"""`Dataset`: a dense numpy matrix binned on the host.

The port's counterpart of `lightgbm_tpu/basic.py` `Dataset` (ref:
python-package/lightgbm/basic.py `Dataset`; src/io/dataset_loader.cpp
`DatasetLoader::ConstructFromSampleData`), for the dense 2-D numpy input
of the training slice.  Binning is the reference's own, on numpy
(`utils/binning.py`): bin mappers are fitted on a row sample of
`bin_construct_sample_cnt` rows drawn by `np.random.RandomState(
data_random_seed)`, then every row is binned into one `[N, F]` uint8
matrix (uint16 past 256 bins).  With `enable_bundle` on, construction
runs the reference's EFB search (`utils/efb.py`), so the port decides
bundling exactly as the JAX package does, and a training set that
bundles also holds its [N, G] bundle matrix (`bundle_data`, the
reference's `basic.py:329`).  A validation set (`create_valid`, or
`reference=`) shares its reference's `BundleSpec`; it is only routed
through trees on its own bins, so its bundle matrix is not built.

`subset` makes a row subset that shares its parent's bin mappers and
bin rows (the reference's `basic.py:967`; `cv` folds are subsets), and
`init_score` (`set_init_score`) is the base every score starts from.
Files, pandas, sparse matrices, query groups, the external-memory
datastore and `save_binary` wait for later slices and raise with the
reason.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Union
from typing import Sequence as SequenceT

import numpy as np

from .utils import log
from .utils.binning import BIN_TYPE_CATEGORICAL, BIN_TYPE_NUMERICAL, \
    BinMapper
from .utils.config import Config
from .utils.log import LightGBMError

__all__ = ["Dataset"]

_LATER = "ROADMAP Queue 1 item 5"
_RANKING = "ROADMAP Queue 1 item 5d: grower and boosting breadth"


def _to_2d_float(data: Any) -> np.ndarray:
    """A dense 2-D numpy (or nested-list) matrix as float64; other inputs
    raise, naming the slice that brings them."""
    if isinstance(data, str):
        raise LightGBMError("file-path data is not ported yet; load the "
                            f"file into a numpy array ({_LATER})")
    if hasattr(data, "tocsr") and hasattr(data, "toarray"):
        raise LightGBMError("sparse input is not ported yet; pass a dense "
                            f"numpy array ({_LATER})")
    if hasattr(data, "values") and hasattr(data, "dtypes"):
        raise LightGBMError("pandas input is not ported yet; pass "
                            f"`df.to_numpy()` ({_LATER})")
    arr = np.asarray(data)
    if arr.dtype.kind not in "fiub":
        raise LightGBMError(f"Dataset data must be numeric, got dtype "
                            f"{arr.dtype}")
    arr = arr.astype(np.float64, copy=False)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.ndim != 2:
        raise LightGBMError(f"Data must be 2-dimensional, got shape "
                            f"{arr.shape}")
    return arr


def _to_1d(arr: Any, dtype) -> np.ndarray:
    return np.asarray(arr, dtype=dtype).reshape(-1)


class Dataset:
    """Dataset container (API of python-package/lightgbm/basic.py
    `Dataset`, dense numpy input only).

    Lazily constructed: `construct()` bins the raw matrix.  A `reference`
    dataset (see `create_valid`) shares its bin mappers, so validation
    data is binned exactly as the training data."""

    def __init__(self, data: Any, label: Any = None,
                 reference: Optional["Dataset"] = None, weight: Any = None,
                 group: Any = None, init_score: Any = None,
                 feature_name: Union[str, SequenceT[str]] = "auto",
                 categorical_feature: Union[str, SequenceT] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        if group is not None:
            raise LightGBMError("query groups (ranking) are not ported yet "
                                f"({_RANKING})")
        self.data = data
        self.label = label
        self.weight = weight
        self.init_score = init_score
        self.used_indices: Optional[np.ndarray] = None
        self.reference = reference
        self.params = copy.deepcopy(params) if params else {}
        self.free_raw_data = free_raw_data
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self._handle_constructed = False
        self.bin_data: Optional[np.ndarray] = None   # [N, F] uint8/uint16
        self.bin_mappers: Optional[List[BinMapper]] = None
        self.num_total_bin = 0
        self.efb = None
        self.bundle_data: Optional[np.ndarray] = None   # [N, G] when bundled
        self._feature_names: Optional[List[str]] = None
        self._num_data: Optional[int] = None
        self._num_feature: Optional[int] = None
        self._label_arr: Optional[np.ndarray] = None
        self._weight_arr: Optional[np.ndarray] = None
        self._init_score_arr: Optional[np.ndarray] = None
        self._categorical_indices: List[int] = []

    # ------------------------------------------------------------- info
    def num_data(self) -> int:
        if self._num_data is not None:
            return self._num_data
        return int(np.shape(self.data)[0])

    def num_feature(self) -> int:
        if self._num_feature is not None:
            return self._num_feature
        return 1 if np.ndim(self.data) == 1 else int(np.shape(self.data)[1])

    def get_feature_name(self) -> List[str]:
        if self._feature_names is not None:
            return list(self._feature_names)
        return self._names_for(self.num_feature())

    def _names_for(self, n_features: int) -> List[str]:
        given = self.feature_name
        if given is not None and given != "auto":
            names = [str(n) for n in given]
            if len(names) != n_features:
                raise LightGBMError(
                    f"Length of feature_names ({len(names)}) does not "
                    f"match number of features ({n_features})")
            return names
        return [f"Column_{i}" for i in range(n_features)]

    def _resolve_categoricals(self, names: List[str], n: int) -> List[int]:
        cf = self.categorical_feature
        if cf == "auto" or cf is None:
            return []
        out = []
        for c in cf:
            if isinstance(c, str):
                if c not in names:
                    raise LightGBMError(
                        f"Unknown categorical feature name: {c}")
                out.append(names.index(c))
            else:
                if not 0 <= int(c) < n:
                    raise LightGBMError(
                        f"categorical_feature index {c} out of range")
                out.append(int(c))
        return sorted(set(out))

    # -------------------------------------------------------- construct
    def construct(self) -> "Dataset":
        """Bin the raw matrix (the JAX package's dense construct path)."""
        if self._handle_constructed:
            return self
        if self.reference is not None:
            self.reference.construct()
        if self.used_indices is not None and self.reference is not None:
            self._construct_subset()
            return self
        if self.data is None:
            raise LightGBMError("Cannot construct Dataset: no raw data "
                                "(was it freed by free_raw_data?)")
        cfg = Config(self.params)
        if cfg.external_memory:
            raise LightGBMError("external_memory (the on-disk datastore) "
                                f"is not ported yet ({_LATER})")
        raw = _to_2d_float(self.data)
        n, f = raw.shape
        self._num_data, self._num_feature = n, f
        self._feature_names = self._names_for(f)
        self._categorical_indices = self._resolve_categoricals(
            self._feature_names, f)
        if self.reference is not None:
            ref = self.reference
            if f != len(ref.bin_mappers):
                raise LightGBMError(
                    f"The number of features in data ({f}) is not the same "
                    f"as it was in training data ({len(ref.bin_mappers)})")
            self.bin_mappers = ref.bin_mappers
            self._categorical_indices = ref._categorical_indices
        else:
            self.bin_mappers = self._fit_bin_mappers(raw, cfg)
        self.bin_data = self._apply_bins(raw, self.bin_mappers)
        self.num_total_bin = sum(m.num_bin for m in self.bin_mappers)
        if self.reference is not None:
            self.efb = self.reference.efb
        elif cfg.enable_bundle:
            from .utils.efb import find_bundles
            self.efb = find_bundles(self.bin_data, self.bin_mappers,
                                    cfg.max_conflict_rate,
                                    cfg.data_random_seed)
        if self.efb is not None and self.reference is None:
            from .utils.efb import build_bundled
            self.bundle_data = build_bundled(self.bin_data, self.efb)
        self._set_fields()
        self._handle_constructed = True
        # linear trees fit and score their leaves on the raw values
        # (the reference's `basic.py:305`)
        if self.free_raw_data and not cfg.linear_tree:
            self.data = None
        return self

    def _fit_bin_mappers(self, raw: np.ndarray,
                         cfg: Config) -> List[BinMapper]:
        """ref: the JAX package's `Dataset._fit_bin_mappers`: one mapper
        per feature, fitted on a sorted row sample."""
        n, f = raw.shape
        sample_cnt = min(cfg.bin_construct_sample_cnt, n)
        if sample_cnt < n:
            rng = np.random.RandomState(cfg.data_random_seed)
            sample = raw[np.sort(rng.choice(n, sample_cnt, replace=False))]
        else:
            sample = raw
        mappers = []
        mbf = cfg.max_bin_by_feature
        for j in range(f):
            m = BinMapper()
            m.find_bin(sample[:, j], len(sample),
                       mbf[j] if j < len(mbf) else cfg.max_bin,
                       min_data_in_bin=cfg.min_data_in_bin,
                       bin_type=(BIN_TYPE_CATEGORICAL
                                 if j in self._categorical_indices
                                 else BIN_TYPE_NUMERICAL),
                       use_missing=cfg.use_missing,
                       zero_as_missing=cfg.zero_as_missing)
            mappers.append(m)
        n_trivial = sum(m.is_trivial for m in mappers)
        if n_trivial:
            log.info(f"{n_trivial} trivial (constant) features found and "
                     "ignored for splitting")
        return mappers

    @staticmethod
    def _apply_bins(raw: np.ndarray, mappers: List[BinMapper]) -> np.ndarray:
        n, f = raw.shape
        max_nb = max((m.num_bin for m in mappers), default=1)
        dtype = np.uint8 if max_nb <= 256 else np.uint16
        out = np.empty((n, f), dtype=dtype)
        for j, m in enumerate(mappers):
            out[:, j] = m.values_to_bins(raw[:, j]).astype(dtype)
        return out

    def _construct_subset(self) -> None:
        """The rows `used_indices` of the reference: its mappers, bundles
        and categorical indices shared, its bin rows (and bundle rows)
        gathered, never re-binned (the reference's
        `_construct_subset`, `basic.py:781`).  Label and weight come from
        the parent unless given; `init_score` does not carry over, as in
        the reference."""
        ref = self.reference
        idx = np.asarray(self.used_indices, dtype=np.int64)
        self.bin_mappers = ref.bin_mappers
        self.bin_data = ref.bin_data[idx]
        self.efb = ref.efb
        if self.efb is not None and ref.bundle_data is not None:
            self.bundle_data = ref.bundle_data[idx]
        self._categorical_indices = ref._categorical_indices
        self._feature_names = ref._feature_names
        self._num_data = len(idx)
        self._num_feature = ref._num_feature
        self.num_total_bin = ref.num_total_bin
        if self.label is None and ref._label_arr is not None:
            self._label_arr = ref._label_arr[idx]
        if self.weight is None and ref._weight_arr is not None:
            self._weight_arr = ref._weight_arr[idx]
        self._set_fields()
        self._handle_constructed = True

    def _set_fields(self) -> None:
        if self.init_score is not None:
            self._init_score_arr = np.asarray(self.init_score,
                                              dtype=np.float64)
        if self.label is not None:
            self._label_arr = _to_1d(self.label, np.float32)
            if len(self._label_arr) != self._num_data:
                raise LightGBMError(
                    f"Length of label ({len(self._label_arr)}) != num_data "
                    f"({self._num_data})")
        if self.weight is not None:
            self._weight_arr = _to_1d(self.weight, np.float32)
            if len(self._weight_arr) != self._num_data:
                raise LightGBMError("Length of weight does not match data")

    # ----------------------------------------------------- field access
    def get_label(self) -> Optional[np.ndarray]:
        if self._handle_constructed:
            return self._label_arr
        return _to_1d(self.label, np.float32) \
            if self.label is not None else None

    def get_weight(self) -> Optional[np.ndarray]:
        if self._handle_constructed:
            return self._weight_arr
        return _to_1d(self.weight, np.float32) \
            if self.weight is not None else None

    def get_init_score(self) -> Optional[np.ndarray]:
        return self._init_score_arr

    def set_init_score(self, init_score: Any) -> "Dataset":
        """The base score of every row (ref: basic.py
        `Dataset.set_init_score`): [N], or [N * K] class-major for K
        trees an iteration."""
        self.init_score = init_score
        if self._handle_constructed:
            self._init_score_arr = np.asarray(init_score, dtype=np.float64) \
                if init_score is not None else None
        return self

    def get_group(self) -> Optional[np.ndarray]:
        """Query group sizes; always None here (groups raise, item 5d)."""
        return None

    def subset(self, used_indices: SequenceT[int],
               params: Optional[dict] = None) -> "Dataset":
        """Row subset sharing this dataset's bins (ref: basic.py
        `Dataset.subset`); constructed lazily, sorted indices."""
        ret = Dataset(None, reference=self, feature_name=self.feature_name,
                      categorical_feature=self.categorical_feature,
                      params=params if params is not None else self.params,
                      free_raw_data=self.free_raw_data)
        ret.used_indices = np.sort(np.asarray(used_indices, dtype=np.int64))
        return ret

    def get_data(self):
        if self.data is None and self.free_raw_data:
            raise LightGBMError("Raw data was freed (free_raw_data=True)")
        return self.data

    def create_valid(self, data: Any, label: Any = None, weight: Any = None,
                     init_score: Any = None,
                     params: Optional[dict] = None) -> "Dataset":
        """Validation set binned with this dataset's mappers
        (ref: basic.py `Dataset.create_valid`)."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       init_score=init_score,
                       feature_name=self.feature_name,
                       categorical_feature=self.categorical_feature,
                       params=params if params is not None else self.params,
                       free_raw_data=self.free_raw_data)

    def save_binary(self, filename: str) -> "Dataset":
        raise LightGBMError(f"save_binary is not ported yet ({_LATER})")
