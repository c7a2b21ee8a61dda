"""`Dataset`: the raw matrix binned on the host, with its labels,
weights, query groups and positions.

The port's counterpart of `lightgbm_tpu/basic.py` `Dataset` (ref:
python-package/lightgbm/basic.py `Dataset`; src/io/dataset_loader.cpp
`DatasetLoader::ConstructFromSampleData`; src/io/metadata.cpp
`Metadata`).  Binning is the reference's own (`utils/binning.py`): bin
mappers are fitted in numpy on a row sample of
`bin_construct_sample_cnt` rows drawn by `np.random.RandomState(
data_random_seed)`, then every row is binned, through the host
library's search (`native/`), into one `[N, F]` uint8 matrix (uint16
past 256 bins).  With `enable_bundle` on, construction
runs the reference's EFB search (`utils/efb.py`), and a training set
that bundles also holds its [N, G] bundle matrix (`bundle_data`).  A
validation set (`create_valid`, or `reference=`) shares its reference's
mappers and `BundleSpec`.

Inputs: a dense numpy or nested-list matrix, a pandas DataFrame (NaN for
`na_value`, the feature names from its columns), a pyarrow Table or
RecordBatch (nulls as NaN, the names from `column_names`), a `Sequence`
(or a list of them) read in batches, and a scipy CSR or CSC matrix,
which never densifies: mappers from each column's stored values plus
its implied zeros, a binned CSC, the EFB search and the bundle matrix
from it (`bin_data` stays None when EFB bundles).  pandas and pyarrow
are recognised by duck typing, never imported.  A file path (CSV, TSV,
space-separated or LibSVM, read by the port's host library through
`cli.py`) is read whole, or with `two_round` in two passes over its
chunks: the mappers from a reservoir sample, then each chunk binned
straight into the bin matrix, so the raw matrix is never held whole.

With `external_memory`, the constructed bins (and the bundle matrix, the
labels and weights) are spilled to a checksummed shard store on disk
(`datastore/`) and the host copies are freed; the booster assembles the
device matrix from it.  The two_round route with `external_memory` bins
each chunk straight into the store.

`group` (sizes, or per-row query ids) gives the query boundaries the
ranking objectives and metrics read; `position` the per-row result-list
positions of position-debiased lambdarank.  `subset` shares the parent's
bins and keeps whole queries (`cv` folds are subsets); `save_binary` /
`load_binary` write and read the reference's npz layout field for
field, so either package reads the other's file.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional, Union
from typing import Sequence as SequenceT

import numpy as np

from .utils import log
from .utils.binning import BIN_TYPE_CATEGORICAL, BIN_TYPE_NUMERICAL, \
    BinMapper
from .utils.config import Config
from .utils.log import LightGBMError

__all__ = ["Dataset", "Sequence"]

class Sequence:
    """A random-access row source (ref: basic.py `Sequence`): subclass
    with `__len__` and `__getitem__` returning a row or a batch of rows;
    `Dataset` takes one or a list of them, read `batch_size` rows at a
    time."""

    batch_size = 4096

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, idx):  # pragma: no cover - abstract
        raise NotImplementedError


def _sequence_to_array(seqs) -> np.ndarray:
    if isinstance(seqs, Sequence):
        seqs = [seqs]
    parts = []
    for s in seqs:
        n = len(s)
        step = max(int(getattr(s, "batch_size", 4096)), 1)
        for lo in range(0, n, step):
            batch = np.asarray(s[slice(lo, min(lo + step, n))],
                               dtype=np.float64)
            if batch.ndim == 1:
                batch = batch.reshape(1, -1)
            parts.append(batch)
    if not parts:
        raise LightGBMError("Cannot construct Dataset from empty Sequence")
    return np.concatenate(parts, axis=0)


def _is_sparse(data: Any) -> bool:
    return hasattr(data, "tocsr") and hasattr(data, "toarray")


def _is_arrow(data: Any) -> bool:
    """A pyarrow Table or RecordBatch, without importing pyarrow."""
    return type(data).__module__.startswith("pyarrow") and \
        hasattr(data, "column_names") and hasattr(data, "columns")


def _to_2d_float(data: Any) -> np.ndarray:
    """An input matrix as 2-D float64 numpy (the reference's
    `basic.py:75`): a Sequence read in batches, a sparse matrix
    densified (prediction only: `Dataset` bins sparse input without
    densifying), Arrow columns with nulls as NaN, a DataFrame with NaN
    for its missing values."""
    if isinstance(data, str):
        raise LightGBMError(
            "file-path data must be resolved by Dataset.construct")
    if isinstance(data, Sequence) or (
            isinstance(data, list) and data
            and isinstance(data[0], Sequence)):
        return _sequence_to_array(data)
    if _is_sparse(data):
        return np.asarray(data.toarray(), dtype=np.float64)
    if _is_arrow(data):
        cols = [np.asarray(c.to_numpy(zero_copy_only=False),
                           dtype=np.float64) for c in data.columns]
        return np.column_stack(cols) if cols else np.empty((0, 0))
    if hasattr(data, "values") and hasattr(data, "dtypes"):
        arr = data.to_numpy(dtype=np.float64, na_value=np.nan)
    else:
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
    if hasattr(arr, "values") and not isinstance(arr, np.ndarray):
        arr = arr.values
    return np.asarray(arr, dtype=dtype).reshape(-1)


def _feature_names_from(data: Any, n_features: int, given) -> List[str]:
    """The given names, else an Arrow table's or a DataFrame's column
    names, else Column_i."""
    if given is not None and given != "auto":
        names = [str(n) for n in given]
        if len(names) != n_features:
            raise LightGBMError(
                f"Length of feature_names ({len(names)}) does not match "
                f"number of features ({n_features})")
        return names
    if hasattr(data, "column_names"):
        return [str(c) for c in data.column_names]
    if hasattr(data, "columns") and not _is_sparse(data):
        return [str(c) for c in data.columns]
    return [f"Column_{i}" for i in range(n_features)]


class Dataset:
    """Dataset container (API of python-package/lightgbm/basic.py
    `Dataset`).

    Lazily constructed: `construct()` bins the raw data.  A `reference`
    dataset (see `create_valid`) shares its bin mappers, so validation
    data is binned exactly as the training data."""

    def __init__(self, data: Any, label: Any = None,
                 reference: Optional["Dataset"] = None, weight: Any = None,
                 group: Any = None, init_score: Any = None,
                 feature_name: Union[str, SequenceT[str]] = "auto",
                 categorical_feature: Union[str, SequenceT] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, position: Any = None):
        self.data = data
        self.label = label
        self.weight = weight
        self.group = group
        self.position = position
        self.init_score = init_score
        self.used_indices: Optional[np.ndarray] = None
        self.reference = reference
        self.params = copy.deepcopy(params) if params else {}
        self.free_raw_data = free_raw_data
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self._handle_constructed = False
        self.bin_data: Optional[np.ndarray] = None   # [N, F] uint8/uint16
        #: sparse input's binned CSC (stored entries: the bins of the
        #: stored values; absent ones each feature's zero bin)
        self.sparse_binned = None
        self.bin_mappers: Optional[List[BinMapper]] = None
        self.num_total_bin = 0
        self.efb = None
        self.bundle_data: Optional[np.ndarray] = None   # [N, G] when bundled
        #: the shard store of a spilled set (`external_memory`): the
        #: canonical bins once `bin_data` and `bundle_data` are freed
        self.datastore = None
        self._feature_names: Optional[List[str]] = None
        self._num_data: Optional[int] = None
        self._num_feature: Optional[int] = None
        self._label_arr: Optional[np.ndarray] = None
        self._weight_arr: Optional[np.ndarray] = None
        self._init_score_arr: Optional[np.ndarray] = None
        self._query_boundaries: Optional[np.ndarray] = None
        self._categorical_indices: List[int] = []
        self.version = 0

    # ------------------------------------------------------------- info
    def num_data(self) -> int:
        if self._num_data is not None:
            return self._num_data
        if self.data is None or isinstance(self.data, str):
            raise LightGBMError("Cannot get num_data before construct")
        if _is_sparse(self.data):
            return int(self.data.shape[0])
        return len(self.data)

    def num_feature(self) -> int:
        if self._num_feature is not None:
            return self._num_feature
        if self.data is None or isinstance(self.data, str):
            raise LightGBMError("Cannot get num_feature before construct")
        return 1 if np.ndim(self.data) == 1 else int(np.shape(self.data)[1])

    def num_total_data(self) -> int:
        return self.num_data()

    def get_feature_name(self) -> List[str]:
        if self._feature_names is not None:
            return list(self._feature_names)
        return _feature_names_from(self.data, self.num_feature(),
                                   self.feature_name)

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
        """Bin the raw data (the reference's `_construct_impl`, its
        in-memory paths)."""
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
        if isinstance(self.data, str):
            # a data file (the reference's `basic.py:253-269`): its label,
            # weight and group columns feed the fields not given
            if (cfg.two_round and self.reference is None
                    and not cfg.linear_tree
                    and self._construct_from_file_streaming(cfg)):
                return self
            from .cli import load_data_file_full
            X, y, extras = load_data_file_full(self.data, cfg)
            self.data = X
            if self.label is None and y is not None:
                self.label = y
            if self.weight is None and "weight" in extras:
                self.weight = extras["weight"]
            if self.group is None and "group" in extras:
                self.group = extras["group"]
        if _is_sparse(self.data):
            self._construct_sparse(cfg)
            self._set_fields()
            self._handle_constructed = True
        else:
            raw = _to_2d_float(self.data)
            n, f = raw.shape
            self._num_data, self._num_feature = n, f
            self._feature_names = _feature_names_from(self.data, f,
                                                      self.feature_name)
            self._categorical_indices = self._resolve_categoricals(
                self._feature_names, f)
            self._share_or_fit(f, lambda: self._fit_bin_mappers(raw, cfg))
            self.bin_data = self._apply_bins(raw, self.bin_mappers)
            self._finish_dense_construct(cfg)
        # linear trees fit and score their leaves on the raw values
        # (the reference's `basic.py:305`)
        if self.free_raw_data and not cfg.linear_tree:
            self.data = None
        return self

    def _finish_dense_construct(self, cfg: Config) -> None:
        """The construction's tail once `bin_data` and the mappers exist:
        the EFB search (a validation set takes its reference's bundles),
        a training set's bundle matrix, the fields, and with
        `external_memory` the spill, after EFB so that the store holds
        both matrices (the reference's `basic.py:307`)."""
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
        # validation sets stay in memory: they are only routed, never
        # histogrammed
        if cfg.external_memory and self.reference is None and \
                self.bin_data is not None:
            self._spill_to_datastore(cfg)

    # ---- external memory (the reference's `basic.py:341-401`)
    def _new_datastore_dir(self, cfg: Config) -> str:
        """A fresh directory for the shards: a new subdirectory of
        `datastore_dir` when given (its owner removes it), else a
        temporary directory removed when the interpreter exits."""
        import os
        import tempfile
        if cfg.datastore_dir:
            os.makedirs(cfg.datastore_dir, exist_ok=True)
            return tempfile.mkdtemp(prefix="dstore-", dir=cfg.datastore_dir)
        import atexit
        import shutil
        d = tempfile.mkdtemp(prefix="lgbt-dstore-")
        atexit.register(shutil.rmtree, d, ignore_errors=True)
        return d

    @staticmethod
    def _datastore_shard_rows(cfg: Config, n: int, row_bytes: int) -> int:
        from .datastore import auto_shard_rows
        if int(cfg.datastore_shard_rows) > 0:
            return int(cfg.datastore_shard_rows)
        return auto_shard_rows(n, row_bytes, cfg.datastore_budget_mb,
                               cfg.datastore_prefetch)

    def _record_spill_telemetry(self) -> None:
        from . import telemetry
        telemetry.REGISTRY.gauge("datastore.spill_bytes").set(
            self.datastore.total_bytes())
        telemetry.REGISTRY.gauge("datastore.shards").set(
            self.datastore.n_shards)

    def _spill_to_datastore(self, cfg: Config) -> None:
        """The bins (and the bundle matrix, labels and weights) into a
        shard store; the host matrices are freed and the store is the
        set's bins from here on."""
        from .datastore import ShardWriter
        bins = self.bin_data
        n, f = bins.shape
        bundle = self.bundle_data
        g = bundle.shape[1] if bundle is not None else 0
        lab, wt = self._label_arr, self._weight_arr
        row_bytes = (f + g) * bins.dtype.itemsize + \
            4 * ((lab is not None) + (wt is not None))
        shard_rows = self._datastore_shard_rows(cfg, n, row_bytes)
        w = ShardWriter(self._new_datastore_dir(cfg), n_features=f,
                        dtype=bins.dtype, shard_rows=shard_rows,
                        bundle_cols=g, has_label=lab is not None,
                        has_weight=wt is not None,
                        meta={"num_total_bin": int(self.num_total_bin)})
        for lo in range(0, n, shard_rows):
            hi = min(lo + shard_rows, n)
            w.append(bins[lo:hi],
                     bundle=bundle[lo:hi] if bundle is not None else None,
                     label=lab[lo:hi] if lab is not None else None,
                     weight=wt[lo:hi] if wt is not None else None)
        self.datastore = w.finalize()
        self._record_spill_telemetry()
        log.info(f"external memory: spilled {n} rows x {f} features to "
                 f"{self.datastore.n_shards} shards "
                 f"({self.datastore.total_bytes() >> 20} MB) in "
                 f"{self.datastore.dirpath}")
        self.bin_data = None
        self.bundle_data = None

    # ---- two_round ingest (the reference's `basic.py:439-645`)
    def _construct_from_file_streaming(self, cfg: Config) -> bool:
        """two_round ingest of a dense text file: pass 1 reads the file in
        chunks, counting rows, keeping the label (weight, group) columns
        and a reservoir sample of rows for the mappers; pass 2 reads it
        again and bins each chunk into the bin matrix (or, with
        `external_memory`, into the shard store).  The raw matrix is never
        held whole.  Above `bin_construct_sample_cnt` rows the reservoir
        holds another sample than the whole-file route draws, so the bins
        may differ from it; below, both see every row.

        False, and the caller reads the file whole, for a LibSVM file
        (the dense reader would take `idx:val` for numbers) and when a
        pass fails to parse (the whole-file route has laxer readers)."""
        from .cli import _sniff_format
        if _sniff_format(self.data)[0] == "libsvm":
            return False
        try:
            return self._stream_two_passes(cfg)
        except ValueError as e:
            log.warning(f"two_round streaming ingest failed ({e}); "
                        "falling back to whole-file loading")
            self.bin_data = None
            self.bin_mappers = None
            return False

    def _stream_two_passes(self, cfg: Config) -> bool:
        from .cli import column_roles, group_ids_to_sizes
        from .native import StreamReader
        chunk_rows = 16384
        try:
            r1 = StreamReader(self.data, chunk_rows=chunk_rows)
        except ValueError:
            return False
        # the reader skips a header that does not parse; a declared one
        # that does (numeric column names) is dropped here, as the
        # whole-file route drops it
        skip_first = bool(cfg.header) and not r1.had_header

        def chunks(reader):
            first = True
            for chunk in reader:
                if first and skip_first:
                    chunk = chunk[1:]
                first = False
                if len(chunk):
                    yield chunk

        label_col, weight_col, group_col, drop = column_roles(cfg)
        s_cap = max(int(cfg.bin_construct_sample_cnt), 1)
        rng = np.random.RandomState(cfg.data_random_seed)
        labels, weights, group_ids = [], [], []
        reservoir = np.empty((s_cap, r1.n_cols), dtype=np.float64)
        filled = seen = 0
        for chunk in chunks(r1):
            labels.append(chunk[:, label_col].astype(np.float32))
            if weight_col is not None:
                weights.append(chunk[:, weight_col].astype(np.float32))
            if group_col is not None:
                group_ids.append(chunk[:, group_col].copy())
            c = len(chunk)
            take = min(s_cap - filled, c)
            if take > 0:
                reservoir[filled:filled + take] = chunk[:take]
                filled += take
            if take < c:
                # algorithm R, vectorised: row i replaces slot j ~ U[0, i]
                gidx = np.arange(seen + take, seen + c, dtype=np.int64)
                js = (rng.random_sample(len(gidx)) * (gidx + 1)).astype(
                    np.int64)
                repl = js < s_cap
                reservoir[js[repl]] = chunk[take:][repl]
            seen += c
        if seen == 0:
            raise LightGBMError(f"no data rows in {self.data}")
        n = seen
        r1.close()
        sample_x = np.delete(reservoir[:filled], drop, axis=1)
        del reservoir
        f = sample_x.shape[1]
        self._num_data, self._num_feature = n, f
        self._feature_names = _feature_names_from(None, f, self.feature_name)
        self._categorical_indices = self._resolve_categoricals(
            self._feature_names, f)
        self.bin_mappers = [self._fit_one_mapper(j, sample_x[:, j], filled,
                                                 cfg) for j in range(f)]
        _log_trivial(self.bin_mappers)
        del sample_x
        max_nb = max((m.num_bin for m in self.bin_mappers), default=1)
        dtype = np.uint8 if max_nb <= 256 else np.uint16
        if self.label is None:
            self.label = np.concatenate(labels)
        if self.weight is None and weights:
            self.weight = np.concatenate(weights)
        if self.group is None and group_ids:
            self.group = group_ids_to_sizes(np.concatenate(group_ids))

        def binned_chunks():
            """Pass 2: each chunk's features binned, in file order."""
            pos = 0
            for chunk in chunks(StreamReader(self.data,
                                             chunk_rows=chunk_rows)):
                xc = np.delete(chunk, drop, axis=1)
                if pos + len(xc) > n:
                    raise LightGBMError(
                        f"file changed between streaming passes (> {n} "
                        "rows)")
                block = np.empty((len(xc), f), dtype=dtype)
                for j, m in enumerate(self.bin_mappers):
                    block[:, j] = m.values_to_bins(xc[:, j]).astype(dtype)
                yield pos, block
                pos += len(xc)
            if pos != n:
                raise LightGBMError(f"file changed between streaming "
                                    f"passes ({pos} vs {n} rows)")

        if cfg.external_memory:
            self._stream_pass2_datastore(cfg, binned_chunks(), n, f, dtype)
            log.info(f"two_round streaming ingest: {n} rows x {f} features "
                     f"spilled to {self.datastore.n_shards} shards without "
                     "materializing the bin matrix")
            self._finish_datastore_construct(cfg)
            return True
        self.bin_data = np.empty((n, f), dtype=dtype)
        for pos, block in binned_chunks():
            self.bin_data[pos:pos + len(block)] = block
        log.info(f"two_round streaming ingest: {n} rows x {f} features "
                 "binned without materializing the raw matrix")
        self._finish_dense_construct(cfg)
        # `data` stays the path: the raw values were never held
        return True

    def _stream_pass2_datastore(self, cfg: Config, blocks, n: int, f: int,
                                dtype) -> None:
        """two_round's pass 2 into a shard store: each binned chunk
        appended with its labels' and weights' slices (collected in pass
        1), so that the store holds the whole set."""
        from .datastore import ShardWriter
        lab = _to_1d(self.label, np.float32) \
            if self.label is not None else None
        wt = _to_1d(self.weight, np.float32) \
            if self.weight is not None else None
        row_bytes = f * np.dtype(dtype).itemsize + \
            4 * ((lab is not None) + (wt is not None))
        w = ShardWriter(self._new_datastore_dir(cfg), n_features=f,
                        dtype=dtype,
                        shard_rows=self._datastore_shard_rows(cfg, n,
                                                              row_bytes),
                        has_label=lab is not None, has_weight=wt is not None)
        for pos, block in blocks:
            rows = slice(pos, pos + len(block))
            w.append(block, label=lab[rows] if lab is not None else None,
                     weight=wt[rows] if wt is not None else None)
        self.datastore = w.finalize()
        self._record_spill_telemetry()

    def _finish_datastore_construct(self, cfg: Config) -> None:
        """The construction's tail for the two_round route into the store:
        no bin matrix exists, so the EFB search is skipped."""
        self.num_total_bin = sum(m.num_bin for m in self.bin_mappers)
        if cfg.enable_bundle:
            log.info("EFB disabled for streamed external-memory ingest "
                     "(bundling needs the dense bin matrix, which this "
                     "path never materializes)")
        self.efb = None
        self._set_fields()
        self._handle_constructed = True

    def _share_or_fit(self, f: int, fit) -> None:
        """The reference's mappers (checking the feature count), or
        `fit()`'s."""
        if self.reference is None:
            self.bin_mappers = fit()
            return
        ref = self.reference
        if f != len(ref.bin_mappers):
            raise LightGBMError(
                f"The number of features in data ({f}) is not the same "
                f"as it was in training data ({len(ref.bin_mappers)})")
        self.bin_mappers = ref.bin_mappers
        self._categorical_indices = ref._categorical_indices

    def _fit_one_mapper(self, j: int, values: np.ndarray, total_cnt: int,
                        cfg: Config) -> BinMapper:
        """One feature's mapper; `values` may leave out zeros when
        `total_cnt` is larger (the sparse sampling contract, bin.cpp
        `FindBin`)."""
        m = BinMapper()
        mbf = cfg.max_bin_by_feature
        m.find_bin(values, total_cnt,
                   mbf[j] if j < len(mbf) else cfg.max_bin,
                   min_data_in_bin=cfg.min_data_in_bin,
                   bin_type=(BIN_TYPE_CATEGORICAL
                             if j in self._categorical_indices
                             else BIN_TYPE_NUMERICAL),
                   use_missing=cfg.use_missing,
                   zero_as_missing=cfg.zero_as_missing)
        return m

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
        mappers = [self._fit_one_mapper(j, sample[:, j], len(sample), cfg)
                   for j in range(f)]
        _log_trivial(mappers)
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

    # ---- sparse input (the reference's `basic.py:645-780`)
    def _construct_sparse(self, cfg: Config) -> None:
        """Bin a scipy CSR or CSC matrix without a dense f64 copy: the
        mappers from each column's sampled stored values plus its implied
        zeros, the stored values binned in place, then the bundle search
        and the [N, G] bundle matrix from the binned CSC (`bin_data`
        stays None); unbundled, and for a validation set, the dense
        [N, F] bins are written from it directly."""
        from .utils.efb import (build_bundled_sparse, find_bundles_sparse,
                                materialize_dense_bins)
        if cfg.external_memory:
            log.warning("external_memory is not supported for sparse "
                        "input (the EFB-bundled sparse form is already "
                        "compact); training in-memory")
        n, f = (int(v) for v in self.data.shape)
        self._num_data, self._num_feature = n, f
        self._feature_names = _feature_names_from(self.data, f,
                                                  self.feature_name)
        self._categorical_indices = self._resolve_categoricals(
            self._feature_names, f)
        csc = self.data.tocsc()
        self._share_or_fit(f, lambda: self._fit_bin_mappers_sparse(csc,
                                                                   cfg))
        binned = self._bin_sparse_csc(csc, self.bin_mappers)
        del csc
        self.sparse_binned = binned
        self.num_total_bin = sum(m.num_bin for m in self.bin_mappers)
        if self.reference is not None:
            self.efb = self.reference.efb
            self.bin_data = materialize_dense_bins(binned, self.bin_mappers)
            return
        if cfg.enable_bundle:
            self.efb = find_bundles_sparse(binned, self.bin_mappers,
                                           cfg.max_conflict_rate,
                                           cfg.data_random_seed)
        if self.efb is not None:
            self.bundle_data = build_bundled_sparse(binned, self.efb,
                                                    self.bin_mappers)
        else:
            self.bin_data = materialize_dense_bins(binned, self.bin_mappers)

    def _fit_bin_mappers_sparse(self, csc, cfg: Config) -> List[BinMapper]:
        """Each feature's mapper from its sampled stored values and the
        sample's row count (the reference's `basic.py:721`)."""
        n, f = csc.shape
        sample_cnt = min(cfg.bin_construct_sample_cnt, n)
        in_sample = None
        if sample_cnt < n:
            rng = np.random.RandomState(cfg.data_random_seed)
            in_sample = np.zeros(n, dtype=bool)
            in_sample[rng.choice(n, sample_cnt, replace=False)] = True
        indptr, indices, data = csc.indptr, csc.indices, csc.data
        mappers = []
        for j in range(f):
            sl = slice(int(indptr[j]), int(indptr[j + 1]))
            vals = np.asarray(data[sl], dtype=np.float64)
            if in_sample is not None:
                vals = vals[in_sample[indices[sl]]]
            mappers.append(self._fit_one_mapper(j, vals, sample_cnt, cfg))
        _log_trivial(mappers)
        return mappers

    @staticmethod
    def _bin_sparse_csc(csc, mappers: List[BinMapper]):
        """The binned CSC: the same pattern, each stored value's bin."""
        max_nb = max((m.num_bin for m in mappers), default=1)
        dtype = np.uint8 if max_nb <= 256 else np.uint16
        out = np.empty(len(csc.data), dtype=dtype)
        for j, m in enumerate(mappers):
            sl = slice(int(csc.indptr[j]), int(csc.indptr[j + 1]))
            out[sl] = m.values_to_bins(
                np.asarray(csc.data[sl], dtype=np.float64)).astype(dtype)
        return type(csc)((out, csc.indices, csc.indptr), shape=csc.shape)

    def _dense_bin_matrix(self) -> np.ndarray:
        """The [N, F] bins, written from the binned CSC when the sparse
        path bundled without them."""
        if self.bin_data is not None:
            return self.bin_data
        if self.datastore is not None:
            # the whole matrix on the host, for the paths that need it at
            # once (DART's and rollback's replays, `add_features_from`)
            return self.datastore.read_all_rows("bins")
        if self.sparse_binned is None:
            raise LightGBMError("Dataset has no binned data (not "
                                "constructed?)")
        from .utils.efb import materialize_dense_bins
        return materialize_dense_bins(self.sparse_binned, self.bin_mappers)

    def _construct_subset(self) -> None:
        """The rows `used_indices` of the reference: its mappers, bundles
        and categorical indices shared, its bin rows (bundle rows, or
        binned CSC rows) gathered, never re-binned, and its queries cut
        to the rows kept (the reference's `_construct_subset`,
        `basic.py:781`).  Label and weight come from the parent unless
        given; `init_score` does not carry over, as in the reference."""
        ref = self.reference
        idx = np.asarray(self.used_indices, dtype=np.int64)
        self.bin_mappers = ref.bin_mappers
        if ref.bin_data is not None:
            self.bin_data = ref.bin_data[idx]
        elif ref.datastore is not None:
            # a spilled parent: the rows gathered from the shards that
            # hold them; the bytes never read are counted
            self.bin_data, saved, skipped = \
                ref.datastore.gather_rows(idx, "bins")
            if "bundle" in ref.datastore.payloads:
                self.bundle_data = \
                    ref.datastore.gather_rows(idx, "bundle")[0]
            from . import telemetry
            telemetry.REGISTRY.counter("datastore.h2d_bytes_saved").inc(
                int(saved))
            if skipped:
                log.info(f"datastore subset: skipped {skipped}/"
                         f"{ref.datastore.n_shards} shards "
                         f"({saved >> 10} KB never read)")
        else:
            self.sparse_binned = ref.sparse_binned.tocsr()[idx].tocsc()
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
        if self.group is None and ref._query_boundaries is not None:
            qb = ref._query_boundaries
            sizes = [m for m in (((idx >= qb[g]) & (idx < qb[g + 1])).sum()
                                 for g in range(len(qb) - 1)) if m]
            self._query_boundaries = np.concatenate([[0], np.cumsum(sizes)])
        self._set_fields()
        self._handle_constructed = True

    def _set_fields(self) -> None:
        """Labels, weights, init scores and query boundaries from the
        given fields, checked against the row count (the reference's
        `_set_all_fields`): `group` is group sizes summing to the row
        count, or per-row query ids."""
        if self.init_score is not None:
            self._init_score_arr = np.asarray(self.init_score,
                                              dtype=np.float64)
        if self.label is not None:
            self._label_arr = _to_1d(self.label, np.float32)
        if self.weight is not None:
            self._weight_arr = _to_1d(self.weight, np.float32)
        if self.group is not None:
            g = _to_1d(self.group, np.int64)
            if len(g) and g.sum() == self._num_data:
                self._query_boundaries = np.concatenate([[0], np.cumsum(g)])
            elif len(g) == self._num_data:
                change = np.nonzero(np.diff(g))[0] + 1
                self._query_boundaries = np.concatenate(
                    [[0], change, [len(g)]])
            else:
                raise LightGBMError("Length of group does not match data")
        if self._label_arr is not None and \
                len(self._label_arr) != self._num_data:
            raise LightGBMError(
                f"Length of label ({len(self._label_arr)}) != num_data "
                f"({self._num_data})")
        if self._weight_arr is not None and \
                len(self._weight_arr) != self._num_data:
            raise LightGBMError("Length of weight does not match data")

    # ----------------------------------------------------- field access
    def set_label(self, label: Any) -> "Dataset":
        self.label = label
        if self._handle_constructed:
            self._label_arr = _to_1d(label, np.float32) \
                if label is not None else None
        self.version += 1
        return self

    def set_weight(self, weight: Any) -> "Dataset":
        self.weight = weight
        if self._handle_constructed:
            self._weight_arr = _to_1d(weight, np.float32) \
                if weight is not None else None
        self.version += 1
        return self

    def set_group(self, group: Any) -> "Dataset":
        self.group = group
        if self._handle_constructed and group is not None:
            self._set_fields()
        self.version += 1
        return self

    def set_init_score(self, init_score: Any) -> "Dataset":
        """The base score of every row (ref: basic.py
        `Dataset.set_init_score`): [N], or [N * K] class-major for K
        trees an iteration."""
        self.init_score = init_score
        if self._handle_constructed:
            self._init_score_arr = np.asarray(init_score, dtype=np.float64) \
                if init_score is not None else None
        self.version += 1
        return self

    def set_position(self, position: Any) -> "Dataset":
        """Per-row result-list positions for position-debiased lambdarank
        (ref: basic.py `Dataset.set_position`)."""
        self.position = position
        self.version += 1
        return self

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

    def get_group(self) -> Optional[np.ndarray]:
        """Query sizes, or None without queries."""
        if self._query_boundaries is None:
            return None
        return np.diff(self._query_boundaries)

    def get_position(self) -> Optional[np.ndarray]:
        if self.position is None:
            return None
        return _to_1d(self.position, np.int64).astype(np.int32)

    def get_field(self, field_name: str):
        getters = {"label": self.get_label, "weight": self.get_weight,
                   "group": self.get_group,
                   "init_score": self.get_init_score,
                   "position": self.get_position}
        return getters[field_name]() if field_name in getters else None

    def set_field(self, field_name: str, data: Any) -> "Dataset":
        return {"label": self.set_label, "weight": self.set_weight,
                "group": self.set_group, "init_score": self.set_init_score,
                "position": self.set_position}[field_name](data)

    def set_feature_name(self, feature_name: SequenceT[str]) -> "Dataset":
        self.feature_name = list(feature_name)
        if self._handle_constructed:
            if len(feature_name) != self._num_feature:
                raise LightGBMError("Length of feature_name doesn't match")
            self._feature_names = [str(s) for s in feature_name]
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        if self._handle_constructed and \
                categorical_feature != self.categorical_feature:
            raise LightGBMError(
                "Cannot set categorical feature after constructed; set "
                "free_raw_data=False to allow re-construction")
        self.categorical_feature = categorical_feature
        return self

    def feature_num_bin(self, feature: Union[int, str]) -> int:
        """Bins of one feature (ref: basic.py `Dataset.feature_num_bin`)."""
        self.construct()
        if isinstance(feature, str):
            feature = self.get_feature_name().index(feature)
        return int(self.bin_mappers[int(feature)].num_bin)

    def get_params(self) -> Dict[str, Any]:
        return copy.deepcopy(self.params or {})

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """Bin this dataset with `reference`'s mappers."""
        if self._handle_constructed and \
                self.bin_mappers is not reference.bin_mappers:
            raise LightGBMError(
                "Cannot set reference after the Dataset was constructed; "
                "set free_raw_data=False and create a new Dataset")
        self.reference = reference
        return self

    def get_ref_chain(self, ref_limit: int = 100) -> set:
        """This dataset and its references, at most `ref_limit`."""
        head, chain = self, set()
        while len(chain) < ref_limit and head not in chain:
            chain.add(head)
            if head.reference is None:
                break
            head = head.reference
        return chain

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """The columns of `other` appended (both constructed, row for
        row); the result is unbundled."""
        self.construct()
        other.construct()
        self.bin_data = np.concatenate(
            [self._dense_bin_matrix(), other._dense_bin_matrix()], axis=1)
        self.sparse_binned = None
        self.bin_mappers = list(self.bin_mappers) + list(other.bin_mappers)
        self._feature_names = list(self._feature_names) \
            + list(other._feature_names)
        self._categorical_indices = list(self._categorical_indices) + [
            i + self._num_feature for i in other._categorical_indices]
        self._num_feature += other._num_feature
        self.num_total_bin += other.num_total_bin
        self.efb = None
        self.bundle_data = None
        return self

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
                     group: Any = None, init_score: Any = None,
                     params: Optional[dict] = None,
                     position: Any = None) -> "Dataset":
        """Validation set binned with this dataset's mappers
        (ref: basic.py `Dataset.create_valid`)."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       feature_name=self.feature_name,
                       categorical_feature=self.categorical_feature,
                       params=params if params is not None else self.params,
                       free_raw_data=self.free_raw_data, position=position)

    # ---- the binary cache (the reference's `basic.py:992-1072`)
    def save_binary(self, filename: str) -> "Dataset":
        """The constructed bins and fields in the reference's npz layout
        (the bin matrix, or a sparse set's binned CSC triplet; the
        mappers, EFB spec and names as JSON; label, weight, query
        boundaries, positions and categorical indices as arrays)."""
        self.construct()
        if self.bin_data is None and self.datastore is not None:
            raise LightGBMError(
                "save_binary is not supported for external-memory "
                "(spilled) Datasets — the datastore directory at "
                f"'{self.datastore.dirpath}' already is the reloadable "
                "on-disk form (pass datastore_dir to keep it)")
        if self.bin_data is not None:
            payload = {"bin_data": self.bin_data}
        else:
            sb = self.sparse_binned
            payload = {"sparse_data": np.asarray(sb.data),
                       "sparse_indices": np.asarray(sb.indices),
                       "sparse_indptr": np.asarray(sb.indptr),
                       "sparse_shape": np.asarray(sb.shape, np.int64)}
        empty = np.array([])
        with open(filename, "wb") as fh:
            np.savez_compressed(
                fh, **payload,
                mappers=json.dumps([m.to_dict() for m in self.bin_mappers]),
                label=self._label_arr if self._label_arr is not None
                else empty,
                weight=self._weight_arr if self._weight_arr is not None
                else empty,
                query=self._query_boundaries
                if self._query_boundaries is not None else empty,
                position=(self.get_position() if self.position is not None
                          else np.array([], np.int32)),
                feature_names=json.dumps(self._feature_names),
                categorical=np.asarray(self._categorical_indices,
                                       dtype=np.int64),
                efb=json.dumps(self.efb.to_dict())
                if self.efb is not None else "")
        return self

    @classmethod
    def load_binary(cls, filename: str) -> "Dataset":
        """A constructed Dataset from `save_binary`'s file (either
        package's)."""
        z = np.load(filename, allow_pickle=False)
        ds = cls(None, free_raw_data=False)
        ds.bin_mappers = [BinMapper.from_dict(d)
                          for d in json.loads(str(z["mappers"]))]
        if "bin_data" in z:
            ds.bin_data = z["bin_data"]
            ds._num_data, ds._num_feature = ds.bin_data.shape
        else:
            from scipy.sparse import csc_matrix
            shape = tuple(z["sparse_shape"].tolist())
            ds.sparse_binned = csc_matrix(
                (z["sparse_data"], z["sparse_indices"],
                 z["sparse_indptr"]), shape=shape)
            ds._num_data, ds._num_feature = shape
        ds.num_total_bin = sum(m.num_bin for m in ds.bin_mappers)
        ds._feature_names = json.loads(str(z["feature_names"]))
        ds._categorical_indices = z["categorical"].tolist()
        if len(z["label"]):
            ds._label_arr = z["label"]
        if len(z["weight"]):
            ds._weight_arr = z["weight"]
        if len(z["query"]):
            ds._query_boundaries = z["query"]
        if "position" in z and len(z["position"]):
            ds.position = z["position"]
        if "efb" in z and str(z["efb"]):
            from .utils.efb import (BundleSpec, build_bundled,
                                    build_bundled_sparse)
            ds.efb = BundleSpec.from_dict(json.loads(str(z["efb"])))
            ds.bundle_data = (
                build_bundled(ds.bin_data, ds.efb)
                if ds.bin_data is not None
                else build_bundled_sparse(ds.sparse_binned, ds.efb,
                                          ds.bin_mappers))
        ds._handle_constructed = True
        return ds


def _log_trivial(mappers: List[BinMapper]) -> None:
    n_trivial = sum(m.is_trivial for m in mappers)
    if n_trivial:
        log.info(f"{n_trivial} trivial (constant) features found and "
                 "ignored for splitting")
