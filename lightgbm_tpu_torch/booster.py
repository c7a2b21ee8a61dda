"""`Booster`: training, model text in and out, host prediction, and
the export the serving runtime compiles.

The port's counterpart of `lightgbm_tpu/booster.py` (ref:
src/boosting/gbdt.cpp `GBDT::{Init,TrainOneIter,UpdateScore}`;
gbdt_model_text.cpp `SaveModelToString` / `LoadModelFromString`).

Training (`Booster(params, train_set)`, then `update`): the reference's
`_init_train`, `_boost_from_average`, `update` / `_update_impl`,
`__boost`, `_update_dart` and `_apply_tree_to_score`, for gbdt, goss,
dart (`_update_dart`) and rf (unshrunk trees grown at the base score,
averaged) on numerical and categorical features, on the bin matrix or
its EFB bundles (`Dataset.bundle_data`), assembled on the device from
a spilled set's shard store (`external_memory`, `datastore/`) or
uploaded from the host, with f32 histograms, or with
quantized gradients (`use_quantized_grad`: the int8 lattice and its
integer histograms), with every sampler of the reference (bagging,
per-class bagging, GOSS, `feature_fraction`, `feature_fraction_bynode`,
`extra_trees`), the grower's constraints (monotone, basic or
intermediate; interaction constraints; CEGB; forced splits; the
bounded histogram pool), linear trees (`_fit_linear_tree`, host f64
ridge fits) and custom objectives (`fobj`), with the strict leaf-wise
grower (`ops/grow.py`, the default `tree_grow_policy=leafwise`) or the
wave grower (`ops/grow_wave.py`, `tree_grow_policy=wave`; the
intermediate method and the pool keep the strict grower, with the
reference's warning).  The bin matrix, scores, gradients and
histograms live on the training device: the card by default
(`device_type="cuda"`: the K1 kernel makes every histogram, or on the
wave's fused path K2 and K3 make the histograms and split candidates;
with quantized gradients K4, or K5 and K3), the CPU with
`device_type="cpu"` (the plain versions).  One iteration is: gradients,
the round's sample weights (bagging or GOSS), their quantization
(stochastic rounding), one grown tree per class on the tree's feature
mask, the train score updated through the grower's final `leaf_id`,
each validation score through a bin-level replay of the tree.  Every
random draw is the reference's: the port's threefry (`ops/threefry.py`,
one launch of `csrc/threefry.cu` a draw on the card) from the same
keys.  Everything the slice does not implement raises `LightGBMError`
naming its ROADMAP item.

Around training (the reference's `booster.py:1358-3388`): `init_score`
as every score's base, `add_valid` after training started and the
scores rebuilt after `set_leaf_output` (the model replayed on the set's
bins in boosting order, `tree_leaf_ids`), `rollback_one_iter` (the last
iteration's cached contributions subtracted, deeper ones replayed),
`reset_parameter` (the grower rebuilt from the new config), `refit`,
`eval` / `eval_train` / `eval_valid` with `feval` (one device-to-host
copy of a set's scores a call, counted in `EVAL_COPIES`), and the
model's IO, analysis and pickling.

Loading: model text in and out, the host f64 walk (the host library's
`predict_rows`, `native/`, or `tree.py` for linear trees: the same
per-tree, boosting-order sum as the JAX package's host path), and
the stacked traversal planes plus the f64 leaf-value table
(`export_predict_arrays`) that `ServingRuntime` compiles.  `predict`
also gives leaf indices, TreeSHAP contributions (`contrib.py`) and
prediction early stop on the host, and with `device_predict` runs the
JAX package's f32 batch program on the card (within the plan, the fused
serving kernel's f32 instance).  The chunk entries (`update_chunk_eval`)
run 16 iterations with the scores after each.
"""
from __future__ import annotations

import copy
import hashlib
import io
import json
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import telemetry
from .basic import Dataset, _is_arrow, _is_sparse
from .basic import _to_2d_float as _dataset_matrix
from .contrib import predict_contrib
from .metrics import Metric, create_metrics
from .objectives import (UNIT_HESSIAN_OBJECTIVES, Objective,
                         TrainObjective, create_objective, parse_objective)
from .ops.fused import (bagging_weights, feature_mask, goss_weights,
                        quantize_gradients)
from .ops.grow import (QUANTIZED_IMPLS, DeviceTree, GrowerSpec, make_grower,
                       split_go_left, to_device, to_host)
from .ops.grow_wave import WAVE_WIDTH_DEFAULT, make_wave_grower
from .ops.renew import renew_leaf_values
from .ops.hist_kernel import MULTI_CHUNK
from .ops.hist_kernel_q import MULTI_CHUNK_Q
from .ops.histogram import PACKED_MAX_QUANT_BINS
from .ops.threefry import fold_in, prng_key
from .tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, Tree
from .utils import log
from .utils.binning import BIN_TYPE_CATEGORICAL
from .mesh.topology import (get_mesh, get_mesh_2level, parse_mesh_shape,
                            world_size)
from .parallel.learner import (make_distributed_grower, place_training_data,
                               resolve_tree_learner)
from .utils.config import _PARAMS, Config, canonical_param_name
from .utils.log import LightGBMError

#: blocking device-to-host copies of a set's scores for evaluation
#: (metrics and `feval`), one a set a call (`Booster._eval_score`)
EVAL_COPIES = 0

#: host seconds of the linear trees' leaf fits (`_fit_linear_tree`), summed
LINEAR_FIT_S = 0.0

#: Dataset parameters a training params dict hands to `construct()`
_DATASET_PARAMS = ("max_bin", "min_data_in_bin", "bin_construct_sample_cnt",
                   "use_missing", "zero_as_missing", "data_random_seed",
                   "max_bin_by_feature", "feature_pre_filter",
                   "enable_bundle", "max_conflict_rate", "linear_tree",
                   # a data file's columns and ingest, and the spill: they
                   # act in construct()
                   "label_column", "header", "weight_column",
                   "group_column", "ignore_column", "two_round",
                   "external_memory", "datastore_dir",
                   "datastore_shard_rows", "datastore_budget_mb",
                   "datastore_prefetch")


def _to_2d_float(data) -> np.ndarray:
    """Request matrix as C-contiguous 2-D f64 numpy (1-D = one row); a
    sparse matrix, an Arrow table, a DataFrame or a `Sequence` through
    the Dataset's conversion (`basic._to_2d_float`)."""
    if _is_sparse(data) or _is_arrow(data) or hasattr(data, "dtypes") \
            or not hasattr(data, "__array__") and not isinstance(
                data, (list, tuple)):
        data = _dataset_matrix(data)
    X = np.ascontiguousarray(np.asarray(data, dtype=np.float64))
    if X.ndim == 1:
        X = X.reshape(1, -1)
    if X.ndim != 2:
        raise LightGBMError(f"expected a 2-D feature matrix, got "
                            f"{X.ndim} dimensions")
    return X


def _flag(v) -> bool:
    """A boolean option; params reloaded from model text are strings."""
    return str(v).lower() in ("true", "1") if isinstance(v, str) \
        else bool(v)


#: rows a `device_predict` chunk holds
DEVICE_PREDICT_CHUNK = 1 << 16


class _PendingChunk(NamedTuple):
    """A chunk of `Booster.dispatch_chunk_eval` not harvested yet: its
    finished flag and the scores after each of its iterations, on the
    training device."""
    finished: bool                  # no tree of the chunk could split
    train: Optional[torch.Tensor]   # [C, ...] train scores, or None
    valid: Tuple                    # per valid set, [C, ...] scores


#: `device_predict` chunks routed through the stacked-plane traversal
#: (a model the compiled plan refuses: ROADMAP Queue 3 (q))
DEVICE_PREDICT_STACKED = 0


class _DevicePredict(NamedTuple):
    """`device_predict`'s tree slice on one device: the compiled plan's
    records (the plan route), or for a model the plan refuses the
    stacked planes (the stacked route, `records` None)."""
    records: Optional[Any]  # the plan's `DeviceRecords` (the plan route)
    stacked: Optional[Dict]  # the stacked planes (the stacked route)
    cls: Optional[torch.Tensor]   # [T] int32 class of tree t (K > 1)
    values: torch.Tensor    # [T, NL] float32 leaf values
    min_features: int
    num_class: int
    average_factor: int     # random-forest divisor (1: a plain sum)


def stage_rows(X: np.ndarray, device, pad: bool = True) -> torch.Tensor:
    """Rows X [m, F] as f32 on `device` (f64 values beyond the f32 range
    saturate to +-inf, the routing wanted); with `pad`, zero rows padded
    on to a multiple of ROW_BLOCK when m is above it (the standalone
    traverse's and the stacked route's batches are bucket-padded; the
    fused route takes any m), and the caller slices the padding away."""
    from .compiler.kernel import ROW_BLOCK
    m = X.shape[0]
    rows = m if m <= ROW_BLOCK or not pad else -(-m // ROW_BLOCK) * ROW_BLOCK
    buf = np.zeros((rows, X.shape[1]), np.float32)
    with np.errstate(over="ignore"):
        buf[:m] = X
    return torch.from_numpy(buf).to(device)


def train_device(device_type) -> torch.device:
    """The training device named by `device_type`: "cuda" (the default,
    the card; raises without one) or "cpu" (the plain versions)."""
    d = str(device_type).lower()
    if d == "cpu":
        return torch.device("cpu")
    if d != "cuda":
        raise LightGBMError(f"device_type={device_type!r}: the port trains "
                            "on 'cuda' (the default) or 'cpu'")
    if not torch.cuda.is_available():
        raise LightGBMError("device_type='cuda' but torch sees no CUDA "
                            "device; pass device_type='cpu' to train with "
                            "the plain versions on the CPU")
    return torch.device("cuda")


#: the ROADMAP item that brings the settings of `PLANES_SETTINGS`
PLANES = "ROADMAP Queue 1 item 5g: the planes on top"
#: settings the config accepts that no module of the port acts on yet
#: (the flight recorder, the telemetry sinks and spool, the debug
#: witnesses): `refusals` names each one set to other than its default
PLANES_SETTINGS = ("flight_recorder", "flight_recorder_depth",
                   "telemetry_sink", "telemetry_prometheus",
                   "telemetry_spool", "telemetry_spool_dir",
                   "debug_contracts", "debug_locks")
#: the reference's TCP transport settings, which warn and are ignored
NETWORK_SETTINGS = ("machines", "local_listen_port", "time_out")


def refusals(cfg: Config) -> List[str]:
    """Why this slice cannot train `cfg`: each entry names a setting and
    the ROADMAP item that brings it.  Empty when the slice covers it."""
    out = []
    if str(cfg.boosting).lower() not in ("gbdt", "goss", "dart", "rf"):
        out.append(f"unknown boosting type {cfg.boosting!r}")
    for name in PLANES_SETTINGS:
        value = getattr(cfg, name)
        if value != _PARAMS[name][0]:
            out.append(f"{name}={value!r} ({PLANES})")
    return out


def warn_network_settings(params: Dict[str, Any], cfg: Config) -> None:
    """The reference's warning (`booster.py:289-298`) for each socket-era
    network setting in `params` at other than its default: the port's
    ranks join a `torch.distributed` process group instead."""
    seen = {canonical_param_name(k) for k in params}
    for name in NETWORK_SETTINGS:
        if name in seen and getattr(cfg, name) != _PARAMS[name][0]:
            log.warning(
                f"Parameter {name} configures the reference's TCP "
                "transport and is ignored here — multi-process setup is "
                "lightgbm_tpu_torch.mesh.init() (a torch.distributed "
                "process group) + num_machines/tree_learner")


def _refuse(cfg: Config) -> None:
    reasons = refusals(cfg)
    if reasons:
        raise LightGBMError("the training slice of lightgbm_tpu_torch "
                            "does not cover: " + "; ".join(reasons))


#: `hist_impl` requests and the grower path of each (the fused names
#: resolve to their base family; `fused_split_of` decides the fusion)
_HIST_IMPLS = {"auto": None, "segment_sum": "plain", "packed": "packed",
               "pallas": "kernel", "pallas_fused": "kernel",
               "pallas_q": "kernel_q", "pallas_fused_q": "kernel_q"}


def uses_goss(cfg: Config) -> bool:
    """GOSS sampling: `boosting=goss`, or `data_sample_strategy=goss` (the
    reference's `_use_goss`, `booster.py:416`)."""
    return str(cfg.boosting).lower() == "goss" \
        or str(cfg.data_sample_strategy).lower() == "goss"


def quant_hist_reasons(cfg: Config, custom: bool = False) -> List[str]:
    """Why the integer-lattice histograms (K4/K5, packed) cannot take
    `cfg` (empty: they can), the reference's `_quant_hist_reasons`
    (`booster.py:926`): too many quantization bins, GOSS, whose
    rescaled weights (1 - a) / b break the lattice's integrality, or a
    custom objective (`custom`), whose negative hessians would borrow
    into the packed field.  Bagging weights are 0 or 1, which the
    lattice takes."""
    reasons = []
    if not 0 < cfg.num_grad_quant_bins <= PACKED_MAX_QUANT_BINS:
        reasons.append(f"num_grad_quant_bins={cfg.num_grad_quant_bins} "
                       f"outside (0, {PACKED_MAX_QUANT_BINS}]")
    if uses_goss(cfg):
        reasons.append("GOSS rescale weights break lattice integrality")
    if custom:
        reasons.append("custom objective (negative hessians would borrow "
                       "into the packed grad field)")
    return reasons


def _hist_impl_fallback(requested: str, reasons: List[str]) -> None:
    """The reference's priced warning (`_hist_impl_fallback`) for a
    request the chosen histograms cannot honour."""
    log.warning(f"hist_impl={requested} is not available with "
                + "; ".join(reasons)
                + " — degrading to the auto-selected path (the lattice "
                "kernels K4/K5 are the quantized fast path; this trains "
                "on the f32 histograms)")


def hist_impl_of(cfg: Config, device: torch.device,
                 custom: bool = False) -> str:
    """The grower's histogram path (`GrowerSpec.hist_impl`) for
    `cfg.hist_impl` on `device`, the reference's `_resolve_hist_impl`
    (`booster.py:975`) as it resolves on a TPU:
      * "auto": the lattice kernels ("kernel_q": K4, and K5 where the
        fused choice applies) when `use_quantized_grad` is on and
        `quant_hist_reasons` is empty, else the f32 kernels ("kernel":
        K1, K2 and K3); the wrappers run their plain versions on CPU
        tensors;
      * "pallas", "pallas_fused", "pallas_q", "pallas_fused_q": those
        kernels, which need a CUDA device (they raise on the CPU);
      * "segment_sum": the plain f32 histogram ("plain"), anywhere;
      * "packed": the plain packed integer histogram, anywhere.
    A quantized request the lattice cannot honour (no
    `use_quantized_grad`, or a `quant_hist_reasons` entry) logs the
    reference's priced warning and takes the "auto" choice: with
    quantized gradients those still train, on the f32 kernels.  Nothing
    else is swapped in."""
    req = str(cfg.hist_impl or "auto").lower()
    if req not in _HIST_IMPLS:
        raise LightGBMError(f"Unknown hist_impl {cfg.hist_impl!r} (expected "
                            f"one of {', '.join(_HIST_IMPLS)})")
    if req.startswith("pallas") and device.type != "cuda":
        raise LightGBMError(f"hist_impl={req} runs the CUDA kernels, which "
                            "need a CUDA device; use hist_impl=auto, "
                            "segment_sum or packed on the CPU")
    quant_reasons = quant_hist_reasons(cfg, custom)
    impl = _HIST_IMPLS[req]
    if impl is not None:
        reasons = []
        if impl in QUANTIZED_IMPLS:
            if not cfg.use_quantized_grad:
                reasons.append("use_quantized_grad=False (the int-lattice "
                               "needs quantized gradients)")
            reasons.extend(quant_reasons)
        if not reasons:
            return impl
        _hist_impl_fallback(req, reasons)
    elif cfg.use_quantized_grad and quant_reasons:
        _hist_impl_fallback("quantized", quant_reasons)
    return "kernel_q" if cfg.use_quantized_grad and not quant_reasons \
        else "kernel"


def packed_const_hess_level(cfg: Config, hist_impl: str, objective: str,
                            weighted: bool) -> int:
    """The reference's `_packed_const_hess_level` (`booster.py:570`): on
    the packed path, a unit-hessian objective with no dataset weights
    quantizes every live row to hq = num_grad_quant_bins, so the counts
    derive from the hessian field; 0 elsewhere."""
    if hist_impl != "packed" or objective not in UNIT_HESSIAN_OBJECTIVES \
            or weighted:
        return 0
    return int(cfg.num_grad_quant_bins)


def learner_topology(cfg: Config, bundled: bool = False):
    """(kind, shards, world, dcn, two_level): the learner and the mesh
    shape of `cfg` over this process group, the reference's
    `_learner_topology` (`booster.py:776`).  Shards: `mesh_shape` when
    set, else `num_machines` (> 1) or the group's world size, at most the
    world size; a 2-level ("dcn", "ici") mesh for `tpu_dcn_slices` > 1
    that divides them with >= 2 ranks a slice.  `kind` carries the EFB
    and 2-level downgrades but not the one-rank serial fallback; quiet."""
    name = cfg.tree_learner or "serial"
    kind = resolve_tree_learner(name, bundled=bundled, quiet=True)
    if kind == "serial":
        return "serial", 1, 1, 1, False
    world = world_size()
    dims = parse_mesh_shape(cfg.mesh_shape) if cfg.mesh_shape else None
    if dims is not None:
        shards = int(np.prod(dims))
        dcn = dims[0] if len(dims) == 2 else 1
        two = len(dims) == 2
    else:
        shards = cfg.num_machines if (cfg.num_machines or 0) > 1 else world
        shards = min(shards, world)
        dcn = max(int(cfg.tpu_dcn_slices or 1), 1)
        two = dcn > 1 and shards % dcn == 0 and shards // dcn > 1
    kind = resolve_tree_learner(name, bundled=bundled, two_level=two,
                                quiet=True)
    return kind, shards, world, dcn, two


def resolve_grow_policy(cfg: Config, monotone_intermediate: bool = False,
                        pool_slots: int = 0, learner: str = "serial") -> str:
    """`tree_grow_policy` resolved to "leafwise" or "wave" (the
    reference's `_resolve_grow_policy`, `booster.py:824`).  The wave
    takes every setting of the strict grower but three, which downgrade
    it to the strict grower with the reference's priced warning: the
    intermediate monotone method, the bounded histogram pool
    (`:845-856`) and a distributed `learner` other than data (`:857-862`;
    the one-rank fallback is serial); the reference's failing kernel
    probe does not apply.  An unknown policy raises."""
    pol = str(cfg.tree_grow_policy or "leafwise").lower()
    if pol in ("leafwise", "leaf", "strict"):
        return "leafwise"
    if pol not in ("wave", "batched"):
        raise LightGBMError(f"Unknown tree_grow_policy {pol!r} (expected "
                            "'leafwise' or 'wave')")
    reasons = []
    if monotone_intermediate:
        reasons.append("monotone_constraints_method=intermediate")
    if pool_slots:
        reasons.append(
            "histogram_pool_size (the bounded pool caps resident "
            f"histograms at {pool_slots} of {cfg.num_leaves}; dropping the "
            "cap restores the wave policy at the cost of the pool's "
            "memory bound)")
    if learner not in ("serial", "data"):
        reasons.append(f"tree_learner={learner} (wave supports serial and "
                       "data-parallel)")
    if reasons:
        log.warning("tree_grow_policy=wave is not supported with "
                    + "; ".join(reasons) + " — using the strict leafwise "
                    "policy")
        return "leafwise"
    return "wave"


def fused_split_of(cfg: Config, policy: str, hist_impl: str,
                   bundled: bool) -> bool:
    """Whether the wave grower takes the fused path (K2 + K3, or K5 + K3
    on the lattice), the reference's `_maybe_fuse_hist_impl`
    (`booster.py:1045`): the wave policy on the kernels' histogram path
    with `tpu_fused_split` on (the default), no path smoothing, no
    extra_trees (whose one threshold a feature the kernels' scan does
    not take) and no EFB bundles (the kernels scan the bundle columns'
    histograms, not the features', `:1071`).  Otherwise the wave runs
    unfused on K1 (K4), with a warning as in the reference; the port's
    kernels need no probe (`chip_smoke.py` holds them to their plain
    versions).  `feature_fraction_bynode` and categorical features stay
    fused: the mask gates `decide_from_candidates`, and the categorical
    features are searched on the carried histograms
    (`ops/grow_wave.py`)."""
    if hist_impl not in ("kernel", "kernel_q") or not cfg.tpu_fused_split:
        return False
    reasons = []
    if policy != "wave":
        if str(cfg.hist_impl or "auto").lower() not in ("pallas_fused",
                                                         "pallas_fused_q"):
            return False
        reasons.append("tree_grow_policy != wave (the strict policy "
                       "re-scans cached histograms per split)")
    if any(int(v) for v in (cfg.monotone_constraints or [])):
        # the kernels' scan is the closed-form gain; bounds need the
        # given-output gain (`booster.py:1068-1069`)
        reasons.append("monotone_constraints")
    if bundled:
        reasons.append("EFB bundling")
    if cfg.path_smooth > 0.0:
        reasons.append("path_smooth")
    if cfg.extra_trees:
        reasons.append("extra_trees")
    if reasons:
        kernel = "K4" if hist_impl == "kernel_q" else "K1"
        log.warning("fused hist+split is unavailable with "
                    + "; ".join(reasons) + f" — using the unfused {kernel} "
                    "histogram kernel and the torch split search")
        return False
    return True


class _DeviceData:
    """A constructed Dataset's bins and labels on the training device
    (the reference's `_DeviceData`, `booster.py:63-129`).  A training
    set that EFB bundles (`for_train`) also puts its [G, N] bundle
    matrix there (`bundle_fm`, what the growers read) and the bundle
    maps in `feat` (the reference's `_build_feat`, `:1122-1126`); a
    validation set is only routed through trees on its own bins.  A
    sparse training set that EFB bundles has no [N, F] bin matrix: its
    `bins_fm` is written from the binned CSC on first use (DART's and
    rollback's replays).  A spilled set (`Dataset.datastore`) assembles
    `bins_fm`, and `bundle_fm` when it bundles, from its shard store on
    first use (`datastore/assemble.py`), the reference's `:63-160`."""

    def __init__(self, ds: Dataset, device: torch.device,
                 for_train: bool = False, defer_bins: bool = False):
        ds.construct()
        self._ds = ds
        self.device = device
        self.num_data, self.num_feature = ds._num_data, ds._num_feature
        #: the shard store of a spilled set, None in memory
        self.store = ds.datastore
        #: the prefetch accounting of every assembly of this set
        self.pf_stats = None
        if self.store is not None:
            from .datastore import PrefetchRunStats
            self.pf_stats = PrefetchRunStats()
        # a distributed learner places its own rows (`defer_bins`): the
        # whole matrix goes to the device only if a path asks for it
        self._bins_fm = None if ds.bin_data is None or defer_bins \
            else torch.from_numpy(np.ascontiguousarray(ds.bin_data.T)).to(
                device)
        self.query_boundaries = ds._query_boundaries
        mappers = ds.bin_mappers
        self.nb_np = np.array([m.num_bin for m in mappers], np.int32)
        self.missing_np = np.array([m.missing_type for m in mappers],
                                   np.int32)
        self.is_cat_np = np.array(
            [m.bin_type == BIN_TYPE_CATEGORICAL for m in mappers], bool)
        self.feat = dict(
            nb=torch.from_numpy(self.nb_np).to(device),
            missing=torch.from_numpy(self.missing_np).to(device),
            default=torch.from_numpy(np.array(
                [m.default_bin for m in mappers], np.int32)).to(device),
            is_cat=torch.from_numpy(self.is_cat_np).to(device),
            nb_np=self.nb_np, missing_np=self.missing_np)
        self.efb = ds.efb if for_train else None
        self._bundle_fm = None
        if self.efb is not None:
            if self.store is None or "bundle" not in self.store.payloads:
                if ds.bundle_data is None:
                    from .utils.efb import build_bundled, \
                        build_bundled_sparse
                    ds.bundle_data = build_bundled_sparse(
                        ds.sparse_binned, self.efb, ds.bin_mappers) \
                        if ds.bin_data is None and \
                        ds.sparse_binned is not None else build_bundled(
                            ds._dense_bin_matrix(), self.efb)
                if not defer_bins:
                    self._bundle_fm = torch.from_numpy(np.ascontiguousarray(
                        ds.bundle_data.T)).to(device)
            efb = self.efb
            self.feat.update(
                bundle_col=torch.from_numpy(
                    efb.col_of_feature.astype(np.int64)).to(device),
                bundle_off=torch.from_numpy(
                    efb.off_of_feature.astype(np.int64)).to(device),
                bundle_identity=torch.from_numpy(
                    np.asarray(efb.identity, bool)).to(device),
                bundle_col_np=efb.col_of_feature,
                bundle_off_np=efb.off_of_feature)
        self.allowed = torch.from_numpy(np.array(
            [not m.is_trivial for m in mappers], bool)).to(device)
        self.max_bin = int(self.nb_np.max())
        label = ds.get_label()
        self.label = torch.from_numpy(label.astype(np.float32)).to(device) \
            if label is not None else None
        w = ds.get_weight()
        self.weight = torch.from_numpy(w.astype(np.float32)).to(device) \
            if w is not None else None
        self.init_score = ds.get_init_score()
        # the raw values, which a Dataset built for linear trees keeps
        # (`Dataset.construct`): the leaves' fits and their scores read
        # them on the host
        self.raw_ref = ds.data
        self._raw2d: Optional[np.ndarray] = None

    def _assemble(self, payload: str) -> torch.Tensor:
        from .datastore.assemble import assemble_feature_major
        return assemble_feature_major(
            self.store, self.device, payload=payload,
            prefetch_depth=Config(self._ds.params or {}).datastore_prefetch,
            run_stats=self.pf_stats)

    @property
    def bins_fm(self) -> torch.Tensor:
        if self._bins_fm is None:
            self._bins_fm = self._assemble("bins") if self.store is not None \
                else torch.from_numpy(np.ascontiguousarray(
                    self._ds._dense_bin_matrix().T)).to(self.device)
        return self._bins_fm

    @property
    def bundle_fm(self) -> Optional[torch.Tensor]:
        """The [G, N] bundle matrix a bundled training set's growers read
        (None unbundled)."""
        if self._bundle_fm is None and self.efb is not None:
            self._bundle_fm = self._assemble("bundle") \
                if self.store is not None and "bundle" in self.store.payloads \
                else torch.from_numpy(np.ascontiguousarray(
                    self._ds.bundle_data.T)).to(self.device)
        return self._bundle_fm

    @property
    def pending(self) -> bool:
        """A spilled set whose training matrix is not assembled yet."""
        if self.store is None:
            return False
        return (self._bundle_fm if self.efb is not None
                else self._bins_fm) is None

    def get_raw(self) -> np.ndarray:
        """The set's raw matrix as f64 [N, F] (the reference's
        `_DeviceData.get_raw`, `booster.py:183`)."""
        if self._raw2d is None:
            if self.raw_ref is None:
                raise LightGBMError(
                    "linear_tree needs raw feature values; construct the "
                    "Dataset with linear_tree in params (or "
                    "free_raw_data=False)")
            self._raw2d = _to_2d_float(self.raw_ref)
        return self._raw2d


def _replay_splits(split_leaf, split_feature, threshold_bin, default_left,
                   is_cat, cat_masks, dd: _DeviceData) -> torch.Tensor:
    """[N] leaf slots of `dd`'s rows after the splits, in growth order:
    split i sends the rows of slot `split_leaf[i]` that go right to slot
    i + 1 (tree.h `Tree::Split`).  `cat_masks` [S, MB] are the left bins
    of the categorical splits (rows of the others unused), uploaded once
    without a sync; None when no split is categorical."""
    device = dd.device
    lid = torch.zeros(dd.num_data, dtype=torch.int32, device=device)
    masks = to_device(cat_masks, device) if cat_masks is not None else None
    for i in range(len(split_leaf)):
        f = int(split_feature[i])
        go_left = split_go_left(dd.bins_fm, f, int(threshold_bin[i]),
                                bool(default_left[i]),
                                int(dd.missing_np[f]), int(dd.nb_np[f]),
                                cat_mask=masks[i] if is_cat[i] else None)
        lid = torch.where((lid == int(split_leaf[i])) & ~go_left,
                          i + 1, lid)
    return lid


def replay_leaf_ids(dev: DeviceTree, dd: _DeviceData) -> torch.Tensor:
    """[N] leaf slots of `dd`'s rows in a grown tree, by replaying its
    splits in growth order on the bins (the reference's
    `ops/predict.py:75 replay_leaf_ids`; the same leaves as its
    bin-level traversal `traverse_bins`)."""
    ns = dev.n_splits
    is_cat = np.asarray(dev.split_is_cat[:ns], bool)
    return _replay_splits(dev.split_leaf[:ns], dev.split_feature[:ns],
                          dev.threshold_bin[:ns], dev.default_left[:ns],
                          is_cat, dev.split_cat_mask[:ns]
                          if is_cat.any() else None, dd)


def tree_leaf_ids(tree: Tree, dd: _DeviceData) -> torch.Tensor:
    """[N] leaf indices of `dd`'s rows in a host `Tree`, by the same
    bin-level replay (`replay_leaf_ids`): the leaves of the reference's
    `traverse_bins` over `_traverse_padded`.  Node i's split leaf is the
    leaf its left chain ends in (the split leaf keeps its index on the
    left); categorical nodes take their bin masks from
    `tree.cat_bin_masks`, so a loaded tree needs
    `recompute_threshold_bins` first."""
    ni = tree.num_internal()
    left, right = tree.left_child[:ni], tree.right_child[:ni]
    order = np.arange(ni)
    if ((left >= 0) & (left <= order)).any() or \
            ((right >= 0) & (right <= order)).any():
        raise LightGBMError("bin-level replay needs the nodes in growth "
                            "order (every child after its parent)")
    split_leaf = np.empty(ni, np.int64)
    for i in range(ni):
        c = int(left[i])
        while c >= 0:
            c = int(tree.left_child[c])
        split_leaf[i] = ~c
    dtype = tree.decision_type[:ni]
    is_cat = (dtype & K_CATEGORICAL_MASK) != 0
    masks = None
    if is_cat.any():
        masks = np.zeros((ni, dd.max_bin), bool)
        for i in np.nonzero(is_cat)[0]:
            m = tree.cat_bin_masks[int(tree.threshold_bin[i])]
            masks[i, :min(len(m), dd.max_bin)] = m[:dd.max_bin]
    return _replay_splits(split_leaf, tree.split_feature[:ni],
                          tree.threshold_bin[:ni],
                          (dtype & K_DEFAULT_LEFT_MASK) != 0, is_cat, masks,
                          dd)


class Booster:
    """A LightGBM model: trained here from a `Dataset`, or loaded from
    model text.

    `Booster(params, train_set)` prepares training (`update`,
    `update_many`, `add_valid`, `eval_train`, `eval_valid`);
    `Booster(model_file=path)` or `Booster(model_str=text)` loads."""

    def __init__(self, params: Optional[Dict] = None, train_set=None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params: Dict = copy.deepcopy(params) if params else {}
        self.best_iteration = -1
        self.best_score: Dict = {}
        self.trees: List[Tree] = []
        self.num_tree_per_iteration = 1
        self.objective_: Optional[Objective] = None
        self.pandas_categorical = None
        self._average_output = False
        self._loaded_feature_names: List[str] = []
        self._loaded_feature_infos: List[str] = []
        self._export_cache = None
        self._device_predict_cache = None
        #: bumped by every change to the trees (`_model_changed`); the
        #: serving runtime compares it with its export's to say `stale`
        self._model_version = 0
        self._inflight: "deque[_PendingChunk]" = deque()
        self.train_set: Optional[Dataset] = None
        self.valid_sets: List[Dataset] = []
        self.name_valid_sets: List[str] = []
        self.cur_iter = 0
        self._attr: Dict[str, str] = {}
        self._last_contribs: List = []
        self._scores_stale = False
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be a "
                                "lightgbm_tpu_torch Dataset, met "
                                f"{type(train_set).__name__}")
            self._init_train(train_set)
        elif model_file is not None:
            with open(model_file, "r") as f:
                self.model_from_string(f.read())
        elif model_str is not None:
            self.model_from_string(model_str)
        else:
            raise TypeError("Need a training dataset, a model file or a "
                            "model string to create a Booster")

    # ------------------------------------------------------- training
    def _init_train(self, train_set: Dataset) -> None:
        """ref: the JAX package's `Booster._init_train` (`booster.py:301`),
        its default path."""
        # a callable objective is the custom objective: `fobj` of every
        # update, with objective "none" (the reference's `:304-308`)
        self._fobj = None
        if callable(self.params.get("objective")):
            self._fobj = self.params["objective"]
            self.params["objective"] = "none"
        cfg = self.config = Config(self.params)
        _refuse(cfg)
        warn_network_settings(self.params, cfg)
        self.device = train_device(cfg.device_type)
        # armed before the device data, so its uploads are attributed
        # from the first byte (the reference's `booster.py:324`)
        telemetry.MEMLEDGER.configure(
            enabled=bool(cfg.memory_ledger),
            reconcile_ms=float(cfg.memory_reconcile_ms))
        train_set.params = {**(train_set.params or {}), **{
            k: v for k, v in self.params.items() if k in _DATASET_PARAMS}}
        if str(cfg.streaming_train or "auto").lower() == "on":
            # the shard store is what streams: "on" implies the spill
            train_set.params["external_memory"] = True
        train_set.construct()
        self.train_set = train_set
        self._dd = _DeviceData(
            train_set, self.device, for_train=True,
            defer_bins=world_size() > 1 and str(
                cfg.tree_learner or "serial").lower() != "serial")
        obj: Optional[TrainObjective] = create_objective(cfg)
        self._train_obj = obj
        label = train_set.get_label()
        if obj is None:
            self.objective_ = None
            self.num_tree_per_iteration = max(cfg.num_class, 1)
        else:
            self.objective_ = obj.link()
            self.num_tree_per_iteration = obj.num_tree_per_iteration
            if label is None:
                raise LightGBMError("Label should not be None")
            obj.init_meta(label.astype(np.float64), train_set.get_weight(),
                          train_set._query_boundaries)
            if train_set.position is not None:
                if hasattr(obj, "set_positions"):
                    obj.set_positions(train_set.get_position())
                else:
                    log.warning(
                        "Dataset positions are only consumed by the "
                        "lambdarank objective — positions have NO effect "
                        f"on objective={obj.name}")
        #: the position-debiased lambdarank's propensities, updated by
        #: every gradient call (the reference's `booster.py:549-560`)
        self._obj_state = obj.init_state(self.device) \
            if getattr(obj, "has_state", False) else None
        self.metrics_: List[Metric] = create_metrics(
            cfg, cfg.metric or cfg.default_metric())
        self._loaded_feature_names = train_set.get_feature_name()
        self._loaded_feature_infos = [m.feature_info_str()
                                      for m in train_set.bin_mappers]
        # the boosting mode, fixed for the booster's life (the
        # reference's `booster.py:413-433`): goss is gbdt with GOSS
        # sampling; a random forest averages unshrunk trees grown at the
        # base score and needs bagging; rf and dart start from 0
        boosting = str(cfg.boosting).lower()
        self._boost_mode = "gbdt" if boosting == "goss" else boosting
        if self._boost_mode == "rf":
            if not (cfg.bagging_freq > 0 and (cfg.bagging_fraction < 1.0
                                              or cfg.feature_fraction < 1.0)):
                raise LightGBMError(
                    "Random forest mode requires bagging "
                    "(bagging_freq > 0 and bagging_fraction < 1.0)")
        if self._boost_mode in ("rf", "dart"):
            cfg.boost_from_average = False
        self._average_output = self._boost_mode == "rf"
        #: the iterations the last DART update dropped
        self.dart_dropped: List[int] = []
        self._use_goss = uses_goss(cfg)
        self._build_grower()
        K = self.num_tree_per_iteration
        self._init_scores = [0.0] * K
        self._boost_from_average_done = False
        self._train_score = self._zero_score(self._dd)
        self._valid_dd: List[_DeviceData] = []
        self._valid_scores: List[torch.Tensor] = []
        self._ones = torch.ones(self._dd.num_data, dtype=torch.float32,
                                device=self.device)
        # threefry keys, kept on the host: their words reach the card as
        # kernel arguments, no sync.  key0 draws the bags, GOSS and the
        # quantizer's rounding; ff_key0 the trees' and nodes' features
        self._rng_key0 = prng_key(cfg.bagging_seed % (2 ** 31))
        self._ff_key0 = prng_key(cfg.feature_fraction_seed % (2 ** 31))
        # rank_xendcg's gammas: fold_in(key, iteration)
        self._grad_key0 = prng_key(cfg.objective_seed % (2 ** 31))

    def _build_grower(self) -> None:
        """The grower of `self.config`, built anew: the histogram path,
        the spec (the wave's width, strict tail and slot chunk, the
        quantized path's constant-hessian level) and the grow function
        (`_init_train`, and `reset_parameter` after a change)."""
        cfg = self.config
        self.hist_impl = hist_impl_of(cfg, self.device,
                                      custom=self._train_obj is None)
        efb = self._dd.efb
        obj = self._train_obj
        interm = self._monotone_intermediate()
        pool_slots = self._hist_pool_slots()
        if interm and pool_slots:
            log.warning("monotone_constraints_method=intermediate needs "
                        "per-leaf histograms to re-search moved leaves — "
                        "ignoring histogram_pool_size")
            pool_slots = 0
        kind, shards = learner_topology(cfg, efb is not None)[:2]
        self._grow_policy = resolve_grow_policy(
            cfg, interm, pool_slots, kind if shards > 1 else "serial")
        wave = self._grow_policy == "wave"
        self._build_feat()
        cegb = self._cegb_active()
        self._grower_spec = GrowerSpec(
            num_leaves=cfg.num_leaves, max_depth=cfg.max_depth,
            max_bin=self._dd.max_bin, lambda_l1=cfg.lambda_l1,
            lambda_l2=cfg.lambda_l2,
            min_data_in_leaf=float(cfg.min_data_in_leaf),
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            min_gain_to_split=cfg.min_gain_to_split,
            max_delta_step=cfg.max_delta_step, path_smooth=cfg.path_smooth,
            hist_impl=self.hist_impl,
            packed_const_hess_level=packed_const_hess_level(
                cfg, self.hist_impl, getattr(obj, "name", None),
                self._dd.weight is not None),
            debug_checks=bool(cfg.tpu_debug_nans),
            wave_width=self._wave_width() if wave else 0,
            wave_gain_ratio=self._wave_gain_ratio() if wave else 0.0,
            wave_overgrow=self._wave_overgrow() if wave else 0.0,
            wave_strict_tail=self._wave_strict_tail() if wave else 0,
            fused=fused_split_of(cfg, self._grow_policy, self.hist_impl,
                                 efb is not None),
            feature_fraction_bynode=cfg.feature_fraction_bynode,
            extra_trees=bool(cfg.extra_trees),
            cat_smooth=cfg.cat_smooth, cat_l2=cfg.cat_l2,
            max_cat_threshold=cfg.max_cat_threshold,
            max_cat_to_onehot=cfg.max_cat_to_onehot,
            has_cat=bool(self._dd.is_cat_np.any()),
            bundled=efb is not None,
            bundle_max_bin=efb.max_bin if efb is not None else 0,
            hist_pool_slots=pool_slots,
            n_ic_groups=0 if self._ic_groups is None
            else self._ic_groups.shape[0],
            forced_splits=self._parse_forced_splits(),
            cegb_tradeoff=cfg.cegb_tradeoff if cegb else 0.0,
            cegb_penalty_split=cfg.cegb_penalty_split,
            cegb_coupled=bool(list(cfg.cegb_penalty_feature_coupled or [])),
            cegb_lazy=bool(list(cfg.cegb_penalty_feature_lazy or [])),
            monotone_intermediate=interm)
        self._grower = make_wave_grower(self._grower_spec) if wave \
            else make_grower(self._grower_spec)
        if self._setup_tree_learner():
            self._streaming = None
        else:
            self._setup_streaming()

    def _setup_tree_learner(self) -> bool:
        """The reference's `_setup_tree_learner` (`booster.py:1150`):
        `tree_learner` data, feature or voting over a process group of
        more than one rank replaces the grower just built by this rank's
        part of the distributed one (`parallel/learner.py`) and places
        this rank's rows (every row for the feature learner; a spilled
        set's from the shards that hold them).  One rank, or a rank
        outside a mesh of `num_machines` ranks, trains with the serial
        learner.  Returns whether the learner is distributed."""
        cfg = self.config
        dd = self._dd
        bundled = dd.efb is not None
        kind, shards, world, dcn, two = learner_topology(cfg, bundled)
        self._dist_bins = None
        if kind == "serial":
            return False
        wave = self._grow_policy == "wave"
        key = (self._grower_spec, kind, shards, dcn if two else 1, wave,
               bool(cfg.deterministic_reduce), int(cfg.top_k))
        if getattr(self, "_learner_cache_key", None) == key:
            if self._dist_grower is None:
                return False
            self._grower, self._dist_bins = self._dist_grower
            return True
        # the configuration's warnings, once
        resolve_tree_learner(cfg.tree_learner, bundled=bundled,
                             two_level=two)
        if (cfg.num_machines or 0) > world:
            log.warning(f"num_machines={cfg.num_machines} exceeds the "
                        f"ranks of the process group ({world}); using "
                        f"{world}")
        if dcn > 1 and not two:
            log.warning(f"cannot build a 2-level mesh from {shards} rank(s) "
                        f"with tpu_dcn_slices={dcn} (need an even division "
                        "with >= 2 ranks per slice); using a flat mesh")
        self._learner_cache_key = key
        self._dist_grower = None
        if shards <= 1:
            log.warning(f"tree_learner={kind} requested but only one rank "
                        "is in the process group; using the serial learner")
            return False
        if str(cfg.streaming_train or "auto").lower() == "on":
            telemetry.REGISTRY.counter("fallback.events").inc()
            telemetry.event("fallback.stream_downgrade",
                            reasons=[f"tree_learner={kind}"])
            log.warning("streaming_train=on is not supported with "
                        f"tree_learner={kind} (shard-streamed training is "
                        "serial-only; distributed learners read their rows "
                        "once at placement instead) — training on the "
                        "placed device matrix")
        mesh_key = (shards, dcn if two else 1)
        if getattr(self, "_mesh_key", None) != mesh_key:
            # every rank of the group builds the same groups, in order
            self._mesh = get_mesh_2level(dcn, shards // dcn) if two \
                else get_mesh(shards)
            self._mesh_key = mesh_key
        if not self._mesh.member:
            log.info(f"tree_learner={kind}: this rank is outside the "
                     f"{shards}-rank mesh; training with the serial learner")
            return False
        grow = make_distributed_grower(
            self._grower_spec, self._mesh, kind, dd.num_feature,
            dd.num_data, wave=wave,
            det_reduce=bool(cfg.deterministic_reduce), top_k=cfg.top_k)
        payload = "bundle" if bundled else "bins"
        if kind == "feature":
            bins = dd.bundle_fm if bundled else dd.bins_fm
        elif dd.store is not None and dd.pending:
            bins = place_training_data(
                None, grow.sharding, self.device, store=dd.store,
                payload=payload, prefetch_depth=cfg.datastore_prefetch,
                run_stats=dd.pf_stats)
        else:
            ds = self.train_set
            bins = place_training_data(
                ds.bundle_data if bundled else ds._dense_bin_matrix(),
                grow.sharding, self.device)
        self._dist_grower = (grow, bins)
        self._grower, self._dist_bins = grow, bins
        log.info(f"tree_learner={kind}: training sharded over {shards} "
                 "rank(s)")
        return True

    def _setup_streaming(self) -> bool:
        """The reference's `_setup_streaming` (`booster.py:1264`): install
        the shard-streamed grower (`streaming/engine.py`) in place of the
        one just built, for a spilled set not assembled yet.  "off"
        assembles; "auto" streams when the spilled bins exceed
        `datastore_budget_mb`; "on" streams.  Where the grower cannot
        stream (EFB, forced splits, the intermediate monotone method, the
        histogram pool, DART, linear trees) both warn as the reference
        does and assemble.  Returns whether it streams."""
        cfg = self.config
        mode = str(cfg.streaming_train or "auto").lower()
        if mode not in ("auto", "on", "off"):
            raise LightGBMError(f"Unknown streaming_train {mode!r} "
                                "(expected 'auto', 'on' or 'off')")
        self._streaming = None
        if mode == "off":
            return False
        from .streaming import streaming_downgrade_reasons, streaming_spec
        store = self._dd.store if self._dd.pending else None
        spec = streaming_spec(self._grower_spec, self._grow_policy)
        reasons = streaming_downgrade_reasons(spec, store)
        if self._boost_mode == "dart":
            reasons.append("boosting=dart (drop replay traverses the "
                           "resident train bins)")
        if cfg.linear_tree:
            reasons.append("linear_tree (leaf fits read the raw matrix)")
        if mode == "auto":
            if store is None or \
                    store.total_bytes("bins") <= \
                    float(cfg.datastore_budget_mb) * 2 ** 20:
                return False
            if reasons:
                telemetry.REGISTRY.counter("fallback.events").inc()
                telemetry.event("fallback.stream_downgrade", reasons=reasons)
                log.warning(
                    "the assembled bin matrix exceeds datastore_budget_mb"
                    f"={cfg.datastore_budget_mb} but streamed training is "
                    "not supported with " + "; ".join(reasons) + " — "
                    "assembling anyway (device memory is the ceiling)")
                return False
        elif reasons:
            telemetry.REGISTRY.counter("fallback.events").inc()
            telemetry.event("fallback.stream_downgrade", reasons=reasons)
            log.warning("streaming_train=on is not supported with "
                        + "; ".join(reasons) + " — using in-memory "
                        "training (device memory is the ceiling, not "
                        "datastore_budget_mb)")
            return False
        depth = int(cfg.streaming_prefetch_depth or cfg.datastore_prefetch)
        key = (spec, depth)
        if getattr(self, "_stream_cache_key", None) != key:
            from .streaming import StreamingWaveGrower
            self._stream_engine = StreamingWaveGrower(
                spec, store, prefetch_depth=depth,
                run_stats=self._dd.pf_stats,
                budget_mb=float(cfg.datastore_budget_mb))
            self._stream_cache_key = key
            log.info(f"streaming_train: shard-streamed training engaged "
                     f"({store.n_shards} shards x ~{store.shard_rows} rows; "
                     "the bins never go to the device whole)")
        self._streaming = self._stream_engine
        self._grower = self._stream_engine
        return True

    def _train_bins(self) -> Optional[torch.Tensor]:
        """The matrix the grower reads: the bundle matrix under EFB, else
        the bins (a spilled set assembles them on first use); None while
        streaming, whose grower reads the shard store."""
        if self._streaming is not None:
            return None
        if getattr(self, "_dist_bins", None) is not None:
            return self._dist_bins
        dd = self._dd
        return dd.bins_fm if dd.bundle_fm is None else dd.bundle_fm

    # ---- the grower's constraints (the reference's `booster.py:586-692`,
    # `:1108-1148`)
    def _monotone_intermediate(self) -> bool:
        """Whether the strict grower runs the intermediate monotone method
        (ref: monotone_constraints.hpp `IntermediateLeafConstraints`):
        `advanced` downgrades to it with a warning."""
        cfg = self.config
        if not any(int(v) for v in (cfg.monotone_constraints or [])):
            return False
        method = (cfg.monotone_constraints_method or "basic").lower()
        if method == "basic":
            return False
        if method == "advanced":
            log.warning(
                "monotone_constraints_method=advanced is not implemented "
                "— using intermediate (ref: monotone_constraints.hpp "
                "AdvancedLeafConstraints is out of scope)")
        elif method != "intermediate":
            raise LightGBMError(
                f"Unknown monotone_constraints_method {method}")
        return True

    def _cegb_active(self) -> bool:
        """CEGB prices candidates when a penalty is set (ref:
        cost_effective_gradient_boosting.hpp `IsEnable`)."""
        cfg = self.config
        return cfg.cegb_tradeoff > 0.0 and (
            cfg.cegb_penalty_split > 0.0
            or bool(list(cfg.cegb_penalty_feature_coupled or []))
            or bool(list(cfg.cegb_penalty_feature_lazy or [])))

    def _parse_ic_groups(self) -> Optional[np.ndarray]:
        """`interaction_constraints` ("[0,1,2],[2,3]" or lists) as [K, F]
        group masks."""
        raw = self.config.interaction_constraints
        if raw is None or raw == "" or raw == []:
            return None
        if isinstance(raw, str):
            try:
                groups = json.loads(raw)
            except json.JSONDecodeError:
                groups = json.loads(f"[{raw}]")
        else:
            groups = [list(g) for g in raw]
        F = self._dd.num_feature
        mask = np.zeros((len(groups), F), dtype=bool)
        for k, g in enumerate(groups):
            for j in g:
                if not 0 <= int(j) < F:
                    raise LightGBMError(
                        f"interaction_constraints feature index {j} out of "
                        f"range [0, {F})")
                mask[k, int(j)] = True
        return mask

    def _parse_forced_splits(self) -> tuple:
        """The forced-splits JSON (nested {feature, threshold, left,
        right}; ref: serial_tree_learner.cpp `ForceSplits`) as BFS-order
        (leaf slot, feature, threshold bin) tuples in the growers' child
        numbering (the right child of step s is leaf s + 1)."""
        fn = self.config.forcedsplits_filename
        if not fn:
            return ()
        with open(fn) as f:
            root = json.load(f)
        if not root:
            return ()
        mappers = self.train_set.bin_mappers
        out = []
        queue = [(root, 0)]
        while queue and len(out) < self.config.num_leaves - 1:
            node, leaf = queue.pop(0)
            j = int(node["feature"])
            thr = float(node["threshold"])
            out.append((leaf, j, int(mappers[j].value_to_bin(thr))))
            if node.get("left"):
                queue.append((node["left"], leaf))
            if node.get("right"):
                queue.append((node["right"], len(out)))
        return tuple(out)

    def _hist_pool_slots(self) -> int:
        """The histogram pool's slots from `histogram_pool_size` MB of
        [cols, bins, 3] f32 histograms (ref: config.h
        histogram_pool_size), at least 2; 0 (one a leaf) when it holds
        num_leaves or when unset."""
        pool_mb = self.config.histogram_pool_size
        if pool_mb is None or pool_mb <= 0:
            return 0
        efb = self._dd.efb
        bins, cols = (efb.max_bin, efb.n_cols) if efb is not None \
            else (self._dd.max_bin, self._dd.num_feature)
        slots = max(2, int(pool_mb * 2 ** 20 // max(cols * bins * 3 * 4, 1)))
        return slots if slots < self.config.num_leaves else 0

    def _build_feat(self) -> None:
        """The constraints' per-feature metadata the growers read beside
        `_DeviceData.feat` (the reference's `_build_feat`): `mono` (shorter
        vectors zero-extended), the interaction groups, the CEGB vectors
        and the model's used features, `cegb_used`, which `_boost`
        updates after each tree."""
        cfg = self.config
        dd = self._dd
        F = dd.num_feature
        extra: Dict[str, Any] = {}
        mono_cfg = list(cfg.monotone_constraints or [])
        if any(int(v) for v in mono_cfg):
            mono = np.zeros(F, np.int32)
            k = min(len(mono_cfg), F)
            mono[:k] = np.asarray(mono_cfg[:k], np.int32)
            extra.update(mono=torch.from_numpy(mono).to(self.device),
                         mono_np=mono)
        self._ic_groups = self._parse_ic_groups()
        if self._ic_groups is not None:
            extra.update(ic_groups=torch.from_numpy(self._ic_groups)
                         .to(self.device), ic_groups_np=self._ic_groups)
        if self._cegb_active():
            def vec(v):
                out = np.zeros(F, np.float32)
                vals = list(v or [])
                out[:min(len(vals), F)] = vals[:F]
                return torch.from_numpy(out).to(self.device)
            extra.update(
                cegb_coupled=vec(cfg.cegb_penalty_feature_coupled),
                cegb_lazy=vec(cfg.cegb_penalty_feature_lazy),
                cegb_used=torch.zeros(F, dtype=torch.bool,
                                      device=self.device))
            self._cegb_used = np.zeros(F, bool)
        self._feat_extra = extra

    # ---- the wave policy's knobs (the reference's `booster.py:703-774`)
    WAVE_GAIN_RATIO_DEFAULT = 0.0
    WAVE_OVERGROW_DEFAULT = 0.0

    def _wave_width(self) -> int:
        """Leaves per batched histogram pass: `tpu_wave_width=0` (auto)
        is `WAVE_WIDTH_DEFAULT`, or the cap under overgrow; the cap is
        the kernels' slot chunk, 14 for f32 histograms and 42 for the
        quantized lattice."""
        cap = MULTI_CHUNK_Q if self.hist_impl in QUANTIZED_IMPLS \
            else MULTI_CHUNK
        w = int(self.config.tpu_wave_width or 0)
        if w <= 0:
            w = cap if self._wave_overgrow() > 1.0 else WAVE_WIDTH_DEFAULT
        return min(w, cap)

    def _wave_gain_ratio(self) -> float:
        r = float(self.config.tpu_wave_gain_ratio)
        return self.WAVE_GAIN_RATIO_DEFAULT if r < 0.0 else min(r, 1.0)

    def _wave_strict_tail(self) -> int:
        """`tpu_wave_strict_tail=-1` (auto) is (num_leaves + 1) // 2, or 0
        under overgrow; 0 disables the strict endgame."""
        t = int(self.config.tpu_wave_strict_tail)
        if t < 0:
            t = 0 if self._wave_overgrow() > 1.0 \
                else (self.config.num_leaves + 1) // 2
        return max(t, 0)

    def _wave_overgrow(self) -> float:
        """Grow-then-prune factor (0 = off), for the wave policy only; off
        with a warning under monotone constraints or path smoothing, where
        a pruned parent's restored output would ignore the clamp and
        smoothing chain."""
        r = float(self.config.tpu_wave_overgrow)
        val = self.WAVE_OVERGROW_DEFAULT if r < 0.0 else r
        if val <= 1.0:
            return 0.0
        if any(int(v) for v in (self.config.monotone_constraints or [])) \
                or self.config.path_smooth > 0.0:
            if not getattr(self, "_warned_overgrow", False):
                self._warned_overgrow = True
                log.warning("tpu_wave_overgrow is not supported with "
                            "monotone constraints or path smoothing "
                            "(pruned parents restore un-clamped outputs) "
                            "— growing without overgrow")
            return 0.0
        return val

    def _zero_score(self, dd: _DeviceData) -> torch.Tensor:
        """A set's score base: zeros plus its `init_score` ([N * K]
        class-major), uploaded pinned (the reference's `_zero_score`,
        `booster.py:1349`)."""
        K = self.num_tree_per_iteration
        shape = (dd.num_data,) if K == 1 else (dd.num_data, K)
        device = dd.device
        score = torch.zeros(shape, dtype=torch.float32, device=device)
        if dd.init_score is not None:
            s = np.asarray(dd.init_score, dtype=np.float32)
            score = score + to_device(s.reshape(shape, order="F"), device)
        return score

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """ref: basic.py `Booster.add_valid` (the JAX package's
        `booster.py:1358`): after training started, the model so far is
        replayed onto the new set's bins in boosting order, onto the bare
        init-score base (iteration 0's trees carry the folded-in
        boost_from_average bias)."""
        self._require_train_data()
        if data.reference is None:
            data.reference = self.train_set
        if self.config.linear_tree:
            # linear leaves score the set's raw values
            data.params = {**(data.params or {}), "linear_tree": True}
        dd = _DeviceData(data, self.device)
        self.valid_sets.append(data)
        self.name_valid_sets.append(name)
        self._valid_dd.append(dd)
        self._valid_scores.append(self._replay_model(dd))
        return self

    def _replay_model(self, dd: _DeviceData) -> torch.Tensor:
        """`dd`'s scores from the trees of every iteration so far, onto
        its bare init-score base (the reference's replay in `add_valid`
        and `_rebuild_train_scores`), on `dd`'s device."""
        score = self._zero_score(dd)
        K = self.num_tree_per_iteration
        for it in range(self.cur_iter):
            for k in range(K):
                self._apply_tree_to_score(score, self.trees[it * K + k], dd,
                                          k, bias_included=True)
        return score

    def _apply_tree_to_score(self, score: torch.Tensor, tree: Tree,
                             dd: _DeviceData, k: int, bias_included: bool,
                             subtract: bool = False, bias: float = 0.0
                             ) -> torch.Tensor:
        """Add (or `subtract`) one tree's contribution to `score` in
        place, by bin-level replay (the reference's
        `_apply_tree_to_score` and `_subtract_tree`, `booster.py:1774,
        2320`): the f32 cast of `leaf_value - bias` at each row's leaf; a
        single-leaf tree adds its value only with `bias_included`; a
        linear tree the f32 cast of its host linear prediction on the
        set's raw values, less `bias`.  Returns the contribution."""
        device = dd.device
        if tree.is_linear and tree.num_leaves > 1:
            X = dd.get_raw()
            c = tree.linear_predict(X, tree.predict_leaf_index(X)) - bias
            contrib = to_device(c.astype(np.float32), device)
        elif tree.num_leaves <= 1:
            const = float(tree.leaf_value[0]) - bias \
                if bias_included and len(tree.leaf_value) else 0.0
            contrib = torch.full((dd.num_data,), const, dtype=torch.float32,
                                 device=device)
        else:
            vals = to_device(np.asarray(tree.leaf_value - bias, np.float32),
                             device)
            contrib = vals[tree_leaf_ids(tree, dd).long()]
        self._add_tree(score, k, -contrib if subtract else contrib)
        return contrib

    def _boost_from_average(self) -> None:
        """ref: the JAX package's `_boost_from_average` (`booster.py:1383`):
        the objective's initial score, added to every score once and
        folded into the first tree's leaves; none when the training set
        has an `init_score`."""
        if self._boost_from_average_done or self._train_obj is None \
                or self._dd.init_score is not None:
            return
        self._boost_from_average_done = True
        if not self.config.boost_from_average:
            return
        label = self.train_set.get_label().astype(np.float64)
        init = self._train_obj.boost_from_score(
            label, self.train_set.get_weight())
        inits = init if isinstance(init, list) else [init]
        K = self.num_tree_per_iteration
        if len(inits) == 1 and K > 1:
            inits = inits * K
        self._init_scores = [float(v) for v in inits]
        if any(abs(v) > 1e-35 for v in self._init_scores):
            add = np.asarray(self._init_scores, dtype=np.float32)
            if K == 1:
                self._train_score = self._train_score + float(add[0])
                self._valid_scores = [v + float(add[0])
                                      for v in self._valid_scores]
            else:
                row = torch.from_numpy(add).to(self.device)[None, :]
                self._train_score = self._train_score + row
                self._valid_scores = [v + row for v in self._valid_scores]

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration (ref: `GBDT::TrainOneIter`; the JAX
        package's `update` / `_update_impl` / `__boost`).  Returns True
        when no tree of the iteration could split.

        `fobj(preds, train_set) -> (grad, hess)` (or the booster's own
        custom objective) takes the place of the objective: the train
        scores come to the host as f64 (class-major for K > 1), and the
        f32 cast of its gradients goes back, one host round trip counted
        in `ops.grow.HOST_SYNCS`.  A random forest takes its gradients at
        the base score; DART drops trees first (`_update_dart`)."""
        if train_set is not None and train_set is not self.train_set:
            self._init_train(train_set)
        self._require_train_data()
        fobj = fobj or self._fobj
        if fobj is not None and self.hist_impl in QUANTIZED_IMPLS:
            # custom hessians may be negative, which corrupts the lattice
            raise LightGBMError(
                "update(fobj=...) cannot be combined with the packed "
                "quantized histogram; construct the Booster with "
                "objective='none' for custom objectives")
        if self._boost_mode == "dart":
            out = self._update_dart(fobj)
            self._ledger_round()
            return out
        if fobj is None:
            if self._train_obj is None:
                raise LightGBMError(
                    "Custom objective function (fobj) is required when "
                    "objective is none/custom")
            self._boost_from_average()
            score = self._train_score
            if self._boost_mode == "rf":
                score = torch.zeros_like(score)
            grad, hess = self._gradients(score)
        else:
            grad, hess = self._custom_gradients(fobj)
        out = self._boost(grad, hess)
        self._ledger_round()
        return out

    def _ledger_round(self) -> None:
        """The round's memory-ledger sweep (the reference's
        `_ledger_round`, `booster.py:1463`): the rebound training state
        attributed anew (`assign` replaces last round's handles), the
        leak sentinel fed.  Metadata only, never a device sync; nothing
        with the ledger off."""
        led = telemetry.MEMLEDGER
        if not led.enabled:
            return
        dd = self._dd
        bins = [dd._bins_fm, dd._bundle_fm, getattr(self, "_dist_bins", None),
                dd.label, dd.weight,
                dd.allowed] + [v for v in dd.feat.values()
                               if isinstance(v, torch.Tensor)] \
            + [v for v in self._feat_extra.values()
               if isinstance(v, torch.Tensor)]
        scores = [self._train_score, self._ones] \
            + list(self._valid_scores) \
            + [c[-1] for c in self._last_contribs]
        if isinstance(self._obj_state, torch.Tensor):
            scores.append(self._obj_state)
        led.assign("train.bins", bins)
        led.assign("train.scores", scores)
        led.on_round()

    def _gradients(self, score: torch.Tensor):
        """The objective's (grad, hess) at `score`: rank_xendcg with the
        iteration's key fold_in(key(objective_seed), it), the
        position-debiased lambdarank with its propensities, which the
        call replaces (the reference's `booster.py:536-560`)."""
        obj, dd = self._train_obj, self._dd
        if getattr(obj, "needs_rng", False):
            return obj.grad_hess(score, dd.label, dd.weight,
                                 key=fold_in(self._grad_key0, self.cur_iter))
        if self._obj_state is not None:
            g, h, self._obj_state = obj.grad_hess(
                score, dd.label, dd.weight, state=self._obj_state)
            return g, h
        return obj.grad_hess(score, dd.label, dd.weight)

    def _custom_gradients(self, fobj):
        """(grad, hess) f32 on the training device from `fobj` at the
        current train scores (the reference's `booster.py:1549-1560`)."""
        K = self.num_tree_per_iteration
        preds = to_host(self._train_score).astype(np.float64)
        if K > 1:
            preds = preds.reshape(-1, order="F")
        g, h = fobj(preds, self.train_set)

        def up(v):
            v = np.asarray(v, dtype=np.float32).reshape(
                (-1, K), order="F").squeeze()
            return to_device(v.reshape((-1, K)) if K > 1 else v,
                             self.device)
        return up(g), up(h)

    def _update_dart(self, fobj=None) -> bool:
        """A DART iteration (ref: dart.hpp `DART::TrainOneIter`; the
        reference's `_update_dart`, `booster.py:2227`): the dropped
        iterations drawn from RandomState((drop_seed + it) mod 2^31)
        (`skip_drop`, `drop_rate`, `max_drop`, at least one), their trees
        subtracted from every score by bin-level replay, the iteration
        trained, then `Normalize`: the new trees scaled by 1 / (k + 1)
        (xgboost mode lr / (k + lr)) and their excess taken off the
        scores, the dropped trees scaled by k / (k + 1) (k / (k + lr)) and
        added back.  The dropped iterations of each call are kept in
        `dart_dropped`."""
        cfg = self.config
        K = self.num_tree_per_iteration
        it = self.cur_iter
        if fobj is None and self._train_obj is None:
            raise LightGBMError("Custom objective function (fobj) is "
                                "required when objective is none/custom")
        self._boost_from_average()
        rng = np.random.RandomState((cfg.drop_seed + it) % (2 ** 31))
        dropped: List[int] = []
        if it > 0 and rng.rand() >= cfg.skip_drop:
            sel = np.nonzero(rng.rand(it) < cfg.drop_rate)[0]
            if cfg.max_drop > 0 and len(sel) > cfg.max_drop:
                sel = rng.choice(sel, cfg.max_drop, replace=False)
            if len(sel) == 0:
                sel = np.array([rng.randint(it)])
            dropped = sorted(int(d) for d in sel)
        self.dart_dropped = dropped
        sets = [(self._dd, self._train_score)] + list(
            zip(self._valid_dd, self._valid_scores))
        for d in dropped:
            for k in range(K):
                for dd, score in sets:
                    self._apply_tree_to_score(score, self.trees[d * K + k],
                                              dd, k, True, subtract=True)
        if fobj is not None:
            grad, hess = self._custom_gradients(fobj)
        else:
            grad, hess = self._gradients(self._train_score)
        finished = self._boost(grad, hess)
        kdrop = len(dropped)
        if kdrop > 0:
            lr = cfg.learning_rate
            if cfg.xgboost_dart_mode:
                new_scale = lr / (kdrop + lr)
                old_scale = kdrop / (kdrop + lr)
            else:
                new_scale = 1.0 / (kdrop + 1.0)
                old_scale = kdrop / (kdrop + 1.0)
            for tree in self.trees[-K:]:
                tree.leaf_value = tree.leaf_value * new_scale
                tree.internal_value = tree.internal_value * new_scale
                tree.shrinkage *= new_scale
            # the new trees entered the scores at full scale
            for kind, vi, k, contrib in self._last_contribs:
                score = self._train_score if kind == "train" \
                    else self._valid_scores[vi]
                self._add_tree(score, k, -(contrib * (1.0 - new_scale)))
            self._last_contribs = []
            for d in dropped:
                for k in range(K):
                    tree = self.trees[d * K + k]
                    tree.leaf_value = tree.leaf_value * old_scale
                    tree.internal_value = tree.internal_value * old_scale
                    tree.shrinkage *= old_scale
                    for dd, score in sets:
                        self._apply_tree_to_score(score, tree, dd, k, True)
            self._model_changed()
        return finished

    def _quantize(self, grad: torch.Tensor, hess: torch.Tensor, it: int):
        """The reference's quantization step of `__boost`
        (`booster.py:1592-1610`), over the full [N] or [N, K] gradients:
        the key `fold_in(key0, 2 it + 1)` with stochastic rounding, and on
        the lattice family the scales, which reach the grower as
        `feat["qscales"]` [2] f32.  Returns (grad, hess, qscales or None).
        """
        cfg = self.config
        key = fold_in(self._rng_key0, it * 2 + 1) \
            if cfg.stochastic_rounding else None
        if self.hist_impl in QUANTIZED_IMPLS:
            g, h, qs = quantize_gradients(
                grad, hess, cfg.num_grad_quant_bins, key, return_scales=True,
                const_hess_level=self._grower_spec.packed_const_hess_level)
            return g, h, torch.stack(qs)
        g, h = quantize_gradients(grad, hess, cfg.num_grad_quant_bins, key)
        return g, h, None

    def _sample_weights(self, it: int) -> torch.Tensor:
        """[N] f32 bagging weights of iteration `it`, the reference's
        `_sample_weights` (`booster.py:1409`): per-class bagging (binary
        labels) on the host with numpy's RandomState((bagging_seed +
        it // freq) % 2^31), else `bagging_weights` from key0 on the
        training device, else ones."""
        cfg = self.config
        n = self._dd.num_data
        if (cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0) \
                and cfg.bagging_freq > 0:
            bag_it = it // cfg.bagging_freq
            rng = np.random.RandomState((cfg.bagging_seed + bag_it)
                                        % (2 ** 31))
            pos = self.train_set.get_label() > 0
            mask = np.zeros(n, dtype=np.float32)
            mask[pos] = rng.rand(int(pos.sum())) < cfg.pos_bagging_fraction
            mask[~pos] = rng.rand(int((~pos).sum())) \
                < cfg.neg_bagging_fraction
            return torch.from_numpy(mask).to(self.device)
        if cfg.bagging_freq <= 0 or cfg.bagging_fraction >= 1.0:
            return self._ones
        return bagging_weights(it, self._rng_key0, n, self.device,
                               bagging_fraction=cfg.bagging_fraction,
                               bagging_freq=cfg.bagging_freq)

    def _goss_weights(self, it: int, grad: torch.Tensor,
                      hess: torch.Tensor) -> torch.Tensor:
        """[N] f32 GOSS weights of iteration `it` from the exact
        gradients, the reference's `_goss_weights` (`booster.py:1563`):
        ones for the first int(1 / learning_rate) iterations or when
        top_rate + other_rate >= 1."""
        cfg = self.config
        start = int(1.0 / cfg.learning_rate)
        if it < start or cfg.top_rate + cfg.other_rate >= 1.0:
            return self._ones
        return goss_weights(it, self._rng_key0, grad, hess,
                            top_rate=cfg.top_rate,
                            other_rate=cfg.other_rate, goss_start_iter=start)

    def _boost(self, grad: torch.Tensor, hess: torch.Tensor) -> bool:
        """ref: the JAX package's `__boost` (`booster.py:1581`).  Each
        tree's train and valid contributions are kept for
        `rollback_one_iter` until the next iteration."""
        cfg = self.config
        # random-forest trees are unshrunk (ref: rf.hpp)
        lr = 1.0 if self._boost_mode == "rf" else cfg.learning_rate
        K = self.num_tree_per_iteration
        it = self.cur_iter
        dd = self._dd
        feat = {**dd.feat, **self._feat_extra}
        # GOSS ranks the exact gradients: the weights come before the
        # quantization, as in the reference
        sw = self._goss_weights(it, grad, hess) if self._use_goss \
            else self._sample_weights(it)
        if cfg.use_quantized_grad and cfg.num_grad_quant_bins > 0:
            grad, hess, qscales = self._quantize(grad, hess, it)
            if qscales is not None:
                feat = {**feat, "qscales": qscales}
        node_sampling = cfg.feature_fraction_bynode < 1.0 or cfg.extra_trees
        all_const = True
        self._last_contribs = []
        for k in range(K):
            gk = grad if K == 1 else grad[:, k].contiguous()
            hk = hess if K == 1 else hess[:, k].contiguous()
            allowed = feature_mask(it, k, self._ff_key0, dd.allowed,
                                   feature_fraction=cfg.feature_fraction)
            feat_k = feat
            if node_sampling:
                # each tree's per-node stream (the reference's
                # `booster.py:1621-1626`)
                feat_k = {**feat, "ff_key": fold_in(
                    fold_in(self._ff_key0, 2 ** 20 + it), k)}
            if "cegb_used" in self._feat_extra:
                feat_k = {**feat_k,
                          "cegb_used": self._feat_extra["cegb_used"]}
            dev = self._grower(self._train_bins(), gk, hk, sw, feat_k,
                               allowed)
            tree = Tree.from_device(dev, self.train_set.bin_mappers, lr)
            if "cegb_used" in self._feat_extra and tree.num_leaves > 1:
                # coupled penalties charge a feature once per model
                feats = np.unique(tree.split_feature[:tree.num_internal()])
                if not self._cegb_used[feats].all():
                    self._cegb_used[feats] = True
                    self._feat_extra["cegb_used"] = to_device(
                        self._cegb_used, self.device)
            if tree.num_leaves > 1:
                all_const = False
            # the train score reads the grower's final leaf_id; the
            # scores are updated in place (the reference's are immutable)
            linear = cfg.linear_tree and tree.num_leaves > 1
            if linear:
                contrib = to_device(self._fit_linear_tree(
                    tree, dev, gk, hk, sw, lr).astype(np.float32),
                    self.device)
            else:
                renew = getattr(self._train_obj, "renew_percentile", None)
                if renew is not None and tree.num_leaves > 1:
                    scaled = self._renew_tree_output(tree, dev, sw,
                                                     float(renew), lr)
                else:
                    scaled = dev.values * lr
                contrib = scaled[dev.leaf_id.long()]
            self._add_tree(self._train_score, k, contrib)
            self._last_contribs.append(("train", 0, k, contrib))
            for vi, (vdd, vscore) in enumerate(zip(self._valid_dd,
                                                   self._valid_scores)):
                if linear:
                    contrib = self._apply_tree_to_score(vscore, tree, vdd, k,
                                                        False)
                else:
                    contrib = scaled[replay_leaf_ids(dev, vdd).long()]
                    self._add_tree(vscore, k, contrib)
                self._last_contribs.append(("valid", vi, k, contrib))
            if it == 0 and abs(self._init_scores[k]) > 1e-35:
                tree.add_bias(self._init_scores[k])
            self.trees.append(tree)
        self._model_changed()
        self.cur_iter += 1
        if all_const:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
        return all_const

    def _renew_tree_output(self, tree: Tree, dev: DeviceTree, sw,
                           alpha: float, lr: float) -> torch.Tensor:
        """The L1 family's leaf refit (ref: regression_objective.hpp
        `RenewTreeOutput`; the reference's `_renew_tree_output`,
        `booster.py:1698`): each leaf's value becomes the alpha-percentile
        of its in-bag rows' residuals `label - score` before this tree,
        weighted by the row weights times the sample weights when the set
        has weights (and always for MAPE, whose weights are 1 / max(1,
        |label|)), on the training device (`ops/renew.py`); leaves with
        no in-bag row keep the grower's value.  Returns the shrunken
        [L] values and rewrites the host tree's leaves."""
        dd = self._dd
        weighted = dd.weight is not None or self._train_obj.name == "mape"
        base_w = dd.weight if dd.weight is not None else self._ones
        if self._train_obj.name == "mape":
            base_w = base_w / torch.clamp(torch.abs(dd.label), min=1.0)
        vals = renew_leaf_values(dev.values, dd.label - self._train_score,
                                 base_w, sw, dev.leaf_id,
                                 self.config.num_leaves, alpha, weighted)
        scaled = vals * lr
        tree.leaf_value = to_host(scaled).astype(np.float64)[
            :tree.num_leaves]
        return scaled

    def _fit_linear_tree(self, tree: Tree, dev: DeviceTree, gk, hk, sw,
                         lr: float) -> np.ndarray:
        """Ridge-fit each leaf's linear model on the raw values of its
        path's numerical features, hessian-weighted, and return each
        train row's f64 contribution (the reference's `_fit_linear_tree`,
        `booster.py:1725`; ref: linear_tree_learner.cpp
        `LinearTreeLearner::CalculateLinear`): per leaf the normal
        equations of [1, x] with `linear_lambda` on the coefficients, in
        f64 numpy on the host; rows with a NaN in the leaf's features, or
        of weight 0, stay out of the fit and keep the leaf's constant.
        The leaf id, gradients and weights come to the host in one copy,
        counted in `ops.grow.HOST_SYNCS`; the fit's host seconds add to
        `LINEAR_FIT_S`."""
        global LINEAR_FIT_S
        t0 = time.perf_counter()
        X = self._dd.get_raw()
        n = len(X)
        host = to_host(torch.cat([dev.leaf_id.to(torch.float32), gk, hk,
                                  sw]))
        leaf_id = host[:n].astype(np.int64)
        g, h, w = (host[i * n:(i + 1) * n].astype(np.float64)
                   for i in (1, 2, 3))
        lam = self.config.linear_lambda
        paths = tree.leaf_path_features()
        tree.is_linear = True
        tree.leaf_const = np.array(tree.leaf_value, np.float64)
        for leaf in range(tree.num_leaves):
            feats = paths[leaf]
            tree.leaf_features[leaf] = []
            tree.leaf_coeff[leaf] = []
            if not feats:
                continue
            rows = np.nonzero(leaf_id == leaf)[0]
            if not len(rows):
                continue
            Xl = X[np.ix_(rows, feats)]
            fit = rows[~np.isnan(Xl).any(axis=1) & (w[rows] > 0)]
            if len(fit) <= len(feats) + 1:
                continue
            A = np.concatenate([np.ones((len(fit), 1)),
                                X[np.ix_(fit, feats)]], axis=1)
            hh = (h[fit] * w[fit])[:, None]
            rhs = -(A.T @ (g[fit] * w[fit]))
            M = A.T @ (A * hh)
            diag = np.arange(1, len(feats) + 1)
            M[diag, diag] += lam
            try:
                beta = np.linalg.solve(M, rhs)
            except np.linalg.LinAlgError:
                continue
            if not np.all(np.isfinite(beta)):
                continue
            tree.leaf_const[leaf] = beta[0] * lr
            tree.leaf_features[leaf] = list(feats)
            tree.leaf_coeff[leaf] = [float(b) for b in beta[1:] * lr]
        out = tree.linear_predict(X, leaf_id)
        LINEAR_FIT_S += time.perf_counter() - t0
        return out

    @staticmethod
    def _add_tree(score: torch.Tensor, k: int,
                  contrib: torch.Tensor) -> None:
        if score.dim() == 1:
            score += contrib
        else:
            score[:, k] += contrib

    def update_many(self, n_rounds: int) -> bool:
        """`n_rounds` iterations of `update`; returns the last one's
        finished flag."""
        finished = False
        for _ in range(n_rounds):
            finished = self.update()
        return finished

    #: rounds a chunk of `dispatch_chunk_eval` runs (the reference's
    #: `_BULK_CHUNK`)
    _BULK_CHUNK = 16

    def dispatch_chunk_eval(self, want_train_scores: bool) -> _PendingChunk:
        """One chunk of `_BULK_CHUNK` iterations with a snapshot of the
        scores after each (the reference's `booster.py:2160`, which
        enqueues a fused device program and returns at once).  The port
        has no device program a chunk could overlap (ROADMAP item 6), so
        the chunk's `update` calls run here, in order; the snapshots stay
        on the training device until `harvest_chunk_eval`.  As after the
        reference's chunk, `rollback_one_iter` then replays rather than
        subtracting cached contributions."""
        self._require_train_data()
        self._boost_from_average()
        finished = True
        train, valid = [], [[] for _ in self._valid_scores]
        for _ in range(self._BULK_CHUNK):
            finished = self.update() and finished
            if want_train_scores:
                train.append(self._train_score.clone())
            for snaps, score in zip(valid, self._valid_scores):
                snaps.append(score.clone())
        self._last_contribs = []
        pending = _PendingChunk(
            finished, torch.stack(train) if want_train_scores else None,
            tuple(torch.stack(v) for v in valid))
        self._inflight.append(pending)
        return pending

    def harvest_chunk_eval(self, pending: _PendingChunk):
        """A dispatched chunk's results, in dispatch order (out of order
        raises, as in the reference): (finished, train scores [C, ...] or
        None, [valid scores [C, ...]]) as host numpy, one copy a set."""
        if not self._inflight or self._inflight[0] is not pending:
            raise LightGBMError("pipeline harvest out of dispatch order")
        self._inflight.popleft()
        train = None if pending.train is None \
            else pending.train.cpu().numpy()
        return (pending.finished, train,
                [v.cpu().numpy() for v in pending.valid])

    def update_chunk_eval(self, want_train_scores: bool):
        """One chunk dispatched and harvested: (finished, train scores
        [C, ...] or None, [valid scores [C, ...]])."""
        return self.harvest_chunk_eval(
            self.dispatch_chunk_eval(want_train_scores))

    def current_iteration(self) -> int:
        return self.cur_iter

    def rollback_one_iter(self) -> "Booster":
        """Undo the last iteration (ref: `GBDT::RollbackOneIter`; the JAX
        package's `booster.py:1803`): the cached contributions of the
        last update are subtracted, so the scores are `(s + c) - c`;
        deeper, each tree's contribution is replayed on the bins and
        subtracted (iteration 0's less its folded-in bias)."""
        if self.cur_iter <= 0:
            return self
        self._require_train_data()
        K = self.num_tree_per_iteration
        if self._last_contribs:
            for kind, vi, k, contrib in self._last_contribs:
                score = self._train_score if kind == "train" \
                    else self._valid_scores[vi]
                self._add_tree(score, k, -contrib)
            self._last_contribs = []
        else:
            rolling_first = self.cur_iter == 1
            for k in range(K):
                tree = self.trees[-K + k]
                bias = self._init_scores[k] if rolling_first else 0.0
                for dd, score in [(self._dd, self._train_score)] + list(
                        zip(self._valid_dd, self._valid_scores)):
                    self._apply_tree_to_score(score, tree, dd, k, True,
                                              subtract=True, bias=bias)
        del self.trees[-K:]
        self.cur_iter -= 1
        self._model_changed()
        return self

    # ------------------------------------------------------ evaluation
    def _require_train_data(self) -> None:
        if self.train_set is None or getattr(self, "_dd", None) is None:
            raise LightGBMError("No training data attached: the booster was "
                                "loaded from model text or its data freed "
                                "by free_dataset(); prediction and model IO "
                                "remain available")
        if self._scores_stale:
            self._rebuild_train_scores()

    def _rebuild_train_scores(self) -> None:
        """Every score replayed from the current trees (after
        `set_leaf_output`; the reference's `booster.py:3322`)."""
        self._train_score = self._replay_model(self._dd)
        self._valid_scores = [self._replay_model(dd) for dd in self._valid_dd]
        self._scores_stale = False

    def _eval_score(self, score: torch.Tensor) -> np.ndarray:
        """A set's scores on the host as f64: the one blocking copy of
        an evaluation, counted in `EVAL_COPIES`."""
        global EVAL_COPIES
        EVAL_COPIES += 1
        s = score.detach().cpu().numpy().astype(np.float64)
        if self._average_output and self.cur_iter > 0:
            s = s / self.cur_iter
        return s

    def _eval_one(self, s: np.ndarray, ds: Dataset, name: str, feval
                  ) -> List[Tuple[str, str, float, bool]]:
        """ref: the JAX package's `_eval_one_impl` (`booster.py:2364`):
        the metrics, then each `feval(preds, ds)` on the f32 scores
        through the objective's link (on the host, the plain version's
        bits), flattened class-major; a feval returns one
        (name, value, higher_better) tuple or a list of them."""
        label = ds.get_label()
        weight = ds.get_weight()
        label64 = label.astype(np.float64) if label is not None else None
        w64 = weight.astype(np.float64) if weight is not None else None
        out = [(name, mname, val, m.higher_better)
               for m in self.metrics_
               for mname, val in m.eval(s, label64, w64,
                                        ds._query_boundaries)]
        if feval is None:
            return out
        preds = s
        if self.objective_ is not None and getattr(
                self._train_obj, "need_convert", False):
            preds = self.objective_.convert_output(
                torch.from_numpy(s.astype(np.float32))).numpy()
        for fe in (feval if isinstance(feval, (list, tuple)) else [feval]):
            res = fe(preds.reshape(-1, order="F") if preds.ndim > 1
                     else preds, ds)
            for item in (res if isinstance(res, list)
                         else [] if res is None else [res]):
                fname, val, hib = item
                out.append((name, fname, val, hib))
        return out

    def eval_with_scores(self, score_np: np.ndarray, data: Dataset,
                         name: str, feval, it_count: int):
        """Metrics and `feval` on a host score snapshot (the reference's
        `booster.py:2185`)."""
        s = np.asarray(score_np, dtype=np.float64)
        if self._average_output and it_count > 0:
            s = s / it_count
        return self._eval_one(s, data, name, feval)

    def eval_train(self, feval=None) -> List[Tuple[str, str, float, bool]]:
        self._require_train_data()
        return self._eval_one(self._eval_score(self._train_score),
                              self.train_set,
                              getattr(self, "_train_data_name", "training"),
                              feval)

    def eval_valid(self, feval=None) -> List[Tuple[str, str, float, bool]]:
        self._require_train_data()
        out = []
        for name, ds, score in zip(self.name_valid_sets, self.valid_sets,
                                   self._valid_scores):
            out.extend(self._eval_one(self._eval_score(score), ds, name,
                                      feval))
        return out

    def eval(self, data: Dataset, name: str, feval=None):
        """ref: basic.py `Booster.eval`: the training set or a set given
        to `add_valid`."""
        if data is self.train_set:
            return self.eval_train(feval)
        self._require_train_data()
        for i, vs in enumerate(self.valid_sets):
            if data is vs:
                return self._eval_one(self._eval_score(self._valid_scores[i]),
                                      data, name, feval)
        raise LightGBMError("Data for eval must be training or validation "
                            "data (use add_valid first)")

    # ------------------------------------------------ changing the model
    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """New parameters for the next iterations (ref: basic.py
        `Booster.reset_parameter`; the JAX package's `booster.py:3344`):
        the config is updated and the grower rebuilt from it, spec and
        all (`_build_grower`: leaves, depth, regularisers, histogram
        path, the wave's width, strict tail, buffers and K2's slot
        count, the quantized constant-hessian level), as a fresh booster
        with these parameters would build it.  `learning_rate` takes
        effect at the next update."""
        self.params.update(params)
        if getattr(self, "_dd", None) is None:
            return self
        self.config.update(params)
        _refuse(self.config)
        self._build_grower()
        return self

    def refit(self, data, label, decay_rate: float = 0.9,
              **kwargs) -> "Booster":
        """A new booster with every tree's structure kept and its leaf
        values refitted on `data` (ref: basic.py `Booster.refit`;
        gbdt.cpp `GBDT::RefitTree`; the JAX package's `booster.py:1851`):
        in boosting order, each row's leaf by the host walk
        (`Tree.predict_leaf_index`), the gradients at the running f32
        score from the port's objective on the training device (the
        booster's, or `device_type=`; on the card through the link
        kernel), the leaf sums in f64 (`bincount`), the closed-form
        output times the learning rate blended as `decay_rate * old +
        (1 - decay_rate) * new`; leaves no row reaches keep their value.
        `weight=` weights the rows; `group=` gives the query sizes a
        ranking objective needs (rank_xendcg draws with fold_in(key,
        it))."""
        if self.objective_ is None:
            raise LightGBMError("Cannot refit due to null objective function")
        cfg = self.config
        device = train_device(kwargs.get("device_type") or cfg.device_type)
        new_bst = Booster(model_str=self.model_to_string(num_iteration=-1),
                          params={**{k: v for k, v in self.params.items()
                                     if not callable(v)}, "verbosity": -1})
        X = _to_2d_float(data)
        y = np.asarray(label, dtype=np.float64).reshape(-1)
        n = X.shape[0]
        if len(y) != n:
            raise LightGBMError("Length of label is not same with #data")
        weight = kwargs.get("weight")
        group = kwargs.get("group")
        qb = None if group is None else np.concatenate(
            [[0], np.cumsum(np.asarray(group, np.int64))])
        obj = create_objective(new_bst.config)
        obj.eager = True        # the reference refits outside `jax.jit`
        obj.init_meta(y, np.asarray(weight, np.float64)
                      if weight is not None else None, qb)
        key0 = prng_key(cfg.objective_seed % (2 ** 31))
        K = self.num_tree_per_iteration
        lr = 1.0 if self._average_output else cfg.learning_rate

        def host_leaf_output(g, h):
            # ops/split.py leaf_output in f64
            t = np.sign(g) * np.maximum(np.abs(g) - cfg.lambda_l1, 0.0)
            denom = h + cfg.lambda_l2
            out = np.where(denom > 0, -t / np.where(denom > 0, denom, 1.0),
                           0.0)
            if cfg.max_delta_step > 0:
                out = np.clip(out, -cfg.max_delta_step, cfg.max_delta_step)
            return out

        label_d = to_device(y.astype(np.float32), device)
        w_d = to_device(np.asarray(weight, np.float32), device) \
            if weight is not None else None
        score = np.zeros(n if K == 1 else (n, K), np.float32)
        for it in range(len(new_bst.trees) // K):
            # an averaged (RF) model's gradients are taken at the constant
            # base score (ref: rf.hpp `RF::Boosting`)
            at = np.zeros_like(score) if self._average_output else score
            if getattr(obj, "needs_rng", False):
                g, h = obj.grad_hess(to_device(at, device), label_d, w_d,
                                     key=fold_in(key0, it))
            else:
                g, h = obj.grad_hess(to_device(at, device), label_d, w_d)
            g = g.cpu().numpy().astype(np.float64)
            h = h.cpu().numpy().astype(np.float64)
            for k in range(K):
                t = new_bst.trees[it * K + k]
                gk = g if K == 1 else g[:, k]
                hk = h if K == 1 else h[:, k]
                li = t.predict_leaf_index(X)
                nl = t.num_leaves
                sg = np.bincount(li, weights=gk, minlength=nl)
                sh = np.bincount(li, weights=hk, minlength=nl)
                cnt = np.bincount(li, minlength=nl)
                new_out = host_leaf_output(sg, sh) * lr
                old = np.asarray(t.leaf_value, np.float64)
                mixed = np.where(cnt > 0, decay_rate * old
                                 + (1.0 - decay_rate) * new_out, old)
                t.leaf_value = mixed
                contrib = mixed[li].astype(np.float32)
                if K == 1:
                    score = score + contrib
                else:
                    score[:, k] += contrib
        new_bst._model_changed()
        return new_bst

    def set_leaf_output(self, tree_id: int, leaf_id: int,
                        value: float) -> "Booster":
        """Overwrite one leaf's output (ref: basic.py
        `Booster.set_leaf_output`); the scores are replayed from the
        trees before the next update or evaluation."""
        self.trees[tree_id].leaf_value[leaf_id] = float(value)
        self._scores_stale = True
        self._last_contribs = []
        self._model_changed()
        return self

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        return float(self.trees[tree_id].leaf_value[leaf_id])

    def shuffle_models(self, start_iteration: int = 0,
                       end_iteration: int = -1) -> "Booster":
        """Permute whole iterations of trees in [start_iteration,
        end_iteration) with numpy's global generator (ref: basic.py
        `Booster.shuffle_models`); the full sum is unchanged."""
        K = self.num_tree_per_iteration
        n_iter = len(self.trees) // K
        end = n_iter if end_iteration < 0 else min(end_iteration, n_iter)
        start = max(0, start_iteration)
        if end - start > 1:
            idx = np.arange(start, end)
            np.random.shuffle(idx)
            blocks = [self.trees[i * K:(i + 1) * K] for i in range(n_iter)]
            reordered = blocks[:start] + [blocks[i] for i in idx] + \
                blocks[end:]
            self.trees = [t for b in reordered for t in b]
            self._last_contribs = []
            self._model_changed()
        return self

    # ------------------------------------------------------ model text
    def model_from_string(self, model_str: str) -> "Booster":
        """ref: gbdt_model_text.cpp `GBDT::LoadModelFromString`."""
        lines = model_str.split("\n")
        header: Dict[str, str] = {}
        i = 0
        while i < len(lines):
            ln = lines[i].strip()
            if ln.startswith("Tree="):
                break
            if "=" in ln:
                k, v = ln.split("=", 1)
                header[k] = v
            i += 1
        self.num_tree_per_iteration = int(
            header.get("num_tree_per_iteration", 1))
        self._average_output = "average_output" in lines[:i]
        self._loaded_feature_names = header.get("feature_names", "").split()
        self._loaded_feature_infos = header.get("feature_infos", "").split()
        # the parameters section round-trips (ref: SaveModelToString
        # writes the config block), which keeps save -> load -> save
        # byte-stable
        in_params = False
        for ln in lines:
            ln = ln.strip()
            if ln == "parameters:":
                in_params = True
                continue
            if ln == "end of parameters":
                break
            if in_params and ln.startswith("[") and ":" in ln:
                k, v = ln[1:-1].split(":", 1)
                self.params.setdefault(k.strip(), v.strip())
        obj_line = header.get("objective", "regression")
        self.objective_ = parse_objective(obj_line, self.params)
        # the training view of the model's parameters (what `refit` and
        # continued training read), as the reference builds it
        params = dict(self.params)
        toks = obj_line.split()
        params["objective"] = toks[0] if toks else "regression"
        params.update(tok.split(":", 1) for tok in toks[1:] if ":" in tok)
        params.setdefault("verbosity", -1)
        self.config = Config(params)
        self._model_changed()
        text = "\n".join(lines[i:])
        self.trees = []
        for section in text.split("Tree=")[1:]:
            section = section.split("\nend of trees")[0]
            self.trees.append(Tree.from_string("Tree=" + section))
        self.cur_iter = len(self.trees) // max(self.num_tree_per_iteration, 1)
        for ln in reversed(lines):
            if ln.startswith("pandas_categorical:"):
                try:
                    self.pandas_categorical = json.loads(
                        ln[len("pandas_categorical:"):])
                except json.JSONDecodeError:
                    pass
                break
        return self

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        """ref: gbdt_model_text.cpp `GBDT::SaveModelToString`; the same
        text the JAX package writes for a loaded model."""
        trees = self._slice_trees(start_iteration, num_iteration)
        fnames = self._loaded_feature_names
        buf = io.StringIO()
        buf.write("tree\n")
        buf.write("version=v4\n")
        buf.write(f"num_class={max(self.num_tree_per_iteration, 1)}\n")
        buf.write(f"num_tree_per_iteration={self.num_tree_per_iteration}\n")
        buf.write("label_index=0\n")
        buf.write(f"max_feature_idx={len(fnames) - 1}\n")
        obj = self.objective_.to_string() if self.objective_ else "custom"
        buf.write(f"objective={obj}\n")
        if self._average_output:
            buf.write("average_output\n")
        buf.write("feature_names=" + " ".join(fnames) + "\n")
        infos = self._loaded_feature_infos or ["none"] * len(fnames)
        buf.write("feature_infos=" + " ".join(infos) + "\n")
        tree_strs = [t.to_string(i) for i, t in enumerate(trees)]
        buf.write("tree_sizes=" + " ".join(str(len(s) + 1)
                                           for s in tree_strs) + "\n")
        buf.write("\n")
        for s in tree_strs:
            buf.write(s + "\n")
        buf.write("end of trees\n\n")
        imp = self.feature_importance(importance_type)
        pairs = sorted([(v, n) for n, v in zip(fnames, imp) if v > 0],
                       reverse=True)
        buf.write("feature_importances:\n")
        for v, n in pairs:
            buf.write(f"{n}={v:g}\n")
        buf.write("\nparameters:\n")
        for k, v in self.params.items():
            if callable(v):
                continue
            if isinstance(v, (list, tuple)):
                v = ",".join(str(x) for x in v)
            buf.write(f"[{k}: {v}]\n")
        buf.write("end of parameters\n")
        buf.write("\npandas_categorical:" +
                  json.dumps(self.pandas_categorical) + "\n")
        return buf.getvalue()

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration, start_iteration,
                                         importance_type))
        return self

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> Dict:
        """The model as a JSON-ready dict (ref: `GBDT::DumpModel`; the
        JAX package's `booster.py:2982`, its fields and their order)."""
        trees = self._slice_trees(start_iteration, num_iteration)
        fnames = self.feature_name()

        def node_to_dict(t: Tree, node: int) -> Dict:
            if node < 0:
                leaf = ~node
                return {"leaf_index": int(leaf),
                        "leaf_value": float(t.leaf_value[leaf]),
                        "leaf_weight": float(t.leaf_weight[leaf]),
                        "leaf_count": int(t.leaf_count[leaf])}
            return {
                "split_index": int(node),
                "split_feature": int(t.split_feature[node]),
                "split_gain": float(t.split_gain[node]),
                "threshold": float(t.threshold[node]),
                "decision_type": "<=",
                "default_left": bool(t.decision_type[node] & 2),
                "missing_type": ["None", "Zero", "NaN"][
                    (t.decision_type[node] >> 2) & 3],
                "internal_value": float(t.internal_value[node]),
                "internal_weight": float(t.internal_weight[node]),
                "internal_count": int(t.internal_count[node]),
                "left_child": node_to_dict(t, t.left_child[node]),
                "right_child": node_to_dict(t, t.right_child[node]),
            }

        return {
            "name": "tree", "version": "v4",
            "num_class": max(self.num_tree_per_iteration, 1),
            "num_tree_per_iteration": self.num_tree_per_iteration,
            "label_index": 0, "max_feature_idx": len(fnames) - 1,
            "objective": self.objective_.to_string()
            if self.objective_ else "custom",
            "feature_names": fnames,
            "tree_info": [{
                "tree_index": i, "num_leaves": t.num_leaves,
                "num_cat": t.num_cat, "shrinkage": t.shrinkage,
                "tree_structure": node_to_dict(
                    t, 0 if t.num_leaves > 1 else ~0),
            } for i, t in enumerate(trees)],
            "pandas_categorical": self.pandas_categorical,
        }

    def model_fingerprint(self) -> str:
        """The model's identity: the first 16 hex digits of the sha256 of
        its model text less the `[param: value]` lines (the JAX
        package's `booster.py:2665`), so a model hashes the same trained
        or loaded."""
        body = "\n".join(ln for ln in self.model_to_string().splitlines()
                         if not ln.startswith("["))
        return hashlib.sha256(body.encode()).hexdigest()[:16]

    # -------------------------------------------------------- queries
    def num_feature(self) -> int:
        return len(self._loaded_feature_names)

    def num_model_per_iteration(self) -> int:
        return self.num_tree_per_iteration

    def feature_name(self) -> List[str]:
        return list(self._loaded_feature_names)

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = str(name)
        return self

    def free_dataset(self) -> "Booster":
        """Drop the training and validation data and their device
        copies (ref: basic.py `Booster.free_dataset`): prediction and
        model IO keep working, training and evaluation raise."""
        self.train_set = None
        self._dd = None
        self._train_score = None
        self._ones = None
        self._valid_dd = []
        self._valid_scores = []
        self.valid_sets = []
        self.name_valid_sets = []
        self._last_contribs = []
        self._dist_bins = None
        self._dist_grower = None
        return self

    def free_network(self) -> "Booster":
        """No-op (ref: basic.py `Booster.free_network`, the socket mesh's
        teardown): the process group belongs to the caller, who leaves it
        with `lightgbm_tpu_torch.mesh.shutdown()`."""
        return self

    def set_network(self, *args, **kwargs) -> "Booster":
        """Accepted for API parity, with a warning (ref: basic.py
        `Booster.set_network`): the ranks join a process group with
        `lightgbm_tpu_torch.mesh.init()` before `train`."""
        log.warning("set_network is inert in the PyTorch port — call "
                    "lightgbm_tpu_torch.mesh.init() on every rank, then "
                    "train with tree_learner=data, feature or voting")
        return self

    def set_attr(self, **kwargs) -> "Booster":
        """String attributes kept with the booster in memory (ref:
        basic.py `Booster.set_attr`); None deletes one."""
        for k, v in kwargs.items():
            if v is None:
                self._attr.pop(k, None)
            else:
                self._attr[k] = str(v)
        return self

    def get_attr(self, name: str) -> Optional[str]:
        return self._attr.get(name)

    def lower_bound(self) -> float:
        """The least raw score: each tree's smallest leaf, summed (ref:
        `GBDT::GetLowerBoundValue`)."""
        return float(sum(float(np.min(t.leaf_value[:t.num_leaves]))
                         for t in self.trees)) if self.trees else 0.0

    def upper_bound(self) -> float:
        """ref: `GBDT::GetUpperBoundValue`."""
        return float(sum(float(np.max(t.leaf_value[:t.num_leaves]))
                         for t in self.trees)) if self.trees else 0.0

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style: bool = False):
        """Histogram of the model's numerical thresholds on one feature
        (ref: basic.py `Booster.get_split_value_histogram`): (counts,
        edges) as `np.histogram`, one bin per distinct value by default;
        with `xgboost_style` the [SplitValue, Count] rows of the bins in
        use, a pandas DataFrame where pandas is installed."""
        fnames = self.feature_name()
        fidx = fnames.index(feature) if isinstance(feature, str) \
            else int(feature)
        values = [t.threshold[i] for t in self.trees
                  for i in range(t.num_internal())
                  if t.split_feature[i] == fidx
                  and not (t.decision_type[i] & K_CATEGORICAL_MASK)]
        n_unique = len(np.unique(values)) if values else 0
        if bins is None or (not isinstance(bins, str)
                            and np.isscalar(bins) and bins > n_unique):
            bins = max(n_unique, 1)
        hist, edges = np.histogram(values, bins=bins)
        if not xgboost_style:
            return hist, edges
        rows = np.column_stack([edges[1:], hist]).astype(np.float64)
        rows = rows[rows[:, 1] > 0]
        try:
            import pandas as pd
        except ImportError:
            return rows
        return pd.DataFrame(rows, columns=["SplitValue", "Count"])

    def trees_to_dataframe(self):
        """The model's nodes and leaves as one pandas DataFrame (ref:
        basic.py `Booster.trees_to_dataframe`, the JAX package's columns
        and rows).  Needs pandas, imported here."""
        import pandas as pd
        fnames = self.feature_name()
        rows = []
        for ti, t in enumerate(self.trees):
            ni = t.num_internal()
            parent = {}
            depth = {("S", 0): 1} if ni else {("L", 0): 1}
            for i in range(ni):
                for child in (t.left_child[i], t.right_child[i]):
                    key = ("L", ~child) if child < 0 else ("S", child)
                    parent[key] = i
                    depth[key] = depth.get(("S", i), 1) + 1

            def node_index(key, ti=ti):
                return f"{ti}-{key[0]}{key[1]}"

            def child_index(c):
                return node_index(("L", ~c) if c < 0 else ("S", c))

            for i in range(ni):
                dt = int(t.decision_type[i])
                f = int(t.split_feature[i])
                rows.append({
                    "tree_index": ti,
                    "node_depth": depth.get(("S", i), 1),
                    "node_index": node_index(("S", i)),
                    "left_child": child_index(int(t.left_child[i])),
                    "right_child": child_index(int(t.right_child[i])),
                    "parent_index": node_index(("S", parent[("S", i)]))
                    if ("S", i) in parent else None,
                    "split_feature": fnames[f] if f < len(fnames)
                    else str(f),
                    "split_gain": float(t.split_gain[i]),
                    "threshold": float(t.threshold[i]),
                    "decision_type": "==" if dt & 1 else "<=",
                    "missing_direction": "left" if dt & 2 else "right",
                    "missing_type": {0: "None", 1: "Zero", 2: "NaN"}[
                        (dt >> 2) & 3],
                    "value": float(t.internal_value[i]),
                    "weight": float(t.internal_weight[i]),
                    "count": int(t.internal_count[i]),
                })
            for li in range(t.num_leaves):
                key = ("L", li)
                rows.append({
                    "tree_index": ti,
                    "node_depth": depth.get(key, 1),
                    "node_index": node_index(key),
                    "left_child": None, "right_child": None,
                    "parent_index": node_index(("S", parent[key]))
                    if key in parent else None,
                    "split_feature": None, "split_gain": None,
                    "threshold": None, "decision_type": None,
                    "missing_direction": None, "missing_type": None,
                    "value": float(t.leaf_value[li]),
                    "weight": float(t.leaf_weight[li]),
                    "count": int(t.leaf_count[li]),
                })
        return pd.DataFrame(rows)

    # ------------------------------------------------------- pickling
    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, _):
        return Booster(model_str=self.model_to_string(num_iteration=-1))

    def __getstate__(self):
        return {"model_str": self.model_to_string(num_iteration=-1),
                "params": self.params, "best_iteration": self.best_iteration}

    def __setstate__(self, state):
        self.__init__(params=state.get("params"),
                      model_str=state["model_str"])
        self.best_iteration = state.get("best_iteration", -1)

    def num_trees(self) -> int:
        return len(self.trees)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """ref: gbdt.cpp `GBDT::FeatureImportance`."""
        out = np.zeros(self.num_feature(), dtype=np.float64)
        for t in self._slice_trees(0, iteration):
            if importance_type == "split":
                t.feature_importance_split(out)
            elif importance_type == "gain":
                t.feature_importance_gain(out)
            else:
                raise LightGBMError(
                    f"Unknown importance type: {importance_type}")
        return out.astype(np.int32) if importance_type == "split" else out

    def _slice_trees(self, start_iteration: int,
                     num_iteration: Optional[int]) -> List[Tree]:
        K = self.num_tree_per_iteration
        if num_iteration is None:
            num_iteration = self.best_iteration \
                if self.best_iteration > 0 else -1
        if num_iteration <= 0:
            end = len(self.trees)
        else:
            end = min((start_iteration + num_iteration) * K, len(self.trees))
        return self.trees[start_iteration * K: end]

    # ------------------------------------------------------ prediction
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, data_has_header: bool = False,
                validate_features: bool = False, **kwargs) -> np.ndarray:
        """ref: basic.py `Booster.predict` -> gbdt_prediction.cpp; the JAX
        package's `booster.py:2449`.

        - `pred_leaf`: [N, T] int32 leaf indices, each tree's host f64
          walk (`Tree.predict_leaf_index`).
        - `pred_contrib`: TreeSHAP on the host (`contrib.py`), [N, (F + 1)
          * K] with each class's bias last in its block.
        - Prediction early stop (`pred_early_stop`, `_freq`, `_margin`;
          binary, or K > 1): the host walk, every `freq` iterations a row
          whose margin reaches `margin` stops (ref:
          prediction_early_stop.cpp).  It takes precedence over
          `device_predict`, as in the reference.
        - `device_predict`: the JAX package's f32 batch program on the
          card (`_predict_device`), or on the CPU with
          `device_type="cpu"`.
        - Otherwise the host walk: f64, summed tree by tree in boosting
          order (ref: `GBDT::PredictRaw`), through the host library's
          `predict_rows` over the flattened trees (`num_threads` OpenMP
          threads), or tree by tree in numpy for linear trees and for rows
          narrower than the trees' features (which raise there).

        Options are read from `kwargs`, then from the booster's params
        (strings such as "true" count, as params reloaded from model text
        are strings).  Converted outputs pass the f32 downcast of the raw
        sum through the objective's link.  `data` may be a sparse matrix,
        a DataFrame, an Arrow table or a `Sequence`, or the path of a data
        file in the training files' formats, read with the booster's
        params (its label column present and dropped; `data_has_header`
        declares a header line, as the `header` param does)."""
        if isinstance(data, str):
            from .cli import load_data_file
            params = {k: v for k, v in self.params.items()
                      if not callable(v)}
            if data_has_header:
                params["header"] = True
            data, _ = load_data_file(data, Config(params))
        X = _to_2d_float(data)
        n = X.shape[0]
        K = self.num_tree_per_iteration
        trees = self._slice_trees(start_iteration, num_iteration)
        if pred_leaf:
            out = np.zeros((n, len(trees)), dtype=np.int32)
            for i, t in enumerate(trees):
                out[:, i] = t.predict_leaf_index(X)
            return out
        if pred_contrib:
            return self._predict_contrib(X, trees)

        def opt(name, default):
            return kwargs.get(name, self.params.get(name, default))

        es = _flag(opt("pred_early_stop", False))
        es = es and (str(self.config.objective) == "binary" or K > 1)
        if _flag(opt("device_predict", False)) and not es and trees:
            device = train_device(kwargs.get("device_type",
                                              self.config.device_type))
            return self._predict_device(
                X, start_iteration, num_iteration, device,
                convert=not raw_score and self.objective_ is not None)
        raw = np.zeros((n, K), dtype=np.float64)
        if es and trees:
            freq = max(int(opt("pred_early_stop_freq", 10)), 1)
            margin = float(opt("pred_early_stop_margin", 10.0))
            active = np.ones(n, dtype=bool)
            all_active = True   # no masked copies until a row is decided
            for i, t in enumerate(trees):
                if all_active:
                    raw[:, i % K] += t.predict(X)
                else:
                    if not active.any():
                        break
                    raw[active, i % K] += t.predict(X[active])
                if (i + 1) % (freq * K) == 0:
                    if K == 1:
                        decided = 2.0 * np.abs(raw[:, 0]) >= margin
                    else:
                        part = np.partition(raw, K - 2, axis=1)
                        decided = (part[:, K - 1] - part[:, K - 2]) >= margin
                    active &= ~decided
                    all_active = bool(active.all())
        else:
            flat = self._flatten_for_native(trees)
            if flat is not None and X.shape[1] >= flat["min_features"]:
                from .native import predict_rows
                raw = predict_rows(flat, X, K,
                                   int(self.config.num_threads or 0))
            else:
                for i, t in enumerate(trees):
                    raw[:, i % K] += t.predict(X)
        if self._average_output and len(trees) >= K:
            raw /= max(len(trees) // K, 1)
        if K == 1:
            raw = raw[:, 0]
        if raw_score or self.objective_ is None:
            return raw
        return self.objective_.convert_output(
            torch.from_numpy(raw).to(torch.float32)).numpy()

    def _flatten_for_native(self, trees: List[Tree]) -> Optional[Dict]:
        """The trees' node and leaf arrays concatenated, with per-tree
        offsets, for the host library's walk (the reference's
        `booster.py:2686`), cached for the tree slice until the model
        changes; None without trees or with linear ones."""
        if not trees or any(t.is_linear for t in trees):
            return None
        key = (self._model_version, len(trees), id(trees[0]), id(trees[-1]))
        cached = getattr(self, "_native_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        offs = {k: [0] for k in ("node", "leaf", "cb", "bits")}
        cols = {k: [] for k in ("feat", "thr", "dtype", "left", "right",
                                "thr_bin", "leaf_value", "cat_bounds",
                                "cat_bits")}
        for t in trees:
            ni = max(t.num_leaves - 1, 0)
            for k, a in (("feat", t.split_feature), ("thr", t.threshold),
                         ("dtype", t.decision_type), ("left", t.left_child),
                         ("right", t.right_child),
                         ("thr_bin", t.threshold_bin)):
                cols[k].append(a[:ni])
            cols["leaf_value"].append(t.leaf_value[:t.num_leaves])
            cols["cat_bounds"].append(t.cat_boundaries)
            cols["cat_bits"].append(t.cat_threshold)
            for k, n in (("node", ni), ("leaf", t.num_leaves),
                         ("cb", len(t.cat_boundaries)),
                         ("bits", len(t.cat_threshold))):
                offs[k].append(offs[k][-1] + n)
        dt = dict(feat=np.int32, thr=np.float64, dtype=np.int32,
                  left=np.int32, right=np.int32, thr_bin=np.int32,
                  leaf_value=np.float64, cat_bounds=np.int64,
                  cat_bits=np.uint32)
        flat = {k: np.ascontiguousarray(np.concatenate(v), dt[k])
                for k, v in cols.items()}
        for k, v in offs.items():
            flat[f"{k}_off"] = np.asarray(v, np.int64)
        flat["n_trees"] = len(trees)
        flat["min_features"] = int(flat["feat"].max()) + 1 \
            if len(flat["feat"]) else 0
        self._native_cache = (key, flat)
        return flat

    def _predict_contrib(self, X: np.ndarray, trees: List[Tree]) -> np.ndarray:
        """TreeSHAP feature contributions (ref: PredictContrib -> tree.cpp
        TreeSHAP recursion); host numpy."""
        return predict_contrib(X, trees, self.num_tree_per_iteration)

    def _device_predict_state(self, start_iteration: int,
                              num_iteration: Optional[int],
                              device: torch.device) -> "_DevicePredict":
        """The compiled plan of the tree slice on `device`, cached with
        the slice's export (`export_predict_arrays`, which every change
        to the model drops), and the plan's records, which the fused
        kernel's f32 instance walks.  Random-forest texts plan with
        averaging off: the division comes after the f32 sum, on the
        host.  A model the plan refuses (`PlanNotCompilable`: a split
        feature past the 12-bit field, a palette or bitset past 16 bits)
        takes the stacked route instead, chosen here from the model
        before anything is launched: the stacked-plane traversal, then
        the same f32 sum with the slots in boosting order."""
        if num_iteration is None:
            num_iteration = self.best_iteration \
                if self.best_iteration > 0 else -1
        ex = self.export_predict_arrays(start_iteration, num_iteration,
                                        device=device)
        cached = self._device_predict_cache
        if cached is not None and cached[0] is ex:
            return cached[1]
        from .compiler import PlanNotCompilable, build_plan
        from .compiler.kernel import DeviceRecords
        from .compiler.records import build_records
        from .serving.runtime import DEFAULT_TILE_KB
        K = ex["num_class"]
        sp = ex["stacked"]
        try:
            plan = build_plan(dict(ex, average_factor=1),
                              tile_vmem_kb=DEFAULT_TILE_KB)
        except PlanNotCompilable:
            plan = None
        records = stacked = None
        if plan is not None:
            records = DeviceRecords.of(build_records(
                plan, sp["cls"].cpu().numpy() if K > 1 else None), device)
        elif torch.device(device).type != "cpu":
            # the stacked traversal's kernel reads one record a node
            from .ops.predict import with_records
            stacked = with_records(sp)
        else:
            stacked = sp
        state = _DevicePredict(records, stacked, sp["cls"] if K > 1 else None,
                               sp["value"], int(sp["min_features"]), K,
                               ex["average_factor"])
        self._device_predict_cache = (ex, state)
        return state

    def _predict_device(self, X: np.ndarray, start_iteration: int,
                        num_iteration: Optional[int], device: torch.device,
                        convert: bool) -> np.ndarray:
        """The JAX package's `_predict_raw_device` (`booster.py:2732`,
        the program `ops/predict.py:188 predict_raw_ensemble`): rows and
        thresholds in f32, leaf values the f32 `value` plane, summed in
        f32 in boosting order from +0.0.  Rows go in chunks of
        DEVICE_PREDICT_CHUNK (65,536; the stacked route's slots are
        [T, rows] int32, so 2M rows of 500 trees would take 4 GB); rows
        are independent, so the chunk does not change a bit.  A chunk is
        staged by `stage_rows` (padded on the stacked route only), and on
        the card runs, within the plan, one launch of the fused kernel's
        f32 instance (`csrc/serve.cu lgbt_serve_f32`: the walk over the
        plan's records and the f32 sum, no slots written), or on the
        stacked route one stacked-plane traversal (`csrc/stacked.cu`) and
        one f32 sum of its slots (`csrc/accumulate.cu`); then with
        `convert` the objective's link (`csrc/links.cu`).  On the CPU the
        same program runs the plain versions.  Raw scores are the f64
        cast of the f32 sums (divided in f64 by the iterations of a
        random forest, as the reference does); converted ones the link
        of their f32 cast."""
        global DEVICE_PREDICT_STACKED
        from .compiler import kernel
        from .ops.predict import (_identity_gather, accumulate_slots_f32,
                                  predict_leaf_ensemble)
        st = self._device_predict_state(start_iteration, num_iteration,
                                        device)
        K = st.num_class
        n = X.shape[0]
        if X.shape[1] < st.min_features:
            raise LightGBMError(
                f"X has {X.shape[1]} features; the model splits on feature "
                f"{st.min_features - 1}")
        outs = []
        for lo in range(0, n, DEVICE_PREDICT_CHUNK):
            Xc = X[lo:lo + DEVICE_PREDICT_CHUNK]
            if st.records is None:
                DEVICE_PREDICT_STACKED += 1
                sums = accumulate_slots_f32(
                    predict_leaf_ensemble(st.stacked, stage_rows(Xc, device)),
                    _identity_gather(st.values.shape[0], device), st.values,
                    n_class=K, cls=st.cls)[:Xc.shape[0]]
            else:
                sums = kernel.serve_forest_f32(
                    stage_rows(Xc, device, pad=False), st.records, st.values,
                    K)
            if st.average_factor != 1:
                raw = sums.cpu().numpy().astype(np.float64) \
                    / st.average_factor
                if convert:
                    raw = self.objective_.convert_output(
                        torch.from_numpy(raw).to(device).to(torch.float32)
                    ).cpu().numpy()
                outs.append(raw)
            elif convert:
                outs.append(self.objective_.convert_output(sums)
                            .cpu().numpy())
            else:
                outs.append(sums.cpu().numpy().astype(np.float64))
        if not outs:
            return np.zeros((0,) if K == 1 else (0, K),
                            np.float32 if convert else np.float64)
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def _stack_for_device(self, trees: List[Tree], device) -> Optional[Dict]:
        """Pad the trees into stacked [T, NI] / [T, NL] planes, built in
        numpy and then put on `device` (the JAX package's
        `Booster._stack_for_device`).  Categorical ensembles add
        `cat_words` [T, NI, MW] (the u32 bitsets as int32 bit patterns)
        and `cat_nwords` [T, NI]; multiclass adds `cls` [T], tree i's
        class i % K.  None for linear trees, which the device path does
        not serve."""
        if not trees or any(t.is_linear for t in trees):
            return None
        ni = max(max(t.num_leaves - 1, 1) for t in trees)
        T = len(trees)
        feat = np.zeros((T, ni), np.int32)
        thr = np.zeros((T, ni), np.float32)
        dtype_ = np.zeros((T, ni), np.int32)
        # pad nodes route to leaf 0 (~0 = -1): a single-leaf tree's root
        # terminates immediately with its constant value
        left = np.full((T, ni), -1, np.int32)
        right = np.full((T, ni), -1, np.int32)
        value = np.zeros((T, ni + 1), np.float32)
        has_cat = any(t.num_cat > 0 for t in trees)
        if has_cat:
            mw = 1
            for t in trees:
                if t.num_cat > 0 and len(t.cat_boundaries) > 1:
                    mw = max(mw, int(np.max(np.diff(t.cat_boundaries))))
            cat_words = np.zeros((T, ni, mw), np.uint32)
            cat_nwords = np.zeros((T, ni), np.int32)
        for i, t in enumerate(trees):
            k = t.num_leaves - 1
            feat[i, :k] = t.split_feature[:k]
            thr[i, :k] = t.threshold[:k]
            dtype_[i, :k] = t.decision_type[:k]
            left[i, :k] = t.left_child[:k]
            right[i, :k] = t.right_child[:k]
            value[i, :t.num_leaves] = t.leaf_value[:t.num_leaves]
            if has_cat and t.num_cat > 0:
                for nd in range(k):
                    if t.decision_type[nd] & 1:
                        cb = int(t.threshold_bin[nd])
                        lo = int(t.cat_boundaries[cb])
                        hi = int(t.cat_boundaries[cb + 1])
                        cat_nwords[i, nd] = hi - lo
                        cat_words[i, nd, :hi - lo] = t.cat_threshold[lo:hi]
        planes = dict(feat=feat, thr=thr, dtype=dtype_, left=left,
                      right=right, value=value)
        if has_cat:
            planes["cat_words"] = cat_words.view(np.int32)
            planes["cat_nwords"] = cat_nwords
        K = self.num_tree_per_iteration
        if K > 1:
            planes["cls"] = np.arange(T, dtype=np.int32) % K
        out = {k: torch.from_numpy(v).to(device) for k, v in planes.items()}
        out["min_features"] = int(feat.max()) + 1 if feat.size else 0
        return out

    def _model_changed(self) -> None:
        """The trees changed: drop the cached export (and so the device
        predict state keyed on it) and bump `_model_version`."""
        self._export_cache = None
        self._model_version += 1

    def export_predict_arrays(self, start_iteration: int = 0,
                              num_iteration: Optional[int] = None,
                              device="cpu") -> Dict:
        """Model export for the serving runtime, cached per tree slice
        and device (the JAX package's `export_predict_arrays`).

        Returns a dict:
          stacked        — tensors on `device` (see `_stack_for_device`)
                           plus `min_features`, or None for linear trees
          leaf_values    — [T, NL] f64 numpy leaf outputs, tree-padded
          value_f64      — the same table as an f64 tensor on `device`
                           (the JAX package carries it as two u32 bit
                           planes, `value_hi`/`value_lo`, because the
                           TPU has no f64); None when stacked is None
          trees          — the resolved host Tree slice
          num_class      — trees per iteration (K)
          average_factor — RF averaging divisor (1 = plain sum)
          version        — `_model_version` at export time
        """
        trees = self._slice_trees(start_iteration, num_iteration)
        device = torch.device(device)
        key = (start_iteration, num_iteration, len(self.trees), str(device))
        if self._export_cache is not None and self._export_cache[0] == key:
            return self._export_cache[1]
        stacked = self._stack_for_device(trees, device)
        nl = max((t.num_leaves for t in trees), default=1)
        leaf_values = np.zeros((len(trees), nl), np.float64)
        for i, t in enumerate(trees):
            leaf_values[i, :t.num_leaves] = t.leaf_value[:t.num_leaves]
        value_f64 = torch.from_numpy(leaf_values).to(device) \
            if stacked is not None else None
        K = self.num_tree_per_iteration
        avg = max(len(trees) // K, 1) \
            if self._average_output and len(trees) >= K else 1
        export = {"stacked": stacked, "leaf_values": leaf_values,
                  "value_f64": value_f64, "trees": trees, "num_class": K,
                  "average_factor": avg, "version": self._model_version}
        self._export_cache = (key, export)
        return export
