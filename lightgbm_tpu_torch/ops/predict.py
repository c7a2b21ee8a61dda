"""Batched tree routing and the exact f64 leaf-value sum.

The port's counterpart of `lightgbm_tpu/ops/predict.py`, for serving:

* `predict_leaf_ensemble` — the [T, N] int32 leaf slots of every tree
  of the stacked [T, NI] planes (`Booster.export_predict_arrays`), the
  JAX package's `:114 _leaf_slots` / `:632 predict_leaf_ensemble` (an
  XLA scan there).  CUDA tensors launch the stacked-plane traversal
  `csrc/stacked.cu` over the planes' records (`rec`, one 16-byte record
  a node, `compiler/records.py stacked_records`, added by `with_records`
  where a rung or `device_predict` runs the kernel); CPU tensors run the
  plain version
  `predict_leaf_ensemble_plain` (`_leaf_slots`: every tree and every row
  step together, one depth level per iteration, decision semantics of
  tree.h `NumericalDecision` / `CategoricalDecision` in f32).  The
  serving runtime's parity probes route their probe batch with the plain
  version.
* `accumulate_slots_exact` — the boosting-order f64 sum of pre-routed
  leaf slots.  The JAX package adds binary64 in software out of u32 ops
  (the TPU has no f64); here a CUDA kernel (`csrc/accumulate.cu`, the
  ordered-sum stage it shares with the fused serving kernel) adds
  native f64 in the same order, with the same round-to-nearest-even
  per step, so the bits agree.  On CPU tensors the wrapper runs the
  plain version, `accumulate_slots_exact_plain`.  The serving path sums
  inside the fused kernel (`compiler/kernel.py serve_forest`); this
  standalone sum is for callers that hold slots.
* `accumulate_slots_f32` — the boosting-order f32 sum of pre-routed
  leaf slots, `Booster.predict(device_predict=True)`'s: the JAX
  package's f32 scan (`lightgbm_tpu/ops/predict.py:188
  predict_raw_ensemble`, `:212` multiclass), an f32 carry from +0.0 and
  one round-to-nearest-even add a tree.  CUDA tensors go through the f32
  instance of `csrc/accumulate.cu`, CPU tensors through its plain
  version `accumulate_slots_f32_plain`.
* `accumulate_slots_bounded` — the bounded rung's sum (the JAX
  package's `:567 accumulate_slots_bounded`): int8 / int16 leaf codes
  summed exactly in int32 per (tile, class), then combined with the f32
  tile scales in ascending tile order, in the arithmetic XLA's CPU build
  gives that combine (`_combine_tiles`).  CUDA tensors launch
  `csrc/bounded.cu` (the trees of each (class, tile) group spread over a
  block's lanes, `compiler/records.py bounded_plan`), CPU tensors run
  `accumulate_slots_bounded_plain`.
* `predict_raw_ensemble_exact` / `predict_raw_ensemble_bounded` — the
  device-sum and the bounded program over the stacked planes: the
  stacked-plane traversal, then the exact f64 or the bounded sum.  The
  serving runtime's bounded rung runs `compiler.kernel.
  compiled_predict_bounded` over the plan instead; the stacked program
  is the JAX package's counterpart, bytewise the same.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..utils.log import LightGBMError

#: accumulate-kernel launches made by `accumulate_slots_exact`
ACCUMULATE_LAUNCHES = 0
#: f32 accumulate-kernel launches made by `accumulate_slots_f32`
ACCUMULATE_F32_LAUNCHES = 0
#: stacked-plane traversal launches made by `predict_leaf_ensemble`
STACKED_LAUNCHES = 0
#: bounded-sum launches made by `accumulate_slots_bounded`
ACCUMULATE_BOUNDED_LAUNCHES = 0

#: missing-type Zero's threshold (tree.h kZeroThreshold), compared in f32
_ZERO_THRESHOLD = float(np.float32(1e-35))


def _leaf_slots(node_feat, node_thr, node_dtype, node_left, node_right, X,
                cat_words=None, cat_nwords=None) -> torch.Tensor:
    """[T, N] int32 leaf slots of T trees (planes [T, NI]) for rows X
    [N, F] f32, or [N] for one tree (planes [NI]).

    NaN with missing_type != NaN reads 0.0; Zero / NaN missing goes to
    default_left; categorical nodes (decision_type bit 0) test the
    category's bit in `cat_words` [T, NI, MW] (int32 bit patterns) with
    the double-space range guard: NaN, out-of-span and v <= -1 go right.
    A feature id outside [0, F) reads 0.0 and a node id at or past NI
    routes to leaf 0 (malformed planes; `csrc/stacked.cu` has the same
    rules).  The loop ends when every cursor has reached a leaf, or after
    NI + 1 steps."""
    one = node_feat.dim() == 1
    if one:
        node_feat, node_thr, node_dtype, node_left, node_right = (
            p.unsqueeze(0) for p in (node_feat, node_thr, node_dtype,
                                     node_left, node_right))
        if cat_words is not None:
            cat_words = cat_words.unsqueeze(0)
            cat_nwords = cat_nwords.unsqueeze(0)
    t_trees, ni = node_feat.shape
    n = X.shape[0]
    xt = X.t()                                      # [F, N]
    nd = torch.zeros((t_trees, n), dtype=torch.int64, device=X.device)
    tree_ix = torch.arange(t_trees, device=X.device)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=X.device)
    n_feat = X.shape[1]
    for _ in range(ni + 1):
        nd = torch.where(nd >= ni, -1, nd)
        active = nd >= 0
        if not bool(active.any()):
            break
        idx = torch.where(active, nd, 0)
        f = torch.gather(node_feat, 1, idx).long()
        f_ok = (f >= 0) & (f < n_feat)
        fval = torch.gather(xt, 0, torch.where(f_ok, f, 0)) if n_feat \
            else zero.expand(f.shape)
        fval = torch.where(f_ok, fval, zero)
        dt = torch.gather(node_dtype, 1, idx)
        missing_type = (dt >> 2) & 3
        default_left = (dt & 2) != 0
        isnan = torch.isnan(fval)
        fv = torch.where(isnan & (missing_type != 2), zero, fval)
        is_missing = (((missing_type == 1) & (fv.abs() <= _ZERO_THRESHOLD))
                      | ((missing_type == 2) & isnan))
        go_left = torch.where(is_missing, default_left,
                              fv <= torch.gather(node_thr, 1, idx))
        if cat_words is not None:
            mw = cat_words.shape[-1]
            span = (torch.gather(cat_nwords, 1, idx) * 32).to(torch.float32)
            ok = ~isnan & (fval > -1.0) & (fval < span)
            v = torch.where(ok, fval, zero).to(torch.int32)
            widx = torch.clamp(v // 32, 0, max(mw - 1, 0)).long()
            w = cat_words[tree_ix, idx, widx]
            bit = (w >> (v % 32)) & 1
            go_left = torch.where((dt & 1) == 1, ok & (bit == 1), go_left)
        child = torch.where(go_left, torch.gather(node_left, 1, idx),
                            torch.gather(node_right, 1, idx)).long()
        nd = torch.where(active, child, nd)
    slots = (~nd).to(torch.int32)
    return slots[0] if one else slots


def predict_leaf_ensemble_plain(stacked: Dict, X: torch.Tensor
                                ) -> torch.Tensor:
    """Plain version of the stacked-plane traversal: [T, N] int32 leaf
    slots of every stacked tree for rows X [N, F] f32 (`_leaf_slots`)."""
    return _leaf_slots(stacked["feat"], stacked["thr"], stacked["dtype"],
                       stacked["left"], stacked["right"], X,
                       cat_words=stacked.get("cat_words"),
                       cat_nwords=stacked.get("cat_nwords"))


#: the planes a stacked record is built from
_RECORD_PLANES = ("feat", "thr", "dtype", "left", "right", "cat_nwords")


def _planes_key(stacked: Dict) -> tuple:
    """What the records of `stacked` must have been built from: each
    plane's storage and its count of in-place edits."""
    return tuple((t.data_ptr(), t._version) for t in (
        stacked.get(k) for k in _RECORD_PLANES) if t is not None)


def with_records(stacked: Dict) -> Dict:
    """`stacked` with its records `rec` [T, NI, 4] int32 (`compiler/
    records.py stacked_records`) built from its planes, on their device:
    what the stacked traversal's kernel reads.  The records are marked
    with the planes they were built from; the kernel refuses them once a
    plane was replaced or edited in place, so a caller that edits the
    planes rebuilds them here."""
    from ..compiler.records import stacked_records
    host = {k: stacked[k].cpu().numpy()
            for k in ("feat", "thr", "dtype", "left", "right")}
    nw = stacked.get("cat_nwords")
    rec = torch.from_numpy(stacked_records(
        **host, cat_nwords=None if nw is None else nw.cpu().numpy())).to(
            stacked["feat"].device)
    rec._lgbt_planes = _planes_key(stacked)
    return dict(stacked, rec=rec)


def records_current(stacked: Dict) -> bool:
    """Were the records `stacked["rec"]` built from these planes, none
    of them replaced or edited in place since?"""
    rec = stacked.get("rec")
    return rec is not None \
        and getattr(rec, "_lgbt_planes", None) == _planes_key(stacked)


def stacked_to(stacked: Dict, device) -> Dict:
    """A copy of `stacked` with its tensors on `device` (new copies, also
    where one already lies there); records that were current stay marked
    current for the copied planes."""
    out = {k: v.to(device, copy=True) if isinstance(v, torch.Tensor)
           else v for k, v in stacked.items()}
    if records_current(stacked):
        out["rec"]._lgbt_planes = _planes_key(out)
    return out


def _check_stacked(stacked: Dict, X: torch.Tensor) -> None:
    if X.dim() != 2 or X.dtype != torch.float32:
        raise LightGBMError("X must be [N, F] float32")
    feat = stacked["feat"]
    if feat.dim() != 2:
        raise LightGBMError("stacked planes must be [T, NI]")
    for k in ("feat", "dtype", "left", "right"):
        if stacked[k].shape != feat.shape or stacked[k].dtype != torch.int32:
            raise LightGBMError(f"stacked {k} must be [T, NI] int32")
    if stacked["thr"].shape != feat.shape \
            or stacked["thr"].dtype != torch.float32:
        raise LightGBMError("stacked thr must be [T, NI] float32")
    cw = stacked.get("cat_words")
    if cw is not None and (cw.dim() != 3 or cw.shape[:2] != feat.shape
                           or cw.dtype != torch.int32
                           or stacked["cat_nwords"].shape != feat.shape):
        raise LightGBMError("cat_words must be [T, NI, MW] int32 beside "
                            "cat_nwords [T, NI]")
    rec = stacked.get("rec")
    if rec is not None and (tuple(rec.shape) != tuple(feat.shape) + (4,)
                            or rec.dtype != torch.int32):
        raise LightGBMError("stacked rec must be [T, NI, 4] int32")
    tensors = [X] + [stacked[k] for k in ("feat", "thr", "dtype", "left",
                                          "right")]
    if cw is not None:
        tensors += [cw, stacked["cat_nwords"]]
    if rec is not None:
        tensors.append(rec)
    if any(t.device != X.device for t in tensors):
        raise LightGBMError("traversal inputs lie on different devices")


def predict_leaf_ensemble(stacked: Dict, X: torch.Tensor, *,
                          plan=None) -> torch.Tensor:
    """[T, N] int32 leaf slots of every stacked tree for rows X [N, F]
    f32.  CUDA tensors launch `csrc/stacked.cu` over the planes' records
    `stacked["rec"]` (with `plan`, default `compiler.records.
    stacked_plan`: a block of rows walks a chunk of trees); CPU tensors
    run `predict_leaf_ensemble_plain`."""
    global STACKED_LAUNCHES
    if X.device.type == "cpu":
        return predict_leaf_ensemble_plain(stacked, X)
    if X.device.type != "cuda":
        raise LightGBMError(f"no traversal kernel for {X.device}")
    _check_stacked(stacked, X)
    rec = stacked.get("rec")
    if rec is None:
        raise LightGBMError("stacked planes carry no records: add them "
                            "with `with_records`")
    if not records_current(stacked):
        raise LightGBMError("stacked records were not built from these "
                            "planes (a plane replaced or edited since): "
                            "rebuild them with `with_records`")
    from ..compiler.records import STACKED_FEAT_OUT, stacked_plan
    cw = stacked.get("cat_words")
    if not all(t.is_contiguous() for t in (X, rec) + (
            () if cw is None else (cw,))):
        raise LightGBMError("traversal inputs must be contiguous")
    t_trees, ni = stacked["feat"].shape
    n, f = X.shape
    if f > STACKED_FEAT_OUT:
        raise LightGBMError(f"X has {f} features; the stacked records "
                            f"hold ids below {STACKED_FEAT_OUT}")
    out = torch.empty((t_trees, n), dtype=torch.int32, device=X.device)
    if n == 0 or t_trees == 0:
        return out
    from ..compiler import _build
    lib = _build.load("stacked")
    plan = plan or stacked_plan(n, f, t_trees)
    rc = _build.on_stream(X.device, lambda stream: lib.lgbt_stacked_slots(
        X.data_ptr(), n, f, rec.data_ptr(),
        None if cw is None else cw.data_ptr(), t_trees, ni,
        0 if cw is None else cw.shape[2], plan.rows, plan.trees,
        plan.threads, out.data_ptr(), ctypes.c_void_p(stream)))
    if rc != 0:
        raise LightGBMError(f"stacked traversal launch failed: CUDA error "
                            f"{rc}")
    STACKED_LAUNCHES += 1
    return out


def _check_accumulate(slots, gather_idx, leaf_values, n_class, cls,
                      dtype=torch.float64):
    if slots.dim() != 2 or slots.dtype != torch.int32:
        raise LightGBMError("slots must be [R, B] int32")
    if gather_idx.dim() != 1 or gather_idx.dtype != torch.int32:
        raise LightGBMError("gather_idx must be [T] int32")
    if leaf_values.dim() != 2 or leaf_values.dtype != dtype:
        raise LightGBMError(f"leaf_values must be [T, NL] {dtype}")
    if gather_idx.shape[0] != leaf_values.shape[0]:
        raise LightGBMError(
            f"gather_idx names {gather_idx.shape[0]} trees, leaf_values "
            f"{leaf_values.shape[0]}")
    if n_class > 1 and (cls is None or cls.shape != gather_idx.shape
                        or cls.dtype != torch.int32):
        raise LightGBMError("multiclass needs cls, [T] int32")
    tensors = [slots, gather_idx, leaf_values] + (
        [cls] if n_class > 1 else [])
    if any(t.device != slots.device for t in tensors):
        raise LightGBMError("accumulate inputs lie on different devices")


def _accumulate_plain(slots, gather_idx, leaf_values, n_class, cls,
                      dtype):
    """The plain sum in `dtype`: a loop over trees in boosting order,
    from +0.0; tree t reads row `gather_idx[t]` of `slots` [R, B] and
    adds `leaf_values[t, slot]` into its class column `cls[t]`.  Indices
    past the tables clamp, as the JAX package's gathers do."""
    _check_accumulate(slots, gather_idx, leaf_values, n_class, cls, dtype)
    r, b = slots.shape
    nl = leaf_values.shape[1]
    gidx = gather_idx.clamp(0, r - 1).tolist()
    cls_host = cls.tolist() if n_class > 1 else None
    shape = (b, n_class) if n_class > 1 else (b,)
    acc = torch.zeros(shape, dtype=dtype, device=slots.device)
    for t, g in enumerate(gidx):
        v = leaf_values[t][slots[g].long().clamp(0, nl - 1)]
        if n_class > 1:
            k = cls_host[t]
            acc[:, k] = acc[:, k] + v
        else:
            acc = acc + v
    return acc


def _accumulate(symbol, slots, gather_idx, leaf_values, n_class, cls,
                dtype):
    """Launch `csrc/accumulate.cu`'s entry `symbol` (the kernel in
    `dtype`) at `records.accumulate_plan`: [B] or [B, K] of `dtype`."""
    if slots.device.type != "cuda":
        raise LightGBMError(f"no accumulate kernel for {slots.device}")
    _check_accumulate(slots, gather_idx, leaf_values, n_class, cls, dtype)
    for t in (slots, gather_idx, leaf_values, cls):
        if t is not None and not t.is_contiguous():
            raise LightGBMError("accumulate inputs must be contiguous")
    from ..compiler import _build
    from ..compiler.records import accumulate_plan
    lib = _build.load("accumulate")
    r, b = slots.shape
    t_trees, nl = leaf_values.shape
    k = max(n_class, 1)
    shape = (b, n_class) if n_class > 1 else (b,)
    out = torch.empty(shape, dtype=dtype, device=slots.device)
    if b == 0:
        return out
    plan = accumulate_plan(b, t_trees, k)
    entry = getattr(lib, symbol)
    rc = _build.on_stream(slots.device, lambda stream: entry(
        slots.data_ptr(), r, b, gather_idx.data_ptr(),
        leaf_values.data_ptr(), t_trees, nl,
        cls.data_ptr() if n_class > 1 else None, k, plan.rows, plan.trees,
        plan.threads, plan.smem, out.data_ptr(), ctypes.c_void_p(stream)))
    if rc != 0:
        raise LightGBMError(f"accumulate kernel launch failed: CUDA error "
                            f"{rc}")
    return out


def accumulate_slots_exact_plain(slots: torch.Tensor,
                                 gather_idx: torch.Tensor,
                                 leaf_values: torch.Tensor,
                                 n_class: int = 1,
                                 cls: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain version of the accumulate kernel: a loop over trees in
    boosting order, f64, starting from +0.0.  Tree t reads row
    `gather_idx[t]` of `slots` [R, B] and adds `leaf_values[t, slot]`
    into its class column `cls[t]`.  Indices past the tables clamp, as
    the JAX package's gathers do.  Returns [B] or [B, K] float64."""
    return _accumulate_plain(slots, gather_idx, leaf_values, n_class, cls,
                             torch.float64)


def accumulate_slots_exact(slots: torch.Tensor, gather_idx: torch.Tensor,
                           leaf_values: torch.Tensor, n_class: int = 1,
                           cls: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Boosting-order f64 sum of pre-routed leaf slots: [B] or [B, K]
    float64.  CUDA tensors go through `csrc/accumulate.cu` (chunks of
    trees gathered into shared memory, then one thread per (row, class)
    adding them in order with `__dadd_rn`, built with `-fmad=false`;
    the launch is `compiler/records.py accumulate_plan`); CPU tensors
    through the plain version."""
    global ACCUMULATE_LAUNCHES
    if slots.device.type == "cpu":
        return accumulate_slots_exact_plain(slots, gather_idx, leaf_values,
                                            n_class, cls)
    out = _accumulate("lgbt_accumulate", slots, gather_idx, leaf_values,
                      n_class, cls, torch.float64)
    if out.shape[0]:
        ACCUMULATE_LAUNCHES += 1
    return out


def accumulate_slots_f32_plain(slots: torch.Tensor,
                               gather_idx: torch.Tensor,
                               leaf_values: torch.Tensor, n_class: int = 1,
                               cls: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain version of the f32 accumulate kernel: the loop of
    `accumulate_slots_exact_plain` in f32 (leaf values [T, NL] float32),
    from +0.0, one f32 add a tree: the JAX package's scan carry.
    Returns [B] or [B, K] float32."""
    return _accumulate_plain(slots, gather_idx, leaf_values, n_class, cls,
                             torch.float32)


def accumulate_slots_f32(slots: torch.Tensor, gather_idx: torch.Tensor,
                         leaf_values: torch.Tensor, n_class: int = 1,
                         cls: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boosting-order f32 sum of pre-routed leaf slots (`device_predict`):
    [B] or [B, K] float32 from f32 leaf values [T, NL].  CUDA tensors go
    through the f32 instance of `csrc/accumulate.cu` (the f64 sum's
    design and launch plan, `__fadd_rn`, `-fmad=false`); CPU tensors
    through the plain version."""
    global ACCUMULATE_F32_LAUNCHES
    if slots.device.type == "cpu":
        return accumulate_slots_f32_plain(slots, gather_idx, leaf_values,
                                          n_class, cls)
    out = _accumulate("lgbt_accumulate_f32", slots, gather_idx, leaf_values,
                      n_class, cls, torch.float32)
    if out.shape[0]:
        ACCUMULATE_F32_LAUNCHES += 1
    return out


def _identity_gather(t_trees: int, device) -> torch.Tensor:
    """gather_idx of slots in boosting order: row t for tree t."""
    return torch.arange(t_trees, dtype=torch.int32, device=device)


def predict_raw_ensemble_exact(stacked: Dict, X: torch.Tensor,
                               value_f64: torch.Tensor, n_class: int = 1,
                               convert: Optional[Callable] = None
                               ) -> torch.Tensor:
    """The device-sum program (the JAX package's `predict_raw_ensemble_
    exact`): `predict_leaf_ensemble`, then `accumulate_slots_exact` over
    the slots in boosting order.  f64 raw sums ([N] or [N, K]), or
    `convert` of their round-to-nearest-even f32 downcast."""
    slots = predict_leaf_ensemble(stacked, X)
    raw = accumulate_slots_exact(
        slots, _identity_gather(slots.shape[0], X.device), value_f64,
        n_class, stacked.get("cls") if n_class > 1 else None)
    return raw if convert is None else convert(raw.to(torch.float32))


# ------------------------------------------------------- the bounded sum
class BoundedGroups(NamedTuple):
    """The trees listed by (class, tile), tiles ascending within a class:
    class k's groups are `cls_start[k]:cls_start[k + 1]`, group g holds
    tile `grp_tile[g]` and the trees `grp_trees[grp_start[g]:
    grp_start[g + 1]]`.  All int32 tensors on one device."""
    grp_tile: torch.Tensor
    grp_start: torch.Tensor
    grp_trees: torch.Tensor
    cls_start: torch.Tensor


def bounded_groups(tile_of_tree: np.ndarray, n_class: int, device,
                   n_tiles: Optional[int] = None) -> BoundedGroups:
    """The `BoundedGroups` of `tile_of_tree` [T] (tree t's class t % K,
    the stacked planes' `cls`), built on the host at refresh.  With
    `n_tiles` (S) the tiles are clamped to [0, S) first, as the plain
    version clamps them, so the kernel sums what it sums."""
    tile = np.asarray(tile_of_tree, np.int64)
    if n_tiles is not None:
        tile = np.clip(tile, 0, max(int(n_tiles), 1) - 1)
    t_trees = len(tile)
    cls = np.arange(t_trees) % max(n_class, 1)
    order = np.lexsort((np.arange(t_trees), tile, cls))
    key = cls[order] * (int(tile.max(initial=0)) + 1) + tile[order]
    first = np.ones(t_trees, bool)
    first[1:] = key[1:] != key[:-1]
    starts = np.flatnonzero(first)
    grp_cls = cls[order][starts]
    cls_start = np.searchsorted(grp_cls, np.arange(max(n_class, 1) + 1))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    return BoundedGroups(put(tile[order][starts]),
                         put(np.append(starts, t_trees)), put(order),
                         put(cls_start))


def _fma_f32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c rounded once, as the card's `fma` (and XLA's CPU
    contraction) rounds it, for f32 tensors a, c and an f32-exact b.

    a * b is exact in f64 (24 + 24 bits); s = p + c is rounded there and
    TwoSum gives its error e exactly.  Rounding s to odd (its last bit set
    when e != 0) keeps what the second rounding needs, so the cast to f32
    is the correctly rounded a * b + c."""
    p = a.double() * b
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    inexact = (e != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    away = (e > 0) == (s > 0)
    bits = torch.where(inexact, torch.where(away, bits + 1, bits - 1), bits)
    return bits.view(torch.float64).to(torch.float32)


def _combine_tiles(partial: torch.Tensor, scales: torch.Tensor
                   ) -> torch.Tensor:
    """The f32 combine of int32 partials [S, ...] under scales [S], in
    the arithmetic of the JAX package on XLA's CPU build, where LLVM
    contracts `p_0 s_0 + p_1 s_1 + ...`: one tile gives round(p_0 s_0);
    more give fma(p_0, s_0, round(p_1 s_1)), then fma(p_s, s_s, out) for
    s = 2, 3, ... (`csrc/bounded.cu` does the same with __fmul_rn and
    __fmaf_rn)."""
    pf = partial.to(torch.float32)
    sc = scales.tolist()
    if len(sc) == 1:
        return (pf[0].double() * sc[0]).to(torch.float32)
    out = _fma_f32(pf[0], sc[0],
                   (pf[1].double() * sc[1]).to(torch.float32))
    for s in range(2, len(sc)):
        out = _fma_f32(pf[s], sc[s], out)
    return out


def _check_bounded(slots, qval, tile_of_tree, scales, n_class, gather_idx):
    if slots.dim() != 2 or slots.dtype != torch.int32:
        raise LightGBMError("slots must be [R, B] int32")
    if qval.dim() != 2 or qval.dtype not in (torch.int8, torch.int16):
        raise LightGBMError("qval must be [T, NL] int8 or int16")
    if tile_of_tree.shape != qval.shape[:1] \
            or tile_of_tree.dtype != torch.int32:
        raise LightGBMError("tile_of_tree must be [T] int32")
    if scales.dim() != 1 or scales.dtype != torch.float32 \
            or scales.shape[0] == 0:
        raise LightGBMError("scales must be [S] float32, S >= 1")
    if gather_idx.shape != qval.shape[:1] or gather_idx.dtype != torch.int32:
        raise LightGBMError("gather_idx must be [T] int32")
    if n_class < 1:
        raise LightGBMError(f"n_class must be positive, got {n_class}")
    if any(t.device != slots.device
           for t in (qval, tile_of_tree, scales, gather_idx)):
        raise LightGBMError("bounded-sum inputs lie on different devices")


def accumulate_slots_bounded_plain(slots: torch.Tensor, qval: torch.Tensor,
                                   tile_of_tree: torch.Tensor,
                                   scales: torch.Tensor, n_class: int = 1,
                                   gather_idx: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Plain version of the bounded sum: tree t's code `qval[t, slot]`
    (its slot read at row `gather_idx[t]` of `slots` [R, B], default row
    t; indices past the tables clamp) is added in int32 into the partial
    of (tile_of_tree[t], t % K); the partials are combined per class by
    `_combine_tiles`.  [B] or [B, K] float32."""
    t_trees = qval.shape[0]
    if gather_idx is None:
        gather_idx = _identity_gather(t_trees, slots.device)
    _check_bounded(slots, qval, tile_of_tree, scales, n_class, gather_idx)
    r, b = slots.shape
    nl = qval.shape[1]
    n_tiles = scales.shape[0]
    rows = slots[gather_idx.long().clamp(0, r - 1)].long().clamp(0, nl - 1)
    codes = torch.gather(qval, 1, rows).to(torch.int32)          # [T, B]
    key = (tile_of_tree.long().clamp(0, n_tiles - 1) * n_class
           + torch.arange(t_trees, device=slots.device) % n_class)
    partial = torch.zeros((n_tiles * n_class, b), dtype=torch.int32,
                          device=slots.device).index_add_(0, key, codes)
    out = _combine_tiles(partial.view(n_tiles, n_class, b), scales)
    return out[0] if n_class == 1 else out.t().contiguous()


def accumulate_slots_bounded(slots: torch.Tensor, qval: torch.Tensor,
                             tile_of_tree: torch.Tensor,
                             scales: torch.Tensor, n_class: int = 1,
                             gather_idx: Optional[torch.Tensor] = None,
                             groups: Optional[BoundedGroups] = None, *,
                             plan=None) -> torch.Tensor:
    """The bounded sum of pre-routed leaf slots: [B] or [B, K] float32
    within the bound `compiler.quantize.pack_bounded` publishes.  CUDA
    tensors launch `csrc/bounded.cu` over `groups` (default: built from
    `tile_of_tree`, a host copy; the serving runtime builds them once at
    refresh, with `n_tiles`) with `plan` (default `compiler.records.
    bounded_plan`); CPU tensors run `accumulate_slots_bounded_plain`."""
    global ACCUMULATE_BOUNDED_LAUNCHES
    if slots.device.type == "cpu":
        return accumulate_slots_bounded_plain(slots, qval, tile_of_tree,
                                              scales, n_class, gather_idx)
    if slots.device.type != "cuda":
        raise LightGBMError(f"no bounded-sum kernel for {slots.device}")
    t_trees, nl = qval.shape
    if gather_idx is None:
        gather_idx = _identity_gather(t_trees, slots.device)
    _check_bounded(slots, qval, tile_of_tree, scales, n_class, gather_idx)
    if groups is None:
        groups = bounded_groups(tile_of_tree.cpu().numpy(), n_class,
                                slots.device, n_tiles=scales.shape[0])
    tensors = (slots, qval, tile_of_tree, scales, gather_idx) + tuple(groups)
    if any(t.device != slots.device for t in groups):
        raise LightGBMError("bounded-sum inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise LightGBMError("bounded-sum inputs must be contiguous")
    from ..compiler import _build
    from ..compiler.records import bounded_plan
    r, b = slots.shape
    out = torch.empty((b, n_class) if n_class > 1 else (b,),
                      dtype=torch.float32, device=slots.device)
    if b == 0:
        return out
    lib = _build.load("bounded")
    n_groups = groups.grp_tile.shape[0]
    if groups.cls_start.shape[0] != n_class + 1 \
            or groups.grp_start.shape[0] != n_groups + 1 \
            or groups.grp_trees.shape[0] != t_trees:
        raise LightGBMError("bounded groups do not match the trees and "
                            "classes")
    plan = plan or bounded_plan(b, t_trees, n_groups, n_class)
    bits = 8 if qval.dtype == torch.int8 else 16
    rc = _build.on_stream(slots.device, lambda stream:
                          lib.lgbt_accumulate_bounded(
        slots.data_ptr(), r, b, gather_idx.data_ptr(), qval.data_ptr(),
        bits, t_trees, nl, groups.grp_tile.data_ptr(),
        groups.grp_start.data_ptr(), groups.grp_trees.data_ptr(),
        groups.cls_start.data_ptr(), n_class, scales.data_ptr(),
        scales.shape[0], n_groups, plan.rows, plan.lanes, plan.group_chunk,
        plan.smem, out.data_ptr(), ctypes.c_void_p(stream)))
    if rc != 0:
        raise LightGBMError(f"bounded-sum launch failed: CUDA error {rc}")
    ACCUMULATE_BOUNDED_LAUNCHES += 1
    return out


def predict_raw_ensemble_bounded(stacked: Dict, X: torch.Tensor,
                                 qval: torch.Tensor,
                                 tile_of_tree: torch.Tensor,
                                 scales: torch.Tensor, n_class: int = 1,
                                 convert: Optional[Callable] = None,
                                 groups: Optional[BoundedGroups] = None
                                 ) -> torch.Tensor:
    """The bounded program over the stacked planes (the JAX package's
    `predict_raw_ensemble_bounded`): `predict_leaf_ensemble`, then
    `accumulate_slots_bounded` in boosting order; `convert` applied to
    the f32 scores when given."""
    out = accumulate_slots_bounded(predict_leaf_ensemble(stacked, X), qval,
                                   tile_of_tree, scales, n_class,
                                   groups=groups)
    return out if convert is None else convert(out)
