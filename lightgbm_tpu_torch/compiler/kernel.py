"""The serving kernels' wrappers and their plain versions.

The port's counterpart of `lightgbm_tpu/compiler/kernel.py`.

* `serve_forest` — the fused entry on the serving path: one launch of
  `csrc/serve.cu` routes every row through every tree of every depth
  bucket, reading the forest's records (`compiler/records.py`), and sums
  the leaf values in boosting order, exactly (f64, round to nearest
  even, from +0.0): the [B] or [B, K] raw scores.  It replaces the TPU
  kernel `_traverse_kernel` and the XLA accumulation together; its
  plain version `serve_forest_plain` reads the same records.
* `serve_forest_f32` — the fused entry's f32 instance
  (`lgbt_serve_f32`), `Booster.predict(device_predict=True)`'s device
  program within the plan (one launch a chunk): the same walk over the
  same records, then each tree's f32 leaf value added in boosting order
  from +0.0 with one f32 add (the JAX package's `ops/predict.py:188
  predict_raw_ensemble`, `:212` multiclass): [B] or [B, K] float32; its
  plain version `serve_forest_f32_plain`.
* `traverse_bucket` — the standalone K6 (`csrc/traverse.cu`): one depth
  bucket's [tiles * TT, B] leaf slots over the JAX layout's planes,
  for callers that need slots; its plain version
  `traverse_bucket_plain`.  `ops.predict.accumulate_slots_exact` is the
  standalone sum of such slots.
* `compiled_predict` — the compiled path's device program: the fused
  entry when the records are given, else every bucket's traverse and
  the standalone sum (the JAX package's program).
* `compiled_predict_bounded` — the bounded rung's program over the
  plan: every bucket's traverse, then `ops.predict.
  accumulate_slots_bounded` reads each tree's slots at its plan row
  (the JAX package's `:200 compiled_predict_bounded`).

Each wrapper launches its hand-written CUDA kernel for CUDA tensors and
runs its plain version for CPU tensors.  There is no fallback from one
to the other: a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.predict import (_ZERO_THRESHOLD, BoundedGroups,
                           accumulate_slots_bounded, accumulate_slots_exact)
from ..utils.log import LightGBMError
from .records import (ForestPlan, ForestRecords, RowPlan, forest_plan,
                      traverse_plan)

#: bucket height: batches above it are padded to a multiple of it, so
#: the standalone traverse's batches stay bucket-padded
ROW_BLOCK = 256

#: traverse-kernel launches made by `traverse_bucket`
TRAVERSE_LAUNCHES = 0
#: fused serving-kernel launches made by `serve_forest`
SERVE_LAUNCHES = 0
#: launches of the fused kernel's f32 instance made by `serve_forest_f32`
SERVE_F32_LAUNCHES = 0


def _check_bucket(X, words, kids, pal, catw, depth, mw):
    if X.dim() != 2 or X.dtype != torch.float32:
        raise LightGBMError("X must be [B, F] float32")
    if words.dim() != 3 or words.dtype != torch.int32 \
            or kids.shape != words.shape or kids.dtype != torch.int32:
        raise LightGBMError("words and kids must be [tiles, TT, NI] int32")
    if pal.dim() != 2 or pal.dtype != torch.float32 \
            or pal.shape[0] != words.shape[0]:
        raise LightGBMError("pal must be [tiles, P] float32")
    if mw:
        if catw is None or catw.dtype != torch.int32 \
                or tuple(catw.shape) != tuple(words.shape) + (mw,):
            raise LightGBMError("catw must be [tiles, TT, NI, mw] int32")
    elif catw is not None:
        raise LightGBMError("catw given with mw == 0")
    if depth < 0:
        raise LightGBMError(f"negative traversal depth {depth}")
    b = X.shape[0]
    br = min(b, ROW_BLOCK)
    if br == 0 or b % br:
        raise LightGBMError(f"batch of {b} rows is not bucket-padded "
                            f"(row block {br})")
    tensors = [X, words, kids, pal] + ([catw] if mw else [])
    if any(t.device != X.device for t in tensors):
        raise LightGBMError("traverse inputs lie on different devices")


def _route(fval, w, kd, thr, cat_of, mw):
    """One routing step of every cursor, decoded from node words `w`,
    child words `kd`, thresholds `thr` and feature values `fval` (all
    [n, B]); `cat_of(widx)` reads the bitset words.  The next cursors,
    as `csrc/forest_common.cuh walk` computes them."""
    zero = torch.zeros((), dtype=torch.float32, device=fval.device)
    code = w & 0xFFFF
    default_left = ((w >> 28) & 1) != 0
    missing_type = (w >> 29) & 3
    isnan = fval != fval
    fv = torch.where(isnan & (missing_type != 2), zero, fval)
    is_missing = (((missing_type == 1) & (fv.abs() <= _ZERO_THRESHOLD))
                  | ((missing_type == 2) & isnan))
    go_left = torch.where(is_missing, default_left, fv <= thr)
    if mw:
        span = (code * 32).to(torch.float32)
        ok = ~isnan & (fval > -1.0) & (fval < span)
        v = torch.where(ok, fval, zero).to(torch.int32)
        widx = torch.clamp(v // 32, 0, mw - 1).long()
        bit = (cat_of(widx) >> (v % 32)) & 1
        go_left = torch.where(w < 0, ok & (bit == 1), go_left)
    return torch.where(go_left, kd >> 16, ((kd & 0xFFFF) ^ 0x8000) - 0x8000)


def _features(xt, feat):
    """x[row, feat] for feature ids `feat` [n, B] over rows xt [F, B],
    with +0.0 for an id >= F."""
    f = xt.shape[0]
    if not f:
        return torch.zeros(feat.shape, dtype=torch.float32,
                           device=xt.device)
    fval = torch.gather(xt, 0, torch.where(feat < f, feat, 0).long())
    return torch.where(feat < f, fval, torch.zeros((), dtype=torch.float32,
                                                   device=xt.device))


def traverse_bucket_plain(X: torch.Tensor, words: torch.Tensor,
                          kids: torch.Tensor, pal: torch.Tensor,
                          catw: Optional[torch.Tensor], depth: int,
                          mw: int) -> torch.Tensor:
    """Plain version of the traverse kernel: [tiles * TT, B] int32
    slots.  A depth loop over [tiles * TT, B] cursors with
    `torch.gather`, decoding the packed words exactly as the kernel
    does, with the same out-of-range rules: a feature id >= F reads
    0.0, a palette code >= P reads a threshold of 0.0, a cursor >= NI
    moves to the root, and a cursor still >= 0 after `depth` steps
    lands on leaf 0."""
    _check_bucket(X, words, kids, pal, catw, depth, mw)
    ntiles, tt, ni = words.shape
    b = X.shape[0]
    p = pal.shape[1]
    n_trees = ntiles * tt
    dev = X.device
    w_all = words.reshape(n_trees, ni)
    k_all = kids.reshape(n_trees, ni)
    pal_t = pal.repeat_interleave(tt, dim=0)            # [tiles*TT, P]
    cat_all = catw.reshape(n_trees, ni, mw) if mw else None
    xt = X.t()                                          # [F, B]
    tree_ix = torch.arange(n_trees, device=dev)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    nd = torch.zeros((n_trees, b), dtype=torch.int32, device=dev)
    for _ in range(depth):
        in_range = (nd >= 0) & (nd < ni)
        idx = torch.where(in_range, nd, 0).long()
        w = torch.gather(w_all, 1, idx)
        kd = torch.gather(k_all, 1, idx)
        code = w & 0xFFFF
        thr = torch.gather(pal_t, 1, torch.where(code < p, code, 0).long())
        thr = torch.where(code < p, thr, zero)
        nxt = _route(_features(xt, (w >> 16) & 0xFFF), w, kd, thr,
                     lambda widx: cat_all[tree_ix, idx, widx], mw)
        nxt = torch.where(in_range, nxt, 0)
        nd = torch.where(nd >= 0, nxt, nd)
    return ~torch.clamp(nd, max=-1)


def traverse_bucket(X: torch.Tensor, words: torch.Tensor,
                    kids: torch.Tensor, pal: torch.Tensor,
                    catw: Optional[torch.Tensor], depth: int,
                    mw: int, *, plan: Optional[RowPlan] = None
                    ) -> torch.Tensor:
    """Route the rows X [B, F] f32 through every tree of one depth
    bucket's tiles: [tiles * TT, B] int32 leaf slots, in plan-flattened
    order.  CUDA tensors launch `csrc/traverse.cu` (with `plan`, default
    `records.traverse_plan`); CPU tensors run `traverse_bucket_plain`."""
    global TRAVERSE_LAUNCHES
    if X.device.type == "cpu":
        return traverse_bucket_plain(X, words, kids, pal, catw, depth, mw)
    if X.device.type != "cuda":
        raise LightGBMError(f"no traverse kernel for {X.device}")
    _check_bucket(X, words, kids, pal, catw, depth, mw)
    for t in (X, words, kids, pal, catw):
        if t is not None and not t.is_contiguous():
            raise LightGBMError("traverse inputs must be contiguous")
    from . import _build
    lib = _build.load("traverse")
    ntiles, tt, ni = words.shape
    b, f = X.shape
    plan = plan or traverse_plan(b, f, tt, ntiles)
    out = torch.empty((ntiles * tt, b), dtype=torch.int32, device=X.device)
    rc = _build.on_stream(X.device, lambda stream: lib.lgbt_traverse(
        X.data_ptr(), b, f, words.data_ptr(), kids.data_ptr(),
        pal.data_ptr(), catw.data_ptr() if mw else None, ntiles, tt, ni,
        pal.shape[1], mw, depth, plan.rows, plan.threads, plan.smem,
        out.data_ptr(), ctypes.c_void_p(stream)))
    if rc != 0:
        raise LightGBMError(f"traverse kernel launch failed: CUDA error "
                            f"{rc}")
    TRAVERSE_LAUNCHES += 1
    return out


class DeviceRecords(NamedTuple):
    """`records.ForestRecords` as tensors on one device."""
    nodes: torch.Tensor            # [N, 4] int32
    meta: torch.Tensor             # [T, 4] int32
    catw: Optional[torch.Tensor]   # [N, MW] int32 or None
    mw: int
    ni_max: int

    @classmethod
    def of(cls, rec: ForestRecords, device) -> "DeviceRecords":
        def put(a):
            return None if a is None else torch.from_numpy(a).to(device)
        return cls(put(rec.nodes), put(rec.meta), put(rec.catw), rec.mw,
                   rec.ni_max)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.nodes, self.meta, self.catw)
                   if t is not None)


def _check_serve(X, rec, leaf_values, n_class, dtype):
    if X.dim() != 2 or X.dtype != torch.float32:
        raise LightGBMError("X must be [B, F] float32")
    if rec.nodes.dim() != 2 or rec.nodes.shape[1] != 4 \
            or rec.nodes.dtype != torch.int32:
        raise LightGBMError("record nodes must be [N, 4] int32")
    if rec.meta.dim() != 2 or rec.meta.shape[1] != 4 \
            or rec.meta.dtype != torch.int32:
        raise LightGBMError("record meta must be [T, 4] int32")
    if leaf_values.dim() != 2 or leaf_values.dtype != dtype \
            or leaf_values.shape[0] != rec.meta.shape[0]:
        raise LightGBMError(f"leaf_values must be [{rec.meta.shape[0]}, NL] "
                            f"{dtype}")
    if rec.mw:
        if rec.catw is None or rec.catw.dtype != torch.int32 \
                or tuple(rec.catw.shape) != (rec.nodes.shape[0], rec.mw):
            raise LightGBMError("record catw must be [N, mw] int32")
    elif rec.catw is not None:
        raise LightGBMError("record catw given with mw == 0")
    if n_class < 1:
        raise LightGBMError(f"n_class must be positive, got {n_class}")
    tensors = [X, rec.nodes, rec.meta, leaf_values] + (
        [rec.catw] if rec.mw else [])
    if any(t.device != X.device for t in tensors):
        raise LightGBMError("serve inputs lie on different devices")


def _serve_plain(X, rec, leaf_values, n_class, chunk, dtype):
    """The fused kernel's plain version in `dtype` (`serve_forest_plain`,
    `serve_forest_f32_plain`)."""
    _check_serve(X, rec, leaf_values, n_class, dtype)
    b = X.shape[0]
    t_trees, nl = leaf_values.shape
    dev = X.device
    chunk = t_trees if chunk is None else max(int(chunk), 1)
    w_all = rec.nodes[:, 0].contiguous()
    k_all = rec.nodes[:, 1].contiguous()
    thr_all = rec.nodes[:, 2].contiguous().view(torch.float32)
    meta = rec.meta.long()
    klass = rec.meta[:, 3].tolist()
    xt = X.t()
    shape = (b, n_class) if n_class > 1 else (b,)
    acc = torch.zeros(shape, dtype=dtype, device=dev)
    for t0 in range(0, t_trees, chunk):
        m = meta[t0:t0 + chunk]
        nd = torch.zeros((m.shape[0], b), dtype=torch.int64, device=dev)
        # the trees of one step bound walk together, that many steps
        for depth in torch.unique(m[:, 2]).tolist():
            sel = torch.nonzero(m[:, 2] == depth).flatten()
            first, ni = m[sel, :1], m[sel, 1:2]
            cur = nd[sel]
            for _ in range(depth):
                in_range = (cur >= 0) & (cur < ni)
                idx = first + torch.where(in_range, cur, 0)
                w = w_all[idx]
                nxt = _route(_features(xt, (w >> 16) & 0xFFF), w,
                             k_all[idx], thr_all[idx],
                             lambda widx: rec.catw[idx, widx], rec.mw)
                nxt = torch.where(in_range, nxt.long(), 0)
                cur = torch.where(cur >= 0, nxt, cur)
            nd[sel] = cur
        slots = (~torch.clamp(nd, max=-1)).clamp(0, nl - 1)
        vals = torch.gather(leaf_values[t0:t0 + chunk], 1, slots)
        for i in range(m.shape[0]):
            if n_class > 1:
                k = klass[t0 + i]
                acc[:, k] = acc[:, k] + vals[i]
            else:
                acc = acc + vals[i]
    return acc


def serve_forest_plain(X: torch.Tensor, rec: DeviceRecords,
                       leaf_values: torch.Tensor, n_class: int = 1,
                       chunk: Optional[int] = None) -> torch.Tensor:
    """Plain version of the fused kernel, over the same records: in
    chunks of `chunk` trees (default all), a depth loop over the chunk's
    [trees, B] cursors (each tree for its own NI and step bound, with
    the traverse's out-of-range rules), then the chunk's leaf values
    added tree by tree, in boosting order, into each row's class column,
    f64 from +0.0 (leaf slots clamp to the table).  [B] or [B, K]
    float64."""
    return _serve_plain(X, rec, leaf_values, n_class, chunk, torch.float64)


def serve_forest_f32_plain(X: torch.Tensor, rec: DeviceRecords,
                           leaf_values: torch.Tensor, n_class: int = 1,
                           chunk: Optional[int] = None) -> torch.Tensor:
    """Plain version of the fused kernel's f32 instance: the walk of
    `serve_forest_plain` over the same records, then the f32 leaf values
    [T, NL] added tree by tree, in boosting order, from +0.0, one f32
    add a tree into each row's class column (the JAX package's scan
    carry).  [B] or [B, K] float32."""
    return _serve_plain(X, rec, leaf_values, n_class, chunk, torch.float32)


def _launch_serve(symbol, X, rec, leaf_values, n_class, plan, dtype):
    """Launch `csrc/serve.cu`'s entry `symbol` (the instance in `dtype`)
    at `plan` (default `records.forest_plan` at the instance's value
    size): [B] or [B, K] of `dtype`."""
    if X.device.type != "cuda":
        raise LightGBMError(f"no serve kernel for {X.device}")
    _check_serve(X, rec, leaf_values, n_class, dtype)
    for t in (X, rec.nodes, rec.meta, rec.catw, leaf_values):
        if t is not None and not t.is_contiguous():
            raise LightGBMError("serve inputs must be contiguous")
    b, f = X.shape
    t_trees, nl = leaf_values.shape
    shape = (b, n_class) if n_class > 1 else (b,)
    out = torch.empty(shape, dtype=dtype, device=X.device)
    if b == 0:
        return out
    from . import _build
    entry = getattr(_build.load("serve"), symbol)
    plan = plan or forest_plan(b, f, t_trees, rec.ni_max, rec.mw, n_class,
                               value_bytes=leaf_values.element_size())
    rc = _build.on_stream(X.device, lambda stream: entry(
        X.data_ptr(), b, f, rec.nodes.data_ptr(), rec.meta.data_ptr(),
        rec.catw.data_ptr() if rec.mw else None, rec.mw,
        leaf_values.data_ptr(), nl, t_trees, n_class, plan.rows,
        plan.cluster, plan.trees, plan.threads, plan.ilp, int(plan.stage),
        int(plan.rows_smem), rec.ni_max, plan.smem, out.data_ptr(),
        ctypes.c_void_p(stream)))
    if rc != 0:
        raise LightGBMError(f"serve kernel launch failed: CUDA error {rc}")
    return out


def serve_forest(X: torch.Tensor, rec: DeviceRecords,
                 leaf_values: torch.Tensor, n_class: int = 1, *,
                 plan: Optional[ForestPlan] = None) -> torch.Tensor:
    """Raw scores of the rows X [B, F] f32 under the forest of `rec`:
    [B] or [B, K] float64, each the boosting-order exact sum of the
    rows' leaf values `leaf_values` [T, NL].  CUDA tensors launch
    `csrc/serve.cu` once (with `plan`, default `records.forest_plan`);
    CPU tensors run `serve_forest_plain`."""
    global SERVE_LAUNCHES
    if X.device.type == "cpu":
        return serve_forest_plain(X, rec, leaf_values, n_class)
    out = _launch_serve("lgbt_serve", X, rec, leaf_values, n_class, plan,
                        torch.float64)
    if out.shape[0]:
        SERVE_LAUNCHES += 1
    return out


def serve_forest_f32(X: torch.Tensor, rec: DeviceRecords,
                     leaf_values: torch.Tensor, n_class: int = 1, *,
                     plan: Optional[ForestPlan] = None) -> torch.Tensor:
    """`device_predict`'s raw f32 sums of the rows X [B, F] f32 under the
    forest of `rec`: [B] or [B, K] float32, each tree's f32 leaf value
    `leaf_values` [T, NL] added in boosting order from +0.0.  CUDA
    tensors launch `csrc/serve.cu lgbt_serve_f32` once (with `plan`,
    default `records.forest_plan(..., value_bytes=4)`); CPU tensors run
    `serve_forest_f32_plain`."""
    global SERVE_F32_LAUNCHES
    if X.device.type == "cpu":
        return serve_forest_f32_plain(X, rec, leaf_values, n_class)
    out = _launch_serve("lgbt_serve_f32", X, rec, leaf_values, n_class,
                        plan, torch.float32)
    if out.shape[0]:
        SERVE_F32_LAUNCHES += 1
    return out


Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
               Optional[torch.Tensor]]


def device_planes(plan, device) -> Tuple[Tuple[Planes, ...],
                                         Tuple[Tuple[int, int], ...]]:
    """A `CompiledPlan`'s packed planes on `device`: per bucket `(words,
    kids, pal, catw | None)`, and the matching `(depth, mw)`."""
    planes = tuple(tuple(None if a is None else torch.from_numpy(a).to(device)
                         for a in (p["words"], p["kids"], p["pal"],
                                   p.get("catw")))
                   for p in plan.planes)
    meta = tuple((p["depth"], p["catw"].shape[-1] if "catw" in p else 0)
                 for p in plan.planes)
    return planes, meta


def traverse_all(X: torch.Tensor, planes: Sequence[Planes],
                 meta: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Every bucket's `traverse_bucket` over X, the slots stacked in
    plan order: [plan rows, B] int32."""
    parts = [traverse_bucket(X, words, kids, pal, catw, depth, mw)
             for (words, kids, pal, catw), (depth, mw) in zip(planes, meta)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def compiled_predict(X: torch.Tensor, planes: Sequence[Planes],
                     gather_idx: torch.Tensor, leaf_values: torch.Tensor,
                     cls: Optional[torch.Tensor] = None, *,
                     meta: Sequence[Tuple[int, int]], n_class: int = 1,
                     convert: Optional[Callable] = None,
                     records: Optional[DeviceRecords] = None
                     ) -> torch.Tensor:
    """The compiled path's device program.  With `records` (the serving
    runtime's): `serve_forest`, one fused launch.  Without: every
    bucket's tiles traverse, then `accumulate_slots_exact` reads each
    tree's slots at its plan row `gather_idx[t]` and sums them in
    boosting order (the JAX package's program; the same bits).

    `planes` holds per-bucket `(words, kids, pal, catw | None)`, `meta`
    the matching `(depth, mw)`.  Returns the f64 raw sums ([B] or
    [B, K]) when `convert` is None; else `convert` applied to their
    round-to-nearest-even f32 downcast."""
    if records is not None:
        raw = serve_forest(X, records, leaf_values, n_class)
    else:
        raw = accumulate_slots_exact(traverse_all(X, planes, meta),
                                     gather_idx, leaf_values,
                                     n_class=n_class, cls=cls)
    if convert is None:
        return raw
    return convert(raw.to(torch.float32))


def compiled_predict_bounded(X: torch.Tensor, planes: Sequence[Planes],
                             gather_idx: torch.Tensor, qval: torch.Tensor,
                             tile_of_tree: torch.Tensor,
                             scales: torch.Tensor, *,
                             meta: Sequence[Tuple[int, int]],
                             n_class: int = 1,
                             convert: Optional[Callable] = None,
                             groups: Optional[BoundedGroups] = None
                             ) -> torch.Tensor:
    """The bounded twin of `compiled_predict`'s unfused program: every
    bucket's traverse (the standalone K6, one launch a bucket on the
    card), then `accumulate_slots_bounded` (one launch) over the plan's
    slots, tree t's at row `gather_idx[t]`: f32 scores within the
    published bound ([B] or [B, K]), or `convert` of them.  Routing is
    the compiled rung's, bitwise the stacked planes', so the bytes equal
    `ops.predict.predict_raw_ensemble_bounded`'s."""
    out = accumulate_slots_bounded(traverse_all(X, planes, meta), qval,
                                   tile_of_tree, scales, n_class,
                                   gather_idx=gather_idx, groups=groups)
    return out if convert is None else convert(out)

