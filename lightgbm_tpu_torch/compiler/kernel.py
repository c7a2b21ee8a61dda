"""Tiled forest traversal over the packed plan planes.

The port's counterpart of `lightgbm_tpu/compiler/kernel.py`.  One launch
per depth bucket routes every row through every tree of the bucket's
tiles and emits per-tree leaf slots; `compiled_predict` gathers them
back to boosting order inside the exact f64 accumulation
(`ops.predict.accumulate_slots_exact`), so the compiled path is
byte-identical to the JAX package's whenever routing matches.

`traverse_bucket` launches the hand-written CUDA kernel
(`csrc/traverse.cu`, which replaces the Pallas kernel
`lightgbm_tpu/compiler/kernel.py:_traverse_kernel`) for CUDA tensors,
and runs the plain PyTorch version `traverse_bucket_plain` for CPU
tensors.  There is no fallback from one to the other: a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..ops.predict import _ZERO_THRESHOLD, accumulate_slots_exact
from ..utils.log import LightGBMError

#: row-block height; bucket sizes are powers of two, padded above this
#: to a multiple of it, so the row block always divides the batch
ROW_BLOCK = 256

#: traverse-kernel launches made by `traverse_bucket`
TRAVERSE_LAUNCHES = 0

#: shared memory a launch gets without opting in, and the most a Hopper
#: block can have
SMEM_DEFAULT = 48 * 1024
SMEM_MAX = 227 * 1024


def row_smem_bytes(b: int, f: int) -> int:
    """Shared memory for one row block of a [b, f] f32 batch in the
    traverse kernel (row stride f | 1 words, so threads reading one
    feature hit different banks), or 0 past SMEM_MAX, where the kernel
    reads the rows from global memory (228 features and up).  Past
    SMEM_DEFAULT the launch opts in to more."""
    smem = min(b, ROW_BLOCK) * (f | 1) * 4
    return smem if smem <= SMEM_MAX else 0


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
    b, f = X.shape
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
        feat = (w >> 16) & 0xFFF
        default_left = ((w >> 28) & 1) != 0
        missing_type = (w >> 29) & 3
        if f:
            fval = torch.gather(xt, 0, torch.where(feat < f, feat, 0).long())
            fval = torch.where(feat < f, fval, zero)
        else:
            fval = torch.zeros((n_trees, b), dtype=torch.float32, device=dev)
        thr = torch.gather(pal_t, 1, torch.where(code < p, code, 0).long())
        thr = torch.where(code < p, thr, zero)
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
            cw = cat_all[tree_ix, idx, widx]
            bit = (cw >> (v % 32)) & 1
            go_left = torch.where(w < 0, ok & (bit == 1), go_left)
        nxt = torch.where(go_left, kd >> 16,
                          ((kd & 0xFFFF) ^ 0x8000) - 0x8000)
        nxt = torch.where(in_range, nxt, 0)
        nd = torch.where(nd >= 0, nxt, nd)
    return ~torch.clamp(nd, max=-1)


def traverse_bucket(X: torch.Tensor, words: torch.Tensor,
                    kids: torch.Tensor, pal: torch.Tensor,
                    catw: Optional[torch.Tensor], depth: int,
                    mw: int) -> torch.Tensor:
    """Route the rows X [B, F] f32 through every tree of one depth
    bucket's tiles: [tiles * TT, B] int32 leaf slots, in plan-flattened
    order.  CUDA tensors launch `csrc/traverse.cu`; CPU tensors run
    `traverse_bucket_plain`."""
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
    out = torch.empty((ntiles * tt, b), dtype=torch.int32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.lgbt_traverse(
            X.data_ptr(), b, f, words.data_ptr(), kids.data_ptr(),
            pal.data_ptr(), catw.data_ptr() if mw else None, ntiles, tt,
            ni, pal.shape[1], mw, depth, row_smem_bytes(b, f),
            out.data_ptr(), ctypes.c_void_p(stream))
    if rc != 0:
        raise LightGBMError(f"traverse kernel launch failed: CUDA error "
                            f"{rc}")
    TRAVERSE_LAUNCHES += 1
    return out


Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
               Optional[torch.Tensor]]


def compiled_predict(X: torch.Tensor, planes: Sequence[Planes],
                     gather_idx: torch.Tensor, leaf_values: torch.Tensor,
                     cls: Optional[torch.Tensor] = None, *,
                     meta: Sequence[Tuple[int, int]], n_class: int = 1,
                     convert: Optional[Callable] = None) -> torch.Tensor:
    """The compiled path's device program: every bucket's tiles
    traverse, then `accumulate_slots_exact` reads each tree's slots at
    its plan row `gather_idx[t]` and sums them in boosting order.

    `planes` holds per-bucket `(words, kids, pal, catw | None)`, `meta`
    the matching `(depth, mw)`.  Returns the f64 raw sums ([B] or
    [B, K]) when `convert` is None; else `convert` applied to their
    round-to-nearest-even f32 downcast."""
    parts = [traverse_bucket(X, words, kids, pal, catw, depth, mw)
             for (words, kids, pal, catw), (depth, mw) in zip(planes, meta)]
    slots = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    raw = accumulate_slots_exact(slots, gather_idx, leaf_values,
                                 n_class=n_class, cls=cls)
    if convert is None:
        return raw
    return convert(raw.to(torch.float32))
