"""Batched tree routing and the exact f64 leaf-value sum.

The port's counterpart of `lightgbm_tpu/ops/predict.py`, for serving:

* `_leaf_slots` / `predict_leaf_ensemble` — the plain routing
  reference over the stacked [T, NI] planes (`Booster.export_predict_
  arrays`): every tree and every row step together, one depth level per
  iteration.  Decision semantics mirror tree.h `NumericalDecision` /
  `CategoricalDecision` in f32, as the JAX package's `_leaf_slots` does.
  The serving runtime's parity probe routes its probe batch with it.
* `accumulate_slots_exact` — the boosting-order f64 sum of pre-routed
  leaf slots.  The JAX package adds binary64 in software out of u32 ops
  (the TPU has no f64); here a CUDA kernel (`csrc/accumulate.cu`) adds
  native f64 in the same order, with the same round-to-nearest-even
  per step, so the bits agree.  On CPU tensors the wrapper runs the
  plain version, `accumulate_slots_exact_plain`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.log import LightGBMError

#: accumulate-kernel launches made by `accumulate_slots_exact`
ACCUMULATE_LAUNCHES = 0

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
    The loop ends when every cursor has reached a leaf."""
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
    for _ in range(ni + 1):
        active = nd >= 0
        if not bool(active.any()):
            break
        idx = torch.where(active, nd, 0)
        f = torch.gather(node_feat, 1, idx).long()
        fval = torch.gather(xt, 0, f)
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


def predict_leaf_ensemble(stacked: Dict, X: torch.Tensor) -> torch.Tensor:
    """[T, N] int32 leaf slots of every stacked tree for rows X."""
    return _leaf_slots(stacked["feat"], stacked["thr"], stacked["dtype"],
                       stacked["left"], stacked["right"], X,
                       cat_words=stacked.get("cat_words"),
                       cat_nwords=stacked.get("cat_nwords"))


def _check_accumulate(slots, gather_idx, leaf_values, n_class, cls):
    if slots.dim() != 2 or slots.dtype != torch.int32:
        raise LightGBMError("slots must be [R, B] int32")
    if gather_idx.dim() != 1 or gather_idx.dtype != torch.int32:
        raise LightGBMError("gather_idx must be [T] int32")
    if leaf_values.dim() != 2 or leaf_values.dtype != torch.float64:
        raise LightGBMError("leaf_values must be [T, NL] float64")
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
    _check_accumulate(slots, gather_idx, leaf_values, n_class, cls)
    r, b = slots.shape
    nl = leaf_values.shape[1]
    gidx = gather_idx.clamp(0, r - 1).tolist()
    cls_host = cls.tolist() if n_class > 1 else None
    shape = (b, n_class) if n_class > 1 else (b,)
    acc = torch.zeros(shape, dtype=torch.float64, device=slots.device)
    for t, g in enumerate(gidx):
        v = leaf_values[t][slots[g].long().clamp(0, nl - 1)]
        if n_class > 1:
            k = cls_host[t]
            acc[:, k] = acc[:, k] + v
        else:
            acc = acc + v
    return acc


def accumulate_slots_exact(slots: torch.Tensor, gather_idx: torch.Tensor,
                           leaf_values: torch.Tensor, n_class: int = 1,
                           cls: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Boosting-order f64 sum of pre-routed leaf slots: [B] or [B, K]
    float64.  CUDA tensors go through `csrc/accumulate.cu` (one thread
    per (row, class), the trees in order, `__dadd_rn`, built with
    `-fmad=false`); CPU tensors through the plain version."""
    global ACCUMULATE_LAUNCHES
    if slots.device.type == "cpu":
        return accumulate_slots_exact_plain(slots, gather_idx, leaf_values,
                                            n_class, cls)
    if slots.device.type != "cuda":
        raise LightGBMError(f"no accumulate kernel for {slots.device}")
    _check_accumulate(slots, gather_idx, leaf_values, n_class, cls)
    for t in (slots, gather_idx, leaf_values, cls):
        if t is not None and not t.is_contiguous():
            raise LightGBMError("accumulate inputs must be contiguous")
    from ..compiler import _build
    lib = _build.load("accumulate")
    r, b = slots.shape
    t_trees, nl = leaf_values.shape
    shape = (b, n_class) if n_class > 1 else (b,)
    out = torch.empty(shape, dtype=torch.float64, device=slots.device)
    with torch.cuda.device(slots.device):
        stream = torch.cuda.current_stream(slots.device).cuda_stream
        rc = lib.lgbt_accumulate(
            slots.data_ptr(), r, b, gather_idx.data_ptr(),
            leaf_values.data_ptr(), t_trees, nl,
            cls.data_ptr() if n_class > 1 else None, max(n_class, 1),
            out.data_ptr(), ctypes.c_void_p(stream))
    if rc != 0:
        raise LightGBMError(f"accumulate kernel launch failed: CUDA error "
                            f"{rc}")
    ACCUMULATE_LAUNCHES += 1
    return out
