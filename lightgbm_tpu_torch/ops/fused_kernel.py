"""The fused histogram + split scan (K2), its quantized twin (K5) and
the scan alone (K3): the wrappers and their plain versions.

The port's counterparts of `lightgbm_tpu/ops/pallas_hist.py`
`pallas_fused_hist_split_rows` (`:689`, launcher `_run_fused_multi`,
kernel `_fused_kernel_multi`), `pallas_fused_hist_split_quantized_rows`
(`:741`, launcher `_run_fused_multi_i8`, kernel `_fused_kernel_multi_i8`)
and `pallas_split_scan` (`:793`, kernel `_scan_only_kernel`).

`fused_hist_split(bins_fm, payload, leaf_id, slots, feat_nb,
feat_missing, parent, max_bin, **scan_kw)` returns `(hist, cand)`:
`hist` [S, F, MB, 3] f32 is `histogram_multi`'s histogram of the slots
(`ops/hist_kernel.py`), and `cand` [S, 2, F, 8] f32 the numerical split
candidates of each slot (`ops/split.py fused_numerical_candidates`, with
`parent` [S, 3] each slot's g, h, count sums), which
`decide_from_candidates` turns into `find_best_split`'s decisions.
`split_scan(hist, feat_nb, feat_missing, parent, **scan_kw)` returns the
candidates of given histograms.  `fused_hist_split_quantized(bins_fm,
pw3, leaf_id, slots, feat_nb, feat_missing, parent, max_bin, s_g, s_h,
**scan_kw)` is `fused_hist_split` over the int8 lattice
(`ops/hist_kernel_q.py`): its histogram is `histogram_multi_quantized`'s.
`scan_kw` are the gain's l1, l2, min_data_in_leaf, min_sum_hessian and
min_gain_to_split.

CUDA tensors launch the hand-written kernels of `csrc/fused_split.cu`;
CPU tensors run the plain versions.  Nothing is swapped in quietly: a
CUDA tensor launches the kernel or raises.  The kernels' numbers: K2's
histogram is the K1 kernel's, bit for bit (the two share their first
stage), K5's is the K4 kernel's, bit for bit (again one shared first
stage, and the same dequantize), and the candidates of all three kernels
equal the plain scan run on the card over the same histogram, bit for
bit.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.log import LightGBMError
from .hist_kernel import (MULTI_CHUNK, _check, first_stage_scratch,
                          histogram_multi_plain, launch_plan, ticket)
from .hist_kernel_q import (MULTI_CHUNK_Q, _check_q, _scales,
                            histogram_multi_quantized_plain, launch_plan_q,
                            q_first_stage_scratch)
from .split import FUSED_CAND_COLS, FUSED_CASES, fused_numerical_candidates

#: K2 launches made by `fused_hist_split` (one per chunk of slots)
FUSED_LAUNCHES = 0
#: K5 launches made by `fused_hist_split_quantized` (one per chunk)
FUSED_Q_LAUNCHES = 0
#: K3 launches made by `split_scan`
SCAN_LAUNCHES = 0

_SCAN_KEYS = ("l1", "l2", "min_data_in_leaf", "min_sum_hessian",
              "min_gain_to_split")


def _scan_args(scan_kw):
    if set(scan_kw) != set(_SCAN_KEYS):
        raise LightGBMError(f"the split scan takes exactly {_SCAN_KEYS}, "
                            f"got {sorted(scan_kw)}")
    return [ctypes.c_float(float(scan_kw[k])) for k in _SCAN_KEYS]


def _check_scan(s, f, feat_nb, feat_missing, parent, device):
    """The scan's metadata for S slots of F features on `device`."""
    for name, t in (("feat_nb", feat_nb), ("feat_missing", feat_missing)):
        if t.shape != (f,) or t.dtype != torch.int32:
            raise LightGBMError(f"{name} must be [{f}] int32")
    if parent.shape != (s, 3) or parent.dtype != torch.float32:
        raise LightGBMError(f"parent must be [{s}, 3] float32")
    if any(t.device != device for t in (feat_nb, feat_missing, parent)):
        raise LightGBMError("split scan inputs lie on different devices")


def _check_hist(hist):
    if hist.dim() != 4 or hist.shape[-1] != 3 or \
            hist.dtype != torch.float32 or 0 in hist.shape:
        raise LightGBMError("hist must be [S, F, MB, 3] float32, S, F and "
                            "MB >= 1")


def split_scan_plain(hist: torch.Tensor, feat_nb: torch.Tensor,
                     feat_missing: torch.Tensor, parent: torch.Tensor,
                     **scan_kw) -> torch.Tensor:
    """Plain version of K3: `fused_numerical_candidates` of each slot's
    histogram, [S, F, MB, 3] -> [S, 2, F, 8]."""
    _check_hist(hist)
    _check_scan(hist.shape[0], hist.shape[1], feat_nb, feat_missing, parent,
                hist.device)
    cand = fused_numerical_candidates(hist.transpose(0, 1), feat_nb,
                                      feat_missing, parent, **scan_kw)
    return cand.permute(1, 2, 0, 3).contiguous()


def fused_hist_split_plain(bins_fm, payload, leaf_id, slots, feat_nb,
                           feat_missing, parent, max_bin, **scan_kw):
    """Plain version of K2 for 1 to 14 slots: `histogram_multi_plain`,
    then the plain scan."""
    hist = histogram_multi_plain(bins_fm, payload, leaf_id, slots, max_bin)
    return hist, split_scan_plain(hist, feat_nb, feat_missing, parent,
                                  **scan_kw)


def _launch_fused(bins_fm, payload, leaf_id, slots, feat_nb, feat_missing,
                  parent, max_bin, scan_args):
    """One K2 launch over 1 to 14 slots."""
    global FUSED_LAUNCHES
    _check(bins_fm, payload, leaf_id, slots, max_bin)
    f, n = bins_fm.shape
    s = slots.shape[0]
    dev = bins_fm.device
    _check_scan(s, f, feat_nb, feat_missing, parent, dev)
    for t in (bins_fm, payload, leaf_id, slots, feat_nb, feat_missing,
              parent):
        if not t.is_contiguous():
            raise LightGBMError("fused split inputs must be contiguous")
    if n == 0 or f == 0:
        raise LightGBMError("the fused split kernel needs rows and features")
    plan = launch_plan(n, f, s, max_bin)
    hist = torch.empty((s, f, max_bin, 3), dtype=torch.float32, device=dev)
    cand = torch.empty((s, FUSED_CASES, f, FUSED_CAND_COLS),
                       dtype=torch.float32, device=dev)
    scratch, rowbuf, work = first_stage_scratch(n, s, f, max_bin,
                                                plan.chunks, dev)
    from ..compiler import _build
    lib = _build.load("fused_split")
    rc = _build.on_stream(dev, lambda stream: lib.lgbt_fused_hist_split(
        bins_fm.data_ptr(), bins_fm.element_size(), payload.data_ptr(),
        leaf_id.data_ptr(), slots.data_ptr(), n, f, s, max_bin,
        plan.feature_group, plan.chunks, rowbuf, ticket(dev, stream), work,
        feat_nb.data_ptr(), feat_missing.data_ptr(), parent.data_ptr(),
        *scan_args, hist.data_ptr(), cand.data_ptr(),
        ctypes.c_void_p(stream)))
    if rc != 0:
        raise LightGBMError(f"fused histogram+split kernel launch failed: "
                            f"CUDA error {rc}")
    FUSED_LAUNCHES += 1
    return hist, cand


def fused_hist_split(bins_fm: torch.Tensor, payload: torch.Tensor,
                     leaf_id: torch.Tensor, slots: torch.Tensor,
                     feat_nb: torch.Tensor, feat_missing: torch.Tensor,
                     parent: torch.Tensor, max_bin: int, **scan_kw):
    """(hist [S, F, MB, 3], cand [S, 2, F, 8]) of the leaves `slots` [S]
    i32 over bins_fm [F, N] u8/u16, payload [N, 3] f32 and row leaf ids
    [N] i32, with `parent` [S, 3] f32 the slots' g, h, count sums.  The
    slots go in chunks of MULTI_CHUNK = 14: on a CUDA device one launch
    of `csrc/fused_split.cu` each, on the CPU `fused_hist_split_plain`."""
    cpu = bins_fm.device.type == "cpu"
    if not cpu and bins_fm.device.type != "cuda":
        raise LightGBMError(f"no fused split kernel for {bins_fm.device}")
    if slots.dim() != 1 or slots.shape[0] == 0:
        raise LightGBMError("slots must be [S] int32 with S >= 1")
    if parent.dim() != 2 or parent.shape[0] != slots.shape[0]:
        raise LightGBMError(f"parent must be [{slots.shape[0]}, 3] float32")
    scan_args = _scan_args(scan_kw)
    outs = []
    for c0 in range(0, slots.shape[0], MULTI_CHUNK):
        sl = slots[c0:c0 + MULTI_CHUNK]
        par = parent[c0:c0 + MULTI_CHUNK]
        if cpu:
            outs.append(fused_hist_split_plain(
                bins_fm, payload, leaf_id, sl, feat_nb, feat_missing, par,
                max_bin, **scan_kw))
        else:
            outs.append(_launch_fused(bins_fm, payload, leaf_id, sl,
                                      feat_nb, feat_missing, par, max_bin,
                                      scan_args))
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([h for h, _ in outs]), torch.cat([c for _, c in outs]))


def fused_hist_split_quantized_plain(bins_fm, pw3, leaf_id, slots, feat_nb,
                                     feat_missing, parent, max_bin, s_g,
                                     s_h, **scan_kw):
    """Plain version of K5: `histogram_multi_quantized_plain`, then the
    plain scan."""
    hist = histogram_multi_quantized_plain(bins_fm, pw3, leaf_id, slots,
                                           max_bin, s_g, s_h)
    return hist, split_scan_plain(hist, feat_nb, feat_missing, parent,
                                  **scan_kw)


def _launch_fused_q(bins_fm, pw3, leaf_id, slots, feat_nb, feat_missing,
                    parent, max_bin, scales, scan_args):
    """One K5 launch over 1 to 42 slots."""
    global FUSED_Q_LAUNCHES
    _check_q(bins_fm, pw3, leaf_id, slots, max_bin)
    f, n = bins_fm.shape
    s = slots.shape[0]
    dev = bins_fm.device
    _check_scan(s, f, feat_nb, feat_missing, parent, dev)
    for t in (bins_fm, pw3, leaf_id, slots, feat_nb, feat_missing, parent):
        if not t.is_contiguous():
            raise LightGBMError("fused split inputs must be contiguous")
    if n == 0 or f == 0:
        raise LightGBMError("the fused split kernel needs rows and features")
    plan = launch_plan_q(n, f, s, max_bin)
    hist = torch.empty((s, f, max_bin, 3), dtype=torch.float32, device=dev)
    cand = torch.empty((s, FUSED_CASES, f, FUSED_CAND_COLS),
                       dtype=torch.float32, device=dev)
    scratch, rowbuf, work = q_first_stage_scratch(n, s, f, max_bin,
                                                  plan.chunks, dev)
    from ..compiler import _build
    lib = _build.load("fused_split")
    rc = _build.on_stream(dev, lambda stream: lib.lgbt_fused_hist_split_q(
        bins_fm.data_ptr(), bins_fm.element_size(), pw3.data_ptr(),
        leaf_id.data_ptr(), slots.data_ptr(), n, f, s, max_bin,
        plan.feature_group, plan.chunks, rowbuf, ticket(dev, stream), work,
        scales.data_ptr(), feat_nb.data_ptr(), feat_missing.data_ptr(),
        parent.data_ptr(), *scan_args, hist.data_ptr(), cand.data_ptr(),
        ctypes.c_void_p(stream)))
    if rc != 0:
        raise LightGBMError(f"quantized fused histogram+split kernel launch "
                            f"failed: CUDA error {rc}")
    FUSED_Q_LAUNCHES += 1
    return hist, cand


def fused_hist_split_quantized(bins_fm: torch.Tensor, pw3: torch.Tensor,
                               leaf_id: torch.Tensor, slots: torch.Tensor,
                               feat_nb: torch.Tensor,
                               feat_missing: torch.Tensor,
                               parent: torch.Tensor, max_bin: int, s_g, s_h,
                               **scan_kw):
    """(hist [S, F, MB, 3], cand [S, 2, F, 8]) of the leaves `slots` [S]
    i32 over bins_fm [F, N] u8/u16, the lattice pw3 [3, N] int8 and row
    leaf ids [N] i32, scaled by s_g and s_h, with `parent` [S, 3] f32 the
    slots' g, h, count sums.  The slots go in chunks of MULTI_CHUNK_Q =
    42: on a CUDA device one launch of `csrc/fused_split.cu`'s K5 each, on
    the CPU `fused_hist_split_quantized_plain`."""
    cpu = bins_fm.device.type == "cpu"
    if not cpu and bins_fm.device.type != "cuda":
        raise LightGBMError(f"no fused split kernel for {bins_fm.device}")
    if slots.dim() != 1 or slots.shape[0] == 0:
        raise LightGBMError("slots must be [S] int32 with S >= 1")
    if parent.dim() != 2 or parent.shape[0] != slots.shape[0]:
        raise LightGBMError(f"parent must be [{slots.shape[0]}, 3] float32")
    scan_args = _scan_args(scan_kw)
    scales = None if cpu else _scales(s_g, s_h, bins_fm.device)
    outs = []
    for c0 in range(0, slots.shape[0], MULTI_CHUNK_Q):
        sl = slots[c0:c0 + MULTI_CHUNK_Q]
        par = parent[c0:c0 + MULTI_CHUNK_Q]
        if cpu:
            outs.append(fused_hist_split_quantized_plain(
                bins_fm, pw3, leaf_id, sl, feat_nb, feat_missing, par,
                max_bin, s_g, s_h, **scan_kw))
        else:
            outs.append(_launch_fused_q(bins_fm, pw3, leaf_id, sl, feat_nb,
                                        feat_missing, par, max_bin, scales,
                                        scan_args))
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([h for h, _ in outs]), torch.cat([c for _, c in outs]))


def split_scan(hist: torch.Tensor, feat_nb: torch.Tensor,
               feat_missing: torch.Tensor, parent: torch.Tensor,
               **scan_kw) -> torch.Tensor:
    """[S, 2, F, 8] f32 candidates of the histograms `hist` [S, F, MB, 3]
    f32 with `parent` [S, 3] f32 (the slots' g, h, count sums).  CUDA
    tensors launch `csrc/fused_split.cu`; CPU tensors run
    `split_scan_plain`."""
    global SCAN_LAUNCHES
    scan_args = _scan_args(scan_kw)
    if hist.device.type == "cpu":
        return split_scan_plain(hist, feat_nb, feat_missing, parent,
                                **scan_kw)
    if hist.device.type != "cuda":
        raise LightGBMError(f"no split scan kernel for {hist.device}")
    _check_hist(hist)
    s, f, mb, _ = hist.shape
    _check_scan(s, f, feat_nb, feat_missing, parent, hist.device)
    for t in (hist, feat_nb, feat_missing, parent):
        if not t.is_contiguous():
            raise LightGBMError("split scan inputs must be contiguous")
    cand = torch.empty((s, FUSED_CASES, f, FUSED_CAND_COLS),
                       dtype=torch.float32, device=hist.device)
    from ..compiler import _build
    lib = _build.load("fused_split")
    with torch.cuda.device(hist.device):
        stream = torch.cuda.current_stream(hist.device).cuda_stream
        rc = lib.lgbt_split_scan(
            hist.data_ptr(), f, s, mb, feat_nb.data_ptr(),
            feat_missing.data_ptr(), parent.data_ptr(), *scan_args,
            cand.data_ptr(), ctypes.c_void_p(stream))
    if rc != 0:
        raise LightGBMError(f"split scan kernel launch failed: CUDA error "
                            f"{rc}")
    SCAN_LAUNCHES += 1
    return cand
