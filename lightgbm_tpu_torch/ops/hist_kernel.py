"""The multi-leaf histogram: the K1 kernel's wrapper and plain version.

The port's counterpart of `lightgbm_tpu/ops/pallas_hist.py`'s K1 entry
points (`pallas_histogram_multi`, `_rows`, launcher `_run_kernel_multi`,
kernel `_hist_kernel_multi`).  `histogram_multi(bins_fm, payload,
leaf_id, slots, max_bin)` returns [S, F, MB, 3] f32: cell (s, f, b, c)
sums `payload[:, c]` over the rows where `leaf_id == slots[s]` and
`bins_fm[f] == b`; a slot that matches no row gives zeros.

CUDA tensors launch the hand-written kernel `csrc/histogram.cu`; CPU
tensors run `histogram_multi_plain`, which is `ops/histogram.py
leaf_histogram` per slot and so bitwise equal to JAX's `segment_sum`.
There is no fallback from one to the other: a CUDA tensor launches the
kernel or raises.

The kernel's numbers: counts are exact (integer sums below 2^24); g and
h agree with the plain version per cell within `1e-4 * sum|x| + 1e-6`
(`sum|x|` over the cell's rows), the tolerance the reference gives its
own Pallas path (`pallas_hist.py` `probe`); two launches on the same
inputs give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.log import LightGBMError
from .histogram import leaf_histogram

#: histogram-kernel launches made by `histogram_multi`
HIST_LAUNCHES = 0

#: most slots one call takes (the reference's `MULTI_CHUNK`)
MULTI_CHUNK = 14

#: warps per block and shared memory a block can have: a block keeps one
#: [MB, 3] f32 histogram per warp plus a 32-row staging buffer per warp
_WARPS = 8
_SMEM_MAX = 227 * 1024
#: blocks that fill the card: 8 resident 256-thread blocks on each of
#: the H100's 132 SMs
_TARGET_BLOCKS = 8 * 132
_MIN_CHUNK_ROWS = 4096


def smem_bytes(max_bin: int) -> int:
    """Shared memory one block of the kernel needs at `max_bin` bins."""
    return (_WARPS * max_bin * 3 + _WARPS * 96) * 4


def chunking(n: int, f: int, s: int):
    """(rows per chunk, chunks) of a launch over `n` rows: about
    `_TARGET_BLOCKS` blocks of (feature, chunk, slot), chunks of a
    multiple of 256 rows and at least `_MIN_CHUNK_ROWS` rows."""
    want = -(-_TARGET_BLOCKS // max(f * s, 1))
    chunks = max(1, min(want, -(-n // _MIN_CHUNK_ROWS)))
    rows = -(-n // chunks)
    rows = -(-rows // 256) * 256
    return rows, -(-n // rows)


def _check(bins_fm, payload, leaf_id, slots, max_bin):
    if bins_fm.dim() != 2 or bins_fm.dtype not in (torch.uint8,
                                                   torch.uint16):
        raise LightGBMError("bins_fm must be [F, N] uint8 or uint16")
    f, n = bins_fm.shape
    if payload.shape != (n, 3) or payload.dtype != torch.float32:
        raise LightGBMError(f"payload must be [{n}, 3] float32")
    if leaf_id.shape != (n,) or leaf_id.dtype != torch.int32:
        raise LightGBMError(f"leaf_id must be [{n}] int32")
    if slots.dim() != 1 or slots.dtype != torch.int32:
        raise LightGBMError("slots must be [S] int32")
    if not 1 <= slots.shape[0] <= MULTI_CHUNK:
        raise LightGBMError(f"{slots.shape[0]} slots: a call takes 1 to "
                            f"{MULTI_CHUNK}")
    if max_bin < 1:
        raise LightGBMError(f"max_bin must be positive, got {max_bin}")
    if any(t.device != bins_fm.device for t in (payload, leaf_id, slots)):
        raise LightGBMError("histogram inputs lie on different devices")


def histogram_multi_plain(bins_fm: torch.Tensor, payload: torch.Tensor,
                          leaf_id: torch.Tensor, slots: torch.Tensor,
                          max_bin: int) -> torch.Tensor:
    """Plain version: `leaf_histogram` of each slot's rows, stacked to
    [S, F, MB, 3]."""
    _check(bins_fm, payload, leaf_id, slots, max_bin)
    return torch.stack([leaf_histogram(bins_fm, payload, leaf_id == s,
                                       max_bin)
                        for s in slots.tolist()])


def histogram_multi(bins_fm: torch.Tensor, payload: torch.Tensor,
                    leaf_id: torch.Tensor, slots: torch.Tensor,
                    max_bin: int) -> torch.Tensor:
    """[S, F, MB, 3] f32 histograms of the leaves `slots` [S] (1 to 14),
    over bins `bins_fm` [F, N] u8/u16, payload [N, 3] f32 and row leaf
    ids `leaf_id` [N] i32.  CUDA tensors launch `csrc/histogram.cu`;
    CPU tensors run `histogram_multi_plain`."""
    global HIST_LAUNCHES
    if bins_fm.device.type == "cpu":
        return histogram_multi_plain(bins_fm, payload, leaf_id, slots,
                                     max_bin)
    if bins_fm.device.type != "cuda":
        raise LightGBMError(f"no histogram kernel for {bins_fm.device}")
    _check(bins_fm, payload, leaf_id, slots, max_bin)
    for t in (bins_fm, payload, leaf_id, slots):
        if not t.is_contiguous():
            raise LightGBMError("histogram inputs must be contiguous")
    if smem_bytes(max_bin) > _SMEM_MAX:
        raise LightGBMError(f"max_bin {max_bin} needs "
                            f"{smem_bytes(max_bin)} B of shared memory a "
                            f"block; the kernel has {_SMEM_MAX}")
    f, n = bins_fm.shape
    s = slots.shape[0]
    out = torch.empty((s, f, max_bin, 3), dtype=torch.float32,
                      device=bins_fm.device)
    if n == 0 or f == 0:
        return out.zero_()
    rows, chunks = chunking(n, f, s)
    work = torch.empty((chunks, s, f, max_bin, 3), dtype=torch.float32,
                       device=bins_fm.device)
    from ..compiler import _build
    lib = _build.load("histogram")
    with torch.cuda.device(bins_fm.device):
        stream = torch.cuda.current_stream(bins_fm.device).cuda_stream
        rc = lib.lgbt_histogram(
            bins_fm.data_ptr(), bins_fm.element_size(), payload.data_ptr(),
            leaf_id.data_ptr(), slots.data_ptr(), n, f, s, max_bin, rows,
            chunks, work.data_ptr(), out.data_ptr(),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise LightGBMError(f"histogram kernel launch failed: CUDA error "
                            f"{rc}")
    HIST_LAUNCHES += 1
    return out
