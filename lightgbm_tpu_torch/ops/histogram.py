"""Leaf histograms, the plain version.

The port's counterpart of `lightgbm_tpu/ops/histogram.py:35
leaf_histogram`: per-(feature, bin) sums of the (g*w, h*w, w) payload
over the rows of one leaf.  The payload is masked first,
`where(mask, payload, 0.0)`, so rows outside the leaf add +0.0, and then
every row is `index_add_`ed in row order into its feature's bins.  On
the CPU that is the order of JAX's `segment_sum`, so the two agree
bitwise (the tests hold them so).  On a CUDA device `index_add_` adds
with atomics in no fixed order: there the plain version agrees with the
kernel (`ops/hist_kernel.py`) only within the kernel's tolerance.
"""
from __future__ import annotations

import torch


def leaf_histogram(bins_fm: torch.Tensor, payload: torch.Tensor,
                   row_mask: torch.Tensor, max_bin: int) -> torch.Tensor:
    """[F, MB, 3] f32 sums of `payload` [N, 3] over the rows where
    `row_mask` [N] is true, by the bins of `bins_fm` [F, N] (u8/u16)."""
    f, n = bins_fm.shape
    d = torch.where(row_mask[:, None], payload,
                    torch.zeros((), dtype=payload.dtype,
                                device=payload.device))
    offs = torch.arange(f, device=bins_fm.device, dtype=torch.int64)
    flat = (bins_fm.to(torch.int64) + offs[:, None] * max_bin).reshape(-1)
    out = torch.zeros((f * max_bin, 3), dtype=torch.float32,
                      device=payload.device)
    out.index_add_(0, flat, d.repeat(f, 1))
    return out.reshape(f, max_bin, 3)
