"""Gradient discretization for quantized training (`use_quantized_grad`).

The port's counterpart of `lightgbm_tpu/ops/fused.py:78
quantize_gradients` (ref: cuda_gradient_discretizer.cu), op for op, so
that the same f32 gradients and the same key give the same lattice
bitwise.
"""
from __future__ import annotations

from typing import Optional

import torch

from .threefry import split, uniform


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor, n_bins: int,
                       key: Optional[torch.Tensor] = None,
                       return_scales: bool = False,
                       const_hess_level: int = 0):
    """Gradients snapped to `n_bins` signed levels of scale s_g = max|g|
    / max(n_bins // 2, 1), hessians to `n_bins` unsigned levels of scale
    s_h = max|h| / n_bins; a zero scale becomes 1.  With a threefry `key`
    the rounding is stochastic, floor(v + u) with u from `split(key)[0]`
    for g and `split(key)[1]` for h (`ops/threefry.py`, on the gradients'
    device); without one it is `torch.round`, half to even as
    `jnp.round`.  `const_hess_level > 0` declares a constant unit
    hessian: it stays unquantized, with s_h = f32(1 / level).

    Returns (gq * s_g, hq * s_h), and with `return_scales` also the f32
    scales (s_g, s_h) as 0-d tensors on the gradients' device."""
    dev = grad.device

    def const(v):
        # a 0-d tensor on the device, not a Python number: CUDA divides by
        # a CPU scalar as a multiply by its reciprocal, which can differ
        # from the IEEE division the CPU (and the reference) computes
        return torch.full((), v, dtype=torch.float32, device=dev)

    half = max(n_bins // 2, 1)
    s_g = torch.max(torch.abs(grad)) / const(half)
    s_g = torch.where(s_g > 0, s_g, const(1.0))
    vg = grad / s_g
    keys = split(key) if key is not None else None
    if const_hess_level > 0:
        hq_s = hess
        s_h = const(1.0 / const_hess_level)
    else:
        s_h = torch.max(torch.abs(hess)) / const(max(n_bins, 1))
        s_h = torch.where(s_h > 0, s_h, const(1.0))
        vh = hess / s_h
        if keys is not None:
            hq_s = torch.floor(vh + uniform(keys[1], hess.shape, dev)) * s_h
        else:
            hq_s = torch.round(vh) * s_h
    if keys is not None:
        gq = torch.floor(vg + uniform(keys[0], grad.shape, dev))
    else:
        gq = torch.round(vg)
    if return_scales:
        return gq * s_g, hq_s, (s_g.to(torch.float32), s_h)
    return gq * s_g, hq_s
