"""The per-round samplers and the gradient discretization.

The port's counterparts of `lightgbm_tpu/ops/fused.py` `:38
bagging_weights`, `:51 goss_weights`, `:78 quantize_gradients` and
`:127 feature_mask`, op for op, so that the same keys (and for GOSS and
the quantizer the same f32 gradients) give the reference's rows,
features and lattice bitwise.  Every draw goes through `ops/threefry.py`
on the gradients' (or the mask's) device: one launch of the threefry
kernel on the card, the plain version on the CPU.  The keys stay on the
host, so no draw costs the card a sync.

JAX compares and scales f32 arrays by Python floats as weak-typed f32
constants; here every such constant is rounded to f32 first (`_f32`),
and nothing divides a CUDA tensor by a Python number (torch multiplies
by its reciprocal there, which can differ from the IEEE division).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .reduce import tree_sum
from .threefry import fold_in, permutation, split, uniform


def _f32(v: float) -> float:
    """`v` rounded to the nearest f32, as a Python float (exact in f32)."""
    return float(np.float32(v))


def bagging_weights(it: int, key0: torch.Tensor, n: int, device, *,
                    bagging_fraction: float,
                    bagging_freq: int) -> torch.Tensor:
    """[N] f32 0/1 bagging mask of iteration `it` (ref: GBDT::Bagging,
    bagging.hpp): `uniform(fold_in(key0, 2 (it // freq)), (n,)) <
    f32(bagging_fraction)`; the bag renews every `bagging_freq`
    iterations."""
    bag_it = it // max(bagging_freq, 1)
    rand = uniform(fold_in(key0, bag_it * 2), (n,), device)
    return (rand < _f32(bagging_fraction)).to(torch.float32)


def goss_weights(it: int, key0: torch.Tensor, grad: torch.Tensor,
                 hess: torch.Tensor, *, top_rate: float, other_rate: float,
                 goss_start_iter: int) -> torch.Tensor:
    """[N] f32 GOSS weights (ref: src/boosting/goss.hpp `GOSS::Bagging`):
    the top `top_rate` rows by |g h| (summed over classes for [N, K]
    gradients, in XLA's CPU order) keep weight 1, ties with the cut
    included; the rest are drawn with probability b / (1 - a) from
    `uniform(fold_in(key0, 2 it), (n,))` and weighted (1 - a) / b.  All
    ones before `goss_start_iter`."""
    n = grad.shape[0]
    if it < goss_start_iter:
        return torch.ones(n, dtype=torch.float32, device=grad.device)
    score = torch.abs(grad * hess)
    if score.dim() == 2:
        score = tree_sum(score)
    a, b = top_rate, other_rate
    top_n = max(1, int(a * n))
    kth = torch.sort(score).values[n - top_n]
    top = score >= kth
    rand = uniform(fold_in(key0, it * 2), (n,), grad.device)
    rest = ~top & (rand < _f32(b / max(1.0 - a, 1e-12)))
    return top.to(torch.float32) \
        + rest.to(torch.float32) * _f32((1.0 - a) / b)


def feature_mask(it: int, k: int, key0: torch.Tensor,
                 base_allowed: torch.Tensor, *,
                 feature_fraction: float) -> torch.Tensor:
    """[F] bool column mask of tree k of iteration `it` (ref:
    col_sampler.hpp `ColSampler::ResetByTree`): the first max(1,
    int(feature_fraction F + 0.999999)) of `permutation(fold_in(fold_in(
    key0, 2 it + 1), k), F)`, and `base_allowed`; on `base_allowed`'s
    device."""
    if feature_fraction >= 1.0:
        return base_allowed
    f = base_allowed.shape[0]
    n_pick = max(1, int(feature_fraction * f + 0.999999))
    key = fold_in(fold_in(key0, it * 2 + 1), k)
    perm = permutation(key, f, base_allowed.device)
    chosen = torch.zeros(f, dtype=torch.bool, device=base_allowed.device)
    chosen[perm[:n_pick]] = True
    return base_allowed & chosen


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
