"""The L1 family's leaf refit: each leaf's output becomes the (weighted)
alpha-percentile of its rows' residuals, on the training device.

The port's counterpart of `lightgbm_tpu/ops/renew.py` (ref:
regression_objective.hpp `RegressionL1loss::RenewTreeOutput`,
`RegressionQuantileloss::RenewTreeOutput` with `PercentileFun` and
`WeightedPercentileFun`).  One global sort by (leaf, residual) orders
every leaf's segment at once, and each leaf's percentile is a gather
at its segment's offsets; no host loop.

The reference's version is an XLA program; this one repeats its
arithmetic in torch ops, so the same inputs give its bits:

* `jnp.lexsort((residual, seg))` is two stable sorts, by residual then
  by leaf (XLA's sort reads -0.0 as +0.0 first, so the two tie, as in
  torch's);
* the weights' segment sums add in row order, one after another from
  +0.0 (`segment_sum`, on the host), and the prefix sums in XLA's CPU
  order (`ops/reduce.py block_cumsum`);
* `alpha * w_leaf + w_before` and `v_lo * (1 - frac) + v_hi * frac`
  are fused multiply-adds in XLA's CPU code, rounded once as here
  (`fma_rn`); the latter contracts the second product up to 16 leaf
  slots and the first one past that (found on jax 0.9.0 at 7 to 63
  slots, `tests/test_torch_objectives_breadth.py`).
"""
from __future__ import annotations

import numpy as np
import torch

from .reduce import block_cumsum
from .xla_math import fma_rn

#: the most leaf slots at which XLA's CPU code contracts the percentile
#: interpolation's second product (past it, the first)
_SMALL_L = 16


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """`jax.ops.segment_sum` on XLA's CPU: per segment, the values in row
    order, one f32 add after another from +0.0; segment ids past
    `num_segments` are dropped.  Summed on the host with `np.add.at`,
    which adds in that order (torch's `index_put_` adds duplicates from
    several threads on the CPU and a warp at a time on the card), the
    [num_segments] sums copied back to `values`' device."""
    v = values.detach().cpu().numpy()
    s = seg.detach().cpu().numpy()
    keep = s < num_segments
    out = np.zeros(num_segments, dtype=v.dtype)
    np.add.at(out, s[keep], v[keep])
    return torch.from_numpy(out).to(values.device)


def leaf_percentile(residual: torch.Tensor, weight: torch.Tensor,
                    in_bag: torch.Tensor, leaf_id: torch.Tensor,
                    num_leaves: int, alpha: float, weighted: bool):
    """Per-leaf (weighted) alpha-percentile of `residual` [N] f32 over the
    in-bag rows (`in_bag` [N] bool) of each of `num_leaves` leaf slots
    (`leaf_id` [N]).  Returns ([L] f32 values, [L] f32 in-bag counts);
    an empty leaf gets 0."""
    n = residual.shape[0]
    L = num_leaves
    seg = torch.where(in_bag, leaf_id.to(torch.int64),
                      torch.full_like(leaf_id, L, dtype=torch.int64))
    by_res = torch.argsort(residual, stable=True)
    order = by_res[torch.argsort(seg[by_res], stable=True)]
    r_s = residual[order]

    # counts are exact in f32 in any order: the card sums them itself
    cnt = torch.zeros(L, dtype=torch.float32, device=residual.device)\
        .index_put_((seg[seg < L],), in_bag[seg < L].to(torch.float32),
                    accumulate=True)
    start_i = (block_cumsum(cnt) - cnt).to(torch.int64)
    live = cnt > 0
    if not weighted:
        pos = alpha * torch.clamp(cnt - 1.0, min=0.0)
        lo = torch.floor(pos)
        hi = torch.minimum(lo + 1.0, torch.clamp(cnt - 1.0, min=0.0))
        frac = pos - lo
        v_lo = r_s[(start_i + lo.to(torch.int64)).clamp(0, n - 1)]
        v_hi = r_s[(start_i + hi.to(torch.int64)).clamp(0, n - 1)]
        if L <= _SMALL_L:
            val = fma_rn(v_hi, frac, v_lo * (1.0 - frac))
        else:
            val = fma_rn(v_lo, 1.0 - frac, v_hi * frac)
        return torch.where(live, val, torch.zeros_like(val)), cnt

    w_eff = torch.where(in_bag, weight, torch.zeros_like(weight))
    w_s = w_eff[order]
    half = block_cumsum(w_s) - 0.5 * w_s
    w_leaf = segment_sum(w_eff, seg, L)
    w_before = block_cumsum(w_leaf) - w_leaf
    target = fma_rn(w_leaf, alpha, w_before)
    idx = torch.searchsorted(half, target)
    end_i = start_i + torch.clamp(cnt.to(torch.int64), min=1) - 1
    idx = torch.minimum(torch.maximum(idx, start_i), end_i)
    val = r_s[idx.clamp(0, n - 1)]
    return torch.where(live, val, torch.zeros_like(val)), cnt


def renew_leaf_values(leaf_value: torch.Tensor, residual: torch.Tensor,
                      weight: torch.Tensor, sample_weight: torch.Tensor,
                      leaf_id: torch.Tensor, num_leaves: int, alpha: float,
                      weighted: bool) -> torch.Tensor:
    """The grower's leaf outputs `leaf_value` [L] with each leaf that
    has in-bag rows replaced by its residuals' percentile (before
    shrinkage); the percentile's weights are the row weights times the
    round's sample weights, in-bag means a sample weight above 0."""
    val, cnt = leaf_percentile(residual, weight * sample_weight,
                               sample_weight > 0, leaf_id, num_leaves,
                               alpha, weighted)
    return torch.where(cnt > 0, val, leaf_value)
