"""Sums and prefix sums in a fixed, stated order: the order XLA's CPU
backend gives the reference.

The reference's root sums (`payload[:, c].sum()`, `ops/grow.py:796`) and
split-scan prefix sums (`jnp.cumsum`, `ops/split.py`) are f32 reductions
whose order XLA chooses.  On the CPU it rewrites them:

* a sum over N elements becomes a tree of sequential 32-element windows
  (the padding split evenly before and after), level by level, until at
  most 32 partial sums remain, which are added in order;
* a prefix sum over n elements (a reduce-window) becomes sequential
  prefixes within blocks of 16, plus the prefix of the block totals
  (itself computed the same way when there are more than 16 blocks);
* every sequential chain, of a sum or of a prefix, starts from the
  reduction's init value +0.0, ((0 + x0) + x1) + ..., so a leading -0.0
  reads as +0.0; a reduction over one element is left as it is.

`tree_sum` and `block_cumsum` add in exactly that order, with IEEE f32
adds, on any device, so given the same inputs the port's sums are the
reference's bits on the CPU (the tests hold them so at several lengths),
and the card computes the same bits as the CPU.  They run as a short
loop of elementwise torch ops; the wave grower's scan kernels K2 and K3
(`csrc/fused_split.cu`) add in `block_cumsum`'s order inside the
kernel.
"""
from __future__ import annotations

import torch

#: window of XLA's CPU tree reduction, and block of its prefix-sum rewrite
SUM_WINDOW = 32
SCAN_BLOCK = 16


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0] + 0.0                 # from the init value +0.0
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA's CPU tree-reduction order."""
    n = x.shape[-1]
    if n == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    if n == 1:
        return x[..., 0].clone()
    while n > SUM_WINDOW:
        nb = -(-n // SUM_WINDOW)
        pad = nb * SUM_WINDOW - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = _seq_sum(x.reshape(*x.shape[:-1], nb, SUM_WINDOW))
        n = nb
    return _seq_sum(x)


def _seq_prefix(x: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    out[..., 0] += 0.0                    # from the init value +0.0
    for k in range(1, x.shape[-1]):
        out[..., k] += out[..., k - 1]
    return out


def block_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in the order of XLA's CPU
    reduce-window rewrite (blocks of SCAN_BLOCK)."""
    n = x.shape[-1]
    if n == 1:
        return x.clone()
    if n <= SCAN_BLOCK:
        return _seq_prefix(x)
    nb = -(-n // SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * SCAN_BLOCK - n))
    inner = _seq_prefix(xp.reshape(*x.shape[:-1], nb, SCAN_BLOCK))
    incl = block_cumsum(inner[..., -1].contiguous())
    off = torch.nn.functional.pad(incl[..., :-1], (1, 0))
    return (inner + off[..., None]).reshape(*x.shape[:-1], -1)[..., :n]
