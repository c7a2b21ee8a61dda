"""XLA's CPU f32 `exp`, sigmoid and softmax, bit for bit.

The reference computes its objectives' links with `jnp.exp`,
`jax.nn.sigmoid` and `jax.nn.softmax`.  On the CPU XLA lowers them to
its own code, whose f32 results differ from `torch.exp`,
`torch.sigmoid` and `torch.softmax` by about one ulp in a tenth of the
inputs; in training those ulps change the trees.  This module repeats
XLA's arithmetic step by step, as `ops/reduce.py` repeats its order of
adds, so that the same f32 inputs give the reference's bits on every
device.

`xla_exp_f32` is the Cephes polynomial that XLA's CPU backend emits,
with fused multiply-adds:

* n = floor(x * log2(e) + 0.5) in f32, at most 127;
* r = fma(n, -0.693359375, x), then r = fma(n, 2.12194440e-4, r);
* z = Horner over p0..p5 in fma, then z = fma(z, r * r, r) + 1;
* the result z * 2^n, flushed to +0 below the smallest normal f32 (XLA's
  CPU code runs with subnormals flushed), +inf above the largest.

In the plain version each fma is an f64 multiply-add rounded to f32
(`_fma`): the product of two f32 values is exact in f64, and the sum is
rounded twice, to f64 and then to f32.  Twice-rounded sums can differ
from the correctly rounded fma, but over every input of this polynomial
they do not: `scripts/check_xla_exp_exhaustive.py` runs `exp` with both
over all 2^32 f32 inputs, and both equal `jnp.exp` (jax 0.9.0).
`2^n` is built from its exponent bits, so the scaling is exact.
`xla_sigmoid` is the HLO of `jax.nn.sigmoid`, 1 / (1 + exp(-x)), and
`xla_softmax` that of `jax.nn.softmax`: the max, the difference, `exp`,
the sum over classes in XLA's CPU reduce order (`ops/reduce.py
tree_sum`), and an IEEE division; both flush subnormal results to +0 as
XLA's CPU does.

The plain versions (`xla_exp_f32_plain`, `xla_sigmoid_plain`) are torch
ops: every step an IEEE f32 or f64 add, multiply, divide, floor, compare
or bit operation, each its own op, so no step can be contracted, and any
device gives the CPU's bits.  Divisions divide by a tensor, never by a
Python number (torch multiplies a CUDA tensor by the reciprocal of a
Python divisor).  They take about 60 elementwise launches, so on a CUDA
tensor `xla_exp_f32` and `xla_sigmoid` launch the hand-written kernel
`csrc/links.cu` instead, which does the same arithmetic in registers
with hardware fused multiply-adds (correctly rounded); CPU tensors run
the plain versions.  A CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.log import LightGBMError
from .reduce import tree_sum

#: link-kernel launches made by `xla_exp_f32` and `xla_sigmoid`
LINK_LAUNCHES = 0


def _f32(v: float) -> float:
    """`v` rounded to the nearest f32, as a Python float (exact in f64)."""
    return float(np.float32(v))


#: XLA's constants, each the f32 nearest the decimal it is written as
_LOG2E = _f32(1.44269504088896341)
_LN2_HI = _f32(0.693359375)
_LN2_LO = _f32(2.12194440e-4)
_POLY = tuple(_f32(p) for p in (1.9875691500e-4, 1.3981999507e-3,
                                8.3334519073e-3, 4.1665795894e-2,
                                1.6666665459e-1, 5.0000001201e-1))
#: below this input every result is under the smallest normal f32 and
#: flushes to +0; clamping there keeps 2^n inside f64's exponent range
_X_MIN = -88.5
#: the largest n: XLA scales by at most 2^127 and lets z carry the rest
_N_MAX = 127.0
#: the smallest normal f32, 2^-126
FLT_MIN = 2.0 ** -126


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c for f32 tensors or f32-exact Python floats `b`, `c`:
    the product exact in f64, the sum rounded twice (to f64, then f32)."""
    p = a.double() * (b.double() if torch.is_tensor(b) else b)
    return (p + (c.double() if torch.is_tensor(c) else c)).float()


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """2^n in f64, exact, for integral f32 `n` in [-1022, 1023]."""
    return ((n.to(torch.int64) + 1023) << 52).view(torch.float64)


def _flush(y: torch.Tensor) -> torch.Tensor:
    """Non-negative `y` with values below the smallest normal f32 set to
    +0 (XLA's CPU flushes subnormal results)."""
    return torch.where(y < FLT_MIN, torch.zeros_like(y), y)


def xla_exp_f32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `xla_exp_f32`: torch ops, on any device."""
    return _exp(x, _fma)


def _exp(x: torch.Tensor, fma) -> torch.Tensor:
    """`xla_exp_f32` with `fma(a, b, c)` for its fused multiply-adds
    (`scripts/check_xla_exp_exhaustive.py` also runs it with a correctly
    rounded fma)."""
    if x.dtype != torch.float32:
        raise TypeError(f"xla_exp_f32 takes float32, got {x.dtype}")
    xc = x.clamp(min=_X_MIN)
    n = torch.floor(xc * _LOG2E + 0.5).clamp(max=_N_MAX)
    r = fma(n, -_LN2_HI, xc)
    r = fma(n, _LN2_LO, r)
    z = torch.full_like(r, _POLY[0])
    for p in _POLY[1:]:
        z = fma(z, r, p)
    z = fma(z, r * r, r) + 1.0
    y = _flush(z.double() * _pow2(n)).float()     # exact, or inf
    return torch.where(torch.isnan(x), x, y)


def xla_sigmoid_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `xla_sigmoid`: torch ops, on any device."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return _flush(one / (xla_exp_f32_plain(-x) + 1.0))


def _link(x: torch.Tensor, sigmoid: bool) -> torch.Tensor:
    """The plain version for a CPU tensor, else one launch of
    `csrc/links.cu`."""
    global LINK_LAUNCHES
    if x.dtype != torch.float32:
        raise TypeError(f"the XLA links take float32, got {x.dtype}")
    if x.device.type == "cpu":
        return xla_sigmoid_plain(x) if sigmoid else xla_exp_f32_plain(x)
    if x.device.type != "cuda":
        raise LightGBMError(f"no link kernel for {x.device}")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    from ..compiler import _build
    lib = _build.load("links")
    rc = _build.on_stream(x.device, lambda stream: lib.lgbt_xla_link(
        x.data_ptr(), x.numel(), int(sigmoid), y.data_ptr(),
        ctypes.c_void_p(stream)))
    if rc != 0:
        raise LightGBMError(f"link kernel launch failed: CUDA error {rc}")
    LINK_LAUNCHES += 1
    return y


def xla_exp_f32(x: torch.Tensor) -> torch.Tensor:
    """`jnp.exp` of f32 `x` as XLA's CPU computes it, bit for bit (NaN
    for NaN)."""
    return _link(x, False)


def xla_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid` of f32 `x` on XLA's CPU: 1 / (1 + exp(-x))."""
    return _link(x, True)


def xla_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """`jax.nn.softmax(x, axis=dim)` of f32 `x` on XLA's CPU: exp(x -
    max) over its sum, the sum in XLA's CPU reduce order."""
    e = xla_exp_f32(x - x.amax(dim=dim, keepdim=True))
    total = tree_sum(e.movedim(dim, -1)).unsqueeze(-1).movedim(-1, dim)
    return _flush(e / total)
