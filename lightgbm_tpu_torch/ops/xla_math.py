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


def fma_rn(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to f32, as a hardware fma rounds it (for
    f32 tensors or f32-exact Python floats `b`, `c`).  `_fma` rounds the
    f64 sum again, which can differ at an f32 midpoint: here the sum is
    rounded to odd first (TwoSum gives its error exactly), which keeps
    what the second rounding needs (`scripts/check_xla_exp_exhaustive.py
    fma_f32`)."""
    p = a.double() * (b.double() if torch.is_tensor(b) else b)
    c = c.double() if torch.is_tensor(c) else c
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    inexact = (e != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    away = (e > 0) == (s > 0)
    bits = torch.where(inexact, torch.where(away, bits + 1, bits - 1), bits)
    return bits.view(torch.float64).float()


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


#: the Cephes log polynomial XLA's CPU backend emits, and its constants
_LOG_POLY = tuple(_f32(p) for p in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = _f32(-2.12194440e-4)
_LOG_Q2 = _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)
#: the f32 constants `jnp.log2` and `jnp.exp2` scale by (1 / ln 2 and ln 2)
LOG2_E = _f32(1.44269502)
LN_2 = _f32(0.693147182)


def xla_log_f32(x: torch.Tensor) -> torch.Tensor:
    """`jnp.log` of f32 `x` as XLA's CPU computes it, bit for bit: the
    Cephes polynomial in fused multiply-adds (`_fma`).  The mantissa m
    in [0.5, 1) and the exponent e come from the bits of max(x, FLT_MIN);
    below sqrt(1/2) m doubles and e drops by one; with r = m - 1 the
    result is ((r - r^2 / 2) + fma(y, r^3, q1 e)) + q2 e.  0 gives -inf,
    +inf itself, negatives and NaN NaN.  Torch ops only, on any device
    (the tests hold it against `jax.jit(jnp.log)`)."""
    if x.dtype != torch.float32:
        raise TypeError(f"xla_log_f32 takes float32, got {x.dtype}")
    t = x.clamp(min=FLT_MIN)
    bits = t.view(torch.int32)
    e = ((bits >> 23) - 0x7f).to(torch.float32) + 1.0
    m = ((bits & ~0x7f800000) | 0x3f000000).view(torch.float32)
    small = m < _SQRTHF
    r = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.to(torch.float32)
    r2 = r * r
    r3 = r2 * r
    p = _LOG_POLY
    y = _fma(r, p[0], p[1])
    y1 = _fma(r, p[3], p[4])
    y2 = _fma(r, p[6], p[7])
    y = _fma(y, r, p[2])
    y1 = _fma(y1, r, p[5])
    y2 = _fma(y2, r, p[8])
    y = _fma(y, r3, y1)
    y = _fma(y, r3, y2)
    y = _fma(y, r3, e * _LOG_Q1)
    r = _fma(r2, -0.5, r)
    r = _fma(e, _LOG_Q2, r + y)
    r = torch.where((x >= 0) & (x < FLT_MIN),
                    torch.full_like(r, -float("inf")), r)
    r = torch.where(x == float("inf"), x, r)
    return torch.where((x < 0) | torch.isnan(x),
                       torch.full_like(r, float("nan")), r)


def xla_log2_f32(x: torch.Tensor) -> torch.Tensor:
    """`jnp.log2` on XLA's CPU: log(x) times the f32 1 / ln 2 (XLA
    rewrites the division by the constant log 2 into that product)."""
    return xla_log_f32(x) * LOG2_E


def xla_exp2_f32(x: torch.Tensor) -> torch.Tensor:
    """`jnp.exp2` on XLA's CPU: exp(x times the f32 ln 2)."""
    return xla_exp_f32(x * LN_2)


#: XLA's f32 tanh: the clamp and the rational polynomial in x^2
_TANH_MAX = _f32(7.99881172180175781)
_TANH_NUM = tuple(_f32(c) for c in (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03))
_TANH_DEN = tuple(_f32(c) for c in (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03))
#: XLA's f32 log1p below sqrt(2) - 1: Cephes' rational polynomial
_LOG1P_NUM = tuple(_f32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_f32(c) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    r = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        r = fma_rn(r, x, c)
    return r


def xla_tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """`jnp.tanh` of f32 `x` on XLA's CPU: x itself below 0.0004, else
    x p(x^2) / q(x^2) on x clamped to +-7.9988, Horner in fmas."""
    xc = x.clamp(-_TANH_MAX, _TANH_MAX)
    x2 = xc * xc
    r = (xc * _horner(_TANH_NUM, x2)) / _horner(_TANH_DEN, x2)
    return torch.where(x.abs() < 0.0004, x, r)


def xla_log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """`jnp.log1p` of f32 `x` on XLA's CPU: log(1 + x) from
    |x| = sqrt(2) - 1 up, below it x - x^2 / 2 + x^3 p(x) / q(x)."""
    x2 = x * x
    small = (x * x2) * (_horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x))
    small = x + (-0.5 * x2 + small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       xla_log_f32(x + 1.0))


def xla_expm1_f32(x: torch.Tensor) -> torch.Tensor:
    """`jnp.expm1` of f32 `x` on XLA's CPU: exp(x) - 1 above |x| = 0.5,
    tanh(x / 2) (exp(x) + 1) below it, x where x / 2 underflows."""
    e = xla_exp_f32(x)
    half = x * 0.5
    r = torch.where(x.abs() > 0.5, e - 1.0, xla_tanh_f32(half) * (e + 1.0))
    return torch.where(half == 0, x, r)


def xla_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """`jax.nn.softmax(x, axis=dim)` of f32 `x` on XLA's CPU: exp(x -
    max) over its sum, the sum in XLA's CPU reduce order."""
    e = xla_exp_f32(x - x.amax(dim=dim, keepdim=True))
    total = tree_sum(e.movedim(dim, -1)).unsqueeze(-1).movedim(-1, dim)
    return _flush(e / total)
