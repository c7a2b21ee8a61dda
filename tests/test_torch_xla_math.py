"""The port's XLA transcendentals (`ops/xla_math.py`) against XLA's CPU.

`xla_exp_f32`, `xla_sigmoid` and `xla_softmax` must give the bits of
`jax.jit(jnp.exp)`, `jax.nn.sigmoid` and `jax.nn.softmax` on the CPU
(two NaNs compare equal whatever their payloads): on 2^20 f32 bit
patterns drawn from a seed, which cover the whole f32 range, and on
dense grids of the edges (the overflow near 88.72, the flush of
subnormal results below -87.34, subnormal and tiny inputs, ±0, ±inf,
NaN, the largest finite values).  `scripts/check_xla_exp_exhaustive.py`
runs the same comparison of `exp` over all 2^32 inputs; its `fma_f32`
must be the correctly rounded fused multiply-add, including where an f64
multiply-add rounded twice is not.
"""
import importlib.util
import sys
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from lightgbm_tpu_torch.ops.xla_math import (xla_exp_f32,  # noqa: E402
                                             xla_sigmoid, xla_softmax)

_SPEC = importlib.util.spec_from_file_location(
    "check_xla_exp_exhaustive", ROOT / "scripts" /
    "check_xla_exp_exhaustive.py")
_SCRIPT = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(_SCRIPT)

_EXP = jax.jit(jnp.exp)
_SIGMOID = jax.jit(jax.nn.sigmoid)


def _assert_bitwise(got: torch.Tensor, want) -> None:
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    same = (got.view(np.uint32) == want.view(np.uint32)) | \
        (np.isnan(got) & np.isnan(want))
    bad = np.flatnonzero(~same)
    assert bad.size == 0, (f"{bad.size} differ, first at "
                           f"{got.ravel()[bad[:4]]} vs "
                           f"{want.ravel()[bad[:4]]}")


def _patterns(n=1 << 20, seed=0) -> np.ndarray:
    """`n` f32 values of uniformly drawn bit patterns: every exponent,
    both signs, subnormals, infinities and NaNs."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
        np.uint32).view(np.float32)


def _grid(lo, hi, n=200_000) -> np.ndarray:
    """Every f32 between lo and hi if there are at most n, else n of
    them spaced evenly in bit pattern (same-sign bounds)."""
    a = np.float32(lo).view(np.int32)
    b = np.float32(hi).view(np.int32)
    a, b = min(a, b), max(a, b)
    return np.unique(np.linspace(a, b, n).astype(np.int32)).view(np.float32)


SPECIALS = np.array(
    [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
     np.finfo(np.float32).max, -np.finfo(np.float32).max,
     np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny,
     1e-45, -1e-45, 1e-40, -1e-40, 88.72283, 88.722839, 88.72284,
     -87.33654, -87.336548, -87.33655, -103.972, -104.0],
    dtype=np.float32)
#: the whole-range draw, then the edges: overflow, flushed results,
#: subnormal and tiny inputs, the largest values, the common range
EXP_CASES = {
    "patterns": _patterns(),
    "specials": SPECIALS,
    "overflow": _grid(88.5, 89.0),
    "flush": _grid(-104.0, -87.0),
    "tiny": np.concatenate([_grid(1e-45, 1e-3), -_grid(1e-45, 1e-3)]),
    "huge": np.concatenate([_grid(1e30, 3.4e38, 20_000),
                            -_grid(1e30, 3.4e38, 20_000)]),
    "range": np.random.default_rng(1).uniform(-90, 90, 500_000).astype(
        np.float32),
}


@pytest.mark.parametrize("case", sorted(EXP_CASES))
def test_exp_bitwise_xla_cpu(case):
    x = EXP_CASES[case]
    _assert_bitwise(xla_exp_f32(torch.from_numpy(x)), _EXP(x))


@pytest.mark.parametrize("case", ["patterns", "specials", "range",
                                  "overflow", "flush"])
def test_sigmoid_bitwise_xla_cpu(case):
    x = EXP_CASES[case]
    if case in ("overflow", "flush"):          # both tails of 1/(1+e^-x)
        x = np.concatenate([x, -x])
    _assert_bitwise(xla_sigmoid(torch.from_numpy(x)), _SIGMOID(x))


@pytest.mark.parametrize("k,axis", [(2, 1), (3, 1), (5, 1), (16, 1),
                                    (33, 1), (40, 1), (3, 0), (7, 0)])
def test_softmax_bitwise_xla_cpu(k, axis):
    """Sums over k classes in XLA's CPU reduce order: sequential up to
    32, 32-element windows beyond (`ops/reduce.py tree_sum`)."""
    rng = np.random.default_rng(k)
    s = (rng.standard_normal((5000, k)) * 6).astype(np.float32)
    s[:3, 0] = [90.0, -90.0, 0.0]
    s[3, :] = -100.0
    if axis == 0:
        s = np.ascontiguousarray(s.T)
    want = jax.jit(lambda v: jax.nn.softmax(v, axis=axis))(s)
    _assert_bitwise(xla_softmax(torch.from_numpy(s), dim=axis), want)


def _fma_exact(a, b, c) -> np.float32:
    """a * b + c of f32 values, exactly, then rounded once to f32: the
    exact value is a Fraction, and f32 rounding of it is taken through
    the two f32 neighbours of its f64 rounding."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(v))
    lo, hi = sorted([near, np.nextafter(near, np.float32(
        np.inf if Fraction(float(near)) < v else -np.inf))])
    dlo, dhi = v - Fraction(float(lo)), Fraction(float(hi)) - v
    if dlo != dhi:
        return lo if dlo < dhi else hi
    return lo if int(lo.view(np.uint32)) % 2 == 0 else hi


def test_fma_f32_is_correctly_rounded():
    rng = np.random.default_rng(5)
    a = (rng.standard_normal(3000) * 10).astype(np.float32)
    b = (rng.standard_normal(3000) * 10).astype(np.float32)
    c = (rng.standard_normal(3000) * 100).astype(np.float32)
    # a double-rounding case: a * b + c lies just below an f32 tie, and
    # its f64 rounding lands on the tie (an f64 multiply-add rounded
    # twice gives 1 + 2^-22)
    a[0] = np.float32(2.0 ** -24 * (1 + 2.0 ** -18))
    b[0] = np.float32(1 - 2.0 ** -18)
    c[0] = np.float32(1 + 2.0 ** -23)
    got = _SCRIPT.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    assert got[0] == np.float32(1 + 2.0 ** -23)
    twice = np.float32(np.float64(a[0]) * np.float64(b[0])
                       + np.float64(c[0]))
    assert twice != got[0]
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_links_run_their_plain_versions_on_the_cpu_only():
    """CPU tensors take the plain torch ops (no kernel launch); a CUDA
    tensor launches `csrc/links.cu`; any other device, and any dtype but
    f32, raises."""
    from lightgbm_tpu_torch.ops import xla_math
    from lightgbm_tpu_torch.utils.log import LightGBMError
    x = torch.from_numpy(EXP_CASES["range"][:4096])
    before = xla_math.LINK_LAUNCHES
    _assert_bitwise(xla_exp_f32(x), xla_math.xla_exp_f32_plain(x).numpy())
    _assert_bitwise(xla_sigmoid(x), xla_math.xla_sigmoid_plain(x).numpy())
    assert xla_math.LINK_LAUNCHES == before
    with pytest.raises(TypeError, match="float32"):
        xla_exp_f32(x.double())
    with pytest.raises(LightGBMError, match="no link kernel"):
        xla_sigmoid(torch.zeros(3, device="meta"))


def _scale_by_exponent(z: np.ndarray, n: np.ndarray) -> np.ndarray:
    """`csrc/links.cu xla_exp`'s z * 2^n: integer arithmetic on z's
    exponent field E (flush below 2^-126 when E + n < 1, +inf when
    E + n > 254, else z's bits plus n << 23)."""
    zb = z.view(np.int32).astype(np.int64)
    e = (zb >> 23) + n
    out = (zb + n * (1 << 23)).astype(np.uint32).view(np.float32)
    out = np.where(e < 1, np.float32(0.0), out)
    return np.where(e > 254, np.float32(np.inf), out).astype(np.float32)


def _scale_f64(z: np.ndarray, n: np.ndarray) -> np.ndarray:
    """The plain version's z * 2^n: exact in f64, flushed below 2^-126,
    rounded to f32."""
    y = z.astype(np.float64) * np.ldexp(1.0, n)
    with np.errstate(over="ignore"):
        return np.where(y < 2.0 ** -126, np.float32(0.0),
                        y.astype(np.float32)).astype(np.float32)


@pytest.mark.parametrize("mantissa", [0, 1, 0x400000, 0x7FFFFF, "random"])
def test_link_kernel_scale_is_the_f64_scale(mantissa):
    """The link kernel applies 2^n by integer arithmetic on z's exponent
    field; for every z the polynomial can give (+inf or a positive normal
    f32) and every n in [-128, 127] that is the plain version's f64
    multiply, flush and rounding, bit for bit: here over every exponent
    field, each n, and the mantissas at the edges of a binade."""
    e_field, n = np.meshgrid(np.arange(1, 255), np.arange(-128, 128))
    e_field, n = e_field.ravel(), n.ravel()
    if mantissa == "random":
        m = np.random.default_rng(3).integers(0, 1 << 23, e_field.size)
    else:
        m = np.full(e_field.size, mantissa)
    z = ((e_field << 23) | m).astype(np.uint32).view(np.float32)
    # z = +inf comes only with n = 127 (x past the cap); any n >= 0 here
    z = np.concatenate([z, np.full(128, np.inf, np.float32)])
    n = np.concatenate([n, np.arange(0, 128)])
    got, want = _scale_by_exponent(z, n), _scale_f64(z, n)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got == 0).any() and np.isinf(got[:-128]).any()
