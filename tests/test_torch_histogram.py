"""The port's histograms and fixed-order sums against the JAX package's,
on the CPU.

`leaf_histogram` and `histogram_multi_plain` (the K1 kernel's plain
version) must equal JAX's `segment_sum` `leaf_histogram` bitwise, per
slot, with pad slots giving zeros; they must agree with the K1 Pallas
kernel in interpret mode within the tolerance the reference's own tests
give it (rtol = atol = 1e-5, `tests/test_pallas_hist.py`).  The sums of
`ops/reduce.py` must equal XLA's CPU `sum` and `cumsum` bitwise.  The
CUDA kernel itself is held to the plain version on the card by
chip_smoke.py.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu.ops.histogram import \
    leaf_histogram as jax_leaf_histogram  # noqa: E402
from lightgbm_tpu.ops.pallas_hist import pallas_histogram_multi  # noqa: E402
from lightgbm_tpu_torch.ops import hist_kernel  # noqa: E402
from lightgbm_tpu_torch.ops.hist_kernel import (  # noqa: E402
    histogram_multi, histogram_multi_plain)
from lightgbm_tpu_torch.ops.histogram import leaf_histogram  # noqa: E402
from lightgbm_tpu_torch.ops.reduce import block_cumsum, tree_sum  # noqa: E402


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32)


def _case(n, f, mb, seed, dtype=np.uint8, leaves=6):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, mb, (f, n)).astype(dtype)
    bins[0] = rng.choice([0, 1, mb - 1], n)          # crowded bins
    payload = (rng.randn(n, 3)
               * np.exp(rng.randn(n, 3) * 2)).astype(np.float32)
    payload[:, 2] = rng.rand(n).astype(np.float32)
    leaf_id = rng.randint(0, leaves, n).astype(np.int32)
    return bins, payload, leaf_id


@pytest.mark.parametrize("n,f,mb,dtype", [(20000, 6, 256, np.uint8),
                                          (20000, 3, 1024, np.uint16)])
def test_leaf_histogram_bitwise_equals_segment_sum(n, f, mb, dtype):
    bins, payload, leaf_id = _case(n, f, mb, seed=n + mb, dtype=dtype)
    mask = leaf_id < 4
    want = np.asarray(jax_leaf_histogram(jnp.asarray(bins),
                                         jnp.asarray(payload),
                                         jnp.asarray(mask), mb))
    got = leaf_histogram(torch.from_numpy(bins), torch.from_numpy(payload),
                         torch.from_numpy(mask), mb).numpy()
    assert got.shape == (f, mb, 3) and got.dtype == np.float32
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("slots", [[3], list(range(12)) + [6, 99]])
def test_multi_plain_bitwise_per_slot(slots):
    n, f, mb = 8000, 5, 64
    bins, payload, leaf_id = _case(n, f, mb, seed=len(slots), leaves=12)
    got = histogram_multi_plain(torch.from_numpy(bins),
                                torch.from_numpy(payload),
                                torch.from_numpy(leaf_id),
                                torch.tensor(slots, dtype=torch.int32),
                                mb).numpy()
    assert got.shape == (len(slots), f, mb, 3)
    for i, s in enumerate(slots):
        want = np.asarray(jax_leaf_histogram(
            jnp.asarray(bins), jnp.asarray(payload),
            jnp.asarray(leaf_id == s), mb))
        assert np.array_equal(_bits(got[i]), _bits(want)), f"slot {s}"
    if 99 in slots:
        assert not got[slots.index(99)].any()    # pad slot: zeros


def test_multi_agrees_with_the_pallas_kernel_in_interpret_mode():
    # payload drawn as in tests/test_pallas_hist.py, whose tolerance this
    # is: the Pallas kernel's 3-term bf16 split keeps ~27 bits of each
    # element, so its error scales with sum|x|, not with the sum
    n, f, mb = 4096, 4, 64
    bins, _, leaf_id = _case(n, f, mb, seed=21, leaves=6)
    payload = np.random.RandomState(22).randn(n, 3).astype(np.float32)
    slots = np.array([2, 0, 6, 4], np.int32)                 # 6 = pad
    want = np.asarray(pallas_histogram_multi(
        jnp.asarray(bins), jnp.asarray(payload), jnp.asarray(leaf_id),
        jnp.asarray(slots), mb, row_tile=2048, interpret=True))
    got = histogram_multi(torch.from_numpy(bins), torch.from_numpy(payload),
                          torch.from_numpy(leaf_id),
                          torch.from_numpy(slots), mb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[2].any()


def test_wrapper_refuses_bad_inputs():
    bins = torch.zeros((2, 10), dtype=torch.uint8)
    pay = torch.zeros((10, 3))
    lid = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(lt.LightGBMError, match="slots"):
        histogram_multi(bins, pay, lid, torch.zeros(15, dtype=torch.int32),
                        4)
    with pytest.raises(lt.LightGBMError, match="slots"):
        histogram_multi(bins, pay, lid, torch.zeros(0, dtype=torch.int32),
                        4)
    with pytest.raises(lt.LightGBMError, match="uint8 or uint16"):
        histogram_multi(bins.int(), pay, lid,
                        torch.zeros(1, dtype=torch.int32), 4)
    with pytest.raises(lt.LightGBMError, match="payload"):
        histogram_multi(bins, pay.double(), lid,
                        torch.zeros(1, dtype=torch.int32), 4)
    with pytest.raises(lt.LightGBMError, match="leaf_id"):
        histogram_multi(bins, pay, lid[:9],
                        torch.zeros(1, dtype=torch.int32), 4)


@pytest.mark.parametrize("n,f,s", [(1, 1, 1), (2_000_000, 28, 1),
                                   (20_000, 28, 14), (100_000, 28, 1),
                                   (4097, 3, 2)])
def test_launch_geometry_covers_every_row(n, f, s):
    rows, chunks = hist_kernel.chunking(n, f, s)
    assert rows % 256 == 0 and rows > 0
    assert rows * (chunks - 1) < n <= rows * chunks
    assert chunks <= 65535
    assert hist_kernel.smem_bytes(256) <= 48 * 1024
    assert hist_kernel.smem_bytes(1024) <= hist_kernel._SMEM_MAX


@pytest.mark.parametrize("n", [1, 7, 16, 17, 63, 64, 255, 256, 257, 1023,
                               1024, 4100])
def test_block_cumsum_is_xla_cpu_cumsum(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(5, n, 3) * np.exp(rng.randn(5, n, 3) * 2)) \
        .astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=1))
    got = block_cumsum(torch.from_numpy(x).transpose(1, 2)) \
        .transpose(1, 2).numpy()
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 1500, 2000, 20000,
                               100_003])
def test_tree_sum_is_xla_cpu_sum(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(n, 3) * np.exp(rng.randn(n, 3))).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.stack(
        [v[:, 0].sum(), v[:, 1].sum(), v[:, 2].sum()]))(jnp.asarray(x)))
    got = tree_sum(torch.from_numpy(x).t()).numpy()
    assert np.array_equal(_bits(got), _bits(want))
