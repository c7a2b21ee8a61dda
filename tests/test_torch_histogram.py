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
                                   (4097, 3, 2), (2_000_000, 28, 7),
                                   (2_000_000, 28, 14), (33, 300, 3)])
def test_launch_geometry_covers_every_row(n, f, s):
    # the planner's launch (`csrc/hist_common.cuh`): every listed row of a
    # slot in exactly one chunk's piece, every (slot, feature) in exactly
    # one block of the grid (s * groups, chunks), grid and workspace as
    # the plan states
    for mb in (2, 255, 1023):
        plan = hist_kernel.launch_plan(n, f, s, mb)
        assert 1 <= plan.feature_group <= min(f, hist_kernel._WARPS)
        assert plan.groups == -(-f // plan.feature_group)
        assert s * plan.groups <= 2 ** 31 - 1 and plan.chunks <= 65535
        assert 1 <= plan.chunks <= max(1, n)
        for length in (0, 1, 31, 256, 1024, n):
            bounds = hist_kernel.piece_bounds(length, plan.chunks)
            assert bounds[0] == 0 and bounds[-1] == length
            assert 1 <= bounds.size - 1 <= plan.chunks
            assert np.all(np.diff(bounds) >= min(length, 256))
        owners = np.zeros((s, f), np.int64)
        for x in range(s * plan.groups):
            f0 = (x % plan.groups) * plan.feature_group
            owners[x // plan.groups, f0:f0 + plan.feature_group] += 1
        assert np.all(owners == 1)
        scratch, rowbuf, work = hist_kernel.first_stage_scratch(
            n, s, f, mb, plan.chunks, torch.device("cpu"))
        assert scratch.numel() == (hist_kernel.row_scratch_ints(n, s)
                                   + plan.chunks * s * f * mb * 3)
        assert work - rowbuf == 4 * hist_kernel.row_scratch_ints(n, s)


@pytest.mark.parametrize("mb", [2, 16, 255, 256, 1023, 2389])
@pytest.mark.parametrize("s", [1, 8, 14])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_launch_plan_fits_the_block(mb, s, dtype):
    # every max_bin the per-warp kernel before this stage took (up to
    # 2389) still launches, its block within the 227 KB (232,448 B) an
    # H100 block can have
    n, f = 2_000_000, 28
    plan = hist_kernel.launch_plan(n, f, s, mb)
    assert plan.smem == hist_kernel.smem_bytes(plan.feature_group, mb)
    assert plan.smem <= 232_448
    assert hist_kernel.blocks_per_sm(plan.smem) >= 1
    bins = torch.zeros((f, 64), dtype={np.uint8: torch.uint8,
                                       np.uint16: torch.uint16}[dtype])
    got = histogram_multi(bins, torch.ones((64, 3)),
                          torch.zeros(64, dtype=torch.int32),
                          torch.arange(s, dtype=torch.int32), mb)
    assert got.shape == (s, f, mb, 3)


def test_planner_refuses_past_the_largest_max_bin_naming_the_limit():
    limit = hist_kernel.max_bin_limit()
    assert limit >= 2389
    hist_kernel.launch_plan(1000, 28, 14, limit)
    with pytest.raises(lt.LightGBMError, match=f"max_bin up to {limit}"):
        hist_kernel.launch_plan(1000, 28, 1, limit + 1)


def _ordered_by_hand(bins, payload, leaf_id, slots, mb):
    """The order `csrc/hist_common.cuh` documents, one add at a time in
    Python f32: each slot's rows cut into pieces, each piece into batches
    of 32 from its first row, a batch's rows of one bin summed in row
    order from +0.0 and added to the piece's cell, the pieces summed in
    index order."""
    f, n = bins.shape
    chunks = hist_kernel.launch_plan(n, f, len(slots), mb).chunks
    out = np.zeros((len(slots), f, mb, 3), np.float32)
    for i, slot in enumerate(slots):
        rows = np.flatnonzero(leaf_id == slot)
        bounds = hist_kernel.piece_bounds(rows.size, chunks)
        for fi in range(f):
            parts = []
            for c in range(bounds.size - 1):
                piece = rows[bounds[c]:bounds[c + 1]]
                cell = np.zeros((mb, 3), np.float32)
                for b0 in range(0, piece.size, 32):
                    batch = piece[b0:b0 + 32]
                    for b in sorted(set(bins[fi, batch].tolist())):
                        if b >= mb:
                            continue
                        acc = np.zeros(3, np.float32)
                        for r in batch[bins[fi, batch] == b]:
                            acc = acc + payload[r]
                        cell[b] = cell[b] + acc
                parts.append(cell)
            total = parts[0]
            for cell in parts[1:]:
                total = total + cell
            out[i, fi] = total
    return out


def test_ordered_model_follows_the_documented_order():
    rng = np.random.RandomState(5)
    n, f, mb = 12000, 2, 8
    bins = rng.randint(0, mb + 2, (f, n)).astype(np.uint8)   # some >= mb
    payload = (rng.randn(n, 3) * np.exp(rng.randn(n, 3) * 3)) \
        .astype(np.float32)
    leaf_id = rng.randint(0, 4, n).astype(np.int32)
    slots = [2, 0, 2, 9]                     # a repeat and an empty slot
    chunks = hist_kernel.launch_plan(n, f, len(slots), mb).chunks
    assert hist_kernel.piece_bounds(n // 4, chunks).size > 2  # 2+ pieces
    want = _ordered_by_hand(bins, payload, leaf_id, slots, mb)
    got = hist_kernel.histogram_multi_ordered(
        torch.from_numpy(bins), torch.from_numpy(payload),
        torch.from_numpy(leaf_id), torch.tensor(slots, dtype=torch.int32),
        mb).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    assert not got[3].any()


@pytest.mark.parametrize("seed,n,f,mb,dtype,slots", [
    (0, 20_000, 6, 256, np.uint8, [3]),
    (1, 50_000, 5, 64, np.uint8, list(range(12)) + [6, 99]),
    (2, 30_000, 3, 1024, np.uint16, [0, 1, 2, 3]),
    (3, 200_000, 4, 255, np.uint8, [0]),
    (4, 40_000, 3, 2389, np.uint16, [5, 7])])
def test_ordered_model_within_the_contract_of_plain(seed, n, f, mb, dtype,
                                                    slots):
    # the CPU model of the kernel's order against the plain version: counts
    # exact, g and h within 1e-4 * sum|x| + 1e-6 (the contract's, the
    # reference's own Pallas tolerance)
    bins, payload, leaf_id = _case(n, f, mb, seed=seed, dtype=dtype,
                                   leaves=12)
    payload[:, 2] = 1.0
    args = (torch.from_numpy(bins), torch.from_numpy(payload),
            torch.from_numpy(leaf_id), torch.tensor(slots, dtype=torch.int32))
    got = hist_kernel.histogram_multi_ordered(*args, mb)
    plain = histogram_multi_plain(*args, mb)
    absum = histogram_multi_plain(args[0], args[1].abs(), *args[2:], mb)
    assert torch.equal(got[..., 2], plain[..., 2])
    assert bool(((got - plain).abs() <= 1e-4 * absum + 1e-6).all())


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
