"""The carries' launch geometry and state on the CPU:

  * the one-pass int32 carry's plan (`ops/hist_kernel_q.py
    launch_plan_carry_q`) for 1 to 42 slots up to the wrapper's max_bin
    limit: a block's cells within the 227 KB an H100 block can have,
    every (slot, feature) in exactly one block of a tile, tiles that
    cover every row and come in whole clusters;
  * the f32 carry's fold grid (`carry_height`) holds a row for every
    piece a shard's rows of every slot reach, as the list kernel lays
    them out, and its scratch and shared words match the C layout;
  * the state a hop of the data learner's ring moves (`hop_tensors`);
  * the int32 carry on the CPU over shard cuts bitwise the JAX package's
    `pallas_histogram_multi_quantized_rows` (interpret mode) over all
    rows.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402
from lightgbm_tpu.ops import pallas_hist as ref_pallas  # noqa: E402
from lightgbm_tpu_torch.ops import hist_kernel as hk  # noqa: E402
from lightgbm_tpu_torch.ops import hist_kernel_q as hq  # noqa: E402
from lightgbm_tpu_torch.utils.log import LightGBMError  # noqa: E402

#: shared memory an H100 block can have
SMEM_MAX = 232_448


@pytest.mark.parametrize("s", range(1, 43))
def test_carry_q_plan_fits_and_covers(s):
    limit = hq.q_max_bin_limit()
    for mb in (2, 63, 255, 256, 1023, 4096, limit):
        for n in (1, 1000, 28_571, 65_536, 1_000_000, 2_000_000):
            for f in (1, 28, 136):
                p = hq.launch_plan_carry_q(n, f, s, mb)
                assert p.smem == hq.carry_q_smem_bytes(
                    p.slot_group, p.feature_group, mb)
                assert p.smem >= p.slot_group * p.feature_group * mb * 12
                assert p.smem <= SMEM_MAX, (mb, n, f)
                assert 1 <= p.slot_group <= s and 1 <= p.feature_group <= f
                assert p.cluster in (1, 2, 4, 8)
                assert p.tiles % p.cluster == 0
                assert p.tiles * p.tile_rows >= n
                assert (p.tiles - p.cluster) * p.tile_rows < n
                sg, fg = -(-s // p.slot_group), -(-f // p.feature_group)
                assert sg * fg * p.tiles <= 2 ** 31 - 1
                owners = np.zeros((s, f), np.int64)   # a tile's blocks
                for combo in range(sg * fg):
                    s0 = (combo // fg) * p.slot_group
                    f0 = (combo % fg) * p.feature_group
                    owners[s0:s0 + p.slot_group,
                           f0:f0 + p.feature_group] += 1
                assert np.all(owners == 1)


def test_carry_q_plan_refuses_what_no_launch_takes():
    with pytest.raises(LightGBMError, match="slots"):
        hq.launch_plan_carry_q(100, 4, 43, 255)
    with pytest.raises(LightGBMError, match="slots"):
        hq.launch_plan_carry_q(100, 4, 0, 255)
    with pytest.raises(LightGBMError, match="max_bin"):
        hq.launch_plan_carry_q(100, 4, 1, hq.q_max_bin_limit() + 1)


def test_carry_q_plan_fills_the_card_at_the_paths_shapes():
    """A streamed shard of 65,536 rows and a ring's fold of 1M rows at S
    = 1 and 8, F = 28, 255 bins: at least 4 blocks an SM of 132 in
    flight, in clusters of 8."""
    for n in (65_536, 1_000_000):
        for s in (1, 8):
            p = hq.launch_plan_carry_q(n, 28, s, 255)
            blocks = p.tiles * -(-s // p.slot_group) * \
                -(-28 // p.feature_group)
            assert blocks >= 4 * 132 * 0.8 and p.cluster == 8, p


def _fold_rows(lid, a, b, slots, chunks):
    """The grid rows `csrc/histogram.cu carry_list_kernel` lays out for
    the shard [a, b) of leaf ids `lid`: per slot, none once every row is
    folded, one if the shard has none of its rows (its open batch
    moves), else one a piece its ranks [R0, R1) reach."""
    rows = 0
    for v in slots:
        big_l = int((lid == v).sum())
        r0 = int((lid[:a] == v).sum())
        r1 = r0 + int((lid[a:b] == v).sum())
        if r0 >= big_l:
            continue
        if r1 == r0:
            rows += 1
            continue
        bounds = hk.piece_bounds(big_l, chunks)
        ca = np.searchsorted(bounds, r0, "right") - 1
        cb = np.searchsorted(bounds, r1 - 1, "right") - 1
        rows += int(cb - ca + 1)
    return rows


@pytest.mark.parametrize("chunks", [1, 2, 16, 132])
def test_fold_grid_holds_every_piece_a_shard_reaches(chunks):
    rng = np.random.default_rng(chunks)
    for _ in range(40):
        n = int(rng.integers(1, 400_000))
        leaves = int(rng.integers(1, 20))
        lid = rng.integers(0, leaves, n)
        lid[rng.integers(0, n):] = rng.integers(0, leaves)   # a long run
        slots = list(rng.integers(0, leaves + 2, int(rng.integers(1, 15))))
        lengths = [int((lid == v).sum()) for v in slots]
        for _ in range(5):
            a = int(rng.integers(0, n))
            b = min(n, a + int(rng.integers(1, 70_000)))
            assert _fold_rows(lid, a, b, slots, chunks) <= \
                hk.carry_height(b - a, chunks, lengths, slots)


def test_scratch_and_shared_words_follow_the_c_layout():
    n, s, f, mb, height = 65_536, 8, 28, 255, 16
    ints = hk.carry_scratch_ints(n, s, f, mb, height)
    partials = (s * n + 2 * s + 2) & ~1     # the partials' even offset
    assert partials % 2 == 0 and partials >= s * n + 2 * s + 1
    assert ints == partials + height * f * mb * 3
    blocks = -(-n // 2048)
    assert hk.carry_sync_ints(n, s, f) == 2 * s * blocks + 2 + s * f
    # a fold block takes any max_bin K1 takes
    assert hk.carry_smem_bytes(hk.max_bin_limit()) <= SMEM_MAX


def test_hop_tensors_are_the_carried_state():
    slots = torch.tensor([0, 2], dtype=torch.int32)
    c = hk.histogram_carry_init(100, 3, slots, 7)
    assert len(c.hop_tensors()) == 1 and c.hop_tensors()[0] is c.acc
    assert c.tensors() == c.hop_tensors()
    assert hk.CARRY_STATE == ("prefix", "open", "rank", "pend_bin",
                              "pend_pay", "parity")


def test_int32_carry_over_cuts_is_the_references():
    rng = np.random.default_rng(12)
    n, f, mb = 3000, 3, 13
    bins = rng.integers(0, mb, (f, n)).astype(np.uint8)
    lid = rng.integers(0, 5, n).astype(np.int32)
    pw3 = np.stack([rng.integers(-7, 8, n), rng.integers(0, 16, n),
                    rng.integers(0, 2, n)]).astype(np.int8)
    slots = np.array([4, 1, 4, 0], np.int32)
    s_g, s_h = np.float32(0.25), np.float32(0.125)
    c = hq.histogram_carry_q_init(f, torch.from_numpy(slots), mb)
    edges = [0, 1, 700, 701, 2222, n]
    for a, b in zip(edges[:-1], edges[1:]):
        hq.histogram_carry_q_update(
            c, torch.from_numpy(np.ascontiguousarray(bins[:, a:b])),
            torch.from_numpy(np.ascontiguousarray(pw3[:, a:b])),
            torch.from_numpy(lid[a:b]))
    got = hq.histogram_carry_q_finalize(c, torch.tensor(s_g),
                                        torch.tensor(s_h)).numpy()
    want = np.asarray(ref_pallas.pallas_histogram_multi_quantized_rows(
        jnp.asarray(bins), jnp.asarray(pw3), jnp.asarray(lid),
        jnp.asarray(slots), mb, s_g, s_h, interpret=True))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
