"""The bounded sum's launch plan and lane split (`compiler/records.py
bounded_plan`; kernel `csrc/bounded.cu`).

The kernel cannot run here, so `_lane_model` repeats its arithmetic in
numpy: the groups a chunk at a time, each row's W lanes taking the
chunk's CSR positions w, w + W, ..., a register partial a lane per group
added into the group's cell, then per (row, class) the combine over the
tiles in ascending order (tiles without a group of the class entering
with p = 0), its f32 rounding `ops/predict.py _fma_f32`'s.  Its scores
must be bitwise `accumulate_slots_bounded_plain` and the JAX package's
`accumulate_slots_bounded` (`lightgbm_tpu/ops/predict.py:567`) for one
class and many, classes whose tiles differ, tiles without a group of a
class, 42 and more tiles, one row, several group chunks, and int16 codes
whose partials reach the quantizer's 2^24 guard.  The plan covers every
row and every tree exactly once and fits the shared-memory limits.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
from lightgbm_tpu.ops.predict import \
    accumulate_slots_bounded as jax_bounded  # noqa: E402
from lightgbm_tpu_torch.compiler.records import (  # noqa: E402
    BOUNDED_THREADS, SMEM_MAX, TARGET_BLOCKS, bounded_plan, bounded_smem)
from lightgbm_tpu_torch.ops.predict import (  # noqa: E402
    _fma_f32, accumulate_slots_bounded, accumulate_slots_bounded_plain,
    bounded_groups)

UNROLL = 4     # `csrc/bounded.cu kUnroll`


def _tile_step(v, s, p, scales):
    """The kernel's `tile_step` on f32 tensors."""
    pf = p.to(torch.float32)
    if s == 0:
        return pf
    if s == 1:
        return _fma_f32(v, float(scales[0]),
                        (pf.double() * float(scales[1])).to(torch.float32))
    return _fma_f32(pf, float(scales[s]), v)


def _lane_positions(j0, j1, lane, w):
    """CSR positions lane `lane` of `w` visits in a chunk [j0, j1), in
    the kernel's order (kUnroll at a time)."""
    out = []
    for j in range(j0 + lane, j1, UNROLL * w):
        out += [j + u * w for u in range(UNROLL) if j + u * w < j1]
    return out


def _lane_model(slots, qval, gidx, groups, scales, n_class, plan):
    """The kernel's scores [B, K] f32 for every row (each row's lanes do
    the same work whatever its block, so the rows go together)."""
    rs, b = slots.shape
    nl = qval.shape[1]
    tile, start, trees, cls_start = (g.numpy().astype(np.int64)
                                     for g in groups)
    n_groups = len(tile)
    n_tiles = len(scales)
    state = [torch.zeros(b, dtype=torch.float32) for _ in range(n_class)]
    for g0 in range(0, n_groups, plan.group_chunk):
        g1 = min(n_groups, g0 + plan.group_chunk)
        part = np.zeros((g1 - g0, b), np.int64)
        for lane in range(plan.lanes):
            g, p = g0, np.zeros(b, np.int64)
            for j in _lane_positions(start[g0], start[g1], lane, plan.lanes):
                if start[g + 1] <= j:
                    part[g - g0] += p
                    p = np.zeros(b, np.int64)
                    while start[g + 1] <= j:
                        g += 1
                t = trees[j]
                r = min(max(int(gidx[t]), 0), rs - 1)
                sl = np.clip(slots[r], 0, nl - 1)
                p = p + qval[t, sl].astype(np.int64)
            part[g - g0] += p
        assert np.abs(part).max(initial=0) <= 1 << 24
        for k in range(n_class):
            gs, ge = max(g0, cls_start[k]), min(g1, cls_start[k + 1])
            if gs >= ge:
                continue
            v = state[k]
            s = tile[gs - 1] + 1 if gs > cls_start[k] else 0
            for gg in range(gs, ge):
                for s in range(s, tile[gg]):
                    v = _tile_step(v, s, torch.zeros(b, dtype=torch.int32),
                                   scales)
                v = _tile_step(v, tile[gg], torch.from_numpy(
                    part[gg - g0].astype(np.int32)), scales)
                s = tile[gg] + 1
            state[k] = v
    out = []
    for k in range(n_class):
        ge = cls_start[k + 1]
        v = state[k]
        s = tile[ge - 1] + 1 if ge > cls_start[k] else 0
        for s in range(s, n_tiles):
            v = _tile_step(v, s, torch.zeros(b, dtype=torch.int32), scales)
        if n_tiles == 1:
            v = (v.double() * float(scales[0])).to(torch.float32)
        out.append(v)
    return torch.stack(out, 1)


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(
        a.view(np.uint32), b.view(np.uint32))


def _case(seed, t_trees, n, nl, s_tiles, k, bits, empty=(), guard=False):
    """slots, codes, tiles, scales; `empty`: (class, tile) pairs left
    without a tree; `guard`: every code of tile 0 at the int16 limit."""
    rng = np.random.RandomState(seed)
    dt = np.int8 if bits == 8 else np.int16
    qmax = (1 << (bits - 1)) - 1
    slots = rng.randint(0, nl, (t_trees + 3, n)).astype(np.int32)
    qval = rng.randint(-qmax, qmax + 1, (t_trees, nl)).astype(dt)
    tile = np.sort(rng.randint(0, s_tiles, t_trees)).astype(np.int32)
    for c, s in empty:
        move = (np.arange(t_trees) % k == c) & (tile == s)
        tile[move] = (s + 1) % s_tiles
    if guard:       # 2^24 / (2^15 - 1) trees of tile 0 at -qmax
        tile = (np.arange(t_trees) >= (1 << 24) // qmax).astype(np.int32)
        qval[tile == 0] = -qmax
    scales = (rng.rand(s_tiles) * 10.0 ** rng.randint(-6, 2, s_tiles)
              ).astype(np.float32)
    gidx = rng.permutation(t_trees + 3)[:t_trees].astype(np.int32)
    return slots, qval, tile, scales, gidx


CASES = {
    "one_class": dict(seed=1, t_trees=300, n=257, nl=31, s_tiles=7, k=1,
                      bits=8),
    "one_tile": dict(seed=2, t_trees=40, n=33, nl=9, s_tiles=1, k=1,
                     bits=16),
    "multiclass": dict(seed=3, t_trees=300, n=129, nl=15, s_tiles=5, k=3,
                       bits=16),
    "tiles_without_a_class": dict(seed=4, t_trees=240, n=65, nl=15,
                                  s_tiles=6, k=3, bits=8,
                                  empty=((0, 0), (1, 2), (2, 5), (1, 3))),
    "tiles_45": dict(seed=5, t_trees=500, n=40, nl=31, s_tiles=45, k=2,
                     bits=8),
    "one_row": dict(seed=6, t_trees=500, n=1, nl=255, s_tiles=9, k=1,
                    bits=8),
    "int16_at_the_guard": dict(seed=7, t_trees=1024, n=17, nl=7,
                               s_tiles=2, k=1, bits=16, guard=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("chunk", [None, 2])
def test_lane_split_bitwise_plain_and_reference(name, chunk):
    c = CASES[name]
    slots, qval, tile, scales, gidx = _case(**c)
    k = c["k"]
    groups = bounded_groups(tile, k, "cpu", n_tiles=c["s_tiles"])
    t = [torch.from_numpy(a) for a in (slots, qval, tile, scales, gidx)]
    plain = accumulate_slots_bounded_plain(t[0], t[1], t[2], t[3], k, t[4])
    plain = plain.reshape(c["n"], k)
    rows = slots[np.clip(gidx, 0, len(slots) - 1)]
    want = np.asarray(jax.jit(lambda *a: jax_bounded(
        *a, n_class=k, cls=(np.arange(len(tile)) % k).astype(np.int32)
        if k > 1 else None))(rows, qval, tile, scales)).reshape(c["n"], k)
    assert _bits(plain.numpy(), want)
    plan = bounded_plan(c["n"], len(tile), len(groups.grp_tile), k,
                        group_chunk=chunk)
    got = _lane_model(slots, qval, gidx, groups, scales, k, plan)
    assert _bits(got.numpy(), want)
    # the wrapper on the CPU runs the plain version
    out = accumulate_slots_bounded(t[0], t[1], t[2], t[3], k, t[4])
    assert _bits(out.reshape(c["n"], k).numpy(), want)


def test_lane_split_clamps_as_the_plain_version():
    """Slots and plan rows past their tables clamp (the plain version's
    rule; the JAX package's gathers wrap negative indices)."""
    slots, qval, tile, scales, gidx = _case(8, 200, 50, 11, 4, 2, 8)
    rng = np.random.RandomState(8)
    slots = rng.randint(-5, 16, slots.shape).astype(np.int32)
    gidx[::7] = rng.randint(-9, 0, len(gidx[::7]))
    gidx[3::7] = len(slots) + rng.randint(0, 9, len(gidx[3::7]))
    groups = bounded_groups(tile, 2, "cpu", n_tiles=4)
    t = [torch.from_numpy(a) for a in (slots, qval, tile, scales, gidx)]
    plain = accumulate_slots_bounded_plain(t[0], t[1], t[2], t[3], 2, t[4])
    plan = bounded_plan(50, 200, len(groups.grp_tile), 2)
    got = _lane_model(slots, qval, gidx, groups, scales, 2, plan)
    assert _bits(got.numpy(), plain.numpy())


def test_guard_case_reaches_the_guard():
    c = CASES["int16_at_the_guard"]
    _, qval, tile, _, _ = _case(**c)
    worst = int((tile == 0).sum()) * ((1 << 15) - 1)
    assert worst > (1 << 24) - (1 << 16) and worst <= 1 << 24


def test_groups_clamp_tiles_as_the_plain_version():
    tile = np.array([0, 5, 1, 9, 1, 2], np.int32)
    g = bounded_groups(tile, 2, "cpu", n_tiles=3)
    # class 0: trees 0, 2, 4 (tiles 0, 1, 1); class 1: 1, 3, 5 (2, 2, 2)
    assert g.cls_start.tolist() == [0, 2, 3]
    assert g.grp_tile.tolist() == [0, 1, 2]
    assert g.grp_start.tolist() == [0, 1, 3, 6]
    assert g.grp_trees.tolist() == [0, 2, 4, 1, 3, 5]
    rng = np.random.RandomState(0)
    slots = torch.from_numpy(rng.randint(0, 4, (6, 11)).astype(np.int32))
    qval = torch.from_numpy(rng.randint(-9, 10, (6, 4)).astype(np.int8))
    scales = torch.from_numpy(rng.rand(3).astype(np.float32))
    plain = accumulate_slots_bounded_plain(slots, qval,
                                           torch.from_numpy(tile), scales, 2)
    plan = bounded_plan(11, 6, 3, 2)
    got = _lane_model(slots.numpy(), qval.numpy(),
                      np.arange(6, dtype=np.int32), g, scales.numpy(), 2,
                      plan)
    assert _bits(got.numpy(), plain.numpy())


@pytest.mark.parametrize("b", [1, 3, 256, 4096, 65536])
@pytest.mark.parametrize("t_trees,n_groups,k", [(500, 40, 1), (7, 3, 3),
                                                 (3000, 3000, 100)])
def test_bounded_plan_covers_every_row_and_tree_once(b, t_trees, n_groups,
                                                     k):
    plan = bounded_plan(b, t_trees, n_groups, k)
    assert plan.threads == plan.rows * plan.lanes <= BOUNDED_THREADS
    assert plan.smem == bounded_smem(plan.rows, plan.group_chunk, k)
    assert plan.smem <= SMEM_MAX
    # rows: thread i of block x is on row x * R + i % R, once a lane
    rows = (np.arange(plan.row_blocks)[:, None] * plan.rows
            + np.arange(plan.threads)[None, :] % plan.rows)
    rows = rows[rows < b]
    assert np.array_equal(np.bincount(rows, minlength=b),
                          np.full(b, plan.lanes))
    # trees: a row's lanes visit every CSR position of every chunk once
    start = np.linspace(0, t_trees, n_groups + 1).astype(np.int64)
    seen = []
    for g0 in range(0, n_groups, plan.group_chunk):
        g1 = min(n_groups, g0 + plan.group_chunk)
        for lane in range(plan.lanes):
            seen += _lane_positions(start[g0], start[g1], lane, plan.lanes)
    assert sorted(seen) == list(range(t_trees))
    if b >= TARGET_BLOCKS * plan.rows:
        assert plan.row_blocks >= TARGET_BLOCKS
    if b == 1:
        assert plan.row_blocks == 1
        assert plan.lanes == min(BOUNDED_THREADS, 1 << (t_trees - 1)
                                 .bit_length())


def test_bounded_plan_requests_and_limits():
    p = bounded_plan(4096, 500, 40, 1, rows=8, lanes=4, group_chunk=3)
    assert (p.rows, p.lanes, p.threads, p.group_chunk) == (8, 4, 32, 3)
    big = bounded_plan(65536, 20000, 20000, 400)
    assert big.smem <= SMEM_MAX and big.group_chunk < 20000
    for bad in (dict(rows=3), dict(lanes=3), dict(rows=32, lanes=16),
                dict(group_chunk=0)):
        with pytest.raises(ValueError):
            bounded_plan(4096, 500, 40, 1, **bad)
    with pytest.raises(ValueError):
        bounded_plan(0, 500, 40, 1)
