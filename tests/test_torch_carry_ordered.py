"""The f32 histogram carry's state machine on the CPU (`ops/hist_kernel.py
carry_ordered_step`, the order of `csrc/histogram.cu carry_fold_kernel`):

  * over random shard cuts, the finalized carry (its prefix) is bitwise
    `histogram_multi_ordered` over all rows, K1's order: shards that
    complete several pieces, a piece open across three or more shards,
    slots with no row in a shard, single-row shards, u16 bins, repeated
    slots, more than 14 slots, chunk counts forced from 1 to 16;
  * after each shard the state holds only the prefix, the open piece,
    the ranks and the open batch's rows, and the prefix is the left fold
    of the pieces completed so far;
  * the carry is within K1's tolerance of the JAX package's f32 carry
    (`lightgbm_tpu/ops/histogram.py hist_stream_*`) over the same cuts,
    counts exact.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402
from lightgbm_tpu.ops import histogram as ref  # noqa: E402
from lightgbm_tpu_torch.ops import hist_kernel as hk  # noqa: E402

STATE = {"prefix", "open", "rank", "pend_bin", "pend_pay"}


def _data(seed, n, f, mb, leaves, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, mb, (f, n)).astype(dtype)
    pay = rng.standard_normal((n, 3)).astype(np.float32)
    lid = rng.integers(0, leaves, n).astype(np.int32)
    return rng, bins, pay, lid


def _fixed_chunks(monkeypatch, chunks):
    plan = hk.launch_plan
    monkeypatch.setattr(hk, "launch_plan", lambda n, f, s, mb:
                        plan(n, f, s, mb)._replace(chunks=chunks))


def _bitwise_k1(bins, pay, lid, slots, mb, cuts):
    args = (torch.from_numpy(bins), torch.from_numpy(pay),
            torch.from_numpy(lid), torch.tensor(slots, dtype=torch.int32))
    want = torch.cat([hk.histogram_multi_ordered(*args[:3], args[3][c:c + 14],
                                                 mb)
                      for c in range(0, len(slots), 14)])
    got = hk.histogram_carry_ordered(*args, mb, cuts)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _case(name):
    """(bins, payload, leaf ids, slots, max_bin, cuts, chunks) of a named
    case."""
    if name == "several_pieces_a_shard":       # pieces of ~300 rows,
        _, b, p, l = _data(1, 9000, 3, 19, 2)  # shards of ~3000
        return b, p, l, [0, 1], 19, [2900, 6100], 16
    if name == "piece_open_across_shards":     # 2 pieces of ~2000 rows,
        _, b, p, l = _data(2, 8000, 2, 23, 2)  # a shard every 150 rows
        return b, p, l, [1, 0], 23, list(range(150, 8000, 150)), 2
    if name == "slot_absent_from_shards":
        _, b, p, l = _data(3, 7000, 3, 17, 3)
        l[1500:4800] = 2                       # shards with slot 2 only
        return b, p, l, [0, 1, 2], 17, [1000, 2000, 3000, 4000, 5500], 7
    if name == "single_row_shards":
        _, b, p, l = _data(4, 3000, 2, 13, 2)
        return b, p, l, [0, 1], 13, list(range(1, 90)) + [1400, 1401], 5
    if name == "u16_bins":
        _, b, p, l = _data(5, 4000, 2, 700, 3, np.uint16)
        b[0, ::97] = 701                       # >= MB: skipped
        return b, p, l, [2, 0], 700, [33, 1000, 1031, 2999], 3
    if name == "repeated_slots":
        _, b, p, l = _data(6, 6000, 3, 21, 4)
        return b, p, l, [3, 0, 3, 1, 0], 21, [500, 2600, 2601, 5000], 4
    if name == "more_than_14_slots":
        _, b, p, l = _data(7, 5000, 2, 11, 20)
        return b, p, l, list(range(20)), 11, [700, 1900, 3300], 1
    raise KeyError(name)


CASES = ("several_pieces_a_shard", "piece_open_across_shards",
         "slot_absent_from_shards", "single_row_shards", "u16_bins",
         "repeated_slots", "more_than_14_slots")


@pytest.mark.parametrize("name", CASES)
def test_carry_is_k1s_order(monkeypatch, name):
    bins, pay, lid, slots, mb, cuts, chunks = _case(name)
    _fixed_chunks(monkeypatch, chunks)
    _bitwise_k1(bins, pay, lid, slots, mb, cuts)


@pytest.mark.parametrize("chunks", [1, 2, 3, 7, 16])
def test_carry_over_random_cuts_is_k1s_order(monkeypatch, chunks):
    _fixed_chunks(monkeypatch, chunks)
    for seed in range(2):
        rng, bins, pay, lid = _data(50 + 10 * chunks + seed, 6000, 2, 21, 4)
        lid[2000:3300] = 3
        slots = [[0, 1, 3, 9], [2, 3, 2]][seed]
        for k in (1, 6, 60):
            _bitwise_k1(bins, pay, lid, slots, 21,
                        np.sort(rng.integers(0, 6001, k)))


def _piece_partials(bins, pay, rows, bounds, mb):
    """Each piece's partial over a slot's rows, K1's batches: the left
    fold of these over the completed pieces is the prefix."""
    out = []
    for c in range(bounds.size - 1):
        part = np.zeros((bins.shape[0], mb, 3), np.float32)
        take = rows[bounds[c]:bounds[c + 1]]
        for fi in range(bins.shape[0]):
            hk._batch_sums_ordered(part[fi], bins[fi, take].astype(np.int64),
                                   pay[take], mb)
        out.append(part)
    return out


def test_state_holds_only_the_prefix_open_piece_ranks_and_open_batch():
    """Driven a shard at a time: the state's keys and shapes never change
    (no [chunks, ...] partials), the ranks count the rows folded, and
    the prefix is the left fold of the pieces complete so far."""
    _, bins, pay, lid = _data(8, 5000, 2, 15, 3)
    slots, mb, chunks = [0, 2, 0], 15, 6
    f = bins.shape[0]
    lengths = [int((lid == v).sum()) for v in slots]
    state = hk.carry_ordered_init(f, len(slots), mb)
    shapes = {k: v.shape for k, v in state.items()}
    assert set(state) == STATE
    parts, bounds = [], []
    for v, big_l in zip(slots, lengths):
        b = hk.piece_bounds(big_l, chunks)
        bounds.append(b)
        parts.append(_piece_partials(bins, pay, np.flatnonzero(lid == v), b,
                                     mb))
    edges = [0, 700, 701, 1900, 2500, 4100, 5000]
    for a, z in zip(edges[:-1], edges[1:]):
        hk.carry_ordered_step(state, bins[:, a:z].astype(np.int64),
                              pay[a:z], lid[a:z], slots, lengths, chunks, mb)
        assert set(state) == STATE
        assert {k: v.shape for k, v in state.items()} == shapes
        for i, v in enumerate(slots):
            done = int((lid[:z] == v).sum())
            assert state["rank"][i] == done
            complete = int(np.searchsorted(bounds[i], done, "right")) - 1
            if complete:
                acc = parts[i][0].copy()
                for c in range(1, complete):
                    acc += parts[i][c]
                assert np.array_equal(acc.view(np.int32),
                                      state["prefix"][i].view(np.int32))


def test_carry_is_within_tolerance_of_the_references():
    """The JAX package's f32 carry adds row by row in another order: the
    kernel's carry agrees within K1's tolerance (1e-4 * sum|x| + 1e-6 a
    cell), its counts exactly."""
    rng, bins, pay, lid = _data(9, 3000, 3, 17, 4)
    pay[:, 2] = rng.random(3000) < 0.9         # the count: 0 or 1
    slots = np.array([1, 3, 0], np.int32)
    cuts = [600, 1200, 1800, 2400]             # few shapes: XLA compiles
    racc = ref.hist_stream_init(3, 3, 17)      # each one once
    rabs = ref.hist_stream_init(3, 3, 17)
    edges = [0] + cuts + [3000]
    for a, b in zip(edges[:-1], edges[1:]):
        args = (jnp.asarray(bins[:, a:b]), jnp.asarray(lid[a:b]),
                jnp.asarray(slots))
        racc = ref.hist_stream_update(racc, args[0], jnp.asarray(pay[a:b]),
                                      *args[1:], 17)
        rabs = ref.hist_stream_update(rabs, args[0],
                                      jnp.asarray(np.abs(pay[a:b])),
                                      *args[1:], 17)
    want = np.asarray(ref.hist_stream_finalize(racc, 3, 3, 17))
    absx = np.asarray(ref.hist_stream_finalize(rabs, 3, 3, 17))
    got = hk.histogram_carry_ordered(
        torch.from_numpy(bins), torch.from_numpy(pay), torch.from_numpy(lid),
        torch.from_numpy(slots), 17, cuts).numpy()
    assert np.array_equal(got[..., 2], want[..., 2])
    assert np.all(np.abs(got - want) <= 1e-4 * absx + 1e-6)
