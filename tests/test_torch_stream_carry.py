"""The histogram carries of the shard-streamed grower on the CPU, against
the live JAX package:

  * the plain carries (`ops/histogram.py hist_stream_*`, the f32 family,
    and `hist_stream_packed_*`, the packed int32 family) bitwise the
    reference's over the same shard cuts, their carried state included;
  * `histogram_carry_ordered`, the order-exact model of the CUDA carry
    entry (`csrc/histogram.cu lgbt_histogram_carry`), over random shard
    cuts bitwise `histogram_multi_ordered` over all rows: batches and
    pieces that straddle shards, chunk counts 1 to 16, repeated and
    empty slots, shards with no row of a slot, u8 and u16 bins;
  * the wrappers: CPU tensors run the plain versions (the f32 carry is
    `histogram_multi_plain`, the int32 carry `histogram_multi_quantized`
    over all rows), other devices raise.
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
from lightgbm_tpu_torch.ops import hist_kernel_q as hkq  # noqa: E402
from lightgbm_tpu_torch.ops import histogram as ph  # noqa: E402
from lightgbm_tpu_torch.utils.log import LightGBMError  # noqa: E402


def _cuts(rng, n, k):
    return np.sort(rng.integers(0, n + 1, k))


def _pieces(n, cuts):
    edges = [0] + [int(c) for c in cuts] + [n]
    return [(a, b) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def _data(seed, n, f, mb, leaves, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, mb, (f, n)).astype(dtype)
    pay = rng.standard_normal((n, 3)).astype(np.float32)
    lid = rng.integers(0, leaves, n).astype(np.int32)
    return rng, bins, pay, lid


def _bits(t):
    return np.asarray(t, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", range(2))
def test_f32_plain_carry_is_the_references(seed):
    """Shards of 400 rows and a ragged tail (few shapes: the reference
    compiles its update once a shape)."""
    rng, bins, pay, lid = _data(seed, 1500, 4, 17, 5)
    slots = np.array([0, 3, 9, 1], np.int32)       # 9: a pad slot
    cuts = [400, 800, 1200]
    acc = ph.hist_stream_init(4, 4, 17)
    racc = ref.hist_stream_init(4, 4, 17)
    for a, b in _pieces(1500, cuts):
        ph.hist_stream_update(acc, torch.from_numpy(bins[:, a:b].copy()),
                              torch.from_numpy(pay[a:b]),
                              torch.from_numpy(lid[a:b]),
                              torch.from_numpy(slots), 17)
        racc = ref.hist_stream_update(racc, jnp.asarray(bins[:, a:b]),
                                      jnp.asarray(pay[a:b]),
                                      jnp.asarray(lid[a:b]),
                                      jnp.asarray(slots), 17)
    assert np.array_equal(_bits(acc.permute(2, 0, 1)), _bits(racc))
    out = ph.hist_stream_finalize(acc, 4, 17)
    rout = ref.hist_stream_finalize(racc, 4, 4, 17)
    assert np.array_equal(_bits(out), _bits(rout))


@pytest.mark.parametrize("level", [0, 7])
def test_packed_plain_carry_is_the_references(level):
    rng, bins, _, lid = _data(11 + level, 5000, 3, 9, 4)
    s_g, s_h = np.float32(0.125), np.float32(0.0625)
    gq = rng.integers(-7, 8, 5000).astype(np.float32)
    hq = rng.integers(0, 8, 5000).astype(np.float32) if level == 0 \
        else np.full(5000, level, np.float32)
    w = (rng.random(5000) < 0.8).astype(np.float32)
    pay = np.stack([gq * s_g * w, hq * s_h * w, w], 1).astype(np.float32)
    slots = np.array([2, 0, 1], np.int32)
    cuts = [2100, 4200]                 # tiles straddle the shards
    acc = ph.hist_stream_packed_init(3, 3, 9, level)
    racc = ref.hist_stream_packed_init(3, 3, 9, const_hess_level=level)
    for a, b in _pieces(5000, cuts):
        ph.hist_stream_packed_update(
            acc, torch.from_numpy(bins[:, a:b].copy()),
            torch.from_numpy(pay[a:b]), torch.from_numpy(lid[a:b]),
            torch.from_numpy(slots), 9, torch.tensor(s_g),
            torch.tensor(s_h), level)
        racc = ref.hist_stream_packed_update(
            racc, jnp.asarray(bins[:, a:b]), jnp.asarray(pay[a:b]),
            jnp.asarray(lid[a:b]), jnp.asarray(slots), 9, s_g, s_h,
            const_hess_level=level)
    assert sorted(acc) == sorted(racc)
    for k in acc:
        assert np.array_equal(acc[k].numpy(), np.asarray(racc[k])), k
    out = ph.hist_stream_packed_finalize(acc, 3, 9, torch.tensor(s_g),
                                         torch.tensor(s_h), level)
    rout = ref.hist_stream_packed_finalize(racc, 3, 3, 9, s_g, s_h,
                                           const_hess_level=level)
    assert np.array_equal(_bits(out), _bits(rout))


def _fixed_chunks(monkeypatch, chunks):
    plan = hk.launch_plan
    monkeypatch.setattr(hk, "launch_plan", lambda n, f, s, mb:
                        plan(n, f, s, mb)._replace(chunks=chunks))


@pytest.mark.parametrize("chunks", [1, 2, 3, 7, 16])
def test_ordered_carry_over_shard_cuts_is_k1s_order(monkeypatch, chunks):
    """Shards cut anywhere, a piece of every length (rows below 256
    make one piece), slots repeated, empty and absent from a shard."""
    _fixed_chunks(monkeypatch, chunks)
    for seed in range(3):
        rng, bins, pay, lid = _data(100 * chunks + seed, 6000, 3, 21, 4)
        bins[0, rng.random(6000) < 0.05] = 25     # >= MB: skipped
        lid[1000:2400] = 1                        # shards with no slot 0
        slots = torch.tensor([[0, 1, 0, 8], [2], [3, 1, 2, 0, 5]][seed],
                             dtype=torch.int32)
        args = (torch.from_numpy(bins), torch.from_numpy(pay),
                torch.from_numpy(lid), slots, 21)
        want = hk.histogram_multi_ordered(*args)
        for k in (0, 4, 40):
            got = hk.histogram_carry_ordered(*args, _cuts(rng, 6000, k))
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (seed, k)


def test_ordered_carry_u16_and_single_row_shards(monkeypatch):
    _fixed_chunks(monkeypatch, 5)
    rng, bins, pay, lid = _data(7, 2500, 2, 700, 3, np.uint16)
    slots = torch.tensor([2, 0], dtype=torch.int32)
    args = (torch.from_numpy(bins), torch.from_numpy(pay),
            torch.from_numpy(lid), slots, 700)
    want = hk.histogram_multi_ordered(*args)
    cuts = list(range(1, 80)) + list(range(600, 640)) + [2499]
    got = hk.histogram_carry_ordered(*args, cuts)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_ordered_carry_more_than_14_slots():
    rng, bins, pay, lid = _data(3, 4000, 2, 11, 20)
    slots = torch.arange(20, dtype=torch.int32)
    args = (torch.from_numpy(bins), torch.from_numpy(pay),
            torch.from_numpy(lid), slots, 11)
    want = torch.cat([hk.histogram_multi_ordered(*args[:3], slots[:14], 11),
                      hk.histogram_multi_ordered(*args[:3], slots[14:], 11)])
    got = hk.histogram_carry_ordered(*args, _cuts(rng, 4000, 9))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_cpu_wrappers_run_the_plain_carries():
    rng, bins, pay, lid = _data(5, 3000, 3, 13, 6)
    slots = torch.tensor([4, 1, 4, 0], dtype=torch.int32)
    B, P, L = map(torch.from_numpy, (bins, pay, lid))
    s_g, s_h = torch.tensor(0.25), torch.tensor(0.5)
    pw3 = torch.from_numpy(np.stack([rng.integers(-7, 8, 3000),
                                     rng.integers(0, 16, 3000),
                                     rng.integers(0, 2, 3000)])
                           .astype(np.int8))
    c = hk.histogram_carry_init(3000, 3, slots, 13)
    q = hkq.histogram_carry_q_init(3, slots, 13)
    for a, b in _pieces(3000, _cuts(rng, 3000, 6)):
        hk.histogram_carry_update(c, B[:, a:b].contiguous(), P[a:b], L[a:b])
        hkq.histogram_carry_q_update(q, B[:, a:b].contiguous(),
                                     pw3[:, a:b].contiguous(), L[a:b])
    assert torch.equal(hk.histogram_carry_finalize(c).view(torch.int32),
                       hk.histogram_multi_plain(B, P, L, slots, 13)
                       .view(torch.int32))
    assert torch.equal(
        hkq.histogram_carry_q_finalize(q, s_g, s_h).view(torch.int32),
        hkq.histogram_multi_quantized(B, pw3, L, slots, 13, s_g, s_h)
        .view(torch.int32))
    assert hk.HIST_CARRY_LAUNCHES == 0 and hkq.HIST_CARRY_Q_LAUNCHES == 0


def test_other_devices_raise():
    meta = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(LightGBMError, match="no histogram carry kernel"):
        hk.histogram_carry_init(10, 2, meta, 4)
    with pytest.raises(LightGBMError, match="no quantized histogram carry"):
        hkq.histogram_carry_q_init(2, meta, 4)
    with pytest.raises(LightGBMError, match="slots must be"):
        hk.histogram_carry_init(10, 2, torch.zeros(0, dtype=torch.int32), 4)
