"""The split scan kernel's orders (`csrc/fused_split.cu scan_row`), checked
on the CPU, where the kernel cannot run.

The kernel scans each (slot, feature) row with one warp of 32 lanes:

  * level 0 of the prefix sums: lane b owns blocks b, b + 32, ... of 16
    bins and adds each in order;
  * the block totals: block_cumsum again level by level, and at the top
    (at most 16 totals) lane b rebuilds the prefix of totals 0..b by the
    sequential chain t0 + t1 + ... + tb, each total read by a shuffle;
  * every chain starts from XLA's init value, (+0.0 + x0) + x1 ... (a
    row of one bin is left as it is);
  * each bin's prefix is its block's prefix plus the previous blocks'
    total (+0.0 in the first block; a row of one block adds nothing);
  * the gains over bins lane, lane + 32, ...; each lane keeps its
    first-wins best, then five xor-shuffle steps leave every lane with
    the row's winner under `beats` (NaN first, then the larger value,
    then the lower index).

`warp_prefix` and `warp_scan` below repeat those steps lane by lane in
numpy f32.  They must be bitwise `ops/reduce.py block_cumsum` and the
plain scan `split_scan_plain`, which is bitwise the JAX package's
`fused_numerical_candidates`, at MB from 1 to 4097 (one block, one block
and one more bin, 16 blocks and one more, more than 256 blocks: three
levels of totals) on rows that start with -0.0; the shuffle-tree argmax
must be `torch.argmax`'s first-wins rule on rows with NaNs, ties, +-0
and all -inf.
"""
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lightgbm_tpu.ops import split as ref_split  # noqa: E402
from lightgbm_tpu_torch.ops import fused_kernel as fk  # noqa: E402
from lightgbm_tpu_torch.ops.reduce import block_cumsum  # noqa: E402

LANES = 32
BLOCK = 16
F32 = np.float32
ZERO = F32(0.0)
MBS = [1, 2, 15, 16, 17, 255, 256, 257, 1023, 1024, 4097]
SCAN_KW = dict(l1=0.3, l2=1.0, min_data_in_leaf=3.0, min_sum_hessian=1e-3,
               min_gain_to_split=0.0)


def _levels(n0):
    """The kernel's `make_levels`: element counts of each level."""
    n = [n0]
    while n[-1] > BLOCK:
        n.append(-(-n[-1] // BLOCK))
    return n


def _seq_block(v, init=True):
    """Block of 16 added in order from the init +0.0 (XLA's; not in a row
    of one bin), in place; returns its total."""
    acc = F32(v[0] + ZERO) if init else v[0]
    v[0] = acc
    for k in range(1, BLOCK):
        acc = F32(acc + v[k])
        v[k] = acc
    return acc


def warp_block_cumsum(t):
    """`warp_block_cumsum` on one channel: block_cumsum of the totals t."""
    n = _levels(len(t))
    top = len(n) - 1
    lv = [np.zeros(BLOCK * n[j + 1], F32) for j in range(top)]
    lv.append(np.zeros(n[top], F32))
    lv[0][:len(t)] = t
    for j in range(top):
        for lane in range(LANES):
            for b in range(lane, n[j + 1], LANES):
                lv[j + 1][b] = _seq_block(lv[j][BLOCK * b:BLOCK * (b + 1)])
    nt = n[top]
    mine = [lv[top][lane] if lane < nt else ZERO for lane in range(LANES)]
    acc = [F32(mine[0] + ZERO)] * LANES          # __shfl_sync(mine, 0)
    for k in range(1, BLOCK):
        for lane in range(LANES):
            if k <= lane:
                acc[lane] = F32(acc[lane] + mine[k])   # shuffle from lane k
    lv[top][:] = acc[:nt]
    for j in range(top - 1, -1, -1):
        for i in range(BLOCK * n[j + 1]):
            b = i // BLOCK
            lv[j][i] = F32(lv[j][i] + (ZERO if b == 0 else lv[j + 1][b - 1]))
    return lv[0][:len(t)]


def warp_prefix(x):
    """The kernel's prefix sums of one channel of a row: level 0 by lanes
    owning whole blocks, then each block's offset."""
    mb = len(x)
    nb0 = -(-mb // BLOCK)
    row = np.zeros(BLOCK * nb0, F32)
    row[:mb] = x
    totals = np.zeros(nb0, F32)
    for lane in range(LANES):
        for b in range(lane, nb0, LANES):
            totals[b] = _seq_block(row[BLOCK * b:BLOCK * (b + 1)], mb > 1)
    if nb0 == 1:
        return row[:mb]
    off = warp_block_cumsum(totals)
    out = np.array([F32(row[i] + (ZERO if i < BLOCK else off[i // BLOCK - 1]))
                    for i in range(mb)], F32)
    return out


def beats(a, ia, b, ib):
    """The kernel's `beats`: a strict total order on (value, index)."""
    na, nb = math.isnan(a), math.isnan(b)
    if na or nb:
        return na and (not nb or ia < ib)
    return a > b or (a == b and ia < ib)


def warp_argmax(v):
    """Lanes' first-wins bests over bins lane, lane + 32, ..., then the
    xor-shuffle tree; returns every lane's (value, index)."""
    best = [(F32(-np.inf), len(v))] * LANES
    for lane in range(LANES):
        for b in range(lane, len(v), LANES):
            if beats(v[b], b, *best[lane]):
                best[lane] = (v[b], b)
    for m in (16, 8, 4, 2, 1):
        best = [best[lane ^ m] if beats(*best[lane ^ m], *best[lane])
                else best[lane] for lane in range(LANES)]
    return best


def _leaf_gain(g, h, l1, l2):
    m = np.abs(g) - F32(l1)
    m = np.where(m < 0, ZERO, m)
    t = np.sign(g) * m
    denom = h + F32(l2)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(denom > 0, (t * t) / denom, ZERO).astype(F32)


def warp_scan(hist, nb, missing, parent, kw):
    """`scan_row` of every (slot, feature) row of hist [S, F, MB, 3]:
    cand [S, 2, F, 8]."""
    s_, f_, mb, _ = hist.shape
    cand = np.zeros((s_, 2, f_, 8), F32)
    for s in range(s_):
        pg, ph, pc = parent[s]
        shift = F32(_leaf_gain(np.array([pg], F32), np.array([ph], F32),
                               kw["l1"], kw["l2"])[0]
                    + F32(kw["min_gain_to_split"]))
        for f in range(f_):
            x = np.where(np.arange(mb)[:, None] < nb[f], hist[s, f], ZERO)
            has_nan = missing[f] == 2
            nanv = (x[nb[f] - 1] if has_nan and 1 <= nb[f] <= mb
                    else np.zeros(3, F32))
            cum = np.stack([warp_prefix(x[:, c]) for c in range(3)], 1)
            t_max = nb[f] - 2 - int(has_nan)
            for cs in (0, 1):
                left = cum + nanv if cs else cum
                right = np.asarray(parent[s], F32) - left
                gain = (_leaf_gain(left[:, 0], left[:, 1], kw["l1"],
                                   kw["l2"])
                        + _leaf_gain(right[:, 0], right[:, 1], kw["l1"],
                                     kw["l2"])) - shift
                ok = ((np.arange(mb) <= t_max) & (cs == 0 or has_nan)
                      & (left[:, 2] >= F32(kw["min_data_in_leaf"]))
                      & (right[:, 2] >= F32(kw["min_data_in_leaf"]))
                      & (left[:, 1] >= F32(kw["min_sum_hessian"]))
                      & (right[:, 1] >= F32(kw["min_sum_hessian"])))
                v = np.where(ok, gain, F32(-np.inf)).astype(F32)
                lanes = warp_argmax(list(v))
                assert len(set((float(a), b) for a, b in lanes)) == 1
                gv, b = lanes[0]
                cand[s, cs, f, :5] = [gv, F32(b), *left[b]]
    return cand


def _row_case(mb, seed):
    """[S=2, F=3, MB, 3] histograms whose rows start with -0.0 (so the
    first prefix is -0.0), a short feature, NaN- and zero-missing."""
    rng = np.random.RandomState(seed)
    hist = (rng.randn(2, 3, mb, 3) * 8).astype(F32)
    hist[..., 1] = np.abs(hist[..., 1])
    hist[..., 2] = rng.randint(0, 6, (2, 3, mb))
    hist[:, :, 0, :] = -0.0
    hist[1, 1, :min(mb, 20), :] = -0.0
    nb = np.array([mb, max(mb - 1, 1), max(mb // 3, 1)], np.int32)
    miss = np.array([2, 0, 1], np.int32)
    parent = hist.sum(axis=2)[:, 0].astype(F32)
    return hist, nb, miss, parent


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, F32)).view(np.uint32)


@pytest.mark.parametrize("mb", MBS)
def test_warp_prefix_is_block_cumsum(mb):
    hist, _, _, _ = _row_case(mb, seed=mb)
    rows = hist.reshape(-1, mb, 3).transpose(0, 2, 1).reshape(-1, mb)
    want = block_cumsum(torch.from_numpy(np.ascontiguousarray(rows))).numpy()
    got = np.stack([warp_prefix(r) for r in rows])
    assert np.array_equal(_bits(got), _bits(want))
    # XLA's chains start from +0.0: a leading -0.0 stays only alone
    assert (np.signbit(got[:, 0]) == (mb == 1)).all()


@pytest.mark.parametrize("mb", MBS)
def test_warp_scan_is_the_plain_and_the_reference_scan(mb):
    hist, nb, miss, parent = _row_case(mb, seed=7 * mb)
    got = warp_scan(hist, nb, miss, parent, SCAN_KW)
    plain = fk.split_scan_plain(torch.from_numpy(hist), torch.from_numpy(nb),
                                torch.from_numpy(miss),
                                torch.from_numpy(parent), **SCAN_KW).numpy()
    ref = np.asarray(ref_split.fused_numerical_candidates(
        jnp.asarray(np.transpose(hist, (1, 0, 2, 3))), jnp.asarray(nb),
        jnp.asarray(miss), jnp.asarray(parent), **SCAN_KW))
    assert np.array_equal(_bits(got), _bits(plain))
    assert np.array_equal(_bits(plain),
                          _bits(np.transpose(ref, (1, 2, 0, 3))))
    # both cases ran: some thresholds found, some rows fully gated
    assert np.isfinite(got[:, 0, :, 0]).any() or mb <= 2


NAN, INF = float("nan"), float("inf")
ARGMAX_ROWS = {
    "nan_first_wins": [1.0, 3.0, NAN, 2.0, NAN, 9.0],
    "ties_lowest_index": [0.5] * 40 + [2.0] * 5 + [1.0] + [2.0] * 30,
    "signed_zeros": [-INF, -0.0, 0.0, -0.0, -INF],
    "all_neg_inf": [-INF] * 255,
    "one_bin": [-INF],
    "late_max_past_a_lane_round": [float(i % 7) for i in range(100)]
    + [50.0] + [50.0] * 3,
}


@pytest.mark.parametrize("case", sorted(ARGMAX_ROWS))
def test_shuffle_argmax_is_torch_argmax(case):
    row = np.array(ARGMAX_ROWS[case], F32)
    lanes = warp_argmax(list(row))
    want = int(torch.argmax(torch.from_numpy(row)))
    assert all(b == want for _, b in lanes)
    v = lanes[0][0]
    assert _bits([v]) == _bits([row[want]]) or (math.isnan(v)
                                                and math.isnan(row[want]))
