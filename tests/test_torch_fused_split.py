"""The fused scan and its kernels' plain versions against the JAX package,
on the CPU (`lightgbm_tpu_torch/ops/split.py` fused section,
`ops/fused_kernel.py`).

  * the port's `fused_numerical_candidates` is bitwise the reference's,
    and `split_scan_plain` bitwise `pallas_split_scan(interpret=True)`,
    on histograms with a short feature (nb < MB), NaN- and zero-missing
    features, l1 > 0, min_data / min_hessian gates that reject some
    candidates, one (feature, slot) row with no valid threshold and one
    slot with no valid split at all;
  * K2's plain version: its histogram is bitwise `histogram_multi_plain`
    and the reference's `leaf_histogram_multi` (segment sum), its
    candidates bitwise the reference's scan on that histogram; against
    `pallas_fused_hist_split_rows(interpret=True)` the histogram agrees
    within the reference's own 1e-4 (its Pallas path splits the payload
    into bf16 terms, ROADMAP Queue 3 (d)) and the candidates bitwise when
    the port scans the reference's histogram;
  * `decide_from_candidates` over the plain candidates equals the port's
    `find_best_split` field for field, bitwise, and the reference's
    `decide_from_candidates`;
  * the wrappers: CPU tensors run the plain versions (no launch is
    counted), another device raises, more than 14 slots go in chunks.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lightgbm_tpu.ops import pallas_hist as ph  # noqa: E402
from lightgbm_tpu.ops import split as ref_split  # noqa: E402
from lightgbm_tpu.ops.histogram import leaf_histogram_multi  # noqa: E402
from lightgbm_tpu_torch.ops import fused_kernel as fk  # noqa: E402
from lightgbm_tpu_torch.ops import split as port_split  # noqa: E402
from lightgbm_tpu_torch.ops.hist_kernel import (  # noqa: E402
    histogram_multi_plain)
from lightgbm_tpu_torch.utils.log import LightGBMError  # noqa: E402

F, S, MB = 6, 4, 32
NB = np.array([MB, 17, MB, 9, MB, 2], np.int32)
# feature 2 NaN-missing, 4 zero-missing, 5 NaN-missing with nb 2 (no
# valid threshold in either case: t_max = -1)
MISSING = np.array([0, 1, 2, 0, 1, 2], np.int32)
DEFAULT = np.array([0, 3, 0, 0, 5, 0], np.int32)

SCANS = {
    "plain": dict(l1=0.0, l2=1.0, min_data_in_leaf=5.0,
                  min_sum_hessian=1e-3, min_gain_to_split=0.0),
    "l1_gates": dict(l1=0.4, l2=0.5, min_data_in_leaf=40.0,
                     min_sum_hessian=6.0, min_gain_to_split=0.05),
}


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _same(a, b):
    """Equal dtype and bytes (signed zeros and NaN payloads count)."""
    a, b = (np.ascontiguousarray(np.asarray(x)) for x in (a, b))
    return a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


def _hist_case(seed=9):
    """[S, F, MB, 3] histograms with integer counts; slot 3 holds so few
    rows that min_data rejects every candidate."""
    rng = np.random.RandomState(seed)
    hist = rng.randn(S, F, MB, 3).astype(np.float32)
    hist[..., 1] = np.abs(hist[..., 1]) * 3
    hist[..., 2] = rng.randint(0, 50, (S, F, MB))
    hist[3, ..., 2] = rng.randint(0, 2, (F, MB))
    bins = np.arange(MB)[None, None, :, None]
    hist = np.where(bins < NB[None, :, None, None], hist, 0.0)\
        .astype(np.float32)
    parent = hist.sum(axis=2).mean(axis=1).astype(np.float32)  # [S, 3]
    return hist, parent


def _rows_case(seed=0, n=512, slots=(0, 1, 2, 7)):
    """K2 inputs: bins within each feature's nb, a payload and leaf ids
    over 0..5 (slot 7 matches no row), and each slot's sums."""
    rng = np.random.RandomState(seed)
    bins = (rng.randint(0, 1 << 16, (F, n)) % NB[:, None]).astype(np.uint8)
    payload = rng.randn(n, 3).astype(np.float32)
    payload[:, 1] = np.abs(payload[:, 1])
    payload[:, 2] = 1.0
    lid = rng.randint(0, 6, n).astype(np.int32)
    sl = np.array(slots, np.int32)
    parent = np.stack([np.array([payload[lid == s, c].sum()
                                 for c in range(3)], np.float32)
                       for s in sl])
    return bins, payload, lid, sl, parent


def _t(a):
    return torch.from_numpy(np.array(a))


def _ref_cand(hist, parent, scan_kw):
    """The reference's scan, [S, F, MB, 3] -> [S, 2, F, 8]."""
    out = ref_split.fused_numerical_candidates(
        jnp.asarray(np.transpose(hist, (1, 0, 2, 3))), jnp.asarray(NB),
        jnp.asarray(MISSING), jnp.asarray(parent), **scan_kw)
    return np.transpose(np.asarray(out), (1, 2, 0, 3))


# ------------------------------------------------------ the plain scan
@pytest.mark.parametrize("scan", sorted(SCANS))
def test_plain_scan_is_the_references_bits(scan):
    hist, parent = _hist_case()
    kw = SCANS[scan]
    got = port_split.fused_numerical_candidates(
        _t(np.transpose(hist, (1, 0, 2, 3))), _t(NB), _t(MISSING),
        _t(parent), **kw).numpy()
    want = np.transpose(_ref_cand(hist, parent, kw), (2, 0, 1, 3))
    assert got.shape == (F, S, 2, 8)
    assert np.array_equal(_bits(got), _bits(want))
    # the no-threshold row and the all-rejected slot: (-inf, 0, bin-0
    # prefix); some candidates rejected, some not
    assert np.all(got[5, :, :, 0] == -np.inf) and np.all(got[5, :, :, 1] == 0)
    assert np.all(got[:, 3, :, 0] == -np.inf)
    assert np.array_equal(got[:, 3, 0, 2:5], hist[3, :, 0, :])
    assert np.isfinite(got[:, :3, 0, 0]).sum() >= 3


@pytest.mark.parametrize("scan", sorted(SCANS))
def test_split_scan_plain_equals_the_pallas_scan(scan):
    hist, parent = _hist_case(seed=4)
    kw = SCANS[scan]
    got = fk.split_scan_plain(_t(hist), _t(NB), _t(MISSING), _t(parent),
                              **kw).numpy()
    want = np.asarray(ph.pallas_split_scan(
        jnp.asarray(hist), jnp.asarray(NB), jnp.asarray(MISSING),
        jnp.asarray(parent), interpret=True, **kw))
    assert got.shape == (S, 2, F, 8)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("mb", [16, 17, 255, 1023])
def test_plain_scan_block_levels(mb):
    """Prefix sums past one block of 16 and past 16 blocks (u16 bins):
    block_cumsum's order, the reference's bits."""
    rng = np.random.RandomState(mb)
    f = 3
    nb = np.array([mb, mb - 1, max(mb // 3, 2)], np.int32)
    miss = np.array([2, 0, 1], np.int32)
    hist = rng.randn(f, 2, mb, 3).astype(np.float32) * 10
    hist[..., 1] = np.abs(hist[..., 1])
    hist[..., 2] = rng.randint(0, 9, (f, 2, mb))
    parent = hist.sum(axis=(0, 2)).astype(np.float32) / f
    kw = SCANS["plain"]
    got = port_split.fused_numerical_candidates(
        _t(hist), _t(nb), _t(miss), _t(parent), **kw).numpy()
    want = np.asarray(ref_split.fused_numerical_candidates(
        jnp.asarray(hist), jnp.asarray(nb), jnp.asarray(miss),
        jnp.asarray(parent), **kw))
    assert np.array_equal(_bits(got), _bits(want))


# ----------------------------------------------------- K2's plain version
def test_fused_plain_histogram_and_candidates():
    bins, payload, lid, sl, parent = _rows_case()
    kw = SCANS["plain"]
    hist, cand = fk.fused_hist_split(_t(bins), _t(payload), _t(lid),
                                     _t(sl), _t(NB), _t(MISSING),
                                     _t(parent), MB, **kw)
    hist, cand = hist.numpy(), cand.numpy()
    assert np.array_equal(_bits(hist), _bits(histogram_multi_plain(
        _t(bins), _t(payload), _t(lid), _t(sl), MB)))
    seg = np.asarray(leaf_histogram_multi(
        jnp.asarray(bins.astype(np.int32)), jnp.asarray(payload),
        jnp.asarray(lid), jnp.asarray(sl), MB))
    assert np.array_equal(_bits(hist), _bits(seg))
    assert not hist[3].any()                      # slot 7 matches no row
    assert np.array_equal(_bits(cand), _bits(_ref_cand(hist, parent, kw)))


def test_fused_plain_against_the_pallas_kernel():
    bins, payload, lid, sl, parent = _rows_case(seed=3)
    kw = SCANS["l1_gates"]
    pj = jnp.asarray(payload)
    ref_h, ref_c = ph.pallas_fused_hist_split_rows(
        jnp.asarray(bins.astype(np.int32)), ph._split_payload9(pj),
        jnp.asarray(lid), jnp.asarray(sl), jnp.asarray(NB),
        jnp.asarray(MISSING), jnp.asarray(parent), MB, row_tile=256,
        interpret=True, **kw)
    ref_h, ref_c = np.asarray(ref_h), np.asarray(ref_c)
    hist, _ = fk.fused_hist_split(_t(bins), _t(payload), _t(lid), _t(sl),
                                  _t(NB), _t(MISSING), _t(parent), MB, **kw)
    np.testing.assert_allclose(hist.numpy(), ref_h, rtol=1e-4, atol=1e-4)
    mine = fk.split_scan_plain(_t(ref_h), _t(NB), _t(MISSING), _t(parent),
                               **kw).numpy()
    assert np.array_equal(_bits(mine), _bits(ref_c))


# ------------------------------------------------------------- decide
def _decide_both(hist, parent, allowed, kw):
    cand = fk.split_scan_plain(_t(hist), _t(NB), _t(MISSING), _t(parent),
                               **kw)
    p = _t(parent)
    got = port_split.decide_from_candidates(
        cand, p[:, 0], p[:, 1], p[:, 2], _t(MISSING), _t(DEFAULT),
        _t(allowed))
    want = port_split.find_best_split(
        _t(hist), p[:, 0], p[:, 1], p[:, 2], _t(NB), _t(MISSING),
        _t(DEFAULT), _t(allowed), kw["l1"], kw["l2"],
        kw["min_data_in_leaf"], kw["min_sum_hessian"],
        kw["min_gain_to_split"])
    return cand.numpy(), got, want


@pytest.mark.parametrize("scan", sorted(SCANS))
def test_decide_reproduces_find_best_split(scan):
    hist, parent = _hist_case(seed=21)
    allowed = np.ones(F, bool)
    cand, got, want = _decide_both(hist, parent, allowed, SCANS[scan])
    for name, a, b in zip(got._fields, got, want):
        # a numerical search leaves the categorical fields None on both
        assert (a is None and b is None) or _same(a, b), name
    assert int(got.feature[3]) == -1           # the all-rejected slot
    assert (got.feature[:3] >= 0).all()
    # ... and the reference's decide on the same candidates
    for s in range(S):
        r = ref_split.decide_from_candidates(
            jnp.asarray(cand[s]), jnp.float32(parent[s, 0]),
            jnp.float32(parent[s, 1]), jnp.float32(parent[s, 2]),
            jnp.asarray(MISSING), jnp.asarray(DEFAULT),
            jnp.asarray(allowed), MB)
        for name in ("gain", "feature", "threshold_bin", "default_left",
                     "left_sum_g", "left_sum_h", "left_cnt", "right_sum_g",
                     "right_sum_h", "right_cnt"):
            a = np.asarray(getattr(got, name)[s])
            b = np.asarray(getattr(r, name))
            assert a.astype(b.dtype) == b and (
                a.dtype.kind != "f" or _bits(a) == _bits(b)), (s, name)


def test_decide_applies_the_feature_gate_after_the_scan():
    hist, parent = _hist_case(seed=5)
    kw = SCANS["plain"]
    allowed = np.array([[1, 1, 1, 1, 1, 1], [0, 1, 1, 0, 1, 1],
                        [1, 0, 0, 1, 0, 1], [1, 1, 1, 1, 1, 1]], bool)
    _, got, want = _decide_both(hist, parent, allowed, kw)
    for name, a, b in zip(got._fields, got, want):
        # a numerical search leaves the categorical fields None on both
        assert (a is None and b is None) or _same(a, b), name
    for s in range(3):
        assert allowed[s, int(got.feature[s])]


# ------------------------------------------------------------ wrappers
def test_cpu_tensors_run_the_plain_versions():
    bins, payload, lid, sl, parent = _rows_case(seed=2)
    kw = SCANS["plain"]
    before = (fk.FUSED_LAUNCHES, fk.SCAN_LAUNCHES)
    hist, cand = fk.fused_hist_split(_t(bins), _t(payload), _t(lid),
                                     _t(sl), _t(NB), _t(MISSING),
                                     _t(parent), MB, **kw)
    again = fk.split_scan(hist, _t(NB), _t(MISSING), _t(parent), **kw)
    assert torch.equal(again, cand)
    assert (fk.FUSED_LAUNCHES, fk.SCAN_LAUNCHES) == before


def test_other_devices_and_bad_arguments_raise():
    bins, payload, lid, sl, parent = _rows_case(seed=2)
    kw = SCANS["plain"]
    meta = [_t(a).to("meta") for a in (bins, payload, lid, sl, NB, MISSING,
                                       parent)]
    with pytest.raises(LightGBMError, match="no fused split kernel"):
        fk.fused_hist_split(*meta, MB, **kw)
    with pytest.raises(LightGBMError, match="no split scan kernel"):
        fk.split_scan(torch.zeros((1, F, MB, 3), device="meta"), meta[4],
                      meta[5], meta[6][:1], **kw)
    with pytest.raises(LightGBMError, match="split scan takes"):
        fk.split_scan(torch.zeros((1, F, MB, 3)), _t(NB), _t(MISSING),
                      _t(parent[:1]), l1=0.0)
    with pytest.raises(LightGBMError, match="parent"):
        fk.split_scan_plain(torch.zeros((2, F, MB, 3)), _t(NB),
                            _t(MISSING), _t(parent[:1]), **kw)


def test_more_than_14_slots_go_in_chunks():
    rng = np.random.RandomState(8)
    n = 700
    bins = (rng.randint(0, 1 << 16, (F, n)) % NB[:, None]).astype(np.uint8)
    payload = rng.randn(n, 3).astype(np.float32)
    payload[:, 2] = 1.0
    lid = rng.randint(0, 20, n).astype(np.int32)
    sl = np.arange(17, dtype=np.int32)[::-1].copy()
    parent = rng.randn(17, 3).astype(np.float32)
    parent[:, 1:] = np.abs(parent[:, 1:]) + 50
    kw = SCANS["plain"]
    hist, cand = fk.fused_hist_split(_t(bins), _t(payload), _t(lid),
                                     _t(sl), _t(NB), _t(MISSING),
                                     _t(parent), MB, **kw)
    assert hist.shape == (17, F, MB, 3) and cand.shape == (17, 2, F, 8)
    for i, s in enumerate(sl):
        want = histogram_multi_plain(_t(bins), _t(payload), _t(lid),
                                     _t(sl[i:i + 1]), MB)
        assert torch.equal(hist[i:i + 1], want)
    assert torch.equal(cand, fk.split_scan_plain(
        hist, _t(NB), _t(MISSING), _t(parent), **kw))
