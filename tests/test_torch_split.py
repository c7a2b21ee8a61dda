"""The port's numerical split search against the JAX package's, on the CPU.

The same f32 histograms go through `lightgbm_tpu.ops.split
find_best_split(has_cat=False)` and the port's `find_best_split`, over
missing types none, zero and NaN, L1/L2, min_data_in_leaf,
min_sum_hessian, max_delta_step, path smoothing and disallowed
features.  The decision (feature, threshold bin, default_left) must be
equal; gains and left sums must agree within rtol 1e-5.  A decision
that differs must be a near-tie (both candidates' gains within 1e-5
relative), and the test asserts that rather than skipping the case.
The port's prefix sums add in XLA's CPU order (`ops/reduce.py`), so in
practice the two agree bitwise, and the test counts that too.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from lightgbm_tpu.ops.split import \
    find_best_split as jax_find_best_split  # noqa: E402
from lightgbm_tpu_torch.ops.split import find_best_split  # noqa: E402

PARAMS = [
    dict(l1=0.0, l2=0.0, min_data_in_leaf=20.0, min_sum_hessian=1e-3,
         min_gain_to_split=0.0),
    dict(l1=0.5, l2=1.0, min_data_in_leaf=5.0, min_sum_hessian=1e-3,
         min_gain_to_split=0.0),
    dict(l1=0.0, l2=10.0, min_data_in_leaf=50.0, min_sum_hessian=5.0,
         min_gain_to_split=0.1, max_delta_step=0.3),
    dict(l1=0.1, l2=0.0, min_data_in_leaf=1.0, min_sum_hessian=0.0,
         min_gain_to_split=0.0, max_delta_step=0.7, path_smooth=2.0),
]


def _leaf(seed, f=7, mb=64):
    """One leaf's histogram with per-feature bin counts and missing
    types (none, zero, NaN), plus its parent sums."""
    rng = np.random.RandomState(seed)
    nb = rng.randint(2, mb + 1, f).astype(np.int32)
    nb[0] = mb
    nb[1] = 2
    missing = rng.randint(0, 3, f).astype(np.int32)
    missing[:3] = [0, 1, 2]
    default = np.array([rng.randint(0, n) for n in nb], np.int32)
    cnt = rng.poisson(30, (f, mb)).astype(np.float32)
    g = (rng.randn(f, mb) * np.sqrt(cnt + 1)).astype(np.float32)
    h = (cnt * rng.uniform(0.05, 0.25, (f, mb))).astype(np.float32)
    hist = np.stack([g, h, cnt], axis=-1)
    hist[np.arange(mb)[None, :] >= nb[:, None]] = 0.0
    # every feature holds the same rows: parent = feature 0's column sum
    parent = hist[0].sum(axis=0)
    allowed = rng.rand(f) < 0.85
    allowed[0] = True
    return hist, parent, nb, missing, default, allowed


def _jax(hist, parent, nb, missing, default, allowed, p, p_out):
    kw = dict(p)
    path_smooth = kw.pop("path_smooth", 0.0)
    mds = kw.pop("max_delta_step", 0.0)
    f = hist.shape[0]
    return jax_find_best_split(
        jnp.asarray(hist), jnp.float32(parent[0]), jnp.float32(parent[1]),
        jnp.float32(parent[2]), jnp.asarray(nb), jnp.asarray(missing),
        jnp.asarray(default), jnp.asarray(allowed),
        jnp.zeros((f,), bool), cat_smooth=10.0, cat_l2=10.0,
        max_cat_threshold=32, max_cat_to_onehot=4, max_delta_step=mds,
        path_smooth=path_smooth, parent_output=jnp.float32(p_out),
        has_cat=False, **kw)


def _port(hist, parent, nb, missing, default, allowed, p, p_out):
    kw = dict(p)
    return find_best_split(
        torch.from_numpy(hist), torch.tensor(parent[0]),
        torch.tensor(parent[1]), torch.tensor(parent[2]),
        torch.from_numpy(nb), torch.from_numpy(missing),
        torch.from_numpy(default), torch.from_numpy(allowed),
        kw.pop("l1"), kw.pop("l2"), kw.pop("min_data_in_leaf"),
        kw.pop("min_sum_hessian"), kw.pop("min_gain_to_split"),
        parent_output=torch.tensor(np.float32(p_out)), **kw)


@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_decisions_equal_gains_within_tolerance(pi):
    p = PARAMS[pi]
    bitwise = 0
    for seed in range(12):
        hist, parent, nb, missing, default, allowed = _leaf(100 * pi + seed)
        p_out = 0.05 * (seed - 6)
        j = _jax(hist, parent, nb, missing, default, allowed, p, p_out)
        t = _port(hist, parent, nb, missing, default, allowed, p, p_out)
        jd = (int(j.feature), int(j.threshold_bin), bool(j.default_left))
        td = (int(t.feature), int(t.threshold_bin), bool(t.default_left))
        if jd != td:
            # allowed only as a near-tie: both gains within 1e-5 relative
            g_j = float(j.gain)
            g_t = float(t.gain)
            assert abs(g_j - g_t) <= 1e-5 * max(abs(g_j), 1e-30), \
                (seed, jd, td, g_j, g_t)
            continue
        np.testing.assert_allclose(float(t.gain), float(j.gain), rtol=1e-5)
        for name in ("left_sum_g", "left_sum_h", "left_cnt",
                     "right_sum_g", "right_sum_h", "right_cnt"):
            np.testing.assert_allclose(float(getattr(t, name)),
                                       float(getattr(j, name)), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        bitwise += all(np.float32(getattr(t, k)) == np.float32(getattr(j, k))
                       for k in ("gain", "left_sum_g", "left_sum_h",
                                 "left_cnt"))
    assert bitwise == 12


def test_no_valid_split_is_minus_inf_not_nan():
    hist, parent, nb, missing, default, allowed = _leaf(7)
    p = dict(PARAMS[0], min_data_in_leaf=1e9)
    t = _port(hist, parent, nb, missing, default, allowed, p, 0.0)
    j = _jax(hist, parent, nb, missing, default, allowed, p, 0.0)
    assert float(t.gain) == float(j.gain) == -np.inf
    assert int(t.feature) == int(j.feature) == -1


def test_batched_search_equals_per_leaf_searches():
    leaves = [_leaf(s) for s in (31, 32)]
    nb, missing, default = leaves[0][2], leaves[0][3], leaves[0][4]
    hists = np.stack([leaves[0][0], leaves[1][0] * 0.5])
    hists[1][np.arange(64)[None, :] >= nb[:, None]] = 0.0
    parents = np.stack([hists[0][0].sum(axis=0), hists[1][0].sum(axis=0)])
    allowed = leaves[0][5]
    p = PARAMS[1]
    batch = find_best_split(
        torch.from_numpy(hists), torch.from_numpy(parents[:, 0]),
        torch.from_numpy(parents[:, 1]), torch.from_numpy(parents[:, 2]),
        torch.from_numpy(nb), torch.from_numpy(missing),
        torch.from_numpy(default), torch.from_numpy(allowed),
        p["l1"], p["l2"], p["min_data_in_leaf"], p["min_sum_hessian"],
        p["min_gain_to_split"])
    packed = batch.pack().numpy()
    assert packed.shape == (2, 10)
    for b in range(2):
        one = _port(hists[b], parents[b], nb, missing, default, allowed, p,
                    0.0)
        assert np.array_equal(packed[b], one.pack().numpy())
