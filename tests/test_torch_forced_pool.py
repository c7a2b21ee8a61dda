"""Forced splits and the bounded histogram pool against the JAX package,
on the CPU.

  * forced splits (`forcedsplits_filename`, a nested JSON of {feature,
    threshold, left, right}) under the strict grower and the wave (fused
    and unfused, f32 and quantized, and under grow-then-prune, which
    never prunes a forced split): model text byte for byte, and every
    tree begins with the forced (feature, threshold) in BFS order; a
    forced split that proves infeasible abandons the rest of the prefix
    as the reference does;
  * `histogram_pool_size`: the slots sized from the MB (between 2 and
    num_leaves - 1, 0 when the pool would hold every leaf), the pooled
    model text byte for byte the reference's pooled one, its trees'
    structure the unpooled run's, and the wave downgraded to the strict
    grower with the reference's warning.
Mirrors tests/test_hist_pool.py and the forced-split cases of the
reference's grower tests.
"""
import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402

BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.2,
        "verbosity": -1, "device_type": "cpu"}
FORCED = {"feature": 0, "threshold": 0.1,
          "left": {"feature": 1, "threshold": -0.2},
          "right": {"feature": 2, "threshold": 0.5,
                    "right": {"feature": 3, "threshold": 0.0}}}
#: the left child's split at 9.0 leaves no row on its right: infeasible
INFEASIBLE = {"feature": 0, "threshold": 0.1,
              "left": {"feature": 1, "threshold": 9.0},
              "right": {"feature": 2, "threshold": 0.5}}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _data(seed=0, n=1500, f=8):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    z = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.4 * X[:, 4] \
        + 0.3 * rng.randn(n)
    return X, (z > 0).astype(np.float64)


def _train_both(params, X, y, rounds=4):
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y), rounds)
    bp = lt.train(dict(params), lt.Dataset(X, label=y), rounds)
    return bj, bp


def _write(tmp_path, tree):
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(tree))
    return str(path)


def _bfs(tree):
    out, queue = [], [tree]
    while queue:
        node = queue.pop(0)
        out.append((node["feature"], node["threshold"]))
        queue += [node[k] for k in ("left", "right") if node.get(k)]
    return out


def _begins_with(bst, ds, forced):
    """Every tree's first splits, in growth order, are the forced ones."""
    mappers = ds.bin_mappers
    want = [(f, mappers[f].bin_to_value(mappers[f].value_to_bin(t)))
            for f, t in forced]
    for t in bst.trees:
        got = [(int(t.split_feature[i]), float(t.threshold[i]))
               for i in range(min(len(want), t.num_internal()))]
        assert got == want, (got, want)


FORCED_RUNS = {
    "leafwise": {},
    "leafwise_quantized": {"use_quantized_grad": True},
    "wave_fused": {"tree_grow_policy": "wave"},
    "wave_unfused": {"tree_grow_policy": "wave", "tpu_fused_split": False},
    "wave_quantized": {"tree_grow_policy": "wave",
                       "use_quantized_grad": True},
    "wave_overgrow": {"tree_grow_policy": "wave", "tpu_wave_overgrow": 2.0},
}


@pytest.mark.parametrize("name", list(FORCED_RUNS))
def test_forced_splits_match_and_lead_every_tree(name, tmp_path):
    X, y = _data(1)
    params = dict(BASE, forcedsplits_filename=_write(tmp_path, FORCED),
                  **FORCED_RUNS[name])
    bj, bp = _train_both(params, X, y)
    assert bp.model_to_string() == bj.model_to_string()
    assert len(bp._grower_spec.forced_splits) == 4
    _begins_with(bp, bp.train_set, _bfs(FORCED))


@pytest.mark.parametrize("policy", ["leafwise", "wave"])
def test_infeasible_forced_split_abandons_the_prefix(policy, tmp_path):
    X, y = _data(2)
    params = dict(BASE, forcedsplits_filename=_write(tmp_path, INFEASIBLE),
                  tree_grow_policy=policy)
    bj, bp = _train_both(params, X, y)
    assert bp.model_to_string() == bj.model_to_string()
    for t in bp.trees:
        # the root is forced; the infeasible left child is not split on
        # feature 1 at its bin, and growth goes on freely
        assert int(t.split_feature[0]) == 0
        assert t.num_leaves > 3


def test_forced_splits_train_one_round(tmp_path):
    """A one-node forced-splits file trains one round, its root the
    forced split."""
    X = np.random.RandomState(0).randn(200, 6)
    y = (X[:, 0] > 0).astype(float)
    path = _write(tmp_path, {"feature": 2, "threshold": 0.0})
    bst = lt.train({"objective": "binary", "verbosity": -1,
                    "device_type": "cpu", "forcedsplits_filename": path},
                   lt.Dataset(X, label=y), num_boost_round=1)
    assert bst.num_trees() == 1
    assert int(bst.trees[0].split_feature[0]) == 2


# ----------------------------------------------------------------- pool
def _reg(n=2000, f=10, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = X[:, 0] * 2 - X[:, 1] + np.sin(X[:, 2] * 2) + 0.2 * rng.randn(n)
    return X, y


POOL = {"objective": "regression", "num_leaves": 31, "min_data_in_leaf": 10,
        "verbosity": -1, "device_type": "cpu"}


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "quantized"])
def test_pooled_matches_the_reference_and_unpooled_structure(quant):
    """On tests/test_hist_pool.py's own data and rounds: a recomputed
    parent is not bitwise the subtracted one, so near-ties may flip
    elsewhere, in the reference as in the port (the f32 pooled texts are
    byte for byte the reference's either way); quantized histograms are
    integer sums, exact both ways."""
    X, y = _reg(3000)
    params = dict(POOL, use_quantized_grad=quant, hist_impl="packed"
                  if quant else "auto")
    # 10 features x 64 bins x 3 x 4 B = 7.5 KB a slot: 0.02 MB is 2 slots,
    # so parents are evicted and recomputed all the time
    bj, bp = _train_both(dict(params, histogram_pool_size=0.02), X, y, 8)
    slots = bp._grower_spec.hist_pool_slots
    assert slots == bj._grower_spec.hist_pool_slots
    assert 2 <= slots < 31
    assert bp.model_to_string() == bj.model_to_string()
    base = lt.train(dict(params), lt.Dataset(X, label=y), 8)
    for tb, tp in zip(base.trees, bp.trees):
        ni = tb.num_internal()
        assert tp.num_internal() == ni
        assert np.array_equal(tb.split_feature[:ni], tp.split_feature[:ni])
        assert np.array_equal(tb.threshold_bin[:ni], tp.threshold_bin[:ni])
    np.testing.assert_allclose(bp.predict(X), base.predict(X), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("pool_mb,leaves,want", [
    (0.05, 63, "between"), (1024, 7, 0), (0.0001, 31, 2)])
def test_pool_slots_sizing(pool_mb, leaves, want):
    X, y = _reg(500)
    sizes = []
    for m in (lgb, lt):
        bst = m.train(dict(POOL, num_leaves=leaves,
                           histogram_pool_size=pool_mb),
                      m.Dataset(X, label=y), 1)
        sizes.append(bst._grower_spec.hist_pool_slots)
    assert sizes[0] == sizes[1]
    if want == "between":
        assert 2 <= sizes[1] < leaves
    else:
        assert sizes[1] == want


def test_pool_downgrades_the_wave(caplog):
    caplog.set_level(logging.WARNING)
    X, y = _reg(1500)
    params = dict(POOL, verbosity=0, tree_grow_policy="wave",
                  histogram_pool_size=0.02)
    bj, bp = _train_both(params, X, y, 3)
    assert bp._grow_policy == "leafwise"
    assert bp._grower_spec.hist_pool_slots > 0
    assert "tree_grow_policy=wave is not supported with histogram_pool_size" \
        in caplog.text
    assert bp.model_to_string() == bj.model_to_string()


def test_intermediate_monotone_ignores_the_pool(caplog):
    caplog.set_level(logging.WARNING)
    X, y = _reg(1500)
    params = dict(POOL, verbosity=0, histogram_pool_size=0.02,
                  monotone_constraints=[1, -1],
                  monotone_constraints_method="intermediate")
    bj, bp = _train_both(params, X, y, 3)
    assert bp._grower_spec.hist_pool_slots == 0
    assert "ignoring histogram_pool_size" in caplog.text
    assert bp.model_to_string() == bj.model_to_string()
