"""EFB-bundled training in the port against the JAX package, on the CPU.

* `build_bundled` bitwise the reference's, conflicting rows included
  (the last member in feature order wins);
* the bundle expansion and decode (`ops/grow.py make_bundled_expander`,
  `feature_bins`) bitwise the reference's `make_bundled_expander` on
  random bundle histograms;
* bundled `lt.train` against the live `lgb.train`, model text byte for
  byte, under both growers, f32 and quantized: on one-hot data, and on
  one-hot data beside a categorical column; the wave runs unfused (the
  reference's reason "EFB bundling"), on the bundle columns;
* a bundled run with a validation set and early stopping, as the
  reference trains it;
* bundled against unbundled under the reference's own quality gate
  (`tests/test_efb.py`): the expanded zero bin is parent minus the rest,
  so tied candidates may flip, and only the log loss is compared.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu.ops.grow import GrowerSpec as JGrowerSpec  # noqa: E402
from lightgbm_tpu.ops.grow import \
    make_bundled_expander as jax_expander  # noqa: E402
from lightgbm_tpu.utils import efb as jefb  # noqa: E402
from lightgbm_tpu_torch.ops.grow import (GrowerSpec, feature_bins,  # noqa
                                         make_bundled_expander)
from lightgbm_tpu_torch.utils import efb as tefb  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as in test_torch_train.py (ROADMAP Queue 3
    (f)): the trainings go through sigmoid."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def make_onehot(n, seed, groups=(5, 7, 4), cat_col=False):
    """Three dense columns, one-hot groups (mutually exclusive 0/1
    columns) and, with `cat_col`, a 12-level categorical column last."""
    rng = np.random.RandomState(seed)
    num = rng.randn(n, 3)
    cols, score = [num], num[:, 0] - 0.5 * num[:, 1]
    for k in groups:
        lev = rng.randint(0, k, n)
        oh = np.zeros((n, k))
        oh[np.arange(n), lev] = 1.0
        cols.append(oh)
        score = score + rng.randn(k)[lev]
    if cat_col:
        c = rng.randint(0, 12, n).astype(np.float64)
        cols.append(c[:, None])
        score = score + (c % 3 == 0)
    X = np.concatenate(cols, axis=1)
    y = (score + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def _bins_and_specs(X, y, rate=0.0, **kw):
    """Both packages' bin matrices and bundle searches on X."""
    out = []
    for pkg, efb in ((lgb, jefb), (lt, tefb)):
        ds = pkg.Dataset(X, label=y, params={"enable_bundle": False},
                         **kw).construct()
        bins = np.asarray(ds.bin_data)
        out.append((bins, ds.bin_mappers,
                    efb.find_bundles(bins, ds.bin_mappers, rate)))
    return out


def test_build_bundled_matches_with_conflicts():
    """A 5% conflict budget bundles columns that overlap: the rows where
    two members are nonzero keep the last member, in both packages."""
    rng = np.random.RandomState(2)
    n = 4000
    X = np.zeros((n, 12))
    for j in range(12):
        hit = rng.rand(n) < 0.04
        X[hit, j] = rng.randint(1, 6, hit.sum())
    X[:, 11] = rng.randn(n)
    y = rng.randn(n)
    (jb, _, js), (tb, _, ts) = _bins_and_specs(X, y, rate=0.05)
    assert js is not None and ts.to_dict() == js.to_dict()
    conflicts = 0
    for b in ts.bundles:
        conflicts += int(((tb[:, list(b)] != 0).sum(axis=1) > 1).sum())
    assert conflicts > 0
    got = tefb.build_bundled(tb, ts)
    want = jefb.build_bundled(jb, js)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_dataset_bundles_like_the_reference():
    X, y = make_onehot(1500, 1, cat_col=True)
    dj = lgb.Dataset(X, label=y, categorical_feature=[X.shape[1] - 1])
    dt = lt.Dataset(X, label=y, categorical_feature=[X.shape[1] - 1])
    dj.construct()
    dt.construct()
    assert dt.efb.to_dict() == dj.efb.to_dict()
    assert np.array_equal(dt.bundle_data, dj.bundle_data)
    valid = dt.create_valid(X[:100], label=y[:100]).construct()
    assert valid.efb is dt.efb and valid.bundle_data is None


def _feat(spec, mappers, mod):
    nb = np.array([m.num_bin for m in mappers], np.int32)
    arr = jnp.asarray if mod == "jax" else (
        lambda a: torch.from_numpy(np.asarray(a)))
    feat = dict(nb=arr(nb),
                bundle_col=arr(spec.col_of_feature.astype(
                    np.int32 if mod == "jax" else np.int64)),
                bundle_off=arr(spec.off_of_feature.astype(
                    np.int32 if mod == "jax" else np.int64)),
                bundle_identity=arr(np.asarray(spec.identity, bool)))
    if mod != "jax":
        feat.update(nb_np=nb, bundle_col_np=spec.col_of_feature,
                    bundle_off_np=spec.off_of_feature)
    return feat


def test_expand_and_decode_match_the_reference():
    """Random [G, HB, 3] bundle histograms of three leaves (one batched
    expansion in the port) against the reference's expansion per leaf,
    bitwise; every feature's decoded bins against the reference's."""
    X, y = make_onehot(2500, 3, groups=(9, 5, 30), cat_col=True)
    (jb, jm, js), (tb, tm, ts) = _bins_and_specs(
        X, y, categorical_feature=[X.shape[1] - 1])
    mb = max(m.num_bin for m in tm)
    hb = ts.max_bin
    kw = dict(num_leaves=7, max_depth=-1, max_bin=mb, lambda_l1=0.0,
              lambda_l2=0.0, min_data_in_leaf=1.0,
              min_sum_hessian_in_leaf=0.0, min_gain_to_split=0.0,
              max_delta_step=0.0, bundled=True, bundle_max_bin=hb)
    jexp, jdec = jax_expander(JGrowerSpec(**kw), _feat(js, jm, "jax"))
    texp, bundle_of = make_bundled_expander(GrowerSpec(**kw),
                                            _feat(ts, tm, "torch"))
    rng = np.random.RandomState(4)
    hg = (rng.randn(3, ts.n_cols, hb, 3) * 10).astype(np.float32)
    parent = (rng.randn(3, 3) * 100).astype(np.float32)
    got = texp(torch.from_numpy(hg), torch.from_numpy(parent)).numpy()
    for i in range(3):
        want = np.asarray(jexp(jnp.asarray(hg[i]), *map(jnp.float32,
                                                         parent[i])))
        assert np.array_equal(got[i].view(np.int32), want.view(np.int32)), i
    bundled = tefb.build_bundled(tb, ts)
    bfm = torch.from_numpy(np.ascontiguousarray(bundled.T))
    jfm = jnp.asarray(np.ascontiguousarray(bundled.T))
    for f in range(tb.shape[1]):
        dec = feature_bins(bfm, f, bundle_of(f)).numpy()
        assert np.array_equal(dec, np.asarray(jdec(jfm, f))), f
        assert np.array_equal(dec, tb[:, f].astype(np.int32)), f


POLICIES = [("leafwise", False), ("wave", False), ("leafwise", True),
            ("wave", True)]
POLICY_IDS = ["strict", "wave", "strict_quant", "wave_quant"]


@pytest.mark.parametrize("cat_col", [False, True],
                         ids=["onehot", "onehot_and_categorical"])
@pytest.mark.parametrize("policy,quant", POLICIES, ids=POLICY_IDS)
def test_bundled_training_byte_identical(policy, quant, cat_col):
    X, y = make_onehot(3000, 5, cat_col=cat_col)
    kw = {"categorical_feature": [X.shape[1] - 1]} if cat_col else {}
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "device_type": "cpu", "tree_grow_policy": policy}
    if quant:
        params["use_quantized_grad"] = True
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y, **kw),
                   num_boost_round=5)
    bp = lt.train(dict(params), lt.Dataset(X, label=y, **kw),
                  num_boost_round=5)
    assert bp.train_set.efb is not None and len(bp.train_set.efb.bundles) == 3
    assert bp._grower_spec.bundled and not bp._grower_spec.fused
    assert bp.model_to_string() == bj.model_to_string()
    if cat_col:
        assert sum(t.num_cat for t in bp.trees) > 0


def test_bundled_with_valid_and_early_stopping():
    """The reference's `test_bundled_with_valid_and_early_stopping`, both
    packages: the same best iteration, trees and validation AUC."""
    X, y = make_onehot(3000, 2, groups=(40,))
    Xv, yv = make_onehot(800, 3, groups=(40,))
    out = []
    for pkg in (lgb, lt):
        bst = pkg.train({"objective": "binary", "num_leaves": 15,
                         "metric": "auc", "verbosity": -1,
                         "device_type": "cpu"},
                        pkg.Dataset(X, label=y), num_boost_round=40,
                        valid_sets=[pkg.Dataset(Xv, label=yv)],
                        callbacks=[pkg.early_stopping(5, verbose=False)])
        out.append(bst)
    bj, bp = out
    assert bp.train_set.efb is not None
    assert bp.best_iteration == bj.best_iteration > 0
    np.testing.assert_allclose(bp.best_score["valid_0"]["auc"],
                               bj.best_score["valid_0"]["auc"], rtol=1e-6)
    assert bp.model_to_string() == bj.model_to_string()
    p = bp.predict(Xv)
    assert np.mean(p[yv > 0]) > np.mean(p[yv == 0])


@pytest.mark.parametrize("policy", ["leafwise", "wave"])
def test_bundled_and_unbundled_agree_in_quality(policy):
    """The reference's quality gate between its bundled and unbundled
    models (`tests/test_efb.py`), on the port: log loss within 0.01."""
    X, y = make_onehot(3000, 0, groups=(40,))
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 20, "device_type": "cpu",
              "tree_grow_policy": policy}
    on = lt.train(dict(params, enable_bundle=True), lt.Dataset(X, label=y),
                  num_boost_round=10)
    off = lt.train(dict(params, enable_bundle=False),
                   lt.Dataset(X, label=y), num_boost_round=10)
    assert on.train_set.efb is not None and off.train_set.efb is None

    def logloss(b):
        p = np.clip(b.predict(X), 1e-7, 1 - 1e-7)
        return -np.mean(y * np.log(p) + (1 - y) * np.log(1 - p))

    assert abs(logloss(on) - logloss(off)) < 0.01
