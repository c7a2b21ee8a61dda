"""DART, random forests and custom objectives against the JAX package, on
the CPU.

  * DART (`drop_rate`, `skip_drop`, `max_drop`, `xgboost_dart_mode`),
    under both growers, with a validation set: model text byte for byte,
    the train and valid scores bitwise the reference's after every drop,
    rescale and re-add, the dropped iterations of each round the
    reference's draw, and the running train score the sum of the stored
    trees (`test_dart_internal_external_consistency`);
  * random forests: bagging required (raises otherwise, as the
    reference), model text byte for byte with `average_output`, and a
    text round trip predicting bitwise;
  * custom objectives: `fobj` through `train(params={"objective": fn})`,
    through `update(fobj=)` on a booster of objective "none" (also with
    three classes, the scores and gradients class-major), and through
    the estimators' `_ObjectiveFunctionWrapper`, each byte for byte; with
    `use_quantized_grad` the reference's f32 fallback and its warning.
Mirrors the DART, RF and custom-objective tests of
tests/test_boosting_modes.py.
"""
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu.sklearn as ref_sklearn  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402

REG = {"objective": "regression", "num_leaves": 15, "verbosity": -1,
       "device_type": "cpu"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _reg(n=1200, f=8, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = 2 * X[:, 0] + np.sin(2 * X[:, 1]) + 0.3 * X[:, 2] ** 2 \
        + 0.1 * rng.randn(n)
    return X, y


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


DART = {
    "plain": {"drop_rate": 0.3},
    "skip": {"drop_rate": 0.5, "skip_drop": 0.7},
    "xgboost_max_drop": {"drop_rate": 0.6, "skip_drop": 0.0, "max_drop": 2,
                         "xgboost_dart_mode": True},
    "binary": {"objective": "binary", "drop_rate": 0.4, "skip_drop": 0.2},
}


@pytest.mark.parametrize("policy", ["leafwise", "wave"])
@pytest.mark.parametrize("name", list(DART))
def test_dart_matches_with_a_valid_set(name, policy):
    X, y = _reg()
    Xv, yv = _reg(400, seed=8)
    if name == "binary":
        y, yv = (y > y.mean()).astype(float), (yv > y.mean()).astype(float)
    params = dict(REG, boosting="dart", tree_grow_policy=policy,
                  learning_rate=0.3, **DART[name])
    out = []
    for m in (lgb, lt):
        ds = m.Dataset(X, label=y)
        bst = m.Booster(dict(params), ds)
        bst.add_valid(ds.create_valid(Xv, label=yv), "v")
        drops = []
        for _ in range(8):
            bst.update()
            if m is lt:
                drops.append(list(bst.dart_dropped))
        out.append((bst, drops))
    (bj, _), (bp, drops) = out
    assert bp.model_to_string() == bj.model_to_string()
    assert np.array_equal(_bits(bp._train_score), _bits(bj._train_score))
    assert np.array_equal(_bits(bp._valid_scores[0]),
                          _bits(bj._valid_scores[0]))
    assert sum(len(d) for d in drops) > 0
    if name == "xgboost_max_drop":
        assert max(len(d) for d in drops) <= 2


def test_dart_internal_external_consistency():
    """After drops and rescales the running train score is the sum of the
    stored trees (the reference's test, on the port)."""
    X, y = _reg(600)
    bst = lt.train(dict(REG, boosting="dart", drop_rate=0.5),
                   lt.Dataset(X, label=y), 15)
    internal = bst._train_score.numpy().astype(np.float64)
    np.testing.assert_allclose(internal, bst.predict(X, raw_score=True),
                               atol=1e-4)
    # and the model text round trip predicts bitwise
    again = lt.Booster(model_str=bst.model_to_string())
    assert np.array_equal(again.predict(X), bst.predict(X))


RF = {"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.7,
      "feature_fraction": 0.8}


@pytest.mark.parametrize("policy", ["leafwise", "wave"])
@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_rf_matches_and_round_trips(objective, policy):
    X, y = _reg()
    if objective == "binary":
        y = (y > y.mean()).astype(float)
    params = dict(REG, objective=objective, tree_grow_policy=policy, **RF)
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y), 6)
    bp = lt.train(dict(params), lt.Dataset(X, label=y), 6)
    text = bp.model_to_string()
    assert text == bj.model_to_string()
    assert "\naverage_output\n" in text
    assert all(t.shrinkage == 1.0 for t in bp.trees)
    again = lt.Booster(model_str=text)
    assert np.array_equal(again.predict(X), bp.predict(X))
    assert np.array_equal(bp.predict(X), bj.predict(X))


def test_rf_requires_bagging():
    X, y = _reg(300)
    for m in (lgb, lt):
        with pytest.raises(m.LightGBMError, match="bagging"):
            m.train(dict(REG, boosting="rf"), m.Dataset(X, label=y), 2)


def _logloss(preds, ds):
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - ds.get_label(), p * (1.0 - p)


def _l2(preds, ds):
    return preds - ds.get_label(), np.ones_like(preds)


@pytest.mark.parametrize("policy", ["leafwise", "wave"])
@pytest.mark.parametrize("fn", [_logloss, _l2], ids=["logloss", "l2"])
def test_fobj_through_train_matches(fn, policy):
    X, y = _reg()
    if fn is _logloss:
        y = (y > y.mean()).astype(float)
    params = dict(REG, objective=fn, tree_grow_policy=policy)
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y), 5)
    bp = lt.train(dict(params), lt.Dataset(X, label=y), 5)
    assert bp.objective_ is None
    assert bp.model_to_string() == bj.model_to_string()
    assert np.array_equal(_bits(bp._train_score), _bits(bj._train_score))


def test_fobj_through_update_matches():
    X, y = _reg()
    params = dict(REG, objective="none")
    texts = []
    for m in (lgb, lt):
        bst = m.Booster(dict(params), m.Dataset(X, label=y))
        for _ in range(4):
            bst.update(fobj=_l2)
        texts.append(bst.model_to_string())
    assert texts[0] == texts[1]
    bst = lt.Booster(dict(params), lt.Dataset(X, label=y))
    with pytest.raises(lt.LightGBMError, match="fobj"):
        bst.update()
    # three classes: the scores go out and the gradients come back
    # class-major
    yk = np.digitize(X[:, 0] + X[:, 1], [-0.7, 0.7]).astype(float)

    def softmax(preds, ds):
        lab = ds.get_label().astype(int)
        p = preds.reshape(-1, 3, order="F")
        p = np.exp(p - p.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        g = p.copy()
        g[np.arange(len(lab)), lab] -= 1.0
        return g.reshape(-1, order="F"), \
            (2.0 * p * (1.0 - p)).reshape(-1, order="F")

    texts = []
    for m in (lgb, lt):
        bst = m.Booster(dict(params, num_class=3), m.Dataset(X, label=yk))
        for _ in range(3):
            bst.update(fobj=softmax)
        texts.append(bst.model_to_string())
    assert texts[0] == texts[1]
    assert texts[1].count("Tree=") == 9


def test_fobj_quantized_takes_the_f32_histograms(caplog):
    caplog.set_level(logging.WARNING)
    X, y = _reg()
    params = dict(REG, objective=_l2, use_quantized_grad=True, verbosity=0)
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y), 3)
    bp = lt.train(dict(params), lt.Dataset(X, label=y), 3)
    assert bp.hist_impl == "kernel"
    assert "custom objective" in caplog.text
    assert bp.model_to_string() == bj.model_to_string()


def test_fobj_through_the_estimators():
    X, y = _reg(600)

    def custom(y_true, y_pred):
        return y_pred - y_true, np.ones_like(y_pred)

    def weighted(y_true, y_pred, weight):
        return (y_pred - y_true) * weight, weight

    w = np.random.RandomState(1).rand(len(y)) + 0.5
    for fn, kw in ((custom, {}), (weighted, {"sample_weight": w})):
        ours = lt.LGBMRegressor(n_estimators=8, objective=fn,
                                device_type="cpu", verbosity=-1)
        ref = ref_sklearn.LGBMRegressor(n_estimators=8, objective=fn,
                                        device_type="cpu", verbosity=-1)
        ours.fit(X, y, **kw)
        ref.fit(X, y, **kw)
        assert ours.booster_.model_to_string() == \
            ref.booster_.model_to_string()
        assert np.array_equal(ours.predict(X), ref.predict(X))
    yc = (y > y.mean()).astype(int)

    def logloss(y_true, y_pred):
        p = 1.0 / (1.0 + np.exp(-y_pred))
        return p - y_true, p * (1.0 - p)

    ours = lt.LGBMClassifier(n_estimators=5, objective=logloss,
                             device_type="cpu", verbosity=-1).fit(X, yc)
    ref = ref_sklearn.LGBMClassifier(n_estimators=5, objective=logloss,
                                     device_type="cpu",
                                     verbosity=-1).fit(X, yc)
    # a custom objective's classifier returns raw scores
    raw = ours.predict(X)
    assert np.array_equal(raw, ref.predict(X))
    assert np.array_equal(raw, ours.booster_.predict(X, raw_score=True))
