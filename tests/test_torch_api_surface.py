"""The rest of the port's Booster and scikit-learn API against the live
JAX package, on the CPU (mirrors tests/test_api_surface.py).

Equal to the reference's: `save_model`, `dump_model`,
`model_fingerprint` and `trees_to_dataframe`; attributes, bounds, leaf
outputs (and the scores rebuilt after `set_leaf_output`),
`shuffle_models`, `get_split_value_histogram`, `free_dataset`,
`num_model_per_iteration`, `feature_name`, `set_train_data_name`;
pickling, `copy` and `deepcopy`; `LGBMRegressor` and `LGBMClassifier`
(model text, predictions, fitted attributes, eval results) with
scikit-learn installed and with its import hidden.
"""
import copy
import importlib
import pickle
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

CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """ROADMAP Queue 3 (f): one intra-op thread for the links."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _text(bst):
    return bst.model_to_string().replace("[device_type: cpu]\n", "")


def _body(text):
    return "\n".join(ln for ln in text.splitlines() if not ln.startswith("["))


def _reg_data(seed=9, n=600):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4)
    y = X[:, 0] - 0.5 * X[:, 1] + 0.1 * rng.randn(n)
    return X, y


PARAMS = {"objective": "regression", "num_leaves": 7, "verbosity": -1}


@pytest.fixture(scope="module")
def pair():
    """The same 8-round regression model trained by both packages."""
    X, y = _reg_data()
    bj = lgb.train(dict(PARAMS), lgb.Dataset(X, label=y,
                                              free_raw_data=False), 8)
    bp = lt.train(dict(PARAMS, **CPU), lt.Dataset(X, label=y,
                                                  free_raw_data=False), 8)
    return bj, bp, X, y


def test_model_io_is_the_reference(pair, tmp_path):
    bj, bp, X, _ = pair
    assert _text(bp) == _text(bj)
    path = str(tmp_path / "m.txt")
    assert bp.save_model(path) is bp
    with open(path) as f:
        assert f.read() == bp.model_to_string()
    back = lt.Booster(model_file=path)
    assert back.current_iteration() == 8
    assert np.array_equal(back.predict(X), bp.predict(X))
    assert bp.save_model(path, num_iteration=3) is bp
    assert lt.Booster(model_file=path).num_trees() == 3
    assert bp.dump_model() == bj.dump_model()
    assert bp.dump_model(num_iteration=2, start_iteration=1) == \
        bj.dump_model(num_iteration=2, start_iteration=1)
    assert bp.model_fingerprint() == bj.model_fingerprint()
    assert back.model_fingerprint() == bp.model_fingerprint()


def test_model_io_categorical_and_multiclass():
    rng = np.random.RandomState(4)
    X = rng.randn(900, 4)
    X[:, 3] = rng.randint(0, 6, 900)
    y = np.digitize(X[:, 0] + (X[:, 3] % 2), [0.0, 1.0]).astype(float)
    params = {"objective": "multiclass", "num_class": 3, "num_leaves": 7,
              "verbosity": -1, "min_data_per_group": 5}

    def run(m, extra):
        return m.train(dict(params, **extra),
                       m.Dataset(X, label=y, categorical_feature=[3]), 3)

    bj, bp = run(lgb, {}), run(lt, CPU)
    assert _text(bp) == _text(bj)
    assert bp.dump_model() == bj.dump_model()
    assert bp.model_fingerprint() == bj.model_fingerprint()
    assert bp.trees_to_dataframe().equals(bj.trees_to_dataframe())
    assert bp.num_model_per_iteration() == bj.num_model_per_iteration() == 3


def test_trees_to_dataframe(pair):
    bj, bp, _, _ = pair
    df = bp.trees_to_dataframe()
    assert df.equals(bj.trees_to_dataframe())
    n_leaves = sum(t.num_leaves for t in bp.trees)
    assert len(df) == n_leaves + sum(t.num_internal() for t in bp.trees)
    ids = set(df["node_index"])
    assert set(p for p in df["parent_index"] if isinstance(p, str)) <= ids


def test_attrs_bounds_and_names(pair):
    bj, bp, X, _ = pair
    bp.set_attr(foo="bar", n=3)
    assert bp.get_attr("foo") == "bar" and bp.get_attr("n") == "3"
    bp.set_attr(foo=None)
    assert bp.get_attr("foo") is None
    raw = bp.predict(X, raw_score=True)
    assert bp.lower_bound() == bj.lower_bound() <= raw.min()
    assert bp.upper_bound() == bj.upper_bound() >= raw.max()
    assert bp.feature_name() == bj.feature_name() == \
        [f"Column_{i}" for i in range(4)]
    assert bp.num_model_per_iteration() == 1
    assert bp.set_train_data_name("tr") is bp
    assert bp.eval_train()[0][0] == "tr"


def test_split_value_histogram(pair):
    bj, bp, _, _ = pair
    for feature, bins in ((0, None), ("Column_1", 3), (0, 100)):
        h, e = bp.get_split_value_histogram(feature, bins=bins)
        hj, ej = bj.get_split_value_histogram(feature, bins=bins)
        assert np.array_equal(h, hj) and np.array_equal(e, ej)
    xgb = bp.get_split_value_histogram(0, xgboost_style=True)
    assert xgb.equals(bj.get_split_value_histogram(0, xgboost_style=True))
    assert np.asarray(xgb)[:, 1].sum() == h.sum()


def test_leaf_output_roundtrip_and_score_rebuild():
    X, y = _reg_data()

    def run(m, extra):
        bst = m.train(dict(PARAMS, **extra), m.Dataset(X, label=y), 5,
                      valid_sets=[m.Dataset(X[:200], label=y[:200])])
        v = bst.get_leaf_output(0, 0)
        bst.set_leaf_output(0, 0, v + 1.0)
        assert bst.get_leaf_output(0, 0) == v + 1.0
        p1 = bst.predict(X, raw_score=True)
        bst.set_leaf_output(2, 1, bst.get_leaf_output(2, 1) - 0.25)
        ev = bst.eval_train() + bst.eval_valid()
        bst.update()
        return bst, p1, ev

    (bj, pj, ej), (bp, pp, ep) = run(lgb, {}), run(lt, CPU)
    assert np.array_equal(pp, pj)
    assert ep == ej
    assert _text(bp) == _text(bj)
    assert np.array_equal(bp._train_score.numpy(), np.asarray(bj._train_score))
    assert np.array_equal(bp._valid_scores[0].numpy(),
                          np.asarray(bj._valid_scores[0]))


def test_shuffle_models_is_the_reference():
    X, y = _reg_data(2, 400)
    out = []
    for m, extra in ((lgb, {}), (lt, CPU)):
        bst = m.train(dict(PARAMS, **extra), m.Dataset(X, label=y), 8)
        p0 = bst.predict(X)
        np.random.seed(0)
        assert bst.shuffle_models(start_iteration=1) is bst
        np.testing.assert_allclose(bst.predict(X), p0, rtol=1e-6)
        out.append(_text(bst))
    assert out[1] == out[0]


def test_free_dataset_blocks_training_not_predict():
    X, y = _reg_data(3, 300)
    bst = lt.train(dict(PARAMS, **CPU), lt.Dataset(X, label=y), 2)
    text = bst.model_to_string()
    assert bst.free_dataset() is bst
    assert np.isfinite(bst.predict(X)).all()
    assert bst.model_to_string() == text
    assert bst.feature_name() == [f"Column_{i}" for i in range(4)]
    for call in (bst.update, bst.eval_train, bst.rollback_one_iter):
        with pytest.raises(lt.LightGBMError, match="free_dataset"):
            call()


def test_pickle_copy_and_deepcopy(pair):
    _, bp, X, _ = pair
    back = pickle.loads(pickle.dumps(bp))
    assert back.best_iteration == bp.best_iteration == 8
    assert back.model_to_string() == bp.model_to_string()
    assert np.array_equal(back.predict(X), bp.predict(X))
    for dup in (copy.copy(bp), copy.deepcopy(bp)):
        assert dup is not bp and dup.trees[0] is not bp.trees[0]
        assert np.array_equal(dup.predict(X), bp.predict(X))


# ------------------------------------------------------------- sklearn
def _cls_data(n_class, seed=1, n=500):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4)
    z = X[:, 0] + 0.4 * X[:, 1] * X[:, 2]
    labels = np.array(["a", "b", "c"])[:n_class]
    return X, labels[np.digitize(z, np.linspace(-0.6, 0.6, n_class - 1))]


def _mean_pred(y_true, y_pred):
    return "mean_pred", float(np.mean(y_pred)), False


@pytest.fixture
def hidden_sklearn(monkeypatch):
    """The port's sklearn module reloaded with scikit-learn's import
    hidden, as on a machine without it; restored after."""
    for name in list(sys.modules):
        if name == "sklearn" or name.startswith("sklearn."):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    import lightgbm_tpu_torch.sklearn as mod
    hidden = importlib.reload(mod)
    assert not hidden._SKLEARN
    yield hidden
    monkeypatch.undo()
    importlib.reload(mod)


def _fit_both(cls_name, X, y, port_module, metric="l1"):
    kw = {"n_estimators": 5, "num_leaves": 7, "verbosity": -1}
    fit = {"eval_set": [(X[:150], y[:150])],
           "eval_metric": [metric, _mean_pred]}
    ref = getattr(ref_sklearn, cls_name)(**kw).fit(X, y, **fit)
    ours = getattr(port_module, cls_name)(device_type="cpu", **kw).fit(
        X, y, **fit)
    return ref, ours


@pytest.mark.parametrize("hide", [False, True], ids=["sklearn", "hidden"])
def test_regressor(hide, request):
    module = request.getfixturevalue("hidden_sklearn") if hide \
        else importlib.import_module("lightgbm_tpu_torch.sklearn")
    X, y = _reg_data()
    ref, ours = _fit_both("LGBMRegressor", X, y, module)
    if hide:
        assert _body(_text(ours.booster_)) == _body(_text(ref.booster_))
    else:
        assert _text(ours.booster_) == _text(ref.booster_)
    assert np.array_equal(ours.predict(X), ref.predict(X))
    assert ours.evals_result_ == ref.evals_result_
    assert ours.best_score_ == ref.best_score_
    assert ours.n_features_ == ours.n_features_in_ == 4
    assert ours.n_estimators_ == ours.n_iter_ == 5
    assert np.array_equal(ours.feature_importances_, ref.feature_importances_)
    assert list(ours.feature_names_in_) == ours.feature_name_
    assert ours.objective_ == "regression"


@pytest.mark.parametrize("hide,n_class", [(False, 2), (False, 3),
                                          (True, 2), (True, 3)],
                         ids=["sklearn-binary", "sklearn-multiclass",
                              "hidden-binary", "hidden-multiclass"])
def test_classifier(hide, n_class, request):
    module = request.getfixturevalue("hidden_sklearn") if hide \
        else importlib.import_module("lightgbm_tpu_torch.sklearn")
    X, y = _cls_data(n_class)
    ref, ours = _fit_both("LGBMClassifier", X, y, module,
                          "binary_error" if n_class == 2 else "multi_error")
    if hide:
        assert _body(_text(ours.booster_)) == _body(_text(ref.booster_))
    else:
        assert _text(ours.booster_) == _text(ref.booster_)
    proba = ours.predict_proba(X)
    assert np.array_equal(proba, ref.predict_proba(X))
    p = ours.booster_.predict(X)
    assert np.array_equal(proba, np.vstack([1.0 - p, p]).T
                          if n_class == 2 else p)
    assert np.array_equal(ours.predict(X), ref.predict(X))
    assert np.array_equal(ours.predict(X, raw_score=True),
                          ref.predict(X, raw_score=True))
    assert list(ours.classes_) == list(ref.classes_)
    assert ours.n_classes_ == n_class
    assert ours.evals_result_ == ref.evals_result_
    assert ours.objective_ == ("binary" if n_class == 2 else "multiclass")


def test_estimator_refusals_and_unfitted():
    from lightgbm_tpu_torch.sklearn import (LGBMClassifier, LGBMRanker,
                                            LGBMRegressor)
    X, y = _reg_data()
    with pytest.raises(lt.LightGBMError, match="not fitted"):
        LGBMRegressor().n_iter_
    # the ranker trains since item 5d (tests/test_torch_ranking.py);
    # without groups it raises, as the reference's does
    with pytest.raises(ValueError, match="Should set group"):
        LGBMRanker(device_type="cpu").fit(X, y)
    # a custom objective trains as the reference's estimator does
    def l2(y_true, y_pred):
        return y_pred - y_true, np.ones_like(y_pred)

    ours = LGBMRegressor(objective=l2, n_estimators=4, device_type="cpu",
                         verbosity=-1).fit(X, y)
    ref = ref_sklearn.LGBMRegressor(objective=l2, n_estimators=4,
                                    device_type="cpu", verbosity=-1)
    ref.fit(X, y)
    assert ours.booster_.model_to_string() == \
        ref.booster_.model_to_string()
    assert np.array_equal(ours.predict(X), ref.predict(X))
    m = LGBMClassifier(n_estimators=2, device_type="cpu", verbosity=-1)
    m.fit(X, (y > 0).astype(int))
    leaves = m.predict(X, pred_leaf=True)
    assert leaves.dtype == np.int32 and leaves.shape == (len(X), 2)
    assert np.array_equal(leaves, m.booster_.predict(X, pred_leaf=True))
    with pytest.raises(ValueError, match="n_features"):
        m.predict(X[:, :3])


def test_estimators_train_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _reg_data()
    with pytest.raises(lt.LightGBMError, match="no CUDA device"):
        lt.LGBMRegressor(n_estimators=2).fit(X, y)
