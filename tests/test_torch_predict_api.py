"""`Booster.predict`'s options in the port against the live JAX package,
on the CPU, on the same model texts and rows.

Models come from the reference: binary, regression (L2), multiclass (3
classes), categorical with NaN rows, and a random forest
(`boosting=rf`), each loaded from its text into both packages.  Held
bitwise: `pred_leaf` (int32), `pred_contrib` (f64; each class block
also sums to the raw score, within the f32 rounding of the model's
hessian weights), prediction early stop (the
reference's cases, and params reloaded from text), and `device_predict`
raw and converted (the port's program with the plain versions, under
`device_type="cpu"`, against the reference's jitted scan on JAX's CPU),
also in chunks; the f32 sum's plain version against a numpy f32 loop;
the refusals; the estimators' `pred_leaf` and `pred_contrib`.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch import booster as lt_booster  # noqa: E402
from lightgbm_tpu_torch.ops.predict import (  # noqa: E402
    accumulate_slots_f32, accumulate_slots_f32_plain)

CPU = {"device_type": "cpu"}
MODELS = ("binary", "regression", "multiclass", "categorical", "rf")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """ROADMAP Queue 3 (f): one intra-op thread for the links."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _data(name, n=600, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    params = {"num_leaves": 15, "verbosity": -1, "min_data_in_leaf": 5}
    cats = []
    if name == "multiclass":
        y = (X[:, 0] > 0.4).astype(float) + (X[:, 1] > 0).astype(float)
        params.update(objective="multiclass", num_class=3)
    elif name == "regression":
        y = X[:, 0] - 0.5 * X[:, 1] + 0.1 * rng.randn(n)
        params.update(objective="regression")
    else:
        y = (X[:, 0] - 0.6 * X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
        params.update(objective="binary")
    if name == "categorical":
        X[:, 2] = rng.randint(0, 12, n)
        y = ((np.isin(X[:, 2], [1, 4, 7, 9]) + 0.3 * X[:, 0]) > 0.5
             ).astype(float)
        X[rng.rand(n, 6) < 0.08] = np.nan
        cats = [2]
    if name == "rf":
        params.update(boosting="rf", bagging_fraction=0.7, bagging_freq=1)
    return X, y, params, cats


def _rows(name, X, seed=11):
    """The rows predicted: fresh draws, NaNs, zeros, huge values that
    saturate in the f32 cast; for the categorical model unseen, negative
    and out-of-range categories."""
    rng = np.random.RandomState(seed)
    R = rng.randn(300, X.shape[1])
    R[rng.rand(*R.shape) < 0.05] = np.nan
    R[rng.rand(*R.shape) < 0.03] = 0.0
    R[:4, 0] = [1e300, -1e300, np.inf, -np.inf]
    if name == "categorical":
        R[:, 2] = rng.randint(0, 12, len(R))
        R[10:20, 2] = 99
        R[20:30, 2] = -0.5
        R[30:40, 2] = np.nan
        R[40:45, 2] = 1e300
    return np.vstack([X[:100], R])


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in MODELS:
        X, y, params, cats = _data(name)
        ref = lgb.train(params, lgb.Dataset(X, label=y,
                                            categorical_feature=cats),
                        num_boost_round=10)
        text = ref.model_to_string()
        out[name] = (lgb.Booster(model_str=text), lt.Booster(model_str=text),
                     _rows(name, X))
    assert any(t.num_cat > 0 for t in out["categorical"][1].trees)
    assert out["rf"][1]._average_output
    return out


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view({8: np.uint64, 4: np.uint32}[a.dtype.itemsize]),
        b.view({8: np.uint64, 4: np.uint32}[b.dtype.itemsize]))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("start,num", [(0, None), (2, 5), (3, -1)])
def test_pred_leaf_equals_the_reference(models, name, start, num):
    ref, ours, X = models[name]
    want = ref.predict(X, pred_leaf=True, start_iteration=start,
                       num_iteration=num)
    got = ours.predict(X, pred_leaf=True, start_iteration=start,
                       num_iteration=num)
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("name", MODELS)
def test_pred_contrib_bitwise_and_locally_accurate(models, name):
    ref, ours, X = models[name]
    X = X[90:110]
    got = ours.predict(X, pred_contrib=True)
    assert _bits(got, ref.predict(X, pred_contrib=True))
    # local accuracy: each class block sums to the raw score.  Exactly
    # (1e-9) where the node weights are exact (integer hessians: L2);
    # else the weights are f32 hessian sums, a node's not quite its
    # children's sum, and the blocks agree to that rounding (up to 2.8e-8
    # measured here, the same bits in the reference): within 1e-6.  A
    # random forest's contributions are not averaged (the reference's
    # TreeSHAP sums its trees), so its blocks sum to raw x iterations.
    K = ours.num_tree_per_iteration
    raw = ours.predict(X, raw_score=True).reshape(len(X), K)
    if ours._average_output:
        raw = raw * (ours.num_trees() // K)
    blocks = got.reshape(len(X), K, X.shape[1] + 1).sum(axis=2)
    np.testing.assert_allclose(blocks, raw, rtol=0,
                               atol=1e-9 if name == "regression" else 1e-6)


@pytest.mark.parametrize("name,kw", [
    ("binary", dict(pred_early_stop_freq=5, pred_early_stop_margin=8.0)),
    ("binary", dict(pred_early_stop_freq=1, pred_early_stop_margin=0.5)),
    ("multiclass", dict(pred_early_stop_freq=3, pred_early_stop_margin=6.0)),
    ("multiclass", dict(pred_early_stop_freq=1, pred_early_stop_margin=0.3)),
    ("regression", {}),
])
def test_early_stop_bitwise(models, name, kw):
    ref, ours, X = models[name]
    for raw in (True, False):
        want = ref.predict(X, pred_early_stop=True, raw_score=raw, **kw)
        got = ours.predict(X, pred_early_stop=True, raw_score=raw, **kw)
        assert _bits(got, want)
    if kw.get("pred_early_stop_margin", 10) < 1:        # the stop fired
        assert not np.array_equal(got, ours.predict(X))


def test_early_stop_from_params_reloaded_from_text(models):
    X, y, params, _ = _data("binary")
    params = dict(params, pred_early_stop=True, pred_early_stop_freq=2,
                  pred_early_stop_margin=1.5)
    text = lgb.train(params, lgb.Dataset(X, label=y),
                     num_boost_round=10).model_to_string()
    ref, ours = lgb.Booster(model_str=text), lt.Booster(model_str=text)
    assert ours.params["pred_early_stop"] == "True"     # a string
    got = ours.predict(X)
    assert _bits(got, ref.predict(X))
    assert not np.array_equal(got, ours.predict(X, pred_early_stop=False))
    # early stop takes precedence over device_predict, as in the reference
    assert _bits(ours.predict(X, device_predict=True, device_type="cpu"),
                 ref.predict(X, device_predict=True))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("raw", [True, False])
def test_device_predict_bitwise(models, name, raw):
    ref, ours, X = models[name]
    want = ref.predict(X, raw_score=raw, device_predict=True)
    got = ours.predict(X, raw_score=raw, device_predict=True, **CPU)
    assert _bits(got, want)
    if name == "multiclass":
        got = ours.predict(X, raw_score=raw, device_predict=True,
                           start_iteration=2, num_iteration=3, **CPU)
        assert _bits(got, ref.predict(X, raw_score=raw, device_predict=True,
                                      start_iteration=2, num_iteration=3))


@pytest.mark.parametrize("name", ["binary", "multiclass", "rf"])
def test_device_predict_chunks_and_padding(models, name, monkeypatch):
    """Rows are independent: chunks of 256 rows (the last of 144, padded
    up) give the bits of one chunk, and one row those of its row."""
    _, ours, X = models[name]
    X = np.vstack([X, X])[:656]
    whole = ours.predict(X, device_predict=True, **CPU)
    monkeypatch.setattr(lt_booster, "DEVICE_PREDICT_CHUNK", 256)
    assert _bits(ours.predict(X, device_predict=True, **CPU), whole)
    assert _bits(ours.predict(X[7], device_predict=True, **CPU), whole[7:8])
    assert ours.predict(X[:0], device_predict=True, **CPU).shape == \
        whole[:0].shape


def test_device_predict_params_and_refusals(models, monkeypatch, tmp_path):
    ref, ours, X = models["binary"]
    # the option from params, as a string (text reloaded)
    ours.params["device_predict"] = "true"
    try:
        got = ours.predict(X, raw_score=True, **CPU)
    finally:
        del ours.params["device_predict"]
    assert _bits(got, ref.predict(X, raw_score=True, device_predict=True))
    with pytest.raises(lt.LightGBMError, match="features"):
        ours.predict(X[:, :1], device_predict=True, **CPU)
    # a data file (its label column dropped) since item 5i: the array's
    # scores and the reference's
    path = str(tmp_path / "data.csv")
    np.savetxt(path, np.column_stack([np.zeros(len(X)), X]), delimiter=",",
               fmt="%.17g")
    got = ours.predict(path, device_predict=True, **CPU)
    assert _bits(got, ours.predict(X, device_predict=True, **CPU))
    assert _bits(got, ref.predict(path, device_predict=True))
    # the card by default: without one it raises, it does not fall back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(lt.LightGBMError, match="no CUDA device"):
        ours.predict(X, device_predict=True)


def test_plan_limits_take_the_stacked_route():
    """A split on feature 4096 leaves the plan's 12-bit feature field:
    `device_predict` takes the stacked-plane traversal and the f32 sum,
    bitwise the reference's `predict(device_predict=True)`, raw and
    converted (ROADMAP Queue 3 (q), closed)."""
    X, y, params, _ = _data("regression")
    text = lgb.train(params, lgb.Dataset(X, label=y),
                     num_boost_round=2).model_to_string()
    ours = lt.Booster(model_str=text)
    ref = lgb.Booster(model_str=text)
    for bst in (ours, ref):
        bst.trees[0].split_feature[0] = 4096
    rng = np.random.RandomState(3)
    Xq = np.zeros((200, 4097))
    Xq[:, :X.shape[1]] = X[:200]
    Xq[:, 4096] = rng.randn(200)
    Xq[::9, 4096] = np.nan
    for raw in (True, False):
        got = ours.predict(Xq, raw_score=raw, device_predict=True, **CPU)
        want = ref.predict(Xq, raw_score=raw, device_predict=True)
        assert _bits(got, want)


@pytest.mark.parametrize("k", [1, 3])
def test_accumulate_f32_plain_is_a_numpy_f32_loop(k):
    rng = np.random.RandomState(k)
    t_trees, r, b, nl = 37, 45, 70, 9
    slots = rng.randint(-2, nl + 3, size=(r, b)).astype(np.int32)
    gidx = rng.permutation(r)[:t_trees].astype(np.int32)
    vals = (rng.randn(t_trees, nl) * 10.0 ** rng.randint(-6, 3, (t_trees, 1))
            ).astype(np.float32)
    vals[0] = -0.0                 # every chain starts from +0.0
    cls = (np.arange(t_trees) % k).astype(np.int32)
    want = np.zeros((b, k), np.float32)
    for t in range(t_trees):
        want[:, cls[t]] += vals[t, np.clip(slots[gidx[t]], 0, nl - 1)]
    args = (torch.from_numpy(slots), torch.from_numpy(gidx),
            torch.from_numpy(vals), k,
            torch.from_numpy(cls) if k > 1 else None)
    got = accumulate_slots_f32_plain(*args).numpy()
    assert _bits(got, want if k > 1 else want[:, 0])
    assert _bits(accumulate_slots_f32(*args).numpy(), got)
    assert not np.signbit(accumulate_slots_f32_plain(
        args[0], args[1][:1], args[2][:1], 1).numpy()).any()
    with pytest.raises(lt.LightGBMError, match="float32"):
        accumulate_slots_f32_plain(args[0], args[1], args[2].double(), k,
                                   args[4])


@pytest.mark.parametrize("kind", ["regressor", "classifier"])
def test_estimators_pred_leaf_and_contrib(kind):
    from lightgbm_tpu.sklearn import LGBMClassifier, LGBMRegressor
    X, y, _, _ = _data("multiclass" if kind == "classifier" else
                       "regression")
    kw = dict(n_estimators=6, num_leaves=7, verbosity=-1)
    ref_cls = LGBMClassifier if kind == "classifier" else LGBMRegressor
    our_cls = lt.LGBMClassifier if kind == "classifier" else lt.LGBMRegressor
    ref = ref_cls(**kw).fit(X, y)
    ours = our_cls(device_type="cpu", **kw).fit(X, y)
    Xp = X[:25]
    assert np.array_equal(ours.predict(Xp, pred_leaf=True),
                          ref.predict(Xp, pred_leaf=True))
    assert _bits(ours.predict(Xp, pred_contrib=True),
                 ref.predict(Xp, pred_contrib=True))
    assert _bits(ours.predict(Xp, raw_score=True, device_predict=True),
                 ref.predict(Xp, raw_score=True, device_predict=True))
    if kind == "classifier":
        assert _bits(ours.predict_proba(Xp, device_predict=True),
                     ref.predict_proba(Xp, device_predict=True))
