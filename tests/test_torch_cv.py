"""`lightgbm_tpu_torch.cv`, `CVBooster` and `Dataset.subset` against the
live JAX package, on the CPU.

The port trains with `device_type="cpu"`.  The folds (`_make_n_folds`:
numpy `RandomState`, stratified and not, `folds=` as a splitter and as
index pairs) are the reference's index for index; the result dicts
("<metric>-mean" and "-stdv" a round) are the reference's float for
float, with early stopping truncating them, `eval_train_metric`,
`fpreproc` and `return_cvbooster`, whose fold models are the
reference's byte for byte.  A fold's subset shares its parent's bin
mappers and rows, and `cv` is `_agg_cv_result` over separate `train`
runs on the same subsets.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu.engine as ref_engine  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
import lightgbm_tpu_torch.engine as engine  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """ROADMAP Queue 3 (f): one intra-op thread for the links."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _data(family, seed=0, n=900):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    z = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.4 * rng.randn(n)
    if family == "binary":
        return X, (z > 0).astype(float)
    if family == "multiclass":
        return X, np.digitize(z, [-0.6, 0.6]).astype(float)
    return X, z


PARAMS = {"binary": {"objective": "binary", "metric": ["auc", "binary_logloss"]},
          "regression": {"objective": "regression", "metric": "l2"},
          "multiclass": {"objective": "multiclass", "num_class": 3,
                         "metric": "multi_logloss"}}


def _params(family, **extra):
    return dict({"num_leaves": 7, "verbosity": -1, "learning_rate": 0.3},
                **dict(PARAMS[family], **extra))


def _pkg(m, params):
    return dict(params, device_type="cpu") if m is lt else dict(params)


def _text(bst):
    return bst.model_to_string().replace("[device_type: cpu]\n", "")


class _EveryThird:
    """A splitter object (the scikit-learn protocol): rows i % 3 == k."""

    def split(self, X, y=None, groups=None):
        n = len(X)
        for k in range(3):
            test = np.arange(k, n, 3)
            yield np.setdiff1d(np.arange(n), test), test


@pytest.mark.parametrize("family,stratified,shuffle", [
    ("binary", True, True), ("binary", True, False),
    ("multiclass", True, True), ("regression", False, True),
    ("regression", False, False)])
def test_folds_are_the_reference(family, stratified, shuffle):
    X, y = _data(family)
    ours = engine._make_n_folds(lt.Dataset(X, label=y), None, 4, {}, 7,
                                stratified, shuffle)
    theirs = ref_engine._make_n_folds(lgb.Dataset(X, label=y), None, 4, {},
                                      7, stratified, shuffle)
    assert len(ours) == len(theirs) == 4
    for (a, b), (c, d) in zip(ours, theirs):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    split = list(engine._make_n_folds(lt.Dataset(X, label=y),
                                      _EveryThird(), 4, {}, 7, True, True))
    assert len(split) == 3 and np.array_equal(split[1][1],
                                              np.arange(1, len(y), 3))


@pytest.mark.parametrize("family,kw", [
    ("binary", {}),
    ("binary", {"stratified": False, "eval_train_metric": True}),
    ("regression", {"nfold": 4, "shuffle": False}),
    ("multiclass", {"nfold": 3, "seed": 3})],
    ids=["binary", "binary-plain-train-metric", "regression", "multiclass"])
def test_cv_results_are_the_reference(family, kw):
    X, y = _data(family)
    kw = dict({"nfold": 3}, **kw)

    def run(m):
        return m.cv(_pkg(m, _params(family)), m.Dataset(X, label=y), 4,
                    return_cvbooster=True, **kw)

    rj, rp = run(lgb), run(lt)
    cj, cp = rj.pop("cvbooster"), rp.pop("cvbooster")
    assert rp == rj
    assert all(len(v) == 4 for v in rp.values())
    assert len(cp.boosters) == kw["nfold"]
    for a, b in zip(cj.boosters, cp.boosters):
        assert _text(b) == _text(a)


def test_cv_with_folds_given_and_fpreproc():
    X, y = _data("binary")
    pairs = [(np.arange(300, 900), np.arange(300)),
             (np.arange(600), np.arange(600, 900))]
    seen = []

    def fpreproc(tr, te, params):
        seen.append((tr.used_indices[0], te.used_indices[0]))
        params["learning_rate"] = 0.5
        return tr, te, params

    def run(m, folds, pre=None):
        return m.cv(_pkg(m, _params("binary")), m.Dataset(X, label=y), 3,
                    folds=folds, fpreproc=pre)

    assert run(lt, pairs, fpreproc) == run(lgb, pairs, fpreproc)
    assert seen[0] == (300, 0) and seen[2] == (300, 0)
    assert run(lt, _EveryThird()) == run(lgb, _EveryThird())


def test_cv_early_stopping_truncates_and_saves(tmp_path):
    X, y = _data("binary")
    params = _params("binary", metric="binary_logloss", learning_rate=1.0,
                     early_stopping_round=2)

    def run(m):
        return m.cv(_pkg(m, params), m.Dataset(X, label=y), 40, nfold=3,
                    return_cvbooster=True)

    rj, rp = run(lgb), run(lt)
    cj, cp = rj.pop("cvbooster"), rp.pop("cvbooster")
    assert rp == rj
    n = len(rp["valid binary_logloss-mean"])
    assert n < 40 and cp.best_iteration == cj.best_iteration == n
    assert all(b.best_iteration == n for b in cp.boosters)
    path = str(tmp_path / "cv.json")
    cp.save_model(path)
    back = lt.CVBooster(model_file=path)
    assert back.best_iteration == n
    assert [b.model_to_string() for b in back.boosters] == \
        [b.model_to_string() for b in cp.boosters]
    # each fold's text holds its trees up to the best iteration
    assert back.num_trees() == [n] * 3
    with pytest.raises(AttributeError):
        back.__wrapped__


def test_cv_reset_parameter_and_feval():
    X, y = _data("binary")

    def feval(preds, ds):
        return "mean", float(np.mean(preds)), True

    def run(m):
        return m.cv(_pkg(m, _params("binary")), m.Dataset(X, label=y), 3,
                    nfold=3, feval=feval, callbacks=[m.reset_parameter(
                        learning_rate=[0.3, 0.2, 0.1])])

    rp = run(lt)
    assert rp == run(lgb)
    assert "valid mean-mean" in rp


def test_cv_is_agg_of_separate_train_runs_on_the_subsets():
    X, y = _data("binary")
    params = _params("binary", device_type="cpu")
    ds = lt.Dataset(X, label=y)
    res = lt.cv(params, ds, 4, nfold=3)
    folds = engine._make_n_folds(ds, None, 3, params, 0, True, True)
    per_fold = []
    for tr_idx, te_idx in folds:
        rec = {}
        tr, te = ds.subset(tr_idx), ds.subset(te_idx)
        lt.train(params, tr, 4, valid_sets=[te], valid_names=["valid"],
                 callbacks=[lt.record_evaluation(rec)])
        per_fold.append(rec["valid"])
    for r in range(4):
        agg = engine._agg_cv_result([[("valid", k, v[r], k == "auc")
                                      for k, v in f.items()]
                                     for f in per_fold])
        for _, key, mean, _, std in agg:
            assert res[f"{key}-mean"][r] == mean
            assert res[f"{key}-stdv"][r] == std


def test_subset_shares_bins_and_mappers():
    X, y = _data("binary")
    w = np.random.RandomState(1).rand(len(y))
    idx = np.random.RandomState(2).choice(len(y), 300, replace=False)
    full = lt.Dataset(X, label=y, weight=w).construct()
    sub = full.subset(idx).construct()
    ref = lgb.Dataset(X, label=y, weight=w).construct()
    rsub = ref.subset(idx).construct()
    assert sub.bin_mappers is full.bin_mappers
    assert np.array_equal(sub.bin_data, full.bin_data[np.sort(idx)])
    assert np.array_equal(sub.bin_data, np.asarray(rsub.bin_data))
    assert np.array_equal(sub.get_label(), rsub.get_label())
    assert np.array_equal(sub.get_weight(), rsub.get_weight())
    assert sub.num_data() == 300 and sub.num_feature() == 5
    bst = lt.train(_params("binary", device_type="cpu"), sub, 2)
    ref_bst = lgb.train(_params("binary"), ref.subset(idx), 2)
    assert _text(bst) == _text(ref_bst)


def test_cv_init_model_starts_every_fold_from_it():
    X, y = _data("binary")
    params = _params("binary", device_type="cpu")
    init = lt.train(params, lt.Dataset(X, label=y), 2)
    res = lt.cv(params, lt.Dataset(X, label=y), 2, nfold=3,
                init_model=init, return_cvbooster=True)
    for b in res["cvbooster"].boosters:
        assert b.current_iteration() == 4
        assert [t.to_string(i) for i, t in enumerate(b.trees[:2])] == \
            [t.to_string(i) for i, t in enumerate(init.trees)]


def test_cv_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data("binary")
    with pytest.raises(lt.LightGBMError, match="no CUDA device"):
        lt.cv(_params("binary"), lt.Dataset(X, label=y), 2, nfold=2)
