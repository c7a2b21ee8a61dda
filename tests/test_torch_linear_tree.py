"""Linear trees against the JAX package, on the CPU.

`linear_tree` fits each leaf's ridge model (`linear_lambda`) on the raw
values of its path's features on the host, in f64, hessian-weighted;
rows with a NaN in those features keep the leaf's constant.  Against the
reference: model text byte for byte under both growers (the leaves'
`leaf_const`, `leaf_features` and `leaf_coeff` lines included), the
train and valid scores bitwise, NaN rows, a validation set with early
stopping (the eval log equal), DART over linear trees, and the model
served by `ServingRuntime` on its host-walk rung bitwise the booster's
own prediction and the reference's.  Mirrors tests/test_linear_tree.py.
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

BASE = {"objective": "regression", "num_leaves": 7, "linear_tree": True,
        "linear_lambda": 0.01, "verbosity": -1, "device_type": "cpu"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _pwlinear(n=1500, seed=0):
    """A target linear in the split feature on each side of a kink."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4)
    y = np.where(X[:, 0] > 0, 2.0 * X[:, 0] + 1.0, -1.5 * X[:, 0] - 0.5)
    return X, y + 0.1 * rng.randn(n)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("policy", ["leafwise", "wave"])
@pytest.mark.parametrize("nan", [False, True], ids=["dense", "nan_rows"])
def test_linear_tree_matches(policy, nan):
    X, y = _pwlinear(seed=1)
    if nan:
        X[::7, 1] = np.nan
        X[::11, 0] = np.nan
    params = dict(BASE, tree_grow_policy=policy)
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y), 5)
    bp = lt.train(dict(params), lt.Dataset(X, label=y), 5)
    text = bp.model_to_string()
    assert text == bj.model_to_string()
    assert bp.trees[0].is_linear and "leaf_coeff=" in text
    assert np.array_equal(_bits(bp._train_score), _bits(bj._train_score))
    p = bp.predict(X)
    assert np.all(np.isfinite(p))
    assert np.array_equal(p, bj.predict(X))
    again = lt.Booster(model_str=text)
    assert again.trees[0].is_linear
    assert again.model_to_string() == text
    assert np.array_equal(again.predict(X), p)


def test_linear_beats_constant_leaves():
    X, y = _pwlinear(2000)
    params = dict(BASE, num_leaves=4, min_data_in_leaf=50, learning_rate=1.0)
    const = lt.train(dict(params, linear_tree=False), lt.Dataset(X, label=y),
                     5)
    lin = lt.train(dict(params), lt.Dataset(X, label=y), 5)
    mse_c = float(np.mean((const.predict(X) - y) ** 2))
    mse_l = float(np.mean((lin.predict(X) - y) ** 2))
    assert mse_l < 0.5 * mse_c, (mse_l, mse_c)


def test_linear_valid_set_early_stopping_and_serving():
    X, y = _pwlinear(seed=3)
    Xv, yv = _pwlinear(600, seed=4)
    params = dict(BASE, metric="l2")
    out = []
    for m in (lgb, lt):
        rec = {}
        bst = m.train(dict(params), m.Dataset(X, label=y), 40,
                      valid_sets=[m.Dataset(Xv, label=yv)],
                      callbacks=[m.early_stopping(5, verbose=False),
                                 m.record_evaluation(rec)])
        out.append((bst, rec))
    (bj, rj), (bp, rp) = out
    assert rp == rj
    assert bp.best_iteration == bj.best_iteration
    assert bp.model_to_string() == bj.model_to_string()
    assert np.array_equal(_bits(bp._valid_scores[0]),
                          _bits(bj._valid_scores[0]))
    rt = lt.ServingRuntime(bp, device="cpu")
    assert rt.rung == "host_walk"
    served = rt.predict(Xv)
    assert np.array_equal(served, bp.predict(Xv))
    assert np.array_equal(served, bj.predict(Xv))


def test_dart_over_linear_trees_matches():
    X, y = _pwlinear(1000, seed=5)
    params = dict(BASE, boosting="dart", drop_rate=0.5, skip_drop=0.0)
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y), 6)
    bp = lt.train(dict(params), lt.Dataset(X, label=y), 6)
    assert bp.model_to_string() == bj.model_to_string()
    assert np.array_equal(_bits(bp._train_score), _bits(bj._train_score))
