"""Ranking against the JAX package, on the CPU: lambdarank and rank_xendcg
with query groups and positions.

  * the query bucketing (`_bucket_queries`, `_build_buckets`) the
    reference's layout, for one bucket and for three;
  * the `discount` table's bits, the constant XLA folds from
    1 / log2(rank + 2);
  * each bucket's gradients and hessians bitwise the reference's
    `grad_hess` under `jax.jit` (as its booster compiles it), at query
    widths around every loop shape XLA's CPU code gives the per-document
    sums, with `lambdarank_norm` on and off, a truncation level under
    the query length, a custom `label_gain`, and positions (the
    propensities too); rank_xendcg's with the iteration's key;
  * model texts byte for byte the reference's after two `update`s:
    uniform and skewed query sizes (one bucket and three), norm on and
    off, truncation, label_gain, positions, rank_xendcg, both growers,
    and a quantized run;
  * positions: the state's anchor, 1-based and gappy positions remapped,
    a length mismatch raising, the inert warning under a non-ranking
    objective;
  * NDCG and MAP of a validation set with groups as the reference's;
    `LGBMRanker` with `eval_group` and `eval_at`, `cv` with groups (the
    default folds and a splitter), `refit(group=)`, and ranking without
    groups raising.
Mirrors tests/test_rank_bucketing.py, test_position_bias.py and the
ranking half of test_boosting_modes.py.
"""
import logging
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu.rank_objective as ref_rank  # noqa: E402
import lightgbm_tpu.sklearn as ref_sklearn  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
import lightgbm_tpu_torch.rank_objective as port_rank  # noqa: E402
from lightgbm_tpu.utils.config import Config as RefConfig  # noqa: E402
from lightgbm_tpu_torch.ops.threefry import fold_in, prng_key  # noqa: E402
from lightgbm_tpu_torch.utils.config import Config  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _ranking(sizes, seed=5, f=6):
    rng = np.random.RandomState(seed)
    n = int(np.sum(sizes))
    X = rng.randn(n, f)
    y = np.clip(np.round(X[:, 0] + 0.5 * X[:, 1] + 0.5 * rng.randn(n) + 1),
                0, 4)
    return X, y


def _skewed(seed=7):
    rng = np.random.RandomState(seed)
    return [int(v) for v in rng.randint(3, 25, 40)] + [60, 80, 90, 120]


def _positions(X, sizes, seed=2):
    """A noisy logged ranking of each query: 0 is the top."""
    rng = np.random.RandomState(seed)
    out, lo = [], 0
    for s in sizes:
        noisy = X[lo:lo + s, 0] + rng.randn(s)
        out.append(np.argsort(np.argsort(-noisy)))
        lo += s
    return np.concatenate(out)


def test_bucket_layout_matches_the_reference():
    rng = np.random.RandomState(1)
    skewed = np.where(rng.rand(200) < 0.9, rng.randint(20, 61, 200),
                      rng.randint(300, 501, 200))
    for sizes in (np.full(50, 20), skewed, np.array([5, 9, 300])):
        want = ref_rank._bucket_queries(sizes)
        got = port_rank._bucket_queries(sizes)
        assert [list(g) for g in got] == [list(g) for g in want]
        qb = np.concatenate([[0], np.cumsum(sizes)])
        for bp, bj in zip(port_rank._build_buckets(qb, sizes),
                          ref_rank._build_buckets(qb, sizes)):
            assert np.array_equal(bp["idx_np"], bj["idx_np"])
            assert np.array_equal(bp["mask"].numpy(), np.asarray(bj["mask"]))
    assert len(port_rank._bucket_queries(skewed)) == 3
    assert len(port_rank._bucket_queries(np.full(50, 20))) == 1


@pytest.mark.parametrize("P", [20, 200, 900])
def test_discount_table_bits(P):
    want = jax.jit(
        lambda: 1.0 / jnp.log2(jnp.arange(P, dtype=jnp.float32) + 2.0))()
    assert np.array_equal(_bits(port_rank._discount(P).numpy()),
                          _bits(want))


#: (query sizes, params): widths around each loop shape of the sums
GRAD_CASES = [
    ([9] * 12, {}), ([13] * 12, {}), ([18] * 12, {}), ([21] * 12, {}),
    ([26] * 12, {}), ([32] * 10, {}), ([40] * 8, {}),
    ([21] * 12, {"lambdarank_norm": False}),
    ([40] * 8, {"lambdarank_norm": False}),
    ([20] * 12, {"lambdarank_truncation_level": 5}),
    ([28] * 10, {"lambdarank_truncation_level": 20,
                 "lambdarank_norm": False}),
    ([20] * 12, {"label_gain": [0, 1, 3, 7, 15]}),
    ("skewed", {}), ("skewed", {"lambdarank_norm": False}),
]


@pytest.mark.parametrize("sizes,params", GRAD_CASES,
                         ids=[f"{s if isinstance(s, str) else s[0]}-"
                              f"{'-'.join(map(str, p)) or 'default'}"
                              for s, p in GRAD_CASES])
def test_lambdarank_gradients_bitwise_the_jitted_reference(sizes, params):
    sizes = _skewed() if sizes == "skewed" else sizes
    n = int(np.sum(sizes))
    rng = np.random.RandomState(n)
    label = rng.randint(0, 5, n).astype(np.float64)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    p = dict(objective="lambdarank", **params)
    ro = ref_rank.LambdarankNDCG(RefConfig(p))
    po = port_rank.LambdarankNDCG(Config(p))
    ro.init_meta(label, None, qb)
    po.init_meta(label, None, qb)
    lj = jnp.asarray(label.astype(np.float32))
    f = jax.jit(lambda s: ro.grad_hess(s, lj, None))
    # round 1's all-equal scores, then spread ones
    for score in (np.zeros(n, np.float32),
                  (rng.randn(n) * 0.5).astype(np.float32)):
        g, h = f(jnp.asarray(score))
        gp, hp = po.grad_hess(torch.from_numpy(score),
                              torch.from_numpy(label.astype(np.float32)),
                              None)
        assert np.array_equal(_bits(gp.numpy()), _bits(g))
        assert np.array_equal(_bits(hp.numpy()), _bits(h))


@pytest.mark.parametrize("sizes", [[20] * 15, "skewed"])
def test_positions_gradients_and_state_bitwise(sizes):
    sizes = _skewed() if sizes == "skewed" else sizes
    X, _ = _ranking(sizes)
    n = len(X)
    rng = np.random.RandomState(4)
    label = rng.randint(0, 5, n).astype(np.float64)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    pos = _positions(X, sizes)
    ro = ref_rank.LambdarankNDCG(RefConfig({"objective": "lambdarank"}))
    po = port_rank.LambdarankNDCG(Config({"objective": "lambdarank"}))
    for o in (ro, po):
        o.init_meta(label, None, qb)
        o.set_positions(pos)
    lj = jnp.asarray(label.astype(np.float32))
    f = jax.jit(lambda s, st: ro.grad_hess(s, lj, None, state=st))
    state, pstate = ro.init_state(), po.init_state()
    for it in range(3):
        score = (rng.randn(n) * 0.3 * it).astype(np.float32)
        g, h, state = f(jnp.asarray(score), state)
        gp, hp, pstate = po.grad_hess(
            torch.from_numpy(score),
            torch.from_numpy(label.astype(np.float32)), None, state=pstate)
        assert np.array_equal(_bits(gp.numpy()), _bits(g))
        assert np.array_equal(_bits(hp.numpy()), _bits(h))
        for a, b in zip(pstate, state):
            assert np.array_equal(_bits(a.numpy()), _bits(b))
    assert pstate[0][0] == 1.0 and pstate[1][0] == 1.0


@pytest.mark.parametrize("sizes", [[20] * 15, "skewed"])
def test_xendcg_gradients_bitwise_the_jitted_reference(sizes):
    sizes = _skewed() if sizes == "skewed" else sizes
    n = int(np.sum(sizes))
    rng = np.random.RandomState(9)
    label = rng.randint(0, 5, n).astype(np.float64)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    ro = ref_rank.RankXENDCG(RefConfig({"objective": "rank_xendcg"}))
    po = port_rank.RankXENDCG(Config({"objective": "rank_xendcg"}))
    ro.init_meta(label, None, qb)
    po.init_meta(label, None, qb)
    lj = jnp.asarray(label.astype(np.float32))
    f = jax.jit(lambda s, k: ro.grad_hess(s, lj, None, key=k))
    score = (rng.randn(n) * 0.5).astype(np.float32)
    for it in (0, 3):
        g, h = f(jnp.asarray(score),
                 jax.random.fold_in(jax.random.PRNGKey(0), it))
        gp, hp = po.grad_hess(torch.from_numpy(score),
                              torch.from_numpy(label.astype(np.float32)),
                              None, key=fold_in(prng_key(0), it))
        assert np.array_equal(_bits(gp.numpy()), _bits(g))
        assert np.array_equal(_bits(hp.numpy()), _bits(h))


#: (objective, layout, params, policy): each layout under both growers;
#: the settings that only change the lambdas (held bitwise above) under
#: the strict one
TEXT_CASES = [(o, lay, p, pol) for o, lay, p in (
    ("lambdarank", "uniform", {}), ("lambdarank", "skewed", {}),
    ("lambdarank", "positions", {}),
    ("lambdarank", "uniform", {"use_quantized_grad": True}),
    ("rank_xendcg", "uniform", {}), ("rank_xendcg", "skewed", {}))
    for pol in ("leafwise", "wave")] + [
    ("lambdarank", "uniform", p, "leafwise") for p in (
        {"lambdarank_norm": False}, {"lambdarank_truncation_level": 5},
        {"label_gain": [0, 1, 3, 7, 15]})]


@pytest.mark.parametrize("objective,layout,params,policy", TEXT_CASES,
                         ids=[f"{o}-{lay}-{'-'.join(map(str, p)) or 'x'}-"
                              f"{pol}" for o, lay, p, pol in TEXT_CASES])
def test_model_text_matches(objective, layout, params, policy):
    sizes = _skewed() if layout == "skewed" else [20] * 20
    X, y = _ranking(sizes)
    pos = _positions(X, sizes) if layout == "positions" else None
    p = dict(objective=objective, num_leaves=7, min_data_in_leaf=5,
             verbosity=-1, device_type="cpu", tree_grow_policy=policy,
             **params)
    texts = []
    for m in (lgb, lt):
        bst = m.Booster(dict(p), m.Dataset(X, label=y, group=sizes,
                                           position=pos))
        for _ in range(2):
            bst.update()
        texts.append(bst.model_to_string())
    assert texts[1] == texts[0]


def test_positions_state_remapping_and_errors(caplog):
    sizes = [15] * 20
    X, y = _ranking(sizes)
    pos = _positions(X, sizes)
    params = {"objective": "lambdarank", "num_leaves": 4, "verbosity": -1,
              "device_type": "cpu"}
    bst = lt.train(params, lt.Dataset(X, label=y, group=sizes,
                                      position=(pos + 1) * 10), 3)
    t_plus, t_minus = (t.numpy() for t in bst._obj_state)
    assert len(t_plus) == len(np.unique(pos))
    assert t_plus[0] == 1.0 and t_minus[0] == 1.0
    assert np.isfinite(t_plus).all() and np.isfinite(t_minus).all()
    with pytest.raises(lt.LightGBMError, match="Length of position"):
        lt.train(params, lt.Dataset(X, label=y, group=sizes,
                                    position=pos[:-5]), 1)
    caplog.set_level(logging.WARNING)
    b = lt.train(dict(params, objective="regression", verbosity=1),
                 lt.Dataset(X, label=y, position=pos), 2)
    assert b.current_iteration() == 2
    assert "positions have NO effect" in caplog.text


def test_ranking_without_groups_raises():
    X, y = _ranking([20] * 5)
    for objective in ("lambdarank", "rank_xendcg"):
        with pytest.raises(lt.LightGBMError, match="query information"):
            lt.train({"objective": objective, "device_type": "cpu",
                      "verbosity": -1}, lt.Dataset(X, label=y), 1)


def test_ndcg_and_map_of_a_validation_set():
    sizes = [20] * 20
    X, y = _ranking(sizes)
    Xv, yv = _ranking([20] * 8, seed=6)
    params = {"objective": "lambdarank", "metric": ["ndcg", "map"],
              "eval_at": [1, 3, 5], "num_leaves": 7, "min_data_in_leaf": 5,
              "verbosity": -1, "device_type": "cpu"}
    res = []
    for m in (lgb, lt):
        ds = m.Dataset(X, label=y, group=sizes)
        bst = m.Booster(dict(params), ds)
        bst.add_valid(ds.create_valid(Xv, label=yv, group=[20] * 8), "v")
        for _ in range(3):
            bst.update()
        res.append(bst.eval_valid())
    assert res[1] == res[0]
    assert [r[1] for r in res[1]] == ["ndcg@1", "ndcg@3", "ndcg@5",
                                      "map@1", "map@3", "map@5"]
    assert all(r[3] for r in res[1])


def test_lgbm_ranker_with_eval_group_and_eval_at():
    sizes = [15] * 20
    X, y = _ranking(sizes)
    Xv, yv = _ranking([15] * 6, seed=8)
    kw = dict(n_estimators=4, num_leaves=7, min_data_in_leaf=5,
              verbosity=-1)
    fit = dict(group=sizes, eval_set=[(Xv, yv)], eval_group=[[15] * 6],
               eval_at=[2, 4])
    mj = ref_sklearn.LGBMRanker(**kw, device_type="cpu").fit(X, y, **fit)
    mp = lt.LGBMRanker(**kw, device_type="cpu").fit(X, y, **fit)
    assert mp.booster_.model_to_string() == mj.booster_.model_to_string()
    assert mp.evals_result_ == mj.evals_result_
    assert list(mp.evals_result_["valid_0"]) == ["ndcg@2", "ndcg@4"]
    assert np.array_equal(mp.predict(Xv), mj.predict(Xv))
    with pytest.raises(ValueError, match="group"):
        lt.LGBMRanker().fit(X, y)
    with pytest.raises(ValueError, match="Eval_group"):
        lt.LGBMRanker().fit(X, y, group=sizes, eval_set=[(Xv, yv)])


def test_cv_with_groups():
    from sklearn.model_selection import GroupKFold
    sizes = [12] * 24
    X, y = _ranking(sizes)
    params = {"objective": "lambdarank", "metric": "ndcg", "eval_at": [3],
              "num_leaves": 7, "min_data_in_leaf": 5, "verbosity": -1,
              "device_type": "cpu"}
    for folds in (None, GroupKFold(n_splits=2)):
        res = [m.cv(dict(params), m.Dataset(X, label=y, group=sizes),
                    num_boost_round=2, nfold=2, folds=folds)
               for m in (lgb, lt)]
        assert res[1] == res[0]
    from lightgbm_tpu_torch.engine import _make_n_folds
    from lightgbm_tpu.engine import _make_n_folds as ref_folds
    ds = lt.Dataset(X, label=y, group=sizes)
    dj = lgb.Dataset(X, label=y, group=sizes)
    for shuffle in (False, True):
        got = _make_n_folds(ds, None, 4, {}, 3, False, shuffle)
        want = ref_folds(dj, None, 4, {}, 3, False, shuffle)
        for (a, b), (c, d) in zip(got, want):
            assert np.array_equal(a, c) and np.array_equal(b, d)
        # whole queries in each fold
        qb = np.concatenate([[0], np.cumsum(sizes)])
        for _, test in got:
            starts = set(test[np.r_[True, np.diff(test) > 1]])
            assert starts <= set(qb[:-1])


@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_refit_with_groups(objective):
    sizes = [10] * 8
    X, y = _ranking(sizes)
    X2, y2 = _ranking(sizes, seed=12)
    params = {"objective": objective, "num_leaves": 7, "min_data_in_leaf": 5,
              "verbosity": -1, "device_type": "cpu"}
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y, group=sizes), 2)
    bp = lt.train(dict(params), lt.Dataset(X, label=y, group=sizes), 2)
    rj = bj.refit(X2, y2, decay_rate=0.5, group=sizes)
    rp = bp.refit(X2, y2, decay_rate=0.5, group=sizes)
    assert rp.model_to_string() == rj.model_to_string()
