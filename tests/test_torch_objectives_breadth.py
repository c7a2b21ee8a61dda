"""The regression family, one-vs-all, the cross-entropies and every metric
against the JAX package, on the CPU.

  * each objective of the slice, under both growers, with f32 and
    quantized histograms as the reference resolves them: the port's
    model text byte for byte the reference's after two `update`s, and
    weighted f32 runs of the three objectives whose leaves are
    refitted (`regression_l1`, `quantile`, `mape`);
  * each objective's gradients and hessians bitwise those of the
    reference's `grad_hess` under `jax.jit` with label and weight held
    as constants, as the reference's booster compiles them (XLA's CPU
    code contracts some sums into fmas there, which the port repeats);
  * `ops/renew.py leaf_percentile` bitwise the jitted reference's, on
    random residuals with ties and signed zeros, weighted and not, at
    alpha 0.1, 0.5 and 0.9, 7 and 31 leaf slots, empty leaves and
    out-of-bag rows;
  * XLA's log, log2, exp2, log1p, expm1 and tanh (`ops/xla_math.py`)
    bitwise `jax.jit` of the jnp functions;
  * every metric of `create_metrics` equal to the reference's, NDCG and
    MAP at `eval_at` with a custom `label_gain` included, and
    `is_higher_better`;
  * the checks the objectives' `init_meta` makes, and `refit` of the
    objectives whose jitted gradients carry fmas (the reference refits
    op by op).
"""
import functools
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
import lightgbm_tpu.metrics as ref_metrics  # noqa: E402
import lightgbm_tpu.objectives as ref_obj  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
import lightgbm_tpu_torch.metrics as port_metrics  # noqa: E402
import lightgbm_tpu_torch.objectives as port_obj  # noqa: E402
from lightgbm_tpu.ops.renew import leaf_percentile as ref_percentile  # noqa
from lightgbm_tpu.utils.config import Config as RefConfig  # noqa: E402
from lightgbm_tpu_torch.ops import xla_math  # noqa: E402
from lightgbm_tpu_torch.ops.renew import leaf_percentile  # noqa: E402
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


def _labels(n=400, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    base = X[:, 0] + 0.5 * np.sin(2 * X[:, 1]) + 0.3 * X[:, 2]
    ys = {
        "regression_l1": base + 0.3 * rng.randn(n),
        "huber": base + rng.randn(n),
        "fair": base + rng.randn(n),
        "poisson": rng.poisson(np.exp(0.5 * base)).astype(float),
        "quantile": base + rng.randn(n),
        "mape": 3 * base + rng.randn(n),
        "gamma": np.exp(0.3 * base) * rng.gamma(2, 0.5, n) + 0.01,
        "tweedie": rng.gamma(1, 1, n) * (rng.rand(n) < 0.7)
        * np.exp(0.3 * base),
        "multiclassova": np.digitize(base, [-0.5, 0.5]).astype(float),
        "cross_entropy": 1 / (1 + np.exp(-base)),
        "cross_entropy_lambda": 1 / (1 + np.exp(-base)),
    }
    return X, ys, rng.uniform(0.5, 2, n)


#: each objective's own parameters
EXTRA = {"quantile": {"alpha": 0.7}, "huber": {"alpha": 0.9},
         "fair": {"fair_c": 1.3},
         "tweedie": {"tweedie_variance_power": 1.5},
         "multiclassova": {"num_class": 3}}
OBJECTIVES = list(_labels(8)[1])
RENEWED = ("regression_l1", "quantile", "mape")
TRAIN_CASES = [(o, p, q, False) for o in OBJECTIVES
               for p in ("leafwise", "wave") for q in (False, True)] + \
    [(o, p, False, True) for o in RENEWED for p in ("leafwise", "wave")]


@pytest.mark.parametrize(
    "objective,policy,quantized,weighted", TRAIN_CASES,
    ids=[f"{o}-{p}-{'q' if q else 'f32'}{'-w' if w else ''}"
         for o, p, q, w in TRAIN_CASES])
def test_model_text_matches(objective, policy, quantized, weighted):
    X, ys, w = _labels(300)
    params = dict(objective=objective, num_leaves=7, max_bin=31,
                  verbosity=-1,
                  device_type="cpu", tree_grow_policy=policy,
                  **EXTRA.get(objective, {}))
    if quantized:
        params["use_quantized_grad"] = True
    texts = []
    for m in (lgb, lt):
        bst = m.Booster(dict(params), m.Dataset(
            X, label=ys[objective], weight=w if weighted else None))
        for _ in range(2):
            bst.update()
        texts.append(bst.model_to_string())
    assert texts[1] == texts[0]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_gradients_bitwise_the_jitted_reference(objective, weighted):
    rng = np.random.RandomState(0)
    n = 3000
    _, ys, _ = _labels(n, seed=1)
    label = ys[objective].astype(np.float64)
    w = rng.uniform(0.5, 2, n).astype(np.float32) if weighted else None
    params = dict(objective=objective, **EXTRA.get(objective, {}))
    ro = ref_obj.create_objective(RefConfig(params))
    po = port_obj.create_objective(Config(params))
    ro.init_meta(label, w, None)
    po.init_meta(label, w)
    s = (rng.randn(n) * 2).astype(np.float32)
    if ro.num_tree_per_iteration > 1:
        s = np.stack([s, 0.5 * s, -s], 1).astype(np.float32)
    s[:3] = 0.0
    lj = jnp.asarray(label.astype(np.float32))
    wj = None if w is None else jnp.asarray(w)
    g, h = jax.jit(lambda x: ro.grad_hess(x, lj, wj))(jnp.asarray(s))
    gp, hp = po.grad_hess(torch.from_numpy(s),
                          torch.from_numpy(label.astype(np.float32)),
                          None if w is None else torch.from_numpy(w))
    assert np.array_equal(_bits(gp.numpy()), _bits(g))
    assert np.array_equal(_bits(hp.numpy()), _bits(h))
    assert po.boost_from_score(label, w) == ro.boost_from_score(label, w)


@pytest.mark.parametrize("objective",
                         ["gamma", "tweedie", "cross_entropy_lambda"])
def test_refit_matches(objective):
    """The reference refits with `grad_hess` outside `jax.jit`, where
    XLA contracts nothing: the port's refit takes that arithmetic."""
    X, ys, w = _labels(300)
    X2, ys2, _ = _labels(300, seed=9)
    params = dict(objective=objective, num_leaves=7, verbosity=-1,
                  device_type="cpu", **EXTRA.get(objective, {}))
    out = []
    for m in (lgb, lt):
        bst = m.train(dict(params), m.Dataset(X, label=ys[objective]), 2)
        out.append(bst.refit(X2, ys2[objective], decay_rate=0.5,
                             weight=w).model_to_string())
    assert out[1] == out[0]


PERCENTILE_CASES = [(L, alpha, weighted)
                    for L in (7, 31) for alpha in (0.1, 0.5, 0.9)
                    for weighted in (False, True)]


@pytest.mark.parametrize("L,alpha,weighted", PERCENTILE_CASES)
def test_leaf_percentile_bitwise_the_jitted_reference(L, alpha, weighted):
    """Half the leaves hold distinct residuals, half rounded ones with
    ties and signed zeros."""
    rng = np.random.RandomState(L + int(alpha * 10))
    n = 1500
    r = rng.randn(n).astype(np.float32)
    tied = rng.rand(n) < 0.5
    r[tied] = np.round(r[tied] * 2) / 2
    r[tied & (rng.rand(n) < 0.3)] = -0.0
    w = rng.uniform(0.1, 3, n).astype(np.float32)
    in_bag = rng.rand(n) < 0.8
    leaf = rng.randint(0, L, n).astype(np.int32)
    leaf[leaf == 2] = 0                        # an empty leaf
    f = jax.jit(functools.partial(ref_percentile, num_leaves=L,
                                  alpha=alpha, weighted=weighted))
    v, c = f(jnp.asarray(r), jnp.asarray(w), jnp.asarray(in_bag),
             jnp.asarray(leaf))
    vp, cp = leaf_percentile(torch.from_numpy(r), torch.from_numpy(w),
                             torch.from_numpy(in_bag),
                             torch.from_numpy(leaf), L, alpha, weighted)
    assert np.array_equal(_bits(vp.numpy()), _bits(v))
    assert np.array_equal(cp.numpy(), np.asarray(c))
    assert vp[2] == 0


XLA_FUNCTIONS = [
    ("log", jnp.log, xla_math.xla_log_f32, (1e-30, 1e30)),
    ("log2", jnp.log2, xla_math.xla_log2_f32, (1e-30, 1e30)),
    ("exp2", jnp.exp2, xla_math.xla_exp2_f32, (-100.0, 100.0)),
    ("log1p", jnp.log1p, xla_math.xla_log1p_f32, (-0.999, 1e6)),
    ("expm1", jnp.expm1, xla_math.xla_expm1_f32, (-60.0, 60.0)),
    ("tanh", jnp.tanh, xla_math.xla_tanh_f32, (-12.0, 12.0)),
]


@pytest.mark.parametrize("name,jf,pf,rng_", XLA_FUNCTIONS,
                         ids=[c[0] for c in XLA_FUNCTIONS])
def test_xla_functions_bitwise(name, jf, pf, rng_):
    rng = np.random.RandomState(11)
    lo, hi = rng_
    if lo > 0:
        x = np.exp(rng.uniform(np.log(lo), np.log(hi), 1 << 18))
    else:
        x = np.concatenate([rng.uniform(lo, hi, 1 << 17),
                            rng.uniform(-0.6, 0.6, 1 << 17)])
    x = np.concatenate([x, [0.0, 1.0, 2.0, 3.0]]).astype(np.float32)
    want = np.asarray(jax.jit(jf)(x))
    got = pf(torch.from_numpy(x)).numpy()
    same = (_bits(got) == _bits(want)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (name, x[~same][:4])


def _metric_data(n=600, k=3, seed=5):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(3, 25, 40)
    sizes[-1] = n - sizes[:-1].sum()
    qb = np.concatenate([[0], np.cumsum(sizes)])
    return {"score": rng.randn(n), "score_k": rng.randn(n, k),
            "pos": rng.gamma(2, 1, n) + 0.01,
            "unit": rng.rand(n), "binary": (rng.rand(n) > 0.6) * 1.0,
            "cls": rng.randint(0, k, n) * 1.0,
            "rank": rng.randint(0, 5, n) * 1.0,
            "w": rng.uniform(0.5, 2, n), "qb": qb}


#: metric -> (score key, label key)
METRICS = {"l1": ("score", "pos"), "l2": ("score", "pos"),
           "rmse": ("score", "pos"), "quantile": ("score", "pos"),
           "huber": ("score", "pos"), "fair": ("score", "pos"),
           "poisson": ("score", "pos"), "gamma": ("score", "pos"),
           "gamma_deviance": ("score", "pos"), "tweedie": ("score", "pos"),
           "mape": ("score", "pos"), "binary_logloss": ("score", "binary"),
           "binary_error": ("score", "binary"), "auc": ("score", "binary"),
           "average_precision": ("score", "binary"),
           "multi_logloss": ("score_k", "cls"),
           "multi_error": ("score_k", "cls"), "auc_mu": ("score_k", "cls"),
           "ndcg": ("score", "rank"), "map": ("score", "rank"),
           "cross_entropy": ("score", "unit"),
           "cross_entropy_lambda": ("score", "unit"),
           "kldiv": ("score", "unit")}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric", list(METRICS))
def test_metrics_equal_the_reference(metric, weighted):
    d = _metric_data()
    params = {"metric": metric, "alpha": 0.7, "fair_c": 1.5,
              "tweedie_variance_power": 1.3, "eval_at": [1, 3, 10],
              "label_gain": [0, 1, 3, 7, 20], "multi_error_top_k": 2}
    sk, lk = METRICS[metric]
    w = d["w"] if weighted else None
    want = [m.eval(d[sk], d[lk], w, d["qb"])
            for m in ref_metrics.create_metrics(RefConfig(params),
                                                [metric])]
    got = [m.eval(d[sk], d[lk], w, d["qb"])
           for m in port_metrics.create_metrics(Config(params), [metric])]
    assert got == want
    for (name, _), in zip(*got):
        assert port_metrics.is_higher_better(name) \
            == ref_metrics.is_higher_better(name)


def test_ranking_metrics_need_queries():
    d = _metric_data()
    for metric in ("ndcg", "map"):
        (m,) = port_metrics.create_metrics(Config({}), [metric])
        with pytest.raises(lt.LightGBMError, match="query information"):
            m.eval(d["score"], d["rank"], None, None)
    with pytest.raises(lt.LightGBMError, match="Unknown metric"):
        port_metrics.create_metrics(Config({}), ["no_such_metric"])


INIT_META = [
    ("poisson", -1.0, "negative"), ("gamma", 0.0, "not positive"),
    ("tweedie", -1.0, "negative"), ("cross_entropy", 1.5, r"\[0, 1\]"),
    ("cross_entropy_lambda", -0.5, ">= 0"),
    ("multiclass", 5.0, "Label must be in"),
    ("binary", 2.0, "Binary objective requires"),
    ("lambdarank", 0.5, "non-negative integers"),
    ("lambdarank", 40.0, "exceeds label_gain"),
]


@pytest.mark.parametrize("objective,bad,match", INIT_META,
                         ids=[f"{o}-{b}" for o, b, _ in INIT_META])
def test_init_meta_checks(objective, bad, match):
    label = np.ones(20)
    label[3] = bad
    params = {"objective": objective,
              "num_class": 3 if objective == "multiclass" else 1}
    qb = np.array([0, 10, 20])
    po = port_obj.create_objective(Config(params))
    ro = ref_obj.create_objective(RefConfig(params))
    with pytest.raises(lt.LightGBMError, match=match):
        po.init_meta(label, None, qb)
    with pytest.raises(Exception, match=match):
        ro.init_meta(label, None, qb)


def test_ranking_objectives_need_queries_and_unknown_raises():
    for name in ("lambdarank", "rank_xendcg"):
        obj = port_obj.create_objective(Config({"objective": name}))
        with pytest.raises(lt.LightGBMError, match="query information"):
            obj.init_meta(np.zeros(10), None, None)
    with pytest.raises(lt.LightGBMError, match="Unknown objective"):
        port_obj.create_objective(Config({"objective": "bogus"}))


def test_register_objective_trains_a_subclass():
    class Halved(port_obj.RegressionL2):
        name = "regression"

        def grad_hess(self, score, label, weight):
            g, h = super().grad_hess(score, label, weight)
            return 0.5 * g, h
    port_obj.register_objective("halved_l2", Halved)
    try:
        cfg = Config({"objective": "regression"})
        cfg.objective = "halved_l2"
        assert isinstance(port_obj.create_objective(cfg), Halved)
    finally:
        port_obj._TRAIN_OBJECTIVES.pop("halved_l2")
