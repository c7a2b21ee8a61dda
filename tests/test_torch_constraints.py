"""The grower's constraints against the JAX package, on the CPU.

`lightgbm_tpu_torch` with `device_type="cpu"` (the kernels' plain
versions) against `lightgbm_tpu` on its CPU backend, the same data and
params:
  * `find_best_split` with monotone directions, finite output bounds and
    CEGB penalties, batched over leaves, numerical and categorical, field
    for field against the reference's jitted search (its growers jit it:
    XLA contracts the given-output gain into one fma, which the port's
    `xla_fused` reproduces), and `decide_from_candidates` with penalties
    against the reference's;
  * monotone constraints, basic (strict and wave, f32 and quantized; the
    booster turns the wave's fusion off), intermediate with
    `feature_fraction_bynode` (the re-searched leaves draw their own
    nodes' samples) and `advanced` (downgraded to intermediate with the
    reference's warning): model text byte for byte, and the predictions
    monotone along a grid of each constrained feature;
  * interaction constraints (both growers, the wave fused, unfused and
    quantized) and CEGB (split costs at tradeoff 1 on the fused wave and
    at 0.6, coupled and lazy costs on the strict grower, all three
    together on the wave fused and unfused, and with IC on the quantized
    wave): model text byte for byte; every
    root-to-leaf path of an IC model uses features of one group.
Mirrors tests/test_constraints.py and tests/test_cegb.py.
"""
import functools
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
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu.ops import split as ref_split  # noqa: E402
from lightgbm_tpu_torch.ops import split as port_split  # noqa: E402

#: both packages get `device_type="cpu"`, so that both texts echo it
BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.2,
        "verbosity": -1, "device_type": "cpu"}
MONO = [1, -1, 0, 0, 1, 0, 0, 0]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as in test_torch_train.py (ROADMAP Queue 3
    (f))."""
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


# ----------------------------------------------------------- the search
def _leaves(seed, b=3, f=7, mb=32):
    rng = np.random.RandomState(seed)
    nb = rng.randint(3, mb + 1, f).astype(np.int32)
    nb[0] = mb
    missing = rng.randint(0, 3, f).astype(np.int32)
    default = np.array([rng.randint(0, n) for n in nb], np.int32)
    cnt = rng.poisson(30, (b, f, mb)).astype(np.float32)
    g = (rng.randn(b, f, mb) * np.sqrt(cnt + 1)).astype(np.float32)
    h = (cnt * rng.uniform(0.05, 0.25, (b, f, mb))).astype(np.float32)
    hist = np.stack([g, h, cnt], axis=-1)
    hist[:, np.arange(mb)[None, :] >= nb[:, None]] = 0.0
    parent = hist[:, 0].sum(axis=1)
    mono = rng.randint(-1, 2, f).astype(np.int32)
    lb = rng.choice([-np.inf, -0.3, -1.0], b).astype(np.float32)
    ub = rng.choice([np.inf, 0.2, 1.0], b).astype(np.float32)
    pen = (rng.rand(b, f) * 3.0).astype(np.float32)
    is_cat = rng.rand(f) < 0.3
    is_cat[0] = False
    return hist, parent, nb, missing, default, mono, lb, ub, pen, is_cat


FIELDS = ("gain", "feature", "threshold_bin", "default_left", "left_sum_g",
          "left_sum_h", "left_cnt", "right_sum_g", "right_sum_h",
          "right_cnt")


@pytest.mark.parametrize("has_cat", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_find_best_split_with_bounds_and_penalties(seed, has_cat):
    """Batched port search vs the reference's jitted single-leaf search:
    every field bitwise, `cat_mask` too with categorical features."""
    hist, parent, nb, missing, default, mono, lb, ub, pen, is_cat = \
        _leaves(seed)
    if not has_cat:
        is_cat[:] = False
    kw = dict(l1=0.1, l2=1.0, min_data_in_leaf=5.0, min_sum_hessian=1e-3,
              min_gain_to_split=0.0)
    jf = jax.jit(functools.partial(
        ref_split.find_best_split, cat_smooth=10.0, cat_l2=10.0,
        max_cat_threshold=32, max_cat_to_onehot=4, max_delta_step=0.0,
        has_cat=has_cat, **kw))
    allowed = np.ones(hist.shape[1], bool)
    extra = dict(is_cat=torch.from_numpy(is_cat), has_cat=True) \
        if has_cat else {}
    got = port_split.find_best_split(
        torch.from_numpy(hist), *(torch.from_numpy(parent[:, i].copy())
                                  for i in range(3)),
        torch.from_numpy(nb), torch.from_numpy(missing),
        torch.from_numpy(default), torch.from_numpy(allowed), 0.1, 1.0,
        5.0, 1e-3, 0.0, mono=torch.from_numpy(mono),
        out_lb=torch.from_numpy(lb), out_ub=torch.from_numpy(ub),
        gain_penalty=torch.from_numpy(pen), xla_fused=True, **extra)
    for i in range(hist.shape[0]):
        ref = jf(jnp.asarray(hist[i]), *(jnp.float32(v) for v in parent[i]),
                 jnp.asarray(nb), jnp.asarray(missing),
                 jnp.asarray(default), jnp.asarray(allowed),
                 jnp.asarray(is_cat), mono=jnp.asarray(mono),
                 out_lb=jnp.float32(lb[i]), out_ub=jnp.float32(ub[i]),
                 gain_penalty=jnp.asarray(pen[i]))
        for name in FIELDS:
            a = np.asarray(getattr(ref, name)).astype(np.float64)
            b = getattr(got, name)[i].numpy().astype(np.float64)
            assert np.array_equal(a, b), (i, name, a, b)
        if has_cat:
            assert bool(got.is_cat[i]) == bool(ref.is_cat)
            assert np.array_equal(got.cat_mask[i].numpy(),
                                  np.asarray(ref.cat_mask))


def test_unconstrained_search_is_unchanged_by_empty_constraints():
    """mono all 0 and infinite bounds leave the closed form: the same bits
    as no constraint arguments at all."""
    hist, parent, nb, missing, default, *_ = _leaves(9)
    args = (torch.from_numpy(hist), *(torch.from_numpy(parent[:, i].copy())
                                      for i in range(3)),
            torch.from_numpy(nb), torch.from_numpy(missing),
            torch.from_numpy(default),
            torch.ones(hist.shape[1], dtype=torch.bool), 0.0, 1.0, 5.0,
            1e-3, 0.0)
    plain = port_split.find_best_split(*args)
    inf = torch.full((hist.shape[0],), float("inf"))
    same = port_split.find_best_split(
        *args, mono=torch.zeros(hist.shape[1], dtype=torch.int32),
        out_lb=-inf, out_ub=inf, xla_fused=True)
    for name in FIELDS:
        assert torch.equal(getattr(plain, name), getattr(same, name)), name


def test_decide_from_candidates_with_penalty():
    hist, parent, nb, missing, default, *_, pen, _ = _leaves(5, b=4)
    kw = dict(l1=0.0, l2=1.0, min_data_in_leaf=5.0, min_sum_hessian=1e-3,
              min_gain_to_split=0.0)
    cand = port_split.fused_numerical_candidates(
        torch.from_numpy(hist).transpose(0, 1).contiguous(),
        torch.from_numpy(nb), torch.from_numpy(missing),
        torch.from_numpy(parent), **kw).permute(1, 2, 0, 3).contiguous()
    allowed = torch.ones(hist.shape[1], dtype=torch.bool)
    got = port_split.decide_from_candidates(
        cand, *(torch.from_numpy(parent[:, i].copy()) for i in range(3)),
        torch.from_numpy(missing), torch.from_numpy(default), allowed,
        torch.from_numpy(pen))
    full = port_split.find_best_split(
        torch.from_numpy(hist), *(torch.from_numpy(parent[:, i].copy())
                                  for i in range(3)),
        torch.from_numpy(nb), torch.from_numpy(missing),
        torch.from_numpy(default), allowed, 0.0, 1.0, 5.0, 1e-3, 0.0,
        gain_penalty=torch.from_numpy(pen))
    for i in range(hist.shape[0]):
        ref = ref_split.decide_from_candidates(
            jnp.asarray(cand[i].numpy()),
            *(jnp.float32(v) for v in parent[i]), jnp.asarray(missing),
            jnp.asarray(default), jnp.asarray(allowed.numpy()),
            hist.shape[2], gain_penalty=jnp.asarray(pen[i]))
        for name in FIELDS:
            a = np.asarray(getattr(ref, name)).astype(np.float64)
            assert a == float(getattr(got, name)[i]), (i, name)
            assert float(getattr(full, name)[i]) == a, (i, name)


# ------------------------------------------------------------ monotone
def _is_monotone(bst, X, feature, direction, rows=40, points=32):
    """Predictions along a grid of `feature` at `rows` held rows never
    move against `direction`."""
    grid = np.linspace(X[:, feature].min(), X[:, feature].max(), points)
    base = np.repeat(X[:rows], points, axis=0)
    base[:, feature] = np.tile(grid, rows)
    p = bst.predict(base, raw_score=True).reshape(rows, points)
    d = np.diff(p, axis=1) * direction
    return bool((d >= -1e-12).all())


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "quantized"])
@pytest.mark.parametrize("policy", ["leafwise", "wave"])
def test_monotone_basic_matches_and_is_monotone(policy, quant, caplog):
    caplog.set_level(logging.WARNING)
    X, y = _data(1)
    params = dict(BASE, monotone_constraints=MONO, tree_grow_policy=policy,
                  use_quantized_grad=quant, verbosity=0)
    bj, bp = _train_both(params, X, y)
    assert bp.model_to_string() == bj.model_to_string()
    assert not bp._grower_spec.fused
    if policy == "wave":
        assert "fused hist+split is unavailable with monotone" in caplog.text
    for f, d in ((0, 1), (1, -1), (4, 1)):
        assert _is_monotone(bp, X, f, d)
    free = lt.train(dict(params, monotone_constraints=None),
                    lt.Dataset(X, label=y), 4)
    assert free.model_to_string() != bp.model_to_string()


@pytest.mark.parametrize("extra", [{}, {"feature_fraction_bynode": 0.5}],
                         ids=["plain", "bynode"])
def test_monotone_intermediate_matches(extra):
    X, y = _data(2)
    params = dict(BASE, monotone_constraints=MONO,
                  monotone_constraints_method="intermediate", **extra)
    bj, bp = _train_both(params, X, y)
    assert bp._grower_spec.monotone_intermediate
    assert bp.model_to_string() == bj.model_to_string()
    for f, d in ((0, 1), (1, -1), (4, 1)):
        assert _is_monotone(bp, X, f, d)
    basic = lt.train(dict(params, monotone_constraints_method="basic"),
                     lt.Dataset(X, label=y), 4)
    assert basic.model_to_string() != bp.model_to_string()


def test_monotone_advanced_downgrades_to_intermediate(caplog):
    caplog.set_level(logging.WARNING)
    X, y = _data(3, n=800)
    params = dict(BASE, monotone_constraints=[1, -1],
                  monotone_constraints_method="advanced",
                  tree_grow_policy="wave", tpu_wave_overgrow=2.0,
                  verbosity=0)
    bj, bp = _train_both(params, X, y, 3)
    assert bp.model_to_string() == bj.model_to_string()
    assert "advanced is not implemented" in caplog.text
    # intermediate keeps the strict grower, and overgrow is off
    assert "tree_grow_policy=wave is not supported" in caplog.text
    assert bp._grow_policy == "leafwise"
    assert bp._grower_spec.wave_overgrow == 0.0
    inter = lt.train(dict(params, monotone_constraints_method="intermediate"),
                     lt.Dataset(X, label=y), 3)
    assert [t.to_string(i) for i, t in enumerate(inter.trees)] == \
        [t.to_string(i) for i, t in enumerate(bp.trees)]


def test_monotone_regression_alias_and_padding():
    """A shorter vector zero-extends; the alias is read; regression."""
    rng = np.random.RandomState(7)
    X = rng.rand(800, 3)
    y = 5.0 * X[:, 0] + np.sin(10 * np.pi * X[:, 0]) \
        + rng.normal(0, 0.1, 800)
    params = dict(BASE, objective="regression", monotonic_cst=[1])
    bj, bp = _train_both(params, X, y, 3)
    assert bp.model_to_string() == bj.model_to_string()
    assert _is_monotone(bp, X, 0, 1)


# --------------------------------------------- interaction constraints
IC = "[0,1,2],[3,4,5,6],[7]"


def _paths(tree):
    """The split features of every root-to-leaf path."""
    out = []
    stack = [(0, [])]
    while stack:
        node, feats = stack.pop()
        if node < 0:
            out.append(feats)
            continue
        f = int(tree.split_feature[node])
        stack.append((int(tree.left_child[node]), feats + [f]))
        stack.append((int(tree.right_child[node]), feats + [f]))
    return out


@pytest.mark.parametrize("policy,fused,quant", [
    ("leafwise", True, False), ("wave", True, False), ("wave", False, False),
    ("wave", True, True)], ids=["leafwise", "wave_fused", "wave_unfused",
                                "wave_fused_quantized"])
def test_interaction_constraints_match(policy, fused, quant):
    X, y = _data(4)
    params = dict(BASE, interaction_constraints=IC, tree_grow_policy=policy,
                  tpu_fused_split=fused, use_quantized_grad=quant)
    bj, bp = _train_both(params, X, y)
    assert bp.model_to_string() == bj.model_to_string()
    assert bp._grower_spec.fused == (policy == "wave" and fused)
    groups = [{0, 1, 2}, {3, 4, 5, 6}, {7}]
    for t in bp.trees:
        if t.num_leaves > 1:
            for feats in _paths(t):
                assert any(set(feats) <= g for g in groups), feats


CEGB = {
    # 0.3 is not f32-exact: XLA folds tradeoff x 0.3 into one constant and
    # contracts gain - c n into one fma (`ops/grow.py cegb_scale`)
    "split": {"cegb_penalty_split": 0.3},
    "split_tradeoff": {"cegb_tradeoff": 0.6, "cegb_penalty_split": 0.3},
    "coupled": {"cegb_penalty_feature_coupled": [3.0] * 8},
    "lazy": {"cegb_penalty_feature_lazy": [0.02] * 8},
    "all": {"cegb_tradeoff": 0.7, "cegb_penalty_split": 0.2,
            "cegb_penalty_feature_coupled": [1, 2, 3, 4, 5, 6, 7, 8],
            "cegb_penalty_feature_lazy": [0.01] * 8},
}


@pytest.mark.parametrize("name,policy,fused", [
    ("split", "wave", True), ("split_tradeoff", "leafwise", True),
    ("coupled", "leafwise", True), ("lazy", "leafwise", True),
    ("all", "wave", True), ("all", "wave", False)],
    ids=["split_wave_fused", "split_tradeoff", "coupled", "lazy",
         "all_wave_fused", "all_wave_unfused"])
def test_cegb_matches(name, policy, fused):
    X, y = _data(5)
    params = dict(BASE, tree_grow_policy=policy, tpu_fused_split=fused,
                  **CEGB[name])
    bj, bp = _train_both(params, X, y)
    assert bp.model_to_string() == bj.model_to_string()
    plain = lt.train({k: v for k, v in params.items()
                      if not k.startswith("cegb")}, lt.Dataset(X, label=y), 4)
    assert plain.model_to_string() != bp.model_to_string()


def test_cegb_quantized_and_ic_together():
    X, y = _data(6)
    params = dict(BASE, tree_grow_policy="wave", use_quantized_grad=True,
                  interaction_constraints=IC, **CEGB["all"])
    bj, bp = _train_both(params, X, y)
    assert bp.model_to_string() == bj.model_to_string()
    used = bp._cegb_used
    feats = {int(f) for t in bp.trees
             for f in t.split_feature[:t.num_internal()]}
    assert set(np.nonzero(used)[0].tolist()) == feats
