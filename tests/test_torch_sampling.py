"""The port's samplers against the live JAX package, on the CPU, bit for
bit (threefry draws and f32 compares: no tolerance).

  * `bagging_weights`, `goss_weights` and `feature_mask`
    (`lightgbm_tpu_torch/ops/fused.py`) against `lightgbm_tpu/ops/
    fused.py`'s on the same keys and numpy-made gradients: GOSS on binary
    [N] and multiclass [N, K] gradients, with tied |g h| at the cut, and
    with `it` on both sides of `goss_start_iter`;
  * the per-node samplers (`ops/grow.py make_node_samplers`: every node's
    bynode mask and extra_trees candidate grid, drawn for a whole tree at
    once) against the reference's `make_node_samplers`, node by node;
  * the growers with per-node sampling against the reference's growers,
    every `DeviceTree` field bitwise;
  * the booster's wiring: the quantized lattice's fallback under GOSS and
    the fusion's under extra_trees, each with the reference's warning.
"""
import logging
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).parent))

import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu.ops import fused as ref_fused  # noqa: E402
from lightgbm_tpu.ops.grow import GrowerSpec as RefSpec  # noqa: E402
from lightgbm_tpu.ops.grow import make_grower as ref_grower  # noqa: E402
from lightgbm_tpu.ops.grow import \
    make_node_samplers as ref_node_samplers  # noqa: E402
from lightgbm_tpu.ops.grow_wave import \
    make_wave_grower as ref_wave_grower  # noqa: E402
from lightgbm_tpu_torch.ops import fused, threefry  # noqa: E402
from lightgbm_tpu_torch.ops.grow import (GrowerSpec, make_grower,  # noqa: E402
                                         make_node_samplers)
from lightgbm_tpu_torch.ops.grow_wave import make_wave_grower  # noqa: E402
from test_torch_wave import _assert_trees_equal  # noqa: E402

SEEDS = [3, 2 ** 31 - 1]


def _keys(seed):
    return threefry.prng_key(seed), jax.random.PRNGKey(seed)


def _assert_bitwise(got, want, ctx=""):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, ctx
    view = {1: np.uint8, 4: np.uint32, 8: np.uint64}[got.itemsize]
    assert np.array_equal(got.view(view), want.view(view)), ctx


# --------------------------------------------------------------- bagging
@pytest.mark.parametrize("freq", [1, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_bagging_weights_match(seed, freq):
    kp, kj = _keys(seed)
    for it in (0, 1, 5):
        for frac in (0.5, 0.7, 0.9):
            want = ref_fused.bagging_weights(jnp.int32(it), kj, 3001,
                                             bagging_fraction=frac,
                                             bagging_freq=freq)
            got = fused.bagging_weights(it, kp, 3001, "cpu",
                                        bagging_fraction=frac,
                                        bagging_freq=freq)
            _assert_bitwise(got, want, (it, frac))
            assert 0 < float(got.sum()) < 3001


# ------------------------------------------------------------------- GOSS
def _goss_grads(seed, shape, ties):
    rng = np.random.RandomState(seed)
    g = (rng.randn(*shape) * 0.8).astype(np.float32)
    h = (0.05 + rng.rand(*shape) * 0.2).astype(np.float32)
    if ties:
        # a block of rows with one |g h| that straddles the top-rate cut,
        # and exact zeros at the bottom
        n = shape[0]
        order = np.argsort(-np.abs((g * h).reshape(n, -1).sum(1)))
        g[order[n // 5 - 40:n // 5 + 40]] = 0.5
        h[order[n // 5 - 40:n // 5 + 40]] = 0.25
        g[order[-30:]] = 0.0
    return g, h


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("k", [1, 3], ids=["binary", "multiclass"])
def test_goss_weights_match(k, ties):
    shape = (4000,) if k == 1 else (4000, k)
    g, h = _goss_grads(k + 10 * ties, shape, ties)
    kp, kj = _keys(3)
    start = 2
    for it in (1, 2, 7):
        for a, b in ((0.2, 0.1), (0.3, 0.25), (0.05, 0.5)):
            want = ref_fused.goss_weights(
                jnp.int32(it), kj, jnp.asarray(g), jnp.asarray(h), 4000,
                top_rate=a, other_rate=b, goss_start_iter=start)
            got = fused.goss_weights(
                it, kp, torch.from_numpy(g), torch.from_numpy(h),
                top_rate=a, other_rate=b, goss_start_iter=start)
            _assert_bitwise(got, want, (it, a, b))
            if it < start:
                assert bool((got == 1).all())
            else:
                assert float(got.max()) > 1.0 and float(got.min()) == 0.0


def test_goss_multiclass_score_adds_in_the_references_order():
    """Three classes whose |g h| sums round differently in another
    order: the weights still match (`tree_sum`, XLA's CPU order)."""
    rng = np.random.RandomState(8)
    g = (rng.rand(5000, 3) * np.array([1e4, 1.0, 1e-4])).astype(np.float32)
    h = np.ones((5000, 3), np.float32)
    g[:, 1] = -g[:, 1]
    kp, kj = _keys(5)
    want = ref_fused.goss_weights(jnp.int32(4), kj, jnp.asarray(g),
                                  jnp.asarray(h), 5000, top_rate=0.2,
                                  other_rate=0.1, goss_start_iter=0)
    got = fused.goss_weights(4, kp, torch.from_numpy(g), torch.from_numpy(h),
                             top_rate=0.2, other_rate=0.1, goss_start_iter=0)
    _assert_bitwise(got, want)


# -------------------------------------------------------- feature_fraction
@pytest.mark.parametrize("f", [1, 6, 28, 300])
def test_feature_mask_matches(f):
    kp, kj = _keys(2)
    base = np.ones(f, bool)
    base[f // 2] = f == 1
    for it in (0, 4):
        for k in (0, 2):
            for frac in (0.1, 0.5, 0.8, 1.0):
                want = ref_fused.feature_mask(jnp.int32(it), k, kj,
                                              jnp.asarray(base),
                                              feature_fraction=frac)
                got = fused.feature_mask(it, k, kp, torch.from_numpy(base),
                                         feature_fraction=frac)
                _assert_bitwise(got, want, (it, k, frac))


# ------------------------------------------------------- per-node samplers
def _node_setup(f, mb, bynode, extra, seed=4):
    rng = np.random.RandomState(seed)
    nb = rng.randint(1, mb + 1, f).astype(np.int32)
    tree_key = (threefry.fold_in(threefry.fold_in(
        threefry.prng_key(seed), 2 ** 20 + 3), 1),
        jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), 2 ** 20 + 3), 1))
    kw = dict(num_leaves=31, max_depth=0, max_bin=mb, lambda_l1=0.0,
              lambda_l2=0.0, min_data_in_leaf=1.0,
              min_sum_hessian_in_leaf=0.0, min_gain_to_split=0.0,
              max_delta_step=0.0, feature_fraction_bynode=bynode,
              extra_trees=extra)
    port = make_node_samplers(GrowerSpec(**kw), {
        "ff_key": tree_key[0], "nb": torch.from_numpy(nb)}, f, 61, "cpu")
    ref = ref_node_samplers(RefSpec(**kw, num_features_hint=f,
                                    has_cat=False), {
        "ff_key": tree_key[1], "nb": jnp.asarray(nb),
        "is_cat": jnp.zeros(f, bool)}, f)
    return port, ref


@pytest.mark.parametrize("f,mb", [(1, 4), (6, 32), (28, 255)])
def test_node_samplers_match_node_by_node(f, mb):
    port, (bynode, extra) = _node_setup(f, mb, 0.5, True)
    base = torch.ones(f, dtype=torch.bool)
    for nid in range(61):
        _assert_bitwise(port.allowed(nid, base),
                        bynode(jnp.int32(nid)), nid)
        _assert_bitwise(port.cand(nid, mb), extra(jnp.int32(nid)), nid)
    # a batch of node ids reads the same rows
    nids = torch.tensor([5, 0, 60, 5])
    assert torch.equal(port.cand(nids, mb)[2], port.cand(60, mb))
    assert torch.equal(port.allowed(nids, base)[0], port.allowed(5, base))


def test_node_samplers_off():
    port, (bynode, extra) = _node_setup(6, 32, 1.0, False)
    assert port.bynode is None and port.pick is None
    assert port.cand(3, 32) is None and extra(3) is None
    base = torch.tensor([True, False, True, True, True, True])
    assert port.allowed(3, base) is base


def _grow_inputs(seed=7, n=3000, f=8, mb=32):
    rng = np.random.RandomState(seed)
    nb = np.full(f, mb, np.int32)
    nb[1] = 17
    missing = np.zeros(f, np.int32)
    missing[2] = 2
    default = np.zeros(f, np.int32)
    bins = (rng.randint(0, 1 << 16, (f, n)) % nb[:, None]).astype(np.uint8)
    grad = (rng.randn(n) + 0.8 * (bins[0] > 12) - 0.6 * (bins[3] < 5)
            + 0.4 * (bins[5] > 20)).astype(np.float32)
    hess = (0.1 + rng.rand(n)).astype(np.float32)
    w = (rng.rand(n) < 0.8).astype(np.float32)
    return bins, grad, hess, w, nb, missing, default


@pytest.mark.parametrize("wave", [False, True], ids=["strict", "wave"])
@pytest.mark.parametrize("bynode,extra", [(0.5, False), (1.0, True),
                                          (0.4, True)],
                         ids=["bynode", "extra", "both"])
def test_grown_trees_with_node_sampling_match(wave, bynode, extra):
    bins, g, h, w, nb, missing, default = _grow_inputs()
    f = len(nb)
    kw = dict(num_leaves=15, max_depth=0, max_bin=32, lambda_l1=0.0,
              lambda_l2=1.0, min_data_in_leaf=5.0,
              min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
              max_delta_step=0.0, feature_fraction_bynode=bynode,
              extra_trees=extra)
    if wave:
        kw.update(wave_width=4, wave_strict_tail=4)
    key = (threefry.fold_in(threefry.prng_key(9), 2 ** 20),
           jax.random.fold_in(jax.random.PRNGKey(9), 2 ** 20))
    allowed = np.ones(f, bool)
    allowed[6] = False
    ref_spec = RefSpec(**kw, hist_impl="segment_sum", num_features_hint=f,
                       has_cat=False)
    want = (ref_wave_grower if wave else ref_grower)(ref_spec)(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        dict(nb=jnp.asarray(nb), missing=jnp.asarray(missing),
             default=jnp.asarray(default), is_cat=jnp.zeros(f, bool),
             mono=jnp.zeros(f, jnp.int32), ff_key=key[1]),
        jnp.asarray(allowed))
    t = torch.from_numpy
    feat = dict(nb=t(nb), missing=t(missing), default=t(default),
                nb_np=nb, missing_np=missing, ff_key=key[0])
    impls = [("plain", False)] + ([("kernel", True)]
                                  if wave and not extra else [])
    for impl, fused_path in impls:
        spec = GrowerSpec(**kw, hist_impl=impl, fused=fused_path)
        got = (make_wave_grower if wave else make_grower)(spec)(
            t(bins), t(g), t(h), t(w), feat, t(allowed))
        assert got.n_splits > 5
        _assert_trees_equal(got, want, (impl, fused_path))


# ---------------------------------------------------- the booster's wiring
def _small_binary():
    rng = np.random.RandomState(0)
    X = rng.randn(600, 5)
    return X, (X[:, 0] + 0.3 * rng.randn(600) > 0).astype(float)


def test_quantized_goss_trains_on_f32_histograms_with_a_warning(caplog):
    X, y = _small_binary()
    caplog.set_level(logging.WARNING)
    bst = lt.train({"objective": "binary", "verbosity": 0,
                    "device_type": "cpu", "boosting": "goss",
                    "use_quantized_grad": True, "learning_rate": 0.5},
                   lt.Dataset(X, label=y), num_boost_round=3)
    assert bst.hist_impl == "kernel" and bst.num_trees() == 3
    assert "GOSS rescale weights break lattice integrality" in caplog.text
    bag = lt.train({"objective": "binary", "verbosity": -1,
                    "device_type": "cpu", "use_quantized_grad": True,
                    "bagging_fraction": 0.5, "bagging_freq": 1},
                   lt.Dataset(X, label=y), num_boost_round=2)
    assert bag.hist_impl == "kernel_q"


def test_extra_trees_takes_the_unfused_wave_with_a_warning(caplog):
    X, y = _small_binary()
    caplog.set_level(logging.WARNING)
    params = {"objective": "binary", "verbosity": 0, "device_type": "cpu",
              "tree_grow_policy": "wave"}
    bst = lt.train(dict(params, extra_trees=True), lt.Dataset(X, label=y),
                   num_boost_round=2)
    assert not bst._grower_spec.fused
    assert "fused hist+split is unavailable with extra_trees" in caplog.text
    bynode = lt.train(dict(params, feature_fraction_bynode=0.5),
                      lt.Dataset(X, label=y), num_boost_round=2)
    assert bynode._grower_spec.fused


def test_the_samplers_keep_their_keys_on_the_host():
    """The keys stay on the CPU (their words reach the card as kernel
    arguments) and match the reference's."""
    X, y = _small_binary()
    params = {"objective": "binary", "verbosity": -1, "bagging_seed": 11,
              "feature_fraction_seed": 2 ** 31 + 4}
    bp = lt.Booster(dict(params, device_type="cpu"), lt.Dataset(X, label=y))
    import lightgbm_tpu as lgb
    bj = lgb.Booster(dict(params), lgb.Dataset(X, label=y))
    for a, b in ((bp._rng_key0, bj._rng_key0), (bp._ff_key0, bj._ff_key0)):
        assert a.device.type == "cpu"
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64))
