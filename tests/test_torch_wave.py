"""The wave grower (`lightgbm_tpu_torch/ops/grow_wave.py`) against the JAX
package's, on the CPU.

  * the port's `make_wave_grower` against the reference's, from the same
    numpy inputs with the reference's `segment_sum` histograms: every
    `DeviceTree` field equal, bitwise, over wave widths 1, 4 and 8, a
    strict tail, the capacity-aware gain floor, grow-then-prune and
    max_depth, on the port's unfused and fused (K2/K3 plain versions)
    paths;
  * the port's fused and unfused wave trees are byte-identical;
  * width 1 is strict: `tpu_wave_strict_tail >= num_leaves` gives the
    port's strict grower's model;
  * `lt.train` against `lgb.train` with `tree_grow_policy=wave` on the
    binary, regression L2 and multiclass golden cases
    (`test_torch_train._assert_same_trees`: structure equal, leaf values
    bitwise for regression, the golden tolerance otherwise);
  * the booster's policy resolution: width default and cap, the auto
    strict tail, overgrow under path smoothing, the fused choice, an
    unknown policy.
"""
import logging
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).parent))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from golden_common import GOLDEN_CASES, make_case_data  # noqa: E402
from lightgbm_tpu.ops.grow import GrowerSpec as RefSpec  # noqa: E402
from lightgbm_tpu.ops.grow_wave import \
    make_wave_grower as ref_wave_grower  # noqa: E402
from lightgbm_tpu_torch.ops import grow_wave  # noqa: E402
from lightgbm_tpu_torch.ops.grow import GrowerSpec  # noqa: E402
from test_torch_train import _assert_same_trees  # noqa: E402

MB = 32
FIELDS = ("split_leaf", "split_feature", "threshold_bin", "default_left",
          "split_gain", "internal_g", "internal_h", "internal_cnt",
          "leaf_value", "leaf_g", "leaf_h", "leaf_cnt", "leaf_id")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Gradients and links go through sigmoid and softmax: one intra-op
    thread keeps this CPU torch build's first-call `exp` fault out of
    the comparison (ROADMAP Queue 3 (f))."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _case(seed=7, n=3000, f=6):
    """Bins with a short feature (nb 17), a NaN-missing and a
    zero-missing feature; regression-like gradients."""
    rng = np.random.RandomState(seed)
    nb = np.full(f, MB, np.int32)
    nb[1] = 17
    missing = np.zeros(f, np.int32)
    missing[2] = 2
    missing[4] = 1
    default = np.zeros(f, np.int32)
    default[4] = 6
    bins = (rng.randint(0, 1 << 16, (f, n)) % nb[:, None]).astype(np.uint8)
    grad = (rng.randn(n) + 0.8 * (bins[0] > 12) - 0.6 * (bins[3] < 5))\
        .astype(np.float32)
    hess = (0.1 + rng.rand(n)).astype(np.float32)
    return bins, grad, hess, nb, missing, default


def _spec_kw(**over):
    kw = dict(num_leaves=15, max_depth=0, max_bin=MB, lambda_l1=0.0,
              lambda_l2=1.0, min_data_in_leaf=5.0,
              min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
              max_delta_step=0.0, wave_width=4)
    kw.update(over)
    return kw


def _grow_port(case, fused=False, **over):
    bins, grad, hess, nb, missing, default = case
    t = torch.from_numpy
    feat = dict(nb=t(nb), missing=t(missing), default=t(default),
                nb_np=nb, missing_np=missing)
    grow = grow_wave.make_wave_grower(GrowerSpec(**_spec_kw(**over),
                                                 fused=fused))
    return grow(t(bins), t(grad), t(hess), torch.ones(len(grad)), feat,
                torch.ones(len(nb), dtype=torch.bool))


def _grow_ref(case, **over):
    bins, grad, hess, nb, missing, default = case
    f = len(nb)
    feat = dict(nb=jnp.asarray(nb), missing=jnp.asarray(missing),
                default=jnp.asarray(default), is_cat=jnp.zeros(f, bool),
                mono=jnp.zeros(f, jnp.int32))
    grow = ref_wave_grower(RefSpec(**_spec_kw(**over),
                                   hist_impl="segment_sum", has_cat=False))
    return grow(jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
                jnp.ones(len(grad), jnp.float32), feat, jnp.ones(f, bool))


def _assert_trees_equal(a, b, ctx):
    assert int(a.n_splits) == int(b.n_splits), ctx
    for name in FIELDS:
        x = np.ascontiguousarray(np.asarray(getattr(a, name)))
        y = np.ascontiguousarray(np.asarray(getattr(b, name)))
        assert x.shape == y.shape, (ctx, name)
        if x.dtype != y.dtype:
            x = x.astype(y.dtype)
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), \
            (ctx, name)


# (id, spec overrides) — each row is held against the reference on both
# of the port's paths
AGAINST_REFERENCE = [
    ("w1", dict(wave_width=1)),
    ("w4", dict(wave_width=4)),
    ("w8", dict(wave_width=8)),
    ("w4_tail5", dict(wave_width=4, wave_strict_tail=5)),
    ("w8_ratio08", dict(wave_width=8, wave_gain_ratio=0.8)),
    ("w8_tail5_ratio08", dict(wave_width=8, wave_strict_tail=5,
                              wave_gain_ratio=0.8)),
    ("w8_overgrow15", dict(wave_width=8, wave_overgrow=1.5)),
    ("w4_depth3", dict(wave_width=4, max_depth=3, lambda_l1=0.2,
                       min_data_in_leaf=40.0)),
]


@pytest.fixture(scope="module")
def case():
    return _case()


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("over", [o for _, o in AGAINST_REFERENCE],
                         ids=[i for i, _ in AGAINST_REFERENCE])
def test_wave_tree_equals_the_references(case, over, fused):
    want = _grow_ref(case, **over)
    got = _grow_port(case, fused=fused, **over)
    assert got.n_splits > 3
    _assert_trees_equal(got, want, over)
    assert got.leaf_id.dtype == torch.int32
    assert torch.equal(got.values, torch.from_numpy(got.leaf_value))


def test_wave_counts_its_waves(case):
    waves, hist_waves = grow_wave.WAVES, grow_wave.HIST_WAVES
    got = _grow_port(case, fused=True, wave_width=4, num_leaves=15)
    d_waves = grow_wave.WAVES - waves
    d_hist = grow_wave.HIST_WAVES - hist_waves
    assert got.n_splits == 14
    # four 4-wide waves cover 14 splits; the last one fills the tree
    assert d_hist == d_waves - 1 and 4 <= d_waves <= 14


@pytest.mark.parametrize("over", [dict(hist_impl="plain"),
                                  dict(path_smooth=1.0)],
                         ids=["plain_hist", "path_smooth"])
def test_fused_spec_it_cannot_run_raises(over):
    """The booster alone decides the fused path (`fused_split_of`); the
    grower refuses a fused spec it cannot run instead of running it
    unfused."""
    with pytest.raises(lt.LightGBMError, match="fused wave path"):
        grow_wave.make_wave_grower(GrowerSpec(**_spec_kw(**over),
                                              fused=True))


@pytest.mark.parametrize("over", [dict(wave_width=3), dict(
    wave_width=14, num_leaves=31, wave_strict_tail=8, lambda_l1=0.5)])
def test_fused_and_unfused_are_byte_identical(over):
    case = _case(seed=11, n=2500)
    a = _grow_port(case, fused=False, **over)
    b = _grow_port(case, fused=True, **over)
    _assert_trees_equal(a, b, over)


@pytest.mark.parametrize("params", [
    {"objective": "binary", "num_leaves": 15},
    {"objective": "regression", "num_leaves": 20, "max_depth": 5,
     "lambda_l1": 0.3, "max_delta_step": 0.8, "path_smooth": 1.5,
     "min_data_in_leaf": 8}], ids=["binary", "regression_options"])
def test_width_one_is_strict(params):
    rng = np.random.RandomState(5)
    X = rng.randn(2500, 6)
    X[rng.rand(2500) < 0.1, 2] = np.nan
    y = X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.randn(2500)
    if params["objective"] == "binary":
        y = (y > 0).astype(float)
    texts = {}
    for pol, extra in (("leafwise", {}),
                       ("wave", {"tpu_wave_strict_tail": 1000,
                                 "tpu_wave_gain_ratio": 0})):
        bst = lt.train(dict(params, verbosity=-1, device_type="cpu",
                            tree_grow_policy=pol, **extra),
                       lt.Dataset(X, label=y), num_boost_round=6)
        texts[pol] = [t.to_string(i) for i, t in enumerate(bst.trees)]
    assert texts["leafwise"] == texts["wave"]


WAVE = {"tree_grow_policy": "wave", "tpu_wave_width": 4,
        "tpu_wave_strict_tail": 4}


@pytest.mark.parametrize("name", ["binary", "regression_l2", "multiclass"])
def test_train_matches_the_reference(name):
    c = GOLDEN_CASES[name]
    X, y = make_case_data(c)
    params = dict(c["params"], **WAVE)
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y),
                   num_boost_round=c["rounds"])
    bp = lt.train(dict(params, device_type="cpu"), lt.Dataset(X, label=y),
                  num_boost_round=c["rounds"])
    assert bp._grower_spec.fused and bp._grow_policy == "wave"
    _assert_same_trees(bj, bp, bitwise=name == "regression_l2")


# ------------------------------------------------------- policy resolution
def _booster(**params):
    rng = np.random.RandomState(0)
    X = rng.randn(300, 4)
    return lt.Booster(dict({"objective": "binary", "verbosity": -1,
                            "device_type": "cpu", "num_leaves": 31},
                           **params),
                      lt.Dataset(X, label=(X[:, 0] > 0).astype(float)))


def test_policy_resolution():
    strict = _booster()
    assert strict._grow_policy == "leafwise"
    assert not strict._grower_spec.fused
    assert strict._grower_spec.wave_width == 0
    wave = _booster(tree_grow_policy="wave")
    spec = wave._grower_spec
    assert wave._grow_policy == "wave" and spec.fused
    assert spec.wave_width == grow_wave.WAVE_WIDTH_DEFAULT == 6
    assert spec.wave_strict_tail == 16          # (31 + 1) // 2
    assert spec.wave_gain_ratio == 0.0 and spec.wave_overgrow == 0.0
    assert _booster(tree_grow_policy="batched")._grow_policy == "wave"
    capped = _booster(tree_grow_policy="wave", tpu_wave_width=40,
                      tpu_wave_gain_ratio=3.0)._grower_spec
    assert capped.wave_width == 14 and capped.wave_gain_ratio == 1.0
    og = _booster(tree_grow_policy="wave", tpu_wave_overgrow=2.0)
    assert og._grower_spec.wave_overgrow == 2.0
    assert og._grower_spec.wave_width == 14      # auto width under overgrow
    assert og._grower_spec.wave_strict_tail == 0
    unfused = _booster(tree_grow_policy="wave", tpu_fused_split=False)
    assert not unfused._grower_spec.fused
    seg = _booster(tree_grow_policy="wave", hist_impl="segment_sum")
    assert not seg._grower_spec.fused
    with pytest.raises(lt.LightGBMError, match="Unknown tree_grow_policy"):
        _booster(tree_grow_policy="bogus")


def test_path_smoothing_turns_off_overgrow_and_fusion(caplog):
    caplog.set_level(logging.WARNING)
    bst = _booster(tree_grow_policy="wave", tpu_wave_overgrow=2.0,
                   path_smooth=1.0, verbosity=0)
    spec = bst._grower_spec
    assert spec.wave_overgrow == 0.0 and not spec.fused
    text = caplog.text
    assert "tpu_wave_overgrow is not supported" in text
    assert "fused hist+split is unavailable with path_smooth" in text
