"""Continued training and the ways a training booster's model changes,
in `lightgbm_tpu_torch` against the live JAX package, on the CPU.

The port trains with `device_type="cpu"`; each case runs the same calls
on both packages from the same numpy data.  Model texts must be the
reference's byte for byte (less the port's `[device_type: cpu]` line),
and the f32 train and valid scores bitwise the reference's, for:
  * `init_model` as a port booster, as a model file written by the port
    (raw data freed: the init model replayed on the bins) and as a model
    text the JAX package trained (raw data kept: its f32 raw
    prediction), under both growers, f32 and quantized, on the binary,
    regression and multiclass families;
  * `init_score` on the train and valid sets;
  * `add_valid` after `update` (the model replayed onto the new set);
    the replayed scores differ from those of a booster that had the set
    from the start wherever boost_from_average folded a bias into the
    first trees, in both packages alike;
  * `rollback_one_iter`, one deep (the cached contributions:
    `(s + c) - c`) and several deep (the bin-level replay);
  * a `reset_parameter` schedule as a list and as a callable, and
    `Booster.reset_parameter` rebuilding the wave grower's spec as a
    fresh booster with the new parameters builds it;
  * `refit`;
  * `feval` returning one tuple and a list of tuples.
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
import lightgbm_tpu_torch.booster as booster_module  # noqa: E402

ROWS = 1500


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread keeps this CPU torch build's first-call `exp`
    fault out of the comparison (ROADMAP Queue 3 (f))."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _data(family, seed=0, n=ROWS):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    z = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(n)
    if family == "binary":
        y = (z > 0).astype(float)
    elif family == "multiclass":
        y = np.digitize(z, [-0.7, 0.7]).astype(float)
    else:
        y = z
    return X, y


FAMILY = {"binary": {"objective": "binary"},
          "regression": {"objective": "regression"},
          "multiclass": {"objective": "multiclass", "num_class": 3}}
GROWER = {"strict": {},
          "wave": {"tree_grow_policy": "wave"},
          "strict_quant": {"use_quantized_grad": True},
          "wave_quant": {"tree_grow_policy": "wave",
                         "use_quantized_grad": True}}
# the reference's CPU "auto" takes the packed histograms with a derived
# count for unit-hessian objectives: hold regression there bitwise
PACKED = {"hist_impl": "packed"}


def _params(family, grower, **extra):
    p = dict({"num_leaves": 15, "verbosity": -1, "learning_rate": 0.2},
             **FAMILY[family], **GROWER[grower], **extra)
    if family == "regression" and "quant" in grower:
        p.update(PACKED)
    return p


def _pkg(m, params):
    return dict(params, device_type="cpu") if m is lt else dict(params)


def _text(bst):
    return bst.model_to_string().replace("[device_type: cpu]\n", "")


def _np(score):
    return score.numpy() if isinstance(score, torch.Tensor) \
        else np.asarray(score)


def _same(bj, bp, scores=True):
    assert _text(bp) == _text(bj)
    if scores:
        assert np.array_equal(_np(bp._train_score), _np(bj._train_score))
        assert len(bp._valid_scores) == len(bj._valid_scores)
        for a, b in zip(bj._valid_scores, bp._valid_scores):
            assert np.array_equal(_np(b), _np(a))


CONTINUED = [("binary", "strict"), ("regression", "wave"),
             ("multiclass", "wave_quant"), ("binary", "strict_quant")]


@pytest.mark.parametrize("family,grower", CONTINUED,
                         ids=[f"{f}-{g}" for f, g in CONTINUED])
def test_init_model_from_a_booster(family, grower):
    X, y = _data(family)
    Xv, yv = _data(family, seed=1, n=400)
    params = _params(family, grower)

    def run(m):
        first = m.train(_pkg(m, params), m.Dataset(X, label=y), 3)
        return m.train(_pkg(m, params), m.Dataset(X, label=y), 3,
                       valid_sets=[m.Dataset(Xv, label=yv)],
                       init_model=first)

    bj, bp = run(lgb), run(lt)
    _same(bj, bp)
    assert bp.current_iteration() == 6
    assert len(bp.trees) == 6 * bp.num_tree_per_iteration


@pytest.mark.parametrize("free_raw_data", [True, False])
def test_init_model_from_a_file_the_port_wrote(tmp_path, free_raw_data):
    """Freed raw data: the train score is the init model replayed on the
    bins; kept: the f32 cast of its raw prediction."""
    X, y = _data("binary")
    params = _params("binary", "wave")
    path = str(tmp_path / "init.txt")
    lt.train(_pkg(lt, params), lt.Dataset(X, label=y), 4).save_model(path)

    def run(m):
        return m.train(_pkg(m, params),
                       m.Dataset(X, label=y, free_raw_data=free_raw_data),
                       3, init_model=path)

    bj, bp = run(lgb), run(lt)
    _same(bj, bp)
    with open(path) as f:
        saved = f.read()
    head = saved.split("end of trees")[0].split("Tree=4")[0]
    assert _text(bp).split("Tree=4")[0].split("tree_sizes=")[1].split(
        "\n", 1)[1] == head.split("tree_sizes=")[1].split("\n", 1)[1]


@pytest.mark.parametrize("family", ["binary", "multiclass"])
def test_init_model_from_a_model_the_jax_package_trained(tmp_path, family):
    """The weights carried across: the JAX package trains and saves, both
    packages continue from its text."""
    X, y = _data(family)
    params = _params(family, "strict")
    path = str(tmp_path / "jax.txt")
    lgb.train(dict(params), lgb.Dataset(X, label=y), 3).save_model(path)

    def run(m):
        return m.train(_pkg(m, params),
                       m.Dataset(X, label=y, free_raw_data=False), 2,
                       init_model=path)

    bj, bp = run(lgb), run(lt)
    _same(bj, bp)
    raw = lt.Booster(model_file=path).predict(X, raw_score=True)
    first = lt.train(_pkg(lt, params),
                     lt.Dataset(X, label=y, free_raw_data=False), 0,
                     init_model=path)
    assert np.array_equal(first._train_score.numpy(),
                          raw.astype(np.float32))


def test_init_model_checks():
    X, y = _data("binary")
    multi = lt.train(_pkg(lt, _params("multiclass", "strict")),
                     lt.Dataset(*_data("multiclass")), 1)
    with pytest.raises(lt.LightGBMError, match="num_tree_per_iteration"):
        lt.train(_pkg(lt, _params("binary", "strict")),
                 lt.Dataset(X, label=y), 1, init_model=multi)
    noise = np.random.RandomState(2).randn(*X.shape) * 0.01
    wide = lt.train(_pkg(lt, _params("binary", "strict")),
                    lt.Dataset(np.hstack([noise, X]), label=y), 2)
    with pytest.raises(lt.LightGBMError, match="has only 6 features"):
        lt.train(_pkg(lt, _params("binary", "strict")),
                 lt.Dataset(X, label=y), 1, init_model=wide)


@pytest.mark.parametrize("family", ["binary", "regression", "multiclass"])
def test_init_score_on_train_and_valid(family):
    X, y = _data(family)
    Xv, yv = _data(family, seed=1, n=400)
    K = 3 if family == "multiclass" else 1
    rng = np.random.RandomState(5)
    init = rng.randn(len(y) * K) * 0.3
    vinit = rng.randn(len(yv) * K) * 0.3
    params = _params(family, "wave")

    def run(m):
        ds = m.Dataset(X, label=y, init_score=init)
        return m.train(_pkg(m, params), ds, 3,
                       valid_sets=[ds.create_valid(Xv, label=yv,
                                                   init_score=vinit)])

    bj, bp = run(lgb), run(lt)
    _same(bj, bp)
    ds = lt.Dataset(X, label=y)
    assert ds.set_init_score(init) is ds
    ds.construct()
    assert np.array_equal(ds.get_init_score(), init)


@pytest.mark.parametrize("boost_from_average", [True, False])
def test_add_valid_after_update(boost_from_average):
    X, y = _data("binary")
    Xv, yv = _data("binary", seed=1, n=400)
    params = _params("binary", "strict",
                     boost_from_average=boost_from_average)

    def late(m):
        b = m.Booster(_pkg(m, params), m.Dataset(X, label=y))
        for _ in range(3):
            b.update()
        b.add_valid(m.Dataset(Xv, label=yv), "late")
        return b

    def early(m):
        b = m.Booster(_pkg(m, params), m.Dataset(X, label=y))
        b.add_valid(m.Dataset(Xv, label=yv), "early")
        for _ in range(3):
            b.update()
        return b

    bj, bp = late(lgb), late(lt)
    _same(bj, bp)
    ej, ep = early(lgb), early(lt)
    _same(ej, ep)
    replayed = bp._valid_scores[0].numpy()
    from_start = ep._valid_scores[0].numpy()
    # the replay adds f32(first tree + bias); from the start the bias was
    # added to the score first: the two orders round differently
    differ = np.sum(replayed != from_start)
    ref_differ = np.sum(np.asarray(bj._valid_scores[0])
                        != np.asarray(ej._valid_scores[0]))
    assert differ == ref_differ
    if boost_from_average:
        assert differ > 0
        np.testing.assert_allclose(replayed, from_start, rtol=0, atol=1e-6)
    else:
        assert differ == 0


@pytest.mark.parametrize("grower", ["strict", "wave_quant"])
def test_rollback_one_and_several_deep(grower):
    X, y = _data("binary")
    Xv, yv = _data("binary", seed=1, n=400)
    params = _params("binary", grower)

    def run(m, updates, rollbacks):
        b = m.Booster(_pkg(m, params), m.Dataset(X, label=y))
        b.add_valid(m.Dataset(Xv, label=yv), "v")
        for _ in range(updates):
            b.update()
        for _ in range(rollbacks):
            b.rollback_one_iter()
        return b

    for rollbacks in (1, 3):
        bj, bp = run(lgb, 4, rollbacks), run(lt, 4, rollbacks)
        _same(bj, bp)
        fresh = run(lt, 4 - rollbacks, 0)
        assert _text(bp) == _text(fresh)
        np.testing.assert_allclose(bp._train_score.numpy(),
                                   fresh._train_score.numpy(), atol=1e-5)
    # rolled back to nothing: the bias went with iteration 0
    bj, bp = run(lgb, 2, 3), run(lt, 2, 3)
    _same(bj, bp)
    assert bp.current_iteration() == 0
    # and training on goes the reference's way
    for b in (bj, bp):
        b.update()
    _same(bj, bp)


def test_rollback_multiclass_keeps_the_reference_bits():
    X, y = _data("multiclass")
    params = _params("multiclass", "wave")

    def run(m):
        b = m.Booster(_pkg(m, params), m.Dataset(X, label=y))
        b.add_valid(m.Dataset(*_data("multiclass", 1, 300)), "v")
        for _ in range(3):
            b.update()
        b.rollback_one_iter()
        b.rollback_one_iter()
        return b

    _same(run(lgb), run(lt))


SCHEDULES = {
    "list": lambda: {"learning_rate": [0.3, 0.2, 0.1, 0.05],
                     "num_leaves": [15, 15, 7, 7]},
    "callable": lambda: {"learning_rate": lambda i: 0.3 * 0.9 ** i},
}


@pytest.mark.parametrize("schedule,grower", [("list", "strict"),
                                              ("callable", "strict"),
                                              ("callable", "wave")])
def test_reset_parameter_schedule(schedule, grower):
    X, y = _data("binary")
    Xv, yv = _data("binary", seed=1, n=400)
    params = _params("binary", grower)

    def run(m):
        rec = {}
        bst = m.train(_pkg(m, params), m.Dataset(X, label=y), 4,
                      valid_sets=[m.Dataset(Xv, label=yv)],
                      callbacks=[m.reset_parameter(**SCHEDULES[schedule]()),
                                 m.record_evaluation(rec)])
        return bst, rec

    (bj, rj), (bp, rp) = run(lgb), run(lt)
    _same(bj, bp)
    assert rp == rj
    shrink = [float(t.shrinkage) for t in bp.trees]
    lr = SCHEDULES[schedule]()["learning_rate"]
    expect = lr if isinstance(lr, list) else [lr(i) for i in range(4)]
    assert shrink == pytest.approx(expect, rel=0, abs=0)


def test_reset_parameter_rebuilds_the_wave():
    """31 -> 7 leaves and a new width at round 2: the grower's spec is the
    one a fresh booster with the new parameters builds (the reference
    keeps the old strict tail: ROADMAP Queue 3), and its trees are that
    booster's on the same scores."""
    X, y = _data("binary")
    params = _params("binary", "wave", num_leaves=31)
    new = {"num_leaves": 7, "tpu_wave_width": 4, "learning_rate": 0.1}
    bst = lt.Booster(_pkg(lt, params), lt.Dataset(X, label=y))
    bst.update()
    bst.update()
    bst.reset_parameter(new)
    fresh = lt.Booster(_pkg(lt, dict(params, **new)),
                       lt.Dataset(X, label=y))
    assert bst._grower_spec == fresh._grower_spec
    assert bst._grower_spec.wave_strict_tail == 4
    fresh._train_score = bst._train_score.clone()
    fresh._boost_from_average_done = True
    fresh.cur_iter = bst.cur_iter
    bst.update()
    fresh.update()
    assert bst.trees[-1].to_string(0) == fresh.trees[-1].to_string(0)
    assert bst.trees[-1].num_leaves <= 7
    # the boosting mode is the booster's from its start: resetting it to
    # dart keeps gbdt, as the reference's reset_parameter does
    boosters = []
    for m in (lgb, lt):
        b = m.Booster(_pkg(m, params), m.Dataset(X, label=y))
        b.update()
        b.reset_parameter({"boosting": "dart", "drop_rate": 0.5})
        b.update()
        b.update()
        boosters.append(b)
    _same(*boosters)


@pytest.mark.parametrize("family", ["binary", "regression", "multiclass"])
def test_refit(family):
    X, y = _data(family)
    Xr, yr = _data(family, seed=3, n=700)
    w = np.random.RandomState(4).rand(700) + 0.5
    params = _params(family, "wave")

    def run(m):
        bst = m.train(_pkg(m, params), m.Dataset(X, label=y), 4)
        return bst.refit(Xr, yr, decay_rate=0.7), \
            bst.refit(Xr, yr, decay_rate=0.9, weight=w)

    (aj, wj), (ap, wp) = run(lgb), run(lt)
    assert _text(ap) == _text(aj)
    assert _text(wp) == _text(wj)
    assert _text(ap) != _text(wp)
    loaded = lt.Booster(model_str=_text(ap))
    again = loaded.refit(Xr, yr, decay_rate=0.7, device_type="cpu")
    ref = lgb.Booster(model_str=_text(aj)).refit(Xr, yr, decay_rate=0.7)
    assert _text(again) == _text(ref)
    # query groups reach the objective (item 5d); a non-ranking one
    # ignores them, as the reference's does
    assert _text(ap.refit(Xr, yr, decay_rate=0.7, group=[700])) == \
        _text(aj.refit(Xr, yr, decay_rate=0.7, group=[700]))


def _feval_one(preds, ds):
    return "mean_pred", float(np.mean(preds)), False


def _feval_list(preds, ds):
    err = float(np.mean(np.abs(preds - ds.get_label())))
    return [("abs_err", err, False), ("max_pred", float(np.max(preds)),
                                      True)]


FEVALS = [("binary", _feval_one), ("binary", _feval_list),
          ("binary", [_feval_one, _feval_list]),
          ("multiclass", _feval_one)]


@pytest.mark.parametrize("family,feval", FEVALS,
                         ids=["binary-tuple", "binary-list", "binary-two",
                              "multiclass-tuple"])
def test_feval(family, feval):
    X, y = _data(family)
    Xv, yv = _data(family, seed=1, n=400)
    params = _params(family, "strict", metric_freq=1)

    def run(m):
        rec = {}
        ds = m.Dataset(X, label=y)
        bst = m.train(_pkg(m, params), ds, 3,
                      valid_sets=[ds, m.Dataset(Xv, label=yv)],
                      valid_names=["train", "held"], feval=feval,
                      callbacks=[m.record_evaluation(rec)])
        return bst, rec, bst.eval(bst.train_set, "again", feval)

    (bj, rj, ej), (bp, rp, ep) = run(lgb), run(lt)
    assert rp == rj and ep == ej
    assert any(k in rp["held"] for k in ("mean_pred", "abs_err"))
    before = booster_module.EVAL_COPIES
    bp.eval_valid(feval)
    assert booster_module.EVAL_COPIES == before + 1


def test_early_stopping_with_feval_matches():
    X, y = _data("binary")
    Xv, yv = _data("binary", seed=1, n=400)
    params = _params("binary", "strict", metric="auc",
                     early_stopping_round=2, learning_rate=0.9)

    def run(m):
        bst = m.train(_pkg(m, params), m.Dataset(X, label=y), 30,
                      valid_sets=[m.Dataset(Xv, label=yv)],
                      feval=_feval_one)
        return bst

    bj, bp = run(lgb), run(lt)
    assert bp.best_iteration == bj.best_iteration < 30
    assert bp.best_score == bj.best_score
    # the reference ran 16-round chunks and rolled the overshoot back by
    # replay, so only its model (not its f32 scores) is the serial one's
    _same(bj, bp, scores=False)
