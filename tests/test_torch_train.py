"""`lightgbm_tpu_torch.train` against the live JAX package, on the CPU.

The port trains with `device_type="cpu"` (the plain versions of its
kernels); the JAX package trains on its CPU backend (`hist_impl`
resolves to `segment_sum`).  Against the live package, not the frozen
golden JSON (ROADMAP Queue 3 (a)):
  * tree count, split_feature, threshold_bin, default_left and
    decision_type are exact;
  * leaf values agree within GOLDEN_LEAF_RTOL / GOLDEN_LEAF_ATOL
    (tests/test_golden.py), and bitwise on the golden families: the
    port's histograms, root sums and scan sums add in the reference's
    own CPU order, and its sigmoid and softmax are XLA's CPU bits
    (`ops/xla_math.py`), so binary and multiclass model texts are the
    reference's byte for byte;
  * the port's model text loads into JAX `Booster(model_str=...)` and
    into the port's CPU `ServingRuntime`, which agree within rtol 1e-4;
  * the eval log on a `create_valid` set agrees within 1e-4;
  * the samplers (bagging at two frequencies, per-class bagging,
    feature_fraction, feature_fraction_bynode, extra_trees, GOSS by both
    spellings on binary and multiclass, quantized with bagging and with
    GOSS), under both growers: model text byte-identical to the
    reference's, and different from the unsampled model's.
Then the slice's scope: every refused setting raises `LightGBMError`,
and training without `device_type="cpu"` raises on a machine with no
GPU.
"""
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from golden_common import GOLDEN_CASES, make_case_data  # noqa: E402

GOLDEN_LEAF_RTOL = 1e-4
GOLDEN_LEAF_ATOL = 1e-9
CASES = ("binary", "regression_l2", "multiclass", "goss_bagging",
         "categorical")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Gradients and links go through sigmoid and softmax: one intra-op
    thread keeps this CPU torch build's first-call `exp` fault out of
    the comparison (ROADMAP Queue 3 (f), as in test_torch_serving.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _train_both(params, X, y, rounds, **kw):
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y, **kw),
                   num_boost_round=rounds)
    bp = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, **kw), num_boost_round=rounds)
    return bj, bp


def _assert_same_trees(bj, bp, bitwise=False):
    assert len(bp.trees) == len(bj.trees)
    for i, (a, b) in enumerate(zip(bj.trees, bp.trees)):
        ni = a.num_internal()
        assert b.num_leaves == a.num_leaves, f"tree {i}"
        for name in ("split_feature", "threshold_bin", "decision_type",
                     "left_child", "right_child"):
            assert np.array_equal(getattr(b, name)[:ni],
                                  getattr(a, name)[:ni]), (i, name)
        if bitwise:
            assert np.array_equal(b.leaf_value, a.leaf_value), f"tree {i}"
            assert np.array_equal(b.threshold[:ni], a.threshold[:ni])
        np.testing.assert_allclose(b.leaf_value, a.leaf_value,
                                   rtol=GOLDEN_LEAF_RTOL,
                                   atol=GOLDEN_LEAF_ATOL,
                                   err_msg=f"tree {i}")


@pytest.fixture(scope="module")
def golden_models():
    out = {}
    for name in CASES:
        case = GOLDEN_CASES[name]
        X, y = make_case_data(case)
        kw = {"categorical_feature": case["categorical"]} \
            if case.get("categorical") else {}
        out[name] = (X,) + _train_both(case["params"], X, y,
                                       case["rounds"], **kw)
    return out


@pytest.mark.parametrize("name", CASES)
def test_golden_family_matches_live_reference(golden_models, name):
    X, bj, bp = golden_models[name]
    _assert_same_trees(bj, bp, bitwise=True)
    assert bp.num_trees() == GOLDEN_CASES[name]["rounds"] * \
        GOLDEN_CASES[name].get("n_class", 1)


@pytest.mark.parametrize("name", CASES)
def test_model_text_serves_in_both_packages(golden_models, name):
    X, bj, bp = golden_models[name]
    text = bp.model_to_string()
    assert text.startswith("tree\nversion=v4\n")
    jax_pred = lgb.Booster(model_str=text).predict(X[:300])
    rt = lt.ServingRuntime(lt.Booster(model_str=text), device="cpu")
    port_pred = rt.predict(X[:300])
    np.testing.assert_allclose(port_pred, jax_pred, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(bp.predict(X[:300]), bj.predict(X[:300]),
                               rtol=1e-4, atol=1e-7)
    # the trained booster serves as it is, and round-trips its own text
    again = lt.Booster(model_str=text).model_to_string()
    assert again == text


def test_eval_log_on_a_valid_set_matches():
    case = GOLDEN_CASES["binary"]
    X, y = make_case_data(case)
    rng = np.random.RandomState(9)
    Xv = rng.randn(600, X.shape[1])
    yv = (Xv[:, 1] - 0.5 * Xv[:, 2] > 0).astype(np.float64)
    params = dict(case["params"], metric=["binary_logloss", "auc"])
    logs = []
    for pkg, extra in ((lgb, {}), (lt, {"device_type": "cpu"})):
        ds = pkg.Dataset(X, label=y)
        rec = {}
        pkg.train(dict(params, **extra), ds, num_boost_round=6,
                  valid_sets=[ds, ds.create_valid(Xv, label=yv)],
                  valid_names=["train", "valid"],
                  callbacks=[pkg.record_evaluation(rec)])
        logs.append(rec)
    jax_log, port_log = logs
    assert set(port_log) == {"train", "valid"} == set(jax_log)
    for ds_name in ("train", "valid"):
        for metric in ("binary_logloss", "auc"):
            np.testing.assert_allclose(port_log[ds_name][metric],
                                       jax_log[ds_name][metric], rtol=1e-4,
                                       atol=1e-4, err_msg=metric)


def _special_regression():
    rng = np.random.RandomState(12)
    n = 2500
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.15, 0] = np.nan
    X[rng.rand(n) < 0.5, 1] = 0.0
    X[:, 2] = 1.5
    X[:, 3] = np.round(X[:, 3] * 3)
    y = (np.nan_to_num(X[:, 0], nan=2.0) + X[:, 1] * X[:, 3]
         + 0.2 * rng.randn(n))
    w = rng.uniform(0.2, 2.0, n)
    return X, y, w


OPTIONS = {"objective": "regression", "num_leaves": 20, "max_depth": 5,
           "lambda_l1": 0.3, "lambda_l2": 2.0, "min_data_in_leaf": 8,
           "min_sum_hessian_in_leaf": 0.5, "max_delta_step": 0.8,
           "min_gain_to_split": 0.01, "learning_rate": 0.2, "max_bin": 63,
           "verbosity": -1}


@pytest.mark.parametrize("path_smooth", [0.0, 1.5])
def test_options_weights_and_missing_values_match(path_smooth):
    """Bitwise without path smoothing; with it, leaf outputs may differ
    from XLA's CPU by an ulp (ROADMAP Queue 3 (g)), within tolerance."""
    X, y, w = _special_regression()
    bj, bp = _train_both(dict(OPTIONS, path_smooth=path_smooth), X, y, 6,
                         weight=w)
    _assert_same_trees(bj, bp, bitwise=path_smooth == 0.0)
    nan_default = [t.decision_type[:t.num_internal()] for t in bp.trees]
    assert any((d >> 2 == 2).any() for d in nan_default)   # NaN missing


def test_sampled_binning_under_a_seed_matches():
    """Training params reach the Dataset exactly as in the reference:
    `bin_construct_sample_cnt` does, `seed` does not (the Dataset keeps
    its own data_random_seed)."""
    case = GOLDEN_CASES["binary"]
    X, y = make_case_data(case)
    params = dict(case["params"], seed=7, bin_construct_sample_cnt=500)
    bj, bp = _train_both(params, X, y, 3)
    _assert_same_trees(bj, bp)
    assert np.array_equal(bp.trees[0].threshold, bj.trees[0].threshold)


def test_early_stopping_matches():
    case = GOLDEN_CASES["regression_l2"]
    X, y = make_case_data(case)
    rng = np.random.RandomState(4)
    Xv = rng.randn(400, X.shape[1]) * 3
    yv = rng.randn(400)
    out = []
    for pkg, extra in ((lgb, {}), (lt, {"device_type": "cpu"})):
        ds = pkg.Dataset(X, label=y)
        bst = pkg.train(dict(case["params"], early_stopping_round=2,
                             **extra),
                        ds, num_boost_round=20,
                        valid_sets=[ds.create_valid(Xv, label=yv)])
        out.append((bst.best_iteration, bst.num_trees(),
                    bst.best_score["valid_0"]["l2"]))
    (ij, nj, sj), (ip, np_, sp) = out
    assert ip == ij and np_ == nj
    np.testing.assert_allclose(sp, sj, rtol=1e-6)


def test_segment_sum_and_auto_train_alike_on_the_cpu():
    case = GOLDEN_CASES["binary"]
    X, y = make_case_data(case)
    texts = []
    for impl in ("auto", "segment_sum"):
        bst = lt.train(dict(case["params"], device_type="cpu",
                            hist_impl=impl), lt.Dataset(X, label=y), 3)
        texts.append([t.to_string(i) for i, t in enumerate(bst.trees)])
    assert texts[0] == texts[1]


REFUSED = [
    ({"monotone_constraints": [1, 0, 0, 0, 0, 0]}, None),
    ({"interaction_constraints": "[0,1],[2,3]"}, None),
    ({"cegb_penalty_split": 0.1}, None),
    ({"objective": "quantile"}, None),
    ({"histogram_pool_size": 16}, None),
    ({"linear_tree": True}, None),
    ({"boosting": "dart"}, None),
    ({"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1},
     None),
    ({"use_quantized_grad": True}, None),
    ({"tree_grow_policy": "bogus"}, "Unknown tree_grow_policy"),
    ({"streaming_train": "on"}, None),
    ({"external_memory": True}, None),
    ({"datastore_budget_mb": 0.001, "external_memory": True}, None),
    ({"tree_learner": "data"}, None),
    ({"num_machines": 2}, None),
    ({"hist_impl": "packed"}, None),
    ({"hist_impl": "pallas_q"}, "CUDA device"),
    ({"hist_impl": "pallas_fused"}, "CUDA device"),
    ({"hist_impl": "pallas_fused_q"}, "CUDA device"),
    ({"hist_impl": "pallas"}, "CUDA device"),
    ({"hist_impl": "bogus"}, "Unknown hist_impl"),
    ({"objective": "huber"}, None),
    ({"objective": "binary", "metric": "ndcg"}, None),
    ({"objective": "bogus"}, "Unknown objective"),
    ({"device_type": "tpu"}, "'cuda'"),
    ({"flight_recorder": True}, r"flight_recorder=True \(.*item 5g"),
    ({"flight_recorder_depth": 16}, r"flight_recorder_depth=16 \(.*item 5g"),
    ({"telemetry_sink": "events.jsonl"}, r"telemetry_sink=.*item 5g"),
    ({"telemetry_prometheus": "metrics.prom"},
     r"telemetry_prometheus=.*item 5g"),
    ({"telemetry_spool": True}, r"telemetry_spool=True \(.*item 5g"),
    ({"telemetry_spool_dir": "spool"}, r"telemetry_spool_dir=.*item 5g"),
    ({"debug_contracts": True}, r"debug_contracts=True \(.*item 5g"),
    ({"debug_locks": True}, r"debug_locks=True \(.*item 5g"),
]


@pytest.mark.parametrize("extra,match", REFUSED,
                         ids=[f"{next(iter(e))}={next(iter(e.values()))}"
                              for e, _ in REFUSED])
def test_refused_settings_raise(extra, match):
    """Each setting raises naming its ROADMAP item or the reason; a
    `None` match is a setting an earlier slice refused that the port now
    trains (quantized training; the constraints and boosting modes of
    item 5d's first half, whose forced-splits case needs a file and
    trains in test_torch_forced_pool.py; the objectives and metrics of
    its second half; external memory, whose spilled bins assemble on the
    device, since item 5e's first half; streamed training, which
    `streaming_train=on` asks for and `auto` takes for spilled bins over
    `datastore_budget_mb`, since its second half; the distributed
    learners of item 5f, which one process trains with the serial
    learner)."""
    X = np.random.RandomState(0).randn(200, 6)
    y = (X[:, 0] > 0).astype(float)
    params = dict({"objective": "binary", "verbosity": -1,
                   "device_type": "cpu"}, **extra)
    if match is None:
        bst = lt.train(params, lt.Dataset(X, label=y), num_boost_round=1)
        assert bst.num_trees() == 1
        return
    with pytest.raises(lt.LightGBMError, match=match):
        lt.train(params, lt.Dataset(X, label=y), num_boost_round=1)


def test_network_settings_warn_and_train(caplog):
    """The socket-era `machines`, `local_listen_port` and `time_out` warn
    as the reference's do (`lightgbm_tpu/booster.py:289-298`), naming
    the port's own multi-process setup, and change nothing: the trees
    are those trained without them, and the text the reference's."""
    X = np.random.RandomState(0).randn(200, 6)
    y = (X[:, 0] > 0).astype(float)
    base = {"objective": "binary", "verbosity": 0, "device_type": "cpu"}
    net = {"machines": "10.0.0.1:12400,10.0.0.2:12400",
           "local_listen_port": 12401, "time_out": 60}
    plain = lt.train(dict(base), lt.Dataset(X, label=y), 2)
    caplog.clear()
    caplog.set_level(logging.WARNING)
    bst = lt.train(dict(base, **net), lt.Dataset(X, label=y), 2)
    warned = [r.getMessage() for r in caplog.records
              if "TCP transport" in r.getMessage()]
    assert len(warned) == 3
    for name, msg in zip(net, warned):
        assert msg.startswith(f"Parameter {name} ")
        assert "torch.distributed" in msg and "tree_learner" in msg
    def trees(text):        # less the `[key: value]` parameter lines
        return [ln for ln in text.splitlines() if not ln.startswith("[")]
    assert trees(bst.model_to_string()) == trees(plain.model_to_string())
    ref = lgb.train(dict(base, **net), lgb.Dataset(X, label=y), 2)
    assert bst.model_to_string() == ref.model_to_string()


def _logloss(preds, ds):
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - ds.get_label(), p * (1.0 - p)


def test_refused_data_and_entry_points_raise():
    """Custom objectives train (`fobj` through `train` and `update`), as
    the reference's do, byte for byte; `update(fobj=)` on a booster whose
    grower reads the quantized lattice still raises, as in the
    reference."""
    X = np.random.RandomState(0).randn(300, 5)
    y = (X[:, 0] > 0).astype(float)
    cpu = {"objective": "binary", "verbosity": -1, "device_type": "cpu"}
    texts = []
    for m in (lgb, lt):
        bst = m.train(dict(cpu, objective=_logloss), m.Dataset(X, label=y),
                      2)
        bst.update(fobj=_logloss)
        texts.append(bst.model_to_string())
    assert texts[0] == texts[1]
    assert "objective=custom" in texts[1]
    bst = lt.train(cpu, lt.Dataset(X, label=y), 1)
    bst.update(fobj=_logloss)
    assert bst.num_trees() == 2
    quant = lt.train(dict(cpu, use_quantized_grad=True),
                     lt.Dataset(X, label=y), 1)
    with pytest.raises(lt.LightGBMError, match="fobj"):
        quant.update(fobj=_logloss)


def test_training_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.RandomState(0).randn(100, 3)
    y = (X[:, 0] > 0).astype(float)
    with pytest.raises(lt.LightGBMError, match="no CUDA device"):
        lt.train({"objective": "binary", "verbosity": -1},
                 lt.Dataset(X, label=y), 1)
    with pytest.raises(lt.LightGBMError, match="no CUDA device"):
        lt.train({"objective": "binary", "device": "cuda"},
                 lt.Dataset(X, label=y), 1)


def _link_data(seed, n_class=2):
    """3000 x 6 features with a nonlinear, noisy target: binary labels, or
    `n_class` classes."""
    rng = np.random.RandomState(seed)
    X = rng.randn(3000, 6)
    z = X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2]) - 0.5 * X[:, 3] \
        + 0.7 * rng.randn(3000)
    if n_class == 2:
        return X, (z > 0).astype(np.float64)
    edges = np.quantile(z, np.linspace(0, 1, n_class + 1)[1:-1])
    return X, np.searchsorted(edges, z).astype(np.float64)


#: both packages get `device_type="cpu"`, so that both texts echo it
LINK_BASE = {"num_leaves": 15, "learning_rate": 0.1, "verbosity": -1,
             "device_type": "cpu"}


@pytest.mark.parametrize("policy", ["leafwise", "wave"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_binary_model_text_byte_identical(seed, policy):
    """The gradients' sigmoid is XLA's bits (`ops/xla_math.py`), so the
    port's model text is the reference's, byte for byte (ROADMAP Queue 3
    F1: with torch's sigmoid, root values differed from tree 2 on)."""
    X, y = _link_data(seed)
    bj, bp = _train_both(dict(LINK_BASE, objective="binary",
                              tree_grow_policy=policy), X, y, 10)
    assert bp.model_to_string() == bj.model_to_string()


@pytest.mark.parametrize("policy", ["leafwise", "wave"])
def test_multiclass_model_text_byte_identical(policy):
    """The gradients' softmax is XLA's bits, so 3 classes x 6 rounds of
    trees are the reference's byte for byte (with torch's softmax they
    diverged in structure from the second iteration)."""
    X, y = _link_data(4, n_class=3)
    bj, bp = _train_both(dict(LINK_BASE, objective="multiclass",
                              num_class=3, tree_grow_policy=policy), X, y, 6)
    assert bp.model_to_string() == bj.model_to_string()


#: the samplers, each on LINK_BASE's binary problem (multiclass where
#: named) for 6 rounds.  GOSS waits int(1 / learning_rate) iterations
#: (the golden `goss_bagging` family, at 0.1, never samples in its 10
#: rounds), so its cases run at learning rate 0.5: rounds 2-5 sample.
SAMPLED = {
    "bagging_freq1": {"bagging_fraction": 0.7, "bagging_freq": 1},
    "bagging_freq3": {"bagging_fraction": 0.6, "bagging_freq": 3},
    "pos_neg_bagging": {"pos_bagging_fraction": 0.6,
                        "neg_bagging_fraction": 0.8, "bagging_freq": 2},
    "feature_fraction": {"feature_fraction": 0.8},
    "bynode": {"feature_fraction_bynode": 0.5},
    "extra_trees": {"extra_trees": True},
    "goss": {"boosting": "goss", "learning_rate": 0.5},
    "goss_multiclass": {"data_sample_strategy": "goss",
                        "learning_rate": 0.5, "objective": "multiclass",
                        "num_class": 3},
    "quantized_bagging": {"use_quantized_grad": True,
                          "bagging_fraction": 0.7, "bagging_freq": 1},
    "quantized_goss": {"use_quantized_grad": True, "boosting": "goss",
                       "learning_rate": 0.5},
}


@pytest.mark.parametrize("policy", ["leafwise", "wave"])
@pytest.mark.parametrize("name", list(SAMPLED))
def test_sampled_training_matches_the_reference(name, policy):
    """The port draws the reference's rows and features: trees exact,
    leaf values and model text bitwise; without the sampler the model
    differs."""
    extra = SAMPLED[name]
    n_class = extra.get("num_class", 2)
    X, y = _link_data(5, n_class=n_class)
    params = dict(dict(LINK_BASE, objective="binary"),
                  tree_grow_policy=policy, **extra)
    bj, bp = _train_both(params, X, y, 6)
    _assert_same_trees(bj, bp, bitwise=True)
    assert bp.model_to_string() == bj.model_to_string()
    plain = {k: v for k, v in params.items()
             if k not in extra or k in ("objective", "num_class")}
    unsampled = lt.train(plain, lt.Dataset(X, label=y), num_boost_round=6)
    assert [t.to_string(i) for i, t in enumerate(unsampled.trees)] != \
        [t.to_string(i) for i, t in enumerate(bp.trees)]
