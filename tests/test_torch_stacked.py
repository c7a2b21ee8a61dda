"""The stacked-plane traversal (`ops/predict.py predict_leaf_ensemble`,
kernel `csrc/stacked.cu`) against the JAX package's
`lightgbm_tpu.ops.predict.predict_leaf_ensemble` (its XLA scan of
`_leaf_slots`), and `device_predict` on a model the compiled plan refuses
(ROADMAP Queue 3 (q)).

On the CPU the wrapper runs the plain version; its [T, N] int32 slots
must equal the reference's bitwise on the golden families, on rows that
stress routing (NaN, +-inf, +-0, subnormals, the zero threshold, values
at the thresholds, categorical edge values), under every missing type
and default direction, on categorical bitsets of 1, several and 313
words, and on padded batches.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import jax  # noqa: E402
import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
import lightgbm_tpu_torch.booster as lt_booster  # noqa: E402
from chip_smoke import adversarial_rows, wide_bitset_text  # noqa: E402
from golden_common import GOLDEN_CASES, make_case_data  # noqa: E402
from lightgbm_tpu.ops.predict import \
    predict_leaf_ensemble as jax_leaf_ensemble  # noqa: E402
from lightgbm_tpu_torch.ops.predict import (  # noqa: E402
    _check_stacked, predict_leaf_ensemble, predict_leaf_ensemble_plain)

_JAX_LEAF = jax.jit(jax_leaf_ensemble)


def _text(name):
    return (ROOT / "tests" / "data" / f"golden_{name}.model.txt").read_text()


def _rows(trees, nf, X=None, seed=0):
    """Adversarial rows of `trees` plus, when given, plain data rows."""
    parts = [adversarial_rows(trees, nf, seed)]
    if X is not None:
        parts.append(X[:300])
    return np.ascontiguousarray(np.vstack(parts))


def _slots_both(text, X):
    """(port slots, reference slots) of every tree for the f64 rows X,
    both from the f32 cast of X."""
    bj = lgb.Booster(model_str=text)
    bp = lt.Booster(model_str=text)
    ex_j = bj.export_predict_arrays()
    arrays = {k: v for k, v in ex_j["stacked"].items()
              if k not in ("min_features", "value")}
    with np.errstate(over="ignore"):
        X32 = X.astype(np.float32)
    want = np.asarray(_JAX_LEAF(arrays, X32))
    ex_p = bp.export_predict_arrays()
    got = predict_leaf_ensemble(ex_p["stacked"], torch.from_numpy(X32))
    return got.numpy(), want, ex_p


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_slots_bitwise_reference_on_golden_families(name):
    text = _text(name)
    X, _ = make_case_data(GOLDEN_CASES[name])
    trees = lt.Booster(model_str=text).trees
    rows = _rows(trees, X.shape[1], X)
    got, want, ex = _slots_both(text, rows)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert got.shape == (len(trees), rows.shape[0])
    # the plain version is what the wrapper ran on the CPU
    with np.errstate(over="ignore"):
        X32 = torch.from_numpy(rows.astype(np.float32))
    assert torch.equal(predict_leaf_ensemble_plain(ex["stacked"], X32),
                       torch.from_numpy(got))


def _with_missing(text, missing_type, default_left):
    """`text` with every numerical node's decision type set to
    `missing_type` (0 None, 1 Zero, 2 NaN) and `default_left`."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("decision_type="):
            vals = [int(v) for v in ln.split("=", 1)[1].split()]
            new = [v if v & 1 else
                   (missing_type << 2) | (2 if default_left else 0)
                   for v in vals]
            ln = "decision_type=" + " ".join(map(str, new))
        out.append(ln)
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("missing_type", [0, 1, 2])
@pytest.mark.parametrize("default_left", [False, True])
def test_missing_types_and_default_direction(missing_type, default_left):
    text = _with_missing(_text("regression_l2"), missing_type, default_left)
    trees = lt.Booster(model_str=text).trees
    rows = _rows(trees, 6, seed=missing_type)
    rows[::3, :] = np.where(np.arange(6) % 2 == 0, np.nan, 0.0)
    rows[1::7, :] = -0.0
    got, want, _ = _slots_both(text, rows)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("words", [(1, 1), (3, 7), (313, 2)])
def test_categorical_bitsets_of_many_words(words):
    text = wide_bitset_text(_text("categorical"), words)
    trees = lt.Booster(model_str=text).trees
    span = 32 * max(words)
    rng = np.random.RandomState(sum(words))
    rows = _rows(trees, 5, seed=1)
    cats = rng.randint(-3, span + 40, size=(600, 1)).astype(np.float64)
    extra = rng.randn(600, 5)
    extra[:, :1] = cats
    extra[::11, 0] = np.nan
    extra[5::13, 0] = cats[5::13, 0] + 0.5
    got, want, ex = _slots_both(text, np.vstack([rows, extra]))
    assert ex["stacked"]["cat_words"].shape[-1] == max(words)
    assert np.array_equal(got, want)


def test_padded_rows_exact():
    text = _text("multiclass")
    X, _ = make_case_data(GOLDEN_CASES["multiclass"])
    ex = lt.Booster(model_str=text).export_predict_arrays()
    X32 = torch.from_numpy(X[:37].astype(np.float32))
    whole = predict_leaf_ensemble(ex["stacked"], X32)
    padded = torch.zeros((64, X32.shape[1]), dtype=torch.float32)
    padded[:37] = X32
    assert torch.equal(predict_leaf_ensemble(ex["stacked"], padded)[:, :37],
                       whole)
    for n in (1, 5, 36):
        assert torch.equal(predict_leaf_ensemble(ex["stacked"], X32[:n]),
                           whole[:, :n])


def test_wrapper_refuses_bad_inputs():
    ex = lt.Booster(model_str=_text("binary")).export_predict_arrays()
    X = torch.zeros((4, 6), dtype=torch.float32)
    with pytest.raises(lt.LightGBMError, match="no traversal kernel"):
        predict_leaf_ensemble(ex["stacked"], X.to("meta"))
    with pytest.raises(lt.LightGBMError, match="float32"):
        _check_stacked(ex["stacked"], X.double())
    bad = dict(ex["stacked"], thr=ex["stacked"]["thr"].double())
    with pytest.raises(lt.LightGBMError, match="thr"):
        _check_stacked(bad, X)


def _q_model():
    """A two-round regression text whose first tree splits on feature
    4096, past the compiled plan's 12-bit feature field (the model of
    ROADMAP Queue 3 (q)), and rows for its 4,097 columns."""
    rng = np.random.RandomState(7)
    X = rng.randn(400, 6)
    y = X[:, 0] * 2.0 + np.sin(X[:, 1]) + 0.1 * rng.randn(400)
    params = {"objective": "regression", "num_leaves": 7,
              "verbosity": -1}
    text = lgb.train(params, lgb.Dataset(X, label=y),
                     num_boost_round=2).model_to_string()
    lines = text.splitlines()
    i = next(k for k, ln in enumerate(lines)
             if ln.startswith("split_feature="))
    feats = lines[i].split("=", 1)[1].split()
    feats[0] = "4096"
    lines[i] = "split_feature=" + " ".join(feats)
    text = "\n".join(lines) + "\n"
    Xq = np.zeros((300, 4097))
    Xq[:, :6] = rng.randn(300, 6)
    Xq[:, 4096] = rng.randn(300) * 2.0
    Xq[::17, 4096] = np.nan
    return text, Xq


def test_device_predict_past_the_plan_limits_matches_reference():
    """ROADMAP Queue 3 (q), closed: `device_predict` on a model with a
    split on feature 4096 takes the stacked route (counted) and is
    bitwise the reference's `predict(device_predict=True)`, raw and
    converted; the route is chosen before anything is launched."""
    text, Xq = _q_model()
    ref = lgb.Booster(model_str=text)
    ours = lt.Booster(model_str=text)
    before = lt_booster.DEVICE_PREDICT_STACKED
    for raw in (True, False):
        got = ours.predict(Xq, raw_score=raw, device_predict=True,
                           device_type="cpu")
        want = ref.predict(Xq, raw_score=raw, device_predict=True)
        assert got.dtype == want.dtype and got.shape == want.shape
        view = np.uint64 if got.dtype == np.float64 else np.uint32
        assert np.array_equal(got.view(view), want.view(view))
    assert lt_booster.DEVICE_PREDICT_STACKED == before + 2
    st = ours._device_predict_state(0, None, torch.device("cpu"))
    assert st.records is None and st.stacked is not None
