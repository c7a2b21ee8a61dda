"""The port's model loading against the JAX package's, on the CPU.

The same model text, or the same trained trees carried across as numpy
arrays, must give the same export planes bit for bit, the same model
text back, and the same host predictions.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import chip_smoke  # noqa: E402
import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from golden_common import GOLDEN_CASES, make_case_data  # noqa: E402
from lightgbm_tpu_torch.interop import booster_from_numpy  # noqa: E402

GOLDEN = sorted(GOLDEN_CASES)
PLANES = ("feat", "thr", "dtype", "left", "right", "cat_words",
          "cat_nwords", "cls")


def _golden_text(name):
    return (ROOT / "tests" / "data" / f"golden_{name}.model.txt").read_text()


def _assert_same_planes(bj, bp):
    ej = bj.export_predict_arrays()
    ep = bp.export_predict_arrays()
    sj, sp = ej["stacked"], ep["stacked"]
    assert sorted(sj) == sorted(sp)
    assert sp["min_features"] == sj["min_features"]
    for k in PLANES:
        if k not in sj:
            continue
        a = np.asarray(sj[k])
        b = sp[k].numpy()
        assert a.shape == b.shape, k
        assert a.itemsize == b.itemsize == 4, k
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), k
    assert ep["num_class"] == ej["num_class"]
    assert ep["average_factor"] == ej["average_factor"]
    bits = ep["leaf_values"].view(np.uint64)
    assert np.array_equal(bits, ej["leaf_values"].view(np.uint64))
    assert np.array_equal((bits >> 32).astype(np.uint32),
                          np.asarray(ej["value_hi"]))
    assert np.array_equal(bits.astype(np.uint32), np.asarray(ej["value_lo"]))
    assert np.array_equal(ep["value_f64"].numpy().view(np.uint64), bits)


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_model_planes_text_and_host_predict(name):
    text = _golden_text(name)
    bj = lgb.Booster(model_str=text)
    bp = lt.Booster(model_str=text)
    _assert_same_planes(bj, bp)
    # model text round-trips, and byte-equal to what the JAX package
    # writes for the same loaded model
    out = bp.model_to_string()
    assert out == bj.model_to_string()
    again = lt.Booster(model_str=out)
    assert again.model_to_string() == out
    _assert_same_planes(bj, again)
    X, _ = make_case_data(GOLDEN_CASES[name])
    want = bj.predict(X[:300], raw_score=True)
    got = bp.predict(X[:300], raw_score=True)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_booster_from_numpy_carries_a_jax_trained_model():
    # a live JAX-trained booster (categorical feature, three classes)
    # handed over as per-tree numpy arrays
    rng = np.random.RandomState(7)
    X = rng.randn(400, 4)
    X[:, 0] = rng.randint(0, 40, 400)
    y = np.clip(np.digitize(X[:, 1] + (X[:, 0] % 3 == 0), [-0.5, 0.5]),
                0, 2).astype(np.float64)
    ds = lgb.Dataset(X, label=y, categorical_feature=[0])
    bj = lgb.train({"objective": "multiclass", "num_class": 3,
                    "num_leaves": 7, "min_data_in_leaf": 5,
                    "verbosity": -1}, ds, num_boost_round=3)
    assert any(t.num_cat > 0 for t in bj.trees)
    fields = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "leaf_value", "num_leaves", "num_cat",
              "cat_boundaries", "cat_threshold", "threshold_bin")
    trees = [{f: getattr(t, f) for f in fields} for t in bj.trees]
    bp = booster_from_numpy(trees, bj.num_tree_per_iteration,
                            bj._objective_to_string())
    _assert_same_planes(bj, bp)
    assert bp.num_feature() == bj.export_predict_arrays()["stacked"][
        "min_features"]
    assert np.array_equal(bp.predict(X, raw_score=True),
                          bj.predict(X, raw_score=True))


def test_synthetic_forest_loads_alike_in_both_packages():
    # chip_smoke.py's generator at 20 trees x 63 leaves x 6 features
    text = chip_smoke.synthetic_forest_text(3, num_trees=20, num_leaves=63,
                                            num_features=6)
    bj = lgb.Booster(model_str=text)
    bp = lt.Booster(model_str=text)
    assert bp.num_trees() == 20 and bp.num_feature() == 6
    assert all(t.num_leaves == 63 for t in bp.trees)
    dtypes = np.concatenate([t.decision_type for t in bp.trees])
    assert set(((dtypes >> 2) & 3).tolist()) == {0, 1, 2}
    assert set(((dtypes >> 1) & 1).tolist()) == {0, 1}
    _assert_same_planes(bj, bp)
    X = chip_smoke.request_rows(np.random.RandomState(4), 200, 6)
    assert np.array_equal(bp.predict(X, raw_score=True),
                          bj.predict(X, raw_score=True))


def test_training_entry_points_raise():
    bp = lt.Booster(model_str=_golden_text("binary"))
    with pytest.raises(lt.LightGBMError, match="training"):
        bp.update()
    with pytest.raises(lt.LightGBMError, match="training"):
        lt.Booster(train_set=object())
