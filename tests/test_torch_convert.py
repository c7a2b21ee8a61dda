"""The port's `convert.py` against the live JAX package's, on the CPU
(mirrors tests/test_convert_model.py).

Both packages load the same model text (regression with a categorical
column and NaNs, multiclass, a random forest).  Held: the generated C
and Python are the reference's byte for byte apart from the header's
package name; the C compiles with gcc and the Python imports, and each
scorer matches the port's `predict(raw_score=True)` within the
reference's 1e-10; `convert_model` writes the file and refuses an
unknown language.
"""
import ctypes
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu.convert as ref_convert  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
import lightgbm_tpu_torch.convert as convert  # noqa: E402

CASES = ("regression_cat_nan", "multiclass", "rf")


def _model(case):
    rng = np.random.RandomState(8)
    n, f = 600, 5
    X = rng.randn(n, f)
    cats = []
    params = {"num_leaves": 8, "verbosity": -1, "min_data_in_leaf": 5}
    if case == "regression_cat_nan":
        X[:, 2] = rng.randint(0, 12, n)
        cats = [2]
        X[rng.rand(n, f) < 0.1] = np.nan
        y = np.nansum(X[:, :2], axis=1) + rng.randn(n) * 0.1
        params["objective"] = "regression"
    elif case == "multiclass":
        y = rng.randint(0, 3, n).astype(float)
        params.update(objective="multiclass", num_class=3)
    else:
        y = (X[:, 0] > 0).astype(float)
        params.update(objective="binary", boosting="rf",
                      bagging_fraction=0.7, bagging_freq=1)
    text = lgb.train(params, lgb.Dataset(X, label=y,
                                         categorical_feature=cats),
                     num_boost_round=12).model_to_string()
    return lgb.Booster(model_str=text), lt.Booster(model_str=text), X


@pytest.fixture(scope="module")
def models():
    return {case: _model(case) for case in CASES}


def _ours_as_reference(text):
    return text.replace("generated by lightgbm_tpu_torch task=",
                        "generated by lightgbm_tpu task=", 1)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("lang", ["c", "python"])
def test_text_is_the_references(models, case, lang):
    ref, ours, _ = models[case]
    fn = "to_if_else_c" if lang == "c" else "to_if_else_python"
    got = getattr(convert, fn)(ours)
    assert "generated by lightgbm_tpu_torch task=convert_model" in got
    assert _ours_as_reference(got) == getattr(ref_convert, fn)(ref)


@pytest.mark.parametrize("case", CASES)
def test_c_scorer_matches_predict(models, case, tmp_path):
    if shutil.which("gcc") is None:
        pytest.skip("gcc not installed")
    _, ours, X = models[case]
    c_path = tmp_path / "scorer.c"
    convert.convert_model(ours, str(c_path))
    so = tmp_path / "scorer.so"
    r = subprocess.run(["gcc", "-O1", "-shared", "-fPIC", str(c_path),
                        "-o", str(so), "-lm"], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    dptr = ctypes.POINTER(ctypes.c_double)
    K = ours.num_tree_per_iteration
    expect = ours.predict(X, raw_score=True)
    rows = [np.ascontiguousarray(row, dtype=np.float64) for row in X]
    if K == 1:
        lib.score_raw.restype = ctypes.c_double
        lib.score_raw.argtypes = [dptr]
        got = np.array([lib.score_raw(r.ctypes.data_as(dptr)) for r in rows])
    else:
        lib.score_raw_multi.restype = None
        lib.score_raw_multi.argtypes = [dptr, dptr]
        got = np.empty((len(X), K))
        for i, r in enumerate(rows):
            buf = (ctypes.c_double * K)()
            lib.score_raw_multi(r.ctypes.data_as(dptr), buf)
            got[i] = list(buf)
    np.testing.assert_allclose(got, expect, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("case", CASES)
def test_python_scorer_matches_predict(models, case, tmp_path):
    _, ours, X = models[case]
    py_path = tmp_path / f"scorer_{case}.py"
    convert.convert_model(ours, str(py_path), language="python")
    spec = importlib.util.spec_from_file_location(f"scorer_{case}",
                                                  py_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    expect = ours.predict(X, raw_score=True)
    if ours.num_tree_per_iteration == 1:
        got = np.array([mod.score_raw(list(map(float, row))) for row in X])
    else:
        got = np.array([mod.score_raw_multi(list(map(float, row)))
                        for row in X])
    np.testing.assert_allclose(got, expect, rtol=1e-10, atol=1e-10)


def test_convert_model_refuses_unknown_language(models, tmp_path):
    _, ours, _ = models["multiclass"]
    with pytest.raises(lt.LightGBMError, match="not supported"):
        convert.convert_model(ours, str(tmp_path / "x.rs"), language="rust")
    assert not os.path.exists(tmp_path / "x.rs")
