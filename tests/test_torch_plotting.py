"""The port's plotting functions against the live JAX package's, on the
CPU (mirrors tests/test_plotting.py; matplotlib's Agg backend).

Both packages load the same model text.  Held: `create_tree_digraph`'s
source identical to the reference's (default and with `show_info`),
`plot_importance`'s bar widths and labels, `plot_metric`'s curves and
`plot_split_value_histogram`'s bars equal to the reference's; the
estimator is taken in place of a booster; `plot_tree` draws the digraph
(graphviz's `dot` rendering replaced by a fixed PNG, since the
executable may be missing).
"""
import io
import sys
from pathlib import Path

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402


@pytest.fixture(scope="module")
def trained():
    rng = np.random.RandomState(6)
    X = rng.randn(500, 5)
    y = (X[:, 0] - 0.5 * X[:, 1] > 0).astype(float)
    ds = lgb.Dataset(X, label=y,
                     feature_name=[f"feat_{i}" for i in range(5)])
    evals = {}
    ref = lgb.train({"objective": "binary", "num_leaves": 7,
                     "verbosity": -1}, ds, num_boost_round=10,
                    valid_sets=[ds], valid_names=["train"],
                    callbacks=[lgb.record_evaluation(evals)])
    text = ref.model_to_string()
    return lgb.Booster(model_str=text), lt.Booster(model_str=text), evals


def _bars(ax):
    return [(p.get_x(), p.get_y(), p.get_width(), p.get_height())
            for p in ax.patches]


@pytest.mark.parametrize("show_info", [None, ["split_gain",
                                              "internal_value",
                                              "leaf_count"]])
@pytest.mark.parametrize("tree_index", [0, 9])
def test_create_tree_digraph_source_identical(trained, show_info,
                                              tree_index):
    pytest.importorskip("graphviz")
    ref, ours, _ = trained
    kw = dict(tree_index=tree_index, show_info=show_info)
    assert lt.create_tree_digraph(ours, **kw).source == \
        lgb.create_tree_digraph(ref, **kw).source
    with pytest.raises(IndexError):
        lt.create_tree_digraph(ours, tree_index=10)


@pytest.mark.parametrize("importance_type", ["split", "gain"])
def test_plot_importance_bars_equal(trained, importance_type):
    ref, ours, _ = trained
    a = lt.plot_importance(ours, importance_type=importance_type)
    b = lgb.plot_importance(ref, importance_type=importance_type)
    assert _bars(a) == _bars(b) and len(_bars(a)) > 0
    assert [t.get_text() for t in a.get_yticklabels()] == \
        [t.get_text() for t in b.get_yticklabels()]
    assert any(t.get_text().startswith("feat_")
               for t in a.get_yticklabels())
    plt.close("all")


def test_plot_metric_and_split_value_histogram(trained):
    ref, ours, evals = trained
    a, b = lt.plot_metric(evals), lgb.plot_metric(evals)
    assert len(a.get_lines()) == 1
    assert len(a.get_lines()[0].get_xdata()) == 10
    assert np.array_equal(a.get_lines()[0].get_ydata(),
                          b.get_lines()[0].get_ydata())
    a = lt.plot_split_value_histogram(ours, feature=0)
    b = lgb.plot_split_value_histogram(ref, feature=0)
    assert _bars(a) == _bars(b) and a.get_title() == b.get_title()
    with pytest.raises(TypeError):
        lt.plot_metric(ours)
    plt.close("all")


def test_plot_tree_draws_the_digraph(trained, monkeypatch):
    graphviz = pytest.importorskip("graphviz")
    _, ours, _ = trained
    buf = io.BytesIO()
    plt.imsave(buf, np.zeros((4, 6, 3)), format="png")
    seen = []

    def pipe(self, format=None):
        seen.append((format, self.source))
        return buf.getvalue()

    monkeypatch.setattr(graphviz.Digraph, "pipe", pipe)
    ax = lt.plot_tree(ours, tree_index=1)
    assert ax.get_images()[0].get_array().shape[:2] == (4, 6)
    assert seen == [("png", lt.create_tree_digraph(ours,
                                                   tree_index=1).source)]
    plt.close("all")


def test_estimator_and_empty_importance():
    rng = np.random.RandomState(0)
    X = rng.randn(200, 3)
    m = lt.LGBMRegressor(n_estimators=3, num_leaves=5, device_type="cpu",
                         verbosity=-1).fit(X, X[:, 0])
    assert lt.plot_importance(m) is not None
    flat = lt.Booster(model_str=lgb.train(
        {"objective": "regression", "verbosity": -1},
        lgb.Dataset(X, label=np.zeros(200)),
        num_boost_round=1).model_to_string())
    # constant target -> no splits -> importance empty
    with pytest.raises(ValueError):
        lt.plot_importance(flat)
    with pytest.raises(TypeError):
        lt.plot_importance({"not": "a booster"})
    plt.close("all")
