"""Plotting utilities (API parity: python-package/lightgbm/plotting.py —
`plot_importance`, `plot_split_value_histogram`, `plot_metric`, `plot_tree`,
`create_tree_digraph`).

The port's copy of `lightgbm_tpu/plotting.py`, on the port's `Booster`
and `LGBMModel`: host-side matplotlib/graphviz over the model dump, each
imported inside the function that draws, so the package imports without
either."""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Optional

import numpy as np

from .booster import Booster
from .sklearn import LGBMModel
from .utils.log import LightGBMError


def _check_not_tuple_of_2_elements(obj, obj_name):
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a tuple of 2 elements.")


def _to_booster(booster) -> Booster:
    if isinstance(booster, LGBMModel):
        return booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be Booster or LGBMModel.")


def plot_importance(booster, ax=None, height: float = 0.2, xlim=None,
                    ylim=None, title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features",
                    importance_type: str = "auto",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, dpi=None,
                    grid: bool = True, precision: Optional[int] = 3,
                    **kwargs):
    """ref: plotting.py `plot_importance`."""
    import matplotlib.pyplot as plt

    booster = _to_booster(booster)
    if importance_type == "auto":
        importance_type = "split"
    importance = booster.feature_importance(importance_type)
    feature_name = booster.feature_name()
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty.")
    tuples = sorted(zip(feature_name, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples)

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y,
                f"{x:.{precision}f}" if isinstance(x, float) else str(x),
                va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, max(values) * 1.1)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        ylim = (-1, len(values))
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric: Optional[str] = None,
                dataset_names=None, ax=None, xlim=None, ylim=None,
                title: str = "Metric during training",
                xlabel: str = "Iterations", ylabel: str = "@metric@",
                figsize=None, dpi=None, grid: bool = True):
    """ref: plotting.py `plot_metric` (takes the eval_result dict recorded by
    `record_evaluation`, or an LGBMModel)."""
    import matplotlib.pyplot as plt

    if isinstance(booster, LGBMModel):
        eval_results = deepcopy(booster.evals_result_)
    elif isinstance(booster, dict):
        eval_results = deepcopy(booster)
    else:
        raise TypeError("booster must be dict or LGBMModel.")
    num_data = len(eval_results)
    if not num_data:
        raise ValueError("eval results cannot be empty.")
    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    if dataset_names is None:
        dataset_names = iter(eval_results.keys())
    name = None
    msv = []
    for name in dataset_names:
        metrics_for_one = eval_results[name]
        if metric is None:
            metric, results = next(iter(metrics_for_one.items()))
        else:
            results = metrics_for_one[metric]
        num_iteration = len(results)
        max_result = max(results)
        min_result = min(results)
        x_ = range(num_iteration)
        ax.plot(x_, results, label=name)
        msv.append((max_result, min_result))
    ax.legend(loc="best")
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
        ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
        ax.set_ylim(ylim)
    if ylabel == "@metric@":
        ylabel = metric
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef: float = 0.8, xlim=None, ylim=None,
                               title="Split value histogram for feature with "
                                     "@index/name@ @feature@",
                               xlabel="Feature split value", ylabel="Count",
                               figsize=None, dpi=None, grid: bool = True,
                               **kwargs):
    """ref: plotting.py `plot_split_value_histogram`."""
    import matplotlib.pyplot as plt

    booster = _to_booster(booster)
    hist, bin_edges = booster.get_split_value_histogram(feature, bins=bins)
    if not hist.sum():
        raise ValueError(
            f"Cannot plot split value histogram, "
            f"because feature {feature} was not used in splitting")
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    width = width_coef * (bin_edges[1] - bin_edges[0])
    centred = (bin_edges[:-1] + bin_edges[1:]) / 2
    ax.bar(centred, hist, width=width, align="center", **kwargs)
    if title is not None:
        title = title.replace("@feature@", str(feature)).replace(
            "@index/name@", "name" if isinstance(feature, str) else "index")
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def create_tree_digraph(booster, tree_index: int = 0, show_info=None,
                        precision: Optional[int] = 3,
                        orientation: str = "horizontal", **kwargs):
    """ref: plotting.py `create_tree_digraph` (graphviz Digraph of one tree)."""
    import graphviz

    booster = _to_booster(booster)
    model = booster.dump_model()
    if tree_index >= len(model["tree_info"]):
        raise IndexError("tree_index is out of range.")
    tree_info = model["tree_info"][tree_index]
    feature_names = model.get("feature_names")
    show_info = show_info or []

    graph = graphviz.Digraph(**kwargs)
    rankdir = "LR" if orientation == "horizontal" else "TB"
    graph.attr(rankdir=rankdir)

    def add(node: Dict[str, Any], parent: Optional[str], decision: str):
        if "split_index" in node:
            name = f"split{node['split_index']}"
            f = node["split_feature"]
            fname = feature_names[f] if feature_names else f"Column_{f}"
            label = f"{fname} <= {node['threshold']:.{precision}f}"
            for info in show_info:
                if info in node:
                    label += f"\n{info}: {node[info]:.{precision}f}" \
                        if isinstance(node[info], float) \
                        else f"\n{info}: {node[info]}"
            graph.node(name, label=label)
            add(node["left_child"], name, "yes")
            add(node["right_child"], name, "no")
        else:
            name = f"leaf{node['leaf_index']}"
            label = f"leaf {node['leaf_index']}: " \
                    f"{node['leaf_value']:.{precision}f}"
            if "leaf_count" in show_info:
                label += f"\ncount: {node['leaf_count']}"
            graph.node(name, label=label)
        if parent is not None:
            graph.edge(parent, name, label=decision)

    add(tree_info["tree_structure"], None, "")
    return graph


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None, dpi=None,
              show_info=None, precision: Optional[int] = 3,
              orientation: str = "horizontal", **kwargs):
    """ref: plotting.py `plot_tree` (renders the digraph into matplotlib)."""
    import matplotlib.image as mpimg
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    graph = create_tree_digraph(booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                orientation=orientation, **kwargs)
    import io as _io
    s = _io.BytesIO(graph.pipe(format="png"))
    img = mpimg.imread(s)
    ax.imshow(img)
    ax.axis("off")
    return ax
