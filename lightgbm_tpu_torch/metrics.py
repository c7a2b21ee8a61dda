"""Evaluation metrics: host-side numpy over the raw scores.

A copy of the JAX package's `metrics.py` (ref: src/metric/metric.cpp
`Metric::CreateMetric`; regression_metric.hpp, binary_metric.hpp,
multiclass_metric.hpp) for the metrics the training slice's three
objectives use by default or commonly: `l2`, `rmse`, `l1`,
`binary_logloss`, `binary_error`, `auc`, `multi_logloss` and
`multi_error`.  Metrics run in f64 numpy on the raw score, applying the
link themselves, exactly as the reference's do; any other metric name
raises.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from .utils.log import LightGBMError


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _avg(values, weight):
    if weight is None:
        return float(np.mean(values))
    return float(np.sum(values * weight) / np.sum(weight))


class Metric:
    """One evaluation metric (ref: include/LightGBM/metric.h `Metric`)."""

    def __init__(self, name: str, fn: Callable, higher_better: bool):
        self.name = name
        self.fn = fn
        self.higher_better = higher_better

    def eval(self, score: np.ndarray, label: np.ndarray,
             weight: Optional[np.ndarray],
             query_boundaries: Optional[np.ndarray]) -> List[Tuple[str, float]]:
        out = self.fn(score, label, weight, query_boundaries)
        if isinstance(out, list):
            return out
        return [(self.name, float(out))]


def _l1(score, label, weight, qb):
    return _avg(np.abs(score - label), weight)


def _l2(score, label, weight, qb):
    return _avg((score - label) ** 2, weight)


def _rmse(score, label, weight, qb):
    return float(np.sqrt(_l2(score, label, weight, qb)))


def _binary_logloss(score, label, weight, qb, sigmoid=1.0):
    p = np.clip(_sigmoid(sigmoid * score), 1e-15, 1 - 1e-15)
    loss = -(label * np.log(p) + (1 - label) * np.log(1 - p))
    return _avg(loss, weight)


def _binary_error(score, label, weight, qb, sigmoid=1.0):
    pred = (_sigmoid(sigmoid * score) > 0.5).astype(np.float64)
    return _avg((pred != label).astype(np.float64), weight)


def _auc(score, label, weight, qb):
    """Weighted ROC-AUC via rank-sum (ref: binary_metric.hpp `AUCMetric`)."""
    order = np.argsort(score, kind="mergesort")
    s, y = score[order], label[order]
    w = weight[order] if weight is not None else np.ones_like(s)
    # group ties: average rank handled via trapezoid on cumulative sums
    pos_w = np.where(y > 0, w, 0.0)
    neg_w = np.where(y > 0, 0.0, w)
    # unique score groups
    boundary = np.nonzero(np.diff(s))[0] + 1
    seg = np.concatenate([[0], boundary, [len(s)]])
    auc_sum = 0.0
    cum_neg = 0.0
    for i in range(len(seg) - 1):
        a, b = seg[i], seg[i + 1]
        gp = pos_w[a:b].sum()
        gn = neg_w[a:b].sum()
        auc_sum += gp * (cum_neg + 0.5 * gn)
        cum_neg += gn
    total_pos = pos_w.sum()
    total_neg = neg_w.sum()
    if total_pos == 0 or total_neg == 0:
        return 0.5
    return float(auc_sum / (total_pos * total_neg))


def _multi_logloss(score, label, weight, qb):
    p = np.clip(_softmax(score), 1e-15, None)
    idx = label.astype(np.int64)
    loss = -np.log(p[np.arange(len(idx)), idx])
    return _avg(loss, weight)


def _make_multi_error(top_k):
    def f(score, label, weight, qb):
        idx = label.astype(np.int64)
        if top_k <= 1:
            err = (np.argmax(score, axis=1) != idx).astype(np.float64)
        else:
            # in top-k? (ref: multi_error_top_k)
            part = np.argpartition(-score, min(top_k, score.shape[1] - 1),
                                   axis=1)[:, :top_k]
            err = (~(part == idx[:, None]).any(axis=1)).astype(np.float64)
        return _avg(err, weight)
    return f


def create_metrics(config, metric_names: List[str]) -> List[Metric]:
    """Factory (ref: src/metric/metric.cpp `Metric::CreateMetric`; the
    JAX package's `metrics.py:350`), for this slice's metrics."""
    out: List[Metric] = []
    for name in metric_names:
        if name in ("", "none", "null", "custom", "na"):
            continue
        if name == "l1":
            out.append(Metric("l1", _l1, False))
        elif name == "l2":
            out.append(Metric("l2", _l2, False))
        elif name == "rmse":
            out.append(Metric("rmse", _rmse, False))
        elif name == "binary_logloss":
            sig = config.sigmoid
            out.append(Metric("binary_logloss",
                              lambda s, l, w, q: _binary_logloss(s, l, w, q,
                                                                 sig),
                              False))
        elif name == "binary_error":
            sig = config.sigmoid
            out.append(Metric("binary_error",
                              lambda s, l, w, q: _binary_error(s, l, w, q,
                                                               sig),
                              False))
        elif name == "auc":
            out.append(Metric("auc", _auc, True))
        elif name == "multi_logloss":
            out.append(Metric("multi_logloss", _multi_logloss, False))
        elif name == "multi_error":
            out.append(Metric("multi_error",
                              _make_multi_error(config.multi_error_top_k),
                              False))
        else:
            raise LightGBMError(f"metric {name!r} is not ported yet "
                                "(ROADMAP Queue 1 item 5)")
    return out
