"""Evaluation metrics: host-side numpy over the raw scores.

A copy of the JAX package's `metrics.py` (ref: src/metric/metric.cpp
`Metric::CreateMetric`; regression_metric.hpp, binary_metric.hpp,
multiclass_metric.hpp, rank_metric.hpp, map_metric.hpp,
xentropy_metric.hpp, dcg_calculator.cpp `DCGCalculator`): every metric
the reference has, NDCG and MAP at `eval_at` over query boundaries
(NDCG in the reference's length buckets, `rank_objective.py
_bucket_queries`), `label_gain`, and `is_higher_better`.  Metrics run
in f64 numpy on the raw score, applying the link themselves, exactly
as the reference's do, so both packages give equal values.
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
             query_boundaries: Optional[np.ndarray]
             ) -> List[Tuple[str, float]]:
        out = self.fn(score, label, weight, query_boundaries)
        if isinstance(out, list):
            return out
        return [(self.name, float(out))]


# ------------------------------------------------------------- regression
def _l1(score, label, weight, qb):
    return _avg(np.abs(score - label), weight)


def _l2(score, label, weight, qb):
    return _avg((score - label) ** 2, weight)


def _rmse(score, label, weight, qb):
    return float(np.sqrt(_l2(score, label, weight, qb)))


def _make_quantile(alpha):
    def f(score, label, weight, qb):
        d = label - score
        return _avg(np.where(d >= 0, alpha * d, (alpha - 1) * d), weight)
    return f


def _make_huber(alpha):
    def f(score, label, weight, qb):
        d = np.abs(score - label)
        loss = np.where(d <= alpha, 0.5 * d * d, alpha * (d - 0.5 * alpha))
        return _avg(loss, weight)
    return f


def _make_fair(c):
    def f(score, label, weight, qb):
        d = np.abs(score - label)
        return _avg(c * c * (d / c - np.log1p(d / c)), weight)
    return f


def _poisson(score, label, weight, qb):
    # score is raw (log link) — ref: PoissonMetric::LossOnPoint
    p = np.exp(score)
    return _avg(p - label * score, weight)


def _gamma(score, label, weight, qb):
    p = np.exp(score)
    return _avg(label / p + score, weight)


def _gamma_deviance(score, label, weight, qb):
    p = np.exp(score)
    eps = 1e-9
    return _avg(2.0 * (np.log(np.maximum(p, eps) / np.maximum(label, eps))
                       + label / np.maximum(p, eps) - 1.0), weight)


def _make_tweedie(rho):
    def f(score, label, weight, qb):
        p = np.exp(score)
        a = label * np.exp((1 - rho) * score) / (1 - rho)
        b = np.exp((2 - rho) * score) / (2 - rho)
        return _avg(-a + b, weight)
    return f


def _mape(score, label, weight, qb):
    return _avg(np.abs(score - label) / np.maximum(1.0, np.abs(label)), weight)


# ----------------------------------------------------------------- binary
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


def _average_precision(score, label, weight, qb):
    """ref: binary_metric.hpp `AveragePrecisionMetric`."""
    order = np.argsort(-score, kind="mergesort")
    y = label[order]
    w = weight[order] if weight is not None \
        else np.ones_like(y, dtype=np.float64)
    tp = np.cumsum(w * (y > 0))
    fp = np.cumsum(w * (y <= 0))
    total_pos = tp[-1]
    if total_pos == 0:
        return 0.0
    precision = tp / np.maximum(tp + fp, 1e-30)
    recall_delta = np.diff(np.concatenate([[0.0], tp])) / total_pos
    return float(np.sum(precision * recall_delta))


# ------------------------------------------------------------- multiclass
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


def _auc_mu(score, label, weight, qb):
    """Multiclass AUC-mu (ref: src/metric/multiclass_metric.hpp `AucMuMetric`),
    simplified: mean of pairwise one-vs-one AUCs on the score differences."""
    k = score.shape[1]
    idx = label.astype(np.int64)
    aucs = []
    for a in range(k):
        for b in range(a + 1, k):
            mask = (idx == a) | (idx == b)
            if mask.sum() == 0:
                continue
            sub_s = score[mask, a] - score[mask, b]
            sub_y = (idx[mask] == a).astype(np.float64)
            sub_w = weight[mask] if weight is not None else None
            aucs.append(_auc(sub_s, sub_y, sub_w, None))
    return float(np.mean(aucs)) if aucs else 0.5


# ---------------------------------------------------------------- ranking
def _dcg_at(scores, labels, k, label_gain):
    order = np.argsort(-scores, kind="mergesort")[:k]
    gains = label_gain[labels[order].astype(np.int64)]
    discounts = 1.0 / np.log2(np.arange(2, len(order) + 2))
    return float(np.sum(gains * discounts))


def _ndcg_scalar(score, label, qb, eval_at, lg):
    """The per-query loop (ref: rank_metric.hpp `NDCGMetric`,
    dcg_calculator.cpp), which the bucketed path below equals."""
    results = []
    for k in eval_at:
        vals = []
        for q in range(len(qb) - 1):
            s, e = qb[q], qb[q + 1]
            ideal = _dcg_at(label[s:e].astype(np.float64), label[s:e], k, lg)
            if ideal <= 0:
                vals.append(1.0)
                continue
            vals.append(_dcg_at(score[s:e], label[s:e], k, lg) / ideal)
        results.append((f"ndcg@{k}", float(np.mean(vals))))
    return results


def _ndcg_bucketed(score, label, qb, eval_at, lg):
    """NDCG over the ranking objectives' length buckets
    (`rank_objective._bucket_queries`): every query of a bucket sorted
    and gathered in one [Q_b, P_b] batch.  Per-query values equal the
    per-query loop's (`_ndcg_scalar`) to f64 round-off: the padded tail
    adds exact zeros, a stable argsort keeps mergesort's tie order, and
    the per-query results go back to query order before the mean."""
    from .rank_objective import _bucket_queries
    sizes = np.diff(qb).astype(np.int64)
    nq = len(sizes)
    lab = label.astype(np.int64)
    score = np.asarray(score, dtype=np.float64)
    out = {k: np.ones(nq, dtype=np.float64) for k in eval_at}
    for qidx in _bucket_queries(sizes):
        pb = int(sizes[qidx].max())
        idx = np.full((len(qidx), pb), -1, dtype=np.int64)
        for row, q in enumerate(qidx):
            idx[row, :sizes[q]] = np.arange(qb[q], qb[q + 1])
        valid = idx >= 0
        g = np.maximum(idx, 0)
        gains = np.where(valid, lg[lab[g]], 0.0)
        # pads sort last (-inf score); `stable` keeps within-query order
        # on ties, same as the scalar mergesort
        o_s = np.argsort(np.where(valid, -score[g], np.inf), axis=1,
                         kind="stable")
        o_i = np.argsort(np.where(valid, -lab[g].astype(np.float64),
                                  np.inf), axis=1, kind="stable")
        disc = 1.0 / np.log2(np.arange(2, pb + 2, dtype=np.float64))
        dcg_t = np.take_along_axis(gains, o_s, axis=1) * disc
        ideal_t = np.take_along_axis(gains, o_i, axis=1) * disc
        for k in eval_at:
            ideal = ideal_t[:, :k].sum(axis=1)
            dcg = dcg_t[:, :k].sum(axis=1)
            out[k][qidx] = np.where(ideal > 0,
                                    dcg / np.where(ideal > 0, ideal, 1.0),
                                    1.0)
    return [(f"ndcg@{k}", float(np.mean(out[k]))) for k in eval_at]


def _make_ndcg(eval_at, label_gain):
    lg = np.asarray(label_gain, dtype=np.float64)

    def f(score, label, weight, qb):
        if qb is None:
            raise LightGBMError("NDCG metric requires query information")
        return _ndcg_bucketed(score, label, np.asarray(qb),
                              tuple(eval_at), lg)
    return f


def _make_map(eval_at):
    def f(score, label, weight, qb):
        if qb is None:
            raise LightGBMError("MAP metric requires query information")
        results = []
        for k in eval_at:
            vals = []
            for q in range(len(qb) - 1):
                s, e = qb[q], qb[q + 1]
                order = np.argsort(-score[s:e], kind="mergesort")
                rel = (label[s:e][order] > 0).astype(np.float64)
                topk = rel[:k]
                if rel.sum() == 0:
                    vals.append(0.0)
                    continue
                prec = np.cumsum(topk) / np.arange(1, len(topk) + 1)
                vals.append(float(np.sum(prec * topk) /
                                  min(rel.sum(), k)))
            results.append((f"map@{k}", float(np.mean(vals))))
        return results
    return f


# ----------------------------------------------------------- cross-entropy
def _cross_entropy(score, label, weight, qb):
    p = np.clip(_sigmoid(score), 1e-15, 1 - 1e-15)
    return _avg(-(label * np.log(p) + (1 - label) * np.log(1 - p)), weight)


def _cross_entropy_lambda(score, label, weight, qb):
    # link p = 1 - exp(-w*hhat), hhat = log1p(exp(s)); with w=1 this equals
    # xent(y, sigmoid(s)) (ref: xentropy_metric.hpp CrossEntropyLambdaMetric)
    w = weight if weight is not None else np.ones_like(score)
    hhat = np.log1p(np.exp(np.minimum(score, 30)))
    wh = np.maximum(w * hhat, 1e-12)
    log_p = np.log(-np.expm1(-wh))
    loss = -(label * log_p - (1 - label) * (-wh))
    return float(np.mean(loss))


def _kldiv(score, label, weight, qb):
    p = np.clip(_sigmoid(score), 1e-15, 1 - 1e-15)
    y = np.clip(label, 1e-15, 1 - 1e-15)
    kl = y * np.log(y / p) + (1 - y) * np.log((1 - y) / (1 - p))
    return _avg(kl, weight)


def create_metrics(config, metric_names: List[str]) -> List[Metric]:
    """Factory (ref: src/metric/metric.cpp `Metric::CreateMetric`)."""
    out: List[Metric] = []
    label_gain = config.label_gain
    if not label_gain:
        label_gain = [float((1 << i) - 1) for i in range(31)]
    for name in metric_names:
        if name in ("", "none", "null", "custom", "na"):
            continue
        if name == "l1":
            out.append(Metric("l1", _l1, False))
        elif name == "l2":
            out.append(Metric("l2", _l2, False))
        elif name == "rmse":
            out.append(Metric("rmse", _rmse, False))
        elif name == "quantile":
            out.append(Metric("quantile", _make_quantile(config.alpha), False))
        elif name == "huber":
            out.append(Metric("huber", _make_huber(config.alpha), False))
        elif name == "fair":
            out.append(Metric("fair", _make_fair(config.fair_c), False))
        elif name == "poisson":
            out.append(Metric("poisson", _poisson, False))
        elif name == "gamma":
            out.append(Metric("gamma", _gamma, False))
        elif name == "gamma_deviance":
            out.append(Metric("gamma_deviance", _gamma_deviance, False))
        elif name == "tweedie":
            out.append(Metric("tweedie",
                              _make_tweedie(config.tweedie_variance_power),
                              False))
        elif name == "mape":
            out.append(Metric("mape", _mape, False))
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
        elif name == "average_precision":
            out.append(Metric("average_precision", _average_precision, True))
        elif name == "multi_logloss":
            out.append(Metric("multi_logloss", _multi_logloss, False))
        elif name == "multi_error":
            out.append(Metric("multi_error",
                              _make_multi_error(config.multi_error_top_k),
                              False))
        elif name == "auc_mu":
            out.append(Metric("auc_mu", _auc_mu, True))
        elif name == "ndcg":
            out.append(Metric("ndcg", _make_ndcg(config.eval_at,
                                                 label_gain), True))
        elif name == "map":
            out.append(Metric("map", _make_map(config.eval_at), True))
        elif name == "cross_entropy":
            out.append(Metric("cross_entropy", _cross_entropy, False))
        elif name == "cross_entropy_lambda":
            out.append(Metric("cross_entropy_lambda",
                              _cross_entropy_lambda, False))
        elif name == "kldiv":
            out.append(Metric("kldiv", _kldiv, False))
        else:
            raise LightGBMError(f"Unknown metric: {name}")
    return out


_HIGHER_BETTER = {"auc", "ndcg", "map", "average_precision", "auc_mu"}


def is_higher_better(metric_name: str) -> bool:
    base = metric_name.split("@")[0]
    return base in _HIGHER_BETTER
