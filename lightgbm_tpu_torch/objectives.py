"""Objective functions on torch tensors: output links and, for the
training slice, gradients.

The port's counterpart of `lightgbm_tpu/objectives.py`.  Two halves:

* loading: `parse_objective` reads a model text's `objective=` line into
  an `Objective`, whose `convert_output` is the link (ref:
  objective_function.h `ConvertOutput`) for every objective;
* training: `create_objective(config)` builds every objective of the
  reference (the regression family, binary, multiclass and one-vs-all,
  the two cross-entropies, and through `rank_objective.py` lambdarank
  and rank_xendcg) with `init_meta` (the label checks), its
  `boost_from_score` (host numpy, f64, as the reference), its
  `renew_percentile` (L1, quantile, MAPE: the leaves are refitted by
  `ops/renew.py`) and `grad_hess` (f32 torch, on whatever device the
  score lies, in the reference's op order).  Where XLA's CPU code
  contracts a product and a sum into a fused multiply-add inside the
  reference's jitted gradients, the port repeats it with
  `ops/xla_math.py _fma` (gamma, tweedie).

`convert_output` takes the f32 raw scores (the round-to-nearest-even
downcast of the exact f64 sums) and applies the link in f32.  Sigmoid,
softmax and exp, in the links and in `grad_hess`, are XLA's CPU
arithmetic bit for bit (`ops/xla_math.py`), so the same scores give the
reference's bits on the CPU and on the card; so are the log1p and
expm1 of `cross_entropy_lambda`'s training and the log of its link
(`ops/xla_math.py`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .ops.xla_math import (_fma, fma_rn, xla_exp_f32, xla_expm1_f32,
                           xla_log1p_f32, xla_sigmoid, xla_softmax)
from .utils import log
from .utils.log import LightGBMError

#: objective-name aliases, as the JAX package's `utils/config.py`
#: resolves them (ref: config.cpp `ParseObjectiveAlias`)
_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression",
    "l2": "regression", "mean_squared_error": "regression",
    "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank", "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg", "xendcg_mart": "rank_xendcg",
    "custom": "custom", "none": "custom", "null": "custom", "na": "custom",
}

#: objective parameters a model text can carry, with the JAX package's
#: defaults (`utils/config.py` `_PARAMS`)
_DEFAULTS = {"sigmoid": 1.0, "num_class": 1, "alpha": 0.9, "fair_c": 1.0,
             "tweedie_variance_power": 1.5, "reg_sqrt": False}


def _as_bool(v) -> bool:
    if isinstance(v, str):
        return v.lower() in ("true", "1", "+", "yes")
    return bool(v)


class Objective:
    """A loaded model's objective: its canonical name, the parameters
    the model text names, and the output link."""

    def __init__(self, name: str, params: Dict):
        self.name = name
        cfg = dict(_DEFAULTS)
        for k in _DEFAULTS:
            if k in params:
                cfg[k] = params[k]
        self.sigmoid = float(cfg["sigmoid"])
        self.num_class = int(cfg["num_class"])
        self.alpha = float(cfg["alpha"])
        self.fair_c = float(cfg["fair_c"])
        self.tweedie_variance_power = float(cfg["tweedie_variance_power"])
        self.sqrt = _as_bool(cfg["reg_sqrt"])
        if name in ("binary", "multiclassova") and self.sigmoid <= 0:
            raise LightGBMError(
                "Sigmoid parameter should be greater than zero")

    def convert_output(self, score: torch.Tensor) -> torch.Tensor:
        """Raw f32 score -> output, in the JAX package's op order."""
        n = self.name
        if n in ("regression", "regression_l1", "huber", "fair",
                 "quantile", "mape"):
            if self.sqrt:
                # sign(s) * s * s, with XLA's signed zero: -0.0 -> -0.0
                return torch.copysign(score * score, score)
            return score
        if n in ("poisson", "gamma", "tweedie"):
            return xla_exp_f32(score)
        if n in ("binary", "multiclassova"):
            return xla_sigmoid(self.sigmoid * score)
        if n == "multiclass":
            return xla_softmax(score, dim=-1)
        if n == "cross_entropy":
            return xla_sigmoid(score)
        if n == "cross_entropy_lambda":
            return xla_log1p_f32(xla_exp_f32(score))
        return score            # ranking objectives: identity

    def to_string(self) -> str:
        """The model text's `objective=` value (`booster.py`
        `_objective_to_string`)."""
        n = self.name
        if n == "binary":
            return f"binary sigmoid:{self.sigmoid:g}"
        if n == "multiclass":
            return f"multiclass num_class:{self.num_class}"
        if n == "multiclassova":
            return (f"multiclassova num_class:{self.num_class} "
                    f"sigmoid:{self.sigmoid:g}")
        if n == "quantile":
            return f"quantile alpha:{self.alpha:g}"
        if n == "huber":
            return f"huber alpha:{self.alpha:g}"
        if n == "fair":
            return f"fair fair_c:{self.fair_c:g}"
        if n == "tweedie":
            return (f"tweedie "
                    f"tweedie_variance_power:{self.tweedie_variance_power:g}")
        return n


def parse_objective(line: str, params: Optional[Dict] = None
                    ) -> Optional[Objective]:
    """Objective of a model text: `line` is the `objective=` header
    value (`binary sigmoid:1`), `params` the `[key: value]` entries of
    its parameters section, which the line's own tokens override (the
    JAX package's `Booster.model_from_string`).  None for `custom`."""
    toks = (line or "regression").split()
    merged = dict(params or {})
    for tok in toks[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            merged[k] = v
    name = _OBJECTIVE_ALIASES.get(toks[0], toks[0])
    if name == "custom":
        return None
    if name not in _OBJECTIVE_ALIASES.values():
        raise LightGBMError(f"Unknown objective: {name}")
    return Objective(name, merged)


# ------------------------------------------------------------ training
def _apply_weight(grad, hess, weight):
    if weight is None:
        return grad, hess
    if grad.dim() == 2 and weight.dim() == 1:
        weight = weight[:, None]
    return grad * weight, hess * weight


#: objectives whose hessian is identically 1 before weighting, by exact
#: name (the reference's `objectives.py:43`): the packed quantized
#: histogram may derive their counts from the hessian field
#: (`booster.packed_const_hess_level`)
UNIT_HESSIAN_OBJECTIVES = frozenset(
    {"regression", "regression_l1", "huber", "quantile"})


class TrainObjective:
    """Base of the training objectives (ref: objective_function.h
    `ObjectiveFunction`).  Host-side set-up is numpy; `grad_hess` is
    f32 torch.  Score layout: [N], or [N, K] for multiclass."""

    name = "custom"
    num_tree_per_iteration = 1
    need_convert = False
    is_ranking = False
    #: the alpha of the L1 family's leaf refit (`ops/renew.py`), or None
    renew_percentile: Optional[float] = None
    #: the reference's op-by-op arithmetic (its `refit` calls
    #: `grad_hess` outside `jax.jit`, where XLA contracts nothing and
    #: reduces each sum alone) instead of its jitted training step's
    eager = False

    def __init__(self, config):
        self.config = config

    def init_meta(self, label: np.ndarray, weight: Optional[np.ndarray],
                  query_boundaries: Optional[np.ndarray] = None) -> None:
        self.num_data = len(label)

    def boost_from_score(self, label: np.ndarray,
                         weight: Optional[np.ndarray]):
        return 0.0

    def grad_hess(self, score: torch.Tensor, label: torch.Tensor,
                  weight: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def link(self) -> Objective:
        """The loading-side `Objective` of this training objective, as
        the trained model's text will load it."""
        return parse_objective(self.to_string(),
                               {k: getattr(self.config, k)
                                for k in _DEFAULTS})

    def to_string(self) -> str:
        """The model text's `objective=` value (the reference's
        `booster.py _objective_to_string`)."""
        c = self.config
        n = self.name
        if n == "quantile":
            return f"quantile alpha:{c.alpha:g}"
        if n == "huber":
            return f"huber alpha:{c.alpha:g}"
        if n == "fair":
            return f"fair fair_c:{c.fair_c:g}"
        if n == "tweedie":
            return (f"tweedie "
                    f"tweedie_variance_power:{c.tweedie_variance_power:g}")
        return n


def _mul_add(a, b, c):
    """a * b + c rounded twice, as two ops."""
    return a * b + c


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """IEEE f32 `num / den` for a Python number `num` (torch computes
    a scalar over a tensor as the reciprocal times the scalar)."""
    return torch.full_like(den, num) / den


class RegressionL2(TrainObjective):
    """ref: regression_objective.hpp `RegressionL2loss` (the JAX
    package's `objectives.py:86`)."""
    name = "regression"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = bool(config.reg_sqrt)

    def transform_label(self, label: np.ndarray) -> np.ndarray:
        """`reg_sqrt`'s label transform (the reference defines it and,
        like it, training does not apply it; the link squares)."""
        if self.sqrt:
            return np.sign(label) * np.sqrt(np.abs(label))
        return label

    def boost_from_score(self, label, weight):
        if not self.config.boost_from_average:
            return 0.0
        if weight is None:
            return float(np.mean(label))
        return float(np.average(label, weights=weight))

    def grad_hess(self, score, label, weight):
        grad = score - label
        hess = torch.ones_like(score)
        return _apply_weight(grad, hess, weight)


class RegressionL1(RegressionL2):
    """ref: regression_objective.hpp `RegressionL1loss`: sign gradients,
    the leaves refitted to their residuals' median."""
    name = "regression_l1"
    renew_percentile = 0.5

    def boost_from_score(self, label, weight):
        if not self.config.boost_from_average:
            return 0.0
        return _weighted_percentile(label, weight, 0.5)

    def grad_hess(self, score, label, weight):
        grad = torch.sign(score - label)
        hess = torch.ones_like(score)
        return _apply_weight(grad, hess, weight)


class HuberLoss(RegressionL2):
    """ref: regression_objective.hpp `RegressionHuberLoss`."""
    name = "huber"

    def grad_hess(self, score, label, weight):
        a = self.config.alpha
        grad = torch.clamp(score - label, -a, a)
        hess = torch.ones_like(score)
        return _apply_weight(grad, hess, weight)


class FairLoss(RegressionL2):
    """ref: regression_objective.hpp `RegressionFairLoss`."""
    name = "fair"

    def boost_from_score(self, label, weight):
        return 0.0

    def grad_hess(self, score, label, weight):
        c = self.config.fair_c
        d = score - label
        den = torch.abs(d) + c
        grad = c * d / den
        hess = _div(c * c, den * den)
        return _apply_weight(grad, hess, weight)


class PoissonLoss(RegressionL2):
    """ref: regression_objective.hpp `RegressionPoissonLoss` (log link)."""
    name = "poisson"
    need_convert = True

    def init_meta(self, label, weight, query_boundaries=None):
        super().init_meta(label, weight, query_boundaries)
        if np.any(label < 0):
            raise LightGBMError(
                "[poisson]: at least one target label is negative")

    def boost_from_score(self, label, weight):
        avg = (np.average(label, weights=weight) if weight is not None
               else np.mean(label))
        return float(np.log(max(avg, 1e-9)))

    def grad_hess(self, score, label, weight):
        grad = xla_exp_f32(score) - label
        hess = xla_exp_f32(score + self.config.poisson_max_delta_step)
        return _apply_weight(grad, hess, weight)


class QuantileLoss(RegressionL2):
    """ref: regression_objective.hpp `RegressionQuantileloss`: ties get
    the gradient 1 - alpha; the leaves are refitted to their residuals'
    alpha-percentile."""
    name = "quantile"

    def boost_from_score(self, label, weight):
        if not self.config.boost_from_average:
            return 0.0
        return _weighted_percentile(label, weight, self.config.alpha)

    def grad_hess(self, score, label, weight):
        a = self.config.alpha
        d = score - label
        grad = torch.where(d >= 0, torch.full_like(d, 1.0 - a),
                           torch.full_like(d, -a))
        hess = torch.ones_like(score)
        return _apply_weight(grad, hess, weight)

    @property
    def renew_percentile(self):
        return self.config.alpha


class MAPELoss(RegressionL2):
    """ref: regression_objective.hpp `RegressionMAPELOSS`: the label
    weights 1 / max(1, |label|), the leaves refitted to the weighted
    median."""
    name = "mape"
    renew_percentile = 0.5

    def init_meta(self, label, weight, query_boundaries=None):
        super().init_meta(label, weight, query_boundaries)
        self.label_weight = (1.0 / np.maximum(1.0, np.abs(label))
                             ).astype(np.float32)

    def boost_from_score(self, label, weight):
        if not self.config.boost_from_average:
            return 0.0
        lw = 1.0 / np.maximum(1.0, np.abs(label))
        if weight is not None:
            lw = lw * weight
        return _weighted_percentile(label, lw, 0.5)

    def grad_hess(self, score, label, weight):
        lw = _div(1.0, torch.clamp(torch.abs(label), min=1.0))
        grad = torch.sign(score - label) * lw
        return _apply_weight(grad, lw, weight)


class GammaLoss(PoissonLoss):
    """ref: regression_objective.hpp `RegressionGammaLoss` (log link).
    The reference's jitted gradients hold label and weight as constants:
    unweighted, `label * exp(-s)` is one fusion's output shared by both
    results, so `1 - label * exp(-s)` rounds twice; weighted, XLA's CPU
    code contracts it into one fma and folds `label * weight` into a
    constant that multiplies `exp(-s)`."""
    name = "gamma"

    def init_meta(self, label, weight, query_boundaries=None):
        TrainObjective.init_meta(self, label, weight, query_boundaries)
        if np.any(label <= 0):
            raise LightGBMError(
                "[gamma]: at least one target label is not positive")

    def grad_hess(self, score, label, weight):
        exp_ns = xla_exp_f32(-score)
        if self.eager:
            hess = label * exp_ns
            return _apply_weight(1.0 - hess, hess, weight)
        if weight is None:
            hess = label * exp_ns
            return 1.0 - hess, hess
        return _fma(-label, exp_ns, 1.0) * weight, (label * weight) * exp_ns


class TweedieLoss(PoissonLoss):
    """ref: regression_objective.hpp `RegressionTweedieLoss`.  XLA's CPU
    code contracts `-label * e1 + e2` and the hessian's sum into fmas."""
    name = "tweedie"

    def init_meta(self, label, weight, query_boundaries=None):
        TrainObjective.init_meta(self, label, weight, query_boundaries)
        if np.any(label < 0):
            raise LightGBMError(
                "[tweedie]: at least one target label is negative")

    def grad_hess(self, score, label, weight):
        rho = self.config.tweedie_variance_power
        e1 = xla_exp_f32((1.0 - rho) * score)
        e2 = xla_exp_f32((2.0 - rho) * score)
        if self.eager:
            grad = -label * e1 + e2
            hess = -label * (1.0 - rho) * e1 + (2.0 - rho) * e2
        else:
            grad = _fma(-label, e1, e2)
            hess = _fma(-label * (1.0 - rho), e1, (2.0 - rho) * e2)
        return _apply_weight(grad, hess, weight)


class BinaryLogloss(TrainObjective):
    """ref: binary_objective.hpp `BinaryLogloss` (the JAX package's
    `objectives.py:274`)."""
    name = "binary"
    need_convert = True

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        if self.sigmoid <= 0:
            raise LightGBMError(
                "Sigmoid parameter should be greater than zero")

    def init_meta(self, label, weight, query_boundaries=None):
        super().init_meta(label, weight, query_boundaries)
        uniq = np.unique(label)
        if not np.all(np.isin(uniq, [0, 1])):
            raise LightGBMError("Binary objective requires labels in "
                                f"{{0, 1}}, got values {uniq[:5]}")
        cnt_pos = float((label == 1).sum() if weight is None
                        else weight[label == 1].sum())
        cnt_neg = float((label == 0).sum() if weight is None
                        else weight[label == 0].sum())
        self.cnt_pos, self.cnt_neg = cnt_pos, cnt_neg
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                self.label_weight = (1.0, cnt_pos / cnt_neg)
            else:
                self.label_weight = (cnt_neg / cnt_pos, 1.0)
        else:
            self.label_weight = (1.0, self.config.scale_pos_weight)

    def boost_from_score(self, label, weight):
        if not self.config.boost_from_average:
            return 0.0
        w_neg, w_pos = self.label_weight
        spos = self.cnt_pos * w_pos
        sneg = self.cnt_neg * w_neg
        if spos <= 0 or sneg <= 0:
            return 0.0
        pavg = spos / (spos + sneg)
        init = float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)
        log.info(f"[binary:BoostFromScore]: pavg={pavg:.6f} -> "
                 f"initscore={init:.6f}")
        return init

    def grad_hess(self, score, label, weight):
        sig = self.sigmoid
        p = xla_sigmoid(sig * score)
        w_neg, w_pos = self.label_weight
        cls_w = torch.where(label > 0, w_pos, w_neg).to(score.dtype)
        grad = sig * (p - label) * cls_w
        hess = sig * sig * p * (1.0 - p) * cls_w
        return _apply_weight(grad, hess, weight)

    def to_string(self) -> str:
        return f"binary sigmoid:{self.sigmoid:g}"


class MulticlassSoftmax(TrainObjective):
    """ref: multiclass_objective.hpp `MulticlassSoftmax` (the JAX
    package's `objectives.py:332`)."""
    name = "multiclass"
    need_convert = True

    def __init__(self, config):
        super().__init__(config)
        self.num_class = config.num_class
        self.num_tree_per_iteration = config.num_class

    def init_meta(self, label, weight, query_boundaries=None):
        super().init_meta(label, weight, query_boundaries)
        ilab = label.astype(np.int64)
        if np.any(ilab < 0) or np.any(ilab >= self.num_class):
            raise LightGBMError(f"Label must be in [0, {self.num_class}) "
                                "for multiclass objective")

    def boost_from_score(self, label, weight):
        return [0.0] * self.num_class

    def grad_hess(self, score, label, weight):
        p = xla_softmax(score, dim=1)
        onehot = torch.nn.functional.one_hot(
            label.to(torch.int64), self.num_class).to(score.dtype)
        grad = p - onehot
        factor = self.num_class / max(self.num_class - 1, 1)
        hess = factor * p * (1.0 - p)
        return _apply_weight(grad, hess, weight)

    def to_string(self) -> str:
        return f"multiclass num_class:{self.num_class}"


class MulticlassOVA(TrainObjective):
    """ref: multiclass_objective.hpp `MulticlassOVA`: K independent
    sigmoids (the JAX package's `objectives.py:357`)."""
    name = "multiclassova"
    need_convert = True

    def __init__(self, config):
        super().__init__(config)
        self.num_class = config.num_class
        self.num_tree_per_iteration = config.num_class
        self.sigmoid = config.sigmoid

    def boost_from_score(self, label, weight):
        return [0.0] * self.num_class

    def grad_hess(self, score, label, weight):
        sig = self.sigmoid
        onehot = torch.nn.functional.one_hot(
            label.to(torch.int64), self.num_class).to(score.dtype)
        p = xla_sigmoid(sig * score)
        grad = sig * (p - onehot)
        hess = sig * sig * p * (1.0 - p)
        return _apply_weight(grad, hess, weight)

    def to_string(self) -> str:
        return (f"multiclassova num_class:{self.num_class} "
                f"sigmoid:{self.sigmoid:g}")


class CrossEntropy(TrainObjective):
    """ref: xentropy_objective.hpp `CrossEntropy` (labels in [0, 1])."""
    name = "cross_entropy"
    need_convert = True

    def init_meta(self, label, weight, query_boundaries=None):
        super().init_meta(label, weight, query_boundaries)
        if np.any(label < 0) or np.any(label > 1):
            raise LightGBMError("[cross_entropy]: labels must be in [0, 1]")

    def boost_from_score(self, label, weight):
        avg = (np.average(label, weights=weight) if weight is not None
               else np.mean(label))
        avg = min(max(avg, 1e-9), 1 - 1e-9)
        return float(np.log(avg / (1.0 - avg)))

    def grad_hess(self, score, label, weight):
        p = xla_sigmoid(score)
        grad = p - label
        hess = p * (1.0 - p)
        return _apply_weight(grad, hess, weight)


#: the f32 floor of `cross_entropy_lambda`'s w h
_EPS12 = float(np.float32(1e-12))


class CrossEntropyLambda(TrainObjective):
    """ref: xentropy_objective.hpp `CrossEntropyLambda`.  The reference
    differentiates its point loss -(y log p - (1 - y)(-w h)), p = 1 -
    exp(-max(w h, 1e-12)), h = log1p(exp(s)), twice with `jax.grad`;
    here the two jaxprs are repeated op for op, with XLA's CPU exp,
    log1p and expm1 (`ops/xla_math.py`) and the two fmas its code
    contracts in the hessian."""
    name = "cross_entropy_lambda"
    need_convert = True

    def init_meta(self, label, weight, query_boundaries=None):
        super().init_meta(label, weight, query_boundaries)
        if np.any(label < 0):
            raise LightGBMError(
                "[cross_entropy_lambda]: labels must be >= 0")

    def boost_from_score(self, label, weight):
        avg = (np.average(label, weights=weight) if weight is not None
               else np.mean(label))
        return float(np.log(np.expm1(max(avg, 1e-9)))) \
            if avg > 1e-9 else -9.0

    def grad_hess(self, score, label, weight):
        # the jaxprs of jax.grad and jax.grad(jax.grad) of the point loss,
        # op for op (c is the weight, b the label, a the score)
        a, b = score, label
        c = weight if weight is not None else torch.ones_like(score)
        one = torch.ones_like(a)
        zero = torch.zeros_like(a)
        d = xla_exp_f32(a)
        f = d + 1.0
        h = c * xla_log1p_f32(d)
        i = torch.clamp(h, min=_EPS12)
        # the max's derivative: 1 where h is the max, halved at a tie
        s_ = torch.where(h == i, one, zero) / torch.where(
            i == _EPS12, 2.0 * one, one)
        u = xla_expm1_f32(-i)
        w = u + 1.0
        x = -u
        ba = 1.0 - b
        bi = -b
        bl = -(bi / x)
        bq = c * (-ba + (-(bl * w)) * s_)
        br = bq / f
        grad = br * d
        # XLA's CPU code contracts these two sums into fmas
        fma = _mul_add if self.eager else fma_rn
        by = fma(-(d * _div(1.0, f * f)), bq, br)
        cc = -((c * (d / f)) * s_)
        ck = fma(bl, cc, ((-(cc * w)) * _div(1.0, x * x)) * bi)
        cp = (c * ((-(ck * w)) * s_)) / f
        hess = (by + cp) * d
        return grad, hess


# ----------------------------------------------------------- utilities
def _weighted_percentile(values: np.ndarray, weight: Optional[np.ndarray],
                         alpha: float) -> float:
    """The (weighted) alpha-percentile of `values`, the reference's
    `objectives.py:464` (ref: regression_objective.hpp `PercentileFun`,
    `WeightedPercentileFun`): unweighted, interpolated at alpha (n - 1);
    weighted, the first sorted value whose cumulative weight less half
    its own reaches alpha times the total."""
    values = np.asarray(values, dtype=np.float64)
    if len(values) == 0:
        return 0.0
    if weight is None:
        order = np.argsort(values)
        pos = alpha * (len(values) - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, len(values) - 1)
        frac = pos - lo
        return float(values[order[lo]] * (1 - frac)
                     + values[order[hi]] * frac)
    order = np.argsort(values)
    sv, sw = values[order], np.asarray(weight, dtype=np.float64)[order]
    cum = np.cumsum(sw) - 0.5 * sw
    t = alpha * sw.sum()
    idx = np.searchsorted(cum, t)
    idx = min(max(idx, 0), len(sv) - 1)
    return float(sv[idx])


_TRAIN_OBJECTIVES: Dict[str, type] = {
    "regression": RegressionL2, "regression_l1": RegressionL1,
    "huber": HuberLoss, "fair": FairLoss, "poisson": PoissonLoss,
    "quantile": QuantileLoss, "mape": MAPELoss, "gamma": GammaLoss,
    "tweedie": TweedieLoss, "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax, "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
}


def register_objective(name: str, cls: type) -> None:
    """Train objective `name` with `cls` (the reference's
    `objectives.py:505`)."""
    _TRAIN_OBJECTIVES[name] = cls


def create_objective(config) -> Optional[TrainObjective]:
    """Training objective of a resolved `Config` (ref:
    `ObjectiveFunction::CreateObjectiveFunction`; the JAX package's
    `objectives.py:509`); "none" and "custom" are None (a custom
    objective's gradients come from the caller's `fobj`); the ranking
    objectives come from `rank_objective.py`."""
    name = config.objective
    if name in ("custom", "none", None):
        return None
    if name not in _TRAIN_OBJECTIVES:
        from . import rank_objective
        _TRAIN_OBJECTIVES.setdefault("lambdarank",
                                     rank_objective.LambdarankNDCG)
        _TRAIN_OBJECTIVES.setdefault("rank_xendcg",
                                     rank_objective.RankXENDCG)
    if name not in _TRAIN_OBJECTIVES:
        raise LightGBMError(f"Unknown objective: {name}")
    return _TRAIN_OBJECTIVES[name](config)
