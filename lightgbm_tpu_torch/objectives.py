"""Objective functions on torch tensors: output links and, for the
training slice, gradients.

The port's counterpart of `lightgbm_tpu/objectives.py`.  Two halves:

* loading: `parse_objective` reads a model text's `objective=` line into
  an `Objective`, whose `convert_output` is the link (ref:
  objective_function.h `ConvertOutput`) for every objective;
* training: `create_objective(config)` builds `RegressionL2`,
  `BinaryLogloss` or `MulticlassSoftmax` with `init_meta`,
  `boost_from_score` (host numpy, f64, as the reference) and
  `grad_hess` (f32 torch, on whatever device the score lies, in the
  reference's op order).  Any other objective raises with the reason.

`convert_output` takes the f32 raw scores (the round-to-nearest-even
downcast of the exact f64 sums) and applies the link in f32.  Sigmoid,
softmax and exp, in the links and in `grad_hess`, are XLA's CPU
arithmetic bit for bit (`ops/xla_math.py`), so the same scores give the
reference's bits on the CPU and on the card; `log1p` (in
`cross_entropy_lambda`) may still differ from XLA's by about one ulp,
and the tests state the bound.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .ops.xla_math import xla_exp_f32, xla_sigmoid, xla_softmax
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
            return torch.log1p(xla_exp_f32(score))
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

    def __init__(self, config):
        self.config = config

    def init_meta(self, label: np.ndarray,
                  weight: Optional[np.ndarray]) -> None:
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
        return self.name


class RegressionL2(TrainObjective):
    """ref: regression_objective.hpp `RegressionL2loss` (the JAX
    package's `objectives.py:86`)."""
    name = "regression"

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

    def init_meta(self, label, weight):
        super().init_meta(label, weight)
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

    def init_meta(self, label, weight):
        super().init_meta(label, weight)
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


_TRAIN_OBJECTIVES = {"regression": RegressionL2, "binary": BinaryLogloss,
                     "multiclass": MulticlassSoftmax}


def create_objective(config) -> Optional[TrainObjective]:
    """Training objective of a resolved `Config` (ref:
    `ObjectiveFunction::CreateObjectiveFunction`; the JAX package's
    `objectives.py:509`).  This slice trains `regression` (L2),
    `binary` and `multiclass`; "none" and "custom" are None (a custom
    objective's gradients come from the caller's `fobj`); every other
    objective raises."""
    name = config.objective
    if name in ("custom", "none", None):
        return None
    if name not in _TRAIN_OBJECTIVES:
        raise LightGBMError(
            f"objective {name!r} is not ported yet: this slice trains "
            "regression (L2), binary and multiclass (ROADMAP Queue 1 "
            "item 5)")
    return _TRAIN_OBJECTIVES[name](config)
