"""Objective output transforms on torch tensors.

The port's counterpart of `lightgbm_tpu/objectives.py`, reduced to what a
model-loading booster needs: parsing the model text's `objective=` line
and `ObjectiveFunction.convert_output` (ref: objective_function.h
`ConvertOutput`).  Gradients and hessians arrive with the training
slice.

`convert_output` takes the f32 raw scores (the round-to-nearest-even
downcast of the exact f64 sums) and applies the link in f32, on
whatever device the tensor lies.  Transcendentals (sigmoid, softmax,
exp) may differ from XLA's by about one ulp; the tests state the bound.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

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
            return torch.exp(score)
        if n in ("binary", "multiclassova"):
            return torch.sigmoid(self.sigmoid * score)
        if n == "multiclass":
            return torch.softmax(score, dim=-1)
        if n == "cross_entropy":
            return torch.sigmoid(score)
        if n == "cross_entropy_lambda":
            return torch.log1p(torch.exp(score))
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
