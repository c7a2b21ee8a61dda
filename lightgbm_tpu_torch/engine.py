"""Training engine: `train()`.

The port's counterpart of `lightgbm_tpu/engine.py:28 train` (API of
python-package/lightgbm/engine.py `train`): the host boosting loop, one
`Booster.update` per iteration, then evaluation and callbacks, with
early stopping through `EarlyStopException`.  `cv`, `init_model` and
`feval` wait for later slices and raise.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

from . import callback as callback_mod
from .basic import Dataset
from .booster import CONTINUED, Booster
from .utils.config import Config, canonical_param_name
from .utils.log import LightGBMError

__all__ = ["train"]


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          feval=None, init_model=None,
          callbacks: Optional[List] = None) -> Booster:
    """Train one model (ref: engine.py `train`).  Trains on the card
    unless `params` say `device_type="cpu"`."""
    if init_model is not None:
        raise LightGBMError("init_model (continued training) is not "
                            f"ported yet ({CONTINUED})")
    if feval is not None:
        raise LightGBMError(f"feval is not ported yet ({CONTINUED})")
    if not isinstance(train_set, Dataset):
        raise TypeError("train() only accepts a lightgbm_tpu_torch Dataset, "
                        f"got {type(train_set).__name__}")
    params = copy.deepcopy(params) if params else {}
    # num_boost_round aliases in params win (reference behaviour)
    for key in list(params.keys()):
        if canonical_param_name(key) == "num_iterations" and \
                params[key] is not None:
            num_boost_round = int(params.pop(key))
    params["num_iterations"] = num_boost_round
    first_metric_only = bool(params.get("first_metric_only", False))

    booster = Booster(params=params, train_set=train_set)
    booster._train_data_name = "training"
    valid_sets = valid_sets or []
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    valid_names = valid_names or []
    train_in_valid = False
    for i, vs in enumerate(valid_sets):
        if vs is train_set:
            booster._train_data_name = (valid_names[i]
                                        if i < len(valid_names)
                                        else "training")
            train_in_valid = True
            continue
        name = valid_names[i] if i < len(valid_names) else f"valid_{i}"
        if vs.reference is None:
            vs.reference = train_set
        booster.add_valid(vs, name)

    callbacks = list(callbacks) if callbacks else []
    es_round = Config(params).early_stopping_round
    if es_round and es_round > 0 and not any(
            getattr(cb, "order", None) == 30 for cb in callbacks):
        callbacks.append(callback_mod.early_stopping(
            es_round, first_metric_only=first_metric_only))
    callbacks.sort(key=lambda cb: getattr(cb, "order", 0))
    want_train_eval = train_in_valid or any(
        params.get(alias) for alias in ("is_provide_training_metric",
                                        "training_metric",
                                        "is_training_metric",
                                        "train_metric"))

    begin = booster.current_iteration()
    end = begin + num_boost_round
    results: List = []
    for i in range(begin, end):
        booster.update()
        results = []
        if want_train_eval:
            results.extend(booster.eval_train())
        results.extend(booster.eval_valid())
        try:
            for cb in callbacks:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=begin, end_iteration=end,
                    evaluation_result_list=results))
        except callback_mod.EarlyStopException as es:
            booster.best_iteration = es.best_iteration + 1
            results = es.best_score
            break
    booster.best_score = {}
    for item in results:
        booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
    return booster
