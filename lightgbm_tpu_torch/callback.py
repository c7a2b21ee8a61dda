"""Training callbacks (API parity: python-package/lightgbm/callback.py).

A copy of the JAX package's `callback.py`: `CallbackEnv`,
`early_stopping`, `log_evaluation`, `record_evaluation` and
`reset_parameter`, with the reference's best_iter / best_score
bookkeeping and its `before_iteration` flag (the engine runs those
callbacks before each update).
"""
from __future__ import annotations

import collections
from functools import partial
from typing import Callable, Dict, List, Union

from .utils import log

__all__ = ["EarlyStopException", "CallbackEnv", "early_stopping",
           "log_evaluation", "record_evaluation", "reset_parameter"]


class EarlyStopException(Exception):
    """ref: callback.py `EarlyStopException`."""

    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """ref: callback.py `log_evaluation`."""

    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(_format_eval_result(x, show_stdv)
                               for x in env.evaluation_result_list)
            log.info(f"[{env.iteration + 1}]\t{result}")

    _callback.order = 10  # type: ignore
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]) -> Callable:
    """ref: callback.py `record_evaluation`."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list:
            data_name, eval_name = item[0], item[1]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for item in env.evaluation_result_list:
            data_name, eval_name, result = item[0], item[1], item[2]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])
            eval_result[data_name][eval_name].append(result)

    _callback.order = 20  # type: ignore
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """ref: callback.py `reset_parameter`: a parameter schedule, each
    value a list indexed by the round (its length the number of rounds)
    or a callable of the round; a change calls
    `env.model.reset_parameter` before the round's update."""

    def _callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"Length of list {key!r} has to equal to "
                        f"'num_boost_round'.")
                new_param = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_param = value(env.iteration - env.begin_iteration)
            else:
                raise ValueError("Only list and callable values are "
                                 "supported as a mapping from boosting round "
                                 "index to new parameter value.")
            if new_param != env.params.get(key, None):
                new_parameters[key] = new_param
        if new_parameters:
            if env.model is not None:
                env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)

    _callback.before_iteration = True  # type: ignore
    _callback.order = 10  # type: ignore
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True,
                   min_delta: Union[float, List[float]] = 0.0) -> Callable:
    """ref: callback.py `early_stopping` (incl. min_delta semantics)."""
    if not isinstance(stopping_rounds, int) or stopping_rounds <= 0:
        raise ValueError("stopping_rounds should be an integer and greater "
                         "than 0")
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List = []
    cmp_op: List[Callable] = []
    enabled = [True]
    first_metric = [""]

    def _init(env: CallbackEnv) -> None:
        enabled[0] = not any(env.params.get(alias, "") == "dart"
                             for alias in ("boosting", "boosting_type",
                                           "boost"))
        if not enabled[0]:
            log.warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric is "
                "required for evaluation")
        if verbose:
            log.info(f"Training until validation scores don't improve for "
                     f"{stopping_rounds} rounds")
        n_metrics = len({m[1] for m in env.evaluation_result_list})
        n_datasets = len(env.evaluation_result_list) // max(n_metrics, 1)
        if isinstance(min_delta, list):
            deltas = min_delta * n_datasets
        else:
            deltas = [min_delta] * n_datasets * n_metrics
        first_metric[0] = env.evaluation_result_list[0][1].split(" ")[-1]
        for eval_ret, delta in zip(env.evaluation_result_list, deltas):
            best_iter.append(0)
            best_score_list.append(None)
            if eval_ret[3]:  # higher better
                best_score.append(float("-inf"))
                cmp_op.append(partial(_gt_delta, delta=delta))
            else:
                best_score.append(float("inf"))
                cmp_op.append(partial(_lt_delta, delta=delta))

    def _gt_delta(curr, best, delta):
        return curr > best + delta

    def _lt_delta(curr, best, delta):
        return curr < best - delta

    def _final_iteration_check(env, eval_name_splitted, i):
        if env.iteration == env.end_iteration - 1:
            if verbose:
                best = "\t".join(_format_eval_result(x)
                                 for x in best_score_list[i])
                log.info("Did not meet early stopping. Best iteration is:"
                         f"\n[{best_iter[i] + 1}]\t{best}")
                if first_metric_only:
                    log.info(f"Evaluated only: {eval_name_splitted[-1]}")
            raise EarlyStopException(best_iter[i], best_score_list[i])

    def _callback(env: CallbackEnv) -> None:
        if not best_score:
            _init(env)
        if not enabled[0]:
            return
        for i in range(len(env.evaluation_result_list)):
            score = env.evaluation_result_list[i][2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            eval_name_splitted = env.evaluation_result_list[i][1].split(" ")
            if first_metric_only and first_metric[0] != eval_name_splitted[-1]:
                continue
            if env.evaluation_result_list[i][0] == "cv_agg" and \
                    eval_name_splitted[0] == "train":
                continue
            if env.model is not None and \
                    env.evaluation_result_list[i][0] == \
                    getattr(env.model, "_train_data_name", "training"):
                _final_iteration_check(env, eval_name_splitted, i)
                continue
            elif env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    best = "\t".join(_format_eval_result(x)
                                     for x in best_score_list[i])
                    log.info(f"Early stopping, best iteration is:"
                             f"\n[{best_iter[i] + 1}]\t{best}")
                    if first_metric_only:
                        log.info(f"Evaluated only: {eval_name_splitted[-1]}")
                raise EarlyStopException(best_iter[i], best_score_list[i])
            _final_iteration_check(env, eval_name_splitted, i)

    _callback.order = 30  # type: ignore
    return _callback
