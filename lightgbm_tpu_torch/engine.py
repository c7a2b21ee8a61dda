"""Training engine: `train()`, `cv()` and `CVBooster`.

The port's counterpart of `lightgbm_tpu/engine.py` (API of
python-package/lightgbm/engine.py `train`, `cv`, `CVBooster`,
`_make_n_folds`): the host boosting loop, one `Booster.update` per
iteration with the `before_iteration` callbacks (`reset_parameter`)
before it, then evaluation (metrics and `feval`) and the other
callbacks, with early stopping through `EarlyStopException`.
`init_model` continues from a booster or a model file (`_continue_from`).
The reference's pipelined chunk path (`dispatch_chunk_eval` and its
kin) overlaps TPU dispatch; its own comment (`engine.py:188-194`) says it
gives the serial schedule's models, which this loop runs.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional, Union

import numpy as np

from . import callback as callback_mod
from .basic import Dataset
from .booster import Booster
from .ops.grow import to_device
from .utils.config import Config, canonical_param_name
from .utils.log import LightGBMError

__all__ = ["train", "cv", "CVBooster"]


def _pop_num_rounds(params: Dict[str, Any], num_boost_round: int) -> int:
    """num_boost_round aliases in params win (reference behaviour)."""
    for key in list(params.keys()):
        if canonical_param_name(key) == "num_iterations" and \
                params[key] is not None:
            num_boost_round = int(params.pop(key))
    params["num_iterations"] = num_boost_round
    return num_boost_round


def _split_callbacks(callbacks, es_round: int, first_metric_only: bool):
    """The callbacks run before each update (`before_iteration`) and
    after it, each list in `order`; `early_stopping_round` in params adds
    the early-stopping callback unless one is given."""
    callbacks = list(callbacks) if callbacks else []
    if es_round and es_round > 0 and not any(
            getattr(cb, "order", None) == 30 for cb in callbacks):
        callbacks.append(callback_mod.early_stopping(
            es_round, first_metric_only=first_metric_only))
    before = [cb for cb in callbacks
              if getattr(cb, "before_iteration", False)]
    after = [cb for cb in callbacks
             if not getattr(cb, "before_iteration", False)]
    before.sort(key=lambda cb: getattr(cb, "order", 0))
    after.sort(key=lambda cb: getattr(cb, "order", 0))
    return before, after


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          feval=None, init_model: Optional[Union[str, Booster]] = None,
          keep_training_booster: bool = False,
          callbacks: Optional[List] = None) -> Booster:
    """Train one model (ref: engine.py `train`; the JAX package's
    `engine.py:83 _train_impl`).  Trains on the card unless `params`
    say `device_type="cpu"`.  `keep_training_booster` is accepted; the
    booster keeps its data either way."""
    if not isinstance(train_set, Dataset):
        raise TypeError("train() only accepts a lightgbm_tpu_torch Dataset, "
                        f"got {type(train_set).__name__}")
    params = copy.deepcopy(params) if params else {}
    num_boost_round = _pop_num_rounds(params, num_boost_round)
    first_metric_only = bool(params.get("first_metric_only", False))

    predictor = None
    if init_model is not None:
        predictor = init_model if isinstance(init_model, Booster) \
            else Booster(model_file=init_model, params={"verbosity": -1})
    booster = Booster(params=params, train_set=train_set)
    booster._train_data_name = "training"
    if predictor is not None:
        _continue_from(booster, predictor)

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

    before, after = _split_callbacks(
        callbacks, Config(params).early_stopping_round, first_metric_only)
    want_train_eval = train_in_valid or any(
        params.get(alias) for alias in ("is_provide_training_metric",
                                        "training_metric",
                                        "is_training_metric",
                                        "train_metric"))

    begin = booster.current_iteration()
    end = begin + num_boost_round
    results: List = []
    for i in range(begin, end):
        for cb in before:
            cb(callback_mod.CallbackEnv(
                model=booster, params=params, iteration=i,
                begin_iteration=begin, end_iteration=end,
                evaluation_result_list=None))
        booster.update()
        results = []
        if want_train_eval:
            results.extend(booster.eval_train(feval))
        results.extend(booster.eval_valid(feval))
        try:
            for cb in after:
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


def _continue_from(booster: Booster, init_booster: Booster) -> None:
    """Continued training (the JAX package's `engine.py:269`): the init
    model's trees become the booster's first iterations, each with a
    private `threshold_bin` re-derived from the training set's mappers
    (the init booster may still be serving); the train score is the f32
    cast of the init model's raw prediction on the raw data, uploaded
    pinned, or, when the raw data was freed, the trees replayed on the
    bins onto the init-score base.  The folded-in bias of the init
    model's first trees stands for boost_from_average."""
    K = booster.num_tree_per_iteration
    if init_booster.num_model_per_iteration() != K:
        raise LightGBMError("init_model has different num_tree_per_iteration")
    n_feat = booster.train_set.num_feature()
    for t in init_booster.trees:
        ni = t.num_internal()
        if ni and int(np.max(t.split_feature[:ni])) >= n_feat:
            raise LightGBMError(
                "init_model splits on feature "
                f"{int(np.max(t.split_feature[:ni]))} but the training set "
                f"has only {n_feat} features")
    booster.trees = []
    for t in init_booster.trees:
        t2 = copy.copy(t)
        t2.threshold_bin = np.array(t.threshold_bin, copy=True)
        t2.recompute_threshold_bins(booster.train_set.bin_mappers)
        booster.trees.append(t2)
    booster.cur_iter = init_booster.current_iteration()
    booster._boost_from_average_done = True
    booster._export_cache = None
    try:
        raw_data = booster.train_set.get_data()
    except LightGBMError:
        raw_data = None
    if raw_data is None:
        booster._train_score = booster._replay_model(booster._dd)
        return
    raw = init_booster.predict(raw_data, raw_score=True, num_iteration=-1)
    booster._train_score = to_device(np.asarray(raw, dtype=np.float32),
                                     booster.device)


class CVBooster:
    """The boosters of a cross-validation, one a fold (ref: engine.py
    `CVBooster`): a method called on it is called on each booster and
    returns their results as a list."""

    def __init__(self, model_file: Optional[str] = None):
        self.boosters: List[Booster] = []
        self.best_iteration = -1
        if model_file is not None:
            with open(model_file) as f:
                payload = json.load(f)
            self.best_iteration = payload["best_iteration"]
            self.boosters = [Booster(model_str=s) for s in payload["boosters"]]

    def append(self, booster: Booster) -> "CVBooster":
        self.boosters.append(booster)
        return self

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function

    def save_model(self, filename: str) -> "CVBooster":
        """One JSON file: the best iteration and every fold's model text."""
        payload = {"best_iteration": self.best_iteration,
                   "boosters": [b.model_to_string() for b in self.boosters]}
        with open(filename, "w") as f:
            json.dump(payload, f)
        return self


def _make_n_folds(full_data: Dataset, folds, nfold: int, params: Dict,
                  seed: int, stratified: bool, shuffle: bool):
    """(train_idx, test_idx) pairs (ref: engine.py `_make_n_folds`; the
    JAX package's `engine.py:360`): `folds` as a splitter or as index
    pairs (a splitter gets each row's query as its group); else
    stratified by label (rows sorted by label, each class shuffled by
    `RandomState(seed)`, dealt round-robin), by whole queries when the
    set has them (every nfold-th of the optionally shuffled queries), or
    plain (optionally shuffled, every nfold-th row)."""
    full_data.construct()
    num_data = full_data.num_data()
    if folds is not None:
        if not hasattr(folds, "__iter__") and not hasattr(folds, "split"):
            raise AttributeError(
                "folds should be a generator or iterator of (train_idx, "
                "test_idx) tuples or scikit-learn splitter object")
        if hasattr(folds, "split"):
            group_info = full_data.get_group()
            flattened_group = np.zeros(num_data, dtype=np.int64) \
                if group_info is None else np.repeat(
                    np.arange(len(group_info)),
                    repeats=np.asarray(group_info, dtype=np.int64))
            folds = folds.split(X=np.empty(num_data),
                                y=full_data.get_label(),
                                groups=flattened_group)
        return folds
    if stratified:
        label = full_data.get_label()
        rng = np.random.RandomState(seed)
        order = np.argsort(label, kind="mergesort")
        if shuffle:
            for cls in np.unique(label):
                block = np.nonzero(label[order] == cls)[0]
                order[block] = order[block][rng.permutation(len(block))]
        fold_of = np.empty(num_data, dtype=np.int64)
        fold_of[order] = np.arange(num_data) % nfold
        return [(np.nonzero(fold_of != k)[0], np.nonzero(fold_of == k)[0])
                for k in range(nfold)]
    group_sizes = full_data.get_group()
    if group_sizes is not None:
        # whole queries a fold, every nfold-th of the (shuffled) queries
        gidx = np.arange(len(group_sizes))
        if shuffle:
            np.random.RandomState(seed).shuffle(gidx)
        boundaries = np.concatenate([[0], np.cumsum(group_sizes)])
        out = []
        for k in range(nfold):
            mask = np.zeros(num_data, dtype=bool)
            for g in gidx[k::nfold]:
                mask[boundaries[g]:boundaries[g + 1]] = True
            out.append((np.nonzero(~mask)[0], np.nonzero(mask)[0]))
        return out
    idx = np.arange(num_data)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    out = []
    for k in range(nfold):
        test_idx = np.sort(idx[k::nfold])
        train_idx = np.sort(np.setdiff1d(idx, test_idx, assume_unique=True))
        out.append((train_idx, test_idx))
    return out


def _agg_cv_result(raw_results):
    """Mean and standard deviation of each metric over the folds (ref:
    engine.py `_agg_cv_result`)."""
    cvmap: Dict[str, List[float]] = {}
    metric_type: Dict[str, bool] = {}
    for one_result in raw_results:
        for one_line in one_result:
            key = f"{one_line[0]} {one_line[1]}"
            metric_type[key] = one_line[3]
            cvmap.setdefault(key, []).append(one_line[2])
    return [("cv_agg", k, float(np.mean(v)), metric_type[k], float(np.std(v)))
            for k, v in cvmap.items()]


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, feval=None, init_model=None,
       fpreproc=None, seed: int = 0, callbacks=None, eval_train_metric=False,
       return_cvbooster: bool = False) -> Dict[str, List[float]]:
    """Cross-validation (ref: engine.py `cv`; the JAX package's
    `engine.py:443`): one booster a fold on `Dataset.subset` rows, each
    round every fold updated and evaluated on its held-out rows, the
    results aggregated (`_agg_cv_result`) into "<metric>-mean" and
    "-stdv" lists, which early stopping truncates to the best round.
    Trains on the card unless `params` say `device_type="cpu"`;
    `init_model` starts every fold from it (`_continue_from`)."""
    params = copy.deepcopy(params) if params else {}
    num_boost_round = _pop_num_rounds(params, num_boost_round)
    if metrics is not None:
        params["metric"] = metrics
    if stratified and Config(params).objective not in (
            "binary", "multiclass", "multiclassova"):
        stratified = False
    predictor = None
    if init_model is not None:
        predictor = init_model if isinstance(init_model, Booster) \
            else Booster(model_file=init_model, params={"verbosity": -1})

    train_set.construct()
    results: Dict[str, List[float]] = {}
    cvbooster = CVBooster()
    for train_idx, test_idx in _make_n_folds(train_set, folds, nfold, params,
                                             seed, stratified, shuffle):
        tr = train_set.subset(sorted(train_idx))
        te = train_set.subset(sorted(test_idx))
        if fpreproc is not None:
            tr, te, fold_params = fpreproc(tr, te, params.copy())
        else:
            fold_params = params.copy()
        booster = Booster(params=fold_params, train_set=tr)
        if predictor is not None:
            _continue_from(booster, predictor)
        booster._train_data_name = "train"
        booster.add_valid(te, "valid")
        cvbooster.append(booster)

    before, after = _split_callbacks(
        callbacks, Config(params).early_stopping_round, False)
    for i in range(num_boost_round):
        for cb in before:
            cb(callback_mod.CallbackEnv(
                model=cvbooster, params=params, iteration=i,
                begin_iteration=0, end_iteration=num_boost_round,
                evaluation_result_list=None))
        fold_results = []
        for booster in cvbooster.boosters:
            booster.update()
            one = []
            if eval_train_metric:
                one.extend(booster.eval_train(feval))
            one.extend(booster.eval_valid(feval))
            fold_results.append(one)
        res = _agg_cv_result(fold_results)
        for _, key, mean, _, std in res:
            results.setdefault(f"{key}-mean", []).append(mean)
            results.setdefault(f"{key}-stdv", []).append(std)
        try:
            for cb in after:
                cb(callback_mod.CallbackEnv(
                    model=cvbooster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=res))
        except callback_mod.EarlyStopException as es:
            cvbooster.best_iteration = es.best_iteration + 1
            for bst in cvbooster.boosters:
                bst.best_iteration = cvbooster.best_iteration
            for k in results:
                results[k] = results[k][:cvbooster.best_iteration]
            break
    if return_cvbooster:
        results["cvbooster"] = cvbooster  # type: ignore
    return results
