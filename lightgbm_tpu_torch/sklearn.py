"""scikit-learn estimators: `LGBMModel`, `LGBMRegressor`,
`LGBMClassifier`.

The port's counterpart of `lightgbm_tpu/sklearn.py` (API of
python-package/lightgbm/sklearn.py): thin adapters from the estimator
contract onto `engine.train`, with the reference's label encoding,
eval-set plumbing and `eval_metric` wrappers.  They train on the card
unless `device_type="cpu"` is given.  Without scikit-learn installed
the estimators keep working on plain base classes (the reference's
`sklearn.py:20-31`).  A callable `objective(y_true, y_pred[, weight[,
group]])` trains as the booster's custom objective
(`_ObjectiveFunctionWrapper`); the classifier then returns raw scores.
`LGBMRanker` trains lambdarank with query groups.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import callback as callback_mod
from .basic import Dataset
from .booster import Booster, _to_2d_float
from .engine import train as engine_train
from .utils.log import LightGBMError

try:
    from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
    _SKLEARN = True
except ImportError:
    BaseEstimator = object

    class ClassifierMixin:
        pass

    class RegressorMixin:
        pass
    _SKLEARN = False

__all__ = ["LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker"]


class _ObjectiveFunctionWrapper:
    """An sklearn-style `func(y_true, y_pred[, weight[, group]])` as the
    engine's `fobj(preds, dataset)` (ref: sklearn.py
    `_ObjectiveFunctionWrapper`)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset: Dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        if argc == 4:
            return self.func(labels, preds, dataset.get_weight(),
                             dataset.get_group())
        raise TypeError(f"Self-defined objective should have 2-4 arguments, "
                        f"got {argc}")


class _EvalFunctionWrapper:
    """An sklearn-style `func(y_true, y_pred[, weight[, group]])` as the
    engine's `feval(preds, dataset)` (ref: sklearn.py
    `_EvalFunctionWrapper`)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset: Dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        if argc == 4:
            return self.func(labels, preds, dataset.get_weight(),
                             dataset.get_group())
        raise TypeError(f"Self-defined eval function should have 2-4 "
                        f"arguments, got {argc}")


class LGBMModel(BaseEstimator):
    """Base estimator (ref: sklearn.py `LGBMModel`)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[Union[str, Callable]] = None,
                 class_weight=None, min_split_gain: float = 0.0,
                 min_child_weight: float = 1e-3, min_child_samples: int = 20,
                 subsample: float = 1.0, subsample_freq: int = 0,
                 colsample_bytree: float = 1.0, reg_alpha: float = 0.0,
                 reg_lambda: float = 0.0, random_state=None,
                 n_jobs: Optional[int] = None,
                 importance_type: str = "split", **kwargs):
        self.boosting_type = boosting_type
        self.objective = objective
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self.class_weight = class_weight
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_score: Dict = {}
        self._best_iteration = -1
        self._other_params: Dict[str, Any] = {}
        self._objective = objective
        self.fitted_ = False
        self._n_features = -1
        self._n_classes = -1
        self.set_params(**kwargs)

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = super().get_params(deep=deep) if _SKLEARN else {}
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            setattr(self, key, value)
            if hasattr(self, f"_{key}"):
                setattr(self, f"_{key}", value)
            self._other_params[key] = value
        return self

    def _process_params(self) -> Dict[str, Any]:
        """The estimator's parameters as `train` params (ref: sklearn.py
        `_process_params`); a callable objective becomes "none" here and
        the wrapped `fobj` at `fit`."""
        params = self.get_params()
        for key in ("objective", "importance_type", "class_weight",
                    "n_jobs", "n_estimators"):
            params.pop(key, None)
        for key in ("num_leaves", "max_depth", "learning_rate",
                    "boosting_type", "min_split_gain", "min_child_weight",
                    "min_child_samples", "subsample", "subsample_freq",
                    "colsample_bytree", "reg_alpha", "reg_lambda",
                    "subsample_for_bin"):
            params[key] = getattr(self, key)
        if self.random_state is not None:
            params["random_state"] = self.random_state
        self._fobj = None
        if callable(self._objective):
            self._fobj = _ObjectiveFunctionWrapper(self._objective)
            params["objective"] = "none"
        elif self._objective is not None:
            params["objective"] = self._objective
        return params

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None, eval_group=None,
            eval_metric=None, feature_name="auto",
            categorical_feature="auto", callbacks=None,
            init_model=None) -> "LGBMModel":
        """ref: sklearn.py `LGBMModel.fit`: one `Dataset` from X and y
        (labels encoded by `_process_label`), each `eval_set` pair a
        validation set (the pair (X, y) itself the training set), string
        `eval_metric`s as the `metric` param and callables as `feval`,
        then `train` for `n_estimators` rounds."""
        params = self._process_params()
        if self._objective is None:
            params.setdefault("objective", self._default_objective())
        feval = None
        if eval_metric is not None:
            metrics = eval_metric if isinstance(eval_metric, list) \
                else [eval_metric]
            str_metrics = [m for m in metrics if isinstance(m, str)]
            fn_metrics = [m for m in metrics if callable(m)]
            if str_metrics:
                params["metric"] = str_metrics
            if fn_metrics:
                feval = [_EvalFunctionWrapper(f) for f in fn_metrics]
        y_processed = self._process_label(np.asarray(y))
        if self.class_weight is not None and sample_weight is None:
            sample_weight = self._class_weights(y_processed)
        train_set = Dataset(X, label=y_processed, weight=sample_weight,
                            group=group, init_score=init_score,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            params=params)
        valid_sets: List[Dataset] = []
        valid_names: List[str] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                else:
                    vw = eval_sample_weight[i] if eval_sample_weight else None
                    vi = eval_init_score[i] if eval_init_score else None
                    vg = eval_group[i] if eval_group else None
                    valid_sets.append(train_set.create_valid(
                        vx, label=self._process_label(np.asarray(vy)),
                        weight=vw, group=vg, init_score=vi))
                valid_names.append(eval_names[i] if eval_names and
                                   i < len(eval_names) else f"valid_{i}")
        self._evals_result = {}
        callbacks = list(callbacks) if callbacks else []
        if valid_sets:
            callbacks.append(callback_mod.record_evaluation(
                self._evals_result))
        if self._fobj is not None:
            params["objective"] = self._fobj
        self._Booster = engine_train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, valid_names=valid_names or None,
            feval=feval, callbacks=callbacks, init_model=init_model)
        self._n_features = self._Booster.num_feature()
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        self.fitted_ = True
        return self

    def _default_objective(self) -> str:
        return "regression"

    def _process_label(self, y: np.ndarray) -> np.ndarray:
        return y.astype(np.float64).reshape(-1)

    def _class_weights(self, y) -> Optional[np.ndarray]:
        from sklearn.utils.class_weight import compute_sample_weight
        return compute_sample_weight(self.class_weight, y)

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        self._check_fitted()
        X2 = _to_2d_float(X)
        if X2.shape[1] != self._n_features:
            raise ValueError(
                f"Number of features of the model must match the input. "
                f"Model n_features_ is {self._n_features} and input "
                f"n_features is {X2.shape[1]}")
        return self._Booster.predict(
            X2, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib, **kwargs)

    def _check_fitted(self):
        if not self.fitted_:
            raise LightGBMError(
                "Estimator not fitted, call fit before exploiting the model.")

    @property
    def n_features_(self) -> int:
        self._check_fitted()
        return self._n_features

    @property
    def n_features_in_(self) -> int:
        self._check_fitted()
        return self._n_features

    @property
    def best_score_(self) -> Dict:
        self._check_fitted()
        return self._best_score

    @property
    def best_iteration_(self) -> int:
        self._check_fitted()
        return self._best_iteration

    @property
    def objective_(self):
        self._check_fitted()
        return self._objective if self._objective is not None \
            else self._default_objective()

    @property
    def booster_(self) -> Booster:
        self._check_fitted()
        return self._Booster

    @property
    def evals_result_(self) -> Dict:
        self._check_fitted()
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        self._check_fitted()
        return self._Booster.feature_importance(
            importance_type=self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        self._check_fitted()
        return self._Booster.feature_name()

    @property
    def feature_names_in_(self) -> np.ndarray:
        self._check_fitted()
        return np.asarray(self._Booster.feature_name(), dtype=object)

    @property
    def n_estimators_(self) -> int:
        """Rounds trained (early stopping may stop short of
        n_estimators)."""
        self._check_fitted()
        return self._Booster.current_iteration()

    @property
    def n_iter_(self) -> int:
        self._check_fitted()
        return self._Booster.current_iteration()


class LGBMRegressor(RegressorMixin, LGBMModel):
    """ref: sklearn.py `LGBMRegressor`."""

    def _default_objective(self) -> str:
        return "regression"


class LGBMClassifier(ClassifierMixin, LGBMModel):
    """ref: sklearn.py `LGBMClassifier`: labels encoded as their index in
    the sorted `classes_`; binary for two classes, multiclass past."""

    def _default_objective(self) -> str:
        return "binary" if self._n_classes <= 2 else "multiclass"

    def fit(self, X, y, **kwargs):
        y_arr = np.asarray(y).reshape(-1)
        self._classes = np.unique(y_arr)
        self._n_classes = len(self._classes)
        self._class_map = {c: i for i, c in enumerate(self._classes)}
        if self._objective is None and self._n_classes > 2:
            self.set_params(num_class=self._n_classes)
        return super().fit(X, y, **kwargs)

    def _process_label(self, y: np.ndarray) -> np.ndarray:
        if not hasattr(self, "_class_map"):
            self._classes = np.unique(y)
            self._n_classes = len(self._classes)
            self._class_map = {c: i for i, c in enumerate(self._classes)}
        return np.asarray([self._class_map[v] for v in y.reshape(-1)],
                          dtype=np.float64)

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        result = self.predict_proba(X, raw_score, start_iteration,
                                    num_iteration, pred_leaf, pred_contrib,
                                    **kwargs)
        if callable(self._objective) or raw_score or pred_leaf \
                or pred_contrib:
            return result
        return self._classes[np.argmax(result, axis=1)]

    def predict_proba(self, X, raw_score: bool = False,
                      start_iteration: int = 0,
                      num_iteration: Optional[int] = None,
                      pred_leaf: bool = False, pred_contrib: bool = False,
                      **kwargs):
        """Class probabilities: `Booster.predict`'s, stacked as [1 - p, p]
        for binary; a custom objective's raw scores as they are."""
        result = LGBMModel.predict(self, X, raw_score, start_iteration,
                                   num_iteration, pred_leaf, pred_contrib,
                                   **kwargs)
        if callable(self._objective) or raw_score or pred_leaf \
                or pred_contrib:
            return result
        if result.ndim == 1:
            return np.vstack([1.0 - result, result]).T
        return result

    @property
    def classes_(self) -> np.ndarray:
        self._check_fitted()
        return self._classes

    @property
    def n_classes_(self) -> int:
        self._check_fitted()
        return self._n_classes


class LGBMRanker(LGBMModel):
    """ref: sklearn.py `LGBMRanker`: lambdarank with query groups (the
    JAX package's `sklearn.py:406`); `eval_at` sets the NDCG and MAP
    cut-offs."""

    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            eval_at=(1, 2, 3, 4, 5), feature_name="auto",
            categorical_feature="auto", callbacks=None,
            init_model=None) -> "LGBMRanker":
        if group is None:
            raise ValueError("Should set group for ranking task")
        if eval_set is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is "
                             "not None")
        self._other_params["eval_at"] = list(eval_at)
        self.set_params(eval_at=list(eval_at))
        return super().fit(X, y, sample_weight=sample_weight,
                           init_score=init_score, group=group,
                           eval_set=eval_set, eval_names=eval_names,
                           eval_sample_weight=eval_sample_weight,
                           eval_init_score=eval_init_score,
                           eval_group=eval_group, eval_metric=eval_metric,
                           feature_name=feature_name,
                           categorical_feature=categorical_feature,
                           callbacks=callbacks, init_model=init_model)
