"""scikit-learn estimator API.

Counterpart of lightgbm_tpu/sklearn.py (the reference's
python-package/lightgbm/sklearn.py): `LGBMModel` with `LGBMRegressor`,
`LGBMClassifier` and `LGBMRanker`. Callables pass straight through to
engine.train's fobj / feval. The estimators train through `train`, on the
card by default (pass ``device_type="cpu"`` for the CPU).

Without scikit-learn (the card's machine has none) the estimators keep
working on fallbacks of their own: a plain base class whose `get_params`
reads the constructor's parameters, a label encoder (sorted classes from
``np.unique``, codes from ``np.searchsorted``: scikit-learn's
LabelEncoder on the same labels) and `class_weight` by scikit-learn's
rule ("balanced": n_samples / (n_classes * count of the class); a dict:
the class's weight, 1 for others).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from .basic import Booster, Dataset
from .callback import record_evaluation
from .engine import train as engine_train

try:
    from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
    from sklearn.preprocessing import LabelEncoder
    _SKLEARN = True
except ImportError:
    _SKLEARN = False

    class BaseEstimator:  # type: ignore[no-redef]
        pass

    class ClassifierMixin:  # type: ignore[no-redef]
        pass

    class RegressorMixin:  # type: ignore[no-redef]
        pass


class _LabelEncoder:
    """scikit-learn's LabelEncoder where it is missing: `classes_` the
    sorted distinct labels, codes their positions."""

    def fit(self, y) -> "_LabelEncoder":
        self.classes_ = np.unique(np.asarray(y))
        return self

    def transform(self, y) -> np.ndarray:
        y = np.asarray(y)
        idx = np.searchsorted(self.classes_, y)
        ok = (idx < len(self.classes_)) & (
            self.classes_[np.minimum(idx, len(self.classes_) - 1)] == y)
        if not np.all(ok):
            raise ValueError(f"y contains previously unseen labels: "
                             f"{np.unique(y[~ok]).tolist()}")
        return idx.astype(np.int64)


def _label_encoder():
    return LabelEncoder() if _SKLEARN else _LabelEncoder()


def _class_sample_weight(class_weight, y) -> np.ndarray:
    """Per-sample weights of `class_weight` ("balanced" or {class:
    weight}), scikit-learn's compute_sample_weight where it is present."""
    if _SKLEARN:
        from sklearn.utils.class_weight import compute_sample_weight
        return compute_sample_weight(class_weight, y)
    y = np.asarray(y)
    classes, codes = np.unique(y, return_inverse=True)
    if class_weight == "balanced":
        w = len(y) / (len(classes) * np.bincount(codes))
    else:
        w = np.asarray([float(class_weight.get(c, 1.0)) for c in classes])
    return w[codes].astype(np.float64)


class LGBMModel(BaseEstimator):
    """Base sklearn estimator (reference: sklearn.py LGBMModel:414)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[Union[str, Callable]] = None,
                 class_weight=None, min_split_gain: float = 0.0,
                 min_child_weight: float = 1e-3, min_child_samples: int = 20,
                 subsample: float = 1.0, subsample_freq: int = 0,
                 colsample_bytree: float = 1.0, reg_alpha: float = 0.0,
                 reg_lambda: float = 0.0, random_state=None,
                 n_jobs: Optional[int] = None, importance_type: str = "split",
                 **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
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
        self._other_params: Dict[str, Any] = dict(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_iteration = -1
        self._best_score: Dict = {}
        self._n_features = -1
        self._objective = objective
        self._class_map = None

    # -- sklearn plumbing --------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        if _SKLEARN:
            params = super().get_params(deep=deep)
        else:
            params = {k: getattr(self, k) for k in self._base_param_names()}
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for k, v in params.items():
            setattr(self, k, v)
            if k not in self._base_param_names():
                self._other_params[k] = v
        return self

    @classmethod
    def _base_param_names(cls) -> List[str]:
        return ["boosting_type", "num_leaves", "max_depth", "learning_rate",
                "n_estimators", "subsample_for_bin", "objective",
                "class_weight", "min_split_gain", "min_child_weight",
                "min_child_samples", "subsample", "subsample_freq",
                "colsample_bytree", "reg_alpha", "reg_lambda", "random_state",
                "n_jobs", "importance_type"]

    def _make_params(self) -> Dict[str, Any]:
        params = {
            "boosting": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "bin_construct_sample_cnt": self.subsample_for_bin,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "verbosity": -1,
        }
        if isinstance(self.objective, str):
            params["objective"] = self.objective
        if self.random_state is not None:
            params["seed"] = (self.random_state
                              if isinstance(self.random_state, int)
                              else 0)
        params.update(self._other_params)
        return params

    # -- training -----------------------------------------------------
    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            feature_name="auto", categorical_feature="auto",
            callbacks=None, init_model=None) -> "LGBMModel":
        params = self._make_params()
        fobj = self.objective if callable(self.objective) else None
        if fobj is not None:
            params["objective"] = "none"
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric
        feval = eval_metric if callable(eval_metric) else None

        X = np.asarray(X)
        y = np.asarray(y).reshape(-1)
        self._n_features = X.shape[1]
        y_tr = self._process_label(y, params)

        # class_weight -> per-sample weights (reference: sklearn.py
        # _LGBMComputeSampleWeight in LGBMClassifier.fit)
        if self.class_weight is not None:
            cw = _class_sample_weight(self.class_weight, y)
            sample_weight = cw if sample_weight is None \
                else np.asarray(sample_weight, np.float64) * cw

        train_set = Dataset(X, label=y_tr, weight=sample_weight,
                            init_score=init_score, group=group,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            params=params)
        valid_sets, valid_names = [], []
        if eval_set:
            for i, (vX, vy) in enumerate(eval_set):
                vw = eval_sample_weight[i] if eval_sample_weight else None
                vs = eval_init_score[i] if eval_init_score else None
                vg = eval_group[i] if eval_group else None
                vy_tr = self._process_label(np.asarray(vy).reshape(-1),
                                            params, fit=False)
                valid_sets.append(train_set.create_valid(
                    np.asarray(vX), label=vy_tr, weight=vw, init_score=vs,
                    group=vg))
                valid_names.append(
                    eval_names[i] if eval_names else f"valid_{i}")

        callbacks = list(callbacks) if callbacks else []
        self._evals_result = {}
        if valid_sets:
            callbacks.append(record_evaluation(self._evals_result))

        self._Booster = engine_train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets, valid_names=valid_names,
            feval=feval, fobj=fobj, callbacks=callbacks,
            init_model=init_model)
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        return self

    def _process_label(self, y, params, fit: bool = True):
        return y

    # -- inference ----------------------------------------------------
    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        if self._Booster is None:
            raise ValueError("Estimator not fitted, call fit first")
        return self._Booster.predict(
            np.asarray(X), raw_score=raw_score,
            start_iteration=start_iteration, num_iteration=num_iteration,
            pred_leaf=pred_leaf, pred_contrib=pred_contrib)

    # -- attributes ----------------------------------------------------
    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise ValueError("No booster found, call fit first")
        return self._Booster

    @property
    def evals_result_(self) -> Dict:
        return self._evals_result

    @property
    def best_iteration_(self) -> int:
        return self._best_iteration

    @property
    def best_score_(self) -> Dict:
        return self._best_score

    @property
    def n_features_(self) -> int:
        return self._n_features

    @property
    def n_features_in_(self) -> int:
        return self._n_features

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance(
            importance_type=self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        return self.booster_.feature_name()


_SUBCLASS_INIT_DOC = """sklearn requires subclasses to redeclare the FULL
parameter list (BaseEstimator.get_params introspects the subclass __init__
signature; missing names would be silently dropped by clone/GridSearchCV —
the reference sklearn.py does the same)."""


class LGBMRegressor(RegressorMixin, LGBMModel):
    """reference: sklearn.py LGBMRegressor."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[Union[str, Callable]] = None,
                 class_weight=None, min_split_gain: float = 0.0,
                 min_child_weight: float = 1e-3, min_child_samples: int = 20,
                 subsample: float = 1.0, subsample_freq: int = 0,
                 colsample_bytree: float = 1.0, reg_alpha: float = 0.0,
                 reg_lambda: float = 0.0, random_state=None,
                 n_jobs: Optional[int] = None, importance_type: str = "split",
                 **kwargs):
        super().__init__(
            boosting_type=boosting_type, num_leaves=num_leaves,
            max_depth=max_depth, learning_rate=learning_rate,
            n_estimators=n_estimators, subsample_for_bin=subsample_for_bin,
            objective=objective, class_weight=class_weight,
            min_split_gain=min_split_gain, min_child_weight=min_child_weight,
            min_child_samples=min_child_samples, subsample=subsample,
            subsample_freq=subsample_freq, colsample_bytree=colsample_bytree,
            reg_alpha=reg_alpha, reg_lambda=reg_lambda,
            random_state=random_state, n_jobs=n_jobs,
            importance_type=importance_type, **kwargs)

    __init__.__doc__ = _SUBCLASS_INIT_DOC

    def _make_params(self):
        params = super()._make_params()
        params.setdefault("objective", "regression")
        return params


class LGBMClassifier(ClassifierMixin, LGBMModel):
    """reference: sklearn.py LGBMClassifier."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[Union[str, Callable]] = None,
                 class_weight=None, min_split_gain: float = 0.0,
                 min_child_weight: float = 1e-3, min_child_samples: int = 20,
                 subsample: float = 1.0, subsample_freq: int = 0,
                 colsample_bytree: float = 1.0, reg_alpha: float = 0.0,
                 reg_lambda: float = 0.0, random_state=None,
                 n_jobs: Optional[int] = None, importance_type: str = "split",
                 **kwargs):
        super().__init__(
            boosting_type=boosting_type, num_leaves=num_leaves,
            max_depth=max_depth, learning_rate=learning_rate,
            n_estimators=n_estimators, subsample_for_bin=subsample_for_bin,
            objective=objective, class_weight=class_weight,
            min_split_gain=min_split_gain, min_child_weight=min_child_weight,
            min_child_samples=min_child_samples, subsample=subsample,
            subsample_freq=subsample_freq, colsample_bytree=colsample_bytree,
            reg_alpha=reg_alpha, reg_lambda=reg_lambda,
            random_state=random_state, n_jobs=n_jobs,
            importance_type=importance_type, **kwargs)

    __init__.__doc__ = _SUBCLASS_INIT_DOC

    def _process_label(self, y, params, fit: bool = True):
        if fit:
            self._le = _label_encoder().fit(y)
            self._classes = self._le.classes_
            self._n_classes = len(self._classes)
            if self._n_classes > 2:
                params.setdefault("objective", "multiclass")
                params["num_class"] = self._n_classes
            else:
                params.setdefault("objective", "binary")
        return self._le.transform(y).astype(np.float64)

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        result = self.predict_proba(X, raw_score, start_iteration,
                                    num_iteration, pred_leaf, pred_contrib,
                                    **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim > 1:
            idx = np.argmax(result, axis=1)
        else:
            idx = (result > 0.5).astype(int)
        return self._classes[idx]

    def predict_proba(self, X, raw_score: bool = False,
                      start_iteration: int = 0,
                      num_iteration: Optional[int] = None,
                      pred_leaf: bool = False, pred_contrib: bool = False,
                      **kwargs):
        result = super().predict(X, raw_score, start_iteration,
                                 num_iteration, pred_leaf, pred_contrib,
                                 **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim == 1:
            return np.vstack([1.0 - result, result]).T
        return result

    @property
    def classes_(self) -> np.ndarray:
        return self._classes

    @property
    def n_classes_(self) -> int:
        return self._n_classes


class LGBMRanker(LGBMModel):
    """reference: sklearn.py LGBMRanker."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[Union[str, Callable]] = None,
                 class_weight=None, min_split_gain: float = 0.0,
                 min_child_weight: float = 1e-3, min_child_samples: int = 20,
                 subsample: float = 1.0, subsample_freq: int = 0,
                 colsample_bytree: float = 1.0, reg_alpha: float = 0.0,
                 reg_lambda: float = 0.0, random_state=None,
                 n_jobs: Optional[int] = None, importance_type: str = "split",
                 **kwargs):
        super().__init__(
            boosting_type=boosting_type, num_leaves=num_leaves,
            max_depth=max_depth, learning_rate=learning_rate,
            n_estimators=n_estimators, subsample_for_bin=subsample_for_bin,
            objective=objective, class_weight=class_weight,
            min_split_gain=min_split_gain, min_child_weight=min_child_weight,
            min_child_samples=min_child_samples, subsample=subsample,
            subsample_freq=subsample_freq, colsample_bytree=colsample_bytree,
            reg_alpha=reg_alpha, reg_lambda=reg_lambda,
            random_state=random_state, n_jobs=n_jobs,
            importance_type=importance_type, **kwargs)

    __init__.__doc__ = _SUBCLASS_INIT_DOC

    def _make_params(self):
        params = super()._make_params()
        params.setdefault("objective", "lambdarank")
        return params

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        if kwargs.get("eval_set") is not None \
                and kwargs.get("eval_group") is None:
            raise ValueError("Eval_group cannot be None when eval_set is not "
                             "None")
        return super().fit(X, y, sample_weight=sample_weight,
                           init_score=init_score, group=group, **kwargs)
