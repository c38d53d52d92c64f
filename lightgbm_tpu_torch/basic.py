"""Dataset and Booster: the user-facing classes.

Counterpart of lightgbm_tpu/basic.py (the reference python package's
basic.py: Dataset:1692, Booster:3495). Dataset keeps the lazy-construction
semantics: raw data is held until `construct()` bins it, against an
optional reference dataset so validation bins align. The binned matrix
goes to the device named by the `device_type` parameter ("cuda" by
default, "cpu" on request).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional, Union

import numpy as np

from .config import resolve_params
from .data.dataset import BinnedDataset, construct_from_matrix
from .metrics import Metric, create_metric, default_metric_for_objective
from .models.gbdt import GBDT, check_slice_config
from .objectives import create_objective
from .utils import resolve_device


def _to_2d_numpy(data: Any) -> np.ndarray:
    if hasattr(data, "values"):   # pandas DataFrame
        data = data.values
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    return arr


_EARLY_STOP_KEYS = ("pred_early_stop", "pred_early_stop_freq",
                    "pred_early_stop_margin")


class Dataset:
    """Dataset container (reference: basic.py:1692)."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List[int]] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = copy.deepcopy(params) if params else {}
        self.free_raw_data = free_raw_data
        self._handle: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        if self._handle is not None:
            return self
        cfg = resolve_params(self.params)
        device = resolve_device(cfg.device_type)
        data = _to_2d_numpy(self.data)
        feature_names = None
        if isinstance(self.feature_name, list):
            feature_names = list(self.feature_name)
        elif hasattr(self.data, "columns"):
            feature_names = [str(c) for c in self.data.columns]
        ref_handle = None
        if self.reference is not None:
            self.reference.construct()
            ref_handle = self.reference._handle

        def vec(v):
            return None if v is None else np.asarray(v).reshape(-1)

        self._handle = construct_from_matrix(
            data, cfg, label=vec(self.label), weight=vec(self.weight),
            group=vec(self.group), init_score=vec(self.init_score),
            categorical_feature=self._cat_indices(feature_names),
            feature_names=feature_names, reference=ref_handle,
            device=device)
        if self.free_raw_data:
            self.data = None
        return self

    def _cat_indices(self, feature_names: Optional[List[str]]) -> List[int]:
        """Column indices of `categorical_feature`: indices, names of
        `feature_names`, or a comma-separated string; "auto" (there is no
        pandas category dtype here) and None mean none (JAX basic.py:266)."""
        cats = self.categorical_feature
        if cats == "auto" or cats is None:
            return []
        if isinstance(cats, str):
            return [int(c) for c in cats.split(",") if c]
        out: List[int] = []
        for c in cats:
            if isinstance(c, str):
                if feature_names and c in feature_names:
                    out.append(feature_names.index(c))
            else:
                out.append(int(c))
        return out

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """reference: basic.py Dataset.create_valid."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params if params is not None else self.params)

    def num_data(self) -> int:
        self.construct()
        return self._handle.num_data

    def num_feature(self) -> int:
        self.construct()
        return self._handle.num_total_features

    def get_label(self) -> Optional[np.ndarray]:
        if self._handle is not None:
            return self._handle.metadata.label
        return None if self.label is None else np.asarray(self.label)

    def get_feature_name(self) -> List[str]:
        self.construct()
        return list(self._handle.feature_names)


class Booster:
    """Booster (reference: basic.py:3495)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = copy.deepcopy(params) if params else {}
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_metrics: List[Metric] = []
        self._valid_metrics: List[List[Metric]] = []
        self.name_valid_sets: List[str] = []

        if train_set is not None:
            cfg = resolve_params(self.params)
            check_slice_config(cfg)
            resolve_device(cfg.device_type)
            if train_set._handle is None:
                train_set.params = {**train_set.params, **self.params}
            train_set.construct()
            objective = create_objective(cfg)
            self._metric_names = cfg.metric or [default_metric_for_objective(
                cfg.objective)]
            self._train_metrics = [
                m for m in (create_metric(n, cfg) for n in self._metric_names)
                if m is not None]
            self._gbdt = GBDT(cfg, train_set._handle, objective,
                              self._train_metrics)
            self.train_set = train_set
            self._config = cfg
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            # `params` still choose where the loaded model predicts
            # (device_type); the model text brings its own objective
            self._gbdt = GBDT.load_model_from_string(
                model_str, resolve_params(self.params))
            self._config = self._gbdt.config
        else:
            raise ValueError("need at least one of train_set, model_file "
                             "and model_str")

    # ------------------------------------------------------------------
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Score `data` each round with the training metrics. A valid set
        not constructed yet is binned against the training set and, for
        the parameters it does not set itself, under the booster's (its
        device_type above all), as the reference merges the training
        params into its valid sets."""
        if data.reference is not self.train_set:
            data.reference = self.train_set
        if data._handle is None:
            data.params = {**self.params, **data.params}
        data.construct()
        metrics = [m for m in (create_metric(n, self._config)
                               for n in self._metric_names) if m is not None]
        self._gbdt.add_valid_dataset(data._handle, name, metrics)
        self._valid_metrics.append(metrics)
        self.name_valid_sets.append(name)
        return self

    def update(self) -> bool:
        """One boosting iteration (reference: basic.py:4005). Returns True
        when no further splits are possible."""
        return self._gbdt.train_one_iter()

    def update_batch(self, n: int) -> None:
        """Run `n` boosting iterations. The JAX package fuses them into
        device scans whose models are md5-equal to repeated update() calls;
        this port runs the per-iteration loop (the batched path is ROADMAP
        item A12)."""
        for _ in range(n):
            if self.update():
                break

    @property
    def current_iteration(self):
        return self._gbdt.iter

    def num_trees(self) -> int:
        return len(self._gbdt.models)

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx_ + 1

    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names_)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        t = 0 if importance_type == "split" else 1
        imp = self._gbdt.feature_importance(t, iteration or -1)
        return imp if t else imp.astype(np.int64)

    # ------------------------------------------------------------------
    def eval_train(self) -> List:
        return self._gbdt.get_eval_result({"training": self._train_metrics})

    def eval_valid(self) -> List:
        out = []
        for name, metrics in zip(self.name_valid_sets, self._valid_metrics):
            out.extend(self._gbdt.get_eval_result({name: metrics}))
        return out

    # ------------------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        """Margins or converted outputs of `data`: the host walk over the
        packed trees, or the device predictor for 100k f32 rows and more
        on a CUDA booster (models/gbdt.py:predict_raw); `[N, K]` for K
        models an iteration. `pred_leaf` gives each row's leaf index in
        every tree, `[N, iterations * K]`, columns in iteration then class
        order. `pred_early_stop` / `_freq` / `_margin`, from the keyword
        arguments or else from the booster's params, stop a row's walk
        once its margin clears the bound (host walk only), as the JAX
        package's Booster.predict. Any other keyword raises."""
        unknown = sorted(set(kwargs) - set(_EARLY_STOP_KEYS))
        if unknown:
            raise NotImplementedError(
                f"Booster.predict keyword(s) {unknown} are not ported to "
                "lightgbm_tpu_torch yet (ROADMAP item A6)")
        ni = num_iteration if num_iteration is not None else (
            self.best_iteration if self.best_iteration > 0 else -1)
        if pred_contrib:
            raise NotImplementedError(
                "pred_contrib (SHAP values) is not ported to "
                "lightgbm_tpu_torch yet (ROADMAP item A18)")
        if pred_leaf:
            return self._gbdt.predict_leaf_index(_to_2d_numpy(data),
                                                 start_iteration, ni)
        es_kwargs = {}
        for p in _EARLY_STOP_KEYS:
            if p in kwargs:
                es_kwargs[p] = kwargs[p]
            elif p in self.params:
                es_kwargs[p] = self.params[p]
        return self._gbdt.predict(_to_2d_numpy(data), raw_score=raw_score,
                                  start_iteration=start_iteration,
                                  num_iteration=ni, **es_kwargs)

    def serve(self, **kwargs) -> Any:
        """Inference session over this model: pinned packed trees, the
        bucket ladder and its scorer cache (serving/session.py). Host-engine
        outputs are bitwise equal to the host walk of :meth:`predict`."""
        from .serving import ServingSession
        return ServingSession.from_booster(self, **kwargs)

    # ------------------------------------------------------------------
    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        # write-temp -> rename: a concurrent reader never sees half a file
        tmp = f"{filename}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.model_to_string(num_iteration, start_iteration,
                                         importance_type))
        os.replace(tmp, filename)
        return self

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        ni = num_iteration if num_iteration is not None else (
            self.best_iteration if self.best_iteration > 0 else -1)
        s = self._gbdt.save_model_to_string(
            start_iteration, ni, 0 if importance_type == "split" else 1)
        return s + "\npandas_categorical:null\n"
