"""Objective functions on torch tensors.

Counterpart of lightgbm_tpu/objectives/__init__.py (the reference's
src/objective/*): gradients and hessians are elementwise tensor functions
evaluated on the scores' device. This slice ports binary logloss and L2
regression; the other objectives are ROADMAP item A10.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..utils.log import log_fatal

_KEPS = 1e-15


class ObjectiveFunction:
    """Base interface (reference: include/LightGBM/objective_function.h)."""

    name: str = "custom"
    num_model_per_iteration: int = 1
    need_convert_output: bool = False

    def __init__(self, config: Config):
        self.config = config
        self.num_data = 0
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = metadata.label
        self.weight = metadata.weight

    def get_gradients(self, score: torch.Tensor, label: torch.Tensor,
                      weight: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def convert_output(self, score: np.ndarray) -> np.ndarray:
        return score

    def to_string(self) -> str:
        return self.name

    def _w(self) -> Tuple[np.ndarray, float]:
        if self.weight is not None:
            return self.weight.astype(np.float64), float(np.sum(self.weight))
        return np.ones_like(self.label, dtype=np.float64), float(len(self.label))


class RegressionL2(ObjectiveFunction):
    """reference: regression_objective.hpp:94 (grad = score - label,
    hess = 1)."""
    name = "regression"

    def get_gradients(self, score, label, weight):
        grad = score - label
        hess = torch.ones_like(score)
        if weight is not None:
            grad, hess = grad * weight, hess * weight
        return grad, hess

    def boost_from_score(self, class_id: int) -> float:
        if not self.config.boost_from_average or self.label is None:
            return 0.0
        w, sumw = self._w()
        return float(np.sum(self.label * w) / sumw)


class BinaryLogloss(ObjectiveFunction):
    """reference: binary_objective.hpp:22."""
    name = "binary"
    need_convert_output = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.label is None:
            return
        pos = self.label > 0
        w, _ = self._w()
        cnt_pos = float(np.sum(w[pos]))
        cnt_neg = float(np.sum(w[~pos]))
        pos_w, neg_w = 1.0, 1.0
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                neg_w = cnt_pos / cnt_neg
            else:
                pos_w = cnt_neg / cnt_pos
        self._pos_weight = pos_w * self.config.scale_pos_weight
        self._neg_weight = neg_w

    def get_gradients(self, score, label, weight):
        sig = self.config.sigmoid
        is_pos = label > 0
        one = torch.ones_like(score)
        y = torch.where(is_pos, one, -one)
        lw = torch.where(is_pos, one * self._pos_weight,
                         one * self._neg_weight)
        response = -y * sig / (1.0 + torch.exp(y * sig * score))
        abs_r = torch.abs(response)
        grad = response * lw
        hess = abs_r * (sig - abs_r) * lw
        if weight is not None:
            grad, hess = grad * weight, hess * weight
        return grad, hess

    def boost_from_score(self, class_id: int) -> float:
        """reference: binary_objective.hpp:140 (log-odds of the weighted
        positive rate, divided by sigmoid)."""
        if self.label is None or not self.config.boost_from_average:
            return 0.0
        w, sumw = self._w()
        suml = float(np.sum((self.label > 0) * w))
        pavg = min(max(suml / sumw, _KEPS), 1.0 - _KEPS)
        return float(np.log(pavg / (1.0 - pavg)) / self.config.sigmoid)

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-self.config.sigmoid * score))

    def to_string(self):
        return f"binary sigmoid:{self.config.sigmoid:g}"


_OBJECTIVE_REGISTRY = {
    "regression": RegressionL2,
    "regression_l2": RegressionL2,
    "l2": RegressionL2,
    "mean_squared_error": RegressionL2,
    "mse": RegressionL2,
    "l2_root": RegressionL2,
    "root_mean_squared_error": RegressionL2,
    "rmse": RegressionL2,
    "binary": BinaryLogloss,
}

# objectives of the JAX package that this port does not have yet
_NOT_PORTED = {
    "regression_l1", "l1", "mean_absolute_error", "mae", "huber", "fair",
    "poisson", "quantile", "mape", "mean_absolute_percentage_error",
    "gamma", "tweedie", "multiclass", "softmax", "multiclassova",
    "multiclass_ova", "ova", "ovr", "cross_entropy", "xentropy",
    "cross_entropy_lambda", "xentlambda", "lambdarank", "rank_xendcg",
    "xendcg", "xe_ndcg", "xe_ndcg_mart", "xendcg_mart"}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (reference: ObjectiveFunction::CreateObjectiveFunction,
    src/objective/objective_function.cpp:81)."""
    name = config.objective.split(" ")[0]
    if name in ("none", "null", "custom", "na"):
        return None
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"objective '{name}' is not ported to lightgbm_tpu_torch yet "
            "(ROADMAP item A10); this slice has binary and regression")
    if name not in _OBJECTIVE_REGISTRY:
        log_fatal(f"Unknown objective type name: {name}")
    return _OBJECTIVE_REGISTRY[name](config)
