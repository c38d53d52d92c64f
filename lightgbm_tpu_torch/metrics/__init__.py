"""Evaluation metrics.

Host numpy metrics, counterpart of lightgbm_tpu/metrics/__init__.py (the
reference's src/metric/*): scores are pulled from the device once per
evaluation. This slice has auc, binary_logloss, l2 and rmse; the other
metrics of the JAX package are ROADMAP item A10.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import Config
from ..utils.log import log_warning

_KEPS = 1e-15

MetricResult = Tuple[str, float, bool]  # (name, value, is_higher_better)


class Metric:
    name: str = ""
    is_higher_better: bool = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.label = metadata.label
        self.weight = metadata.weight
        self.query_boundaries = metadata.query_boundaries
        self.num_data = num_data
        if self.weight is None:
            self.sum_weights = float(num_data)
        else:
            self.sum_weights = float(np.sum(self.weight))

    def eval(self, score: np.ndarray, objective) -> List[MetricResult]:
        raise NotImplementedError

    def result_name(self) -> str:
        """Name under which eval() reports its (single) result — only
        multi_error@k differs from the class-level name."""
        return self.name

    def _w(self) -> np.ndarray:
        if self.weight is not None:
            return self.weight.astype(np.float64)
        return np.ones(self.num_data, dtype=np.float64)


class _PointwiseRegressionMetric(Metric):
    """reference: regression_metric.hpp RegressionMetric<T>."""

    transform_output = True

    def point_loss(self, label: np.ndarray, score: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def final_transform(self, mean_loss: float) -> float:
        return mean_loss

    def eval(self, score, objective) -> List[MetricResult]:
        score = np.asarray(score, np.float64).reshape(-1)
        if objective is not None and self.transform_output \
                and objective.need_convert_output:
            score = objective.convert_output(score)
        label = self.label.astype(np.float64)
        w = self._w()
        loss = float(np.sum(self.point_loss(label, score) * w) / self.sum_weights)
        return [(self.name, self.final_transform(loss), self.is_higher_better)]


class L2Metric(_PointwiseRegressionMetric):
    name = "l2"

    def point_loss(self, y, s):
        return (s - y) ** 2


class RMSEMetric(L2Metric):
    name = "rmse"

    def final_transform(self, v):
        return float(np.sqrt(v))


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, score, objective) -> List[MetricResult]:
        p = objective.convert_output(np.asarray(score, np.float64).reshape(-1)) \
            if objective is not None and objective.need_convert_output else \
            1.0 / (1.0 + np.exp(-np.asarray(score, np.float64).reshape(-1)))
        y = (self.label > 0).astype(np.float64)
        p = np.clip(p, _KEPS, 1.0 - _KEPS)
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        w = self._w()
        return [(self.name, float(np.sum(loss * w) / self.sum_weights), False)]


class AUCMetric(Metric):
    """reference: binary_metric.hpp AUCMetric (weighted rank sum)."""
    name = "auc"
    is_higher_better = True

    def eval(self, score, objective) -> List[MetricResult]:
        s = np.asarray(score, np.float64).reshape(-1)
        y = (self.label > 0)
        w = self._w()
        order = np.argsort(s, kind="mergesort")
        s_s, y_s, w_s = s[order], y[order], w[order]
        # tie-aware trapezoid accumulation
        pos_w = np.sum(w_s * y_s)
        neg_w = np.sum(w_s * ~y_s)
        if pos_w <= 0 or neg_w <= 0:
            return [(self.name, 1.0, True)]
        # group by unique score
        _, idx_start = np.unique(s_s, return_index=True)
        group_pos = np.add.reduceat(w_s * y_s, idx_start)
        group_neg = np.add.reduceat(w_s * ~y_s, idx_start)
        cum_neg = np.cumsum(group_neg) - group_neg
        auc = np.sum(group_pos * (cum_neg + 0.5 * group_neg)) / (pos_w * neg_w)
        return [(self.name, float(auc), True)]


_METRIC_REGISTRY = {
    "l2": L2Metric, "mean_squared_error": L2Metric, "mse": L2Metric,
    "regression": L2Metric, "regression_l2": L2Metric,
    "rmse": RMSEMetric, "root_mean_squared_error": RMSEMetric,
    "l2_root": RMSEMetric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "auc": AUCMetric,
}

# metrics of the JAX package that this port does not have yet
_NOT_PORTED = {
    "l1", "mean_absolute_error", "mae", "regression_l1", "quantile",
    "huber", "fair", "poisson", "mape", "mean_absolute_percentage_error",
    "gamma", "gamma_deviance", "tweedie", "r2", "binary_error", "auc_mu",
    "average_precision", "multi_logloss", "multiclass", "softmax",
    "multiclassova", "multi_error", "ndcg", "lambdarank", "rank_xendcg",
    "xendcg", "map", "mean_average_precision", "cross_entropy",
    "xentropy", "cross_entropy_lambda", "xentlambda", "kullback_leibler",
    "kldiv"}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """reference: Metric::CreateMetric (src/metric/metric.cpp:88)."""
    name = name.strip()
    if name in ("", "none", "null", "custom", "na"):
        return None
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"metric '{name}' is not ported to lightgbm_tpu_torch yet "
            "(ROADMAP item A10)")
    if name not in _METRIC_REGISTRY:
        log_warning(f"Unknown metric {name!r}; ignored")
        return None
    return _METRIC_REGISTRY[name](config)


def default_metric_for_objective(objective: str) -> str:
    """When metric is unset, the reference uses the objective's own metric
    (config.cpp Config::CheckParamConflict)."""
    return objective.split(" ")[0]
