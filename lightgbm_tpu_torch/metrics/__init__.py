"""Evaluation metrics.

Host numpy metrics, counterpart of lightgbm_tpu/metrics/__init__.py (the
reference's src/metric/*, factory metric.cpp:88): scores are pulled from
the device once per evaluation, [N] for one model an iteration and [K, N]
for multiclass. Each metric returns (name, value, is_higher_better)
tuples, and applies the objective's output transform itself, as the
reference metrics take the ObjectiveFunction's ConvertOutput.

Batched training evaluates the valid sets on the device instead, inside
the graphs of a chunk: `device_eval_fn(objective)` gives a tensor function
`fn(score, label, weight, sum_weights) -> f32 scalar` of the [K, N]
scores, or None where the JAX package has no device form (JAX metrics/
__init__.py:28-101, :265, :295, :334, :399, :436); the run then stays per
iteration. Device values are f32 and may differ from the f64 host value
in the low bits.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..utils.log import log_fatal, log_warning

_KEPS = 1e-15
# device metrics run in f32, where 1e-15 would round `1 - eps` to 1 and
# log(0) follow: the smallest eps that survives it (JAX metrics:22)
_KEPS_F32 = 1e-7

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

    def device_eval_fn(self, objective) -> Optional[Callable]:
        """The metric as a tensor function of (score [K, N], label [N],
        weight [N], sum_weights) for the batched trainer, or None when it
        has none."""
        return None

    def _w(self) -> np.ndarray:
        if self.weight is not None:
            return self.weight.astype(np.float64)
        return np.ones(self.num_data, dtype=np.float64)

    def _mean(self, loss: np.ndarray) -> float:
        return float(np.sum(loss * self._w()) / self.sum_weights)


def _device_convert_output(objective) -> Optional[Callable]:
    """The objective's output transform as a tensor function (identity
    when it has none), or None when it has no device form (JAX metrics/
    __init__.py:28-44)."""
    if objective is None or not objective.need_convert_output:
        return lambda s: s
    name = getattr(objective, "name", "")
    if name in ("binary", "multiclassova"):
        sig = float(objective.config.sigmoid)
        return lambda s: 1.0 / (1.0 + torch.exp(-sig * s))
    if name == "multiclass":
        return lambda s: torch.softmax(s, dim=0)
    if name in ("poisson", "gamma", "tweedie"):
        return torch.exp
    return None


def _sigmoid_t(s: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-s))


def _converted(score, objective, otherwise=None) -> np.ndarray:
    """[N] f64 scores through the objective's output transform, or through
    `otherwise` (identity when None) without one."""
    s = np.asarray(score, np.float64).reshape(-1)
    if objective is not None and objective.need_convert_output:
        return objective.convert_output(s)
    return s if otherwise is None else otherwise(s)


def _sigmoid(s):
    return 1.0 / (1.0 + np.exp(-s))


# ---------------------------------------------------------------------------
# regression metrics (reference: regression_metric.hpp RegressionMetric<T>)
# ---------------------------------------------------------------------------
class _PointwiseRegressionMetric(Metric):
    # (config, label, score) -> loss as tensors, or None: no device form
    _device_point_loss = None

    def point_loss(self, label: np.ndarray, score: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def final_transform(self, mean_loss: float) -> float:
        return mean_loss

    def _device_final(self, v: torch.Tensor) -> torch.Tensor:
        return v

    def device_eval_fn(self, objective):
        point = type(self)._device_point_loss
        conv = _device_convert_output(objective)
        if point is None or conv is None:
            return None
        final, cfg = self._device_final, self.config

        def fn(score, label, weight, sum_weights):
            s = conv(score.reshape(-1))
            return final(torch.sum(point(cfg, label, s) * weight)
                         / sum_weights)
        return fn

    def eval(self, score, objective) -> List[MetricResult]:
        s = _converted(score, objective)
        loss = self._mean(self.point_loss(self.label.astype(np.float64), s))
        return [(self.name, self.final_transform(loss),
                 self.is_higher_better)]


class L2Metric(_PointwiseRegressionMetric):
    name = "l2"
    _device_point_loss = staticmethod(lambda cfg, y, s: (s - y) ** 2)

    def point_loss(self, y, s):
        return (s - y) ** 2


class RMSEMetric(L2Metric):
    name = "rmse"

    def final_transform(self, v):
        return float(np.sqrt(v))

    def _device_final(self, v):
        return torch.sqrt(v)


class L1Metric(_PointwiseRegressionMetric):
    name = "l1"
    _device_point_loss = staticmethod(lambda cfg, y, s: torch.abs(s - y))

    def point_loss(self, y, s):
        return np.abs(s - y)


class QuantileMetric(_PointwiseRegressionMetric):
    name = "quantile"
    _device_point_loss = staticmethod(
        lambda cfg, y, s: torch.where((y - s) >= 0, cfg.alpha * (y - s),
                                      (cfg.alpha - 1.0) * (y - s)))

    def point_loss(self, y, s):
        a = self.config.alpha
        d = y - s
        return np.where(d >= 0, a * d, (a - 1.0) * d)


class HuberMetric(_PointwiseRegressionMetric):
    name = "huber"

    def point_loss(self, y, s):
        a = self.config.alpha
        d = np.abs(s - y)
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairMetric(_PointwiseRegressionMetric):
    name = "fair"

    def point_loss(self, y, s):
        c = self.config.fair_c
        x = np.abs(s - y)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseRegressionMetric):
    name = "poisson"

    def point_loss(self, y, s):
        s = np.maximum(s, 1e-10)
        return s - y * np.log(s)


class MAPEMetric(_PointwiseRegressionMetric):
    name = "mape"

    def point_loss(self, y, s):
        return np.abs((y - s)) / np.maximum(1.0, np.abs(y))


class GammaMetric(_PointwiseRegressionMetric):
    """Gamma negative log-likelihood with psi = 1
    (regression_metric.hpp GammaMetric): y / s + log(s)."""
    name = "gamma"

    def point_loss(self, y, s):
        s = np.maximum(s, 1e-10)
        return y / s + np.log(s)


class GammaDevianceMetric(_PointwiseRegressionMetric):
    """regression_metric.hpp GammaDevianceMetric:
    2 (frac - log(frac) - 1), frac = label / score."""
    name = "gamma_deviance"

    def point_loss(self, y, s):
        eps = 1e-9
        frac = np.maximum(y / np.maximum(s, eps), eps)
        return 2.0 * (frac - np.log(frac) - 1.0)


class TweedieMetric(_PointwiseRegressionMetric):
    name = "tweedie"

    def point_loss(self, y, s):
        rho = self.config.tweedie_variance_power
        s = np.maximum(s, 1e-10)
        a = y * np.power(s, 1.0 - rho) / (1.0 - rho)
        b = np.power(s, 2.0 - rho) / (2.0 - rho)
        return -a + b


class R2Metric(_PointwiseRegressionMetric):
    name = "r2"
    is_higher_better = True

    def eval(self, score, objective):
        s = _converted(score, objective)
        y = self.label.astype(np.float64)
        w = self._w()
        ybar = np.sum(y * w) / self.sum_weights
        ss_res = np.sum(w * (y - s) ** 2)
        ss_tot = np.sum(w * (y - ybar) ** 2)
        return [(self.name, float(1.0 - ss_res / max(ss_tot, _KEPS)), True)]


# ---------------------------------------------------------------------------
# binary metrics (reference: binary_metric.hpp:116-271)
# ---------------------------------------------------------------------------
class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, score, objective) -> List[MetricResult]:
        p = np.clip(_converted(score, objective, _sigmoid), _KEPS,
                    1.0 - _KEPS)
        y = (self.label > 0).astype(np.float64)
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [(self.name, self._mean(loss), False)]

    def device_eval_fn(self, objective):
        conv = (_device_convert_output(objective)
                if objective is not None and objective.need_convert_output
                else _sigmoid_t)
        if conv is None:
            return None

        def fn(score, label, weight, sum_weights):
            p = torch.clamp(conv(score.reshape(-1)), _KEPS_F32,
                            1.0 - _KEPS_F32)
            y = (label > 0).to(torch.float32)
            loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
            return torch.sum(loss * weight) / sum_weights
        return fn


class BinaryErrorMetric(Metric):
    name = "binary_error"

    def eval(self, score, objective) -> List[MetricResult]:
        p = _converted(score, objective)
        err = ((p > 0.5) != (self.label > 0)).astype(np.float64)
        return [(self.name, self._mean(err), False)]

    def device_eval_fn(self, objective):
        conv = _device_convert_output(objective)
        if conv is None:
            return None

        def fn(score, label, weight, sum_weights):
            p = conv(score.reshape(-1))
            err = ((p > 0.5) != (label > 0)).to(torch.float32)
            return torch.sum(err * weight) / sum_weights
        return fn


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

    def device_eval_fn(self, objective):
        # rank-based: the monotone output transform changes nothing
        def fn(score, label, weight, sum_weights):
            s = score.reshape(-1)
            n = s.shape[0]
            order = torch.sort(s, stable=True).indices
            s_s, y_s, w_s = s[order], (label > 0)[order], weight[order]
            yw = w_s * y_s.to(torch.float32)
            nw = w_s * (~y_s).to(torch.float32)
            pos_w, neg_w = torch.sum(yw), torch.sum(nw)
            # tie groups: runs of equal scores share a group id
            gid = torch.cumsum(torch.cat([
                torch.zeros(1, dtype=torch.int64, device=s.device),
                (s_s[1:] != s_s[:-1]).to(torch.int64)]), 0)
            group_pos = torch.zeros_like(yw).index_add_(0, gid, yw)
            group_neg = torch.zeros_like(nw).index_add_(0, gid, nw)
            cum_neg = torch.cumsum(group_neg, 0) - group_neg
            auc = torch.sum(group_pos * (cum_neg + 0.5 * group_neg)) \
                / torch.clamp(pos_w * neg_w, min=_KEPS_F32)
            # a one-class valid set reports 1.0, as on the host
            return torch.where((pos_w <= 0) | (neg_w <= 0),
                               torch.ones_like(auc), auc)
        return fn


class AveragePrecisionMetric(Metric):
    name = "average_precision"
    is_higher_better = True

    def eval(self, score, objective) -> List[MetricResult]:
        s = np.asarray(score, np.float64).reshape(-1)
        y = (self.label > 0).astype(np.float64)
        w = self._w()
        order = np.argsort(-s, kind="mergesort")
        y_s, w_s = y[order], w[order]
        tp = np.cumsum(w_s * y_s)
        fp = np.cumsum(w_s * (1 - y_s))
        total_pos = tp[-1]
        if total_pos <= 0:
            return [(self.name, 1.0, True)]
        precision = tp / np.maximum(tp + fp, _KEPS)
        recall = tp / total_pos
        d_recall = np.diff(np.concatenate([[0.0], recall]))
        return [(self.name, float(np.sum(precision * d_recall)), True)]


# ---------------------------------------------------------------------------
# multiclass metrics (reference: multiclass_metric.hpp)
# ---------------------------------------------------------------------------
class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, score, objective) -> List[MetricResult]:
        s = np.asarray(score, np.float64)                      # [K, N] raw
        p = objective.convert_output(s) if objective is not None \
            and objective.need_convert_output else s
        li = self.label.astype(np.int64)
        pi = np.clip(p[li, np.arange(len(li))], _KEPS, 1.0)
        return [(self.name, self._mean(-np.log(pi)), False)]

    def device_eval_fn(self, objective):
        conv = _device_convert_output(objective)
        if conv is None:
            return None

        def fn(score, label, weight, sum_weights):
            p = conv(score)                                  # [K, N]
            li = label.to(torch.int64)
            pi = torch.clamp(p.gather(0, li[None, :])[0], _KEPS_F32, 1.0)
            return torch.sum(-torch.log(pi) * weight) / sum_weights
        return fn


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval(self, score, objective) -> List[MetricResult]:
        s = np.asarray(score, np.float64)
        li = self.label.astype(np.int64)
        k = self.config.multi_error_top_k
        if k <= 1:
            err = (np.argmax(s, axis=0) != li).astype(np.float64)
        else:
            # top-k error: 1 when the true class is not among the k largest
            part = np.argpartition(-s, k - 1, axis=0)[:k]
            err = (~np.any(part == li[None, :], axis=0)).astype(np.float64)
        return [(self.result_name(), self._mean(err), False)]

    def result_name(self) -> str:
        k = self.config.multi_error_top_k
        return self.name if k <= 1 else f"multi_error@{k}"

    def device_eval_fn(self, objective):
        # argmax and top-k membership ignore the output transform
        k = self.config.multi_error_top_k

        def fn(score, label, weight, sum_weights):
            li = label.to(torch.int64)
            if k <= 1:
                err = torch.argmax(score, dim=0) != li
            else:
                topi = torch.topk(score.t(), k, dim=1).indices   # [N, k]
                err = ~torch.any(topi == li[:, None], dim=1)
            return torch.sum(err.to(torch.float32) * weight) / sum_weights
        return fn


class AucMuMetric(Metric):
    """Multi-class AUC-mu (reference: multiclass_metric.hpp:184, after
    Kleiman & Page, pmlr v97): pairwise class separability along the
    partition-weight direction, averaged over class pairs."""
    name = "auc_mu"
    is_higher_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        nc = self.config.num_class
        wspec = self.config.auc_mu_weights
        if wspec:
            if len(wspec) != nc * nc:
                log_fatal(f"auc_mu_weights must have {nc * nc} elements")
            self._cw = np.asarray(wspec, np.float64).reshape(nc, nc)
            np.fill_diagonal(self._cw, 0.0)
        else:
            self._cw = np.ones((nc, nc)) - np.eye(nc)

    def eval(self, score, objective) -> List[MetricResult]:
        nc = self.config.num_class
        s = np.asarray(score, np.float64).reshape(nc, -1)
        lab = self.label.astype(np.int64)
        w = None if self.weight is None else np.asarray(self.weight,
                                                        np.float64)
        ans = 0.0
        for i in range(nc):
            for j in range(i + 1, nc):
                curr_v = self._cw[i] - self._cw[j]
                t1 = curr_v[i] - curr_v[j]
                idx = np.flatnonzero((lab == i) | (lab == j))
                va = t1 * (curr_v @ s[:, idx])
                # sorted by distance, ties put class j (the higher label)
                # first: within a tie group every j row precedes every i
                # row, so the reference's sequential half-credit rule is:
                # each i row counts the j weight of all groups up to its
                # own, less half of its own group's
                order = np.lexsort((-lab[idx], va))
                a = idx[order]
                dist = va[order]
                is_i = lab[a] == i
                wt = np.ones(len(a)) if w is None else w[a]
                grp = np.zeros(len(a), np.int64)
                if len(a) > 1:
                    grp[1:] = np.cumsum(np.abs(np.diff(dist)) >= 1e-15)
                j_in = np.bincount(grp, weights=np.where(is_i, 0.0, wt))
                j_incl = np.cumsum(j_in)
                sij = float(np.sum(wt[is_i] * (j_incl[grp[is_i]]
                                               - 0.5 * j_in[grp[is_i]])))
                if w is None:
                    ci = float(np.sum(lab == i))
                    cj = float(np.sum(lab == j))
                else:
                    ci = float(np.sum(w[lab == i]))
                    cj = float(np.sum(w[lab == j]))
                if ci > 0 and cj > 0:
                    ans += (sij / ci) / cj
        ans = (2.0 * ans / nc) / (nc - 1)
        return [(self.name, float(ans), True)]


# ---------------------------------------------------------------------------
# ranking metrics (reference: rank_metric.hpp:20, map_metric.hpp:21)
# ---------------------------------------------------------------------------
class NDCGMetric(Metric):
    name = "ndcg"
    is_higher_better = True

    def eval(self, score, objective) -> List[MetricResult]:
        from .rank_utils import eval_ndcg
        return eval_ndcg(np.asarray(score, np.float64).reshape(-1),
                         self.label, self.query_boundaries, self.weight,
                         self.config.eval_at, self.config.label_gain)


class MapMetric(Metric):
    name = "map"
    is_higher_better = True

    def eval(self, score, objective) -> List[MetricResult]:
        from .rank_utils import eval_map
        return eval_map(np.asarray(score, np.float64).reshape(-1),
                        self.label, self.query_boundaries, self.weight,
                        self.config.eval_at)


# ---------------------------------------------------------------------------
# cross-entropy metrics (reference: xentropy_metric.hpp)
# ---------------------------------------------------------------------------
class CrossEntropyMetric(Metric):
    name = "cross_entropy"

    def eval(self, score, objective) -> List[MetricResult]:
        p = np.clip(_converted(score, objective, _sigmoid), _KEPS,
                    1.0 - _KEPS)
        y = self.label.astype(np.float64)
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [(self.name, self._mean(loss), False)]


class KLDivMetric(Metric):
    name = "kullback_leibler"

    def eval(self, score, objective) -> List[MetricResult]:
        p = np.clip(_converted(score, objective, _sigmoid), _KEPS,
                    1.0 - _KEPS)
        y = np.clip(self.label.astype(np.float64), _KEPS, 1 - _KEPS)
        kl = y * np.log(y / p) + (1 - y) * np.log((1 - y) / (1 - p))
        return [(self.name, self._mean(kl), False)]


_METRIC_REGISTRY = {
    "l2": L2Metric, "mean_squared_error": L2Metric, "mse": L2Metric,
    "regression": L2Metric, "regression_l2": L2Metric,
    "rmse": RMSEMetric, "root_mean_squared_error": RMSEMetric,
    "l2_root": RMSEMetric,
    "l1": L1Metric, "mean_absolute_error": L1Metric, "mae": L1Metric,
    "regression_l1": L1Metric,
    "quantile": QuantileMetric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "mape": MAPEMetric, "mean_absolute_percentage_error": MAPEMetric,
    "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "r2": R2Metric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "auc_mu": AucMuMetric,
    "average_precision": AveragePrecisionMetric,
    "multi_logloss": MultiLoglossMetric, "multiclass": MultiLoglossMetric,
    "softmax": MultiLoglossMetric, "multiclassova": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "ndcg": NDCGMetric, "lambdarank": NDCGMetric,
    "rank_xendcg": NDCGMetric, "xendcg": NDCGMetric,
    "map": MapMetric, "mean_average_precision": MapMetric,
    "cross_entropy": CrossEntropyMetric, "xentropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyMetric,
    "xentlambda": CrossEntropyMetric,
    "kullback_leibler": KLDivMetric, "kldiv": KLDivMetric,
}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """reference: Metric::CreateMetric (src/metric/metric.cpp:88)."""
    name = name.strip()
    if name in ("", "none", "null", "custom", "na"):
        return None
    if name not in _METRIC_REGISTRY:
        log_warning(f"Unknown metric {name!r}; ignored")
        return None
    return _METRIC_REGISTRY[name](config)


def default_metric_for_objective(objective: str) -> str:
    """When metric is unset, the reference uses the objective's own metric
    (config.cpp Config::CheckParamConflict)."""
    return objective.split(" ")[0]
