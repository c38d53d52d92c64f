"""Objective functions on torch tensors.

Counterpart of lightgbm_tpu/objectives/__init__.py (the reference's
src/objective/*): gradients and hessians are elementwise tensor functions
evaluated on the scores' device. Scores have shape [num_model_per_iteration,
N] (class-major, the reference's score layout); the single-model objectives
take one [N] row. The ranking objectives live in objectives/rank.py.
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
    is_constant_hessian: bool = False
    need_convert_output: bool = False
    # objectives that refit leaf outputs after growth (RenewTreeOutput,
    # objective_function.h:58): l1 / quantile / mape
    need_renew_tree_output: bool = False
    # host-computed gradients (get_gradients_numpy; rank_xendcg)
    runs_on_host: bool = False

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

    def renew_tree_output_quantile(self) -> Optional[float]:
        """Percentile (alpha) for leaf-output renewal, or None."""
        return None

    def renew_sample_weights(self) -> Optional[np.ndarray]:
        """Per-row weights of the renewal percentiles (None: unweighted);
        MAPE gives its label weights (RegressionMAPELOSS::RenewTreeOutput)."""
        return None if self.weight is None \
            else np.asarray(self.weight, np.float64)

    def to_string(self) -> str:
        return self.name

    def _w(self) -> Tuple[np.ndarray, float]:
        if self.weight is not None:
            return self.weight.astype(np.float64), float(np.sum(self.weight))
        return np.ones_like(self.label, dtype=np.float64), float(len(self.label))


def _weighted(grad, hess, weight):
    if weight is not None:
        return grad * weight, hess * weight
    return grad, hess


def sign_nan(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: torch.sign maps NaN to 0, jnp.sign keeps it NaN, so a NaN
    label gives NaN gradients (and 1-leaf trees) as in the JAX package."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _const(score: torch.Tensor, v: float) -> torch.Tensor:
    """A Python float as an f32 tensor of score's shape (a weakly typed
    scalar of the JAX package's jnp.where)."""
    return torch.full_like(score, v)


# ---------------------------------------------------------------------------
# regression family (reference: src/objective/regression_objective.hpp)
# ---------------------------------------------------------------------------
class RegressionL2(ObjectiveFunction):
    """reference: regression_objective.hpp:94 (grad = score - label,
    hess = 1)."""
    name = "regression"
    is_constant_hessian = True

    def get_gradients(self, score, label, weight):
        return _weighted(score - label, torch.ones_like(score), weight)

    def boost_from_score(self, class_id: int) -> float:
        if not self.config.boost_from_average or self.label is None:
            return 0.0
        w, sumw = self._w()
        return float(np.sum(self.label * w) / sumw)


class RegressionL1(RegressionL2):
    """reference: regression_objective.hpp:208."""
    name = "regression_l1"
    need_renew_tree_output = True

    def get_gradients(self, score, label, weight):
        return _weighted(sign_nan(score - label), torch.ones_like(score),
                         weight)

    def boost_from_score(self, class_id: int) -> float:
        if not self.config.boost_from_average or self.label is None:
            return 0.0
        if self.weight is None:
            return percentile_ref(self.label, 0.5)
        return weighted_percentile_ref(self.label, self.weight, 0.5)

    def renew_tree_output_quantile(self):
        return 0.5


class RegressionHuber(RegressionL2):
    """reference: regression_objective.hpp:294 (no leaf renewal)."""
    name = "huber"
    is_constant_hessian = False

    def get_gradients(self, score, label, weight):
        a = self.config.alpha
        diff = score - label
        grad = torch.where(torch.abs(diff) <= a, diff, sign_nan(diff) * a)
        return _weighted(grad, torch.ones_like(score), weight)


class RegressionFair(ObjectiveFunction):
    """reference: regression_objective.hpp:352."""
    name = "fair"

    def get_gradients(self, score, label, weight):
        c = self.config.fair_c
        x = score - label
        grad = c * x / (torch.abs(x) + c)
        # c * c as an f32 tensor: torch computes `scalar / tensor` as a
        # reciprocal times the scalar, not the quotient
        hess = _const(score, c * c) / ((torch.abs(x) + c) ** 2)
        return _weighted(grad, hess, weight)


class RegressionPoisson(ObjectiveFunction):
    """reference: regression_objective.hpp:399."""
    name = "poisson"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.label is not None and np.any(self.label < 0):
            log_fatal("[poisson]: at least one target label is negative")

    def get_gradients(self, score, label, weight):
        mds = self.config.poisson_max_delta_step
        return _weighted(torch.exp(score) - label, torch.exp(score + mds),
                         weight)

    def boost_from_score(self, class_id: int) -> float:
        if self.label is None:
            return 0.0
        w, sumw = self._w()
        return float(np.log(max(np.sum(self.label * w) / sumw, _KEPS)))

    def convert_output(self, score):
        return np.exp(score)


class RegressionQuantile(RegressionL2):
    """reference: regression_objective.hpp:482."""
    name = "quantile"
    need_renew_tree_output = True

    def get_gradients(self, score, label, weight):
        a = self.config.alpha
        grad = torch.where(score > label, _const(score, 1.0 - a),
                           _const(score, -a))
        return _weighted(grad, torch.ones_like(score), weight)

    def boost_from_score(self, class_id: int) -> float:
        if not self.config.boost_from_average or self.label is None:
            return 0.0
        if self.weight is None:
            return percentile_ref(self.label, self.config.alpha)
        return weighted_percentile_ref(self.label, self.weight,
                                       self.config.alpha)

    def renew_tree_output_quantile(self):
        return self.config.alpha


class RegressionMAPE(RegressionL2):
    """reference: regression_objective.hpp (RegressionMAPELOSS)."""
    name = "mape"
    need_renew_tree_output = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        # label_weight = w / max(1, |label|), normalized to sum to num_data
        w, _ = self._w()
        lw = w / np.maximum(1.0, np.abs(self.label))
        self._label_weight = (lw / np.sum(lw) * len(lw)).astype(np.float32)
        self._lw_dev: Optional[torch.Tensor] = None

    def get_gradients(self, score, label, weight):
        if self._lw_dev is None or self._lw_dev.device != score.device:
            self._lw_dev = torch.from_numpy(self._label_weight).to(
                score.device)
        lw = self._lw_dev
        return sign_nan(score - label) * lw, lw.expand_as(score)

    def boost_from_score(self, class_id: int) -> float:
        if not self.config.boost_from_average or self.label is None:
            return 0.0
        return weighted_percentile_ref(
            self.label, self._label_weight.astype(np.float64), 0.5)

    def renew_tree_output_quantile(self):
        return 0.5

    def renew_sample_weights(self):
        return np.asarray(self._label_weight, np.float64)


class RegressionGamma(RegressionPoisson):
    """reference: regression_objective.hpp (RegressionGammaLoss)."""
    name = "gamma"

    def get_gradients(self, score, label, weight):
        e = torch.exp(-score)
        return _weighted(1.0 - label * e, label * e, weight)


class RegressionTweedie(RegressionPoisson):
    """reference: regression_objective.hpp:718."""
    name = "tweedie"

    def get_gradients(self, score, label, weight):
        rho = self.config.tweedie_variance_power
        e1 = torch.exp((1.0 - rho) * score)
        e2 = torch.exp((2.0 - rho) * score)
        grad = -label * e1 + e2
        hess = -label * (1.0 - rho) * e1 + (2.0 - rho) * e2
        return _weighted(grad, hess, weight)


# ---------------------------------------------------------------------------
# binary (reference: src/objective/binary_objective.hpp:22)
# ---------------------------------------------------------------------------
class BinaryLogloss(ObjectiveFunction):
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
        return _weighted(response * lw, abs_r * (sig - abs_r) * lw, weight)

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


# ---------------------------------------------------------------------------
# multiclass (reference: src/objective/multiclass_objective.hpp:25,187)
# ---------------------------------------------------------------------------
class MulticlassSoftmax(ObjectiveFunction):
    name = "multiclass"
    need_convert_output = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_model_per_iteration = config.num_class
        if config.num_class <= 1:
            log_fatal("num_class should be > 1 for multiclass objective")
        self._factor = config.num_class / (config.num_class - 1.0)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        li = self.label.astype(np.int32)
        if np.any((li < 0) | (li >= self.config.num_class)):
            log_fatal(f"Label must be in [0, {self.config.num_class})")
        w, sumw = self._w()
        probs = np.zeros(self.config.num_class)
        np.add.at(probs, li, w)
        self._class_init_probs = probs / sumw

    def get_gradients(self, score, label, weight):
        # score [K, N]; softmax over the classes as jax.nn.softmax computes
        # it: exp(s - max) over its sum
        e = torch.exp(score - score.max(dim=0, keepdim=True).values)
        p = e / e.sum(dim=0, keepdim=True)
        K = score.shape[0]
        y = (label.to(torch.int32)[None, :]
             == torch.arange(K, dtype=torch.int32,
                             device=score.device)[:, None])
        grad = p - y.to(p.dtype)
        hess = self._factor * p * (1.0 - p)
        if weight is not None:
            grad, hess = grad * weight[None, :], hess * weight[None, :]
        return grad, hess

    def boost_from_score(self, class_id: int) -> float:
        """reference: multiclass_objective.hpp:156."""
        if not self.config.boost_from_average:
            return 0.0
        return float(np.log(max(_KEPS, self._class_init_probs[class_id])))

    def convert_output(self, score):
        # [K, N] -> softmax probabilities
        e = np.exp(score - np.max(score, axis=0, keepdims=True))
        return e / np.sum(e, axis=0, keepdims=True)

    def to_string(self):
        return f"multiclass num_class:{self.config.num_class}"


class _LabelOnly:
    """Metadata of one class of MulticlassOVA: its 0/1 label, the weights."""

    def __init__(self, label, weight):
        self.label, self.weight = label, weight


class MulticlassOVA(ObjectiveFunction):
    """One-vs-all: K independent binary objectives
    (reference: multiclass_objective.hpp:187)."""
    name = "multiclassova"
    need_convert_output = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_model_per_iteration = config.num_class
        if config.num_class <= 1:
            log_fatal("num_class should be > 1 for multiclassova objective")

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self._binaries = []
        for k in range(self.config.num_class):
            b = BinaryLogloss(self.config)
            b.init(_LabelOnly((self.label.astype(np.int32) == k)
                              .astype(np.float32), self.weight), num_data)
            self._binaries.append(b)

    def get_gradients(self, score, label, weight):
        li = label.to(torch.int32)
        out = [self._binaries[k].get_gradients(
            score[k], (li == k).to(torch.float32), weight)
            for k in range(score.shape[0])]
        return (torch.stack([g for g, _ in out]),
                torch.stack([h for _, h in out]))

    def boost_from_score(self, class_id: int) -> float:
        return self._binaries[class_id].boost_from_score(0)

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-self.config.sigmoid * score))

    def to_string(self):
        return (f"multiclassova num_class:{self.config.num_class} "
                f"sigmoid:{self.config.sigmoid:g}")


# ---------------------------------------------------------------------------
# cross-entropy (reference: src/objective/xentropy_objective.hpp:45,186)
# ---------------------------------------------------------------------------
class CrossEntropy(ObjectiveFunction):
    name = "cross_entropy"
    need_convert_output = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.label is not None and (np.any(self.label < 0)
                                       or np.any(self.label > 1)):
            log_fatal("[cross_entropy]: labels must be in [0, 1]")

    def get_gradients(self, score, label, weight):
        p = 1.0 / (1.0 + torch.exp(-score))
        return _weighted(p - label, p * (1.0 - p), weight)

    def boost_from_score(self, class_id: int) -> float:
        if self.label is None:
            return 0.0
        w, sumw = self._w()
        p = float(np.sum(self.label * w) / sumw)
        p = min(max(p, _KEPS), 1.0 - _KEPS)
        return float(np.log(p / (1.0 - p)))

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-score))


class CrossEntropyLambda(ObjectiveFunction):
    """reference: xentropy_objective.hpp:186 (the weights folded in,
    hu = w exp(s) / (1 + w exp(s)), xentropy_objective.hpp:230-260)."""
    name = "cross_entropy_lambda"
    need_convert_output = True

    def get_gradients(self, score, label, weight):
        w = weight if weight is not None else 1.0
        epsilon = torch.exp(score)
        hu = w * epsilon / (1.0 + w * epsilon)
        return hu * (1.0 + label) - label, hu * (1.0 + label) * (1.0 - hu)

    def boost_from_score(self, class_id: int) -> float:
        """log(expm1(mean label)), the inverse of the log1p(exp) output
        link at the label mean (xentropy_objective.hpp:267)."""
        if self.label is None:
            return 0.0
        w, sumw = self._w()
        p = max(float(np.sum(self.label * w) / sumw), _KEPS)
        return float(np.log(max(np.expm1(p), _KEPS)))

    def convert_output(self, score):
        return np.log1p(np.exp(score))


def percentile_ref(values: np.ndarray, alpha: float) -> float:
    """The reference percentile (PercentileFun,
    regression_objective.hpp:25): descending order, linear interpolation
    at (cnt - 1) * (1 - alpha)."""
    cnt = len(values)
    if cnt == 0:
        return 0.0
    if cnt == 1:
        return float(values[0])
    d = np.sort(np.asarray(values, np.float64))[::-1]
    float_pos = (cnt - 1) * (1.0 - alpha)
    pos = int(float_pos) + 1
    if pos < 1:
        return float(d[0])
    if pos >= cnt:
        return float(d[-1])
    bias = float_pos - (pos - 1)
    return float(d[pos - 1] - (d[pos - 1] - d[pos]) * bias)


def weighted_percentile_ref(values: np.ndarray, weights: np.ndarray,
                            alpha: float) -> float:
    """The reference weighted percentile (WeightedPercentileFun,
    regression_objective.hpp:57)."""
    cnt = len(values)
    if cnt == 0:
        return 0.0
    if cnt == 1:
        return float(values[0])
    order = np.argsort(np.asarray(values, np.float64), kind="stable")
    v = np.asarray(values, np.float64)[order]
    w = np.asarray(weights, np.float64)[order]
    cdf = np.cumsum(w)
    thr = cdf[-1] * alpha
    pos = min(int(np.searchsorted(cdf, thr, side="right")), cnt - 1)
    if pos == 0 or pos == cnt - 1:
        return float(v[pos])
    if cdf[pos] - cdf[pos - 1] >= 1.0:
        return float((thr - cdf[pos - 1]) / (cdf[pos] - cdf[pos - 1])
                     * (v[pos] - v[pos - 1]) + v[pos - 1])
    return float(v[pos - 1])


_OBJECTIVE_REGISTRY = {
    "regression": RegressionL2,
    "regression_l2": RegressionL2,
    "l2": RegressionL2,
    "mean_squared_error": RegressionL2,
    "mse": RegressionL2,
    "l2_root": RegressionL2,
    "root_mean_squared_error": RegressionL2,
    "rmse": RegressionL2,
    "regression_l1": RegressionL1,
    "l1": RegressionL1,
    "mean_absolute_error": RegressionL1,
    "mae": RegressionL1,
    "huber": RegressionHuber,
    "fair": RegressionFair,
    "poisson": RegressionPoisson,
    "quantile": RegressionQuantile,
    "mape": RegressionMAPE,
    "mean_absolute_percentage_error": RegressionMAPE,
    "gamma": RegressionGamma,
    "tweedie": RegressionTweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "softmax": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "multiclass_ova": MulticlassOVA,
    "ova": MulticlassOVA,
    "ovr": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "xentropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "xentlambda": CrossEntropyLambda,
}

_RANK_OBJECTIVES = ("lambdarank", "rank_xendcg", "xendcg", "xe_ndcg",
                    "xe_ndcg_mart", "xendcg_mart")


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (reference: ObjectiveFunction::CreateObjectiveFunction,
    src/objective/objective_function.cpp:81)."""
    name = config.objective.split(" ")[0]
    if name in ("none", "null", "custom", "na"):
        return None
    if name in _RANK_OBJECTIVES:
        from .rank import LambdarankNDCG, RankXENDCG
        return (LambdarankNDCG if name == "lambdarank" else RankXENDCG)(
            config)
    if name not in _OBJECTIVE_REGISTRY:
        log_fatal(f"Unknown objective type name: {name}")
    return _OBJECTIVE_REGISTRY[name](config)
