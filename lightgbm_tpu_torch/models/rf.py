"""Random forest mode.

Counterpart of lightgbm_tpu/models/rf.py (reference: src/boosting/rf.hpp:26):
bagging without shrinkage. The gradients are computed once, from the
constant boost-from-average score (RF::Boosting, rf.hpp:96-117); every tree
trains against them on its bag, and the model's output is the average over
iterations (average_output_, rf.hpp:29).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.log import log_fatal
from .gbdt import _KEPS, GBDT


class RF(GBDT):
    """reference: class RF (src/boosting/rf.hpp:26)."""

    def __init__(self, config, train_set, objective, training_metrics=()):
        super().__init__(config, train_set, objective, training_metrics)
        self.average_output = True
        self.shrinkage_rate = 1.0
        if train_set is not None:
            self._init_fixed_gradients()

    def _init_fixed_gradients(self) -> None:
        """RF::Boosting (rf.hpp:96): the gradients of the constant
        boost-from-average score, once for all iterations (zeros, not the
        Dataset's init_score, where it has one: rf.py:33-47)."""
        if self.objective is None:
            log_fatal("RF mode does not support custom objective functions, "
                      "please use built-in objectives")
        K = self.num_tree_per_iteration
        init_scores = np.zeros(K)
        if self.config.boost_from_average and not self._has_init_score:
            for k in range(K):
                init_scores[k] = self.objective.boost_from_score(k)
        self._init_scores = init_scores
        tmp = np.tile(np.asarray(init_scores, np.float32)[:, None],
                      (1, self.num_data))
        self._fixed_g, self._fixed_h = self._gradients(
            torch.from_numpy(tmp).to(self.device))

    # -- overrides ----------------------------------------------------
    def _boost_from_average(self) -> np.ndarray:
        # RF never folds a bias into trees or scores at the start
        return np.zeros(self.num_tree_per_iteration)

    def boost(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._fixed_g, self._fixed_h

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """After the base iteration, fold the boost-from-average bias into
        each new tree (rf.hpp:150-156 AddBias), and add it to the training
        and valid scores, so averaged predictions and the kept scores carry
        the init score. A tree still on the device carries the bias with it
        to its materialization, which adds it once, as the JAX package's
        add_bias on the host tree does."""
        ret = super().train_one_iter(grad, hess)
        K = self.num_tree_per_iteration
        for k in range(K):
            b = float(self._init_scores[k])
            if abs(b) > _KEPS and len(self._pending) + len(self._models) >= K:
                idx = len(self._pending) - K + k
                if idx >= 0:
                    tree, bias, lr = self._pending[idx]
                    self._pending[idx] = (tree, bias + b, lr)
                else:
                    self._models[idx].add_bias(b)
                self.scores[k] += float(np.float32(b))
                for vs in self._valid_scores:
                    vs[k] += float(np.float32(b))
        return ret

    def get_eval_result(self, metrics_per_set):
        """Metrics see the averaged scores (rf.hpp MultiplyScore)."""
        it = max(self.iter, 1)
        saved, saved_v = self.scores, list(self._valid_scores)
        self.scores = self.scores / it
        self._valid_scores = [v / it for v in saved_v]
        try:
            return super().get_eval_result(metrics_per_set)
        finally:
            self.scores, self._valid_scores = saved, saved_v
