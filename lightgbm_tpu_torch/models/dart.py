"""DART boosting (Dropouts meet Multiple Additive Regression Trees).

Counterpart of lightgbm_tpu/models/dart.py (reference:
src/boosting/dart.hpp:24). Each iteration drops a random subset of the
existing trees (weighted by tree weight unless uniform_drop), takes their
outputs out of the training scores before the gradients, and after the new
tree renormalizes the dropped trees by k / (k + 1) (or the xgboost_dart_mode
variant), patching the training and valid scores (dart.hpp Normalize).

The drop sets come from NumPy's RandomState(drop_seed) on the host, so they
are the JAX package's draw for draw. The score patches run on the scores'
device: each tree's leaves by the binned walk (ops/predict.py), kept per
tree, then the score update (#2) over the tree's f32 leaf values times the
f32 factor, which are the JAX package's f32 per-row products.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops.histogram import add_leaf_values_
from ..utils.log import log_debug, log_fatal
from .gbdt import GBDT


class DART(GBDT):
    """reference: class DART (src/boosting/dart.hpp:24)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if getattr(self, "_linear", False):
            log_fatal("boosting=dart with linear_tree is not supported "
                      "yet: DART's drop/normalize score patching assumes "
                      "constant leaf outputs")
        self._rng_drop = np.random.RandomState(self.config.drop_seed)
        self.tree_weight_: List[float] = []
        self.sum_weight_ = 0.0
        self._drop_index: List[int] = []
        self._leaf_cache = {}  # model idx -> (train leaves, [valid leaves])

    def _tree_leaves(self, mi: int):
        """Model `mi`'s leaf of every training and valid row, walked on the
        device once and kept (a grown tree's structure never changes)."""
        cached = self._leaf_cache.get(mi)
        if cached is None or len(cached[1]) != len(self.valid_sets):
            tree = self.models[mi]
            lt = self._tree_leaves_binned(tree, self._binned_features())
            lv = [self._tree_leaves_binned(tree, Xv)
                  for Xv in self._valid_Xt]
            self._leaf_cache[mi] = cached = (lt, lv)
        return cached

    def _patch(self, row: torch.Tensor, mi: int, factor: float,
               leaf: torch.Tensor) -> None:
        """row += f32(model mi's leaf values) * f32(factor) at each row's
        leaf, through the score update (#2)."""
        vals = np.asarray(self.models[mi].leaf_value, np.float32) \
            * np.float32(factor)
        add_leaf_values_(row, torch.from_numpy(vals).to(row.device), leaf)

    def _select_dropping_trees(self) -> None:
        """dart.hpp DroppingTrees:99-149."""
        cfg = self.config
        self._drop_index = []
        # max_drop <= 0 means unlimited (dart.hpp: size_t cast of max_drop
        # only caps when positive)
        drop_cap = cfg.max_drop if cfg.max_drop > 0 else 10**9
        if self._rng_drop.rand() < cfg.skip_drop:
            pass
        elif not cfg.uniform_drop:
            drop_rate = cfg.drop_rate
            if self.sum_weight_ > 0:
                inv_avg = len(self.tree_weight_) / self.sum_weight_
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate,
                                    cfg.max_drop * inv_avg / self.sum_weight_)
                for i in range(self.iter):
                    if self._rng_drop.rand() < \
                            drop_rate * self.tree_weight_[i] * inv_avg:
                        self._drop_index.append(i)
                        if len(self._drop_index) >= drop_cap:
                            break
        else:
            drop_rate = cfg.drop_rate
            if cfg.max_drop > 0 and self.iter > 0:
                drop_rate = min(drop_rate, cfg.max_drop / self.iter)
            for i in range(self.iter):
                if self._rng_drop.rand() < drop_rate:
                    self._drop_index.append(i)
                    if len(self._drop_index) >= drop_cap:
                        break

        # the dropped trees leave the training scores
        K = self.num_tree_per_iteration
        for i in self._drop_index:
            for k in range(K):
                mi = i * K + k
                self._patch(self.scores[k], mi, -1.0,
                            self._tree_leaves(mi)[0])
        k_drop = len(self._drop_index)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + k_drop)
        elif k_drop == 0:
            self.shrinkage_rate = cfg.learning_rate
        else:
            self.shrinkage_rate = cfg.learning_rate / (
                cfg.learning_rate + k_drop)

    def _normalize(self) -> None:
        """dart.hpp Normalize:161-199: each dropped tree goes back into the
        training scores at `factor` times its weight, the valid scores
        (which kept it) move by factor - 1, and the tree shrinks by
        `factor`."""
        cfg = self.config
        k = float(len(self._drop_index))
        if k == 0:
            return
        K = self.num_tree_per_iteration
        factor = k / (k + 1.0) if not cfg.xgboost_dart_mode \
            else k / (k + cfg.learning_rate)
        for i in self._drop_index:
            for kk in range(K):
                mi = i * K + kk
                lt, lv = self._tree_leaves(mi)
                for vi, leaf_v in enumerate(lv):
                    self._patch(self._valid_scores[vi][kk], mi,
                                factor - 1.0, leaf_v)
                self._patch(self.scores[kk], mi, factor, lt)
                self.models[mi].shrink(factor)
            if not cfg.uniform_drop:
                if not cfg.xgboost_dart_mode:
                    self.sum_weight_ -= self.tree_weight_[i] / (k + 1.0)
                    self.tree_weight_[i] *= k / (k + 1.0)
                else:
                    self.sum_weight_ -= self.tree_weight_[i] / (
                        k + cfg.learning_rate)
                    self.tree_weight_[i] *= k / (k + cfg.learning_rate)

    # -- overrides ----------------------------------------------------
    def train_one_iter(self, grad=None, hess=None) -> bool:
        self._select_dropping_trees()
        if self._drop_index:
            log_debug(f"DART: dropped {len(self._drop_index)} trees")
        ret = super().train_one_iter(grad, hess)
        if ret:
            return ret
        self._normalize()
        if not self.config.uniform_drop:
            self.tree_weight_.append(self.shrinkage_rate)
            self.sum_weight_ += self.shrinkage_rate
        return False

    def rollback_one_iter(self) -> None:
        """GBDT's rollback; the kept leaves of the trees removed go too."""
        super().rollback_one_iter()
        n = len(self.models)
        self._leaf_cache = {mi: v for mi, v in self._leaf_cache.items()
                            if mi < n}
