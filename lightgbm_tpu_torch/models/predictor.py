"""Packed multi-tree host predictor.

Counterpart of lightgbm_tpu/models/predictor.py's PackedModel (the host
walk, without its prediction early stopping and single-row path); the
device predictors are later work (ROADMAP item A7).

The reference predicts by walking trees one at a time per row
(GBDT::PredictRaw, gbdt_prediction.cpp; Tree::Predict, tree.h:438). Here
all trees' node arrays are concatenated into flat "packed" arrays once,
then every (row, tree) pair walks in lockstep — one vectorized step per
tree level, over chunks of rows. Categorical and linear leaves are walked
too, so model files of the JAX package that hold them predict the same.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .tree import (Tree, MISSING_NAN, MISSING_ZERO, _CATEGORICAL_MASK,
                   _DEFAULT_LEFT_MASK, _KZERO_THRESHOLD)


class PackedModel:
    """Flat concatenation of a [start_it, end_it) slice of the model's
    trees, iteration-major (tree t = iteration t // K, class t % K)."""

    def __init__(self, trees: List[Tree], num_class_models: int):
        self.K = num_class_models
        self.T = len(trees)
        node_counts = [max(t.num_leaves - 1, 1) for t in trees]
        leaf_counts = [t.num_leaves for t in trees]
        self.node_start = np.zeros(self.T + 1, np.int64)
        np.cumsum(node_counts, out=self.node_start[1:])
        self.leaf_start = np.zeros(self.T + 1, np.int64)
        np.cumsum(leaf_counts, out=self.leaf_start[1:])
        M = int(self.node_start[-1])
        L = int(self.leaf_start[-1])
        self.split_feature = np.zeros(M, np.int32)
        self.threshold = np.zeros(M, np.float64)
        self.threshold_in_bin = np.zeros(M, np.int32)
        self.decision_type = np.zeros(M, np.int8)
        self.left_child = np.zeros(M, np.int32)
        self.right_child = np.zeros(M, np.int32)
        self.leaf_value = np.zeros(L, np.float64)
        # categorical bitsets, concatenated with per-tree offsets
        self.num_cat = sum(t.num_cat for t in trees)
        cb = [np.zeros(0, np.int32)]
        ct = [np.zeros(0, np.uint32)]
        self.cat_start = np.zeros(self.T, np.int32)      # into boundaries
        self.word_start = np.zeros(self.T, np.int32)     # into bitset words
        cat_off = word_off = 0
        self.single_leaf = np.array(
            [t.num_leaves <= 1 for t in trees], bool)
        for i, t in enumerate(trees):
            a, b = self.node_start[i], self.node_start[i + 1]
            m = t.num_leaves - 1
            if m > 0:
                self.split_feature[a:a + m] = t.split_feature
                self.threshold[a:a + m] = t.threshold
                self.threshold_in_bin[a:a + m] = t.threshold_in_bin
                self.decision_type[a:a + m] = t.decision_type
                self.left_child[a:a + m] = t.left_child
                self.right_child[a:a + m] = t.right_child
            la = self.leaf_start[i]
            self.leaf_value[la:la + t.num_leaves] = t.leaf_value
            self.cat_start[i] = cat_off
            self.word_start[i] = word_off
            if t.num_cat > 0:
                cb.append(np.asarray(t.cat_boundaries, np.int32))
                ct.append(np.asarray(t.cat_threshold, np.uint32))
                cat_off += t.num_cat + 1
                word_off += len(t.cat_threshold)
        self.cat_boundaries = np.concatenate(cb)
        self.cat_threshold = np.concatenate(ct)
        # linear leaves (tree.cpp AddPredictionToScore linear path): a
        # uniform representation — non-linear trees get const=leaf_value
        # with zero coefficients, so one ragged pass covers mixed models
        self.has_linear = any(t.is_linear for t in trees)
        if self.has_linear:
            self.leaf_const = np.zeros(L, np.float64)
            counts = np.zeros(L, np.int32)
            feat_flat: List[int] = []
            coef_flat: List[float] = []
            for i, t in enumerate(trees):
                la = self.leaf_start[i]
                if t.is_linear:
                    self.leaf_const[la:la + t.num_leaves] = t.leaf_const
                    for li in range(t.num_leaves):
                        cs = t.leaf_coeff[li]
                        counts[la + li] = len(cs)
                        feat_flat.extend(t.leaf_features[li])
                        coef_flat.extend(cs)
                else:
                    self.leaf_const[la:la + t.num_leaves] = t.leaf_value
            self.coef_count = counts
            self.coef_start = np.zeros(L + 1, np.int64)
            np.cumsum(counts, out=self.coef_start[1:])
            self.coef_feat = np.asarray(feat_flat, np.int64)
            self.coef_val = np.asarray(coef_flat, np.float64)
            self.max_coeffs = int(counts.max()) if L else 0

    # ------------------------------------------------------------------
    def _step(self, X, rows, node, tsel):
        """One lockstep level: X [n, F]; rows [n] row ids; node [n, S]
        LOCAL node ids (>=0 active, <0 leaf); tsel [S] tree indices.
        Returns next node matrix."""
        active = node >= 0
        gnode = np.maximum(node, 0) + self.node_start[tsel][None, :]
        f = self.split_feature[gnode]
        fval = X[rows[:, None], f].astype(np.float64)
        dt = self.decision_type[gnode]
        default_left = (dt & _DEFAULT_LEFT_MASK) != 0
        missing_type = (dt.astype(np.int32) >> 2) & 3
        nan_mask = np.isnan(fval)
        fval_n = np.where(nan_mask & (missing_type != MISSING_NAN), 0.0,
                          fval)
        is_missing = ((missing_type == MISSING_ZERO)
                      & (np.abs(fval_n) <= _KZERO_THRESHOLD)) | \
                     ((missing_type == MISSING_NAN) & nan_mask)
        go_left = np.where(is_missing, default_left,
                           fval_n <= self.threshold[gnode])
        if self.num_cat > 0:
            is_cat = (dt & _CATEGORICAL_MASK) != 0
            if is_cat.any():
                go_left = np.where(is_cat,
                                   self._cat_go_left(fval, gnode, tsel),
                                   go_left)
        nxt = np.where(go_left, self.left_child[gnode],
                       self.right_child[gnode])
        return np.where(active, nxt, node)

    def _cat_go_left(self, fval, gnode, tsel):
        valid = ~np.isnan(fval) & (fval >= 0)
        iv = np.where(valid, fval, 0).astype(np.int64)
        cat_idx = self.threshold_in_bin[gnode].astype(np.int64)
        cb_idx = np.clip(self.cat_start[tsel][None, :] + cat_idx, 0,
                         max(len(self.cat_boundaries) - 2, 0))
        starts = self.word_start[tsel][None, :] + self.cat_boundaries[cb_idx]
        sizes = self.cat_boundaries[cb_idx + 1] - self.cat_boundaries[cb_idx]
        in_range = valid & (iv < sizes.astype(np.int64) * 32)
        word = starts + np.minimum(iv // 32, np.maximum(sizes - 1, 0))
        bits = self.cat_threshold[np.clip(word, 0,
                                          len(self.cat_threshold) - 1)]
        return in_range & (((bits >> (iv % 32).astype(np.uint32)) & 1) == 1)

    def _leaves(self, X, rows, tsel):
        """Leaf VALUE matrix [n, S] for the selected trees."""
        n = rows.shape[0]
        S = tsel.shape[0]
        node = np.where(self.single_leaf[tsel][None, :],
                        -1, 0).astype(np.int32) * np.ones((n, 1), np.int32)
        for _ in range(64 * 1024):
            if not (node >= 0).any():
                break
            node = self._step(X, rows, node, tsel)
        leaf = ~node
        gl = self.leaf_start[tsel][None, :] + leaf
        if not self.has_linear:
            return self.leaf_value[gl]
        # linear leaves: const + sum(coeff * raw); any NaN in a used
        # feature falls back to the constant leaf_value (tree.cpp:144-152)
        base = self.leaf_const[gl]
        add = np.zeros_like(base)
        nan_found = np.zeros(base.shape, bool)
        nc = self.coef_count[gl]
        for j in range(self.max_coeffs):
            m = j < nc
            idx = np.clip(self.coef_start[gl] + j, 0,
                          max(len(self.coef_feat) - 1, 0))
            f = self.coef_feat[idx] if len(self.coef_feat) else idx
            v = X[rows[:, None], f].astype(np.float64)
            nan_found |= m & np.isnan(v)
            add += np.where(m, np.nan_to_num(v) * self.coef_val[idx], 0.0)
        return np.where(nan_found, self.leaf_value[gl], base + add)

    # ------------------------------------------------------------------
    def predict_margin(self, X: np.ndarray,
                       chunk: int = 8192) -> np.ndarray:
        """[K, N] f64 margins of X [N, F] raw features."""
        N = X.shape[0]
        K = self.K
        out = np.zeros((K, N), np.float64)
        tsel = np.arange(self.T)
        for c0 in range(0, N, chunk):
            rows = np.arange(c0, min(c0 + chunk, N))
            lv = self._leaves(X, rows, tsel)                  # [n, T]
            out[:, rows] = lv.reshape(len(rows), self.T // K, K) \
                .sum(axis=1).T
        return out
