"""Packed multi-tree predictor: the host walk and the device predictors.

Counterpart of lightgbm_tpu/models/predictor.py: PackedModel (the host
walk and its single-row path, without prediction early stopping), its
device arrays for the serving engines, and the batch device predictor
`predict_margin_device` that Booster.predict takes for large f32 batches.

The reference predicts by walking trees one at a time per row
(GBDT::PredictRaw, gbdt_prediction.cpp; Tree::Predict, tree.h:438). Here
all trees' node arrays are concatenated into flat "packed" arrays once,
then every (row, tree) pair walks in lockstep — one vectorized step per
tree level, over chunks of rows. Categorical and linear leaves are walked
too, so model files of the JAX package that hold them predict the same.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

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
        # the deepest leaf of any tree: the step count of the device walks
        self.max_depth = max((int(t.leaf_depths().max()) for t in trees
                              if t.num_leaves > 1), default=0)
        self._device_arrays = {}
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
    def predict_single(self, x: np.ndarray) -> np.ndarray:
        """[K] margins for ONE row: all trees walk in lockstep, ~depth
        vectorized [T]-sized steps."""
        X = x.reshape(1, -1)
        rows = np.zeros(1, np.int64)
        lv = self._leaves(X, rows, np.arange(self.T))[0]  # [T]
        return lv.reshape(self.T // self.K, self.K).sum(axis=0)

    def device_arrays(self, device: torch.device):
        """The packed arrays on `device` for the device walk
        (ops/predict.py predict_margin_packed), uploaded ONCE per model
        version and device. Thresholds are f32-floored
        (``floor_threshold_f32``) so the device's single-precision compare
        routes f32 feature values exactly like the host's f64 walk."""
        device = torch.device(device)
        cached = self._device_arrays.get(device)
        if cached is not None:
            return cached
        if self.has_linear:
            raise ValueError("device serving path does not support "
                             "linear leaves; use the host path")
        from ..ops.predict import PackedDeviceArrays

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(device)
        pa = PackedDeviceArrays(
            node_start=i64(self.node_start[:-1]),
            leaf_start=i64(self.leaf_start[:-1]),
            split_feature=i64(self.split_feature),
            threshold=torch.from_numpy(
                floor_threshold_f32(self.threshold)).to(device),
            threshold_in_bin=i64(self.threshold_in_bin),
            decision_type=i64(self.decision_type),
            left_child=i64(self.left_child),
            right_child=i64(self.right_child),
            leaf_value=torch.from_numpy(
                self.leaf_value.astype(np.float32)).to(device),
            single_leaf=torch.from_numpy(self.single_leaf).to(device),
            cat_start=i64(self.cat_start),
            word_start=i64(self.word_start),
            cat_boundaries=i64(self.cat_boundaries),
            cat_threshold=i64(self.cat_threshold),
            num_cat=int(self.num_cat),
            depth=self.max_depth,
        )
        self._device_arrays[device] = pa
        return pa

    # ------------------------------------------------------------------
    def predict_margin(self, X: np.ndarray,
                       early_stop_margin: Optional[float] = None,
                       early_stop_freq: int = 10,
                       chunk: int = 8192) -> np.ndarray:
        """[K, N] f64 margins of X [N, F] raw features. With
        `early_stop_margin`, trees are consumed in groups of
        `early_stop_freq` iterations and a row whose margin clears the
        bound walks no later group (prediction_early_stop.cpp: binary
        |margin| at :30, multiclass top-1 minus top-2 at :14), as the JAX
        package's PackedModel.predict_margin."""
        N = X.shape[0]
        K = self.K
        n_iters = self.T // K
        out = np.zeros((K, N), np.float64)
        for c0 in range(0, N, chunk):
            rows = np.arange(c0, min(c0 + chunk, N))
            if early_stop_margin is None:
                lv = self._leaves(X, rows, np.arange(self.T))  # [n, T]
                out[:, rows] = lv.reshape(len(rows), n_iters, K) \
                    .sum(axis=1).T
                continue
            alive = rows
            acc = np.zeros((K, len(rows)), np.float64)
            for g0 in range(0, n_iters, early_stop_freq):
                g1 = min(g0 + early_stop_freq, n_iters)
                lv = self._leaves(X, alive, np.arange(g0 * K, g1 * K))
                local = np.searchsorted(rows, alive)
                acc[:, local] += lv.reshape(len(alive), g1 - g0, K) \
                    .sum(axis=1).T
                if g1 >= n_iters:
                    break
                m = acc[:, local]
                if K == 1:
                    go_on = np.abs(m[0]) < early_stop_margin
                else:
                    s = np.sort(m, axis=0)
                    go_on = (s[-1] - s[-2]) < early_stop_margin
                alive = alive[go_on]
                if alive.size == 0:
                    break
            out[:, rows] = acc
        return out


def linear_tree_indices(trees) -> List[int]:
    """Indices of the linear-leaf trees, which the paths that refuse them
    name in their error (JAX models/predictor.py:287-296)."""
    return [i for i, t in enumerate(trees)
            if getattr(t, "is_linear", False)]


def format_tree_indices(linear: List[int]) -> str:
    """'tree(s) [0, 3, 7]', the first 8, elided beyond (the refusals'
    shared phrasing)."""
    return (f"tree(s) {linear[:8]}"
            f"{'...' if len(linear) > 8 else ''}")


def floor_threshold_f32(t64: np.ndarray) -> np.ndarray:
    """The f64 thresholds floored to the largest f32 <= each: for f32
    feature values v, (v <= thr_f64) == (v <= thr_f32floor), so a device
    single-precision compare routes boundary rows exactly like the host's
    double-precision walk."""
    t64 = np.asarray(t64, np.float64)
    t32 = t64.astype(np.float32)
    over = t32.astype(np.float64) > t64
    t32[over] = np.nextafter(t32[over], np.float32(-np.inf))
    return t32


# ----------------------------------------------------------------------
# batch device predictor (Booster.predict's device route)
# ----------------------------------------------------------------------
# [rows, trees] elements a chunk of the walk holds per temporary
_WALK_CELLS = 1 << 24


def build_device_tables(trees: List[Tree], num_class_models: int,
                        device: torch.device):
    """The packed device arrays of `trees` for predict_margin_device
    (cacheable across calls while the model is unchanged)."""
    if any(getattr(t, "is_linear", False) for t in trees):
        raise ValueError("predict_margin_device does not support linear "
                         "leaves; use predict_margin")
    return (PackedModel(list(trees), num_class_models).device_arrays(device),
            num_class_models)


def device_tables_bytes(trees: List[Tree]) -> int:
    """Device memory of build_device_tables' arrays: per node five int64
    index fields, the int64 decision type and the f32 threshold; per leaf
    one f32; the categorical bitsets. (The JAX package's layout, a
    one-hot feature selector, also scaled with the feature count.)"""
    M = sum(max(t.num_leaves - 1, 1) for t in trees)
    L = sum(t.num_leaves for t in trees)
    words = sum(len(t.cat_threshold) + len(t.cat_boundaries)
                for t in trees if t.num_cat > 0)
    return M * (6 * 8 + 4) + L * 4 + len(trees) * 5 * 8 + words * 8


def predict_margin_device(trees: List[Tree], num_class_models: int,
                          X, chunk: int = 65536,
                          tables=None,
                          device: Optional[torch.device] = None
                          ) -> np.ndarray:
    """[K, N] f64 margins of X [N, F] float32 on the device. Counterpart
    of the JAX package's MXU predictor of the same name, which finds each
    row's leaf by exact one-hot contractions; the port finds the same leaf
    by the exact gather walk of ops/predict.py (no matmul, so no TF32
    question), then adds the trees' f32 leaf values one tree at a time in
    tree order, as the JAX predictor's scan does. Linear leaves are not
    supported (use the host path)."""
    from ..ops.predict import predict_leaves_packed
    K = num_class_models
    if tables is None:
        tables = build_device_tables(trees, K, device)
    pa = tables[0]
    dev = pa.leaf_value.device
    T = pa.node_start.shape[0]
    N = X.shape[0]
    Xd = torch.as_tensor(np.asarray(X, np.float32)) \
        if not isinstance(X, torch.Tensor) else X.to(torch.float32)
    rows = max(1, min(int(chunk), _WALK_CELLS // max(T, 1)))
    out = torch.empty((K, N), dtype=torch.float32, device=dev)
    for c0 in range(0, N, rows):
        xc = Xd[c0:c0 + rows].to(dev)
        lv = pa.leaf_value[predict_leaves_packed(pa, xc)]      # [n, T]
        for k in range(K):
            acc = torch.zeros(xc.shape[0], dtype=torch.float32, device=dev)
            for t in range(k, T, K):
                acc = acc + lv[:, t]
            out[k, c0:c0 + xc.shape[0]] = acc
    return out.cpu().numpy().astype(np.float64)
