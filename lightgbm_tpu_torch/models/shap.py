"""SHAP feature contributions (TreeSHAP).

Counterpart of lightgbm_tpu/models/shap.py, the analog of the reference's
PredictContrib path (Boosting::PredictContrib, include/LightGBM/
boosting.h:171; tree.cpp TreeSHAP): the polynomial-time TreeSHAP
recursion (Lundberg et al.) over each host Tree, float64 NumPy, no device
work, with internal / leaf counts as cover weights, exactly as the
reference does. Output: [N, K * (num_features + 1)]; the last column of
each class's block is the expected value.

The JAX package runs the recursion once per row. Here one recursion over
a tree carries every row at once: the path's features and zero fractions
are the same for all rows, only the one fractions and path weights are
per row ([N] arrays), and each operation is the JAX package's scalar one
elementwise, branch by branch (`np.where` picks the branch a row's scalar
code takes). A row's leaf contributions are then added in that row's own
visiting order (its hot child first at every node, as the per-row
recursion visits them), so the feature columns are the JAX package's bit
for bit, at a fraction of the per-row recursion's Python overhead.

One repair: a tree's expected value (`Tree.expected_value`) is the
leaf-COUNT weighted mean of its outputs, as the reference's
Tree::ExpectedValue (tree.cpp) and the path fractions weigh by count. The
JAX package weighs by the leaves' hessian sums, so its rows miss their raw
scores by that difference; here each row sums to its raw score.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .tree import _CATEGORICAL_MASK, _DEFAULT_LEFT_MASK

# rows a recursion carries at once (its leaf contributions are
# [leaves, rows, F + 1] f64)
ROW_CHUNK = 1024


class _Path:
    """The TreeSHAP path: per element a feature index and a zero fraction
    (shared by every row), a one fraction and a path weight ([N] f64)."""
    __slots__ = ("feature", "zero", "one", "pweight")

    def __init__(self, feature, zero, one, pweight):
        self.feature = feature
        self.zero = zero
        self.one = one
        self.pweight = pweight

    def extended(self, n: int, extra: int) -> "_Path":
        """A copy with `extra` blank elements appended (the recursion's
        per-node copy)."""
        z = np.zeros(n)
        return _Path(self.feature + [-1] * extra, self.zero + [0.0] * extra,
                     self.one + [z] * extra, self.pweight + [z] * extra)


def _extend_path(p: _Path, ud: int, zero: float, one: np.ndarray,
                 feature: int) -> None:
    p.feature[ud] = feature
    p.zero[ud] = zero
    p.one[ud] = one
    p.pweight[ud] = np.full(one.shape, 1.0 if ud == 0 else 0.0)
    for i in range(ud - 1, -1, -1):
        p.pweight[i + 1] = p.pweight[i + 1] \
            + one * p.pweight[i] * (i + 1) / (ud + 1)
        p.pweight[i] = zero * p.pweight[i] * (ud - i) / (ud + 1)


def _unwind_path(p: _Path, ud: int, pi: int) -> None:
    one, zero = p.one[pi], p.zero[pi]
    nz = one != 0
    nop = p.pweight[ud]
    for i in range(ud - 1, -1, -1):
        tmp = p.pweight[i]
        w_a = nop * (ud + 1) / ((i + 1) * one)
        nop_a = tmp - w_a * zero * (ud - i) / (ud + 1)
        w_b = tmp * (ud + 1) / (zero * (ud - i))
        p.pweight[i] = np.where(nz, w_a, w_b)
        nop = np.where(nz, nop_a, nop)
    for i in range(pi, ud):
        p.feature[i] = p.feature[i + 1]
        p.zero[i] = p.zero[i + 1]
        p.one[i] = p.one[i + 1]


def _unwound_path_sum(p: _Path, ud: int, pi: int) -> np.ndarray:
    one, zero = p.one[pi], p.zero[pi]
    nz = one != 0
    nop = p.pweight[ud]
    total = np.zeros(one.shape)
    for i in range(ud - 1, -1, -1):
        tmp = nop * (ud + 1) / ((i + 1) * one)
        add_b = p.pweight[i] / (zero * (ud - i) / (ud + 1))
        total = total + np.where(nz, tmp, add_b)
        nop = np.where(nz, p.pweight[i] - tmp * zero * (ud - i) / (ud + 1),
                       nop)
    return total


def _go_left(tree, X: np.ndarray, node: int) -> np.ndarray:
    """[N] bool: each row goes to the left child of `node` (the rules of
    Tree.predict, the JAX package's `_decide_children`)."""
    dt = int(tree.decision_type[node])
    fval = X[:, int(tree.split_feature[node])]
    if dt & _CATEGORICAL_MASK:
        return tree._cat_decision(fval, np.full(len(fval), node))
    mt = (dt >> 2) & 3
    fval = np.where(np.isnan(fval) & (mt != 2), 0.0, fval)
    missing = ((mt == 1) & (np.abs(fval) <= 1e-35)) \
        | ((mt == 2) & np.isnan(fval))
    return np.where(missing, bool(dt & _DEFAULT_LEFT_MASK),
                    fval <= tree.threshold[node])


def _node_count(tree, node: int) -> float:
    return max(float(tree.internal_count[node]), 1.0)


def _child_count(tree, child: int) -> float:
    if child < 0:
        return max(float(tree.leaf_count[~child]), 0.0)
    return max(float(tree.internal_count[child]), 0.0)


def _leaves_under(tree, node: int) -> int:
    if node < 0:
        return 1
    return _leaves_under(tree, int(tree.left_child[node])) \
        + _leaves_under(tree, int(tree.right_child[node]))


def _tree_shap(tree, X: np.ndarray, node: int, ud: int, parent: _Path,
               pzero: float, pone: np.ndarray, pfeature: int,
               offset: np.ndarray,
               out: Dict[int, Tuple[np.ndarray, List]]) -> None:
    """The recursion of the JAX package's `_tree_shap` over all rows; at
    each leaf, out[leaf] = (each row's position in its visiting order,
    [(feature, [N] contribution)])."""
    n = X.shape[0]
    p = parent.extended(n, 2)
    _extend_path(p, ud, pzero, pone, pfeature)
    if node < 0:
        leaf = ~node
        contrib = []
        for i in range(1, ud + 1):
            w = _unwound_path_sum(p, ud, i)
            contrib.append((p.feature[i], w * (p.one[i] - p.zero[i])
                            * tree.leaf_value[leaf]))
        out[leaf] = (offset, contrib)
        return

    left, right = int(tree.left_child[node]), int(tree.right_child[node])
    gl = _go_left(tree, X, node)
    w = float(_node_count(tree, node))
    left_zero = _child_count(tree, left) / w
    right_zero = _child_count(tree, right) / w
    in_zero, in_one = 1.0, np.ones(n)
    split = int(tree.split_feature[node])
    pi = 0
    while pi <= ud:
        if p.feature[pi] == split:
            break
        pi += 1
    if pi != ud + 1:
        in_zero, in_one = p.zero[pi], p.one[pi]
        _unwind_path(p, ud, pi)
        ud -= 1
    # the hot child gets the incoming one fraction, the cold one 0; a row
    # visits its hot child's leaves first
    nl, nr = _leaves_under(tree, left), _leaves_under(tree, right)
    _tree_shap(tree, X, left, ud + 1, p, left_zero * in_zero,
               np.where(gl, in_one, 0.0), split,
               offset + np.where(gl, 0, nr), out)
    _tree_shap(tree, X, right, ud + 1, p, right_zero * in_zero,
               np.where(gl, 0.0, in_one), split,
               offset + np.where(gl, nl, 0), out)


def _tree_phi(tree, X: np.ndarray, F: int) -> np.ndarray:
    """[N, F + 1] feature contributions of one tree (the last column
    unused), each row's terms added in its own visiting order, as the
    per-row recursion adds them."""
    n = X.shape[0]
    out: Dict[int, Tuple[np.ndarray, List]] = {}
    _tree_shap(tree, X, 0, 0, _Path([], [], [], []), 1.0, np.ones(n), -1,
               np.zeros(n, np.int64), out)
    L = len(out)
    dense = np.zeros((L, n, F + 1))
    at = np.empty((L, n), np.int64)           # at[position, row] = leaf
    rows = np.arange(n)
    for leaf, (pos, contrib) in out.items():
        at[pos, rows] = leaf
        for f, c in contrib:
            dense[leaf, :, f] = c
    phi = np.zeros((n, F + 1))
    for k in range(L):
        phi += dense[at[k], rows]
    return phi


def predict_contrib(gbdt, X: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1) -> np.ndarray:
    """[N, (F+1) * K] SHAP values (+ expected value column per class)."""
    # fail loudly, not silently: a linear tree's leaf value is a fitted
    # linear function of the features, so path-attribution TreeSHAP over
    # constant leaves would produce numbers that LOOK like SHAP values
    # but attribute none of the within-leaf linear term (the documented
    # known gap, README.md "Known gaps": linear_tree pred_contrib)
    linear = [i for i, t in enumerate(gbdt.models)
              if getattr(t, "is_linear", False)]
    if linear:
        raise ValueError(
            "pred_contrib (TreeSHAP) is not supported for linear trees: "
            f"tree(s) {linear[:8]}{'...' if len(linear) > 8 else ''} carry "
            "fitted leaf coefficients whose within-leaf contribution "
            "path-attribution cannot decompose; use predict() for values "
            "or retrain with linear_tree=false for attributions "
            "(README.md known gap)")
    X = np.asarray(X, dtype=np.float64)
    N = X.shape[0]
    F = gbdt.max_feature_idx_ + 1
    K = gbdt.num_tree_per_iteration
    total_iters = len(gbdt.models) // K
    end = total_iters if num_iteration <= 0 else min(
        total_iters, start_iteration + num_iteration)
    out = np.zeros((N, K, F + 1), dtype=np.float64)
    for it in range(start_iteration, end):
        for k in range(K):
            tree = gbdt.models[it * K + k]
            out[:, k, F] += tree.expected_value()
            if tree.num_leaves <= 1:
                continue
            for r0 in range(0, N, ROW_CHUNK):
                r1 = min(r0 + ROW_CHUNK, N)
                # the branch a row does not take may divide by zero
                with np.errstate(divide="ignore", invalid="ignore"):
                    phi = _tree_phi(tree, X[r0:r1], F)
                out[r0:r1, k, :F] += phi[:, :F]
    if K == 1:
        return out[:, 0, :]
    return out.reshape(N, K * (F + 1))
