"""Linear-tree leaf models: per-leaf ridge regressions on branch features.

A copy of lightgbm_tpu/models/linear.py (NumPy only, so the port keeps its
own): the fit runs on the host in f64 whatever the training device, and
the trainer uploads each tree's score delta once (models/gbdt.py
`_fit_and_apply_linear`).

Re-implementation of the reference's LinearTreeLearner::CalculateLinear
(src/treelearner/linear_tree_learner.cpp:183-345, Eigen solve at :345;
method of Eq. 3 in arXiv:1802.05640): after a tree is grown, every leaf
gets a linear model

    coeffs = -(X^T H X + lambda * I)^(-1) (X^T g)

fit over the leaf's in-bag rows, where X = [raw branch-feature values, 1],
H = diag(hessians), g = gradients. Rows containing NaN in any used feature
are excluded; leaves with fewer valid rows than coefficients keep their
constant output. Coefficients below kZeroThreshold are dropped (and their
features with them), matching the reference's sparsification.

Host-side by design: the solve is O(num_leaves * depth^3) — microseconds —
and the accumulation is one numpy pass over the leaf's rows; the reference
uses the identical host-Eigen structure around its device learners
(LinearTreeLearner templates over SerialTreeLearner AND GPUTreeLearner).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

_KZERO = 1e-35  # reference: common.h kZeroThreshold


def branch_features(tree) -> List[List[int]]:
    """Per-leaf sorted unique INNER feature ids along the root path
    (reference: Tree::branch_features via track_branch_features)."""
    n = tree.num_leaves
    out: List[List[int]] = [[] for _ in range(n)]
    if n <= 1:
        return out
    inner = np.asarray(tree.split_feature_inner, np.int32)
    stack = [(0, [])]
    while stack:
        node, path = stack.pop()
        path2 = path + [int(inner[node])]
        for child in (int(tree.left_child[node]), int(tree.right_child[node])):
            if child < 0:
                out[~child] = sorted(set(path2))
            else:
                stack.append((child, path2))
    return out


def fit_linear_models(
    tree,                      # host Tree (already shrunken by lr)
    raw: np.ndarray,           # [N, F_total] f32 raw feature values
    leaf_of_row: np.ndarray,   # [N] int32 (in-bag rows; -1 = exclude)
    grad: np.ndarray,          # [N] f32 (raw)
    hess: np.ndarray,          # [N] f32 (raw)
    in_bag: np.ndarray,        # [N] f32 in-bag multiplier (0 = out of bag)
    *,
    linear_lambda: float,
    shrinkage: float,          # lr already applied to tree.leaf_value
    numeric_inner: np.ndarray,  # [F_inner] bool: numerical (non-cat) feats
    inner_to_real: np.ndarray,  # [F_inner] int: inner -> raw column index
    is_first_tree: bool = False,
    leaf_features_inner: Optional[List[List[int]]] = None,  # refit reuse
    is_refit: bool = False,
    decay_rate: float = 0.9,
) -> np.ndarray:
    """Fit (or refit) the tree's linear leaves IN PLACE and return the
    per-row linear output `shrinkage * (const + coeffs . raw)` with the
    constant-leaf fallback for NaN rows — the training score delta
    (Tree::AddPredictionToScore linear path, tree.cpp:130-155).

    The fit solves on UNSHRUNKEN gradients (like the reference, which
    calls CalculateLinear before GBDT applies Shrinkage) and then scales
    the stored const/coeffs by `shrinkage` so the host tree stays
    consistently post-shrinkage."""
    n_leaves = tree.num_leaves
    tree.is_linear = True
    N = leaf_of_row.shape[0]

    if is_first_tree:
        # reference: the very first tree keeps constant outputs
        # (linear_tree_learner.cpp:252-257)
        tree.leaf_const = tree.leaf_value.copy()
        tree.leaf_features = [[] for _ in range(n_leaves)]
        tree.leaf_coeff = [[] for _ in range(n_leaves)]
        return tree.leaf_value[np.maximum(leaf_of_row, 0)] \
            * (leaf_of_row >= 0)

    if leaf_features_inner is None:
        leaf_features_inner = branch_features(tree)
    # numerical features only (linear_tree_learner.cpp:222-230)
    leaf_feats = [[f for f in feats if numeric_inner[f]]
                  for feats in leaf_features_inner]

    order = np.argsort(leaf_of_row, kind="stable")
    sorted_leaf = leaf_of_row[order]
    starts = np.searchsorted(sorted_leaf, np.arange(n_leaves))
    ends = np.searchsorted(sorted_leaf, np.arange(n_leaves), side="right")

    out = np.zeros(N, np.float64)
    # capture the PREVIOUS model before overwriting (refit decay blends
    # against it)
    old_const_arr = np.asarray(tree.leaf_const, np.float64).copy()
    old_feat_list = list(tree.leaf_features)
    old_coef_list = list(tree.leaf_coeff)
    tree.leaf_const = np.zeros(n_leaves, np.float64)
    new_features: List[List[int]] = []
    new_coeffs: List[List[float]] = []
    for li in range(n_leaves):
        rows = order[starts[li]:ends[li]]
        feats = leaf_feats[li]
        k = len(feats)
        cols = inner_to_real[feats] if k else np.zeros(0, np.int64)
        Xl = raw[np.ix_(rows, cols)].astype(np.float64) if k \
            else np.zeros((len(rows), 0))
        ok = ~np.isnan(Xl).any(axis=1) if k else np.ones(len(rows), bool)
        # the FIT sees only in-bag rows (reference leaf_map_ is built from
        # the bagged data partition); the OUTPUT covers every row
        bag = in_bag[rows] > 0
        fit_ok = ok & bag
        nz = int(fit_ok.sum())
        const_fallback = float(tree.leaf_value[li])
        if nz < k + 1:
            # not enough valid rows: constant leaf
            # (linear_tree_learner.cpp:333-343)
            if is_refit:
                old_const = float(old_const_arr[li])
                tree.leaf_const[li] = decay_rate * old_const \
                    + (1.0 - decay_rate) * const_fallback
            else:
                tree.leaf_const[li] = const_fallback
            new_features.append([])
            new_coeffs.append([])
            # scores must advance by what the refitted model will output
            # (the decay-blended const), not the pre-blend fallback
            out[rows] = tree.leaf_const[li]
            continue
        Xv = Xl[fit_ok]
        amp = in_bag[rows][fit_ok].astype(np.float64)
        g = grad[rows][fit_ok].astype(np.float64) * amp
        h = hess[rows][fit_ok].astype(np.float64) * amp
        Xe = np.concatenate([Xv, np.ones((nz, 1))], axis=1)  # [nz, k+1]
        XTHX = (Xe * h[:, None]).T @ Xe
        XTHX[np.arange(k), np.arange(k)] += linear_lambda
        XTg = Xe.T @ g
        try:
            coeffs = -np.linalg.solve(XTHX, XTg)
        except np.linalg.LinAlgError:
            coeffs = -np.linalg.pinv(XTHX) @ XTg
        # sparsify near-zero coefficients on a fresh fit; REFIT keeps the
        # full saved feature set (linear_tree_learner.cpp:363-373)
        keep = list(range(k)) if is_refit else \
            [j for j in range(k) if not (-_KZERO < coeffs[j] < _KZERO)]
        cvec = [float(coeffs[j]) * shrinkage for j in keep]
        fvec = [int(inner_to_real[feats[j]]) for j in keep]
        const = float(coeffs[k]) * shrinkage
        if is_refit:
            old_const = float(old_const_arr[li])
            old_coeffs = dict(zip(old_feat_list[li], old_coef_list[li]))
            cvec = [decay_rate * old_coeffs.get(f, 0.0)
                    + (1.0 - decay_rate) * c
                    for f, c in zip(fvec, cvec)]
            const = decay_rate * old_const + (1.0 - decay_rate) * const
        new_features.append(fvec)
        new_coeffs.append(cvec)
        tree.leaf_const[li] = const
        # training-score delta for this leaf's rows (NaN rows fall back
        # to the constant leaf output)
        if keep:
            kept_X = Xl[:, keep]
            lin = const + kept_X @ np.asarray(cvec)
            leaf_out = np.where(ok, lin, const_fallback)
        else:
            leaf_out = np.where(ok, const, const_fallback)
        out[rows] = leaf_out
    tree.leaf_features = new_features
    tree.leaf_coeff = new_coeffs
    return out


def linear_output_for_leaves(tree, raw: np.ndarray,
                             leaf: np.ndarray) -> np.ndarray:
    """Per-row output of a linear tree given precomputed leaf indices
    (training-time binned partition): const + coeffs . raw with the
    constant-leaf NaN fallback. Used to replay linear trees onto scores
    (continued training, rollback, valid-set replay)."""
    out = tree.leaf_const[leaf].astype(np.float64).copy()
    nan_found = np.zeros(raw.shape[0], bool)
    for li in range(tree.num_leaves):
        feats = tree.leaf_features[li]
        if not feats:
            continue
        rows = leaf == li
        if not rows.any():
            continue
        vals = raw[np.ix_(rows, feats)].astype(np.float64)
        bad = np.isnan(vals).any(axis=1)
        out[rows] += np.where(
            bad[:, None], 0.0,
            vals * np.asarray(tree.leaf_coeff[li])[None, :]).sum(axis=1)
        nan_found[np.flatnonzero(rows)[bad]] = True
    return np.where(nan_found, tree.leaf_value[leaf], out)
