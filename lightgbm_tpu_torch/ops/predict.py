"""Tree traversal on the device: binned (training) and raw (serving).

Counterpart of lightgbm_tpu/ops/predict.py (the reference's Tree::GetLeaf
with NumericalDecisionInner, tree.h:358-440): every row walks its tree in
lockstep, one vectorized step per level, until all rows sit on a leaf.
`predict_leaf_binned` runs over binned features for the valid-set scores
during training; `predict_margin_packed` runs the same lockstep walk over
RAW f32 features and the concatenated packed-tree arrays
(models/predictor.py PackedModel.device_arrays): the `device` serving
engine's scorer. The JAX package's `lax.while_loop` becomes a Python loop
of exactly the model's depth, so the host never reads a device flag per
level.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.tree import (MISSING_NAN, MISSING_ZERO, _CATEGORICAL_MASK,
                           _DEFAULT_LEFT_MASK, _KZERO_THRESHOLD)
from .split import FeatureMeta
from ..utils import bin_values, indexable_bins


def predict_leaf_binned(split_feature: torch.Tensor,
                        threshold_bin: torch.Tensor,
                        default_left: torch.Tensor,
                        left_child: torch.Tensor, right_child: torch.Tensor,
                        num_leaves: int, X_t: torch.Tensor,
                        meta: FeatureMeta,
                        split_is_cat: Optional[torch.Tensor] = None,
                        split_cat_bitset: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Leaf index per row ([N] int64) of one tree over X_t [F, N] binned
    (raw, unbundled features). A categorical node (`split_is_cat`) sends a
    row left when its bin's bit is set in `split_cat_bitset` [M, W] (32
    bits per int64 word)."""
    N = X_t.shape[1]
    dev = X_t.device
    if num_leaves <= 1:
        return torch.zeros(N, dtype=torch.int64, device=dev)
    rows = torch.arange(N, device=dev)
    mt_f = meta.missing_type.to(torch.int64)
    db_f = meta.default_bin.to(torch.int64)
    nb_f = meta.num_bins.to(torch.int64)
    lc, rc = left_child.to(torch.int64), right_child.to(torch.int64)
    # node >= 0: internal node to test; node < 0: arrived at leaf ~node
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    Xi = indexable_bins(X_t)
    for step in range(num_leaves - 1):    # depth <= num_leaves - 1
        nd = node.clamp(min=0)
        f = split_feature[nd]
        bin_v = bin_values(Xi[f, rows])
        mt = mt_f[f]
        is_missing = ((mt == MISSING_ZERO) & (bin_v == db_f[f])) \
            | ((mt == MISSING_NAN) & (bin_v == nb_f[f] - 1))
        go_left = torch.where(is_missing, default_left[nd],
                              bin_v <= threshold_bin[nd])
        if split_is_cat is not None:
            W = split_cat_bitset.shape[1]
            words = split_cat_bitset[nd, (bin_v >> 5).clamp(0, W - 1)]
            go_left = torch.where(split_is_cat[nd],
                                  ((words >> (bin_v & 31)) & 1) == 1,
                                  go_left)
        node = torch.where(node >= 0, torch.where(go_left, lc[nd], rc[nd]),
                           node)
        if step % 8 == 7 and not bool((node >= 0).any()):
            break
    return ~node


class PackedDeviceArrays(NamedTuple):
    """Packed multi-tree arrays on one device (flat concatenation over all
    T trees, models/predictor.py PackedModel layout). Index arrays are
    int64, `cat_threshold` holds the uint32 bitset words in int64.
    `depth` is the deepest leaf of any tree: the walk's step count."""
    node_start: torch.Tensor      # [T] node offset per tree
    leaf_start: torch.Tensor      # [T] leaf offset per tree
    split_feature: torch.Tensor   # [M]
    threshold: torch.Tensor       # [M] f32 (f32-floored f64 thresholds)
    threshold_in_bin: torch.Tensor  # [M] (categorical bitset index)
    decision_type: torch.Tensor   # [M]
    left_child: torch.Tensor      # [M] (negative = ~leaf)
    right_child: torch.Tensor     # [M]
    leaf_value: torch.Tensor      # [L] f32
    single_leaf: torch.Tensor     # [T] bool (stump trees start at leaf 0)
    cat_start: torch.Tensor       # [T] into cat_boundaries
    word_start: torch.Tensor      # [T] into cat_threshold words
    cat_boundaries: torch.Tensor
    cat_threshold: torch.Tensor
    num_cat: int
    depth: int


def predict_leaves_packed(pa: PackedDeviceArrays,
                          X: torch.Tensor) -> torch.Tensor:
    """[n, T] int64 ABSOLUTE leaf indices (into the flat `leaf_value`) of
    X [n, F] f32 raw features: every (row, tree) pair walks its tree in
    lockstep, `pa.depth` gather steps. Numeric, missing and categorical
    splits; f32 compares against f32-floored thresholds route f32 values
    exactly like the host's f64 walk."""
    n = X.shape[0]
    T = pa.node_start.shape[0]
    node = torch.where(pa.single_leaf, -1, 0).to(torch.int64) \
        .expand(n, T).contiguous()
    nan_x = torch.isnan(X)
    for _ in range(pa.depth):
        g = node.clamp(min=0) + pa.node_start[None, :]        # [n, T]
        f = pa.split_feature[g]
        fval = torch.gather(X, 1, f)
        nan_mask = torch.gather(nan_x, 1, f)
        dt = pa.decision_type[g]
        default_left = (dt & _DEFAULT_LEFT_MASK) != 0
        mt = (dt >> 2) & 3
        fval_n = torch.where(nan_mask & (mt != MISSING_NAN), 0.0, fval)
        is_missing = ((mt == MISSING_ZERO)
                      & (fval_n.abs() <= _KZERO_THRESHOLD)) | \
                     ((mt == MISSING_NAN) & nan_mask)
        go_left = torch.where(is_missing, default_left,
                              fval_n <= pa.threshold[g])
        if pa.num_cat > 0:
            go_left = torch.where((dt & _CATEGORICAL_MASK) != 0,
                                  _cat_go_left(pa, fval, nan_mask, g),
                                  go_left)
        nxt = torch.where(go_left, pa.left_child[g], pa.right_child[g])
        node = torch.where(node >= 0, nxt, node)
    return pa.leaf_start[None, :] + ~node


def _cat_go_left(pa: PackedDeviceArrays, fval, nan_mask, g):
    """Raw-category bitset test of the host walk
    (PackedModel._cat_go_left): NaN, negative and out-of-bitset values go
    right."""
    valid = ~nan_mask & (fval >= 0)
    iv = torch.where(valid, fval, 0.0).to(torch.int64)
    ncb = pa.cat_boundaries.shape[0]
    cb_idx = (pa.cat_start[None, :] + pa.threshold_in_bin[g]) \
        .clamp(0, max(ncb - 2, 0))
    starts = pa.word_start[None, :] + pa.cat_boundaries[cb_idx]
    sizes = pa.cat_boundaries[(cb_idx + 1).clamp(max=ncb - 1)] \
        - pa.cat_boundaries[cb_idx]
    in_range = valid & (iv < sizes * 32)
    word = starts + torch.minimum(iv >> 5, (sizes - 1).clamp(min=0))
    bits = pa.cat_threshold[
        word.clamp(0, max(pa.cat_threshold.shape[0] - 1, 0))]
    return in_range & (((bits >> (iv & 31)) & 1) == 1)


def sum_iterations(x: torch.Tensor) -> torch.Tensor:
    """[n, K] sums over the iteration axis of x [n, I, K]: a pairwise tree
    of elementwise adds over I padded with -0.0 to a power of two P. x +
    (-0.0) is x for every x, so zero-padded iterations past I fold away
    exactly, and an elementwise add does not depend on the tensor's shape
    (torch.sum's order depends on the reduced length and, on CUDA, on the
    number of outputs). A row's sum is therefore the same bits at any
    batch size and under any tail of padded iterations: what lets the
    fused cross-tenant walk (export/fusion.py) reproduce each tenant's own
    margins. The padding is never made: the tree's first level adds
    iteration i + P/2 to iteration i where i + P/2 < I and carries the
    other P - I iterations of the first half as they are (x + (-0.0))."""
    n, I, K = x.shape
    if I == 0:
        return x.new_zeros((n, K))
    h = (1 << (I - 1).bit_length()) // 2
    if 0 < h < I < 2 * h:
        r = I - h
        y = torch.empty((n, h, K), dtype=x.dtype, device=x.device)
        torch.add(x[:, :r], x[:, h:], out=y[:, :r])
        y[:, r:] = x[:, r:h]
        x = y
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def sum_leaf_values(lv: torch.Tensor, K: int) -> torch.Tensor:
    """[K, n] f32 margins from the [n, T] leaf values of one model, summed
    over its T // K iterations by ``sum_iterations`` (the JAX walks'
    ``lv.reshape(n, T // K, K).sum(axis=1)`` in a fixed order). Every
    engine of the port accumulates through this function, so engines that
    reach the same leaves give bitwise equal margins."""
    n, T = lv.shape
    return sum_iterations(lv.reshape(n, T // K, K)).t()


def predict_margin_packed(pa: PackedDeviceArrays, X: torch.Tensor,
                          K: int) -> torch.Tensor:
    """[K, n] f32 margins of X [n, F] f32 raw features (the device
    analog of PackedModel.predict_margin)."""
    gl = predict_leaves_packed(pa, X)
    return sum_leaf_values(pa.leaf_value[gl], K)
