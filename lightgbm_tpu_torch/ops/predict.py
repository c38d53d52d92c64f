"""Tree traversal over binned features on the device.

Counterpart of lightgbm_tpu/ops/predict.py:predict_leaf_binned (the
reference's Tree::GetLeaf with NumericalDecisionInner, tree.h:358-440):
every row walks the tree in lockstep, one vectorized step per level, until
all rows sit on a leaf. It updates the valid-set scores after each tree.
"""

from __future__ import annotations

import torch

from ..models.tree import MISSING_NAN, MISSING_ZERO
from .split import FeatureMeta


def predict_leaf_binned(split_feature: torch.Tensor,
                        threshold_bin: torch.Tensor,
                        default_left: torch.Tensor,
                        left_child: torch.Tensor, right_child: torch.Tensor,
                        num_leaves: int, X_t: torch.Tensor,
                        meta: FeatureMeta) -> torch.Tensor:
    """Leaf index per row ([N] int64) of one tree over X_t [F, N] binned."""
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
    for step in range(num_leaves - 1):    # depth <= num_leaves - 1
        nd = node.clamp(min=0)
        f = split_feature[nd]
        bin_v = X_t[f, rows].to(torch.int64)
        mt = mt_f[f]
        is_missing = ((mt == MISSING_ZERO) & (bin_v == db_f[f])) \
            | ((mt == MISSING_NAN) & (bin_v == nb_f[f] - 1))
        go_left = torch.where(is_missing, default_left[nd],
                              bin_v <= threshold_bin[nd])
        node = torch.where(node >= 0, torch.where(go_left, lc[nd], rc[nd]),
                           node)
        if step % 8 == 7 and not bool((node >= 0).any()):
            break
    return ~node
