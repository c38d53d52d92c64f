"""Compacted leaf-wise growth: the compact serial grower.

Counterpart of lightgbm_tpu/ops/grow_fast.py:grow_tree_fast (the
reference's DataPartition, data_partition.hpp:22, and its smaller-child
histogram with the sibling by subtraction, serial_tree_learner.cpp:344).
An `order` permutation keeps the rows grouped by leaf, each leaf a window
[leaf_start, leaf_start + leaf_count); splitting a leaf stably partitions
only its window, left rows first, and the smaller child's histogram is
the slot histogram (#1) over the window's rows. The larger child's
histogram is the parent's minus the smaller one's, in f32, as the JAX
package does.

The JAX package pads each window to a power-of-two bucket (`_bucket_sizes`)
because XLA needs static shapes, and masks the padded rows out. Here the
windows are exact: their starts and counts live in device tensors, the
partition (`window_partition`) and the smaller child's histogram (#1
over the window's row ids) read them from device memory, so a split's
work follows its window. The sums are those of the padded windows. The
split is ops/grow_batched.py:SerialStepper's, which batched training
replays with no read; `grow_tree_fast` drives it eagerly, one host read
a split.

As in the JAX package, the tree's leaf and internal counts and the counts
the children's searches read are the split search's synthesized counts
(cnt_factor), not the window counts; out-of-bag rows stay in the windows
and are masked out of the histograms.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .grow import DeviceTree, GrowConfig
from .histogram import HistPlan
from .split import FeatureMeta


def grow_tree_fast(
    X_t: torch.Tensor,            # [F, N] uint8 or uint16, feature-major
    grad: torch.Tensor,           # [N] f32
    hess: torch.Tensor,           # [N] f32
    in_bag: torch.Tensor,         # [N] f32
    meta: FeatureMeta,
    cfg: GrowConfig,
    feature_mask: Optional[torch.Tensor] = None,
    *,
    hist_plan: Optional[HistPlan] = None,
    plain: bool = False,
    dist=None,
) -> Tuple[DeviceTree, torch.Tensor]:
    """Compacted leaf-wise growth; the contract of ops/grow.py:grow_tree.
    Under `dist` each rank's windows hold its own rows and the smaller
    child's histogram is psum'd (grow_fast.py:92-104, :302)."""
    from .grow_batched import grow_tree_serial
    return grow_tree_serial(X_t, grad, hess, in_bag, meta, cfg, feature_mask,
                            compact=True, hist_plan=hist_plan, plain=plain,
                            dist=dist)
