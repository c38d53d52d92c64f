"""Grower configuration and the device-resident tree record.

Counterpart of the types in lightgbm_tpu/ops/grow.py (GrowConfig:49,
DeviceTree:205). Leaf/node numbering follows Tree::Split (src/io/tree.cpp):
internal node s is created by split s; the left child keeps leaf id p, the
right child becomes a new leaf; child pointers store ``~leaf`` for leaves.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .split import SplitHyperParams


class GrowConfig(NamedTuple):
    """Static grower configuration (the fields this port's wave grower
    reads; lightgbm_tpu's GrowConfig carries more regimes)."""
    num_leaves: int
    max_depth: int              # <= 0 means unlimited
    min_data_in_leaf: float
    min_sum_hessian_in_leaf: float
    lambda_l1: float
    lambda_l2: float
    max_delta_step: float
    min_gain_to_split: float
    path_smooth: float
    num_bins_padded: int        # B: padded bin axis
    # batched-order guard of the wave grower (config tpu_wave_gain_slack)
    wave_gain_slack: float = 0.0

    @property
    def hp(self) -> SplitHyperParams:
        return SplitHyperParams(
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian_in_leaf=self.min_sum_hessian_in_leaf,
            lambda_l1=self.lambda_l1,
            lambda_l2=self.lambda_l2,
            max_delta_step=self.max_delta_step,
            min_gain_to_split=self.min_gain_to_split,
            path_smooth=self.path_smooth,
        )


class DeviceTree(NamedTuple):
    """Grown tree, device-resident (analog of CUDATree, cuda_tree.hpp:29).
    M = num_leaves - 1 node slots, L leaf slots; `num_leaves` and
    `num_waves` are host ints."""
    num_leaves: int                # leaves actually grown
    split_feature: torch.Tensor    # [M] int64 inner feature index
    threshold_bin: torch.Tensor    # [M] int64
    default_left: torch.Tensor     # [M] bool
    split_gain: torch.Tensor       # [M] f32
    left_child: torch.Tensor       # [M] int32 (negative = ~leaf)
    right_child: torch.Tensor      # [M] int32
    internal_value: torch.Tensor   # [M] f32
    internal_weight: torch.Tensor  # [M] f32
    internal_count: torch.Tensor   # [M] int32
    leaf_value: torch.Tensor       # [L] f32 (pre-shrinkage)
    leaf_weight: torch.Tensor      # [L] f32
    leaf_count: torch.Tensor       # [L] int32
    split_parent_leaf: torch.Tensor  # [M] int64: the leaf each split divided
    num_waves: int                 # histogram waves used (diagnostic)
