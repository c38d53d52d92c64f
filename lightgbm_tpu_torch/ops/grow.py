"""Grower configuration and the device-resident tree record.

Counterpart of the types in lightgbm_tpu/ops/grow.py (GrowConfig:49,
DeviceTree:205). Leaf/node numbering follows Tree::Split (src/io/tree.cpp):
internal node s is created by split s; the left child keeps leaf id p, the
right child becomes a new leaf; child pointers store ``~leaf`` for leaves.

Categorical left-sets are bin bitsets of W = ceil(B / 32) words. Torch has
no full-range uint32, so each word's 32 bits are held in an int64 (values
0 .. 2^32 - 1), the layout `PackedDeviceArrays.cat_threshold` uses too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .categorical import CatConfig
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
    # per-STORAGE-COLUMN bin counts in storage order and the histogram
    # implementation ("auto" | "legacy" | "tiered" | "tiered_hilo" |
    # "rowwise" | "rowwise_packed" | "fused"; config histogram_impl)
    hist_tiers: tuple = ()
    hist_impl: str = "auto"
    # the fused routes (histogram_impl="fused"): the feature-tile width
    # that sets the general kernel's wave width, and whether an
    # applies-only wave defers its relabel into the next fused launch
    fused_feature_tile: int = 32
    fused_relabel_fusion: bool = True
    # categorical split search (reference: config.h cat_* params)
    has_categorical: bool = False
    max_cat_to_onehot: int = 4
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    min_data_per_group: float = 100.0
    # search-side constraints: whether meta carries monotone directions /
    # interaction sets (they decide the fused route, grow_wave.py:300-309),
    # the monotone method ("basic" or "intermediate") and monotone_penalty
    has_monotone: bool = False
    has_interaction: bool = False
    monotone_method: str = "basic"
    monotone_penalty: float = 0.0
    # forced splits (meta.forced, forcedsplits_filename) and CEGB
    # (cost_effective_gradient_boosting.hpp): the penalty tradeoff *
    # (penalty_split * leaf count + coupled[f] on a feature's first use),
    # whether meta carries the coupled vector (grow_wave.py:424-428)
    has_forced: bool = False
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    has_cegb_coupled: bool = False
    # per-node column sampling and one random threshold per node and
    # feature (feature_fraction_bynode, extra_trees with extra_seed),
    # drawn from the tree's seed by the port's threefry
    # (grow_wave.py:657-682)
    feature_fraction_bynode: float = 1.0
    extra_trees: bool = False
    extra_seed: int = 6
    # quantized gradients (use_quantized_grad, grow_wave.py:381-404): int8
    # (grad, hess) with per-tree scales, exact int32 histograms descaled
    # for the search; stochastic rounding draws from the tree's seed;
    # quant_renew_leaf (quant_train_renew_leaf) refits the leaf values
    # from exact float leaf sums
    use_quantized_grad: bool = False
    num_grad_quant_bins: int = 4
    stochastic_rounding: bool = True
    quant_renew_leaf: bool = False
    # EFB (data/dataset.py:_build_bundles): X_t holds BUNDLE columns;
    # per-ORIGINAL-feature maps unpack them in the decision pass, and
    # meta.bundle_expand re-slices bundle histograms per feature at search
    # time. Empty tuples = no bundling.
    bundle_col: tuple = ()      # orig feature -> bundle column
    bundle_off: tuple = ()      # offset in the bundle, -1 = raw singleton
    bundle_nb: tuple = ()       # orig feature num_bin
    bundle_db: tuple = ()       # orig feature default bin

    @property
    def bundled(self) -> bool:
        return len(self.bundle_col) > 0

    @property
    def has_cegb(self) -> bool:
        return self.cegb_penalty_split > 0.0 or self.has_cegb_coupled

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

    @property
    def cat_words(self) -> int:
        """W: 32-bit words per bin bitset."""
        return max((self.num_bins_padded + 31) // 32, 1)

    @property
    def cat(self) -> CatConfig:
        return CatConfig(
            max_cat_to_onehot=self.max_cat_to_onehot,
            max_cat_threshold=self.max_cat_threshold,
            cat_l2=self.cat_l2,
            cat_smooth=self.cat_smooth,
            min_data_per_group=self.min_data_per_group,
            num_bitset_words=self.cat_words,
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
    split_is_cat: torch.Tensor     # [M] bool: categorical (bitset) split
    split_cat_bitset: torch.Tensor  # [M, W] int64 uint32 words: left bins
    num_waves: int                 # histogram waves used (diagnostic)
