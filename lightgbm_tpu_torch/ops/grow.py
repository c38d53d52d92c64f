"""Grower configuration, the device-resident tree record and the masked
serial grower.

Counterpart of lightgbm_tpu/ops/grow.py (GrowConfig:49, DeviceTree:205,
grow_tree:263). Leaf/node numbering follows Tree::Split (src/io/tree.cpp):
internal node s is created by split s; the left child keeps leaf id p, the
right child becomes a new leaf; child pointers store ``~leaf`` for leaves.

`grow_tree` is the reference's one-split-at-a-time loop
(SerialTreeLearner::Train, serial_tree_learner.cpp:222-240) with a
row -> leaf vector in place of index lists: each split takes the leaf of
largest cached gain, records node s, re-tags that leaf's rows and builds
both children's histograms in ONE pass over all rows, the slot histogram
(#1) at K = 2 with the leaf's left rows in slot 0, its right rows in slot
1 and every other row outside [0, 2). The JAX package runs the L - 1
splits inside a `fori_loop` that `lax.cond` skips once the tree is done.
The split itself is ops/grow_batched.py:SerialStepper's, which batched
training replays with no read; here `grow_tree` drives it eagerly and
reads whether another split would do work, one host read a split, and
stops at the first split that cannot be made (`done` is sticky there, so
the trees are the same).

Categorical left-sets are bin bitsets of W = ceil(B / 32) words. Torch has
no full-range uint32, so each word's 32 bits are held in an int64 (values
0 .. 2^32 - 1), the layout `PackedDeviceArrays.cat_threshold` uses too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .categorical import CatConfig, find_best_split_categorical
from .histogram import HistPlan, build_histogram, hist_route
from .split import (NEG_INF, FeatureMeta, SplitHyperParams, SplitResult,
                    find_best_split, synth_count_channel)


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
    # the wave grower in strict leaf-wise order (tpu_grower=wave_exact):
    # each wave applies what the serial growers' priority rule would, up
    # to the first leaf whose children are not yet speculated; the gain
    # slack is ignored (grow_wave.py:1215-1231, :1448)
    wave_exact: bool = False
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
    # multi-device training (parallel/, grow.py:GrowConfig): the ranks of
    # the process group a tree grows over (1: serial), the voting learner's
    # top_k (0: not voting), feature-parallel (every rank holds all rows
    # and histograms its own feature slice), and the histogram exchange
    # (parallel_hist_mode: "auto", "allreduce" or "reduce_scatter")
    n_shards: int = 1
    voting_top_k: int = 0
    feature_parallel: bool = False
    parallel_hist_mode: str = "auto"

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
    def wide_bins(self) -> bool:
        """More than 256 bins a storage column: the uint16 storage
        (data/dataset.py:_alloc_binned), which only the apply route's
        kernels (#1, #4) and the serial growers read; the JAX package's
        Pallas kernels refuse it (histogram.py:_use_pallas)."""
        return self.num_bins_padded > 256

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
    `num_waves` are host ints, or 0-dim device tensors in the records of
    batched training (ops/grow_batched.py), read only when a tree becomes
    a host Tree."""
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
    num_waves: int                 # histogram waves used (diagnostic;
    #                                0 on the serial growers)
    host_reads: int = 0            # device-to-host reads while growing


def empty_split_cache(L: int, dev) -> SplitResult:
    """[L] best-split records with gain -inf (no split)."""
    def z():
        return torch.zeros(L, dtype=torch.float32, device=dev)
    return SplitResult(
        gain=torch.full((L,), NEG_INF, dtype=torch.float32, device=dev),
        feature=torch.zeros(L, dtype=torch.int64, device=dev),
        threshold=torch.zeros(L, dtype=torch.int64, device=dev),
        default_left=torch.zeros(L, dtype=torch.bool, device=dev),
        left_sum_g=z(), left_sum_h=z(), left_count=z(),
        right_sum_g=z(), right_sum_h=z(), right_count=z(),
        left_output=z(), right_output=z())


def serial_hist_route(cfg: GrowConfig, num_storage_cols: int) -> str:
    """The histogram route of the serial growers: the `hist_route` of
    histogram_impl over the storage's bin counts ("fused", which has no
    plain-histogram form, routes as "auto"; JAX histogram.py:92-108)."""
    tiers = cfg.hist_tiers if len(cfg.hist_tiers) == num_storage_cols \
        else ()
    return hist_route(cfg.hist_impl, tiers)


def serial_search(hist2: torch.Tensor, sum_g: torch.Tensor,
                  sum_h: torch.Tensor, count: torch.Tensor,
                  out: torch.Tensor, meta: FeatureMeta, cfg: GrowConfig,
                  feature_mask: Optional[torch.Tensor]
                  ) -> Tuple[SplitResult, torch.Tensor, torch.Tensor]:
    """Best splits of n leaves from their [n, 2, F, B] (grad, hess)
    histograms: the count channel synthesized from the hessians
    (cnt_factor, feature_histogram.hpp:529,844), the numerical search,
    and with categorical features the bitset search, numeric winning ties
    (grow.py:374-390). Returns (SplitResult [n], is_cat [n], bitset
    [n, W])."""
    n = count.shape[0]
    hist = synth_count_channel(hist2, count, sum_h)
    num = find_best_split(hist, sum_g, sum_h, count, out, meta, cfg.hp,
                          feature_mask)
    if not cfg.has_categorical:
        return (num, torch.zeros(n, dtype=torch.bool, device=count.device),
                torch.zeros((n, cfg.cat_words), dtype=torch.int64,
                            device=count.device))
    catr, bits = find_best_split_categorical(
        hist, sum_g, sum_h, count, out, meta, cfg.hp, cfg.cat, feature_mask)
    use_cat = catr.gain > num.gain
    merged = SplitResult(*[torch.where(use_cat, cv, nv)
                           for cv, nv in zip(catr, num)])
    return merged, use_cat, torch.where(use_cat[:, None], bits, 0)


class SerialDist:
    """The serial growers' collective hooks over a process group (JAX
    grow.py:271-410, grow_fast.py:92-104), inert without one: the root's
    sums, the exact child counts and every histogram summed over the ranks
    (`psum`). Under an explicit parallel_hist_mode=reduce_scatter the
    masked grower exchanges each histogram by a psum_scatter of the
    feature-padded buffer instead, searches its rank's FeatureSlice and
    elects the winner with the order-encoded keys in the single-device
    scan order (numerical over categorical, then default direction, then
    feature: the full-search allreduce path's tie order) and one masked
    psum (parallel/packed.py). The compact grower always psums (its
    windows are the rank's own rows)."""

    def __init__(self, dist, cfg: GrowConfig, F: int, compact: bool):
        self.dist = dist if dist is not None and cfg.n_shards > 1 else None
        self.rs = (self.dist is not None and not compact
                   and cfg.parallel_hist_mode == "reduce_scatter"
                   and not cfg.bundled and not cfg.feature_parallel)
        self.fsl = None
        if self.rs:
            from ..parallel.data_parallel import FeatureSlice
            self.fsl = FeatureSlice.of(F, cfg.n_shards,
                                       self.dist.axis_index())

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.dist is None else self.dist.psum(x)

    def exchange(self, hist: torch.Tensor) -> torch.Tensor:
        """[..., F, B] local histograms -> summed ([..., Fs, B], the owned
        slice, under reduce_scatter)."""
        if not self.rs:
            return self.psum(hist)
        ax = hist.dim() - 2
        return self.dist.psum_scatter(self.fsl.pad(hist, ax), axis=ax)

    def search(self, hist2, sum_g, sum_h, count, out, meta: FeatureMeta,
               cfg: GrowConfig, feature_mask):
        """`serial_search` of the exchanged histograms: on the owned slice
        with the winner elected over the ranks under reduce_scatter."""
        if not self.rs:
            return serial_search(hist2, sum_g, sum_h, count, out, meta, cfg,
                                 feature_mask)
        from ..parallel.packed import masked_psum_record, pmax_winner_mask
        res, use_cat, bits = serial_search(
            hist2, sum_g, sum_h, count, out, self.fsl.meta(meta), cfg,
            self.fsl.take(feature_mask))
        res = res._replace(feature=res.feature + self.fsl.foff)
        mask = pmax_winner_mask(self.dist, res.gain, res.feature,
                                res.threshold, res.default_left, use_cat,
                                scan_order=True)
        return masked_psum_record(self.dist, mask, (res, use_cat, bits))


def split_go_left(X_t: torch.Tensor, bs: SplitResult, is_cat, bits,
                  meta: FeatureMeta, cfg: GrowConfig) -> torch.Tensor:
    """[N] bool: which rows of X_t go left under one split (its best `bs`,
    categorical flag and [W] bitset words), the wave grower's
    `dec_go_left` for n = 1 (grow_wave imports this module)."""
    from .grow_wave import dec_go_left
    return dec_go_left(X_t, bs.feature.reshape(1), bs.threshold.reshape(1),
                       bs.default_left.reshape(1), is_cat.reshape(1),
                       bits[None], meta, cfg)[0]


class _TreeRecord:
    """The root's tree record and per-leaf state, device arrays that
    SerialStepper.start copies into its own: the node records empty, leaf
    0 the root's sums and the cached best splits the root's."""

    def __init__(self, L: int, W: int, dev, root_g, root_h, root_c,
                 root_out, root_split: SplitResult, root_cat, root_bits):
        M = max(L - 1, 1)

        def zeros(n, dtype=torch.float32):
            return torch.zeros(n, dtype=dtype, device=dev)
        self.split_feature = zeros(M, torch.int64)
        self.threshold_bin = zeros(M, torch.int64)
        self.default_left = zeros(M, torch.bool)
        self.split_gain = zeros(M)
        self.left_child = zeros(M, torch.int32)
        self.right_child = zeros(M, torch.int32)
        self.internal_value = zeros(M)
        self.internal_weight = zeros(M)
        self.internal_count = zeros(M, torch.int32)
        self.split_parent_leaf = zeros(M, torch.int64)
        self.split_is_cat = zeros(M, torch.bool)
        self.split_cat_bitset = zeros((M, W), torch.int64)
        # leaf 0 stays 0.0 until a split sets it: a no-split tree is a
        # constant-zero tree (AsConstantTree(0), gbdt.cpp:443)
        self.leaf_value = zeros(L)
        self.leaf_weight = zeros(L)
        self.leaf_weight[0] = root_h
        self.leaf_count = zeros(L, torch.int32)
        self.leaf_count[0] = root_c.to(torch.int32)
        self.leaf_output = zeros(L)
        self.leaf_output[0] = root_out
        self.leaf_sum_g = zeros(L)
        self.leaf_sum_g[0] = root_g
        self.leaf_sum_h = zeros(L)
        self.leaf_sum_h[0] = root_h
        self.best = empty_split_cache(L, dev)
        for a, v in zip(self.best, root_split):
            a[0] = v[0]
        self.best_is_cat = zeros(L, torch.bool)
        self.best_is_cat[0] = root_cat[0]
        self.best_bitset = zeros((L, W), torch.int64)
        self.best_bitset[0] = root_bits[0]


def serial_root(X_t: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                in_bag: torch.Tensor, meta: FeatureMeta, cfg: GrowConfig,
                feature_mask: Optional[torch.Tensor], hroute: str,
                hist_plan: Optional[HistPlan], plain: bool,
                sd: Optional[SerialDist] = None):
    """The root of both serial growers (BeforeTrain, serial_tree_learner.
    cpp:292-342): (g, h, in-bag row indicator, root histogram [2, F, B]
    (the owned [2, Fs, B] slice under reduce_scatter), tree record with the
    root's best split). `sd`: the collective hooks (None: serial)."""
    sd = sd or SerialDist(None, cfg, 0, False)
    hp = cfg.hp
    g = grad.to(torch.float32) * in_bag
    h = hess.to(torch.float32) * in_bag
    # the in-bag ROW indicator for exact counts (GOSS amplification rides
    # only on g / h in the reference, goss.hpp)
    cnt_row = (in_bag > 0).to(torch.float32)
    root_g, root_h, root_c = sd.psum(torch.stack(
        [g.sum(), h.sum(), cnt_row.sum()])).unbind()
    root_out = (-torch.sign(root_g)
                * torch.clamp(torch.abs(root_g) - hp.lambda_l1, min=0.0)
                / (root_h + hp.lambda_l2))
    hist_root = sd.exchange(build_histogram(
        X_t, torch.stack([g, h]), cfg.num_bins_padded, impl=hroute,
        plan=hist_plan, plain=plain))                        # [2, F, B]
    root_split, root_cat, root_bits = sd.search(
        hist_root[None], root_g[None], root_h[None], root_c[None],
        root_out[None], meta, cfg, feature_mask)
    rec = _TreeRecord(cfg.num_leaves, cfg.cat_words, X_t.device, root_g,
                      root_h, root_c, root_out, root_split, root_cat,
                      root_bits)
    return g, h, cnt_row, hist_root, rec


def grow_tree(
    X_t: torch.Tensor,            # [F, N] uint8, feature-major
    grad: torch.Tensor,           # [N] f32
    hess: torch.Tensor,           # [N] f32
    in_bag: torch.Tensor,         # [N] f32 (0/1 bagging mask; GOSS weights)
    meta: FeatureMeta,
    cfg: GrowConfig,
    feature_mask: Optional[torch.Tensor] = None,  # [F] bool
    *,
    hist_plan: Optional[HistPlan] = None,
    plain: bool = False,
    dist=None,
) -> Tuple[DeviceTree, torch.Tensor]:
    """Grow one tree leaf-wise, one split at a time over all rows (the
    masked grower); returns (DeviceTree, leaf_of_row [N] int32).

    Each split: the leaf p of largest cached gain, node s recorded, the
    parent's pointer rewired, p's rows re-tagged (the right child is leaf
    s + 1), the children's exact in-bag counts (update_cnt,
    serial_tree_learner.cpp:796-799), then both children's histograms in
    one slot-histogram pass and their splits searched (SerialStepper's
    split, driven by grow_tree_serial). `hist_plan` is `make_hist_plan`'s
    plan of a row-wise histogram route (made here when not given);
    `plain=True` runs the kernels' plain versions on any device. `dist`
    (parallel.DistContext) grows the tree over the process group, each
    rank on its row block (`SerialDist`)."""
    from .grow_batched import grow_tree_serial
    return grow_tree_serial(X_t, grad, hess, in_bag, meta, cfg, feature_mask,
                            compact=False, hist_plan=hist_plan, plain=plain,
                            dist=dist)
