"""Wave-pipelined leaf-wise tree growth.

Counterpart of lightgbm_tpu/ops/grow_wave.py:grow_tree_wave with the
default gain-slack batching, on the two routes the JAX package takes on its
accelerator (`wave_routes`):

  * "mega", the fused megakernel route (`use_mega`, grow_wave.py:287-290):
    at most 32 storage columns, no EFB bundles, no categorical features and
    a col-wise histogram_impl. One row sweep per wave (`wave_pass`, a
    Hopper kernel) relabels the rows of the applied splits and accumulates
    every candidate's smaller-child histogram; a wave with no candidates
    runs the relabel only (`wave_relabel`).
  * "apply", the wide / categorical / EFB route (`use_apply`,
    grow_wave.py:892-894, :1659-1689): every other dataset, and any width
    under histogram_impl rowwise / rowwise_packed. One kernel
    (`wave_apply`) decides each row under the wave's split records (EFB
    bundle unpacking and categorical bitsets included) and resolves its
    leaf membership, where the TPU route precomputes a [K, N] decision
    matrix (`dec_go_left`); the histogram runs as its own pass
    (`build_histogram_slots` on the route `hist_route` picks: the K-slot
    kernel, or the row-wise kernels).
  * "fused" and "fused_tiled", histogram_impl="fused" (`use_fused` /
    `use_fused_tiled`, grow_wave.py:300-309): the row pass of "mega"
    ("fused", `wave_pass_fused`) or of "apply" ("fused_tiled",
    `wave_pass_fused_tiled`) also searches both children of every
    candidate in the same call (ops/grow_fused.py); the categorical search
    of "fused_tiled" stays outside and merges by gain; its kernel reads
    the go-left bits of `dec_go_left`. On "fused_tiled" an applies-only
    wave defers its relabel into the next wave's launch as a pending pass
    (`fused_relabel_fusion`, grow_wave.py:1135-1139), flushed by
    `wave_apply` when no launch follows. `fused_veto_reasons` lists why
    a pinned "fused" takes "mega" or "apply" instead. Each fused route
    keeps the TPU kernel's own wave width (`fused_kcap`).

The algorithm is the JAX package's, restructured from one XLA program into
a Python loop over waves:

  1. APPLY: ready leaves with positive gain split in gain order (the
     gain-slack rule decides how many), trimmed to the leaf budget — pure
     [L]-array bookkeeping.
  2. SPECULATE: the top-K unready frontier leaves by cached gain become
     the wave's candidates.
  3. The row pass of the route relabels the rows and builds every
     candidate's smaller-child histogram. The larger child's histogram is
     parent minus smaller (BeforeFindBestSplit, serial_tree_learner.cpp:344).
  4. SEARCH: best splits of both children of every candidate, batched
     (ops/split.py, and ops/categorical.py when the data has categorical
     features; numeric wins ties), cached per leaf with their categorical
     flags and bitsets until the leaf is applied.

Under use_quantized_grad (grow_wave.py:381-404) the gradients become int8
with per-tree scales (`discretize_gradients`, stochastic rounding drawn
from the tree's seed by the port's threefry), every route's histograms are
exact int32, parent minus smaller child subtracts in int32, and the search
reads them descaled to f32; `quant_renew_leaf` then refits the leaf values
from exact float leaf sums (the slot histogram over a one-bin feature).

Three regimes take the two-pass routes only ("mega", "apply"; the fused
kernels are vetoed, as in the JAX package):

  * forced splits (meta.forced, grow_wave.py:431-439, :600-643,
    :1815-1825): a leaf whose cached best is its forced-table node's split
    outranks every other (key 3e18 - node id * 1e12, so forced nodes apply
    in BFS order), and its children continue the table; a forced split
    that cannot be made leaves the branch to normal growth;
  * CEGB (grow_wave.py:577-598): every search subtracts tradeoff *
    (penalty_split * count + coupled * (1 - used)) per feature, `used` the
    features split on so far (`cegb_used` from the earlier trees, then
    this tree's applied splits);
  * monotone `intermediate` (grow_wave.py:1201-1272, :1403-1438,
    :1767-1800): children bounded by their sibling's output, at most one
    split a wave among the leaves under a monotone node, every apply
    followed by a refresh of all bounds against the subtree outputs, and
    the leaves whose bounds moved re-searched as a third block of the
    wave's search before they speculate again.

The JAX package's `lax.while_loop` over waves becomes a Python loop that
reads two host scalars per wave (whether to go on plus the number of
splits to apply, then the candidate count, which picks the bucketed K,
with the stale leaves' count under `intermediate`); its `lax.switch` over
K buckets becomes a direct call with the bucketed K.
"""

from __future__ import annotations

import functools
import os
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..models.tree import MISSING_NAN, MISSING_ZERO
from .categorical import find_best_split_categorical
from .grow import DeviceTree, GrowConfig
from .grow_fused import (fused_feature_mask, pack_fused_meta,
                         pack_fused_scalars, unpack_fused_records)
from .histogram import (ROWWISE_IMPLS, HistPlan, build_histogram,
                        build_histogram_slots, hist_route, make_hist_plan,
                        wave_apply, wave_pass, wave_pass_fused,
                        wave_pass_fused_tiled, wave_relabel)
from .split import (NEG_INF, FeatureMeta, SplitResult, find_best_split,
                    find_best_split_and_forced, synth_count_channel,
                    threshold_l1)
from ..utils.random import PRNGKey, fold_in, split, uniform

MAX_WAVE_FEATURES = 32
# the one-bin storage of the leaf renewal's sums: every row adds into bin
# 0, so the histogram's bin count only sets the tile shape; from 65 bins
# on the slot histogram merges a warp's equal cells before its atomic,
# which is the whole of this histogram's work (all lanes of a warp of
# rows grouped by leaf hit one cell)
RENEW_BINS = 128


def _wave_buckets(L: int, kcap: int = 128) -> List[int]:
    """Slot-kernel sizes; the smallest bucket >= the wave's candidate count
    is launched (lightgbm_tpu/ops/grow_wave.py:83)."""
    kmax = min(kcap, max(L - 1, 1))
    ladder = (1, 2, 4, 8, 16, 32, 48, 64, 96)
    return [k for k in ladder if k < kmax] + [kmax]


def _kcap(budget: int) -> int:
    """A K cap from a VMEM budget in slots: the largest power of two at
    most `budget`, at most 128."""
    kcap = max(1 << (budget.bit_length() - 1), 1) if budget >= 1 else 1
    return min(kcap, 128)


def _bin_lane(num_bins_padded: int) -> int:
    """The TPU kernels' lane-padded bin width (histogram_pallas.py:65)."""
    return next((w for w in (32, 64, 128) if num_bins_padded <= w), 256)


def mega_kcap(num_bins_padded: int) -> int:
    """The widest wave of the megakernel route (grow_wave.py:328-338): the
    TPU kernel's output block bounds K by its VMEM budget. The cap decides
    how many splits a wave may apply and speculate, so the port keeps it to
    grow the same trees."""
    return _kcap(3_400_000 // (2 * 32 * _bin_lane(num_bins_padded) * 4))


def fused_kcap(num_bins_padded: int, tile: Optional[int] = None) -> int:
    """The widest wave of a fused route (grow_wave.py:310-338): the narrow
    kernel (tile None) halves the megakernel's budget, because it also
    holds the candidates' parent histograms; the feature-tiled kernel's
    budget is one tile of `tile` columns, halved the same way. 64 at
    B <= 64 on both with the default tile of 32; 16 at B = 256."""
    width = 32 if tile is None else tile
    return _kcap(3_400_000 // (2 * width * _bin_lane(num_bins_padded) * 4)
                 // 2)


def fused_veto_reasons(cfg: GrowConfig) -> List[str]:
    """Why no fused kernel runs for this configuration, empty when one does
    (grow_wave.py:96-139, for the regimes the port trains; the rest are
    refused before a tree grows). The JAX package's `no_tpu_pallas` has no
    counterpart: on a CPU tensor the fused routes run their kernels' plain
    versions."""
    reasons = []
    if cfg.hist_impl != "fused":
        reasons.append("histogram_impl=%s (not 'fused')" % cfg.hist_impl)
    if os.environ.get("LIGHTGBM_TPU_DISABLE_FUSED", "").lower() \
            in ("1", "true", "yes"):
        reasons.append("LIGHTGBM_TPU_DISABLE_FUSED")
    if cfg.bundled:
        reasons.append("efb_bundled")
    if cfg.has_forced:
        reasons.append("forced_splits")
    if cfg.has_cegb:
        reasons.append("cegb")
    if cfg.feature_fraction_bynode < 1.0:
        reasons.append("feature_fraction_bynode")
    if cfg.extra_trees:
        reasons.append("extra_trees")
    if cfg.has_monotone:
        if cfg.monotone_method == "intermediate":
            reasons.append("monotone_intermediate")
        if cfg.monotone_penalty > 0.0:
            reasons.append("monotone_penalty")
    return reasons


def wave_routes(cfg: GrowConfig, num_storage_cols: int) -> Tuple[str, str]:
    """(grow route, histogram route) of this configuration: "fused" or
    "fused_tiled" (histogram_impl="fused" with no veto), "mega" (with
    "slots") or "apply" with the `hist_route` of its histogram_impl, the
    JAX package's accelerator routes (grow_wave.py:287-309, :894)."""
    narrow = (not cfg.bundled and not cfg.has_categorical
              and num_storage_cols <= MAX_WAVE_FEATURES)
    if cfg.hist_impl == "fused" and not fused_veto_reasons(cfg):
        # quantized gradients and monotone and interaction constraints take
        # the general kernel, never the narrow one (grow_wave.py:302-309)
        general = (cfg.has_monotone or cfg.has_interaction
                   or cfg.use_quantized_grad)
        return ("fused" if narrow and not general else "fused_tiled"), \
            "slots"
    if narrow and cfg.hist_impl not in ROWWISE_IMPLS:
        return "mega", "slots"
    # per-storage-column bin counts that do not match the storage choose
    # the uniform layout (histogram.py:96)
    tiers = cfg.hist_tiers if len(cfg.hist_tiers) == num_storage_cols \
        else ()
    return "apply", hist_route(cfg.hist_impl, tiers)


def wave_buckets_for(cfg: GrowConfig, route: str) -> List[int]:
    """The K ladder of a route: the megakernel's or a fused kernel's VMEM
    cap, 128 on "apply" (grow_wave.py:310-347)."""
    B = cfg.num_bins_padded
    cap = {"mega": lambda: mega_kcap(B),
           "fused": lambda: fused_kcap(B),
           "fused_tiled": lambda: fused_kcap(B, cfg.fused_feature_tile),
           "apply": lambda: 128}[route]()
    return _wave_buckets(cfg.num_leaves, cap)


def discretize_gradients(g: torch.Tensor, h: torch.Tensor, num_bins: int,
                         stochastic: bool, seed: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 (grad, hess) of use_quantized_grad and their descale
    factors: ([2, N] int8, [2] f32 (grad scale, hess scale)), as
    grow_wave.py:381-404 (GradientDiscretizer::DiscretizeGradients,
    gradient_discretizer.cpp:72-162). Scales max|g| / (num_bins // 2) and
    max h / num_bins, at least 1e-30; values truncate toward zero after
    adding sign(g) * u to g / scale (u / 0.5 for the hessians), u the
    uniform draws of the split of PRNGKey(seed), or 0.5 without
    `stochastic`. The scales are tensors on g's device and every division
    divides by a tensor: torch on CUDA divides by a Python scalar as a
    multiply by its f32 reciprocal, not the IEEE quotient JAX computes."""
    dev = g.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)
    g_scale = torch.maximum(g.abs().max() / f32(num_bins // 2), f32(1e-30))
    h_scale = torch.maximum(h.max() / f32(num_bins), f32(1e-30))
    if stochastic:
        kg, kh = split(PRNGKey(seed))
        ug = uniform(kg, g.shape, dev)
        uh = uniform(kh, h.shape, dev)
    else:
        ug = uh = 0.5
    # sign(g) * u is exact, so a contracted multiply-add rounds the same
    g8 = torch.clamp(torch.trunc(g / g_scale + torch.sign(g) * ug),
                     -127, 127).to(torch.int8)
    h8 = torch.clamp(torch.trunc(h / h_scale + uh), 0, 127).to(torch.int8)
    return torch.stack([g8, h8]), torch.stack([g_scale, h_scale])


def renew_leaf_values(leaf_value: torch.Tensor, leaf_of_row: torch.Tensor,
                      g: torch.Tensor, h: torch.Tensor, num_leaves: int,
                      slots: int, hp, *, plain: bool = False
                      ) -> torch.Tensor:
    """quant_train_renew_leaf (RenewIntGradTreeOutput,
    gradient_discretizer.cpp:210; grow_wave.py:2126-2150): the leaf values
    of a tree of `num_leaves` leaves from the exact float sums of g / h
    over each leaf's rows, -threshold_l1(sum g) / (sum h + lambda_l2)
    clipped to max_delta_step; leaves with no hessian keep theirs. The
    sums are the slot histogram of [g, h] over a one-column storage whose
    rows all sit in bin 0, leaf ids as slots, `slots` leaves a call."""
    L = leaf_value.shape[0]
    N = g.shape[0]
    dev = g.device
    dummy = torch.zeros((1, N), dtype=torch.uint8, device=dev)
    fp2 = torch.stack([g, h])
    sums = []
    for off in range(0, L, slots):
        sl = torch.where((leaf_of_row >= off) & (leaf_of_row < off + slots),
                         leaf_of_row - off, -1).to(torch.int32)
        hs = build_histogram_slots(dummy, fp2, sl, slots, RENEW_BINS,
                                   plain=plain)
        sums.append(hs[:, :, 0, 0])                        # [slots, 2]
    sums = torch.cat(sums)[:L]
    sg, sh = sums[:, 0], sums[:, 1]
    lv = -threshold_l1(sg, hp.lambda_l1) / (sh + hp.lambda_l2)
    if hp.max_delta_step > 0:
        lv = torch.clamp(lv, -hp.max_delta_step, hp.max_delta_step)
    ok = (torch.arange(L, device=dev) < num_leaves) & (sh > 0.0) \
        & (num_leaves > 1)
    return torch.where(ok, lv, leaf_value)


class _Pending(NamedTuple):
    """An applies-only wave's deferred relabel on the "fused_tiled" route
    (the `pend_*` fields of grow_wave.py:_WaveState): its applied leaves,
    their splits and the first new leaf id; entry k's rows that go right
    move to leaf nl0 + k."""
    leaves: torch.Tensor
    feature: torch.Tensor
    threshold: torch.Tensor
    default_left: torch.Tensor
    is_cat: torch.Tensor
    bits: torch.Tensor
    nl0: int


def node_masks(key: torch.Tensor, n: int, F: int, fraction: float,
               device) -> torch.Tensor:
    """[n, F] bool feature_fraction_bynode masks (ColSampler::GetByNode,
    col_sampler.hpp:208; grow_wave.py:660-666): row i keeps the features
    whose uniform is at most the row's max(1, int(F * fraction))-th
    smallest, all of them when draws tie there (jax.lax.top_k's
    threshold). Row i is counters i * F .. i * F + F - 1 of the draw, so
    it does not depend on n."""
    k_keep = max(1, int(F * fraction))
    u = uniform(key, (n, F), device)
    return u <= torch.sort(u, dim=1).values[:, k_keep - 1:k_keep]


def xt_bins(key: torch.Tensor, n: int, num_bins: torch.Tensor
            ) -> torch.Tensor:
    """[n, F] int32 extra_trees thresholds, each uniform in
    [0, max(num_bin - 2, 1)) (grow_wave.py:677-682): the one bin of each
    feature whose threshold the search may take."""
    hi = torch.clamp(num_bins.to(torch.int32) - 2, min=1)
    u = uniform(key, (n, hi.shape[0]), hi.device)
    return torch.minimum((u * hi.to(torch.float32)).to(torch.int32), hi - 1)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k: the k largest, ties to the lower index."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _empty_split_cache(L: int, dev) -> SplitResult:
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


def _slack_guard(sel: torch.Tensor, gains: torch.Tensor, keyed: torch.Tensor,
                 j_iota: torch.Tensor, budget: int, L: int,
                 slack: float) -> torch.Tensor:
    """The gain-slack rule (grow_wave.py:1243-1258, :1448-1460): a leaf
    below slack * (best gain anywhere) waits, except for the top half of
    the selection, and only under leaf-budget pressure (always for
    L < 64)."""
    n = sel.sum()
    guard = gains >= slack * keyed.max()
    keep = guard | (j_iota < (n + 1) // 2)
    if L >= 64:
        keep = keep | ~(2 * n >= budget)
    return sel & keep


@functools.lru_cache(maxsize=16)
def _bundle_maps(col: tuple, off: tuple, nb: tuple, db: tuple,
                 device: torch.device,
                 dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """[4, F]: bundle column, offset (-1 = raw singleton), num_bin and
    default bin of every original feature."""
    return torch.tensor([col, off, nb, db], dtype=dtype, device=device)


def wave_bundle_map(cfg: GrowConfig,
                    device: torch.device) -> Optional[torch.Tensor]:
    """The wave_apply kernel's [4, F] int32 bundle map of EFB storage, None
    when every feature is its own storage column."""
    if not cfg.bundled:
        return None
    return _bundle_maps(cfg.bundle_col, cfg.bundle_off, cfg.bundle_nb,
                        cfg.bundle_db, device, torch.int32)


def pack_wave_cats(is_cat_app: Optional[torch.Tensor],
                   bits_app: Optional[torch.Tensor],
                   is_cat_cand: Optional[torch.Tensor],
                   bits_cand: Optional[torch.Tensor],
                   W: int) -> torch.Tensor:
    """[2, 128, 1 + W] int32: the applied (0) and candidate (1) entries'
    categorical flags, then their bitsets' W 32-bit words (the int64
    words of the split records, bit for bit); None for a side with no
    entries. Entries past a side's count are numeric with empty sets."""
    dev = next(t.device for t in (bits_app, bits_cand) if t is not None)
    cats = torch.zeros((2, 128, 1 + W), dtype=torch.int64, device=dev)
    for side, ic, bits in ((0, is_cat_app, bits_app),
                           (1, is_cat_cand, bits_cand)):
        if ic is not None:
            n = ic.shape[0]
            cats[side, :n, 0] = ic.to(torch.int64)
            cats[side, :n, 1:] = bits
    cats = torch.where(cats >= 1 << 31, cats - (1 << 32), cats)
    return cats.to(torch.int32)


def _split_rows(feat: torch.Tensor, thr: torch.Tensor, dl: torch.Tensor,
                meta: FeatureMeta) -> torch.Tensor:
    """[6, n] int32 wave-table rows of n splits: feature, threshold,
    default_left, and the feature's missing type, default bin and bin
    count."""
    return torch.stack([
        feat, thr, dl.to(torch.int64), meta.missing_type.to(torch.int64)[feat],
        meta.default_bin.to(torch.int64)[feat],
        meta.num_bins.to(torch.int64)[feat]]).to(torch.int32)


def dec_go_left(X_t: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                dl: torch.Tensor, iscat: torch.Tensor, bits: torch.Tensor,
                meta: FeatureMeta, cfg: GrowConfig) -> torch.Tensor:
    """[n, N] bool go-left of every row under each of n splits
    (grow_wave.py:896-929), the decision bits the general fused wave (#10)
    reads. X_t holds storage columns: with EFB a feature's
    bins are unpacked from its bundle column (FastFeatureBundling's
    inverse, dataset.cpp:251). A categorical split tests its bin bitset
    (bits [n, W], 32 bits per int64 word) as a gather from the [n, 32 W]
    bool table the words expand to; bins are below 32 W by construction.
    Intermediates stay uint8 / int16 / bool, plus the int32 flat index of
    the categorical gather."""
    F = meta.num_bins.shape[0]
    n = feat.shape[0]
    featc = feat.clamp(0, F - 1)
    if cfg.bundled:
        bm = _bundle_maps(cfg.bundle_col, cfg.bundle_off, cfg.bundle_nb,
                          cfg.bundle_db, X_t.device)[:, featc]
        src = X_t.index_select(0, bm[0]).to(torch.int16)
        off, nbf, dbf = (bm[i].to(torch.int16)[:, None] for i in (1, 2, 3))
        rb = src - off
        inr = (rb >= 0) & (rb < nbf - 1)
        unp = torch.where(inr, rb + (rb >= dbf).to(torch.int16), dbf)
        binv = torch.where(off < 0, src, unp)
    else:
        binv = X_t.index_select(0, featc)
    mt = meta.missing_type.to(torch.int64)[featc]
    db = meta.default_bin.to(torch.int64)[featc]
    nb = meta.num_bins.to(torch.int64)[featc]
    # the one bin that is "missing" under each split (-1: none)
    mbin = torch.where(mt == MISSING_ZERO, db,
                       torch.where(mt == MISSING_NAN, nb - 1,
                                   torch.full_like(db, -1)))
    gl = torch.where(binv == mbin[:, None], dl[:, None],
                     binv <= thr[:, None])
    if cfg.has_categorical:
        W = bits.shape[1]
        shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
        table = ((bits[:, :, None] >> shifts) & 1).to(torch.bool)
        base = torch.arange(n, dtype=torch.int32, device=X_t.device) * (32 * W)
        idx = base[:, None] + binv.to(torch.int32)
        gl_cat = table.reshape(-1).index_select(0, idx.reshape(-1))
        gl = torch.where(iscat[:, None], gl_cat.reshape(n, -1), gl)
    return gl


def _flush_pending(X_t: torch.Tensor, leaf_of_row: torch.Tensor,
                   pend: _Pending, meta: FeatureMeta, cfg: GrowConfig,
                   buckets: List[int], plain: bool) -> torch.Tensor:
    """Apply a deferred relabel that no fused launch will run: the wave_apply
    kernel with the pending applies as its applied entries. The JAX package
    computes the same in XLA (grow_wave.py:1619-1630, :2108-2120); with
    unique pending leaves its `hit` equals wave_apply's `inA == 1` rule."""
    n = pend.leaves.shape[0]
    Kd = next(k for k in buckets if k >= n)
    dev = X_t.device
    tbl = torch.full((16, 128), -1, dtype=torch.int32, device=dev)
    tbl[0, :n] = pend.leaves.to(torch.int32)
    tbl[1:7, :n] = _split_rows(pend.feature, pend.threshold,
                               pend.default_left, meta)
    tbl[15] = pend.nl0
    cats = (pack_wave_cats(pend.is_cat, pend.bits, None, None,
                           cfg.cat_words) if cfg.has_categorical else None)
    return wave_apply(X_t, leaf_of_row, tbl, cats,
                      wave_bundle_map(cfg, dev), Kd, cfg.num_leaves,
                      plain=plain)[0]


def grow_tree_wave(
    X_t: torch.Tensor,            # [F_storage, N] uint8, feature-major
    grad: torch.Tensor,           # [N] f32
    hess: torch.Tensor,           # [N] f32
    in_bag: torch.Tensor,         # [N] f32
    meta: FeatureMeta,
    cfg: GrowConfig,
    feature_mask: Optional[torch.Tensor] = None,
    *,
    hist_plan: Optional[HistPlan] = None,
    rng_seed: int = 0,
    cegb_used: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> Tuple[DeviceTree, torch.Tensor]:
    """Grow one tree; returns (DeviceTree, leaf_of_row [N] int32).

    With EFB, X_t holds the bundle columns and `meta` describes the
    original features. `hist_plan` is `make_hist_plan`'s plan of the
    row-wise routes (made here when not given). `rng_seed` (an int32)
    keys the quantized gradients' stochastic rounding.
    `rng_seed` also keys feature_fraction_bynode's masks
    (PRNGKey(rng_seed + 0x5EED)) and extra_trees' thresholds
    (PRNGKey(rng_seed * 31 + extra_seed)), folded with 0 at the root and
    with the wave count + 1 in the waves, as the JAX package's.
    `cegb_used` [F] bool marks the features earlier trees of the model
    split on: CEGB's coupled penalty charges only the others (all of them
    when None).
    `plain=True` runs the kernels' plain PyTorch versions on any device."""
    dev = X_t.device
    F_st, N = X_t.shape
    F = meta.num_bins.shape[0]
    route, hroute = wave_routes(cfg, F_st)
    if hroute != "slots" and hist_plan is None:
        hist_plan = make_hist_plan(X_t, hroute, cfg.hist_tiers)
    L = cfg.num_leaves
    M = max(L - 1, 1)
    B = cfg.num_bins_padded
    W = cfg.cat_words
    hp = cfg.hp
    has_cat = cfg.has_categorical
    max_depth = cfg.max_depth if cfg.max_depth > 0 else 10 ** 9
    slack = cfg.wave_gain_slack
    buckets = wave_buckets_for(cfg, route)
    KMAX = buckets[-1]

    g = grad.to(torch.float32) * in_bag
    h = hess.to(torch.float32) * in_bag
    cnt_row = (in_bag > 0).to(torch.float32)
    root_g, root_h, root_c = g.sum(), h.sum(), cnt_row.sum()
    quant = cfg.use_quantized_grad
    if quant:
        # int8 values, exact int32 histograms (grow_wave.py:381-404); the
        # root sums above stay the float sums
        vals0, ch_scale = discretize_gradients(
            g, h, cfg.num_grad_quant_bins, cfg.stochastic_rounding,
            rng_seed)
        # the general fused kernel takes the factors as launch arguments
        scale_args = (tuple(ch_scale.tolist()) if route == "fused_tiled"
                      else None)
    else:
        vals0 = torch.stack([g, h], dim=0)                   # [2, N] f32
        ch_scale = scale_args = None
    C = 2

    def to_f32(hist):
        """Descale [n, C, F, B] int32 sums (grow_wave.py:409-413)."""
        if quant:
            return hist.to(torch.float32) * ch_scale[:, None, None]
        return hist

    # search-side constraints (grow_wave.py:422-423, :718): monotone
    # `basic` bounds per leaf, interaction sets per leaf, monotone_penalty
    has_mono = meta.monotone is not None
    has_inter = meta.inter_sets is not None
    use_mpen = has_mono and cfg.monotone_penalty > 0.0
    # monotone `intermediate` (grow_wave.py:717-757, :1201-1272,
    # :1403-1438, :1767-1800): children bounded by their sibling's output,
    # at most one split a wave under a monotone node, and the bounds
    # refreshed after every apply, with an own re-search of the leaves
    # whose bounds moved
    mono_inter = has_mono and cfg.monotone_method == "intermediate"
    S = meta.inter_sets.shape[0] if has_inter else 1
    # forced splits (meta.forced) and CEGB (grow_wave.py:424-428)
    has_forced = meta.forced is not None
    has_cegb = cfg.has_cegb
    feat_used = (cegb_used.clone() if cegb_used is not None
                 else torch.zeros(F, dtype=torch.bool, device=dev))

    def sel_key(gain, is_forced, fid):
        """The wave's selection key (grow_wave.py:431-439): a leaf whose
        best is its forced split outranks every other, forced nodes in BFS
        order, 3e18 - fid * 1e12 in f32; the stored gain stays the real
        one (ForceSplits walks its queue first, serial_tree_learner.cpp:
        628)."""
        if not has_forced:
            return gain
        return torch.where(is_forced, 3e18 - fid.to(torch.float32) * 1e12,
                           gain)

    def cegb_penalty(count):
        """[n, F] CEGB penalties of n leaves of `count` rows
        (DeltaGain, cost_effective_gradient_boosting.hpp:81;
        grow_wave.py:577-598): tradeoff * (penalty_split * count +
        coupled * (1 - used)), `used` the features split on so far, in this
        tree and before it. As in the JAX package, and not the reference's
        UpdateLeafBestSplits, leaves searched before a feature's first use
        keep the penalized gains they cached."""
        pen = (cfg.cegb_tradeoff * cfg.cegb_penalty_split) * count[:, None]
        if meta.cegb_coupled is not None:
            pen = pen + (cfg.cegb_tradeoff * meta.cegb_coupled
                         * (1.0 - feat_used.to(torch.float32)))
        return pen.expand(count.shape[0], F)
    # per-node draws (grow_wave.py:657-682): int32 seeds, wrapped as
    # PRNGKey wraps them
    bynode = cfg.feature_fraction_bynode < 1.0
    xt = cfg.extra_trees
    bn_base = PRNGKey(rng_seed + 0x5EED) if bynode else None
    xt_base = PRNGKey(rng_seed * 31 + cfg.extra_seed) if xt else None

    def node_draws(step: int, n: int, rows: torch.Tensor):
        """(bynode masks, extra_trees bins) of the rows `rows` of draw
        `step`, which has n rows (1 at the root, step 0; in the waves step
        the wave count + 1 and a row per slot of the [2 KMAX] search batch,
        left children first: grow_wave.py:1829, :1870-1873, :1967-1970);
        None where the regime is off."""
        fm = (node_masks(fold_in(bn_base, step), n, F,
                         cfg.feature_fraction_bynode, dev)[rows]
              if bynode else None)
        rb = xt_bins(fold_in(xt_base, step), n, meta.num_bins)[rows] \
            if xt else None
        return fm, rb

    def and_masks(a, b):
        return b if a is None else (a if b is None else a & b)

    def sets_to_fmask(sets):
        """[n, S] satisfiable sets -> [n, F] allowed features, with the
        column-sampling mask (grow_wave.py:531-536)."""
        m = (meta.inter_sets[None, :, :] & sets[:, :, None]).any(dim=1)
        return m if feature_mask is None else m & feature_mask

    def child_sets(bsx, psets):
        """The parent's sets that contain the split feature, for both
        children (grow_wave.py:709-715)."""
        return psets & meta.inter_sets.t()[bsx.feature]

    def mpen_factor(depth):
        """monotone_penalty's gain factor by leaf depth
        (ComputeMonotoneSplitGainPenalty, monotone_constraints.hpp:358;
        grow_wave.py:720-731)."""
        pen, eps = cfg.monotone_penalty, 1e-15
        d = depth.to(torch.float32)
        if pen <= 1.0:
            f = 1.0 - pen / torch.exp2(d) + eps
        else:
            f = 1.0 - torch.exp2(pen - 1.0 - d) + eps
        return torch.where(pen >= d + 1.0, torch.full_like(f, eps), f)

    def child_bounds(bsx, pmin, pmax):
        """The children's bounds after the splits `bsx` of leaves bounded
        by [pmin, pmax]: the `basic` rule separates them at the midpoint
        of the clipped outputs (BasicLeafConstraints::Update,
        monotone_constraints.hpp:330), `intermediate` bounds each child by
        its sibling's output (IntermediateLeafConstraints::
        UpdateConstraintsWithOutputs, :548; grow_wave.py:733-757)."""
        mono_f = meta.monotone[bsx.feature]
        if mono_inter:
            lcap, rcap = bsx.right_output, bsx.left_output
        else:
            lcap = rcap = 0.5 * (bsx.left_output + bsx.right_output)
        lmax = torch.where(mono_f > 0, torch.minimum(pmax, lcap), pmax)
        rmin = torch.where(mono_f > 0, torch.maximum(pmin, rcap), pmin)
        lmin = torch.where(mono_f < 0, torch.maximum(pmin, lcap), pmin)
        rmax = torch.where(mono_f < 0, torch.minimum(pmax, rcap), pmax)
        return lmin, lmax, rmin, rmax

    def refresh_bounds(n_leaves):
        """Refresh every leaf's intermediate bounds against the current
        outputs under each monotone node, the batched fixpoint of the
        reference's GoUpToFindLeavesToUpdate (monotone_constraints.hpp:
        625; grow_wave.py:1403-1438): for an increasing split at node s,
        each leaf of its left subtree is capped above by the least output
        of its right subtree and each leaf of its right subtree below by
        the largest of its left, the other way round for a decreasing
        one. A leaf whose bounds moved by more than 1e-12 leaves the ready
        set and is marked stale until its own best is searched again."""
        act = torch.arange(L, device=dev) < n_leaves
        inf = torch.full((), torch.inf, device=dev)
        o_min = torch.where(act, leaf_output, inf)[:, None]
        o_max = torch.where(act, leaf_output, -inf)[:, None]
        u_l, u_r = under == 1, under == 2                    # [L, M]
        lmax_n = torch.where(u_l, o_max, -inf).amax(dim=0)   # [M]
        rmin_n = torch.where(u_r, o_min, inf).amin(dim=0)
        lmin_n = torch.where(u_l, o_min, inf).amin(dim=0)
        rmax_n = torch.where(u_r, o_max, -inf).amax(dim=0)
        node_act = torch.arange(M, device=dev) < n_leaves - 1
        mono_n = torch.where(node_act, meta.monotone[split_feature],
                             0)[None, :]
        capmax = torch.where((mono_n > 0) & u_l, rmin_n[None, :],
                             torch.where((mono_n < 0) & u_r,
                                         lmin_n[None, :], inf))
        capmin = torch.where((mono_n > 0) & u_r, lmax_n[None, :],
                             torch.where((mono_n < 0) & u_l,
                                         rmax_n[None, :], -inf))
        new_max = capmax.amin(dim=1)                         # [L]
        new_min = capmin.amax(dim=1)
        moved = act & (((new_min - leaf_min).abs() > 1e-12)
                       | ((new_max - leaf_max).abs() > 1e-12))
        leaf_min.copy_(new_min)
        leaf_max.copy_(new_max)
        ready.logical_and_(~moved)
        stale.logical_or_(moved)

    def children_constraints(bsx, leaves):
        """What the search of both children of the candidates `leaves`
        (best splits `bsx`) reads, left children first: (bounds min,
        bounds max, feature mask [2n, F] or the global one, penalty
        factor); None where the regime is off."""
        bmin = bmax = mpf = None
        fm = feature_mask
        if has_mono:
            lmin, lmax, rmin, rmax = child_bounds(bsx, leaf_min[leaves],
                                                  leaf_max[leaves])
            bmin, bmax = torch.cat([lmin, rmin]), torch.cat([lmax, rmax])
        if has_inter:
            allow = sets_to_fmask(child_sets(bsx, leaf_sets[leaves]))
            fm = torch.cat([allow, allow])
        if use_mpen:
            d = leaf_depth[leaves] + 1
            mpf = mpen_factor(torch.cat([d, d]))
        return bmin, bmax, fm, mpf

    def fused_operands(bsx, leaves, sil):
        """The fused scan's per-child scalars [7, 2K] (with the monotone
        bounds, grow_wave.py:1573-1583) and feature masks [2K, F] (the
        interaction sets', :1586-1599) of the K candidates `leaves`."""
        bmin, bmax, fm, _ = children_constraints(bsx, leaves)
        scal = pack_fused_scalars(bsx, sil, bmin, bmax)
        if has_inter:
            return scal, fm.to(torch.uint8).contiguous()
        return scal, fused_feature_mask(feature_mask, F, dev,
                                        2 * leaves.shape[0])

    def search(hist2, sum_g, sum_h, count, out, num=None, bmin=None,
               bmax=None, fmask=None, mpf=None, rand_bins=None, fid=None):
        """Best splits of n histograms [n, C, F_st, B] of storage columns:
        (SplitResult [n], is_cat [n], bitset [n, W], forced [n]). `num` is
        the numeric search's result when a fused kernel already ran it;
        hist2 is then read only for the categorical search. bmin / bmax
        [n] are the monotone bounds, fmask the feature mask ([F] or
        [n, F]), mpf [n] monotone_penalty's factor, rand_bins [n, F]
        extra_trees' one threshold a feature (numeric features only, as in
        JAX), fid [n] the leaves' forced-node ids (-1: none): a forced
        split that can be made replaces the best, and `forced` marks it
        (grow_wave.py:600-643)."""
        n = count.shape[0]
        unforced = torch.zeros(n, dtype=torch.bool, device=dev)
        if num is not None and not has_cat:
            return (num, unforced,
                    torch.zeros((n, W), dtype=torch.int64, device=dev),
                    unforced)
        if cfg.bundled:
            # EFB: re-slice the bundle histogram per original feature and
            # rebuild each feature's default bin as parent - sum(others)
            # (Dataset::FixHistogram, dataset.h:778; grow_wave.py:542-554)
            flat = hist2.reshape(n, C, -1)
            flat = torch.cat([flat, flat.new_zeros((n, C, 1))], dim=-1)
            hist2 = to_f32(flat.index_select(-1, meta.bundle_expand)
                           .reshape(n, C, F, B))
            parent = torch.stack([sum_g, sum_h], dim=-1)      # [n, C]
            miss = parent[:, :, None] - hist2.sum(dim=-1)     # [n, C, F]
            hist2 = hist2 + meta.bundle_mfb * miss[..., None]
        else:
            hist2 = to_f32(hist2)
        hist = synth_count_channel(hist2, count, sum_h)       # [n, 3, F, B]
        pen = cegb_penalty(count) if has_cegb else None
        fres = None
        if num is None and has_forced:
            # one gain map gives the normal best and the forced cell's
            fc = fid.clamp(0, meta.forced.shape[1] - 1)
            num, fres = find_best_split_and_forced(
                hist, sum_g, sum_h, count, out, meta, hp, fmask, bmin, bmax,
                meta.forced[0, fc], meta.forced[1, fc], cegb_pen=pen,
                rand_bins=rand_bins, mono_pen_factor=mpf)
        elif num is None:
            num = find_best_split(hist, sum_g, sum_h, count, out, meta, hp,
                                  fmask, leaf_min=bmin, leaf_max=bmax,
                                  mono_pen_factor=mpf, rand_bins=rand_bins,
                                  cegb_pen=pen)
        if has_cat:
            catres, bits = find_best_split_categorical(
                hist, sum_g, sum_h, count, out, meta, hp, cfg.cat, fmask,
                leaf_min=bmin, leaf_max=bmax, cegb_pen=pen)
            # numeric wins ties (grow_wave.py:629)
            use_cat = catres.gain > num.gain
            merged = SplitResult(*[torch.where(use_cat, cv, nv)
                                   for cv, nv in zip(catres, num)])
            bits = torch.where(use_cat[:, None], bits, 0)
        else:
            merged, use_cat = num, unforced
            bits = torch.zeros((n, W), dtype=torch.int64, device=dev)
        if fres is None:
            return merged, use_cat, bits, unforced
        use_f = (fid >= 0) & torch.isfinite(fres.gain)
        merged = SplitResult(*[torch.where(use_f, fv, mv)
                               for fv, mv in zip(fres, merged)])
        return (merged, use_cat & ~use_f,
                torch.where(use_f[:, None], 0, bits), use_f)

    # ---- root
    root_out = (-torch.sign(root_g)
                * torch.clamp(torch.abs(root_g) - hp.lambda_l1, min=0.0)
                / (root_h + hp.lambda_l2))
    hist_root = build_histogram(X_t, vals0, B, impl=hroute, plan=hist_plan,
                                plain=plain)                 # [2, F_st, B]
    one = torch.ones(1, dtype=torch.float32, device=dev)
    root_fmask = (sets_to_fmask(torch.ones((1, S), dtype=torch.bool,
                                           device=dev))
                  if has_inter else feature_mask)
    root_bn, root_rb = node_draws(0, 1, torch.zeros(1, dtype=torch.int64,
                                                    device=dev))
    # the forced table's node 0 is the root's (grow_wave.py:771)
    root_fid = torch.full((1,), 0 if has_forced else -1, dtype=torch.int64,
                          device=dev)
    root_split, root_cat, root_bits, root_forced = search(
        hist_root[None], root_g[None], root_h[None], root_c[None],
        root_out[None], bmin=-torch.inf * one if has_mono else None,
        bmax=torch.inf * one if has_mono else None,
        fmask=and_masks(root_fmask, root_bn),
        mpf=mpen_factor(0 * one) if use_mpen else None, rand_bins=root_rb,
        fid=root_fid)
    if max_depth < 1:
        root_split = root_split._replace(
            gain=torch.full_like(root_split.gain, NEG_INF))
        root_forced = torch.zeros_like(root_forced)

    def zeros(n, dtype=torch.float32):
        return torch.zeros(n, dtype=dtype, device=dev)

    # tree record; child arrays carry one extra trailing slot that absorbs
    # the rewiring writes of entries whose parent is the root
    split_feature = zeros(M, torch.int64)
    threshold_bin = zeros(M, torch.int64)
    default_left = zeros(M, torch.bool)
    split_gain = zeros(M)
    left_child = zeros(M + 1, torch.int32)
    right_child = zeros(M + 1, torch.int32)
    internal_value = zeros(M)
    internal_weight = zeros(M)
    internal_count = zeros(M, torch.int32)
    split_parent_leaf = zeros(M, torch.int64)
    split_is_cat = zeros(M, torch.bool)
    split_cat_bitset = zeros((M, W), torch.int64)
    # leaf 0 stays 0.0 until a split sets it: a no-split tree is a
    # constant-zero tree (AsConstantTree(0), gbdt.cpp:443)
    leaf_value = zeros(L)
    leaf_weight = zeros(L)
    leaf_weight[0] = root_h
    leaf_count = zeros(L, torch.int32)
    leaf_count[0] = root_c.to(torch.int32)

    # per-leaf grower state
    leaf_of_row = zeros(N, torch.int32)
    leaf_parent_node = torch.full((L,), -1, dtype=torch.int64, device=dev)
    leaf_is_left = zeros(L, torch.bool)
    leaf_depth = zeros(L, torch.int64)
    leaf_output = zeros(L)
    leaf_output[0] = root_out
    leaf_sum_g = zeros(L)
    leaf_sum_g[0] = root_g
    leaf_sum_h = zeros(L)
    leaf_sum_h[0] = root_h
    leaf_min = torch.full((L,), -torch.inf, device=dev)
    leaf_max = torch.full((L,), torch.inf, device=dev)
    leaf_sets = torch.ones((L, S), dtype=torch.bool, device=dev)
    # int32 under quantized gradients (grow_wave.py:1027, :1108)
    hist_cache = torch.zeros((L, C * hist_root[0].numel()),
                             dtype=hist_root.dtype, device=dev)
    hist_cache[0] = hist_root.reshape(-1)
    small_hist = torch.zeros_like(hist_cache)
    small_is_left = zeros(L, torch.bool)
    ready = zeros(L, torch.bool)
    best = _empty_split_cache(L, dev)
    for a, v in zip(best, root_split):
        a[0] = v[0]
    best_is_cat = zeros(L, torch.bool)
    best_is_cat[0] = root_cat[0]
    best_bitset = zeros((L, W), torch.int64)
    best_bitset[0] = root_bits[0]
    bestl = _empty_split_cache(L, dev)
    bestr = _empty_split_cache(L, dev)
    catl, catr = zeros(L, torch.bool), zeros(L, torch.bool)
    bitsl, bitsr = zeros((L, W), torch.int64), zeros((L, W), torch.int64)
    # forced splits: each leaf's forced-node id (-1: none), whether its
    # cached best is that forced split, and the same for the speculated
    # children (grow_wave.py:215-221)
    leaf_forced = torch.full((L,), -1, dtype=torch.int64, device=dev)
    leaf_forced[0] = root_fid[0]
    best_forced = zeros(L, torch.bool)
    best_forced[0] = root_forced[0]
    fidl = torch.full((L,), -1, dtype=torch.int64, device=dev)
    fidr = fidl.clone()
    bfl, bfr = zeros(L, torch.bool), zeros(L, torch.bool)
    # monotone intermediate: `under[l, s]` is 1 / 2 when leaf l lies in the
    # left / right subtree of node s, and `stale` marks the leaves whose
    # bounds moved since their own best was searched (grow_wave.py:222-226)
    under = zeros((L, M), torch.int8) if mono_inter else None
    stale = zeros(L, torch.bool)

    bundle_map = wave_bundle_map(cfg, dev)
    j_iota = torch.arange(KMAX, device=dev)
    num_leaves, num_waves = 1, 0
    fused = route in ("fused", "fused_tiled")
    if fused:
        fmeta = pack_fused_meta(meta)
        fmask = fused_feature_mask(feature_mask, F, dev)
    # the deferred relabel of an applies-only wave ("fused_tiled")
    fusion = route == "fused_tiled" and cfg.fused_relabel_fusion
    pend: Optional[_Pending] = None

    while L > 1:
        im_leaf = None
        if mono_inter:
            # leaves under a monotone node already in the tree: their
            # applications serialize (grow_wave.py:1201-1211)
            node_act = torch.arange(M, device=dev) < num_leaves - 1
            mono_n = torch.where(node_act, meta.monotone[split_feature], 0)
            im_leaf = ((under != 0) & (mono_n != 0)[None, :]).any(dim=1)
        # ---- ORDER: ready leaves with positive gain split in gain order
        keyed = sel_key(best.gain, best_forced, leaf_forced)
        budget = L - num_leaves
        rg, rl = _top_k(torch.where(ready, keyed,
                                    torch.full_like(keyed, NEG_INF)), KMAX)
        sel = (rg > 0.0) & (j_iota < budget)
        if slack > 0.0:
            sel = _slack_guard(sel, rg, keyed, j_iota, budget, L, slack)
        if mono_inter:
            # intermediate bounds come from the siblings' outputs, which
            # move as splits land: among the leaves under a monotone node
            # or splitting on a monotone feature, only the first in gain
            # order applies this wave (grow_wave.py:1259-1271)
            ser = im_leaf | (meta.monotone[best.feature] != 0)
            sel_mono = sel & ser[rl]
            first = (torch.cumsum(sel_mono.to(torch.int32), 0) == 1) \
                & sel_mono
            sel = sel & (~sel_mono | first)
            # the selection need not be a prefix now: the applied entries
            # are the selected ones, in gain order
            rl = rl[torch.sort((~sel).to(torch.int8), stable=True).indices]
        napp, go_on = torch.stack([sel.sum(),
                                   (keyed.max() > 0.0).to(torch.int64)]
                                  ).tolist()
        if num_leaves >= L or not go_on:
            break
        nl0 = num_leaves
        tbl = torch.full((16, 128), -1, dtype=torch.int32, device=dev)
        tbl[15] = nl0

        # ---- APPLY (the applied leaves lead the gain order)
        if napp > 0:
            pa = rl[:napp]
            s_idx = torch.arange(nl0 - 1, nl0 - 1 + napp, device=dev)
            r_idx = torch.arange(nl0, nl0 + napp, device=dev)
            bs2 = SplitResult(*[x[pa] for x in best])
            iscat2, bits2 = best_is_cat[pa], best_bitset[pa]
            bl = [x[pa] for x in bestl]
            br = [x[pa] for x in bestr]
            cl, cr, bil, bir = catl[pa], catr[pa], bitsl[pa], bitsr[pa]
            iv, iw, ic = leaf_output[pa], leaf_sum_h[pa], leaf_count[pa]
            prev, was_left = leaf_parent_node[pa], leaf_is_left[pa]
            depth_child = leaf_depth[pa] + 1
            hsm = small_hist[pa]
            hlg = hist_cache[pa] - hsm
            sil = small_is_left[pa][:, None]
            # the children's constraints, from the parents' before the
            # writes below (grow_wave.py:1358-1363)
            if has_mono:
                almin, almax, armin, armax = child_bounds(
                    bs2, leaf_min[pa], leaf_max[pa])
                leaf_min[pa], leaf_min[r_idx] = almin, armin
                leaf_max[pa], leaf_max[r_idx] = almax, armax
            if has_inter:
                asets = child_sets(bs2, leaf_sets[pa])
                leaf_sets[pa], leaf_sets[r_idx] = asets, asets
            if mono_inter:
                # the children inherit the parent's subtree membership and
                # join the new node's sides (grow_wave.py:1369-1378)
                pu = under[pa]
                newcol = torch.arange(M, device=dev)[None, :] \
                    == s_idx[:, None]
                under[pa] = torch.where(newcol, 1, pu).to(torch.int8)
                under[r_idx] = torch.where(newcol, 2, pu).to(torch.int8)
            if has_cegb:
                feat_used[bs2.feature] = True

            split_feature[s_idx] = bs2.feature
            threshold_bin[s_idx] = bs2.threshold
            default_left[s_idx] = bs2.default_left
            split_gain[s_idx] = bs2.gain
            left_child[s_idx] = (~pa).to(torch.int32)
            right_child[s_idx] = (~r_idx).to(torch.int32)
            internal_value[s_idx] = iv
            internal_weight[s_idx] = iw
            internal_count[s_idx] = ic
            split_parent_leaf[s_idx] = pa
            split_is_cat[s_idx] = iscat2
            split_cat_bitset[s_idx] = bits2
            # rewire the parent node's child pointer (~p -> s); siblings
            # may split in the same wave, so each side writes its own array
            fix = prev >= 0
            s32 = s_idx.to(torch.int32)
            left_child[torch.where(fix & was_left, prev, M)] = s32
            right_child[torch.where(fix & ~was_left, prev, M)] = s32

            for arr, lv, rv in ((leaf_value, bs2.left_output,
                                 bs2.right_output),
                                (leaf_weight, bs2.left_sum_h,
                                 bs2.right_sum_h),
                                (leaf_count, bs2.left_count.to(torch.int32),
                                 bs2.right_count.to(torch.int32)),
                                (ready, False, False),
                                (leaf_parent_node, s_idx, s_idx),
                                (leaf_is_left, True, False),
                                (leaf_depth, depth_child, depth_child),
                                (leaf_output, bs2.left_output,
                                 bs2.right_output),
                                (leaf_sum_g, bs2.left_sum_g,
                                 bs2.right_sum_g),
                                (leaf_sum_h, bs2.left_sum_h,
                                 bs2.right_sum_h),
                                (best_is_cat, cl, cr),
                                (best_bitset, bil, bir),
                                (leaf_forced, fidl[pa], fidr[pa]),
                                (best_forced, bfl[pa], bfr[pa])):
                arr[pa] = lv
                arr[r_idx] = rv
            hist_cache[pa] = torch.where(sil, hsm, hlg)
            hist_cache[r_idx] = torch.where(sil, hlg, hsm)
            for a, lv, rv in zip(best, bl, br):
                a[pa] = lv
                a[r_idx] = rv
            num_leaves += napp

            tbl[0, :napp] = pa.to(torch.int32)
            tbl[1:7, :napp] = _split_rows(bs2.feature, bs2.threshold,
                                          bs2.default_left, meta)
            if mono_inter:
                refresh_bounds(num_leaves)

        # ---- SPECULATE: top-K unready frontier leaves by gain (a stale
        # leaf waits for its own re-search)
        budget2 = L - num_leaves
        keyed2 = sel_key(best.gain, best_forced, leaf_forced)
        gains, cand = _top_k(torch.where(ready | stale,
                                         torch.full_like(keyed2, NEG_INF),
                                         keyed2), KMAX)
        valid = (gains > 0.0) & (j_iota < budget2)
        if slack > 0.0:
            valid = _slack_guard(valid, gains, keyed2, j_iota, budget2, L,
                                 slack)
        bs = SplitResult(*[x[cand] for x in best])
        smaller_is_left = bs.left_count <= bs.right_count
        if mono_inter:
            # the stale leaves' own re-search runs even in a wave with no
            # candidate (grow_wave.py:2090-2093); one read for both counts
            n_cand, n_stale = torch.stack([valid.sum(), stale.sum()]
                                          ).tolist()
            n_rs = min(n_stale, KMAX)
        else:
            n_cand, n_rs = int(valid.sum()), 0
        num_waves += 1

        # ---- the route's row pass: relabel (+ candidate histograms, and
        # on the fused routes their children's splits)
        if route in ("mega", "fused"):
            tbl[7, :KMAX] = torch.where(valid, cand, -1).to(torch.int32)
            tbl[8:14, :KMAX] = _split_rows(bs.feature, bs.threshold,
                                           bs.default_left, meta)
            tbl[14, :KMAX] = smaller_is_left.to(torch.int32)
            if n_cand == 0:
                # in place: the tree's last wave allocates nothing
                wave_relabel(X_t, leaf_of_row, tbl, L, out=leaf_of_row,
                             plain=plain)
                if n_rs == 0:
                    continue
            elif route == "mega":
                K = next(k for k in buckets if k >= n_cand)
                leaf_of_row, hist_wave = wave_pass(X_t, vals0, leaf_of_row,
                                                   tbl, K, B, L, plain=plain)
            else:
                K = next(k for k in buckets if k >= n_cand)
                leaf_of_row, hist_wave, rec = wave_pass_fused(
                    X_t, vals0, leaf_of_row, tbl, hist_cache[cand[:K]],
                    fused_operands(SplitResult(*[x[:K] for x in bs]),
                                   cand[:K], smaller_is_left[:K])[0],
                    fmeta, fmask, K, B, L, hp, plain=plain)
        elif fusion and n_cand == 0:
            # applies-only wave: its relabel rides into the next fused
            # launch as the pending pass (grow_wave.py:1135-1139); a
            # pending relabel already waiting is flushed first
            # (:1615-1633)
            if pend is not None:
                leaf_of_row = _flush_pending(X_t, leaf_of_row, pend, meta,
                                             cfg, buckets, plain)
            pend = None if napp == 0 else _Pending(
                pa, bs2.feature, bs2.threshold, bs2.default_left, iscat2,
                bits2, nl0)
            continue
        else:
            n_pend = 0 if pend is None else pend.leaves.shape[0]
            Kd = next(k for k in buckets if k >= max(napp, n_cand, n_pend, 1))
            ci = cand[:n_cand]
            if n_cand > 0:
                tbl[7, :n_cand] = ci.to(torch.int32)
                tbl[8:14, :n_cand] = _split_rows(
                    bs.feature[:n_cand], bs.threshold[:n_cand],
                    bs.default_left[:n_cand], meta)
                tbl[14, :n_cand] = smaller_is_left[:n_cand].to(torch.int32)
            if route == "apply" or n_cand == 0:
                # one kernel decides each row under the applied and the
                # candidate splits: no [Kd, N] decision matrix
                cats = None
                if has_cat:
                    cats = pack_wave_cats(
                        iscat2 if napp > 0 else None,
                        bits2 if napp > 0 else None,
                        best_is_cat[ci] if n_cand > 0 else None,
                        best_bitset[ci] if n_cand > 0 else None, W)
                leaf_of_row, slot_small = wave_apply(
                    X_t, leaf_of_row, tbl, cats, bundle_map, Kd, L,
                    plain=plain)
                if n_cand == 0 and n_rs == 0:
                    continue
                if n_cand > 0:
                    K = next(k for k in buckets if k >= n_cand)
                    hist_wave = build_histogram_slots(
                        X_t, vals0, slot_small, K, B, impl=hroute,
                        plan=hist_plan, plain=plain)
            else:
                # kernel #10 reads go-left bits per (entry, row): bit 0
                # under applied entry j, bit 1 = lands in candidate j's
                # smaller child, bit 2 under pending entry j; Kd rows, the
                # bucketed count of live entries
                dec = torch.zeros((Kd, N), dtype=torch.uint8, device=dev)
                if napp > 0:
                    dec[:napp] = dec_go_left(
                        X_t, bs2.feature, bs2.threshold, bs2.default_left,
                        iscat2, bits2, meta, cfg)
                glc = dec_go_left(
                    X_t, bs.feature[:n_cand], bs.threshold[:n_cand],
                    bs.default_left[:n_cand], best_is_cat[ci],
                    best_bitset[ci], meta, cfg)
                land = glc == smaller_is_left[:n_cand, None]
                dec[:n_cand] |= land.to(torch.uint8) << 1
                pend_tbl = torch.full((128,), -1, dtype=torch.int32,
                                      device=dev)
                if pend is not None:
                    dec[:n_pend] |= dec_go_left(
                        X_t, pend.feature, pend.threshold,
                        pend.default_left, pend.is_cat, pend.bits, meta,
                        cfg).to(torch.uint8) << 2
                    pend_tbl[:n_pend] = pend.leaves.to(torch.int32)
                K = next(k for k in buckets if k >= n_cand)
                scal, fmask_lr = fused_operands(
                    SplitResult(*[x[:K] for x in bs]), cand[:K],
                    smaller_is_left[:K])
                leaf_of_row, hist_wave, rec = wave_pass_fused_tiled(
                    X_t, vals0, dec, leaf_of_row, tbl, pend_tbl,
                    0 if pend is None else pend.nl0, hist_cache[cand[:K]],
                    scal, fmeta, fmask_lr, K, B, L, hp, scale_args,
                    plain=plain)
                pend = None
                del dec

        # ---- SEARCH both children of every candidate (the fused routes'
        # kernels ran the numeric search already), and under intermediate
        # the stale leaves' own bests as a third block (grow_wave.py:
        # 1766-1800)
        c_idx = cand[:n_cand]
        hist_small = hist_wave[:n_cand].reshape(n_cand, -1) \
            if n_cand > 0 else None
        num = unpack_fused_records(rec, n_cand) if fused else None
        hist_lr = None
        if n_cand > 0 and (num is None or has_cat):
            sl = smaller_is_left[:n_cand, None]
            hist_large = hist_cache[c_idx] - hist_small
            hist_lr = torch.cat([torch.where(sl, hist_small, hist_large),
                                 torch.where(sl, hist_large, hist_small)]
                                ).reshape((2 * n_cand,)
                                          + tuple(hist_root.shape))
        bsc = SplitResult(*[x[:n_cand] for x in bs])

        def both(a, b):
            return torch.cat([a[:n_cand], b[:n_cand]])

        sg_lr = both(bs.left_sum_g, bs.right_sum_g)
        sh_lr = both(bs.left_sum_h, bs.right_sum_h)
        c_lr = both(bs.left_count, bs.right_count)
        o_lr = both(bs.left_output, bs.right_output)
        bmin_lr, bmax_lr, fmask_lr, mpf_lr = children_constraints(bsc,
                                                                  c_idx)
        # the children's forced-node ids: a candidate whose best is its
        # forced split hands the table's children on (BFS walk,
        # grow_wave.py:1815-1825)
        fidl_k = fidr_k = fid_lr = None
        if has_forced:
            cf = best_forced[c_idx]
            fc = leaf_forced[c_idx].clamp(0, meta.forced.shape[1] - 1)
            fidl_k = torch.where(cf, meta.forced[2, fc], -1)
            fidr_k = torch.where(cf, meta.forced[3, fc], -1)
            fid_lr = torch.cat([fidl_k, fidr_k])
        # depth mask at store time: the order step reads stored gains
        can = (leaf_depth[c_idx] + 1 < max_depth).repeat(2)
        draw_rows = None
        if bynode or xt:
            # slot j's children are rows j and KMAX + j of the wave's draw
            j = torch.arange(n_cand, device=dev)
            draw_rows = torch.cat([j, j + KMAX])
        if n_rs > 0:
            # the stale leaves' own histograms, sums, bounds and sets; the
            # own block re-splits the leaf itself, so its depth gate is
            # depth < max_depth
            rs_gain = torch.where(stale, torch.clamp(best.gain, min=0.0),
                                  torch.full_like(best.gain, NEG_INF))
            rs_i = _top_k(rs_gain, KMAX)[1][:n_rs]
            hist_own = hist_cache[rs_i].reshape((n_rs,)
                                                + tuple(hist_root.shape))
            hist_lr = hist_own if hist_lr is None \
                else torch.cat([hist_lr, hist_own])
            sg_lr = torch.cat([sg_lr, leaf_sum_g[rs_i]])
            sh_lr = torch.cat([sh_lr, leaf_sum_h[rs_i]])
            c_lr = torch.cat([c_lr, leaf_count[rs_i].to(torch.float32)])
            o_lr = torch.cat([o_lr, leaf_output[rs_i]])
            bmin_lr = torch.cat([bmin_lr, leaf_min[rs_i]])
            bmax_lr = torch.cat([bmax_lr, leaf_max[rs_i]])
            if has_inter:
                fmask_lr = torch.cat([fmask_lr,
                                      sets_to_fmask(leaf_sets[rs_i])])
            if use_mpen:
                mpf_lr = torch.cat([mpf_lr, mpen_factor(leaf_depth[rs_i])])
            if has_forced:
                fid_lr = torch.cat([fid_lr, leaf_forced[rs_i]])
            can = torch.cat([can, leaf_depth[rs_i] < max_depth])
            if draw_rows is not None:
                draw_rows = torch.cat([
                    draw_rows, torch.arange(n_rs, device=dev) + 2 * KMAX])
        rb_lr = None
        if draw_rows is not None:
            bn_lr, rb_lr = node_draws(num_waves + 1,
                                      (3 if mono_inter else 2) * KMAX,
                                      draw_rows)
            fmask_lr = and_masks(fmask_lr, bn_lr)
        s_lr, cat_lr, bits_lr, forced_lr = search(
            hist_lr, sg_lr, sh_lr, c_lr, o_lr, num, bmin_lr, bmax_lr,
            fmask_lr, mpf_lr, rb_lr, fid_lr)
        s_lr = s_lr._replace(gain=torch.where(
            can, s_lr.gain, torch.full_like(s_lr.gain, NEG_INF)))
        forced_lr = forced_lr & can
        if n_cand > 0:
            small_hist[c_idx] = hist_small
            small_is_left[c_idx] = smaller_is_left[:n_cand]
            ready[c_idx] = True
            n2 = 2 * n_cand
            for a_l, a_r, v in zip(bestl, bestr, s_lr):
                a_l[c_idx] = v[:n_cand]
                a_r[c_idx] = v[n_cand:n2]
            catl[c_idx], catr[c_idx] = cat_lr[:n_cand], cat_lr[n_cand:n2]
            bitsl[c_idx], bitsr[c_idx] = bits_lr[:n_cand], bits_lr[n_cand:n2]
            if has_forced:
                fidl[c_idx], fidr[c_idx] = fidl_k, fidr_k
                bfl[c_idx] = forced_lr[:n_cand]
                bfr[c_idx] = forced_lr[n_cand:n2]
        if n_rs > 0:
            # install the re-searched bests; the leaves re-enter as
            # candidates next wave (grow_wave.py:2066-2085)
            o = 2 * n_cand
            for a, v in zip(best, s_lr):
                a[rs_i] = v[o:]
            best_is_cat[rs_i] = cat_lr[o:]
            best_bitset[rs_i] = bits_lr[o:]
            best_forced[rs_i] = forced_lr[o:]
            stale[rs_i] = False

    if pend is not None:
        # the tree's last wave applied only: no launch follows it
        leaf_of_row = _flush_pending(X_t, leaf_of_row, pend, meta, cfg,
                                     buckets, plain)

    if quant and cfg.quant_renew_leaf and cfg.path_smooth <= 1e-15:
        leaf_value = renew_leaf_values(leaf_value, leaf_of_row, g, h,
                                       num_leaves, KMAX, hp, plain=plain)

    tree = DeviceTree(
        num_leaves=num_leaves, split_feature=split_feature,
        threshold_bin=threshold_bin, default_left=default_left,
        split_gain=split_gain, left_child=left_child[:M],
        right_child=right_child[:M], internal_value=internal_value,
        internal_weight=internal_weight, internal_count=internal_count,
        leaf_value=leaf_value, leaf_weight=leaf_weight,
        leaf_count=leaf_count, split_parent_leaf=split_parent_leaf,
        split_is_cat=split_is_cat, split_cat_bitset=split_cat_bitset,
        num_waves=num_waves)
    return tree, leaf_of_row
