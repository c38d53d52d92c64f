"""Best-split search over feature histograms, in PyTorch.

Counterpart of lightgbm_tpu/ops/split.py (the reference's
FeatureHistogram::FindBestThresholdSequentially,
feature_histogram.hpp:833-1058). Both direction scans for all features are
cumulative sums over the [F, B] histogram, and the best (direction,
feature, threshold) is one argmax. The JAX package runs this as XLA; here
it is plain tensor code, batched over any leading dimensions so one call
searches every child of a wave.

Histograms are channel-major [..., 3, F, B]: (sum_grad, sum_hess, count),
the count channel synthesized from hessians (`synth_count_channel`).

Direction semantics (feature_histogram.hpp:855-1030):
 - forward scan: missing-valued rows fall RIGHT (default_left=False)
 - reverse scan: missing-valued rows fall LEFT  (default_left=True)
 - the missing bin (default_bin for MissingType::Zero, last bin for
   MissingType::NaN) is excluded from both cumulative sums; its mass
   reaches one side via `parent_total - accumulated`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models.tree import MISSING_NAN, MISSING_ZERO

NEG_INF = float("-inf")

# min_data_in_leaf slack for the hessian-synthesized count channel: the
# round-to-nearest admit region (lightgbm_tpu/ops/split.py SYNTH_COUNT_SLACK)
SYNTH_COUNT_SLACK = 0.5


class SplitHyperParams(NamedTuple):
    """Split hyperparameters (subset of Config used by the finder)."""
    min_data_in_leaf: float
    min_sum_hessian_in_leaf: float
    lambda_l1: float
    lambda_l2: float
    max_delta_step: float
    min_gain_to_split: float
    path_smooth: float


def expand_feature_offset_hist(flat: torch.Tensor, offsets: tuple,
                               widths: tuple, num_bins: int) -> torch.Tensor:
    """Ragged per-feature-offset histogram [..., total] -> uniform
    [..., F, num_bins] grid (lightgbm_tpu/ops/split.py:62): feature f owns
    the `widths[f]` columns from `offsets[f]`; bins it does not own read 0
    (a zero column appended to `flat`, as the JAX package's OOB fill)."""
    total = flat.shape[-1]
    offs = torch.tensor(offsets, dtype=torch.int64)[:, None]
    wid = torch.tensor(widths, dtype=torch.int64)[:, None]
    b = torch.arange(num_bins, dtype=torch.int64)[None, :]
    idx = torch.where(b < wid, offs + b, total).reshape(-1)
    padded = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (1,))], -1)
    out = padded.index_select(-1, idx.to(flat.device))
    return out.reshape(flat.shape[:-1] + (len(offsets), num_bins))


class FeatureMeta(NamedTuple):
    """Per-feature metadata tensors (reference: FeatureMetainfo,
    feature_histogram.hpp:30)."""
    num_bins: torch.Tensor        # [F] int32 (includes the NaN bin)
    missing_type: torch.Tensor    # [F] int32
    default_bin: torch.Tensor     # [F] int32
    is_categorical: torch.Tensor  # [F] bool
    bundle_expand: Optional[torch.Tensor] = None  # [F*B] int64: EFB bundle-
    #   histogram -> per-feature histogram gather map (OOB = fill 0)
    bundle_mfb: Optional[torch.Tensor] = None     # [F, B] f32 one-hot of
    #   each feature's default bin (FixHistogram reconstruction)
    monotone: Optional[torch.Tensor] = None       # [F] int8: -1 / 0 / +1
    #   constraint; None when no feature is constrained
    inter_sets: Optional[torch.Tensor] = None     # [S, F] bool: interaction
    #   constraint set membership; None without interaction constraints
    forced: Optional[torch.Tensor] = None         # [4, S] int64 forced-split
    #   tree in BFS order: rows (inner feature, bin threshold, left child,
    #   right child), children forced-node ids or -1 (forcedsplits_filename,
    #   serial_tree_learner.cpp:628); None without forced splits
    cegb_coupled: Optional[torch.Tensor] = None   # [F] f32 coupled CEGB
    #   penalty by inner feature (cegb_penalty_feature_coupled,
    #   cost_effective_gradient_boosting.hpp:87); None when not given


class SplitResult(NamedTuple):
    """Best split per leaf (reference: SplitInfo, split_info.hpp); every
    field has the batch shape of the search."""
    gain: torch.Tensor            # f32; -inf when no valid split
    feature: torch.Tensor         # int64 inner feature index
    threshold: torch.Tensor       # int64 bin threshold (left: bin <= thr)
    default_left: torch.Tensor    # bool
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_count: torch.Tensor
    right_sum_g: torch.Tensor
    right_sum_h: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


def threshold_l1(s: torch.Tensor, l1: float) -> torch.Tensor:
    """reference: feature_histogram.hpp:712."""
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def synth_count_channel(hist2: torch.Tensor, count: torch.Tensor,
                        sum_h: torch.Tensor) -> torch.Tensor:
    """[..., 2, F, B] (grad, hess) -> [..., 3, F, B] with per-bin counts
    synthesized as hess * count / sum_hess (the reference's cnt_factor,
    feature_histogram.hpp:529,844)."""
    cntf = count / torch.clamp(sum_h, min=1e-12)
    cnt = hist2[..., 1:2, :, :] * cntf[..., None, None, None]
    return torch.cat([hist2, cnt], dim=-3)


def leaf_output(sum_g, sum_h, hp: SplitHyperParams, num_data,
                parent_output):
    """reference: CalculateSplittedLeafOutput (feature_histogram.hpp:718)."""
    ret = -threshold_l1(sum_g, hp.lambda_l1) / (sum_h + hp.lambda_l2)
    if hp.max_delta_step > 0:
        ret = torch.clamp(ret, -hp.max_delta_step, hp.max_delta_step)
    if hp.path_smooth > 1e-15:
        # a tensor divisor: torch's CUDA division by a Python scalar
        # multiplies by its f32 reciprocal, which is not the IEEE quotient
        # the CPU, the JAX package and the fused kernels' scan compute
        n_over_s = num_data / torch.full_like(num_data, hp.path_smooth)
        ret = ret * n_over_s / (n_over_s + 1.0) \
            + parent_output / (n_over_s + 1.0)
    return ret


def leaf_gain_given_output(sum_g, sum_h, hp: SplitHyperParams, output):
    """reference: GetLeafGainGivenOutput (feature_histogram.hpp:818)."""
    sg = threshold_l1(sum_g, hp.lambda_l1)
    return -(2.0 * sg * output + (sum_h + hp.lambda_l2) * output * output)


def leaf_gain(sum_g, sum_h, hp: SplitHyperParams, num_data, parent_output):
    """reference: GetLeafGain (feature_histogram.hpp:800)."""
    out = leaf_output(sum_g, sum_h, hp, num_data, parent_output)
    return leaf_gain_given_output(sum_g, sum_h, hp, out)


def _numeric_gain_map(hist, parent_sum_g, parent_sum_h, parent_count,
                      parent_output, meta: FeatureMeta,
                      hp: SplitHyperParams, feature_mask, leaf_min=None,
                      leaf_max=None):
    """Gain map [..., 2, F, B] (dir 0 forward, dir 1 reverse), validity
    mask, the eight per-cell stat maps, and min_gain_shift [...]."""
    F, B = hist.shape[-2:]
    dev = hist.device
    bins = torch.arange(B, device=dev)[None, :]                # [1, B]
    nb = meta.num_bins.to(torch.int64)[:, None]                 # [F, 1]
    mt = meta.missing_type.to(torch.int64)
    db = meta.default_bin.to(torch.int64)

    valid_bin = bins < nb
    missing_bin = torch.where(mt == MISSING_NAN, nb[:, 0] - 1,
                              torch.where(mt == MISSING_ZERO, db,
                                          torch.full_like(db, -1)))
    excl = (bins == missing_bin[:, None]) | ~valid_bin         # [F, B]

    acc = torch.where(excl, torch.zeros((), dtype=hist.dtype, device=dev),
                      hist)                                    # [..., 3, F, B]
    # prefix sums in f64, each rounded once to f32: what torch's CPU cumsum
    # of f32 does anyway, while its CUDA cumsum is an f32 parallel scan;
    # so the search gives the same bits on both devices, and the fused
    # kernels' in-order f64 scan (csrc/split_scan.cuh) gives them too
    cum = torch.cumsum(acc.double(), dim=-1).float()
    acc_tot = cum[..., -1:]                                    # [..., 3, F, 1]

    parent = torch.stack([parent_sum_g, parent_sum_h,
                          parent_count.to(torch.float32)], dim=-1)  # [..., 3]
    miss = parent[..., :, None, None] - acc_tot                # [..., 3, F, 1]

    # threshold t: left = bins <= t; dir 0 left = cum[t] (missing right),
    # dir 1 left = cum[t] + miss (missing left); stacked as [..., 3, 2, F, B]
    left = torch.stack([cum, cum + miss], dim=-3)
    right = parent[..., :, None, None, None] - left

    lg, lh, lc = left[..., 0, :, :, :], left[..., 1, :, :, :], \
        torch.round(left[..., 2, :, :, :])
    rg, rh, rc = right[..., 0, :, :, :], right[..., 1, :, :, :], \
        torch.round(right[..., 2, :, :, :])
    lc_ok = left[..., 2, :, :, :] >= hp.min_data_in_leaf - SYNTH_COUNT_SLACK
    rc_ok = right[..., 2, :, :, :] >= hp.min_data_in_leaf - SYNTH_COUNT_SLACK

    # threshold validity (feature_histogram.hpp:860-944): t in
    # [0, num_bin-2]; the reverse scan of a NaN-missing feature stops at
    # num_bin-3; MissingType::Zero skips the default-bin threshold
    max_t = nb - 2
    max_t_r = torch.where((mt == MISSING_NAN)[:, None], nb - 3, max_t)
    skip_default = (mt == MISSING_ZERO)[:, None] & (bins == db[:, None])
    t_ok = torch.stack([(bins <= max_t) & ~skip_default,
                        (bins <= max_t_r) & ~skip_default], dim=0)

    ok = (t_ok & lc_ok & rc_ok
          & (lh >= hp.min_sum_hessian_in_leaf)
          & (rh >= hp.min_sum_hessian_in_leaf))
    if feature_mask is not None:
        # [F], or [..., F] per histogram of the batch
        ok = ok & feature_mask[..., None, :, None]
    ok = ok & ~meta.is_categorical[:, None]

    po = parent_output[..., None, None, None]
    lout = leaf_output(lg, lh, hp, lc, po)
    rout = leaf_output(rg, rh, hp, rc, po)
    if leaf_min is not None:
        # the monotone bounds of the leaf ([...], one per histogram)
        lo = leaf_min[..., None, None, None]
        hi = leaf_max[..., None, None, None]
        lout = torch.clamp(lout, lo, hi)
        rout = torch.clamp(rout, lo, hi)
    if meta.monotone is not None:
        # a split on a +-1 feature whose clipped outputs go the wrong way
        mono = meta.monotone[:, None]
        ok = ok & ~(((mono > 0) & (lout > rout))
                    | ((mono < 0) & (lout < rout)))
    gain = (leaf_gain_given_output(lg, lh, hp, lout)
            + leaf_gain_given_output(rg, rh, hp, rout))

    # gain of not splitting (BeforeNumerical, feature_histogram.hpp:199)
    gain_shift = leaf_gain(parent_sum_g, parent_sum_h, hp, parent_count,
                           parent_output)
    min_gain_shift = gain_shift + hp.min_gain_to_split
    return gain, ok, (lg, lh, lc, rg, rh, rc, lout, rout), min_gain_shift


def find_best_split(hist: torch.Tensor, parent_sum_g: torch.Tensor,
                    parent_sum_h: torch.Tensor, parent_count: torch.Tensor,
                    parent_output: torch.Tensor, meta: FeatureMeta,
                    hp: SplitHyperParams,
                    feature_mask: Optional[torch.Tensor] = None,
                    leaf_min: Optional[torch.Tensor] = None,
                    leaf_max: Optional[torch.Tensor] = None,
                    mono_pen_factor: Optional[torch.Tensor] = None,
                    rand_bins: Optional[torch.Tensor] = None,
                    forced_f: Optional[torch.Tensor] = None,
                    forced_b: Optional[torch.Tensor] = None,
                    cegb_pen: Optional[torch.Tensor] = None
                    ) -> SplitResult:
    """Best numerical split per histogram.

    hist [..., 3, F, B] f32; parent scalars with the batch shape [...];
    feature_mask [F] or [..., F] bool (column sampling, interaction sets).
    Returns gain -inf where no split satisfies the constraints.
    Categorical features are masked out (ops/categorical.py searches
    them).

    Monotone constraints, the reference's "basic" method
    (lightgbm_tpu/ops/split.py:find_best_split; BasicLeafConstraints,
    monotone_constraints.hpp:330): the child outputs are clipped into the
    leaf's bounds `leaf_min` / `leaf_max` ([...]), the gain is that of the
    clipped outputs, and a split on a +-1 feature of `meta.monotone` whose
    clipped outputs go the wrong way is rejected. `mono_pen_factor` [...]
    (monotone_penalty) multiplies the shifted gain of splits on monotone
    features (serial_tree_learner.cpp:1001-1005). `rand_bins` [..., F]
    (extra_trees) leaves each feature one candidate threshold, its drawn
    bin (BeforeNumerical's rand.NextInt(0, num_bin - 2),
    feature_histogram.hpp:203-207; lightgbm_tpu/ops/split.py:339-345).

    Forced mode (`forced_f` / `forced_b` [...], SerialTreeLearner::
    ForceSplits, serial_tree_learner.cpp:628): only the cell of that
    (feature, bin threshold) competes, in either missing direction, and the
    min-gain bar does not apply (split.py:327-337). `cegb_pen` [F] or
    [..., F] (CEGB's DeltaGain, cost_effective_gradient_boosting.hpp:81) is
    subtracted from every finite gain of its feature before the argmax, so
    the stored gain is the penalized one (split.py:345-351)."""
    gain, ok, stats, min_gain_shift = _numeric_gain_map(
        hist, parent_sum_g, parent_sum_h, parent_count, parent_output,
        meta, hp, feature_mask, leaf_min, leaf_max)
    mgs = min_gain_shift[..., None, None, None]
    if forced_f is not None:
        keep = ok & _forced_cell(gain, forced_f, forced_b)
    else:
        keep = ok & (gain > mgs)
    gain = torch.where(keep, gain, torch.full_like(gain, NEG_INF))
    gain = _penalize(gain, mgs, meta, rand_bins, cegb_pen, mono_pen_factor)
    return _pick_best(gain, stats, min_gain_shift)


def _forced_cell(gain: torch.Tensor, forced_f: torch.Tensor,
                 forced_b: torch.Tensor) -> torch.Tensor:
    """[..., 1, F, B] bool: the one (feature, bin) cell of each histogram's
    forced split, in both directions."""
    F, B = gain.shape[-2:]
    dev = gain.device
    fsel = torch.arange(F, device=dev) == forced_f[..., None]      # [..., F]
    bsel = torch.arange(B, device=dev) == forced_b[..., None]      # [..., B]
    return (fsel[..., :, None] & bsel[..., None, :])[..., None, :, :]


def _penalize(gain, mgs, meta: FeatureMeta, rand_bins, cegb_pen,
              mono_pen_factor):
    """The normal selection's filters after the validity mask, in the JAX
    package's order (split.py:338-360): extra_trees' drawn bin, CEGB's
    per-feature penalty, then monotone_penalty's affine map around the
    shift."""
    if rand_bins is not None:
        B = gain.shape[-1]
        drawn = torch.arange(B, device=gain.device) == rand_bins[..., None]
        gain = torch.where(drawn[..., None, :, :], gain,
                           torch.full_like(gain, NEG_INF))
    if cegb_pen is not None:
        gain = torch.where(torch.isfinite(gain),
                           gain - cegb_pen[..., None, :, None], gain)
    if mono_pen_factor is not None and meta.monotone is not None:
        # an affine map around the shift, in map space (split.py:352-360)
        mono_f = (meta.monotone != 0)[:, None]
        gain = torch.where(
            mono_f & torch.isfinite(gain),
            (gain - mgs) * mono_pen_factor[..., None, None, None] + mgs,
            gain)
    return gain


def find_best_split_and_forced(
        hist: torch.Tensor, parent_sum_g: torch.Tensor,
        parent_sum_h: torch.Tensor, parent_count: torch.Tensor,
        parent_output: torch.Tensor, meta: FeatureMeta,
        hp: SplitHyperParams, feature_mask: Optional[torch.Tensor],
        leaf_min: Optional[torch.Tensor], leaf_max: Optional[torch.Tensor],
        forced_f: torch.Tensor, forced_b: torch.Tensor,
        cegb_pen: Optional[torch.Tensor] = None,
        rand_bins: Optional[torch.Tensor] = None,
        mono_pen_factor: Optional[torch.Tensor] = None
        ) -> Tuple[SplitResult, SplitResult]:
    """The best numerical split and the forced (feature, threshold) cell's
    split per histogram, from one gain map (split.py:409-449). The column
    sampler, extra_trees, CEGB and monotone_penalty apply only to the
    normal selection: a forced split bypasses them, and the min-gain bar
    (ForceSplits, serial_tree_learner.cpp:628)."""
    gain, ok, stats, min_gain_shift = _numeric_gain_map(
        hist, parent_sum_g, parent_sum_h, parent_count, parent_output,
        meta, hp, None, leaf_min, leaf_max)
    mgs = min_gain_shift[..., None, None, None]
    ok_n = ok if feature_mask is None \
        else ok & feature_mask[..., None, :, None]
    neg = torch.full_like(gain, NEG_INF)
    gain_n = _penalize(torch.where(ok_n & (gain > mgs), gain, neg), mgs,
                       meta, rand_bins, cegb_pen, mono_pen_factor)
    gain_f = torch.where(ok & _forced_cell(gain, forced_f, forced_b), gain,
                         neg)
    return (_pick_best(gain_n, stats, min_gain_shift),
            _pick_best(gain_f, stats, min_gain_shift))


def _pick_best(gain, stats, min_gain_shift) -> SplitResult:
    """Argmax over a filtered [..., 2, F, B] gain map (first maximum in
    direction-major order, as jnp.argmax) + exact stat selection."""
    F, B = gain.shape[-2:]
    batch = gain.shape[:-3]
    flat = gain.reshape(batch + (2 * F * B,))
    best = torch.argmax(flat, dim=-1, keepdim=True)
    best_gain = torch.gather(flat, -1, best)[..., 0]

    def pick(x):
        v = torch.gather(x.reshape(batch + (2 * F * B,)), -1, best)[..., 0]
        # non-selected cells may be inf/NaN; the picked one is finite
        # whenever the gain is (the JAX version zeroes non-finite picks)
        return torch.where(torch.isfinite(v), v, torch.zeros_like(v))

    lg, lh, lc, rg, rh, rc, lout, rout = (pick(x) for x in stats)
    best = best[..., 0]
    return SplitResult(
        gain=torch.where(torch.isfinite(best_gain),
                         best_gain - min_gain_shift,
                         torch.full_like(best_gain, NEG_INF)),
        feature=(best // B) % F,
        threshold=best % B,
        default_left=(best // (F * B)) == 1,
        left_sum_g=lg, left_sum_h=lh, left_count=lc,
        right_sum_g=rg, right_sum_h=rh, right_count=rc,
        left_output=lout, right_output=rout,
    )
