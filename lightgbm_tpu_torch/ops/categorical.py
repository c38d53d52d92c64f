"""Categorical best-split search (one-hot and sorted many-vs-many).

Counterpart of lightgbm_tpu/ops/categorical.py (the reference's
FeatureHistogram::FindBestThresholdCategoricalInner,
src/treelearner/feature_histogram.cpp:148-344), batched over any leading
dimensions like ops/split.py:find_best_split, so one call searches every
child of a wave:

  * one-hot mode (num_bin <= max_cat_to_onehot): left = {single category};
    every (feature, bin) candidate evaluated at once with plain lambda_l2.
  * sorted many-vs-many: categories with count >= cat_smooth are sorted by
    grad / (hess + cat_smooth); candidate left-sets are prefixes of the
    ascending and descending orders, capped at
    max_num_cat = min(max_cat_threshold, (used_bin + 1) / 2), with
    l2 -> lambda_l2 + cat_l2. Both direction scans are cumulative sums over
    the sorted histogram (a stable sort, as jnp.argsort).

Deviation from the reference (documented, as in the JAX package): the
reference's `cnt_cur_group >= min_data_per_group` *stepping* rule (it skips
candidate prefixes until a new group has accumulated min_data_per_group
rows, feature_histogram.cpp:316) is sequential; here every prefix that
satisfies the hard left/right count+hessian constraints is evaluated. The
`right_count >= min_data_per_group` hard constraint is kept.

The chosen left-set is returned as a BIN-index bitset ([..., W] words of
32 bits, held in int64); bin 0 (the missing/other-category bin) is never
selected, so missing values fall right — the reference's
`default_left = false` for categorical splits (feature_histogram.cpp:155).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .split import (NEG_INF, FeatureMeta, SplitHyperParams, SplitResult,
                    leaf_gain, leaf_gain_given_output, leaf_output)

_EPS = 1e-15


class CatConfig(NamedTuple):
    """Static categorical hyperparameters (subset of Config)."""
    max_cat_to_onehot: int
    max_cat_threshold: int
    cat_l2: float
    cat_smooth: float
    min_data_per_group: float
    num_bitset_words: int       # W: ceil(num_bins_padded / 32)


def _gain_and_outputs(lg, lh, lc, rg, rh, rc, hp, parent_output,
                      leaf_min=None, leaf_max=None):
    lout = leaf_output(lg, lh, hp, lc, parent_output)
    rout = leaf_output(rg, rh, hp, rc, parent_output)
    if leaf_min is not None:
        # monotone ancestors bound every descendant's output, categorical
        # splits included; the direction rule is the numeric search's only
        # (lightgbm_tpu/ops/categorical.py:48-62)
        lout = torch.clamp(lout, leaf_min, leaf_max)
        rout = torch.clamp(rout, leaf_min, leaf_max)
    gain = (leaf_gain_given_output(lg, lh, hp, lout)
            + leaf_gain_given_output(rg, rh, hp, rout))
    return gain, lout, rout


def bitset_words(selected: torch.Tensor, W: int) -> torch.Tensor:
    """[..., B] bool -> [..., W] int64 words (bit b of word b // 32)."""
    B = selected.shape[-1]
    pad = W * 32 - B
    if pad > 0:
        selected = torch.cat([selected, selected.new_zeros(
            selected.shape[:-1] + (pad,))], dim=-1)
    sel = selected[..., :W * 32].reshape(selected.shape[:-1] + (W, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=selected.device)
    return (sel.to(torch.int64) << shifts).sum(dim=-1)


def find_best_split_categorical(
    hist: torch.Tensor,             # [..., 3, F, B] f32 (channel-major)
    parent_sum_g: torch.Tensor,     # [...]
    parent_sum_h: torch.Tensor,
    parent_count: torch.Tensor,
    parent_output: torch.Tensor,
    meta: FeatureMeta,
    hp: SplitHyperParams,
    cat: CatConfig,
    feature_mask: Optional[torch.Tensor] = None,
    leaf_min: Optional[torch.Tensor] = None,
    leaf_max: Optional[torch.Tensor] = None,
    cegb_pen: Optional[torch.Tensor] = None,
) -> Tuple[SplitResult, torch.Tensor]:
    """Best categorical split over all features per histogram.

    feature_mask [F] or [..., F]; leaf_min / leaf_max [...] the monotone
    bounds the child outputs are clipped into; cegb_pen [F] or [..., F]
    CEGB's per-feature penalty, subtracted from every finite gain of the
    three candidate kinds before the argmax (lightgbm_tpu/ops/
    categorical.py:158-160). Returns (SplitResult with the batch shape,
    bin bitset [..., W] int64). gain == -inf where no categorical split is
    valid."""
    F, B = hist.shape[-2:]
    batch = hist.shape[:-3]
    dev = hist.device
    W = cat.num_bitset_words
    bins = torch.arange(B, device=dev)[None, :]                 # [1, B]
    nb = meta.num_bins.to(torch.int64)[:, None]                 # [F, 1]

    g = hist[..., 0, :, :]
    h = hist[..., 1, :, :]
    c = torch.round(hist[..., 2, :, :])

    is_cat = meta.is_categorical
    if feature_mask is not None:
        is_cat = is_cat & feature_mask                          # [..., F]
    # bin 0 is the missing/other bin (binning.py categorical layout)
    valid = (bins >= 1) & (bins < nb) & is_cat[..., None]       # [..., F, B]

    def bcast(x):
        return x[..., None, None]

    bmin = None if leaf_min is None else bcast(leaf_min)
    bmax = None if leaf_max is None else bcast(leaf_max)

    pg, ph = bcast(parent_sum_g), bcast(parent_sum_h)
    pc = bcast(parent_count.to(torch.float32))
    po = bcast(parent_output)
    gain_shift = leaf_gain(parent_sum_g, parent_sum_h, hp, parent_count,
                           parent_output)
    min_gain_shift = gain_shift + hp.min_gain_to_split
    mgs = bcast(min_gain_shift)
    hp_cat = hp._replace(lambda_l2=hp.lambda_l2 + cat.cat_l2)

    def constraints_ok(lh_, lc_, rh_, rc_, extra_right_min=0.0):
        return ((lc_ >= hp.min_data_in_leaf)
                & (rc_ >= max(hp.min_data_in_leaf, extra_right_min))
                & (lh_ >= hp.min_sum_hessian_in_leaf)
                & (rh_ >= hp.min_sum_hessian_in_leaf))

    def masked(gain, ok):
        return torch.where(ok & (gain > mgs), gain,
                           torch.full_like(gain, NEG_INF))

    # ---- one-hot candidates: left = {bin b} (fc:189-243)
    onehot_f = (meta.num_bins.to(torch.int64)
                <= cat.max_cat_to_onehot)[:, None]              # [F, 1]
    lg1, lh1, lc1 = g, h + _EPS, c
    rg1, rh1, rc1 = pg - lg1, ph - lh1 - _EPS, pc - lc1
    gain1, lout1, rout1 = _gain_and_outputs(lg1, lh1, lc1, rg1, rh1, rc1,
                                            hp, po, bmin, bmax)
    gain1 = masked(gain1, valid & onehot_f
                   & constraints_ok(lh1, lc1, rh1, rc1))

    # ---- sorted many-vs-many (fc:245-343)
    include = valid & ~onehot_f & (c >= cat.cat_smooth)       # [..., F, B]
    ratio = g / (h + cat.cat_smooth)
    used_bin = include.sum(dim=-1)                              # [..., F]
    max_num_cat = torch.clamp((used_bin + 1) // 2,
                              max=cat.max_cat_threshold)
    lim = torch.minimum(used_bin, max_num_cat)[..., None]
    inf = torch.full_like(ratio, float("inf"))
    iota = torch.arange(B, device=dev).expand_as(ratio)

    def direction(descending: bool):
        key = torch.where(include, -ratio if descending else ratio, inf)
        order = torch.sort(key, dim=-1, stable=True).indices
        rank = torch.empty_like(order).scatter_(-1, order, iota)
        sg = torch.gather(g, -1, order)
        sh = torch.gather(h, -1, order)
        sc = torch.gather(c, -1, order)
        lg = torch.cumsum(sg, dim=-1)
        lh = torch.cumsum(sh, dim=-1) + _EPS
        lc = torch.cumsum(sc, dim=-1)
        rg, rh, rc = pg - lg, ph - lh - _EPS, pc - lc
        gain, lout, rout = _gain_and_outputs(lg, lh, lc, rg, rh, rc,
                                             hp_cat, po, bmin, bmax)
        ok = ((bins < lim) & ~onehot_f & is_cat[..., None]
              & constraints_ok(lh, lc, rh, rc, cat.min_data_per_group))
        return masked(gain, ok), (lg, lh, lc, rg, rh, rc, lout, rout), rank

    gain_a, stats_a, rank_a = direction(False)
    gain_d, stats_d, rank_d = direction(True)
    stats1 = (lg1, lh1, lc1, rg1, rh1, rc1, lout1, rout1)

    all_gain = torch.stack([gain1, gain_a, gain_d], dim=-3)  # [..., 3, F, B]
    if cegb_pen is not None:
        all_gain = torch.where(torch.isfinite(all_gain),
                               all_gain - cegb_pen[..., None, :, None],
                               all_gain)
    flat = all_gain.reshape(batch + (3 * F * B,))
    best_k = torch.argmax(flat, dim=-1, keepdim=True)
    best_gain = torch.gather(flat, -1, best_k)[..., 0]

    def pick(a, b_, d):
        x = torch.stack([a.expand_as(gain1), b_, d], dim=-3)
        return torch.gather(x.reshape(batch + (3 * F * B,)), -1,
                            best_k)[..., 0]

    best = best_k[..., 0]
    kind = best // (F * B)
    f = (best // B) % F
    t = best % B

    # ---- left-set bitset over bins
    fi = f[..., None, None].expand(batch + (1, B))
    rank_sel = torch.where((kind == 1)[..., None],
                           torch.gather(rank_a, -2, fi)[..., 0, :],
                           torch.gather(rank_d, -2, fi)[..., 0, :])
    bvec = torch.arange(B, device=dev)
    selected = torch.where((kind == 0)[..., None], bvec == t[..., None],
                           rank_sel <= t[..., None])
    selected = selected & (bvec >= 1) & (bvec < nb[f.reshape(-1), 0]
                                         .reshape(batch + (1,)))
    words = bitset_words(selected, W)

    lg, lh, lc, rg, rh, rc, lout, rout = (
        pick(s1, sa, sd) for s1, sa, sd in zip(stats1, stats_a, stats_d))
    res = SplitResult(
        gain=torch.where(torch.isfinite(best_gain),
                         best_gain - min_gain_shift,
                         torch.full_like(best_gain, NEG_INF)),
        feature=f,
        threshold=torch.zeros_like(f),        # unused for categorical
        default_left=torch.zeros_like(f, dtype=torch.bool),
        left_sum_g=lg, left_sum_h=lh, left_count=lc,
        right_sum_g=rg, right_sum_h=rh, right_count=rc,
        left_output=lout, right_output=rout,
    )
    return res, words
