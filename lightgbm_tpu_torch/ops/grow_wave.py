"""Wave-pipelined leaf-wise tree growth on the wave megakernel route.

Counterpart of lightgbm_tpu/ops/grow_wave.py:grow_tree_wave on its fused
megakernel route (`use_mega`, grow_wave.py:287-290: F <= 32 storage
columns, no EFB bundles, no categorical features) with the default
gain-slack batching. The algorithm is the JAX package's, restructured from
one XLA program into a Python loop over waves:

  1. APPLY: ready leaves with positive gain split in gain order (the
     gain-slack rule decides how many), trimmed to the leaf budget — pure
     [L]-array bookkeeping.
  2. SPECULATE: the top-K unready frontier leaves by cached gain become
     the wave's candidates.
  3. One row sweep (`wave_pass`, a Hopper kernel) relabels the rows of
     the applied splits and accumulates every candidate's smaller-child
     histogram; a wave with no candidates runs the relabel only
     (`wave_relabel`). The larger child's histogram is parent minus
     smaller (BeforeFindBestSplit, serial_tree_learner.cpp:344).
  4. SEARCH: best splits of both children of every candidate, batched
     (ops/split.py), cached per leaf until the leaf is applied.

The JAX package's `lax.while_loop` over waves becomes a Python loop that
reads two host scalars per wave (whether to go on plus the number of
splits to apply, then the candidate count, which picks the kernel's
bucketed K); its `lax.switch` over K buckets becomes a direct call with
the bucketed K.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .grow import DeviceTree, GrowConfig
from .histogram import build_histogram, wave_pass, wave_relabel
from .split import (NEG_INF, FeatureMeta, SplitResult, find_best_split,
                    synth_count_channel)

MAX_WAVE_FEATURES = 32


def _wave_buckets(L: int, kcap: int = 128) -> List[int]:
    """Slot-kernel sizes; the smallest bucket >= the wave's candidate count
    is launched (lightgbm_tpu/ops/grow_wave.py:83)."""
    kmax = min(kcap, max(L - 1, 1))
    ladder = (1, 2, 4, 8, 16, 32, 48, 64, 96)
    return [k for k in ladder if k < kmax] + [kmax]


def mega_kcap(num_bins_padded: int) -> int:
    """The widest wave of the megakernel route (grow_wave.py:328-338): the
    TPU kernel's output block bounds K by its VMEM budget. The cap decides
    how many splits a wave may apply and speculate, so the port keeps it to
    grow the same trees."""
    B_lane = next(w for w in (32, 64, 128, 256) if num_bins_padded <= w) \
        if num_bins_padded <= 256 else 256
    kcap = 3_400_000 // (2 * 32 * B_lane * 4)
    kcap = max(1 << (kcap.bit_length() - 1), 1) if kcap >= 1 else 1
    return min(kcap, 128)


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


def grow_tree_wave(
    X_t: torch.Tensor,            # [F, N] uint8 binned, feature-major
    grad: torch.Tensor,           # [N] f32
    hess: torch.Tensor,           # [N] f32
    in_bag: torch.Tensor,         # [N] f32
    meta: FeatureMeta,
    cfg: GrowConfig,
    feature_mask: Optional[torch.Tensor] = None,
    *,
    plain: bool = False,
) -> Tuple[DeviceTree, torch.Tensor]:
    """Grow one tree; returns (DeviceTree, leaf_of_row [N] int32).

    `plain=True` runs the kernels' plain PyTorch versions on any device."""
    dev = X_t.device
    if X_t.shape[0] > MAX_WAVE_FEATURES:
        raise NotImplementedError(
            f"{X_t.shape[0]} storage columns: the wave megakernel takes at "
            f"most {MAX_WAVE_FEATURES}; the wide-feature route is ROADMAP "
            "item A9")
    N = X_t.shape[1]
    L = cfg.num_leaves
    M = max(L - 1, 1)
    B = cfg.num_bins_padded
    hp = cfg.hp
    max_depth = cfg.max_depth if cfg.max_depth > 0 else 10 ** 9
    slack = cfg.wave_gain_slack
    buckets = _wave_buckets(L, mega_kcap(B))
    KMAX = buckets[-1]

    g = grad.to(torch.float32) * in_bag
    h = hess.to(torch.float32) * in_bag
    cnt_row = (in_bag > 0).to(torch.float32)
    root_g, root_h, root_c = g.sum(), h.sum(), cnt_row.sum()
    vals0 = torch.stack([g, h], dim=0)                       # [2, N] f32
    C = 2

    def search(hist2, sum_g, sum_h, count, out):
        hist = synth_count_channel(hist2, count, sum_h)      # [n, 3, F, B]
        return find_best_split(hist, sum_g, sum_h, count, out, meta, hp,
                               feature_mask)

    # ---- root
    root_out = (-torch.sign(root_g)
                * torch.clamp(torch.abs(root_g) - hp.lambda_l1, min=0.0)
                / (root_h + hp.lambda_l2))
    hist_root = build_histogram(X_t, vals0, B, plain=plain)  # [2, F, B]
    root_split = search(hist_root[None], root_g[None], root_h[None],
                        root_c[None], root_out[None])
    if max_depth < 1:
        root_split = root_split._replace(
            gain=torch.full_like(root_split.gain, NEG_INF))

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
    hist_cache = torch.zeros((L, C * hist_root[0].numel()),
                             dtype=torch.float32, device=dev)
    hist_cache[0] = hist_root.reshape(-1)
    small_hist = torch.zeros_like(hist_cache)
    small_is_left = zeros(L, torch.bool)
    ready = zeros(L, torch.bool)
    best = _empty_split_cache(L, dev)
    for a, v in zip(best, root_split):
        a[0] = v[0]
    bestl = _empty_split_cache(L, dev)
    bestr = _empty_split_cache(L, dev)

    mt_f = meta.missing_type.to(torch.int64)
    db_f = meta.default_bin.to(torch.int64)
    nb_f = meta.num_bins.to(torch.int64)
    j_iota = torch.arange(KMAX, device=dev)
    num_leaves, num_waves = 1, 0

    while L > 1:
        # ---- ORDER: ready leaves with positive gain split in gain order
        keyed = best.gain
        budget = L - num_leaves
        rg, rl = _top_k(torch.where(ready, keyed,
                                    torch.full_like(keyed, NEG_INF)), KMAX)
        sel = (rg > 0.0) & (j_iota < budget)
        if slack > 0.0:
            sel = _slack_guard(sel, rg, keyed, j_iota, budget, L, slack)
        napp, go_on = torch.stack([sel.sum(),
                                   (keyed.max() > 0.0).to(torch.int64)]
                                  ).tolist()
        if num_leaves >= L or not go_on:
            break
        nl0 = num_leaves
        tbl = torch.full((16, 128), -1, dtype=torch.int32, device=dev)
        tbl[15] = nl0

        # ---- APPLY (the selection is a prefix of the gain order)
        if napp > 0:
            pa = rl[:napp]
            s_idx = torch.arange(nl0 - 1, nl0 - 1 + napp, device=dev)
            r_idx = torch.arange(nl0, nl0 + napp, device=dev)
            bs2 = SplitResult(*[x[pa] for x in best])
            bl = [x[pa] for x in bestl]
            br = [x[pa] for x in bestr]
            iv, iw, ic = leaf_output[pa], leaf_sum_h[pa], leaf_count[pa]
            prev, was_left = leaf_parent_node[pa], leaf_is_left[pa]
            depth_child = leaf_depth[pa] + 1
            hsm = small_hist[pa]
            hlg = hist_cache[pa] - hsm
            sil = small_is_left[pa][:, None]

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
                                 bs2.right_sum_h)):
                arr[pa] = lv
                arr[r_idx] = rv
            hist_cache[pa] = torch.where(sil, hsm, hlg)
            hist_cache[r_idx] = torch.where(sil, hlg, hsm)
            for a, lv, rv in zip(best, bl, br):
                a[pa] = lv
                a[r_idx] = rv
            num_leaves += napp

            f2 = bs2.feature
            tbl[0:7, :napp] = torch.stack([
                pa, f2, bs2.threshold, bs2.default_left.to(torch.int64),
                mt_f[f2], db_f[f2], nb_f[f2]]).to(torch.int32)

        # ---- SPECULATE: top-K unready frontier leaves by gain
        budget2 = L - num_leaves
        keyed2 = best.gain
        gains, cand = _top_k(torch.where(ready,
                                         torch.full_like(keyed2, NEG_INF),
                                         keyed2), KMAX)
        valid = (gains > 0.0) & (j_iota < budget2)
        if slack > 0.0:
            valid = _slack_guard(valid, gains, keyed2, j_iota, budget2, L,
                                 slack)
        bs = SplitResult(*[x[cand] for x in best])
        smaller_is_left = bs.left_count <= bs.right_count
        fc = bs.feature
        tbl[7:15, :KMAX] = torch.stack([
            torch.where(valid, cand, -1), fc, bs.threshold,
            bs.default_left.to(torch.int64), mt_f[fc], db_f[fc], nb_f[fc],
            smaller_is_left.to(torch.int64)]).to(torch.int32)
        n_cand = int(valid.sum())

        # ---- one row sweep: relabel (+ candidate histograms)
        num_waves += 1
        if n_cand == 0:
            leaf_of_row = wave_relabel(X_t, leaf_of_row, tbl, L, plain=plain)
            continue
        K = next(k for k in buckets if k >= n_cand)
        leaf_of_row, hist_wave = wave_pass(X_t, vals0, leaf_of_row, tbl, K,
                                           B, L, plain=plain)

        # ---- SEARCH both children of every candidate
        c_idx = cand[:n_cand]
        sl = smaller_is_left[:n_cand, None]
        hist_small = hist_wave[:n_cand].reshape(n_cand, -1)
        hist_large = hist_cache[c_idx] - hist_small
        hist_lr = torch.cat([torch.where(sl, hist_small, hist_large),
                             torch.where(sl, hist_large, hist_small)]
                            ).reshape((2 * n_cand,) + tuple(hist_root.shape))

        def both(a, b):
            return torch.cat([a[:n_cand], b[:n_cand]])

        s_lr = search(hist_lr, both(bs.left_sum_g, bs.right_sum_g),
                      both(bs.left_sum_h, bs.right_sum_h),
                      both(bs.left_count, bs.right_count),
                      both(bs.left_output, bs.right_output))
        # depth mask at store time: the order step reads stored gains
        can = (leaf_depth[c_idx] + 1 < max_depth).repeat(2)
        s_lr = s_lr._replace(gain=torch.where(
            can, s_lr.gain, torch.full_like(s_lr.gain, NEG_INF)))
        small_hist[c_idx] = hist_small
        small_is_left[c_idx] = smaller_is_left[:n_cand]
        ready[c_idx] = True
        for a_l, a_r, v in zip(bestl, bestr, s_lr):
            a_l[c_idx] = v[:n_cand]
            a_r[c_idx] = v[n_cand:]

    tree = DeviceTree(
        num_leaves=num_leaves, split_feature=split_feature,
        threshold_bin=threshold_bin, default_left=default_left,
        split_gain=split_gain, left_child=left_child[:M],
        right_child=right_child[:M], internal_value=internal_value,
        internal_weight=internal_weight, internal_count=internal_count,
        leaf_value=leaf_value, leaf_weight=leaf_weight,
        leaf_count=leaf_count, split_parent_leaf=split_parent_leaf,
        num_waves=num_waves)
    return tree, leaf_of_row
