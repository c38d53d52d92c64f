"""Compacted leaf-wise growth: the compact serial grower.

Counterpart of lightgbm_tpu/ops/grow_fast.py:grow_tree_fast (the
reference's DataPartition, data_partition.hpp:22, and its smaller-child
histogram with the sibling by subtraction, serial_tree_learner.cpp:344).
An `order` permutation keeps the rows grouped by leaf, each leaf a window
[leaf_start, leaf_start + leaf_count); splitting a leaf stably partitions
only its window, left rows first, and the smaller child's histogram is
the slot histogram (#1) over the window's gathered [F, S] bins, its rows
in the other child masked out. The larger child's histogram is the
parent's minus the smaller one's, in f32, as the JAX package does.

The JAX package pads each window to a power-of-two bucket (`_bucket_sizes`)
because XLA needs static shapes, and masks the padded rows out. Here the
window is sliced exactly: the leaf windows' starts and counts live on the
host, and each split's left count comes back with the next split's
choice, one host read a split (and one after the last split). The sums
are those of the padded windows.

As in the JAX package, the tree's leaf and internal counts and the counts
the children's searches read are the split search's synthesized counts
(cnt_factor), not the window counts; out-of-bag rows stay in the windows
and are masked out of the histograms.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .grow import (DeviceTree, GrowConfig, serial_hist_route, serial_root,
                   serial_search, split_go_left)
from .histogram import HistPlan, build_histogram, make_hist_plan
from .split import FeatureMeta, SplitResult


def grow_tree_fast(
    X_t: torch.Tensor,            # [F, N] uint8, feature-major
    grad: torch.Tensor,           # [N] f32
    hess: torch.Tensor,           # [N] f32
    in_bag: torch.Tensor,         # [N] f32
    meta: FeatureMeta,
    cfg: GrowConfig,
    feature_mask: Optional[torch.Tensor] = None,
    *,
    hist_plan: Optional[HistPlan] = None,
    plain: bool = False,
) -> Tuple[DeviceTree, torch.Tensor]:
    """Compacted leaf-wise growth; the contract of ops/grow.py:grow_tree.
    The nibble-packed row-wise route packs each gathered window anew."""
    F_st, N = X_t.shape
    dev = X_t.device
    L = cfg.num_leaves
    B = cfg.num_bins_padded
    max_depth = cfg.max_depth if cfg.max_depth > 0 else 10 ** 9
    hroute = serial_hist_route(cfg, F_st)
    if hroute == "rowwise" and hist_plan is None:
        hist_plan = make_hist_plan(X_t, hroute, cfg.hist_tiers)
    _, _, _, hist_root, t = serial_root(X_t, grad, hess, in_bag, meta, cfg,
                                        feature_mask, hroute, hist_plan,
                                        plain)
    grad = grad.to(torch.float32)
    hess = hess.to(torch.float32)
    hist_cache = torch.zeros((L,) + tuple(hist_root.shape),
                             dtype=torch.float32, device=dev)
    hist_cache[0] = hist_root
    order = torch.arange(N, dtype=torch.int64, device=dev)
    start = [0] * L
    count = [0] * L
    count[0] = N
    reads = 0
    pend = None                  # (leaf, new leaf, left count on device)
    for s in range(L - 1):
        p, valid, got = t.next_leaf(*([] if pend is None else [pend[2]]))
        reads += 1
        if pend is not None:
            _settle(start, count, pend, int(got[0]))
            pend = None
        if not valid:
            break
        bs = SplitResult(*[a[p] for a in t.best])
        is_cat, bits = t.best_is_cat[p], t.best_bitset[p]
        sil = bs.left_count <= bs.right_count
        r = s + 1
        lo, n = start[p], count[p]
        depth = t.apply(s, p, bs, is_cat, bits, bs.left_count,
                        bs.right_count)
        if n > 0:
            idx = order[lo:lo + n].clone()
            Xg = X_t[:, idx]                                  # [F, S]
            gl = split_go_left(Xg, bs, is_cat, bits, meta, cfg)
            # stable partition of the window, left rows first
            perm = torch.sort((~gl).to(torch.uint8), stable=True).indices
            order[lo:lo + n] = idx[perm]
            n_left = gl.sum()
            in_small = torch.where(sil, gl, ~gl)
            m = in_small.to(torch.float32) * in_bag[idx]
            plan = (make_hist_plan(Xg, hroute, cfg.hist_tiers)
                    if hroute == "rowwise_packed" else hist_plan)
            hist_small = build_histogram(
                Xg, torch.stack([grad[idx] * m, hess[idx] * m]), B,
                impl=hroute, plan=plan, plain=plain)
        else:
            n_left = torch.zeros((), dtype=torch.int64, device=dev)
            hist_small = torch.zeros_like(hist_root)
        pend = (p, r, n_left)
        hist_large = hist_cache[p] - hist_small
        hist_l = torch.where(sil, hist_small, hist_large)
        hist_r = torch.where(sil, hist_large, hist_small)
        hist_cache[p], hist_cache[r] = hist_l, hist_r
        s_lr, cat_lr, bits_lr = serial_search(
            torch.stack([hist_l, hist_r]),
            torch.stack([bs.left_sum_g, bs.right_sum_g]),
            torch.stack([bs.left_sum_h, bs.right_sum_h]),
            torch.stack([bs.left_count, bs.right_count]),
            torch.stack([bs.left_output, bs.right_output]), meta, cfg,
            feature_mask)
        t.cache(p, r, s_lr, cat_lr, bits_lr, depth < max_depth)
    if pend is not None:
        _settle(start, count, pend, int(pend[2]))
        reads += 1
    # leaf_of_row from the final partition: the windows tile [0, N)
    leaves = [lf for lf in range(t.num_leaves) if count[lf] > 0]
    leaves.sort(key=lambda lf: start[lf])
    pos_leaf = torch.repeat_interleave(
        torch.tensor(leaves, dtype=torch.int32, device=dev),
        torch.tensor([count[lf] for lf in leaves], dtype=torch.int64,
                     device=dev), output_size=N)
    leaf_of_row = torch.empty(N, dtype=torch.int32, device=dev)
    leaf_of_row[order] = pos_leaf
    return t.device_tree(reads), leaf_of_row


def _settle(start, count, pend, n_left: int) -> None:
    """The host windows after leaf p's split: the left child keeps
    [start, start + n_left), the right child the rest."""
    p, r, _ = pend
    start[r] = start[p] + n_left
    count[r] = count[p] - n_left
    count[p] = n_left
