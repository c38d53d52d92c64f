"""The growers at one fixed shape, with no host reads: batched training's
tree step on every wave route ("mega", "apply", "fused", "fused_tiled")
(`WaveStepper`) and on the serial growers masked and compact
(`SerialStepper`, one split a step; see its docstring).

Counterpart of the body and condition of the JAX package's
`lax.while_loop` over waves (lightgbm_tpu/ops/grow_wave.py:2095-2124):
`wave_step` and `cond`, and of its start state (:760-790). Where the
per-iteration grower (ops/grow_wave.py:grow_tree_wave) reads two counts a
wave to pick the bucketed K and slice its operands, every wave here runs
at the route's K cap (the largest of `wave_buckets_for`) over the same
shapes:

  * the counts stay on the device: the number of leaves, of waves, and
    the masks of the applied and speculated entries (`sel`, `valid`);
  * every `[:n]` slice and `if n == 0` branch becomes a masked write: an
    entry outside its mask writes to a trash slot (leaf L, node M) that
    nothing reads, as JAX's `scat(..., mode="drop")` drops it;
  * the row pass always runs: a wave table entry of -1 names no leaf, so
    the kernels skip it (#3 / #9 through rows 0 and 7, #4 / #10 through
    their leaf maps, #1 through slots outside [0, K));
  * a wave after the tree has ended (`active` false: no positive gain,
    or the leaf budget spent) applies and speculates nothing and leaves
    every array bitwise as it was, so a host that polls with a lag may
    run a few such waves.

`more` ([] int32) says after the root and after every wave whether another
wave would do work; the host reads it (batched.py polls it every LAG
waves). The float histograms accumulate in f64 and the quantized ones in
int32, so a candidate's sums do not depend on K: the trees equal the
per-iteration grower's bit for bit.

Covered: float and int8 quantized gradients (with `quant_renew_leaf`),
categorical and EFB storages, the row-wise histogram layouts, monotone
`basic` with monotone_penalty, monotone `intermediate`, interaction sets,
feature_fraction_bynode, extra_trees, the gain-slack rule, forced splits,
wave_exact and the fused routes:

  * "fused" runs #9 and "fused_tiled" #10 every wave at the route's cap
    (`fused_kcap`), their records unpacked over the fixed width and, on
    "fused_tiled", merged with the categorical search outside; #10 takes
    its descale factors and the pending relabel's first leaf from device
    memory. "fused_tiled" drops the applies-only deferral of the
    per-iteration grower (`fused_relabel_fusion`): every wave's applied
    entries go in `dec` bit 0, its candidates in bit 1, and no relabel is
    pending. A deferral moves no row to another leaf, so the trees are
    the same;
  * monotone `intermediate` serializes its applies on the device, refreshes
    every bound after a wave that applied, and re-searches the stale
    leaves as a third block of K children, masked by `stale`;
  * wave_exact takes its applies from `exact_order`, on the device;
  * forced splits rank a leaf whose best is its forced split first and
    hand the forced table's children on.

CEGB stays on the per-iteration grower, as in the JAX package
(models/gbdt.py:can_batch_iters names it).

Every per-tree value arrives as a tensor (the seed keys the draws through
utils/random.py's DevKey), the steps write their state in place, and no
step reads the device from the host: a CUDA graph captured from a step
replays it (models/batched.py). The valid sets' rows are relabelled by the
same wave tables (#5 on "mega" / "fused", #4 on "apply" / "fused_tiled"),
so a tree's valid-set leaves are ready when it ends, with no walk over the
tree.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..models.tree import MISSING_NAN, MISSING_ZERO
from .categorical import find_best_split_categorical
from .grow import (DeviceTree, GrowConfig, SerialDist, empty_split_cache,
                   serial_hist_route, serial_root, serial_search,
                   split_go_left)
from .grow_fused import (fused_feature_mask, pack_fused_meta,
                         pack_fused_scalars, unpack_fused_records)
from .grow_wave import (_slack_guard, _split_rows, _top_k, dec_go_left,
                        discretize_gradients, exact_order,
                        intermediate_leaves, monotone_child_bounds,
                        monotone_penalty_factor, node_masks, pack_wave_cats,
                        refresh_bounds, renew_leaf_values, wave_buckets_for,
                        wave_bundle_map, wave_routes, xt_bins)
from . import histogram_cuda as hc
from .histogram import (HistPlan, add_leaf_values_, build_histogram,
                        build_histogram_slots, build_histogram_window,
                        make_hist_plan, wave_apply, wave_pass,
                        wave_pass_fused, wave_pass_fused_tiled, wave_relabel,
                        window_partition)
from .split import (NEG_INF, FeatureMeta, SplitResult, find_best_split,
                    find_best_split_and_forced, synth_count_channel)
from ..utils.random import PRNGKey, fold_in

# the fields of a tree's record (DeviceTree's but the grower's host reads)
TREE_FIELDS = tuple(f for f in DeviceTree._fields if f != "host_reads")


class WaveStepper:
    """The fixed-shape state of one tree and its three steps: `start` (the
    root), `wave` (one wave at K = the route's cap; `step`, the runner's
    name for it) and `finish` (leaf renewal and the score updates). Leaf
    arrays hold L + 1 entries and node arrays M + 1, the last one the trash
    slot of masked writes; `device_tree()` views the first L / M."""

    step_name = "wave"

    def __init__(self, X_t: torch.Tensor, meta: FeatureMeta,
                 cfg: GrowConfig, *, hist_plan: Optional[HistPlan] = None,
                 valid_X: Sequence[torch.Tensor] = (),
                 plain: bool = False,
                 leaf_map: Optional[torch.Tensor] = None):
        if cfg.has_cegb:
            # CEGB's used features carry over from tree to tree: the JAX
            # package trains it per iteration too
            raise ValueError("no fixed-shape wave step for CEGB")
        self.X_t, self.meta, self.cfg = X_t, meta, cfg
        self.plain = plain
        dev = self.dev = X_t.device
        F_st, N = X_t.shape
        self.F = F = meta.num_bins.shape[0]
        self.route, self.hroute = wave_routes(cfg, F_st)
        self.fused = self.route in ("fused", "fused_tiled")
        self.hist_plan = hist_plan
        self.L = L = cfg.num_leaves
        # one buffer for every launch, so the captured graphs replay it
        self.gmap = leaf_map if leaf_map is not None or plain \
            else hc.new_leaf_map(dev, L)
        self.M = M = max(L - 1, 1)
        self.B = B = cfg.num_bins_padded
        self.W = W = cfg.cat_words
        self.K = K = wave_buckets_for(cfg, self.route)[-1]
        self.C = C = 2
        self.quant = cfg.use_quantized_grad
        self.has_mono = meta.monotone is not None
        self.mono_inter = (self.has_mono
                           and cfg.monotone_method == "intermediate")
        self.has_inter = meta.inter_sets is not None
        self.has_forced = meta.forced is not None
        self.exact = cfg.wave_exact
        self.use_mpen = self.has_mono and cfg.monotone_penalty > 0.0
        self.S = meta.inter_sets.shape[0] if self.has_inter else 1
        self.bynode = cfg.feature_fraction_bynode < 1.0
        self.xt = cfg.extra_trees
        self.max_depth = cfg.max_depth if cfg.max_depth > 0 else 10 ** 9
        self.bundle_map = wave_bundle_map(cfg, dev)
        self.j_iota = torch.arange(K, device=dev)
        self.valid_X = list(valid_X)

        def z(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        hdt = torch.int32 if self.quant else torch.float32
        self.hist_shape = (C, F_st, B)
        # per-tree inputs the waves read
        self.vals0 = z((C, N), torch.int8 if self.quant else torch.float32)
        self.ch_scale = z(2)
        self.g, self.h = z(N), z(N)
        self.seed = z((), torch.int64)
        self.fmask = None
        # tree record
        self.split_feature = z(M + 1, torch.int64)
        self.threshold_bin = z(M + 1, torch.int64)
        self.default_left = z(M + 1, torch.bool)
        self.split_gain = z(M + 1)
        self.left_child = z(M + 1, torch.int32)
        self.right_child = z(M + 1, torch.int32)
        self.internal_value = z(M + 1)
        self.internal_weight = z(M + 1)
        self.internal_count = z(M + 1, torch.int32)
        self.split_parent_leaf = z(M + 1, torch.int64)
        self.split_is_cat = z(M + 1, torch.bool)
        self.split_cat_bitset = z((M + 1, W), torch.int64)
        self.leaf_value = z(L + 1)
        self.leaf_weight = z(L + 1)
        self.leaf_count = z(L + 1, torch.int32)
        # grower state
        self.leaf_of_row = z(N, torch.int32)
        self.leaf_parent_node = z(L + 1, torch.int64)
        self.leaf_is_left = z(L + 1, torch.bool)
        self.leaf_depth = z(L + 1, torch.int64)
        self.leaf_output = z(L + 1)
        self.leaf_sum_g = z(L + 1)
        self.leaf_sum_h = z(L + 1)
        self.leaf_min = z(L + 1)
        self.leaf_max = z(L + 1)
        self.leaf_sets = z((L + 1, self.S), torch.bool)
        self.hist_cache = z((L + 1, C * F_st * B), hdt)
        self.small_hist = z((L + 1, C * F_st * B), hdt)
        self.small_is_left = z(L + 1, torch.bool)
        self.ready = z(L + 1, torch.bool)
        self.best = empty_split_cache(L + 1, dev)
        self.best_is_cat = z(L + 1, torch.bool)
        self.best_bitset = z((L + 1, W), torch.int64)
        self.bestl = empty_split_cache(L + 1, dev)
        self.bestr = empty_split_cache(L + 1, dev)
        self.catl, self.catr = z(L + 1, torch.bool), z(L + 1, torch.bool)
        self.bitsl = z((L + 1, W), torch.int64)
        self.bitsr = z((L + 1, W), torch.int64)
        # forced splits: each leaf's forced-node id (-1: none), whether its
        # cached best is that forced split, and the same for the
        # speculated children (grow_wave.py:215-221)
        self.leaf_forced = z(L + 1, torch.int64)
        self.best_forced = z(L + 1, torch.bool)
        self.fidl = z(L + 1, torch.int64)
        self.fidr = z(L + 1, torch.int64)
        self.bfl, self.bfr = z(L + 1, torch.bool), z(L + 1, torch.bool)
        # monotone intermediate: each leaf's side of every node and the
        # leaves whose bounds moved since their own search
        if self.mono_inter:
            self.under = z((L + 1, M), torch.int8)
            self.stale = z(L + 1, torch.bool)
        if self.fused:
            self.fmeta = pack_fused_meta(meta)
        if self.route == "fused_tiled":
            # #10's decision bits, one row an entry, and its pending
            # operands, never live here
            self.dec = z((K, N), torch.uint8)
            self.pend_leaf = torch.full((128,), -1, dtype=torch.int32,
                                        device=dev)
            self.pend_nl0 = z(1, torch.int32)
        self.num_leaves = z((), torch.int64)
        self.num_waves = z((), torch.int64)
        self.more = z((), torch.int32)
        self.valid_leaf = [z(Xv.shape[1], torch.int32) for Xv in valid_X]

    # ------------------------------------------------------------------
    def _to_f32(self, hist):
        """Descale [n, C, F, B] int32 sums (grow_wave.py:409-413)."""
        if self.quant:
            return hist.to(torch.float32) * self.ch_scale[:, None, None]
        return hist

    def _sets_to_fmask(self, sets):
        m = (self.meta.inter_sets[None, :, :] & sets[:, :, None]).any(dim=1)
        return m if self.fmask is None else m & self.fmask

    def _mpen_factor(self, depth):
        return monotone_penalty_factor(depth, self.cfg.monotone_penalty)

    def _child_bounds(self, bsx, pmin, pmax):
        return monotone_child_bounds(bsx, pmin, pmax, self.meta.monotone,
                                     self.mono_inter)

    def _child_sets(self, bsx, psets):
        return psets & self.meta.inter_sets.t()[bsx.feature]

    def _sel_key(self, gain, is_forced, fid):
        """The wave's selection key (grow_wave.py:431-439): a leaf whose
        best is its forced split outranks every other, forced nodes in BFS
        order."""
        if not self.has_forced:
            return gain
        return torch.where(is_forced, 3e18 - fid.to(torch.float32) * 1e12,
                           gain)

    def _keyed(self):
        """The [L] selection keys of the cached bests."""
        L = self.L
        return self._sel_key(self.best.gain[:L], self.best_forced[:L],
                             self.leaf_forced[:L])

    def _node_draws(self, step, n: int):
        """The per-node draws of step `step` (0 at the root, the wave count
        + 1 in the waves), n rows (grow_wave.py:620-631): PRNGKey(seed +
        0x5EED) and PRNGKey(seed * 31 + extra_seed), on the device."""
        fm = rb = None
        if self.bynode:
            fm = node_masks(fold_in(PRNGKey(self.seed + 0x5EED), step), n,
                            self.F, self.cfg.feature_fraction_bynode,
                            self.dev)
        if self.xt:
            rb = xt_bins(fold_in(PRNGKey(self.seed * 31
                                         + self.cfg.extra_seed), step), n,
                         self.meta.num_bins)
        return fm, rb

    def _search(self, hist2, sum_g, sum_h, count, out, bmin=None, bmax=None,
                fmask=None, mpf=None, rand_bins=None, fid=None, num=None):
        """Best splits of n histograms [n, C, F_st, B] of storage columns:
        (SplitResult [n], is_cat [n], bitset [n, W], forced [n]), the
        per-iteration grower's search without CEGB. `num` is the numeric
        search's result when a fused kernel ran it (hist2 then feeds the
        categorical search alone); `fid` [n] the leaves' forced-node ids
        (-1: none), whose split replaces the best where it can be made."""
        meta, cfg, hp = self.meta, self.cfg, self.cfg.hp
        n = count.shape[0]
        unforced = torch.zeros(n, dtype=torch.bool, device=self.dev)
        nobits = torch.zeros((n, self.W), dtype=torch.int64, device=self.dev)
        if num is not None and not cfg.has_categorical:
            return num, unforced, nobits, unforced
        if cfg.bundled:
            flat = hist2.reshape(n, self.C, -1)
            flat = torch.cat([flat, flat.new_zeros((n, self.C, 1))], dim=-1)
            hist2 = self._to_f32(flat.index_select(-1, meta.bundle_expand)
                                 .reshape(n, self.C, self.F, self.B))
            parent = torch.stack([sum_g, sum_h], dim=-1)
            miss = parent[:, :, None] - hist2.sum(dim=-1)
            hist2 = hist2 + meta.bundle_mfb * miss[..., None]
        else:
            hist2 = self._to_f32(hist2)
        hist = synth_count_channel(hist2, count, sum_h)
        fres = None
        if num is None and fid is not None:
            fc = fid.clamp(0, meta.forced.shape[1] - 1)
            num, fres = find_best_split_and_forced(
                hist, sum_g, sum_h, count, out, meta, hp, fmask, bmin, bmax,
                meta.forced[0, fc], meta.forced[1, fc], rand_bins=rand_bins,
                mono_pen_factor=mpf)
        elif num is None:
            num = find_best_split(hist, sum_g, sum_h, count, out, meta, hp,
                                  fmask, leaf_min=bmin, leaf_max=bmax,
                                  mono_pen_factor=mpf, rand_bins=rand_bins)
        if cfg.has_categorical:
            catres, bits = find_best_split_categorical(
                hist, sum_g, sum_h, count, out, meta, hp, cfg.cat, fmask,
                leaf_min=bmin, leaf_max=bmax)
            use_cat = catres.gain > num.gain          # numeric wins ties
            merged = SplitResult(*[torch.where(use_cat, cv, nv)
                                   for cv, nv in zip(catres, num)])
            bits = torch.where(use_cat[:, None], bits, 0)
        else:
            merged, use_cat, bits = num, unforced, nobits
        if fres is None:
            return merged, use_cat, bits, unforced
        use_f = (fid >= 0) & torch.isfinite(fres.gain)
        merged = SplitResult(*[torch.where(use_f, fv, mv)
                               for fv, mv in zip(fres, merged)])
        return (merged, use_cat & ~use_f,
                torch.where(use_f[:, None], 0, bits), use_f)

    # ------------------------------------------------------------------
    def start(self, grad: torch.Tensor, hess: torch.Tensor,
              in_bag: torch.Tensor, feature_mask: Optional[torch.Tensor],
              seed: torch.Tensor) -> None:
        """The root of a tree: sampled gradients (and their int8 form),
        the root histogram and search, and the state reset in place.
        `seed` is the tree's int32 seed as an int64 device tensor."""
        L, dev = self.L, self.dev
        cfg, hp = self.cfg, self.cfg.hp
        self.seed.copy_(seed)
        self.fmask = feature_mask
        g = grad.to(torch.float32) * in_bag
        h = hess.to(torch.float32) * in_bag
        cnt_row = (in_bag > 0).to(torch.float32)
        root_g, root_h, root_c = g.sum(), h.sum(), cnt_row.sum()
        self.g.copy_(g)
        self.h.copy_(h)
        if self.quant:
            vals0, ch_scale = discretize_gradients(
                g, h, cfg.num_grad_quant_bins, cfg.stochastic_rounding,
                self.seed)
            self.vals0.copy_(vals0)
            self.ch_scale.copy_(ch_scale)
        else:
            self.vals0.copy_(torch.stack([g, h]))
        root_out = (-torch.sign(root_g)
                    * torch.clamp(torch.abs(root_g) - hp.lambda_l1, min=0.0)
                    / (root_h + hp.lambda_l2))
        hist_root = build_histogram(self.X_t, self.vals0, self.B,
                                    impl=self.hroute, plan=self.hist_plan,
                                    plain=self.plain)
        one = torch.ones(1, dtype=torch.float32, device=dev)
        root_fmask = (self._sets_to_fmask(
            torch.ones((1, self.S), dtype=torch.bool, device=dev))
            if self.has_inter else feature_mask)
        root_bn, root_rb = self._node_draws(0, 1)
        if root_bn is not None:
            root_fmask = root_bn if root_fmask is None \
                else root_fmask & root_bn
        # the forced table's node 0 is the root's (grow_wave.py:771)
        root_fid = (torch.zeros(1, dtype=torch.int64, device=dev)
                    if self.has_forced else None)
        split, is_cat, bits, forced = self._search(
            hist_root[None], root_g[None], root_h[None], root_c[None],
            root_out[None], bmin=-torch.inf * one if self.has_mono else None,
            bmax=torch.inf * one if self.has_mono else None,
            fmask=root_fmask,
            mpf=self._mpen_factor(0 * one) if self.use_mpen else None,
            rand_bins=root_rb, fid=root_fid)
        if self.max_depth < 1:
            split = split._replace(gain=torch.full_like(split.gain, NEG_INF))
            forced = torch.zeros_like(forced)

        for name in ("split_feature", "threshold_bin", "default_left",
                     "split_gain", "left_child", "right_child",
                     "internal_value", "internal_weight", "internal_count",
                     "split_parent_leaf", "split_is_cat", "split_cat_bitset",
                     "leaf_value", "leaf_weight", "leaf_count", "leaf_of_row",
                     "leaf_is_left", "leaf_depth", "leaf_output",
                     "leaf_sum_g", "leaf_sum_h", "hist_cache", "small_hist",
                     "small_is_left", "ready", "best_is_cat", "best_bitset",
                     "catl", "catr", "bitsl", "bitsr", "best_forced", "bfl",
                     "bfr"):
            getattr(self, name).zero_()
        for name in ("leaf_forced", "fidl", "fidr", "leaf_parent_node"):
            getattr(self, name).fill_(-1)
        if self.mono_inter:
            self.under.zero_()
            self.stale.zero_()
        self.leaf_weight[0] = root_h
        self.leaf_count[0] = root_c.to(torch.int32)
        self.leaf_output[0] = root_out
        self.leaf_sum_g[0] = root_g
        self.leaf_sum_h[0] = root_h
        self.leaf_min.fill_(-torch.inf)
        self.leaf_max.fill_(torch.inf)
        self.leaf_sets.fill_(True)
        self.hist_cache[0] = hist_root.reshape(-1)
        for cache in (self.best, self.bestl, self.bestr):
            cache.gain.fill_(NEG_INF)
            for a in cache[1:]:
                a.zero_()
        for a, v in zip(self.best, split):
            a[0] = v[0]
        self.best_is_cat[0] = is_cat[0]
        self.best_bitset[0] = bits[0]
        if self.has_forced:
            self.leaf_forced[:1].zero_()
            self.best_forced[0] = forced[0]
        self.num_leaves.fill_(1)
        self.num_waves.zero_()
        for vl in self.valid_leaf:
            vl.zero_()
        self.more.copy_(((self._keyed().max() > 0.0) & (L > 1))
                        .to(torch.int32))

    # ------------------------------------------------------------------
    def _order(self, keyed, nl0, im_leaf, active):
        """ORDER (grow_wave.py:921-963): the leaves that split this wave, in
        the order they split, and the mask of the applied ones (a prefix):
        the ready leaves with positive gain in gain order, trimmed to the
        leaf budget and the gain-slack rule and, under intermediate,
        serialized; or wave_exact's strict leaf-wise order."""
        L, K, j = self.L, self.K, self.j_iota
        ready = self.ready[:L]
        if self.exact:
            pa, sel = exact_order(
                keyed, self._sel_key(self.bestl.gain[:L], self.bfl[:L],
                                     self.fidl[:L]),
                self._sel_key(self.bestr.gain[:L], self.bfr[:L],
                              self.fidr[:L]),
                ready, im_leaf, nl0, L, K)
            return pa, sel & active
        budget = L - nl0
        rg, pa = _top_k(torch.where(ready, keyed,
                                    torch.full_like(keyed, NEG_INF)), K)
        sel = (rg > 0.0) & (j < budget)
        if self.cfg.wave_gain_slack > 0.0:
            sel = _slack_guard(sel, rg, keyed, j, budget, L,
                               self.cfg.wave_gain_slack)
        if self.mono_inter:
            # among the leaves under a monotone node or splitting on a
            # monotone feature, only the first in gain order applies; the
            # selected entries then lead, in gain order (grow_wave.py:
            # 1259-1271)
            ser = im_leaf | (self.meta.monotone[self.best.feature[:L]] != 0)
            sel_mono = sel & ser[pa]
            first = (torch.cumsum(sel_mono.to(torch.int32), 0) == 1) \
                & sel_mono
            sel = sel & (~sel_mono | first)
            order = torch.sort((~sel).to(torch.int8), stable=True).indices
            pa, sel = pa[order], sel[order]
        return pa, sel & active

    def wave(self) -> None:
        """One wave at K = the route's cap: APPLY the ready leaves the
        order selects, SPECULATE the top-K frontier leaves, the route's
        row pass, SEARCH both children of every candidate (and under
        intermediate the stale leaves); inert when the tree has ended."""
        L, M, K, W, dev = self.L, self.M, self.K, self.W, self.dev
        cfg, meta = self.cfg, self.meta
        slack = cfg.wave_gain_slack
        j = self.j_iota
        nl0 = self.num_leaves.clone()
        best, ready = self.best, self.ready[:L]
        im_leaf = None
        if self.mono_inter:
            im_leaf = intermediate_leaves(self.under[:L],
                                          self.split_feature[:M],
                                          meta.monotone, nl0)

        # ---- ORDER: whether the tree goes on, and the applied leaves
        keyed = self._keyed()
        active = (keyed.max() > 0.0) & (nl0 < L)
        pa, sel = self._order(keyed, nl0, im_leaf, active)
        napp = sel.sum()

        # ---- APPLY: the applied entries lead, so entry j splits node
        # nl0 - 1 + j and its right child is leaf nl0 + j
        s_idx = nl0 - 1 + j
        r_idx = nl0 + j
        pa_w = torch.where(sel, pa, L)
        r_w = torch.where(sel, r_idx, L)
        s_w = torch.where(sel, s_idx, M)
        bs2 = SplitResult(*[x[pa] for x in best])
        iscat2, bits2 = self.best_is_cat[pa], self.best_bitset[pa]
        bl = [x[pa] for x in self.bestl]
        br = [x[pa] for x in self.bestr]
        cl, cr = self.catl[pa], self.catr[pa]
        bil, bir = self.bitsl[pa], self.bitsr[pa]
        iv, iw = self.leaf_output[pa], self.leaf_sum_h[pa]
        ic = self.leaf_count[pa]
        prev, was_left = self.leaf_parent_node[pa], self.leaf_is_left[pa]
        depth_child = self.leaf_depth[pa] + 1
        hsm = self.small_hist[pa]
        hlg = self.hist_cache[pa] - hsm
        sil = self.small_is_left[pa][:, None]
        if self.has_mono:
            almin, almax, armin, armax = self._child_bounds(
                bs2, self.leaf_min[pa], self.leaf_max[pa])
            self.leaf_min[pa_w] = almin
            self.leaf_min[r_w] = armin
            self.leaf_max[pa_w] = almax
            self.leaf_max[r_w] = armax
        if self.has_inter:
            asets = self._child_sets(bs2, self.leaf_sets[pa])
            self.leaf_sets[pa_w] = asets
            self.leaf_sets[r_w] = asets
        if self.mono_inter:
            # the children inherit the parent's subtree membership and
            # join the new node's sides (grow_wave.py:1369-1378)
            pu = self.under[pa]
            newcol = torch.arange(M, device=dev)[None, :] == s_idx[:, None]
            self.under[pa_w] = torch.where(newcol, 1, pu).to(torch.int8)
            self.under[r_w] = torch.where(newcol, 2, pu).to(torch.int8)
        self.split_feature[s_w] = bs2.feature
        self.threshold_bin[s_w] = bs2.threshold
        self.default_left[s_w] = bs2.default_left
        self.split_gain[s_w] = bs2.gain
        self.left_child[s_w] = (~pa).to(torch.int32)
        self.right_child[s_w] = (~r_idx).to(torch.int32)
        self.internal_value[s_w] = iv
        self.internal_weight[s_w] = iw
        self.internal_count[s_w] = ic
        self.split_parent_leaf[s_w] = pa
        self.split_is_cat[s_w] = iscat2
        self.split_cat_bitset[s_w] = bits2
        # rewire the parent node's child pointer (~p -> s)
        fix = (prev >= 0) & sel
        s32 = s_idx.to(torch.int32)
        self.left_child[torch.where(fix & was_left, prev, M)] = s32
        self.right_child[torch.where(fix & ~was_left, prev, M)] = s32
        pairs = [(self.leaf_value, bs2.left_output, bs2.right_output),
                 (self.leaf_weight, bs2.left_sum_h, bs2.right_sum_h),
                 (self.leaf_count, bs2.left_count.to(torch.int32),
                  bs2.right_count.to(torch.int32)),
                 (self.leaf_parent_node, s_idx, s_idx),
                 (self.leaf_depth, depth_child, depth_child),
                 (self.leaf_output, bs2.left_output, bs2.right_output),
                 (self.leaf_sum_g, bs2.left_sum_g, bs2.right_sum_g),
                 (self.leaf_sum_h, bs2.left_sum_h, bs2.right_sum_h),
                 (self.best_is_cat, cl, cr),
                 (self.best_bitset, bil, bir)]
        if self.has_forced:
            pairs += [(self.leaf_forced, self.fidl[pa], self.fidr[pa]),
                      (self.best_forced, self.bfl[pa], self.bfr[pa])]
        for arr, lv, rv in pairs:
            arr[pa_w] = lv
            arr[r_w] = rv
        # constant writes fill: a Python value assigned through an index
        # would be copied in from the host
        self.ready.index_fill_(0, pa_w, False)
        self.ready.index_fill_(0, r_w, False)
        self.leaf_is_left.index_fill_(0, pa_w, True)
        self.leaf_is_left.index_fill_(0, r_w, False)
        self.hist_cache[pa_w] = torch.where(sil, hsm, hlg)
        self.hist_cache[r_w] = torch.where(sil, hlg, hsm)
        for a, lv, rv in zip(best, bl, br):
            a[pa_w] = lv
            a[r_w] = rv
        self.num_leaves.add_(napp)
        if self.mono_inter:
            # after a wave that applied, every bound against the new
            # outputs; a leaf whose bounds moved waits for its re-search
            new_min, new_max, moved = refresh_bounds(
                self.under[:L], self.leaf_output[:L], self.leaf_min[:L],
                self.leaf_max[:L], self.split_feature[:M], meta.monotone,
                self.num_leaves)
            applied = napp > 0
            moved = moved & applied
            self.leaf_min[:L] = torch.where(applied, new_min,
                                            self.leaf_min[:L])
            self.leaf_max[:L] = torch.where(applied, new_max,
                                            self.leaf_max[:L])
            ready.logical_and_(~moved)
            self.stale[:L].logical_or_(moved)
        tbl = torch.full((16, 128), -1, dtype=torch.int32, device=dev)
        tbl[15] = nl0
        tbl[0, :K] = torch.where(sel, pa, -1).to(torch.int32)
        tbl[1:7, :K] = _split_rows(bs2.feature, bs2.threshold,
                                   bs2.default_left, meta)

        # ---- SPECULATE: the top-K unready frontier leaves by gain (a
        # stale leaf waits for its own re-search)
        budget2 = L - self.num_leaves
        keyed2 = self._keyed()
        excl = ready | self.stale[:L] if self.mono_inter else ready
        gains, cand = _top_k(torch.where(excl,
                                         torch.full_like(keyed2, NEG_INF),
                                         keyed2), K)
        valid = (gains > 0.0) & (j < budget2)
        if slack > 0.0 and not self.exact:
            valid = _slack_guard(valid, gains, keyed2, j, budget2, L, slack)
        valid = valid & active
        bs = SplitResult(*[x[cand] for x in best])
        smaller_is_left = bs.left_count <= bs.right_count
        self.num_waves.add_(active.to(torch.int64))
        tbl[7, :K] = torch.where(valid, cand, -1).to(torch.int32)
        tbl[8:14, :K] = _split_rows(bs.feature, bs.threshold,
                                    bs.default_left, meta)
        tbl[14, :K] = smaller_is_left.to(torch.int32)
        cons = self._children_constraints(bs, cand)

        # ---- the route's row pass: relabel, candidate histograms (and on
        # the fused routes their children's numeric searches)
        rec = None
        if self.route in ("mega", "fused"):
            if self.route == "mega":
                lor, hist_wave = wave_pass(self.X_t, self.vals0,
                                           self.leaf_of_row, tbl, K, self.B,
                                           L, plain=self.plain,
                                           gmap=self.gmap)
            else:
                lor, hist_wave, rec = wave_pass_fused(
                    self.X_t, self.vals0, self.leaf_of_row, tbl,
                    self.hist_cache[cand],
                    pack_fused_scalars(bs, smaller_is_left, cons[0],
                                       cons[1]),
                    self.fmeta, fused_feature_mask(self.fmask, self.F, dev),
                    K, self.B, L, cfg.hp, plain=self.plain, gmap=self.gmap)
            for Xv, vl in zip(self.valid_X, self.valid_leaf):
                wave_relabel(Xv, vl, tbl, L, out=vl, plain=self.plain,
                             gmap=self.gmap)
        else:
            cats = None
            if cfg.has_categorical:
                cats = pack_wave_cats(iscat2, bits2, self.best_is_cat[cand],
                                      self.best_bitset[cand], W)
            if self.route == "apply":
                lor, slot_small = wave_apply(self.X_t, self.leaf_of_row, tbl,
                                             cats, self.bundle_map, K, L,
                                             plain=self.plain,
                                             gmap=self.gmap)
                hist_wave = build_histogram_slots(
                    self.X_t, self.vals0, slot_small, K, self.B,
                    impl=self.hroute, plan=self.hist_plan, plain=self.plain)
            else:
                # #10 reads go-left bits per (entry, row): bit 0 under
                # applied entry j, bit 1 = lands in candidate j's smaller
                # child; no relabel is pending
                gla = dec_go_left(self.X_t, bs2.feature, bs2.threshold,
                                  bs2.default_left, iscat2, bits2, meta, cfg)
                glc = dec_go_left(self.X_t, bs.feature, bs.threshold,
                                  bs.default_left, self.best_is_cat[cand],
                                  self.best_bitset[cand], meta, cfg)
                land = glc == smaller_is_left[:, None]
                torch.bitwise_or(gla.to(torch.uint8),
                                 land.to(torch.uint8) << 1, out=self.dec)
                del gla, glc, land
                fm_lr = cons[2]
                fm_lr = (fm_lr.to(torch.uint8).contiguous()
                         if self.has_inter else
                         fused_feature_mask(self.fmask, self.F, dev, 2 * K))
                lor, hist_wave, rec = wave_pass_fused_tiled(
                    self.X_t, self.vals0, self.dec, self.leaf_of_row, tbl,
                    self.pend_leaf, self.pend_nl0, self.hist_cache[cand],
                    pack_fused_scalars(bs, smaller_is_left, cons[0],
                                       cons[1]),
                    self.fmeta, fm_lr, K, self.B, L, cfg.hp,
                    self.ch_scale if self.quant else None, plain=self.plain,
                    gmap=self.gmap)
            for Xv, vl in zip(self.valid_X, self.valid_leaf):
                # the valid rows hold the original features: no bundle map
                vl.copy_(wave_apply(Xv, vl, tbl, cats, None, K, L,
                                    plain=self.plain, gmap=self.gmap)[0])
        self.leaf_of_row.copy_(lor)

        # ---- SEARCH both children of every candidate (the fused kernels
        # ran the numeric search already), and under intermediate the
        # stale leaves' own bests as a third block (grow_wave.py:1766-1800)
        hist_small = hist_wave.reshape(K, -1)
        num = unpack_fused_records(rec, K) if rec is not None else None
        hist_lr = None
        if num is None or cfg.has_categorical:
            sl = smaller_is_left[:, None]
            hist_large = self.hist_cache[cand] - hist_small
            hist_lr = torch.cat([torch.where(sl, hist_small, hist_large),
                                 torch.where(sl, hist_large, hist_small)]
                                ).reshape((2 * K,) + self.hist_shape)

        def both(a, b):
            return torch.cat([a, b])
        sg_lr = both(bs.left_sum_g, bs.right_sum_g)
        sh_lr = both(bs.left_sum_h, bs.right_sum_h)
        c_lr = both(bs.left_count, bs.right_count)
        o_lr = both(bs.left_output, bs.right_output)
        bmin, bmax, fmask, mpf = cons
        # the children's forced-node ids: a candidate whose best is its
        # forced split hands the table's children on (grow_wave.py:
        # 1815-1825)
        fid_lr = None
        if self.has_forced:
            cf = self.best_forced[cand]
            fc = self.leaf_forced[cand].clamp(0, meta.forced.shape[1] - 1)
            fidl_k = torch.where(cf, meta.forced[2, fc], -1)
            fidr_k = torch.where(cf, meta.forced[3, fc], -1)
            fid_lr = both(fidl_k, fidr_k)
        can = (self.leaf_depth[cand] + 1 < self.max_depth).repeat(2)
        rows = 2 * K
        if self.mono_inter:
            # the stale leaves' own histograms, sums, bounds and sets; the
            # own block re-splits the leaf itself, so its depth gate is
            # depth < max_depth
            stale = self.stale[:L]
            rs_i = _top_k(torch.where(stale,
                                      torch.clamp(best.gain[:L], min=0.0),
                                      torch.full_like(best.gain[:L],
                                                      NEG_INF)), K)[1]
            rs_ok = (j < stale.sum()) & active
            hist_lr = torch.cat([hist_lr, self.hist_cache[rs_i].reshape(
                (K,) + self.hist_shape)])
            sg_lr = both(sg_lr, self.leaf_sum_g[rs_i])
            sh_lr = both(sh_lr, self.leaf_sum_h[rs_i])
            c_lr = both(c_lr, self.leaf_count[rs_i].to(torch.float32))
            o_lr = both(o_lr, self.leaf_output[rs_i])
            bmin = both(bmin, self.leaf_min[rs_i])
            bmax = both(bmax, self.leaf_max[rs_i])
            if self.has_inter:
                fmask = both(fmask, self._sets_to_fmask(self.leaf_sets[rs_i]))
            if self.use_mpen:
                mpf = both(mpf, self._mpen_factor(self.leaf_depth[rs_i]))
            if self.has_forced:
                fid_lr = both(fid_lr, self.leaf_forced[rs_i])
            can = both(can, self.leaf_depth[rs_i] < self.max_depth)
            rows = 3 * K
        bn, rb = self._node_draws(self.num_waves + 1, rows)
        if bn is not None:
            fmask = bn if fmask is None else fmask & bn
        s_lr, cat_lr, bits_lr, forced_lr = self._search(
            hist_lr, sg_lr, sh_lr, c_lr, o_lr, bmin, bmax, fmask, mpf, rb,
            fid_lr, num)
        s_lr = s_lr._replace(gain=torch.where(
            can, s_lr.gain, torch.full_like(s_lr.gain, NEG_INF)))
        forced_lr = forced_lr & can
        c_w = torch.where(valid, cand, L)
        self.small_hist[c_w] = hist_small
        self.small_is_left[c_w] = smaller_is_left
        self.ready.index_fill_(0, c_w, True)
        for a_l, a_r, v in zip(self.bestl, self.bestr, s_lr):
            a_l[c_w] = v[:K]
            a_r[c_w] = v[K:2 * K]
        self.catl[c_w], self.catr[c_w] = cat_lr[:K], cat_lr[K:2 * K]
        self.bitsl[c_w], self.bitsr[c_w] = bits_lr[:K], bits_lr[K:2 * K]
        if self.has_forced:
            self.fidl[c_w], self.fidr[c_w] = fidl_k, fidr_k
            self.bfl[c_w] = forced_lr[:K]
            self.bfr[c_w] = forced_lr[K:2 * K]
        if self.mono_inter:
            # install the re-searched bests; the leaves re-enter as
            # candidates next wave (grow_wave.py:2066-2085)
            r_w2 = torch.where(rs_ok, rs_i, L)
            for a, v in zip(best, s_lr):
                a[r_w2] = v[2 * K:]
            self.best_is_cat[r_w2] = cat_lr[2 * K:]
            self.best_bitset[r_w2] = bits_lr[2 * K:]
            if self.has_forced:
                self.best_forced[r_w2] = forced_lr[2 * K:]
            self.stale.index_fill_(0, r_w2, False)
        self.more.copy_(((self._keyed().max() > 0.0)
                         & (self.num_leaves < L)).to(torch.int32))

    step = wave

    def _children_constraints(self, bsx, leaves):
        """What the search of both children of the candidates `leaves`
        (best splits `bsx`) reads, left children first: (bounds min,
        bounds max, feature mask [2K, F] or the tree's, penalty factor);
        None where the regime is off."""
        bmin = bmax = mpf = None
        fmask = self.fmask
        if self.has_mono:
            lmin, lmax, rmin, rmax = self._child_bounds(
                bsx, self.leaf_min[leaves], self.leaf_max[leaves])
            bmin, bmax = torch.cat([lmin, rmin]), torch.cat([lmax, rmax])
        if self.has_inter:
            allow = self._sets_to_fmask(self._child_sets(
                bsx, self.leaf_sets[leaves]))
            fmask = torch.cat([allow, allow])
        if self.use_mpen:
            d = self.leaf_depth[leaves] + 1
            mpf = self._mpen_factor(torch.cat([d, d]))
        return bmin, bmax, fmask, mpf

    # ------------------------------------------------------------------
    def finish(self, lr: torch.Tensor, scores: torch.Tensor,
               valid_scores: Sequence[torch.Tensor] = ()) -> None:
        """The tree's end: quant_train_renew_leaf's refit, then the score
        updates (#2) of the training rows and of each valid set by the
        leaf values times `lr` (an f32 device scalar)."""
        self.renew_leaves()
        step = self.leaf_value[:self.L] * lr
        add_leaf_values_(scores, step, self.leaf_of_row, plain=self.plain)
        for vs, vl in zip(valid_scores, self.valid_leaf):
            add_leaf_values_(vs, step, vl, plain=self.plain)

    def renew_leaves(self) -> None:
        """quant_train_renew_leaf: the leaf values refitted from exact float
        leaf sums (grow_wave.py:1311-1313)."""
        L, cfg = self.L, self.cfg
        if self.quant and cfg.quant_renew_leaf and cfg.path_smooth <= 1e-15:
            self.leaf_value[:L].copy_(renew_leaf_values(
                self.leaf_value[:L], self.leaf_of_row, self.g, self.h,
                self.num_leaves, self.K, cfg.hp, plain=self.plain))

    def device_tree(self) -> DeviceTree:
        """The tree grown so far as a DeviceTree whose num_leaves and
        num_waves are device scalars."""
        L, M = self.L, self.M
        return DeviceTree(
            num_leaves=self.num_leaves, split_feature=self.split_feature[:M],
            threshold_bin=self.threshold_bin[:M],
            default_left=self.default_left[:M],
            split_gain=self.split_gain[:M], left_child=self.left_child[:M],
            right_child=self.right_child[:M],
            internal_value=self.internal_value[:M],
            internal_weight=self.internal_weight[:M],
            internal_count=self.internal_count[:M],
            leaf_value=self.leaf_value[:L], leaf_weight=self.leaf_weight[:L],
            leaf_count=self.leaf_count[:L],
            split_parent_leaf=self.split_parent_leaf[:M],
            split_is_cat=self.split_is_cat[:M],
            split_cat_bitset=self.split_cat_bitset[:M],
            num_waves=self.num_waves)


def partition_record(start: torch.Tensor, count: torch.Tensor,
                     bs: SplitResult, is_cat: torch.Tensor,
                     bits: torch.Tensor, new_leaf: torch.Tensor,
                     meta: FeatureMeta) -> torch.Tensor:
    """The int32 record of `window_partition` for one split ([1] tensors
    on the device; bits [1, W] int64 words): start, count, storage column,
    threshold, default_left, the missing bin (dec_go_left's `mbin`, -1:
    none), is_cat, new leaf, W, then the W words as int32 bit patterns."""
    F = meta.num_bins.shape[0]
    f = bs.feature.clamp(0, F - 1)
    mt = meta.missing_type.to(torch.int64)[f]
    db = meta.default_bin.to(torch.int64)[f]
    nb = meta.num_bins.to(torch.int64)[f]
    mbin = torch.where(mt == MISSING_ZERO, db,
                       torch.where(mt == MISSING_NAN, nb - 1,
                                   torch.full_like(db, -1)))
    words = bits.reshape(-1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    head = torch.cat([start, count, f, bs.threshold,
                      bs.default_left.to(torch.int64), mbin,
                      is_cat.to(torch.int64), new_leaf,
                      torch.full_like(start, words.shape[0])])
    return torch.cat([head, words]).to(torch.int32)


class SerialStepper:
    """The fixed-shape state of one tree of a serial grower, `masked` or
    `compact`, and its three steps: `start` (the root), `split` (one split; `step`,
    the runner's name for it) and `finish` (the score updates). The
    counterpart of the JAX package's serial growers inside its batched
    scan (`fori_loop` over L - 1 splits, grow.py:610, grow_fast.py:394),
    which run every split, a finished tree's ones inert.

    The per-iteration growers (ops/grow.py:grow_tree and
    ops/grow_fast.py:grow_tree_fast) drive these steps eagerly, through
    grow_tree_serial, so both paths grow the same trees. The split counter,
    the chosen leaf (`argmax` of the cached gains, the lowest id on ties,
    as jnp.argmax) and the new leaf's id live on the device, and every
    write into the tree record goes through device indices; a split after
    the tree has ended (no positive gain, or the leaves spent) writes only
    to the trash slots (leaf L, node M) and moves no row. `more` ([] int32)
    says whether another split would do work.

    masked: one pass over all rows a split, #1 at K = 2 (the leaf's left
    rows in slot 0, its right rows in slot 1), the children's exact in-bag
    counts. compact: the leaf windows' start and count are [L] device
    tensors; the split's stable partition of its window
    (`window_partition`, left rows first, the right rows relabelled) and
    the smaller child's histogram (#1 over the window's row ids,
    `build_histogram_window`) both read the window from device memory, so
    their work follows the window, not N; the larger child is the parent's
    histogram less the smaller's, in f32. The windows are exact, not the
    JAX package's power-of-two buckets, whose padded rows add nothing to
    the sums. The window histograms take the uniform grid whatever
    histogram_impl says (the row-wise layouts give the same
    f64-accumulated sums); the root takes the configured route.

    Valid rows follow each split's decision (`split_go_left`), so a tree's
    valid-set leaves are ready when it ends."""

    step_name = "split"

    def __init__(self, X_t: torch.Tensor, meta: FeatureMeta,
                 cfg: GrowConfig, *, compact: bool,
                 hist_plan: Optional[HistPlan] = None,
                 valid_X: Sequence[torch.Tensor] = (),
                 plain: bool = False, dist=None):
        self.X_t, self.meta, self.cfg = X_t, meta, cfg
        self.compact = compact
        self.sd = SerialDist(dist, cfg, meta.num_bins.shape[0], compact)
        self.plain = plain
        dev = self.dev = X_t.device
        F_st, N = X_t.shape
        self.L = L = cfg.num_leaves
        self.M = M = max(L - 1, 1)
        self.B = cfg.num_bins_padded
        W = cfg.cat_words
        self.hroute = serial_hist_route(cfg, F_st)
        if self.hroute != "slots" and hist_plan is None:
            hist_plan = make_hist_plan(X_t, self.hroute, cfg.hist_tiers)
        self.hist_plan = hist_plan
        self.max_depth = cfg.max_depth if cfg.max_depth > 0 else 10 ** 9
        self.valid_X = list(valid_X)
        self.fmask = None

        def z(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        self.vals = z((2, N))
        self.cnt_row = z(N)
        # the tree record, then the per-leaf state
        self.split_feature = z(M + 1, torch.int64)
        self.threshold_bin = z(M + 1, torch.int64)
        self.default_left = z(M + 1, torch.bool)
        self.split_gain = z(M + 1)
        self.left_child = z(M + 1, torch.int32)
        self.right_child = z(M + 1, torch.int32)
        self.internal_value = z(M + 1)
        self.internal_weight = z(M + 1)
        self.internal_count = z(M + 1, torch.int32)
        self.split_parent_leaf = z(M + 1, torch.int64)
        self.split_is_cat = z(M + 1, torch.bool)
        self.split_cat_bitset = z((M + 1, W), torch.int64)
        self.leaf_value = z(L + 1)
        self.leaf_weight = z(L + 1)
        self.leaf_count = z(L + 1, torch.int32)
        self.leaf_output = z(L + 1)
        self.leaf_sum_g = z(L + 1)
        self.leaf_sum_h = z(L + 1)
        self.leaf_parent_node = z(L + 1, torch.int64)
        self.leaf_is_left = z(L + 1, torch.bool)
        self.leaf_depth = z(L + 1, torch.int64)
        self.best = empty_split_cache(L + 1, dev)
        self.best_is_cat = z(L + 1, torch.bool)
        self.best_bitset = z((L + 1, W), torch.int64)
        self.leaf_of_row = z(N, torch.int32)
        self.num_leaves = z((), torch.int64)
        self.num_waves = z((), torch.int64)
        self.more = z((), torch.int32)
        self.valid_leaf = [z(Xv.shape[1], torch.int32) for Xv in valid_X]
        if compact:
            self.rows = torch.arange(N, dtype=torch.int32, device=dev)
            self.order = z(N, torch.int32)
            self.leaf_start = z(L + 1, torch.int64)
            self.leaf_cnt = z(L + 1, torch.int64)
            self.hist_cache = z((L + 1, 2, F_st, self.B))
            self.win = z(2, torch.int32)

    # ------------------------------------------------------------------
    def start(self, grad: torch.Tensor, hess: torch.Tensor,
              in_bag: torch.Tensor, feature_mask: Optional[torch.Tensor],
              seed: torch.Tensor) -> None:
        """The root (ops/grow.py:serial_root, the per-iteration growers'
        own) copied into the static state, which is reset in place. The
        serial growers take no seed."""
        L, M = self.L, self.M
        self.fmask = feature_mask
        g, h, cnt_row, hist_root, rec = serial_root(
            self.X_t, grad, hess, in_bag, self.meta, self.cfg, feature_mask,
            self.hroute, self.hist_plan, self.plain, self.sd)
        self.vals.copy_(torch.stack([g, h]))
        self.cnt_row.copy_(cnt_row)
        for name in ("split_feature", "threshold_bin", "default_left",
                     "split_gain", "left_child", "right_child",
                     "internal_value", "internal_weight", "internal_count",
                     "split_parent_leaf", "split_is_cat",
                     "split_cat_bitset"):
            dst = getattr(self, name)
            dst[:M].copy_(getattr(rec, name))
            dst[M:].zero_()
        for name in ("leaf_value", "leaf_weight", "leaf_count",
                     "leaf_output", "leaf_sum_g", "leaf_sum_h",
                     "best_is_cat", "best_bitset"):
            dst = getattr(self, name)
            dst[:L].copy_(getattr(rec, name))
            dst[L:].zero_()
        for dst, src in zip(self.best, rec.best):
            dst[:L].copy_(src)
            dst[L:].zero_()
        self.best.gain[L:].fill_(NEG_INF)
        self.leaf_parent_node.fill_(-1)
        self.leaf_is_left.zero_()
        self.leaf_depth.zero_()
        self.leaf_of_row.zero_()
        for vl in self.valid_leaf:
            vl.zero_()
        self.num_leaves.fill_(1)
        self.num_waves.zero_()
        if self.compact:
            self.order.copy_(self.rows)
            self.leaf_start.zero_()
            self.leaf_cnt.zero_()
            self.leaf_cnt[:1].fill_(self.X_t.shape[1])
            self.hist_cache[0] = hist_root
        self.more.copy_(((self.best.gain[:L].max() > 0.0) & (L > 1))
                        .to(torch.int32))

    # ------------------------------------------------------------------
    def split(self) -> None:
        """One split: the leaf of largest cached gain, its node recorded and
        the parent's pointer rewired, its rows moved, both children's
        histograms and searches cached; inert once the tree has ended."""
        L, M, meta, cfg = self.L, self.M, self.meta, self.cfg
        gains = self.best.gain[:L]
        p = torch.argmax(gains).reshape(1)
        active = (gains.index_select(0, p) > 0.0) & (self.num_leaves < L)
        s = (self.num_leaves - 1).reshape(1)
        r = self.num_leaves.clone().reshape(1)   # _apply counts the leaf
        p_w = torch.where(active, p, L)
        s_w = torch.where(active, s, M)
        r_w = torch.where(active, r, L)
        bs = SplitResult(*[a.index_select(0, p) for a in self.best])
        is_cat = self.best_is_cat.index_select(0, p)
        bits = self.best_bitset.index_select(0, p)
        if self.compact:
            sil = (bs.left_count <= bs.right_count).reshape(())
            n_left, n_right = bs.left_count, bs.right_count
        else:
            gl = split_go_left(self.X_t, bs, is_cat, bits[0], meta, cfg)
            lor = self.leaf_of_row
            in_p = lor == p_w
            # rows of p: slot 0 going left, slot 1 going right; others -1
            slot = torch.where(in_p, (~gl).to(torch.int32),
                               torch.full_like(lor, -1))
            self.leaf_of_row.copy_(torch.where(in_p & ~gl,
                                               r.to(torch.int32), lor))
            n_left = self.sd.psum(
                (self.cnt_row * (in_p & gl).to(torch.float32)).sum()
                .reshape(1))
            n_right = self.leaf_count.index_select(0, p).to(torch.float32) \
                - n_left
            bs = bs._replace(left_count=n_left, right_count=n_right)
        depth = self._apply(p, p_w, s, s_w, r, r_w, active, bs, is_cat, bits,
                            n_left, n_right)
        if self.compact:
            lo = self.leaf_start.index_select(0, p_w)
            n = self.leaf_cnt.index_select(0, p_w)
            nl = window_partition(
                self.X_t, self.order, self.leaf_of_row,
                partition_record(lo, n, bs, is_cat, bits, r, meta),
                plain=self.plain).to(torch.int64)
            # the left child keeps [lo, lo + nl), the right child the rest
            self.leaf_start[r_w] = lo + nl
            self.leaf_cnt[r_w] = n - nl
            self.leaf_cnt[p_w] = nl
            a = lo + torch.where(sil, 0, nl)
            m = torch.where(sil, nl, n - nl)
            self.win.copy_(torch.cat([a, a + m]).to(torch.int32))
            hist_small = self.sd.psum(build_histogram_window(
                self.X_t, self.vals, self.order, self.win, self.B,
                plain=self.plain))
            hist_large = self.hist_cache.index_select(0, p)[0] - hist_small
            hist_l = torch.where(sil, hist_small, hist_large)
            hist_r = torch.where(sil, hist_large, hist_small)
            self.hist_cache[p_w] = hist_l[None]
            self.hist_cache[r_w] = hist_r[None]
            hist_lr = torch.stack([hist_l, hist_r])
        else:
            hist_lr = self.sd.exchange(build_histogram_slots(
                self.X_t, self.vals, slot, 2, self.B, impl=self.hroute,
                plan=self.hist_plan, plain=self.plain))
        s_lr, cat_lr, bits_lr = self.sd.search(
            hist_lr, torch.cat([bs.left_sum_g, bs.right_sum_g]),
            torch.cat([bs.left_sum_h, bs.right_sum_h]),
            torch.cat([n_left, n_right]),
            torch.cat([bs.left_output, bs.right_output]), meta, cfg,
            self.fmask)
        # both children's bests, gain -inf past max_depth
        can = depth < self.max_depth
        s_lr = s_lr._replace(gain=torch.where(
            can, s_lr.gain, torch.full_like(s_lr.gain, NEG_INF)))
        for a, v in zip(self.best, s_lr):
            a[p_w] = v[:1]
            a[r_w] = v[1:]
        self.best_is_cat[p_w] = cat_lr[:1]
        self.best_is_cat[r_w] = cat_lr[1:]
        self.best_bitset[p_w] = bits_lr[:1]
        self.best_bitset[r_w] = bits_lr[1:]
        for Xv, vl in zip(self.valid_X, self.valid_leaf):
            glv = split_go_left(Xv, bs, is_cat, bits[0], meta, cfg)
            vl.copy_(torch.where((vl == p_w) & ~glv, r.to(torch.int32), vl))
        self.more.copy_(((self.best.gain[:L].max() > 0.0)
                         & (self.num_leaves < L)).to(torch.int32))

    step = split

    def _apply(self, p, p_w, s, s_w, r, r_w, active, bs, is_cat, bits,
               left_count, right_count) -> torch.Tensor:
        """Record split s of leaf p as Tree::Split does (node s, the
        parent's child pointer, both children's leaf state), through the
        masked indices; returns the children's depth ([1])."""
        M = self.M
        self.split_feature[s_w] = bs.feature
        self.threshold_bin[s_w] = bs.threshold
        self.default_left[s_w] = bs.default_left
        self.split_gain[s_w] = bs.gain
        self.left_child[s_w] = (~p).to(torch.int32)
        self.right_child[s_w] = (~r).to(torch.int32)
        self.internal_value[s_w] = self.leaf_output.index_select(0, p)
        self.internal_weight[s_w] = self.leaf_sum_h.index_select(0, p)
        self.internal_count[s_w] = self.leaf_count.index_select(0, p)
        self.split_parent_leaf[s_w] = p
        self.split_is_cat[s_w] = is_cat
        self.split_cat_bitset[s_w] = bits
        prev = self.leaf_parent_node.index_select(0, p)
        was_left = self.leaf_is_left.index_select(0, p)
        fix = (prev >= 0) & active
        s32 = s.to(torch.int32)
        self.left_child[torch.where(fix & was_left, prev, M)] = s32
        self.right_child[torch.where(fix & ~was_left, prev, M)] = s32
        depth = self.leaf_depth.index_select(0, p) + 1
        pairs = [(self.leaf_parent_node, s, s),
                 (self.leaf_depth, depth, depth),
                 (self.leaf_value, bs.left_output, bs.right_output),
                 (self.leaf_weight, bs.left_sum_h, bs.right_sum_h),
                 (self.leaf_count, left_count.to(torch.int32),
                  right_count.to(torch.int32)),
                 (self.leaf_output, bs.left_output, bs.right_output),
                 (self.leaf_sum_g, bs.left_sum_g, bs.right_sum_g),
                 (self.leaf_sum_h, bs.left_sum_h, bs.right_sum_h)]
        for arr, lv, rv in pairs:
            arr[p_w] = lv
            arr[r_w] = rv
        # constant writes fill: a Python value assigned through an index
        # would be copied in from the host
        self.leaf_is_left.index_fill_(0, p_w, True)
        self.leaf_is_left.index_fill_(0, r_w, False)
        self.num_leaves.add_(active[0].to(torch.int64))
        return depth

    # ------------------------------------------------------------------
    def finish(self, lr: torch.Tensor, scores: torch.Tensor,
               valid_scores: Sequence[torch.Tensor] = ()) -> None:
        """The score updates (#2) of the training rows and of each valid
        set by the leaf values times `lr` (an f32 device scalar)."""
        step = self.leaf_value[:self.L] * lr
        add_leaf_values_(scores, step, self.leaf_of_row, plain=self.plain)
        for vs, vl in zip(valid_scores, self.valid_leaf):
            add_leaf_values_(vs, step, vl, plain=self.plain)

    def device_tree(self) -> DeviceTree:
        """The tree grown so far as a DeviceTree whose num_leaves and
        num_waves (0) are device scalars."""
        L, M = self.L, self.M
        return DeviceTree(
            num_leaves=self.num_leaves, split_feature=self.split_feature[:M],
            threshold_bin=self.threshold_bin[:M],
            default_left=self.default_left[:M],
            split_gain=self.split_gain[:M], left_child=self.left_child[:M],
            right_child=self.right_child[:M],
            internal_value=self.internal_value[:M],
            internal_weight=self.internal_weight[:M],
            internal_count=self.internal_count[:M],
            leaf_value=self.leaf_value[:L], leaf_weight=self.leaf_weight[:L],
            leaf_count=self.leaf_count[:L],
            split_parent_leaf=self.split_parent_leaf[:M],
            split_is_cat=self.split_is_cat[:M],
            split_cat_bitset=self.split_cat_bitset[:M],
            num_waves=self.num_waves)


def grow_tree_serial(
    X_t: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
    in_bag: torch.Tensor, meta: FeatureMeta, cfg: GrowConfig,
    feature_mask: Optional[torch.Tensor] = None, *, compact: bool,
    hist_plan: Optional[HistPlan] = None, plain: bool = False,
    dist=None) -> tuple:
    """One tree of a serial grower (masked, or compact when `compact`)
    through SerialStepper's steps, eagerly: before each split one host read
    of `more`, and none after the split that makes the last leaf. Returns
    (DeviceTree with host counts and its reads, leaf_of_row)."""
    st = SerialStepper(X_t, meta, cfg, compact=compact, hist_plan=hist_plan,
                       plain=plain, dist=dist)
    st.start(grad, hess, in_bag, feature_mask, None)
    splits = reads = 0
    while splits < st.L - 1:
        reads += 1
        if not int(st.more):
            break
        st.split()
        splits += 1
    tree = st.device_tree()._replace(num_leaves=splits + 1, num_waves=0,
                                     host_reads=reads)
    return tree, st.leaf_of_row


def make_stepper(grower: str, X_t: torch.Tensor, meta: FeatureMeta,
                 cfg: GrowConfig, *, leaf_map: Optional[torch.Tensor] = None,
                 **kw):
    """The fixed-shape stepper of a grower: SerialStepper for "masked" and
    "compact", WaveStepper for the wave grower ("wave", "wave_exact"),
    which takes the booster's global leaf maps `leaf_map` (the serial
    growers launch no wave kernel)."""
    if grower in ("masked", "compact"):
        return SerialStepper(X_t, meta, cfg, compact=grower == "compact",
                             **kw)
    return WaveStepper(X_t, meta, cfg, leaf_map=leaf_map, **kw)


def grow_tree_wave_batched(
    X_t: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
    in_bag: torch.Tensor, meta: FeatureMeta, cfg: GrowConfig,
    feature_mask: Optional[torch.Tensor] = None, *,
    hist_plan: Optional[HistPlan] = None, rng_seed: int = 0,
    lag: int = 4, plain: bool = False) -> tuple:
    """One tree through the fixed-shape steps, eagerly, polling `more`
    every `lag` waves as the batched trainer does: (DeviceTree with device
    counts, leaf_of_row, host reads, waves run). The same tree as
    grow_tree_wave's with the same arguments."""
    st = WaveStepper(X_t, meta, cfg, hist_plan=hist_plan, plain=plain)
    st.start(grad, hess, in_bag, feature_mask,
             torch.tensor(rng_seed, dtype=torch.int64, device=X_t.device))
    reads = waves = 0
    while True:
        for _ in range(lag):
            st.wave()
            waves += 1
        reads += 1
        if not int(st.more):
            break
    st.renew_leaves()
    return st.device_tree(), st.leaf_of_row, reads, waves


