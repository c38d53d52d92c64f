"""Cross-tenant forest fusion: many tenants' forests scored together.

Counterpart of lightgbm_tpu/export/fusion.py. The fleet's unfused drain
scores one tenant a batch, so under many-tenant traffic nearly every batch
switches the resident model. Fusion packs every fusable tenant's binned
forest (BinnedModel, ops/predict_binned.py) into one padded supertensor,
the JAX package's layout:

 * flat node / leaf arrays are the per-tenant arrays concatenated, plus
   one shared zero leaf for padding;
 * per-tenant tree tables ``node_start / leaf_start / single_leaf /
   slot_of [C, Tmax]`` hold absolute offsets into the flat arrays; padded
   tree slots point at the zero leaf through the single-leaf path and at
   a garbage slot one past the end of the slot buffer.

The fused walk takes a per-row tenant id: gathering the tree tables by it
turns the per-tenant dispatch into four lookups inside the same lockstep
walk, run for the deepest tenant's depth. Each tree's leaf value lands in
its own (iteration, class) slot of an ``[n, I, Kmax]`` buffer filled with
-0.0, and ``ops/predict.py sum_iterations`` reduces the iteration axis: a
tenant with fewer iterations adds an exact -0.0 tail, so every tenant's
margins are bitwise those of its own ``engine="binned"`` session
(tests/test_torch_fusion.py).

:class:`FusedScorer` wraps the supertensor for the fleet: per-tenant host
binning of f64 rows, or, when every tenant session holds a serve-mode bin
table, raw f32 rows binned against the stacked table by the stacked
bucketize kernel (``ops/bucketize.py bucketize_rows_stacked``, one
launch), column padding to the widest tenant, power-of-two bucket padding,
and atomic republish on hot-swap (serving/fleet.py rebuilds on
``promote()``). ``num_shards > 1`` scores each batch data-parallel over
the local cards, the tenant-id vector split with the rows
(serving/session.py:resolve_shards; one card rounds it to 1).
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..ops.predict import sum_iterations
from ..utils.log import log_info


class FusedDeviceArrays(NamedTuple):
    """A supertensor on one device (int64 indices, the uint32 bitset words
    in int64); `num_cat`, `W`, `Kmax`, `iters` (the slot buffer's
    iterations, a power of two) and `depth` are Python ints."""
    node_start: torch.Tensor      # [C, Tmax]
    leaf_start: torch.Tensor      # [C, Tmax]
    single_leaf: torch.Tensor     # [C, Tmax] bool
    slot_of: torch.Tensor         # [C, Tmax]
    split_feature: torch.Tensor   # [M]
    threshold_bin: torch.Tensor   # [M]
    missing_bin: torch.Tensor     # [M]
    default_left: torch.Tensor    # [M] bool
    left_child: torch.Tensor      # [M]
    right_child: torch.Tensor     # [M]
    leaf_value: torch.Tensor      # [L + 1] f32, the last the zero leaf
    is_cat: torch.Tensor          # [M] bool
    cat_bitset: torch.Tensor      # [M, W]
    num_cat: int
    W: int
    Kmax: int
    iters: int
    depth: int


class FusedForest:
    """The supertensor: every fusable tenant's bin-domain forest packed
    into shared flat arrays + per-tenant [C, Tmax] tree tables."""

    def __init__(self, models: "Dict[str, object]") -> None:
        """`models`: ordered tenant name -> BinnedModel."""
        if not models:
            raise ValueError("FusedForest needs at least one tenant")
        self.names: List[str] = list(models)
        self.tid_of = {n: i for i, n in enumerate(self.names)}
        bms = [models[n] for n in self.names]
        C = len(bms)
        self.Tmax = max(bm.T for bm in bms)
        self.Fmax = max(bm.num_features for bm in bms)
        self.Kmax = max(bm.K for bm in bms)
        self.K_of = {n: bm.K for n, bm in zip(self.names, bms)}
        self.W = max(bm.W for bm in bms)
        self.num_cat = sum(bm.num_cat for bm in bms)
        self.depth = max(bm.max_depth for bm in bms)

        def cat(field, dtype):
            return np.concatenate(
                [np.asarray(getattr(bm, field), dtype) for bm in bms])

        self.split_feature = cat("split_feature", np.int32)
        self.threshold_bin = cat("threshold_bin", np.int32)
        self.missing_bin = cat("missing_bin", np.int32)
        self.default_left = cat("default_left", bool)
        self.left_child = cat("left_child", np.int32)
        self.right_child = cat("right_child", np.int32)
        self.is_cat = cat("is_cat", bool)
        # one shared zero leaf at the END pads every short tenant's tree
        # slots: single_leaf routing yields gl == leaf_start == this slot
        self.leaf_value = np.concatenate(
            [np.asarray(bm.leaf_value, np.float32) for bm in bms]
            + [np.zeros(1, np.float32)])
        self._zero_leaf = len(self.leaf_value) - 1
        self.cat_bitset = np.zeros((len(self.split_feature), self.W),
                                   np.uint32)
        node_off = 0
        for bm in bms:
            M = len(bm.split_feature)
            self.cat_bitset[node_off:node_off + M, :bm.cat_bitset.shape[1]] \
                = bm.cat_bitset
            node_off += M

        # slot_of routes tree t of tenant c into (iteration t // K_c,
        # class t % K_c) of the flat [ItersMax * Kmax] slot buffer;
        # padded tree slots go to a garbage slot one past the end. The
        # port's buffer holds a power of two of iterations (the tree sum's
        # width), so the garbage slot sits past that
        self.ItersMax = max(bm.T // bm.K for bm in bms)
        self.iters = 1 << max(self.ItersMax - 1, 0).bit_length()
        garbage = self.iters * self.Kmax
        self.node_start = np.zeros((C, self.Tmax), np.int32)
        self.leaf_start = np.full((C, self.Tmax), self._zero_leaf, np.int32)
        self.single_leaf = np.ones((C, self.Tmax), bool)
        self.slot_of = np.full((C, self.Tmax), garbage, np.int32)
        node_off = leaf_off = 0
        for c, bm in enumerate(bms):
            T = bm.T
            self.node_start[c, :T] = node_off + \
                np.asarray(bm.node_start[:-1], np.int32)
            self.leaf_start[c, :T] = leaf_off + \
                np.asarray(bm.leaf_start[:-1], np.int32)
            self.single_leaf[c, :T] = np.asarray(bm.single_leaf, bool)
            t = np.arange(T, dtype=np.int32)
            self.slot_of[c, :T] = (t // bm.K) * self.Kmax + (t % bm.K)
            node_off += len(bm.split_feature)
            leaf_off += len(bm.leaf_value)
        self._device: Dict[torch.device, FusedDeviceArrays] = {}

    def device_arrays(self, device: torch.device) -> FusedDeviceArrays:
        """The supertensor on `device`, uploaded once per build and
        device."""
        device = torch.device(device)
        fa = self._device.get(device)
        if fa is None:
            def i64(a):
                return torch.as_tensor(np.asarray(a, np.int64)).to(device)

            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)
            fa = FusedDeviceArrays(
                node_start=i64(self.node_start),
                leaf_start=i64(self.leaf_start),
                single_leaf=up(self.single_leaf),
                slot_of=i64(self.slot_of),
                split_feature=i64(self.split_feature),
                threshold_bin=i64(self.threshold_bin),
                missing_bin=i64(self.missing_bin),
                default_left=up(self.default_left),
                left_child=i64(self.left_child),
                right_child=i64(self.right_child),
                leaf_value=up(self.leaf_value),
                is_cat=up(self.is_cat),
                cat_bitset=i64(self.cat_bitset),
                num_cat=int(self.num_cat), W=int(self.W),
                Kmax=int(self.Kmax), iters=int(self.iters),
                depth=int(self.depth))
            self._device[device] = fa
        return fa


def predict_leaves_fused(fa: FusedDeviceArrays, Xb: torch.Tensor,
                         tid: torch.Tensor) -> torch.Tensor:
    """[n, Tmax] absolute leaf indices (into ``fa.leaf_value``) for a
    mixed-tenant batch: Xb [n, Fmax] uint8 bins (each row binned through
    its tenant's mappers), tid [n] tenant ids. The per-tenant tree tables
    gathered by tid replace ``predict_leaves_binned``'s [T] broadcasts;
    the walk takes the deepest tenant's ``fa.depth`` steps."""
    t = tid.to(torch.int64)
    Xi = Xb.to(torch.int64)
    ns = fa.node_start[t]                                 # [n, Tmax]
    node = torch.where(fa.single_leaf[t], -1, 0).to(torch.int64)
    for _ in range(fa.depth):
        g = node.clamp(min=0) + ns
        bv = torch.gather(Xi, 1, fa.split_feature[g])
        is_missing = bv == fa.missing_bin[g]
        go_left = torch.where(is_missing, fa.default_left[g],
                              bv <= fa.threshold_bin[g])
        if fa.num_cat > 0:
            words = fa.cat_bitset[g, (bv >> 5).clamp(0, fa.W - 1)]
            gl_cat = ((words >> (bv & 31)) & 1) == 1
            go_left = torch.where(fa.is_cat[g], gl_cat, go_left)
        nxt = torch.where(go_left, fa.left_child[g], fa.right_child[g])
        node = torch.where(node >= 0, nxt, node)
    return fa.leaf_start[t] + ~node


def predict_margin_fused(fa: FusedDeviceArrays, Xb: torch.Tensor,
                         tid: torch.Tensor) -> torch.Tensor:
    """[Kmax, n] f32 margins for a mixed-tenant batch (JAX
    predict_margin_fused): each tree's leaf value scattered into its
    unique (iteration, class) slot of a -0.0 buffer, then the iterations
    summed by ``sum_iterations``, the per-tenant walk's own reduction, so
    each row's first K_c margins are bitwise its tenant's
    ``predict_margin_binned``."""
    n = Xb.shape[0]
    gl = predict_leaves_fused(fa, Xb, tid)
    lv = fa.leaf_value[gl]                                # [n, Tmax] f32
    slots = fa.iters * fa.Kmax
    buf = torch.zeros((n, slots + 1), dtype=torch.float32,
                      device=Xb.device).neg_()
    buf.scatter_(1, fa.slot_of[tid.to(torch.int64)], lv)
    return sum_iterations(buf[:, :slots].reshape(n, fa.iters, fa.Kmax)).t()


class FusedScorer:
    """One immutable supertensor + its scorer. The fleet treats a scorer as
    a snapshot: hot-swapping any tenant builds a NEW scorer and republishes
    the reference atomically (a launch in flight finishes on the old
    supertensor)."""

    def __init__(self, sessions: "Dict[str, object]", *,
                 max_batch: int = 256, min_bucket: int = 8,
                 num_shards: int = 0, generation: int = 0,
                 warmup: bool = True) -> None:
        """`sessions`: tenant name -> ServingSession whose ``_bm`` (binned
        model) is set, i.e. engine "binned" or "compiled", all on one
        device."""
        from ..serving.session import bucket_for, resolve_shards
        self.generation = int(generation)
        self.sessions = dict(sessions)
        devices = {s.device for s in self.sessions.values()}
        if len(devices) != 1:
            raise ValueError(f"fused tenants must share one device, got "
                             f"{sorted(map(str, devices))}")
        self.device = devices.pop()
        self.forest = FusedForest(
            {n: s._bm for n, s in sessions.items()})
        self.fa = self.forest.device_arrays(self.device)
        self.max_batch = 1 << max(int(max_batch) - 1, 0).bit_length()
        # sharded scoring over the local cards, the tenant ids split with
        # the rows (fusion.py:193-212, :247-280)
        self._shard_devs = (resolve_shards(num_shards, self.device,
                                           "fused num_shards")
                            if num_shards > 1 else [])
        self.num_shards = len(self._shard_devs)
        self.min_bucket = bucket_for(
            max(int(min_bucket), self.num_shards or 1), 1, self.max_batch)
        # cross-tenant device binning: when EVERY tenant session holds a
        # serve-mode bin table, stack them so all-f32 mixed batches bin in
        # one launch of the stacked bucketize kernel
        self._stacked = None
        tables = [getattr(sessions[n], "_bin_table", None)
                  for n in self.forest.names]
        if tables and all(t is not None for t in tables):
            from ..ops.bucketize import stack_bin_tables, upload_stacked_table
            self._stacked = upload_stacked_table(stack_bin_tables(tables),
                                                 self.device)
            if self.device.type == "cuda":
                # build the kernel here: the fleet's worker thread must not
                # be the one that runs a first-use nvcc build
                from ..ops import histogram_cuda as hc
                hc._lib("bucketize_stacked")
        self._walk, self._raw = self._scorers()
        self.build_s = 0.0
        t0 = time.perf_counter()
        if warmup:
            self.warmup()
        self.build_s = time.perf_counter() - t0

    # ------------------------------------------------------------------
    def _scorers(self):
        """(uint8 walk, raw-f32 drain): [n, Fmax] rows + [n] tenant ids ->
        [Kmax, n]; under sharding each is `build_sharded_score_fn` over
        per-card copies of the supertensor (and stacked table)."""
        from ..ops.bucketize import (bucketize_rows_stacked,
                                     stack_bin_tables, upload_stacked_table)

        def make(fa, st):
            def walk(Xb, tid):
                return predict_margin_fused(fa, Xb, tid)

            def raw(Xf, tid):
                return predict_margin_fused(
                    fa, bucketize_rows_stacked(Xf, tid, st), tid)
            return walk, raw
        if not self._shard_devs:
            return make(self.fa, self._stacked)
        from ..parallel import build_sharded_score_fn
        tables = [self.sessions[n]._bin_table for n in self.forest.names]
        per = [make(self.forest.device_arrays(d),
                    upload_stacked_table(stack_bin_tables(tables), d)
                    if self._stacked is not None else None)
               for d in self._shard_devs]
        return (build_sharded_score_fn(self._shard_devs,
                                       [w for w, _ in per], 1),
                build_sharded_score_fn(self._shard_devs,
                                       [r for _, r in per], 1))

    def _score_raw(self, Xf: torch.Tensor, tid: torch.Tensor) -> torch.Tensor:
        """Raw-f32 fused drain: the stacked bucketize (one launch), then
        the fused walk; bit-identical to per-tenant binning + the uint8
        path."""
        return self._raw(Xf, tid)

    def warmup(self) -> List[int]:
        """Run the whole bucket ladder once before the scorer is
        published, so a supertensor swap never makes live traffic pay a
        first call."""
        ladder, b = [], self.min_bucket
        while b <= self.max_batch:
            ladder.append(b)
            b *= 2
        F = self.forest.Fmax
        for b in ladder:
            tid = torch.zeros(b, dtype=torch.int32, device=self.device)
            self._walk(torch.zeros((b, F), dtype=torch.uint8,
                                   device=self.device), tid).cpu()
            if self._stacked is not None:
                self._score_raw(torch.zeros((b, F), dtype=torch.float32,
                                            device=self.device), tid).cpu()
        log_info(f"fused scorer gen={self.generation} warm: "
                 f"tenants={len(self.forest.names)} buckets={ladder} "
                 f"device={self.device}")
        return ladder

    # ------------------------------------------------------------------
    def score_groups(self, groups: "List[Tuple[str, np.ndarray]]") \
            -> List[np.ndarray]:
        """Score a mixed-tenant batch in one fused walk. `groups` is a list
        of (tenant name, raw rows [n_i, F_i]); returns per-group [K_i, n_i]
        f64 raw margins (f32-accumulated values, bit-identical to each
        tenant's ``engine="binned"`` session). All-f32 groups against a
        stacked table ship raw and bin on the device."""
        from ..serving.session import bucket_for
        n = sum(g[1].shape[0] for g in groups)
        b = bucket_for(n, self.min_bucket, self.max_batch)
        raw = self._stacked is not None and all(
            np.asarray(X).dtype == np.float32 for _, X in groups)
        Xb = np.zeros((b, self.forest.Fmax),
                      np.float32 if raw else np.uint8)
        tid = np.zeros(b, np.int32)
        off = 0
        for name, X in groups:
            bm = self.sessions[name]._bm
            m = X.shape[0]
            if raw:
                Xb[off:off + m, :bm.num_features] = \
                    np.asarray(X)[:, :bm.num_features]
            else:
                Xb[off:off + m, :bm.num_features] = bm.bin_rows(
                    np.asarray(X, np.float64))
            tid[off:off + m] = self.forest.tid_of[name]
            off += m
        Xt = torch.from_numpy(Xb).to(self.device)
        tt = torch.from_numpy(tid).to(self.device)
        out = (self._score_raw(Xt, tt) if raw
               else self._walk(Xt, tt)).cpu().numpy()
        results = []
        off = 0
        for name, X in groups:
            m = X.shape[0]
            r = out[:self.K_of(name), off:off + m].astype(np.float64)
            sess = self.sessions[name]
            if sess._avg_div:
                r = r / sess._avg_div
            results.append(r)
            off += m
        return results

    def K_of(self, name: str) -> int:
        return self.forest.K_of[name]

    def can_serve(self, name: str) -> bool:
        return name in self.forest.tid_of
