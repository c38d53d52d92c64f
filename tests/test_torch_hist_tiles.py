"""The redesigned slot histogram (csrc/hist_slots.cu) and score update
(csrc/take_leaf_values.cu) of the port, on the CPU: the tile planner's
rule, the plain version of the kernel's row grouping, a plain emulation of
its tiled sweep (the kernel's tiles, accumulator layouts and cell indices),
and the in-place score update, against the port's plain versions and the
JAX package.

Tolerances:
  * f32 histograms of values on a 0.25 grid (sums exact in f32 and f64 in
    any order) and int8 -> int32 histograms are compared bitwise;
  * f32 histograms of random values against the JAX package's XLA lowering
    (f32 sums in another order) within rtol 1e-5 of the largest bin;
  * the score update is compared bitwise: one f32 add per row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.histogram import (_build_histogram_slots_xla,
                                        take_leaf_values)
from lightgbm_tpu.ops.histogram_pallas import take_leaf_values_pallas
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import histogram_cuda as hc

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tiles(plan, K, F):
    """(k0, nk, f0, nf) of every tile of `plan`, in the kernel's order."""
    for st in range(plan.slot_tiles):
        k0 = st * plan.slots_per_tile
        for ft in range(plan.feat_tiles):
            f0 = ft * plan.feats_per_tile
            yield (k0, min(K - k0, plan.slots_per_tile), f0,
                   min(F - f0, plan.feats_per_tile))


# ---------------------------------------------------------------------------
# the tile planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("K", [1, 16, 64, 128])
def test_plan_tiles_every_cell_once_within_budget(K, quantized):
    acc = 4 if quantized else 8
    for B in (16, 64, 256):
        for F in (1, 28, 39, 100):
            for C in (1, 2, 4):
                plan = hc.plan_hist_tiles(K, C, F, B, quantized=quantized)
                seen = np.zeros((K, F), np.int64)
                for k0, nk, f0, nf in _tiles(plan, K, F):
                    assert nk >= 1 and nf >= 1
                    seen[k0:k0 + nk, f0:f0 + nf] += 1
                    assert nk * C * nf * B * acc <= plan.smem_bytes
                what = (K, C, F, B, quantized, plan)
                assert (seen == 1).all(), what
                assert plan.smem_bytes <= hc.HIST_SMEM_BUDGET, what
                assert plan.blocks_per_sm >= 4, what
                assert plan.blocks_per_sm * (
                    plan.smem_bytes + hc.BLOCK_SMEM_RESERVED) \
                    <= hc.SM_SMEM_BYTES, what
                assert plan.grouped == (K > 1)
                assert plan.merge == (B >= hc.MERGE_MIN_BINS)
                assert plan.paired == (K == 1 and C == 2 and not quantized
                                       and not plan.merge)
                assert not plan.direct
                # few rows: the direct sweep at K > 1, the same tiles
                small = hc.plan_hist_tiles(K, C, F, B, quantized=quantized,
                                           rows=hc.DIRECT_MAX_ROWS)
                assert small.direct == (K > 1 or plan.feat_tiles == 1)
                assert small._replace(direct=False) == plan
                big = hc.DIRECT_MAX_ROWS + 1
                assert hc.plan_hist_tiles(
                    K, C, F, B, quantized=quantized, rows=big).direct == (
                    K == 1 and plan.feat_tiles == 1
                    and big * F <= hc.DIRECT_MAX_ADDS)


def test_plan_shapes_of_the_main_path():
    # bench root: one tile holds every feature
    p = hc.plan_hist_tiles(1, 2, 28, 64)
    assert (p.slot_tiles, p.feat_tiles, p.smem_bytes) == (1, 1, 28 * 1024)
    # Criteo root: 160 KB of accumulators cut into 4 tiles of 10 features
    p = hc.plan_hist_tiles(1, 2, 39, 256)
    assert (p.feats_per_tile, p.feat_tiles) == (10, 4)
    assert p.blocks_per_sm == 5
    # Criteo wave of 128 slots: no tile spills to global memory
    p = hc.plan_hist_tiles(128, 2, 39, 256)
    assert p.slot_tiles * p.feat_tiles == 512 and p.grouped and p.merge
    # narrow storage: several slots share a tile
    p = hc.plan_hist_tiles(128, 1, 4, 16)
    assert p.slots_per_tile > 1 and p.slots_per_tile * p.slot_tiles >= 128
    # the channel pairing only at the root: a wave over narrow storage
    # keeps the [nk][C][nf][B] layout
    assert hc.plan_hist_tiles(1, 2, 9, 64).paired
    p = hc.plan_hist_tiles(16, 2, 9, 64)
    assert p.slots_per_tile > 1 and not p.paired


@pytest.mark.parametrize("args", [
    (hc.MAX_GROUP_SLOTS + 1, 2, 28, 64), (1, 5, 28, 64),
    (1, 2, 28, hc.MAX_BINS + 1),
    (0, 2, 28, 64), (1, 2, 0, 64)])
def test_plan_raises_on_a_shape_it_cannot_tile(args):
    with pytest.raises(ValueError):
        hc.plan_hist_tiles(*args)


@pytest.mark.parametrize("N", [0, 100, 1 << 16, 1 << 20, 1 << 22])
def test_segments_and_grouping_warps(N):
    for K, F, B in ((1, 28, 64), (1, 39, 256), (16, 39, 256),
                    (128, 39, 256), (16, 28, 64)):
        plan = hc.plan_hist_tiles(K, 2, F, B)
        wave = 132 * plan.blocks_per_sm
        # segments of [0, N): one wave of the card, MIN_SEGMENT_ROWS each
        segs = hc.hist_segments(plan, N, 132, False)
        assert segs >= 1
        if segs > 1:
            assert N // segs >= hc.MIN_SEGMENT_ROWS
            assert plan.slot_tiles * plan.feat_tiles * segs <= wave
        # pieces of the grouped rows per feature tile: one wave
        pieces = hc.hist_segments(plan, N, 132, True)
        assert pieces >= 1 and (pieces == 1
                                or plan.feat_tiles * pieces <= wave)
    W = hc.group_warps(N)
    assert 1 <= W <= hc.MAX_GROUP_WARPS
    # the kernel's chunk: ceil(N / W) rounded up to 32 rows
    chunk = -(-max(-(-N // W), 1) // 32) * 32
    assert W * chunk >= N
    assert W == hc.MAX_GROUP_WARPS or chunk <= hc.GROUP_ROWS


# ---------------------------------------------------------------------------
# the row grouping's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("K,N", [(1, 777), (16, 5000), (128, 3001),
                                 (5, 0)])
def test_group_rows_by_slot_plain(K, N):
    rng = np.random.RandomState(K + N)
    slot = rng.randint(-3, K + 3, size=N).astype(np.int32)
    counts, offsets, rows = hc.group_rows_by_slot_plain(_t(slot), K)
    keep = (slot >= 0) & (slot < K)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(slot[keep], minlength=K))
    assert offsets[0] == 0 and offsets[-1] == keep.sum()
    np.testing.assert_array_equal(np.diff(offsets.numpy()), counts.numpy())
    r = rows.numpy()
    assert rows.dtype == torch.int32 and len(r) == keep.sum()
    # a permutation of the in-range rows, grouped by slot, ascending
    np.testing.assert_array_equal(np.sort(r), np.nonzero(keep)[0])
    for k in range(K):
        seg = r[int(offsets[k]):int(offsets[k + 1])]
        assert (slot[seg] == k).all()
        assert (np.diff(seg) > 0).all()


# ---------------------------------------------------------------------------
# the tiled sweep, emulated in plain PyTorch
# ---------------------------------------------------------------------------
def _tiled_sweep(X, vals, slot, K, B, plan):
    """csrc/hist_slots.cu's decomposition in plain PyTorch: each tile of
    `plan` adds the rows of its slots (grouped by slot when the plan
    groups) into accumulators laid out as the kernel's shared memory,
    [nk][C][nf][B], or [nk][nf][B][2] when paired (f32 values, C = 2), at
    the kernel's cell index (sweep_tile), and each accumulator goes to the
    output cell that the kernel's tile_global names; every index is
    checked to stay inside its tile and every output cell to be written
    once."""
    F, N = X.shape
    C = vals.shape[0]
    quant = vals.dtype == torch.int8
    paired = plan.paired and C == 2 and not quant
    acc_dtype = torch.int32 if quant else torch.float64
    out = torch.zeros(K * C * F * B, dtype=acc_dtype)
    written = torch.zeros(K * C * F * B, dtype=torch.int64)
    s = (torch.zeros(N, dtype=torch.int64) if slot is None
         else slot.to(torch.int64))
    if plan.grouped and slot is not None:
        _, offsets, rows = hc.group_rows_by_slot_plain(slot, K)
        rows = rows.to(torch.int64)
    v = vals.to(acc_dtype)
    for k0, nk, f0, nf in _tiles(plan, K, F):
        if plan.grouped and slot is not None:
            r = rows[int(offsets[k0]):int(offsets[k0 + nk])]
        else:
            r = torch.nonzero((s >= k0) & (s < k0 + nk)).flatten()
        kl = s[r] - k0
        fb = nf * B
        cells = nk * C * fb
        acc = torch.zeros(cells + 1, dtype=acc_dtype)
        base = kl * fb if paired else kl * C * fb
        for fl in range(nf):
            b = X[f0 + fl, r].to(torch.int64)
            ok = b < B
            for c in range(C):
                idx = ((base + fl * B + b) * 2 + c if paired
                       else base + fl * B + b + c * fb)
                assert bool(((idx[ok] >= 0) & (idx[ok] < cells)).all())
                acc.index_add_(0, torch.where(ok, idx, cells), v[c, r])
        i = torch.arange(cells)
        if paired:
            c, q = i & 1, i >> 1
            b, fl, kl_ = q % B, (q // B) % nf, q // B // nf
            g = (((k0 + kl_) * C + c) * F + f0 + fl) * B + b
        else:
            b, q = i % B, i // B
            g = ((k0 * C + q // nf) * F + f0 + q % nf) * B + b
        out[g] = acc[:cells]
        written.index_add_(0, g, torch.ones_like(g))
    assert bool((written == 1).all())
    out = out.view(K, C, F, B)
    return out if quant else out.to(torch.float32)


def _hand_plan(K, C, F, B, spt, fpt, grouped):
    """A plan with small tiles, so a few rows cross many tile edges; paired
    wherever the kernel can pair (C = 2, B <= 64), several slots per tile
    included."""
    return hc.HistTilePlan(spt, fpt, -(-K // spt), -(-F // fpt),
                           spt * fpt * C * B * 8, 4, B > 64, grouped,
                           C == 2 and B <= 64, False)


_CASES = [
    # (F, N, C, B, K, slotted, hand plan (spt, fpt) or None)
    (28, 3001, 2, 64, 1, False, None),      # bench root, ragged N
    (39, 2500, 2, 256, 1, False, None),     # Criteo root: 4 feature tiles
    (39, 2500, 2, 256, 16, True, None),     # Criteo wave
    (28, 4000, 2, 64, 128, True, None),     # bench wave at the K cap
    (7, 2000, 3, 32, 9, True, (2, 3)),      # ragged slot and feature tiles
    (5, 1800, 1, 16, 6, True, (4, 5)),      # several slots per tile
    (6, 900, 2, 64, 1, True, (1, 4)),       # K = 1 with a slot array
    (9, 2000, 2, 64, 16, True, (5, 9)),     # paired, several slots a tile
    (9, 2000, 2, 64, 16, True, None),       # the planner's narrow wave
]


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("case", _CASES)
def test_tiled_sweep_equals_plain_and_jax(case, grouped):
    F, N, C, B, K, slotted, hand = case
    rng = np.random.RandomState(F + N + K)
    X = rng.randint(0, B, size=(F, N)).astype(np.uint8)
    slot = (rng.randint(-2, K + 2, size=N).astype(np.int32) if slotted
            else None)
    plan = (_hand_plan(K, C, F, B, *hand, grouped and K > 1) if hand
            else hc.plan_hist_tiles(K, C, F, B)._replace(
                grouped=grouped and K > 1))
    ts = None if slot is None else _t(slot)
    jslot = jnp.asarray(np.zeros(N, np.int32) if slot is None else slot)

    # 0.25-grid values: bitwise against both references
    grid = (rng.randint(-32, 32, size=(C, N)) * 0.25).astype(np.float32)
    got = _tiled_sweep(_t(X), _t(grid), ts, K, B, plan)
    ref = hc.build_histogram_slots_plain(_t(X), _t(grid), ts, K, B)
    assert got.shape == (K, C, F, B) and got.dtype == torch.float32
    assert torch.equal(got, ref)
    jref = np.asarray(_build_histogram_slots_xla(
        jnp.asarray(X), jnp.asarray(grid), jslot, K, B))
    np.testing.assert_array_equal(got.numpy(), jref)

    # random f32 values: rtol 1e-5 of the largest bin against the XLA
    # lowering, which sums in f32 in another order
    vals = rng.normal(size=(C, N)).astype(np.float32)
    got = _tiled_sweep(_t(X), _t(vals), ts, K, B, plan)
    ref = hc.build_histogram_slots_plain(_t(X), _t(vals), ts, K, B)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    jref = np.asarray(_build_histogram_slots_xla(
        jnp.asarray(X), jnp.asarray(vals), jslot, K, B))
    np.testing.assert_allclose(got.numpy(), jref, rtol=0,
                               atol=1e-5 * float(np.abs(jref).max()))

    # bins at or past B (the kernel's contract) add nothing
    Xw = np.where(rng.rand(F, N) < 0.1, min(B + 1, 255), X).astype(np.uint8)
    got = _tiled_sweep(_t(Xw), _t(grid), ts, K, B, plan)
    assert torch.equal(got, hc.build_histogram_slots_plain(
        _t(Xw), _t(grid), ts, K, B))

    # int8 values: exact int32 sums
    v8 = rng.randint(-127, 128, size=(C, N)).astype(np.int8)
    got = _tiled_sweep(_t(X), _t(v8), ts, K, B, plan)
    assert got.dtype == torch.int32
    assert torch.equal(got, hc.build_histogram_slots_plain(
        _t(X), _t(v8), ts, K, B))
    jref = np.asarray(_build_histogram_slots_xla(
        jnp.asarray(X), jnp.asarray(v8), jslot, K, B))
    np.testing.assert_array_equal(got.numpy(), jref)


# ---------------------------------------------------------------------------
# the in-place score update
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L,N", [(255, 5003), (31, 301), (2048, 1002),
                                 (7, 4)])
def test_add_leaf_values_matches_jax(L, N):
    rng = np.random.RandomState(L * 3 + N)
    values = rng.normal(size=L).astype(np.float32)
    scores = rng.normal(size=N).astype(np.float32)
    scores[:2] = -0.0                      # -0.0 + 0.0 is +0.0 in both
    # in-range leaf ids: the JAX package's score update on the CPU
    lor = rng.randint(0, L, size=N).astype(np.int32)
    s = _t(scores.copy())
    out = th.add_leaf_values_(s, _t(values), _t(lor))
    assert out is s and s.dtype == torch.float32
    ref = np.asarray(jnp.asarray(scores)
                     + take_leaf_values(jnp.asarray(values),
                                        jnp.asarray(lor)))
    np.testing.assert_array_equal(s.numpy(), ref)
    # out-of-range leaf ids (negative and >= L) add 0, as in the TPU kernel
    # that the JAX package's take_leaf_values runs on a TPU
    lor = rng.randint(-3, L + 3, size=N).astype(np.int32)
    s = _t(scores.copy())
    th.add_leaf_values_(s, _t(values), _t(lor))
    ref = np.asarray(jnp.asarray(scores)
                     + take_leaf_values_pallas(jnp.asarray(values),
                                               jnp.asarray(lor),
                                               interpret=True))
    np.testing.assert_array_equal(s.numpy(), ref)
    # and it is bitwise the gather-then-add it replaces on the main path
    s2 = _t(scores.copy())
    s2 += th.take_leaf_values(_t(values), _t(lor))
    assert torch.equal(s, s2)


def test_add_leaf_values_updates_a_row_of_the_score_matrix():
    values = torch.tensor([0.5, -1.25, 2.0])
    scores = torch.zeros((2, 6))
    lor = torch.tensor([0, 1, 2, 3, -1, 1], dtype=torch.int32)
    th.add_leaf_values_(scores[0], values, lor)
    assert scores[0].tolist() == [0.5, -1.25, 2.0, 0.0, 0.0, -1.25]
    assert scores[1].abs().sum() == 0


def test_new_kernel_wrappers_refuse_cpu_tensors_and_bad_shapes():
    lor = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        hc.add_leaf_values_cuda(torch.zeros(10), torch.zeros(4), lor)
    X = torch.zeros((3, 10), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        hc.build_histogram_slots_cuda(X, torch.zeros((2, 10)),
                                      lor, 16, 64)
    # past the leaf cap the kernel reads its values from global memory:
    # any L >= 1 is taken, an empty table refused
    assert hc._check_leaf_args(torch.zeros(hc.LEAF_CAP + 1), lor,
                               torch.device("cpu")) == (hc.LEAF_CAP + 1, 10)
    with pytest.raises(ValueError, match="1 <= L"):
        hc._check_leaf_args(torch.zeros(0), lor, torch.device("cpu"))


def test_direct_sweep_at_the_root_needs_one_tile():
    # the direct sweep keeps the whole K = 1 histogram in shared memory:
    # a plan of several feature tiles is refused before any launch
    plan = hc.plan_hist_tiles(1, 2, 39, 256, rows=1 << 10)
    assert plan.feat_tiles > 1 and not plan.direct
    X = torch.zeros((39, 1 << 10), dtype=torch.uint8)
    with pytest.raises(ValueError, match="one tile"):
        hc._hist_slots_launch(X, torch.zeros((2, 1 << 10)), None, 1, 256,
                              plan._replace(direct=True))
