"""The port's tiled accumulation engine on the row-wise flat layout
(kernels #7 and #8), kernel #10's membership pass, and the fused kernels'
warp-per-feature split scan, on the CPU: the unequal-width tile planner,
plain emulations of what the kernels do (their tiles, layouts, cell
indices, maps and reduction order), against the port's plain versions and
the JAX package.

Tolerances:
  * f32 histograms of values on a 0.25 grid (sums exact in f32 and f64 in
    any order) and int8 -> int32 histograms are compared bitwise;
  * f32 histograms of random values against the JAX package's XLA
    lowering (f32 sums in another order) within rtol 1e-5 of the largest
    bin;
  * leaf ids and slots bitwise;
  * the scan's records bitwise against the port's plain scan on random
    (continuous) values: the emulation forms the prefixes in its order;
    against the JAX two-pass search on grid values the chosen splits and
    the child sums exactly, gains and outputs within rtol 1e-6 (the same
    f32 formulas in XLA's operation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import histogram_rowwise as jr
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.ops import grow_fused as gf
from lightgbm_tpu_torch.ops import histogram_cuda as hc
from lightgbm_tpu_torch.ops import histogram_rowwise as tr
from lightgbm_tpu_torch.ops import split as ts

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

MIXED = (33, 256, 12, 100, 256, 8, 64, 7, 3, 16, 2)
# the Criteo storage's shape: 13 count columns, 26 categorical of 3-250
CRITEO = (256, 193, 256, 71, 256, 256, 218, 101, 256, 9, 48, 40, 256,
          250, 180, 3, 12, 66, 5, 127, 220, 31, 4, 140, 249, 9, 96, 250,
          15, 7, 200, 64, 22, 3, 247, 110, 18, 243, 55)
NARROW = tuple([4, 16, 9, 2, 16, 13] * 60)          # > MAX_TILE_COLS columns
WIDE = tuple([256] * 9 + [5, 17, 4] + [64] * 30)    # > one column chunk


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _X(nbins, N, rng):
    return np.stack([rng.randint(0, nb, N) for nb in nbins]).astype(np.uint8)


# ---------------------------------------------------------------------------
# the unequal-width planner
# ---------------------------------------------------------------------------
def _flat_tiles(tp, plan, K):
    """(k0, nk, f0, nf, lo, span) of every tile, the kernel's FlatBins.cols
    and its slot tiles."""
    F = len(plan.widths)
    cuts = tp.col_cuts
    for st in range(tp.slot_tiles):
        k0 = st * tp.slots_per_tile
        for ft in range(tp.feat_tiles):
            f0, f1 = cuts[ft], cuts[ft + 1]
            lo = plan.offsets[f0]
            end = plan.offsets[f1] if f1 < F else plan.total
            yield (k0, min(K - k0, tp.slots_per_tile), f0, f1 - f0, lo,
                   end - lo)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("K", [1, 16, 128])
@pytest.mark.parametrize("nbins", [MIXED, CRITEO, NARROW, WIDE, (8,),
                                   (256, 256)])
def test_flat_plan_every_cell_once_within_budget(nbins, K, quantized):
    plan = tr.build_rowwise_plan(nbins)
    F = len(nbins)
    acc = 4 if quantized else 8
    for C in (1, 2, 4):
        tp = hc.plan_flat_tiles(K, C, plan.offsets, plan.widths, plan.total,
                                quantized=quantized)
        assert tr.flat_plan(plan, K, C, quantized) == tp
        cells = np.zeros((K, F), np.int64)
        cols = np.zeros((K, plan.total), np.int64)
        for k0, nk, f0, nf, lo, span in _flat_tiles(tp, plan, K):
            assert nk >= 1 and 1 <= nf <= hc.MAX_TILE_COLS
            assert nf <= tp.max_cols and span <= tp.max_span
            cells[k0:k0 + nk, f0:f0 + nf] += 1
            cols[k0:k0 + nk, lo:lo + span] += 1
            # every column's cells lie inside its tile's span
            for f in range(f0, f0 + nf):
                assert lo <= plan.offsets[f]
                assert plan.offsets[f] + plan.widths[f] <= lo + span
            assert nk * C * span * acc <= hc.HIST_SMEM_BUDGET
            assert span < 1 << 15 and max(plan.widths) < 1 << 16
        what = (nbins, K, C, quantized, tp)
        assert (cells == 1).all(), what      # every (slot, column) cell
        assert (cols == 1).all(), what       # the spans cover the buffer
        assert tp.smem_bytes == tp.max_cols * hc.COL_RECORD \
            + tp.slots_per_tile * C * tp.max_span * acc
        assert tp.blocks_per_sm >= 4, what
        assert tp.blocks_per_sm * (tp.smem_bytes + hc.BLOCK_SMEM_RESERVED) \
            <= hc.SM_SMEM_BYTES
        assert tp.grouped == (K > 1)
        assert tp.merge == (max(plan.widths) >= hc.MERGE_MIN_BINS)
        assert tp.paired == (K == 1 and C == 2 and not quantized
                             and not tp.merge)
        # the fewest tiles the budget allows, their spans balanced: no
        # tile could take its neighbour's first column under the cap the
        # fewest tiles need
        if tp.feat_tiles > 1:
            assert tp.feat_tiles == len(hc._flat_cuts(
                plan.offsets, plan.total,
                hc.HIST_SMEM_BUDGET // (C * acc))) - 1


def test_flat_plan_shapes_of_the_main_path():
    plan = tr.build_rowwise_plan(CRITEO)
    # the Criteo root: about 2 / 3 of the uniform grid's 4 tiles
    tp = tr.flat_plan(plan, 1, 2, False)
    assert tp.feat_tiles < hc.plan_hist_tiles(1, 2, 39, 256).feat_tiles
    assert tp.merge and not tp.paired and not tp.grouped
    # a wave: one slot a tile, rows grouped
    tp = tr.flat_plan(plan, 16, 2, False)
    assert tp.slots_per_tile == 1 and tp.grouped
    # narrow columns: several slots share a tile, the pairing at the root
    plan = tr.build_rowwise_plan((4, 16, 9, 2))
    assert tr.flat_plan(plan, 16, 2, False).slots_per_tile > 1
    assert tr.flat_plan(plan, 1, 2, False).paired


@pytest.mark.parametrize("args", [
    (hc.MAX_GROUP_SLOTS + 1, 2, (0,), (8,), 128),
    (1, 5, (0,), (8,), 128),
    (1, 2, (0, 8), (16, 8), 128),        # overlapping columns
    (1, 2, (0,), (8,), 4)])              # past the buffer
def test_flat_plan_raises_on_a_layout_it_cannot_tile(args):
    K, C, offs, wid, total = args
    with pytest.raises(ValueError):
        hc.plan_flat_tiles(K, C, offs, wid, total)


# ---------------------------------------------------------------------------
# the tiled sweep over the flat layout, emulated in plain PyTorch
# ---------------------------------------------------------------------------
def _flat_sweep(X, Xu, vals, slot, K, plan, pplan, tp):
    """csrc/hist_tiles.cuh's sweep with the FlatBins reader in plain
    PyTorch: each tile of `tp` stages its columns from the descriptors the
    wrapper builds (byte row, shift, mask, width, first cell), adds the
    rows of its slots (grouped by slot when the plan groups) into
    accumulators laid out as the kernel's shared memory, [nk][C][span],
    or [nk][span][2] when paired, at the kernel's cell index, and each
    accumulator goes to the output cell tile_global names; every index is
    checked to stay in its tile and every output cell to be written
    once."""
    F = len(plan.widths)
    N = X.shape[1]
    C = vals.shape[0]
    quant = vals.dtype == torch.int8
    paired = tp.paired and C == 2 and not quant
    acc_dtype = torch.int32 if quant else torch.float64
    total = plan.total
    out = torch.zeros(K * C * total, dtype=acc_dtype)
    written = torch.zeros(K * C * total, dtype=torch.int64)
    desc = tr._desc(plan, pplan, tp.col_cuts, torch.device("cpu")).numpy()
    off, wid, nib, brow = desc[:4 * F].reshape(4, F)
    assert tuple(desc[4 * F:]) == tp.col_cuts
    s = (torch.zeros(N, dtype=torch.int64) if slot is None
         else slot.to(torch.int64))
    grouped = tp.grouped and slot is not None
    if grouped:
        _, offsets, rows = hc.group_rows_by_slot_plain(slot, K)
        rows = rows.to(torch.int64)
    v = vals.to(acc_dtype)
    for k0, nk, f0, nf, lo, span in _flat_tiles(tp, plan, K):
        if grouped:
            r = rows[int(offsets[k0]):int(offsets[k0 + nk])]
        else:
            r = torch.nonzero((s >= k0) & (s < k0 + nk)).flatten()
        kl = s[r] - k0
        cells = nk * C * span
        acc = torch.zeros(cells + 1, dtype=acc_dtype)
        base = kl * span if paired else kl * C * span
        for fl in range(nf):
            f = f0 + fl
            p = int(nib[f])
            src = X if p >= 0 or Xu is None else Xu
            row = p >> 1 if p >= 0 else int(brow[f])
            shift, mask = (4 * (p & 1), 15) if p >= 0 else (0, 255)
            b = (src[row, r].to(torch.int64) >> shift) & mask
            ok = b < int(wid[f])
            loc = int(off[f]) - lo
            for c in range(C):
                idx = ((base + loc + b) * 2 + c if paired
                       else base + loc + b + c * span)
                assert bool(((idx[ok] >= 0) & (idx[ok] < cells)).all())
                acc.index_add_(0, torch.where(ok, idx, cells), v[c, r])
        i = torch.arange(cells)
        if paired:
            c, q = i & 1, i >> 1
            g = ((k0 + q // span) * C + c) * total + lo + q % span
        else:
            g = (k0 * C + i // span) * total + lo + i % span
        out[g] = acc[:cells]
        written.index_add_(0, g, torch.ones_like(g))
    assert bool((written == 1).all())
    out = out.view(K, C, total)
    return out if quant else out.to(torch.float32)


_SWEEP_CASES = [
    # (column bins, N, C, K)
    (MIXED, 2500, 2, 1),
    (CRITEO, 1800, 2, 16),
    (CRITEO, 1500, 2, 1),
    (WIDE, 1200, 2, 5),
    (NARROW, 900, 2, 1),        # paired, several tiles of 256 columns
    (NARROW, 900, 1, 9),        # several slots a tile
    ((4, 16, 9, 2, 3), 1600, 3, 128),
]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("case", _SWEEP_CASES)
def test_flat_sweep_equals_plain_and_jax(case, packed):
    nbins, N, C, K = case
    rng = np.random.RandomState(N + K + len(nbins))
    X = _X(nbins, N, rng)
    slot = rng.randint(-2, K + 2, size=N).astype(np.int32) if K > 1 \
        else None
    ts_ = None if slot is None else _t(slot)
    plan = tr.build_rowwise_plan(nbins)
    pplan = tr.build_pack4_plan(nbins)
    if packed:
        Xk, Xu = tr.pack4(_t(X), pplan)
    else:
        Xk, Xu = _t(X), None
    jplan = jr.build_rowwise_plan(nbins)
    jslot = jnp.asarray(np.zeros(N, np.int32) if slot is None else slot)

    def sweep(vals):
        tp = tr.flat_plan(plan, K, C, vals.dtype == np.int8)
        return _flat_sweep(Xk, Xu, _t(vals), ts_, K, plan,
                           pplan if packed else None, tp)

    def plain(vals):
        if packed:
            return tr.hist_rowwise_packed_plain(Xk, Xu, _t(vals), ts_, K,
                                                plan, pplan)
        return tr.hist_rowwise_plain(Xk, _t(vals), ts_, K, plan)

    def xla(vals):
        return np.asarray(jr._build_histogram_slots_rowwise_xla(
            jnp.asarray(X), jnp.asarray(vals), jslot, K, jplan))

    # 0.25-grid values: bitwise against both references
    grid = (rng.randint(-32, 32, size=(C, N)) * 0.25).astype(np.float32)
    got = sweep(grid)
    assert got.shape == (K, C, plan.total) and got.dtype == torch.float32
    assert torch.equal(got, plain(grid))
    np.testing.assert_array_equal(got.numpy(), xla(grid))

    # random f32 values: rtol 1e-5 of the largest bin against the XLA
    # lowering, which sums in f32 in another order
    vals = rng.normal(size=(C, N)).astype(np.float32)
    got = sweep(vals)
    ref = plain(vals)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    jref = xla(vals)
    np.testing.assert_allclose(got.numpy(), jref, rtol=0,
                               atol=1e-5 * float(np.abs(jref).max()))

    # int8 values: exact int32 sums
    v8 = rng.randint(-127, 128, size=(C, N)).astype(np.int8)
    got = sweep(v8)
    assert got.dtype == torch.int32 and torch.equal(got, plain(v8))
    np.testing.assert_array_equal(got.numpy(), xla(v8))


def test_flat_sweep_bins_past_width_add_nothing():
    """A bin at or past its column's width (the kernel's contract) adds
    nothing, in both readers."""
    rng = np.random.RandomState(5)
    N, C, K = 1400, 2, 3
    X = _X(MIXED, N, rng)
    plan = tr.build_rowwise_plan(MIXED)
    wid = np.array(plan.widths)[:, None]
    Xw = np.where(rng.rand(*X.shape) < 0.1, np.minimum(wid + 1, 255), X)
    Xw = np.where((np.array(MIXED)[:, None] <= 16) & (Xw > 15), 15,
                  Xw).astype(np.uint8)    # a nibble holds 15 at most
    slot = _t(rng.randint(-1, K, size=N).astype(np.int32))
    grid = _t((rng.randint(-32, 32, size=(C, N)) * 0.25).astype(np.float32))
    tp = tr.flat_plan(plan, K, C, False)
    ref = tr.hist_rowwise_plain(_t(Xw), grid, slot, K, plan)
    assert torch.equal(_flat_sweep(_t(Xw), None, grid, slot, K, plan, None,
                                   tp), ref)
    pplan = tr.build_pack4_plan(MIXED)
    Xp, Xu = tr.pack4(_t(Xw), pplan)
    assert torch.equal(_flat_sweep(Xp, Xu, grid, slot, K, plan, pplan, tp),
                       ref)


def test_flat_sweep_equals_jax_pallas_interpret():
    rng = np.random.RandomState(31)
    N, C, K = 1100, 2, 4
    X = _X(MIXED, N, rng)
    vals = (rng.randint(-32, 32, size=(C, N)) * 0.25).astype(np.float32)
    slot = rng.randint(-1, K, size=N).astype(np.int32)
    plan = tr.build_rowwise_plan(MIXED)
    pplan = tr.build_pack4_plan(MIXED)
    jplan, jpplan = jr.build_rowwise_plan(MIXED), jr.build_pack4_plan(MIXED)
    Xp, Xu = tr.pack4(_t(X), pplan)
    tp = tr.flat_plan(plan, K, C, False)
    got = _flat_sweep(_t(X), None, _t(vals), _t(slot), K, plan, None, tp)
    ref = jr.build_histogram_slots_rowwise_flat(
        jnp.asarray(X), jnp.asarray(vals), jnp.asarray(slot), K, jplan,
        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    gotp = _flat_sweep(Xp, Xu, _t(vals), _t(slot), K, plan, pplan, tp)
    jp, ju = jr.pack4(jnp.asarray(X), jpplan)
    refp = jr.build_histogram_slots_rowwise_packed_flat(
        jp, ju, jnp.asarray(vals), jnp.asarray(slot), K, jplan, jpplan,
        interpret=True)
    np.testing.assert_array_equal(gotp.numpy(), np.asarray(refp))


# ---------------------------------------------------------------------------
# kernel #10's membership pass, emulated
# ---------------------------------------------------------------------------
NONE, DUP = 0xFFFF, 0xFFFE


def _map16(leaves, n, cap):
    """lgbt_map_entries16: map[leaf] = k for the active entries k < n; a
    leaf named by two entries becomes DUP, whatever order the entries'
    compare-and-swaps land in."""
    m = np.full(cap, NONE, np.int64)
    for k in np.random.RandomState(n).permutation(min(n, 128)):
        leaf = int(leaves[k])
        if 0 <= leaf < cap:
            m[leaf] = k if m[leaf] == NONE else DUP
    return m


def _member_emulated(dec, lor, table, pend, pend_nl0, K, Kd, cap):
    """fused_member_kernel, row by row in numpy."""
    maps = (_map16(pend, Kd, cap), _map16(table[0], Kd, cap),
            _map16(table[7], K, cap))

    def entry(m, leaf):
        e = np.where((leaf >= 0) & (leaf < cap), m[np.clip(leaf, 0, cap - 1)],
                     NONE)
        return np.where(e < 128, e, -1)

    rows = np.arange(lor.shape[0])

    def bit(k, sh):
        return (dec[np.maximum(k, 0), rows] >> sh) & 1

    leaf = lor.astype(np.int64)
    kp = entry(maps[0], leaf)
    leaf = np.where((kp >= 0) & (bit(kp, 2) == 0), pend_nl0 + kp, leaf)
    ka = entry(maps[1], leaf)
    leaf = np.where((ka >= 0) & (bit(ka, 0) == 0), table[15, 0] + ka, leaf)
    kc = entry(maps[2], leaf)
    slot = np.where((kc >= 0) & (bit(kc, 1) == 1), kc, -1)
    return leaf.astype(np.int32), slot.astype(np.int32)


@pytest.mark.parametrize("K,Kd", [(1, 4), (16, 16), (5, 40)])
def test_membership_pass_equals_two_applies(K, Kd):
    rng = np.random.RandomState(K * 7 + Kd)
    N, L, nl0 = 3000, 255, 100
    lor = rng.randint(0, nl0, size=N).astype(np.int32)
    pend = np.full(128, -1, np.int32)
    pend[:6] = rng.choice(nl0, 6, replace=False)
    pend[1] = pend[0]                  # a pending leaf named twice
    pnl0, nl1 = nl0, nl0 + 8
    napp = min(Kd, 12)
    t = np.full((16, 128), -1, np.int32)
    t[0, :napp] = rng.choice(nl1, napp, replace=False)
    if napp > 2:
        t[0, napp - 1] = t[0, 0]       # an applied leaf named twice
    t[7, :Kd] = rng.choice(nl1 + napp, Kd, replace=False)
    t[15] = nl1
    dec = rng.randint(0, 8, size=(Kd, N)).astype(np.uint8)
    got_lor, got_slot = _member_emulated(dec, lor, t, pend, pnl0, K, Kd, L)
    # the plain version's two applies (wave_pass_fused_tiled_plain)
    tp = torch.full((16, 128), -1, dtype=torch.int32)
    tp[0] = _t(pend)
    tp[15] = pnl0
    lor1, _ = hc.wave_apply_plain((_t(dec) >> 2) & 1, _t(lor), tp, L)
    tt = _t(t).clone()
    tt[7, K:] = -1
    ref_lor, ref_slot = hc.wave_apply_plain(_t(dec), lor1, tt, L)
    np.testing.assert_array_equal(got_lor, ref_lor.numpy())
    np.testing.assert_array_equal(got_slot, ref_slot.numpy())
    assert (got_slot >= 0).any() and (got_lor != lor).any()
    # a leaf named by two pending entries matches neither
    moved = got_lor != lor
    assert not moved[(lor == pend[0]) & ~np.isin(lor, t[0, :napp])].any()


# ---------------------------------------------------------------------------
# the warp-per-feature split scan, emulated
# ---------------------------------------------------------------------------
WARPS = 8     # LGBT_SCAN_WARPS


def _keys(gain, idx):
    """lgbt_key: (gain, flat index) -> uint64, larger gain then smaller
    index first."""
    g = np.where(gain == 0, np.float32(0), gain).astype(np.float32)
    u = g.view(np.uint32).astype(np.uint64)
    u = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return (u << np.uint64(32)) | (np.uint64(0xFFFFFFFF)
                                   - idx.astype(np.uint64))


def _key_gain(key):
    u = (key >> np.uint64(32)).astype(np.uint32)
    u = np.where(u & 0x80000000, u & 0x7FFFFFFF, ~u)
    return u.astype(np.uint32).view(np.float32)


def _cell(pg, ph, pc, tot, d, sg, sh, cnt, pout, hp, bmin, bmax, mono):
    """lgbt_cell with split.py's formulas, all f32 tensors: the outputs
    clipped into [bmin, bmax], the direction `mono` enforced on them."""
    mg, mh, mc = sg - tot[0], sh - tot[1], cnt - tot[2]
    lcu = pc + mc if d else pc
    lg = pg + mg if d else pg
    lh = ph + mh if d else ph
    rg, rh, rcu = sg - lg, sh - lh, cnt - lcu
    lc, rc = torch.round(lcu), torch.round(rcu)
    slack = hp.min_data_in_leaf - ts.SYNTH_COUNT_SLACK
    ok = (lcu >= slack) & (rcu >= slack) & (lh >= hp.min_sum_hessian_in_leaf) \
        & (rh >= hp.min_sum_hessian_in_leaf)
    lout = torch.clamp(ts.leaf_output(lg, lh, hp, lc, pout), bmin, bmax)
    rout = torch.clamp(ts.leaf_output(rg, rh, hp, rc, pout), bmin, bmax)
    ok = ok & ~(((mono > 0) & (lout > rout)) | ((mono < 0) & (lout < rout)))
    gain = ts.leaf_gain_given_output(lg, lh, hp, lout) \
        + ts.leaf_gain_given_output(rg, rh, hp, rout)
    return ok, gain, (lg, lh, lc, rg, rh, rc, lout, rout)


def _scan_emulated(hist, parent, scal, fmeta, fmask, hp):
    """lgbt_split_scan_kernel's order in plain PyTorch: per (child,
    feature) the staged child values, one lane a channel forming the f64
    prefix over bins [0, min(nb, B)) in order, rounded once; the cells of
    both directions by the lanes at bins lane, lane + 32, ..., each lane
    keeping its best key and that cell's statistics; the warp's best (its
    statistics kept for the feature), then the block's (8 features) and
    the child's; the winner's kept statistics, or the index-0 cell
    recomputed where no cell is valid; with the monotone operand (scalar
    rows 5 / 6, meta row 4). Returns the [12, 2K] records."""
    K, _, F, B = hist.shape
    n2 = 2 * K
    rec = torch.zeros((12, n2), dtype=torch.float32)
    nb_, mt_, db_, cat_, mono_ = (fmeta[i].tolist() for i in range(5))
    floor = _keys(np.float32([-np.inf]), np.array([0]))[0]
    for j in range(n2):
        k = j if j < K else j - K
        sg, sh, cnt, pout = (scal[i, j:j + 1] for i in range(4))
        bmin, bmax = scal[5, j:j + 1], scal[6, j:j + 1]
        use_small = (j < K) == bool(scal[4, j] != 0)
        cntf = cnt / torch.clamp(sh, min=1e-12)
        mgs = ts.leaf_gain(sg, sh, hp, cnt, pout) + hp.min_gain_to_split
        small = hist[k]
        child = small if use_small else parent[k].view(2, F, B) - small

        def prefix(f):
            nb, mt, db = nb_[f], mt_[f], db_[f]
            top = min(nb, B)
            mbin = nb - 1 if mt == 2 else (db if mt == 1 else -1)
            v = child[:, f, :top].clone()
            if 0 <= mbin < top:
                v[:, mbin] = 0
            v = torch.cat([v, v[1:2] * cntf])          # [3, top] f32
            pre = torch.zeros((3, top), dtype=torch.float32)
            s = torch.zeros(3, dtype=torch.float64)
            for b in range(top):                       # lane c, in order
                s = s + v[:, b].double()
                pre[:, b] = s.float()
            return pre, s.float(), top

        kept = {}                                      # the cells scratch
        block_best = []
        for f0 in range(0, F, WARPS):
            warp_best = []
            for f in range(f0, min(f0 + WARPS, F)):
                if not (fmask[j, f] and not cat_[f]):
                    continue
                pre, tot, top = prefix(f)
                nb, mt, db = nb_[f], mt_[f], db_[f]
                max_t = nb - 2
                max_t_r = nb - 3 if mt == 2 else max_t
                lanes = []
                for lane in range(32):
                    best = (floor, None)
                    for b in range(lane, min(max_t + 1, B), 32):
                        if mt == 1 and b == db:
                            continue
                        for d in (0, 1):
                            if b > (max_t_r if d else max_t):
                                continue
                            ok, gain, st = _cell(
                                pre[0, b:b + 1], pre[1, b:b + 1],
                                pre[2, b:b + 1], tot, d, sg, sh, cnt, pout,
                                hp, bmin, bmax, mono_[f])
                            if not bool(ok & (gain > mgs)):
                                continue
                            key = _keys(gain.numpy(),
                                        np.array([(d * F + f) * B + b]))[0]
                            if key > best[0]:
                                best = (key, st)
                    lanes.append(best)
                wkey, wst = max(lanes, key=lambda kv: kv[0])
                if wkey > floor:
                    kept[f] = wst
                warp_best.append(wkey)                # the warp's shuffles
            block_best.append(max(warp_best, default=np.uint64(0)))
        key = max(max(block_best), floor)
        bi = int(np.uint64(0xFFFFFFFF) - (key & np.uint64(0xFFFFFFFF)))
        bg = torch.tensor(_key_gain(np.array([key])))
        d, f, b = bi // (F * B), (bi // B) % F, bi % B
        if key > floor:
            stats = kept[f]
        else:
            pre, tot, top = prefix(0)
            at = pre[:, :1] if top > 0 else tot[:, None]
            _, _, stats = _cell(at[0], at[1], at[2], tot, 0, sg, sh, cnt,
                                pout, hp, bmin, bmax, mono_[0])
        fields = [torch.where(torch.isfinite(bg), bg - mgs,
                              torch.tensor([-np.inf])),
                  torch.tensor([float(f)]), torch.tensor([float(b)]),
                  torch.tensor([float(d)])]
        fields += [torch.where(torch.isfinite(x), x, torch.zeros_like(x))
                   for x in stats]
        rec[:, j] = torch.cat([x.float() for x in fields])
    return rec


def _scan_case(seed, K, F, B, grid, mono=False):
    """A wave's scan operands from real rows: each candidate's parent
    histogram over its leaf's rows, the smaller child's histogram, the
    per-child scalars, random feature metadata and masks. Without `mono`
    the monotone operand is off (bounds +-inf, directions 0); with it
    every other child is bounded around its output and the directions are
    mixed."""
    rng = np.random.RandomState(seed)
    N = 4000
    nb = rng.randint(B // 4, B + 1, size=F)
    X = np.stack([rng.randint(0, n, N) for n in nb]).astype(np.uint8)
    g = rng.normal(size=N) + np.where(X[0] < nb[0] // 2, 1.0, -1.0)
    h = rng.uniform(0.05, 0.25, size=N)
    if grid:
        g, h = np.round(g * 64) / 64, np.round(h * 64) / 64
    vals = _t(np.stack([g, h]).astype(np.float32))
    leaf = rng.randint(-1, K, size=N).astype(np.int32)
    small = np.where(rng.rand(N) < 0.4, leaf, -1).astype(np.int32)
    Xt = _t(X)
    v3 = torch.cat([vals, torch.ones((1, N))])
    par = hc.build_histogram_slots_plain(Xt, v3, _t(leaf), K, B)
    sm = hc.build_histogram_slots_plain(Xt, v3, _t(small), K, B)
    sil = torch.from_numpy(rng.randint(0, 2, K).astype(bool))
    ptot, stot = par[:, :, 0].sum(-1), sm[:, :, 0].sum(-1)
    ltot = torch.where(sil[:, None], stot, ptot - stot)
    lr = torch.cat([ltot, ptot - ltot])
    out = -lr[:, 0] / (lr[:, 1] + 1.0)
    bmin = torch.full((2 * K,), -np.inf)
    bmax = torch.full((2 * K,), np.inf)
    dirs = np.zeros(F, np.int64)
    if mono:
        # the odd children: a window of +-0.05 around the output, which
        # the children's own outputs cross
        bmin[1::2], bmax[1::2] = out[1::2] - 0.05, out[1::2] + 0.05
        dirs = rng.choice([-1, 0, 1], size=F)
    scal = torch.stack([lr[:, 0], lr[:, 1], lr[:, 2], out,
                        torch.cat([sil, sil]).float(), bmin,
                        bmax]).contiguous()
    fmeta = torch.tensor(np.stack([nb, rng.randint(0, 3, F),
                                   rng.randint(0, B // 4, F),
                                   (rng.rand(F) < 0.1), dirs]),
                         dtype=torch.int32)
    fmask = torch.from_numpy((rng.rand(2 * K, F) < 0.85).astype(np.uint8))
    return sm[:, :2].contiguous(), par[:, :2].reshape(K, -1), scal, fmeta, \
        fmask


HP = ts.SplitHyperParams(min_data_in_leaf=20.0, min_sum_hessian_in_leaf=1e-3,
                         lambda_l1=0.0, lambda_l2=0.0, max_delta_step=0.0,
                         min_gain_to_split=0.0, path_smooth=0.0)


@pytest.mark.parametrize("K,F,B,hp", [
    (2, 11, 64, HP), (2, 7, 256, HP), (1, 20, 40, HP),
    (2, 11, 64, HP._replace(lambda_l1=0.5, lambda_l2=2.0,
                            max_delta_step=0.75, min_gain_to_split=0.25,
                            path_smooth=3.0))])
def test_scan_order_equals_plain_on_continuous_values(K, F, B, hp):
    hist, parent, scal, fmeta, fmask = _scan_case(K * F + B, K, F, B, False)
    got = _scan_emulated(hist, parent, scal, fmeta, fmask, hp)
    ref = gf._scan_plain(hist, parent, scal, fmeta, fmask, hp, None)
    assert torch.isfinite(got[0]).any()
    assert torch.equal(got, ref)


def test_scan_with_no_valid_split_takes_index_zero():
    hist, parent, scal, fmeta, fmask = _scan_case(3, 2, 6, 32, False)
    got = _scan_emulated(hist, parent, scal, fmeta, torch.zeros_like(fmask),
                         HP)
    ref = gf._scan_plain(hist, parent, scal, fmeta, torch.zeros_like(fmask),
                         HP, None)
    assert torch.equal(got, ref)
    assert torch.isinf(got[0]).all() and (got[1:4] == 0).all()


@pytest.mark.parametrize("K,F,B,grid", [(2, 11, 64, False),
                                         (2, 9, 40, True)])
def test_scan_with_the_monotone_operand_equals_plain(K, F, B, grid):
    """The warp-per-feature scan with live bounds and directions against
    the plain version (find_best_split with leaf_min / leaf_max /
    monotone), bitwise; the operand changes the records, and off (+-inf,
    zeros) it gives the unconstrained records."""
    hist, parent, scal, fmeta, fmask = _scan_case(K * F + B + 1, K, F, B,
                                                  grid, mono=True)
    got = _scan_emulated(hist, parent, scal, fmeta, fmask, HP)
    ref = gf._scan_plain(hist, parent, scal, fmeta, fmask, HP, None)
    assert torch.isfinite(got[0]).any()
    assert torch.equal(got, ref)
    off_scal, off_meta = scal.clone(), fmeta.clone()
    off_scal[5], off_scal[6], off_meta[4] = -np.inf, np.inf, 0
    off = gf._scan_plain(hist, parent, off_scal, off_meta, fmask, HP, None)
    assert not torch.equal(off, ref)
    assert torch.equal(off, _scan_emulated(hist, parent, off_scal, off_meta,
                                           fmask, HP))


def test_scan_order_equals_jax_two_pass_on_grid_values():
    K, F, B = 2, 8, 64
    hist, parent, scal, fmeta, fmask = _scan_case(17, K, F, B, True)
    got = _scan_emulated(hist, parent, scal, fmeta, fmask, HP)
    sil = (scal[4, :K] != 0)[:, None, None, None]
    large = parent.view(K, 2, F, B) - hist
    ch = torch.cat([torch.where(sil, hist, large),
                    torch.where(sil, large, hist)]).numpy()
    jm = js.FeatureMeta(num_bins=jnp.asarray(fmeta[0].numpy()),
                        missing_type=jnp.asarray(fmeta[1].numpy()),
                        default_bin=jnp.asarray(fmeta[2].numpy()),
                        is_categorical=jnp.asarray(fmeta[3].numpy() != 0))
    jhp = js.SplitHyperParams(**HP._asdict())
    s = scal.numpy()
    found = 0
    for j in range(2 * K):
        h3 = js.synth_count_channel(jnp.asarray(ch[j]), jnp.float32(s[2, j]),
                                    jnp.float32(s[1, j]))
        r = js.find_best_split(h3, *(jnp.float32(s[i, j]) for i in range(4)),
                               jm, jhp, jnp.asarray(fmask[j].numpy() != 0))
        want = [float(x) for x in r]
        col = got[:, j].tolist()
        if not np.isfinite(want[0]):
            assert not np.isfinite(col[0])
            continue
        found += 1
        # feature, threshold, default_left, and the sums and counts exact
        assert col[1:10] == pytest.approx(want[1:10], rel=0, abs=0)
        np.testing.assert_allclose([col[0]] + col[10:],
                                   [want[0]] + want[10:], rtol=1e-6)
    assert found >= K
