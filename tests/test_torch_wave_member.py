"""The megakernel route's waves (kernels #3 and #9) on the CPU: an
emulation of their membership pass (csrc/wave_member.cuh) in the kernel's
own order, against the port's plain version and the JAX package's TPU
kernel in interpret mode; the tile plans of the engine at the waves'
shapes; and the host-side layout of the waves' histogram launch
(histogram_cuda.wave_hist_layout).

Tolerances: leaf ids and slots are compared bitwise; the JAX kernel's
histogram of 1/4-grid values (sums exact in any order) bitwise too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.histogram_pallas import wave_pass_pallas
from lightgbm_tpu_torch.ops import histogram_cuda as hc
from lightgbm_tpu_torch.ops.grow_wave import fused_kcap, mega_kcap

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

T = 128          # LGBT_T_ENTRIES


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the membership pass, emulated
# ---------------------------------------------------------------------------
def _pack(t, row0, k, sil):
    """lgbt_pack_entry: feat&31 | thr<<5 | dl<<13 | miss_bin<<14 | sil<<23,
    as the uint32 the kernel decodes."""
    feat, thr, dl, mt, db, nb = (int(t[row0 + i, k]) for i in range(6))
    mb = db if mt == 1 else (nb - 1 if mt == 2 else 0x1FF)
    return ((feat & 31) | (thr << 5) | (dl << 13) | (mb << 14)
            | (sil << 23)) & 0xFFFFFFFF


def _go_left(p, X, r):
    """lgbt_go_left: features at or past F read bin 0."""
    F = X.shape[0]
    feat, thr = p & 31, (p >> 5) & 0xFF
    dl, mb = (p >> 13) & 1, (p >> 14) & 0x1FF
    col = int(X[feat, r]) if feat < F else 0
    return bool(dl) if col == mb else col <= thr


def _maps(t, K, cap, order):
    """lgbt_load_table's leaf -> entry maps, the entries written in
    `order`, each by lgbt_map_min (a leaf keeps its lowest entry)."""
    app_of, cand_of = [-1] * cap, [-1] * cap

    def map_min(m, leaf, k):
        if not (m[leaf] >= 0 and m[leaf] <= k):
            m[leaf] = k
    for k in order:
        la, lc = int(t[0, k]), int(t[7, k])
        if 0 <= la < cap:
            map_min(app_of, la, k)
        if k < K and 0 <= lc < cap:
            map_min(cand_of, lc, k)
    return app_of, cand_of


def _member_emulated(X, lor, t, K, cap, order):
    """wave_member_kernel, row by row."""
    app_of, cand_of = _maps(t, K, cap, order)
    app_p = [_pack(t, 1, k, 0) for k in range(T)]
    cand_p = [_pack(t, 8, k, int(t[14, k]) & 1) for k in range(T)]
    nl0 = int(t[15, 0])
    N = lor.shape[0]
    out_lor = np.empty(N, np.int32)
    slot = np.empty(N, np.int32)
    for r in range(N):
        leaf = int(lor[r])
        ka = app_of[leaf] if 0 <= leaf < cap else -1
        nl = nl0 + ka if ka >= 0 and not _go_left(app_p[ka], X, r) else leaf
        out_lor[r] = nl
        kc = cand_of[nl] if 0 <= nl < cap else -1
        s = -1
        if kc >= 0:
            p = cand_p[kc]
            if _go_left(p, X, r) == bool((p >> 23) & 1):
                s = kc
        slot[r] = s
    return out_lor, slot


def _table(rng, F, B, nl0, app, cand, feat_hi=None):
    """[16, 128] wave table with every missing type among the entries;
    features drawn below `feat_hi` (default F; up to 32 puts some at or
    past F)."""
    t = np.full((16, T), -1, np.int64)
    hi = F if feat_hi is None else feat_hi
    for r0, leaves in ((0, app), (7, cand)):
        n = len(leaves)
        t[r0, :n] = leaves
        t[r0 + 1, :n] = rng.randint(0, hi, n)             # feature
        t[r0 + 2, :n] = rng.randint(0, B - 1, n)          # threshold bin
        t[r0 + 3, :n] = rng.randint(0, 2, n)              # default_left
        t[r0 + 4, :n] = np.arange(n) % 3                  # None, Zero, NaN
        t[r0 + 5, :n] = rng.randint(0, B - 1, n)          # default bin
        t[r0 + 6, :n] = B - rng.randint(0, 2, n)          # num_bins
    t[14, :len(cand)] = rng.randint(0, 2, len(cand))
    t[15] = nl0
    return t.astype(np.int32)


# F, N, B, K, nl0, napp, ncand, feat_hi, dup
MEMBER_CASES = {
    "missing_types": (9, 1500, 16, 16, 12, 6, 16, None, False),
    "feature_past_F": (5, 1200, 32, 8, 10, 5, 8, 32, False),
    "more_candidates_than_K": (12, 1000, 64, 4, 8, 4, 10, None, False),
    "duplicated_leaf": (9, 1500, 16, 16, 12, 6, 16, None, True),
}


def _member_case(name):
    F, N, B, K, nl0, napp, ncand, feat_hi, dup = MEMBER_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    X = rng.randint(0, B, size=(F, N)).astype(np.uint8)
    lor = rng.randint(0, nl0, size=N).astype(np.int32)
    app = rng.choice(nl0, napp, replace=False)
    cand = rng.choice(nl0 + napp, ncand, replace=False)
    if dup:
        # entry 1 names entry 0's leaf with a split of its own
        app[1], cand[1] = app[0], cand[0]
    t = _table(rng, F, B, nl0, app, cand, feat_hi)
    if dup:
        t[1, 1] = (t[1, 0] + 1) % F
        t[8, 1] = (t[8, 0] + 1) % F
        t[14, 1] = 1 - t[14, 0]
    return X, lor, t, K, B


@pytest.mark.parametrize("name", sorted(MEMBER_CASES))
def test_membership_emulated_equals_plain(name):
    X, lor, t, K, _ = _member_case(name)
    cap = 256
    ref_lor, ref_slot = hc.wave_member_plain(_t(X), _t(lor), _t(t), K)
    rng = np.random.RandomState(3)
    # the maps do not depend on the order the entries are written in
    for order in (range(T), range(T - 1, -1, -1), rng.permutation(T)):
        got_lor, got_slot = _member_emulated(X, lor, t, K, cap, order)
        np.testing.assert_array_equal(got_lor, ref_lor.numpy())
        np.testing.assert_array_equal(got_slot, ref_slot.numpy())
    # the case exercises what it is named for
    assert (ref_slot.numpy() >= 0).any() and (ref_slot.numpy() < 0).any()
    if name == "feature_past_F":
        assert (t[8, :K] >= X.shape[0]).any() and (t[1] >= X.shape[0]).any()
    if name == "duplicated_leaf":
        # rows of the duplicated candidate leaf take entry 0, never 1
        assert not (ref_slot.numpy() == 1).any()
    # the plain wave pass is the membership pass, then the slot histogram
    vals = _t(np.random.RandomState(4).randint(-64, 64, (2, X.shape[1]))
              .astype(np.float32) / 4)
    new_lor, hist = hc.wave_pass_plain(_t(X), vals, _t(lor), _t(t), K, 64,
                                       cap)
    assert torch.equal(new_lor, ref_lor)
    assert torch.equal(hist, hc.build_histogram_slots_plain(
        _t(X), vals, ref_slot, K, 64))


@pytest.mark.parametrize("name", ["missing_types", "feature_past_F"])
def test_membership_emulated_equals_jax_pallas(name):
    """The TPU kernel's masked sums assume a leaf is named once, so the
    duplicated-leaf case is held against the plain version only."""
    X, lor, t, K, B = _member_case(name)
    vals = np.random.RandomState(5).randint(-64, 64, (2, X.shape[1])) \
        .astype(np.float32) / 4
    ref_lor, ref_hist = wave_pass_pallas(
        jnp.asarray(X), jnp.asarray(vals), jnp.asarray(lor), jnp.asarray(t),
        K, B, interpret=True)
    got_lor, slot = _member_emulated(X, lor, t, K, 256, range(T))
    np.testing.assert_array_equal(got_lor, np.asarray(ref_lor))
    hist = hc.build_histogram_slots_plain(_t(X), _t(vals), _t(slot), K, B)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(ref_hist))


# ---------------------------------------------------------------------------
# the engine's plans at the waves' shapes, and the wrapper's layout
# ---------------------------------------------------------------------------
def _tiles(plan, K, F):
    for st in range(plan.slot_tiles):
        k0 = st * plan.slots_per_tile
        for ft in range(plan.feat_tiles):
            f0 = ft * plan.feats_per_tile
            yield (k0, min(K - k0, plan.slots_per_tile), f0,
                   min(F - f0, plan.feats_per_tile))


ROWS = (1 << 14, 1 << 16, 1 << 20)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("route", ["mega", "fused"])
@pytest.mark.parametrize("B", [16, 64, 256])
def test_wave_plans_every_cell_once_within_budget(B, route, quantized):
    cap = mega_kcap(B) if route == "mega" else fused_kcap(B)
    # the routes' caps: mega 128 / 128 / 32; the narrow fused route halves
    # the budget (the lane width of 16 bins is 32)
    assert cap == {"mega": {16: 128, 64: 128, 256: 32},
                   "fused": {16: 128, 64: 64, 256: 16}}[route][B]
    acc = 4 if quantized else 8
    for K in (1, cap):
        for F in (1, 9, 28, 32):
            for N in ROWS:
                lay = hc.wave_hist_layout(K, 2, F, B, N, quantized, 132)
                plan = lay.plan
                seen = np.zeros((K, F), np.int64)
                for k0, nk, f0, nf in _tiles(plan, K, F):
                    seen[k0:k0 + nk, f0:f0 + nf] += 1
                    assert nk * 2 * nf * B * acc <= plan.smem_bytes
                what = (K, F, B, N, quantized, plan)
                assert (seen == 1).all(), what
                assert plan.smem_bytes <= hc.HIST_SMEM_BUDGET, what
                if plan.direct and K == 1:
                    # one block's private copy holds the histogram
                    assert plan.feat_tiles == 1, what


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("K", [1, 16, 64, 128])
def test_wave_layout_zeroes_what_the_launch_adds_into(K, quantized):
    for B in (16, 64, 256):
        for F in (9, 28):
            for N in ROWS:
                lay = hc.wave_hist_layout(K, 2, F, B, N, quantized, 132)
                p, sz = lay.plan, lay.sizes
                n = K * 2 * F * B
                what = (K, F, B, N, quantized, lay)
                grouped = sz.W > 0
                assert grouped == (K > 1 and not p.direct), what
                # the membership pass's slots lead the scratch
                assert sz.scratch == N + (
                    K * sz.W + 2 * K + 1 + N if grouped else 0), what
                if quantized:
                    assert sz.acc == 0 and lay.zero_acc_bytes == 0, what
                    adds = p.direct or grouped or sz.segs > 1
                    assert lay.zero_out_bytes == (4 * n if adds else 0), what
                    continue
                if p.direct:
                    # the f64 sums and the grid barrier's counter after them
                    assert sz.acc >= n + 1, what
                    assert lay.zero_out_bytes == 0, what
                elif grouped or sz.segs > 1:
                    # the sums and a completion counter per tile
                    tiles = p.slot_tiles * p.feat_tiles
                    assert 2 * (sz.acc - n) >= tiles, what
                    assert lay.zero_out_bytes == (4 * n if grouped else 0)
                else:
                    assert sz.acc == 0 and lay.zero_out_bytes == 0, what
                assert lay.zero_acc_bytes == 8 * sz.acc, what


def test_wave_layout_of_the_main_path():
    # bench.py's shape on 2^20 rows: the root-like K = 1 wave sweeps
    # every row's slot in pieces with the channel pairing; wider waves
    # group their rows; 2^16 rows take the direct route
    lay = hc.wave_hist_layout(1, 2, 28, 64, 1 << 20, False, 132)
    assert not lay.plan.direct and lay.sizes.W == 0 and lay.plan.paired
    assert lay.sizes.segs > 1 and lay.zero_out_bytes == 0
    # the paired root-like wave reads one column at a time, the others
    # read a row's bins WAVE_PREFETCH columns ahead
    assert lay.prefetch == 1
    for K in (16, 128):
        lay = hc.wave_hist_layout(K, 2, 28, 64, 1 << 20, False, 132)
        assert not lay.plan.direct and lay.sizes.W > 0
        assert lay.zero_out_bytes == 4 * K * 2 * 28 * 64
        assert lay.prefetch == hc.WAVE_PREFETCH == 4
    with pytest.raises(ValueError):
        hc.wave_hist_layout(16, 2, 28, 64, 1 << 20, False, 132, prefetch=8)
    for K in (1, 16, 64):
        assert hc.wave_hist_layout(K, 2, 28, 64, 1 << 16, False,
                                   132).plan.direct


def test_wave_kernels_raise_on_cpu_tensors():
    from lightgbm_tpu_torch.ops import grow_fused as gf
    X = torch.zeros((4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        hc.wave_pass_cuda(X, torch.zeros((2, 8)), torch.zeros(
            8, dtype=torch.int32), torch.zeros((16, 128), dtype=torch.int32),
            1, 16, 16)
    with pytest.raises(ValueError):
        gf.wave_pass_fused_cuda(X, *([None] * 7), 1, 16, 16, None)
