"""Past the leaf cap: num_leaves > 4096 in the port against the JAX package
on the CPU.

The kernels #2, #3 / #9, #4, #5 and #10 keep 4096-entry leaf tables in
shared memory; past that they take global leaf maps (csrc/wave_table.cuh,
ops/histogram_cuda.py:new_leaf_map). Their plain versions, which the CPU runs,
are uncapped. Here:

  * (a) each plain version on a wave whose leaf ids are spread over
    [0, L), L in {8192, 131072} (ids up to L - 1 = 131071), against the
    JAX package's references on the same seeded tables: the leaf-value
    gather (`ops/histogram.py:take_leaf_values`), the Pallas wave pass,
    relabel and wave-apply kernels in interpret mode (decision bits from
    the numpy transcription of `grow_wave.py:dec_go_left`) and the XLA
    slot histogram. Leaf ids, slots and histograms of 1/64- or 1/4-grid
    values bitwise;
  * (b) one tree of both packages' `grow_tree_wave` at num_leaves = 4104
    from the same 1/64-grid gradients and a constant hessian (every sum
    exact in f32 and f64, so equal gains tie alike in both and the
    synthesized counts are integers, C notes 9 and 17): more than 4096
    leaves, the structure, counts and leaf_of_row equal;
  * (c) the port's batched and per-iteration models md5-equal, and their
    training scores equal, at num_leaves = 4104, a tree past 4096 leaves;
  * the histogram_pool_size ladder at num_leaves = 131072 on bench's
    shape (28 features, max_bin 63) chooses as the JAX package's does.
"""

import hashlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops.grow_wave import grow_tree_wave
from lightgbm_tpu.ops.histogram import (_build_histogram_slots_xla,
                                        take_leaf_values)
from lightgbm_tpu.ops.histogram_pallas import (wave_apply_pallas,
                                               wave_pass_pallas,
                                               wave_relabel_pallas)
from lightgbm_tpu_torch.ops import grow_fused as tf
from lightgbm_tpu_torch.ops import grow_wave as tw
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import histogram_cuda as hc
from lightgbm_tpu_torch.ops import split as ts

from test_torch_fused import HP, _apply_ref, _fmeta, _narrow_wave, _tiled_wave
from test_torch_wave_apply import _dec_go_left_np

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

LS = [8192, 131072]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _spread_map(rng, L, first_new):
    """[first_new + 256] int64: a small wave's leaf ids spread over [0, L):
    the old leaves [0, first_new) to distinct ids drawn from
    [0, L - 256), the new leaves first_new + j (right children, numbered
    consecutively from a table's first new leaf) to L - 256 + j."""
    base = L - 256
    old = rng.choice(base, first_new, replace=False)
    return np.concatenate([old, base + np.arange(256)]).astype(np.int64)


def _spread(m, leaves):
    """Leaf ids (-1 inactive) through the map m, int32."""
    leaves = np.asarray(leaves)
    return np.where(leaves >= 0, m[np.maximum(leaves, 0)], -1) \
        .astype(np.int32)


def _spread_table(m, t):
    t = t.copy()
    for r in (0, 7):
        t[r] = _spread(m, t[r])
    t[15] = m[t[15, 0]]
    return t


# ---------------------------------------------------------------------------
# (a) the plain versions past the cap
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L", LS)
def test_leaf_values_past_the_cap(L):
    """#2: the gather and the in-place score update at leaf ids spread
    over [0, L), bitwise the JAX gather (and its f32 add)."""
    rng = np.random.RandomState(L % 1000)
    N = 4000
    values = (rng.randint(-4096, 4096, L) / 64).astype(np.float32)
    lor = rng.randint(0, L, N).astype(np.int32)
    lor[:8] = [L - 1, 0, 4095, 4096, min(65535, L - 3), 65536 % L, L - 2,
               4097]
    ref = np.asarray(take_leaf_values(jnp.asarray(values), jnp.asarray(lor)))
    got = th.take_leaf_values(_t(values), _t(lor))
    np.testing.assert_array_equal(got.numpy(), ref)
    scores = (rng.randint(-640, 640, N) / 64).astype(np.float32)
    got_s = th.add_leaf_values_(_t(scores.copy()), _t(values), _t(lor))
    np.testing.assert_array_equal(got_s.numpy(),
                                  np.asarray(jnp.asarray(scores)
                                             + jnp.asarray(ref)))


def _mega_wave(L, seed, F=9, N=2000, B=64, K=8):
    """A mid-tree wave of tests/test_torch_kernels_ref.py's shape (30 old
    leaves, 12 applied, K candidates) with its leaf ids spread over
    [0, L): (X, vals on the 1/4 grid, spread leaf_of_row, spread table)."""
    rng = np.random.RandomState(seed)
    nl0, napp = 30, 12
    X = rng.randint(0, B, size=(F, N)).astype(np.uint8)
    vals = (rng.randint(-32, 32, size=(2, N)) * 0.25).astype(np.float32)
    lor = rng.randint(0, nl0, size=N).astype(np.int32)
    t = np.full((16, 128), -1, np.int64)
    for r0, leaves in ((0, rng.choice(nl0, napp, replace=False)),
                       (7, rng.choice(nl0 + napp, K, replace=False))):
        n = len(leaves)
        t[r0, :n] = leaves
        t[r0 + 1, :n] = rng.randint(0, F, n)
        t[r0 + 2, :n] = rng.randint(0, B - 1, n)
        t[r0 + 3, :n] = rng.randint(0, 2, n)
        t[r0 + 4, :n] = rng.randint(0, 3, n)
        t[r0 + 5, :n] = rng.randint(0, B - 1, n)
        t[r0 + 6, :n] = B - rng.randint(0, 2, n)
    t[14, :K] = rng.randint(0, 2, K)
    t[15] = nl0
    m = _spread_map(rng, L, nl0)
    return X, vals, _spread(m, lor), _spread_table(m, t.astype(np.int32)), \
        B, K


@pytest.mark.parametrize("L", LS)
def test_wave_pass_and_relabel_past_the_cap(L):
    """#3 and #5: leaf_of_row and the slot histogram bitwise the Pallas
    wave pass / relabel (interpret mode) at leaf ids past 4096."""
    X, vals, lor, tbl, B, K = _mega_wave(L, 3 + L % 7)
    assert (lor >= hc.LEAF_CAP).mean() > 0.4 and lor.max() < L
    ref_lor, ref_hist = wave_pass_pallas(
        jnp.asarray(X), jnp.asarray(vals), jnp.asarray(lor),
        jnp.asarray(tbl), K, B, interpret=True)
    got_lor, got_hist = th.wave_pass(_t(X), _t(vals), _t(lor), _t(tbl), K,
                                     B, L)
    np.testing.assert_array_equal(got_lor.numpy(), np.asarray(ref_lor))
    np.testing.assert_array_equal(got_hist.numpy(), np.asarray(ref_hist))
    assert (got_lor.numpy() != lor).any() and got_hist.abs().sum() > 0
    ref = wave_relabel_pallas(jnp.asarray(X), jnp.asarray(vals),
                              jnp.asarray(lor), jnp.asarray(tbl), B,
                              interpret=True)
    np.testing.assert_array_equal(
        th.wave_relabel(_t(X), _t(lor), _t(tbl), L).numpy(),
        np.asarray(ref))


@pytest.mark.parametrize("L", LS)
def test_wave_apply_past_the_cap(L):
    """#4: the per-row decide-and-apply pass at leaf ids past 4096 (an
    entry naming a leaf twice included) against the JAX decision bits
    (dec_go_left) and the Pallas wave-apply kernel."""
    rng = np.random.RandomState(40 + L % 11)
    N, F, B, Kd, napp, nl0 = 2500, 7, 64, 16, 12, 30
    nb = rng.randint(3, B + 1, size=F).astype(np.int32)
    mt = rng.randint(0, 3, size=F).astype(np.int32)
    db = np.minimum(rng.randint(0, B, size=F), nb - 1).astype(np.int32)
    X = np.stack([rng.randint(0, k, N) for k in nb]).astype(np.uint8)
    feat = rng.randint(0, F, size=(2, Kd))
    thr = rng.randint(0, B, size=(2, Kd))
    dl = rng.randint(0, 2, size=(2, Kd)).astype(bool)
    sil = rng.randint(0, 2, Kd)
    t = np.full((16, 128), -1, np.int32)
    t[0, :napp] = rng.choice(nl0, napp, replace=False)
    t[7, :Kd] = rng.choice(nl0 + napp, Kd, replace=False)
    t[0, 5] = t[0, 2]                  # a leaf applied twice: neither
    for side, r0 in ((0, 1), (1, 8)):
        f = feat[side]
        t[r0:r0 + 6, :Kd] = np.stack([f, thr[side], dl[side], mt[f], db[f],
                                      nb[f]])
    t[14, :Kd] = sil
    t[15] = nl0
    m = _spread_map(rng, L, nl0)
    tL = _spread_table(m, t)
    lor = _spread(m, rng.randint(0, nl0, N))
    assert (lor >= hc.LEAF_CAP).mean() > 0.4
    gl_a = _dec_go_left_np(X, feat[0], thr[0], dl[0], None, None, nb, mt,
                           db, None)
    gl_c = _dec_go_left_np(X, feat[1], thr[1], dl[1], None, None, nb, mt,
                           db, None)
    dec = np.zeros((128, N), np.int8)
    dec[:Kd] = gl_a.astype(np.int8) | ((gl_c == sil[:, None])
                                       .astype(np.int8) << 1)
    ref_lor, ref_slot = wave_apply_pallas(jnp.asarray(dec),
                                          jnp.asarray(lor),
                                          jnp.asarray(tL), interpret=True)
    got_lor, got_slot = th.wave_apply(_t(X), _t(lor), _t(tL), None, None,
                                      Kd, L)
    np.testing.assert_array_equal(got_lor.numpy(), np.asarray(ref_lor))
    np.testing.assert_array_equal(got_slot.numpy(), np.asarray(ref_slot))
    assert (got_slot.numpy() >= 0).any() and (got_lor.numpy() != lor).any()


@pytest.mark.parametrize("L", LS)
def test_fused_waves_past_the_cap(L):
    """#9 and #10: the narrow fused wave (against the Pallas wave pass) and
    the general one with a pending relabel (against the Pallas wave-apply
    chain and the XLA histogram), at leaf ids past 4096: leaf_of_row and
    the smaller children's histogram. Their split search reads neither
    (tests/test_torch_fused.py holds it to the JAX search)."""
    K, B, F = 4, 64, 9
    X, vals, lor, tbl, parent, scal, meta = _narrow_wave(B, F, 1200, K,
                                                         70 + L % 5)
    m = _spread_map(np.random.RandomState(L % 13), L, 12)
    lor, tbl = _spread(m, lor), _spread_table(m, tbl)
    ref_lor, ref_hist = wave_pass_pallas(
        jnp.asarray(X), jnp.asarray(vals), jnp.asarray(lor),
        jnp.asarray(tbl), K, B, interpret=True)
    got_lor, got_hist, _ = tf.wave_pass_fused_plain(
        _t(X), _t(vals), _t(lor), _t(tbl), _t(parent.reshape(K, -1)),
        _t(scal), _fmeta(meta), tf.fused_feature_mask(None, F, "cpu"), K, B,
        L, ts.SplitHyperParams(**HP))
    np.testing.assert_array_equal(got_lor.numpy(), np.asarray(ref_lor))
    np.testing.assert_array_equal(got_hist.numpy(), np.asarray(ref_hist))

    F, K = 33, 8
    X, vals, dec, lor, t, pend, parent, scal, meta, fmask = _tiled_wave(
        F, B, K, False, 80 + L % 3)
    # the pending relabel's new leaves 12-13 and this wave's 14-16 are
    # numbered on from leaf 12
    m = _spread_map(np.random.RandomState(L % 17), L, 12)
    lor, pend, t = _spread(m, lor), _spread(m, pend), _spread_table(m, t)
    pnl0 = int(m[12])
    got_lor, got_hist, _ = tf.wave_pass_fused_tiled_plain(
        _t(X), _t(vals), _t(dec), _t(lor), _t(t), _t(pend),
        torch.tensor([pnl0], dtype=torch.int32), _t(parent.reshape(K, -1)),
        _t(scal), _fmeta(meta), _t(fmask.astype(np.uint8)), K, B, L,
        ts.SplitHyperParams(**HP), None)
    lor1, _ = _apply_ref((dec >> 2) & 1, lor, pend,
                         np.full(128, -1, np.int32), pnl0)
    ref_lor, slot = _apply_ref(dec & 3, np.asarray(lor1), t[0], t[7],
                               int(t[15, 0]))
    ref_hist = np.asarray(_build_histogram_slots_xla(
        jnp.asarray(X), jnp.asarray(vals), slot, K, B))
    np.testing.assert_array_equal(got_lor.numpy(), np.asarray(ref_lor))
    np.testing.assert_array_equal(got_hist.numpy(), ref_hist)
    assert int((np.asarray(lor1) != lor).sum()) > 0


# ---------------------------------------------------------------------------
# (b) one tree past 4096 leaves against the JAX package
# ---------------------------------------------------------------------------
N_B, L_B = 12000, 4104
P_B = dict(objective="binary", num_leaves=L_B, max_bin=63,
           min_data_in_leaf=2, verbose=-1)


def _separated_data(N=N_B):
    rng = np.random.RandomState(3)
    X = rng.normal(size=(N, 8)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + np.sin(3 * X[:, 2])
         + rng.normal(scale=0.5, size=N) > 0).astype(np.float32)
    g = (np.round((0.5 - y + 0.1 * rng.normal(size=N)) * 64) / 64) \
        .astype(np.float32)
    return X, y, g, np.full(N, 0.25, np.float32)


def test_one_tree_past_the_cap_equals_jax():
    X, y, g, h = _separated_data()
    gj = lj.Booster(P_B, lj.Dataset(X, label=y))._gbdt
    gt = lt.Booster({**P_B, "device_type": "cpu", "binning_impl": "host"},
                    lt.Dataset(X, label=y))._gbdt
    assert gt.grower == gj.grower == "wave" and gt.grow_route == "mega"
    tj, lor_j = jax.jit(grow_tree_wave, static_argnames=("cfg",))(
        gj.X_t, jnp.asarray(g), jnp.asarray(h), jnp.ones(N_B, jnp.float32),
        gj.meta, cfg=gj.grow_cfg, rng_seed=jnp.int32(5))
    tt, lor_t = tw.grow_tree_wave(gt.X_t, _t(g), _t(h), torch.ones(N_B),
                                  gt.meta, gt.grow_cfg,
                                  hist_plan=gt.hist_plan, rng_seed=5)
    n = int(tj.num_leaves)
    assert tt.num_leaves == n > hc.LEAF_CAP
    assert tt.num_waves == int(tj.num_waves)
    m = n - 1
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "split_parent_leaf",
                 "internal_count"):
        np.testing.assert_array_equal(getattr(tt, name)[:m].numpy(),
                                      np.asarray(getattr(tj, name))[:m],
                                      err_msg=name)
    np.testing.assert_array_equal(tt.leaf_count.numpy(),
                                  np.asarray(tj.leaf_count))
    for name, k in (("leaf_value", n), ("split_gain", m)):
        np.testing.assert_allclose(getattr(tt, name)[:k].numpy(),
                                   np.asarray(getattr(tj, name))[:k],
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(lor_t.numpy(), np.asarray(lor_j))
    assert lor_t.max() >= hc.LEAF_CAP


# ---------------------------------------------------------------------------
# (c) batched and per-iteration models past the cap; the ladder
# ---------------------------------------------------------------------------
def test_batched_equals_per_iteration_past_the_cap(monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_DISABLE_BATCHED", "")
    # an L2 target of distinct values: one round on 10000 rows grows a
    # tree to the 4104-leaf limit; the training scores hold the score
    # update past the cap
    X, _, _, _ = _separated_data(10000)
    y = (X[:, 0] - X[:, 1] + np.sin(3 * X[:, 2])
         + np.random.RandomState(4).normal(scale=0.5, size=len(X))) \
        .astype(np.float32)
    p = {**P_B, "objective": "regression", "device_type": "cpu",
         "binning_impl": "host"}
    md5, leaves, scores = {}, {}, {}
    for bt in (True, False):
        b = lt.train({**p, "batched_train": bt}, lt.Dataset(X, label=y), 1)
        assert b._gbdt.batched_veto == ("" if bt else "batched_train=false")
        md5[bt] = hashlib.md5(b.model_to_string().encode()).hexdigest()
        leaves[bt] = [t.num_leaves for t in b._gbdt.models]
        scores[bt] = b._gbdt.scores.clone()
    assert md5[True] == md5[False]
    assert leaves[True] == leaves[False] and max(leaves[True]) > hc.LEAF_CAP
    assert torch.equal(scores[True], scores[False])


def test_leaf_cap_mirrors_the_cuda_header():
    """hc.LEAF_CAP is csrc/common.cuh's LGBT_LEAF_CAP, the one definition
    the kernels stage their leaf tables by."""
    import re
    text = (hc.CSRC / "common.cuh").read_text()
    assert int(re.search(r"#define LGBT_LEAF_CAP (\d+)", text).group(1)) \
        == hc.LEAF_CAP
    assert hc.new_leaf_map(torch.device("cpu"), 8192) is None


@pytest.mark.parametrize("pool", [-1, 4000, 20000])
def test_pool_ladder_at_131072_leaves_matches_jax(pool):
    """histogram_pool_size (MB) at num_leaves = 131072 on bench's shape:
    masked by default (the caches need GBs), compact once one cache fits,
    wave once the wave grower's fit, in both packages."""
    rng = np.random.RandomState(0)
    X = rng.normal(size=(2000, 28)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    p = dict(objective="binary", num_leaves=131072, max_bin=63, verbose=-1,
             histogram_pool_size=pool)
    gj = lj.Booster(p, lj.Dataset(X, label=y))._gbdt
    gt = lt.Booster({**p, "device_type": "cpu", "binning_impl": "host"},
                    lt.Dataset(X, label=y))._gbdt
    assert gt.grower == gj.grower
    assert gt._grower_feasible == gj._grower_feasible
    assert gt.grower == {-1: "masked", 4000: "compact", 20000: "wave"}[pool]
