"""The fused growth route of the port (histogram_impl="fused") against the
JAX package on the CPU.

The JAX package defines its fused kernels as bit-identical to the two-pass
wave (lightgbm_tpu/ops/grow_fused.py:30-32), so the reference here is the
two-pass computation on its portable functions: the wave's relabel and slot
histogram (`wave_pass_pallas` / `wave_apply_pallas` in interpret mode, the
XLA slot histogram), then `synth_count_channel` + `find_best_split` of
every child. Its Pallas fused kernels do not run on this jax version.

Tolerances:
  * leaf_of_row and the histograms bitwise: values on a 1/4 grid (int8 for
    the quantized case) sum exactly in any order;
  * the records' feature, threshold and default_left exactly; their float
    fields within rtol 1e-5 / atol 1e-6, the tolerance of
    tests/test_torch_split.py for the port's search against the JAX one
    (the same f32 formulas, evaluated in another operation order by XLA);
  * whole runs: trees and predictions within the tolerances of
    tests/test_torch_wide.py (structure exact; values rtol 1e-4; raw
    predictions rtol 1e-5). num_leaves stays at 17 or below: the JAX CPU
    route caps a wave at 128 candidates, the fused routes at 16 for
    B = 256, and the ladders agree only while K <= 16.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu.ops import grow_wave as jgw
from lightgbm_tpu.ops import split as js
from lightgbm_tpu.ops.histogram import _build_histogram_slots_xla
from lightgbm_tpu.ops.histogram_pallas import (_compute_dims,
                                               wave_apply_pallas,
                                               wave_pass_pallas)
from lightgbm_tpu_torch.convert import booster_from_state
from lightgbm_tpu_torch.ops import grow as tgrow
from lightgbm_tpu_torch.ops import grow_fused as tf
from lightgbm_tpu_torch.ops import grow_wave as tgw
from lightgbm_tpu_torch.ops import split as ts

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

HP = dict(min_data_in_leaf=5.0, min_sum_hessian_in_leaf=1e-3,
          lambda_l1=0.0, lambda_l2=0.0, max_delta_step=0.0,
          min_gain_to_split=0.0, path_smooth=0.0)
MT_NONE, MT_ZERO, MT_NAN = 0, 1, 2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _meta(rng, F, B):
    """num_bins, missing_type, default_bin of F features (int32)."""
    nb = rng.randint(B // 2, B + 1, size=F).astype(np.int32)
    mt = rng.choice([MT_NONE, MT_ZERO, MT_NAN], size=F).astype(np.int32)
    db = np.minimum(rng.randint(0, B, size=F), nb - 1).astype(np.int32)
    return nb, mt, db


def _scalars(rng, K):
    """[7, 2K] per-child parent scalars: sums, counts, outputs, the
    smaller_is_left flags (left children first) and unconstrained monotone
    bounds (-inf, +inf)."""
    sg = rng.normal(size=2 * K)
    sh = np.abs(rng.normal(size=2 * K)) * 30 + 5
    cnt = rng.randint(40, 400, size=2 * K).astype(np.float64)
    out = rng.normal(size=2 * K) * 0.1
    sil = np.tile(rng.randint(0, 2, size=K), 2)
    inf = np.full(2 * K, np.inf)
    return np.stack([sg, sh, cnt, out, sil, -inf, inf]).astype(np.float32)


def _jax_children(small, parent, scal, meta, fmask, scale=None):
    """The JAX two-pass search of every child: small [K, 2, F, B] (f32 or
    int32), parent the same shape; SplitResult of [2K] numpy arrays."""
    K = small.shape[0]
    sil = jnp.asarray(scal[4, :K] != 0)[:, None, None, None]
    sm, pa = jnp.asarray(small), jnp.asarray(parent)
    ch = jnp.concatenate([jnp.where(sil, sm, pa - sm),
                          jnp.where(sil, pa - sm, sm)])
    if scale is not None:
        ch = ch.astype(jnp.float32) * jnp.asarray(
            scale, jnp.float32)[:, None, None]
    nb, mt, db = meta
    jm = js.FeatureMeta(num_bins=jnp.asarray(nb),
                        missing_type=jnp.asarray(mt),
                        default_bin=jnp.asarray(db),
                        is_categorical=jnp.zeros(nb.shape[0], bool))
    hp = js.SplitHyperParams(**HP)

    def one(h, sg, sh, c, o, fm):
        return js.find_best_split(js.synth_count_channel(h, c, sh), sg, sh,
                                  c, o, jm, hp, fm)
    s = jnp.asarray(scal)
    res = jax.vmap(one)(ch, s[0], s[1], s[2], s[3], jnp.asarray(fmask))
    return js.SplitResult(*[np.asarray(x) for x in res])


def _assert_records(rec, ref, K):
    got = tf.unpack_fused_records(rec, K)
    for name in ("feature", "threshold", "default_left"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(ref, name), err_msg=name)
    for name in ts.SplitResult._fields[4:] + ("gain",):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(ref, name), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _fmeta(meta):
    nb, mt, db = meta
    return _t(np.stack([nb, mt, db, np.zeros_like(nb),
                        np.zeros_like(nb)]).astype(np.int32))


# ---------------------------------------------------------------------------
# 9. the narrow fused wave
# ---------------------------------------------------------------------------
def _narrow_wave(B, F, N, K, seed):
    """A mid-tree wave: rows over 12 leaves, 4 applied splits, K
    candidates (surviving leaves and fresh right children), parents on the
    1/4 grid that dominate the smaller children."""
    rng = np.random.RandomState(seed)
    X = rng.randint(0, B - 1, size=(F, N)).astype(np.uint8)
    vals = (rng.randint(-32, 32, size=(2, N)) * 0.25).astype(np.float32)
    lor = rng.randint(0, 12, size=N).astype(np.int32)
    t = np.full((16, 128), -1, np.int64)
    app = [0, 3, 5, 7]
    cand = rng.choice([0, 1, 2, 3, 4, 12, 13, 14, 15], K, replace=False)
    for r0, leaves in ((0, app), (7, cand)):
        n = len(leaves)
        t[r0, :n] = leaves
        t[r0 + 1, :n] = rng.randint(0, F, n)
        t[r0 + 2, :n] = rng.randint(0, B - 2, n)
        t[r0 + 3, :n] = rng.randint(0, 2, n)
        t[r0 + 4, :n] = rng.randint(0, 3, n)
        t[r0 + 5, :n] = rng.randint(0, B - 1, n)
        t[r0 + 6, :n] = B - 1
    scal = _scalars(rng, K)
    t[14, :K] = scal[4, :K]
    t[15] = 12
    parent = (np.round(np.abs(rng.normal(size=(K, 2, F, B))) * 200) / 4
              ).astype(np.float32)
    return X, vals, lor, t.astype(np.int32), parent, scal, _meta(rng, F, B)


@pytest.mark.parametrize("B,F", [(32, 9), (64, 28), (128, 6), (256, 4)])
def test_wave_pass_fused_plain_matches_two_pass(B, F):
    N, K = 1200, 4
    X, vals, lor, tbl, parent, scal, meta = _narrow_wave(B, F, N, K, 55 + B)
    ref_lor, ref_hist = wave_pass_pallas(
        jnp.asarray(X), jnp.asarray(vals), jnp.asarray(lor),
        jnp.asarray(tbl), K, B, interpret=True)
    got_lor, got_hist, rec = tf.wave_pass_fused_plain(
        _t(X), _t(vals), _t(lor), _t(tbl), _t(parent.reshape(K, -1)),
        _t(scal), _fmeta(meta), tf.fused_feature_mask(None, F, "cpu"), K, B,
        256, ts.SplitHyperParams(**HP))
    np.testing.assert_array_equal(got_lor.numpy(), np.asarray(ref_lor))
    np.testing.assert_array_equal(got_hist.numpy(), np.asarray(ref_hist))
    ref = _jax_children(np.asarray(ref_hist), parent, scal, meta,
                        np.ones((2 * K, F), bool))
    _assert_records(rec, ref, K)
    assert np.isfinite(ref.gain).sum() >= K


# ---------------------------------------------------------------------------
# 10. the general (feature-tiled on the TPU) fused wave
# ---------------------------------------------------------------------------
def _tiled_wave(F, B, K, quant, seed, N=1500):
    """A mid-tree wave from decision bits: rows over 12 leaves; a pending
    relabel of leaves 2 and 5 (right children 12, 13); this wave applies
    leaves 0, 3 and 12 (right children 14-16) and speculates K leaves;
    random decision bits; per-child feature masks."""
    rng = np.random.RandomState(seed)
    X = rng.randint(0, B, size=(F, N)).astype(np.uint8)
    if quant:
        vals = rng.randint(-127, 128, size=(2, N)).astype(np.int8)
        parent = rng.randint(0, 4000, size=(K, 2, F, B)).astype(np.int32)
    else:
        vals = (rng.randint(-32, 32, size=(2, N)) * 0.25).astype(np.float32)
        parent = (np.round(np.abs(rng.normal(size=(K, 2, F, B))) * 200)
                  / 4).astype(np.float32)
    lor = rng.randint(0, 12, size=N).astype(np.int32)
    dec = rng.randint(0, 8, size=(K, N)).astype(np.uint8)
    pend = np.full(128, -1, np.int32)
    pend[:2] = [2, 5]
    t = np.full((16, 128), -1, np.int32)
    t[0, :3] = [0, 3, 12]
    t[7, :K] = rng.choice(17, K, replace=False)
    t[15] = 14
    scal = _scalars(rng, K)
    fmask = rng.rand(2 * K, F) < 0.8
    return X, vals, dec, lor, t, pend, parent, scal, _meta(rng, F, B), fmask


def _apply_ref(dec, lor, leaves, cand, nl0):
    """JAX wave_apply_pallas with a [128, N] int8 decision matrix."""
    d = np.zeros((128, dec.shape[1]), np.int8)
    d[:dec.shape[0]] = dec
    t = np.full((16, 128), -1, np.int32)
    t[0] = leaves
    t[7] = cand
    t[15] = nl0
    return wave_apply_pallas(jnp.asarray(d), jnp.asarray(lor),
                             jnp.asarray(t), interpret=True)


@pytest.mark.parametrize("F,B,tile,quant", [
    (33, 256, 32, False),      # one column past a tile
    (64, 256, 64, True),       # int8 values, exact int32 sums
    (100, 64, 128, False),     # a ragged last tile
    (100, 256, 128, True)])
def test_wave_pass_fused_tiled_plain_matches_two_pass(F, B, tile, quant):
    K = tgw.fused_kcap(B, tile)       # the route's widest wave
    X, vals, dec, lor, t, pend, parent, scal, meta, fmask = _tiled_wave(
        F, B, K, quant, F + B + tile)
    scale = torch.tensor([0.03125, 0.0078125]) if quant else None
    got_lor, got_hist, rec = tf.wave_pass_fused_tiled_plain(
        _t(X), _t(vals), _t(dec), _t(lor), _t(t), _t(pend),
        torch.tensor([12], dtype=torch.int32),
        _t(parent.reshape(K, -1)), _t(scal), _fmeta(meta),
        _t(fmask.astype(np.uint8)), K, B, 256, ts.SplitHyperParams(**HP),
        scale)
    # JAX: the pending pass, then the apply pass, then the XLA slot
    # histogram of the smaller children
    lor1, _ = _apply_ref((dec >> 2) & 1, lor, pend,
                         np.full(128, -1, np.int32), 12)
    ref_lor, slot = _apply_ref(dec & 3, np.asarray(lor1), t[0], t[7], 14)
    ref_hist = np.asarray(_build_histogram_slots_xla(
        jnp.asarray(X), jnp.asarray(vals), slot, K, B))
    np.testing.assert_array_equal(got_lor.numpy(), np.asarray(ref_lor))
    assert got_hist.dtype == (torch.int32 if quant else torch.float32)
    np.testing.assert_array_equal(got_hist.numpy(), ref_hist)
    assert int((np.asarray(lor1) != lor).sum()) > 0      # pending pass ran
    ref = _jax_children(ref_hist, parent, scal, meta, fmask,
                        None if scale is None else scale.numpy())
    _assert_records(rec, ref, K)


# ---------------------------------------------------------------------------
# routes, caps, vetoes
# ---------------------------------------------------------------------------
def _jax_kcap(B, tile):
    """grow_wave.py:310-338 recomputed: the narrow kernel (tile None) and
    the tiled kernel's K caps."""
    B_lane = _compute_dims(B)[0]
    kcap = 3_400_000 // (2 * (32 if tile is None else tile) * B_lane * 4)
    kcap //= 2
    kcap = max(1 << (kcap.bit_length() - 1), 1) if kcap >= 1 else 1
    return min(kcap, 128)


def _cfgs(B, tile=32, L=255, **kw):
    common = dict(num_leaves=L, max_depth=-1, min_data_in_leaf=20.0,
                  min_sum_hessian_in_leaf=1e-3, lambda_l1=0.0,
                  lambda_l2=0.0, max_delta_step=0.0, min_gain_to_split=0.0,
                  path_smooth=0.0, num_bins_padded=B, **kw)
    return (tgrow.GrowConfig(fused_feature_tile=tile, **common),
            jgrow.GrowConfig(fused_feature_tile=tile, **common))


@pytest.mark.parametrize("tile", [32, 64, 128])
@pytest.mark.parametrize("B", [32, 64, 128, 256])
def test_fused_wave_ladders_match_jax(B, tile):
    tc, _ = _cfgs(B, tile, hist_impl="fused")
    assert tgw.wave_buckets_for(tc, "fused") == jgw._wave_buckets(
        255, _jax_kcap(B, None))
    assert tgw.wave_buckets_for(tc, "fused_tiled") == jgw._wave_buckets(
        255, _jax_kcap(B, tile))
    assert tgw.fused_kcap(B) == _jax_kcap(B, None)


@pytest.mark.parametrize("over,env,route", [
    ({"hist_impl": "fused"}, None, "fused"),
    ({"hist_impl": "auto"}, None, "mega"),
    ({"hist_impl": "fused"}, "1", "mega"),
    ({"hist_impl": "fused", "bundle_col": (0, 0, 1),
      "bundle_off": (1, 4, -1), "bundle_nb": (4, 4, 9),
      "bundle_db": (0, 0, 0)}, None, "apply"),
    ({"hist_impl": "fused", "has_categorical": True}, None, "fused_tiled")])
def test_fused_vetoes_match_jax(monkeypatch, over, env, route):
    if env is None:
        monkeypatch.delenv("LIGHTGBM_TPU_DISABLE_FUSED", raising=False)
    else:
        monkeypatch.setenv("LIGHTGBM_TPU_DISABLE_FUSED", env)
    tc, jc = _cfgs(64, **over)
    F = 3
    jm = js.FeatureMeta(num_bins=jnp.full(F, 9), missing_type=jnp.zeros(F),
                        default_bin=jnp.zeros(F),
                        is_categorical=jnp.zeros(F, bool))
    assert tgw.fused_veto_reasons(tc) == jgw.fused_veto_reasons(
        jc, jm, False, True)
    assert tgw.wave_routes(tc, 2 if tc.bundled else F)[0] == route


# ---------------------------------------------------------------------------
# whole runs against the JAX package
# ---------------------------------------------------------------------------
PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              learning_rate=0.1, min_data_in_leaf=20, verbose=-1,
              bagging_freq=0, histogram_impl="fused")
TORCH = {"device_type": "cpu", "binning_impl": "host"}


def _blocks(text):
    body = text.split("end of trees")[0]
    return [dict(ln.split("=", 1) for ln in blk.splitlines()[1:] if "=" in ln)
            for blk in body.split("Tree=")[1:]]


def _nums(s, dtype=float):
    return np.array(s.split(), dtype=dtype)


def _assert_same_model(X, bj, bt, rounds):
    tt, tj = _blocks(bt.model_to_string()), _blocks(bj.model_to_string())
    assert len(tt) == len(tj) == rounds
    for a, b in zip(tt, tj):
        for k in ("num_leaves", "num_cat", "split_feature", "threshold",
                  "left_child", "right_child", "cat_boundaries",
                  "cat_threshold"):
            assert a.get(k) == b.get(k), k
        np.testing.assert_array_equal(_nums(a["decision_type"], int) & ~2,
                                      _nums(b["decision_type"], int) & ~2)
        for k in ("split_gain", "leaf_value", "internal_value"):
            np.testing.assert_allclose(_nums(a[k]), _nums(b[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


def _dense(F, N=3000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N, F)).astype(np.float32)
    X[rng.rand(N) < 0.1, 1] = np.nan
    w = np.zeros(F)
    w[:6] = [3.0, -2.5, 2.0, 1.6, -1.3, 1.0]
    y = (np.nan_to_num(X) @ w + rng.normal(scale=0.3, size=N) > 0)
    return X, y.astype(np.float32)


def _categorical(N=4000):
    """F = 40 with categorical columns 0, 3, 7 and 11 (12, 30, 3 and 9
    categories; one-hot and sorted many-vs-many splits)."""
    rng = np.random.RandomState(1)
    X = rng.normal(size=(N, 40)).astype(np.float32)
    cards = {0: 12, 3: 30, 7: 3, 11: 9}
    z = 0.8 * X[:, 1]
    for c, n in cards.items():
        codes = rng.randint(0, n, N)
        X[:, c] = codes
        z = z + np.sin(np.arange(n) * (1.3 + c))[codes]
    X[rng.rand(N) < 0.02, 3] = np.nan
    y = (z + rng.normal(scale=0.3, size=N) > 0).astype(np.float32)
    return X, y, dict(categorical_feature=list(cards))


@pytest.fixture(scope="module")
def dense9():
    X, y = _dense(9)
    bj = lj.train(PARAMS, lj.Dataset(X, label=y), num_boost_round=2)
    return X, y, bj


@pytest.mark.parametrize("case", ["dense9", "wide40", "cat40", "wide255"])
def test_fused_training_matches_jax(case, request):
    over, rounds = {}, 2
    if case == "dense9":
        X, y, bj = request.getfixturevalue("dense9")
        dskw, route = {}, "fused"
    else:
        if case == "cat40":
            X, y, dskw = _categorical()
            over = dict(max_cat_to_onehot=4, max_cat_threshold=16)
        elif case == "wide40":
            (X, y), dskw = _dense(40), {}
        else:
            (X, y), dskw = _dense(255, N=1000), {}
            over, rounds = dict(max_bin=255, num_leaves=17), 1
        bj = lj.train({**PARAMS, **over}, lj.Dataset(X, label=y, **dskw),
                      num_boost_round=rounds)
        route = "fused_tiled"
    bt = lt.train({**PARAMS, **TORCH, **over}, lt.Dataset(X, label=y, **dskw),
                  num_boost_round=rounds)
    g = bt._gbdt
    assert g.grow_route == route and g.fused_veto_reasons == []
    _assert_same_model(X, bj, bt, rounds)
    if case == "cat40":
        assert sum(t.num_cat for t in g.models) > 0


def _count_calls(monkeypatch, name):
    calls = []
    fn = getattr(tgw, name)

    def spy(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    monkeypatch.setattr(tgw, name, spy)
    return calls


def test_relabel_fusion_on_and_off_grow_the_same_trees(monkeypatch):
    """The pending relabel rides into the next fused launch (fusion on) or
    runs at once through wave_apply (off): the same trees, and the apply
    route's. The data and the slack of 0.9 make applies-only waves
    mid-tree, so the kernels' pending pass runs, and two of them in a row,
    so the mid-tree flush runs."""
    rng = np.random.RandomState(2)
    X = rng.normal(size=(6000, 40)).astype(np.float32)
    X[:, 5] = rng.randint(0, 30, 6000)
    y = ((X[:, :5] @ rng.normal(size=5) + (X[:, 5] % 7 == 0) * 3
          + rng.normal(size=6000)) > 0).astype(np.float32)
    p = {**PARAMS, **TORCH, "num_leaves": 17, "max_bin": 255,
         "tpu_wave_gain_slack": 0.9, "min_data_in_leaf": 300}
    texts, pend_waves = [], []
    orig = tgw.wave_pass_fused_tiled

    def spy(X_, v, dec, lor, tbl, pend, *a, **kw):
        pend_waves.append(int((pend >= 0).sum()))
        return orig(X_, v, dec, lor, tbl, pend, *a, **kw)
    monkeypatch.setattr(tgw, "wave_pass_fused_tiled", spy)
    flushes = _count_calls(monkeypatch, "_flush_pending")
    for over in ({"fused_relabel_fusion": True},
                 {"fused_relabel_fusion": False},
                 {"histogram_impl": "auto"}):
        bt = lt.train({**p, **over}, lt.Dataset(X, label=y),
                      num_boost_round=3)
        texts.append(bt.model_to_string().split("parameters:")[0])
        if over.get("fused_relabel_fusion"):
            assert bt._gbdt.grow_route == "fused_tiled"
            # more flushes than trees: some ran mid-tree
            assert len(flushes) > 3 and any(pend_waves)
    # the same trees, and those of the two-pass apply route
    assert bt._gbdt.grow_route == "apply"
    assert texts[0] == texts[1] == texts[2]


def test_fused_matches_two_pass_route():
    """On the CPU the fused routes run their kernels' plain versions, which
    are the two-pass computation: the trees equal those of the megakernel
    and apply routes bit for bit."""
    for F, other in ((9, "mega"), (40, "apply")):
        X, y = _dense(F, N=2000)
        texts = []
        for impl in ("fused", "auto"):
            bt = lt.train({**PARAMS, **TORCH, "histogram_impl": impl},
                          lt.Dataset(X, label=y), num_boost_round=2)
            texts.append(bt.model_to_string().split("parameters:")[0])
        assert bt._gbdt.grow_route == other
        assert texts[0] == texts[1]


def test_efb_data_under_fused_takes_the_apply_route():
    from lightgbm_tpu_torch.utils.synthetic import efb_like
    X, y = efb_like(2000, n_sparse=24, n_dense=6)
    bt = lt.train({**PARAMS, **TORCH}, lt.Dataset(X, label=y), 1)
    assert bt._gbdt.grow_route == "apply"
    assert bt._gbdt.fused_veto_reasons == ["efb_bundled"]


def test_jax_fused_model_carried_across(dense9):
    X, _, bj = dense9
    g = bj._gbdt
    bst = booster_from_state(
        params=bj.params, trees=[vars(t) for t in g.models],
        mappers=[m.to_dict() for m in g.mappers],
        real_feature_index=g.real_feature_index,
        feature_names=g.feature_names_,
        num_total_features=g.max_feature_idx_ + 1)
    np.testing.assert_allclose(bst.predict(X), bj.predict(X), rtol=0,
                               atol=1e-12)
    assert _blocks(bst.model_to_string()) == _blocks(bj.model_to_string())


def test_search_cumsum_in_f64_is_the_cpu_cumsum():
    """The search's prefix sums run in f64 and round each prefix once: on
    the CPU that is what torch's f32 cumsum gives, bit for bit."""
    rng = np.random.RandomState(3)
    a = torch.from_numpy((rng.normal(size=(6, 3, 40, 256)) * 1e3)
                         .astype(np.float32))
    assert torch.equal(torch.cumsum(a.double(), -1).float(),
                       torch.cumsum(a, -1))
    ref = np.cumsum(a.numpy().astype(np.float64), -1).astype(np.float32)
    np.testing.assert_array_equal(torch.cumsum(a, -1).numpy(), ref)
