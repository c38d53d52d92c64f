"""The wave-apply route's row pass: the port's decision-bit form
(dec_go_left + wave_apply_plain, which the general fused wave #10 still
reads) against the JAX package's wave_apply_pallas (interpret mode on the
CPU) and a numpy transcription of lightgbm_tpu/ops/grow_wave.py:896-929;
then the plain version of the wave_apply kernel, which decides each row
under the wave's split records (wave_apply_rows_plain), against that
composition on every missing type, categorical bitsets, bundled storage,
a duplicated leaf, entries past Kd and leaves outside the table.

Everything here is integer and selection work, so every comparison is
bitwise.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops.histogram_pallas import wave_apply_pallas
from lightgbm_tpu_torch.ops import grow as tg
from lightgbm_tpu_torch.ops import grow_wave as tw
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import histogram_cuda as hc
from lightgbm_tpu_torch.ops import split as ts

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)


def _table(rng, nl0, napp, ncand, leaves_after):
    t = np.full((16, 128), -1, np.int32)
    t[0, :napp] = rng.choice(nl0, napp, replace=False)
    t[7, :ncand] = rng.choice(leaves_after, ncand, replace=False)
    t[15] = nl0
    return t


def _both(dec, lor, tbl, L):
    """(port plain, JAX Pallas) outputs; the JAX kernel reads 128 entry
    rows, so dec is zero-padded past Kd (those entries are inactive)."""
    Kd, N = dec.shape
    pad = np.zeros((128, N), np.int8)
    pad[:Kd] = dec
    jl, js = wave_apply_pallas(jnp.asarray(pad), jnp.asarray(lor),
                               jnp.asarray(tbl), interpret=True)
    tl, tsl = hc.wave_apply_plain(torch.from_numpy(dec),
                                  torch.from_numpy(lor),
                                  torch.from_numpy(tbl), L)
    assert tl.dtype == tsl.dtype == torch.int32
    return (tl.numpy(), tsl.numpy()), (np.asarray(jl), np.asarray(js))


@pytest.mark.parametrize("N,Kd,napp,ncand,seed", [
    (3000, 128, 64, 128, 0),      # the TPU's full table
    (2500, 16, 12, 16, 1),        # a bucketed Kd below 128
    (1800, 48, 0, 40, 2),         # candidates only (no applied split)
    (1800, 8, 8, 0, 3),           # applies only (a tree's last wave)
])
def test_wave_apply_plain_matches_pallas(N, Kd, napp, ncand, seed):
    rng = np.random.RandomState(seed)
    L, nl0 = 255, 100
    tbl = _table(rng, nl0, napp, ncand, nl0 + napp)
    # rows of leaves in no table entry, and of every entry's leaf
    lor = rng.randint(0, nl0, size=N).astype(np.int32)
    dec = rng.randint(0, 4, size=(Kd, N)).astype(np.int8)
    (tl, tsl), (jl, js) = _both(dec, lor, tbl, L)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tsl, js)
    assert (tsl >= 0).any() == (ncand > 0)
    if napp:
        assert (tl >= nl0).any() and (tl < nl0).any()


def test_wave_apply_entries_past_kd_are_inactive():
    """A table entry at Kd or above names a real leaf but is ignored: no
    row of that leaf moves or takes a slot (the JAX kernel sees the entry
    inactive, -1)."""
    rng = np.random.RandomState(4)
    N, Kd, L, nl0 = 2000, 8, 63, 20
    tbl = _table(rng, nl0, 16, 16, nl0 + 16)
    lor = rng.randint(0, nl0, size=N).astype(np.int32)
    dec = rng.randint(0, 4, size=(Kd, N)).astype(np.int8)
    tl, tsl = hc.wave_apply_plain(torch.from_numpy(dec),
                                  torch.from_numpy(lor),
                                  torch.from_numpy(tbl), L)
    tbl_j = tbl.copy()
    tbl_j[0, Kd:] = -1
    tbl_j[7, Kd:] = -1
    (_, _), (jl, js) = _both(dec, lor, tbl_j, L)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tsl.numpy(), js)
    late = np.isin(lor, tbl[0, Kd:16])
    np.testing.assert_array_equal(tl.numpy()[late], lor[late])


def test_wave_apply_duplicate_leaf_matches_neither():
    """A leaf named by two active entries: the TPU kernel's `inA == 1`
    rule leaves its rows in place, and the port follows it."""
    rng = np.random.RandomState(5)
    N, Kd, L, nl0 = 1500, 16, 63, 20
    tbl = _table(rng, nl0, 10, 10, nl0 + 10)
    tbl[0, 3] = tbl[0, 7]
    tbl[7, 2] = tbl[7, 9]
    lor = rng.randint(0, nl0, size=N).astype(np.int32)
    dec = rng.randint(0, 4, size=(Kd, N)).astype(np.int8)
    (tl, tsl), (jl, js) = _both(dec, lor, tbl, L)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tsl, js)
    dup = lor == tbl[0, 7]
    assert dup.any()
    np.testing.assert_array_equal(tl[dup], lor[dup])


def test_wave_apply_kernel_refuses_cpu_tensors():
    X = torch.zeros((4, 10), dtype=torch.uint8)
    lor = torch.zeros(10, dtype=torch.int32)
    tbl = torch.full((16, 128), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        hc.wave_apply_cuda(X, lor, tbl, None, None, 4, 4)


# ---------------------------------------------------------------------------
# dec_go_left
# ---------------------------------------------------------------------------
MISSING_ZERO, MISSING_NAN = 1, 2


def _dec_go_left_np(X_t, feat, thr, dl, iscat, bits, nb, mt, db, bundle):
    """numpy transcription of grow_wave.py:896-929 (the W-way select chain
    over uint32 words included)."""
    F = len(nb)
    featc = np.clip(feat, 0, F - 1)
    if bundle is not None:
        col, off, bnb, bdb = (np.asarray(a) for a in bundle)
        src = X_t[col[featc]].astype(np.int32) & 0xFF
        o = off[featc][:, None]
        nbf = bnb[featc][:, None]
        dbf = bdb[featc][:, None]
        rb = src - o
        inr = (rb >= 0) & (rb < nbf - 1)
        unp = np.where(inr, rb + (rb >= dbf), dbf)
        binv = np.where(o < 0, src, unp)
    else:
        binv = X_t[featc].astype(np.int32) & 0xFF
    m = mt[featc][:, None]
    d = db[featc][:, None]
    n = nb[featc][:, None]
    miss = ((m == MISSING_ZERO) & (binv == d)) | \
        ((m == MISSING_NAN) & (binv == n - 1))
    gl = np.where(miss, dl[:, None].astype(bool), binv <= thr[:, None])
    if bits is not None:
        W = bits.shape[1]
        widx = np.clip(binv >> 5, 0, W - 1)
        wsel = np.zeros(binv.shape, np.uint32)
        for w in range(W):
            wsel = np.where(widx == w, bits[:, w:w + 1], wsel)
        gl_cat = ((wsel >> (binv & 31).astype(np.uint32)) & 1) == 1
        gl = np.where(iscat[:, None], gl_cat, gl)
    return gl


def _case(rng, N, F, B, n):
    nb = rng.randint(3, B + 1, size=F).astype(np.int32)
    mt = rng.randint(0, 3, size=F).astype(np.int32)
    db = np.minimum(rng.randint(0, B, size=F), nb - 1).astype(np.int32)
    feat = rng.randint(0, F, size=n)
    thr = rng.randint(0, B, size=n)
    dl = rng.randint(0, 2, size=n).astype(bool)
    return nb, mt, db, feat, thr, dl


def _port(X_t, feat, thr, dl, iscat, bits, nb, mt, db, B, cfg_kw):
    meta = ts.FeatureMeta(num_bins=torch.tensor(nb),
                          missing_type=torch.tensor(mt),
                          default_bin=torch.tensor(db),
                          is_categorical=torch.zeros(len(nb), dtype=bool))
    cfg = tg.GrowConfig(num_leaves=31, max_depth=-1, min_data_in_leaf=1.0,
                        min_sum_hessian_in_leaf=0.0, lambda_l1=0.0,
                        lambda_l2=0.0, max_delta_step=0.0,
                        min_gain_to_split=0.0, path_smooth=0.0,
                        num_bins_padded=B, **cfg_kw)
    W = cfg.cat_words
    b = (torch.zeros((len(feat), W), dtype=torch.int64) if bits is None
         else torch.from_numpy(bits.astype(np.int64)))
    ic = (torch.zeros(len(feat), dtype=torch.bool) if iscat is None
          else torch.from_numpy(iscat))
    got = tw.dec_go_left(torch.from_numpy(X_t), torch.from_numpy(feat),
                         torch.from_numpy(thr), torch.from_numpy(dl), ic, b,
                         meta, cfg)
    assert got.dtype == torch.bool
    return got.numpy()


def test_dec_go_left_missing_bins():
    """Zero- and NaN-missing features: the missing bin follows
    default_left, the rest the threshold; feature ids past F clamp."""
    rng = np.random.RandomState(6)
    N, F, B, n = 2000, 9, 64, 40
    nb, mt, db, feat, thr, dl = _case(rng, N, F, B, n)
    feat[:3] = [F, F + 5, -1]
    X_t = np.stack([rng.randint(0, k, N) for k in nb]).astype(np.uint8)
    want = _dec_go_left_np(X_t, feat, thr, dl, None, None, nb, mt, db, None)
    got = _port(X_t, feat, thr, dl, None, None, nb, mt, db, B, {})
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B", [64, 256])
def test_dec_go_left_categorical_bitsets(B):
    """Categorical entries test their bin bitset (every word in use at
    B = 256); numeric entries beside them keep the threshold rule."""
    rng = np.random.RandomState(7 + B)
    N, F, n = 2000, 6, 32
    W = (B + 31) // 32
    nb, mt, db, feat, thr, dl = _case(rng, N, F, B, n)
    nb[:] = B
    X_t = rng.randint(0, B, size=(F, N)).astype(np.uint8)
    iscat = rng.rand(n) < 0.6
    bits = rng.randint(0, 2 ** 32, size=(n, W), dtype=np.uint64) \
        .astype(np.uint32)
    want = _dec_go_left_np(X_t, feat, thr, dl, iscat, bits, nb, mt, db, None)
    got = _port(X_t, feat, thr, dl, iscat, bits, nb, mt, db, B,
                {"has_categorical": True})
    np.testing.assert_array_equal(got, want)


def test_dec_go_left_bundled_storage():
    """EFB storage: features unpacked from their bundle column (offset,
    compacted default bin) or read raw as singletons (offset -1)."""
    rng = np.random.RandomState(9)
    N, n, B = 2500, 48, 64
    # bundle 0 packs features 0-2 (num_bin 4, 5, 3), bundle 1 features
    # 3-4 (6, 4); features 5 and 6 are raw singleton columns 2 and 3
    nb = np.array([4, 5, 3, 6, 4, 40, 17], np.int32)
    db = np.array([0, 2, 1, 0, 3, 5, 0], np.int32)
    mt = np.array([1, 0, 1, 2, 1, 2, 0], np.int32)
    col = np.array([0, 0, 0, 1, 1, 2, 3])
    off = np.array([1, 4, 8, 1, 6, -1, -1])
    X = np.zeros((N, 7), np.int64)
    for f in range(7):
        X[:, f] = rng.randint(0, nb[f], N)
    X_t = np.zeros((4, N), np.uint8)
    for f in range(5):                       # mutually exclusive members
        own = rng.rand(N) < 0.3
        nd = own & (X[:, f] != db[f]) & (X_t[col[f]] == 0)
        rb = X[:, f] - (X[:, f] > db[f])
        X_t[col[f], nd] = off[f] + rb[nd]
    X_t[2], X_t[3] = X[:, 5], X[:, 6]
    feat = rng.randint(0, 7, size=n)
    thr = rng.randint(0, 8, size=n)
    dl = rng.randint(0, 2, size=n).astype(bool)
    bundle = (col, off, nb, db)
    want = _dec_go_left_np(X_t, feat, thr, dl, None, None, nb, mt, db,
                           bundle)
    got = _port(X_t, feat, thr, dl, None, None, nb, mt, db, B,
                dict(bundle_col=tuple(col.tolist()),
                     bundle_off=tuple(off.tolist()),
                     bundle_nb=tuple(nb.tolist()),
                     bundle_db=tuple(db.tolist())))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the per-row decide-and-apply pass (wave_apply's plain version) against the
# parent's composition: dec_go_left + wave_apply_plain
# ---------------------------------------------------------------------------
def _meta_cfg(nb, mt, db, B, cfg_kw):
    meta = ts.FeatureMeta(num_bins=torch.tensor(nb),
                          missing_type=torch.tensor(mt),
                          default_bin=torch.tensor(db),
                          is_categorical=torch.zeros(len(nb), dtype=bool))
    cfg = tg.GrowConfig(num_leaves=63, max_depth=-1, min_data_in_leaf=1.0,
                        min_sum_hessian_in_leaf=0.0, lambda_l1=0.0,
                        lambda_l2=0.0, max_delta_step=0.0,
                        min_gain_to_split=0.0, path_smooth=0.0,
                        num_bins_padded=B, **cfg_kw)
    return meta, cfg


def _records(rng, n, F, B, W, cat_frac):
    """n split records: features (a few past F or negative, which clamp),
    thresholds in [-1, B], default_left, categorical flags and bitsets."""
    feat = rng.randint(0, F, n)
    feat[rng.rand(n) < 0.05] = F + 3
    feat[rng.rand(n) < 0.05] = -2
    thr = rng.randint(-1, B + 1, n)
    dl = rng.randint(0, 2, n).astype(bool)
    iscat = rng.rand(n) < cat_frac
    bits = rng.randint(0, 2 ** 32, size=(n, W), dtype=np.uint64) \
        .astype(np.int64)
    return [torch.from_numpy(a) for a in (feat, thr, dl, iscat, bits)]


def _apply_case(X_t, nb, mt, db, B, seed, *, Kd=16, napp=12, ncand=16,
                cfg_kw=None, cat_frac=0.0, dup=False, lor_lo=0,
                lor_hi=None, default_left=None):
    """The per-row pass and the parent's composition on one wave: napp
    applied splits among leaves [0, 20), ncand candidates among the
    leaves after them (entries past Kd included in the table, inactive);
    returns ((new leaf, slot) per row, the same by the composition)."""
    rng = np.random.RandomState(seed)
    F, N = len(nb), X_t.shape[1]
    L, nl0 = 63, 20
    meta, cfg = _meta_cfg(nb, mt, db, B, cfg_kw or {})
    W = cfg.cat_words
    fa, ta, da, ca, ba = _records(rng, napp, F, B, W, cat_frac)
    fc, tc, dc, cc, bc = _records(rng, ncand, F, B, W, cat_frac)
    if default_left is not None:
        da[:], dc[:] = default_left, default_left
    sil = torch.from_numpy(rng.randint(0, 2, ncand).astype(bool))
    t = torch.full((16, 128), -1, dtype=torch.int32)
    t[0, :napp] = torch.from_numpy(rng.choice(nl0, napp, replace=False))
    t[7, :ncand] = torch.from_numpy(rng.choice(nl0 + napp, ncand,
                                               replace=False))
    if dup:
        t[0, 3] = t[0, 7]
        t[7, 2] = t[7, 9]
    # the table's per-feature columns are those of the clamped feature,
    # as the grower writes them for its (always valid) features
    t[1:7, :napp] = tw._split_rows(fa.clamp(0, F - 1), ta, da, meta)
    t[1, :napp] = fa.to(torch.int32)
    t[8:14, :ncand] = tw._split_rows(fc.clamp(0, F - 1), tc, dc, meta)
    t[8, :ncand] = fc.to(torch.int32)
    t[14, :ncand] = sil.to(torch.int32)
    t[15] = nl0
    lor = torch.from_numpy(rng.randint(lor_lo, lor_hi or nl0, N)
                           .astype(np.int32))
    X = torch.from_numpy(X_t)
    cats = (tw.pack_wave_cats(ca, ba, cc, bc, W) if cfg.has_categorical
            else None)
    got = th.wave_apply(X, lor, t, cats, tw.wave_bundle_map(cfg, X.device),
                        Kd, L)
    na, nc = min(napp, Kd), min(ncand, Kd)
    dec = torch.zeros((Kd, N), dtype=torch.uint8)
    dec[:na] = tw.dec_go_left(X, fa[:na], ta[:na], da[:na], ca[:na],
                              ba[:na], meta, cfg)
    glc = tw.dec_go_left(X, fc[:nc], tc[:nc], dc[:nc], cc[:nc], bc[:nc],
                         meta, cfg)
    dec[:nc] |= (glc == sil[:nc, None]).to(torch.uint8) << 1
    ref = hc.wave_apply_plain(dec, lor, t, L)
    return [a.numpy() for a in got], [a.numpy() for a in ref]


def _assert_apply_equal(got, ref):
    assert got[0].dtype == got[1].dtype == np.int32
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert (got[1] >= 0).any()


@pytest.mark.parametrize("missing_type", [0, 1, 2])
@pytest.mark.parametrize("default_left", [False, True])
def test_per_row_pass_missing_types(missing_type, default_left):
    """Every missing type with both default_left values: the missing bin
    (default_bin under Zero, num_bins - 1 under NaN) follows default_left,
    every other bin the threshold."""
    rng = np.random.RandomState(20 + missing_type)
    N, F, B = 3000, 7, 64
    nb = rng.randint(3, B + 1, size=F).astype(np.int32)
    db = np.minimum(rng.randint(0, B, size=F), nb - 1).astype(np.int32)
    mt = np.full(F, missing_type, np.int32)
    X_t = np.stack([rng.randint(0, k, N) for k in nb]).astype(np.uint8)
    got, ref = _apply_case(X_t, nb, mt, db, B, 30 + missing_type,
                           default_left=default_left)
    _assert_apply_equal(got, ref)


@pytest.mark.parametrize("default_left", [False, True])
@pytest.mark.parametrize("missing_type", [1, 2])
def test_per_row_pass_missing_bin_rows(missing_type, default_left):
    """Every row sits in its feature's missing bin or beside it, and every
    entry has the same default_left: the pass sends the missing bin's rows
    the default way."""
    rng = np.random.RandomState(50 + missing_type)
    N, F, B = 2000, 5, 64
    nb = np.full(F, 9, np.int32)
    db = np.full(F, 4, np.int32)
    mt = np.full(F, missing_type, np.int32)
    miss = db if missing_type == 1 else nb - 1
    X_t = (miss[:, None] - rng.randint(0, 2, (F, N))).astype(np.uint8)
    meta, cfg = _meta_cfg(nb, mt, db, B, {})
    lor = torch.from_numpy(rng.randint(0, 4, N).astype(np.int32))
    t = torch.full((16, 128), -1, dtype=torch.int32)
    t[0, :4] = torch.arange(4)
    feat = torch.arange(4)
    thr = torch.full((4,), 3)
    dl = torch.full((4,), default_left)
    t[1:7, :4] = tw._split_rows(feat, thr, dl, meta)
    t[15] = 10
    X = torch.from_numpy(X_t)
    got = th.wave_apply(X, lor, t, None, None, 4, 63)[0].numpy()
    dec = tw.dec_go_left(X, feat, thr, dl, torch.zeros(4, dtype=bool),
                         torch.zeros((4, 2), dtype=torch.int64), meta, cfg)
    ref = hc.wave_apply_plain(dec.to(torch.uint8), lor, t, 63)[0].numpy()
    np.testing.assert_array_equal(got, ref)
    in_miss = X_t[lor.numpy(), np.arange(N)] == miss[lor.numpy()]
    moved = got != lor.numpy()
    np.testing.assert_array_equal(moved[in_miss], not default_left)


@pytest.mark.parametrize("B", [64, 256])
def test_per_row_pass_categorical_bitsets(B):
    """Categorical entries test bit `bin` of their bitset (every word at
    B = 256), numeric entries beside them the threshold rule."""
    rng = np.random.RandomState(60 + B)
    N, F = 3000, 6
    nb = np.full(F, B, np.int32)
    db = rng.randint(0, B, size=F).astype(np.int32)
    mt = rng.randint(0, 3, size=F).astype(np.int32)
    X_t = rng.randint(0, B, size=(F, N)).astype(np.uint8)
    got, ref = _apply_case(X_t, nb, mt, db, B, 70 + B, Kd=32, napp=20,
                           ncand=32, cat_frac=0.6,
                           cfg_kw={"has_categorical": True})
    _assert_apply_equal(got, ref)


def test_per_row_pass_bundled_storage():
    """EFB storage: features unpacked from their bundle column, raw
    singletons (offset -1) read as they are."""
    rng = np.random.RandomState(9)
    N, B = 2500, 64
    nb = np.array([4, 5, 3, 6, 4, 40, 17], np.int32)
    db = np.array([0, 2, 1, 0, 3, 5, 0], np.int32)
    mt = np.array([1, 0, 1, 2, 1, 2, 0], np.int32)
    col = np.array([0, 0, 0, 1, 1, 2, 3])
    off = np.array([1, 4, 8, 1, 6, -1, -1])
    X = np.zeros((N, 7), np.int64)
    for f in range(7):
        X[:, f] = rng.randint(0, nb[f], N)
    X_t = np.zeros((4, N), np.uint8)
    for f in range(5):                       # mutually exclusive members
        own = rng.rand(N) < 0.3
        nd = own & (X[:, f] != db[f]) & (X_t[col[f]] == 0)
        rb = X[:, f] - (X[:, f] > db[f])
        X_t[col[f], nd] = off[f] + rb[nd]
    X_t[2], X_t[3] = X[:, 5], X[:, 6]
    kw = dict(bundle_col=tuple(col.tolist()), bundle_off=tuple(off.tolist()),
              bundle_nb=tuple(nb.tolist()), bundle_db=tuple(db.tolist()))
    got, ref = _apply_case(X_t, nb, mt, db, B, 80, cfg_kw=kw)
    _assert_apply_equal(got, ref)


def _plain_storage(seed, N=2500, F=6, B=64):
    rng = np.random.RandomState(seed)
    nb = rng.randint(3, B + 1, size=F).astype(np.int32)
    db = np.minimum(rng.randint(0, B, size=F), nb - 1).astype(np.int32)
    mt = rng.randint(0, 3, size=F).astype(np.int32)
    X_t = np.stack([rng.randint(0, k, N) for k in nb]).astype(np.uint8)
    return X_t, nb, mt, db, B


def test_per_row_pass_duplicated_leaf():
    """A leaf named by two active entries matches neither (the TPU
    kernel's `inA == 1` rule): its rows stay and take no slot."""
    X_t, nb, mt, db, B = _plain_storage(90)
    got, ref = _apply_case(X_t, nb, mt, db, B, 91, dup=True)
    _assert_apply_equal(got, ref)


def test_per_row_pass_entries_past_kd():
    """Entries at Kd or above name real leaves but are inactive."""
    X_t, nb, mt, db, B = _plain_storage(92)
    got, ref = _apply_case(X_t, nb, mt, db, B, 93, Kd=8, napp=16,
                           ncand=16)
    _assert_apply_equal(got, ref)


def test_per_row_pass_leaves_outside_the_table():
    """Leaf ids outside [0, num_leaves) and leaves of no entry: unchanged,
    no slot."""
    X_t, nb, mt, db, B = _plain_storage(94)
    got, ref = _apply_case(X_t, nb, mt, db, B, 95, lor_lo=-3, lor_hi=70)
    _assert_apply_equal(got, ref)
