"""Device binning of the port (lightgbm_tpu_torch/ops/bucketize.py) against
the JAX package: the packed bin tables, and the plain version of the
bucketize kernel against JAX's XLA lowering, its Pallas kernel in interpret
mode, and the host BinMapper / BinnedModel.bin_rows semantics.

Binning is integer work, so every comparison is bitwise. One documented
exception: JAX's XLA lowering lifts the NaN pads of a categorical table
row to +inf before its search, so a raw +inf categorical value in a
serve-mode table lands on a pad lane (bin 0) there, while the Pallas kernel,
the host path and the port give the sentinel bin (ROADMAP C).
"""

import math

import numpy as np
import pytest
import torch

from lightgbm_tpu.data.binning import BIN_TYPE_CATEGORICAL as J_CAT
from lightgbm_tpu.data.binning import BIN_TYPE_NUMERICAL as J_NUM
from lightgbm_tpu.data.binning import BinMapper as JBinMapper
from lightgbm_tpu.data.binning import categorical_to_bin_sentinel
from lightgbm_tpu.ops import bucketize as jb
from lightgbm_tpu_torch.data.binning import BinMapper as TBinMapper
from lightgbm_tpu_torch.ops import bucketize as tb

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

INTERP = "LIGHTGBM_TPU_PALLAS_INTERPRET"


def _edge_col(rng, n):
    """f32 numeric fixture over the parity edges: NaN, ±0, subnormals,
    huge magnitudes, ±inf."""
    v = rng.normal(scale=50.0, size=n).astype(np.float32)
    v[rng.rand(n) < 0.08] = np.nan
    v[rng.rand(n) < 0.08] = 0.0
    v[rng.rand(n) < 0.04] = -0.0
    v[:8] = np.array([1e-45, -1e-45, 1e-40, -1e-40, 3e38, -3e38, np.inf,
                      -np.inf], np.float32)
    return v


def _mappers(seed, F=6, max_bin=63, zero_as_missing=False,
             use_missing=True):
    """JAX BinMappers over adversarial samples (the last column
    categorical, with negative codes in the fit sample) and their port
    copies."""
    rng = np.random.RandomState(seed)
    n = 2000
    X = np.stack([_edge_col(rng, n) for _ in range(F)], axis=1)
    X[:, F - 1] = rng.randint(-2, 30, size=n).astype(np.float32)
    jm = [JBinMapper.find_bin(
        np.asarray(X[:, f], np.float64), n, max_bin, 3, 20,
        bin_type=J_CAT if f == F - 1 else J_NUM,
        use_missing=use_missing, zero_as_missing=zero_as_missing)
        for f in range(F)]
    return jm, [TBinMapper.from_dict(m.to_dict()) for m in jm]


def _probe(rng, jm, n=400):
    """Query rows: edge values in every column, every floored bound of
    each numeric mapper and one f32 ulp either side of it, and integer,
    fractional, negative, unseen and infinite categories."""
    F = len(jm)
    cols = []
    for f, m in enumerate(jm):
        if m.bin_type == J_CAT:
            c = rng.randint(-3, 40, size=n).astype(np.float32)
            c[:10] = [np.nan, np.inf, -np.inf, -0.5, 2.7, -1.0, 1e30, -0.0,
                      31.0, 2.0 ** 24]
        else:
            ub = np.asarray(m.bin_upper_bound, np.float64)
            b32 = tb._floor_f32(ub[np.isfinite(ub)])
            edges = np.concatenate([
                b32, np.nextafter(b32, np.float32(-np.inf)),
                np.nextafter(b32, np.float32(np.inf))])
            c = _edge_col(rng, max(n, len(edges)))[:n]
            k = min(len(edges), n - 8)
            c[8:8 + k] = edges[:k]
        cols.append(c)
    return np.stack(cols, axis=1).astype(np.float32)


def _host_bins(jm, X, mode, used=None):
    """The host semantics the table modes reproduce: value_to_bin (train),
    BinnedModel.bin_rows (serve: sentinel categories, unused columns 0)."""
    out = np.zeros(X.shape, np.int64)
    for f, m in enumerate(jm):
        if used is not None and f not in used:
            continue
        col = np.asarray(X[:, f], np.float64)
        if mode == "serve" and m.bin_type == J_CAT:
            keys = np.array(sorted(m.categorical_2_bin), np.int64)
            vals = np.array([m.categorical_2_bin[k] for k in keys.tolist()],
                            np.int64)
            with np.errstate(invalid="ignore"):
                out[:, f] = categorical_to_bin_sentinel(col, keys, vals,
                                                        m.num_bin)
        else:
            with np.errstate(invalid="ignore"):
                out[:, f] = m.value_to_bin(col)
    return out.astype(np.uint8)


def _plain(X, t):
    return tb.bucketize_plain(torch.from_numpy(X),
                              tb.upload_bin_table(t, "cpu")).numpy()


def _assert_tables_equal(tj, tt):
    assert (tj.num_features, tj.B, tj.mode) == (tt.num_features, tt.B,
                                                 tt.mode)
    for a in ("table", "cat_val", "meta"):
        np.testing.assert_array_equal(getattr(tj, a), getattr(tt, a),
                                      err_msg=a)


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("opts,missing_type", [
    ({}, 2), ({"zero_as_missing": True}, 1), ({"use_missing": False}, 0)],
    ids=["nan", "zero", "none"])
def test_pack_bin_table_equals_jax(mode, opts, missing_type):
    jm, tm = _mappers(3, **opts)
    assert missing_type in {m.missing_type for m in tm
                            if m.bin_type != J_CAT}
    used = [0, 2, 3, 5] if mode == "serve" else None
    # an inert column: a None hole (serve) or an unused feature
    jl, tl = list(jm), list(tm)
    if mode == "serve":
        jl[4] = tl[4] = None
    tj = jb.pack_bin_table(jl, mode=mode, used_features=used)
    tt = tb.pack_bin_table(tl, mode=mode, used_features=used)
    _assert_tables_equal(tj, tt)


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("max_bin", [15, 63, 255])
def test_plain_equals_xla_and_host(mode, max_bin):
    jm, tm = _mappers(max_bin, max_bin=max_bin)
    used = [0, 1, 3, 5] if mode == "serve" else None
    tj = jb.pack_bin_table(jm, mode=mode, used_features=used)
    tt = tb.pack_bin_table(tm, mode=mode, used_features=used)
    X = _probe(np.random.RandomState(max_bin + 1), jm)
    got = _plain(X, tt)
    np.testing.assert_array_equal(got, _host_bins(jm, X, mode, used))
    xla = np.array(jb.bucketize_rows(X, tj, impl="xla"))
    if mode == "serve":
        # the XLA lowering's +inf categorical lands on a lifted pad lane
        inf_cat = np.isposinf(X[:, 5])
        assert (xla[inf_cat, 5] == 0).all() and \
            (got[inf_cat, 5] == jm[5].num_bin).all()
        xla[inf_cat, 5] = got[inf_cat, 5]
    np.testing.assert_array_equal(got, xla)


@pytest.mark.parametrize("mode", ["train", "serve"])
def test_plain_equals_pallas_interpret(mode, monkeypatch):
    monkeypatch.setenv(INTERP, "1")
    jm, tm = _mappers(7)
    used = [1, 2, 5] if mode == "serve" else None
    tj = jb.pack_bin_table(jm, mode=mode, used_features=used)
    tt = tb.pack_bin_table(tm, mode=mode, used_features=used)
    X = _probe(np.random.RandomState(8), jm, n=300)
    ref = np.asarray(jb.bucketize_rows(X, tj, impl="pallas"))
    np.testing.assert_array_equal(_plain(X, tt), ref)


def test_max_bin_255_nan_bin_is_256():
    """max_bin=255 + the NaN bin -> num_bin == 256: the uint8 top bin."""
    rng = np.random.RandomState(5)
    v = np.unique(rng.normal(size=4000)).astype(np.float64)[:3000]
    v = np.concatenate([v, [np.nan] * 50])
    m = JBinMapper.find_bin(v, len(v), 256, 1, 2)
    assert m.num_bin == 256
    tt = tb.pack_bin_table([TBinMapper.from_dict(m.to_dict())])
    q = np.concatenate([v[:500], [np.nan, 0.0, -0.0, 1e30, -1e30]])
    q = q.astype(np.float32)[:, None]
    ref = m.value_to_bin(np.asarray(q[:, 0], np.float64))
    np.testing.assert_array_equal(_plain(q, tt)[:, 0], ref.astype(np.uint8))


def test_binning_unavailable():
    rng = np.random.RandomState(2)
    # a numeric mapper past 256 bins
    wide = JBinMapper.find_bin(rng.normal(size=5000), 5000, 400, 1, 2)
    assert wide.num_bin > 256
    with pytest.raises(tb.BinningUnavailable, match="overflow uint8"):
        tb.pack_bin_table([TBinMapper.from_dict(wide.to_dict())])
    # 256 categories: the train cap, one past the serve cap
    cats = np.repeat(np.arange(256, dtype=np.float64), 20)
    cm = TBinMapper.from_dict(JBinMapper.find_bin(
        cats, len(cats), 400, 1, 2, bin_type=J_CAT).to_dict())
    assert cm.num_bin == 256
    tb.pack_bin_table([cm], mode="train")
    with pytest.raises(tb.BinningUnavailable, match="serve cap"):
        tb.pack_bin_table([cm], mode="serve")
    # a key that is not f32-exact
    big = np.repeat(np.array([1.0, 2.0 ** 24 + 1]), 50)
    km = TBinMapper.from_dict(JBinMapper.find_bin(
        big, len(big), 255, 1, 2, bin_type=J_CAT).to_dict())
    with pytest.raises(tb.BinningUnavailable, match="f32-exact"):
        tb.pack_bin_table([km])
    with pytest.raises(ValueError, match="mode"):
        tb.pack_bin_table([km], mode="fast")


def test_resolve_binning_impl():
    assert tb.resolve_binning_impl("auto", torch.device("cpu")) == "host"
    assert tb.resolve_binning_impl("auto", torch.device("cuda", 0)) \
        == "device"
    for knob in ("host", "device"):
        assert tb.resolve_binning_impl(knob, torch.device("cpu")) == knob
    with pytest.raises(ValueError):
        tb.resolve_binning_impl("gpu", torch.device("cpu"))


def test_bin_rows_device_selects_columns_and_writes_feature_major():
    """The ingest entry point: raw columns picked by `cols` without a host
    copy, chunked rows, the feature-major result."""
    jm, tm = _mappers(11)
    X = _probe(np.random.RandomState(12), jm, n=1000)
    wide = np.concatenate([np.ones((1000, 2), np.float32), X[:, ::-1]],
                          axis=1)
    cols = [2 + (len(jm) - 1 - f) for f in range(len(jm))]
    tt = tb.pack_bin_table(tm)
    X_t = tb.bin_rows_device(wide, tt, torch.device("cpu"), cols=cols,
                             chunk=300)
    assert X_t.shape == (len(jm), 1000) and X_t.dtype == torch.uint8
    np.testing.assert_array_equal(X_t.numpy().T, _host_bins(jm, X, "train"))


def test_kernel_wrapper_refuses_cpu_tensors():
    jm, tm = _mappers(1)
    tt = tb.upload_bin_table(tb.pack_bin_table(tm), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tb.bucketize_cuda(torch.zeros((4, len(tm))), tt)


# ---------------------------------------------------------------------------
# the redesigned kernel's host-side pieces: the per-row search depth in the
# uploaded meta rows, the search it bounds, and the launch planner
# ---------------------------------------------------------------------------
def _synthetic_style_mappers(seed, F=8):
    """chip_smoke's synthetic table in small: every fourth feature
    categorical, the others numeric with NaN-missing, zero-missing or no
    missing type at max_bin 63 or 255."""
    rng = np.random.RandomState(seed)
    n = 3000
    out = []
    for f in range(F):
        if f % 4 == 3:
            fit = rng.randint(-3, 60, size=n).astype(np.float64)
            m = JBinMapper.find_bin(fit, n, 255, 3, 20, bin_type=J_CAT)
        else:
            m = JBinMapper.find_bin(_edge_col(rng, n).astype(np.float64), n,
                                    63 if f % 2 else 255, 3, 20,
                                    zero_as_missing=f % 4 == 1,
                                    use_missing=f % 8 != 6)
        out.append(m)
    return out, [TBinMapper.from_dict(m.to_dict()) for m in out]


def _table_cases():
    jm, tm = _mappers(13)
    sj, st = _synthetic_style_mappers(14)
    used = [0, 2, 3, 5]
    return [("train", jm, tb.pack_bin_table(tm, mode="train"), None),
            ("serve", jm, tb.pack_bin_table(tm, mode="serve",
                                            used_features=used), used),
            ("synthetic", sj, tb.pack_bin_table(st, mode="serve"), None)]


def _searchable(m, f, used):
    """The lanes a feature's search covers, from its mapper: its keys, or
    its finite upper bounds (the +inf last bound and the NaN bin's are
    not searched); none for an unused feature."""
    if used is not None and f not in used:
        return 0
    if m.bin_type == J_CAT:
        return len(m.categorical_2_bin)
    ub = np.asarray(m.bin_upper_bound, np.float64)
    return int(np.sum(ub < np.inf))


@pytest.mark.parametrize("case", range(3), ids=["train", "serve",
                                                  "synthetic"])
def test_search_depth_in_meta_rows(case):
    """upload_bin_table writes each row's searchable lanes (column 7) and
    the depth of the kernel's search (column 6): ceil(log2(n + 1)) for the
    largest of the row's grid buckets, at most ceil(log2(count + 1)), the
    depth of a search over the whole row, which a row whose bounds span no
    range (one bucket) takes; the packed numpy table itself stays the JAX
    package's."""
    name, jm, t, used = _table_cases()[case]
    tt = tb.upload_bin_table(t, "cpu")
    meta, grids = tt.meta.numpy(), tt.grids.numpy()
    np.testing.assert_array_equal(meta[:, :6], t.meta[:t.num_features, :6])
    shallower = 0
    for f, m in enumerate(jm):
        cnt = _searchable(m, f, used)
        full = math.ceil(math.log2(cnt + 1)) if cnt else 0
        assert meta[f, 7] == cnt, (name, f)
        g = grids[f, 2:]
        sizes = (g >> 16) - (g & 0xFFFF)
        assert sizes.sum() == cnt
        largest = int(sizes.max())
        assert meta[f, 6] == (math.ceil(math.log2(largest + 1))
                              if largest else 0)
        assert meta[f, 6] <= full
        if grids[f, 1] == 0:                       # scale 0: one bucket
            assert meta[f, 6] == full
        shallower += meta[f, 6] < full
    assert shallower >= len(jm) // 2


def _kernel_search(X, tt):
    """numpy transcription of csrc/bucketize.cu's search: a key's bucket
    on its row's grid, then a lower-bound search of `depth` probes among
    that bucket's bounds; a categorical key is present iff the lane at
    its count equals it."""
    tab, cv, m = (a.numpy() for a in (tt.table, tt.cat_val, tt.meta))
    grids = tt.grids.numpy()
    nb = grids.shape[1] - 2
    out = np.zeros(X.shape, np.uint8)
    for f in range(tab.shape[0]):
        v = X[:, f]
        nan = np.isnan(v)
        is_cat = m[f, 0] > 0
        if is_cat:
            with np.errstate(invalid="ignore"):
                q = np.where(nan, m[f, 3], np.trunc(v)).astype(np.float32)
                q = np.where((v < 0) & (m[f, 5] > 0), np.float32(-2.0), q)
        else:
            q = v
        lo, scale = grids[f, :2].view(np.float32)
        g = grids[f, 2:][tb.grid_buckets(q, lo, scale, nb)]
        p, e = (g & 0xFFFF).astype(np.int64), (g >> 16).astype(np.int64)
        depth, cnt = int(m[f, 6]), int(m[f, 7])
        step = 1 << (depth - 1) if depth else 0
        while step:
            c = np.minimum(p + step, e)
            with np.errstate(invalid="ignore"):
                p = np.where(tab[f, np.maximum(c - 1, p)] < q, c, p)
            step >>= 1
        if is_cat:
            hit = (p < cnt) & (tab[f, np.minimum(p, tab.shape[1] - 1)] == q)
            out[:, f] = np.where(hit, cv[f, np.minimum(p, cv.shape[1] - 1)],
                                 m[f, 4]).astype(np.uint8)
        else:
            out[:, f] = np.where(nan, m[f, 2],
                                 np.minimum(p, m[f, 1])).astype(np.uint8)
    return out


def test_grid_buckets_are_monotone():
    """The bucket function is monotone in f32, the property the grid's
    partition of the bounds rests on: over the probe values (NaN aside)
    and every row's grid, a larger value never lands in a smaller
    bucket."""
    _, jm, t, _ = _table_cases()[2]
    tt = tb.upload_bin_table(t, "cpu")
    X = _probe(np.random.RandomState(16), jm, n=600)
    v = np.sort(X[~np.isnan(X)].astype(np.float32))
    grids = tt.grids.numpy()
    for f in range(grids.shape[0]):
        lo, scale = grids[f, :2].view(np.float32)
        b = tb.grid_buckets(v, lo, scale, grids.shape[1] - 2)
        assert (np.diff(b) >= 0).all()


@pytest.mark.parametrize("case", range(3), ids=["train", "serve",
                                                  "synthetic"])
def test_depth_bounded_search_equals_plain(case):
    """The kernel's search, a grid bucket and a few probes, bins the probe
    rows (every bound and one ulp either side, NaN, +-0, subnormals,
    +-inf, unseen and negative categories) as the plain version does."""
    name, jm, t, _ = _table_cases()[case]
    tt = tb.upload_bin_table(t, "cpu")
    X = _probe(np.random.RandomState(15 + case), jm, n=600)
    np.testing.assert_array_equal(_kernel_search(X, tt), _plain(X, t),
                                  err_msg=name)


@pytest.mark.parametrize("n,F,B,want", [
    (1 << 20, 28, 128, (28, 1, 528)),    # ingest: the train table
    (1 << 18, 28, 128, (28, 1, 528)),    # an ingest chunk
    (256, 28, 128, (4, 7, 14)),          # the served bucket of 256 rows
    (8, 28, 128, (4, 7, 7)),             # the smallest served bucket
    (1 << 20, 28, 256, (14, 2, 660)),    # the synthetic table's lanes
    (1 << 20, 39, 256, (13, 3, 660)),    # the Criteo schema
])
def test_bucketize_planner(n, F, B, want):
    """The launch of kernel #6 on an H100's 132 SMs, grids of B buckets:
    feature groups of at most 32 whose tables let four blocks share an
    SM, cut to 4 features for served chunks so that a chunk spreads over
    blocks; a grid of the blocks that fit, a multiple of the groups, at
    most one block per row tile and group."""
    p = tb.plan_bucketize(n, F, B, B, 132)
    assert (p.group, p.groups, p.grid) == want
    assert p.group <= 32 and p.groups * p.group >= F
    assert (p.groups - 1) * p.group < F
    assert p.grid % p.groups == 0
    assert p.grid // p.groups <= -(-n // 128)
    assert p.smem == tb._smem_bytes(p.group, B, B)
    assert p.group <= 4 or p.smem + 1024 <= 228 * 1024 // 4
    per_sm = (228 * 1024) // (p.smem + 1024)
    assert p.grid <= 132 * min(per_sm, 8)
