"""Streaming Datasets and warm_continue in the port against the JAX package
on the CPU: `init_streaming` / `push_rows` / `mark_finished` bin each chunk
against a frozen reference, on the host (`value_to_bin`) or, for f32
chunks under `binning_impl=device`, through #6's plain version into the
chunk's columns of `X_t`. Held to the JAX package's streamed Dataset on
the same seeded rows: `X_binned` bitwise (in order and with `start_row`
out of order), `X_t` its transpose, label / weight / init_score, no EFB
bundles, the same fatal messages, uint16 storage past 256 bins, and the
schema signature. `engine.warm_continue` on a regression with labels on a
1/64 grid grows the JAX package's tree structures, raw predictions within
1e-5 (the JAX search sums in f32, the port in f64: ROADMAP C note 9)."""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
from lightgbm_tpu.engine import warm_continue as jax_warm_continue
from lightgbm_tpu.utils.log import FatalError as JaxFatalError
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.engine import warm_continue
from lightgbm_tpu_torch.utils.log import FatalError

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

N_BASE, N_STREAM, N_COLS = 1200, 1200, 6
PARAMS = dict(objective="regression", num_leaves=7, min_data_in_leaf=5,
              learning_rate=0.2, seed=3, verbose=-1)
TORCH = {"device_type": "cpu"}


def _rows(n, seed):
    """Rows with NaN in column 2 and a categorical column 4 (6 levels);
    labels on a 1/64 grid."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, N_COLS)
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[:, 4] = rng.randint(0, 6, n)
    y = np.round((X[:, 0] + X[:, 1] + (X[:, 4] == 2)) * 32) / 64
    return X, y


XB, YB = _rows(N_BASE, 0)
XS, YS = _rows(N_STREAM, 1)
WS = np.round(np.linspace(0.5, 2.0, N_STREAM), 3)
ISC = np.linspace(-0.25, 0.25, N_STREAM)


def _base(mod, params, **extra):
    p = dict(PARAMS, **params, **extra)
    return mod.Dataset(XB, label=YB, params=p, categorical_feature=[4],
                       free_raw_data=False).construct()


@pytest.fixture(scope="module")
def refs():
    return _base(lt, TORCH), _base(lj, {})


def _stream(mod, params, ref, X, chunks, n=N_STREAM):
    """Push `chunks` ((lo, hi) row ranges, in push order) of X with their
    labels, weights and init scores, each at its start_row."""
    ds = mod.Dataset(None, params=dict(PARAMS, **params))
    ds.init_streaming(n, reference=ref)
    for lo, hi in chunks:
        ds.push_rows(X[lo:hi], label=YS[lo:hi], weight=WS[lo:hi],
                     init_score=ISC[lo:hi], start_row=lo)
    return ds


IN_ORDER = [(0, 400), (400, 900), (900, 1200)]
OUT_OF_ORDER = [(900, 1200), (0, 400), (400, 900)]


@pytest.mark.parametrize("order", ["in_order", "out_of_order"])
@pytest.mark.parametrize("route", ["host_f64", "device_f32"])
def test_streamed_bins_equal_jax(refs, order, route):
    chunks = IN_ORDER if order == "in_order" else OUT_OF_ORDER
    X = XS.astype(np.float32) if route == "device_f32" else XS
    tparams = dict(TORCH, binning_impl="device" if route == "device_f32"
                   else "auto")
    dt = _stream(lt, tparams, refs[0], X, chunks).mark_finished()
    dj = _stream(lj, {}, refs[1], X, chunks).mark_finished()
    ht, hj = dt._handle, dj._handle
    assert ht.binning_route == route.split("_")[0]
    assert ht.X_binned.dtype == hj.X_binned.dtype == np.uint8
    assert np.array_equal(ht.X_binned, hj.X_binned)
    assert np.array_equal(ht.X_t.numpy(), ht.X_binned.T)
    for k in ("label", "weight", "init_score"):
        assert np.array_equal(getattr(ht.metadata, k),
                              getattr(hj.metadata, k)), k
    assert ht.bundles is None and hj.bundles is None
    assert ht.schema_signature() == hj.schema_signature() \
        == refs[1]._handle.schema_signature()


def test_stream_equals_bulk_reference_and_short_fill(refs):
    """A full f32 stream equals the bulk `Dataset(X, reference=...)` in
    both copies; a short fill warns, and its unpushed rows keep bin 0 and
    label 0 in both copies, as in the JAX package."""
    X32 = XS.astype(np.float32)
    dev = dict(TORCH, binning_impl="device")
    full = _stream(lt, dev, refs[0], X32, OUT_OF_ORDER).mark_finished()
    bulk = lt.Dataset(X32, label=YS, reference=refs[0],
                      params=dict(PARAMS, **dev)).construct()
    assert bulk._handle.binning_route == "device"
    assert np.array_equal(full._handle.X_binned, bulk._handle.X_binned)
    assert torch.equal(full._handle.X_t, bulk._handle.X_t)
    short_t = _stream(lt, TORCH, refs[0], XS, [(0, 250)], n=400)
    short_j = _stream(lj, {}, refs[1], XS, [(0, 250)], n=400)
    ht, hj = short_t.mark_finished()._handle, short_j.mark_finished()._handle
    assert np.array_equal(ht.X_binned, hj.X_binned)
    assert not ht.X_binned[250:].any() and not ht.X_t[:, 250:].any()
    assert np.array_equal(ht.metadata.label, hj.metadata.label)
    assert not ht.metadata.label[250:].any()


def _fatal(mod, case, ref):
    ds = mod.Dataset(None, params=dict(PARAMS, **(
        TORCH if mod is lt else {})))
    if case == "no_reference":
        ds.init_streaming(10)
    elif case == "push_before_init":
        ds.push_rows(XS[:5])
    elif case == "finish_before_init":
        ds.mark_finished()
    elif case == "overflow":
        ds.init_streaming(10, reference=ref)
        ds.push_rows(XS[:6])
        ds.push_rows(XS[:6])
    elif case == "overflow_start_row":
        ds.init_streaming(10, reference=ref)
        ds.push_rows(XS[:4], start_row=8)


@pytest.mark.parametrize("case", ["no_reference", "push_before_init",
                                  "finish_before_init", "overflow",
                                  "overflow_start_row"])
def test_fatal_errors_match_jax(refs, case):
    with pytest.raises(FatalError) as et:
        _fatal(lt, case, refs[0])
    with pytest.raises(JaxFatalError) as ej:
        _fatal(lj, case, refs[1])
    assert str(et.value) == str(ej.value)


def test_device_binning_refuses_f64(refs):
    """binning_impl=device bins f32 rows; an f64 chunk raises, as the
    matrix path does, instead of taking the host route unasked."""
    ds = lt.Dataset(None, params=dict(PARAMS, **TORCH,
                                      binning_impl="device"))
    ds.init_streaming(N_STREAM, reference=refs[0])
    with pytest.raises(ValueError, match="float32"):
        ds.push_rows(XS[:10])


def test_wide_bins_stream_uint16():
    """A max_bin=511 reference stores uint16 bins: the f32 chunks take the
    host route (#6's table holds 256 lanes) and equal the JAX package's
    bins; X_t is uint16."""
    rng = np.random.RandomState(5)
    Xb, Xs = rng.normal(size=(3000, 3)), rng.normal(size=(500, 3))
    Xs = Xs.astype(np.float32)
    rt = lt.Dataset(Xb, params=dict(PARAMS, max_bin=511, **TORCH)).construct()
    rj = lj.Dataset(Xb, params=dict(PARAMS, max_bin=511)).construct()
    dt = lt.Dataset(None, params=dict(PARAMS, max_bin=511, **TORCH))
    dt.init_streaming(500, reference=rt)
    dj = lj.Dataset(None, params=dict(PARAMS, max_bin=511))
    dj.init_streaming(500, reference=rj)
    for lo, hi in ((300, 500), (0, 300)):
        dt.push_rows(Xs[lo:hi], start_row=lo)
        dj.push_rows(Xs[lo:hi], start_row=lo)
    ht = dt.mark_finished()._handle
    assert ht.binning_route == "host"
    assert ht.X_binned.dtype == np.uint16 and ht.X_t.dtype == torch.uint16
    assert int(ht.X_binned.max()) > 255
    assert np.array_equal(ht.X_binned, dj.mark_finished()._handle.X_binned)
    assert np.array_equal(ht.X_t.view(torch.int16).numpy().view(np.uint16),
                          ht.X_binned.T)


def _blocks(text):
    body = text.split("end of trees")[0]
    return [dict(ln.split("=", 1) for ln in blk.splitlines()[1:] if "=" in ln)
            for blk in body.split("Tree=")[1:]]


def _same_structures(ta, tb):
    ba, bb = _blocks(ta), _blocks(tb)
    assert len(ba) == len(bb)
    for a, b in zip(ba, bb):
        for k in ("num_leaves", "num_cat", "split_feature", "threshold",
                  "left_child", "right_child", "cat_boundaries",
                  "cat_threshold"):
            assert a.get(k) == b.get(k), k


def test_warm_continue_matches_jax(refs):
    """Three trees boosted onto a 5-tree model on streamed rows (the base
    rows' count, so the JAX package reuses its compiled grower): the JAX
    package's structures, raw predictions within 1e-5. f32 rows stay f32,
    binned through #6's plain version under binning_impl=device, and give
    the model bytes of their f64 copy on the host route."""
    bt = lt.train(dict(PARAMS, **TORCH), refs[0], 5)
    bj = lj.train(dict(PARAMS), refs[1], 5)
    ct = warm_continue(dict(PARAMS, **TORCH), XS, YS, 3, bt, refs[0],
                       weight=WS)
    cj = jax_warm_continue(dict(PARAMS), XS, YS, 3, bj, refs[1], weight=WS)
    assert ct.num_trees() == cj.num_trees() == 8
    assert ct.train_set._handle.binning_route == "host"
    _same_structures(ct.model_to_string(), cj.model_to_string())
    np.testing.assert_allclose(ct.predict(XB, raw_score=True),
                               cj.predict(XB, raw_score=True), atol=1e-5)
    X32 = XS.astype(np.float32)
    dev = dict(PARAMS, **TORCH, binning_impl="device")
    c32 = warm_continue(dev, X32, YS, 3, bt, refs[0], weight=WS)
    c64 = warm_continue(dict(PARAMS, **TORCH), X32.astype(np.float64), YS,
                        3, bt, refs[0], weight=WS)
    assert c32.train_set._handle.binning_route == "device"
    assert np.array_equal(c32.train_set._handle.X_binned,
                          c64.train_set._handle.X_binned)
    assert c32.model_to_string() == c64.model_to_string().replace(
        "[binning_impl: auto]", "[binning_impl: device]")
