"""Cross-tenant forest fusion in the port (lightgbm_tpu_torch/export/
fusion.py) and its stacked bucketize (ops/bucketize.py) on the CPU, where
the stacked kernel's plain version runs, against the port's own
per-tenant paths and against the JAX package.

Each tenant is built in both packages from the same model text and the
same bin mappers. Tolerances:
  * bins (stacked, per tenant, JAX's bucketize_rows_stacked): bitwise;
  * FusedScorer.score_groups against each tenant's own engine="binned"
    session: bitwise (the fused walk reaches the same leaves, and
    ops/predict.py sum_iterations folds a tenant's -0.0 tail exactly);
  * against JAX's FusedScorer.score_groups: rtol 1e-6 (f32 leaf values
    summed in another order).
"""

import hashlib

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
from lightgbm_tpu.data.binning import BinMapper as JBinMapper
from lightgbm_tpu.export import FusedScorer as JFusedScorer
from lightgbm_tpu.ops import bucketize as jb
from lightgbm_tpu.serving import ServingSession as JSession
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.export import FusedForest, FusedScorer
from lightgbm_tpu_torch.export.fusion import (predict_leaves_fused,
                                              predict_margin_fused)
from lightgbm_tpu_torch.ops import bucketize as tb
from lightgbm_tpu_torch.ops.predict import sum_iterations
from lightgbm_tpu_torch.ops.predict_binned import (mappers_for,
                                                   predict_leaves_binned)
from lightgbm_tpu_torch.serving import ServingSession

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

N = 600
CPU = {"device_type": "cpu", "verbose": -1}


def _md5(a) -> str:
    return hashlib.md5(np.ascontiguousarray(np.asarray(a))
                       .tobytes()).hexdigest()


def _train(seed, cols, objective, rounds, cat=(), **params):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N, cols))
    for c in cat:
        X[:, c] = rng.randint(0, 12, size=N)
    X[rng.rand(N, cols) < 0.05] = np.nan
    x0 = np.nan_to_num(X[:, 0])
    if objective == "multiclass":
        y = (x0 > 0).astype(int) + (np.nan_to_num(X[:, 1]) > 0.5)
        params["num_class"] = 3
    elif objective == "binary":
        y = (x0 + np.nan_to_num(X[:, 1]) > 0).astype(float)
    else:
        y = 2 * x0 + np.where(np.isin(X[:, cat[0]], (1, 4, 7)), 3.0, 0.0) \
            if cat else 2 * x0
    p = dict(objective=objective, num_leaves=12, min_data_in_leaf=5,
             max_bin=63, **CPU, **params)
    if cat:
        p["categorical_feature"] = list(cat)
    return lt.train(p, lt.Dataset(X, label=y), num_boost_round=rounds)


def _both(bst):
    """(port Booster, JAX Booster, port mappers, JAX mappers) of one
    tenant: both packages' boosters from the same model text, both
    mapper lists from the same mapper dicts."""
    text = bst.model_to_string()
    tm = mappers_for(bst._gbdt)
    jm = [None if m is None else JBinMapper.from_dict(m.to_dict())
          for m in tm]
    return (lt.Booster(params=CPU, model_str=text),
            lj.Booster(model_str=text), tm, jm)


def _with_warnings(fn):
    """(fn(), the log lines it wrote, warnings included)."""
    from lightgbm_tpu_torch.utils import log as tlog
    logs, prev, verb = [], tlog._logger, tlog._verbosity
    tlog.register_logger(type("L", (), {"info": logs.append,
                                        "warning": logs.append})())
    tlog.set_verbosity(0)
    try:
        out = fn()
    finally:
        tlog.register_logger(prev)
        tlog.set_verbosity(verb)
    return out, logs


@pytest.fixture(scope="module")
def tenants():
    """Heterogeneous on purpose: K 1 / 3, tree counts 6 / 12 / 5, feature
    counts 8 / 5 / 8, numeric, categorical and averaged (rf) forests."""
    return {
        "bin": _both(_train(21, 8, "binary", 6)),
        "mc": _both(_train(22, 5, "multiclass", 4, cat=(2,))),
        "rf": _both(_train(23, 8, "regression", 5, cat=(3,),
                           boosting="rf", bagging_freq=1,
                           bagging_fraction=0.7)),
    }


def _sessions(tenants, **kw):
    return {n: ServingSession(b._gbdt, engine="binned", max_batch=16,
                              bin_mappers=tm, binning_impl="device", **kw)
            for n, (b, _, tm, _) in tenants.items()}


def _queries(seed, tenants):
    """Per tenant rows over the edges: NaN and +-inf numerics; NaN,
    negative, fractional, unseen and +inf categories."""
    rng = np.random.RandomState(seed)
    qs = {}
    for n, (b, _, _, _) in tenants.items():
        F = b.num_feature()
        q = rng.normal(scale=2.0, size=(7, F))
        q[rng.rand(7, F) < 0.1] = np.nan
        q[0, 0], q[1, 0] = np.inf, -np.inf
        for c in {"mc": (2,), "rf": (3,)}.get(n, ()):
            q[:, c] = [np.nan, -1.0, 2.7, 99.0, np.inf, 4.0, 7.0]
        qs[n] = q
    return qs


def test_sum_iterations_folds_a_negative_zero_tail():
    """A -0.0 tail of any length and any batch size leave a row's sum the
    same bits (the fused walk pads short tenants so)."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.normal(size=(9, 11, 3)).astype(np.float32))
    x[0, :, 0] = -0.0
    want = sum_iterations(x)
    for tail in (1, 5, 21):
        pad = torch.zeros((9, tail, 3)).neg()
        got = sum_iterations(torch.cat([x, pad], dim=1))
        assert _md5(got.numpy()) == _md5(want.numpy())
    assert _md5(sum_iterations(x[2:5]).numpy()) == _md5(want[2:5].numpy())
    np.testing.assert_allclose(want.numpy(), x.sum(1).numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("iters", [1, 2, 3, 5, 8, 13, 31, 33])
def test_sum_iterations_is_the_padded_pairwise_tree(iters):
    """The first level that carries the odd iterations gives the bits of
    the tree over an explicit -0.0 padding to a power of two."""
    rng = np.random.RandomState(iters)
    x = torch.from_numpy(rng.normal(size=(7, iters, 2)).astype(np.float32))
    x[1, :, 1] = -0.0
    P = 1 << (iters - 1).bit_length()
    ref = torch.cat([x, torch.zeros((7, P - iters, 2)).neg()], dim=1)
    while ref.shape[1] > 1:
        ref = ref[:, :ref.shape[1] // 2] + ref[:, ref.shape[1] // 2:]
    assert _md5(sum_iterations(x).numpy()) == _md5(ref[:, 0].numpy())


def test_stacked_bins_bitwise_per_tenant_and_jax(tenants):
    """Stacked bins of a mixed batch == each tenant's own bucketize_plain
    bins == JAX's bucketize_rows_stacked, NaN / negative / unseen / +inf
    categories included; a row with an invalid tenant id bins to 0."""
    sessions = _sessions(tenants)
    jsess = {n: JSession(jbst._gbdt, engine="binned", max_batch=16,
                         bin_mappers=jm)
             for n, (_, jbst, _, jm) in tenants.items()}
    names = list(tenants)
    tables = [sessions[n]._bin_table for n in names]
    st = tb.upload_stacked_table(tb.stack_bin_tables(tables),
                                 torch.device("cpu"))
    jtables = [jb.pack_bin_table(jsess[n]._bm._mappers, mode="serve",
                                 num_features=jsess[n]._bm.num_features,
                                 used_features=jsess[n]._bm.used_features)
               for n in names]
    jst = jb.stack_bin_tables(jtables)
    np.testing.assert_array_equal(jst.table, tb.stack_bin_tables(
        tables).table)
    qs = _queries(3, tenants)
    rows, tids = [], []
    for i in range(7):                        # interleave the tenants
        for c, n in enumerate(names):
            q = np.zeros(st.num_features, np.float32)
            q[:qs[n].shape[1]] = qs[n][i]
            rows.append(q)
            tids.append(c)
    X = np.stack(rows)
    tid = np.asarray(tids, np.int32)
    got = tb.bucketize_rows_stacked(torch.from_numpy(X),
                                    torch.from_numpy(tid), st).numpy()
    for c, n in enumerate(names):
        s = sessions[n]
        own = tb.bucketize_plain(torch.from_numpy(X[tid == c]),
                                 s._bin_tensors).numpy()
        F = s._bm.num_features
        np.testing.assert_array_equal(got[tid == c, :F], own)
        assert (got[tid == c, F:] == 0).all()
        # and the host bin_rows of the f64 values
        np.testing.assert_array_equal(
            own, s._bm.bin_rows(X[tid == c, :F].astype(np.float64)))
    want = np.asarray(jb.bucketize_rows_stacked(X, jst, tid))
    np.testing.assert_array_equal(got, want)
    bad = tid.copy()
    bad[:2] = (-1, len(names))
    got_bad = tb.bucketize_rows_stacked(torch.from_numpy(X),
                                        torch.from_numpy(bad), st).numpy()
    assert (got_bad[:2] == 0).all()
    np.testing.assert_array_equal(got_bad[2:], got[2:])


def test_fused_walk_reaches_each_tenants_leaves(tenants):
    """predict_leaves_fused of a mixed batch lands every row on the leaves
    its tenant's own walk reaches (offset into the flat leaf table); the
    padded tree slots reach the shared zero leaf."""
    sessions = _sessions(tenants)
    forest = FusedForest({n: s._bm for n, s in sessions.items()})
    fa = forest.device_arrays(torch.device("cpu"))
    qs = _queries(4, tenants)
    Xb = np.zeros((21, forest.Fmax), np.uint8)
    tid = np.repeat(np.arange(3, dtype=np.int32), 7)
    for c, n in enumerate(forest.names):
        bm = sessions[n]._bm
        Xb[tid == c, :bm.num_features] = bm.bin_rows(qs[n])
    gl = predict_leaves_fused(fa, torch.from_numpy(Xb),
                              torch.from_numpy(tid)).numpy()
    off = 0
    for c, n in enumerate(forest.names):
        bm = sessions[n]._bm
        own = predict_leaves_binned(
            bm.device_arrays(torch.device("cpu")),
            torch.from_numpy(bm.bin_rows(qs[n]))).numpy()
        np.testing.assert_array_equal(gl[tid == c, :bm.T], own + off)
        assert (gl[tid == c, bm.T:] == len(forest.leaf_value) - 1).all()
        off += len(bm.leaf_value)
    m = predict_margin_fused(fa, torch.from_numpy(Xb),
                             torch.from_numpy(tid))
    assert tuple(m.shape) == (forest.Kmax, 21)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_scorer_bitwise_each_binned_session(tenants, dtype):
    """One fused walk over interleaved heterogeneous tenant groups ==
    each tenant's own binned session, bit for bit, a tenant twice in one
    batch included; f32 groups take the stacked bucketize."""
    sessions = _sessions(tenants)
    scorer = FusedScorer(sessions, max_batch=16)
    assert scorer._stacked is not None
    assert all(scorer.can_serve(n) for n in tenants)
    assert scorer.K_of("mc") == 3 and scorer.K_of("bin") == 1
    qs = {n: q.astype(dtype) for n, q in _queries(5, tenants).items()}
    for groups in ([("mc", qs["mc"][:5]), ("bin", qs["bin"][:4]),
                    ("rf", qs["rf"][:5]), ("bin", qs["bin"][4:6])],
                   [("rf", qs["rf"])]):
        outs = scorer.score_groups(groups)
        for (n, X), margins in zip(groups, outs):
            assert _md5(margins) == _md5(sessions[n].score_margin(X)), n


def test_fused_scorer_within_1e6_of_jax(tenants):
    """The same mixed batch through JAX's FusedScorer, built from the same
    model text and mappers: rtol 1e-6."""
    sessions = _sessions(tenants)
    jsess = {n: JSession(jbst._gbdt, engine="binned", max_batch=16,
                         bin_mappers=jm)
             for n, (_, jbst, _, jm) in tenants.items()}
    scorer = FusedScorer(sessions, max_batch=16)
    jscorer = JFusedScorer(jsess, max_batch=16)
    qs = _queries(6, tenants)
    groups = [("rf", qs["rf"][:4]), ("mc", qs["mc"][:6]),
              ("bin", qs["bin"][:6])]
    for got, want in zip(scorer.score_groups(groups),
                         jscorer.score_groups(groups)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_fused_scorer_refusals(tenants):
    sessions = _sessions(tenants)
    # num_shards=2 on one device: rounded to 1 with the JAX package's
    # warning, bitwise the unsharded scorer
    sh, logs = _with_warnings(lambda: FusedScorer(sessions, num_shards=2))
    assert sh.num_shards == 0
    assert any("fused num_shards=2 rounded to 1 (power of two, 1 devices)"
               in m for m in logs), logs
    qs = _queries(7, tenants)
    groups = [("mc", qs["mc"][:5]), ("bin", qs["bin"][:4])]
    for got, want in zip(sh.score_groups(groups),
                         FusedScorer(sessions).score_groups(groups)):
        assert _md5(got) == _md5(want)
    with pytest.raises(ValueError, match="at least one tenant"):
        FusedForest({})
