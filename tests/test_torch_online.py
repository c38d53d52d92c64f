"""The online loop in the port (online/: sources, OnlineTrainer,
SnapshotPublisher; cli.py task=online) on the CPU, the cases of the JAX
package's tests/test_online.py and tests/test_online_sources.py.

Within the port the contract is byte parity: every snapshot the loop
publishes is md5-equal to its offline arm on the same window
(`anchor.refit` for a refit, `engine.warm_continue` for a continue), and a
loop killed mid-run (`kill@iter=2`, exit code 17, in a subprocess) or
stopped and resumed in process republishes the same bytes. Against the
JAX package, on the same seeded rows and trace: the `summary()` dicts,
the publish kinds and reasons and the schema signature equal; on labels on
a 1/64 grid (regression), with the JAX package's anchor text as both
loops' anchor, each snapshot's tree structures equal and raw predictions
within 1e-5 (the JAX search sums in f32, the port in f64: ROADMAP C note
9). Around that: sources (slicing, seek, order; Arrow and Sequence), the
bin-compat guard, the row trigger, the staleness watchdog on a fake
clock, the stall_source / corrupt_batch directives, the publisher's modes
and the watcher's floor, a hot swap under live traffic on the binned
engine, and task=online through the CLI."""

import hashlib
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu.online as jo
from lightgbm_tpu.runtime.faults import FaultPlan as JaxFaultPlan
import lightgbm_tpu_torch as lt
import lightgbm_tpu_torch.online as to
from lightgbm_tpu_torch.cli import main as cli_main
from lightgbm_tpu_torch.config import resolve_params
from lightgbm_tpu_torch.engine import warm_continue
from lightgbm_tpu_torch.online import (ArrowSource, CallableSource,
                                       DirectorySource, OnlineTrainer,
                                       SchemaDriftError, SequenceSource,
                                       SnapshotPublisher, TraceSource,
                                       check_batch_schema, open_source,
                                       save_trace)
from lightgbm_tpu_torch.runtime.checkpoint import verify_manifest
from lightgbm_tpu_torch.runtime.faults import FaultPlan
from lightgbm_tpu_torch.serving import (MicroBatcher, ModelRegistry,
                                        ServingMetrics)

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N_COLS = 5
PARAMS = dict(objective="binary", num_leaves=7, min_data_in_leaf=5,
              learning_rate=0.2, seed=3, verbosity=-1, deterministic=True)
TORCH = {"device_type": "cpu"}
# the md5-parity loop: 3 refreshes, the third a continue
LOOP = dict(online_window_rows=400, online_refresh_rows=200,
            online_continue_every=3, online_continue_trees=4)


def _data(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, N_COLS)
    return X, (X[:, 0] + X[:, 1] > 1.0).astype(np.float64)


XB, YB = _data(300, 0)
XS, YS = _data(600, 1)
WS = np.round(np.linspace(1.0, 3.0, 600), 3)


def _md5(b):
    return hashlib.md5(b if isinstance(b, bytes) else b.encode()).hexdigest()


def _md5_file(path):
    with open(path, "rb") as f:
        return _md5(f.read())


def _anchor(text):
    return lt.Booster(params=dict(TORCH), model_str=text)


@pytest.fixture(scope="module")
def base():
    """(params, base Dataset, base model text) of the port."""
    p = dict(PARAMS, **TORCH)
    ds = lt.Dataset(XB, label=YB, params=dict(p), free_raw_data=False)
    return p, ds, lt.train(dict(p), ds, num_boost_round=8).model_to_string()


@pytest.fixture(scope="module")
def trace(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "s.npz")
    save_trace(path, XS, YS, weight=WS, batch_sizes=[100] * 6)
    return path


def _loop(params, text, ds, source, prefix, **kw):
    t = OnlineTrainer(params, text, ds, source,
                      SnapshotPublisher(prefix=prefix, mode="files"), **kw)
    return t, t.run()


def _offline_arms(params, text, ds, X, y, w, cap=400, step=200,
                  every=3, trees=4, n=3):
    """The offline arm of each refresh k: the window of the last `cap` of
    the first step * k rows, refit onto the anchor or (every `every`-th)
    warm-continued, which becomes the anchor."""
    out, anchor = [], text
    for k in range(1, n + 1):
        lo = max(0, step * k - cap)
        sl = slice(lo, step * k)
        ww = None if w is None else w[sl]
        if every and k % every == 0:
            anchor = warm_continue(dict(params), X[sl], y[sl], trees,
                                   _anchor(anchor), ds,
                                   weight=ww).model_to_string()
            out.append(anchor)
        else:
            out.append(_anchor(anchor).refit(
                X[sl], y[sl], decay_rate=0.9, weight=ww).model_to_string())
    return out


# ----------------------------------------------------------------------
# sources and the bin-compat guard
# ----------------------------------------------------------------------
def test_trace_source_slicing_and_seek(tmp_path):
    X, y = _data(100, 1)
    w = np.linspace(1.0, 2.0, 100)
    path = str(tmp_path / "t.npz")
    save_trace(path, X, y, weight=w, batch_sizes=[30, 30, 40])
    src = TraceSource(path)
    assert src.num_batches == 3
    b0 = src.next_batch()
    assert b0.seq == 0 and b0.num_rows == 30 and b0.X.dtype == np.float64
    np.testing.assert_array_equal(b0.X, X[:30])
    np.testing.assert_array_equal(b0.weight, w[:30])
    src.seek(2)
    b2 = src.next_batch()
    assert b2.seq == 2 and b2.num_rows == 40
    np.testing.assert_array_equal(b2.y, y[60:])
    assert src.next_batch() is None and src.exhausted
    assert TraceSource((X, y, None, None), batch_rows=64).num_batches == 2
    assert isinstance(open_source(path), TraceSource)
    with pytest.raises(FileNotFoundError):
        open_source(str(tmp_path / "nope"))


def test_directory_source_tails_in_order(tmp_path):
    d = tmp_path / "drops"
    d.mkdir()
    X, y = _data(60, 1)
    np.savez(d / "b_001.npz", X=X[:20], y=y[:20])
    np.savetxt(d / "a_000.csv", np.column_stack([y[20:40], X[20:40]]),
               delimiter=",")
    src = DirectorySource(str(d))
    first = src.next_batch()          # the csv sorts first, label column 0
    np.testing.assert_allclose(first.X, X[20:40])
    np.testing.assert_allclose(first.y, y[20:40])
    np.testing.assert_array_equal(src.next_batch().X, X[:20])
    assert src.next_batch(timeout_s=0.0) is None and not src.exhausted
    np.savez(d / "c_002.npz", X=X[40:], y=y[40:])    # a late arrival
    np.testing.assert_array_equal(src.next_batch().y, y[40:])
    assert isinstance(open_source(str(d)), DirectorySource)


def test_schema_guard_rejects_drift():
    X, y = _data(10, 1)
    check_batch_schema(X, y, N_COLS)
    ybad = y.copy()
    ybad[3] = np.nan
    for Xb, yb in ((X[:, :3], y), (np.hstack([X, X[:, :1]]), y),
                   (X, y[:5]), (X, ybad), (X[0], y)):
        with pytest.raises(SchemaDriftError):
            check_batch_schema(Xb, yb, N_COLS)


def _matrix(n, seed=42):
    """Column 0 the label (the row index), the rest features."""
    mat = np.random.RandomState(seed).normal(size=(n, 5))
    mat[:, 0] = np.arange(n, dtype=np.float64)
    return mat


def _drain(src):
    out = []
    while True:
        b = src.next_batch(0.0)
        if b is None:
            return out
        out.append(b)


def _table(mat):
    pa = pytest.importorskip("pyarrow")
    return pa.table({f"c{j}": mat[:, j] for j in range(mat.shape[1])})


def test_arrow_table_roundtrip_and_seek():
    mat = _matrix(100)
    batches = _drain(ArrowSource(_table(mat), batch_rows=32))
    assert [b.num_rows for b in batches] == [32, 32, 32, 4]
    assert np.array_equal(np.concatenate([b.X for b in batches]), mat[:, 1:])
    assert np.array_equal(np.concatenate([b.y for b in batches]), mat[:, 0])
    src = ArrowSource(_table(mat), batch_rows=32)
    src.seek(2)
    tail = _drain(src)
    assert [b.seq for b in tail] == [2, 3]
    assert np.array_equal(tail[0].X, batches[2].X)


def test_arrow_stream_weight_column_and_no_seek():
    pytest.importorskip("pyarrow")
    mat = _matrix(60)
    mat[:, 2] = np.random.RandomState(1).rand(60) + 0.5
    src = ArrowSource(iter(_table(mat).to_batches(max_chunksize=20)),
                      weight_column=2)
    batches = _drain(src)
    assert [b.num_rows for b in batches] == [20, 20, 20]
    assert np.array_equal(np.concatenate([b.weight for b in batches]),
                          mat[:, 2])
    assert np.array_equal(np.concatenate([b.X for b in batches]),
                          mat[:, [1, 3, 4]])
    with pytest.raises(NotImplementedError):
        src.seek(1)


class _Rows(lt.Sequence):
    batch_size = 16

    def __init__(self, mat):
        self._mat = mat

    def __len__(self):
        return len(self._mat)

    def __getitem__(self, idx):
        return self._mat[idx]


def test_sequence_source_batching_seek_and_dispatch(tmp_path):
    mat = _matrix(50)
    batches = _drain(SequenceSource(_Rows(mat)))
    assert [b.num_rows for b in batches] == [16, 16, 16, 2]
    assert np.array_equal(np.concatenate([b.X for b in batches]), mat[:, 1:])
    src = SequenceSource(_Rows(mat), batch_rows=20)
    src.seek(2)
    tail = _drain(src)
    assert len(tail) == 1 and np.array_equal(tail[0].y, mat[40:, 0])
    with pytest.raises(TypeError, match="__len__/__getitem__"):
        SequenceSource(object())
    assert isinstance(open_source(_Rows(mat)), SequenceSource)
    assert open_source(src) is src
    with pytest.raises(TypeError, match="not a path"):
        open_source(12345)
    if pytest.importorskip("pyarrow"):
        assert isinstance(open_source(_table(mat)), ArrowSource)


def test_corrupt_batch_directive_on_arrow_source():
    """corrupt_batch widens exactly the named batch, so the guard rejects
    it and passes the rest."""
    src = ArrowSource(_table(_matrix(64)), batch_rows=16,
                      fault_plan=FaultPlan.parse("corrupt_batch@batch=1"))
    ok = bad = 0
    for b in _drain(src):
        try:
            check_batch_schema(b.X, b.y, 4)
            ok += 1
        except SchemaDriftError as e:
            assert "refusing to re-bin" in str(e)
            bad += 1
    assert (ok, bad) == (3, 1) and src.corrupted_batches == 1


# ----------------------------------------------------------------------
# the refresh policy and the fault directives, against the JAX package
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_base():
    ds = lj.Dataset(XB, label=YB, params=dict(PARAMS), free_raw_data=False)
    return ds, lj.train(dict(PARAMS), ds, num_boost_round=8).model_to_string()


def _both_loops(base, jax_base, tmp_path, op, sizes, plan=""):
    """The same trace through the port's loop and the JAX package's:
    (port trainer, port summary, JAX trainer, JAX summary)."""
    params, ds, text = base
    trace = str(tmp_path / "s.npz")
    save_trace(trace, XS[:sum(sizes)], YS[:sum(sizes)], batch_sizes=sizes)
    out = []
    for mod, parse, p, d, t, pre in (
            (to, FaultPlan.parse,
             dict(params, **op), ds, text, "m"),
            (jo, JaxFaultPlan.parse, dict(PARAMS, **op), jax_base[0],
             jax_base[1], "j")):
        fp = parse(plan) if plan else None
        tr = mod.OnlineTrainer(p, t, d, mod.TraceSource(trace, fault_plan=fp),
                               mod.SnapshotPublisher(
                                   prefix=str(tmp_path / pre), mode="files"),
                               fault_plan=fp)
        out += [tr, tr.run()]
    return out


def test_corrupt_batch_skipped_and_counted(base, jax_base, tmp_path):
    t, s, tj, sj = _both_loops(
        base, jax_base, tmp_path, dict(online_window_rows=300,
                                       online_refresh_rows=150,
                                       online_continue_every=0),
        [100] * 4, plan="corrupt_batch@batch=1")
    assert s == sj
    assert s["skipped_batches"] == 1 and s["consumed_batches"] == 4
    assert s["consumed_rows"] == 300 and s["publishes"] >= 1
    assert t.source.corrupted_batches == 1


def test_stall_source_fires_staleness_refresh(base, jax_base, tmp_path):
    """stall_source holds batch 1 back 300 ms: the 50 pending rows are
    published by the staleness trigger, far below the row trigger."""
    t, s, tj, sj = _both_loops(
        base, jax_base, tmp_path, dict(online_window_rows=500,
                                       online_refresh_rows=500,
                                       online_max_staleness_s=0.1,
                                       online_continue_every=0),
        [50, 50], plan="stall_source@batch=1:ms=300")
    assert s == sj
    assert s["stale_refreshes"] == 1 and s["publishes"] == 1
    assert s["consumed_rows"] == 100


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_staleness_watchdog_on_fake_clock(base, jax_base, tmp_path):
    """Each pull advances an injected clock by 60 ms: under a 100 ms
    staleness bound the third batch fires a `staleness` refresh, far
    below the row trigger, and the tail flushes at the stream's end."""
    params, ds, text = base
    op = dict(online_window_rows=500, online_refresh_rows=500,
              online_max_staleness_s=0.1, online_continue_every=0)
    out = []
    for mod, p, d, t in ((to,
                          dict(params, **op), ds, text),
                         (jo, dict(PARAMS, **op), *jax_base)):
        clock = _FakeClock()

        def gen(clock=clock):
            for lo in range(0, 200, 50):
                yield XS[lo:lo + 50], YS[lo:lo + 50]
                clock.t += 0.06
        tr = mod.OnlineTrainer(p, t, d, mod.CallableSource(gen()),
                               mod.SnapshotPublisher(
                                   prefix=str(tmp_path / mod.__name__),
                                   mode="files"), clock=clock)
        out.append(tr.run())
    assert out[0] == out[1]
    assert out[0]["publishes"] == 2 and out[0]["stale_refreshes"] == 1
    assert out[0]["consumed_rows"] == 200


def test_refresh_policy_row_trigger_counts(base, tmp_path, trace):
    params, ds, text = base
    op = dict(params, online_window_rows=400, online_refresh_rows=200,
              online_continue_every=0)
    _, s = _loop(op, text, ds, TraceSource(trace), str(tmp_path / "m"))
    assert s["publishes"] == 3 and s["refits"] == 3 and s["continues"] == 0
    assert s["window_rows"] == 400


def test_callable_source_flushes_tail_at_end(base, tmp_path):
    params, ds, text = base

    def gen():
        for lo in range(0, 150, 50):
            yield XS[lo:lo + 50], YS[lo:lo + 50]
    op = dict(params, online_window_rows=500, online_refresh_rows=60,
              online_continue_every=0)
    _, s = _loop(op, text, ds, CallableSource(gen()), str(tmp_path / "m"))
    assert s["publishes"] == 2 and s["consumed_rows"] == 150


# ----------------------------------------------------------------------
# byte parity with the offline arms; JAX by summary, kinds, structures
# ----------------------------------------------------------------------
def test_snapshots_md5_equal_offline_arms_and_jax_summary(
        base, jax_base, tmp_path, trace):
    """Three refreshes (refit, refit, continue), weights included: every
    snapshot verifies against its manifest and is md5-equal to its
    offline arm; the JAX package's loop on the same trace gives the same
    summary, kinds and reasons."""
    params, ds, text = base
    op = dict(params, **LOOP)
    t, s = _loop(op, text, ds, TraceSource(trace), str(tmp_path / "m"))
    assert s["publishes"] == 3 and s["continues"] == 1
    for k, off in enumerate(_offline_arms(op, text, ds, XS, YS, WS), 1):
        snap = str(tmp_path / f"m.snapshot_iter_{k}.txt")
        ok, reason = verify_manifest(snap)
        assert ok, reason
        assert _md5_file(snap) == _md5(off), f"snapshot {k}"
        assert json.load(open(snap + ".manifest.json"))["kind"] == (
            "continue" if k == 3 else "refit")
    tj = jo.OnlineTrainer(dict(PARAMS, **LOOP), jax_base[1], jax_base[0],
                          jo.TraceSource(trace), jo.SnapshotPublisher(
                              prefix=str(tmp_path / "j"), mode="files"))
    assert tj.run() == s
    assert t.schema_signature == tj.schema_signature

    def kinds(prefix):
        return [tuple(json.load(open(
            f"{prefix}.snapshot_iter_{k}.txt.manifest.json"))[f]
            for f in ("kind", "reason", "window_rows")) for k in (1, 2, 3)]
    assert kinds(tmp_path / "m") == kinds(tmp_path / "j")


def _blocks(text):
    body = text.split("end of trees")[0]
    return [dict(ln.split("=", 1) for ln in blk.splitlines()[1:] if "=" in ln)
            for blk in body.split("Tree=")[1:]]


def test_grid_labels_structures_equal_jax_from_jax_anchor(tmp_path):
    """A regression loop on 1/64-grid labels, both packages from the JAX
    package's anchor text: each snapshot's trees have the JAX snapshot's
    structures, raw predictions within 1e-5, and the port's snapshots are
    md5-equal to its offline arms on that text."""
    p = dict(PARAMS, objective="regression")
    y_b = np.round((XB[:, 0] + XB[:, 1]) * 32) / 64
    y_s = np.round((XS[:, 0] + XS[:, 1]) * 32) / 64
    dj = lj.Dataset(XB, label=y_b, params=dict(p), free_raw_data=False)
    jtext = lj.train(dict(p), dj, num_boost_round=6).model_to_string()
    dt = lt.Dataset(XB, label=y_b, params=dict(p, **TORCH),
                    free_raw_data=False)
    trace = str(tmp_path / "g.npz")
    save_trace(trace, XS, y_s, batch_sizes=[100] * 6)
    op = dict(p, **TORCH, **LOOP)
    _, s = _loop(op, jtext, dt, TraceSource(trace), str(tmp_path / "m"))
    sj = jo.OnlineTrainer(dict(p, **LOOP), jtext, dj, jo.TraceSource(trace),
                          jo.SnapshotPublisher(prefix=str(tmp_path / "j"),
                                               mode="files")).run()
    assert s == sj
    offline = _offline_arms(op, jtext, dt, XS, y_s, None)
    for k in (1, 2, 3):
        mt = open(tmp_path / f"m.snapshot_iter_{k}.txt").read()
        mj = open(tmp_path / f"j.snapshot_iter_{k}.txt").read()
        assert _md5(mt) == _md5(offline[k - 1])
        bt, bj = _blocks(mt), _blocks(mj)
        assert len(bt) == len(bj) == (6 if k < 3 else 10)
        for a, b in zip(bt, bj):
            for key in ("num_leaves", "split_feature", "threshold",
                        "left_child", "right_child"):
                assert a[key] == b[key], (k, key)
        np.testing.assert_allclose(
            _anchor(mt).predict(XS, raw_score=True),
            lj.Booster(model_str=mj).predict(XS, raw_score=True), atol=1e-5)


def test_in_process_resume_republishes_identical_bytes(base, tmp_path,
                                                       trace):
    params, ds, text = base
    op = dict(params, **LOOP)
    _loop(op, text, ds, TraceSource(trace), str(tmp_path / "ref"))
    ck = str(tmp_path / "ckpt")
    _, s1 = _loop(dict(op, online_max_batches=4), text, ds,
                  TraceSource(trace), str(tmp_path / "got"),
                  checkpoint_dir=ck)
    assert s1["publishes"] == 2
    _, s2 = _loop(op, text, ds, TraceSource(trace), str(tmp_path / "got"),
                  checkpoint_dir=ck)
    assert s2["consumed_batches"] == 6 and s2["publishes"] == 1
    for k in (1, 2, 3):
        assert _md5_file(tmp_path / f"got.snapshot_iter_{k}.txt") == \
            _md5_file(tmp_path / f"ref.snapshot_iter_{k}.txt")


_KILL_WORKER = """\
import json, sys
spec = json.load(open(sys.argv[1]))
import numpy as np
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.online import (OnlineTrainer, SnapshotPublisher,
                                       TraceSource)
from lightgbm_tpu_torch.runtime.faults import active_plan
with np.load(spec["base_npz"]) as z:
    X, y = z["X"], z["y"]
params = spec["params"]
ds = lt.Dataset(X, label=y, params=dict(params), free_raw_data=False)
plan = active_plan(spec.get("fault_plan", ""))
OnlineTrainer(params, spec["base_model"], ds,
              TraceSource(spec["trace"], fault_plan=plan),
              SnapshotPublisher(prefix=spec["prefix"], mode="files"),
              fault_plan=plan, checkpoint_dir=spec["ckpt"]).run()
"""


def test_kill_subprocess_resumes_to_identical_bytes(base, tmp_path, trace):
    """kill@iter=2 exits 17 before the second publish; the resumed
    process seeks past the checkpointed batches, and every snapshot
    equals the uninterrupted run's byte for byte."""
    params, ds, text = base
    op = dict(params, **LOOP)
    _loop(op, text, ds, TraceSource(trace), str(tmp_path / "ref"))
    base_npz = str(tmp_path / "base.npz")
    np.savez(base_npz, X=XB, y=YB)
    worker = tmp_path / "worker.py"
    worker.write_text(_KILL_WORKER)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}

    def spawn(fault):
        spec = tmp_path / "spec.json"
        spec.write_text(json.dumps({
            "base_npz": base_npz, "params": op, "trace": trace,
            "base_model": text, "prefix": str(tmp_path / "got"),
            "ckpt": str(tmp_path / "ckpt"), "fault_plan": fault}))
        return subprocess.run([sys.executable, str(worker), str(spec)],
                              env=env, capture_output=True, text=True,
                              timeout=300)
    killed = spawn("kill@iter=2")
    assert killed.returncode == 17, killed.stdout + killed.stderr
    assert os.path.exists(tmp_path / "got.snapshot_iter_1.txt")
    assert not os.path.exists(tmp_path / "got.snapshot_iter_2.txt")
    resumed = spawn("")
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    for k in (1, 2, 3):
        assert _md5_file(tmp_path / f"got.snapshot_iter_{k}.txt") == \
            _md5_file(tmp_path / f"ref.snapshot_iter_{k}.txt"), k


# ----------------------------------------------------------------------
# publication and co-located serving
# ----------------------------------------------------------------------
def test_publisher_modes_and_watch_floor(base, tmp_path):
    """`both` writes the file with its manifest, promotes, and lifts the
    watcher's floor, so a poll does not promote the file copy again."""
    _, _, text = base
    registry = ModelRegistry(engine="host", max_batch=64, device_type="cpu")
    registry.register("default", text)
    prefix = str(tmp_path / "m")
    registry.watch_snapshots("default", prefix, start=False)
    pub = SnapshotPublisher(prefix=prefix, mode="both", registry=registry)
    info = pub.publish(text, 1)
    assert info["promoted"] and os.path.exists(info["path"])
    assert info["sha256"] == hashlib.sha256(text.encode()).hexdigest()
    ok, reason = verify_manifest(info["path"])
    assert ok, reason
    v = registry.session("default").version
    assert registry.poll_snapshots("default") is None
    assert registry.session("default").version == v
    files = SnapshotPublisher(prefix=str(tmp_path / "f"), mode="files")
    assert not files.publish(text, 4)["promoted"]
    assert files.snapshot_path(4).endswith(".snapshot_iter_4.txt")
    for kw in ({"prefix": prefix, "mode": "bogus"},
               {"prefix": "", "mode": "files"},
               {"prefix": prefix, "mode": "direct", "registry": None}):
        with pytest.raises(ValueError):
            SnapshotPublisher(**kw)


def test_hot_swap_under_live_traffic(base, tmp_path, trace):
    """Three refreshes promoted (mode both) into a co-located binned
    session whose f32 rows bin through #6's plain version, while two
    client threads score single rows: no failed request, no host
    fallback, each answer within 1e-6 of `Booster.predict` of a
    generation live during the request, never an older one than the
    client's last."""
    params, ds, text = base
    h = ds.construct()._handle
    mappers = [None] * h.num_total_features
    for inner, orig in enumerate(h.real_feature_index):
        mappers[orig] = h.mappers[inner]
    metrics = ServingMetrics(max_batch=64)
    registry = ModelRegistry(metrics=metrics, engine="binned", max_batch=64,
                             device_type="cpu", binning_impl="device")
    registry.register("default", text, bin_mappers=mappers)
    batcher = MicroBatcher(lambda q: registry.predict(q), max_batch=64,
                           max_wait_ms=1.0, queue_depth=64,
                           timeout_ms=10_000, metrics=metrics)
    batcher.start()
    Xq = XS[:64].astype(np.float32)
    seen, errors, stop = [[], []], [], threading.Event()

    def client(c):
        rng = np.random.RandomState(c)
        while not stop.is_set():
            i = int(rng.randint(64))
            v0 = registry.session("default").version
            try:
                p = float(np.asarray(batcher.predict(Xq[i:i + 1]))[0])
            except Exception as e:          # fails the test below
                errors.append(e)
                return
            seen[c].append((i, v0, registry.session("default").version, p))
    threads = [threading.Thread(target=client, args=(c,)) for c in (0, 1)]
    for th in threads:
        th.start()
    try:
        pub = SnapshotPublisher(prefix=str(tmp_path / "m"), mode="both",
                                registry=registry)
        s = OnlineTrainer(dict(params, **LOOP, online_serve=True), text, ds,
                          TraceSource(trace), pub).run()
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)
        batcher.stop()
    assert not errors, errors
    assert s["publishes"] == 3 and registry.session().version == 3
    assert metrics.counters.get("swaps", 0) == 3
    assert metrics.counters.get("host_fallbacks", 0) == 0
    gens = [text] + [open(tmp_path / f"m.snapshot_iter_{k}.txt").read()
                     for k in (1, 2, 3)]
    preds = [_anchor(g).predict(Xq.astype(np.float64)) for g in gens]
    for rows in seen:
        assert rows
        last = 0
        for i, v0, v1, p in rows:
            ok = [v for v in range(max(v0, last), v1 + 1)
                  if abs(preds[v][i] - p) <= 1e-6]
            assert ok, (i, v0, v1, p)
            last = ok[0]


def test_online_config_aliases_validation_and_model_echo():
    cfg = resolve_params({"stream_source": "/tmp/x", "online_window": 512,
                          "online_refit_rows": 128, "continue_every": 2,
                          "online_new_trees": 3, "publish_mode": "files",
                          "online_ckpt_every": 2})
    assert (cfg.online_source, cfg.online_window_rows,
            cfg.online_refresh_rows, cfg.online_continue_every,
            cfg.online_continue_trees, cfg.online_checkpoint_every) == (
        "/tmp/x", 512, 128, 2, 3, 2)
    echo = cfg.to_string()
    for field in ("online_source", "online_window_rows",
                  "online_refresh_rows", "online_publish_mode",
                  "online_serve"):
        assert field not in echo
    for bad in ({"online_window_rows": 0},
                {"online_refresh_rows": 600, "online_window_rows": 500},
                {"online_publish_mode": "ftp"},
                {"online_idle_timeout_s": 0.0},
                {"online_checkpoint_every": 0},
                {"task": "online", "online_publish_mode": "direct"}):
        with pytest.raises(Exception):
            resolve_params(bad)


def test_cli_task_online(tmp_path):
    """task=online end to end on the CPU: the base model trained offline,
    the trace consumed, co-located serving promoted directly and from
    files, the profile's online spans and an HBM sample a publish, the
    newest snapshot as output_model, which task=predict reads."""
    Xb, yb = _data(240, 0)
    data = str(tmp_path / "train.csv")
    np.savetxt(data, np.column_stack([yb, Xb]), delimiter=",")
    trace = str(tmp_path / "s.npz")
    save_trace(trace, XS[:360], YS[:360], batch_sizes=[120] * 3)
    out = str(tmp_path / "model.txt")
    prof, smet = str(tmp_path / "profile.json"), str(tmp_path / "sm.json")
    assert cli_main([
        "task=online", f"data={data}", "header=false", "label_column=0",
        f"online_source={trace}", f"output_model={out}", "device_type=cpu",
        "objective=binary", "num_leaves=7", "min_data_in_leaf=5",
        "num_iterations=6", "seed=3", "deterministic=true", "verbosity=-1",
        "online_window_rows=240", "online_refresh_rows=120",
        "online_continue_every=2", "online_continue_trees=3",
        "online_publish_mode=both", "online_serve=true", "serve_port=0",
        "serve_warmup=false", "device_profile=true",
        f"profile_output={prof}", f"serve_metrics_output={smet}"]) == 0
    profile = json.load(open(prof))
    for span in ("online_ingest", "online_refit", "online_continue",
                 "online_publish"):
        assert span in profile["stages_s"], span
    assert profile["n_iters"] == 3
    samples = profile["hbm_watermark"]
    assert len(samples) == 3 and all("peak_bytes" in x for x in samples)
    assert json.load(open(smet))["serving"]["counters"]["swaps"] == 3
    assert _md5_file(out) == _md5_file(
        str(tmp_path / "model.txt.snapshot_iter_3.txt"))
    pred = str(tmp_path / "pred.tsv")
    assert cli_main(["task=predict", f"data={data}", "header=false",
                     "label_column=0", f"input_model={out}",
                     f"output_result={pred}", "device_type=cpu",
                     "verbosity=-1"]) == 0
    assert os.path.getsize(pred) > 0
