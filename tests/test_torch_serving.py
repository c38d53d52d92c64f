"""The port's serving path (lightgbm_tpu_torch/serving/) on the CPU, where
the device engines run the kernels' plain versions: engines against each
other and against the JAX package's ServingSession, the bucket ladder and
its cache, the micro-batcher, the registry's hot swap, and the refusals.

Tolerances:
  * ``host`` engine: bitwise equal to Booster.predict's host walk (the
    same PackedModel, the same f64 arithmetic);
  * ``device`` and ``binned`` engines, f64 and raw-f32 requests: bitwise
    equal to each other (the same leaves, one accumulation function);
  * against JAX's ServingSession with the same engine: rtol 1e-6 (f32
    leaf values summed in another order).
"""

import threading
import time

import numpy as np
import torch
import pytest

import lightgbm_tpu as lj
from lightgbm_tpu.serving import ServingSession as JSession
from lightgbm_tpu_torch import Booster
from lightgbm_tpu_torch.convert import booster_from_state
from lightgbm_tpu_torch.ops.predict_binned import BinnedUnavailable
from lightgbm_tpu_torch.serving import (MicroBatcher, ModelRegistry,
                                        QueueFullError, RequestTimeout,
                                        ServingMetrics, ServingSession,
                                        bucket_for)

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

COLS = 10
CPU = {"device_type": "cpu"}


def _jax_model(seed, rounds=8, cat=()):
    rng = np.random.RandomState(seed)
    n = 1200
    X = rng.normal(size=(n, COLS))
    for c in cat:
        X[:, c] = rng.randint(0, 12, size=n)
    if cat:
        y = np.where(np.isin(X[:, cat[0]], (1, 4, 7, 9)), 3.0, -3.0) \
            + X[:, 0] + 0.1 * rng.normal(size=n)
        obj = "regression"
    else:
        y = (X[:, 0] + X[:, 1] > 0).astype(float)
        obj = "binary"
    X[rng.rand(n, COLS) < 0.05] = np.nan
    X[rng.rand(n, COLS) < 0.05] = 0.0
    ds = lj.Dataset(X, label=y, categorical_feature=list(cat) or "auto")
    return lj.train(dict(objective=obj, num_leaves=15, verbose=-1,
                         min_data_in_leaf=5, max_bin=63), ds,
                    num_boost_round=rounds), X


def _port(jbst):
    g = jbst._gbdt
    return booster_from_state(
        params={**jbst.params, **CPU},
        trees=[vars(t) for t in g.models],
        mappers=[m.to_dict() for m in g.mappers],
        real_feature_index=g.real_feature_index,
        feature_names=g.feature_names_,
        num_total_features=g.max_feature_idx_ + 1)


def _queries(X, seed, n=300, cat=()):
    rng = np.random.RandomState(seed)
    q = rng.normal(scale=2.0, size=(n, COLS))
    q[rng.rand(n, COLS) < 0.08] = np.nan
    q[rng.rand(n, COLS) < 0.08] = 0.0
    q[:50] = X[:50]
    for c in cat:
        q[:, c] = rng.randint(-2, 14, size=n)
        q[5:11, c] = [99, -3, 7.7, np.nan, 1000, -0.5]
    return q.astype(np.float32)


@pytest.fixture(scope="module")
def binary():
    jbst, X = _jax_model(0)
    return jbst, _port(jbst), _queries(X, 1)


@pytest.fixture(scope="module")
def binary_v2():
    jbst, X = _jax_model(0, rounds=16)
    return jbst, _port(jbst)


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


def test_bucket_for():
    assert bucket_for(1, 8, 256) == 8
    assert bucket_for(9, 8, 256) == 16
    assert bucket_for(1000, 8, 256) == 256
    assert bucket_for(129, 8, 256) == 256


def test_host_engine_bitwise_equals_booster_predict(binary):
    _, bst, q = binary
    s = bst.serve(engine="host", max_batch=64)
    assert s.engine == "host"
    for X in (q, q.astype(np.float64)):
        np.testing.assert_array_equal(s.predict(X), bst.predict(X))
        np.testing.assert_array_equal(s.predict(X, raw_score=True),
                                      bst.predict(X, raw_score=True))
    # engine=auto on the CPU is the host engine
    assert bst.serve().engine == "host"


def _margins(sess, q):
    return sess.predict(q, raw_score=True)


@pytest.mark.parametrize("max_batch", [64, 1024])
def test_device_engines_bitwise_and_against_jax(binary, max_batch):
    jbst, bst, q = binary
    opts = dict(max_batch=max_batch, binning_impl="device")
    dev = bst.serve(engine="device", **opts)
    binned = bst.serve(engine="binned", **opts)
    assert binned.cache_info()["device_binning"]
    ref = _margins(dev, q)
    np.testing.assert_array_equal(_margins(dev, q.astype(np.float64)), ref)
    np.testing.assert_array_equal(_margins(binned, q), ref)        # raw f32
    np.testing.assert_array_equal(
        _margins(binned, q.astype(np.float64)), ref)               # f64
    for engine, got in (("device", ref), ("binned", ref)):
        js = JSession(jbst._gbdt, engine=engine, max_batch=max_batch,
                      binning_impl="device")
        np.testing.assert_allclose(got, js.predict(q, raw_score=True),
                                   rtol=1e-6, atol=1e-6)
    # and the host walk of the same model, up to f32 leaf sums
    np.testing.assert_allclose(ref, bst.predict(q, raw_score=True),
                               rtol=0, atol=1e-5)


def test_categorical_model_from_jax_serves_like_jax():
    jbst, X = _jax_model(3, cat=(2,))
    assert sum(t.num_cat for t in jbst._gbdt.models) > 0
    bst = _port(jbst)
    q = _queries(X, 4, cat=(2,))
    binned = bst.serve(engine="binned", binning_impl="device")
    assert binned._bm.num_cat > 0
    js = JSession(jbst._gbdt, engine="binned", binning_impl="device")
    for Xq in (q, q.astype(np.float64)):
        np.testing.assert_allclose(binned.predict(Xq), js.predict(Xq),
                                   rtol=1e-6, atol=1e-6)
    dev = bst.serve(engine="device")
    np.testing.assert_array_equal(binned.predict(q), dev.predict(q))
    np.testing.assert_allclose(binned.predict(q), jbst.predict(q),
                               rtol=0, atol=1e-5)


def test_bucket_ladder_and_cache_counts(binary):
    _, bst, q = binary
    s = bst.serve(engine="binned", max_batch=100, min_bucket=8,
                  binning_impl="device", warmup=True)
    assert s.max_batch == 128
    ladder = [8, 16, 32, 64, 128]
    info = s.cache_info()
    # warmup builds the uint8 and the raw-f32 scorer of every bucket
    assert (info["entries"], info["misses"], info["hits"]) == (10, 10, 0)
    s.predict(q[:5])                  # raw f32, bucket 8
    s.predict(q[:5].astype(np.float64))  # f64, bucket 8
    s.predict(q[:200])                # 128 + 72 -> buckets 128, 128
    info = s.cache_info()
    assert (info["entries"], info["misses"], info["hits"]) == (10, 10, 4)
    assert s.metrics.counters["host_fallbacks"] == 0
    assert s.metrics.counters["batches"] == 4
    assert s.warmup() == ladder


def test_micro_batcher_coalesces(binary):
    _, bst, q = binary
    sess = bst.serve(engine="binned", binning_impl="device", max_batch=64)
    metrics = ServingMetrics()
    exp = sess.predict(q[:60])
    got = np.empty(60)
    with MicroBatcher(sess.predict, max_batch=64, max_wait_ms=20.0,
                      metrics=metrics) as mb:
        def one(i):
            got[i] = mb.predict(q[i])[0]
        ts = [threading.Thread(target=one, args=(i,)) for i in range(60)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        sizes = list(mb.batch_sizes)
    np.testing.assert_array_equal(got, exp)
    assert sum(sizes) == 60 and len(sizes) < 60
    assert metrics.counters["requests"] == 60


def test_micro_batcher_errors_timeouts_and_overflow():
    def boom(X):
        raise RuntimeError("scorer exploded")

    with MicroBatcher(boom, max_wait_ms=0.0) as mb:
        for _ in range(2):           # the worker survives the error
            with pytest.raises(RuntimeError, match="scorer exploded"):
                mb.predict(np.zeros(COLS))

    def slow(X):
        time.sleep(0.3)
        return np.zeros(X.shape[0])

    metrics = ServingMetrics()
    with MicroBatcher(slow, max_wait_ms=0.0, timeout_ms=30.0,
                      metrics=metrics) as mb:
        with pytest.raises(RequestTimeout):
            mb.predict(np.zeros(COLS))
    assert metrics.counters["timeouts"] == 1

    release = threading.Event()
    mb = MicroBatcher(lambda X: release.wait(5.0) and np.zeros(len(X)),
                      max_wait_ms=0.0, queue_depth=1,
                      metrics=metrics).start()
    try:
        mb.submit(np.zeros(COLS))
        time.sleep(0.1)              # the worker holds request 0
        mb.submit(np.zeros(COLS))
        with pytest.raises(QueueFullError):
            mb.submit(np.zeros(COLS))
    finally:
        release.set()
        mb.stop()


def test_registry_hot_swap_under_concurrent_requests(binary, binary_v2):
    _, b1, q = binary
    _, b2 = binary_v2
    rows = q[:40].astype(np.float64)
    p1, p2 = b1.predict(rows), b2.predict(rows)
    assert not np.array_equal(p1, p2)
    reg = ModelRegistry(engine="binned", binning_impl="device", **CPU)
    reg.register("m", b1)
    stop = threading.Event()
    bad = []

    def hammer():
        while not stop.is_set():
            out = reg.predict(rows, name="m")
            # every response is ENTIRELY one version's answer
            if not (np.allclose(out, p1, rtol=0, atol=1e-5)
                    or np.allclose(out, p2, rtol=0, atol=1e-5)):
                bad.append(out)

    ts = [threading.Thread(target=hammer) for _ in range(4)]
    for t in ts:
        t.start()
    time.sleep(0.05)
    reg.promote("m", b2)              # atomic swap mid-traffic
    time.sleep(0.05)
    stop.set()
    for t in ts:
        t.join(timeout=30)
    assert not bad and not any(t.is_alive() for t in ts)
    sess = reg.session("m")
    assert (sess.version, sess.engine) == (1, "binned")
    assert reg.metrics.counters["swaps"] == 1
    np.testing.assert_allclose(reg.predict(rows, name="m"), p2, rtol=0,
                               atol=1e-5)
    with pytest.raises(KeyError):
        reg.session("nope")


def test_model_text_needs_mappers_for_binned(binary, tmp_path):
    """A model loaded from text carries no mappers: an explicit binned
    engine raises (no fallback to host), explicit bin_mappers restore it,
    and a registry promote to model text carries them over."""
    _, bst, q = binary
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    loaded = Booster(model_file=path, params=CPU)
    with pytest.raises(BinnedUnavailable, match="binned engine "
                                                "unavailable"):
        loaded.serve(engine="binned")
    mappers = bst.serve(engine="binned")._bm._mappers
    s = loaded.serve(engine="binned", bin_mappers=mappers,
                     binning_impl="device")
    ref = bst.serve(engine="device").predict(q)
    np.testing.assert_array_equal(s.predict(q), ref)
    reg = ModelRegistry(engine="binned", binning_impl="device", **CPU)
    reg.register("m", bst)
    reg.promote("m", path)
    assert reg.session("m").engine == "binned"
    np.testing.assert_array_equal(reg.predict(q, name="m"), ref)
    # snapshot watching is ported (tests/test_torch_serving_slo.py): with
    # no snapshot beside the model text, a poll promotes nothing
    reg.watch_snapshots("m", path)
    assert reg.poll_snapshots("m") is None
    assert reg.session("m").version == 1


def test_refusals(binary):
    _, bst, _ = binary
    # the compiled engine is ported (tests/test_torch_export.py): a
    # session builds; its programs are exported when a bucket first scores
    assert bst.serve(engine="compiled", max_batch=8).engine == "compiled"
    # sharded serving on one device rounds to 1 with the JAX package's
    # warning and scores bitwise as its unsharded twin
    sh, logs = _with_warnings(lambda: bst.serve(engine="device",
                                                num_shards=2))
    assert sh.num_shards == 0
    assert any("serving num_shards=2 rounded to 1 (power of two, 1 "
               "devices)" in m for m in logs), logs
    Xq = np.random.RandomState(3).normal(size=(37, sh.num_features))
    assert np.array_equal(sh.predict(Xq),
                          bst.serve(engine="device").predict(Xq))
    # the circuit breaker is ported (tests/test_torch_serving_slo.py): a
    # session with one serves
    from lightgbm_tpu_torch.serving import CircuitBreaker
    br = CircuitBreaker()
    s = bst.serve(engine="device", breaker=br)
    assert s.breaker is br and s.predict(np.zeros((2, s.num_features))) \
        .shape == (2,)
    # the stage profiler is ported (tests/test_torch_runtime.py)
    from lightgbm_tpu_torch.runtime.profiler import StageProfiler
    assert bst.serve(profiler=StageProfiler()).profiler is not None
    with pytest.raises(ValueError, match="unknown serving engine"):
        bst.serve(engine="tpu")
