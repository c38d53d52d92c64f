"""Overload protection in the port (lightgbm_tpu_torch/serving/): admission
control and load shedding, deadline propagation, the circuit breaker with
the serving fault hooks, wedge detection, snapshot watching, the config
knobs and `task=serve`. tests/test_serving_slo.py's cases, ported:

  * the device-free objects (AdmissionController, CircuitBreaker, the
    token bucket) run side by side with the JAX package's under one
    injected clock and one event sequence: states, counters, shed
    outcomes and retry_after_s equal;
  * the session's breaker path on the CPU (engine="device" runs the
    device walk's plain PyTorch version): degraded chunks' margins
    bitwise Booster.predict, each counted in host_fallbacks; without a
    breaker a failing chunk raises (C note 20);
  * /predict answers the same status codes as the JAX server for the
    same requests;
  * every sleep is about 50 ms or less; the HTTP servers bind
    127.0.0.1:0.
"""

import http.client
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu.serving as js
import lightgbm_tpu_torch as lt
import lightgbm_tpu_torch.serving as ts
from lightgbm_tpu.cli import build_http_server as j_build_http_server
from lightgbm_tpu.config import resolve_params as j_resolve_params
from lightgbm_tpu.runtime.faults import FaultPlan as JFaultPlan
from lightgbm_tpu.serving.admission import _TokenBucket as JBucket
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch.config import resolve_params
from lightgbm_tpu_torch.runtime.checkpoint import write_manifest
from lightgbm_tpu_torch.runtime.faults import (FaultPlan, InjectedFault,
                                               corrupt_file)
from lightgbm_tpu_torch.serving import (AdmissionController, CircuitBreaker,
                                        MicroBatcher, ModelRegistry,
                                        OverloadedError, RequestTimeout,
                                        ServingMetrics, ServingSession)
from lightgbm_tpu_torch.serving.admission import _TokenBucket
from lightgbm_tpu_torch.serving.breaker import CLOSED, HALF_OPEN, OPEN

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

COLS = 12
CPU = {"device_type": "cpu", "binning_impl": "host"}
BOTH = (("jax", js), ("torch", ts))


def _data(seed, n=400):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, COLS))
    y = X[:, 0] * 2 + np.sin(X[:, 1]) + 0.1 * rng.normal(size=n)
    return X, y


def _make(seed, rounds=10):
    X, y = _data(seed)
    return lt.train(dict(objective="regression", num_leaves=15, verbose=-1,
                         min_data_in_leaf=5, **CPU),
                    lt.Dataset(X, label=y), num_boost_round=rounds)


@pytest.fixture(scope="module")
def booster():
    return _make(3)


class _FakeBatcher:
    """Just enough surface for AdmissionController."""

    def __init__(self, capacity=10):
        self.depth = 0
        self.capacity = capacity
        self.max_batch = 4
        self.dropped = []

    def drop_oldest(self, error=None):
        self.dropped.append(error)
        return True

    def submit(self, x, deadline=None):
        return ("req", deadline)


def _counters(m):
    """The metrics' counters but the port's own worker_deaths (which the
    JAX package adds only when a worker dies)."""
    return {k: v for k, v in m.counters.items() if k != "worker_deaths"}


def _outcome(fn):
    """(exception class name or "ok", retry_after_s, http_status)."""
    try:
        fn()
        return ("ok", None, None)
    except Exception as e:
        return (type(e).__name__, getattr(e, "retry_after_s", None),
                getattr(e, "http_status", None))


# ----------------------------------------------------------------------
# admission: side by side with the JAX package's
# ----------------------------------------------------------------------
def test_token_bucket_matches_jax():
    trace = {}
    for name, cls in (("jax", JBucket), ("torch", _TokenBucket)):
        b = cls(rate=10.0, burst=2.0, now=0.0)
        trace[name] = [b.take(now, n) for now, n in (
            (0.0, 1.0), (0.0, 1.0), (0.0, 1.0), (0.05, 1.0), (0.1, 1.0),
            (10.0, 2.0), (10.0, 2.0), (10.3, 0.5), (11.0, 3.0))]
    assert trace["torch"] == trace["jax"]
    assert trace["torch"][2] == pytest.approx(0.1)      # 1 token @ 10/s


# (name, constructor kwargs, events): an event sets the fake batcher's
# depth / the clock / the occupancy, observes a latency, or admits
ADMISSION_CASES = {
    "hysteresis": (dict(queue_high=0.8, queue_low=0.3),
                   [("depth", 7), "admit", ("depth", 8), "admit",
                    ("depth", 5), "admit", ("depth", 3), "admit"]),
    "p99_window": (dict(p99_slo_ms=50.0, capacity=1000),
                   [("lat", 0.2)] * 20 + ["admit", ("t", 4.0), "admit",
                                          ("t", 10.0), "admit"]),
    "occupancy": (dict(occupancy_high=0.8, capacity=1000),
                  [("occ", 0.2), "admit", ("occ", 0.85), "admit",
                   ("occ", 0.73), "admit", ("occ", 0.71), "admit"]),
    "drop_oldest": (dict(queue_high=0.5, queue_low=0.1,
                         shed_class="drop_oldest"),
                    [("depth", 6), "submit", "submit", ("depth", 1),
                     "submit"]),
    "rate_limit": (dict(rate_qps=2.0, burst=1.0, capacity=100),
                   [("admit", "a"), ("admit", "a"), ("admit", "b"),
                    ("t", 0.25), ("admit", "a"), ("t", 0.5),
                    ("admit", "a"), ("rows", 3, "c")]),
    "rate_and_depth": (dict(rate_qps=100.0, burst=5.0, queue_high=0.5,
                            queue_low=0.2),
                       [("depth", 5), "admit", ("batch_lat", 0.03),
                        ("depth", 9), "admit", ("depth", 1), "admit"]),
}


def _run_admission(mod, kwargs, events):
    kw = dict(kwargs)
    fb = _FakeBatcher(capacity=kw.pop("capacity", 10))
    t, occ = [0.0], [None]
    m = mod.ServingMetrics(max_batch=4)
    if "occupancy_high" in kw:
        kw["occupancy_observer"] = lambda: occ[0]
    adm = mod.AdmissionController(fb, metrics=m, clock=lambda: t[0], **kw)
    trace = []
    for ev in events:
        ev = ev if isinstance(ev, tuple) else (ev,)
        if ev[0] == "depth":
            fb.depth = ev[1]
        elif ev[0] == "t":
            t[0] = ev[1]
        elif ev[0] == "occ":
            occ[0] = ev[1]
        elif ev[0] == "lat":
            adm.observe_latency(ev[1])
        elif ev[0] == "batch_lat":
            m.batch_latency.record(ev[1])
        elif ev[0] == "submit":
            trace.append(_outcome(lambda: adm.submit(np.zeros((1, 3)))))
        elif ev[0] == "rows":
            trace.append(_outcome(lambda: adm.admit(n_rows=ev[1],
                                                    client=ev[2])))
        else:
            client = ev[1] if len(ev) > 1 else "default"
            trace.append(_outcome(lambda: adm.admit(client=client)))
        trace.append((adm.shedding, adm.observed_p99_ms(),
                      adm.observed_occupancy()))
    dropped = [(type(e).__name__, e.retry_after_s) for e in fb.dropped]
    return trace, _counters(m), dict(m.states), dropped


@pytest.mark.parametrize("case", list(ADMISSION_CASES))
def test_admission_matches_jax(case):
    kwargs, events = ADMISSION_CASES[case]
    got = {name: _run_admission(mod, kwargs, events) for name, mod in BOTH}
    assert got["torch"] == got["jax"]
    trace, counters, states, dropped = got["torch"]
    outcomes = [o for o in trace if len(o) == 3 and isinstance(o[0], str)]
    if case == "rate_limit":
        assert ("RateLimitedError", pytest.approx(0.5), 429) in outcomes
        assert counters["shed_rate_limit"] >= 2
    elif case == "drop_oldest":
        assert dropped and counters["shed_drop_oldest"] == 2
    else:
        assert any(o[0] == "OverloadedError" and o[2] == 503
                   for o in outcomes)
        assert states["shedding"] == "no"       # every case disengages


def test_admission_validation_matches_jax():
    bad = [dict(shed_class="nope"), dict(queue_high=1.5),
           dict(queue_high=0.5, queue_low=0.8), dict(rate_qps=-1.0),
           dict(occupancy_high=1.5), dict(p99_slo_ms=-1.0)]
    for kw in bad:
        errs = {name: _outcome(lambda: mod.AdmissionController(
            _FakeBatcher(), **kw))[0] for name, mod in BOTH}
        assert errs["torch"] == errs["jax"] == "ValueError", kw
    # the default occupancy observer is the shared metrics' occupancy
    m = ServingMetrics(max_batch=8)
    adm = AdmissionController(_FakeBatcher(), metrics=m, occupancy_high=0.5)
    assert adm.occupancy_observer == m.batch_occupancy


# ----------------------------------------------------------------------
# the circuit breaker: side by side with the JAX package's
# ----------------------------------------------------------------------
BREAKER_CASES = {
    "latency_trip_reopen": (dict(failure_threshold=0, latency_slo_ms=10.0,
                                 latency_trips=2, cooldown_s=1.0),
                            [("ok", 0.005), ("ok", 0.05), ("ok", 0.05),
                             "allow", ("t", 1.5), "allow", "allow",
                             ("ok", 0.05), ("t", 3.0), "allow",
                             ("ok", 0.001), "allow"]),
    "failure_trip": (dict(failure_threshold=3, cooldown_s=0.5),
                     [("fail",), ("fail",), ("ok", 0.0), ("fail",),
                      ("fail",), ("fail",), "allow", ("fail",),
                      ("t", 0.4), "allow", ("t", 0.6), "allow",
                      ("fail",), "allow", ("t", 1.2), "allow",
                      ("ok", 0.0), "allow"]),
}


def _run_breaker(mod, kwargs, events):
    t = [0.0]
    m = mod.ServingMetrics()
    br = mod.CircuitBreaker(metrics=m, clock=lambda: t[0], **kwargs)
    trace = []
    for ev in events:
        ev = ev if isinstance(ev, tuple) else (ev,)
        if ev[0] == "t":
            t[0] = ev[1]
        elif ev[0] == "ok":
            br.record_success(ev[1])
        elif ev[0] == "fail":
            br.record_failure(RuntimeError("injected"))
        else:
            trace.append(br.allow())
        trace.append(br.to_dict())
    return trace, _counters(m), dict(m.states)


@pytest.mark.parametrize("case", list(BREAKER_CASES))
def test_breaker_matches_jax(case):
    kwargs, events = BREAKER_CASES[case]
    got = {name: _run_breaker(mod, kwargs, events) for name, mod in BOTH}
    assert got["torch"] == got["jax"]
    trace, counters, states = got["torch"]
    assert counters["breaker_trips"] == 2
    assert counters["breaker_recoveries"] == 1
    assert states["breaker"] == CLOSED


def test_breaker_states_and_validation():
    t = [0.0]
    br = CircuitBreaker(failure_threshold=1, cooldown_s=1.0,
                        clock=lambda: t[0])
    br.record_failure(RuntimeError("x"))
    assert br.state == OPEN and not br.allow()
    t[0] = 2.0
    assert br.allow() and br.state == HALF_OPEN and not br.allow()
    for kw in (dict(failure_threshold=-1), dict(latency_trips=0),
               dict(cooldown_s=0.0), dict(latency_slo_ms=-1.0)):
        errs = {name: _outcome(lambda: mod.CircuitBreaker(**kw))[0]
                for name, mod in BOTH}
        assert errs["torch"] == errs["jax"] == "ValueError", kw


# ----------------------------------------------------------------------
# deadline propagation, drop_oldest, wedge detection
# ----------------------------------------------------------------------
def test_deadline_expired_at_batch_assembly():
    """A request whose deadline passed while queued is failed at gather
    time — before padding or scoring — and counted as expired."""
    m = ServingMetrics()
    gate = threading.Event()
    calls = []

    def gated(X):
        calls.append(X.shape[0])
        gate.wait(10)
        return np.asarray(X)[:, 0]

    with MicroBatcher(gated, max_batch=4, max_wait_ms=0.0,
                      timeout_ms=5000, metrics=m) as mb:
        r1 = mb.submit(np.zeros((1, 3)))                  # occupies worker
        while not calls:
            time.sleep(0.002)
        r2 = mb.submit(np.zeros((1, 3)),
                       deadline=time.perf_counter() + 0.01)
        time.sleep(0.03)                                  # r2 expires queued
        gate.set()
        mb.wait(r1)
        with pytest.raises(RequestTimeout, match="deadline expired"):
            mb.wait(r2, timeout=5.0)
    assert m.counters["expired"] == 1
    assert calls == [1]                          # r2 never reached scoring


def test_deadline_bounds_wait_and_none_is_legacy():
    with MicroBatcher(lambda X: np.asarray(X)[:, 0], max_batch=4,
                      timeout_ms=50.0) as mb:
        assert mb.predict(np.zeros((1, 3))) is not None
        with pytest.raises(RequestTimeout):
            mb.predict(np.zeros((1, 3)),
                       deadline=time.perf_counter() - 0.01)


def test_drop_oldest_and_health_accessors():
    gate = threading.Event()
    started = threading.Event()

    def gated(X):
        started.set()
        gate.wait(10)
        return np.asarray(X)[:, 0]

    mb = MicroBatcher(gated, max_batch=1, max_wait_ms=0.0,
                      queue_depth=8, timeout_ms=5000)
    assert not mb.alive() and mb.capacity == 8 and mb.depth == 0
    mb.start()
    try:
        r1 = mb.submit(np.zeros((1, 3)))
        assert started.wait(5)                    # r1 inside the worker
        r2 = mb.submit(np.zeros((1, 3)))          # oldest queued
        r3 = mb.submit(np.zeros((1, 3)))
        assert mb.alive() and mb.depth == 2
        assert mb.drop_oldest(OverloadedError("shed", retry_after_s=2.0))
        gate.set()
        mb.wait(r1)
        mb.wait(r3)
        with pytest.raises(OverloadedError):
            mb.wait(r2)
        assert not mb.drop_oldest()               # queue empty
    finally:
        gate.set()
        mb.stop()
    assert not mb.alive()


def test_wedge_worker_fault_flips_wedged():
    plan = FaultPlan.parse("wedge_worker@batch=0:ms=120")
    mb = MicroBatcher(lambda X: np.asarray(X)[:, 0], max_batch=4,
                      timeout_ms=5000, fault_plan=plan)
    mb.start()
    try:
        time.sleep(0.01)                         # worker inside the wedge
        r = mb.submit(np.zeros((1, 3)))
        time.sleep(0.05)
        assert mb.wedged(threshold_s=0.04)       # stale beat + queued work
        assert mb.wait(r, timeout=5.0) is not None   # wedge ends, served
        assert not mb.wedged(threshold_s=0.04)
    finally:
        mb.stop()


# ----------------------------------------------------------------------
# the session's breaker path
# ----------------------------------------------------------------------
def test_session_degrades_device_to_host_and_recovers(booster):
    """Injected device failures trip the breaker device -> host: every
    request is answered, the degraded chunks bitwise Booster.predict and
    counted in host_fallbacks; after the cooldown a half-open probe
    restores the device walk."""
    rng = np.random.RandomState(9)
    Xq = rng.normal(size=(5, COLS))
    want = booster.predict(Xq)
    m = ServingMetrics()
    br = CircuitBreaker(failure_threshold=3, cooldown_s=0.02, metrics=m)
    plan = FaultPlan.parse("fail_score@batch=0:times=3")
    sess = ServingSession.from_booster(
        booster, engine="device", max_batch=32, metrics=m, breaker=br,
        fault_plan=plan, device_type="cpu")
    assert sess.engine == "device"
    for _ in range(3):                           # 3 injected device fails
        np.testing.assert_array_equal(sess.predict(Xq), want)
    assert br.state == OPEN and br.trips == 1
    assert m.counters["host_fallbacks"] == 3
    assert m.counters["breaker_trips"] == 1
    # OPEN: scored on the host without touching the device path
    np.testing.assert_array_equal(sess.predict(Xq), want)
    assert m.counters["host_fallbacks"] == 4
    time.sleep(0.03)                             # cooldown elapses
    out = sess.predict(Xq)                       # half-open probe succeeds
    assert br.state == CLOSED and br.recoveries == 1
    assert m.counters["breaker_recoveries"] == 1
    assert m.counters["host_fallbacks"] == 4
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)  # f32 walk
    assert m.states["breaker"] == "closed"
    # a chunked request: each chunk asks the breaker on its own
    br2 = CircuitBreaker(failure_threshold=1, cooldown_s=60.0)
    m2 = ServingMetrics()
    s2 = ServingSession.from_booster(
        booster, engine="device", max_batch=8, metrics=m2, breaker=br2,
        fault_plan=FaultPlan.parse("fail_score@batch=1"), device_type="cpu")
    Xl = rng.normal(size=(20, COLS))
    out = s2.predict(Xl)
    assert m2.counters["host_fallbacks"] == 2    # chunk 1 failed, 2 open
    np.testing.assert_array_equal(out[8:], booster.predict(Xl)[8:])


def test_session_without_breaker_raises(booster):
    """No breaker: a failing device chunk raises and nothing is re-scored
    (the JAX package re-scores on the host, C note 20)."""
    m = ServingMetrics()
    sess = ServingSession.from_booster(
        booster, engine="device", max_batch=32, metrics=m,
        fault_plan=FaultPlan.parse("fail_score@batch=0"),
        device_type="cpu")
    with pytest.raises(InjectedFault):
        sess.predict(np.zeros((3, COLS)))
    assert m.counters["host_fallbacks"] == 0
    sess.predict(np.zeros((3, COLS)))            # times=1: served after


def test_breaker_survives_hot_swap(booster):
    m = ServingMetrics()
    br = CircuitBreaker(failure_threshold=1, cooldown_s=60.0, metrics=m)
    reg = ModelRegistry(metrics=m, engine="device", max_batch=32,
                        breaker=br, device_type="cpu")
    reg.register("default", booster)
    br.record_failure(RuntimeError("injected"))
    assert br.state == OPEN
    reg.promote("default", _make(4))
    new = reg.session("default")
    assert new.version == 1 and new.breaker is br and br.state == OPEN


def test_slow_score_trips_the_latency_slo(booster):
    m = ServingMetrics()
    br = CircuitBreaker(failure_threshold=0, latency_slo_ms=5.0,
                        latency_trips=2, cooldown_s=60.0, metrics=m)
    sess = ServingSession.from_booster(
        booster, engine="device", max_batch=32, metrics=m, breaker=br,
        fault_plan=FaultPlan.parse("slow_score@batch=0:ms=10:times=2"),
        device_type="cpu")
    Xq = np.random.RandomState(1).normal(size=(4, COLS))
    for _ in range(2):
        sess.predict(Xq)
    assert br.state == OPEN and "latency SLO" in br.last_trip_reason
    np.testing.assert_array_equal(sess.predict(Xq), booster.predict(Xq))
    assert m.counters["host_fallbacks"] == 1


# ----------------------------------------------------------------------
# snapshot watching
# ----------------------------------------------------------------------
def test_snapshot_rejection_backoff_and_reset(booster, tmp_path):
    prefix = str(tmp_path / "model.txt")
    reg = ModelRegistry(engine="host", max_batch=32, device_type="cpu")
    reg.register("default", booster)
    reg.watch_snapshots("default", prefix)
    w = reg._watches["default"]
    bad = tmp_path / "model.txt.snapshot_iter_5.txt"
    bad.write_text("truncated garbage")
    assert reg.poll_snapshots("default") is None
    assert w.reject_streak == 1
    assert w.backoff_until > time.perf_counter()
    # rewritten-but-still-bad file inside the backoff window: skipped
    # without another validation attempt
    bad.write_text("still garbage, new mtime")
    assert reg.poll_snapshots("default") is None
    assert w.reject_streak == 1
    w.backoff_until = 0.0
    assert reg.poll_snapshots("default") is None
    assert w.reject_streak == 2
    assert reg.metrics.counters["snapshots_rejected"] == 2
    # a valid snapshot promotes and resets the streak
    w.backoff_until = 0.0
    good = tmp_path / "model.txt.snapshot_iter_7.txt"
    booster.save_model(str(good))
    assert reg.poll_snapshots("default") == 7
    assert w.reject_streak == 0 and w.backoff_until == 0.0
    assert reg.session("default").version == 1
    assert json.loads(open(prefix + ".watch_state.json").read()) == \
        {"last_iter": 7}


def test_watch_takes_the_ports_manifests(booster, tmp_path):
    """Snapshots with the port's checksum manifests (cli.py snapshot_freq):
    a corrupted one (same size) is rejected by its manifest, the newest
    good one promoted; the served floor persists across a restart and
    note_published lifts it."""
    prefix = str(tmp_path / "m.txt")
    for it in (4, 8):
        path = f"{prefix}.snapshot_iter_{it}.txt"
        _make(3, rounds=it).save_model(path)
        write_manifest(path)
    corrupt_file(f"{prefix}.snapshot_iter_8.txt")
    reg = ModelRegistry(engine="host", max_batch=32, device_type="cpu")
    reg.register("default", booster)
    reg.watch_snapshots("default", prefix)
    assert reg.poll_snapshots("default") == 4    # 8 rejected, 4 promoted
    assert len(reg.session("default").gbdt.models) == 4
    again = ModelRegistry(engine="host", max_batch=32, device_type="cpu")
    again.register("default", booster)
    again.watch_snapshots("default", prefix)
    assert again._watches["default"].last_iter == 4
    assert again.poll_snapshots("default") is None
    again.note_published("default", 12)
    assert again._watches["default"].last_iter == 12
    # a background watcher stops on request
    again.watch_snapshots("default", prefix, poll_s=0.01, start=True)
    again.stop_watchers()
    assert again._watches["default"].thread is None


# ----------------------------------------------------------------------
# config knobs
# ----------------------------------------------------------------------
def test_config_aliases_validation_and_model_echo():
    params = {"serve_rate_qps": 50, "shed_class": "drop_oldest",
              "breaker_failures": 5, "request_deadline_ms": 200,
              "occupancy_high": 0.7}
    cfg, jcfg = resolve_params(dict(params)), j_resolve_params(dict(params))
    for f in ("serve_admission_rate_qps", "serve_admission_shed_class",
              "serve_breaker_failures", "serve_deadline_ms",
              "serve_admission_occupancy_high", "serve_breaker_cooldown_s",
              "serve_breaker_latency_trips", "serve_admission_queue_high",
              "serve_watch_poll_s", "serve_deadline_header"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.serve_admission_rate_qps == 50.0
    assert cfg.serve_deadline_ms == 200.0
    echo = cfg.to_string()
    for field in ("serve_admission_rate_qps", "serve_breaker_failures",
                  "serve_deadline_ms", "serve_admission_shed_class"):
        assert field not in echo
    for bad in ({"serve_admission_queue_low": 0.9,
                 "serve_admission_queue_high": 0.5},
                {"serve_admission_shed_class": "zap"},
                {"serve_breaker_cooldown_s": 0.0},
                {"serve_breaker_latency_trips": 0},
                {"serve_deadline_ms": -1},
                {"serve_admission_occupancy_high": 1.2}):
        with pytest.raises(Exception):
            resolve_params(bad)


# ----------------------------------------------------------------------
# acceptance: overload end to end
# ----------------------------------------------------------------------
def test_overload_sheds_fast_and_keeps_accepted_p99(booster):
    """A fault-injected slow scorer at 5x capacity: shed requests fail at
    once (never queued), the accepted requests' p99 stays under twice
    the SLO, and every request resolves."""
    service_ms, max_batch, slo_ms = 20.0, 8, 150.0
    m = ServingMetrics(max_batch=max_batch)
    plan = FaultPlan.parse(
        f"slow_score@batch=0:ms={service_ms}:times=100000")
    sess = ServingSession.from_booster(
        booster, engine="host", max_batch=max_batch, metrics=m,
        fault_plan=plan)
    mb = MicroBatcher(sess.predict, max_batch=max_batch, max_wait_ms=1.0,
                      queue_depth=64, timeout_ms=4000, metrics=m)
    mb.start()
    adm = AdmissionController(mb, metrics=m, queue_high=0.5,
                              queue_low=0.25, p99_slo_ms=slo_ms)
    capacity = max_batch / ((service_ms + 1.0) / 1e3)
    offered, clients, duration = 5.0 * capacity, 8, 0.6
    accepted, shed, failed = [], [], []
    lock = threading.Lock()
    row = np.zeros((1, COLS))
    import queue as _q
    inflight: "_q.Queue" = _q.Queue()
    gen_done = threading.Event()

    def client():
        period = clients / offered
        t_end = time.perf_counter() + duration
        while time.perf_counter() < t_end:
            t0 = time.perf_counter()
            try:
                inflight.put((adm.submit(
                    row, deadline=t0 + 2 * slo_ms / 1e3), t0))
            except OverloadedError:
                with lock:
                    shed.append(time.perf_counter() - t0)
            time.sleep(max(0.0, period - (time.perf_counter() - t0)))

    def waiter():
        while True:
            try:
                req, t0 = inflight.get(timeout=0.05)
            except _q.Empty:
                if gen_done.is_set():
                    return
                continue
            try:
                mb.wait(req)
                with lock:
                    accepted.append(time.perf_counter() - t0)
            except Exception as e:
                with lock:
                    failed.append(e)

    gens = [threading.Thread(target=client) for _ in range(clients)]
    waits = [threading.Thread(target=waiter) for _ in range(2 * clients)]
    for t in gens + waits:
        t.start()
    for t in gens:
        t.join(timeout=30)
    gen_done.set()
    for t in waits:
        t.join(timeout=30)
    assert all(not t.is_alive() for t in gens + waits)   # no deadlock
    mb.stop()
    total = len(accepted) + len(shed) + len(failed)
    assert total > 0.5 * offered * duration
    assert len(shed) > len(accepted)
    assert m.counters["shed_overload"] == len(shed)
    assert max(shed) < 0.05
    acc = sorted(accepted)
    p99 = acc[min(len(acc) - 1, int(round(0.99 * (len(acc) - 1))))]
    assert p99 * 1e3 <= 2 * slo_ms
    for e in failed:
        assert isinstance(e, (RequestTimeout, OverloadedError))
    assert m.counters["admitted"] == len(accepted) + len(failed)


# ----------------------------------------------------------------------
# HTTP: the same status codes as the JAX server
# ----------------------------------------------------------------------
def _jax_booster():
    X, y = _data(3)
    return lj.train(dict(objective="regression", num_leaves=15,
                         verbose=-1, min_data_in_leaf=5),
                    lj.Dataset(X, label=y), num_boost_round=4)


def _server(mod, build, model, gate, fault_plan=None, **adm_kw):
    """A registry + batcher (its scorer held by `gate` when the gate is
    shut) + admission + breaker behind build(...) on 127.0.0.1:0."""
    m = mod.ServingMetrics(max_batch=8)
    br = mod.CircuitBreaker(failure_threshold=1, cooldown_s=60.0,
                            metrics=m)
    kw = {"device_type": "cpu"} if mod is ts else {}
    reg = mod.ModelRegistry(metrics=m, engine="device", max_batch=8,
                            breaker=br, fault_plan=fault_plan, **kw)
    reg.register("default", model)

    def gated(X):
        gate.wait(10)
        return reg.predict(X)

    mb = mod.MicroBatcher(gated, max_batch=1, max_wait_ms=0.0,
                          queue_depth=4, timeout_ms=10000, metrics=m,
                          fault_plan=fault_plan)
    mb.start()
    adm = mod.AdmissionController(mb, metrics=m, **adm_kw)
    cfg = types.SimpleNamespace(serve_host="127.0.0.1", serve_port=0,
                                serve_deadline_ms=0.0,
                                serve_deadline_header="X-Deadline-Ms")
    server = build(cfg, reg, mb, m, admission=adm, breaker=br)
    st = threading.Thread(target=server.serve_forever, daemon=True)
    st.start()
    return server, st, mb, m


def _request(server, method, path, body=None, headers=None):
    host, port = server.server_address
    c = http.client.HTTPConnection(host, port, timeout=10)
    try:
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        return r.status, r.getheader("Retry-After"), json.loads(r.read())
    finally:
        c.close()


def _codes(mod, build, model, booster_rows):
    """The status codes (and Retry-After, breaker state) of one request
    script against one package's server."""
    out = []
    gate = threading.Event()
    gate.set()
    plan = (JFaultPlan if mod is js else FaultPlan).parse(
        "fail_score@batch=0")
    # 0.01 tokens/s: no refill between a client's requests
    server, st, mb, m = _server(mod, build, model, gate, fault_plan=plan,
                                rate_qps=0.01, burst=2.0, queue_high=0.75,
                                queue_low=0.25)
    row = json.dumps({"rows": booster_rows}).encode()
    try:
        # 1: the first chunk fails on the device: the breaker re-scores it
        # on the host and opens; 2: served on the host
        for _ in range(2):
            code, ra, body = _request(server, "POST", "/predict", row,
                                      {"X-Client": "a"})
            out.append((code, ra, len(body.get("predictions", []))))
        out.append(m.counters["host_fallbacks"])
        # 3: the bucket (burst 2) is empty for client a: 429, Retry-After
        # about 1 / 0.01 s
        code, ra, _ = _request(server, "POST", "/predict", row,
                               {"X-Client": "a"})
        out.append((code, 95 <= int(ra) <= 100))
        # malformed, non-rectangular, oversized, unknown route
        for body, hdr in ((b"{not json", {}), (b"[[1, 2], [3]]", {}),
                          (b"[]", {"Content-Length": str(40 << 20)})):
            out.append(_request(server, "POST", "/predict", body,
                                {"X-Client": "b", **hdr})[0])
        out.append(_request(server, "POST", "/nope", row)[0])
        out.append(_request(server, "GET", "/nope")[0])
        # a shut gate: one request in the worker, queued ones behind it;
        # a deadline that expires in the queue is 504; past the 75%
        # watermark of the 4-deep queue new requests are shed (503)
        gate.clear()
        blocker = mb.submit(np.zeros((1, COLS)))
        while mb.depth:
            time.sleep(0.002)
        code, _, _ = _request(server, "POST", "/predict", row,
                              {"X-Client": "c", "X-Deadline-Ms": "20"})
        out.append(code)
        queued = [mb.submit(np.zeros((1, COLS))) for _ in range(3)]
        code, ra, _ = _request(server, "POST", "/predict", row,
                               {"X-Client": "d"})
        out.append((code, ra is not None))
        out.append(_request(server, "GET", "/readyz")[0])
        out.append(_request(server, "GET", "/health")[0])
        out.append(_request(server, "GET", "/metrics")[0])
        gate.set()
        for r in [blocker] + queued:
            mb.wait(r)
        out.append(_request(server, "GET", "/healthz")[0])
        out.append(m.states)
    finally:
        gate.set()
        mb.stop()
        server.shutdown()
        server.server_close()
        st.join(timeout=5)
    return out


def test_http_status_codes_match_jax(booster):
    rows = np.random.RandomState(2).normal(size=(1, COLS)).tolist()
    got = {"torch": _codes(ts, tcli.build_http_server, booster, rows),
           "jax": _codes(js, j_build_http_server, _jax_booster(), rows)}
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t[:3] == [(200, None, 1), (200, None, 1), 2]
    assert t[3] == (429, True)
    assert t[4:9] == [400, 400, 413, 404, 404]
    assert t[9] == 504 and t[10] == (503, True)
    assert t[11:14] == [200, 200, 200] and t[14] == 200
    assert t[15] == {"breaker": "open", "shedding": "yes"}


def test_http_healthz_reports_a_wedged_worker(booster):
    m = ServingMetrics(max_batch=8)
    reg = ModelRegistry(metrics=m, engine="host", max_batch=8,
                        device_type="cpu")
    reg.register("default", booster)
    # /healthz's threshold is at least 0.5 s: a 0.8 s stall
    mb = MicroBatcher(reg.predict, max_batch=4, timeout_ms=20, metrics=m,
                      fault_plan=FaultPlan.parse(
                          "wedge_worker@batch=0:ms=800"))
    mb.start()
    cfg = types.SimpleNamespace(serve_host="127.0.0.1", serve_port=0,
                                serve_deadline_ms=0.0,
                                serve_deadline_header="X-Deadline-Ms")
    server = tcli.build_http_server(cfg, reg, mb, m)
    st = threading.Thread(target=server.serve_forever, daemon=True)
    st.start()
    try:
        time.sleep(0.01)
        r = mb.submit(np.zeros((1, COLS)))
        t_end = time.perf_counter() + 5.0
        while not mb.wedged() and time.perf_counter() < t_end:
            time.sleep(0.01)
        code, _, body = _request(server, "GET", "/healthz")
        assert code == 503 and body["worker_wedged"] is True
        mb.wait(r, timeout=5.0)
        code, _, body = _request(server, "GET", "/healthz")
        assert code == 200 and body["worker_alive"] is True
    finally:
        mb.stop()
        server.shutdown()
        server.server_close()
        st.join(timeout=5)


def test_http_deadline_expiry_504(booster):
    """A request whose deadline header expires while queued returns 504
    (the batcher expired it at assembly or wait)."""
    m = ServingMetrics(max_batch=8)
    reg = ModelRegistry(metrics=m, engine="host", max_batch=8,
                        device_type="cpu")
    reg.register("default", booster)
    gate = threading.Event()

    def gated(X):
        gate.wait(10)
        return reg.predict(X)

    mb = MicroBatcher(gated, max_batch=1, max_wait_ms=0.0,
                      timeout_ms=10000, metrics=m)
    mb.start()
    cfg = types.SimpleNamespace(serve_host="127.0.0.1", serve_port=0,
                                serve_deadline_ms=0.0,
                                serve_deadline_header="X-Deadline-Ms")
    server = tcli.build_http_server(cfg, reg, mb, m)
    host, port = server.server_address
    st = threading.Thread(target=server.serve_forever, daemon=True)
    st.start()
    body = json.dumps({"rows": [[0.0] * COLS]}).encode()
    try:
        blocker = mb.submit(np.zeros((1, COLS)))
        req = urllib.request.Request(
            f"http://{host}:{port}/predict", data=body,
            headers={"X-Deadline-Ms": "30"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 504
        gate.set()
        mb.wait(blocker)
    finally:
        gate.set()
        mb.stop()
        server.shutdown()
        server.server_close()
        st.join(timeout=5)


# ----------------------------------------------------------------------
# task=serve
# ----------------------------------------------------------------------
def test_task_serve_file_and_stdin_match_task_predict(booster, tmp_path,
                                                      monkeypatch, capsys):
    """task=serve with serve_port=0: a data file scored through the
    registry and the micro-batcher equals task=predict's file bit for bit
    (serve_engine=auto is the host engine on the CPU); stdin lines print the same values; a
    serve_watch prefix and a fault plan are taken; the metrics file
    carries the breaker's state; serve_models (the fleet) answers the file
    with the same bytes."""
    model = tmp_path / "model.txt"
    booster.save_model(str(model))
    X, _ = _data(5, n=50)
    data = tmp_path / "q.tsv"
    np.savetxt(data, np.column_stack([np.zeros(len(X)), X]), delimiter="\t",
               fmt="%.17g")
    common = [f"input_model={model}", f"data={data}", "device_type=cpu",
              "verbosity=-1"]
    assert tcli.main(["task=predict", f"output_result={tmp_path}/p.tsv"]
                     + common) == 0
    metrics_out = tmp_path / "serve_metrics.json"
    assert tcli.main(["task=serve", f"output_result={tmp_path}/s.tsv",
                      f"serve_watch={tmp_path}/model.txt",
                      "fault_plan=slow_score@batch=0:ms=1",
                      f"serve_metrics_output={metrics_out}"] + common) == 0
    assert open(tmp_path / "s.tsv").read() == open(tmp_path / "p.tsv").read()
    summary = json.loads(metrics_out.read_text())["serving"]
    assert summary["counters"]["requests"] > 0
    want = open(tmp_path / "p.tsv").read().split()
    monkeypatch.setattr("sys.stdin", iter(
        ["\t".join(f"{v:.17g}" for v in X[i]) + "\n" for i in range(3)]))
    capsys.readouterr()
    assert tcli.main(["task=serve", f"input_model={model}",
                      "device_type=cpu", "serve_engine=host",
                      "verbosity=-1"]) == 0
    printed = capsys.readouterr().out.split()
    assert [float(v) for v in printed] == [float(v) for v in want[:3]]
    # serve_models: the multi-tenant fleet answers the file as the single
    # model does, through its first tenant
    assert tcli.main(["task=serve", f"serve_models=a={model},b={model}",
                      f"output_result={tmp_path}/f.tsv"] + common) == 0
    assert open(tmp_path / "f.tsv").read() == open(tmp_path / "s.tsv").read()
    assert not os.path.exists(f"{tmp_path}/model.txt.watch_state.json")


@pytest.mark.parametrize("argv", [[], ["serve_breaker_failures=0"],
                                  ["serve_engine=host"],
                                  ["breaker_failures=0",
                                   "serve_breaker_latency_slo_ms=50"]])
def test_build_serving_builds_the_breaker_as_jax_run_serve(argv):
    """task=serve's objects (cli.build_serving): a breaker exists when a
    device engine may serve and a trip condition is set, with the JAX
    package's defaults and aliases (lightgbm_tpu/cli.py:551-555); the
    batcher is left to the caller to start."""
    cfg = resolve_params(tcli.parse_args(["task=serve", "device_type=cpu"]
                                         + argv))
    jcfg = j_resolve_params(dict(kv.split("=", 1) for kv in argv))
    metrics, br, reg, mb = tcli.build_serving(cfg)
    want = jcfg.serve_engine in ("auto", "device", "binned") and (
        jcfg.serve_breaker_failures > 0
        or jcfg.serve_breaker_latency_slo_ms > 0.0)
    assert (br is not None) == want
    if br is not None:
        assert br.state == CLOSED and br._metrics is metrics
        assert (br.failure_threshold, br.latency_slo_ms, br.latency_trips,
                br.cooldown_s) == (jcfg.serve_breaker_failures,
                                   jcfg.serve_breaker_latency_slo_ms,
                                   jcfg.serve_breaker_latency_trips,
                                   jcfg.serve_breaker_cooldown_s)
    assert reg._defaults.get("breaker") is br and not mb.alive()
