"""The multi-tenant serving fleet of the port (lightgbm_tpu_torch/serving/
fleet.py) on the CPU: tests/test_fleet.py's and tests/test_fused.py's
cases, ported, and the scheduler and the HTTP front end held to the JAX
package's.

  * per-tenant isolation: queues, admission, breakers, metrics;
  * EDF continuous batching over one worker: with the requests queued
    before start(), the order in which tenants are scored equals the JAX
    fleet's;
  * hot swap under traffic; the fused drain (one walk for a mixed batch,
    bitwise each tenant's session) and its atomic republish;
  * deadlines expired at assembly, a fatal worker failing fast, thread
    hygiene after stop();
  * the fleet's HTTP routes answer the JAX server's status codes.

Answers are bitwise each tenant's own session (the same engine on the same
rows) and within 1e-6 of Booster.predict. Sleeps are about 50 ms or less;
the HTTP servers bind 127.0.0.1:0.
"""

import hashlib
import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu.serving as js
import lightgbm_tpu_torch as lt
from lightgbm_tpu.cli import build_fleet_http_server as j_fleet_server
from lightgbm_tpu_torch.cli import build_fleet_http_server
from lightgbm_tpu_torch.ops.predict_binned import mappers_for
from lightgbm_tpu_torch.runtime.faults import FaultPlan
from lightgbm_tpu_torch.serving import (ModelFleet, RateLimitedError,
                                        RequestTimeout)

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)

COLS = 8
CPU = {"device_type": "cpu", "verbose": -1}


def _md5(a) -> str:
    return hashlib.md5(np.ascontiguousarray(np.asarray(a))
                       .tobytes()).hexdigest()


def _make(rng, n=600, objective="regression", rounds=8, seed_col=0,
          cols=COLS, **params):
    X = rng.normal(size=(n, cols))
    X[rng.rand(n, cols) < 0.05] = np.nan
    y = np.nan_to_num(X[:, seed_col]) * 2 + 0.1 * rng.normal(size=n)
    if objective == "binary":
        y = (y > 0).astype(float)
    elif objective == "multiclass":
        y = np.digitize(y, (-1.0, 1.0))
        params["num_class"] = 3
    return lt.train(dict(objective=objective, num_leaves=12,
                         min_data_in_leaf=5, **CPU, **params),
                    lt.Dataset(X, label=y), num_boost_round=rounds), X


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(7)
    a, X = _make(rng, seed_col=0)
    b, _ = _make(rng, seed_col=1, objective="binary", rounds=6)
    c, _ = _make(rng, seed_col=2, objective="multiclass", rounds=5)
    return {"a": a, "b": b, "c": c, "X": X}


def _fleet(**kw):
    kw.setdefault("max_batch", 16)
    kw.setdefault("max_wait_ms", 1.0)
    kw.setdefault("timeout_ms", 5000.0)
    kw.setdefault("session_opts", {"engine": "binned", "min_bucket": 8,
                                   "device_type": "cpu",
                                   "binning_impl": "device"})
    return ModelFleet(**kw)


def _wait_fused(fleet, gen=0, names=(), timeout=30.0):
    """Block until a supertensor generation > `gen` covering `names` is
    live."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        scorer = fleet._fused_scorer
        if scorer is not None and fleet.fused_generation > gen \
                and all(scorer.can_serve(n) for n in names):
            return
        time.sleep(0.02)
    raise AssertionError(f"fused supertensor gen>{gen} covering {names} "
                         f"never published")


def test_fleet_correctness_and_metrics(models):
    X = models["X"]
    with _fleet() as fleet:
        fleet.add_model("alpha", models["a"])
        fleet.add_model("beta", models["b"])
        pa = fleet.predict(X[:13], tenant="alpha")
        pb = fleet.predict(X[:13].astype(np.float32), tenant="beta")
        assert _md5(pa) == _md5(fleet.session("alpha").predict(X[:13]))
        assert _md5(pb) == _md5(fleet.session("beta").predict(
            X[:13].astype(np.float32)))
        np.testing.assert_allclose(pa, models["a"].predict(X[:13]),
                                   rtol=1e-6, atol=1e-6)
        d = fleet.metrics_dict()
        tenants = d["fleet"]["tenants"]
        assert sorted(tenants) == ["alpha", "beta"]
        assert tenants["alpha"]["tenant"] == "alpha"
        assert tenants["alpha"]["counters"]["requests"] == 1
        assert tenants["beta"]["counters"]["requests"] == 1
        assert tenants["alpha"]["request_latency"]["count"] == 1
        assert sorted(d["stages_by_tenant"]) == ["alpha", "beta"]
        assert d["fleet"]["scheduler"]["batches"] == 2
        assert d["fleet"]["scheduler"]["served"] == {"alpha": 1, "beta": 1}


def test_fleet_concurrent_tenants(models):
    X = models["X"]
    with _fleet() as fleet:
        for name in ("a", "b", "c"):
            fleet.add_model(name, models[name])
        errs = []

        def hammer(name):
            ref = fleet.session(name)
            for i in range(20):
                lo = (7 * i) % 300
                out = fleet.predict(X[lo:lo + 3], tenant=name,
                                    client=f"c{i % 4}")
                if _md5(out) != _md5(ref.predict(X[lo:lo + 3])):
                    errs.append((name, i))

        threads = [threading.Thread(target=hammer, args=(n,))
                   for n in ("a", "b", "c")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        d = fleet.metrics_dict()
        for n in ("a", "b", "c"):
            assert d["fleet"]["tenants"][n]["counters"]["requests"] == 20
            assert d["fleet"]["tenants"][n]["counters"]["errors"] == 0


def test_tenant_rate_limit_isolation(models):
    """A flash crowd on one tenant sheds at ITS token bucket; the quiet
    tenant keeps every request."""
    X = models["X"]
    with _fleet() as fleet:
        fleet.add_model("crowd", models["a"],
                        admission_opts={"rate_qps": 20.0, "burst": 5.0})
        fleet.add_model("quiet", models["b"])
        shed = served = 0
        for i in range(40):
            try:
                fleet.predict(X[i:i + 1], tenant="crowd", client="one")
                served += 1
            except RateLimitedError:
                shed += 1
        assert shed > 0 and served > 0
        for i in range(10):
            fleet.predict(X[i:i + 1], tenant="quiet")
        d = fleet.metrics_dict()["fleet"]["tenants"]
        assert d["crowd"]["counters"]["shed_rate_limit"] == shed
        assert d["quiet"]["counters"]["shed_rate_limit"] == 0
        assert d["quiet"]["counters"]["requests"] == 10
        assert d["quiet"]["counters"]["errors"] == 0


def test_tenant_breaker_isolation(models):
    """Injected scoring failures on one tenant trip ITS breaker (its
    failing chunks re-scored on the host, every answer still right); the
    other tenant's breaker stays closed."""
    X = models["X"]
    with _fleet(breaker_opts={"failure_threshold": 2}) as fleet:
        fleet.add_model(
            "sick", models["a"],
            fault_plan=FaultPlan.parse("fail_score@batch=0:times=2"))
        fleet.add_model("healthy", models["b"])
        for i in range(4):
            out = fleet.predict(X[i:i + 8], tenant="sick")
            np.testing.assert_allclose(out, models["a"].predict(X[i:i + 8]),
                                       rtol=1e-6, atol=1e-6)
            fleet.predict(X[i:i + 8], tenant="healthy")
        d = fleet.metrics_dict()["fleet"]["tenants"]
        assert d["sick"]["counters"]["host_fallbacks"] >= 2
        assert d["sick"]["counters"]["breaker_trips"] >= 1
        assert d["sick"]["counters"]["errors"] == 0
        assert d["healthy"]["counters"]["host_fallbacks"] == 0
        assert d["healthy"]["counters"]["breaker_trips"] == 0


def test_hot_swap_under_traffic(models):
    """Three promotes on one tenant while both tenants take traffic: no
    request errors, versions advance, the neighbour untouched."""
    X = models["X"]
    with _fleet() as fleet:
        fleet.add_model("hot", models["a"])
        fleet.add_model("cold", models["b"])
        stop = threading.Event()
        errs = []

        def hammer(name):
            i = 0
            while not stop.is_set():
                try:
                    fleet.predict(X[i % 300:(i % 300) + 2], tenant=name)
                except Exception as e:
                    errs.append((name, repr(e)))
                i += 1

        threads = [threading.Thread(target=hammer, args=(n,))
                   for n in ("hot", "cold")]
        for t in threads:
            t.start()
        try:
            for new_model in (models["b"], models["c"], models["a"]):
                fleet.promote("hot", new_model)
                time.sleep(0.05)
        finally:
            stop.set()
            for t in threads:
                t.join()
        assert not errs
        assert fleet.session("hot").version == 3
        assert fleet.session("cold").version == 0
        d = fleet.metrics_dict()["fleet"]["tenants"]
        assert d["hot"]["counters"]["swaps"] == 3
        assert d["cold"]["counters"]["swaps"] == 0
        np.testing.assert_allclose(fleet.predict(X[:5], tenant="hot"),
                                   models["a"].predict(X[:5]), rtol=1e-6,
                                   atol=1e-6)


def test_deadline_expiry_at_assembly(models):
    """A request whose deadline passes while queued is failed at batch
    assembly (the expired counter), never scored."""
    X = models["X"]
    fleet = _fleet(fault_plan=FaultPlan.parse("wedge_worker@batch=0:ms=300"))
    fleet.add_model("t", models["a"])
    fleet.start()
    try:
        req = fleet.submit(X[:1], tenant="t",
                           deadline=time.perf_counter() + 0.02)
        with pytest.raises(RequestTimeout):
            fleet.wait(req, tenant="t", timeout=2.0)
        deadline = time.time() + 2.0
        while time.time() < deadline:
            if fleet._tenant("t").metrics.counters["expired"] == 1:
                break
            time.sleep(0.01)
        assert fleet._tenant("t").metrics.counters["expired"] == 1
        assert fleet._tenant("t").metrics.counters["batches"] == 0
    finally:
        fleet.stop()


def test_fatal_worker_death_fails_fast(models):
    """An error escaping the per-batch guard fails every queued request
    across all tenants and makes later submits fail fast."""
    X = models["X"]
    fleet = _fleet()
    fleet.add_model("t1", models["a"])
    fleet.add_model("t2", models["b"])

    def boom():
        raise RuntimeError("scheduler exploded")

    fleet._next_batch = boom
    fleet.start()
    deadline = time.time() + 2.0
    while time.time() < deadline and fleet._fatal is None:
        time.sleep(0.01)
    assert fleet._fatal is not None
    assert fleet.worker_deaths == 1
    for tenant in ("t1", "t2"):
        with pytest.raises(RuntimeError, match="fleet worker died"):
            fleet.submit(X[:1], tenant=tenant)
    fleet.stop()
    assert not fleet.alive()


def _edf_order(fleet_cls, add, fused_opts):
    """The tenants in the order one fleet scores them: requests with set
    deadlines queued before start(), one row a batch."""
    fleet = fleet_cls(max_batch=1, max_wait_ms=0.0, timeout_ms=5000.0,
                      session_opts=fused_opts)
    for name in ("a", "b", "c"):
        add(fleet, name)
    order = []
    score = fleet._score

    def recording(t, batch):
        order.append(t.name)
        return score(t, batch)

    fleet._score = recording
    now = time.perf_counter()
    # (tenant, seconds to its deadline); equal deadlines tie on
    # last_served
    plan = [("a", 30), ("b", 10), ("c", 20), ("a", 5), ("b", 40),
            ("c", 10), ("a", 50), ("b", 10), ("c", 60)]
    fleet._running = True                # queue before the worker starts
    reqs = [(t, fleet.submit(np.zeros((1, COLS)), tenant=t,
                             deadline=now + s)) for t, s in plan]
    fleet._running = False
    with fleet:
        for t, r in reqs:
            fleet.wait(r, tenant=t, timeout=10.0)
    return order


def test_edf_order_equals_jax(models):
    """EDF over the tenants' heads, least recently served first on a tie:
    the port's fleet scores the tenants in the JAX fleet's order."""
    text = {n: models[n].model_to_string() for n in ("a", "b", "c")}
    got = _edf_order(ModelFleet,
                     lambda f, n: f.add_model(n, text[n]),
                     {"engine": "host", "device_type": "cpu"})
    want = _edf_order(js.ModelFleet,
                      lambda f, n: f.add_model(n, text[n]),
                      {"engine": "host"})
    assert got == want
    assert len(got) == 9


def test_fleet_stop_thread_hygiene(models):
    fleet = _fleet(fused=True)
    fleet.add_model("t", models["a"])
    fleet.start()
    assert fleet.alive()
    _wait_fused(fleet, names=("t",))
    fleet.stop()
    assert not any(t.name.startswith(("serving-fleet", "fleet-fused"))
                   for t in threading.enumerate())


def test_fused_cross_tenant_batch(models):
    """Requests of three tenants land in ONE fused batch (no tenant
    switch), each answer bitwise its tenant's own session; f32 requests
    bin through the stacked bucketize."""
    X = models["X"]
    qs = {"a": X[:5], "b": X[5:9].astype(np.float32), "c": X[9:15]}
    with _fleet(fused=True, max_wait_ms=100.0) as fleet:
        for n in ("a", "b", "c"):
            fleet.add_model(n, models[n])
        _wait_fused(fleet, names=("a", "b", "c"))
        reqs = {n: fleet.submit(q, tenant=n) for n, q in qs.items()}
        outs = {n: fleet.wait(r, tenant=n, timeout=30.0)
                for n, r in reqs.items()}
        for n, q in qs.items():
            assert _md5(outs[n]) == _md5(fleet.session(n).predict(q)), n
        d = fleet.metrics_dict()["fleet"]["scheduler"]
        assert d["fused"] is True
        assert d["fused_batches"] >= 1
        assert d["fused_rows"] == sum(q.shape[0] for q in qs.values())
        assert d["tenant_switches"] == 0
        assert sorted(d["served"]) == ["a", "b", "c"]
        # an all-f32 mixed batch through the scorer the fleet publishes
        f32 = [("b", X[:3].astype(np.float32)),
               ("c", X[3:7].astype(np.float32))]
        for (n, q), m in zip(f32, fleet._fused_scorer.score_groups(f32)):
            assert _md5(m) == _md5(fleet.session(n).score_margin(q))


def test_fused_hot_swap_republish(models):
    """promote() marks the supertensor dirty; the background rebuild
    republishes a new generation and the promoted tenant's fused answers
    are its NEW session's, bitwise. Until then it drains unfused."""
    X = models["X"]
    with _fleet(fused=True) as fleet:
        for n in ("a", "b"):
            fleet.add_model(n, models[n])
        _wait_fused(fleet, names=("a", "b"))
        gen0 = fleet.fused_generation
        fleet.promote("b", models["c"])
        out = fleet.predict(X[:6], tenant="b")
        assert _md5(out) == _md5(fleet.session("b").predict(X[:6]))
        _wait_fused(fleet, gen=gen0)
        assert fleet.fused_generation > gen0
        before = fleet.fused_batches
        out = fleet.predict(X[:6], tenant="b")
        assert fleet.fused_batches > before
        assert _md5(out) == _md5(fleet.session("b").predict(X[:6]))
        np.testing.assert_allclose(out, models["c"].predict(X[:6]),
                                   rtol=1e-6, atol=1e-6)


def test_fused_ineligible_tenant_drains_unfused(models, tmp_path):
    """A text-loaded tenant on the host engine stays out of the
    supertensor and serves unfused beside a fused neighbour (the port's
    binned engine raises without mappers where the JAX package's falls
    back to the host, so the tenant asks for the host engine); a
    text-loaded tenant given its mappers joins it."""
    X = models["X"]
    path = tmp_path / "m.txt"
    models["a"].save_model(str(path))
    with _fleet(fused=True) as fleet:
        fleet.add_model("fusable", models["c"])
        fleet.add_model("hosty", str(path), engine="host")
        fleet.add_model("file", str(path),
                        bin_mappers=mappers_for(models["a"]._gbdt))
        assert fleet.session("hosty").engine == "host"
        assert fleet.session("file").engine == "binned"
        _wait_fused(fleet, names=("fusable", "file"))
        assert not fleet._fused_scorer.can_serve("hosty")
        out_h = fleet.predict(X[:6], tenant="hosty")
        out_f = fleet.predict(X[:6], tenant="fusable")
        out_m = fleet.predict(X[:6], tenant="file")
        assert _md5(out_h) == _md5(models["a"].predict(X[:6]))
        assert _md5(out_f) == _md5(fleet.session("fusable").predict(X[:6]))
        assert _md5(out_m) == _md5(fleet.session("file").predict(X[:6]))
        d = fleet.metrics_dict()["fleet"]["scheduler"]
        assert d["fused_batches"] >= 2
        assert d["batches"] >= 3


def test_fused_shards_refused():
    """fused_num_shards=2 on one device rounds to 1 at construction, with
    the JAX package's warning; the fused scorer then runs unsharded."""
    fleet, logs = _with_warnings(lambda: ModelFleet(
        fused=True, fused_num_shards=2,
        session_opts={"device_type": "cpu"}))
    assert fleet.fused_num_shards == 1
    assert any("fused num_shards=2 rounded to 1 (power of two, 1 devices)"
               in m for m in logs), logs


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


def _http(host, port, path, data=None, headers=None):
    r = urllib.request.Request(f"http://{host}:{port}{path}", data=data,
                               headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_fleet_http_routes_match_jax(models):
    """The fleet front end of both packages on the same requests: per
    tenant routes, the X-Model header, unknown tenants and routes, a
    malformed body, /metrics, /healthz, /readyz: the same status codes,
    and the same answers within 1e-6."""
    X = models["X"]
    text = {n: models[n].model_to_string() for n in ("a", "b")}
    cfg = types.SimpleNamespace(serve_host="127.0.0.1", serve_port=0,
                                serve_deadline_header="X-Deadline-Ms",
                                serve_deadline_ms=0.0)
    body = json.dumps({"rows": X[:3].tolist()}).encode()
    calls = [("/predict/alpha", body, None), ("/predict", body,
                                              {"X-Model": "beta"}),
             ("/predict/nope", body, None), ("/other", body, None),
             ("/predict/alpha", b"[[1, 2], [3]]", None),
             ("/metrics", None, None), ("/healthz", None, None),
             ("/readyz", None, None), ("/nothing", None, None)]
    seen = {}
    for name, mod, opts, build in (
            ("torch", ModelFleet, {"engine": "host", "device_type": "cpu"},
             build_fleet_http_server),
            ("jax", js.ModelFleet, {"engine": "host"}, j_fleet_server)):
        fleet = mod(max_batch=16, max_wait_ms=1.0, session_opts=opts)
        fleet.add_model("alpha", text["a"])
        fleet.add_model("beta", text["b"])
        with fleet:
            server = build(cfg, fleet)
            host, port = server.server_address
            st = threading.Thread(target=server.serve_forever, daemon=True)
            st.start()
            try:
                seen[name] = [_http(host, port, p, d, h)
                              for p, d, h in calls]
            finally:
                server.shutdown()
                server.server_close()
                st.join(timeout=5.0)
    codes = [c for c, _ in seen["torch"]]
    assert codes == [c for c, _ in seen["jax"]]
    assert codes == [200, 200, 404, 404, 400, 200, 200, 200, 404]
    for i in (0, 1):
        np.testing.assert_allclose(seen["torch"][i][1]["predictions"],
                                   seen["jax"][i][1]["predictions"],
                                   rtol=1e-6, atol=1e-6)
    assert sorted(seen["torch"][5][1]["fleet"]["tenants"]) == \
        ["alpha", "beta"]
    assert seen["torch"][7][1]["tenants"] == ["alpha", "beta"]
