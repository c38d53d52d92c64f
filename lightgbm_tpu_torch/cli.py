"""The command-line application.

Counterpart of lightgbm_tpu/cli.py, which mirrors the reference CLI
(src/main.cpp + src/application/application.cpp):

    python -m lightgbm_tpu_torch config=train.conf [key=value ...]

with task = train | predict | refit | convert_model | serve | online.
Config files are `key = value` lines with `#` comments
(Application::LoadParameters, application.cpp:54); the command line
overrides the file, GNU switches
(`--profile`, `--key=value`) and aliases included. The run takes
`device_type` like any other parameter: "cuda" by default, "cpu" on
request. Training reads text files (data/loader.py, through the native
parser), takes valid files, `input_model`, `snapshot_freq` snapshots with
checksum manifests, checkpoints and resume (runtime/checkpoint.py), and
`device_profile` with `profile_output` (runtime/profiler.py).
`task=serve` serves one model (run_serve: the registry with snapshot
watching, the micro-batcher, admission control and the circuit breaker,
over HTTP at serve_port > 0, else a file or stdin), or, with
`serve_models="name=path,..."`, a multi-tenant fleet (run_serve_fleet:
serving/fleet.py; `serve_fused=true` is fatal there, since a model file
carries no bin mappers for the fused drain);
`task=convert_model convert_model_language=torch_export data=<training
file>` writes the exported serving artifact (export/compile.py).
`task=online` runs the online loop (run_online: online/, with
co-located serving under `online_serve=true`).
`convert_model_language=stablehlo` is fatal (the port writes no
StableHLO). `task=train` with a distributed tree_learner and
`num_machines=N` under the launcher (`python -m lightgbm_tpu_torch.launch
-n N -- python -m lightgbm_tpu_torch config=...`) trains through the same
Booster path, one rank a process; `serve_num_shards` /
`serve_fused_shards` shard scoring over the local cards.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .config import canonical_name, resolve_params
from .data.loader import load_text_file
from .engine import train as engine_train
from .runtime.checkpoint import atomic_write_text, write_manifest
from .utils.log import log_fatal, log_info


def parse_config_file(path: str) -> Dict[str, str]:
    """reference: Application::LoadParameters reads key=value lines."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def parse_args(argv: List[str]) -> Dict[str, str]:
    """The run's params, canonical names, the command line over the
    config file (application.cpp:64-68)."""
    params: Dict[str, str] = {}
    for arg in argv:
        # GNU-style switches map onto config params: `--profile` ->
        # device_profile=true (through the alias table), `--key=value` ->
        # key=value
        if arg.startswith("--"):
            arg = arg[2:]
            if "=" not in arg:
                arg += "=true"
        if "=" not in arg:
            log_fatal(f"Unknown CLI argument: {arg} (expected key=value)")
        k, v = arg.split("=", 1)
        params[canonical_name(k.strip().replace("-", "_"))] = v.strip()
    if "config" in params:
        file_params = {canonical_name(k): v for k, v in
                       parse_config_file(params.pop("config")).items()}
        # canonical keys, so an aliased argument beats its file twin
        file_params.update(params)
        params = file_params
    return params


def _load_text(cfg, path: str):
    return load_text_file(
        path, has_header=cfg.header, label_column=cfg.label_column,
        weight_column=cfg.weight_column, group_column=cfg.group_column,
        ignore_column=cfg.ignore_column)


def _load_dataset_from_config(cfg, path: str,
                              reference: Optional[Dataset] = None
                              ) -> Dataset:
    X, y, w, group, names = _load_text(cfg, path)
    if reference is not None:
        return reference.create_valid(X, label=y, weight=w, group=group)
    return Dataset(X, label=y, weight=w, group=group,
                   feature_name=list(names))


def _snapshot_callback(cfg):
    """Model snapshots every snapshot_freq iterations (GBDT::Train,
    gbdt.cpp:259-263): `<output_model>.snapshot_iter_<k>.txt`, written
    atomically, with a checksum manifest beside it."""
    def _snapshot(env):
        it = env.iteration + 1
        if it % cfg.snapshot_freq == 0:
            path = f"{cfg.output_model}.snapshot_iter_{it}.txt"
            env.model.save_model(path)
            write_manifest(path)
    return _snapshot


def run_train(params: Dict[str, Any], cfg) -> None:
    train_set = _load_dataset_from_config(cfg, cfg.data)
    valid_sets, valid_names = [], []
    valid_paths = cfg.valid if isinstance(cfg.valid, list) else (
        [v for v in str(cfg.valid).split(",") if v])
    for vp in valid_paths:
        valid_sets.append(_load_dataset_from_config(cfg, vp, train_set))
        valid_names.append(vp.rsplit("/", 1)[-1])
    callbacks = ([_snapshot_callback(cfg)] if cfg.snapshot_freq > 0
                 else None)
    booster = engine_train(params, train_set,
                           num_boost_round=cfg.num_iterations,
                           valid_sets=valid_sets, valid_names=valid_names,
                           init_model=cfg.input_model or None,
                           callbacks=callbacks)
    booster.save_model(cfg.output_model)
    if cfg.device_profile:
        profile = booster.get_profile()
        if profile is not None:
            text = json.dumps(profile, indent=2)
            if cfg.profile_output:
                atomic_write_text(cfg.profile_output, text + "\n")
                log_info(f"Device profile saved to {cfg.profile_output}")
            print(text)
    log_info(f"Finished training; model saved to {cfg.output_model}")


def _input_booster(params: Dict[str, Any], cfg, task: str) -> Booster:
    """The input_model, predicting on the run's device_type."""
    if not cfg.input_model:
        log_fatal(f"task={task} requires input_model")
    return Booster(params=params, model_file=cfg.input_model)


def run_predict(params: Dict[str, Any], cfg) -> None:
    booster = _input_booster(params, cfg, "predict")
    # drop the same non-feature columns as training, or features shift
    X, _, _, _, _ = _load_text(cfg, cfg.data)
    pred = booster.predict(
        X, raw_score=cfg.predict_raw_score,
        pred_leaf=cfg.predict_leaf_index, pred_contrib=cfg.predict_contrib,
        start_iteration=cfg.start_iteration_predict,
        num_iteration=cfg.num_iteration_predict)
    out = np.asarray(pred)
    if out.ndim == 1:
        out = out[:, None]
    np.savetxt(cfg.output_result, out, delimiter="\t", fmt="%.18g")
    log_info(f"Finished prediction; results saved to {cfg.output_result}")


# IO and task keys: `data` collides with refit's positional argument, and
# the rest are CLI plumbing that must not reach the refit's params
_CLI_ONLY = frozenset((
    "task", "data", "valid", "decay_rate", "refit_decay_rate",
    "input_model", "output_model", "snapshot_freq", "header",
    "label_column", "weight_column", "group_column", "ignore_column",
    "save_binary", "start_iteration_predict", "num_iteration_predict",
    "predict_raw_score", "predict_leaf_index", "predict_contrib",
    "output_result", "convert_model",
))


def run_refit(params: Dict[str, Any], cfg) -> None:
    booster = _input_booster(params, cfg, "refit")
    X, y, _, _, _ = _load_text(cfg, cfg.data)
    refit_params = {k: v for k, v in params.items() if k not in _CLI_ONLY}
    booster = booster.refit(X, y, decay_rate=cfg.refit_decay_rate,
                            **refit_params)
    booster.save_model(cfg.output_model)
    log_info(f"Finished refit; model saved to {cfg.output_model}")


def run_convert_model(params: Dict[str, Any], cfg) -> None:
    """task=convert_model. `convert_model_language=cpp` (or "") writes the
    standalone if-else C++ (Application::ConvertModel);
    `convert_model_language=torch_export` freezes the model into an
    exported serving artifact directory (export/compile.py), the port's
    counterpart of the JAX package's `stablehlo` artifact. It needs the
    frozen per-feature bin edges, which model text files do not carry:
    pass `data=<training file>` (with the same binning params) and they
    are re-derived deterministically (lightgbm_tpu/cli.py:796-846)."""
    if cfg.convert_model_language == "stablehlo":
        log_fatal("convert_model_language=stablehlo writes the JAX "
                  "package's StableHLO artifact, which lightgbm_tpu_torch "
                  "cannot write; use convert_model_language=torch_export "
                  "(the exported serving artifact)")
    booster = _input_booster(params, cfg, "convert_model")
    if cfg.convert_model_language == "torch_export":
        if not cfg.data:
            log_fatal(
                "convert_model_language=torch_export requires data=<training "
                "file>: models loaded from text carry no frozen BinMapper "
                "tables, so the bin edges are re-derived from the training "
                "data (same data + binning params => identical bins)")
        from .export.compile import export_model
        X, y, w, group, names = _load_text(cfg, cfg.data)
        h = Dataset(X, label=y, weight=w, group=group,
                    feature_name=list(names),
                    params=dict(params)).construct()._handle
        # per-ORIGINAL-feature mappers (the handle's are inner-indexed)
        mappers = [None] * (int(max(h.real_feature_index)) + 1
                            if len(h.real_feature_index) else 0)
        for inner, orig in enumerate(h.real_feature_index):
            if inner < len(h.mappers):
                mappers[orig] = h.mappers[inner]
        out_dir = cfg.convert_model \
            if cfg.convert_model not in ("", "gbdt_prediction.cpp") \
            else "compiled_model"
        try:
            export_model(booster, out_dir, bin_mappers=mappers,
                         max_batch=cfg.serve_max_batch,
                         min_bucket=cfg.serve_min_bucket,
                         start_iteration=cfg.start_iteration_predict,
                         num_iteration=cfg.num_iteration_predict)
        except ValueError as e:
            log_fatal(str(e))
        log_info(f"Finished converting model; exported artifact saved to "
                 f"{out_dir}")
        return
    out = cfg.convert_model or "gbdt_prediction.cpp"
    atomic_write_text(out, booster.dump_model_to_cpp())
    log_info(f"Finished converting model; saved to {out}")


def _parse_rows(text: str) -> np.ndarray:
    """Request body -> [n, F] f64: JSON (list-of-rows or {"rows": ...})
    or delimited lines (tab / comma / space)."""
    text = text.strip()
    if text.startswith("{") or text.startswith("["):
        import json
        obj = json.loads(text)
        if isinstance(obj, dict):
            obj = obj.get("rows", obj.get("data"))
        rows = np.asarray(obj, np.float64)
    else:
        rows = np.asarray(
            [[float(t) if t.lower() not in ("", "na", "nan") else np.nan
              for t in line.replace(",", "\t").split()]
             for line in text.replace("\t", " ").splitlines() if line.strip()],
            np.float64)
    return rows.reshape(1, -1) if rows.ndim == 1 else rows


# one POST body may not exceed this many bytes (HTTP 413): bounds the
# memory one client can pin before admission control even runs
_MAX_BODY_BYTES = 32 << 20


def _handler_base(cfg):
    """The request handler both HTTP front ends share (lightgbm_tpu/cli.py
    build_http_server / build_fleet_http_server): JSON replies with an
    integer ``Retry-After`` on a shed, the per-request deadline (the
    ``serve_deadline_header`` header in ms, else ``serve_deadline_ms``),
    the body read (413 past _MAX_BODY_BYTES, 400 malformed) and the
    overload status codes of one prediction."""
    import http.server
    import math
    import time as _time

    from .serving import QueueFullError, RequestTimeout, ShedError

    deadline_hdr = getattr(cfg, "serve_deadline_header", "") or "X-Deadline-Ms"
    default_deadline_ms = float(getattr(cfg, "serve_deadline_ms", 0.0) or 0.0)

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):   # keep serving stdout quiet
            pass

        def _send(self, code: int, obj, retry_after_s: float = 0.0) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after_s > 0.0:
                # HTTP Retry-After is integer seconds; round UP so a
                # compliant client never retries into the same shed
                self.send_header("Retry-After",
                                 str(max(int(math.ceil(retry_after_s)), 1)))
            self.end_headers()
            self.wfile.write(body)

        def _deadline(self):
            ms = self.headers.get(deadline_hdr)
            ms = float(ms) if ms is not None else default_deadline_ms
            if ms <= 0.0:
                return None
            return _time.perf_counter() + ms / 1e3

        def _predict(self, predict) -> None:
            """Read the body's rows and answer predict(rows, client,
            deadline) with the status code of its outcome: 200, 429 / 503
            (shed, queue full) with Retry-After, 504 (deadline or
            timeout), 413 (oversize body), 400 (malformed)."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > _MAX_BODY_BYTES:
                    return self._send(413, {
                        "error": f"request body {n} bytes exceeds the "
                                 f"{_MAX_BODY_BYTES}-byte limit"})
                raw = self.rfile.read(n).decode()
                deadline = self._deadline()
            except Exception as e:
                return self._send(400, {"error": str(e)})
            try:
                rows = _parse_rows(raw)
                if rows.size == 0 or rows.ndim != 2:
                    raise ValueError("empty or non-rectangular row block")
            except Exception as e:
                return self._send(400, {"error": f"malformed body: {e}"})
            client = self.headers.get("X-Client") or self.client_address[0]
            try:
                pred = predict(rows, client, deadline)
                self._send(200, {"predictions":
                                 np.asarray(pred).tolist()})
            except ShedError as e:
                # 429 (rate limit) or 503 (overload): never queued
                self._send(e.http_status, {"error": str(e)},
                           retry_after_s=e.retry_after_s)
            except QueueFullError as e:
                self._send(503, {"error": str(e)}, retry_after_s=1.0)
            except RequestTimeout as e:
                self._send(504, {"error": str(e)})
            except Exception as e:
                self._send(400, {"error": str(e)})

        def _health(self, alive: bool, wedged: bool) -> None:
            ok = alive and not wedged
            self._send(200 if ok else 503, {
                "status": "ok" if ok else "unhealthy",
                "worker_alive": alive, "worker_wedged": wedged})

    return Handler


def build_http_server(cfg, registry, batcher, metrics,
                      admission=None, breaker=None):
    """Threaded HTTP front-end (lightgbm_tpu/cli.py build_http_server).
    Routes:

      POST /predict  — score rows; overload protection maps to status
                       codes: 429 (rate limited) / 503 (shed, queue
                       full) with ``Retry-After``, 504 (deadline or
                       timeout), 413 (oversize body), 400 (malformed)
      GET /metrics   — serving summary JSON
      GET /health    — legacy liveness (kept for old probes)
      GET /healthz   — liveness: worker thread alive and not wedged
      GET /readyz    — readiness: a model is registered and scoring is
                       possible; body reports breaker/shedding state

    A per-request deadline comes from the ``serve_deadline_header``
    header (ms, overrides) or ``serve_deadline_ms`` (default budget);
    clients are keyed for rate limiting by ``X-Client`` or their
    address. Factory so tests can bind port 0 and read back
    ``server.server_address``; ``serve_forever`` is the caller's call.
    """
    import http.server

    def predict(rows, client, deadline):
        if admission is not None:
            return admission.predict(rows, client=client, deadline=deadline)
        return batcher.predict(rows, deadline=deadline)

    class Handler(_handler_base(cfg)):
        def do_GET(self):
            if self.path == "/metrics":
                self._send(200, metrics.to_dict())
            elif self.path == "/health":
                self._send(200, {"status": "ok",
                                 "models": registry.names()})
            elif self.path == "/healthz":
                self._health(batcher.alive(), batcher.wedged())
            elif self.path == "/readyz":
                models = registry.names()
                ok = bool(models) and batcher.alive()
                body = {"status": "ready" if ok else "not_ready",
                        "models": models,
                        "queue_depth": batcher.depth,
                        "states": dict(metrics.states)}
                if breaker is not None:
                    body["breaker"] = breaker.to_dict()
                # an OPEN breaker or active shedding still serves (host
                # fallback / partial admission): degraded, not unready
                self._send(200 if ok else 503, body)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                return self._send(404, {"error": f"no route {self.path}"})
            self._predict(predict)

    return http.server.ThreadingHTTPServer(
        (cfg.serve_host, cfg.serve_port), Handler)


def build_fleet_http_server(cfg, fleet):
    """Threaded HTTP front-end for a multi-tenant ModelFleet
    (lightgbm_tpu/cli.py build_fleet_http_server). Routes:

      POST /predict/<tenant>  — score rows against one tenant's model
      POST /predict           — tenant from the ``X-Model`` header
                                (default tenant key: "default")
      GET /metrics            — fleet export: per-tenant summaries,
                                scheduler fairness, stages_by_tenant
      GET /health /healthz /readyz — as the single-model server, with
                                per-tenant breaker/shedding states

    Per-request deadlines, client keying and status codes are those of
    :func:`build_http_server`; unknown tenants map to 404."""
    import http.server

    class Handler(_handler_base(cfg)):
        def do_GET(self):
            if self.path == "/metrics":
                self._send(200, fleet.metrics_dict())
            elif self.path == "/health":
                self._send(200, {"status": "ok",
                                 "tenants": fleet.tenant_names()})
            elif self.path == "/healthz":
                self._health(fleet.alive(), fleet.wedged())
            elif self.path == "/readyz":
                tenants = fleet.tenant_names()
                ok = bool(tenants) and fleet.alive()
                self._send(200 if ok else 503, {
                    "status": "ready" if ok else "not_ready",
                    "tenants": tenants,
                    "queue_depth": fleet.depth,
                    "states": {n: dict(fleet._tenant(n).metrics.states)
                               for n in tenants},
                })
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path == "/predict":
                tenant = self.headers.get("X-Model") or "default"
            elif self.path.startswith("/predict/"):
                tenant = self.path[len("/predict/"):]
            else:
                return self._send(404, {"error": f"no route {self.path}"})
            if tenant not in fleet.tenant_names():
                return self._send(404, {
                    "error": f"no tenant {tenant!r} "
                             f"(have {fleet.tenant_names()})"})
            self._predict(lambda rows, client, deadline: fleet.predict(
                rows, tenant=tenant, client=client, deadline=deadline))

    return http.server.ThreadingHTTPServer(
        (cfg.serve_host, cfg.serve_port), Handler)


def run_serve_fleet(params: Dict[str, Any], cfg) -> None:
    """task=serve with serve_models="name=path,...": the multi-tenant
    fleet (lightgbm_tpu/cli.py run_serve_fleet), its models on the run's
    device_type. serve_port > 0 -> HTTP (POST /predict/<tenant>);
    data=<file> -> batch-score through the FIRST tenant; else stdin lines
    (first tenant). With serve_watch set (any non-empty value) every
    tenant watches its own model path as a snapshot prefix."""
    from .config import parse_serve_models
    from .runtime.faults import active_plan
    from .serving import ModelFleet
    # fail-fast parse (duplicates, empty names/paths), shared with
    # Config._validate so the CLI and programmatic configs agree
    entries = parse_serve_models(cfg.serve_models)
    if cfg.serve_fused:
        log_fatal(
            "serve_fused=true cannot fuse a tenant of serve_models: the "
            "fused drain scores binned forests, and a model file carries "
            "no BinMapper tables, so every tenant would drain unfused; "
            "fuse in process with ModelFleet(fused=True) and "
            "add_model(name, model, bin_mappers=...)")
    fault_plan = active_plan(cfg.fault_plan)
    fleet = ModelFleet(
        max_batch=cfg.serve_max_batch,
        max_wait_ms=cfg.serve_batch_wait_ms,
        queue_depth=cfg.serve_queue_depth,
        timeout_ms=cfg.serve_request_timeout_ms,
        raw_score=cfg.predict_raw_score, fault_plan=fault_plan,
        fused=cfg.serve_fused, fused_num_shards=cfg.serve_fused_shards,
        session_opts=dict(
            engine=cfg.serve_engine, min_bucket=cfg.serve_min_bucket,
            num_shards=cfg.serve_num_shards, warmup=cfg.serve_warmup,
            binning_impl=cfg.binning_impl, device_type=cfg.device_type,
            start_iteration=cfg.start_iteration_predict,
            num_iteration=cfg.num_iteration_predict),
        admission_opts=dict(
            rate_qps=cfg.serve_admission_rate_qps,
            burst=cfg.serve_admission_burst,
            queue_high=cfg.serve_admission_queue_high,
            queue_low=cfg.serve_admission_queue_low,
            p99_slo_ms=cfg.serve_admission_p99_slo_ms,
            shed_class=cfg.serve_admission_shed_class,
            occupancy_high=cfg.serve_admission_occupancy_high),
        breaker_opts=dict(
            failure_threshold=cfg.serve_breaker_failures,
            latency_slo_ms=cfg.serve_breaker_latency_slo_ms,
            latency_trips=cfg.serve_breaker_latency_trips,
            cooldown_s=cfg.serve_breaker_cooldown_s))
    for name, path in entries:
        fleet.add_model(name, path)
        if cfg.serve_watch:
            fleet.watch_snapshots(name, path,
                                  poll_s=cfg.serve_watch_poll_s,
                                  start=cfg.serve_port > 0)
    fleet.start()
    first = entries[0][0]
    try:
        if cfg.serve_port > 0:
            server = build_fleet_http_server(cfg, fleet)
            log_info(f"serving fleet ({len(entries)} tenants) on "
                     f"http://{server.server_address[0]}:"
                     f"{server.server_address[1]} (POST /predict/<tenant>, "
                     f"GET /metrics /health /healthz /readyz)")
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                server.server_close()
        elif cfg.data:
            X, _, _, _, _ = _load_text(cfg, cfg.data)
            results = []
            pending = []
            for i in range(X.shape[0]):
                pending.append(fleet.submit(X[i], tenant=first))
                if len(pending) >= min(cfg.serve_queue_depth, 512):
                    results.extend(fleet.wait(r, tenant=first)
                                   for r in pending)
                    pending = []
            results.extend(fleet.wait(r, tenant=first) for r in pending)
            out = np.concatenate([np.asarray(r) for r in results], axis=0)
            if out.ndim == 1:
                out = out[:, None]
            np.savetxt(cfg.output_result, out, delimiter="\t", fmt="%.18g")
            log_info(f"Finished serving {X.shape[0]} rows through tenant "
                     f"{first!r}; results saved to {cfg.output_result}")
        else:
            for line in sys.stdin:
                if not line.strip():
                    continue
                pred = np.asarray(fleet.predict(_parse_rows(line),
                                                tenant=first))
                print("\t".join(f"{v:.18g}" for v in pred.reshape(-1)))
    finally:
        fleet.stop()
        if cfg.serve_metrics_output:
            fleet.export_json(cfg.serve_metrics_output)
            log_info(
                f"Serving metrics saved to {cfg.serve_metrics_output}")


def build_serving(cfg, profiler=None):
    """task=serve's objects from its config: (metrics, breaker or None,
    registry, batcher), the batcher not started and no model registered.
    The breaker guards the device scoring path; a host-only deployment has
    nothing to degrade from, so it exists only when a device engine is in
    play and a trip condition is set (by default
    serve_breaker_failures=3). `profiler` goes to every session (the
    online loop's co-located serving shares the loop's)."""
    from .runtime.faults import active_plan
    from .serving import (CircuitBreaker, MicroBatcher, ModelRegistry,
                          ServingMetrics)
    metrics = ServingMetrics(max_batch=cfg.serve_max_batch)
    fault_plan = active_plan(cfg.fault_plan)
    breaker = None
    if cfg.serve_engine in ("auto", "device", "binned") and (
            cfg.serve_breaker_failures > 0
            or cfg.serve_breaker_latency_slo_ms > 0.0):
        breaker = CircuitBreaker(
            failure_threshold=cfg.serve_breaker_failures,
            latency_slo_ms=cfg.serve_breaker_latency_slo_ms,
            latency_trips=cfg.serve_breaker_latency_trips,
            cooldown_s=cfg.serve_breaker_cooldown_s, metrics=metrics)
    registry = ModelRegistry(
        metrics=metrics, engine=cfg.serve_engine,
        max_batch=cfg.serve_max_batch, min_bucket=cfg.serve_min_bucket,
        num_shards=cfg.serve_num_shards, warmup=cfg.serve_warmup,
        binning_impl=cfg.binning_impl, device_type=cfg.device_type,
        start_iteration=cfg.start_iteration_predict,
        num_iteration=cfg.num_iteration_predict,
        breaker=breaker, fault_plan=fault_plan, profiler=profiler)
    batcher = MicroBatcher(
        lambda X: registry.predict(X, raw_score=cfg.predict_raw_score),
        max_batch=cfg.serve_max_batch, max_wait_ms=cfg.serve_batch_wait_ms,
        queue_depth=cfg.serve_queue_depth,
        timeout_ms=cfg.serve_request_timeout_ms, metrics=metrics,
        fault_plan=fault_plan)
    return metrics, breaker, registry, batcher


def run_serve(params: Dict[str, Any], cfg) -> None:
    """task=serve: score via the serving engine (registry + batcher).
    serve_port > 0 -> HTTP; data=<file> -> batch-score the file (output
    bit-identical to task=predict on the host engine); else stdin lines.
    The models run on the run's device_type. serve_models="name=path,..."
    switches to the multi-tenant fleet (run_serve_fleet)."""
    if cfg.serve_models:
        return run_serve_fleet(params, cfg)
    if not cfg.input_model:
        log_fatal("task=serve requires input_model")
    from .serving import AdmissionController
    metrics, breaker, registry, batcher = build_serving(cfg)
    registry.register("default", cfg.input_model)
    if cfg.serve_watch:
        # when the process booted on a snapshot file, its iteration seeds
        # the already-served floor so the watcher doesn't re-promote the
        # very model it just loaded (registry also persists the floor
        # across restarts in <prefix>.watch_state.json)
        from .serving.registry import _SNAP_RE
        m = _SNAP_RE.search(str(cfg.input_model))
        registry.watch_snapshots("default", cfg.serve_watch,
                                 poll_s=cfg.serve_watch_poll_s,
                                 start=cfg.serve_port > 0,
                                 initial_iter=int(m.group(1)) if m else -1)
    batcher.start()
    # admission control only fronts the HTTP path: file/stdin modes are
    # the caller's own rows — there is no one to shed for. With default
    # knobs it is pure depth-watermark shedding (engage at 80% queue);
    # rate limits and the latency watermark are opt-in
    admission = None
    if cfg.serve_port > 0:
        admission = AdmissionController(
            batcher, metrics=metrics,
            rate_qps=cfg.serve_admission_rate_qps,
            burst=cfg.serve_admission_burst,
            queue_high=cfg.serve_admission_queue_high,
            queue_low=cfg.serve_admission_queue_low,
            p99_slo_ms=cfg.serve_admission_p99_slo_ms,
            shed_class=cfg.serve_admission_shed_class)
    try:
        if cfg.serve_port > 0:
            server = build_http_server(cfg, registry, batcher, metrics,
                                       admission=admission, breaker=breaker)
            log_info(f"serving on http://{server.server_address[0]}:"
                     f"{server.server_address[1]} (POST /predict, "
                     f"GET /metrics /health /healthz /readyz)")
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                server.server_close()
        elif cfg.data:
            X, _, _, _, _ = _load_text(cfg, cfg.data)
            # per-row submits in waves: exercises the coalescing path a
            # live deployment sees, result order preserved
            results = []
            pending = []
            for i in range(X.shape[0]):
                pending.append(batcher.submit(X[i]))
                if len(pending) >= min(cfg.serve_queue_depth, 512):
                    results.extend(batcher.wait(r) for r in pending)
                    pending = []
            results.extend(batcher.wait(r) for r in pending)
            out = np.concatenate([np.asarray(r) for r in results], axis=0)
            if out.ndim == 1:
                out = out[:, None]
            np.savetxt(cfg.output_result, out, delimiter="\t", fmt="%.18g")
            log_info(f"Finished serving {X.shape[0]} rows; results saved "
                     f"to {cfg.output_result}")
        else:
            for line in sys.stdin:
                if not line.strip():
                    continue
                pred = np.asarray(batcher.predict(_parse_rows(line)))
                print("\t".join(f"{v:.18g}" for v in pred.reshape(-1)))
    finally:
        batcher.stop()
        registry.stop_watchers()
        if cfg.serve_metrics_output:
            metrics.export_json(cfg.serve_metrics_output)
            log_info(
                f"Serving metrics saved to {cfg.serve_metrics_output}")


def run_online(params: Dict[str, Any], cfg) -> None:
    """task=online: stream, refit or warm-continue, publish (online/;
    lightgbm_tpu/cli.py run_online). ``data=`` is the original training
    file, whose frozen bin mappers bin every streamed batch; the anchor is
    ``input_model``, else a model trained on ``data`` first (saved to
    ``output_model``). ``online_serve=true`` serves in the same process
    with task=serve's stack (``build_serving``: the registry, the
    micro-batcher, the breaker; admission and the HTTP server at
    serve_port > 0), which every published refresh hot-swaps: directly
    (``online_publish_mode`` direct / both) or through the registry's
    snapshot watcher (files). The newest snapshot is then copied to
    ``output_model``."""
    if not cfg.online_source:
        log_fatal("task=online requires online_source=<directory to "
                  "tail or .npz trace>")
    if not cfg.data:
        log_fatal("task=online requires data= (the original training "
                  "data; its frozen bin mappers bin the stream)")
    from .online import OnlineTrainer, SnapshotPublisher, open_source
    from .runtime.faults import active_plan
    from .utils import resolve_device
    fault_plan = active_plan(cfg.fault_plan)

    base_ds = _load_dataset_from_config(cfg, cfg.data)
    base_ds.params = {**base_ds.params, **params}
    base_ds.construct()
    if cfg.input_model:
        with open(cfg.input_model) as f:
            base_model = f.read()
    else:
        log_info("task=online: no input_model; training the base model "
                 f"offline on {cfg.data} first")
        booster = engine_train(params, base_ds,
                               num_boost_round=cfg.num_iterations)
        booster.save_model(cfg.output_model)
        base_model = booster.model_to_string()

    profiler = None
    if cfg.device_profile:
        from .runtime.profiler import StageProfiler
        profiler = StageProfiler(device=resolve_device(cfg.device_type))

    metrics = registry = batcher = server = serve_thread = None
    if cfg.online_serve:
        import threading

        from .serving import AdmissionController
        metrics, breaker, registry, batcher = build_serving(
            cfg, profiler=profiler)
        # a model text carries no bin mappers: the binned engine takes
        # the base data's, and the registry carries them across promotes
        h = base_ds._handle
        mappers = [None] * h.num_total_features
        for inner, orig in enumerate(h.real_feature_index):
            mappers[orig] = h.mappers[inner]
        registry.register("default", base_model, bin_mappers=mappers)
        if cfg.online_publish_mode == "files":
            # file-only publication still hot-swaps the co-located
            # session, through the registry's snapshot watcher
            registry.watch_snapshots("default", cfg.output_model,
                                     poll_s=cfg.serve_watch_poll_s,
                                     start=True)
        batcher.start()
        if cfg.serve_port > 0:
            admission = AdmissionController(
                batcher, metrics=metrics,
                rate_qps=cfg.serve_admission_rate_qps,
                burst=cfg.serve_admission_burst,
                queue_high=cfg.serve_admission_queue_high,
                queue_low=cfg.serve_admission_queue_low,
                p99_slo_ms=cfg.serve_admission_p99_slo_ms,
                shed_class=cfg.serve_admission_shed_class,
                occupancy_high=cfg.serve_admission_occupancy_high)
            server = build_http_server(cfg, registry, batcher, metrics,
                                       admission=admission,
                                       breaker=breaker)
            serve_thread = threading.Thread(target=server.serve_forever,
                                            name="online-http",
                                            daemon=True)
            serve_thread.start()
            log_info(f"online serving on http://"
                     f"{server.server_address[0]}:"
                     f"{server.server_address[1]}")

    publisher = SnapshotPublisher(prefix=cfg.output_model,
                                  mode=cfg.online_publish_mode,
                                  registry=registry, model_name="default")
    source = open_source(cfg.online_source, fault_plan=fault_plan)
    trainer = OnlineTrainer(
        params, base_model, base_ds, source, publisher,
        profiler=profiler, fault_plan=fault_plan,
        checkpoint_dir=cfg.checkpoint_dir,
        checkpoint_retention=cfg.checkpoint_retention)
    try:
        summary = trainer.run()
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            serve_thread.join(timeout=5.0)
        if batcher is not None:
            batcher.stop()
            registry.stop_watchers()
            if cfg.serve_metrics_output:
                metrics.export_json(cfg.serve_metrics_output)
                log_info(f"Serving metrics saved to "
                         f"{cfg.serve_metrics_output}")
    if publisher.last_iteration >= 0 and \
            cfg.online_publish_mode in ("files", "both"):
        # the newest snapshot is also the output model, so task=predict
        # input_model=<output_model> serves what the loop published last
        with open(publisher.snapshot_path(publisher.last_iteration)) as f:
            atomic_write_text(cfg.output_model, f.read())
    if profiler is not None:
        text = profiler.export_json(cfg.profile_output)
        if cfg.profile_output:
            log_info(f"Online profile saved to {cfg.profile_output}")
        else:
            print(text)
    log_info("online loop finished: " + json.dumps(summary, sort_keys=True))


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    params = parse_args(argv)
    cfg = resolve_params(dict(params))
    task = cfg.task
    log_info(f"lightgbm_tpu_torch CLI: task={task}")
    if task == "train":
        run_train(params, cfg)
    elif task in ("predict", "prediction", "test"):
        run_predict(params, cfg)
    elif task == "refit":
        run_refit(params, cfg)
    elif task == "convert_model":
        run_convert_model(params, cfg)
    elif task == "serve":
        run_serve(params, cfg)
    elif task == "online":
        run_online(params, cfg)
    else:
        log_fatal(f"Unknown task: {task}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
