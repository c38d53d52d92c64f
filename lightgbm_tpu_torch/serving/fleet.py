"""Multi-tenant serving fleet: one device, many models.

Counterpart of lightgbm_tpu/serving/fleet.py. A :class:`ModelFleet` owns
ONE scoring worker (the card is a serially shared resource: batches from
different models cannot overlap on it anyway) and many tenant-keyed serving
stacks. Each tenant gets its OWN :class:`~.registry.ModelRegistry`
(hot-swap + snapshot watcher), :class:`~.metrics.ServingMetrics`
(QPS / p50 / p99 / occupancy never aggregate across models),
:class:`~.breaker.CircuitBreaker` (a misbehaving model degrades ITSELF to
host scoring, not the fleet) and :class:`~.admission.AdmissionController`
over a private bounded queue (one tenant's flash crowd sheds at its own
watermark; its neighbours' queues stay shallow).

The fleet scheduler does continuous batching across tenants: the worker
loop picks the tenant whose HEAD request has the earliest effective
deadline (requests without an explicit deadline are due at ``t_enqueue +
timeout``, so EDF degrades to cross-tenant FIFO), least-recently-served
breaking ties, then drains ONE batch from that tenant only. Coalescing
(waiting ``max_wait_ms`` for more rows) happens only while no other tenant
has queued work: a lone tenant gets the latency of a dedicated
:class:`~.batcher.MicroBatcher`, a busy fleet never idles the card to top
up a batch.

``fused=True`` adds the fused drain (export/fusion.py): every
binned-capable tenant's forest is packed into one cross-tenant
supertensor, and when the EDF-primary tenant is covered by the current
:class:`~..export.fusion.FusedScorer` the worker assembles a MIXED-tenant
batch (still in EDF order, still up to ``max_batch`` rows) and scores it
in one fused walk with a per-row tenant id; all-f32 batches bin in one
launch of the stacked bucketize kernel. Tenants the supertensor cannot
cover (host engine, linear leaves) and tenants hot-swapped after the
supertensor was built drain unfused until the background
"fleet-fused-rebuild" thread republishes a fresh supertensor (triggered by
:meth:`start`, :meth:`add_model` and :meth:`promote`; the swap is atomic
and the new scorer is warmed up BEFORE publication). A fused-launch
failure is delivered to every request of that mixed batch: the wider blast
radius of sharing one launch.

Requests keep float32 rows as float32 (as the port's MicroBatcher does),
so f32 traffic takes each session's raw-f32 route (#6) unfused and the
stacked kernel fused; other rows are float64. The bins, and so the
margins, are the same either way.

Failure semantics mirror the single-model batcher: deadline-expired
requests are failed at batch assembly before scoring; a scoring error is
delivered to exactly the requests of that tenant's batch and the worker
keeps serving every other tenant; a FATAL worker error fails all queues,
marks the fleet stopped, and makes later submits fail fast naming the
cause. ``wedged()`` / ``alive()`` drive ``/healthz`` as on the
single-model path.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..runtime.profiler import StageProfiler
from ..utils.log import log_info, log_warning
from .admission import AdmissionController
from .batcher import QueueFullError, RequestTimeout, _Request
from .breaker import CircuitBreaker
from .metrics import ServingMetrics
from .registry import ModelRegistry


class _TenantQueue:
    """Per-tenant bounded request queue with the micro-batcher's submit/
    wait surface, so :class:`~.admission.AdmissionController` layers on
    top UNCHANGED. Requests live in a deque guarded by the fleet's
    shared condition; the scheduler peeks heads across tenants (which a
    ``queue.Queue`` cannot do) and the fleet worker drains it directly."""

    def __init__(self, fleet: "ModelFleet", tenant: str,
                 metrics: ServingMetrics) -> None:
        self._fleet = fleet
        self.tenant = tenant
        self.metrics = metrics
        self._q: "collections.deque[_Request]" = collections.deque()

    # -- health / shed accessors (admission.py expects these) ----------
    @property
    def depth(self) -> int:
        return len(self._q)

    @property
    def capacity(self) -> int:
        return self._fleet.queue_depth

    @property
    def max_batch(self) -> int:
        return self._fleet.max_batch

    def drop_oldest(self, error: Optional[BaseException] = None) -> bool:
        with self._fleet._cond:
            while self._q:
                r = self._q.popleft()
                if r.abandoned:
                    continue
                r.abandoned = True
                r.error = error if error is not None else \
                    RuntimeError("request shed (drop_oldest)")
                r.event.set()
                return True
            return False

    # -- request path ---------------------------------------------------
    def submit(self, x, deadline: Optional[float] = None) -> _Request:
        fleet = self._fleet
        if fleet._fatal is not None:
            raise RuntimeError(
                f"serving fleet worker died: {fleet._fatal!r}"
            ) from fleet._fatal
        if not fleet._running:
            raise RuntimeError("fleet not started")
        x = np.asarray(x)
        if x.dtype != np.float32:
            x = x.astype(np.float64)
        if x.ndim == 1:
            x = x.reshape(1, -1)
        req = _Request(x, time.perf_counter(), deadline=deadline)
        with fleet._cond:
            if len(self._q) >= fleet.queue_depth:
                self.metrics.inc("overflows")
                raise QueueFullError(
                    f"tenant {self.tenant!r} queue full "
                    f"({fleet.queue_depth} requests)")
            self._q.append(req)
            fleet._cond.notify_all()
        return req

    def wait(self, req: _Request, timeout: Optional[float] = None):
        if timeout is None:
            timeout = self._fleet.timeout_s if req.deadline is None else \
                max(req.deadline - time.perf_counter(), 0.0)
        if not req.event.wait(timeout):
            req.abandoned = True
            self.metrics.inc("timeouts")
            raise RequestTimeout(
                f"serving request timed out after {timeout * 1e3:.0f} ms")
        if req.error is not None:
            raise req.error
        self.metrics.record_request(
            time.perf_counter() - req.t_enqueue, req.n)
        return req.result

    def _expire(self, r: _Request) -> None:
        r.abandoned = True
        r.error = RequestTimeout(
            "request deadline expired after "
            f"{(time.perf_counter() - r.t_enqueue) * 1e3:.0f} ms in queue")
        r.event.set()
        self.metrics.inc("expired")


class _Tenant:
    """One tenant's isolated serving stack."""

    __slots__ = ("name", "metrics", "breaker", "registry", "queue",
                 "admission", "last_served", "batches")

    def __init__(self, name: str, metrics: ServingMetrics,
                 breaker: Optional[CircuitBreaker],
                 registry: ModelRegistry, queue: _TenantQueue,
                 admission: AdmissionController) -> None:
        self.name = name
        self.metrics = metrics
        self.breaker = breaker
        self.registry = registry
        self.queue = queue
        self.admission = admission
        self.last_served = 0.0        # perf_counter of last drained batch
        self.batches = 0              # batches drained for this tenant


class ModelFleet:
    """Tenant-keyed serving stacks sharing one scoring worker.

    ``session_opts`` become per-tenant :class:`~.session.ServingSession`
    defaults (``engine=\"binned\"``, ``num_shards=...``);
    ``admission_opts`` / ``breaker_opts`` seed each tenant's admission
    controller and circuit breaker. All three merge under per-tenant
    overrides passed to :meth:`add_model`.
    """

    def __init__(self, *, max_batch: int = 256, max_wait_ms: float = 2.0,
                 queue_depth: int = 256, timeout_ms: float = 1000.0,
                 raw_score: bool = False, fault_plan=None,
                 profiler: Optional[StageProfiler] = None,
                 session_opts: Optional[Dict[str, Any]] = None,
                 admission_opts: Optional[Dict[str, Any]] = None,
                 breaker_opts: Optional[Dict[str, Any]] = None,
                 fused: bool = False, fused_num_shards: int = 0) -> None:
        self.max_batch = max(int(max_batch), 1)
        self.max_wait_s = max(float(max_wait_ms), 0.0) / 1e3
        self.queue_depth = max(int(queue_depth), 1)
        self.timeout_s = float(timeout_ms) / 1e3
        self.raw_score = bool(raw_score)
        self.fault_plan = fault_plan
        # no device fencing: fleet spans time live traffic
        self.profiler = profiler if profiler is not None else \
            StageProfiler(barrier=lambda: None)
        self._session_opts = dict(session_opts or {})
        self._admission_opts = dict(admission_opts or {})
        self._breaker_opts = dict(breaker_opts or {})
        # one condition guards every tenant queue AND wakes the worker;
        # per-tenant locks would deadlock the cross-tenant head scan
        self._cond = threading.Condition()
        self._tenants: Dict[str, _Tenant] = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._fatal: Optional[BaseException] = None
        self._last_tenant: Optional[Any] = None
        self.last_beat = time.perf_counter()
        # observability: scheduler-level fairness counters
        self.batches = 0
        self.tenant_switches = 0
        self.worker_deaths = 0
        self.batch_sizes: List[int] = []
        # fused drain mode: cross-tenant supertensor (export/fusion.py),
        # rebuilt off-worker and republished atomically on hot-swap
        self.fused = bool(fused)
        if fused_num_shards > 1:
            # the fused scorer shards over the local cards; the count
            # rounds here, once, with the JAX package's warning
            from .session import resolve_shards
            dt = self._session_opts.get("device_type")
            dev = torch.device("cuda" if dt in (None, "cuda")
                               and torch.cuda.is_available() else "cpu")
            fused_num_shards = len(resolve_shards(
                fused_num_shards, dev, "fused num_shards")) or 1
        self.fused_num_shards = int(fused_num_shards)
        self._fused_scorer = None
        self._fused_dirty = False
        self._fused_thread: Optional[threading.Thread] = None
        self._fused_seq = 0
        # sentinel _last_tenant value: a fused launch keeps ONE resident
        # program regardless of the tenant mix, but a single-tenant
        # batch after a fused one re-switches the resident model
        self._FUSED = object()
        self.fused_generation = 0
        self.fused_batches = 0
        self.fused_rows = 0

    # ------------------------------------------------------------------
    # tenant management
    # ------------------------------------------------------------------
    def add_model(self, name: str, model: Any, *,
                  admission_opts: Optional[Dict[str, Any]] = None,
                  breaker_opts: Optional[Dict[str, Any]] = None,
                  **session_opts) -> _Tenant:
        """Deploy `model` under tenant key `name`: builds the tenant's
        whole isolated stack (metrics, breaker, registry + session,
        queue, admission). Callable before or after :meth:`start`; the
        session is built on the CALLER's thread so a slow warmup never
        stalls the scoring loop."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered "
                             f"(promote() hot-swaps an existing tenant)")
        metrics = ServingMetrics(max_batch=self.max_batch, tenant=name)
        bk = dict(self._breaker_opts)
        bk.update(breaker_opts or {})
        breaker = CircuitBreaker(metrics=metrics,
                                 name=f"device[{name}]", **bk)
        so = dict(self._session_opts)
        so.update(session_opts)
        so.setdefault("max_batch", self.max_batch)
        so.setdefault("breaker", breaker)
        if self.fault_plan is not None:
            so.setdefault("fault_plan", self.fault_plan)
        registry = ModelRegistry(metrics=metrics, **so)
        queue = _TenantQueue(self, name, metrics)
        ao = dict(self._admission_opts)
        ao.update(admission_opts or {})
        admission = AdmissionController(queue, metrics=metrics, **ao)
        t = _Tenant(name, metrics, breaker, registry, queue, admission)
        registry.register(name, model)
        with self._cond:
            self._tenants[name] = t
        log_info(f"serving fleet: added tenant {name!r} "
                 f"(engine={registry.session(name).engine})")
        if self._running:
            self._mark_fused_dirty()
        return t

    def promote(self, name: str, model: Any, **session_opts):
        """Hot-swap one tenant's model; every other tenant is untouched.
        In fused mode the supertensor is rebuilt in the background and
        republished atomically — until then the promoted tenant drains
        UNFUSED against its new session (never the stale fused copy)."""
        sess = self._tenant(name).registry.promote(
            name, model, **session_opts)
        self._mark_fused_dirty()
        return sess

    def watch_snapshots(self, name: str, model_prefix: str,
                        **kw) -> None:
        self._tenant(name).registry.watch_snapshots(name, model_prefix,
                                                    **kw)

    def poll_snapshots(self, name: str) -> Optional[int]:
        return self._tenant(name).registry.poll_snapshots(name)

    def session(self, name: str):
        return self._tenant(name).registry.session(name)

    def tenant_names(self) -> List[str]:
        with self._cond:
            return sorted(self._tenants)

    def _tenant(self, name: str) -> _Tenant:
        with self._cond:
            try:
                return self._tenants[name]
            except KeyError:
                raise KeyError(
                    f"no tenant {name!r} registered "
                    f"(have {sorted(self._tenants)})") from None

    # ------------------------------------------------------------------
    # lifecycle / health
    # ------------------------------------------------------------------
    def start(self) -> "ModelFleet":
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="serving-fleet-worker", daemon=True)
        self._thread.start()
        self._mark_fused_dirty()
        return self

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._fused_dirty = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._fused_thread is not None:
            self._fused_thread.join(timeout=10.0)
            self._fused_thread = None
        err = RuntimeError("fleet stopped")
        with self._cond:
            tenants = list(self._tenants.values())
        for t in tenants:
            with self._cond:
                stragglers = list(t.queue._q)
                t.queue._q.clear()
            for r in stragglers:
                r.error = err
                r.event.set()
            t.registry.stop_watchers()

    def __enter__(self) -> "ModelFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def depth(self) -> int:
        """Total queued requests across tenants (the /healthz signal)."""
        with self._cond:
            return sum(len(t.queue._q) for t in self._tenants.values())

    def alive(self) -> bool:
        return (self._running and self._fatal is None
                and self._thread is not None and self._thread.is_alive())

    def wedged(self, threshold_s: Optional[float] = None) -> bool:
        if threshold_s is None:
            threshold_s = max(0.5, 4.0 * self.max_wait_s,
                              2.0 * self.timeout_s)
        return (self.depth > 0
                and time.perf_counter() - self.last_beat > threshold_s)

    # ------------------------------------------------------------------
    # request path
    # ------------------------------------------------------------------
    def submit(self, x, tenant: str = "default",
               client: str = "default", deadline=None) -> _Request:
        """Admission-checked enqueue onto `tenant`'s private queue."""
        return self._tenant(tenant).admission.submit(
            x, client=client, deadline=deadline)

    def wait(self, req: _Request, tenant: str = "default",
             timeout: Optional[float] = None):
        return self._tenant(tenant).queue.wait(req, timeout)

    def predict(self, x, tenant: str = "default",
                client: str = "default", deadline=None,
                timeout: Optional[float] = None):
        """Synchronous submit + wait against one tenant's model."""
        return self.wait(self.submit(x, tenant=tenant, client=client,
                                     deadline=deadline),
                         tenant=tenant, timeout=timeout)

    # ------------------------------------------------------------------
    # fused supertensor lifecycle
    # ------------------------------------------------------------------
    def _mark_fused_dirty(self) -> None:
        """Request a supertensor (re)build; coalesces bursts of promotes
        into one rebuild. The build runs on its own daemon thread so a
        multi-second pack+warmup never stalls the scoring worker."""
        if not self.fused:
            return
        with self._cond:
            self._fused_dirty = True
            if self._fused_thread is not None \
                    and self._fused_thread.is_alive():
                return
            self._fused_thread = threading.Thread(
                target=self._fused_rebuild_loop,
                name="fleet-fused-rebuild", daemon=True)
            self._fused_thread.start()

    def _fused_rebuild_loop(self) -> None:
        while True:
            with self._cond:
                if not self._fused_dirty:
                    return
                self._fused_dirty = False
                names = list(self._tenants)
                gen = self.fused_generation + 1
            # snapshot sessions OUTSIDE the fleet lock; only tenants
            # with a binned model (session._bm) can join the supertensor
            eligible = {}
            for n in names:
                try:
                    s = self._tenants[n].registry.session(n)
                except KeyError:
                    continue
                if getattr(s, "_bm", None) is not None:
                    eligible[n] = s
            scorer = None
            if eligible:
                try:
                    from ..export.fusion import FusedScorer
                    scorer = FusedScorer(
                        eligible, max_batch=self.max_batch,
                        min_bucket=min(s.min_bucket
                                       for s in eligible.values()),
                        num_shards=self.fused_num_shards, generation=gen)
                except BaseException as e:
                    log_warning(f"fleet: fused supertensor rebuild failed "
                                f"({e!r}); tenants drain unfused")
            with self._cond:
                # atomic republish: a launch in flight finishes on the
                # old scorer object; new batches see the new one
                self._fused_scorer = scorer
                if scorer is not None:
                    self.fused_generation = scorer.generation
                self._cond.notify_all()
            if scorer is not None:
                log_info(f"fleet: fused supertensor gen={scorer.generation}"
                         f" live ({len(eligible)}/{len(names)} tenants)")

    def _fusable_locked(self, t: _Tenant, scorer) -> bool:
        """A tenant drains fused only while the published supertensor
        was built from its CURRENT session — a hot-swapped tenant falls
        back to unfused until the rebuild lands (never serves stale)."""
        return (scorer is not None and scorer.can_serve(t.name)
                and scorer.sessions[t.name]
                is t.registry.session(t.name))

    # ------------------------------------------------------------------
    # the scheduler
    # ------------------------------------------------------------------
    def _effective_deadline(self, r: _Request) -> float:
        # requests without an explicit deadline are due one timeout
        # after enqueue — EDF over these is cross-tenant FIFO
        return r.deadline if r.deadline is not None else \
            r.t_enqueue + self.timeout_s

    def _pick_tenant_locked(self) -> Optional[_Tenant]:
        best: Optional[_Tenant] = None
        best_key: Tuple[float, float] = (0.0, 0.0)
        for t in self._tenants.values():
            q = t.queue._q
            while q and q[0].abandoned:
                q.popleft()
            if not q:
                continue
            key = (self._effective_deadline(q[0]), t.last_served)
            if best is None or key < best_key:
                best, best_key = t, key
        return best

    def _other_work_locked(self, tenant: _Tenant) -> bool:
        return any(t.queue._q for t in self._tenants.values()
                   if t is not tenant)

    def _drain_locked(self, t: _Tenant) -> List[_Request]:
        """One device batch from ONE tenant: drain until max_batch rows,
        expiring overdue requests; coalesce (wait up to max_wait) only
        while no other tenant has queued work."""
        q = t.queue._q
        batch: List[_Request] = []
        rows = 0
        open_t = time.perf_counter()
        while True:
            now = time.perf_counter()
            while q:
                r = q[0]
                if r.abandoned:
                    q.popleft()
                elif r.deadline is not None and now >= r.deadline:
                    q.popleft()
                    t.queue._expire(r)
                else:
                    break
            if q:
                r = q[0]
                if rows and rows + r.n > self.max_batch:
                    break                # too big for this batch: next one
                q.popleft()
                batch.append(r)
                rows += r.n
                if rows >= self.max_batch:
                    break
                continue
            if rows == 0:
                break
            if self._other_work_locked(t):
                break                    # never idle the chip to coalesce
            rem = open_t + self.max_wait_s - now
            if rem <= 0:
                break
            self._cond.wait(min(rem, 0.05))
        return batch

    def _drain_fused_locked(self, scorer) \
            -> List[Tuple[_Tenant, List[_Request]]]:
        """One MIXED-tenant device batch: keep taking the EDF-earliest
        head across all fused-capable tenants until max_batch rows,
        expiring overdue requests; stop filling the moment a NON-fusable
        tenant becomes EDF-primary (its single-tenant batch runs next);
        coalesce only while no tenant has queued work."""
        groups: List[Tuple[_Tenant, List[_Request]]] = []
        rows = 0
        open_t = time.perf_counter()
        while rows < self.max_batch:
            now = time.perf_counter()
            t = self._pick_tenant_locked()
            if t is None:
                if rows == 0:
                    break
                rem = open_t + self.max_wait_s - now
                if rem <= 0:
                    break
                self._cond.wait(min(rem, 0.05))
                continue
            if not self._fusable_locked(t, scorer):
                break
            q = t.queue._q
            r = q[0]                     # pick guarantees a live head
            if r.deadline is not None and now >= r.deadline:
                q.popleft()
                t.queue._expire(r)
                continue
            if rows and rows + r.n > self.max_batch:
                break
            q.popleft()
            if groups and groups[-1][0] is t:
                groups[-1][1].append(r)
            else:
                groups.append((t, [r]))
            rows += r.n
        return groups

    def _next_batch(self):
        """(tenant, requests) for a single-tenant batch, or
        (self._FUSED, (scorer, groups)) for a fused mixed-tenant one."""
        with self._cond:
            t = self._pick_tenant_locked()
            if t is None:
                self._cond.wait(0.05)
                return None, []
            scorer = self._fused_scorer if self.fused else None
            if scorer is not None and self._fusable_locked(t, scorer):
                groups = self._drain_fused_locked(scorer)
                return self._FUSED, (scorer, groups)
            batch = self._drain_locked(t)
        return t, [r for r in batch if not r.abandoned]

    def _score(self, t: _Tenant, batch: List[_Request]) -> None:
        t0 = time.perf_counter()
        if t is not self._last_tenant:
            if self._last_tenant is not None:
                self.tenant_switches += 1
            self._last_tenant = t
        self.batches += 1
        try:
            X = batch[0].x if len(batch) == 1 else \
                np.concatenate([r.x for r in batch], axis=0)
            self.batch_sizes.append(X.shape[0])
            with self.profiler.span("score", tenant=t.name):
                out = np.asarray(t.registry.predict(
                    X, name=t.name, raw_score=self.raw_score))
            results = []
            off = 0
            for r in batch:
                results.append(out[off:off + r.n])
                off += r.n
        except BaseException as e:       # deliver to THIS tenant's batch
            t.metrics.inc("errors", len(batch))
            for r in batch:
                r.error = e
                r.event.set()
            t.last_served = time.perf_counter()
            return
        for r, res in zip(batch, results):
            r.result = res
            r.event.set()
        t.metrics.record_batch(time.perf_counter() - t0, X.shape[0])
        t.batches += 1
        t.last_served = time.perf_counter()

    def _score_fused(self, scorer,
                     groups: List[Tuple[_Tenant, List[_Request]]]) -> None:
        """One fused launch for a mixed-tenant batch. The supertensor is
        the resident program regardless of the tenant mix, so fused
        launches never count as tenant switches (the sentinel
        ``_last_tenant`` makes the NEXT single-tenant batch count one).
        A launch failure is delivered to every request in the batch —
        the wider blast radius of sharing one launch."""
        t0 = time.perf_counter()
        if self._last_tenant is not None \
                and self._last_tenant is not self._FUSED:
            self.tenant_switches += 1
        self._last_tenant = self._FUSED
        self.batches += 1
        self.fused_batches += 1
        live = [(t, [r for r in reqs if not r.abandoned])
                for t, reqs in groups]
        live = [(t, reqs) for t, reqs in live if reqs]
        if not live:
            return
        try:
            seq, self._fused_seq = self._fused_seq, self._fused_seq + 1
            if self.fault_plan is not None:
                # same per-launch injected service time as the unfused
                # path (sessions apply it inside score_margin, which the
                # fused launch bypasses)
                self.fault_plan.slow_score(seq)
                self.fault_plan.fail_score(seq)
            parts = [(t.name,
                      reqs[0].x if len(reqs) == 1 else
                      np.concatenate([r.x for r in reqs], axis=0))
                     for t, reqs in live]
            with self.profiler.span("score", tenant="fused"):
                outs = scorer.score_groups(parts)
        except BaseException as e:       # whole-batch blast radius
            for t, reqs in live:
                t.metrics.inc("errors", len(reqs))
                for r in reqs:
                    r.error = e
                    r.event.set()
                t.last_served = time.perf_counter()
            return
        n_rows = sum(X.shape[0] for _, X in parts)
        self.batch_sizes.append(n_rows)
        self.fused_rows += n_rows
        dt = time.perf_counter() - t0
        for (t, reqs), (_, X), margins in zip(live, parts, outs):
            out = np.asarray(scorer.sessions[t.name]._postprocess(
                margins, self.raw_score))
            off = 0
            for r in reqs:
                r.result = out[off:off + r.n]
                off += r.n
                r.event.set()
            t.metrics.record_batch(dt, X.shape[0])
            t.batches += 1
            t.last_served = time.perf_counter()

    def _loop(self) -> None:
        batch: List[_Request] = []
        loop_idx = 0
        try:
            while self._running:
                self.last_beat = time.perf_counter()
                if self.fault_plan is not None:
                    self.fault_plan.wedge_worker(loop_idx)
                loop_idx += 1
                tenant, batch = self._next_batch()
                if tenant is self._FUSED:
                    scorer, groups = batch
                    batch = [r for _, reqs in groups for r in reqs]
                    if groups:
                        self._score_fused(scorer, groups)
                    batch = []
                    continue
                if tenant is None or not batch:
                    continue
                self._score(tenant, batch)
                batch = []
        except BaseException as e:
            self._die(e, batch)

    def _die(self, exc: BaseException, batch: List[_Request]) -> None:
        """FATAL worker error: fail every in-flight and queued request
        across all tenants and refuse new work — a dead scheduler never
        strands callers waiting out their timeouts undiagnosed."""
        self.worker_deaths += 1
        err = RuntimeError(f"serving fleet worker died: {exc!r}")
        err.__cause__ = exc
        with self._cond:
            self._fatal = exc
            self._running = False
            stragglers = list(batch)
            for t in self._tenants.values():
                stragglers.extend(t.queue._q)
                t.queue._q.clear()
        for r in stragglers:
            r.error = err
            r.event.set()

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def metrics_dict(self) -> Dict[str, Any]:
        """Fleet-level profiler export with the per-tenant table: each
        tenant's full serving summary under ``fleet.tenants`` plus
        scheduler fairness counters; per-tenant device time appears as
        ``stages_by_tenant`` (runtime/profiler.py)."""
        with self._cond:
            tenants = dict(self._tenants)
        self.profiler.extras["fleet"] = {
            "tenants": {n: t.metrics.summary()
                        for n, t in sorted(tenants.items())},
            "scheduler": {
                "batches": self.batches,
                "tenant_switches": self.tenant_switches,
                "worker_deaths": self.worker_deaths,
                "fused": self.fused,
                "fused_batches": self.fused_batches,
                "fused_rows": self.fused_rows,
                "fused_generation": self.fused_generation,
                "served": {n: t.batches
                           for n, t in sorted(tenants.items())},
            },
        }
        return self.profiler.to_dict()

    def export_json(self, path: str = "") -> str:
        self.metrics_dict()
        return self.profiler.export_json(path)
