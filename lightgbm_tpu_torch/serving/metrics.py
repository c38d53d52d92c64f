"""Serving counters, exported through the profiler JSON machinery.

Counterpart of lightgbm_tpu/serving/metrics.py. One ``ServingMetrics``
instance is shared by the session(s), the micro-batcher and the registry,
so counters survive model hot-swaps. Each scored batch is recorded as one
profiler "iteration" (``StageProfiler`` ring + totals give the per-batch
stage breakdown and rows/s); request- and batch-level latencies feed
bounded ``LatencyStats`` reservoirs (p50/p99). ``to_dict``/``export_json``
reuse the profiler's export path, with the serving summary under the
``serving`` key.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ..runtime.profiler import LatencyStats, StageProfiler


class ServingMetrics:
    """Thread-safe serving counters: QPS, p50/p99 latency, batch
    occupancy, compile-cache hit rate (reference analog: the per-call
    setup the single-row FastInit API amortizes, c_api.h:1399 — here the
    cache hit rate measures exactly that amortization)."""

    def __init__(self, max_batch: int = 0,
                 clock=time.perf_counter, tenant: str = "") -> None:
        self._lock = threading.Lock()
        # fleet serving (serving/fleet.py): one ServingMetrics per tenant,
        # so QPS / p50 / p99 / occupancy never aggregate across models
        self.tenant = tenant
        self._clock = clock
        self.start_t = clock()
        # per-batch ring; no device fence per batch, which would
        # serialize the very pipeline being measured
        self.profiler = StageProfiler()
        self.request_latency = LatencyStats()
        self.batch_latency = LatencyStats()
        self.max_batch = max_batch
        self.counters: Dict[str, int] = {
            "requests": 0, "rows": 0, "batches": 0,
            "cache_hits": 0, "cache_misses": 0,
            "host_fallbacks": 0, "timeouts": 0, "overflows": 0,
            "swaps": 0, "errors": 0, "worker_deaths": 0,
            # overload-protection layer (admission.py, breaker.py)
            "expired": 0,            # deadline-expired at batch assembly
            "admitted": 0,           # passed admission control
            "shed_rate_limit": 0,    # 429: token bucket empty
            "shed_overload": 0,      # 503: watermark shed (reject_new)
            "shed_drop_oldest": 0,   # 503: watermark shed (drop_oldest)
            "breaker_trips": 0,      # device->host circuit-breaker trips
            "breaker_recoveries": 0,  # half-open probe closed the breaker
        }
        # live component states ("breaker": closed/open/half_open,
        # "shedding": yes/no) — set by breaker.py / admission.py,
        # exported under serving["states"] and /readyz
        self.states: Dict[str, str] = {}
        self._latency_observers: list = []

    # -- recording ------------------------------------------------------
    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def set_state(self, name: str, value: str) -> None:
        with self._lock:
            self.states[name] = str(value)

    def add_latency_observer(self, fn) -> None:
        """fn(latency_s) is called after every completed request —
        outside this object's lock (observers may take their own locks;
        admission.py feeds its sliding p99 window this way)."""
        with self._lock:
            self._latency_observers.append(fn)

    def record_request(self, latency_s: float, n_rows: int = 1) -> None:
        with self._lock:
            self.counters["requests"] += 1
            self.counters["rows"] += n_rows
            self.request_latency.record(latency_s)
            observers = tuple(self._latency_observers)
        for fn in observers:
            fn(latency_s)

    def record_batch(self, latency_s: float, n_rows: int) -> None:
        """One scored device/host batch (NOT one request): feeds the
        profiler ring so the batch trajectory is inspectable like a
        training run's iteration ring."""
        with self._lock:
            self.counters["batches"] += 1
            self.batch_latency.record(latency_s)
            self.profiler.ring.append({
                "iter": self.profiler.n_iters,
                "wall_s": round(latency_s, 6),
                "stages_s": {"score": round(latency_s, 6)},
            })
            self.profiler.n_iters += 1
            self.profiler.total_wall += latency_s
            self.profiler.total_rows += int(n_rows)
            t = self.profiler.totals
            t["score"] = t.get("score", 0.0) + latency_s

    def record_cache(self, hit: bool) -> None:
        self.inc("cache_hits" if hit else "cache_misses")

    # -- export ---------------------------------------------------------
    def cache_hit_rate(self) -> Optional[float]:
        h = self.counters["cache_hits"]
        m = self.counters["cache_misses"]
        return h / (h + m) if (h + m) else None

    def batch_occupancy(self) -> Optional[float]:
        """Mean rows per scored batch / max_batch (1.0 = every device
        batch full); None before any batch or without a max."""
        b = self.counters["batches"]
        if not b or not self.max_batch:
            return None
        return self.counters["rows"] / b / self.max_batch

    def qps(self) -> float:
        dt = self._clock() - self.start_t
        return self.counters["requests"] / dt if dt > 0 else 0.0

    def summary(self) -> Dict[str, Any]:
        """The serving summary dict alone (no profiler wrap): what the
        fleet exports per tenant (serving/fleet.py)."""
        with self._lock:
            serving: Dict[str, Any] = {
                "uptime_s": round(self._clock() - self.start_t, 3),
                "qps": round(self.qps(), 2),
                "counters": dict(self.counters),
                "request_latency": self.request_latency.to_dict(),
                "batch_latency": self.batch_latency.to_dict(),
            }
            if self.tenant:
                serving["tenant"] = self.tenant
            hr = self.cache_hit_rate()
            if hr is not None:
                serving["cache_hit_rate"] = round(hr, 4)
            occ = self.batch_occupancy()
            if occ is not None:
                serving["batch_occupancy"] = round(occ, 4)
            if self.counters["batches"]:
                serving["mean_batch_rows"] = round(
                    self.counters["rows"] / self.counters["batches"], 2)
            if self.states:
                serving["states"] = dict(self.states)
            return serving

    def to_dict(self) -> Dict[str, Any]:
        self.profiler.extras["serving"] = self.summary()
        return self.profiler.to_dict()

    def export_json(self, path: str = "") -> str:
        self.to_dict()     # refresh extras["serving"] before export
        return self.profiler.export_json(path)
