"""Circuit breaker for the serving scoring path.

Counterpart of lightgbm_tpu/serving/breaker.py (the port keeps its own
copy: the module is device-free). The device engine is the fast path but
also the fragile one: a wedged runtime, a kernel that keeps raising, or a
slow device turns every request into a timeout. The breaker watches the *protected* (device)
scoring attempts and, when they keep failing or keep missing their
latency SLO, degrades the session to the host engine — the serving twin
of the training watchdog's reduce_scatter -> allreduce collective
degrade. The host walk is always available and bit-identical to
``Booster.predict``, so degradation trades latency for availability,
never correctness. It is taken only when a breaker is configured: a
session without one raises on a scoring failure, and every chunk routed
away is counted in ``host_fallbacks`` and logged (session.py).

Sticky CUDA errors: a real device fault (an illegal address, a
device-side assert) poisons the process's CUDA context. After one, no
later kernel can succeed in that process, so the half-open probe fails
every cooldown and the breaker stays open, serving on the host walk until
the process is restarted. The breaker recovers from failures that leave
the context usable: Python-level exceptions in the scoring call, a
refused launch, a slow device (the latency trip), the fault plan's
``fail_score`` / ``slow_score``.

State machine (classic three-state breaker):

    CLOSED ──(failure_threshold consecutive failures, or
              latency_trips consecutive latency-SLO misses)──> OPEN
    OPEN   ──(cooldown_s elapsed)──> HALF_OPEN
    HALF_OPEN: exactly ONE probe request is allowed onto the device
      path; success (within SLO) -> CLOSED, failure or SLO miss -> OPEN
      (cooldown restarts).

``allow()`` is the single question the scoring loop asks per batch:
True = score on the protected path, False = take the host fallback.
Transitions are counted into :class:`~.metrics.ServingMetrics`
(``breaker_trips`` / ``breaker_recoveries``) and the live state is
exported under the serving summary's ``states`` key and `/readyz`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ..utils.log import log_info, log_warning

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Thread-safe; shared by every session version of one served model
    so the degrade decision survives hot-swaps (registry.py)."""

    def __init__(self, *, failure_threshold: int = 3,
                 latency_slo_ms: float = 0.0, latency_trips: int = 3,
                 cooldown_s: float = 5.0, metrics=None,
                 clock=time.perf_counter, name: str = "device") -> None:
        if failure_threshold < 0:
            raise ValueError("failure_threshold must be >= 0 (0 disables "
                             "the consecutive-failure trip)")
        if latency_slo_ms < 0.0:
            raise ValueError("latency_slo_ms must be >= 0 (0 disables "
                             "the latency trip)")
        if latency_trips < 1:
            raise ValueError("latency_trips must be >= 1")
        if cooldown_s <= 0.0:
            raise ValueError("cooldown_s must be > 0")
        self.failure_threshold = int(failure_threshold)
        self.latency_slo_ms = float(latency_slo_ms)
        self.latency_trips = int(latency_trips)
        self.cooldown_s = float(cooldown_s)
        self.name = name
        self._metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self._consec_failures = 0
        self._consec_slow = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        self.trips = 0
        self.recoveries = 0
        self.last_trip_reason = ""

    # ------------------------------------------------------------------
    def allow(self) -> bool:
        """True: score this batch on the protected (device) path."""
        with self._lock:
            if self.state == CLOSED:
                return True
            now = self._clock()
            if self.state == OPEN:
                if now - self._opened_at < self.cooldown_s:
                    return False
                # cooldown over: half-open, this caller is the probe
                self.state = HALF_OPEN
                self._probe_in_flight = True
                self._set_state_metric()
                log_info(f"serving breaker[{self.name}]: half-open, "
                         "probing the protected path")
                return True
            # HALF_OPEN: one probe at a time
            if not self._probe_in_flight:
                self._probe_in_flight = True
                return True
            return False

    def record_success(self, latency_s: float = 0.0) -> None:
        with self._lock:
            slow = (self.latency_slo_ms > 0.0
                    and latency_s * 1e3 > self.latency_slo_ms)
            if self.state == HALF_OPEN:
                self._probe_in_flight = False
                if slow:
                    self._trip(f"half-open probe missed the latency SLO "
                               f"({latency_s * 1e3:.1f} ms > "
                               f"{self.latency_slo_ms:g} ms)")
                else:
                    self._close()
                return
            if slow:
                self._consec_slow += 1
                self._consec_failures = 0
                if self._consec_slow >= self.latency_trips:
                    self._trip(f"{self._consec_slow} consecutive batches "
                               f"over the {self.latency_slo_ms:g} ms "
                               "latency SLO")
            else:
                self._consec_slow = 0
                self._consec_failures = 0

    def record_failure(self, exc: Optional[BaseException] = None) -> None:
        with self._lock:
            if self.state == HALF_OPEN:
                self._probe_in_flight = False
                self._trip(f"half-open probe failed ({exc!r})")
                return
            if self.state != CLOSED:
                return
            self._consec_failures += 1
            self._consec_slow = 0
            if self.failure_threshold > 0 \
                    and self._consec_failures >= self.failure_threshold:
                self._trip(f"{self._consec_failures} consecutive scoring "
                           f"failures (last: {exc!r})")

    # -- internal (lock held) ------------------------------------------
    def _trip(self, reason: str) -> None:
        self.state = OPEN
        self._opened_at = self._clock()
        self._consec_failures = 0
        self._consec_slow = 0
        self.trips += 1
        self.last_trip_reason = reason
        if self._metrics is not None:
            self._metrics.inc("breaker_trips")
        self._set_state_metric()
        log_warning(f"serving breaker[{self.name}]: OPEN — degrading to "
                    f"the host engine ({reason}); half-open probe in "
                    f"{self.cooldown_s:g}s")

    def _close(self) -> None:
        self.state = CLOSED
        self._consec_failures = 0
        self._consec_slow = 0
        self.recoveries += 1
        if self._metrics is not None:
            self._metrics.inc("breaker_recoveries")
        self._set_state_metric()
        log_info(f"serving breaker[{self.name}]: probe succeeded, CLOSED "
                 "— protected path restored")

    def _set_state_metric(self) -> None:
        if self._metrics is not None:
            self._metrics.set_state("breaker", self.state)

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self.state, "trips": self.trips,
                "recoveries": self.recoveries,
                "failure_threshold": self.failure_threshold,
                "latency_slo_ms": self.latency_slo_ms,
                "cooldown_s": self.cooldown_s,
                "last_trip_reason": self.last_trip_reason,
            }
