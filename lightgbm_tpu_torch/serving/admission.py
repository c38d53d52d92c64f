"""Admission control and load shedding in front of the micro-batcher.

Counterpart of lightgbm_tpu/serving/admission.py (the port keeps its own
copy: the module is device-free). A bounded queue alone ("fail when full", batcher.py) protects memory but
not latency: by the time the queue is full every queued request is
already doomed to miss its SLO. The admission controller sheds *before*
that point, by policy:

 * **token-bucket rate limit per client** — ``rate_qps`` tokens/s with
   ``burst`` capacity per client key (one row = one token). An empty
   bucket raises :class:`RateLimitedError` (HTTP 429) with the exact
   refill time as ``retry_after_s``.
 * **overload watermarks with hysteresis** — shedding ENGAGES when
   queue depth rises to ``queue_high`` × capacity OR the observed
   request p99 (over a sliding time window of completed requests)
   exceeds ``p99_slo_ms`` OR the device-occupancy observer reports at
   least ``occupancy_high`` (the profiler's batch-occupancy metric:
   every scored batch full means the device itself, not the queue, is
   the bottleneck); it DISENGAGES only when depth has fallen to
   ``queue_low`` × capacity AND the p99 has recovered below
   ``p99_recovery`` × SLO AND occupancy has fallen back below the
   recovery fraction of its threshold — no flapping at the boundary.
 * **shed classes** — while shedding, ``reject_new`` refuses the new
   request (:class:`OverloadedError`, HTTP 503, ``retry_after_s``
   estimated from the queue drain rate); ``drop_oldest`` admits the new
   request and instead fails the oldest *queued* request immediately —
   the freshest work has the most deadline left, the stalest the least
   (LIFO-flavored shedding for deadline-bound traffic).

Shed requests fail in O(1) on the submit path — they never enter the
queue, never wake the worker, and never burn device time. Counters:
``admitted`` / ``shed_rate_limit`` / ``shed_overload`` /
``shed_drop_oldest``; the live shed state is exported under the serving
summary's ``states`` key and surfaces in `/readyz`.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, Optional, Tuple

from ..utils.log import log_info, log_warning

SHED_CLASSES = ("reject_new", "drop_oldest")

# p99 recovery factor: while shedding, the observed p99 must fall below
# this fraction of the SLO (in addition to the queue-low watermark)
# before admission reopens — the latency half of the hysteresis band
P99_RECOVERY = 0.8
# sliding window (seconds) for the observed p99: old samples age out so
# a past latency spike cannot pin the controller in the shedding state
# after the queue has drained
P99_WINDOW_S = 5.0
# occupancy recovery factor (the occupancy half of the hysteresis band):
# while shedding, observed occupancy must fall below this fraction of
# ``occupancy_high`` before admission reopens
OCCUPANCY_RECOVERY = 0.9


class ShedError(RuntimeError):
    """Request refused by admission control (it was never queued).
    ``retry_after_s`` is the client back-off hint (the HTTP front-end
    rounds it up into a ``Retry-After`` header)."""

    http_status = 503

    def __init__(self, msg: str, retry_after_s: float = 1.0) -> None:
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class RateLimitedError(ShedError):
    """Per-client token bucket exhausted (HTTP 429)."""

    http_status = 429


class OverloadedError(ShedError):
    """Overload watermark shedding (HTTP 503)."""

    http_status = 503


class _TokenBucket:
    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float, now: float) -> None:
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.last = now

    def take(self, now: float, n: float = 1.0) -> float:
        """0.0 when `n` tokens were taken; else seconds until they
        would be available (nothing is taken)."""
        self.tokens = min(self.burst,
                          self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        return (n - self.tokens) / self.rate


class AdmissionController:
    """Policy layer over a :class:`~.batcher.MicroBatcher`: every
    request enters through :meth:`submit` (or :meth:`predict`), which
    either forwards to the batcher or raises a :class:`ShedError`."""

    def __init__(self, batcher, *, metrics=None, rate_qps: float = 0.0,
                 burst: float = 0.0, queue_high: float = 0.8,
                 queue_low: float = 0.5, p99_slo_ms: float = 0.0,
                 shed_class: str = "reject_new",
                 occupancy_high: float = 0.0, occupancy_observer=None,
                 clock=time.perf_counter) -> None:
        if shed_class not in SHED_CLASSES:
            raise ValueError(f"unknown shed_class {shed_class!r} "
                             f"(supported: {', '.join(SHED_CLASSES)})")
        if not (0.0 < queue_high <= 1.0):
            raise ValueError("queue_high must be in (0, 1]")
        if not (0.0 < queue_low <= queue_high):
            raise ValueError("queue_low must be in (0, queue_high]")
        if rate_qps < 0.0 or burst < 0.0 or p99_slo_ms < 0.0:
            raise ValueError("rate_qps / burst / p99_slo_ms must be >= 0")
        if not (0.0 <= occupancy_high <= 1.0):
            raise ValueError("occupancy_high must be in [0, 1] "
                             "(0 disables occupancy shedding)")
        self.batcher = batcher
        self.metrics = metrics
        self.rate_qps = float(rate_qps)
        # default burst: one second's worth of tokens (at least 1)
        self.burst = float(burst) if burst > 0.0 else max(rate_qps, 1.0)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.p99_slo_ms = float(p99_slo_ms)
        self.shed_class = shed_class
        self.occupancy_high = float(occupancy_high)
        # device saturation signal: a callable returning the live occupancy fraction or None — defaults to
        # the shared metrics' batch_occupancy (mean rows per scored
        # batch / max_batch)
        if occupancy_observer is None and occupancy_high > 0.0 \
                and metrics is not None:
            occupancy_observer = metrics.batch_occupancy
        self.occupancy_observer = occupancy_observer
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, _TokenBucket] = {}
        self._window: Deque[Tuple[float, float]] = collections.deque()
        self.shedding = False
        if metrics is not None:
            metrics.set_state("shedding", "no")
            # completed-request latencies feed the sliding p99 window
            metrics.add_latency_observer(self.observe_latency)

    # -- signals --------------------------------------------------------
    def observe_latency(self, latency_s: float) -> None:
        now = self._clock()
        with self._lock:
            self._window.append((now, latency_s))
            self._prune(now)

    def _prune(self, now: float) -> None:
        w = self._window
        while w and now - w[0][0] > P99_WINDOW_S:
            w.popleft()

    def observed_p99_ms(self) -> Optional[float]:
        """p99 over completed requests in the sliding window; None when
        the window is empty (then only the depth watermark applies)."""
        with self._lock:
            self._prune(self._clock())
            if not self._window:
                return None
            s = sorted(lat for _, lat in self._window)
        idx = min(len(s) - 1, int(round(0.99 * (len(s) - 1))))
        return s[idx] * 1e3

    def retry_after_s(self) -> float:
        """Back-off hint from the queue drain rate: batches left to
        drain × recent mean batch latency (floor 100 ms, cap 30 s)."""
        depth = self.batcher.depth
        batches = max(1.0, depth / max(self.batcher.max_batch, 1))
        mean_s = 0.0
        if self.metrics is not None:
            bl = self.metrics.batch_latency
            if bl.buf:
                mean_s = sum(bl.buf) / len(bl.buf)
        return min(max(batches * (mean_s or 0.1), 0.1), 30.0)

    def observed_occupancy(self) -> Optional[float]:
        """Live device-occupancy fraction from the observer; None when
        occupancy shedding is disabled or the observer has no signal
        yet (then only depth + p99 apply)."""
        if self.occupancy_high <= 0.0 or self.occupancy_observer is None:
            return None
        try:
            occ = self.occupancy_observer()
        except Exception:
            return None
        return None if occ is None else float(occ)

    def _update_shedding(self) -> bool:
        depth = self.batcher.depth
        cap = max(self.batcher.capacity, 1)
        p99 = self.observed_p99_ms() if self.p99_slo_ms > 0.0 else None
        occ = self.observed_occupancy()
        if not self.shedding:
            if depth >= self.queue_high * cap or \
                    (p99 is not None and p99 > self.p99_slo_ms) or \
                    (occ is not None and occ >= self.occupancy_high):
                self.shedding = True
                if self.metrics is not None:
                    self.metrics.set_state("shedding", "yes")
                log_warning(
                    f"serving admission: shedding ENGAGED (queue "
                    f"{depth}/{cap}, p99 "
                    f"{'n/a' if p99 is None else f'{p99:.1f}ms'}, "
                    f"occupancy "
                    f"{'n/a' if occ is None else f'{occ:.2f}'}, "
                    f"class={self.shed_class})")
        else:
            depth_ok = depth <= self.queue_low * cap
            p99_ok = (self.p99_slo_ms <= 0.0 or p99 is None
                      or p99 <= P99_RECOVERY * self.p99_slo_ms)
            occ_ok = (occ is None
                      or occ < OCCUPANCY_RECOVERY * self.occupancy_high)
            if depth_ok and p99_ok and occ_ok:
                self.shedding = False
                if self.metrics is not None:
                    self.metrics.set_state("shedding", "no")
                log_info(f"serving admission: shedding disengaged "
                         f"(queue {depth}/{cap})")
        return self.shedding

    # -- the gate -------------------------------------------------------
    def admit(self, n_rows: int = 1, client: str = "default") -> None:
        """Raise a ShedError, or return having consumed rate tokens."""
        now = self._clock()
        if self.rate_qps > 0.0:
            with self._lock:
                b = self._buckets.get(client)
                if b is None:
                    b = self._buckets[client] = _TokenBucket(
                        self.rate_qps, self.burst, now)
                wait = b.take(now, float(max(n_rows, 1)))
            if wait > 0.0:
                if self.metrics is not None:
                    self.metrics.inc("shed_rate_limit")
                raise RateLimitedError(
                    f"client {client!r} rate-limited "
                    f"({self.rate_qps:g} rows/s, burst {self.burst:g})",
                    retry_after_s=wait)
        if self._update_shedding():
            if self.shed_class == "drop_oldest":
                # admit the fresh request; shed the stalest queued one
                shed = self.batcher.drop_oldest(OverloadedError(
                    "shed (drop_oldest): overload admission dropped this "
                    "request to admit a fresher one",
                    retry_after_s=self.retry_after_s()))
                if shed and self.metrics is not None:
                    self.metrics.inc("shed_drop_oldest")
            else:
                if self.metrics is not None:
                    self.metrics.inc("shed_overload")
                raise OverloadedError(
                    f"overloaded (queue {self.batcher.depth}/"
                    f"{self.batcher.capacity}); shedding new requests",
                    retry_after_s=self.retry_after_s())
        if self.metrics is not None:
            self.metrics.inc("admitted")

    def submit(self, x, client: str = "default", deadline=None):
        """Admission-checked ``batcher.submit``; ShedErrors are raised
        before the request touches the queue."""
        x_rows = getattr(x, "shape", None)
        n = int(x_rows[0]) if x_rows and len(x_rows) > 1 else 1
        self.admit(n_rows=n, client=client)
        return self.batcher.submit(x, deadline=deadline)

    def wait(self, req, timeout: Optional[float] = None):
        return self.batcher.wait(req, timeout)

    def predict(self, x, client: str = "default", deadline=None,
                timeout: Optional[float] = None):
        return self.wait(self.submit(x, client=client, deadline=deadline),
                         timeout)
