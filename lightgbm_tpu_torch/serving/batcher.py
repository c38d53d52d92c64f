"""Dynamic micro-batching: coalesce concurrent small requests.

Counterpart of lightgbm_tpu/serving/batcher.py.

Single-row latency on an accelerator is dominated by fixed dispatch cost, so
concurrent batch-1 requests are coalesced into one padded-bucket scoring call
(serving/session.py) under a max-latency / max-batch policy: the worker takes
the first queued request, then drains more until either the batch is full or
``max_wait_ms`` has elapsed since the batch opened. One background worker
thread owns scoring; callers block on a per-request event.

Back-pressure and failure semantics:

 * queue depth is bounded — ``submit`` raises :class:`QueueFullError`
   immediately when the queue is at ``queue_depth`` requests (fail fast
   rather than building an unbounded latency backlog); richer shedding
   policies (rate limits, watermark hysteresis, drop-oldest) layer on
   top via :class:`~.admission.AdmissionController`;
 * a request may carry an ABSOLUTE deadline (``submit(deadline=...)``,
   ``time.perf_counter`` domain). Deadlines propagate into batch
   assembly: ``_gather`` fails already-expired requests immediately
   (``RequestTimeout``, ``expired`` counter) *before* they are padded
   or scored, so queue time is subtracted from the budget and a request
   never burns device time it can't use. ``wait`` with no explicit
   timeout waits exactly to the deadline. Without a deadline, a caller
   that gives up marks its request ABANDONED, and the worker drops
   abandoned requests at batch assembly;
 * a scoring error is delivered to exactly the requests in that batch;
   the worker survives and keeps serving;
 * a FATAL worker error (anything outside the per-batch scoring guard)
   is delivered to every in-flight and queued request, the batcher is
   marked stopped, and subsequent ``submit`` calls fail fast naming the
   original error — a dead worker never strands callers waiting out
   their timeouts undiagnosed;
 * the worker updates a heartbeat each loop; ``wedged()`` reports a
   worker that has stopped making progress while requests queue (the
   `/healthz` liveness signal; driven in tests by the ``wedge_worker``
   fault action, runtime/faults.py).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, List, Optional

import numpy as np


class QueueFullError(RuntimeError):
    """Raised by submit() when the request queue is at queue_depth."""


class RequestTimeout(TimeoutError):
    """Raised by wait()/predict() when a request misses its deadline."""


class _Request:
    __slots__ = ("x", "n", "event", "result", "error", "t_enqueue",
                 "abandoned", "deadline")

    def __init__(self, x: np.ndarray, t_enqueue: float,
                 deadline: Optional[float] = None) -> None:
        self.x = x
        self.n = x.shape[0]
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = t_enqueue
        self.abandoned = False
        # absolute deadline (perf_counter domain); None = no deadline
        self.deadline = deadline


class MicroBatcher:
    """Coalesces predict requests into batches for `predict_fn`.

    `predict_fn(X [n, F]) -> per-row outputs` (an array whose FIRST axis
    is rows, e.g. ``ServingSession.predict``'s output for K == 1, or the
    [n, K] transposed multiclass output). Results are sliced back per
    request in submission order.
    """

    def __init__(self, predict_fn: Callable[[np.ndarray], Any], *,
                 max_batch: int = 256, max_wait_ms: float = 2.0,
                 queue_depth: int = 1024, timeout_ms: float = 1000.0,
                 metrics=None, fault_plan=None) -> None:
        self.predict_fn = predict_fn
        self.max_batch = max(int(max_batch), 1)
        self.max_wait_s = max(float(max_wait_ms), 0.0) / 1e3
        self.timeout_s = float(timeout_ms) / 1e3
        self.metrics = metrics
        self.fault_plan = fault_plan
        self._q: "queue.Queue[_Request]" = queue.Queue(
            maxsize=max(int(queue_depth), 1))
        self._carry: Optional[_Request] = None   # overflow from last batch
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._fatal: Optional[BaseException] = None  # worker-death cause
        # observability: sizes of the batches actually scored
        self.batch_sizes: List[int] = []
        self.last_beat = time.perf_counter()     # worker-loop heartbeat

    # ------------------------------------------------------------------
    def start(self) -> "MicroBatcher":
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="serving-batcher", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        # fail any stragglers so no waiter hangs forever
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            r.error = RuntimeError("batcher stopped")
            r.event.set()

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # health / shed accessors (admission.py, cli.py /healthz /readyz)
    # ------------------------------------------------------------------
    @property
    def depth(self) -> int:
        """Queued requests (approximate; the carry slot counts)."""
        return self._q.qsize() + (1 if self._carry is not None else 0)

    @property
    def capacity(self) -> int:
        return self._q.maxsize

    def alive(self) -> bool:
        """Worker liveness: started, thread running, no fatal error."""
        return (self._running and self._fatal is None
                and self._thread is not None and self._thread.is_alive())

    def wedged(self, threshold_s: Optional[float] = None) -> bool:
        """True when requests are queued but the worker loop has not
        beaten its heartbeat for `threshold_s` — a worker stuck inside
        one batch (wedge_worker fault, a hung device call). Default
        threshold: generous multiples of the coalescing window and
        request timeout, never below 0.5 s."""
        if threshold_s is None:
            threshold_s = max(0.5, 4.0 * self.max_wait_s,
                              2.0 * self.timeout_s)
        return (self.depth > 0
                and time.perf_counter() - self.last_beat > threshold_s)

    def drop_oldest(self, error: Optional[BaseException] = None) -> bool:
        """Shed class drop-oldest (admission.py): fail the OLDEST queued
        request immediately so a fresher one can take its place. False
        when the queue was empty."""
        try:
            r = self._q.get_nowait()
        except queue.Empty:
            return False
        r.abandoned = True
        r.error = error if error is not None else \
            RuntimeError("request shed (drop_oldest)")
        r.event.set()
        return True

    # ------------------------------------------------------------------
    def submit(self, x, deadline: Optional[float] = None) -> _Request:
        """Enqueue one request (a single row or a small [n, F] block).
        Non-blocking; raises QueueFullError under back-pressure.
        `deadline` is ABSOLUTE (time.perf_counter domain): past it the
        request is dropped unscored at batch assembly."""
        if self._fatal is not None:
            raise RuntimeError(
                f"serving worker died: {self._fatal!r}") from self._fatal
        if not self._running:
            raise RuntimeError("batcher not started")
        # float32 rows keep their dtype, so a batch of them takes the
        # session's raw-f32 route (bucketized on the device); anything
        # else is scored as f64
        x = np.asarray(x)
        if x.dtype != np.float32:
            x = x.astype(np.float64)
        if x.ndim == 1:
            x = x.reshape(1, -1)
        req = _Request(x, time.perf_counter(), deadline=deadline)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            if self.metrics is not None:
                self.metrics.inc("overflows")
            raise QueueFullError(
                f"serving queue full ({self._q.maxsize} requests)") from None
        return req

    def wait(self, req: _Request, timeout: Optional[float] = None):
        if timeout is None:
            # a deadline-carrying request waits exactly to its deadline;
            # otherwise the configured per-request timeout applies
            timeout = self.timeout_s if req.deadline is None else \
                max(req.deadline - time.perf_counter(), 0.0)
        if not req.event.wait(timeout):
            req.abandoned = True
            if self.metrics is not None:
                self.metrics.inc("timeouts")
            raise RequestTimeout(
                f"serving request timed out after {timeout * 1e3:.0f} ms")
        if req.error is not None:
            raise req.error
        if self.metrics is not None:
            self.metrics.record_request(
                time.perf_counter() - req.t_enqueue, req.n)
        return req.result

    def predict(self, x, timeout: Optional[float] = None,
                deadline: Optional[float] = None):
        """Synchronous submit + wait — the per-request client call."""
        return self.wait(self.submit(x, deadline=deadline), timeout)

    # ------------------------------------------------------------------
    def _expire(self, r: _Request) -> None:
        """Deadline already passed at batch assembly: fail the waiter
        NOW instead of padding/scoring rows whose answer nobody can use
        (deadline propagation)."""
        r.abandoned = True
        r.error = RequestTimeout(
            "request deadline expired after "
            f"{(time.perf_counter() - r.t_enqueue) * 1e3:.0f} ms in queue")
        r.event.set()
        if self.metrics is not None:
            self.metrics.inc("expired")

    def _expired(self, r: _Request, now: float) -> bool:
        if r.deadline is not None and now >= r.deadline:
            self._expire(r)
            return True
        return False

    def _gather(self) -> List[_Request]:
        """The coalescing policy: first request opens the batch; keep
        draining until max_batch rows or the batch deadline. Requests
        whose own deadline has already expired are failed here, before
        any padding or scoring happens."""
        if self._carry is not None:
            first, self._carry = self._carry, None
            if self._expired(first, time.perf_counter()):
                return []
        else:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                return []
            if self._expired(first, time.perf_counter()):
                return []
        batch = [first]
        rows = first.n
        deadline = time.perf_counter() + self.max_wait_s
        while rows < self.max_batch:
            rem = deadline - time.perf_counter()
            try:
                r = self._q.get(timeout=max(rem, 0.0)) if rem > 0 \
                    else self._q.get_nowait()
            except queue.Empty:
                break
            if self._expired(r, time.perf_counter()):
                continue
            if rows + r.n > self.max_batch:
                self._carry = r          # too big for this batch: next one
                break
            batch.append(r)
            rows += r.n
        return batch

    def _loop(self) -> None:
        batch: List[_Request] = []
        loop_idx = 0
        try:
            while self._running:
                self.last_beat = time.perf_counter()
                if self.fault_plan is not None:
                    self.fault_plan.wedge_worker(loop_idx)
                loop_idx += 1
                batch = [r for r in self._gather() if not r.abandoned]
                if not batch:
                    continue
                try:
                    X = batch[0].x if len(batch) == 1 else \
                        np.concatenate([r.x for r in batch], axis=0)
                    self.batch_sizes.append(X.shape[0])
                    out = np.asarray(self.predict_fn(X))
                    results = []
                    off = 0
                    for r in batch:
                        results.append(out[off:off + r.n])
                        off += r.n
                except BaseException as e:   # deliver, don't die
                    if self.metrics is not None:
                        self.metrics.inc("errors", len(batch))
                    for r in batch:
                        r.error = e
                        r.event.set()
                    continue
                for r, res in zip(batch, results):
                    r.result = res
                    r.event.set()
                batch = []
        except BaseException as e:
            # anything escaping the per-batch guard would otherwise kill
            # this thread silently and strand every waiter: record the
            # cause, fail the in-flight batch and the whole queue, and
            # make the batcher refuse new work
            self._die(e, batch)

    def _die(self, exc: BaseException, batch: List[_Request]) -> None:
        self._fatal = exc
        self._running = False
        if self.metrics is not None:
            self.metrics.inc("worker_deaths")
        err = RuntimeError(f"serving worker died: {exc!r}")
        err.__cause__ = exc
        for r in batch:
            r.error = err
            r.event.set()
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            r.error = err
            r.event.set()
