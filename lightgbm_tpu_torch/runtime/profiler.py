"""Device-fenced stage profiling.

Counterpart of lightgbm_tpu/runtime/profiler.py. Two layers live here:

 * ``Timer`` — the process-global named-phase accumulator (the reference's
   ``Common::Timer global_timer`` with RAII ``FunctionTimer`` sections,
   utils/common.h:980,1044), printed at exit when ``LIGHTGBM_TPU_TIMETAG``
   is set. models/gbdt.py opens the JAX package's three sections:
   ``GBDT::TrainOneIter/grow`` (a tree of a per-iteration round),
   ``GBDT::TrainItersBatched/scan`` (a batched chunk's replay) and
   ``GBDT::MaterializeModels`` (pending device trees made host trees).
   They are host time, unfenced: a section ends when its launches are
   queued or its reads done.
 * ``StageProfiler`` — per-iteration stage spans with device fences. CUDA
   launches are asynchronous, so every span synchronizes the training
   device (``device_barrier``) before and after; the host clock then
   brackets real device wall time. Each iteration records named spans
   plus an ``other`` catch-all (iteration wall minus the sum of explicit
   spans), so the per-stage breakdown sums to the measured wall time. A
   bounded ring buffer keeps the most recent iterations; totals,
   throughput counters (row-iters/s) and an HBM watermark
   (``torch.cuda.max_memory_allocated`` of the device, None on the CPU)
   accumulate for the whole run. ``to_dict`` / ``export_json`` emit the
   JSON shape of the JAX package's profile.

A tree's growth is many launches the host does not fence one by one;
``probe_stage_breakdown`` times the constituent operations (the slot
histogram #1, the split search, a partition) once on a row subsample,
giving a representative decomposition of the ``grow`` span.
``count_kernel_launches`` counts the port's kernel launches of one eager
call (the counterpart of the JAX package's static ``pallas_call`` site
count).

Nothing here swallows an exception: a fence or a probe whose kernel fails
raises.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch


def device_barrier(device: Optional[torch.device] = None) -> None:
    """Wait for all work queued on a CUDA `device` (None: the current CUDA
    device, once CUDA is initialized). On the CPU it does nothing: the plain
    versions run synchronously."""
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """reference: Common::Timer (utils/common.h:980)."""

    def __init__(self) -> None:
        self.acc: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._printed = False

    @contextlib.contextmanager
    def section(self, name: str, block: bool = False):
        """Time a named section (FunctionTimer, common.h:1044). With
        block=True, waits for all queued device work first and after (so
        the section reflects device wall time)."""
        if block:
            self._barrier()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block:
                self._barrier()
            dt = time.perf_counter() - t0
            self.acc[name] = self.acc.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    _barrier = staticmethod(device_barrier)

    def summary(self) -> str:
        lines = ["[LightGBM-TPU] [Info] Time summary:"]
        for name in sorted(self.acc, key=lambda n: -self.acc[n]):
            lines.append(f"  {name}: {self.acc[name]:.3f}s "
                         f"({self.counts[name]} calls)")
        return "\n".join(lines)

    def reset(self) -> None:
        self.acc.clear()
        self.counts.clear()

    def print_summary(self) -> None:
        from ..utils.log import log_info
        for line in self.summary().split("\n"):
            log_info(line)


global_timer = Timer()

if os.environ.get("LIGHTGBM_TPU_TIMETAG", "") not in ("", "0", "false"):
    atexit.register(lambda: global_timer.acc
                    and global_timer.print_summary())


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler session (CPU, and CUDA where a card is
    present) over the enclosed region and write it as a Chrome trace,
    ``log_dir/trace.json`` (open it in chrome://tracing or Perfetto).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _hbm_peak_bytes(device: Optional[torch.device] = None) -> Optional[int]:
    """Peak memory the caching allocator has handed out on a CUDA `device`
    (None: the current CUDA device, once CUDA is initialized), or None on
    the CPU, which keeps no allocator statistics."""
    if device is None:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    if torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device)) or None


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


class StageProfiler:
    """Per-iteration stage spans, device-fenced, with a ring buffer.

    Usage from the training loop::

        prof.iter_start()
        with prof.span("boost"): ...
        with prof.span("grow"): ...
        prof.iter_end(n_rows=...)

    Spans outside an iteration (e.g. the one-time "bin" upload at init)
    accumulate into totals only. ``clock`` and ``barrier`` are injectable
    for tests; ``device`` is the device whose fences and HBM watermark the
    defaults read (None: the current CUDA device, if any).
    """

    RING_SIZE = 512

    def __init__(self, ring_size: int = RING_SIZE,
                 clock: Callable[[], float] = time.perf_counter,
                 barrier: Optional[Callable[[], None]] = None,
                 device: Optional[torch.device] = None) -> None:
        self._clock = clock
        self._device = device
        self._barrier = (barrier if barrier is not None
                         else lambda: device_barrier(device))
        self.ring: collections.deque = collections.deque(maxlen=ring_size)
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.counters: Dict[str, float] = {}
        self.extras: Dict[str, Any] = {}
        self.n_iters = 0
        self.total_wall = 0.0
        self.total_rows = 0
        self.hbm_peak_bytes: Optional[int] = None
        self._iter_t0: Optional[float] = None
        self._iter_spans: Optional[Dict[str, float]] = None
        self._iter_fields: Optional[Dict[str, Any]] = None
        # cross-rank straggler detection: per-stage lists of per-iteration
        # [rank0_s, rank1_s, ...] span rows
        self.rank_spans: Dict[str, List[List[float]]] = {}
        self.straggler_threshold = 1.5
        # multi-tenant serving: spans tagged with a tenant also accumulate
        # into a per-tenant table, exported as "stages_by_tenant"
        self.tenant_totals: Dict[str, Dict[str, float]] = {}

    def _sample_peak(self) -> Optional[int]:
        peak = _hbm_peak_bytes(self._device)
        if peak is not None:
            self.hbm_peak_bytes = max(self.hbm_peak_bytes or 0, peak)
        return peak

    # -- span recording ---------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, tenant: Optional[str] = None):
        """Fence the device, time the block, fence again. Inside an
        iteration the span lands in that iteration's record; outside it
        accumulates into totals only (init-scope work such as "bin").
        With ``tenant`` set, the span also lands in that tenant's row of
        the per-tenant table."""
        self._barrier()
        t0 = self._clock()
        try:
            yield
        finally:
            self._barrier()
            dt = self._clock() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if self._iter_spans is not None:
                self._iter_spans[name] = self._iter_spans.get(name, 0.0) + dt
            if tenant is not None:
                row = self.tenant_totals.setdefault(str(tenant), {})
                row[name] = row.get(name, 0.0) + dt

    def iter_start(self) -> None:
        self._barrier()
        self._iter_spans = {}
        self._iter_fields = {}
        self._iter_t0 = self._clock()

    def iter_meta(self, **fields: Any) -> None:
        """Attach host-known metadata to the CURRENT iteration's ring
        record. No-op outside an iteration."""
        if self._iter_fields is not None:
            self._iter_fields.update(fields)

    def iter_end(self, n_rows: int = 0) -> None:
        if self._iter_t0 is None:
            return
        self._barrier()
        wall = self._clock() - self._iter_t0
        spans = self._iter_spans or {}
        # catch-all: host-side work between spans, so the stage breakdown
        # always sums to the iteration wall time
        other = wall - sum(spans.values())
        if other > 0.0:
            spans["other"] = other
            self.totals["other"] = self.totals.get("other", 0.0) + other
        rec: Dict[str, Any] = {"iter": self.n_iters, "wall_s": wall,
                               "stages_s": spans}
        if self._iter_fields:
            rec.update(self._iter_fields)
        self.ring.append(rec)
        self.n_iters += 1
        self.total_wall += wall
        self.total_rows += int(n_rows)
        self._iter_t0 = None
        self._iter_spans = None
        self._iter_fields = None
        self._sample_peak()

    def add_counter(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def record_batched_chunk(self, n_iters: int, wall_s: float,
                             n_rows: int = 0, **fields: Any) -> None:
        """Synthesize per-iteration ring records for a batched chunk
        (models/gbdt.py:train_iters_batched). A chunk replays its graphs
        for ``n_iters`` boosting iterations with no host boundary to
        span-time, so the chunk wall time is attributed evenly across its
        iterations under a single "scan" stage (the JAX package's name for
        its whole-chunk scan) and each record carries ``batched: True``:
        the {iter, wall_s, stages_s} schema is the same either path."""
        if n_iters <= 0:
            return
        per = wall_s / n_iters
        rows_per = int(n_rows) // n_iters
        for _ in range(n_iters):
            rec: Dict[str, Any] = {"iter": self.n_iters, "wall_s": per,
                                   "stages_s": {"scan": per},
                                   "batched": True}
            if fields:
                rec.update(fields)
            self.ring.append(rec)
            self.n_iters += 1
            self.total_wall += per
            self.total_rows += rows_per
        self.totals["scan"] = self.totals.get("scan", 0.0) + wall_s
        self.counts["scan"] = self.counts.get("scan", 0) + n_iters
        self._sample_peak()

    HBM_SAMPLE_CAP = 4096

    def sample_hbm(self, tag: str = "") -> Optional[int]:
        """Record one HBM-watermark sample: appended to
        ``extras["hbm_watermark"]`` and folded into the run peak.
        ``peak_bytes`` is None on the CPU; the sample is still recorded so
        the export shape does not depend on the device."""
        peak = self._sample_peak()
        samples = self.extras.setdefault("hbm_watermark", [])
        if len(samples) < self.HBM_SAMPLE_CAP:
            samples.append({"seq": len(samples), "tag": str(tag),
                            "peak_bytes": peak})
        return peak

    # -- straggler detection ----------------------------------------------

    def record_rank_spans(self, stage: str, spans,
                          threshold: Optional[float] = None) -> None:
        """One iteration's per-rank wall seconds for ``stage``."""
        if threshold is not None:
            self.straggler_threshold = float(threshold)
        row = [float(s) for s in spans]
        if row:
            self.rank_spans.setdefault(stage, []).append(row)

    def straggler_report(self) -> Dict[str, Any]:
        """Cross-rank span skew per stage: each rank's mean span over the
        recorded iterations, the cross-rank median, and the ranks whose
        mean exceeds ``straggler_threshold`` x median."""
        out: Dict[str, Any] = {}
        for stage, rows in self.rank_spans.items():
            n_ranks = min(len(r) for r in rows)
            if n_ranks == 0:
                continue
            mean = [sum(r[i] for r in rows) / len(rows)
                    for i in range(n_ranks)]
            med = _median(mean)
            out[stage] = {
                "n_iters": len(rows),
                "mean_s_by_rank": [round(v, 6) for v in mean],
                "median_s": round(med, 6),
                "skew": round(max(mean) / med, 4) if med > 0 else 0.0,
                "threshold": self.straggler_threshold,
                "straggler_ranks": [
                    i for i, v in enumerate(mean)
                    if med > 0 and v > self.straggler_threshold * med],
            }
        return out

    # -- export -----------------------------------------------------------

    def row_iters_per_sec(self) -> Optional[float]:
        if self.total_wall <= 0.0 or self.total_rows <= 0:
            return None
        return self.total_rows / self.total_wall

    def to_dict(self) -> Dict[str, Any]:
        stages = {n: round(v, 6) for n, v in
                  sorted(self.totals.items(), key=lambda kv: -kv[1])}
        out: Dict[str, Any] = {
            "n_iters": self.n_iters,
            "total_wall_s": round(self.total_wall, 6),
            "stages_s": stages,
            "stage_counts": dict(self.counts),
            "ring": list(self.ring),
        }
        rps = self.row_iters_per_sec()
        if rps is not None:
            out["row_iters_per_sec"] = round(rps, 1)
        if self.counters:
            out["counters"] = {n: round(v, 6)
                               for n, v in self.counters.items()}
        if self.hbm_peak_bytes is not None:
            out["hbm_peak_bytes"] = self.hbm_peak_bytes
        if self.rank_spans:
            out["stragglers"] = self.straggler_report()
        if self.tenant_totals:
            out["stages_by_tenant"] = {
                t: {n: round(v, 6) for n, v in
                    sorted(row.items(), key=lambda kv: -kv[1])}
                for t, row in sorted(self.tenant_totals.items())}
        if self.extras:
            out.update(self.extras)
        return out

    def export_json(self, path: str = "") -> str:
        """Serialize; when ``path`` is set also write the file."""
        text = json.dumps(self.to_dict(), indent=2, sort_keys=False)
        if path:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text


class LatencyStats:
    """Bounded latency reservoir with exact percentiles over the kept tail
    (most recent ``maxlen`` samples); count/sum cover the whole run,
    percentiles the tail window."""

    def __init__(self, maxlen: int = 8192) -> None:
        self.buf: collections.deque = collections.deque(maxlen=maxlen)
        self.count = 0
        self.total = 0.0
        self.max_s = 0.0

    def record(self, seconds: float) -> None:
        self.buf.append(seconds)
        self.count += 1
        self.total += seconds
        if seconds > self.max_s:
            self.max_s = seconds

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100] over the tail window; None when empty."""
        if not self.buf:
            return None
        s = sorted(self.buf)
        idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
        return s[idx]

    def to_dict(self) -> Dict[str, Any]:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "mean_ms": round(self.total / self.count * 1e3, 3),
            "p50_ms": round((self.percentile(50.0) or 0.0) * 1e3, 3),
            "p99_ms": round((self.percentile(99.0) or 0.0) * 1e3, 3),
            "max_ms": round(self.max_s * 1e3, 3),
        }


def probe_stage_breakdown(X_t: torch.Tensor, grad: torch.Tensor,
                          hess: torch.Tensor, meta, cfg,
                          n_probe_rows: int = 16384) -> Dict[str, float]:
    """One-time decomposition of the ``grow`` span into its constituent
    operations, each timed once after a warm call, fenced on X_t's device:
    the slot histogram (#1, K = 1) of the first `n_probe_rows` rows, the
    split search over that histogram (skipped on EFB-bundled storage,
    whose histogram the grower re-slices per feature at search time) and
    a partition of the rows on one threshold. The seconds are
    representative single-shot costs at the probe size, not exact shares
    of a tree."""
    from ..ops.histogram import build_histogram
    from ..ops.split import find_best_split, synth_count_channel
    from ..utils import bin_values, indexable_bins

    dev = X_t.device
    n = int(X_t.shape[1])
    m = min(int(n_probe_rows), n)
    Xs = X_t[:, :m].contiguous()
    g = grad[:m].to(torch.float32)
    h = hess[:m].to(torch.float32)
    B = int(cfg.num_bins_padded)

    def timed(fn, *args) -> float:
        fn(*args)                       # build / warm
        device_barrier(dev)
        t0 = time.perf_counter()
        fn(*args)
        device_barrier(dev)
        return time.perf_counter() - t0

    out: Dict[str, float] = {"probe_rows": m}
    vals = torch.stack([g, h])                                   # [2, m]
    out["histogram_s"] = round(timed(build_histogram, Xs, vals, B), 6)

    if not cfg.bundled:
        hist2 = build_histogram(Xs, vals, B)
        gsum, hsum = g.sum(), h.sum()
        cnt = torch.tensor(float(m), device=dev)
        zero = torch.zeros((), device=dev)

        def split_probe(hh, gs, hs, c):
            h3 = synth_count_channel(hh, c, hs)
            return find_best_split(h3, gs, hs, c, zero, meta, cfg.hp)

        out["split_search_s"] = round(
            timed(split_probe, hist2, gsum, hsum, cnt), 6)

    thr = B // 2
    Xi = indexable_bins(Xs)
    out["partition_s"] = round(timed(
        lambda X: (bin_values(X[0]) <= thr).to(torch.int32), Xi), 6)
    return out


def count_kernel_launches(fn: Callable, *args: Any,
                          **kwargs: Any) -> Dict[str, int]:
    """The port's kernel launches made by one eager call of ``fn``: the
    rise of each launch counter of ops/histogram_cuda.py:LAUNCHES over the
    call, {kernel name: launches}, kernels not launched left out.

    This counts launches, not static sites: the JAX package's
    ``count_pallas_launch_sites`` walks a traced jaxpr and counts each
    ``pallas_call`` once however often it runs, while here every launch
    of a kernel counts (a tree of w waves shows its wave kernel w times).
    On the CPU the wrappers run their plain versions and count nothing."""
    from ..ops import histogram_cuda as hc
    before = dict(hc.LAUNCHES)
    fn(*args, **kwargs)
    return {k: hc.LAUNCHES[k] - before.get(k, 0) for k in hc.LAUNCHES
            if hc.LAUNCHES[k] != before.get(k, 0)}
