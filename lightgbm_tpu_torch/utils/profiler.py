"""Batch ring and latency reservoirs for the serving metrics.

The parts of lightgbm_tpu/runtime/profiler.py that serving/metrics.py
reads: ``StageProfiler``'s ring of per-batch records with its totals and
JSON export (its training-loop spans, counters, straggler report and HBM
sampling wait for ROADMAP item A14), and ``LatencyStats``.
"""

from __future__ import annotations

import collections
import json
from typing import Any, Dict, Optional


class StageProfiler:
    """Per-record ring with stage totals, exported as JSON (the serving
    metrics record one ring entry per scored batch)."""

    RING_SIZE = 512

    def __init__(self, ring_size: int = RING_SIZE) -> None:
        self.ring: collections.deque = collections.deque(maxlen=ring_size)
        self.totals: Dict[str, float] = {}
        self.extras: Dict[str, Any] = {}
        self.n_iters = 0
        self.total_wall = 0.0
        self.total_rows = 0

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
            "ring": list(self.ring),
        }
        rps = self.row_iters_per_sec()
        if rps is not None:
            out["row_iters_per_sec"] = round(rps, 1)
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
