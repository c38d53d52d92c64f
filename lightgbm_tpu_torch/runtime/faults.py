"""Deterministic fault injection for resilience tests and smoke runs.

Counterpart of lightgbm_tpu/runtime/faults.py: the same plan grammar and
the same training hooks (models/gbdt.py calls `at_iteration` before each
iteration and `maybe_fail_collective` inside its step watchdog;
runtime/checkpoint.py asks `should_corrupt_snapshot`).

A fault PLAN is a ``;``/``,``-separated list of directives, each
``action@key=value[:key=value...]`` (docs/ROBUSTNESS.md):

    kill@iter=7                   os._exit(17) before iteration 7 runs
    raise@iter=3                  raise InjectedFault before iteration 3
    sleep@iter=2:rank=1:ms=250    straggle rank 1 for 250ms at iteration 2
    corrupt_snapshot@iter=8       flip bytes in the checkpoint written at
                                  iteration 8 (its manifest then fails)
    fail_collective@iter=2:times=2  the histogram exchange raises
                                  CollectiveFault `times` times starting
                                  at iteration 2 (on one card, as in the
                                  JAX package's serial run: the step
                                  watchdog retries it up to
                                  step_max_retries times, else raises;
                                  the reduce_scatter -> allreduce degrade
                                  comes with multi-device training, A16)

Serving actions (keyed by the 0-based scored-batch / worker-loop index
instead of the training iteration; ``batch`` defaults to 0, "from the
first batch"). They parse here, and their hooks stay unwired in the
port: they drive the serving circuit breaker and the batcher's
heartbeat, which come with ROADMAP item A18(b):

    slow_score@batch=0:ms=50:times=8   sleep 50ms inside the timed
                                  scoring region of 8 batches (drives
                                  latency-SLO shedding and the circuit
                                  breaker's latency trip)
    fail_score@batch=0:times=3    the scorer raises InjectedFault for 3
                                  batches (drives the breaker's
                                  consecutive-failure device->host trip)
    wedge_worker@batch=0:ms=800   the micro-batcher worker thread stalls
                                  mid-loop (drives the /healthz wedge
                                  detection; default ms is an hour)

Online-loop actions (keyed by the 0-based micro-batch index, the same
``batch``/``times`` grammar as the serving actions; parsed, unwired
until the online loop of ROADMAP item A13):

    stall_source@batch=2:ms=400   the micro-batch source blocks 400ms
                                  before yielding batch 2 (drives the
                                  online trainer's staleness watchdog)
    corrupt_batch@batch=1:times=2 the source mangles 2 batches starting
                                  at batch 1 (extra column -> the
                                  bin-compat guard rejects; the loop
                                  must skip-and-log, not die)

``times`` defaults to 1 everywhere. Plans come from config
``fault_plan=...`` or the LIGHTGBM_TPU_FAULT_PLAN env var; with no plan
the training hot path pays exactly one ``is None`` check per iteration.

Stdlib-only (imported eagerly by ``runtime/__init__``).
"""

import os
import re
import sys
import time
from typing import Dict, List, Optional

KILL_EXIT_CODE = 17

_ACTIONS = ("kill", "raise", "sleep", "corrupt_snapshot", "fail_collective",
            "slow_score", "fail_score", "wedge_worker",
            "stall_source", "corrupt_batch")


class InjectedFault(RuntimeError):
    """An error raised on purpose by the fault-injection harness."""


class CollectiveFault(InjectedFault):
    """An injected histogram-exchange (collective) failure."""


class _Directive:
    __slots__ = ("action", "params", "remaining")

    def __init__(self, action: str, params: Dict[str, str]):
        self.action = action
        self.params = params
        self.remaining = int(params.get("times", 1))

    def __repr__(self):
        kv = ":".join(f"{k}={v}" for k, v in sorted(self.params.items()))
        return f"{self.action}@{kv}" if kv else self.action


def _rank() -> int:
    """This process's rank: 0, one process trains until multi-device
    training (ROADMAP item A16)."""
    return 0


class FaultPlan:
    """Parsed plan; directives are consumed (``times`` decrements) so a
    resumed process re-reading the same plan replays deterministically
    from its own start."""

    def __init__(self, directives: List[_Directive], spec: str):
        self.directives = directives
        self.spec = spec

    def __repr__(self):
        return f"FaultPlan({self.spec!r})"

    @classmethod
    def parse(cls, spec: str) -> Optional["FaultPlan"]:
        spec = (spec or "").strip()
        if not spec:
            return None
        directives = []
        for tok in re.split(r"[;,]", spec):
            tok = tok.strip()
            if not tok:
                continue
            action, _, rest = tok.partition("@")
            action = action.strip()
            if action not in _ACTIONS:
                raise ValueError(
                    f"unknown fault action {action!r} in plan {spec!r}; "
                    f"known: {', '.join(_ACTIONS)}")
            params: Dict[str, str] = {}
            for kv in filter(None, (p.strip() for p in rest.split(":"))):
                k, _, v = kv.partition("=")
                params[k.strip()] = v.strip()
            directives.append(_Directive(action, params))
        return cls(directives, spec)

    # -- hooks ------------------------------------------------------------

    def at_iteration(self, it: int) -> None:
        """Training-loop hook, called once before iteration `it` runs;
        fires kill / raise / sleep directives pinned to that iteration."""
        for d in self.directives:
            if d.remaining <= 0 or int(d.params.get("iter", -1)) != int(it):
                continue
            if d.action == "kill":
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(int(d.params.get("code", KILL_EXIT_CODE)))
            elif d.action == "raise":
                d.remaining -= 1
                raise InjectedFault(f"injected fault at iteration {it}")
            elif d.action == "sleep":
                if int(d.params.get("rank", 0)) != _rank():
                    continue
                d.remaining -= 1
                time.sleep(float(d.params.get("ms", 100.0)) / 1e3)

    def maybe_fail_collective(self, it: int) -> None:
        """Histogram-exchange hook (models/gbdt.py `_grow_step`)."""
        for d in self.directives:
            if d.action == "fail_collective" and d.remaining > 0 \
                    and int(it) >= int(d.params.get("iter", 0)):
                d.remaining -= 1
                raise CollectiveFault(
                    f"injected collective failure at iteration {it}")

    def _consume_serving(self, action: str, idx: int) -> Optional[Dict]:
        for d in self.directives:
            if d.action == action and d.remaining > 0 \
                    and int(idx) >= int(d.params.get("batch", 0)):
                d.remaining -= 1
                return d.params
        return None

    def slow_score(self, batch_idx: int) -> None:
        """Scoring hook, called inside the timed region so the injected
        delay shows up in batch latency (unwired until A18(b))."""
        p = self._consume_serving("slow_score", batch_idx)
        if p is not None:
            time.sleep(float(p.get("ms", 100.0)) / 1e3)

    def fail_score(self, batch_idx: int) -> None:
        """Scoring hook: raise so the serving circuit breaker records a
        failure (unwired until A18(b))."""
        if self._consume_serving("fail_score", batch_idx) is not None:
            raise InjectedFault(
                f"injected scoring failure at batch {batch_idx}")

    def wedge_worker(self, loop_idx: int) -> None:
        """Micro-batcher worker-loop hook: stall the worker thread
        (unwired until A18(b)). Default stall is an hour; tests pass a
        small ``ms``."""
        p = self._consume_serving("wedge_worker", loop_idx)
        if p is not None:
            time.sleep(float(p.get("ms", 3_600_000.0)) / 1e3)

    def stall_source(self, batch_idx: int) -> None:
        """Online-source hook, called before a batch is yielded: block so
        the stream goes quiet (unwired until A13). Default stall is an
        hour; tests pass a small ``ms``."""
        p = self._consume_serving("stall_source", batch_idx)
        if p is not None:
            time.sleep(float(p.get("ms", 3_600_000.0)) / 1e3)

    def should_corrupt_batch(self, batch_idx: int) -> bool:
        """Online-source hook: mangle the batch about to be yielded
        (unwired until A13)."""
        return self._consume_serving("corrupt_batch", batch_idx) is not None

    def should_corrupt_snapshot(self, iteration: int) -> bool:
        """Checkpoint-write hook (runtime/checkpoint.py); consumed once."""
        for d in self.directives:
            if d.action == "corrupt_snapshot" and d.remaining > 0 \
                    and int(d.params.get("iter", -1)) == int(iteration):
                d.remaining -= 1
                return True
        return False


def active_plan(spec: str = "") -> Optional[FaultPlan]:
    """Plan from the explicit spec, else LIGHTGBM_TPU_FAULT_PLAN, else
    None (the zero-overhead default)."""
    return FaultPlan.parse(
        spec or os.environ.get("LIGHTGBM_TPU_FAULT_PLAN", ""))


def corrupt_file(path: str, offset_frac: float = 0.4,
                 nbytes: int = 64) -> None:
    """Deterministically overwrite bytes mid-file, keeping its size —
    the shape of a bad sector / torn buffer, detectable only by
    checksum (manifest verification, not a size check, must catch it)."""
    size = os.path.getsize(path)
    off = max(int(size * offset_frac), 0)
    n = max(min(nbytes, size - off), 4)
    with open(path, "r+b") as f:
        f.seek(off)
        f.write(b"\xde\xad\xbe\xef" * (n // 4))


# the words by which a runtime error names a failed collective (JAX
# parallel/__init__.py:16-29)
COLLECTIVE_ERROR_MARKERS = ("collective", "all-reduce", "allreduce",
                            "all-gather", "allgather", "reduce-scatter",
                            "reduce_scatter", "psum", "ppermute",
                            "nccl", "megascale")


def is_collective_error(exc: BaseException) -> bool:
    """True when `exc` looks like a failed cross-device collective (an
    injected CollectiveFault or a runtime error naming one)."""
    if isinstance(exc, CollectiveFault):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in COLLECTIVE_ERROR_MARKERS)
