"""Model registry: named sessions, atomic hot-swap, snapshot watching.

Counterpart of lightgbm_tpu/serving/registry.py. ``promote`` builds the
successor :class:`~.session.ServingSession` COMPLETELY (parse, pack, upload,
warm the bucket ladder when asked) before a single pointer swap under the
registry lock, so in-flight requests keep scoring against the old
session's arrays (Python references keep them alive) and a hot-swap never
drops a request. Sessions share one :class:`~.metrics.ServingMetrics`, so
counters and latency reservoirs survive swaps.

The snapshot watcher closes the loop with training: ``task=train`` with
``snapshot_freq=k`` (cli.py) writes ``<output_model>.snapshot_iter_<k>.txt``
with a manifest sidecar (runtime/checkpoint.py); ``watch_snapshots`` polls
that prefix and promotes the highest-iteration snapshot it hasn't served
yet — continuous deployment of a model still being trained.

Publish-path hardening: a candidate snapshot must pass validation —
manifest checksum when a ``.manifest.json`` sidecar exists, and a
structural truncation check always — before it is parsed; a rejected or
unloadable snapshot is remembered (by path/mtime/size) and skipped, and
the registry keeps serving the old session. The last promoted iteration
is persisted next to the snapshots, so a restarted serve process does not
re-promote what it already served.
"""

from __future__ import annotations

import glob
import json
import os
import random
import re
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..utils.log import log_info, log_warning
from .metrics import ServingMetrics
from .session import ServingSession


_SNAP_RE = re.compile(r"\.snapshot_iter_(\d+)(?:\.txt)?$")

# complete model text ends with the parameter block (save_model_to_string)
# followed by the Booster-appended pandas_categorical line; the parameter
# sentinel inside the last chunk is the cheap truncation probe
_MODEL_EOF_MARKER = b"end of parameters"
_EOF_PROBE_BYTES = 4096

# exponential backoff for a snapshot path that keeps reappearing
# invalid (a broken producer rewriting a torn snapshot every few
# seconds): each fresh rejection doubles the pause before the next
# validation attempt ON THAT PATH, up to the cap, with jitter so a
# fleet of watchers does not re-probe in lockstep. Snapshots at other
# paths are still validated immediately — a later, valid snapshot must
# never wait behind a broken sibling. A successful promote resets the
# streak.
_BACKOFF_BASE_S = 0.5
_BACKOFF_CAP_S = 60.0


def _snapshot_valid(path: str) -> Tuple[bool, str]:
    """(ok, reason). Checksum-verify against the manifest sidecar when
    the producer wrote one (runtime/checkpoint.py write_manifest, the
    port's own manifests);
    always run the structural truncation probe — atomic writers can't
    produce a torn file, but a copied/rsynced snapshot can."""
    try:
        size = os.path.getsize(path)
    except OSError as e:
        return False, f"unreadable: {e}"
    if size == 0:
        return False, "empty file"
    from ..runtime.checkpoint import manifest_path, verify_manifest
    if os.path.exists(manifest_path(path)):
        ok, reason = verify_manifest(path)
        if not ok:
            return False, reason
    with open(path, "rb") as f:
        f.seek(max(size - _EOF_PROBE_BYTES, 0))
        tail = f.read()
    if _MODEL_EOF_MARKER not in tail:
        return False, "truncated (no end-of-parameters marker)"
    return True, "ok"


def _load_gbdt(model: Any):
    """Booster | GBDT | model text | model file path -> GBDT."""
    if hasattr(model, "_gbdt"):                  # Booster
        return model._gbdt
    if hasattr(model, "models"):                 # GBDT
        return model
    if isinstance(model, (str, os.PathLike)):
        text = str(model)
        if "\n" not in text:                     # a path, not model text
            with open(text) as f:
                text = f.read()
        from ..models.gbdt import GBDT
        return GBDT.load_model_from_string(text)
    raise TypeError(f"cannot load a model from {type(model).__name__}")


class _Watch:
    __slots__ = ("prefix", "opts", "last_iter", "poll_s", "thread", "stop",
                 "state_path", "rejected", "reject_streak", "backoff_until",
                 "last_rejected_path")

    def __init__(self, prefix: str, opts: Dict[str, Any], poll_s: float,
                 initial_iter: int = -1,
                 state_file: Optional[str] = None) -> None:
        self.prefix = prefix
        self.opts = opts
        self.poll_s = poll_s
        self.thread: Optional[threading.Thread] = None
        self.stop = threading.Event()
        # restart amnesia fix: the last promoted iteration is persisted
        # next to the snapshots and reloaded here, so a restarted serve
        # process skips the no-op re-promotion of what it already served
        self.state_path = (state_file if state_file is not None
                           else prefix + ".watch_state.json")
        self.last_iter = max(int(initial_iter), self._load_state())
        # snapshots that failed validation/promotion, keyed by
        # (path, mtime_ns, size): never retried unless rewritten
        self.rejected: set = set()
        # consecutive polls that rejected a NEW (rewritten) candidate;
        # drives the exponential validation backoff, scoped to the path
        # that last failed (other snapshot files validate immediately)
        self.reject_streak = 0
        self.backoff_until = 0.0
        self.last_rejected_path: Optional[str] = None

    def note_rejection(self) -> float:
        """A fresh (not previously-seen) candidate was rejected: extend
        the backoff window and return its length in seconds."""
        self.reject_streak += 1
        pause = min(_BACKOFF_BASE_S * (2.0 ** (self.reject_streak - 1)),
                    _BACKOFF_CAP_S) * (0.75 + 0.5 * random.random())
        self.backoff_until = time.perf_counter() + pause
        return pause

    def note_promoted(self) -> None:
        self.reject_streak = 0
        self.backoff_until = 0.0
        self.last_rejected_path = None

    def _load_state(self) -> int:
        try:
            with open(self.state_path) as f:
                return int(json.load(f).get("last_iter", -1))
        except Exception:
            return -1

    def save_state(self) -> None:
        try:
            from ..runtime.checkpoint import atomic_write_text
            atomic_write_text(self.state_path,
                              json.dumps({"last_iter": self.last_iter}))
        except Exception as e:
            log_warning(f"serving: could not persist watch state to "
                        f"{self.state_path}: {e}")


class ModelRegistry:
    """name -> live ServingSession, with versioned atomic promotion."""

    def __init__(self, metrics: Optional[ServingMetrics] = None,
                 **default_session_opts) -> None:
        self._lock = threading.Lock()
        self._sessions: Dict[str, ServingSession] = {}
        self._watches: Dict[str, _Watch] = {}
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self._defaults = default_session_opts

    # ------------------------------------------------------------------
    def _build(self, model: Any, version: int,
               opts: Dict[str, Any]) -> ServingSession:
        kw = dict(self._defaults)
        kw.update(opts)
        kw.setdefault("warmup", False)
        if hasattr(model, "_gbdt") and "num_iteration" not in kw:
            return ServingSession.from_booster(
                model, metrics=self.metrics, version=version, **kw)
        return ServingSession(_load_gbdt(model), metrics=self.metrics,
                              version=version, **kw)

    def register(self, name: str, model: Any,
                 **session_opts) -> ServingSession:
        """First deployment of `name` (or full replacement, version 0)."""
        sess = self._build(model, 0, session_opts)
        with self._lock:
            self._sessions[name] = sess
        return sess

    def promote(self, name: str, model: Any,
                **session_opts) -> ServingSession:
        """Hot-swap: build the successor fully, then one pointer swap."""
        with self._lock:
            old = self._sessions.get(name)
        if old is None:
            return self.register(name, model, **session_opts)
        opts = dict(session_opts)
        for k in ("engine", "max_batch", "min_bucket", "binning_impl",
                  "device_type"):
            opts.setdefault(k, getattr(
                old, k if k != "engine" else "requested_engine"))
        # the breaker (and any fault plan / profiler) is shared across
        # versions so an OPEN device path stays degraded through a
        # hot-swap instead of resetting to closed on every promote;
        # bin_mappers too: a model reloaded from text carries no frozen
        # mappers, so the binned engine could not be built on promote
        # without the carry (the new session still prefers the new
        # model's own mappers when present)
        for k in ("breaker", "fault_plan", "profiler", "bin_mappers"):
            if getattr(old, k, None) is not None:
                opts.setdefault(k, getattr(old, k))
        sess = self._build(model, old.version + 1, opts)
        with self._lock:
            self._sessions[name] = sess
        self.metrics.inc("swaps")
        log_info(f"serving: promoted {name!r} to version {sess.version} "
                 f"(engine={sess.engine})")
        return sess

    def session(self, name: str = "default") -> ServingSession:
        with self._lock:
            try:
                return self._sessions[name]
            except KeyError:
                raise KeyError(
                    f"no model {name!r} registered "
                    f"(have {sorted(self._sessions)})") from None

    def names(self):
        with self._lock:
            return sorted(self._sessions)

    def predict(self, data, name: str = "default",
                raw_score: bool = False):
        # one pointer read: the whole request scores against ONE version
        return self.session(name).predict(data, raw_score=raw_score)

    # ------------------------------------------------------------------
    # snapshot watching
    # ------------------------------------------------------------------
    def watch_snapshots(self, name: str, model_prefix: str, *,
                        poll_s: float = 5.0, start: bool = False,
                        initial_iter: int = -1,
                        state_file: Optional[str] = None,
                        **session_opts) -> None:
        """Watch ``<model_prefix>.snapshot_iter_<k>[.txt]`` files and
        promote new ones. Call :meth:`poll_snapshots` manually (tests,
        single-threaded serving loops) or pass ``start=True`` for a
        background poller.

        ``initial_iter`` seeds the already-served floor (e.g. the
        iteration parsed from the snapshot the process booted on); the
        floor persisted in ``state_file`` (default
        ``<model_prefix>.watch_state.json``) is merged in, whichever is
        higher wins."""
        w = _Watch(model_prefix, session_opts, poll_s,
                   initial_iter=initial_iter, state_file=state_file)
        with self._lock:
            self._watches[name] = w
        if start:
            w.thread = threading.Thread(
                target=self._watch_loop, args=(name, w),
                name=f"snapshot-watch-{name}", daemon=True)
            w.thread.start()

    def poll_snapshots(self, name: str) -> Optional[int]:
        """One poll: promote the newest unseen snapshot for `name` that
        passes validation. Candidates are tried newest-first; one that
        fails validation or promotion is marked rejected (and never
        retried unless its file changes) while the old session keeps
        serving. Returns the promoted iteration, or None."""
        with self._lock:
            w = self._watches.get(name)
        if w is None:
            return None
        in_backoff = time.perf_counter() < w.backoff_until
        candidates = []
        for path in glob.glob(glob.escape(w.prefix) + ".snapshot_iter_*"):
            m = _SNAP_RE.search(path)
            if m and int(m.group(1)) > w.last_iter:
                candidates.append((int(m.group(1)), path))
        for it, path in sorted(candidates, reverse=True):
            try:
                st = os.stat(path)
                sig = (path, st.st_mtime_ns, st.st_size)
            except OSError:
                continue
            if sig in w.rejected:
                continue
            if in_backoff and path == w.last_rejected_path:
                # rejection-backoff window: the path that last failed is
                # skipped without re-validation (a broken producer
                # rewriting the same torn snapshot gets exponentially
                # rarer attention, not a warning per poll); any OTHER
                # snapshot file still validates this poll
                continue
            ok, reason = _snapshot_valid(path)
            if not ok:
                self._reject(w, sig, path, reason)
                continue
            try:
                self.promote(name, path, **w.opts)
            except Exception as e:
                self._reject(w, sig, path, f"failed to load: {e!r}")
                continue
            w.last_iter = it
            w.save_state()
            w.note_promoted()
            log_info(f"serving: picked up snapshot iter {it} ({path})")
            return it
        return None

    def note_published(self, name: str, iteration: int) -> None:
        """An in-process publisher direct-promoted this iteration AND
        wrote its snapshot file: lift the watcher's already-served floor
        so the next poll does not re-promote the file copy of what is
        already live."""
        with self._lock:
            w = self._watches.get(name)
        if w is None:
            return
        if int(iteration) > w.last_iter:
            w.last_iter = int(iteration)
            w.save_state()

    def _reject(self, w: _Watch, sig: Tuple, path: str,
                reason: str) -> None:
        """Remember a bad candidate and extend the poll backoff. The
        FIRST rejection in a streak logs at warning; repeats (the same
        producer rewriting the same broken file) drop to info so a
        long-running serve process is not spammed once per rewrite."""
        w.rejected.add(sig)
        self.metrics.inc("snapshots_rejected")
        w.last_rejected_path = path
        pause = w.note_rejection()
        log = log_warning if w.reject_streak == 1 else log_info
        log(f"serving: rejected snapshot {path}: {reason}; keeping the "
            f"current session (streak {w.reject_streak}, next validation "
            f"attempt in {pause:.1f}s)")

    def _watch_loop(self, name: str, w: _Watch) -> None:
        while not w.stop.wait(w.poll_s):
            try:
                self.poll_snapshots(name)
            except Exception as e:     # keep watching through bad files
                self.metrics.inc("errors")
                log_info(f"serving: snapshot poll failed: {e}")

    def stop_watchers(self) -> None:
        with self._lock:
            watches = list(self._watches.values())
        for w in watches:
            w.stop.set()
            if w.thread is not None:
                w.thread.join(timeout=5.0)
                w.thread = None
