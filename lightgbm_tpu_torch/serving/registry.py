"""Model registry: named sessions and atomic hot-swap.

Counterpart of lightgbm_tpu/serving/registry.py. ``promote`` builds the
successor :class:`~.session.ServingSession` COMPLETELY (parse, pack, upload,
warm the bucket ladder when asked) before a single pointer swap under the
registry lock, so in-flight requests keep scoring against the old
session's arrays (Python references keep them alive) and a hot-swap never
drops a request. Sessions share one :class:`~.metrics.ServingMetrics`, so
counters and latency reservoirs survive swaps. Snapshot watching (with its
validation and backoff) waits for ROADMAP item A18(b).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

from ..utils.log import log_info
from .metrics import ServingMetrics
from .session import ServingSession


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


class ModelRegistry:
    """name -> live ServingSession, with versioned atomic promotion."""

    def __init__(self, metrics: Optional[ServingMetrics] = None,
                 **default_session_opts) -> None:
        self._lock = threading.Lock()
        self._sessions: Dict[str, ServingSession] = {}
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
        # bin_mappers too: a model reloaded from text carries no frozen
        # mappers, so the binned engine could not be built on promote
        # without the carry (the new session still prefers the new
        # model's own mappers when present)
        if old.bin_mappers is not None:
            opts.setdefault("bin_mappers", old.bin_mappers)
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

    def watch_snapshots(self, name: str, model_prefix: str,
                        **kwargs) -> None:
        """Snapshot watching of the JAX package (validated promotion of
        ``<model_prefix>.snapshot_iter_<k>`` files)."""
        raise NotImplementedError(
            "snapshot watching is not ported to lightgbm_tpu_torch yet "
            "(ROADMAP item A18(b))")
