"""Atomic snapshot publication for the online loop.

Counterpart of lightgbm_tpu/online/publisher.py. Every refreshed model
leaves the trainer through :meth:`SnapshotPublisher.publish`, in one or
both of two modes:

 * ``files``: ``<prefix>.snapshot_iter_<k>.txt`` written atomically
   (write-temp, fsync, rename; runtime/checkpoint.py) with its checksum
   manifest. The name is the serving registry's snapshot pattern
   (serving/registry.py ``_SNAP_RE``), so a watching server, in this
   process or another, verifies and hot-swaps it on its next poll; the
   rename is the publication, so no reader sees half a file.
 * ``direct``: the model text goes straight to ``registry.promote``, which
   builds the successor session whole and then swaps one pointer;
   requests in flight finish on the old session.

``both`` writes the file, promotes, then lifts the watcher's floor
(``registry.note_published``) so the next poll does not promote the
file copy of what is already live. Publishing iteration ``k`` again with
the same bytes (a resumed loop) overwrites the file with the same
content.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

from ..runtime.checkpoint import atomic_write_text, write_manifest
from ..utils.log import log_info

PUBLISH_MODES = ("files", "direct", "both")


class SnapshotPublisher:
    """One publication door for refreshed models. ``prefix`` is the
    snapshot path prefix (``files``/``both``); ``registry`` +
    ``model_name`` address the co-located serving session
    (``direct``/``both``)."""

    def __init__(self, prefix: str = "", mode: str = "files",
                 registry=None, model_name: str = "default") -> None:
        if mode not in PUBLISH_MODES:
            raise ValueError(f"unknown publish mode {mode!r} "
                             f"(supported: {', '.join(PUBLISH_MODES)})")
        if mode in ("files", "both") and not prefix:
            raise ValueError(f"publish mode {mode!r} needs a snapshot "
                             "path prefix")
        if mode in ("direct", "both") and registry is None:
            raise ValueError(f"publish mode {mode!r} needs a serving "
                             "registry to promote into")
        self.prefix = prefix
        self.mode = mode
        self.registry = registry
        self.model_name = model_name
        self.last_iteration = -1
        self.n_published = 0

    def snapshot_path(self, iteration: int) -> str:
        return f"{self.prefix}.snapshot_iter_{int(iteration)}.txt"

    def publish(self, model_text: str, iteration: int,
                extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Publish one refreshed model; returns what happened (path,
        sha256, whether a live session was swapped)."""
        payload = model_text.encode("utf-8")
        info: Dict[str, Any] = {
            "iteration": int(iteration),
            "sha256": hashlib.sha256(payload).hexdigest(),
            "bytes": len(payload),
            "promoted": False,
        }
        if self.mode in ("files", "both"):
            path = self.snapshot_path(iteration)
            atomic_write_text(path, model_text)
            manifest = {"iteration": int(iteration),
                        "published_by": "online"}
            if extra:
                manifest.update(extra)
            write_manifest(path, manifest)
            info["path"] = path
        if self.mode in ("direct", "both"):
            self.registry.promote(self.model_name, model_text)
            # direct promotion outruns any snapshot watch on the same
            # prefix; lift its floor so the file copy is not re-promoted
            self.registry.note_published(self.model_name, int(iteration))
            info["promoted"] = True
        self.last_iteration = int(iteration)
        self.n_published += 1
        log_info(f"online publish: iteration {iteration} "
                 f"({info['bytes']} bytes, mode={self.mode}"
                 + (f", -> {info.get('path')}" if "path" in info else "")
                 + ")")
        return info
