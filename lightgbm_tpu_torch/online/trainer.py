"""The online loop: stream, refit or warm-continue, publish.

Counterpart of lightgbm_tpu/online/trainer.py. :class:`OnlineTrainer`
pulls micro-batches from a :class:`~.source.BatchSource`, keeps a sliding
window of the last ``online_window_rows`` accepted rows, and refreshes
the model whenever the policy fires, with one of two kinds:

 * **refit** (the default): the ANCHOR's leaf values refit on the window
   (``Booster.refit`` at ``refit_decay_rate``; the structure is kept).
   A refit never changes the anchor, so a published refit is the bytes of
   an offline ``anchor.refit(window)`` on the same rows.
 * **continue** (every ``online_continue_every``-th refresh):
   ``online_continue_trees`` new trees boosted onto the anchor on the
   window, binned against the frozen base mappers
   (``engine.warm_continue``, which the offline arm calls too); the result
   becomes the anchor.

The window holds float64 rows, as every source yields them, so it is
binned on the host and a refit walks the anchor's f64 thresholds on the
rows' own values (ROADMAP C note 22).

The policy fires on pending rows >= ``online_refresh_rows``, or when the
oldest pending batch is older than ``online_max_staleness_s`` on the
injectable ``clock`` (the staleness watchdog: a stalled source does not
hold ingested rows back). A batch that fails the bin-compat guard
(:func:`~.source.check_batch_schema`) is skipped, counted and logged.

The loop's whole state (window rows, anchor text, counters, batches
consumed) checkpoints through
:class:`~..runtime.checkpoint.CheckpointManager` as kind
``online_loop``; a killed loop resumes by seeking its source past the
consumed batches and publishes the same bytes from there.

Each refresh is one profiler iteration with ``online_ingest`` /
``online_refit`` / ``online_continue`` / ``online_publish`` spans and an
HBM sample at each publish, so a co-located train + serve deployment sees
both workloads in one profile.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..basic import Booster, Dataset
from ..config import resolve_params
from ..engine import warm_continue
from ..runtime.checkpoint import STATE_FORMAT, CheckpointManager
from ..utils.log import log_info, log_warning
from .source import BatchSource, MicroBatch, SchemaDriftError, \
    check_batch_schema

# distinguishes online-loop checkpoints from boosting-iteration
# checkpoints (runtime/checkpoint.py capture_trainer_state) sharing a
# directory namespace
ONLINE_STATE_KIND = "online_loop"

# quiet-source poll granularity: bounds how late the staleness watchdog
# and idle-stop checks can fire
_POLL_S = 0.05


class OnlineTrainer:
    """Drives one online loop. ``params`` are the boosting parameters
    (shared verbatim with the offline arms for byte parity),
    ``base_model`` the anchor's model text (or a Booster/path),
    ``base_dataset`` the constructed Dataset carrying the frozen bin
    mappers, ``publisher`` a :class:`~.publisher.SnapshotPublisher`."""

    def __init__(self, params: Dict[str, Any], base_model,
                 base_dataset: Dataset, source: BatchSource, publisher,
                 profiler=None, fault_plan=None,
                 checkpoint_dir: str = "", checkpoint_retention: int = 3,
                 clock=time.monotonic) -> None:
        self.params = dict(params)
        self.cfg = resolve_params(dict(params))
        self.source = source
        self.publisher = publisher
        self.profiler = profiler
        self.fault_plan = fault_plan
        self._clock = clock

        if isinstance(base_model, Booster):
            self.anchor = base_model.model_to_string()
        elif isinstance(base_model, str) and "\n" in base_model:
            self.anchor = base_model
        else:
            with open(base_model) as f:
                self.anchor = f.read()

        base_dataset.construct()
        self.base_dataset = base_dataset
        self.num_features = base_dataset._handle.num_total_features
        self.schema_signature = base_dataset._handle.schema_signature()

        self.ckpt_mgr = None
        if checkpoint_dir:
            self.ckpt_mgr = CheckpointManager(
                checkpoint_dir, retention=checkpoint_retention,
                fault_plan=fault_plan)

        # sliding window: chunk lists, evicted from the front so the
        # window always holds exactly the LAST `online_window_rows` rows
        # of the accepted stream (the offline arm reproduces it as
        # `concatenated[-window_rows:]`)
        self._wX: List[np.ndarray] = []
        self._wy: List[np.ndarray] = []
        self._ww: List[Optional[np.ndarray]] = []
        self._win_rows = 0
        self._saw_weights = False

        # policy + bookkeeping state (all of it checkpointed)
        self.pending_rows = 0
        self._oldest_pending_t: Optional[float] = None
        self.publish_seq = 0          # last published snapshot iteration
        self.refresh_count = 0        # completed refreshes
        self.consumed_batches = 0     # every pull, including skipped
        self.consumed_rows = 0        # accepted rows only
        self.skipped_batches = 0
        self.stale_refreshes = 0
        self.n_refits = 0
        self.n_continues = 0
        self.publishes: List[Dict[str, Any]] = []

    # -- sliding window -------------------------------------------------

    def _append(self, b: MicroBatch) -> None:
        self._wX.append(np.asarray(b.X, np.float64))
        self._wy.append(np.asarray(b.y, np.float64))
        self._ww.append(None if b.weight is None
                        else np.asarray(b.weight, np.float64))
        if b.weight is not None:
            self._saw_weights = True
        self._win_rows += b.num_rows
        cap = self.cfg.online_window_rows
        while self._win_rows > cap:
            excess = self._win_rows - cap
            head = self._wX[0]
            if head.shape[0] <= excess:
                self._win_rows -= head.shape[0]
                del self._wX[0], self._wy[0], self._ww[0]
            else:
                self._wX[0] = head[excess:]
                self._wy[0] = self._wy[0][excess:]
                if self._ww[0] is not None:
                    self._ww[0] = self._ww[0][excess:]
                self._win_rows = cap

    def _window_arrays(self) -> Tuple[np.ndarray, np.ndarray,
                                      Optional[np.ndarray]]:
        X = np.concatenate(self._wX, axis=0)
        y = np.concatenate(self._wy, axis=0)
        w = None
        if self._saw_weights:
            w = np.concatenate(
                [np.ones(x.shape[0], np.float64) if wi is None else wi
                 for x, wi in zip(self._wX, self._ww)])
        return X, y, w

    # -- ingest ---------------------------------------------------------

    def _span(self, name: str):
        return (self.profiler.span(name) if self.profiler is not None
                else contextlib.nullcontext())

    def _ingest_one(self, timeout_s: float) -> bool:
        """Pull (at most) one micro-batch; True when one was consumed
        (accepted OR skipped — both advance the source position)."""
        with self._span("online_ingest"):
            b = self.source.next_batch(timeout_s)
        if b is None:
            return False
        self.consumed_batches += 1
        try:
            check_batch_schema(b.X, b.y, self.num_features)
        except SchemaDriftError as e:
            # skip-and-log policy: a drifted batch is rejected whole and
            # the loop keeps serving/refreshing on clean data
            self.skipped_batches += 1
            log_warning(f"online ingest: skipping batch {b.seq} "
                        f"({b.num_rows} rows): {e}")
            return True
        self._append(b)
        self.pending_rows += b.num_rows
        self.consumed_rows += b.num_rows
        if self._oldest_pending_t is None:
            self._oldest_pending_t = self._clock()
        return True

    # -- refresh policy + actions ---------------------------------------

    def _refresh_due(self, now: float) -> Optional[str]:
        """None, or why the refresh fires ('rows' | 'staleness')."""
        if self.pending_rows <= 0:
            return None
        if self.pending_rows >= self.cfg.online_refresh_rows:
            return "rows"
        if (self.cfg.online_max_staleness_s > 0.0
                and self._oldest_pending_t is not None
                and now - self._oldest_pending_t
                >= self.cfg.online_max_staleness_s):
            return "staleness"
        return None

    def _anchor_booster(self) -> Booster:
        """The anchor's text as a Booster on the loop's device_type; as in
        the JAX package, a refit takes no other parameter from the loop."""
        return Booster(params={"device_type": self.cfg.device_type},
                       model_str=self.anchor)

    def _refit_window(self, X, y, w) -> str:
        """Leaf refresh of the ANCHOR (not mutated): identical call
        shape to the offline one-shot arm, so identical bytes."""
        anchor = self._anchor_booster()
        refreshed = anchor.refit(X, y,
                                 decay_rate=self.cfg.refit_decay_rate,
                                 weight=w)
        return refreshed.model_to_string()

    def _continue_window(self, X, y, w) -> str:
        """Warm-continue: k new trees on the window, binned against the
        frozen base mappers (engine.warm_continue — the same code path
        the offline parity arm calls). The result is the new anchor."""
        booster = warm_continue(
            dict(self.params), X, y,
            num_boost_round=self.cfg.online_continue_trees,
            init_model=self._anchor_booster(),
            reference=self.base_dataset, weight=w)
        return booster.model_to_string()

    def _refresh(self, reason: str) -> None:
        next_seq = self.publish_seq + 1
        if self.fault_plan is not None:
            # the kill/raise injection point for the resume-parity tests
            self.fault_plan.at_iteration(next_seq)
        X, y, w = self._window_arrays()
        is_continue = (self.cfg.online_continue_every > 0
                       and (self.refresh_count + 1)
                       % self.cfg.online_continue_every == 0)
        kind = "continue" if is_continue else "refit"
        if self.profiler is not None:
            self.profiler.iter_start()
        if is_continue:
            with self._span("online_continue"):
                model_text = self._continue_window(X, y, w)
            self.anchor = model_text
            self.n_continues += 1
        else:
            with self._span("online_refit"):
                model_text = self._refit_window(X, y, w)
            self.n_refits += 1
        with self._span("online_publish"):
            info = self.publisher.publish(
                model_text, next_seq,
                extra={"kind": kind, "reason": reason,
                       "window_rows": int(X.shape[0])})
        if self.profiler is not None:
            self.profiler.sample_hbm(f"online_publish_{next_seq}")
            self.profiler.iter_meta(kind=kind, reason=reason,
                                    publish_iter=next_seq,
                                    window_rows=int(X.shape[0]),
                                    pending_rows=self.pending_rows)
            self.profiler.iter_end(n_rows=int(X.shape[0]))
        self.publishes.append(info)
        self.publish_seq = next_seq
        self.refresh_count += 1
        if reason == "staleness":
            self.stale_refreshes += 1
        self.pending_rows = 0
        self._oldest_pending_t = None
        if self.ckpt_mgr is not None and \
                self.refresh_count % self.cfg.online_checkpoint_every == 0:
            self.ckpt_mgr.save(self._state(), self.publish_seq)

    # -- checkpoint / resume --------------------------------------------

    def _state(self) -> Dict[str, Any]:
        X, y, w = (self._window_arrays() if self._win_rows
                   else (np.zeros((0, self.num_features)), np.zeros(0),
                         None))
        return {
            "format": STATE_FORMAT,
            "kind": ONLINE_STATE_KIND,
            "schema_signature": self.schema_signature,
            "anchor_model": self.anchor,
            "window_X": X, "window_y": y, "window_w": w,
            "pending_rows": int(self.pending_rows),
            "publish_seq": int(self.publish_seq),
            "refresh_count": int(self.refresh_count),
            "consumed_batches": int(self.consumed_batches),
            "consumed_rows": int(self.consumed_rows),
            "skipped_batches": int(self.skipped_batches),
            "stale_refreshes": int(self.stale_refreshes),
            "n_refits": int(self.n_refits),
            "n_continues": int(self.n_continues),
        }

    def _maybe_resume(self) -> bool:
        if self.ckpt_mgr is None:
            return False
        state = self.ckpt_mgr.load_latest()
        if state is None or state.get("kind") != ONLINE_STATE_KIND:
            return False
        if state.get("schema_signature") != self.schema_signature:
            log_warning("online resume: checkpoint was taken against a "
                        "different base-model schema; starting fresh")
            return False
        self.anchor = state["anchor_model"]
        X, y, w = state["window_X"], state["window_y"], state["window_w"]
        self._wX = [X] if X.shape[0] else []
        self._wy = [y] if X.shape[0] else []
        self._ww = [w] if X.shape[0] else []
        self._win_rows = int(X.shape[0])
        self._saw_weights = w is not None
        self.pending_rows = int(state["pending_rows"])
        if self.pending_rows:
            self._oldest_pending_t = self._clock()
        self.publish_seq = int(state["publish_seq"])
        self.refresh_count = int(state["refresh_count"])
        self.consumed_batches = int(state["consumed_batches"])
        self.consumed_rows = int(state["consumed_rows"])
        self.skipped_batches = int(state["skipped_batches"])
        self.stale_refreshes = int(state["stale_refreshes"])
        self.n_refits = int(state["n_refits"])
        self.n_continues = int(state["n_continues"])
        try:
            self.source.seek(self.consumed_batches)
        except NotImplementedError as e:
            log_warning(f"online resume: {e}")
        log_info(f"online resume: restored loop at publish "
                 f"{self.publish_seq} ({self.consumed_batches} batches, "
                 f"{self.consumed_rows} rows consumed)")
        return True

    # -- the loop -------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        """Consume the stream to its end (or ``online_max_batches`` /
        idle timeout), publishing on every policy trigger; the pending
        tail is flushed as a final refresh. Returns the loop summary."""
        self._maybe_resume()
        idle_since = self._clock()
        while True:
            if self.source.exhausted:
                break
            if self.cfg.online_max_batches > 0 and \
                    self.consumed_batches >= self.cfg.online_max_batches:
                log_info(f"online loop: stopping at online_max_batches="
                         f"{self.cfg.online_max_batches}")
                break
            got = self._ingest_one(_POLL_S)
            now = self._clock()
            if got:
                idle_since = now
            elif not self.source.exhausted and \
                    now - idle_since >= self.cfg.online_idle_timeout_s:
                log_info(f"online loop: source idle for "
                         f"{self.cfg.online_idle_timeout_s:g}s; stopping")
                break
            reason = self._refresh_due(now)
            if reason is not None:
                self._refresh(reason)
        if self.pending_rows > 0:
            self._refresh("flush")
        return self.summary()

    def summary(self) -> Dict[str, Any]:
        return {
            "publishes": len(self.publishes),
            "last_iteration": self.publish_seq,
            "refits": self.n_refits,
            "continues": self.n_continues,
            "consumed_batches": self.consumed_batches,
            "consumed_rows": self.consumed_rows,
            "skipped_batches": self.skipped_batches,
            "stale_refreshes": self.stale_refreshes,
            "window_rows": self._win_rows,
        }
