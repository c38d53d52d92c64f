"""Micro-batch sources for the online loop.

Counterpart of lightgbm_tpu/online/source.py, with its dtypes: every
source hands over raw ``(X, y[, weight])`` rows as float64 (a window is
binned on the host, so a refit walks the anchor's f64 thresholds on the
values they were trained against). Every source is PULLED,
``next_batch(timeout)``, so backpressure is structural: a trainer busy
refreshing does not pull, and nothing buffers on its behalf.

 * :class:`DirectorySource` tails a directory for ``*.npz`` / ``*.csv``
   drops, each file one batch, consumed once in sorted-name order.
 * :class:`CallableSource` wraps a callable or an iterator of ``(X, y)``
   tuples (a consumer the caller owns); it cannot seek.
 * :class:`TraceSource` replays a recorded ``.npz`` trace batch by batch
   and seeks to any batch: a killed loop resumes on the same batches.
 * :class:`ArrowSource` slices a pyarrow Table (seekable) or streams
   RecordBatches (not seekable), the label (and weight) split out by
   column after the Arrow conversion ``Dataset`` uses.
 * :class:`SequenceSource` replays a :class:`lightgbm_tpu_torch.Sequence`
   in ``batch_size`` slices; seekable.

Sources never see a bin mapper: the trainer bins against the frozen base
mappers. :func:`check_batch_schema`, the bin-compat guard, rejects a
drifted batch (another column count, non-finite labels) whole with
:class:`SchemaDriftError` before any row reaches the window.

Fault hooks (runtime/faults.py): ``stall_source@batch=k:ms=..`` blocks the
pull of batch ``k`` (the trainer's staleness watchdog fires);
``corrupt_batch@batch=k`` widens batch ``k`` by one column, so the guard
rejects it and the loop skips it.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from ..utils.log import log_info, log_warning


class SchemaDriftError(ValueError):
    """A micro-batch does not match the frozen base-model schema. The
    online loop must never re-bin: a drifted batch is rejected whole
    (skip-and-log policy), keeping refreshed trees comparable and the
    serving engines warm."""


class MicroBatch:
    """One pulled chunk: raw features + labels (+ optional weights),
    stamped with the source-order sequence number and arrival time."""

    __slots__ = ("X", "y", "weight", "seq", "arrived_at")

    def __init__(self, X: np.ndarray, y: np.ndarray,
                 weight: Optional[np.ndarray], seq: int,
                 arrived_at: float) -> None:
        self.X = X
        self.y = y
        self.weight = weight
        self.seq = int(seq)
        self.arrived_at = float(arrived_at)

    @property
    def num_rows(self) -> int:
        return int(self.X.shape[0])

    def __repr__(self) -> str:
        return (f"MicroBatch(seq={self.seq}, rows={self.num_rows}, "
                f"cols={self.X.shape[1] if self.X.ndim == 2 else '?'})")


def check_batch_schema(X: np.ndarray, y: np.ndarray,
                       num_features: int) -> None:
    """The bin-compat guard: a batch is accepted only when it can be
    binned against the FROZEN original BinMapper — same column count,
    finite labels, matching row counts. Raises SchemaDriftError."""
    if X.ndim != 2:
        raise SchemaDriftError(
            f"batch features must be 2-D, got shape {X.shape}")
    if int(X.shape[1]) != int(num_features):
        raise SchemaDriftError(
            f"batch has {X.shape[1]} columns but the frozen base-model "
            f"schema has {num_features}; refusing to re-bin "
            "(the bin-compat guard)")
    if y.shape[0] != X.shape[0]:
        raise SchemaDriftError(
            f"batch has {X.shape[0]} rows but {y.shape[0]} labels")
    if not np.all(np.isfinite(np.asarray(y, np.float64))):
        raise SchemaDriftError("batch labels contain NaN/inf")


def _as_batch_arrays(item: Any) -> Tuple[np.ndarray, np.ndarray,
                                         Optional[np.ndarray]]:
    """(X, y[, weight]) tuple -> float arrays (weight may be None)."""
    if not isinstance(item, (tuple, list)) or len(item) not in (2, 3):
        raise SchemaDriftError(
            f"source items must be (X, y) or (X, y, weight) tuples, "
            f"got {type(item).__name__}")
    X = np.asarray(item[0], np.float64)
    if X.ndim == 1:
        X = X.reshape(1, -1)
    y = np.asarray(item[1], np.float64).reshape(-1)
    w = None
    if len(item) == 3 and item[2] is not None:
        w = np.asarray(item[2], np.float64).reshape(-1)
        if w.shape[0] != y.shape[0]:
            raise SchemaDriftError(
                f"batch has {y.shape[0]} labels but {w.shape[0]} weights")
    return X, y, w


class BatchSource:
    """Base pull interface. ``next_batch`` returns the next MicroBatch,
    None on timeout (stream quiet, caller decides staleness policy), and
    sets ``exhausted`` once the stream has definitively ended.

    ``fault_plan`` hooks fire on the consumed-batch index: the injection
    point is the source boundary, exactly where a real feed stalls or a
    real producer ships a bad file."""

    def __init__(self, fault_plan=None) -> None:
        self.fault_plan = fault_plan
        self.exhausted = False
        self.seq = 0               # next batch's source-order index
        self.corrupted_batches = 0

    # subclasses implement: pull one raw item or None (nothing yet)
    def _pull(self, timeout_s: float) -> Optional[Any]:
        raise NotImplementedError

    def next_batch(self, timeout_s: float = 0.0) -> Optional[MicroBatch]:
        if self.exhausted:
            return None
        if self.fault_plan is not None:
            self.fault_plan.stall_source(self.seq)
        item = self._pull(timeout_s)
        if item is None:
            return None
        X, y, w = _as_batch_arrays(item)
        if self.fault_plan is not None and \
                self.fault_plan.should_corrupt_batch(self.seq):
            # widen by one column: the cheapest mutation that is
            # guaranteed to trip the bin-compat guard, not the binner
            X = np.concatenate([X, np.zeros((X.shape[0], 1))], axis=1)
            self.corrupted_batches += 1
        b = MicroBatch(X, y, w, self.seq, time.monotonic())
        self.seq += 1
        return b

    def seek(self, n_batches: int) -> None:
        """Skip the first ``n_batches`` (deterministic resume: the
        checkpointed consumed-count is replayed here). Sources that
        cannot seek raise."""
        raise NotImplementedError(
            f"{type(self).__name__} is not seekable; resume replays "
            "from the live position")


class CallableSource(BatchSource):
    """Wrap a callable returning ``(X, y[, weight])`` per call, or an
    iterator/generator of such tuples. The callable returns None (or the
    iterator ends) to signal stream end."""

    def __init__(self, fn: Callable[[], Any], fault_plan=None) -> None:
        super().__init__(fault_plan)
        if callable(fn):
            self._fn: Optional[Callable[[], Any]] = fn
            self._it = None
        else:
            self._fn = None
            self._it = iter(fn)

    def _pull(self, timeout_s: float) -> Optional[Any]:
        if self._fn is not None:
            item = self._fn()
            if item is None:
                self.exhausted = True
                return None
            return item
        try:
            return next(self._it)
        except StopIteration:
            self.exhausted = True
            return None


class DirectorySource(BatchSource):
    """Tail a directory for ``*.npz`` (arrays ``X``/``y``[/``weight``])
    or ``*.csv`` (label in column 0, like the CLI's ``label_column=0``
    convention) drops. Each file is one micro-batch; files are consumed
    once, in sorted-name order. A file that appears AFTER its sorted
    position was passed is still picked up (consumed names are tracked
    individually, not by a high-water mark)."""

    PATTERNS = ("*.npz", "*.csv")

    def __init__(self, directory: str, fault_plan=None,
                 poll_s: float = 0.05) -> None:
        super().__init__(fault_plan)
        if not os.path.isdir(directory):
            raise FileNotFoundError(
                f"online_source directory {directory!r} does not exist")
        self.directory = directory
        self.poll_s = float(poll_s)
        self._consumed: set = set()

    def _candidates(self) -> List[str]:
        names: List[str] = []
        for pat in self.PATTERNS:
            names.extend(glob.glob(os.path.join(
                glob.escape(self.directory), pat)))
        return sorted(n for n in names
                      if os.path.basename(n) not in self._consumed)

    def _load(self, path: str) -> Any:
        if path.endswith(".npz"):
            with np.load(path) as z:
                X = np.asarray(z["X"], np.float64)
                y = np.asarray(z["y"], np.float64)
                w = (np.asarray(z["weight"], np.float64)
                     if "weight" in z.files else None)
            return (X, y, w)
        raw = np.loadtxt(path, delimiter=",", ndmin=2)
        return (raw[:, 1:], raw[:, 0], None)

    def _pull(self, timeout_s: float) -> Optional[Any]:
        deadline = time.monotonic() + max(float(timeout_s), 0.0)
        while True:
            for path in self._candidates():
                try:
                    item = self._load(path)
                except Exception as e:
                    # a torn/partial drop: leave it for the next poll
                    # (producers should write-temp-then-rename; one that
                    # does not gets retried, not crashed on)
                    log_warning(f"online source: could not read {path} "
                                f"({e}); will retry")
                    continue
                self._consumed.add(os.path.basename(path))
                return item
            if time.monotonic() >= deadline:
                return None
            time.sleep(min(self.poll_s, 0.05))

    def seek(self, n_batches: int) -> None:
        """Mark the first ``n_batches`` files (sorted order) consumed
        without loading them — resume replay over a stable directory."""
        for path in self._candidates()[:int(n_batches)]:
            self._consumed.add(os.path.basename(path))
        log_info(f"online source: sought past {n_batches} consumed "
                 f"file(s) in {self.directory}")
        self.seq = int(n_batches)


class TraceSource(BatchSource):
    """Replay a recorded trace: an ``.npz`` holding ``X`` [N, F], ``y``
    [N], optional ``weight`` [N] and ``batch_sizes`` [B] (row counts per
    micro-batch; when absent, ``batch_rows`` slices uniformly). Fully
    deterministic and seekable: the kill / resume md5 checks run on
    it."""

    def __init__(self, path_or_arrays, fault_plan=None,
                 batch_rows: int = 256) -> None:
        super().__init__(fault_plan)
        if isinstance(path_or_arrays, (str, os.PathLike)):
            with np.load(str(path_or_arrays)) as z:
                X = np.asarray(z["X"], np.float64)
                y = np.asarray(z["y"], np.float64)
                w = (np.asarray(z["weight"], np.float64)
                     if "weight" in z.files else None)
                sizes = (np.asarray(z["batch_sizes"], np.int64)
                         if "batch_sizes" in z.files else None)
        else:
            X, y, w, sizes = path_or_arrays
            X = np.asarray(X, np.float64)
            y = np.asarray(y, np.float64)
            w = None if w is None else np.asarray(w, np.float64)
            sizes = None if sizes is None else np.asarray(sizes, np.int64)
        if sizes is None:
            n = X.shape[0]
            step = max(int(batch_rows), 1)
            sizes = np.diff(np.arange(0, n + step, step).clip(max=n))
            sizes = sizes[sizes > 0]
        self.X, self.y, self.weight = X, y, w
        self.offsets = np.concatenate(
            [[0], np.cumsum(np.asarray(sizes, np.int64))])
        if int(self.offsets[-1]) != X.shape[0]:
            raise ValueError(
                f"trace batch_sizes sum to {int(self.offsets[-1])} but "
                f"the trace holds {X.shape[0]} rows")

    @property
    def num_batches(self) -> int:
        return len(self.offsets) - 1

    def _pull(self, timeout_s: float) -> Optional[Any]:
        if self.seq >= self.num_batches:
            self.exhausted = True
            return None
        lo, hi = int(self.offsets[self.seq]), int(self.offsets[self.seq + 1])
        w = None if self.weight is None else self.weight[lo:hi]
        return (self.X[lo:hi], self.y[lo:hi], w)

    def seek(self, n_batches: int) -> None:
        self.seq = int(n_batches)
        if self.seq >= self.num_batches:
            self.exhausted = True


def _split_label(mat: np.ndarray, label_column: int,
                 weight_column: Optional[int]):
    """Matrix -> (X, y[, weight]) by column index (the CSV ``label in
    column 0`` convention generalized)."""
    cols = [c for c in range(mat.shape[1])
            if c != label_column and c != weight_column]
    w = None if weight_column is None else mat[:, weight_column]
    return mat[:, cols], mat[:, label_column], w


class ArrowSource(BatchSource):
    """Micro-batches from pyarrow data. Accepts a ``pa.Table`` (sliced
    into ``batch_rows`` chunks, SEEKABLE) or any iterator/reader of
    ``pa.RecordBatch``/``pa.Table`` items (streamed, not seekable —
    e.g. ``RecordBatchFileReader``/flight streams the caller owns).
    The label (and optional weight) ride along as columns, split out by
    index after the same Arrow→numpy conversion ``Dataset`` uses
    (basic.py ``_arrow_to_numpy``) — so a batch that would not bin for
    Dataset construction fails the same way here."""

    def __init__(self, data, fault_plan=None, batch_rows: int = 256,
                 label_column: int = 0,
                 weight_column: Optional[int] = None) -> None:
        super().__init__(fault_plan)
        from ..basic import _is_arrow
        self.label_column = int(label_column)
        self.weight_column = weight_column if weight_column is None \
            else int(weight_column)
        self.batch_rows = max(int(batch_rows), 1)
        if _is_arrow(data) and hasattr(data, "slice"):   # Table
            self._table = data
            self._it = None
        else:
            self._table = None
            self._it = iter(data)

    def _convert(self, chunk) -> Any:
        from ..basic import _arrow_to_numpy
        mat = _arrow_to_numpy(chunk)
        return _split_label(mat, self.label_column, self.weight_column)

    def _pull(self, timeout_s: float) -> Optional[Any]:
        if self._table is not None:
            lo = self.seq * self.batch_rows
            if lo >= self._table.num_rows:
                self.exhausted = True
                return None
            return self._convert(self._table.slice(lo, self.batch_rows))
        try:
            return self._convert(next(self._it))
        except StopIteration:
            self.exhausted = True
            return None

    def seek(self, n_batches: int) -> None:
        if self._table is None:
            raise NotImplementedError(
                "ArrowSource over a record-batch stream is not seekable; "
                "resume replays from the live position")
        self.seq = int(n_batches)
        if self.seq * self.batch_rows >= self._table.num_rows:
            self.exhausted = True


class SequenceSource(BatchSource):
    """Replay a :class:`lightgbm_tpu_torch.Sequence` (out-of-core row
    access, basic.py) as micro-batches of ``seq.batch_size`` rows (override with
    ``batch_rows``), label split out by column like :class:`ArrowSource`.
    Random access makes it SEEKABLE — the same kill/resume contract as
    :class:`TraceSource`, without materializing the data."""

    def __init__(self, sequence, fault_plan=None, batch_rows: int = 0,
                 label_column: int = 0,
                 weight_column: Optional[int] = None) -> None:
        super().__init__(fault_plan)
        if not (hasattr(sequence, "__len__")
                and hasattr(sequence, "__getitem__")):
            raise TypeError(
                f"SequenceSource needs __len__/__getitem__ (the "
                f"lightgbm_tpu_torch.Sequence interface), got "
                f"{type(sequence).__name__}")
        self.sequence = sequence
        self.batch_rows = int(batch_rows) if batch_rows > 0 else \
            int(getattr(sequence, "batch_size", 65536))
        self.label_column = int(label_column)
        self.weight_column = weight_column if weight_column is None \
            else int(weight_column)

    def _pull(self, timeout_s: float) -> Optional[Any]:
        lo = self.seq * self.batch_rows
        n = len(self.sequence)
        if lo >= n:
            self.exhausted = True
            return None
        mat = np.asarray(
            self.sequence[lo:min(lo + self.batch_rows, n)], np.float64)
        if mat.ndim == 1:
            mat = mat.reshape(1, -1)
        return _split_label(mat, self.label_column, self.weight_column)

    def seek(self, n_batches: int) -> None:
        self.seq = int(n_batches)
        if self.seq * self.batch_rows >= len(self.sequence):
            self.exhausted = True


def save_trace(path: str, X, y, weight=None, batch_sizes=None) -> None:
    """Write a TraceSource ``.npz``."""
    arrays = {"X": np.asarray(X, np.float64),
              "y": np.asarray(y, np.float64)}
    if weight is not None:
        arrays["weight"] = np.asarray(weight, np.float64)
    if batch_sizes is not None:
        arrays["batch_sizes"] = np.asarray(batch_sizes, np.int64)
    np.savez(path, **arrays)


def open_source(spec, fault_plan=None,
                batch_rows: int = 256) -> BatchSource:
    """CLI/API entry (``online_source=...``): a directory tails, an
    ``.npz`` file replays as a trace; programmatic callers may also pass
    a ready :class:`BatchSource`, a pyarrow Table/RecordBatch stream, or
    a :class:`lightgbm_tpu_torch.Sequence` directly."""
    if isinstance(spec, BatchSource):
        return spec
    if not isinstance(spec, (str, os.PathLike)):
        from ..basic import Sequence, _is_arrow
        if _is_arrow(spec):   # Table, RecordBatch, or a pyarrow reader
            return ArrowSource(spec, fault_plan=fault_plan,
                               batch_rows=batch_rows)
        if isinstance(spec, Sequence) or (
                hasattr(spec, "__len__") and hasattr(spec, "__getitem__")):
            return SequenceSource(spec, fault_plan=fault_plan)
        raise TypeError(
            f"online_source of type {type(spec).__name__} is not a path, "
            "BatchSource, pyarrow data, or Sequence")
    spec = str(spec)
    if os.path.isdir(spec):
        return DirectorySource(spec, fault_plan=fault_plan)
    if os.path.isfile(spec) and spec.endswith(".npz"):
        return TraceSource(spec, fault_plan=fault_plan,
                           batch_rows=batch_rows)
    raise FileNotFoundError(
        f"online_source={spec!r} is neither a directory to tail nor a "
        ".npz trace file")
