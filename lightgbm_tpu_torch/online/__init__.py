"""The online learning loop: micro-batch streams, windowed refit and
warm-continue, zero-downtime snapshot publication.

Counterpart of lightgbm_tpu/online/, the same names:

 * :mod:`.source`: pull-based micro-batch sources (directory tail,
   callable, replayable trace, Arrow, Sequence) with the bin-compat guard
   and the ``stall_source`` / ``corrupt_batch`` fault hooks;
 * :mod:`.trainer`: :class:`OnlineTrainer`, the sliding window, the
   refresh policy (rows and staleness; every k-th refresh continues),
   checkpoint and resume, the profiler spans;
 * :mod:`.publisher`: :class:`SnapshotPublisher`, atomic snapshot files
   for a registry's watcher and / or direct promotion into a co-located
   serving session.

``task=online`` runs it from the command line (cli.py run_online).
"""

from .publisher import PUBLISH_MODES, SnapshotPublisher
from .source import (ArrowSource, BatchSource, CallableSource,
                     DirectorySource, MicroBatch, SchemaDriftError,
                     SequenceSource, TraceSource, check_batch_schema,
                     open_source, save_trace)
from .trainer import ONLINE_STATE_KIND, OnlineTrainer

__all__ = [
    "ArrowSource", "BatchSource", "CallableSource", "DirectorySource",
    "MicroBatch", "SchemaDriftError", "SequenceSource", "TraceSource",
    "check_batch_schema", "open_source", "save_trace", "PUBLISH_MODES",
    "SnapshotPublisher", "ONLINE_STATE_KIND", "OnlineTrainer",
]
