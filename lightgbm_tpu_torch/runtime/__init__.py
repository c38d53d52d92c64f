"""Runtime subsystem: device profiling and strategy autotuning.

Counterpart of lightgbm_tpu/runtime/ (its checkpoint and fault modules wait
for ROADMAP item A17):

 * `profiler` — per-iteration stage spans fenced by
   ``torch.cuda.synchronize`` of the training device, throughput
   counters, an HBM watermark (``torch.cuda.max_memory_allocated``), a
   ring buffer and JSON export (``device_profile=true``,
   ``Booster.get_profile``, the ``record_profile`` callback).
 * `autotune` — at train init, short timed probes of the feasible growers,
   the histogram routes and the fused wave on a row subsample of the real
   binned matrix, cached in-process and on disk (``autotune=true``); and
   the binning probe of ``binning_impl=auto``.

Both default off; ``autotune=false`` keeps the ladder's choice.
"""

from .autotune import (AUTOTUNE_PREFERENCE, autotune_decision,  # noqa: F401
                       load_disk_cache, make_key, save_disk_cache)
from .profiler import (LatencyStats, StageProfiler, Timer,  # noqa: F401
                       count_kernel_launches, device_barrier, global_timer,
                       trace)
