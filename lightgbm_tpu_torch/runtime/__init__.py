"""Runtime subsystem: device profiling, strategy autotuning, checkpoints
and fault plans.

Counterpart of lightgbm_tpu/runtime/:

 * `profiler` — per-iteration stage spans fenced by
   ``torch.cuda.synchronize`` of the training device, throughput
   counters, an HBM watermark (``torch.cuda.max_memory_allocated``), a
   ring buffer and JSON export (``device_profile=true``,
   ``Booster.get_profile``, the ``record_profile`` callback).
 * `autotune` — at train init, short timed probes of the feasible growers,
   the histogram routes and the fused wave on a row subsample of the real
   binned matrix, cached in-process and on disk (``autotune=true``); and
   the binning probe of ``binning_impl=auto``.
 * `checkpoint` — iteration-level deterministic checkpoint / resume:
   atomic writes with checksummed manifests, bounded retention, and a
   resumed run's model bytes equal to an uninterrupted run's
   (``checkpoint_interval``, ``checkpoint_dir``,
   ``resume_from_checkpoint``).
 * `faults` — deterministic fault-injection plans (``fault_plan`` or
   LIGHTGBM_TPU_FAULT_PLAN): kill / raise / sleep / corrupt_snapshot /
   fail_collective on the training path, slow_score / fail_score /
   wedge_worker on the serving path, stall_source / corrupt_batch on the
   online loop's sources.

All default off; ``autotune=false`` keeps the ladder's choice and
``checkpoint_interval=0`` leaves the training loop untouched.
"""

from .autotune import (AUTOTUNE_PREFERENCE, autotune_decision,  # noqa: F401
                       load_disk_cache, make_key, save_disk_cache)
from .profiler import (LatencyStats, StageProfiler, Timer,  # noqa: F401
                       count_kernel_launches, device_barrier, global_timer,
                       trace)
from .checkpoint import (CheckpointError, CheckpointManager,  # noqa: F401
                         atomic_write_bytes, atomic_write_text,
                         capture_trainer_state, load_checkpoint,
                         restore_trainer_state, verify_manifest,
                         write_manifest)
from .faults import (CollectiveFault, FaultPlan,  # noqa: F401
                     InjectedFault, active_plan)
