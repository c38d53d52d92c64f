"""Inference on the port's packed trees (lightgbm_tpu/serving/ counterpart).

 * session.py   ServingSession: pinned packed trees, per-bucket scorer
                cache, pow2 padding, warmup; host / device / binned engines
 * batcher.py   MicroBatcher: coalesce concurrent small requests, deadline
                propagation, worker heartbeat
 * registry.py  ModelRegistry: named sessions, atomic hot-swap
 * metrics.py   ServingMetrics: QPS / p50 / p99 / occupancy / hit rate

The admission layer, the circuit breaker, the fleet and snapshot watching
are ROADMAP items A17/A18.
"""

from .batcher import MicroBatcher, QueueFullError, RequestTimeout
from .metrics import ServingMetrics
from .registry import ModelRegistry
from .session import CompiledPredictorCache, ServingSession, bucket_for

__all__ = [
    "ServingSession", "CompiledPredictorCache", "bucket_for",
    "MicroBatcher", "QueueFullError", "RequestTimeout",
    "ModelRegistry", "ServingMetrics",
]
