"""Inference on the port's packed trees (lightgbm_tpu/serving/ counterpart).

 * session.py   ServingSession: pinned packed trees, per-bucket scorer
                cache, pow2 padding, warmup; host / device / binned /
                compiled engines; breaker-guarded chunks
 * batcher.py   MicroBatcher: coalesce concurrent small requests, deadline
                propagation, worker heartbeat
 * admission.py AdmissionController: per-client token buckets, overload
                watermarks with hysteresis, reject_new / drop_oldest
 * breaker.py   CircuitBreaker: device -> host degradation on repeated
                failures or latency-SLO misses, half-open recovery
 * registry.py  ModelRegistry: named sessions, atomic hot-swap, snapshot
                watching
 * metrics.py   ServingMetrics: QPS / p50 / p99 / occupancy / hit rate,
                shed and breaker counters, live states
 * fleet.py     ModelFleet: many tenants behind one worker (per-tenant
                registry / breaker / admission / metrics, EDF continuous
                batching across tenants, the fused cross-tenant drain)
"""

from .admission import (AdmissionController, OverloadedError,
                        RateLimitedError, ShedError)
from .batcher import MicroBatcher, QueueFullError, RequestTimeout
from .breaker import CircuitBreaker
from .fleet import ModelFleet
from .metrics import ServingMetrics
from .registry import ModelRegistry
from .session import CompiledPredictorCache, ServingSession, bucket_for

__all__ = [
    "ServingSession", "CompiledPredictorCache", "bucket_for",
    "MicroBatcher", "QueueFullError", "RequestTimeout",
    "AdmissionController", "ShedError", "RateLimitedError",
    "OverloadedError", "CircuitBreaker",
    "ModelRegistry", "ServingMetrics", "ModelFleet",
]
