"""Exported and fused serving (lightgbm_tpu/export/ counterpart).

``compile``  the exporter: freeze a trained model into a standalone
artifact directory of ``torch.export`` programs, one a batch bucket, plus
the in-process save -> load round trip behind
``ServingSession(engine="compiled")``.
``runtime``  the standalone loader of those artifacts (no
``lightgbm_tpu_torch.models`` / ``engine`` / ``basic`` imports); this
package's ``load_compiled`` is its loader with the bucketize kernel
attached on a card (``compile.attach_bucketize``).
``fusion``   cross-tenant forest fusion: many tenants' binned forests
packed into one padded supertensor scored by one walk with a per-row
tenant id (the fleet's fused drain, serving/fleet.py).
"""

from .compile import (attach_bucketize, export_model, load_compiled,
                      roundtrip_binned_scorer, roundtrip_raw_scorer)
from .fusion import FusedForest, FusedScorer, predict_margin_fused
from .runtime import CompiledModel

__all__ = [
    "export_model", "roundtrip_binned_scorer", "roundtrip_raw_scorer",
    "CompiledModel", "attach_bucketize", "load_compiled",
    "FusedForest", "FusedScorer", "predict_margin_fused",
]
