"""Distributed / multi-device layer (reference: src/network/ and the
parallel tree learners; lightgbm_tpu/parallel/), over the default
torch.distributed process group, one process per rank."""

from ..runtime.faults import COLLECTIVE_ERROR_MARKERS, is_collective_error
from .context import DATA_AXIS, FEATURE_AXIS, DistContext, make_data_mesh
from .data_parallel import (build_data_parallel_train_fn,
                            build_sharded_score_fn, lane_multiple,
                            pad_rows_to, replicated, shard_rows)
from .distributed import init_distributed

__all__ = [
    "DATA_AXIS", "FEATURE_AXIS", "DistContext", "make_data_mesh",
    "build_data_parallel_train_fn", "build_sharded_score_fn",
    "lane_multiple", "pad_rows_to", "shard_rows", "replicated",
    "init_distributed", "COLLECTIVE_ERROR_MARKERS", "is_collective_error",
]
