"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

The same `Dataset` / `Booster` / `train` surface and the same v4 text model
files as the JAX package, trained on an NVIDIA H100 through hand-written
Hopper kernels (``csrc/``, built with ``nvcc`` at first use). Every tensor
lives on the device named by the `device_type` parameter: "cuda" (the
default, an error without a card) or "cpu", where each kernel wrapper runs
its plain PyTorch version.

This package imports torch and numpy, never jax and nothing of
lightgbm_tpu.
"""

from .basic import Booster, Dataset
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import train
from .utils.log import FatalError, register_logger

__all__ = [
    "Booster", "Config", "Dataset", "EarlyStopException", "FatalError",
    "early_stopping", "log_evaluation", "record_evaluation",
    "register_logger", "reset_parameter", "train",
]
