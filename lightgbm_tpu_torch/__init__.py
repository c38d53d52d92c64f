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

from .basic import Booster, Dataset, Sequence
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       record_evaluation, record_profile, reset_parameter)
from .config import Config, resolve_params
from .engine import CVBooster, cv, train
from .utils.log import FatalError, register_logger

__all__ = [
    "Booster", "CVBooster", "Config", "Dataset", "EarlyStopException",
    "FatalError", "cv", "early_stopping", "log_evaluation",
    "record_evaluation", "record_profile", "register_logger",
    "reset_parameter", "resolve_params", "Sequence", "train",
    "LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker",
    "create_tree_digraph", "plot_importance", "plot_metric", "plot_tree",
]

_SKLEARN_NAMES = ("LGBMModel", "LGBMClassifier", "LGBMRegressor",
                  "LGBMRanker")
_PLOTTING_NAMES = ("create_tree_digraph", "plot_importance", "plot_metric",
                   "plot_tree")


def __getattr__(name):
    # the scikit-learn estimators and the plotting functions load on first
    # use, so importing the package never imports scikit-learn, matplotlib
    # or graphviz
    if name in _SKLEARN_NAMES:
        from . import sklearn as _sk
        return getattr(_sk, name)
    if name in _PLOTTING_NAMES:
        from . import plotting as _pl
        return getattr(_pl, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
