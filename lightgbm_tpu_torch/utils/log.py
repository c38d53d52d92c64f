"""Logging for lightgbm_tpu_torch.

Analog of the reference logger (include/LightGBM/utils/log.h:89):
levels Debug/Info/Warning/Fatal, where Fatal raises instead of aborting, and
the sink is redirectable (the reference exposes LGBM_RegisterLogCallback,
src/c_api.cpp:980; here `register_logger` mirrors the python-package API).
"""

from __future__ import annotations

import logging
import sys
from typing import Any

_logger: Any = logging.getLogger("lightgbm_tpu_torch")
_logger.addHandler(logging.StreamHandler(sys.stdout))
_logger.setLevel(logging.INFO)

_info_method_name = "info"
_warning_method_name = "warning"

# verbosity: <0 = fatal only, 0 = error/warning, 1 = info, >1 = debug
_verbosity = 1


class FatalError(RuntimeError):
    """Raised by log_fatal; the analog of Log::Fatal's thrown std::runtime_error."""


def register_logger(
    logger: Any,
    info_method_name: str = "info",
    warning_method_name: str = "warning",
) -> None:
    """Redirect library logging into a custom logger object."""
    global _logger, _info_method_name, _warning_method_name
    for name in (info_method_name, warning_method_name):
        if not callable(getattr(logger, name, None)):
            raise TypeError(f"logger must have a callable `{name}` method")
    _logger = logger
    _info_method_name = info_method_name
    _warning_method_name = warning_method_name


def set_verbosity(verbosity: int) -> None:
    global _verbosity
    _verbosity = verbosity


def log_debug(msg: str) -> None:
    if _verbosity > 1:
        getattr(_logger, _info_method_name)(f"[LightGBM-TPU] [Debug] {msg}")


def log_info(msg: str) -> None:
    if _verbosity >= 1:
        getattr(_logger, _info_method_name)(f"[LightGBM-TPU] [Info] {msg}")


def log_warning(msg: str) -> None:
    if _verbosity >= 0:
        getattr(_logger, _warning_method_name)(f"[LightGBM-TPU] [Warning] {msg}")


def log_fatal(msg: str) -> None:
    raise FatalError(f"[LightGBM-TPU] [Fatal] {msg}")
