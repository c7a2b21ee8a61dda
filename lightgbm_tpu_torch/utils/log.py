"""Logging for lightgbm_tpu_torch (a copy of the JAX package's module).

Mirrors the reference's Log class + registerable callback
(ref: include/LightGBM/utils/log.h `Log`, python-package/lightgbm/basic.py
`_log_callback` / `register_logger`): Fatal raises, Error/Warning/Info/Debug
route through a swappable Python logger.

Verbosity is the single source of truth: `set_verbosity` syncs the
underlying `logging` level too, so a registered stdlib logger left at
WARNING doesn't silently drop the info/debug output the user just asked
for with verbosity=2.
"""
from __future__ import annotations

import logging
from typing import Any

_logger: Any = logging.getLogger("lightgbm_tpu_torch")
_logger.setLevel(logging.INFO)
if not _logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[LightGBM-Torch] %(message)s"))
    _logger.addHandler(_h)

_info_method_name = "info"
_warning_method_name = "warning"

# LightGBM verbosity: <0 fatal only, 0 warning+, 1 info+ (default), >1 debug+
_verbosity = 1


def _logging_level(verbosity: int) -> int:
    if verbosity < 0:
        return logging.CRITICAL
    if verbosity == 0:
        return logging.WARNING
    if verbosity == 1:
        return logging.INFO
    return logging.DEBUG


def _sync_level() -> None:
    """Push the LightGBM verbosity onto the active logger, when it speaks
    the stdlib protocol — a duck-typed logger without setLevel keeps its
    own filtering."""
    setter = getattr(_logger, "setLevel", None)
    if callable(setter):
        setter(_logging_level(_verbosity))


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = int(level)
    _sync_level()


def register_logger(logger: Any, info_method_name: str = "info",
                    warning_method_name: str = "warning") -> None:
    """Register a custom logger (parity with lightgbm.register_logger)."""
    global _logger, _info_method_name, _warning_method_name
    if not all(hasattr(logger, m) for m in (info_method_name, warning_method_name)):
        raise TypeError("Logger must provide info and warning methods")
    _logger = logger
    _info_method_name = info_method_name
    _warning_method_name = warning_method_name
    _sync_level()


def debug(msg: str) -> None:
    if _verbosity > 1:
        # a logger with a real debug channel gets debug-severity records;
        # duck-typed loggers fall back to their registered info method
        method = getattr(_logger, "debug", None)
        if not callable(method):
            method = getattr(_logger, _info_method_name)
        method(msg)


def info(msg: str) -> None:
    if _verbosity >= 1:
        getattr(_logger, _info_method_name)(msg)


def warning(msg: str) -> None:
    if _verbosity >= 0:
        getattr(_logger, _warning_method_name)(msg)


def error(msg: str) -> None:
    """Error-severity report for degraded-but-alive paths (probe-gated
    kernel fallbacks, dead sinks): louder than warning where the logger
    distinguishes, never raises — `fatal` is the raising channel."""
    if _verbosity >= 0:
        method = getattr(_logger, "error", None)
        if not callable(method):
            method = getattr(_logger, _warning_method_name)
        method(msg)


class LightGBMError(Exception):
    """Error raised by lightgbm_tpu_torch (parity with lightgbm.basic.LightGBMError)."""


def fatal(msg: str) -> None:
    raise LightGBMError(msg)
