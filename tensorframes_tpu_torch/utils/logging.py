"""Logging shim: every module takes a child of the package logger.

The counterpart of ``tensorframes_tpu/utils/logging.py``:

- every module takes a child of the ``tensorframes_tpu_torch`` logger
  through :func:`get_logger`;
- :func:`initialize_logging` installs a stderr handler and format once and
  sets the package level (argument, else ``TFT_LOG_LEVEL``, else
  WARNING);
- :func:`set_level` sets the level by number or name;
- a TRACE level below DEBUG, with a ``trace`` method on every package
  logger.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

__all__ = ["TRACE", "get_logger", "initialize_logging", "set_level"]

# TRACE below DEBUG, registered once
TRACE = 5
if logging.getLevelName(TRACE) != "TRACE":
    logging.addLevelName(TRACE, "TRACE")

_ROOT_NAME = "tensorframes_tpu_torch"
_initialized = False
_handler: Optional[logging.StreamHandler] = None


def _trace(self: logging.Logger, msg, *args, **kwargs):
    if self.isEnabledFor(TRACE):
        self._log(TRACE, msg, args, **kwargs)


def _package_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not hasattr(logger, "trace"):
        logger.trace = _trace.__get__(logger)
    return logger


_root_logger = _package_logger(_ROOT_NAME)


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """Return the package logger or a child of it:
    ``get_logger("engine.ops")`` -> ``tensorframes_tpu_torch.engine.ops``."""
    if not name or name == _ROOT_NAME:
        return _root_logger
    if name.startswith(_ROOT_NAME + "."):
        name = name[len(_ROOT_NAME) + 1:]
    return _package_logger(_ROOT_NAME + "." + name)


def initialize_logging(level: Optional[int] = None,
                       stream=None) -> logging.Logger:
    """Install a stderr handler and format on the package logger
    (idempotent; a later call with ``stream`` moves the handler there).

    The level is ``level``, else ``TFT_LOG_LEVEL`` (a name, ``TRACE`` or a
    number), else WARNING."""
    global _initialized, _handler
    if level is None:
        env = os.environ.get("TFT_LOG_LEVEL")
        if env:
            known = getattr(logging, env.upper(), None)
            if isinstance(known, int):
                level = known
            elif env.upper() == "TRACE":
                level = TRACE
            else:
                try:
                    level = int(env)
                except ValueError:
                    _root_logger.warning(
                        "unrecognized TFT_LOG_LEVEL=%r; using WARNING", env)
                    level = logging.WARNING
        else:
            level = logging.WARNING
    if not _initialized:
        _handler = logging.StreamHandler(stream or sys.stderr)
        _handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        _root_logger.addHandler(_handler)
        _root_logger.propagate = False
        _initialized = True
    elif stream is not None:
        _handler.setStream(stream)
    _root_logger.setLevel(level)
    return _root_logger


def set_level(level) -> None:
    """Set the package log level (a number or a name, ``TRACE``
    included)."""
    if isinstance(level, str):
        name = level.upper()
        if name == "TRACE":
            level = TRACE
        else:
            level = getattr(logging, name, None)
            if not isinstance(level, int):
                raise ValueError(
                    f"Unknown log level {name!r}; expected one of "
                    f"TRACE, DEBUG, INFO, WARNING, ERROR, CRITICAL")
    _root_logger.setLevel(level)
