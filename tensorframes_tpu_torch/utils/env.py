"""Environment knobs: the one parser for every ``TFT_*`` setting.

A leaf module (it imports nothing of the package but logging), so that
``resilience``, ``observability`` and the engine can all read their knobs
through it without an import cycle. Unset or empty means the default; a
malformed number is warned about and means the default too.
"""

from __future__ import annotations

import os
from typing import Optional

from .logging import get_logger

__all__ = ["env_float", "env_int", "env_bool"]

_log = get_logger("utils.env")


def env_float(name: str, default: Optional[float]) -> Optional[float]:
    """Float env knob; unset/empty/malformed (warned) → ``default``."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        _log.warning("ignoring malformed %s=%r", name, raw)
        return default


def env_int(name: str, default: int) -> int:
    """Int env knob; unset/empty/malformed (warned) → ``default``."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        _log.warning("ignoring malformed %s=%r", name, raw)
        return default


def env_bool(name: str, default: bool) -> bool:
    """Bool env knob; unset/empty → ``default``, ``0/false/False`` →
    False, anything else → True. The one truthiness parser for every
    switch (``TFT_OOM_SPLIT``, ``TFT_FUSE``, ...)."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw not in ("0", "false", "False")
