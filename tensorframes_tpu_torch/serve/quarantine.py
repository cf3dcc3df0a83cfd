"""Poison-query quarantine: per-fingerprint permanent-failure streaks.

The port's counterpart of ``tensorframes_tpu/serve/quarantine.py``. A
query that fails deterministically costs its full retry budget at every
submission, for every tenant that submits the same plan. This registry
keeps a **permanent-failure streak per plan fingerprint**
(:func:`~..plan.adaptive.query_fingerprint`, the key the performance
sentinel and the durable result tier use). After
``TFT_QUARANTINE_AFTER`` consecutive permanent failures (3; 0 disables)
the fingerprint is quarantined: the scheduler rejects it at submit with a
classified :class:`~..resilience.QueryQuarantined` before it touches a
queue, a quota or a worker.

Only **permanent** classifications count (``resilience.classify``):
transient faults, OOM splits, preemptions, cancellations and load
rejections are the resilience layer at work, not evidence of a poison
plan. A success resets the streak.

A quarantine lifts after ``TFT_QUARANTINE_TTL_S`` (300 s) into ONE probe
admission, whose streak restarts at ``threshold - 1`` (a plan still
poison is quarantined again at the probe's failure), or at once through
``ttf.unquarantine()``. Shown in ``ttf.doctor()``, ``health()`` and
``serve_report()``; every transition is flight-recorded. The registry is
process-wide.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..resilience import env_float, env_int
from ..resilience.classify import QueryQuarantined
from ..utils.logging import get_logger
from ..utils.tracing import counters

__all__ = ["check", "note_failure", "note_success", "unquarantine",
           "status", "quarantine_status", "reset", "QueryQuarantined"]

_log = get_logger("serve.quarantine")

_lock = threading.Lock()
_streaks: Dict[str, int] = {}
# fp -> {"until": monotonic, "failures": n, "error": str}
_quarantined: Dict[str, dict] = {}


def _threshold() -> int:
    return env_int("TFT_QUARANTINE_AFTER", 3)


def _ttl() -> float:
    return env_float("TFT_QUARANTINE_TTL_S", 300.0)


def check(fp: Optional[str]) -> None:
    """Submit-time gate: raise :class:`QueryQuarantined` while ``fp``
    is quarantined; expire an aged quarantine into one probe admission
    (streak restarts at ``threshold - 1``)."""
    if fp is None or _threshold() <= 0:
        return
    with _lock:
        entry = _quarantined.get(fp)
        if entry is None:
            return
        remaining = entry["until"] - time.monotonic()
        if remaining <= 0:
            # TTL expired: this submission is the probe
            del _quarantined[fp]
            _streaks[fp] = max(_threshold() - 1, 0)
            failures = entry["failures"]
        else:
            failures = entry["failures"]
            error = entry["error"]
    from ..observability import flight as _flight
    if remaining <= 0:
        counters.inc("serve.quarantine_expired")
        _flight.record("serve.quarantine_expire", fingerprint=fp,
                       failures=failures)
        _log.info("quarantine on %s expired; admitting one probe", fp)
        return
    counters.inc("serve.quarantined")
    _flight.record("serve.quarantine_reject", fingerprint=fp,
                   failures=failures, ttl_remaining_s=round(remaining, 1))
    raise QueryQuarantined(
        f"plan fingerprint {fp} is quarantined: {failures} consecutive "
        f"permanent failures (last: {error}); expires in "
        f"{remaining:.0f}s, or lift it with ttf.unquarantine({fp!r})")


def note_failure(fp: Optional[str], error: BaseException) -> None:
    """Count one PERMANENT failure of ``fp``; quarantine at the
    threshold. The caller has already classified — transient/OOM/
    preempt/rejection outcomes must never reach here."""
    threshold = _threshold()
    if fp is None or threshold <= 0:
        return
    with _lock:
        if fp in _quarantined:
            return  # already quarantined (a racing in-flight run)
        streak = _streaks.get(fp, 0) + 1
        _streaks[fp] = streak
        if streak < threshold:
            quarantine = False
        else:
            quarantine = True
            del _streaks[fp]
            _quarantined[fp] = {"until": time.monotonic() + _ttl(),
                                "failures": streak,
                                "error": f"{type(error).__name__}: {error}"}
    if not quarantine:
        return
    counters.inc("serve.quarantines")
    from ..observability import flight as _flight
    _flight.record("serve.quarantine", fingerprint=fp, failures=streak,
                   ttl_s=_ttl(), error=str(error)[:200])
    _log.warning(
        "QUARANTINED plan fingerprint %s after %d consecutive permanent "
        "failures (%s: %s); submissions fast-reject for %.0fs "
        "(ttf.unquarantine() lifts it)", fp, streak,
        type(error).__name__, error, _ttl())


def note_success(fp: Optional[str]) -> None:
    """A completed run clears the fingerprint's streak."""
    if fp is None:
        return
    with _lock:
        _streaks.pop(fp, None)


def unquarantine(fp: Optional[str] = None) -> int:
    """Lift quarantines (and their streaks): one fingerprint, or every
    one when ``fp`` is ``None``. Returns how many were active. Exported
    as ``ttf.unquarantine``."""
    with _lock:
        if fp is None:
            lifted = list(_quarantined)
            _quarantined.clear()
            _streaks.clear()
        else:
            lifted = [fp] if _quarantined.pop(fp, None) is not None else []
            _streaks.pop(fp, None)
    if lifted:
        counters.inc("serve.unquarantined", len(lifted))
        from ..observability import flight as _flight
        for f in lifted:
            _flight.record("serve.unquarantine", fingerprint=f)
            _log.info("quarantine on %s lifted manually", f)
    return len(lifted)


def status() -> dict:
    """Registry snapshot for ``health()`` / ``doctor()`` /
    ``serve_report()``."""
    now = time.monotonic()
    with _lock:
        active = {fp: {"failures": e["failures"],
                       "error": e["error"],
                       "ttl_remaining_s": round(max(e["until"] - now, 0.0),
                                                1)}
                  for fp, e in _quarantined.items()}
        streaks = dict(_streaks)
    return {"threshold": _threshold(), "ttl_s": _ttl(),
            "active": active, "streaks": streaks}


def reset() -> None:
    """Drop every streak and quarantine (tests)."""
    with _lock:
        _streaks.clear()
        _quarantined.clear()


# the package surface's spelling (``serve.quarantine_status``,
# ``ttf.quarantine_status``: ``status`` alone is too generic there)
quarantine_status = status
