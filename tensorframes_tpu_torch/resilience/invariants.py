"""Cross-cutting invariant auditors at quiesce points.

The port's counterpart of ``tensorframes_tpu/resilience/invariants.py``.
Each subsystem keeps local books: the slot pool counts leases
(``engine/pipeline.py``), the memory ledger counts reserved and resident
bytes (``memory/manager.py``), checkpoints carry resume cursors
(``memory/checkpoint.py``), the scheduler counts queued and running
queries per tenant (``serve/scheduler.py``), the serving fabric keeps
every query attached to a worker (``serve/fabric.py``). Each book
balances by construction on the paths its own tests drive. This module
audits the books against each other at quiesce points (a stream's batch
boundary, a fused query's close, a query's finish, a scheduler's close,
the chaos drill's checkpoints), where a composed fault (``.chaos``) would
surface as a leak no single subsystem can see: a lease left behind by an
error that unwound through two layers, a reservation released twice, a
query neither queued nor running nor finished.

Two modes, one knob pair:

- **always-on** (the default): every :func:`audit` runs, violations are
  flight-recorded (``invariant.violation``), counted
  (``invariants.violations`` + ``invariants.<auditor>.violations``) and
  logged, never raised; ``TFT_INVARIANTS=0`` bypasses even that;
- **strict** (an active chaos schedule, tests,
  ``TFT_INVARIANTS_STRICT=1``, or the :func:`strict` context): a
  violation also raises a classified
  :class:`~.classify.InvariantViolation` at the quiesce point.

Built-in auditors, consulted live at each audit: slot-pool lease balance,
memory-ledger reservation balance with spillable-registry consistency,
every live serving scheduler's queue, running and in-flight accounting
(no orphaned query at its close), and the live fabric's no-orphan
accounting (every fabric query placed on a real worker, or done).
:func:`register` adds process-wide custom auditors.

Per-query row conservation is threaded, not global: ``plan/execute.py``
opens a :func:`row_ledger` around a row-local fused plan, filter stages
:func:`note_filtered` their masked-out rows, and the close checks
``rows in == rows out + rows filtered``. A preemption resume restoring a
prior attempt's prefix calls :func:`taint_rows`, and the check is skipped,
not faked. :func:`conserve` raises in every mode.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
from typing import Callable, Dict, Iterator, List, Optional

from ..utils.logging import get_logger
from ..utils.tracing import counters
from .classify import InvariantViolation

__all__ = ["audit", "register", "unregister", "strict", "strict_mode",
           "enabled", "violate", "check", "conserve", "row_ledger",
           "note_filtered", "note_emitted", "taint_rows",
           "InvariantViolation"]

_log = get_logger("resilience.invariants")

_lock = threading.Lock()
_strict_depth = 0
_custom: Dict[str, Callable[[str], List[str]]] = {}

# the open per-query row ledger, if any: {"filtered", "out", "tainted"};
# a contextvar so that concurrent queries keep separate books
_row_ledger: "contextvars.ContextVar[Optional[dict]]" = \
    contextvars.ContextVar("tft_row_ledger", default=None)


def enabled() -> bool:
    """Auditors run unless ``TFT_INVARIANTS=0``."""
    return os.environ.get("TFT_INVARIANTS", "1") != "0"


def strict_mode() -> bool:
    """Raise on violation? True inside :func:`strict`, under an active
    chaos schedule, or with ``TFT_INVARIANTS_STRICT=1``."""
    if _strict_depth > 0:
        return True
    if os.environ.get("TFT_INVARIANTS_STRICT", "") not in ("", "0"):
        return True
    from . import chaos as _chaos
    return _chaos.active() is not None


@contextlib.contextmanager
def strict() -> Iterator[None]:
    """Scoped strict mode: violations raise."""
    global _strict_depth
    with _lock:
        _strict_depth += 1
    try:
        yield
    finally:
        with _lock:
            _strict_depth -= 1


def register(name: str, fn: Callable[[str], List[str]]) -> None:
    """Add a process-wide auditor: ``fn(point)`` returns violation
    messages (an empty list is clean)."""
    with _lock:
        _custom[name] = fn


def unregister(name: str) -> None:
    with _lock:
        _custom.pop(name, None)


def _record(auditor: str, point: str, msg: str) -> None:
    counters.inc("invariants.violations")
    counters.inc(f"invariants.{auditor}.violations")
    from ..observability import flight as _flight
    _flight.record("invariant.violation", auditor=auditor, point=point,
                   detail=msg)
    _log.warning("INVARIANT VIOLATION [%s @ %s]: %s", auditor, point, msg)


def violate(auditor: str, msg: str, point: str = "inline") -> None:
    """Report one violation found outside :func:`audit`: count and
    flight-record always, raise :class:`InvariantViolation` in strict
    mode."""
    _record(auditor, point, msg)
    if strict_mode():
        raise InvariantViolation(f"[{auditor} @ {point}] {msg}")


def check(cond: bool, auditor: str, msg: str,
          point: str = "inline") -> bool:
    """``violate`` unless ``cond``; returns ``cond``, so that always-on
    callers can take the cold path instead of trusting bad state."""
    if not cond and enabled():
        violate(auditor, msg, point)
    return cond


def conserve(expected: int, actual: int, what: str) -> None:
    """Row conservation that raises in every mode: losing or duplicating
    rows is never a count-and-continue condition."""
    if expected == actual:
        return
    msg = f"{what} row conservation violated: {expected} in, {actual} out"
    _record("rows", what, msg)
    raise InvariantViolation(msg)


# -- per-query row ledger --------------------------------------------------
@contextlib.contextmanager
def row_ledger(rows_in: int, what: str) -> Iterator[None]:
    """Audit ``rows in == rows out + rows filtered`` across a row-local
    plan execution; the body reports its output rows through
    :func:`note_emitted`."""
    if not enabled():
        yield
        return
    ledger = {"filtered": 0, "out": None, "tainted": False}
    token = _row_ledger.set(ledger)
    try:
        yield
    finally:
        _row_ledger.reset(token)
    counters.inc("invariants.audits")
    if ledger["tainted"] or ledger["out"] is None:
        return
    rows_out = ledger["out"]
    filtered = ledger["filtered"]
    if rows_in != rows_out + filtered:
        violate("rows",
                f"{what}: {rows_in} rows admitted != {rows_out} emitted "
                f"+ {filtered} filtered", point=what)


def note_filtered(n: int) -> None:
    """A filter stage masked out ``n`` rows of the current query."""
    ledger = _row_ledger.get()
    if ledger is not None:
        ledger["filtered"] += int(n)


def note_emitted(n: int) -> None:
    """The current query's final emitted row count."""
    ledger = _row_ledger.get()
    if ledger is not None:
        ledger["out"] = int(n)


def taint_rows(reason: str) -> None:
    """Void the open row ledger (a resume restored a prior attempt's
    prefix, whose filter counts this ledger never saw)."""
    ledger = _row_ledger.get()
    if ledger is not None and not ledger["tainted"]:
        ledger["tainted"] = True
        counters.inc("invariants.rows.tainted")
        _log.debug("row ledger tainted: %s", reason)


# -- built-in auditors -----------------------------------------------------
def _audit_slots(point: str) -> List[str]:
    from ..engine import pipeline as _pipeline
    pool = _pipeline.current_slot_pool()
    if pool is None:
        return []
    leased = pool.leased()
    out = []
    if leased < 0:
        out.append(f"slot pool leased count is negative ({leased}): "
                   f"a release without an acquire")
    elif leased > pool.slots:
        out.append(f"slot pool over-leased: {leased} leases against "
                   f"{pool.slots} slots")
    elif leased != 0 and point.endswith(".close"):
        out.append(f"slot pool still holds {leased} lease(s) at "
                   f"{point}: leaked by an unwound stream")
    return out


def _audit_memory(point: str) -> List[str]:
    from .. import memory as _memory
    m = _memory.active()
    if m is None:
        return []
    return m.audit()


def _audit_scheduler(point: str) -> List[str]:
    from ..serve.scheduler import live_schedulers
    out: List[str] = []
    for s in live_schedulers():
        out.extend(s.audit_invariants(point))
    return out


def _audit_fabric(point: str) -> List[str]:
    from ..serve.fabric import live_fabric
    f = live_fabric()
    if f is None:
        return []
    return f.audit_invariants(point)


_BUILTIN = (("slots", _audit_slots), ("memory", _audit_memory),
            ("scheduler", _audit_scheduler), ("fabric", _audit_fabric))


def audit(point: str) -> List[str]:
    """Run every auditor at a quiesce point; returns the violation
    messages (empty when clean). Always-on: count and flight-record;
    strict: raise one classified :class:`InvariantViolation` naming them
    all. An auditor that itself crashes is a violation too."""
    if not enabled():
        return []
    counters.inc("invariants.audits")
    with _lock:
        extra = list(_custom.items())
    found: List[str] = []
    for name, fn in tuple(_BUILTIN) + tuple(extra):
        try:
            msgs = fn(point)
        except InvariantViolation:
            raise  # already recorded, and strict
        except Exception as e:
            msgs = [f"auditor crashed: {e!r}"]
        for msg in msgs:
            _record(name, point, msg)
            found.append(f"[{name}] {msg}")
    if found and strict_mode():
        raise InvariantViolation(
            f"{len(found)} invariant violation(s) at {point}: "
            + "; ".join(found))
    return found
