"""Deterministic fault injection for the resilience layer.

The port's counterpart of ``tensorframes_tpu/resilience/faults.py``. The
retry and fallback paths exist for failures that cannot be produced on
demand: a transient dispatch failure, a card that runs out of memory, a
readback that fails. This harness makes them reproducible: instrumented
sites call :func:`check(site) <check>`, which raises a scripted
:class:`InjectedFault` while that site's budget lasts, then goes quiet.
The port's CPU tests drive every recovery path this way, and
``chip_smoke.py`` drives them on the card beside a real
``torch.cuda.OutOfMemoryError``.

Two ways to arm a site:

- context manager (tests): ``with inject("dispatch", fail_n=2): ...``:
  the first two ``check("dispatch")`` calls raise, the third passes;
- environment: ``TFT_FAULTS="dispatch:2,oom:1"`` arms the same budgets at
  the first check of the process.

Sites the port fires (:func:`sites`):

========== ===========================================================
site        raised from
========== ===========================================================
compile     ``engine.executor.BlockExecutor`` before the eager call. The
            port compiles nothing per shape; the site stays so that the
            JAX tests' fault schedules mean the same thing in both
            packages
dispatch    ``engine.executor.BlockExecutor`` block dispatch
oom         ``engine.executor.BlockExecutor`` dispatch, OOM-shaped
drain       ``engine.executor.PendingBlock.drain`` pipelined readback
perf        ``plan.execute`` forcings: NEVER raises; :func:`slowdown`
            consumes the budget and sleeps ``TFT_FAULT_PERF_S`` seconds
            (default 0.05) inside the timed forcing
preempt     ``engine.preempt.boundary`` pipelined block boundary: NOT
            raised out of the query; the active preemption scope turns
            the fault into a preempt request, so ``TFT_FAULTS=preempt:N``
            parks a running query at its next N block boundaries
disk        ``memory.persist`` artifact reads: never raised out of a
            query (the persist tier is best-effort, a failed read is a
            cold path); armed with a message containing ``corrupt`` it
            flips a payload byte instead, for the checksum path
========== ===========================================================

``pad_compile`` has no counterpart: the port has no padding buckets, so
there is no bucketed compile to fail. The other sites of the JAX package
(``cluster_init``, ``dmap``, ``batch``, ``device``, ``worker``,
``pjrt_execute``), with the shaping of their faults (device loss, worker
loss), come with their layers (``ROADMAP.md`` A10, A11); arming one now
warns, as any unknown site does, and nothing checks it.

Counting is deterministic (a lock-guarded integer per site, decremented
per check), so a test asserting "succeeds on the 3rd attempt" is exact.
Seeded chaos schedules (``TFT_CHAOS``, ``resilience/chaos.py`` in the JAX
package, and the consult hook it installs here) are not ported
(``ROADMAP.md`` A11): with ``TFT_CHAOS`` set, the first check raises
``NotImplementedError``, and :func:`may_fire` is true only while a
scripted budget is armed.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Iterator, Optional

from ..utils.env import env_float
from ..utils.logging import get_logger
from ..utils.tracing import counters

__all__ = ["InjectedFault", "inject", "check", "arm", "reset", "active",
           "may_fire", "slowdown", "sites"]

_log = get_logger("resilience.faults")

# the site table, programmatically: site -> where it fires (the docstring
# table's machine-readable twin)
_SITES = {
    "compile": "engine.executor.BlockExecutor before the eager call (kept "
               "so the JAX package's fault schedules carry over)",
    "dispatch": "engine.executor.BlockExecutor block dispatch",
    "oom": "engine.executor.BlockExecutor dispatch, OOM-shaped",
    "drain": "engine.executor.PendingBlock.drain pipelined readback",
    "perf": "plan.execute forcings (slowdown: sleeps TFT_FAULT_PERF_S "
            "inside the forcing, never raises)",
    "preempt": "engine.preempt.boundary (converted to a park request, "
               "never raised out of the query)",
    "disk": "memory.persist artifact reads (read failure, or checksum "
            "corruption when armed with a 'corrupt' message)",
}


def sites() -> Dict[str, str]:
    """The instrumented fault-site table: ``{site: where it fires}``, the
    single source of truth for what :func:`arm` can usefully arm."""
    return dict(_SITES)


class InjectedFault(RuntimeError):
    """A scripted failure from :func:`check`.

    ``transient=True`` (default) makes it retryable under
    :func:`~.classify.is_transient`; ``message`` can be shaped to hit
    other classifiers (e.g. ``RESOURCE_EXHAUSTED`` for the OOM split
    path — :func:`inject` does this automatically for the ``oom`` site).
    """

    def __init__(self, site: str, message: Optional[str] = None,
                 transient: bool = True):
        self.site = site
        self.transient = transient
        super().__init__(
            message or f"injected transient fault at site {site!r}")


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.budgets: Dict[str, int] = {}
        self.messages: Dict[str, Optional[str]] = {}
        self.transient: Dict[str, bool] = {}
        self._armed_env = False


_state = _State()

# the "oom" site must be caught by classify.is_oom, not retried
_OOM_MESSAGE = ("RESOURCE_EXHAUSTED: injected fault: out of memory "
                "allocating scratch for block")

# the "disk" site never escapes memory.persist (its reads are best-effort
# try/except); non-transient so nothing would retry it if an
# instrumentation point outside that layer ever picked it up
_DISK_MESSAGE = ("injected disk fault: persist artifact read failed "
                 "(I/O error simulated)")


def _arm_from_env() -> None:
    """Parse ``TFT_FAULTS="site:count,site:count"`` once per process;
    ``TFT_CHAOS`` raises (seeded chaos schedules are not ported)."""
    with _state.lock:
        if _state._armed_env:
            return
        if os.environ.get("TFT_CHAOS"):
            raise NotImplementedError(
                "TFT_CHAOS is set, and seeded chaos schedules "
                "(resilience/chaos.py, ROADMAP.md A11) are not in "
                "tensorframes_tpu_torch yet; unset it, or script faults "
                "with TFT_FAULTS")
        _state._armed_env = True
        raw = os.environ.get("TFT_FAULTS", "")
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        site, _, count = part.partition(":")
        try:
            arm(site.strip(), int(count) if count else 1)
        except ValueError:
            _log.warning("ignoring malformed TFT_FAULTS entry %r", part)


def arm(site: str, fail_n: int = 1, message: Optional[str] = None,
        transient: Optional[bool] = None) -> None:
    """Arm ``site`` to fail its next ``fail_n`` checks.

    ``transient`` defaults to True except for the ``oom`` site, whose
    faults must reach the OOM classifier (the row split), not the retry
    loop, and the ``disk`` site (the persist cold path, never a retry).
    """
    if fail_n < 0:
        raise ValueError(f"fail_n must be >= 0, got {fail_n}")
    if site not in _SITES:
        # loud, not fatal: arming still proceeds (a nothing-checks-it
        # site is harmless) but a typo in TFT_FAULTS must never turn a
        # drill vacuous silently
        counters.inc("faults.unknown_sites")
        _log.warning(
            "arming UNKNOWN fault site %r — no instrumentation point "
            "checks it, so this budget will never fire; known sites: "
            "%s (faults.sites())", site, ", ".join(sorted(_SITES)))
    if site == "oom":
        if message is None:
            message = _OOM_MESSAGE
        if transient is None:
            transient = False
    elif site == "disk":
        if message is None:
            message = _DISK_MESSAGE
        if transient is None:
            transient = False
    elif transient is None:
        transient = True
    with _state.lock:
        _state.budgets[site] = fail_n
        _state.messages[site] = message
        _state.transient[site] = transient
    _log.debug("fault site %r armed for %d failure(s)", site, fail_n)


def reset(site: Optional[str] = None) -> None:
    """Disarm one site, or every site when ``site`` is None."""
    with _state.lock:
        if site is None:
            _state.budgets.clear()
            _state.messages.clear()
            _state.transient.clear()
        else:
            _state.budgets.pop(site, None)
            _state.messages.pop(site, None)
            _state.transient.pop(site, None)


def active(site: str) -> int:
    """Remaining scripted failures for ``site`` (0 when disarmed)."""
    _arm_from_env()
    with _state.lock:
        return _state.budgets.get(site, 0)


def may_fire(site: str) -> bool:
    """True when a :func:`check` of ``site`` could raise right now: a
    scripted budget is armed. For gated instrumentation points
    (``engine.preempt.boundary``) that enter their fault branch only when
    something might fire."""
    return active(site) > 0


def _consume(site: str):
    """Take one unit of ``site``'s budget, returning ``(left, message,
    transient)`` — or ``None`` when the site is disarmed."""
    with _state.lock:
        left = _state.budgets.get(site, 0)
        if left <= 0:
            return None
        _state.budgets[site] = left - 1
        return (left - 1, _state.messages.get(site),
                _state.transient.get(site, True))


def check(site: str) -> None:
    """Raise the site's scripted fault while its budget lasts.

    Instrumentation points call this unconditionally: the disarmed path
    is one env read (memoized) plus a dict lookup under a lock.
    """
    _arm_from_env()
    got = _consume(site)
    if got is None:
        return
    left, message, transient = got
    counters.inc(f"faults.{site}.injected")
    _log.info("injecting fault at site %r (%d more scripted)",
              site, left)
    raise InjectedFault(site, message, transient=transient)


def slowdown(site: str = "perf") -> float:
    """The sleep-shaped sibling of :func:`check`: while the site's
    budget lasts, sleep ``TFT_FAULT_PERF_S`` seconds (default 0.05)
    INSIDE the caller's timed region and return the duration slept —
    never raises, so the query completes normally, just slower
    (``TFT_FAULTS=perf:1``). Returns 0.0 on the disarmed path (one
    memoized env read + a locked dict lookup, same as :func:`check`)."""
    _arm_from_env()
    got = _consume(site)
    if got is None:
        return 0.0
    left = got[0]
    dur = max(env_float("TFT_FAULT_PERF_S", 0.05), 0.0)
    counters.inc(f"faults.{site}.injected")
    _log.info("injecting %.3fs slowdown at site %r (%d more scripted)",
              dur, site, left)
    if dur:
        import time
        time.sleep(dur)
    return dur


@contextlib.contextmanager
def inject(site: str, fail_n: int = 1, message: Optional[str] = None,
           transient: Optional[bool] = None) -> Iterator[None]:
    """Scoped fault injection: the next ``fail_n`` ``check(site)`` calls
    inside the block raise; the site is disarmed on exit either way."""
    arm(site, fail_n, message=message, transient=transient)
    try:
        yield
    finally:
        reset(site)
