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
cluster_init ``parallel.cluster.initialize`` bootstrap attempt (retried
            until the bootstrap deadline, then degraded or, under
            ``TFT_REQUIRE_CLUSTER=1``, raised as ``ClusterInitError``)
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
batch       ``stream.runtime.StreamHandle`` per-batch processing: a
            transient fault retries the batch, a permanent one skips and
            counts it
worker      ``engine.preempt.boundary`` (a running query) and the
            ``serve.fabric`` heartbeat (an idle worker): like ``preempt``
            NOT raised out of the query; the scope parks the query (its
            checkpoint persisted) and flags the worker as crashed, so
            ``TFT_FAULTS=worker:1`` kills one serving worker mid-query and
            the fabric declares it ``worker_lost`` and resumes elsewhere
dmap        ``parallel.distributed.dmap_blocks`` mesh dispatch and the
            fused stage of ``plan.dist`` (a transient fault retries the
            dispatch, a permanent one replays a fused chain per op)
device      ``parallel.elastic.elastic_call`` dispatch, device-loss
            shaped (``DEVICE_LOST: injected fault: device %d is lost``,
            ``TFT_FAULT_DEVICE`` picks the index, default 0): the elastic
            layer shrinks the mesh, re-shards and re-runs the op
========== ===========================================================

``pad_compile`` has no counterpart: the port has no padding buckets, so
there is no bucketed compile to fail. The JAX package's ``pjrt_execute``
comes with the native execution core (``ROADMAP.md`` A item 8); arming
it now warns, as any unknown site does.
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
           "may_fire", "slowdown", "sites", "set_chaos_hook"]

_log = get_logger("resilience.faults")

# the site table, programmatically: site -> where it fires (the docstring
# table's machine-readable twin)
_SITES = {
    "cluster_init": "parallel.cluster.initialize bootstrap attempt",
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
    "dmap": "parallel.distributed.dmap_blocks mesh dispatch (and the "
            "fused stage of plan.dist)",
    "batch": "stream.runtime.StreamHandle per-batch processing",
    "device": "parallel.elastic.elastic_call dispatch (device-loss "
              "shaped: the elastic layer shrinks the mesh)",
    "worker": "engine.preempt.boundary / serve.fabric heartbeat "
              "(worker-loss shaped: park + fabric re-placement)",
}


def sites() -> Dict[str, str]:
    """The instrumented fault-site table: ``{site: where it fires}``, the
    single source of truth for what :func:`arm` can usefully arm: chaos
    schedules (``resilience/chaos.py``) reject sites outside it."""
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

# the "device" site must be caught by classify.is_device_lost (mesh
# shrink), not the retry loop; the device index in the message is what
# parallel.elastic parses to pick the shard to drop
_DEVICE_MESSAGE = ("DEVICE_LOST: injected fault: device %d is lost "
                   "(chip failure simulated)")

# the "worker" site must be caught by classify.is_worker_lost (fabric
# re-placement and checkpoint resume), never the retry loop
_WORKER_MESSAGE = ("WORKER_LOST: injected fault: worker process died "
                   "(crash simulated)")

# the "disk" site never escapes memory.persist (its reads are best-effort
# try/except); non-transient so nothing would retry it if an
# instrumentation point outside that layer ever picked it up
_DISK_MESSAGE = ("injected disk fault: persist artifact read failed "
                 "(I/O error simulated)")

# set by resilience.chaos while a schedule is active: called with the
# site on every budget-exhausted check; returns True after arming a
# one-shot seed-deterministic budget for it (None costs one load)
_chaos_hook = None


def set_chaos_hook(hook) -> None:
    """Install (or clear with ``None``) the chaos scheduler's consult
    hook: owned by ``resilience.chaos``, not a public tuning point."""
    global _chaos_hook
    _chaos_hook = hook


def _arm_from_env() -> None:
    """Parse ``TFT_FAULTS="site:count,site:count"`` once per process, and
    arm ``TFT_CHAOS`` the same lazy way."""
    with _state.lock:
        if _state._armed_env:
            return
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
    # the chaos twin: memoized inside, a no-op without the knob; a
    # malformed spec raises there
    from . import chaos as _chaos
    _chaos.maybe_start_from_env()


def arm(site: str, fail_n: int = 1, message: Optional[str] = None,
        transient: Optional[bool] = None) -> None:
    """Arm ``site`` to fail its next ``fail_n`` checks.

    ``transient`` defaults to True except for the ``oom`` site, whose
    faults must reach the OOM classifier (the row split), not the retry
    loop, the ``device`` site, whose faults must reach the device-loss
    classifier (mesh shrink and re-shard; ``TFT_FAULT_DEVICE`` selects
    the reported device index, default 0), the ``worker`` site (fabric
    re-placement) and the ``disk`` site (the persist cold path), never a
    retry.
    """
    if fail_n < 0:
        raise ValueError(f"fail_n must be >= 0, got {fail_n}")
    if site not in _SITES:
        # loud, not fatal: arming still proceeds (a nothing-checks-it
        # site is harmless) but a typo in TFT_FAULTS / TFT_CHAOS must
        # never turn a drill vacuous silently
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
    elif site == "device":
        if message is None:
            from ..utils.env import env_int
            message = _DEVICE_MESSAGE % env_int("TFT_FAULT_DEVICE", 0)
        if transient is None:
            transient = False
    elif site == "worker":
        if message is None:
            message = _WORKER_MESSAGE
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
    scripted budget is armed, or an active chaos schedule names the site.
    For gated instrumentation points (``engine.preempt.boundary``) that
    enter their fault branch only when something might fire: gating on
    :func:`active` alone would hide those sites from chaos schedules."""
    if active(site) > 0:
        return True
    if _chaos_hook is None:
        return False
    from . import chaos as _chaos
    sched = _chaos.active()
    return sched is not None and site in sched.sites


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
    is one env read (memoized) plus a dict lookup under a lock (and one
    global load for the chaos hook). With a chaos schedule active and no
    scripted budget, the schedule decides seed-deterministically whether
    this check fires: a firing arms a one-shot budget through :func:`arm`
    (site-correct message shaping included) and consumes it here, so a
    chaos fault is indistinguishable from a scripted one.
    """
    _arm_from_env()
    got = _consume(site)
    if got is None:
        hook = _chaos_hook
        if hook is None or not hook(site):
            return
        got = _consume(site)  # the firing armed a one-shot budget
        if got is None:
            return  # lost a race with reset(); the firing was recorded
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
    memoized env read + a locked dict lookup, same as :func:`check`). A
    chaos schedule naming this site can fire it too, as in
    :func:`check`."""
    _arm_from_env()
    got = _consume(site)
    if got is None:
        hook = _chaos_hook
        if hook is None or not hook(site):
            return 0.0
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
