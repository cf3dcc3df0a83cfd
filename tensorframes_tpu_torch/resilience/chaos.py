"""Seeded chaos schedules: composed multi-site fault injection.

The port's counterpart of ``tensorframes_tpu/resilience/chaos.py``. Every
recovery path of the port was proven by arming ONE deterministic fault
site (:mod:`.faults`) and asserting one contract. Faults in service
arrive composed: a worker dies while a whale is being preempted and its
survivor restarts warm off a disk tier that may itself be rotten. This
module composes the existing sites into reproducible multi-site
schedules:

    TFT_CHAOS="seed:42,rate:0.05,sites:worker|oom|preempt|disk"

While a schedule is active, every :func:`~.faults.check` (and
:func:`~.faults.slowdown`) whose site is named by the schedule and has
no scripted budget consults it. The decision for the *n*-th consult of
a site is a pure hash of ``(seed, site, n)`` against ``rate``: no RNG
state, no wall clock, and the same function as the JAX package's, so a
spec decides the same way in both packages. The same seed over the same
workload fires the same ``(site, step)`` sequence, per site, however the
other sites interleave. A firing arms a ONE-SHOT budget through
:func:`~.faults.arm` (which shapes the message for the site's
classifier: OOM-shaped for ``oom``, ``WORKER_LOST`` for ``worker``) and
the very next consume raises it: chaos faults are indistinguishable
from scripted ones downstream.

The steps differ between the packages: the port's blocks and dispatches
are not the JAX package's (it has no padding executor), so one seed over
"the same" workload consults each site a different number of times and
fires at different steps. Replay holds within a package.

Every firing is flight-recorded (``chaos.fire`` with seed, site and
step) and kept on the schedule (:meth:`ChaosSchedule.firings`), so a
failure under chaos replays exactly: re-run with the same seed and the
same workload, and the drill fires the same schedule
(:meth:`ChaosSchedule.fingerprint`).

Invariant auditors (:mod:`.invariants`) treat an active schedule as
strict mode: a violation surfaced mid-drill raises a classified
``InvariantViolation`` instead of only counting.

Entry points: :func:`inject` (scoped, tests), :func:`start`/:func:`stop`
(whole-process, ``tensorframes_tpu_torch/tools/chaos_soak.py``), or the
``TFT_CHAOS`` environment knob (armed lazily by the first fault-site
check, like ``TFT_FAULTS``). Site names are validated against the
port's own :func:`~.faults.sites`: a site the port lacks (``device``,
``dmap``, ``cluster_init``, ...) raises instead of arming a vacuous
drill.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from ..utils.logging import get_logger
from ..utils.tracing import counters
from . import faults as _faults

__all__ = ["ChaosSchedule", "parse", "start", "stop", "active", "inject",
           "maybe_start_from_env"]

_log = get_logger("resilience.chaos")

_lock = threading.Lock()
_active: Optional["ChaosSchedule"] = None
_env_armed = False


class ChaosSchedule:
    """One seeded multi-site schedule (see the module docstring).

    ``rate`` is the per-consult firing probability; the decision for a
    site's *n*-th consult is ``hash64(seed, site, n) / 2**64 < rate`` —
    probabilistic in distribution, fully determined by the seed.
    """

    def __init__(self, seed: int, rate: float, sites: List[str]):
        known = _faults.sites()
        unknown = [s for s in sites if s not in known]
        if unknown:
            raise ValueError(
                f"chaos schedule names unknown fault site(s) "
                f"{unknown!r}; known sites: {sorted(known)} "
                f"(faults.sites()) — refusing to arm a vacuous drill")
        if not sites:
            raise ValueError("chaos schedule needs at least one site")
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"chaos rate must be in (0, 1], got {rate}")
        self.seed = int(seed)
        self.rate = float(rate)
        self.sites = tuple(dict.fromkeys(sites))  # de-duped, ordered
        self._lock = threading.Lock()
        self._steps: Dict[str, int] = {}
        self._firings: List[Tuple[str, int]] = []

    def consult(self, site: str) -> bool:
        """The :func:`~.faults.check` hook: count the consult, decide
        seed-deterministically, arm a one-shot budget on a firing."""
        if site not in self.sites:
            return False
        with self._lock:
            step = self._steps.get(site, 0) + 1
            self._steps[site] = step
        h = hashlib.sha256(
            f"{self.seed}:{site}:{step}".encode()).digest()
        if int.from_bytes(h[:8], "big") / 2.0 ** 64 >= self.rate:
            return False
        with self._lock:
            self._firings.append((site, step))
        counters.inc("chaos.fired")
        counters.inc(f"chaos.{site}.fired")
        from ..observability import flight as _flight
        _flight.record("chaos.fire", site=site, step=step,
                       seed=self.seed, rate=self.rate)
        _log.info("chaos: firing site %r at step %d (seed %d)",
                  site, step, self.seed)
        _faults.arm(site, 1)
        return True

    def firings(self) -> List[Tuple[str, int]]:
        """Every ``(site, step)`` this schedule fired, in firing order
        — the replay record (same seed + same workload => same list)."""
        with self._lock:
            return list(self._firings)

    def fingerprint(self) -> Tuple[Tuple[str, int], ...]:
        """The firing sequence as a hashable identity: two runs of the
        same workload under the same seed compare equal."""
        return tuple(self.firings())

    def stats(self) -> dict:
        with self._lock:
            return {"seed": self.seed, "rate": self.rate,
                    "sites": list(self.sites),
                    "consults": dict(self._steps),
                    "fired": len(self._firings)}

    def __repr__(self):
        return (f"ChaosSchedule(seed={self.seed}, rate={self.rate:g}, "
                f"sites={'|'.join(self.sites)}, "
                f"fired={len(self.firings())})")


def parse(spec: str) -> ChaosSchedule:
    """``"seed:42,rate:0.05,sites:device|worker|disk"`` -> schedule.

    Order-free; ``seed`` defaults to 0, ``rate`` to 0.05. ``sites`` is
    required. Malformed entries and unknown sites raise — a chaos spec
    is an operator statement of intent, never best-effort."""
    seed, rate, sites = 0, 0.05, []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, value = part.partition(":")
        key = key.strip()
        if not sep:
            raise ValueError(f"malformed TFT_CHAOS entry {part!r} "
                             f"(expected key:value)")
        if key == "seed":
            seed = int(value)
        elif key == "rate":
            rate = float(value)
        elif key == "sites":
            sites = [s.strip() for s in value.split("|") if s.strip()]
        else:
            raise ValueError(
                f"unknown TFT_CHAOS key {key!r} (seed/rate/sites)")
    return ChaosSchedule(seed, rate, sites)


def active() -> Optional[ChaosSchedule]:
    """The installed schedule, or ``None``. Invariant auditors read
    this to decide strictness."""
    return _active


def start(spec_or_schedule) -> ChaosSchedule:
    """Install a schedule process-wide (replacing any active one) and
    hook it into the fault sites. Returns the installed schedule."""
    sched = (spec_or_schedule
             if isinstance(spec_or_schedule, ChaosSchedule)
             else parse(spec_or_schedule))
    global _active
    with _lock:
        _active = sched
    _faults.set_chaos_hook(_consult)
    _log.info("chaos schedule active: %r", sched)
    return sched


def stop() -> Optional[ChaosSchedule]:
    """Uninstall the active schedule (returning it) and disarm any
    fired-but-unconsumed one-shot budgets on its sites, so a stopped
    drill can never leak a pending fault into later work."""
    global _active
    with _lock:
        sched, _active = _active, None
    _faults.set_chaos_hook(None)
    if sched is not None:
        for site in sched.sites:
            _faults.reset(site)
        _log.info("chaos schedule stopped: %r", sched)
    return sched


def _consult(site: str) -> bool:
    sched = _active
    return sched is not None and sched.consult(site)


def maybe_start_from_env() -> None:
    """Arm ``TFT_CHAOS`` once per process — called lazily by the first
    :func:`~.faults.check`, mirroring ``TFT_FAULTS``. A malformed spec
    raises: silently skipping it would run the exact vacuous drill the
    validation exists to prevent."""
    global _env_armed
    with _lock:
        if _env_armed:
            return
        _env_armed = True
    import os
    spec = os.environ.get("TFT_CHAOS", "").strip()
    if spec:
        start(spec)


@contextlib.contextmanager
def inject(spec_or_schedule) -> Iterator[ChaosSchedule]:
    """Scoped chaos for tests/drills: install on entry, :func:`stop`
    on exit either way."""
    sched = start(spec_or_schedule)
    try:
        yield sched
    finally:
        stop()
