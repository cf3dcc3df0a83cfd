"""Retry policy and deadlines: the control knobs of the resilience layer.

The port's counterpart of ``tensorframes_tpu/resilience/policy.py``.
:class:`RetryPolicy` is the one retry loop in the package: the executor's
dispatch calls :meth:`RetryPolicy.call` rather than hand-rolling a loop,
so backoff, deadline accounting, counters and log lines behave the same at
every layer.

Deadlines compose through a thread-local stack: ``with deadline(30):``
bounds everything inside it, nested deadlines only shrink the budget, and
:meth:`RetryPolicy.call` consults the ambient deadline before every
attempt and every backoff sleep, so a retry loop never outlives its
caller's time budget.

Observability contract:

- every attempt runs inside a ``resilience.<op>.attempt`` span;
- every retry increments ``retry.<op>.retries`` and logs a WARNING, and
  with a query trace open records a ``retry`` event with the classified
  error;
- every giveup increments ``retry.<op>.giveups``, logs an ERROR, records
  a ``resilience.giveup`` flight record (and a ``giveup`` event under a
  trace) and triggers a flight dump when ``TFT_FLIGHT_DUMP`` is set,
  before the last exception propagates;
- an expired deadline increments ``deadline.<op>.expired``.

Backoff jitter is deterministic (keyed on op name and attempt number): two
processes retrying the same op spread out, while a test replaying a
scenario sees identical timing every run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable, Optional, TypeVar

from ..observability import flight as _flight
from ..observability.events import add_event as _obs_event
from ..observability.events import current_trace as _current_trace
from ..utils.env import env_bool, env_float, env_int
from ..utils.logging import get_logger
from ..utils.tracing import counters, span

__all__ = ["RetryPolicy", "DeadlineExceeded",
           "ClusterInitError", "DEFAULT_POLICY", "default_policy",
           "deadline", "remaining_time", "check_deadline",
           "env_float", "env_int", "env_bool"]

_log = get_logger("resilience.policy")

T = TypeVar("T")


class DeadlineExceeded(TimeoutError):
    """An operation (or its retry loop) ran out of its time budget."""


class ClusterInitError(RuntimeError):
    """Cluster bootstrap failed and ``TFT_REQUIRE_CLUSTER`` forbids the
    single-process degradation (kept for the cluster bootstrap, which is
    not ported yet)."""


# -- deadlines ---------------------------------------------------------------

_local = threading.local()


def _stack():
    s = getattr(_local, "deadlines", None)
    if s is None:
        s = _local.deadlines = []
    return s


class deadline:
    """Bound the wall-clock time of a block (thread-local, nestable).

    ``with deadline(30): ...`` — code inside that calls
    :func:`check_deadline` (the retry loop does, between attempts and
    sleeps) raises :class:`DeadlineExceeded` once 30s have elapsed.
    Nested deadlines only ever shrink the budget. ``None`` seconds means
    no new bound (useful for optional knobs).
    """

    def __init__(self, seconds: Optional[float]):
        if seconds is not None and seconds <= 0:
            raise ValueError(f"deadline must be positive, got {seconds}")
        self.seconds = seconds
        self._pushed = False

    def __enter__(self) -> "deadline":
        if self.seconds is not None:
            expires = time.monotonic() + self.seconds
            s = _stack()
            if s:
                expires = min(expires, s[-1])
            s.append(expires)
            self._pushed = True
        return self

    def __exit__(self, *exc):
        if self._pushed:
            _stack().pop()
        return False


def remaining_time() -> Optional[float]:
    """Seconds left on the tightest ambient deadline, or None."""
    s = _stack()
    if not s:
        return None
    return s[-1] - time.monotonic()


def check_deadline(op: str = "operation") -> None:
    """Raise :class:`DeadlineExceeded` when the ambient deadline is up."""
    left = remaining_time()
    if left is not None and left <= 0:
        counters.inc(f"deadline.{op}.expired")
        raise DeadlineExceeded(
            f"{op}: deadline expired ({-left:.3f}s past)")


# -- retry policy ------------------------------------------------------------

def _error_kind(exc: BaseException) -> str:
    """The classifier's verdict as an event label (oom / transient /
    permanent, plus the serving layer's rejected / over_quota /
    deadline_admission) — what the retry decision was actually based
    on."""
    from .classify import error_kind
    return error_kind(exc)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff, jitter, and a deadline.

    ``max_attempts`` counts every try including the first; ``deadline``
    (seconds) bounds the whole :meth:`call` including sleeps — ``None``
    defers to whatever ambient :func:`deadline` is in effect.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.25
    deadline: Optional[float] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if not 0 <= self.jitter < 1:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    def backoff(self, attempt: int, op: str = "") -> float:
        """Sleep before attempt ``attempt + 1`` (0-based failed attempt).

        Exponential with a cap, jittered deterministically from
        ``(op, attempt)`` so concurrent processes spread out but test
        replays are exact.
        """
        raw = min(self.base_delay * (self.multiplier ** attempt),
                  self.max_delay)
        if not self.jitter:
            return raw
        digest = hashlib.sha256(f"{op}:{attempt}".encode()).digest()
        frac = digest[0] / 255.0  # [0, 1], stable across runs
        return raw * (1.0 - self.jitter + 2.0 * self.jitter * frac)

    def call(self, fn: Callable[[], T], *, op: str,
             classify: Optional[Callable[[BaseException], bool]] = None,
             sleep: Callable[[float], None] = time.sleep) -> T:
        """Run ``fn`` under this policy.

        ``classify(exc) -> bool`` marks an exception retryable (default:
        :func:`~.classify.is_transient`). Non-retryable exceptions
        propagate immediately; retryable ones retry up to
        ``max_attempts`` within the deadline, then propagate (the last
        one) after a ``retry.<op>.giveups`` count + ERROR log.
        """
        if classify is None:
            from .classify import is_transient as classify
        with deadline(self.deadline):
            last: Optional[BaseException] = None
            for attempt in range(self.max_attempts):
                check_deadline(op)
                try:
                    with span(f"resilience.{op}.attempt"):
                        return fn()
                except BaseException as e:  # noqa: BLE001 - reclassified
                    if not classify(e):
                        raise
                    last = e
                if attempt + 1 >= self.max_attempts:
                    break
                delay = self.backoff(attempt, op)
                left = remaining_time()
                if left is not None and delay >= left:
                    # sleeping would blow the deadline: give up now with
                    # the deadline error, carrying the real failure
                    counters.inc(f"retry.{op}.giveups")
                    if _current_trace() is not None:
                        # kind classification only when a trace listens:
                        # the giveup/retry paths must stay zero-cost
                        # with tracing off (re-classifying str(exc) per
                        # attempt is not free)
                        _obs_event("giveup", name=op,
                                   attempts=attempt + 1,
                                   error=type(last).__name__,
                                   kind=_error_kind(last), deadline=True)
                    # giveups are rare enough to classify always-on for
                    # the flight ring, and a classified giveup is one
                    # of the recorder's auto-dump triggers
                    _flight.record("resilience.giveup", op=op,
                                   attempts=attempt + 1,
                                   error=type(last).__name__,
                                   error_kind=_error_kind(last),
                                   deadline=True)
                    _flight.maybe_dump("giveup")
                    _log.error(
                        "%s: transient failure and only %.3fs left on "
                        "the deadline (backoff %.3fs); giving up", op,
                        max(left, 0.0), delay)
                    raise DeadlineExceeded(
                        f"{op}: deadline reached after {attempt + 1} "
                        f"attempt(s)") from last
                counters.inc(f"retry.{op}.retries")
                if _current_trace() is not None:
                    _obs_event("retry", name=op, attempt=attempt + 1,
                               backoff_s=delay,
                               error=type(last).__name__,
                               kind=_error_kind(last))
                _log.warning(
                    "%s: transient failure (attempt %d/%d), retrying in "
                    "%.3fs: %s", op, attempt + 1, self.max_attempts,
                    delay, last)
                sleep(delay)
            counters.inc(f"retry.{op}.giveups")
            if _current_trace() is not None:
                _obs_event("giveup", name=op, attempts=self.max_attempts,
                           error=type(last).__name__,
                           kind=_error_kind(last))
            _flight.record("resilience.giveup", op=op,
                           attempts=self.max_attempts,
                           error=type(last).__name__,
                           error_kind=_error_kind(last))
            _flight.maybe_dump("giveup")
            _log.error("%s: giving up after %d attempt(s): %s",
                       op, self.max_attempts, last)
            assert last is not None
            raise last


DEFAULT_POLICY = RetryPolicy()


def default_policy(prefix: str = "TFT_RETRY",
                   **overrides) -> RetryPolicy:
    """The process-default policy, shaped by environment knobs.

    ``TFT_RETRY_MAX_ATTEMPTS`` / ``TFT_RETRY_BASE_DELAY`` /
    ``TFT_RETRY_MAX_DELAY`` / ``TFT_RETRY_DEADLINE`` override the
    dataclass defaults; keyword ``overrides`` win over both (callers pin
    what their layer must control, e.g. the cluster bootstrap deadline).
    Re-read per call: the knobs are cheap and tests flip them.
    """
    params = dict(
        max_attempts=env_int(f"{prefix}_MAX_ATTEMPTS",
                             DEFAULT_POLICY.max_attempts),
        base_delay=env_float(f"{prefix}_BASE_DELAY",
                             DEFAULT_POLICY.base_delay),
        max_delay=env_float(f"{prefix}_MAX_DELAY",
                            DEFAULT_POLICY.max_delay),
        deadline=env_float(f"{prefix}_DEADLINE", DEFAULT_POLICY.deadline),
    )
    params.update(overrides)
    return RetryPolicy(**params)
