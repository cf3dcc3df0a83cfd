"""Multi-tenant query scheduling: admission, fairness, quotas, deadlines,
preemption.

The port's counterpart of ``tensorframes_tpu/serve/scheduler.py``, for one
process. :class:`QueryScheduler` is the serving front end over the
layers below it: query traces and the flight recorder (observability),
classified errors and deadlines (resilience), the card's memory
watermark (``observability.device``), the pipeline's slot pool, and
preemption with checkpoints (``engine.preempt``, ``memory.checkpoint``).

- **Submission** (:meth:`QueryScheduler.submit`): a lazy frame (and
  optional fetches), a tenant and an optional deadline land on the
  tenant's bounded FIFO queue. A full queue rejects at once with a
  classified :class:`~..resilience.QueueFull`, an exhausted rows/sec
  token bucket with :class:`~..resilience.OverQuota`, and a quarantined
  plan with :class:`~..resilience.QueryQuarantined`.
- **Weighted-fair selection** (stride scheduling): each tenant carries a
  virtual pass advanced by ``1/weight`` per served query; a worker serves
  the eligible tenant with the smallest pass (eligible: a non-empty queue
  and in-flight below ``max_inflight``).
- **Admission**: before a query runs, its estimated footprint is held
  against the card's high-water mark (``TFT_SERVE_HBM_FRACTION`` of
  ``TFT_SERVE_HBM_LIMIT_BYTES``, else of the card's memory; live bytes
  are the caching allocator's bytes in use). A query that would cross it
  WAITS, bounded by ``TFT_SERVE_ADMISSION_WAIT_S`` and its deadline;
  during the wait the largest running query that could cover the
  shortfall is asked to PARK (``serve.admission_preempts``), and only an
  arrival that still does not fit is **shed** with a classified
  :class:`~..resilience.AdmissionDeadline`. Without a card, the memory
  ledger stands in when it has a budget; otherwise admission is free.
- **Execution**: a worker forces the frame inside a
  :func:`~..observability.query_trace` labelled with the tenant, a
  resilience :func:`~..resilience.deadline`, a flight scope and a cost
  capture (``observability.baseline``). The scheduler installs its own
  :class:`~..engine.pipeline.SlotPool` (workers x pipeline depth, or
  ``TFT_SERVE_SLOTS``), which bounds in-flight blocks across queries, and
  a :class:`~.cache.SharedCompileCache` as the executor's interner, so
  equal programs from different tenants share one ``Computation``.
- **Preemption and cancellation**: :meth:`QueryScheduler.cancel` stops a
  queued query at once and a running one at its next block boundary
  (classified :class:`~..resilience.QueryCancelled`). When a
  higher-weight tenant submits while every worker is busy, the
  lowest-weight running query that has run for at least
  ``TFT_PREEMPT_AFTER_MS`` parks at its next block boundary: its finished
  blocks move to a checkpoint off the card and it goes back to the FRONT
  of its tenant's queue; its resume dispatches only the remaining blocks,
  bit-equal to an uninterrupted run.
- **Finish**: the latency histogram, the sentinel's baseline and
  regression check, the durable history, the SLO burn callbacks, the
  quarantine streaks, and an invariant audit (the ``scheduler`` auditor
  of ``resilience.invariants``).

All worker threads share the process's default device and the current
CUDA stream. ``workers=0`` builds a scheduler driven by hand:
:meth:`QueryScheduler.step` runs exactly one scheduling decision on the
calling thread (tests use it for a deterministic order).

Knobs: ``TFT_SERVE_WORKERS`` (2), ``TFT_SERVE_QUEUE_DEPTH`` (64 per
tenant), ``TFT_SERVE_INFLIGHT`` (2 per tenant), ``TFT_SERVE_SLOTS``,
``TFT_SERVE_HBM_FRACTION`` (0.9), ``TFT_SERVE_HBM_LIMIT_BYTES``,
``TFT_SERVE_ADMISSION_WAIT_S`` (5), ``TFT_SERVE_ADMISSION_POLL_S``
(0.02), ``TFT_SERVE_SHARED_CACHE`` (1), ``TFT_SERVE_DEADLINE_S``,
``TFT_SERVE_PREEMPT`` (1), ``TFT_PREEMPT_AFTER_MS`` (100).

The serving fabric (``serve/fabric.py``) drives every scheduler of its
workers through hooks: ``worker_id`` is stamped on the flight scopes and
history records, ``on_worker_fault`` fires (on the victim's own worker
thread, before the scheduler's lock is taken) when a running query's park
was caused by the ``worker`` fault site, :meth:`QueryScheduler.mark_lost`
stops a dying worker's intake, :meth:`QueryScheduler.request_park_all`
parks every running query, and ``submit(..., query_id=, _checkpoint=)``
re-dispatches a migrated query under its original id with its persisted
checkpoint. A query orphaned at :meth:`QueryScheduler.close` keeps its
persisted checkpoint file, so that the fabric can resume it elsewhere.
A query whose forcing raises a ``device_lost`` error (the mesh shrank
under it, ``parallel/elastic.py``) is retried once on the surviving
devices: ``serve.device_lost_retries``, a ``device_lost_retry`` event.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from ..engine import executor as _executor
from ..engine import pipeline as _pipeline
from ..engine import preempt as _preempt
from ..observability import baseline as _baseline
from ..observability import device as _obs_device
from ..observability import events as _obs
from ..observability import flight as _flight
from ..observability import history as _history
from ..observability import slo as _slo
from ..resilience import (AdmissionDeadline, DeadlineExceeded, OverQuota,
                          QueryCancelled, QueryPreempted, QueueFull,
                          ServeRejected, deadline as _deadline,
                          env_bool, env_float, env_int, error_kind)
from ..resilience import invariants as _invariants
from ..resilience.classify import InvariantViolation
from ..utils.logging import get_logger
from ..utils.tracing import counters, gauge, histograms
from .cache import SharedCompileCache
from . import quarantine as _quarantine

__all__ = ["TenantQuota", "SubmittedQuery", "QueryScheduler",
           "default_scheduler", "set_default_scheduler",
           "shutdown_default_scheduler"]

_log = get_logger("serve.scheduler")

_OUTCOMES = ("submitted", "admitted", "rejected", "over_quota", "shed",
             "quarantined", "completed", "failed", "preempted",
             "cancelled")


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant limits; ``None`` fields defer to the ``TFT_SERVE_*``
    process defaults at registration time.

    ``weight`` shapes the fair share (a weight-2 tenant completes ~2x
    the queries of a weight-1 tenant under contention); ``max_queue``
    bounds queued submissions (reject beyond); ``max_inflight`` bounds
    concurrently running queries; ``rows_per_sec`` is a token bucket
    over *estimated* rows (burst = one second of budget; a query whose
    estimate exceeds the burst can never pass and is always rejected
    over-quota); ``deadline_s`` is the default per-query deadline.
    """

    weight: float = 1.0
    max_queue: Optional[int] = None
    max_inflight: Optional[int] = None
    rows_per_sec: Optional[float] = None
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_inflight is not None and self.max_inflight < 1:
            # 0 would accept submissions that no worker may ever pick:
            # an unclassified forever-hang, the exact thing this layer
            # exists to prevent (pause a tenant by closing its client
            # path or rejecting at submit, not by wedging its queue)
            raise ValueError(
                f"max_inflight must be >= 1, got {self.max_inflight}")
        if self.rows_per_sec is not None and self.rows_per_sec <= 0:
            raise ValueError(
                f"rows_per_sec must be > 0 (omit it for unlimited), "
                f"got {self.rows_per_sec}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0, got {self.deadline_s}")


class _TokenBucket:
    """Rows/sec budget: refills continuously, burst = 1s of rate."""

    __slots__ = ("rate", "burst", "tokens", "_t")

    def __init__(self, rate: float):
        self.rate = float(rate)
        self.burst = float(rate)
        self.tokens = self.burst
        self._t = time.monotonic()

    def try_take(self, n: float) -> bool:
        now = time.monotonic()
        self.tokens = min(self.burst, self.tokens +
                          (now - self._t) * self.rate)
        self._t = now
        if n <= self.tokens:
            self.tokens -= n
            return True
        return False


class SubmittedQuery:
    """A query accepted onto a tenant queue: a future over its forcing.

    ``result(timeout)`` blocks until the scheduler completes the query,
    returning the forced frame — or raising the classified error
    (``DeadlineExceeded``, ``AdmissionDeadline``, ``QueryCancelled``,
    or whatever the execution raised). ``state`` is one of ``queued`` /
    ``running`` / ``done`` / ``failed`` / ``shed`` (admission) /
    ``rejected`` (never ran: scheduler shut down) / ``cancelled``.
    A preempted query goes back to ``queued`` with its checkpoint
    (``preemptions`` counts how often) — preemption is not a terminal
    state; the future resolves when the resumed run finishes.
    """

    __slots__ = ("query_id", "tenant", "est_rows", "est_bytes",
                 "est_stream_bytes", "deadline_at", "submitted_at",
                 "started_at", "finished_at", "state", "preemptions",
                 "fingerprint", "_identity",
                 "_thunk", "_event", "_result", "_error", "_scope",
                 "_checkpoint", "_cancel_requested")

    def __init__(self, query_id: str, tenant: str, thunk: Callable[[], Any],
                 est_rows: Optional[float], est_bytes: Optional[int],
                 deadline_at: Optional[float],
                 est_stream_bytes: Optional[int] = None):
        self.query_id = query_id
        self.tenant = tenant
        self.est_rows = est_rows
        self.est_bytes = est_bytes
        # the streaming working set (~one block of the frame): what the
        # spill-capable ledger actually has to hold at once
        self.est_stream_bytes = est_stream_bytes
        self.deadline_at = deadline_at  # monotonic, or None
        self.submitted_at = time.monotonic()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.state = "queued"
        self.preemptions = 0
        # plan-fingerprint of the FULL query (frame + fetches), set at
        # submit: the poison-query quarantine's streak key
        self.fingerprint: Optional[str] = None
        # a served aggregate's (fingerprint, portable), taken at submit:
        # its result frame has no chain for the sentinel to key by
        self._identity: Optional[Tuple[str, bool]] = None
        self._thunk = thunk
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        # preemption plumbing: the live scope while running, the parked
        # checkpoint between a preempt and its resume, and the
        # cancel-before-start flag
        self._scope = None
        self._checkpoint = None
        self._cancel_requested = False

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"query {self.query_id} not finished within {timeout}s "
                f"(state={self.state})")
        if self._error is not None:
            raise self._error
        return self._result

    def _complete(self, result: Any = None,
                  error: Optional[BaseException] = None) -> None:
        if self._event.is_set():
            return  # exactly one terminal state, even under races
        cp, self._checkpoint = self._checkpoint, None
        if cp is not None:
            cp.free()  # no terminal state keeps parked buffers alive
        self._scope = None
        self.finished_at = time.monotonic()
        self._result = result
        self._error = error
        if error is None:
            self.state = "done"
        elif isinstance(error, QueryCancelled):
            self.state = "cancelled"
        elif isinstance(error, AdmissionDeadline):
            self.state = "shed"
        elif isinstance(error, ServeRejected):
            self.state = "rejected"
        else:
            self.state = "failed"
        self._event.set()

    def __repr__(self):
        return (f"SubmittedQuery({self.query_id}, tenant={self.tenant!r}, "
                f"state={self.state})")


class _Tenant:
    __slots__ = ("name", "weight", "max_queue", "max_inflight", "bucket",
                 "deadline_s", "queue", "inflight", "vpass", "counts")

    def __init__(self, name: str, quota: TenantQuota):
        self.name = name
        self.weight = quota.weight
        self.max_queue = (quota.max_queue if quota.max_queue is not None
                          else env_int("TFT_SERVE_QUEUE_DEPTH", 64))
        self.max_inflight = (quota.max_inflight
                             if quota.max_inflight is not None
                             else env_int("TFT_SERVE_INFLIGHT", 2))
        self.bucket = (_TokenBucket(quota.rows_per_sec)
                       if quota.rows_per_sec is not None else None)
        self.deadline_s = (quota.deadline_s if quota.deadline_s is not None
                           else env_float("TFT_SERVE_DEADLINE_S", None))
        self.queue: "deque[SubmittedQuery]" = deque()
        self.inflight = 0
        self.vpass = 0.0
        self.counts: Dict[str, int] = {k: 0 for k in _OUTCOMES}


def _estimate(frame) -> Tuple[Optional[float], Optional[int]]:
    """Best-effort (rows, bytes) of a frame through the memory
    manager's estimator: exact when already forced (cached blocks), the
    plan-derived hint for an unforced frame (source constructors record
    their bytes and ops scale them), and ``(None, None)`` only when
    neither exists. Admission and quotas enforce what they can
    measure."""
    from .. import memory as _memory
    return _memory.frame_estimate(frame)


# live schedulers, newest last (serve_report() and the metrics provider
# read the most recent; entries remove themselves on close)
_live_lock = threading.Lock()
_live: List["QueryScheduler"] = []


def live_schedulers() -> List["QueryScheduler"]:
    """Every not-yet-closed scheduler, oldest first (the invariant
    auditors walk all of them — overlapping schedulers each keep their
    own books)."""
    with _live_lock:
        return list(_live)


def live_scheduler() -> Optional["QueryScheduler"]:
    with _live_lock:
        return _live[-1] if _live else None


class QueryScheduler:
    """See the module docstring. Use as a context manager or call
    :meth:`close` — the scheduler installs process-wide hooks (slot
    pool, computation interner, metrics provider) that must be
    uninstalled."""

    def __init__(self, quotas: Optional[Mapping[str, TenantQuota]] = None,
                 workers: Optional[int] = None,
                 slots: Optional[int] = None,
                 admission: bool = True,
                 shared_cache: Optional[bool] = None,
                 preemption: Optional[bool] = None,
                 name: str = "serve"):
        self.name = name
        self._cond = threading.Condition()
        self._tenants: Dict[str, _Tenant] = {}
        # every live (queued or running) query by id: cancel() and the
        # priority preemptor need to find them; entries leave on any
        # terminal state
        self._queries: Dict[str, SubmittedQuery] = {}
        self._vtime = 0.0
        self._qid = itertools.count(1)
        self._open = True
        # a lost worker's scheduler: stops picking work and orphans
        # parked queries, but close() (full teardown, thread joins)
        # still runs later from another thread; see mark_lost()
        self._dying = False
        self._admission = admission
        self._preemption = (preemption if preemption is not None
                            else env_bool("TFT_SERVE_PREEMPT", True))
        self.workers = (workers if workers is not None
                        else env_int("TFT_SERVE_WORKERS", 2))
        if self.workers < 0:
            raise ValueError(f"workers must be >= 0, got {self.workers}")
        n_slots = (slots if slots is not None
                   else env_int("TFT_SERVE_SLOTS",
                                max(1, self.workers)
                                * _pipeline.pipeline_depth()))
        self.slot_pool = _pipeline.SlotPool(max(1, n_slots))
        if isinstance(shared_cache, SharedCompileCache):
            # an explicit cache instance, shared with whoever passed it
            self.compile_cache = shared_cache
        else:
            use_cache = (shared_cache if shared_cache is not None
                         else env_bool("TFT_SERVE_SHARED_CACHE", True))
            self.compile_cache = SharedCompileCache() if use_cache else None
        # set by the serving fabric: worker_id tags this scheduler's
        # flight records; on_worker_fault(self) fires when a running
        # query's park was caused by the `worker` fault site
        self.worker_id: Optional[str] = None
        self.on_worker_fault = None
        for tname, quota in (quotas or {}).items():
            self._tenants[tname] = _Tenant(tname, quota)
        self._threads: List[threading.Thread] = []
        self._install()
        for i in range(self.workers):
            t = threading.Thread(target=self._worker,
                                 name=f"tft-{name}-worker-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        _log.info("QueryScheduler %r: %d worker(s), %d pipeline slot(s), "
                  "shared compile cache %s", name, self.workers,
                  self.slot_pool.slots,
                  "on" if self.compile_cache else "off")

    # -- lifecycle ---------------------------------------------------------
    def _install(self) -> None:
        self._prev_pool = _pipeline.install_slot_pool(self.slot_pool)
        # pin the exact bound method installed: close() restores the
        # previous hook only if it still owns the slot (overlapping
        # schedulers closed out of LIFO order must not resurrect a dead
        # scheduler's pool/interner over a live one's)
        self._interner_fn = None
        self._prev_interner = None
        if self.compile_cache is not None:
            self._interner_fn = self.compile_cache.intern
            self._prev_interner = _executor.set_computation_interner(
                self._interner_fn)
        from . import stats as _stats
        _stats.register_scheduler_metrics(self)
        with _live_lock:
            _live.append(self)

    def __enter__(self) -> "QueryScheduler":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def mark_lost(self) -> None:
        """Flag this scheduler as dying WITHOUT joining its threads.

        The serving fabric's worker-fault hook runs on the victim's own
        worker thread, where a full :meth:`close` would join itself.
        This flips the kill switch synchronously instead: workers stop
        picking queries, new submits are refused, and a parked query's
        requeue takes the orphan path (a classified rejection the fabric
        reads as *migrating*, not failed). A later :meth:`close` from
        another thread still runs the full teardown."""
        with self._cond:
            self._dying = True
            self._cond.notify_all()

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting, fail still-queued queries with a classified
        rejection, wait for running queries, uninstall the hooks.
        Idempotent."""
        with self._cond:
            if not self._open:
                return
            self._open = False
            orphans: List[SubmittedQuery] = []
            for t in self._tenants.values():
                while t.queue:
                    q = t.queue.popleft()
                    self._queries.pop(q.query_id, None)
                    t.counts["rejected"] += 1
                    counters.inc("serve.rejected")
                    orphans.append(q)
            self._cond.notify_all()
        for q in orphans:
            q._complete(error=ServeRejected(
                f"scheduler {self.name!r} shut down before query "
                f"{q.query_id} ran"))
        for t in self._threads:
            t.join(timeout=timeout)
        # quiesce-point audit while the hooks are still installed: every
        # query accounted for, every slot lease returned. Guarded to
        # our own pool — an out-of-order close under a NEWER scheduler
        # must not read that scheduler's live leases as our leak.
        if _invariants.enabled() and \
                _pipeline.current_slot_pool() is self.slot_pool:
            _invariants.audit("scheduler.close")
        # hook teardown, out-of-order safe: restore the previous hook
        # only while still the installed owner; otherwise unlink this
        # scheduler from the restore chain (any live scheduler whose
        # "previous" is ours must now skip to OUR previous), so a dead
        # scheduler's pool/interner can never be resurrected later
        with _live_lock:
            others = [s for s in _live if s is not self]
        for s in others:
            if s._prev_pool is self.slot_pool:
                s._prev_pool = self._prev_pool
            if self._interner_fn is not None and \
                    s._prev_interner is self._interner_fn:
                s._prev_interner = self._prev_interner
        if _pipeline.current_slot_pool() is self.slot_pool:
            _pipeline.install_slot_pool(self._prev_pool)
        else:
            _log.warning(
                "scheduler %r closed out of order: a newer scheduler "
                "owns the engine hooks; unlinked this one from its "
                "restore chain", self.name)
        if self._interner_fn is not None and \
                _executor.current_computation_interner() \
                is self._interner_fn:
            _executor.set_computation_interner(self._prev_interner)
        from . import stats as _stats
        _stats.unregister_scheduler_metrics(self)
        with _live_lock:
            if self in _live:
                _live.remove(self)
        _log.info("QueryScheduler %r closed", self.name)

    # -- tenants -----------------------------------------------------------
    def register_tenant(self, name: str,
                        quota: Optional[TenantQuota] = None) -> None:
        """Register (or re-quota) a tenant explicitly; submitting to an
        unknown tenant auto-registers it with default quotas.
        Re-quotaing an ACTIVE tenant keeps its queue, in-flight
        accounting, fairness pass, and stats — only the limits change."""
        with self._cond:
            fresh = _Tenant(name, quota or TenantQuota())
            t = self._tenants.get(name)
            if t is None:
                self._tenants[name] = fresh
            else:
                t.weight = fresh.weight
                t.max_queue = fresh.max_queue
                t.max_inflight = fresh.max_inflight
                t.deadline_s = fresh.deadline_s
                # an idempotent re-quota must not refill the rows/sec
                # budget: keep the live bucket at an unchanged rate,
                # and carry spent tokens into a changed one
                if fresh.bucket is None:
                    t.bucket = None
                elif t.bucket is None or \
                        t.bucket.rate != fresh.bucket.rate:
                    if t.bucket is not None:
                        t.bucket.try_take(0.0)  # apply the lazy refill
                        fresh.bucket.tokens = min(t.bucket.tokens,
                                                  fresh.bucket.burst)
                    t.bucket = fresh.bucket
            self._cond.notify_all()  # eligibility may have widened

    def _tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            t = self._tenants[name] = _Tenant(name, TenantQuota())
        return t

    def tenants(self) -> List[str]:
        with self._cond:
            return sorted(self._tenants)

    # -- submission --------------------------------------------------------
    def submit(self, frame, fetches=None, *, tenant: str = "default",
               deadline: Optional[float] = None,
               est_rows: Optional[float] = None,
               est_bytes: Optional[int] = None,
               query_id: Optional[str] = None,
               _checkpoint=None) -> SubmittedQuery:
        """Queue one query: force ``frame`` (after applying ``fetches``
        via ``map_blocks`` when given) under the tenant's quotas. A
        grouped frame (``frame.group_by(...)``) is served as
        ``aggregate(fetches, frame)``, its keyed sums and all, on the
        worker (the JAX package's scheduler takes only a frame).

        Raises :class:`~..resilience.QueryQuarantined` (a poison plan),
        :class:`~..resilience.QueueFull` (bounded queue) or
        :class:`~..resilience.OverQuota` (rows/sec budget), all
        classified, all *before* any work happens. Returns a
        :class:`SubmittedQuery` future otherwise.

        ``query_id`` / ``_checkpoint`` are the serving fabric's
        re-dispatch hooks (``serve/fabric.py``): a query migrated off a
        lost worker re-submits under its ORIGINAL id carrying its
        persisted checkpoint, so that ``ttf.why(query_id)`` shows one
        causal chain across workers and the resume re-dispatches only
        the blocks the dead worker never finished. A grouped submit
        re-dispatches as a grouped submit.
        """
        from ..frame import GroupedFrame
        grouped = frame if isinstance(frame, GroupedFrame) else None
        if grouped is not None:
            if fetches is None:
                raise TypeError("a grouped frame is served as "
                                "aggregate(fetches, grouped): give fetches")
            frame = grouped.frame

            def thunk(grouped=grouped, fetches=fetches):
                from ..engine import ops as _ops
                out = _ops.aggregate(fetches, grouped)
                out.blocks()
                return out
        elif fetches is None:
            def thunk(frame=frame):
                frame.blocks()
                return frame
        else:
            def thunk(frame=frame, fetches=fetches):
                out = frame.map_blocks(fetches)
                out.blocks()
                return out
        if est_rows is None or est_bytes is None:
            rows_guess, bytes_guess = _estimate(frame)
            est_rows = est_rows if est_rows is not None else rows_guess
            est_bytes = est_bytes if est_bytes is not None else bytes_guess
        # fingerprint the FULL query (frame + fetches) for the poison
        # quarantine's streak key; a chain with no usable identity
        # (fp None) is simply never quarantined
        fp: Optional[str] = None
        got = None
        try:
            from ..plan import adaptive as _adaptive
            if grouped is not None:
                got = _adaptive.aggregate_fingerprint(grouped, fetches)
            else:
                got = _adaptive.query_fingerprint(
                    frame if fetches is None else frame.map_blocks(fetches))
            if got is not None:
                fp = got[0]
        except Exception as e:
            _log.debug("query fingerprint failed at submit: %s", e)
        with self._cond:
            if not self._open or self._dying:
                raise RuntimeError(
                    f"scheduler {self.name!r} is closed")
            t = self._tenant(tenant)
            if query_id is None and _checkpoint is None:
                # a fabric re-dispatch (original id or checkpoint in
                # hand) is a MIGRATION, not a fresh submission: it must
                # not fast-reject mid-flight
                try:
                    _quarantine.check(fp)
                except _quarantine.QueryQuarantined:
                    t.counts["quarantined"] += 1
                    gauge("serve.queue_depth", self._queued_locked())
                    raise
            if len(t.queue) >= t.max_queue:
                t.counts["rejected"] += 1
                counters.inc("serve.rejected")
                _flight.record("serve.reject", tenant=tenant,
                               queued=len(t.queue),
                               max_queue=t.max_queue)
                raise QueueFull(
                    f"tenant {tenant!r} queue is full "
                    f"({t.max_queue} queued); retry later (classified "
                    f"'rejected', transient)")
            if t.bucket is not None and est_rows:
                if not t.bucket.try_take(est_rows):
                    t.counts["over_quota"] += 1
                    counters.inc("serve.over_quota")
                    _flight.record("serve.over_quota", tenant=tenant,
                                   est_rows=est_rows,
                                   rate=t.bucket.rate,
                                   tokens=t.bucket.tokens)
                    raise OverQuota(
                        f"tenant {tenant!r} rows/sec budget exhausted "
                        f"({t.bucket.rate:g} rows/s, query estimated "
                        f"{est_rows:g} rows); retry later (classified "
                        f"'over_quota', transient)")
            dl = deadline if deadline is not None else t.deadline_s
            est_stream = None
            if est_bytes:
                parts = max(1, getattr(frame, "num_partitions", 1) or 1)
                est_stream = max(1, int(est_bytes / parts))
            q = SubmittedQuery(
                query_id or f"{self.name}-q{next(self._qid)}", tenant,
                thunk, est_rows, est_bytes,
                time.monotonic() + dl if dl is not None else None,
                est_stream_bytes=est_stream)
            q.fingerprint = fp
            if _checkpoint is not None:
                q._checkpoint = _checkpoint
            if grouped is not None and got is not None:
                q._identity = got
            was_empty = not t.queue
            t.queue.append(q)
            self._queries[q.query_id] = q
            if was_empty:
                # re-activation: an idle tenant must not cash in the
                # passes it never used (stride scheduling)
                t.vpass = max(t.vpass, self._vtime)
            t.counts["submitted"] += 1
            counters.inc("serve.submitted")
            gauge("serve.queue_depth", self._queued_locked())
            self._maybe_preempt_locked(t, arriving_query=q.query_id)
            self._cond.notify()
        return q

    # -- preemption & cancellation -----------------------------------------
    def _maybe_preempt_locked(self, arriving: _Tenant,
                              arriving_query: Optional[str] = None
                              ) -> None:
        """Priority preemption on arrival when a
        higher-weight tenant submits and every execution slot is busy,
        the lowest-weight running query that has run for at least
        ``TFT_PREEMPT_AFTER_MS`` is asked to park at its next block
        boundary. Called with the scheduler lock held."""
        if not self._preemption or not self._open:
            return
        # busy-ness is the INFLIGHT count, not the scoped-running list
        # below: a worker stuck in the HBM admission wait has no scope
        # yet but is every bit as busy — and this early return keeps
        # the uncontended submit path O(tenants), not O(live queries)
        if self._inflight_locked() < max(1, self.workers):
            return  # a free worker will pick the arrival up anyway
        # capture (query, scope) pairs: _complete/_requeue null
        # q._scope outside this lock, and dereferencing it twice could
        # hit None mid-way — requesting preempt on a captured scope
        # whose query just finished is a harmless no-op instead
        running = [(q, sc) for q in self._queries.values()
                   for sc in (q._scope,)
                   if q.state == "running" and sc is not None
                   and not sc.preempt_requested
                   and not sc.cancel_requested]
        after_s = env_float("TFT_PREEMPT_AFTER_MS", 100.0) / 1000.0
        now = time.monotonic()
        victims = [(q, sc) for q, sc in running
                   if self._tenants[q.tenant].weight < arriving.weight
                   and q.started_at is not None
                   and now - q.started_at >= max(after_s, 0.0)]
        if not victims:
            return
        victim, vscope = min(victims, key=lambda p: (
            self._tenants[p[0].tenant].weight, p[0].started_at))
        vscope.request_preempt(
            f"preempted by tenant {arriving.name!r} "
            f"(weight {arriving.weight:g} > "
            f"{self._tenants[victim.tenant].weight:g})")
        counters.inc("serve.preempt_requests")
        _flight.record("serve.preempt", query=victim.query_id,
                       victim_tenant=victim.tenant,
                       victim_weight=self._tenants[victim.tenant].weight,
                       arriving=arriving.name,
                       arriving_query=arriving_query,
                       arriving_weight=arriving.weight,
                       workers=max(1, self.workers),
                       after_ms=env_float("TFT_PREEMPT_AFTER_MS", 100.0))
        # no add_event here: this runs on the SUBMITTER's thread, whose
        # active trace (if any) is not the victim's — the victim-side
        # park records the request (with its reason naming the
        # preemptor) into the right query's trace at the boundary
        _log.info("query %s (tenant %r, weight %g) asked to preempt for "
                  "arriving tenant %r (weight %g)", victim.query_id,
                  victim.tenant, self._tenants[victim.tenant].weight,
                  arriving.name, arriving.weight)

    def cancel(self, query_id: str) -> bool:
        """Cancel a query by id. A queued query never runs (its future
        fails with a classified :class:`~..resilience.QueryCancelled`
        immediately); a running one stops at its next block boundary
        and frees any checkpoint. Returns False when the query is
        unknown or already terminal — a second ``cancel`` of the same
        query is a no-op, not an error."""
        with self._cond:
            q = self._queries.get(query_id)
            if q is None or q.done():
                return False
            t = self._tenants.get(q.tenant)
            queued = t is not None and q in t.queue
            if queued:
                t.queue.remove(q)
                self._queries.pop(query_id, None)
                t.counts["cancelled"] += 1
                gauge("serve.queue_depth", self._queued_locked())
            else:
                # between queue-pop and run, or running: the flag stops
                # it before the thunk / at the next block boundary
                q._cancel_requested = True
                sc = q._scope
                if sc is not None:
                    sc.request_cancel(f"cancel({query_id})")
            self._cond.notify_all()
        counters.inc("serve.cancel_requests")
        _flight.record("serve.cancel", query=query_id, tenant=q.tenant,
                       state="queued" if queued else "running")
        # like the preempt request above, the victim-side boundary
        # records the `cancel` event into the victim's own trace
        if queued:
            counters.inc("serve.cancelled")
            q._complete(error=QueryCancelled(
                f"query {query_id} (tenant {q.tenant!r}) cancelled "
                f"while queued; it never ran"))
        return True

    def query(self, query_id: str) -> Optional[SubmittedQuery]:
        """The live (queued or running) query with this id, else None."""
        with self._cond:
            return self._queries.get(query_id)

    # -- selection ---------------------------------------------------------
    def _queued_locked(self) -> int:
        return sum(len(t.queue) for t in self._tenants.values())

    def _inflight_locked(self) -> int:
        return sum(t.inflight for t in self._tenants.values())

    def _pick_locked(self) -> Optional[_Tenant]:
        best = None
        for t in self._tenants.values():
            if not t.queue or t.inflight >= t.max_inflight:
                continue
            if best is None or t.vpass < best.vpass:
                best = t
        return best

    def _next(self, block: bool) -> Optional[SubmittedQuery]:
        with self._cond:
            while True:
                if not self._open or self._dying:
                    return None
                t = self._pick_locked()
                if t is not None:
                    q = t.queue.popleft()
                    self._vtime = t.vpass
                    t.vpass += 1.0 / t.weight
                    t.inflight += 1
                    gauge("serve.queue_depth", self._queued_locked())
                    gauge("serve.inflight", self._inflight_locked())
                    return q
                if not block:
                    return None
                self._cond.wait(timeout=0.1)

    # -- execution ---------------------------------------------------------
    def _worker(self) -> None:
        while True:
            q = self._next(block=True)
            if q is None:
                return
            self._execute(q)

    def step(self) -> bool:
        """Manually execute ONE scheduling decision (pick the fairest
        eligible query and run it to completion on the calling thread).
        Returns False when nothing is eligible. The deterministic drive
        for ``workers=0`` schedulers (tests, benchmarks, embedding)."""
        q = self._next(block=False)
        if q is None:
            return False
        self._execute(q)
        return True

    def _execute(self, q: SubmittedQuery) -> None:
        # the cost capture rides INSIDE the flight scope: the sentinel's
        # regression record correlates to the same query id, and a
        # preempted run that requeues discards its partial capture at
        # this context exit (partial runs must not calibrate baselines)
        with _flight.scope(q.query_id, worker=self.worker_id):
            with _baseline.capture(q.query_id, tenant=q.tenant):
                self._execute_scoped(q)

    def _execute_scoped(self, q: SubmittedQuery) -> None:
        # everything inside runs under the flight-recorder correlation
        # scope: decisions made deep in the forcing (a
        # re-plan, a ledger spill) land in the ring tagged with this
        # query id, with TFT_TRACE off
        t = self._tenants[q.tenant]
        q.started_at = time.monotonic()
        q.state = "running"
        queue_wait = q.started_at - q.submitted_at
        try:
            if q._cancel_requested:
                # cancelled in the gap between queue-pop and run: it
                # must not execute (the caller was told it would not)
                raise QueryCancelled(
                    f"query {q.query_id} (tenant {q.tenant!r}) "
                    f"cancelled before it started")
            # shed what already missed its deadline while queued: running
            # it would spend capacity on a result nobody can use
            if q.deadline_at is not None and \
                    time.monotonic() >= q.deadline_at:
                raise DeadlineExceeded(
                    f"query {q.query_id} (tenant {q.tenant!r}) spent "
                    f"{queue_wait:.3f}s queued and missed its deadline "
                    f"before starting")
            self._admit(q)
            with self._cond:
                t.counts["admitted"] += 1
            counters.inc("serve.admitted")
            _flight.record("serve.start", tenant=q.tenant,
                           queue_wait_s=round(queue_wait, 6),
                           est_bytes=q.est_bytes,
                           resumed=q.preemptions > 0)
            remaining = None
            if q.deadline_at is not None:
                remaining = max(q.deadline_at - time.monotonic(), 1e-3)
            # the preemption token: cancel()/priority arrivals flip it;
            # the pipelined engine polls it at block boundaries. A
            # resumed query carries its parked checkpoint back in.
            # Publication and the cancel-flag seed happen under the
            # scheduler lock: a cancel() that landed during the
            # admission wait (flag set, no scope yet) must reach this
            # scope, and one arriving after sees q._scope non-None —
            # no window where a cancel can vanish.
            scope = _preempt.PreemptionScope(q.query_id,
                                             checkpoint=q._checkpoint)
            with self._cond:
                q._scope = scope
                if q._cancel_requested:
                    scope.request_cancel(f"cancel({q.query_id})")
            with _obs.query_trace("serve", tenant=q.tenant,
                                  query=q.query_id) as tr:
                if tr is not None:
                    tr.add("sched_start", name=q.query_id,
                           tenant=q.tenant, queue_wait_s=queue_wait,
                           resumed=q.preemptions > 0)
                with _deadline(remaining), _preempt.activate(scope):
                    try:
                        result = q._thunk()
                    except Exception as e:
                        # a device_lost error means the mesh shrank
                        # underneath the query (parallel/elastic.py): one
                        # re-attempt on the surviving devices instead of
                        # failing the future
                        if error_kind(e) != "device_lost":
                            raise
                        counters.inc("serve.device_lost_retries")
                        _obs.add_event("device_lost_retry",
                                       name=q.query_id, tenant=q.tenant)
                        _log.warning(
                            "query %s (tenant %r) hit a device loss "
                            "(%s); retrying once on the shrunken mesh",
                            q.query_id, q.tenant, e)
                        result = q._thunk()
        except QueryPreempted:
            self._requeue_preempted(q, t)
            return
        except BaseException as e:
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                self._finish(q, t, error=e)
                raise
            self._finish(q, t, error=e)
            return
        # fingerprint the result chain while the frame is in hand — the
        # sentinel keys this completion's cost vector by it in _finish
        if q._identity is not None:
            _baseline.note_fingerprint(*q._identity)
        else:
            _baseline.note_result_frame(result)
        self._finish(q, t, result=result)

    def _requeue_preempted(self, q: SubmittedQuery, t: _Tenant) -> None:
        """A preempted query parks, it does not fail: carry the
        checkpoint, put it back at the FRONT of its tenant's queue (it
        already waited its turn), and let the fair scheduler resume it.
        Its deadline keeps running while parked."""
        scope = q._scope
        if scope is not None and scope.checkpoint is not None:
            q._checkpoint = scope.checkpoint
        worker_fault = scope is not None and scope.worker_fault
        q._scope = None
        if worker_fault and self.on_worker_fault is not None:
            # the `worker` fault site fired during this query: tell the
            # fabric BEFORE taking our lock (its handler may close this
            # scheduler, which takes _cond: holding it here would
            # deadlock); the query still requeues below so that the
            # fabric finds it on the dead worker and re-places it
            try:
                self.on_worker_fault(self)
            except Exception as e:
                _log.warning("on_worker_fault hook failed: %s", e)
        with self._cond:
            if not self._open or self._dying:
                # lost the race with close()/mark_lost(): fail like any
                # orphan; the fabric reads this rejection from a dead
                # worker as "migrating" and re-dispatches elsewhere
                self._queries.pop(q.query_id, None)
                t.inflight -= 1
                t.counts["rejected"] += 1
                gauge("serve.inflight", self._inflight_locked())
                self._cond.notify_all()
                q._complete(error=ServeRejected(
                    f"scheduler {self.name!r} shut down while query "
                    f"{q.query_id} was parked"))
                counters.inc("serve.rejected")
                return
            q.preemptions += 1
            q.state = "queued"
            q.started_at = None
            t.inflight -= 1
            t.counts["preempted"] += 1
            t.queue.appendleft(q)
            gauge("serve.queue_depth", self._queued_locked())
            gauge("serve.inflight", self._inflight_locked())
            self._cond.notify_all()
        counters.inc("serve.preemptions")
        cp = q._checkpoint
        _flight.record("serve.requeue", query=q.query_id,
                       tenant=q.tenant, preemptions=q.preemptions,
                       parked_blocks=cp.parked_blocks
                       if cp is not None else 0)
        _log.info("query %s (tenant %r) parked (%d block(s) "
                  "checkpointed); re-queued at the front", q.query_id,
                  q.tenant, cp.parked_blocks if cp is not None else 0)

    def _admit(self, q: SubmittedQuery) -> None:
        """HBM admission: wait (bounded) for headroom, preempting a
        checkpointable whale to clear it, else shed.

        Against a real backend watermark the whole-frame estimate is
        the enforceable footprint (pre-spill semantics). When the
        headroom comes from the spill-capable memory ledger instead
        (no card, ``TFT_MEM_LIMIT_BYTES``
        set), admission is **spill-aware**: the engine streams the
        frame block-by-block and the ledger spills or splits the rest,
        so the footprint compared is the streaming working set
        (~one block) — a larger-than-budget query is executable
        out-of-core and must not be shed for its total size.

        Preempt-aware:
        before falling through to shed, the wait asks the
        largest-footprint running query to PARK at its next block
        boundary — its checkpoint moves completed block outputs
        off-device through the memory ledger, clearing headroom the
        arrival can use, and the whale resumes later from where it
        parked. An arrival is rejected only when preemption could not
        free enough within the wait budget.
        """
        if not self._admission or not q.est_bytes:
            return
        need = q.est_bytes
        if q.est_stream_bytes is not None \
                and _obs_device.watermark() is None:
            from .. import memory as _memory
            mgr = _memory.active()
            if mgr is not None and mgr.spill_enabled:
                need = min(need, q.est_stream_bytes)
        budget = env_float("TFT_SERVE_ADMISSION_WAIT_S", 5.0)
        poll = env_float("TFT_SERVE_ADMISSION_POLL_S", 0.02)
        give_up_at = time.monotonic() + max(budget, 0.0)
        if q.deadline_at is not None:
            give_up_at = min(give_up_at, q.deadline_at)
        waited_since: Optional[float] = None
        waited = False
        preempt_tried = False
        while True:
            if q._cancel_requested:
                # don't spend the admission-wait budget on a query
                # whose caller was already told it will not run
                raise QueryCancelled(
                    f"query {q.query_id} (tenant {q.tenant!r}) "
                    f"cancelled while waiting for admission")
            headroom = self._hbm_headroom()
            if headroom is None or need <= headroom:
                if waited:
                    counters.inc("serve.admission_waits")
                _flight.record(
                    "serve.admit", tenant=q.tenant, est_bytes=need,
                    headroom=headroom,
                    waited_s=round(time.monotonic() - waited_since, 6)
                    if waited_since is not None else 0.0)
                return
            if not preempt_tried:
                # one preemption attempt per admission: ask the whale
                # to park, then keep polling while it checkpoints
                preempt_tried = True
                self._preempt_for_admission(q, need,
                                            shortfall=need - headroom)
            if time.monotonic() >= give_up_at:
                _flight.record("serve.shed", tenant=q.tenant,
                               est_bytes=need, headroom=headroom,
                               budget_s=budget,
                               preempt_tried=preempt_tried)
                raise AdmissionDeadline(
                    f"query {q.query_id} (tenant {q.tenant!r}) shed: "
                    f"estimated footprint {need} B exceeds HBM "
                    f"headroom {headroom} B and admission could not "
                    f"clear within its budget — preemption could not "
                    f"free enough (classified 'deadline_admission')")
            if not waited:
                waited = True
                waited_since = time.monotonic()
                _obs.add_event("sched_admission_wait", name=q.query_id,
                               tenant=q.tenant, est_bytes=need)
            time.sleep(max(poll, 0.001))

    def _preempt_for_admission(self, q: SubmittedQuery, need: int,
                               shortfall: int) -> bool:
        """Ask the largest-footprint checkpointable running query to
        park so ``q`` can admit. Returns whether
        a preempt was requested; the park itself happens at the
        victim's next block boundary. A victim whose known footprint
        cannot plausibly cover ``shortfall`` is left alone — parking
        it would cost a checkpoint + resume for zero headroom gain."""
        if not self._preemption:
            return False
        with self._cond:
            victims = [(v, sc) for v in self._queries.values()
                       for sc in (v._scope,)
                       if v is not q and v.state == "running"
                       and sc is not None
                       and not sc.preempt_requested
                       and not sc.cancel_requested]
        if not victims:
            return False
        victim, vscope = max(
            victims, key=lambda p: (p[0].est_bytes or 0,
                                    p[0].started_at or 0.0))
        if victim.est_bytes is not None \
                and victim.est_bytes < max(shortfall, 0):
            _log.info(
                "admission for query %s: not preempting — the largest "
                "running query %s (est %d B) cannot cover the %d B "
                "shortfall; the arrival will shed at its wait budget",
                q.query_id, victim.query_id, victim.est_bytes,
                shortfall)
            return False
        vscope.request_preempt(
            f"parked to clear {need} B of admission headroom for "
            f"query {q.query_id} (tenant {q.tenant!r})")
        counters.inc("serve.admission_preempts")
        _obs.add_event("sched_admission_preempt", name=q.query_id,
                       tenant=q.tenant, victim=victim.query_id,
                       victim_bytes=victim.est_bytes or 0)
        _flight.record("serve.admission_preempt", query=q.query_id,
                       tenant=q.tenant, victim=victim.query_id,
                       victim_bytes=victim.est_bytes or 0, need=need,
                       shortfall=shortfall)
        _log.info("admission for query %s (tenant %r, %d B) preempting "
                  "query %s (est %s B): parking the whale instead of "
                  "shedding the arrival", q.query_id, q.tenant, need,
                  victim.query_id, victim.est_bytes)
        return True

    def _hbm_headroom(self) -> Optional[int]:
        """Bytes below the high-water mark, or None when unenforceable.

        The backend watermark (live allocator stats) is authoritative
        when the backend reports one; otherwise the memory manager's
        ledger stands in: its budget minus
        in-flight reservations, with spillable resident bytes counted
        as reclaimable — which makes admission enforceable even on
        backends without memory stats (``TFT_MEM_LIMIT_BYTES`` on CPU).
        None only when neither exists."""
        wm = _obs_device.watermark()
        frac = env_float("TFT_SERVE_HBM_FRACTION", 0.9)
        if wm is None:
            from .. import memory as _memory
            mgr = _memory.active()
            if mgr is not None:
                return mgr.headroom(frac)
            return None
        limit = env_int("TFT_SERVE_HBM_LIMIT_BYTES", 0) \
            or wm.get("limit_bytes") or 0
        if limit <= 0:
            return None
        return int(limit * frac) - int(wm["live_bytes"])

    def _finish(self, q: SubmittedQuery, t: _Tenant,
                result: Any = None,
                error: Optional[BaseException] = None) -> None:
        # cross-cutting audit at the query-finish quiesce point
        # (resilience/invariants.py): in strict (chaos/test) mode a
        # violation fails THIS query, classified 'invariant', instead
        # of resolving its future green over books just proven wrong
        if _invariants.enabled():
            try:
                _invariants.audit("serve.finish")
            except InvariantViolation as iv:
                if error is None:
                    result, error = None, iv
        q._complete(result=result, error=error)
        from ..memory import persist as _persist
        if _persist.enabled():
            # a TERMINAL state is the only point where a query's durable
            # checkpoint dies: close()'s orphan path keeps the file so
            # that the fabric can resume the query on another worker
            _persist.discard_checkpoint(q.query_id)
        dur = q.finished_at - q.submitted_at  # end-to-end serving latency
        if error is None:
            outcome = "ok"
            key = "completed"
        else:
            outcome = error_kind(error)
            if isinstance(error, QueryCancelled):
                key = "cancelled"
            elif isinstance(error, AdmissionDeadline):
                key = "shed"
            elif isinstance(error, ServeRejected):
                key = "rejected"
            else:
                key = "failed"
        # tenant bookkeeping BEFORE the observability tail: the future
        # resolved at q._complete above, so a caller holding result()
        # may read snapshot() at any moment — the counts must already
        # reflect this completion (the baseline finalize below walks
        # counter registries and can take milliseconds under load)
        with self._cond:
            self._queries.pop(q.query_id, None)
            t.inflight -= 1
            t.counts[key] += 1
            gauge("serve.inflight", self._inflight_locked())
            self._cond.notify_all()
        # poison-query streaks: only PERMANENT failures count — the
        # resilience layer's own outcomes (transient retries, OOM
        # splits, preempts, sheds) are not evidence the plan is poison
        if key == "completed":
            _quarantine.note_success(q.fingerprint)
        elif key == "failed" and outcome == "permanent":
            _quarantine.note_failure(q.fingerprint, error)
        histograms.observe("query_latency_seconds", dur, op="serve",
                           tenant=t.name, outcome=outcome)
        counters.inc(f"serve.{key}")
        # close out the cost capture: fold the vector into the plan
        # fingerprint's baseline and run the regression check (only
        # "completed" calibrates; the capture contextvar is still live
        # because _finish runs inside _execute's capture scope). The
        # baseline gets EXECUTION latency, not end-to-end: queue wait
        # under a burst is a scheduling condition the SLO layer already
        # watches — folding it in makes every congested query look like
        # a plan regression
        run_s = dur if q.started_at is None \
            else q.finished_at - q.started_at
        vec = _baseline.finalize(latency_s=run_s, outcome=key)
        _flight.record("serve.finish", query=q.query_id, tenant=t.name,
                       outcome=key, latency_s=round(dur, 6))
        # durable query history: fold this completion (cost vector,
        # flight-decision digest) into the archive, AFTER the serve.finish
        # record so that the digest carries the terminal decision too
        # (best effort; never raises)
        _history.record_finish(
            q.query_id, tenant=t.name, fingerprint=q.fingerprint,
            outcome=key,
            error=(f"{type(error).__name__}: {error}"
                   if error is not None else None),
            error_kind=outcome if error is not None else None,
            worker=self.worker_id, cost=vec,
            queued_s=(q.started_at - q.submitted_at
                      if q.started_at is not None else None),
            run_s=run_s, total_s=dur,
            est_rows=q.est_rows, est_bytes=q.est_bytes,
            preemptions=q.preemptions, source="serve",
            decisions=_flight.for_query(q.query_id))
        # SLO burn-rate callbacks evaluate off the completion path
        # (throttled per tenant)
        _slo.note_completion(t.name)

    def request_park_all(self, reason: str = "drain") -> int:
        """Ask every RUNNING query to park at its next block boundary
        (their checkpoints write through to the durable tier when it is
        on). The fabric's crash and drain primitive: called before
        :meth:`close` so that a simulated worker death leaves resumable
        checkpoints instead of completed queries. Returns the number of
        queries asked."""
        with self._cond:
            scopes = [sc for q in self._queries.values()
                      for sc in (q._scope,)
                      if q.state == "running" and sc is not None]
        for sc in scopes:
            sc.request_preempt(reason)
        if scopes:
            _log.info("scheduler %r: park requested for %d running "
                      "query(ies) (%s)", self.name, len(scopes), reason)
        return len(scopes)

    # -- introspection -----------------------------------------------------
    def audit_invariants(self, point: str = "inline") -> List[str]:
        """No-orphan accounting, one consistent read (the built-in
        scheduler auditor, ``resilience/invariants.py``): every live
        query is queued, running, or mid-``_finish``; queue lengths,
        inflight counts, and the live-query table all agree; nothing
        has gone negative. At a ``*.close`` point the table must be
        EMPTY — anything left is an orphan whose future never
        resolves."""
        out: List[str] = []
        with self._cond:
            queued = running = finishing = 0
            for q in self._queries.values():
                if q.state == "queued":
                    queued += 1
                elif q.state == "running":
                    running += 1
                else:
                    # terminal state, not yet popped: the short window
                    # inside a concurrent _finish — balanced below, an
                    # orphan only at close
                    finishing += 1
            in_queues = sum(len(t.queue) for t in self._tenants.values())
            inflight = sum(t.inflight for t in self._tenants.values())
            if queued != in_queues:
                out.append(
                    f"scheduler {self.name!r}: {queued} queued query(ies)"
                    f" vs {in_queues} queue entries")
            if inflight != running + finishing:
                out.append(
                    f"scheduler {self.name!r}: inflight accounting "
                    f"{inflight} != {running} running + {finishing} "
                    f"finishing")
            for t in self._tenants.values():
                if t.inflight < 0:
                    out.append(f"tenant {t.name!r}: negative inflight "
                               f"({t.inflight})")
                for k, v in t.counts.items():
                    if v < 0:
                        out.append(f"tenant {t.name!r}: negative "
                                   f"{k!r} count ({v})")
            if point.endswith(".close") and not self._open \
                    and self._queries:
                out.append(
                    f"scheduler {self.name!r}: {len(self._queries)} "
                    f"query(ies) orphaned at {point}: "
                    f"{sorted(self._queries)[:5]}")
        return out

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant live state + outcome totals (one consistent read)."""
        with self._cond:
            out: Dict[str, Dict[str, Any]] = {}
            for name, t in sorted(self._tenants.items()):
                out[name] = {"weight": t.weight,
                             "queued": len(t.queue),
                             "inflight": t.inflight,
                             "max_queue": t.max_queue,
                             "max_inflight": t.max_inflight,
                             **t.counts}
            return out

    def __repr__(self):
        state = "open" if self._open else "closed"
        return (f"QueryScheduler({self.name!r}, {state}, "
                f"workers={self.workers}, tenants={len(self._tenants)})")


# ---------------------------------------------------------------------------
# process-default scheduler (the `ttf.submit()` backend)
# ---------------------------------------------------------------------------

_default_lock = threading.Lock()
_default: Optional[QueryScheduler] = None


def default_scheduler() -> QueryScheduler:
    """The lazily-created process default (env-configured); created on
    first :func:`~..api.submit`."""
    global _default
    if _default is None or not _default._open:
        with _default_lock:
            if _default is None or not _default._open:
                _default = QueryScheduler(name="serve")
    return _default


def set_default_scheduler(s: Optional[QueryScheduler]
                          ) -> Optional[QueryScheduler]:
    """Swap the process default (does NOT close the old one); returns
    the previous."""
    global _default
    with _default_lock:
        prev, _default = _default, s
    return prev


def shutdown_default_scheduler() -> None:
    global _default
    with _default_lock:
        s, _default = _default, None
    if s is not None:
        s.close()
