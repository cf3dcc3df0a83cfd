"""The serving fabric: tenants placed across workers, a lost worker's
queries resumed from persisted checkpoints, rolling restarts.

The port's counterpart of ``tensorframes_tpu/serve/fabric.py``. Every
robustness guarantee of the serving stack (preempt/resume checkpoints,
the plan-fingerprint result cache, per-tenant SLO burn rates) lives
inside ONE scheduler and dies with it. The fabric is the coordinator
that makes the worker group itself a managed, failure-prone resource:
N workers, each a full :class:`~.scheduler.QueryScheduler`, with the
coordinator owning placement, health and recovery.

**Workers.** Each :class:`FabricWorker` wraps one scheduler named
``<fabric>-w<i>e<epoch>`` (the epoch increments across restarts). As in
the JAX package the workers are in-process: on the card they share one
process, one CUDA context and one caching allocator. They simulate the
process boundary honestly: a "crash" parks running queries (checkpoints
write through to the durable tier, ``memory/persist.py``, which strips
their devices: the survivor puts the blocks back on its default device),
closes the scheduler (queued queries orphan), and invalidates the
in-memory result cache: exactly the state a dead process loses. What
survives is exactly what the disk holds. All workers share ONE
:class:`~.cache.SharedCompileCache`: its keys are structural, so the
fleet exports and interns each program once.

**Placement.** Tenants map to workers least-loaded first at their first
submit (``fabric.place``). The balancing signal is the SLO burn rate
(``observability/slo.py``): a tenant burning its error budget faster
than ``TFT_FABRIC_BURN_FACTOR`` times its hottest peer (and above 1.0:
actually over budget) is re-placed onto the least-loaded other worker
(``fabric.rebalance``, cooldown-limited). Every placement decision lands
in the flight ring under ``query="tenant:<name>"``, so
``ttf.why("tenant:hot")`` reconstructs a tenant's placement history.

**Failure matrix.** Worker health is a heartbeat and a lease: every
:meth:`ServeFabric.tick` beats each worker; ``TFT_FABRIC_MISSED_HB``
consecutive misses declare it lost (``fabric.worker_lost``, classified
``worker_lost``: never retried against the corpse, recovery is
structural). Then:

- **queued queries** of the dead worker re-place onto survivors and
  re-run cold: they never started, there is nothing to resume;
- **running queries** resume from their PERSISTED checkpoint on a
  survivor (``fabric.resume_dispatch`` under the query's ORIGINAL id,
  so ``ttf.why(qid)`` is one causal chain across workers). The resume
  re-dispatches only the blocks the dead worker never finished,
  bit-identical; any tag or cursor mismatch discards to a cold re-run:
  never wrong, never dropped. A grouped submit (``submit(grouped,
  fetches)``) re-dispatches as one, so a resumed keyed aggregate still
  runs the segment_sum kernel on the survivor;
- **tenants** of the dead worker re-place (``fabric.replace``).

The deterministic ``worker`` fault site (``TFT_FAULTS=worker:1``)
drives this whole path: a running query's next block boundary parks it
and flags the crash (``engine/preempt.py``); an idle worker consumes the
fault at its next heartbeat.

**Rolling restarts.** :meth:`ServeFabric.restart_worker` drains (park,
persist), closes, bumps the epoch, starts a fresh scheduler, and gates
re-admission with a probe query (a tiny known-answer query through the
worker's own scheduler: ``fabric.admit`` / ``fabric.admit_probe_failed``).
:meth:`ServeFabric.rolling_restart` does that worker by worker; in-flight
queries migrate, and the result cache comes back warm from the durable
tier (``plan.result_cache_warm_hits``, zero dispatches) for the chains it
may cache: parquet-rooted, of programs whose state it can pin (not a DSL
program, ``plan/adaptive.py``). A worker between its drain and its probe
is exempt from the lease: the monitor's beats while it drains declare
nothing (the JAX package counts them as missed and declares the
restarting worker lost).

Knobs: ``TFT_FABRIC`` (1; ``0`` degrades to one worker with pass-through
submits, bit-identical to a plain scheduler), ``TFT_FABRIC_WORKERS`` (2),
``TFT_HEARTBEAT_MS`` (100), ``TFT_FABRIC_MISSED_HB`` (3),
``TFT_FABRIC_REBALANCE_TICKS`` (5), ``TFT_FABRIC_BURN_FACTOR`` (2.0),
``TFT_FABRIC_BURN_MIN_QUERIES`` (3), ``TFT_FABRIC_MAX_REDISPATCH`` (3).
"""

from __future__ import annotations

import itertools
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..memory import persist as _persist
from ..observability import flight as _flight
from ..observability import history as _history
from ..resilience import (ServeRejected, WorkerLost, env_bool, env_float,
                          env_int)
from ..resilience import faults as _faults
from ..utils.logging import get_logger
from ..utils.tracing import counters
from .cache import SharedCompileCache
from .scheduler import QueryScheduler, TenantQuota

__all__ = ["ServeFabric", "FabricWorker", "FabricQuery", "live_fabric",
           "fabric_enabled"]

_log = get_logger("serve.fabric")

_live_lock = threading.Lock()
_live: List["ServeFabric"] = []


def fabric_enabled() -> bool:
    """``TFT_FABRIC`` gate (default on). ``TFT_FABRIC=0`` collapses the
    fabric to one pass-through worker — bit-identical to a plain
    :class:`~.scheduler.QueryScheduler`."""
    return env_bool("TFT_FABRIC", True)


def live_fabric() -> Optional["ServeFabric"]:
    """The most recently opened fabric still running, or ``None``
    (``ttf.health()``'s fabric section reads this)."""
    with _live_lock:
        for f in reversed(_live):
            if f._open:
                return f
    return None


class FabricWorker:
    """One worker (in-process; module docstring)."""

    __slots__ = ("index", "epoch", "scheduler", "alive", "lost",
                 "missed", "lease_at", "fault_pending", "started_at",
                 "restarting")

    def __init__(self, index: int, epoch: int,
                 scheduler: QueryScheduler):
        self.index = index
        self.epoch = epoch
        self.scheduler = scheduler
        self.alive = True
        self.lost = False
        self.missed = 0            # consecutive failed heartbeats
        self.lease_at = time.monotonic()
        self.fault_pending = False  # a crash scheduled for the next tick
        self.started_at = time.monotonic()
        # between restart_worker's drain and its admission probe: the
        # worker is down on purpose, so its missed beats declare nothing
        self.restarting = False

    @property
    def worker_id(self) -> str:
        return f"w{self.index}"

    def busy(self) -> bool:
        try:
            snap = self.scheduler.snapshot()
        except Exception:
            return False
        return any(v.get("queued", 0) or v.get("inflight", 0)
                   for v in snap.values())

    def heartbeat(self, allow_fault: bool = True) -> bool:
        """One lease check: True when the worker answered. An idle
        worker consumes a pending ``worker`` fault here — but only
        while the WHOLE fabric is idle (``allow_fault``): when any
        query is running somewhere, its own block boundary consumes
        the fault (``engine/preempt.py``) so ``TFT_FAULTS=worker:1``
        deterministically kills the worker doing the work."""
        if not self.alive or not self.scheduler._open:
            return False
        if allow_fault and _faults.active("worker") \
                and not self.fault_pending and not self.busy():
            try:
                _faults.check("worker")
            except _faults.InjectedFault:
                self.fault_pending = True  # the next tick executes it
        return True

    def __repr__(self):
        state = ("lost" if self.lost
                 else "alive" if self.alive else "down")
        return (f"FabricWorker({self.worker_id}, epoch={self.epoch}, "
                f"{state})")


class FabricQuery:
    """The fabric-level future over a query: survives its worker.

    Wraps the current :class:`~.scheduler.SubmittedQuery` attempt; a
    worker death swaps a new attempt in (same ``query_id``, persisted
    checkpoint carried over) without the caller noticing anything but
    latency. Terminal errors (the query's own failure, a policy
    rejection from a LIVE worker) pass through; a rejection from a dead
    or restarting worker means *migrating*, not failed.
    """

    __slots__ = ("query_id", "tenant", "attempts", "worker_index",
                 "_fabric", "_frame", "_fetches", "_kwargs", "_current",
                 "_event", "_result", "_error", "_lock")

    def __init__(self, fabric: "ServeFabric", query_id: str, tenant: str,
                 frame, fetches, kwargs: Dict[str, Any]):
        self.query_id = query_id
        self.tenant = tenant
        self.attempts = 0
        self.worker_index: Optional[int] = None
        self._fabric = fabric
        self._frame = frame
        self._fetches = fetches
        self._kwargs = kwargs
        self._current = None  # the live SubmittedQuery attempt
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    @property
    def state(self) -> str:
        if self._event.is_set():
            return "failed" if self._error is not None else "done"
        sq = self._current
        return sq.state if sq is not None else "placing"

    def _complete(self, result: Any = None,
                  error: Optional[BaseException] = None) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._result = result
            self._error = error
            self._event.set()

    def result(self, timeout: Optional[float] = None):
        """Block for the query's terminal result across any number of
        worker deaths and migrations. Drives the fabric's tick while
        waiting, so monitorless fabrics (tests) still make progress."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        while not self._event.is_set():
            self._fabric.tick()
            if self._event.is_set():
                break
            sq = self._current
            if sq is not None:
                sq._event.wait(0.05)
            else:
                time.sleep(0.01)
            self._fabric._settle(self)
            if deadline is not None and not self._event.is_set() \
                    and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"fabric query {self.query_id} not finished within "
                    f"{timeout}s (state={self.state}, "
                    f"attempts={self.attempts})")
        if self._error is not None:
            raise self._error
        return self._result

    def __repr__(self):
        return (f"FabricQuery({self.query_id}, tenant={self.tenant!r}, "
                f"state={self.state}, attempts={self.attempts})")


class ServeFabric:
    """The coordinator (module docstring). Context-manage or
    :meth:`close`."""

    def __init__(self,
                 workers: Optional[int] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 worker_threads: int = 1,
                 persist_dir: Optional[str] = None,
                 monitor: Optional[bool] = None,
                 probe: bool = True,
                 heartbeat_ms: Optional[float] = None,
                 missed_hb: Optional[int] = None,
                 name: str = "fab"):
        self.name = name
        self.enabled = fabric_enabled()
        n = (workers if workers is not None
             else env_int("TFT_FABRIC_WORKERS", 2))
        if not self.enabled:
            n = 1  # TFT_FABRIC=0: one pass-through worker
        if n < 1:
            raise ValueError(f"workers must be >= 1, got {n}")
        self.heartbeat_ms = (heartbeat_ms if heartbeat_ms is not None
                             else env_float("TFT_HEARTBEAT_MS", 100.0))
        self.missed_hb = (missed_hb if missed_hb is not None
                          else env_int("TFT_FABRIC_MISSED_HB", 3))
        self.rebalance_ticks = env_int("TFT_FABRIC_REBALANCE_TICKS", 5)
        self.burn_factor = env_float("TFT_FABRIC_BURN_FACTOR", 2.0)
        self.burn_min_queries = env_int("TFT_FABRIC_BURN_MIN_QUERIES", 3)
        self.max_redispatch = env_int("TFT_FABRIC_MAX_REDISPATCH", 3)
        self._quotas = dict(quotas or {})
        self._worker_threads = max(1, int(worker_threads))
        self._lock = threading.RLock()
        self._open = True
        self._qn = itertools.count(1)
        self._tick_no = 0
        self._queries: Dict[str, FabricQuery] = {}
        self._placement: Dict[str, int] = {}
        # tenant -> (tick of last burn-move, query total at that move)
        self._last_rebalance: Dict[str, Tuple[int, int]] = {}
        # the fleet-level compile cache: one instance, every worker:
        # structural keys make it safe across workers
        self.compile_cache = SharedCompileCache()
        # durable tier: an explicit dir, the ambient TFT_PERSIST_DIR,
        # or a private tmpdir the fabric owns and removes on close
        self._persist_prev: Any = False  # False = never configured
        self._own_persist_dir: Optional[str] = None
        if persist_dir is not None:
            self._persist_prev = _persist.configure(persist_dir)
        elif not _persist.enabled():
            d = tempfile.mkdtemp(prefix=f"tft-{name}-persist-")
            self._own_persist_dir = d
            self._persist_prev = _persist.configure(d)
        self._workers: List[FabricWorker] = []
        for i in range(n):
            w = FabricWorker(i, 0, self._new_scheduler(i, 0))
            self._workers.append(w)
        with _live_lock:
            _live.append(self)
        if self.enabled and probe:
            for w in self._workers:
                self._probe_worker(w)
        self._monitor: Optional[threading.Thread] = None
        run_monitor = (monitor if monitor is not None else self.enabled)
        if run_monitor:
            self._monitor = threading.Thread(
                target=self._monitor_loop,
                name=f"tft-{name}-monitor", daemon=True)
            self._monitor.start()
        _log.info("ServeFabric %r: %d worker(s), heartbeat %.0fms, "
                  "lease %d missed beats, persist %s%s", name, n,
                  self.heartbeat_ms, self.missed_hb,
                  _persist.root() or "off",
                  "" if self.enabled else " (TFT_FABRIC=0 pass-through)")

    # -- lifecycle ---------------------------------------------------------
    def _new_scheduler(self, index: int, epoch: int) -> QueryScheduler:
        s = QueryScheduler(quotas=dict(self._quotas),
                           workers=self._worker_threads,
                           shared_cache=self.compile_cache,
                           name=f"{self.name}-w{index}e{epoch}")
        s.worker_id = f"w{index}"
        s.on_worker_fault = self._on_worker_fault
        return s

    def __enter__(self) -> "ServeFabric":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self, timeout: float = 30.0) -> None:
        """Close every worker, stop the monitor, restore the persist
        override, remove a fabric-owned persistence dir. Idempotent."""
        with self._lock:
            if not self._open:
                return
            self._open = False
            workers = list(self._workers)
        for w in workers:
            w.alive = False
            try:
                w.scheduler.close(timeout=timeout)
            except Exception as e:
                _log.warning("closing worker %s failed: %s",
                             w.worker_id, e)
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        with _live_lock:
            if self in _live:
                _live.remove(self)
        if self._persist_prev is not False:
            _persist.configure(self._persist_prev)
        if self._own_persist_dir is not None:
            shutil.rmtree(self._own_persist_dir, ignore_errors=True)
        _log.info("ServeFabric %r closed", self.name)

    def _monitor_loop(self) -> None:
        interval = max(self.heartbeat_ms, 1.0) / 1000.0
        while self._open:
            try:
                self.tick()
            except Exception as e:
                _log.error("fabric %r tick failed: %s", self.name, e)
            time.sleep(interval)

    # -- placement ---------------------------------------------------------
    def _live_workers_locked(self,
                             exclude: Optional[int] = None
                             ) -> List[FabricWorker]:
        return [w for w in self._workers
                if w.alive and not w.lost and not w.fault_pending
                and w.scheduler._open and not w.scheduler._dying
                and w.index != exclude]

    def _tenant_count_locked(self, index: int) -> int:
        return sum(1 for i in self._placement.values() if i == index)

    def _pick_worker_locked(self,
                            exclude: Optional[int] = None
                            ) -> Optional[FabricWorker]:
        live = self._live_workers_locked(exclude)
        if not live:
            return None
        return min(live, key=lambda w: (
            self._tenant_count_locked(w.index), w.index))

    def _place_locked(self, tenant: str) -> Optional[int]:
        idx = self._placement.get(tenant)
        if idx is not None:
            w = self._workers[idx]
            if w.alive and not w.lost and not w.fault_pending \
                    and w.scheduler._open and not w.scheduler._dying:
                return idx
        w = self._pick_worker_locked()
        if w is None:
            return None
        self._placement[tenant] = w.index
        _flight.record("fabric.place", query=f"tenant:{tenant}",
                       tenant=tenant, worker=w.worker_id,
                       tenants_on_worker=self._tenant_count_locked(
                           w.index))
        _log.info("fabric %r: tenant %r placed on %s", self.name,
                  tenant, w.worker_id)
        return w.index

    # -- submit ------------------------------------------------------------
    def submit(self, frame, fetches=None, *, tenant: str = "default",
               **kwargs) -> FabricQuery:
        """Queue one query on the tenant's placed worker. Raises the
        scheduler's classified policy rejections (queue full / over
        quota) directly — those are the tenant's quota talking, not a
        worker failure. Returns a :class:`FabricQuery`."""
        with self._lock:
            if not self._open:
                raise RuntimeError(f"fabric {self.name!r} is closed")
            qid = f"{self.name}-q{next(self._qn)}"
            fq = FabricQuery(self, qid, tenant, frame, fetches,
                             dict(kwargs))
            idx = self._place_locked(tenant)
            if idx is None:
                raise WorkerLost(
                    f"fabric {self.name!r} has no live workers to "
                    f"place tenant {tenant!r} on")
            w = self._workers[idx]
            self._queries[qid] = fq
        try:
            sq = w.scheduler.submit(frame, fetches, tenant=tenant,
                                    query_id=qid, **kwargs)
        except Exception:
            with self._lock:
                self._queries.pop(qid, None)
            raise
        with fq._lock:
            fq._current = sq
            fq.worker_index = w.index
            fq.attempts = 1
        counters.inc("fabric.submitted")
        return fq

    # -- failure handling --------------------------------------------------
    def _on_worker_fault(self, scheduler: QueryScheduler) -> None:
        """Scheduler hook: a running query's park was caused by the
        ``worker`` fault site. Kill the scheduler's intake NOW
        (``mark_lost`` — this thread is the victim's own worker
        thread, so a full close() here would self-join) so the parked
        query orphans instead of resuming on the corpse; the next tick
        executes the rest of the crash."""
        scheduler.mark_lost()
        with self._lock:
            for w in self._workers:
                if w.scheduler is scheduler and w.alive:
                    w.fault_pending = True
                    _log.warning("fabric %r: worker %s hit the "
                                 "`worker` fault site; crash scheduled",
                                 self.name, w.worker_id)
                    return

    def _execute_crash(self, w: FabricWorker) -> None:
        """Kill one worker the way a process dies: running queries are
        already parked (or asked to), the scheduler closes (queued
        queries orphan with rejections the fabric treats as
        *migrating*), and the in-memory result cache dies with it.
        Disk keeps what the durable tier wrote."""
        counters.inc("fabric.worker_crashes")
        _flight.record("fabric.worker_crash", worker=w.worker_id,
                       epoch=w.epoch)
        _log.warning("fabric %r: worker %s crashed (epoch %d)",
                     self.name, w.worker_id, w.epoch)
        try:
            w.scheduler.request_park_all("worker crash")
            w.scheduler.close()
        except Exception as e:
            _log.warning("crashing worker %s: close failed: %s",
                         w.worker_id, e)
        from ..plan import adaptive as _adaptive
        _adaptive.invalidate_results()  # process memory is gone

    def _declare_lost(self, w: FabricWorker) -> None:
        """The lease expired: classify, re-place tenants, re-dispatch
        the dead worker's queries (module docstring failure matrix)."""
        if w.lost:
            return
        w.lost = True
        w.alive = False
        counters.inc("fabric.workers_lost")
        _flight.record("fabric.worker_lost", worker=w.worker_id,
                       epoch=w.epoch, missed=w.missed,
                       classified="worker_lost")
        _log.error("fabric %r: worker %s declared lost after %d missed "
                   "heartbeat(s)", self.name, w.worker_id, w.missed)
        if w.scheduler._open:
            try:
                w.scheduler.request_park_all("worker lost")
                w.scheduler.close()
            except Exception as e:
                _log.warning("closing lost worker %s failed: %s",
                             w.worker_id, e)
        with self._lock:
            moved = [t for t, i in self._placement.items()
                     if i == w.index]
            for t in moved:
                nw = self._pick_worker_locked(exclude=w.index)
                if nw is None:
                    continue
                self._placement[t] = nw.index
                _flight.record("fabric.replace", query=f"tenant:{t}",
                               tenant=t, source=w.worker_id,
                               worker=nw.worker_id,
                               reason="worker_lost")
                _log.info("fabric %r: tenant %r re-placed %s -> %s "
                          "(worker lost)", self.name, t, w.worker_id,
                          nw.worker_id)
            victims = [fq for fq in self._queries.values()
                       if fq.worker_index == w.index
                       and not fq.done()]
        for fq in victims:
            self._redispatch(fq, reason="worker_lost")

    def _redispatch(self, fq: FabricQuery, reason: str) -> None:
        """Move one in-flight query to a survivor: resume from its
        persisted checkpoint when one exists (and matches: the
        checkpoint's contract discards any drift to a cold re-run), cold
        otherwise.
        Same query id either way: one causal chain in ``ttf.why()``."""
        if fq.done():
            return
        with self._lock:
            prev = (self._workers[fq.worker_index].worker_id
                    if fq.worker_index is not None else None)
            idx = self._place_locked(fq.tenant)
            w = self._workers[idx] if idx is not None else None
        if w is None:
            fq._complete(error=WorkerLost(
                f"query {fq.query_id}: no surviving workers to "
                f"re-dispatch onto"))
            return
        if fq.attempts >= 1 + self.max_redispatch:
            fq._complete(error=WorkerLost(
                f"query {fq.query_id} re-dispatched "
                f"{fq.attempts - 1} time(s) without completing "
                f"(TFT_FABRIC_MAX_REDISPATCH={self.max_redispatch})"))
            return
        cp = (_persist.load_checkpoint(fq.query_id)
              if _persist.enabled() else None)
        try:
            sq = w.scheduler.submit(fq._frame, fq._fetches,
                                    tenant=fq.tenant,
                                    query_id=fq.query_id,
                                    _checkpoint=cp, **fq._kwargs)
        except Exception as e:
            fq._complete(error=e)
            return
        with fq._lock:
            fq._current = sq
            fq.worker_index = w.index
            fq.attempts += 1
        counters.inc("fabric.redispatches")
        _flight.record("fabric.resume_dispatch", query=fq.query_id,
                       tenant=fq.tenant, worker=w.worker_id,
                       reason=reason, attempt=fq.attempts,
                       resumed_blocks=(cp.parked_blocks
                                       if cp is not None else 0),
                       from_checkpoint=cp is not None)
        # durable query history: a dead worker never reaches its own
        # _finish fold, so the coordinator stamps the migration here —
        # the survivor's terminal record stitches onto this one (same
        # query id, worker path A->B) in ttf.history()
        _history.record_finish(
            fq.query_id, tenant=fq.tenant, outcome="migrated",
            worker=prev, source="fabric",
            summary=f"re-dispatched to {w.worker_id} ({reason}, "
                    f"attempt #{fq.attempts}, "
                    + (f"{cp.parked_blocks} block(s) from checkpoint"
                       if cp is not None else "cold re-run") + ")",
            decisions=_flight.for_query(fq.query_id))
        _log.info("fabric %r: query %s re-dispatched to %s (%s, "
                  "%s)", self.name, fq.query_id, w.worker_id, reason,
                  f"{cp.parked_blocks} block(s) from checkpoint"
                  if cp is not None else "cold")

    def _settle(self, fq: FabricQuery) -> bool:
        """Fold one attempt's outcome into the fabric future. A
        rejection from a dead/restarting worker is *migrating* (the
        tick re-dispatches); everything else is terminal."""
        if fq.done():
            return True
        sq = fq._current
        if sq is None or not sq.done():
            return False
        if sq._error is None:
            fq._complete(result=sq._result)
            return True
        err = sq._error
        with self._lock:
            w = (self._workers[fq.worker_index]
                 if fq.worker_index is not None else None)
            worker_dead = (w is None or not w.alive or w.lost
                           or not w.scheduler._open
                           or w.scheduler._dying or w.fault_pending)
        if isinstance(err, ServeRejected) and worker_dead:
            return False  # migrating: the dead worker's orphan rejection
        fq._complete(error=err)
        return True

    # -- the heartbeat loop ------------------------------------------------
    def tick(self) -> None:
        """One coordinator pass: execute scheduled crashes, beat every
        lease, declare the expired lost, settle finished queries,
        maybe rebalance. Thread-safe; the monitor calls it on the
        heartbeat interval and ``FabricQuery.result`` drives it too."""
        if not self._open:
            return
        with self._lock:
            crashing = [w for w in self._workers
                        if w.fault_pending and w.alive]
            for w in crashing:
                w.alive = False
                w.fault_pending = False
        for w in crashing:
            self._execute_crash(w)
        lost_now: List[FabricWorker] = []
        with self._lock:
            if not self.enabled:
                pass  # one pass-through worker: no lease to manage
            else:
                idle = not any(w.busy() for w in self._workers
                               if w.alive and not w.lost)
                for w in self._workers:
                    if w.lost or w.restarting:
                        continue
                    if w.heartbeat(allow_fault=idle):
                        w.missed = 0
                        w.lease_at = time.monotonic()
                    else:
                        w.missed += 1
                        _flight.record("fabric.heartbeat_miss",
                                       worker=w.worker_id,
                                       missed=w.missed,
                                       limit=self.missed_hb)
                        if w.missed >= self.missed_hb:
                            lost_now.append(w)
            queries = list(self._queries.values())
        for w in lost_now:
            self._declare_lost(w)
        for fq in queries:
            self._settle(fq)
        with self._lock:
            self._tick_no += 1
            do_rebalance = (self.enabled
                            and self.rebalance_ticks > 0
                            and self._tick_no % self.rebalance_ticks
                            == 0)
        if do_rebalance:
            self._rebalance()

    # -- SLO-burn rebalance ------------------------------------------------
    def _rebalance(self) -> None:
        """Act on the SLO burn rates: a tenant over budget AND
        burning ``TFT_FABRIC_BURN_FACTOR``x its hottest peer moves to
        the least-loaded other worker. Edge-triggered per tenant with a
        cooldown so one hot window cannot thrash placement."""
        try:
            from ..observability.slo import slo_status
            statuses = slo_status()
        except Exception as e:
            _log.debug("fabric rebalance: slo_status failed: %s", e)
            return
        with self._lock:
            placed = dict(self._placement)
        burns: Dict[str, float] = {}
        for t, idx in placed.items():
            st = statuses.get(t)
            if not st or st.get("burn_rate") is None:
                continue
            if st.get("total", 0) < self.burn_min_queries:
                continue
            burns[t] = float(st["burn_rate"])
        for t, burn in sorted(burns.items(), key=lambda kv: -kv[1]):
            if burn <= 1.0:
                break  # inside budget: nothing to act on
            peers = [b for pt, b in burns.items() if pt != t]
            peer_max = max(peers) if peers else 0.0
            if peers and burn <= self.burn_factor * peer_max:
                continue
            total = int(statuses[t].get("total", 0))
            with self._lock:
                cooldown = max(2 * self.rebalance_ticks, 1)
                last = self._last_rebalance.get(t)
                if last is not None and (
                        self._tick_no - last[0] < cooldown
                        or total <= last[1]):
                    # burn is a trailing window: without NEW queries
                    # since the last move it is stale evidence, and
                    # acting on it again just ping-pongs the tenant
                    continue
                cur = placed[t]
                nw = self._pick_worker_locked(exclude=cur)
                if nw is None or nw.index == cur:
                    continue
                self._placement[t] = nw.index
                self._last_rebalance[t] = (self._tick_no, total)
                src = self._workers[cur].worker_id
                counters.inc("fabric.rebalances")
                _flight.record("fabric.rebalance",
                               query=f"tenant:{t}", tenant=t,
                               source=src, worker=nw.worker_id,
                               burn_rate=round(burn, 3),
                               peer_max=round(peer_max, 3),
                               factor=self.burn_factor,
                               reason="slo_burn")
                _log.warning(
                    "fabric %r: tenant %r re-placed %s -> %s (burn "
                    "%.2f vs hottest peer %.2f)", self.name, t, src,
                    nw.worker_id, burn, peer_max)
            break  # at most one move per pass: observe, then re-judge

    # -- health-gated admission -------------------------------------------
    def _probe_worker(self, w: FabricWorker,
                      timeout: float = 30.0) -> bool:
        """A tiny known-answer query through the worker's OWN scheduler,
        on the default device, gates admission: a worker that cannot add
        1.0 to four floats must not be handed tenants."""
        from ..api import frame as _frame
        try:
            f = _frame({"x": np.arange(4.0)}, num_partitions=1)
            sq = w.scheduler.submit(f, lambda x: {"y": x + 1.0},
                                    tenant="_probe")
            out = sq.result(timeout=timeout)
            got = out.blocks()[0].columns["y"]
            got = np.asarray(got.cpu() if hasattr(got, "cpu") else got)
            if not np.array_equal(got, np.arange(4.0) + 1.0):
                raise RuntimeError(f"probe returned {got!r}")
        except Exception as e:
            counters.inc("fabric.admit_probe_failures")
            _flight.record("fabric.admit_probe_failed",
                           worker=w.worker_id, epoch=w.epoch,
                           error=str(e)[:200])
            _log.error("fabric %r: worker %s failed its admission "
                       "probe: %s", self.name, w.worker_id, e)
            w.alive = False
            return False
        _flight.record("fabric.admit", worker=w.worker_id,
                       epoch=w.epoch)
        return True

    # -- rolling restarts --------------------------------------------------
    def restart_worker(self, index: int, timeout: float = 30.0) -> bool:
        """Drain, kill, and re-admit one worker at the next epoch.
        Running queries park (checkpoints persist) and migrate; the
        in-memory result cache dies with the process and comes back
        warm from the durable tier. Returns True when the fresh worker
        passed its admission probe."""
        with self._lock:
            if not self._open:
                raise RuntimeError(f"fabric {self.name!r} is closed")
            w = self._workers[index]
            w.alive = False
            w.restarting = True
        counters.inc("fabric.worker_restarts")
        _flight.record("fabric.worker_restart", worker=w.worker_id,
                       epoch=w.epoch, next_epoch=w.epoch + 1)
        _log.info("fabric %r: rolling restart of %s (epoch %d -> %d)",
                  self.name, w.worker_id, w.epoch, w.epoch + 1)
        try:
            w.scheduler.request_park_all("rolling restart")
            w.scheduler.close(timeout=timeout)
        except Exception as e:
            _log.warning("restart of %s: close failed: %s",
                         w.worker_id, e)
        from ..plan import adaptive as _adaptive
        _adaptive.invalidate_results()  # the old process's memory
        with self._lock:
            victims = [fq for fq in self._queries.values()
                       if fq.worker_index == index and not fq.done()]
        for fq in victims:
            self._redispatch(fq, reason="restart")
        w.epoch += 1
        w.scheduler = self._new_scheduler(index, w.epoch)
        w.alive = True
        w.lost = False
        w.missed = 0
        w.fault_pending = False
        w.lease_at = time.monotonic()
        w.started_at = time.monotonic()
        try:
            return self._probe_worker(w, timeout=timeout) \
                if self.enabled else True
        finally:
            w.restarting = False

    def rolling_restart(self, timeout: float = 30.0) -> int:
        """Restart every worker in sequence (the fleet never empties
        with >= 2 workers). Returns how many came back healthy."""
        with self._lock:
            indices = [w.index for w in self._workers if not w.lost]
        ok = 0
        for i in indices:
            if self.restart_worker(i, timeout=timeout):
                ok += 1
            self.tick()
        return ok

    # -- introspection -----------------------------------------------------
    def health_snapshot(self) -> Dict[str, Any]:
        """The ``ttf.health()`` fabric section: workers live/lost,
        leases, per-worker tenant counts, durable-tier bytes."""
        now = time.monotonic()
        with self._lock:
            per_worker = []
            for w in self._workers:
                try:
                    snap = w.scheduler.snapshot() \
                        if w.scheduler._open else {}
                except Exception:
                    snap = {}
                per_worker.append({
                    "worker": w.worker_id,
                    "epoch": w.epoch,
                    "alive": w.alive,
                    "lost": w.lost,
                    "missed_heartbeats": w.missed,
                    "lease_age_s": round(now - w.lease_at, 3),
                    "tenants": self._tenant_count_locked(w.index),
                    "queued": sum(v.get("queued", 0)
                                  for v in snap.values()),
                    "inflight": sum(v.get("inflight", 0)
                                    for v in snap.values()),
                })
            placement = {t: f"w{i}"
                         for t, i in sorted(self._placement.items())}
            queries = len(self._queries)
            done = sum(1 for fq in self._queries.values()
                       if fq.done())
        return {
            "running": self._open,
            "enabled": self.enabled,
            "name": self.name,
            "workers": len(per_worker),
            "live": sum(1 for p in per_worker
                        if p["alive"] and not p["lost"]),
            "lost": sum(1 for p in per_worker if p["lost"]),
            "heartbeat_ms": self.heartbeat_ms,
            "missed_hb_limit": self.missed_hb,
            "per_worker": per_worker,
            "placement": placement,
            "queries": {"total": queries, "done": done,
                        "inflight": queries - done},
            "persist": _persist.stats(),
            "history": _history.stats(),
        }

    def audit_invariants(self, point: str = "inline") -> List[str]:
        """Fabric no-orphan accounting (the built-in fabric auditor,
        ``resilience/invariants.py``): every live fabric query is
        placing, attached to a real worker, or done; placements point
        at real workers; nothing is left unresolved once the fabric
        closes (a non-done query after close is a future no tick will
        ever settle)."""
        out: List[str] = []
        with self._lock:
            n = len(self._workers)
            for fq in self._queries.values():
                wi = fq.worker_index
                if wi is not None and not 0 <= wi < n:
                    out.append(f"fabric {self.name!r}: query "
                               f"{fq.query_id} placed on worker index "
                               f"{wi} of {n}")
                if not fq.done() and not self._open:
                    out.append(f"fabric {self.name!r}: query "
                               f"{fq.query_id} ({fq.state}) orphaned "
                               f"at {point} — no tick will settle it")
            for tenant, wi in self._placement.items():
                if not 0 <= wi < n:
                    out.append(f"fabric {self.name!r}: tenant "
                               f"{tenant!r} placed on worker index "
                               f"{wi} of {n}")
        return out

    def placement_report(self) -> str:
        """The ``serve_report()`` placement table."""
        snap = self.health_snapshot()
        lines = [f"fabric {self.name!r}: {snap['live']}/{snap['workers']}"
                 f" worker(s) live, {snap['lost']} lost",
                 f"{'worker':<8} {'epoch':>5} {'state':<6} "
                 f"{'tenants':>7} {'queued':>6} {'inflight':>8}"]
        for p in snap["per_worker"]:
            state = ("lost" if p["lost"]
                     else "live" if p["alive"] else "down")
            lines.append(f"{p['worker']:<8} {p['epoch']:>5} "
                         f"{state:<6} {p['tenants']:>7} "
                         f"{p['queued']:>6} {p['inflight']:>8}")
        if snap["placement"]:
            lines.append("placement: " + ", ".join(
                f"{t}->{w}" for t, w in snap["placement"].items()))
        ps = snap["persist"]
        if ps.get("enabled"):
            lines.append(
                f"persist: {ps['checkpoints']} checkpoint(s) "
                f"({ps['checkpoint_bytes']} B), {ps['results']} "
                f"result(s) ({ps['result_bytes']} B) at {ps['dir']}")
        hs = snap.get("history") or {}
        if hs.get("enabled"):
            lines.append(
                f"history: {hs['segments']} segment(s) "
                f"({hs['bytes']} B) at {hs['dir']}, "
                f"{hs['records_written']} record(s) this process")
        return "\n".join(lines)

    def __repr__(self):
        state = "open" if self._open else "closed"
        return (f"ServeFabric({self.name!r}, {state}, "
                f"workers={len(self._workers)})")
