"""The device-memory budget ledger: admission, LRU spill, fault-back.

The port's counterpart of ``tensorframes_tpu/memory/manager.py``. The
engine finds out about device-memory pressure the hard way otherwise: the
allocator fails with a ``torch.cuda.OutOfMemoryError``, and the block is
re-dispatched as two halves (``engine/executor.py``, the *reactive*
``oom_split`` path). This module is the subsystem that acts **before**
the allocator fails:

- a **budget**: ``TFT_MEM_LIMIT_BYTES`` when set (the deterministic
  CPU-testing knob), else the card's allocator limit
  (``observability.device.watermark(default_device())['limit_bytes']``:
  its total memory times the process's
  ``torch.cuda.set_per_process_memory_fraction``) scaled by
  ``TFT_MEM_FRACTION`` (default 0.85); neither known (the CPU) means
  *unlimited* and every entry point collapses to one attribute check;
- a **ledger** of device-resident bytes: transient dispatch
  reservations (reserved at executor submit, released at drain) plus
  registered *resident* spillables (a distributed frame's columns, a
  pipelined block's not-yet-drained device output) in LRU order;
- **admission**: every block dispatch reserves its estimated footprint
  against the budget; under pressure the ledger spills the coldest
  resident entries to pinned host buffers first (``memory.spills``),
  then waits (bounded) for in-flight reservations to drain, and only
  then — loudly — overshoots (``memory.overflow_admissions``), because
  a soft ledger must degrade to the pre-ledger behavior rather than
  fail work the allocator might still manage;
- **fault-back**: touching a spilled resident restores it to the
  device bit-identically (``memory.faults``) after making room.

The *proactive* split lives in the executor: when an admission estimate
alone exceeds the whole budget and the computation is row-local, the
block splits **before** dispatch (``memory.proactive_splits``) —
counted separately from the reactive ``oom_split`` path it replaces.

Thread model: one re-entrant lock guards the ledger; spill and fault
run under it (a spill performs a device-to-host copy and waits for it,
so a concurrent admission waits: latency, never a cycle, since the
device work it waits on completes independently).

A spill hands its tensors back to PyTorch's caching allocator (no
``cudaFree``): the freed bytes are reused by the next allocations of the
same process, which is what the budget counts.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, Iterator, Optional

from ..observability import flight as _flight
from ..observability.events import add_event as _obs_event
from ..resilience import check_deadline, env_bool, env_float, env_int
from ..utils.logging import get_logger
from ..utils.tracing import counters

__all__ = ["MemoryManager", "DEFAULT_FRACTION", "DEFAULT_SORT_FRACTION"]

_log = get_logger("memory.manager")

# fraction of the card's allocator limit the ledger budgets when
# TFT_MEM_LIMIT_BYTES is not set (headroom for the programs' own scratch)
DEFAULT_FRACTION = 0.85
# fraction of the budget above which a resident structure goes out of
# core: a join's build table is probed in chunks above it (and the
# external sort of the parallel layer will take it too)
DEFAULT_SORT_FRACTION = 0.5


class MemoryManager:
    """Budget ledger over device-resident bytes (module docstring).

    Resident entries are duck-typed spillables implementing
    ``mem_name() / mem_device_bytes() / mem_host_bytes() /
    mem_is_spilled() / mem_spill() -> freed / mem_fault() -> restored``
    (:mod:`~.spill` provides the stock implementations). The ledger
    holds them **weakly**: an entry dies with its owner (a collected
    frame releases its bytes with no unregister call), and the spilled
    host copy lives on the entry itself, so dropping the owner drops
    the host copy too.
    """

    def __init__(self, limit_bytes: Optional[int] = None,
                 spill: Optional[bool] = None):
        if limit_bytes is None:
            limit_bytes = env_int("TFT_MEM_LIMIT_BYTES", 0)
            if limit_bytes <= 0:
                limit_bytes = self._device_budget() or 0
        self.limit: Optional[int] = (int(limit_bytes)
                                     if limit_bytes and limit_bytes > 0
                                     else None)
        self.spill_enabled = (bool(spill) if spill is not None
                              else env_bool("TFT_MEM_SPILL", True))
        self._lock = threading.RLock()
        self._inflight = 0  # reserved transient dispatch bytes
        # LRU of resident spillables: id(obj) -> weakref (oldest first)
        self._resident: "OrderedDict[int, weakref.ref]" = OrderedDict()
        # host-side bookkeeping: frames whose forced block cache is live
        self._frame_caches: "weakref.WeakSet" = weakref.WeakSet()

    # -- budget ------------------------------------------------------------
    @staticmethod
    def _device_budget() -> Optional[int]:
        """The default device's allocator limit x ``TFT_MEM_FRACTION``, or
        None when it reports no memory statistics (the CPU, or a card the
        process has not touched yet)."""
        try:
            from ..device import default_device
            from ..observability import device as _obs_device
            wm = _obs_device.watermark(default_device())
        except Exception as e:  # a failed probe means no enforceable budget
            _log.debug("device budget probe failed: %s", e)
            return None
        if not wm or not wm.get("limit_bytes"):
            return None
        frac = env_float("TFT_MEM_FRACTION", DEFAULT_FRACTION)
        return int(wm["limit_bytes"] * frac)

    @property
    def limited(self) -> bool:
        return self.limit is not None

    def would_overflow(self, nbytes: int) -> bool:
        """True when ``nbytes`` cannot fit even with everything else
        spilled and drained — the caller should split before dispatch."""
        return self.limit is not None and nbytes > self.limit

    def external_sort_threshold(self) -> Optional[int]:
        """Size above which a resident structure goes out of core (None =
        never): a join build over it is probed in chunks."""
        if self.limit is None:
            return None
        frac = env_float("TFT_MEM_SORT_FRACTION", DEFAULT_SORT_FRACTION)
        return int(self.limit * frac)

    # -- resident spillables ----------------------------------------------
    def _live_locked(self) -> Iterator[Any]:
        """Live resident entries, LRU first; prunes dead weakrefs."""
        dead = []
        for key, ref in self._resident.items():
            obj = ref()
            if obj is None:
                dead.append(key)
            else:
                yield obj
        for key in dead:
            self._resident.pop(key, None)

    def _device_in_use_locked(self) -> int:
        used = self._inflight
        for obj in list(self._live_locked()):
            used += int(obj.mem_device_bytes())
        return used

    def register(self, obj) -> None:
        """Add a resident spillable (MRU); registering over-budget
        content immediately spills the coldest entries to fit."""
        if self.limit is None:
            return
        with self._lock:
            self._resident[id(obj)] = weakref.ref(obj)
            self._make_room_locked(0)

    def touch(self, obj) -> None:
        """Mark ``obj`` most-recently-used; fault it back if spilled."""
        if self.limit is None:
            return
        with self._lock:
            key = id(obj)
            if key in self._resident:
                self._resident.move_to_end(key)
            if obj.mem_is_spilled():
                self._fault_locked(obj)

    def drop(self, obj) -> None:
        """Forget a resident entry (its bytes are the owner's problem
        again — e.g. a drained pipeline block)."""
        if self.limit is None:
            return
        with self._lock:
            self._resident.pop(id(obj), None)

    def _spill_locked(self, obj) -> int:
        name = obj.mem_name()
        try:
            freed = int(obj.mem_spill())
        except Exception as e:
            # a spillable that cannot spill must not wedge admission:
            # unregister it and move on (its bytes stay counted against
            # nothing — the owner still holds them)
            _log.warning("spill of %s failed (%s); dropping it from the "
                         "ledger", name, e)
            self._resident.pop(id(obj), None)
            return 0
        if freed:
            counters.inc("memory.spills")
            counters.inc("memory.spill_bytes", freed)
            _obs_event("spill", name=name, bytes=freed)
            _flight.record("memory.spill", name=name, bytes=freed,
                           limit=self.limit)
            _log.debug("spilled %s (%d B) to host", name, freed)
        return freed

    def _fault_locked(self, obj) -> int:
        self._make_room_locked(int(obj.mem_host_bytes()), exclude=obj)
        restored = int(obj.mem_fault())
        if restored:
            counters.inc("memory.faults")
            counters.inc("memory.fault_bytes", restored)
            _obs_event("fault", name=obj.mem_name(), bytes=restored)
            _flight.record("memory.fault", name=obj.mem_name(),
                           bytes=restored)
            _log.debug("faulted %s (%d B) back to device",
                       obj.mem_name(), restored)
        return restored

    def _make_room_locked(self, extra: int, exclude=None) -> bool:
        if self.limit is None:
            return True
        while self._device_in_use_locked() + extra > self.limit:
            victim = None
            if self.spill_enabled:
                for obj in self._live_locked():
                    if (obj is not exclude and not obj.mem_is_spilled()
                            and obj.mem_device_bytes() > 0):
                        victim = obj
                        break
            if victim is None:
                return False
            self._spill_locked(victim)
        return True

    def make_room(self, nbytes: int, exclude=None) -> bool:
        """Best-effort: spill cold residents until ``nbytes`` of budget
        headroom exists (used before a large host->device copy)."""
        if self.limit is None:
            return True
        with self._lock:
            return self._make_room_locked(int(nbytes), exclude=exclude)

    # -- out-of-ledger spill accounting (checkpoints) ------------------------
    def note_spill(self, nbytes: int, name: str) -> None:
        counters.inc("memory.spills")
        counters.inc("memory.spill_bytes", int(nbytes))
        _obs_event("spill", name=name, bytes=int(nbytes))
        _flight.record("memory.spill", name=name, bytes=int(nbytes),
                       limit=self.limit)

    def note_fault(self, nbytes: int, name: str) -> None:
        counters.inc("memory.faults")
        counters.inc("memory.fault_bytes", int(nbytes))
        _obs_event("fault", name=name, bytes=int(nbytes))
        _flight.record("memory.fault", name=name, bytes=int(nbytes))

    # -- admission ---------------------------------------------------------
    def try_reserve(self, nbytes: int, op: str = "dispatch"
                    ) -> Optional[int]:
        """Non-blocking admission: spill cold residents to make room and
        reserve, or return ``None`` under pressure (the async submit
        path then falls back to the synchronous admitted run)."""
        if self.limit is None:
            return 0
        nbytes = int(nbytes)
        with self._lock:
            if self._make_room_locked(nbytes):
                self._inflight += nbytes
                return nbytes
        return None

    def reserve(self, nbytes: int, op: str = "dispatch") -> int:
        """Blocking-but-bounded admission; never fails.

        Spills cold residents first; waits up to ``TFT_MEM_ADMIT_WAIT_S``
        (honoring the ambient resilience deadline) for in-flight
        reservations to drain; then admits OVER budget with a warning
        (``memory.overflow_admissions``) — a soft ledger must degrade to
        the pre-ledger behavior, not fail work the allocator might still
        manage. Returns the token to pass to :meth:`release`."""
        if self.limit is None:
            return 0
        nbytes = int(nbytes)
        if self.would_overflow(nbytes):
            # mathematically unable to fit: waiting for drains cannot
            # help — spill what we can for the allocator's sake and
            # overflow-admit immediately instead of stalling the full
            # wait budget on every such dispatch
            with self._lock:
                self._make_room_locked(0)
                self._inflight += nbytes
            counters.inc("memory.overflow_admissions")
            _flight.record("memory.overflow_admit", op=op, bytes=nbytes,
                           limit=self.limit, cause="request > budget")
            _log.warning(
                "admitting %d B for %s OVER the %d B device budget (the "
                "request alone exceeds it); split the input into "
                "smaller blocks to stay within budget", nbytes, op,
                self.limit)
            return nbytes
        tok = self.try_reserve(nbytes, op)
        if tok is not None:
            return tok
        counters.inc("memory.admission_waits")
        _obs_event("mem_wait", name=op, bytes=nbytes)
        _flight.record("memory.wait", op=op, bytes=nbytes,
                       limit=self.limit)
        budget = env_float("TFT_MEM_ADMIT_WAIT_S", 5.0)
        give_up = time.monotonic() + max(budget, 0.0)
        while time.monotonic() < give_up:
            check_deadline("memory.admit")
            time.sleep(0.002)
            tok = self.try_reserve(nbytes, op)
            if tok is not None:
                return tok
        counters.inc("memory.overflow_admissions")
        _flight.record("memory.overflow_admit", op=op, bytes=nbytes,
                       limit=self.limit,
                       cause=f"wait budget {budget:g}s exhausted")
        _log.warning(
            "admitting %d B for %s OVER the %d B device budget (nothing "
            "left to spill and in-flight work did not drain within "
            "%.1fs); the allocator may still manage — split the input "
            "into smaller blocks to stay within budget", nbytes, op,
            self.limit, budget)
        with self._lock:
            self._inflight += nbytes
        return nbytes

    def release(self, token: int) -> None:
        if token:
            with self._lock:
                self._inflight -= token

    def convert_reservation(self, token: int, obj) -> None:
        """Turn a dispatch reservation into a resident entry: the
        pipelined submit path registers its pending block as a spill
        candidate (its device output can be drained to host early)."""
        with self._lock:
            self._inflight -= token
            self._resident[id(obj)] = weakref.ref(obj)

    # -- introspection -----------------------------------------------------
    def headroom(self, fraction: float = 1.0) -> Optional[int]:
        """Bytes below ``limit * fraction``; spillable resident bytes
        count as reclaimable (admission can spill them). ``None`` when
        unlimited."""
        if self.limit is None:
            return None
        with self._lock:
            used = self._inflight
            if not self.spill_enabled:
                for obj in list(self._live_locked()):
                    used += int(obj.mem_device_bytes())
            return int(self.limit * fraction) - used

    def note_frame_cache(self, frame) -> None:
        self._frame_caches.add(frame)

    def forget_frame_cache(self, frame) -> None:
        self._frame_caches.discard(frame)

    def frame_cache_bytes(self) -> int:
        from .estimate import blocks_estimate
        total = 0
        for f in list(self._frame_caches):
            blocks = getattr(f, "_cache", None)
            if blocks:
                total += blocks_estimate(blocks)[1]
        return total

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            resident = spilled = resident_n = spilled_n = 0
            for obj in list(self._live_locked()):
                resident_n += 1
                resident += int(obj.mem_device_bytes())
                if obj.mem_is_spilled():
                    spilled_n += 1
                    spilled += int(obj.mem_host_bytes())
            return {"limit_bytes": self.limit or 0,
                    "inflight_bytes": self._inflight,
                    "resident_bytes": resident,
                    "resident_buffers": resident_n,
                    "spilled_bytes": spilled,
                    "spilled_buffers": spilled_n}

    def audit(self) -> list:
        """Ledger-balance + spillable-registry consistency check. Returns
        violation messages: a negative in-flight reservation balance
        means a double release; a resident entry whose spilled flag
        disagrees with its byte accounting (device bytes while spilled,
        host bytes while resident) means the registry and the spillable
        have diverged — the fault-back path would restore from the
        wrong side."""
        out = []
        with self._lock:
            if self._inflight < 0:
                out.append(f"memory ledger in-flight reservations went "
                           f"negative ({self._inflight} B): a "
                           f"reservation released twice")
            for obj in list(self._live_locked()):
                name = obj.mem_name()
                spilled = obj.mem_is_spilled()
                dev = int(obj.mem_device_bytes())
                host = int(obj.mem_host_bytes())
                if spilled and dev > 0:
                    out.append(f"spillable {name!r} is marked spilled "
                               f"but still counts {dev} device bytes")
                if not spilled and host > 0:
                    out.append(f"spillable {name!r} is marked resident "
                               f"but still counts {host} host bytes")
        return out

    def __repr__(self):
        lim = "unlimited" if self.limit is None else f"{self.limit} B"
        return (f"MemoryManager(limit={lim}, "
                f"spill={'on' if self.spill_enabled else 'off'})")
