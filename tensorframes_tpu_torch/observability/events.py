"""Query-scoped structured events: the correlation layer over tracing.

The port's counterpart of ``tensorframes_tpu/observability/events.py``.
The flat ``span``/``counters`` registry (:mod:`..utils.tracing`) says how
long ``executor.dispatch`` took process-wide; this module says which
query's block ran out of memory and where its time went:

- every public forcing opens a :class:`QueryTrace` with a unique query id
  (``q<N>``) through :func:`query_trace` (``TensorFrame.blocks``, and the
  eager ops through :func:`traced_query`);
- the trace rides a :mod:`contextvars` variable, so any layer (engine,
  pipeline, resilience) attaches typed events with :func:`add_event`, and
  :func:`wrap_context` carries it onto a worker thread;
- while a trace is open, the flight recorder's query scope is the trace's
  id, unless a scope is already ambient, so the decisions recorded inside
  (``engine.oom_split``, ``plan.oom_fallback``, ``resilience.giveup``)
  correlate to it (the JAX package reads ``flight.for_query`` with the
  trace's id at the end of a query but never scopes by it);
- finished traces land in a bounded process-wide ring
  (:func:`recent_events`) and, with ``TFT_TRACE_FILE`` set, in a JSONL
  file; :meth:`QueryTrace.to_chrome_trace` exports a chrome://tracing /
  Perfetto timeline with one track per in-flight pipeline slot;
- ``TFT_SLOW_QUERY_MS`` writes one condensed line for a query over the
  threshold, traced or not, with the performance sentinel's cost context
  (``baseline.slow_context``) when the query is served;
- a finished trace is archived in the durable query history
  (``observability/history.py``), unless it is a served query, which the
  scheduler archives itself; :meth:`QueryTrace.report` renders it
  (``observability/report.py``).

Zero cost when off: :func:`query_trace` yields ``None`` unless tracing is
enabled (``TFT_TRACE=1`` / :func:`~..utils.tracing.enable`), and every
hook is then a ``None`` check.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple)

from ..utils import tracing
from ..utils.env import env_int
from ..utils.logging import get_logger
from . import flight as _flight

__all__ = ["Event", "QueryTrace", "query_trace", "current_trace",
           "add_event", "wrap_context", "traced_query", "last_query",
           "recent_events", "clear_ring", "block_meta", "bypass",
           "DEVICE_TRACK_BASE"]

_log = get_logger("observability.events")

# chrome-trace track (tid) namespace: 0 = query, 1..depth = pipeline
# slots, DEVICE_TRACK_BASE+i = card i (its memory samples). Far above any
# realistic pipeline depth, so the two namespaces can never collide.
DEVICE_TRACK_BASE = 1000


_qid_counter = itertools.count(1)
_current: "contextvars.ContextVar[Optional[QueryTrace]]" = \
    contextvars.ContextVar("tft_query_trace", default=None)
# tracing-off slow-query timer nesting guard: nested forcings must join
# the ambient (outermost) timed query exactly like traced queries join
# the ambient trace — without this, one API call logs one slow line per
# upstream frame it forces
_slow_active: "contextvars.ContextVar[bool]" = \
    contextvars.ContextVar("tft_slow_query_active", default=False)

# benchmark hook: strips the event layer entirely (even the enabled()
# check), to measure the disabled layer's residual cost
_bypass = False

_last_lock = threading.Lock()
_last_query: Optional["QueryTrace"] = None

_ring_lock = threading.Lock()
_ring: "deque[Dict[str, Any]]" = deque(
    maxlen=env_int("TFT_TRACE_RING", 8192))


class Event:
    """One typed trace event.

    ``ts``/``dur`` are seconds relative to the owning trace's start;
    ``track`` selects the chrome-trace row (0 = query-level, ``slot+1``
    for per-pipeline-slot block events); ``args`` carries the typed
    payload (block index, rows, bytes, error class, ...).
    """

    __slots__ = ("etype", "name", "ts", "dur", "track", "args")

    def __init__(self, etype: str, name: Optional[str], ts: float,
                 dur: Optional[float] = None, track: int = 0,
                 args: Optional[Dict[str, Any]] = None):
        self.etype = etype
        self.name = name
        self.ts = ts
        self.dur = dur
        self.track = track
        self.args = args

    def as_dict(self, query_id: Optional[str] = None) -> Dict[str, Any]:
        d: Dict[str, Any] = {"type": self.etype, "ts": self.ts,
                             "track": self.track}
        if query_id is not None:
            d["query_id"] = query_id
        if self.name is not None:
            d["name"] = self.name
        if self.dur is not None:
            d["dur"] = self.dur
        if self.args:
            d.update(self.args)
        return d

    def __repr__(self):
        return (f"Event({self.etype!r}, name={self.name!r}, "
                f"ts={self.ts:.6f}, dur={self.dur}, track={self.track}, "
                f"args={self.args!r})")


class QueryTrace:
    """All events of one public-API query, under one correlation id.

    Thread-safe: worker threads append through the contextvar carried by
    :func:`wrap_context`. The event list is bounded
    (``TFT_TRACE_MAX_EVENTS``, default 50k) — overflow increments
    ``dropped`` instead of growing without bound.
    """

    def __init__(self, op: str, meta: Optional[Dict[str, Any]] = None,
                 max_events: Optional[int] = None):
        self.query_id = f"q{next(_qid_counter)}"
        self.op = op
        self.meta = dict(meta or {})
        self.start_time = time.time()
        self._t0 = time.perf_counter()
        self.duration: Optional[float] = None
        self.events: List[Event] = []
        self.dropped = 0
        # per-query span attribution: name -> [count, total_seconds]
        self.stages: Dict[str, List[float]] = {}
        # events left to record once the card has done their work (a
        # traced mesh dispatch's shard times): each returns True once added
        self._deferred: List[Callable[[], bool]] = []
        self._lock = threading.Lock()
        self._max_events = (max_events if max_events is not None
                            else env_int("TFT_TRACE_MAX_EVENTS", 50_000))

    # -- recording ---------------------------------------------------------
    def clock(self) -> float:
        """Seconds since this trace opened (the event timebase)."""
        return time.perf_counter() - self._t0

    def add(self, etype: str, name: Optional[str] = None,
            ts: Optional[float] = None, dur: Optional[float] = None,
            track: int = 0, **args) -> Optional[Event]:
        if ts is None:
            ts = self.clock()
        ev = Event(etype, name, ts, dur, track, args or None)
        with self._lock:
            if len(self.events) >= self._max_events:
                self.dropped += 1
                return None
            self.events.append(ev)
        return ev

    def defer(self, settle: Callable[[], bool]) -> None:
        """Register events that can be read only later: ``settle()`` adds
        them, without a wait, and returns True once it has. The trace calls
        it when it finishes or is read (:meth:`settle`)."""
        with self._lock:
            self._deferred.append(settle)

    def settle(self) -> None:
        """Add the deferred events whose work has completed; the others
        stay deferred. Never waits."""
        if not self._deferred:
            return
        with self._lock:
            todo, self._deferred = self._deferred, []
        left = [fn for fn in todo if not fn()]
        if left:
            with self._lock:
                self._deferred[:0] = left

    def add_stage(self, name: str, dt: float) -> None:
        with self._lock:
            st = self.stages.get(name)
            if st is None:
                self.stages[name] = [1, dt]
            else:
                st[0] += 1
                st[1] += dt

    def _finish(self, error: Optional[str] = None) -> None:
        self.settle()
        try:  # the card's memory watermark at query end (None on CPU)
            from ..device import default_device
            from . import device as _device
            _device.sample(self, "query_end", per_device=True,
                           device=default_device())
        except Exception as e:
            _log.debug("query-end memory sample failed: %s", e)
        self.duration = self.clock()
        if error is not None:
            # a failed query must stay distinguishable from a slow
            # success — in the latency histogram (its own series), the
            # slow-query log, and the exported trace/meta
            self.meta["error"] = error
        tracing.counters.inc("trace.queries")
        tracing.histograms.observe("query_latency_seconds", self.duration,
                                   op=self.op,
                                   outcome="error" if error else "ok")
        if self.dropped:
            tracing.counters.inc("trace.events_dropped", self.dropped)
        with self._lock:
            dicts = [ev.as_dict(self.query_id) for ev in self.events]
        with _ring_lock:
            _ring.extend(dicts)
        global _last_query
        with _last_lock:
            _last_query = self
        path = os.environ.get("TFT_TRACE_FILE")
        if path:
            self._write_jsonl(path, dicts)
        # durable query history: traced forcings archive too; a served
        # query's trace is skipped, as the scheduler archives its own
        # richer record under the serving id
        if self.op != "serve":
            from . import history as _history
            _history.record_finish(
                self.query_id, outcome="error" if error else "ok",
                error=error, run_s=self.duration,
                total_s=self.duration, source="trace",
                summary=self.op,
                decisions=_flight.for_query(self.query_id))
        ms = _slow_query_threshold_ms()
        if ms is not None and self.duration * 1000.0 >= ms:
            s = self.summary()
            rec = {"type": "slow_query", "query_id": self.query_id,
                   "op": self.op,
                   "duration_ms": round(self.duration * 1000.0, 3),
                   "blocks": s["blocks"], "retries": s["retries"],
                   "oom_splits": s["oom_splits"],
                   "sync_fallbacks": s["sync_fallbacks"]}
            if error is not None:
                rec["error"] = error
            if s["hbm"] is not None:
                rec["peak_hbm_bytes"] = s["hbm"]["peak"]
            _emit_slow(rec)

    def _write_jsonl(self, path: str, dicts: List[Dict[str, Any]]) -> None:
        head = {"type": "query", "query_id": self.query_id, "op": self.op,
                "start_time": self.start_time, "duration": self.duration,
                "dropped": self.dropped, **self.meta}
        lines = [json.dumps(head, default=str)]
        lines.extend(json.dumps(d, default=str) for d in dicts)
        try:
            # the shared size-capped sink (TFT_TRACE_FILE_MAX_BYTES,
            # keep-1 rollover to <path>.1) — a long-running
            # process must not grow the trace file without bound
            _flight.append_jsonl(path, lines)
        except OSError as e:
            _log.warning("TFT_TRACE_FILE=%s write failed: %s", path, e)

    # -- introspection -----------------------------------------------------
    def count(self, etype: str) -> int:
        self.settle()
        with self._lock:
            return sum(1 for ev in self.events if ev.etype == etype)

    def summary(self) -> Dict[str, Any]:
        """Aggregate the event stream into the per-query totals
        ``explain()`` renders (blocks, rows, bytes, retries, fallbacks,
        pipeline occupancy, per-device mesh times with a straggler ratio,
        mesh shrinks, grows and rebalances, spills, preemption and the
        card's memory watermarks)."""
        s: Dict[str, Any] = {
            "query_id": self.query_id, "op": self.op,
            "duration_s": self.duration if self.duration is not None
            else self.clock(),
            "blocks": 0, "rows_in": 0, "rows_out": 0, "bytes_in": 0,
            "retries": 0, "giveups": 0, "oom_splits": 0,
            "pad_fallbacks": 0, "sync_fallbacks": 0,
            "compile_hits": 0, "compile_misses": 0,
            "compile_seconds": 0.0, "dispatches": 0,
            "mesh_dispatches": 0, "collectives": 0,
            "mesh_shrinks": 0, "rebalances": 0,
            "mesh_grows": 0, "preempts": 0, "resumed_blocks": 0,
            "spills": 0, "spill_bytes": 0, "faults": 0,
            "proactive_splits": 0, "external_sort_runs": 0,
            "events": 0, "dropped": self.dropped,
            "occupancy_mean": None, "slots": 0,
            "mesh": None, "hbm": None,
        }
        self.settle()
        occ_total = 0.0
        occ_n = 0
        slots = set()
        # per-device accumulation: device -> [rows, bytes, time_s]
        devs: Dict[int, list] = {}
        hbm_live_start = hbm_live_end = hbm_peak = None
        with self._lock:
            events = list(self.events)
        for ev in events:
            a = ev.args or {}
            if ev.etype in ("block_submit", "block_run"):
                s["blocks"] += 1
                s["rows_in"] += int(a.get("rows") or 0)
                s["bytes_in"] += int(a.get("bytes") or 0)
                if ev.track > 0:
                    slots.add(ev.track)
            if ev.etype in ("block_drain", "block_run"):
                s["rows_out"] += int(a.get("rows_out") or 0)
            elif ev.etype == "retry":
                s["retries"] += 1
            elif ev.etype == "giveup":
                s["giveups"] += 1
            elif ev.etype == "oom_split":
                s["oom_splits"] += 1
            elif ev.etype == "pad_fallback":
                s["pad_fallbacks"] += 1
            elif ev.etype == "sync_fallback":
                s["sync_fallbacks"] += 1
            elif ev.etype == "compile_cache":
                if a.get("hit"):
                    s["compile_hits"] += 1
                else:
                    s["compile_misses"] += 1
            elif ev.etype == "compile":
                s["compile_seconds"] += float(ev.dur or 0.0)
            elif ev.etype == "dispatch":
                s["dispatches"] += 1
            elif ev.etype == "mesh_dispatch":
                s["mesh_dispatches"] += 1
            elif ev.etype == "collective":
                s["collectives"] += 1
            elif ev.etype == "mesh_shrink":
                s["mesh_shrinks"] += 1
            elif ev.etype == "mesh_grow":
                s["mesh_grows"] += 1
            elif ev.etype == "preempt_park":
                s["preempts"] += 1
            elif ev.etype == "resume":
                s["resumed_blocks"] += int(a.get("blocks") or 0)
            elif ev.etype == "rebalance":
                s["rebalances"] += 1
            elif ev.etype == "spill":
                s["spills"] += 1
                s["spill_bytes"] += int(a.get("bytes") or 0)
            elif ev.etype == "fault":
                s["faults"] += 1
            elif ev.etype == "proactive_split":
                s["proactive_splits"] += 1
            elif ev.etype == "external_sort":
                s["external_sort_runs"] += int(a.get("runs") or 0)
            elif ev.etype == "shard":
                d = a.get("device")
                if d is not None:
                    acc = devs.setdefault(int(d), [0, 0, 0.0])
                    acc[0] += int(a.get("rows") or 0)
                    acc[1] += int(a.get("bytes") or 0)
            elif ev.etype == "shard_compute":
                d = a.get("device")
                if d is not None:
                    acc = devs.setdefault(int(d), [0, 0, 0.0])
                    acc[2] += float(ev.dur or 0.0)
            elif ev.etype == "hbm_sample" and a.get("device") is None:
                live = int(a.get("live_bytes") or 0)
                peak = int(a.get("peak_bytes") or live)
                if hbm_live_start is None:
                    hbm_live_start = live
                hbm_live_end = live
                hbm_peak = max(hbm_peak or 0, peak, live)
            elif ev.etype == "occupancy":
                occ_total += float(a.get("value") or 0.0)
                occ_n += 1
        s["events"] = len(events)
        s["slots"] = len(slots)
        if occ_n:
            s["occupancy_mean"] = occ_total / occ_n
        if devs:
            times = [acc[2] for acc in devs.values() if acc[2] > 0.0]
            ratio = None
            if len(times) >= 2:
                import statistics
                med = statistics.median(times)
                if med > 0.0:
                    ratio = max(times) / med
            s["mesh"] = {
                "devices": {d: {"rows": acc[0], "bytes": acc[1],
                                "time_s": acc[2]}
                            for d, acc in sorted(devs.items())},
                "straggler_ratio": ratio,
            }
        if hbm_peak is not None:
            s["hbm"] = {"live_start": hbm_live_start,
                        "live_end": hbm_live_end, "peak": hbm_peak}
        return s

    def report(self) -> str:
        from .report import render
        return render(self)

    # -- chrome trace export ----------------------------------------------
    def to_chrome_trace(self, file: Optional[str] = None) -> str:
        """A chrome://tracing / Perfetto-loadable JSON timeline.

        One process per query; track (``tid``) 0 carries the query span
        and instantaneous events (retries, OOM splits, fallbacks), tracks
        1..depth are the in-flight pipeline slots with each block's
        submit/compute/drain phases, and tracks
        ``DEVICE_TRACK_BASE + i`` (named ``device i``) carry card i's
        memory samples. Returns the JSON string; ``file`` also writes it
        out.
        """
        pid = 1
        self.settle()
        with self._lock:
            events = list(self.events)
        out: List[Dict[str, Any]] = []
        tracks = {0}
        for ev in events:
            tracks.add(ev.track)
            rec: Dict[str, Any] = {
                "name": ev.name or ev.etype,
                "cat": ev.etype,
                "pid": pid,
                "tid": ev.track,
                "ts": round(ev.ts * 1e6, 3),
                "args": {"query_id": self.query_id, **(ev.args or {})},
            }
            if ev.dur is not None:
                rec["ph"] = "X"
                rec["dur"] = round(max(ev.dur, 0.0) * 1e6, 3)
            else:
                rec["ph"] = "i"
                rec["s"] = "t"
            out.append(rec)
        dur = self.duration if self.duration is not None else self.clock()
        out.append({"name": f"{self.op} [{self.query_id}]",
                    "cat": "query", "ph": "X", "pid": pid, "tid": 0,
                    "ts": 0.0, "dur": round(dur * 1e6, 3),
                    "args": {"query_id": self.query_id, **self.meta}})
        out.sort(key=lambda r: (r["ts"], r["tid"]))
        meta: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "ts": 0.0,
            "args": {"name": f"tensorframes_tpu_torch {self.query_id} "
                             f"({self.op})"}}]
        for tid in sorted(tracks):
            if tid == 0:
                tname = "query"
            elif tid >= DEVICE_TRACK_BASE:
                tname = f"device {tid - DEVICE_TRACK_BASE}"
            else:
                tname = f"slot {tid - 1}"
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "ts": 0.0,
                         "args": {"name": tname}})
        doc = {"traceEvents": meta + out, "displayTimeUnit": "ms",
               "otherData": {"query_id": self.query_id, "op": self.op,
                             "start_time": self.start_time}}
        text = json.dumps(doc, default=str)
        if file:
            with open(file, "w") as f:
                f.write(text)
        return text

    def __repr__(self):
        return (f"QueryTrace({self.query_id}, op={self.op!r}, "
                f"events={len(self.events)}, "
                f"duration={self.duration})")


# ---------------------------------------------------------------------------
# context management
# ---------------------------------------------------------------------------

def current_trace() -> Optional[QueryTrace]:
    """The active :class:`QueryTrace`, or None (tracing off / no query)."""
    return _current.get()


_slow_malformed_warned = False


def _slow_query_threshold_ms() -> Optional[float]:
    """The ``TFT_SLOW_QUERY_MS`` threshold, or ``None`` when unset."""
    raw = os.environ.get("TFT_SLOW_QUERY_MS")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        global _slow_malformed_warned
        if not _slow_malformed_warned:
            _log.warning("ignoring malformed TFT_SLOW_QUERY_MS=%r", raw)
            _slow_malformed_warned = True
        return None


def _emit_slow(rec: Dict[str, Any]) -> None:
    """One condensed slow-query JSONL line: to the ``TFT_TRACE_FILE``
    sink when set (size-capped rotation shared with the trace writer),
    else the logger. A slow query also triggers a flight-recorder dump
    when ``TFT_FLIGHT_DUMP`` is set: the decisions that made it slow are
    in the ring right now."""
    try:
        # the sentinel's live cost preview: the in-flight cost vector, the
        # plan fingerprint and the worst deviation against the stored
        # baseline, so the line explains itself
        from . import baseline as _baseline
        ctx = _baseline.slow_context()
        if ctx is not None:
            rec = {**rec, **ctx}
    except Exception as e:
        _log.debug("slow-query cost context failed: %s", e)
    line = json.dumps(rec, default=str)
    _flight.maybe_dump("slow_query")
    path = os.environ.get("TFT_TRACE_FILE")
    if path:
        try:
            _flight.append_jsonl(path, [line])
            return
        except OSError as e:
            _log.warning("TFT_TRACE_FILE=%s write failed: %s", path, e)
    _log.warning("slow query: %s", line)


@contextlib.contextmanager
def query_trace(op: str, **meta) -> Iterator[Optional[QueryTrace]]:
    """Open a query-scoped trace around a public-API execution.

    Yields the new :class:`QueryTrace` — or ``None`` when tracing is
    disabled (zero-cost-when-off) or a trace is already active (nested
    API calls join the ambient query instead of fragmenting it; events
    they record attach to the outermost trace).

    ``TFT_SLOW_QUERY_MS``: top-level queries exceeding the threshold emit
    one condensed JSONL line even with full tracing OFF — the timing then
    is a bare ``perf_counter`` pair, no trace or events are allocated.
    """
    if _bypass:
        yield None
        return
    if not tracing.enabled() or _current.get() is not None:
        ms = _slow_query_threshold_ms()
        if ms is None or _current.get() is not None or _slow_active.get():
            yield None
            return
        token = _slow_active.set(True)
        t0 = time.perf_counter()
        err = None
        try:
            yield None
        except BaseException as e:
            err = type(e).__name__
            raise
        finally:
            _slow_active.reset(token)
            dur = time.perf_counter() - t0
            if dur * 1000.0 >= ms:
                rec = {"type": "slow_query", "op": op,
                       "duration_ms": round(dur * 1000.0, 3)}
                if err is not None:
                    rec["error"] = err
                _emit_slow(rec)
        return
    t = QueryTrace(op, meta)
    token = _current.set(t)
    # decisions recorded inside correlate to this trace unless a flight
    # scope is already ambient
    fscope = (_flight.scope(t.query_id) if _flight.current_query() is None
              else contextlib.nullcontext())
    fscope.__enter__()
    try:  # the card's memory watermark at query start (None on CPU)
        from ..device import default_device
        from . import device as _device
        _device.sample(t, "query_start", per_device=True,
                       device=default_device())
    except Exception as e:
        _log.debug("query-start memory sample failed: %s", e)
    err = None
    try:
        yield t
    except BaseException as e:
        err = type(e).__name__
        raise
    finally:
        fscope.__exit__(None, None, None)
        _current.reset(token)
        t._finish(error=err)


def add_event(etype: str, name: Optional[str] = None,
              dur: Optional[float] = None, track: int = 0,
              **args) -> None:
    """Attach a typed event to the active query trace (no-op without
    one). The cheap fire-and-forget hook every layer calls."""
    if _bypass:
        return
    t = _current.get()
    if t is not None:
        t.add(etype, name=name, dur=dur, track=track, **args)


def wrap_context(fn: Callable) -> Callable:
    """Bind ``fn`` to the CALLER's context so the query correlation id
    survives a hop onto a worker thread (``contextvars`` do not propagate
    into ``ThreadPoolExecutor`` tasks by themselves). Any executor that
    dispatches on its own threads should do the same."""
    ctx = contextvars.copy_context()

    def bound(*a, **k):
        return ctx.run(fn, *a, **k)

    return bound


def traced_query(op: str, meta_fn: Optional[Callable] = None):
    """Decorator form of :func:`query_trace` for eager API entry points
    (``reduce_blocks``, ``reduce_rows``, ``aggregate``).

    ``meta_fn(*args, **kwargs) -> dict`` extracts entry metadata from the
    call so traces are self-describing instead of bare op names. It runs ONLY when a
    trace actually opened (zero-cost-when-off) and is best-effort — a
    failure is logged, never raised into the query.
    """
    def deco(fn: Callable) -> Callable:
        import functools

        @functools.wraps(fn)
        def wrapper(*a, **k):
            with query_trace(op) as t:
                if t is not None and meta_fn is not None:
                    try:
                        t.meta.update(meta_fn(*a, **k) or {})
                    except Exception as e:
                        _log.debug("traced_query meta_fn for %s failed: "
                                   "%s", op, e)
                return fn(*a, **k)

        return wrapper

    return deco


def last_query() -> Optional[QueryTrace]:
    """The most recently finished :class:`QueryTrace` (any frame/op)."""
    with _last_lock:
        return _last_query


@contextlib.contextmanager
def bypass() -> Iterator[None]:
    """Short-circuit :func:`query_trace` and :func:`add_event` at their
    first check — the benchmark baseline for measuring what the
    (already disabled) event layer's hooks still cost on top of a bare
    flag test."""
    global _bypass
    was = _bypass
    _bypass = True
    try:
        yield
    finally:
        _bypass = was


# ---------------------------------------------------------------------------
# ring buffer sink
# ---------------------------------------------------------------------------

def recent_events() -> List[Dict[str, Any]]:
    """The bounded process-wide ring of recent events (across queries),
    oldest first. Size: ``TFT_TRACE_RING`` (default 8192)."""
    with _ring_lock:
        return list(_ring)


def clear_ring() -> None:
    """Drop buffered events and re-read ``TFT_TRACE_RING`` for the
    bound (tests flip it)."""
    global _ring
    with _ring_lock:
        _ring = deque(maxlen=env_int("TFT_TRACE_RING", 8192))


def _reset_last_query() -> None:
    global _last_query
    with _last_lock:
        _last_query = None


# ---------------------------------------------------------------------------
# helpers for instrumented layers
# ---------------------------------------------------------------------------

def block_meta(b) -> Tuple[Optional[int], int]:
    """Best-effort ``(rows, bytes)`` of a block-ish object: an engine
    ``Block`` (``num_rows`` + ``columns``) or a plain mapping of arrays
    or tensors.
    Only called with an active trace, so the introspection never costs
    the untraced path anything."""
    rows = getattr(b, "num_rows", None)
    cols = getattr(b, "columns", None)
    if cols is None and isinstance(b, Mapping):
        cols = b
    nbytes = 0
    if cols:
        for v in cols.values():
            nb = getattr(v, "nbytes", None)
            if nb is not None:
                nbytes += int(nb)
        if rows is None:
            try:
                rows = len(next(iter(cols.values())))
            except (TypeError, StopIteration):
                rows = None
    return rows, nbytes


def _on_span(name: str, dt: float) -> None:
    """Span observer (registered with utils.tracing at package import):
    credit every span to the active query's per-stage breakdown."""
    t = _current.get()
    if t is not None:
        t.add_stage(name, dt)
