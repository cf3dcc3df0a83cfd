"""Always-on flight recorder: a bounded ring of runtime *decisions*.

The port's counterpart of ``tensorframes_tpu/observability/flight.py``.
The engine makes calls of its own on a query (split a block that ran out
of device memory, give up on a retry, hand a fused plan back to the per-op
path); each is visible as a bare counter, and the ring keeps the inputs it
was decided from, after the fact and with ``TFT_TRACE`` off:

- :func:`record` is the one hook a layer calls at a DECISION (never per
  block): one dict (seq, wall-clock ts, kind, the correlated query id and
  the decision's inputs) into a bounded ring (``TFT_FLIGHT_RING``, default
  4096; overflow drops the oldest);
- :func:`scope` is a contextvar carrying the query id, so decisions deep
  in a forcing correlate to the query that rode them; it survives a hop to
  a worker thread through ``events.wrap_context``;
- :func:`dump` / :func:`maybe_dump` write the ring as a JSONL snapshot,
  triggered on slow queries and classified giveups, and at process exit,
  when ``TFT_FLIGHT_DUMP=<path>`` is set; writes share the trace file's
  size-capped keep-1 rotation (``TFT_TRACE_FILE_MAX_BYTES``,
  :func:`append_jsonl`).

The recorder is on unless ``TFT_FLIGHT=0``, as in the JAX package: with it
off every hook returns at one environment check, and nothing is recorded
or dumped. Its Prometheus family (``tft_flight_*``) renders through
``observability/metrics.py``.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

from ..utils.env import env_int
from ..utils.logging import get_logger

__all__ = ["enabled", "record", "scope", "current_query", "recent",
           "for_query", "dump", "maybe_dump", "clear", "append_jsonl",
           "stats", "set_worker_id", "current_worker", "load_dumps"]

_log = get_logger("observability.flight")


def enabled() -> bool:
    """``TFT_FLIGHT`` gate (default ON — the recorder exists for the
    queries nobody knew to trace). ``TFT_FLIGHT=0`` bypasses every hook
    at this one check, bit-identically."""
    return os.environ.get("TFT_FLIGHT", "") not in ("0", "false")


_seq = itertools.count(1)
_ring_lock = threading.Lock()
_ring: "deque[Dict[str, Any]]" = deque(
    maxlen=env_int("TFT_FLIGHT_RING", 4096))
_recorded = 0  # lifetime total (the ring drops, this does not)
_dumps = 0
_dump_evictions = 0  # snapshot sections pruned past TFT_FLIGHT_DUMP_KEEP

# the always-on query correlation id (a query trace's id, or whatever the
# caller scopes); independent of TFT_TRACE so decisions correlate even for
# queries that were never traced
_query: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("tft_flight_query", default=None)


def current_query() -> Optional[str]:
    """The ambient flight-correlation query id, or None."""
    return _query.get()


# the worker identity dimension: a process-level default (set_worker_id,
# one worker id per process of a fleet) plus a contextvar override for
# several workers that share one process and one ring.
_worker_default: Optional[str] = None
_worker: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("tft_flight_worker", default=None)


def set_worker_id(worker_id: Optional[str]) -> Optional[str]:
    """Set the process-default worker id stamped on every record (and
    on dump headers). Returns the previous value."""
    global _worker_default
    prev = _worker_default
    _worker_default = str(worker_id) if worker_id is not None else None
    return prev


def current_worker() -> Optional[str]:
    """The ambient worker id: the scope override when inside one, else
    the process default."""
    w = _worker.get()
    return w if w is not None else _worker_default


@contextlib.contextmanager
def scope(query_id: str,
          worker: Optional[str] = None) -> Iterator[None]:
    """Correlate every decision recorded inside the body to
    ``query_id`` (nested scopes shadow; a query trace scopes its forcing
    with its own id). ``worker`` additionally tags records with the
    executing worker's id (``None`` leaves the ambient worker)."""
    token = _query.set(str(query_id))
    wtoken = _worker.set(str(worker)) if worker is not None else None
    try:
        yield
    finally:
        if wtoken is not None:
            _worker.reset(wtoken)
        _query.reset(token)


def record(kind: str, query: Optional[str] = None, **inputs) -> None:
    """Record one decision. ``kind`` names it (``engine.oom_split``,
    ``plan.oom_fallback``, ``resilience.giveup``, ...); ``inputs`` carry what the
    decision SAW — the estimate and the observation, the threshold it
    compared against, the knob value, the alternative chosen — so the
    audit trail can reconstruct *why*, not just *that*. ``query``
    defaults to the ambient :func:`scope` id. Call this at decisions
    only, never from per-block hot paths."""
    if not enabled():
        return
    rec: Dict[str, Any] = {"ts": time.time(), "kind": kind}
    q = query if query is not None else _query.get()
    if q is not None:
        rec["query"] = q
    w = current_worker()
    if w is not None and "worker" not in inputs:
        rec["worker"] = w
    if inputs:
        rec.update(inputs)
    global _recorded
    # seq drawn under the ring lock so ring/dump order and seq order
    # always agree (a post-mortem consumer sorts dump lines by seq)
    with _ring_lock:
        rec["seq"] = next(_seq)
        _ring.append(rec)
        _recorded += 1


def recent(kind: Optional[str] = None,
           limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """Ring snapshot, oldest first; ``kind`` filters (prefix match with
    a trailing ``.`` treated as a namespace, e.g. ``"engine"``),
    ``limit`` keeps the newest N after filtering."""
    with _ring_lock:
        out = list(_ring)
    if kind is not None:
        out = [r for r in out
               if r["kind"] == kind or r["kind"].startswith(kind + ".")]
    if limit is not None and len(out) > limit:
        out = out[-limit:]
    return out


def for_query(query_id: str) -> List[Dict[str, Any]]:
    """Every recorded decision correlated to ``query_id``, oldest
    first."""
    qid = str(query_id)
    with _ring_lock:
        return [r for r in _ring if r.get("query") == qid]


def stats() -> Dict[str, Any]:
    with _ring_lock:
        return {"enabled": enabled(), "records": len(_ring),
                "capacity": _ring.maxlen, "recorded_total": _recorded,
                "dumps": _dumps, "dump_evictions": _dump_evictions}


def clear() -> None:
    """Drop the ring and re-read ``TFT_FLIGHT_RING`` (tests flip it)."""
    global _ring
    with _ring_lock:
        _ring = deque(maxlen=env_int("TFT_FLIGHT_RING", 4096))


# ---------------------------------------------------------------------------
# JSONL sink with size-capped keep-1 rotation
# ---------------------------------------------------------------------------

_file_lock = threading.Lock()


def _max_sink_bytes() -> int:
    """``TFT_TRACE_FILE_MAX_BYTES``: the shared JSONL-sink size cap (0 /
    unset = unbounded). One knob for the trace file AND flight dumps —
    a long-running process must not grow either without bound."""
    return max(env_int("TFT_TRACE_FILE_MAX_BYTES", 0), 0)


def append_jsonl(path: str, lines: List[str]) -> None:
    """Append pre-serialized JSONL ``lines`` to ``path`` under the
    shared sink lock, rotating first when the write would push the file
    past ``TFT_TRACE_FILE_MAX_BYTES``: the current file moves to
    ``<path>.1`` (keep-1 rollover, replacing any previous ``.1``) and a
    fresh file starts. A single write larger than the cap still lands
    (capping it would truncate mid-record); it rotates out on the next
    write. Raises ``OSError`` like a plain append — callers keep their
    own degrade-to-log handling."""
    text = "\n".join(lines) + "\n"
    cap = _max_sink_bytes()
    with _file_lock:
        if cap:
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
            if size and size + len(text.encode()) > cap:
                os.replace(path, path + ".1")
        with open(path, "a") as f:
            f.write(text)


# ---------------------------------------------------------------------------
# dumps
# ---------------------------------------------------------------------------

def _dump_keep() -> int:
    """``TFT_FLIGHT_DUMP_KEEP``: newest snapshot sections kept in the
    dump file (default 8; ``0`` disables pruning). Each anomaly appends
    one section, across restarts — without a bound the dump file is
    the one observability artifact that grows forever."""
    return max(env_int("TFT_FLIGHT_DUMP_KEEP", 8), 0)


def _prune_dump_snapshots(path: str) -> int:
    """Drop the oldest snapshot sections past :func:`_dump_keep`,
    rewriting the file atomically under the shared sink lock; returns
    the number of sections evicted (counted in :func:`stats`)."""
    keep = _dump_keep()
    if not keep:
        return 0
    global _dump_evictions
    with _file_lock:
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            return 0
        heads = []
        for i, line in enumerate(lines):
            s = line.strip()
            if '"flight_dump"' not in s:
                continue
            try:
                rec = json.loads(s)
            except ValueError:
                continue
            if isinstance(rec, dict) \
                    and rec.get("type") == "flight_dump":
                heads.append(i)
        excess = len(heads) - keep
        if excess <= 0:
            return 0
        tmp = path + ".prune"
        try:
            with open(tmp, "w") as f:
                f.write("\n".join(lines[heads[excess]:]) + "\n")
            os.replace(tmp, path)
        except OSError as e:
            _log.warning("flight dump prune of %s failed: %s", path, e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return 0
    with _ring_lock:
        _dump_evictions += excess
    _log.info("flight dump %s: %d old snapshot section(s) evicted "
              "(TFT_FLIGHT_DUMP_KEEP=%d)", path, excess, keep)
    return excess


def dump(path: Optional[str] = None,
         reason: str = "manual",
         worker: Optional[str] = None) -> Optional[str]:
    """Write the ring as one JSONL snapshot — a ``flight_dump`` header
    line (reason, timestamp, record count, and the dumping ``worker``
    when one is known) followed by one line per decision — to ``path``
    (default ``TFT_FLIGHT_DUMP``). Returns the path written, or None
    (no path configured / recorder bypassed). A failed write degrades
    to a warning log, never raises into the query that triggered it."""
    if not enabled():
        return None
    path = path or os.environ.get("TFT_FLIGHT_DUMP")
    if not path:
        return None
    with _ring_lock:
        records = list(_ring)
    head = {"type": "flight_dump", "reason": reason, "ts": time.time(),
            "records": len(records)}
    w = worker if worker is not None else current_worker()
    if w is not None:
        head["worker"] = w
    lines = [json.dumps(head, default=str)]
    lines.extend(json.dumps(r, default=str) for r in records)
    try:
        append_jsonl(path, lines)
    except OSError as e:
        _log.warning("TFT_FLIGHT_DUMP=%s write failed: %s", path, e)
        return None
    global _dumps
    with _ring_lock:
        _dumps += 1
    _prune_dump_snapshots(path)
    _log.info("flight recorder dumped %d decision(s) to %s (%s)",
              len(records), path, reason)
    return path


def maybe_dump(reason: str) -> Optional[str]:
    """Auto-dump hook for the trigger sites (slow query, classified
    giveup, process exit): dumps only when
    ``TFT_FLIGHT_DUMP`` is set, so the triggers cost one env read when
    it is not."""
    if not os.environ.get("TFT_FLIGHT_DUMP"):
        return None
    return dump(reason=reason)


def load_dumps(paths) -> List[Dict[str, Any]]:
    """Merge per-worker JSONL flight dumps back into one decision
    stream. Each file is the
    :func:`dump` format: ``flight_dump`` header lines carry the
    dumping worker's id, which is attributed to every following record
    that lacks its own ``worker`` field. Records merge across files
    sorted by wall-clock ``ts`` then ``seq`` — per-process seqs are
    independent, but ts orders the fleet's decisions well enough for a
    post-mortem. Unreadable files and malformed lines are skipped with
    a warning (a post-mortem tool must salvage what it can)."""
    if isinstance(paths, str):
        paths = [paths]
    merged: List[Dict[str, Any]] = []
    for path in paths:
        try:
            with open(path) as f:
                text = f.read()
        except OSError as e:
            _log.warning("flight dump %s unreadable: %s", path, e)
            continue
        header_worker: Optional[str] = None
        for ln, line in enumerate(text.splitlines(), 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                _log.warning("flight dump %s:%d: malformed line "
                             "skipped", path, ln)
                continue
            if not isinstance(rec, dict):
                continue
            if rec.get("type") == "flight_dump":
                header_worker = rec.get("worker")
                continue
            if "worker" not in rec and header_worker is not None:
                rec["worker"] = header_worker
            merged.append(rec)
    merged.sort(key=lambda r: (r.get("ts", 0), r.get("seq", 0)))
    return merged


@atexit.register
def _dump_at_exit() -> None:
    # the crash-adjacent case the recorder exists for: whatever was in
    # the ring when the process died is the last evidence
    try:
        if _ring:
            maybe_dump("exit")
    except Exception as e:  # noqa: BLE001 - interpreter is shutting down
        _log.debug("exit flight dump failed: %s", e)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _render_metrics() -> List[str]:
    s = stats()
    return [
        "# HELP tft_flight_records_total Decisions recorded by the "
        "flight recorder (lifetime; the ring holds the newest).",
        "# TYPE tft_flight_records_total counter",
        f"tft_flight_records_total {s['recorded_total']}",
        "# HELP tft_flight_ring_records Decisions currently held in "
        "the bounded flight ring.",
        "# TYPE tft_flight_ring_records gauge",
        f"tft_flight_ring_records {s['records']}",
        "# HELP tft_flight_dumps_total JSONL flight snapshots written "
        "(slow query / giveup / exit / manual).",
        "# TYPE tft_flight_dumps_total counter",
        f"tft_flight_dumps_total {s['dumps']}",
        "# HELP tft_flight_dump_evictions_total Old dump snapshot "
        "sections pruned past TFT_FLIGHT_DUMP_KEEP.",
        "# TYPE tft_flight_dump_evictions_total counter",
        f"tft_flight_dump_evictions_total {s['dump_evictions']}",
    ]


def _register_metrics() -> None:
    # deferred: metrics imports events, which imports this module
    from .metrics import register_metrics_provider
    register_metrics_provider("flight", _render_metrics)
