"""Durable query history and crash post-mortems: the archive of finished
queries.

The port's counterpart of ``tensorframes_tpu/observability/history.py``,
byte-compatible with it: each package reads the other's segments.

**What is recorded.** At every query-terminal point (the serve
scheduler's ``_finish``, a traced query's close, a stream batch that
emits windows or is skipped) :func:`record_finish` appends ONE compact
record: query id, tenant, plan fingerprint and a short summary, the
performance sentinel's cost vector, a bounded digest of the query's
flight-recorder decisions (the newest ``TFT_HISTORY_DECISIONS`` with a
per-kind histogram of the rest), outcome and classified error kind, the
worker id, and the queued, run and total walls.

**How it is stored.** Append-only, size-rotated segments
(``seg-NNNNNN.hist``) under ``TFT_HISTORY_DIR`` (or
``<persist root>/history`` when ``TFT_PERSIST_DIR`` is set). Each record
is framed ``magic + length + sha256(payload) + payload`` with a JSON
payload, and lands in ONE ``write()`` on an ``O_APPEND`` descriptor, so a
crash never tears a completed append. Whatever a crash does leave behind
fails the checksum walk, and the segment goes cold: counted
(``history.segments_corrupt``), flight-recorded
(``history.segment_corrupt``) and unlinked, never returning wrong records.
Rotation at ``TFT_HISTORY_MAX_BYTES`` per segment; the newest
``TFT_HISTORY_RETENTION`` segments are kept. ``TFT_HISTORY=0`` turns every
hook off.

**Reading it back.** :func:`history` filters (tenant, fingerprint,
outcome, since, slow_only) and stitches the records of one query id into
one. :func:`causal_chain` feeds ``ttf.why()``'s durable fall-through, so a
query's chain survives the ring's rotation and a restart.

**Post-mortems.** The first append of a process drops a
``running-<pid>.marker`` in the history directory, removed at a clean
interpreter exit. The first touch of a directory scans for the markers of
dead pids: one found is an unclean shutdown, counted, flight-recorded
(``history.unclean_shutdown``, shown by ``doctor()`` and ``health()``),
and :func:`postmortem` renders the triage report: the marker's story, the
history's tail, the last flight dump's summary and the timeline's rates.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils.env import env_int
from ..utils.logging import get_logger
from ..utils.tracing import counters

__all__ = ["enabled", "active_dir", "record_finish", "history",
           "causal_chain", "postmortem", "unclean_shutdown", "stats",
           "clear"]

_log = get_logger("observability.history")

# per-record framing: magic + 4-byte big-endian payload length +
# sha256(payload) + payload, the JAX package's bytes. memory/persist.py's
# discipline (the magic keys the layout, the digest catches bit rot
# before JSON can parse wrong data) applied per RECORD, so segments stay
# append-only.
_MAGIC = b"TFTH\x01"
_DIGEST_LEN = 32
_HEAD_LEN = len(_MAGIC) + 4 + _DIGEST_LEN

_SEG_PREFIX = "seg-"
_SEG_SUFFIX = ".hist"
_MARKER_PREFIX = "running-"
_MARKER_SUFFIX = ".marker"

_DEFAULT_MAX_BYTES = 4 * 1024 * 1024
_DEFAULT_RETENTION = 8
_DEFAULT_DECISIONS = 32

_lock = threading.Lock()
# active-segment cache: (dir, seg_no, size) — re-resolved when the dir
# changes (tests switch TFT_HISTORY_DIR; TFT_PERSIST_DIR moves it too)
_active: Optional[Tuple[str, int, int]] = None
# dirs whose stale-marker scan already ran (once per process per dir)
_scanned: set = set()
# markers this process created (removed at clean exit)
_markers: set = set()
# the newest unclean shutdown detected this process, or None
_unclean: Optional[Dict[str, Any]] = None

# lifetime counts for stats()/metrics (tracing counters mirror them so
# the timeline can rate them)
_written = 0
_rotations = 0
_evictions = 0
_corrupt = 0
_write_errors = 0
_unclean_total = 0


def enabled() -> bool:
    """``TFT_HISTORY`` gate (default on: the archive exists for the crash
    nobody planned). ``TFT_HISTORY=0`` turns every hook off."""
    return os.environ.get("TFT_HISTORY", "") not in ("0", "false")


def active_dir() -> Optional[str]:
    """The history directory, or ``None`` (archive off): an explicit
    ``TFT_HISTORY_DIR``, else ``<persist root>/history`` when the
    durable tier (``memory/persist.py``) is configured."""
    d = os.environ.get("TFT_HISTORY_DIR")
    if d:
        return d
    from ..memory import persist as _persist
    base = _persist.root()
    if base is None:
        return None
    return os.path.join(base, "history")


def _max_bytes() -> int:
    return max(env_int("TFT_HISTORY_MAX_BYTES", _DEFAULT_MAX_BYTES), 1)


def _retention() -> int:
    return max(env_int("TFT_HISTORY_RETENTION", _DEFAULT_RETENTION), 1)


def _decisions_keep() -> int:
    return max(env_int("TFT_HISTORY_DECISIONS", _DEFAULT_DECISIONS), 0)


def _frame(payload: bytes) -> bytes:
    return (_MAGIC + struct.pack(">I", len(payload))
            + hashlib.sha256(payload).digest() + payload)


def _seg_no(name: str) -> Optional[int]:
    if not (name.startswith(_SEG_PREFIX)
            and name.endswith(_SEG_SUFFIX)):
        return None
    try:
        return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
    except ValueError:
        return None


def _seg_path(d: str, no: int) -> str:
    return os.path.join(d, f"{_SEG_PREFIX}{no:06d}{_SEG_SUFFIX}")


def _segments(d: str) -> List[Tuple[int, str]]:
    """(segment number, path) pairs, oldest first."""
    out: List[Tuple[int, str]] = []
    try:
        with os.scandir(d) as it:
            for e in it:
                no = _seg_no(e.name)
                if no is not None:
                    out.append((no, e.path))
    except OSError:
        return []
    out.sort()
    return out


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # EPERM etc: exists, just not ours
    return True


def _scan_stale_markers(d: str) -> None:
    """Unclean-shutdown detection: a ``running-<pid>`` marker whose pid
    is dead means that process never reached its clean-exit hook. The
    finding is counted, flight-recorded as an anomaly, consumed
    (marker unlinked), and kept for :func:`postmortem`."""
    global _unclean, _unclean_total
    try:
        with os.scandir(d) as it:
            names = [e.name for e in it
                     if e.name.startswith(_MARKER_PREFIX)
                     and e.name.endswith(_MARKER_SUFFIX)]
    except OSError:
        return
    for name in names:
        try:
            pid = int(name[len(_MARKER_PREFIX):-len(_MARKER_SUFFIX)])
        except ValueError:
            continue
        if pid == os.getpid() or _pid_alive(pid):
            continue
        path = os.path.join(d, name)
        info: Dict[str, Any] = {"pid": pid}
        try:
            with open(path) as f:
                body = json.loads(f.read())
            if isinstance(body, dict):
                info.update(body)
        except (OSError, ValueError) as e:
            _log.debug("unclean marker %s unreadable: %s", path, e)
        info["detected_ts"] = time.time()
        try:
            os.unlink(path)
        except OSError as e:
            _log.debug("unclean marker %s unlink failed: %s", path, e)
        with _lock:
            _unclean_total += 1
            if (_unclean is None
                    or info.get("started_ts", 0)
                    >= _unclean.get("started_ts", 0)):
                _unclean = info
        counters.inc("history.unclean_shutdowns")
        from . import flight as _flight
        _flight.record("history.unclean_shutdown", pid=pid,
                       started_ts=info.get("started_ts"),
                       worker=info.get("worker"), dir=d)
        _log.warning("history: UNCLEAN shutdown detected — pid %d died "
                     "without its clean-exit hook (marker %s); "
                     "ttf.postmortem() has the triage report", pid, name)


def _ensure_dir() -> Optional[str]:
    """Resolve + create the history dir; run the stale-marker scan and
    drop this process's running marker the first time a dir is seen."""
    d = active_dir()
    if d is None:
        return None
    try:
        os.makedirs(d, exist_ok=True)
    except OSError as e:
        _log.warning("history dir unavailable (%s): %s", d, e)
        return None
    with _lock:
        first = d not in _scanned
        if first:
            _scanned.add(d)
    if first:
        _scan_stale_markers(d)
        marker = os.path.join(
            d, f"{_MARKER_PREFIX}{os.getpid()}{_MARKER_SUFFIX}")
        try:
            from . import flight as _flight
            body = {"pid": os.getpid(), "started_ts": time.time(),
                    "worker": _flight.current_worker()}
            with open(marker, "w") as f:
                f.write(json.dumps(body))
            with _lock:
                _markers.add(marker)
        except OSError as e:
            _log.warning("history running marker failed (%s): %s",
                         marker, e)
    return d


@atexit.register
def _clean_exit() -> None:
    # the clean-shutdown half of the post-mortem contract: markers
    # that survive this hook belonged to a process that crashed
    with _lock:
        markers = list(_markers)
        _markers.clear()
    for m in markers:
        try:
            os.unlink(m)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _digest_decisions(decisions: Optional[List[Dict[str, Any]]]
                      ) -> Tuple[List[Dict[str, Any]], Dict[str, int],
                                 int]:
    """Bound the per-query flight digest: the newest
    ``TFT_HISTORY_DECISIONS`` full records plus a per-kind histogram of
    everything, with the dropped count (a query that rode 500 spills
    archives their shape, not 500 lines)."""
    if not decisions:
        return [], {}, 0
    kinds: Dict[str, int] = {}
    for r in decisions:
        k = str(r.get("kind", "?"))
        kinds[k] = kinds.get(k, 0) + 1
    keep = _decisions_keep()
    kept = decisions[-keep:] if keep else []
    return list(kept), kinds, len(decisions) - len(kept)


def _rotate_locked(d: str, seg: int) -> int:
    """Start the next segment; evict the oldest past the retention."""
    global _rotations, _evictions
    seg += 1
    _rotations += 1
    counters.inc("history.segments_rotated")
    segs = _segments(d)
    excess = len(segs) + 1 - _retention()  # +1: the new segment
    for no, path in segs[:max(excess, 0)]:
        try:
            os.unlink(path)
            _evictions += 1
            counters.inc("history.segment_evictions")
            _log.debug("history segment %06d evicted (retention %d)",
                       no, _retention())
        except OSError as e:
            _log.debug("history segment eviction failed (%s): %s",
                       path, e)
    return seg


def record_finish(query_id: Any, *,
                  tenant: Optional[str] = None,
                  fingerprint: Optional[str] = None,
                  outcome: str = "ok",
                  error: Optional[str] = None,
                  error_kind: Optional[str] = None,
                  worker: Optional[str] = None,
                  cost: Optional[Dict[str, Any]] = None,
                  queued_s: Optional[float] = None,
                  run_s: Optional[float] = None,
                  total_s: Optional[float] = None,
                  est_rows: Optional[int] = None,
                  est_bytes: Optional[int] = None,
                  preemptions: int = 0,
                  source: str = "serve",
                  summary: Optional[str] = None,
                  decisions: Optional[List[Dict[str, Any]]] = None
                  ) -> bool:
    """Fold one finished query into the durable archive. Best-effort by
    design: every failure is logged and counted, never raised — a full
    disk must degrade the archive, not fail the query that was
    finishing. Returns whether a record landed."""
    if not enabled():
        return False
    try:
        d = _ensure_dir()
        if d is None:
            return False
        decs, kinds, dropped = _digest_decisions(decisions)
        rec: Dict[str, Any] = {
            "v": 1, "ts": time.time(), "query": str(query_id),
            "outcome": str(outcome), "source": source,
        }
        if tenant is not None:
            rec["tenant"] = str(tenant)
        if fingerprint is not None:
            rec["fingerprint"] = str(fingerprint)
        if summary is not None:
            rec["summary"] = str(summary)
        if worker is not None:
            rec["worker"] = str(worker)
        if error is not None:
            rec["error"] = str(error)[:300]
        if error_kind is not None:
            rec["error_kind"] = str(error_kind)
        if cost:
            rec["cost"] = dict(cost)
        for k, v in (("queued_s", queued_s), ("run_s", run_s),
                     ("total_s", total_s)):
            if v is not None:
                rec[k] = round(float(v), 6)
        if est_rows is not None:
            rec["est_rows"] = int(est_rows)
        if est_bytes is not None:
            rec["est_bytes"] = int(est_bytes)
        if preemptions:
            rec["preemptions"] = int(preemptions)
        if decs:
            rec["decisions"] = decs
        if kinds:
            rec["decision_kinds"] = kinds
        if dropped:
            rec["decisions_dropped"] = dropped
        payload = json.dumps(rec, default=str).encode()
        framed = _frame(payload)
        global _active, _written
        with _lock:
            if _active is None or _active[0] != d:
                segs = _segments(d)
                if segs:
                    no, path = segs[-1]
                    try:
                        size = os.path.getsize(path)
                    except OSError:
                        size = 0
                    _active = (d, no, size)
                else:
                    _active = (d, 0, 0)
            _, seg, size = _active
            if size and size + len(framed) > _max_bytes():
                seg = _rotate_locked(d, seg)
                size = 0
            # one write() on an O_APPEND descriptor: a crash between
            # records leaves whole records; a crash INSIDE this append
            # leaves a torn tail the checksum walk turns cold
            fd = os.open(_seg_path(d, seg),
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, framed)
            finally:
                os.close(fd)
            _active = (d, seg, size + len(framed))
            _written += 1
        counters.inc("history.records")
        return True
    except Exception as e:  # noqa: BLE001 - archive is best-effort
        global _write_errors
        with _lock:
            _write_errors += 1
        counters.inc("history.write_errors")
        _log.warning("history append for query %s failed: %s",
                     query_id, e)
        return False


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _cold_segment(path: str, why: str) -> None:
    """The cold-never-wrong path: a segment that fails verification is
    counted, flight-recorded, and unlinked — the archive returns fewer
    records, never wrong ones."""
    global _corrupt
    with _lock:
        _corrupt += 1
    counters.inc("history.segments_corrupt")
    from . import flight as _flight
    _flight.record("history.segment_corrupt",
                   segment=os.path.basename(path), why=why)
    _log.warning("history segment corrupt (%s): %s — segment goes "
                 "cold, earlier segments remain readable", path, why)
    try:
        os.unlink(path)
    except OSError:
        pass
    global _active
    with _lock:
        _active = None  # re-resolve: the active segment may be gone


def _read_segment(path: str) -> List[Dict[str, Any]]:
    """Walk one segment's framed records, verifying each digest. ANY
    framing/checksum/parse failure sends the whole segment cold."""
    from ..resilience import faults as _faults
    data: Optional[bytes] = None
    try:
        try:
            _faults.check("disk")
        except _faults.InjectedFault as e:
            if "corrupt" not in str(e):
                raise
            # corruption-shaped injection (persist.py's idiom): read the
            # real bytes and flip one payload bit, which the checksum
            # must catch
            with open(path, "rb") as f:
                buf = bytearray(f.read())
            if buf:
                buf[-1] ^= 0x01
            data = bytes(buf)
        if data is None:
            with open(path, "rb") as f:
                data = f.read()
    except FileNotFoundError:
        return []
    except Exception as e:
        _cold_segment(path, f"read failed: {e}")
        return []
    out: List[Dict[str, Any]] = []
    off = 0
    n = len(data)
    while off < n:
        head = data[off:off + _HEAD_LEN]
        if len(head) < _HEAD_LEN or not head.startswith(_MAGIC):
            _cold_segment(path, f"bad record header at byte {off}")
            return []
        (plen,) = struct.unpack(">I", head[len(_MAGIC):len(_MAGIC) + 4])
        digest = head[len(_MAGIC) + 4:]
        payload = data[off + _HEAD_LEN:off + _HEAD_LEN + plen]
        if len(payload) < plen:
            _cold_segment(path, f"truncated record at byte {off}")
            return []
        if hashlib.sha256(payload).digest() != digest:
            _cold_segment(path, f"sha256 mismatch at byte {off}")
            return []
        try:
            rec = json.loads(payload)
        except ValueError as e:
            _cold_segment(path, f"unparseable record at byte {off}: {e}")
            return []
        if isinstance(rec, dict):
            out.append(rec)
        off += _HEAD_LEN + plen
    return out


def _raw_records() -> List[Dict[str, Any]]:
    d = active_dir()
    if d is None:
        return []
    out: List[Dict[str, Any]] = []
    for _, path in _segments(d):
        out.extend(_read_segment(path))
    return out


def _stitch(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Merge per-attempt records of one query id into one story: the
    worker path in order, the migration count, the terminal attempt's
    outcome, cost and times (a ``migrated`` record is an interim stamp,
    never the ending; the port has no fabric yet that writes one)."""
    by_qid: Dict[str, List[Dict[str, Any]]] = {}
    order: List[str] = []
    for r in records:
        q = str(r.get("query", "?"))
        if q not in by_qid:
            order.append(q)
        by_qid.setdefault(q, []).append(r)
    out: List[Dict[str, Any]] = []
    for q in order:
        grp = sorted(by_qid[q], key=lambda r: r.get("ts", 0))
        terminal = grp[-1]
        for r in reversed(grp):
            if r.get("outcome") != "migrated":
                terminal = r
                break
        stitched = dict(terminal)
        workers: List[str] = []
        for r in grp:
            w = r.get("worker")
            if w is not None and w not in workers:
                workers.append(str(w))
        if workers:
            stitched["workers"] = workers
        migrations = sum(1 for r in grp
                         if r.get("outcome") == "migrated")
        if migrations:
            stitched["migrations"] = migrations
        if len(grp) > 1:
            stitched["attempts"] = len(grp) - migrations
            stitched["ts_first"] = grp[0].get("ts")
            kinds: Dict[str, int] = {}
            decs: List[Dict[str, Any]] = []
            for r in grp:
                for k, v in (r.get("decision_kinds") or {}).items():
                    kinds[k] = kinds.get(k, 0) + int(v)
                decs.extend(r.get("decisions") or [])
            if kinds:
                stitched["decision_kinds"] = kinds
            if decs:
                decs.sort(key=lambda r: (r.get("ts", 0),
                                         r.get("seq", 0)))
                stitched["decisions"] = decs
        out.append(stitched)
    out.sort(key=lambda r: r.get("ts", 0))
    return out


def _slow_threshold_s() -> float:
    raw = os.environ.get("TFT_SLOW_QUERY_MS")
    try:
        return float(raw) / 1000.0 if raw else 1.0
    except ValueError:
        return 1.0


def history(tenant: Optional[str] = None,
            fingerprint: Optional[str] = None,
            outcome: Optional[str] = None,
            since: Optional[float] = None,
            slow_only: bool = False,
            limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """The durable query log, oldest first, stitched per query id. Filters: ``tenant`` (exact), ``fingerprint``
    (prefix — fingerprints are long hashes), ``outcome`` (the terminal
    key: ``completed``/``failed``/``shed``/...), ``since`` (epoch
    seconds), ``slow_only`` (total wall past ``TFT_SLOW_QUERY_MS``,
    default 1s). ``limit`` keeps the newest N after filtering."""
    _ensure_dir()  # stale-marker scan even on a read-only consumer
    recs = _stitch(_raw_records())
    if tenant is not None:
        recs = [r for r in recs if r.get("tenant") == tenant]
    if fingerprint is not None:
        recs = [r for r in recs
                if str(r.get("fingerprint", "")).startswith(fingerprint)]
    if outcome is not None:
        recs = [r for r in recs if r.get("outcome") == outcome]
    if since is not None:
        recs = [r for r in recs if r.get("ts", 0) >= float(since)]
    if slow_only:
        bar = _slow_threshold_s()
        recs = [r for r in recs
                if (r.get("total_s") or r.get("run_s") or 0) >= bar]
    if limit is not None and len(recs) > limit:
        recs = recs[-limit:]
    return recs


def causal_chain(query_id: Any
                 ) -> Tuple[Optional[Dict[str, Any]],
                            List[Dict[str, Any]]]:
    """``ttf.why()``'s durable fall-through: the stitched history
    record for ``query_id`` and its archived decision digest —
    ``(None, [])`` when the archive has never seen the query."""
    qid = str(query_id)
    for r in _stitch(_raw_records()):
        if r.get("query") == qid:
            return r, list(r.get("decisions") or [])
    return None, []


# ---------------------------------------------------------------------------
# post-mortem synthesis
# ---------------------------------------------------------------------------

def unclean_shutdown() -> Optional[Dict[str, Any]]:
    """The newest unclean shutdown detected this process (pid,
    started_ts, worker, detected_ts), or ``None``. Detection runs at
    the first history-dir touch; calling this forces it."""
    _ensure_dir()
    with _lock:
        return dict(_unclean) if _unclean is not None else None


def _dump_summary() -> List[str]:
    """Summarize the last ``TFT_FLIGHT_DUMP`` snapshot: header of the
    newest section plus an anomaly-kind histogram over its records."""
    path = os.environ.get("TFT_FLIGHT_DUMP")
    if not path or not os.path.exists(path):
        return ["  flight dump: none (TFT_FLIGHT_DUMP unset or empty)"]
    from . import flight as _flight
    from .decisions import ANOMALY_KINDS
    head: Optional[Dict[str, Any]] = None
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) \
                        and rec.get("type") == "flight_dump":
                    head = rec  # last header wins: the newest snapshot
    except OSError as e:
        return [f"  flight dump: {path} unreadable ({e})"]
    merged = _flight.load_dumps(path)
    kinds: Dict[str, int] = {}
    for r in merged:
        k = r.get("kind")
        if k in ANOMALY_KINDS:
            kinds[k] = kinds.get(k, 0) + 1
    lines = []
    if head is not None:
        age = time.time() - float(head.get("ts", time.time()))
        lines.append(
            f"  flight dump: {path} — last snapshot {age:.0f}s ago "
            f"({head.get('reason')}, {head.get('records')} record(s)"
            + (f", worker {head['worker']}" if head.get("worker")
               else "") + ")")
    else:
        lines.append(f"  flight dump: {path} — no parseable snapshot")
    if kinds:
        lines.append("  dump anomalies: " + ", ".join(
            f"{k} x{n}" for k, n in sorted(kinds.items())))
    return lines


def postmortem(tail: int = 10) -> str:
    """One crash triage report: the unclean-shutdown finding (or its
    absence), the durable history tail, the last flight dump's
    summary, and recent timeline rates — merged so the first command
    after a restart answers "what was the process doing when it
    died"."""
    info = unclean_shutdown()
    lines = ["ttf.postmortem() · crash triage report"]
    if info is not None:
        started = info.get("started_ts")
        up = (f", up {info['detected_ts'] - started:.0f}s"
              if started else "")
        w = f" (worker {info['worker']})" if info.get("worker") else ""
        lines.append(
            f"  UNCLEAN SHUTDOWN: pid {info.get('pid')}{w} died without "
            f"reaching its clean-exit hook{up} — records below are what "
            f"the archive saved before the crash")
    else:
        lines.append(
            "  no unclean shutdown detected (previous run exited "
            "cleanly, or no history dir is configured)")
    recs = history(limit=tail)
    if recs:
        lines.append(f"  history tail (newest {len(recs)} of the "
                     f"durable archive):")
        for r in recs:
            parts = [f"{r.get('outcome')}"]
            if r.get("total_s") is not None:
                parts.append(f"{r['total_s']:.3f}s")
            if r.get("tenant"):
                parts.append(f"tenant {r['tenant']!r}")
            if r.get("workers"):
                parts.append("worker " + "->".join(r["workers"]))
            elif r.get("worker"):
                parts.append(f"worker {r['worker']}")
            if r.get("error_kind"):
                parts.append(f"[{r['error_kind']}]")
            lines.append(f"    {r.get('query'):<16} "
                         + " · ".join(parts))
    else:
        lines.append("  history tail: empty (no archived queries)")
    lines.extend(_dump_summary())
    try:
        from . import timeline as _timeline
        tl_lines = []
        for fam in ("serve", "stream.batches", "retry",
                    "history.records"):
            tl = _timeline.timeline(fam)
            if tl["samples"] >= 2 and tl["total_delta"]:
                tl_lines.append(
                    f"    {fam}: {tl['total_delta']:g} over "
                    f"{tl['samples']} sample(s) "
                    f"({tl['rate_per_s']:.3g}/s)")
        if tl_lines:
            lines.append("  timeline rates (in-memory, this process):")
            lines.extend(tl_lines)
    except Exception as e:  # noqa: BLE001 - triage must render
        _log.debug("postmortem timeline section failed: %s", e)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# introspection / metrics
# ---------------------------------------------------------------------------

def stats() -> Dict[str, Any]:
    """Archive snapshot for ``ttf.health()``."""
    d = active_dir()
    segs = _segments(d) if d else []
    size = 0
    for _, path in segs:
        try:
            size += os.path.getsize(path)
        except OSError:
            continue
    with _lock:
        return {
            "enabled": enabled() and d is not None,
            "dir": d,
            "segments": len(segs),
            "bytes": size,
            "records_written": _written,
            "rotations": _rotations,
            "evictions": _evictions,
            "corrupt_segments": _corrupt,
            "write_errors": _write_errors,
            "unclean_shutdowns": _unclean_total,
            "unclean": dict(_unclean) if _unclean is not None else None,
        }


def clear() -> None:
    """Forget process-local archive state (tests switch directories): the
    active-segment cache, the per-dir marker scans, the unclean
    finding. On-disk segments are untouched."""
    global _active, _unclean
    with _lock:
        _active = None
        _unclean = None
        _scanned.clear()


def _render_metrics() -> List[str]:
    s = stats()
    return [
        "# HELP tft_history_records_total Query records appended to "
        "the durable history archive (this process).",
        "# TYPE tft_history_records_total counter",
        f"tft_history_records_total {s['records_written']}",
        "# HELP tft_history_segments On-disk history segments.",
        "# TYPE tft_history_segments gauge",
        f"tft_history_segments {s['segments']}",
        "# HELP tft_history_bytes Bytes across on-disk history "
        "segments.",
        "# TYPE tft_history_bytes gauge",
        f"tft_history_bytes {s['bytes']}",
        "# HELP tft_history_rotations_total Segment rotations at "
        "TFT_HISTORY_MAX_BYTES.",
        "# TYPE tft_history_rotations_total counter",
        f"tft_history_rotations_total {s['rotations']}",
        "# HELP tft_history_evictions_total Segments evicted past "
        "TFT_HISTORY_RETENTION.",
        "# TYPE tft_history_evictions_total counter",
        f"tft_history_evictions_total {s['evictions']}",
        "# HELP tft_history_corrupt_total Segments sent cold by the "
        "checksum walk (bit rot / truncation; never wrong records).",
        "# TYPE tft_history_corrupt_total counter",
        f"tft_history_corrupt_total {s['corrupt_segments']}",
        "# HELP tft_history_unclean_shutdowns_total Stale running "
        "markers of dead pids found at startup.",
        "# TYPE tft_history_unclean_shutdowns_total counter",
        f"tft_history_unclean_shutdowns_total {s['unclean_shutdowns']}",
    ]


def _register_metrics() -> None:
    # deferred: metrics imports events, which imports flight
    from .metrics import register_metrics_provider
    register_metrics_provider("history", _render_metrics)
