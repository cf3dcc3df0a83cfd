"""Durable state tier: checkpoints and result-cache entries on disk.

The port's counterpart of ``tensorframes_tpu/memory/persist.py``. The
guarantees above this line (preempt/resume, :mod:`.checkpoint`; the
plan-fingerprint result cache of ``plan/adaptive.py``, not ported yet)
live in process memory and die with the process. This module is the disk
tier under them that makes them survive process death: a crashed
process's running query resumes elsewhere, and a restart comes back
warm.

Two artifact families, one directory (``TFT_PERSIST_DIR`` or
:func:`configure`):

- **checkpoints** (``<dir>/checkpoints/<query>.ckpt``): the parked form
  of a :class:`~.checkpoint.QueryCheckpoint`, written through on every
  park. Payloads are numpy, never pickled tensors, so a file
  survives a different torch build: a parked device value is written as
  ``("dev", host numpy, None, dtype name)``. Its device is dropped (a
  device is a live-process handle; the restoring process places it on
  its default device). The stream ``tag`` + ``total`` cursor ride along
  verbatim, so a resume elsewhere hits the same mismatch contract: any
  drift discards to a cold re-run, never restores wrong data.
- **results** (``<dir>/results/<fp>.res``): result blocks keyed by a
  portable plan fingerprint, so a restarted process can serve a
  zero-dispatch warm hit. The result dir is byte-budgeted
  (``TFT_PERSIST_RESULT_BYTES``) and swept oldest-first. Its caller is
  the plan-fingerprint result cache (``plan/adaptive.py``).
- **baselines** (``<dir>/baselines/<fp>.perf``): a performance
  sentinel's rolling per-fingerprint cost baselines, keyed by the same
  fingerprints. Tiny, so no sweep.

Durability here is best-effort by design: every write/read failure is
logged and counted, never raised — a broken disk must degrade the
serving tier to cold re-runs, not crash the query that was being
checkpointed. Corrupt or truncated files load as ``None`` (cold path).

Every artifact is framed ``magic + sha256(payload) + payload`` and the
digest is verified on load. Truncation usually breaks the pickle on
its own, but single-bit rot inside a numpy buffer does NOT — the file
still unpickles and silently restores WRONG data, which the serving
tier would then hand out as a warm hit. The checksum closes that hole:
a mismatch goes cold (counted ``memory.persist_corrupt``,
flight-recorded, file removed), never wrong. The ``disk`` fault site
(``resilience/faults.py``) injects both failure shapes here: a plain
disk fault takes the read-failure path, one whose message mentions
``corrupt`` flips a payload byte so the checksum path is exercised.

Unpickling runs only on files this tier wrote under its own directory.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import re
import tempfile
import threading
from typing import Any, List, Optional, Tuple

from ..utils.logging import get_logger
from ..utils.tracing import counters

__all__ = ["configure", "root", "enabled", "save_checkpoint",
           "load_checkpoint", "discard_checkpoint", "save_result",
           "load_result", "save_baseline", "load_baseline", "stats"]

_log = get_logger("memory.persist")

_lock = threading.Lock()
_override: Optional[str] = None  # configure() beats the env knob

_CKPT_DIR = "checkpoints"
_RES_DIR = "results"
_BL_DIR = "baselines"

# result-dir byte budget before the oldest-first sweep (default 512 MiB)
_DEFAULT_RESULT_BYTES = 512 * 1024 * 1024

# artifact framing: magic + sha256(payload) + payload. The magic keys
# the container format (bump on layout change); the digest makes
# bit-rot detectable before pickle can silently restore wrong data.
_MAGIC = b"TFTP\x01"
_DIGEST_LEN = 32


def _pack(payload: bytes) -> bytes:
    """Frame pickled ``payload`` with the magic + content checksum."""
    return _MAGIC + hashlib.sha256(payload).digest() + payload


def _corrupt(path: str, why: str) -> None:
    """The checksum cold path: count, flight-record, remove, ``None``.
    Distinct from ``persist.read_errors`` (I/O and unpickle failures)
    because a digest mismatch means the bytes CHANGED after a good
    write — the one failure shape that would otherwise restore wrong
    data silently."""
    counters.inc("memory.persist_corrupt")
    from ..observability import flight as _flight
    _flight.record("memory.persist_corrupt", path=os.path.basename(path),
                   why=why)
    _log.warning("persist artifact corrupt (%s): %s — treating as cold",
                 path, why)
    try:
        os.unlink(path)
    except OSError:
        pass
    return None


def configure(path: Optional[str]) -> Optional[str]:
    """Point the tier at ``path`` (``None`` disables unless
    ``TFT_PERSIST_DIR`` is set). Returns the previous override so a
    scoped owner (the fabric) can restore it on close."""
    global _override
    with _lock:
        prev = _override
        _override = path
    return prev


def root() -> Optional[str]:
    """The active persistence root, or ``None`` when the tier is off."""
    with _lock:
        if _override is not None:
            return _override
    return os.environ.get("TFT_PERSIST_DIR") or None


def enabled() -> bool:
    return root() is not None


def _safe_name(key: str) -> str:
    """A filesystem-safe, collision-free filename for ``key``: the
    sanitized key for greppability plus a short hash for identity."""
    tail = hashlib.sha256(key.encode()).hexdigest()[:12]
    stem = re.sub(r"[^A-Za-z0-9_.-]", "_", key)[:80]
    return f"{stem}-{tail}"


def _subdir(kind: str) -> Optional[str]:
    base = root()
    if base is None:
        return None
    path = os.path.join(base, kind)
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as e:
        _log.warning("persist tier unavailable (%s): %s", path, e)
        return None
    return path


def _atomic_write(path: str, payload: bytes) -> bool:
    """Write-then-rename so readers never see a torn file (a crash
    mid-write leaves the previous version or nothing, both safe)."""
    d = os.path.dirname(path)
    try:
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return True
    except Exception as e:
        counters.inc("persist.write_errors")
        _log.warning("persist write failed (%s): %s", path, e)
        return False


def _read(path: str) -> Optional[Any]:
    from ..resilience import faults as _faults
    data: Optional[bytes] = None
    try:
        try:
            _faults.check("disk")
        except _faults.InjectedFault as e:
            if "corrupt" not in str(e):
                raise
            # corruption-shaped injection: read the real bytes, then
            # flip one payload bit — the artifact still "reads fine"
            # and must be caught by the checksum, not by luck
            with open(path, "rb") as f:
                buf = bytearray(f.read())
            if buf:
                buf[-1] ^= 0x01
            data = bytes(buf)
        if data is None:
            with open(path, "rb") as f:
                data = f.read()
    except FileNotFoundError:
        return None
    except Exception as e:
        # I/O failure (including injected disk faults): cold path
        counters.inc("persist.read_errors")
        _log.warning("persist read failed (%s): %s — treating as cold",
                     path, e)
        try:
            os.unlink(path)
        except OSError:
            pass
        return None
    if (not data.startswith(_MAGIC)
            or len(data) < len(_MAGIC) + _DIGEST_LEN):
        return _corrupt(path, "missing or truncated artifact header")
    digest = data[len(_MAGIC):len(_MAGIC) + _DIGEST_LEN]
    payload = data[len(_MAGIC) + _DIGEST_LEN:]
    if hashlib.sha256(payload).digest() != digest:
        return _corrupt(path, "sha256 content checksum mismatch")
    try:
        return pickle.loads(payload)
    except Exception as e:
        # checksum held but the pickle didn't: version/environment skew
        counters.inc("persist.read_errors")
        _log.warning("persist unpickle failed (%s): %s — treating as "
                     "cold", path, e)
        try:
            os.unlink(path)
        except OSError:
            pass
        return None


def _strip_devices(t: Tuple) -> Tuple:
    """The parked form's ``("dev", host, device, dtype)`` tuples carry a
    live device handle and a torch dtype; the written form keeps the
    numpy bytes and the dtype's name, and ``None`` for the device makes
    the restore take the default device (bit-identical values either
    way)."""
    kind = t[0]
    if kind == "dev":
        return ("dev", t[1], None, str(t[3]).replace("torch.", ""))
    if kind in ("block", "dict"):
        mapped = {k: _strip_devices(c) for k, c in t[1].items()}
        return (kind, mapped) + tuple(t[2:])
    return t


# -- checkpoints ----------------------------------------------------------

def save_checkpoint(query_id: str, parked: Tuple[List[Tuple], int, str],
                    parked_blocks: int, moved_bytes: int) -> bool:
    """Write-through one parked stream (called from
    :meth:`~.checkpoint.QueryCheckpoint.park_stream`). Best-effort:
    a failure degrades THAT query's cross-process resume to a cold
    re-run and nothing else."""
    d = _subdir(_CKPT_DIR)
    if d is None:
        return False
    vals, total, tag = parked
    try:
        payload = pickle.dumps(
            {"version": 1, "query_id": query_id, "tag": tag,
             "total": int(total),
             "vals": [_strip_devices(v) for v in vals],
             "parked_blocks": int(parked_blocks),
             "moved_bytes": int(moved_bytes)},
            protocol=pickle.HIGHEST_PROTOCOL)
    except Exception as e:
        counters.inc("persist.write_errors")
        _log.warning("checkpoint of %s not picklable: %s", query_id, e)
        return False
    path = os.path.join(d, _safe_name(query_id) + ".ckpt")
    if not _atomic_write(path, _pack(payload)):
        return False
    counters.inc("persist.checkpoint_writes")
    _log.debug("persisted checkpoint of %s: %d block(s), %d B -> %s",
               query_id, parked_blocks, len(payload), path)
    return True


def load_checkpoint(query_id: str):
    """The persisted :class:`~.checkpoint.QueryCheckpoint` of
    ``query_id``, or ``None`` (cold). The returned checkpoint still
    enforces the tag+total mismatch contract on resume."""
    d = _subdir(_CKPT_DIR)
    if d is None:
        return None
    rec = _read(os.path.join(d, _safe_name(query_id) + ".ckpt"))
    if not isinstance(rec, dict) or rec.get("version") != 1:
        return None
    from .checkpoint import QueryCheckpoint
    cp = QueryCheckpoint(query_id)
    cp._parked = (rec["vals"], int(rec["total"]), str(rec["tag"]))
    cp.parked_blocks = int(rec.get("parked_blocks", len(rec["vals"])))
    cp.moved_bytes = int(rec.get("moved_bytes", 0))
    counters.inc("persist.checkpoint_loads")
    return cp


def discard_checkpoint(query_id: str) -> None:
    """Drop the persisted checkpoint (terminal completion — the query
    finished for real, nothing left to resume)."""
    base = root()
    if base is None:
        return
    path = os.path.join(base, _CKPT_DIR, _safe_name(query_id) + ".ckpt")
    try:
        os.unlink(path)
        counters.inc("persist.checkpoint_discards")
    except FileNotFoundError:
        pass
    except OSError as e:
        _log.debug("checkpoint discard of %s failed: %s", query_id, e)


# -- result-cache entries -------------------------------------------------

def _result_budget() -> int:
    try:
        return int(os.environ.get("TFT_PERSIST_RESULT_BYTES",
                                  _DEFAULT_RESULT_BYTES))
    except ValueError:
        return _DEFAULT_RESULT_BYTES


def _sweep_results(d: str) -> None:
    """Oldest-first eviction when the result dir crosses its byte
    budget — mirrors the in-memory LRU's discipline on disk."""
    budget = _result_budget()
    try:
        entries = []
        total = 0
        with os.scandir(d) as it:
            for e in it:
                if not e.name.endswith(".res"):
                    continue
                st = e.stat()
                entries.append((st.st_mtime, st.st_size, e.path))
                total += st.st_size
        if total <= budget:
            return
        entries.sort()
        for _, size, path in entries:
            try:
                os.unlink(path)
                counters.inc("persist.result_evictions")
                total -= size
            except OSError:
                continue
            if total <= budget:
                break
    except OSError as e:
        _log.debug("result sweep failed: %s", e)


def save_result(fingerprint: str, blocks: List[Any]) -> bool:
    """Persist one result (the parked forms of its blocks) under its
    portable plan fingerprint."""
    d = _subdir(_RES_DIR)
    if d is None:
        return False
    from .checkpoint import _park
    try:
        stats = {"moved": 0}
        parked = [_strip_devices(_park(b, stats)) for b in blocks]
        payload = pickle.dumps({"version": 1, "blocks": parked},
                               protocol=pickle.HIGHEST_PROTOCOL)
    except Exception as e:
        counters.inc("persist.write_errors")
        _log.warning("result %s not picklable: %s", fingerprint[:16], e)
        return False
    path = os.path.join(d, _safe_name(fingerprint) + ".res")
    if not _atomic_write(path, _pack(payload)):
        return False
    counters.inc("persist.result_writes")
    _sweep_results(d)
    return True


def load_result(fingerprint: str) -> Optional[List[Any]]:
    """The persisted blocks for ``fingerprint``, or ``None`` (cold)."""
    d = _subdir(_RES_DIR)
    if d is None:
        return None
    rec = _read(os.path.join(d, _safe_name(fingerprint) + ".res"))
    if not isinstance(rec, dict) or rec.get("version") != 1:
        return None
    from .checkpoint import _restore
    try:
        blocks = [_restore(b) for b in rec["blocks"]]
    except Exception as e:
        counters.inc("persist.read_errors")
        _log.warning("result %s restore failed: %s — treating as cold",
                     fingerprint[:16], e)
        return None
    counters.inc("persist.result_loads")
    return blocks


# -- performance-sentinel baselines ---------------------------------------

def save_baseline(fingerprint: str, payload: dict) -> bool:
    """Persist one plan fingerprint's rolling cost baseline (its caller
    owns the payload shape). Best-effort like everything here: a failure
    degrades that fingerprint's regression detector to an in-memory
    re-warm after restart."""
    d = _subdir(_BL_DIR)
    if d is None:
        return False
    try:
        blob = pickle.dumps({"version": 1, "baseline": payload},
                            protocol=pickle.HIGHEST_PROTOCOL)
    except Exception as e:
        counters.inc("persist.write_errors")
        _log.warning("baseline %s not picklable: %s", fingerprint[:16], e)
        return False
    path = os.path.join(d, _safe_name(fingerprint) + ".perf")
    if not _atomic_write(path, _pack(blob)):
        return False
    counters.inc("persist.baseline_writes")
    return True


def load_baseline(fingerprint: str) -> Optional[dict]:
    """The persisted baseline payload for ``fingerprint``, or ``None``
    (cold — the detector re-warms from live completions)."""
    d = _subdir(_BL_DIR)
    if d is None:
        return None
    rec = _read(os.path.join(d, _safe_name(fingerprint) + ".perf"))
    if not isinstance(rec, dict) or rec.get("version") != 1:
        return None
    payload = rec.get("baseline")
    if not isinstance(payload, dict):
        return None
    counters.inc("persist.baseline_loads")
    return payload


# -- introspection --------------------------------------------------------

def _dir_stats(kind: str, suffix: str) -> Tuple[int, int]:
    base = root()
    if base is None:
        return (0, 0)
    d = os.path.join(base, kind)
    n = total = 0
    try:
        with os.scandir(d) as it:
            for e in it:
                if e.name.endswith(suffix):
                    n += 1
                    total += e.stat().st_size
    except OSError:
        return (0, 0)
    return (n, total)


def stats() -> dict:
    """Tier snapshot: what is on disk right now."""
    ckpt_n, ckpt_b = _dir_stats(_CKPT_DIR, ".ckpt")
    res_n, res_b = _dir_stats(_RES_DIR, ".res")
    bl_n, bl_b = _dir_stats(_BL_DIR, ".perf")
    return {
        "enabled": enabled(),
        "dir": root(),
        "checkpoints": ckpt_n,
        "checkpoint_bytes": ckpt_b,
        "results": res_n,
        "result_bytes": res_b,
        "baselines": bl_n,
        "baseline_bytes": bl_b,
    }
