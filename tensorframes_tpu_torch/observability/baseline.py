"""Per-query cost attribution and rolling per-fingerprint baselines: the
performance sentinel.

The port's counterpart of ``tensorframes_tpu/observability/baseline.py``.

- :func:`capture`: the serve scheduler wraps every execution in one. It
  snapshots the always-on counters the engine keeps, accumulates the
  forcings' walls (:func:`note_stage_wall`, fed by the plan layer's
  feedback hook) and measured slot waits (:func:`note_wait`, fed by the
  pipeline's and the stream's slot leases), and at the finish assembles
  the **cost vector**: ``latency_s``, ``compile_s`` (the
  ``compile_seconds`` histogram's delta: capture's probes and a
  deserialized program's first placement, the port's cost of a new
  program), ``stage_wall_s``, ``slot_wait_s``, ``slot_waits``,
  ``admission_waits``, ``spill_bytes``, ``fault_bytes``, ``dispatches``,
  ``host_bytes``. Counter deltas are process-wide, so concurrent queries
  count into each other's vectors; the robust detector below tolerates
  that, and the timed components are attributed exactly.
- a rolling **baseline** per plan fingerprint
  (:func:`~..plan.adaptive.query_fingerprint`; a parquet-rooted
  fingerprint persists through ``memory/persist.py``, so a restart stays
  calibrated): an EWMA and a window of the last ``TFT_BASELINE_SAMPLES``
  (32) completions per component, armed after ``TFT_BASELINE_MIN`` (5)
  warm runs.
- a **regression detector**: a completion whose latency lies beyond
  ``TFT_REGRESSION_SIGMA`` (4.0) robust deviations
  (``|x - median| / (1.4826 * MAD + floor)``) above its baseline, and is
  slower both relatively (``TFT_REGRESSION_MIN_FRAC``, +50%) and
  absolutely (``TFT_REGRESSION_MIN_S``, 50 ms), flags a
  ``perf.regression`` flight anomaly naming the **most-moved component**,
  triggers ``flight.maybe_dump("regression")``, and shows in
  ``ttf.regressions()``, ``ttf.doctor()``, ``ttf.health()``'s warnings,
  ``serve_report()`` and the ``tft_perf_*`` metrics.

``TFT_TIMELINE=0`` turns the whole sentinel off (the gate is
:func:`.timeline.enabled`).
"""

from __future__ import annotations

import contextlib
import contextvars
import statistics
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..utils import tracing
from ..utils.env import env_float as _env_float
from ..utils.env import env_int as _env_int
from ..utils.logging import get_logger
from . import flight as _flight
from . import timeline as _timeline

__all__ = ["enabled", "capture", "note_stage_wall", "note_wait",
           "note_result_frame", "note_fingerprint", "finalize",
           "slow_context",
           "baseline_for", "regressions", "perf_stats", "clear"]

_log = get_logger("observability.baseline")


def enabled() -> bool:
    """The sentinel shares the timeline's ``TFT_TIMELINE=0`` gate: one
    knob turns off sampling, cost capture, and regression detection
    together, bit-identically."""
    return _timeline.enabled()


# the counter families a capture deltas; every one is always-on
_TRACKED = ("pipeline.slot_waits", "stream.slot_waits",
            "serve.admission_waits", "memory.spill_bytes",
            "memory.fault_bytes", "pipeline.submitted",
            "mesh.dispatches", "mesh.interstage_host_bytes")

# cost-vector component order (stable for rendering)
COMPONENTS = ("latency_s", "compile_s", "stage_wall_s", "slot_wait_s",
              "slot_waits", "admission_waits", "spill_bytes",
              "fault_bytes", "dispatches", "host_bytes")


def _compile_sum() -> float:
    """Summed ``compile_seconds`` over every label set (the always-on
    histogram), read in place: a full ``snapshot()`` would copy every
    histogram's buckets twice per query."""
    return float(tracing.histograms.family_sum("compile_seconds"))


class _Capture:
    """One query's in-flight cost accumulation (found by the hooks
    through the ambient contextvar, which ``wrap_context`` carries onto
    worker threads as it carries the flight scope)."""

    __slots__ = ("query_id", "tenant", "t0", "counters0", "compile0",
                 "stage_wall_s", "slot_wait_s", "fingerprint",
                 "portable", "lock")

    def __init__(self, query_id: str, tenant: Optional[str]) -> None:
        self.query_id = query_id
        self.tenant = tenant
        self.t0 = time.perf_counter()
        self.counters0 = tracing.counters.get_many(_TRACKED)
        self.compile0 = _compile_sum()
        self.stage_wall_s = 0.0
        self.slot_wait_s = 0.0
        self.fingerprint: Optional[str] = None
        self.portable = False
        self.lock = threading.Lock()

    def vector(self, latency_s: Optional[float] = None
               ) -> Dict[str, float]:
        snap = tracing.counters.get_many(_TRACKED)
        d = {k: snap[k] - self.counters0[k] for k in _TRACKED}
        with self.lock:
            stage, slot = self.stage_wall_s, self.slot_wait_s
        return {
            "latency_s": (time.perf_counter() - self.t0
                          if latency_s is None else float(latency_s)),
            "compile_s": max(_compile_sum() - self.compile0, 0.0),
            "stage_wall_s": stage,
            "slot_wait_s": slot,
            "slot_waits": float(d["pipeline.slot_waits"]
                                + d["stream.slot_waits"]),
            "admission_waits": float(d["serve.admission_waits"]),
            "spill_bytes": float(d["memory.spill_bytes"]),
            "fault_bytes": float(d["memory.fault_bytes"]),
            "dispatches": float(d["pipeline.submitted"]
                                + d["mesh.dispatches"]),
            "host_bytes": float(d["mesh.interstage_host_bytes"]),
        }


_active: "contextvars.ContextVar[Optional[_Capture]]" = \
    contextvars.ContextVar("tft_cost_capture", default=None)


@contextlib.contextmanager
def capture(query_id: str,
            tenant: Optional[str] = None) -> Iterator[None]:
    """Attribute everything the hooks see inside the body to this
    query. A query that exits without :func:`finalize` (error, requeue
    after preemption) simply discards its capture — partial runs must
    not calibrate baselines."""
    if not enabled():
        yield
        return
    token = _active.set(_Capture(str(query_id), tenant))
    try:
        yield
    finally:
        _active.reset(token)


def note_stage_wall(wall_s: float) -> None:
    """Accumulate one forcing's wall into the active capture (called by
    the plan layer's feedback hook, once a forcing, never per block)."""
    cap = _active.get()
    if cap is None:
        return
    with cap.lock:
        cap.stage_wall_s += float(wall_s)


def note_wait(seconds: float) -> None:
    """Accumulate one measured slot/lease wait (pipeline and stream
    slot leases call this only on their contended path)."""
    cap = _active.get()
    if cap is None:
        return
    with cap.lock:
        cap.slot_wait_s += float(seconds)


# fingerprint memo: a re-submitted frame OBJECT would re-walk the same
# chain at every completion, so cache per frame, keyed by its version
# counter (``uncache()`` invalidates). A leaf re-versioned under a
# long-lived chain object is not seen; that only mis-keys which baseline
# calibrates, never a query's result.
_fp_memo: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def note_result_frame(frame) -> None:
    """Fingerprint the finished query's result chain while the frame is
    still in hand (the scheduler calls this right after the thunk; by
    ``_finish`` time only the capture remembers it)."""
    cap = _active.get()
    if cap is None or frame is None:
        return
    ver = getattr(frame, "_version", 0)
    try:
        hit = _fp_memo.get(frame)
    except TypeError:  # unhashable/unweakrefable frame type
        hit = None
    if hit is not None and hit[0] == ver:
        cap.fingerprint, cap.portable = hit[1], hit[2]
        return
    try:
        from ..plan import adaptive as _adaptive
        fp = _adaptive.query_fingerprint(frame)
    except Exception as e:
        _log.debug("query fingerprint failed for %s: %s",
                   cap.query_id, e)
        return
    if fp is not None:
        cap.fingerprint, cap.portable = fp
        with contextlib.suppress(TypeError):
            _fp_memo[frame] = (ver, fp[0], fp[1])


def note_fingerprint(fingerprint: Optional[str], portable: bool) -> None:
    """Key the finished query's cost vector by a fingerprint taken before
    it ran: a served aggregate's result frame carries no chain, so the
    scheduler passes the one it took at submit
    (``plan.adaptive.aggregate_fingerprint``)."""
    cap = _active.get()
    if cap is None or fingerprint is None:
        return
    cap.fingerprint, cap.portable = fingerprint, bool(portable)


# ---------------------------------------------------------------------------
# rolling baselines
# ---------------------------------------------------------------------------

def _window_k() -> int:
    return max(_env_int("TFT_BASELINE_SAMPLES", 32), 2)


def _min_warm() -> int:
    return max(_env_int("TFT_BASELINE_MIN", 5), 2)


def _sigma() -> float:
    return max(_env_float("TFT_REGRESSION_SIGMA", 4.0), 0.5)


def _min_frac() -> float:
    """Relative guard: latency must exceed ``(1 + frac) * median``."""
    return max(_env_float("TFT_REGRESSION_MIN_FRAC", 0.5), 0.0)


def _min_delta_s() -> float:
    """Absolute guard: latency must exceed the median by this many
    seconds. Fast queries jitter by multiples of their own runtime
    (compile variance, scheduler noise) — a 16 ms query taking 50 ms is
    not an actionable regression, and without this floor it can clear
    both the sigma and the relative tests."""
    return max(_env_float("TFT_REGRESSION_MIN_S", 0.05), 0.0)


_EWMA_ALPHA = 0.2


def _floor(component: str) -> float:
    """Per-unit MAD floors so a perfectly stable component (MAD 0)
    cannot turn measurement jitter into infinite sigmas."""
    if component.endswith("_s"):
        return 0.005  # 5 ms: below scheduler/timer noise
    if component.endswith("_bytes"):
        return 4096.0
    return 1.0


class Baseline:
    """Rolling per-component statistics for one plan fingerprint.

    Concurrent serve workers finalize completions of the SAME
    fingerprint at once — every window read/write holds the
    per-baseline lock (a deque appended to mid-iteration raises)."""

    __slots__ = ("fingerprint", "portable", "count", "ewma", "window",
                 "updated_ts", "lock")

    def __init__(self, fingerprint: str, portable: bool) -> None:
        self.fingerprint = fingerprint
        self.portable = portable
        self.count = 0
        self.ewma: Dict[str, float] = {}
        self.window: Dict[str, deque] = {}
        self.updated_ts = 0.0
        self.lock = threading.Lock()

    def update(self, vec: Dict[str, float]) -> None:
        k = _window_k()
        with self.lock:
            for comp, x in vec.items():
                w = self.window.get(comp)
                if w is None or w.maxlen != k:
                    w = self.window[comp] = deque(w or (), maxlen=k)
                w.append(float(x))
                prev = self.ewma.get(comp)
                self.ewma[comp] = float(x) if prev is None else \
                    prev + _EWMA_ALPHA * (float(x) - prev)
            self.count += 1
            self.updated_ts = time.time()

    def deviation(self, comp: str, x: float) -> Tuple[float, float]:
        """``(robust_sigma, median)`` of ``x`` against this baseline's
        window for ``comp`` (0 sigma when the window is empty)."""
        with self.lock:
            w = self.window.get(comp)
            vals = list(w) if w else None
        if not vals:
            return 0.0, 0.0
        med = statistics.median(vals)
        mad = statistics.median(abs(v - med) for v in vals)
        scale = 1.4826 * mad + _floor(comp)
        return abs(float(x) - med) / scale, med

    def to_payload(self) -> Dict[str, Any]:
        with self.lock:
            return {"fingerprint": self.fingerprint,
                    "portable": self.portable, "count": self.count,
                    "ewma": dict(self.ewma),
                    "window": {c: list(w)
                               for c, w in self.window.items()},
                    "updated_ts": self.updated_ts}

    @classmethod
    def from_payload(cls, payload: Dict[str, Any]
                     ) -> Optional["Baseline"]:
        try:
            bl = cls(str(payload["fingerprint"]),
                     bool(payload.get("portable", True)))
            bl.count = int(payload.get("count", 0))
            bl.ewma = {str(c): float(v)
                       for c, v in payload.get("ewma", {}).items()}
            k = _window_k()
            bl.window = {
                str(c): deque((float(v) for v in vals), maxlen=k)
                for c, vals in payload.get("window", {}).items()}
            bl.updated_ts = float(payload.get("updated_ts", 0.0))
            return bl
        except (KeyError, TypeError, ValueError) as e:
            _log.warning("discarding malformed persisted baseline: %s",
                         e)
            return None


_bl_lock = threading.Lock()
_baselines: "OrderedDict[str, Baseline]" = OrderedDict()
_BASELINE_CAP = 512
_loaded_misses: set = set()  # portable fps whose disk load came back empty

_reg_lock = threading.Lock()
_regressions: "deque[Dict[str, Any]]" = deque(
    maxlen=_env_int("TFT_REGRESSIONS_RING", 256))
_completions = 0  # lifetime cost vectors folded into baselines
_reg_total = 0


def baseline_for(fingerprint: str) -> Optional[Baseline]:
    """The in-memory baseline for a fingerprint, falling through to the
    durable tier for portable fingerprints once per process."""
    with _bl_lock:
        bl = _baselines.get(fingerprint)
        if bl is not None:
            _baselines.move_to_end(fingerprint)
            return bl
        missed = fingerprint in _loaded_misses
    if missed:
        return None
    payload = _load_persisted(fingerprint)
    bl = Baseline.from_payload(payload) if payload else None
    with _bl_lock:
        if bl is not None and fingerprint not in _baselines:
            _admit_locked(fingerprint, bl)
        elif bl is None:
            _loaded_misses.add(fingerprint)
            if len(_loaded_misses) > 4096:
                _loaded_misses.clear()
        return _baselines.get(fingerprint)


def _admit_locked(fingerprint: str, bl: Baseline) -> None:
    _baselines[fingerprint] = bl
    _baselines.move_to_end(fingerprint)
    while len(_baselines) > _BASELINE_CAP:
        _baselines.popitem(last=False)


def _load_persisted(fingerprint: str) -> Optional[Dict[str, Any]]:
    try:
        from ..memory import persist as _persist
        if not _persist.enabled():
            return None
        return _persist.load_baseline(fingerprint)
    except Exception as e:
        _log.warning("baseline load for %s failed: %s",
                     fingerprint[:16], e)
        return None


def _save_persisted(bl: Baseline) -> None:
    if not bl.portable:
        return  # process-local fingerprints mean nothing after restart
    try:
        from ..memory import persist as _persist
        if _persist.enabled():
            _persist.save_baseline(bl.fingerprint, bl.to_payload())
    except Exception as e:
        _log.warning("baseline save for %s failed: %s",
                     bl.fingerprint[:16], e)


# ---------------------------------------------------------------------------
# finalize + regression detection
# ---------------------------------------------------------------------------

def finalize(latency_s: Optional[float] = None,
             outcome: str = "completed") -> Optional[Dict[str, Any]]:
    """Close out the active capture at a query's finish: assemble the
    cost vector, fold it into the fingerprint's baseline and run the
    regression check. Only completions calibrate: a shed, failed or
    preempted run's costs are not what the plan usually costs. Returns
    the cost vector (``None``: sentinel off, or no capture). Called by
    the serve scheduler's ``_finish``."""
    cap = _active.get()
    if cap is None:
        return None
    # this runs on the serving completion path after the caller's future
    # resolved: a fault here degrades to a log line, never to a failed
    # worker thread
    try:
        vec = cap.vector(latency_s)
        _timeline.maybe_sample()  # query finish: the timeline's beat
        if outcome != "completed" or cap.fingerprint is None:
            return vec
        global _completions
        fp = cap.fingerprint
        bl = baseline_for(fp)
        regression = None
        if bl is None:
            bl = Baseline(fp, cap.portable)
            with _bl_lock:
                existing = _baselines.get(fp)
                if existing is not None:
                    bl = existing
                else:
                    _admit_locked(fp, bl)
        elif bl.count >= _min_warm():
            regression = _check_regression(bl, vec, cap)
        bl.update(vec)
        with _reg_lock:
            _completions += 1
        _save_persisted(bl)
        if regression is not None:
            _flag_regression(regression)
        return vec
    except Exception as e:  # noqa: BLE001 - never break the query
        _log.warning("sentinel finalize failed for query %s: %s",
                     cap.query_id, e)
        return None


def _check_regression(bl: Baseline, vec: Dict[str, float],
                      cap: _Capture) -> Optional[Dict[str, Any]]:
    lat = vec["latency_s"]
    # O(1) pre-gate on the EWMA before any window sort: the guards below
    # demand +frac relative AND +delta absolute over the window MEDIAN,
    # so a completion under HALF those margins over the EWMA cannot pass
    # them unless the EWMA drifted ~20% above the median; the common
    # healthy completion skips the median and MAD sorts
    with bl.lock:
        ew = bl.ewma.get("latency_s")
    if ew is not None and (lat <= ew * (1.0 + 0.5 * _min_frac())
                           or lat - ew <= 0.5 * _min_delta_s()):
        return None
    sigma = _sigma()
    z_lat, med_lat = bl.deviation("latency_s", lat)
    # three guards, all required: statistically extreme (sigma),
    # relatively large (frac) and absolutely large (seconds); the last two
    # keep a fast query's jitter from tripping an always-on alarm
    if z_lat <= sigma or lat <= med_lat:
        return None  # got FASTER beyond sigma: fine, not a regression
    if lat <= med_lat * (1.0 + _min_frac()):
        return None
    if lat - med_lat <= _min_delta_s():
        return None
    # most-moved component: the largest robust deviation among the
    # components that INCREASED, which is the "why"
    best = ("latency_s", z_lat, med_lat, vec["latency_s"])
    for comp in COMPONENTS:
        if comp == "latency_s":
            continue
        z, med = bl.deviation(comp, vec[comp])
        if vec[comp] > med and z > best[1]:
            best = (comp, z, med, vec[comp])
    comp, z, base, obs = best
    return {"ts": time.time(), "query": cap.query_id,
            "tenant": cap.tenant, "fingerprint": bl.fingerprint,
            "component": comp, "baseline": round(base, 6),
            "observed": round(obs, 6), "sigma": round(z, 2),
            "latency_s": round(vec["latency_s"], 6),
            "baseline_latency_s": round(med_lat, 6),
            "latency_sigma": round(z_lat, 2), "runs": bl.count}


def _flag_regression(reg: Dict[str, Any]) -> None:
    global _reg_total
    with _reg_lock:
        _regressions.append(reg)
        _reg_total += 1
    tracing.counters.inc("perf.regressions")
    inputs = {k: v for k, v in reg.items()
              if k not in ("ts", "query", "fingerprint")}
    inputs["fingerprint"] = reg["fingerprint"][:16]
    _flight.record("perf.regression", query=reg["query"], **inputs)
    _flight.maybe_dump("regression")
    _log.warning(
        "perf regression: query %s (plan %s) latency %.3fs vs baseline "
        "%.3fs (%.1f sigma); most-moved: %s %.6g -> %.6g (%.1f sigma)",
        reg["query"], reg["fingerprint"][:16], reg["latency_s"],
        reg["baseline_latency_s"], reg["latency_sigma"],
        reg["component"], reg["baseline"], reg["observed"],
        reg["sigma"])


def regressions(limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """Flagged regressions, oldest first (``ttf.regressions()``);
    ``limit`` keeps the newest N."""
    with _reg_lock:
        out = list(_regressions)
    if limit is not None and len(out) > limit:
        out = out[-limit:]
    return out


def slow_context() -> Optional[Dict[str, Any]]:
    """The active capture's live cost preview for the slow-query line:
    the partial vector, the fingerprint (when known) and the worst
    in-flight deviation against the stored baseline, so a
    ``TFT_SLOW_QUERY_MS`` line explains itself."""
    cap = _active.get()
    if cap is None:
        return None
    vec = cap.vector()
    out: Dict[str, Any] = {
        "cost": {k: round(v, 6) for k, v in vec.items()}}
    if cap.fingerprint is None:
        return out
    out["fingerprint"] = cap.fingerprint[:16]
    with _bl_lock:
        bl = _baselines.get(cap.fingerprint)
    if bl is not None and bl.count >= _min_warm():
        worst = None
        for comp in COMPONENTS:
            z, med = bl.deviation(comp, vec[comp])
            if vec[comp] > med and (worst is None or z > worst[1]):
                worst = (comp, z, med, vec[comp])
        if worst is not None:
            out["baseline_deviation"] = {
                "component": worst[0], "sigma": round(worst[1], 2),
                "baseline": round(worst[2], 6),
                "observed": round(worst[3], 6)}
    return out


def perf_stats() -> Dict[str, Any]:
    """The sentinel's health snapshot (``ttf.health()['perf']``)."""
    with _bl_lock:
        n_bl = len(_baselines)
        warm = sum(1 for b in _baselines.values()
                   if b.count >= _min_warm())
    with _reg_lock:
        regs = list(_regressions)
        total = _reg_total
        comps = _completions
    recent = [{"query": r["query"], "fingerprint": r["fingerprint"][:16],
               "component": r["component"], "sigma": r["sigma"],
               "ts": r["ts"]} for r in regs[-5:]]
    return {"enabled": enabled(), "baselines": n_bl,
            "warm_baselines": warm, "completions_total": comps,
            "regressions_total": total, "recent_regressions": recent,
            "timeline": _timeline.stats()}


def clear() -> None:
    """Drop baselines, regressions, and the loaded-miss memo (tests);
    re-reads the ring-size knobs."""
    global _regressions, _completions, _reg_total
    with _bl_lock:
        _baselines.clear()
        _loaded_misses.clear()
    with _reg_lock:
        _regressions = deque(maxlen=_env_int("TFT_REGRESSIONS_RING",
                                             256))
        _completions = 0
        _reg_total = 0


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _render_metrics() -> List[str]:
    s = perf_stats()
    return [
        "# HELP tft_perf_baselines Plan fingerprints with a rolling "
        "cost baseline in memory.",
        "# TYPE tft_perf_baselines gauge",
        f"tft_perf_baselines {s['baselines']}",
        "# HELP tft_perf_warm_baselines Baselines warm enough to arm "
        "the regression detector.",
        "# TYPE tft_perf_warm_baselines gauge",
        f"tft_perf_warm_baselines {s['warm_baselines']}",
        "# HELP tft_perf_completions_total Query completions folded "
        "into cost baselines.",
        "# TYPE tft_perf_completions_total counter",
        f"tft_perf_completions_total {s['completions_total']}",
        "# HELP tft_perf_regressions_total Completions flagged beyond "
        "TFT_REGRESSION_SIGMA of their baseline.",
        "# TYPE tft_perf_regressions_total counter",
        f"tft_perf_regressions_total {s['regressions_total']}",
    ]


def _register_metrics() -> None:
    # deferred: metrics imports events, which imports flight
    from .metrics import register_metrics_provider
    register_metrics_provider("perf", _render_metrics)
