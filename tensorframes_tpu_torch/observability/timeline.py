"""Always-on bounded telemetry timeline: a ring of periodic snapshots.

The port's counterpart of ``tensorframes_tpu/observability/timeline.py``.
Counters, gauges, histograms and ``metrics_text()`` answer "what is the
value now", never "what changed in the last N minutes". This module keeps
a small in-process history so that the question is answerable from a
REPL on the host:

- :func:`maybe_sample`: the one opportunistic hook. Callers on paths that
  are already slow (a stream's batch boundary, a metrics scrape) invite a
  sample, and one is taken only when ``TFT_TIMELINE_INTERVAL_S``
  (default 5 s) has passed since the last. No background thread: a quiet
  process takes no samples. Each sample snapshots every counter, every
  gauge's last value and every histogram family's ``(count, sum)``
  summed over its label sets into a bounded ring
  (``TFT_TIMELINE_SAMPLES``, default 720; overflow drops the oldest and
  counts the drop);
- :func:`timeline`: the sampled series of one family (a counter name or
  prefix, a gauge, a histogram family or ``<family>.count``) with
  consecutive deltas and per-second rates.

``TFT_TIMELINE=0`` turns sampling off at one environment check. The
ring's own health is scrapeable (``tft_timeline_*``). The knobs are read
through ``utils/env.py``.

The performance sentinel (``observability/baseline.py``) shares this
gate, and a served query's finish is one of the timeline's beats.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils import tracing
from ..utils.env import env_float, env_int

__all__ = ["enabled", "maybe_sample", "sample_now", "timeline",
           "families", "recent_samples", "stats", "clear"]


def enabled() -> bool:
    """``TFT_TIMELINE`` gate (default on)."""
    return os.environ.get("TFT_TIMELINE", "") not in ("0", "false")


def _interval_s() -> float:
    return max(env_float("TFT_TIMELINE_INTERVAL_S", 5.0), 0.0)


_lock = threading.Lock()
_ring: "deque[Dict[str, Any]]" = deque(
    maxlen=env_int("TFT_TIMELINE_SAMPLES", 720))
_taken = 0    # lifetime samples taken (the ring drops, this does not)
_dropped = 0  # oldest samples pushed out of the ring
_last_mono: float = float("-inf")


def _take_sample_locked() -> None:
    """Snapshot the tracing registries into one ring entry. The
    registries take their own finer locks; nothing takes the timeline
    lock while holding them, so the order is one-way."""
    global _taken, _dropped
    hist: Dict[str, Dict[str, float]] = {}
    for (fam, _labels), h in tracing.histograms.snapshot().items():
        agg = hist.setdefault(fam, {"count": 0, "sum": 0.0})
        agg["count"] += int(h["count"])
        agg["sum"] += float(h["sum"])
    gauges = {name: g["last"]
              for name, g in tracing.timings.gauges_snapshot().items()}
    sample = {"ts": time.time(),
              "counters": tracing.counters.snapshot(),
              "gauges": gauges,
              "hist": hist}
    if _ring.maxlen is not None and len(_ring) == _ring.maxlen:
        _dropped += 1
    _ring.append(sample)
    _taken += 1


def maybe_sample() -> bool:
    """Take one sample if the timeline is on and the interval has passed;
    returns whether one was taken. Off the interval it costs one
    monotonic read and one comparison after the environment check."""
    global _last_mono
    if not enabled():
        return False
    now = time.monotonic()
    if now - _last_mono < _interval_s():
        return False
    with _lock:
        if now - _last_mono < _interval_s():
            return False  # lost the race: another thread just sampled
        _last_mono = now
        _take_sample_locked()
    return True


def sample_now() -> bool:
    """Take a sample whatever the interval (still gated by
    ``TFT_TIMELINE=0``)."""
    global _last_mono
    if not enabled():
        return False
    with _lock:
        _last_mono = time.monotonic()
        _take_sample_locked()
    return True


def recent_samples(window_s: Optional[float] = None
                   ) -> List[Dict[str, Any]]:
    """The ring, oldest first; ``window_s`` keeps samples newer than that
    many seconds."""
    with _lock:
        out = list(_ring)
    if window_s is not None:
        cutoff = time.time() - float(window_s)
        out = [s for s in out if s["ts"] >= cutoff]
    return out


def _value_of(sample: Dict[str, Any], family: str) -> Optional[float]:
    """One family's value in one sample: an exact counter, the sum over a
    counter namespace (``"stream"`` sums ``stream.*``), a gauge's last
    value, a histogram family's sum, or its ``.count``."""
    counters = sample["counters"]
    if family in counters:
        return float(counters[family])
    prefix = family + "."
    matched = [v for k, v in counters.items() if k.startswith(prefix)]
    if matched:
        return float(sum(matched))
    if family in sample["gauges"]:
        return float(sample["gauges"][family])
    hist = sample["hist"]
    if family in hist:
        return float(hist[family]["sum"])
    if family.endswith(".count") and family[:-6] in hist:
        return float(hist[family[:-6]]["count"])
    return None


def timeline(family: str,
             window_s: Optional[float] = None) -> Dict[str, Any]:
    """The sampled series of ``family`` with consecutive deltas and
    per-second rates. Samples where the family had no value yet are
    skipped."""
    points = []
    for s in recent_samples(window_s):
        v = _value_of(s, family)
        if v is not None:
            points.append({"ts": s["ts"], "value": v})
    deltas = []
    for prev, cur in zip(points, points[1:]):
        dt = cur["ts"] - prev["ts"]
        dv = cur["value"] - prev["value"]
        deltas.append({"ts": cur["ts"], "delta": dv,
                       "rate_per_s": dv / dt if dt > 0 else 0.0})
    total = points[-1]["value"] - points[0]["value"] \
        if len(points) >= 2 else 0.0
    span = points[-1]["ts"] - points[0]["ts"] if len(points) >= 2 else 0.0
    return {"family": family, "samples": len(points), "points": points,
            "deltas": deltas, "total_delta": total,
            "rate_per_s": total / span if span > 0 else 0.0}


def families() -> List[str]:
    """Every family present in the newest sample."""
    with _lock:
        if not _ring:
            return []
        s = _ring[-1]
    return sorted(set(s["counters"]) | set(s["gauges"]) | set(s["hist"]))


def stats() -> Dict[str, Any]:
    with _lock:
        n = len(_ring)
        cap = _ring.maxlen
        taken, dropped = _taken, _dropped
        newest = _ring[-1]["ts"] if _ring else None
    age = max(time.time() - newest, 0.0) if newest is not None else None
    return {"enabled": enabled(), "samples": n, "capacity": cap,
            "taken_total": taken, "dropped_total": dropped,
            "interval_s": _interval_s(), "last_sample_age_s": age}


def clear() -> None:
    """Drop the ring, reset the lifetime totals and re-read
    ``TFT_TIMELINE_SAMPLES``."""
    global _ring, _taken, _dropped, _last_mono
    with _lock:
        _ring = deque(maxlen=env_int("TFT_TIMELINE_SAMPLES", 720))
        _taken = _dropped = 0
        _last_mono = float("-inf")


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _render_metrics() -> List[str]:
    # a scrape is itself a fine moment to sample: the endpoint is the
    # timeline's heartbeat on otherwise idle processes
    maybe_sample()
    s = stats()
    return [
        "# HELP tft_timeline_samples_total Telemetry timeline samples "
        "taken (lifetime; the ring holds the newest).",
        "# TYPE tft_timeline_samples_total counter",
        f"tft_timeline_samples_total {s['taken_total']}",
        "# HELP tft_timeline_ring_samples Samples currently held in "
        "the bounded timeline ring.",
        "# TYPE tft_timeline_ring_samples gauge",
        f"tft_timeline_ring_samples {s['samples']}",
        "# HELP tft_timeline_dropped_total Oldest samples dropped from "
        "the ring on overflow.",
        "# TYPE tft_timeline_dropped_total counter",
        f"tft_timeline_dropped_total {s['dropped_total']}",
    ]


def _register_metrics() -> None:
    from .metrics import register_metrics_provider
    register_metrics_provider("timeline", _render_metrics)
