"""Host-side spans, gauges, always-on counters and histograms.

The counterpart of ``tensorframes_tpu/utils/tracing.py``'s :func:`span`,
:func:`gauge`, :data:`counters`, :data:`histograms` and
:func:`set_span_observer`. :func:`span` times a named stage into
:data:`timings` when tracing is on (``TFT_TRACE=1`` or :func:`enable`) and
costs one global read when it is off; while it times, it also opens a
``torch.profiler.record_function`` range, so host stages line up with the
card's kernels in a ``torch.profiler`` trace, and it credits the stage to
the active query trace through the span observer that
``observability`` installs. :func:`gauge` samples a level (the pipeline's
window occupancy) under the same switch; gauges keep their own stat family
(:meth:`Timings.gauges_snapshot`: ``count``/``mean``/``min``/``max``/
``last``), apart from the spans' ``count``/``total_s``. :data:`counters`
and :data:`histograms` are always on. :func:`profile` records a
``torch.profiler`` trace of a body with the spans on; :func:`dump_stats`
prints spans, gauges and counters in one report.

Names keep the JAX package's. Spans: ``executor.convert`` (host->device,
opened only when some input is on the host), ``executor.dispatch``,
``executor.convert_back``, ``executor.stage_out`` (a block's outputs into
pinned host buffers, their non-blocking copies and the event, opened only
when the outputs leave a card for the host), ``computation.capture`` (a
new program's output-shape probes; a cached program opens none),
``daggregate.keyed_sum`` (every shard's ``[groups, ...]`` table of a mesh
aggregate, without its collective), ``pipeline.submit`` / ``pipeline.drain``,
``plan.execute`` (one fused forcing), ``io.parquet_read`` (one row group
decoded), ``aggregate.factorize_keys`` / ``aggregate.segment_reduce`` /
``aggregate.sketch_fold``, ``join.probe`` (one probe block joined),
``join.match`` (its host key match) and ``join.probe_gather`` (its device
gather), and ``join.sort_merge`` (one sort-merge join run).
Counters: ``pipeline.submitted`` / ``pipeline.drained``,
``plan.fused_queries``, ``plan.oom_fallbacks``,
``plan.pushdown_groups_skipped`` / ``plan.pushdown_bytes_skipped``,
``io.parquet_row_groups_read`` / ``io.parquet_bytes_read`` (the footer's
uncompressed bytes of the column chunks a scan decoded), and
``relational.broadcast_joins`` / ``relational.sort_merge_joins`` (joins
defined), ``relational.probe_dispatches`` (gather programs run),
``relational.rows_joined``, ``relational.sketch_folds`` and
``relational.key_distinct_probes``; the resilience layer's
``retry.<op>.retries`` / ``retry.<op>.giveups``, ``deadline.<op>.expired``,
``oom_split.dispatches``, ``pipeline.sync_fallbacks`` and
``faults.<site>.injected``; ``trace.queries``. Spans of the recovery:
``executor.oom_split`` and ``resilience.<op>.attempt``. Gauge:
``pipeline.occupancy``. Histograms: ``query_latency_seconds`` (by ``op``
and ``outcome``; served queries also by ``tenant``) and
``compile_seconds`` (by ``engine``: what the port pays for a new program
signature, a capture's probes and a deserialized program's first
placement on a device).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Dict, Iterator, Optional

from .logging import get_logger

__all__ = ["Timings", "timings", "Counters", "counters", "Histograms",
           "histograms", "span", "gauge", "enable", "disable", "enabled",
           "set_span_observer", "dump_stats", "profile"]

_log = get_logger("utils.tracing")


class _GaugeStat:
    """Stats of a sampled level: unit-less, with the newest sample."""

    __slots__ = ("count", "total", "min", "max", "last")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.last = 0.0

    def add(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.last = value

    def as_dict(self) -> Dict[str, float]:
        return {"count": self.count,
                "mean": self.total / self.count if self.count else 0.0,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "last": self.last}


class Timings:
    """Thread-safe per-stage timing registry: ``{name: {count, total_s}}``,
    and the gauges beside it."""

    def __init__(self):
        self._stats: Dict[str, Dict[str, float]] = {}
        self._gauges: Dict[str, _GaugeStat] = {}
        self._lock = threading.Lock()

    def add(self, name: str, dt: float) -> None:
        with self._lock:
            s = self._stats.setdefault(name, {"count": 0, "total_s": 0.0})
            s["count"] += 1
            s["total_s"] += dt

    def add_gauge(self, name: str, value: float) -> None:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = _GaugeStat()
            g.add(value)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """The spans (gauges are in :meth:`gauges_snapshot`)."""
        with self._lock:
            return {k: dict(v) for k, v in self._stats.items()}

    def gauges_snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: v.as_dict() for k, v in self._gauges.items()}

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._gauges.clear()

    def report(self, include_counters: bool = True) -> str:
        """One human-readable report: spans, gauges and (by default) the
        always-on :data:`counters`."""
        spans = self.snapshot()
        gauges = self.gauges_snapshot()
        counts = counters.snapshot() if include_counters else {}
        if not spans and not gauges and not counts:
            return "(no spans recorded; enable tracing first)"
        lines = []
        if spans:
            width = max(len(k) for k in spans)
            lines.append("%-*s %8s %12s %12s" % (width, "span", "count",
                                                 "total_s", "mean_s"))
            for name in sorted(spans, key=lambda k: -spans[k]["total_s"]):
                s = spans[name]
                lines.append("%-*s %8d %12.6f %12.6f"
                             % (width, name, s["count"], s["total_s"],
                                s["total_s"] / max(s["count"], 1)))
        else:
            lines.append("(no spans recorded; enable tracing first)")
        if gauges:
            width = max(len(k) for k in gauges)
            lines.append("")
            lines.append("%-*s %8s %12s %12s %12s" % (width, "gauge",
                                                      "count", "mean",
                                                      "max", "last"))
            for name in sorted(gauges):
                g = gauges[name]
                lines.append("%-*s %8d %12.4f %12.4f %12.4f"
                             % (width, name, g["count"], g["mean"],
                                g["max"], g["last"]))
        if counts:
            width = max(len(k) for k in counts)
            lines.append("")
            lines.append("%-*s %8s" % (width, "counter", "value"))
            for name in sorted(counts):
                lines.append("%-*s %8d" % (width, name, counts[name]))
        return "\n".join(lines)


timings = Timings()


class Counters:
    """Thread-safe named event counters, always on."""

    def __init__(self):
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def get_many(self, names) -> Dict[str, int]:
        """Several counters in one consistent read."""
        with self._lock:
            return {n: self._counts.get(n, 0) for n in names}

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


counters = Counters()


# Default histogram buckets (seconds), the JAX package's: per-query
# latencies from sub-millisecond to tens of seconds. Each bucket holds its
# own (non-cumulative) count.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class _Hist:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = len(self.buckets)
        for j, le in enumerate(self.buckets):
            if value <= le:
                i = j
                break
        self.counts[i] += 1
        self.sum += value
        self.count += 1

    def as_dict(self) -> Dict[str, object]:
        return {"les": self.buckets + (float("inf"),),
                "counts": list(self.counts), "sum": self.sum,
                "count": self.count}


class Histograms:
    """Thread-safe histogram registry, always on like :class:`Counters`
    (observations are rare: one per finished query). Keyed by
    ``(family, sorted labels)``."""

    def __init__(self):
        self._hists: Dict[tuple, _Hist] = {}
        self._lock = threading.Lock()

    def observe(self, family: str, value: float, buckets=None,
                **labels) -> None:
        key = (family, tuple(sorted(labels.items())))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Hist(buckets or DEFAULT_BUCKETS)
            h.observe(float(value))

    def snapshot(self) -> Dict[tuple, Dict[str, object]]:
        with self._lock:
            return {k: v.as_dict() for k, v in self._hists.items()}

    def family_sum(self, family: str) -> float:
        """The summed observations of one family over every label set,
        read in place (the per-query cost capture reads the
        ``compile_seconds`` total at every served query's start and
        finish)."""
        with self._lock:
            return sum(h.sum for (fam, _), h in self._hists.items()
                       if fam == family)

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()


histograms = Histograms()


def dump_stats(file=None) -> None:
    """Print spans, gauges and counters in one report
    (``ttf.dump_stats()``)."""
    print(timings.report(include_counters=True), file=file)

_enabled = os.environ.get("TFT_TRACE", "") not in ("", "0", "false")


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


# the observability layer's per-query stage attribution, called as
# (name, dt_seconds) at the end of every recorded span; one slot, set at
# import of tensorframes_tpu_torch.observability
_span_observer: Optional[Callable[[str, float], None]] = None


def set_span_observer(fn: Optional[Callable[[str, float], None]]) -> None:
    global _span_observer
    _span_observer = fn


def _device_annotation(name: str):
    """A ``torch.profiler`` range for the span (a no-op unless a profiler
    records)."""
    from torch.profiler import record_function
    return record_function(name)


# what span() returns while tracing is off: one shared context that does
# nothing, so an untraced stage costs a global read and no allocation
_NULL_SPAN = contextlib.nullcontext()


def span(name: str):
    """Time a named host stage; a no-op when tracing is off.

    The profiler range is decoration: one that fails to open or to close
    neither loses the host timing nor masks the body's own exception."""
    if not _enabled:
        return _NULL_SPAN
    return _timed_span(name)


@contextlib.contextmanager
def _timed_span(name: str) -> Iterator[None]:
    ann = _device_annotation(name)
    try:
        ann.__enter__()
    except Exception as e:
        _log.debug("profiler range enter failed for %s: %s", name, e)
        ann = None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        timings.add(name, dt)
        obs = _span_observer
        if obs is not None:
            obs(name, dt)
        if ann is not None:
            try:
                ann.__exit__(None, None, None)
            except Exception as e:
                _log.debug("profiler range exit failed for %s: %s", name,
                           e)


def gauge(name: str, value: float) -> None:
    """Sample a level into :data:`timings`' gauges (for example the
    pipeline's in-flight window into ``pipeline.occupancy``); a no-op
    unless tracing is on."""
    if _enabled:
        timings.add_gauge(name, float(value))


@contextlib.contextmanager
def profile(log_dir: str, host_spans: bool = True):
    """Record a ``torch.profiler`` trace of the body into ``log_dir`` as a
    Chrome trace (``trace.json``), with the CUDA activity when CUDA is
    initialized, and the host spans on for the same window (each span is
    also a ``record_function`` range in the trace). Yields the profiler,
    whose ``key_averages()`` hold the device time once the body is done.

    A profiler that fails to stop is logged, never raised: it must not
    mask the body's own exception, nor fail a body that succeeded."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    was = _enabled
    prof.__enter__()  # before enable(): a failure here must not leave
    if host_spans:    # spans on for good
        enable()
    try:
        yield prof
    finally:
        if not was:
            disable()
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        except Exception as e:
            _log.error("torch.profiler stop failed (trace in %s may be "
                       "incomplete): %s", log_dir, e)
        else:
            _log.info("profile written to %s", log_dir)
