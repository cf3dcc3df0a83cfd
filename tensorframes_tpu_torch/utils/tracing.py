"""Host-side spans and always-on counters.

The counterpart of ``tensorframes_tpu/utils/tracing.py``'s :func:`span`
and :data:`counters`. :func:`span` times a named stage into :data:`timings`
when tracing is on (``TFT_TRACE=1`` or :func:`enable`) and costs one global
read when it is off. :data:`counters` are always on.

Names keep the JAX package's. Spans: ``executor.convert`` (host->device,
opened only when some input is on the host), ``executor.dispatch``,
``executor.convert_back``, ``pipeline.submit`` / ``pipeline.drain``,
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
``relational.key_distinct_probes``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator

__all__ = ["Timings", "timings", "Counters", "counters", "span", "enable",
           "disable", "enabled"]


class Timings:
    """Thread-safe per-stage timing registry: ``{name: {count, total_s}}``."""

    def __init__(self):
        self._stats: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()

    def add(self, name: str, dt: float) -> None:
        with self._lock:
            s = self._stats.setdefault(name, {"count": 0, "total_s": 0.0})
            s["count"] += 1
            s["total_s"] += dt

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._stats.items()}

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


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

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


counters = Counters()

_enabled = os.environ.get("TFT_TRACE", "") not in ("", "0", "false")


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Time a named host stage; a no-op when tracing is off."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        timings.add(name, time.perf_counter() - t0)
