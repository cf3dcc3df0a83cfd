"""Reading a ``torch.profiler`` trace of a run's window.

The harness opens a ``record_function`` range named :data:`WINDOW` around
the traced window; everything here is clipped to it. The port's spans
(``utils/tracing.py``) are ``record_function`` ranges too while its
tracing is on, so their host intervals are in the trace beside the
card's kernels and copies. Times are seconds.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW = "portbench.window"

Interval = Tuple[float, float]


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``(start, end)`` intervals as disjoint ones, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_seconds(intervals: Iterable[Interval]) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    return sum(e - s for s, e in merged(intervals))


def is_port_span(name: str) -> bool:
    """A span of the port (``executor.convert``), not an operator
    (``aten::mm``), a runtime call (``cudaMemcpyAsync``) or the window."""
    return ("." in name and "::" not in name and name != WINDOW
            and not name.startswith("cuda"))


class OpCall:
    """One call of an operator: its input shapes, its scalar inputs, its
    input dtypes (where the profiler records them) and the device seconds
    of every kernel launched under it."""

    __slots__ = ("shapes", "scalars", "dtypes", "device_s")

    def __init__(self, shapes, scalars, dtypes, device_s):
        self.shapes = shapes
        self.scalars = scalars
        self.dtypes = dtypes
        self.device_s = device_s


class TraceView:
    """Host ranges and device activity of one traced window."""

    def __init__(self, events: Sequence, op_names: Sequence[str] = ()):
        from torch.autograd import DeviceType

        host: List[Tuple[str, float, float]] = []
        device: List[Tuple[str, float, float]] = []
        window = None
        calls: Dict[str, list] = defaultdict(list)
        for e in events:
            s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type == DeviceType.CPU:
                if e.name == WINDOW:
                    window = (s, t)
                    continue
                host.append((e.name, s, t))
                if e.name in op_names:
                    calls[e.name].append((s, e))
            elif not (getattr(e, "is_user_annotation", False)
                      or e.name == WINDOW or is_port_span(e.name)):
                # a range's copy on the device's timeline is no activity
                device.append((e.name, s, t))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW!r} range")
        self.start, self.end = window
        w0, w1 = window
        self.host = [(n, max(s, w0), min(t, w1)) for n, s, t in host
                     if t > w0 and s < w1]
        self.device = [(n, max(s, w0), min(t, w1)) for n, s, t in device
                       if t > w0 and s < w1]
        self.calls: Dict[str, List[OpCall]] = {}
        for name, got in calls.items():
            self.calls[name] = [
                OpCall(list(e.input_shapes or []),
                       list(getattr(e, "concrete_inputs", None) or []),
                       list(getattr(e, "input_dtypes", None) or []),
                       e.device_time_total * 1e-6)
                for s, e in got if w0 <= s < w1]

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        """Seconds in which a kernel, copy or set ran on the device."""
        return union_seconds((s, t) for _, s, t in self.device)

    def span_intervals(self, names: Iterable[str]) -> List[Interval]:
        names = set(names)
        return [(s, t) for n, s, t in self.host if n in names]

    def span_seconds(self, names: Iterable[str]) -> float:
        """The union of the named spans' intervals in the window."""
        return union_seconds(self.span_intervals(names))

    def op_calls(self, name: str) -> List[OpCall]:
        return self.calls.get(name, [])

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time: ``[name, s]``
        (names cut to 160 characters; C++ kernel names run to thousands)."""
        by: Dict[str, float] = defaultdict(float)
        for n, s, t in self.device:
            by[n[:160]] += t - s
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The device's idle time in the window, summed by what the host
        was doing at each gap's middle (the innermost port span, and the
        innermost operator inside it where there is one): ``[name, s]``,
        the largest first."""
        busy = merged((s, t) for _, s, t in self.device)
        gaps, prev = [], self.start
        for s, t in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        if self.end > prev:
            gaps.append((prev, self.end))
        spans = sorted((s, t, n) for n, s, t in self.host if is_port_span(n))
        ops = sorted((s, t, n) for n, s, t in self.host
                     if not is_port_span(n))
        by: Dict[str, float] = defaultdict(float)
        mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
        span_at = _innermost(spans, [m for m, _ in mids])
        op_at = _innermost(ops, [m for m, _ in mids])
        for (m, length), sp, op in zip(mids, span_at, op_at):
            if sp and op:
                name = f"{sp} / {op}"
            else:
                name = sp or op or "host outside any range"
            by[name[:160]] += length
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]


def _innermost(intervals: List[Tuple[float, float, str]],
               points: List[float]) -> List[Optional[str]]:
    """For each point (ascending), the name of the interval that contains
    it and started last, or ``None``."""
    heap: List[Tuple[float, float, str]] = []  # (-start, end, name)
    out: List[Optional[str]] = []
    i = 0
    for p in points:
        while i < len(intervals) and intervals[i][0] <= p:
            s, t, n = intervals[i]
            heapq.heappush(heap, (-s, t, n))
            i += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out
