"""Query-scoped observability: correlated events, flight records, the
card's memory watermarks.

The port's counterpart of ``tensorframes_tpu/observability/__init__.py``,
for the part the engine's recovery calls:

- :mod:`.events`: :class:`QueryTrace` and contextvar correlation. Every
  forcing gets a query id; the engine, pipeline and resilience layers
  attach typed events (block submit/compute/drain, retries and giveups
  with their classified error, OOM splits, sync fallbacks, occupancy
  samples, memory samples). Finished traces land in a bounded ring and an
  optional JSONL file (``TFT_TRACE_FILE``);
  :meth:`QueryTrace.to_chrome_trace` exports a Perfetto timeline.
- :mod:`.device`: the card's memory watermarks from
  ``torch.cuda.memory_stats``, ``None`` on the CPU.
- :mod:`.flight`: the always-on flight recorder, a bounded ring of
  decisions (an OOM split, a plan handed back to the per-op path, a retry
  given up) with the inputs each was decided from.

Zero cost when off: with ``TFT_TRACE`` unset :func:`query_trace` yields
``None`` and every hook is one ``None`` check. Importing this package
installs :func:`.events._on_span` as the span observer, so every span is
also credited to the active query's stage breakdown.

Not in this package yet (``ROADMAP.md`` A11): the metrics endpoint and
Prometheus families, SLOs, the timeline, the performance baseline, the
durable history, ``why``/``doctor``, ``health`` and the text report.
"""

from __future__ import annotations

from ..utils import tracing as _tracing
from .events import (DEVICE_TRACK_BASE, Event, QueryTrace, add_event,
                     block_meta, bypass, clear_ring, current_trace,
                     last_query, query_trace, recent_events, traced_query,
                     wrap_context)
from . import device
from . import flight

__all__ = [
    "Event", "QueryTrace", "query_trace", "current_trace", "add_event",
    "wrap_context", "traced_query", "last_query", "recent_events",
    "clear_ring", "block_meta", "bypass", "DEVICE_TRACK_BASE", "device",
    "flight",
]

# credit every span to the active query's stage breakdown as well as to
# the flat registry (one slot; this package owns it)
from .events import _on_span as _span_observer  # noqa: E402

_tracing.set_span_observer(_span_observer)
