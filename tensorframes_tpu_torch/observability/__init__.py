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

- :mod:`.metrics`: :func:`metrics_text` renders the counters, spans,
  gauges, histograms and every registered provider (the flight
  recorder's, the memory ledger's, the timeline's, the live streams', the
  SLOs', the sentinel's, the history's, a live scheduler's) in the
  Prometheus text format; :func:`serve_metrics` serves it on loopback
  (``TFT_METRICS_PORT=<port>`` starts it at import);
- :mod:`.timeline`: the always-on bounded ring of periodic snapshots
  (:func:`timeline` answers deltas and rates over a window);
- :mod:`.report`: ``frame.explain()`` and :func:`last_query_report`;
- :mod:`.baseline`: the performance sentinel, per-query cost vectors,
  rolling per-fingerprint baselines and :func:`regressions`;
- :mod:`.slo`: per-tenant latency objectives, error budgets and burn
  rates (:func:`set_slo`, :func:`slo_status`, :func:`on_burn`);
- :mod:`.history`: the durable query history and crash post-mortems
  (``TFT_HISTORY_DIR``);
- :mod:`.decisions`: :func:`why` (one query's decision chain) and
  :func:`doctor` (the process triage report);
- :mod:`.health`: :func:`health`, one snapshot across the subsystems.

Zero cost when off: with ``TFT_TRACE`` unset :func:`query_trace` yields
``None`` and every hook is one ``None`` check. Importing this package
installs :func:`.events._on_span` as the span observer, so every span is
also credited to the active query's stage breakdown.

"""

from __future__ import annotations

import os

from ..utils import tracing as _tracing
from ..utils.logging import get_logger
from .events import (DEVICE_TRACK_BASE, Event, QueryTrace, add_event,
                     block_meta, bypass, clear_ring, current_trace,
                     last_query, query_trace, recent_events, traced_query,
                     wrap_context)
from . import device
from . import flight
from . import metrics
from . import slo
from . import timeline
from . import baseline
from . import history
from .baseline import perf_stats, regressions
from .decisions import doctor, why
from .health import health
from .metrics import metrics_port, metrics_text, serve_metrics, stop_metrics
from .report import frame_report, last_query_report, render
from .slo import SLO, on_burn, set_slo, slo_status

__all__ = [
    "Event", "QueryTrace", "query_trace", "current_trace", "add_event",
    "wrap_context", "traced_query", "last_query", "recent_events",
    "clear_ring", "block_meta", "bypass", "DEVICE_TRACK_BASE", "device",
    "flight", "metrics", "timeline", "metrics_text",
    "serve_metrics", "stop_metrics", "metrics_port",
    "frame_report", "last_query_report", "render",
    "slo", "why", "doctor", "health",
    "SLO", "set_slo", "slo_status", "on_burn",
    "baseline", "regressions", "perf_stats", "history",
]

_log = get_logger("observability")

# credit every span to the active query's stage breakdown as well as to
# the flat registry (one slot; this package owns it)
from .events import _on_span as _span_observer  # noqa: E402

_tracing.set_span_observer(_span_observer)

# the flight recorder's, the SLOs', the timeline's, the sentinel's and the
# history's families register once the provider registry exists
# (deferred: flight is imported by metrics' own import chain)
flight._register_metrics()
slo._register_metrics()
timeline._register_metrics()
baseline._register_metrics()
history._register_metrics()


def _maybe_autostart() -> None:
    """Opt-in metrics endpoint: ``TFT_METRICS_PORT=<port>`` starts the
    loopback server at import (``0`` picks a free port)."""
    raw = os.environ.get("TFT_METRICS_PORT")
    if not raw:
        return
    try:
        port = int(raw)
    except ValueError:
        _log.warning("ignoring malformed TFT_METRICS_PORT=%r", raw)
        return
    try:
        serve_metrics(port)
    except (OSError, OverflowError, ValueError) as e:
        # a bad env value must warn, never break the package's import
        _log.warning("metrics endpoint failed to start on port %s: %s",
                     raw, e)


_maybe_autostart()
