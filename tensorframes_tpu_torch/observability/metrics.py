"""Prometheus-text-format export of the tracing registries.

The port's counterpart of ``tensorframes_tpu/observability/metrics.py``.
:func:`metrics_text` renders the always-on counters, the span and gauge
statistics and the histogram families of :mod:`..utils.tracing` in the
Prometheus exposition format (text/plain; version=0.0.4), plus every
registered provider's lines; :func:`serve_metrics` serves it from a stdlib
``http.server`` endpoint, opt-in and on loopback only.

Families:

- ``tft_counter_total{name="..."}``: every named counter (retries, OOM
  splits, pipeline and stream totals);
- ``tft_span_seconds_count/_sum{span="..."}`` (summary): the per-stage
  span statistics, recorded while tracing is on;
- ``tft_gauge{name="...",stat="mean|min|max|last"}`` and
  ``tft_gauge_samples_total{name="..."}``: sampled levels (e.g.
  ``pipeline.occupancy``);
- histogram families (cumulative ``le`` buckets, ``_sum`` and
  ``_count``): ``tft_query_latency_seconds{op="...",outcome="ok|error"}``,
  observed at every traced query's finish;
- the providers' families: the flight recorder's (``tft_flight_*``), the
  memory manager's (``tft_memory_*``), the timeline's
  (``tft_timeline_*``), the live streams' (``tft_stream_*``), the SLOs'
  (``tft_serve_slo_*``), the sentinel's (``tft_perf_*``), the history's
  (``tft_history_*``), the relational layer's (``tft_relational_*``)
  and each live scheduler's (``tft_serve_*``);
- ``tft_trace_ring_events``: events currently buffered in the ring.

The endpoint binds ``127.0.0.1`` only: metric names leak workload
structure, so exposing them beyond the host is a reverse-proxy decision,
not a default. ``TFT_METRICS_PORT=<port>`` starts it at import (``0``
picks a free port; ``observability/__init__.py``).

Unlike the JAX package, spans carry no ``tft_span_seconds_min/_max``
gauges (the port's span registry keeps counts and sums only), and
``tft_compile_seconds{engine="torch"}`` observes what the port pays for a
new program (a capture's probes, a deserialized program's first
placement), where the JAX package observes XLA compiles.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..utils import tracing
from ..utils.logging import get_logger
from . import events as _events

__all__ = ["metrics_text", "serve_metrics", "stop_metrics", "metrics_port",
           "register_metrics_provider", "unregister_metrics_provider",
           "registered_providers"]

_log = get_logger("observability.metrics")

# extra exposition-line providers: name -> zero-arg callable returning a
# list of already-formatted lines. Providers render LIVE state (a
# stream's watermark, the ledger's resident bytes), which the counter and
# span registries cannot express.
_providers_lock = threading.Lock()
_providers: dict = {}


def register_metrics_provider(name: str, fn) -> None:
    """Add ``fn() -> list[str]`` to every :func:`metrics_text` render
    under ``name`` (re-registering a name replaces it). A provider that
    raises is logged and skipped: it can never take the endpoint down."""
    with _providers_lock:
        _providers[name] = fn


def unregister_metrics_provider(name: str) -> None:
    with _providers_lock:
        _providers.pop(name, None)


def registered_providers() -> list:
    """Names of every registered provider."""
    with _providers_lock:
        return sorted(_providers)


def _escape_label(value: str) -> str:
    """Prometheus label-value escaping: backslash, double quote and
    newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _num(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return format(v, ".10g")


def metrics_text() -> str:
    """The current counters, spans, gauges, histograms and provider lines
    in Prometheus text format."""
    lines = []
    counts = tracing.counters.snapshot()
    lines.append("# HELP tft_counter_total Always-on framework event "
                 "counters (retries, fallbacks, pipeline totals).")
    lines.append("# TYPE tft_counter_total counter")
    for name in sorted(counts):
        lines.append(f'tft_counter_total{{name="{_escape_label(name)}"}} '
                     f'{counts[name]}')

    spans = tracing.timings.snapshot()
    lines.append("# HELP tft_span_seconds Host wall time per traced "
                 "stage (recorded only while tracing is enabled).")
    lines.append("# TYPE tft_span_seconds summary")
    for name in sorted(spans):
        s = spans[name]
        lab = f'span="{_escape_label(name)}"'
        lines.append(f"tft_span_seconds_count{{{lab}}} {s['count']}")
        lines.append(f"tft_span_seconds_sum{{{lab}}} {_num(s['total_s'])}")

    gauges = tracing.timings.gauges_snapshot()
    lines.append("# HELP tft_gauge Sampled levels (window occupancy, "
                 "queue depths); dimensionless.")
    lines.append("# TYPE tft_gauge gauge")
    for name in sorted(gauges):
        g = gauges[name]
        lab = _escape_label(name)
        for stat in ("mean", "min", "max", "last"):
            lines.append(f'tft_gauge{{name="{lab}",stat="{stat}"}} '
                         f"{_num(g[stat])}")
    lines.append("# TYPE tft_gauge_samples_total counter")
    for name in sorted(gauges):
        lines.append(f'tft_gauge_samples_total{{name='
                     f'"{_escape_label(name)}"}} {gauges[name]["count"]}')

    lines.extend(_histogram_lines())

    with _providers_lock:
        providers = list(_providers.items())
    for pname, fn in providers:
        try:
            lines.extend(fn())
        except Exception as e:
            _log.warning("metrics provider %r failed (skipped this "
                         "scrape): %s", pname, e)

    lines.append("# HELP tft_trace_ring_events Events currently held in "
                 "the bounded trace ring buffer.")
    lines.append("# TYPE tft_trace_ring_events gauge")
    lines.append(f"tft_trace_ring_events {len(_events.recent_events())}")
    return "\n".join(lines) + "\n"


_HIST_HELP = {
    "query_latency_seconds":
        "Wall time of traced queries, by op (observed at query finish).",
}


def _histogram_lines() -> list:
    """Every :data:`~..utils.tracing.histograms` family in the Prometheus
    histogram convention: cumulative ``le`` buckets ending at ``+Inf``,
    then ``_sum`` and ``_count`` per label set."""
    hists = tracing.histograms.snapshot()
    lines: list = []
    for fam in sorted({k[0] for k in hists}):
        metric = f"tft_{fam}"
        help_text = _HIST_HELP.get(fam, "Bucketed observations (seconds).")
        lines.append(f"# HELP {metric} {help_text}")
        lines.append(f"# TYPE {metric} histogram")
        series = sorted((k for k in hists if k[0] == fam),
                        key=lambda k: k[1])
        for key in series:
            h = hists[key]
            labels = ",".join(f'{n}="{_escape_label(v)}"'
                              for n, v in key[1])
            sep = "," if labels else ""
            cum = 0
            for le, c in zip(h["les"], h["counts"]):
                cum += c
                le_s = "+Inf" if le == float("inf") else _num(le)
                lines.append(f'{metric}_bucket{{{labels}{sep}le='
                             f'"{le_s}"}} {cum}')
            brace = f"{{{labels}}}" if labels else ""
            lines.append(f"{metric}_sum{brace} {_num(h['sum'])}")
            lines.append(f"{metric}_count{brace} {h['count']}")
    return lines


# ---------------------------------------------------------------------------
# loopback HTTP endpoint
# ---------------------------------------------------------------------------

_server_lock = threading.Lock()
_server: Optional[ThreadingHTTPServer] = None
_thread: Optional[threading.Thread] = None


class _MetricsHandler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        if self.path.split("?", 1)[0].rstrip("/") in ("", "/metrics"):
            body = metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_error(404)

    def log_message(self, fmt, *args):  # route http.server chatter to us
        _log.debug("metrics endpoint: " + fmt, *args)


def serve_metrics(port: Optional[int] = None) -> int:
    """Start (or return) the loopback metrics endpoint; returns the bound
    port. ``port=0`` (the default) picks a free one. Always binds
    ``127.0.0.1``. Asking for a DIFFERENT specific port while the
    endpoint runs raises; :func:`stop_metrics` first to rebind."""
    global _server, _thread
    with _server_lock:
        if _server is not None:
            bound = _server.server_address[1]
            if port and port != bound:
                raise RuntimeError(
                    f"metrics endpoint already running on 127.0.0.1:"
                    f"{bound}; stop_metrics() before rebinding to "
                    f"{port}")
            return bound
        srv = ThreadingHTTPServer(("127.0.0.1", port or 0),
                                  _MetricsHandler)
        srv.daemon_threads = True
        t = threading.Thread(target=srv.serve_forever,
                             name="tft-metrics", daemon=True)
        t.start()
        _server, _thread = srv, t
        _log.info("metrics endpoint on http://127.0.0.1:%d/metrics",
                  srv.server_address[1])
        return srv.server_address[1]


def metrics_port() -> Optional[int]:
    """The running endpoint's port, or None."""
    with _server_lock:
        return _server.server_address[1] if _server is not None else None


def stop_metrics() -> None:
    """Shut the endpoint down (idempotent)."""
    global _server, _thread
    with _server_lock:
        srv, t = _server, _thread
        _server = _thread = None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if t is not None:
        t.join(timeout=5)
