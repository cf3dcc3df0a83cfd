"""The port's metrics exposition and telemetry timeline against the JAX
package's: ``tests/test_observability.py``'s
``test_metrics_text_parses_as_prometheus`` and
``test_endpoint_serves_metrics_on_loopback``, and
``tests/test_sentinel.py::TestTimeline``.

Each case drives both packages the same way (the JAX package on the CPU
with x64, the port on the CPU) and compares what they expose: the lines
of ``metrics_text()`` (every one parses as Prometheus text; the same
counter, span and gauge samples), the endpoint's answers, and the
timeline's samples, deltas and ring statistics.
"""

import re
import urllib.error
import urllib.request

import numpy as np
import pytest

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import observability as jobs
from tensorframes_tpu.observability import timeline as jtimeline
from tensorframes_tpu.utils import tracing as jtracing
from tensorframes_tpu_torch import observability as tobs
from tensorframes_tpu_torch.observability import timeline as ttimeline
from tensorframes_tpu_torch.utils import tracing as ttracing

pytestmark = pytest.mark.observability

PKGS = {"jax": (jtf, jobs, jtimeline, jtracing),
        "torch": (ttf, tobs, ttimeline, ttracing)}

_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*='
    r'"(?:[^"\\\n]|\\["\\n])*"(,[a-zA-Z_][a-zA-Z0-9_]*='
    r'"(?:[^"\\\n]|\\["\\n])*")*\})? '
    r'(-?\d+(\.\d+)?([eE][+-]?\d+)?|[+-]Inf|NaN)$')


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("TFT_TIMELINE", "TFT_TIMELINE_INTERVAL_S",
                "TFT_TIMELINE_SAMPLES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TFT_ADAPTIVE", "0")
    monkeypatch.setenv("TFT_RESULT_CACHE", "0")
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    for _, obs, tl, tracing in PKGS.values():
        tracing.disable()
        tracing.timings.reset()
        tracing.counters.reset()
        tracing.histograms.reset()
        obs.clear_ring()
        tl.clear()
    yield
    for _, obs, tl, tracing in PKGS.values():
        tracing.disable()
        tracing.timings.reset()
        tracing.counters.reset()
        tracing.histograms.reset()
        obs.clear_ring()
        tl.clear()
    ttf.set_default_device(prev)


# ---------------------------------------------------------------------------
# Prometheus metrics
# ---------------------------------------------------------------------------

class TestMetrics:
    def test_metrics_text_parses_as_prometheus(self, monkeypatch):
        monkeypatch.setenv("TFT_PIPELINE_DEPTH", "3")
        texts = {}
        for name, (m, obs, _tl, tracing) in PKGS.items():
            tracing.enable()
            df = m.frame({"x": np.arange(30.0)}, num_partitions=6)
            df.map_blocks(lambda x: {"y": x + 1.0}).blocks()
            tracing.disable()
            text = obs.metrics_text()
            assert text.endswith("\n")
            for line in text.splitlines():
                if not line or line.startswith("#"):
                    continue
                assert _PROM_LINE.match(line), line
            assert 'tft_counter_total{name="pipeline.submitted"} 6' \
                in text
            assert 'tft_span_seconds_count{span="pipeline.submit"} 6' \
                in text
            assert 'tft_gauge{name="pipeline.occupancy",stat="mean"}' \
                in text
            assert "tft_trace_ring_events" in text
            texts[name] = text

        def samples(text, prefix):
            return sorted(ln for ln in text.splitlines()
                          if ln.startswith(prefix))

        # the same pipeline counters, span counts and occupancy gauges
        for prefix in ('tft_counter_total{name="pipeline.',
                       'tft_span_seconds_count{span="pipeline.',
                       'tft_gauge{name="pipeline.occupancy"',
                       "tft_timeline_ring"):
            assert samples(texts["torch"], prefix) \
                == samples(texts["jax"], prefix), prefix
        # the flight recorder's family (its totals are the process's
        # lifetime, so only the series are compared)
        for text in texts.values():
            assert [ln.split(" ")[0] for ln in
                    samples(text, "tft_flight_")] == [
                "tft_flight_dump_evictions_total", "tft_flight_dumps_total",
                "tft_flight_records_total", "tft_flight_ring_records"]

    def test_endpoint_serves_metrics_on_loopback(self):
        for _m, obs, _tl, tracing in PKGS.values():
            tracing.counters.inc("endpoint.smoke")
            port = obs.serve_metrics(0)
            try:
                assert obs.metrics_port() == port
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics",
                        timeout=10) as r:
                    assert r.status == 200
                    assert "text/plain" in r.headers["Content-Type"]
                    body = r.read().decode()
                assert 'tft_counter_total{name="endpoint.smoke"} 1' in body
                with pytest.raises(urllib.error.HTTPError):
                    urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/nope", timeout=10)
            finally:
                obs.stop_metrics()
            assert obs.metrics_port() is None


# ---------------------------------------------------------------------------
# timeline ring
# ---------------------------------------------------------------------------

class TestTimeline:
    def test_sample_now_and_query(self, monkeypatch):
        monkeypatch.setenv("TFT_TIMELINE_INTERVAL_S", "0")
        out = {}
        for name, (m, _obs, tl, tracing) in PKGS.items():
            tracing.counters.inc("sentineltest.widgets", 5)
            assert tl.sample_now()
            tracing.counters.inc("sentineltest.widgets", 7)
            assert tl.sample_now()
            series = m.timeline("sentineltest.widgets")
            assert "sentineltest.widgets" in tl.families()
            out[name] = (series["samples"], series["deltas"][-1]["delta"],
                         series["total_delta"],
                         [p["value"] for p in series["points"]])
        assert out["torch"] == out["jax"] == (2, 7, 7, [5.0, 12.0])

    def test_prefix_aggregation(self, monkeypatch):
        monkeypatch.setenv("TFT_TIMELINE_INTERVAL_S", "0")
        out = {}
        for name, (m, _obs, tl, tracing) in PKGS.items():
            # the namespace exists (at 0) in the first sample: counters
            # start from zero here, and a sample without the family is
            # skipped
            tracing.counters.inc("sentineltest.a", 0)
            assert tl.sample_now()
            tracing.counters.inc("sentineltest.a", 3)
            tracing.counters.inc("sentineltest.b", 4)
            assert tl.sample_now()
            out[name] = m.timeline("sentineltest")["deltas"][-1]["delta"]
        assert out["torch"] == out["jax"] == 7

    def test_ring_is_bounded(self, monkeypatch):
        monkeypatch.setenv("TFT_TIMELINE_INTERVAL_S", "0")
        monkeypatch.setenv("TFT_TIMELINE_SAMPLES", "4")
        out = {}
        for name, (_m, _obs, tl, _tracing) in PKGS.items():
            tl.clear()
            for _ in range(10):
                assert tl.sample_now()
            st = tl.stats()
            out[name] = (st["samples"], st["capacity"], st["taken_total"],
                         st["dropped_total"])
        assert out["torch"] == out["jax"] == (4, 4, 10, 6)

    def test_interval_gates_maybe_sample(self, monkeypatch):
        monkeypatch.setenv("TFT_TIMELINE_INTERVAL_S", "3600")
        out = {}
        for name, (_m, _obs, tl, _tracing) in PKGS.items():
            tl.clear()
            first = tl.maybe_sample()
            later = [tl.maybe_sample() for _ in range(5)]
            out[name] = (first, later, tl.stats()["samples"])
        assert out["torch"] == out["jax"] == (True, [False] * 5, 1)

    def test_window_filter(self, monkeypatch):
        monkeypatch.setenv("TFT_TIMELINE_INTERVAL_S", "0")
        out = {}
        for name, (_m, _obs, tl, _tracing) in PKGS.items():
            assert tl.sample_now()
            assert tl.sample_now()
            out[name] = (len(tl.recent_samples()) >= 2,
                         tl.recent_samples(window_s=0.0))
        assert out["torch"] == out["jax"] == (True, [])
