"""The port's query events, flight recorder and memory watermarks against
the JAX package's.

Mirrors ``tests/test_observability.py``'s ``TestCorrelation``,
``TestChromeTrace``, ``TestZeroCostWhenOff`` and
``TestTracingExceptionSafety`` (its two ``span`` cases; ``profile`` is not
ported yet), and ``tests/test_flight.py``'s ``TestRing``, ``TestZeroCost``
and ``TestDumps`` (but the cases of layers not ported yet: ``tft.why``,
streams, the mesh's device loss). Where a query runs, the same inputs and
fault schedule go through both packages, and the event types each trace
records are compared; the JAX package's ``compile`` and
``compile_cache`` events have no counterpart (eager PyTorch compiles
nothing per shape).
"""

import json
import re
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import observability as jobs
from tensorframes_tpu.observability import device as jobs_device
from tensorframes_tpu.observability import events as jobs_events
from tensorframes_tpu.resilience import faults as jfaults
from tensorframes_tpu.utils import tracing as jtracing
from tensorframes_tpu_torch import observability as obs
from tensorframes_tpu_torch import resilience as rz
from tensorframes_tpu_torch.engine.executor import BlockExecutor
from tensorframes_tpu_torch.observability import device as obs_device
from tensorframes_tpu_torch.observability import events as obs_events
from tensorframes_tpu_torch.observability import flight
from tensorframes_tpu_torch.resilience import faults
from tensorframes_tpu_torch.utils import tracing

_ENV = ("TFT_FLIGHT", "TFT_FLIGHT_DUMP", "TFT_FLIGHT_RING", "TFT_TRACE_FILE",
        "TFT_TRACE_FILE_MAX_BYTES", "TFT_SLOW_QUERY_MS", "TFT_HISTORY_DIR",
        "TFT_PIPELINE_DEPTH")

# event types of the JAX package's jit compile cache
_ONLY_JAX_EVENTS = {"compile", "compile_cache"}


def _reset_all():
    for tr in (tracing, jtracing):
        tr.disable()
        tr.timings.reset()
        tr.counters.reset()
        tr.histograms.reset()
    for o, ev, dev in ((obs, obs_events, obs_device),
                       (jobs, jobs_events, jobs_device)):
        o.clear_ring()
        ev._reset_last_query()
        dev._reset()
    flight.clear()
    faults.reset()
    jfaults.reset()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("TFT_RETRY_BASE_DELAY", "0.001")
    monkeypatch.setenv("TFT_RETRY_MAX_DELAY", "0.01")
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    _reset_all()
    yield
    _reset_all()
    ttf.set_default_device(prev)


def _depth(monkeypatch, d):
    monkeypatch.setenv("TFT_PIPELINE_DEPTH", str(d))


def _traced_map(monkeypatch, n=30, parts=6, depth=3, m=ttf):
    _depth(monkeypatch, depth)
    (tracing if m is ttf else jtracing).enable()
    df = m.frame({"x": np.arange(float(n))}, num_partitions=parts)
    out = df.map_blocks(lambda x: {"y": x + 1.0})
    out.blocks()
    return df, out, out._trace


def _event_types(trace):
    return sorted(e.etype for e in trace.events
                  if e.etype not in _ONLY_JAX_EVENTS)


# ---------------------------------------------------------------------------
# correlation / context propagation
# ---------------------------------------------------------------------------

class TestCorrelation:
    def test_forcing_opens_query_trace(self, monkeypatch):
        _, out, t = _traced_map(monkeypatch)
        assert t is not None
        assert t.op == "map_blocks"
        assert re.fullmatch(r"q\d+", t.query_id)
        assert t.duration is not None and t.duration >= 0
        assert t.meta["plan"] == out._plan

    def test_query_ids_unique_per_query(self, monkeypatch):
        _, _, t1 = _traced_map(monkeypatch)
        _, _, t2 = _traced_map(monkeypatch)
        assert t1.query_id != t2.query_id

    def test_nested_forcings_join_outer_query(self, monkeypatch):
        # a per-op chain forces upstream frames inside one query: exactly
        # ONE trace, owned by the outermost forcing
        _depth(monkeypatch, 3)
        monkeypatch.setenv("TFT_FUSE", "0")
        tracing.enable()
        df = ttf.frame({"x": np.arange(20.0)}, num_partitions=4)
        mid = df.map_blocks(lambda x: {"y": x + 1.0})
        top = mid.map_blocks(lambda y: {"z": y * 2.0})
        top.blocks()
        assert top._trace is not None
        assert mid._trace is None  # joined the ambient query
        assert obs.last_query() is top._trace

    def test_query_id_survives_worker_threads(self):
        tracing.enable()
        with obs.query_trace("threaded") as t:
            with ThreadPoolExecutor(max_workers=2) as pool:
                fs = [pool.submit(obs.wrap_context(obs.current_trace))
                      for _ in range(4)]
                seen = [f.result() for f in fs]
            # an unwrapped hop must not see the trace
            with ThreadPoolExecutor(max_workers=1) as pool:
                bare = pool.submit(obs.current_trace).result()
        assert all(s is t for s in seen)
        assert bare is None

    def test_worker_thread_events_attach_to_query(self, monkeypatch):
        """An executor that dispatches on its own worker thread, through
        wrap_context, records events on the submitting query's trace."""
        _depth(monkeypatch, 3)
        tracing.enable()
        inner = BlockExecutor()
        worker_qids = []

        class ThreadedExecutor:
            def __init__(self):
                self._pool = ThreadPoolExecutor(max_workers=1)

            def resolve(self):
                return inner.resolve()

            def run(self, comp, arrays, row_local=False, keep_device=False):
                return inner.run(comp, arrays, row_local=row_local)

            def submit(self, comp, arrays, row_local=False):
                def work():
                    t = obs.current_trace()
                    worker_qids.append(t.query_id if t else None)
                    obs.add_event("worker_dispatch")
                    return inner.run(comp, arrays, row_local=row_local)

                fut = self._pool.submit(obs.wrap_context(work))

                class P:
                    def drain(self):
                        return fut.result()

                return P()

        df = ttf.frame({"x": np.arange(24.0)}, num_partitions=6)
        out = df.map_blocks(lambda x: {"y": x - 1.0},
                            executor=ThreadedExecutor())
        got = np.concatenate([b.columns["y"] for b in out.blocks()])
        np.testing.assert_array_equal(got, np.arange(24.0) - 1.0)
        t = out._trace
        assert t is not None
        assert worker_qids == [t.query_id] * 6
        assert t.count("worker_dispatch") == 6

    @pytest.mark.parametrize("op", ["reduce_blocks", "reduce_rows",
                                    "aggregate"])
    def test_eager_ops_record_last_query(self, monkeypatch, op):
        _depth(monkeypatch, 3)
        traces = {}
        for m, o, tr in ((jtf, jobs, jtracing), (ttf, obs, tracing)):
            tr.enable()
            df = m.frame({"x": np.arange(12.0), "k": np.arange(12) % 4},
                         num_partitions=3)
            if op == "reduce_blocks":
                m.reduce_blocks(lambda x_input: {"x": x_input.sum(0)},
                                df.select(["x"]))
            elif op == "reduce_rows":
                m.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2},
                              df.select(["x"]))
            else:  # eager: its result holds its blocks
                m.aggregate({"x": "sum"}, df.group_by("k"))
            tr.disable()
            traces[m] = o.last_query()
        assert traces[ttf] is not None and traces[ttf].op == op
        assert traces[ttf].op == traces[jtf].op
        assert _event_types(traces[ttf]) == _event_types(traces[jtf])
        # report() renders through observability/report.py in both
        # packages: the rows and resilience lines agree
        reports = {m: traces[m].report() for m in (jtf, ttf)}

        def key_lines(r):
            return [ln for ln in r.splitlines()
                    if ln.startswith(("  rows ", "  resilience:"))]

        assert key_lines(reports[ttf]) == key_lines(reports[jtf])
        assert reports[ttf].startswith(f"query {traces[ttf].query_id} · {op}")

    def test_flight_records_correlate_to_the_trace(self, monkeypatch):
        """Decisions made inside a traced query carry its id (the port
        scopes the flight ring with the trace's id)."""
        _depth(monkeypatch, 1)
        tracing.enable()
        df = ttf.frame({"x": np.arange(16.0)}, num_partitions=1)
        out = df.map_rows(lambda x: {"y": x * 3.0})
        with faults.inject("oom", fail_n=2):
            out.blocks()
        t = out._trace
        recs = flight.for_query(t.query_id)
        assert [r["kind"] for r in recs] == ["engine.oom_split"] * 2
        assert [r["rows"] for r in recs] == [16, 8]
        with flight.scope("outer"):
            with obs.query_trace("inner") as t2:
                flight.record("test.kind")
        assert flight.for_query("outer") and not flight.for_query(
            t2.query_id)


# ---------------------------------------------------------------------------
# event parity on the recovery paths
# ---------------------------------------------------------------------------

class TestRecoveryEvents:
    @pytest.mark.parametrize("site,fail_n,depth", [
        ("oom", 1, 1), ("oom", 3, 2), ("drain", 1, 3), ("compile", 2, 1),
        ("dispatch", 4, 3)])
    def test_same_event_types_as_the_reference(self, monkeypatch, site,
                                               fail_n, depth):
        _depth(monkeypatch, depth)
        traces, counts = {}, {}
        for m, f, tr in ((jtf, jfaults, jtracing), (ttf, faults, tracing)):
            tr.enable()
            df = m.frame({"x": np.arange(16.0)}, num_partitions=2)
            out = df.map_rows(lambda x: {"y": x + 2.0})
            with f.inject(site, fail_n=fail_n):
                out.blocks()
            tr.disable()
            traces[m] = out._trace
            counts[m] = traces[m].summary()
        assert _event_types(traces[ttf]) == _event_types(traces[jtf])
        for key in ("blocks", "rows_in", "rows_out", "retries", "giveups",
                    "oom_splits", "sync_fallbacks", "events"):
            if key == "events":
                continue
            assert counts[ttf][key] == counts[jtf][key], key
        for ev in traces[ttf].events:
            if ev.etype == "oom_split":
                assert ev.args["error"] == "InjectedFault"
            if ev.etype == "retry":
                assert ev.args["kind"] == "transient"

    def test_oom_split_tagged_with_watermark(self, monkeypatch):
        _on_fake_cards(monkeypatch, [_FakeDevice(111, 222)])
        tracing.enable()
        df = ttf.frame({"x": np.arange(16.0)}, num_partitions=1)
        out = df.map_rows(lambda x: {"y": x * 3.0})
        with faults.inject("oom", fail_n=1):
            out.blocks()
        t = out._trace
        splits = [e for e in t.events if e.etype == "oom_split"]
        assert splits and splits[0].args["hbm_peak_bytes"] == 222
        assert splits[0].args["hbm_live_bytes"] == 111
        rec = flight.recent("engine.oom_split")[-1]
        assert rec["hbm_live_bytes"] == 111 and rec["query"] == t.query_id

    def test_giveup_event_and_flight_record(self, monkeypatch):
        monkeypatch.setenv("TFT_RETRY_MAX_ATTEMPTS", "2")
        _depth(monkeypatch, 1)
        tracing.enable()
        df = ttf.frame({"x": np.arange(4.0)}, num_partitions=1)
        out = df.map_blocks(lambda x: {"y": x + 1.0})
        with faults.inject("dispatch", fail_n=10):
            with pytest.raises(rz.InjectedFault):
                out.blocks()
        t = obs.last_query()
        assert t.meta["error"] == "InjectedFault"
        assert [e.etype for e in t.events if e.etype in
                ("retry", "giveup")] == ["retry", "giveup"]
        give = flight.recent("resilience.giveup")[-1]
        assert give["attempts"] == 2 and give["error_kind"] == "transient"
        h = tracing.histograms.snapshot()
        assert (("query_latency_seconds",
                 (("op", "map_blocks"), ("outcome", "error")))) in h


# ---------------------------------------------------------------------------
# chrome trace export
# ---------------------------------------------------------------------------

class TestChromeTrace:
    def test_chrome_trace_valid_and_sorted(self, monkeypatch, tmp_path):
        _, out, t = _traced_map(monkeypatch, n=30, parts=6, depth=3)
        path = tmp_path / "trace.json"
        text = t.to_chrome_trace(file=str(path))
        doc = json.loads(text)
        assert json.loads(path.read_text()) == doc
        evs = doc["traceEvents"]
        assert evs, "no events exported"
        for e in evs:
            for field in ("ph", "ts", "pid", "tid"):
                assert field in e, (field, e)
        ts = [e["ts"] for e in evs]
        assert ts == sorted(ts)

    def test_per_block_events_on_slot_tracks_share_query_id(
            self, monkeypatch):
        _, out, t = _traced_map(monkeypatch, n=30, parts=6, depth=3)
        _, _, jt = _traced_map(monkeypatch, n=30, parts=6, depth=3, m=jtf)
        docs = {}
        for name, tr in (("torch", t), ("jax", jt)):
            doc = json.loads(tr.to_chrome_trace())
            evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
            assert {e["args"]["query_id"] for e in evs} == {tr.query_id}
            by_cat = {}
            for e in evs:
                by_cat.setdefault(e.get("cat"), []).append(e)
            docs[name] = (doc, by_cat)
        doc, by_cat = docs["torch"]
        assert len(by_cat["block_submit"]) == 6
        assert len(by_cat["block_compute"]) == 6
        assert len(by_cat["block_drain"]) == 6
        block_tids = {e["tid"] for cat in ("block_submit", "block_drain")
                      for e in by_cat[cat]}
        assert block_tids == {1, 2, 3}
        jcats = {c: len(v) for c, v in docs["jax"][1].items()
                 if c not in _ONLY_JAX_EVENTS}
        assert {c: len(v) for c, v in by_cat.items()} == jcats
        names = {e["args"]["name"] for e in doc["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "thread_name"}
        assert {"query", "slot 0", "slot 1", "slot 2"} <= names

    def test_serial_depth_records_block_runs(self, monkeypatch):
        _, out, t = _traced_map(monkeypatch, n=12, parts=3, depth=1)
        assert t.count("block_run") == 3
        s = t.summary()
        assert s["blocks"] == 3 and s["rows_in"] == 12


# ---------------------------------------------------------------------------
# zero cost when off
# ---------------------------------------------------------------------------

class TestZeroCostWhenOff:
    def test_no_events_recorded_with_tracing_disabled(self, monkeypatch):
        _depth(monkeypatch, 3)
        assert not tracing.enabled()
        df = ttf.frame({"x": np.arange(20.0)}, num_partitions=4)
        out = df.map_blocks(lambda x: {"y": x + 1.0})
        out.blocks()
        ttf.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, df)
        assert out._trace is None
        assert obs.last_query() is None
        assert obs.recent_events() == []
        assert obs.current_trace() is None
        assert tracing.timings.snapshot() == {}
        assert tracing.timings.gauges_snapshot() == {}

    def test_add_event_without_trace_is_noop(self):
        obs.add_event("orphan", detail="nothing listens")
        assert obs.recent_events() == []

    def test_bypass_strips_layer_even_when_enabled(self):
        tracing.enable()
        with obs_events.bypass():
            with obs.query_trace("stripped") as t:
                assert t is None
        assert obs.last_query() is None

    def test_no_memory_stats_calls_with_tracing_off(self, monkeypatch):
        calls = []

        def probed():
            calls.append(1)
            return []

        monkeypatch.setattr(obs_device, "_local_devices", probed)
        obs_device._reset()
        df = ttf.frame({"x": np.arange(8.0)}, num_partitions=2)
        df.map_blocks(lambda x: {"y": x + 1.0}).blocks()
        assert calls == []


# ---------------------------------------------------------------------------
# the card's memory watermarks
# ---------------------------------------------------------------------------

class _FakeDevice:
    def __init__(self, live, peak, limit=0):
        self._stats = {"bytes_in_use": live, "peak_bytes_in_use": peak,
                       "bytes_limit": limit}

    def memory_stats(self):
        return self._stats


def _on_fake_cards(monkeypatch, cards):
    """Fake visible cards, and a query on the CPU read as if its work ran
    on all of them (a reading for the CPU covers no card otherwise)."""
    monkeypatch.setattr(obs_device, "_local_devices", lambda: cards)
    monkeypatch.setattr(obs_device, "_covered",
                        lambda device, n: list(range(n)))
    obs_device._reset()


class TestDeviceMemory:
    def test_cpu_is_a_graceful_none_and_latches(self):
        tracing.enable()
        with obs.query_trace("probe") as t:
            assert obs_device.sample(t, "probe") is None
        assert not obs_device.supported()
        assert obs_device.watermark() is None
        assert t.count("hbm_sample") == 0

    def test_fake_devices_record_watermarks(self, monkeypatch):
        _on_fake_cards(monkeypatch, [_FakeDevice(100, 300, 1000),
                                     _FakeDevice(50, 200, 1000)])
        assert obs_device.watermark() == {"live_bytes": 150,
                                          "peak_bytes": 500,
                                          "limit_bytes": 2000,
                                          "devices": 2}
        tracing.enable()
        df = ttf.frame({"x": np.arange(8.0)}, num_partitions=2)
        out = df.map_blocks(lambda x: {"y": x + 1.0})
        out.blocks()
        s = out._trace.summary()
        assert s["hbm"] == {"live_start": 150, "live_end": 150,
                            "peak": 500}
        per_dev = [e for e in out._trace.events if e.etype == "hbm_sample"
                   and (e.args or {}).get("device") is not None]
        assert {e.args["device"] for e in per_dev} == {0, 1}
        assert {e.track for e in per_dev} == {obs.DEVICE_TRACK_BASE,
                                              obs.DEVICE_TRACK_BASE + 1}

    def test_a_reading_covers_the_work_s_card_only(self, monkeypatch):
        """A reading names the device the work runs on: the CPU reads no
        card, ``cuda:1`` reads card 1 only, and no device reads them all.
        A query on the CPU with cards present records no card readings,
        on its trace or on its OOM split."""
        monkeypatch.setattr(obs_device, "_local_devices",
                            lambda: [_FakeDevice(100, 300, 1000),
                                     _FakeDevice(50, 200, 1000)])
        obs_device._reset()
        assert obs_device.watermark("cpu") is None
        assert obs_device.watermark("cuda:1") == {"live_bytes": 50,
                                                  "peak_bytes": 200,
                                                  "limit_bytes": 1000,
                                                  "devices": 1}
        assert obs_device.watermark()["devices"] == 2
        tracing.enable()
        out = ttf.frame({"x": np.arange(16.0)}, num_partitions=1).map_rows(
            lambda x: {"y": x * 3.0})
        with faults.inject("oom", fail_n=1):
            out.blocks()
        t = out._trace
        assert t.count("hbm_sample") == 0
        assert t.summary()["hbm"] is None
        splits = [e for e in t.events if e.etype == "oom_split"]
        assert len(splits) == 1 and "hbm_live_bytes" not in splits[0].args
        assert obs_device.supported()

    def test_a_card_not_yet_touched_reports_none_without_latching(
            self, monkeypatch):
        class Untouched:
            def memory_stats(self):
                return None

        monkeypatch.setattr(obs_device, "_local_devices",
                            lambda: [Untouched()])
        obs_device._reset()
        assert obs_device.raw_memory_stats() is None
        assert obs_device.supported()


# ---------------------------------------------------------------------------
# the unported parts raise, never skip silently
# ---------------------------------------------------------------------------

class TestNotYetPorted:
    def test_history_dir_raises(self, monkeypatch, tmp_path):
        """``TFT_HISTORY_DIR`` on a traced query raised while the durable
        history was not ported; now the forcing archives one record,
        which the JAX package's reader returns too."""
        from tensorframes_tpu.observability import history as jhistory
        from tensorframes_tpu_torch.observability import history

        monkeypatch.setenv("TFT_HISTORY_DIR", str(tmp_path))
        history.clear()
        jhistory.clear()
        tracing.enable()
        df = ttf.frame({"x": np.arange(4.0)})
        out = df.map_blocks(lambda x: {"y": x + 1.0})
        out.blocks()
        recs = history.history()
        assert [r["query"] for r in recs] == [out._trace.query_id]
        assert recs[0]["source"] == "trace"
        assert recs[0]["outcome"] == "ok"
        assert recs[0]["summary"] == "map_blocks"
        assert jhistory.history() == recs
        history.clear()
        jhistory.clear()


# ---------------------------------------------------------------------------
# tracing exception safety
# ---------------------------------------------------------------------------

class TestTracingExceptionSafety:
    def test_span_survives_annotation_exit_failure(self, monkeypatch):
        class EvilAnnotation:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                raise RuntimeError("annotation teardown exploded")

        monkeypatch.setattr(tracing, "_device_annotation",
                            lambda name: EvilAnnotation())
        tracing.enable()
        with tracing.span("guarded"):
            pass
        assert tracing.timings.snapshot()["guarded"]["count"] == 1

    def test_span_survives_annotation_enter_failure(self, monkeypatch):
        class Unenterable:
            def __enter__(self):
                raise RuntimeError("no profiler running")

            def __exit__(self, *exc):
                raise AssertionError("never entered, never exited")

        monkeypatch.setattr(tracing, "_device_annotation",
                            lambda name: Unenterable())
        tracing.enable()
        with tracing.span("guarded2"):
            pass
        assert tracing.timings.snapshot()["guarded2"]["count"] == 1

    def test_span_body_error_is_not_masked_and_still_timed(self):
        tracing.enable()
        with pytest.raises(ValueError, match="body failed"):
            with tracing.span("failing"):
                raise ValueError("body failed")
        assert tracing.timings.snapshot()["failing"]["count"] == 1

    def test_spans_credit_the_active_query(self, monkeypatch):
        _, out, t = _traced_map(monkeypatch, n=12, parts=3, depth=3)
        assert t.stages["executor.dispatch"][0] == 3
        assert t.stages["pipeline.submit"][0] == 3


# ---------------------------------------------------------------------------
# the flight ring
# ---------------------------------------------------------------------------

def _frame(n=16, parts=4):
    return ttf.frame({"x": np.arange(float(n))}, num_partitions=parts)


class TestRing:
    def test_ring_bounds_and_eviction_order(self, monkeypatch):
        monkeypatch.setenv("TFT_FLIGHT_RING", "8")
        flight.clear()
        for i in range(20):
            flight.record("test.kind", i=i)
        recs = flight.recent("test.kind")
        assert len(recs) == 8
        assert [r["i"] for r in recs] == list(range(12, 20))
        seqs = [r["seq"] for r in recs]
        assert seqs == sorted(seqs)

    def test_records_carry_inputs_and_scope(self):
        with flight.scope("q-scope"):
            assert flight.current_query() == "q-scope"
            flight.record("test.decision", estimate=100, observed=412,
                          threshold=4.0)
        assert flight.current_query() is None
        recs = flight.for_query("q-scope")
        assert len(recs) == 1
        r = recs[0]
        assert r["estimate"] == 100 and r["observed"] == 412
        assert r["threshold"] == 4.0
        assert r["query"] == "q-scope"
        assert "ts" in r and "seq" in r

    def test_scope_survives_worker_threads(self):
        got = {}

        def work():
            flight.record("test.threaded")
            got["q"] = flight.current_query()

        with flight.scope("q-thread"):
            t = threading.Thread(target=obs.wrap_context(work))
            t.start()
            t.join()
        assert got["q"] == "q-thread"
        assert flight.for_query("q-thread")

    def test_kind_filter_is_namespace_aware(self):
        flight.record("mesh.shrink", device=1)
        flight.record("mesh.grow", devices=[1])
        flight.record("meshy.other")
        assert {r["kind"] for r in flight.recent("mesh")} == \
            {"mesh.shrink", "mesh.grow"}
        assert len(flight.recent("mesh.shrink")) == 1
        assert len(flight.recent(limit=2)) == 2

    def test_bypass_is_total(self, monkeypatch):
        monkeypatch.setenv("TFT_FLIGHT", "0")
        flight.record("test.kind", x=1)
        assert flight.recent() == []
        assert flight.dump(reason="manual") is None
        assert flight.stats()["enabled"] is False

    def test_flight_off_forcing_bit_identical(self, monkeypatch):
        _depth(monkeypatch, 1)
        df_on = _frame(32, 8).map_rows(lambda x: {"z": x * 2.0})
        with faults.inject("oom", fail_n=1):
            on = [np.asarray(b.columns["z"]) for b in df_on.blocks()]
        assert flight.recent("engine.oom_split")
        monkeypatch.setenv("TFT_FLIGHT", "0")
        df_off = _frame(32, 8).map_rows(lambda x: {"z": x * 2.0})
        with faults.inject("oom", fail_n=1):
            off = [np.asarray(b.columns["z"]) for b in df_off.blocks()]
        assert len(on) == len(off)
        for a, b in zip(on, off):
            assert a.dtype == b.dtype and np.array_equal(a, b)

    def test_worker_id_tags_records(self):
        prev = flight.set_worker_id("w7")
        try:
            flight.record("test.kind")
            assert flight.recent("test.kind")[-1]["worker"] == "w7"
            with flight.scope("q", worker="w9"):
                flight.record("test.kind")
            assert flight.recent("test.kind")[-1]["worker"] == "w9"
        finally:
            flight.set_worker_id(prev)


class TestZeroCost:
    def test_no_ring_writes_from_per_block_paths(self):
        before = flight.stats()["recorded_total"]
        _frame(64, 16).map_rows(lambda x: {"z": x + 1.0}).blocks()
        ttf.aggregate({"x": "sum"}, ttf.frame(
            {"x": np.arange(64.0), "k": np.arange(64) % 5},
            num_partitions=4).group_by("k")).blocks()
        after = flight.stats()["recorded_total"]
        assert after == before, flight.recent(limit=10)


# ---------------------------------------------------------------------------
# dumps: slow query, giveup, rotation
# ---------------------------------------------------------------------------

def _parse_dump(path):
    lines = path.read_text().splitlines()
    assert lines, "dump file is empty"
    recs = [json.loads(ln) for ln in lines]
    heads = [r for r in recs if r.get("type") == "flight_dump"]
    assert heads, "no flight_dump header line"
    return heads, recs


class TestDumps:
    def test_manual_dump_parseable_jsonl(self, tmp_path):
        flight.record("test.kind", detail="with \"quotes\" and\nnewline")
        out = tmp_path / "flight.jsonl"
        assert flight.dump(str(out), reason="manual") == str(out)
        heads, recs = _parse_dump(out)
        assert heads[0]["reason"] == "manual"
        assert heads[0]["records"] == 1
        assert any(r.get("kind") == "test.kind" for r in recs)
        assert flight.load_dumps(str(out))[0]["kind"] == "test.kind"

    def test_dump_on_slow_query(self, tmp_path, monkeypatch):
        out = tmp_path / "dump.jsonl"
        monkeypatch.setenv("TFT_FLIGHT_DUMP", str(out))
        monkeypatch.setenv("TFT_SLOW_QUERY_MS", "0")
        flight.record("test.context", hint="pre-slow-query state")
        assert not tracing.enabled()
        _frame(8, 2).map_rows(lambda x: {"z": x + 1.0}).blocks()
        heads, recs = _parse_dump(out)
        assert any(h["reason"] == "slow_query" for h in heads)
        assert any(r.get("kind") == "test.context" for r in recs)

    def test_slow_query_line_in_trace_file(self, tmp_path, monkeypatch):
        path = tmp_path / "trace.jsonl"
        monkeypatch.setenv("TFT_TRACE_FILE", str(path))
        monkeypatch.setenv("TFT_SLOW_QUERY_MS", "0")
        _frame(8, 2).map_rows(lambda x: {"z": x + 1.0}).blocks()
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert [r["type"] for r in lines] == ["slow_query"]
        assert lines[0]["op"] == "map_rows"

    def test_dump_on_classified_giveup(self, tmp_path, monkeypatch):
        out = tmp_path / "dump.jsonl"
        monkeypatch.setenv("TFT_FLIGHT_DUMP", str(out))

        def always_transient():
            raise RuntimeError("UNAVAILABLE: flaky backend")

        with pytest.raises(RuntimeError):
            rz.RetryPolicy(max_attempts=2, base_delay=0.001,
                           jitter=0.0).call(always_transient, op="t")
        heads, recs = _parse_dump(out)
        assert any(h["reason"] == "giveup" for h in heads)
        give = [r for r in recs if r.get("kind") == "resilience.giveup"]
        assert give and give[-1]["attempts"] == 2
        assert give[-1]["error_kind"] == "transient"

    def test_sink_rotation_keep_one(self, tmp_path, monkeypatch):
        monkeypatch.setenv("TFT_TRACE_FILE_MAX_BYTES", "400")
        path = tmp_path / "sink.jsonl"
        line = json.dumps({"type": "filler", "pad": "x" * 60})
        for _ in range(12):
            flight.append_jsonl(str(path), [line])
        rolled = tmp_path / "sink.jsonl.1"
        assert rolled.exists(), "keep-1 rollover file missing"
        assert path.stat().st_size <= 400 + len(line) + 1
        for p in (path, rolled):
            for ln in p.read_text().splitlines():
                json.loads(ln)

    def test_trace_file_rides_the_rotation(self, tmp_path, monkeypatch):
        path = tmp_path / "trace.jsonl"
        monkeypatch.setenv("TFT_TRACE_FILE", str(path))
        monkeypatch.setenv("TFT_TRACE_FILE_MAX_BYTES", "2000")
        tracing.enable()
        for _ in range(8):
            _frame(8, 2).map_rows(lambda x: {"z": x + 1.0}).blocks()
        assert path.exists()
        assert (tmp_path / "trace.jsonl.1").exists()

    def test_dump_keep_prunes_old_sections(self, tmp_path, monkeypatch):
        monkeypatch.setenv("TFT_FLIGHT_DUMP_KEEP", "2")
        out = tmp_path / "d.jsonl"
        flight.record("test.kind")
        for _ in range(4):
            flight.dump(str(out))
        heads, _ = _parse_dump(out)
        assert len(heads) == 2
        assert flight.stats()["dump_evictions"] >= 2


# ---------------------------------------------------------------------------
# reports: explain() and last_query_report() (TestExplain)
# ---------------------------------------------------------------------------

def _report_lines(report):
    """The lines both packages render alike: rows, pipeline, resilience."""
    return [ln for ln in report.splitlines()
            if ln.startswith(("  rows ", "  pipeline :", "  resilience:"))]


class TestExplain:
    def test_explain_counts_match_counters(self, monkeypatch):
        reports = {}
        for m, tr in ((jtf, jtracing), (ttf, tracing)):
            base = tr.counters.snapshot()
            _, out, t = _traced_map(monkeypatch, n=30, parts=6, depth=3, m=m)
            s = t.summary()
            now = tr.counters.snapshot()
            assert s["blocks"] == now.get("pipeline.submitted", 0) \
                - base.get("pipeline.submitted", 0) == 6
            assert s["rows_in"] == s["rows_out"] == 30
            assert s["bytes_in"] == 30 * np.dtype(float).itemsize
            report = out.explain()
            assert "30 in / 30 out" in report and "6 block(s)" in report
            assert t.query_id in report and "wall time by stage" in report
            reports[m] = report
            tr.disable()
        assert _report_lines(reports[ttf]) == _report_lines(reports[jtf])

    def test_explain_reports_sync_fallbacks(self, monkeypatch):
        reports = {}
        for m, tr, fz in ((jtf, jtracing, jfaults), (ttf, tracing, faults)):
            _depth(monkeypatch, 3)
            tr.enable()
            out = m.frame({"x": np.arange(20.0)}, num_partitions=4) \
                .map_blocks(lambda x: {"y": x + 1.0})
            with fz.inject("dispatch", fail_n=2):
                out.blocks()
            got = np.asarray([r["y"] for r in out.collect()], float).ravel()
            np.testing.assert_array_equal(got, np.arange(20.0) + 1.0)
            reports[m] = out.explain()
            assert "2 sync fallback(s)" in reports[m]
            tr.disable()
        assert _report_lines(reports[ttf]) == _report_lines(reports[jtf])

    def test_explain_reports_retries_with_classified_error(
            self, monkeypatch):
        _depth(monkeypatch, 1)  # serial: the fault reaches the retry loop
        tracing.enable()
        out = ttf.frame({"x": np.arange(12.0)}, num_partitions=3) \
            .map_blocks(lambda x: {"y": x + 1.0})
        with faults.inject("dispatch", fail_n=1):
            out.blocks()
        retry = [e for e in out._trace.events if e.etype == "retry"][0]
        assert retry.args["kind"] == "transient"
        assert "1 retried" in out.explain()

    def test_explain_forces_untraced_frame(self, monkeypatch):
        _depth(monkeypatch, 3)
        out = ttf.frame({"x": np.arange(10.0)}, num_partitions=2) \
            .map_blocks(lambda x: {"y": x * 3.0})
        out.blocks()  # tracing off: no trace recorded
        assert out._trace is None
        report = out.explain()  # re-forces once, tracing on
        assert out._trace is not None and "map_blocks" in report
        assert "10 in / 10 out" in report
        assert not tracing.enabled()

    def test_explain_inside_another_query_says_so(self):
        out = ttf.frame({"x": np.arange(4.0)}).map_blocks(
            lambda x: {"y": x + 1.0})
        tracing.enable()
        with obs.query_trace("outer"):
            assert "inside another active query" in out.explain()

    def test_last_query_report_without_queries(self):
        assert "no query recorded" in ttf.last_query_report()

    def test_last_query_report_of_an_eager_aggregate(self, monkeypatch):
        reports = {}
        for m, tr in ((jtf, jtracing), (ttf, tracing)):
            tr.enable()
            df = m.frame({"x": np.arange(12.0), "k": np.arange(12) % 4},
                         num_partitions=3)
            m.aggregate({"x": "sum"}, df.group_by("k"))
            tr.disable()
            reports[m] = m.last_query_report()
        assert reports[ttf].startswith("query q")
        assert "· aggregate ·" in reports[ttf]
        assert _report_lines(reports[ttf]) == _report_lines(reports[jtf])

    def test_memory_line_reads_the_cards_samples(self, monkeypatch):
        _on_fake_cards(monkeypatch, [_FakeDevice(100, 4096, 1 << 30)])
        _, out, _ = _traced_map(monkeypatch, n=8, parts=2)
        assert "peak HBM 4.0 KiB" in out.explain()


# ---------------------------------------------------------------------------
# the slow-query log (TestSlowQueryLog)
# ---------------------------------------------------------------------------

def _slow_lines(path):
    return [r for r in (json.loads(ln) for ln in
                        path.read_text().splitlines())
            if r["type"] == "slow_query"]


class TestSlowQueryLog:
    def test_logs_jsonl_with_tracing_off(self, monkeypatch, tmp_path):
        got = {}
        for m in (jtf, ttf):
            path = tmp_path / f"slow-{m.__name__}.jsonl"
            monkeypatch.setenv("TFT_SLOW_QUERY_MS", "0")
            monkeypatch.setenv("TFT_TRACE_FILE", str(path))
            m.frame({"x": np.arange(8.0)}, num_partitions=2) \
                .map_blocks(lambda x: {"y": x + 1.0}).blocks()
            (slow,) = _slow_lines(path)
            got[m] = sorted(slow)
            assert slow["op"] == "map_blocks" and "query_id" not in slow
        assert got[ttf] == got[jtf]

    def test_includes_summary_fields_when_traced(self, monkeypatch,
                                                 tmp_path):
        path = tmp_path / "slow.jsonl"
        monkeypatch.setenv("TFT_SLOW_QUERY_MS", "0")
        monkeypatch.setenv("TFT_TRACE_FILE", str(path))
        tracing.enable()
        out = ttf.frame({"x": np.arange(12.0)}, num_partitions=3) \
            .map_blocks(lambda x: {"y": x + 1.0})
        out.blocks()
        (slow,) = _slow_lines(path)
        assert slow["query_id"] == out._trace.query_id
        assert slow["blocks"] == 3 and slow["retries"] == 0

    def test_fast_queries_stay_silent(self, monkeypatch, tmp_path):
        path = tmp_path / "slow.jsonl"
        monkeypatch.setenv("TFT_SLOW_QUERY_MS", "60000")
        monkeypatch.setenv("TFT_TRACE_FILE", str(path))
        ttf.frame({"x": np.arange(8.0)}, num_partitions=2) \
            .map_blocks(lambda x: {"y": x + 1.0}).blocks()
        assert not path.exists() or not _slow_lines(path)

    def test_failed_query_marked_in_log_and_histogram(self, monkeypatch,
                                                      tmp_path):
        path = tmp_path / "slow.jsonl"
        monkeypatch.setenv("TFT_SLOW_QUERY_MS", "0")
        monkeypatch.setenv("TFT_TRACE_FILE", str(path))
        tracing.enable()
        with pytest.raises(RuntimeError, match="boom"):
            with obs.query_trace("doomed"):
                raise RuntimeError("boom")
        assert _slow_lines(path)[0]["error"] == "RuntimeError"
        key = ("query_latency_seconds",
               (("op", "doomed"), ("outcome", "error")))
        assert tracing.histograms.snapshot()[key]["count"] == 1
        assert obs.last_query().meta["error"] == "RuntimeError"

    def test_served_slow_query_carries_the_cost_vector(self, monkeypatch,
                                                       tmp_path):
        path = tmp_path / "slow.jsonl"
        monkeypatch.setenv("TFT_SLOW_QUERY_MS", "0")
        monkeypatch.setenv("TFT_TRACE_FILE", str(path))
        chain = ttf.frame({"x": np.arange(16.0)}, num_partitions=4) \
            .map_blocks(lambda x: {"y": x + 1.0}) \
            .map_blocks(lambda y: {"z": y * 2.0})
        with ttf.serve.QueryScheduler(workers=0, name="slow") as s:
            fut = s.submit(chain, tenant="t")
            s.step()
            fut.result(timeout=30)
        slow = [r for r in _slow_lines(path) if r.get("op") == "serve"]
        # the fingerprint is taken after the forcing, so the line (written
        # when the trace closes) carries the cost vector only, as in the
        # JAX package
        assert slow and "cost" in slow[0]
        assert slow[0]["cost"]["stage_wall_s"] > 0.0
