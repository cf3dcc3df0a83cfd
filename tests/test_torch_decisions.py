"""The port's decision audit, SLOs, health and utilities held against the
JAX package: ``tests/test_flight.py``'s ``TestWhy``, ``TestSLO`` and
``TestHealth``, and ``tests/test_utils.py``.

- the same flight records give the same ``why`` chain (times masked);
- the same histogram observations give the same ``slo_status``;
- ``health()`` has the JAX package's keys but the ``mesh`` section,
  which waits for the parallel layer;
- the port exports every name of the JAX package's top level, and every
  name of its ``serve`` package, the fabric's included.
"""

import io
import json
import logging
import re
import time
import types

import numpy as np
import pytest

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from conftest import timing_margin
from tensorframes_tpu import resilience as jres
from tensorframes_tpu import stream as jstream
from tensorframes_tpu.engine import preempt as jpreempt
from tensorframes_tpu.observability import device as jdevice
from tensorframes_tpu.observability import flight as jflight
from tensorframes_tpu.observability import slo as jslo
from tensorframes_tpu.utils import tracing as jtracing
from tensorframes_tpu_torch import resilience as tres
from tensorframes_tpu_torch import stream as tstream
from tensorframes_tpu_torch.engine import preempt as tpreempt
from tensorframes_tpu_torch.observability import device as tdevice
from tensorframes_tpu_torch.observability import flight as tflight
from tensorframes_tpu_torch.observability import slo as tslo
from tensorframes_tpu_torch.utils import logging as tlog
from tensorframes_tpu_torch.utils import tracing as ttracing

J = types.SimpleNamespace(name="jax", top=jtf, res=jres, stream=jstream,
                          preempt=jpreempt, device=jdevice, flight=jflight,
                          slo=jslo, tracing=jtracing)
T = types.SimpleNamespace(name="torch", top=ttf, res=tres, stream=tstream,
                          preempt=tpreempt, device=tdevice, flight=tflight,
                          slo=tslo, tracing=ttracing)
BOTH = [J, T]
IDS = ["jax", "torch"]

# the JAX package's fabric names
FABRIC = {"ServeFabric", "FabricQuery", "FabricWorker", "live_fabric",
          "fabric_enabled"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("TFT_SERVE_ADMISSION_WAIT_S", "TFT_SERVE_ADMISSION_POLL_S",
                "TFT_SLO_DEFAULT_MS", "TFT_SLO_TARGET", "TFT_HISTORY_DIR",
                "TFT_PERSIST_DIR", "TFT_FAULTS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TFT_ADAPTIVE", "0")
    monkeypatch.setenv("TFT_RESULT_CACHE", "0")
    ttf.set_default_device("cpu")
    for p in BOTH:
        p.tracing.disable()
        p.tracing.histograms.reset()
        p.res.faults.reset()
        p.flight.clear()
        p.slo.clear_slos()
    yield
    # a fake card may have set a ledger budget: with the fakes undone,
    # resolve the ledger again against the real devices
    monkeypatch.undo()
    for p in BOTH:
        p.res.faults.reset()
        p.flight.clear()
        p.slo.clear_slos()
        p.device._reset()
        p.top.memory._reset()
    ttf.memory.active()


def _frame(p, n=16, parts=4):
    return p.top.frame({"x": np.arange(float(n))}, num_partitions=parts)


def _mask(text):
    text = re.sub(r"[-+]?\s*\d+\.\d+s\b", "<t>", text)
    return text.replace("tft.", "ttf.")


class _FakeCard:
    def __init__(self, live, peak, limit):
        self.stats = {"bytes_in_use": live, "peak_bytes_in_use": peak,
                      "bytes_limit": limit}

    def memory_stats(self):
        return self.stats


# ---------------------------------------------------------------------------
# why()
# ---------------------------------------------------------------------------

class TestWhy:
    def test_why_reconstructs_a_shed_query(self, monkeypatch):
        monkeypatch.setenv("TFT_SERVE_ADMISSION_WAIT_S", "0.05")
        monkeypatch.setenv("TFT_SERVE_ADMISSION_POLL_S", "0.01")
        reports = []
        for p in BOTH:
            monkeypatch.setattr(p.device, "_local_devices",
                                lambda: [_FakeCard(950, 950, 1000)])
            if p is T:
                monkeypatch.setattr(p.device, "_covered",
                                    lambda device, n: list(range(n)))
            p.device._reset()
            with p.top.serve.QueryScheduler(workers=0,
                                            name="fshed") as sched:
                fut = sched.submit(_frame(p, 8), tenant="t", est_bytes=500)
                assert sched.step()
                with pytest.raises(p.res.AdmissionDeadline):
                    fut.result(timeout=timing_margin(5))
                report = p.top.why(fut.query_id)
            shed = [r for r in p.flight.for_query(fut.query_id)
                    if r["kind"] == "serve.shed"][0]
            assert shed["est_bytes"] == 500 and shed["headroom"] < 500
            assert shed["budget_s"] == pytest.approx(0.05)
            assert "SHED" in report and "500 B" in report
            reports.append(_mask(report))
        assert reports[1] == reports[0]

    def test_why_reconstructs_a_preempted_query(self):
        reports = []
        for p in BOTH:
            df = _frame(p, 40, 8).map_rows(lambda x: {"z": x + 1.0})
            sc = p.preempt.PreemptionScope("q-preempted")
            p.res.faults.arm("preempt", 1)
            with pytest.raises(p.res.QueryPreempted):
                with p.preempt.activate(sc):
                    df.blocks()
            p.res.faults.reset()
            with p.preempt.activate(sc):
                df.blocks()
            recs = p.flight.for_query("q-preempted")
            park = [r for r in recs if r["kind"] == "preempt.park"][0]
            resume = [r for r in recs if r["kind"] == "preempt.resume"][0]
            assert park["total"] == 8 and 1 <= park["blocks"] < 8
            assert resume["blocks"] == park["blocks"]
            report = p.top.why("q-preempted")
            assert "parked at block boundary" in report
            assert "restored from checkpoint" in report
            reports.append([ln.split("s ", 1)[-1].split(" — ")[0]
                            for ln in report.splitlines()[1:]])
        assert reports[1] == reports[0]

    def test_why_reconstructs_a_replanned_query(self, monkeypatch):
        from tensorframes_tpu_torch.plan import adaptive
        monkeypatch.setenv("TFT_REPLAN_RATIO", "3")
        monkeypatch.setenv("TFT_ADAPTIVE", "1")

        def forget():
            adaptive.invalidate_results()
            with adaptive._fb_lock:
                adaptive._feedback.clear()

        forget()
        request_cleanup = forget
        q1 = lambda v: v > -1.0                   # noqa: E731
        q2 = lambda v: v < 50.0                   # noqa: E731
        warm = ttf.frame({"v": np.arange(30, dtype=np.float64)},
                         num_partitions=30)
        warm.cache()
        warm.filter(q1).filter(q2).blocks()
        warm.filter(q1).filter(q2).blocks()
        big = ttf.frame({"v": np.arange(6000, dtype=np.float64)},
                        num_partitions=30)
        big.cache()
        with tflight.scope("q-replan"):
            big.filter(q1).filter(q2).blocks()
        replans = [r for r in tflight.for_query("q-replan")
                   if r["kind"] == "plan.replan"]
        assert replans and replans[0]["ratio"] == pytest.approx(3.0)
        report = ttf.why("q-replan")
        request_cleanup()
        assert "RE-PLAN" in report and "TFT_REPLAN_RATIO" in report

    def test_same_records_give_the_same_chain(self):
        recs = [("serve.admit", dict(tenant="t", est_bytes=4096,
                                     headroom=1 << 20, waited_s=0.25)),
                ("serve.start", dict(tenant="t", queue_wait_s=0.5,
                                     est_bytes=4096, resumed=True)),
                ("memory.spill", dict(name="blk", bytes=8192)),
                ("memory.fault", dict(name="blk", bytes=8192)),
                ("preempt.park", dict(blocks=3, total=8, bytes=1 << 16,
                                      reason="priority")),
                ("serve.requeue", dict(parked_blocks=3, preemptions=1)),
                ("preempt.resume", dict(blocks=3, total=8)),
                ("plan.result_cache_hit", dict(blocks=2, bytes=1024)),
                ("engine.oom_split", dict(error="OOM", rows=64)),
                ("resilience.giveup", dict(op="dispatch", attempts=3,
                                           error="boom",
                                           error_kind="permanent")),
                ("perf.regression", dict(latency_s=1.5,
                                         baseline_latency_s=0.5,
                                         latency_sigma=9.1, runs=6,
                                         fingerprint="abcd",
                                         component="stage_wall_s",
                                         baseline=0.4, observed=1.4,
                                         sigma=12.0)),
                ("serve.finish", dict(outcome="completed", latency_s=2.0)),
                ("some.new_kind", dict(a=1, b="x"))]
        texts = []
        for p in BOTH:
            with p.flight.scope("q-same"):
                for kind, inputs in recs:
                    p.flight.record(kind, **inputs)
            texts.append(_mask(p.top.why("q-same")))
        assert texts[1] == texts[0]

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_why_unknown_query_is_helpful(self, p):
        assert "no decisions recorded" in p.top.why("serve-q99999")

    def test_why_of_a_traced_query_uses_its_id(self):
        """The port scopes the flight ring with a trace's id, so a traced
        query's own decisions answer ``why`` by that id."""
        ttracing.enable()
        df = ttf.frame({"x": np.arange(16.0)}, num_partitions=1)
        out = df.map_rows(lambda x: {"y": x * 3.0})
        with tres.faults.inject("oom", fail_n=1):
            out.blocks()
        ttracing.disable()
        report = ttf.why(out._trace.query_id)
        assert "engine.oom_split" in report and "re-dispatched" in report


# ---------------------------------------------------------------------------
# SLOs: the same observations, the same status
# ---------------------------------------------------------------------------

def _observe(p, tenant, obs):
    for latency, outcome in obs:
        p.tracing.histograms.observe("query_latency_seconds", latency,
                                     op="serve", tenant=tenant,
                                     outcome=outcome)


class TestSLO:
    def test_burn_math_matches_hand_computed_buckets(self):
        got = []
        for p in BOTH:
            p.slo.set_slo("slo-a", objective_ms=250.0, target=0.99)
            _observe(p, "slo-a", [(0.01, "ok")] * 8 + [(0.3, "ok"),
                                                       (0.01, "error")])
            got.append(p.slo.slo_status("slo-a")["slo-a"])
        j, t = got
        assert t == j
        assert (t["total"], t["good"], t["bad"]) == (10, 8, 2)
        assert t["burn_rate"] == pytest.approx(20.0)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_random_observations_same_status(self, seed):
        rng = np.random.default_rng(seed)
        obs = {t: [(float(rng.lognormal(-3, 1.5)),
                    "ok" if rng.random() < 0.9 else "permanent")
                   for _ in range(200)] for t in ("x", "y", "z")}
        got = []
        for p in BOTH:
            p.slo.set_slo("x", objective_ms=100.0, target=0.95)
            p.slo.set_slo("y", objective_ms=37.0)
            for t, o in obs.items():
                _observe(p, t, o)
            got.append(p.slo.slo_status())
        assert got[1] == got[0] and set(got[1]) == {"x", "y", "z"}

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_objective_rounds_down_to_bucket_edge(self, p):
        p.slo.set_slo("slo-b", objective_ms=300.0, target=0.999)
        _observe(p, "slo-b", [(0.3, "ok")])
        s = p.slo.slo_status("slo-b")["slo-b"]
        assert s["good"] == 0 and s["bad"] == 1

    def test_default_slo_env_knobs(self, monkeypatch):
        monkeypatch.setenv("TFT_SLO_DEFAULT_MS", "123")
        monkeypatch.setenv("TFT_SLO_TARGET", "0.95")
        assert tslo.default_slo() == tslo.SLO(123.0, 0.95)
        assert jslo.default_slo().objective_ms == 123.0

    def test_slo_validation(self):
        for p in BOTH:
            with pytest.raises(ValueError) as a:
                p.slo.SLO(objective_ms=0)
            with pytest.raises(ValueError) as b:
                p.slo.SLO(objective_ms=100, target=1.5)
        assert str(a.value) == "objective_ms must be > 0, got 0"
        assert "target must be in (0, 1)" in str(b.value)

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_burn_callback_edge_triggered(self, p):
        p.slo.set_slo("slo-c", objective_ms=250.0, target=0.99)
        _observe(p, "slo-c", [(5.0, "error")])
        fired = []
        key = p.slo.on_burn(lambda t, s: fired.append((t, s["burn_rate"])),
                            threshold=1.0)
        try:
            p.slo.note_completion("slo-c")
            assert fired and fired[0][0] == "slo-c" and fired[0][1] > 1.0
            p.slo._last_eval.clear()  # defeat the 1 s throttle
            p.slo.note_completion("slo-c")
            assert len(fired) == 1
        finally:
            p.slo.remove_burn_callback(key)

    def test_serve_report_renders_the_slo_line(self):
        lines = []
        for p in BOTH:
            with p.top.serve.QueryScheduler(workers=0,
                                            name="fslo") as sched:
                fut = sched.submit(_frame(p, 8), lambda x: {"z": x + 1.0},
                                   tenant="slo-report")
                sched.step()
                fut.result(timeout=timing_margin(10))
                report = p.top.serve.serve_report(sched)
            lines.append([ln for ln in report.splitlines() if "SLO" in ln])
        assert lines[1] == lines[0] and "burn" in lines[1][0]

    def test_metrics_families_match(self):
        fams = []
        for p in BOTH:
            p.slo.set_slo("m", objective_ms=250.0)
            _observe(p, "m", [(0.01, "ok"), (1.0, "ok")])
            text = p.top.observability.metrics_text()
            fams.append(sorted(ln for ln in text.splitlines()
                               if ln.startswith("tft_serve_slo_")))
        assert fams[1] == fams[0] and fams[1]


# ---------------------------------------------------------------------------
# health()
# ---------------------------------------------------------------------------

class TestHealth:
    def test_snapshot_keys_match_but_mesh_and_fabric(self):
        snaps = [p.top.health() for p in BOTH]
        j, t = snaps
        assert set(t) == set(j)
        assert set(t["mesh"]) == set(j["mesh"])
        assert t["fabric"] == j["fabric"] == {"running": False}
        for sec in ("memory", "caches", "flight", "resilience",
                    "invariants", "quarantine", "perf", "history"):
            extra = set(t[sec]) - set(j[sec])
            assert extra <= {"device"}, (sec, extra)
            missing = set(j[sec]) - set(t[sec])
            assert missing == set(), (sec, missing)
        assert t["memory"]["device"] is None  # no card in this process
        json.dumps(t)

    def test_health_never_initializes_cuda(self, monkeypatch):
        import importlib
        import torch
        thealth = importlib.import_module(
            "tensorframes_tpu_torch.observability.health")
        was = torch.cuda.is_initialized()
        calls = []
        real = tdevice.watermark
        monkeypatch.setattr(tdevice, "watermark",
                            lambda *a, **k: calls.append(a) or real(*a))
        snap = ttf.health()
        # only the ledger's probe of the default device (the CPU here);
        # health's own read of every card waits for CUDA to be up
        assert all(a and a[0] is not None for a in calls), calls
        assert snap["memory"]["device"] is None
        assert torch.cuda.is_initialized() is was
        assert thealth._backend_initialized() is was

    def test_memory_section_reads_the_card_once_initialized(
            self, monkeypatch):
        import torch
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(tdevice, "_local_devices",
                            lambda: [_FakeCard(100, 300, 1000)])
        monkeypatch.setattr(tdevice, "_covered",
                            lambda device, n: list(range(n)))
        tdevice._reset()
        dev = ttf.health()["memory"]["device"]
        assert dev["live_bytes"] == 100 and dev["peak_bytes"] == 300
        assert dev["limit_bytes"] == 1000

    def test_health_sees_serve_and_streams(self):
        got = []
        for p in BOTH:
            def gen():
                for i in range(3):
                    yield {"v": np.arange(4, dtype=np.float64) + i}

            h = p.stream.from_source(p.stream.GeneratorSource(gen())) \
                .map_rows(lambda v: {"z": v * 2.0}) \
                .start(name="flight-health-stream")
            h.run()
            with p.top.serve.QueryScheduler(workers=0,
                                            name="fhlth") as sched:
                fut = sched.submit(_frame(p, 8), tenant="t")
                sched.step()
                fut.result(timeout=timing_margin(10))
                snap = p.top.health()
            assert snap["serve"]["running"] is True
            st = snap["streams"]["flight-health-stream"]
            got.append((snap["serve"]["tenants"], st["batches"],
                        st["batches_skipped"], sorted(st)))
        assert got[1] == got[0]

    def test_doctor_renders(self):
        outs = []
        for p in BOTH:
            p.flight.record("serve.shed", query="doc-q", tenant="t",
                            est_bytes=500, headroom=50, budget_s=5.0)
            out = p.top.doctor()
            assert "triage" in out and "serve.shed" in out
            assert "memory" in out and "flight" in out
            # the anomaly's line; the WARNINGS block reads process state
            # that other tests of each package leave behind
            outs.append([ln for ln in out.splitlines() if "SHED" in ln])
        assert [re.sub(r"-\s*\d+\.\d+s", "", ln) for ln in outs[1]] == \
            [re.sub(r"-\s*\d+\.\d+s", "", ln) for ln in outs[0]]
        # the mesh line of both (tests/test_torch_mesh_lines.py holds its
        # text against the JAX package's)
        for p in BOTH:
            assert any(ln.startswith("  mesh     : ")
                       for ln in p.top.doctor().splitlines())


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------

class TestExports:
    def test_top_level_exports_every_jax_name(self):
        missing = set(jtf.__all__) - set(ttf.__all__)
        assert missing == set()
        for name in jtf.__all__:
            assert hasattr(ttf, name), name

    def test_serve_exports_every_jax_name_but_the_fabrics(self):
        missing = set(jtf.serve.__all__) - set(ttf.serve.__all__)
        assert missing == set()
        assert FABRIC <= set(ttf.serve.__all__)
        for name in ttf.serve.__all__:
            assert hasattr(ttf.serve, name), name

    def test_observability_exports_every_jax_name(self):
        assert set(jtf.observability.__all__) <= \
            set(ttf.observability.__all__)


# ---------------------------------------------------------------------------
# utils: logging and tracing (tests/test_utils.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def _log_state():
    root = tlog.get_logger()
    saved = (list(root.handlers), root.level, root.propagate,
             tlog._initialized, tlog._handler)
    ttracing.timings.reset()
    yield
    ttracing.timings.reset()
    ttracing.disable()
    root.handlers, root.level, root.propagate = saved[0], saved[1], saved[2]
    tlog._initialized, tlog._handler = saved[3], saved[4]


@pytest.mark.usefixtures("_log_state")
class TestUtils:
    def test_get_logger_hierarchy(self):
        child = tlog.get_logger("engine.executor")
        assert child.name == "tensorframes_tpu_torch.engine.executor"
        assert tlog.get_logger().name == "tensorframes_tpu_torch"
        assert tlog.get_logger(
            "tensorframes_tpu_torch.engine.executor") is child

    def test_trace_level_below_debug(self, caplog):
        log = tlog.get_logger("t1")
        log.setLevel(tlog.TRACE)
        with caplog.at_level(tlog.TRACE,
                             logger="tensorframes_tpu_torch.t1"):
            log.trace("hot loop %d", 7)
        assert any(r.levelno == tlog.TRACE and "hot loop 7" in r.message
                   for r in caplog.records)
        assert tlog.TRACE < logging.DEBUG

    def test_initialize_logging_idempotent(self):
        root = ttf.initialize_logging(level=logging.INFO)
        n = len(root.handlers)
        root2 = ttf.initialize_logging(level=logging.WARNING)
        assert root2 is root and len(root.handlers) == n
        assert root.level == logging.WARNING

    def test_initialize_logging_env_and_set_level(self, monkeypatch):
        monkeypatch.setenv("TFT_LOG_LEVEL", "trace")
        buf = io.StringIO()
        root = ttf.initialize_logging(stream=buf)
        assert root.level == tlog.TRACE
        tlog.set_level("error")
        assert root.level == logging.ERROR
        with pytest.raises(ValueError, match="Unknown log level"):
            tlog.set_level("loud")

    def test_span_disabled_records_nothing(self):
        ttracing.disable()
        with ttracing.span("nothing"):
            pass
        assert ttracing.timings.snapshot() == {}

    def test_span_enabled_records_stats(self):
        ttracing.enable()
        for _ in range(3):
            with ttracing.span("stage"):
                pass
        snap = ttracing.timings.snapshot()
        assert snap["stage"]["count"] == 3
        assert "stage" in ttracing.timings.report()

    def test_report_empty_message(self):
        assert "no spans" in ttracing.timings.report(include_counters=False)

    def test_dump_stats_prints_spans_and_counters(self, capsys):
        ttracing.enable()
        ttf.map_blocks(lambda x: {"z": x + 3.0},
                       _frame(T, 8, 2)).collect()
        ttf.dump_stats()
        out = capsys.readouterr().out
        assert out.startswith("span") and "executor.dispatch" in out
        assert "trace.queries" in out

    def test_profile_writes_trace(self, tmp_path):
        ttracing.disable()
        with ttracing.profile(str(tmp_path)) as prof:
            ttf.map_blocks(lambda x: {"z": x * 2.0},
                           _frame(T, 4, 1)).collect()
            assert ttracing.enabled()
        assert not ttracing.enabled()
        assert (tmp_path / "trace.json").exists()
        assert ttracing.timings.snapshot()
        names = {e.key for e in prof.key_averages()}
        assert "map_blocks.block" in names

    def test_time_since_start_is_monotonic_across_reports(self):
        # a sanity pin on the report's ordering: spans sorted by total
        ttracing.enable()
        with ttracing.span("slow"):
            time.sleep(0.01)
        with ttracing.span("fast"):
            pass
        lines = ttracing.timings.report(include_counters=False) \
            .splitlines()
        assert lines[1].startswith("slow") and lines[2].startswith("fast")
