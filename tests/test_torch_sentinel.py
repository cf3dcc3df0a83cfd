"""The port's performance sentinel (``observability/baseline.py``) held
against the JAX package (``tests/test_sentinel.py``).

The arithmetic is compared number for number: the same cost-vector
sequence goes through both packages' ``Baseline``, and the EWMA, the
window median and the robust deviation must agree to 1e-12, with the same
regression verdict and the same most-moved component. The serving cases
(a baseline per fingerprint, the scripted regression drill with
``TFT_FAULTS=perf:1``, the surfaces that show a regression) run through
each package's own ``QueryScheduler(workers=0)``.
"""

import time
import types

import numpy as np
import pytest

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from conftest import timing_margin
from tensorframes_tpu import dsl as jdsl
from tensorframes_tpu.memory import persist as jpersist
from tensorframes_tpu.observability import baseline as jbaseline
from tensorframes_tpu.observability import flight as jflight
from tensorframes_tpu.observability import metrics as jmetrics
from tensorframes_tpu.observability import timeline as jtimeline
from tensorframes_tpu.plan import adaptive as jadaptive
from tensorframes_tpu.resilience import faults as jfaults
from tensorframes_tpu.utils import tracing as jtracing
from tensorframes_tpu_torch import dsl as tdsl
from tensorframes_tpu_torch.memory import persist as tpersist
from tensorframes_tpu_torch.observability import baseline as tbaseline
from tensorframes_tpu_torch.observability import flight as tflight
from tensorframes_tpu_torch.observability import metrics as tmetrics
from tensorframes_tpu_torch.observability import timeline as ttimeline
from tensorframes_tpu_torch.plan import adaptive as tadaptive
from tensorframes_tpu_torch.resilience import faults as tfaults
from tensorframes_tpu_torch.utils import tracing as ttracing

J = types.SimpleNamespace(name="jax", top=jtf, baseline=jbaseline,
                          flight=jflight, faults=jfaults,
                          timeline=jtimeline, adaptive=jadaptive,
                          persist=jpersist, metrics=jmetrics,
                          tracing=jtracing, serve=jtf.serve)
T = types.SimpleNamespace(name="torch", top=ttf, baseline=tbaseline,
                          flight=tflight, faults=tfaults,
                          timeline=ttimeline, adaptive=tadaptive,
                          persist=tpersist, metrics=tmetrics,
                          tracing=ttracing, serve=ttf.serve)
BOTH = [J, T]
IDS = ["jax", "torch"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("TFT_TIMELINE", "TFT_TIMELINE_INTERVAL_S",
                "TFT_TIMELINE_SAMPLES", "TFT_BASELINE_SAMPLES",
                "TFT_BASELINE_MIN", "TFT_REGRESSION_SIGMA",
                "TFT_REGRESSION_MIN_FRAC", "TFT_REGRESSION_MIN_S",
                "TFT_FAULT_PERF_S", "TFT_FAULTS", "TFT_FLIGHT",
                "TFT_PERSIST_DIR", "TFT_HISTORY_DIR"):
        monkeypatch.delenv(var, raising=False)
    ttf.set_default_device("cpu")
    for p in BOTH:
        p.tracing.disable()
        p.faults.reset()
        p.flight.clear()
        p.baseline.clear()
        p.timeline.clear()
    yield
    for p in BOTH:
        p.faults.reset()
        p.flight.clear()
        p.baseline.clear()
        p.timeline.clear()
        p.tracing.disable()


def _frame(p, n=256, offset=0.0):
    return p.top.frame({"x": np.arange(float(n)) + offset},
                       num_partitions=4)


def _fused(p, n=256, offset=0.0):
    # two chained map_blocks: the forcing takes the fused plan, where the
    # perf fault site and the stage-wall feedback hook both live
    return _frame(p, n, offset).map_blocks(lambda x: {"y": x * 2.0 + 1.0}) \
        .map_blocks(lambda y: {"z": y - 3.0})


def _run_one(sched, frame, tenant="drill"):
    fut = sched.submit(frame, tenant=tenant)
    sched.step()
    return fut.result(timeout=timing_margin(30))


def _vectors(seed, n, slow_at=None, slow_comp="stage_wall_s"):
    """``n`` cost vectors from a seed; ``slow_at`` adds a slowdown there,
    carried by ``slow_comp``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        vec = {c: float(abs(rng.normal(0.1, 0.01))) if c.endswith("_s")
               else float(rng.integers(0, 4)) for c in jbaseline.COMPONENTS}
        if i == slow_at:
            vec["latency_s"] += 0.75
            vec[slow_comp] += 1.5
        out.append(vec)
    return out


# ---------------------------------------------------------------------------
# the arithmetic, number for number
# ---------------------------------------------------------------------------

class TestBaselineArithmetic:
    def test_components_are_the_jax_packages(self):
        assert tbaseline.COMPONENTS == jbaseline.COMPONENTS
        assert tbaseline._TRACKED == jbaseline._TRACKED

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_same_vectors_same_ewma_median_and_deviation(self, seed):
        bls = {p.name: p.baseline.Baseline("f" * 64, portable=False)
               for p in BOTH}
        for vec in _vectors(seed, 40):
            for bl in bls.values():
                bl.update(vec)
        j, t = bls["jax"], bls["torch"]
        assert t.count == j.count == 40
        for comp in jbaseline.COMPONENTS:
            assert abs(t.ewma[comp] - j.ewma[comp]) <= 1e-12
            assert list(t.window[comp]) == list(j.window[comp])
            for x in (0.0, 0.1, 0.5, 3.0):
                zt, mt = t.deviation(comp, x)
                zj, mj = j.deviation(comp, x)
                assert abs(zt - zj) <= 1e-12 * max(1.0, abs(zj))
                assert abs(mt - mj) <= 1e-12

    @pytest.mark.parametrize("slow_comp", ["stage_wall_s", "slot_wait_s",
                                           "compile_s"])
    def test_same_verdict_and_most_moved_component(self, slow_comp):
        vecs = _vectors(7, 12, slow_at=11, slow_comp=slow_comp)
        verdicts = {}
        for p in BOTH:
            bl = p.baseline.Baseline("a" * 64, portable=False)
            cap = types.SimpleNamespace(query_id="q-1", tenant="t")
            got = []
            for vec in vecs:
                if bl.count >= 5:
                    got.append(p.baseline._check_regression(bl, vec, cap))
                bl.update(vec)
            verdicts[p.name] = got
        j, t = verdicts["jax"], verdicts["torch"]
        assert [r is None for r in t] == [r is None for r in j]
        assert t[:-1] == [None] * (len(t) - 1)
        reg_t, reg_j = t[-1], j[-1]
        assert reg_t["component"] == reg_j["component"] == slow_comp
        strip = ("ts",)
        assert {k: v for k, v in reg_t.items() if k not in strip} == \
            {k: v for k, v in reg_j.items() if k not in strip}

    @pytest.mark.parametrize("writer,reader", [(T, J), (J, T)],
                             ids=["torch-writes", "jax-writes"])
    def test_payload_carries_across_packages(self, writer, reader):
        bl = writer.baseline.Baseline("b" * 64, portable=True)
        for vec in _vectors(3, 9):
            bl.update(vec)
        payload = bl.to_payload()
        got = reader.baseline.Baseline.from_payload(payload)
        assert got is not None and got.to_payload() == payload

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_regression_math_guards(self, p):
        bl = p.baseline.Baseline("a" * 64, portable=False)
        for _ in range(8):
            bl.update({c: (1.0 if c == "latency_s" else 0.0)
                       for c in p.baseline.COMPONENTS})
        z, med = bl.deviation("latency_s", 1.0)
        assert med == 1.0 and z == 0.0
        z, _ = bl.deviation("latency_s", 5.0)
        assert z > 100


# ---------------------------------------------------------------------------
# baselines of served queries
# ---------------------------------------------------------------------------

class TestBaselines:
    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_completion_builds_a_baseline(self, monkeypatch, p):
        monkeypatch.setenv("TFT_BASELINE_MIN", "2")
        with p.serve.QueryScheduler(workers=0, name="bl") as s:
            for _ in range(3):
                _run_one(s, _fused(p))
        st = p.baseline.perf_stats()
        assert (st["baselines"], st["warm_baselines"],
                st["completions_total"]) == (1, 1, 3)

    def test_vector_components_present(self):
        with ttf.serve.QueryScheduler(workers=0, name="vec") as s:
            _run_one(s, _fused(T))
        (bl,) = tbaseline._baselines.values()
        for comp in tbaseline.COMPONENTS:
            assert comp in bl.window, comp
        assert bl.window["stage_wall_s"][-1] > 0.0
        assert bl.window["latency_s"][-1] > 0.0
        assert bl.window["dispatches"][-1] == 4.0  # one per block

    def test_failed_runs_do_not_calibrate(self):
        with ttf.serve.QueryScheduler(workers=0, name="fail") as s:
            tfaults.arm("dispatch", 100, transient=False)
            fut = s.submit(_fused(T), tenant="t")
            s.step()
            with pytest.raises(Exception):
                fut.result(timeout=timing_margin(30))
        assert tbaseline.perf_stats()["baselines"] == 0

    def test_fingerprint_stable_across_resubmission(self):
        fp1 = tadaptive.query_fingerprint(_fused(T))
        fp2 = tadaptive.query_fingerprint(_fused(T))
        assert fp1 is not None and fp1 == fp2 and fp1[1] is False
        fp3 = tadaptive.query_fingerprint(
            _frame(T).map_blocks(lambda x: {"w": x * x})
                     .map_blocks(lambda w: {"v": w + 1.0}))
        assert fp3 is not None and fp3 != fp1
        # a bare leaf has no identity, in both packages
        assert tadaptive.query_fingerprint(_frame(T)) is None
        assert jadaptive.query_fingerprint(_frame(J)) is None

    def test_parquet_chain_fingerprint_is_portable(self, tmp_path):
        """A parquet-rooted chain, DSL programs included, has a portable
        identity that two builds of the chain share, in both packages."""
        path = str(tmp_path / "x.parquet")
        ttf.write_parquet(ttf.frame({"x": np.arange(64.0),
                                     "y": np.ones(64)}), path)

        def chain(p):
            df = (jtf.io if p is J else ttf).read_parquet(path)
            with (jdsl if p is J else tdsl).with_graph():
                z = (p.top.block(df, "x") + p.top.block(df, "y")) \
                    .named("z")
            return df.map_blocks(z).map_rows(lambda z: {"w": z * 2.0})

        for p in BOTH:
            a, b = (p.adaptive.query_fingerprint(chain(p)) for _ in "ab")
            assert a is not None and a == b and a[1] is True
        # the port's result-cache key needs every program's state, which
        # a DSL program has not: the baseline key does not depend on it
        assert tadaptive.portable_fingerprint(chain(T)) is None

    def test_portable_baseline_persists(self, tmp_path):
        prev = tpersist.configure(str(tmp_path))
        try:
            bl = tbaseline.Baseline("f" * 64, portable=True)
            bl.update({c: 1.0 for c in tbaseline.COMPONENTS})
            tbaseline._save_persisted(bl)
            assert tpersist.stats()["baselines"] == 1
            loaded = tbaseline.Baseline.from_payload(
                tpersist.load_baseline("f" * 64))
            assert loaded is not None and loaded.count == 1
            assert list(loaded.window["latency_s"]) == [1.0]
            local = tbaseline.Baseline("e" * 64, portable=False)
            local.update({c: 1.0 for c in tbaseline.COMPONENTS})
            tbaseline._save_persisted(local)
            assert tpersist.stats()["baselines"] == 1
            # a fresh process finds it through baseline_for
            tbaseline.clear()
            assert tbaseline.baseline_for("f" * 64).count == 1
        finally:
            tpersist.configure(prev)


# ---------------------------------------------------------------------------
# the scripted regression drill
# ---------------------------------------------------------------------------

def _jitter_past_the_forcing(monkeypatch, p):
    """0.2, 0.1 and 0.3 s of host work in turn after each served forcing
    (the scheduler's ``note_result_frame`` call: inside the run's latency
    but outside its stage wall), as a served query's own host work past
    its plan varies. The latency's MAD is then 0.1 s whatever the load,
    no warm run strays from the median, and the drill's slowdown moves
    ``stage_wall_s`` further, in robust sigmas, than ``latency_s``."""
    runs = []
    real = p.baseline.note_result_frame

    def note(frame):
        time.sleep((0.2, 0.1, 0.3)[len(runs) % 3])
        runs.append(1)
        real(frame)

    monkeypatch.setattr(p.baseline, "note_result_frame", note)


class TestRegressionDrill:
    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_drill_flags_exactly_one_regression(self, monkeypatch, p):
        _jitter_past_the_forcing(monkeypatch, p)
        monkeypatch.setenv("TFT_BASELINE_MIN", "3")
        # 8 robust latency deviations (1.4826 x 0.1 s) past the median
        slow_s = timing_margin(1.2)
        monkeypatch.setenv("TFT_FAULT_PERF_S", str(slow_s))
        with p.serve.QueryScheduler(workers=0, name="drill") as s:
            for _ in range(6):
                _run_one(s, _fused(p))
            expected_fp = p.adaptive.query_fingerprint(_fused(p))[0]
            assert p.baseline.perf_stats()["warm_baselines"] == 1
            p.faults.arm("perf", 1)
            _run_one(s, _fused(p))
            regs = p.top.regressions()
            assert len(regs) == 1, regs
            reg = regs[0]
            assert reg["fingerprint"] == expected_fp
            assert reg["component"] == "stage_wall_s"
            assert reg["observed"] >= slow_s
            assert reg["latency_s"] > reg["baseline_latency_s"]
            assert reg["tenant"] == "drill"
            recs = p.flight.recent("perf.regression")
            assert len(recs) == 1 and recs[0]["query"] == reg["query"]
            why = p.top.why(reg["query"])
            assert "PERF REGRESSION" in why and "stage_wall_s" in why
            warns = [w for w in p.top.health()["warnings"]
                     if w.startswith("perf:")]
            assert len(warns) == 1 and "stage_wall_s" in warns[0]
            report = p.top.serve_report(s)
            assert "PERF: 1 regression(s)" in report
            assert expected_fp[:16] in report
            _run_one(s, _fused(p))
            assert len(p.top.regressions()) == 1
        doc = p.top.doctor()
        assert "perf regressions by plan fingerprint" in doc
        assert expected_fp[:16] in doc

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_drill_quiet_when_disabled(self, monkeypatch, p):
        monkeypatch.setenv("TFT_TIMELINE", "0")
        monkeypatch.setenv("TFT_BASELINE_MIN", "3")
        monkeypatch.setenv("TFT_FAULT_PERF_S", str(timing_margin(0.3)))
        with p.serve.QueryScheduler(workers=0, name="quiet") as s:
            for _ in range(4):
                _run_one(s, _fused(p))
            p.faults.arm("perf", 1)
            _run_one(s, _fused(p))
        assert p.top.regressions() == []
        assert p.flight.recent("perf.regression") == []


# ---------------------------------------------------------------------------
# surfaces
# ---------------------------------------------------------------------------

class TestSurfaces:
    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_slow_context_carries_cost_vector(self, p):
        with p.baseline.capture("slowq", tenant="t"):
            p.baseline.note_stage_wall(0.25)
            ctx = p.baseline.slow_context()
        assert ctx is not None and ctx["cost"]["stage_wall_s"] == 0.25
        assert sorted(ctx["cost"]) == sorted(p.baseline.COMPONENTS)

    def test_slow_query_line_carries_the_cost(self, monkeypatch, caplog):
        monkeypatch.setenv("TFT_SLOW_QUERY_MS", "0")
        with tbaseline.capture("slowq", tenant="t"):
            tbaseline.note_stage_wall(0.125)
            with caplog.at_level("WARNING"):
                ttf.frame({"x": np.arange(4.0)}).map_blocks(
                    lambda x: {"y": x + 1.0}).blocks()
        lines = [r.getMessage() for r in caplog.records
                 if r.getMessage().startswith("slow query:")]
        assert lines and '"stage_wall_s": 0.125' in lines[-1]

    def test_compile_seconds_feed_the_compile_component(self):
        before = ttracing.histograms.family_sum("compile_seconds")
        with tbaseline.capture("q-compile", tenant="t"):
            ttf.frame({"x": np.arange(8.0)}).map_blocks(
                lambda x: {"y": x * 3.0})  # capture's probes
            vec = tbaseline._active.get().vector()
        assert ttracing.histograms.family_sum("compile_seconds") > before
        assert vec["compile_s"] > 0.0

    def test_metrics_providers_render(self):
        providers = tmetrics.registered_providers()
        assert {"perf", "timeline", "history", "serve.slo"} <= \
            set(providers)
        text = tmetrics.metrics_text()
        for fam in ("tft_perf_baselines", "tft_perf_regressions_total",
                    "tft_timeline_samples_total"):
            assert fam in text

    def test_perf_stats_shape(self):
        assert sorted(tbaseline.perf_stats()) == \
            sorted(jbaseline.perf_stats())
