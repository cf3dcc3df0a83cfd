"""The port's serving layer (``serve/scheduler.py``, ``stats.py``,
``quarantine.py``) held against the JAX package: ``tests/test_serve.py``,
``test_preempt.py::TestSchedulerPreemption``,
``test_memory.py::TestServeIntegration`` and
``test_chaos.py::TestQuarantine``.

The deterministic cases drive the same ``workers=0`` submissions through
each package's scheduler with ``step()`` and compare the pick order, the
snapshots, and the rejections' types and messages. Served results are
compared too: DSL programs bit for bit, f64 sums to rtol 1e-12. The
threaded cases (the three-tenant mix, cancels and preemption racing a
running query) run the port alone and hold its results against the JAX
package's serial ones.
"""

import re
import threading
import time
import types

import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from conftest import timing_margin
from tensorframes_tpu import dsl as jdsl
from tensorframes_tpu import memory as jmemory
from tensorframes_tpu import resilience as jres
from tensorframes_tpu.engine import pipeline as jpipeline
from tensorframes_tpu.observability import device as jdevice
from tensorframes_tpu.observability import flight as jflight
from tensorframes_tpu.serve import quarantine as jquarantine
from tensorframes_tpu.utils import tracing as jtracing
from tensorframes_tpu_torch import dsl as tdsl
from tensorframes_tpu_torch import memory as tmemory
from tensorframes_tpu_torch import resilience as tres
from tensorframes_tpu_torch.engine import executor as texecutor
from tensorframes_tpu_torch.engine import pipeline as tpipeline
from tensorframes_tpu_torch.observability import device as tdevice
from tensorframes_tpu_torch.observability import flight as tflight
from tensorframes_tpu_torch.serve import quarantine as tquarantine
from tensorframes_tpu_torch.utils import tracing as ttracing

J = types.SimpleNamespace(name="jax", top=jtf, serve=jtf.serve, res=jres,
                          dsl=jdsl,
                          faults=jres.faults, tracing=jtracing,
                          counters=jtracing.counters, pipeline=jpipeline,
                          device=jdevice, memory=jmemory, flight=jflight,
                          quarantine=jquarantine)
T = types.SimpleNamespace(name="torch", top=ttf, serve=ttf.serve, res=tres,
                          dsl=tdsl,
                          faults=tres.faults, tracing=ttracing,
                          counters=ttracing.counters, pipeline=tpipeline,
                          device=tdevice, memory=tmemory, flight=tflight,
                          quarantine=tquarantine)
BOTH = [J, T]
IDS = ["jax", "torch"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("TFT_SERVE_HBM_LIMIT_BYTES", "TFT_SERVE_ADMISSION_WAIT_S",
                "TFT_SERVE_ADMISSION_POLL_S", "TFT_PREEMPT_AFTER_MS",
                "TFT_FAULTS", "TFT_HISTORY_DIR", "TFT_PERSIST_DIR",
                "TFT_MEM_LIMIT_BYTES", "TFT_QUARANTINE_AFTER",
                "TFT_QUARANTINE_TTL_S"):
        monkeypatch.delenv(var, raising=False)
    # the JAX package's static layout: results compare block for block
    monkeypatch.setenv("TFT_ADAPTIVE", "0")
    monkeypatch.setenv("TFT_RESULT_CACHE", "0")
    ttf.set_default_device("cpu")
    for p in BOTH:
        p.tracing.disable()
        p.counters.reset()
        p.tracing.histograms.reset()
        p.faults.reset()
        p.flight.clear()
        p.quarantine.reset()
        p.device._reset()
    yield
    # a fake card may have set a ledger budget: with the fakes undone,
    # resolve the ledger again against the real devices
    monkeypatch.undo()
    for p in BOTH:
        p.serve.shutdown_default_scheduler()
        p.faults.reset()
        p.quarantine.reset()
        p.device._reset()
        p.memory._reset()
        assert p.pipeline.current_slot_pool() is None
    tmemory.active()


def _frame(p, n, offset=0.0, parts=2):
    return p.top.frame({"x": np.arange(float(n)) + offset},
                       num_partitions=parts)


def _z(forced, name="z"):
    return np.concatenate([np.asarray(b.columns[name])
                           for b in forced.blocks()])


def _chain(p, n=40, parts=8, mul=2.0):
    return p.top.frame({"x": np.arange(float(n))},
                       num_partitions=parts).map_rows(
        lambda x: {"y": x * mul})


def _ys(frame):
    return [float(r["y"]) for r in frame.collect()]


def _benign_fetches(x):
    # module-level, so that the plan fingerprint is stable
    return {"z": x * 2.0}


def _both(fn):
    return [fn(p) for p in BOTH]


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)
    raise AssertionError("did not raise")


def _no_ids(msg):
    return re.sub(r"\bq\d+\b", "q?", msg)


# ---------------------------------------------------------------------------
# the three-tenant mix, served by worker threads
# ---------------------------------------------------------------------------

class TestMixedWorkloadAcceptance:
    def test_three_tenant_mix_correct_fair_and_shared(self):
        sizes = {"small": 40, "medium": 400, "large": 4000}
        per_tenant = 6
        quotas = {t: ttf.serve.TenantQuota(
            weight=2.0 if t == "large" else 1.0, max_inflight=2)
            for t in sizes}
        results = {}
        with ttf.serve.QueryScheduler(quotas=quotas, workers=3,
                                      name="accept") as sched:
            futs = {}

            def submit_all(tenant):
                for k in range(per_tenant):
                    # a fresh lambda per query: structurally equal,
                    # distinct objects, the shared cache's job
                    futs[(tenant, k)] = sched.submit(
                        _frame(T, sizes[tenant], offset=k),
                        lambda x: {"z": x + 3.0}, tenant=tenant)

            threads = [threading.Thread(target=submit_all, args=(t,))
                       for t in sizes]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            for key, fut in futs.items():
                results[key] = _z(fut.result(timeout=timing_margin(120)))
            cc = sched.compile_cache.stats()
            assert cc["hits"] >= 1 and cc["misses"] <= 2
            snap = sched.snapshot()
            for tenant in sizes:
                s = snap[tenant]
                assert s["completed"] == per_tenant
                assert s["failed"] == s["rejected"] == s["shed"] == 0
            assert "shared compile cache" in ttf.serve_report(sched)
        # zero lost, zero duplicated, equal to the JAX package's run
        assert len(results) == len(sizes) * per_tenant
        for (tenant, k), got in results.items():
            want = _z(jtf.map_blocks(lambda x: {"z": x + 3.0},
                                     _frame(J, sizes[tenant], offset=k)))
            np.testing.assert_array_equal(got, want)

    def test_rejection_messages_match(self):
        def run(p):
            with p.serve.QueryScheduler(workers=0, name="cls") as sched:
                sched.register_tenant("t", p.serve.TenantQuota(
                    max_queue=1))
                sched.submit(_frame(p, 8), tenant="t")
                full = _error(lambda: sched.submit(_frame(p, 8),
                                                   tenant="t"))
                sched.register_tenant("q", p.serve.TenantQuota(
                    rows_per_sec=10.0))
                df = _frame(p, 1000)
                df.cache()
                over = _error(lambda: sched.submit(df, tenant="q"))
                return full, over, sched.snapshot()

        j, t = _both(run)
        assert t == j
        assert t[0][0] == "QueueFull" and t[1][0] == "OverQuota"

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_rejections_are_classified_not_hangs(self, p):
        with p.serve.QueryScheduler(workers=0, name="cls") as sched:
            sched.register_tenant("t", p.serve.TenantQuota(max_queue=1))
            sched.submit(_frame(p, 8), tenant="t")
            with pytest.raises(p.res.QueueFull) as ei:
                sched.submit(_frame(p, 8), tenant="t")
            assert p.res.error_kind(ei.value) == "rejected"
            assert p.res.is_transient(ei.value)
            sched.register_tenant("q", p.serve.TenantQuota(
                rows_per_sec=10.0))
            df = _frame(p, 1000)
            df.cache()
            with pytest.raises(p.res.OverQuota) as ei:
                sched.submit(df, tenant="q")
            assert p.res.error_kind(ei.value) == "over_quota"


# ---------------------------------------------------------------------------
# weighted-fair selection: the same pick order in both packages
# ---------------------------------------------------------------------------

class TestFairness:
    def test_stride_pick_order_and_snapshots_match(self):
        def run(p):
            quotas = {"a": p.serve.TenantQuota(weight=1.0),
                      "b": p.serve.TenantQuota(weight=1.0),
                      "c": p.serve.TenantQuota(weight=2.0)}
            order = []
            with p.serve.QueryScheduler(quotas=quotas, workers=0,
                                        name="fair") as sched:
                futs = []
                for tenant in ("a", "b", "c"):
                    for k in range(8):
                        futs.append((tenant, sched.submit(
                            _frame(p, 16, offset=k),
                            lambda x: {"z": x + 1.0}, tenant=tenant)))
                by_id = {f.query_id: t for t, f in futs}
                done = set()
                while sched.step():
                    now = {f.query_id for _, f in futs if f.done()}
                    order.extend(by_id[q] for q in sorted(now - done))
                    done = now
                values = [_z(f.result(timeout=5)) for _, f in futs]
                return order, sched.snapshot(), values

        (jo, js, jv), (to, ts, tv) = _both(run)
        assert to == jo and ts == js
        for a, b in zip(jv, tv):
            np.testing.assert_array_equal(b, a)
        head = to[:8]
        for t, w in (("a", 1.0), ("b", 1.0), ("c", 2.0)):
            ideal = 8 * w / 4.0
            assert ideal / 2 <= head.count(t) <= 2 * ideal

    def test_idle_tenant_does_not_bank_credit(self):
        def run(p):
            quotas = {"busy": p.serve.TenantQuota(weight=1.0),
                      "idle": p.serve.TenantQuota(weight=1.0)}
            with p.serve.QueryScheduler(quotas=quotas, workers=0,
                                        name="bank") as sched:
                for k in range(6):
                    sched.submit(_frame(p, 8, offset=k), tenant="busy")
                for _ in range(6):
                    sched.step()
                for k in range(3):
                    sched.submit(_frame(p, 8, offset=k), tenant="idle")
                    sched.submit(_frame(p, 8, offset=k), tenant="busy")
                seen = []
                for _ in range(2):
                    assert sched.step()
                    snap = sched.snapshot()
                    seen.append((snap["idle"]["completed"],
                                 snap["busy"]["completed"]))
                return seen

        j, t = _both(run)
        assert t == j and 1 <= t[-1][0] <= 2


# ---------------------------------------------------------------------------
# deadlines and admission
# ---------------------------------------------------------------------------

class _FakeCard:
    def __init__(self, live, peak, limit):
        self.stats = {"bytes_in_use": live, "peak_bytes_in_use": peak,
                      "bytes_limit": limit}

    def memory_stats(self):
        return self.stats


def _fake_cards(monkeypatch, p, devices):
    monkeypatch.setattr(p.device, "_local_devices", devices)
    if hasattr(p.device, "_covered"):
        monkeypatch.setattr(p.device, "_covered",
                            lambda device, n: list(range(n)))
    p.device._reset()


class TestDeadlinesAndAdmission:
    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_queued_past_deadline_is_shed_classified(self, p):
        with p.serve.QueryScheduler(workers=0, name="dl") as sched:
            fut = sched.submit(_frame(p, 8), tenant="t", deadline=0.01)
            time.sleep(0.05)
            assert sched.step()
            with pytest.raises(p.res.DeadlineExceeded):
                fut.result(timeout=timing_margin(5))
            assert fut.state == "failed"
            assert sched.snapshot()["t"]["failed"] == 1

    def test_admission_sheds_when_no_headroom(self, monkeypatch):
        monkeypatch.setenv("TFT_SERVE_ADMISSION_WAIT_S", "0.05")
        monkeypatch.setenv("TFT_SERVE_ADMISSION_POLL_S", "0.01")

        def run(p):
            _fake_cards(monkeypatch, p,
                        lambda: [_FakeCard(950, 950, 1000)])
            with p.serve.QueryScheduler(workers=0, name="adm") as sched:
                fut = sched.submit(_frame(p, 8), tenant="t", est_bytes=500)
                assert sched.step()
                err = _error(lambda: fut.result(timeout=timing_margin(5)))
                e = fut.error
                return (err[0], _no_ids(err[1]), fut.state,
                        p.res.error_kind(e), p.res.is_permanent(e),
                        sched.snapshot()["t"]["shed"])

        j, t = _both(run)
        assert t == j
        assert t[0] == "AdmissionDeadline" and t[2] == "shed"
        assert t[3] == "deadline_admission" and t[4] is True

    def test_admission_waits_for_headroom_then_runs(self, monkeypatch):
        monkeypatch.setenv("TFT_SERVE_ADMISSION_WAIT_S", "5")
        monkeypatch.setenv("TFT_SERVE_ADMISSION_POLL_S", "0.01")

        def run(p):
            card = _FakeCard(950, 950, 1000)
            calls = []

            def devices():
                calls.append(1)
                if len(calls) >= 3:  # pressure clears on the third poll
                    card.stats["bytes_in_use"] = 100
                return [card]

            _fake_cards(monkeypatch, p, devices)
            with p.serve.QueryScheduler(workers=0, name="admw") as sched:
                fut = sched.submit(_frame(p, 8), lambda x: {"z": x + 1.0},
                                   tenant="t", est_bytes=500)
                assert sched.step()
                out = _z(fut.result(timeout=timing_margin(5)))
            return out, len(calls) >= 3, \
                p.counters.get("serve.admission_waits")

        (jo, jc, jw), (to, tc, tw) = _both(run)
        np.testing.assert_array_equal(to, jo)
        assert tc and jc and tw == jw == 1

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_cpu_backend_admits_freely(self, p):
        with p.serve.QueryScheduler(workers=0, name="cpu") as sched:
            fut = sched.submit(_frame(p, 8), tenant="t",
                               est_bytes=10 ** 15)
            assert sched.step()
            fut.result(timeout=timing_margin(5))
            assert fut.state == "done"

    def test_hbm_limit_knob_overrides_the_card(self, monkeypatch):
        monkeypatch.setenv("TFT_SERVE_HBM_LIMIT_BYTES", "2000")

        def run(p):
            _fake_cards(monkeypatch, p, lambda: [_FakeCard(100, 100, 10**9)])
            with p.serve.QueryScheduler(workers=0, name="knob") as sched:
                return sched._hbm_headroom()

        assert _both(run) == [int(2000 * 0.9) - 100] * 2


# ---------------------------------------------------------------------------
# slot leasing and hooks
# ---------------------------------------------------------------------------

class TestSlotsAndHooks:
    def test_no_lease_leak_on_error(self):
        with ttf.serve.QueryScheduler(workers=0, slots=2,
                                      name="leak") as sched:
            def bad(x):
                raise ValueError("boom")
            fut = sched.submit(_frame(T, 64, parts=8),
                               lambda x: {"z": bad(x)}, tenant="t")
            assert sched.step()
            with pytest.raises(ValueError):
                fut.result(timeout=10)
            assert sched.slot_pool.leased() == 0
            assert sched.audit_invariants("test.close") == []

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_scheduler_restores_previous_hooks(self, p):
        pool = p.pipeline.SlotPool(7)
        prev = p.pipeline.install_slot_pool(pool)
        try:
            with p.serve.QueryScheduler(workers=0, name="nest"):
                assert p.pipeline.current_slot_pool() is not pool
            assert p.pipeline.current_slot_pool() is pool
        finally:
            p.pipeline.install_slot_pool(prev)

    def test_out_of_order_close_keeps_live_scheduler_hooks(self):
        a = ttf.serve.QueryScheduler(workers=0, name="older")
        b = ttf.serve.QueryScheduler(workers=0, name="newer")
        try:
            a.close()
            assert tpipeline.current_slot_pool() is b.slot_pool
            assert texecutor.current_computation_interner() \
                is b._interner_fn
        finally:
            b.close()
        assert tpipeline.current_slot_pool() is None
        assert texecutor.current_computation_interner() is None


# ---------------------------------------------------------------------------
# metrics, the API and the lifecycle
# ---------------------------------------------------------------------------

class TestApiAndLifecycle:
    def test_live_gauges_match(self):
        def run(p):
            with p.serve.QueryScheduler(workers=0, name="met") as sched:
                sched.register_tenant("alpha", p.serve.TenantQuota(
                    max_queue=4))
                sched.submit(_frame(p, 8), tenant="alpha")
                text = p.top.observability.metrics_text()
                before = sorted(ln for ln in text.splitlines()
                                if ln.startswith("tft_serve_")
                                and "slo" not in ln)
                assert sched.step()
            after = p.top.observability.metrics_text()
            return before, "tft_serve_queue_depth" in after

        (jb, jgone), (tb, tgone) = _both(run)
        assert tb == jb and not tgone and not jgone
        assert 'tft_serve_queue_depth{tenant="alpha"} 1' in tb

    def test_submit_and_frame_submit(self):
        def run(p):
            fut = p.top.submit(_frame(p, 16), lambda x: {"z": x + 9.0},
                               tenant="api")
            z = _z(fut.result(timeout=60))
            n = _frame(p, 8).submit(tenant="api").result(timeout=60) \
                .count()
            report = p.top.serve_report()
            p.serve.shutdown_default_scheduler()
            return z, n, "api" in report

        (jz, jn, jr), (tz, tn, tr) = _both(run)
        np.testing.assert_array_equal(tz, jz)
        assert (tn, tr) == (jn, jr) == (8, True)

    def test_close_fails_queued_queries_classified(self):
        def run(p):
            sched = p.serve.QueryScheduler(workers=0, name="close")
            fut = sched.submit(_frame(p, 8), tenant="t")
            sched.close()
            err = _error(lambda: fut.result(timeout=1))
            closed = _error(lambda: sched.submit(_frame(p, 8), tenant="t"))
            sched.close()  # idempotent
            return (err, fut.state, sched.snapshot()["t"]["rejected"],
                    p.counters.get("serve.rejected"), closed)

        j, t = _both(run)
        assert t == j and t[0][0] == "ServeRejected"

    def test_requota_active_tenant_keeps_queue_and_inflight(self):
        def run(p):
            with p.serve.QueryScheduler(workers=0, name="rq") as sched:
                sched.register_tenant("t", p.serve.TenantQuota(
                    max_queue=1))
                fut = sched.submit(_frame(p, 8), lambda x: {"z": x + 1.0},
                                   tenant="t")
                sched.register_tenant("t", p.serve.TenantQuota(
                    max_queue=8, weight=3.0))
                queued = sched.snapshot()["t"]["queued"]
                for _ in range(3):
                    sched.submit(_frame(p, 4), tenant="t")
                while sched.step():
                    pass
                return queued, _z(fut.result(timeout=30)), \
                    sched.snapshot()

        (jq, jz, js), (tq, tz, ts) = _both(run)
        assert tq == jq == 1 and ts == js
        np.testing.assert_array_equal(tz, jz)

    def test_dsl_chain_with_aggregate_served_bit_equal(self):
        """A DSL program and a keyed f64 sum, served in each package."""
        rng = np.random.default_rng(5)
        x = rng.normal(size=4000)
        k = rng.integers(0, 37, size=4000).astype(np.int64)

        def run(p):
            df = p.top.frame({"k": k, "x": x}, num_partitions=4)
            with p.dsl.with_graph():
                xb = p.top.block(df, "x")
                z = (xb * 2.0 + 1.0).named("z")
                chain = p.top.map_blocks(z, df).select(["k", "z"])
            with p.serve.QueryScheduler(workers=0, name="dsl") as sched:
                fut = sched.submit(chain, tenant="t")
                assert sched.step()
                served = fut.result(timeout=30)
            agg = p.top.aggregate({"z": "sum"}, served.group_by("k"))
            rows = sorted((int(r["k"]), float(r["z"]))
                          for r in agg.collect())
            return _z(served), rows

        (jz, jrows), (tz, trows) = _both(run)
        np.testing.assert_array_equal(tz, jz)
        assert [r[0] for r in trows] == [r[0] for r in jrows]
        np.testing.assert_allclose([r[1] for r in trows],
                                   [r[1] for r in jrows], rtol=1e-12)
        want = np.bincount(k, weights=x * 2.0 + 1.0, minlength=37)
        np.testing.assert_allclose([r[1] for r in trows], want,
                                   rtol=1e-12)


# ---------------------------------------------------------------------------
# a served aggregate: the port's submit(grouped, fetches)
# ---------------------------------------------------------------------------

def _keyed(p, n=6000, keys=53, parts=4, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    k = rng.integers(0, keys, size=n).astype(np.int64)
    df = p.top.frame({"k": k, "x": x}, num_partitions=parts)
    return df.map_blocks(_benign_fetches).select(["k", "z"]), k, x


class TestServedAggregate:
    """The port serves ``aggregate(fetches, grouped)`` as one query (the
    JAX package's scheduler takes only a frame): the keyed sums run on
    the worker and equal the JAX package's aggregate forced alone."""

    def test_keyed_sum_runs_on_the_worker(self, monkeypatch):
        from tensorframes_tpu_torch.engine import ops as tops
        real_sum = tops._segment_sum
        threads = []

        def counted(values, ids, num_segments):
            threads.append(threading.current_thread().name)
            return real_sum(values, ids, num_segments)

        monkeypatch.setattr(tops, "_segment_sum", counted)
        chain, k, x = _keyed(T)
        with ttf.serve.QueryScheduler(workers=2, name="agg") as sched:
            futs = [sched.submit(chain.group_by("k"), {"z": "sum"},
                                 tenant=t) for t in ("a", "b")]
            served = [f.result(timeout=60) for f in futs]
            # every block's segment sum ran before the futures resolved,
            # on the scheduler's workers
            assert len(threads) == 2 * 4, threads
            assert threading.current_thread().name not in threads
        jchain, _, _ = _keyed(J)
        want = jtf.aggregate({"z": "sum"}, jchain.group_by("k"))
        for out in served:
            for c in ("k", "z"):
                np.testing.assert_allclose(_z(out, c), _z(want, c),
                                           rtol=1e-12)
        np.testing.assert_allclose(
            _z(served[0], "z"),
            np.bincount(k, weights=2.0 * x)[_z(served[0], "k")], rtol=1e-12)

    def test_keyed_apart_from_its_chain(self):
        from tensorframes_tpu_torch.observability import baseline
        from tensorframes_tpu_torch.plan import adaptive
        chain, _, _ = _keyed(T)
        fp_chain = adaptive.query_fingerprint(chain)[0]
        fp_agg = adaptive.aggregate_fingerprint(chain.group_by("k"),
                                                {"z": "sum"})[0]
        assert fp_agg != fp_chain
        assert adaptive.aggregate_fingerprint(
            chain.group_by("k"), {"z": "max"})[0] != fp_agg
        assert adaptive.aggregate_fingerprint(
            chain.group_by("k"), {"z": _benign_fetches}) is None
        baseline.clear()
        try:
            with ttf.serve.QueryScheduler(workers=0, name="agg0") as sched:
                fut = sched.submit(chain.group_by("k"), {"z": "sum"})
                assert sched.step()
                fut.result(timeout=30)
                assert fut.fingerprint == fp_agg
                plain = sched.submit(chain)
                assert sched.step()
                plain.result(timeout=30)
                assert plain.fingerprint == fp_chain
            assert baseline.baseline_for(fp_agg).count == 1
            assert baseline.baseline_for(fp_chain).count == 1
        finally:
            baseline.clear()
        # a poison streak of the aggregate leaves its chain servable
        for _ in range(3):
            tquarantine.note_failure(fp_agg, ValueError("bug"))
        with ttf.serve.QueryScheduler(workers=0, name="agg1") as sched:
            with pytest.raises(tres.QueryQuarantined):
                sched.submit(chain.group_by("k"), {"z": "sum"})
            sched.submit(chain)
            with pytest.raises(TypeError, match="give fetches"):
                sched.submit(chain.group_by("k"))


# ---------------------------------------------------------------------------
# preemption and cancellation (test_preempt.py::TestSchedulerPreemption)
# ---------------------------------------------------------------------------

class TestSchedulerPreemption:
    def test_fault_driven_preempt_requeues_and_resumes(self):
        def run(p):
            c = p.counters
            with p.serve.QueryScheduler(workers=0, name="tp") as s:
                q = s.submit(_chain(p, 40, 8), tenant="whale")
                p.faults.arm("preempt", 1)
                assert s.step() is True
                parked_state = (q.state, q.preemptions,
                                q._checkpoint is not None, q.done())
                sub0 = c.get("pipeline.submitted")
                parked = c.get("pipeline.parked_blocks")
                assert s.step() is True
                res = q.result(timeout=10)
                return (parked_state, q.state,
                        c.get("serve.preemptions"),
                        c.get("pipeline.resumed_blocks") == parked,
                        c.get("pipeline.submitted") - sub0 == 8 - parked,
                        _ys(res), s.snapshot()["whale"])

        j, t = _both(run)
        assert t == j
        assert t[0] == ("queued", 1, True, False) and t[1] == "done"
        assert t[3] and t[4]
        assert t[5] == [2.0 * i for i in range(40)]

    def test_cancel_queued_never_runs(self):
        def run(p):
            with p.serve.QueryScheduler(workers=0, name="tc") as s:
                q = s.submit(_chain(p), tenant="t")
                first = s.cancel(q.query_id)
                err = _error(lambda: q.result(timeout=2))
                return (first, _no_ids(err[1]), err[0], q.state, s.step(),
                        s.cancel(q.query_id), s.snapshot()["t"])

        j, t = _both(run)
        assert t == j and t[0] is True and t[2] == "QueryCancelled"

    def test_cancel_running_settles_once(self, monkeypatch):
        _slow_dispatches(monkeypatch)
        with ttf.serve.QueryScheduler(workers=0, name="tr") as s:
            df = ttf.frame({"x": np.arange(2000.0)},
                           num_partitions=32).map_rows(
                lambda x: {"y": x * 2}).map_rows(lambda y: {"z": y + 1})
            q = s.submit(df, tenant="t")
            th = threading.Thread(target=s.step)
            th.start()
            for _ in range(2000):
                if q.state != "queued":
                    break
                time.sleep(0.005)
            assert s.cancel(q.query_id) is True
            th.join(timeout=30)
            assert not th.is_alive()
            with pytest.raises(tres.QueryCancelled):
                q.result(timeout=10)
            assert q.state == "cancelled" and q._checkpoint is None
            snap = s.snapshot()["t"]
            assert snap["inflight"] == 0 and snap["queued"] == 0
            assert s.query(q.query_id) is None
            assert s.slot_pool.leased() == 0

    def test_preempt_racing_natural_completion(self):
        rng = np.random.default_rng(7)
        for trial in range(3):
            with ttf.serve.QueryScheduler(workers=0,
                                          name=f"race{trial}") as s:
                mul = float(trial + 2)
                q = s.submit(_chain(T, 200, 16, mul=mul), tenant="t")
                th = threading.Thread(target=lambda: [
                    None for _ in iter(s.step, False)])
                th.start()
                time.sleep(float(rng.uniform(0.0, 0.05)))
                live = s.query(q.query_id)
                if live is not None and live._scope is not None:
                    live._scope.request_preempt("race test")
                th.join(timeout=30)
                while not q.done() and s.step():
                    pass
                assert q.state == "done"
                assert _ys(q.result(timeout=10)) == \
                    _ys(_chain(J, 200, 16, mul=mul))
                snap = s.snapshot()["t"]
                assert snap["inflight"] == 0 and snap["queued"] == 0

    def test_priority_arrival_preempts_lowest_weight_whale(
            self, monkeypatch):
        _slow_dispatches(monkeypatch)
        monkeypatch.setenv("TFT_PREEMPT_AFTER_MS", "0")
        with ttf.serve.QueryScheduler(
                quotas={"whale": ttf.serve.TenantQuota(weight=1.0),
                        "vip": ttf.serve.TenantQuota(weight=8.0)},
                workers=0, name="pp") as s:
            whale_df = ttf.frame({"x": np.arange(20_000.0)},
                                 num_partitions=24).map_rows(
                lambda x: {"y": x * 2}).map_rows(lambda y: {"z": y + 1})
            wq = s.submit(whale_df, tenant="whale")
            stepped = threading.Event()
            th = threading.Thread(target=lambda: (s.step(),
                                                  stepped.set()))
            th.start()
            for _ in range(2000):
                if wq.state == "running":
                    break
                time.sleep(0.002)
            assert wq.state == "running", "whale never started"
            vq = s.submit(ttf.frame({"x": np.arange(8.0)}).map_rows(
                lambda x: {"y": x + 1}), tenant="vip")
            assert stepped.wait(30), "whale neither parked nor finished"
            th.join(timeout=5)
            assert wq.preemptions >= 1
            assert tres_counter("serve.preempt_requests") >= 1
            assert s.step() is True
            assert vq.result(timeout=10) is not None
            while not wq.done():
                assert s.step() is True
            want = jtf.frame({"x": np.arange(20_000.0)},
                             num_partitions=24).map_rows(
                lambda x: {"y": x * 2}).map_rows(lambda y: {"z": y + 1})
            np.testing.assert_array_equal(_z(wq.result(timeout=10)),
                                          _z(want))
            snap = s.snapshot()
            assert snap["whale"]["preempted"] >= 1
            assert snap["whale"]["completed"] == 1
            assert snap["vip"]["completed"] == 1

    def test_cancel_aborts_admission_wait(self, monkeypatch):
        monkeypatch.setenv("TFT_SERVE_ADMISSION_WAIT_S", "30")
        with ttf.serve.QueryScheduler(workers=0, name="aw") as s:
            monkeypatch.setattr(s, "_hbm_headroom", lambda: 0)
            q = s.submit(_chain(T), tenant="t", est_bytes=10_000)
            th = threading.Thread(target=s.step)
            th.start()
            for _ in range(2000):
                if q.state == "running":
                    break
                time.sleep(0.002)
            assert s.cancel(q.query_id) is True
            th.join(timeout=timing_margin(10.0))
            assert not th.is_alive(), "admission wait ignored the cancel"
            with pytest.raises(tres.QueryCancelled):
                q.result(timeout=5)


def _slow_dispatches(monkeypatch, seconds=0.01):
    """Each block's dispatch takes ``seconds`` longer, so that a cancel or
    an arrival lands while the stream runs, however loaded the machine."""
    real = texecutor.BlockExecutor._launch

    def slow(self, *a, **k):
        time.sleep(seconds)
        return real(self, *a, **k)

    monkeypatch.setattr(texecutor.BlockExecutor, "_launch", slow)


def tres_counter(name):
    return ttracing.counters.get(name)


# ---------------------------------------------------------------------------
# the memory ledger backs admission (test_memory.py::TestServeIntegration)
# ---------------------------------------------------------------------------

class TestServeIntegration:
    def test_unforced_frame_gets_estimate(self):
        from tensorframes_tpu.serve.scheduler import _estimate as jest
        from tensorframes_tpu_torch.serve.scheduler import _estimate as test
        got = []
        for p, est in ((J, jest), (T, test)):
            lazy = p.top.frame({"x": np.arange(512.0)}).map_blocks(
                lambda x: {"z": x + 1.0})
            before = est(lazy)
            lazy.blocks()
            got.append((before, est(lazy)))
        assert got[1] == got[0] == ((512.0, 512 * 8 * 2),) * 2

    def test_ledger_headroom_backs_admission(self):
        def run(p):
            m = p.memory.configure(limit_bytes=10000)
            sched = p.serve.QueryScheduler(workers=0, name="memtest")
            try:
                h0 = sched._hbm_headroom()
                tok = m.reserve(5000)
                h1 = sched._hbm_headroom()
                m.release(tok)
                return h0, h1
            finally:
                sched.close()
                p.memory._reset()

        assert _both(run) == [(9000, 4000)] * 2

    def test_larger_than_budget_query_admits_spill_aware(self):
        def run(p):
            p.memory.configure(limit_bytes=64 * 1024)
            df = p.top.frame({"x": np.arange(32768, dtype=np.float64)},
                             num_partitions=16)
            try:
                with p.serve.QueryScheduler(workers=1,
                                            name="memadmit") as sched:
                    fut = sched.submit(
                        df.map_blocks(lambda x: {"z": x + 1.0}),
                        tenant="t")
                    out = fut.result(timeout=timing_margin(60.0))
                    return _z(out), fut.state
            finally:
                p.memory._reset()

        (jz, js), (tz, ts) = _both(run)
        np.testing.assert_array_equal(tz, jz)
        assert ts == js == "done"

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_no_budget_headroom_is_none(self, p):
        p.memory.configure(limit_bytes=0)
        sched = p.serve.QueryScheduler(workers=0, name="memtest2")
        try:
            assert sched._hbm_headroom() is None
        finally:
            sched.close()
            p.memory._reset()


# ---------------------------------------------------------------------------
# poison-query quarantine (test_chaos.py::TestQuarantine)
# ---------------------------------------------------------------------------

class TestQuarantine:
    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_streak_quarantines_and_classifies(self, p):
        fp = "fp-poison-1"
        boom = ValueError("deterministic plan bug")
        p.quarantine.note_failure(fp, boom)
        p.quarantine.note_failure(fp, boom)
        p.quarantine.check(fp)
        p.quarantine.note_failure(fp, boom)
        assert p.counters.get("serve.quarantines") == 1
        with pytest.raises(p.res.QueryQuarantined) as ei:
            p.quarantine.check(fp)
        assert p.res.error_kind(ei.value) == "quarantined"
        assert not p.res.is_transient(ei.value)
        assert p.counters.get("serve.quarantined") == 1
        st = p.quarantine.status()
        assert st["active"][fp]["failures"] == 3
        recs = p.flight.recent(kind="serve.quarantine")
        assert recs and recs[-1]["fingerprint"] == fp

    def test_messages_and_status_match(self):
        def run(p):
            for _ in range(3):
                p.quarantine.note_failure("fp-m", ValueError("bug"))
            err = _error(lambda: p.quarantine.check("fp-m"))
            st = p.quarantine.status()
            return (err[0], re.sub(r"expires in \d+s", "", err[1])
                    .replace("tft.", "ttf."),
                    {k: v for k, v in st.items() if k != "active"},
                    st["active"]["fp-m"]["failures"])

        assert _both(run)[1] == _both(run)[0]

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_success_resets_streak(self, p):
        fp = "fp-flaky"
        boom = ValueError("boom")
        p.quarantine.note_failure(fp, boom)
        p.quarantine.note_failure(fp, boom)
        p.quarantine.note_success(fp)
        p.quarantine.note_failure(fp, boom)
        p.quarantine.note_failure(fp, boom)
        p.quarantine.check(fp)
        assert p.quarantine.status()["active"] == {}

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_unquarantine_lifts(self, p):
        boom = ValueError("boom")
        for fp in ("fp-a", "fp-b"):
            for _ in range(3):
                p.quarantine.note_failure(fp, boom)
        assert p.top.unquarantine("fp-a") == 1
        p.quarantine.check("fp-a")
        with pytest.raises(p.res.QueryQuarantined):
            p.quarantine.check("fp-b")
        assert p.top.unquarantine() == 1
        p.quarantine.check("fp-b")
        assert p.counters.get("serve.unquarantined") == 2
        assert p.top.quarantine_status()["active"] == {}

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_ttl_expires_into_one_probe(self, monkeypatch, p):
        monkeypatch.setenv("TFT_QUARANTINE_TTL_S", "0.05")
        fp = "fp-ttl"
        boom = ValueError("boom")
        for _ in range(3):
            p.quarantine.note_failure(fp, boom)
        with pytest.raises(p.res.QueryQuarantined):
            p.quarantine.check(fp)
        time.sleep(0.08)
        p.quarantine.check(fp)
        assert p.counters.get("serve.quarantine_expired") == 1
        p.quarantine.note_failure(fp, boom)
        with pytest.raises(p.res.QueryQuarantined):
            p.quarantine.check(fp)

    @pytest.mark.parametrize("p", BOTH, ids=IDS)
    def test_disabled_by_knob(self, monkeypatch, p):
        monkeypatch.setenv("TFT_QUARANTINE_AFTER", "0")
        for _ in range(10):
            p.quarantine.note_failure("fp-off", ValueError("boom"))
        p.quarantine.check("fp-off")
        assert p.quarantine.status()["active"] == {}

    def test_scheduler_end_to_end(self):
        df = ttf.frame({"x": np.arange(16.0)}, num_partitions=2)
        with ttf.serve.QueryScheduler(
                quotas={"t": ttf.serve.TenantQuota()}, workers=1,
                name="quar-e2e") as sched:
            for _ in range(3):
                tres.faults.arm("dispatch", 2,
                                message="injected permanent plan bug",
                                transient=False)
                fut = sched.submit(df, _benign_fetches, tenant="t")
                with pytest.raises(tres.InjectedFault):
                    fut.result(timeout=60)
                tres.faults.reset("dispatch")
            with pytest.raises(tres.QueryQuarantined) as ei:
                sched.submit(df, _benign_fetches, tenant="t")
            assert tres.error_kind(ei.value) == "quarantined"
            assert sched.snapshot()["t"]["quarantined"] == 1
            assert "QUARANTINE" in ttf.serve_report(sched)
            assert ttf.unquarantine() == 1
            out = sched.submit(df, _benign_fetches, tenant="t") \
                .result(timeout=60)
            np.testing.assert_array_equal(_z(out), np.arange(16.0) * 2.0)


# ---------------------------------------------------------------------------
# the scheduler's invariant auditor
# ---------------------------------------------------------------------------

class TestAuditor:
    def test_clean_books_and_an_orphan(self):
        from tensorframes_tpu_torch.resilience import invariants
        with ttf.serve.QueryScheduler(workers=0, name="aud") as sched:
            sched.submit(_frame(T, 8), tenant="t")
            assert sched.audit_invariants() == []
            assert invariants.audit("test.inline") == []
            assert sched.step()
            # an entry that no queue holds and no worker runs
            sched.submit(_frame(T, 8), tenant="t")
            sched._tenants["t"].queue.clear()
            found = sched.audit_invariants()
            assert found and "queue entries" in found[0]
            sched._queries.clear()
        assert ttracing.counters.get("invariants.audits") >= 2


# ---------------------------------------------------------------------------
# signatures under concurrency: the scheduler's workers intern at once
# ---------------------------------------------------------------------------

def test_signatures_from_eight_threads_agree():
    """Equal programs captured and signed from eight threads at once all
    get one signature: concurrent ``torch.export`` traces used to fail
    each other, which marked equal programs uncacheable for good."""
    from tensorframes_tpu_torch.computation import Computation, TensorSpec
    from tensorframes_tpu_torch.serve.cache import computation_signature
    from tensorframes_tpu_torch.shape import Shape, Unknown

    comps = [Computation.trace(lambda x: {"z": x * 2.0 + 1.0},
                               [TensorSpec("x", ttf.dtypes.double,
                                           Shape(Unknown))])
             for _ in range(8)]
    barrier = threading.Barrier(8)
    sigs = [None] * 8

    def sign(i):
        barrier.wait()
        sigs[i] = computation_signature(comps[i])

    threads = [threading.Thread(target=sign, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert None not in sigs and len(set(sigs)) == 1, sigs


def test_signatures_and_filter_atoms_from_threads_at_once():
    """Programs signed (``torch.export``) on four threads while four
    others extract filters' atoms (``make_fx``), all at once: each gets
    its signature and its atoms. Both trace through ``torch.fx``, whose
    patcher is process-wide, and a fingerprint taken at submit used to
    fail against a worker planning a filtered chain
    (``AssertionError: CURRENT_PATCHER is None in finally block``)."""
    from tensorframes_tpu_torch.computation import Computation, TensorSpec
    from tensorframes_tpu_torch.plan.predicates import Atom, extract_atoms
    from tensorframes_tpu_torch.serve.cache import computation_signature
    from tensorframes_tpu_torch.shape import Shape, Unknown

    spec = [TensorSpec("x", ttf.dtypes.double, Shape(Unknown))]
    rounds = 3
    programs = [[Computation.trace(lambda x: {"z": x * 2.0 + 1.0}, spec)
                 for _ in range(rounds)] for _ in range(4)]
    filters = [[Computation.trace(lambda x: x > 3.0, spec)
                for _ in range(rounds)] for _ in range(4)]
    barrier = threading.Barrier(8)
    sigs, atoms = [], []

    def sign(comps):
        barrier.wait()
        sigs.extend(computation_signature(c) for c in comps)

    def extract(comps):
        barrier.wait()
        atoms.extend(tuple(extract_atoms(c)) for c in comps)

    threads = [threading.Thread(target=sign, args=(c,)) for c in programs] \
        + [threading.Thread(target=extract, args=(c,)) for c in filters]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert len(sigs) == len(atoms) == 4 * rounds
    assert None not in sigs and len(set(sigs)) == 1, sigs
    assert set(atoms) == {(Atom("x", "gt", 3.0, torch.float64),)}, atoms
