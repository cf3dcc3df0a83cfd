"""The port's serving fabric (``serve/fabric.py``) held against the JAX
package's: ``tests/test_fabric.py`` mirrored case by case, and the same
frames and programs served through both packages' fabrics.

The fabric runs without its monitor thread: ``tick()`` drives it, and
``FabricQuery.result()`` ticks while it waits, so no case depends on
sleeping. The durable tier's unit cases of ``tests/test_fabric.py``
(checkpoint round trip, tag mismatch, corrupt checkpoint, result budget)
are mirrored in ``tests/test_torch_memory.py::TestPersist``.

Parity: a plain map, a grouped aggregate and a crash mid-query resumed
on a survivor go through a JAX ``ServeFabric`` (JAX on the CPU, x64) and
the port's from the same numpy data. Sums are over integer-valued f64,
so they agree exactly in any order; the ``fabric.*`` counters and the
placement and resume flight records compare by name.
"""

import json
import types

import numpy as np
import pytest

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from conftest import timing_margin
from tensorframes_tpu import resilience as jres
from tensorframes_tpu.memory import persist as jpersist
from tensorframes_tpu.observability import flight as jflight
from tensorframes_tpu.observability import slo as jslo
from tensorframes_tpu.plan import adaptive as jadaptive
from tensorframes_tpu.utils import tracing as jtracing
from tensorframes_tpu_torch import resilience as tres
from tensorframes_tpu_torch.memory import persist as tpersist
from tensorframes_tpu_torch.observability import flight as tflight
from tensorframes_tpu_torch.observability import slo as tslo
from tensorframes_tpu_torch.plan import adaptive as tadaptive
from tensorframes_tpu_torch.resilience import WorkerLost, faults
from tensorframes_tpu_torch.serve import (QueryScheduler, ServeFabric,
                                          fabric_enabled, live_fabric,
                                          serve_report)
from tensorframes_tpu_torch.utils.tracing import counters

pytestmark = pytest.mark.fabric

J = types.SimpleNamespace(name="jax", top=jtf, res=jres, persist=jpersist,
                          flight=jflight, slo=jslo, adaptive=jadaptive,
                          counters=jtracing.counters)
T = types.SimpleNamespace(name="torch", top=ttf, res=tres, persist=tpersist,
                          flight=tflight, slo=tslo, adaptive=tadaptive,
                          counters=counters)
BOTH = [J, T]

# shared across forcings: a fresh lambda per call would defeat the result
# cache's keys and the compile cache's interning
DOUBLE = lambda x: {"y": x * 2.0}  # noqa: E731
PLUS1 = lambda x: {"y": x + 1.0}  # noqa: E731


def _twice(x):
    return {"z": x + x}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("TFT_FABRIC", "TFT_FABRIC_WORKERS", "TFT_PERSIST_DIR",
                "TFT_HISTORY_DIR", "TFT_FAULTS", "TFT_CHAOS",
                "TFT_FABRIC_MISSED_HB"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TFT_RETRY_BASE_DELAY", "0.001")
    ttf.set_default_device("cpu")
    prev = {}
    for p in BOTH:
        p.res.faults.reset()
        p.slo.clear_slos()
        p.adaptive.invalidate_results()
        p.counters.reset()
        p.flight.clear()
        prev[p.name] = p.persist.configure(None)
    yield
    for p in BOTH:
        p.persist.configure(prev[p.name])
        p.res.faults.reset()
        p.slo.clear_slos()
        p.adaptive.invalidate_results()
        assert p.top.serve.live_fabric() is None


def _col(frame, name="y"):
    out = []
    for b in frame.blocks():
        v = b.columns[name]
        out.append(v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
    return np.concatenate(out)


def _fabric(tmp_path, name, workers=2, **kw):
    kw.setdefault("monitor", False)
    kw.setdefault("probe", False)
    return ServeFabric(workers=workers, persist_dir=str(tmp_path),
                       name=name, **kw)


def _resume_records(flight, qid):
    return [r for r in flight.for_query(qid)
            if r["kind"] == "fabric.resume_dispatch"]


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

def test_worker_lost_classified():
    e = WorkerLost("worker process died")
    assert tres.is_worker_lost(e)
    assert tres.error_kind(e) == "worker_lost"
    assert not tres.is_transient(e)
    assert tres.error_kind(e) == jres.error_kind(
        jres.WorkerLost("worker process died"))


# ---------------------------------------------------------------------------
# the fabric: placement and basic serving
# ---------------------------------------------------------------------------

def test_fabric_places_tenants_least_loaded(tmp_path):
    with _fabric(tmp_path, "place") as fab:
        f = ttf.frame({"x": np.arange(8.0)}, num_partitions=2)
        fab.submit(f, DOUBLE, tenant="a").result(timeout=30)
        fab.submit(f, DOUBLE, tenant="b").result(timeout=30)
        snap = fab.health_snapshot()
        assert snap["placement"]["a"] != snap["placement"]["b"]
        # sticky: a's second query lands on a's worker
        before = snap["placement"]["a"]
        fab.submit(f, DOUBLE, tenant="a").result(timeout=30)
        assert fab.health_snapshot()["placement"]["a"] == before
        assert live_fabric() is fab
    assert live_fabric() is None


def test_fabric_result_bit_identical_to_plain_scheduler(tmp_path):
    f = ttf.frame({"x": np.arange(32.0)}, num_partitions=4)
    with QueryScheduler(workers=1, name="plain") as sched:
        plain = _col(sched.submit(f, DOUBLE).result(timeout=30))
    with _fabric(tmp_path, "fabeq") as fab:
        fabbed = _col(fab.submit(f, DOUBLE, tenant="a").result(timeout=30))
    np.testing.assert_array_equal(plain, fabbed)


def test_fabric_disabled_single_process_path(tmp_path, monkeypatch):
    monkeypatch.setenv("TFT_FABRIC", "0")
    assert not fabric_enabled()
    with ServeFabric(workers=4, monitor=False, persist_dir=str(tmp_path),
                     name="off") as fab:
        assert len(fab._workers) == 1  # collapses regardless of ask
        f = ttf.frame({"x": np.arange(16.0)}, num_partitions=4)
        got = _col(fab.submit(f, DOUBLE, tenant="a").result(timeout=30))
        np.testing.assert_array_equal(got, np.arange(16.0) * 2.0)


# ---------------------------------------------------------------------------
# worker crash: the failure matrix
# ---------------------------------------------------------------------------

def test_worker_crash_mid_query_resumes_elsewhere_bit_identical(tmp_path):
    with _fabric(tmp_path, "crash") as fab:
        f = ttf.frame({"x": np.arange(64.0)}, num_partitions=8)
        faults.arm("worker", fail_n=1)
        fq = fab.submit(f, DOUBLE, tenant="alice")
        got = _col(fq.result(timeout=60))
        np.testing.assert_array_equal(got, np.arange(64.0) * 2.0)
        assert fq.attempts == 2  # the original and one re-dispatch
        snap = fab.health_snapshot()
        assert snap["lost"] == 1 and snap["live"] == 1
        # the survivor resumed from the PERSISTED checkpoint: the resume
        # re-dispatched fewer blocks than the query has
        chain = ttf.why(fq.query_id)
        assert "fabric.resume_dispatch" in chain
        assert "resume from the persisted checkpoint" in chain
        assert "preempt.park" in chain  # the crash-side park
        recs = _resume_records(tflight, fq.query_id)
        assert recs and recs[0]["from_checkpoint"]
        assert 0 < recs[0]["resumed_blocks"] < 8
        # one causal chain across two worker ids
        workers = {r.get("worker") for r in tflight.for_query(fq.query_id)}
        assert {"w0", "w1"} <= workers
        # and the tenant was re-placed off the corpse
        assert "fabric.replace" in ttf.why("tenant:alice")


def test_worker_crash_discarded_checkpoint_cold_rerun(tmp_path,
                                                       monkeypatch):
    """A checkpoint that does not survive (deleted under the fabric)
    degrades to a cold re-run on the survivor: same answer."""
    with _fabric(tmp_path, "cold") as fab:
        f = ttf.frame({"x": np.arange(64.0)}, num_partitions=8)
        monkeypatch.setattr(tpersist, "load_checkpoint", lambda qid: None)
        faults.arm("worker", fail_n=1)
        fq = fab.submit(f, DOUBLE, tenant="a")
        got = _col(fq.result(timeout=60))
        np.testing.assert_array_equal(got, np.arange(64.0) * 2.0)
        recs = _resume_records(tflight, fq.query_id)
        assert recs and not recs[0]["from_checkpoint"]


@pytest.mark.parametrize("case", ["fabric_survives", "health_warning"])
def test_idle_worker_fault_consumed_at_heartbeat(tmp_path, case):
    """``TFT_FAULTS=worker:1`` with NO running query: the next heartbeat
    consumes the fault, the lease expires, the worker is declared lost,
    and serving continues on the survivor
    (``test_idle_worker_fault_consumed_at_heartbeat``); ``health()``
    warns about the lost worker
    (``test_lost_worker_raises_health_warning``)."""
    with _fabric(tmp_path, "idle") as fab:
        faults.arm("worker", fail_n=1)
        for _ in range(fab.missed_hb + 2):
            fab.tick()
        assert fab.health_snapshot()["lost"] == 1
        assert not faults.active("worker")  # consumed
        if case == "health_warning":
            warns = ttf.health()["warnings"]
            assert any("worker(s) declared lost" in w for w in warns)
            return
        f = ttf.frame({"x": np.arange(8.0)}, num_partitions=2)
        got = _col(fab.submit(f, DOUBLE, tenant="a").result(timeout=30))
        np.testing.assert_array_equal(got, np.arange(8.0) * 2.0)


def test_queued_queries_replaced_not_dropped(tmp_path):
    """Queries still QUEUED on a crashed worker re-place and re-run cold:
    zero lost, zero duplicated."""
    with _fabric(tmp_path, "queue") as fab:
        f = ttf.frame({"x": np.arange(16.0)}, num_partitions=2)
        fab.submit(f, DOUBLE, tenant="a").result(timeout=30)
        widx = fab._placement["a"]
        # pile queries onto a's worker, then kill it before they drain
        fqs = [fab.submit(f, PLUS1, tenant="a") for _ in range(3)]
        fab._workers[widx].fault_pending = True
        fab._workers[widx].scheduler.mark_lost()
        outs = [_col(fq.result(timeout=60)) for fq in fqs]
        for got in outs:
            np.testing.assert_array_equal(got, np.arange(16.0) + 1.0)
        assert all(fq.done() and fq.error is None for fq in fqs)
        assert len({fq.query_id for fq in fqs}) == 3


def test_no_survivors_is_classified_worker_lost(tmp_path):
    with _fabric(tmp_path, "alone", workers=1) as fab:
        f = ttf.frame({"x": np.arange(16.0)}, num_partitions=4)
        faults.arm("worker", fail_n=1)
        fq = fab.submit(f, DOUBLE, tenant="a")
        with pytest.raises(WorkerLost):
            fq.result(timeout=60)
        assert tres.error_kind(fq.error) == "worker_lost"


def test_orphan_at_close_keeps_its_checkpoint_file(tmp_path):
    """A query parked on a worker that is marked lost is orphaned by the
    scheduler's requeue, and its persisted checkpoint stays on disk for
    the fabric to resume (the scheduler's terminal ``_finish`` would
    discard it)."""
    tpersist.configure(str(tmp_path))
    with QueryScheduler(workers=1, name="orphan") as sched:
        lost = []
        sched.on_worker_fault = lambda s: (lost.append(s), s.mark_lost())
        f = ttf.frame({"x": np.arange(64.0)}, num_partitions=8)
        faults.arm("worker", fail_n=1)
        q = sched.submit(f, DOUBLE, tenant="a", query_id="orphan-q1")
        with pytest.raises(tres.ServeRejected):
            q.result(timeout=60)
    assert lost == [sched]
    cp = tpersist.load_checkpoint("orphan-q1")
    assert cp is not None and 0 < cp.parked_blocks < 8


# ---------------------------------------------------------------------------
# a grouped submit: the keyed aggregate resumes on the survivor
# ---------------------------------------------------------------------------

def test_grouped_submit_resumes_as_grouped(tmp_path):
    rng = np.random.default_rng(3)
    key = rng.integers(0, 40, 4_000)
    x = rng.integers(0, 1_000, 4_000).astype(np.float64)
    want = np.bincount(key, weights=2 * x, minlength=40)
    launches = []
    from tensorframes_tpu_torch.engine import ops as tops
    real = tops._segment_sum

    def counted(*a, **k):
        launches.append(1)
        return real(*a, **k)

    tops._segment_sum = counted
    try:
        with _fabric(tmp_path, "grp", workers=3) as fab:
            src = ttf.frame({"key": key, "x": x}, num_partitions=8)
            g = src.map_blocks(_twice).select(["key", "z"]).group_by("key")
            faults.arm("worker", fail_n=1)
            fq = fab.submit(g, {"z": "sum"}, tenant="bob")
            out = fq.result(timeout=60)
    finally:
        tops._segment_sum = real
    c = out.blocks()[0].columns
    np.testing.assert_array_equal(np.asarray(c["key"]), np.arange(40))
    np.testing.assert_array_equal(np.asarray(c["z"]), want)
    rec = _resume_records(tflight, fq.query_id)[0]
    assert rec["from_checkpoint"] and 0 < rec["resumed_blocks"] < 8
    assert launches, "the resumed aggregate never reached segment_sum"


# ---------------------------------------------------------------------------
# durable result cache across restarts
# ---------------------------------------------------------------------------

def test_rolling_restart_keeps_result_cache_warm(tmp_path):
    pq = str(tmp_path / "t.parquet")
    ttf.write_parquet(ttf.frame({"x": np.arange(32.0)}, num_partitions=4),
                      pq)
    with _fabric(tmp_path / "persist", "roll") as fab:
        f = ttf.read_parquet(pq)
        # two sightings admit (two-touch), the admit persists
        outs = [fab.submit(f, DOUBLE, tenant="t1").result(timeout=30)
                for _ in range(2)]
        a = _col(outs[0])
        assert counters.get("persist.result_writes") >= 1
        warm0 = counters.get("plan.result_cache_warm_hits")
        # restart EVERY worker: in-memory caches die with each epoch
        assert fab.rolling_restart() == 2
        assert all(w.epoch == 1 for w in fab._workers)
        submitted0 = counters.get("pipeline.submitted")
        assert submitted0 > 0
        got = _col(fab.submit(f, DOUBLE, tenant="t1").result(timeout=30))
        np.testing.assert_array_equal(a, got)
        # served WARM from the durable tier: counted apart, with zero new
        # pipeline dispatches (the port counts them as submits)
        assert counters.get("plan.result_cache_warm_hits") == warm0 + 1
        assert counters.get("pipeline.submitted") == submitted0
        # the warm hit re-admits into memory: the NEXT hit is a plain one
        hits0 = counters.get("plan.result_cache_hits")
        fab.submit(f, DOUBLE, tenant="t1").result(timeout=30)
        assert counters.get("plan.result_cache_hits") == hits0 + 1


def test_rolling_restart_loses_zero_inflight_queries(tmp_path):
    with _fabric(tmp_path, "migrate") as fab:
        f = ttf.frame({"x": np.arange(24.0)}, num_partitions=3)
        fqs = [fab.submit(f, PLUS1, tenant=t) for t in ("a", "b", "c")]
        assert fab.rolling_restart() == 2
        for fq in fqs:
            got = _col(fq.result(timeout=60))
            np.testing.assert_array_equal(got, np.arange(24.0) + 1.0)
        assert counters.get("fabric.worker_restarts") == 2


@pytest.mark.parametrize("p", BOTH, ids=["jax", "torch"])
def test_restart_under_the_monitor_is_not_a_lost_worker(tmp_path, p):
    """Found on the card: beats that ticked while a worker drained for its
    restart counted as missed, so a rolling restart under the monitor
    declared the restarting worker lost (its tenants re-placed, a
    lost-worker warning, ``fabric.workers_lost``) and then re-admitted
    it. The port exempts a restarting worker from the lease until its
    probe; the JAX package does not (``ROADMAP.md`` §C). The drain here
    ticks as a monitor would while it waits."""
    with p.top.serve.ServeFabric(workers=2, monitor=False, probe=False,
                                 persist_dir=str(tmp_path),
                                 name="rst") as fab:
        sched = fab._workers[0].scheduler
        real_close = sched.close

        def draining_close(timeout=30.0):
            for _ in range(fab.missed_hb + 1):
                fab.tick()
            return real_close(timeout=timeout)

        sched.close = draining_close
        assert fab.restart_worker(0)
        lost = p.counters.get("fabric.workers_lost")
        snap = fab.health_snapshot()
    assert snap["live"] == 2 and fab._workers[0].epoch == 1
    assert (lost, snap["lost"]) == ((0, 0) if p is T else (1, 0))


def test_restart_probe_gates_admission(tmp_path):
    with _fabric(tmp_path, "gate") as fab:
        w = fab._workers[0]
        ok = fab.restart_worker(0)
        assert ok and w.epoch == 1 and w.alive
        assert any(r["kind"] == "fabric.admit"
                   for r in tflight.recent() if r.get("worker") == "w0")
        # a worker whose probe fails is not admitted
        real = fab._workers[1].scheduler.__class__.submit

        def broken(self, *a, **k):
            raise RuntimeError("probe refused")

        fab._workers[1].scheduler.__class__.submit = broken
        try:
            assert not fab._probe_worker(fab._workers[1])
        finally:
            fab._workers[1].scheduler.__class__.submit = real
        assert counters.get("fabric.admit_probe_failures") == 1
        assert not fab._workers[1].alive


def test_shared_compile_cache_spans_workers(tmp_path):
    """One SharedCompileCache instance serves every worker and every
    epoch: tenant B's identical computation on another worker hits."""
    with _fabric(tmp_path, "cc") as fab:
        f = ttf.frame({"x": np.arange(8.0)}, num_partitions=2)
        # structurally identical but DISTINCT computation objects: the
        # interner's per-object short-circuit must not mask the test
        fab.submit(f, lambda x: {"y": x * 2.0},
                   tenant="a").result(timeout=30)
        fab.submit(f, lambda x: {"y": x * 2.0},
                   tenant="b").result(timeout=30)
        assert fab.health_snapshot()["placement"]["a"] != \
            fab.health_snapshot()["placement"]["b"]
        st = fab.compile_cache.stats()
        assert st["hits"] >= 1
        for w in fab._workers:
            assert w.scheduler.compile_cache is fab.compile_cache


# ---------------------------------------------------------------------------
# SLO-burn re-placement, driven by a fixed burn table (not by latencies)
# ---------------------------------------------------------------------------

def _burn_table(hot_total):
    return {"hot": {"burn_rate": 1000.0, "total": hot_total},
            "cool": {"burn_rate": 0.0, "total": 4}}


@pytest.mark.parametrize("p", BOTH, ids=["jax", "torch"])
def test_slo_burn_replaces_hot_tenant(tmp_path, monkeypatch, p):
    table = {"now": _burn_table(4)}
    monkeypatch.setattr(p.slo, "slo_status",
                        lambda tenant=None: table["now"])
    with p.top.serve.ServeFabric(workers=2, monitor=False, probe=False,
                                 persist_dir=str(tmp_path),
                                 name="burn") as fab:
        f = p.top.frame({"x": np.arange(8.0)}, num_partitions=2)
        for t in ("hot", "cool"):
            fab.submit(f, DOUBLE, tenant=t).result(timeout=30)
        before = dict(fab._placement)
        for _ in range(3 * fab.rebalance_ticks):
            fab.tick()
        after = dict(fab._placement)
        assert before["hot"] != after["hot"]
        assert before["cool"] == after["cool"]
        chain = p.top.why("tenant:hot")
        assert "fabric.rebalance" in chain and "SLO burn" in chain
        # stale evidence never ping-pongs: more ticks, no new queries
        for _ in range(4 * fab.rebalance_ticks):
            fab.tick()
        assert fab._placement["hot"] == after["hot"]
        # new evidence past the cooldown: the hot tenant moves again
        table["now"] = _burn_table(8)
        for _ in range(3 * fab.rebalance_ticks):
            fab.tick()
        assert fab._placement["hot"] == before["hot"]
        assert p.counters.get("fabric.rebalances") == 2


# ---------------------------------------------------------------------------
# observability surfaces
# ---------------------------------------------------------------------------

def test_health_and_doctor_show_fabric(tmp_path):
    with _fabric(tmp_path, "obs") as fab:
        f = ttf.frame({"x": np.arange(8.0)}, num_partitions=2)
        fab.submit(f, DOUBLE, tenant="a").result(timeout=30)
        h = ttf.health()
        assert h["fabric"]["running"] and h["fabric"]["workers"] == 2
        assert h["fabric"]["persist"]["enabled"]
        assert "fabric" in ttf.doctor()
        rep = serve_report(fab._workers[0].scheduler)
        # the report ends in the placement table
        assert rep.split("\n\n")[-1] == fab.placement_report()
        assert "placement: a->" in rep
        # the JAX package's fabric section, key for key
        assert set(h["fabric"]) == {
            "running", "enabled", "name", "workers", "live", "lost",
            "heartbeat_ms", "missed_hb_limit", "per_worker", "placement",
            "queries", "persist", "history"}
    assert not ttf.health()["fabric"].get("running", False)


def test_flight_records_carry_worker_and_dumps_merge(tmp_path):
    with _fabric(tmp_path, "wid") as fab:
        f = ttf.frame({"x": np.arange(8.0)}, num_partitions=2)
        fq = fab.submit(f, DOUBLE, tenant="a")
        fq.result(timeout=30)
        recs = tflight.for_query(fq.query_id)
        workers = {r.get("worker") for r in recs if r.get("worker")}
        assert workers <= {"w0", "w1"} and workers
    # per-worker dumps: the header carries worker=, records re-attribute
    p0 = str(tmp_path / "w0.jsonl")
    tflight.dump(p0, reason="test", worker="w0")
    with open(p0) as fh:
        head = json.loads(fh.readline())
    assert head["worker"] == "w0"
    merged = tflight.load_dumps([p0])
    assert merged and all(r.get("worker") for r in merged)


def test_doctor_merges_per_worker_dumps(tmp_path):
    tflight.record("serve.shed", tenant="t", est_bytes=1, headroom=0,
                   budget_s=1)
    p = str(tmp_path / "wX.jsonl")
    tflight.dump(p, reason="test", worker="wX")
    d = ttf.doctor(flight_dumps=[p])
    assert "per-worker dump" in d and "w=wX" in d


# ---------------------------------------------------------------------------
# the worker fault site without a fabric: park and same-process resume
# ---------------------------------------------------------------------------

def test_worker_fault_site_without_fabric_still_completes():
    """No fabric: the `worker` site parks the query and the SAME scheduler
    resumes it (there is no coordinator to kill the worker), so the site
    degrades to a preempt and resume, never a wrong answer."""
    with QueryScheduler(workers=1, name="solo") as sched:
        f = ttf.frame({"x": np.arange(32.0)}, num_partitions=4)
        faults.arm("worker", fail_n=1)
        q = sched.submit(f, DOUBLE)
        got = _col(q.result(timeout=30))
        np.testing.assert_array_equal(got, np.arange(32.0) * 2.0)
        assert q.preemptions >= 1


# ---------------------------------------------------------------------------
# heartbeat and lease through the monitor thread
# ---------------------------------------------------------------------------

@pytest.mark.timing
def test_monitor_declares_lost_within_lease_bound(tmp_path):
    import time
    hb_ms = 20.0
    with _fabric(tmp_path, "lease", monitor=True, heartbeat_ms=hb_ms,
                 missed_hb=3) as fab:
        faults.arm("worker", fail_n=1)
        # lease math: the fault is consumed on a beat, lost after 3
        # misses: generously 20 beat intervals, margin-scaled
        deadline = time.monotonic() + timing_margin(
            20 * (hb_ms / 1000.0) + 1.0)
        while time.monotonic() < deadline:
            if fab.health_snapshot()["lost"] == 1:
                break
            time.sleep(hb_ms / 1000.0)
        assert fab.health_snapshot()["lost"] == 1


# ---------------------------------------------------------------------------
# the same frames and programs through both packages' fabrics
# ---------------------------------------------------------------------------

FABRIC_COUNTERS = ("fabric.submitted", "fabric.worker_crashes",
                   "fabric.workers_lost", "fabric.redispatches",
                   "fabric.rebalances", "fabric.worker_restarts")


def _serve_both(tmp_path, fn, workers=2):
    """``fn(p, fab)`` in each package's fabric, counters and flight ring
    from zero; returns ``{name: (value, fabric.* counters, flight kinds
    of the fabric)}``."""
    out = {}
    for p in BOTH:
        p.counters.reset()
        p.flight.clear()
        p.res.faults.reset()
        with p.top.serve.ServeFabric(
                workers=workers, monitor=False, probe=False,
                persist_dir=str(tmp_path / p.name), name="par") as fab:
            v = fn(p, fab)
        kinds = sorted({r["kind"] for r in p.flight.recent()
                        if r["kind"].startswith("fabric.")})
        out[p.name] = (v, {k: p.counters.get(k) for k in FABRIC_COUNTERS},
                       kinds)
    return out


def test_parity_plain_map(tmp_path):
    x = np.random.default_rng(11).random(96)

    def fn(p, fab):
        f = p.top.frame({"x": x}, num_partitions=4)
        a = fab.submit(f, DOUBLE, tenant="a")
        b = fab.submit(f, PLUS1, tenant="b")
        return (_col(a.result(timeout=60)), _col(b.result(timeout=60)),
                dict(fab._placement))

    got = _serve_both(tmp_path, fn)
    (ja, jb, jplace), jc, jk = got["jax"]
    (ta, tb, tplace), tc, tk = got["torch"]
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)
    assert tplace == jplace and tc == jc and tk == jk == ["fabric.place"]


def test_parity_grouped_aggregate(tmp_path):
    """The port serves ``submit(grouped, fetches)`` whole on a worker; the
    JAX scheduler takes a frame, so its fabric serves the map and the
    caller aggregates. Integer-valued f64 sums agree exactly."""
    rng = np.random.default_rng(12)
    key = rng.integers(0, 30, 2_000)
    x = rng.integers(0, 500, 2_000).astype(np.float64)

    def fn(p, fab):
        src = p.top.frame({"key": key, "x": x}, num_partitions=4)
        if p is J:
            mapped = fab.submit(src, _twice, tenant="etl").result(
                timeout=60)
            out = jtf.aggregate({"z": "sum"},
                                mapped.select(["key", "z"]).group_by("key"))
        else:
            g = src.map_blocks(_twice).select(["key", "z"]).group_by("key")
            out = fab.submit(g, {"z": "sum"}, tenant="etl").result(
                timeout=60)
        c = out.blocks()[0].columns
        return _host(c["key"]), _host(c["z"])

    got = _serve_both(tmp_path, fn)
    (jkey, jz), jc, jk = got["jax"]
    (tkey, tz), tc, tk = got["torch"]
    np.testing.assert_array_equal(tkey, jkey)
    np.testing.assert_array_equal(tz, jz)
    np.testing.assert_array_equal(
        tz, np.bincount(key, weights=2 * x, minlength=30)[tkey])
    assert tc == jc and tk == jk


def test_parity_crash_mid_query_resumed_elsewhere(tmp_path):
    x = np.random.default_rng(13).random(64)

    def fn(p, fab):
        f = p.top.frame({"x": x}, num_partitions=8)
        p.res.faults.arm("worker", fail_n=1)
        fq = fab.submit(f, DOUBLE, tenant="alice")
        got = _col(fq.result(timeout=60))
        recs = [r for r in p.flight.for_query(fq.query_id)
                if r["kind"].startswith("fabric.")]
        tenant = [r["kind"] for r in p.flight.for_query("tenant:alice")]
        return (got, fq.attempts, fab.health_snapshot()["lost"],
                [(r["kind"], r["reason"], r["from_checkpoint"],
                  r["worker"], r["attempt"]) for r in recs],
                tenant, sorted(recs[0]))

    got = _serve_both(tmp_path, fn)
    jv, jc, jk = got["jax"]
    tv, tc, tk = got["torch"]
    np.testing.assert_allclose(tv[0], jv[0], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(tv[0], x * 2.0)
    assert tv[1:] == jv[1:]
    assert tv[3] == [("fabric.resume_dispatch", "worker_lost", True, "w1",
                      2)]
    assert tc == jc and tk == jk
    assert tc["fabric.worker_crashes"] == tc["fabric.workers_lost"] == 1


def _host(v):
    return v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
