"""The port's preemption against the JAX package's
(``tests/test_preempt.py``): classification, park and resume at block
boundaries in the engine (windowed, serial, per-op and fused), cancel,
and the checkpoint itself.

A query preempted at a block boundary (driven by the ``preempt`` fault
site, ``TFT_FAULTS=preempt:N``) parks its completed block outputs, resumes
dispatching ONLY the remaining blocks (the pipeline counters prove it),
and collects a result bit-identical to an uninterrupted run. Each case
runs the same seeded inputs through both packages (the JAX package on the
CPU with x64, the port on the CPU) and compares values and the
``pipeline.*`` / ``memory.*`` / ``serve.checkpoint_discards`` counters.

A stream's batch interrupted by a cancel raises out of ``step()`` and is
not counted as a poisoned batch (``TestStreamInterruption``).

Not mirrored here: the serve scheduler's preemption
(``TestSchedulerPreemption``), which waits for the serving layer
(``ROADMAP.md`` A11).
"""

import gc
import pickle
import threading
import weakref

import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import memory as jmem
from tensorframes_tpu import resilience as jrz
from tensorframes_tpu.engine import preempt as jpp
from tensorframes_tpu.memory import persist as jpersist
from tensorframes_tpu.observability import events as jevents
from tensorframes_tpu.utils import tracing as jtracing
from tensorframes_tpu.utils.tracing import counters as jcounters
from tensorframes_tpu_torch import memory as tmem
from tensorframes_tpu_torch import resilience as trz
from tensorframes_tpu_torch.engine import executor as texecutor
from tensorframes_tpu_torch.engine import pipeline as tpipeline
from tensorframes_tpu_torch.engine import preempt as tpp
from tensorframes_tpu_torch.memory import persist as tpersist
from tensorframes_tpu_torch.memory.checkpoint import QueryCheckpoint
from tensorframes_tpu_torch.observability import events as tevents
from tensorframes_tpu_torch.resilience import (QueryCancelled,
                                               QueryPreempted, faults)
from tensorframes_tpu_torch.utils import tracing as ttracing
from tensorframes_tpu_torch.utils.tracing import counters as tcounters

# package -> (root, preempt, resilience, memory, counters)
PKGS = {"jax": (jtf, jpp, jrz, jmem, jcounters),
        "torch": (ttf, tpp, trz, tmem, tcounters)}

WATCHED = ("pipeline.", "memory.", "serve.checkpoint", "persist.")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("TFT_ADAPTIVE", "0")
    monkeypatch.setenv("TFT_RESULT_CACHE", "0")
    monkeypatch.delenv("TFT_PIPELINE_DEPTH", raising=False)
    monkeypatch.delenv("TFT_FUSE", raising=False)
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    for *_, rz, mem, c in PKGS.values():
        c.reset()
        rz.faults.reset()
    yield
    for *_, rz, mem, c in PKGS.values():
        rz.faults.reset()
        mem._reset()
    jtracing.disable()
    ttracing.disable()
    ttf.set_default_device(prev)


def _chain(m, n=40, parts=8, mul=2.0):
    return m.frame({"x": np.arange(float(n))},
                   num_partitions=parts).map_rows(lambda x: {"y": x * mul})


def _ys(frame):
    return [r["y"] for r in frame.collect()]


def _watched(c):
    return {k: v for k, v in c.snapshot().items() if k.startswith(WATCHED)}


def both(fn):
    """``fn(m, pp, rz)`` per package, counters from zero; returns
    ``{pkg: (value, watched counters)}``."""
    out = {}
    for name, (m, pp, rz, mem, c) in PKGS.items():
        c.reset()
        out[name] = (fn(m, pp, rz), _watched(c))
    return out


def same(res):
    (jv, jc), (tv, tc) = res["jax"], res["torch"]
    assert tc == jc, (tc, jc)
    assert tv == jv, (tv, jv)
    return tv


def drive(pp, rz, frame, sc, limit=10):
    """Force ``frame`` under ``sc`` until it completes; per attempt the
    cursor parked (or ``"done"``), the blocks submitted and resumed."""
    c = tcounters if pp is tpp else jcounters
    log = []
    for _ in range(limit):
        s0 = c.get("pipeline.submitted")
        r0 = c.get("pipeline.resumed_blocks")
        try:
            with pp.activate(sc):
                frame.blocks()
        except rz.QueryPreempted:
            log.append((sc.checkpoint.parked_blocks,
                        c.get("pipeline.submitted") - s0,
                        c.get("pipeline.resumed_blocks") - r0))
            continue
        log.append(("done", c.get("pipeline.submitted") - s0,
                    c.get("pipeline.resumed_blocks") - r0))
        return log
    raise AssertionError(f"preemption did not converge: {log}")


# ---------------------------------------------------------------------------
# classification + fault site
# ---------------------------------------------------------------------------

class TestClassification:
    def test_kinds_and_transience(self):
        def fn(m, pp, rz):
            p = rz.QueryPreempted("parked")
            c = rz.QueryCancelled("stopped")
            return (rz.error_kind(p), rz.error_kind(c), rz.is_transient(p),
                    rz.is_transient(c),
                    rz.is_transient(rz.QueryCancelled("CANCELLED by user")))
        assert same(both(fn)) == ("preempted", "cancelled", False, False,
                                  False)

    def test_tft_faults_env_arms_preempt_site(self, monkeypatch):
        monkeypatch.setenv("TFT_FAULTS", "preempt:2")
        for *_, rz, mem, c in PKGS.values():
            monkeypatch.setattr(rz.faults._state, "_armed_env", False)
            assert rz.faults.active("preempt") == 2
            assert rz.faults.may_fire("preempt")
            assert not rz.faults.may_fire("dispatch")
        assert "preempt" in faults.sites()

    def test_interrupted_never_retried_by_policy(self):
        def fn(m, pp, rz):
            calls = []

            def work():
                calls.append(1)
                raise rz.QueryPreempted("park me")
            with pytest.raises(rz.QueryPreempted):
                rz.default_policy().call(work, op="test")
            return len(calls)
        assert same(both(fn)) == 1  # no retry of a caller's decision


# ---------------------------------------------------------------------------
# engine: park at a boundary, resume only the remaining blocks
# ---------------------------------------------------------------------------

class TestEngineParkResume:
    def test_windowed_park_resume_bit_identical(self):
        def fn(m, pp, rz):
            df = _chain(m, 40, 8)
            sc = pp.PreemptionScope("q")
            rz.faults.arm("preempt", 1)
            log = drive(pp, rz, df, sc)
            return log, _ys(df), len(df.blocks())
        res = both(fn)
        log, ys, n = same(res)
        parked = log[0][0]
        assert parked >= 1
        # the resume dispatched ONLY the remaining blocks
        assert log[1] == ("done", 8 - parked, parked)
        assert ys == [2.0 * i for i in range(40)] and n == 8
        assert res["torch"][1]["pipeline.parked_blocks"] == parked

    def test_serial_depth1_park_resume(self, monkeypatch):
        monkeypatch.setenv("TFT_PIPELINE_DEPTH", "1")

        def fn(m, pp, rz):
            df = _chain(m, 40, 8, mul=3.0)
            sc = pp.PreemptionScope("q")
            rz.faults.arm("preempt", 1)
            return drive(pp, rz, df, sc), _ys(df)
        log, ys = same(both(fn))
        assert log[0][0] >= 1 and log[1][2] == log[0][0]
        assert ys == [3.0 * i for i in range(40)]

    def test_per_op_path_park_resume(self, monkeypatch):
        monkeypatch.setenv("TFT_FUSE", "0")

        def fn(m, pp, rz):
            df = _chain(m, 40, 8, mul=5.0)
            sc = pp.PreemptionScope("q")
            rz.faults.arm("preempt", 1)
            return drive(pp, rz, df, sc), _ys(df)
        log, ys = same(both(fn))
        assert len(log) == 2 and ys == [5.0 * i for i in range(40)]

    def test_repeated_preemption_converges(self):
        # every injected preemption parks at a strictly later cursor, so N
        # preemptions never livelock, and each resume re-dispatches only
        # the blocks past its checkpoint
        def fn(m, pp, rz):
            df = _chain(m, 40, 8, mul=7.0)
            sc = pp.PreemptionScope("q")
            rz.faults.arm("preempt", 3)
            return drive(pp, rz, df, sc), _ys(df)
        res = both(fn)
        log, ys = same(res)
        assert log == [(1, 1, 0), (2, 1, 1), (3, 1, 2), ("done", 5, 3)]
        assert ys == [7.0 * i for i in range(40)]
        assert res["torch"][1]["pipeline.preempted_streams"] == 3

    def test_fused_multi_stage_chain_parks_and_resumes(self):
        """A fused chain whose first stage's edge stays device-resident
        (map_blocks -> filter -> map_blocks: two stages) parks its final
        blocks and resumes under the plan's tag."""
        x = np.random.default_rng(5).standard_normal(64)

        def fn(m, pp, rz):
            df = (m.frame({"x": x}, num_partitions=8)
                  .map_blocks(lambda x: {"y0": x * 2.0})
                  .filter(lambda y0: y0 > -1.0)
                  .map_blocks(lambda y0: {"y": y0 + 1.0}))
            sc = pp.PreemptionScope("q")
            rz.faults.arm("preempt", 2)
            log = drive(pp, rz, df, sc)
            return log, _ys(df), df._plan_info is not None
        log, ys, fused = same(both(fn))
        assert fused and log[-1][0] == "done" and len(log) == 3
        want = x * 2.0
        assert ys == list(want[want > -1.0] + 1.0)

    def test_resume_down_another_path_discards(self, monkeypatch):
        """Parked on the fused path, resumed per-op: the tags differ, so
        the checkpoint is discarded and the query re-runs cold."""
        def fn(m, pp, rz):
            df = _chain(m, 40, 8, mul=11.0).map_rows(  # two ops: fuses
                lambda y: {"w": y + 1.0})
            sc = pp.PreemptionScope("q")
            rz.faults.arm("preempt", 1)
            with pytest.raises(rz.QueryPreempted):
                with pp.activate(sc):
                    df.blocks()
            assert sc.checkpoint._parked[2].startswith("plan[")
            monkeypatch.setenv("TFT_FUSE", "0")
            try:
                with pp.activate(sc):
                    df.blocks()
            finally:
                monkeypatch.delenv("TFT_FUSE")
            return _ys(df), sc.checkpoint.empty
        res = both(fn)
        ys, empty = same(res)
        assert empty and ys == [11.0 * i for i in range(40)]
        assert res["torch"][1]["serve.checkpoint_discards"] == 1
        assert "pipeline.resumed_blocks" not in res["torch"][1]

    def test_cancel_raises_at_boundary_and_frees_checkpoint(self):
        def fn(m, pp, rz):
            df = _chain(m, 40, 8)
            sc = pp.PreemptionScope("q")
            rz.faults.arm("preempt", 1)
            with pytest.raises(rz.QueryPreempted):
                with pp.activate(sc):
                    df.blocks()
            parked = not sc.checkpoint.empty
            sc.request_cancel("user")
            with pytest.raises(rz.QueryCancelled) as ei:
                with pp.activate(sc):
                    df.blocks()
            return parked, sc.checkpoint.empty, str(ei.value)
        res = both(fn)
        assert same(res) == (True, True, "query q cancelled at a block "
                                         "boundary (user)")
        assert res["torch"][1]["pipeline.cancelled_streams"] == 1

    def test_cancel_from_another_thread_mid_stream(self, monkeypatch):
        """A cancel requested from another thread while the stream runs
        raises at the next boundary, frees the checkpoint, and lets the
        undrained window's blocks (and their device buffers) go with the
        exception, not when it is collected."""
        monkeypatch.setenv("TFT_PIPELINE_DEPTH", "4")
        df = _chain(ttf, 64, 8, mul=2.0)
        sc = tpp.PreemptionScope("q")
        faults.arm("preempt", 1)
        with pytest.raises(QueryPreempted):
            with tpp.activate(sc):
                df.blocks()
        assert not sc.checkpoint.empty
        pendings = []
        real_launch = texecutor.BlockExecutor._launch
        real_call = texecutor.BlockExecutor._call

        def launch(self, *a, **kw):
            p = real_launch(self, *a, **kw)
            pendings.append(weakref.ref(p))
            return p

        def call(self, comp, dev):
            if len(pendings) == 3:  # mid-stream: 3 blocks in flight
                t = threading.Thread(target=sc.request_cancel,
                                     args=("from another thread",))
                t.start()
                t.join(timeout=10)
                assert not t.is_alive()
            return real_call(self, comp, dev)
        monkeypatch.setattr(texecutor.BlockExecutor, "_launch", launch)
        monkeypatch.setattr(texecutor.BlockExecutor, "_call", call)
        try:
            with tpp.activate(sc):
                df.blocks()
            raise AssertionError("the cancel did not stop the stream")
        except QueryCancelled as e:
            assert "from another thread" in str(e)
            # the exception is still alive here: its traceback's frames
            # must not pin the window's pending blocks
            assert [r for r in pendings if r() is not None] == []
        assert sc.checkpoint.empty
        assert tcounters.get("pipeline.cancelled_streams") == 1
        assert df._cache is None

    def test_preempt_event_and_summary(self):
        for (m, pp, rz, mem, c), events, tracing in (
                (PKGS["jax"], jevents, jtracing),
                (PKGS["torch"], tevents, ttracing)):
            df = _chain(m, 40, 8)
            sc = pp.PreemptionScope("q")
            rz.faults.arm("preempt", 1)
            tracing.enable()
            try:
                with pytest.raises(rz.QueryPreempted):
                    with pp.activate(sc):
                        df.blocks()
                t = events.last_query()
                assert t.count("preempt_park") == 1
                assert t.summary()["preempts"] == 1
                ev = [e for e in t.events if e.etype == "preempt_park"][0]
                assert ev.name == "q" and ev.args["total"] == 8
                assert ev.args["blocks"] == sc.checkpoint.parked_blocks
                with pp.activate(sc):
                    df.blocks()
                t2 = events.last_query()
                assert t2.summary()["resumed_blocks"] == ev.args["blocks"]
            finally:
                tracing.disable()

    def test_anonymous_stream_parks_without_checkpoint(self):
        def fn(m, pp, rz):
            from importlib import import_module
            pipe = import_module(f"{m.__name__}.engine.pipeline")
            sc = pp.PreemptionScope("q")
            rz.faults.arm("preempt", 1)
            blocks = list(range(6))
            kw = {"depth": 3}
            with pytest.raises(rz.QueryPreempted) as ei:
                with pp.activate(sc):
                    pipe.run_pipelined(blocks, lambda b: b * 2,
                                       lambda b: b * 2, lambda p, b: p,
                                       **kw)
            return str(ei.value), sc.checkpoint is None
        res = both(fn)
        assert same(res) == ("query q preempted (anonymous stream, no "
                             "checkpoint) (injected fault: injected "
                             "transient fault at site 'preempt')", True)

    def test_same_tag_siblings_resume_into_their_own_stream(self):
        """Two streams with one tag in one attempt: the ordinal suffix
        keeps the second's checkpoint out of the first."""
        sc = tpp.PreemptionScope("q")
        faults.arm("preempt", 1)
        out = []

        def attempt():
            with tpp.activate(sc):
                a = tpipeline.run_pipelined(list(range(4)), lambda b: b,
                                            lambda b: b, lambda p, b: p,
                                            depth=2, tag="t")
                b = tpipeline.run_pipelined(list(range(4)),
                                            lambda b: b + 10,
                                            lambda b: b + 10,
                                            lambda p, b: p, depth=2,
                                            tag="t")
            return a, b
        with pytest.raises(QueryPreempted):
            attempt()  # the first stream parks at block 1
        out = attempt()
        assert out == ([0, 1, 2, 3], [10, 11, 12, 13])
        assert tcounters.get("pipeline.resumed_blocks") == 1


# ---------------------------------------------------------------------------
# the checkpoint itself
# ---------------------------------------------------------------------------

class TestQueryCheckpoint:
    def test_block_and_dict_round_trip(self):
        def fn(m, pp, rz):
            from importlib import import_module
            ck = import_module(f"{m.__name__}.memory.checkpoint")
            b = m.Block({"x": np.arange(5.0),
                         "s": np.array(list("abcde"), object)}, 5)
            d = {"y": np.arange(3, dtype=np.int64)}
            cp = ck.QueryCheckpoint("q")
            cp.park_stream([b, d], total=4)
            out = cp.resume_stream(4)
            return (type(out[0]).__name__, out[0].columns["x"].tolist(),
                    list(out[0].columns["s"]), out[1]["y"].tolist(),
                    cp.empty)
        assert same(both(fn)) == ("Block", [0.0, 1.0, 2.0, 3.0, 4.0],
                                  list("abcde"), [0, 1, 2], True)

    def test_device_arrays_spill_and_fault_back_bitwise(self):
        tmem.configure(limit_bytes=1 << 30)
        vals = [torch.arange(1000, dtype=torch.float32),
                torch.arange(8, dtype=torch.float32).to(torch.bfloat16)]
        cp = QueryCheckpoint("q")
        moved = cp.park_stream(vals, total=2)
        assert moved == 4000 + 16
        assert tcounters.get("memory.spills") == 1
        assert tcounters.get("memory.spill_bytes") == 4016
        out = cp.resume_stream(2)
        for a, b in zip(vals, out):
            assert b.dtype == a.dtype and b.device == a.device
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        assert tcounters.get("memory.faults") == 1
        # the JAX package counts the same traffic for the same bytes
        import jax
        jmem.configure(limit_bytes=1 << 30)
        from tensorframes_tpu.memory.checkpoint import QueryCheckpoint as J
        jcp = J("q")
        assert jcp.park_stream(
            [jax.device_put(np.arange(1000, dtype=np.float32))],
            total=1) == 4000
        jcp.resume_stream(1)
        assert (jcounters.get("memory.spills"),
                jcounters.get("memory.faults")) == (1, 1)

    def test_mismatched_stream_discards(self):
        def fn(m, pp, rz):
            cp = pp.PreemptionScope("q").ensure_checkpoint()
            cp.park_stream([{"x": np.arange(2)}], total=4)
            return cp.resume_stream(6), cp.empty  # plan changed: discard
        res = both(fn)
        assert same(res) == (None, True)
        assert res["torch"][1]["serve.checkpoint_discards"] == 1

    def test_mismatched_tag_discards(self):
        def fn(m, pp, rz):
            cp = pp.PreemptionScope("q").ensure_checkpoint()
            cp.park_stream([{"x": np.arange(2)}], total=4, tag="plan[2ops]")
            return cp.resume_stream(4, tag="map_rows(source)"), cp.empty
        res = both(fn)
        assert same(res) == (None, True)
        assert res["torch"][1]["serve.checkpoint_discards"] == 1

    def test_free_drops_parked_state(self):
        def fn(m, pp, rz):
            cp = pp.PreemptionScope("q").ensure_checkpoint()
            cp.park_stream([{"x": np.arange(2)}], total=4)
            cp.free()
            return cp.empty, cp.resume_stream(4), repr(cp)
        assert same(both(fn)) == (True, None, "QueryCheckpoint('q', empty)")

    def test_parked_prefix_and_persisted_schema_match(self, tmp_path):
        """The state that crosses packages: a stream parked in each holds
        the same prefix (numpy, block for block, in order), and the
        persisted records carry the same fields."""
        x = np.random.default_rng(6).standard_normal(64)
        prefixes, records = {}, {}
        for name, persist in (("jax", jpersist), ("torch", tpersist)):
            m, pp, rz, mem, c = PKGS[name]
            prev = persist.configure(str(tmp_path / name))
            try:
                df = m.frame({"x": x}, num_partitions=8).map_rows(
                    lambda x: {"y": x * 3.0})
                sc = pp.PreemptionScope(f"q-{name}")
                rz.faults.arm("preempt", 2)
                for _ in range(2):
                    with pytest.raises(rz.QueryPreempted):
                        with pp.activate(sc):
                            df.blocks()
                vals, total, tag = sc.checkpoint._parked
                prefixes[name] = [v[1] for v in vals]
                files = list((tmp_path / name / "checkpoints").iterdir())
                raw = files[0].read_bytes()
                records[name] = pickle.loads(
                    raw[len(persist._MAGIC) + persist._DIGEST_LEN:])
            finally:
                persist.configure(prev)
        assert len(prefixes["torch"]) == len(prefixes["jax"]) == 2
        for jb, tb in zip(prefixes["jax"], prefixes["torch"]):
            assert list(tb) == list(jb)
            for k in jb:
                assert jb[k][0] == tb[k][0] == "raw"
                np.testing.assert_array_equal(tb[k][1], jb[k][1])
        assert set(records["torch"]) == set(records["jax"]) == {
            "version", "query_id", "tag", "total", "vals", "parked_blocks",
            "moved_bytes"}
        for k in ("version", "total", "parked_blocks", "moved_bytes"):
            assert records["torch"][k] == records["jax"][k], k


# ---------------------------------------------------------------------------
# streams: interruption is control flow, not poisoned data
# ---------------------------------------------------------------------------

class TestStreamInterruption:
    def test_cancel_propagates_not_skip_counted(self):
        from tensorframes_tpu import stream as jstream
        from tensorframes_tpu_torch import stream as tstream
        out = {}
        for name, (m, pp, rz, _mem, c) in PKGS.items():
            stream = jstream if m is jtf else tstream
            src = stream.GeneratorSource(
                ({"x": np.arange(4.0) + i} for i in range(100)))
            handle = stream.StreamingFrame(src).map_rows(
                lambda x: {"y": x * 2}).start()
            assert handle.step(timeout=1.0) is True  # a healthy batch
            sc = pp.PreemptionScope("op")
            sc.request_cancel("operator stop")
            with pytest.raises(rz.QueryCancelled) as ei:
                with pp.activate(sc):
                    handle.step(timeout=1.0)
            m_ = handle.metrics()
            handle.stop()
            out[name] = (str(ei.value), m_["batches_skipped"],
                         m_["batches"], c.get("stream.batches_skipped"))
        assert out["torch"] == out["jax"]
        # not counted as poisoned
        assert out["torch"][1:] == (0, 1, 0)
