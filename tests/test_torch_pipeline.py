"""The port's pipelined window against the JAX package's under faults:
the drain's sync fallback, attribution to the right block, permanent
errors raised at the drain, ``PipelinedExecutor`` and ``ReadyResult``.

Each case runs the same seeded inputs under the same fault schedule and
depth through both packages (the JAX package on the CPU with x64; the
port on the CPU) and compares values bit for bit, the counters
(``pipeline.submitted`` / ``.drained`` / ``.sync_fallbacks``,
``oom_split.dispatches``, ``retry.executor.dispatch.*``) and error types
and messages. Mirrors ``tests/test_pipeline.py``'s
``TestPipelineResilience`` and ``TestPipelinedExecutor``, but their
padded cases (``pad_compile`` fallbacks, the donating padded executable):
the port never pads.
"""

import weakref

import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu.engine.executor import BlockExecutor as JBlockExecutor
from tensorframes_tpu.engine.pipeline import \
    PipelinedExecutor as JPipelinedExecutor
from tensorframes_tpu_torch import resilience as trz
from tensorframes_tpu_torch.engine import ops as tops
from tensorframes_tpu_torch.engine.executor import (BlockExecutor,
                                                    PendingBlock)
from tensorframes_tpu_torch.engine.pipeline import (PipelinedExecutor,
                                                    ReadyResult,
                                                    pipeline_depth,
                                                    run_pipelined)
from tensorframes_tpu_torch.resilience import faults
from tensorframes_tpu_torch.utils import tracing
from tensorframes_tpu_torch.utils.tracing import counters
from test_torch_resilience import assert_same, col, run_both


@pytest.fixture(autouse=True)
def _fast_and_clean(monkeypatch):
    monkeypatch.setenv("TFT_RETRY_BASE_DELAY", "0.001")
    monkeypatch.setenv("TFT_RETRY_MAX_DELAY", "0.01")
    monkeypatch.delenv("TFT_PIPELINE_DEPTH", raising=False)
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    counters.reset()
    faults.reset()
    yield
    faults.reset()
    tracing.disable()
    ttf.set_default_device(prev)


def _depth(monkeypatch, d):
    monkeypatch.setenv("TFT_PIPELINE_DEPTH", str(d))


def _counters_consistent():
    sub = counters.get("pipeline.submitted")
    drn = counters.get("pipeline.drained")
    fb = counters.get("pipeline.sync_fallbacks")
    assert sub == drn, (sub, drn)
    assert fb <= drn
    return sub


class TestDepthKnob:
    def test_default_env_floor_and_malformed(self, monkeypatch):
        assert pipeline_depth() == 3
        for raw, want in (("5", 5), ("0", 1), ("-2", 1), ("many", 3)):
            monkeypatch.setenv("TFT_PIPELINE_DEPTH", raw)
            assert pipeline_depth() == want
        assert pipeline_depth(7) == 7


class TestPipelineResilience:
    def test_drain_error_attributed_to_right_block(self, monkeypatch):
        """One injected drain fault: every block's values still come back
        right and exactly one sync fallback is recorded."""
        _depth(monkeypatch, 3)
        got = assert_same(run_both(lambda m, rz: col(
            m.frame({"x": np.arange(24.0)}, num_partitions=4)
            .map_blocks(lambda x: {"y": x * 5.0})), "drain", 1))
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.arange(24.0) * 5.0)
        assert counters.get("pipeline.sync_fallbacks") == 1
        assert _counters_consistent() == 4

    @pytest.mark.parametrize("block", [0, 2, 3])
    def test_drain_fault_reruns_exactly_its_block(self, monkeypatch, block):
        """A fault at the drain of block ``block`` only: that block re-runs
        and its values, and its neighbours', come back in place."""
        _depth(monkeypatch, 2)

        def fn(m, rz):
            real, seen = rz.faults.check, {"n": -1}

            def check(site):
                if site == "drain":
                    seen["n"] += 1
                    if seen["n"] == block:
                        raise rz.InjectedFault("drain")
                return real(site)

            monkeypatch.setattr(rz.faults, "check", check)
            try:
                return col(m.frame({"x": np.arange(16.0)}, num_partitions=4)
                           .map_blocks(lambda x: {"y": x * 2.0 + 1.0}))
            finally:
                monkeypatch.setattr(rz.faults, "check", real)

        got = assert_same(run_both(fn))
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.arange(16.0) * 2.0 + 1.0)
        assert counters.get("pipeline.sync_fallbacks") == 1
        assert _counters_consistent() == 4

    def test_submit_error_defers_to_sync_recovery(self, monkeypatch):
        """A transient fault at the async submit (compile site) re-runs
        that block synchronously; the sync path absorbs further faults
        through its retry loop."""
        _depth(monkeypatch, 2)
        got = assert_same(run_both(lambda m, rz: col(
            m.frame({"x": np.arange(12.0)}, num_partitions=3)
            .map_blocks(lambda x: {"y": x + 2.0})), "compile", 4))
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.arange(12.0) + 2.0)
        assert counters.get("pipeline.sync_fallbacks") == 2
        assert counters.get("retry.executor.dispatch.retries") == 2
        _counters_consistent()

    def test_oom_split_recovers_under_pipelining(self, monkeypatch):
        """OOM faults outlasting the async submits reach the sync
        recovery's dispatch, which splits the block (map_rows: the
        row-local contract)."""
        _depth(monkeypatch, 2)
        got = assert_same(run_both(lambda m, rz: col(
            m.frame({"x": np.arange(16.0)}, num_partitions=2)
            .map_rows(lambda x: {"y": x * 3.0})), "oom", 3))
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.arange(16.0) * 3.0)
        assert counters.get("oom_split.dispatches") == 1
        assert counters.get("pipeline.sync_fallbacks") == 2
        _counters_consistent()

    def test_permanent_unpadded_error_reraises_without_rerun(
            self, monkeypatch):
        """A deterministic failure on the async path re-raises at the
        drain: no duplicate run, no bogus recovery count."""
        _depth(monkeypatch, 2)
        err = assert_same(run_both(lambda m, rz: col(
            m.frame({"x": np.arange(8.0)}, num_partitions=2)
            .map_blocks(lambda x: {"y": x + 1.0})), "dispatch", 1,
            transient=False))
        assert isinstance(err, trz.InjectedFault)
        assert counters.get("pipeline.sync_fallbacks") == 0

    def test_permanent_error_still_raises_at_drain(self, monkeypatch):
        """The sync recovery re-raises genuine failures: a fault armed
        past every recovery attempt propagates out of collect()."""
        monkeypatch.setenv("TFT_RETRY_MAX_ATTEMPTS", "1")
        _depth(monkeypatch, 2)
        err = assert_same(run_both(lambda m, rz: col(
            m.frame({"x": np.arange(8.0)}, num_partitions=2)
            .map_blocks(lambda x: {"y": x + 1.0})), "dispatch", 100))
        assert isinstance(err, trz.InjectedFault)
        assert counters.get("retry.executor.dispatch.giveups") == 1

    def test_oom_in_a_non_row_local_fused_stream_falls_back_per_op(
            self, monkeypatch):
        """A fused filter stage has no row-local contract: OOMs that
        outlast the async submits reach the sync re-run, which cannot
        split, and the forcing goes back to the per-op path
        (``plan.oom_fallbacks``), which the faults have left alone."""
        _depth(monkeypatch, 3)
        got = assert_same(run_both(lambda m, rz: col(
            m.frame({"x": np.arange(12.0)}, num_partitions=3)
            .map_blocks(lambda x: {"y": x + 1.0})
            .filter(lambda y: y > 4.0)), "oom", 4))
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.arange(5.0, 13.0))
        assert counters.get("oom_split.dispatches") == 0
        assert counters.get("pipeline.sync_fallbacks") == 1
        assert counters.get("plan.oom_fallbacks") == 1

    def test_submit_never_raises_and_records_the_error(self):
        df = ttf.frame({"x": np.arange(4.0)})
        comp = tops._map_computation(lambda x: {"y": x + 1.0}, df.schema,
                                     block_level=True)
        ex = BlockExecutor()
        with faults.inject("dispatch", fail_n=1, transient=False):
            pending = ex.submit(comp, {"x": np.arange(4.0)})
        assert isinstance(pending, PendingBlock)
        with pytest.raises(trz.InjectedFault):
            pending.drain()

    def test_failed_submit_does_not_pin_the_attempts_memory(self):
        """The error a submit records is released of its frames: the
        failed attempt's block-sized local is gone before the drain."""
        df = ttf.frame({"x": np.arange(8.0)})
        comp = tops._map_computation(lambda x: {"y": x + 1.0}, df.schema,
                                     block_level=True)
        seen = {}

        def prog(d):
            big = d["x"].new_zeros(d["x"].shape[0], 256)
            if "ref" not in seen:
                seen["ref"] = weakref.ref(big)
                raise MemoryError("host allocation failed")
            return {"y": d["x"] + 1.0 + big.sum(1)}

        comp = type(comp)(prog, comp.inputs, comp.outputs)
        ex = BlockExecutor()
        pending = ex.submit(comp, {"x": np.arange(8.0)}, row_local=True)
        assert seen["ref"]() is None, "the failed attempt is still alive"
        out = pending.drain()
        np.testing.assert_array_equal(out["y"], np.arange(8.0) + 1.0)
        assert counters.get("pipeline.sync_fallbacks") == 1

    def test_keep_device_drain_recovers_to_tensors(self):
        """A keep_device submit that failed drains, after its sync
        re-run and split, to tensors on the executor's device."""
        df = ttf.frame({"x": np.arange(8.0)})
        comp = tops._vmapped(tops._map_computation(
            lambda x: {"y": x * 2.0}, df.schema, block_level=False))
        ex = BlockExecutor()
        with faults.inject("oom", fail_n=2):
            out = ex.submit(comp, {"x": np.arange(8.0)}, row_local=True,
                            keep_device=True).drain()
        assert isinstance(out["y"], torch.Tensor)
        assert torch.equal(out["y"], torch.arange(8.0,
                                                  dtype=torch.float64) * 2)
        assert counters.get("oom_split.dispatches") == 1
        assert counters.get("pipeline.sync_fallbacks") == 1


    def test_real_cuda_oom_splits_at_the_drain_without_a_second_run(self):
        """A submit that fails with a real ``torch.cuda.OutOfMemoryError``
        (raised here for blocks over 4 rows) is split at the drain without
        the whole-block re-run, which would fail again at the same size.
        The counters equal the JAX package's, whose drain re-runs the block
        first (its out-of-memory error here is ``RESOURCE_EXHAUSTED`` text
        for the same sizes)."""
        from tensorframes_tpu.engine import ops as jops
        whole = {"jax": 0, "torch": 0}

        def fn(m, rz):
            df = m.frame({"x": np.arange(4.0)})
            ops, pkg = (jops, "jax") if m is jtf else (tops, "torch")
            comp = ops._map_computation(lambda x: {"y": x + 1.0},
                                        df.schema, block_level=True)

            def prog(d):
                if d["x"].shape[0] > 4:
                    whole[pkg] += 1
                    if m is jtf:
                        raise RuntimeError("RESOURCE_EXHAUSTED: out of "
                                           "memory allocating the block")
                    raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
                return {"y": d["x"] * 2.0}

            comp = type(comp)(prog, comp.inputs, comp.outputs)
            arrays = {"x": np.arange(8.0)}
            if m is jtf:
                return JBlockExecutor(pad_rows=True).submit(
                    comp, arrays).drain()["y"]
            return BlockExecutor().submit(comp, arrays,
                                          row_local=True).drain()["y"]

        got = assert_same(run_both(fn))
        np.testing.assert_array_equal(got, np.arange(8.0) * 2.0)
        assert counters.get("pipeline.sync_fallbacks") == 1
        assert counters.get("oom_split.dispatches") == 1
        assert whole == {"jax": 2, "torch": 1}


class TestWindowEdges:
    def test_depth_exceeding_block_count(self, monkeypatch):
        _depth(monkeypatch, 64)
        got = assert_same(run_both(lambda m, rz: col(
            m.frame({"x": np.arange(12.0)}, num_partitions=3)
            .map_blocks(lambda x: {"y": x - 1.0}))))
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.arange(12.0) - 1.0)
        assert _counters_consistent() == 3


class TestPipelinedExecutor:
    def test_pins_depth_over_env(self, monkeypatch):
        _depth(monkeypatch, 1)  # env says serial...

        def fn(m, rz):
            pex = (JPipelinedExecutor(JBlockExecutor(), depth=3)
                   if m is jtf else PipelinedExecutor(BlockExecutor(),
                                                      depth=3))
            assert pex.depth == 3
            return col(m.frame({"x": np.arange(20.0)}, num_partitions=4)
                       .map_blocks(lambda x: {"y": x * 2.0},
                                   executor=pex))

        got = assert_same(run_both(fn))
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.arange(20.0) * 2.0)
        # ...but the executor's pinned depth actually pipelined
        assert _counters_consistent() == 4

    def test_map_helper_orders_results(self):
        ex = PipelinedExecutor(BlockExecutor(), depth=2)
        df = ttf.frame({"x": np.arange(4.0)})
        comp = tops._map_computation(lambda x: {"y": x * 2.0}, df.schema,
                                     block_level=True)
        streams = [{"x": np.full(3, float(i))} for i in range(5)]
        outs = ex.map(streams, comp)
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o["y"], np.full(3, 2.0 * i))
        # the helper passes row_local on: an OOM'd block splits only then
        with faults.inject("oom", fail_n=2):
            with pytest.raises(trz.InjectedFault):
                ex.map(streams[:1], comp)
        assert counters.get("oom_split.dispatches") == 0
        # two submits fail, then block 0's sync re-run, which splits
        with faults.inject("oom", fail_n=3):
            outs = ex.map(streams, comp, row_local=True)
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o["y"], np.full(3, 2.0 * i))
        assert counters.get("oom_split.dispatches") == 1
        assert counters.get("pipeline.sync_fallbacks") == 2

    def test_occupancy_gauge_sampled(self, monkeypatch):
        _depth(monkeypatch, 3)
        tracing.timings.reset()
        tracing.enable()
        try:
            df = ttf.frame({"x": np.arange(30.0)}, num_partitions=6)
            df.map_blocks(lambda x: {"y": x + 1.0}).blocks()
        finally:
            tracing.disable()
        occ = tracing.timings.gauges_snapshot().get("pipeline.occupancy")
        assert occ is not None and occ["count"] == 6
        assert occ["max"] <= 3  # never exceeds the window
        assert occ["last"] == 3
        assert "pipeline.occupancy" not in tracing.timings.snapshot()

    def test_gauge_is_off_with_tracing_off(self, monkeypatch):
        _depth(monkeypatch, 3)
        tracing.timings.reset()
        df = ttf.frame({"x": np.arange(30.0)}, num_partitions=6)
        df.map_blocks(lambda x: {"y": x + 1.0}).blocks()
        assert tracing.timings.gauges_snapshot() == {}


class TestReadyResult:
    def test_executor_without_submit_runs_eagerly(self, monkeypatch):
        """An executor with only ``run`` streams through ReadyResult, its
        recovery included, with the same values and counters as the JAX
        package's."""
        _depth(monkeypatch, 3)

        class RunOnly:
            # forwards each package's own row-local say (the JAX
            # package's pad_ok, the port's row_local)
            def __init__(self, inner):
                self.inner = inner

            def resolve(self):
                return self.inner.resolve()

            def run(self, comp, arrays, keep_device=False, **say):
                return self.inner.run(comp, arrays, **say)

        def fn(m, rz):
            inner = (JBlockExecutor(pad_rows=True) if m is jtf
                     else BlockExecutor())
            return col(m.frame({"x": np.arange(16.0)}, num_partitions=2)
                       .map_rows(lambda x: {"y": x + 3.0},
                                 executor=RunOnly(inner)))

        got = assert_same(run_both(fn, "oom", 1))
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.arange(16.0) + 3.0)
        assert counters.get("oom_split.dispatches") == 1
        assert counters.get("pipeline.sync_fallbacks") == 0

    def test_ready_result_drains_its_value(self):
        r = ReadyResult({"y": 1})
        assert r.drain() == {"y": 1}
        assert run_pipelined([1, 2, 3], lambda b: b * 10,
                             lambda b: ReadyResult(b * 10),
                             lambda p, b: p.drain(), depth=2) == [10, 20, 30]
