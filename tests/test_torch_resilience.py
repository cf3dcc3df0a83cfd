"""The port's resilience core against the JAX package's: retries,
deadlines, fault injection, the executor's OOM row split, and the plan's
OOM fallback.

Each case runs the same seeded numpy inputs under the same fault schedule
through both packages (the JAX package on the CPU with x64, as its own
tests run it; the port on the CPU) and compares the values bit for bit,
the resilience counters, and the error types and messages. The cases
mirror ``tests/test_resilience.py``'s ``TestRetryPolicy``,
``TestDeadline``, ``TestFaults`` and ``TestEngineResilience``. Left out:
its three padded-compile cases (``pad_compile``, the bucketed executor's
exact-shape fallback and ``PaddingExecutor``), because the port never pads
and has no bucketed compile to fail; the cluster bootstrap, mesh and
concurrent-compile classes, which belong to layers not ported yet.
"""

import dataclasses
import re
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from chip_smoke import rff_query, rff_tables
from conftest import timing_margin
from tensorframes_tpu import resilience as jrz
from tensorframes_tpu.engine.executor import BlockExecutor as JBlockExecutor
from tensorframes_tpu.utils.tracing import counters as jcounters
from tensorframes_tpu_torch import resilience as trz
from tensorframes_tpu_torch.engine.executor import BlockExecutor
from tensorframes_tpu_torch.resilience import faults
from tensorframes_tpu_torch.utils.tracing import counters

PKGS = {"jax": (jtf, jrz, jcounters), "torch": (ttf, trz, counters)}

# counters the JAX package keeps for layers the port has no counterpart of
# (the jit compile cache, the row-conservation auditor, the adaptive
# result cache)
_ONLY_JAX = ("compile_cache.", "invariants.", "plan.result_cache")


@pytest.fixture(autouse=True)
def _fast_and_clean(monkeypatch):
    """Millisecond backoffs, clean counters and faults in both packages,
    and the port on the CPU."""
    monkeypatch.setenv("TFT_RETRY_BASE_DELAY", "0.001")
    monkeypatch.setenv("TFT_RETRY_MAX_DELAY", "0.01")
    monkeypatch.delenv("TFT_PIPELINE_DEPTH", raising=False)
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    for _, rz, c in PKGS.values():
        c.reset()
        rz.faults.reset()
    yield
    for _, rz, _c in PKGS.values():
        rz.faults.reset()
    ttf.set_default_device(prev)


def run_both(fn, site=None, fail_n=0, **inject):
    """``fn(tf, rz)`` in each package under the same fault schedule.
    Returns ``{pkg: (value or exception, counters)}``; each package's
    counters start from zero."""
    out = {}
    for name, (m, rz, c) in PKGS.items():
        c.reset()
        try:
            if site is None:
                v = fn(m, rz)
            else:
                with rz.faults.inject(site, fail_n=fail_n, **inject):
                    v = fn(m, rz)
        except Exception as e:  # compared across packages below
            v = e
        out[name] = (v, {k: n for k, n in c.snapshot().items()
                         if not k.startswith(_ONLY_JAX)})
    return out


def assert_same(res, values_equal=None):
    """Equal counters; equal values (bit for bit), or the same error type
    and message. Returns the port's value."""
    (jv, jc), (tv, tc) = res["jax"], res["torch"]
    assert tc == jc, (tc, jc)
    if isinstance(jv, Exception) or isinstance(tv, Exception):
        assert type(tv).__name__ == type(jv).__name__, (tv, jv)
        assert str(tv) == str(jv)
        return tv
    (values_equal or _equal)(jv, tv)
    return tv


def _equal(jv, tv):
    if isinstance(jv, list):
        assert len(jv) == len(tv)
        for a, b in zip(jv, tv):
            _equal(a, b)
        return
    a, b = np.asarray(jv), np.asarray(tv)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(b, a)


def col(frame, name="y"):
    """A forced frame's column, block by block."""
    return [np.asarray(b.columns[name]) for b in frame.blocks()]


# ---------------------------------------------------------------------------
# policy + deadline primitives
# ---------------------------------------------------------------------------

class TestRetryPolicy:
    def test_retries_then_succeeds(self):
        calls = {"jax": [], "torch": []}

        def fn(m, rz):
            log = calls["jax" if m is jtf else "torch"]

            def flaky():
                log.append(1)
                rz.faults.check("unit")
                return 42
            return rz.RetryPolicy(max_attempts=3, base_delay=0.001).call(
                flaky, op="unit")

        res = run_both(fn, "unit", 2)
        assert assert_same(res) == 42
        assert calls["torch"] == calls["jax"] == [1, 1, 1]
        assert counters.get("retry.unit.retries") == 2
        assert counters.get("retry.unit.giveups") == 0

    def test_gives_up_and_raises_last(self):
        res = run_both(lambda m, rz: rz.RetryPolicy(
            max_attempts=2, base_delay=0.001).call(
                lambda: rz.faults.check("unit"), op="unit"), "unit", 10)
        assert isinstance(assert_same(res), trz.InjectedFault)
        assert counters.get("retry.unit.retries") == 1
        assert counters.get("retry.unit.giveups") == 1

    def test_permanent_errors_not_retried(self):
        calls = []

        def fn(m, rz):
            def broken():
                calls.append(1)
                raise ValueError("shape mismatch: deterministic, do not "
                                 "retry")
            return rz.RetryPolicy(max_attempts=5).call(broken, op="unit")

        assert isinstance(assert_same(run_both(fn)), ValueError)
        assert len(calls) == 2  # once in each package
        assert counters.get("retry.unit.retries") == 0

    def test_backoff_is_deterministic_and_bounded(self):
        kw = dict(base_delay=0.1, multiplier=2.0, max_delay=0.5,
                  jitter=0.25)
        p, pj = trz.RetryPolicy(**kw), jrz.RetryPolicy(**kw)
        delays = [p.backoff(i, op="x") for i in range(6)]
        assert delays == [pj.backoff(i, op="x") for i in range(6)]
        assert delays == [p.backoff(i, op="x") for i in range(6)]
        assert all(d <= 0.5 * 1.25 + 1e-9 for d in delays)
        p0 = trz.RetryPolicy(base_delay=0.1, multiplier=2.0, max_delay=0.5,
                             jitter=0.0)
        assert [round(p0.backoff(i), 3) for i in range(4)] == \
            [0.1, 0.2, 0.4, 0.5]

    def test_env_knobs(self, monkeypatch):
        monkeypatch.setenv("TFT_RETRY_MAX_ATTEMPTS", "7")
        monkeypatch.setenv("TFT_RETRY_DEADLINE", "12.5")
        assert dataclasses.asdict(trz.default_policy()) == \
            dataclasses.asdict(jrz.default_policy())
        assert trz.default_policy().max_attempts == 7
        assert trz.default_policy().deadline == 12.5

    def test_policy_validation_messages(self):
        for kw in ({"max_attempts": 0}, {"jitter": 1.0}):
            with pytest.raises(ValueError) as jt:
                jrz.RetryPolicy(**kw)
            with pytest.raises(ValueError, match=re.escape(str(jt.value))):
                trz.RetryPolicy(**kw)


@pytest.mark.timing
class TestDeadline:
    def test_expiry_raises_within_budget(self):
        t0 = time.monotonic()
        with pytest.raises(trz.DeadlineExceeded):
            with trz.deadline(0.05):
                with faults.inject("unit", fail_n=100):
                    trz.RetryPolicy(max_attempts=100,
                                    base_delay=0.02).call(
                        lambda: faults.check("unit"), op="unit")
        # a generous margin over the 0.05 s budget: it proves the loop
        # stopped, not that the box was idle
        assert time.monotonic() - t0 < timing_margin(3.0)
        # it stops once: either the next backoff would outlive the
        # deadline (a giveup) or the deadline expired during a sleep
        assert counters.get("retry.unit.giveups") \
            + counters.get("deadline.unit.expired") == 1

    def test_nested_deadlines_only_shrink(self):
        with trz.deadline(10.0):
            with trz.deadline(0.01):
                left = trz.remaining_time()
                assert left is not None and left <= 0.011
            outer_left = trz.remaining_time()
            assert outer_left is not None and outer_left > 1.0
        assert trz.remaining_time() is None

    def test_check_deadline_counts(self):
        def fn(m, rz):
            with rz.deadline(0.001):
                time.sleep(0.005)
                rz.check_deadline("op_x")

        res = run_both(fn)
        (jv, jc), (tv, tc) = res["jax"], res["torch"]
        assert tc == jc == {"deadline.op_x.expired": 1}
        # the message carries the measured overrun, so only its head is
        # the same in both packages
        assert type(tv).__name__ == type(jv).__name__ == "DeadlineExceeded"
        assert str(tv).startswith("op_x: deadline expired (")
        assert str(jv).startswith("op_x: deadline expired (")

    def test_deadline_rejects_non_positive(self):
        with pytest.raises(ValueError) as jt:
            jrz.deadline(0)
        with pytest.raises(ValueError, match=str(jt.value)):
            trz.deadline(0)


class TestFaults:
    def test_budget_is_exact(self):
        with faults.inject("unit", fail_n=2):
            for _ in range(2):
                with pytest.raises(trz.InjectedFault):
                    faults.check("unit")
            faults.check("unit")  # the third passes
        faults.check("unit")  # disarmed on exit
        assert counters.get("faults.unit.injected") == 2

    def test_env_driven(self, monkeypatch):
        monkeypatch.setenv("TFT_FAULTS", "envsite:1")
        # env parsing is once per process; force it for the test
        faults._state._armed_env = False
        try:
            with pytest.raises(trz.InjectedFault):
                faults.check("envsite")
            faults.check("envsite")
        finally:
            faults.reset()

    def test_oom_site_is_oom_shaped(self):
        for rz in (jrz, trz):
            with rz.faults.inject("oom", fail_n=1):
                with pytest.raises(rz.InjectedFault) as ei:
                    rz.faults.check("oom")
            assert rz.is_oom(ei.value)
            assert not rz.is_transient(ei.value)
            assert str(ei.value).startswith("RESOURCE_EXHAUSTED")

    def test_sites_are_the_ports_and_chaos_waits(self, monkeypatch):
        assert set(faults.sites()) == {"compile", "dispatch", "oom",
                                       "drain", "perf", "preempt", "disk"}
        assert set(faults.sites()) <= set(jrz.faults.sites())
        monkeypatch.setenv("TFT_CHAOS", "seed:1,rate:0.5")
        faults._state._armed_env = False
        try:
            with pytest.raises(NotImplementedError, match="A11"):
                faults.check("dispatch")
        finally:
            monkeypatch.delenv("TFT_CHAOS")
            faults._state._armed_env = False

    def test_unknown_site_warns_and_counts(self):
        faults.arm("no_such_site", 1)
        faults.reset()
        assert counters.get("faults.unknown_sites") == 1

    @pytest.mark.parametrize("site", ["device", "worker"])
    def test_sites_of_later_layers_are_unknown_and_unshaped(self, site):
        """The mesh's and the fabric's sites come with those layers:
        arming one warns like any unknown site, and its fault carries none
        of the JAX package's shaping (device loss, worker loss)."""
        with faults.inject(site, fail_n=1):
            with pytest.raises(trz.InjectedFault) as ei:
                faults.check(site)
        assert counters.get("faults.unknown_sites") == 1
        assert trz.error_kind(ei.value) == "transient"
        with jrz.faults.inject(site, fail_n=1):
            with pytest.raises(jrz.InjectedFault) as ej:
                jrz.faults.check(site)
        assert jrz.error_kind(ej.value) != "transient"

    def test_disk_site_is_shaped_like_the_jax_package(self):
        """The persist tier's site came with ``memory/persist.py``: it is
        known, and its fault is the JAX package's failed read,
        non-transient."""
        with faults.inject("disk", fail_n=1):
            with pytest.raises(trz.InjectedFault) as ei:
                faults.check("disk")
        with jrz.faults.inject("disk", fail_n=1):
            with pytest.raises(jrz.InjectedFault) as ej:
                jrz.faults.check("disk")
        assert counters.get("faults.unknown_sites") == 0
        assert str(ei.value) == str(ej.value)
        assert trz.error_kind(ei.value) == jrz.error_kind(ej.value)
        assert not ei.value.transient

    def test_perf_slowdown_sleeps_and_never_raises(self, monkeypatch):
        monkeypatch.setenv("TFT_FAULT_PERF_S", "0.001")
        with faults.inject("perf", fail_n=1):
            assert faults.slowdown("perf") == 0.001
            assert faults.slowdown("perf") == 0.0
        assert counters.get("faults.perf.injected") == 1


class TestEnvKnobs:
    """One parser for every knob of the port (``utils/env.py``), reading
    each value as the JAX package's ``env_*`` does."""

    @pytest.mark.parametrize("raw", [None, "", "3", "2.5", "x", "0",
                                     "false", "False", "yes"])
    def test_parse_like_the_jax_package(self, monkeypatch, raw):
        if raw is None:
            monkeypatch.delenv("TFT_UNIT_KNOB", raising=False)
        else:
            monkeypatch.setenv("TFT_UNIT_KNOB", raw)
        for fn, default in (("env_int", 7), ("env_float", 1.5),
                            ("env_bool", True)):
            assert (getattr(trz, fn)("TFT_UNIT_KNOB", default)
                    == getattr(jrz, fn)("TFT_UNIT_KNOB", default)), fn

    def test_one_parser(self):
        from tensorframes_tpu_torch.observability import events, flight
        from tensorframes_tpu_torch.utils import env
        assert trz.env_int is env.env_int is flight.env_int is \
            events.env_int
        assert trz.env_float is env.env_float
        assert trz.env_bool is env.env_bool


class TestClassify:
    """The port's classifier on the JAX package's cases, and on the card's
    own errors."""

    CASES = [MemoryError(), RuntimeError("RESOURCE_EXHAUSTED: hbm"),
             RuntimeError("UNAVAILABLE: socket"), ConnectionError("x"),
             ValueError("shape mismatch"), RuntimeError("DEVICE_LOST: 0"),
             RuntimeError("WORKER_LOST: w1"), TimeoutError("slow")]

    @pytest.mark.parametrize("i", range(len(CASES)))
    def test_same_verdicts(self, i):
        e = self.CASES[i]
        for fn in ("is_oom", "is_transient", "is_permanent",
                   "is_device_lost", "is_worker_lost", "error_kind"):
            assert getattr(trz, fn)(e) == getattr(jrz, fn)(e), fn

    def test_cuda_oom_by_type_and_cublas_text(self):
        assert trz.is_oom(torch.cuda.OutOfMemoryError("CUDA error"))
        e = RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when "
                         "calling `cublasCreate(handle)`")
        assert trz.is_oom(e) and not trz.is_transient(e)
        assert trz.error_kind(e) == "oom"

    def test_kernel_errors_are_permanent_whatever_their_text(self):
        e = trz.KernelError("nvcc failed to build x.cu (exit 1):\n"
                            "UNAVAILABLE ROOM out of memory")
        assert trz.is_permanent(e)
        assert not trz.is_transient(e) and not trz.is_oom(e)
        assert trz.error_kind(e) == "permanent"
        calls = []

        def build():
            calls.append(1)
            raise e
        with pytest.raises(trz.KernelError):
            trz.RetryPolicy(max_attempts=5).call(build, op="unit")
        assert calls == [1]


# ---------------------------------------------------------------------------
# engine: dispatch retry, OOM split
# ---------------------------------------------------------------------------

class TestEngineResilience:
    def test_map_blocks_succeeds_on_third_attempt(self, monkeypatch):
        """inject("compile", fail_n=2): a 3-block map succeeds on the 3rd
        attempt with exactly 2 retries (serial engine)."""
        monkeypatch.setenv("TFT_PIPELINE_DEPTH", "1")
        res = run_both(lambda m, rz: col(
            m.frame({"x": np.arange(12.0)}, num_partitions=3)
            .map_blocks(lambda x: {"y": x * 2.0})), "compile", 2)
        got = assert_same(res)
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.arange(12.0) * 2.0)
        assert counters.get("retry.executor.dispatch.retries") == 2
        assert counters.get("retry.executor.dispatch.giveups") == 0

    def test_dispatch_gives_up_after_max_attempts(self, monkeypatch):
        monkeypatch.setenv("TFT_RETRY_MAX_ATTEMPTS", "2")
        res = run_both(lambda m, rz: col(
            m.frame({"x": np.arange(4.0)}, num_partitions=1)
            .map_blocks(lambda x: {"y": x + 1.0})), "dispatch", 10)
        assert isinstance(assert_same(res), trz.InjectedFault)
        assert counters.get("retry.executor.dispatch.giveups") == 1

    def test_oom_triggers_split_block_redispatch(self):
        res = run_both(lambda m, rz: col(
            m.frame({"x": np.arange(16.0)}, num_partitions=1)
            .map_rows(lambda x: {"y": x * 3.0})), "oom", 1)
        got = assert_same(res)
        np.testing.assert_array_equal(got[0], np.arange(16.0) * 3.0)
        assert counters.get("oom_split.dispatches") == 1

    @pytest.mark.parametrize("fail_n,rows", [(2, 16), (3, 16), (3, 11)])
    def test_oom_split_recurses_until_it_fits(self, fail_n, rows):
        # consecutive OOMs: 16 -> 8 (OOM again) -> 4 + 4, and so on; an
        # odd block halves unevenly
        res = run_both(lambda m, rz: col(
            m.frame({"x": np.arange(float(rows))}, num_partitions=1)
            .map_rows(lambda x: {"y": x + 1.0})), "oom", fail_n)
        got = assert_same(res)
        np.testing.assert_array_equal(got[0], np.arange(float(rows)) + 1.0)
        assert counters.get("oom_split.dispatches") == fail_n

    def test_map_rows_splits_on_any_executor(self):
        """Row-locality is the op's say (``row_local=True`` from
        ``map_rows``), not the executor's: an explicit plain executor
        splits an OOM'd map_rows block too. (In the JAX package the
        executor's ``pad_rows`` decides.)"""
        out = ttf.frame({"x": np.arange(8.0)}, num_partitions=1).map_rows(
            lambda x: {"y": x + 2.0}, executor=BlockExecutor())
        with faults.inject("oom", fail_n=1):
            got = col(out)
        np.testing.assert_array_equal(got[0], np.arange(8.0) + 2.0)
        assert counters.get("oom_split.dispatches") == 1

    def test_oom_without_row_local_contract_propagates(self):
        # block-level computations may be cross-row: splitting would be
        # WRONG, so the OOM propagates (an explicit executor pins the
        # per-op path in both packages)
        res = run_both(lambda m, rz: col(
            m.frame({"x": np.arange(8.0)}, num_partitions=1).map_blocks(
                lambda x: {"y": x - x.mean()},
                executor=(JBlockExecutor() if m is jtf
                          else BlockExecutor()))), "oom", 1)
        assert isinstance(assert_same(res), trz.InjectedFault)
        assert counters.get("oom_split.dispatches") == 0

    @pytest.mark.parametrize("op", ["filter", "reduce_blocks", "aggregate",
                                    "reduce_rows"])
    def test_oom_propagates_through_ops_without_the_contract(self, op):
        def fn(m, rz):
            df = m.frame({"x": np.arange(8.0), "k": np.arange(8) % 3},
                         num_partitions=1)
            if op == "filter":
                return col(df.filter(lambda x: x > 2.0), "x")
            if op == "reduce_blocks":
                return m.reduce_blocks(
                    lambda x_input: {"x": x_input.sum(0)}, df.select(["x"]))
            if op == "reduce_rows":
                return m.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2},
                                     df.select(["x"]))
            return col(m.aggregate({"x": "sum"}, df.group_by("k")), "x")

        res = run_both(fn, "oom", 1)
        if op == "aggregate":
            # the mapping form of aggregate dispatches no program through
            # the executor in either package: nothing fires
            assert_same(res)
            assert counters.get("faults.oom.injected") == 0
        else:
            assert isinstance(assert_same(res), trz.InjectedFault)
        assert counters.get("oom_split.dispatches") == 0

    def test_oom_split_disabled_by_env(self, monkeypatch):
        monkeypatch.setenv("TFT_OOM_SPLIT", "0")
        res = run_both(lambda m, rz: col(
            m.frame({"x": np.arange(8.0)}, num_partitions=1)
            .map_rows(lambda x: {"y": x + 1.0})), "oom", 1)
        assert isinstance(assert_same(res), trz.InjectedFault)

    def test_single_row_block_cannot_split(self):
        res = run_both(lambda m, rz: col(
            m.frame({"x": np.arange(1.0)}, num_partitions=1)
            .map_rows(lambda x: {"y": x + 1.0})), "oom", 1)
        assert isinstance(assert_same(res), trz.InjectedFault)

    def test_split_keeps_device_outputs_with_keep_device(self):
        """A recovered keep_device dispatch still hands back tensors on the
        executor's device (joined with torch.cat), equal to an unsplit
        run."""
        from tensorframes_tpu_torch.engine import ops as tops
        df = ttf.frame({"x": np.arange(10.0)})
        comp = tops._vmapped(tops._map_computation(
            lambda x: {"y": x * 2.0 + 1.0}, df.schema, block_level=False))
        ex = BlockExecutor()
        want = ex.run(comp, {"x": np.arange(10.0)}, keep_device=True)
        with faults.inject("oom", fail_n=2):
            got = ex.run(comp, {"x": np.arange(10.0)}, row_local=True,
                         keep_device=True)
        assert isinstance(got["y"], torch.Tensor)
        assert torch.equal(got["y"], want["y"])
        assert counters.get("oom_split.dispatches") == 2

    def test_cuda_oom_returns_cached_segments_before_the_halves(
            self, monkeypatch):
        """A ``torch.cuda.OutOfMemoryError`` (raised here by the program
        for blocks over 4 rows) splits like any OOM, and each half first
        hands the allocator's cached segments back; an injected OOM-shaped
        fault does not."""
        from tensorframes_tpu_torch.engine import ops as tops
        emptied = []
        monkeypatch.setattr(torch.cuda, "empty_cache",
                            lambda: emptied.append(1))

        def prog(d):
            if d["x"].shape[0] > 4:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
            return {"y": d["x"] * 2.0}

        df = ttf.frame({"x": np.arange(16.0)})
        comp = tops._map_computation(lambda x: {"y": x + 1.0}, df.schema,
                                     block_level=True)
        comp = type(comp)(prog, comp.inputs, comp.outputs)
        out = BlockExecutor().run(comp, {"x": np.arange(16.0)},
                                  row_local=True)
        np.testing.assert_array_equal(out["y"], np.arange(16.0) * 2.0)
        assert counters.get("oom_split.dispatches") == 3  # 16 -> 8 -> 4
        assert len(emptied) == 6  # before each of the six halves
        with faults.inject("oom", fail_n=1):
            df.map_rows(lambda x: {"y": x + 1.0}).blocks()
        assert len(emptied) == 6

    def test_failed_attempt_is_released_before_the_halves_run(
            self, monkeypatch):
        """The failed attempt's intermediates and its device inputs are
        freed before the split runs its halves: weak references to the
        block-sized local and to the block's input tensor die first."""
        from tensorframes_tpu_torch.engine import executor as tex
        from tensorframes_tpu_torch.engine import ops as tops
        import weakref
        seen = {"big": None, "alive_at_half": []}
        inputs = []
        to_device = tex.to_device

        def tracked(a, *args, **kw):
            t = to_device(a, *args, **kw)
            inputs.append(weakref.ref(t))
            return t

        monkeypatch.setattr(tex, "to_device", tracked)

        def prog(d):
            x = d["x"]
            big = x.new_zeros(x.shape[0], 64)  # the block-sized local
            if x.shape[0] == 8:
                seen["big"] = weakref.ref(big)
                raise MemoryError("host allocation failed")
            ref = seen["big"]
            seen["alive_at_half"].append(ref is not None
                                         and ref() is not None)
            seen["alive_at_half"].append(inputs[0]() is not None)
            return {"y": x + big.sum(1)}

        df = ttf.frame({"x": np.arange(8.0)})
        comp = tops._map_computation(lambda x: {"y": x + 1.0}, df.schema,
                                     block_level=True)
        comp = type(comp)(prog, comp.inputs, comp.outputs)
        out = BlockExecutor().run(comp, {"x": np.arange(8.0)},
                                  row_local=True)
        np.testing.assert_array_equal(out["y"], np.arange(8.0))
        assert seen["alive_at_half"] == [False] * 4


# ---------------------------------------------------------------------------
# the plan: OOM fallback to the per-op path, and the row-local first stage
# ---------------------------------------------------------------------------

def _memory_error_once(monkeypatch):
    """Make the next dispatch of each package's executor raise a host
    ``MemoryError`` (a host allocation failing inside a fused stage)."""
    for cls in (JBlockExecutor, BlockExecutor):
        orig = cls._dispatch
        state = {"left": 1}

        def failing(self, *a, _orig=orig, _state=state, **k):
            if _state["left"]:
                _state["left"] -= 1
                raise MemoryError("host allocation failed")
            return _orig(self, *a, **k)
        monkeypatch.setattr(cls, "_dispatch", failing)


class TestPlanRecovery:
    def test_memory_error_in_a_fused_stage_falls_back_per_op(
            self, monkeypatch):
        """A fused map_blocks -> map_blocks stage (not row-local) whose
        dispatch raises a host MemoryError once: both packages hand the
        forcing back to the per-op path, with equal results and one
        ``plan.oom_fallbacks``. (The port used to catch only
        ``torch.cuda.OutOfMemoryError`` here and raised.)"""
        monkeypatch.setenv("TFT_PIPELINE_DEPTH", "1")
        _memory_error_once(monkeypatch)

        def fn(m, rz):
            df = m.frame({"x": np.arange(12.0)}, num_partitions=3)
            out = df.map_blocks(lambda x: {"y": x + 1.0}).map_blocks(
                lambda y: {"z": y * 2.0})
            return col(out, "z") + [np.asarray(out._plan_info is None)]

        got = assert_same(run_both(fn))
        assert counters.get("plan.oom_fallbacks") == 1
        assert counters.get("plan.fused_queries") == 0
        np.testing.assert_array_equal(np.concatenate(got[:3]),
                                      (np.arange(12.0) + 1.0) * 2.0)
        assert bool(got[3])

    def test_fallback_leaves_a_flight_record(self, monkeypatch):
        from tensorframes_tpu_torch.observability import flight
        flight.clear()
        monkeypatch.setenv("TFT_PIPELINE_DEPTH", "1")
        _memory_error_once(monkeypatch)
        df = ttf.frame({"x": np.arange(6.0)}, num_partitions=2)
        df.map_blocks(lambda x: {"y": x + 1.0}).map_blocks(
            lambda y: {"z": y * 2.0}).blocks()
        recs = flight.recent("plan.oom_fallback")
        assert [r["error"] for r in recs] == ["MemoryError"]

    def test_other_errors_in_a_fused_stage_propagate(self):
        def fn(m, rz):
            def bad(x):
                raise ValueError("deterministic")
            df = m.frame({"x": np.arange(6.0)}, num_partitions=2)
            return col(df.map_blocks(bad).map_blocks(
                lambda y: {"z": y * 2.0}), "z")
        assert isinstance(assert_same(run_both(fn)), ValueError)
        assert counters.get("plan.oom_fallbacks") == 0

    @pytest.mark.parametrize("depth", [1, 3])
    def test_fused_map_rows_stage_splits_in_place(self, monkeypatch, depth):
        """A fused map_rows -> map_rows -> select stage is row-local: an
        OOM splits the block inside the fused stage (no per-op fallback),
        as the JAX package's row-local first stage does."""
        monkeypatch.setenv("TFT_PIPELINE_DEPTH", str(depth))

        def fn(m, rz):
            df = m.frame({"x": np.arange(32.0), "k": np.arange(32)},
                         num_partitions=4)
            out = (df.map_rows(lambda x: {"y": x * 3.0})
                   .map_rows(lambda y: {"z": y + 1.0}).select(["k", "z"]))
            return col(out, "z") + [np.asarray(out._plan_info is not None)]

        got = assert_same(run_both(fn, "oom", 3))
        np.testing.assert_array_equal(np.concatenate(got[:4]),
                                      np.arange(32.0) * 3.0 + 1.0)
        assert bool(got[4]), "the chain did not stay fused"
        assert counters.get("plan.oom_fallbacks") == 0
        assert counters.get("plan.fused_queries") == 1
        if depth == 1:
            assert counters.get("oom_split.dispatches") == 3

    def test_fused_stage_after_a_filter_is_not_row_local(self):
        from tensorframes_tpu_torch.plan.optimize import build_plan
        df = ttf.frame({"x": np.arange(8.0)}, num_partitions=2)
        chain = df.map_rows(lambda x: {"y": x + 1.0}).filter(
            lambda y: y > 2.0).map_rows(lambda y: {"z": y * 2.0})
        stages = build_plan(chain).stages
        assert [s.row_local for s in stages] == [False, True]
        rows = ttf.frame({"x": np.arange(8.0)}, num_partitions=2) \
            .map_rows(lambda x: {"y": x + 1.0})
        assert [s.row_local for s in build_plan(
            rows.map_rows(lambda y: {"z": y * 2.0})).stages] == [True]

    def test_perf_drill_slows_the_forcing_and_changes_nothing(
            self, monkeypatch):
        monkeypatch.setenv("TFT_FAULT_PERF_S", "0.001")

        def fn(m, rz):
            df = m.frame({"x": np.arange(8.0)}, num_partitions=2)
            return col(df.map_rows(lambda x: {"y": x + 1.0})
                       .map_rows(lambda y: {"z": y * 2.0}), "z")

        assert_same(run_both(fn, "perf", 1))
        assert counters.get("faults.perf.injected") == 1


# ---------------------------------------------------------------------------
# the slice: random Fourier features through map_rows, then aggregate
# ---------------------------------------------------------------------------

def rff_consts(m, tables):
    """(W, b, beta) as package ``m``'s arrays, and its cosine."""
    if m is jtf:
        return tuple(jnp.asarray(tables[k]) for k in ("W", "b", "beta")), \
            jnp.cos
    return tuple(torch.from_numpy(tables[k]) for k in ("W", "b", "beta")), \
        torch.cos


class TestSlice:
    @pytest.mark.parametrize("depth", [1, 3])
    def test_rff_map_rows_then_aggregate_under_injected_ooms(
            self, monkeypatch, depth):
        """chip_smoke.py's OOM phase at 4 blocks x 2,000 rows, F = 64, in
        f64, under inject("oom", fail_n=3): both
        packages give the same keyed sums (to rtol 1e-12 at f64: the
        products' summation order is each library's), the port splits as
        often as the JAX package, and the port's result equals its own
        undisturbed run bit for bit."""
        monkeypatch.setenv("TFT_PIPELINE_DEPTH", str(depth))
        tables = rff_tables(np, 4 * 2000, feats=64, keys=50,
                            dtype="float64")

        def fn(m, rz):
            consts, cos = rff_consts(m, tables)
            z, agg = rff_query(m, cos, consts, tables, 4)
            cols = agg.blocks()[0].columns
            return [np.asarray(cols["key"]), np.asarray(cols["z"])] + \
                col(z, "z")

        res = run_both(fn, "oom", 3)
        (jv, jc), (tv, tc) = res["jax"], res["torch"]
        assert tc == jc, (tc, jc)
        np.testing.assert_array_equal(tv[0], jv[0])
        for a, b in zip(jv[1:], tv[1:]):
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)
        splits = 3 if depth == 1 else 0
        assert tc.get("oom_split.dispatches", 0) == splits
        assert tc.get("pipeline.sync_fallbacks", 0) == (3 if depth > 1
                                                        else 0)
        assert tc.get("plan.oom_fallbacks", 0) == 0
        counters.reset()
        consts, cos = rff_consts(ttf, tables)
        _, clean = rff_query(ttf, cos, consts, tables, 4)
        np.testing.assert_array_equal(clean.blocks()[0].columns["z"], tv[1])
        assert counters.get("oom_split.dispatches") == 0
