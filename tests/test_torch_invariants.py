"""The port's invariant auditors against the JAX package's: the cases of
``tests/test_chaos.py::TestInvariants`` that need no chaos schedule or
serving scheduler.

Each case runs the same steps in both packages (the JAX package on the
CPU with x64 and ``TFT_ADAPTIVE=0 TFT_RESULT_CACHE=0``, the port on the
CPU) and compares the findings, the ``invariants.*`` counters, the
flight records and the error types: always-on counting, strict mode's
classified ``InvariantViolation``, the ``TFT_INVARIANTS`` bypass, row
conservation (``conserve`` and the per-query row ledger, through a real
fused filter chain), the checkpoint's cursor checks and the slot pool's
lease balance.
"""

import numpy as np
import pytest

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu.engine import pipeline as jpipeline
from tensorframes_tpu.memory.checkpoint import \
    QueryCheckpoint as JQueryCheckpoint
from tensorframes_tpu.observability import flight as jflight
from tensorframes_tpu.resilience import error_kind as jerror_kind
from tensorframes_tpu.resilience import invariants as jinv
from tensorframes_tpu.utils import tracing as jtracing
from tensorframes_tpu_torch.engine import pipeline as tpipeline
from tensorframes_tpu_torch.memory.checkpoint import \
    QueryCheckpoint as TQueryCheckpoint
from tensorframes_tpu_torch.observability import flight as tflight
from tensorframes_tpu_torch.resilience import error_kind as terror_kind
from tensorframes_tpu_torch.resilience import invariants as tinv
from tensorframes_tpu_torch.utils import tracing as ttracing

pytestmark = pytest.mark.invariants

# package -> (root, invariants, flight, tracing, error_kind, checkpoint,
# pipeline)
PKGS = {"jax": (jtf, jinv, jflight, jtracing, jerror_kind, JQueryCheckpoint,
                jpipeline),
        "torch": (ttf, tinv, tflight, ttracing, terror_kind,
                  TQueryCheckpoint, tpipeline)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # the JAX package's predicates.py imports jax.core.Literal, which the
    # installed jax moved to jax.extend.core; without it that package
    # proves no filter atom-local and opens no row ledger
    import jax
    if not hasattr(jax.core, "Literal"):
        from jax.extend import core as jax_extend_core
        monkeypatch.setattr(jax.core, "Literal", jax_extend_core.Literal,
                            raising=False)
    for var in ("TFT_INVARIANTS", "TFT_INVARIANTS_STRICT", "TFT_CHAOS",
                "TFT_FAULTS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TFT_ADAPTIVE", "0")
    monkeypatch.setenv("TFT_RESULT_CACHE", "0")
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    for _, _inv, flight, tracing, *_ in PKGS.values():
        tracing.counters.reset()
        flight.clear()
    yield
    ttf.set_default_device(prev)


def each(fn):
    """``fn(*package)`` in each package with counters from zero: ``{pkg:
    (value, invariants.* counters)}``; asserts the counters agree and
    returns the port's value."""
    out = {}
    for name, pkg in PKGS.items():
        tracing = pkg[3]
        tracing.counters.reset()
        v = fn(*pkg)
        out[name] = (v, {k: n for k, n in tracing.counters.snapshot().items()
                         if k.startswith("invariants.")})
    (jv, jc), (tv, tc) = out["jax"], out["torch"]
    assert tc == jc, (tc, jc)
    assert tv == jv, (tv, jv)
    return tv, tc


class TestInvariants:
    def test_custom_auditor_always_on_counts(self):
        def fn(m, inv, flight, tracing, *_):
            inv.register("testaud", lambda point: ["book unbalanced"])
            try:
                found = inv.audit("test.point")
            finally:
                inv.unregister("testaud")
            rec = flight.recent(kind="invariant.violation")[-1]
            return found, rec["auditor"], rec["point"]

        v, c = each(fn)
        assert v == (["[testaud] book unbalanced"], "testaud", "test.point")
        assert c["invariants.violations"] == 1
        assert c["invariants.testaud.violations"] == 1

    def test_strict_mode_raises_classified(self):
        def fn(m, inv, flight, tracing, error_kind, *_):
            inv.register("testaud", lambda point: ["book unbalanced"])
            try:
                with inv.strict():
                    assert inv.strict_mode()
                    with pytest.raises(inv.InvariantViolation) as ei:
                        inv.audit("test.point")
            finally:
                inv.unregister("testaud")
            return (error_kind(ei.value), str(ei.value),
                    inv.strict_mode())

        v, _ = each(fn)
        assert v[0] == "invariant" and "testaud" in v[1] and not v[2]

    def test_auditor_crash_is_a_violation(self):
        def fn(m, inv, *_):
            def broken(point):
                raise RuntimeError("auditor bug")
            inv.register("broken", broken)
            try:
                return inv.audit("test.point")
            finally:
                inv.unregister("broken")

        found, c = each(fn)
        assert len(found) == 1 and "auditor crashed" in found[0]
        assert c["invariants.broken.violations"] == 1

    def test_disabled_bypass(self, monkeypatch):
        monkeypatch.setenv("TFT_INVARIANTS", "0")

        def fn(m, inv, *_):
            inv.register("testaud", lambda point: ["unbalanced"])
            try:
                found = inv.audit("test.point")
            finally:
                inv.unregister("testaud")
            # check() takes the cold path without counting when disabled
            return inv.enabled(), found, inv.check(False, "testaud", "nope")

        v, c = each(fn)
        assert v == (False, [], False)
        assert c.get("invariants.violations", 0) == 0

    def test_env_strict_knob(self, monkeypatch):
        monkeypatch.setenv("TFT_INVARIANTS_STRICT", "1")

        def fn(m, inv, *_):
            with pytest.raises(inv.InvariantViolation) as ei:
                inv.violate("testaud", "unbalanced")
            return inv.strict_mode(), str(ei.value)

        v, _ = each(fn)
        assert v == (True, "[testaud @ inline] unbalanced")

    def test_conserve_raises_in_every_mode(self):
        def fn(m, inv, flight, tracing, error_kind, *_):
            assert not inv.strict_mode()  # even always-on raises
            with pytest.raises(inv.InvariantViolation) as ei:
                inv.conserve(10, 8, "test.exchange")
            inv.conserve(10, 10, "test.exchange")  # balanced: quiet
            return error_kind(ei.value), str(ei.value)

        v, c = each(fn)
        assert v[0] == "invariant"
        assert c["invariants.rows.violations"] == 1

    def test_row_ledger_balanced(self):
        def fn(m, inv, *_):
            with inv.row_ledger(10, "test.query"):
                inv.note_filtered(4)
                inv.note_emitted(6)
            return True

        _, c = each(fn)
        assert c.get("invariants.violations", 0) == 0
        assert c["invariants.audits"] == 1

    def test_row_ledger_unbalanced_counts(self):
        def fn(m, inv, *_):
            with inv.row_ledger(10, "test.query"):
                inv.note_filtered(4)
                inv.note_emitted(5)  # 10 != 5 + 4
            return True

        _, c = each(fn)
        assert c["invariants.rows.violations"] == 1

    def test_row_ledger_unbalanced_strict_raises(self):
        def fn(m, inv, *_):
            with pytest.raises(inv.InvariantViolation) as ei:
                with inv.strict():
                    with inv.row_ledger(10, "test.query"):
                        inv.note_emitted(5)
                        inv.note_filtered(4)
            return str(ei.value)

        v, _ = each(fn)
        assert "10 rows admitted != 5 emitted + 4 filtered" in v

    def test_row_ledger_taint_skips_check(self):
        def fn(m, inv, *_):
            with inv.strict():
                with inv.row_ledger(10, "test.query"):
                    inv.note_emitted(5)
                    inv.taint_rows("resume restored a prior prefix")
            return True

        _, c = each(fn)
        assert c["invariants.rows.tainted"] == 1
        assert c.get("invariants.violations", 0) == 0

    def test_real_filter_query_balances(self):
        # the production row ledger: the plan opens it around a
        # row-local fused chain (an atom-proven filter after a map_rows),
        # the filter stage notes its masked-out rows, the close balances
        def fn(m, inv, *_):
            df = m.frame({"x": np.arange(30.0)}, num_partitions=3)
            with inv.strict():
                out = df.map_rows(lambda x: {"z": x * 2.0}).filter(
                    lambda z: z > 10.0)
                blocks = out.blocks()
            vals = np.concatenate(
                [np.asarray(b.columns["z"]) for b in blocks])
            return list(np.sort(vals))

        v, c = each(fn)
        assert v == list(np.arange(12.0, 60.0, 2.0))
        assert c.get("invariants.rows.violations", 0) == 0
        assert c["invariants.audits"] >= 1

    def test_checkpoint_park_cursor_check(self):
        def fn(m, inv, flight, tracing, error_kind, cp_cls, *_):
            cp = cp_cls("q-cursor")
            cp.park_stream([np.arange(3.0), np.arange(3.0)], total=1,
                           tag="stream-a")
            return cp.parked_blocks

        v, c = each(fn)
        assert v == 2
        assert c["invariants.checkpoint.violations"] == 1

    def test_checkpoint_resume_cursor_cold_paths(self):
        # an inconsistent cursor (more parked blocks than the stream has)
        # discards to a cold re-run, never resumes duplicate rows
        def fn(m, inv, flight, tracing, error_kind, cp_cls, *_):
            cp = cp_cls("q-cursor2")
            cp._parked = ([("junk",), ("junk",)], 1, "stream-a")
            before = tracing.counters.get("serve.checkpoint_discards")
            got = cp.resume_stream(total=1, tag="stream-a")
            return got, tracing.counters.get(
                "serve.checkpoint_discards") - before

        v, c = each(fn)
        assert v == (None, 1)
        assert c["invariants.checkpoint.violations"] == 1

    def test_slot_pool_lease_balance(self):
        # the slots auditor: a release without an acquire is negative, a
        # lease still held at a ".close" point leaked
        def fn(m, inv, flight, tracing, error_kind, cp_cls, pipeline):
            pool = pipeline.SlotPool(2)
            prev = pipeline.install_slot_pool(pool)
            try:
                clean = inv.audit("test.quiesce")
                assert pool.try_acquire()
                leaked = inv.audit("test.close")
                pool.release()
                pool.release()
                negative = inv.audit("test.quiesce")
            finally:
                pipeline.install_slot_pool(prev)
            return clean, leaked, negative

        (clean, leaked, negative), c = each(fn)
        assert clean == []
        assert len(leaked) == 1 and "leaked" in leaked[0]
        assert len(negative) == 1 and "negative" in negative[0]
        assert c["invariants.slots.violations"] == 2


class TestSlotPoolUnderThreads:
    def test_concurrent_streams_share_the_pool_and_return_every_lease(
            self, monkeypatch):
        """More pipelined streams than cores, each leasing a slot per
        in-flight block from one pool, with a short switch interval: the
        pool never lends more than its slots, every lease comes back,
        and every stream's results are its own, in order."""
        import os
        import sys
        import threading

        monkeypatch.setenv("TFT_PIPELINE_DEPTH", "3")
        pool = tpipeline.SlotPool(2)
        held, peak = [0], [0]
        lock = threading.Lock()

        def submit(b):
            with lock:
                held[0] += 1
                peak[0] = max(peak[0], pool.leased())
            return tpipeline.ReadyResult(b * 2)

        def drain(p, b):
            with lock:
                held[0] -= 1
            return p.drain()

        results, errors = {}, []

        def stream(i):
            try:
                blocks = list(range(i * 1000, i * 1000 + 200))
                results[i] = tpipeline.run_pipelined(
                    blocks, lambda b: b * 2, submit, drain, depth=3)
            except Exception as e:  # reported below
                errors.append(e)

        prev_pool = tpipeline.install_slot_pool(pool)
        prev_switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=stream, args=(i,))
                       for i in range((os.cpu_count() or 2) + 2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(prev_switch)
            tpipeline.install_slot_pool(prev_pool)
        assert not errors, errors
        assert pool.leased() == 0 and held[0] == 0
        assert 1 <= peak[0] <= pool.slots
        assert ttracing.counters.get("pipeline.slot_waits") > 0
        for i, out in results.items():
            assert out == [b * 2 for b in range(i * 1000, i * 1000 + 200)]
