"""The port's device-memory manager against the JAX package's
(``tests/test_memory.py``): the budget ledger, spill and fault-back bit
identity, LRU order, the executor's admission (proactive split, sync
dispatch under pressure, pending blocks as spill candidates), the
frame-cache gauge, the zero-cost unlimited path, and the persist tier
(``tests/test_fabric.py``'s persist cases and
``tests/test_chaos.py::TestPersistChecksums``).

Budgets are set the same way in both packages (``configure(limit_bytes=)``
or ``TFT_MEM_LIMIT_BYTES``), the same seeded inputs run through both (the
JAX package on the CPU with x64, the port on the CPU), and the values and
every ``memory.*`` / ``pipeline.*`` counter are compared. Row-local blocks
use power-of-two row counts of at least 8, where the JAX package's padded
estimate equals the port's (the port never pads); one case pins the
difference elsewhere.

The stream's window state spills instead of force-emitting under a
budget (``TestStreamStateSpill``: the JAX file's class of that name with
its ledger-driven spill, fault-back and audit), and the ``tft_memory_*``
metrics families render through the port's metrics layer.

Not mirrored here: the external sort and the larger-than-budget mesh
suite (with ``dsort``, ``ROADMAP.md`` A10), the serve scheduler's
estimates and headroom (A11) and the external-sort explain line (A10).
"""

import gc
import os
import pickle
import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from chip_smoke import ledger_spills
from conftest import timing_margin
from tensorframes_tpu import memory as jmem
from tensorframes_tpu.engine.executor import BlockExecutor as JBlockExecutor
from tensorframes_tpu.memory import checkpoint as jcheckpoint
from tensorframes_tpu.memory import persist as jpersist
from tensorframes_tpu.observability import flight as jflight
from tensorframes_tpu.observability import metrics as jmetrics
from tensorframes_tpu.resilience import invariants as jinvariants
from tensorframes_tpu.resilience import faults as jfaults
from tensorframes_tpu.utils import tracing as jtracing
from tensorframes_tpu.utils.tracing import counters as jcounters
from tensorframes_tpu_torch import memory as tmem
from tensorframes_tpu_torch.engine.executor import (BlockExecutor,
                                                    PendingBlock)
from tensorframes_tpu_torch.engine.pipeline import ReadyResult
from tensorframes_tpu_torch.memory import checkpoint as tcheckpoint
from tensorframes_tpu_torch.memory import persist as tpersist
from tensorframes_tpu_torch.observability import flight as tflight
from tensorframes_tpu_torch.observability import metrics as tmetrics
from tensorframes_tpu_torch.resilience import invariants as tinvariants
from tensorframes_tpu_torch.resilience import faults as tfaults
from tensorframes_tpu_torch.utils import tracing as ttracing
from tensorframes_tpu_torch.utils.tracing import counters as tcounters

# package -> (root, memory, counters)
PKGS = {"jax": (jtf, jmem, jcounters), "torch": (ttf, tmem, tcounters)}

# the counters the two packages are held to
LEDGER = ("memory.", "pipeline.", "oom_split.", "relational.build_chunks",
          "persist.", "serve.checkpoint")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """The port on the CPU, the static plan in both packages, clean
    counters, and the env-resolved memory singletons restored after."""
    monkeypatch.setenv("TFT_ADAPTIVE", "0")
    monkeypatch.setenv("TFT_RESULT_CACHE", "0")
    monkeypatch.delenv("TFT_PIPELINE_DEPTH", raising=False)
    monkeypatch.delenv("TFT_MEM_LIMIT_BYTES", raising=False)
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    for _, mem, c in PKGS.values():
        c.reset()
        mem._reset()
    yield
    for _, mem, _c in PKGS.values():
        mem._reset()
    ttf.set_default_device(prev)


def _ledger(c) -> dict:
    return {k: v for k, v in c.snapshot().items() if k.startswith(LEDGER)}


def both(fn, limit=None, spill=None):
    """``fn(package, memory)`` in each package under the same budget
    (``limit`` bytes; ``None`` leaves the env-resolved manager). Returns
    ``{pkg: (value, ledger counters)}``, counters from zero."""
    out = {}
    for name, (m, mem, c) in PKGS.items():
        c.reset()
        if limit is not None:
            mem.configure(limit_bytes=limit, spill=spill)
        out[name] = (fn(m, mem), _ledger(c))
    return out


def same(res):
    """Equal ledger counters and equal values (arrays bit for bit).
    Returns the port's value."""
    (jv, jc), (tv, tc) = res["jax"], res["torch"]
    assert tc == jc, (tc, jc)
    _equal(jv, tv)
    return tv


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (np.ndarray, jax.Array, torch.Tensor)):
        x, y = _np(a), _np(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (x.dtype, y.dtype)
        np.testing.assert_array_equal(y, x)
    else:
        assert a == b, (a, b)


def _np(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _col(frame, name="z"):
    return np.concatenate([np.asarray(b.columns[name])
                           for b in frame.blocks()])


def _dev(m, host):
    """``host`` as the package's device value (a jax array; a CPU
    tensor)."""
    if m is jtf:
        return jax.device_put(host)
    if host.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(host.copy())


# ---------------------------------------------------------------------------
# ledger basics
# ---------------------------------------------------------------------------

class TestLedger:
    def test_unlimited_is_inactive(self):
        def fn(m, mem):
            mgr = mem.configure(limit_bytes=0)
            return (mgr.limited, mem.active() is None, mgr.reserve(10 ** 12),
                    mgr.try_reserve(10 ** 12), mgr.headroom(),
                    mgr.would_overflow(10 ** 12))
        assert same(both(fn)) == (False, True, 0, 0, None, False)

    def test_env_budget_resolution(self, monkeypatch):
        monkeypatch.setenv("TFT_MEM_LIMIT_BYTES", "12345")

        def fn(m, mem):
            mem._reset()
            mgr = mem.manager()
            return mgr.limit, mem.active() is mgr
        assert same(both(fn)) == (12345, True)

    def test_reserve_release_accounting(self):
        def fn(m, mem):
            mgr = mem.active()
            t1 = mgr.reserve(400, op="t")
            t2 = mgr.reserve(400, op="t")
            seen = [mgr.snapshot()["inflight_bytes"], mgr.try_reserve(400)]
            mgr.release(t1)
            t3 = mgr.try_reserve(400)
            mgr.release(t2)
            mgr.release(t3)
            return seen + [t3, mgr.snapshot()["inflight_bytes"]]
        assert same(both(fn, limit=1000)) == [800, None, 400, 0]

    def test_would_overflow_is_whole_budget(self):
        def fn(m, mem):
            mgr = mem.active()
            return mgr.would_overflow(1001), mgr.would_overflow(1000)
        assert same(both(fn, limit=1000)) == (True, False)

    def test_soft_admission_counts_overflow(self, monkeypatch):
        monkeypatch.setenv("TFT_MEM_ADMIT_WAIT_S", "0.05")

        def fn(m, mem):
            mgr = mem.active()
            hold = mgr.reserve(900)
            tok = mgr.reserve(900, op="t")  # waits, then admits over
            mgr.release(hold)
            mgr.release(tok)
            return tok
        res = both(fn, limit=1000)
        assert same(res) == 900
        assert res["torch"][1]["memory.overflow_admissions"] == 1
        assert res["torch"][1]["memory.admission_waits"] == 1

    @pytest.mark.timing
    def test_impossible_request_overflows_without_stalling(self,
                                                           monkeypatch):
        monkeypatch.setenv("TFT_MEM_ADMIT_WAIT_S", "5.0")

        def fn(m, mem):
            t0 = time.monotonic()
            tok = mem.active().reserve(2000, op="t")
            took = time.monotonic() - t0
            mem.active().release(tok)
            return tok, took < timing_margin(1.0)
        res = both(fn, limit=1000)
        assert same(res) == (2000, True)
        assert res["torch"][1]["memory.overflow_admissions"] == 1

    @pytest.mark.timing
    def test_admission_wait_is_bounded(self, monkeypatch):
        monkeypatch.setenv("TFT_MEM_ADMIT_WAIT_S", "0.2")
        mgr = tmem.configure(limit_bytes=1000)
        hold = mgr.reserve(1000)
        t0 = time.monotonic()
        tok = mgr.reserve(500, op="t")
        took = time.monotonic() - t0
        assert 0.15 <= took < timing_margin(3.0)
        mgr.release(hold)
        mgr.release(tok)

    def test_admission_unblocks_on_release(self, monkeypatch):
        monkeypatch.setenv("TFT_MEM_ADMIT_WAIT_S", "5.0")
        mgr = tmem.configure(limit_bytes=1000)
        hold = mgr.reserve(900)
        got = []
        t = threading.Thread(target=lambda: got.append(
            mgr.reserve(500, op="t")))
        t.start()
        mgr.release(hold)
        t.join(timeout=timing_margin(10.0))
        assert not t.is_alive()
        assert got == [500]
        assert tcounters.get("memory.overflow_admissions") == 0
        mgr.release(500)

    def test_deadline_ends_the_admission_wait(self, monkeypatch):
        from tensorframes_tpu_torch.resilience import (DeadlineExceeded,
                                                       deadline)
        monkeypatch.setenv("TFT_MEM_ADMIT_WAIT_S", "5.0")
        mgr = tmem.configure(limit_bytes=1000)
        hold = mgr.reserve(1000)
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded):
            with deadline(0.05):
                mgr.reserve(500, op="t")
        assert time.monotonic() - t0 < timing_margin(3.0)
        mgr.release(hold)
        assert mgr.snapshot()["inflight_bytes"] == 0

    def test_card_budget_is_its_limit_times_the_fraction(self, monkeypatch):
        """No ``TFT_MEM_LIMIT_BYTES``: the budget is the default device's
        allocator limit x ``TFT_MEM_FRACTION`` in both packages."""
        from tensorframes_tpu.observability import device as jdev
        from tensorframes_tpu_torch.observability import device as tdev
        seen = []

        def card(device=None):
            seen.append(device)
            return {"live_bytes": 0, "peak_bytes": 0,
                    "limit_bytes": 8589934592, "devices": 1}
        monkeypatch.setattr(jdev, "watermark", card)
        monkeypatch.setattr(tdev, "watermark", card)
        res = both(lambda m, mem: mem.manager().limit)
        assert same(res) == 7301444403
        assert seen[-1] == ttf.default_device()
        monkeypatch.setenv("TFT_MEM_FRACTION", "0.5")
        res = both(lambda m, mem: (mem._reset(), mem.manager().limit)[1])
        assert same(res) == 4294967296

    def test_an_untouched_card_is_not_latched_unlimited(self, monkeypatch):
        """A card the process has not touched reports no limit yet: the
        port resolves again at the next use instead of staying
        unlimited for the life of the process."""
        from tensorframes_tpu_torch.observability import device as tdev
        card = {"limit_bytes": None}
        monkeypatch.setattr(
            tdev, "watermark",
            lambda device=None: None if card["limit_bytes"] is None else {
                "live_bytes": 0, "peak_bytes": 0, "devices": 1,
                "limit_bytes": card["limit_bytes"]})
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        ttf.set_default_device("cuda")
        assert tmem.active() is None
        card["limit_bytes"] = 1000
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        assert tmem.active() is not None and tmem.active().limit == 850
        card["limit_bytes"] = None  # latched now: resolved once
        assert tmem.active().limit == 850
        ttf.set_default_device("cpu")
        tmem._reset()
        assert tmem.active() is None  # the CPU: latched unlimited

    def test_audit_flags_a_double_release_and_a_torn_entry(self):
        def fn(m, mem):
            mgr = mem.active()
            ok = mgr.audit()
            mgr.release(100)  # never reserved
            neg = mgr.audit()
            mgr._inflight = 0
            torn = _Torn()  # marked spilled, still holding device bytes
            mgr.register(torn)
            return ok, len(neg), "negative" in neg[0], mgr.audit()
        assert same(both(fn, limit=10 ** 6)) == (
            [], 1, True, ["spillable 'torn' is marked spilled but still "
                          "counts 8 device bytes"])


class _Torn:
    """A ledger entry whose spilled flag disagrees with its bytes."""

    def mem_name(self):
        return "torn"

    def mem_is_spilled(self):
        return True

    def mem_device_bytes(self):
        return 8

    def mem_host_bytes(self):
        return 0

    def mem_spill(self):
        return 0

    def mem_fault(self):
        return 0


# ---------------------------------------------------------------------------
# spill / fault bit identity
# ---------------------------------------------------------------------------

SPILL_DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint32,
                np.bool_, ml_dtypes.bfloat16]


class TestSpillFault:
    @pytest.mark.parametrize("dtype", SPILL_DTYPES,
                             ids=[np.dtype(d).name for d in SPILL_DTYPES])
    def test_round_trip_bit_identity(self, dtype):
        raw = np.random.default_rng(0).standard_normal(257) * 100
        # bf16 rounds once, from f32, in both packages
        host = raw.astype(np.float32).astype(dtype)

        def fn(m, mem):
            buf = mem.SpillableBuffer("t", {"x": _dev(m, host)})
            nbytes = buf.mem_device_bytes()
            freed = buf.spill()
            state = (nbytes, freed, buf.spilled, buf.mem_device_bytes(),
                     buf.mem_host_bytes())
            back = buf.get("x")  # faults the buffer back
            return state + (buf.spilled, back)
        res = both(fn)
        got = same(res)
        assert got[:6] == (host.nbytes, host.nbytes, True, 0, host.nbytes,
                           False)
        # BIT identity with the value that went in, not value closeness
        np.testing.assert_array_equal(_np(got[6]), _np(host))

    def test_string_ride_along_untouched(self):
        s = np.array(["a", "bb", None], object)

        def fn(m, mem):
            buf = mem.SpillableBuffer("t", {"x": _dev(m, np.arange(3.0)),
                                            "s": s})
            buf.spill()
            spilled = buf.mem_device_bytes()
            got = buf.arrays()
            return spilled, got["s"] is s, got["x"]
        got = same(both(fn))
        assert got[:2] == (0, True)
        np.testing.assert_array_equal(_np(got[2]), np.arange(3.0))

    def test_double_spill_and_fault_are_idempotent(self):
        def fn(m, mem):
            buf = mem.SpillableBuffer("t", {"x": _dev(m, np.arange(8.0))})
            return buf.spill(), buf.spill(), buf.fault(), buf.fault()
        assert same(both(fn)) == (64, 0, 64, 0)

    def test_spillable_columns_transparent_access(self):
        def fn(m, mem):
            sc = mem.spillable_columns(
                "t", {"x": _dev(m, np.arange(16.0)),
                      "s": np.array(list("abcdefghijklmnop"), object)},
                mem.active())
            kind = type(sc).__name__
            sc.mem_spill()
            spilled = sc.mem_is_spilled()
            x = sc["x"]  # any access faults the mapping back
            return kind, spilled, sc.mem_is_spilled(), x
        res = both(fn, limit=10 ** 9)
        assert same(res)[:3] == ("SpillableColumns", True, False)
        assert res["torch"][1]["memory.faults"] == 1

    def test_spillable_columns_host_value_does_not_fault(self):
        def fn(m, mem):
            sc = mem.spillable_columns(
                "t", {"x": _dev(m, np.arange(16.0))}, mem.active())
            sc.mem_spill()
            return (np.asarray(mem.host_value(sc, "x")),
                    mem.value_nbytes(sc, "x"), sc.leading_rows(),
                    sc.mem_is_spilled())
        got = same(both(fn, limit=10 ** 9))
        np.testing.assert_array_equal(got[0], np.arange(16.0))
        assert got[1:] == (128, 16, True)

    def test_bfloat16_host_value_decodes_the_bits(self):
        vals = np.arange(-4.0, 4.0, 0.5, dtype=np.float32)
        sc = tmem.spillable_columns(
            "t", {"x": torch.from_numpy(vals).to(torch.bfloat16)},
            tmem.configure(limit_bytes=10 ** 9))
        sc.mem_spill()
        got = tmem.host_value(sc, "x")
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, vals)
        assert sc._host["x"][0].dtype == np.uint16  # the bits, kept

    def test_inactive_manager_returns_plain_dict(self):
        def fn(m, mem):
            mem.configure(limit_bytes=0)
            return type(mem.spillable_columns(
                "t", {"x": _dev(m, np.arange(4.0))})).__name__
        assert same(both(fn)) == "dict"


# ---------------------------------------------------------------------------
# LRU ordering under pressure
# ---------------------------------------------------------------------------

def _bufs(m, mem, names, n=100):
    return [mem.SpillableBuffer(
        nm, {"x": _dev(m, np.arange(n, dtype=np.float64))})
        for nm in names]


class TestLRU:
    def test_cold_entry_spills_first(self):
        def fn(m, mem):
            mgr = mem.active()  # three 800 B buffers fit
            a, b, c = _bufs(m, mem, "abc")
            for buf in (a, b, c):
                mgr.register(buf)
            mgr.touch(a)  # a is now hottest; b is the coldest
            tok = mgr.reserve(2000, op="t")  # needs two spills
            mgr.release(tok)
            return a.spilled, b.spilled, c.spilled
        res = both(fn, limit=3000)
        assert same(res) == (False, True, True)
        assert res["torch"][1]["memory.spills"] == 2

    def test_registration_over_budget_spills_immediately(self):
        def fn(m, mem):
            a, b = _bufs(m, mem, "ab")
            mem.active().register(a)
            mem.active().register(b)  # 1600 B > 1000: the LRU one spills
            return a.spilled, b.spilled
        res = both(fn, limit=1000)
        assert same(res) == (True, False)
        assert res["torch"][1]["memory.spills"] == 1

    def test_fault_back_spills_others(self):
        def fn(m, mem):
            a, b = _bufs(m, mem, "ab")
            mem.active().register(a)
            mem.active().register(b)
            mem.active().touch(a)  # faulting a back must push b out
            return a.spilled, b.spilled
        res = both(fn, limit=1000)
        assert same(res) == (False, True)
        assert res["torch"][1]["memory.faults"] == 1

    def test_dead_entries_are_pruned(self):
        def fn(m, mem):
            buf = _bufs(m, mem, "a")[0]
            mem.active().register(buf)
            n = mem.active().snapshot()["resident_buffers"]
            del buf
            gc.collect()
            return n, mem.active().snapshot()["resident_buffers"]
        assert same(both(fn, limit=10 ** 6)) == (1, 0)

    def test_drop_releases_entry(self):
        def fn(m, mem):
            buf = _bufs(m, mem, "a")[0]
            mem.active().register(buf)
            mem.active().drop(buf)
            return mem.active().snapshot()["resident_buffers"]
        assert same(both(fn, limit=10 ** 6)) == 0

    def test_snapshot_and_headroom(self):
        def fn(m, mem):
            mgr = mem.active()
            a, b = _bufs(m, mem, "ab")
            mgr.register(a)
            mgr.register(b)
            tok = mgr.reserve(300)
            snap, room = mgr.snapshot(), mgr.headroom()
            mgr.release(tok)
            return snap, room, mgr.headroom(0.5)
        assert same(both(fn, limit=2000)) == (
            {"limit_bytes": 2000, "inflight_bytes": 300,
             "resident_bytes": 1600, "resident_buffers": 2,
             "spilled_bytes": 0, "spilled_buffers": 0}, 1700, 1000)


# ---------------------------------------------------------------------------
# executor integration: proactive splits, sync dispatch, window spill
# ---------------------------------------------------------------------------

class TestExecutorAdmission:
    def test_proactive_split_before_dispatch(self):
        def fn(m, mem):
            df = m.frame({"x": np.arange(4096, dtype=np.float64)})
            return _col(df.map_rows(lambda x: {"z": x + 1.0}))
        res = both(fn, limit=4096)
        np.testing.assert_array_equal(same(res), np.arange(4096.0) + 1.0)
        # 4096 rows at 16 B a row halve down to 256-row leaves: 15 splits,
        # BEFORE the allocator, not after
        assert res["torch"][1]["memory.proactive_splits"] == 15
        assert "oom_split.dispatches" not in res["torch"][1]

    def test_proactive_split_per_op_path(self, monkeypatch):
        monkeypatch.setenv("TFT_FUSE", "0")
        self.test_proactive_split_before_dispatch()

    def test_pipeline_pressure_falls_back_to_sync(self, monkeypatch):
        # a window of 64 KiB blocks against a 100 KiB budget: the async
        # submit cannot hold depth x est in flight and runs blocks
        # synchronously (admitted) instead of blocking
        monkeypatch.setenv("TFT_PIPELINE_DEPTH", "4")

        def fn(m, mem):
            df = m.frame({"x": np.arange(32768, dtype=np.float64)},
                         num_partitions=4)
            return _col(df.map_blocks(lambda x: {"z": x * 2.0}))
        res = both(fn, limit=100 * 1024)
        np.testing.assert_array_equal(same(res), np.arange(32768.0) * 2.0)
        assert res["torch"][1]["memory.sync_dispatches"] == 4

    @pytest.mark.parametrize("parts,depth", [(8, 8), (8, 3), (6, 4)])
    def test_window_pressure_spills_the_oldest_pending_block(
            self, monkeypatch, parts, depth):
        """The chip phase's part (b) at a small size: a window of pending
        blocks over the budget spills the least recently used one at each
        submit that does not fit, as ``chip_smoke.ledger_spills``
        predicts."""
        monkeypatch.setenv("TFT_PIPELINE_DEPTH", str(depth))
        rows, feats = 4096, 4
        est = 2 * rows * feats * 4
        limit = int(est * 5.7)
        x = np.random.default_rng(1).standard_normal(
            (parts * rows, feats)).astype(np.float32)

        def fn(m, mem):
            df = m.frame({"x": x}, num_partitions=parts)
            return _col(df.map_rows(lambda x: {"z": x * 2.0}))
        res = both(fn, limit=limit)
        np.testing.assert_array_equal(same(res), x * 2.0)
        want = ledger_spills(est, parts, depth, limit)
        got = res["torch"][1]
        assert got.get("memory.spills", 0) == want["memory.spills"]
        assert got.get("memory.sync_dispatches", 0) == \
            want["memory.sync_dispatches"]
        if (parts, depth) == (8, 8):
            assert want == {"memory.spills": 3,
                            "memory.sync_dispatches": 0}

    def test_unlimited_run_reserves_nothing(self):
        def fn(m, mem):
            df = m.frame({"x": np.arange(10000.0)}, num_partitions=4)
            return _col(df.map_blocks(lambda x: {"z": x + 1.0}))
        res = both(fn, limit=0)
        same(res)
        assert not any(k.startswith("memory.") for k in res["torch"][1])

    def test_pending_block_is_spill_candidate(self):
        mgr = tmem.configure(limit_bytes=10 ** 6)
        comp = ttf.Computation.trace(
            lambda x: {"z": x + 1.0},
            [ttf.TensorSpec("x", ttf.dtypes.double, ttf.Shape(-1))])
        pending = BlockExecutor().submit(
            comp, {"x": np.arange(64, dtype=np.float64)})
        assert isinstance(pending, PendingBlock)
        assert mgr.snapshot()["resident_buffers"] == 1
        assert mgr.snapshot()["resident_bytes"] == 2 * 64 * 8
        # a ledger spill takes the drain result early and lets the
        # device buffers go
        assert mgr.make_room(10 ** 6)
        assert pending.mem_is_spilled() and pending._held is None
        assert mgr.snapshot()["resident_bytes"] == 0
        with tfaults.inject("drain", fail_n=1):  # a spilled drain passes
            out = pending.drain()                # no drain fault site
        np.testing.assert_array_equal(out["z"], np.arange(64.0) + 1.0)
        assert mgr.snapshot()["resident_buffers"] == 0
        assert tcounters.get("faults.drain.injected") == 0
        # the JAX package: the same ledger traffic
        jmgr = jmem.configure(limit_bytes=10 ** 6)
        jcomp = jtf.Computation.trace(
            lambda x: {"z": x + 1.0},
            [jtf.TensorSpec("x", jtf.dtypes.double, jtf.Shape(-1))])
        jp = JBlockExecutor().submit(
            jcomp, {"x": np.arange(64, dtype=np.float64)}, pad_ok=False)
        assert jmgr.snapshot()["resident_bytes"] == 2 * 64 * 8
        assert jmgr.make_room(10 ** 6) and jp.mem_is_spilled()
        np.testing.assert_array_equal(jp.drain()["z"], out["z"])
        assert _ledger(tcounters) == _ledger(jcounters)

    def test_collected_pending_block_and_build_leave_the_ledger(self):
        """The ledger holds its entries weakly: a pending block dropped
        without a drain, and a join's build table whose frames are gone,
        leave it with no unregister call."""
        mgr = tmem.configure(limit_bytes=10 ** 6)
        comp = ttf.Computation.trace(
            lambda x: {"z": x + 1.0},
            [ttf.TensorSpec("x", ttf.dtypes.double, ttf.Shape(-1))])
        pending = BlockExecutor().submit(
            comp, {"x": np.arange(64, dtype=np.float64)})
        right = ttf.frame({"k": np.arange(4, dtype=np.int64),
                           "w": np.arange(4.0)})
        joined = ttf.frame({"k": np.arange(8, dtype=np.int64)}).join(
            right, on="k")
        snap = mgr.snapshot()
        assert (snap["resident_buffers"], snap["resident_bytes"]) == \
            (2, 2 * 64 * 8 + 4 * 8)
        del pending, joined, right
        gc.collect()
        assert mgr.snapshot()["resident_buffers"] == 0
        assert mgr.snapshot()["resident_bytes"] == 0

    def test_keep_device_pending_block_spilled_early(self):
        """A ``keep_device`` pending block (a fused stage edge) spilled
        before its drain copies its outputs to the host in their storage
        dtypes and lets its device tensors go; the drain hands back the
        host arrays."""
        mgr = tmem.configure(limit_bytes=10 ** 6)
        comp = ttf.Computation.trace(
            lambda x: {"z": x * 2.0},
            [ttf.TensorSpec("x", ttf.dtypes.float32, ttf.Shape(-1))])
        x = np.arange(32, dtype=np.float32)
        pending = BlockExecutor().submit(comp, {"x": x}, keep_device=True)
        assert isinstance(pending._device_out["z"], torch.Tensor)
        assert mgr.snapshot()["resident_bytes"] == 2 * 32 * 4
        assert mgr.make_room(10 ** 6)
        assert pending._device_out is None and pending._held is None
        out = pending.drain()
        assert isinstance(out["z"], np.ndarray)
        assert out["z"].dtype == np.float32
        np.testing.assert_array_equal(out["z"], x * 2.0)
        assert tcounters.get("memory.spills") == 1
        assert tcounters.get("memory.spill_bytes") == 2 * 32 * 4

    def test_fused_chain_with_spilled_edges_is_bit_identical(
            self, monkeypatch):
        """A two-stage fused chain (its first stage's edge device-resident)
        under window pressure: spilled edges come back as host arrays and
        the later stage takes them; values equal the unbudgeted run's."""
        monkeypatch.setenv("TFT_PIPELINE_DEPTH", "8")
        x = np.random.default_rng(2).standard_normal(8 * 512)

        def fn(m, mem):
            df = m.frame({"x": x}, num_partitions=8)
            return _col(df.map_blocks(lambda x: {"y": x * 3.0})
                        .filter(lambda y: y > -1.0)
                        .map_blocks(lambda y: {"z": y + 1.0}), "z")
        want = same(both(fn, limit=0))
        res = both(fn, limit=int(2 * 512 * 8 * 5.5))
        assert res["torch"][1].get("memory.spills", 0) > 0
        np.testing.assert_array_equal(same(res), want)

    def test_padding_makes_the_estimates_differ(self):
        """Documented difference: the JAX package pads a row-local block to
        a power of two (at least 8 rows) and scales its estimate by it; the
        port never pads. 600 rows of f64 estimate 9,600 B in the port and
        16,384 B (1,024 padded rows) in the JAX package: over a 10,000 B
        budget only the JAX package splits."""
        from tensorframes_tpu.engine.executor import (
            _dispatch_estimate as jest)
        from tensorframes_tpu_torch.engine.executor import (
            _dispatch_estimate as test_)
        x = np.arange(600, dtype=np.float64)
        comp = ttf.Computation.trace(
            lambda x: {"z": x + 1.0},
            [ttf.TensorSpec("x", ttf.dtypes.double, ttf.Shape(-1))])
        assert test_(comp, {"x": x}) == 9600
        assert jest({"x": x}, 1024, 600) == 16384

        def fn(m, mem):
            return _col(m.frame({"x": x}).map_rows(lambda x: {"z": x + 1.0}))
        res = both(fn, limit=10_000)
        _equal(res["jax"][0], res["torch"][0])
        assert res["jax"][1]["memory.proactive_splits"] == 1
        assert "memory.proactive_splits" not in res["torch"][1]

    def test_sketch_fold_reserves_and_releases(self):
        from tensorframes_tpu_torch.relational import approx_distinct
        rng = np.random.default_rng(3)
        df = ttf.frame({"k": rng.integers(0, 4, 5000),
                        "v": rng.integers(0, 1000, 5000)}, num_partitions=2)
        mgr = tmem.configure(limit_bytes=10 ** 9)
        seen = []
        real = mgr.reserve

        def spy(nbytes, op="dispatch"):
            seen.append((nbytes, op))
            return real(nbytes, op)
        mgr.reserve = spy
        out = ttf.aggregate({"v": approx_distinct()}, df.group_by("k"))
        assert out.blocks()[0].num_rows == 4
        folds = [s for s in seen if s[1] == "aggregate.sketch_fold"]
        # 2x the int64 values and the int32 group ids of each block
        assert [n for n, _ in folds] == [2 * 2500 * 8 + 2500 * 4] * 2
        assert mgr.snapshot()["inflight_bytes"] == 0


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

class TestObservability:
    def test_frame_cache_gauge_and_uncache(self):
        def fn(m, mem):
            df = m.frame({"x": np.arange(1000.0)})
            df.blocks()
            cached = mem.active().frame_cache_bytes()
            df.uncache()
            return cached, mem.active().frame_cache_bytes(), df._cache
        assert same(both(fn, limit=10 ** 9)) == (8000, 0, None)

    def test_proactive_split_event_in_trace(self):
        for m, mem, tracing in ((jtf, jmem, jtracing), (ttf, tmem, ttracing)):
            mem.configure(limit_bytes=4096)
            out = m.frame({"x": np.arange(4096, dtype=np.float64)}).map_rows(
                lambda x: {"z": x + 1.0})
            tracing.enable()
            try:
                out.blocks()
                trace = out._trace
            finally:
                tracing.disable()
            assert trace is not None
            assert trace.summary()["proactive_splits"] == 15
            ev = [e for e in trace.events if e.etype == "proactive_split"][0]
            assert ev.args == {"rows": 4096, "est_bytes": 65536}

    def test_spill_fault_and_pressure_events(self, monkeypatch):
        monkeypatch.setenv("TFT_PIPELINE_DEPTH", "4")
        mgr = tmem.configure(limit_bytes=100 * 1024)
        df = ttf.frame({"x": np.arange(32768, dtype=np.float64)},
                       num_partitions=4)
        a, b = _bufs(ttf, tmem, "ab")
        mgr.register(a)
        ttracing.enable()
        try:
            _col(df.map_blocks(lambda x: {"z": x * 2.0}))
            trace = ttf.observability.last_query()
            mgr.touch(a)
        finally:
            ttracing.disable()
        s = trace.summary()
        assert s["spills"] == 1 and s["spill_bytes"] == 800
        assert trace.count("mem_sync_dispatch") == 4
        ev = [e for e in trace.events if e.etype == "spill"][0]
        assert (ev.name, ev.args) == ("a", {"bytes": 800})
        recs = [r for r in tflight.recent() if r["kind"] == "memory.fault"]
        assert recs[-1]["name"] == "a" and recs[-1]["bytes"] == 800


    def test_metrics_families_present(self):
        def fn(m, mem):
            m.frame({"x": np.arange(2048.0)}).map_rows(
                lambda x: {"z": x + 1.0}).blocks()
            text = (jmetrics if m is jtf else tmetrics).metrics_text()
            return [family in text for family in (
                "tft_memory_budget_bytes", "tft_memory_inflight_bytes",
                "tft_memory_spilled_bytes", "tft_memory_spills_total",
                "tft_memory_proactive_splits_total")]
        assert same(both(fn, limit=4096)) == [True] * 5


# ---------------------------------------------------------------------------
# stream state: spill instead of force-evict
# ---------------------------------------------------------------------------

def _stream_modules(m):
    if m is jtf:
        from tensorframes_tpu import stream
    else:
        from tensorframes_tpu_torch import stream
    return stream


def _stream_rows(h):
    return sorted(tuple(map(float, r))
                  for f in h.collect_updates() for r in f.collect())


class TestStreamStateSpill:
    """Each case runs one stream per package under the same budget and
    compares the emitted rows, the aggregation's spill/fault/eviction
    counts and the ledger counters."""

    @staticmethod
    def _run_stream(m, cap):
        stream = _stream_modules(m)

        def batches():
            for i in range(6):
                yield {"t": np.full(8, float(i)),
                       "k": np.arange(8, dtype=np.int64),
                       "v": np.full(8, 1.0)}

        agg = stream.StreamingFrame(stream.GeneratorSource(batches())) \
            .group_by("k").aggregate(
                {"v": "sum"}, window=stream.tumbling(2.0), time_col="t",
                watermark_delay=10.0,  # nothing emits by watermark
                max_state_rows=cap)
        h = agg.start()
        h.run()
        return (agg.state_spills, agg.state_evictions, agg.state_faults,
                _stream_rows(h))

    def test_spills_and_keeps_windows_live(self):
        ref = same(both(lambda m, mem: self._run_stream(m, 10 ** 9),
                        limit=0))
        got = same(both(lambda m, mem: self._run_stream(m, 8),
                        limit=10 ** 9))
        spills, evictions, faults, rows = got
        assert spills > 0
        # with a memory manager the cap spills, never force-emits
        assert evictions == 0
        assert rows == ref[3]  # results identical to the uncapped run
        assert faults == 0     # no window was touched twice here

    def test_spilled_window_faults_back_on_late_fold(self):
        def fn(m, mem):
            stream = _stream_modules(m)

            def batches():
                # window 0 fills, window 2 pushes it out (spill), then
                # more rows for window 0 arrive: fault-back and fold
                yield {"t": np.full(8, 0.0),
                       "k": np.arange(8, dtype=np.int64),
                       "v": np.full(8, 1.0)}
                yield {"t": np.full(8, 2.0),
                       "k": np.arange(8, dtype=np.int64),
                       "v": np.full(8, 1.0)}
                yield {"t": np.full(8, 0.5),
                       "k": np.arange(8, dtype=np.int64),
                       "v": np.full(8, 2.0)}

            agg = stream.StreamingFrame(stream.GeneratorSource(batches())) \
                .group_by("k").aggregate(
                    {"v": "sum"}, window=stream.tumbling(2.0),
                    time_col="t", watermark_delay=10.0, max_state_rows=8)
            h = agg.start()
            h.run()
            return agg.state_spills, agg.state_faults, _stream_rows(h)

        spills, faults, rows = same(both(fn, limit=10 ** 9))
        assert spills > 0 and faults > 0
        # window 0: v = 1 + 2 = 3 per key; window 2: v = 1 per key
        w0 = [r for r in rows if r[0] == 0.0]
        assert all(r[2] == 3.0 for r in w0) and len(w0) == 8

    def test_without_budget_force_evicts_as_before(self):
        spills, evictions, _, _ = same(both(
            lambda m, mem: self._run_stream(m, 8), limit=0))
        assert evictions > 0
        assert spills == 0

    def test_ledger_touch_faults_a_spilled_window_back(self):
        def fn(m, mem):
            stream = _stream_modules(m)
            agg = stream.StreamingFrame(stream.GeneratorSource(
                {"t": np.full(8, float(i)), "k": np.arange(8, dtype=np.int64),
                 "v": np.arange(8.0) + i} for i in range(3))) \
                .group_by("k").aggregate(
                    {"v": "sum"}, window=stream.tumbling(2.0),
                    time_col="t", watermark_delay=10.0, max_state_rows=8)
            h = agg.start()
            h.run(max_batches=3)
            spilled = [w for w in agg._windows.values() if w.spilled]
            mgr = mem.active()
            for w in spilled:
                mgr.touch(w)  # the ledger faults it back itself
            resident = all(not w.spilled for w in agg._windows.values())
            h.run()
            return (len(spilled), resident, agg.state_faults,
                    _stream_rows(h))

        n_spilled, resident, faults, rows = same(both(fn, limit=10 ** 9))
        assert n_spilled == 1 and resident and faults == 1
        assert [r[2] for r in rows] == list(np.arange(8.0) * 2 + 1) \
            + list(np.arange(8.0) + 2)

    def test_audit_balances_with_spilled_windows(self):
        def fn(m, mem):
            _, _, _, rows = self._run_stream(m, 8)
            inv = (jinvariants if m is jtf else tinvariants)
            with inv.strict():
                return rows, inv.audit("test.stream")
        rows, found = same(both(fn, limit=10 ** 9))
        assert found == [] and len(rows) == 24


# ---------------------------------------------------------------------------
# zero-cost when unlimited
# ---------------------------------------------------------------------------

class TestZeroCostUnlimited:
    def test_active_is_none_without_budget(self):
        def fn(m, mem):
            mem.configure(limit_bytes=0)
            return mem.active() is None
        assert same(both(fn)) is True

    def test_the_cpu_has_no_budget_without_the_knob(self):
        tmem._reset()
        assert tmem.active() is None
        assert tmem.manager().limit is None

    def test_no_ledger_traffic_in_relational_suite(self):
        rng = np.random.default_rng(4)
        k = rng.integers(0, 10, 1000).astype(np.int64)
        v = rng.random(1000)

        def fn(m, mem):
            df = m.frame({"k": k, "v": v}, num_partitions=4)
            df.map_blocks(lambda v: {"z": v + 1.0}).filter(
                lambda z: z > 0.5).blocks()
            return m.aggregate({"v": "sum"}, df.group_by("k")).blocks()[0] \
                .columns["k"]
        res = both(fn, limit=0)
        same(res)
        assert not any(n.startswith("memory.") for n in res["torch"][1])
        assert tmem.manager().snapshot()["inflight_bytes"] == 0

    def test_bypass_context(self):
        def fn(m, mem):
            mgr = mem.active()
            with mem.bypass():
                inside = mem.active() is None
            return inside, mem.active() is mgr
        assert same(both(fn, limit=1000)) == (True, True)


# ---------------------------------------------------------------------------
# the persist tier (tests/test_fabric.py's persist cases,
# tests/test_chaos.py::TestPersistChecksums)
# ---------------------------------------------------------------------------

PERSIST = {"jax": (jpersist, jcheckpoint, jfaults, jflight, jcounters),
           "torch": (tpersist, tcheckpoint, tfaults, tflight, tcounters)}


@pytest.fixture
def tier(tmp_path):
    """Each package's persist tier in its own directory; the previous
    overrides restored after."""
    dirs = {}
    prev = {}
    for name, (persist, *_rest) in PERSIST.items():
        dirs[name] = tmp_path / name
        prev[name] = persist.configure(str(dirs[name]))
    yield dirs
    for name, (persist, *_rest) in PERSIST.items():
        persist.configure(prev[name])


def per_tier(fn):
    """``fn(persist, checkpoint, faults, flight)`` per package; returns
    ``{pkg: (value, persist/memory counters)}``."""
    out = {}
    for name, (persist, cp, faults, flight, c) in PERSIST.items():
        c.reset()
        out[name] = (fn(persist, cp, faults, flight), _ledger(c))
    return out


class TestPersist:
    def test_persist_checkpoint_roundtrip(self, tier):
        def fn(persist, cp, faults, flight):
            q = cp.QueryCheckpoint("q-rt")
            q.park_stream(iter([{"x": np.arange(4.0)},
                                {"x": np.arange(4.0, 8.0)}]), total=4,
                          tag="tag-a")
            n = persist.stats()["checkpoints"]
            q.free()  # process memory dies; disk must not
            back = persist.load_checkpoint("q-rt")
            vals = list(back.resume_stream(total=4, tag="tag-a"))
            return n, persist.stats()["checkpoints"], len(vals), vals[0]["x"]
        got = same(per_tier(fn))
        assert got[:3] == (1, 1, 2)
        np.testing.assert_array_equal(got[3], np.arange(4.0))

    def test_persist_checkpoint_tag_mismatch_discards(self, tier):
        def fn(persist, cp, faults, flight):
            q = cp.QueryCheckpoint("q-mm")
            q.park_stream(iter([{"x": np.arange(4.0)}]), total=3, tag="a")
            back = persist.load_checkpoint("q-mm")
            return back.resume_stream(total=3, tag="B"), back.parked_blocks
        assert same(per_tier(fn)) == (None, 0)

    def test_persist_corrupt_checkpoint_is_cold_rerun(self, tier):
        def fn(persist, cp, faults, flight):
            q = cp.QueryCheckpoint("q-corrupt")
            q.park_stream(iter([{"x": np.arange(4.0)}]), total=1, tag="t")
            files = list(__import__("pathlib").Path(persist.root(),
                                                   "checkpoints").iterdir())
            files[0].write_bytes(b"not a pickle")
            return (len(files), persist.load_checkpoint("q-corrupt"),
                    persist.stats()["checkpoints"])
        assert same(per_tier(fn)) == (1, None, 0)

    def test_persist_result_budget_sweep(self, tier, monkeypatch):
        def fn(persist, cp, faults, flight):
            blocks = [{"x": np.arange(256.0)}]
            persist.save_result("fp-old", blocks)
            size = persist.stats()["result_bytes"]
            monkeypatch.setenv("TFT_PERSIST_RESULT_BYTES",
                               str(int(size * 2.5)))
            for fp in ("fp-mid", "fp-new"):
                time.sleep(0.02)  # mtime ordering
                persist.save_result(fp, blocks)
            monkeypatch.delenv("TFT_PERSIST_RESULT_BYTES")
            return (persist.load_result("fp-old"),
                    persist.load_result("fp-new")[0]["x"])
        got = same(per_tier(fn))
        assert got[0] is None
        np.testing.assert_array_equal(got[1], np.arange(256.0))

    def _result_path(self, persist):
        d = os.path.join(persist.root(), "results")
        names = os.listdir(d)
        assert len(names) == 1
        return os.path.join(d, names[0])

    def test_roundtrip_bit_identical(self, tier):
        def fn(persist, cp, faults, flight):
            blocks = [{"x": np.arange(16.0)}]
            ok = persist.save_result("fp-rt", blocks)
            return ok, persist.load_result("fp-rt")[0]["x"]
        got = same(per_tier(fn))
        assert got[0] is True
        np.testing.assert_array_equal(got[1], np.arange(16.0))

    def test_bit_rot_detected_and_cold(self, tier):
        arr = np.arange(16.0)

        def fn(persist, cp, faults, flight):
            persist.save_result("fp-rot", [{"x": arr}])
            path = self._result_path(persist)
            with open(path, "rb") as f:
                data = bytearray(f.read())
            off = data.find(arr.tobytes())
            assert off > 0, "float buffer not found in the artifact"
            data[off + 40] ^= 0x01  # still unpickles, to wrong values
            with open(path, "wb") as f:
                f.write(bytes(data))
            payload = bytes(data[len(persist._MAGIC)
                                 + persist._DIGEST_LEN:])
            assert pickle.loads(payload) is not None
            recs = []
            got = persist.load_result("fp-rot")
            recs = [r for r in flight.recent()
                    if r["kind"] == "memory.persist_corrupt"]
            return got, os.path.exists(path), "checksum" in recs[-1]["why"]
        res = per_tier(fn)
        assert same(res) == (None, False, True)
        assert res["torch"][1]["memory.persist_corrupt"] == 1

    def test_missing_header_cold(self, tier):
        def fn(persist, cp, faults, flight):
            persist.save_result("fp-hdr", [{"x": np.arange(4.0)}])
            path = self._result_path(persist)
            with open(path, "wb") as f:
                f.write(b"not a framed artifact")
            return persist.load_result("fp-hdr"), os.path.exists(path)
        res = per_tier(fn)
        assert same(res) == (None, False)
        assert res["torch"][1]["memory.persist_corrupt"] == 1

    def test_checksum_ok_unpickle_fails_is_skew_not_rot(self, tier):
        def fn(persist, cp, faults, flight):
            persist.save_result("fp-skew", [{"x": np.arange(4.0)}])
            with open(self._result_path(persist), "wb") as f:
                f.write(persist._pack(b"not-a-pickle"))
            return persist.load_result("fp-skew")
        res = per_tier(fn)
        assert same(res) is None
        assert res["torch"][1] == {"persist.result_writes": 1,
                                   "persist.read_errors": 1}

    def test_disk_fault_read_failure_mode(self, tier):
        def fn(persist, cp, faults, flight):
            persist.save_result("fp-io", [{"x": np.arange(4.0)}])
            with faults.inject("disk"):
                return persist.load_result("fp-io")
        res = per_tier(fn)
        assert same(res) is None
        assert res["torch"][1]["persist.read_errors"] == 1
        assert "memory.persist_corrupt" not in res["torch"][1]

    def test_disk_fault_corruption_mode(self, tier):
        def fn(persist, cp, faults, flight):
            persist.save_result("fp-crpt", [{"x": np.arange(4.0)}])
            with faults.inject("disk", message="injected corrupt artifact"):
                return persist.load_result("fp-crpt")
        res = per_tier(fn)
        assert same(res) is None
        assert res["torch"][1]["memory.persist_corrupt"] == 1
        assert "persist.read_errors" not in res["torch"][1]

    def test_checkpoint_artifacts_framed_too(self, tier):
        def fn(persist, cp, faults, flight):
            q = cp.QueryCheckpoint("q-framed")
            q.park_stream([np.arange(8.0)], total=2, tag="s")
            loaded = persist.load_checkpoint("q-framed")
            d = os.path.join(persist.root(), "checkpoints")
            with open(os.path.join(d, os.listdir(d)[0]), "rb") as f:
                return loaded is not None, f.read(len(persist._MAGIC))
        got = same(per_tier(fn))
        assert got == (True, tpersist._MAGIC) == (True, jpersist._MAGIC)

    def test_baselines_round_trip(self, tier):
        def fn(persist, cp, faults, flight):
            ok = persist.save_baseline("fp-b", {"wall_s": [0.5, 0.25]})
            return ok, persist.load_baseline("fp-b"), \
                persist.load_baseline("fp-none"), persist.stats()["baselines"]
        assert same(per_tier(fn)) == (True, {"wall_s": [0.5, 0.25]}, None, 1)

    def test_device_values_persist_as_numpy(self, tier):
        """A parked tensor is written as numpy bytes with its dtype's name
        (no tensor, no device in the file) and restores bit for bit,
        bf16 included, on the default device."""
        cp = tcheckpoint.QueryCheckpoint("q-dev")
        vals = [torch.arange(6, dtype=torch.float32),
                torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
                {"k": torch.arange(3, dtype=torch.int64),
                 "s": np.array(["a"], object)}]
        cp.park_stream(vals, total=3, tag="t")
        d = os.path.join(tpersist.root(), "checkpoints")
        with open(os.path.join(d, os.listdir(d)[0]), "rb") as f:
            raw = f.read()
        rec = pickle.loads(raw[len(tpersist._MAGIC) + tpersist._DIGEST_LEN:])
        assert b"torch" not in raw
        assert rec["vals"][1] == ("dev", rec["vals"][1][1], None, "bfloat16")
        assert isinstance(rec["vals"][1][1], np.ndarray)
        back = tpersist.load_checkpoint("q-dev").resume_stream(3, "t")
        for a, b in ((vals[0], back[0]), (vals[1], back[1]),
                     (vals[2]["k"], back[2]["k"])):
            assert b.dtype == a.dtype and b.device == ttf.default_device()
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        assert back[2]["s"].tolist() == ["a"]
