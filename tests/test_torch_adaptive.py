"""The port's adaptive execution (``plan/adaptive.py``) against the JAX
package's: ``tests/test_adaptive.py``'s ``TestAdaptiveBlockSizing``,
``TestReplanning``, ``TestResultCache`` and ``TestStreamBatchSizing``.

Every case runs in both packages on the same numpy inputs. The contract
is the JAX suite's: with ``TFT_ADAPTIVE`` and ``TFT_RESULT_CACHE`` on (the
default) a chain's blocks are bit-identical to the static layout
(``=0``), value for value, dtype for dtype, block boundaries included;
and the two packages agree with each other, exactly (the programs are
elementwise f64 and comparisons), and on the adaptive counters. No
decision here depends on the host's timing: the layout pass is gated by
the presence of feedback, not its wall, and the stream batcher's wall
thresholds are injected (``TFT_ADAPTIVE_BATCH_MIN_S``).

``TestPreemptAwareAdmission`` imports the serve layer, which the port
does not have yet (``ROADMAP.md`` A item 4).
"""

import importlib
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import io as jio
from tensorframes_tpu import memory as jmem
from tensorframes_tpu import relational as jrel
from tensorframes_tpu import stream as jstream
from tensorframes_tpu.frame import Block as JBlock
from tensorframes_tpu.frame import TensorFrame as JTensorFrame
from tensorframes_tpu.plan import adaptive as jadaptive
from tensorframes_tpu.utils.tracing import counters as jcounters
from tensorframes_tpu_torch import io as tio
from tensorframes_tpu_torch import memory as tmem
from tensorframes_tpu_torch import relational as trel
from tensorframes_tpu_torch import stream as tstream
from tensorframes_tpu_torch.frame import Block as TBlock
from tensorframes_tpu_torch.frame import TensorFrame as TTensorFrame
from tensorframes_tpu_torch.plan import adaptive as tadaptive
from tensorframes_tpu_torch.utils.tracing import counters as tcounters

JAX = SimpleNamespace(name="jax", tft=jtf, io=jio, mem=jmem, rel=jrel,
                      stream=jstream, Block=JBlock, TF=JTensorFrame,
                      adaptive=jadaptive, counters=jcounters)
TORCH = SimpleNamespace(name="torch", tft=ttf, io=tio, mem=tmem, rel=trel,
                        stream=tstream, Block=TBlock, TF=TTensorFrame,
                        adaptive=tadaptive, counters=tcounters)
PKGS = (JAX, TORCH)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Both packages' knobs at their defaults (adaptive on), the port on
    the CPU, and no result or feedback left over from another test."""
    import jax
    if not hasattr(jax.core, "Literal"):
        from jax.extend import core as jax_extend_core
        monkeypatch.setattr(jax.core, "Literal", jax_extend_core.Literal,
                            raising=False)
    monkeypatch.setenv("TFT_RETRY_BASE_DELAY", "0.001")
    for knob in ("TFT_ADAPTIVE", "TFT_RESULT_CACHE", "TFT_FUSE",
                 "TFT_MEM_LIMIT_BYTES", "TFT_PIPELINE_DEPTH"):
        monkeypatch.delenv(knob, raising=False)
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    _forget_feedback()
    yield
    # the JAX package's own adaptive suite may run next in this process:
    # it expects no feedback for its plan shapes, which share these tags
    _forget_feedback()
    ttf.set_default_device(prev)


# module state a program reads through a global name (the in-place case of
# TestResultCache)
_STATE: dict = {}


def _scaled_by_global_state(x):
    return {"y": x * _STATE["w"]}


def _forget_feedback():
    for p in PKGS:
        p.adaptive.invalidate_results()
        with p.adaptive._fb_lock:
            p.adaptive._feedback.clear()


def _snapshot(frame):
    out = []
    for b in frame.blocks():
        cols = {}
        for n, c in b.columns.items():
            cols[n] = list(c) if not isinstance(c, np.ndarray) else c
        out.append((b.num_rows, cols))
    return out


def _assert_identical(a_snap, b_snap):
    assert len(a_snap) == len(b_snap), "block count differs"
    for i, ((na, ca), (nb, cb)) in enumerate(zip(a_snap, b_snap)):
        assert na == nb, f"block {i}: rows {na} != {nb}"
        assert list(ca) == list(cb), f"block {i}: columns differ"
        for n in cb:
            a, s = ca[n], cb[n]
            if isinstance(s, np.ndarray):
                assert isinstance(a, np.ndarray), (i, n)
                assert a.dtype == s.dtype, (i, n, a.dtype, s.dtype)
                assert a.shape == s.shape, (i, n, a.shape, s.shape)
                assert np.array_equal(a, s), (i, n)
            else:
                assert len(a) == len(s), (i, n)
                for x, y in zip(a, s):
                    assert np.array_equal(np.asarray(x), np.asarray(y))


def _static_snapshot(monkeypatch, build):
    monkeypatch.setenv("TFT_ADAPTIVE", "0")
    monkeypatch.setenv("TFT_RESULT_CACHE", "0")
    snap = _snapshot(build())
    monkeypatch.delenv("TFT_ADAPTIVE")
    monkeypatch.delenv("TFT_RESULT_CACHE")
    return snap


def _both(case):
    """``case(pkg)`` in each package; returns ``{name: result}``."""
    return {p.name: case(p) for p in PKGS}


def _same_snaps(res, *keys):
    """The port's snapshots equal the JAX package's, key by key."""
    for k in keys:
        _assert_identical(res["torch"][k], res["jax"][k])


# ---------------------------------------------------------------------------
# leg 1: adaptive block sizing
# ---------------------------------------------------------------------------

class TestAdaptiveBlockSizing:
    def test_coalesce_engages_second_forcing_and_is_bit_identical(
            self, monkeypatch):
        def case(p):
            df = p.tft.frame({"x": np.arange(3000, dtype=np.float64)},
                             num_partitions=48)
            df.cache()
            f = lambda x: {"y": x * 2.0 + 1.0}        # noqa: E731
            q = lambda y: y > 500.0                   # noqa: E731

            def build():
                return df.map_rows(f).filter(q).select(["y"])

            before = p.counters.get("plan.adaptive_layouts")
            first = _snapshot(build())
            # the first forcing runs the static layout (no feedback yet)
            assert p.counters.get("plan.adaptive_layouts") == before
            c0 = p.counters.get("plan.adaptive_coalesces")
            second = _snapshot(build())
            assert p.counters.get("plan.adaptive_layouts") == before + 1
            assert p.counters.get("plan.adaptive_coalesces") == c0 + 1
            static = _static_snapshot(monkeypatch, build)
            _assert_identical(first, static)
            _assert_identical(second, static)
            return {"first": first, "second": second}

        _same_snaps(_both(case), "first", "second")

    def test_split_oversized_block_under_ledger(self, monkeypatch):
        def case(p):
            f = lambda x: {"y": x + 0.5}              # noqa: E731
            g = lambda y: {"z": y * 2.0}              # noqa: E731
            out = {}
            for parts in (2, 1):
                df = p.tft.frame({"x": np.arange(60_000,
                                                 dtype=np.float64)},
                                 num_partitions=parts)
                df.cache()

                def build():
                    return df.map_rows(f).map_rows(g).select(["z"])

                static = _static_snapshot(monkeypatch, build)
                p.mem.configure(limit_bytes=300_000)  # blocks ~480 KB
                try:
                    before = p.counters.get("plan.adaptive_splits")
                    first = _snapshot(build())    # static (feedback gate)
                    second = _snapshot(build())   # split layout
                    assert p.counters.get("plan.adaptive_splits") > before
                finally:
                    p.mem._reset()
                _assert_identical(first, static)
                _assert_identical(second, static)
                out[parts] = second
            return out

        _same_snaps(_both(case), 2, 1)

    def test_empty_and_skewed_partitions_restore_boundaries(
            self, monkeypatch):
        arrays = ([np.arange(400.0)] + [np.empty(0)] * 3
                  + [np.arange(400.0, 405.0)] * 20)

        def case(p):
            schema = p.tft.frame({"x": arrays[0]}).schema
            bl = [p.Block({"x": a}, len(a)) for a in arrays]
            df = p.TF.from_blocks(bl, schema)
            df.cache()
            f = lambda x: {"y": x - 1.0}              # noqa: E731
            q = lambda y: y < 300.0                   # noqa: E731

            def build():
                return df.map_rows(f).filter(q)

            _snapshot(build())                        # feedback
            before = p.counters.get("plan.adaptive_layouts")
            adaptive = _snapshot(build())
            assert p.counters.get("plan.adaptive_layouts") == before + 1
            static = _static_snapshot(monkeypatch, build)
            _assert_identical(adaptive, static)
            assert len(adaptive) == len(bl)
            return {"adaptive": adaptive}

        _same_snaps(_both(case), "adaptive")

    def test_cross_row_map_blocks_never_rebuckets(self, monkeypatch):
        def case(p):
            df = p.tft.frame({"x": np.arange(900, dtype=np.float64)},
                             num_partitions=30)
            df.cache()
            f = lambda x: {"z": x - x.mean()}         # noqa: E731
            g = lambda z: {"w": z * 2.0}              # noqa: E731

            def build():
                return df.map_blocks(f).map_blocks(g).select(["w"])

            before = p.counters.get("plan.adaptive_layouts")
            first = _snapshot(build())
            second = _snapshot(build())
            assert p.counters.get("plan.adaptive_layouts") == before
            static = _static_snapshot(monkeypatch, build)
            _assert_identical(first, static)
            _assert_identical(second, static)
            return {"second": second}

        res = _both(case)
        # x - mean(x): the two packages' means may round apart
        for (na, ca), (nb, cb) in zip(res["torch"]["second"],
                                      res["jax"]["second"]):
            assert na == nb
            np.testing.assert_allclose(ca["w"], cb["w"], rtol=1e-12,
                                       atol=1e-12)

    def test_adaptive_layout_over_join_leaf(self, monkeypatch):
        def case(p):
            left = p.tft.frame(
                {"k": np.arange(600, dtype=np.int64) % 50,
                 "v": np.arange(600, dtype=np.float64)},
                num_partitions=24)
            right = p.tft.frame(
                {"k": np.arange(50, dtype=np.int64),
                 "w": np.arange(50, dtype=np.float64) * 10.0})
            left.cache()
            right.cache()
            f = lambda v, w: {"s": v + w}             # noqa: E731

            def build():
                out = p.rel.broadcast_join(left, right, on="k", how="left")
                return out.map_rows(f).select(["k", "s"])

            first = _snapshot(build())
            second = _snapshot(build())
            static = _static_snapshot(monkeypatch, build)
            _assert_identical(first, static)
            _assert_identical(second, static)
            return {"first": first, "second": second}

        _same_snaps(_both(case), "first", "second")


# ---------------------------------------------------------------------------
# leg 2: re-planning from observed selectivity
# ---------------------------------------------------------------------------

class TestReplanning:
    def test_filter_reorder_is_bit_identical(self, monkeypatch):
        def case(p):
            df = p.tft.frame({"z": np.arange(4000, dtype=np.float64)},
                             num_partitions=16)
            df.cache()
            p_all = lambda z: z >= 0.0                # noqa: E731
            p_few = lambda z: z < 15.0                # noqa: E731

            def build():
                return df.filter(p_all).filter(p_few)

            before = p.counters.get("plan.filter_reorders")
            first = _snapshot(build())      # records selectivities
            frame = build()
            second = _snapshot(frame)       # re-ordered plan
            assert p.counters.get("plan.filter_reorders") > before
            assert any("re-ordered" in line
                       for line in frame._plan_info or ())
            static = _static_snapshot(monkeypatch, build)
            _assert_identical(first, static)
            _assert_identical(second, static)
            return {"first": first, "second": second}

        _same_snaps(_both(case), "first", "second")

    def test_cross_row_predicate_never_reorders(self, monkeypatch):
        def case(p):
            df = p.tft.frame({"z": np.arange(1000, dtype=np.float64)},
                             num_partitions=4)
            df.cache()
            p_mean = lambda z: z > z.mean()           # noqa: E731
            p_few = lambda z: z < 900.0               # noqa: E731

            def build():
                return df.filter(p_mean).filter(p_few)

            before = p.counters.get("plan.filter_reorders")
            first = _snapshot(build())
            second = _snapshot(build())
            assert p.counters.get("plan.filter_reorders") == before
            static = _static_snapshot(monkeypatch, build)
            _assert_identical(first, static)
            _assert_identical(second, static)
            return {"second": second}

        _same_snaps(_both(case), "second")

    def test_mid_plan_replan_on_shifted_distribution(self, monkeypatch):
        """q2 keeps everything on the warm-up data, then drops 99% on the
        real forcing: the first unit's observation deviates past
        ``TFT_REPLAN_RATIO`` and the remaining units re-plan."""
        monkeypatch.setenv("TFT_REPLAN_RATIO", "3")

        def case(p):
            q1 = lambda v: v > -1.0                   # noqa: E731
            q2 = lambda v: v < 50.0                   # noqa: E731

            def chain(frame):
                return frame.filter(q1).filter(q2)

            warm = p.tft.frame({"v": np.arange(30, dtype=np.float64)},
                               num_partitions=30)
            warm.cache()
            _snapshot(chain(warm))          # priced ~keep-everything
            _snapshot(chain(warm))          # feedback for the shape
            big = p.tft.frame({"v": np.arange(6000, dtype=np.float64)},
                              num_partitions=30)
            big.cache()

            def build():
                return chain(big)

            before = p.counters.get("plan.replans")
            out = _snapshot(build())
            assert p.counters.get("plan.replans") == before + 1
            static = _static_snapshot(monkeypatch, build)
            _assert_identical(out, static)
            return {"out": out}

        _same_snaps(_both(case), "out")


    def test_join_cardinality_from_build_table_spans(self):
        """Duplicate build keys, 4 rows a key: the sketch-based estimate
        prices the expansion (true 400); unique keys stay exact."""
        def case(p):
            left = p.tft.frame({"k": np.arange(100, dtype=np.int64) % 10,
                                "v": np.arange(100, dtype=np.float64)})
            right = p.tft.frame(
                {"k": np.repeat(np.arange(10, dtype=np.int64), 4),
                 "w": np.arange(40, dtype=np.float64)})
            est = p.rel.broadcast_join(left, right, on="k",
                                       how="inner").estimated_rows()
            assert est is not None and 300 <= est <= 500
            right_u = p.tft.frame({"k": np.arange(10, dtype=np.int64),
                                   "w": np.arange(10, dtype=np.float64)})
            out_u = p.rel.broadcast_join(left, right_u, on="k", how="left")
            assert out_u.estimated_rows() == 100
            return est

        res = _both(case)
        assert res["torch"] == res["jax"]

    def test_approx_key_distinct_probe(self):
        def case(p):
            akd = importlib.import_module(
                p.rel.__name__ + ".join").approx_key_distinct
            df = p.tft.frame({"k": (np.arange(5000) % 137).astype(np.int64),
                              "v": np.arange(5000, dtype=np.float64)},
                             num_partitions=4)
            assert akd(df, ["k"]) is None  # unforced
            df.cache()
            est = akd(df, ["k"])
            assert est is not None and abs(est - 137) / 137 < 0.15
            before = p.counters.get("relational.key_distinct_probes")
            assert akd(df, ["k"]) == est   # cached per (keys, version)
            assert p.counters.get("relational.key_distinct_probes") == before
            return est

        res = _both(case)
        assert res["torch"] == res["jax"]


# ---------------------------------------------------------------------------
# leg 3: the plan-fingerprint result cache
# ---------------------------------------------------------------------------

class TestResultCache:
    def test_two_touch_hit_with_zero_dispatches(self, monkeypatch):
        def case(p):
            df = p.tft.frame({"x": np.arange(512, dtype=np.float64)},
                             num_partitions=8)
            df.cache()
            f = lambda x: {"y": x * 3.0}              # noqa: E731

            def build():
                return df.map_blocks(f).select(["y"])

            static = _static_snapshot(monkeypatch, build)
            hits0 = p.counters.get("plan.result_cache_hits")
            _snapshot(build())        # 1st: seen
            _snapshot(build())        # 2nd: interned
            assert p.counters.get("plan.result_cache_hits") == hits0
            before = (p.counters.get("pipeline.submitted"),
                      p.counters.get("pipeline.drained"))
            frame = build()
            out = _snapshot(frame)    # 3rd: HIT
            after = (p.counters.get("pipeline.submitted"),
                     p.counters.get("pipeline.drained"))
            assert p.counters.get("plan.result_cache_hits") == hits0 + 1
            assert after == before, "a cache hit must dispatch nothing"
            assert frame._plan_info and "result cache" in \
                frame._plan_info[0]
            _assert_identical(out, static)
            return {"out": out}

        _same_snaps(_both(case), "out")

    def test_off_switch(self, monkeypatch):
        monkeypatch.setenv("TFT_RESULT_CACHE", "0")

        def case(p):
            df = p.tft.frame({"x": np.arange(64, dtype=np.float64)})
            df.cache()
            f = lambda x: {"y": x + 1.0}              # noqa: E731
            hits0 = p.counters.get("plan.result_cache_hits")
            for _ in range(4):
                _snapshot(df.map_blocks(f))
            assert p.counters.get("plan.result_cache_hits") == hits0
            return p.adaptive.result_cache_stats()

        res = _both(case)
        assert res["torch"] == res["jax"] == {"entries": 0, "bytes": 0}

    def test_uncache_reversions_and_misses(self):
        def case(p):
            df = p.tft.frame({"x": np.arange(64, dtype=np.float64)})
            df.cache()
            f = lambda x: {"y": x + 1.0}              # noqa: E731
            _snapshot(df.map_blocks(f))
            _snapshot(df.map_blocks(f))   # interned
            hits0 = p.counters.get("plan.result_cache_hits")
            df.uncache()                  # source re-versioned
            df.cache()
            _snapshot(df.map_blocks(f))
            assert p.counters.get("plan.result_cache_hits") == hits0
            return df._version

        assert _both(case) == {"jax": 1, "torch": 1}

    def test_stale_invalidation_after_parquet_append(
            self, monkeypatch, tmp_path):
        import pyarrow as pa
        import pyarrow.parquet as pq

        def case(p):
            path = str(tmp_path / f"{p.name}.parquet")
            p.io.write_parquet(
                p.tft.frame({"x": np.arange(32, dtype=np.float64)},
                            num_partitions=2), path)
            f = lambda x: {"y": x * 2.0}              # noqa: E731

            def build():
                return p.io.read_parquet(path).map_blocks(f).select(["y"])

            static = _static_snapshot(monkeypatch, build)
            _snapshot(build())
            second = _snapshot(build())               # interned
            _assert_identical(second, static)
            hits0 = p.counters.get("plan.result_cache_hits")
            out3 = _snapshot(build())                 # hit
            assert p.counters.get("plan.result_cache_hits") == hits0 + 1
            _assert_identical(out3, static)
            # rewrite the file: its footer identity changes, so the old
            # entry can never hit
            time.sleep(0.01)
            table = pa.table({"x": np.arange(40, dtype=np.float64)})
            with pq.ParquetWriter(path, table.schema) as w:
                w.write_table(table)
            hits1 = p.counters.get("plan.result_cache_hits")
            fresh = _snapshot(build())
            assert p.counters.get("plan.result_cache_hits") == hits1
            assert sum(n for n, _ in fresh) == 40
            return {"out3": out3, "fresh": fresh}

        _same_snaps(_both(case), "out3", "fresh")

    def test_streaming_batches_never_pollute_the_cache(self):
        def case(p):
            stats0 = p.adaptive.result_cache_stats()["entries"]

            def batches():
                for i in range(6):
                    yield {"x": np.arange(8, dtype=np.float64) + i}

            f = lambda x: {"y": x + 1.0}              # noqa: E731
            h = p.stream.from_source(p.stream.GeneratorSource(batches())) \
                .map_blocks(f).start(name="rc-pollute")
            h.run()
            assert p.adaptive.result_cache_stats()["entries"] == stats0
            return h.metrics()["batches"]

        assert _both(case) == {"jax": 6, "torch": 6}

    def test_lru_eviction_under_entry_budget(self, monkeypatch):
        monkeypatch.setenv("TFT_RESULT_CACHE_ENTRIES", "2")

        def case(p):
            df = p.tft.frame({"x": np.arange(32, dtype=np.float64)})
            df.cache()
            fns = [(lambda k: (lambda x: {"y": x + float(k)}))(k)
                   for k in range(4)]
            ev0 = p.counters.get("plan.result_cache_evictions")
            for k in range(4):
                _snapshot(df.map_blocks(fns[k]))
                _snapshot(df.map_blocks(fns[k]))   # intern each
            return (p.adaptive.result_cache_stats()["entries"],
                    p.counters.get("plan.result_cache_evictions") - ev0)

        assert _both(case) == {"jax": (2, 2), "torch": (2, 2)}

    @pytest.mark.parametrize("kind", ["tensor_add_", "tensor_copy_",
                                      "array", "global_tensor"])
    def test_mutable_state_updated_in_place_is_never_served_stale(
            self, kind):
        """The port runs a program eagerly at every forcing, so a program
        that reads state which changes in place (a weight an optimizer
        steps, centers updated with ``copy_``) must see each new value:
        its chain is never cached. (The JAX package's ``jit`` bakes the
        closure in at the first trace, so it has no counterpart here.)"""
        df = ttf.frame({"x": np.arange(64, dtype=np.float64)},
                       num_partitions=4)
        df.cache()
        w = np.full((), 2.0) if kind == "array" else \
            torch.tensor(2.0, dtype=torch.float64)
        if kind == "global_tensor":
            _STATE["w"] = w
            f = _scaled_by_global_state
        else:
            f = lambda x: {"y": x * torch.as_tensor(w)}  # noqa: E731
        hits0 = tcounters.get("plan.result_cache_hits")
        for step in range(4):
            out = np.concatenate([b.columns["y"] for b in
                                  df.map_rows(f).select(["y"]).blocks()])
            np.testing.assert_array_equal(
                out, np.arange(64.0) * (2.0 + step))
            if kind == "tensor_copy_":
                w.copy_(torch.tensor(3.0 + step, dtype=torch.float64))
            else:
                w += 1.0
        assert tcounters.get("plan.result_cache_hits") == hits0
        assert tadaptive.result_cache_stats()["entries"] == 0
        _STATE.clear()

    def test_rebound_closure_scalar_changes_the_key(self):
        """State read by value (a scalar a closure cell holds) keys the
        entry: rebinding it forces anew, and a steady value still hits on
        the third forcing."""
        df = ttf.frame({"x": np.arange(32, dtype=np.float64)})
        df.cache()
        scale = 2.0
        f = lambda x: {"y": x * scale}                # noqa: E731

        def force():
            return np.concatenate([b.columns["y"] for b in
                                   df.map_rows(f).select(["y"]).blocks()])

        hits0 = tcounters.get("plan.result_cache_hits")
        for scale in (2.0, 3.0, 3.0, 4.0, 4.0, 4.0):
            np.testing.assert_array_equal(force(), np.arange(32.0) * scale)
        assert tcounters.get("plan.result_cache_hits") == hits0 + 1
        assert tadaptive.program_state(
            ttf.frame({"x": np.zeros(2)}).map_rows(f)._plan_node.comp) \
            is not None

    def test_metrics_families_render(self):
        from tensorframes_tpu_torch.observability import metrics
        text = metrics.metrics_text()
        for fam in ("tft_plan_result_cache_hits_total",
                    "tft_plan_adaptive_layouts_total",
                    "tft_plan_replans_total",
                    "tft_stream_batch_grows_total",
                    "tft_plan_result_cache_bytes"):
            assert fam in text


# ---------------------------------------------------------------------------
# streams: adaptive batch sizing
# ---------------------------------------------------------------------------

class TestStreamBatchSizing:
    @staticmethod
    def _rows(frames):
        out = []
        for fr in frames:
            for b in fr.blocks():
                out.extend(np.asarray(b.columns["y"]).tolist())
        return out

    def test_adaptive_batches_same_rows(self, monkeypatch):
        # every batch counts as fast: the row target doubles each batch
        monkeypatch.setenv("TFT_ADAPTIVE_BATCH_MIN_S", "1e9")

        def case(p):
            f = lambda x: {"y": x * 2.0}              # noqa: E731

            def batches():
                for i in range(24):
                    yield {"x": np.arange(4, dtype=np.float64) + 4 * i}

            h1 = p.stream.from_source(p.stream.GeneratorSource(batches())) \
                .map_blocks(f).start(name="ab-static")
            h1.run()
            want = self._rows(h1.collect_updates())
            h2 = p.stream.from_source(p.stream.GeneratorSource(batches())) \
                .map_blocks(f).start(name="ab-adaptive",
                                     batch_rows="adaptive")
            h2.run()
            got = self._rows(h2.collect_updates())
            assert got == want
            m = h2.metrics()
            assert m["rows"] == 24 * 4
            return got, m["batches"]

        res = _both(case)
        # 4, 8, 16, 32, 36 rows: five batches in both packages
        assert res["torch"] == res["jax"]
        assert res["torch"][1] == 5

    def test_slow_batches_shrink_the_target(self, monkeypatch):
        monkeypatch.setenv("TFT_ADAPTIVE_BATCH_MIN_S", "0")
        monkeypatch.setenv("TFT_ADAPTIVE_BATCH_MAX_S", "0")

        def case(p):
            b = p.adaptive.AdaptiveBatcher(row_bytes=8)
            b.observe(64, 1.0)
            b.observe(64, 1.0)
            return b.target, b.want_more(15), b.want_more(16)

        assert _both(case) == {"jax": (16, True, False),
                               "torch": (16, True, False)}

    def test_fixed_batch_rows_coalesce_and_kill_switch(self, monkeypatch):
        def case(p):
            f = lambda x: {"y": x + 1.0}              # noqa: E731

            def batches():
                for i in range(12):
                    yield {"x": np.arange(2, dtype=np.float64) + 2 * i}

            h = p.stream.from_source(p.stream.GeneratorSource(batches())) \
                .map_blocks(f).start(name="ab-fixed", batch_rows=8)
            h.run()
            on = (h.metrics()["rows"], h.metrics()["batches"])
            monkeypatch.setenv("TFT_ADAPTIVE", "0")
            h0 = p.stream.from_source(p.stream.GeneratorSource(batches())) \
                .map_blocks(f).start(name="ab-fixed-off", batch_rows=8)
            h0.run()
            monkeypatch.delenv("TFT_ADAPTIVE")
            return on, h0.metrics()["batches"]

        assert _both(case) == {"jax": ((24, 3), 12), "torch": ((24, 3), 12)}

    def test_windowed_aggregation_bit_identical_with_batching(
            self, monkeypatch):
        monkeypatch.setenv("TFT_ADAPTIVE_BATCH_MIN_S", "1e9")

        def case(p):
            def batches():
                for i in range(16):
                    yield {"k": (np.arange(4) % 2).astype(np.int64),
                           "v": np.arange(4, dtype=np.float64) + i,
                           "ts": np.full(4, float(i))}

            def run(**kw):
                h = p.stream.from_source(
                    p.stream.GeneratorSource(batches())) \
                    .group_by("k") \
                    .aggregate({"v": "sum"}, window=p.stream.tumbling(4.0),
                               time_col="ts") \
                    .start(name=f"ab-win-{len(kw)}", **kw)
                h.run()
                rows = []
                for fr in h.collect_updates():
                    for r in fr.collect():
                        rows.append((float(r["window_start"]),
                                     int(r["k"]), float(r["v"])))
                return sorted(rows)

            want = run()
            got = run(batch_rows="adaptive")
            assert got == want
            return got

        res = _both(case)
        assert res["torch"] == res["jax"]


class TestDurableResults:
    def test_warm_hit_from_the_persist_tier_after_a_restart(
            self, monkeypatch, tmp_path):
        """A parquet-rooted result admitted to the cache is written
        through under its portable fingerprint; once the in-memory cache
        is gone (a restarted worker), the same chain is served from disk
        with no dispatch (``plan.result_cache_warm_hits``)."""
        def case(p):
            monkeypatch.setenv("TFT_PERSIST_DIR",
                               str(tmp_path / f"persist-{p.name}"))
            path = str(tmp_path / f"{p.name}.parquet")
            p.io.write_parquet(
                p.tft.frame({"x": np.arange(48, dtype=np.float64)},
                            num_partitions=3), path)
            f = lambda x: {"y": x * 2.0}              # noqa: E731

            def build():
                return p.io.read_parquet(path).map_blocks(f).select(["y"])

            static = _static_snapshot(monkeypatch, build)
            _snapshot(build())
            _snapshot(build())                        # admitted, persisted
            p.adaptive.invalidate_results()           # the restart
            w0 = p.counters.get("plan.result_cache_warm_hits")
            d0 = p.counters.get("pipeline.submitted")
            warm = _snapshot(build())
            assert p.counters.get("plan.result_cache_warm_hits") == w0 + 1
            assert p.counters.get("pipeline.submitted") == d0
            _assert_identical(warm, static)
            monkeypatch.delenv("TFT_PERSIST_DIR")
            return {"warm": warm}

        _same_snaps(_both(case), "warm")
