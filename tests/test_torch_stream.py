"""The port's stream layer against the JAX package's
(``tests/test_stream.py``, and ``tests/test_relational.py``'s
``TestStreamJoin`` and ``TestSketchStream``).

Every case feeds the same seeded numpy batches to both packages (the JAX
package on the CPU with x64 and ``TFT_ADAPTIVE=0 TFT_RESULT_CACHE=0``,
the port on the CPU) and compares what comes out: the emitted frames
(window starts, keys in order, f64 values to rtol 1e-12, integers and
sketch registers exactly), the ``stream.*`` counters, and the error
types. The cases mirror ``tests/test_stream.py`` one for one: sources,
finite equivalence, windows and watermarks, bounded state, window state
in the memory ledger's LRU, failure isolation, sinks and metrics, the
slot pool and the background queue source.

One documented difference: the JAX package's steady state is "no
``compile_cache.misses`` after warm-up"; the port compiles nothing per
shape, so its steady state is "no new merge signature"
(``stream.merge_compiles``) after warm-up, held in both packages.
"""

import queue as queue_mod
import time
from types import SimpleNamespace

import numpy as np
import pytest

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import io as jio
from tensorframes_tpu import memory as jmem
from tensorframes_tpu import relational as jrel
from tensorframes_tpu import stream as jstream
from tensorframes_tpu.engine import pipeline as jpipeline
from tensorframes_tpu.engine.ops import InputNotFoundError as JInputNotFound
from tensorframes_tpu.observability import metrics as jmetrics
from tensorframes_tpu.resilience import faults as jfaults
from tensorframes_tpu.schema import Schema as JSchema
from tensorframes_tpu.stream import aggregate as jagg
from tensorframes_tpu.utils import tracing as jtracing
from tensorframes_tpu_torch import io as tio
from tensorframes_tpu_torch import memory as tmem
from tensorframes_tpu_torch import relational as trel
from tensorframes_tpu_torch import stream as tstream
from tensorframes_tpu_torch.engine import pipeline as tpipeline
from tensorframes_tpu_torch.engine.ops import \
    InputNotFoundError as TInputNotFound
from tensorframes_tpu_torch.observability import metrics as tmetrics
from tensorframes_tpu_torch.resilience import faults as tfaults
from tensorframes_tpu_torch.schema import Schema as TSchema
from tensorframes_tpu_torch.stream import aggregate as tagg
from tensorframes_tpu_torch.utils import tracing as ttracing
from torch_parity import assert_frames_match

pytestmark = pytest.mark.stream

P = {
    "jax": SimpleNamespace(
        tf=jtf, io=jio, memory=jmem, rel=jrel, stream=jstream,
        pipeline=jpipeline, metrics=jmetrics, faults=jfaults,
        Schema=JSchema, agg=jagg, tracing=jtracing,
        InputNotFound=JInputNotFound),
    "torch": SimpleNamespace(
        tf=ttf, io=tio, memory=tmem, rel=trel, stream=tstream,
        pipeline=tpipeline, metrics=tmetrics, faults=tfaults,
        Schema=TSchema, agg=tagg, tracing=ttracing,
        InputNotFound=TInputNotFound),
}

# the counters both packages are held to
WATCHED = ("stream.", "retry.stream.", "relational.sketch_folds")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Millisecond backoffs, the static plan in the JAX package, clean
    counters, faults, merge caches and memory singletons in both, and the
    port on the CPU."""
    monkeypatch.setenv("TFT_RETRY_BASE_DELAY", "0.001")
    monkeypatch.setenv("TFT_RETRY_MAX_DELAY", "0.01")
    monkeypatch.setenv("TFT_ADAPTIVE", "0")
    monkeypatch.setenv("TFT_RESULT_CACHE", "0")
    monkeypatch.delenv("TFT_STREAM_FAIL_FAST", raising=False)
    monkeypatch.delenv("TFT_MEM_LIMIT_BYTES", raising=False)
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    for p in P.values():
        p.tracing.disable()
        p.tracing.counters.reset()
        p.faults.reset()
        p.agg._merge_cache.clear()
        p.memory._reset()
    yield
    for p in P.values():
        p.faults.reset()
        p.memory._reset()
    ttf.set_default_device(prev)


def watched(p) -> dict:
    return {k: v for k, v in p.tracing.counters.snapshot().items()
            if k.startswith(WATCHED)}


def both(fn):
    """``fn(p)`` in each package with its counters from zero: ``{pkg:
    (value or exception, watched counters)}``."""
    out = {}
    for name, p in P.items():
        p.tracing.counters.reset()
        try:
            v = fn(p)
        except AssertionError:
            raise  # a check inside the case failed: never compared away
        except Exception as e:  # compared across packages
            v = e
        out[name] = (v, watched(p))
    return out


def same(res, compare=None):
    """Equal watched counters, and equal values (``compare``, or
    ``==``) or the same error type and message; returns the port's
    value."""
    (jv, jc), (tv, tc) = res["jax"], res["torch"]
    assert tc == jc, (tc, jc)
    if isinstance(jv, Exception) or isinstance(tv, Exception):
        assert type(tv).__name__ == type(jv).__name__, (tv, jv)
        assert str(tv) == str(jv)
        return tv
    (compare or _eq)(jv, tv)
    return tv


def _eq(a, b):
    assert a == b, (a, b)


def frames_match(jframes, tframes, rtol=1e-12):
    """Lists of emitted frames: same count, schemas, keys and windows;
    f64 values to ``rtol`` (integer columns exactly)."""
    assert len(tframes) == len(jframes)
    for jf, tf in zip(jframes, tframes):
        assert_frames_match(jf, tf, rtol=rtol)


def _batches(n, rows=4, keys=2, t0=0.0, dt=1.0):
    """n batches of `rows` rows: int64 key cycling [0, keys), double
    value, double event time (one timestamp per batch)."""
    for i in range(n):
        yield {"k": (np.arange(rows) % keys).astype(np.int64),
               "v": np.arange(rows, dtype=np.float64) + i,
               "ts": np.full(rows, t0 + i * dt)}


def _rows(frames):
    return [r for f in frames for r in f.collect()]


def _total(frames, col="v"):
    return sum(float(np.sum(f.blocks()[0].columns[col])) for f in frames)


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

class TestSources:
    def test_generator_infers_schema_and_ends(self):
        def run(p):
            src = p.stream.GeneratorSource(_batches(2))
            names = src.schema.names
            polled = [src.poll() is not None, src.poll() is not None,
                      src.poll() is None]
            return names, polled, src.done()

        assert same(both(run)) == (["k", "v", "ts"], [True] * 3, True)

    def test_schema_drift_is_named(self):
        def run(p):
            def gen():
                yield {"x": np.arange(3.0)}
                yield {"y": np.arange(3.0)}          # renamed column

            src = p.stream.GeneratorSource(gen())
            assert src.poll() is not None
            with pytest.raises(p.stream.SchemaMismatch, match="missing"):
                src.poll()
            return True

        same(both(run))

    def test_dtype_drift_is_named(self):
        def run(p):
            def gen():
                yield {"x": np.arange(3.0)}
                yield {"x": np.arange(3, dtype=np.float32)}

            src = p.stream.GeneratorSource(gen())
            assert src.poll() is not None
            src.poll()

        err = same(both(run))
        assert isinstance(err, tstream.SchemaMismatch)
        assert "float32" in str(err)

    def test_queue_backpressure_and_close(self):
        def run(p):
            src = p.stream.QueueSource(p.Schema.of(x="double"), maxsize=1)
            src.put({"x": np.arange(2.0)})
            with pytest.raises(queue_mod.Full):   # the bound pushes back
                src.put({"x": np.arange(2.0)}, timeout=0.01)
            src.close()
            with pytest.raises(RuntimeError):
                src.put({"x": np.arange(2.0)})
            queued = not src.done()               # one block still queued
            got = src.poll() is not None
            return queued, got, src.done()

        assert same(both(run)) == (True, True, True)

    def test_queue_checks_at_producer(self):
        def run(p):
            src = p.stream.QueueSource(p.Schema.of(x="double"), maxsize=4)
            src.put({"x": np.arange(3, dtype=np.int32)})

        assert isinstance(same(both(run)), tstream.SchemaMismatch)

    def test_parquet_tail_reads_only_new_row_groups(self, tmp_path):
        def run(p):
            path = str(tmp_path / f"t_{p.tf.__name__}.parquet")
            p.io.write_parquet(
                p.tf.frame({"x": np.arange(8.0)}, num_partitions=2), path)
            src = p.stream.ParquetTailSource(path)
            got = [src.poll(), src.poll()]
            sizes = [b.num_rows for b in got]
            idle = src.poll() is None and not src.done()  # follow mode
            # the writer replaces the file with a longer one (the parquet
            # append idiom); only the NEW groups come back
            p.io.write_parquet(
                p.tf.frame({"x": np.arange(16.0)}, num_partitions=4), path)
            b3 = list(src.poll().columns["x"])
            tail = (src.poll().num_rows, src.poll() is None)
            return sizes, idle, b3, tail

        assert same(both(run)) == ([4, 4], True, [8.0, 9.0, 10.0, 11.0],
                                   (4, True))

    def test_read_parquet_row_group_offset(self, tmp_path):
        def run(p):
            path = str(tmp_path / f"o_{p.tf.__name__}.parquet")
            p.io.write_parquet(
                p.tf.frame({"x": np.arange(9.0),
                            "s": np.array(["a"] * 9, object)},
                           num_partitions=3), path)
            part = p.io.read_parquet(path, row_group_offset=1)
            xs = list(np.concatenate([b.columns["x"]
                                      for b in part.blocks()]))
            # past the end: empty but TYPED from the parquet footer
            empty = p.io.read_parquet(path, row_group_offset=17)
            with pytest.raises(ValueError, match="row_group_offset"):
                p.io.read_parquet(path, row_group_offset=-1)
            return (part.num_partitions, xs, empty.count(),
                    empty.schema["x"].dtype.name,
                    empty.schema["s"].dtype.name)

        assert same(both(run)) == (2, list(np.arange(3.0, 9.0)), 0,
                                   "double", "string")


# ---------------------------------------------------------------------------
# finite-source equivalence: bit-identical to the batch path, ordering
# included, in each package; and the two packages' streams agree
# ---------------------------------------------------------------------------

class TestFiniteEquivalence:
    @pytest.fixture
    def pq_files(self, tmp_path):
        rng = np.random.default_rng(7)
        cols = {"x": rng.normal(size=20),
                "k": (np.arange(20) % 4).astype(np.int64)}
        paths = {}
        for name, p in P.items():
            paths[name] = str(tmp_path / f"f_{name}.parquet")
            p.io.write_parquet(p.tf.frame(dict(cols), num_partitions=5),
                               paths[name])
        return paths

    def _check(self, pq_files, stream_chain, batch_chain):
        out = {}
        for name, p in P.items():
            sf = stream_chain(p, p.stream.from_source(
                p.stream.ParquetTailSource(pq_files[name], follow=False)))
            h = sf.start()
            h.run()
            frames = h.collect_updates()
            want = batch_chain(p, p.io.read_parquet(pq_files[name]))
            got_rows = _rows(frames)
            want_rows = want.collect()
            assert len(got_rows) == len(want_rows)
            for g, w in zip(got_rows, want_rows):
                assert g.fields == w.fields
                for a, b in zip(g, w):
                    assert np.asarray(a).dtype == np.asarray(b).dtype
                    np.testing.assert_array_equal(a, b)
            out[name] = frames
        frames_match(out["jax"], out["torch"], rtol=0.0)

    def test_map_blocks(self, pq_files):
        fetch = lambda x: {"y": x * 2.0 + 1.0}  # noqa: E731
        self._check(pq_files, lambda p, sf: sf.map_blocks(fetch),
                    lambda p, df: df.map_blocks(fetch))

    def test_map_blocks_trim(self, pq_files):
        fetch = lambda x: {"y": x - 3.0}  # noqa: E731
        self._check(pq_files, lambda p, sf: sf.map_blocks(fetch, trim=True),
                    lambda p, df: df.map_blocks(fetch, trim=True))

    def test_map_rows(self, pq_files):
        fetch = lambda x: {"y": x * x}  # noqa: E731
        self._check(pq_files, lambda p, sf: sf.map_rows(fetch),
                    lambda p, df: p.tf.map_rows(fetch, df))

    def test_filter_and_select(self, pq_files):
        pred = lambda k: k != 2  # noqa: E731
        self._check(pq_files,
                    lambda p, sf: sf.filter_rows(pred).select(["x"]),
                    lambda p, df: df.filter(pred).select(["x"]))

    def test_chained_ops(self, pq_files):
        def chain_stream(p, sf):
            return (sf.map_blocks(lambda x: {"y": x + 1.0})
                    .filter_rows(lambda k: k != 0)
                    .map_rows(lambda y: {"z": y * y})
                    .select(["k", "z"]))

        def chain_batch(p, df):
            df = df.map_blocks(lambda x: {"y": x + 1.0})
            df = df.filter(lambda k: k != 0)
            df = p.tf.map_rows(lambda y: {"z": y * y}, df)
            return df.select(["k", "z"])

        self._check(pq_files, chain_stream, chain_batch)

    def test_definition_time_validation(self):
        def run(p):
            sf = p.stream.from_source(p.stream.GeneratorSource(_batches(1)))
            with pytest.raises(Exception, match="no matching column"):
                sf.map_blocks(lambda nope: {"y": nope})
            with pytest.raises(KeyError):
                sf.select(["missing"])
            return True

        same(both(run))


# ---------------------------------------------------------------------------
# windows, watermarks, late data
# ---------------------------------------------------------------------------

def _agg(p, gen, window, delay=0.0, **kw):
    return (p.stream.from_source(p.stream.GeneratorSource(gen))
            .group_by("k")
            .aggregate({"v": "sum"}, window=window, time_col="ts",
                       watermark_delay=delay, **kw))


class TestWindowsAndWatermarks:
    def test_tumbling_emits_exactly_at_watermark(self):
        def run(p):
            h = _agg(p, _batches(12), p.stream.tumbling(4.0),
                     delay=1.0).start()
            emitted_at = {}
            n = 0
            while not h.done():
                if h.step():
                    n += 1
                # drain after EVERY step: the finalize flush arrives on
                # the exhausting step, which returns False
                for f in h.collect_updates():
                    s = f.collect()[0]["window_start"]
                    emitted_at[float(s)] = n
            return emitted_at

        # watermark = max_ts - 1; window [0,4) closes when wm >= 4, i.e.
        # after the batch at ts=5 (the 6th batch)
        assert same(both(run)) == {0.0: 6, 4.0: 10, 8.0: 12}

    def test_window_contents_match_batch_aggregate(self):
        def run(p):
            h = _agg(p, _batches(12), p.stream.tumbling(4.0),
                     delay=1.0).start()
            h.run()
            frames = h.collect_updates()
            by_window = {float(f.collect()[0]["window_start"]): f
                         for f in frames}
            all_rows = {"k": [], "v": [], "ts": []}
            for b in _batches(12):
                for c in all_rows:
                    all_rows[c].append(b[c])
            full = p.tf.frame({c: np.concatenate(v)
                               for c, v in all_rows.items()})
            for start in (0.0, 4.0, 8.0):
                wdf = full.filter(
                    lambda ts: (ts >= start) & (ts < start + 4.0))
                want = p.tf.aggregate({"v": "sum"},
                                      wdf.select(["k", "v"]).group_by("k"))
                got = by_window[start]
                np.testing.assert_array_equal(
                    got.blocks()[0].columns["k"],
                    want.blocks()[0].columns["k"])
                np.testing.assert_allclose(
                    got.blocks()[0].columns["v"],
                    want.blocks()[0].columns["v"], rtol=1e-12)
            return frames

        same(both(run), frames_match)

    def test_late_batch_is_dropped_and_counted(self):
        def run(p):
            def gen():
                yield from _batches(8)               # ts 0..7
                # a straggler for the long-closed first window
                yield {"k": np.array([0], np.int64),
                       "v": np.array([100.0]), "ts": np.array([0.5])}

            h = _agg(p, gen(), p.stream.tumbling(2.0), delay=1.0).start()
            h.run()
            frames = h.collect_updates()
            # the late 100.0 must not appear in ANY window
            assert all(r["v"] < 100.0 for r in _rows(frames))
            assert h.metrics()["late_rows"] == 1
            return frames

        same(both(run), frames_match)
        assert ttracing.counters.get("stream.late_rows") == 1

    def test_sliding_rows_land_in_every_overlapping_window(self):
        def run(p):
            def gen():
                yield {"k": np.array([0], np.int64),
                       "v": np.array([1.0]), "ts": np.array([5.0])}
                yield {"k": np.array([0], np.int64),
                       "v": np.array([0.0]), "ts": np.array([30.0])}

            h = _agg(p, gen(), p.stream.sliding(4.0, 2.0)).start()
            h.run()
            return h.collect_updates()

        frames = same(both(run), frames_match)
        out = {float(r["window_start"]): r["v"] for r in _rows(frames)}
        # ts=5 belongs to [4,8) and [2,6); ts=30 to [28,32) and [30,34)
        assert out[4.0] == 1.0 and out[2.0] == 1.0
        assert 0.0 not in out or out[0.0] == 0.0

    def test_update_mode_running_totals(self):
        def run(p):
            src = p.stream.GeneratorSource(_batches(3, rows=2, keys=2))
            h = (p.stream.from_source(src).group_by("k")
                 .aggregate({"v": "sum"}).start())
            h.run()
            return h.collect_updates()

        frames = same(both(run), frames_match)
        # per-batch deltas plus the finalize snapshot; the last frame is
        # the full running total: k=0 gets v[0]=i, k=1 gets v[1]=i+1
        final = {r["k"]: r["v"] for r in frames[-1].collect()}
        assert final == {0: 0.0 + 1 + 2, 1: 1.0 + 2 + 3}

    def test_windowed_needs_time_col_and_update_rejects_cap(self):
        cases = (
            lambda p, g: g.aggregate({"v": "sum"},
                                     window=p.stream.tumbling(4.0)),
            lambda p, g: g.aggregate({"v": "sum"}, max_state_rows=10),
            lambda p, g: g.aggregate({"v": "median"},
                                     window=p.stream.tumbling(4.0),
                                     time_col="ts"))
        for case, match in zip(cases, ("time_col", "max_state_rows",
                                       "Unknown combiner")):
            err = same(both(lambda p: case(p, p.stream.from_source(
                p.stream.GeneratorSource(_batches(1))).group_by("k"))))
            assert isinstance(err, ValueError) and match in str(err)


# ---------------------------------------------------------------------------
# bounded state and a cache-hit steady state (>= 100 batches)
# ---------------------------------------------------------------------------

class TestBoundedStateDemo:
    def test_100_plus_batches_bounded_state_and_no_recompiles(self):
        n_batches, keys = 120, 8

        def run(p):
            agg = (p.stream.from_source(
                       p.stream.GeneratorSource(
                           _batches(n_batches, rows=16, keys=keys)))
                   .map_blocks(lambda v: {"v2": v * 2.0})
                   .select(["k", "v2", "ts"])
                   .group_by("k")
                   .aggregate({"v2": "sum"}, window=p.stream.tumbling(8.0),
                              time_col="ts", watermark_delay=4.0))
            h = agg.start(name="demo")
            peak_rows = peak_bytes = 0
            warmup_mark = None
            processed = 0
            while not h.done():
                if not h.step():
                    continue
                processed += 1
                m = h.metrics()
                peak_rows = max(peak_rows, m["state_rows"])
                peak_bytes = max(peak_bytes, m["state_bytes"])
                if processed == 20:  # steady state reached
                    warmup_mark = p.tracing.counters.get(
                        "stream.merge_compiles")
            assert processed == n_batches
            assert h.metrics()["batches_skipped"] == 0
            # watermark delay 4 keeps at most 3 windows open, `keys`
            # rows each
            assert 0 < peak_rows <= 3 * keys
            assert peak_bytes > 0
            # steady state builds no new merge signature
            assert p.tracing.counters.get("stream.merge_compiles") \
                == warmup_mark
            frames = h.collect_updates()
            want_total = sum(2.0 * (16 * i + np.arange(16.0).sum())
                             for i in range(n_batches))
            assert _total(frames, "v2") == pytest.approx(want_total,
                                                         rel=1e-12)
            assert h.metrics()["windows_emitted"] == n_batches / 8
            return frames

        same(both(run), frames_match)

    def test_max_state_rows_force_evicts_oldest(self):
        def run(p):
            # the watermark never advances enough to emit (huge delay):
            # the cap is the only thing bounding state
            agg = (p.stream.from_source(
                       p.stream.GeneratorSource(
                           _batches(30, rows=8, keys=4)))
                   .group_by("k")
                   .aggregate({"v": "sum"}, window=p.stream.tumbling(2.0),
                              time_col="ts", watermark_delay=1000.0,
                              max_state_rows=12))
            h = agg.start()
            while not h.done():
                if h.step():
                    assert h.metrics()["state_rows"] <= 12
            assert h.metrics()["state_evictions"] > 0
            return h.collect_updates()

        same(both(run), frames_match)
        assert ttracing.counters.get("stream.state_evictions") > 0


class TestWindowStateInGlobalLRU:
    def test_ledger_pressure_spills_window_state(self):
        def run(p):
            p.memory.configure(limit_bytes=1 << 20)
            agg = (p.stream.from_source(
                       p.stream.GeneratorSource(
                           _batches(6, rows=64, keys=32)))
                   .group_by("k")
                   .aggregate({"v": "sum"}, window=p.stream.tumbling(2.0),
                              time_col="ts", watermark_delay=1000.0))
            h = agg.start()
            assert h.step()  # one committed, ledger-registered window
            spills0 = p.tracing.counters.get("stream.state_spills")
            # an admission squeeze from ANYWHERE in the process pushes
            # the coldest resident (the window state) to host
            mgr = p.memory.active()
            tok = mgr.reserve((1 << 20) - 64, op="test.pressure")
            mgr.release(tok)
            assert p.tracing.counters.get("stream.state_spills") > spills0
            assert agg.state_spills > 0
            # the window stayed LIVE: the rest of the stream folds into
            # it (fault-back) and the totals stay exact
            h.run()
            frames = h.collect_updates()
            want = sum(float(np.sum(b["v"]))
                       for b in _batches(6, rows=64, keys=32))
            assert _total(frames) == pytest.approx(want, rel=1e-12)
            return frames

        same(both(run), frames_match)

    def test_no_ledger_registration_when_unlimited(self):
        def run(p):
            p.memory.configure(limit_bytes=0)
            agg = (p.stream.from_source(
                       p.stream.GeneratorSource(_batches(2)))
                   .group_by("k")
                   .aggregate({"v": "sum"}, window=p.stream.tumbling(2.0),
                              time_col="ts", watermark_delay=1000.0))
            h = agg.start()
            h.run()
            return agg.state_spills

        assert same(both(run)) == 0


# ---------------------------------------------------------------------------
# per-batch failure isolation (the `batch` fault site)
# ---------------------------------------------------------------------------

class TestFailureIsolation:
    def test_poisoned_batch_skipped_stream_survives(self):
        def run(p):
            sf = p.stream.from_source(
                p.stream.GeneratorSource(_batches(5))) \
                .map_blocks(lambda v: {"y": v + 1.0})
            h = sf.start(name="poison")
            # arm AFTER batch 0: exactly batch 1 poisons
            assert h.step()
            with p.faults.inject("batch", fail_n=1, transient=False):
                h.run()
            m = h.metrics()
            assert h.done()
            got = _rows(h.collect_updates())
            return (m["batches_skipped"], m["batches"], len(got),
                    sorted({float(r["ts"]) for r in got}))

        assert same(both(run)) == (1, 4, 16, [0.0, 2.0, 3.0, 4.0])

    def test_transient_batch_fault_retries_not_skips(self):
        def run(p):
            h = p.stream.from_source(
                p.stream.GeneratorSource(_batches(3))).start(name="flaky")
            with p.faults.inject("batch", fail_n=1):  # transient
                h.run()
            return h.metrics()["batches_skipped"], h.metrics()["batches"]

        assert same(both(run)) == (0, 3)
        assert ttracing.counters.get("retry.stream.batch.retries") == 1

    def test_transient_fault_never_double_counts_aggregation(self):
        def run(p):
            agg = (p.stream.from_source(
                       p.stream.GeneratorSource(_batches(8, rows=4, keys=2)))
                   .group_by("k")
                   .aggregate({"v": "sum"}, window=p.stream.tumbling(4.0),
                              time_col="ts", watermark_delay=0.0))
            h = agg.start()
            assert h.step()                         # batch 0 clean
            with p.faults.inject("batch", fail_n=1):  # transient: retried
                h.run()
            assert h.metrics()["batches_skipped"] == 0
            frames = h.collect_updates()
            want = sum(4 * i + np.arange(4.0).sum() for i in range(8))
            assert _total(frames) == pytest.approx(want, rel=1e-12)
            return frames

        same(both(run), frames_match)

    def test_failed_ingest_leaves_state_untouched(self, monkeypatch):
        def run(p):
            a = (p.stream.from_source(
                     p.stream.GeneratorSource(_batches(3, rows=4, keys=2)))
                 .group_by("k")
                 .aggregate({"v": "sum"}, window=p.stream.tumbling(100.0),
                            time_col="ts"))
            h = a.start()
            assert h.step()
            before = a.state_rows
            real = p.agg._merge_program

            def poisoned(*args, **kw):
                raise ValueError("deterministic merge poison")

            monkeypatch.setattr(p.agg, "_merge_program", poisoned)
            assert h.step()                         # consumed, but skipped
            skipped = h.metrics()["batches_skipped"]
            unchanged = a.state_rows == before
            monkeypatch.setattr(p.agg, "_merge_program", real)
            assert h.step()                         # continues cleanly
            h.run()
            return skipped, unchanged, h.metrics()["batches"], \
                h.collect_updates()

        def compare(j, t):
            assert j[:3] == t[:3] == (1, True, 2)
            frames_match(j[3], t[3])

        same(both(run), compare)

    def test_corrupt_tail_row_group_cannot_livelock(self, tmp_path,
                                                    monkeypatch):
        def run(p):
            path = str(tmp_path / f"c_{p.tf.__name__}.parquet")
            p.io.write_parquet(
                p.tf.frame({"x": np.arange(8.0)}, num_partitions=2), path)
            src = p.stream.ParquetTailSource(path,
                                             skip_unreadable_after_s=0.0)
            real = p.io._read_parquet_eager

            def corrupt(path_, *a, **kw):
                raise ValueError("corrupt row group data")

            monkeypatch.setattr(p.io, "_read_parquet_eager", corrupt)
            # three failures at the same offset (past the zeroed
            # wall-clock floor), then the source steps past the
            # unreadable group: forward progress, not a spin
            for _ in range(3):
                with pytest.raises(ValueError):
                    src.poll()
            monkeypatch.setattr(p.io, "_read_parquet_eager", real)
            return list(src.poll().columns["x"])    # group 0 was skipped

        assert same(both(run)) == [4.0, 5.0, 6.0, 7.0]

    def test_corrupt_group_does_not_discard_readable_neighbors(
            self, tmp_path, monkeypatch):
        def run(p):
            # groups 0..2; group 1 is corrupt: the single-group reads
            # deliver groups 0 and 2 and skip ONLY group 1
            path = str(tmp_path / f"mid_{p.tf.__name__}.parquet")
            p.io.write_parquet(
                p.tf.frame({"x": np.arange(12.0)}, num_partitions=3), path)
            src = p.stream.ParquetTailSource(path,
                                             skip_unreadable_after_s=0.0)
            real = p.io._read_parquet_eager

            def selective(path_, *a, row_group_offset=0,
                          row_group_limit=None, **kw):
                end = (row_group_offset + row_group_limit
                       if row_group_limit is not None else 3)
                if row_group_offset <= 1 < end:
                    raise ValueError("corrupt row group 1")
                return real(path_, *a, row_group_offset=row_group_offset,
                            row_group_limit=row_group_limit, **kw)

            monkeypatch.setattr(p.io, "_read_parquet_eager", selective)
            got = []
            for _ in range(10):
                try:
                    b = src.poll()
                except ValueError:
                    continue
                if b is not None:
                    got.append(b)
                if len(got) == 2:
                    break
            monkeypatch.setattr(p.io, "_read_parquet_eager", real)
            return [list(b.columns["x"]) for b in got]

        assert same(both(run)) == [list(np.arange(4.0)),
                                   list(np.arange(8.0, 12.0))]

    def test_read_parquet_row_group_limit(self, tmp_path):
        def run(p):
            path = str(tmp_path / f"lim_{p.tf.__name__}.parquet")
            p.io.write_parquet(
                p.tf.frame({"x": np.arange(12.0)}, num_partitions=3), path)
            mid = p.io.read_parquet(path, row_group_offset=1,
                                    row_group_limit=1)
            with pytest.raises(ValueError, match="row_group_limit"):
                p.io.read_parquet(path, row_group_limit=0)
            return mid.num_partitions, list(mid.blocks()[0].columns["x"])

        assert same(both(run)) == (1, [4.0, 5.0, 6.0, 7.0])

    def test_background_pump_records_fail_fast_error(self, monkeypatch):
        monkeypatch.setenv("TFT_STREAM_FAIL_FAST", "1")

        def run(p):
            h = p.stream.from_source(
                p.stream.GeneratorSource(_batches(2))).start(name="ff")
            with p.faults.inject("batch", fail_n=1, transient=False):
                h.start_background(poll_interval=0.005)
                deadline = time.monotonic() + 10
                while h.error is None and time.monotonic() < deadline:
                    time.sleep(0.01)
            h.stop()
            return type(h.error).__name__

        assert same(both(run)) == "InjectedFault"

    def test_fail_fast_env_raises(self, monkeypatch):
        monkeypatch.setenv("TFT_STREAM_FAIL_FAST", "1")

        def run(p):
            h = p.stream.from_source(
                p.stream.GeneratorSource(_batches(2))).start()
            with p.faults.inject("batch", fail_n=1, transient=False):
                h.run()

        assert isinstance(same(both(run)), tfaults.InjectedFault)

    def test_source_schema_drift_skips_and_continues(self):
        def run(p):
            def gen():
                yield {"x": np.arange(3.0)}
                yield {"x": np.arange(3, dtype=np.int32)}   # drift
                yield {"x": np.arange(3.0) + 10}

            h = p.stream.from_source(p.stream.GeneratorSource(gen())).start()
            h.run()
            m = h.metrics()
            return (m["batches"], m["batches_skipped"],
                    [r["x"] for r in _rows(h.collect_updates())])

        assert same(both(run)) == (2, 1, [0.0, 1.0, 2.0, 10.0, 11.0,
                                          12.0])


# ---------------------------------------------------------------------------
# sinks, metrics, the slot pool
# ---------------------------------------------------------------------------

class TestSinksAndMetrics:
    def test_callback_and_collect(self):
        def run(p):
            seen = []
            h = p.stream.from_source(
                p.stream.GeneratorSource(_batches(3))).start(
                    on_update=seen.append)
            h.run()
            return len(seen), len(h.collect_updates()), h.collect_updates()

        assert same(both(run)) == (3, 3, [])

    def test_callback_error_counted_not_fatal(self):
        def run(p):
            def bad(frame):
                raise RuntimeError("sink down")

            h = p.stream.from_source(
                p.stream.GeneratorSource(_batches(3))).start(on_update=bad)
            h.run()
            return h.metrics()["batches"]

        assert same(both(run)) == 3
        assert ttracing.counters.get("stream.sink_errors") == 3

    def test_parquet_sink_appends_and_reads_back(self, tmp_path):
        def run(p):
            path = str(tmp_path / f"out_{p.tf.__name__}.parquet")
            sink = p.stream.ParquetSink(path)
            h = (p.stream.from_source(p.stream.GeneratorSource(_batches(6)))
                 .group_by("k")
                 .aggregate({"v": "sum"}, window=p.stream.tumbling(2.0),
                            time_col="ts")
                 .start(sink=sink))
            h.run()                                  # finalize closes it
            back = p.io.read_parquet(path)
            assert back.schema.names == ["window_start", "k", "v"]
            assert back.count() == 6                 # 3 windows x 2 keys
            assert back.num_partitions == 3          # a row group an emit
            return back

        same(both(run), lambda j, t: assert_frames_match(j, t, rtol=1e-12))

    def test_metrics_text_and_dict(self):
        def run(p):
            h = (p.stream.from_source(p.stream.GeneratorSource(
                     _batches(4, rows=6, keys=3)))
                 .group_by("k")
                 .aggregate({"v": "sum"}, window=p.stream.tumbling(2.0),
                            time_col="ts", watermark_delay=1.0)
                 .start(name="mx"))
            h.run(max_batches=3)
            text = p.metrics.metrics_text()
            assert 'tft_stream_batches_total{stream="mx"} 3' in text
            assert 'tft_stream_state_rows{stream="mx"}' in text
            assert 'tft_stream_watermark{stream="mx"}' in text
            m = h.metrics()
            assert m["state_rows"] > 0 and m["state_bytes"] > 0
            assert m["batch_lag_s"] is not None
            return m["rows"], m["watermark"], m["state_rows"]

        assert same(both(run)) == (18, 1.0, 6)

    def test_stream_leases_serving_slot_pool(self):
        def run(p):
            pool = p.pipeline.SlotPool(2)
            prev = p.pipeline.install_slot_pool(pool)
            try:
                h = p.stream.from_source(
                    p.stream.GeneratorSource(_batches(4))).start()
                h.run()
                batches = h.metrics()["batches"]
            finally:
                p.pipeline.install_slot_pool(prev)
            # every lease was returned: both slots acquirable again
            free = pool.try_acquire() and pool.try_acquire()
            pool.release()
            pool.release()
            return batches, free, pool.leased()

        assert same(both(run)) == (4, True, 0)

    def test_queue_source_end_to_end_background(self):
        def run(p):
            src = p.stream.QueueSource(p.Schema.of(x="double"), maxsize=8)
            h = p.stream.from_source(src) \
                .map_blocks(lambda x: {"y": x + 1.0}) \
                .start(name="bg").start_background(poll_interval=0.005)
            for i in range(5):
                src.put({"x": np.arange(3.0) + i})
            src.close()
            deadline = time.monotonic() + 10
            while not h.done() and time.monotonic() < deadline:
                time.sleep(0.01)
            done = h.done()
            h.stop()
            return done, h.metrics()["batches"], h.collect_updates()

        def compare(j, t):
            assert j[:2] == t[:2] == (True, 5)
            frames_match(j[2], t[2], rtol=0.0)

        same(both(run), compare)


# ---------------------------------------------------------------------------
# the stream join and sketch folds (tests/test_relational.py)
# ---------------------------------------------------------------------------

class TestStreamJoin:
    def test_stream_enrich_equals_batch(self):
        rng = np.random.default_rng(3)
        batches = [{"k": rng.integers(0, 4, 50).astype(np.int64),
                    "x": rng.normal(0, 1, 50)} for _ in range(3)]
        table = {"k": np.array([0, 1, 2], np.int64),
                 "label": np.array(["a", "b", "c"], object),
                 "w": np.array([0.5, 1.5, 2.5])}

        def run(p):
            t = p.tf.frame(dict(table))
            sf = p.stream.from_source(p.stream.GeneratorSource(
                iter([dict(b) for b in batches]))).join(t, on="k")
            h = sf.start()
            h.run()
            got = h.collect_updates()
            expect = [p.rel.broadcast_join(p.tf.frame(dict(b)), t, on="k",
                                           how="left") for b in batches]
            frames_match(expect, got, rtol=0.0)
            return got

        same(both(run), lambda j, t: frames_match(j, t, rtol=0.0))

    def test_definition_time_validation(self):
        def run(p):
            src = p.stream.GeneratorSource(
                iter([{"k": np.array([1], np.int64)}]),
                schema=p.tf.frame({"k": np.array([1], np.int64)}).schema)
            table = p.tf.frame({"j": np.array([1], np.int64)})
            p.stream.from_source(src).join(table, on="k")

        err = same(both(run))
        assert isinstance(err, TInputNotFound)


class TestSketchStream:
    def test_windowed_stream_equals_batch(self):
        rng = np.random.default_rng(21)
        batches = [{"t": np.full(400, float(i)),
                    "k": rng.integers(0, 2, 400).astype(np.int64),
                    "x": rng.lognormal(0, 1, 400),
                    "it": rng.integers(0, 100, 400).astype(np.int64)}
                   for i in range(6)]

        def run(p):
            fetches = {"x": p.rel.approx_quantile(qs=0.5, alpha=0.02),
                       "it": p.rel.approx_distinct(bits=9)}
            sf = p.stream.from_source(p.stream.GeneratorSource(
                iter([dict(b) for b in batches])))
            agg = sf.group_by("k").aggregate(
                fetches, window=p.stream.tumbling(2.0), time_col="t")
            h = agg.start()
            h.run()
            frames = h.collect_updates()
            assert len(frames) == 3
            allc = {k: np.concatenate([b[k] for b in batches])
                    for k in batches[0]}
            for wi, f in enumerate(frames):
                t0 = wi * 2.0
                m = (allc["t"] >= t0) & (allc["t"] < t0 + 2.0)
                bdf = p.tf.frame({"k": allc["k"][m], "x": allc["x"][m],
                                  "it": allc["it"][m]})
                batch = sorted(_rows(p.tf.aggregate(fetches,
                                                    bdf.group_by("k"))))
                got = sorted(tuple(r)[1:] for r in f.collect())
                assert got == batch
            return frames

        same(both(run), lambda j, t: frames_match(j, t, rtol=0.0))

    def test_streaming_topk_host_state(self):
        batches = [{"t": np.full(100, float(i)),
                    "k": np.zeros(100, np.int64),
                    "it": np.where(np.arange(100) < 60, 5,
                                   np.arange(100)).astype(np.int64)}
                   for i in range(4)]

        def run(p):
            sf = p.stream.from_source(p.stream.GeneratorSource(
                iter([dict(b) for b in batches])))
            agg = sf.group_by("k").aggregate(
                {"it": p.rel.approx_top_k(k=4)},
                window=p.stream.tumbling(4.0), time_col="t")
            h = agg.start()
            h.run()
            frames = h.collect_updates()
            assert len(frames) == 1
            # host-merged sketch state costs zero device bytes, and it
            # all emitted at finalize
            assert agg.state_rows == 0
            return frames

        frames = same(both(run), lambda j, t: frames_match(j, t, rtol=0.0))
        row = frames[0].collect()[0]
        assert 5 in list(np.asarray(row[2]))  # far above the n/(k+1) bar


class TestBatchRows:
    """An int ``batch_rows`` coalesces the blocks a source has ready up to
    that many rows, gated by ``TFT_ADAPTIVE`` as in the JAX package;
    ``"adaptive"`` sizes batches through ``plan/adaptive.py``'s
    ``AdaptiveBatcher``."""

    @pytest.mark.parametrize("adaptive", ["1", "0"])
    def test_int_target_coalesces_ready_blocks(self, monkeypatch, adaptive):
        monkeypatch.setenv("TFT_ADAPTIVE", adaptive)

        def run(p):
            h = (p.stream.from_source(p.stream.GeneratorSource(
                     _batches(6, rows=4, keys=2)))
                 .group_by("k")
                 .aggregate({"v": "sum"}, window=p.stream.tumbling(100.0),
                            time_col="ts")
                 .start(batch_rows=8))
            h.run()
            return h.metrics()["batches"], h.collect_updates()

        def compare(j, t):
            assert j[0] == t[0] == (3 if adaptive == "1" else 6)
            frames_match(j[1], t[1])

        same(both(run), compare)

    def test_adaptive_batch_rows_waits_for_the_adaptive_planner(
            self, monkeypatch):
        """``batch_rows="adaptive"`` no longer raises: the first batch is
        one source block, then every batch that finished under
        ``TFT_ADAPTIVE_BATCH_MIN_S`` (injected: all of them) doubles the
        row target, 4 -> 8 -> 16 rows, in both packages."""
        monkeypatch.setenv("TFT_ADAPTIVE", "1")
        monkeypatch.setenv("TFT_ADAPTIVE_BATCH_MIN_S", "1e9")

        def run(p):
            h = (p.stream.from_source(p.stream.GeneratorSource(
                     _batches(6, rows=4, keys=2)))
                 .group_by("k")
                 .aggregate({"v": "sum"}, window=p.stream.tumbling(100.0),
                            time_col="ts")
                 .start(batch_rows="adaptive"))
            h.run()
            return h.metrics()["batches"], h.collect_updates()

        def compare(j, t):
            assert j[0] == t[0] == 3
            frames_match(j[1], t[1])

        same(both(run), compare)


class TestWaitsForLaterLayers:
    def test_history_dir_raises(self, monkeypatch, tmp_path):
        """``TFT_HISTORY_DIR`` on a stream raised while the durable
        history was not ported; now a plain pass-through stream starts,
        runs, and archives nothing (records are per window emit and per
        skipped batch, as in the JAX package)."""
        from tensorframes_tpu_torch.observability import history

        monkeypatch.setenv("TFT_HISTORY_DIR", str(tmp_path))
        history.clear()
        sf = tstream.from_source(tstream.GeneratorSource(_batches(1)))
        h = sf.start()
        h.run()
        assert h.metrics()["batches"] == 1
        assert history.history() == []
        history.clear()

    def test_mesh_fold_raises_and_one_shard_does_not(self):
        """A 2-shard mesh folds each batch on the mesh (one dispatch a
        fold) and equals the 1-shard run; a 1-shard mesh keeps the
        single-device fold."""
        import torch

        from tensorframes_tpu_torch import parallel as tpar

        tcounters = ttracing.counters

        def run(mesh):
            g = tstream.from_source(
                tstream.GeneratorSource(_batches(4))).group_by("k")
            h = g.aggregate({"v": "sum"}, window=tstream.tumbling(2.0),
                            time_col="ts", mesh=mesh).start()
            h.run()
            assert h.metrics()["batches"] == 4
            return _rows(h.collect_updates())

        one = run(SimpleNamespace(num_data_shards=1))
        m0 = tcounters.get("stream.mesh_folds")
        d0 = tcounters.get("mesh.dispatches")
        mesh2 = tpar.DeviceMesh(np.array([torch.device("cpu")] * 2,
                                         dtype=object))
        two = run(mesh2)
        folds = tcounters.get("stream.mesh_folds") - m0
        assert folds == 4
        assert tcounters.get("mesh.dispatches") - d0 == folds
        assert two == one
