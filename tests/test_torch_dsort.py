"""The port's ``dsort`` (columnsort, the one-device program and the
external route) and ``memory.external_sort`` against the JAX package on
the same seeded frames.

Mirrors ``tests/test_parallel.py``'s ``TestDSort``, ``TestColumnsort`` and
the sort of ``TestHostMeshConformance``, and ``tests/test_memory.py``'s
``TestExternalSort``, ``TestExternalDsort`` and ``TestLargerThanBudget``.
Not mirrored: ``TestDSort::test_descending_unsigned_and_int_min``'s uint8
column (the port has no uint8 dtype; its int32/int64 extremes are here),
and ``TestExternalDsort::test_spilled_frame_collects_without_faulting`` and
``::test_dmap_result_copies_through_accessors``, which need mesh frames
registered as spill candidates of the ledger (ROADMAP A item 7b, with the
elastic layer). The JAX package's device-loss cases of the sort are
mirrored with that layer too.

Both packages run on 8-shard meshes (the port on ``TFT_CPU_DEVICE_COUNT=8``
logical CPU shards), the port also on one shard; the external route on 4.
Sort orders are held exactly, bit for bit: the keys include -0.0 and 0.0,
NaN and -NaN, +-inf and the integer extremes, ascending and descending
(XLA's sort, probed on jax 0.9.0's CPU: -0.0 and 0.0 tie and keep row
order, NaNs of either sign sort last and tie).
"""

import logging
import os

import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import memory as jmem
from tensorframes_tpu import parallel as jpar
from tensorframes_tpu.engine.ops import InvalidTypeError as JInvalidType
from tensorframes_tpu.utils.tracing import counters as jcounters
from tensorframes_tpu_torch import memory as tmem
from tensorframes_tpu_torch import parallel as tpar
from tensorframes_tpu_torch.engine.ops import InvalidTypeError
from tensorframes_tpu_torch.parallel import distributed as tdist
from tensorframes_tpu_torch.utils.tracing import counters as tcounters
from torch_parity import assert_frames_match

J = (jtf, jpar, jmem, jcounters, JInvalidType)
T = (ttf, tpar, tmem, tcounters, InvalidTypeError)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("TFT_ADAPTIVE", "0")
    monkeypatch.setenv("TFT_RESULT_CACHE", "0")
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    jcounters.reset()
    tcounters.reset()
    yield
    ttf.set_default_device(prev)
    jmem._reset()
    tmem._reset()


@pytest.fixture(scope="module")
def meshes():
    old = os.environ.get("TFT_CPU_DEVICE_COUNT")
    os.environ["TFT_CPU_DEVICE_COUNT"] = "8"
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    try:
        return {J: jpar.local_mesh(8), T: tpar.local_mesh(8),
                "torch1": tpar.local_mesh(1), "jax4": jpar.local_mesh(4),
                "torch4": tpar.local_mesh(4)}
    finally:
        ttf.set_default_device(prev)
        if old is None:
            del os.environ["TFT_CPU_DEVICE_COUNT"]
        else:
            os.environ["TFT_CPU_DEVICE_COUNT"] = old


def sorted_both(meshes, cols, keys, descending=False, parts=3,
                one_shard=True):
    """``dsort`` of one seeded frame through the JAX package and the port
    (and the port on one shard): the collected frames, held equal."""
    def run(pkg, mesh):
        df = pkg[0].frame(dict(cols), num_partitions=parts)
        out = pkg[1].dsort(keys, pkg[1].distribute(df, mesh),
                           descending=descending)
        assert out.shard_valid is None  # prefix layout
        return out.collect_frame()

    jo, to = run(J, meshes[J]), run(T, meshes[T])
    assert_frames_match(jo, to)
    if one_shard:
        # one shard collects into one block
        t1 = run(T, meshes["torch1"])
        for n in to.schema.names:
            np.testing.assert_array_equal(column(t1, n), column(to, n))
    return to


def column(frame, name):
    return np.concatenate([np.asarray(b.columns[name])
                           for b in frame.blocks()])


def pinned_floats(rng, n, dtype="float64"):
    """Floats holding every value whose order XLA and torch might treat
    differently: signed zeros, NaNs of both signs, infinities, the
    extremes, repeats."""
    fi = np.finfo(dtype)
    x = np.round(rng.standard_normal(n), 1).astype(dtype)
    special = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, fi.max,
               -fi.max, fi.tiny, -0.0, 0.0, np.nan]
    x[rng.choice(n, len(special) * 3, replace=False)] = special * 3
    return x


# ---------------------------------------------------------------------------
# the float and integer order of XLA's sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [37, 600])
def test_float_order_is_xlas(meshes, descending, dtype, n):
    rng = np.random.default_rng(n)
    x = pinned_floats(rng, n, dtype)
    tag = np.arange(n, dtype=np.int64)  # the original position
    out = sorted_both(meshes, {"x": x, "tag": tag}, "x", descending)
    got = column(out, "tag")
    # -0.0 and 0.0 tie, every NaN sorts last (descending too) and ties
    key = np.where(x == 0, 0.0, x).astype(np.float64)
    if descending:
        key = -key
    nan = np.isnan(key)
    want = np.concatenate([np.flatnonzero(~nan)[np.argsort(
        key[~nan], kind="stable")], np.flatnonzero(nan)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", ["int64", "int32"])
def test_integer_extremes(meshes, descending, dtype):
    rng = np.random.default_rng(4)
    info = np.iinfo(dtype)
    v = rng.integers(-50, 50, 300).astype(dtype)
    v[::29] = info.min
    v[5::31] = info.max
    v[7::37] = -1
    out = sorted_both(meshes, {"v": v, "tag": np.arange(300)}, "v",
                      descending)
    key = ~v if descending else v
    np.testing.assert_array_equal(column(out, "tag"),
                                  np.argsort(key, kind="stable"))


def test_lexsort_order_pins_xlas_float_order():
    from tensorframes_tpu_torch.memory.external_sort import lexsort_order

    x = torch.tensor([np.nan, 1.0, -0.0, -np.inf, 0.0, -np.nan, np.inf,
                      -1.0, 0.0, np.nan], dtype=torch.float64)
    assert lexsort_order([x]).tolist() == [3, 7, 2, 4, 8, 1, 6, 0, 5, 9]
    flag = torch.tensor([1, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=torch.int8)
    assert lexsort_order([flag, x]).tolist() == [3, 7, 2, 4, 8, 1, 6, 5,
                                                  9, 0]


# ---------------------------------------------------------------------------
# TestDSort
# ---------------------------------------------------------------------------

class TestDSort:
    def test_matches_host_order_by(self, meshes):
        rng = np.random.default_rng(31)
        x = rng.normal(size=100)
        v = rng.normal(size=(100, 2))
        out = sorted_both(meshes, {"x": x, "v": v}, "x")
        order = np.argsort(x, kind="stable")
        np.testing.assert_array_equal(column(out, "x"), x[order])
        np.testing.assert_array_equal(column(out, "v"), v[order])

    def test_descending_and_multi_key(self, meshes):
        k = np.array([1, 0, 1, 0, 2, 2], np.int64)
        x = np.array([6.0, 5.0, 4.0, 3.0, 2.0, 1.0])
        out = sorted_both(meshes, {"k": k, "x": x}, ["k", "x"])
        assert list(zip(column(out, "k"), column(out, "x"))) == [
            (0, 3.0), (0, 5.0), (1, 4.0), (1, 6.0), (2, 1.0), (2, 2.0)]
        out = sorted_both(meshes, {"k": k, "x": x}, "x", descending=True)
        assert column(out, "x").tolist() == [6.0, 5.0, 4.0, 3.0, 2.0, 1.0]
        out = sorted_both(meshes, {"k": k, "x": x}, ["k", "x"],
                          descending=True)
        assert list(zip(column(out, "k"), column(out, "x"))) == [
            (2, 2.0), (2, 1.0), (1, 6.0), (1, 4.0), (0, 5.0), (0, 3.0)]

    def test_pad_rows_sink_and_normalize_mask_layout(self, meshes):
        x = np.arange(20, dtype=np.float64)

        def run(p, m):
            flt = p[1].dfilter(lambda x: x % 3.0 == 0.0, p[1].distribute(
                p[0].frame({"x": x}), m))
            out = p[1].dsort("x", flt, descending=True)
            assert out.shard_valid is None  # prefix layout restored
            return out.collect_frame()

        jo, to = run(J, meshes[J]), run(T, meshes[T])
        assert_frames_match(jo, to)
        assert column(to, "x").tolist() == [18.0, 15.0, 12.0, 9.0, 6.0,
                                            3.0, 0.0]

    def test_string_rider_follows(self, meshes):
        k = np.array([f"s{i}" for i in range(10)], object)
        x = np.arange(10, dtype=np.float64)[::-1].copy()
        out = sorted_both(meshes, {"k": k, "x": x}, "x")
        assert column(out, "k").tolist() == [f"s{i}"
                                             for i in range(9, -1, -1)]

    def test_key_validation(self, meshes):
        for p in (J, T):
            dist = p[1].distribute(p[0].frame({
                "k": np.array(["a", "b"], object), "x": np.arange(2.0),
                "v": np.ones((2, 2))}), meshes[p])
            with pytest.raises(p[4], match="host-side"):
                p[1].dsort("k", dist)
            with pytest.raises(KeyError, match="nope"):
                p[1].dsort("nope", dist)

    def test_nan_keys_stay_in_valid_prefix(self, meshes):
        # a real row keyed NaN must not move into the pad region (10 rows
        # pad to 16): it sorts last among the REAL rows
        x = np.array([3.0, np.nan, 1.0, 4.0, 0.5, 2.0, 9.0, 8.0, 7.0, 6.0])
        got = column(sorted_both(meshes, {"x": x}, "x"), "x")
        assert len(got) == 10 and np.isnan(got[-1])
        assert got[:-1].tolist() == sorted(v for v in x if not np.isnan(v))

    def test_descending_int_min(self, meshes):
        # raw negation overflows iinfo.min; the bitwise-not transform
        # orders it correctly
        i = np.array([5, np.iinfo(np.int32).min, -1, 3], np.int64)
        out = sorted_both(meshes, {"i": i, "x": np.arange(4.0)}, "i",
                          descending=True)
        assert column(out, "i").tolist() == [5, 3, -1,
                                             np.iinfo(np.int32).min]

    def test_counters_span_and_trace(self, meshes):
        from tensorframes_tpu_torch.observability import query_trace
        from tensorframes_tpu_torch.utils import tracing

        dist = tpar.distribute(ttf.frame({"x": np.arange(64.0)}), meshes[T])
        tracing.enable()
        tracing.timings.reset()
        try:
            with query_trace("dsort") as trace:
                tpar.dsort("x", dist)
            spans = tracing.timings.snapshot()
        finally:
            tracing.disable()
        assert "dsort.columnsort_dispatch" in spans
        assert tcounters.get("mesh.dispatches") == 1
        kinds = [e.etype for e in trace.events]
        assert kinds.count("shard") == 8 and "mesh_dispatch" in kinds
        one = tpar.distribute(ttf.frame({"x": np.arange(64.0)}),
                              meshes["torch1"])
        tracing.enable()
        tracing.timings.reset()
        try:
            tpar.dsort("x", one)
            assert "dsort.dispatch" in tracing.timings.snapshot()
        finally:
            tracing.disable()


# ---------------------------------------------------------------------------
# TestColumnsort
# ---------------------------------------------------------------------------

class TestColumnsort:
    def test_randomized_against_numpy(self, meshes):
        rng = np.random.default_rng(1234)
        for n in (16, 97, 800, 4096):
            x = rng.normal(size=n)
            out = sorted_both(meshes, {"x": x}, "x", one_shard=n < 1000)
            np.testing.assert_array_equal(column(out, "x"), np.sort(x))

    def test_rows_past_the_validity_condition(self, meshes):
        # 8 shards of 200 rows: r >= 2(S-1)^2 = 98, no internal padding
        # beyond the multiple of 2S
        rng = np.random.default_rng(3)
        k = rng.integers(0, 50, 1600)
        tag = np.arange(1600)
        out = sorted_both(meshes, {"k": k, "tag": tag}, "k",
                          descending=True)
        np.testing.assert_array_equal(column(out, "tag"),
                                      np.argsort(~k, kind="stable"))

    def test_randomized_multikey_stability(self, meshes):
        rng = np.random.default_rng(5)
        n = 1000
        k1 = rng.integers(0, 7, n)
        k2 = rng.integers(0, 5, n).astype(np.float64)
        tag = np.arange(n, dtype=np.float64)  # original position
        out = sorted_both(meshes, {"k1": k1, "k2": k2, "tag": tag},
                          ["k1", "k2"])
        np.testing.assert_array_equal(column(out, "tag"),
                                      tag[np.lexsort((tag, k2, k1))])

    def test_randomized_descending_ints(self, meshes):
        rng = np.random.default_rng(6)
        v = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                         700, dtype=np.int64)
        out = sorted_both(meshes, {"v": v, "x": np.zeros(700)}, "v",
                          descending=True)
        assert column(out, "v").tolist() == sorted(v.tolist(), reverse=True)

    def test_after_dfilter_mask_layout(self, meshes):
        x = np.random.default_rng(7).normal(size=500)

        def run(p, m):
            flt = p[1].dfilter(lambda x: x > 0.0, p[1].distribute(
                p[0].frame({"x": x}), m))
            out = p[1].dsort("x", flt, descending=True)
            assert out.shard_valid is None
            return out.collect_frame()

        jo, to = run(J, meshes[J]), run(T, meshes[T])
        assert_frames_match(jo, to)
        np.testing.assert_array_equal(
            column(to, "x"), sorted((v for v in x if v > 0), reverse=True))

    def test_gather_fallback_warns_once(self, meshes, caplog, monkeypatch):
        # a multi-shard frame whose rows do not tile the data axis sorts on
        # one device, which must warn (once)
        monkeypatch.setattr(tdist, "_dsort_gather_warned", False)
        x = np.arange(48.0)

        def summary(p, m):
            return p[1].dmap_blocks(
                lambda x: {"s": -x[:6]}, p[1].distribute(
                    p[0].frame({"x": x}), m), trim=True, row_aligned=False)

        tsum = summary(T, meshes[T])
        assert tsum.padded_rows % 8 != 0
        with caplog.at_level(logging.WARNING):
            out = tpar.dsort("s", tsum).collect_frame()
        jout = jpar.dsort("s", summary(J, meshes[J])).collect_frame()
        assert_frames_match(jout, out)
        assert column(out, "s").tolist() == sorted((-x[:6]).tolist())
        assert len([r for r in caplog.records if "gather" in r.message
                    and r.name == "tensorframes_tpu_torch.dsort"]) == 1
        with caplog.at_level(logging.WARNING):
            out = tpar.dsort("s", tsum, descending=True).collect_frame()
        assert len([r for r in caplog.records if "gather" in r.message
                    and r.name == "tensorframes_tpu_torch.dsort"]) == 1
        assert_frames_match(jpar.dsort("s", summary(J, meshes[J]),
                                       descending=True).collect_frame(), out)

    def test_vector_and_string_riders(self, meshes):
        rng = np.random.default_rng(8)
        n = 300
        x = rng.permutation(n).astype(np.float64)
        v = np.stack([x * 2, x * 3], axis=1)
        s = np.array([f"s{int(i)}" for i in x], object)
        out = sorted_both(meshes, {"x": x, "v": v, "s": s}, "x")
        np.testing.assert_array_equal(column(out, "x"), np.arange(n))
        np.testing.assert_array_equal(column(out, "v"),
                                      np.stack([np.arange(n) * 2.0,
                                                np.arange(n) * 3.0], 1))
        assert column(out, "s").tolist() == [f"s{i}" for i in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_mesh_conformance_filter_and_sort(meshes, seed):
    """``TestHostMeshConformance``'s sort: a dfilter then dsort chain
    against the host filter and order_by, in both packages."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(30, 200))
    cols = {"k": rng.integers(0, int(rng.integers(2, 12)), n)
            .astype(np.int32), "x": rng.normal(size=n),
            "v": rng.normal(size=(n, int(rng.integers(1, 4))))}
    parts = int(rng.integers(1, 5))

    def run(p, m):
        df = p[0].frame(dict(cols), num_partitions=parts)
        host = df.filter(lambda x: x > 0.0).order_by("x")
        mesh = p[1].dsort("x", p[1].dfilter(lambda x: x > 0.0,
                                            p[1].distribute(df, m)))
        return host, mesh.collect_frame()

    (jh, jm), (th, tm) = run(J, meshes[J]), run(T, meshes[T])
    assert_frames_match(jm, tm)
    for n_ in ("k", "x", "v"):
        np.testing.assert_array_equal(column(tm, n_), column(th, n_))


# ---------------------------------------------------------------------------
# memory.external_sort
# ---------------------------------------------------------------------------

class TestExternalSort:
    @staticmethod
    def _cols(n=5000, seed=42):
        rng = np.random.default_rng(seed)
        return {"k": rng.integers(0, 200, n).astype(np.int64),
                "v": rng.random(n)}

    @staticmethod
    def _both(limit, cols, keys, **kw):
        out = []
        for p in (J, T):
            m = p[2].configure(limit_bytes=limit)
            out.append(p[2].external_sort(cols, keys, manager=m, **kw))
            p[2]._reset()
        (jc, jo, js), (tc, to, ts) = out
        assert ts == js
        np.testing.assert_array_equal(to, jo)
        assert sorted(tc) == sorted(jc)
        for n in jc:
            assert tc[n].dtype == jc[n].dtype
            np.testing.assert_array_equal(tc[n], jc[n])
        return tc, to, ts

    @pytest.mark.parametrize("descending", [False, True])
    def test_matches_stable_inmemory_sort(self, descending):
        cols = self._cols()
        out, order, stats = self._both(16 * 1024, cols, ["k"],
                                       descending=descending)
        assert stats["runs"] > 1
        ref = np.argsort(-cols["k"] if descending else cols["k"],
                         kind="stable")
        np.testing.assert_array_equal(order, ref)
        np.testing.assert_array_equal(out["v"], cols["v"][ref])
        assert tcounters.get("memory.external_sorts") == 1
        assert tcounters.get("memory.external_sort_runs") == stats["runs"]

    def test_multi_key_lexicographic(self):
        rng = np.random.default_rng(1)
        n = 4000
        cols = {"a": rng.integers(0, 8, n).astype(np.int64),
                "b": rng.integers(0, 8, n).astype(np.int64),
                "v": rng.random(n)}
        out, order, _ = self._both(16 * 1024, cols, ["a", "b"])
        np.testing.assert_array_equal(order,
                                      np.lexsort((cols["b"], cols["a"])))

    @pytest.mark.parametrize("descending", [False, True])
    def test_nan_and_signed_zero_keys(self, descending):
        rng = np.random.default_rng(2)
        n = 3000
        k = pinned_floats(rng, n)
        cols = {"k": k, "v": np.arange(n, dtype=np.float64)}
        _, order, stats = self._both(8 * 1024, cols, ["k"],
                                     descending=descending)
        assert stats["runs"] > 1
        key = np.where(k == 0, 0.0, -k if descending else k)
        nan = np.isnan(key)
        want = np.concatenate([np.flatnonzero(~nan)[np.argsort(
            key[~nan], kind="stable")], np.flatnonzero(nan)])
        np.testing.assert_array_equal(order, want)

    def test_counts_run_spills_and_spans(self):
        from tensorframes_tpu_torch.utils import tracing

        m = tmem.configure(limit_bytes=16 * 1024)
        tracing.enable()
        tracing.timings.reset()
        try:
            _, _, stats = tmem.external_sort(self._cols(), ["k"], manager=m)
            spans = tracing.timings.snapshot()
        finally:
            tracing.disable()
        assert tcounters.get("memory.spills") >= stats["runs"]
        for name in ("memory.external_sort", "memory.run_sort",
                     "memory.kway_merge"):
            assert name in spans

    def test_empty_input(self):
        _, order, stats = self._both(1024, {"k": np.empty(0, np.int64)},
                                     ["k"])
        assert len(order) == 0 and stats["runs"] == 0


# ---------------------------------------------------------------------------
# the external dsort against the in-memory one
# ---------------------------------------------------------------------------

def external_both(meshes, cols, key, limit, descending=False, parts=4):
    """dsort of one frame on 4 shards: unlimited (columnsort) and under
    ``limit`` (the external route), in both packages, all four equal."""
    out = {}
    for p, mesh in ((J, meshes["jax4"]), (T, meshes["torch4"])):
        df = p[0].frame(dict(cols), num_partitions=parts)
        p[2].configure(limit_bytes=0)
        ref = p[1].dsort(key, p[1].distribute(df, mesh),
                         descending=descending).collect_frame()
        p[2].configure(limit_bytes=limit)
        before = p[3].get("memory.external_sorts")
        got = p[1].dsort(key, p[1].distribute(df, mesh),
                         descending=descending)
        assert got.shard_valid is None
        got = got.collect_frame()
        ext = p[3].get("memory.external_sorts") - before
        p[2]._reset()
        assert_frames_match(ref, got)
        out[p[0]] = (got, ext)
    assert_frames_match(out[jtf][0], out[ttf][0])
    return out[ttf]


class TestExternalDsort:
    @staticmethod
    def _cols(n=8192, seed=42):
        rng = np.random.default_rng(seed)
        return {"k": rng.integers(0, 500, n).astype(np.int64),
                "v": rng.random(n)}

    def test_equals_inmemory_dsort(self, meshes):
        # the frame is 128 KiB of device columns
        _, ext = external_both(meshes, self._cols(), "k", 32 * 1024)
        assert ext == 1  # the external route ran

    def test_descending_equals_inmemory(self, meshes):
        _, ext = external_both(meshes, self._cols(), "v", 32 * 1024,
                               descending=True)
        assert ext == 1

    def test_string_ride_along_permutes(self, meshes):
        rng = np.random.default_rng(3)
        n = 4096
        cols = {"k": rng.integers(0, 97, n).astype(np.int64),
                "s": np.array([f"row{i}" for i in range(n)], object)}
        _, ext = external_both(meshes, cols, "k", 8 * 1024)
        assert ext == 1

    def test_after_dfilter_and_trace(self, meshes):
        from tensorframes_tpu_torch.observability import query_trace

        cols = self._cols()
        df = ttf.frame(dict(cols), num_partitions=4)
        dist = tpar.dfilter(lambda v: v > 0.5,
                            tpar.distribute(df, meshes["torch4"]))
        want = tpar.dsort("k", dist).collect_frame()
        from tensorframes_tpu_torch.utils import tracing

        tmem.configure(limit_bytes=16 * 1024)
        tracing.enable()
        try:
            with query_trace("ext") as trace:
                got = tpar.dsort("k", dist)
        finally:
            tracing.disable()
        assert got.shard_valid is None
        assert_frames_match(want, got.collect_frame())
        ev = [e for e in trace.events if e.etype == "external_sort"]
        assert ev and ev[0].args["runs"] > 1

    def test_under_threshold_keeps_columnsort(self, meshes):
        for p, mesh in ((J, meshes["jax4"]), (T, meshes["torch4"])):
            p[2].configure(limit_bytes=10 ** 9)  # limited, the frame fits
            before = p[3].get("memory.external_sorts")
            df = p[0].frame(self._cols(n=512), num_partitions=4)
            p[1].dsort("k", p[1].distribute(df, mesh)).collect_frame()
            assert p[3].get("memory.external_sorts") == before
            p[2]._reset()

    def test_invalid_key_still_raises(self, meshes):
        for p, mesh in ((J, meshes["jax4"]), (T, meshes["torch4"])):
            p[2].configure(limit_bytes=8 * 1024)
            dist = p[1].distribute(p[0].frame(self._cols(),
                                              num_partitions=4), mesh)
            with pytest.raises(KeyError):
                p[1].dsort("nope", dist)
            p[2]._reset()


class TestLargerThanBudget:
    def test_relational_suite_4x_limit(self, meshes):
        n = 16384  # 2 f64 columns = 256 KiB
        rng = np.random.default_rng(42)
        cols = {"k": rng.integers(0, 100, n).astype(np.float64),
                "v": rng.random(n)}

        def suite(p, mesh):
            df = p[0].frame(dict(cols), num_partitions=8)
            mapped = df.map_blocks(lambda v: {"mv": v * 2.0})
            filtered = mapped.filter(lambda k: k < 50.0)
            map_rows = [tuple(r) for r in filtered.collect()]
            agg = p[0].aggregate({"v": "sum"}, df.group_by("k"))
            agg_rows = [tuple(r) for r in agg.collect()]
            sort = p[1].dsort("k", p[1].distribute(df, mesh)) \
                .collect_frame()
            return map_rows, agg_rows, sort

        for p, mesh in ((J, meshes["jax4"]), (T, meshes["torch4"])):
            p[2].configure(limit_bytes=0)
            ref = suite(p, mesh)
            p[2].configure(limit_bytes=64 * 1024)  # the frame is 4x this
            spills = p[3].get("memory.spills")
            got = suite(p, mesh)
            p[2]._reset()
            assert got[0] == ref[0], "map/filter diverged under the budget"
            assert got[1] == ref[1], "aggregate diverged under the budget"
            assert_frames_match(ref[2], got[2])
            assert p[3].get("memory.spills") > spills, \
                "a 4x-budget run must spill"
            if p is T:
                port = got
            else:
                jax_out = got
        assert_frames_match(jax_out[2], port[2])
