"""The port's shuffle (``tensorframes_tpu_torch/parallel/exchange.py``) and
what is built on it, against the JAX package on the same seeded frames.

Mirrors ``tests/test_shuffle.py`` (all but ``test_device_loss_zero_lost_rows``,
``TestPartitionedJoin::test_device_loss_bit_identity`` and
``TestShuffleAggregate::test_device_loss_recovers``, which inject a
``device:1`` loss: the port's elastic layer is ROADMAP A item 7b, and its
slice mirrors them), and of ``tests/test_relational.py`` the mesh cases of
``TestSortMergeJoin`` (not ``test_device_loss_bit_identical``, for the same
reason), ``TestSketchDaggregate`` (not ``test_elastic_recovery``) and the
mesh routing case. Each case runs through both packages: the JAX package
on the conftest's 8 CPU devices, the port on 8 logical CPU shards
(``TFT_CPU_DEVICE_COUNT=8``).

Tolerances: placements, row orders, block boundaries, integers, min/max,
sketch registers and joins exact; f64 sums rtol 1e-12 (the packages' shard
aggregates add in different orders).
"""

import importlib
import os

import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import memory as jmem
from tensorframes_tpu import parallel as jpar
from tensorframes_tpu import relational as jrel
from tensorframes_tpu.engine.ops import InvalidTypeError as JInvalidType
from tensorframes_tpu.observability import flight as jflight
from tensorframes_tpu.parallel import exchange as jex
from tensorframes_tpu.utils.tracing import counters as jcounters
from tensorframes_tpu_torch import memory as tmem
from tensorframes_tpu_torch import parallel as tpar
from tensorframes_tpu_torch import relational as trel
from tensorframes_tpu_torch.engine.ops import InvalidTypeError
from tensorframes_tpu_torch.observability import flight as tflight
from tensorframes_tpu_torch.parallel import exchange as tex
from tensorframes_tpu_torch.utils.tracing import counters as tcounters
from torch_parity import assert_frames_match

F64 = 1e-12
jjoin = importlib.import_module("tensorframes_tpu.relational.join")
tjoin = importlib.import_module("tensorframes_tpu_torch.relational.join")

# (package, parallel, relational, exchange, counters, flight, join module,
#  InvalidTypeError, memory)
J = (jtf, jpar, jrel, jex, jcounters, jflight, jjoin, JInvalidType, jmem)
T = (ttf, tpar, trel, tex, tcounters, tflight, tjoin, InvalidTypeError, tmem)


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
                "torch1": tpar.local_mesh(1)}
    finally:
        ttf.set_default_device(prev)
        if old is None:
            del os.environ["TFT_CPU_DEVICE_COUNT"]
        else:
            os.environ["TFT_CPU_DEVICE_COUNT"] = old


def both(meshes, fn):
    """``fn(pkg, mesh)`` through the JAX package and the port."""
    return fn(J, meshes[J]), fn(T, meshes[T])


def shard_rows(ex, name):
    """Per-shard valid slices of one column of an exchanged frame."""
    S = ex.mesh.num_data_shards
    rp = ex.padded_rows // S
    col = ex.host_read_padded(name)
    valid = ex.per_shard_valid()
    return [col[s * rp: s * rp + int(valid[s])] for s in range(S)]


def assert_same_exchange(jx, tx, names):
    assert tx.padded_rows == jx.padded_rows
    assert tx.num_rows == jx.num_rows
    np.testing.assert_array_equal(tx.per_shard_valid(),
                                  jx.per_shard_valid())
    for n in names:
        for a, b in zip(shard_rows(jx, n), shard_rows(tx, n)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, (n, a.dtype, b.dtype)
            np.testing.assert_array_equal(b, a, err_msg=n)


def frames(pkg, seed=0, nl=400, nr=160, multi=False, vec=False):
    """A probe and a build frame (the JAX test's ``_frames``)."""
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, 60, nl).astype(np.int64)
    rk = rng.integers(0, 60, nr).astype(np.int64)
    lc = {"k": lk, "lv": rng.standard_normal(nl),
          "ltag": np.array([f"L{i}" for i in range(nl)], object)}
    rc = {"k": rk, "rv": rng.standard_normal(nr),
          "rtag": np.array([f"R{i}" for i in range(nr)], object)}
    if multi:
        lc["k2"] = rng.integers(0, 3, nl).astype(np.int64)
        rc["k2"] = rng.integers(0, 3, nr).astype(np.int64)
    if vec:
        rc["rvec"] = rng.standard_normal((nr, 4))
    m = pkg[0]
    return (m.frame(lc, num_partitions=3), m.frame(rc, num_partitions=2))


# ---------------------------------------------------------------------------
# the hash and the placement
# ---------------------------------------------------------------------------

def _key_cases():
    rng = np.random.default_rng(11)
    f = rng.standard_normal(300)
    f[:12] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5, 1.5, 0.0,
              -0.0, np.nan, 2.0]
    i64 = rng.integers(-2 ** 62, 2 ** 62, 300, dtype=np.int64)
    i64[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0]
    i32 = rng.integers(-500, 500, 300).astype(np.int32)
    i32[:2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    return {
        "int64": {"k": i64},
        "int32": {"k": i32},
        "float64": {"k": f},
        "float32": {"k": f.astype(np.float32)},
        "two_keys": {"k": f, "k2": rng.integers(0, 4, 300).astype(np.int64)},
        "string": {"k": np.array([f"key-{i % 37}" for i in range(300)],
                                 object)},
    }


@pytest.mark.parametrize("case", ["int64", "int32", "float64", "float32",
                                  "two_keys", "string"])
def test_placement_matches_the_jax_package(meshes, case):
    cols = _key_cases()[case]
    n = len(cols["k"])
    keys = sorted(cols)
    data = dict(cols, i=np.arange(n, dtype=np.int64),
                tag=np.array([f"row{i}" for i in range(n)], object))

    def fn(pkg, mesh):
        return pkg[3].dexchange(keys, pkg[1].distribute(
            pkg[0].frame(dict(data), num_partitions=3), mesh))

    jx, tx = both(meshes, fn)
    assert_same_exchange(jx, tx, keys + ["i", "tag"])
    if case not in ("float32",):
        # exact key dtypes: the device hash is the host hash
        pred = (tex.exchange_hash_host([cols[k] for k in keys])
                % np.uint64(8)).astype(int)
        for s, got in enumerate(shard_rows(tx, "i")):
            np.testing.assert_array_equal(got, np.flatnonzero(pred == s))


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64,
                                   np.float32, object])
def test_exchange_hash_host_matches_the_jax_package(dtype):
    rng = np.random.default_rng(3)
    if dtype is object:
        a = np.array([f"s{i}" for i in rng.integers(0, 99, 200)], object)
    else:
        a = (rng.standard_normal(200) * 1e6).astype(dtype)
    b = rng.integers(0, 9, 200).astype(np.int64)
    for keys in ([a], [a, b]):
        np.testing.assert_array_equal(tex.exchange_hash_host(keys),
                                      jex.exchange_hash_host(keys))


def test_mesh_estimates_match_the_jax_package(meshes):
    from tensorframes_tpu.memory import estimate as jest
    from tensorframes_tpu_torch.memory import estimate as test_

    cols = {"k": np.arange(20, dtype=np.int64), "x": np.ones((20, 3)),
            "f": np.ones(20, np.float32),
            "s": np.array([f"s{i}" for i in range(20)], object)}
    jd = jpar.distribute(jtf.frame(dict(cols)), meshes[J])
    td = tpar.distribute(ttf.frame(dict(cols)), meshes[T])
    assert test_.dist_frame_estimate(td) == jest.dist_frame_estimate(jd) \
        == (20.0, 24 * (8 + 24 + 4 + 8))
    specs = [((), np.int64), ((3,), np.float64), ((), np.float32)]
    for shards, cap, rowid in ((8, 16, 4), (4, 48, 0)):
        want = jest.exchange_buffer_bytes(specs, shards, cap, rowid)
        assert test_.exchange_buffer_bytes(specs, shards, cap, rowid) == \
            want
        assert test_.exchange_buffer_bytes(
            [((), torch.int64), ((3,), torch.float64),
             ((), torch.float32)], shards, cap, rowid) == want


class TestExchangeInvariants:
    def test_placement_matches_host_hash(self, meshes):
        rng = np.random.default_rng(42)
        keys = rng.integers(-500, 500, 700).astype(np.int64)
        v = rng.standard_normal(700)
        jx, tx = both(meshes, lambda p, m: p[3].dexchange(
            "k", p[1].distribute(p[0].frame({"k": keys, "v": v}), m)))
        assert_same_exchange(jx, tx, ["k", "v"])
        pred = (tex.exchange_hash_host([keys]) % np.uint64(8)).astype(int)
        shards = shard_rows(tx, "k")
        # every row on exactly one shard, and the predicted one
        assert sum(len(s) for s in shards) == 700
        for s, got in enumerate(shards):
            np.testing.assert_array_equal(got, keys[pred == s])
            np.testing.assert_array_equal(shard_rows(tx, "v")[s],
                                          v[pred == s])

    def test_placement_stable_and_colocating(self, meshes):
        # same values, different frames and order: same shard per value
        vals = np.random.default_rng(1).integers(0, 100, 300).astype(
            np.int64)
        m = meshes[T]
        a = tex.dexchange("k", tpar.distribute(ttf.frame({"k": vals}), m))
        b = tex.dexchange("k", tpar.distribute(
            ttf.frame({"k": vals[::-1].copy()}), m))
        for s in range(8):
            assert set(shard_rows(a, "k")[s].tolist()) == \
                set(shard_rows(b, "k")[s].tolist())

    def test_string_keys_and_ride_alongs(self, meshes):
        n = 250
        sk = np.array([f"key-{i % 37}" for i in range(n)], object)
        tag = np.array([f"row{i}" for i in range(n)], object)
        v = np.arange(n, dtype=np.int64)
        jx, tx = both(meshes, lambda p, m: p[3].dexchange(
            "s", p[1].distribute(p[0].frame({"s": sk, "v": v, "tag": tag}),
                                 m)))
        assert_same_exchange(jx, tx, ["s", "v", "tag"])
        got_tags = []
        for s in range(8):
            for si, ti, vi in zip(shard_rows(tx, "s")[s],
                                  shard_rows(tx, "tag")[s],
                                  shard_rows(tx, "v")[s]):
                # the string ride-alongs followed their rows
                assert si == sk[vi] and ti == tag[vi]
            got_tags.extend(shard_rows(tx, "tag")[s])
        assert sorted(got_tags) == sorted(tag.tolist())

    def test_per_shard_original_order(self, meshes):
        keys = np.random.default_rng(2).integers(0, 40, 500).astype(np.int64)
        i = np.arange(500, dtype=np.int64)
        jx, tx = both(meshes, lambda p, m: p[3].dexchange(
            "k", p[1].distribute(p[0].frame({"k": keys, "i": i}), m)))
        assert_same_exchange(jx, tx, ["k", "i"])
        for s in range(8):
            assert np.all(np.diff(shard_rows(tx, "i")[s]) > 0), \
                f"shard {s} not in original row order"

    def test_float_and_multi_key(self, meshes):
        # -0.0 / 0.0 and NaN canonicalize to one destination
        f = np.array([0.0, -0.0, np.nan, np.nan, 1.5, 1.5], np.float64)
        g = np.array([1, 1, 2, 2, 3, 3], np.int64)
        jx, tx = both(meshes, lambda p, m: p[3].dexchange(
            ["f", "g"], p[1].distribute(p[0].frame({"f": f, "g": g}), m)))
        assert_same_exchange(jx, tx, ["f", "g"])
        assert int(tx.per_shard_valid().sum()) == 6
        for s in range(8):
            gs = shard_rows(tx, "g")[s]
            fs = shard_rows(tx, "f")[s]
            if 1 in gs:
                assert (gs == 1).sum() == 2
            if 2 in gs:
                assert np.isnan(fs[gs == 2]).all() and (gs == 2).sum() == 2

    def test_after_dfilter_and_non_tiling_frames(self, meshes):
        # per-shard validity and a trim result that does not tile the
        # data axis (laid out as an even prefix first)
        x = np.arange(50, dtype=np.float64)
        k = (np.arange(50) % 13).astype(np.int64)

        def fn(p, m):
            d = p[1].distribute(p[0].frame({"k": k, "x": x}), m)
            flt = p[1].dfilter(lambda x: x % 3.0 != 0.0, d)
            return (p[3].dexchange("k", flt),
                    p[3].dexchange("s", p[1].dmap_blocks(
                        lambda x: {"s": x[:7] * 2.0}, d.select(["x"]),
                        trim=True, row_aligned=False)))

        (jf, jt), (tf, tt) = both(meshes, fn)
        assert_same_exchange(jf, tf, ["k", "x"])
        assert_same_exchange(jt, tt, ["s"])

    def test_single_shard_noop(self, meshes):
        dist = tpar.distribute(ttf.frame({"k": np.arange(5, dtype=np.int64)}),
                               meshes["torch1"])
        assert tex.dexchange("k", dist) is dist

    def test_key_validation(self, meshes):
        dist = tpar.distribute(ttf.frame({"k": np.arange(8, dtype=np.int64),
                                          "v": np.ones((8, 2))}),
                               meshes[T])
        with pytest.raises(ValueError, match="at least one key"):
            tex.dexchange([], dist)
        with pytest.raises(KeyError, match="nope"):
            tex.dexchange("nope", dist)

    def test_skew_counters_and_explain(self, meshes):
        keys = np.zeros(400, np.int64)  # every row -> one shard

        def fn(p, m):
            p[5].clear()
            ex = p[3].dexchange("k", p[1].distribute(
                p[0].frame({"k": keys}), m))
            snap = p[4].snapshot()
            recs = list(p[5].recent(kind="mesh.exchange_skew"))
            return ex, {k: snap.get(k, 0) for k in (
                "mesh.exchange_dispatches", "mesh.exchange_skew_events",
                "mesh.exchange_rows", "mesh.exchange_bytes",
                "mesh.interstage_host_bytes")}, recs

        (jx, jc, jr), (tx, tc, tr) = both(meshes, fn)
        # the port reads only the S x S count matrix back; the JAX package
        # also reads each shard's received total (4 * S bytes more)
        assert tc.pop("mesh.interstage_host_bytes") == 4 * 8 * 8
        assert jc.pop("mesh.interstage_host_bytes") == 4 * 8 * 8 + 4 * 8
        assert tc == jc
        assert tc["mesh.exchange_dispatches"] == 1
        assert tc["mesh.exchange_skew_events"] == 1
        assert tc["mesh.exchange_rows"] == 400
        assert tr and tr[-1]["rows"] == 400
        assert {k: tr[-1][k] for k in ("op", "ratio", "threshold", "rows",
                                       "per_shard")} == \
            {k: jr[-1][k] for k in ("op", "ratio", "threshold", "rows",
                                    "per_shard")}
        assert tx._exchange == jx._exchange
        text = tx.explain()
        assert "exchange: partition imbalance" in text
        assert "OVER TFT_SKEW_WARN" in text
        line = [ln for ln in text.splitlines() if "exchange:" in ln]
        assert line == [ln for ln in jx.explain().splitlines()
                        if "exchange:" in ln]


# ---------------------------------------------------------------------------
# partitioned hash join against the broadcast join
# ---------------------------------------------------------------------------

def same_result(want, got):
    """Two of the port's frames alike: schema, block boundaries, and each
    column's values in row order (a block's column order aside)."""
    assert got.schema.names == want.schema.names
    wb, gb = want.blocks(), got.blocks()
    assert [b.num_rows for b in gb] == [b.num_rows for b in wb]
    for a, b in zip(wb, gb):
        for n in want.schema.names:
            x, y = np.asarray(a.columns[n]), np.asarray(b.columns[n])
            assert x.dtype == y.dtype, n
            np.testing.assert_array_equal(y, x, err_msg=n)


def _joined(meshes, fn):
    jo, to = both(meshes, fn)
    assert_frames_match(jo, to)
    return jo, to


class TestPartitionedJoin:
    @pytest.mark.parametrize("how", ["inner", "left"])
    @pytest.mark.parametrize("multi", [False, True])
    def test_broadcast_bit_identity(self, meshes, how, multi):
        on = ["k", "k2"] if multi else "k"

        def fn(p, m):
            left, right = frames(p, multi=multi)
            return p[2].partitioned_hash_join(left, right, on, how=how,
                                              mesh=m)

        _, to = _joined(meshes, fn)
        left, right = frames(T, multi=multi)
        same_result(trel.broadcast_join(left, right, on, how=how), to)

    def test_duplicate_build_keys(self, meshes):
        def fn(p, m):
            left, right = frames(p, seed=4, nl=300, nr=300)
            return p[2].partitioned_hash_join(left, right, "k", how="left",
                                              mesh=m)

        _, to = _joined(meshes, fn)
        assert to.count() > 300  # the duplicate keys expanded

    def test_vector_cells_and_indicator(self, meshes):
        def fn(p, m):
            left, right = frames(p, vec=True)
            return p[2].partitioned_hash_join(left, right, "k", how="left",
                                              mesh=m, indicator="_m")

        _, to = _joined(meshes, fn)
        left, right = frames(T, vec=True)
        same_result(trel.broadcast_join(left, right, "k", how="left",
                                        indicator="_m"), to)

    @pytest.mark.parametrize("how", ["inner", "left"])
    def test_string_keys(self, meshes, how):
        rng = np.random.default_rng(5)
        ls = np.array([f"u{i % 23}" for i in range(300)], object)
        rs = np.array([f"u{i % 31}" for i in range(120)], object)
        lv, rv = rng.standard_normal(300), rng.standard_normal(120)

        def fn(p, m, partitioned=True):
            left = p[0].frame({"s": ls, "lv": lv}, num_partitions=2)
            right = p[0].frame({"s": rs, "rv": rv})
            if not partitioned:
                return p[2].broadcast_join(left, right, "s", how=how)
            return p[2].partitioned_hash_join(left, right, "s", how=how,
                                              mesh=m)

        _, to = _joined(meshes, fn)
        same_result(fn(T, None, partitioned=False), to)

    def test_empty_sides_and_filter_to_zero(self, meshes):
        def fn(p, m):
            left, right = frames(p)
            r0 = p[0].frame({"k": np.empty(0, np.int64), "rv": np.empty(0),
                             "rtag": np.empty(0, object)})
            lz = left.filter(lambda k: k < -1)  # keeps nothing
            return (p[2].partitioned_hash_join(left, r0, "k", how="left",
                                               mesh=m),
                    p[2].partitioned_hash_join(lz, right, "k", how="inner",
                                               mesh=m))

        (j1, j2), (t1, t2) = both(meshes, fn)
        assert_frames_match(j1, t1)
        assert_frames_match(j2, t2)
        assert t2.count() == 0
        left, right = frames(T)
        same_result(trel.broadcast_join(
            left, ttf.frame({"k": np.empty(0, np.int64), "rv": np.empty(0),
                             "rtag": np.empty(0, object)}), "k", how="left"),
            t1)

    def test_build_bytes_o_r_over_s(self, meshes):
        def fn(p, m):
            left, right = frames(p, nl=1600, nr=1200)
            out = p[2].partitioned_hash_join(left, right, "k", how="inner",
                                             mesh=m)
            out.collect()
            return out

        jo, to = _joined(meshes, fn)
        info = to._partitioned_info
        assert info == jo._partitioned_info
        assert info["shards"] == 8
        # each shard holds a fraction of the global build, not all of it
        assert info["max_build_bytes"] * 2 < info["global_build_bytes"]
        assert len(info["build_bytes"]) > 1

    def test_counters(self, meshes):
        def fn(p, m):
            left, right = frames(p)
            p[2].partitioned_hash_join(left, right, "k", mesh=m).collect()
            snap = p[4].snapshot()
            return {k: snap.get(k, 0) for k in (
                "relational.partitioned_joins",
                "relational.partitioned_fallbacks",
                "relational.partitioned_probe_rows",
                "mesh.exchange_dispatches")}

        jc, tc = both(meshes, fn)
        assert tc == jc
        assert tc["relational.partitioned_probe_rows"] == 400

    def test_mismatched_key_storage_raises(self, meshes):
        for p in (J, T):
            left = p[0].frame({"k": np.arange(4, dtype=np.int64)})
            right = p[0].frame({"k": np.arange(4, dtype=np.int32),
                                "v": np.arange(4.0)})
            with pytest.raises(p[7], match="cast one side"):
                p[2].partitioned_hash_join(left, right, "k",
                                           mesh=meshes[p])

    def test_kill_switch_falls_back_to_broadcast(self, meshes, monkeypatch):
        monkeypatch.setenv("TFT_SHUFFLE", "0")

        def fn(p, m):
            left, right = frames(p)
            out = p[2].partitioned_hash_join(left, right, "k", how="inner",
                                             mesh=m)
            assert p[4].snapshot().get(
                "relational.partitioned_fallbacks", 0) == 1
            assert out._plan_node.strategy == "broadcast"
            return out

        _joined(meshes, fn)

    def test_one_shard_falls_back_to_broadcast(self, meshes):
        left, right = frames(T)
        out = trel.partitioned_hash_join(left, right, "k",
                                         mesh=meshes["torch1"])
        assert out._plan_node.strategy == "broadcast"
        same_result(trel.broadcast_join(left, right, "k"), out)


# ---------------------------------------------------------------------------
# join() routing and its observability
# ---------------------------------------------------------------------------

class TestJoinRouting:
    def test_oversized_build_routes_partitioned(self, meshes, monkeypatch):
        monkeypatch.setenv("TFT_BROADCAST_LIMIT_BYTES", "1")

        def fn(p, m):
            p[5].clear()
            left, right = frames(p)
            out = p[2].join(left, right, "k", how="inner", mesh=m)
            assert out._plan_node.strategy == "partitioned"
            recs = list(p[5].recent(kind="relational.join_route"))
            return out, recs[-1]

        (jo, jr), (to, tr) = both(meshes, fn)
        assert_frames_match(jo, to)
        assert to._join_route == jo._join_route
        assert to._join_route["strategy"] == "partitioned"
        assert {k: tr[k] for k in to._join_route} == to._join_route
        assert tr["limit"] == 1 and tr["est_build_bytes"] is not None

    def test_oversized_string_keys_route_partitioned(self, meshes,
                                                     monkeypatch):
        monkeypatch.setenv("TFT_BROADCAST_LIMIT_BYTES", "1")
        rng = np.random.default_rng(6)
        ls = np.array([f"u{i % 9}" for i in range(60)], object)
        rs = np.array([f"u{i % 11}" for i in range(40)], object)
        lv, rv = rng.standard_normal(60), rng.standard_normal(40)

        def fn(p, m):
            out = p[2].join(p[0].frame({"s": ls, "lv": lv}),
                            p[0].frame({"s": rs, "rv": rv}), "s", mesh=m)
            assert out._plan_node.strategy == "partitioned"
            return out

        _, to = _joined(meshes, fn)
        same_result(trel.broadcast_join(
            ttf.frame({"s": ls, "lv": lv}), ttf.frame({"s": rs, "rv": rv}),
            "s"), to)

    def test_shuffle_off_restores_old_routing(self, meshes, monkeypatch):
        monkeypatch.setenv("TFT_BROADCAST_LIMIT_BYTES", "1")
        monkeypatch.setenv("TFT_SHUFFLE", "0")
        ls = np.array([f"u{i % 9}" for i in range(30)], object)
        rv = np.random.default_rng(7).standard_normal(10)

        def fn(p, m):
            left, right = frames(p)
            out = p[2].join(left, right, "k", mesh=m)
            assert out._plan_node.strategy == "sort_merge"
            # string keys: broadcast (the behaviour before the shuffle)
            out2 = p[2].join(p[0].frame({"s": ls}),
                             p[0].frame({"s": ls[:10].copy(), "rv": rv}),
                             "s", mesh=m)
            assert out2._plan_node.strategy == "broadcast"
            return out, out2

        (j1, j2), (t1, t2) = both(meshes, fn)
        assert_frames_match(j1, t1)
        assert_frames_match(j2, t2)
        assert t1._join_route == j1._join_route
        assert t2._join_route == j2._join_route

    def test_small_build_stays_broadcast(self, meshes):
        def fn(p, m):
            left, right = frames(p)
            out = p[2].join(left, right, "k", mesh=m)
            assert out._plan_node.strategy == "broadcast"
            return out

        jo, to = _joined(meshes, fn)
        assert to._join_route["reason"] == "build fits"
        assert to._join_route == jo._join_route

    def test_auto_routing_string_keys_stay_broadcast(self, meshes,
                                                     monkeypatch):
        # test_relational.py's mesh routing case: with the shuffle off, the
        # auto route never picks sort-merge for string keys
        monkeypatch.setenv("TFT_BROADCAST_LIMIT_BYTES", "1")
        monkeypatch.setenv("TFT_SHUFFLE", "0")

        def fn(p, m):
            return p[2].join(
                p[0].frame({"k": np.array(["a", "b"], object),
                            "v": np.array([1.0, 2.0])}),
                p[0].frame({"k": np.array(["b"], object),
                            "w": np.array([9.0])}),
                on="k", how="left", mesh=m)

        jo, to = _joined(meshes, fn)
        assert to._join_route == jo._join_route
        assert to._join_route["reason"] == "string keys, shuffle off"

    def test_sort_merge_string_error_names_partitioned(self, meshes):
        for p in (J, T):
            left = p[0].frame({"s": np.array(["a", "b"], object)})
            right = p[0].frame({"s": np.array(["a"], object),
                                "v": np.arange(1.0)})
            with pytest.raises(p[7], match="partitioned"):
                p[2].sort_merge_join(left, right, "s", mesh=meshes[p])

    def test_unknown_strategy_lists_partitioned(self, meshes):
        for p in (J, T):
            left, right = frames(p)
            with pytest.raises(ValueError, match="'partitioned'"):
                p[2].join(left, right, "k", strategy="nope", mesh=meshes[p])

    def test_explain_renders_route(self, meshes, monkeypatch):
        monkeypatch.setenv("TFT_BROADCAST_LIMIT_BYTES", "1")

        def fn(p, m):
            left, right = frames(p)
            out = p[2].join(left, right, "k", mesh=m)
            out.collect()
            text = out.explain()
            return [ln for ln in text.splitlines()
                    if ln.startswith(("  join ", "  shuffle ",
                                      "  exchange "))]

        jl, tl = both(meshes, fn)
        assert tl == jl
        assert any("auto-routed to 'partitioned'" in ln for ln in tl)
        assert any("shuffle  : partitioned build across" in ln for ln in tl)


# ---------------------------------------------------------------------------
# shuffle daggregate
# ---------------------------------------------------------------------------

class TestShuffleAggregate:
    def test_matches_daggregate(self, meshes):
        rng = np.random.default_rng(8)
        n = 900
        cols = {"k": rng.integers(-40, 40, n).astype(np.int64),
                "a": rng.integers(0, 1000, n).astype(np.int64),
                "b": rng.integers(0, 1000, n).astype(np.int64),
                "x": rng.random(n)}
        fetches = {"a": "sum", "b": "min", "x": "sum"}

        def fn(p, m):
            df = p[0].frame(dict(cols), num_partitions=3)
            return (p[1].daggregate(fetches, p[1].distribute(df, m), ["k"]),
                    p[3].shuffle_daggregate(fetches, p[1].distribute(df, m),
                                            ["k"]))

        (jd, js), (td, ts) = both(meshes, fn)
        assert_frames_match(js, ts, rtol=F64)
        assert_frames_match(td, ts, rtol=F64)
        assert tcounters.get("mesh.shuffle_daggregates") == 1

    def test_string_keys_match(self, meshes):
        rng = np.random.default_rng(9)
        n = 400
        g = np.array([f"g{i % 19}" for i in range(n)], object)
        v = rng.integers(0, 100, n).astype(np.int64)

        def fn(p, m):
            df = p[0].frame({"g": g, "v": v})
            return (p[1].daggregate({"v": "max"}, p[1].distribute(df, m),
                                    ["g"]),
                    p[3].shuffle_daggregate({"v": "max"},
                                            p[1].distribute(df, m), ["g"]))

        (jd, js), (td, ts) = both(meshes, fn)
        assert_frames_match(js, ts)
        assert_frames_match(td, ts)

    def test_vector_cells_and_two_keys(self, meshes):
        rng = np.random.default_rng(10)
        n = 600
        cols = {"k1": rng.integers(0, 30, n).astype(np.int32),
                "k2": rng.integers(0, 3, n).astype(np.int64),
                "v": rng.random((n, 3))}

        def fn(p, m):
            return p[3].shuffle_daggregate(
                {"v": "sum"}, p[1].distribute(p[0].frame(dict(cols)), m),
                ["k1", "k2"])

        jo, to = both(meshes, fn)
        assert_frames_match(jo, to, rtol=F64)

    def test_auto_route_threshold(self, meshes, monkeypatch):
        n = 600
        keys = np.arange(n, dtype=np.int64)  # every row its own group
        v = np.random.default_rng(11).integers(0, 9, n).astype(np.int64)
        x = np.random.default_rng(12).random(n)
        monkeypatch.setenv("TFT_SHUFFLE_AGG_GROUPS", "100")

        def fn(p, m):
            df = p[0].frame({"k": keys, "v": v, "x": x})
            return p[1].daggregate({"v": "sum", "x": "sum"},
                                   p[1].distribute(df, m), ["k"])

        jo, to = both(meshes, fn)
        assert tcounters.get("mesh.shuffle_agg_routes") == 1
        assert tcounters.get("mesh.shuffle_daggregates") == 1
        assert_frames_match(jo, to, rtol=F64)
        # the dense route under TFT_SHUFFLE=0, and one shard, agree
        monkeypatch.setenv("TFT_SHUFFLE", "0")
        dense = fn(T, meshes[T])
        assert tcounters.get("mesh.shuffle_agg_routes") == 1
        assert_frames_match(to, dense, rtol=F64)
        monkeypatch.delenv("TFT_SHUFFLE")
        assert_frames_match(to, fn(T, meshes["torch1"]), rtol=F64)
        assert tcounters.get("mesh.shuffle_agg_routes") == 1

    def test_auto_route_off_at_zero_and_on_device_keys(self, meshes,
                                                       monkeypatch):
        keys = np.arange(300, dtype=np.int64)
        df = ttf.frame({"k": keys, "v": np.ones(300)})
        dist = tpar.distribute(df, meshes[T])
        monkeypatch.setenv("TFT_SHUFFLE_AGG_GROUPS", "0")
        tpar.daggregate({"v": "sum"}, dist, "k")
        monkeypatch.setenv("TFT_SHUFFLE_AGG_GROUPS", "10")
        tpar.daggregate({"v": "sum"}, dist, "k", max_groups=512)
        assert tcounters.get("mesh.shuffle_agg_routes") == 0

    def test_kill_switch_delegates(self, meshes, monkeypatch):
        monkeypatch.setenv("TFT_SHUFFLE", "0")
        rng = np.random.default_rng(13)
        keys = rng.integers(0, 10, 100).astype(np.int64)
        v = rng.integers(0, 9, 100).astype(np.int64)

        def fn(p, m):
            df = p[0].frame({"k": keys, "v": v})
            return p[3].shuffle_daggregate({"v": "sum"},
                                           p[1].distribute(df, m), ["k"])

        jo, to = both(meshes, fn)
        assert tcounters.get("mesh.shuffle_daggregates") == 0
        assert_frames_match(jo, to)
        assert tex.shuffle_enabled() is False

    def test_delegations_and_empty_frame(self, meshes):
        from tensorframes_tpu_torch.relational import approx_distinct

        df = ttf.frame({"k": np.arange(16, dtype=np.int64) % 3,
                        "v": np.arange(16.0)})
        dist = tpar.distribute(df, meshes[T])
        for fetches in ({"v": approx_distinct()},
                        lambda v_input: {"v": v_input.sum(0)}):
            assert_frames_match(tpar.daggregate(fetches, dist, "k"),
                                tex.shuffle_daggregate(fetches, dist, "k"))
        one = tpar.distribute(df, meshes["torch1"])
        assert_frames_match(tpar.daggregate({"v": "sum"}, one, "k"),
                            tex.shuffle_daggregate({"v": "sum"}, one, "k"))
        assert tcounters.get("mesh.shuffle_daggregates") == 0
        empty = tpar.dfilter(lambda v: v < 0.0, dist)
        for p in (J, T):
            e = p[1].dfilter(lambda v: v < 0.0, p[1].distribute(
                p[0].frame({"k": np.arange(16, dtype=np.int64) % 3,
                            "v": np.arange(16.0)}), meshes[p]))
            with pytest.raises(ValueError, match="empty distributed"):
                p[3].shuffle_daggregate({"v": "sum"}, e, "k")
        assert empty.count() == 0


# ---------------------------------------------------------------------------
# the mesh sort-merge join and daggregate's sketch route
# (test_relational.py's mesh cases)
# ---------------------------------------------------------------------------

class TestSortMergeJoinMesh:
    def test_mesh_equals_host(self, meshes):
        rng = np.random.default_rng(7)
        lk = rng.integers(0, 20, 64).astype(np.int64)
        rk = rng.integers(0, 20, 40).astype(np.int64)

        def fn(p, m):
            left = p[0].frame({"k": lk, "v": np.arange(64.0),
                               "s": np.array([f"r{i}" for i in range(64)],
                                             object)}, num_partitions=4)
            right = p[0].frame({"k": rk, "w": np.arange(40.0)},
                               num_partitions=2)
            return (p[2].sort_merge_join(left, right, on="k", how="inner",
                                         mesh=m),
                    p[2].sort_merge_join(left, right, on="k", how="inner"))

        (jm, jh), (tm, th) = both(meshes, fn)
        assert_frames_match(jm, tm)
        assert_frames_match(th, tm)
        assert tcounters.get("mesh.dispatches") >= 2  # both sides dsorted

    @pytest.mark.parametrize("how", ["inner", "left"])
    def test_mesh_duplicate_keys_and_indicator(self, meshes, how):
        def fn(p, m):
            left, right = frames(p, seed=3, nl=200, nr=120)
            return p[2].sort_merge_join(left, right, on="k", how=how,
                                        mesh=m, indicator="hit")

        _joined(meshes, fn)

    def test_ledger_routes_external_sort(self, meshes):
        # a side 4x over the budget takes the external sort and still
        # matches the host sort-merge join bit for bit
        n = 4096
        rng = np.random.default_rng(9)
        lk = rng.integers(0, 64, n).astype(np.int64)

        def fn(p, m):
            left = p[0].frame({"k": lk, "v": np.arange(n, dtype=np.int64)},
                              num_partitions=4)
            right = p[0].frame({"k": np.arange(64, dtype=np.int64),
                                "w": np.arange(64, dtype=np.int64)})
            host = p[2].sort_merge_join(left, right, on="k", how="inner")
            host.blocks()
            p[8].configure(limit_bytes=int(n * 16 // 4))
            try:
                out = p[2].sort_merge_join(left, right, on="k",
                                           how="inner", mesh=m)
                out.blocks()
            finally:
                p[8]._reset()
            return out, host

        (jo, jh), (to, th) = both(meshes, fn)
        assert_frames_match(jo, to)
        assert_frames_match(th, to)
        assert tcounters.get("memory.external_sorts") >= 1


class TestSketchDaggregate:
    @staticmethod
    def _data(n, seed=5):
        rng = np.random.default_rng(seed)
        return {"g": rng.integers(0, 3, n).astype(np.int64),
                "x": rng.lognormal(0.0, 1.5, n),
                "it": rng.integers(0, 500, n).astype(np.int64)}

    @pytest.mark.parametrize("n", [1000, 8000])
    def test_bit_identical_to_host_aggregate(self, meshes, n):
        cols = self._data(n)

        def fn(p, m):
            rel = p[2]
            fetches = {"x": rel.approx_quantile(qs=0.5, alpha=0.02),
                       "it": rel.approx_distinct(bits=10)}
            df = p[0].frame(dict(cols), num_partitions=4)
            return (p[1].daggregate(fetches, p[1].distribute(df, m), "g"),
                    p[0].aggregate(fetches, df.group_by("g")))

        (jm, jh), (tm, th) = both(meshes, fn)
        assert_frames_match(jm, tm)
        assert_frames_match(th, tm)
        assert tcounters.get("relational.sketch_folds") >= 2

    def test_mixed_with_scalar_collective(self, meshes):
        cols = self._data(4096)

        def fn(p, m):
            df = p[0].frame(dict(cols), num_partitions=4)
            return p[1].daggregate({"it": p[2].approx_top_k(k=6),
                                    "x": "sum"},
                                   p[1].distribute(df, m), "g")

        jo, to = both(meshes, fn)
        assert to.schema.names == ["g", "it", "it_counts", "x"]
        assert_frames_match(jo, to, rtol=F64)
        for r in to.collect():
            np.testing.assert_allclose(r[3], cols["x"][cols["g"] == r[0]]
                                       .sum(), rtol=F64)

    def test_one_factorization_serves_both_halves(self, meshes,
                                                 monkeypatch):
        from tensorframes_tpu_torch.parallel import distributed as tdist

        calls = []
        real = tdist._host_group_ids
        monkeypatch.setattr(tdist, "_host_group_ids",
                            lambda *a: calls.append(1) or real(*a))
        cols = self._data(2000)
        dist = tpar.distribute(ttf.frame(dict(cols)), meshes[T])
        out = tpar.daggregate({"it": trel.approx_distinct(), "x": "sum"},
                              dist, "g")
        assert len(calls) == 1  # the scalar half's view shares the ids
        again = tpar.daggregate({"x": "max"}, dist.select(["g", "x"]), "g")
        assert len(calls) == 1 and again.count() == out.count() == 3

    def test_max_groups_rejected_with_sketches(self, meshes):
        for p in (J, T):
            dist = p[1].distribute(p[0].frame(
                {"g": np.zeros(64, np.int64),
                 "it": np.arange(64, dtype=np.int64)}), meshes[p])
            with pytest.raises(ValueError, match="max_groups"):
                p[1].daggregate({"it": p[2].approx_distinct()}, dist, "g",
                                max_groups=8)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase shuffle_20M rehearsed at a small size
# ---------------------------------------------------------------------------

def test_phase_shuffle_rehearsal(monkeypatch):
    """``chip_smoke.phase_shuffle`` on one CPU shard and 8 logical ones at
    1% of its size: the shuffle route's threshold and the broadcast limit lowered to
    match, ``torch.cuda.synchronize`` stubbed, a segment_sum launch counted
    for every float segment sum (the CPU runs B1's plain version)."""
    import chip_smoke

    from tensorframes_tpu_torch.engine import ops as engine_ops
    from tensorframes_tpu_torch.ops import segment_reduce

    monkeypatch.delenv("TFT_CPU_DEVICE_COUNT", raising=False)  # 1 shard
    monkeypatch.setenv("TFT_SHUFFLE_AGG_GROUPS", "2000")
    monkeypatch.setenv("TFT_BROADCAST_LIMIT_BYTES", str(100_000))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "emit", lambda obj: None)
    real_sum = engine_ops._segment_sum

    def counted(values, ids, num_segments):
        if values.is_floating_point():
            segment_reduce.launches += 1
        return real_sum(values, ids, num_segments)

    monkeypatch.setattr(engine_ops, "_segment_sum", counted)
    out = chip_smoke.phase_shuffle(
        ttf, np, torch, segment_reduce, n=200_000, keys=1_000,
        groups=20_000, users=10_000, build_rows=40_000, probe_rows=60_000,
        sort_limit=4 << 20, device="cpu")
    assert out["meshes"] == {"local_mesh": 1, "8_shards_of_one_card": 8}
    for b in out["b_external_sort"].values():
        if isinstance(b, dict):
            assert b["memory.external_sort_runs"] == 4
    assert out["c_daggregate"]["local_mesh"]["dense"]["launches"] == 1
    c = out["c_daggregate"]["8_shards_of_one_card"]
    assert c["shuffle"]["mesh.shuffle_daggregates"] == 1
    assert c["shuffle"]["launches"] == 8 and c["dense"]["launches"] == 8
    assert c["shuffle"]["state_bytes_per_shard"] * 4 < \
        c["dense"]["state_bytes_per_shard"]
    assert out["c_daggregate"]["sketch"]["relational.sketch_folds"] == 1
    d = out["d_joins"]
    assert d["routes"]["partitioned"]["strategy"] == "partitioned"
    assert d["routes"]["sort_merge"]["strategy"] == "sort_merge"
    assert d["routes"]["one_shard"]["strategy"] == "sort_merge"
    assert d["launches"] > 0 and d["cut"] is not None
    assert d["build_share_of_one_shard"] < 2 / 8
