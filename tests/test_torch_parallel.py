"""The port's parallel layer (``tensorframes_tpu_torch/parallel/``) against
the JAX package's on the same seeded frames: the cases of
``tests/test_parallel.py`` that the port has (the ring cases are in
``tests/test_torch_ring.py``;
``TestDSort``, ``TestColumnsort`` and the sort of
``TestHostMeshConformance`` are in ``tests/test_torch_dsort.py``) and
``tests/test_elastic.py``'s ``TestHotKeySalting``, each run through both
packages.

Both run on 8-shard meshes: the JAX package on the conftest's 8 virtual CPU
devices, the port on 8 logical CPU shards (``TFT_CPU_DEVICE_COUNT=8``);
the port's 1-shard mesh runs the same cases where marked. On the CPU the
port's ``daggregate`` takes B1's plain version on every shard.

Tolerances: f64 sums rtol 1e-12 (the shards' partials meet in another
order), f32 sums rtol 1e-5; integer sums, min, max, maps, filters, row
order, group order, schemas and dtypes exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import parallel as jpar
from tensorframes_tpu.utils.tracing import counters as jcounters
from tensorframes_tpu_torch import parallel as tpar
from tensorframes_tpu_torch.engine import ops as tops
from tensorframes_tpu_torch.parallel import distributed as tdist
from tensorframes_tpu_torch.utils.tracing import counters as tcounters

F64 = 1e-12


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    jcounters.reset()
    tcounters.reset()
    yield
    ttf.set_default_device(prev)


@pytest.fixture(scope="module")
def meshes():
    old = os.environ.get("TFT_CPU_DEVICE_COUNT")
    os.environ["TFT_CPU_DEVICE_COUNT"] = "8"
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    try:
        return {"jax": jpar.local_mesh(8), "torch": tpar.local_mesh(8),
                "torch1": tpar.local_mesh(1)}
    finally:
        ttf.set_default_device(prev)
        if old is None:
            del os.environ["TFT_CPU_DEVICE_COUNT"]
        else:
            os.environ["TFT_CPU_DEVICE_COUNT"] = old


def run(meshes, fn, one_shard=False):
    """``fn(m, par, mesh)`` through the JAX package and the port (and, with
    ``one_shard``, the port on a 1-shard mesh): ``[jax, port, ...]``."""
    out = [fn(jtf, jpar, meshes["jax"]), fn(ttf, tpar, meshes["torch"])]
    if one_shard:
        out.append(fn(ttf, tpar, meshes["torch1"]))
    return out


def columns(frame):
    blocks = frame.blocks()
    return {n: np.concatenate([np.asarray(b.columns[n]) for b in blocks])
            for n in frame.schema.names}


def assert_same(want, got, rtol=0.0):
    """Two host frames (or dreduce dicts) alike: names, dtypes, row and
    group order, values exactly or to ``rtol``."""
    if isinstance(want, dict):
        w, g = want, got
    else:
        assert got.schema.names == want.schema.names
        assert [f.dtype.name for f in got.schema] == \
            [f.dtype.name for f in want.schema]
        w, g = columns(want), columns(got)
    assert sorted(w) == sorted(g)
    for n in w:
        a, b = np.asarray(w[n]), np.asarray(g[n])
        assert a.dtype == b.dtype, (n, a.dtype, b.dtype)
        assert a.shape == b.shape, (n, a.shape, b.shape)
        if rtol and a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=rtol, err_msg=n)
        else:
            np.testing.assert_array_equal(b, a, err_msg=n)


def collected(dist):
    return dist.collect_frame()


# ---------------------------------------------------------------------------
# mesh, distribute, dmap_blocks
# ---------------------------------------------------------------------------

def test_local_mesh_shape(meshes):
    for key in ("jax", "torch"):
        assert meshes[key].num_data_shards == 8
        assert meshes[key].num_devices == 8
    assert repr(meshes["torch"]) == repr(meshes["jax"])
    assert meshes["torch1"].num_data_shards == 1
    # without the knob the CPU shows one logical shard
    assert tpar.local_mesh().num_data_shards == 1


@pytest.mark.parametrize("call,match", [
    (lambda par: par.local_mesh(4, shape=(8,)), r"num_devices=4"),
    (lambda par: par.local_mesh(16), r"num_devices=16.*8 visible"),
    (lambda par: par.local_mesh(shape=(3,)), r"3 device\(s\) but 8"),
    (lambda par: par.local_mesh(0), r"num_devices must be >= 1"),
])
def test_local_mesh_validation_matches(call, match, monkeypatch):
    monkeypatch.setenv("TFT_CPU_DEVICE_COUNT", "8")
    for par in (jpar, tpar):
        with pytest.raises(ValueError, match=match):
            call(par)


def test_device_mesh_names_its_axes_and_may_repeat_a_card():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="no 'data' axis"):
        tpar.DeviceMesh(np.array([cpu] * 2, dtype=object), ("x",))
    mesh = tpar.DeviceMesh(np.array([[cpu, cpu]] * 4, dtype=object),
                           ("data", "model"))
    assert mesh.num_data_shards == 4 and mesh.num_devices == 8
    assert mesh.shard_devices() == [cpu] * 4
    dist = tpar.distribute(ttf.frame({"x": np.arange(10.0)}), mesh)
    assert dist.padded_rows == 12
    assert [int(s.shape[0]) for s in dist.columns["x"].shards] == [3] * 4


def test_distribute_and_collect_roundtrip(meshes):
    def fn(m, par, mesh):
        df = m.frame({"x": np.arange(20.0), "k": np.arange(20) % 3},
                     num_partitions=3)
        return par.distribute(df, mesh)

    j, t, t1 = run(meshes, fn, one_shard=True)
    assert (j.num_rows, j.padded_rows) == (t.num_rows, t.padded_rows) \
        == (20, 24)
    assert t1.padded_rows == 20
    assert_same(collected(j), collected(t))
    assert_same(collected(j), collected(t1))
    assert [b.num_rows for b in collected(t).blocks()] == \
        [b.num_rows for b in collected(j).blocks()]


def test_dmap_blocks_elementwise(meshes):
    def fn(m, par, mesh):
        dist = par.distribute(m.frame({"x": np.arange(16.0)}), mesh)
        return par.dmap_blocks(lambda x: {"z": x * 2 + 1}, dist)

    j, t, t1 = run(meshes, fn, one_shard=True)
    assert_same(collected(j), collected(t))
    assert_same(collected(j), collected(t1))
    # the output is sharded like the input: one tensor per shard
    assert len(t.columns["z"].shards) == 8
    assert [int(s.shape[0]) for s in t.columns["z"].shards] == [2] * 8


def test_dmap_trim_and_collision(meshes):
    for m, par, mesh in ((jtf, jpar, meshes["jax"]),
                         (ttf, tpar, meshes["torch"])):
        dist = par.distribute(m.frame({"x": np.arange(8.0)}), mesh)
        out = par.dmap_blocks(lambda x: {"z": x}, dist, trim=True)
        assert out.schema.names == ["z"]
        with pytest.raises(ValueError, match="collides"):
            par.dmap_blocks(lambda x: {"x": x}, dist)
        with pytest.raises(ValueError, match="row_aligned=False only"):
            par.dmap_blocks(lambda x: {"z": x}, dist, row_aligned=False)


def test_dmap_trim_global_result_sees_the_padded_array(meshes):
    """A trim program sees the global padded array and may emit one
    global row (``row_aligned=False``): the k-means variant C pattern."""
    def fn(m, par, mesh):
        dist = par.distribute(m.frame({"x": np.arange(1.0, 12.0)}), mesh)
        n = dist.num_rows
        if m is ttf:
            prog = lambda x: {"s": (x * (torch.arange(  # noqa: E731
                x.shape[0]) < n)).sum()[None], "rows": torch.tensor(
                [x.shape[0]], dtype=torch.int64)}
        else:
            prog = lambda x: {"s": (x * (jnp.arange(  # noqa: E731
                x.shape[0]) < n)).sum()[None], "rows": jnp.array(
                [x.shape[0]], jnp.int64)}
        out = par.dmap_blocks(prog, dist, trim=True, row_aligned=False)
        assert out.num_rows == out.padded_rows == 1
        return out

    j, t = run(meshes, fn)
    assert_same(collected(j), collected(t))
    assert int(collected(t).blocks()[0].columns["rows"][0]) == 16
    assert float(np.asarray(t.columns["s"])[0]) == 66.0
    with pytest.raises(ValueError, match="changed the row count"):
        tpar.dmap_blocks(lambda x: {"z": x[:1]}, tpar.distribute(
            ttf.frame({"x": np.arange(16.0)}), meshes["torch"]))


# ---------------------------------------------------------------------------
# dreduce_blocks
# ---------------------------------------------------------------------------

def test_dreduce_collective_sum_min(meshes):
    # pad rows must be masked to the neutral element: an unmasked zero pad
    # would corrupt min (3.0 -> 0.0)
    vals = np.arange(3.0, 24.0)  # 21 rows, padded to 24
    for cname in ("sum", "min", "max"):
        j, t, t1 = run(meshes, lambda m, par, mesh: par.dreduce_blocks(
            {"x": cname}, par.distribute(m.frame({"x": vals}), mesh)),
            one_shard=True)
        assert_same(j, t, rtol=F64)
        assert_same(j, t1, rtol=F64)
    assert float(t["x"]) == 23.0
    # prod: the JAX package's shard_map refuses its all_gather (its
    # replication cannot be inferred), so the port is held to numpy
    for mesh in (meshes["torch"], meshes["torch1"]):
        t = tpar.dreduce_blocks({"x": "prod"}, tpar.distribute(
            ttf.frame({"x": vals / 8}), mesh))
        np.testing.assert_allclose(t["x"], np.prod(vals / 8), rtol=F64)


def test_dreduce_collective_integer_and_vector_columns(meshes):
    v = np.arange(30.0).reshape(10, 3)
    k = np.arange(10, dtype=np.int32) - 4
    for cname in ("sum", "min", "max"):
        j, t = run(meshes, lambda m, par, mesh: par.dreduce_blocks(
            {"v": cname, "k": cname},
            par.distribute(m.frame({"v": v, "k": k}), mesh)))
        assert_same(j, t)
    np.testing.assert_allclose(t["v"], v.max(axis=0))
    assert t["k"].dtype == np.int32


def test_dreduce_generic_computation(meshes):
    vals = np.arange(1.0, 18.0)

    def fn(m, par, mesh):
        dist = par.distribute(m.frame({"x": vals}), mesh)
        if m is ttf:
            return par.dreduce_blocks(
                lambda x_input: {"x": torch.amax(x_input, 0)}, dist)
        return par.dreduce_blocks(
            lambda x_input: {"x": jnp.max(x_input, axis=0)}, dist)

    j, t, t1 = run(meshes, fn, one_shard=True)
    assert_same(j, t)
    assert_same(j, t1)
    assert float(t["x"]) == 17.0


def test_dreduce_matches_single_host(meshes):
    vals = np.linspace(-5.0, 7.0, 23)

    def fn(m, par, mesh):
        df = m.frame({"x": vals, "v": np.outer(vals, [1.0, -2.0])},
                     num_partitions=4)
        if m is ttf:
            f = lambda x_input, v_input: {  # noqa: E731
                "x": torch.amin(x_input, 0), "v": v_input.sum(0)}
        else:
            f = lambda x_input, v_input: {  # noqa: E731
                "x": jnp.min(x_input, axis=0), "v": v_input.sum(0)}
        single = m.reduce_blocks(f, m.analyze(df))
        multi = par.dreduce_blocks(f, par.distribute(m.analyze(df), mesh))
        return single, multi

    (js, jm), (ts, tm) = run(meshes, fn)
    assert_same(jm, tm, rtol=F64)
    # reduce_blocks of two fetches returns them in name order
    np.testing.assert_allclose(tm["v"], ts[0], rtol=F64)
    np.testing.assert_allclose(tm["x"], ts[1], rtol=F64)


def test_dreduce_empty_raises(meshes):
    for m, par, mesh in ((jtf, jpar, meshes["jax"]),
                         (ttf, tpar, meshes["torch"])):
        dist = par.distribute(m.frame({"x": np.empty(0)}), mesh)
        with pytest.raises(ValueError, match="empty"):
            par.dreduce_blocks({"x": "sum"}, dist)
        with pytest.raises(KeyError, match="Unknown combiner"):
            par.dreduce_blocks({"x": "mean"}, par.distribute(
                m.frame({"x": np.ones(3)}), mesh))


# ---------------------------------------------------------------------------
# daggregate
# ---------------------------------------------------------------------------

def test_daggregate_matches_host_aggregate(meshes):
    rng = np.random.default_rng(11)
    n, g = 10_000, 1_000
    keys = rng.integers(0, g, n)
    vals = rng.normal(size=n)

    def fn(m, par, mesh):
        df = m.frame({"key": keys, "x": vals}, num_partitions=4)
        return (m.aggregate({"x": "sum"}, df.group_by("key")),
                par.daggregate({"x": "sum"}, par.distribute(df, mesh),
                               "key"))

    (jh, jm), (th, tm), (_, tm1) = run(meshes, fn, one_shard=True)
    assert_same(jm, tm, rtol=F64)
    assert_same(jm, tm1, rtol=F64)
    assert_same(th, tm, rtol=F64)
    assert list(columns(tm)["key"]) == sorted(set(keys.tolist()))


def test_daggregate_launches_b1_on_every_shard(meshes, monkeypatch):
    """A float sum column calls B1 once on every shard (the plain version
    on the CPU; the kernel on a card); min/max go through the segment
    scatter."""
    calls = []
    real = tops._segment_sum

    def counting(values, ids, num_segments):
        calls.append((values.shape[0], num_segments))
        return real(values, ids, num_segments)

    monkeypatch.setattr(tops, "_segment_sum", counting)
    rng = np.random.default_rng(3)
    df = ttf.frame({"k": rng.integers(0, 50, 1000),
                    "x": rng.normal(size=1000),
                    "y": rng.normal(size=(1000, 2))})
    for mesh, shards in ((meshes["torch"], 8), (meshes["torch1"], 1)):
        dist = tpar.distribute(df, mesh)
        calls.clear()
        tpar.daggregate({"x": "sum", "y": "sum"}, dist, "k")
        assert calls == [(1000 // shards, 50)] * (2 * shards)
        calls.clear()
        tpar.daggregate({"x": "sum"}, dist, "k", max_groups=64)
        assert calls == [(1000 // shards, 65)] * shards
        calls.clear()
        tpar.daggregate({"x": "max"}, dist, "k")
        assert calls == []


def test_daggregate_min_max_prod_vector_multi_key(meshes):
    rng = np.random.default_rng(12)
    k1 = rng.integers(0, 4, 50)
    k2 = rng.integers(0, 3, 50)
    v = rng.normal(size=(50, 2))
    for cname in ("max", "min"):
        j, t, t1 = run(meshes, lambda m, par, mesh: par.daggregate(
            {"v": cname}, par.distribute(
                m.frame({"k1": k1, "k2": k2, "v": v}), mesh), ["k1", "k2"]),
            one_shard=True)
        assert_same(j, t, rtol=F64)
        assert_same(j, t1, rtol=F64)
    # prod against the port's host aggregate (the JAX package's shard_map
    # refuses prod's all_gather)
    df = ttf.frame({"k1": k1, "k2": k2, "v": v})
    t = tpar.daggregate({"v": "prod"}, tpar.distribute(df, meshes["torch"]),
                        ["k1", "k2"])
    assert_same(ttf.aggregate({"v": "prod"}, df.group_by("k1", "k2")), t,
                rtol=F64)
    for r in t.collect():
        sel = (k1 == r["k1"]) & (k2 == r["k2"])
        np.testing.assert_allclose(r["v"], v[sel].prod(axis=0), rtol=1e-9)


def test_daggregate_pad_rows_excluded(meshes):
    # 10 rows pad to 16 on an 8-shard mesh; pad rows must not contribute
    def fn(m, par, mesh):
        dist = par.distribute(m.frame({"key": np.zeros(10, np.int64),
                                       "x": np.ones(10)}), mesh)
        return [par.daggregate({"x": c}, dist, "key", max_groups=g)
                for c in ("sum", "min") for g in (None, 4)]

    j, t = run(meshes, fn)
    for a, b in zip(j, t):
        assert_same(a, b)
        assert len(b.collect()) == 1
    assert t[0].collect()[0]["x"] == 10.0


def test_daggregate_unused_value_column_ignored(meshes):
    def fn(m, par, mesh):
        df = m.frame({"key": np.zeros(4, np.int64), "x": np.arange(4.0),
                      "extra": np.arange(4.0)})
        return par.daggregate({"x": "sum"}, par.distribute(df, mesh), "key")

    j, t = run(meshes, fn)
    assert_same(j, t)
    assert "extra" not in t.schema.names


def test_daggregate_integer_values_exact(meshes):
    rng = np.random.default_rng(14)
    k = rng.integers(-3, 9, 700)
    a = rng.integers(-1000, 1000, 700)
    b = rng.integers(-9, 9, 700).astype(np.int32)
    for max_groups in (None, 16):
        j, t, t1 = run(meshes, lambda m, par, mesh: par.daggregate(
            {"a": "sum", "b": "max"}, par.distribute(
                m.frame({"k": k, "a": a, "b": b}), mesh), "k",
            max_groups=max_groups), one_shard=True)
        assert_same(j, t)
        assert_same(j, t1)


def _norm(m):
    if m is ttf:
        return lambda x_input: {"x": torch.sqrt((x_input ** 2).sum(0))}
    return lambda x_input: {"x": jnp.sqrt((x_input ** 2).sum(0))}


def test_daggregate_generic_computation_matches_host(meshes):
    rng = np.random.default_rng(21)
    n = 500
    key = rng.integers(0, 13, n).astype(np.int64)
    v = rng.normal(size=n)
    w = rng.normal(size=(n, 3))

    def fn(m, par, mesh):
        df = m.analyze(m.frame({"k": key, "v": v, "w": w},
                               num_partitions=4))
        sq = torch.sqrt if m is ttf else jnp.sqrt

        def fetch(v_input, w_input):
            return {"v": sq((v_input ** 2).sum(0)),
                    "w": sq((w_input ** 2).sum(0))}

        return (m.aggregate(fetch, df.group_by("k")),
                par.daggregate(fetch, par.distribute(df, mesh), "k"))

    (jh, jm), (th, tm), (_, tm1) = run(meshes, fn, one_shard=True)
    assert_same(jm, tm, rtol=F64)
    assert_same(jm, tm1, rtol=F64)
    assert_same(th, tm, rtol=F64)


def test_daggregate_generic_single_row_groups(meshes):
    # single-row groups still see one application of the computation:
    # sqrt(x^2) = |x| tells "raw row passed through" from "applied"
    def fn(m, par, mesh):
        df = m.frame({"k": np.arange(10, dtype=np.int64),
                      "x": np.linspace(-5, 4, 10)})
        return par.daggregate(_norm(m), par.distribute(df, mesh), "k")

    j, t, t1 = run(meshes, fn, one_shard=True)
    assert_same(j, t, rtol=F64)
    assert_same(j, t1, rtol=F64)
    assert columns(t)["x"][0] == pytest.approx(5.0)


def test_daggregate_generic_multi_key_pad_rows(meshes):
    rng = np.random.default_rng(22)
    n = 30                                   # pads to 32 on 8 shards
    k1 = rng.integers(0, 3, n).astype(np.int64)
    k2 = rng.integers(0, 2, n).astype(np.int64)
    x = rng.normal(size=n)

    def fn(m, par, mesh):
        dist = par.distribute(m.frame({"k1": k1, "k2": k2, "x": x}), mesh)
        return dist.padded_rows, par.daggregate(_norm(m), dist,
                                                ["k1", "k2"])

    (jp, j), (tp, t) = run(meshes, fn)
    assert jp == tp == 32
    assert_same(j, t, rtol=F64)


def test_daggregate_device_keys_matches_host_path(meshes):
    rng = np.random.default_rng(31)
    n = 400
    key = rng.integers(0, 37, n).astype(np.int64)
    x = rng.normal(size=n)
    v = rng.normal(size=(n, 2))

    def fn(m, par, mesh):
        dist = par.distribute(m.frame({"k": key, "x": x, "v": v}), mesh)
        return (par.daggregate({"x": "sum", "v": "max"}, dist, "k"),
                par.daggregate({"x": "sum", "v": "max"}, dist, "k",
                               max_groups=64))

    (jh, jd), (th, td), (_, td1) = run(meshes, fn, one_shard=True)
    assert_same(jd, td, rtol=F64)
    assert_same(jd, td1, rtol=F64)
    assert_same(th, td, rtol=F64)


def test_daggregate_device_keys_cap_overflow_raises(meshes):
    for m, par, mesh in ((jtf, jpar, meshes["jax"]),
                         (ttf, tpar, meshes["torch"]),
                         (ttf, tpar, meshes["torch1"])):
        df = m.frame({"k": np.arange(20, dtype=np.int64), "x": np.ones(20)})
        dist = par.distribute(df, mesh)
        for fetch in ({"x": "sum"}, {"x": "min"}, _norm(m)):
            with pytest.raises(ValueError, match="max_groups=10"):
                par.daggregate(fetch, dist, "k", max_groups=10)


def test_daggregate_device_keys_pad_rows_excluded(meshes):
    def fn(m, par, mesh):
        df = m.frame({"k": np.zeros(10, np.int64), "x": np.ones(10)})
        return par.daggregate({"x": "sum"}, par.distribute(df, mesh), "k",
                              max_groups=4)

    j, t = run(meshes, fn)
    assert_same(j, t)
    assert t.collect()[0]["k"] == 0 and t.collect()[0]["x"] == 10.0


def test_daggregate_generic_device_keys(meshes):
    rng = np.random.default_rng(41)
    n = 300
    key = rng.integers(0, 19, n).astype(np.int32)
    x = rng.normal(size=n)

    def fn(m, par, mesh):
        dist = par.distribute(m.frame({"k": key, "x": x}), mesh)
        return (par.daggregate(_norm(m), dist, "k"),
                par.daggregate(_norm(m), dist, "k", max_groups=32))

    (jh, jd), (th, td) = run(meshes, fn)
    assert_same(jd, td, rtol=F64)
    assert_same(th, td, rtol=F64)


def test_daggregate_device_keys_long_keys_are_exact(meshes):
    # the JAX package's tests run with x64 on, where int64 keys are never
    # narrowed on the device; the port is always 64-bit (ROADMAP.md §C)
    def fn(m, par, mesh):
        df = m.frame({"k": np.array([1, 1 + 2**32] * 8, np.int64),
                      "x": np.ones(16)})
        return par.daggregate({"x": "sum"}, par.distribute(df, mesh), "k",
                              max_groups=4)

    j, t = run(meshes, fn)
    assert_same(j, t)
    assert len(t.collect()) == 2


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_daggregate_device_keys_sentinel_key_raises(meshes, dtype):
    big = np.iinfo(dtype).max
    for m, par, mesh in ((jtf, jpar, meshes["jax"]),
                         (ttf, tpar, meshes["torch"])):
        df = m.frame({"k": np.array([1, big, 2], dtype), "x": np.ones(3)})
        dist = par.distribute(df, mesh)
        with pytest.raises(ValueError, match="pad sentinel"):
            par.daggregate({"x": "sum"}, dist, "k", max_groups=4)
        # the host path takes such keys
        rows = par.daggregate({"x": "sum"}, dist, "k").collect()
        assert [r["k"] for r in rows] == [1, 2, big]


def test_daggregate_device_keys_reject_float_keys(meshes):
    for m, par, mesh in ((jtf, jpar, meshes["jax"]),
                         (ttf, tpar, meshes["torch"])):
        dist = par.distribute(m.frame({"k": np.arange(4.0),
                                       "x": np.ones(4)}), mesh)
        with pytest.raises(ValueError, match="needs an integer key column"):
            par.daggregate({"x": "sum"}, dist, "k", max_groups=8)


def test_distribute_string_key_column_rides_host_side(meshes):
    def fn(m, par, mesh):
        df = m.frame([(str(i % 3), float(i)) for i in range(10)],
                     columns=["key", "x"])
        dist = par.distribute(df, mesh)
        out = par.daggregate({"x": "sum"}, dist, "key")
        back = par.dmap_blocks(lambda x: {"z": x + 1.0},
                               dist).collect_frame()
        return out, back

    (jo, jb), (to, tb) = run(meshes, fn)
    assert_same(jo, to)
    assert_same(jb, tb)
    assert {r["key"]: r["x"] for r in to.collect()} == \
        {"0": 18.0, "1": 12.0, "2": 15.0}


def test_daggregate_key_factorization_cached(meshes, monkeypatch):
    # repeated aggregations over the same keys on the same frame do not
    # re-run the host factorization (or the device sort-unique)
    rng = np.random.default_rng(13)
    keys = rng.integers(0, 20, 200)
    vals = rng.normal(size=200)
    dist = tpar.distribute(ttf.frame({"key": keys, "x": vals}),
                           meshes["torch"])
    calls = {"host": 0, "device": 0}
    orig_host, orig_dev = tdist._host_group_ids, tdist._device_key_ids

    def count_host(*a, **k):
        calls["host"] += 1
        return orig_host(*a, **k)

    def count_dev(*a, **k):
        calls["device"] += 1
        return orig_dev(*a, **k)

    monkeypatch.setattr(tdist, "_host_group_ids", count_host)
    monkeypatch.setattr(tdist, "_device_key_ids", count_dev)
    first = tpar.daggregate({"x": "sum"}, dist, "key")
    again = tpar.daggregate({"x": "min"}, dist, "key")
    gen = tpar.daggregate(lambda x_input: {"x": x_input.sum(0)}, dist,
                          "key")
    assert calls["host"] == 1
    dev1 = tpar.daggregate({"x": "sum"}, dist, "key", max_groups=32)
    tpar.daggregate({"x": "max"}, dist, "key", max_groups=32)
    assert calls["device"] == 1
    tpar.daggregate({"x": "sum"}, dist, "key", max_groups=64)
    assert calls["device"] == 2
    jdist = jpar.distribute(jtf.frame({"key": keys, "x": vals}),
                            meshes["jax"])
    assert_same(jpar.daggregate({"x": "sum"}, jdist, "key"), first, F64)
    assert_same(jpar.daggregate({"x": "min"}, jdist, "key"), again)
    assert_same(jpar.daggregate({"x": "sum"}, jdist, "key"), dev1, F64)
    assert_same(jpar.daggregate(lambda x_input: {"x": x_input.sum(0)},
                                jdist, "key"), gen, F64)


def test_group_ids_cache_lru_capped(meshes):
    k = np.arange(64, dtype=np.int32) % 4
    dist = tpar.distribute(ttf.frame({"k": k, "x": np.ones(64)}),
                           meshes["torch"])
    cap = tdist._GROUP_IDS_CACHE_CAP
    from tensorframes_tpu.parallel.distributed import _GROUP_IDS_CACHE_CAP
    assert cap == _GROUP_IDS_CACHE_CAP
    for groups in range(4, 4 + cap + 4):
        tdist._cached_group_ids(dist, ["k"], groups)
    assert len(dist._group_ids_cache) == cap
    newest = ("device", ("k",), 4 + cap + 3)
    assert newest in dist._group_ids_cache


def test_daggregate_empty_keys_and_frame_rejected(meshes):
    for m, par, mesh in ((jtf, jpar, meshes["jax"]),
                         (ttf, tpar, meshes["torch"])):
        dist = par.distribute(m.frame({"x": np.ones(8)}), mesh)
        with pytest.raises(ValueError, match="at least one key"):
            par.daggregate({"x": "sum"}, dist, [])
        with pytest.raises(ValueError, match="at least one key"):
            par.daggregate({"x": "sum"}, dist, [], max_groups=4)
        with pytest.raises(KeyError, match="No key column"):
            par.daggregate({"x": "sum"}, dist, "nope")
        empty = par.distribute(m.frame({"k": np.empty(0, np.int64),
                                        "x": np.empty(0)}), mesh)
        with pytest.raises(ValueError, match="empty distributed frame"):
            par.daggregate({"x": "sum"}, empty, "k")


def test_shards_without_rows(meshes):
    """3 rows on 8 shards: five shards hold only pad rows; every op agrees
    with the JAX package."""
    def fn(m, par, mesh):
        df = m.frame({"k": np.array([5, -2, 5]), "x": np.array([1.5, 2.0,
                                                                -4.0])})
        dist = par.distribute(df, mesh)
        flt = par.dfilter(lambda x: x > 0.0, dist)
        return (collected(flt), par.dreduce_blocks({"x": "min"}, dist),
                par.daggregate({"x": "sum"}, dist, "k"),
                par.daggregate({"x": "max"}, dist, "k", max_groups=2),
                par.daggregate(_norm(m), flt, "k"))

    j, t = run(meshes, fn)
    for a, b in zip(j, t):
        assert_same(a, b, rtol=F64)


# ---------------------------------------------------------------------------
# multi-key device ids
# ---------------------------------------------------------------------------

class TestDeviceKeysMultiKey:
    def test_two_key_monoid_matches_host_path(self, meshes):
        rng = np.random.default_rng(41)
        n = 3000
        k1 = rng.integers(-5, 5, n).astype(np.int32)   # negatives too
        k2 = rng.integers(0, 7, n).astype(np.int32)
        x = rng.normal(size=n)

        def fn(m, par, mesh):
            dist = par.distribute(m.frame({"k1": k1, "k2": k2, "x": x}),
                                  mesh)
            return (par.daggregate({"x": "sum"}, dist, ["k1", "k2"]),
                    par.daggregate({"x": "sum"}, dist, ["k1", "k2"],
                                   max_groups=128))

        (jh, jd), (th, td), (_, td1) = run(meshes, fn, one_shard=True)
        assert_same(jd, td, rtol=F64)
        assert_same(jd, td1, rtol=F64)
        assert_same(th, td, rtol=F64)
        assert len(td.collect()) == len({(a, b) for a, b in zip(k1, k2)})

    def test_two_key_generic_matches_host_path(self, meshes):
        rng = np.random.default_rng(42)
        n = 500
        k1 = rng.integers(0, 4, n).astype(np.int32)
        k2 = rng.integers(0, 3, n).astype(np.int32)
        v = rng.normal(size=(n, 2))

        def fn(m, par, mesh):
            sq = torch.sqrt if m is ttf else jnp.sqrt
            f = lambda v_input: {"v": sq((v_input ** 2).sum(0))}  # noqa
            dist = par.distribute(m.frame({"k1": k1, "k2": k2, "v": v}),
                                  mesh)
            return (par.daggregate(f, dist, ["k1", "k2"]),
                    par.daggregate(f, dist, ["k1", "k2"], max_groups=32))

        (jh, jd), (th, td) = run(meshes, fn)
        assert_same(jd, td, rtol=F64)
        assert_same(th, td, rtol=F64)

    def test_three_keys(self, meshes):
        rng = np.random.default_rng(43)
        n = 200
        cols = {f"k{i}": rng.integers(0, 3, n).astype(np.int32)
                for i in range(3)}
        cols["x"] = rng.normal(size=n)
        j, t = run(meshes, lambda m, par, mesh: par.daggregate(
            {"x": "max"}, par.distribute(m.frame(cols), mesh),
            ["k0", "k1", "k2"], max_groups=27))
        assert_same(j, t)

    def test_cap_overflow_errors(self, meshes):
        n = 100
        for m, par, mesh in ((jtf, jpar, meshes["jax"]),
                             (ttf, tpar, meshes["torch"])):
            dist = par.distribute(m.frame({
                "k1": np.arange(n, dtype=np.int32),      # 100 distinct
                "k2": np.zeros(n, np.int32), "x": np.ones(n)}), mesh)
            with pytest.raises(ValueError, match="distinct"):
                par.daggregate({"x": "sum"}, dist, ["k1", "k2"],
                               max_groups=10)
            with pytest.raises(ValueError, match="int32 combined-id"):
                par.daggregate({"x": "sum"}, dist, ["k1", "k2"],
                               max_groups=100_000)


# ---------------------------------------------------------------------------
# dfilter
# ---------------------------------------------------------------------------

class TestDFilter:
    def test_matches_host_filter(self, meshes):
        rng = np.random.default_rng(21)
        x = rng.normal(size=1000)
        v = rng.normal(size=(1000, 3))

        def fn(m, par, mesh):
            dist = par.distribute(m.analyze(m.frame({"x": x, "v": v})),
                                  mesh)
            return par.dfilter(lambda x: x > 0.0, dist)

        j, t, t1 = run(meshes, fn, one_shard=True)
        assert t.count() == j.count() == int((x > 0).sum())
        assert list(t.shard_valid) == list(j.shard_valid)
        assert_same(collected(j), collected(t))
        assert_same(collected(j), collected(t1))
        keep = x > 0
        np.testing.assert_array_equal(columns(collected(t1))["x"], x[keep])

    def test_chains_with_dmap_and_dreduce(self, meshes):
        x = np.arange(100, dtype=np.float64)

        def fn(m, par, mesh):
            flt = par.dfilter(lambda x: x >= 50.0,
                              par.distribute(m.frame({"x": x}), mesh))
            mapped = par.dmap_blocks(lambda x: {"z": x * 2.0}, flt)
            sel = mapped.select(["z"])
            gen = (lambda z_input: {"z": torch.amax(z_input, 0)}) \
                if m is ttf else (lambda z_input: {"z": jnp.max(z_input,
                                                                axis=0)})
            return (par.dreduce_blocks({"z": "sum"}, sel),
                    par.dreduce_blocks(gen, sel))

        (js, jg), (ts, tg) = run(meshes, fn)
        assert_same(js, ts)
        assert_same(jg, tg)
        assert float(ts["z"]) == float((x[x >= 50] * 2).sum())
        assert float(tg["z"]) == 198.0

    def test_pad_rows_never_survive(self, meshes):
        j, t = run(meshes, lambda m, par, mesh: par.dfilter(
            lambda x: x > 0.0, par.distribute(m.frame({"x": np.ones(10)}),
                                              mesh)))
        assert t.count() == j.count() == 10
        assert_same(collected(j), collected(t))

    def test_string_rider_column_permutes(self, meshes):
        keys = np.array([f"k{i}" for i in range(12)], object)
        x = np.arange(12, dtype=np.float64)
        j, t = run(meshes, lambda m, par, mesh: par.dfilter(
            lambda x: x % 2.0 == 0.0,
            par.distribute(m.frame({"k": keys, "x": x}), mesh)))
        assert_same(collected(j), collected(t))
        assert sorted(r["k"] for r in collected(t).collect()) == \
            sorted(f"k{i}" for i in range(0, 12, 2))

    def test_filter_all_gone_then_count_zero(self, meshes):
        j, t = run(meshes, lambda m, par, mesh: par.dfilter(
            lambda x: x < 0.0, par.distribute(m.frame({"x": np.ones(16)}),
                                              mesh)))
        assert t.count() == j.count() == 0

    def test_host_column_predicate_typed_error(self, meshes):
        from tensorframes_tpu_torch import dtypes as tdt
        from tensorframes_tpu_torch.computation import (Computation,
                                                        TensorSpec)
        from tensorframes_tpu_torch.shape import Shape, Unknown

        k = np.array(["a", "b"], object)
        dist = tpar.distribute(ttf.frame({"k": k, "x": np.arange(2.0)}),
                               meshes["torch"])
        with pytest.raises(tops.InvalidTypeError, match="non-tensor"):
            tpar.dfilter(lambda k: (k != 0).to(torch.int32), dist)
        comp = Computation.trace(
            lambda k: {"keep": (k > 0).to(torch.int32)},
            [TensorSpec("k", tdt.double, Shape(Unknown))])
        with pytest.raises(tops.InvalidTypeError, match="host-side"):
            tpar.dfilter(comp, dist)

    def test_dfilter_reuses_its_computation(self, meshes):
        pred = lambda x: x > 0.0  # noqa: E731
        dist = tpar.distribute(ttf.frame({"x": np.arange(16.0)}),
                               meshes["torch"])
        tpar.dfilter(pred, dist)
        comp = tops.cached_map_computation(pred, dist.schema,
                                           block_level=True)
        out = tpar.dfilter(pred, dist)
        assert tops.cached_map_computation(pred, dist.schema,
                                           block_level=True) is comp
        assert out.count() == 15


# ---------------------------------------------------------------------------
# randomized conformance, explain
# ---------------------------------------------------------------------------

class TestHostMeshConformance:
    """Every mesh op agrees with its host twin and with the JAX package's
    mesh op on the same random frames."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_frames_agree(self, meshes, seed):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(30, 200))
        g = int(rng.integers(2, 12))
        data = {"k": rng.integers(0, g, n).astype(np.int32),
                "x": rng.normal(size=n),
                "v": rng.normal(size=(n, int(rng.integers(1, 4))))}
        parts = int(rng.integers(1, 5))

        def fn(m, par, mesh):
            df = m.analyze(m.frame(data, num_partitions=parts))
            dist = par.distribute(df, mesh)
            mx = (lambda v_input: {"v": torch.amax(v_input, 0)}) \
                if m is ttf else (lambda v_input: {"v": jnp.max(v_input,
                                                                axis=0)})
            return {
                "map": collected(par.dmap_blocks(
                    lambda x, v: {"z": x[:, None] * v}, dist)),
                "host_map": m.map_blocks(lambda x, v: {"z": x[:, None] * v},
                                         df),
                "sum": par.dreduce_blocks({"x": "sum"}, dist.select(["x"])),
                "max": par.dreduce_blocks(mx, dist.select(["v"])),
                "host_max": m.reduce_blocks(mx, df.select(["v"])),
                "agg": par.daggregate({"x": "sum"}, dist.select(["k", "x"]),
                                      "k"),
                "host_agg": m.aggregate({"x": "sum"},
                                        df.select(["k", "x"]).group_by("k")),
                "filter": collected(par.dfilter(lambda x: x > 0.0, dist)),
            }

        j, t, t1 = run(meshes, fn, one_shard=True)
        for key in ("map", "sum", "max", "agg", "filter"):
            assert_same(j[key], t[key], rtol=F64)
            if key != "filter":  # a 1-shard filter keeps the host order
                assert_same(j[key], t1[key], rtol=F64)
        assert_same(t["host_map"], t["map"])
        np.testing.assert_allclose(t["max"]["v"], t["host_max"], rtol=F64)
        assert_same(t["host_agg"], t["agg"], rtol=F64)
        keep = data["x"] > 0
        np.testing.assert_array_equal(np.sort(columns(t["filter"])["x"]),
                                      np.sort(data["x"][keep]))


def test_distributed_frame_explain(meshes):
    k = np.array(["a", "b"], object)
    df = ttf.analyze(ttf.frame({"k": k, "x": np.arange(2.0),
                                "v": np.ones((2, 3))}))
    dist = tpar.distribute(df, meshes["torch"])
    out = dist.explain()
    assert "2 rows" in out and "padded 8" in out
    assert "prefix" in out
    assert "host (ride-along)" in out            # string column
    assert "x: double" in out and "v: array<double>" in out
    assert "row-sharded over 'data' (8 shards on cpu)" in out
    flt = tpar.dfilter(lambda x: x >= 0.0, dist)
    assert "per-shard [1, 1, 0, 0, 0, 0, 0, 0]" in flt.explain()
    jflt = jpar.dfilter(lambda x: x >= 0.0, jpar.distribute(
        jtf.analyze(jtf.frame({"k": k, "x": np.arange(2.0),
                               "v": np.ones((2, 3))})), meshes["jax"]))
    assert "per-shard [1, 1, 0, 0, 0, 0, 0, 0]" in jflt.explain()


# ---------------------------------------------------------------------------
# hot-key salting (tests/test_elastic.py TestHotKeySalting)
# ---------------------------------------------------------------------------

class TestHotKeySalting:
    @staticmethod
    def _hot_frame(m, n=8_000):
        keys = np.zeros(n, np.int64)
        keys[: n // 5] = np.arange(n // 5) % 7 + 1  # key 0 holds 80%
        return m.frame({"k": keys, "v": np.arange(n)})

    def test_hot_key_salted_and_exact(self, meshes):
        def fn(m, par, mesh):
            df = self._hot_frame(m)
            return (m.aggregate({"v": "sum"}, df.group_by("k")),
                    par.daggregate({"v": "sum"}, par.distribute(df, mesh),
                                   "k"))

        (jh, jm), (th, tm) = run(meshes, fn)
        assert jcounters.get("mesh.salted_keys") == 1
        assert tcounters.get("mesh.salted_keys") == 1
        assert_same(jm, tm)
        assert_same(th, tm)
        assert tm.hot_keys() == jm.hot_keys() == [
            {"keys": {"k": 0}, "fraction": 0.8, "salt_slots": 8}]

    def test_salting_cached_per_frame(self, meshes):
        dist = tpar.distribute(self._hot_frame(ttf), meshes["torch"])
        a1 = tpar.daggregate({"v": "sum"}, dist, "k").collect()
        a2 = tpar.daggregate({"v": "sum"}, dist, "k").collect()
        assert a1 == a2
        assert tcounters.get("mesh.salted_keys") == 1  # planned once

    @pytest.mark.parametrize("cname", ["min", "max", "sum"])
    def test_fold_back_exact(self, meshes, cname):
        df = self._hot_frame(ttf)
        df = ttf.frame({"k": columns(df)["k"],
                        "v": np.arange(8_000) * 0.25 - 7.0})
        host = ttf.aggregate({"v": cname}, df.group_by("k"))
        out = tpar.daggregate({"v": cname}, tpar.distribute(
            df, meshes["torch"]), "k")
        assert_same(host, out, rtol=F64)
        jdf = jtf.frame({"k": columns(df)["k"], "v": columns(df)["v"]})
        assert_same(jpar.daggregate({"v": cname}, jpar.distribute(
            jdf, meshes["jax"]), "k"), out, rtol=F64)

    def test_no_hot_key_no_salting_nor_on_one_shard(self, meshes):
        n = 8_000
        df = ttf.frame({"k": np.arange(n) % 16, "v": np.arange(n)})
        tpar.daggregate({"v": "sum"}, tpar.distribute(df, meshes["torch"]),
                        "k")
        hot = self._hot_frame(ttf)
        out = tpar.daggregate({"v": "sum"}, tpar.distribute(
            hot, meshes["torch1"]), "k")
        assert tcounters.get("mesh.salted_keys") == 0
        assert out.hot_keys() == []

    def test_salting_disabled_by_env(self, meshes, monkeypatch):
        monkeypatch.setenv("TFT_SALT_HOT_KEYS", "0")
        df = self._hot_frame(ttf)
        out = tpar.daggregate({"v": "sum"}, tpar.distribute(
            df, meshes["torch"]), "k")
        assert tcounters.get("mesh.salted_keys") == 0
        assert_same(ttf.aggregate({"v": "sum"}, df.group_by("k")), out)

    def test_explain_renders_the_hot_key(self, meshes):
        out = tpar.daggregate({"v": "sum"}, tpar.distribute(
            self._hot_frame(ttf), meshes["torch"]), "k")
        assert "hot key  : {k=0} — 80% of rows, salted across 8 slot(s)" \
            in out.explain()


# ---------------------------------------------------------------------------
# what waits for ROADMAP.md A items 7b and 8
# ---------------------------------------------------------------------------

def test_unported_routes_raise_naming_their_item(meshes, monkeypatch):
    dist = tpar.distribute(ttf.frame({"k": np.arange(8) % 2,
                                      "x": np.arange(8.0)}),
                           meshes["torch"])
    # the elastic mesh and the fused plan are ported
    # (tests/test_torch_elastic.py, tests/test_torch_dplan.py)
    lz = dist.lazy()
    assert getattr(lz, "_tft_lazy_dist", False)
    assert tpar.admit_devices(dist) is dist  # no candidate: a no-op
    assert tpar.grow_mesh(meshes["torch"], []) is meshes["torch"]
    assert tpar.probe_device(torch.device("cpu")) is True
    # the ring collectives are ported (tests/test_torch_ring.py), and so
    # is the cluster (tests/test_torch_cluster.py)
    for name in ("ring_attention", "ring_allreduce"):
        assert name in tpar.__all__ and name in jpar.__all__
    x = torch.arange(16.0).reshape(8, 2)
    torch.testing.assert_close(tpar.ring_allreduce(x, meshes["torch"]),
                               x.sum(0).expand(8, 2).contiguous())
    for name in ("cluster_mesh", "distribute_local", "initialize"):
        assert name in tpar.__all__ and name in jpar.__all__
    for var in ("TFT_COORDINATOR", "TFT_NUM_PROCESSES", "TFT_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    # with no cluster configured the process stays single-process
    assert tpar.initialize() is False
    assert sorted(tpar.__all__) == sorted(jpar.__all__)
    # the shuffle route is ported (tests/test_torch_shuffle.py): past the
    # threshold on 8 shards it routes; one shard never shuffles, nor does
    # the device-key path
    monkeypatch.setenv("TFT_SHUFFLE_AGG_GROUPS", "1")
    tpar.daggregate({"x": "sum"}, dist, "k")
    assert tcounters.get("mesh.shuffle_agg_routes") == 1
    tpar.daggregate({"x": "sum"}, tpar.distribute(
        ttf.frame({"k": np.arange(8) % 2, "x": np.arange(8.0)}),
        meshes["torch1"]), "k")
    tpar.daggregate({"x": "sum"}, dist, "k", max_groups=4)
    assert tcounters.get("mesh.shuffle_agg_routes") == 1
    monkeypatch.delenv("TFT_SHUFFLE_AGG_GROUPS")
    monkeypatch.setenv("TFT_EXECUTOR", "pjrt")
    for call in (lambda: tpar.distribute(ttf.frame({"x": np.ones(2)}),
                                         meshes["torch"]),
                 lambda: tpar.dmap_blocks(lambda x: {"z": x}, dist),
                 lambda: tpar.dfilter(lambda x: x > 0, dist),
                 lambda: tpar.dreduce_blocks({"x": "sum"}, dist),
                 lambda: tpar.daggregate({"x": "sum"}, dist, "k")):
        with pytest.raises(NotImplementedError, match="A item 8"):
            call()


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def test_reference_workload_through_the_mesh(meshes):
    """The reference workload at a small size through distribute ->
    dmap_blocks(z = x + x) -> dfilter -> dreduce_blocks (collective and
    generic) -> daggregate with host keys and with device keys, in both
    packages on 8 shards and in the port on one."""
    rng = np.random.default_rng(2)
    n, keys = 4_000, 300
    key = rng.integers(0, keys, n)
    x = rng.random(n)

    def fn(m, par, mesh):
        dist = par.distribute(m.frame({"key": key, "x": x},
                                      num_partitions=8), mesh)
        z = par.dmap_blocks(lambda x: {"z": x + x}, dist)
        flt = par.dfilter(lambda x: x > 0.25, z)
        sel = flt.select(["z"])
        mn = (lambda z_input: {"z": torch.amin(z_input, 0)}) if m is ttf \
            else (lambda z_input: {"z": jnp.min(z_input, axis=0)})
        zk = z.select(["key", "z"])
        return {"collect": collected(flt),
                "sum": par.dreduce_blocks({"z": "sum"}, sel),
                "min": par.dreduce_blocks({"z": "min"}, sel),
                "gmin": par.dreduce_blocks(mn, sel),
                "host": par.daggregate({"z": "sum"}, zk, "key"),
                "device": par.daggregate({"z": "sum"}, zk, "key",
                                         max_groups=512),
                "filtered": par.daggregate({"z": "sum"},
                                           flt.select(["key", "z"]), "key",
                                           max_groups=512)}

    j, t, t1 = run(meshes, fn, one_shard=True)
    for k in j:
        assert_same(j[k], t[k], rtol=F64)
        if k != "collect":
            assert_same(j[k], t1[k], rtol=F64)
    keep = x > 0.25
    np.testing.assert_allclose(float(t["sum"]["z"]), (2 * x[keep]).sum(),
                               rtol=F64)
    assert float(t["min"]["z"]) == float(t["gmin"]["z"]) == \
        (2 * x[keep]).min()
    want = np.bincount(key, weights=2 * x, minlength=keys)
    got = columns(t["device"])
    np.testing.assert_allclose(got["z"], want[got["key"]], rtol=F64)
    assert_same(t["host"], t["device"])
