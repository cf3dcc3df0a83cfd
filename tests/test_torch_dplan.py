"""The port's distributed plan (``tensorframes_tpu_torch/plan/dist.py``):
lazy d-op chains fused into one stage per mesh stage, against the JAX
package's on the same seeded frames.

Mirrors every case of ``tests/test_dplan.py``. Each chain runs through
both packages: the JAX package on the conftest's 8 CPU devices, the port
on 8 logical CPU shards (``TFT_CPU_DEVICE_COUNT=8``), eager and through
``lazy()``. Fused and eager agree bit for bit within each package, and
the two packages agree with each other on values, dtypes, row order,
per-shard valid rows and the counters the JAX tests pin
(``mesh.dispatches``, ``mesh.interstage_host_bytes``,
``dplan.fused_programs``, ``dplan.fallbacks``). Tolerances: integers
exact; f64 rtol 1e-12. The explain and report texts name the port's
stage ("fused stage program") where the JAX package's name its GSPMD
program.
"""

import numpy as np
import pytest

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import memory as jmem
from tensorframes_tpu import parallel as jpar
from tensorframes_tpu import stream as jstream
from tensorframes_tpu.engine import ops as jops
from tensorframes_tpu.observability import events as jevents
from tensorframes_tpu.observability.report import render as jrender
from tensorframes_tpu.parallel import elastic as jelastic
from tensorframes_tpu.plan import nodes as jnodes
from tensorframes_tpu.resilience import faults as jfaults
from tensorframes_tpu.utils import tracing as jtracing
from tensorframes_tpu_torch import memory as tmem
from tensorframes_tpu_torch import parallel as tpar
from tensorframes_tpu_torch import stream as tstream
from tensorframes_tpu_torch.engine import ops as tops
from tensorframes_tpu_torch.observability import events as tevents
from tensorframes_tpu_torch.observability.report import render as trender
from tensorframes_tpu_torch.parallel import elastic as telastic
from tensorframes_tpu_torch.plan import nodes as tnodes
from tensorframes_tpu_torch.resilience import faults as tfaults
from tensorframes_tpu_torch.utils import tracing as ttracing
from types import SimpleNamespace

pytestmark = pytest.mark.dplan

F64 = 1e-12

J = SimpleNamespace(
    name="jax", tf=jtf, par=jpar, elastic=jelastic, faults=jfaults,
    events=jevents, tracing=jtracing, counters=jtracing.counters,
    mem=jmem, ops=jops, nodes=jnodes, stream=jstream, render=jrender,
    fused="1 fused GSPMD program", stage="ONE GSPMD program")
T = SimpleNamespace(
    name="torch", tf=ttf, par=tpar, elastic=telastic, faults=tfaults,
    events=tevents, tracing=ttracing, counters=ttracing.counters,
    mem=tmem, ops=tops, nodes=tnodes, stream=tstream, render=trender,
    fused="1 fused stage program", stage="ONE fused stage program")
BOTH = (J, T)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("TFT_CPU_DEVICE_COUNT", "8")
    monkeypatch.setenv("TFT_ADAPTIVE", "0")
    monkeypatch.setenv("TFT_RESULT_CACHE", "0")
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    for P in BOTH:
        P.counters.reset()
        P.faults.reset()
        P.elastic._tracker.clear()
    yield
    for P in BOTH:
        P.faults.reset()
        P.elastic._tracker.clear()
        P.elastic._lost_pool.clear()
        P.tracing.disable()
        P.mem._reset()
    ttf.set_default_device(prev)


def mesh(P):
    return P.par.local_mesh(8)


def both(fn):
    return fn(J), fn(T)


def frame(P, n=40, keys=5, strings=False):
    cols = {"k": (np.arange(n) % keys).astype(np.int64),
            "x": np.arange(n).astype(np.int64),
            "f": np.arange(n, dtype=np.float64) * 0.5}
    if strings:
        cols["s"] = np.array([f"n{i}" for i in range(n)], object)
    return P.tf.frame(cols)


def cols_of(dframe):
    """Collected columns of a (distributed) frame as exact numpy."""
    tf = dframe.collect_frame()
    out = {}
    for f in tf.schema:
        parts = [np.asarray(b.columns[f.name], object)
                 if not f.dtype.tensor else np.asarray(b.dense(f.name))
                 for b in tf.blocks()]
        out[f.name] = np.concatenate(parts) if parts else np.empty(0)
    return out


def assert_identical(got, ref):
    assert set(got) == set(ref)
    for n in ref:
        g, r = got[n], ref[n]
        assert g.dtype == r.dtype, (n, g.dtype, r.dtype)
        assert g.shape == r.shape, (n, g.shape, r.shape)
        if g.dtype == object:
            assert list(g) == list(r), n
        else:
            assert np.array_equal(g, r), n


def chains(P):
    par = P.par
    return {
        "maps": lambda d: par.dmap_blocks(
            lambda z: {"w": z + 1}, par.dmap_blocks(
                lambda x: {"z": x * 2}, d)),
        "map_filter_map": lambda d: par.dmap_blocks(
            lambda z: {"w": z + 1}, par.dfilter(
                lambda z: z % 3 == 0, par.dmap_blocks(
                    lambda x: {"z": x * 2}, d))),
        "filter_first": lambda d: par.dmap_blocks(
            lambda x: {"z": x + 10}, par.dfilter(lambda x: x % 2 == 0, d)),
        "multi_filter": lambda d: par.dfilter(
            lambda x: x < 30, par.dfilter(lambda x: x % 2 == 0, d)),
        "select_prunes": lambda d: par.dmap_blocks(
            lambda x: {"z": x * 3}, d).select(["z"]),
        "float_row_local": lambda d: par.dmap_blocks(
            lambda f: {"g": f * 1.5 + 0.25}, d),
        "filter_to_zero": lambda d: par.dmap_blocks(
            lambda x: {"z": x + 1}, par.dfilter(lambda x: x < 0, d)),
    }


CHAIN_NAMES = sorted(chains(J))


def fused_and_eager(P, chain, dist):
    """``chain`` over ``dist`` eagerly and through ``lazy()``: both
    collected, bit-identical, and the fused frame's per-shard valid
    rows."""
    ref = cols_of(chain(dist))
    lz = chain(dist.lazy())
    got = cols_of(lz)
    assert_identical(got, ref)
    return got, list(lz.per_shard_valid())


def across_packages(j, t):
    assert_identical(t[0], j[0])
    assert t[1] == j[1]


# ---------------------------------------------------------------------------
# fused vs per-op bit-identity
# ---------------------------------------------------------------------------

class TestEquivalence:
    @pytest.mark.parametrize("shape", CHAIN_NAMES)
    def test_chain_bit_identical(self, shape):
        across_packages(*both(lambda P: fused_and_eager(
            P, chains(P)[shape], P.par.distribute(frame(P), mesh(P)))))

    def test_fuse_off_is_the_per_op_path(self, monkeypatch):
        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))
            monkeypatch.setenv("TFT_FUSE", "0")
            assert dist.lazy() is dist  # the kill switch: no recording
            ref = cols_of(chains(P)["map_filter_map"](dist.lazy()))
            monkeypatch.delenv("TFT_FUSE")
            got = cols_of(chains(P)["map_filter_map"](dist.lazy()))
            assert_identical(got, ref)
            return got, []

        across_packages(*both(run))

    def test_string_ride_along_through_fused_filter(self):
        def run(P):
            out = fused_and_eager(
                P, chains(P)["map_filter_map"],
                P.par.distribute(frame(P, strings=True), mesh(P)))
            assert out[0]["s"].dtype == object
            return out

        across_packages(*both(run))

    def test_shard_valid_input_frame(self):
        def run(P):
            dist = P.par.dfilter(lambda x: x % 3 != 1,
                                 P.par.distribute(frame(P), mesh(P)))
            assert dist.shard_valid is not None
            return fused_and_eager(P, chains(P)["map_filter_map"], dist)

        across_packages(*both(run))

    def test_empty_shards(self):
        across_packages(*both(lambda P: fused_and_eager(
            P, chains(P)["map_filter_map"],
            P.par.distribute(frame(P, n=3), mesh(P)))))

    def test_vector_cells(self):
        def run(P):
            df = P.tf.frame({"x": np.arange(16).astype(np.int64),
                             "v": np.arange(48, dtype=np.float64)
                             .reshape(16, 3)})

            def chain(d):
                return P.par.dmap_blocks(
                    lambda m: {"s": m * 2.0},
                    P.par.dmap_blocks(lambda x, v: {"m": x[:, None] * v},
                                      d))

            return fused_and_eager(P, chain, P.par.distribute(df, mesh(P)))

        across_packages(*both(run))

    def test_trim_map_materializes_chain(self):
        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))
            lz = P.par.dmap_blocks(lambda x: {"z": x * 2}, dist.lazy())
            out = P.par.dmap_blocks(lambda z: {"t": z.sum()[None]}, lz,
                                    trim=True)
            ref = P.par.dmap_blocks(
                lambda z: {"t": z.sum()[None]},
                P.par.dmap_blocks(lambda x: {"z": x * 2}, dist), trim=True)
            got = int(np.asarray(out.host_read_padded("t"))[0])
            assert got == int(np.asarray(ref.host_read_padded("t"))[0])
            return got

        j, t = both(run)
        assert t == j

    def test_record_time_validation_parity(self):
        msgs = []
        for P in BOTH:
            dist = P.par.distribute(frame(P), mesh(P))
            with pytest.raises(ValueError, match="collides") as e1:
                P.par.dmap_blocks(lambda x: {"x": x}, dist.lazy())
            with pytest.raises(KeyError) as e2:
                dist.lazy().select(["nope"])
            with pytest.raises(P.ops.InvalidTypeError,
                               match="non-tensor") as e3:
                P.par.dfilter(lambda s: s,
                              P.par.distribute(frame(P, strings=True),
                                               mesh(P)).lazy())
            msgs.append((str(e1.value), str(e2.value),
                         str(e3.value).replace("tensorframes_tpu_torch",
                                               "tensorframes_tpu")))
        assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# folded terminal reductions
# ---------------------------------------------------------------------------

class TestFoldedReductions:
    def test_reduce_int_bit_identical(self):
        fetches = {"x": "sum", "z": "max", "k": "min"}

        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))
            ref = P.par.dreduce_blocks(
                fetches, P.par.dmap_blocks(lambda x: {"z": x * 2}, dist))
            d0 = P.counters.get("mesh.dispatches")
            got = P.par.dreduce_blocks(
                fetches, P.par.dmap_blocks(lambda x: {"z": x * 2},
                                           dist.lazy()))
            assert P.counters.get("mesh.dispatches") - d0 == 1
            for n in fetches:
                assert got[n].dtype == ref[n].dtype
                assert np.array_equal(got[n], ref[n]), n
            return got

        j, t = both(run)
        for n in fetches:
            assert t[n].dtype == j[n].dtype and np.array_equal(t[n], j[n])

    def test_reduce_after_filter(self):
        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))

            def chain(d):
                return P.par.dfilter(lambda x: x % 2 == 0, d)

            ref = P.par.dreduce_blocks({"x": "sum"}, chain(dist))
            got = P.par.dreduce_blocks({"x": "sum"}, chain(dist.lazy()))
            assert np.array_equal(got["x"], ref["x"])
            return got["x"]

        j, t = both(run)
        assert np.array_equal(t, j) and t.dtype == j.dtype

    def test_reduce_empty_after_filter_raises(self):
        msgs = []
        for P in BOTH:
            dist = P.par.distribute(frame(P), mesh(P))
            lz = P.par.dfilter(lambda x: x < 0, dist.lazy())
            with pytest.raises(ValueError, match="empty") as ei:
                P.par.dreduce_blocks({"x": "sum"}, lz)
            msgs.append(str(ei.value))
        assert msgs[1] == msgs[0]

    def test_reduce_unknown_column_and_combiner(self):
        msgs = []
        for P in BOTH:
            dist = P.par.distribute(frame(P), mesh(P))
            lz = P.par.dmap_blocks(lambda x: {"z": x + 1}, dist.lazy())
            with pytest.raises(KeyError, match="No column") as e1:
                P.par.dreduce_blocks({"nope": "sum"}, lz)
            with pytest.raises(KeyError, match="Unknown combiner") as e2:
                P.par.dreduce_blocks({"x": "median"}, lz)
            msgs.append((str(e1.value), str(e2.value)))
        assert msgs[1] == msgs[0]

    def test_generic_reduce_materializes(self):
        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))

            def combine(x_input):
                return {"x": x_input.sum(axis=0) if P is J
                        else x_input.sum(0)}

            ref = P.par.dreduce_blocks(
                combine, P.par.dmap_blocks(lambda x: {"z": x * 2}, dist)
                .select(["x"]))
            got = P.par.dreduce_blocks(
                combine, P.par.dmap_blocks(lambda x: {"z": x * 2},
                                           dist.lazy()).select(["x"]))
            assert np.array_equal(got["x"], ref["x"])
            return got["x"]

        j, t = both(run)
        assert np.array_equal(t, j)

    def test_aggregate_folded_matches_eager(self):
        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))

            def chain(d):
                return P.par.dmap_blocks(lambda x: {"v": x * 3},
                                         d).select(["k", "v"])

            ref = P.par.daggregate({"v": "sum"}, chain(dist), "k")
            d0 = P.counters.get("mesh.dispatches")
            got = P.par.daggregate({"v": "sum"}, chain(dist.lazy()), "k")
            assert P.counters.get("mesh.dispatches") - d0 == 1
            assert got.collect() == ref.collect()
            return cols_of_host(got)

        j, t = both(run)
        assert_identical(t, j)

    def test_aggregate_with_filter_falls_back_correctly(self):
        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))

            def chain(d):
                return P.par.dfilter(lambda x: x % 2 == 0, d)

            ref = P.par.daggregate({"x": "sum"}, chain(dist), "k")
            got = P.par.daggregate({"x": "sum"}, chain(dist.lazy()), "k")
            assert got.collect() == ref.collect()
            return cols_of_host(got)

        j, t = both(run)
        assert_identical(t, j)

    def test_aggregate_hot_key_salted_exact(self):
        def run(P):
            n = 64
            k = np.zeros(n, np.int64)
            k[: n // 4] = np.arange(n // 4) % 3 + 1  # one dominant key 0
            df = P.tf.frame({"k": k, "x": np.arange(n).astype(np.int64)})
            dist = P.par.distribute(df, mesh(P))
            lz = P.par.dmap_blocks(lambda x: {"v": x + 1}, dist.lazy()) \
                .select(["k", "v"])
            got = P.par.daggregate({"v": "sum"}, lz, "k")
            ref = P.par.daggregate(
                {"v": "sum"},
                P.par.dmap_blocks(lambda x: {"v": x + 1}, dist)
                .select(["k", "v"]), "k")
            assert got.collect() == ref.collect()
            assert P.counters.get("mesh.salted_keys") >= 1
            return cols_of_host(got), got.hot_keys()

        j, t = both(run)
        assert_identical(t[0], j[0])
        assert t[1] == j[1]


def cols_of_host(tf):
    """A host frame's columns, exact numpy."""
    out = {}
    for f in tf.schema:
        out[f.name] = np.concatenate([np.asarray(b.dense(f.name))
                                      for b in tf.blocks()])
    return out


# ---------------------------------------------------------------------------
# laziness, dispatch counts, host transfers
# ---------------------------------------------------------------------------

class TestLaziness:
    def test_recording_does_not_dispatch(self):
        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))
            d0 = P.counters.get("mesh.dispatches")
            lz = chains(P)["map_filter_map"](dist.lazy())
            assert P.counters.get("mesh.dispatches") == d0
            lz.collect_frame()
            assert P.counters.get("mesh.dispatches") == d0 + 1
            return P.counters.get("dplan.recorded_ops")

        j, t = both(run)
        assert t == j == 3

    def test_at_least_4x_fewer_dispatches(self):
        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))

            def four_op(d):
                d = P.par.dmap_blocks(lambda x: {"z": x * 2}, d)
                d = P.par.dfilter(lambda z: z % 3 == 0, d)
                d = P.par.dmap_blocks(lambda z: {"w": z + 1}, d)
                return P.par.dreduce_blocks({"w": "sum"}, d)

            d0 = P.counters.get("mesh.dispatches")
            ref = four_op(dist)
            eager_n = P.counters.get("mesh.dispatches") - d0
            d1 = P.counters.get("mesh.dispatches")
            got = four_op(dist.lazy())
            fused_n = P.counters.get("mesh.dispatches") - d1
            assert np.array_equal(got["w"], ref["w"])
            assert eager_n == 4
            assert fused_n == 1
            return got["w"], eager_n, fused_n

        j, t = both(run)
        assert np.array_equal(t[0], j[0]) and t[1:] == j[1:]

    def test_zero_interstage_host_bytes_when_fused(self):
        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))
            chain = chains(P)["map_filter_map"]
            h0 = P.counters.get("mesh.interstage_host_bytes")
            chain(dist).collect_frame()
            eager_bytes = P.counters.get("mesh.interstage_host_bytes") - h0
            h1 = P.counters.get("mesh.interstage_host_bytes")
            chain(dist.lazy()).collect_frame()
            fused_bytes = P.counters.get("mesh.interstage_host_bytes") - h1
            assert eager_bytes > 0      # dfilter's counts readback
            assert fused_bytes == 0     # counts stay on the devices
            return eager_bytes, fused_bytes

        j, t = both(run)
        assert t == j

    _mk = staticmethod(lambda x: {"z": x * 2})
    _fl = staticmethod(lambda z: z % 3 == 0)
    _mk2 = staticmethod(lambda z: {"w": z + 1})

    def test_program_cache_hit_on_reforcing(self):
        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))

            def chain(d):
                return P.par.dmap_blocks(
                    TestLaziness._mk2, P.par.dfilter(
                        TestLaziness._fl, P.par.dmap_blocks(
                            TestLaziness._mk, d)))

            chain(dist.lazy()).collect_frame()
            built = P.counters.get("dplan.fused_programs")
            chain(dist.lazy()).collect_frame()  # same comps, same shapes
            assert P.counters.get("dplan.fused_programs") == built
            return built

        for P in BOTH:
            run(P)

    def test_resident_passthrough_skips_program_io(self):
        for P in BOTH:
            dist = P.par.distribute(frame(P), mesh(P))
            lz = P.par.dmap_blocks(lambda x: {"z": x * 2}, dist.lazy())
            assert lz.columns["k"] is dist.columns["k"]


# ---------------------------------------------------------------------------
# elastic recovery through fused stages
# ---------------------------------------------------------------------------

class TestElastic:
    def test_device_loss_mid_fused_stage(self):
        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))
            chain = chains(P)["map_filter_map"]
            ref = cols_of(chain(dist))
            lz = chain(dist.lazy())
            P.tracing.enable()
            try:
                with P.faults.inject("device", 1):
                    lz.count()  # forces mid-inject: the loss hits the
                    #             fused dispatch boundary
                t = P.events.last_query()
            finally:
                P.tracing.disable()
            got = cols_of(lz)
            assert_identical(got, ref)
            assert lz.mesh.num_devices == 7
            assert P.counters.get("mesh.devices_lost") == 1
            assert P.counters.get("mesh.reshard_rows") > 0
            assert t is not None and t.op == "dfused"
            shr = [e for e in t.events if e.etype == "mesh_shrink"]
            assert len(shr) == 1 and shr[0].args["devices_after"] == 7
            return got, list(lz.per_shard_valid())

        across_packages(*both(run))

    def test_device_loss_on_folded_reduce(self):
        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))
            lz = P.par.dmap_blocks(lambda x: {"z": x * 2}, dist.lazy())
            ref = P.par.dreduce_blocks(
                {"z": "sum"}, P.par.dmap_blocks(lambda x: {"z": x * 2},
                                                dist))
            with P.faults.inject("device", 1):
                got = P.par.dreduce_blocks({"z": "sum"}, lz)
            assert np.array_equal(got["z"], ref["z"])
            assert P.counters.get("mesh.devices_lost") == 1
            return got["z"]

        j, t = both(run)
        assert np.array_equal(t, j)

    def test_elastic_disabled_raises(self, monkeypatch):
        monkeypatch.setenv("TFT_ELASTIC", "0")
        for P in BOTH:
            dist = P.par.distribute(frame(P), mesh(P))
            lz = chains(P)["maps"](dist.lazy())
            with P.faults.inject("device", 1):
                with pytest.raises(P.faults.InjectedFault):
                    lz.collect_frame()


# ---------------------------------------------------------------------------
# fallbacks
# ---------------------------------------------------------------------------

class TestFallback:
    def test_permanent_fault_replays_per_op(self):
        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))
            chain = chains(P)["map_filter_map"]
            ref = cols_of(chain(dist))
            lz = chain(dist.lazy())
            f0 = P.counters.get("dplan.fallbacks")
            with P.faults.inject("dmap", 1, transient=False):
                got = cols_of(lz)
            assert_identical(got, ref)
            assert P.counters.get("dplan.fallbacks") == f0 + 1
            # the replay ran on the same mesh, op by op
            assert lz.mesh.num_devices == 8
            return got, list(lz.per_shard_valid())

        across_packages(*both(run))

    def test_transient_fault_retries_through_fused(self):
        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))
            chain = chains(P)["maps"]
            ref = cols_of(chain(dist))
            lz = chain(dist.lazy())
            f0 = P.counters.get("dplan.fallbacks")
            with P.faults.inject("dmap", 1):  # transient: retried
                got = cols_of(lz)
            assert_identical(got, ref)
            assert P.counters.get("dplan.fallbacks") == f0  # no fallback
            return got, list(lz.per_shard_valid())

        across_packages(*both(run))

    def test_fuse_disabled_after_recording_replays(self, monkeypatch):
        def run(P):
            dist = P.par.distribute(frame(P), mesh(P))
            lz = chains(P)["map_filter_map"](dist.lazy())
            monkeypatch.setenv("TFT_FUSE", "0")  # flipped between record
            got = cols_of(lz)                    # and force
            monkeypatch.delenv("TFT_FUSE")
            assert_identical(got, cols_of(
                chains(P)["map_filter_map"](dist)))
            return got, list(lz.per_shard_valid())

        across_packages(*both(run))


# ---------------------------------------------------------------------------
# memory ledger: resident shard edges
# ---------------------------------------------------------------------------

class TestLedger:
    def test_resident_edges_spill_and_fault_back(self):
        def run(P):
            P.mem.configure(limit_bytes=10 ** 9)
            dist = P.par.distribute(
                P.tf.frame({"x": np.arange(256, dtype=np.float64)}),
                mesh(P))
            lz = P.par.dmap_blocks(lambda x: {"z": x + 1.0},
                                   dist.lazy()).select(["z"])
            ref = cols_of(lz)
            c = lz.columns
            assert type(c).__name__ == "SpillableColumns"
            freed = c.mem_spill()
            assert freed > 0
            got = cols_of(lz)
            assert_identical(got, ref)  # fault-back bit-identical
            return got, freed

        j, t = both(run)
        assert_identical(t[0], j[0])
        assert t[1] == j[1]

    def test_passthrough_result_not_double_registered(self):
        for P in BOTH:
            P.mem.configure(limit_bytes=10 ** 9)
            dist = P.par.distribute(
                P.tf.frame({"x": np.arange(64, dtype=np.float64)}),
                mesh(P))
            lz = P.par.dmap_blocks(lambda x: {"z": x + 1.0}, dist.lazy())
            assert type(lz.columns).__name__ != "SpillableColumns"
            assert lz.columns["x"] is dist.columns["x"]

    def test_ledger_pressure_spills_fused_result(self):
        def run(P):
            mgr = P.mem.configure(limit_bytes=100_000)
            dist = P.par.distribute(
                P.tf.frame({"x": np.arange(512, dtype=np.float64)}),
                mesh(P))
            lz = P.par.dmap_blocks(lambda x: {"z": x + 1.0},
                                   dist.lazy()).select(["z"])
            ref = cols_of(lz)
            s0 = P.counters.get("memory.spills")
            mgr.make_room(10 ** 9)  # an admission squeeze spills residents
            assert P.counters.get("memory.spills") > s0
            assert lz.columns.mem_is_spilled()
            got = cols_of(lz)
            assert_identical(got, ref)
            return got

        j, t = both(run)
        assert_identical(t, j)

    def test_lazy_estimate_without_forcing(self):
        from tensorframes_tpu.memory.estimate import \
            dist_frame_estimate as jest
        from tensorframes_tpu_torch.memory.estimate import \
            dist_frame_estimate as test

        out = []
        for P, est in ((J, jest), (T, test)):
            dist = P.par.distribute(frame(P), mesh(P))
            lz = P.par.dmap_blocks(lambda f: {"g": f * 2.0}, dist.lazy())
            rows, nbytes = est(lz)
            assert lz._forced is None  # estimating must not force
            assert rows == 40
            assert nbytes is not None and nbytes > 0
            out.append((rows, nbytes))
        assert out[1] == out[0]


# ---------------------------------------------------------------------------
# feedback selectivity
# ---------------------------------------------------------------------------

class TestFeedbackSelectivity:
    def test_dfilter_records_observed_selectivity(self):
        sels = []
        for P in BOTH:
            dist = P.par.distribute(frame(P, n=60, keys=6), mesh(P))
            pred = lambda x: x % 3 == 0  # noqa: E731 - the shared predicate
            comp = P.ops._filter_computation(pred, dist.schema)
            assert P.nodes.observed_selectivity(comp) is None
            P.par.dfilter(pred, dist)
            sel = P.nodes.observed_selectivity(comp)
            assert sel is not None and abs(sel - 1 / 3) < 0.05
            sels.append(sel)
        assert sels[1] == sels[0]

    def test_fused_filter_records_and_estimates_sharpen(self):
        out = []
        for P in BOTH:
            dist = P.par.distribute(frame(P, n=64, keys=4), mesh(P))
            pred = lambda x: x % 4 == 0  # noqa: E731
            lz = P.par.dfilter(pred, dist.lazy())
            up_rows, _ = lz._dplan_node.estimate()
            assert up_rows == 64  # upper bound before any observation
            lz.collect_frame()    # the forcing observes rows-in/rows-out
            lz2 = P.par.dfilter(pred, dist.lazy())
            rows, _ = lz2._dplan_node.estimate()
            assert rows is not None and rows == pytest.approx(16, rel=0.05)
            out.append(rows)
        assert out[1] == out[0]

    def test_single_device_filter_node_sharpens(self):
        out = []
        for P in BOTH:
            df = P.tf.frame({"x": np.arange(100, dtype=np.float64)})
            pred = lambda x: x < 25.0  # noqa: E731
            f1 = df.filter(pred)
            r_up, _ = f1._plan_node.estimate()
            assert r_up == 100
            f1.blocks()  # force: observes selectivity 0.25
            f2 = df.filter(pred)
            r_obs, _ = f2._plan_node.estimate()
            assert r_obs == pytest.approx(25, rel=0.05)
            out.append(r_obs)
        assert out[1] == out[0]

    def test_downstream_cached_estimate_sharpens_too(self):
        out = []
        for P in BOTH:
            df = P.tf.frame({"x": np.arange(100, dtype=np.float64)})
            pred = lambda x: x < 10.0  # noqa: E731
            chain = df.filter(pred).map_blocks(lambda x: {"z": x * 2.0})
            r_before, _ = chain._plan_node.estimate()
            assert r_before == 100
            df.filter(pred).blocks()  # observe selectivity 0.1 elsewhere
            r_after, _ = chain._plan_node.estimate()
            assert r_after == pytest.approx(10, rel=0.05)
            out.append(r_after)
        assert out[1] == out[0]

    def test_record_time_row_aligned_error(self):
        msgs = []
        for P in BOTH:
            dist = P.par.distribute(frame(P), mesh(P))
            lz = P.par.dmap_blocks(lambda x: {"z": x + 1}, dist.lazy())
            with pytest.raises(ValueError, match="row_aligned=False") as ei:
                P.par.dmap_blocks(lambda z: {"w": z}, lz, row_aligned=False)
            assert lz._forced is None  # nothing ran
            msgs.append(str(ei.value))
        assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# explain / observability
# ---------------------------------------------------------------------------

class TestExplain:
    def test_lazy_explain_renders_plan_section(self):
        for P in BOTH:
            dist = P.par.distribute(frame(P), mesh(P))
            text = chains(P)["map_filter_map"](dist.lazy()).explain()
            assert "dplan" in text
            assert P.fused in text
            assert "compacted in-program" in text
            assert "stage 0: dmap_blocks+dfilter+dmap_blocks -> 1 mesh " \
                "dispatch" in text

    def test_fuse_off_explain_names_the_reason(self, monkeypatch):
        for P in BOTH:
            dist = P.par.distribute(frame(P), mesh(P))
            lz = chains(P)["maps"](dist.lazy())
            monkeypatch.setenv("TFT_FUSE", "0")
            assert "TFT_FUSE=0" in lz.explain()
            monkeypatch.delenv("TFT_FUSE")

    def test_trace_report_shows_fused_stage(self):
        summaries = []
        for P in BOTH:
            dist = P.par.distribute(frame(P), mesh(P))
            lz = chains(P)["map_filter_map"](dist.lazy())
            P.tracing.enable()
            try:
                lz.collect_frame()
            finally:
                P.tracing.disable()
            t = P.events.last_query()
            assert t is not None and t.op == "dfused"
            text = P.render(t)
            assert P.stage in text
            assert "mesh     : 8 device(s), 1 dispatch(es)" in text
            stage = [e for e in t.events if e.etype == "fused_stage"]
            summaries.append({k: v for k, v in stage[0].args.items()
                              if k != "wall_s"})
        assert summaries[1] == summaries[0]


# ---------------------------------------------------------------------------
# distributed streams on the mesh
# ---------------------------------------------------------------------------

class TestStreamMesh:
    def _run(self, P, m):
        def gen():
            for i in range(8):
                yield {"k": (np.arange(8) % 2).astype(np.int64),
                       "v": (np.arange(8) + i).astype(np.int64),
                       "ts": np.full(8, float(i))}

        agg = (P.stream.from_source(P.stream.GeneratorSource(gen()))
               .group_by("k")
               .aggregate({"v": "sum"}, window=P.stream.tumbling(4.0),
                          time_col="ts", mesh=m))
        h = agg.start()
        out = []
        while not h.done():
            h.step()
            for f in h.collect_updates():
                out.extend(f.collect())
        return out

    def test_windowed_stream_on_mesh_matches_single_device(self):
        def run(P):
            ref = self._run(P, None)
            m0 = P.counters.get("stream.mesh_folds")
            got = self._run(P, mesh(P))
            assert P.counters.get("stream.mesh_folds") > m0
            assert got == ref  # integer sums: exact across shard counts
            return [tuple(r) for r in got], \
                P.counters.get("stream.mesh_folds") - m0

        j, t = both(run)
        assert t == j

    def test_one_fused_dispatch_per_batch_fold(self):
        def run(P):
            d0 = P.counters.get("mesh.dispatches")
            m0 = P.counters.get("stream.mesh_folds")
            self._run(P, mesh(P))
            folds = P.counters.get("stream.mesh_folds") - m0
            assert P.counters.get("mesh.dispatches") - d0 == folds
            return folds

        j, t = both(run)
        assert t == j
