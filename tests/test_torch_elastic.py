"""The port's elastic mesh (``tensorframes_tpu_torch/parallel/elastic.py``)
against the JAX package's on the same seeded frames.

Mirrors every case of ``tests/test_elastic.py``, and the device-loss and
spill cases the elastic layer carries elsewhere:
``test_shuffle.py::TestExchangeInvariants::test_device_loss_zero_lost_rows``,
``::TestPartitionedJoin::test_device_loss_bit_identity``,
``::TestShuffleAggregate::test_device_loss_recovers``,
``test_relational.py::TestSortMergeJoin::test_device_loss_bit_identical``,
``::TestSketchDaggregate::test_elastic_recovery``, and
``test_memory.py::TestExternalDsort::test_spilled_frame_collects_without_faulting``
and ``::test_dmap_result_copies_through_accessors``.

Each case runs through both packages with the same fault schedule and the
same synthetic skew times: the JAX package on the conftest's 8 CPU
devices, the port on 8 logical CPU shards (``TFT_CPU_DEVICE_COUNT=8``),
which it knows apart by the mesh's logical ids. The cases compare values,
dtypes, row order, per-shard valid rows, counters, trace events and error
types. Tolerances: integers exact; f64 sums rtol 1e-12.
"""

import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import memory as jmem
from tensorframes_tpu import parallel as jpar
from tensorframes_tpu import relational as jrel
from tensorframes_tpu import resilience as jrz
from tensorframes_tpu import stream as jstream
from tensorframes_tpu.observability import events as jevents
from tensorframes_tpu.parallel import elastic as jelastic
from tensorframes_tpu.parallel import exchange as jex
from tensorframes_tpu.resilience import faults as jfaults
from tensorframes_tpu.serve import QueryScheduler as JScheduler
from tensorframes_tpu.serve import TenantQuota as JQuota
from tensorframes_tpu.utils import tracing as jtracing
from tensorframes_tpu_torch import memory as tmem
from tensorframes_tpu_torch import parallel as tpar
from tensorframes_tpu_torch import relational as trel
from tensorframes_tpu_torch import resilience as trz
from tensorframes_tpu_torch import stream as tstream
from tensorframes_tpu_torch.observability import events as tevents
from tensorframes_tpu_torch.parallel import elastic as telastic
from tensorframes_tpu_torch.parallel import exchange as tex
from tensorframes_tpu_torch.parallel.mesh import LogicalDevice
from tensorframes_tpu_torch.resilience import faults as tfaults
from tensorframes_tpu_torch.serve import QueryScheduler as TScheduler
from tensorframes_tpu_torch.serve import TenantQuota as TQuota
from tensorframes_tpu_torch.utils import tracing as ttracing

pytestmark = pytest.mark.elastic

F64 = 1e-12

J = SimpleNamespace(
    name="jax", tf=jtf, par=jpar, elastic=jelastic, faults=jfaults,
    rz=jrz, events=jevents, tracing=jtracing, counters=jtracing.counters,
    stream=jstream, rel=jrel, ex=jex, mem=jmem, Scheduler=JScheduler,
    Quota=JQuota)
T = SimpleNamespace(
    name="torch", tf=ttf, par=tpar, elastic=telastic, faults=tfaults,
    rz=trz, events=tevents, tracing=ttracing, counters=ttracing.counters,
    stream=tstream, rel=trel, ex=tex, mem=tmem, Scheduler=TScheduler,
    Quota=TQuota)
BOTH = (J, T)


def _reset(P):
    P.counters.reset()
    P.faults.reset()
    P.elastic._tracker.clear()
    P.elastic._upgrades.clear()
    P.elastic._lost_pool.clear()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("TFT_CPU_DEVICE_COUNT", "8")
    monkeypatch.setenv("TFT_ADAPTIVE", "0")
    monkeypatch.setenv("TFT_RESULT_CACHE", "0")
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    for P in BOTH:
        _reset(P)
    yield
    for P in BOTH:
        _reset(P)
        P.tracing.disable()
    jmem._reset()
    tmem._reset()
    ttf.set_default_device(prev)


def mesh(P, n=8):
    return P.par.local_mesh(n)


def both(fn):
    """``fn(P)`` through the JAX package and the port."""
    return fn(J), fn(T)


def ids_of(P, m):
    """The mesh's device ids, in flat order (``jax.Device.id`` / the
    port's logical ids)."""
    if P is J:
        return [int(d.id) for d in m.mesh.devices.flat]
    return m.flat_ids()


def int_frame(P, n=40, keys=5):
    return P.tf.frame({"k": np.arange(n) % keys, "x": np.arange(n)})


def col(frame, name):
    """One collected column of a (distributed) frame, exact numpy."""
    tf = frame.collect_frame() if hasattr(frame, "collect_frame") \
        else frame
    parts = [np.asarray(b.columns[name]) if tf.schema[name].dtype.tensor
             else np.asarray(b.columns[name], object)
             for b in tf.blocks()]
    return np.concatenate(parts) if parts else np.empty(0)


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(b, a)


def rows(frame):
    return [tuple(np.asarray(x).item() if np.ndim(x) == 0 else x
                  for x in r) for r in frame.collect()]


def shrink_events(P):
    t = P.events.last_query()
    return t, [ev for ev in t.events if ev.etype == "mesh_shrink"]


# ---------------------------------------------------------------------------
# classification + fault site
# ---------------------------------------------------------------------------

class TestClassification:
    def test_device_lost_markers(self):
        for P in BOTH:
            e = RuntimeError("DEVICE_LOST: device 2 halted")
            assert P.rz.is_device_lost(e)
            assert P.rz.error_kind(e) == "device_lost"
            assert not P.rz.is_transient(e)

    def test_device_lost_beats_transient_markers(self):
        for P in BOTH:
            e = RuntimeError("UNAVAILABLE: device lost during collective")
            assert P.rz.error_kind(e) == "device_lost"
            assert not P.rz.is_transient(e)

    def test_device_lost_exception_class(self):
        for P in BOTH:
            assert P.rz.error_kind(P.rz.DeviceLost("chip 3 gone")) == \
                "device_lost"

    def test_device_fault_site_default_shape(self):
        msgs = []
        for P in BOTH:
            P.faults.arm("device", 1)
            with pytest.raises(P.faults.InjectedFault) as ei:
                P.faults.check("device")
            assert P.rz.error_kind(ei.value) == "device_lost"
            assert "device 0" in str(ei.value)
            msgs.append(str(ei.value))
        assert msgs[1] == msgs[0]

    def test_device_fault_site_env_device(self, monkeypatch):
        monkeypatch.setenv("TFT_FAULT_DEVICE", "5")
        msgs = []
        for P in BOTH:
            P.faults.arm("device", 1)
            with pytest.raises(P.faults.InjectedFault) as ei:
                P.faults.check("device")
            assert "device 5" in str(ei.value)
            msgs.append(str(ei.value))
        assert msgs[1] == msgs[0]

    def test_tft_faults_env_arms_device_site(self, monkeypatch):
        monkeypatch.setenv("TFT_FAULTS", "device:1")
        for P in BOTH:
            monkeypatch.setattr(P.faults._state, "_armed_env", False)
            assert P.faults.active("device") == 1
            with pytest.raises(P.faults.InjectedFault) as ei:
                P.faults.check("device")
            assert P.rz.error_kind(ei.value) == "device_lost"

    def test_lost_device_ids_parsed_from_message(self):
        e = RuntimeError("DEVICE_LOST: device 6 is lost")
        j, t = both(lambda P: P.elastic.lost_device_ids(e, mesh(P)))
        assert j == t == [6]

    def test_lost_device_ids_defaults_to_zero(self):
        j, t = both(lambda P: P.elastic.lost_device_ids(
            RuntimeError("DEVICE_LOST"), mesh(P)))
        assert j == t == [0]


# ---------------------------------------------------------------------------
# device-loss recovery
# ---------------------------------------------------------------------------

class TestDeviceLossRecovery:
    def _assert_shrink_trace(self, P, lost_device=0):
        t, shr = shrink_events(P)
        assert len(shr) == 1
        assert shr[0].args["device"] == lost_device
        assert shr[0].args["devices_before"] == 8
        assert shr[0].args["devices_after"] == 7
        assert t.summary()["mesh_shrinks"] == 1
        return shr[0].args

    def _traced_loss(self, P, run):
        P.tracing.enable()
        try:
            with P.faults.inject("device", 1):
                return run()
        finally:
            P.tracing.disable()

    def test_dmap_blocks_bit_identical_after_loss(self):
        def run(P):
            dist = P.par.distribute(int_frame(P), mesh(P))
            healthy = col(P.par.dmap_blocks(lambda x: {"z": x * 2}, dist),
                          "z")
            out = self._traced_loss(
                P, lambda: P.par.dmap_blocks(lambda x: {"z": x * 2}, dist))
            same(healthy, col(out, "z"))
            assert out.mesh.num_devices == 7
            assert P.counters.get("mesh.devices_lost") == 1
            assert P.counters.get("mesh.reshard_rows") > 0
            return (col(out, "z"), self._assert_shrink_trace(P),
                    P.counters.get("mesh.reshard_rows"),
                    list(out.per_shard_valid()))

        j, t = both(run)
        same(j[0], t[0])
        assert t[1:] == j[1:]

    def test_daggregate_bit_identical_after_loss(self):
        def run(P):
            dist = P.par.distribute(int_frame(P), mesh(P))
            healthy = P.par.daggregate({"x": "sum"}, dist, "k").collect()
            out = self._traced_loss(
                P, lambda: P.par.daggregate({"x": "sum"}, dist, "k"))
            assert out.collect() == healthy
            assert P.counters.get("mesh.devices_lost") == 1
            return (col(out, "k"), col(out, "x"),
                    self._assert_shrink_trace(P))

        j, t = both(run)
        same(j[0], t[0])
        same(j[1], t[1])
        assert t[2] == j[2]

    def test_dsort_bit_identical_after_loss(self):
        def run(P):
            rng = np.random.default_rng(7)
            dist = P.par.distribute(P.tf.frame({"x": rng.permutation(40)}),
                                    mesh(P))
            healthy = col(P.par.dsort("x", dist, descending=True), "x")
            out = self._traced_loss(
                P, lambda: P.par.dsort("x", dist, descending=True))
            same(healthy, col(out, "x"))
            assert P.counters.get("mesh.devices_lost") == 1
            return col(out, "x"), self._assert_shrink_trace(P)

        j, t = both(run)
        same(j[0], t[0])
        assert t[1] == j[1]

    def test_dfilter_and_dreduce_recover(self):
        def run(P):
            dist = P.par.distribute(int_frame(P), mesh(P))
            with P.faults.inject("device", 1):
                flt = P.par.dfilter(lambda x: x % 2 == 0, dist)
            assert flt.count() == 20
            same(col(flt, "x"), np.arange(0, 40, 2))
            with P.faults.inject("device", 1):
                red = P.par.dreduce_blocks({"x": "sum"}, dist)
            assert int(red["x"]) == sum(range(40))
            assert P.counters.get("mesh.devices_lost") == 2
            return col(flt, "x"), red["x"], list(flt.per_shard_valid())

        j, t = both(run)
        same(j[0], t[0])
        same(j[1], t[1])
        assert t[2] == j[2]

    def test_named_device_is_the_one_dropped(self):
        def run(P):
            dist = P.par.distribute(int_frame(P), mesh(P))
            with P.faults.inject(
                    "device", 1,
                    message="DEVICE_LOST: injected: device 3 is lost"):
                out = P.par.dmap_blocks(lambda x: {"z": x + 1}, dist)
            ids = ids_of(P, out.mesh)
            assert 3 not in ids and len(ids) == 7
            return ids

        j, t = both(run)
        assert t == j

    def test_two_successive_losses(self):
        def run(P):
            dist = P.par.distribute(int_frame(P, 80), mesh(P))
            with P.faults.inject("device", 2):
                out = P.par.dmap_blocks(lambda x: {"z": x * 3}, dist)
            assert out.mesh.num_devices == 6
            assert P.counters.get("mesh.devices_lost") == 2
            assert P.counters.get("mesh.shrinks") == 2
            same(col(out, "z"), np.arange(80) * 3)
            return col(out, "z"), ids_of(P, out.mesh)

        j, t = both(run)
        same(j[0], t[0])
        assert t[1] == j[1]

    def test_loss_on_filtered_frame_keeps_shard_valid_rows(self):
        def run(P):
            dist = P.par.distribute(int_frame(P), mesh(P))
            flt = P.par.dfilter(lambda x: x % 2 == 0, dist)
            assert flt.shard_valid is not None
            with P.faults.inject("device", 1):
                out = P.par.dmap_blocks(lambda x: {"z": x + 100}, flt)
            same(col(out, "z"), np.arange(0, 40, 2) + 100)
            return col(out, "z"), P.counters.get("mesh.reshard_rows")

        j, t = both(run)
        same(j[0], t[0])
        assert t[1] == j[1]

    def test_host_string_columns_survive_reshard(self):
        def run(P):
            df = P.tf.frame({"s": np.array(list("abcdefghij"), object),
                             "x": np.arange(10)})
            dist = P.par.distribute(df, mesh(P))
            with P.faults.inject("device", 1):
                out = P.par.dmap_blocks(lambda x: {"z": x * 2}, dist)
            got = out.collect_frame().collect()
            assert [r["s"] for r in got] == list("abcdefghij")
            assert [r["z"] for r in got] == [i * 2 for i in range(10)]
            return col(out, "s"), col(out, "z")

        j, t = both(run)
        assert list(t[0]) == list(j[0])
        same(j[1], t[1])

    def test_elastic_disabled_raises(self, monkeypatch):
        monkeypatch.setenv("TFT_ELASTIC", "0")

        def run(P):
            dist = P.par.distribute(int_frame(P), mesh(P))
            with P.faults.inject("device", 1):
                with pytest.raises(P.faults.InjectedFault) as ei:
                    P.par.dmap_blocks(lambda x: {"z": x}, dist, trim=True)
            assert P.counters.get("mesh.devices_lost") == 0
            return str(ei.value)

        j, t = both(run)
        assert t == j

    def test_single_shard_mesh_reraises(self):
        def run(P):
            dist = P.par.distribute(P.tf.frame({"x": np.arange(4)}),
                                    mesh(P, 1))
            with P.faults.inject("device", 1):
                with pytest.raises(P.faults.InjectedFault) as ei:
                    P.par.dmap_blocks(lambda x: {"z": x}, dist, trim=True)
            return type(ei.value).__name__, str(ei.value)

        j, t = both(run)
        assert t == j

    def test_mesh_metrics_series_exported(self):
        from tensorframes_tpu.observability.metrics import \
            metrics_text as jtext
        from tensorframes_tpu_torch.observability.metrics import \
            metrics_text as ttext

        texts = []
        for P, text in ((J, jtext), (T, ttext)):
            dist = P.par.distribute(int_frame(P), mesh(P))
            with P.faults.inject("device", 1):
                P.par.dmap_blocks(lambda x: {"z": x + 1}, dist)
            out = text()
            assert "tft_mesh_devices_lost_total 1" in out
            assert "tft_mesh_shrinks_total 1" in out
            assert "tft_mesh_reshard_rows_total" in out
            texts.append(sorted(ln.split()[2] for ln in out.splitlines()
                                if ln.startswith("# TYPE tft_mesh_")
                                or ln.startswith("# TYPE tft_dplan_")))
        assert texts[1] == texts[0]

    def test_report_renders_shrink(self):
        for P in BOTH:
            dist = P.par.distribute(int_frame(P), mesh(P))
            P.tracing.enable()
            try:
                with P.faults.inject("device", 1):
                    P.par.daggregate({"x": "sum"}, dist, "k")
                rep = P.tf.last_query_report()
            finally:
                P.tracing.disable()
            assert "mesh shrunk 8 -> 7" in rep


# ---------------------------------------------------------------------------
# skew-adaptive repartitioning
# ---------------------------------------------------------------------------

class TestSkewRebalance:
    SKEWED = [0.001] * 7 + [0.01]

    def test_persistent_skew_repartitions_proportionally(self):
        def run(P):
            m = mesh(P)
            dist = P.par.distribute(P.tf.frame({"x": np.arange(80)}), m)
            for _ in range(3):
                P.elastic.note_dispatch(m, "dmap_blocks", self.SKEWED)
            out = P.par.dmap_blocks(lambda x: {"z": x + 1}, dist)
            rb = getattr(out, "_rebalance", None)
            assert rb is not None
            assert P.counters.get("mesh.rebalances") == 1
            assert sum(rb["after"]) == 80
            assert rb["after"][-1] == min(rb["after"])
            assert rb["after"][-1] < min(rb["before"])
            same(col(out, "z"), np.arange(80) + 1)
            assert "rebalance" in out.explain()
            return rb, col(out, "z"), list(out.per_shard_valid())

        j, t = both(run)
        assert t[0]["before"] == j[0]["before"]
        assert t[0]["after"] == j[0]["after"]
        assert t[0]["ratio"] == pytest.approx(j[0]["ratio"], rel=F64)
        same(j[1], t[1])
        assert t[2] == j[2] == j[0]["after"]

    def test_rebalance_acts_once_per_streak(self):
        def run(P):
            m = mesh(P)
            dist = P.par.distribute(P.tf.frame({"x": np.arange(80)}), m)
            for _ in range(3):
                P.elastic.note_dispatch(m, "op", self.SKEWED)
            P.par.dmap_blocks(lambda x: {"z": x}, dist, trim=True)
            out2 = P.par.dmap_blocks(lambda x: {"z": x}, dist, trim=True)
            assert getattr(out2, "_rebalance", None) is None
            return P.counters.get("mesh.rebalances")

        assert both(run) == (1, 1)

    def test_balanced_dispatch_resets_streak(self):
        def run(P):
            m = mesh(P)
            dist = P.par.distribute(P.tf.frame({"x": np.arange(80)}), m)
            for _ in range(2):
                P.elastic.note_dispatch(m, "op", self.SKEWED)
            P.elastic.note_dispatch(m, "op", [0.001] * 8)  # balanced
            P.elastic.note_dispatch(m, "op", self.SKEWED)
            out = P.par.dmap_blocks(lambda x: {"z": x}, dist, trim=True)
            assert getattr(out, "_rebalance", None) is None
            return (P.counters.get("mesh.rebalances"),
                    dict(P.elastic._tracker[P.elastic._mesh_key(m)]))

        j, t = both(run)
        assert t[0] == j[0] == 0
        assert t[1]["hits"] == j[1]["hits"] == 1
        np.testing.assert_allclose(t[1]["times"], j[1]["times"], rtol=F64)

    def test_rebalance_disabled_by_env(self, monkeypatch):
        monkeypatch.setenv("TFT_SKEW_REBALANCE_AFTER", "0")

        def run(P):
            m = mesh(P)
            for _ in range(5):
                P.elastic.note_dispatch(m, "op", self.SKEWED)
            dist = P.par.distribute(P.tf.frame({"x": np.arange(80)}), m)
            out = P.par.dmap_blocks(lambda x: {"z": x}, dist, trim=True)
            assert getattr(out, "_rebalance", None) is None
            return P.counters.get("mesh.rebalances"), \
                len(P.elastic._tracker)

        assert both(run) == ((0, 0), (0, 0))

    def test_rebalance_event_in_trace(self):
        def run(P):
            m = mesh(P)
            dist = P.par.distribute(P.tf.frame({"x": np.arange(80)}), m)
            for _ in range(3):
                P.elastic.note_dispatch(m, "dmap_blocks", self.SKEWED)
            P.tracing.enable()
            try:
                P.par.dmap_blocks(lambda x: {"z": x + 1}, dist)
            finally:
                P.tracing.disable()
            t = P.events.last_query()
            evs = [ev for ev in t.events if ev.etype == "rebalance"]
            assert len(evs) == 1
            assert sum(evs[0].args["after"]) == 80
            assert t.summary()["rebalances"] == 1
            # the traced dispatch timed every shard on its device track
            comp = [ev for ev in t.events if ev.etype == "shard_compute"]
            assert len(comp) == 8
            return dict(evs[0].args)

        j, t = both(run)
        assert t == j


# ---------------------------------------------------------------------------
# hot-key salting
# ---------------------------------------------------------------------------

class TestHotKeySalting:
    def _hot_frame(self, P, n=8_000):
        keys = np.zeros(n, np.int64)
        keys[: n // 5] = np.arange(n // 5) % 7 + 1  # key 0 holds 80%
        return P.tf.frame({"k": keys, "v": np.arange(n)})

    def _agg(self, P, df, cname):
        host = {r["k"]: r["v"] for r in
                P.tf.aggregate({"v": cname}, df.group_by("k")).collect()}
        out = P.par.daggregate({"v": cname},
                               P.par.distribute(df, mesh(P)), "k")
        return host, out

    def test_hot_key_salted_and_exact(self):
        def run(P):
            host, out = self._agg(P, self._hot_frame(P), "sum")
            assert P.counters.get("mesh.salted_keys") == 1
            assert {r["k"]: r["v"] for r in out.collect()} == host
            return col(out, "k"), col(out, "v")

        j, t = both(run)
        same(j[0], t[0])
        same(j[1], t[1])

    def test_salting_cached_per_frame(self):
        def run(P):
            dist = P.par.distribute(self._hot_frame(P), mesh(P))
            a1 = P.par.daggregate({"v": "sum"}, dist, "k").collect()
            a2 = P.par.daggregate({"v": "sum"}, dist, "k").collect()
            assert a1 == a2
            return P.counters.get("mesh.salted_keys")

        assert both(run) == (1, 1)

    def test_min_max_fold_back_exact(self):
        def run(P):
            host, out = self._agg(P, self._hot_frame(P), "min")
            assert {r["k"]: r["v"] for r in out.collect()} == host
            return col(out, "v")

        j, t = both(run)
        same(j, t)

    def test_no_hot_key_no_salting(self):
        def run(P):
            n = 8_000
            df = P.tf.frame({"k": np.arange(n) % 16, "v": np.arange(n)})
            P.par.daggregate({"v": "sum"}, P.par.distribute(df, mesh(P)),
                             "k")
            return P.counters.get("mesh.salted_keys")

        assert both(run) == (0, 0)

    def test_salting_disabled_by_env(self, monkeypatch):
        monkeypatch.setenv("TFT_SALT_HOT_KEYS", "0")

        def run(P):
            host, out = self._agg(P, self._hot_frame(P), "sum")
            assert P.counters.get("mesh.salted_keys") == 0
            assert {r["k"]: r["v"] for r in out.collect()} == host
            return col(out, "v")

        j, t = both(run)
        same(j, t)


# ---------------------------------------------------------------------------
# local_mesh validation
# ---------------------------------------------------------------------------

class TestLocalMeshValidation:
    def test_shape_validated_against_num_devices(self):
        for P in BOTH:
            with pytest.raises(ValueError, match=r"num_devices=4"):
                P.par.local_mesh(4, shape=(8,))

    def test_more_than_visible_raises_clearly(self):
        for P in BOTH:
            with pytest.raises(ValueError,
                               match=r"num_devices=16.*8 visible"):
                P.par.local_mesh(16)

    def test_shape_without_num_devices_names_visible(self):
        for P in BOTH:
            with pytest.raises(ValueError, match=r"3 device\(s\) but 8"):
                P.par.local_mesh(shape=(3,))

    def test_valid_combinations_still_work(self):
        for P in BOTH:
            assert P.par.local_mesh(4, shape=(4,)).num_devices == 4
            m = P.par.local_mesh(8)
            assert m.num_devices == 8
            assert ids_of(P, m) == list(range(8))


# ---------------------------------------------------------------------------
# device loss during streaming and serving
# ---------------------------------------------------------------------------

class TestStreamAndServeRideTheElasticPath:
    def test_stream_keeps_folding_through_device_loss(self):
        n_batches, nrows = 12, 64

        def run(P):
            def gen():
                for i in range(n_batches):
                    yield {"k": np.arange(nrows) % 4,
                           "v": np.full(nrows, i, np.int64)}

            agg = (P.stream.from_source(P.stream.GeneratorSource(gen()))
                   .group_by("k").aggregate({"v": "sum"}))
            handle = agg.start(name=f"elastic-stream-{P.name}") \
                .start_background(poll_interval=0.001)
            dist = P.par.distribute(int_frame(P, 80), mesh(P))
            with P.faults.inject("device", 1):
                out = P.par.dmap_blocks(lambda x: {"z": x * 2}, dist)
            assert out.mesh.num_devices == 7
            deadline = time.monotonic() + 30
            while not handle.done() and time.monotonic() < deadline:
                time.sleep(0.01)
            handle.stop()
            m = handle.metrics()
            assert m["batches"] == n_batches
            assert m["batches_skipped"] == 0
            assert m["rows"] == n_batches * nrows
            got = {r["k"]: r["v"] for fr in handle.collect_updates()
                   for r in fr.collect()}
            per_key = sum(range(n_batches)) * (nrows // 4)
            assert got == {k: per_key for k in range(4)}
            assert P.counters.get("mesh.devices_lost") == 1
            return got

        j, t = both(run)
        assert t == j

    def test_stream_batch_device_lost_retried_once(self):
        def run(P):
            def gen():
                for i in range(3):
                    yield {"v": np.arange(4.0) + i}

            sf = P.stream.from_source(P.stream.GeneratorSource(gen()))
            handle = sf.start(name=f"dl-retry-{P.name}")
            with P.faults.inject("batch", 1,
                                 message="DEVICE_LOST: device 1 is lost",
                                 transient=False):
                n = handle.run()
            assert n == 3
            m = handle.metrics()
            assert m["batches"] == 3
            assert m["batches_skipped"] == 0
            return P.counters.get("stream.device_lost_retries")

        assert both(run) == (1, 1)

    def test_serve_mix_completes_through_device_loss(self):
        def run(P):
            quotas = {"a": P.Quota(weight=1.0), "b": P.Quota(weight=2.0)}
            with P.Scheduler(quotas=quotas, workers=2,
                             name=f"elastic-serve-{P.name}") as sched:
                futs = []
                for i in range(6):
                    fr = P.tf.frame({"x": np.arange(32.0) + i})
                    futs.append((i, sched.submit(
                        fr, lambda x: {"z": x + 1.0},
                        tenant="a" if i % 2 else "b")))
                dist = P.par.distribute(int_frame(P, 80), mesh(P))
                with P.faults.inject("device", 1):
                    out = P.par.dmap_blocks(lambda x: {"z": x * 2}, dist)
                assert out.mesh.num_devices == 7
                same(col(out, "z"), np.arange(80) * 2)
                got = []
                for i, fut in futs:
                    res = fut.result(timeout=30)
                    vals = [r["z"] for r in res.collect()]
                    assert vals == list(np.arange(32.0) + i + 1.0)
                    got.append(vals)
            assert P.counters.get("mesh.devices_lost") == 1
            return got, col(out, "z")

        j, t = both(run)
        assert t[0] == j[0]
        same(j[1], t[1])

    def test_serve_thunk_device_lost_retried_once(self):
        def run(P):
            with P.Scheduler(workers=0, name=f"dl-serve-{P.name}") as sched:
                fr = P.tf.frame({"x": np.arange(8.0)})
                fut = sched.submit(fr, lambda x: {"z": x + 1.0},
                                   tenant="t")
                P.tracing.enable()
                try:
                    with P.faults.inject(
                            "dispatch", 1,
                            message="DEVICE_LOST: device 0 is lost",
                            transient=False):
                        assert sched.step()
                finally:
                    P.tracing.disable()
                res = fut.result(timeout=30)
                assert [r["z"] for r in res.collect()] == \
                    list(np.arange(8.0) + 1.0)
            t = P.events.last_query()
            retry = [ev for ev in t.events
                     if ev.etype == "device_lost_retry"]
            return (P.counters.get("serve.device_lost_retries"),
                    len(retry))

        assert both(run) == ((1, 1), (1, 1))


# ---------------------------------------------------------------------------
# reshard invariants
# ---------------------------------------------------------------------------

class TestReshard:
    def test_prefix_reshard_preserves_order(self):
        def run(P):
            dist = P.par.distribute(int_frame(P, 20), mesh(P))
            small = P.elastic.shrink_mesh(dist.mesh, [2])
            out = P.elastic.reshard(dist, small)
            assert out.num_rows == 20
            assert out.mesh.num_data_shards == 7
            same(col(out, "x"), np.arange(20))
            return (ids_of(P, small), list(out.per_shard_valid()),
                    out.padded_rows)

        j, t = both(run)
        assert t == j

    def test_explicit_shard_rows_layout(self):
        rows_ = np.array([4, 4, 2, 2, 2, 1, 1, 0])

        def run(P):
            dist = P.par.distribute(int_frame(P, 16), mesh(P))
            out = P.elastic.reshard(dist, dist.mesh, shard_rows=rows_)
            assert list(out.per_shard_valid()) == list(rows_)
            same(col(out, "x"), np.arange(16))
            return out.host_read_padded("x"), out.padded_rows

        j, t = both(run)
        same(j[0], t[0])
        assert t[1] == j[1]

    def test_bad_shard_rows_rejected(self):
        msgs = []
        for P in BOTH:
            dist = P.par.distribute(int_frame(P, 16), mesh(P))
            with pytest.raises(ValueError, match="does not distribute") \
                    as ei:
                P.elastic.reshard(dist, dist.mesh,
                                  shard_rows=np.array([1] * 8))
            msgs.append(str(ei.value))
        assert msgs[1] == msgs[0]

    def test_shrink_rejects_non_data_mesh(self):
        msgs = []
        for P in BOTH:
            m = P.par.local_mesh(8, axis_names=("data", "model"),
                                 shape=(4, 2))
            with pytest.raises(ValueError, match="data-only") as ei:
                P.elastic.shrink_mesh(m, [0])
            msgs.append(str(ei.value))
        assert msgs[1] == msgs[0]

    def test_shrink_keeps_non_leading_data_axis(self):
        from jax.sharding import Mesh

        jm = jpar.DeviceMesh(Mesh(np.array(jax.devices()).reshape(1, 8),
                                  ("model", "data")), data_axis="data")
        tm = tpar.DeviceMesh(np.array([torch.device("cpu")] * 8,
                                      dtype=object).reshape(1, 8),
                             ("model", "data"), data_axis="data")
        js = jelastic.shrink_mesh(jm, [2])
        ts = telastic.shrink_mesh(tm, [2])
        assert dict(js.mesh.shape) == ts.shape == {"model": 1, "data": 7}
        assert ts.num_data_shards == js.num_data_shards == 7
        assert ts.flat_ids() == ids_of(J, js)

    def test_loss_after_rebalance_drops_stale_record(self):
        def run(P):
            m = mesh(P)
            dist = P.par.distribute(P.tf.frame({"x": np.arange(80)}), m)
            for _ in range(3):
                P.elastic.note_dispatch(m, "dmap_blocks",
                                        [0.001] * 7 + [0.01])
            with P.faults.inject("device", 1):
                out = P.par.dmap_blocks(lambda x: {"z": x + 1}, dist)
            assert out.mesh.num_devices == 7
            assert getattr(out, "_rebalance", None) is None
            same(col(out, "z"), np.arange(80) + 1)
            return (P.counters.get("mesh.rebalances"),
                    P.counters.get("mesh.reshard_rows"))

        j, t = both(run)
        assert t == j


# ---------------------------------------------------------------------------
# elastic mesh growth: probe + admit + migrate + churn
# ---------------------------------------------------------------------------

@pytest.mark.preempt
class TestElasticGrowth:
    def test_admit_devices_grows_and_stays_bit_identical(self):
        def run(P):
            dist = P.par.distribute(int_frame(P), mesh(P, 6))
            healthy = col(P.par.dmap_blocks(lambda x: {"z": x * 2}, dist),
                          "z")
            P.tracing.enable()
            try:
                grown = P.par.admit_devices(dist)
            finally:
                P.tracing.disable()
            assert grown.mesh.num_devices == 8
            got = col(P.par.dmap_blocks(lambda x: {"z": x * 2}, grown), "z")
            same(healthy, got)
            assert P.counters.get("mesh.grows") == 1
            assert P.counters.get("mesh.devices_admitted") == 2
            return got, ids_of(P, grown.mesh), list(grown.per_shard_valid())

        j, t = both(run)
        same(j[0], t[0])
        assert t[1:] == j[1:]

    def test_grow_mesh_is_inverse_of_shrink(self):
        jm, tm = mesh(J), mesh(T)
        jsmall = jelastic.shrink_mesh(jm, [3])
        tsmall = telastic.shrink_mesh(tm, [3])
        jlost = jm.mesh.devices.flat[3]
        tlost = tm.logical_devices()[3]
        jback = jelastic.grow_mesh(jsmall, [jlost])
        tback = telastic.grow_mesh(tsmall, [tlost])
        assert tback.num_devices == jback.num_devices == 8
        assert tlost in tback.logical_devices()
        assert tback.flat_ids() == ids_of(J, jback)
        # idempotent: already-member devices are ignored
        assert jelastic.grow_mesh(jback, [jlost]) is jback
        assert telastic.grow_mesh(tback, [tlost]) is tback

    def test_other_frames_migrate_at_next_dispatch(self):
        def run(P):
            m6 = mesh(P, 6)
            a = P.par.distribute(int_frame(P), m6)
            b = P.par.distribute(int_frame(P), m6)  # same mesh, untouched
            P.par.admit_devices(a)
            out = P.par.dmap_blocks(lambda x: {"z": x + 1}, b)
            assert out.mesh.num_devices == 8
            assert P.counters.get("mesh.grow_migrations") == 1
            same(col(out, "z"), np.arange(40) + 1)
            return ids_of(P, out.mesh), list(out.per_shard_valid())

        j, t = both(run)
        assert t == j

    def test_fresh_user_mesh_not_captured_by_old_upgrade(self):
        def run(P):
            a = P.par.distribute(int_frame(P), mesh(P, 6))
            P.par.admit_devices(a)
            b = P.par.distribute(int_frame(P), mesh(P, 6))
            out = P.par.dmap_blocks(lambda x: {"z": x + 1}, b)
            assert out.mesh.num_devices == 6  # not migrated
            return P.counters.get("mesh.grow_migrations")

        assert both(run) == (0, 0)

    def test_default_candidates_prefer_lost_devices(self):
        def run(P):
            dist = P.par.distribute(int_frame(P), mesh(P, 6))
            with P.faults.inject(
                    "device", 1,
                    message="DEVICE_LOST: injected: device 2 is lost"):
                out = P.par.dmap_blocks(lambda x: {"z": x + 1}, dist)
            assert out.mesh.num_devices == 5
            assert P.elastic.lost_pool() == [2]
            regrown = P.par.admit_devices(
                P.par.distribute(int_frame(P), out.mesh))
            assert regrown.mesh.num_devices == 6
            ids = sorted(ids_of(P, regrown.mesh))
            assert ids == [0, 1, 2, 3, 4, 5]
            assert P.counters.get("mesh.devices_admitted") == 1
            assert P.elastic.lost_pool() == []
            return ids_of(P, regrown.mesh)

        j, t = both(run)
        assert t == j

    def test_admit_on_mesh_returns_grown_mesh(self):
        def run(P):
            grown = P.par.admit_devices(mesh(P, 6))
            assert isinstance(grown, P.par.DeviceMesh)
            assert grown.num_devices == 8
            return ids_of(P, grown)

        j, t = both(run)
        assert t == j

    def test_no_candidates_is_a_no_op(self):
        def run(P):
            dist = P.par.distribute(int_frame(P), mesh(P))
            assert P.par.admit_devices(dist) is dist
            return P.counters.get("mesh.grows")

        assert both(run) == (0, 0)

    def test_failed_probe_is_not_admitted(self):
        class DeadChip:
            id = 99

            def __repr__(self):
                return "DeadChip(99)"

        def run(P):
            m6 = mesh(P, 6)
            assert P.elastic.probe_device(DeadChip()) is False
            grown = P.par.admit_devices(m6, devices=[DeadChip()])
            assert grown is m6  # unchanged: nothing passed the probe
            return (P.counters.get("mesh.admit_probe_failures"),
                    P.counters.get("mesh.grows"))

        assert both(run) == ((1, 0), (1, 0))

    @pytest.mark.timing
    def test_admit_probe_timeout_bounded(self, monkeypatch):
        from conftest import timing_margin

        real_put = jax.device_put

        def hung_put(x, device=None, **kw):
            time.sleep(1.5)
            return real_put(x)

        real_transfer = telastic._probe_transfer

        def hung_transfer(dev):
            time.sleep(1.5)
            return real_transfer(dev)

        monkeypatch.setattr(jax, "device_put", hung_put)
        monkeypatch.setattr(telastic, "_probe_transfer", hung_transfer)
        for probe, dev in ((jelastic.probe_device, jax.devices()[0]),
                           (telastic.probe_device, torch.device("cpu"))):
            t0 = time.monotonic()
            ok = probe(dev, timeout_s=0.2)
            elapsed = time.monotonic() - t0
            assert ok is False
            assert elapsed <= timing_margin(5.0), \
                f"probe timeout took {elapsed:.2f}s"

    def test_admit_clears_stale_skew_penalties(self):
        for P in BOTH:
            m6, m8 = mesh(P, 6), mesh(P, 8)
            for _ in range(3):
                P.elastic.note_dispatch(m6, "dmap_blocks",
                                        [0.001] * 5 + [0.01])
                P.elastic.note_dispatch(m8, "dmap_blocks",
                                        [0.001] * 7 + [0.01])
            assert P.elastic._tracker
            P.par.admit_devices(m6)
            assert P.elastic._mesh_key(m6) not in P.elastic._tracker
            assert P.elastic._mesh_key(m8) not in P.elastic._tracker

    def test_shrink_forgets_upgrades_onto_lost_devices(self):
        for P in BOTH:
            P.par.admit_devices(mesh(P, 6))
            assert P.elastic._upgrades
            dist = P.par.distribute(int_frame(P), mesh(P))
            with P.faults.inject(
                    "device", 1,
                    message="DEVICE_LOST: injected: device 6 is lost"):
                P.par.dmap_blocks(lambda x: {"z": x + 1}, dist)
            assert not P.elastic._upgrades

    def test_grow_event_in_trace_and_report(self):
        def run(P):
            dist = P.par.distribute(int_frame(P), mesh(P, 6))
            P.tracing.enable()
            try:
                with P.events.query_trace("test_grow"):
                    grown = P.par.admit_devices(dist)
                t = P.events.last_query()
            finally:
                P.tracing.disable()
            assert grown.mesh.num_devices == 8
            grows = [ev for ev in t.events if ev.etype == "mesh_grow"]
            assert len(grows) == 1
            assert grows[0].args["devices_before"] == 6
            assert grows[0].args["devices_after"] == 8
            assert t.summary()["mesh_grows"] == 1
            assert "re-admitted" in t.report()
            return dict(grows[0].args)

        j, t = both(run)
        assert t == j

    def test_churn_shrink_grow_shrink_zero_lost_rows(self):
        def run(P):
            df = int_frame(P, 80)
            healthy = P.par.distribute(df, mesh(P))
            h_map = col(P.par.dmap_blocks(lambda x: {"z": x * 2}, healthy),
                        "z")
            h_filter = col(P.par.dfilter(lambda x: x % 3 == 0, healthy),
                           "x")
            h_sort = col(P.par.dsort("x", healthy, descending=True), "x")
            h_red = int(P.par.dreduce_blocks({"x": "sum"}, healthy)["x"])
            h_agg = P.par.daggregate({"x": "sum"}, healthy, "k").collect()

            dist = P.par.distribute(df, mesh(P))
            with P.faults.inject("device", 1):
                out = P.par.dmap_blocks(lambda x: {"z": x * 2}, dist)
            assert out.mesh.num_devices == 7
            same(col(out, "z"), h_map)
            dist = P.par.admit_devices(P.par.distribute(df, out.mesh))
            assert dist.mesh.num_devices == 8
            same(col(P.par.dfilter(lambda x: x % 3 == 0, dist), "x"),
                 h_filter)
            same(col(P.par.dsort("x", dist, descending=True), "x"), h_sort)
            assert int(P.par.dreduce_blocks({"x": "sum"}, dist)["x"]) == \
                h_red
            assert P.par.daggregate({"x": "sum"}, dist, "k").collect() == \
                h_agg
            with P.faults.inject("device", 1):
                out2 = P.par.dmap_blocks(lambda x: {"z": x * 2}, dist)
            assert out2.mesh.num_devices == 7
            same(col(out2, "z"), h_map)  # zero lost, zero duplicated
            assert P.counters.get("mesh.grows") >= 1
            assert P.counters.get("mesh.devices_lost") == 2
            return ids_of(P, dist.mesh), ids_of(P, out2.mesh)

        j, t = both(run)
        assert t == j


class TestDeviceTypeIdentity:
    """The port's own: every explicit mesh numbers its slots from 0, so an
    id alone names no device across meshes. The lost pool and the skew
    tracker key by id and device, and a mesh grows only by devices of its
    own type. The card mesh here is built and never dispatched to."""

    @staticmethod
    def card_mesh(n=8):
        return tpar.DeviceMesh(np.array([torch.device("cuda", 0)] * n,
                                        dtype=object))

    def test_lost_cpu_slot_never_joins_a_card_mesh(self):
        cpu0 = LogicalDevice(0, torch.device("cpu"))
        card0 = LogicalDevice(0, torch.device("cuda", 0))
        dist = tpar.distribute(int_frame(T), mesh(T))
        with tfaults.inject("device", 1,
                            message="DEVICE_LOST: injected: device 0 is "
                                    "lost"):
            tpar.dmap_blocks(lambda x: {"z": x + 1}, dist)
        assert telastic._lost_pool == {cpu0}
        small = telastic.shrink_mesh(self.card_mesh(), [0])
        # the pool's slot 0 is the CPU mesh's, and no visible device is a
        # card here: nothing to admit
        assert tpar.admit_devices(small, probe=False) is small
        assert tpar.admit_devices(small, devices=[cpu0]) is small
        assert T.counters.get("mesh.admit_probe_failures") == 0
        with pytest.raises(ValueError, match="device type"):
            tpar.grow_mesh(small, [cpu0])
        # the card's own lost slot 0 comes back; the CPU's stays pooled
        telastic._lost_pool.add(card0)
        grown = tpar.admit_devices(small, probe=False)
        assert grown.flat_ids() == [1, 2, 3, 4, 5, 6, 7, 0]
        assert all(d.type == "cuda" for d in grown.shard_devices())
        assert telastic._lost_pool == {cpu0}
        assert telastic.lost_pool() == [0]

    def test_skew_on_a_cpu_mesh_leaves_a_card_mesh_alone(self):
        cpu, card = mesh(T), self.card_mesh()
        assert cpu.flat_ids() == card.flat_ids()
        for _ in range(3):
            telastic.note_dispatch(cpu, "dmap_blocks", [0.001] * 7 + [0.01])
        assert telastic._mesh_key(cpu) in telastic._tracker
        assert telastic._mesh_key(card) not in telastic._tracker

    @pytest.mark.parametrize("ticks,want", [
        (range(1, 9), [1.0] * 8),
        ([1, 2, 3, 4, 5, 6, 7, 10], [1.0] * 7 + [3.0]),
        ([4, 5, 6, 7, 8, 9, 10, 11], [4.0] * 8)])
    def test_shards_of_one_device_time_their_own_work(self, monkeypatch,
                                                      ticks, want):
        """Shards sharing a device run one after another: each one's time
        is its own finish less its predecessor's, in the running-maximum
        form the tracker takes. Equal shards read as balanced, not as the
        ramp of their raw finishes (whose max/median is 2S/(S+1))."""
        from tensorframes_tpu_torch.parallel import distributed

        clock = iter([0.0] + [float(t) for t in ticks])
        monkeypatch.setattr(distributed, "time",
                            SimpleNamespace(perf_counter=lambda: next(clock)))
        sc = distributed._ShardClock(SimpleNamespace(clock=lambda: 0.0),
                                     mesh(T))
        for _ in range(8):
            sc.mark()
        got = sc.durations()
        assert got == want
        telastic.note_dispatch(mesh(T), "dmap_blocks", got)
        assert bool(telastic._tracker) == (max(want) / min(want) > 2.0)


# ---------------------------------------------------------------------------
# device loss in the shuffle, the joins and the sketch aggregate
# ---------------------------------------------------------------------------

def shard_slices(ex, name):
    """Per-shard valid rows of one column of an exchanged frame."""
    S = ex.mesh.num_data_shards
    rp = ex.padded_rows // S
    c = np.asarray(ex.host_read_padded(name))
    valid = ex.per_shard_valid()
    return [c[s * rp: s * rp + int(valid[s])] for s in range(S)]


def join_frames(P, seed, nl, nr):
    rng = np.random.default_rng(seed)
    lc = {"k": rng.integers(0, 60, nl).astype(np.int64),
          "lv": rng.standard_normal(nl),
          "ltag": np.array([f"L{i}" for i in range(nl)], object)}
    rc = {"k": rng.integers(0, 60, nr).astype(np.int64),
          "rv": rng.standard_normal(nr),
          "rtag": np.array([f"R{i}" for i in range(nr)], object)}
    return (P.tf.frame(lc, num_partitions=3),
            P.tf.frame(rc, num_partitions=2))


class TestShuffleDeviceLoss:
    def test_device_loss_zero_lost_rows(self):
        keys = np.random.default_rng(42).integers(0, 90, 640) \
            .astype(np.int64)

        def run(P):
            df = P.tf.frame({"k": keys,
                             "i": np.arange(640, dtype=np.int64)})
            with P.faults.inject("device", 1):
                ex = P.ex.dexchange("k", P.par.distribute(df, mesh(P)))
            assert P.counters.get("mesh.devices_lost") == 1
            S = ex.mesh.num_data_shards
            assert S == 7  # shrunk
            idx = np.concatenate(shard_slices(ex, "i"))
            assert sorted(idx.tolist()) == list(range(640))
            pred = (P.ex.exchange_hash_host([keys]) % np.uint64(S)) \
                .astype(int)
            for s in range(S):
                assert np.array_equal(shard_slices(ex, "k")[s],
                                      keys[pred == s])
            return shard_slices(ex, "i"), list(ex.per_shard_valid())

        j, t = both(run)
        assert t[1] == j[1]
        for a, b in zip(j[0], t[0]):
            same(a, b)

    def test_partitioned_join_device_loss_bit_identity(self):
        def run(P):
            left, right = join_frames(P, 42, 500, 220)
            oracle = rows(P.rel.broadcast_join(left, right, "k",
                                               how="inner"))
            with P.faults.inject("device", 1):
                p = P.rel.partitioned_hash_join(left, right, "k",
                                                how="inner", mesh=mesh(P))
                got = rows(p)
            assert got == oracle
            assert P.counters.get("mesh.devices_lost") == 1
            return got

        j, t = both(run)
        assert t == j

    def test_shuffle_daggregate_device_loss_recovers(self):
        rng = np.random.default_rng(42)
        keys = rng.integers(0, 30, 500).astype(np.int64)
        vals = rng.integers(0, 50, 500).astype(np.int64)

        def run(P):
            df = P.tf.frame({"k": keys, "v": vals})
            oracle = rows(P.par.daggregate(
                {"v": "sum"}, P.par.distribute(df, mesh(P)), ["k"]))
            with P.faults.inject("device", 1):
                got = rows(P.par.shuffle_daggregate(
                    {"v": "sum"}, P.par.distribute(df, mesh(P)), ["k"]))
            assert got == oracle
            return got

        j, t = both(run)
        assert t == j

    def test_sort_merge_join_device_loss_bit_identical(self):
        rng = np.random.default_rng(8)
        lk = rng.integers(0, 10, 64).astype(np.int64)
        rk = rng.integers(0, 10, 32).astype(np.int64)

        def run(P):
            left = P.tf.frame({"k": lk, "v": np.arange(64, dtype=np.int64)},
                              num_partitions=4)
            right = P.tf.frame({"k": rk,
                                "w": np.arange(32, dtype=np.int64)})
            healthy = rows(P.rel.sort_merge_join(left, right, on="k",
                                                 how="left", mesh=mesh(P)))
            with P.faults.inject("device", 1):
                wounded = rows(P.rel.sort_merge_join(
                    left, right, on="k", how="left", mesh=mesh(P)))
            assert P.counters.get("mesh.devices_lost") > 0
            assert str(wounded) == str(healthy)
            return wounded

        j, t = both(run)
        assert str(t) == str(j)

    def test_sketch_daggregate_elastic_recovery(self):
        rng = np.random.default_rng(5)
        cols = {"g": rng.integers(0, 3, 4096).astype(np.int64),
                "x": rng.lognormal(0.0, 1.5, 4096),
                "it": rng.integers(0, 500, 4096).astype(np.int64)}

        def run(P):
            df = P.tf.frame(cols, num_partitions=4)
            fetches = {"it": P.rel.approx_distinct(bits=10)}
            healthy = sorted(rows(P.par.daggregate(
                fetches, P.par.distribute(df, mesh(P)), "g")))
            with P.faults.inject("device", 1):
                wounded = sorted(rows(P.par.daggregate(
                    fetches, P.par.distribute(df, mesh(P)), "g")))
            assert wounded == healthy
            return wounded

        j, t = both(run)
        assert t == j


# ---------------------------------------------------------------------------
# mesh frames as spill candidates of the memory ledger
# ---------------------------------------------------------------------------

class TestSpilledMeshFrames:
    def _frame(self, P, n=8192):
        rng = np.random.default_rng(42)
        return P.tf.frame(
            {"k": rng.integers(0, 500, n).astype(np.int64),
             "v": rng.random(n)}, num_partitions=4)

    def test_spilled_frame_collects_without_faulting(self):
        def run(P):
            P.mem.configure(limit_bytes=16 * 1024)
            dist = P.par.distribute(self._frame(P), mesh(P, 4))
            assert dist.columns.mem_is_spilled()  # registration spilled it
            f0 = P.counters.get("memory.faults")
            assert dist.padded_rows == 8192
            out = dist.collect_frame()
            assert out.count() == 8192
            assert P.counters.get("memory.faults") == f0, \
                "collect_frame re-resident a spilled frame"
            assert dist.columns.mem_is_spilled()
            return col(out, "k"), col(out, "v")

        j, t = both(run)
        same(j[0], t[0])
        same(j[1], t[1])

    def test_dmap_result_copies_through_accessors(self):
        def run(P):
            P.mem.configure(limit_bytes=10 ** 9)
            dist = P.par.distribute(self._frame(P, n=512), mesh(P, 4))
            dist.columns.mem_spill()
            out = P.par.dmap_blocks(lambda v: {"z": v + 1.0}, dist)
            got = out.collect_frame()
            assert got.count() == 512
            assert all(c is not None for c in
                       (out.columns[n] for n in out.columns))
            return col(got, "z")

        j, t = both(run)
        same(j, t)

    def test_spilled_shards_fault_back_onto_their_devices(self):
        """The port's shard-by-shard spill: each shard to its own host
        buffer and back onto the device it came from, the frame's layout
        kept, bit for bit."""
        tmem.configure(limit_bytes=10 ** 9)
        dist = tpar.distribute(self._frame(T, n=1000), mesh(T, 4))
        before = {n: [s.clone() for s in dist.columns[n].shards]
                  for n in ("k", "v")}
        assert dist.columns.mem_spill() > 0
        assert dist.columns.mem_is_spilled()
        same(dist.host_read_padded("v"),
             np.concatenate([s.numpy() for s in before["v"]]))
        for n, shards in before.items():
            got = dist.columns[n]  # faults back
            assert len(got.shards) == 4
            for a, b in zip(shards, got.shards):
                assert a.device == b.device and a.dtype == b.dtype
                assert torch.equal(a, b)
        assert not dist.columns.mem_is_spilled()


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 2e, rehearsed on CPU shards at a small size
# ---------------------------------------------------------------------------

def test_phase_elastic_rehearsal(monkeypatch):
    """``chip_smoke.phase_elastic`` on 8 logical CPU shards at 1% of its
    size, with ``torch.cuda.synchronize`` stubbed and a segment_sum launch
    counted for every float segment sum (the CPU runs B1's plain
    version). Untraced, unlike the card's run: the host clock's shard
    times on a loaded CPU are noise, and the phase holds the layout
    unmoved outside part (c), whose skew is synthetic."""
    import chip_smoke

    from tensorframes_tpu_torch.engine import ops as engine_ops
    from tensorframes_tpu_torch.ops import segment_reduce

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    real_sum = engine_ops._segment_sum

    def counted(values, ids, num_segments):
        if values.is_floating_point():
            segment_reduce.launches += 1
        return real_sum(values, ids, num_segments)

    monkeypatch.setattr(engine_ops, "_segment_sum", counted)
    out = chip_smoke.phase_elastic(
        ttf, np, torch, segment_reduce, n=200_000, keys=1_000,
        max_groups=2_048, stream_rows=40_000, stream_batch=4_000,
        stream_keys=100, device="cpu")
    assert out["device_loss"]["dmap_blocks"]["reshard_rows"] == 25_000
    assert out["device_loss"]["dmap_blocks"]["per_shard_valid"] == \
        [28_572] * 6 + [28_568]
    for name in ("daggregate_host_keys", "daggregate_device_keys"):
        assert out["device_loss"][name]["launches"] == 7
    assert out["growth"]["ids"] == [0, 1, 3, 4, 5, 6, 7, 2]
    valid = out["rebalance"]["per_shard_valid"]
    assert sum(valid) == 200_000 and valid[-1] < valid[0]
    assert len(out["idle_cost"]["on"]) == len(out["idle_cost"]["bypass"])
    fused = out["fused_plan"]["map_aggregate"]
    assert fused["lazy"]["launches"] == 8
    assert fused["eager"]["counts"]["mesh.dispatches"] == 2
    assert out["stream_mesh"]["launches"] == \
        8 * out["stream_mesh"]["folds"] > 0
