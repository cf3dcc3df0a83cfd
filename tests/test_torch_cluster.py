"""The multi-process cluster of the port (``parallel/cluster.py``) against
the JAX package's.

ONE pair of real processes joins over ``torch.distributed`` (gloo on the
CPU, 4 shards each, so an 8-shard global mesh) and runs the JAX package's
cluster worker's ten steps (``tests/cluster_worker.py``) at its sizes:
rank 0 holds 23 rows and rank 1 17, keys ``% 5``, the composite's second
key ``% 3``. Each rank checks each step against numpy over the global rows
and prints a digest of its result; here each step is its own case, and
the two ranks' digests must be equal (bit-identical results). The rank
program is ``chip_smoke.CLUSTER_RANK``, the one phase ``cluster_2x4_20M``
runs on the card at 20M rows.

In-process cases hold ``distribute_local``'s layout, and the reduces and
aggregates over it, against the JAX package's on 8 CPU devices; the
bootstrap's policy against ``tests/test_resilience.py::
TestClusterResilience``; and the backend choice. None of them leaves a
process group up in the test process.
"""

import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from conftest import timing_margin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import tensorframes_tpu_torch as ttf  # noqa: E402
from tensorframes_tpu import parallel as jpar  # noqa: E402
from tensorframes_tpu import resilience as jrz  # noqa: E402
from tensorframes_tpu.utils.tracing import counters as jcounters  # noqa: E402
from tensorframes_tpu_torch import parallel as tpar  # noqa: E402
from tensorframes_tpu_torch import resilience as trz  # noqa: E402
from tensorframes_tpu_torch.parallel import cluster  # noqa: E402
from tensorframes_tpu_torch.utils.tracing import counters  # noqa: E402

from cluster_worker import STEP_NAMES  # noqa: E402  the JAX worker's steps

STEPS = list(chip_smoke.CLUSTER_STEPS)
CLUSTER_ENV = ("TFT_COORDINATOR", "TFT_NUM_PROCESSES", "TFT_PROCESS_ID",
               "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
               "TFT_REQUIRE_CLUSTER", "TFT_DIST_BACKEND")


@pytest.fixture(autouse=True)
def _single_process(monkeypatch):
    """No cluster configured, the port on the CPU, fast retries; and no
    process group left behind by any case."""
    for var in CLUSTER_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TFT_RETRY_BASE_DELAY", "0.001")
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    counters.reset()
    jcounters.reset()
    yield
    ttf.set_default_device(prev)
    alive = tdist.is_initialized()
    cluster.shutdown()
    assert not alive, "a case left a process group up"


# -- the two-process pair ----------------------------------------------------

def worker_config(ckpt, steps=STEPS, backend=None):
    return {"device": "cpu", "shards": 4, "rows": [23, 17],
            "data": "worker", "seed": 0, "max_groups": 8,
            "composite_groups": 16, "below": 500.0, "ckpt": ckpt,
            "steps": list(steps), "backend": backend}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The pair, spawned once; both ranks are killed (and the module
    fails) past the wall limit."""
    ckpt = str(tmp_path_factory.mktemp("cluster") / "ckpt")
    t0 = time.perf_counter()
    try:
        runs = chip_smoke.run_cluster(
            worker_config(ckpt), world=2, timeout=120,
            env={"TFT_BOOTSTRAP_TIMEOUT": "60", "JAX_PLATFORMS": "cpu"})
    except TimeoutError as e:
        pytest.fail(f"the cluster pair timed out: {e}")
    return runs, time.perf_counter() - t0


def test_the_step_list_is_the_jax_workers():
    assert STEPS == STEP_NAMES


@pytest.mark.parametrize("step", STEPS)
def test_cluster_step(pair, step):
    runs, _ = pair
    digests = []
    for rank, run in enumerate(runs):
        rep = run["report"]
        assert rep is not None, (f"rank {rank} printed no report "
                                 f"(rc={run['rc']}):\n{run['out'][-3000:]}")
        assert rep["backend"] == "gloo" and rep["multi"] is True
        assert f"[rank {rank}] STEP {step} OK" in run["out"], (
            f"step {step!r} on rank {rank}:\n{run['out'][-3000:]}")
        digests.append(rep["steps"][step]["digest"])
    # every rank folds the same partials in the same order
    assert digests[0] == digests[1], f"{step}: ranks differ"


def test_cluster_ranks_exit_clean(pair):
    runs, wall = pair
    for rank, run in enumerate(runs):
        assert run["rc"] == 0, f"rank {rank}:\n{run['out'][-3000:]}"
        rep = run["report"]
        assert rep["rows_here"] == (23, 17)[rank]
        # the JAX package's layout: rows_per = max(ceil(23/4), ceil(17/4))
        # = 6, pads per process
        assert rep["shard_valid"] == [6, 6, 6, 5, 6, 6, 5, 0]
    assert wall < 60, wall


def test_nccl_with_ranks_on_the_cpu_is_refused_on_every_rank(tmp_path):
    runs = chip_smoke.run_cluster(
        worker_config(str(tmp_path / "ckpt"), steps=(), backend="nccl"),
        world=2, timeout=60, env={"TFT_BOOTSTRAP_TIMEOUT": "20"})
    for run in runs:
        rep = run["report"]
        assert run["rc"] == 0 and rep["refused"] is True, run["out"]
        assert "backend='nccl' needs a CUDA card on every rank" \
            in rep["error"]
        assert rep["bootstrap_s"] < 20


# -- distribute_local's layout against the JAX package's --------------------

@pytest.fixture(scope="module")
def meshes():
    return {"jax": jpar.local_mesh(8),
            "torch": tpar.DeviceMesh(np.array([torch.device("cpu")] * 8,
                                              dtype=object))}


def local_rows(n, seed):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 6, n).astype(np.int64),
            "x": rng.random(n), "v": rng.random((n, 3))}


@pytest.mark.parametrize("n", [37, 8, 3, 64])
def test_distribute_local_layout_matches_jax(meshes, n):
    rows = local_rows(n, n)
    j = jpar.distribute_local(rows, meshes["jax"])
    t = tpar.distribute_local(rows, meshes["torch"])
    assert t.num_rows == j.num_rows == n
    np.testing.assert_array_equal(t.shard_valid, j.shard_valid)
    assert t.padded_rows == j.padded_rows
    for name in rows:
        np.testing.assert_array_equal(t.host_read_padded(name),
                                      np.asarray(j.host_read_padded(name)))
    got = {f: np.asarray([r[f] for r in t.collect_frame().collect()])
           for f in rows}
    want = {f: np.asarray([r[f] for r in j.collect_frame().collect()])
            for f in rows}
    for f in rows:
        np.testing.assert_array_equal(got[f], want[f])


@pytest.mark.parametrize("n", [37, 61])
def test_reduces_and_aggregates_over_distribute_local_match_jax(meshes, n):
    rows = local_rows(n, 100 + n)
    j = jpar.distribute_local(rows, meshes["jax"])
    t = tpar.distribute_local(rows, meshes["torch"])
    for fetches in ({"x": "sum", "v": "min"}, {"x": "max", "v": "sum"}):
        jr, tr = (jpar.dreduce_blocks(fetches, j),
                  tpar.dreduce_blocks(fetches, t))
        for f in fetches:
            np.testing.assert_allclose(tr[f], np.asarray(jr[f]),
                                       rtol=1e-12)
    jg = jpar.dreduce_blocks(
        lambda x_input: {"x": jnp.sqrt((x_input ** 2).sum(0))},
        j.select("x"))
    tg = tpar.dreduce_blocks(
        lambda x_input: {"x": torch.sqrt((x_input ** 2).sum(0))},
        t.select("x"))
    np.testing.assert_allclose(tg["x"], np.asarray(jg["x"]), rtol=1e-12)
    for kw in ({}, {"max_groups": 8}):
        ja = jpar.daggregate({"x": "sum", "v": "max"}, j, "k", **kw)
        ta = tpar.daggregate({"x": "sum", "v": "max"}, t, "k", **kw)
        jc, tc = ja.collect(), ta.collect()
        assert [r["k"] for r in tc] == [r["k"] for r in jc]
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a["x"], b["x"], rtol=1e-12)
            np.testing.assert_allclose(a["v"], b["v"], rtol=1e-12)


def test_distribute_local_validates_before_any_collective(meshes):
    with pytest.raises(ValueError, match="data axis 'data' leading"):
        mesh = tpar.DeviceMesh(
            np.array([torch.device("cpu")] * 4, dtype=object).reshape(2, 2),
            ("model", "data"), data_axis="data")
        tpar.distribute_local({"x": np.arange(4.0)}, mesh)
    # one process: a frame works as a mapping does
    df = ttf.frame({"x": np.arange(10.0)})
    d = tpar.distribute_local(df, meshes["torch"])
    assert d.num_rows == 10 and d.shard_valid.tolist() == [2] * 5 + [0] * 3


def test_cluster_mesh_without_a_cluster_is_the_local_mesh(monkeypatch):
    monkeypatch.setenv("TFT_CPU_DEVICE_COUNT", "4")
    mesh = tpar.cluster_mesh()
    assert not mesh.is_cluster and mesh.num_data_shards == 4
    assert mesh.local_shards() == [0, 1, 2, 3]
    assert [d.process for d in mesh.logical_devices()] == [0] * 4
    with pytest.raises(ValueError, match="does not cover"):
        tpar.cluster_mesh(shape=(3,))
    assert cluster.process_identity() == "p0of1"
    assert (cluster.process_index(), cluster.process_count()) == (0, 1)


def test_a_slot_is_known_by_its_process_too():
    from tensorframes_tpu_torch.parallel.mesh import LogicalDevice

    cpu = torch.device("cpu")
    assert LogicalDevice(0, cpu) == LogicalDevice(0, cpu, 0)
    assert LogicalDevice(0, cpu, 0) != LogicalDevice(0, cpu, 1)
    assert len({LogicalDevice(0, cpu, 0), LogicalDevice(0, cpu, 1)}) == 2


# -- the bootstrap policy (tests/test_resilience.py::TestClusterResilience) --

def both(fn):
    """``fn(cluster_module, resilience_module)`` for each package."""
    from tensorframes_tpu.parallel import cluster as jcluster
    return [fn(jcluster, jrz), fn(cluster, trz)]


def test_partial_env_raises_valueerror(monkeypatch):
    monkeypatch.setenv("TFT_COORDINATOR", "127.0.0.1:9999")

    def call(c, _):
        with pytest.raises(ValueError, match="partially-specified") as ei:
            c.initialize()
        return str(ei.value)

    j, t = both(call)
    assert j == t


def test_partial_args_raise_valueerror():
    def call(c, _):
        with pytest.raises(ValueError, match="TFT_NUM_PROCESSES") as ei:
            c.initialize(coordinator_address="127.0.0.1:9999")
        return str(ei.value)

    j, t = both(call)
    assert j == t


def test_malformed_coordinator_address_fails_fast():
    def call(c, _):
        with pytest.raises(ValueError, match="host:port") as ei:
            c.initialize(coordinator_address="tpu-host", num_processes=2,
                         process_id=1)
        return str(ei.value)

    j, t = both(call)
    assert j == t


@pytest.mark.parametrize("address", ["[fd00::1]:1234", "10.0.0.2:99",
                                     "10.0.0.2", "host:notaport", ":77",
                                     "h:0", "h:65536"])
def test_hostport_parses_like_the_jax_package(address):
    def call(c, _):
        try:
            return c._parse_hostport(address)
        except ValueError as e:
            return str(e)

    j, t = both(call)
    assert j == t


def test_fault_injected_bootstrap_retries_then_degrades():
    def call(c, rz):
        from tensorframes_tpu.utils.tracing import counters as jc
        cnt = jc if rz is jrz else counters
        with rz.faults.inject("cluster_init", fail_n=10):
            ok = c.initialize(timeout=2)
        return (ok, cnt.get("retry.cluster_init.retries") >= 1,
                cnt.get("cluster_init.degraded"))

    j, t = both(call)
    assert j == t == (False, True, 1)


def test_fault_injected_bootstrap_retries_then_succeeds():
    # two scripted failures, then the single-process autodetection
    # answers "no cluster": degradation must NOT be recorded
    with trz.faults.inject("cluster_init", fail_n=2):
        assert cluster.initialize(timeout=5) is False
    assert counters.get("retry.cluster_init.retries") == 2
    assert counters.get("cluster_init.degraded") == 0


@pytest.mark.timing
def test_require_cluster_fails_fast_on_unreachable_coordinator(monkeypatch):
    monkeypatch.setenv("TFT_REQUIRE_CLUSTER", "1")
    t0 = time.monotonic()
    with pytest.raises(trz.ClusterInitError):
        cluster.initialize("127.0.0.1:1", 2, 1, timeout=3)
    assert time.monotonic() - t0 < timing_margin(5.0)
    assert counters.get("cluster_init.failures") == 1


def test_unreachable_coordinator_degrades_without_require():
    assert cluster.initialize("127.0.0.1:1", 2, 1, timeout=2) is False
    assert counters.get("cluster_init.degraded") == 1


def test_launcher_variables_are_read(monkeypatch):
    # torchrun's variables name a coordinator that is not there: the
    # bootstrap retries under the attempt-counted policy and degrades
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1"),
                 ("WORLD_SIZE", "2"), ("RANK", "1")):
        monkeypatch.setenv(k, v)
    assert cluster.initialize(timeout=2) is False
    assert counters.get("cluster_init.degraded") == 1


# -- the backend ---------------------------------------------------------------

CPU = {"type": "cpu", "host": "h"}


def card(uuid):
    return {"type": "cuda", "index": 0, "name": "NVIDIA H100 80GB HBM3",
            "uuid": uuid}


def test_backend_follows_where_the_ranks_are():
    choose = cluster.choose_backend
    assert choose([CPU, CPU], None) == "gloo"
    assert choose([CPU, CPU], "gloo") == "gloo"
    assert choose([card("GPU-a"), card("GPU-b")], None) == "nccl"
    assert choose([card("GPU-a")], None) == "nccl"
    # two ranks on one card: gloo, never NCCL
    assert choose([card("GPU-a"), card("GPU-a")], None) == "gloo"
    assert choose([card("GPU-a"), card("GPU-a")], "gloo") == "gloo"


def test_an_impossible_backend_raises_naming_why():
    with pytest.raises(trz.ClusterInitError,
                       match=r"needs a CUDA card on every rank; rank\(s\) "
                             r"\[0, 1\]"):
        cluster.choose_backend([CPU, CPU], "nccl")
    with pytest.raises(trz.ClusterInitError,
                       match=r"cannot run ranks 0 and 1 on one card "
                             r"\(NVIDIA H100 80GB HBM3, GPU-a\)"):
        cluster.choose_backend([card("GPU-a"), card("GPU-a")], "nccl")
    with pytest.raises(ValueError, match="backend must be one of"):
        cluster.initialize(backend="mpi")
    with pytest.raises(TypeError, match="local_device_ids"):
        cluster.initialize(local_device_ids=[0])


# -- the chip phase, rehearsed on the CPU ------------------------------------

def test_phase_cluster_rehearsal(monkeypatch, capsys):
    """``chip_smoke.phase_cluster`` at a small size on the CPU: (a) the ten
    steps on two gloo ranks with uneven rows, (b) a one-rank world (gloo
    here, NCCL on the card), (c) NCCL refused for ranks without a card,
    (d) the analytics demo on 8 CPU shards; its JSON lines printed."""
    import json

    from tensorframes_tpu_torch.ops import segment_reduce

    monkeypatch.setattr(chip_smoke, "smi_card",
                        lambda: "CPU rehearsal, no card")
    out = {}
    info = chip_smoke.phase_cluster(
        ttf, np, torch, segment_reduce, rows=(11_000, 9_000), keys=1000,
        csv_rows=20_000, one_rank_backend="gloo", device="cpu",
        timeout=120, out=out)
    assert info["c_outcome"] == "refused"
    assert out["child_launches"] == 0  # the plain version on the CPU
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    parts = {ln["part"]: ln for ln in lines
             if ln.get("phase") == "cluster_2x4_20M"}
    assert sorted(parts) == ["a_gloo_two_ranks_one_card",
                             "b_one_rank_world",
                             "c_nccl_two_ranks_one_card",
                             "d_analytics_demo"]
    a = parts["a_gloo_two_ranks_one_card"]
    assert a["backend"] == "gloo" and a["rows_per_rank"] == [11_000, 9_000]
    # rows_per = max(ceil(11000/4), ceil(9000/4)) = 2750: rank 1's pads
    # fill its last shard
    assert a["shard_valid"] == [2750] * 7 + [750]
    assert set(a["step_walls"][0]) == set(chip_smoke.CLUSTER_STEPS)
    assert "needs a CUDA card" in parts["c_nccl_two_ranks_one_card"][
        "error"]
    assert parts["d_analytics_demo"]["groups"] == 32


def test_more_ops_across_the_pair(tmp_path):
    """Beyond the JAX worker's steps: a trim map (every process sees the
    global padded array), the sketch route (global host copies of the
    value columns), ``distribute`` of a frame every process holds whole,
    and the ops that refuse a cluster mesh before any collective;
    bit-identical across the ranks."""
    steps = ("dmap_trim", "daggregate_sketch", "distribute_global",
             "cluster_refusals")
    runs = chip_smoke.run_cluster(
        worker_config(str(tmp_path / "ckpt"), steps=steps), world=2,
        timeout=120, env={"TFT_BOOTSTRAP_TIMEOUT": "60"})
    reps = chip_smoke.cluster_ranks(runs, "gloo")
    for step in steps:
        assert reps[0]["steps"][step]["digest"] == \
            reps[1]["steps"][step]["digest"], step
