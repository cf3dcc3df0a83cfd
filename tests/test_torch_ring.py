"""The port's ring collectives (``tensorframes_tpu_torch/parallel/ring.py``)
against the JAX package's on the same numpy-seeded inputs.

The JAX side runs on the conftest's 8 virtual CPU devices, the port on a
``DeviceMesh`` of CPU slots of the same shape. Mirrors
``tests/test_parallel.py::test_ring_allreduce_matches_psum`` and
``::test_ring_attention_matches_full`` (causal and not),
``tests/test_kernels.py``'s ``test_matches_ring_attention`` (B2's plain
version against the port's ring) and
``tests/test_observability.py``'s
``test_ring_allreduce_records_collective_event``.

Tolerances, f32: the ring's outputs to 2e-5 of their max-abs against the
JAX ring (the same block updates, einsums summed in other orders) and
against full attention (the JAX tests' own bound, 2e-4 relative and 2e-5
absolute); the allreduce to rtol 1e-6 (sums of 8 values in another
order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import tensorframes_tpu_torch as ttf
from tensorframes_tpu import observability as jobs
from tensorframes_tpu.parallel import ring as jring
from tensorframes_tpu.parallel.mesh import DeviceMesh as JaxMesh
from tensorframes_tpu_torch import observability as tobs
from tensorframes_tpu_torch import parallel as tpar
from tensorframes_tpu_torch.parallel import ring as tring
from tensorframes_tpu_torch.utils import tracing

fa = importlib.import_module("tensorframes_tpu_torch.ops.flash_attention")

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def on_cpu():
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    yield
    ttf.set_default_device(prev)


def meshes(shape, names):
    """The JAX package's mesh on its virtual devices and the port's of CPU
    slots, both of ``shape`` over ``names``."""
    n = int(np.prod(shape))
    jm = JaxMesh(Mesh(np.array(jax.devices()[:n]).reshape(shape), names),
                 data_axis=names[0])
    tm = tpar.DeviceMesh(np.array([CPU] * n, dtype=object).reshape(shape),
                         names, data_axis=names[0])
    return jm, tm


def qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def full_attention(q, k, v, causal):
    S, D = q.shape[1], q.shape[-1]
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)
    if causal:
        mask = np.tril(np.ones((S, S), bool))
        scores = np.where(mask[None, None], scores, -np.inf)
    w = np.exp(scores - scores.max(axis=-1, keepdims=True))
    w /= w.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", w, v)


def close(got, want, tol=2e-5):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("n", [2, 8])
def test_ring_allreduce_matches_psum(n):
    jm, tm = meshes((n,), ("data",))
    x = np.arange(n * 5.0).reshape(n, 5).astype(np.float32) * 0.37
    want = np.asarray(jring.ring_allreduce(
        jax.device_put(x, jm.row_sharding(2)), jm))
    got = tpar.ring_allreduce(torch.from_numpy(x), tm)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.broadcast_to(x.sum(axis=0), (n, 5)), rtol=1e-6)
    assert got.dtype == torch.float32 and got.shape == (n, 5)


def test_ring_allreduce_pads_a_payload_the_ring_does_not_divide():
    jm, tm = meshes((8,), ("data",))
    x = np.random.default_rng(3).normal(size=(8, 3, 7)).astype(np.float32)
    want = np.asarray(jring.ring_allreduce(
        jax.device_put(x, jm.row_sharding(3)), jm))
    got = tpar.ring_allreduce(torch.from_numpy(x), tm).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_ring_allreduce_one_shard_and_wrong_leading_dim():
    jm, tm = meshes((1,), ("data",))
    x = torch.arange(6.0).reshape(2, 3)
    assert tpar.ring_allreduce(x, tm) is x  # n = 1: x itself
    jm4, tm4 = meshes((4,), ("data",))
    with pytest.raises(ValueError) as want:
        jring.ring_allreduce(jnp.zeros((3, 2), jnp.float32), jm4)
    with pytest.raises(ValueError) as got:
        tpar.ring_allreduce(torch.zeros(3, 2), tm4)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_full(causal):
    B, S, H, D = 2, 32, 2, 8  # S split 8 ways -> 4 a shard
    jm, tm = meshes((8,), ("data",))
    q, k, v = qkv(0, (B, S, H, D))
    sharding = NamedSharding(jm.mesh, P(None, "data", None, None))
    want = np.asarray(jring.ring_attention(
        *(jax.device_put(a, sharding) for a in (q, k, v)), jm,
        causal=causal))
    got = tpar.ring_attention(*map(torch.from_numpy, (q, k, v)), tm,
                              causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, D)
    close(got, want)
    np.testing.assert_allclose(got.numpy(), full_attention(q, k, v, causal),
                               rtol=2e-4, atol=2e-5)


def test_ring_attention_composed_axes():
    """Batch over data, heads over model, the sequence ring over seq."""
    jm, tm = meshes((2, 2, 2), ("data", "seq", "model"))
    q, k, v = qkv(1, (4, 16, 4, 8))
    kw = dict(seq_axis="seq", causal=True, batch_axis="data",
              head_axis="model")
    sharding = NamedSharding(jm.mesh, P("data", "seq", "model", None))
    want = np.asarray(jring.ring_attention(
        *(jax.device_put(a, sharding) for a in (q, k, v)), jm, **kw))
    got = tpar.ring_attention(*map(torch.from_numpy, (q, k, v)), tm, **kw)
    close(got, want)


def test_matches_ring_attention():
    """B2's plain version and the ring compute the same function: the two
    halves of the long-context story (``tests/test_kernels.py``)."""
    _, tm = meshes((4,), ("data",))
    q, k, v = map(torch.from_numpy, qkv(2, (1, 32, 2, 8)))
    ref = fa.flash_attention_reference(q, k, v, causal=True)
    ring = tpar.ring_attention(q, k, v, tm, causal=True)
    flash = fa.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(ring, ref, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(flash, ref, rtol=2e-5, atol=2e-5)


def test_fully_masked_hops_stay_finite_and_differentiate():
    """Causal over 4 shards: at the later hops a shard's whole k block
    lies in its rows' future. The -inf guards keep the forward and the
    gradients finite; the gradients equal autograd of B2's plain version
    on the same inputs."""
    _, tm = meshes((4,), ("seq",))
    leaves = [t.requires_grad_() for t in map(torch.from_numpy,
                                              qkv(4, (2, 16, 2, 8)))]
    ring = tpar.ring_attention(*leaves, tm, seq_axis="seq", causal=True)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=ring.shape).astype(np.float32))
    got = torch.autograd.grad(ring, leaves, g)
    plain = fa.flash_attention_reference(*leaves, causal=True)
    want = torch.autograd.grad(plain, leaves, g)
    assert bool(torch.isfinite(ring).all())
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        close(a, b, tol=1e-5)


def test_ring_attention_rejects_a_sequence_the_ring_does_not_divide():
    _, tm = meshes((4,), ("data",))
    x = torch.zeros(1, 6, 2, 8)
    with pytest.raises(ValueError, match="sequence dim"):
        tpar.ring_attention(x, x, x, tm)


def test_ring_allreduce_records_collective_event():
    jm, tm = meshes((8,), ("data",))
    n = 8
    x = np.arange(float(n * 4)).reshape(n, 4)
    tracing.enable()
    jtracing = importlib.import_module("tensorframes_tpu.utils.tracing")
    jtracing.enable()
    try:
        with jobs.query_trace("ring") as jt:
            jring.ring_allreduce(jax.device_put(x, jm.row_sharding(2)), jm)
        with tobs.query_trace("ring") as tt:
            out = tpar.ring_allreduce(torch.from_numpy(x), tm)
            tpar.ring_attention(*map(torch.from_numpy, qkv(6, (1, 16, 2, 8))),
                                tm, causal=True)
    finally:
        tracing.disable()
        jtracing.disable()
    np.testing.assert_allclose(out.numpy()[0], x.sum(axis=0))
    jev = [e for e in jt.events if e.etype == "collective"]
    tev = [e for e in tt.events if e.etype == "collective"]
    assert [e.name for e in tev] == ["ring_allreduce", "ring_attention"]
    assert tev[0].name == jev[0].name
    for key in ("axis", "devices", "hops"):
        assert tev[0].args[key] == jev[0].args[key], key
    assert tev[0].args["hops"] == 2 * (n - 1)
    assert tev[1].args == {"axis": "data", "devices": n, "hops": 2 * n}
    assert all(e.dur is not None and e.dur >= 0.0 for e in tev)


def test_untraced_ring_records_nothing():
    _, tm = meshes((2,), ("data",))
    assert not tracing.enabled()
    tpar.ring_allreduce(torch.ones(2, 3), tm)
    assert tobs.current_trace() is None


def test_ring_and_the_cluster_are_exported(monkeypatch):
    from tensorframes_tpu import parallel as jpar
    from tensorframes_tpu_torch.parallel import cluster

    assert tpar.ring_attention is tring.ring_attention
    assert tpar.ring_allreduce is tring.ring_allreduce
    assert sorted(tpar.__all__) == sorted(jpar.__all__)
    for name in ("cluster_mesh", "distribute_local", "initialize"):
        assert name in tpar.__all__
        assert getattr(tpar, name) is getattr(cluster, name)
    for var in ("TFT_COORDINATOR", "TFT_NUM_PROCESSES", "TFT_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tpar.initialize() is False
