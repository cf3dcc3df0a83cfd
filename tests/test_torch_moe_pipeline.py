"""The port's expert and pipeline parallelism against the JAX package's.

Mirrors the ten tests of ``tests/test_pipeline_moe.py`` on the same
numpy-seeded inputs: ``switch_ffn`` (``parallel/moe.py``) unsharded and
over a (data, expert) mesh, ``pipeline_apply`` (``parallel/pipeline.py``)
over (data, pipe) meshes, and the transformer's MoE layers and pipelined
train step, each held against the JAX function. Then the two places
where the port's single controller has to do what GSPMD does for the
JAX package: routing is global (an expert overflows on a mesh of two data
shards and the same tokens are dropped) and the aux loss is a product of
global means.

The JAX side runs on the conftest's 8 virtual CPU devices, the port on a
``DeviceMesh`` of CPU slots of the same shape. Tolerances, f32: outputs
and logits to 1e-5 of their max-abs (products summed in other orders),
losses and aux to 1e-6 relative, gradients to 1e-5 of their max-abs, the
parameters after 3 adam steps to 1e-4 of each parameter's max-abs (adam's
first update is about the learning rate whatever the gradient, so an
element whose gradient is near 0 moves by rounding); the losses of later
steps to 2e-5 relative for the same reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tensorframes_tpu_torch as ttf
from tensorframes_tpu.models.transformer import (
    TransformerConfig as JaxConfig, TransformerLM as JaxLM)
from tensorframes_tpu.parallel.mesh import DeviceMesh as JaxMesh
from tensorframes_tpu.parallel.moe import switch_ffn as jax_switch_ffn
from tensorframes_tpu.parallel.pipeline import \
    pipeline_apply as jax_pipeline_apply
from tensorframes_tpu_torch import parallel as tpar
from tensorframes_tpu_torch.models import (TransformerConfig, TransformerLM,
                                           params_from_jax)
from tensorframes_tpu_torch.models.transformer import \
    pipelined_params_from_jax
from tensorframes_tpu_torch.parallel.moe import init_switch_ffn, switch_ffn
from tensorframes_tpu_torch.parallel.pipeline import pipeline_apply
from tensorframes_tpu_torch.utils.tracing import counters

CPU = torch.device("cpu")
MOE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           num_experts=4)
PIPE = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=4, d_ff=32)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    yield
    ttf.set_default_device(prev)


def meshes(shape, names):
    n = int(np.prod(shape))
    jm = JaxMesh(Mesh(np.array(jax.devices()[:n]).reshape(shape), names),
                 data_axis=names[0])
    tm = tpar.DeviceMesh(np.array([CPU] * n, dtype=object).reshape(shape),
                         names, data_axis=names[0])
    return jm, tm


def close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def switch_params(seed, T, D, F, E):
    rng = np.random.default_rng(seed)
    params = {"router": rng.normal(0, D ** -0.5, (D, E)),
              "w1": rng.normal(0, D ** -0.5, (E, D, F)),
              "w2": rng.normal(0, F ** -0.5, (E, F, D))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    return params, rng.normal(size=(T, D)).astype(np.float32)


def both_switch(params, x, **kw):
    """``switch_ffn`` through both packages: ``(jax, port)`` of ``(out,
    aux)``. ``kw`` may name ``mesh=(jax_mesh, port_mesh)``."""
    jmesh, tmesh = kw.pop("mesh", (None, None))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    j = jax_switch_ffn(jnp.asarray(x), jp, mesh=jmesh, **kw)
    t = switch_ffn(torch.from_numpy(x), tp, mesh=tmesh, **kw)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


# -- switch_ffn -------------------------------------------------------------

def _ref_switch(x, params, capacity):
    """Token-at-a-time top-1 routing with capacity drops
    (``tests/test_pipeline_moe.py``'s reference)."""
    logits = x @ params["router"]
    e = np.exp(logits - logits.max(-1, keepdims=True))
    gates = e / e.sum(-1, keepdims=True)
    top = gates.argmax(-1)
    out = np.zeros_like(x)
    counts = {}
    for t in range(x.shape[0]):
        ex = int(top[t])
        k = counts.get(ex, 0)
        if k < capacity:
            counts[ex] = k + 1
            h = np.asarray(jax.nn.gelu(x[t] @ params["w1"][ex]))
            out[t] = (h @ params["w2"][ex]) * gates[t, ex]
    return out


def test_switch_ffn_routes_and_drops():
    T, D, F, E = 32, 8, 16, 4
    params, x = switch_params(0, T, D, F, E)
    (jout, jaux), (tout, taux) = both_switch(params, x, capacity_factor=1.0)
    close(tout, jout)
    close(tout, _ref_switch(x, params, capacity=T // E))
    assert rel(taux, jaux) <= 1e-6 and float(taux) > 0.0
    assert tout.dtype == np.float32 and tout.shape == (T, D)


def test_switch_ffn_sharded_matches_unsharded():
    jm, tm = meshes((2, 4), ("data", "expert"))
    params, x = switch_params(1, 64, 8, 16, 4)
    (jref, jaux), (tref, taux) = both_switch(params, x, capacity_factor=1.25)
    (jout, _), (tout, taux_m) = both_switch(
        params, x, capacity_factor=1.25, mesh=(jm, tm), expert_axis="expert")
    close(tout, tref)
    close(tout, jout)
    close(tref, jref)
    assert rel(taux_m, jaux) <= 1e-6


def test_init_switch_ffn_shapes_and_dtypes():
    p = init_switch_ffn(torch.Generator().manual_seed(0), 8, 16, 4,
                        dtype=torch.bfloat16, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        "router": ((8, 4), torch.float32),
        "w1": ((4, 8, 16), torch.bfloat16),
        "w2": ((4, 16, 8), torch.bfloat16)}
    again = init_switch_ffn(torch.Generator().manual_seed(0), 8, 16, 4,
                            device="cpu")
    np.testing.assert_allclose(float(again["w2"].std()), 16 ** -0.5,
                               rtol=0.2)


@pytest.mark.parametrize("names,shape", [
    (("data", "expert"), (2, 2)),   # two data shards, two expert shards
    (("data", "expert"), (4, 2)),
])
def test_overflow_drops_the_same_tokens_as_the_jax_package(names, shape):
    """Routing is global: the capacity comes from all T tokens, a token's
    queue position from its place in global order. At capacity_factor 0.5
    experts overflow; the port drops exactly the tokens the JAX package
    drops (their output rows are 0), on a mesh of more than one data
    shard, and counts them."""
    jm, tm = meshes(shape, names)
    params, x = switch_params(2, 64, 8, 16, 4)
    before = counters.get("moe.dropped_tokens")
    (jout, jaux), (tout, taux) = both_switch(
        params, x, capacity_factor=0.5, mesh=(jm, tm), expert_axis="expert")
    dropped_j = np.all(jout == 0.0, axis=1)
    dropped_t = np.all(tout == 0.0, axis=1)
    np.testing.assert_array_equal(dropped_t, dropped_j)
    assert dropped_j.sum() >= 64 // 2  # half the slots: at least half drop
    assert counters.get("moe.dropped_tokens") - before == dropped_j.sum()
    close(tout, jout)
    assert rel(taux, jaux) <= 1e-6
    # per-shard routing (each data shard with its own capacity and queue)
    # would keep other tokens
    halves = [switch_ffn(torch.from_numpy(h), {k: torch.from_numpy(v) for
                                               k, v in params.items()},
                         capacity_factor=0.5)[0].numpy()
              for h in np.split(x, shape[0])]
    assert not np.array_equal(np.all(np.concatenate(halves) == 0.0, axis=1),
                              dropped_j)


def test_aux_loss_is_a_product_of_global_means():
    """The aux on a (data 4, expert 2) mesh equals the JAX package's global
    aux, not the mean of the shards' own aux."""
    jm, tm = meshes((4, 2), ("data", "expert"))
    params, x = switch_params(3, 64, 8, 16, 4)
    (_, jaux), (_, taux) = both_switch(params, x, mesh=(jm, tm),
                                       expert_axis="expert")
    assert rel(taux, jaux) <= 1e-6
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    shard_mean = np.mean([float(switch_ffn(torch.from_numpy(h), tp)[1])
                          for h in np.split(x, 4)])
    assert rel(shard_mean, jaux) > 1e-3


def test_switch_ffn_differentiates_like_the_jax_package():
    jm, tm = meshes((2, 2), ("data", "expert"))
    params, x = switch_params(4, 32, 8, 16, 4)
    g = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jax_switch_ffn(x, p, mesh=jm, expert_axis="expert")
        return jnp.sum(out * g) + aux

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    leaves = {k: torch.from_numpy(v).requires_grad_()
              for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = switch_ffn(xt, leaves, mesh=tm, expert_axis="expert")
    tgrads = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)) + aux,
                                 list(leaves.values()) + [xt])
    for name, tg in zip(list(leaves) + ["x"], tgrads):
        want = jgrads[1] if name == "x" else jgrads[0][name]
        close(tg, want)


# -- pipeline_apply ---------------------------------------------------------

def test_pipeline_matches_sequential():
    jm, tm = meshes((2, 4), ("data", "pipe"))
    P_, D = 4, 6
    rng = np.random.default_rng(0)
    ws = rng.normal(0, 0.3, (P_, D, D)).astype(np.float32)
    x = rng.normal(size=(8, D)).astype(np.float32)
    want = np.asarray(jax_pipeline_apply(
        lambda w, a: jnp.tanh(a @ w[0]), jnp.asarray(ws)[:, None],
        jnp.asarray(x), jm, pipe_axis="pipe", data_axis="data"))
    got = pipeline_apply(lambda w, a: torch.tanh(a @ w[0]),
                         torch.from_numpy(ws)[:, None], torch.from_numpy(x),
                         tm, pipe_axis="pipe", data_axis="data")
    close(got, want)
    seq = x
    for i in range(P_):
        seq = np.tanh(seq @ ws[i])
    np.testing.assert_allclose(got.numpy(), seq, rtol=2e-4, atol=2e-5)


def test_pipeline_microbatches_more_than_stages():
    jm, tm = meshes((1, 4), ("data", "pipe"))
    D = 4
    rng = np.random.default_rng(1)
    ws = rng.normal(0, 0.3, (4, D, D)).astype(np.float32)
    x = rng.normal(size=(16, D)).astype(np.float32)
    want = np.asarray(jax_pipeline_apply(
        lambda w, a: a @ w[0], jnp.asarray(ws)[:, None], jnp.asarray(x), jm,
        pipe_axis="pipe", num_microbatches=8))
    got = pipeline_apply(lambda w, a: a @ w[0],
                         torch.from_numpy(ws)[:, None], torch.from_numpy(x),
                         tm, pipe_axis="pipe", num_microbatches=8)
    close(got, want)
    np.testing.assert_allclose(got.numpy(), x @ ws[0] @ ws[1] @ ws[2] @ ws[3],
                               rtol=2e-4, atol=2e-5)


def test_pipeline_is_differentiable():
    jm, tm = meshes((1, 4), ("data", "pipe"))
    D = 4
    rng = np.random.default_rng(2)
    ws = rng.normal(0, 0.3, (4, 1, D, D)).astype(np.float32)
    x = rng.normal(size=(4, D)).astype(np.float32)
    want = jax.jit(jax.grad(lambda w: jax_pipeline_apply(
        lambda wp, a: jnp.tanh(a @ wp[0]), w, jnp.asarray(x), jm,
        pipe_axis="pipe").sum()))(jnp.asarray(ws))
    leaf = torch.from_numpy(ws).requires_grad_()
    out = pipeline_apply(lambda wp, a: torch.tanh(a @ wp[0]), leaf,
                         torch.from_numpy(x), tm, pipe_axis="pipe")
    (got,) = torch.autograd.grad(out.sum(), [leaf])
    assert bool(torch.isfinite(got).all()) and float(got.abs().sum()) > 0
    close(got, want)


def test_pipeline_rejects_a_batch_not_divisible_into_microbatches():
    jm, tm = meshes((1, 4), ("data", "pipe"))
    w = np.zeros((4, 1, 2, 2), np.float32)
    with pytest.raises(ValueError) as want:
        jax_pipeline_apply(lambda wp, a: a @ wp[0], jnp.asarray(w),
                           jnp.zeros((6, 2), jnp.float32), jm,
                           pipe_axis="pipe")
    with pytest.raises(ValueError) as got:
        pipeline_apply(lambda wp, a: a @ wp[0], torch.from_numpy(w),
                       torch.zeros(6, 2), tm, pipe_axis="pipe")
    assert str(got.value) == str(want.value)


# -- transformer integration ------------------------------------------------

@pytest.fixture(scope="module")
def moe_pair():
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    jm = JaxLM(JaxConfig(**MOE))
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    tm = TransformerLM(TransformerConfig(**MOE), device="cpu")
    tm.load_state_dict(params_from_jax(params))
    yield jm, params, tm
    ttf.set_default_device(prev)


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_moe_transformer_forward_and_loss(moe_pair):
    jm, params, tm = moe_pair
    toks = tokens(7, (2, 8), 64)
    jlogits, jaux = jax.jit(jm.apply_with_aux)(params, jnp.asarray(toks))
    logits, aux = tm.apply_with_aux(torch.from_numpy(toks))
    assert tuple(logits.shape) == (2, 8, 64)
    close(logits, jlogits)
    assert float(aux) > 0.0 and rel(aux, jaux) <= 1e-6
    tgt = np.ones((2, 8), np.int32)
    assert rel(tm.loss(torch.from_numpy(toks), torch.from_numpy(tgt)),
               jax.jit(jm.loss)(params, jnp.asarray(toks),
                                jnp.asarray(tgt))) <= 1e-6


def test_moe_transformer_decodes_like_the_jax_package(moe_pair):
    jm, params, tm = moe_pair
    prompt = tokens(8, (2, 5), 64)
    want = np.asarray(jm.generate(params, jnp.asarray(prompt), 6))
    got = tm.generate(torch.from_numpy(prompt), 6).numpy()
    np.testing.assert_array_equal(got, want)


def test_moe_expert_parallel_train_step(moe_pair):
    jmodel, _, tmodel = moe_pair
    jm, tm = meshes((2, 2, 2), ("data", "model", "expert"))
    jstep, jinit = jmodel.make_sharded_train_step(
        jm, data_axis="data", model_axis="model", expert_axis="expert")
    jstate = jinit(jax.random.PRNGKey(0))
    tstep, tinit = tmodel.make_sharded_train_step(
        tm, data_axis="data", model_axis="model", expert_axis="expert")
    tstate = tinit(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate["params"])))
    toks = tokens(1, (4, 8), 64)
    tgt = np.roll(toks, -1, 1)
    for i in range(3):
        jstate, jl = jstep(jstate, jnp.asarray(toks), jnp.asarray(tgt))
        tstate, tl = tstep(tstate, torch.from_numpy(toks),
                           torch.from_numpy(tgt))
        assert np.isfinite(float(tl))
        assert rel(tl, jl) <= (1e-6 if i == 0 else 2e-5), (i, tl, jl)
    got = tstep.gather(tstate, CPU)["params"]
    for name, want in params_from_jax(jax.tree_util.tree_map(
            np.asarray, jstate["params"])).items():
        close(got[name], want, tol=1e-4)


def test_moe_overflow_in_the_transformer_matches_the_jax_package():
    """Global routing through the model: capacity_factor 0.5 on (data 2,
    model 2, expert 2); every layer drops tokens, and the loss (with its
    aux) equals the JAX package's, whose routing is global."""
    cfg = dict(MOE, expert_capacity_factor=0.5)
    jmodel = JaxLM(JaxConfig(**cfg))
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(2)))
    tmodel = TransformerLM(TransformerConfig(**cfg), device="cpu")
    tmodel.load_state_dict(params_from_jax(params))
    jm, tm = meshes((2, 2, 2), ("data", "model", "expert"))
    toks = tokens(3, (4, 8), 64)
    tgt = np.roll(toks, -1, 1)
    kw = dict(data_axis="data", model_axis="model", expert_axis="expert")
    want = jax.jit(lambda p, t, g: jmodel.loss(p, t, g, mesh=jm, **kw))(
        params, jnp.asarray(toks), jnp.asarray(tgt))
    before = counters.get("moe.dropped_tokens")
    got = tmodel.loss(torch.from_numpy(toks), torch.from_numpy(tgt),
                      mesh=tm, **kw)
    assert counters.get("moe.dropped_tokens") - before >= 2 * 32 // 2
    assert rel(got, want) <= 1e-6


def test_pipelined_train_step_runs_and_learns():
    cfg = PIPE
    jmodel = JaxLM(JaxConfig(**cfg))
    tmodel = TransformerLM(TransformerConfig(**cfg), device="cpu")
    jm, tm = meshes((2, 4), ("data", "pipe"))
    jstep, jinit = jmodel.make_pipelined_train_step(
        jm, pipe_axis="pipe", data_axis="data", learning_rate=1e-2)
    tstep, tinit = tmodel.make_pipelined_train_step(
        tm, pipe_axis="pipe", data_axis="data", learning_rate=1e-2)
    jstate = jinit(jax.random.PRNGKey(0))
    tstate = tinit(pipelined_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate["params"])))
    toks = tokens(1, (8, 8), 32)
    tgt = np.roll(toks, -1, 1)
    losses = []
    for i in range(3):
        jstate, jl = jstep(jstate, jnp.asarray(toks), jnp.asarray(tgt))
        tstate, tl = tstep(tstate, torch.from_numpy(toks),
                           torch.from_numpy(tgt))
        assert rel(tl, jl) <= (1e-6 if i == 0 else 2e-5), (i, tl, jl)
        losses.append(float(tl))
    assert losses[-1] < losses[0]  # the pipelined grads descend
    got = tstep.gather(tstate, CPU)["params"]
    want = pipelined_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate["params"]))
    for part in ("outer", "stages"):
        for name, w in want[part].items():
            close(got[part][name], w, tol=1e-4)
    # one stage a pipe shard: stage p's [1, per_stage, ...] slice
    assert [tuple(t.shape) for t in tstate["params"]["stages"]["wq"]] == \
        [(1, 1, 16, 2, 8)] * 4


def test_pipelined_forward_matches_unpipelined():
    cfg = PIPE
    jmodel = JaxLM(JaxConfig(**cfg))
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0)))
    tmodel = TransformerLM(TransformerConfig(**cfg), device="cpu")
    tmodel.load_state_dict(params_from_jax(params))
    _, tm = meshes((1, 4), ("data", "pipe"))
    toks = tokens(1, (4, 8), 32)
    tgt = np.roll(toks, -1, 1)
    step, init_state = tmodel.make_pipelined_train_step(tm)
    state = init_state(params_from_jax(params))
    _, pipel = step(state, torch.from_numpy(toks), torch.from_numpy(tgt))
    ref = tmodel.loss(torch.from_numpy(toks), torch.from_numpy(tgt))
    jref = jax.jit(jmodel.loss)(params, jnp.asarray(toks), jnp.asarray(tgt))
    assert rel(pipel, ref) <= 1e-6 and rel(pipel, jref) <= 1e-6


def test_pipelined_step_rejects_moe_and_uneven_stages(moe_pair):
    _, _, tmodel = moe_pair
    jm, tm = meshes((1, 4), ("data", "pipe"))
    with pytest.raises(ValueError, match="dense FFN models only"):
        tmodel.make_pipelined_train_step(tm, pipe_axis="pipe")
    _, tm3 = meshes((1, 3), ("data", "pipe"))
    jm3, _ = meshes((1, 3), ("data", "pipe"))
    dense = TransformerConfig(**PIPE)
    with pytest.raises(ValueError) as want:
        JaxLM(JaxConfig(**PIPE)).make_pipelined_train_step(jm3)
    with pytest.raises(ValueError) as got:
        TransformerLM(dense, device="cpu").make_pipelined_train_step(tm3)
    assert str(got.value) == str(want.value)
