"""The transformer's and the logistic regression's mesh steps on the CPU
against the JAX package's.

The JAX side runs on the conftest's 8 virtual CPU devices, the port on a
``DeviceMesh`` of CPU slots of the same shape; both start from the JAX
package's parameters (carried with ``params_from_jax``) and take the same
numpy tokens. Mirrors ``tests/test_models.py``'s
``TestTransformer::test_ring_attention_matches_local``,
``::test_ring_attention_composed_axes_matches_local``, the three layouts
of ``::test_sharded_train_step`` (as parity with the JAX package's step,
not only "it learns") and ``TestLogReg::test_sharded_train_step``;
``tests/test_builder_checkpoint.py::test_checkpoint_resume_sharded_state``
and ``tests/test_demos.py::test_train_lm_learns_and_resumes`` on a (data
2, model 2) mesh.

Tolerances, f32: logits to 1e-5 of their max-abs (products summed in other
orders, the model shards' partial sums added in shard order); step 0's
loss to 1e-6 relative; the parameters after 3 adam steps to 1e-4 of each
parameter's max-abs, and later steps' losses to 2e-5 relative (adam's
first update is about the learning rate whatever the gradient, so an
element whose gradient is near 0 moves by rounding). The mesh against the
port's own one-device step: the same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tensorframes_tpu_torch as ttf
from tensorframes_tpu.models.logreg import LogisticRegression as JaxLogReg
from tensorframes_tpu.models.transformer import (
    TransformerConfig as JaxConfig, TransformerLM as JaxLM)
from tensorframes_tpu.parallel.mesh import DeviceMesh as JaxMesh
from tensorframes_tpu_torch import parallel as tpar
from tensorframes_tpu_torch.demos import train_lm
from tensorframes_tpu_torch.models import (LogisticRegression,
                                           TransformerConfig, TransformerLM,
                                           params_from_jax)
from tensorframes_tpu_torch.models.transformer import as_mesh
from tensorframes_tpu_torch.utils import checkpoint as ckpt

CPU = torch.device("cpu")
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
LR = 1e-2


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


def close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    jm = JaxLM(JaxConfig(**CFG))
    params = host(jm.init())
    tm = TransformerLM(TransformerConfig(**CFG), device="cpu")
    tm.load_state_dict(params_from_jax(params))
    yield jm, params, tm
    ttf.set_default_device(prev)


def named(tree):
    """The JAX package's parameter tree by the port's state-dict names."""
    out = {n: tree[n] for n in ("embed", "ln_f", "head")}
    for i, lp in enumerate(tree["layers"]):
        for k, v in lp.items():
            for kk, vv in (v.items() if k == "moe" else [(None, v)]):
                out[f"layers.{i}." + (f"moe.{kk}" if kk else k)] = vv
    return out


def batch(seed=2, shape=(8, 8), vocab=64):
    tok = np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)
    return tok, np.roll(tok, -1, axis=1)


# -- forward on a mesh ----------------------------------------------------------

def test_ring_attention_matches_local(pair):
    jm, params, tm = pair
    tok = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                        64), np.int32)
    jmesh, tmesh = meshes((1, 4), ("data", "seq"))
    want = jax.jit(lambda p, t: jm.apply(p, t, mesh=jmesh, seq_axis="seq",
                                         data_axis="data"))(
        params, jnp.asarray(tok))
    local = tm.apply(torch.from_numpy(tok))
    ringed = tm.apply(torch.from_numpy(tok), mesh=tmesh, seq_axis="seq",
                      data_axis="data")
    close(ringed, want, 1e-5)
    close(ringed, local, 1e-5)


def test_ring_attention_composed_axes_matches_local(pair):
    """dp+sp+tp composed: batch over data, seq ring, heads over model."""
    jm, params, tm = pair
    tok = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 16), 0,
                                        64), np.int32)
    jmesh, tmesh = meshes((2, 2, 2), ("data", "seq", "model"))
    kw = dict(seq_axis="seq", data_axis="data", model_axis="model")
    want = jax.jit(lambda p, t: jm.apply(p, t, mesh=jmesh, **kw))(
        params, jnp.asarray(tok))
    ringed = tm.apply(torch.from_numpy(tok), mesh=tmesh, **kw)
    close(ringed, want, 1e-5)
    close(ringed, tm.apply(torch.from_numpy(tok)), 1e-5)
    tgt = np.roll(tok, -1, 1)
    assert rel(tm.loss(torch.from_numpy(tok), torch.from_numpy(tgt),
                       mesh=tmesh, **kw),
               jax.jit(lambda p, t, g: jm.loss(p, t, g, mesh=jmesh, **kw))(
                   params, jnp.asarray(tok), jnp.asarray(tgt))) <= 1e-6


def test_vocab_split_head_loss_meets_across_shards(pair):
    """The head split over 4 model shards: the log-softmax's max and sum
    of exponentials meet across them, each target's logit comes from the
    shard that holds it; the loss is the one-device loss."""
    _, _, tm = pair
    _, tmesh = meshes((2, 4), ("data", "model"))
    tok, tgt = batch(5, (4, 8))
    one = tm.loss(torch.from_numpy(tok), torch.from_numpy(tgt))
    split = tm.loss(torch.from_numpy(tok), torch.from_numpy(tgt), mesh=tmesh,
                    data_axis="data", model_axis="model")
    assert rel(split, one) <= 1e-6


# -- the sharded train step ---------------------------------------------------

@pytest.mark.parametrize("axes,shape,seq", [
    (("data",), (8,), None),                 # pure dp
    (("data", "model"), (2, 4), None),       # dp + tp
    (("data", "model", "seq"), (2, 2, 2), "seq"),  # dp + tp + sp
])
def test_sharded_train_step(axes, shape, seq):
    jmesh, tmesh = meshes(shape, axes)
    jm = JaxLM(JaxConfig(**CFG))
    jstep, jinit = jm.make_sharded_train_step(jmesh, seq_axis=seq,
                                              learning_rate=LR)
    jstate = jinit(jax.random.PRNGKey(0))
    tm = TransformerLM(TransformerConfig(**CFG), device="cpu")
    tstep, tinit = tm.make_sharded_train_step(tmesh, seq_axis=seq,
                                              learning_rate=LR)
    tstate = tinit(params_from_jax(host(jstate["params"])))
    tok, tgt = batch()
    losses = []
    for i in range(3):
        jstate, jl = jstep(jstate, jnp.asarray(tok), jnp.asarray(tgt))
        tstate, tl = tstep(tstate, torch.from_numpy(tok),
                           torch.from_numpy(tgt))
        assert rel(tl, jl) <= (1e-6 if i == 0 else 2e-5), (i, tl, jl)
        losses.append(float(tl))
    assert losses[-1] < losses[0]  # it learns (memorizes the batch)
    assert np.isfinite(losses).all()
    got = tstep.gather(tstate, CPU)
    for name, want in params_from_jax(host(jstate["params"])).items():
        close(got["params"][name], want, 1e-4)
    assert int(got["opt"]["count"]) == 3


def test_param_shardings_match_the_jax_package():
    for experts in (0, 4):
        jm = JaxLM(JaxConfig(**CFG, num_experts=experts))
        tm = TransformerLM(TransformerConfig(**CFG, num_experts=experts),
                           device="cpu")
        jmesh, tmesh = meshes((2, 2, 2), ("data", "model", "expert"))
        want = {n: s.spec for n, s in named(
            jm.param_shardings(jmesh, "model", "expert")).items()}
        got = tm.param_shardings(tmesh, "model", "expert")
        assert set(got) == set(want)
        for name, spec in got.items():
            padded = tuple(spec)
            w = tuple(want[name]) + (None,) * (len(padded) - len(want[name]))
            assert padded == w, name


def test_defaults_split_over_the_model_axis_when_the_mesh_has_it(pair):
    """``data_axis="data"`` and ``model_axis="model"`` by default, as in
    the JAX package, each acting only when the mesh has the axis."""
    _, params, tm = pair
    _, with_model = meshes((2, 2), ("data", "model"))
    _, data_only = meshes((4,), ("data",))
    step, init_state = tm.make_sharded_train_step(with_model)
    state = init_state(params_from_jax(params))
    assert [tuple(t.shape) for t in state["params"]["layers.0.wq"]] == \
        [(32, 2, 8)] * 2
    assert [tuple(t.shape) for t in state["params"]["head"]] == \
        [(32, 32)] * 2
    step, init_state = tm.make_sharded_train_step(data_only)
    state = init_state(params_from_jax(params))
    assert [tuple(t.shape) for t in state["params"]["layers.0.wq"]] == \
        [(32, 4, 8)]


def test_replicated_parameter_is_updated_once(pair):
    """8 slots of one CPU device: each replicated parameter is one tensor,
    updated once a step with the gradient summed over the 8 shards, and
    the run equals the one-device step; a (data 4, model 2) mesh holds
    one slice a model shard, not one a slot."""
    _, params, tm = pair
    _, mesh8 = meshes((8,), ("data",))
    step, init_state = tm.make_sharded_train_step(mesh8, learning_rate=LR)
    state = init_state(params_from_jax(params))
    one, one_init = tm.make_sharded_train_step(None, learning_rate=LR)
    ostate = one_init(params_from_jax(params))
    assert all(len(ts) == 1 for ts in state["params"].values())
    tok, tgt = batch()
    for i in range(2):
        state, loss = step(state, torch.from_numpy(tok),
                           torch.from_numpy(tgt))
        ostate, oloss = one(ostate, torch.from_numpy(tok),
                            torch.from_numpy(tgt))
        assert rel(loss, oloss) <= (1e-6 if i == 0 else 2e-5)
    assert int(state["opt"]["count"]) == 2
    got = step.gather(state)["params"]
    for name, want in ostate["params"].items():
        close(got[name], want, 1e-4)
    _, mesh42 = meshes((4, 2), ("data", "model"))
    _, init42 = tm.make_sharded_train_step(mesh42)
    s42 = init42(params_from_jax(params))
    assert len(s42["params"]["layers.1.w1"]) == 2
    assert len(s42["params"]["embed"]) == 1


def test_sharded_state_round_trips_through_a_checkpoint(pair, tmp_path):
    """The mesh state is saved as its global state and placed again on
    restore; the resumed step equals the uninterrupted one bit for bit."""
    _, params, tm = pair
    _, tmesh = meshes((2, 2), ("data", "model"))
    step, init_state = tm.make_sharded_train_step(tmesh, learning_rate=LR)
    state = init_state(params_from_jax(params))
    tok, tgt = map(torch.from_numpy, batch())
    state, _ = step(state, tok, tgt)
    root = str(tmp_path / "run")
    ckpt.save_step(root, 1, step.gather(state))
    restored, at = ckpt.restore_step(root, step.gather(init_state()))
    assert at == 1
    restored = step.place(restored)
    state, la = step(state, tok, tgt)
    restored, lb = step(restored, tok, tgt)
    assert torch.equal(la, lb)
    a, b = step.gather(state), step.gather(restored)
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name


def test_a_checkpoint_restores_only_into_its_own_layout(tmp_path):
    cfg = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=4, d_ff=32)
    tm = TransformerLM(TransformerConfig(**cfg), device="cpu")
    _, pipe = meshes((1, 4), ("data", "pipe"))
    _, data = meshes((2,), ("data",))
    pstep, pinit = tm.make_pipelined_train_step(pipe)
    sstep, sinit = tm.make_sharded_train_step(data)
    root = str(tmp_path / "ck")
    ckpt.save_step(root, 1, sstep.gather(sinit()))
    with pytest.raises(ValueError, match="template"):
        ckpt.restore_step(root, pstep.gather(pinit()))
    ckpt.save_step(root, 2, pstep.gather(pinit()))
    with pytest.raises(ValueError, match="template"):
        ckpt.restore_step(root, sstep.gather(sinit()))
    restored, _ = ckpt.restore_step(root, pstep.gather(pinit()))
    assert tuple(restored["params"]["stages"]["wq"].shape) == \
        (4, 1, 16, 2, 8)


def test_checkpoint_resume_sharded_state(tmp_path):
    _, tmesh = meshes((8,), ("data",))
    model = LogisticRegression(num_features=8, device="cpu")
    step = model.make_sharded_train_step(tmesh)
    params = model.init()
    root = str(tmp_path / "run")
    assert ckpt.latest_step(root) is None
    assert ckpt.restore_step(root) == (None, None)
    ckpt.save_step(root, 3, params)
    ckpt.save_step(root, 7, params)
    assert ckpt.latest_step(root) == 7
    restored, step_n = ckpt.restore_step(root, state_like=params)
    assert step_n == 7
    for k in params:
        assert torch.equal(restored[k], params[k])
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, 8)).astype(np.float32))
    y = (x.sum(1) > 0).to(torch.float32)
    a, la = step(params, x, y)
    b, lb = step(restored, x, y)
    assert torch.equal(la, lb) and all(torch.equal(a[k], b[k]) for k in a)


# -- models/logreg.py ---------------------------------------------------------

def test_logreg_sharded_train_step(rng):
    jmesh, tmesh = meshes((8,), ("data",))
    x = rng.normal(size=(64, 4)).astype(np.float32)
    w_true = np.array([1.5, -2.0, 0.5, 3.0], np.float32)
    y = (x @ w_true > 0).astype(np.float32)
    jmodel, tmodel = JaxLogReg(4), LogisticRegression(4, device="cpu")
    jstep = jmodel.make_sharded_train_step(jmesh, lr=0.5)
    tstep = tmodel.make_sharded_train_step(tmesh, lr=0.5)
    one = tmodel.make_sharded_train_step(None, lr=0.5)
    jp = jmodel.init()
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    op = dict(tp)
    losses = []
    for _ in range(20):
        jp, jl = jstep(jp, jnp.asarray(x), jnp.asarray(y))
        tp, tl = tstep(tp, torch.from_numpy(x), torch.from_numpy(y))
        op, ol = one(op, torch.from_numpy(x), torch.from_numpy(y))
        assert rel(tl, jl) <= 1e-5 and rel(tl, ol) <= 1e-5
        losses.append(float(tl))
    assert losses[-1] < losses[0] * 0.5
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tp[k].numpy(), op[k].numpy(),
                                   rtol=1e-5, atol=1e-6)


# -- demos/train_lm.py ------------------------------------------------------

def test_train_lm_learns_and_resumes(tmp_path):
    """On a (data 2, model 2) mesh: learns, resumes from the step-8
    checkpoint with only steps 8..12 run, equal to the uninterrupted run,
    and equal to the one-device run of the same schedule."""
    _, mesh = meshes((2, 2), ("data", "model"))
    root = str(tmp_path / "ckpt")
    kw = dict(batch=8, seq_len=16, vocab=32,
              checkpoint_root=root, checkpoint_every=4)
    _, losses = train_lm.train(mesh, n_steps=8, **kw)
    assert len(losses) == 8
    assert losses[-1] < losses[0]          # it learns
    _, more = train_lm.train(mesh, n_steps=12, resume=True, **kw)
    assert len(more) == 4
    _, full = train_lm.train(mesh, n_steps=12, batch=8, seq_len=16,
                             vocab=32, checkpoint_root=str(tmp_path / "c2"),
                             checkpoint_every=100)
    np.testing.assert_allclose(more, full[8:], rtol=1e-6)
    _, single = train_lm.train(None, n_steps=12, batch=8, seq_len=16,
                               vocab=32)
    np.testing.assert_allclose(full, single, rtol=2e-5)


# -- the rest ----------------------------------------------------------------

def test_low_precision_config_dtypes_are_pinned():
    """At ``TransformerConfig(dtype=bfloat16)`` the JAX package's ``init``
    gives f32 dense weights, embedding and head (a bf16 normal times a
    numpy f32 scalar promotes) and only the RMSNorm scales in bf16, so its
    logits are f32; the port keeps every parameter and its logits in the
    config's dtype (a MoE router f32 in both). Neither package changes
    here: a change in either shows in this test."""
    for experts in (0, 4):
        jm = JaxLM(JaxConfig(**CFG, num_experts=experts,
                             dtype=jnp.bfloat16))
        params = jm.init(jax.random.PRNGKey(0))
        tm = TransformerLM(TransformerConfig(**CFG, num_experts=experts,
                                             dtype=torch.bfloat16),
                           device="cpu")
        jd = {k: str(v.dtype) for k, v in named(params).items()}
        td = {k: str(p.dtype).replace("torch.", "")
              for k, p in tm.state_dict().items()}
        assert set(jd) == set(td)
        for name in jd:
            norm = name.split(".")[-1] in ("ln1", "ln2", "ln_f")
            router = name.endswith("router")
            assert jd[name] == ("bfloat16" if norm else "float32"), name
            assert td[name] == ("float32" if router else "bfloat16"), name
        tok = jnp.zeros((1, 4), jnp.int32)
        assert jax.jit(jm.apply)(params, tok).dtype == jnp.float32
        assert tm.apply(torch.zeros(1, 4, dtype=torch.int64)).dtype == \
            torch.bfloat16


def test_as_mesh_takes_none_a_device_mesh_or_a_list():
    assert as_mesh(None) is None
    _, tmesh = meshes((2, 2), ("data", "model"))
    assert as_mesh(tmesh) is tmesh
    listed = as_mesh([CPU, CPU])
    assert listed.axis_names == ("data",) and listed.num_devices == 2
    jmesh, _ = meshes((2,), ("data",))
    with pytest.raises(TypeError, match="parallel.DeviceMesh"):
        as_mesh(jmesh)


def test_mesh_errors_name_the_axis_or_the_dim(pair):
    _, _, tm = pair
    _, tmesh = meshes((2, 2), ("data", "model"))
    tok = torch.zeros((3, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="no 'seq' axis"):
        tm.apply(tok, mesh=tmesh, seq_axis="seq")
    with pytest.raises(ValueError, match=r"batch \(3\) does not split"):
        tm.apply(tok, mesh=tmesh, data_axis="data")
