"""The port's single-device training on the CPU against the JAX package's.

The transformer's train step (``make_sharded_train_step``, adam) at
``tests/test_models.py``'s ``CFG`` against the JAX step on a one-device
CPU mesh, both from the JAX package's initial parameters (carried with
``params_from_jax``) and the same numpy batch:

- step 0's gradients to 1e-5 of each parameter's max-abs gradient (f32
  products summed in other orders through 2 layers);
- the loss of each of 5 steps to 2e-6 relative at f32: adam's first
  update is about ``lr`` in size whatever the gradient's, so the
  parameters agree to f32 rounding and so do the losses;
- at f64, the parameters after 5 steps to 1e-6 absolute (1e-4 of the
  learning rate). Both packages keep pieces of the forward in f32 at f64
  (the JAX package's attention scores, both packages' RMSNorm statistics
  and cross-entropy), so the gradients agree to about f32's rounding, and
  an element's adam update, ``lr * m / (sqrt(v) + eps)``, moves with the
  gradient's relative error.

Also the mirrors of ``TestTransformer::test_sharded_train_step``'s
single-device case and ``TestGenerate::test_trained_model_continues_
sequence`` (through the ported ``train_lm`` demo), the demo's resume, and
the mesh paths that raise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tensorframes_tpu_torch as ttf
from tensorframes_tpu.models.transformer import (
    TransformerConfig as JaxConfig, TransformerLM as JaxLM)
from tensorframes_tpu.parallel.mesh import DeviceMesh
from tensorframes_tpu_torch.demos import train_lm
from tensorframes_tpu_torch.models import (LogisticRegression,
                                           TransformerConfig, TransformerLM,
                                           params_from_jax)
from tensorframes_tpu_torch.models import transformer as port_transformer
from tensorframes_tpu_torch.utils import checkpoint as ckpt

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
LR = 1e-2


@pytest.fixture(autouse=True)
def on_cpu():
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    yield
    ttf.set_default_device(prev)


def _batch(seed=2, shape=(8, 8)):
    tok = np.random.default_rng(seed).integers(0, 64, shape).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def _both(jdtype, tdtype):
    mesh = DeviceMesh(Mesh(np.array(jax.devices()[:1]), ("data",)),
                      data_axis="data")
    jm = JaxLM(JaxConfig(**CFG, dtype=jdtype))
    jstep, jinit = jm.make_sharded_train_step(mesh, learning_rate=LR)
    jstate = jinit(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jstate["params"])
    tm = TransformerLM(TransformerConfig(**CFG, dtype=tdtype), device="cpu")
    tstep, tinit = tm.make_sharded_train_step(learning_rate=LR)
    return (jm, jstep, jstate, params), (tm, tstep, tinit(
        params_from_jax(params)))


def test_step0_gradients_match_the_jax_package():
    (jm, _, _, params), (tm, _, state) = _both(jnp.float32, torch.float32)
    tok, tgt = _batch()
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(tok), jnp.asarray(tgt)))(
        jax.tree_util.tree_map(jnp.asarray, params))
    loss, grads = tm.loss_and_grads(state["params"], torch.from_numpy(tok),
                                    torch.from_numpy(tgt))
    assert abs(float(loss) - float(jloss)) <= 2e-6 * float(jloss)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(want) == sorted(grads)
    for name, w in want.items():
        g = grads[name]
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        top = float(w.abs().max())
        assert top > 0, name
        assert float((g - w).abs().max()) <= 1e-5 * top, name
    # the state is read, never changed
    assert all(torch.equal(state["params"][k], v)
               for k, v in params_from_jax(params).items())


def test_each_steps_loss_matches_the_jax_package_f32():
    (_, jstep, jstate, _), (_, tstep, tstate) = _both(jnp.float32,
                                                      torch.float32)
    tok, tgt = _batch()
    for i in range(5):
        jstate, jl = jstep(jstate, jnp.asarray(tok), jnp.asarray(tgt))
        tstate, tl = tstep(tstate, torch.from_numpy(tok),
                           torch.from_numpy(tgt))
        assert tl.dtype == torch.float32 and tl.dim() == 0
        assert abs(float(tl) - float(jl)) <= 2e-6 * float(jl), i
    assert int(tstate["opt"]["count"]) == 5


def test_parameters_after_five_adam_steps_match_at_f64():
    (_, jstep, jstate, _), (_, tstep, tstate) = _both(jnp.float64,
                                                      torch.float64)
    tok, tgt = _batch()
    for _ in range(5):
        jstate, _ = jstep(jstate, jnp.asarray(tok), jnp.asarray(tgt))
        tstate, _ = tstep(tstate, torch.from_numpy(tok),
                          torch.from_numpy(tgt))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                  jstate["params"]))
    for name, w in want.items():
        got = tstate["params"][name]
        assert got.dtype == torch.float64 == w.dtype, name
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    for name in ("mu", "nu"):
        jm = jstate["opt"][0]
        moment = params_from_jax(jax.tree_util.tree_map(
            np.asarray, getattr(jm, name)))
        for k, w in moment.items():
            np.testing.assert_allclose(
                tstate["opt"][name][k].numpy(), w.numpy(),
                rtol=1e-5, atol=1e-9 if name == "mu" else 1e-12,
                err_msg=f"{name} {k}")


def test_adam_update_is_optax_adam():
    """One update by hand: ``mu = (1-b1) g``, ``nu = (1-b2) g^2``, bias-
    corrected, ``p -= lr * mu_hat / (sqrt(nu_hat) + eps)``."""
    p = {"w": torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)}
    g = {"w": torch.tensor([0.3, -1e-9, 0.0], dtype=torch.float64)}
    opt = port_transformer.adam_init(p)
    port_transformer.adam_update(p, g, opt, 0.1)
    want = np.array([1.0, -2.0, 0.5]) - 0.1 * np.array(
        [0.3, -1e-9, 0.0]) / (np.abs([0.3, -1e-9, 0.0]) + 1e-8)
    np.testing.assert_allclose(p["w"].numpy(), want, rtol=1e-15, atol=0)
    assert int(opt["count"]) == 1


@pytest.mark.parametrize("mesh", [None, [torch.device("cpu")]],
                         ids=["none", "one_device"])
def test_sharded_train_step_single_device(mesh):
    """``TestTransformer::test_sharded_train_step``'s pure-dp case on one
    device: 5 steps at lr 1e-2 on one batch lower the loss."""
    model = TransformerLM(TransformerConfig(**CFG), device="cpu")
    step, init_state = model.make_sharded_train_step(mesh,
                                                     learning_rate=1e-2)
    state = init_state(torch.Generator().manual_seed(0))
    tok, tgt = _batch(seed=2)
    losses = []
    for _ in range(5):
        state, loss = step(state, torch.from_numpy(tok),
                           torch.from_numpy(tgt))
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()
    # the model's own weights are untouched and frozen
    assert not any(p.requires_grad for p in model.parameters())
    fresh = TransformerLM(TransformerConfig(**CFG), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), fresh.state_dict().values()))


def test_init_state_draws_or_takes_parameters():
    model = TransformerLM(TransformerConfig(**CFG), device="cpu")
    _, init_state = model.make_sharded_train_step()
    a = init_state()
    b = init_state(torch.Generator().manual_seed(0))
    c = init_state(torch.Generator().manual_seed(1))
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    assert not torch.equal(a["params"]["head"], c["params"]["head"])
    assert int(a["opt"]["count"]) == 0
    assert all(float(m.abs().max()) == 0 for m in a["opt"]["mu"].values())
    with pytest.raises(KeyError, match="do not match"):
        init_state({"embed": a["params"]["embed"]})


def test_multi_device_mesh_and_mesh_axes_raise():
    """The mesh steps are ported (``test_torch_mesh_training.py``): a list
    of devices is a one-axis data mesh whose step equals the one-device
    step, model, seq and expert axes are accepted (each acting only where
    the mesh has it), and only a mesh of another type raises, as does a
    pipelined step over a mesh without a pipe axis."""
    model = TransformerLM(TransformerConfig(**CFG), device="cpu")
    two = [torch.device("cpu"), torch.device("cpu")]
    jax_mesh = DeviceMesh(Mesh(np.array(jax.devices()[:2]), ("data",)),
                          data_axis="data")
    assert port_transformer.as_mesh(two).shape == {"data": 2}
    assert port_transformer.as_mesh(None) is None
    with pytest.raises(TypeError, match="parallel.DeviceMesh"):
        model.make_sharded_train_step(jax_mesh)
    with pytest.raises(TypeError, match="parallel.DeviceMesh"):
        LogisticRegression(4, device="cpu").make_sharded_train_step(jax_mesh)
    tok, tgt = _batch()
    params = port_transformer.params_from_jax(
        jax.tree_util.tree_map(np.asarray, JaxLM(JaxConfig(**CFG)).init()))
    runs = []
    for mesh, axes in [(None, {}), (two, {}),
                       (None, {"model_axis": "x", "seq_axis": "y",
                               "expert_axis": "z"}),
                       (two, {"seq_axis": "seq", "expert_axis": "e"})]:
        step, init_state = model.make_sharded_train_step(
            mesh, learning_rate=LR, **axes)
        state, loss = step(init_state(params), tok, tgt)
        runs.append(float(loss))
    np.testing.assert_allclose(runs, runs[0], rtol=1e-6)
    lr = LogisticRegression(4, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 4)).astype(np.float32))
    y = (x[:, 0] > 0).to(torch.float32)
    a, la = lr.make_sharded_train_step(two)(lr.init(), x, y)
    b, lb = lr.make_sharded_train_step(None)(lr.init(), x, y)
    torch.testing.assert_close(la, lb, rtol=1e-6, atol=0)
    with pytest.raises(KeyError, match="pipe"):
        model.make_pipelined_train_step(two)


def test_trained_model_continues_sequence():
    """``TestGenerate::test_trained_model_continues_sequence`` through the
    ported demo: train on +1/+2 modular sequences, then continue a +1
    prompt greedily."""
    vocab = 32
    cfg = TransformerConfig(vocab_size=vocab, d_model=64, n_heads=8,
                            n_layers=2, d_ff=128)
    state, losses = train_lm.train(None, n_steps=60, batch=16, seq_len=16,
                                   vocab=vocab, config=cfg,
                                   learning_rate=3e-3)
    assert losses[-1] < 0.3, losses[-1]
    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict(state["params"])
    start = 5
    prompt = torch.tensor([[(start + i) % vocab for i in range(8)]])
    out = model.generate(prompt, max_new_tokens=6)
    assert out[0].tolist() == [(start + i) % vocab for i in range(14)]


@pytest.fixture
def deterministic():
    """``torch.use_deterministic_algorithms(True)``: the embedding's
    backward (an accumulating ``index_put_``) otherwise sums in an order
    that changes from run to run, on the CPU's threads as on the card."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def test_demo_resume_equals_an_uninterrupted_run(tmp_path, deterministic):
    """``train_lm.main``'s crash and resume: 30 steps with a checkpoint
    every 10, then a resume to 40, whose state equals 40 uninterrupted
    steps bit for bit."""
    root = str(tmp_path / "ckpt")
    out = train_lm.main(checkpoint_root=root)
    assert out["resumed_from"] == 30 and len(out["losses"]) == 40
    assert out["final_loss"] < out["first_loss"] / 10
    assert out["continuation"] == list(range(18, 26))
    assert sorted(os.listdir(root)) == [f"step_{s:08d}"
                                        for s in (10, 20, 30, 40)]
    straight, losses = train_lm.train(n_steps=40)
    assert losses == out["losses"]
    resumed, at = ckpt.restore_step(root)
    assert at == 40
    for k, v in straight["params"].items():
        assert torch.equal(torch.as_tensor(resumed["params"][k]), v), k
    assert int(resumed["opt"]["count"]) == 40
