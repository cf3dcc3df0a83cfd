"""The port's TransformerLM on the CPU against the JAX package's.

One small config (``tests/test_models.py``'s: vocab 64, d_model 32, 4
heads, 2 layers, d_ff 64). The JAX package's weights are carried into the
port with ``params_from_jax``, so both packages compute the same function;
logits and losses agree to rtol/atol 2e-4, the JAX tests' own bound
(``tests/test_models.py:206-214``), and greedy decoding token for token.
Sampling draws from another generator than ``jax.random``, so the sampled
via-frame test checks the contract (streams by block content,
reproducible), not the bits, as the JAX package's own test does.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu.models.transformer import (
    TransformerConfig as JaxConfig, TransformerLM as JaxLM,
    _rms_norm as jax_rms_norm, _rope as jax_rope)
from tensorframes_tpu_torch.models import (TransformerConfig, TransformerLM,
                                           params_from_jax)
from tensorframes_tpu_torch.models import transformer as port_transformer
from torch_parity import schema_tuple

fa = importlib.import_module("tensorframes_tpu_torch.ops.flash_attention")

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
TOL = 2e-4


@pytest.fixture(scope="module")
def pair():
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    jm = JaxLM(JaxConfig(**SMALL))
    params = jm.init(jax.random.PRNGKey(1))
    tm = TransformerLM(TransformerConfig(**SMALL), device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    yield jm, params, tm
    ttf.set_default_device(prev)


def _tokens(seed, shape, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_rope_and_rms_norm_match(rng):
    x = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
    pos = np.arange(3, 10)
    want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = port_transformer._rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 10000.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jax_rms_norm(jnp.asarray(h), jnp.asarray(scale)))
    got = port_transformer._rms_norm(torch.from_numpy(h),
                                     torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_params_from_jax_carries_every_weight_as_is(pair):
    _, params, tm = pair
    state = tm.state_dict()
    carried = params_from_jax(params)
    assert sorted(carried) == sorted(state)
    for name, t in carried.items():
        assert tuple(t.shape) == tuple(state[name].shape), name
        assert torch.equal(t, state[name]), name
    # embed already carries its sqrt(d_model) factor: not scaled again
    np.testing.assert_array_equal(state["embed"].numpy(),
                                  np.asarray(params["embed"]))


def test_apply_and_loss_match_the_jax_package(pair):
    jm, params, tm = pair
    toks = _tokens(0, (2, 12))
    tgt = np.roll(toks, -1, axis=1)
    want = np.asarray(jm.apply(params, jnp.asarray(toks)))
    logits, aux = tm.apply_with_aux(torch.from_numpy(toks))
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, 12, 64)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.apply(torch.from_numpy(toks)).numpy(),
                               want, rtol=TOL, atol=TOL)
    want_loss = float(jm.loss(params, jnp.asarray(toks), jnp.asarray(tgt)))
    got_loss = float(tm.loss(torch.from_numpy(toks), torch.from_numpy(tgt)))
    np.testing.assert_allclose(got_loss, want_loss, rtol=TOL, atol=TOL)


def test_causality(pair):
    _, _, tm = pair
    tok = torch.zeros((1, 8), dtype=torch.int32)
    tok[0, 4] = 7
    logits = tm.apply(tok)
    tok2 = tok.clone()
    tok2[0, 4] = 9
    logits2 = tm.apply(tok2)
    np.testing.assert_allclose(logits[0, :4].numpy(), logits2[0, :4].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(logits[0, 4:].numpy(), logits2[0, 4:].numpy())


def test_cached_forward_matches_apply(pair):
    # teacher forcing through the cache (prefill + per-token decode)
    jm, params, tm = pair
    toks = _tokens(0, (2, 12))
    ref = tm.apply(torch.from_numpy(toks))
    want = np.asarray(jm.apply(params, jnp.asarray(toks)))
    T = 12
    cache = tm.init_cache(2, T)
    assert tuple(cache["layers"][0]["k"].shape) == (2, T, 4, 8)
    lg, cache = tm._forward_cached(cache, torch.from_numpy(toks[:, :5]), 0, T)
    np.testing.assert_allclose(lg.numpy(), ref[:, :5].numpy(),
                               rtol=TOL, atol=TOL)
    for pos in range(5, 12):
        lg, cache = tm._forward_cached(
            cache, torch.from_numpy(toks[:, pos:pos + 1]), pos, T)
        np.testing.assert_allclose(lg[:, 0].numpy(), ref[:, pos].numpy(),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lg[:, 0].numpy(), want[:, pos],
                                   rtol=TOL, atol=TOL)


def test_greedy_generate_matches_the_jax_package(pair):
    jm, params, tm = pair
    prompt = _tokens(3, (3, 5))
    want = np.asarray(jm.generate(params, jnp.asarray(prompt), 6))
    got = tm.generate(torch.from_numpy(prompt), 6)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 11)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tm.generate(torch.from_numpy(prompt), 6),
                                  got)


def test_greedy_equals_stepwise_argmax(pair):
    _, _, tm = pair
    prompt = np.asarray([[7, 3, 11, 2]], np.int32)
    out = tm.generate(torch.from_numpy(prompt), 4).numpy()
    toks = prompt
    for _ in range(4):
        lg = tm.apply(torch.from_numpy(toks))
        nxt = np.argmax(lg[:, -1].numpy(), axis=-1)
        toks = np.concatenate([toks, nxt[:, None].astype(np.int32)], axis=1)
    np.testing.assert_array_equal(out, toks)


def test_sampling_needs_rng_and_runs(pair):
    jm, params, tm = pair
    prompt = torch.tensor([[1, 2]], dtype=torch.int32)
    with pytest.raises(ValueError, match="needs rng"):
        tm.generate(prompt, 3, temperature=0.8)
    with pytest.raises(ValueError, match="needs rng"):
        jm.generate(params, jnp.asarray(prompt.numpy()), 3, temperature=0.8)
    out = tm.generate(prompt, 3, temperature=0.8,
                      rng=torch.Generator().manual_seed(7))
    again = tm.generate(prompt, 3, temperature=0.8,
                        rng=torch.Generator().manual_seed(7))
    assert tuple(out.shape) == (1, 5)
    assert ((out >= 0) & (out < 64)).all()
    np.testing.assert_array_equal(out, again)


def test_generate_via_frame_matches_generate_and_the_jax_frame(pair):
    jm, params, tm = pair
    prompts = np.asarray([[1, 2, 3, 4], [9, 8, 7, 6], [5, 5, 5, 5]],
                         np.int64)
    out = tm.generate_via_frame(ttf.analyze(ttf.frame({"prompt": prompts})),
                                max_new_tokens=3)
    jout = jm.generate_via_frame(
        params, jtf.analyze(jtf.frame({"prompt": prompts})),
        max_new_tokens=3)
    assert schema_tuple(out.schema) == schema_tuple(jout.schema)
    comp = out.blocks()[0].columns["completion"]
    want = jout.blocks()[0].columns["completion"]
    assert comp.dtype == want.dtype == np.int32 and comp.shape == (3, 7)
    np.testing.assert_array_equal(
        comp, tm.generate(torch.from_numpy(prompts), 3).numpy())
    np.testing.assert_array_equal(comp, want)


def test_generate_via_frame_sampling_independent_blocks(pair):
    # the contract of tests/test_models.py:282-317: streams follow block
    # content; identical content reproduces exactly
    _, _, tm = pair
    key = torch.Generator().manual_seed(3)
    prompts = np.asarray([[1, 2, 3, 4]] * 4, np.int64)
    df = ttf.analyze(ttf.frame({"prompt": prompts}, num_partitions=2))
    out = tm.generate_via_frame(df, max_new_tokens=6, temperature=1.5,
                                rng=key)
    blocks = [b.columns["completion"] for b in out.blocks()]
    assert len(blocks) == 2
    np.testing.assert_array_equal(blocks[0], blocks[1])
    prompts2 = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int64)
    df2 = ttf.analyze(ttf.frame({"prompt": prompts2}, num_partitions=2))
    out2 = tm.generate_via_frame(df2, max_new_tokens=6, temperature=1.5,
                                 rng=key)
    b2 = [b.columns["completion"] for b in out2.blocks()]
    assert not np.array_equal(blocks[0][0], b2[0][0]), (blocks[0][0], b2[0][0])
    again = tm.generate_via_frame(df2, max_new_tokens=6, temperature=1.5,
                                  rng=key)
    a2 = [b.columns["completion"] for b in again.blocks()]
    np.testing.assert_array_equal(b2[0], a2[0])
    np.testing.assert_array_equal(b2[1], a2[1])


def test_capture_runs_no_forward(pair, monkeypatch):
    """Capture infers the completion's shape on abstract tensors: the
    model runs no real forward until the blocks are computed."""
    _, _, tm = pair
    real = []
    block_cached = TransformerLM._block_cached

    def spy(self, lp, ck, x, *a, **k):
        real.append(not port_transformer._is_abstract(x))
        return block_cached(self, lp, ck, x, *a, **k)

    monkeypatch.setattr(TransformerLM, "_block_cached", spy)
    prompts = np.asarray([[1, 2, 3], [4, 5, 6]], np.int64)
    df = ttf.analyze(ttf.frame({"prompt": prompts}))
    out = tm.generate_via_frame(df, max_new_tokens=2,
                                rng=torch.Generator().manual_seed(1),
                                temperature=1.0)
    assert not any(real)
    assert out.schema["completion"].block_shape.dims[1:] == (5,)
    out.blocks()
    assert real and all(real)  # 1 prefill + 2 decodes, 2 layers each
    assert len(real) == 6


def test_capture_of_a_closure_over_the_model_is_abstract(pair, monkeypatch):
    # a user's map_blocks over model.apply: shapes come from meta or fake
    # probes, which launch nothing and run no plain attention on data
    _, _, tm = pair
    calls = []
    ref = fa.flash_attention_reference
    monkeypatch.setattr(fa, "flash_attention_reference",
                        lambda *a, **k: calls.append(1) or ref(*a, **k))
    toks = _tokens(5, (3, 6)).astype(np.int64)
    df = ttf.analyze(ttf.frame({"tokens": toks}))
    out = ttf.map_blocks(lambda tokens: {"logits": tm.apply(tokens)}, df,
                         trim=True)
    assert not calls
    assert out.schema["logits"].block_shape.dims[1:] == (6, 64)
    got = out.blocks()[0].columns["logits"]
    assert calls  # the real run takes the plain version on the CPU
    np.testing.assert_allclose(got, tm.apply(torch.from_numpy(toks)).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_init_is_seeded_and_scaled():
    cfg = TransformerConfig(**SMALL)
    a = TransformerLM(cfg, device="cpu")
    b = TransformerLM(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    c = TransformerLM(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    for (name, x), y, z in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
        if not name.endswith(("ln1", "ln2", "ln_f")):
            assert not torch.equal(x, z), name
    assert not any(p.requires_grad for p in a.parameters())
    # sqrt(1/fan_in) scale, embed also times sqrt(d_model)
    np.testing.assert_allclose(float(a.layers[0].wq.std()), 32 ** -0.5,
                               rtol=0.1)
    np.testing.assert_allclose(float(a.embed.std()), 1.0, rtol=0.1)


def test_unported_paths_raise(pair, monkeypatch):
    """The mesh paths and the MoE layers are ported (their parity is in
    ``test_torch_mesh_training.py`` and ``test_torch_moe_pipeline.py``):
    a mesh of another type than ``parallel.DeviceMesh`` is refused, a
    ``seq_axis`` without a mesh is ignored as in the JAX package, a MoE
    model builds and ``params_from_jax`` carries a layer's ``"moe"``
    dict; the cluster's entry points are exported like the JAX package's
    and answer single-process when no cluster is configured."""
    jm, params, tm = pair
    tok = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="parallel.DeviceMesh"):
        tm.apply(tok, mesh=object(), seq_axis="seq")
    tgt = torch.ones((1, 4), dtype=torch.int32)
    want = jm.loss(params, jnp.zeros((1, 4), jnp.int32),
                   jnp.ones((1, 4), jnp.int32), seq_axis="seq")
    np.testing.assert_allclose(float(tm.loss(tok, tgt, seq_axis="seq")),
                               float(want), rtol=TOL)
    moe = TransformerLM(TransformerConfig(**SMALL, num_experts=4),
                        device="cpu")
    assert tuple(moe.layers[0].moe.w1.shape) == (4, 32, 64)
    layer = {**params["layers"][0], "moe": {
        "router": np.zeros((32, 4), np.float32),
        "w1": np.zeros((4, 32, 64), np.float32),
        "w2": np.zeros((4, 64, 32), np.float32)}}
    del layer["w1"], layer["w2"]
    state = params_from_jax(dict(params, layers=[layer]))
    assert "layers.0.moe.w1" in state and "layers.0.w1" not in state
    from tensorframes_tpu import parallel as jpar
    from tensorframes_tpu_torch import parallel as tpar
    for name in ("cluster_mesh", "distribute_local", "initialize"):
        assert name in tpar.__all__
    assert sorted(tpar.__all__) == sorted(jpar.__all__)
    for var in ("TFT_COORDINATOR", "TFT_NUM_PROCESSES", "TFT_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tpar.initialize() is False  # no cluster configured
    # the default device is cuda: without a GPU the model refuses to build
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = ttf.default_device()
    ttf.set_default_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="no GPU"):
            TransformerLM(TransformerConfig(**SMALL))
    finally:
        ttf.set_default_device(prev)
