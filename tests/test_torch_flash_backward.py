"""The gradients of the port's flash_attention on the CPU against the JAX
package's.

The JAX package has no backward kernel: it differentiates its plain
attention (``flash_attention(..., impl="xla")``) with ``jax.vjp``. The
port's plain backward (autograd of ``flash_attention_reference``, what the
op ``tft::flash_attention`` runs for a CPU tensor) is held against that on
inputs drawn with numpy from a seed: f32 to 1e-5. At f64 the JAX package's
plain attention still takes its scores in f32 (``preferred_element_type=
jnp.float32``) and casts ``v`` to f32, so its gradients are f32's: there
``jax.vjp`` is held to 1e-5, and the port's f64 backward to 1e-12 against
numpy's closed form. The CUDA backward kernel runs only on a GPU:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it against this
plain version there.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tensorframes_tpu.ops import flash_attention as jax_flash_attention

fa = importlib.import_module("tensorframes_tpu_torch.ops.flash_attention")
fab = importlib.import_module(
    "tensorframes_tpu_torch.ops.flash_attention_backward")

LENGTHS = [(16, 16), (24, 40), (40, 24), (1, 33), (65, 63), (5, 0)]


def _arrays(seed, sq, sk, b=2, h=2, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)) for s in (sq, sk, sk, sq)]


def _jax_grads(arrays, dtype, causal):
    q, k, v, g = (jnp.asarray(a, dtype) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(
        q, k, v, causal=causal, impl="xla"), q, k, v)
    return [np.asarray(t) for t in vjp(g)]


def _numpy_grads(arrays, causal):
    """The closed form in f64: P = softmax(q k^T / sqrt(d) [masked]),
    dv = P^T g, dP = g v^T, dS = P (dP - rowsum(P dP)), dq = dS k / sqrt(d),
    dk = dS^T q / sqrt(d)."""
    q, k, v, g = arrays
    c = 1.0 / np.sqrt(q.shape[-1])
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * c
    if causal:
        keep = np.arange(q.shape[1])[:, None] >= np.arange(k.shape[1])[None]
        s = np.where(keep, s, -1e30)
    if k.shape[1]:
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
    else:
        p = s
    dp = np.einsum("bqhd,bkhd->bhqk", g, v)
    ds = p * (dp - (p * dp).sum(-1, keepdims=True))
    return (np.einsum("bhqk,bkhd->bqhd", ds, k) * c,
            np.einsum("bhqk,bqhd->bkhd", ds, q) * c,
            np.einsum("bhqk,bqhd->bkhd", p, g))


def _port_grads(arrays, dtype, causal):
    """Through the public entry point: inputs that require grad take the
    op ``tft::flash_attention`` and its autograd formula."""
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in arrays)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    before = (fa.launches, fab.launches)
    out = fa.flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, g)
    assert (fa.launches, fab.launches) == before  # the CPU: no kernel
    direct = fab.flash_attention_backward_reference(q, k, v, g, causal)
    for a, b in zip(grads, direct):
        assert torch.equal(a, b)
    return [t.numpy() for t in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", LENGTHS)
def test_plain_backward_matches_jax_vjp_f32(causal, sq, sk):
    arrays = _arrays(sq * 3 + sk, sq, sk)
    want = _jax_grads(arrays, jnp.float32, causal)
    got = _port_grads(arrays, torch.float32, causal)
    for w, x in zip(want, got):
        assert x.dtype == np.float32 and x.shape == w.shape
        np.testing.assert_allclose(x, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", LENGTHS)
def test_plain_backward_f64(causal, sq, sk):
    arrays = _arrays(sq * 5 + sk, sq, sk)
    got = _port_grads(arrays, torch.float64, causal)
    for w, x in zip(_numpy_grads(arrays, causal), got):
        assert x.dtype == np.float64
        np.testing.assert_allclose(x, w, rtol=1e-12, atol=1e-12)
    for w, x in zip(_jax_grads(arrays, jnp.float64, causal), got):
        np.testing.assert_allclose(x, w, rtol=1e-5, atol=1e-5)


def test_no_key_rows_get_zero_gradients():
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(1, 4, 0))
    q.requires_grad_()
    out = fa.flash_attention(q, k, v, causal=True)
    (dq,) = torch.autograd.grad(out, [q], g)
    assert torch.equal(dq, torch.zeros_like(dq))
    _, lse = torch.ops.tft.flash_attention(q.detach(), k, v, True, 0.5, True)
    assert tuple(lse.shape) == (4, 4) and bool(torch.isneginf(lse).all())


@pytest.mark.parametrize("causal", [False, True])
def test_op_writes_the_log_sum_exp_only_when_asked(causal):
    q, k, v, _ = (torch.from_numpy(a).float() for a in _arrays(2, 9, 7))
    out, lse = torch.ops.tft.flash_attention(q, k, v, causal, 0.3, True)
    torch.testing.assert_close(
        out, fa.flash_attention_reference(q, k, v, causal, 0.3),
        rtol=0, atol=0)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.3
    if causal:
        s = s.masked_fill(~torch.ones(9, 7, dtype=torch.bool).tril(), -1e30)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(4, 9),
                               rtol=1e-6, atol=1e-6)
    _, none = torch.ops.tft.flash_attention(q, k, v, causal, 0.3, False)
    assert none.numel() == 0
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        fo, fl = torch.ops.tft.flash_attention(fq, fk, fv, causal, 0.3, True)
        assert tuple(fo.shape) == tuple(q.shape)
        assert tuple(fl.shape) == (4, 9) and fl.dtype == torch.float32


def test_every_call_goes_through_the_op(monkeypatch):
    """Every call takes the op; the log-sum-exp is asked for only when a
    backward will follow on a tensor off the CPU (the plain backward of a
    CPU tensor does not read it): not under ``torch.no_grad()``, not for
    inputs that need no grad, not on the CPU."""
    calls = []
    op = torch.ops.tft.flash_attention

    class Spy:
        def __call__(self, *a):
            calls.append(a[-1])
            return op(*a)

        def __getattr__(self, name):  # the fake kernel looks up .default
            return getattr(op, name)

    monkeypatch.setattr(torch.ops.tft, "flash_attention", Spy())
    q = torch.ones((1, 3, 2, 4), requires_grad=True)
    with torch.no_grad():
        fa.flash_attention(q, q, q)
    fa.flash_attention(q.detach(), q.detach(), q.detach())
    fa.flash_attention(q, q, q).sum().backward()
    assert calls == [False, False, False]
    m = torch.ones((1, 3, 2, 4), device="meta", requires_grad=True)
    assert fa.flash_attention(m, m, m).shape == m.shape
    assert calls == [False, False, False, True]


def test_backward_plan_fits_the_card():
    for d in (1, 8, 32, 33, 40, 64, 65, 100, 128):
        plan = fab.plan_backward(d)
        assert plan.dmax >= d and plan.dmax in (32, 64, 128)
        assert plan.smem_dq < plan.smem_dkdv <= 232_448
    assert fab.plan_backward(64) == (64, 4 * (4 * 64 * 68 + 128 + 2 * 64 * 68),
                                     4 * (4 * 64 * 68 + 128 + 64 * 68))
    with pytest.raises(ValueError, match="head dim"):
        fab.plan_backward(129)


def test_backward_wrapper_takes_cuda_tensors_only():
    q = torch.ones((1, 4, 2, 8))
    lse = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fab.flash_attention_backward_cuda(q, q, q, q, lse, q)
