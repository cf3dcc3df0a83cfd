"""The port's flash_attention (its plain version, on the CPU) against the
JAX package's flash_attention through XLA and the Pallas interpreter.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerance 2e-5 in f32, the JAX kernel tests' own (tests/test_kernels.py);
bf16 outputs are compared in f32 to 1e-2 (one rounding to 8 bits of
mantissa, after f32 sums taken in another order). The CUDA kernel itself
runs only on a GPU: tests/test_torch_cuda.py and chip_smoke.py hold it
against flash_attention_reference there.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tensorframes_tpu.ops import flash_attention as jax_flash_attention
from tensorframes_tpu_torch.ops import (flash_attention,
                                        flash_attention_reference)

fa = importlib.import_module("tensorframes_tpu_torch.ops.flash_attention")

TOL = 2e-5


def _qkv(rng, b=2, sq=64, sk=None, h=2, d=16):
    sk = sq if sk is None else sk
    return (rng.standard_normal((b, sq, h, d)),
            rng.standard_normal((b, sk, h, d)),
            rng.standard_normal((b, sk, h, d)))


def _both(arrays, dtype="float32", impl="xla", **kw):
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    ref = jax_flash_attention(jq, jk, jv, impl=impl, **kw)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrays)
    kw.pop("block_q", None)
    kw.pop("block_k", None)
    before = fa.launches
    out = flash_attention(tq, tk, tv, **kw)
    assert fa.launches == before  # a CPU tensor takes the plain version
    assert out.dtype == tq.dtype and tuple(out.shape) == tuple(ref.shape)
    return np.asarray(ref.astype(jnp.float32)), out.float().numpy()


# the cases of tests/test_kernels.py::TestFlashAttention
@pytest.mark.parametrize("causal", [False, True])
def test_matches_xla(rng, causal):
    ref, out = _both(_qkv(rng), causal=causal)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_non_multiple_seq_len(rng):
    ref, out = _both(_qkv(rng, sq=37))
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_causal_non_multiple(rng):
    ref, out = _both(_qkv(rng, sq=21), causal=True)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(24, 40), (40, 24), (1, 33)])
def test_cross_attention_lengths(rng, causal, sq, sk):
    # Sq != Sk; causal stays top-left (query i sees keys j <= i)
    ref, out = _both(_qkv(rng, b=1, sq=sq, sk=sk, d=8), causal=causal)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_single_block(rng):
    ref, out = _both(_qkv(rng, sq=8))
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_explicit_scale(rng):
    ref, out = _both(_qkv(rng, sq=19, d=8), causal=True, scale=0.3)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_matches_pallas_interpreter(rng):
    ref, out = _both(_qkv(rng, sq=37), impl="interpret", causal=True,
                     block_q=16, block_k=16)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_bfloat16(rng):
    ref, out = _both(_qkv(rng, sq=33), dtype="bfloat16", causal=True)
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2)


def test_float64_plain_version_against_numpy(rng):
    q, k, v = _qkv(rng, b=1, sq=12, sk=9, h=3, d=4)
    out = flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=True).numpy()
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / 2.0
    s = np.where(np.arange(12)[:, None] >= np.arange(9)[None, :], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bkhd->bqhd", p, v)
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)


def test_impl_errors(rng):
    q, k, v = (torch.from_numpy(a).float() for a in _qkv(rng, sq=8))
    with pytest.raises(ValueError, match="Unknown flash_attention impl"):
        flash_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="Unknown flash_attention impl"):
        jax_flash_attention(*(jnp.asarray(a.numpy()) for a in (q, k, v)),
                            impl="pallas-gpu")
    # impl="cuda" insists on the kernel: a CPU tensor cannot take it
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        flash_attention(q.requires_grad_(), k, v, impl="cuda")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fa.flash_attention_cuda(q, k, v)


def test_abstract_inputs_give_shape_only(rng):
    before = fa.launches
    q = torch.empty((2, 5, 3, 8), device="meta")
    k = torch.empty((2, 7, 3, 8), device="meta")
    out = flash_attention(q, k, k, causal=True)
    assert out.device.type == "meta" and tuple(out.shape) == (2, 5, 3, 8)
    with FakeTensorMode():
        fq = torch.empty((1, 4, 2, 16), dtype=torch.bfloat16)
        fout = flash_attention(fq, fq, fq, causal=True)
    assert tuple(fout.shape) == (1, 4, 2, 16)
    assert fout.dtype == torch.bfloat16
    assert fa.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("d", [8, 64, 128])
def test_launch_plan_fits_shared_memory(d, dtype):
    plan = fa.plan_launch(d, dtype)
    assert plan.dmax in (32, 64, 128) and d <= plan.dmax < 2 * max(d, 32)
    size = torch.empty((), dtype=dtype).element_size()
    # rows padded by 16 bytes: fragment loads free of bank conflicts
    assert (plan.row_elems - plan.dmax) * size == 16
    assert plan.smem_bytes == 5 * 64 * plan.row_elems * size  # Q, 2 K, 2 V
    assert plan.smem_bytes <= 232_448  # a block's most on the H100
    with pytest.raises(ValueError, match="head dim"):
        fa.plan_launch(129, dtype)


# The kernel's arithmetic, emulated on the CPU: a TF32 operand is f32 with
# the low 13 mantissa bits masked off, as the kernel splits a value and as
# the tensor cores read one.
def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(eq, a, b):
    """An f32 product as three TF32 products summed in f32: a_lo.b_hi +
    a_hi.b_lo + a_hi.b_hi, each TF32 product exact in f32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def _emulated_kernel(q, k, v, causal):
    """flash_attention_reference's algorithm with the kernel's products:
    3xTF32 for f32; for bf16 and f16, q.k exact in f32 and p split into
    two halves of the input type against the exact v."""
    scale = 1.0 / q.shape[-1] ** 0.5
    qf, kf, vf = (t.float() for t in (q, k, v))
    if q.dtype == torch.float32:
        scores = _mm_3xtf32("bqhd,bkhd->bhqk", qf, kf) * scale
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        sq, sk = scores.shape[-2:]
        mask = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    if q.dtype == torch.float32:
        return _mm_3xtf32("bhqk,bkhd->bqhd", p, vf)
    p_hi = p.to(q.dtype).float()
    p_lo = (p - p_hi).to(q.dtype).float()
    return (torch.einsum("bhqk,bkhd->bqhd", p_lo, vf)
            + torch.einsum("bhqk,bkhd->bqhd", p_hi, vf)).to(q.dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1e-2),
                                       (torch.float16, 1e-2)], ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [dict(), dict(sq=37), dict(sq=21),
                                   dict(b=1, sq=24, sk=40, d=8),
                                   dict(b=1, sq=40, sk=24, d=8),
                                   dict(b=1, sq=1, sk=33, d=8),
                                   dict(b=1, sq=300, h=1, d=64),
                                   dict(b=1, sq=128, h=1, d=128)], ids=str)
def test_split_products_hold_the_tolerance(rng, dtype, tol, causal, shape):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(rng, **shape))
    want = flash_attention_reference(q.double(), k.double(), v.double(),
                                     causal=causal)
    got = _emulated_kernel(q, k, v, causal)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=tol,
                               atol=tol)


def test_a_program_calling_attention_serializes_through_the_op(rng):
    """Capture traces the op ``tft::flash_attention`` (its fake kernel), so
    a shipped program that calls attention keeps it: deserialized, it runs
    the plain version on the CPU (the kernel on the card)."""
    import tensorframes_tpu_torch as ttf

    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    try:
        comp = ttf.Computation.trace(
            lambda x: {"z": flash_attention(x, x, x, causal=True)},
            [ttf.TensorSpec("x", ttf.dtypes.float32, ttf.Shape(-1, 6, 2, 8))])
        back = ttf.Computation.deserialize(comp.serialize())
        called = [n.target for n in back.fn.exported.graph.nodes
                  if n.op == "call_function"]
        assert torch.ops.tft.flash_attention.default in called
        x = rng.standard_normal((3, 6, 2, 8)).astype(np.float32)
        rows = ttf.map_blocks(back, ttf.frame({"x": x})).collect()
    finally:
        ttf.set_default_device(prev)
    got = np.stack([np.asarray(r["z"]) for r in rows])
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        got, flash_attention_reference(t, t, t, causal=True).numpy())
