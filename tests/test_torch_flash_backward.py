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

import chip_smoke
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
    """Six 64-row tiles in the input type (rows padded by 4 words for f32,
    16 bytes for bf16 and f16), the dk/dv kernel's two stages of lse and
    delta besides; within a block's 232,448 bytes, and two blocks an SM
    (228 KB, 1 KB of it reserved a block) at head dims up to 64."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in (1, 8, 32, 33, 40, 64, 65, 100, 128):
            plan = fab.plan_backward(d, dtype)
            assert plan.dmax >= d and plan.dmax in (32, 64, 128)
            assert plan.smem_dq < plan.smem_dkdv <= 232_448
            if plan.dmax <= 64:
                assert 2 * (plan.smem_dkdv + 1024) <= 233_472
    assert fab.plan_backward(64) == (64, 4 * 6 * 64 * 68 + 2 * 2 * 64 * 4,
                                     4 * 6 * 64 * 68)
    assert fab.plan_backward(64, torch.bfloat16) == (
        64, 2 * 6 * 64 * 72 + 2 * 2 * 64 * 4, 2 * 6 * 64 * 72)
    assert fab.plan_backward(8, torch.float16) == (
        32, 2 * 6 * 64 * 40 + 2 * 2 * 64 * 4, 2 * 6 * 64 * 40)
    assert fab.plan_backward(128) == (128, 4 * 6 * 64 * 132 + 2 * 2 * 64 * 4,
                                      4 * 6 * 64 * 132)
    with pytest.raises(ValueError, match="head dim"):
        fab.plan_backward(129)


def test_backward_wrapper_takes_cuda_tensors_only():
    q = torch.ones((1, 4, 2, 8))
    lse = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fab.flash_attention_backward_cuda(q, q, q, q, lse, q)


# The kernels' operand rounding, emulated: the five products computed in
# f64 from the operands as the tensor cores read them, against the f64
# plain backward, to chip_smoke.py's tolerances (each cotangent's max-abs).
# f32: every product 3xTF32, a = hi + lo, a.b ~ lo.b_hi + hi.b_lo +
# hi.b_hi, by one of the _SPLITS rules: "rna", the kernel's (hi rounded
# to TF32 to nearest, ties away; lo = a - hi, which the tensor cores read
# truncated to TF32: its low 13 bits cleared), "trunc", the forward's (hi
# truncated too), "cvt_rna" (lo rounded to nearest as well); P and dS
# formed in f32 from f32 scores. bf16 and f16: S and dP exact (f32
# accumulation of exact products), P and dS rounded once to the input
# type. The gradients are
# rounded to the input type. Not emulated: the order and rounding of the
# tensor cores' own f32 sums, which the card's checks see.
FLASH_BWD_TOL = chip_smoke.FLASH_BWD_TOL
_SPLITS = ("rna", "trunc", "cvt_rna")
_LOG2E = np.float32(1.4426950408889634)


def _tf32(x, nearest):
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if nearest:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xffffe000)).view(np.float32)


def _split(x, rule):
    x = np.asarray(x, np.float32)
    hi = _tf32(x, rule != "trunc")
    return (hi.astype(np.float64),
            _tf32(x - hi, rule == "cvt_rna").astype(np.float64))


def _mm3(a, b, rule):
    """``a @ b`` as 3xTF32 on the tensor cores, in f64."""
    (ah, al), (bh, bl) = _split(a, rule), _split(b, rule)
    return al @ bh + ah @ bl + ah @ bh


def _as(x, dtype):
    """``x`` rounded to ``dtype`` (to nearest even), as f64."""
    return torch.from_numpy(np.asarray(x, np.float64)).to(
        dtype).double().numpy()


def emulated_backward(arrays, causal, dtype, rule="rna"):
    """dq, dk, dv of the kernels on ``arrays`` (q, k, v, dO in ``dtype``,
    held as f64), from the forward's output in ``dtype`` and its f32
    log-sum-exp."""
    q, k, v, g = arrays
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / np.sqrt(d)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    keep = np.ones((sq, sk), bool)
    if causal:
        keep = np.arange(sq)[:, None] >= np.arange(sk)[None]
    s = np.where(keep, s, -1e30)
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    out = np.einsum("bhqk,bkhd->bqhd", np.exp(s - lse[..., None]), v)
    delta = (_as(out, dtype) * g).sum(-1).astype(np.float32)  # [b, sq, h]
    lse2 = np.float32(lse) * _LOG2E
    grads = [np.zeros_like(t) for t in (q, k, v)]
    for i in range(b):
        for j in range(h):
            qh, kh, vh, gh = (t[i, :, j] for t in arrays)
            if dtype == torch.float32:
                st, dpt = _mm3(qh, kh.T, rule), _mm3(gh, vh.T, rule)
            else:
                st, dpt = qh @ kh.T, gh @ vh.T
            x = np.float32(st) * np.float32(scale * _LOG2E) \
                - lse2[i, j][:, None]
            p = np.where(keep, np.exp2(x), np.float32(0))
            ds = p * (np.float32(dpt) - delta[i, :, j][:, None])
            if dtype == torch.float32:
                dq = _mm3(ds, kh, rule) * scale
                dk = _mm3(ds.T, qh, rule) * scale
                dv = _mm3(p.T, gh, rule)
            else:
                pr, dsr = _as(p, dtype), _as(ds, dtype)
                dq, dk, dv = dsr @ kh * scale, dsr.T @ qh * scale, pr.T @ gh
            for t, x in zip(grads, (dq, dk, dv)):
                t[i, :, j] = x
    return [_as(t, dtype) for t in grads]


def emulated_errors(arrays, causal, dtype, rule="rna"):
    """Each cotangent's worst error over its reference's max-abs (a
    cotangent zero by symmetry against the largest of the three), as
    ``chip_smoke.flash_backward_check`` measures the kernels."""
    want = _numpy_grads(arrays, causal)
    got = emulated_backward(arrays, causal, dtype, rule)
    tops = [float(np.abs(w).max()) for w in want]
    return {c: float(np.abs(x - w).max()) / (
        top if top > 1e-6 * max(tops) else max(tops))
        for c, x, w, top in zip(("dq", "dk", "dv"), got, want, tops)}


EMULATED = [(64, 64, 8, False), (64, 64, 8, True), (63, 65, 64, False),
            (63, 65, 64, True), (65, 40, 64, True), (33, 100, 8, True),
            (200, 200, 64, False), (200, 200, 64, True), (512, 512, 64, True)]
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _emulated_inputs(sq, sk, d, dtype):
    return [_as(a, dtype) for a in _arrays(sq + 7 * sk + d, sq, sk, h=2, d=d,
                                           b=1)]


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("sq,sk,d,causal", EMULATED)
def test_emulated_operand_rounding_meets_the_tolerance(dtype, sq, sk, d,
                                                       causal):
    arrays = _emulated_inputs(sq, sk, d, dtype)
    name = str(dtype).replace("torch.", "")
    errs = emulated_errors(arrays, causal, dtype)
    assert max(errs.values()) <= FLASH_BWD_TOL[name], errs
    assert max(errs.values()) > 0  # the rounding is really emulated


if __name__ == "__main__":
    # the emulated worst error of each cotangent over the cases above, by
    # type and, for f32, by the TF32 split rule:
    # PYTHONPATH=. python tests/test_torch_flash_backward.py
    for dtype in _DTYPES:
        for rule in _SPLITS if dtype == torch.float32 else ("rna",):
            worst = {}
            for sq, sk, d, causal in EMULATED:
                errs = emulated_errors(_emulated_inputs(sq, sk, d, dtype),
                                       causal, dtype, rule)
                for c, e in errs.items():
                    worst[c] = max(worst.get(c, 0.0), e)
            print(str(dtype).replace("torch.", ""), rule, worst)
