"""Exact softmax attention: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

``flash_attention(q, k, v, causal, scale)`` is the port's counterpart of
``tensorframes_tpu/ops/flash_attention.py``, whose Pallas TPU kernel
``csrc/flash_attention.cu`` replaces (see the note at the top of that file).
Layout ``[B, S, H, D]`` as in the JAX package; Sq != Sk is allowed, and the
causal mask is **top-left** (query ``i`` sees keys ``j <= i``) whatever the
lengths.

- On a CUDA tensor of f32, bf16 or f16 the kernel runs; nothing falls back:
  a dtype or shape it does not take, or a launch that fails, raises.
- On a CPU tensor :func:`flash_attention_reference` runs (the JAX
  package's ``impl="xla"`` path).
- On an abstract tensor (``meta``, or fake during capture's shape probes
  and ``torch.export``) the op's fake kernel gives the output's shape and
  dtype and launches nothing; an exported program records the op, which
  runs the kernel (or the plain version) when the program runs.

Every call goes through the op ``torch.ops.tft.flash_attention`` (a fake
kernel, and an autograd formula registered with ``register_autograd``).
When autograd will need the gradients (grad mode on and an input that
requires grad) of a tensor off the CPU, the forward also writes each row's
log-sum-exp; the backward is :mod:`.flash_attention_backward`: the
hand-written kernels on a CUDA tensor, autograd of the plain version on a
CPU one. Under ``torch.no_grad()`` the kernel writes the output alone.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from ..resilience.classify import KernelError
from . import _build

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_cuda", "plan_launch"]

# Launches of the CUDA kernel since the process started (or the caller last
# set it to 0); flash_attention_cuda adds one per launch. Read it on this
# module (``ops.flash_attention`` is the function): a ``from`` import copies
# the int.
launches = 0

_NEG_INF = -1e30  # large-negative, not -inf: fully-masked rows stay NaN-free
_MAX_HEAD_DIM = 128
_BLOCK_Q = 64     # query rows per block and key rows per tile (the .cu)
_STAGES = 2       # K/V tiles in flight (kStages)
_HEAD_DIMS = (32, 64, 128)  # head dims the kernel is built for, D padded up
_MAX_Q_TILES = 65535  # the grid's y dimension
_DTYPE_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class FlashPlan(NamedTuple):
    dmax: int        # the head dim padded up, zero columns past D
    row_elems: int   # row stride of each shared-memory tile, padded
    smem_bytes: int  # the Q tile and _STAGES K and V tiles


def plan_launch(d: int, dtype: torch.dtype) -> FlashPlan:
    """Shared memory of one block for head dim ``d`` in ``dtype``: rows
    padded by 4 words (f32) or 16 bytes (bf16, f16) so that the tensor
    cores' fragment loads meet no bank conflicts; the kernel checks the
    size it is given against its own."""
    if not 1 <= d <= _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_cuda takes a head dim of 1 to "
                         f"{_MAX_HEAD_DIM}, got {d}")
    dmax = next(m for m in _HEAD_DIMS if d <= m)
    size = torch.empty((), dtype=dtype).element_size()
    row = dmax + (4 if size == 4 else 8)
    return FlashPlan(dmax, row, (1 + 2 * _STAGES) * _BLOCK_Q * row * size)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              scale: Optional[float] = None,
                              return_lse: bool = False):
    """The plain version, ``_xla_attention`` of the JAX package: scores in
    f32 (f64 for f64 inputs), the top-left causal mask
    ``arange(sq)[:, None] >= arange(sk)[None, :]`` with masked scores
    -1e30, softmax, then ``p @ v``, cast to the input dtype. With
    ``return_lse`` also each row's natural log-sum-exp of its scaled (and
    masked) scores, ``[B*H, Sq]`` in the scores' dtype: what the kernel
    writes for the backward (-inf for a row with no key)."""
    b, sq, h, d = q.shape
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(k.shape[1], device=q.device)[None, :])
        scores = torch.where(mask, scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(acc)).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(scores, dim=-1).reshape(b * h, sq)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.tft_flash_attention
    if fn.argtypes is None:  # declare once: ctypes would pass 32-bit ints
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
            [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.tft_flash_attention_error_string.restype = ctypes.c_char_p
        lib.tft_flash_attention_error_string.argtypes = [ctypes.c_int]
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False, scale: Optional[float] = None,
                         return_lse: bool = False):
    """Launch the CUDA kernel: ``q`` ``[B, Sq, H, D]``, ``k`` and ``v``
    ``[B, Sk, H, D]``, contiguous CUDA tensors of one dtype (f32, bf16 or
    f16) on one device, ``D <= 128``. Returns ``[B, Sq, H, D]`` in the
    input dtype, and with ``return_lse`` also each row's log-sum-exp
    ``[B*H, Sq]`` f32 (what the backward reads). Raises on anything else,
    and on a failed launch. No gradient flows through this function: the
    op ``torch.ops.tft.flash_attention`` carries the autograd formula."""
    global launches
    ts = (q, k, v)
    if not all(t.is_cuda for t in ts):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.dtype not in _DTYPE_KIND or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes f32, bf16 or f16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or (q.shape[0], q.shape[2], q.shape[3]) \
            != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"flash_attention_cuda takes q [B, Sq, H, D] and "
                         f"k, v [B, Sk, H, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    plan = plan_launch(d, q.dtype)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention_cuda takes contiguous tensors")
    if math.ceil(sq / _BLOCK_Q) > _MAX_Q_TILES or b * h >= 2 ** 31 \
            or sk >= 2 ** 31:
        raise ValueError(f"flash_attention_cuda: B*H = {b * h}, Sq = {sq}, "
                         f"Sk = {sk} exceed the kernel's grid")
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq) if return_lse else (0,),
                      dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    # 16-byte rows and pointers: the kernel copies tiles with cp.async
    vec = d * q.element_size() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, out))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tft_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, b, h, sq, sk, d, scale,
            int(bool(causal)), _DTYPE_KIND[q.dtype], plan.dmax,
            plan.smem_bytes, int(vec), stream)
    if rc != 0:
        raise KernelError(
            f"flash_attention kernel launch failed: "
            f"{lib.tft_flash_attention_error_string(rc).decode()} "
            f"(cudaError {rc})")
    launches += 1
    return (out, lse) if return_lse else out


@torch.library.custom_op("tft::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float, with_lse: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the kernel for a CUDA tensor, the plain version for
    a CPU one; ``lse`` is ``[B*H, Sq]`` f32 when ``with_lse``, else empty."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal, scale,
                                    return_lse=True) if with_lse else \
            (flash_attention_cuda(q, k, v, causal, scale),
             q.new_empty((0,), dtype=torch.float32))
    if with_lse:
        out, lse = flash_attention_reference(q, k, v, causal, scale,
                                             return_lse=True)
        return out, lse.float()
    return (flash_attention_reference(q, k, v, causal, scale),
            q.new_empty((0,), dtype=torch.float32))


@_flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, scale, with_lse):
    b, sq, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b * h, sq) if with_lse else (0,),
                        dtype=torch.float32))


def _flash_attention_setup(ctx, inputs, output):
    q, k, v, causal, scale, _ = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale = causal, scale


def _flash_attention_grad(ctx, dout, _dlse):
    from .flash_attention_backward import (
        flash_attention_backward_cuda, flash_attention_backward_reference)

    q, k, v, out, lse = ctx.saved_tensors
    if not q.is_cuda:
        dq, dk, dv = flash_attention_backward_reference(
            q, k, v, dout, ctx.causal, ctx.scale)
    elif lse.numel() == 0 and q.numel() > 0:
        raise KernelError("tft::flash_attention ran without its log-sum-exp "
                          "(with_lse=False); its backward needs it")
    else:
        dq, dk, dv = flash_attention_backward_cuda(
            q, k, v, out, lse, dout.contiguous(), ctx.causal, ctx.scale)
    return dq, dk, dv, None, None, None


_flash_attention_op.register_autograd(_flash_attention_grad,
                                      setup_context=_flash_attention_setup)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Exact attention ``softmax(q kᵀ · scale [+ causal]) v`` in the
    ``[B, S, H, D]`` layout; ``scale`` defaults to ``1/sqrt(D)``.

    The route follows the tensor: a CUDA tensor launches the kernel (or
    raises), a CPU tensor takes the plain version, an abstract one (meta
    or fake) gets its output's shape only. ``impl="cuda"`` insists on the
    kernel and raises where it cannot run; ``None`` is the default route.
    The call goes through the op ``tft::flash_attention``, whose backward
    is the backward kernels on a CUDA tensor (see the module's note).
    """
    if impl not in (None, "cuda"):
        raise ValueError(f"Unknown flash_attention impl {impl!r}")
    if scale is None:
        scale = float(1.0 / (q.shape[-1] ** 0.5))
    abstract = q.device.type == "meta" or is_fake(q)
    if impl == "cuda" and not (abstract or q.is_cuda):
        raise ValueError("flash_attention impl='cuda' takes CUDA tensors")
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    # the log-sum-exp only where the backward kernels read it: the plain
    # backward of a CPU tensor builds the scores again
    return torch.ops.tft.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), bool(causal),
        float(scale), grad and q.device.type != "cpu")[0]
