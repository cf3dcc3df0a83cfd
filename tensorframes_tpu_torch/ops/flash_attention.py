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
- On an abstract tensor (``meta``, or fake during capture's shape probes)
  the output is an empty tensor of the output's shape and dtype: shape
  inference launches nothing.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

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
                              scale: Optional[float] = None) -> torch.Tensor:
    """The plain version, ``_xla_attention`` of the JAX package: scores in
    f32 (f64 for f64 inputs), the top-left causal mask
    ``arange(sq)[:, None] >= arange(sk)[None, :]`` with masked scores
    -1e30, softmax, then ``p @ v``, cast to the input dtype."""
    d = q.shape[-1]
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if causal:
        sq, sk = scores.shape[-2:]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        scores = torch.where(mask, scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(acc)).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.tft_flash_attention
    if fn.argtypes is None:  # declare once: ctypes would pass 32-bit ints
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.tft_flash_attention_error_string.restype = ctypes.c_char_p
        lib.tft_flash_attention_error_string.argtypes = [ctypes.c_int]
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel: ``q`` ``[B, Sq, H, D]``, ``k`` and ``v``
    ``[B, Sk, H, D]``, contiguous CUDA tensors of one dtype (f32, bf16 or
    f16) on one device, ``D <= 128``. Returns ``[B, Sq, H, D]`` in the
    input dtype. Raises on anything else, and on a failed launch.

    Forward only: inputs that require grad raise while autograd is on,
    rather than give an output no gradient reaches."""
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "flash_attention_cuda is forward only; its backward comes with "
            "the training step (ROADMAP A12). Call it under torch.no_grad()")
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # 16-byte rows and pointers: the kernel copies tiles with cp.async
    vec = d * q.element_size() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, out))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tft_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, sq, sk, d, scale, int(bool(causal)), _DTYPE_KIND[q.dtype],
            plan.dmax, plan.smem_bytes, int(vec), stream)
    if rc != 0:
        raise KernelError(
            f"flash_attention kernel launch failed: "
            f"{lib.tft_flash_attention_error_string(rc).decode()} "
            f"(cudaError {rc})")
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Exact attention ``softmax(q kᵀ · scale [+ causal]) v`` in the
    ``[B, S, H, D]`` layout; ``scale`` defaults to ``1/sqrt(D)``.

    The route follows the tensor: a CUDA tensor launches the kernel (or
    raises), a CPU tensor takes the plain version, an abstract one (meta
    or fake) gets its output's shape only. ``impl="cuda"`` insists on the
    kernel and raises where it cannot run; ``None`` is the default route.
    """
    if impl not in (None, "cuda"):
        raise ValueError(f"Unknown flash_attention impl {impl!r}")
    if q.device.type == "meta" or is_fake(q):
        return torch.empty_like(q)
    if impl is None and not q.is_cuda:
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, scale=scale)
