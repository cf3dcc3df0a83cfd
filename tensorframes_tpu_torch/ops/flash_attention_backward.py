"""The backward of exact softmax attention: a hand-written CUDA kernel for
Hopper and its plain PyTorch version.

``flash_attention_backward_cuda(q, k, v, out, lse, dout, causal, scale)``
returns ``(dq, dk, dv)`` for the forward of
:mod:`~tensorframes_tpu_torch.ops.flash_attention`, from that forward's
output and per-row log-sum-exp; ``csrc/flash_attention_backward.cu`` holds
the kernels (see the note at the top of that file): a delta pre-pass, a
dk/dv sweep over key tiles and a dq sweep over query tiles, their five
products on the tensor cores with ``mma.sync`` (3xTF32 for f32), P and dS
kept in registers, tiles streamed through a ``cp.async`` ring. The JAX
package has no backward kernel: it differentiates its plain attention
(``_xla_attention``) with XLA's autodiff, so the plain version here,
:func:`flash_attention_backward_reference`, is autograd of
``flash_attention_reference``.

The training path reaches this module through the autograd formula of the
op ``torch.ops.tft.flash_attention``; nothing falls back: a CUDA tensor the
kernel does not take, or a launch that fails, raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..resilience.classify import KernelError
from . import _build
from .flash_attention import (_DTYPE_KIND, _HEAD_DIMS, _MAX_HEAD_DIM,
                              flash_attention_reference)

__all__ = ["flash_attention_backward_cuda",
           "flash_attention_backward_reference", "plan_backward"]

# Calls of the backward (each launches its three kernels: delta, dk and dv,
# dq) since the process started or the caller last set it to 0. Read it on
# this module: a ``from`` import copies the int.
launches = 0

_TILE = 64     # query rows per query tile and keys per key tile (the .cu)
_STAGES = 2    # streamed tiles in flight (kStages)


class BackwardPlan(NamedTuple):
    dmax: int        # the head dim padded up, zero features past D
    smem_dkdv: int   # dynamic shared memory of the dk/dv kernel, bytes
    smem_dq: int     # of the dq kernel


def plan_backward(d: int, dtype: torch.dtype = torch.float32
                  ) -> BackwardPlan:
    """Shared memory of the two tile kernels for head dim ``d`` in
    ``dtype``: six tiles of 64 rows in the input type, rows padded by 4
    words (f32) or 16 bytes (bf16, f16) so that the tensor cores' fragment
    loads meet no bank conflicts. The dk/dv kernel keeps K and V and streams
    Q and dO through ``_STAGES`` stages, each with its tile's log-sum-exp
    and delta (64 f32 each); the dq kernel keeps Q and dO and streams K and
    V. The kernel checks the sizes it is given against its own."""
    if not 1 <= d <= _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_backward_cuda takes a head dim of "
                         f"1 to {_MAX_HEAD_DIM}, got {d}")
    dmax = next(m for m in _HEAD_DIMS if d <= m)
    size = torch.empty((), dtype=dtype).element_size()
    tiles = (2 + 2 * _STAGES) * _TILE * (dmax + (4 if size == 4 else 8)) \
        * size
    return BackwardPlan(dmax, tiles + 2 * _STAGES * _TILE * 4, tiles)


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        dout: torch.Tensor, causal: bool = False,
        scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: autograd of ``flash_attention_reference`` (the
    JAX package's ``_xla_attention``) at ``(q, k, v)`` with cotangent
    ``dout``. Returns ``(dq, dk, dv)`` in the inputs' dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_reference(*leaves, causal=causal, scale=scale)
        return torch.autograd.grad(out, leaves, dout)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_backward")
    fn = lib.tft_flash_attention_backward
    if fn.argtypes is None:  # declare once: ctypes would pass 32-bit ints
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + \
            [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        err = lib.tft_flash_attention_backward_error_string
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
    return lib


def flash_attention_backward_cuda(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, dout: torch.Tensor, causal: bool = False,
        scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels: ``q``, ``out`` and ``dout`` ``[B, Sq, H,
    D]``, ``k`` and ``v`` ``[B, Sk, H, D]``, contiguous CUDA tensors of one
    dtype (f32, bf16 or f16) on one device, ``D <= 128``; ``lse`` the
    forward's ``[B*H, Sq]`` f32 log-sum-exp. Returns ``(dq, dk, dv)`` in the
    input dtype. Raises on anything else, and on a failed launch."""
    global launches
    ts = (q, k, v, out, dout)
    if not all(t.is_cuda for t in ts + (lse,)):
        raise ValueError("flash_attention_backward_cuda takes CUDA tensors")
    if any(t.device != q.device for t in ts + (lse,)):
        raise ValueError("flash_attention_backward_cuda takes tensors on one "
                         "device")
    if q.dtype not in _DTYPE_KIND or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"flash_attention_backward_cuda takes f32, bf16 or "
                        f"f16 q, k, v, out, dout of one dtype, got "
                        f"{[t.dtype for t in ts]}")
    if q.dim() != 4 or k.shape != v.shape or out.shape != q.shape \
            or dout.shape != q.shape or k.dim() != 4 \
            or (q.shape[0], q.shape[2], q.shape[3]) \
            != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"flash_attention_backward_cuda takes q, out, dout "
                         f"[B, Sq, H, D] and k, v [B, Sk, H, D], got "
                         f"{[tuple(t.shape) for t in ts]}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b * h, sq):
        raise ValueError(f"flash_attention_backward_cuda takes the forward's "
                         f"[B*H, Sq] = [{b * h}, {sq}] f32 lse, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    plan = plan_backward(d, q.dtype)
    if not all(t.is_contiguous() for t in ts + (lse,)):
        raise ValueError("flash_attention_backward_cuda takes contiguous "
                         "tensors")
    if b * h >= 2 ** 31 or sq >= 2 ** 31 or sk >= 2 ** 31:
        raise ValueError(f"flash_attention_backward_cuda: B*H = {b * h}, "
                         f"Sq = {sq}, Sk = {sk} exceed the kernels' grid")
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tft_flash_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d, scale,
            int(bool(causal)), _DTYPE_KIND[q.dtype], plan.dmax,
            plan.smem_dkdv, plan.smem_dq, stream)
    if rc != 0:
        raise KernelError(
            f"flash_attention backward kernel launch failed: "
            f"{lib.tft_flash_attention_backward_error_string(rc).decode()} "
            f"(cudaError {rc})")
    launches += 1
    return dq, dk, dv
