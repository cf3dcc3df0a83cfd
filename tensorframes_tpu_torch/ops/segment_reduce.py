"""Keyed segment sum: a hand-written CUDA kernel for Hopper and its plain
PyTorch version.

``segment_sum(values, segment_ids, num_segments)`` is the device-side core
of keyed aggregation; the port's counterpart of
``tensorframes_tpu/ops/segment_reduce.py``, whose Pallas TPU kernel
``csrc/segment_sum.cu`` replaces (see the note at the top of that file).

- On a CUDA tensor, float values (f32, bf16, f64) go through the kernel;
  nothing falls back: a launch that fails raises.
- On a CPU tensor, and for integer values everywhere (the exact path, as
  in the JAX package), :func:`segment_sum_reference` runs: a masked
  ``index_add_`` in the accumulation dtype.

The launch (the sort's tile and digits, the reduction's pieces and
levels, every grid and the scratch's layout) is planned in Python by
:func:`plan_sort`, so the CPU tests reach it; the kernel takes the plan
as it is and checks only its own limits.

Float values reach either version through one ``torch.library`` op,
``torch.ops.tft.segment_sum``: its implementation launches the kernel for
a CUDA tensor and runs the plain version for a CPU one, and its fake
kernel gives ``[num_segments, ...]`` in the values' dtype without running
anything. So capture's fake probes of a program that calls B1 over
closed-over CUDA tensors get its shape, and ``torch.export`` records the
op itself (a shipped program launches the kernel wherever it is placed on
the card). The op has no batching rule: ``torch.func.vmap`` over a
program that calls it raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..resilience.classify import KernelError
from . import _build

__all__ = ["segment_sum", "segment_sum_reference", "segment_sum_cuda",
           "plan_sort"]

# Launches of the CUDA kernel since the process started (or the caller
# last set it to 0); segment_sum_cuda adds one per launch. Read it as
# ``segment_reduce.launches``: a ``from`` import copies the int.
launches = 0

_THREADS = 256            # threads per block of every kernel (kThreads)
_SORT_TILE = 4096         # rows per sort block (at most kMaxTile)
_MAX_DIGIT_BITS = 9       # at most 512 digits a pass (kMaxDigitBits)
_NARROW_LANES = 8         # lanes per segment and per piece for d < 32
_PIECE_NARROW = 1024      # rows per piece for d < 32: 8 lanes stride rows
_PIECE_WIDE = 64          # rows per piece for d >= 32: lanes take columns
_MAX_LEVELS = 8           # levels of piece partials (kMaxLevels)
_MAX_ROWS = 2 ** 31 - 1   # row indices and positions are 32-bit
_ALIGN = 256              # byte alignment of each scratch buffer

_VALUE_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_ID_KIND = {torch.int32: 0, torch.int64: 1}


class SortPlan(NamedTuple):
    """One launch of the kernel: every grid, the sort's digits, the
    reduction's pieces and levels, and the scratch's layout. The C entry
    point takes it field for field (``_Launch``)."""
    tile: int            # rows per sort block
    sort_blocks: int     # blocks of each sort kernel
    digit_bits: int
    passes: int
    offset_blocks: int   # blocks of the offsets kernel, a thread per key
    lanes: int           # lanes per segment and per piece: 32 or 8
    piece_rows: int      # rows per piece, at every level of the tree
    segment_blocks: int  # blocks of the reduction, a group per segment
    head_rows: Tuple[int, ...]    # partial rows of each level, one per piece
    head_blocks: Tuple[int, ...]  # blocks of each level, a group per piece
    # byte offset and size of each scratch buffer: keys, idx, hist,
    # totals, offsets, then head0, head1, ...
    layout: Dict[str, Tuple[int, int]]
    scratch_bytes: int


class _Launch(ctypes.Structure):
    """``struct Plan`` of ``csrc/segment_sum.cu``."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "tile", "sort_blocks", "digit_bits", "passes", "offset_blocks",
        "lanes", "piece", "segment_blocks", "levels")] + [
        ("head_blocks", ctypes.c_int * _MAX_LEVELS),
        ("head_rows", ctypes.c_longlong * _MAX_LEVELS),
        ("at", ctypes.c_longlong * (5 + _MAX_LEVELS))]


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype == torch.float64:
        return torch.float64
    if dtype.is_floating_point:
        return torch.float32
    return torch.int64


def plan_sort(n: int, d: int, num_segments: int, acc_size: int) -> SortPlan:
    """The launch for ``n`` rows of width ``d`` into ``num_segments``
    segments, ``acc_size`` bytes per accumulator.

    Keys run over ``[0, num_segments]`` (the sentinel included) and sort in
    ``ceil(bits / 9)`` passes of equal digits, one sort block per
    ``_SORT_TILE`` rows. A warp (d >= 32) or 8 lanes (d < 32) take each
    segment and each piece; pieces of ``piece_rows`` rows make level 0 of
    the tree, and each level's partial rows, one per piece, are cut into
    pieces again while a level holds more than one piece. Scratch is O(n)
    plus the offsets: keys and row indices double-buffered (16 bytes a
    row), the digit histograms and totals, ``S + 1`` offsets and the
    partial rows of every level (about ``n / piece_rows`` rows)."""
    if n < 1 or d < 1 or num_segments < 1:
        raise ValueError(f"plan_sort needs n, d, num_segments >= 1, got "
                         f"{n}, {d}, {num_segments}")
    if n > _MAX_ROWS or num_segments > _MAX_ROWS:
        raise ValueError(f"segment_sum: {n} rows into {num_segments} "
                         f"segments exceed the kernel's 32-bit indices")
    passes = math.ceil(num_segments.bit_length() / _MAX_DIGIT_BITS)
    digit_bits = math.ceil(num_segments.bit_length() / passes)
    sort_blocks = math.ceil(n / _SORT_TILE)
    lanes = 32 if d >= 32 else _NARROW_LANES
    piece = _PIECE_WIDE if d >= 32 else _PIECE_NARROW
    groups = _THREADS // lanes  # segments or pieces per block
    head_rows, rows = [], n
    while rows > piece:
        rows = math.ceil(rows / piece)
        head_rows.append(rows)
    sizes = {"keys": 2 * n * 4, "idx": 2 * n * 4,
             "hist": (1 << digit_bits) * sort_blocks * 4,
             "totals": (1 << digit_bits) * 4,
             "offsets": (num_segments + 1) * 4}
    sizes.update({f"head{k}": r * d * acc_size
                  for k, r in enumerate(head_rows)})
    layout, at = {}, 0
    for name, size in sizes.items():
        layout[name] = (at, size)
        at += -(-size // _ALIGN) * _ALIGN
    return SortPlan(
        _SORT_TILE, sort_blocks, digit_bits, passes,
        math.ceil((num_segments + 1) / _THREADS), lanes, piece,
        math.ceil(num_segments / groups), tuple(head_rows),
        tuple(math.ceil(r / groups) for r in head_rows), layout, at)


def _launch(plan: SortPlan) -> _Launch:
    levels = len(plan.head_rows)  # at most 5: n < 2^31, pieces >= 64
    names = ["keys", "idx", "hist", "totals", "offsets"] + [
        f"head{k}" for k in range(levels)]
    return _Launch(
        plan.tile, plan.sort_blocks, plan.digit_bits, plan.passes,
        plan.offset_blocks, plan.lanes, plan.piece_rows,
        plan.segment_blocks, levels,
        (ctypes.c_int * _MAX_LEVELS)(*plan.head_blocks),
        (ctypes.c_longlong * _MAX_LEVELS)(*plan.head_rows),
        (ctypes.c_longlong * (5 + _MAX_LEVELS))(
            *(plan.layout[k][0] for k in names)))


@functools.lru_cache(maxsize=64)
def _planned(n: int, d: int, num_segments: int,
             acc_size: int) -> Tuple[SortPlan, _Launch]:
    """:func:`plan_sort` and its C struct, made once per shape: the engine
    launches the kernel at one shape for every block of a frame, and the
    plan's host time (about 20 us) would otherwise come before every
    launch."""
    plan = plan_sort(n, d, num_segments, acc_size)
    return plan, _launch(plan)


def segment_sum_reference(values: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """The plain version: rows with ids outside ``[0, num_segments)``
    masked to zero, ``index_add_`` in the accumulation dtype (f64 for f64,
    f32 for f32/bf16, int64 for integers), cast back to the values dtype."""
    acc = _acc_dtype(values.dtype)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]), dtype=acc,
                      device=values.device)
    if num_segments == 0 or values.shape[0] == 0:
        return out.to(values.dtype)
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    v = torch.where(valid.reshape((-1,) + (1,) * (values.dim() - 1)),
                    values, torch.zeros((), dtype=values.dtype,
                                        device=values.device)).to(acc)
    idx = torch.where(valid, segment_ids, torch.zeros_like(segment_ids))
    out.index_add_(0, idx.long(), v)
    return out.to(values.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_sum")
    fn = lib.tft_segment_sum
    if fn.argtypes is None:  # declare once: ctypes would pass 32-bit ints
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(_Launch)] + \
            [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.tft_cuda_error_string.restype = ctypes.c_char_p
        lib.tft_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def segment_sum_cuda(values: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Launch the CUDA kernel: ``values`` a contiguous CUDA ``[N, d]``
    tensor of f32, bf16 or f64, ``segment_ids`` a contiguous CUDA ``[N]``
    tensor of int32 or int64 on the same device. Returns ``[S, d]`` in the
    values dtype. Raises on anything else, and on a failed launch."""
    global launches
    if not (values.is_cuda and segment_ids.is_cuda):
        raise ValueError("segment_sum_cuda takes CUDA tensors")
    if values.device != segment_ids.device:
        raise ValueError(f"values on {values.device}, ids on "
                         f"{segment_ids.device}")
    if values.dtype not in _VALUE_KIND:
        raise TypeError(f"segment_sum_cuda takes f32, bf16 or f64 values, "
                        f"got {values.dtype}")
    if segment_ids.dtype not in _ID_KIND:
        raise TypeError(f"segment_sum_cuda takes int32 or int64 ids, got "
                        f"{segment_ids.dtype}")
    if values.dim() != 2 or segment_ids.dim() != 1 \
            or values.shape[0] != segment_ids.shape[0]:
        raise ValueError(f"segment_sum_cuda takes values [N, d] and ids [N], "
                         f"got {tuple(values.shape)} and "
                         f"{tuple(segment_ids.shape)}")
    if not (values.is_contiguous() and segment_ids.is_contiguous()):
        raise ValueError("segment_sum_cuda takes contiguous tensors")
    n, d = values.shape
    if n == 0 or num_segments == 0 or d == 0:
        return torch.zeros((num_segments, d), dtype=values.dtype,
                           device=values.device)
    acc = _acc_dtype(values.dtype)
    plan, launch = _planned(n, d, num_segments, torch.finfo(acc).bits // 8)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=values.device)
    out = torch.empty((num_segments, d), dtype=values.dtype,
                      device=values.device)
    lib = _lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.tft_segment_sum(
            values.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), ctypes.byref(launch), n, d, num_segments,
            _VALUE_KIND[values.dtype], _ID_KIND[segment_ids.dtype], stream)
    if rc != 0:
        raise KernelError(
            f"segment_sum kernel launch failed: "
            f"{lib.tft_cuda_error_string(rc).decode()} (cudaError {rc})")
    launches += 1
    return out


@torch.library.custom_op("tft::segment_sum", mutates_args=())
def _segment_sum_op(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Float ``values`` [N, ...] into ``[num_segments, ...]``: the kernel
    for a CUDA tensor, the plain version for a CPU one."""
    if not values.is_cuda:
        return segment_sum_reference(values, segment_ids, num_segments)
    tail = tuple(values.shape[1:])
    flat = values.reshape(values.shape[0], math.prod(tail)).contiguous()
    out = segment_sum_cuda(flat, segment_ids.contiguous(), num_segments)
    return out.reshape((num_segments,) + tail)


@_segment_sum_op.register_fake
def _segment_sum_fake(values, segment_ids, num_segments):
    return values.new_empty((num_segments,) + tuple(values.shape[1:]))


def _segment_sum_no_vmap(info, in_dims, values, segment_ids, num_segments):
    raise NotImplementedError(
        "tft::segment_sum has no batching rule: call it on the whole "
        "block (map_blocks), not under torch.func.vmap")


_segment_sum_op.register_vmap(_segment_sum_no_vmap)


def segment_sum(values, segment_ids, num_segments: int,
                impl: Optional[str] = None) -> torch.Tensor:
    """Sum ``values`` rows into ``num_segments`` buckets by ``segment_ids``.

    ``values``: [N, ...] (trailing dims flattened for the kernel and
    restored); ``segment_ids``: [N] ints — rows with ids outside
    ``[0, num_segments)`` are dropped. Returns [num_segments, ...] in the
    values dtype.

    The route follows the tensor: float values on a CUDA tensor launch the
    kernel (or raise); a CPU tensor, and integer values anywhere, take the
    exact plain version. ``impl="cuda"`` insists on the kernel and raises
    where it cannot run; ``None`` is the default route.
    """
    if impl not in (None, "cuda"):
        raise ValueError(f"Unknown segment_sum impl {impl!r}")
    values = torch.as_tensor(values)
    segment_ids = torch.as_tensor(segment_ids, device=values.device)
    if not values.is_floating_point():
        if impl == "cuda":
            raise ValueError(
                "segment_sum impl='cuda' takes float values; integer "
                "values take the exact plain path")
        return segment_sum_reference(values, segment_ids, num_segments)
    if impl == "cuda" and not (values.is_cuda and segment_ids.is_cuda):
        raise ValueError("segment_sum impl='cuda' takes CUDA tensors")
    return torch.ops.tft.segment_sum(values, segment_ids, num_segments)
