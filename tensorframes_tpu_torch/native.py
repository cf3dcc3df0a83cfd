"""ctypes binding to the port's host runtime (``csrc/host_runtime.cpp``).

The port's counterpart of ``tensorframes_tpu/native.py``, with the same
functions and fallbacks: the threaded loops around every host->device
copy. ``convert`` casts a column's dtype on the host, ``gather_rows``
gathers rows by an index (a keyed aggregate's sort by key),
``pack_ragged`` and ``pad_ragged`` turn ragged cells into CSR or
pad-to-dense blocks, and ``empty_aligned`` hands out 64-byte-aligned
staging buffers from a pool.

The library is the package's own: ``ops/_build.py`` compiles
``csrc/host_runtime.cpp`` with ``g++`` at first use into
``build/kernels/`` (content-hashed, like the CUDA kernels), so it is
available wherever ``g++`` is. ``TFT_NATIVE_LIB`` names a prebuilt library
to load instead. Everything degrades gracefully: when the library cannot
be built or loaded, or ``TFT_DISABLE_NATIVE=1`` is set, every function
runs its numpy equivalent, with the same results bit for bit.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .resilience.classify import KernelError
from .utils.logging import get_logger

__all__ = [
    "available", "lib_version", "set_threads", "convert", "gather_rows",
    "pack_ragged", "pad_ragged", "empty_aligned", "pool_bytes", "pool_trim",
]

_DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.uint8): 4,
}

# below this many bytes the ctypes call overhead beats any threading win
_MIN_NATIVE_BYTES = 1 << 16

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_load_lock = threading.Lock()


def _open() -> Optional[ctypes.CDLL]:
    """``TFT_NATIVE_LIB`` when it names a file, else the package's own
    build of ``csrc/host_runtime.cpp``; ``None`` when neither loads."""
    cand = os.environ.get("TFT_NATIVE_LIB")
    try:
        if cand and os.path.exists(cand):
            return ctypes.CDLL(cand)
        from .ops import _build
        return _build.load("host_runtime")
    except (KernelError, OSError) as e:
        get_logger("native").info(
            "host runtime unavailable (%s); numpy fallbacks in use", e)
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    with _load_lock:
        if _load_attempted:
            return _lib
        lib = None if os.environ.get("TFT_DISABLE_NATIVE") else _open()
        if lib is not None:
            c64 = ctypes.c_int64
            vp = ctypes.c_void_p
            lib.tfr_version.restype = ctypes.c_char_p
            lib.tfr_set_threads.argtypes = [ctypes.c_int]
            lib.tfr_get_threads.restype = ctypes.c_int
            lib.tfr_convert.argtypes = [vp, ctypes.c_int, vp, ctypes.c_int,
                                        c64]
            lib.tfr_convert.restype = ctypes.c_int
            lib.tfr_gather_rows.argtypes = [vp, c64, vp, c64, c64, vp]
            lib.tfr_gather_rows.restype = ctypes.c_int
            lib.tfr_pack_ragged.argtypes = [vp, vp, c64, vp, vp]
            lib.tfr_pack_ragged.restype = c64
            lib.tfr_pad_ragged.argtypes = [vp, vp, c64, c64, c64, vp, vp]
            lib.tfr_pad_ragged.restype = ctypes.c_int
            lib.tfr_alloc.argtypes = [c64]
            lib.tfr_alloc.restype = vp
            lib.tfr_free.argtypes = [vp, c64]
            lib.tfr_free.restype = None
            lib.tfr_pool_bytes.restype = c64
            lib.tfr_pool_trim.restype = None
        _lib = lib
        _load_attempted = True
    return _lib


def available() -> bool:
    return _load() is not None


def lib_version() -> Optional[str]:
    lib = _load()
    return lib.tfr_version().decode() if lib else None


def set_threads(n: int) -> None:
    lib = _load()
    if lib:
        lib.tfr_set_threads(int(n))


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def convert(src: np.ndarray, dst_dtype) -> np.ndarray:
    """dtype-convert an array (threaded native kernel for large buffers;
    numpy ``astype`` otherwise). Returns ``src`` unchanged if already right."""
    dst_dtype = np.dtype(dst_dtype)
    if src.dtype == dst_dtype:
        return src
    lib = _load()
    if (lib is None or src.nbytes < _MIN_NATIVE_BYTES
            or src.dtype not in _DTYPE_CODES
            or dst_dtype not in _DTYPE_CODES
            or not src.flags.c_contiguous):
        return src.astype(dst_dtype)
    dst = np.empty(src.shape, dst_dtype)
    rc = lib.tfr_convert(_ptr(src), _DTYPE_CODES[src.dtype], _ptr(dst),
                         _DTYPE_CODES[dst_dtype], src.size)
    if rc != 0:  # pragma: no cover — only on dtype-table drift
        return src.astype(dst_dtype)
    return dst


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``src[idx]`` along axis 0 (threaded native row-gather for large
    blocks; numpy fancy-indexing fallback)."""
    lib = _load()
    idx = np.ascontiguousarray(idx, np.int64)
    if (lib is None or src.nbytes < _MIN_NATIVE_BYTES
            or not src.flags.c_contiguous or src.ndim < 1):
        # match the native kernel's contract exactly: no negative-wrapping
        if idx.size and (idx.min() < 0 or idx.max() >= src.shape[0]):
            raise IndexError("gather_rows: index out of bounds")
        return src[idx]
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                 dtype=np.int64))
    if row_bytes == 0:
        return src[idx]
    dst = np.empty((len(idx),) + src.shape[1:], src.dtype)
    rc = lib.tfr_gather_rows(_ptr(src), src.shape[0], _ptr(idx), len(idx),
                             row_bytes, _ptr(dst))
    if rc != 0:
        raise IndexError("gather_rows: index out of bounds")
    return dst


def _as_cell_list(cells: Sequence[np.ndarray], dtype) -> List[np.ndarray]:
    return [np.ascontiguousarray(c, dtype) for c in cells]


def pack_ragged(cells: Sequence[np.ndarray], dtype=None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate variable-length cells into (values, element_offsets) —
    the CSR layout for ragged columns."""
    if dtype is None:
        dtype = cells[0].dtype if len(cells) else np.float64
    dtype = np.dtype(dtype)
    arrs = _as_cell_list(cells, dtype)
    n = len(arrs)
    lib = _load()
    total_bytes = sum(a.nbytes for a in arrs)
    if lib is None or total_bytes < _MIN_NATIVE_BYTES:
        offsets = np.zeros(n + 1, np.int64)
        for i, a in enumerate(arrs):
            offsets[i + 1] = offsets[i] + a.size
        values = (np.concatenate([a.reshape(-1) for a in arrs])
                  if arrs else np.empty(0, dtype))
        return values.astype(dtype, copy=False), offsets
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs])
    nbytes = np.array([a.nbytes for a in arrs], np.int64)
    values = np.empty(total_bytes // dtype.itemsize, dtype)
    byte_offsets = np.empty(n + 1, np.int64)
    lib.tfr_pack_ragged(ctypes.cast(ptrs, ctypes.c_void_p), _ptr(nbytes), n,
                        _ptr(values), _ptr(byte_offsets))
    return values, byte_offsets // dtype.itemsize


def pad_ragged(cells: Sequence[np.ndarray], max_len: Optional[int] = None,
               dtype=None, with_mask: bool = True
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Pad 1-d variable-length cells to a dense ``[n, max_len]`` block plus
    a validity mask (uint8, 1 = valid)."""
    if dtype is None:
        dtype = cells[0].dtype if len(cells) else np.float64
    dtype = np.dtype(dtype)
    arrs = _as_cell_list(cells, dtype)
    n = len(arrs)
    lens = np.array([a.size for a in arrs], np.int64)
    if max_len is None:
        max_len = int(lens.max()) if n else 0
    lib = _load()
    if lib is None or int(lens.sum()) * dtype.itemsize < _MIN_NATIVE_BYTES:
        dense = np.zeros((n, max_len), dtype)
        mask = np.zeros((n, max_len), np.uint8) if with_mask else None
        for i, a in enumerate(arrs):
            if a.size > max_len:
                raise ValueError(
                    f"pad_ragged: a cell exceeds max_len={max_len}")
            dense[i, :a.size] = a.reshape(-1)
            if mask is not None:
                mask[i, :a.size] = 1
        return dense, mask
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs])
    dense = np.empty((n, max_len), dtype)
    mask = np.empty((n, max_len), np.uint8) if with_mask else None
    rc = lib.tfr_pad_ragged(
        ctypes.cast(ptrs, ctypes.c_void_p), _ptr(lens), n, max_len,
        dtype.itemsize, _ptr(dense),
        _ptr(mask) if mask is not None else None)
    if rc != 0:
        raise ValueError(f"pad_ragged: a cell exceeds max_len={max_len}")
    return dense, mask


def empty_aligned(shape, dtype) -> np.ndarray:
    """64-byte-aligned array from the native buffer pool (falls back to
    ``np.empty``). Reuse of hot staging sizes skips page-faulting fresh
    allocations on every block; the storage returns to the pool when the
    array is garbage-collected."""
    import weakref

    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    lib = _load()
    if lib is None or nbytes < _MIN_NATIVE_BYTES:
        return np.empty(shape, dtype)
    ptr = lib.tfr_alloc(nbytes)
    if not ptr:  # pragma: no cover — OOM
        return np.empty(shape, dtype)
    buf = (ctypes.c_char * nbytes).from_address(ptr)
    base = np.frombuffer(buf, dtype=dtype, count=nbytes // dtype.itemsize)
    weakref.finalize(base, lib.tfr_free, ptr, nbytes)
    return base.reshape(shape)


def pool_bytes() -> int:
    lib = _load()
    return int(lib.tfr_pool_bytes()) if lib else 0


def pool_trim() -> None:
    lib = _load()
    if lib:
        lib.tfr_pool_trim()
