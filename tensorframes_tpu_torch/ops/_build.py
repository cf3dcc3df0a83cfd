"""Build and load the package's CUDA kernels and its host runtime.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``, and each
``csrc/<name>.cpp`` (the host runtime of ``native.py``) by ``g++``, into a
shared library with a plain C interface,
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout, and
loaded with ``ctypes``. The hash covers the source and the flags, so an
edited source builds anew. Building happens at first use, never at import;
:func:`build` compiles several sources at once. One process-wide lock
serializes builds and loads, so threads that reach a kernel's first use
together (the serving scheduler's workers) run one compiler per source and
share one handle; each build writes a temporary file named for its process
and thread, moved into place atomically, so two processes building the
same source (the test runner's workers) cannot tear each other's library.
``-Xptxas -v`` makes ``ptxas`` report each kernel's registers, shared
memory and spills; a build's compiler output is kept in :data:`logs`.
A failed or impossible build raises
:class:`~..resilience.classify.KernelError`, which the resilience layer
treats as permanent: it is not retried and nothing falls back to a plain
version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from ..resilience.classify import KernelError

__all__ = ["build", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_loaded: Dict[str, ctypes.CDLL] = {}
# the compiler's output of each source this process built, by name
logs: Dict[str, str] = {}
_lock = threading.RLock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError(
        "nvcc not found (neither on PATH nor under /usr/local/cuda); the "
        "package's CUDA kernels are built from source at first use")


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise KernelError(
        "g++ not found on PATH; the package's host runtime is built from "
        "source at first use")


def _source(name: str) -> Path:
    """``csrc/<name>.cu`` (a CUDA kernel) or else ``csrc/<name>.cpp``."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _flags(src: Path):
    return NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS


def _library_path(name: str) -> Path:
    src = _source(name)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(_flags(src)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(*names: str) -> Dict[str, ctypes.CDLL]:
    """The libraries ``names``, each built first if need be: one compiler
    per source, all started together. Raises with the compiler's output if
    one fails (after every compiler has ended)."""
    with _lock:
        return _build_locked(names)


def _build_locked(names) -> Dict[str, ctypes.CDLL]:
    jobs = []
    for name in names:
        out = _library_path(name)
        if name in _loaded or out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        src = _source(name)
        tool = _nvcc() if src.suffix == ".cu" else _gxx()
        cmd = [tool, *_flags(src), "-o", str(tmp), str(src)]
        jobs.append((src, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tool = "nvcc" if src.suffix == ".cu" else "g++"
            failed.append(f"{tool} failed to build {src.name} (exit "
                          f"{proc.returncode}):\n{log}")
            if tmp.exists():
                tmp.unlink()
        else:
            logs[src.stem] = log
            os.replace(tmp, out)
    if failed:
        raise KernelError("\n".join(failed))
    for name in names:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_library_path(name)))
    return {name: _loaded[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The library ``name``, built first if need be."""
    lib = _loaded.get(name)
    return lib if lib is not None else build(name)[name]
