"""Block executor: run a computation on one block's columns on the device.

The port's counterpart of ``tensorframes_tpu/engine/executor.py``. One call
copies the block's input columns host->device, casts each to its device
dtype on the device (``bfloat16`` columns are f32 on the host), calls the
computation eagerly, copies the outputs device->host and casts them back to
their columns' storage dtypes.

The JAX package pads the row dim to power-of-two buckets only to bound XLA
recompiles of a program per block size. Eager PyTorch compiles nothing per
shape, so :func:`default_padding_executor` returns the plain executor, and
``run`` / ``submit`` take no ``pad_ok``.

``keep_device=True`` returns the outputs as device tensors (the logical
plan chains its stages on them), and a ``torch.Tensor`` passed as an input
is used where it lies: no copy to the host and no second H2D copy.

Not in this package yet: the compile-cache interner, retries, the
memory-manager admission and the OOM split of the JAX package.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from .. import dtypes as _dt
from ..computation import Computation
from ..device import resolve_device
from ..utils.tracing import span

__all__ = ["BlockExecutor", "PendingBlock", "default_executor",
           "default_padding_executor", "to_storage_dtype", "to_device",
           "to_host"]


def to_storage_dtype(a: np.ndarray, dtype: _dt.DType) -> np.ndarray:
    """Cast one host output array to its column storage dtype."""
    storage = dtype.np_storage
    if a.dtype != storage:
        return a.astype(storage)
    return a


def to_device(a, dtype: torch.dtype, device: torch.device,
              pin: bool = False) -> torch.Tensor:
    """One host column as a tensor of ``dtype`` on ``device``. The dtype
    cast runs on the device, after the copy. ``pin`` stages the copy
    through pinned host memory so that it is asynchronous. A tensor
    already on ``device`` is only cast."""
    if isinstance(a, torch.Tensor):
        t = a if a.device == device else a.to(device)
        return t if t.dtype == dtype else t.to(dtype)
    a = np.asarray(a)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.ascontiguousarray(a) if a.flags.writeable else a.copy()
    t = torch.from_numpy(a)
    if device.type == "cuda" and pin:
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return t if t.dtype == dtype else t.to(dtype)


def _host_view(t: torch.Tensor) -> torch.Tensor:
    """A device output in a dtype numpy can hold (bf16 -> f32)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (synchronous)."""
    return _host_view(t).cpu().numpy()


def _check_outputs(comp: Computation, out: Mapping) -> None:
    for spec in comp.outputs:
        v = out.get(spec.name)
        if not isinstance(v, torch.Tensor):
            raise TypeError(
                f"Computation output {spec.name!r} is "
                f"{type(v).__name__}, not a torch.Tensor")


class PendingBlock:
    """One in-flight block: launched on the device, its outputs copying
    to pinned host buffers behind a CUDA event. ``drain()`` waits on the
    event and returns host arrays in storage dtypes. The device inputs and
    outputs are held until then. (Pinned staging buffers come from
    PyTorch's caching host allocator, which does not hand a buffer out
    again before the copies queued on it have run.)"""

    __slots__ = ("_comp", "_inputs", "_host", "_event", "_device_out")

    def __init__(self, comp: Computation, inputs, host: Dict[str, torch.Tensor],
                 event: Optional[torch.cuda.Event],
                 device_out: Optional[Dict[str, torch.Tensor]] = None):
        self._comp = comp
        self._inputs = inputs
        self._host = host
        self._event = event
        self._device_out = device_out

    def drain(self) -> Dict[str, Union[np.ndarray, torch.Tensor]]:
        """Host arrays in storage dtypes, or, for a ``keep_device``
        submit, the device outputs (no wait: the stream orders later
        work on them)."""
        if self._device_out is not None:
            out, self._device_out, self._inputs = self._device_out, None, None
            return out
        if self._event is not None:
            self._event.synchronize()
        result = {}
        for spec in self._comp.outputs:
            result[spec.name] = to_storage_dtype(
                self._host[spec.name].numpy(), spec.dtype)
        self._inputs = None
        return result


class BlockExecutor:
    """Executes :class:`Computation`\\ s on columnar blocks on one device.

    ``device``: ``"cuda"``, ``"cuda:N"`` or ``"cpu"``; ``None`` follows the
    package default (:func:`~tensorframes_tpu_torch.set_default_device`),
    which is ``cuda``. Without a GPU a CUDA device raises at the first
    dispatch.
    """

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        self.device = device

    def resolve(self) -> torch.device:
        return resolve_device(self.device)

    def _inputs(self, comp: Computation, arrays: Mapping, device,
                pin: bool) -> Dict[str, torch.Tensor]:
        # the convert span times host->device work; inputs that are all
        # device tensors already (a later plan stage) open none
        resident = all(isinstance(arrays[s.name], torch.Tensor)
                       for s in comp.inputs)
        with contextlib.nullcontext() if resident \
                else span("executor.convert"):
            return {s.name: to_device(arrays[s.name],
                                      _dt.device_dtype(s.dtype), device,
                                      pin=pin)
                    for s in comp.inputs}

    def _call(self, comp: Computation, dev: Mapping) -> Dict[str, torch.Tensor]:
        with span("executor.dispatch"), torch.no_grad():
            out = comp.fn(dev)
        _check_outputs(comp, out)
        return out

    def run(self, comp: Computation, arrays: Mapping[str, np.ndarray],
            keep_device: bool = False
            ) -> Dict[str, Union[np.ndarray, torch.Tensor]]:
        """Run a computation on host arrays (or device tensors); returns
        host arrays in the outputs' storage dtypes, or with
        ``keep_device`` the device outputs."""
        device = self.resolve()
        out = self._call(comp, self._inputs(comp, arrays, device, pin=False))
        if keep_device:
            return {s.name: out[s.name] for s in comp.outputs}
        with span("executor.convert_back"):
            return {s.name: to_storage_dtype(to_host(out[s.name]), s.dtype)
                    for s in comp.outputs}

    def submit(self, comp: Computation, arrays: Mapping[str, np.ndarray],
               keep_device: bool = False
               ) -> PendingBlock:
        """Asynchronous half of :meth:`run`: pinned non-blocking H2D
        copies, the launch, and non-blocking D2H copies into pinned
        buffers, with no host wait. With ``keep_device`` the outputs stay
        on the device and ``drain()`` returns them. On the CPU it runs
        synchronously."""
        device = self.resolve()
        cuda = device.type == "cuda"
        dev = self._inputs(comp, arrays, device, pin=cuda)
        out = self._call(comp, dev)
        if keep_device:
            return PendingBlock(comp, dev, {}, None,
                                device_out={s.name: out[s.name]
                                            for s in comp.outputs})
        host = {}
        for spec in comp.outputs:
            t = _host_view(out[spec.name])
            if cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
            else:
                h = t
            host[spec.name] = h
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        return PendingBlock(comp, (dev, out), host, event)


_default: Optional[BlockExecutor] = None
_default_lock = threading.Lock()


def default_executor() -> BlockExecutor:
    """The process-default executor, on the package default device."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = BlockExecutor()
    return _default


def default_padding_executor() -> BlockExecutor:
    """The executor ``map_rows`` uses. The JAX package pads rows to
    power-of-two buckets here to bound XLA recompiles; eager PyTorch needs
    no buckets, so this is the plain default executor."""
    return default_executor()
