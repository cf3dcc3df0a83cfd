"""Spillable device buffers: pinned-host round trips, bit-identical.

The port's counterpart of ``tensorframes_tpu/memory/spill.py``: wrappers
that move device tensors to **pinned host buffers** and restore them on
next touch to the device and dtype they came from. A "device value" is
any ``torch.Tensor`` (on the CPU, where the tests run, the round trip is
tensor -> numpy -> tensor); host numpy, lists and scalars are already
host bytes and never spill.

A spill of a CUDA tensor copies it into a ``pin_memory=True`` host tensor
(a synchronous copy: the host may drop the device tensor right after) and
keeps a numpy view of it. A fault-back copies the host bytes to the
recorded device and dtype. The round trip is bit-identical for every
dtype. ``bfloat16`` has no numpy dtype: its host copy holds the raw bits
as ``uint16`` (the tensor's ``int16`` view, re-viewed), and the recorded
dtype puts them back as ``bfloat16`` on the way to the device; nothing
widens through float32. Host ride-along columns (strings) pass through
untouched: they were never device bytes.

A spilled value is the triple ``(host numpy, device, dtype)``
(:func:`spill_value` / :func:`restore_value`), the parked form the
checkpoint reuses; the persist tier writes it with no device and the
dtype's name, so a file holds numpy and strings only.

A mesh frame's column (``parallel.distributed.ShardedArray``, a tensor
per data shard) spills shard by shard: each shard to its own pinned host
buffer (``_HostShards``, the triple's host part), and faults back shard
by shard onto the device it came from, so a spilled frame keeps its
layout. Its host values read as the shards' rows concatenated.

Two stock spillables implement the ledger's duck-typed entry protocol
(:class:`~.manager.MemoryManager`):

- :class:`SpillableBuffer`: a named set of tensors;
- :class:`SpillableColumns`: a ``dict`` drop-in whose device values spill
  as a unit and fault back **transparently on any access**
  (``__getitem__`` / ``get`` / ``values`` / ``items``), so its readers (a
  join's build table) need no spill awareness.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .estimate import array_nbytes

__all__ = ["array_nbytes", "is_device_value", "to_pinned_host",
           "SpillableBuffer", "SpillableColumns", "host_value",
           "value_nbytes", "spill_value", "restore_value"]

# (host numpy, device the tensor lay on, its dtype)
Spilled = Tuple[np.ndarray, Optional[torch.device], torch.dtype]


def _is_sharded(a: Any) -> bool:
    """A mesh column (``ShardedArray``): a tensor per data shard."""
    shards = getattr(a, "shards", None)
    return isinstance(shards, list) and all(
        isinstance(t, torch.Tensor) for t in shards)


def is_device_value(a: Any) -> bool:
    """True for ``torch.Tensor`` values and mesh columns (a tensor per
    data shard); host numpy / lists / scalars are already host bytes and
    never spill."""
    return isinstance(a, torch.Tensor) or _is_sharded(a)


class _HostShards:
    """A spilled mesh column's host side: one pinned host array per shard
    and the device each shard came from (``nbytes`` and ``shape`` read as
    the concatenated array's, without concatenating)."""

    __slots__ = ("parts", "devices")

    def __init__(self, parts, devices):
        self.parts = parts
        self.devices = devices

    @property
    def nbytes(self) -> int:
        return sum(int(p.nbytes) for p in self.parts)

    @property
    def shape(self) -> tuple:
        return ((sum(int(p.shape[0]) for p in self.parts),)
                + tuple(self.parts[0].shape[1:]))


def to_pinned_host(t: torch.Tensor) -> np.ndarray:
    """Copy ``t`` into host memory (pinned when it lies on a CUDA card) and
    return it as numpy, bit for bit: ``bfloat16`` comes back as its
    ``uint16`` bits. The copy has completed when this returns."""
    t = t.detach()
    bf16 = t.dtype == torch.bfloat16
    if bf16:
        t = t.view(torch.int16)
    if t.device.type == "cuda":
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)  # synchronous: the host may drop ``t`` at once
    else:
        h = t.clone()
    out = h.numpy()
    return out.view(np.uint16) if bf16 else out


def spill_value(t) -> Spilled:
    """One tensor's spilled form: its host bytes, device and dtype (a mesh
    column's: each shard's host bytes and device, and the dtype)."""
    if _is_sharded(t):
        return (_HostShards([to_pinned_host(p) for p in t.shards],
                            [p.device for p in t.shards]),
                None, t.shards[0].dtype)
    return (to_pinned_host(t), t.device, t.dtype)


def restore_value(spilled: Spilled, device=None) -> torch.Tensor:
    """A spilled value back as a tensor of its dtype on its recorded
    device (or on ``device``, or the package default when neither is
    known: a checkpoint loaded from disk records none)."""
    host, dev, dtype = spilled
    if isinstance(host, _HostShards):
        # a mesh column: every shard back onto the device it came from
        from ..parallel.distributed import ShardedArray
        return ShardedArray([restore_value((p, d, dtype))
                             for p, d in zip(host.parts, host.devices)])
    if isinstance(dtype, str):  # a persisted record names its dtype
        dtype = getattr(torch, dtype)
    if dev is None:
        from ..device import default_device
        dev = device if device is not None else default_device()
    if dtype == torch.bfloat16:
        t = torch.from_numpy(np.ascontiguousarray(host).view(np.int16))
        return t.to(dev).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(host)).to(dev)


def _host_values(spilled: Spilled) -> np.ndarray:
    """A spilled value's values as host numpy (``bfloat16`` decoded to
    float32, the port's host dtype for it)."""
    host, _, dtype = spilled
    if isinstance(host, _HostShards):
        return np.concatenate([_host_values((p, None, dtype))
                               for p in host.parts])
    if dtype in (torch.bfloat16, "bfloat16"):
        return torch.from_numpy(np.ascontiguousarray(host).view(np.int16)) \
            .view(torch.bfloat16).float().numpy()
    return host


def _tensor_host(t) -> np.ndarray:
    if _is_sharded(t):
        return np.concatenate([_tensor_host(p) for p in t.shards])
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def host_value(columns: Mapping[str, Any], name: str) -> np.ndarray:
    """A column's value as host numpy WITHOUT faulting a spilled mapping
    back to the device."""
    if isinstance(columns, SpillableColumns):
        return columns.host_value(name)
    v = columns[name]
    return _tensor_host(v) if is_device_value(v) else v


def value_nbytes(columns: Mapping[str, Any], name: str) -> int:
    """A column's byte size, spilled or resident, without faulting."""
    if isinstance(columns, SpillableColumns):
        return columns.value_nbytes(name)
    return array_nbytes(columns[name])


def _spill_all(values: Dict[str, Any], setter) -> Tuple[Dict[str, Spilled],
                                                        int]:
    host: Dict[str, Spilled] = {}
    freed = 0
    for n, v in list(values.items()):
        if is_device_value(v):
            host[n] = spill_value(v)
            freed += array_nbytes(v)
            setter(n, None)  # drop the device reference
    return host, freed


def _fault_all(host: Dict[str, Spilled], setter) -> int:
    restored = 0
    for n, s in host.items():
        a = restore_value(s)
        setter(n, a)
        restored += array_nbytes(a)
    return restored


class SpillableBuffer:
    """A named set of tensors that round-trips to pinned host buffers.
    Standalone use (no ledger)::

        buf = SpillableBuffer("sorted-run-3", {"x": dev_x, "k": dev_k})
        buf.spill()            # device -> pinned host, bit-identical
        a = buf.get("x")       # faults the whole buffer back

    Registered with a :class:`~.manager.MemoryManager` it becomes an LRU
    spill candidate; host values (numpy/object arrays) ride along
    uncounted and unconverted.
    """

    __slots__ = ("_name", "_values", "_host", "__weakref__")

    def __init__(self, name: str, arrays: Mapping[str, Any]):
        self._name = name
        self._values: Dict[str, Any] = dict(arrays)
        self._host: Optional[Dict[str, Spilled]] = None

    # -- ledger entry protocol --------------------------------------------
    def mem_name(self) -> str:
        return self._name

    def mem_is_spilled(self) -> bool:
        return self._host is not None

    def mem_device_bytes(self) -> int:
        if self._host is not None:
            return 0
        return sum(array_nbytes(v) for v in self._values.values()
                   if is_device_value(v))

    def mem_host_bytes(self) -> int:
        if self._host is None:
            return 0
        return sum(int(s[0].nbytes) for s in self._host.values())

    def mem_spill(self) -> int:
        if self._host is not None:
            return 0
        self._host, freed = _spill_all(self._values,
                                       self._values.__setitem__)
        return freed

    def mem_fault(self) -> int:
        if self._host is None:
            return 0
        restored = _fault_all(self._host, self._values.__setitem__)
        self._host = None
        return restored

    # -- convenience -------------------------------------------------------
    spill = mem_spill
    fault = mem_fault

    @property
    def spilled(self) -> bool:
        return self.mem_is_spilled()

    def get(self, name: str) -> Any:
        if self._host is not None:
            self.mem_fault()
        return self._values[name]

    def arrays(self) -> Dict[str, Any]:
        if self._host is not None:
            self.mem_fault()
        return dict(self._values)

    def __repr__(self):
        state = "spilled" if self.mem_is_spilled() else "resident"
        return f"SpillableBuffer({self._name!r}, {state})"


class SpillableColumns(dict):
    """A column mapping whose device values can spill to pinned host
    buffers as a unit and fault back transparently on the next access.

    Every read path (``[]`` / ``get`` / ``values`` / ``items``) touches
    the owning :class:`~.manager.MemoryManager` first, refreshing LRU
    recency and faulting the columns back when spilled. Host ride-along
    columns are plain values: never counted, never converted. While
    spilled, the device slots hold ``None``; only the overridden accessors
    are public API.
    """

    def __init__(self, name: str, cols: Mapping[str, Any], manager):
        super().__init__(cols)
        self._name = name
        self._mgr = manager
        self._host: Optional[Dict[str, Spilled]] = None

    def _set(self, key, value) -> None:
        dict.__setitem__(self, key, value)

    # -- ledger entry protocol --------------------------------------------
    def mem_name(self) -> str:
        return self._name

    def mem_is_spilled(self) -> bool:
        return self._host is not None

    def mem_device_bytes(self) -> int:
        if self._host is not None:
            return 0
        return sum(array_nbytes(v) for v in dict.values(self)
                   if is_device_value(v))

    def mem_host_bytes(self) -> int:
        if self._host is None:
            return 0
        return sum(int(s[0].nbytes) for s in self._host.values())

    def mem_spill(self) -> int:
        if self._host is not None:
            return 0
        self._host, freed = _spill_all(dict(dict.items(self)), self._set)
        return freed

    def mem_fault(self) -> int:
        if self._host is None:
            return 0
        restored = _fault_all(self._host, self._set)
        self._host = None
        return restored

    # -- transparent access ------------------------------------------------
    def _touch(self) -> None:
        m = self._mgr
        if m is not None:
            m.touch(self)  # faults back under the ledger lock if spilled
        elif self._host is not None:
            self.mem_fault()

    def __getitem__(self, key):
        self._touch()
        return dict.__getitem__(self, key)

    def get(self, key, default=None):
        self._touch()
        return dict.get(self, key, default)

    def values(self):
        self._touch()
        return dict.values(self)

    def items(self):
        self._touch()
        return dict.items(self)

    # -- spill-free reads (estimates, shape metadata) ----------------------
    def leading_rows(self) -> int:
        """Leading row count of the first column WITHOUT faulting a
        spilled mapping back to the device."""
        if self._host:
            for n in dict.keys(self):
                entry = self._host.get(n)
                if entry is not None:
                    return int(entry[0].shape[0])
        for v in dict.values(self):
            if v is not None and hasattr(v, "shape"):
                return int(v.shape[0])
        raise ValueError("no shaped columns to read a row count from")

    def host_value(self, name: str) -> np.ndarray:
        if self._host is not None and name in self._host:
            return _host_values(self._host[name])
        v = dict.__getitem__(self, name)
        return _tensor_host(v) if is_device_value(v) else v

    def value_nbytes(self, name: str) -> int:
        if self._host is not None and name in self._host:
            return int(self._host[name][0].nbytes)
        return array_nbytes(dict.__getitem__(self, name))

    def __repr__(self):
        state = "spilled" if self.mem_is_spilled() else "resident"
        return (f"SpillableColumns({self._name!r}, "
                f"{list(dict.keys(self))}, {state})")
