"""Device meshes for the single-controller parallel layer.

The port's counterpart of ``tensorframes_tpu/parallel/mesh.py``. As in the
JAX package, one process drives every device of a mesh: a
:class:`DeviceMesh` is an array of ``torch.device`` objects with named
axes, and the default 1-axis ``data`` mesh is pure data parallelism (a
shard of every column on each device of the data axis). Multi-process
meshes (``torch.distributed`` with NCCL, the counterpart of the JAX
package's ``cluster.initialize``) come from ``cluster.cluster_mesh``: a
cluster mesh names every process's slots, each with the process that owns
it (``processes``), and carries the process group its cross-process legs
run over (``group``). Each process holds only its own shards
(:meth:`DeviceMesh.local_shards`).

:func:`local_mesh` enumerates the cards ``torch.cuda.device_count()``
reports when the package's default device is CUDA (one H100: a 1-shard
mesh). When the default device is the CPU it enumerates logical CPU
shards, each ``torch.device("cpu")``: ``TFT_CPU_DEVICE_COUNT`` of them
(default 1), the counterpart of the JAX package's
``--xla_force_host_platform_device_count``, so the tests build the JAX
package's 8-device meshes. An explicit :class:`DeviceMesh` may name one
device more than once (8 logical shards on one card); ``local_mesh``
never repeats a card.

Logical device identity: the JAX package keys everything elastic (the
lost-device pool, admission candidates, the skew tracker, grow's
membership test) by ``jax.Device.id``. Equal ``torch.device`` objects
cannot tell the port's shards apart (8 logical shards of ``cuda:0`` are 8
equal devices), so a :class:`DeviceMesh` carries one logical id per slot
in ``ids``, an int array of the same shape as ``devices``: the port's
``d.id``. :func:`local_mesh` numbers the visible devices 0..n-1; an
explicit ``DeviceMesh(devices)`` numbers by position unless ``ids=`` is
given. The elastic layer's shrink and grow carry the ids along. On a
cluster mesh ids number globally, in process order, and a slot's identity
also holds its process: ``cuda:0`` of process 0 and ``cuda:0`` of process 1
are different slots.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import default_device
from ..utils.env import env_int

__all__ = ["DeviceMesh", "LogicalDevice", "local_mesh", "refuse_cluster"]


class LogicalDevice:
    """One slot of a mesh: its logical ``id`` (the port's ``jax.Device.id``),
    the ``torch.device`` it runs on and the ``process`` that owns it (0 on a
    single-controller mesh). Equal when all three agree, so the lost shards
    of one card stay distinct, and so do the same card index of two
    processes."""

    __slots__ = ("id", "device", "process")

    def __init__(self, id: int, device, process: int = 0):
        self.id = int(id)
        self.device = torch.device(device)
        self.process = int(process)

    def __eq__(self, other):
        return (isinstance(other, LogicalDevice) and other.id == self.id
                and other.device == self.device
                and other.process == self.process)

    def __hash__(self):
        return hash((self.id, str(self.device), self.process))

    def __repr__(self):
        if self.process:
            return f"LogicalDevice({self.id}, {self.device}, p{self.process})"
        return f"LogicalDevice({self.id}, {self.device})"


class DeviceMesh:
    """Named axes over an array of ``torch.device`` objects; the data axis
    shards the rows of a distributed frame."""

    def __init__(self, devices, axis_names: Sequence[str] = ("data",),
                 data_axis: str = "data", ids=None, processes=None,
                 group=None):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).flat]
        arr.reshape(-1)[:] = flat
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(
                f"devices of shape {arr.shape} do not match axes "
                f"{self.axis_names}")
        self.devices = arr
        if ids is None:
            ids = np.arange(arr.size, dtype=np.int64).reshape(arr.shape)
        ids = np.asarray(ids, dtype=np.int64)
        if ids.shape != arr.shape:
            raise ValueError(
                f"ids of shape {ids.shape} do not match devices of shape "
                f"{arr.shape}")
        if len(set(ids.reshape(-1).tolist())) != ids.size:
            raise ValueError(f"mesh ids must be distinct, got "
                             f"{ids.reshape(-1).tolist()}")
        # one logical id per slot: the port's ``jax.Device.id``
        self.ids = ids
        self.data_axis = data_axis
        if data_axis not in self.axis_names:
            raise ValueError(
                f"Mesh has axes {self.axis_names}; no {data_axis!r} axis")
        if processes is None:
            processes = np.zeros(arr.shape, dtype=np.int64)
        processes = np.asarray(processes, dtype=np.int64)
        if processes.shape != arr.shape:
            raise ValueError(
                f"processes of shape {processes.shape} do not match devices "
                f"of shape {arr.shape}")
        # the process owning each slot; ``group`` is the cluster's process
        # group (``cluster.ClusterGroup``), None on a single-controller mesh
        self.processes = processes
        self.group = group

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def num_data_shards(self) -> int:
        return self.shape[self.data_axis]

    @property
    def num_devices(self) -> int:
        return int(self.devices.size)

    def flat_ids(self) -> List[int]:
        """Every slot's logical id, in the devices' flat order."""
        return [int(i) for i in self.ids.reshape(-1)]

    def logical_devices(self) -> List[LogicalDevice]:
        """Every slot as a :class:`LogicalDevice`, in flat order."""
        return [LogicalDevice(i, d, p) for i, d, p in
                zip(self.flat_ids(), self.devices.reshape(-1),
                    self.processes.reshape(-1).tolist())]

    @property
    def is_cluster(self) -> bool:
        """True for a mesh over the processes of a cluster
        (``cluster.cluster_mesh``): its ops add cross-process legs."""
        return self.group is not None

    def shard_processes(self) -> List[int]:
        """The process owning each data shard, in shard order."""
        axis = self.axis_names.index(self.data_axis)
        moved = np.moveaxis(self.processes, axis, 0)
        return [int(p) for p in moved.reshape(moved.shape[0], -1)[:, 0]]

    def local_shards(self) -> List[int]:
        """The data shards this process holds, in shard order: every shard
        of a single-controller mesh, this process's own of a cluster's."""
        if self.group is None:
            return list(range(self.num_data_shards))
        me = self.group.rank
        return [s for s, p in enumerate(self.shard_processes()) if p == me]

    def local_shard_devices(self) -> List[torch.device]:
        """The device of each data shard this process holds."""
        devs = self.shard_devices()
        return [devs[s] for s in self.local_shards()]

    def axis_size(self, axis: Optional[str]) -> int:
        """The size of ``axis``; 1 for ``None``."""
        return 1 if axis is None else self.shape[axis]

    def device_at(self, **coords: int) -> torch.device:
        """The device of the slot at ``coords`` (axis name -> index); an
        axis not named is taken at index 0, so a part split over some axes
        runs on the first slot of the others."""
        for name in coords:
            if name not in self.axis_names:
                raise ValueError(f"Mesh has axes {self.axis_names}; no "
                                 f"{name!r} axis")
        return self.devices[tuple(coords.get(a, 0)
                                  for a in self.axis_names)]

    def shard_devices(self) -> List[torch.device]:
        """The device of each data shard, in shard order: the first device
        along every other axis (a shard is replicated over those)."""
        axis = self.axis_names.index(self.data_axis)
        moved = np.moveaxis(self.devices, axis, 0)
        return list(moved.reshape(moved.shape[0], -1)[:, 0])

    def __repr__(self):
        if self.group is not None:
            return (f"DeviceMesh({self.shape}, data_axis={self.data_axis!r}, "
                    f"processes={self.group.size})")
        return f"DeviceMesh({self.shape}, data_axis={self.data_axis!r})"


def refuse_cluster(mesh, op: str) -> None:
    """Raise before any collective when ``op`` meets a cluster mesh it does
    not run on: every process refuses alike, so no peer waits."""
    if mesh is not None and getattr(mesh, "is_cluster", False):
        raise NotImplementedError(
            f"{op} on a cluster mesh is not supported: the JAX package "
            f"neither defines nor tests it across processes (ROADMAP.md "
            f"section C); run it on a single-process mesh")


def _visible_devices() -> List[torch.device]:
    """The cards when the default device is CUDA, else the logical CPU
    shards (``TFT_CPU_DEVICE_COUNT``, default 1)."""
    if default_device().type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * max(env_int("TFT_CPU_DEVICE_COUNT", 1), 1)


def visible_logical_devices() -> List[LogicalDevice]:
    """The visible devices as :func:`local_mesh` numbers them (0..n-1)."""
    return [LogicalDevice(i, d) for i, d in enumerate(_visible_devices())]


def local_mesh(num_devices: Optional[int] = None,
               axis_names: Sequence[str] = ("data",),
               shape: Optional[Sequence[int]] = None) -> DeviceMesh:
    """Build a mesh over the locally visible devices.

    One card gives a 1-device mesh (the degenerate case every op still
    runs through); 8 logical CPU shards (tests) give the 8-way data mesh
    of the JAX package's tests.
    """
    devices = _visible_devices()
    if num_devices is not None:
        if num_devices < 1:
            raise ValueError(
                f"num_devices must be >= 1, got {num_devices}")
        if num_devices > len(devices):
            raise ValueError(
                f"local_mesh(num_devices={num_devices}) asked for more "
                f"devices than the {len(devices)} visible; lower "
                f"num_devices (or add devices, e.g. TFT_CPU_DEVICE_COUNT "
                f"on CPU)")
        devices = devices[:num_devices]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        # validate against what the CALLER asked for: naming only the
        # visible device count when num_devices was given is misleading
        if num_devices is not None:
            raise ValueError(
                f"Mesh shape {tuple(shape)} covers {int(np.prod(shape))} "
                f"device(s) but num_devices={num_devices} was requested "
                f"— make the shape's product equal num_devices")
        raise ValueError(
            f"Mesh shape {tuple(shape)} covers {int(np.prod(shape))} "
            f"device(s) but {n} are visible")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return DeviceMesh(arr.reshape(tuple(shape)), tuple(axis_names),
                      data_axis=axis_names[0])
