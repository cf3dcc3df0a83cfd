"""Multi-process operation: process bootstrap + process-local distribution.

The port's counterpart of ``tensorframes_tpu/parallel/cluster.py``, over
``torch.distributed`` where the JAX package uses ``jax.distributed``.
Every process runs the same program; :func:`initialize` joins them into
one process group (rank 0 hosts its ``TCPStore``), :func:`cluster_mesh`
builds a :class:`~.mesh.DeviceMesh` over every process's slots, in rank
order with the data axis leading, and :func:`distribute_local` is the
executor-side entry: each process contributes its OWN rows and gets back
a :class:`~.distributed.DistributedFrame` whose columns hold that
process's shards only. Per-process padding is tracked with a per-shard
validity vector, so reductions and aggregations mask pad rows wherever
they fall, not just in a global suffix.

The JAX package's global arrays make every d-op work across processes
through its compiler's collectives; the port's layer is
single-controller, so each d-op that reads across shards has an explicit
cross-process leg over the group (``collectives.py``): partials gathered
to every process and folded in global shard order, key tables unioned,
survivor counts and the columnsort exchange carried by allgathers and
``all_to_all_single``. Every process's result is bit-identical.

The backend follows where the ranks are: ``nccl`` when every rank has a
CUDA card of its own (ranks compare card UUIDs over the store), ``gloo``
when ranks share a card or run on the CPU. ``backend=`` (or
``TFT_DIST_BACKEND``) names one; a choice that cannot work (``nccl`` with
two ranks on one card, or a rank on the CPU) raises
:class:`~..resilience.ClusterInitError` within the bootstrap deadline and
never becomes another backend.
"""

from __future__ import annotations

import json
import os
import socket
from datetime import timedelta
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import dtypes as _dt
from ..device import default_device
from ..engine.executor import to_device
from ..frame import Block, TensorFrame
from ..resilience import (ClusterInitError, DeadlineExceeded, deadline,
                          default_policy, env_bool, env_float, faults,
                          is_transient, remaining_time)
from ..schema import Schema
from ..utils.logging import get_logger
from ..utils.tracing import counters
from .collectives import ClusterGroup, allgather_object
from .distributed import DistributedFrame, _refuse_host_columns, _sharded
from .mesh import DeviceMesh, _visible_devices

__all__ = ["initialize", "cluster_mesh", "distribute_local",
           "process_index", "process_count", "process_identity"]

_log = get_logger("parallel.cluster")

# default bound on the whole bootstrap (connect + retries): torch's own
# default (30 minutes) would swallow a wrong coordinator address whole
_DEFAULT_BOOTSTRAP_TIMEOUT = 60.0
_BACKENDS = ("gloo", "nccl")

# this process's group and the store it rendezvoused through (kept alive:
# rank 0's store serves the other ranks for the group's lifetime)
_group: Optional[ClusterGroup] = None
_store = None


class BackendRefused(ClusterInitError):
    """An explicitly chosen backend cannot run where the ranks are."""


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout: Optional[float] = None,
               backend: Optional[str] = None,
               **kwargs) -> bool:
    """Join this process to the cluster (idempotent). Returns True when
    the process is part of a multi-process cluster afterwards, False when
    it degraded to (or already was) single-process.

    Explicit arguments win, otherwise ``TFT_COORDINATOR`` /
    ``TFT_NUM_PROCESSES`` / ``TFT_PROCESS_ID`` are read, otherwise
    torch's own launcher variables (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``, as ``torchrun`` sets them).

    - a partially-specified cluster (e.g. a coordinator address with no
      process count) raises ``ValueError`` at once, and so does a
      malformed address;
    - ranks other than 0 probe the coordinator with a TCP connect before
      they join;
    - the whole bootstrap is bounded by ``timeout`` (or
      ``TFT_BOOTSTRAP_TIMEOUT``, default 60 s) and retried with backoff:
      an explicitly-configured cluster keeps retrying until that deadline
      (the coordinator may simply not be up yet), autodetection retries
      under the attempt-counted process policy (``TFT_RETRY_*`` knobs);
      the store and ``init_process_group`` get what is left of the
      deadline as their timeout, and every later collective of the group
      is bounded by the bootstrap timeout;
    - when the bootstrap still fails, the process degrades to a
      single-process mesh with a LOUD warning, unless
      ``TFT_REQUIRE_CLUSTER=1``, which turns degradation into a
      :class:`~..resilience.ClusterInitError` raised within the deadline;
    - ``backend`` (``"gloo"`` or ``"nccl"``; ``TFT_DIST_BACKEND``) is
      chosen from where the ranks are when not given (module docstring);
      an impossible choice raises ``ClusterInitError`` whatever
      ``TFT_REQUIRE_CLUSTER`` says. The chosen backend is logged at INFO.

    ``kwargs`` are the JAX package's options for ``jax.distributed``; any
    given raises ``TypeError``.
    """
    import torch.distributed as tdist

    if kwargs:
        # the JAX package hands these to jax.distributed.initialize; the
        # port has no counterpart and never drops an option quietly
        raise TypeError(f"initialize() got options of jax.distributed "
                        f"that the port has no counterpart for: "
                        f"{sorted(kwargs)}")
    if tdist.is_initialized():  # already up
        return tdist.get_world_size() > 1

    backend = backend or os.environ.get("TFT_DIST_BACKEND") or None
    if backend is not None and backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    coordinator_address = coordinator_address or os.environ.get(
        "TFT_COORDINATOR")
    if num_processes is None and os.environ.get("TFT_NUM_PROCESSES"):
        num_processes = int(os.environ["TFT_NUM_PROCESSES"])
    if process_id is None and os.environ.get("TFT_PROCESS_ID"):
        process_id = int(os.environ["TFT_PROCESS_ID"])

    spec = {"TFT_COORDINATOR / coordinator_address": coordinator_address,
            "TFT_NUM_PROCESSES / num_processes": num_processes,
            "TFT_PROCESS_ID / process_id": process_id}
    given = [k for k, v in spec.items() if v is not None]
    missing = [k for k, v in spec.items() if v is None]
    if given and missing:
        # a partial spec would reach the store as a malformed cluster and
        # surface as an opaque hang; fail fast instead
        raise ValueError(
            f"partially-specified cluster environment: {given} set but "
            f"{missing} missing — set all three (or none, for "
            f"single-process / autodetection)")
    if coordinator_address is not None:
        # malformed addresses fail fast like the partial spec above —
        # retrying (or degrading on) a typo helps nobody
        _parse_hostport(coordinator_address)

    if timeout is None:
        timeout = env_float("TFT_BOOTSTRAP_TIMEOUT",
                            _DEFAULT_BOOTSTRAP_TIMEOUT)
    require_cluster = env_bool("TFT_REQUIRE_CLUSTER", False)
    if given:
        # an explicitly-configured cluster is retried until the bootstrap
        # deadline, not for an attempt count: connection-refused is
        # near-instant while the coordinator has not bound its port yet
        # (the normal worker-before-coordinator launch race), so a
        # 3-attempt budget would give up in milliseconds and split-brain
        # the job. The retry loop's deadline accounting ends the loop.
        policy = default_policy(max_attempts=1_000_000)
    else:
        # autodetection: a handful of tries is plenty — "no cluster
        # detected" answers quickly and is usually the final answer
        policy = default_policy()

    def attempt() -> None:
        faults.check("cluster_init")
        if tdist.is_initialized():
            return  # a slow earlier attempt won the race after all
        addr, n, rank = coordinator_address, num_processes, process_id
        if addr is None:
            addr, n, rank = _autodetect()
        left = remaining_time()
        if rank != 0:
            # probe the coordinator over plain TCP first: a refused or
            # timed-out socket raises ConnectionError / TimeoutError, both
            # transient, both retried, and no store is left half-built
            _probe_coordinator(addr, min(left, 10.0) if left else 10.0)
        _bootstrap(addr, n, rank, backend, left, timeout)

    try:
        with deadline(timeout):
            policy.call(attempt, op="cluster_init")
    except BackendRefused:
        counters.inc("cluster_init.failures")
        raise
    except Exception as e:
        if require_cluster:
            counters.inc("cluster_init.failures")
            raise ClusterInitError(
                f"cluster bootstrap failed within {timeout}s and "
                f"TFT_REQUIRE_CLUSTER is set: {e}") from e
        if (not given and not isinstance(e, DeadlineExceeded)
                and not is_transient(e)):
            # nothing was configured and autodetection said "no cluster
            # here" — the normal single-process case, not a failure (no
            # counter). A TRANSIENT error that survived the retry budget
            # is different: a cluster was within reach and bootstrap
            # genuinely failed, which must be a loud degradation.
            _log.debug("no cluster detected (%s); running single-process",
                       e)
            return False
        counters.inc("cluster_init.failures")
        counters.inc("cluster_init.degraded")
        _log.warning(
            "DEGRADED TO SINGLE-PROCESS: cluster bootstrap failed (%s). "
            "Collectives will only span this process's devices; set "
            "TFT_REQUIRE_CLUSTER=1 to make this fatal instead.", e)
        return False
    return process_count() > 1


def _autodetect():
    """The launcher's variables (``torchrun``) as ``(address, n, rank)``;
    ``ValueError`` (not transient: single-process) when none are set."""
    names = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
    env = {k: os.environ.get(k) for k in names}
    if not all(env.values()):
        raise ValueError(
            f"no cluster configured: neither TFT_COORDINATOR nor the "
            f"launcher's {', '.join(names)} are set "
            f"(missing {[k for k, v in env.items() if not v]})")
    return (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            int(env["WORLD_SIZE"]), int(env["RANK"]))


def _device_identity() -> Dict[str, object]:
    """What this rank runs on, as the ranks compare it over the store."""
    dev = default_device()
    if dev.type != "cuda":
        return {"type": "cpu", "host": socket.gethostname()}
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    uuid = getattr(props, "uuid", None)
    return {"type": "cuda", "index": index, "name": props.name,
            "uuid": str(uuid) if uuid is not None
            else f"{socket.gethostname()}:{props.pci_bus_id}"}


def choose_backend(idents: Sequence[Dict[str, object]],
                   requested: Optional[str]) -> str:
    """The backend for ranks on ``idents`` (one :func:`_device_identity`
    per rank): ``nccl`` when every rank has a card of its own, else
    ``gloo``; a ``requested`` one that cannot work raises
    :class:`BackendRefused` naming why."""
    on_cpu = [r for r, i in enumerate(idents) if i["type"] != "cuda"]
    shared = None
    seen: Dict[str, int] = {}
    for r, i in enumerate(idents):
        if i["type"] == "cuda":
            if i["uuid"] in seen and shared is None:
                shared = (seen[i["uuid"]], r, i)
            seen.setdefault(i["uuid"], r)
    if requested == "nccl":
        if on_cpu:
            raise BackendRefused(
                f"backend='nccl' needs a CUDA card on every rank; rank(s) "
                f"{on_cpu} run on the CPU — use backend='gloo'")
        if shared is not None:
            a, b, i = shared
            raise BackendRefused(
                f"backend='nccl' cannot run ranks {a} and {b} on one card "
                f"({i['name']}, {i['uuid']}): NCCL takes one rank per "
                f"card — use backend='gloo', or give each rank its own "
                f"card")
        return "nccl"
    if requested == "gloo":
        return "gloo"
    return "nccl" if not on_cpu and shared is None else "gloo"


def _bootstrap(address: str, n: int, rank: int, requested: Optional[str],
               left: Optional[float], total: float) -> None:
    """One bootstrap attempt: the store, the ranks' device identities, the
    backend, then ``init_process_group`` over the store."""
    global _group, _store
    import torch.distributed as tdist

    host, port = _parse_hostport(address)
    wait = timedelta(seconds=max(left if left is not None else total, 1.0))
    store = tdist.TCPStore(host, port, world_size=n, is_master=(rank == 0),
                           timeout=wait, wait_for_workers=False)
    try:
        ident = _device_identity()
        store.set(f"tft/device/{rank}", json.dumps(ident))
        idents = [json.loads(store.get(f"tft/device/{r}"))
                  for r in range(n)]
        # rank 0 hosts the store: it waits until every rank has read the
        # identities, so that a refusal (every rank refuses alike) never
        # closes the store under a rank still reading
        if rank:
            store.set(f"tft/read/{rank}", "1")
        else:
            store.wait([f"tft/read/{r}" for r in range(1, n)])
        chosen = choose_backend(idents, requested)
        if chosen == "nccl":
            torch.cuda.set_device(int(ident["index"]))
        tdist.init_process_group(
            chosen, store=tdist.PrefixStore("tft", store), rank=rank,
            world_size=n, timeout=timedelta(seconds=max(total, 1.0)))
    except BaseException:
        # drop the store here, not with the traceback: rank 0's listener
        # must close before a retry binds the port again
        store = None  # noqa: F841
        raise
    _store = store
    _group = ClusterGroup(None, rank, n, chosen)
    where = sorted({i.get("name", i["type"]) for i in idents})
    _log.info("cluster: rank %d of %d joined %s with backend %s on %s",
              rank, n, address, chosen, ", ".join(map(str, where)))


def shutdown() -> None:
    """Leave the cluster: destroy the process group (a no-op when none is
    up). Call it before the process exits, every rank alike."""
    global _group, _store
    import torch.distributed as tdist

    if tdist.is_initialized():
        tdist.destroy_process_group()
    _group, _store = None, None


def _parse_hostport(address: str):
    """``host:port`` / ``[v6]:port`` → ``(host, port)``; ``ValueError``
    on anything a socket connect could not use."""
    host, sep, port_s = address.rpartition(":")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]  # bracketed IPv6 literal
    try:
        port = int(port_s)
    except ValueError:
        port = -1
    if not sep or not 0 < port < 65536:
        raise ValueError(
            f"coordinator address {address!r} is not host:port")
    return host or "127.0.0.1", port


def _probe_coordinator(address: str, timeout: float) -> None:
    """One TCP connect to the coordinator, bounded by ``timeout``.

    Raises ``ConnectionError`` (refused/reset) or ``TimeoutError``
    (unroutable) — the transient classifications the retry loop expects.
    """
    host, port = _parse_hostport(address)
    try:
        sock = socket.create_connection((host, port),
                                        timeout=max(timeout, 0.001))
    except socket.timeout as e:
        raise TimeoutError(
            f"coordinator {address} unreachable within {timeout:.1f}s"
        ) from e
    except OSError as e:
        raise ConnectionError(
            f"coordinator {address} not accepting connections: {e}"
        ) from e
    sock.close()


def process_index() -> int:
    import torch.distributed as tdist

    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as tdist

    return tdist.get_world_size() if tdist.is_initialized() else 1


def process_identity() -> str:
    """A stable worker-id string for THIS process (``p<i>of<n>``); safe
    before :func:`initialize` (a single uninitialized process is
    ``p0of1``)."""
    return f"p{process_index()}of{process_count()}"


def cluster_mesh(axis_names: Sequence[str] = ("data",),
                 shape: Optional[Sequence[int]] = None,
                 local_devices: Optional[Sequence] = None) -> DeviceMesh:
    """A mesh over every process's slots, in rank order.

    Each process's slots are ``local_devices`` (default: the devices
    ``local_mesh()`` would see: the cards, or ``TFT_CPU_DEVICE_COUNT``
    CPU shards); ``[cuda:0] * 4`` gives a process 4 logical shards of its
    card. Every process calls this together (one allgather of the slot
    lists). Logical ids number globally; the data axis must lead
    (``distribute_local`` lays each process's rows on its own shards, in
    rank order). Without a cluster (no :func:`initialize`, or a
    degraded one) this is a single-process mesh over the local slots."""
    local = [torch.device(d) for d in (local_devices
                                       if local_devices is not None
                                       else _visible_devices())]
    if not local:
        raise ValueError("cluster_mesh needs at least one local device")
    g = _group
    if g is None:
        per_rank: List[List[str]] = [[str(d) for d in local]]
    else:
        per_rank = allgather_object(g, [str(d) for d in local])
    devices = [torch.device(d) for r in per_rank for d in r]
    procs = [r for r, devs in enumerate(per_rank) for _ in devs]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"Mesh shape {tuple(shape)} does not cover {n} "
                         f"devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    arr = arr.reshape(tuple(shape))
    pro = np.asarray(procs, np.int64).reshape(tuple(shape))
    rows = pro.reshape(pro.shape[0], -1)
    if (rows != rows[:, :1]).any():
        raise ValueError(
            f"Mesh shape {tuple(shape)} puts one data shard on the devices "
            f"of more than one process; make the data axis a multiple of "
            f"the process count")
    return DeviceMesh(arr, tuple(axis_names), data_axis=axis_names[0],
                      ids=np.arange(n, dtype=np.int64).reshape(arr.shape),
                      processes=pro, group=g)


def distribute_local(local: Mapping[str, np.ndarray] | TensorFrame,
                     mesh: DeviceMesh,
                     schema: Optional[Schema] = None) -> DistributedFrame:
    """Build a global :class:`DistributedFrame` from process-local rows.

    Every process calls this collectively with its OWN row block (local
    row counts may differ). Rows land process-contiguously in the global
    order; each process's block is zero-padded up to its shards (every
    shard of the mesh holds the same ``rows_per`` rows, sized for the
    largest block), and the per-shard valid-row counts ride along so
    every reduction masks pads wherever they fall
    (``DistributedFrame.shard_valid``)."""
    if isinstance(local, TensorFrame):
        merged = Block.concat(local.blocks(), local.schema)
        schema = local.schema
        cols_in: Dict[str, np.ndarray] = {
            f.name: merged.dense(f.name) for f in schema}
        n_local = merged.num_rows
    else:
        if schema is None:
            schema = TensorFrame.from_columns(dict(local)).schema
        cols_in = {k: np.asarray(v) for k, v in local.items()}
        n_local = next(iter(cols_in.values())).shape[0] if cols_in else 0

    # everything that can fail is checked before the first collective
    axis = mesh.data_axis
    if mesh.axis_names[0] != axis:
        raise ValueError(
            f"distribute_local needs the data axis {axis!r} leading in the "
            f"mesh (axes: {mesh.axis_names}) for process-contiguous row "
            f"layout")
    if mesh.is_cluster:
        _refuse_host_columns(schema)
    S = mesh.num_data_shards
    shard_proc = mesh.shard_processes()
    my_shards = mesh.local_shards()
    if not my_shards:
        raise ValueError(f"process {process_index()} owns no data shards "
                         f"of {mesh!r}")

    counts = (np.asarray(allgather_object(mesh.group, int(n_local)),
                         np.int64) if mesh.is_cluster
              else np.asarray([n_local], np.int64))
    # uniform rows-per-shard across the global mesh, sized for the
    # largest process block
    per_proc_shards = {p: shard_proc.count(p) for p in set(shard_proc)}
    rows_per = max(
        (int(counts[p]) + per_proc_shards[p] - 1) // per_proc_shards[p]
        for p in per_proc_shards)
    rows_per = max(rows_per, 1)

    # per-shard valid counts, globally (every process computes identically)
    shard_valid = np.zeros(S, np.int64)
    seen: Dict[int, int] = {p: 0 for p in per_proc_shards}
    for s in range(S):
        p = shard_proc[s]
        got = seen[p]
        shard_valid[s] = min(max(int(counts[p]) - got, 0), rows_per)
        seen[p] = got + rows_per
    num_rows = int(counts.sum())

    local_padded = len(my_shards) * rows_per
    devs = mesh.shard_devices()
    columns: Dict[str, object] = {}
    for f in schema:
        a = cols_in[f.name]
        if not f.dtype.tensor:
            from .distributed import _host_side_column

            columns[f.name] = _host_side_column(a, f, local_padded)
            continue
        if a.shape[0] != local_padded:
            out = np.zeros((local_padded,) + a.shape[1:], a.dtype)
            out[:a.shape[0]] = a
            a = out
        dd = _dt.device_dtype(f.dtype)
        columns[f.name] = _sharded(
            mesh, [to_device(a[j * rows_per:(j + 1) * rows_per], dd, devs[s])
                   for j, s in enumerate(my_shards)], [rows_per] * S)
    return DistributedFrame(mesh, schema, columns, num_rows,
                            shard_valid=shard_valid)
