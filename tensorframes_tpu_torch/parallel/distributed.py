"""Distributed frames: mesh-sharded columns and mesh-level map/reduce.

The port's counterpart of ``tensorframes_tpu/parallel/distributed.py``,
single-controller as the JAX package is: one process drives every device
of a :class:`~.mesh.DeviceMesh`. A :class:`DistributedFrame` holds each
device column as a :class:`ShardedArray`, one tensor per data shard on
that shard's device, all shards of equal length (pad rows make up the
remainder; ``num_rows`` remembers the truth). Then:

- :func:`dmap_blocks` runs the program on every shard with no
  cross-device traffic; with ``trim=True`` it sees the global padded
  array, one concatenation on the first shard's device;
- :func:`dfilter` compacts each shard's kept rows to its front and
  records per-shard survivor counts;
- :func:`dreduce_blocks` reduces each shard locally, pad rows masked to
  the combiner's neutral element, and folds the partials with the
  combiner's collective (``collectives.py``); an arbitrary reduce
  computation combines the per-shard partials with one more call;
- :func:`daggregate` reduces each shard's rows into a dense
  ``[groups, ...]`` table — a float sum through the hand-written
  ``segment_sum`` kernel (B1) on every shard — and folds the tables
  across the data axis. Group ids come from a host factorization of the
  key columns (cached per frame) or, with ``max_groups=``, from a
  sort-unique and a ``searchsorted`` of the keys on the devices, so the
  keys never visit the host. A computation-form aggregate folds each
  shard's groups by a segmented scan of the program and folds the
  shards' tables with the same program.

- :func:`dsort` sorts globally by columnsort (per-shard sorts and copies
  between the shards, never the global array on one device), or through
  the external sort when the frame outgrows the device budget.

``daggregate`` routes past ``TFT_SHUFFLE_AGG_GROUPS`` groups to the
shuffle-partitioned aggregate (``exchange.py``) and folds sketch
combiners from the host copies of their columns.

Every op dispatches through the elastic boundary
(``elastic.elastic_call``): a classified device loss shrinks the mesh,
re-shards the frame through the host and re-runs the op on the surviving
shards; persistent skew re-partitions the rows first; a grown mesh is
picked up at the next op. While a trace is active each op records one
time per shard (a CUDA event after each shard's work on a card, the host
clock on the CPU, cumulative from one start) as ``shard_compute`` events
on the device tracks and feeds them to the skew tracker.
:meth:`DistributedFrame.lazy` records chains for ``plan/dist.py``'s fused
stages. Under a device budget with spilling on, mesh frames are spill
candidates of the memory ledger (``memory.spillable_columns``), moved
shard by shard to pinned host memory and faulted back on their next
touch; shape metadata never faults them back. ``TFT_EXECUTOR=pjrt``
routes the ops the JAX package routes through the native execution core,
one SPMD package an op (``native_mesh.py``), where the JAX package does:
the row-aligned ``dmap_blocks``, ``dfilter``, ``dsort``'s columnsort, both
``dreduce_blocks`` routes and both ``daggregate`` routes (not a salted
one); the program is the eager route's own shard functions and fold (the
map, the collective reduce, the columnsort and the generic fold take the
shards together: ``native_mesh.py``).
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import dtypes as _dt
from .. import memory as _memory
from ..engine import ops as _ops
from ..engine.executor import (BlockExecutor, to_device, to_host,
                               to_storage_dtype)
from ..frame import Block, TensorFrame
from ..memory.external_sort import lexsort_order
from ..observability.events import (DEVICE_TRACK_BASE, current_trace,
                                    traced_query)
from ..resilience import default_policy as _default_policy
from ..resilience import faults as _faults
from ..schema import Field, Schema
from ..shape import Unknown
from ..utils.logging import get_logger
from ..utils.tracing import counters, span
from . import elastic as _elastic
from . import native_mesh as _nm
from .collectives import (COMBINERS, allgather_object, allgather_var,
                          gather_shard_parts, route_pieces)
from .mesh import DeviceMesh

__all__ = ["DistributedFrame", "ShardedArray", "distribute", "dmap_blocks",
           "dfilter", "dsort", "dreduce_blocks", "daggregate"]


def _lazy_input(dist):
    """The lazy recording view when ``dist`` is one (``frame.lazy()``),
    else None: the d-op entry points continue recorded chains instead of
    forcing them (``plan/dist.py``)."""
    return dist if getattr(dist, "_tft_lazy_dist", False) else None


def _native_mesh(mesh: DeviceMesh):
    """The native mesh executor when ``TFT_EXECUTOR=pjrt`` routes mesh ops
    through the core and it can span ``mesh``, else ``None`` (the eager
    route)."""
    if os.environ.get("TFT_EXECUTOR") != "pjrt":
        return None
    return _nm.executor_for(mesh)


def _from_native(mesh: DeviceMesh, pieces, rows) -> ShardedArray:
    """A native result's pieces (numpy), one a data shard of ``rows[s]``
    rows, placed on the shards' devices."""
    devs = mesh.shard_devices()
    return _sharded(mesh, [torch.from_numpy(p).to(devs[s])
                           for s, p in enumerate(pieces)], rows)


def _shard_counts(dist) -> List[np.ndarray]:
    """Each data shard's valid-row count, as the native route hands it to
    a shard (one int64 a shard)."""
    return [np.array([c], np.int64) for c in dist.per_shard_valid()]


# ---------------------------------------------------------------------------
# sharded columns
# ---------------------------------------------------------------------------

class ShardedArray:
    """One device column of a :class:`DistributedFrame`: a tensor per
    data shard, each on its shard's device, in shard order. Its global
    view is the shards' rows concatenated (``shape``, ``numpy()``).

    On a cluster mesh (``cluster.cluster_mesh``) a process holds only its
    own shards (``mesh.local_shards()``): ``cluster`` is the mesh and
    ``rows`` every shard's row count in global shard order. ``gather`` and
    ``numpy`` then assemble the global array with one allgather, so every
    process must call them together."""

    __slots__ = ("shards", "cluster", "rows")

    def __init__(self, shards: Sequence[torch.Tensor], cluster=None,
                 rows: Optional[Sequence[int]] = None):
        self.shards = list(shards)
        self.cluster = cluster
        self.rows = None if rows is None else tuple(int(r) for r in rows)

    def like(self, shards: Sequence[torch.Tensor]) -> "ShardedArray":
        """New shards laid out as these are (the same rows per shard)."""
        return ShardedArray(shards, self.cluster, self.rows)

    @property
    def shape(self):
        first = self.shards[0]
        n = (sum(self.rows) if self.cluster is not None
             else sum(int(s.shape[0]) for s in self.shards))
        return (n,) + tuple(first.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.shards]

    @property
    def nbytes(self) -> int:
        return sum(int(s.numel()) * int(s.element_size())
                   for s in self.shards)

    def gather(self, device: torch.device) -> torch.Tensor:
        """The global array, concatenated on ``device`` (a collective on a
        cluster mesh: every process's shards, in shard order)."""
        local = torch.cat([s.to(device) for s in self.shards])
        if self.cluster is None:
            return local
        return torch.cat(allgather_var(self.cluster.group, local))

    def numpy(self) -> np.ndarray:
        """The global array on the host (one copy per shard; one
        allgather on a cluster mesh)."""
        if self.cluster is not None:
            return to_host(self.gather(self.shards[0].device))
        return np.concatenate([to_host(s) for s in self.shards])

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self):
        return (f"ShardedArray(shape={self.shape}, dtype={self.dtype}, "
                f"shards={len(self.shards)})")


def _sharded(mesh: DeviceMesh, shards: Sequence[torch.Tensor],
             rows: Sequence[int]) -> ShardedArray:
    """The shards this process holds as a column of ``mesh``, whose data
    shards have ``rows`` rows each (recorded on a cluster mesh, where the
    other processes' shards are not here to count)."""
    if mesh.is_cluster:
        return ShardedArray(shards, mesh, rows)
    return ShardedArray(shards)


def _place(mesh: DeviceMesh, a: np.ndarray, rows: Sequence[int],
           dtype: torch.dtype) -> ShardedArray:
    """Place a host array on the mesh: ``rows[i]`` rows, in order, on
    data shard ``i``'s device, as ``dtype`` (a cluster process places the
    rows of its own shards only)."""
    held = set(mesh.local_shards())
    out, lo = [], 0
    for s, (r, d) in enumerate(zip(rows, mesh.shard_devices())):
        if s in held:
            out.append(to_device(a[lo:lo + r], dtype, d))
        lo += r
    return _sharded(mesh, out, rows)


def _shard_rows(dist) -> List[int]:
    """The row count of each data shard of ``dist``."""
    for c in dist.columns.values():
        if isinstance(c, ShardedArray):
            if c.rows is not None:
                return list(c.rows)
            return [int(s.shape[0]) for s in c.shards]
    S = dist.mesh.num_data_shards
    return [dist.padded_rows // S] * S


def _chunk_rows(n: int, S: int) -> List[int]:
    """Rows of each shard when ``n`` rows lie in ceil-div chunks (equal
    shards when ``n`` tiles the data axis)."""
    chunk = -(-n // S)
    return [max(0, min(n, (i + 1) * chunk) - min(n, i * chunk))
            for i in range(S)]


def _split_global(mesh: DeviceMesh, t: torch.Tensor) -> ShardedArray:
    """A trim program's global result back onto the mesh, in the ceil-div
    chunks of :meth:`DistributedFrame.per_shard_valid` (equal shards when
    it tiles the data axis; some chunks may be empty otherwise)."""
    devices = mesh.shard_devices()
    rows = _chunk_rows(int(t.shape[0]), len(devices))
    bounds = np.cumsum([0] + rows)
    return _sharded(mesh, [t[int(bounds[s]):int(bounds[s + 1])].to(devices[s])
                           for s in mesh.local_shards()], rows)


def _read_global(a) -> np.ndarray:
    """A column (sharded or host-side) as one host array."""
    return a if isinstance(a, np.ndarray) else a.numpy()


_PREP = BlockExecutor(device="cpu")


def _call(comp, inputs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Run ``comp`` on one shard's (or the gathered global) tensors, on
    their device: deserialized programs are placed there first."""
    if comp._tft_programs:
        _PREP._prepare(comp, inputs)
    with torch.no_grad():
        out = comp.fn(dict(inputs))
    for spec in comp.outputs:
        if not isinstance(out.get(spec.name), torch.Tensor):
            raise TypeError(
                f"Computation output {spec.name!r} is "
                f"{type(out.get(spec.name)).__name__}, not a torch.Tensor")
    return out


# ---------------------------------------------------------------------------
# trace instrumentation (only behind a `trace is not None` check)
# ---------------------------------------------------------------------------

def _mesh_meta(dist) -> Dict:
    m = dist.mesh
    return {"mesh_shape": m.shape, "shards": m.num_data_shards,
            "devices": m.num_devices, "rows": dist.num_rows,
            "padded_rows": dist.padded_rows}


def _meta_with_fetches(fetches=None, dist=None, *a, **k):
    dist = k.get("dist", dist)
    fetches = k.get("fetches", fetches)
    if dist is None:
        return {}
    meta = _mesh_meta(dist)
    names = getattr(fetches, "output_names", None)
    if names:
        meta["fetches"] = sorted(names)
    elif isinstance(fetches, Mapping):
        meta["fetches"] = sorted(str(n) for n in fetches)
    return meta


def _meta_dfilter(predicate=None, dist=None, *a, **k):
    dist = k.get("dist", dist)
    return _mesh_meta(dist) if dist is not None else {}


def _meta_dsort(keys=None, dist=None, *a, **k):
    dist = k.get("dist", dist)
    keys = k.get("keys", keys)
    if dist is None:
        return {}
    meta = _mesh_meta(dist)
    meta["keys"] = [keys] if isinstance(keys, str) else list(keys or ())
    return meta


def _meta_daggregate(fetches=None, dist=None, keys=None, *a, **k):
    meta = _meta_with_fetches(fetches, dist, **k)
    keys = k.get("keys", keys)
    if meta and keys is not None:
        meta["keys"] = [keys] if isinstance(keys, str) else list(keys)
    return meta


def _meta_distribute(df=None, mesh=None, *a, **k):
    mesh = k.get("mesh", mesh)
    if mesh is None:
        return {}
    return {"mesh_shape": mesh.shape, "shards": mesh.num_data_shards,
            "devices": mesh.num_devices}


class _ShardClock:
    """Per-shard times of one traced mesh dispatch, in the JAX package's
    ordered-readiness form: the time until shard ``i`` AND every earlier
    one were done, had the shards started together each on a device of
    its own. Shards that share a device (the logical shards of one card,
    or of the host) run one after another, so each one's own time is its
    finish less the previous finish on its device, and the form is the
    running maximum of those: equal shards give equal times, not a ramp
    that reads as skew. On a card the finishes are CUDA events recorded
    on the shard's stream after its work (:meth:`mark`), measured from one
    start event per card and read only once they have completed
    (:meth:`ready`), never waited for; on the CPU, the host clock. Shards
    the dispatch did not mark share what is left of its time (:meth:`seal`).
    Made only while a trace is active."""

    def __init__(self, trace, mesh: DeviceMesh):
        self.ts = trace.clock()
        self.devices = mesh.local_shard_devices()
        self.cuda = all(d.type == "cuda" for d in self.devices)
        self.starts = {}
        if self.cuda:
            for d in dict.fromkeys(self.devices):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(d))
                self.starts[d] = ev
        self.w0 = time.perf_counter()
        self.marks: list = []

    def mark(self) -> None:
        """The next shard's work has been issued."""
        d = self.devices[min(len(self.marks), len(self.devices) - 1)]
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(d))
            self.marks.append((d, ev))
        else:
            self.marks.append((d, time.perf_counter() - self.w0))

    def seal(self) -> None:
        """The dispatch is issued: mark the shards it did not mark."""
        while len(self.marks) < len(self.devices):
            self.mark()

    def ready(self) -> bool:
        """Whether every shard's finish can be read without a wait (a
        stream's last event done means its earlier ones are too)."""
        return not self.cuda or all(
            ev.query() for ev in {d: ev for d, ev in self.marks}.values())

    def durations(self) -> List[float]:
        """The shards' times; on a card, only once :meth:`ready`."""
        self.seal()
        if self.cuda:
            ends = [(d, self.starts[d].elapsed_time(ev) / 1e3)
                    for d, ev in self.marks]
        else:
            ends = self.marks
        out, run, prev = [], 0.0, {}
        for d, end in ends:
            run = max(run, end - prev.get(d, 0.0))
            prev[d] = end
            out.append(run)
        return out


def _trace_shards(trace, op: str, dist=None, mesh=None) -> _ShardClock:
    """One ``shard`` event per data shard (its valid rows, where the frame
    knows them) on the device tracks; returns the dispatch's clock for
    :func:`_trace_done`."""
    rows = None
    if dist is not None:
        mesh = dist.mesh
        try:
            rows = dist.per_shard_valid()
        except ValueError:
            rows = None
    devices = mesh.shard_devices()
    for i in mesh.local_shards():
        dev = devices[i]
        trace.add("shard", name=f"{op} shard {i}", device=i,
                  device_name=str(dev),
                  rows=(int(rows[i]) if rows is not None else None),
                  track=DEVICE_TRACK_BASE + i)
    return _ShardClock(trace, mesh)


class _ShardTimes:
    """One traced dispatch's per-shard times, recorded once they can be
    read without a wait: ``shard_compute`` events, and the skew tracker's
    input (``elastic.note_dispatch``) when ``mesh`` is given."""

    __slots__ = ("trace", "op", "clock", "mesh", "done")

    def __init__(self, trace, op: str, clock: _ShardClock,
                 mesh: Optional[DeviceMesh]):
        self.trace, self.op, self.clock, self.mesh = trace, op, clock, mesh
        self.done = False

    def settle(self) -> bool:
        """Record the times if the shards' work has completed; True once
        they are recorded."""
        with _pending_lock:
            if self.done:
                return True
            if not self.clock.ready():
                return False
            self.done = True
        durs = self.clock.durations()
        for i, dur in enumerate(durs):
            self.trace.add("shard_compute", name=f"{self.op} d{i}",
                           ts=self.clock.ts, dur=dur, device=i,
                           track=DEVICE_TRACK_BASE + i)
        mesh = self.mesh
        if mesh is not None and len(durs) >= 2 and not mesh.is_cluster:
            _elastic.note_dispatch(mesh, self.op, durs)
        return True


# traced dispatches whose shards were still running on a card when they
# were issued; bounded, so a card that never answers cannot grow it
_pending: "deque[_ShardTimes]" = deque(maxlen=256)
_pending_lock = threading.Lock()


def _settle_pending() -> None:
    """Record the shard times of every earlier traced dispatch whose work
    has completed."""
    with _pending_lock:
        todo = list(_pending)
        _pending.clear()
    left = [p for p in todo if not p.settle()]
    if left:
        with _pending_lock:
            _pending.extendleft(reversed(left))


def _trace_done(trace, op: str, clock: _ShardClock,
                mesh: Optional[DeviceMesh] = None) -> None:
    """Per-shard ``shard_compute`` events and the op-level mesh dispatch
    span. When ``mesh`` is given the per-shard times also feed the
    elastic layer's skew tracker (``elastic.note_dispatch``).

    Nothing here waits for the card: shard times still running there stay
    pending, and are recorded once their events have completed, when the
    trace finishes or is read (``QueryTrace.settle``) or at the next
    traced dispatch."""
    clock.seal()
    _settle_pending()
    times = _ShardTimes(trace, op, clock, mesh)
    if not times.settle():
        with _pending_lock:
            _pending.append(times)
        trace.defer(times.settle)
    trace.add("mesh_dispatch", name=op, ts=clock.ts,
              dur=max(trace.clock() - clock.ts, 0.0))


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------

class DistributedFrame:
    """Columns sharded over the mesh's data axis + the true row count.

    ``num_rows`` is the un-padded row count; rows are padded up to a
    multiple of the data-axis size so every shard is equal, and consumers
    mask or slice the pad away.

    ``shard_valid``: per-data-shard valid-row counts, for frames whose
    pad rows are NOT a global suffix (``dfilter``'s result). ``None``
    means prefix semantics (``distribute``): the first ``num_rows`` rows
    are the real ones.
    """

    def __init__(self, mesh: DeviceMesh, schema: Schema,
                 columns: Dict[str, object], num_rows: int,
                 shard_valid: Optional[np.ndarray] = None):
        self.mesh = mesh
        self.schema = schema
        self.columns = columns
        self.num_rows = num_rows
        self.shard_valid = shard_valid
        # group-id factorizations memoized per key tuple: frames are
        # immutable (every op returns a new frame), so repeated
        # aggregations over the same keys skip the host transfer and
        # lexsort (host keys) or the sort-unique (device keys). LRU-capped:
        # entries hold device arrays sized like the frame
        self._group_ids_cache: "OrderedDict[tuple, tuple]" = OrderedDict()

    @property
    def padded_rows(self) -> int:
        # shape metadata must NOT fault a spilled frame back to the device
        # (collect_frame and valid_row_mask route through here; a
        # larger-than-budget collect would re-resident the whole frame)
        cols = self.columns
        if isinstance(cols, _memory.SpillableColumns):
            return cols.leading_rows()
        first = next(iter(cols.values()))
        return first.shape[0]

    def per_shard_valid(self) -> np.ndarray:
        """Valid-row count of every data shard, [num_data_shards]."""
        S = self.mesh.num_data_shards
        if self.shard_valid is not None:
            return np.asarray(self.shard_valid, np.int64)
        rows_per = self.padded_rows // S
        if rows_per * S != self.padded_rows:
            # a global (row_aligned=False) result need not tile the data
            # axis (e.g. ONE summary row on an 8-shard mesh); such frames
            # carry no pad rows and lie in ceil-div chunks
            if self.num_rows != self.padded_rows:
                raise ValueError(
                    f"frame rows ({self.padded_rows}) do not tile the "
                    f"{S}-shard data axis yet only {self.num_rows} are "
                    f"valid — pad to a multiple of the shard count")
            chunk = -(-self.padded_rows // S)
            starts = np.minimum(np.arange(S) * chunk, self.padded_rows)
            ends = np.minimum(starts + chunk, self.padded_rows)
            return (ends - starts).astype(np.int64)
        out = np.full(S, rows_per, np.int64)
        full, tail = divmod(self.num_rows, rows_per)
        out[full:] = 0
        if full < S:
            out[full] = tail
        return out

    def valid_row_mask(self) -> np.ndarray:
        """Host bool mask [padded_rows]: True where the row is real."""
        S = self.mesh.num_data_shards
        rows_per = self.padded_rows // S
        if rows_per * S != self.padded_rows:
            self.per_shard_valid()  # validates num_rows == padded_rows
            return np.ones(self.padded_rows, bool)
        idx = np.arange(self.padded_rows) % rows_per
        return idx < np.repeat(self.per_shard_valid(), rows_per)

    def host_read_padded(self, name: str) -> np.ndarray:
        """The full padded global column on the host. A spilled frame's
        columns are served from their pinned host buffers WITHOUT faulting
        back to the device."""
        if isinstance(self.columns, _memory.SpillableColumns) \
                and self.columns.mem_is_spilled():
            return self.columns.host_value(name)
        return _read_global(self.columns[name])

    def collect_frame(self, num_partitions: Optional[int] = None
                      ) -> TensorFrame:
        """Bring the data back to the host as a TensorFrame (pad dropped)."""
        mask = self.valid_row_mask()
        host_cols = {}
        for f in self.schema:
            a = self.host_read_padded(f.name)
            a = a[mask] if self.shard_valid is not None \
                else a[: self.num_rows]
            host_cols[f.name] = (to_storage_dtype(a, f.dtype)
                                 if f.dtype.tensor else a)
        return TensorFrame.from_columns(
            host_cols, schema=self.schema,
            num_partitions=num_partitions or self.mesh.num_data_shards)

    def select(self, names) -> "DistributedFrame":
        """A view with only ``names`` (no data movement — the reduce ops
        require every column to back a fetch, so dropping ride-along
        columns first is the normal prelude). The view shares the frame's
        group-id cache: its ids depend only on the key columns and the
        validity, which a view keeps."""
        if isinstance(names, str):
            names = [names]
        names = list(names)
        missing = [n for n in names if n not in self.schema]
        if missing:
            raise KeyError(
                f"No column(s) {missing}; columns: {self.schema.names}")
        view = DistributedFrame(self.mesh, self.schema.select(names),
                                {n: self.columns[n] for n in names},
                                self.num_rows, shard_valid=self.shard_valid)
        view._group_ids_cache = self._group_ids_cache
        return view

    def count(self) -> int:
        """True (un-padded) global row count."""
        return self.num_rows

    def lazy(self):
        """A RECORDING view of this frame: later ``dmap_blocks`` /
        ``dfilter`` / ``select`` calls record distributed plan nodes
        instead of dispatching, and the chain forces as ONE fused stage
        program per mesh stage, its shard intermediates staying on their
        devices (a terminal monoid ``dreduce_blocks`` / ``daggregate``
        folds into the same stage). Returns ``self`` when fusion cannot
        apply (``TFT_FUSE=0``, ``TFT_EXECUTOR=pjrt``, frames whose rows
        do not tile the data axis), so chains then run per op,
        bit-identical by construction. See ``plan/dist.py``."""
        from ..plan import dist as _dplan
        return _dplan.lazy_frame(self)

    def explain(self) -> str:
        """Schema + placement report: per-column dtype, declared shape,
        placement, plus the mesh and pad layout."""
        lines = [f"DistributedFrame: {self.num_rows} rows "
                 f"(padded {self.padded_rows}) on {self.mesh!r}",
                 "  validity: "
                 + ("prefix" if self.shard_valid is None
                    else f"per-shard {list(map(int, self.shard_valid))}")]
        rb = getattr(self, "_rebalance", None)
        if rb:
            lines.append(
                f"  rebalance: skew {rb['ratio']:.2f} during {rb['op']}; "
                f"per-shard rows {rb['before']} -> {rb['after']} "
                f"(proportional to observed device throughput)")
        ex = getattr(self, "_exchange", None)
        if ex:
            flag = (" OVER TFT_SKEW_WARN"
                    if ex["ratio"] > ex["threshold"] else "")
            lines.append(
                f"  exchange: partition imbalance {ex['ratio']:.2f} "
                f"(threshold {ex['threshold']:.2f}{flag}); per-shard "
                f"rows {ex['per_shard']}")
        if self.mesh.is_cluster:
            g = self.mesh.group
            lines.append(f"  cluster: process {g.rank} of {g.size} "
                         f"({g.backend}) holds shards "
                         f"{self.mesh.local_shards()}")
        for f in self.schema:
            col = self.columns[f.name]
            if isinstance(col, np.ndarray):
                place = "host (ride-along)"
            else:
                devs = sorted({str(d) for d in col.devices})
                place = (f"row-sharded over {self.mesh.data_axis!r} "
                         f"({len(col.shards)} shards on "
                         f"{', '.join(devs)})")
            lines.append(f"  {f.describe()} sharding={place}")
        info = getattr(self, "_dplan_info", None)
        if info:
            # the distributed plan section: fused stage layout, resident
            # shard edges, fallback reasons (set by plan.dist when this
            # frame came out of a lazy chain)
            lines.extend(info)
        return "\n".join(lines)

    def __repr__(self):
        return (f"DistributedFrame[{', '.join(self.schema.names)}] "
                f"rows={self.num_rows} mesh={self.mesh!r}")


def _refuse_host_columns(schema: Schema) -> None:
    """Host-side columns are process-local: a cluster mesh refuses them,
    before any collective (the JAX package's check and wording)."""
    for f in schema:
        if not f.dtype.tensor:
            raise ValueError(
                f"column {f.name!r}: non-tensor (string) columns are not "
                f"supported across processes — drop them with select() or "
                f"key on an integer column")


def _host_side_column(a: np.ndarray, field, padded_rows: int) -> np.ndarray:
    """Pad a non-tensor (string) column for the host-side ride-along:
    such columns cannot live on a device, so they travel in the same
    padded global layout as the device columns — pass-through and group
    keys only, the host engine's contract for them."""
    a = np.asarray(a, field.dtype.np_storage)
    if a.shape[0] != padded_rows:
        a = np.concatenate(
            [a, np.full(padded_rows - a.shape[0], None, a.dtype)])
    return a


@traced_query("distribute", _meta_distribute)
def distribute(df: TensorFrame, mesh: DeviceMesh) -> DistributedFrame:
    """Shard a host frame over the mesh's data axis: equal shards of one
    global array, one per data-shard device (pad rows, zero filled, make
    up the remainder; ``num_rows`` remembers the truth)."""
    if mesh.is_cluster:
        _refuse_host_columns(df.schema)
    with span("distribute.concat"):
        merged = Block.concat(df.blocks(), df.schema)
    n = merged.num_rows
    shards = mesh.num_data_shards
    padded = ((n + shards - 1) // shards) * shards if n else shards
    mem_mgr = _memory.active()
    cols: Dict[str, object] = {}
    for f in df.schema:
        a = merged.dense(f.name)
        if not f.dtype.tensor:
            cols[f.name] = _host_side_column(a, f, padded)
            continue
        dd = _dt.device_dtype(f.dtype)
        if padded != n:
            # empty + explicit tail zeros writes each byte once
            with span("distribute.convert_pad"):
                out = np.empty((padded,) + a.shape[1:], a.dtype)
                out[:n] = a
                out[n:] = 0
            a = out
        if mem_mgr is not None:
            # spill colder residents before placing this column
            mem_mgr.make_room(int(a.nbytes))
        with span("distribute.device_put"):
            cols[f.name] = _place(mesh, a, [padded // shards] * shards, dd)
    if mem_mgr is not None and mem_mgr.spill_enabled \
            and not mesh.is_cluster:
        # the frame's device columns become one LRU spill candidate: cold
        # mesh frames move to pinned host buffers under pressure and fault
        # back transparently on the next column access
        cols = _memory.spillable_columns(
            f"distribute:{df._plan.split('(', 1)[0]}@{id(df):x}", cols,
            mem_mgr)
    result = DistributedFrame(mesh, df.schema, cols, n)
    trace = current_trace()
    if trace is not None:
        _trace_done(trace, "distribute", _trace_shards(trace, "distribute",
                                                       result))
    return result


# ---------------------------------------------------------------------------
# dmap_blocks
# ---------------------------------------------------------------------------

def dmap_blocks(fetches, dist: DistributedFrame, trim: bool = False,
                row_aligned: Optional[bool] = None) -> DistributedFrame:
    """Mesh-parallel map: the program runs on every shard.

    Without ``trim``, outputs ride alongside the inputs and must be
    row-local (each output row depends on its input row and constants);
    pad rows flow through and are dropped at collect. With ``trim=True``
    the computation sees the GLOBAL padded array (one concatenation on the
    first shard's device) and may change the row count (e.g. an in-program
    pre-aggregation emitting one global row); it must mask pad rows itself
    (``dist.num_rows`` is the true count, ``padded_rows`` what it sees).

    ``row_aligned`` declares how a trim output relates to the input rows:
    ``True`` — output rows correspond 1:1 to input rows (pad structure
    survives, dropped at collect); ``False`` — the output is a fresh global
    result (every emitted row is real). Default ``None`` infers from the
    row count (equal to ``padded_rows`` -> aligned).

    Like every mesh op, the dispatch runs through the elastic boundary
    (``elastic.py``): a classified device loss shrinks the mesh,
    re-shards and re-runs; persistent skew re-partitions first.

    On a LAZY frame (:meth:`DistributedFrame.lazy`) a proven
    row-preserving non-trim map RECORDS a plan node and defers: the chain
    forces as one fused stage (``plan/dist.py``); trim and unprovable
    computations force the chain and dispatch eagerly.
    """
    lz = _lazy_input(dist)
    if lz is not None:
        from ..plan import dist as _dplan
        out = _dplan.record_map(fetches, lz, trim, row_aligned)
        if out is not None:
            return out
        dist = _dplan.materialize(lz)
    return _dmap_blocks_eager(fetches, dist, trim, row_aligned)


@traced_query("dmap_blocks", _meta_with_fetches)
def _dmap_blocks_eager(fetches, dist: DistributedFrame, trim: bool = False,
                       row_aligned: Optional[bool] = None
                       ) -> DistributedFrame:
    return _elastic.elastic_call(
        "dmap_blocks", dist,
        lambda d: _dmap_blocks(fetches, d, trim, row_aligned))


def _dmap_blocks(fetches, dist: DistributedFrame, trim: bool,
                 row_aligned: Optional[bool]) -> DistributedFrame:
    schema = dist.schema
    if row_aligned is False and not trim:
        raise ValueError(
            "row_aligned=False only makes sense for trim=True outputs: "
            "without trim the untrimmed input columns ride along and still "
            "contain pad rows, which declaring every output row real would "
            "surface as data")
    comp = _ops.cached_map_computation(fetches, schema, block_level=True)
    out_schema = _ops._validate_map(comp, schema, block_level=True, trim=trim)
    mesh = dist.mesh
    names = [s.name for s in comp.outputs]

    # TFT_EXECUTOR=pjrt: a row-aligned map runs as ONE SPMD package in the
    # native core (a trim program and unsupported dtypes run eagerly)
    nm = _native_mesh(mesh) if not trim else None
    if nm is not None:
        outs = nm.dmap(comp, dist)
        if outs is not None:
            counters.inc("mesh.dispatches")
            # per-key copy through __getitem__: spilled columns fault back
            cols = {n: dist.columns[n] for n in dist.columns}
            rows = _shard_rows(dist)
            for spec in comp.outputs:
                cols[spec.name] = _from_native(mesh, outs[spec.name], rows)
            return DistributedFrame(mesh, out_schema, cols, dist.num_rows,
                                    shard_valid=dist.shard_valid)
    policy = _default_policy()

    trace = current_trace()
    clock = (_trace_shards(trace, "dmap_blocks", dist)
             if trace is not None else None)

    held = mesh.local_shards()
    if trim:
        # a cluster gathers the inputs with one allgather per column
        # before the dispatch (and its retries) can start
        dev0 = mesh.local_shard_devices()[0]
        gathered = {n: dist.columns[n].gather(dev0)
                    for n in comp.input_names}

    def _dispatch():
        _faults.check("dmap")
        if clock is not None:
            clock.marks.clear()  # a retried attempt times its own shards
        with span("dmap_blocks.dispatch"):
            if trim:
                return [_call(comp, gathered)]
            parts = []
            for j in range(len(held)):
                parts.append(_call(comp, {n: dist.columns[n].shards[j]
                                          for n in comp.input_names}))
                if clock is not None:
                    clock.mark()
            return parts

    parts = policy.call(_dispatch, op="dmap_blocks.dispatch")
    counters.inc("mesh.dispatches")
    if trace is not None:
        _trace_done(trace, "dmap_blocks", clock, mesh)
    rows = {f: sum(int(p[f].shape[0]) for p in parts) for f in names}
    if len(set(rows.values())) > 1:
        raise ValueError(
            f"Distributed map fetches disagree on output row count: "
            f"{rows}")
    n_out = rows[names[0]] if names else dist.padded_rows
    in_rows = _shard_rows(dist)
    if not trim:
        if any(int(p[f].shape[0]) != in_rows[s] for p, s in zip(
                parts, held) for f in names):
            raise ValueError(
                f"Distributed map output changed the row count ({n_out} "
                f"vs {dist.padded_rows}); use trim=True for "
                f"row-count-changing (global) computations")
        n_out = dist.padded_rows  # a cluster process counted its own
    if row_aligned is None:
        row_aligned = n_out == dist.padded_rows
    elif row_aligned and n_out != dist.padded_rows:
        raise ValueError(
            f"row_aligned=True but the output has {n_out} rows and the "
            f"input {dist.padded_rows}")
    cols = {} if trim else {n: dist.columns[n] for n in dist.columns}
    for f in names:
        cols[f] = (_split_global(mesh, parts[0][f]) if trim
                   else _sharded(mesh, [p[f] for p in parts], in_rows))
    num_rows = dist.num_rows if row_aligned else n_out
    # row-aligned outputs keep the input's pad layout; a fresh global
    # result (row_aligned=False) has no pad rows at all
    return DistributedFrame(mesh, out_schema, cols, num_rows,
                            shard_valid=(dist.shard_valid if row_aligned
                                         else None))


# ---------------------------------------------------------------------------
# dfilter
# ---------------------------------------------------------------------------

def dfilter(predicate, dist: DistributedFrame) -> DistributedFrame:
    """Mesh filter: keep the rows where ``predicate`` holds (nonzero).

    Each shard computes its mask, stably compacts its kept rows to its
    front (argsort on the negated mask + gather) and reports its survivor
    count — the padded layout is untouched and the result's validity
    becomes per-shard (``shard_valid``). Host-side ride-along columns
    (strings) replay the same per-shard permutation on the host.

    ``predicate`` follows :func:`tensorframes_tpu_torch.filter_rows`'s
    contract: named args select columns, one rank-1 boolean/integer
    fetch.

    On a LAZY frame the filter RECORDS: its compaction runs inside the
    chain's fused stage and the survivor counts stay on the devices
    (no host readback until the chain forces).
    """
    lz = _lazy_input(dist)
    if lz is not None:
        from ..plan import dist as _dplan
        out = _dplan.record_filter(predicate, lz)
        if out is not None:
            return out
        dist = _dplan.materialize(lz)
    return _dfilter_eager(predicate, dist)


@traced_query("dfilter", _meta_dfilter)
def _dfilter_eager(predicate, dist: DistributedFrame) -> DistributedFrame:
    return _elastic.elastic_call("dfilter", dist,
                                 lambda d: _dfilter(predicate, d))


def _filter_shard(mask_fn, local: Dict[str, torch.Tensor], valid
                  ) -> tuple:
    """One shard's filter, the eager and the native route's: the mask
    ``mask_fn(local)``, kept where it is nonzero on the shard's first
    ``valid`` rows, and the shard's rows stably compacted to the front by
    it (argsort on the negated mask + gather). Returns ``(columns,
    keep)``."""
    m = mask_fn(local)
    rowid = torch.arange(m.shape[0], device=m.device)
    keep = (m != 0) & (rowid < valid)
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    return {n: t.index_select(0, order.to(t.device))
            for n, t in local.items()}, keep


def _dfilter_eager_shards(comp, pname: str, dist: DistributedFrame,
                          tensor_names, counts_in) -> tuple:
    """:func:`_filter_shard` shard by shard (timed while a trace is
    active). Returns the new tensor columns, every shard's survivor count
    (on the host) and the keep masks."""
    mesh = dist.mesh
    S = mesh.num_data_shards
    trace = current_trace()
    clock = (_trace_shards(trace, "dfilter", dist)
             if trace is not None else None)
    new_shards: Dict[str, list] = {n: [] for n in tensor_names}
    counts, keeps = [], []
    held = mesh.local_shards()
    with span("dfilter.dispatch"):
        for j, s in enumerate(held):
            local, keep = _filter_shard(
                lambda t: _call(comp, {n: t[n] for n in comp.input_names}
                                )[pname],
                {n: dist.columns[n].shards[j] for n in tensor_names},
                int(counts_in[s]))
            for n in tensor_names:
                new_shards[n].append(local[n])
            counts.append(keep.sum())
            keeps.append(keep)
            if clock is not None:
                clock.mark()
    if trace is not None:
        _trace_done(trace, "dfilter", clock, mesh)
    counters.inc("mesh.dispatches")
    dev0 = mesh.local_shard_devices()[0]
    counts_host = to_host(torch.stack([c.to(dev0) for c in counts])
                          ).astype(np.int64)
    if mesh.is_cluster:
        # every process's survivor counts, in shard order
        got = allgather_object(mesh.group, counts_host.tolist())
        counts_host = np.zeros(S, np.int64)
        for r, part in enumerate(got):
            owned = [s for s, p in enumerate(mesh.shard_processes())
                     if p == r]
            counts_host[owned] = part
    new_cols: Dict[str, object] = {
        n: dist.columns[n].like(new_shards[n]) for n in tensor_names}
    return new_cols, counts_host, keeps


def _dfilter(predicate, dist: DistributedFrame) -> DistributedFrame:
    schema = dist.schema
    comp = _ops._filter_computation(predicate, schema)
    bad = [n for n in comp.input_names
           if (f := schema.get(n)) is not None and not f.dtype.tensor]
    if bad:
        raise _ops.InvalidTypeError(
            f"dfilter predicate reads host-side (non-tensor) column(s) "
            f"{bad}: string columns ride along on the mesh but cannot "
            f"enter the sharded program. Filter on the host instead "
            f"(tensorframes_tpu_torch.filter_rows / TensorFrame.filter) "
            f"before distribute().")
    pname = comp.output_names[0]
    mesh = dist.mesh
    S = mesh.num_data_shards
    tensor_names = [f.name for f in schema if f.dtype.tensor]
    host_names = [f.name for f in schema if not f.dtype.tensor]
    counts_in = dist.per_shard_valid()

    # TFT_EXECUTOR=pjrt: every shard's mask and compaction as ONE SPMD
    # package in the native core
    outs = None
    nm = _native_mesh(mesh)
    if nm is not None:
        def mask(local):
            return comp.fn({n: local[n] for n in comp.input_names})[pname]

        def build():
            def fn(cnt, *cols):
                done = [_filter_shard(mask, {n: c[p] for n, c in zip(
                    tensor_names, cols)}, cnt[p]) for p in range(S)]
                out = tuple([d[0][n] for d in done] for n in tensor_names)
                out += ([d[1].sum(0, keepdim=True) for d in done],)
                return out + (([d[1] for d in done],) if host_names else ())
            return fn

        outs = nm.run_sharded(
            ("dfilter", pname, tuple(tensor_names), bool(host_names)),
            build, [_shard_counts(dist)] + [dist.columns[n]
                                           for n in tensor_names],
            [_nm.SHARD] + [_nm.ROWS] * len(tensor_names), mesh, owner=comp,
            programs=comp._tft_programs)
    if outs is not None:
        counters.inc("mesh.dispatches")
        rows = _shard_rows(dist)
        new_cols: Dict[str, object] = {
            n: _from_native(mesh, outs[i], rows)
            for i, n in enumerate(tensor_names)}
        counts_host = np.array([int(c[0]) for c in outs[len(tensor_names)]],
                               np.int64)
        keeps = outs[len(tensor_names) + 1] if host_names else []
    else:
        new_cols, counts_host, keeps = _dfilter_eager_shards(
            comp, pname, dist, tensor_names, counts_in)
    # the survivor counts (and, with host ride-alongs, the keep mask)
    # cross to the host between this op and the next
    counters.inc("mesh.interstage_host_bytes", 4 * S)
    from ..plan.nodes import record_selectivity
    record_selectivity(comp, dist.num_rows, int(counts_host.sum()))
    if host_names:
        counters.inc("mesh.interstage_host_bytes", dist.padded_rows)
        bounds = np.concatenate([[0], np.cumsum(
            [int(k.shape[0]) for k in keeps])])
        for n in host_names:
            a = dist.columns[n]
            out_a = np.empty_like(a)
            for s, k in enumerate(keeps):
                sl = slice(bounds[s], bounds[s + 1])
                k = k if isinstance(k, np.ndarray) else to_host(k)
                order = np.argsort(~k, kind="stable")
                out_a[sl] = a[sl][order]
            new_cols[n] = out_a
    return DistributedFrame(mesh, schema, new_cols, int(counts_host.sum()),
                            shard_valid=counts_host)


# ---------------------------------------------------------------------------
# dsort
# ---------------------------------------------------------------------------

def dsort(keys, dist: DistributedFrame, descending: bool = False
          ) -> DistributedFrame:
    """Rows globally sorted by scalar key column(s), on the mesh.

    Multi-shard frames sort by **columnsort** (Leighton's 8 steps): four
    per-shard sorts interleaved with the deal and inverse deal (each
    shard's rows dealt round-robin to every shard and back, the
    ``all_to_all``s of the JAX package, here copies between the shards'
    tensors) and a half-block shift and unshift between neighbour shards.
    No shard ever sorts, or holds, the global array. Stability and pad
    handling ride in the sort key: a flag (real rows 0, frame pad rows 1,
    internal pad rows 2) is the most significant key and the global row
    id the least, and each user key is order-transformed for
    ``descending`` (negation for floats, ``~k`` for ints, which never
    overflows). Correctness needs rows per shard >= 2(S-1)^2 and a
    multiple of 2S, met by padding each shard inside the sort; the final
    slice restores the frame's layout. Single-shard meshes and frames
    whose rows do not tile the data axis sort on the first shard's device
    in one program instead (warned once on a multi-shard mesh).

    Under an active device budget a frame whose tensor columns exceed
    ``TFT_MEM_SORT_FRACTION`` of it takes the external sort
    (``memory.external_sort``) instead, with the same result.

    The result has prefix validity: pad rows are all at the tail whatever
    the input layout. Keys must be device (numeric) columns; sort by a
    string key on the host with ``TensorFrame.order_by``. Host-side
    string columns are permuted on the host by the same order.
    """
    lz = _lazy_input(dist)
    if lz is not None:
        # the pending chain forces fused; the sort consumes its
        # device-resident result
        from ..plan import dist as _dplan
        dist = _dplan.materialize(lz)
    if isinstance(keys, str):
        keys = [keys]
    return _dsort_eager(list(keys), dist, descending)


@traced_query("dsort", _meta_dsort)
def _dsort_eager(keys, dist: DistributedFrame, descending: bool = False
                 ) -> DistributedFrame:
    ext = _dsort_external_if_needed(keys, dist, descending)
    if ext is not None:
        return ext
    return _elastic.elastic_call("dsort", dist,
                                 lambda d: _dsort(keys, d, descending))


def _validate_dsort_keys(schema: Schema, keys) -> None:
    for k in keys:
        f = schema.get(k)
        if f is None:
            raise KeyError(f"No key column {k!r}; columns: {schema.names}")
        if not f.dtype.tensor:
            raise _ops.InvalidTypeError(
                f"dsort key {k!r} is a host-side (string) column; sort on "
                f"the host with order_by, or key on a numeric column")
        if f.block_shape is not None and len(f.block_shape.dims) != 1:
            raise _ops.InvalidShapeError(
                f"dsort key {k!r} must be a scalar column")


def _dsort_external_if_needed(keys, dist: DistributedFrame,
                              descending: bool
                              ) -> Optional[DistributedFrame]:
    """Route a larger-than-budget frame to the external sort: only under
    an active device budget, when the frame's tensor columns exceed
    ``TFT_MEM_SORT_FRACTION`` of it (columnsort would hold the input and
    its exchange copies resident at once)."""
    mgr = _memory.active()
    if mgr is None or not mgr.spill_enabled:
        return None
    threshold = mgr.external_sort_threshold()
    if threshold is None:
        return None
    total = sum(_memory.value_nbytes(dist.columns, f.name)
                for f in dist.schema if f.dtype.tensor)
    if dist.mesh.is_cluster:
        # every process sees the same global size: all refuse together
        total = sum(allgather_object(dist.mesh.group, total))
    if total <= threshold:
        return None
    if dist.mesh.is_cluster:
        raise NotImplementedError(
            "dsort's external sort on a cluster mesh: the frame outgrows "
            "the device budget and the external sort merges on one host; "
            "raise the budget (TFT_MEM_SORT_FRACTION) or sort on a "
            "single-process mesh")
    _validate_dsort_keys(dist.schema, keys)
    return _dsort_external(keys, dist, descending, mgr)


def _dsort_external(keys, dist: DistributedFrame, descending: bool,
                    mgr) -> DistributedFrame:
    """Out-of-core dsort: budget-sized device runs and a host k-way merge
    (``memory.external_sort``), the result equal to the in-memory sort's:
    stable by original row order, pads at the global tail, host
    ride-along columns permuted alongside."""
    mesh = dist.mesh
    schema = dist.schema
    tensor_names = [f.name for f in schema if f.dtype.tensor]
    host_names = [f.name for f in schema if not f.dtype.tensor]
    with span("dsort.external"):
        mask = dist.valid_row_mask()
        valid_idx = np.flatnonzero(mask)
        host_cols = {n: _read_global(dist.columns[n])[mask]
                     for n in tensor_names}
        sorted_cols, order, stats = _memory.external_sort(
            host_cols, keys, descending=descending, manager=mgr,
            device=mesh.shard_devices()[0])
        trace = current_trace()
        if trace is not None:
            trace.add("external_sort", rows=stats["rows"],
                      runs=stats["runs"], bytes=stats["bytes"])
        padded = dist.padded_rows
        n_valid = len(valid_idx)
        rows = _chunk_rows(padded, mesh.num_data_shards)
        new_cols: Dict[str, object] = {}
        for n in tensor_names:
            a = sorted_cols[n]
            if padded != n_valid:
                out = np.zeros((padded,) + a.shape[1:], a.dtype)
                out[:n_valid] = a
                a = out
            mgr.make_room(int(a.nbytes))
            with span("dsort.external_put"):
                new_cols[n] = _place(mesh, a, rows, dist.columns[n].dtype)
        for n in host_names:
            g = np.asarray(dist.columns[n], object)[valid_idx[order]]
            if padded != n_valid:
                g = np.concatenate([g, np.full(padded - n_valid, None,
                                               object)])
            new_cols[n] = g
        new_cols = _memory.spillable_columns(
            f"dsort.external@{id(dist):x}", new_cols, mgr)
        get_logger("dsort").info(
            "dsort took the external-memory path: %d rows (%d B) in %d "
            "run(s), k-way merged on the host", stats["rows"],
            stats["bytes"], stats["runs"])
        return DistributedFrame(mesh, schema, new_cols, dist.num_rows)


def _dsort(keys, dist: DistributedFrame, descending: bool
           ) -> DistributedFrame:
    schema = dist.schema
    _validate_dsort_keys(schema, keys)
    mesh = dist.mesh
    S = mesh.num_data_shards
    tensor_names = [f.name for f in schema if f.dtype.tensor]
    host_names = [f.name for f in schema if not f.dtype.tensor]
    # TFT_EXECUTOR=pjrt: the whole columnsort (the local sorts and the
    # exchanges between the shards) as ONE SPMD package in the native core
    nm = (_native_mesh(mesh) if S > 1 and dist.padded_rows % S == 0
          else None)
    res = (_dsort_columnsort_native(nm, dist, keys, descending,
                                    tensor_names, bool(host_names))
           if nm is not None else None)
    if res is not None:
        counters.inc("mesh.dispatches")
        return _dsort_result(dist, tensor_names, host_names, *res)
    trace = current_trace()
    clock = _trace_shards(trace, "dsort", dist) if trace is not None \
        else None
    t0 = clock.ts if clock is not None else 0.0
    if S > 1 and dist.padded_rows % S == 0:
        if trace is not None:
            # the exchange schedule: the deal and its inverse, the shift
            # and the unshift
            trace.add("collective", name="all_to_all", ts=t0, count=2,
                      op="dsort.columnsort")
            trace.add("collective", name="ppermute", ts=t0, count=2,
                      op="dsort.columnsort")
        with span("dsort.columnsort_dispatch"):
            cols, order = _dsort_columnsort(dist, keys, descending,
                                            tensor_names)
    else:
        if S > 1:
            _warn_dsort_gather(dist, S)
        with span("dsort.dispatch"):
            cols, order = _dsort_local(dist, keys, descending,
                                       tensor_names)
    counters.inc("mesh.dispatches")
    if trace is not None:
        _trace_done(trace, "dsort", clock, mesh)
    return _dsort_result(dist, tensor_names, host_names, cols, order)


def _dsort_result(dist: DistributedFrame, tensor_names, host_names, cols,
                  order) -> DistributedFrame:
    """The sorted frame: the sorted tensor columns, and the host-side
    columns permuted on the host by the global row ids in ``order``."""
    new_cols: Dict[str, object] = dict(zip(tensor_names, cols))
    if host_names:
        order_host = _read_global(order)
        for n in host_names:
            new_cols[n] = dist.columns[n][order_host]
    return DistributedFrame(dist.mesh, dist.schema, new_cols, dist.num_rows)


_dsort_gather_warned = False


def _warn_dsort_gather(dist: DistributedFrame, S: int) -> None:
    """Warn ONCE when a multi-shard frame sorts on one device: its rows
    do not tile the data axis (a trim or global map result), so the key
    columns gather onto the first shard's device, the pathology
    columnsort exists to avoid."""
    global _dsort_gather_warned
    if _dsort_gather_warned:
        return
    get_logger("dsort").warning(
        "dsort on a %d-shard mesh fell back to the global-argsort program "
        "because the frame's %d rows do not tile the data axis: the "
        "columns gather onto one device. Pad or repartition the frame to "
        "a multiple of the shard count to get columnsort (warned once)",
        S, dist.padded_rows)
    _dsort_gather_warned = True


def _key_transform(kv: torch.Tensor, descending: bool) -> torch.Tensor:
    """Order-reversing transforms with no overflow for descending: float
    negation, and bitwise-not for ints (``~k = -k-1`` is strictly
    decreasing and never overflows, where raw negation overflows
    ``iinfo.min``)."""
    if not descending:
        return kv
    return -kv if kv.is_floating_point() else ~kv


def _dsort_local(dist: DistributedFrame, keys, descending: bool,
                 tensor_names) -> tuple:
    """The one-device sort (single-shard meshes, non-tiling frames): the
    shards gather onto the first shard's device, one stable lexicographic
    sort by (invalid, keys..., position) runs there, and the result goes
    back to the shards in the frame's chunks. The validity flag leads, so
    pad rows sink behind every real row, a NaN or an ``iinfo.max`` key
    included. Returns ``(columns, order)``."""
    mesh = dist.mesh
    dev0 = mesh.local_shard_devices()[0]
    valid = _valid_dev(dist).gather(dev0)
    named = {n: dist.columns[n].gather(dev0) for n in tensor_names}
    order = lexsort_order(
        [(~valid).to(torch.int8)]
        + [_key_transform(named[k], descending) for k in keys])
    cols = [_split_global(mesh, named[n].index_select(0, order))
            for n in tensor_names]
    return cols, order


def _dsort_columnsort(dist: DistributedFrame, keys, descending: bool,
                      tensor_names) -> tuple:
    """Columnsort over the data axis (see :func:`dsort`).

    The shards are the matrix's "columns" of ``rp`` rows; the 8 steps:
    1. sort each shard; 2. deal its rows round-robin to the shards (row
    ``i`` of shard ``j`` to shard ``i % S``, at ``j * rp/S + i // S``);
    3. sort; 4. the inverse deal (shard ``j``'s contiguous chunk ``d`` to
    shard ``d``, interleaved by source); 5. sort; 6. shift by half a
    shard: each shard's bottom half moves to the next shard's top (shard
    0's top is a min-sentinel half, flag -16); 7. sort the shifted shards
    (the conceptual extra shard, ``[last shard's bottom, +inf]``, is
    already sorted); 8. unshift: each shard's top is its own shifted
    bottom half, its bottom the next shard's shifted top (the last
    shard's: its own step-5 bottom). The flag (min-sentinel -16 < real 0
    < frame pad 1 < internal pad 2) is the most significant key and the
    global row id the least, so every step's order is total and the
    result stable; internal pad rows sort behind the frame's own pads and
    the first ``padded`` rows are the frame's layout, cut back into shards
    of ``padded / S`` rows at the end. Every move between shards is a
    :func:`~.collectives.route_pieces` exchange, so on a cluster mesh each
    process sorts its own shards and the pieces bound for another
    process's shards cross in one ``all_to_all_single`` per exchange and
    column. Returns ``(columns, order)``, the order as the global row id
    of each output row."""
    mesh = dist.mesh
    devs = mesh.shard_devices()
    S = len(devs)
    held = mesh.local_shards()
    padded = dist.padded_rows
    r = padded // S
    # internal rows per shard: a multiple of 2S, >= 2(S-1)^2 (Leighton's
    # condition), >= r
    need = max(r, 2 * (S - 1) * (S - 1))
    rp = ((need + 2 * S - 1) // (2 * S)) * (2 * S)
    h, q = rp // 2, rp // S
    pad_n = rp - r
    key_idx = [tensor_names.index(k) for k in keys]
    valid = _valid_dev(dist)

    # a shard's state: [flag, rowid, col_0, col_1, ...], rp rows each
    state = {}
    for j, s in enumerate(held):
        dev = devs[s]
        flag = torch.cat([torch.where(valid.shards[j], 0, 1).to(torch.int8),
                          torch.full((pad_n,), 2, dtype=torch.int8,
                                     device=dev)])
        rowid = torch.cat([s * r + torch.arange(r, device=dev),
                           torch.zeros(pad_n, dtype=torch.int64,
                                       device=dev)])
        cols = []
        for n in tensor_names:
            c = dist.columns[n].shards[j]
            cols.append(torch.cat([c, c.new_zeros((pad_n,)
                                                  + tuple(c.shape[1:]))]))
        state[s] = [flag, rowid] + cols
    width = 2 + len(tensor_names)

    def colsort(st):
        order = lexsort_order(
            [st[0]] + [_key_transform(st[2 + i], descending)
                       for i in key_idx] + [st[1]])
        return [t.index_select(0, order) for t in st]

    def exchange(st, cut, sizes, assemble):
        """Move every state tensor: ``cut(src, t)`` gives the pieces of
        shard ``src``'s tensor by destination shard, ``assemble(dst, i,
        pieces)`` the new tensor from the pieces that reached ``dst``, in
        source order."""
        out = {s: [] for s in held}
        for i in range(width):
            pieces = {}
            for s in held:
                for d, piece in cut(s, st[s][i]).items():
                    pieces[(s, d)] = piece
            got = route_pieces(mesh, pieces, sizes, st[held[0]][i])
            for d in held:
                srcs = sorted(a for a, b in sizes if b == d)
                out[d].append(assemble(d, i, [got[(a, d)] for a in srcs]))
        return out

    every = {(a, b): q for a in range(S) for b in range(S)}
    with torch.no_grad():
        state = {s: colsort(st) for s, st in state.items()}          # 1
        state = exchange(                                              # 2
            state, lambda s, t: {d: t[d::S] for d in range(S)}, every,
            lambda d, i, ps: torch.cat(ps))
        state = {s: colsort(st) for s, st in state.items()}          # 3
        state = exchange(                                              # 4
            state, lambda s, t: {d: t[d * q:(d + 1) * q]
                                 for d in range(S)}, every,
            lambda d, i, ps: torch.stack(ps, 1).reshape(
                (rp,) + tuple(ps[0].shape[1:])))
        state = {s: colsort(st) for s, st in state.items()}          # 5

        def top(d, i, ps):                                             # 6
            t = state[d][i]
            if ps:
                prev = ps[0]
            elif i == 0:
                prev = torch.full((rp - h,), -16, dtype=torch.int8,
                                  device=t.device)
            else:
                prev = t.new_zeros((rp - h,) + tuple(t.shape[1:]))
            return torch.cat([prev, t[:h]])

        shifted = exchange(
            state, lambda s, t: {s + 1: t[h:]} if s < S - 1 else {},
            {(a, a + 1): rp - h for a in range(S - 1)}, top)
        shifted = {s: colsort(st) for s, st in shifted.items()}      # 7

        def bottom(d, i, ps):                                          # 8
            tail = ps[0] if ps else state[d][i][h:]
            return torch.cat([shifted[d][i][h:], tail])

        out = exchange(
            shifted, lambda s, t: {s - 1: t[:h]} if s else {},
            {(a + 1, a): h for a in range(S - 1)}, bottom)

        # the first S * r rows, back into shards of r rows
        spans = {}
        for a in range(S):
            for b in range(S):
                lo, hi = max(b * r, a * rp), min((b + 1) * r, (a + 1) * rp)
                if lo < hi:
                    spans[(a, b)] = (lo - a * rp, hi - a * rp)
        out = exchange(
            out, lambda s, t: {b: t[lo:hi] for (a, b), (lo, hi)
                               in spans.items() if a == s},
            {k: hi - lo for k, (lo, hi) in spans.items()},
            lambda d, i, ps: torch.cat(ps) if len(ps) != 1 else ps[0])
        rows = [r] * S
        order = _sharded(mesh, [out[s][1] for s in held], rows)
        cols = [_sharded(mesh, [out[s][2 + j] for s in held], rows)
                for j in range(len(tensor_names))]
    return cols, order


def _take_rows(t: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Each of ``S`` stacked shards' rows (``t``: ``[S, r, ...]``) in
    its ``order`` row (``[S, r]``)."""
    return t.gather(1, order.reshape(order.shape + (1,) * (t.dim() - 2))
                    .expand_as(t))


def _lexsort_stacked(keys) -> torch.Tensor:
    """:func:`~..memory.external_sort.lexsort_order` of every row of
    ``[S, n]`` keys at once: each row's permutation, by the same chain of
    stable sorts and the same float normalization."""
    S, n = keys[0].shape
    order = torch.arange(n, device=keys[0].device).expand(S, n)
    for k in reversed(list(keys)):
        kk = k.gather(1, order)
        if kk.is_floating_point():
            kk = torch.where(kk == 0, 0.0, kk)
            kk = torch.where(torch.isnan(kk), float("nan"), kk)
        order = order.gather(1, torch.sort(kk, dim=1, stable=True).indices)
    return order


def _columnsort_stacked(valid: torch.Tensor, cols, key_idx,
                        descending: bool) -> List[torch.Tensor]:
    """:func:`_dsort_columnsort` with its ``S`` shards stacked on one device:
    ``valid`` is ``[S, r]``, each column ``[S, r, ...]``. The same rows
    per shard, keys and 8 steps, each step on every shard at once (a
    batched sort; the deals and shifts as reshapes of the stacked state).
    Returns ``[rowid, column...]``, each ``[S, r, ...]``; the order is
    total, so the result is the eager route's (the native parity tests
    hold the two equal: change them together).

    The native route's columnsort, where the other routed ops trace the
    eager route's shard functions: traced shard by shard, 8 shards of
    phase 3o's 20M filtered rows built a package in 180.8 s on an H100,
    where the stacked form's took 22.8 s in another run."""
    S, r = valid.shape
    need = max(r, 2 * (S - 1) * (S - 1))
    rp = ((need + 2 * S - 1) // (2 * S)) * (2 * S)
    h, q = rp // 2, rp // S
    pad_n = rp - r
    dev = valid.device
    flag = torch.cat([torch.where(valid, 0, 1).to(torch.int8),
                      torch.full((S, pad_n), 2, dtype=torch.int8,
                                 device=dev)], 1)
    rowid = torch.cat([torch.arange(S, device=dev)[:, None] * r
                       + torch.arange(r, device=dev)[None, :],
                       torch.zeros((S, pad_n), dtype=torch.int64,
                                   device=dev)], 1)
    state = [flag, rowid] + [
        torch.cat([c, c.new_zeros((S, pad_n) + tuple(c.shape[2:]))], 1)
        for c in cols]

    def colsort(st):
        order = _lexsort_stacked(
            [st[0]] + [_key_transform(st[2 + i], descending)
                       for i in key_idx] + [st[1]])
        return [_take_rows(t, order) for t in st]

    def rest(t):
        return tuple(t.shape[2:])

    def deal(t):            # row i of shard j to shard i % S, at j q + i // S
        k = len(rest(t))
        return t.reshape((S, q, S) + rest(t)).permute(
            (2, 0, 1) + tuple(range(3, 3 + k))).reshape((S, rp) + rest(t))

    def undeal(t):          # shard j's chunk d to shard d, by source
        k = len(rest(t))
        return t.reshape((S, S, q) + rest(t)).permute(
            (1, 2, 0) + tuple(range(3, 3 + k))).reshape((S, rp) + rest(t))

    with torch.no_grad():
        state = colsort(state)                                         # 1
        state = colsort([deal(t) for t in state])                      # 2, 3
        state = colsort([undeal(t) for t in state])                    # 4, 5
        shifted = []                                                   # 6
        for i, t in enumerate(state):
            first = (torch.full((1, rp - h), -16, dtype=torch.int8,
                                device=dev) if i == 0
                     else t.new_zeros((1, rp - h) + rest(t)))
            prev = torch.cat([first, t[:-1, h:]])
            shifted.append(torch.cat([prev, t[:, :h]], 1))
        shifted = colsort(shifted)                                     # 7
        out = []                                                       # 8
        for t, s5 in zip(shifted, state):
            tails = torch.cat([t[1:, :h], s5[-1:, h:]])
            out.append(torch.cat([t[:, h:], tails], 1))
        # the first S * r rows, back into shards of r rows
        return [t.reshape((S * rp,) + rest(t))[:S * r].reshape(
            (S, r) + rest(t)) for t in out[1:]]


def _dsort_columnsort_native(nm, dist: DistributedFrame, keys,
                             descending: bool, tensor_names,
                             want_order: bool):
    """The whole columnsort as ONE SPMD package in the native core: the
    shards stacked on the device (:func:`_columnsort_stacked`; the
    program is shaped by the rows per shard: a package per exact shape).
    Returns ``(columns, order)`` as :func:`_dsort_columnsort` does (the
    order only with ``want_order``), or ``None`` when not routable."""
    mesh = dist.mesh
    S = mesh.num_data_shards
    key_idx = [tensor_names.index(k) for k in keys]

    def build():
        def fn(cnt, *cols):
            r = int(cols[0][0].shape[0])
            dev = cnt[0].device
            valid = torch.arange(r, device=dev)[None, :] < torch.cat(
                cnt)[:, None]
            out = _columnsort_stacked(valid, [torch.stack(c) for c in cols],
                                      key_idx, descending)
            res = tuple(list(t.unbind(0)) for t in out[1:])
            return res + ((list(out[0].unbind(0)),) if want_order else ())
        return fn

    outs = nm.run_sharded(
        ("dsort", tuple(tensor_names), tuple(key_idx), descending,
         want_order), build,
        [_shard_counts(dist)] + [dist.columns[n] for n in tensor_names],
        [_nm.SHARD] + [_nm.ROWS] * len(tensor_names), mesh, dynamic=False)
    if outs is None:
        return None
    rows = _shard_rows(dist)
    cols = [_from_native(mesh, o, rows) for o in outs[:len(tensor_names)]]
    order = _from_native(mesh, outs[-1], rows) if want_order else None
    return cols, order


# ---------------------------------------------------------------------------
# dreduce_blocks
# ---------------------------------------------------------------------------

def dreduce_blocks(fetches, dist: DistributedFrame):
    """Mesh-parallel reduce to one row.

    - ``fetches`` is a mapping ``{column: combiner-name}`` (sum/min/max/
      prod): each shard reduces its rows, pad rows masked to the
      combiner's neutral element, and the partials meet in the combiner's
      collective;
    - ``fetches`` is a computation (z/z_input contract): the program
      reduces each shard's rows and once more their stacked partials.

    On a LAZY frame a monoid mapping folds into the chain's fused stage
    as its terminal combiner; a computation forces the chain and runs the
    eager path.
    """
    lz = _lazy_input(dist)
    if lz is not None:
        from ..plan import dist as _dplan
        out = _dplan.record_reduce(fetches, lz)
        if out is not None:
            return out
        dist = _dplan.materialize(lz)
    return _dreduce_blocks_eager(fetches, dist)


@traced_query("dreduce_blocks", _meta_with_fetches)
def _dreduce_blocks_eager(fetches, dist: DistributedFrame):
    if isinstance(fetches, Mapping) and all(
            isinstance(v, str) for v in fetches.values()):
        return _elastic.elastic_call(
            "dreduce_blocks", dist,
            lambda d: _collective_reduce(fetches, d))
    return _elastic.elastic_call(
        "dreduce_blocks", dist, lambda d: _generic_reduce(fetches, d))


def _host_result(v: torch.Tensor, field) -> np.ndarray:
    a = to_host(v)
    return to_storage_dtype(a, field.dtype) if field is not None else a


def _collective_partial(c, s: torch.Tensor, valid, axis: int = 0
                        ) -> Optional[torch.Tensor]:
    """One shard's local reduce with its rows past ``valid`` masked to the
    combiner's neutral element (a shard with no rows gives none). With
    ``axis=1``, ``s`` stacks the shards (``[S, rows, ...]``) and ``valid``
    is their counts as ``[S, 1]`` (a native package's form)."""
    rows = s.shape[axis]
    if rows == 0:
        return None
    keep = torch.arange(rows, device=s.device) < valid
    neutral = torch.tensor(c.neutral(s.dtype), dtype=s.dtype,
                           device=s.device)
    masked = torch.where(
        keep.reshape(tuple(keep.shape) + (1,) * (s.dim() - keep.dim())),
        s, neutral)
    return c.local(masked, axis)


def _collective_reduce(col_combiners: Mapping[str, str],
                       dist: DistributedFrame) -> Dict[str, np.ndarray]:
    if dist.num_rows == 0:
        raise ValueError("reduce on an empty distributed frame")
    combs = {}
    for name, cname in col_combiners.items():
        if name not in dist.schema:
            raise KeyError(f"No column {name!r}")
        if cname not in COMBINERS:
            raise KeyError(
                f"Unknown combiner {cname!r}; known: {sorted(COMBINERS)}")
        combs[name] = COMBINERS[cname]
    names = sorted(col_combiners)

    # TFT_EXECUTOR=pjrt: every shard's masked partial and the shard-order
    # fold as ONE SPMD package in the native core
    nm = _native_mesh(dist.mesh)
    if nm is not None:
        S = dist.mesh.num_data_shards

        def program(cnt, *cols):
            # the shards stacked: every shard's masked partial in one
            # reduction a column, then the fold in shard order
            valid = torch.cat(cnt)[:, None]
            return tuple(combs[name].collective(list(_collective_partial(
                combs[name], torch.stack(c), valid, axis=1).unbind(0)))
                for name, c in zip(names, cols))

        outs = nm.dreduce_collective(
            program, names, dist,
            tuple((name, col_combiners[name]) for name in names))
        if outs is not None:
            counters.inc("mesh.dispatches")
            return {name: to_storage_dtype(o, dist.schema[name].dtype)
                    for name, o in zip(names, outs)}
    valid = dist.per_shard_valid()
    trace = current_trace()
    clock = None
    if trace is not None:
        clock = _trace_shards(trace, "dreduce_blocks", dist)
        for name in names:
            trace.add("collective", name=combs[name].ici, ts=clock.ts,
                      column=name, op="dreduce_blocks")
    result = {}
    mesh = dist.mesh
    home = mesh.local_shard_devices()[0]
    with span("dreduce_blocks.collective_dispatch"):
        # shard by shard (each shard's partials of every column, then the
        # collectives), so a traced dispatch can time each shard
        parts: Dict[str, list] = {name: [] for name in names}
        for j, s in enumerate(mesh.local_shards()):
            for name in names:
                parts[name].append(_collective_partial(
                    combs[name], dist.columns[name].shards[j], valid[s]))
            if clock is not None:
                clock.mark()
        for name in names:
            # a cluster's partials meet on every process in shard order
            every = gather_shard_parts(mesh, parts[name], home)
            out = combs[name].collective([p for p in every
                                          if p is not None])
            result[name] = _host_result(out, dist.schema[name])
    if trace is not None:
        _trace_done(trace, "dreduce_blocks", clock, dist.mesh)
    counters.inc("mesh.dispatches")
    return result


def _generic_reduce(fetches, dist: DistributedFrame) -> Dict[str, np.ndarray]:
    """Generic (arbitrary-computation) mesh reduce: the program reduces
    every shard whose rows are all valid, the boundary shard's valid
    prefix on its own, and then the stacked partials on the first shard's
    device. Frames whose pad rows are not a global suffix (after
    ``dfilter``) fold every valid row into one group through the
    segmented fold instead."""
    schema = dist.schema
    comp = _ops.cached_reduce_computation(fetches, schema, ("_input",),
                                          block_level=True)
    _ops._validate_reduce(comp, schema, ("_input",), rank_delta=1)
    fetch_names = comp.output_names
    mesh = dist.mesh
    S = mesh.num_data_shards
    n = dist.num_rows
    if n == 0:
        raise ValueError("reduce on an empty distributed frame")
    names = sorted(fetch_names)
    arrays = {f: dist.columns[f] for f in names}
    if dist.shard_valid is not None or dist.padded_rows % S \
            or mesh.is_cluster:
        ids_host = np.where(dist.valid_row_mask(), 0, -1).astype(np.int32)
        ids = _place(mesh, ids_host, _shard_rows(dist), torch.int32)
        final_t = _segmented_fold(comp, names, mesh, arrays, ids, 1)
        return {f: _host_result(final_t[f][0], schema.get(f))
                for f in fetch_names}
    rows_per = dist.padded_rows // S
    full = n // rows_per          # shards whose rows are all valid
    tail = n - full * rows_per    # valid rows in the boundary shard

    # TFT_EXECUTOR=pjrt: the per-shard partials, the ragged tail's and the
    # final stacked combine as ONE SPMD package in the native core (shaped
    # by the rows: a package per exact shape)
    nm = _native_mesh(mesh)
    if nm is not None:
        def build():
            def fn(*cols):
                final = _generic_partials_fold(comp.fn, names, cols, full,
                                               tail)
                return tuple(final[f] for f in names)
            return fn

        outs = nm.run_sharded(
            ("dreduce_generic", n, tuple(names)), build,
            [arrays[f] for f in names], [_nm.ROWS] * len(names), mesh,
            owner=comp, dynamic=False, programs=comp._tft_programs)
        if outs is not None:
            counters.inc("mesh.dispatches")
            got = dict(zip(names, outs))
            return {f: (to_storage_dtype(got[f], schema[f].dtype)
                        if schema.get(f) is not None else got[f])
                    for f in fetch_names}
    trace = current_trace()
    clock = (_trace_shards(trace, "dreduce_blocks", dist)
             if trace is not None else None)
    with span("dreduce_blocks.generic_dispatch"):
        final = _generic_partials_fold(
            lambda inputs: _call(comp, inputs), names,
            [arrays[f].shards for f in names], full, tail,
            clock.mark if clock is not None else None)
    counters.inc("mesh.dispatches")
    if trace is not None:
        _trace_done(trace, "dreduce_blocks", clock, mesh)
    return {f: _host_result(final[f], schema.get(f)) for f in fetch_names}


def _generic_partials_fold(call, names, cols, full: int, tail: int,
                           mark=None) -> Dict[str, torch.Tensor]:
    """The generic reduce's program, the eager and the native route's:
    ``call`` (the computation) reduces each of the first ``full`` shards
    of ``cols`` (a list of shards a fetch), the boundary shard's first
    ``tail`` rows, and then their stacked partials on the first shard's
    device. ``mark()`` follows each full shard."""
    dev0 = cols[0][0].device
    parts = []
    for s in range(full):
        parts.append(call({f + "_input": c[s] for f, c in zip(names, cols)}))
        if mark is not None:
            mark()
    if tail:
        parts.append(call({f + "_input": c[full][:tail]
                           for f, c in zip(names, cols)}))
    return call({f + "_input": torch.stack([p[f].to(dev0) for p in parts])
                 for f in names})


# ---------------------------------------------------------------------------
# daggregate: group ids
# ---------------------------------------------------------------------------

_GROUP_IDS_CACHE_CAP = 8


def _group_ids_cache_get(dist: DistributedFrame, ckey: tuple):
    hit = dist._group_ids_cache.get(ckey)
    if hit is not None:
        dist._group_ids_cache.move_to_end(ckey)
    return hit


def _group_ids_cache_put(dist: DistributedFrame, ckey: tuple, hit: tuple):
    dist._group_ids_cache[ckey] = hit
    while len(dist._group_ids_cache) > _GROUP_IDS_CACHE_CAP:
        dist._group_ids_cache.popitem(last=False)


def _cached_group_ids(dist: DistributedFrame, keys, max_groups):
    """Memoized key factorization (see ``DistributedFrame._group_ids_cache``).

    Returns ``(ids, uniques, key_table, count_dev, num_groups)`` —
    ``uniques`` is None on the device path, ``key_table``/``count_dev``
    are None on the host path.
    """
    if max_groups is not None:
        ckey = ("device", tuple(keys), max_groups)
        hit = _group_ids_cache_get(dist, ckey)
        if hit is None:
            with span("daggregate.device_key_ids"):
                hit = _device_key_ids(dist, keys, max_groups)
            _group_ids_cache_put(dist, ckey, hit)
        ids, key_table, count_dev, num_groups = hit
        return ids, None, key_table, count_dev, num_groups
    ckey = ("host", tuple(keys))
    hit = _group_ids_cache_get(dist, ckey)
    if hit is None:
        hit = _host_group_ids(dist, keys)
        _group_ids_cache_put(dist, ckey, hit)
    ids, uniques, num_groups = hit
    return ids, uniques, None, None, num_groups


def _monoid_group_plan(dist: DistributedFrame, keys):
    """Host-key group ids + the hot-key salt plan for a monoid
    aggregation. Returns ``(ids, uniques, num_groups, salt_plan)``;
    salting is cached per (frame, keys, threshold) like the ids."""
    ids, uniques, _, _, num_groups = _cached_group_ids(dist, keys, None)
    salt_plan = None
    # a cluster mesh never salts: the salt plan reads every row's id
    if dist.mesh.num_data_shards > 1 and not dist.mesh.is_cluster:
        frac = _elastic.salt_fraction()
        if frac is not None:
            skey = ("salt", tuple(keys), frac)
            cached = _group_ids_cache_get(dist, skey)
            if cached is None:
                plan = _elastic.plan_key_salt(
                    dist, ids.numpy(), num_groups,
                    dist.mesh.num_data_shards)
                if plan is not None:
                    plan = (_place(dist.mesh, plan[0], _shard_rows(dist),
                                   torch.int32),) + tuple(plan[1:])
                cached = (plan,)
                _group_ids_cache_put(dist, skey, cached)
            salt_plan = cached[0]
    return ids, uniques, num_groups, salt_plan


def _host_group_ids(dist: DistributedFrame, keys):
    """Key columns → dense group ids on the mesh (host factorization).

    Only the scalar KEY columns visit the host; ids come back sharded with
    pad rows marked ``-1`` (dropped by every consumer). Returns
    ``(ids, uniques, num_groups)``.
    """
    if dist.mesh.is_cluster:
        return _cluster_group_ids(dist, keys)
    schema = dist.schema
    mask = dist.valid_row_mask()
    key_host = []
    for k in keys:
        fld = schema[k]
        a = dist.host_read_padded(k)
        a = a[mask] if dist.shard_valid is not None else a[: dist.num_rows]
        if a.ndim != 1:
            raise _ops.InvalidTypeError(
                f"Key column {k!r} must be scalar-typed")
        if fld.dtype.tensor:
            a = to_storage_dtype(a, fld.dtype)
        key_host.append(a)
    with span("aggregate.factorize_keys"):
        fact = _ops._factorize_keys(key_host)
    ids_padded = np.full(dist.padded_rows, -1, np.int32)  # -1: pad, dropped
    if dist.shard_valid is not None:
        ids_padded[mask] = fact.ids
    else:
        ids_padded[: dist.num_rows] = fact.ids
    ids = _place(dist.mesh, ids_padded, _shard_rows(dist), torch.int32)
    return ids, fact.uniques, fact.num_groups


def _cluster_group_ids(dist: DistributedFrame, keys):
    """:func:`_host_group_ids` across the processes of a cluster mesh:
    each process factorizes the keys of its own valid rows, the processes'
    small unique-key tables meet in one allgather, every process
    factorizes their concatenation (in process order) into the same
    global table, and maps its own ids into it. Returns ``(ids, uniques,
    num_groups)``, the same on every process."""
    mesh = dist.mesh
    schema = dist.schema
    rows = _shard_rows(dist)
    counts = dist.per_shard_valid()
    held = mesh.local_shards()
    key_local = []
    for k in keys:
        col = dist.columns[k]
        if len(col.shards[0].shape) != 1:
            raise _ops.InvalidTypeError(
                f"Key column {k!r} must be scalar-typed")
        a = np.concatenate([to_host(col.shards[j][:int(counts[s])])
                            for j, s in enumerate(held)])
        key_local.append(to_storage_dtype(a, schema[k].dtype))
    with span("aggregate.factorize_keys"):
        if len(key_local[0]):
            fact = _ops._factorize_keys(key_local)
            local_ids, uniques = fact.ids, fact.uniques
        else:
            local_ids = np.empty(0, np.int64)
            uniques = [a[:0] for a in key_local]
        tables = allgather_object(mesh.group, uniques)
        glob = _ops._factorize_keys(
            [np.concatenate([t[i] for t in tables])
             for i in range(len(keys))])
        off = sum(len(t[0]) for t in tables[:mesh.group.rank])
        remap = glob.ids[off:off + len(uniques[0])]
    ids_local = remap[local_ids].astype(np.int32)
    out, lo = [], 0
    devs = mesh.shard_devices()
    for s in held:
        n = int(counts[s])
        piece = np.full(rows[s], -1, np.int32)  # -1: pad, dropped
        piece[:n] = ids_local[lo:lo + n]
        lo += n
        out.append(to_device(piece, torch.int32, devs[s]))
    return _sharded(mesh, out, rows), glob.uniques, glob.num_groups


def _valid_dev(dist: DistributedFrame) -> ShardedArray:
    """The valid-row mask, made on each shard's device: a shard's valid
    rows are its first ``per_shard_valid()`` rows (a prefix frame's and a
    ``dfilter`` result's alike), so no mask crosses from the host."""
    counts = dist.per_shard_valid()
    rows = _shard_rows(dist)
    devs = dist.mesh.shard_devices()
    return _sharded(dist.mesh, [torch.arange(rows[s], device=devs[s])
                                < int(counts[s])
                                for s in dist.mesh.local_shards()], rows)


def _device_group_ids(dist: DistributedFrame, key: str, max_groups: int,
                      valid=None):
    """Dense group ids computed ON THE DEVICES for one integer key column:
    a sort-unique (``torch.unique`` with a static size cap) builds the
    group table and a ``searchsorted`` maps rows to ids; the key column
    never visits the host. Returns the raw ``(ids, uniques, count,
    sentinel_hit)`` of :func:`_build_device_ids` — ids are ``-1`` for pad
    rows; cap overflow and the sentinel flag are the CALLER's to read
    back and raise on."""
    kcol = dist.columns[key]
    dtype = kcol.dtype if isinstance(kcol, ShardedArray) else None
    if dtype is None or dtype.is_floating_point or dtype == torch.bool \
            or dtype.is_complex:
        shown = (str(dtype).replace("torch.", "") if dtype is not None
                 else "a host-side (string) column")
        raise _ops.InvalidTypeError(
            f"device-side aggregation needs an integer key column; {key!r} "
            f"is {shown} (use the host path)")
    if valid is None:
        valid = _valid_dev(dist)
    return _build_device_ids(kcol, valid, max_groups)


def _sentinel_check(sentinel_hit, key: str) -> None:
    if bool(sentinel_hit):
        raise _ops.InvalidTypeError(
            f"key column {key!r} contains the dtype's max value, which the "
            f"device path reserves as its pad sentinel; use the host path "
            f"(max_groups=None) for such keys")


def _build_device_ids(kc: ShardedArray, vm: ShardedArray, max_groups: int):
    """Sort-unique group table + per-row dense ids. Each shard's masked
    keys are uniqued where they lie; the shards' uniques meet on the first
    shard's device, where one more unique makes the sorted table of
    ``max_groups + 1`` slots (the sentinel, the key dtype's max, fills the
    rest); every shard then ``searchsorted``s its keys into it."""
    sentinel = torch.iinfo(kc.dtype).max
    dev0 = kc.shards[0].device
    masked = [torch.where(v, k, sentinel) for k, v in zip(kc.shards,
                                                          vm.shards)]
    sentinel_hit = torch.stack([(v & (k == sentinel)).any().to(dev0)
                                for k, v in zip(kc.shards, vm.shards)]).any()
    uniq_all = torch.unique(torch.cat([torch.unique(m).to(dev0)
                                       for m in masked]))
    if kc.cluster is not None:
        # the processes' sorted uniques (and sentinel flags) meet in one
        # allgather each; one more unique makes the same table everywhere
        group = kc.cluster.group
        uniq_all = torch.unique(torch.cat(allgather_var(group, uniq_all)))
        sentinel_hit = torch.stack(allgather_var(
            group, sentinel_hit.reshape(1))).any()
    uniq = torch.full((max_groups + 1,), sentinel, dtype=kc.dtype,
                      device=dev0)
    take = min(max_groups + 1, int(uniq_all.shape[0]))
    uniq[:take] = uniq_all[:take]
    count = (uniq != sentinel).sum()
    ids = []
    for m, v in zip(masked, vm.shards):
        pos = torch.searchsorted(uniq.to(m.device), m).to(torch.int32)
        ids.append(torch.where(v, pos, -1))
    return kc.like(ids), uniq, count, sentinel_hit


def _combine_ids(acc: ShardedArray, ids_k: ShardedArray,
                 radix: int) -> ShardedArray:
    """Mixed-radix combination of dense per-key ids (int32 throughout, as
    the JAX package keeps it)."""
    return acc.like([a * radix + b for a, b in zip(acc.shards,
                                                   ids_k.shards)])


def _device_key_ids(dist: DistributedFrame, keys, max_groups: int):
    """Shared entry to the device-keys path (monoid + generic daggregate).

    One key: sort-unique + searchsorted on the mesh (the key never visits
    the host). Composite keys: each key column factorizes to dense ids the
    same way, the ids combine into one mixed-radix int32 id space
    (``radix = max_groups + 1`` per position), and one more sort-unique
    over the combined ids yields the dense group table. ``(cap+1)^k`` must
    stay below 2^31 (checked loudly; the host path has no cap).

    Returns ``(ids, key_table, count_dev, table_groups)`` where
    ``key_table`` carries what :func:`_device_key_columns` needs to
    rebuild the key columns and ``table_groups`` is the static table size
    (cap + sentinel slot)."""
    if len(keys) == 1:
        ids, uniq, count, sent = _device_group_ids(dist, keys[0],
                                                   max_groups)
        _sentinel_check(sent, keys[0])
        return ids, ("single", uniq), count, max_groups + 1

    radix = max_groups + 1
    if radix ** len(keys) >= 2 ** 31 - 1:
        raise ValueError(
            f"max_groups={max_groups} with {len(keys)} key columns "
            f"overflows the int32 combined-id space ((cap+1)^k must stay "
            f"below 2^31); lower the cap or use the host path "
            f"(max_groups=None)")
    # one valid-mask upload serves every per-key program and the combine
    valid = _valid_dev(dist)
    per = [_device_group_ids(dist, k, max_groups, valid=valid)
           for k in keys]
    combined = None
    for ids_k, _, _, _ in per:
        combined = (ids_k if combined is None
                    else _combine_ids(combined, ids_k, radix))
    ids, uniq_c, count, _ = _build_device_ids(combined, valid, max_groups)
    for k, (_, _, count_k, sent_k) in zip(keys, per):
        _sentinel_check(sent_k, k)
        if int(count_k) > max_groups:
            # a truncated per-key table would silently merge distinct
            # keys before the final overflow check could see them
            raise ValueError(
                f"more than max_groups={max_groups} distinct values in "
                f"key column {k!r}; raise max_groups (the static table "
                f"cap)")
    per_uniq = [u for _, u, _, _ in per]
    return ids, ("multi", uniq_c, per_uniq, radix), count, max_groups + 1


def _device_key_columns(dist: DistributedFrame, keys, key_table,
                        count_dev, max_groups: int):
    """Overflow check + host materialization of the device group table(s).
    Returns ``({key name: values}, num_groups)``."""
    count = int(count_dev)
    if count > max_groups:
        raise ValueError(
            f"more than max_groups={max_groups} distinct keys in "
            f"{keys}; raise max_groups (the static table cap)")

    def cast(vals, key):
        return to_storage_dtype(vals, dist.schema[key].dtype)

    if key_table[0] == "single":
        return {keys[0]: cast(to_host(key_table[1])[:count], keys[0])}, count
    _, uniq_c, per_uniq, radix = key_table
    comb = to_host(uniq_c)[:count].astype(np.int64)
    digits = []
    for _ in keys:                       # least-significant digit first
        digits.append(comb % radix)
        comb = comb // radix
    return {k: cast(to_host(per_uniq[i])[digits[len(keys) - 1 - i]], k)
            for i, k in enumerate(keys)}, count


# ---------------------------------------------------------------------------
# daggregate
# ---------------------------------------------------------------------------

def daggregate(fetches, dist: DistributedFrame, keys,
               max_groups: Optional[int] = None) -> TensorFrame:
    """Mesh-distributed keyed aggregation.

    Instead of moving rows between devices by key, each shard reduces its
    LOCAL rows into a dense ``[groups, ...]`` table and the tables are
    combined across the data axis. Only the scalar KEY columns visit the
    host (to build dense group ids); the values never leave their shards.

    - ``fetches`` is a mapping ``{column: combiner-name}`` (sum/min/max/
      prod): one segment reduce per shard and column (float sums through
      the ``segment_sum`` kernel on a card) + the combiner's collective;
    - ``fetches`` is a computation (block-level ``<col>_input`` reduce):
      per shard, a sort by group id and a segmented scan whose pair
      combiner IS the user computation on two-row blocks, segment tails
      scattered into a ``[groups, ...]`` table, then a fold of the shards'
      tables with the same combiner, masked by presence. Combine order is
      unspecified (the computation must tolerate arbitrary regrouping).

    ``keys``: key column name or list of names. Returns a host
    :class:`TensorFrame` of one row per group (keys + fetches, fetches
    sorted by name), groups in key order.

    ``max_groups``: DEVICE-side group ids for integer key(s): the key
    columns never visit the host. The value caps the static group table;
    exceeding it raises. Composite keys combine per-key dense ids in a
    mixed-radix int32 space, which bounds the cap at ``(cap+1)^k < 2^31``.

    Skew: on the monoid host-key path, a key group holding more than
    ``TFT_HOT_KEY_FRACTION`` of the rows is **salted** across the data
    shards (``elastic.py``); per-salt partials fold back on the host, so
    results keep the same groups and order (float sums may reassociate).
    """
    if isinstance(keys, str):
        keys = [keys]
    keys = list(keys)
    if not keys:
        raise ValueError("daggregate needs at least one key column")
    lz = _lazy_input(dist)
    if lz is not None:
        # a monoid host-key aggregation over a filter-free chain whose keys
        # pass through untouched FOLDS into the fused stage as its terminal
        # combiner; anything else forces the chain (still fused among
        # itself) and runs the eager op on the device-resident result
        from ..plan import dist as _dplan
        out = _dplan.record_aggregate(fetches, lz, keys, max_groups)
        if out is not None:
            return out
        dist = _dplan.materialize(lz)
    return _daggregate_eager(fetches, dist, keys, max_groups)


@traced_query("daggregate", _meta_daggregate)
def _daggregate_eager(fetches, dist: DistributedFrame, keys,
                      max_groups: Optional[int] = None) -> TensorFrame:
    return _elastic.elastic_call(
        "daggregate", dist,
        lambda d: _daggregate(fetches, d, keys, max_groups))


def _shuffle_route(num_groups: int, mesh: DeviceMesh) -> bool:
    """The high-cardinality auto-route: more than
    ``TFT_SHUFFLE_AGG_GROUPS`` groups (default 131072) on more than one
    shard, with the shuffle on (``TFT_SHUFFLE``)."""
    from .exchange import shuffle_agg_groups_threshold, shuffle_enabled
    thr = shuffle_agg_groups_threshold()
    # a cluster mesh keeps the dense tables (the exchange is single-process)
    return (thr is not None and shuffle_enabled() and not mesh.is_cluster
            and num_groups > thr and mesh.num_data_shards > 1)


def _shard_table(cname: str, v: torch.Tensor, ids: torch.Tensor,
                 groups: int) -> torch.Tensor:
    """One shard's ``[groups, ...]`` table: ``segment_sum`` for a sum (rows
    whose id is outside ``[0, groups)`` dropped), else a segment min/max/
    prod with those rows masked to the combiner's neutral element."""
    ids = ids.to(v.device)
    if cname != "sum":
        valid = (ids >= 0) & (ids < groups)
        neutral = torch.tensor(COMBINERS[cname].neutral(v.dtype),
                               dtype=v.dtype, device=v.device)
        v = torch.where(valid.reshape((-1,) + (1,) * (v.dim() - 1)),
                        v, neutral)
        ids = torch.where(valid, ids, 0)
    return _ops._segment_reduce(cname, v, ids, groups)


def _shard_tables(fetch_names, col_combiners, columns, ids: ShardedArray,
                  groups: int, clock=None) -> Dict[str, List[torch.Tensor]]:
    """Every shard's ``[groups, ...]`` table of every fetch column
    (:func:`_shard_table`: B1 for a float sum), shard by shard so a traced
    dispatch can time each shard, all under the span
    ``daggregate.keyed_sum``. The one fragment of the eager, fused and
    streaming aggregate routes."""
    parts: Dict[str, List[torch.Tensor]] = {f: [] for f in fetch_names}
    cols = {f: columns[f] for f in fetch_names}
    with span("daggregate.keyed_sum"):
        for s, i in enumerate(ids.shards):
            for f in fetch_names:
                parts[f].append(_shard_table(col_combiners[f],
                                             cols[f].shards[s], i, groups))
            if clock is not None:
                clock.mark()
    return parts


def _monoid_agg_result(schema: Schema, keys, fetch_names, tables,
                       key_cols, num_out: int) -> TensorFrame:
    """Host assembly of a monoid aggregation's result frame (key
    columns + sliced/cast fetch tables)."""
    cols = dict(key_cols)
    for f, t in zip(fetch_names, tables):
        cols[f] = to_storage_dtype(np.asarray(t)[:num_out], schema[f].dtype)
    out_fields = [schema[k] for k in keys] + [
        Field(f, schema[f].dtype,
              block_shape=(schema[f].block_shape.with_lead(Unknown)
                           if schema[f].block_shape is not None else None),
              sql_rank=schema[f].sql_rank)
        for f in fetch_names]
    return TensorFrame.from_blocks([Block(cols, num_out)],
                                   Schema(out_fields))


def _daggregate(fetches, dist: DistributedFrame, keys,
                max_groups: Optional[int]) -> TensorFrame:
    schema = dist.schema
    for k in keys:
        if k not in schema:
            raise KeyError(f"No key column {k!r}; columns: {schema.names}")
    if not _ops._monoid_mapping(fetches):
        return _generic_daggregate(fetches, dist, keys,
                                   max_groups=max_groups)
    if any(_ops._is_sketch(v) for v in fetches.values()):
        return _daggregate_sketch(fetches, dist, keys, max_groups)
    col_combiners = fetches
    mesh = dist.mesh
    value_names = [n for n in schema.names if n not in keys]
    _ops._validate_monoid_fetches(col_combiners, value_names,
                                  "before distribute()")
    if dist.num_rows == 0:
        raise ValueError("aggregate on an empty distributed frame")

    device_keys = max_groups is not None
    if device_keys:
        ids, uniques, key_table, count_dev, num_groups = \
            _cached_group_ids(dist, keys, max_groups)
        salt_plan = None
    else:
        ids, uniques, num_groups, salt_plan = _monoid_group_plan(dist, keys)
        # high-cardinality keys: the dense per-shard tables below hold
        # EVERY group on EVERY shard; past TFT_SHUFFLE_AGG_GROUPS the rows
        # hash-repartition instead, so each shard aggregates only its own
        # key range (O(groups / shards) state; parallel/exchange.py)
        if _shuffle_route(num_groups, mesh):
            from .exchange import _shuffle_daggregate_impl
            counters.inc("mesh.shuffle_agg_routes")
            return _shuffle_daggregate_impl(fetches, dist, keys)
    if salt_plan is not None:
        prog_ids, prog_groups = salt_plan[0], salt_plan[1]
    else:
        prog_ids, prog_groups = ids, num_groups

    fetch_names = sorted(col_combiners)
    # TFT_EXECUTOR=pjrt: every shard's segment reduce (B1 for a float sum,
    # launched from inside the package) and the shard-order fold as ONE
    # SPMD package in the native core. A salted aggregate stays eager: its
    # host-side fold below is the salting's second half
    tables = None
    nm = None if salt_plan is not None else _native_mesh(mesh)
    if nm is not None:
        S = mesh.num_data_shards

        def build():
            def fn(ids, *rest):
                groups = rest[-1].shape[0]
                return tuple(COMBINERS[col_combiners[f]].collective(
                    [_shard_table(col_combiners[f], c[p], ids[p], groups)
                     for p in range(S)])
                    for f, c in zip(fetch_names, rest[:-1]))
            return fn

        tables = nm.run_sharded(
            ("daggregate", tuple((f, col_combiners[f])
                                 for f in fetch_names)), build,
            [prog_ids] + [dist.columns[f] for f in fetch_names]
            + [prog_groups],
            [_nm.ROWS] * (1 + len(fetch_names)) + [_nm.SIZE], mesh)
        if tables is not None:
            counters.inc("mesh.dispatches")
    if tables is None:
        trace = current_trace()
        clock = None
        if trace is not None:
            clock = _trace_shards(trace, "daggregate", dist)
            for f in fetch_names:
                trace.add("collective",
                          name=COMBINERS[col_combiners[f]].ici,
                          ts=clock.ts, column=f, op="daggregate")
        home = mesh.local_shard_devices()[0]
        with span("daggregate.dispatch"):
            parts = _shard_tables(fetch_names, col_combiners, dist.columns,
                                  prog_ids, prog_groups, clock)
            # a cluster's tables meet on every process in shard order
            tables = [to_host(COMBINERS[col_combiners[f]].collective(
                gather_shard_parts(mesh, parts[f], home)))
                for f in fetch_names]
        if trace is not None:
            _trace_done(trace, "daggregate", clock, mesh)
        counters.inc("mesh.dispatches")

    if salt_plan is not None:
        tables = [_elastic.fold_salted(t, salt_plan[2], col_combiners[f])
                  for f, t in zip(fetch_names, tables)]
    if device_keys:
        key_cols, num_out = _device_key_columns(dist, keys, key_table,
                                                count_dev, max_groups)
    else:
        key_cols = {k: u for k, u in zip(keys, uniques)}
        num_out = num_groups
    out = _monoid_agg_result(schema, keys, fetch_names, tables,
                             key_cols, num_out)
    if salt_plan is not None:
        attach_hot_keys(out, keys, uniques, salt_plan)
    return out


def attach_hot_keys(frame: TensorFrame, keys, uniques, salt_plan) -> None:
    """Record the hot-key OBSERVATIONS that triggered salting on the
    result frame (``frame.hot_keys()`` and an ``explain()`` line)."""
    hot, K = salt_plan[2]
    fracs = salt_plan[3] if len(salt_plan) > 3 else None
    records = []
    for j, g in enumerate(hot):
        kv = {}
        for k, u in zip(keys, uniques):
            v = u[int(g)]
            kv[k] = v.item() if hasattr(v, "item") else v
        records.append({
            "keys": kv,
            "fraction": (float(fracs[j]) if fracs is not None else None),
            "salt_slots": int(K),
        })
    frame._hot_keys = records


def _daggregate_sketch(fetches, dist: DistributedFrame, keys,
                       max_groups: Optional[int]) -> TensorFrame:
    """The sketch half of a mesh aggregation.

    Sketch combiners hash and bucket on the host in float64 (the
    determinism contract that makes ``aggregate``, ``daggregate`` and the
    stream agree bit for bit), so their partials fold from the host copies
    of the value columns, on the first shard's device from
    ``relational.sketch.DEVICE_FOLD_ROWS`` rows. Scalar combiners in the
    same mapping keep the shards' segment reduce and collective (B1 for a
    float sum); both halves share ONE cached group factorization, so
    their group order is identical by construction."""
    schema = dist.schema
    if max_groups is not None:
        raise ValueError(
            "max_groups= (device-side group ids) does not compose with "
            "sketch combiners — sketches hash on the host; drop "
            "max_groups or the sketch fetches")
    value_names = [n for n in schema.names if n not in keys]
    _ops._validate_monoid_fetches(fetches, value_names,
                                  "before distribute()", schema=schema)
    if dist.num_rows == 0:
        raise ValueError("aggregate on an empty distributed frame")
    scalars = {f: c for f, c in fetches.items() if not _ops._is_sketch(c)}
    sketches = {f: c for f, c in fetches.items() if _ops._is_sketch(c)}

    ids_dev, uniques, num_groups, salt_plan = _monoid_group_plan(dist, keys)
    # the scalar half sees only its own columns; the group order is the
    # same by construction (same key data, same host factorization)
    scalar_out = (_daggregate(
        scalars, dist.select(list(keys) + sorted(scalars)), keys, None)
        if scalars else None)

    ids_host = ids_dev.numpy()
    ids = ids_host[ids_host >= 0].astype(np.int64)
    mask = dist.valid_row_mask()
    dev0 = dist.mesh.local_shard_devices()[0]
    sketch_cols: Dict[str, np.ndarray] = {}
    with span("daggregate.sketch_fold"):
        for f in sorted(sketches):
            sk = sketches[f]
            a = _read_global(dist.columns[f])
            vals = a[mask] if dist.shard_valid is not None \
                else a[: dist.num_rows]
            if schema[f].dtype.tensor:
                vals = to_storage_dtype(vals, schema[f].dtype)
            table = sk.block_partial(np.asarray(vals), ids, num_groups,
                                     device=dev0)
            counters.inc("relational.sketch_folds")
            sketch_cols.update(sk.finalize(f, table))

    # keys + sorted fetch columns (a sketch's outputs inline after its
    # fetch name)
    out_fields = [schema[k] for k in keys]
    cols: Dict[str, object] = {}
    if scalar_out is not None:
        sb = Block.concat(scalar_out.blocks(), scalar_out.schema)
        for k in keys:
            cols[k] = sb.columns[k]
    else:
        for k, u in zip(keys, uniques):
            cols[k] = np.asarray(u)
    for f in sorted(fetches):
        if f in sketches:
            for fld in sketches[f].out_fields(f, schema[f]):
                out_fields.append(fld)
                cols[fld.name] = sketch_cols[fld.name]
        else:
            out_fields.append(scalar_out.schema[f])
            cols[f] = sb.columns[f]
    out = TensorFrame.from_blocks([Block(cols, num_groups)],
                                  Schema(out_fields))
    if salt_plan is not None:
        attach_hot_keys(out, keys, uniques, salt_plan)
    return out


def _segmented_fold(comp, names, mesh: DeviceMesh, arrays, ids: ShardedArray,
                    G: int) -> Dict[str, torch.Tensor]:
    """Per-group fold of an arbitrary reduce computation on the mesh.

    ``ids``: sharded dense group ids (int32, ``-1`` for pad rows). Per
    shard: stable sort by id, a segmented scan whose operator applies
    ``comp`` to a stacked two-row block when both elements share an id
    (``engine/ops.py``'s fold pieces), segment tails scattered into a
    ``[G, ...]`` table + presence mask; the shards' tables are folded
    pairwise with the same combiner on the first shard's device, and
    ``comp`` is applied once more over each group's one-row block
    (at-least-once parity with the host ``CompactionBuffer.evaluate``).
    Returns ``{fetch: [G, ...cell]}`` on the first shard's device. A
    program ``torch.func.vmap`` cannot batch raises
    :class:`~..engine.ops.FoldBatchingError`.
    """
    pair_v, single_v, op = _ops._fold_functions(comp, names)

    # TFT_EXECUTOR=pjrt: every shard's sort, segmented scan and scatter and
    # the fold of their tables as ONE SPMD package in the native core
    # (shaped by the rows: a package per exact shape)
    nm = _native_mesh(mesh)
    if nm is not None:
        S = mesh.num_data_shards

        def build():
            def fn(ids_p, *cols):
                # every shard's rows in ONE segmented scan (all lie on one
                # device): shard p's group g is p * G + g, so no segment
                # spans two shards, and the scan's depth is that of the
                # frame, not shards times that of a shard
                dev0 = ids_p[0].device
                gid = torch.cat([torch.where((i < 0) | (i >= G), S * G,
                                             p * G + i)
                                 for p, i in enumerate(ids_p)])
                table, pres = _fold_shard(
                    op, gid, {f: torch.cat(c) for f, c in zip(names, cols)},
                    S * G, dev0)
                out = _fold_tables(
                    pair_v, single_v, comp, names,
                    [{f: t.reshape((S, G) + tuple(t.shape[1:]))[p]
                      for f, t in table.items()} for p in range(S)],
                    list(pres.reshape(S, G)))
                return tuple(out[f] for f in names)
            return fn

        outs = nm.run_sharded(
            ("dagg_generic", G, tuple(names)), build,
            [ids] + [arrays[f] for f in names],
            [_nm.ROWS] * (1 + len(names)), mesh, owner=comp, dynamic=False,
            programs=comp._tft_programs)
        if outs is not None:
            counters.inc("mesh.dispatches")
            return {f: torch.from_numpy(o) for f, o in zip(names, outs)}
    dev0 = mesh.local_shard_devices()[0]
    tabs, present = [], []
    trace = current_trace()
    clock = (_trace_shards(trace, "daggregate", mesh=mesh)
             if trace is not None else None)
    with span("daggregate.segmented_fold_dispatch"), torch.no_grad():
        for s, ids_local in enumerate(ids.shards):
            table, p = _fold_shard(op, ids_local, {f: arrays[f].shards[s]
                                                   for f in names}, G, dev0)
            tabs.append(table)
            present.append(p)
            if clock is not None:
                clock.mark()
        if mesh.is_cluster:
            # every shard's table on every process, in shard order
            every = {f: gather_shard_parts(mesh, [t[f] for t in tabs], dev0)
                     for f in names}
            tabs = [{f: every[f][s] for f in names}
                    for s in range(mesh.num_data_shards)]
            present = gather_shard_parts(mesh, present, dev0)
        out = _fold_tables(pair_v, single_v, comp, names, tabs, present)
    counters.inc("mesh.dispatches")
    if trace is not None:
        _trace_done(trace, "daggregate", clock, mesh)
    return {f: out[f] for f in names}


def _fold_shard(op, ids_local: torch.Tensor, vals: Dict[str, torch.Tensor],
                G: int, dev0) -> tuple:
    """One shard's groups folded, the eager and the native route's: a
    stable sort by id (pad rows, -1, sort to the end as group ``G``), the
    segmented scan of ``op`` and each group's tail row scattered into a
    ``[G, ...]`` table (every other row into slot ``G``, dropped), with the
    groups' presence. Returns ``(table, present)`` on ``dev0``."""
    dev = ids_local.device
    sort_ids = torch.where((ids_local < 0) | (ids_local >= G), G,
                           ids_local).long()
    order = torch.argsort(sort_ids, stable=True)
    sid = sort_ids[order]
    _, scanned = _ops._segmented_scan(
        op, sid, {f: v[order.to(v.device)] for f, v in vals.items()})
    tail = torch.ones_like(sid, dtype=torch.bool)
    tail[:-1] = sid[1:] != sid[:-1]
    target = torch.where(tail, sid, G)
    table = {}
    for f in vals:
        z = torch.zeros((G + 1,) + tuple(scanned[f].shape[1:]),
                        dtype=scanned[f].dtype, device=dev)
        z.index_put_((target,), scanned[f])
        table[f] = z[:G].to(dev0)
    p = torch.zeros((G + 1,), dtype=torch.bool, device=dev)
    p.index_put_((target,), torch.ones_like(target, dtype=torch.bool))
    return table, p[:G].to(dev0)


def _fold_tables(pair_v, single_v, comp, names, tabs, present
                 ) -> Dict[str, torch.Tensor]:
    """The shards' tables folded pairwise in shard order with the
    combiner, masked by presence, then ``comp`` once more over each
    group's one-row block (at-least-once parity with the host
    ``CompactionBuffer.evaluate``)."""
    acc, acc_p = tabs[0], present[0]
    for s in range(1, len(tabs)):
        comb = _ops._fold_call(pair_v, comp, acc, tabs[s])
        both = acc_p & present[s]
        nxt = {}
        for f in names:
            shape = (-1,) + (1,) * (acc[f].dim() - 1)
            nxt[f] = torch.where(both.reshape(shape), comb[f],
                                 torch.where(present[s].reshape(shape),
                                             tabs[s][f], acc[f]))
        acc, acc_p = nxt, acc_p | present[s]
    return _ops._fold_call(single_v, comp, acc)


def _generic_daggregate(fetches, dist: DistributedFrame, keys,
                        max_groups: Optional[int] = None) -> TensorFrame:
    """Arbitrary-computation keyed aggregation on the mesh: the segmented
    fold of every shard's groups and a fold of the shards' tables
    (:func:`_segmented_fold`), group ids from the host or, with
    ``max_groups``, from the devices."""
    schema = dist.schema
    mesh = dist.mesh
    if dist.num_rows == 0:
        raise ValueError("aggregate on an empty distributed frame")
    value_schema = schema.select([m for m in schema.names if m not in keys])
    comp = _ops.cached_reduce_computation(fetches, value_schema,
                                          ("_input",), block_level=True)
    _ops._validate_reduce(comp, value_schema, ("_input",), rank_delta=1)
    names = sorted(comp.output_names)
    ids, uniques, key_table, count_dev, table_groups = _cached_group_ids(
        dist, keys, max_groups)
    final = _segmented_fold(comp, names, mesh,
                            {f: dist.columns[f] for f in names},
                            ids, table_groups)
    if max_groups is not None:
        cols, num_groups = _device_key_columns(dist, keys, key_table,
                                               count_dev, max_groups)
    else:
        num_groups = table_groups
        cols = {k: u for k, u in zip(keys, uniques)}
    for f in names:
        cols[f] = to_storage_dtype(to_host(final[f])[:num_groups],
                                   schema[f].dtype)
    out_fields = [schema[k] for k in keys] + [
        Field(s.name, s.dtype, block_shape=s.shape.prepend(Unknown),
              sql_rank=s.shape.ndim)
        for s in comp.outputs]
    return TensorFrame.from_blocks([Block(cols, num_groups)],
                                   Schema(out_fields))
