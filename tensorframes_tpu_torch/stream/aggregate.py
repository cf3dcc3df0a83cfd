"""Incremental keyed aggregation: windows, watermarks, bounded state.

The port's counterpart of ``tensorframes_tpu/stream/aggregate.py``: the
streaming twin of ``aggregate``'s monoid path
(``engine.ops._monoid_aggregate``). Fetches are a ``{column:
combiner}`` mapping over the associative monoids (sum / min / max /
prod) and the sketch combiners of ``relational``, so a batch folds into
running state exactly (combine order is free).

Per batch, the value columns go to the device once (host numpy after
the batch's forcing: a ``Block`` holds host columns), then per live
window present in the batch:

1. the window's rows' keys factorize to dense ids on the host
   (``engine.ops._factorize_keys``, the finite aggregate's);
2. each fetch column reduces in ONE device dispatch through
   ``engine.ops._segment_reduce``: float sums through the CUDA
   ``segment_sum`` kernel on a GPU (the port of the Pallas kernel the
   JAX package dispatches here), integer sums and min/max/prod through
   torch's scatter ops;
3. the batch partial merges into the window's **device-resident state
   table** through a cached merge (a fill with the combiner's neutral,
   ``index_copy_`` of the old table, then ``index_add_`` or
   ``scatter_reduce_`` of the partial into the key-union table). Merges
   are cached by signature (``stream.merge_compiles`` counts the distinct
   ones), so steady-state batches build nothing new.

**Windows and watermarks**: rows go to tumbling or sliding windows by an
event-time column (window arithmetic in f64 whatever the column's type);
the watermark trails the largest event time seen by ``watermark_delay``.
A window whose end falls at or below the watermark EMITS (one frame:
window start, keys in lexicographic order, aggregates) and its state is
dropped. Rows for an already-closed window are **late**: counted
(``stream.late_rows``) and dropped. ``max_state_rows`` caps the DEVICE
state rows: under an active memory budget (``memory``) the oldest window
SPILLS to pinned host memory (``stream.state_spills``), stays live and
faults back on its next touch (``stream.state_faults``); without a budget
it force-emits early (``stream.state_evictions``). Under a budget every
window's state is also an entry of the ledger's LRU, so pressure from
anywhere in the process can spill it.

Without a window the aggregation runs in **update mode**: one state
table, and each batch emits the updated rows of the keys it touched.

``mesh=`` with more than one data shard folds each batch on the mesh
(``plan.dist.mesh_segment_partial``): the batch's rows shard over the data
axis, each shard reduces its rows by group (``segment_sum``, B1, for a
float sum) and one collective yields the partial tables the window state
merges: one ``mesh.dispatches`` per fold, counted in
``stream.mesh_folds``. Float sums may reassociate across shards, as in any
``daggregate``; integer folds stay exact. A 1-shard mesh (or None) keeps
the single-device fold.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, \
    Tuple

import numpy as np
import torch

from .. import dtypes as _dt
from ..engine.executor import (default_executor, to_device, to_host,
                               to_storage_dtype)
from ..engine.ops import (InvalidTypeError, _factorize_keys, _field_spec,
                          _identity, _is_sketch, _segment_reduce,
                          _validate_monoid_fetches)
from ..frame import Block, TensorFrame
from ..memory import spill as _spill
from ..observability import events as _obs
from ..schema import Field, Schema
from ..shape import Shape, Unknown
from ..utils.logging import get_logger
from ..utils.tracing import counters, span

__all__ = ["Window", "tumbling", "sliding", "StreamingAggregation",
           "WINDOW_COL"]

_log = get_logger("stream.aggregate")

# the window-start column prepended to every windowed emission
WINDOW_COL = "window_start"


class Window(NamedTuple):
    """An event-time window: ``size`` units long, a new one every
    ``slide``. ``slide == size`` is tumbling; ``slide < size`` is sliding
    (each row lands in ``ceil(size / slide)`` windows). Window starts are
    multiples of ``slide``; a row at time t belongs to the windows with
    ``start <= t < start + size``."""

    size: float
    slide: float


def tumbling(size: float) -> Window:
    """Non-overlapping windows of ``size`` event-time units."""
    if size <= 0:
        raise ValueError(f"window size must be > 0, got {size}")
    return Window(float(size), float(size))


def sliding(size: float, slide: float) -> Window:
    """Overlapping windows: ``size`` long, a new one every ``slide``."""
    if size <= 0 or slide <= 0:
        raise ValueError(
            f"window size/slide must be > 0, got {size}/{slide}")
    if slide > size:
        raise ValueError(
            f"slide {slide} > size {size} would drop rows between "
            f"windows; use tumbling({slide}) or shrink the slide")
    return Window(float(size), float(slide))


class _WState:
    """One window's live state: host key table + device value tables.

    ``values`` maps each fetch to a tensor on the device, or to a host
    numpy table for a sketch that merges on the host (top-k). A SPILLED
    state holds each tensor as its spilled form instead (pinned host
    bytes, the device and dtype: ``memory.spill.spill_value``),
    bit-identical on the way back and costing zero device bytes.

    The state is also a duck-typed entry of the memory ledger's LRU (the
    ``mem_*`` protocol of ``memory/manager.py``): under a budget the
    ledger can spill it, not only the stream's own ``max_state_rows``
    cap. It registers at commit, held weakly: an emitted window's entry
    dies with it.
    """

    __slots__ = ("keys_u", "values", "rows", "spilled", "on_spill",
                 "on_fault", "_spill_lock", "__weakref__")

    def __init__(self, keys_u: List[np.ndarray], values: Dict[str, object],
                 rows: int):
        self.keys_u = keys_u        # per key column: sorted unique values
        self.values = values        # fetch -> device tensor [rows, ...]
        self.rows = rows
        self.spilled = False
        # per-stream spill/fault accounting hooks (set at registration)
        self.on_spill: Optional[Callable[[int], None]] = None
        self.on_fault: Optional[Callable[[int], None]] = None
        # the ledger LRU (its own lock) and the max_state_rows path (the
        # aggregation's state lock) can both pick this state: a per-state
        # lock and a re-check keep one spill from counting or copying
        # twice
        self._spill_lock = threading.Lock()

    def spill(self) -> int:
        """Move the device tables to pinned host memory; returns the
        device bytes freed (0 when a concurrent spill won the race)."""
        with self._spill_lock:
            if self.spilled:
                return 0
            freed = 0
            for f, v in list(self.values.items()):
                if _spill.is_device_value(v):
                    freed += _spill.array_nbytes(v)
                    self.values[f] = _spill.spill_value(v)
            self.spilled = True
        return freed

    def snapshot(self) -> Tuple[Dict[str, object], bool, int]:
        """``(tables, was_spilled, host_bytes)``: the tables as they are
        now, spilled ones restored to their devices as new tensors (the
        state itself is left as it is). Taken under the spill lock, so a
        concurrent ledger spill never hands the fold half-spilled
        tables."""
        with self._spill_lock:
            values = dict(self.values)
            was_spilled = self.spilled
        host = sum(int(v[0].nbytes) for v in values.values()
                   if isinstance(v, tuple))
        return ({f: (_spill.restore_value(v) if isinstance(v, tuple)
                     else v) for f, v in values.items()},
                was_spilled, host)

    # -- memory-ledger entry protocol --------------------------------------
    def mem_name(self) -> str:
        return "stream-window"

    def mem_is_spilled(self) -> bool:
        return self.spilled

    def mem_device_bytes(self) -> int:
        if self.spilled:
            return 0
        return sum(_spill.array_nbytes(v) for v in self.values.values()
                   if _spill.is_device_value(v))

    def mem_host_bytes(self) -> int:
        if not self.spilled:
            return 0
        return sum(int(v[0].nbytes) for v in self.values.values()
                   if isinstance(v, tuple))

    def mem_spill(self) -> int:
        """Ledger-driven spill (under the ledger lock); the ``on_spill``
        hook counts it for the stream."""
        freed = self.spill()
        if freed:
            cb = self.on_spill
            if cb is not None:
                cb(freed)
        return freed

    def mem_fault(self) -> int:
        """Restore the tables to their devices. The fold restores a
        spilled base on its own, so this runs only when the ledger touches
        the entry."""
        with self._spill_lock:
            if not self.spilled:
                return 0
            restored = 0
            for f, v in list(self.values.items()):
                if isinstance(v, tuple):
                    self.values[f] = _spill.restore_value(v)
                    restored += int(v[0].nbytes)
            self.spilled = False
        if restored:
            cb = self.on_fault
            if cb is not None:
                cb(restored)
        return restored

    @property
    def nbytes(self) -> int:
        n = sum(int(np.asarray(k).nbytes) for k in self.keys_u)
        for v in self.values.values():
            n += (int(v[0].nbytes) if isinstance(v, tuple)
                  else _spill.array_nbytes(v))
        return n


# cached merges: (combiner, M, G, H, tail, dtype) -> merge function,
# LRU-capped; every touch under the lock
_merge_cache: "OrderedDict[Tuple, Callable]" = OrderedDict()
_merge_lock = threading.Lock()
_MERGE_CACHE_CAP = 128

_SCATTER = {"min": "amin", "max": "amax", "prod": "prod"}


def _merge_program(cname: str, m: int, g: int, h: int,
                   tail: Tuple[int, ...], dtype: torch.dtype) -> Callable:
    """The cached scatter-merge: old state [g, ...] + batch partial
    [h, ...] -> union table [m, ...]. Every union position receives the
    old value (copied) and/or the partial (combined against the monoid's
    neutral), so overlapping, old-only and new-only keys are all exact.
    Cached by signature, as the JAX package caches its jitted merge, so
    ``stream.merge_compiles`` counts the distinct signatures."""
    key = (cname, m, g, h, tail, str(dtype))
    with _merge_lock:
        fn = _merge_cache.get(key)
        if fn is not None:
            _merge_cache.move_to_end(key)
            return fn
    neutral = _identity(cname, dtype) if cname != "sum" else 0

    def merge(old: torch.Tensor, idx_old: torch.Tensor, new: torch.Tensor,
              idx_new: torch.Tensor) -> torch.Tensor:
        out = torch.full((m,) + tail, neutral, dtype=old.dtype,
                         device=old.device)
        out.index_copy_(0, idx_old, old)
        if cname == "sum":
            # idx_new holds distinct positions (one per key of the
            # partial), so each output row takes exactly one addition:
            # the result does not depend on the order of the card's
            # atomics
            return out.index_add_(0, idx_new, new)
        idx = idx_new.reshape((-1,) + (1,) * len(tail)).expand_as(new)
        return out.scatter_reduce_(0, idx, new, reduce=_SCATTER[cname],
                                   include_self=True)

    with _merge_lock:
        fn = _merge_cache.setdefault(key, merge)
        _merge_cache.move_to_end(key)
        if len(_merge_cache) > _MERGE_CACHE_CAP:
            _merge_cache.popitem(last=False)
    counters.inc("stream.merge_compiles")
    return fn


class StreamingAggregation:
    """The terminal operator a :class:`~.frame.GroupedStream` builds (see
    the module docstring). Drive it with :meth:`start`: a
    :class:`~.runtime.StreamHandle` whose per-batch outputs are the
    emitted window frames."""

    def __init__(self, upstream, keys: List[str],
                 col_combiners: Mapping[str, object],
                 window: Optional[Window] = None,
                 time_col: Optional[str] = None,
                 watermark_delay: float = 0.0,
                 max_state_rows: Optional[int] = None,
                 mesh=None):
        if not (isinstance(col_combiners, Mapping) and col_combiners
                and all(isinstance(v, str) or _is_sketch(v)
                        for v in col_combiners.values())):
            raise TypeError(
                "streaming aggregate fetches must be a non-empty "
                "{column: combiner} mapping (the monoid form — "
                "sum/min/max/prod names or relational sketch "
                "combiners; arbitrary reduce computations cannot fold "
                "incrementally)")
        schema = upstream.schema
        self.upstream = upstream
        self.keys = list(keys)
        self.window = window
        self.time_col = time_col
        self.watermark_delay = float(watermark_delay)
        self.max_state_rows = max_state_rows
        # mesh=: per-batch folds ride the mesh (module docstring); a 1-shard
        # mesh (or None) keeps the single-device fold, and so does a
        # cluster mesh: the batch's rows are this process's, not the
        # global rows its shards would stand for
        self.mesh = mesh if (mesh is not None
                             and mesh.num_data_shards > 1
                             and not mesh.is_cluster) else None
        if watermark_delay < 0:
            raise ValueError(
                f"watermark_delay must be >= 0, got {watermark_delay}")
        if window is not None:
            if time_col is None:
                raise ValueError(
                    "windowed aggregation needs time_col= (the event-"
                    "time column windows and the watermark read)")
            f = schema.get(time_col)
            if f is None:
                raise KeyError(f"No time column {time_col!r}; columns: "
                               f"{schema.names}")
            if f.sql_rank != 0 or not f.dtype.tensor or \
                    np.dtype(f.dtype.np_storage).kind not in "iuf":
                raise InvalidTypeError(
                    f"time_col {time_col!r} must be a numeric scalar "
                    f"column, got {f.type_string()}")
            if WINDOW_COL in schema:
                raise ValueError(
                    f"column {WINDOW_COL!r} already exists; windowed "
                    f"emission needs that name for the window-start "
                    f"column")
        else:
            if time_col is not None:
                raise ValueError("time_col= only applies with window=")
            if max_state_rows is not None:
                raise ValueError(
                    "max_state_rows bounds WINDOW state; update-mode "
                    "(window=None) state is the live key cardinality — "
                    "cap the key universe upstream instead")
        if max_state_rows is not None and max_state_rows < 1:
            raise ValueError(
                f"max_state_rows must be >= 1, got {max_state_rows}")
        value_names = [n for n in schema.names
                       if n not in self.keys and n != time_col]
        _validate_monoid_fetches(col_combiners, value_names,
                                 "upstream with select()", schema=schema)
        self.col_combiners = dict(col_combiners)
        self.fetch_names = sorted(col_combiners)
        # sketch combiners: an elementwise sketch's state (HLL registers:
        # max; quantile bucket counts: sum) folds through the same merge
        # on the device; a host-merged one (top-k) keeps host tables
        self.sketches = {f: c for f, c in self.col_combiners.items()
                         if _is_sketch(c)}
        fields: List[Field] = []
        if window is not None:
            # window starts are f64 whatever the time column's storage
            fields.append(Field(WINDOW_COL, _dt.double,
                                block_shape=Shape(Unknown), sql_rank=0))
        fields += [schema[k] for k in self.keys]
        for f in self.fetch_names:
            sk = self.sketches.get(f)
            if sk is not None:
                fields.extend(sk.out_fields(f, schema[f]))
            else:
                fields.append(Field(
                    f, schema[f].dtype,
                    block_shape=_field_spec(schema[f], True,
                                            "stream aggregate")
                    .with_lead(Unknown),
                    sql_rank=schema[f].sql_rank))
        self.out_schema = Schema(fields)
        # -- live state ----------------------------------------------------
        # _windows is read by metrics scrapes on other threads while the
        # pump folds batches: every structural change (commit, emit pop)
        # and every snapshot happens under this lock
        self._state_lock = threading.Lock()
        self._windows: Dict[Optional[float], _WState] = {}
        self._max_ts = -np.inf
        # windows with start <= this are closed (emitted or force-
        # evicted); rows mapping into them are late
        self._closed_through = -np.inf
        # emitted frames not returned yet: _emit appends the moment a
        # window is popped, ingest/finalize drain it as their return
        # value, so a failure AFTER some windows of a batch emitted can
        # never lose them. Pump thread only.
        self._emitted_backlog: List[TensorFrame] = []
        # per-instance twins of the global counters
        self.late_rows = 0
        self.windows_emitted = 0
        self.state_evictions = 0
        self.state_spills = 0
        self.state_faults = 0

    # -- introspection (the runtime's metrics read these) -----------------
    @property
    def schema(self) -> Schema:
        return self.out_schema

    @property
    def state_rows(self) -> int:
        with self._state_lock:
            return sum(w.rows for w in self._windows.values())

    @property
    def state_bytes(self) -> int:
        with self._state_lock:
            return sum(w.nbytes for w in self._windows.values())

    @property
    def live_windows(self) -> int:
        with self._state_lock:
            return len(self._windows)

    @property
    def watermark(self) -> Optional[float]:
        if self.window is None or self._max_ts == -np.inf:
            return None
        return self._max_ts - self.watermark_delay

    # -- ingestion ---------------------------------------------------------
    def ingest(self, df: TensorFrame) -> List[TensorFrame]:
        """Fold one batch into state; returns the frames this batch
        caused to emit (closed windows, or the update-mode delta).

        ALL-OR-NOTHING: the batch folds into fresh staging state
        (:meth:`_fold` never changes a live ``_WState``) and commits in
        one locked update at the end, so an exception anywhere mid-fold
        leaves the live state exactly as it was: the runtime skips the
        WHOLE batch, and a retried batch can never count twice (the
        runtime's retry wraps only the forcing; ingest runs once after
        it).
        """
        blocks = df.blocks()
        merged = blocks[0] if len(blocks) == 1 \
            else Block.concat(blocks, df.schema)
        if merged.num_rows == 0:
            return []
        for k in self.keys:
            if merged.is_ragged(k) or merged.dense(k).ndim != 1:
                raise InvalidTypeError(
                    f"Key column {k!r} must be scalar-typed")
        device = default_executor().resolve()
        key_arrays = [merged.dense(k) for k in self.keys]
        vals = self._batch_values(merged, device)
        if self.window is None:
            state, touched = self._fold(self._windows.get(None),
                                        key_arrays, vals, device)
            with self._state_lock:
                self._windows[None] = state
            self._register_state(state)
            return [self._update_frame(touched)]
        ts = np.asarray(merged.dense(self.time_col), np.float64)
        if ts.ndim != 1:
            raise InvalidTypeError(
                f"time_col {self.time_col!r} must be scalar per row")
        new_max = max(self._max_ts, float(ts.max()))
        size, slide = self.window.size, self.window.slide
        n_off = int(np.ceil(size / slide))
        # f64 event-time arithmetic: an int64 time column is exact below
        # 2^53
        q = np.floor(ts / slide)
        late = 0
        pending: Dict[Optional[float], _WState] = {}
        with span("stream.aggregate.ingest"):
            for i in range(n_off):
                starts = (q - i) * slide
                valid = ts < starts + size
                if not valid.any():
                    continue
                for s in np.unique(starts[valid]):
                    m = valid & (starts == s)
                    if s <= self._closed_through:
                        late += int(m.sum())
                        continue
                    s = float(s)
                    # a sliding batch can hit one window from two offsets
                    # (disjoint row subsets): chain through the staging
                    base = pending.get(s, self._windows.get(s))
                    pending[s], _ = self._fold(
                        base, [a[m] for a in key_arrays],
                        self._rows_of(vals, m, device), device)
        # commit point: live state changes only once the WHOLE batch
        # folded cleanly
        with self._state_lock:
            self._windows.update(pending)
        for st in pending.values():
            self._register_state(st)
        self._max_ts = new_max
        if late:
            self.late_rows += late
            counters.inc("stream.late_rows", late)
            _obs.add_event("late_rows", rows=late,
                           watermark=self.watermark)
        self._emit_ready()
        self._evict_over_cap()
        return self._drain_backlog()

    def finalize(self) -> List[TensorFrame]:
        """Flush every live window (the source is drained), in window
        order; update mode emits one full-table snapshot."""
        if self.window is None:
            with self._state_lock:
                state = self._windows.get(None)
            if state is None:
                return []
            return [self._update_frame(np.arange(state.rows))]
        with self._state_lock:
            remaining = sorted(k for k in self._windows)
        for s in remaining:
            self._emit(s)
            self._closed_through = max(self._closed_through, s)
        return self._drain_backlog()

    # -- internals ---------------------------------------------------------
    def _batch_values(self, merged: Block, device) -> Dict[str, object]:
        """The batch's fetch columns: scalar-combiner columns go to the
        device ONCE per batch, in their device dtypes (windows then take
        their rows there); sketch columns stay host numpy (their partials
        hash and bucket on the host)."""
        schema = self.upstream.schema
        out: Dict[str, object] = {}
        for f in self.fetch_names:
            v = merged.dense(f)
            if f in self.sketches:
                out[f] = v
            else:
                out[f] = to_device(v, _dt.device_dtype(schema[f].dtype),
                                   device)
        return out

    @staticmethod
    def _rows_of(vals: Dict[str, object], m: np.ndarray,
                 device) -> Dict[str, object]:
        """One window's rows of the batch values (``m`` a host mask):
        tensors are gathered on the device, with no copy when every row
        belongs to the window."""
        if m.all():
            return vals
        idx = None
        out: Dict[str, object] = {}
        for f, v in vals.items():
            if isinstance(v, torch.Tensor):
                if idx is None:
                    idx = torch.from_numpy(np.flatnonzero(m)).to(device)
                out[f] = v.index_select(0, idx)
            else:
                out[f] = v[m]
        return out

    def _register_state(self, state: _WState) -> None:
        """Join the memory ledger's LRU under a budget: the ledger, not
        only ``max_state_rows``, then drives this window's spills.
        Registered outside ``_state_lock`` (the ledger takes its own lock
        and may spill at once)."""
        from .. import memory as _memory
        mgr = _memory.active()
        if mgr is not None and mgr.spill_enabled:
            state.on_spill = self._note_ledger_spill
            state.on_fault = self._note_ledger_fault
            mgr.register(state)

    def _note_ledger_spill(self, freed: int) -> None:
        self.state_spills += 1
        counters.inc("stream.state_spills")
        _log.debug("memory ledger spilled a stream window (%d B) to "
                   "host; it stays live and faults back on its next "
                   "touch", freed)

    def _note_ledger_fault(self, restored: int) -> None:
        self.state_faults += 1
        counters.inc("stream.state_faults")

    def _fold(self, base: Optional[_WState],
              key_arrays: List[np.ndarray], vals: Dict[str, object],
              device) -> Tuple[_WState, np.ndarray]:
        """Fold one window's batch rows against ``base`` (possibly None),
        returning a FRESH ``_WState`` and the union-table positions the
        batch touched (update mode reads them). Pure with respect to
        ``base``: the merges write new tensors, which is what makes
        :meth:`ingest` transactional."""
        fact = _factorize_keys(key_arrays)
        scalar_names = [f for f in self.fetch_names
                        if f not in self.sketches]
        parts: Dict[str, object] = {}
        if self.mesh is not None and scalar_names:
            # the distributed-plan path: one mesh dispatch per batch (rows
            # shard over the data axis, B1 on each shard for a float sum,
            # the partial tables combine with one collective)
            from ..plan import dist as _dplan
            mesh_parts = _dplan.mesh_segment_partial(
                self.mesh,
                {f: self.col_combiners[f] for f in scalar_names},
                fact.ids.astype(np.int32), {f: vals[f] for f in
                                            scalar_names},
                fact.num_groups)
            parts = {f: mesh_parts[f].to(device) for f in scalar_names}
        elif scalar_names:
            # int32 ids where they fit, as the finite aggregate passes
            # them: 4 bytes a row less for the kernel to read
            id_dt = np.int32 if fact.num_groups < 2 ** 31 else np.int64
            ids = torch.from_numpy(fact.ids.astype(id_dt)).to(device)
            with span("stream.aggregate.segment_reduce"):
                for f in scalar_names:
                    parts[f] = _segment_reduce(
                        self.col_combiners[f], vals[f], ids,
                        fact.num_groups)
        if self.sketches:
            # sketch partials hash and bucket on the host (the cross-path
            # determinism contract) and fold on the device from
            # relational.sketch.DEVICE_FOLD_ROWS rows; elementwise states
            # join the device tables, host-merged ones (top-k) stay numpy
            with span("stream.aggregate.sketch_fold"):
                for f, sk in self.sketches.items():
                    part = sk.block_partial(np.asarray(vals[f]), fact.ids,
                                            fact.num_groups, device=device)
                    counters.inc("relational.sketch_folds")
                    parts[f] = (torch.from_numpy(part).to(device)
                                if sk.elementwise is not None else part)
        if base is None:
            return _WState([np.asarray(u) for u in fact.uniques], parts,
                           fact.num_groups), np.arange(fact.num_groups)
        old_values, was_spilled, host_bytes = base.snapshot()
        if was_spilled:
            # fault-back: the fold restores the spilled tables to the
            # device itself (the result state is resident again), counted
            # once here; ``base`` stays as it is until the commit
            from .. import memory as _memory
            self.state_faults += 1
            counters.inc("stream.state_faults")
            mgr = _memory.active()
            if mgr is not None:
                mgr.note_fault(host_bytes, name="stream-window")
        g, h = base.rows, fact.num_groups
        cat = [np.concatenate([o, n])
               for o, n in zip(base.keys_u, fact.uniques)]
        gf = _factorize_keys(cat)
        m = gf.num_groups
        idx_np = gf.ids.astype(np.int64)
        idx_old = idx_np[:g]
        idx_new = idx_np[g:]
        values: Dict[str, object] = {}
        with span("stream.aggregate.merge"):
            dev_idx = None
            for f in self.fetch_names:
                old = old_values[f]
                sk = self.sketches.get(f)
                if sk is not None and sk.elementwise is None:
                    # host-merged sketch state (top-k): the union-table
                    # fold runs in numpy, never on the device
                    values[f] = sk.merge_tables(
                        np.asarray(old), idx_old, np.asarray(parts[f]),
                        idx_new, m)
                    continue
                if dev_idx is None:
                    dev_idx = torch.from_numpy(idx_np).to(old.device)
                cname = (sk.elementwise if sk is not None
                         else self.col_combiners[f])
                fn = _merge_program(cname, m, g, h, tuple(old.shape[1:]),
                                    old.dtype)
                values[f] = fn(old, dev_idx[:g], parts[f], dev_idx[g:])
        return _WState([np.asarray(u) for u in gf.uniques], values,
                       m), idx_new

    def _drain_backlog(self) -> List[TensorFrame]:
        out, self._emitted_backlog = self._emitted_backlog, []
        return out

    def _emit_ready(self) -> None:
        wm = self.watermark
        if wm is None:
            return
        size = self.window.size
        with self._state_lock:
            ready = sorted(k for k in self._windows if k + size <= wm)
        for s in ready:
            self._emit(s)
        self._closed_through = max(self._closed_through, wm - size)

    def _evict_over_cap(self) -> None:
        """Bound the live DEVICE state to ``max_state_rows``.

        Under an active memory budget the oldest window SPILLS to pinned
        host memory instead of force-emitting: it stays live (rows keep
        folding into it after a fault-back at the next touch) and only
        stops costing device bytes (``stream.state_spills``). Without a
        budget the oldest window force-emits early
        (``stream.state_evictions``)."""
        if self.max_state_rows is None:
            return
        from .. import memory as _memory
        mgr = _memory.active()
        spill_ok = mgr is not None and mgr.spill_enabled
        while True:
            with self._state_lock:
                live = [(k, w) for k, w in self._windows.items()
                        if not w.spilled]
                total = sum(w.rows for _, w in live)
                if total <= self.max_state_rows or not live:
                    return
                oldest = min(k for k, _ in live)
                state = self._windows[oldest]
                rows = state.rows
                if spill_ok:
                    freed = state.spill()
            if spill_ok:
                if freed:  # a concurrent ledger spill may have won
                    self.state_spills += 1
                    counters.inc("stream.state_spills")
                    mgr.note_spill(freed, name=f"stream-window@{oldest}")
                    _log.debug(
                        "stream state over max_state_rows=%d; spilled "
                        "window %s (%d rows, %d B) to host — it stays "
                        "live and faults back on the next touch",
                        self.max_state_rows, oldest, rows, freed)
                continue
            self.state_evictions += 1
            counters.inc("stream.state_evictions")
            _obs.add_event("state_eviction", window=oldest, rows=rows)
            _log.warning(
                "stream state over max_state_rows=%d; force-emitting "
                "window %s early (%d rows) — widen the cap or shrink "
                "the watermark delay if this is not intended",
                self.max_state_rows, oldest, rows)
            self._emit(oldest)
            self._closed_through = max(self._closed_through, oldest)

    def _values_to_host(self, state: _WState,
                        sel: Optional[np.ndarray] = None
                        ) -> Dict[str, np.ndarray]:
        schema = self.upstream.schema
        cols = {}
        for f in self.fetch_names:
            v = state.values[f]
            if isinstance(v, tuple):        # spilled
                v = _spill._host_values(v)
            elif isinstance(v, torch.Tensor):
                v = to_host(v)
            if sel is not None:
                v = v[sel]
            sk = self.sketches.get(f)
            if sk is not None:
                # sketch states finalize into their estimate columns at
                # emission (the state itself never leaves the fold)
                cols.update(sk.finalize(f, np.asarray(v, sk.state_dtype)))
                continue
            cols[f] = to_storage_dtype(v, schema[f].dtype)
        return cols

    def _emit(self, s: float) -> None:
        # build the frame BEFORE popping: a failed device->host copy must
        # leave the window's state live (the batch that triggered the
        # emit skips; the window emits on a later batch), the same
        # all-or-nothing contract as ingest. The frame lands in the
        # backlog the moment the pop commits, so a failure on a LATER
        # window cannot lose it.
        with self._state_lock:
            state = self._windows[s]
        cols: Dict[str, np.ndarray] = {
            WINDOW_COL: np.full(state.rows, s, np.float64)}
        for k, u in zip(self.keys, state.keys_u):
            cols[k] = u
        cols.update(self._values_to_host(state))
        frame = TensorFrame.from_blocks(
            [Block({f.name: cols[f.name] for f in self.out_schema},
                   state.rows)], self.out_schema)
        with self._state_lock:
            self._windows.pop(s, None)
        self._emitted_backlog.append(frame)
        self.windows_emitted += 1
        counters.inc("stream.windows_emitted")
        counters.inc("stream.rows_emitted", state.rows)
        _obs.add_event("window_emit", window=s, rows=state.rows)

    def _update_frame(self, touched: np.ndarray) -> TensorFrame:
        with self._state_lock:
            state = self._windows[None]
        sel = np.sort(np.asarray(touched))
        cols: Dict[str, np.ndarray] = {}
        for k, u in zip(self.keys, state.keys_u):
            cols[k] = u[sel]
        cols.update(self._values_to_host(state, sel))
        counters.inc("stream.rows_emitted", len(sel))
        return TensorFrame.from_blocks(
            [Block({f.name: cols[f.name] for f in self.out_schema},
                   len(sel))], self.out_schema)

    # -- execution ---------------------------------------------------------
    def start(self, sink=None, on_update=None, name: Optional[str] = None,
              max_buffered: Optional[int] = None, batch_rows=None):
        """A :class:`~.runtime.StreamHandle` pumping the upstream and
        folding each batch into this aggregation; emitted window frames
        flow to ``collect_updates()`` / ``sink`` / ``on_update``. The
        fold is a keyed monoid, so batches coalesced by an int
        ``batch_rows`` combine to the same state as the per-block ones."""
        from .runtime import StreamHandle
        return StreamHandle(self.upstream, aggregation=self, sink=sink,
                            on_update=on_update, name=name,
                            max_buffered=max_buffered,
                            batch_rows=batch_rows)

    def __repr__(self):
        w = (f"window={self.window.size}/{self.window.slide}"
             if self.window else "update-mode")
        return (f"StreamingAggregation(keys={self.keys}, "
                f"fetches={self.col_combiners}, {w}, "
                f"state_rows={self.state_rows})")
