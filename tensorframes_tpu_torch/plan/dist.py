"""Distributed logical plan: lazy d-op chains fused into ONE stage program
per mesh stage, with device-resident shard intermediates.

The port's counterpart of ``tensorframes_tpu/plan/dist.py``. Eagerly, a
chain of N row-preserving mesh ops costs N mesh dispatches, and every
``dfilter`` reads its per-shard survivor counts back to the host between
ops. A chain recorded on a lazy :class:`LazyDistributedFrame`
(``DistributedFrame.lazy()``) instead forces as one stage:

- XLA compiled the JAX package's stage into one GSPMD program; torch has
  none. Here a stage is ONE cached Python program, run once per shard,
  that composes the per-op fragments: each ``dmap_blocks`` computation
  runs on the shard's tensors as its per-op dispatch would; each
  ``dfilter`` narrows a keep mask that stays on the device with the
  shard's survivor count, and the kept rows are compacted once, at the
  stage's end (stably, to the shard's front: the eager layout); a terminal
  monoid ``dreduce_blocks`` / ``daggregate`` folds INTO the stage as its
  last fragment and never compacts (pad and dropped rows take the
  combiner's neutral value; the aggregate's fold is the ``segment_sum``
  kernel, B1, on every shard for a float sum), then the combiner's
  collective;
- the stage counts ONE ``mesh.dispatches`` and no
  ``mesh.interstage_host_bytes``; its program is built once per chain
  shape, mesh and column layout (``dplan.fused_programs`` counts builds),
  so forcing the same chain again reuses it. ``torch.compile`` is not
  applied: the stage runs eagerly.

Legality is proof-driven, as in the single-device plan: a map records
only when its computation is PROVEN row-preserving (``optimize.
_row_preserving``), a filter only when its mask provably has block length
(``optimize._mask_shaped``). Anything else (trim and global maps, generic
reductions, ``dsort``, ``dexchange``) forces the pending chain and takes
the unchanged per-op path. ``TFT_FUSE=0`` makes ``lazy()`` the identity,
so the kill switch is bit-identical by construction. A fused stage that
fails with anything but a device loss (an OOM, a permanent fault) replays
the chain op by op on the same mesh (``dplan.fallbacks``, a flight record
``dplan.fallback``); it is never a route to the CPU.

The elastic layer applies at the FUSED boundary: the whole forcing runs
through :func:`~..parallel.elastic.elastic_call`, so a device lost
mid-stage shrinks the mesh, re-shards the SOURCE frame and re-runs the
stage on the survivors. The memory ledger admits the stage
(``make_room`` on the plan's output estimate) and a forced result whose
columns are all fresh registers as ONE spill candidate.

:func:`mesh_segment_partial` is the streaming fold on a mesh: one batch's
keyed partial tables, B1 on every shard and one collective.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability import flight as _flight
from ..observability.events import add_event, current_trace, traced_query
from ..utils.logging import get_logger
from ..utils.tracing import counters, span
from .adaptive import record_stream_feedback, stream_feedback
from .nodes import _cell_bytes, observed_selectivity, record_selectivity
from .optimize import _mask_shaped, _row_preserving
from .optimize import enabled as fuse_enabled

__all__ = ["LazyDistributedFrame", "lazy_frame", "record_map",
           "record_filter", "record_reduce", "record_aggregate",
           "materialize", "mesh_segment_partial"]

_log = get_logger("plan.dist")


class _Unfusable(RuntimeError):
    """A runtime condition the recorder could not see; the caller replays
    the chain per op (unplanned, not failed)."""


class _EmptyReduceError(ValueError):
    """The per-op "reduce on an empty distributed frame" contract,
    discovered after the dispatch (a filter emptied the frame). A sentinel
    subclass so the fallback handler re-raises exactly this while any
    other ``ValueError`` out of the fused stage still replays per op."""


# ---------------------------------------------------------------------------
# plan nodes (the distributed chain IR)
# ---------------------------------------------------------------------------

class DistNode:
    """One recorded d-op (or the source leaf) of a lazy mesh chain."""

    kind = "dnode"

    def __init__(self, input: Optional["DistNode"], schema):
        self.input = input
        self.schema = schema

    def describe(self) -> str:
        return self.kind

    def estimate(self) -> Tuple[Optional[float], Optional[Dict[str, int]]]:
        """``(rows, {column: device bytes})``, the distributed twin of
        :meth:`~.nodes.PlanNode.estimate`, read by the fused dispatch's
        ledger admission and ``memory.estimate``."""
        return None, None


class DSourceNode(DistNode):
    kind = "dsource"

    def __init__(self, frame):
        super().__init__(None, frame.schema)
        self.frame_ref = weakref.ref(frame)

    def describe(self) -> str:
        f = self.frame_ref()
        return (f"dsource[{f.num_rows} rows]" if f is not None
                else "dsource[collected]")

    def estimate(self):
        f = self.frame_ref()
        if f is None:
            return None, None
        from .. import memory as _memory
        cols: Dict[str, int] = {}
        for fl in f.schema:
            try:
                cols[fl.name] = int(_memory.value_nbytes(f.columns, fl.name))
            except Exception:  # noqa: BLE001 - an estimate is advisory
                cols[fl.name] = 0
        return float(f.num_rows), cols


class DMapNode(DistNode):
    """A proven row-preserving (non-trim) ``dmap_blocks``."""

    kind = "dmap"

    def __init__(self, input, schema, comp):
        super().__init__(input, schema)
        self.comp = comp

    def describe(self) -> str:
        return "dmap_blocks"

    def estimate(self):
        rows, cols = self.input.estimate()
        if rows is None or cols is None:
            return rows, cols
        out = dict(cols)
        for s in self.comp.outputs:
            out[s.name] = int(rows * _cell_bytes(s.dtype, s.shape.dims[1:]))
        return rows, out


class DFilterNode(DistNode):
    kind = "dfilter"

    def __init__(self, input, schema, comp):
        super().__init__(input, schema)
        self.comp = comp

    def describe(self) -> str:
        sel = observed_selectivity(self.comp)
        return ("dfilter" if sel is None
                else f"dfilter[sel~{sel:.2f} observed]")

    def estimate(self):
        # feedback selectivity: once any forcing of this predicate
        # observed rows-in/rows-out, estimate with the observed ratio
        # instead of the upper bound
        rows, cols = self.input.estimate()
        sel = observed_selectivity(self.comp)
        if sel is None or rows is None:
            return rows, cols
        return rows * sel, ({n: int(b * sel) for n, b in cols.items()}
                            if cols is not None else None)


class DSelectNode(DistNode):
    kind = "dselect"

    def __init__(self, input, schema, names: Sequence[str]):
        super().__init__(input, schema)
        self.names = tuple(names)

    def describe(self) -> str:
        return f"dselect{list(self.names)}"

    def estimate(self):
        rows, cols = self.input.estimate()
        if cols is None:
            return rows, cols
        return rows, {n: cols[n] for n in self.names if n in cols}


# ---------------------------------------------------------------------------
# the lazy frame
# ---------------------------------------------------------------------------

def _dist():
    from ..parallel import distributed
    return distributed


class LazyDistributedFrame:
    """A :class:`~..parallel.distributed.DistributedFrame` whose columns
    are a RECORDED d-op chain, not materialized shards.

    Built by :meth:`DistributedFrame.lazy`; every further ``dmap_blocks``
    / ``dfilter`` / ``select`` on it records a node and stays lazy. Any
    access to data (``columns`` / ``num_rows`` / ``collect_frame`` / an
    unfusable op) FORCES the chain: the planner fuses it into one stage
    (module docstring); ``TFT_FUSE=0`` and unplannable chains replay the
    recorded ops per op, bit-identical. Thread-safe: concurrent forcings
    converge on one result.
    """

    _tft_lazy_dist = True

    def __init__(self, source, node: DistNode, chain: Tuple[DistNode, ...],
                 schema):
        self._source = source          # the materialized chain root
        self._dplan_node = node
        self._chain = chain            # op nodes, leaf -> final order
        self._mesh = source.mesh
        self.schema = schema
        self._forced = None
        self._force_lock = threading.Lock()
        self._dplan_info: Optional[List[str]] = None
        self._group_ids_cache: "OrderedDict" = OrderedDict()

    # -- laziness ----------------------------------------------------------
    def lazy(self):
        return self

    def _force(self):
        f = self._forced
        if f is not None:
            return f
        with self._force_lock:
            if self._forced is None:
                self._forced = _force_chain(self)
            return self._forced

    @property
    def mesh(self):
        # a forced chain may have recovered onto a SHRUNKEN mesh; the
        # record-time mesh stands until then
        f = self._forced
        return f.mesh if f is not None else self._mesh

    @property
    def columns(self):
        return self._force().columns

    @property
    def num_rows(self) -> int:
        return self._force().num_rows

    @property
    def shard_valid(self):
        return self._force().shard_valid

    # -- recorded ops ------------------------------------------------------
    def select(self, names) -> "LazyDistributedFrame":
        if isinstance(names, str):
            names = [names]
        names = list(names)
        missing = [n for n in names if n not in self.schema]
        if missing:
            raise KeyError(
                f"No column(s) {missing}; columns: {self.schema.names}")
        out_schema = self.schema.select(names)
        node = DSelectNode(self._dplan_node, out_schema, names)
        return LazyDistributedFrame(self._source, node,
                                    self._chain + (node,), out_schema)

    # -- estimates (no forcing) -------------------------------------------
    def estimated_rows(self):
        """Plan-derived row estimate WITHOUT forcing (filters priced at
        their observed selectivity once recorded)."""
        from ..memory.estimate import dist_frame_estimate
        return dist_frame_estimate(self)[0]

    def estimated_bytes(self):
        from ..memory.estimate import dist_frame_estimate
        return dist_frame_estimate(self)[1]

    # -- forwarding (everything else behaves like the forced frame) -------
    def count(self) -> int:
        return self.num_rows

    def explain(self) -> str:
        forced = self._force()
        report = forced.explain()
        if self._dplan_info and getattr(forced, "_dplan_info", None) \
                != self._dplan_info:
            report += "\n" + "\n".join(self._dplan_info)
        return report

    def __getattr__(self, name):
        # anything not defined here (collect_frame, per_shard_valid,
        # host_read_padded, valid_row_mask, padded_rows, ...) forces and
        # delegates: the forced frame IS this frame's value
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._force(), name)

    def __repr__(self):
        state = ("forced" if self._forced is not None
                 else f"{len(self._chain)} pending op(s)")
        return (f"LazyDistributedFrame[{', '.join(self.schema.names)}] "
                f"({state}) mesh={self._mesh!r}")


def lazy_frame(dist):
    """``DistributedFrame.lazy()``: a recording view over ``dist``, or
    ``dist`` itself when recording cannot help (``TFT_FUSE=0``,
    ``TFT_EXECUTOR=pjrt``, multi-process (cluster) meshes, frames whose
    rows do not tile the data axis)."""
    import os

    if getattr(dist, "_tft_lazy_dist", False):
        return dist
    if not fuse_enabled():
        return dist
    if os.environ.get("TFT_EXECUTOR") == "pjrt":
        return dist  # the native route keeps the per-op dispatches
    if dist.mesh.is_cluster:
        return dist  # a cluster mesh's ops stay per op
    S = dist.mesh.num_data_shards
    if S < 1 or dist.padded_rows % S != 0:
        return dist  # non-tiling (global-result) frames stay per op
    node = DSourceNode(dist)
    return LazyDistributedFrame(dist, node, (), dist.schema)


def materialize(dist):
    """The materialized frame behind ``dist`` (forcing a lazy chain)."""
    if getattr(dist, "_tft_lazy_dist", False):
        return dist._force()
    return dist


# ---------------------------------------------------------------------------
# recording (called by the d-op entry points on lazy inputs)
# ---------------------------------------------------------------------------

def record_map(fetches, lazy: LazyDistributedFrame, trim: bool,
               row_aligned) -> Optional[LazyDistributedFrame]:
    """Record a ``dmap_blocks`` on a lazy frame, or ``None`` when the op
    must force the chain and run per op (trim/global programs, unprovable
    row preservation)."""
    from ..engine import ops as _ops

    if row_aligned is False and not trim:
        # the eager op's argument validation, raised at RECORD time: a bad
        # call must not first execute the whole pending chain
        raise ValueError(
            "row_aligned=False only makes sense for trim=True outputs: "
            "without trim the untrimmed input columns ride along and "
            "still contain pad rows, which declaring every output row "
            "real would surface as data")
    if trim or not fuse_enabled():
        return None
    comp = _ops.cached_map_computation(fetches, lazy.schema,
                                       block_level=True)
    # record-time validation: the same errors the eager op raises at call
    # time (schema mismatches must not move to force time)
    out_schema = _ops._validate_map(comp, lazy.schema, block_level=True,
                                    trim=False)
    if not _row_preserving(comp):
        return None  # the per-op runtime row-count check owns this
    counters.inc("dplan.recorded_ops")
    node = DMapNode(lazy._dplan_node, out_schema, comp)
    return LazyDistributedFrame(lazy._source, node, lazy._chain + (node,),
                                out_schema)


def record_filter(predicate,
                  lazy: LazyDistributedFrame
                  ) -> Optional[LazyDistributedFrame]:
    from ..engine import ops as _ops

    if not fuse_enabled():
        return None
    comp = _ops._filter_computation(predicate, lazy.schema)
    bad = [n for n in comp.input_names
           if (f := lazy.schema.get(n)) is not None and not f.dtype.tensor]
    if bad:
        # the eager op's error, raised at record time (error parity
        # without forcing the pending chain first)
        raise _ops.InvalidTypeError(
            f"dfilter predicate reads host-side (non-tensor) column(s) "
            f"{bad}: string columns ride along on the mesh but cannot "
            f"enter the sharded program. Filter on the host instead "
            f"(tensorframes_tpu_torch.filter_rows / TensorFrame.filter) "
            f"before distribute().")
    if not _mask_shaped(comp):
        return None
    counters.inc("dplan.recorded_ops")
    node = DFilterNode(lazy._dplan_node, lazy.schema, comp)
    return LazyDistributedFrame(lazy._source, node, lazy._chain + (node,),
                                lazy.schema)


# ---------------------------------------------------------------------------
# chain planning
# ---------------------------------------------------------------------------

class _DPlan:
    """The fused-stage layout of one recorded chain (and an optional
    folded terminal reduction)."""

    __slots__ = ("ops", "members", "in_names", "out_names", "passthrough",
                 "host_names", "has_filter", "n_filters", "final_schema",
                 "reduce_names", "reduce_combs", "agg_combiners", "labels",
                 "filter_nodes", "est_bytes")

    def __init__(self):
        self.est_bytes = None  # plan-derived result size (ledger admission)
        self.ops = []
        self.members = []
        self.in_names = ()
        self.out_names = ()
        self.passthrough = ()
        self.host_names = ()
        self.has_filter = False
        self.n_filters = 0
        self.final_schema = None
        self.reduce_names = None   # sorted fetch names of a folded reduce
        self.reduce_combs = None   # {name: Combiner}
        self.agg_combiners = None  # {name: combiner-name} of a folded agg
        self.labels = []
        self.filter_nodes = []

    @property
    def n_ops(self) -> int:
        return len(self.ops) + (1 if (self.reduce_names is not None
                                      or self.agg_combiners) else 0)

    def describe(self, executed: Optional[str] = None) -> List[str]:
        term = ""
        if self.reduce_names is not None:
            term = " + dreduce_blocks[folded]"
        elif self.agg_combiners:
            term = " + daggregate[folded]"
        state = executed or "planned"
        lines = [f"  dplan    : {self.n_ops} op(s) -> 1 fused stage "
                 f"program, run once per shard ({state})",
                 f"    stage 0: {'+'.join(self.labels) or 'pass'}{term} "
                 f"-> 1 mesh dispatch"]
        if self.passthrough:
            lines.append(f"    resident: {list(self.passthrough)} "
                         f"pass through device-resident (no program I/O)")
        if self.has_filter:
            lines.append(
                f"    filters : {self.n_filters} compacted in-program "
                f"(keep masks and survivor counts stay on the devices; "
                f"no inter-op host readback)")
        return lines


def _plan_chain(source_schema, ops: Sequence[DistNode], final_schema,
                reduce_spec: Optional[Mapping[str, str]] = None,
                agg_value_names: Optional[Sequence[str]] = None
                ) -> Optional[_DPlan]:
    """Lay one fused stage out of the recorded ``ops``; ``None`` means the
    chain has nothing to fuse (select-only, no terminal)."""
    from ..parallel.collectives import COMBINERS

    plan = _DPlan()
    plan.ops = list(ops)
    plan.final_schema = final_schema

    # backward need pass (column pruning): a column is read or carried
    # only when it feeds a computation or survives to the final schema
    if reduce_spec is not None:
        need = set(reduce_spec)
    elif agg_value_names is not None:
        need = set(agg_value_names)
    else:
        need = {f.name for f in final_schema}
    for o in reversed(ops):
        if o.kind == "dmap":
            need = (need - set(o.comp.output_names)) \
                | set(o.comp.input_names)
        elif o.kind == "dfilter":
            need = need | set(o.comp.input_names)
        # select: need is already a subset of the selected names

    leaf_required = [f.name for f in source_schema
                     if f.dtype.tensor and f.name in need]
    plan.host_names = tuple(
        f.name for f in final_schema
        if not f.dtype.tensor) if reduce_spec is None \
        and agg_value_names is None else ()
    plan.in_names = tuple(leaf_required)

    # forward simulation: compose members, track the live tensor env in
    # deterministic order (leaf order, then map outputs by name)
    order: List[str] = list(leaf_required)
    env = set(order)
    produced: set = set()
    for o in ops:
        if o.kind == "dselect":
            keep = set(o.names)
            order = [n for n in order if n in keep]
            env &= keep
            produced &= keep
            plan.members.append(("sel", tuple(order)))
        elif o.kind == "dmap":
            if not set(o.comp.input_names) <= env:
                return None  # defensive: the recorder guarantees this
            plan.members.append(("map", o.comp))
            plan.labels.append("dmap_blocks")
            for s in o.comp.outputs:
                if s.name not in env:
                    order.append(s.name)
                env.add(s.name)
                produced.add(s.name)
        else:  # dfilter
            if not set(o.comp.input_names) <= env:
                return None
            plan.members.append(("filter", o.comp, tuple(order)))
            plan.labels.append("dfilter")
            plan.has_filter = True
            plan.n_filters += 1
            plan.filter_nodes.append(o)
            produced = set(order)  # everything is permuted now

    if reduce_spec is not None:
        plan.reduce_names = sorted(reduce_spec)
        plan.reduce_combs = {n: COMBINERS[reduce_spec[n]]
                             for n in plan.reduce_names}
        if not set(plan.reduce_names) <= env:
            return None
        return plan
    if agg_value_names is not None:
        if not set(agg_value_names) <= env:
            return None
        return plan

    final_tensor = [f.name for f in final_schema if f.dtype.tensor]
    if not set(final_tensor) <= env:
        return None
    if plan.has_filter:
        # a filter permutes every live column: all survivors come out of
        # the stage
        plan.out_names = tuple(n for n in order if n in set(final_tensor))
        plan.passthrough = ()
    else:
        plan.out_names = tuple(n for n in order
                               if n in produced and n in set(final_tensor))
        plan.passthrough = tuple(n for n in final_tensor
                                 if n not in produced)
    if not any(m[0] in ("map", "filter") for m in plan.members):
        return None  # select-only: no program needed
    return plan


# ---------------------------------------------------------------------------
# the fused stage program (per-op fragments composed, run once per shard)
# ---------------------------------------------------------------------------

_fused_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
_FUSED_CACHE_CAP = 64
_fused_lock = threading.Lock()


def _member_key(m) -> tuple:
    if m[0] == "map":
        return ("map", id(m[1]))
    if m[0] == "filter":
        return ("filter", id(m[1]), m[2])
    return m


def _neutral_masked(c, v: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``v`` with the rows ``keep`` drops set to the combiner's neutral
    element."""
    neutral = torch.tensor(c.neutral(v.dtype), dtype=v.dtype,
                           device=v.device)
    return torch.where(keep.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                       neutral)


def _build_fused_fn(plan: _DPlan, want_keeps: bool,
                    agg_groups: Optional[int] = None):
    """The whole chain as one function of one shard: ``fn(rows, valid,
    cols, ids)`` with ``cols`` the shard's tensors of ``plan.in_names``,
    ``valid`` its valid-row count and ``ids`` its group ids (a folded
    aggregate). Returns ``{"cols": ..., "count": ..., "keep": ...}`` for
    a frame, ``{"partials": ...}`` for a folded reduce (with ``count``
    after a filter) and ``{"tables": ...}`` for a folded aggregate."""
    D = _dist()
    members = tuple(plan.members)
    out_names = plan.out_names
    has_filter = plan.has_filter
    reduce_names = plan.reduce_names
    reduce_combs = plan.reduce_combs
    agg = plan.agg_combiners
    agg_names = sorted(agg) if agg else ()

    def shard_fn(rows: int, valid: int, cols, ids=None, device=None):
        env = dict(cols)
        keep = None
        if has_filter or reduce_names is not None:
            keep = torch.arange(rows, device=device) < valid
        for m in members:
            if m[0] == "map":
                comp = m[1]
                env.update(D._call(comp, {n: env[n]
                                          for n in comp.input_names}))
            elif m[0] == "sel":
                alive = set(m[1])
                env = {n: v for n, v in env.items() if n in alive}
            else:
                comp = m[1]
                mk = D._call(comp, {n: env[n] for n in comp.input_names})
                keep = keep & (mk[comp.output_names[0]] != 0)
        if reduce_names is not None:
            out = {"partials": {} if rows == 0 else {
                n: reduce_combs[n].local(
                    _neutral_masked(reduce_combs[n], env[n], keep), 0)
                for n in reduce_names}}
            if has_filter:
                out["count"] = keep.sum()
            return out
        if agg is not None:
            # the terminal fold: B1 for a float sum, on this shard (pad
            # rows carry id -1 and are dropped by the fold)
            return {"tables": {f: D._shard_table(agg[f], env[f], ids,
                                                 agg_groups)
                               for f in agg_names}}
        if not has_filter:
            return {"cols": {n: env[n] for n in out_names}}
        # one stable compaction at the stage's end: the kept rows to the
        # shard's front in their order, the eager layout
        order = torch.argsort((~keep).to(torch.int8), stable=True)
        out = {"cols": {n: env[n].index_select(0, order.to(env[n].device))
                        for n in out_names},
               "count": keep.sum()}
        if want_keeps:
            out["keep"] = keep
        return out

    return shard_fn


def _fused_program(plan: _DPlan, d, want_keeps: bool,
                   agg_groups: Optional[int] = None):
    """The cached stage program for ``plan`` over ``d``'s mesh and column
    layout (a shrink or reshard changes both and builds anew; the
    computations are held strongly by the entry so their ids stay valid
    for the key's lifetime)."""
    from ..parallel import elastic as _elastic
    mesh = d.mesh
    arrays = [d.columns[n] for n in plan.in_names]
    key = (_elastic._mesh_key(mesh), mesh.data_axis,
           tuple(str(x) for x in mesh.shard_devices()),
           tuple(_member_key(m) for m in plan.members),
           tuple((n, tuple(a.shape), str(a.dtype))
                 for n, a in zip(plan.in_names, arrays)),
           plan.out_names, want_keeps, agg_groups,
           tuple(sorted(plan.reduce_combs))
           if plan.reduce_combs is not None else None,
           tuple(sorted(plan.agg_combiners.items()))
           if plan.agg_combiners else None)
    with _fused_lock:
        hit = _fused_cache.get(key)
        if hit is not None:
            _fused_cache.move_to_end(key)
            return hit[0], arrays
    fn = _build_fused_fn(plan, want_keeps, agg_groups)
    strong = [m[1] for m in plan.members if m[0] in ("map", "filter")]
    with _fused_lock:
        hit = _fused_cache.setdefault(key, (fn, strong))
        _fused_cache.move_to_end(key)
        while len(_fused_cache) > _FUSED_CACHE_CAP:
            _fused_cache.popitem(last=False)
    counters.inc("dplan.fused_programs")
    return hit[0], arrays


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _admit(plan: _DPlan, d) -> None:
    """Ledger admission for the fused dispatch: spill colder residents
    before the stage's outputs land. The plan-derived estimate
    (``memory.estimate.dist_frame_estimate``, observed filter
    selectivities included) prices the result when available; the raw
    per-output sum is the fallback."""
    from .. import memory as _memory
    mgr = _memory.active()
    if mgr is None:
        return
    est = plan.est_bytes
    if est is None:
        rows = float(d.padded_rows)
        est = 0
        for o in plan.ops:
            if o.kind == "dmap":
                for s in o.comp.outputs:
                    est += int(rows * _cell_bytes(s.dtype,
                                                  s.shape.dims[1:]))
    if est:
        mgr.make_room(int(est))


def _register_result(cols: Dict, mesh_tag: str):
    """Resident shard edges join the memory LRU: the forced chain's
    columns spill to pinned host memory under ledger pressure and fault
    back on the next access, like any distributed frame."""
    from .. import memory as _memory
    mgr = _memory.active()
    if mgr is not None and mgr.spill_enabled:
        return _memory.spillable_columns(mesh_tag, cols, mgr)
    return cols


def _feedback_key(plan: _DPlan) -> str:
    """The fused stage's identity in the adaptive feedback registry: one
    record per plan shape, accumulated across forcings."""
    return (f"dplan[{','.join(o.kind for o in plan.ops)}]"
            f"({plan.final_schema.names})")


def _feedback_lines(plan: _DPlan) -> List[str]:
    """The per-stage shard-time line ``explain()`` renders from the
    feedback registry."""
    fb = stream_feedback(_feedback_key(plan))
    if fb is None or not fb.forcings:
        return []
    shards = max(fb.blocks // max(fb.forcings, 1), 1)
    return [f"    feedback: {fb.forcings} fused forcing(s) · "
            f"{shards} shard(s)/stage · mean stage wall "
            f"{fb.wall_s / fb.forcings * 1e3:.2f} ms · "
            f"{fb.rows} row(s) total (feedback registry; unused for "
            f"sizing today)"]


def _record_fallback(e: BaseException) -> None:
    """Always-on bookkeeping of a fused-chain fallback to the per-op
    replay: the counter pair and the flight-recorder decision, with the
    classified kind."""
    from ..resilience import error_kind, is_oom
    counters.inc("dplan.fallbacks")
    if is_oom(e):
        counters.inc("dplan.oom_fallbacks")
    _flight.record("dplan.fallback", error=type(e).__name__,
                   error_kind=error_kind(e))


def _dispatch(plan: _DPlan, d, want_keeps: bool,
              agg_groups: Optional[int] = None, ids=None):
    """One fused mesh dispatch over ``d``: the stage program on every
    shard, through the resilient policy (transient retry), with the trace
    plumbing. Returns ``(per-shard outputs, wall seconds)``."""
    from ..resilience import default_policy as _default_policy
    from ..resilience import faults as _faults

    D = _dist()
    mesh = d.mesh
    S = max(mesh.num_data_shards, 1)
    if d.padded_rows % S != 0:
        raise _Unfusable("frame rows do not tile the data axis")
    fn, arrays = _fused_program(plan, d, want_keeps, agg_groups)
    valid = d.per_shard_valid()
    rows = D._shard_rows(d)
    devices = mesh.shard_devices()
    _admit(plan, d)
    policy = _default_policy()
    trace = current_trace()
    clock = (D._trace_shards(trace, "dfused", d)
             if trace is not None else None)

    def _go():
        _faults.check("dmap")
        if clock is not None:
            clock.marks.clear()  # a retried attempt times its own shards
        outs = []
        with span("dfused.dispatch"), torch.no_grad():
            for s in range(S):
                outs.append(fn(int(rows[s]), int(valid[s]),
                               {n: a.shards[s] for n, a in
                                zip(plan.in_names, arrays)},
                               ids.shards[s] if ids is not None else None,
                               devices[s]))
                if clock is not None:
                    clock.mark()
        return outs

    w0 = time.perf_counter()
    # the regression drill's deterministic slowdown lands INSIDE the
    # measured stage wall, so the sentinel attributes it to stage_wall_s
    _faults.slowdown("perf")
    outs = policy.call(_go, op="dfused.dispatch")
    wall = time.perf_counter() - w0
    counters.inc("mesh.dispatches")
    if trace is not None:
        add_event("fused_stage", name="+".join(plan.labels) or "pass",
                  ops=plan.n_ops, filters=plan.n_filters,
                  resident=len(plan.passthrough), wall_s=wall,
                  shards=mesh.num_data_shards)
        D._trace_done(trace, "dfused", clock, mesh)
    return outs, wall


def _counts(outs, dev0) -> np.ndarray:
    """The shards' survivor counts on the host (read once, after the
    stage)."""
    from ..engine.executor import to_host
    return to_host(torch.stack([o["count"].to(dev0) for o in outs])
                   ).astype(np.int64)


def _permute_host(a: np.ndarray, keeps: Sequence[np.ndarray]
                  ) -> np.ndarray:
    """Replay the stage's per-shard compaction on a host (string)
    ride-along column: each shard's kept rows to its front, in order."""
    out = np.empty_like(a)
    lo = 0
    for keep in keeps:
        hi = lo + keep.shape[0]
        order = np.argsort(~keep, kind="stable")
        out[lo:hi] = a[lo:hi][order]
        lo = hi
    return out


def _meta_dfused(plan=None, source=None, *a, **k):
    source = k.get("source", source)
    plan = k.get("plan", plan)
    if source is None:
        return {}
    meta = _dist()._mesh_meta(source)
    if plan is not None:
        meta["fused_ops"] = plan.n_ops
    return meta


@traced_query("dfused", _meta_dfused)
def _run_fused_frame(plan: _DPlan, source):
    from ..parallel import elastic as _elastic

    return _elastic.elastic_call("dfused", source,
                                 lambda d: _exec_frame(plan, d))


def _exec_frame(plan: _DPlan, d):
    from ..engine.executor import to_host

    D = _dist()
    S = d.mesh.num_data_shards
    dev0 = d.mesh.shard_devices()[0]
    want_keeps = plan.has_filter and bool(plan.host_names)
    outs, wall = _dispatch(plan, d, want_keeps)
    cols: Dict[str, object] = {}
    # resident passthrough: untouched source columns chain buffer to
    # buffer (no copy, no program I/O); per-key access through
    # __getitem__ keeps SpillableColumns' fault-back live
    for n in plan.passthrough:
        cols[n] = d.columns[n]
    for n in plan.out_names:
        cols[n] = D.ShardedArray([o["cols"][n] for o in outs])
    if plan.has_filter:
        counts = _counts(outs, dev0)
        num_rows = int(counts.sum())
        shard_valid = counts
        if plan.n_filters == 1:
            # single-filter chains attribute the observed selectivity to
            # their predicate (row-preserving maps keep the count)
            record_selectivity(plan.filter_nodes[0].comp, d.num_rows,
                               num_rows)
    else:
        num_rows = d.num_rows
        shard_valid = d.shard_valid
    if want_keeps:
        keeps = [to_host(o["keep"]) for o in outs]
        for n in plan.host_names:
            cols[n] = _permute_host(np.asarray(d.columns[n], object), keeps)
    elif plan.host_names:
        for n in plan.host_names:
            cols[n] = d.columns[n]
    if not plan.passthrough:
        # every column is a FRESH stage output: register the result as one
        # LRU spill candidate (the resident shard edge). Passthrough
        # columns are the SOURCE's own shards: its registration already
        # accounts them, and a second wrapper over the same tensors would
        # double-count resident bytes
        cols = _register_result(cols, f"dfused@{id(plan):x}")
    record_stream_feedback(_feedback_key(plan), blocks=S,
                           rows=num_rows, wall_s=wall)
    return D.DistributedFrame(d.mesh, plan.final_schema, cols, num_rows,
                              shard_valid=shard_valid)


def _replay_per_op(source, ops: Sequence[DistNode]):
    """The recorded chain re-run through the UNCHANGED eager d-op
    dispatches on the same mesh: the ``TFT_FUSE=0`` path and the
    unrecoverable-failure fallback, bit-identical to never having
    recorded at all."""
    D = _dist()
    cur = source
    for o in ops:
        if o.kind == "dmap":
            cur = D.dmap_blocks(o.comp, cur)
        elif o.kind == "dfilter":
            cur = D.dfilter(o.comp, cur)
        else:
            cur = cur.select(list(o.names))
    return cur


def _force_chain(lazy: LazyDistributedFrame):
    source, ops = lazy._source, list(lazy._chain)
    if not ops:
        lazy._dplan_info = ["  dplan    : empty chain (source frame)"]
        return source
    if not fuse_enabled():
        lazy._dplan_info = [
            "  dplan    : TFT_FUSE=0 — recorded chain replayed through "
            "the per-op d-op dispatches"]
        result = _replay_per_op(source, ops)
        result._dplan_info = lazy._dplan_info
        return result
    plan = _plan_chain(source.schema, ops, lazy.schema)
    if plan is None:
        # select-only chains: pure views, no dispatch at all
        cur = source
        for o in ops:
            if o.kind == "dselect":
                cur = cur.select(list(o.names))
            else:  # defensive: unplanned, not failed
                lazy._dplan_info = [
                    "  dplan    : chain not plannable — per-op replay"]
                return _replay_per_op(source, ops)
        lazy._dplan_info = [
            "  dplan    : projection-only chain (0 mesh dispatches)"]
        return cur
    from ..memory.estimate import dist_frame_estimate
    plan.est_bytes = dist_frame_estimate(lazy)[1]
    try:
        result = _run_fused_frame(plan, source)
    except Exception as e:  # noqa: BLE001 - reclassified below
        from ..resilience import is_device_lost
        if is_device_lost(e):
            raise  # elastic recovery exhausted: per-op parity is to raise
        _record_fallback(e)
        _log.warning(
            "fused mesh stage failed (%s: %s); re-running the recorded "
            "chain through the per-op d-op dispatches", type(e).__name__,
            e)
        lazy._dplan_info = plan.describe(
            executed=f"FELL BACK per-op: {type(e).__name__}")
        result = _replay_per_op(source, ops)
        result._dplan_info = lazy._dplan_info
        return result
    counters.inc("dplan.fused_forcings")
    lazy._dplan_info = plan.describe(executed="executed") \
        + _feedback_lines(plan)
    # explain() on the FORCED frame renders the same plan section
    result._dplan_info = lazy._dplan_info
    return result


# ---------------------------------------------------------------------------
# folded terminal reductions
# ---------------------------------------------------------------------------

def record_reduce(fetches, lazy: LazyDistributedFrame
                  ) -> Optional[Dict[str, np.ndarray]]:
    """Fold a monoid ``dreduce_blocks`` into the pending chain's fused
    stage as its terminal combiner; ``None`` defers to forcing the chain
    and the eager op (computations, fusion off)."""
    from ..parallel.collectives import COMBINERS

    if not (isinstance(fetches, Mapping) and fetches and all(
            isinstance(v, str) for v in fetches.values())):
        return None
    if not fuse_enabled() or not lazy._chain:
        return None
    # the eager op's validation errors, raised before any work
    for name, cname in fetches.items():
        if name not in lazy.schema:
            raise KeyError(f"No column {name!r}")
        if cname not in COMBINERS:
            raise KeyError(
                f"Unknown combiner {cname!r}; known: {sorted(COMBINERS)}")
    source, ops = lazy._source, list(lazy._chain)
    plan = _plan_chain(source.schema, ops, lazy.schema,
                       reduce_spec=dict(fetches))
    if plan is None:
        return None
    if not plan.has_filter and source.num_rows == 0:
        raise ValueError("reduce on an empty distributed frame")
    try:
        result = _run_fused_reduce(plan, source)
    except _EmptyReduceError:
        raise  # the empty-after-filter contract (per-op parity)
    except Exception as e:  # noqa: BLE001 - reclassified below
        from ..resilience import is_device_lost
        if is_device_lost(e):
            raise
        _record_fallback(e)
        _log.warning(
            "fused mesh reduce failed (%s: %s); re-running per-op",
            type(e).__name__, e)
        return _dist().dreduce_blocks(fetches, _replay_per_op(source, ops))
    counters.inc("dplan.fused_forcings")
    lazy._dplan_info = plan.describe(executed="executed") \
        + _feedback_lines(plan)
    return result


@traced_query("dfused", _meta_dfused)
def _run_fused_reduce(plan: _DPlan, source):
    from ..parallel import elastic as _elastic

    return _elastic.elastic_call(
        "dfused", source, lambda d: _exec_reduce(plan, d))


def _exec_reduce(plan: _DPlan, d) -> Dict[str, np.ndarray]:
    D = _dist()
    outs, wall = _dispatch(plan, d, want_keeps=False)
    record_stream_feedback(_feedback_key(plan),
                           blocks=d.mesh.num_data_shards,
                           rows=d.num_rows, wall_s=wall)
    names = plan.reduce_names
    if plan.has_filter:
        num_rows = int(_counts(outs, d.mesh.shard_devices()[0]).sum())
        if plan.n_filters == 1:
            record_selectivity(plan.filter_nodes[0].comp, d.num_rows,
                               num_rows)
        if num_rows == 0:
            # the eager op raises before dispatching; here emptiness is
            # only knowable after: same exception type and text either way
            raise _EmptyReduceError(
                "reduce on an empty distributed frame")
    result = {}
    for name in names:
        c = plan.reduce_combs[name]
        out = c.collective([o["partials"][name] for o in outs
                            if o["partials"]])
        result[name] = D._host_result(out, plan.final_schema.get(name))
    return result


def record_aggregate(fetches, lazy: LazyDistributedFrame, keys,
                     max_groups):
    """Fold a monoid host-key ``daggregate`` into the fused stage (the
    chain's values reduce by group on every shard, B1 for a float sum,
    then one collective). ``None`` defers to forcing the chain and the
    eager op: device-key (``max_groups``) aggregations, computations,
    chains with a filter (the key->id factorization reads the SOURCE
    layout, which a filter invalidates), or keys produced by the
    chain."""
    if not fuse_enabled() or not lazy._chain:
        return None
    if max_groups is not None:
        return None
    if not (isinstance(fetches, Mapping) and fetches and all(
            isinstance(v, str) for v in fetches.values())):
        return None
    source, ops = lazy._source, list(lazy._chain)
    if any(o.kind == "dfilter" for o in ops):
        return None
    for k in keys:
        if k not in lazy.schema or k not in source.schema:
            return None
        if any(o.kind == "dmap" and k in o.comp.output_names for o in ops):
            return None  # a computed key column needs the chain's values
    from ..engine.ops import _validate_monoid_fetches

    value_names = [n for n in lazy.schema.names if n not in keys]
    _validate_monoid_fetches(fetches, value_names, "before distribute()")
    if source.num_rows == 0:
        raise ValueError("aggregate on an empty distributed frame")
    plan = _plan_chain(source.schema, ops, lazy.schema,
                       agg_value_names=sorted(fetches))
    if plan is None:
        return None
    plan.agg_combiners = dict(fetches)
    try:
        result = _run_fused_aggregate(plan, source, list(keys))
    except Exception as e:  # noqa: BLE001 - reclassified below
        from ..resilience import is_device_lost
        if is_device_lost(e):
            raise
        _record_fallback(e)
        _log.warning(
            "fused mesh aggregate failed (%s: %s); re-running per-op",
            type(e).__name__, e)
        return _dist().daggregate(fetches, _replay_per_op(source, ops),
                                  keys)
    counters.inc("dplan.fused_forcings")
    lazy._dplan_info = plan.describe(executed="executed") \
        + _feedback_lines(plan)
    return result


@traced_query("dfused", _meta_dfused)
def _run_fused_aggregate(plan: _DPlan, source, keys):
    from ..parallel import elastic as _elastic

    return _elastic.elastic_call(
        "dfused", source, lambda d: _exec_aggregate(plan, d, keys))


def _exec_aggregate(plan: _DPlan, d, keys):
    """Key ids factorize from the SOURCE frame (the chain is filter-free
    and the keys pass through untouched, so the row<->id layout is the
    same): hot-key salting, the group-ids cache and the host fold-back
    all ride the eager op's own helpers."""
    from ..engine.executor import to_host
    from ..parallel.collectives import COMBINERS

    D = _dist()
    ids, uniques, num_groups, salt_plan = D._monoid_group_plan(d, keys)
    if salt_plan is not None:
        prog_ids, prog_groups = salt_plan[0], salt_plan[1]
    else:
        prog_ids, prog_groups = ids, num_groups
    fetch_names = sorted(plan.agg_combiners)
    outs, wall = _dispatch(plan, d, want_keeps=False,
                           agg_groups=prog_groups, ids=prog_ids)
    record_stream_feedback(_feedback_key(plan),
                           blocks=d.mesh.num_data_shards,
                           rows=d.num_rows, wall_s=wall)
    tables = [to_host(COMBINERS[plan.agg_combiners[f]].collective(
        [o["tables"][f] for o in outs])) for f in fetch_names]
    if salt_plan is not None:
        from ..parallel import elastic as _elastic
        tables = [_elastic.fold_salted(t, salt_plan[2],
                                       plan.agg_combiners[f])
                  for f, t in zip(fetch_names, tables)]
    key_cols = {k: u for k, u in zip(keys, uniques)}
    out = D._monoid_agg_result(plan.final_schema, keys, fetch_names,
                               tables, key_cols, num_groups)
    if salt_plan is not None:
        # the fused fold surfaces its hot-key observations like the eager
        # op (frame.hot_keys() / explain())
        D.attach_hot_keys(out, keys, uniques, salt_plan)
    return out


# ---------------------------------------------------------------------------
# streaming: per-batch window folds on the mesh
# ---------------------------------------------------------------------------

def mesh_segment_partial(mesh, col_combiners: Mapping[str, str],
                         ids: np.ndarray, vals: Mapping[str, object],
                         num_groups: int) -> Dict[str, torch.Tensor]:
    """One batch's keyed partial tables as ONE mesh dispatch: the rows
    shard over the data axis in equal ceil-div shards (pad rows carry id
    -1), each shard reduces its rows by group (``segment_sum``, B1, for a
    float sum: one launch a shard and sum column) and the combiner's
    collective yields the ``[groups, ...]`` tables the window state
    merges, on the first shard's device. ``vals`` are tensors or host
    arrays of the batch's rows."""
    D = _dist()
    from ..parallel.collectives import COMBINERS

    S = mesh.num_data_shards
    devices = mesh.shard_devices()
    fetch_names = sorted(col_combiners)
    n = int(ids.shape[0])
    rows_per = max(-(-n // S), 1)
    padded = rows_per * S
    ids_p = np.full(padded, -1, np.int32)
    ids_p[:n] = ids
    with span("stream.mesh_fold"), torch.no_grad():
        id_shards = D.ShardedArray([
            torch.from_numpy(ids_p[s * rows_per:(s + 1) * rows_per])
            .to(devices[s]) for s in range(S)])
        cols = {}
        for f in fetch_names:
            v = vals[f]
            v = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
            if padded != n:
                v = torch.cat([v, v.new_zeros((padded - n,)
                                              + tuple(v.shape[1:]))])
            cols[f] = D.ShardedArray([v[s * rows_per:(s + 1) * rows_per]
                                      .to(devices[s]) for s in range(S)])
        parts = D._shard_tables(fetch_names, col_combiners, cols,
                                id_shards, num_groups)
        tables = {f: COMBINERS[col_combiners[f]].collective(parts[f])
                  for f in fetch_names}
    counters.inc("mesh.dispatches")
    counters.inc("stream.mesh_folds")
    return tables
