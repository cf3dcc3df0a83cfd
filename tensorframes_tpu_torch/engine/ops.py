"""The six core operations: map/filter/reduce/aggregate over TensorFrames.

The port's counterpart of ``tensorframes_tpu/engine/ops.py``, with the same
user-visible contracts, validation and error messages:

- ``map_blocks`` / ``map_rows`` are **lazy**, append output columns **sorted
  by name**, and reject fetch names that collide with existing columns;
- ``map_blocks(trim=True)`` returns only the fetch columns and may change the
  number of rows;
- ``filter_rows`` keeps the rows where a one-fetch predicate is nonzero;
- ``reduce_blocks`` requires, for each fetch ``z``, an input ``z_input`` of
  rank one higher; ``reduce_rows`` requires inputs ``z_1``/``z_2`` of the
  fetch's own shape; both are **eager** and reduce per-partition first,
  then combine partials;
- ``aggregate`` groups by key columns: the ``{column: "sum"|"min"|"max"|
  "prod"}`` form reduces each column with one segment reduction per block
  (float sums through the CUDA ``segment_sum`` kernel on a GPU); the
  computation form folds every group of a block at once by a segmented
  scan of the program over two-row blocks (``_aggregate_segmented_fold``),
  or, under an executor of another kind than the default, reduces each
  group through a :class:`CompactionBuffer`.

User computations are PyTorch functions (or DSL nodes, ``dsl/``) run
eagerly on the executor's device; ``map_rows`` vectorizes them with
``torch.func.vmap`` and ``reduce_rows`` folds a partition with a Python
loop. The lazy ops also record a logical-plan node on their result
(``plan/nodes.py``) unless an explicit ``executor=`` pins the per-op path,
and ``filter_rows`` records each forcing's observed selectivity on its
predicate. The mapping form of ``aggregate`` also takes the sketch
combiners of ``relational/sketch.py`` (``approx_distinct``,
``approx_quantile``, ``approx_top_k``), mixed freely with the scalar names.
``map_rows`` dispatches with ``row_local=True`` (its rows are independent
under vmap), so a block that runs out of device memory splits in half
and re-runs (``engine/executor.py``); ``map_blocks``, ``filter_rows``, the
reduces and ``aggregate`` let the OOM propagate. The eager ops
(``reduce_blocks``, ``reduce_rows``, ``aggregate``) each open a query
trace when tracing is on (``observability.traced_query``); a lazy op's
forcing opens one in ``TensorFrame.blocks``.
"""

from __future__ import annotations

import inspect
import threading
import weakref
from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from .. import dtypes as _dt
from .. import memory as _memory
from .. import native as _native
from ..computation import Computation, TensorSpec
from ..memory.estimate import propagate_hints
from ..frame import Block, GroupedFrame, TensorFrame
from ..marshal import Column
from ..observability.events import traced_query
from ..ops.segment_reduce import segment_sum as _segment_sum
from ..schema import Field, Schema
from ..shape import Shape, Unknown
from ..utils.logging import get_logger
from ..utils.tracing import counters, span
from .compaction import CompactionBuffer, DEFAULT_BUFFER_SIZE
from .executor import (BlockExecutor, default_executor,
                       default_padding_executor, to_device, to_host,
                       to_storage_dtype)
from . import pipeline as _pipeline

_log = get_logger("engine.ops")

__all__ = [
    "map_blocks", "map_rows", "filter_rows", "reduce_blocks", "reduce_rows",
    "aggregate", "InputNotFoundError", "InvalidTypeError",
    "InvalidShapeError",
]


class InputNotFoundError(ValueError):
    """A computation input has no matching DataFrame column
    (``Operations.scala:7-9`` InputNotFoundException analogue)."""


class InvalidTypeError(ValueError):
    """Column/input dtype mismatch — no implicit casting is performed
    (``Operations.scala:13-15`` InvalidTypeException analogue)."""


class InvalidShapeError(ValueError):
    """Column/input shape incompatibility
    (``Operations.scala:10-12`` InvalidDimensionException analogue)."""


Fetches = Union[Computation, Callable]


# ---------------------------------------------------------------------------
# Computation adaptation: callables -> Computation bound to the frame schema
# ---------------------------------------------------------------------------

def _callable_input_names(fn: Callable) -> List[str]:
    sig = inspect.signature(fn)
    names = []
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                      p.KEYWORD_ONLY):
            names.append(p.name)
        else:
            raise ValueError(
                f"Cannot derive computation inputs from *args/**kwargs "
                f"parameter {p.name!r}; pass a Computation instead")
    return names


def _field_spec(field: Field, block_level: bool, context: str) -> Shape:
    if not field.dtype.tensor:
        raise InvalidTypeError(
            f"Column {field.name!r} has non-tensor type {field.dtype.name} "
            f"and cannot feed a computation ({context}); it can only pass "
            f"through or serve as a group_by key")
    if field.block_shape is None:
        raise InvalidShapeError(
            f"Column {field.name!r} has no tensor shape information; run "
            f"analyze() on the frame first ({context})")
    return field.block_shape if block_level else field.block_shape.tail


def _is_dsl(fetches) -> bool:
    if isinstance(fetches, (list, tuple)) and fetches:
        fetches = fetches[0]
    return hasattr(fetches, "_tft_dsl_node")


def _map_computation(fetches: Fetches, schema: Schema,
                     block_level: bool) -> Computation:
    if isinstance(fetches, Computation):
        return fetches
    if _is_dsl(fetches):
        from ..dsl import lower as _dsl_lower
        return _dsl_lower.nodes_to_computation(fetches, schema, block_level)
    if callable(fetches):
        names = _callable_input_names(fetches)
        specs = []
        for n in names:
            field = schema.get(n)
            if field is None:
                raise InputNotFoundError(
                    f"Computation input {n!r} found no matching column; "
                    f"columns: {schema.names}")
            specs.append(TensorSpec(
                n, field.dtype, _field_spec(field, block_level, "map")))
        return Computation.trace(fetches, specs)
    raise TypeError(f"Unsupported fetches object: {type(fetches)}")


def _reduce_computation(fetches: Fetches, schema: Schema,
                        suffixes: Sequence[str],
                        block_level: bool) -> Computation:
    """Build/check a reduce computation whose inputs are derived from fetch
    names + naming-contract suffixes ('_input' or '_1'/'_2')."""
    if isinstance(fetches, Computation):
        return fetches
    if _is_dsl(fetches):
        from ..dsl import lower as _dsl_lower
        return _dsl_lower.nodes_to_reduce_computation(
            fetches, schema, suffixes, block_level)
    if callable(fetches):
        names = _callable_input_names(fetches)
        specs = []
        for n in names:
            base = _strip_suffix(n, suffixes)
            if base is None:
                raise InputNotFoundError(
                    f"Reduce input {n!r} does not follow the naming "
                    f"contract (expected one of "
                    f"{[f'<col>{s}' for s in suffixes]})")
            field = schema.get(base)
            if field is None:
                raise InputNotFoundError(
                    f"Reduce input {n!r}: no column named {base!r}; "
                    f"columns: {schema.names}")
            shape = _field_spec(field, block_level, "reduce")
            specs.append(TensorSpec(n, field.dtype, shape))
        return Computation.trace(fetches, specs)
    raise TypeError(f"Unsupported fetches object: {type(fetches)}")


def _strip_suffix(name: str, suffixes: Sequence[str]) -> Optional[str]:
    for s in suffixes:
        if name.endswith(s) and len(name) > len(s):
            return name[: -len(s)]
    return None


# Computation objects rebuilt per call would be traced anew each time;
# this weak cache reuses one Computation per (fetches, kind, schema). All
# access is under _comp_cache_lock.
_fetches_comp_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_comp_cache_lock = threading.Lock()


def _cached(fetches, kind: tuple, schema: Schema,
            build: Callable[[], Computation]) -> Computation:
    """``build()``, reused per (fetches object, ``kind``, schema) and keyed
    weakly by the fetches object; unhashable or unweakrefable fetches build
    fresh. Racing threads converge on one canonical Computation."""
    sig = kind + tuple((f.name, f.dtype.name,
                        tuple(f.block_shape.dims)
                        if f.block_shape is not None else None)
                       for f in schema)
    try:
        with _comp_cache_lock:
            per = _fetches_comp_cache.setdefault(fetches, {})
            comp = per.get(sig)
    except TypeError:
        return build()
    if comp is None:
        comp = build()
        with _comp_cache_lock:
            comp = per.setdefault(sig, comp)
    return comp


def cached_map_computation(fetches, schema: Schema,
                           block_level: bool) -> Computation:
    """:func:`_map_computation`, reused per fetches object and schema."""
    return _cached(fetches, ("map", block_level), schema,
                   lambda: _map_computation(fetches, schema, block_level))


def cached_reduce_computation(fetches, value_schema: Schema,
                              suffixes: Sequence[str],
                              block_level: bool) -> Computation:
    """:func:`_reduce_computation`, reused per fetches object and schema."""
    return _cached(fetches, (tuple(suffixes), block_level), value_schema,
                   lambda: _reduce_computation(fetches, value_schema,
                                               suffixes, block_level))


# ---------------------------------------------------------------------------
# Schema validation (SchemaTransforms analogue)
# ---------------------------------------------------------------------------

def _validate_map(comp: Computation, schema: Schema, block_level: bool,
                  trim: bool) -> Schema:
    for spec in comp.inputs:
        field = schema.get(spec.name)
        if field is None:
            raise InputNotFoundError(
                f"Computation input {spec.name!r} found no matching column; "
                f"columns: {schema.names}")
        if field.dtype is not spec.dtype:
            raise InvalidTypeError(
                f"Column {spec.name!r} has type {field.dtype} but the "
                f"computation expects {spec.dtype}; no implicit casting is "
                f"performed")
        declared = _field_spec(field, block_level, "map")
        if not declared.is_more_precise_than(spec.shape) and \
                not spec.shape.is_more_precise_than(declared):
            raise InvalidShapeError(
                f"Column {spec.name!r} shape {declared} is incompatible "
                f"with computation input shape {spec.shape}")
    out_fields = []
    for spec in comp.outputs:  # already sorted by name
        if not trim and spec.name in schema:
            raise ValueError(
                f"Fetch name {spec.name!r} collides with an existing "
                f"column; fetch names must differ from all input columns")
        shape = spec.shape
        if block_level:
            if shape.ndim == 0:
                raise InvalidShapeError(
                    f"Fetch {spec.name!r} is a scalar; block-level outputs "
                    f"must have a leading row dimension")
            shape = shape.with_lead(Unknown)
        else:
            shape = shape.prepend(Unknown)
        out_fields.append(Field(spec.name, spec.dtype, block_shape=shape,
                                sql_rank=max(0, shape.ndim - 1)))
    if trim:
        return Schema(out_fields)
    return schema.append(out_fields)


def _validate_reduce(comp: Computation, schema: Schema,
                     suffixes: Sequence[str], rank_delta: int) -> None:
    """Check the reduce naming contract (reduceBlocksSchema /
    reduceRowsSchema analogue, ``DebugRowOps.scala:76-258``)."""
    fetch_names = set(comp.output_names)
    consumed = set()
    for spec in comp.inputs:
        base = _strip_suffix(spec.name, suffixes)
        if base is None or base not in fetch_names:
            raise InputNotFoundError(
                f"Reduce input {spec.name!r} does not correspond to any "
                f"fetch; fetches: {sorted(fetch_names)} with suffixes "
                f"{list(suffixes)}")
        field = schema.get(base)
        if field is None:
            raise InputNotFoundError(
                f"Reduce fetch {base!r} has no matching column; columns: "
                f"{schema.names}")
        if field.dtype is not spec.dtype:
            raise InvalidTypeError(
                f"Column {base!r} has type {field.dtype} but reduce input "
                f"{spec.name!r} expects {spec.dtype}")
        out_spec = comp.output(base)
        if out_spec.dtype is not spec.dtype:
            raise InvalidTypeError(
                f"Fetch {base!r} dtype {out_spec.dtype} differs from its "
                f"input {spec.name!r} dtype {spec.dtype}")
        if spec.shape.ndim != out_spec.shape.ndim + rank_delta:
            raise InvalidShapeError(
                f"Reduce input {spec.name!r} has rank {spec.shape.ndim}; "
                f"expected fetch rank + {rank_delta} = "
                f"{out_spec.shape.ndim + rank_delta}")
        consumed.add(base)
    for f in comp.output_names:
        missing = [f + s for s in suffixes if not any(
            i.name == f + s for i in comp.inputs)]
        if missing:
            raise InputNotFoundError(
                f"Fetch {f!r} is missing required reduce input(s) "
                f"{missing}")
    unused = [n for n in schema.names if n not in consumed]
    if unused:
        # the reference tolerates ride-along columns a reduction does not
        # consume (BasicOperationsSuite.scala:178-187: a string `key2`
        # rides along silently and reduce_sum over `x` returns Row(4.1)) —
        # match that contract, but with a warning instead of silence: an
        # unconsumed column in a reduce has repeatedly been a user bug in
        # the reference's own demos (geom_mean.py). The columns simply do
        # not appear in the result row.
        _log.warning(
            "Columns %s are not consumed by the reduction and will be "
            "ignored (select() the fetch-backing columns to silence this)",
            unused)


# ---------------------------------------------------------------------------
# pipelined streaming shared by the lazy block ops
# ---------------------------------------------------------------------------

def _stream_thunk(df: TensorFrame, ex, run_block, submit_block,
                  drain_block, tag: Optional[str] = None):
    """The lazy forcing every streaming op shares: blocks through the
    bounded in-flight window, drained FIFO. ``tag`` is the stream's stable
    identity for preemption checkpoints (:func:`_stream_tag`); ``None``
    makes the stream preemptible WITHOUT checkpointing."""
    return lambda: _pipeline.run_pipelined(
        df.blocks(), run_block, submit_block, drain_block,
        depth=_pipeline.stream_depth(ex), executor=ex, tag=tag)


def _stream_tag(op: str, comp, plan: str) -> str:
    """The checkpoint identity of one op stream: the op, the computation's
    input/output names, and the output frame's plan string. Two DIFFERENT
    sibling streams in one query must never share a tag and block count
    (a parked checkpoint restores only into its own stream,
    ``engine/preempt.py``)."""
    return (f"{op}[{','.join(comp.input_names)}->"
            f"{','.join(comp.output_names)}]{plan}")


def _drain_with(finish):
    """A drain half that passes finished Blocks through (empty/ragged
    blocks complete at submit) and finishes pendings with ``finish(b,
    host_out)``."""
    def drain_block(pending, b: Block) -> Block:
        if isinstance(pending, Block):
            return pending
        return finish(b, pending.drain())
    return drain_block


# ---------------------------------------------------------------------------
# map_blocks
# ---------------------------------------------------------------------------

def empty_schema_block(schema: Schema) -> Block:
    """A 0-row block of ``schema``, Unknown cell dims floored at 0 — the
    empty-partition construction."""
    cols: Dict[str, Column] = {}
    for f in schema:
        cell = f.cell_shape
        dims = tuple(0 if d == Unknown else d
                     for d in (cell.dims if cell else ()))
        cols[f.name] = np.empty((0,) + dims, f.dtype.np_storage)
    return Block(cols, 0)


def empty_fetch_columns(b: Block, outputs) -> Block:
    """A 0-row block: ``b``'s columns plus empty fetch columns built
    from row-level output specs — ``map_rows``' empty guard."""
    cols = dict(b.columns)
    for s in outputs:
        dims = tuple(0 if d == Unknown else d for d in s.shape.dims)
        cols[s.name] = np.empty((0,) + dims, s.dtype.np_storage)
    return Block(cols, 0)


def map_blocks(fetches: Fetches, df: TensorFrame, trim: bool = False,
               executor: Optional[BlockExecutor] = None) -> TensorFrame:
    """Transform a frame block-by-block, appending (or, with ``trim``,
    replacing with) the computation's outputs. Lazy."""
    ex = executor or default_executor()
    comp = cached_map_computation(fetches, df.schema, block_level=True)
    out_schema = _validate_map(comp, df.schema, block_level=True, trim=trim)
    in_names = comp.input_names
    fetch_names = comp.output_names
    _log.debug("map_blocks: inputs=%s fetches=%s trim=%s",
               in_names, fetch_names, trim)

    def empty_block() -> Block:
        return empty_schema_block(out_schema)

    def finish_block(b: Block, out: Dict[str, np.ndarray]) -> Block:
        lead = {out[f].shape[0] for f in fetch_names}
        if len(lead) > 1:
            raise InvalidShapeError(
                f"Fetches disagree on output row count: "
                f"{ {f: out[f].shape[0] for f in fetch_names} }")
        n_out = lead.pop()
        if not trim and n_out != b.num_rows:
            raise InvalidShapeError(
                f"map_blocks output has {n_out} rows for a {b.num_rows}-row "
                f"block; use trim=True for row-count-changing computations")
        if trim:
            return Block({f: out[f] for f in fetch_names}, n_out)
        cols = dict(b.columns)
        cols.update({f: out[f] for f in fetch_names})
        return Block(cols, b.num_rows)

    def run_block(b: Block) -> Block:
        if b.num_rows == 0:
            return empty_block()
        with span("map_blocks.block"):
            arrays = {n: b.dense(n) for n in in_names}
            out = ex.run(comp, arrays)
        return finish_block(b, out)

    def submit_block(b: Block):
        if b.num_rows == 0:
            return empty_block()  # finished: flows through the window
        arrays = {n: b.dense(n) for n in in_names}
        return _pipeline.submit(ex, comp, arrays)

    rows_h, bytes_h = propagate_hints(df, out_schema)
    plan_s = f"map_blocks({df._plan})"
    out = TensorFrame(out_schema,
                      _stream_thunk(df, ex, run_block, submit_block,
                                    _drain_with(finish_block),
                                    tag=_stream_tag("map_blocks", comp,
                                                    plan_s)),
                      df.num_partitions, plan=plan_s,
                      rows_hint=None if trim else rows_h,
                      bytes_hint=None if trim else bytes_h)
    if executor is None:
        # the logical-plan node; an explicit executor= pins the per-op
        # path, so no node is attached
        from ..plan.nodes import MapBlocksNode, attach, node_for
        attach(out, MapBlocksNode(node_for(df), out_schema, comp, trim))
    return out


# ---------------------------------------------------------------------------
# map_rows
# ---------------------------------------------------------------------------

def _vmapped(comp: Computation) -> Computation:
    """The row computation batched over a leading row dim with
    ``torch.func.vmap``, cached on the computation."""
    vcomp = getattr(comp, "_tft_vmapped", None)
    if vcomp is None:
        vcomp = Computation(
            lambda d: torch.func.vmap(comp.fn)(d),
            [TensorSpec(s.name, s.dtype, s.shape.prepend(Unknown))
             for s in comp.inputs],
            [TensorSpec(s.name, s.dtype, s.shape.prepend(Unknown))
             for s in comp.outputs])
        vcomp._tft_programs = comp._tft_programs
        vcomp._tft_vmap_of = comp  # its signature is derived from comp's
        with _comp_cache_lock:
            prior = getattr(comp, "_tft_vmapped", None)
            if prior is None:
                comp._tft_vmapped = vcomp
            else:
                vcomp = prior
    return vcomp


def map_rows(fetches: Fetches, df: TensorFrame,
             executor: Optional[BlockExecutor] = None) -> TensorFrame:
    """Transform a frame row-by-row, appending output columns. Lazy.

    Dense blocks take a vectorized path (``torch.func.vmap`` over the row
    dim, one call per block); blocks with ragged input columns group their
    rows by cell shape and run one vectorized call per distinct shape.
    """
    ex = executor or default_padding_executor()
    comp = cached_map_computation(fetches, df.schema, block_level=False)
    out_schema = _validate_map(comp, df.schema, block_level=False, trim=False)
    in_names = comp.input_names
    fetch_names = comp.output_names
    vcomp = _vmapped(comp)

    def attach_outputs(b: Block, out: Dict[str, np.ndarray]) -> Block:
        cols = dict(b.columns)
        cols.update({f: out[f] for f in fetch_names})
        return Block(cols, b.num_rows)

    def run_block(b: Block) -> Block:
        if b.num_rows == 0:
            return empty_fetch_columns(b, comp.outputs)
        dense = all(not b.is_ragged(n) for n in in_names)
        if dense:
            with span("map_rows.block_dense"):
                arrays = {n: b.dense(n) for n in in_names}
                out = ex.run(vcomp, arrays, row_local=True)
            return attach_outputs(b, out)
        # ragged: group rows by cell-shape signature and run ONE vmapped
        # call per distinct signature
        cells = {n: [np.asarray(b.columns[n][i]) for i in range(b.num_rows)]
                 for n in in_names}
        groups: Dict[Tuple, List[int]] = {}
        for i in range(b.num_rows):
            sig = tuple(cells[n][i].shape for n in in_names)
            groups.setdefault(sig, []).append(i)
        per_row: Dict[str, List[Optional[np.ndarray]]] = {
            f: [None] * b.num_rows for f in fetch_names}
        for idxs in groups.values():
            arrays = {}
            for n in in_names:
                # a signature group's cells share one shape: one threaded
                # native copy packs them into the stacked block
                grp = [cells[n][i] for i in idxs]
                values, _ = _native.pack_ragged(grp, dtype=grp[0].dtype)
                arrays[n] = values.reshape((len(idxs),) + grp[0].shape)
            out = ex.run(vcomp, arrays, row_local=True)
            for f in fetch_names:
                for j, i in enumerate(idxs):
                    per_row[f][i] = out[f][j]
        cols = dict(b.columns)
        for f in fetch_names:
            arrays = per_row[f]
            shapes = {a.shape for a in arrays}
            cols[f] = (np.stack(arrays) if len(shapes) == 1
                       else arrays)
        return Block(cols, b.num_rows)

    def submit_block(b: Block):
        # empty and ragged blocks run serially at submit and flow through
        # the window as finished Blocks; dense blocks pipeline.
        if b.num_rows == 0 or any(b.is_ragged(n) for n in in_names):
            return run_block(b)
        arrays = {n: b.dense(n) for n in in_names}
        return _pipeline.submit(ex, vcomp, arrays, row_local=True)

    rows_h, bytes_h = propagate_hints(df, out_schema)
    plan_s = f"map_rows({df._plan})"
    out = TensorFrame(out_schema,
                      _stream_thunk(df, ex, run_block, submit_block,
                                    _drain_with(attach_outputs),
                                    tag=_stream_tag("map_rows", comp,
                                                    plan_s)),
                      df.num_partitions, plan=plan_s,
                      rows_hint=rows_h, bytes_hint=bytes_h)
    if executor is None:
        from ..plan.nodes import MapRowsNode, attach, node_for
        attach(out, MapRowsNode(node_for(df), out_schema, comp, vcomp))
    return out


# ---------------------------------------------------------------------------
# filter_rows
# ---------------------------------------------------------------------------

def _filter_computation(predicate: Fetches, schema: Schema) -> Computation:
    """Build/validate a filter predicate: one rank-1 boolean/integer fetch
    over block-level columns (nonzero keeps the row)."""
    comp = cached_map_computation(predicate, schema, block_level=True)
    if len(comp.outputs) != 1:
        raise InvalidShapeError(
            f"filter predicate must produce exactly one fetch, got "
            f"{comp.output_names}")
    out_spec = comp.outputs[0]
    if len(out_spec.shape.dims) != 1:
        raise InvalidShapeError(
            f"filter predicate fetch {out_spec.name!r} must be a rank-1 "
            f"row mask, got shape {out_spec.shape}")
    if out_spec.dtype.np_storage.kind not in ("b", "i"):
        raise InvalidTypeError(
            f"filter predicate fetch {out_spec.name!r} must be boolean or "
            f"integer (nonzero keeps the row), got {out_spec.dtype.name}")
    return comp


def filter_rows(predicate: Fetches, df: TensorFrame,
                executor: Optional[BlockExecutor] = None) -> TensorFrame:
    """Keep the rows where ``predicate`` holds. Lazy.

    ``predicate`` follows the map-computation conventions (named args
    select columns) and must produce exactly ONE boolean/integer vector of
    block length; nonzero keeps the row. The schema is unchanged; every
    column (including non-tensor pass-through columns like strings) is
    masked.
    """
    ex = executor or default_executor()
    comp = _filter_computation(predicate, df.schema)
    in_names = comp.input_names
    pname = comp.output_names[0]

    def apply_mask(b: Block, out: Dict[str, np.ndarray]) -> Block:
        mask = np.asarray(out[pname]).astype(bool)
        if mask.shape != (b.num_rows,):
            raise InvalidShapeError(
                f"filter predicate produced shape {mask.shape} for a "
                f"{b.num_rows}-row block")
        keep = int(mask.sum())
        # feedback selectivity: the per-op path observes too, so chains
        # that never fuse still sharpen their plan estimates
        from ..plan.nodes import record_selectivity
        record_selectivity(comp, b.num_rows, keep)
        if keep == b.num_rows:
            return b
        cols: Dict[str, Column] = {}
        for n, c in b.columns.items():
            if isinstance(c, np.ndarray):
                cols[n] = c[mask]
            else:  # ragged / list-backed columns mask by index
                cols[n] = [c[i] for i in np.flatnonzero(mask)]
        return Block(cols, keep)

    def run_block(b: Block) -> Block:
        if b.num_rows == 0:
            return b
        with span("filter_rows.block"):
            arrays = {n: b.dense(n) for n in in_names}
            out = ex.run(comp, arrays)
        return apply_mask(b, out)

    def submit_block(b: Block):
        if b.num_rows == 0:
            return b
        arrays = {n: b.dense(n) for n in in_names}
        return _pipeline.submit(ex, comp, arrays)

    # the hint is an upper bound: a filter keeps at most its input
    rows_h, bytes_h = propagate_hints(df, df.schema)
    plan_s = f"filter_rows({df._plan})"
    out = TensorFrame(df.schema,
                      _stream_thunk(df, ex, run_block, submit_block,
                                    _drain_with(apply_mask),
                                    tag=_stream_tag("filter_rows", comp,
                                                    plan_s)),
                      df.num_partitions, plan=plan_s,
                      rows_hint=rows_h, bytes_hint=bytes_h)
    if executor is None:
        from ..plan.nodes import FilterNode, attach, node_for
        attach(out, FilterNode(node_for(df), df.schema, comp))
    return out


# ---------------------------------------------------------------------------
# reduce_blocks / reduce_rows
# ---------------------------------------------------------------------------

@traced_query("reduce_blocks")
def reduce_blocks(fetches: Fetches, df: TensorFrame,
                  executor: Optional[BlockExecutor] = None) -> Dict[str, np.ndarray]:
    """Reduce the whole frame to one row. Eager.

    Per-partition block-reduce, then one combine over the stacked partials
    (the combine order is unspecified by contract).
    """
    ex = executor or default_executor()
    comp = _reduce_computation(fetches, df.schema, ("_input",),
                               block_level=True)
    _validate_reduce(comp, df.schema, ("_input",), rank_delta=1)
    fetch_names = comp.output_names

    def block_arrays(b: Block) -> Dict[str, np.ndarray]:
        return {f + "_input": b.dense(f) for f in fetch_names}

    # empty-partition guard; per-partition partials stream through the
    # pipelined window like the map ops
    nonempty = [b for b in df.blocks() if b.num_rows > 0]
    with span("reduce_blocks.partials"):
        partials: List[Dict[str, np.ndarray]] = _pipeline.run_pipelined(
            nonempty,
            lambda b: ex.run(comp, block_arrays(b)),
            lambda b: _pipeline.submit(ex, comp, block_arrays(b)),
            lambda p, b: p.drain(),
            depth=_pipeline.stream_depth(ex), executor=ex,
            tag=_stream_tag("reduce_blocks", comp, f"({df._plan})"))
    if not partials:
        raise ValueError("reduce_blocks on an empty frame")
    if len(partials) == 1:
        return partials[0]
    with span("reduce_blocks.combine"):
        stacked = {f + "_input": np.stack([p[f] for p in partials])
                   for f in fetch_names}
        return ex.run(comp, stacked)


@traced_query("reduce_rows")
def reduce_rows(fetches: Fetches, df: TensorFrame,
                executor: Optional[BlockExecutor] = None) -> Dict[str, np.ndarray]:
    """Pairwise-reduce the whole frame to one row. Eager.

    Contract: for fetch ``z``, inputs ``z_1``/``z_2`` with z's shape/dtype;
    combine order unspecified. A dense partition folds on the device in one
    call, a Python loop over its rows where the JAX package uses
    ``lax.scan``; partials then fold pairwise across partitions.
    """
    ex = executor or default_executor()
    comp = _reduce_computation(fetches, df.schema, ("_1", "_2"),
                               block_level=False)
    _validate_reduce(comp, df.schema, ("_1", "_2"), rank_delta=0)
    fetch_names = comp.output_names

    def fold(d: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        carry = {f: d[f][0] for f in fetch_names}
        for i in range(1, d[fetch_names[0]].shape[0]):
            feeds = {f + "_1": carry[f] for f in fetch_names}
            feeds.update({f + "_2": d[f][i] for f in fetch_names})
            out = comp.fn(feeds)
            carry = {f: out[f] for f in fetch_names}
        return carry

    folder = Computation(
        fold,
        [TensorSpec(f, comp.output(f).dtype,
                    comp.output(f).shape.prepend(Unknown))
         for f in fetch_names],
        list(comp.outputs))
    folder._tft_programs = comp._tft_programs
    partials: List[Dict[str, np.ndarray]] = []
    for b in df.blocks():
        if b.num_rows == 0:
            continue
        dense = all(not b.is_ragged(f) for f in fetch_names)
        if dense:
            partials.append(ex.run(folder, {f: b.dense(f)
                                            for f in fetch_names}))
        else:
            acc = {f: np.asarray(b.columns[f][0]) for f in fetch_names}
            for i in range(1, b.num_rows):
                feeds = {f + "_1": acc[f] for f in fetch_names}
                feeds.update({f + "_2": np.asarray(b.columns[f][i])
                              for f in fetch_names})
                acc = ex.run(comp, feeds)
            partials.append(acc)
    if not partials:
        raise ValueError("reduce_rows on an empty frame")
    acc = partials[0]
    for p in partials[1:]:
        feeds = {f + "_1": acc[f] for f in fetch_names}
        feeds.update({f + "_2": p[f] for f in fetch_names})
        acc = ex.run(comp, feeds)
    return acc


# ---------------------------------------------------------------------------
# aggregate
# ---------------------------------------------------------------------------

class KeyFactorization(NamedTuple):
    """Dense-id view of (possibly multiple) scalar key columns: the
    shuffle's key→partition mapping of the reference (Catalyst groupBy)
    reduced to a host factorization — per-row VALUES never come through."""

    ids: np.ndarray            # [n] group index per input row
    uniques: List[np.ndarray]  # per key column: each group's key value
    num_groups: int
    order: np.ndarray          # [n] lexsort permutation (sorted-by-key)
    seg_starts: np.ndarray     # [num_groups] group start offsets in `order`


def _factorize_keys(key_arrays: Sequence[np.ndarray]) -> KeyFactorization:
    n = len(key_arrays[0])
    order = np.lexsort(tuple(reversed(tuple(key_arrays))))
    sorted_keys = [a[order] for a in key_arrays]
    changed = np.zeros(n, dtype=bool)
    changed[0] = True
    for a in sorted_keys:
        changed[1:] |= a[1:] != a[:-1]
    gidx_sorted = np.cumsum(changed) - 1
    ids = np.empty(n, np.int64)
    ids[order] = gidx_sorted
    uniques = [a[changed] for a in sorted_keys]
    return KeyFactorization(ids, uniques, int(gidx_sorted[-1]) + 1,
                            order, np.flatnonzero(changed))


def _blockwise_key_factorization(blocks, keys):
    """Global key→dense-id factorization WITHOUT concatenating the frame.

    The reference streamed partitions through the UDAF shuffle and never
    held the whole dataset in one buffer; ``Block.concat`` of the frame
    made host aggregation peak at ~3× the column bytes (round-3 weak #5).
    Instead: factorize each block locally (lexsort over that block only),
    merge the SMALL per-block unique-key tables into the global table,
    and remap each block's local ids. Peak extra memory is one block's
    sort copy plus the per-row id arrays (int32 where they fit).

    Returns ``(ids_blocks, uniques, num_groups)`` — one dense-id array
    per block (aligned with the block's rows), the global unique key
    columns (lexicographically sorted, the output key order), and the
    group count. Empty blocks get empty id arrays.
    """
    # per block keep ONLY (uniques, int32 local ids): a retained
    # KeyFactorization would pin its int64 ids AND order arrays (2x 8
    # bytes/row across all blocks — the very footprint this path removes)
    per_block = []
    for b in blocks:
        if b.num_rows == 0:
            per_block.append(None)
            continue
        f = _factorize_keys([b.dense(k) for k in keys])
        local_dt = np.int32 if f.num_groups < 2 ** 31 else np.int64
        per_block.append((f.uniques, f.ids.astype(local_dt)))
        del f
    nonempty = [p for p in per_block if p is not None]
    if not nonempty:
        return [np.empty(0, np.int64) for _ in blocks], \
            [np.empty(0) for _ in keys], 0
    if len(nonempty) == 1:
        uniques, ids = nonempty[0]
        return [ids if p is not None else np.empty(0, ids.dtype)
                for p in per_block], list(uniques), len(uniques[0])
    cat = [np.concatenate([u[i] for u, _ in nonempty])
           for i in range(len(keys))]
    gf = _factorize_keys(cat)  # tables only: small
    id_dt = np.int32 if gf.num_groups < 2 ** 31 else np.int64
    ids_blocks = []
    off = 0
    for i, p in enumerate(per_block):
        if p is None:
            ids_blocks.append(np.empty(0, id_dt))
            continue
        uniques_b, local_ids = p
        g = len(uniques_b[0])
        local_to_global = gf.ids[off:off + g].astype(id_dt)
        ids_blocks.append(local_to_global[local_ids])
        per_block[i] = None  # release the local ids as we go
        off += g
    return ids_blocks, list(gf.uniques), gf.num_groups


def _fact_from_global_ids(ids: np.ndarray) -> KeyFactorization:
    """A KeyFactorization over PRE-ASSIGNED global group ids (one block's
    rows): segments are the groups present in the block, ``uniques[0]``
    their GLOBAL ids, while ``.ids`` are re-densified LOCAL ids (0..G_b-1)
    — consumers scatter into [G_b]-sized tables."""
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    changed = np.zeros(len(ids), dtype=bool)
    changed[0] = True
    changed[1:] = sorted_ids[1:] != sorted_ids[:-1]
    starts = np.flatnonzero(changed)
    dense_sorted = np.cumsum(changed) - 1
    dense = np.empty(len(ids), dense_sorted.dtype)
    dense[order] = dense_sorted
    return KeyFactorization(dense, [sorted_ids[starts]], len(starts),
                            order, starts)


def _check_scalar_keys(blocks, keys: Sequence[str]) -> None:
    for b in blocks:
        for k in keys:
            if b.num_rows and (b.is_ragged(k) or b.dense(k).ndim != 1):
                raise InvalidTypeError(
                    f"Key column {k!r} must be scalar-typed")


_COMBINERS = ("sum", "min", "max", "prod")


def _is_sketch(c) -> bool:
    from ..relational.sketch import SketchCombiner
    return isinstance(c, SketchCombiner)


def _monoid_mapping(fetches) -> bool:
    """True for the ``{column: combiner}`` aggregate form: combiner names
    (sum/min/max/prod) or :class:`~..relational.sketch.SketchCombiner`
    instances (approx_distinct / approx_quantile / approx_top_k), freely
    mixed."""
    return (isinstance(fetches, Mapping) and bool(fetches)
            and all(isinstance(v, str) or _is_sketch(v)
                    for v in fetches.values()))


def _validate_monoid_fetches(col_combiners: Mapping[str, str],
                             value_names: Sequence[str],
                             drop_hint: str,
                             schema: Optional[Schema] = None) -> None:
    """Checks for the {column: combiner} aggregate form. Combiners are
    scalar names or sketch combiners; ``schema`` (when given) lets
    sketches validate their input column."""
    unknown = sorted(set(col_combiners) - set(value_names))
    if unknown:
        raise InputNotFoundError(
            f"Aggregate fetches {unknown} match no value column; value "
            f"columns: {list(value_names)}")
    unused = [n for n in value_names if n not in col_combiners]
    if unused:
        # same ride-along tolerance as _validate_reduce: columns no fetch
        # consumes drop out of the result, with a warning
        _log.warning(
            "Columns %s are not consumed by the aggregation and will be "
            "ignored (drop them %s to silence this)", unused, drop_hint)
    for name, cname in col_combiners.items():
        if _is_sketch(cname):
            if schema is not None:
                cname.validate_input(schema[name])
            continue
        if cname not in _COMBINERS:
            raise ValueError(
                f"Unknown combiner {cname!r} for {name!r}; known: "
                f"{sorted(_COMBINERS)} (or a relational sketch combiner — "
                f"approx_distinct/approx_quantile/approx_top_k)")


def _identity(cname: str, dtype: torch.dtype):
    """The neutral element a segment min/max/prod leaves in a group that
    has no rows: what makes the blockwise combine exact."""
    if cname == "prod":
        return 1
    info = torch.finfo(dtype) if dtype.is_floating_point \
        else torch.iinfo(dtype)
    if cname == "min":
        return float("inf") if dtype.is_floating_point else info.max
    return float("-inf") if dtype.is_floating_point else info.min


# Segment reductions for the monoid combiner names. "sum" goes through
# ops/segment_reduce.py (the CUDA kernel for float values on a GPU); min,
# max and prod are scatter_reduce_ on an output pre-filled with the
# combiner's identity, as the JAX package leaves them to XLA's segment ops.
def _segment_reduce(cname: str, values: torch.Tensor, ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    if cname == "sum":
        return _segment_sum(values, ids, num_segments)
    out = torch.full((num_segments,) + tuple(values.shape[1:]),
                     _identity(cname, values.dtype), dtype=values.dtype,
                     device=values.device)
    idx = ids.long().reshape((-1,) + (1,) * (values.dim() - 1))
    out.scatter_reduce_(0, idx.expand_as(values), values,
                        reduce={"min": "amin", "max": "amax",
                                "prod": "prod"}[cname],
                        include_self=True)
    return out


def _monoid_aggregate(col_combiners: Mapping[str, str],
                      grouped: GroupedFrame, ex: BlockExecutor) -> TensorFrame:
    """Keyed aggregation for the associative monoids: key->dense-id
    factorization on the host, then ONE segment reduction per block and
    fetch column on the device, the per-block partials combined on the
    host with the monoid.

    Sketch combiners ride the same structure: per-block partial STATE
    tables (group ids shared with the scalar columns; HLL registers and
    quantile bucket counts fold on the device from 4,096 rows) combined
    across blocks with the sketch's own monoid and finalized into
    estimate columns at the end."""
    df = grouped.frame
    keys = grouped.keys
    value_names = [n for n in df.schema.names if n not in keys]
    _validate_monoid_fetches(col_combiners, value_names,
                             "with select() first", schema=df.schema)

    blocks = df.blocks()
    _check_scalar_keys(blocks, keys)
    fetch_names = sorted(col_combiners)
    scalar_names = [f for f in fetch_names
                    if not _is_sketch(col_combiners[f])]
    sketch_names = [f for f in fetch_names if _is_sketch(col_combiners[f])]
    out_fields = [df.schema[k] for k in keys]
    for f in fetch_names:
        if f in sketch_names:
            out_fields.extend(col_combiners[f].out_fields(f, df.schema[f]))
            continue
        out_fields.append(Field(
            f, df.schema[f].dtype,
            block_shape=_field_spec(df.schema[f], True, "aggregate")
            .with_lead(Unknown),
            sql_rank=df.schema[f].sql_rank))
    n = sum(b.num_rows for b in blocks)
    if n == 0:
        return TensorFrame.from_blocks(
            [Block({f.name: np.empty(
                (0,) + tuple(d for d in (f.cell_shape.dims
                                         if f.cell_shape else ())
                             if d != Unknown),
                f.dtype.np_storage) for f in out_fields}, 0)],
            Schema(out_fields))

    device = ex.resolve()
    with span("aggregate.factorize_keys"):
        ids_blocks, uniques, num_groups = _blockwise_key_factorization(
            blocks, keys)
    combine_np = {"sum": np.add, "prod": np.multiply,
                  "min": np.minimum, "max": np.maximum}
    cols: Dict[str, np.ndarray] = {k: u for k, u in zip(keys, uniques)}
    mem_mgr = _memory.active()
    with span("aggregate.sketch_fold"):
        for f in sketch_names:
            sk = col_combiners[f]
            table = None
            for b, ids in zip(blocks, ids_blocks):
                if b.num_rows == 0:
                    continue
                vals = np.asarray(b.columns[f])
                mem_tok = (mem_mgr.reserve(
                    2 * int(vals.nbytes) + int(ids.nbytes),
                    op="aggregate.sketch_fold")
                    if mem_mgr is not None else 0)
                try:
                    part = sk.block_partial(vals, ids, num_groups,
                                            device=device)
                finally:
                    if mem_tok:
                        mem_mgr.release(mem_tok)
                table = part if table is None else sk.combine_np(table, part)
            counters.inc("relational.sketch_folds")
            cols.update(sk.finalize(f, table))
    with span("aggregate.segment_reduce"):
        for f in scalar_names:
            field = df.schema[f]
            dd = _dt.device_dtype(field.dtype)
            out = None
            for b, ids in zip(blocks, ids_blocks):
                if b.num_rows == 0:
                    continue
                vals = to_device(b.dense(f), dd, device)
                part = to_host(_segment_reduce(
                    col_combiners[f], vals,
                    torch.as_tensor(ids, device=device), num_groups))
                # groups absent from a block hold the combiner's neutral
                # element, so the pairwise combine is exact
                out = part if out is None \
                    else combine_np[col_combiners[f]](out, part)
            cols[f] = to_storage_dtype(out, field.dtype)
    return TensorFrame.from_blocks([Block(cols, num_groups)],
                                   Schema(out_fields))


class FoldBatchingError(RuntimeError):
    """A computation-form ``aggregate`` program that ``torch.func.vmap``
    cannot batch, so the segmented fold cannot run it."""


def _fold_call(fn, comp, *args):
    """One vmapped call of the fold (``aggregate.fold_calls``). A failure
    to batch names the program and the fold; an OOM and a kernel's own
    failure pass through as they are."""
    from ..resilience import KernelError, is_oom
    counters.inc("aggregate.fold_calls")
    try:
        return fn(*args)
    except (RuntimeError, NotImplementedError, TypeError) as e:
        if is_oom(e) or isinstance(e, KernelError):
            raise
        raise FoldBatchingError(
            f"aggregate's segmented fold runs {comp!r} on two-row blocks "
            f"batched with torch.func.vmap, which failed: "
            f"{type(e).__name__}: {e}") from e


def _segmented_scan(op, sid: torch.Tensor, vals: Dict[str, torch.Tensor]):
    """Inclusive scan of ``op`` over ``(sid, vals)`` along the rows, with
    the odd/even recursion of ``jax.lax.associative_scan`` level for
    level: combine adjacent pairs, scan the result, then fill in the
    even positions. The partials meet in the JAX package's tree, so f64
    results agree to rounding; O(log rows) levels of two calls each."""
    n = sid.shape[0]
    if n < 2:
        return sid, vals
    r_id, r_v = op((sid[0:-1:2], {f: v[0:-1:2] for f, v in vals.items()}),
                   (sid[1::2], {f: v[1::2] for f, v in vals.items()}))
    o_id, o_v = _segmented_scan(op, r_id, r_v)
    if n % 2 == 0:
        a = (o_id[:-1], {f: v[:-1] for f, v in o_v.items()})
    else:
        a = (o_id, o_v)
    e_id, e_v = op(a, (sid[2::2], {f: v[2::2] for f, v in vals.items()}))

    def interleave(first, even, odd):
        dt = torch.promote_types(torch.promote_types(first.dtype, even.dtype),
                                 odd.dtype)
        out = torch.empty((n,) + tuple(first.shape[1:]), dtype=dt,
                          device=first.device)
        out[0:1] = first[0:1]
        out[2::2] = even
        out[1::2] = odd
        return out

    return (interleave(sid, e_id, o_id),
            {f: interleave(vals[f], e_v[f], o_v[f]) for f in vals})


def _fold_functions(comp: Computation, names):
    """The segmented fold's pieces for a computation-form reduce over the
    fetches ``names``: ``pair_v`` (the program on stacked two-row blocks,
    batched with ``torch.func.vmap``), ``single_v`` (on one-row blocks)
    and ``op``, the segmented scan's operator, which combines two
    elements where their group ids agree. The mesh fold
    (``parallel/distributed.py``) shares them."""

    def pair(av, bv):
        out = comp.fn({f + "_input": torch.stack([av[f], bv[f]])
                       for f in names})
        return {f: out[f] for f in names}

    def single(av):
        out = comp.fn({f + "_input": av[f][None] for f in names})
        return {f: out[f] for f in names}

    pair_v = torch.func.vmap(pair)
    single_v = torch.func.vmap(single)

    def op(a, b):
        a_id, a_v = a
        b_id, b_v = b
        if b_id.shape[0] == 0:
            return b_id, b_v
        same = a_id == b_id
        comb = _fold_call(pair_v, comp, a_v, b_v)
        out_v = {}
        for f in names:
            m = same.reshape((-1,) + (1,) * (comb[f].ndim - 1))
            out_v[f] = torch.where(m, comb[f], b_v[f])
        return b_id, out_v

    return pair_v, single_v, op


def _aggregate_segmented_fold(comp: Computation, fetch_names, fetch_blocks,
                              fact: KeyFactorization, schema: Schema,
                              executor: BlockExecutor
                              ) -> Dict[str, np.ndarray]:
    """All groups of one block (rows sorted by key) folded at once.

    Per group: the fold of the user computation over its contiguous rows
    by a segmented inclusive scan whose operator applies the program to
    two-row blocks (``pair``, batched with ``torch.func.vmap``), the
    segment tail scattered into a ``[G, ...]`` table, then one
    application over each group's one-row block (``single``): the
    semantics of the ``CompactionBuffer`` path under the
    algebraic-regrouping contract, at O(log rows) vmapped calls instead
    of one call per chunk of every group. Plain torch on the executor's
    device; the block's fetch columns go there once, in their device
    dtypes. A program that vmap cannot batch raises
    :class:`FoldBatchingError`.
    """
    names = sorted(fetch_names)
    G = len(fact.seg_starts)
    device = executor.resolve()
    ids_sorted = np.asarray(fact.ids)[np.asarray(fact.order)]
    sid = torch.as_tensor(ids_sorted.astype(np.int64), device=device)
    dev = {f: to_device(fetch_blocks[f], _dt.device_dtype(schema[f].dtype),
                        device) for f in names}
    if comp._tft_programs:
        executor._prepare(comp, {f + "_input": v for f, v in dev.items()})

    _, single_v, op = _fold_functions(comp, names)
    mem_mgr = _memory.active()
    mem_tok = (mem_mgr.reserve(
        2 * sum(int(v.numel() * v.element_size()) for v in dev.values())
        + int(sid.numel() * sid.element_size()),
        op="aggregate.segmented_fold") if mem_mgr is not None else 0)
    try:
        with span("aggregate.segmented_fold"), torch.no_grad():
            _, scanned = _segmented_scan(op, sid, dev)
            tail = torch.ones_like(sid, dtype=torch.bool)
            tail[:-1] = sid[1:] != sid[:-1]
            tail_ids = sid[tail]
            table = {}
            for f in names:
                z = torch.zeros((G,) + tuple(scanned[f].shape[1:]),
                                dtype=scanned[f].dtype, device=device)
                z[tail_ids] = scanned[f][tail]
                table[f] = z
            final = _fold_call(single_v, comp, table)
            cols = {f: to_storage_dtype(to_host(final[f]), schema[f].dtype)
                    for f in names}
    finally:
        if mem_tok:
            mem_mgr.release(mem_tok)
    return cols


@traced_query("aggregate")
def aggregate(fetches: Fetches, grouped: GroupedFrame,
              buffer_size: int = DEFAULT_BUFFER_SIZE,
              executor: Optional[BlockExecutor] = None) -> TensorFrame:
    """Algebraic keyed aggregation: for each distinct key, reduce the
    group's rows with the fetch computation (reduce_blocks contract).

    Two paths:

    - ``fetches`` is a mapping ``{column: combiner-name}`` (sum/min/max/
      prod, or a sketch combiner of ``relational``): host key
      factorization + one segment reduction per block and column on the
      device (the CUDA ``segment_sum`` kernel for float sums on a GPU);
    - ``fetches`` is a computation: each block is sorted by key on the
      host and all its groups fold at once on the device
      (:func:`_aggregate_segmented_fold`, O(log rows) vmapped calls of
      the program); under an executor of another kind than the default
      each group reduces through a :class:`CompactionBuffer` honoring
      the buffered-compaction contract (buffer_size=10 by default). The
      per-block partials combine through the same machinery.
    """
    ex = executor or default_executor()
    if _monoid_mapping(fetches):
        return _monoid_aggregate(fetches, grouped, ex)
    df = grouped.frame
    keys = grouped.keys
    value_schema = df.schema.select(
        [n for n in df.schema.names if n not in keys])
    comp = cached_reduce_computation(fetches, value_schema, ("_input",),
                                     block_level=True)
    _validate_reduce(comp, value_schema, ("_input",), rank_delta=1)
    fetch_names = comp.output_names

    def reduce_fn(block: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        counters.inc("aggregate.buffer_calls")
        return ex.run(comp, {f + "_input": block[f] for f in fetch_names})

    blocks = df.blocks()
    _check_scalar_keys(blocks, keys)

    n = sum(b.num_rows for b in blocks)
    out_fields = [df.schema[k] for k in keys] + [
        Field(s.name, s.dtype,
              block_shape=s.shape.prepend(Unknown),
              sql_rank=s.shape.ndim)
        for s in comp.outputs]
    if n == 0:
        return TensorFrame.from_blocks(
            [Block({f.name: np.empty((0,), f.dtype.np_storage)
                    for f in out_fields}, 0)], Schema(out_fields))

    # blockwise "shuffle": each block is sorted by GLOBAL group id and
    # reduced to one partial row per group present in it; the per-block
    # partials then combine through one more pass of the same machinery
    # (legal under the algebraic-regrouping contract)
    with span("aggregate.factorize_keys"):
        ids_blocks, uniques, num_groups = _blockwise_key_factorization(
            blocks, keys)
    # the fold calls the program itself on the executor's device, so it
    # replaces the per-group dispatches only when the effective executor
    # is exactly the default kind; an executor of another kind keeps the
    # CompactionBuffer path, so the program runs through that executor.
    # Deserialized programs take the fold too: the port vmaps a placed
    # program (the JAX package's exported.call has no batching rule)
    use_fold = type(ex) is BlockExecutor

    def block_partials(fetch_b, fact_b):
        """One partial row per group present, in segment order."""
        if use_fold:
            return _aggregate_segmented_fold(comp, fetch_names, fetch_b,
                                             fact_b, df.schema, ex)
        # CompactionBuffer path: each segment is ingested in power-of-two
        # chunks (capped), so a group costs O(rows/cap + log rows) reduce
        # calls; the buffer still compacts every ``buffer_size`` partials
        seg_starts = fact_b.seg_starts
        seg_ends = np.append(seg_starts[1:], len(fact_b.ids))
        chunk_cap = 1 << 16
        out_rows: Dict[str, List[np.ndarray]] = {f: [] for f in
                                                 fetch_names}
        for a, bnd in zip(seg_starts, seg_ends):
            buf = CompactionBuffer(fetch_names, reduce_fn, buffer_size)
            c, rem = a, bnd - a
            while rem >= chunk_cap:
                buf.update_block({f: fetch_b[f][c:c + chunk_cap]
                                  for f in fetch_names}, chunk_cap)
                c += chunk_cap
                rem -= chunk_cap
            p = chunk_cap >> 1
            while rem:
                if rem >= p:
                    buf.update_block({f: fetch_b[f][c:c + p]
                                      for f in fetch_names}, p)
                    c += p
                    rem -= p
                p >>= 1
            result = buf.evaluate()
            for f in fetch_names:
                out_rows[f].append(result[f])
        return {f: np.stack(out_rows[f]) for f in fetch_names}

    partial_gids: List[np.ndarray] = []
    partial_rows: Dict[str, List[np.ndarray]] = {f: [] for f in
                                                 fetch_names}
    for b, ids in zip(blocks, ids_blocks):
        if b.num_rows == 0:
            continue
        with span("aggregate.sort_block"):
            fact_b = _fact_from_global_ids(ids)
            fetch_b = {f: _native.gather_rows(b.dense(f), fact_b.order)
                       for f in fetch_names}
        cols_b = block_partials(fetch_b, fact_b)
        partial_gids.append(fact_b.uniques[0])
        for f in fetch_names:
            partial_rows[f].append(cols_b[f])

    if len(partial_gids) == 1:
        cols = {f: partial_rows[f][0] for f in fetch_names}
    else:
        ids2 = np.concatenate(partial_gids)
        fact2 = _fact_from_global_ids(ids2)
        fetch2 = {f: np.concatenate(partial_rows[f])[fact2.order]
                  for f in fetch_names}
        cols = block_partials(fetch2, fact2)

    for k, u in zip(keys, uniques):
        cols[k] = u
    return TensorFrame.from_blocks([Block(cols, num_groups)],
                                   Schema(out_fields))
