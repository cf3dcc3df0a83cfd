"""Plan executor: run an :class:`~.optimize.ExecPlan` block by block.

The port's counterpart of ``tensorframes_tpu/plan/execute.py``, with its
execution contract (what makes fused == unfused bit-identical):

- every fused program dispatches through the process-default executor
  the per-op path uses, at the exact block shape, with the same retry
  loop and fault sites: a FIRST stage of map_rows only (row-local by
  construction) dispatches with ``row_local=True``, like its per-op twin,
  so a block that runs out of device memory splits itself in half inside
  the fused stage; any other stage is not row-local (``_stage_executor``,
  the JAX package's choice);
- the FIRST stage pipelines through the executor's submit/drain halves
  (``engine/pipeline.run_pipelined``); later stages run inside the drain
  on the first stage's outputs, which stay DEVICE-resident
  (``keep_device=True``); the storage-dtype host round trip they skip is
  value-exact, and the final stage converts to storage dtypes with the
  executor's own rules;
- filter masks are computed inside the fused program and come to the
  host at the stage boundary; host columns are masked there, resident
  columns gathered on the device;
- 0-row blocks (empty partitions, filters that drop everything, row
  groups the scan refuted) replay the per-op chain's EMPTY-block
  semantics op by op on the host, so even degenerate shapes/dtypes match
  the unfused path exactly;
- a runtime condition the optimizer could not see (a ragged column
  feeding a program) abandons the plan BEFORE any work and returns
  ``None``: the caller then runs the unchanged per-op thunk;
- an out-of-memory failure a fused stage could not split
  (``resilience.is_oom``: ``torch.cuda.OutOfMemoryError``, a host
  ``MemoryError``, the TPU's and cuBLAS's status words) hands the forcing
  back to the per-op path (``plan.oom_fallbacks`` and a
  ``plan.oom_fallback`` flight record), whose op-granular dispatches may
  fit or split; any other error propagates;
- ``faults.slowdown("perf")`` sleeps inside the timed forcing when the
  ``perf`` site is armed;
- the fused stream carries a stable tag (:func:`_plan_tag`: the leaf,
  the op kinds, the columns read and the output schema), so that a
  preempted fused chain parks a checkpoint and resumes from it; a resume
  whose forcing took another path discards it;
- a row-local chain (``ExecPlan.row_local_chain``) runs inside the
  row-conservation ledger of ``resilience/invariants.py``: rows in ==
  rows out + rows its filters masked out.

With ``TFT_ADAPTIVE`` on (the default), a row-local chain outside a
preemption scope may run a re-bucketed layout (``plan/adaptive.py``'s
``choose_layout``, fed by the feedback every forcing records): coalesced
or split units stream through the same stages, an int32 vector of each
row's original block rides through every mask, and the outputs are
re-split on the original boundaries (:func:`_restore_layout`), so the
result is bit-identical to the static layout, boundaries included. After
the first unit, a filter whose observed selectivity strays past
``TFT_REPLAN_RATIO`` from what the plan priced re-plans the remaining
units (:func:`_should_replan`, ``plan.replans``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..engine import preempt as _preempt
from ..engine.executor import default_executor, to_host, to_storage_dtype
from ..observability import flight as _flight
from ..resilience import faults as _faults
from ..resilience import invariants as _invariants
from ..resilience import is_oom
from ..shape import Unknown
from ..utils.logging import get_logger
from ..utils.tracing import counters, span
from .optimize import MASK, ExecPlan, build_plan

__all__ = ["maybe_run"]

_log = get_logger("plan.execute")


def maybe_run(frame) -> Optional[List]:
    """Force ``frame`` through its optimized plan; ``None`` defers to
    the per-op thunk (fusion off, unplannable chain, ragged inputs).

    Plan BUILD problems are never fatal (unplanned, not failed);
    execution errors propagate (out of the same resilient executors the
    per-op path uses, after the same recovery attempts), except an OOM
    the fused stage could not split, which falls back to the per-op path.
    """
    try:
        plan = build_plan(frame)
    except Exception as e:  # noqa: BLE001 - unplannable means per-op
        _log.debug("plan build failed (%s: %s); using the per-op path",
                   type(e).__name__, e)
        plan = None
    if plan is None:
        frame._plan_info = None
        return None
    leaf = plan.leaf
    if leaf.kind == "parquet":
        leaf_blocks = leaf.read_blocks(plan.leaf_required,
                                       atoms=plan.scan_atoms)
    else:
        if leaf.kind == "join":
            # pruning reaches INTO the join: only the columns this chain
            # needs are gathered and materialized
            leaf_blocks = leaf.read_blocks(plan.leaf_required)
        else:
            leaf_blocks = leaf.frame.blocks()
        for b in leaf_blocks:
            for n in plan.scan_names:
                if b.num_rows and b.is_ragged(n):
                    # ragged computation inputs belong to the per-op
                    # path (map_rows' per-signature grouping)
                    frame._plan_info = None
                    return None
    try:
        with span("plan.execute"):
            blocks = _run(plan, leaf_blocks, frame)
    except Exception as e:
        if not is_oom(e):
            raise
        error = type(e).__name__
    else:
        counters.inc("plan.fused_queries")
        frame._plan_info = plan.describe()
        return blocks
    # outside the handler, so the failed forcing's tensors are gone before
    # the per-op path runs: stages that are not row-local cannot split an
    # OOM'd fused dispatch, and the per-op path's smaller ones may fit
    counters.inc("plan.oom_fallbacks")
    _flight.record("plan.oom_fallback", error=error)
    _log.warning("fused plan hit an OOM its stage could not split (%s); "
                 "re-running through the per-op path", error)
    frame._plan_info = None
    return None


# ---------------------------------------------------------------------------
# empty-block replay (per-op semantics, host-only)
# ---------------------------------------------------------------------------

def _empty_chain(ops, b):
    """Apply each op's per-op EMPTY-block behavior to a 0-row block —
    delegating to the ops module's own constructions so the two paths
    can never drift."""
    from ..engine.ops import empty_fetch_columns, empty_schema_block
    for o in ops:
        if o.kind == "select":
            b = b.select(list(o.names))
        elif o.kind == "filter":
            pass  # per-op filter returns 0-row blocks unchanged
        elif o.kind == "map_blocks":
            b = empty_schema_block(o.schema)
        else:  # map_rows appends empty fetch columns
            b = empty_fetch_columns(b, o.comp.outputs)
    return b


# ---------------------------------------------------------------------------
# value plumbing
# ---------------------------------------------------------------------------

def _mask_value(v, mask: np.ndarray, dev_mask: torch.Tensor):
    if isinstance(v, np.ndarray):
        return v[mask]
    if isinstance(v, torch.Tensor):
        return v[dev_mask]  # device gather; stays resident
    return [v[i] for i in np.flatnonzero(mask)]  # ragged / list-backed


def _to_storage(v, field) -> object:
    """The executor's convert-back rules for one final column (host
    values pass through untouched, like per-op passthrough)."""
    if isinstance(v, (np.ndarray, list)):
        return v
    return to_storage_dtype(to_host(v), field.dtype)


def _env_to_block(env: Dict[str, object], schema, num_rows: int):
    """A boundary-schema block from the (possibly pruned) env. Pruned
    columns are rebuilt empty from their field spec — only legal at 0
    rows, where the per-op path's own empty reconstruction does the
    same; a pruned column can never reach the final schema."""
    from ..frame import Block
    cols = {}
    for f in schema:
        if f.name in env:
            cols[f.name] = _to_storage(env[f.name], f)
        else:
            cell = f.cell_shape
            dims = tuple(0 if d == Unknown else d
                         for d in (cell.dims if cell else ()))
            cols[f.name] = np.empty((0,) + dims, f.dtype.np_storage)
    return Block(cols, num_rows)


def _final_block(plan: ExecPlan, env: Dict[str, object], n_rows: int):
    from ..frame import Block
    cols = {}
    for f in plan.final_schema:
        cols[f.name] = _to_storage(env[f.name], f)
    if cols:
        first = next(iter(cols.values()))
        n_rows = len(first)
    return Block(cols, n_rows)


# ---------------------------------------------------------------------------
# stage execution
# ---------------------------------------------------------------------------

def _mask_counts(counts: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The rows of each consecutive piece of ``counts`` rows that
    ``mask`` keeps."""
    bounds = np.concatenate(([0], np.cumsum(counts)))
    return np.array([np.count_nonzero(mask[lo:hi])
                     for lo, hi in zip(bounds[:-1], bounds[1:])], np.int64)


def _apply_stage_result(plan, st, env, out, n_rows, aux=None):
    """Merge a stage's outputs into a fresh env; apply the mask. Returns
    ``(env, n_rows, short_circuit_block, aux)`` — the block is non-None
    when the mask dropped every row and the rest of the chain replays the
    empty-block semantics. ``aux`` is the adaptive layout's rows per
    original block (:func:`_mask_counts`), counted through each mask so
    the final outputs can be re-split on the original block boundaries;
    ``None`` (the static layout) passes through."""
    new_env = {n: env[n] for n in st.passthrough}
    new_env.update({n: out[n] for n in st.outputs})
    if st.mask:
        raw = out[MASK]
        mask = (to_host(raw) if isinstance(raw, torch.Tensor)
                else np.asarray(raw)).astype(bool)
        keep = int(mask.sum())
        # feedback selectivity: the forced filter's observed rows-in /
        # rows-out sharpen PlanNode.estimate() for later forcings of the
        # same predicate
        fnode = plan.ops[st.op_end]
        if fnode.kind == "filter":
            from .nodes import record_selectivity
            record_selectivity(fnode.comp, mask.size, keep)
        # row-conservation ledger: the masked-out rows are FILTERED, not
        # lost (noted before the keep == 0 short-circuit, so that a
        # drop-everything mask balances too)
        _invariants.note_filtered(mask.size - keep)
        dev_mask = raw.bool() if isinstance(raw, torch.Tensor) else None
        if keep == 0:
            empty = {k: _mask_value(v, mask, dev_mask)
                     for k, v in new_env.items()}
            bb = _env_to_block(empty, st.boundary_schema, 0)
            if aux is not None:
                aux = np.zeros_like(aux)
            return None, 0, _empty_chain(plan.ops[st.op_end + 1:], bb), aux
        # compare against the MASK length, not the stage-input row
        # count: a trim member inside the stage may have changed the
        # row count before the predicate ran
        if keep != mask.size:
            new_env = {k: _mask_value(v, mask, dev_mask)
                       for k, v in new_env.items()}
            if aux is not None:
                aux = _mask_counts(aux, mask)
        n_rows = keep
    return new_env, n_rows, None, aux


def _stage_executor(st, first: bool = True):
    """``(executor, row_local)`` of a stage, the per-op choice: a FIRST
    stage of map_rows only is row-local (and with it gets the OOM row
    split: rows are independent under vmap); any other stage is not, like
    its per-op twin.

    Later stages are never row-local, as in the JAX package (there only
    the first stage, fed by host rows, runs on the padding executor)."""
    return default_executor(), bool(st.row_local and first)


def _run_rest(plan: ExecPlan, env: Dict[str, object], n_rows: int,
              start: int, aux=None):
    """Stages ``start..`` over an env, device-resident between stages.
    Returns ``(final block, aux)``."""
    for si in range(start, len(plan.stages)):
        st = plan.stages[si]
        ex, row_local = _stage_executor(st, first=si == 0)
        out = ex.run(st.comp, {n: env[n] for n in st.inputs},
                     row_local=row_local, keep_device=True)
        env, n_rows, short, aux = _apply_stage_result(plan, st, env, out,
                                                      n_rows, aux)
        if short is not None:
            return short, aux
    return _final_block(plan, env, n_rows), aux


def _full_leaf_empty(plan: ExecPlan, b):
    """A 0-row leaf block widened back to the FULL leaf schema: column
    pruning may have dropped columns the per-op empty replay's selects
    still name (pruned columns can never reach the final schema, so
    their spec-derived empty dims are unobservable)."""
    from ..frame import Block
    if all(f.name in b.columns for f in plan.leaf.schema):
        return b
    from ..engine.ops import empty_schema_block
    cols = dict(empty_schema_block(plan.leaf.schema).columns)
    cols.update(b.columns)  # keep the actually-decoded empties
    return Block(cols, 0)


def _plan_tag(plan: ExecPlan) -> str:
    """Stable stream identity of a plan shape: preemption checkpoints key
    on it, and the adaptive feedback registry correlates repeated
    forcings of the same chain by it."""
    return (f"plan[{plan.leaf.describe()};"
            f"{','.join(o.kind for o in plan.ops)};"
            f"{sorted(plan.leaf_required)}]"
            f"({plan.final_schema.names})")


def _run(plan: ExecPlan, leaf_blocks, frame=None) -> List:
    from ..engine import pipeline as _pipeline
    from . import adaptive as _adaptive
    if not plan.stages:
        # pure projection over a pruned scan: no device work at all
        out = []
        for b in leaf_blocks:
            if b.num_rows == 0:
                out.append(_empty_chain(plan.ops,
                                        _full_leaf_empty(plan, b)))
            else:
                env = {n: b.columns[n] for n in plan.leaf_required}
                out.append(_final_block(plan, env, b.num_rows))
        return out
    tag = _plan_tag(plan)
    layout = None
    if _adaptive.enabled() and plan.row_local_chain \
            and _preempt.current_scope() is None and leaf_blocks:
        # re-bucket the stream to TFT_PIPELINE_DEPTH full slots within
        # the ledger's headroom; outputs are re-split on the original
        # block boundaries. Not under a preemption scope, whose
        # checkpoint tags pin the block count
        layout = _adaptive.choose_layout(
            plan, leaf_blocks, _pipeline.pipeline_depth(None), tag)
    t0 = time.perf_counter()
    # the perf drill's slowdown lands inside the timed forcing
    _faults.slowdown("perf")
    rows_in = sum(b.num_rows for b in leaf_blocks)
    # per-query row conservation (resilience/invariants.py): a row-local
    # chain only ever drops rows through filter masks, so rows in == rows
    # out + rows filtered must balance exactly; a preemption resume
    # taints the ledger instead (the restored prefix's filter counts
    # belong to the prior attempt)
    ledger = (_invariants.row_ledger(rows_in, tag)
              if plan.row_local_chain else contextlib.nullcontext())
    with ledger:
        if layout is not None:
            out = _run_adaptive(plan, layout, frame)
        else:
            out = _run_static(plan, leaf_blocks, tag)
        if plan.row_local_chain:
            _invariants.note_emitted(sum(b.num_rows for b in out))
    _adaptive.record_stream_feedback(
        tag, blocks=len(leaf_blocks), rows=rows_in,
        wall_s=time.perf_counter() - t0,
        occupancy=_pipeline.last_occupancy())
    return out


def _run_static(plan: ExecPlan, leaf_blocks, tag: str) -> List:
    from ..engine import pipeline as _pipeline
    from ..frame import Block
    # the FIRST stage pipelines through the executor's async submit /
    # drain halves like any per-op stream; multi-stage plans drain
    # device-resident outputs (keep_device) and complete the remaining
    # stages inside the drain, so later-stage dispatches overlap the
    # next blocks' first-stage work
    st0 = plan.stages[0]
    ex0, local0 = _stage_executor(st0, first=True)
    multi = len(plan.stages) > 1

    def finish(b, out) -> Block:
        env = {n: b.columns[n] for n in st0.passthrough}
        env, n_rows, short, _ = _apply_stage_result(plan, st0, env, out,
                                                    b.num_rows)
        if short is not None:
            return short
        if multi:
            return _run_rest(plan, env, n_rows, 1)[0]
        return _final_block(plan, env, n_rows)

    def serial_fn(b):
        if b.num_rows == 0:
            return _empty_chain(plan.ops, _full_leaf_empty(plan, b))
        out = ex0.run(st0.comp, {n: b.columns[n] for n in st0.inputs},
                      row_local=local0, keep_device=multi)
        return finish(b, out)

    def submit_fn(b):
        if b.num_rows == 0:
            # finished: flows through the window
            return _empty_chain(plan.ops, _full_leaf_empty(plan, b))
        return ex0.submit(st0.comp, {n: b.columns[n] for n in st0.inputs},
                          row_local=local0, keep_device=multi)

    def drain_fn(pending, b):
        if isinstance(pending, Block):
            return pending
        return finish(b, pending.drain())

    # the stream's identity for preemption checkpoints: a resume whose
    # forcing no longer takes the fused path must discard, not restore
    # these FINAL per-block results into a per-op stream of the same
    # length
    return _pipeline.run_pipelined(leaf_blocks, serial_fn, submit_fn,
                                   drain_fn,
                                   depth=_pipeline.stream_depth(ex0),
                                   executor=ex0, tag=tag)


# ---------------------------------------------------------------------------
# adaptive layout: re-bucketed stream + restore
# ---------------------------------------------------------------------------

def _pinned_concat(cols) -> Optional[torch.Tensor]:
    """``np.concatenate(cols)`` written once into page-locked host memory,
    or ``None`` where the columns are not one dense array type (ragged
    cells, a dtype torch cannot hold)."""
    if not all(isinstance(c, np.ndarray) for c in cols) or \
            len({(c.dtype, c.shape[1:]) for c in cols}) != 1:
        return None
    try:
        dtype = torch.from_numpy(np.empty(0, cols[0].dtype)).dtype
    except TypeError:
        return None
    buf = torch.empty((sum(len(c) for c in cols),) + cols[0].shape[1:],
                      dtype=dtype, pin_memory=True)
    np.concatenate(cols, out=buf.numpy())
    return buf


def _stage_unit(layout, unit, names, pin: bool) -> Dict[str, object]:
    """Columns ``names`` of a layout unit: a lone block's own arrays (no
    copy), else the unit's blocks merged now, when the unit is
    dispatched, with :meth:`Block.concat`'s semantics. For the card the
    merge writes straight into pinned host memory, which the executor
    copies to the card as it is: the static stream stages every block
    through pinned memory too, so coalescing adds no host copy."""
    from ..frame import Block
    blocks = unit[0]
    if len(blocks) == 1:
        return {n: blocks[0].columns[n] for n in names}
    out: Dict[str, object] = {}
    rest = []
    for n in names:
        staged = _pinned_concat([b.columns[n] for b in blocks]) \
            if pin else None
        if staged is None:
            rest.append(n)
        else:
            out[n] = staged
    if rest:
        out.update(Block.concat(blocks, layout.schema.select(rest)).columns)
    return out


def _unit_fns(plan: ExecPlan, layout):
    """serial/submit/drain halves over the layout's units ``(blocks,
    counts, orig_list)``; results are ``(final block, surviving counts)``
    pairs. Units are never empty (0-row originals are left
    out of the layout and replayed verbatim at restore)."""
    st0 = plan.stages[0]
    ex0, local0 = _stage_executor(st0, first=True)
    multi = len(plan.stages) > 1
    pin = ex0.resolve().type == "cuda"

    def finish(unit, out):
        blocks, counts, _ = unit
        env = _stage_unit(layout, unit, st0.passthrough, pin=False)
        env, n_rows, short, counts = _apply_stage_result(
            plan, st0, env, out, int(counts.sum()), counts)
        if short is not None:
            return short, counts
        if multi:
            return _run_rest(plan, env, n_rows, 1, counts)
        return _final_block(plan, env, n_rows), counts

    def serial_fn(unit):
        out = ex0.run(st0.comp, _stage_unit(layout, unit, st0.inputs, pin),
                      row_local=local0, keep_device=multi)
        return finish(unit, out)

    def submit_fn(unit):
        return ex0.submit(st0.comp,
                          _stage_unit(layout, unit, st0.inputs, pin),
                          row_local=local0, keep_device=multi)

    def drain_fn(pending, unit):
        return finish(unit, pending.drain())

    return serial_fn, submit_fn, drain_fn, ex0


def _should_replan(plan: ExecPlan):
    """The worst ``(priced, observed)`` selectivity pair deviating past
    ``TFT_REPLAN_RATIO``, or ``None`` (the plan is still priced right):
    what the plan believed against what the blocks showed."""
    from . import adaptive as _adaptive
    from .nodes import observed_selectivity
    ratio = _adaptive.replan_ratio()
    worst = None
    worst_dev = ratio
    for i, sel0 in plan.priced_sel.items():
        cur = observed_selectivity(plan.ops[i].comp)
        if cur is None:
            continue
        a = max(sel0 if sel0 is not None else 1.0, 1e-6)
        b = max(cur, 1e-6)
        dev = max(a, b) / min(a, b)
        if dev > worst_dev:
            worst_dev = dev
            worst = (a, b)
    return worst


def _run_adaptive(plan: ExecPlan, layout, frame) -> List:
    from ..engine import pipeline as _pipeline
    from ..observability.events import add_event
    from . import adaptive as _adaptive
    serial_fn, submit_fn, drain_fn, ex0 = _unit_fns(plan, layout)
    units = layout.units
    add_event("adaptive_layout", name=plan.leaf.describe(),
              blocks=layout.n_orig, units=len(units),
              coalesced=layout.coalesced_from, splits=layout.splits)
    _flight.record("plan.adaptive_layout", blocks=layout.n_orig,
                   units=len(units), coalesced=layout.coalesced_from,
                   splits=layout.splits,
                   depth=_pipeline.pipeline_depth(None))
    # the first unit runs alone: its observed selectivities are the
    # re-plan trigger for the remaining units (a mid-plan boundary, not
    # a new forcing)
    outs = [serial_fn(units[0])]
    rest_plan = plan
    deviation = (_should_replan(plan)
                 if len(units) > 1 and frame is not None else None)
    if deviation is not None:
        try:
            new_plan = build_plan(frame)
        except Exception as e:  # noqa: BLE001 - a re-plan is best-effort
            _log.debug("mid-plan replan failed (%s); keeping the current "
                       "plan", e)
            new_plan = None
        # adopt the re-planned stages only when they are shape-safe (same
        # read set, still row-local) AND actually different
        if new_plan is not None and new_plan.row_local_chain \
                and new_plan.leaf_required == plan.leaf_required \
                and [id(o.comp) for o in new_plan.ops
                     if o.kind != "select"] \
                != [id(o.comp) for o in plan.ops if o.kind != "select"]:
            rest_plan = new_plan
            counters.inc("plan.replans")
            add_event("replan", name=plan.leaf.describe(),
                      at_block=int(len(units[0][2])))
            _flight.record("plan.replan", at_block=int(len(units[0][2])),
                           priced=round(deviation[0], 6),
                           observed=round(deviation[1], 6),
                           ratio=_adaptive.replan_ratio())
            _log.info("mid-plan replan: observed selectivity deviated "
                      "past TFT_REPLAN_RATIO; re-ordered the remaining "
                      "filter stages")
            serial_fn, submit_fn, drain_fn, ex0 = _unit_fns(rest_plan,
                                                             layout)
    outs.extend(_pipeline.run_pipelined(
        units[1:], serial_fn, submit_fn, drain_fn,
        depth=_pipeline.stream_depth(ex0), executor=ex0, tag=None))
    return _restore_layout(rest_plan, layout, outs)


def _slice_final(block, lo: int, hi: int):
    from ..frame import Block
    from .adaptive import _slice_cols
    return Block(_slice_cols(block, list(block.columns), lo, hi), hi - lo)


def _restore_layout(plan: ExecPlan, layout, outs) -> List:
    """Re-split the adaptive units' outputs on the ORIGINAL block
    boundaries (each piece's surviving row count came through every
    mask) and splice the empty originals' empty-chain replays back in:
    the result is bit-identical to the static layout, boundaries
    included. An original whose rows were all filtered out gets a 0-row
    slice of its unit's (final-schema) output, which carries the dtypes
    and cell dims the static path produces."""
    from ..frame import Block
    per: List[List] = [[] for _ in range(layout.n_orig)]
    for (blk, counts), (_, _, orig_list) in zip(outs, layout.units):
        bounds = np.concatenate(([0], np.cumsum(counts)))
        for oid, lo, hi in zip(orig_list, bounds[:-1], bounds[1:]):
            per[oid].append(_slice_final(blk, int(lo), int(hi)))
    out: List = []
    empties = dict(layout.empty_blocks)
    for i in range(layout.n_orig):
        if i in empties:
            out.append(_empty_chain(plan.ops,
                                    _full_leaf_empty(plan, empties[i])))
        elif len(per[i]) == 1:
            out.append(per[i][0])
        else:
            # a split original: its sub-units' outputs stitched back with
            # the one canonical concat (frame.Block.concat)
            out.append(Block.concat(per[i], plan.final_schema))
    return out
