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

Left out, against the JAX package: the adaptive layout (re-bucketed
streams and mid-plan re-plans); the port runs the static layout, which is
what ``TFT_ADAPTIVE=0`` gives there.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

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
            blocks = _run(plan, leaf_blocks)
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

def _apply_stage_result(plan, st, env, out, n_rows):
    """Merge a stage's outputs into a fresh env; apply the mask. Returns
    ``(env, n_rows, short_circuit_block)`` — the block is non-None when
    the mask dropped every row and the rest of the chain replays the
    empty-block semantics."""
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
            return None, 0, _empty_chain(plan.ops[st.op_end + 1:], bb)
        # compare against the MASK length, not the stage-input row
        # count: a trim member inside the stage may have changed the
        # row count before the predicate ran
        if keep != mask.size:
            new_env = {k: _mask_value(v, mask, dev_mask)
                       for k, v in new_env.items()}
        n_rows = keep
    return new_env, n_rows, None


def _stage_executor(st, first: bool = True):
    """``(executor, row_local)`` of a stage, the per-op choice: a FIRST
    stage of map_rows only is row-local (and with it gets the OOM row
    split: rows are independent under vmap); any other stage is not, like
    its per-op twin.

    Later stages are never row-local, as in the JAX package (there only
    the first stage, fed by host rows, runs on the padding executor)."""
    return default_executor(), bool(st.row_local and first)


def _run_rest(plan: ExecPlan, env: Dict[str, object], n_rows: int,
              start: int):
    """Stages ``start..`` over an env, device-resident between stages.
    Returns the final block."""
    for si in range(start, len(plan.stages)):
        st = plan.stages[si]
        ex, row_local = _stage_executor(st, first=si == 0)
        out = ex.run(st.comp, {n: env[n] for n in st.inputs},
                     row_local=row_local, keep_device=True)
        env, n_rows, short = _apply_stage_result(plan, st, env, out, n_rows)
        if short is not None:
            return short
    return _final_block(plan, env, n_rows)


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
    on it."""
    return (f"plan[{plan.leaf.describe()};"
            f"{','.join(o.kind for o in plan.ops)};"
            f"{sorted(plan.leaf_required)}]"
            f"({plan.final_schema.names})")


def _run(plan: ExecPlan, leaf_blocks) -> List:
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
    # the perf drill's slowdown lands inside the timed forcing
    _faults.slowdown("perf")
    if not plan.row_local_chain:
        return _run_static(plan, leaf_blocks)
    # per-query row conservation (resilience/invariants.py): a row-local
    # chain only ever drops rows through filter masks, so rows in == rows
    # out + rows filtered must balance exactly; a preemption resume
    # taints the ledger instead (the restored prefix's filter counts
    # belong to the prior attempt)
    with _invariants.row_ledger(sum(b.num_rows for b in leaf_blocks),
                                _plan_tag(plan)):
        out = _run_static(plan, leaf_blocks)
        _invariants.note_emitted(sum(b.num_rows for b in out))
    return out


def _run_static(plan: ExecPlan, leaf_blocks) -> List:
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
        env, n_rows, short = _apply_stage_result(plan, st0, env, out,
                                                 b.num_rows)
        if short is not None:
            return short
        if multi:
            return _run_rest(plan, env, n_rows, 1)
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
                                   executor=ex0, tag=_plan_tag(plan))
