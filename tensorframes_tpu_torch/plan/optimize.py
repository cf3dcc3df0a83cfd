"""Plan optimizer: fusion legality, column pruning, stage building.

The port's counterpart of ``tensorframes_tpu/plan/optimize.py``. The
optimizer turns a linear chain of plan nodes into an
:class:`ExecPlan` — a list of :class:`Stage`\\ s, each one composed
:class:`~..computation.Computation` dispatched ONCE per block — or
returns ``None``, in which case the frame's unchanged per-op thunk runs
(the always-correct fallback; also the whole path under ``TFT_FUSE=0``).

Correctness is proof-driven, never assumed. The JAX package proves shapes
with ``jax.eval_shape`` on a symbolic row dimension; the port has no such
symbol and proves them with capture's own abstract probes instead
(``computation._run_probes``: the program on meta or fake tensors of 61,
67 and 2 rows, nothing run on data). A program whose shapes only a real
run can tell (data-dependent shapes) is never proven:

- a non-trim ``map_blocks`` fuses only when every fetch's lead equals the
  input rows in EVERY probe (the per-op path's runtime row-count check,
  discharged statically — ``v[:61]`` is Unknown to capture yet not
  row-preserving, and falls back and raises exactly as per-op);
- a trim ``map_blocks`` fuses only when all fetches share one lead in
  every probe; a filter predicate only when its mask is one vector of
  block length in every probe; ``map_rows`` is row-preserving by vmap
  construction;
- a filter ends its fusion stage: its mask is computed INSIDE the fused
  program (one extra output) and applied at the stage boundary, as in
  the JAX package, whose static-shape programs cannot hold a
  data-dependent row count: the mask comes to the host, host columns are
  masked there and device-resident ones gathered on the device, and the
  next stage consumes them where they lie;
- column pruning is a backward pass over the chain: only columns that
  feed a computation or survive to the final schema are read
  (``ParquetScanNode``), gathered by a join (``JoinNode``), marshalled, or
  materialized as program outputs.

A composed :class:`~..computation.Computation` is built from its
members' specs and never probes them again. It is built anew at every
forcing: eager PyTorch compiles nothing per program, so the JAX package's
structural cache of composed programs (which saves XLA recompiles) has
nothing to save here.

With ``TFT_ADAPTIVE`` on (the default, ``plan/adaptive.py``), runs of
adjacent atom-proven filters are re-ordered most-selective-first by
their observed selectivity (:func:`_reorder_filters`), and each plan
records the selectivity it priced every filter at (``priced_sel``), the
executor's mid-plan re-plan baseline.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..computation import (Computation, TensorSpec, _probe_dims,
                           _run_probe, _run_probes)
from ..utils.env import env_bool
from ..utils.logging import get_logger
from . import nodes as _n

__all__ = ["enabled", "build_plan", "ExecPlan", "Stage", "MASK"]

_log = get_logger("plan.optimize")

# the fused filter mask's reserved output name; a user column with this
# name disables planning for the chain (checked in build_plan)
MASK = "_tft_mask"


def enabled() -> bool:
    """``TFT_FUSE`` gate (default on). ``TFT_FUSE=0`` disables every
    pass; forcing then runs the per-op thunks, bit-identical to the
    fused path by construction: unset or empty is on,
    ``0``/``false``/``False`` off, anything else on."""
    return env_bool("TFT_FUSE", True)


# ---------------------------------------------------------------------------
# legality proofs from abstract probes (cached per Computation)
# ---------------------------------------------------------------------------

def _abstract_outputs(comp: Computation):
    """``[(rows, {fetch: shape})]``, one entry per abstract probe of the
    computation (rows 61, 67 and, when the program runs at that size, 2
    in the shared lead dim), or ``None`` when the computation has no
    Unknown lead or no abstract probe settles its shapes. Cached on the
    computation: one set of probes per comp per process."""
    cached = getattr(comp, "_tft_plan_absout", False)
    if cached is not False:
        return cached
    res = None
    lead = next((i for i, s in enumerate(comp.inputs)
                 if s.shape.ndim > 0 and s.shape.head == -1), None)
    if lead is not None:
        probes = _probe_dims(comp.inputs, share_lead_symbol=True)
        outs = None
        for device in ("meta", "fake"):
            try:
                outs = _run_probes(comp.fn, comp.inputs, probes[:2], device)
                break
            except Exception as e:  # noqa: BLE001 - unproven means unfused
                _log.debug("%s probe for a fusion proof failed (%s: %s)",
                           device, type(e).__name__, e)
        if outs is not None:
            try:
                outs.append(_run_probe(comp.fn, comp.inputs, probes[2],
                                       device))
            except Exception:  # noqa: BLE001 - a program may need > 2 rows
                pass
            res = []
            for shapes, out in zip(probes, outs):
                got = {n: tuple(out[n].shape) for n in comp.output_names}
                if res and any(len(got[n]) != len(res[0][1][n])
                               for n in got):
                    continue  # the small probe changed rank: ignore it
                res.append((shapes[lead][0], got))
    try:
        comp._tft_plan_absout = res
    except AttributeError as e:
        _log.debug("could not cache fusion proof on %r: %s", comp, e)
    return res


def _row_preserving(comp: Computation) -> bool:
    """Every fetch's lead equals the input rows in every probe — the
    static discharge of the per-op runtime row-count check."""
    r = _abstract_outputs(comp)
    if not r:
        return False
    return all(len(sh) > 0 and sh[0] == rows
               for rows, out in r for sh in out.values())


def _uniform_lead(comp: Computation) -> bool:
    """All fetches share ONE lead in every probe (the trim contract:
    fetches may change the row count, but must agree)."""
    r = _abstract_outputs(comp)
    if not r:
        return False
    for _, out in r:
        shapes = list(out.values())
        if any(len(sh) == 0 for sh in shapes) \
                or len({sh[0] for sh in shapes}) > 1:
            return False
    return True


def _mask_shaped(comp: Computation) -> bool:
    """The filter predicate yields one block-length vector in every
    probe."""
    r = _abstract_outputs(comp)
    if not r:
        return False
    name = comp.output_names[0]
    return all(len(out[name]) == 1 and out[name][0] == rows
               for rows, out in r)


# ---------------------------------------------------------------------------
# chain linearization
# ---------------------------------------------------------------------------

def linearize(frame):
    """``(leaf_node, [op nodes leaf->final])`` or ``None``.

    Walks ``input`` links from the frame's node; an upstream op whose
    own frame is already forced becomes the leaf (its cached blocks are
    free — exactly what the per-op thunk would reuse)."""
    node = getattr(frame, "_plan_node", None)
    if node is None:
        return None
    chain: List[_n.PlanNode] = []
    while node is not None:
        if node.kind not in _n.OP_KINDS:
            chain.reverse()
            return node, chain
        rf = node.result_ref() if node.result_ref is not None else None
        if rf is not None and rf is not frame \
                and getattr(rf, "_cache", None) is not None:
            chain.reverse()
            return _n.SourceNode(rf), chain
        chain.append(node)
        node = node.input
    return None


# ---------------------------------------------------------------------------
# composed computations
# ---------------------------------------------------------------------------

# a stage member is ("mb", comp, trim) | ("mr", vcomp) | ("f", comp)
# | ("sel", names)
Member = Tuple


def _compose(members: Sequence[Member], in_specs: List[TensorSpec],
             out_specs: List[TensorSpec]) -> Computation:
    mem = tuple(members)
    data_names = tuple(s.name for s in out_specs if s.name != MASK)
    has_mask = any(s.name == MASK for s in out_specs)

    def fused_fn(d):
        env = dict(d)
        mask = None
        for m in mem:
            if m[0] == "sel":
                keep = set(m[1])
                env = {k: v for k, v in env.items() if k in keep}
                continue
            comp = m[1]
            out = comp.fn({n: env[n] for n in comp.input_names})
            if m[0] == "f":
                mask = out[comp.output_names[0]]
            elif m[0] == "mb" and m[2]:
                env = dict(out)  # trim: only the fetches survive
            else:
                env.update(out)
        res = {n: env[n] for n in data_names}
        if has_mask:
            res[MASK] = mask
        return res

    fused = Computation(fused_fn, in_specs, out_specs)
    fused._tft_programs = tuple(dict.fromkeys(
        p for m in mem if m[0] != "sel" for p in m[1]._tft_programs))
    return fused


# ---------------------------------------------------------------------------
# stages and the executable plan
# ---------------------------------------------------------------------------

class Stage:
    """One fused dispatch: a composed program plus the host-side glue
    around it (passthrough columns, the filter mask, the boundary
    schema for mid-chain empty results)."""

    __slots__ = ("comp", "inputs", "outputs", "passthrough", "mask",
                 "label", "op_end", "boundary_schema", "row_local")

    def __init__(self, comp: Optional[Computation], inputs: Tuple[str, ...],
                 outputs: Tuple[str, ...], passthrough: Tuple[str, ...],
                 mask: bool, label: str, op_end: int, boundary_schema,
                 row_local: bool):
        self.comp = comp
        self.inputs = inputs
        self.outputs = outputs
        self.passthrough = passthrough
        self.mask = mask
        self.label = label
        self.op_end = op_end  # index into ExecPlan.ops of the last op
        self.boundary_schema = boundary_schema
        # every member is a vmapped map_rows (or a select): rows are
        # independent by construction, so the stage keeps the per-op
        # map_rows executor and with it the OOM row split. A stage with a
        # map_blocks or filter member may be cross-row (z = x - mean(x))
        # and runs on the default executor, like its per-op twin.
        self.row_local = row_local


class ExecPlan:
    """The optimizer's output: leaf + stages + pruning decisions."""

    __slots__ = ("leaf", "ops", "stages", "final_schema", "leaf_required",
                 "scan_names", "device_ops", "pruned", "scan_atoms",
                 "row_local_chain", "priced_sel", "reordered")

    def __init__(self, leaf, ops, stages, final_schema, leaf_required,
                 scan_names, device_ops, pruned, scan_atoms=(),
                 row_local_chain=False, priced_sel=None, reordered=False):
        self.leaf = leaf
        self.ops = ops
        self.stages = stages
        self.final_schema = final_schema
        self.leaf_required = leaf_required  # leaf columns actually needed
        self.scan_names = scan_names        # leaf columns feeding programs
        self.device_ops = device_ops
        self.pruned = pruned                # leaf columns NOT read
        self.scan_atoms = scan_atoms        # parquet pushdown predicates
        # every op provably row-local (vmapped map_rows, selects,
        # atom-proven filter predicates): rows only ever leave through
        # filter masks, so the executor audits rows in == rows out + rows
        # filtered (resilience/invariants.row_ledger), and the adaptive
        # layout may re-bucket the leaf stream (plan/adaptive.py)
        self.row_local_chain = row_local_chain
        # the selectivity each filter op was PRICED at when this plan was
        # built (None = the keeps-everything upper bound); the executor
        # compares observations against these to trigger a re-plan
        self.priced_sel = priced_sel or {}
        self.reordered = reordered  # filter run re-ordered by feedback

    def describe(self) -> List[str]:
        """``explain()``'s plan section: fused groups, pruned columns,
        resident edges."""
        lines = [f"  plan     : {len(self.ops) + 1} node(s) -> "
                 f"{len(self.stages)} fused stage(s), "
                 f"{self.device_ops} device op(s) fused (TFT_FUSE=1)"]
        src = self.leaf.describe()
        if self.pruned:
            lines.append(
                f"    source : {src} · read {len(self.leaf_required)}/"
                f"{len(self.leaf.schema)} column(s) "
                f"{list(self.leaf_required)} (pruned {list(self.pruned)})")
        else:
            lines.append(f"    source : {src} · "
                         f"{len(self.leaf_required)} column(s)")
        if self.scan_atoms:
            preds = ", ".join(f"{a.column} {a.op} {a.value:g}"
                              for a in self.scan_atoms)
            lines.append(
                f"    pushdown: [{preds}] checked against row-group "
                f"footer statistics (refuted groups never read)")
        if self.reordered:
            lines.append(
                "    adaptive: conjunctive filters re-ordered by "
                "observed selectivity (TFT_ADAPTIVE=1)")
        for i, st in enumerate(self.stages):
            edge = ("host rows" if i == 0 else "device-resident")
            mask_s = " · mask applied host-side" if st.mask else ""
            lines.append(
                f"    stage {i}: {st.label} -> 1 dispatch/block "
                f"(in: {edge}){mask_s}")
        return lines


def _atom_filter(comp) -> bool:
    """True when the predicate's sole output is PROVEN a conjunction of
    column-vs-literal comparisons (:mod:`.predicates`), so the predicate
    is row-local: its mask row depends only on that row."""
    from .predicates import extract_atoms
    return bool(extract_atoms(comp))


def _reorder_filters(ops):
    """Runs of ADJACENT filters whose predicates are all atom-proven
    (row-local, so they commute: same final row set, same order, same
    block boundaries) re-order most-selective-first by observed
    selectivity, so later filter dispatches see fewer rows. Unobserved
    predicates price at the keeps-everything upper bound and keep their
    position (stable sort). Returns ``(ops, reordered)``."""
    from .adaptive import enabled as _adaptive_on
    if not _adaptive_on():
        return ops, False
    out = list(ops)
    changed = False
    i = 0
    while i < len(out):
        if out[i].kind != "filter" or not _atom_filter(out[i].comp):
            i += 1
            continue
        j = i
        while j < len(out) and out[j].kind == "filter" \
                and _atom_filter(out[j].comp):
            j += 1
        if j - i > 1:
            run = out[i:j]
            sels = [_n.observed_selectivity(o.comp) for o in run]
            if any(s is not None for s in sels):
                order = sorted(range(len(run)),
                               key=lambda k: (sels[k] if sels[k]
                                              is not None else 1.0, k))
                if order != list(range(len(run))):
                    out[i:j] = [run[k] for k in order]
                    changed = True
                    from ..observability import flight as _flight
                    _flight.record(
                        "plan.filter_reorder", order=order,
                        selectivities=[round(s, 6) if s is not None
                                       else None for s in sels])
        i = j
    if changed:
        from ..utils.tracing import counters
        counters.inc("plan.filter_reorders")
    return out, changed


def build_plan(frame) -> Optional[ExecPlan]:
    """Optimize ``frame``'s recorded chain, or ``None`` for the per-op
    fallback. Never raises for an unsupported chain — unsupported means
    unplanned, not failed."""
    if not enabled():
        return None
    from ..engine.executor import BlockExecutor, default_executor
    if type(default_executor()) is not BlockExecutor:
        # a non-default process executor (native PJRT core) keeps the
        # per-op path: fused chaining relies on keep_device dispatches
        return None
    lin = linearize(frame)
    if lin is None:
        return None
    leaf, ops = lin
    if not ops:
        return None
    device_ops = sum(1 for o in ops
                     if o.kind in ("map_blocks", "map_rows", "filter"))
    # parquet scans prune their read; join leaves prune the columns the
    # join materializes
    prunable_leaf = leaf.kind in ("parquet", "join")
    if device_ops < 2 and not prunable_leaf:
        return None  # nothing to win; per-op semantics stay canonical
    if MASK in leaf.schema or any(MASK in o.schema for o in ops):
        return None
    # adaptive re-plan: observed-selective conjunctive filters first, at
    # every forcing and between stream batches (each batch builds a fresh
    # plan over the shared computations that carry the observations)
    ops, reordered = _reorder_filters(ops)

    # legality: every device op must carry a proof, or the chain falls
    # back wholesale (all-or-nothing keeps error contracts identical)
    for o in ops:
        if o.kind == "map_blocks":
            if o.trim:
                if not _uniform_lead(o.comp):
                    return None
            elif not _row_preserving(o.comp):
                return None
        elif o.kind == "map_rows":
            if o.vcomp is None:
                return None
        elif o.kind == "filter":
            if not _mask_shaped(o.comp):
                return None

    # backward pass: required columns after (and before) every op
    final_schema = ops[-1].schema
    need: Set[str] = set(final_schema.names)
    req_after: List[Set[str]] = [set()] * len(ops)
    for i in range(len(ops) - 1, -1, -1):
        req_after[i] = set(need)
        o = ops[i]
        if o.kind == "map_blocks":
            if o.trim:
                need = set(o.comp.input_names)
            else:
                need = (need - set(o.comp.output_names)) \
                    | set(o.comp.input_names)
        elif o.kind == "map_rows":
            need = (need - set(o.comp.output_names)) \
                | set(o.comp.input_names)
        elif o.kind == "filter":
            need = need | set(o.comp.input_names)
        # select: need is already a subset of the selected names
    if not len(final_schema):
        # select([]) chains: the per-op path owns the empty-schema
        # corner (a zero-output fused program cannot carry the row
        # count a mid-chain trim may have changed)
        return None
    leaf_required = tuple(f.name for f in leaf.schema if f.name in need)
    if not leaf_required and len(leaf.schema):
        return None  # empty projection: a corner the per-op path owns

    # forward simulation: group ops into stages, resolve program
    # inputs/outputs, keep per-name block-level specs
    spec_of: Dict[str, TensorSpec] = {}
    origin: Dict[str, str] = {}
    for f in leaf.schema:
        if f.name not in need:
            continue
        spec_of[f.name] = (TensorSpec(f.name, f.dtype, f.block_shape)
                           if f.dtype.tensor and f.block_shape is not None
                           else None)
        origin[f.name] = "leaf"
    live: Set[str] = set(leaf_required)
    stages: List[Stage] = []
    members: List[Member] = []
    ext: Dict[str, TensorSpec] = {}
    internal: Set[str] = set()
    labels: List[str] = []
    scan_names: Set[str] = set()

    def close(idx: int, mask_member: Optional[Member]) -> None:
        nonlocal live, members, ext, internal, labels
        req = req_after[idx]
        produced = tuple(n for n in sorted(live)
                         if n in internal and n in req)
        passthrough = tuple(n for n in sorted(live)
                            if n not in internal and n in req)
        out_specs = [spec_of[n] for n in produced]
        if mask_member is not None:
            mspec = mask_member[1].outputs[0]
            out_specs.append(TensorSpec(MASK, mspec.dtype, mspec.shape))
        comp = None
        if any(m[0] != "sel" for m in members) or mask_member is not None:
            mem = list(members) + ([mask_member] if mask_member else [])
            in_specs = [ext[n] for n in sorted(ext)]
            comp = _compose(mem, in_specs, out_specs)
        if comp is not None:
            row_local = (mask_member is None
                         and all(m[0] in ("mr", "sel") for m in members)
                         and any(m[0] == "mr" for m in members))
            stages.append(Stage(
                comp, tuple(sorted(ext)), produced, passthrough,
                mask_member is not None, "+".join(labels) or "pass",
                idx, ops[idx].schema, row_local))
        live = set(produced) | set(passthrough)
        for n in produced:
            origin[n] = "computed"
        members, ext, internal, labels = [], {}, set(), []

    bailed = False
    for i, o in enumerate(ops):
        if o.kind == "select":
            keep = set(o.names)
            live &= keep
            internal &= keep
            members.append(("sel", tuple(o.names)))
            continue
        comp = o.vcomp if o.kind == "map_rows" else o.comp
        ok = True
        for n in comp.input_names:
            if n in internal:
                continue
            sp = spec_of.get(n)
            if n not in live or sp is None:
                ok = False
                break
            ext.setdefault(n, sp)
            if origin.get(n) == "leaf":
                scan_names.add(n)
        if not ok:
            bailed = True
            break
        if o.kind == "filter":
            labels.append("filter")
            close(i, ("f", comp))
            continue
        trim = o.kind == "map_blocks" and o.trim
        members.append(("mb", comp, trim) if o.kind == "map_blocks"
                       else ("mr", comp))
        labels.append(o.kind + ("[trim]" if trim else ""))
        if trim:
            live, internal = set(), set()
        for s in comp.outputs:
            live.add(s.name)
            internal.add(s.name)
            spec_of[s.name] = s
            origin[s.name] = "computed"
    if bailed:
        return None
    if members:
        close(len(ops) - 1, None)
    if not stages:
        # a pure-projection chain still plans when it prunes a parquet
        # read or a join; otherwise the per-op path is already minimal
        if not (prunable_leaf and len(leaf_required) < len(leaf.schema)):
            return None
    pruned = tuple(f.name for f in leaf.schema if f.name not in need) \
        if prunable_leaf else ()
    row_local_chain = bool(stages) and all(
        o.kind in ("map_rows", "select")
        or (o.kind == "filter" and _atom_filter(o.comp))
        for o in ops)
    priced_sel = {i: _n.observed_selectivity(o.comp)
                  for i, o in enumerate(ops) if o.kind == "filter"}
    return ExecPlan(leaf, list(ops), stages, final_schema, leaf_required,
                    frozenset(scan_names), device_ops, pruned,
                    _scan_atoms(leaf, ops), row_local_chain=row_local_chain,
                    priced_sel=priced_sel, reordered=reordered)


def _scan_atoms(leaf, ops):
    """Pushdown atoms for a parquet leaf: conjunctive ``column <op>
    literal`` filter predicates over columns that still hold the scan's
    values where the filter reads them. A trim ends that for every
    column; a ``select`` ends it for the columns it drops, and a map that
    later makes a column of the same name makes a new column, whose
    values the file's statistics say nothing about. Sound for
    whole-group skipping regardless of earlier filters: a group whose
    every row fails the predicate contributes nothing downstream.
    Explicitly re-partitioned scans (``num_partitions=``) push down
    too: the scan node remaps surviving group rows onto the partition
    spans the unpushed read would have produced."""
    if leaf.kind != "parquet":
        return ()
    from .predicates import extract_atoms
    from_leaf = set(leaf.schema.names)
    atoms = []
    for o in ops:
        if o.kind == "map_blocks" and o.trim:
            break
        if o.kind == "select":
            from_leaf &= set(o.names)
        elif o.kind in ("map_blocks", "map_rows"):
            from_leaf -= set(o.comp.output_names)
        elif o.kind == "filter":
            atoms.extend(a for a in extract_atoms(o.comp)
                         if a.column in from_leaf)
    return tuple(atoms)
