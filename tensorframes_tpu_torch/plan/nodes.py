"""Plan-node IR: one node per lazy frame op, plus the two leaf kinds.

The port's counterpart of ``tensorframes_tpu/plan/nodes.py``. A node
records WHAT an op computes (its canonical
:class:`~..computation.Computation`, its projection, its output schema)
— never HOW it will run; the optimizer (:mod:`.optimize`) decides that
at forcing time. Nodes are built alongside the existing lazy thunks
(:func:`attach` is called by ``engine.ops`` and ``TensorFrame.select``),
so a frame always has its per-op path available as the fallback.

Estimates: every node answers :meth:`PlanNode.estimate` with
``(rows, {column: total_bytes})`` — per-COLUMN byte accounting threaded
from measured leaf sizes (exact block bytes for in-memory sources,
footer column-chunk sizes for parquet scans), so projections and fetch
columns are priced individually instead of by the whole-schema row-byte
ratio. ``memory.estimate.frame_estimate`` consults this for unforced
frames. A lazy join (``relational/join.py``) is a leaf too
(:class:`JoinNode`): chains fuse over its result, and pruning reaches into
it.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..computation import Computation
from ..schema import Schema
from ..utils.logging import get_logger

__all__ = ["PlanNode", "SourceNode", "ParquetScanNode", "MapBlocksNode",
           "MapRowsNode", "FilterNode", "SelectNode", "JoinNode", "attach",
           "node_for", "record_selectivity", "observed_selectivity"]

_log = get_logger("plan.nodes")

# ---------------------------------------------------------------------------
# feedback selectivity
# ---------------------------------------------------------------------------
#
# When a filter FORCES, the observed rows-in/rows-out land on the
# predicate's canonical Computation (computations are cached per fetches
# object — engine.ops.cached_map_computation — so every plan built from
# the same predicate shares one record). Estimates then use the observed
# ratio instead of the keeps-everything upper bound.

_sel_lock = threading.Lock()

# bumped on every recorded observation: estimate caches key on it, so
# an upstream filter's sharpened selectivity invalidates EVERY cached
# downstream estimate (a MapBlocksNode whose input is a filter must not
# keep pricing the pre-observation upper bound forever)
_sel_epoch = 0


def record_selectivity(comp, rows_in: int, rows_out: int) -> None:
    """Accumulate one forcing's observed filter selectivity on its
    predicate computation (best-effort: unsettable comps are skipped)."""
    global _sel_epoch
    if rows_in <= 0:
        return
    try:
        with _sel_lock:
            tin, tout = getattr(comp, "_tft_observed_sel", (0, 0))
            comp._tft_observed_sel = (tin + int(rows_in),
                                      tout + int(rows_out))
            _sel_epoch += 1
    except Exception as e:  # noqa: BLE001 - feedback is advisory
        _log.debug("could not record selectivity on %r: %s", comp, e)


def observed_selectivity(comp) -> Optional[float]:
    """The accumulated rows-out/rows-in ratio of a predicate, or
    ``None`` before its first observed forcing."""
    rec = getattr(comp, "_tft_observed_sel", None)
    if not rec or rec[0] <= 0:
        return None
    return min(1.0, rec[1] / rec[0])

# (rows, per-column total bytes) — either half may be None when unknown
Estimate = Tuple[Optional[float], Optional[Dict[str, int]]]

OP_KINDS = ("map_blocks", "map_rows", "filter", "select")


def _col_nbytes(col) -> int:
    """Host bytes of one column — delegates to the shared definition so
    plan estimates and block accounting can never drift."""
    from ..memory.estimate import column_nbytes
    return column_nbytes(col)


def _cell_bytes(dtype, dims: Sequence) -> int:
    """Bytes per row of a cell shape (Unknown dims floor at 1, the same
    deliberate floor ``schema_row_bytes`` uses)."""
    cells = 1
    for d in dims:
        if isinstance(d, int) and d > 0:
            cells *= d
    return cells * int(np.dtype(dtype.np_storage).itemsize)


def _field_row_bytes(field) -> int:
    if not field.dtype.tensor:
        return 8  # strings count a pointer, like schema_row_bytes
    cell = field.cell_shape
    return _cell_bytes(field.dtype, cell.dims if cell is not None else ())


class PlanNode:
    """Base: an op node with one input, or a leaf with ``input=None``."""

    kind = "node"

    def __init__(self, input: Optional["PlanNode"], schema: Schema):
        self.input = input
        self.schema = schema
        # weakref to the frame this node produced (set by attach):
        # linearization stops at an upstream frame whose block cache is
        # already materialized — re-deriving it would waste work the
        # per-op path gets for free
        self.result_ref: Optional[weakref.ref] = None

    def describe(self) -> str:
        return self.kind

    def estimate(self) -> Estimate:
        """Cached per selectivity epoch: computed once per node (chain
        building stays O(n), not O(n^2) walks) and recomputed only
        after a new filter observation landed anywhere in the process
        (``record_selectivity`` bumps the epoch) — so a sharpened
        upstream selectivity propagates through cached downstream
        estimates. Callers get a copy of the column dict."""
        cached = getattr(self, "_est_cache", None)
        if cached is None or cached[0] != _sel_epoch:
            cached = self._est_cache = (_sel_epoch, self._estimate())
        rows, cols = cached[1]
        return rows, (dict(cols) if cols is not None else None)

    def _estimate(self) -> Estimate:
        return None, None


class SourceNode(PlanNode):
    """Leaf over any frame without a plan of its own (eager constructors,
    ``order_by``/``repartition``/``limit`` results, cached upstreams)."""

    kind = "source"

    def __init__(self, frame):
        super().__init__(None, frame.schema)
        self.frame = frame

    def describe(self) -> str:
        return f"source[{self.frame._plan}]"

    def _estimate(self) -> Estimate:
        blocks = getattr(self.frame, "_cache", None)
        if blocks:
            rows = 0
            col_bytes: Dict[str, int] = {f.name: 0 for f in self.schema}
            for b in blocks:
                rows += int(b.num_rows)
                for name, col in b.columns.items():
                    if name in col_bytes:
                        col_bytes[name] += _col_nbytes(col)
            return float(rows), col_bytes
        rows = getattr(self.frame, "_rows_hint", None)
        rows_f = float(rows) if rows is not None else None
        cb = getattr(self.frame, "_col_bytes_hint", None)
        if cb is not None:
            return rows_f, dict(cb)
        total = getattr(self.frame, "_bytes_hint", None)
        if total is None:
            return rows_f, None
        # only a whole-frame hint exists: distribute it over the declared
        # per-row column widths so downstream projections still prune
        widths = {f.name: _field_row_bytes(f) for f in self.schema}
        denom = sum(widths.values()) or 1
        return rows_f, {n: int(total * w / denom)
                        for n, w in widths.items()}


class ParquetScanNode(PlanNode):
    """Leaf over a lazily-read parquet range: the pruning target.

    ``columns`` is the full requested projection (file order);
    :meth:`read_blocks` reads any subset of it at force time — one
    footer read decided everything else (rows, per-column bytes,
    partition count) at construction.
    """

    kind = "parquet"

    def __init__(self, path: str, columns: Sequence[str],
                 row_group_offset: int, row_group_limit: int,
                 num_partitions: Optional[int], schema: Schema,
                 rows: int, col_bytes: Dict[str, int]):
        super().__init__(None, schema)
        self.path = path
        self.columns = tuple(columns)
        self.row_group_offset = int(row_group_offset)
        # pinned at footer time: a tailed file growing between build and
        # force must not change what this frame reads
        self.row_group_limit = int(row_group_limit)
        self.num_partitions = num_partitions
        self.rows = int(rows)
        self.col_bytes = dict(col_bytes)
        self.frame_ref: Optional[weakref.ref] = None

    def describe(self) -> str:
        import os
        return f"parquet[{os.path.basename(self.path)}]"

    def _estimate(self) -> Estimate:
        return float(self.rows), dict(self.col_bytes)

    def _group_stats(self):
        """Per-row-group footer statistics for this scan's pinned range:
        a list of ``(num_rows, {column: (min, max)})`` — one footer
        read, cached on the node. ``None`` stats never refute."""
        cached = getattr(self, "_rg_stats", None)
        if cached is not None:
            return cached
        stats = []
        try:
            import pyarrow.parquet as pq
            with pq.ParquetFile(self.path) as pf:
                md = pf.metadata
                want = set(self.columns)
                end = min(md.num_row_groups,
                          self.row_group_offset + self.row_group_limit)
                for g in range(self.row_group_offset, end):
                    rg = md.row_group(g)
                    per = {}
                    nbytes = {}
                    for j in range(rg.num_columns):
                        c = rg.column(j)
                        base = c.path_in_schema.split(".", 1)[0]
                        if base not in want:
                            continue
                        nbytes[base] = int(c.total_uncompressed_size)
                        s = c.statistics
                        if s is not None and s.has_min_max:
                            per[base] = (s.min, s.max)
                    stats.append((rg.num_rows, per, nbytes))
        except Exception as e:  # noqa: BLE001 - no stats, no pushdown
            _log.debug("row-group stats unavailable for %s (%s); "
                       "pushdown disabled", self.path, e)
            stats = []
        self._rg_stats = stats
        return stats

    def refuted_groups(self, atoms) -> List[int]:
        """Row-group indices (0-based within this scan's range) whose
        footer stats PROVE every row fails some pushdown atom."""
        if not atoms:
            return []
        from .. import dtypes as _dt
        from .predicates import refutes
        stats = self._group_stats()
        if len(stats) != self.row_group_limit:
            return []
        out = []
        for gi, (_, per, _nb) in enumerate(stats):
            for a in atoms:
                f = self.schema.get(a.column)
                mm = per.get(a.column)
                if f is None or mm is None or not f.dtype.tensor:
                    continue
                if refutes(a, mm[0], mm[1], _dt.device_dtype(f.dtype)):
                    out.append(gi)
                    break
        return out

    def _empty_block(self, names: Sequence[str]):
        """A 0-row block typed like this scan's columns (the stand-in
        for a pushdown-skipped row group; only ever observed at 0 rows,
        where the per-op empty replay makes the shapes unobservable)."""
        from ..engine.ops import empty_schema_block
        return empty_schema_block(self.schema.select(list(names)))

    def read_blocks(self, names: Sequence[str], atoms=None) -> List:
        """Blocks holding (at least) ``names`` — the already-forced frame
        cache when it exists, a pruned read otherwise.

        ``atoms`` (pushdown predicates, :mod:`.predicates`) skip whole
        row groups whose footer statistics refute them — bit-identical
        downstream, because every skipped row was about to fail the
        filter anyway (``plan.pushdown_groups_skipped`` /
        ``plan.pushdown_bytes_skipped`` count what was never read). On
        1:1 group->partition scans (``num_partitions is None``) a
        skipped group's partition becomes a typed 0-row block;
        explicitly re-partitioned scans remap the surviving groups'
        rows onto the exact partition spans the unpushed read would
        have produced (skipped rows simply absent from their spans —
        the filter was about to drop them)."""
        frame = self.frame_ref() if self.frame_ref is not None else None
        if frame is not None and getattr(frame, "_cache", None):
            return frame._cache
        from ..io import _read_parquet_eager
        want = [n for n in self.columns if n in set(names)]
        skip = set(self.refuted_groups(atoms) if atoms else [])
        if not skip:
            return _read_parquet_eager(
                self.path, columns=want,
                num_partitions=self.num_partitions,
                pad_ragged=False, row_group_offset=self.row_group_offset,
                row_group_limit=self.row_group_limit).blocks()
        from ..utils.tracing import counters
        stats = self._group_stats()
        skipped_bytes = 0
        for gi in skip:
            _, _, nbytes = stats[gi]
            # footer chunk sizes of the READ projection only
            skipped_bytes += sum(int(nbytes.get(n, 0)) for n in want)
        counters.inc("plan.pushdown_groups_skipped", len(skip))
        counters.inc("plan.pushdown_bytes_skipped", skipped_bytes)
        _log.info("parquet pushdown: skipped %d/%d row group(s) "
                  "(~%d B) of %s", len(skip), self.row_group_limit,
                  skipped_bytes, self.path)
        # read surviving groups in contiguous runs; skipped positions
        # stay None
        blocks: List = [None] * self.row_group_limit
        run_start = None
        for gi in range(self.row_group_limit + 1):
            live = gi < self.row_group_limit and gi not in skip
            if live and run_start is None:
                run_start = gi
            elif not live and run_start is not None:
                got = _read_parquet_eager(
                    self.path, columns=want, num_partitions=None,
                    pad_ragged=False,
                    row_group_offset=self.row_group_offset + run_start,
                    row_group_limit=gi - run_start).blocks()
                for k, b in enumerate(got):
                    blocks[run_start + k] = b
                run_start = None
        if self.num_partitions is not None:
            return self._remap_partitions(blocks, want, stats)
        # group->partition is 1:1: splice typed empties at skipped spots
        empty = self._empty_block(want)
        return [b if b is not None else empty for b in blocks]

    def _remap_partitions(self, gblocks: List, names: Sequence[str],
                          stats) -> List:
        """Surviving per-group blocks -> the ``num_partitions`` blocks
        of an explicitly re-partitioned scan. Partition spans are cut
        over the TOTAL row count (footer group sizes, refuted groups
        included) with the same ``_split_even`` the unpushed read uses,
        so partition count and each surviving row's partition match the
        unpushed path exactly; refuted groups' rows are simply absent
        from their spans."""
        from ..frame import Block, _split_even
        group_rows = [int(st[0]) for st in stats]
        offsets = np.concatenate([[0], np.cumsum(group_rows)])
        total = int(offsets[-1])
        sel_schema = self.schema.select(list(names))
        spans = _split_even(total, self.num_partitions)
        out: List = []
        for a, b in spans:
            pieces: List = []
            for gi, blk in enumerate(gblocks):
                if blk is None:
                    continue  # refuted: its rows were about to fail
                ga, gb = int(offsets[gi]), int(offsets[gi + 1])
                lo, hi = max(a, ga), min(b, gb)
                if lo >= hi:
                    continue
                if lo == ga and hi == gb:
                    pieces.append(blk)
                    continue
                s0, s1 = lo - ga, hi - ga
                pieces.append(Block(
                    {k: (v[s0:s1] if isinstance(v, np.ndarray)
                         else list(v[s0:s1]))
                     for k, v in blk.columns.items()}, s1 - s0))
            if pieces:
                out.append(Block.concat(pieces, sel_schema))
            else:
                out.append(self._empty_block(names))
        return out


class MapBlocksNode(PlanNode):
    kind = "map_blocks"

    def __init__(self, input: PlanNode, schema: Schema, comp: Computation,
                 trim: bool):
        super().__init__(input, schema)
        self.comp = comp
        self.trim = bool(trim)

    def describe(self) -> str:
        return "map_blocks[trim]" if self.trim else "map_blocks"

    def _estimate(self) -> Estimate:
        rows, cols = self.input.estimate()
        if self.trim:
            # the computation owns the row count; nothing is knowable
            return None, None
        if rows is None or cols is None:
            return rows, None
        out = dict(cols)
        for s in self.comp.outputs:
            out[s.name] = int(rows * _cell_bytes(s.dtype, s.shape.dims[1:]))
        return rows, out


class MapRowsNode(PlanNode):
    kind = "map_rows"

    def __init__(self, input: PlanNode, schema: Schema, comp: Computation,
                 vcomp: Optional[Computation]):
        super().__init__(input, schema)
        self.comp = comp    # row-level user computation
        self.vcomp = vcomp  # its cached vmapped (block-level) twin

    def _estimate(self) -> Estimate:
        rows, cols = self.input.estimate()
        if rows is None or cols is None:
            return rows, None
        out = dict(cols)
        for s in self.comp.outputs:  # row-level: dims ARE the cell dims
            out[s.name] = int(rows * _cell_bytes(s.dtype, s.shape.dims))
        return rows, out


class FilterNode(PlanNode):
    kind = "filter"

    def __init__(self, input: PlanNode, schema: Schema, comp: Computation):
        super().__init__(input, schema)
        self.comp = comp

    def _estimate(self) -> Estimate:
        # the epoch-keyed base cache re-invokes this after every new
        # observation, so the ratio is always current
        rows, cols = self.input.estimate()
        sel = observed_selectivity(self.comp)
        if sel is None or rows is None:
            # an upper bound, like the per-op hint: a filter keeps at
            # most its input
            return rows, cols
        return rows * sel, ({n: int(b * sel) for n, b in cols.items()}
                            if cols is not None else None)


class SelectNode(PlanNode):
    kind = "select"

    def __init__(self, input: PlanNode, schema: Schema,
                 names: Sequence[str]):
        super().__init__(input, schema)
        self.names = tuple(names)

    def describe(self) -> str:
        return f"select{list(self.names)}"

    def _estimate(self) -> Estimate:
        rows, cols = self.input.estimate()
        if cols is None:
            return rows, None
        return rows, {n: cols[n] for n in self.names if n in cols}


class JoinNode(PlanNode):
    """Leaf over a lazy join (``relational/join.py``): downstream chains
    fuse over the join result like any source, column pruning reaches INTO
    the join through :meth:`read_blocks` (build columns the chain never
    names are not gathered, probe passthrough columns not materialized),
    and :meth:`estimate` prices the join's output per column.
    ``strategy`` is ``"broadcast"`` or ``"sort_merge"``.
    """

    kind = "join"

    def __init__(self, left: PlanNode, right: Optional[PlanNode],
                 schema: Schema, on, how: str, strategy: str,
                 materialize):
        super().__init__(None, schema)
        self.left = left
        self.right = right
        self.on = tuple(on)
        self.how = how
        self.strategy = strategy
        self._materialize = materialize
        self.build = None  # the broadcast BuildTable, on that path

    def describe(self) -> str:
        return f"join[{self.strategy},{self.how}]{list(self.on)}"

    @property
    def frame(self):
        """The join result frame."""
        return self.result_ref() if self.result_ref is not None else None

    def read_blocks(self, names: Sequence[str]) -> List:
        """The join's blocks holding (at least) ``names``: the forced
        frame's cache when it exists, the join run for ``names`` only
        otherwise."""
        frame = self.frame
        if frame is not None and getattr(frame, "_cache", None):
            return frame._cache
        return self._materialize(list(names))

    def _rows_estimate(self, rows_l: Optional[float]) -> Optional[float]:
        """Output cardinality: a broadcast BuildTable prices the per-probe
        row expansion from its unique-key count (``build_rows /
        num_groups``, exactly 1 for unique keys, so 1:1 left joins stay
        exact); a sort-merge join over forced sides prices ``|L|·|R| /
        max(V(L), V(R))`` with HLL ``approx_key_distinct`` probes.
        Anything unprobeable keeps the probe side's row count."""
        if not rows_l:
            return rows_l
        build = self.build
        if build is not None and build.num_groups:
            rows = rows_l * (build.build_rows / build.num_groups)
            return max(rows, rows_l) if self.how == "left" else rows
        if self.right is not None:
            rows_r, _ = self.right.estimate()
            if rows_r:
                from ..relational.join import approx_key_distinct
                lf = (self.left.result_ref()
                      if self.left.result_ref is not None else None) \
                    or getattr(self.left, "frame", None)
                rf = (self.right.result_ref()
                      if self.right.result_ref is not None else None) \
                    or getattr(self.right, "frame", None)
                d_l = approx_key_distinct(lf, self.on) \
                    if lf is not None else None
                d_r = approx_key_distinct(rf, self.on) \
                    if rf is not None else None
                d = max([v for v in (d_l, d_r) if v] or [0.0])
                if d >= 1.0:
                    rows = rows_l * rows_r / d
                    return max(rows, rows_l) if self.how == "left" \
                        else rows
        return rows_l

    def _estimate(self) -> Estimate:
        rows_l, cols_l = self.left.estimate()
        rows = self._rows_estimate(rows_l)
        out: Dict[str, int] = {}
        if cols_l is not None:
            # left columns replicate with the expansion factor
            scale_l = (rows / rows_l) if rows_l and rows else 1.0
            out.update({n: int(b * scale_l) for n, b in cols_l.items()
                        if n in self.schema})
        build = self.build
        if build is not None and build.build_rows and rows:
            scale = rows / build.build_rows
            for f in build.value_fields:
                if f.name not in self.schema:
                    continue
                if f.name in build.tensor_names:
                    nb = int(build._sorted_host[f.name].nbytes * scale)
                else:
                    nb = int(8 * rows)
                out[f.name] = nb
        elif self.right is not None:
            rows_r, cols_r = self.right.estimate()
            if cols_r is not None and rows_r and rows:
                for n, b in cols_r.items():
                    if n in self.schema and n not in out:
                        out[n] = int(b * rows / rows_r)
        return rows, (out or None)


def node_for(frame) -> PlanNode:
    """The plan node producing ``frame``: its recorded op node, or a
    fresh :class:`SourceNode` leaf when it has none."""
    node = getattr(frame, "_plan_node", None)
    return node if node is not None else SourceNode(frame)


def attach(frame, node: PlanNode) -> None:
    """Record ``node`` as the plan of ``frame`` (called by the lazy ops
    right after they build the result frame)."""
    node.result_ref = weakref.ref(frame)
    frame._plan_node = node
