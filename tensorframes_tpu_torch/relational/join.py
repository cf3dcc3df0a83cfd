"""Joins: the broadcast hash join and the host sort-merge join.

The port's counterpart of ``tensorframes_tpu/relational/join.py``.

**Broadcast hash join** (small build side): the right frame factorizes ONCE
into a :class:`BuildTable`: sorted unique keys, group offsets, and its value
columns re-ordered by key and copied to the executor's device as torch
tensors, once, at construction. Each probe block then costs one host
key-match (a vectorized ``searchsorted`` into the sorted key table, the same
"host keys, device values" split ``aggregate`` uses) and ONE gather program
for all the build value columns it needs (``torch.index_select``), run
through the :class:`~..engine.executor.BlockExecutor`: only the block's
int32 build-row index crosses to the device; the resident build tensors are
passed in place.

Output order: probe (left) row order, block boundaries preserved; within a
probe row, build matches in build-row order. ``how`` is ``"inner"`` or
``"left"`` (unmatched left rows keep fill values: NaN for floats, bfloat16
included, 0 for ints, False for bools, ``""`` for strings; pass
``indicator=`` for an explicit int32 matched column).

**Sort-merge join**: both sides sort by key, with the host ``order_by``
or, given a ``mesh``, the mesh ``dsort`` (both stable, so both give the
same order), then the two key-sorted streams merge on the host with a
vectorized group-cartesian expansion. Output order: key-ascending, stable
by original row order within ties.

**Partitioned hash join** (a mesh, large build sides): both sides
hash-repartition by key through ``parallel.dexchange``; every shard builds
a :class:`BuildTable` over its own key range and probes its own left rows,
so a shard holds about 1/S of the build. A carried row id and one stable
sort restore the broadcast join's probe order, and the left frame's block
boundaries are re-cut: the result equals the broadcast join's.

``join()`` routes: broadcast without a mesh or for a build side estimated
under ``TFT_BROADCAST_LIMIT_BYTES`` (64 MiB); above it on a multi-shard
mesh, the partitioned join, or with ``TFT_SHUFFLE=0`` the mesh sort-merge
join (numeric keys). The decision is flight-recorded
(``relational.join_route``) and rendered by ``explain()``.

Both strategies are LAZY and record a :class:`~..plan.nodes.JoinNode`, so
downstream chains fuse over the join result, and column pruning reaches
INTO the join: build columns the chain never names are not gathered, and a
join's left side is read with only the columns the join needs (a left side
that is itself a join prunes in turn).

Under an active device budget the build table is a ledger entry: a build
over the ledger's resident threshold
(:meth:`~..memory.manager.MemoryManager.external_sort_threshold`) stays
on the host and is probed in contiguous-group chunks, each chunk's rows
copied for its own dispatch (``relational.build_chunks``, span
``join.probe_gather_chunk``); any other build makes room first and is
held as :class:`~..memory.spill.SpillableColumns`, so it can be spilled
under pressure and faults back at its next probe.

The ``relational.*`` counters keep the JAX package's names. A device lost
during one side's exchange shrinks only that side's mesh: the partitioned
join then re-exchanges the wider side at the narrower shard count
(``elastic.reshard``), so the key ranges line up again.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import dtypes as _dt
from .. import memory as _memory
from ..frame import Block, TensorFrame, _split_even
from ..schema import Field, Schema
from ..shape import Shape, Unknown
from ..utils.logging import get_logger
from ..utils.tracing import counters, span

__all__ = ["join", "broadcast_join", "sort_merge_join",
           "partitioned_hash_join", "BuildTable", "approx_key_distinct"]

_log = get_logger("relational.join")

_DEFAULT_BROADCAST_LIMIT = 64 << 20


def _fill_value(field):
    # bfloat16 columns are f32 on this package's host: a float, fills NaN
    kind = np.dtype(field.dtype.np_storage).kind
    if kind == "f":
        return np.nan
    if kind == "b":
        return False
    if kind in "iu":
        return 0
    return ""  # strings / objects


def _validate_on(left_schema: Schema, right_schema: Schema,
                 on: Sequence[str]) -> List[str]:
    from ..engine.ops import InputNotFoundError, InvalidTypeError
    on = [on] if isinstance(on, str) else list(on)
    if not on:
        raise ValueError("join needs at least one key column (on=)")
    for side, schema in (("left", left_schema), ("right", right_schema)):
        for k in on:
            f = schema.get(k)
            if f is None:
                raise InputNotFoundError(
                    f"join key {k!r} not in the {side} frame; columns: "
                    f"{schema.names}")
            if f.sql_rank != 0:
                raise InvalidTypeError(
                    f"join key {k!r} must be a scalar column")
    for k in on:
        lt = left_schema[k].dtype.tensor
        rt = right_schema[k].dtype.tensor
        if lt != rt:
            raise InvalidTypeError(
                f"join key {k!r} is numeric on one side and string on "
                f"the other; cast one side first")
    return on


def join_schema(left_schema: Schema, right_schema: Schema,
                on: Sequence[str], how: str,
                indicator: Optional[str]) -> Schema:
    """The join output schema: left fields, then the right VALUE fields
    (right order, key columns dropped: they equal the left copy), then the
    optional int32 indicator."""
    if how not in ("inner", "left"):
        raise ValueError(f"how must be 'inner' or 'left', got {how!r}")
    on = set(on)
    fields = list(left_schema)
    for f in right_schema:
        if f.name in on:
            continue
        if f.name in left_schema:
            raise ValueError(
                f"join would duplicate column {f.name!r}; select() or "
                f"rename one side first")
        fields.append(f)
    if indicator:
        if indicator in left_schema or indicator in right_schema:
            raise ValueError(
                f"indicator column {indicator!r} already exists")
        fields.append(Field(indicator, _dt.int32,
                            block_shape=Shape(Unknown), sql_rank=0))
    return Schema(fields)


def approx_key_distinct(frame, on: Sequence[str],
                        bits: int = 12) -> Optional[float]:
    """HLL distinct-count estimate of a FORCED frame's key column(s): one
    pass over the cached blocks, about 1.6% relative error at the default
    4,096 registers, cached on the frame per (keys, bits). ``None`` when
    the frame is unforced (estimates never force), a key is not numeric,
    or a key column is ragged. Feeds ``JoinNode.estimate()``'s output
    cardinality."""
    on = [on] if isinstance(on, str) else list(on)
    blocks = getattr(frame, "_cache", None)
    if not blocks:
        return None
    key = (tuple(on), int(bits))
    cache = getattr(frame, "_tft_key_distinct", None)
    if cache is not None and cache.get(key) is not None:
        return cache[key]
    for b in blocks:
        for k in on:
            if k not in b.columns:
                return None
            if b.num_rows and (b.is_ragged(k)
                               or b.dense(k).dtype.kind not in "biuf"):
                return None
    from .sketch import HllSketch, _hash64, _splitmix64
    sk = HllSketch(bits=bits)
    table = None
    for b in blocks:
        if b.num_rows == 0:
            continue
        h = _hash64(b.dense(on[0]))
        for k in on[1:]:
            h = _splitmix64(h ^ _hash64(b.dense(k)))
        part = sk.block_partial(h, np.zeros(b.num_rows, np.int64), 1)
        table = part if table is None else sk.combine_np(table, part)
    if table is None:
        return 0.0
    est = float(sk.finalize("d", table)["d"][0])
    counters.inc("relational.key_distinct_probes")
    if cache is None:
        cache = frame._tft_key_distinct = {}
    cache[key] = est
    return est


# ---------------------------------------------------------------------------
# the broadcast build table
# ---------------------------------------------------------------------------

class BuildTable:
    """The factorized, key-sorted, device-resident build side.

    Built ONCE (eagerly: the build frame forces here) and probed by every
    block of a join. Value columns are stored in key-sorted row order, so
    each key group's rows are a contiguous span ``[starts[g], starts[g] +
    counts[g])``: the unique-key fast path gathers row ``g`` directly, and
    the duplicate-key expansion gathers contiguous runs. The tensor value
    columns go to ``executor``'s device (default: the process executor's)
    at construction, in their device dtypes, and stay there (as a
    spillable ledger entry under a device budget), unless the budget is
    too small to hold them: then they stay on the host and each probe
    gathers chunk by chunk (``chunks``: contiguous-group row spans).
    """

    def __init__(self, frame: TensorFrame, on: Sequence[str],
                 executor=None):
        from ..engine.executor import default_executor, to_device
        from ..engine.ops import _factorize_keys

        self.on = [on] if isinstance(on, str) else list(on)
        self.schema = frame.schema
        _validate_on(frame.schema, frame.schema, self.on)
        merged = Block.concat(frame.blocks(), frame.schema)
        self.build_rows = merged.num_rows
        self.value_fields = [f for f in frame.schema
                             if f.name not in self.on]
        if merged.num_rows:
            fact = _factorize_keys(
                [np.asarray(merged.columns[k]) for k in self.on])
            self.uniques = [np.asarray(u) for u in fact.uniques]
            self.num_groups = fact.num_groups
            self.starts = np.asarray(fact.seg_starts, np.int64)
            self.counts = np.diff(
                np.append(self.starts, merged.num_rows)).astype(np.int64)
            order = fact.order
        else:
            self.uniques = [np.empty(0, np.asarray(
                merged.columns[k]).dtype if merged.columns[k] is not None
                else np.float64) for k in self.on]
            self.num_groups = 0
            self.starts = np.empty(0, np.int64)
            self.counts = np.empty(0, np.int64)
            order = np.empty(0, np.int64)
        self.unique_keys = bool(self.num_groups == self.build_rows)

        # key-sorted value columns; tensor columns are device-gather
        # candidates, strings/ragged stay host ride-alongs
        self.host_cols: Dict[str, object] = {}
        self.tensor_names: List[str] = []
        sorted_tensor: Dict[str, np.ndarray] = {}
        for f in self.value_fields:
            col = merged.columns[f.name]
            if f.dtype.tensor and isinstance(col, np.ndarray):
                sorted_tensor[f.name] = col[order]
                self.tensor_names.append(f.name)
            elif isinstance(col, np.ndarray):
                self.host_cols[f.name] = col[order]
            else:  # ragged list column
                self.host_cols[f.name] = [col[i] for i in order]
        self._sorted_host = sorted_tensor
        self.dev_bytes = sum(int(a.nbytes) for a in sorted_tensor.values())
        self.executor = executor or default_executor()
        # ledger admission: hold the build table device-resident when it
        # fits, else keep it host-side and probe in budget-sized
        # contiguous-group chunks
        mgr = _memory.active()
        self.chunks: Optional[List[Tuple[int, int]]] = None  # row spans
        self.dev_cols = {}
        threshold = (mgr.external_sort_threshold()
                     if mgr is not None and mgr.spill_enabled else None)
        if threshold is not None and self.dev_bytes > threshold \
                and self.build_rows:
            # chunks sized so that the executor's 2x dispatch estimate
            # still admits under the threshold (no overflow admissions)
            n_chunks = int(np.ceil(self.dev_bytes / max(1, threshold // 2)))
            self.chunks = self._chunk_spans(n_chunks)
            self.dev_cols = None
            counters.inc("relational.build_chunks", len(self.chunks))
            _log.info(
                "join build side (%d B) exceeds the ledger's resident "
                "threshold (%d B); probing in %d contiguous-group chunk(s) "
                "instead of holding it resident", self.dev_bytes, threshold,
                len(self.chunks))
        elif sorted_tensor:
            # resident: one host->device copy per column, here and never
            # again (a spill and its fault-back aside)
            if mgr is not None and self.dev_bytes:
                mgr.make_room(self.dev_bytes)
            device = self.executor.resolve()
            dev = {name: to_device(a, _dt.device_dtype(
                       self.schema[name].dtype), device)
                   for name, a in sorted_tensor.items()}
            self.dev_cols = (_memory.spillable_columns(
                f"join.build@{id(self):x}", dev, mgr)
                if mgr is not None else dev)
        # cached probe computations: (names, rows) -> Computation
        self._comps: Dict[Tuple, object] = {}
        self._comp_lock = threading.Lock()

    def _chunk_spans(self, n_chunks: int) -> List[Tuple[int, int]]:
        """Contiguous-GROUP row spans of roughly equal rows: a key lives in
        exactly one chunk, so per-chunk probe results combine exactly."""
        n_chunks = max(1, min(n_chunks, self.num_groups or 1))
        bounds = np.linspace(0, self.build_rows, n_chunks + 1)
        gbounds = np.searchsorted(self.starts, bounds[1:-1], side="left")
        row_bounds = [0] + [int(self.starts[g]) if g < self.num_groups
                            else self.build_rows for g in gbounds] \
            + [self.build_rows]
        spans = []
        for a, b in zip(row_bounds[:-1], row_bounds[1:]):
            if b > a:
                spans.append((a, b))
        return spans or [(0, self.build_rows)]

    # -- key matching ------------------------------------------------------
    def match(self, key_arrays: List[np.ndarray]
              ) -> Tuple[np.ndarray, np.ndarray]:
        """``(group_id int64 with -1 for no match, matched bool)`` per
        probe row."""
        n = len(key_arrays[0])
        if self.num_groups == 0 or n == 0:
            return np.full(n, -1, np.int64), np.zeros(n, bool)
        if len(self.on) == 1:
            uniq = self.uniques[0]
            probe = np.asarray(key_arrays[0])
            idx = np.searchsorted(uniq, probe)
            idxc = np.minimum(idx, len(uniq) - 1)
            matched = uniq[idxc] == probe
            gid = np.where(matched, idxc, -1).astype(np.int64)
            return gid, np.asarray(matched, bool)
        # composite keys: factorize the (small) unique table together with
        # the probe keys; probe groups landing on a build group id are
        # matches (exact for every dtype, strings included)
        from ..engine.ops import _factorize_keys
        g = self.num_groups
        cat = [np.concatenate([u, np.asarray(p)])
               for u, p in zip(self.uniques, key_arrays)]
        gf = _factorize_keys(cat)
        inv = np.full(gf.num_groups, -1, np.int64)
        inv[gf.ids[:g]] = np.arange(g)
        gid = inv[gf.ids[g:]]
        return gid, gid >= 0

    # -- the device gather -------------------------------------------------
    def _probe_comp(self, names: Tuple[str, ...], rows: int):
        """The gather program for ``names``, one per (names, rows). Its
        specs are given, not captured: the build dim is fixed at ``rows``,
        the probe dim Unknown, and nothing is probed or run to settle
        them."""
        key = (names, rows)
        with self._comp_lock:
            comp = self._comps.get(key)
        if comp is not None:
            return comp
        import torch

        from ..computation import Computation, TensorSpec

        def fn(d):
            idx = d["_tft_idx"]
            return {n: torch.index_select(d[f"_tft_t_{n}"], 0, idx)
                    for n in names}

        in_specs = [TensorSpec("_tft_idx", _dt.int32, Shape(Unknown))]
        out_specs = []
        for n in names:
            f = self.schema[n]
            cell = self._sorted_host[n].shape[1:]
            in_specs.append(TensorSpec(f"_tft_t_{n}", f.dtype,
                                       Shape((rows,) + cell)))
            out_specs.append(TensorSpec(n, f.dtype,
                                        Shape((Unknown,) + cell)))
        comp = Computation(fn, in_specs, out_specs)
        with self._comp_lock:
            comp = self._comps.setdefault(key, comp)
        return comp

    def gather_device(self, names: Sequence[str], idx: np.ndarray,
                      gid: np.ndarray, executor=None
                      ) -> Dict[str, np.ndarray]:
        """Gather the named build columns at ``idx`` (build-row per output
        row): ONE dispatch through the executor on the resident path, whose
        only host input is the int32 index; one per chunk on the chunked
        path."""
        names = tuple(n for n in names if n in self._sorted_host)
        if not names:
            return {}
        ex = executor or self.executor
        if not len(idx):
            return {n: self._sorted_host[n][:0].copy() for n in names}
        if self.chunks is None:
            arrays = {"_tft_idx": idx.astype(np.int32)}
            for n in names:
                arrays[f"_tft_t_{n}"] = self.dev_cols[n]
            comp = self._probe_comp(names, self.build_rows)
            counters.inc("relational.probe_dispatches")
            with span("join.probe_gather"):
                return ex.run(comp, arrays)
        # chunked probe: each chunk's rows are copied for this dispatch only
        # (admitted by the executor's own reservation); results select by
        # span membership, a build row lying in exactly one span
        out = {n: None for n in names}
        for a, b in self.chunks:
            sel = (idx >= a) & (idx < b)
            local = np.where(sel, idx - a, 0).astype(np.int32)
            arrays = {"_tft_idx": local}
            for n in names:
                arrays[f"_tft_t_{n}"] = self._sorted_host[n][a:b]
            comp = self._probe_comp(names, b - a)
            counters.inc("relational.probe_dispatches")
            with span("join.probe_gather_chunk"):
                part = ex.run(comp, arrays)
            for n in names:
                if out[n] is None:
                    out[n] = part[n].copy()
                else:
                    out[n][sel] = part[n][sel]
        return out


# ---------------------------------------------------------------------------
# per-block probe
# ---------------------------------------------------------------------------

def _gather_host(col, idx: np.ndarray):
    if isinstance(col, np.ndarray):
        return col[idx]
    return [col[i] for i in idx]


def _mask_host(col, mask: np.ndarray):
    if isinstance(col, np.ndarray):
        return col[mask]
    return [col[i] for i in np.flatnonzero(mask)]


def _fill_unmatched(arr, field, valid: np.ndarray):
    fill = _fill_value(field)
    if isinstance(arr, np.ndarray):
        out = arr.copy() if not arr.flags.writeable else arr
        out[~valid] = fill
        return out
    return [a if v else fill for a, v in zip(arr, valid)]


def _empty_build_cols(build: BuildTable, names: Sequence[str],
                      n: int) -> Dict[str, object]:
    cols: Dict[str, object] = {}
    for f in build.value_fields:
        if f.name not in names:
            continue
        if f.name in build.tensor_names:
            src = build._sorted_host[f.name]
            cols[f.name] = np.full((n,) + src.shape[1:], _fill_value(f),
                                   src.dtype)
        else:
            src = build.host_cols[f.name]
            if isinstance(src, np.ndarray):
                cols[f.name] = np.full((n,) + src.shape[1:],
                                       _fill_value(f), src.dtype)
            else:
                cols[f.name] = [_fill_value(f)] * n
    return cols


def probe_block(build: BuildTable, block: Block, how: str,
                out_names: Sequence[str],
                indicator: Optional[str] = None,
                executor=None) -> Block:
    """Join one probe block against the build table; returns the output
    block restricted to ``out_names`` (the pruning surface)."""
    with span("join.probe"):
        return _probe_block(build, block, how, out_names, indicator,
                            executor)


def _probe_block(build, block, how, out_names, indicator, executor):
    out_set = set(out_names)
    left_names = [n for n in block.columns if n in out_set]
    build_names = [f.name for f in build.value_fields
                   if f.name in out_set]
    n = block.num_rows
    if n == 0:
        cols: Dict[str, object] = {m: block.columns[m][:0]
                                   if isinstance(block.columns[m],
                                                 np.ndarray)
                                   else [] for m in left_names}
        cols.update(_empty_build_cols(build, build_names, 0))
        if indicator and indicator in out_set:
            cols[indicator] = np.empty(0, np.int32)
        return Block(cols, 0)

    keys = [np.asarray(block.columns[k]) for k in build.on]
    with span("join.match"):
        gid, matched = build.match(keys)

    if build.unique_keys or build.num_groups == 0:
        # 1:1 (or 1:0): no expansion
        if how == "inner":
            keep = matched
            n_out = int(keep.sum())
            sel_gid = gid[keep]
            idx = (build.starts[sel_gid] if n_out else
                   np.empty(0, np.int64))
            valid = np.ones(n_out, bool)
            cols = {m: _mask_host(block.columns[m], keep)
                    for m in left_names}
        else:
            n_out = n
            idx = np.where(matched, build.starts[np.maximum(gid, 0)]
                           if build.num_groups else 0, 0)
            valid = matched
            cols = {m: block.columns[m] for m in left_names}
    else:
        # duplicate build keys: expand each probe row by its group size
        cnt = np.where(matched,
                       build.counts[np.maximum(gid, 0)], 0)
        out_cnt = np.maximum(cnt, 1) if how == "left" else cnt
        total = int(out_cnt.sum())
        rep = np.repeat(np.arange(n), out_cnt)
        offsets = np.concatenate([[0], np.cumsum(out_cnt)[:-1]])
        within = np.arange(total) - offsets[rep]
        m_rep = matched[rep]
        idx = np.where(
            m_rep,
            build.starts[np.maximum(gid[rep], 0)] + within, 0)
        valid = m_rep
        n_out = total
        cols = {m: _gather_host(block.columns[m], rep)
                for m in left_names}

    if n_out and build.num_groups:
        dev_names = [m for m in build_names if m in build.tensor_names]
        gathered = build.gather_device(dev_names, idx, gid,
                                       executor=executor)
        for m in dev_names:
            a = gathered[m]
            if how == "left" and not valid.all():
                a = _fill_unmatched(np.array(a, copy=True),
                                    build.schema[m], valid)
            cols[m] = a
        for m in build_names:
            if m in build.tensor_names:
                continue
            a = _gather_host(build.host_cols[m], idx)
            if how == "left" and not valid.all():
                a = _fill_unmatched(
                    a if not isinstance(a, np.ndarray) else a.copy(),
                    build.schema[m], valid)
            cols[m] = a
    else:
        cols.update(_empty_build_cols(build, build_names, n_out))
    if indicator and indicator in out_set:
        cols[indicator] = valid.astype(np.int32) if n_out else \
            np.empty(0, np.int32)
    counters.inc("relational.rows_joined", n_out)
    return Block(cols, n_out)


# ---------------------------------------------------------------------------
# the lazy join frames
# ---------------------------------------------------------------------------

def _attach_join_node(out: TensorFrame, left: TensorFrame,
                      right: Optional[TensorFrame], on, how: str,
                      strategy: str, materialize) -> None:
    from ..plan.nodes import JoinNode, attach, node_for
    attach(out, JoinNode(
        node_for(left), node_for(right) if right is not None else None,
        out.schema, on, how, strategy, materialize))


def _pruned(frame: TensorFrame, names: Sequence[str],
            on: Sequence[str]) -> TensorFrame:
    """``frame`` with only the columns among ``names`` and the keys: a
    ``select`` when that drops columns, so that the logical plan prunes
    the read (into a join leaf, too) and the per-op path slices."""
    want = set(names) | set(on)
    keep = [n for n in frame.schema.names if n in want]
    return frame.select(keep) if len(keep) < len(frame.schema) else frame


def broadcast_join(left: TensorFrame, right=None, on=None,
                   how: str = "inner", indicator: Optional[str] = None,
                   build: Optional[BuildTable] = None,
                   executor=None) -> TensorFrame:
    """Broadcast hash join: build the right side once (now), probe ``left``
    block by block (lazy). Pass ``build=`` to reuse a prebuilt
    :class:`BuildTable`."""
    if build is None:
        if right is None:
            raise ValueError("broadcast_join needs right= or build=")
        build = BuildTable(right, on, executor=executor)
    on = build.on
    out_schema = join_schema(left.schema, build.schema, on, how,
                             indicator)
    _validate_on(left.schema, build.schema, on)
    counters.inc("relational.broadcast_joins")

    def materialize(names: Sequence[str]) -> List[Block]:
        return [probe_block(build, b, how, list(names),
                            indicator=indicator, executor=executor)
                for b in _pruned(left, names, on).blocks()]

    rows_h, _ = _left_rows_hint(left)
    out = TensorFrame(
        out_schema, lambda: materialize(out_schema.names),
        left.num_partitions,
        plan=f"join[broadcast,{how}]({left._plan})",
        rows_hint=rows_h if how == "left" or build.unique_keys else None)
    _attach_join_node(out, left, None, on, how, "broadcast", materialize)
    # the node prices build columns from the BuildTable directly
    out._plan_node.build = build
    return out


def _left_rows_hint(left: TensorFrame):
    from ..memory.estimate import frame_estimate
    rows, nbytes = frame_estimate(left)
    return (int(rows) if rows is not None else None,
            nbytes)


def _sorted_merged(df: TensorFrame, names: Sequence[str],
                   on: List[str], mesh=None) -> Block:
    """The frame's rows (at least ``names`` and the keys) as ONE block,
    key-sorted ascending, stable by original row order: through the mesh
    ``dsort`` (with its external-sort route) when a mesh is given, the
    host ``order_by`` otherwise. Both are stable, so both give the same
    order."""
    sub = _pruned(df, names, on)
    if mesh is not None and sum(b.num_rows for b in sub.blocks()) > 0:
        from ..parallel.distributed import distribute, dsort
        sorted_df = dsort(on, distribute(sub, mesh)).collect_frame()
        return Block.concat(sorted_df.blocks(), sub.schema)
    return Block.concat(sub.order_by(*on).blocks(), sub.schema)


def _group_spans(key_arrays: List[np.ndarray]
                 ) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """``(uniques, starts, counts)`` of already-sorted key columns."""
    n = len(key_arrays[0])
    if n == 0:
        return [a[:0] for a in key_arrays], np.empty(0, np.int64), \
            np.empty(0, np.int64)
    changed = np.zeros(n, bool)
    changed[0] = True
    for a in key_arrays:
        changed[1:] |= a[1:] != a[:-1]
    starts = np.flatnonzero(changed).astype(np.int64)
    counts = np.diff(np.append(starts, n)).astype(np.int64)
    return [a[starts] for a in key_arrays], starts, counts


def sort_merge_join(left: TensorFrame, right: TensorFrame, on,
                    how: str = "inner", mesh=None,
                    indicator: Optional[str] = None) -> TensorFrame:
    """Sort-merge join (lazy).

    Keys must be numeric scalars; string columns ride along. Given a
    ``mesh``, both sides sort there through ``parallel.dsort`` (the same
    order). Output is key-sorted, stable by original row order within
    equal keys, and re-partitioned to the left frame's partition count.
    """
    from ..parallel.mesh import refuse_cluster
    refuse_cluster(mesh, "sort_merge_join(mesh=)")
    on = _validate_on(left.schema, right.schema,
                      [on] if isinstance(on, str) else list(on))
    from ..engine.ops import InvalidTypeError
    for k in on:
        if not left.schema[k].dtype.tensor:
            raise InvalidTypeError(
                f"sort_merge_join key {k!r} must be numeric (the dsort "
                f"contract); use the partitioned strategy for string "
                f"keys")
    out_schema = join_schema(left.schema, right.schema, on, how,
                             indicator)
    counters.inc("relational.sort_merge_joins")
    right_values = [f for f in right.schema if f.name not in on]

    def materialize(names: Sequence[str]) -> List[Block]:
        out_set = set(names)
        with span("join.sort_merge"):
            lm = _sorted_merged(left, names, on, mesh)
            rm = _sorted_merged(right, names, on, mesh)
            lkeys = [np.asarray(lm.columns[k]) for k in on]
            rkeys = [np.asarray(rm.columns[k]) for k in on]
            lu, lstarts, lcounts = _group_spans(lkeys)
            ru, rstarts, rcounts = _group_spans(rkeys)
            # map each left group to its right group (both unique tables
            # are sorted; composite keys reuse the matcher's factorization)
            if len(lu[0]) and len(ru[0]):
                if len(on) == 1:
                    pos = np.searchsorted(ru[0], lu[0])
                    posc = np.minimum(pos, len(ru[0]) - 1)
                    lmatch = ru[0][posc] == lu[0]
                    rgrp = np.where(lmatch, posc, 0)
                else:
                    from ..engine.ops import _factorize_keys
                    g = len(ru[0])
                    cat = [np.concatenate([u, v])
                           for u, v in zip(ru, lu)]
                    gf = _factorize_keys(cat)
                    inv = np.full(gf.num_groups, -1, np.int64)
                    inv[gf.ids[:g]] = np.arange(g)
                    mapped = inv[gf.ids[g:]]
                    lmatch = mapped >= 0
                    rgrp = np.maximum(mapped, 0)
            else:
                lmatch = np.zeros(len(lu[0]) if lu else 0, bool)
                rgrp = np.zeros(len(lu[0]) if lu else 0, np.int64)
            cb = np.where(lmatch, rcounts[rgrp] if len(rcounts)
                          else 0, 0)
            cb_eff = np.maximum(cb, 1) if how == "left" else cb
            group_rows = lcounts * cb_eff
            total = int(group_rows.sum())
            og = np.repeat(np.arange(len(lcounts)), group_rows)
            shift = np.concatenate([[0], np.cumsum(group_rows)[:-1]])
            pos = np.arange(total) - shift[og]
            denom = cb_eff[og]
            l_idx = lstarts[og] + pos // denom
            r_off = pos % denom
            valid = lmatch[og]
            r_idx = np.where(valid,
                             (rstarts[rgrp[og]] if len(rstarts) else 0)
                             + r_off, 0)
            cols: Dict[str, object] = {}
            for f in left.schema:
                if f.name in out_set:
                    cols[f.name] = _gather_host(lm.columns[f.name],
                                                l_idx)
            for f in right_values:
                if f.name not in out_set:
                    continue
                src = rm.columns[f.name]
                if rm.num_rows == 0:
                    # empty right side: every output row is a fill
                    if isinstance(src, np.ndarray):
                        a = np.full((total,) + src.shape[1:],
                                    _fill_value(f), src.dtype)
                    else:
                        a = [_fill_value(f)] * total
                else:
                    a = _gather_host(src, r_idx)
                    if how == "left" and not valid.all():
                        a = _fill_unmatched(
                            a.copy() if isinstance(a, np.ndarray)
                            else a, f, valid)
                cols[f.name] = a
            if indicator and indicator in out_set:
                cols[indicator] = valid.astype(np.int32)
            counters.inc("relational.rows_joined", total)
            spans = _split_even(total, left.num_partitions)
            return [Block({n_: (c[a:b] if isinstance(c, np.ndarray)
                                else list(c[a:b]))
                           for n_, c in cols.items()}, b - a)
                    for a, b in spans]

    rows_h, _ = _left_rows_hint(left)
    out = TensorFrame(
        out_schema, lambda: materialize(out_schema.names),
        left.num_partitions,
        plan=f"join[sort_merge,{how}]({left._plan})",
        rows_hint=rows_h if how == "left" else None)
    _attach_join_node(out, left, right, on, how, "sort_merge",
                      materialize)
    return out


# ---------------------------------------------------------------------------
# partitioned hash join (shuffle exchange)
# ---------------------------------------------------------------------------

_PROW = "_tft_prow"  # the carried probe row id column (internal)


def _partition_keys_ok(left_schema: Schema, right_schema: Schema,
                       on: Sequence[str]) -> bool:
    """Whether the exchange may hash these keys: present on both sides,
    scalar, equally host or device, and (device keys) of the same
    storage dtype: the device hash is a bit hash, so an int32 key against
    an int64 one would place equal values on different shards."""
    for k in on:
        lf = left_schema.get(k)
        rf = right_schema.get(k)
        if lf is None or rf is None:
            return False
        if lf.sql_rank != 0 or rf.sql_rank != 0:
            return False
        if lf.dtype.tensor != rf.dtype.tensor:
            return False
        if lf.dtype.tensor and (np.dtype(lf.dtype.np_storage)
                                != np.dtype(rf.dtype.np_storage)):
            return False
    return True


def _empty_like(field):
    if not field.dtype.tensor:
        return []
    cell = ()
    if field.block_shape is not None:
        cell = tuple(d if isinstance(d, int) and d > 0 else 0
                     for d in field.block_shape.dims[1:])
    return np.empty((0,) + cell, field.dtype.np_storage)


def partitioned_hash_join(left: TensorFrame, right: TensorFrame, on,
                          how: str = "inner", mesh=None,
                          indicator: Optional[str] = None) -> TensorFrame:
    """Shuffle-partitioned hash join (lazy): BOTH sides hash-repartition by
    key through :func:`~..parallel.exchange.dexchange`, then every shard
    builds a :class:`BuildTable` over ONLY its own key range and probes
    only its own left rows: a shard's build memory is O(R/S) instead of
    broadcast's O(R). Equal keys land on one shard (placement is a
    function of the key value and the shard count), so the shards' probes
    see every match.

    The output equals :func:`broadcast_join`'s: a carried row id restores
    the probe order with one stable sort and the left frame's block
    boundaries are re-cut. String keys hash on the host; key STORAGE
    dtypes must match across sides. An empty side, a one-shard mesh or
    ``TFT_SHUFFLE=0`` falls back to the broadcast join, with the same
    result. Per-shard and global build bytes are recorded on the result
    as ``_partitioned_info`` when it is forced."""
    from ..parallel.mesh import refuse_cluster
    refuse_cluster(mesh, "partitioned_hash_join(mesh=)")
    if mesh is None:
        raise ValueError("partitioned_hash_join needs a mesh; use "
                         "broadcast_join for host-only frames")
    on = _validate_on(left.schema, right.schema,
                      [on] if isinstance(on, str) else list(on))
    from ..engine.ops import InvalidTypeError
    if not _partition_keys_ok(left.schema, right.schema, on):
        raise InvalidTypeError(
            f"partitioned_hash_join keys {on!r} have mismatched storage "
            f"dtypes across sides; cast one side first")
    from ..parallel import exchange as _ex
    if not _ex.shuffle_enabled() or mesh.num_data_shards <= 1:
        counters.inc("relational.partitioned_fallbacks")
        return broadcast_join(left, right, on, how=how,
                              indicator=indicator)
    out_schema = join_schema(left.schema, right.schema, on, how,
                             indicator)
    counters.inc("relational.partitioned_joins")

    def materialize(names: Sequence[str]) -> List[Block]:
        out_set = set(names)
        with span("join.partitioned"):
            from ..parallel.distributed import distribute
            lneeded = [f.name for f in left.schema
                       if f.name in out_set or f.name in on]
            rneeded = [f.name for f in right.schema
                       if f.name in out_set or f.name in on]
            lf = left.select(lneeded) \
                if set(lneeded) != set(left.schema.names) else left
            rf = right.select(rneeded) \
                if set(rneeded) != set(right.schema.names) else right
            lblocks = lf.blocks()
            lm = Block.concat(lblocks, lf.schema)
            block_sizes = [b.num_rows for b in lblocks]
            rm = Block.concat(rf.blocks(), rf.schema)
            if lm.num_rows == 0 or rm.num_rows == 0:
                # a degenerate side: the broadcast join IS the
                # partitioned plan here (an empty exchange buys nothing)
                counters.inc("relational.partitioned_fallbacks")
                build = BuildTable(rf, on)
                return [probe_block(build, b, how, list(names),
                                    indicator=indicator)
                        for b in lblocks]
            lcols = dict(lm.columns)
            lcols[_PROW] = np.arange(lm.num_rows, dtype=np.int64)
            lschema = Schema(list(lf.schema) + [Field(_PROW, _dt.int64)])
            lex = _ex.dexchange(on, distribute(
                TensorFrame.from_columns(lcols, schema=lschema), mesh))
            rex = _ex.dexchange(on, distribute(
                TensorFrame.from_columns(dict(rm.columns),
                                         schema=rf.schema), mesh))
            # a device lost during one exchange shrinks only that side;
            # re-exchange the wider side at the narrower shard count so key
            # ranges line up again (counts only ever decrease)
            from ..parallel import elastic as _elastic
            while (lex.mesh.num_data_shards
                   != rex.mesh.num_data_shards):
                if (lex.mesh.num_data_shards
                        > rex.mesh.num_data_shards):
                    lex = _ex.dexchange(
                        on, _elastic.reshard(lex, rex.mesh))
                else:
                    rex = _ex.dexchange(
                        on, _elastic.reshard(rex, lex.mesh))
            S = lex.mesh.num_data_shards
            lrp = lex.padded_rows // S
            rrp = rex.padded_rows // S
            lvalid = lex.per_shard_valid()
            rvalid = rex.per_shard_valid()
            lhost = {n: lex.host_read_padded(n) for n in lneeded + [_PROW]}
            rhost = {n: rex.host_read_padded(n) for n in rneeded}

            def shard_cols(host, schema, rows_per, s, k):
                out = {}
                for n, full in host.items():
                    a = full[s * rows_per: s * rows_per + k]
                    fld = schema[n]
                    if isinstance(a, np.ndarray) and fld.dtype.tensor \
                            and a.dtype != fld.dtype.np_storage:
                        a = a.astype(fld.dtype.np_storage)
                    out[n] = a
                return out

            probe_names = list(names) + [_PROW]
            parts: List[Block] = []
            build_bytes: List[int] = []
            for s in range(S):
                lk = int(lvalid[s])
                rk = int(rvalid[s])
                if lk == 0:
                    continue
                rshard = TensorFrame.from_columns(
                    shard_cols(rhost, rex.schema, rrp, s, rk),
                    schema=rf.schema)
                build = BuildTable(rshard, on)
                build_bytes.append(int(build.dev_bytes))
                lblk = Block(shard_cols(lhost, lex.schema, lrp, s, lk), lk)
                parts.append(probe_block(build, lblk, how, probe_names,
                                         indicator=indicator))
            part_schema = Schema([out_schema[n] for n in names
                                  if out_schema.get(n) is not None]
                                 + [Field(_PROW, _dt.int64)])
            if parts:
                cat = Block.concat(parts, part_schema)
            else:
                cat = Block({n: (np.empty(0, np.int64) if n == _PROW
                                 else _empty_like(out_schema[n]))
                             for n in part_schema.names}, 0)
            # the matches of one probe row all lie on ONE shard (equal
            # keys land together), so a stable sort by the carried row id
            # restores the broadcast join's probe order exactly
            prow = np.asarray(cat.columns[_PROW])
            perm = np.argsort(prow, kind="stable")
            prow_sorted = prow[perm]
            cols = {n: (cat.columns[n][perm]
                        if isinstance(cat.columns[n], np.ndarray)
                        else [cat.columns[n][i] for i in perm])
                    for n in part_schema.names if n != _PROW}
            counters.inc("relational.partitioned_probe_rows",
                         int(lm.num_rows))
            out._partitioned_info = {
                "shards": S,
                "build_bytes": build_bytes,
                "max_build_bytes": max(build_bytes, default=0),
                "global_build_bytes": int(sum(build_bytes)),
            }
            ex_info = getattr(lex, "_exchange", None)
            if ex_info is not None:
                out._exchange_skew = ex_info
            # re-cut the left frame's block boundaries
            bounds = np.cumsum(np.asarray(block_sizes, np.int64))
            splits = np.searchsorted(prow_sorted, bounds, side="left")
            blocks: List[Block] = []
            a = 0
            for b in splits.tolist():
                blocks.append(Block(
                    {n: (c[a:b] if isinstance(c, np.ndarray)
                         else list(c[a:b])) for n, c in cols.items()},
                    b - a))
                a = b
            return blocks

    rows_h, _ = _left_rows_hint(left)
    out = TensorFrame(
        out_schema, lambda: materialize(out_schema.names),
        left.num_partitions,
        plan=f"join[partitioned,{how}]({left._plan})",
        rows_hint=rows_h if how == "left" else None)
    _attach_join_node(out, left, right, on, how, "partitioned",
                      materialize)
    return out


def _broadcast_limit() -> int:
    try:
        return int(os.environ.get("TFT_BROADCAST_LIMIT_BYTES",
                                  _DEFAULT_BROADCAST_LIMIT))
    except ValueError:
        return _DEFAULT_BROADCAST_LIMIT


def _route_join(left: TensorFrame, right: TensorFrame, on_l, mesh,
                how: str) -> Tuple[str, Dict[str, object]]:
    """``join()``'s routing, with the decision record the flight ring
    keeps: the strategy, the estimated build bytes it was judged on
    (``frame_estimate``) and the limit it was judged against."""
    from ..parallel import exchange as _ex
    limit = _broadcast_limit()
    _, rbytes = _memory.frame_estimate(right)
    oversized = mesh is not None and (rbytes is None or rbytes > limit)
    tensor_keys = all(
        left.schema.get(k) is not None and left.schema[k].dtype.tensor
        for k in on_l)
    shuffle_ok = (_ex.shuffle_enabled() and mesh is not None
                  and getattr(mesh, "num_data_shards", 1) > 1
                  and _partition_keys_ok(left.schema, right.schema, on_l))
    strategy = "broadcast"
    reason = "no mesh" if mesh is None else "build fits"
    if oversized:
        if shuffle_ok:
            # over the limit on a multi-shard mesh: shuffle both sides
            # (string keys too)
            strategy = "partitioned"
            reason = "build over limit"
        elif tensor_keys:
            strategy = "sort_merge"
            reason = ("build over limit (shuffle off)"
                      if mesh is not None else "build over limit")
        else:
            # string keys without the shuffle can only broadcast
            reason = "string keys, shuffle off"
    route = {"strategy": strategy, "reason": reason,
             "est_build_bytes": (int(rbytes) if rbytes is not None
                                 else None),
             "limit": limit, "how": how,
             "shuffle": bool(_ex.shuffle_enabled()),
             "keys": list(on_l)}
    return strategy, route


def join(left: TensorFrame, right: TensorFrame, on,
         how: str = "inner", strategy: Optional[str] = None,
         mesh=None, indicator: Optional[str] = None) -> TensorFrame:
    """Join two frames (lazy). ``strategy=None`` routes: the broadcast
    join for a build side estimated under ``TFT_BROADCAST_LIMIT_BYTES``
    (default 64 MiB) or without a mesh; the shuffle-partitioned hash join
    for a larger build on a multi-shard mesh (string keys included); the
    mesh sort-merge join when the shuffle is off (``TFT_SHUFFLE=0``) and
    the keys are numeric. The choice is flight-recorded
    (``relational.join_route``; ``ttf.why()`` renders it), kept on the
    result as ``_join_route`` and rendered by ``explain()``."""
    from ..parallel.mesh import refuse_cluster
    refuse_cluster(mesh, "join(mesh=)")
    on_l = [on] if isinstance(on, str) else list(on)
    route = None
    if strategy is None:
        strategy, route = _route_join(left, right, on_l, mesh, how)
    if strategy == "broadcast":
        out = broadcast_join(left, right, on, how=how,
                             indicator=indicator)
    elif strategy == "sort_merge":
        out = sort_merge_join(left, right, on, how=how, mesh=mesh,
                              indicator=indicator)
    elif strategy == "partitioned":
        out = partitioned_hash_join(left, right, on, how=how, mesh=mesh,
                                    indicator=indicator)
    else:
        raise ValueError(
            f"unknown join strategy {strategy!r}; use 'broadcast', "
            f"'sort_merge', or 'partitioned'")
    if route is not None:
        from ..observability import flight as _flight
        _flight.record("relational.join_route", **route)
        out._join_route = route
    return out


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

_REL_FAMILIES = (
    ("relational.broadcast_joins", "tft_relational_broadcast_joins_total",
     "Broadcast hash joins defined."),
    ("relational.sort_merge_joins",
     "tft_relational_sort_merge_joins_total",
     "Sort-merge joins defined."),
    ("relational.partitioned_joins",
     "tft_relational_partitioned_joins_total",
     "Shuffle-partitioned hash joins defined."),
    ("relational.partitioned_fallbacks",
     "tft_relational_partitioned_fallbacks_total",
     "Partitioned joins that fell back to broadcast (TFT_SHUFFLE=0, "
     "single-shard mesh, or a degenerate empty side)."),
    ("relational.partitioned_probe_rows",
     "tft_relational_partitioned_probe_rows_total",
     "Probe rows routed through the shuffle exchange."),
    ("relational.rows_joined", "tft_relational_rows_joined_total",
     "Join output rows produced."),
    ("relational.probe_dispatches",
     "tft_relational_probe_dispatches_total",
     "Fused build-table gather programs dispatched."),
    ("relational.build_chunks", "tft_relational_build_chunks_total",
     "Build-side chunks created because the ledger refused a resident "
     "broadcast."),
    ("relational.sketch_folds", "tft_relational_sketch_folds_total",
     "Sketch partial tables folded (aggregate/daggregate/stream)."),
    ("relational.key_distinct_probes",
     "tft_relational_key_distinct_probes_total",
     "HLL key-distinct probes run for join cardinality estimates."),
)


def _render_metrics() -> List[str]:
    snap = counters.snapshot()
    lines: List[str] = []
    for key, fam, help_text in _REL_FAMILIES:
        lines.append(f"# HELP {fam} {help_text}")
        lines.append(f"# TYPE {fam} counter")
        lines.append(f"{fam} {snap.get(key, 0)}")
    return lines


from ..observability import metrics as _metrics  # noqa: E402

_metrics.register_metrics_provider("relational", _render_metrics)
