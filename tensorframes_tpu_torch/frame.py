"""TensorFrame: a partitioned, columnar DataFrame for tensor programs.

The port's counterpart of ``tensorframes_tpu/frame.py``. A
:class:`TensorFrame` is a :class:`~.schema.Schema` carrying tensor metadata
plus a list of **blocks** (one per partition), each a dict of columnar numpy
arrays on the host. The executor copies a block's input columns to the
device as torch tensors and its outputs back.

Laziness matches the JAX package: ``map_*`` and ``filter`` return a lazy
frame (a thunk chain, forced by ``collect``/``blocks``/``count``), while
``reduce_*``/``aggregate`` are eager.

Ragged columns (rows holding vectors of varying length) are stored as lists
of per-row arrays, because ``map_rows`` must handle them. Dense block
materialization of a ragged column raises.

Every lazy op also records a logical-plan node on its result
(``plan/nodes.py``), and ``blocks()`` first offers the chain to the plan
(``plan.maybe_run``): fused stages, pruned parquet reads, device-resident
intermediates. ``TFT_FUSE=0`` leaves the per-op thunk chain, which is also
the fallback for any chain the plan cannot prove. Size hints (exact at the
source constructors, scaled through the ops) answer ``estimated_rows`` /
``estimated_bytes`` for unforced frames.

Beyond the six ops, a frame joins another (:meth:`TensorFrame.join`, the
``relational`` package), sorts globally (:meth:`TensorFrame.order_by`, host
``np.lexsort``), samples, shows, and pads a ragged column to a dense one
(:meth:`TensorFrame.pad_column`).

Under an active device budget a forced frame's block cache joins the
memory manager's host-side gauge (``memory.note_frame_cache``), and
:meth:`TensorFrame.uncache` leaves it.

Not in this package yet: the plan-fingerprint result cache that the JAX
package also hooks into ``blocks()`` (with ``plan/adaptive.py``),
``submit`` (the serve layer), and the hot-key observations of a salted
``daggregate`` (``hot_keys`` returns none).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from . import dtypes as _dt
from .marshal import (Column, _concrete_cell, columns_to_rows,
                      rows_to_columns)
from .schema import Field, Schema
from .shape import Shape, Unknown

__all__ = ["Row", "Block", "TensorFrame", "GroupedFrame", "frame"]


class Row(tuple):
    """A result row: a tuple with named-field access (Spark Row analogue)."""

    _fields: Tuple[str, ...]

    def __new__(cls, values: Iterable, fields: Sequence[str]):
        self = super().__new__(cls, values)
        self._fields = tuple(fields)
        return self

    def __getitem__(self, key):
        if isinstance(key, str):
            try:
                key = self._fields.index(key)
            except ValueError:
                raise KeyError(f"No field {key!r}; fields: {self._fields}")
        return super().__getitem__(key)

    def as_dict(self) -> Dict[str, object]:
        return dict(zip(self._fields, self))

    @property
    def fields(self) -> Tuple[str, ...]:
        return self._fields

    def __repr__(self):
        inner = ", ".join(f"{n}={v!r}" for n, v in zip(self._fields, self))
        return f"Row({inner})"


class Block:
    """One partition's worth of rows, stored columnar."""

    __slots__ = ("columns", "num_rows")

    def __init__(self, columns: Dict[str, Column], num_rows: Optional[int] = None):
        self.columns = columns
        if num_rows is None:
            if not columns:
                raise ValueError("Empty block needs an explicit num_rows")
            num_rows = len(next(iter(columns.values())))
        self.num_rows = int(num_rows)
        for name, col in columns.items():
            if len(col) != self.num_rows:
                raise ValueError(
                    f"Column {name!r} has {len(col)} rows; expected "
                    f"{self.num_rows}")

    def is_ragged(self, name: str) -> bool:
        return not isinstance(self.columns[name], np.ndarray)

    def dense(self, name: str) -> np.ndarray:
        col = self.columns[name]
        if not isinstance(col, np.ndarray):
            raise ValueError(
                f"Column {name!r} contains cells of varying shape in this "
                f"block; block operations require uniform cells — use "
                f"map_rows instead (reference core.py:193-194)")
        return col

    def select(self, names: Sequence[str]) -> "Block":
        return Block({n: self.columns[n] for n in names}, self.num_rows)

    def row(self, i: int, names: Sequence[str]) -> Tuple:
        return tuple(self.columns[n][i] for n in names)

    @staticmethod
    def from_rows(rows: Sequence[Sequence], schema: Schema) -> "Block":
        cols = rows_to_columns(rows, schema)
        return Block(cols, len(rows))

    @staticmethod
    def concat(blocks: Sequence["Block"], schema: Schema) -> "Block":
        # 0-row columns carry no shape evidence (their zero-filled cell dims
        # need not match the real blocks'); they are ignored when unifying.
        nonempty = [b for b in blocks if b.num_rows > 0]
        if len(nonempty) == 1:
            # single-partition frames concat for free: callers treat
            # blocks as immutable, so the columns can be shared, not
            # copied (np.concatenate of one array still copies)
            b = nonempty[0]
            return Block({f.name: b.columns[f.name] for f in schema},
                         b.num_rows)
        if not nonempty:
            if blocks:
                return Block({f.name: blocks[0].columns[f.name]
                              for f in schema}, 0)
            return Block({f.name: np.empty((0,), f.dtype.np_storage)
                          for f in schema}, 0)
        out: Dict[str, Column] = {}
        for f in schema:
            cols = [b.columns[f.name] for b in nonempty]
            if all(isinstance(c, np.ndarray) for c in cols) and \
                    len({c.shape[1:] for c in cols}) == 1:
                out[f.name] = np.concatenate(cols)
            else:
                ragged: List[np.ndarray] = []
                for c in cols:
                    ragged.extend(list(c))
                out[f.name] = ragged
        return Block(out, sum(b.num_rows for b in nonempty))


def _infer_schema_from_rows(rows: Sequence[Sequence],
                            names: Sequence[str]) -> Schema:
    """Infer field dtypes/ranks from the first row (Spark-style: python
    float -> double, int -> long)."""
    if not rows:
        raise ValueError("Cannot infer a schema from zero rows; pass schema=")
    first = rows[0]
    if len(first) != len(names):
        raise ValueError(
            f"Row width {len(first)} != number of column names {len(names)}")
    fields = []
    for name, cell in zip(names, first):
        rank = 0
        probe = cell
        while isinstance(probe, (list, tuple, np.ndarray)):
            rank += 1
            if len(probe) == 0:
                probe = 0.0
                break
            probe = probe[0]
        dt = _dt.string if isinstance(probe, (str, np.str_, bytes)) \
            else _dt.from_python_value(probe)
        f = Field(name, dt, sql_rank=rank)
        if rank == 0 and dt.tensor:
            f = f.with_block_shape(Shape(Unknown))
        fields.append(f)
    return Schema(fields)


def _blocks_hints(blocks: Sequence[Block]) -> Dict[str, object]:
    """Exact size hints for a source frame whose blocks already exist,
    with the per-column split the plan cost model seeds from."""
    from .memory.estimate import blocks_estimate, column_nbytes
    rows, nbytes = blocks_estimate(blocks)
    col_bytes: Dict[str, int] = {}
    for b in blocks:
        for name, col in b.columns.items():
            col_bytes[name] = col_bytes.get(name, 0) + column_nbytes(col)
    return {"rows_hint": rows, "bytes_hint": nbytes,
            "col_bytes_hint": col_bytes}


def _split_even(n: int, parts: int) -> List[Tuple[int, int]]:
    """Split n rows into at most ``parts`` non-empty spans (Spark-style:
    never more partitions than rows)."""
    return _split_exact(n, max(1, min(parts, max(n, 1))))


def _split_exact(n: int, parts: int) -> List[Tuple[int, int]]:
    """Split n rows into exactly ``parts`` spans (possibly empty)."""
    base, extra = divmod(n, parts)
    spans, start = [], 0
    for i in range(parts):
        size = base + (1 if i < extra else 0)
        spans.append((start, start + size))
        start += size
    return spans


class TensorFrame:
    """A lazily-evaluated, partitioned columnar DataFrame."""

    def __init__(self, schema: Schema,
                 thunk: Callable[[], List[Block]],
                 num_partitions: int,
                 plan: str = "source",
                 rows_hint: Optional[int] = None,
                 bytes_hint: Optional[int] = None,
                 col_bytes_hint: Optional[Dict[str, int]] = None):
        self._schema = schema
        self._thunk = thunk
        self._cache: Optional[List[Block]] = None
        self._num_partitions = num_partitions
        self._plan = plan
        # size hints: exact at source constructors, scaled through ops;
        # None means unknown
        self._rows_hint = rows_hint
        self._bytes_hint = bytes_hint
        self._col_bytes_hint = col_bytes_hint
        # logical plan: the node a lazy op recorded (plan/nodes.py), and
        # the optimized plan's rendering after a fused forcing
        self._plan_node = None
        self._plan_info: Optional[List[str]] = None
        # host spans of the last forcing made with tracing on (explain)
        self._spans: Optional[Dict[str, Dict[str, float]]] = None
        # the query trace of this frame's forcing (tracing on, and not
        # nested inside another query)
        self._trace = None

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_rows(rows: Sequence[Sequence], columns: Sequence[str] = None,
                  schema: Optional[Schema] = None,
                  num_partitions: int = 1) -> "TensorFrame":
        rows = [tuple(r) if not isinstance(r, tuple) else r for r in rows]
        if schema is None:
            if columns is None:
                raise ValueError("Pass columns=[...] names or schema=")
            schema = _infer_schema_from_rows(rows, columns)
        spans = _split_even(len(rows), num_partitions)
        blocks = [Block.from_rows(rows[a:b], schema) for a, b in spans]
        return TensorFrame(schema, lambda: blocks, len(blocks),
                           **_blocks_hints(blocks))

    @staticmethod
    def from_columns(cols: Dict[str, np.ndarray],
                     schema: Optional[Schema] = None,
                     num_partitions: int = 1) -> "TensorFrame":
        cols = {n: np.asarray(c) for n, c in cols.items()}
        if schema is None:
            schema = Schema.from_numpy_columns(cols)
        ns = {len(c) for c in cols.values()}
        if len(ns) > 1:
            raise ValueError(f"Columns disagree on row count: {ns}")
        n = ns.pop() if ns else 0
        spans = _split_even(n, num_partitions)
        blocks = [Block({k: v[a:b] for k, v in cols.items()}, b - a)
                  for a, b in spans]
        return TensorFrame(schema, lambda: blocks, len(blocks),
                           **_blocks_hints(blocks))

    @staticmethod
    def from_blocks(blocks: List[Block], schema: Schema) -> "TensorFrame":
        return TensorFrame(schema, lambda: blocks, len(blocks),
                           **_blocks_hints(blocks))

    # -- basic properties --------------------------------------------------
    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def columns(self) -> List[str]:
        return self._schema.names

    @property
    def num_partitions(self) -> int:
        return self._num_partitions

    def __repr__(self):
        return (f"TensorFrame[{', '.join(self._schema.names)}] "
                f"({self._num_partitions} partition(s), plan={self._plan})")

    # -- evaluation --------------------------------------------------------
    def blocks(self) -> List[Block]:
        if self._cache is None:
            from .observability import events as _obs
            from .utils import tracing
            before = tracing.timings.snapshot() if tracing.enabled() \
                else None
            # forcing IS the query: open a correlated trace (None with
            # tracing off; a forcing nested inside another query joins
            # the ambient trace and yields None here)
            with _obs.query_trace(self._plan.split("(", 1)[0],
                                  plan=self._plan) as t:
                blocks = None
                if self._plan_node is not None:
                    # the logical plan first: fused stages, pruned reads,
                    # device-resident intermediates; None (fusion off or
                    # an unplannable chain) defers to the per-op thunk
                    from .plan import maybe_run
                    blocks = maybe_run(self)
                self._cache = blocks if blocks is not None \
                    else self._thunk()
            if t is not None:
                self._trace = t
            if before is not None:
                self._spans = _span_delta(before,
                                          tracing.timings.snapshot())
            # under an active device budget the forced block cache joins
            # the host-side gauge; one global read otherwise
            from . import memory as _memory
            _memory.note_frame_cache(self)
        return self._cache

    def uncache(self) -> "TensorFrame":
        """Drop the forced block cache (the next ``blocks()`` re-runs the
        thunk chain) and release it from the memory manager's host-side
        gauge. The inverse of :meth:`cache`."""
        self._cache = None
        from . import memory as _memory
        _memory.forget_frame_cache(self)
        return self

    def estimated_rows(self) -> Optional[int]:
        """Best-effort row count: exact when forced, the plan's estimate
        or the hint otherwise, ``None`` when unknown."""
        from .memory.estimate import frame_estimate
        rows, _ = frame_estimate(self)
        return int(rows) if rows is not None else None

    def estimated_bytes(self) -> Optional[int]:
        """Best-effort host byte size: exact when forced, the plan's
        per-column estimate (an upper bound through filters) or the hint
        otherwise, ``None`` when unknown."""
        from .memory.estimate import frame_estimate
        _, nbytes = frame_estimate(self)
        return nbytes

    def collect(self) -> List[Row]:
        names = self._schema.names
        out: List[Row] = []
        for b in self.blocks():
            for tup in columns_to_rows(b.columns, self._schema):
                out.append(Row(tup, names))
        return out

    def count(self) -> int:
        return sum(b.num_rows for b in self.blocks())

    def first(self) -> Row:
        for b in self.blocks():
            if b.num_rows:
                tup = columns_to_rows(
                    Block({k: v[:1] for k, v in b.columns.items()}, 1).columns,
                    self._schema)[0]
                return Row(tup, self._schema.names)
        raise ValueError("Frame is empty")

    def cache(self) -> "TensorFrame":
        self.blocks()
        return self

    # -- transformations ---------------------------------------------------
    def select(self, names: Sequence[str]) -> "TensorFrame":
        names = list(names)
        schema = self._schema.select(names)
        from .memory.estimate import propagate_hints
        rows_h, bytes_h = propagate_hints(self, schema)
        out = TensorFrame(
            schema, lambda: [b.select(names) for b in self.blocks()],
            self._num_partitions, plan=f"select({self._plan})",
            rows_hint=rows_h, bytes_hint=bytes_h)
        from .plan.nodes import SelectNode, attach, node_for
        attach(out, SelectNode(node_for(self), schema, names))
        return out

    def with_schema(self, schema: Schema) -> "TensorFrame":
        """Same data, refined metadata (used by ``analyze``)."""
        return TensorFrame(schema, self.blocks, self._num_partitions,
                           plan=self._plan)

    def repartition(self, n: int) -> "TensorFrame":
        """Redistribute rows into exactly ``n`` partitions (some possibly
        empty when there are fewer rows than partitions)."""
        n = max(1, int(n))

        def thunk():
            merged = Block.concat(self.blocks(), self._schema)
            out = []
            for a, b in _split_exact(merged.num_rows, n):
                cols: Dict[str, Column] = {}
                for name, col in merged.columns.items():
                    cols[name] = col[a:b] if isinstance(col, np.ndarray) \
                        else list(col[a:b])
                out.append(Block(cols, b - a))
            return out

        from .memory.estimate import propagate_hints
        rows_h, bytes_h = propagate_hints(self, self._schema)
        return TensorFrame(self._schema, thunk, n,
                           plan=f"repartition({self._plan})",
                           rows_hint=rows_h, bytes_hint=bytes_h)

    def pad_column(self, name: str, max_len: Optional[int] = None,
                   pow2: bool = False, mask_col: Optional[str] = None,
                   len_col: Optional[str] = None) -> "TensorFrame":
        """Pad a ragged 1-d column to a dense ``[rows, L]`` column plus an
        int32 validity-mask column and an int64 length column, which makes
        it usable by the block-level ops. Eager on the column lengths;
        the padded blocks build lazily.

        ``pow2`` rounds L up to a power of two.
        """
        field = self._schema.get(name)
        if field is None:
            raise KeyError(f"No column {name!r}")
        mask_col = mask_col or f"{name}_mask"
        len_col = len_col or f"{name}_len"
        for c in (mask_col, len_col):
            if c in self._schema:
                raise ValueError(f"Column {c!r} already exists")
        blocks = self.blocks()

        def cell_list(b: Block) -> List[np.ndarray]:
            col = b.columns[name]
            return [np.asarray(col[i]) for i in range(b.num_rows)]

        longest = 0
        for b in blocks:
            for c in cell_list(b):
                if c.ndim != 1:
                    raise ValueError(
                        f"pad_column supports 1-d cells; {name!r} has a "
                        f"rank-{c.ndim} cell")
                longest = max(longest, c.size)
        L = max_len if max_len is not None else longest
        if pow2:
            p = 1
            while p < L:
                p *= 2
            L = p
        storage = field.dtype.np_storage

        def pad_block(b: Block) -> Block:
            cols = dict(b.columns)
            cells = cell_list(b)
            dense = np.zeros((b.num_rows, L), storage)
            mask = np.zeros((b.num_rows, L), np.int32)
            for i, c in enumerate(cells):
                if c.size > L:
                    raise ValueError(
                        f"pad_column: a cell of {name!r} holds {c.size} "
                        f"values, more than max_len={L}")
                dense[i, :c.size] = c
                mask[i, :c.size] = 1
            cols[name] = dense
            cols[mask_col] = mask
            cols[len_col] = np.array([c.size for c in cells], np.int64)
            return Block(cols, b.num_rows)

        fields = []
        for f in self._schema:
            if f.name == name:
                fields.append(Field(name, f.dtype,
                                    block_shape=Shape(Unknown, L),
                                    sql_rank=1))
            else:
                fields.append(f)
        fields.append(Field(mask_col, _dt.int32,
                            block_shape=Shape(Unknown, L), sql_rank=1))
        fields.append(Field(len_col, _dt.int64,
                            block_shape=Shape(Unknown), sql_rank=0))
        return TensorFrame(Schema(fields),
                           lambda: [pad_block(b) for b in blocks],
                           self._num_partitions,
                           plan=f"pad_column({self._plan})")

    def join(self, other: "TensorFrame", on, how: str = "inner",
             strategy: Optional[str] = None, mesh=None,
             indicator: Optional[str] = None) -> "TensorFrame":
        """Join this frame against ``other`` (lazy). A broadcast hash join
        (the default, and the only strategy without a mesh), or the host
        sort-merge join (``strategy="sort_merge"``). See
        :func:`~.relational.join.join`."""
        from .relational.join import join as _join
        return _join(self, other, on, how=how, strategy=strategy,
                     mesh=mesh, indicator=indicator)

    def hot_keys(self) -> List[Dict]:
        """The hot-key observations of a salted ``daggregate``: one dict
        per hot group, ``{"keys": {col: value}, "fraction": ...,
        "salt_slots": K}``. This package has no salted ``daggregate`` yet,
        so no frame carries any and the list is empty."""
        return []

    def limit(self, n: int) -> "TensorFrame":
        """The first ``n`` rows (in block order). Lazy."""
        if n < 0:
            raise ValueError(f"limit({n}): n must be >= 0")

        def run() -> List[Block]:
            out: List[Block] = []
            left = n
            for b in self.blocks():
                if left <= 0:
                    break
                take = min(left, b.num_rows)
                if take == b.num_rows:
                    out.append(b)
                else:
                    out.append(Block(
                        {k: v[:take] for k, v in b.columns.items()}, take))
                left -= take
            return out or [Block(
                {f.name: np.empty((0,) + _concrete_cell(f),
                                  f.dtype.np_storage)
                 for f in self._schema}, 0)]

        from .memory.estimate import frame_estimate
        est_rows, est_bytes = frame_estimate(self)
        if est_rows:
            take = min(n, int(est_rows))
            lim_bytes = (int(est_bytes * take / est_rows)
                         if est_bytes is not None else None)
        else:
            take, lim_bytes = None, None
        return TensorFrame(self._schema, run, self._num_partitions,
                           plan=f"limit({n})({self._plan})",
                           rows_hint=take, bytes_hint=lim_bytes)

    def sample(self, fraction: float, seed: int = 0) -> "TensorFrame":
        """A Bernoulli row sample (each row kept independently with
        probability ``fraction``). Lazy; deterministic for a given seed:
        block ``i`` draws from ``np.random.default_rng((seed, i))``, as in
        the JAX package, so both keep the same rows."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"sample fraction {fraction} not in [0, 1]")

        def run() -> List[Block]:
            out: List[Block] = []
            for i, b in enumerate(self.blocks()):
                rng = np.random.default_rng((seed, i))
                mask = rng.random(b.num_rows) < fraction
                keep = int(mask.sum())
                out.append(Block(
                    {k: (v[mask] if isinstance(v, np.ndarray)
                         else [v[j] for j in np.flatnonzero(mask)])
                     for k, v in b.columns.items()}, keep))
            return out

        from .memory.estimate import frame_estimate
        est_rows, est_bytes = frame_estimate(self)
        return TensorFrame(
            self._schema, run, self._num_partitions,
            plan=f"sample({fraction})({self._plan})",
            rows_hint=(int(est_rows * fraction)
                       if est_rows is not None else None),
            bytes_hint=(int(est_bytes * fraction)
                        if est_bytes is not None else None))

    def show(self, n: int = 20) -> None:
        """Print the first ``n`` rows as a small aligned table (the Spark
        ``df.show()`` convenience)."""
        rows = self.limit(n).collect()
        names = self._schema.names

        def fmt(v):
            if isinstance(v, float):
                return f"{v:.6g}"
            if isinstance(v, np.ndarray):
                flat = np.asarray(v).reshape(-1)
                s = ", ".join(f"{x:.4g}" if isinstance(x, float)
                              else str(x) for x in flat[:4])
                return f"[{s}{', ...' if flat.size > 4 else ''}]"
            return str(v)

        table = [[fmt(r[i]) for i in range(len(names))] for r in rows]
        widths = [max(len(nm), *(len(t[i]) for t in table))
                  if table else len(nm) for i, nm in enumerate(names)]
        line = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        print(line)
        print("|" + "|".join(f" {nm:<{w}} "
                             for nm, w in zip(names, widths)) + "|")
        print(line)
        for t in table:
            print("|" + "|".join(f" {c:<{w}} "
                                 for c, w in zip(t, widths)) + "|")
        print(line)

    def order_by(self, *cols: str, descending: bool = False,
                 num_partitions: Optional[int] = None) -> "TensorFrame":
        """Rows globally sorted by scalar key column(s), on the host. Lazy.

        Multi-key: the first name is the primary key. Stable within equal
        keys. The result is re-partitioned evenly (``num_partitions``
        defaults to the input's count): a global sort cannot keep the
        partition boundaries.
        """
        if not cols:
            raise ValueError("order_by needs at least one key column")
        for c in cols:
            f = self._schema.get(c)
            if f is None:
                raise KeyError(
                    f"No column {c!r}; columns: {self._schema.names}")
            if f.sql_rank != 0:
                raise ValueError(
                    f"order_by key {c!r} must be a scalar column")
        parts = num_partitions or self._num_partitions

        def run() -> List[Block]:
            # only the KEY columns are concatenated; value columns gather
            # from their blocks one output block at a time
            blocks = self.blocks()
            sizes = [b.num_rows for b in blocks]
            offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(
                np.int64)
            n = int(offsets[-1])
            # np.lexsort: the LAST key is primary; stable. Descending
            # negates the key instead of reversing the result, which would
            # un-stabilize ties. Float keys negate the values, so NaN stays
            # LAST (np.lexsort sinks NaN); other keys (strings, ints) negate
            # their dense rank, which cannot overflow and works for objects.
            keys = []
            for c in reversed(cols):
                parts_c = [np.asarray(b.columns[c]) for b in blocks
                           if b.num_rows]
                k = (np.concatenate(parts_c) if parts_c
                     else np.empty(0))
                if descending:
                    if k.dtype.kind == "f":
                        k = -k
                    else:
                        k = -np.unique(k, return_inverse=True)[1]
                keys.append(k)
            order = np.lexsort(keys) if n else np.empty(0, np.int64)
            del keys
            if n < 2 ** 31:
                order = order.astype(np.int32)
            spans = _split_even(n, parts)
            out_blocks = []
            col_srcs = {name: [b.columns[name] for b in blocks]
                        for name in self._schema.names}
            col_dense = {name: all(isinstance(s, np.ndarray)
                                   for s in srcs)
                         for name, srcs in col_srcs.items()}
            for a, e in spans:
                osel = order[a:e]
                bsel = np.searchsorted(offsets[1:], osel,
                                       side="right").astype(np.int32)
                lsel = osel - offsets[bsel]
                masks = [(bi, bsel == bi) for bi in np.unique(bsel)]
                cols_out: Dict[str, Column] = {}
                for name in self._schema.names:
                    srcs = col_srcs[name]
                    if col_dense[name] and srcs:
                        first = srcs[bsel[0]] if e > a else srcs[0]
                        out_a = np.empty((e - a,) + first.shape[1:],
                                         first.dtype)
                        for bi, m in masks:
                            out_a[m] = srcs[bi][lsel[m]]
                        cols_out[name] = out_a
                    else:  # ragged list columns reorder by index
                        cols_out[name] = [srcs[bi][i]
                                          for bi, i in zip(bsel, lsel)]
                out_blocks.append(Block(cols_out, e - a))
            return out_blocks

        from .memory.estimate import propagate_hints
        rows_h, bytes_h = propagate_hints(self, self._schema)
        return TensorFrame(self._schema, run, parts,
                           plan=f"order_by{cols}({self._plan})",
                           rows_hint=rows_h, bytes_hint=bytes_h)

    def group_by(self, *cols: str) -> "GroupedFrame":
        for c in cols:
            if c not in self._schema:
                raise KeyError(f"No column {c!r}")
        return GroupedFrame(self, list(cols))

    # -- fluent op sugar ---------------------------------------------------
    def map_blocks(self, fetches, trim: bool = False,
                   executor=None) -> "TensorFrame":
        from . import api
        return api.map_blocks(fetches, self, trim=trim, executor=executor)

    def map_rows(self, fetches, executor=None) -> "TensorFrame":
        from . import api
        return api.map_rows(fetches, self, executor=executor)

    def reduce_blocks(self, fetches, executor=None):
        from . import api
        return api.reduce_blocks(fetches, self, executor=executor)

    def reduce_rows(self, fetches, executor=None):
        from . import api
        return api.reduce_rows(fetches, self, executor=executor)

    def filter(self, predicate, executor=None) -> "TensorFrame":
        from . import api
        return api.filter_rows(predicate, self, executor=executor)

    def analyze(self) -> "TensorFrame":
        from . import api
        return api.analyze(self)

    # -- introspection -----------------------------------------------------
    def explain(self) -> str:
        """Execution report of this frame's forcing: rows, blocks, the
        host spans by stage and, when the logical plan ran, its fused
        stages, pruned columns, pushdown and resident edges.

        A frame not yet forced with tracing on is (re-)forced once with
        tracing enabled, so a post-hoc ``explain()`` re-runs the plan.
        Distinct from the function ``explain(df)``, which describes the
        schema."""
        if self._spans is None:
            from .utils import tracing
            was = tracing.enabled()
            tracing.enable()
            try:
                self._cache = None
                self.blocks()
            finally:
                if not was:
                    tracing.disable()
        blocks = self.blocks()
        lines = [f"query    : {self._plan}",
                 f"  rows     : {sum(b.num_rows for b in blocks)} in "
                 f"{len(blocks)} block(s)"]
        if self._spans:
            lines.append("  wall time by stage:")
            width = max(len(k) for k in self._spans)
            for name in sorted(self._spans,
                               key=lambda k: -self._spans[k]["total_s"]):
                st = self._spans[name]
                lines.append(f"    {name:<{width}} {int(st['count']):6d}x "
                             f"{st['total_s']:12.6f}s")
        if self._plan_info:
            lines.extend(self._plan_info)
        return "\n".join(lines)

    def explain_tensors(self) -> str:
        return self._schema.tree_string()


def _span_delta(before: Dict[str, Dict[str, float]],
                after: Dict[str, Dict[str, float]]
                ) -> Dict[str, Dict[str, float]]:
    """The spans recorded between two ``timings`` snapshots."""
    out = {}
    for name, st in after.items():
        b = before.get(name, {"count": 0, "total_s": 0.0})
        if st["count"] > b["count"]:
            out[name] = {"count": st["count"] - b["count"],
                         "total_s": st["total_s"] - b["total_s"]}
    return out


class GroupedFrame:
    """The result of ``TensorFrame.group_by`` (RelationalGroupedDataset
    analogue) — consumed by ``aggregate``."""

    def __init__(self, frame: TensorFrame, keys: List[str]):
        self.frame = frame
        self.keys = keys

    def __repr__(self):
        return f"GroupedFrame(keys={self.keys}, frame={self.frame!r})"


def frame(data, columns: Sequence[str] = None,
          schema: Optional[Schema] = None,
          num_partitions: int = 1) -> TensorFrame:
    """Convenience constructor: rows (list of tuples) or dict of columns."""
    if isinstance(data, dict):
        return TensorFrame.from_columns(data, schema=schema,
                                        num_partitions=num_partitions)
    return TensorFrame.from_rows(data, columns=columns, schema=schema,
                                 num_partitions=num_partitions)
