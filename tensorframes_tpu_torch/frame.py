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

Not in this package yet: the plan-fingerprint result cache, the memory
manager and the query traces that the JAX package also hooks into
``blocks()``.
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
            from .utils import tracing
            before = tracing.timings.snapshot() if tracing.enabled() \
                else None
            blocks = None
            if self._plan_node is not None:
                # the logical plan first: fused stages, pruned reads,
                # device-resident intermediates; None (fusion off or an
                # unplannable chain) defers to the per-op thunk
                from .plan import maybe_run
                blocks = maybe_run(self)
            self._cache = blocks if blocks is not None else self._thunk()
            if before is not None:
                self._spans = _span_delta(before,
                                          tracing.timings.snapshot())
        return self._cache

    def uncache(self) -> "TensorFrame":
        """Drop the forced block cache; the next ``blocks()`` re-runs the
        thunk chain. The inverse of :meth:`cache`."""
        self._cache = None
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

        return TensorFrame(self._schema, run, self._num_partitions,
                           plan=f"limit({n})({self._plan})")

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
