"""StreamingFrame: the relational surface over a block source.

The port's counterpart of ``tensorframes_tpu/stream/frame.py``. A
:class:`StreamingFrame` is a :class:`~.source.BlockSource` plus a chain of
per-batch transformations. The row-local relational ops (``map_blocks``,
``map_rows``, ``filter_rows``, ``select``) are the SAME ops the finite
engine runs (``engine.ops``), applied batch by batch, with two
guarantees:

- **definition-time resolution**: fetches resolve to one canonical
  :class:`~..computation.Computation` ONCE, when the op is chained
  (``engine.ops.cached_map_computation``, the cache the batch path uses),
  so every batch runs the same Computation; schema validation happens
  here too: a bad fetch fails when the stream is DEFINED, not on batch 1;
- **finite equivalence**: each batch runs through the unchanged engine
  ops (and through the logical plan when its chain plans), so streaming
  a finite source through any chain of these ops gives bit-identical
  results, ordering included, to the batch ``TensorFrame`` path.

``join`` enriches each batch against a static table: a
:class:`~..relational.join.BuildTable` is built once, at definition, and
every batch probes it through ``broadcast_join(build=)``.
``group_by(...)`` hands off to the incremental keyed aggregation
(:mod:`.aggregate`); ``start()`` builds the pump
(:class:`~.runtime.StreamHandle`).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from ..engine import ops as _ops
from ..frame import TensorFrame
from ..schema import Schema

__all__ = ["StreamingFrame", "GroupedStream"]


class StreamingFrame:
    """A lazily-described stream of blocks with per-batch relational ops.

    Construct from a source (``stream.from_source(src)`` or directly);
    chain ops like a ``TensorFrame``; then ``start()`` to pump batches.
    Transformations share the upstream source object — one stream
    definition is driven by one handle at a time.
    """

    def __init__(self, source, schema: Optional[Schema] = None,
                 transforms: Tuple[Callable[[TensorFrame], TensorFrame],
                                   ...] = (),
                 plan: Optional[str] = None):
        self.source = source
        self._schema = schema if schema is not None else source.schema
        self._transforms = tuple(transforms)
        self._plan = plan or f"stream({type(source).__name__})"

    # -- properties --------------------------------------------------------
    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def columns(self) -> List[str]:
        return self._schema.names

    def __repr__(self):
        return (f"StreamingFrame[{', '.join(self._schema.names)}] "
                f"(plan={self._plan})")

    # -- batch application (used by the runtime pump) ----------------------
    def _apply(self, df: TensorFrame) -> TensorFrame:
        for t in self._transforms:
            df = t(df)
        return df

    def _chain(self, fn: Callable[[TensorFrame], TensorFrame],
               out_schema: Schema, label: str) -> "StreamingFrame":
        return StreamingFrame(self.source, out_schema,
                              self._transforms + (fn,),
                              plan=f"{label}({self._plan})")

    # -- relational ops (per-batch; engine.ops semantics) ------------------
    def select(self, names: Sequence[str]) -> "StreamingFrame":
        # materialize FIRST: a one-shot iterable consumed by the schema
        # check would leave every batch selecting zero columns
        names = list(names)
        out_schema = self._schema.select(names)
        return self._chain(lambda df: df.select(names), out_schema,
                           f"select{tuple(names)}")

    def map_blocks(self, fetches, trim: bool = False,
                   executor=None) -> "StreamingFrame":
        """Per-batch ``map_blocks`` (lazy-op semantics, forced by the
        pump). The fetches resolve to ONE canonical Computation here,
        which every batch reuses."""
        comp = _ops.cached_map_computation(fetches, self._schema,
                                           block_level=True)
        out_schema = _ops._validate_map(comp, self._schema,
                                        block_level=True, trim=trim)
        return self._chain(
            lambda df: _ops.map_blocks(comp, df, trim=trim,
                                       executor=executor),
            out_schema, "map_blocks")

    def map_rows(self, fetches, executor=None) -> "StreamingFrame":
        comp = _ops.cached_map_computation(fetches, self._schema,
                                           block_level=False)
        out_schema = _ops._validate_map(comp, self._schema,
                                        block_level=False, trim=False)
        return self._chain(
            lambda df: _ops.map_rows(comp, df, executor=executor),
            out_schema, "map_rows")

    def filter_rows(self, predicate, executor=None) -> "StreamingFrame":
        comp = _ops._filter_computation(predicate, self._schema)
        return self._chain(
            lambda df: _ops.filter_rows(comp, df, executor=executor),
            self._schema, "filter_rows")

    # TensorFrame spells it `filter`; keep the alias for symmetry
    filter = filter_rows

    def join(self, table, on, how: str = "left",
             indicator: Optional[str] = None) -> "StreamingFrame":
        """Enrich each batch against a STATIC table (the stream-table
        join): the right side factorizes into a broadcast
        :class:`~..relational.join.BuildTable` ONCE, here at definition
        time — schema validation included — and every batch probes it
        through the same per-block path the batch ``broadcast_join``
        uses (one fused device gather per block, resilient executor,
        ledger-admitted build residency). Default ``how="left"``: an
        enrichment must not drop stream rows silently; pass
        ``how="inner"`` to keep only matches."""
        from ..relational.join import (BuildTable, broadcast_join,
                                       join_schema)
        build = BuildTable(table, on)
        out_schema = join_schema(self._schema, build.schema, build.on,
                                 how, indicator)
        return self._chain(
            lambda df: broadcast_join(df, build=build, how=how,
                                      indicator=indicator),
            out_schema, f"join[{how}]")

    # -- aggregation handoff -----------------------------------------------
    def group_by(self, *keys: str) -> "GroupedStream":
        for k in keys:
            f = self._schema.get(k)
            if f is None:
                raise KeyError(
                    f"No column {k!r}; columns: {self._schema.names}")
            if f.sql_rank != 0:
                raise ValueError(
                    f"group_by key {k!r} must be a scalar column")
        if not keys:
            raise ValueError("group_by needs at least one key column")
        return GroupedStream(self, list(keys))

    # -- execution ---------------------------------------------------------
    def start(self, sink=None, on_update=None, name: Optional[str] = None,
              max_buffered: Optional[int] = None, batch_rows=None):
        """Build a :class:`~.runtime.StreamHandle` pumping this stream's
        batches: each batch's resulting frame is buffered for
        ``collect_updates()`` and delivered to ``sink`` / ``on_update``.
        ``batch_rows`` sizes batches: an int coalesces already-available
        source blocks up to that many rows, ``None`` keeps one source
        block per batch (``"adaptive"`` is not in this package yet).
        Coalescing changes batch BOUNDARIES: use it for row-local
        chains; a per-batch cross-row ``map_blocks`` (``x - x.mean()``)
        sees the merged batch."""
        from .runtime import StreamHandle
        return StreamHandle(self, sink=sink, on_update=on_update,
                            name=name, max_buffered=max_buffered,
                            batch_rows=batch_rows)


class GroupedStream:
    """``StreamingFrame.group_by(...)`` result — consumed by
    :meth:`aggregate` (the incremental keyed-aggregation layer)."""

    def __init__(self, frame: StreamingFrame, keys: List[str]):
        self.frame = frame
        self.keys = keys

    def aggregate(self, fetches, window=None, time_col: Optional[str] = None,
                  watermark_delay: float = 0.0,
                  max_state_rows: Optional[int] = None, mesh=None):
        """Incremental keyed aggregation over the stream: ``fetches`` is
        a ``{column: combiner-name}`` mapping (sum/min/max/prod — the
        monoid set ``aggregate`` and ``daggregate`` serve), combined
        per batch in one segment-reduce dispatch per column against
        bounded device-resident state. ``window``
        (:func:`~.aggregate.tumbling` / :func:`~.aggregate.sliding`)
        plus ``time_col`` enable windowing; ``watermark_delay`` is the
        allowed event-time lateness before a window emits and evicts.
        ``mesh=`` with more than one data shard folds each batch on the
        mesh (one dispatch a batch, ``plan.dist.mesh_segment_partial``).
        Returns a :class:`~.aggregate.StreamingAggregation`; call
        ``.start()`` on it."""
        from .aggregate import StreamingAggregation
        return StreamingAggregation(
            self.frame, self.keys, fetches, window=window,
            time_col=time_col, watermark_delay=watermark_delay,
            max_state_rows=max_state_rows, mesh=mesh)

    def __repr__(self):
        return f"GroupedStream(keys={self.keys}, frame={self.frame!r})"
