"""Block sources: where a stream's batches come from.

The port's counterpart of ``tensorframes_tpu/stream/source.py``. A
:class:`BlockSource` is the streaming analogue of a ``TensorFrame``
constructor: instead of a finite list of blocks made up front, it yields
schema-checked :class:`~..frame.Block` objects of host numpy columns
over time. Three concrete sources:

- :class:`GeneratorSource`: any Python iterable of blocks or column dicts
  (synthetic feeds, adapters for message buses);
- :class:`QueueSource`: a bounded in-memory queue another thread
  puts blocks into; the bound IS the ingestion backpressure (a full queue
  blocks or rejects the producer, it never buffers without bound);
- :class:`ParquetTailSource`: follows a parquet file as row groups are
  appended, re-reading NOTHING: consumed row groups are skipped through
  ``io._read_parquet_eager(row_group_offset=...)``, so each poll costs
  one footer read plus the new groups.

Every source checks each block against its schema (:func:`check_block`):
a producer that drifts (a missing column, a wrong dtype) fails at the
source boundary with a named error, not deep inside a dispatch.

The pull contract (driven by :class:`~.runtime.StreamHandle`):
``poll(timeout)`` returns the next block or ``None`` when nothing is
available yet; ``done()`` reports permanent exhaustion (finite sources,
closed queues), which lets a finite stream end and flush its windows.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np

from ..frame import Block
from ..schema import Schema
from ..utils.logging import get_logger

__all__ = ["SchemaMismatch", "BlockSource", "GeneratorSource",
           "QueueSource", "ParquetTailSource", "check_block"]

_log = get_logger("stream.source")


class SchemaMismatch(ValueError):
    """A source produced a block that does not match its declared schema
    (missing/extra column or wrong storage dtype). Raised at the source
    boundary — classified permanent, so a drifting producer poisons its
    batch (skipped-and-counted), never wedges the retry loop."""


def _as_block(data: Union[Block, Dict[str, np.ndarray]]) -> Block:
    """Accept a Block or a dict of columns (arrays coerced)."""
    if isinstance(data, Block):
        return data
    if isinstance(data, dict):
        cols = {}
        for n, c in data.items():
            cols[n] = c if isinstance(c, list) else np.asarray(c)
        return Block(cols)
    raise TypeError(
        f"Source produced {type(data).__name__}; expected a Block or a "
        f"dict of columns")


def check_block(schema: Schema, block: Block) -> Block:
    """Validate a produced block against the source schema.

    Column NAMES must match exactly (no missing, no extras — a silent
    extra column would change downstream ``trim``/select semantics) and
    dense columns must arrive in the field's storage dtype. Ragged
    (list-backed) columns skip the dtype check — their cells are
    validated lazily by the ops that consume them.
    """
    missing = [f.name for f in schema if f.name not in block.columns]
    extra = [n for n in block.columns if n not in schema]
    if missing or extra:
        raise SchemaMismatch(
            f"block columns {sorted(block.columns)} do not match the "
            f"stream schema {schema.names}"
            + (f"; missing {missing}" if missing else "")
            + (f"; unexpected {extra}" if extra else ""))
    for f in schema:
        col = block.columns[f.name]
        if not isinstance(col, np.ndarray):
            continue  # ragged: cells checked by the consuming op
        expect = np.dtype(f.dtype.np_storage)
        if col.dtype != expect:
            raise SchemaMismatch(
                f"column {f.name!r} arrived as {col.dtype}, schema "
                f"declares {expect} ({f.dtype.name}); cast at the "
                f"producer — streams never cast implicitly")
    return block


class BlockSource:
    """Base protocol for stream sources (see the module docstring).

    Subclasses implement :meth:`poll` / :meth:`done` and expose
    :attr:`schema`; :meth:`close` is optional cleanup.
    """

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def poll(self, timeout: float = 0.0) -> Optional[Block]:
        """The next block, or ``None`` when nothing is available within
        ``timeout`` seconds (0 = non-blocking)."""
        raise NotImplementedError

    def done(self) -> bool:
        """True once the source can never produce another block."""
        return False

    def close(self) -> None:
        """Release any resources; idempotent."""

    def __repr__(self):
        return f"{type(self).__name__}(schema={self.schema.names})"


class GeneratorSource(BlockSource):
    """Wrap any iterable of blocks / column dicts as a source.

    The schema is taken from ``schema=`` or inferred from the first
    produced block (``Schema.from_numpy_columns``); every block is
    checked against it. Finite iterables end the stream cleanly
    (``done()`` turns True at ``StopIteration``).
    """

    def __init__(self, it: Iterable, schema: Optional[Schema] = None):
        self._it: Iterator = iter(it)
        self._schema = schema
        self._done = False
        self._peeked: Optional[Block] = None

    def _infer(self, block: Block) -> Schema:
        dense = {n: c for n, c in block.columns.items()
                 if isinstance(c, np.ndarray)}
        if len(dense) != len(block.columns):
            raise SchemaMismatch(
                "cannot infer a schema from a block with ragged "
                "columns; pass schema= to GeneratorSource")
        return Schema.from_numpy_columns(dense)

    @property
    def schema(self) -> Schema:
        if self._schema is None:
            # peek one block to type the stream (held for the next poll)
            b = self.poll()
            if b is None:
                raise RuntimeError(
                    "GeneratorSource needs schema= when the iterator is "
                    "empty or not ready at definition time")
            self._peeked = b
        return self._schema

    def poll(self, timeout: float = 0.0) -> Optional[Block]:
        if self._peeked is not None:
            b, self._peeked = self._peeked, None
            return b
        if self._done:
            return None
        try:
            data = next(self._it)
        except StopIteration:
            self._done = True
            return None
        b = _as_block(data)
        if self._schema is None:
            self._schema = self._infer(b)
        return check_block(self._schema, b)

    def done(self) -> bool:
        return self._done and self._peeked is None


class QueueSource(BlockSource):
    """A bounded in-memory queue source — the producer-side API.

    ``put()`` converts + schema-checks at the PRODUCER (so a drifting
    producer hears about it synchronously) and blocks when the queue is
    at ``maxsize`` — the queue bound is the stream's ingestion
    backpressure; with ``timeout`` it raises ``queue.Full`` instead.
    ``close()`` ends the stream once the queued blocks drain.
    """

    def __init__(self, schema: Schema, maxsize: int = 64):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self._schema = schema
        self._q: "_queue.Queue[Block]" = _queue.Queue(maxsize=maxsize)
        self._closed = threading.Event()

    @property
    def schema(self) -> Schema:
        return self._schema

    def put(self, data: Union[Block, Dict[str, np.ndarray]],
            timeout: Optional[float] = None) -> None:
        """Enqueue one block (or dict of columns). Blocks while the
        queue is full (backpressure); ``timeout`` bounds the wait and
        raises ``queue.Full``. Raises after :meth:`close`."""
        if self._closed.is_set():
            raise RuntimeError("QueueSource is closed")
        b = check_block(self._schema, _as_block(data))
        self._q.put(b, block=True, timeout=timeout)

    def poll(self, timeout: float = 0.0) -> Optional[Block]:
        try:
            if timeout and timeout > 0:
                return self._q.get(block=True, timeout=timeout)
            return self._q.get_nowait()
        except _queue.Empty:
            return None

    def qsize(self) -> int:
        return self._q.qsize()

    def done(self) -> bool:
        return self._closed.is_set() and self._q.empty()

    def close(self) -> None:
        self._closed.set()


class ParquetTailSource(BlockSource):
    """Follow a parquet file, one block per NEW row group.

    Consumed row groups are never re-read: each poll reads the footer
    (row-group count only) and, when the file has grown, loads just the
    new groups via ``io.read_parquet(row_group_offset=consumed)``. A
    writer that appends row groups (or atomically replaces the file
    with a longer one, the parquet idiom) feeds the stream incrementally.

    ``follow=False`` makes the source FINITE: it drains the row groups
    present as polling proceeds and reports ``done()`` once the count at
    construction time is consumed — the replay mode the equivalence
    tests use. The file must exist at construction (the schema is read
    from its footer, via an empty typed frame).
    """

    def __init__(self, path: str, columns: Optional[Sequence[str]] = None,
                 follow: bool = True,
                 skip_unreadable_after_s: float = 2.0):
        from .. import io as _io

        self._path = path
        self._columns = list(columns) if columns is not None else None
        self._follow = follow
        self._consumed = 0
        self._buffer: "deque[Block]" = deque()
        self._end_at: Optional[int] = None
        self._fail_streak = 0
        self._first_fail_at = 0.0
        # wall-clock floor before a repeatedly-unreadable row group is
        # skipped (loud data loss beats a livelocked tail)
        self._skip_after_s = float(skip_unreadable_after_s)
        total = self._row_groups()
        if not follow:
            self._end_at = total
        # schema probe: offset past the end hits read_parquet's
        # empty-table path, typing the columns from the parquet footer
        # without touching a single row group
        probe = _io.read_parquet(path, columns=self._columns,
                                 row_group_offset=max(total, 1))
        self._schema = probe.schema

    def _row_groups(self) -> int:
        import pyarrow.parquet as pq

        with pq.ParquetFile(self._path) as pf:
            return pf.num_row_groups

    @property
    def schema(self) -> Schema:
        return self._schema

    def poll(self, timeout: float = 0.0) -> Optional[Block]:
        if self._buffer:
            return check_block(self._schema, self._buffer.popleft())
        if self.done():
            return None
        from .. import io as _io

        try:
            total = self._row_groups()
        except Exception as e:
            # mid-replace window: a non-atomic writer leaves a missing
            # or truncated file whose footer read raises OSError OR
            # pyarrow ArrowInvalid ("magic bytes not found") — both are
            # transient here, healed by the writer's next footer
            _log.debug("parquet tail %s unreadable this poll: %s",
                       self._path, e)
            return None
        if self._end_at is not None:
            total = min(total, self._end_at)
        if total <= self._consumed:
            return None
        # after any failure, degrade to ONE group per read: a failing
        # single-group read is attributed to exactly that group, so the
        # eventual skip can never discard a readable group that merely
        # shared a multi-group read with a corrupt later one
        read_n = (total - self._consumed if self._fail_streak == 0
                  else 1)
        try:
            # the EAGER reader, deliberately: public read_parquet is
            # footer-lazy (io.read_parquet), which would (a) pay a second
            # footer read at blocks() — this source's contract is ONE
            # footer read per poll — and (b) move decode errors outside
            # this guard, livelocking the corrupt-group skip machinery
            frame = _io._read_parquet_eager(
                self._path, columns=self._columns, num_partitions=None,
                pad_ragged=False, row_group_offset=self._consumed,
                row_group_limit=read_n)
            blocks = frame.blocks()
        except Exception:
            # mid-replace windows heal on the next poll; a PERSISTENTLY
            # unreadable group (corrupt append) must not livelock the
            # stream re-raising at the same offset forever. Step past
            # ONE group (its rows are lost, loudly) only once
            # SINGLE-GROUP reads of it have failed repeatedly AND for a
            # wall-clock floor — tight poll loops alone (run()'s 10ms
            # default) can never discard a group a slow writer is still
            # replacing. The raise is counted by the runtime's
            # skip-and-count path.
            now = time.monotonic()
            if self._fail_streak == 0:
                self._first_fail_at = now
            self._fail_streak += 1
            if self._fail_streak >= 3 and read_n == 1 and \
                    now - self._first_fail_at >= self._skip_after_s:
                _log.error(
                    "parquet tail %s: row group %d unreadable for "
                    "%.1fs (%d attempts); skipping it (its rows are "
                    "lost)", self._path, self._consumed,
                    now - self._first_fail_at, self._fail_streak)
                self._consumed += 1
                self._fail_streak = 0
            raise
        self._fail_streak = 0
        # one block per row group; a finite (follow=False) source whose
        # file grew mid-replay keeps only the groups inside its end mark
        self._buffer.extend(blocks[: total - self._consumed])
        self._consumed = min(total, self._consumed + read_n)
        if self._buffer:
            return check_block(self._schema, self._buffer.popleft())
        return None

    def done(self) -> bool:
        return (self._end_at is not None
                and self._consumed >= self._end_at
                and not self._buffer)
