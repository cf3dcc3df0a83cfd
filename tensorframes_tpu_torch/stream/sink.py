"""Stream sinks: where per-batch outputs and emitted windows land.

The port's counterpart of ``tensorframes_tpu/stream/sink.py``. A sink is any object with ``write(frame)`` (called once per output
:class:`~..frame.TensorFrame`) and optionally ``close()`` (called when
the stream finalizes or stops). Three built-ins:

- :class:`CollectSink` — buffers frames for polling (the explicit form
  of the handle's built-in ``collect_updates()`` buffer);
- :class:`CallbackSink` — adapts a plain callable;
- :class:`ParquetSink` — appends every frame to one growing parquet
  file, one row group per block, through a single open writer. The
  output of a parquet-sink'd stream is itself tail-able by a
  :class:`~.source.ParquetTailSource` — streams compose end to end.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from ..frame import TensorFrame
from ..utils.logging import get_logger

__all__ = ["CollectSink", "CallbackSink", "ParquetSink"]

_log = get_logger("stream.sink")


class CollectSink:
    """Buffer output frames; ``collect()`` drains them (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._frames: List[TensorFrame] = []

    def write(self, frame: TensorFrame) -> None:
        with self._lock:
            self._frames.append(frame)

    def collect(self) -> List[TensorFrame]:
        with self._lock:
            out, self._frames = self._frames, []
        return out

    def close(self) -> None:
        pass  # nothing to release; buffered frames stay collectable


class CallbackSink:
    """Adapt ``fn(frame)`` as a sink (``on_update=`` does this for
    you; the class exists for composing sinks explicitly)."""

    def __init__(self, fn: Callable[[TensorFrame], None],
                 on_close: Optional[Callable[[], None]] = None):
        self._fn = fn
        self._on_close = on_close

    def write(self, frame: TensorFrame) -> None:
        self._fn(frame)

    def close(self) -> None:
        if self._on_close is not None:
            self._on_close()


class ParquetSink:
    """Append every output frame to ``path`` as parquet row groups.

    One ``pyarrow.parquet.ParquetWriter`` stays open across writes (the
    schema is pinned by the first frame); each block becomes one row
    group, so the file is incrementally tail-able. ``close()`` (called
    by the stream handle at finalize/stop) finishes the footer —
    readers see all row groups written so far only after a footer
    exists, i.e. parquet tailing composes with ATOMIC replace-style
    writers; this sink's own file is complete at close.
    """

    def __init__(self, path: str):
        # pyarrow is imported here, on the thread that makes the sink: a
        # first import on a background pump thread that later exits
        # leaves pyarrow crashing at its next use on another thread
        # (seen with pyarrow 25.0.0)
        import pyarrow.parquet as pq

        self._pq = pq
        self.path = path
        self._writer = None
        self._lock = threading.Lock()

    def write(self, frame: TensorFrame) -> None:
        from ..io import _frame_block_to_table

        with self._lock:
            for b in frame.blocks():
                if b.num_rows == 0:
                    continue
                tbl = _frame_block_to_table(b, frame.schema)
                if self._writer is None:
                    self._writer = self._pq.ParquetWriter(self.path,
                                                          tbl.schema)
                self._writer.write_table(tbl)

    def close(self) -> None:
        with self._lock:
            w, self._writer = self._writer, None
        if w is not None:
            w.close()
            _log.info("parquet sink closed: %s", self.path)
