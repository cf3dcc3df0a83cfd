"""Streaming execution: continuous block sources over the same engine.

The port's counterpart of ``tensorframes_tpu/stream/``. The pipelined
engine streams a finite frame's blocks through a bounded in-flight
window; this package extends that to CONTINUOUS sources, with keyed
incremental state staying on the device across batches:

- **sources** (:mod:`.source`): the ``BlockSource`` protocol with
  ``ParquetTailSource`` (re-reads nothing: consumed row groups are
  skipped by ``row_group_offset``), ``GeneratorSource`` and the bounded
  ``QueueSource`` (the queue bound is the ingestion backpressure);
- **relational ops** (:mod:`.frame`): ``StreamingFrame`` applies
  ``map_blocks`` / ``map_rows`` / ``filter_rows`` / ``select`` / ``join``
  batch by batch through the unchanged engine ops; fetches resolve to one
  Computation at definition time, and finite streams are bit-identical to
  the batch path;
- **incremental aggregation** (:mod:`.aggregate`): keyed monoid folds
  (sum/min/max/prod and the sketch combiners) of each batch into window
  state on the device, one segment reduction per column (float sums
  through the CUDA ``segment_sum`` kernel on a GPU), with tumbling and
  sliding windows, watermark emission, late-row accounting, and state
  that spills to pinned host memory under a device budget;
- **runtime** (:mod:`.runtime`): the ``StreamHandle`` pump: per-batch
  failure isolation through the resilience retry and classification (a
  poisoned batch is skipped and counted, never kills the stream), the
  slot pool, per-batch query traces and live ``tft_stream_*`` metrics;
- **sinks** (:mod:`.sink`): ``collect_updates()`` polling, callbacks and
  a parquet appender whose output is itself tail-able.

Quick start::

    import tensorframes_tpu_torch as ttf
    from tensorframes_tpu_torch import stream

    src = stream.ParquetTailSource("events.parquet")
    agg = (stream.from_source(src)
           .filter_rows(lambda amount: amount > 0)
           .group_by("user")
           .aggregate({"amount": "sum"},
                      window=stream.tumbling(60.0), time_col="ts",
                      watermark_delay=5.0))
    handle = agg.start(name="spend")
    handle.run(timeout_s=10)            # or handle.start_background()
    for frame in handle.collect_updates():
        frame.show()
"""

from .aggregate import (StreamingAggregation, Window, WINDOW_COL, sliding,
                        tumbling)
from .frame import GroupedStream, StreamingFrame
from .runtime import StreamHandle
from .sink import CallbackSink, CollectSink, ParquetSink
from .source import (BlockSource, GeneratorSource, ParquetTailSource,
                     QueueSource, SchemaMismatch, check_block)

__all__ = [
    "BlockSource", "GeneratorSource", "QueueSource", "ParquetTailSource",
    "SchemaMismatch", "check_block",
    "StreamingFrame", "GroupedStream", "from_source",
    "StreamingAggregation", "Window", "WINDOW_COL", "tumbling", "sliding",
    "StreamHandle",
    "CollectSink", "CallbackSink", "ParquetSink",
]


def from_source(source: BlockSource) -> StreamingFrame:
    """The entry point: wrap a block source as a ``StreamingFrame``."""
    return StreamingFrame(source)
