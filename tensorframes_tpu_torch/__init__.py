"""tensorframes_tpu_torch: the PyTorch/CUDA port of tensorframes_tpu.

Columnar frames processed by tensor programs on an NVIDIA GPU: build a
frame, run PyTorch functions over its blocks with ``map_blocks``,
``map_rows``, ``filter_rows``, ``reduce_blocks``, ``reduce_rows`` and keyed
``aggregate``, and collect rows. Keyed float sums run through a
hand-written CUDA kernel (``ops/segment_reduce.py``, ``csrc/segment_sum.cu``).
``models`` holds the decoder-only transformer LM, whose attention runs
through a second one (``ops/flash_attention.py``,
``csrc/flash_attention.cu``).

Lazy chains are forced through the logical plan (``plan/``): adjacent ops
fuse into one dispatch per block, and a frame from :func:`read_parquet`
reads only the columns and row groups the chain needs (``TFT_FUSE=0``
runs every op on its own). The DSL (``dsl``, with :func:`block` and
:func:`row`) builds programs without writing PyTorch. ``relational`` holds
the joins (:func:`join`, ``TensorFrame.join``: broadcast hash and host
sort-merge, both plan leaves) and the sketch combiners
(:func:`approx_distinct`, :func:`approx_quantile`, :func:`approx_top_k`)
that ``aggregate`` takes beside ``"sum"``.

``resilience`` retries transient dispatch failures, classifies errors and
injects faults (``resilience.faults``); a ``map_rows`` block that runs out
of device memory re-runs as two halves, recursively, and a pipelined block
whose submit failed re-runs synchronously at its drain. ``observability``
correlates what a query did (``query_trace``, ``last_query``, the
always-on ``flight`` recorder, the card's memory watermarks) when
``TFT_TRACE`` is set.

``memory`` budgets the card (``TFT_MEM_LIMIT_BYTES``, or the card's limit
x ``TFT_MEM_FRACTION``): every dispatch is admitted against the ledger, a
row-local block over the whole budget splits before it dispatches, and
cold resident buffers (pending blocks, join build tables) spill to pinned
host memory. ``engine.preempt.PreemptionScope`` lets a running query park
at a block boundary and resume later from its checkpoint
(``memory.persist`` writes it to ``TFT_PERSIST_DIR``).

``stream`` runs the same ops over a continuous source
(``stream.from_source``): per-batch transforms, a stream-table join, and
keyed window folds into state on the device through the same segment
reductions, with failure isolation, a slot pool and live metrics
(``observability.metrics_text``, :func:`timeline`).

``serve`` is the multi-tenant front end: :func:`submit` (or
``TensorFrame.submit``) queues a query on a ``QueryScheduler`` with
per-tenant weights, quotas, deadlines, admission against the card's
memory and preemption; :func:`serve_report` shows it.
``serve.ServeFabric`` places tenants across several schedulers
(``serve.FabricWorker``), resumes a lost worker's queries on a survivor
from their persisted checkpoints (``serve.FabricQuery`` survives its
worker) and restarts workers one by one; ``serve.live_fabric`` and
``serve.fabric_enabled`` read its state and ``TFT_FABRIC``.
``resilience.chaos`` composes the fault sites into seeded schedules
(``TFT_CHAOS``), and ``tools.chaos_soak`` drives a mixed workload under
one. The observability
layer reports through :func:`last_query_report` and ``explain()``, the
durable query :func:`history` and :func:`postmortem`, the performance
sentinel's :func:`regressions`, per-tenant SLOs, :func:`why`,
:func:`doctor` and :func:`health`.

``builder`` runs shipped programs: ``Computation.serialize`` (or
``builder.save_computation``) writes a program as bytes in one process,
and ``builder.load_computation`` or ``builder.map_blocks_builder(df)
.graph(blob)`` runs it in another, without the Python that wrote it.
``serve.SharedCompileCache`` interns equivalent programs at the executor
(``engine.executor.set_computation_interner``).

The entry points run on ``cuda`` unless the caller asks for the CPU, with
:func:`set_default_device` or ``executor=BlockExecutor(device="cpu")``.
This package imports neither ``jax`` nor ``tensorframes_tpu``.
"""

from __future__ import annotations

__version__ = "0.1.0"

from .shape import Shape, Unknown
from . import dtypes
from . import utils
from .utils.logging import initialize_logging
from .utils.tracing import dump_stats
from .device import default_device, set_default_device
from .schema import Field, Schema
from .frame import Block, GroupedFrame, Row, TensorFrame
from .computation import Computation, TensorSpec, analyze_graph
from .engine.executor import BlockExecutor
from .api import (
    aggregate, analyze, block, explain, filter_rows, frame, map_blocks,
    map_rows, print_schema, reduce_blocks, reduce_rows, row, submit,
)
from .io import (from_pandas, read_csv, read_npz, read_parquet, to_pandas,
                 write_csv, write_npz, write_parquet)
from . import dsl
from . import io
from . import memory
from . import plan
from . import interop
from . import ops
from . import models
from . import relational
from . import observability
from . import resilience
from . import stream
from . import builder
from . import serve
from .observability import (doctor, health, last_query_report, regressions,
                            why)
from .observability.history import history, postmortem
from .observability.timeline import timeline
from .serve import quarantine_status, serve_report, unquarantine
from .relational import (approx_distinct, approx_quantile, approx_top_k,
                         join)

__all__ = [
    "Shape",
    "Unknown",
    "Field",
    "Schema",
    "dtypes",
    "Block",
    "GroupedFrame",
    "Row",
    "TensorFrame",
    "Computation",
    "TensorSpec",
    "analyze_graph",
    "BlockExecutor",
    "map_rows",
    "map_blocks",
    "reduce_rows",
    "reduce_blocks",
    "filter_rows",
    "aggregate",
    "analyze",
    "print_schema",
    "explain",
    "frame",
    "block",
    "row",
    "read_parquet",
    "write_parquet",
    "from_pandas",
    "to_pandas",
    "read_npz",
    "write_npz",
    "read_csv",
    "write_csv",
    "dsl",
    "io",
    "memory",
    "plan",
    "utils",
    "interop",
    "ops",
    "models",
    "relational",
    "observability",
    "resilience",
    "stream",
    "builder",
    "serve",
    "submit",
    "serve_report",
    "unquarantine",
    "quarantine_status",
    "initialize_logging",
    "dump_stats",
    "last_query_report",
    "why",
    "health",
    "doctor",
    "history",
    "postmortem",
    "regressions",
    "timeline",
    "join",
    "approx_distinct",
    "approx_quantile",
    "approx_top_k",
    "set_default_device",
    "default_device",
    "__version__",
]
