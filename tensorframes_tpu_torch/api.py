"""Public user-facing API.

The port's counterpart of ``tensorframes_tpu/api.py``: ``map_blocks``,
``map_rows``, ``filter_rows``, ``reduce_blocks``, ``reduce_rows``,
``aggregate``, ``analyze``, ``print_schema``, ``explain``, ``frame``, and
the DSL's frame-derived placeholders ``block`` and ``row``.

- *fetches* are PyTorch callables over named tensors, DSL nodes (one or a
  list), or :class:`~.computation.Computation` objects;
- reduce results unpack to numpy: one array for a single fetch, a list for
  several.

- :func:`submit` defers a frame's forcing to the serving scheduler
  (``serve/scheduler.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np

from .analysis import analyze, explain, print_schema
from .engine import ops as _ops
from .engine.compaction import DEFAULT_BUFFER_SIZE
from .frame import GroupedFrame, TensorFrame, frame

__all__ = [
    "map_blocks", "map_rows", "reduce_blocks", "reduce_rows", "aggregate",
    "filter_rows", "analyze", "print_schema", "explain", "frame", "block",
    "row", "submit",
]


def submit(dframe: Union[TensorFrame, GroupedFrame], fetches=None, *,
           tenant: str = "default", deadline: Optional[float] = None,
           est_rows: Optional[float] = None,
           est_bytes: Optional[int] = None,
           scheduler=None):
    """Defer a frame's forcing to the multi-tenant query scheduler.

    The query (``dframe``, with ``fetches`` applied through
    ``map_blocks`` when given) joins ``tenant``'s bounded FIFO queue on
    the process-default :class:`~.serve.QueryScheduler` (or on
    ``scheduler``) and runs under its weighted-fair selection, admission
    against the card's memory, and quotas. ``dframe`` may also be a
    grouped frame: the query is then ``aggregate(fetches, dframe)``, run
    whole on the scheduler's worker (the JAX package takes only a frame).
    Returns a
    :class:`~.serve.SubmittedQuery` future; a full queue or an exhausted
    rows/sec budget raises a classified :class:`~.resilience.QueueFull` /
    :class:`~.resilience.OverQuota` at once. ``deadline`` (seconds)
    bounds the queue wait and the run together."""
    from . import serve as _serve
    sched = scheduler if scheduler is not None \
        else _serve.default_scheduler()
    return sched.submit(dframe, fetches, tenant=tenant, deadline=deadline,
                        est_rows=est_rows, est_bytes=est_bytes)


def map_blocks(fetches, dframe: TensorFrame, trim: bool = False,
               executor=None) -> TensorFrame:
    """Transforms a frame into another frame block by block.

    Appends new columns (trim=False) or discards the inputs and returns only
    the computation's outputs (trim=True), in which case the number of rows
    may differ from the input block's. Lazy. ``executor`` overrides the
    process-default :class:`~.engine.executor.BlockExecutor`.
    """
    return _ops.map_blocks(fetches, dframe, trim=trim, executor=executor)


def map_rows(fetches, dframe: TensorFrame, executor=None) -> TensorFrame:
    """Transforms a frame row by row, adding one column per fetch.

    Works on cells (no leading block dimension); the only op that accepts
    rows whose vector cells vary in size. Lazy.
    """
    return _ops.map_rows(fetches, dframe, executor=executor)


def _unpack(result: Dict[str, np.ndarray], names: Sequence[str]):
    vals = []
    for n in names:
        v = result[n]
        vals.append(v.item() if v.ndim == 0 else v)
    return vals[0] if len(vals) == 1 else vals


def reduce_blocks(fetches, dframe: TensorFrame, executor=None):
    """Reduces the frame to one row, block-at-a-time then across partials.

    Naming contract: each fetch ``z`` requires an input ``z_input`` of one
    rank higher. Eager; combine order unspecified. Returns a numpy value per
    fetch (a list if several).
    """
    comp = _ops._reduce_computation(fetches, dframe.schema, ("_input",),
                                    block_level=True)
    out = _ops.reduce_blocks(comp, dframe, executor=executor)
    return _unpack(out, comp.output_names)


def reduce_rows(fetches, dframe: TensorFrame, executor=None):
    """Reduces the frame to one row, pairwise.

    Naming contract: each fetch ``z`` requires inputs ``z_1`` and ``z_2`` of
    z's own shape/dtype. Eager; order unspecified.
    """
    comp = _ops._reduce_computation(fetches, dframe.schema, ("_1", "_2"),
                                    block_level=False)
    out = _ops.reduce_rows(comp, dframe, executor=executor)
    return _unpack(out, comp.output_names)


def filter_rows(predicate, dframe: TensorFrame,
                executor=None) -> TensorFrame:
    """Keeps the rows where ``predicate`` is true (nonzero). Lazy.

    ``predicate`` follows the map conventions (named args select columns)
    and must produce one boolean/integer vector of block length.
    """
    return _ops.filter_rows(predicate, dframe, executor=executor)


def aggregate(fetches, grouped_data: GroupedFrame,
              buffer_size: int = DEFAULT_BUFFER_SIZE,
              executor=None) -> TensorFrame:
    """Algebraic aggregation of the grouped data: one output row per key,
    fetch columns appended to the key columns."""
    return _ops.aggregate(fetches, grouped_data, buffer_size=buffer_size,
                          executor=executor)


def block(df: TensorFrame, col_name: str, tf_name: Optional[str] = None):
    """DSL placeholder shaped like **blocks** of a column.

    The leading dimension is always unknown: a block's row count varies and
    may be zero on empty partitions (reference ``core.py:302-315,
    350-355``).
    """
    from . import dsl as _dsl
    from .shape import Unknown
    field = df.schema.get(col_name)
    if field is None:
        raise ValueError(f"Could not find column with name {col_name!r}")
    shape = _ops._field_spec(field, True, "block placeholder") \
        .with_lead(Unknown)
    return _dsl.placeholder(field.dtype, shape, name=tf_name or col_name)


def row(df: TensorFrame, col_name: str, tf_name: Optional[str] = None):
    """DSL placeholder shaped like **one row** of a column
    (reference ``core.py:317-330``)."""
    from . import dsl as _dsl
    field = df.schema.get(col_name)
    if field is None:
        raise ValueError(f"Could not find column with name {col_name!r}")
    shape = _ops._field_spec(field, False, "row placeholder")
    return _dsl.placeholder(field.dtype, shape, name=tf_name or col_name)
