"""Byte/row estimates for frames.

The port's counterpart of the part of ``tensorframes_tpu/memory/estimate.py``
the logical plan uses. Forced frames are exact (their cached blocks are
counted); lazy frames carry **hints** threaded through the ops at
construction time: source constructors record their actual bytes, and
every op scales its input's hint by the schema row-byte ratio (an upper
bound for ``filter``, exact for ``select``). An unforced frame with a plan
node answers from the node's per-column cost model instead
(:meth:`~..plan.nodes.PlanNode.estimate`).

Not in this package yet: the distributed/exchange estimates of the JAX
package (``dist_frame_estimate``, ``exchange_buffer_bytes``; with the
parallel layer, ``ROADMAP.md`` A10).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import get_logger

__all__ = ["array_nbytes", "column_nbytes", "block_nbytes",
           "blocks_estimate", "schema_row_bytes", "frame_estimate",
           "propagate_hints"]

_log = get_logger("memory.estimate")


def array_nbytes(a: Any) -> int:
    """Byte size of an array (numpy or torch); 0 when it has no size."""
    if hasattr(a, "element_size") and hasattr(a, "numel"):  # torch.Tensor
        return int(a.numel()) * int(a.element_size())
    nb = getattr(a, "nbytes", None)
    if nb is not None:
        return int(nb)
    try:
        return int(np.prod(a.shape)) * np.dtype(a.dtype).itemsize
    except (AttributeError, TypeError):
        return 0


def column_nbytes(col) -> int:
    """Host bytes of one column (ragged list columns sum their cells; a
    string cell counts a pointer). The single definition the plan cost
    model and block accounting share."""
    if isinstance(col, np.ndarray):
        return int(col.nbytes)
    total = 0
    for cell in col:
        total += array_nbytes(cell) or 8
    return total


def block_nbytes(block) -> int:
    """Host bytes of one block."""
    return sum(column_nbytes(col) for col in block.columns.values())


def blocks_estimate(blocks: Sequence) -> Tuple[int, int]:
    """Exact ``(rows, bytes)`` of a materialized block list."""
    rows = 0
    nbytes = 0
    for b in blocks:
        rows += int(b.num_rows)
        nbytes += block_nbytes(b)
    return rows, nbytes


def schema_row_bytes(schema) -> int:
    """Declared bytes per row of a schema: storage itemsize times the
    known cell size (Unknown dims count 1, a deliberate floor);
    non-tensor (string) columns count a pointer."""
    total = 0
    for f in schema:
        if not f.dtype.tensor:
            total += 8
            continue
        cells = 1
        cell = f.cell_shape
        if cell is not None:
            for d in cell.dims:
                if isinstance(d, int) and d > 0:
                    cells *= d
        total += cells * int(np.dtype(f.dtype.np_storage).itemsize)
    return max(total, 1)


def frame_estimate(frame) -> Tuple[Optional[float], Optional[int]]:
    """Best-effort ``(rows, bytes)`` of a frame: exact when forced; for an
    unforced frame with a plan node, the plan's per-column cost model;
    else the construction-time hints; ``(None, None)`` when nothing is
    known."""
    blocks = getattr(frame, "_cache", None)
    if blocks:
        rows, nbytes = blocks_estimate(blocks)
        return float(rows), nbytes
    node = getattr(frame, "_plan_node", None)
    if node is not None:
        try:
            rows, col_bytes = node.estimate()
        except Exception as e:  # noqa: BLE001 - an estimate is advisory
            _log.debug("plan-node estimate failed (%s); falling back to "
                       "the scalar hints", e)
            rows, col_bytes = None, None
        if col_bytes is not None:
            return (float(rows) if rows is not None else None,
                    int(sum(col_bytes.values())))
    rows = getattr(frame, "_rows_hint", None)
    nbytes = getattr(frame, "_bytes_hint", None)
    return (float(rows) if rows is not None else None,
            int(nbytes) if nbytes is not None else None)


def propagate_hints(src_frame, out_schema
                    ) -> Tuple[Optional[int], Optional[int]]:
    """``(rows_hint, bytes_hint)`` for an op's result frame: rows carry
    over; bytes scale by the schema row-byte ratio. An upper bound for
    row-dropping ops (filter), exact for column projections."""
    rows, nbytes = frame_estimate(src_frame)
    if nbytes is not None:
        src_schema = getattr(src_frame, "_schema", None)
        if src_schema is not None and src_schema is not out_schema:
            nbytes = int(nbytes * schema_row_bytes(out_schema)
                         / schema_row_bytes(src_schema))
    return (int(rows) if rows is not None else None, nbytes)
