"""Row <-> columnar-block marshalling.

The port's counterpart of ``tensorframes_tpu/marshal.py``: blocks are
**columnar numpy arrays** on the host that the executor copies to the device
as torch tensors; rows only materialize at the user boundary (``collect``).
A fast vectorized path and a slow validating path are both kept.

``infer_physical_shape`` resolves at most one unknown dim of a declared shape
from a flat buffer's element count.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from .schema import Field, Schema
from .shape import Shape, Unknown

__all__ = [
    "rows_to_columns",
    "columns_to_rows",
    "infer_physical_shape",
    "validate_block_column",
]

Column = Union[np.ndarray, List[np.ndarray]]  # dense | ragged


def infer_physical_shape(num_elements: int, declared: Shape,
                         context: str = "") -> Tuple[int, ...]:
    """Resolve the dims of a flat buffer of ``num_elements`` against a
    declared shape with at most one Unknown dim."""
    unknowns = [i for i, d in enumerate(declared.dims) if d == Unknown]
    if len(unknowns) > 1:
        raise ValueError(
            f"Shape {declared} has multiple unknown dims; cannot infer "
            f"physical shape{': ' + context if context else ''}")
    known = math.prod(d for d in declared.dims if d != Unknown)
    if not unknowns:
        if known != num_elements:
            raise ValueError(
                f"Buffer of {num_elements} elements does not match shape "
                f"{declared}{': ' + context if context else ''}")
        return declared.dims
    if known == 0 or num_elements % known != 0:
        raise ValueError(
            f"Buffer of {num_elements} elements cannot fill shape "
            f"{declared}{': ' + context if context else ''}")
    dims = list(declared.dims)
    dims[unknowns[0]] = num_elements // known
    return tuple(dims)


def _cell_to_array(cell, dtype: np.dtype) -> np.ndarray:
    if cell is None:
        raise ValueError("Null cell encountered; nullable fields are not "
                         "accepted (analyze/ops reject them)")
    return np.asarray(cell, dtype=dtype)


def rows_to_columns(rows: Sequence[Sequence], schema: Schema,
                    fast: bool = True) -> Dict[str, Column]:
    """Convert a sequence of row tuples into columnar arrays.

    Fast path: one vectorized ``np.asarray`` per column (dense data).
    Slow path (and fallback): per-cell conversion with shape validation;
    ragged columns come back as a list of per-row arrays.
    """
    ncols = len(schema)
    out: Dict[str, Column] = {}
    # one C-level transpose instead of re-indexing [r[j] for r in rows]
    # per column (O(rows*cols) Python indexing on the ingest path);
    # len(), not truthiness: rows may be a 2-D ndarray
    transposed = tuple(zip(*rows)) if len(rows) else ((),) * ncols
    for j, field in enumerate(schema):
        np_dt = field.dtype.np_storage
        cells = transposed[j]
        if fast:
            try:
                arr = np.asarray(cells, dtype=np_dt)
                if arr.dtype == object:
                    raise ValueError("ragged")
                out[field.name] = arr
                continue
            except (ValueError, TypeError):
                pass  # fall through to slow path
        arrays = [_cell_to_array(c, np_dt) for c in cells]
        shapes = {a.shape for a in arrays}
        if len(shapes) <= 1:
            out[field.name] = (np.stack(arrays) if arrays
                               else np.empty((0,) + _concrete_cell(field),
                                             np_dt))
        else:
            out[field.name] = arrays  # ragged
    # sanity: all columns agree on row count
    for name, col in out.items():
        n = len(col)
        if n != len(rows):
            raise AssertionError(
                f"Column {name} has {n} rows, expected {len(rows)}")
    assert len(out) == ncols
    return out


def _concrete_cell(field: Field) -> Tuple[int, ...]:
    cs = field.cell_shape
    if cs is None or cs.has_unknown:
        return ()
    return cs.dims


def columns_to_rows(columns: Dict[str, Column], schema: Schema,
                    fast: bool = True) -> List[tuple]:
    """Convert columnar arrays back into row tuples.

    Scalar cells come back as Python scalars, tensor cells as numpy arrays —
    the shape users see from ``collect`` (reference returns Spark Rows whose
    array cells the Python layer re-wraps as numpy, ``core.py:78-92``).
    """
    names = schema.names
    cols = [columns[n] for n in names]
    if not cols:
        return []
    lens = {len(c) for c in cols}
    if len(lens) > 1:
        raise ValueError(
            "columns disagree on row count: "
            + ", ".join(f"{n}={len(c)}" for n, c in zip(names, cols)))
    if fast:
        # column-at-a-time: ndarray.tolist() unboxes a whole scalar column
        # to Python values in C, list(arr) splits a tensor column into row
        # views in C, and zip reassembles tuples — ~10x the per-cell loop
        # below (the reference's fastPath/slow-path split, DataOps.scala:40)
        seqs = [c.tolist() if isinstance(c, np.ndarray) and c.ndim == 1
                else list(c) for c in cols]
        return list(zip(*seqs))
    n = len(cols[0])
    scalar = [isinstance(c, np.ndarray) and c.ndim == 1 for c in cols]
    rows = []
    for i in range(n):
        row = []
        for c, is_scalar in zip(cols, scalar):
            v = c[i]
            if is_scalar:
                # object columns (string) index straight to python values
                v = v.item() if isinstance(v, np.generic) else v
            elif isinstance(v, np.ndarray):
                v = np.asarray(v)
            row.append(v)
        rows.append(tuple(row))
    return rows


def validate_block_column(name: str, col: Column, field: Field) -> None:
    """Check a materialized column against its declared field info."""
    if isinstance(col, np.ndarray):
        declared = field.block_shape
        if declared is not None and not declared.matches_concrete(col.shape):
            raise ValueError(
                f"Column {name!r}: block of shape {tuple(col.shape)} does "
                f"not conform to declared shape {declared}")
    else:
        for i, cell in enumerate(col):
            if field.cell_shape is not None and \
                    field.cell_shape.ndim != cell.ndim:
                raise ValueError(
                    f"Column {name!r} row {i}: cell rank {cell.ndim} does "
                    f"not match declared cell shape {field.cell_shape}")
