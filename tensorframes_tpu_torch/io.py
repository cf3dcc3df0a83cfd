"""Columnar IO: parquet / pandas / npz / csv in and out of TensorFrames.

The port's counterpart of ``tensorframes_tpu/io.py``, with the same
contracts: reading maps parquet row groups to partitions with no
row-at-a-time work, and a parquet read of scalar, fixed-size-list and
string columns is LAZY — only the footer is read at ``read_parquet``, and
the frame carries a :class:`~.plan.nodes.ParquetScanNode` so that the
logical plan pushes column pruning and row-group refutation into the read
at forcing.

Scope: scalar columns (float/double/int/long/bool/string),
fixed-size-list columns (vector cells), and variable-length list columns
— the latter load as RAGGED columns (one numpy cell per row, the
engine's in-memory ragged format, which ``map_rows`` consumes directly;
``read_parquet(..., pad_ragged=...)`` densifies them at load time into a
``[rows, L]`` column plus ``_mask``/``_len`` columns). Null policy: a
floating column's nulls load as NaN; an int/bool column with nulls, or
any column whose footer cannot prove zero nulls, takes the eager decode,
whose schema follows the decoded data.

pyarrow and pandas are imported inside the functions that use them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .frame import TensorFrame
from .utils.tracing import counters, span

__all__ = ["read_parquet", "write_parquet", "from_pandas", "to_pandas",
           "read_npz", "write_npz", "read_csv", "write_csv"]


class _RaggedParts:
    """A variable-length list column decoded as its arrow buffers.

    Holds the flattened value buffer plus the per-row offsets — the
    columnar form the pad path consumes DIRECTLY (one vectorized scatter,
    no per-cell Python work: the reference's acknowledged per-row boxing
    weakness, ``DataOps.scala:30-33``, eliminated at the IO boundary).
    ``cells()`` materializes the engine's in-memory ragged format (one
    numpy view per row) for frames that stay ragged. Internal to
    :func:`read_parquet` — never escapes into a TensorFrame.
    """

    __slots__ = ("flat", "offs")

    def __init__(self, flat: np.ndarray, offs: np.ndarray):
        self.flat = flat
        self.offs = offs

    def __len__(self) -> int:
        return len(self.offs) - 1

    @property
    def lens(self) -> np.ndarray:
        return self.offs[1:] - self.offs[:-1]

    def cells(self) -> list:
        flat, offs = self.flat, self.offs
        return [flat[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]

    def pad(self, width: int, dtype) -> tuple:
        """-> (dense [rows, width], mask int32, lens int64), vectorized."""
        lens = self.lens
        r = len(lens)
        m = np.arange(width) < lens[:, None]
        dense = np.zeros((r, width), dtype)
        dense[m] = self.flat  # row-major fill == concatenated cell order
        return dense, m.astype(np.int32), lens.astype(np.int64)


def _column_to_numpy(col, name: str):
    """One pyarrow ChunkedArray/Array -> dense numpy column (or
    :class:`_RaggedParts` for variable-length list columns)."""
    import pyarrow as pa

    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    t = col.type
    if pa.types.is_fixed_size_list(t):
        flat = col.flatten().to_numpy(zero_copy_only=False)
        return np.asarray(flat).reshape(len(col), t.list_size)
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        import pyarrow.compute as pc

        if col.null_count:
            raise ValueError(
                f"column {name!r}: {col.null_count} null list cell(s); "
                f"vector columns must be dense to load from parquet")
        lengths = pc.unique(pc.list_value_length(col)).to_pylist()
        if len(lengths) == 1:
            width = lengths[0]
            flat = col.flatten().to_numpy(zero_copy_only=False)
            return np.asarray(flat).reshape(len(col), width)
        # variable-length lists: keep the (values, offsets) buffer pair —
        # cells slice out lazily, and the pad path never makes cells
        flat = np.asarray(col.flatten().to_numpy(zero_copy_only=False))
        offs = np.asarray(col.offsets).astype(np.int64)
        return _RaggedParts(flat, offs)
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return np.asarray(col.to_pylist(), dtype=object)
    return col.to_numpy(zero_copy_only=False)


def _arrow_field_to_field(af):
    """Footer type -> schema Field matching what the EAGER decode would
    infer from materialized data, or ``None`` for types the lazy scan
    does not cover (variable-length lists, dates, decimals...)."""
    import pyarrow as pa

    from . import dtypes as _dt
    from .schema import Field
    from .shape import Shape, Unknown

    t = af.type
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return Field(af.name, _dt.string, sql_rank=0)
    if pa.types.is_fixed_size_list(t):
        try:
            dt = _dt.from_numpy(np.dtype(t.value_type.to_pandas_dtype()))
        except Exception:
            return None
        if not dt.tensor:
            return None
        return Field(af.name, dt,
                     block_shape=Shape(Unknown, t.list_size), sql_rank=1)
    if pa.types.is_floating(t) or pa.types.is_integer(t) \
            or pa.types.is_boolean(t):
        try:
            dt = _dt.from_numpy(np.dtype(t.to_pandas_dtype()))
        except Exception:
            return None
        return Field(af.name, dt, block_shape=Shape(Unknown), sql_rank=0)
    return None


def read_parquet(path: str, columns: Optional[Sequence[str]] = None,
                 num_partitions: Optional[int] = None,
                 pad_ragged=False,
                 row_group_offset: int = 0,
                 row_group_limit: Optional[int] = None) -> TensorFrame:
    """Read a parquet file into a TensorFrame, row groups → partitions.

    ``columns=`` projects at READ time: only the named columns' chunks
    are decoded (footer-driven — unrequested columns' bytes are never
    touched), composing with ``row_group_offset``/``row_group_limit``.

    ``num_partitions=None`` keeps the file's row-group structure (the
    natural block layout); an explicit value re-blocks after load.

    Variable-length list columns become RAGGED columns (usable by
    ``map_rows`` directly). ``pad_ragged=True`` pads every ragged column
    at load (dense ``[rows, L]`` plus ``_mask``/``_len`` columns); a
    sequence of names pads just those, a column that is not ragged
    through :meth:`~.frame.TensorFrame.pad_column`.

    ``row_group_offset`` skips the first N row groups — only groups at
    index >= offset are read (one footer read, no data touched for the
    skipped groups); ``row_group_limit`` caps how many groups are read
    from there. An offset
    at/past the end returns an EMPTY frame whose columns are still
    typed from the parquet schema.

    Files of scalar / fixed-size-list / string columns load LAZILY: only
    the footer is read here; data reads happen at forcing, which lets
    the logical plan push column pruning and row-group refutation into
    the read — a chain that references two of six columns touches two
    columns' bytes. The row-group range is pinned at footer time, so a
    concurrently-appended file never changes what a frame reads.
    ``pad_ragged`` or any other column type falls back to the eager
    read, byte-for-byte today's behavior.
    """
    import pyarrow as pa
    import pyarrow.parquet as pq

    if tuple(int(x) for x in pa.__version__.split(".")[:1]) < (11,):
        raise ImportError(
            f"read_parquet needs pyarrow >= 11 (found {pa.__version__}): "
            f"it relies on ParquetFile context management and "
            f"Schema.empty_table")
    if row_group_offset < 0:
        raise ValueError(
            f"row_group_offset must be >= 0, got {row_group_offset}")
    if row_group_limit is not None and row_group_limit < 1:
        raise ValueError(
            f"row_group_limit must be >= 1, got {row_group_limit}")

    with pq.ParquetFile(path) as pf:
        file_names = list(pf.schema_arrow.names)
        names = list(columns) if columns is not None else file_names
        missing = [n for n in names if n not in file_names]
        if missing:
            raise ValueError(
                f"read_parquet: column(s) {missing} not in {path!r}; "
                f"file columns: {file_names}")
        lazy = None
        if not pad_ragged:
            lazy = _lazy_parquet_frame(pf, path, names, num_partitions,
                                       row_group_offset, row_group_limit)
        if lazy is not None:
            return lazy
        # eager fallback reuses the already-open footer (one parse
        # per call, not two)
        return _read_parquet_eager(path, names, num_partitions,
                                   pad_ragged, row_group_offset,
                                   row_group_limit, pf=pf)


def _lazy_parquet_frame(pf, path, names, num_partitions,
                        row_group_offset, row_group_limit):
    """A lazy scan frame from the footer alone, or ``None`` when the
    file needs the eager decode (unsupported types, nothing to read)."""
    import weakref

    from .frame import _split_even
    from .plan.nodes import ParquetScanNode, attach
    from .schema import Schema

    fields = []
    for n in names:
        f = _arrow_field_to_field(pf.schema_arrow.field(n))
        if f is None:
            return None
        fields.append(f)
    if not fields:
        return None
    md = pf.metadata
    end_group = md.num_row_groups
    if row_group_limit is not None:
        end_group = min(end_group, row_group_offset + row_group_limit)
    n_groups = end_group - row_group_offset
    if n_groups < 1:
        return None  # empty range: the eager typed-empty frame is cheap
    # null policy: the eager decode materializes int/bool-with-nulls as
    # float64 NaN / object (pyarrow to_numpy), so a footer-typed schema
    # would silently disagree with the data. Floating scalars are safe
    # (null -> NaN, dtype unchanged); every other column must PROVE
    # zero nulls via chunk statistics, else the eager path decides.
    import pyarrow as pa
    lax_nulls = {n for n in names
                 if pa.types.is_floating(pf.schema_arrow.field(n).type)}
    rows = 0
    col_bytes = {n: 0 for n in names}
    want = set(names)
    for g in range(row_group_offset, end_group):
        rg = md.row_group(g)
        rows += rg.num_rows
        for j in range(rg.num_columns):
            c = rg.column(j)
            base = c.path_in_schema.split(".", 1)[0]
            if base not in want:
                continue
            col_bytes[base] += int(c.total_uncompressed_size)
            if base not in lax_nulls:
                stats = c.statistics
                if stats is None or stats.null_count is None \
                        or stats.null_count > 0:
                    return None
    if num_partitions is None:
        parts = n_groups
    else:
        parts = len(_split_even(rows, num_partitions))

    def thunk():
        return _read_parquet_eager(path, names, num_partitions, False,
                                   row_group_offset, n_groups).blocks()

    import os as _os
    frame = TensorFrame(
        Schema(fields), thunk, parts,
        plan=f"parquet({_os.path.basename(path)})",
        rows_hint=rows, bytes_hint=sum(col_bytes.values()),
        col_bytes_hint=col_bytes)
    node = ParquetScanNode(path, names, row_group_offset, n_groups,
                           num_partitions, frame.schema, rows, col_bytes)
    node.frame_ref = weakref.ref(frame)
    attach(frame, node)
    return frame


def _read_parquet_eager(path: str, columns: Optional[Sequence[str]],
                        num_partitions: Optional[int], pad_ragged,
                        row_group_offset: int,
                        row_group_limit: Optional[int],
                        pf=None) -> TensorFrame:
    """The materializing read (the pre-plan ``read_parquet`` body): row
    groups decode NOW, the returned frame's blocks already exist.
    ``pf`` reuses a caller's already-open ``ParquetFile`` (one footer
    parse per ``read_parquet`` call)."""
    import contextlib

    import pyarrow.parquet as pq

    with (pq.ParquetFile(path) if pf is None
          else contextlib.nullcontext(pf)) as pf:
        names = list(columns) if columns is not None else [
            c for c in pf.schema_arrow.names]
        blocks: List[dict] = []
        end_group = pf.num_row_groups
        if row_group_limit is not None:
            end_group = min(end_group, row_group_offset + row_group_limit)
        want = set(names)
        for rg in range(row_group_offset, end_group):
            with span("io.parquet_read"):
                tbl = pf.read_row_group(rg, columns=names)
                blocks.append({n: _column_to_numpy(tbl.column(n), n)
                               for n in names})
            # what the scan decoded: row groups, and the footer's
            # uncompressed bytes of the column chunks read
            md = pf.metadata.row_group(rg)
            counters.inc("io.parquet_row_groups_read")
            counters.inc("io.parquet_bytes_read", sum(
                int(md.column(j).total_uncompressed_size)
                for j in range(md.num_columns)
                if md.column(j).path_in_schema.split(".", 1)[0] in want))
        if not blocks:
            # empty file: type the empty columns from the parquet schema,
            # not as float64
            empty = pf.schema_arrow.empty_table()
            blocks = [{n: _column_to_numpy(empty.column(n), n)
                       for n in names}]
    if not names:  # explicit empty selection: an empty frame
        return TensorFrame.from_columns({})
    ragged_names = [n for n in names
                    if any(isinstance(b[n], _RaggedParts) for b in blocks)]
    # which ragged columns pad at load (fused: straight from the arrow
    # buffers); a non-ragged pad request raises below
    if pad_ragged:
        to_pad = list(ragged_names) if pad_ragged is True else [
            n for n in pad_ragged]
    else:
        to_pad = []
    fused_pad = [n for n in to_pad if n in ragged_names]
    if not ragged_names:
        first = TensorFrame.from_columns(blocks[0])
        schema = first.schema
    else:
        # a row group whose lists HAPPEN to share one length decodes
        # dense; rebuild its (values, offsets) form so every block agrees
        for b in blocks:
            for n in ragged_names:
                c = b[n]
                if isinstance(c, np.ndarray):
                    w = c.shape[1] if c.ndim > 1 else 0
                    b[n] = _RaggedParts(
                        np.ascontiguousarray(c).reshape(-1),
                        np.arange(len(c) + 1, dtype=np.int64) * w)
        from . import dtypes as _dt
        from .schema import Field, Schema
        from .shape import Shape, Unknown

        # global pad width per fused column (the JAX pad_column's length
        # scan computes, here from the offsets alone)
        widths = {n: max((int(b[n].lens.max()) if len(b[n]) else 0)
                         for b in blocks) for n in fused_pad}
        fields = []
        for n in names:
            if n in ragged_names:
                # dtype probe over ALL blocks: the first one may hold
                # only empty cells
                probe = next(
                    (b[n].flat for b in blocks if b[n].flat.size),
                    np.empty(0))
                dt = _dt.from_numpy(probe.dtype)
                if n in fused_pad:
                    fields.append(Field(
                        n, dt, block_shape=Shape(Unknown, widths[n]),
                        sql_rank=1))
                else:
                    fields.append(Field(n, dt, sql_rank=1))
            else:
                fields.append(
                    Schema.from_numpy_columns(
                        {n: blocks[0][n]}).fields[0])
        for n in fused_pad:  # mask/len fields append in pad order
            for extra in (f"{n}_mask", f"{n}_len"):
                if extra in names:
                    raise ValueError(f"Column {extra!r} already exists")
            fields.append(Field(f"{n}_mask", _dt.int32,
                                block_shape=Shape(Unknown, widths[n]),
                                sql_rank=1))
            fields.append(Field(f"{n}_len", _dt.int64,
                                block_shape=Shape(Unknown), sql_rank=0))
        schema = Schema(fields)
        for b in blocks:
            for n in names:
                c = b[n]
                if not isinstance(c, _RaggedParts):
                    continue
                if n in fused_pad:
                    dense, mask, lens = c.pad(widths[n],
                                              schema[n].dtype.np_storage)
                    b[n] = dense
                    b[f"{n}_mask"] = mask
                    b[f"{n}_len"] = lens
                else:
                    b[n] = c.cells()
    from .frame import Block

    out_names = schema.names
    fblocks = [Block({n: b[n] for n in out_names},
                     len(b[names[0]])) for b in blocks]
    first = TensorFrame.from_blocks(fblocks, schema)
    if num_partitions is not None:
        merged = Block.concat(first.blocks(), first.schema)
        from .frame import _split_even

        spans = _split_even(merged.num_rows, num_partitions)
        fblocks = [Block({n: merged.columns[n][a:b] for n in out_names},
                         b - a) for a, b in spans]
        first = TensorFrame.from_blocks(fblocks, schema)
    for n in to_pad:
        if n not in fused_pad:  # non-ragged pad request: pad_column path
            first = first.pad_column(n)
    return first


def _frame_block_to_table(b, schema):
    """One frame Block -> a pyarrow Table (shared by :func:`write_parquet`
    and the streaming ``ParquetSink`` appender)."""
    import pyarrow as pa

    arrays = {}
    for name in schema.names:
        if b.is_ragged(name):
            # ragged 1-d cells -> a variable-length list column
            cells = b.columns[name]
            if any(np.asarray(c).ndim != 1 for c in cells):
                raise ValueError(
                    f"column {name!r}: only 1-d ragged cells map "
                    f"to parquet lists")
            arrays[name] = pa.array(
                [np.asarray(c).tolist() for c in cells])
            continue
        a = b.dense(name)
        if a.ndim == 1:
            arrays[name] = pa.array(a.tolist() if a.dtype == object
                                    else a)
        elif a.ndim == 2:
            arrays[name] = pa.FixedSizeListArray.from_arrays(
                pa.array(a.reshape(-1)), a.shape[1])
        else:
            raise ValueError(
                f"column {name!r}: rank-{a.ndim} cells do not map "
                f"to parquet; flatten first")
    return pa.table(arrays)


def write_parquet(df: TensorFrame, path: str) -> None:
    """Write a TensorFrame to parquet, partitions → row groups."""
    import pyarrow.parquet as pq

    writer = None
    try:
        for b in df.blocks():
            tbl = _frame_block_to_table(b, df.schema)
            if writer is None:
                writer = pq.ParquetWriter(path, tbl.schema)
            writer.write_table(tbl)
    finally:
        if writer is not None:
            writer.close()


def from_pandas(pdf, num_partitions: int = 1) -> TensorFrame:
    """pandas DataFrame → TensorFrame (object/string dtypes pass through)."""
    cols = {}
    for name in pdf.columns:
        s = pdf[name]
        a = s.to_numpy()
        if a.dtype.kind in ("U", "S") or (
                a.dtype == object and len(a) and isinstance(a[0], str)):
            a = np.asarray(a, dtype=object)
        cols[str(name)] = a
    return TensorFrame.from_columns(cols, num_partitions=num_partitions)


def to_pandas(df: TensorFrame):
    """TensorFrame → pandas DataFrame (vector cells become object lists)."""
    import pandas as pd

    from .frame import Block

    merged = Block.concat(df.blocks(), df.schema)
    data = {}
    for name in df.schema.names:
        a = merged.dense(name)
        data[name] = list(a) if a.ndim > 1 else a
    return pd.DataFrame(data)


def read_npz(path: str, num_partitions: int = 1) -> TensorFrame:
    """Load a ``.npz`` archive as one column per entry."""
    with np.load(path, allow_pickle=False) as z:
        cols = {k: z[k] for k in z.files}
    return TensorFrame.from_columns(cols, num_partitions=num_partitions)


def write_npz(df: TensorFrame, path: str) -> None:
    from .frame import Block

    merged = Block.concat(df.blocks(), df.schema)
    cols = {}
    for n in df.schema.names:
        a = merged.dense(n)
        if a.dtype == object:
            raise ValueError(
                f"column {n!r}: string/object columns do not round-trip "
                f"through npz; use write_parquet, or select() them away")
        cols[n] = a
    # write through an open handle so np.savez cannot silently append
    # '.npz' and land at a different path than requested
    with open(path, "wb") as fh:
        np.savez(fh, **cols)


def read_csv(path: str, num_partitions: int = 1,
             columns: Optional[Sequence[str]] = None,
             dtypes: Optional[dict] = None) -> TensorFrame:
    """Load a CSV (header row required) as a TensorFrame.

    Parsing rides pandas; dtypes map through the same policy as
    :func:`from_pandas` — float/int/bool columns become tensor columns,
    everything else (strings) becomes object pass-through columns.
    ``dtypes`` (column -> numpy dtype) pins parse dtypes, e.g.
    ``{"key": "int32"}``.
    """
    import pandas as pd

    pdf = pd.read_csv(
        path, usecols=list(columns) if columns is not None else None,
        dtype=dtypes)
    if columns is not None:
        pdf = pdf[list(columns)]  # usecols returns file order; honor ours
    return from_pandas(pdf, num_partitions=num_partitions)


def write_csv(df: TensorFrame, path: str) -> None:
    """Write a frame of scalar columns as CSV (vector cells are rejected:
    CSV has no faithful encoding for them — use parquet)."""
    for f in df.schema:
        if f.sql_rank != 0:
            raise ValueError(
                f"column {f.name!r} holds rank-{f.sql_rank} cells; CSV "
                f"cannot represent tensor cells — use write_parquet")
    to_pandas(df).to_csv(path, index=False)
