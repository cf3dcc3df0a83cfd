"""Helpers the tests/test_torch_*.py files share: hand a JAX-package frame
to the PyTorch port block for block, and compare the two packages' frames.
"""

import numpy as np

from tensorframes_tpu_torch.interop import frame_from_numpy_blocks


def to_port(jframe):
    """The port's frame with ``jframe``'s blocks and schema."""
    fields = [(f.name, f.dtype.name,
               None if f.block_shape is None else f.block_shape.dims)
              for f in jframe.schema]
    return frame_from_numpy_blocks([b.columns for b in jframe.blocks()],
                                   fields)


def schema_tuple(schema):
    return [(f.name, f.dtype.name,
             None if f.block_shape is None else tuple(f.block_shape.dims),
             f.sql_rank) for f in schema]


def assert_columns_close(jcol, tcol, rtol=0.0, atol=0.0):
    if isinstance(jcol, np.ndarray):
        assert isinstance(tcol, np.ndarray), type(tcol)
        assert tcol.shape == jcol.shape
        assert tcol.dtype == jcol.dtype, (tcol.dtype, jcol.dtype)
        if (rtol == 0.0 and atol == 0.0) or jcol.dtype == object:
            np.testing.assert_array_equal(tcol, jcol)
        else:
            np.testing.assert_allclose(tcol, jcol, rtol=rtol, atol=atol)
        return
    assert not isinstance(tcol, np.ndarray), "port column is dense"
    assert len(tcol) == len(jcol)
    for a, b in zip(jcol, tcol):
        assert_columns_close(np.asarray(a), np.asarray(b), rtol, atol)


def assert_frames_match(jframe, tframe, rtol=0.0, atol=0.0):
    """Same schema, column order, block boundaries, row order and values
    (exact unless a tolerance is given)."""
    assert schema_tuple(tframe.schema) == schema_tuple(jframe.schema)
    jb, tb = jframe.blocks(), tframe.blocks()
    assert [b.num_rows for b in tb] == [b.num_rows for b in jb]
    for a, b in zip(jb, tb):
        assert list(b.columns) == list(a.columns)
        for name in a.columns:
            assert_columns_close(a.columns[name], b.columns[name], rtol, atol)
