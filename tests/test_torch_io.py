"""The port's columnar IO against the JAX package's (``tests/test_io.py``).

The same files, written from a numpy seed, are read by both packages; the
frames must agree in schema, block boundaries, row order and values
(exactly: IO does no arithmetic). The lazy parquet scan must agree with
its own eager decode and with the JAX package's, and decode only the
columns asked for.
"""

import numpy as np
import pytest

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import io as jio
from tensorframes_tpu_torch import io as tio
from torch_parity import assert_frames_match, schema_tuple, to_port


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("TFT_ADAPTIVE", "0")
    monkeypatch.setenv("TFT_RESULT_CACHE", "0")
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    yield
    ttf.set_default_device(prev)


def _mixed_cols(n=100):
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal(n),
            "i": rng.integers(0, 50, n),
            "v": rng.standard_normal((n, 4)),
            "key": np.asarray([str(i % 7) for i in range(n)], object)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parquet_round_trip_scalar_vector_string(tmp_path, writer):
    p = str(tmp_path / "t.parquet")
    j = jtf.frame(_mixed_cols(), num_partitions=3)
    if writer == "jax":
        jio.write_parquet(j, p)
    else:
        tio.write_parquet(to_port(j), p)
    back, jback = tio.read_parquet(p), jio.read_parquet(p)
    assert back._cache is None and back._plan_node is not None  # lazy
    assert back.count() == 100
    assert_frames_match(jback, back)
    assert_frames_match(j, back)


@pytest.fixture
def wide_file(tmp_path):
    p = str(tmp_path / "wide.parquet")
    n = 60
    cols = {"a": np.arange(float(n)),
            "b": np.arange(n).astype(np.int64),
            "c": np.ones((n, 2)),
            "d": np.asarray([f"s{i}" for i in range(n)], object)}
    jio.write_parquet(jtf.frame(cols, num_partitions=3), p)
    return p, cols, n


def test_projection_reads_only_requested(wide_file, monkeypatch):
    p, cols, n = wide_file
    decoded = []
    real = tio._column_to_numpy
    monkeypatch.setattr(tio, "_column_to_numpy",
                        lambda col, name: decoded.append(name)
                        or real(col, name))
    back = tio.read_parquet(p, columns=["a", "d"])
    assert back.schema.names == ["a", "d"]
    assert back.count() == n
    assert set(decoded) == {"a", "d"}
    assert_frames_match(jio.read_parquet(p, columns=["a", "d"]), back)


def test_projection_composes_with_row_groups(wide_file):
    p, cols, _ = wide_file
    part = tio.read_parquet(p, columns=["b"], row_group_offset=1,
                            row_group_limit=1)
    got = np.concatenate([blk.columns["b"] for blk in part.blocks()])
    assert np.array_equal(got, cols["b"][20:40])  # group 1: rows 20..39
    assert part.schema.names == ["b"]
    assert_frames_match(jio.read_parquet(p, columns=["b"],
                                         row_group_offset=1,
                                         row_group_limit=1), part)


def test_offset_past_the_end_is_a_typed_empty_frame(wide_file):
    p, _, _ = wide_file
    back = tio.read_parquet(p, row_group_offset=7)
    jback = jio.read_parquet(p, row_group_offset=7)
    assert back.count() == 0
    assert_frames_match(jback, back)


@pytest.mark.parametrize("kw,match", [
    ({"columns": ["a", "nope"]}, "nope"),
    ({"row_group_offset": -1}, "row_group_offset"),
    ({"row_group_limit": 0}, "row_group_limit"),
])
def test_bad_arguments_rejected(wide_file, kw, match):
    p, _, _ = wide_file
    with pytest.raises(ValueError, match=match):
        jio.read_parquet(p, **kw)
    with pytest.raises(ValueError, match=match):
        tio.read_parquet(p, **kw)


def test_lazy_schema_matches_eager_decode(wide_file):
    p, _, _ = wide_file
    lazy = tio.read_parquet(p)
    pre = lazy.schema  # footer-derived, nothing read yet
    assert lazy._cache is None
    eager = tio._read_parquet_eager(p, None, None, False, 0, None)
    assert pre == eager.schema
    assert lazy.num_partitions == eager.num_partitions
    assert schema_tuple(pre) == schema_tuple(jio.read_parquet(p).schema)


def test_nullable_int_column_falls_back_to_eager(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    p = str(tmp_path / "nulls.parquet")
    pq.write_table(pa.table({"i": pa.array([1, None, 3], pa.int64()),
                             "f": pa.array([1.0, 2.0, 3.0])}), p)
    back = tio.read_parquet(p)
    assert back._plan_node is None  # eager
    blk = back.blocks()[0]
    assert blk.columns["i"].dtype == np.float64
    assert back.schema["i"].dtype.name == "double"
    assert np.isnan(blk.columns["i"][1])
    assert schema_tuple(back.schema) == \
        schema_tuple(jio.read_parquet(p).schema)


def test_float_nulls_stay_lazy_and_decode_nan(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    p = str(tmp_path / "fnull.parquet")
    pq.write_table(pa.table({"f": pa.array([1.0, None, 3.0])}), p)
    back = tio.read_parquet(p)
    assert back._plan_node is not None
    assert np.isnan(back.blocks()[0].columns["f"][1])


def test_lazy_rows_bytes_hints_from_footer(wide_file):
    p, _, n = wide_file
    lazy, jlazy = tio.read_parquet(p, columns=["a"]), \
        jio.read_parquet(p, columns=["a"])
    assert lazy._cache is None
    assert lazy.estimated_rows() == jlazy.estimated_rows() == n
    assert lazy.estimated_bytes() == jlazy.estimated_bytes() > 0


def test_parquet_row_groups_become_partitions(tmp_path):
    p = str(tmp_path / "t.parquet")
    tio.write_parquet(ttf.frame({"x": np.arange(30.0)}, num_partitions=3), p)
    assert tio.read_parquet(p).num_partitions == 3  # one per row group
    back2 = tio.read_parquet(p, num_partitions=5)
    assert back2.num_partitions == 5
    assert_frames_match(jio.read_parquet(p, num_partitions=5), back2)


def test_parquet_feeds_engine(tmp_path):
    p = str(tmp_path / "t.parquet")
    tio.write_parquet(ttf.frame({"x": np.arange(10.0)}), p)
    out = ttf.map_blocks(lambda x: {"z": x + 3.0}, ttf.read_parquet(p))
    assert [r["z"] for r in out.collect()] == [i + 3.0 for i in range(10)]


def test_pandas_round_trip():
    import pandas as pd
    pdf = pd.DataFrame({"x": np.arange(5.0), "k": [str(i) for i in range(5)]})
    df = ttf.from_pandas(pdf, num_partitions=2)
    assert_frames_match(jio.from_pandas(pdf, num_partitions=2), df)
    out = ttf.to_pandas(ttf.map_blocks(lambda x: {"z": x * 2}, df))
    assert list(out.columns) == ["x", "k", "z"]
    np.testing.assert_allclose(out["z"], np.arange(5.0) * 2)


def test_npz_round_trip(tmp_path):
    p = str(tmp_path / "t.npz")
    df = ttf.frame({"x": np.arange(8.0),
                    "v": np.arange(16.0).reshape(8, 2)})
    ttf.write_npz(df, p)
    back = ttf.read_npz(p, num_partitions=2)
    assert_frames_match(jio.read_npz(p, num_partitions=2), back)
    with pytest.raises(ValueError, match="npz"):
        ttf.write_npz(ttf.frame({"s": np.array(["a"], object)}),
                      str(tmp_path / "s.npz"))


def test_csv_round_trip_and_columns(tmp_path):
    p = str(tmp_path / "t.csv")
    df = ttf.frame({"name": np.array(["a", "b", "c"], object),
                    "x": np.array([1.5, 2.5, 3.5]),
                    "n": np.array([1, 2, 3], np.int64)})
    ttf.write_csv(df, p)
    back = ttf.read_csv(p, num_partitions=2)
    assert [(r["name"], r["x"], r["n"]) for r in back.collect()] == [
        ("a", 1.5, 1), ("b", 2.5, 2), ("c", 3.5, 3)]
    assert_frames_match(jio.read_csv(p, num_partitions=2), back)
    assert ttf.read_csv(p, columns=["x"]).schema.names == ["x"]
    assert ttf.read_csv(p, columns=[]).schema.names == []


def test_csv_rejects_vector_cells(tmp_path):
    df = ttf.analyze(ttf.frame({"v": np.ones((2, 3))}))
    with pytest.raises(ValueError, match="CSV cannot represent"):
        ttf.write_csv(df, str(tmp_path / "t.csv"))


# ---------------------------------------------------------------------------
# ragged (variable-length list) columns
# ---------------------------------------------------------------------------

def _write_ragged(tmp_path):
    df = jtf.frame(
        [(np.arange(i + 1, dtype=np.float64), float(i)) for i in range(6)],
        columns=["v", "x"], num_partitions=2)
    p = str(tmp_path / "ragged.parquet")
    jio.write_parquet(df, p)
    return p


@pytest.mark.parametrize("kw", [{}, {"num_partitions": 3},
                                {"pad_ragged": True},
                                {"pad_ragged": ["v"]}], ids=str)
def test_ragged_parquet_matches_jax(tmp_path, kw):
    p = _write_ragged(tmp_path)
    back = tio.read_parquet(p, **kw)
    assert back._plan_node is None  # ragged files take the eager decode
    assert_frames_match(jio.read_parquet(p, **kw), back)


def test_ragged_feeds_map_rows(tmp_path):
    p = _write_ragged(tmp_path)
    df = ttf.analyze(tio.read_parquet(p))
    out = ttf.map_rows(lambda v: {"s": v.sum()}, df.select(["v"]))
    assert [r["s"] for r in out.collect()] == [
        float(np.arange(i + 1).sum()) for i in range(6)]


def test_pad_ragged_then_map_blocks(tmp_path):
    p = _write_ragged(tmp_path)
    df = tio.read_parquet(p, pad_ragged=True)
    assert set(df.columns) >= {"v", "v_mask", "v_len"}
    out = ttf.map_blocks(
        lambda v, v_mask: {"s": (v * v_mask).sum(axis=1)}, df)
    assert [r["s"] for r in out.collect()] == [
        float(np.arange(i + 1).sum()) for i in range(6)]


def test_fused_pad_matches_pad_column(tmp_path):
    # read_parquet(pad_ragged=True) pads straight from the arrow offsets
    # and values; it must be indistinguishable from loading the ragged
    # cells and then pad_column, and both equal the JAX package's
    p = _write_ragged(tmp_path)
    fused = tio.read_parquet(p, pad_ragged=True)
    stepwise = tio.read_parquet(p).pad_column("v")
    assert schema_tuple(fused.schema) == schema_tuple(stepwise.schema)
    assert_frames_match(jio.read_parquet(p).pad_column("v"), stepwise)
    fr, sr = fused.collect(), stepwise.collect()
    assert len(fr) == len(sr)
    for a, b in zip(fr, sr):
        for c in fused.schema.names:
            np.testing.assert_array_equal(a[c], b[c])


def test_pad_of_a_dense_column_goes_through_pad_column(tmp_path):
    # a named column that is not ragged pads through pad_column, whose
    # 1-d cell rule rejects a scalar column in both packages
    p = _write_ragged(tmp_path)
    for io in (jio, tio):
        with pytest.raises(ValueError, match="1-d cells"):
            io.read_parquet(p, pad_ragged=["x"])


def test_fused_pad_empty_and_uniform_cells(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    p = str(tmp_path / "mixed.parquet")
    t1 = pa.table({"v": pa.array([[1.0, 2.0, 3.0], [], [4.0]])})
    t2 = pa.table({"v": pa.array([[5.0, 6.0], [7.0, 8.0]])})
    with pq.ParquetWriter(p, t1.schema) as writer:
        writer.write_table(t1)
        writer.write_table(t2)
    df = tio.read_parquet(p, pad_ragged=True)
    rows = df.collect()
    assert [r["v_len"] for r in rows] == [3, 0, 1, 2, 2]
    np.testing.assert_array_equal(rows[3]["v"], [5.0, 6.0, 0.0])
    assert_frames_match(jio.read_parquet(p, pad_ragged=True), df)
