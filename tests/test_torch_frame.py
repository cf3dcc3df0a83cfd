"""The port's data model against the JAX package's: frames built from rows,
columns and blocks, ``analyze``, ``print_schema``/``explain`` text,
``collect()`` rows and ``Row`` access, ragged vector columns included.
The data model is host-side numpy in both packages, so everything here is
exact.
"""

import numpy as np
import pytest

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from torch_parity import assert_frames_match, schema_tuple, to_port


def _rows_equal(jrows, trows):
    assert len(trows) == len(jrows)
    for a, b in zip(jrows, trows):
        assert b.fields == a.fields
        assert b.as_dict().keys() == a.as_dict().keys()
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                assert isinstance(y, np.ndarray)
                np.testing.assert_array_equal(y, x)
                assert y.dtype == x.dtype
            else:
                assert type(y) is type(x) and y == x


def _both(build):
    return build(jtf), build(ttf)


ROWS = [(1.0, 2, [1.0, 2.0]), (3.5, -4, [3.0, 4.0]), (5.25, 6, [5.0, 6.0]),
        (7.0, 8, [7.0, 8.0]), (9.0, 10, [9.0, 10.0])]
RAGGED = [(1, [1.0]), (2, [2.0, 3.0]), (3, []), (4, [4.0, 5.0, 6.0]),
          (5, [7.0])]


@pytest.mark.parametrize("parts", [1, 2, 3, 7])
def test_frame_from_rows(parts):
    j, t = _both(lambda m: m.frame(ROWS, columns=["x", "n", "v"],
                                   num_partitions=parts))
    assert t.num_partitions == j.num_partitions
    assert_frames_match(j, t)
    _rows_equal(j.collect(), t.collect())
    assert t.count() == j.count()


@pytest.mark.parametrize("parts", [1, 4])
def test_frame_from_columns(rng, parts):
    cols = {"x": rng.standard_normal(11), "k": rng.integers(0, 3, 11),
            "f": rng.standard_normal(11).astype(np.float32),
            "i": rng.integers(0, 9, 11).astype(np.int32),
            "m": rng.standard_normal((11, 2, 3)),
            "s": np.array([f"r{i}" for i in range(11)], dtype=object)}
    j, t = _both(lambda m: m.frame(cols, num_partitions=parts))
    assert_frames_match(j, t)
    _rows_equal(j.collect(), t.collect())


def test_frame_from_blocks_with_empty_partition():
    def build(m):
        s = m.Schema.of(x="double")
        blocks = [m.Block({"x": np.array([1.0, 2.0])}),
                  m.Block({"x": np.empty((0,))}, 0),
                  m.Block({"x": np.array([3.0])})]
        return m.TensorFrame.from_blocks(blocks, s)

    j, t = _both(build)
    assert_frames_match(j, t)
    _rows_equal(j.collect(), t.collect())


def test_interop_hands_over_blocks_and_schema(rng):
    j = jtf.frame({"x": rng.standard_normal(9),
                   "v": rng.standard_normal((9, 4))}, num_partitions=3)
    t = to_port(j)
    assert_frames_match(j, t)


def test_ragged_column_rows_and_analyze():
    j, t = _both(lambda m: m.frame(RAGGED, columns=["k", "v"],
                                   num_partitions=2))
    assert_frames_match(j, t)
    _rows_equal(j.collect(), t.collect())
    ja, ta = jtf.analyze(j), ttf.analyze(t)
    assert schema_tuple(ta.schema) == schema_tuple(ja.schema)


@pytest.mark.parametrize("parts", [1, 2, 5])
def test_analyze_dense_columns(parts):
    j, t = _both(lambda m: m.analyze(m.frame(
        ROWS, columns=["x", "n", "v"], num_partitions=parts)))
    assert schema_tuple(t.schema) == schema_tuple(j.schema)


def test_print_schema_and_explain_text(capsys):
    j, t = _both(lambda m: m.analyze(m.frame(ROWS, columns=["x", "n", "v"],
                                             num_partitions=2)))
    jtf.print_schema(j)
    jout = capsys.readouterr().out
    ttf.print_schema(t)
    assert capsys.readouterr().out == jout
    assert ttf.explain(t) == jtf.explain(j)
    assert t.explain_tensors() == j.explain_tensors()


def test_row_access_and_errors():
    j, t = _both(lambda m: m.frame(ROWS, columns=["x", "n", "v"]))
    jr, tr = j.first(), t.first()
    assert tr["x"] == jr["x"] and tr[1] == jr[1]
    assert repr(tr) == repr(jr)
    with pytest.raises(KeyError):
        tr["nope"]
    with pytest.raises(KeyError):
        t.group_by("nope")


def test_select_cache_limit_repartition():
    j, t = _both(lambda m: m.frame(ROWS, columns=["x", "n", "v"],
                                   num_partitions=3))
    assert_frames_match(j.select(["v", "x"]), t.select(["v", "x"]))
    assert_frames_match(j.limit(4), t.limit(4))
    assert_frames_match(j.repartition(2), t.repartition(2))
    assert t.cache() is t and t._cache is not None


def test_block_ragged_dense_access_raises_same():
    jb = jtf.Block({"v": [np.ones(2), np.ones(3)]})
    tb = ttf.Block({"v": [np.ones(2), np.ones(3)]})
    with pytest.raises(ValueError) as je:
        jb.dense("v")
    with pytest.raises(ValueError) as te:
        tb.dense("v")
    assert str(te.value) == str(je.value)


def test_schema_inference_errors_match():
    for m in (jtf, ttf):
        with pytest.raises(ValueError, match="zero rows"):
            m.frame([], columns=["x"])
        with pytest.raises(ValueError, match="disagree on row count"):
            m.frame({"a": np.arange(2), "b": np.arange(3)})


# ---------------------------------------------------------------------------
# order_by, limit, sample, show (tests/test_frame.py) and pad_column
# (tests/test_pad_column.py): host-side in both packages, so exact
# ---------------------------------------------------------------------------

class TestOrderBy:
    def test_single_key(self):
        j, t = _both(lambda m: m.frame({"x": np.array([3.0, 1.0, 2.0]),
                                        "y": np.array([30.0, 10.0, 20.0])},
                                       num_partitions=2).order_by("x"))
        assert [(r["x"], r["y"]) for r in t.collect()] == [
            (1.0, 10.0), (2.0, 20.0), (3.0, 30.0)]
        assert_frames_match(j, t)

    def test_multi_key_and_stability(self):
        cols = {"k": np.array([1, 0, 1, 0, 1], np.int64),
                "x": np.array([5.0, 4.0, 3.0, 2.0, 1.0])}
        j, t = _both(lambda m: m.frame(cols).order_by("k", "x"))
        assert [(r["k"], r["x"]) for r in t.collect()] == [
            (0, 2.0), (0, 4.0), (1, 1.0), (1, 3.0), (1, 5.0)]
        assert_frames_match(j, t)

    def test_descending_stable_with_strings(self):
        cols = {"k": np.array(["b", "a", "b", "a"], object),
                "tag": np.array([0.0, 1.0, 2.0, 3.0])}
        j, t = _both(lambda m: m.frame(cols).order_by("k", descending=True))
        # primary: b before a; ties keep original order (stable)
        assert [(r["k"], r["tag"]) for r in t.collect()] == [
            ("b", 0.0), ("b", 2.0), ("a", 1.0), ("a", 3.0)]
        assert_frames_match(j, t)

    def test_vector_columns_follow(self):
        j, t = _both(lambda m: m.analyze(m.frame(
            {"x": np.array([2.0, 1.0]),
             "v": np.array([[2., 2.], [1., 1.]])})).order_by("x"))
        np.testing.assert_array_equal(t.collect()[0]["v"], [1.0, 1.0])
        assert_frames_match(j, t)

    def test_descending_float_nan_stays_last(self):
        j, t = _both(lambda m: m.frame(
            {"x": np.array([3.0, np.nan, 1.0, 2.0])}).order_by(
            "x", descending=True))
        got = [r["x"] for r in t.collect()]
        assert got[:3] == [3.0, 2.0, 1.0]
        assert np.isnan(got[3])
        assert_frames_match(j, t)

    def test_validation(self):
        for m in (jtf, ttf):
            df = m.analyze(m.frame({"v": np.ones((3, 2))}))
            with pytest.raises(ValueError, match="scalar column"):
                df.order_by("v")
            with pytest.raises(KeyError, match="No column"):
                df.order_by("nope")
            with pytest.raises(ValueError, match="at least one"):
                df.order_by()

    @pytest.mark.parametrize("parts,out_parts", [(3, None), (4, 2), (2, 5)])
    def test_repartitions_like_the_jax_package(self, rng, parts, out_parts):
        cols = {"k": rng.integers(0, 5, 40), "x": rng.standard_normal(40),
                "s": np.array([f"r{i}" for i in range(40)], object),
                "r": [np.arange(i % 3, dtype=np.float64) for i in range(40)]}
        j, t = _both(lambda m: m.frame(
            [tuple(c[i] for c in cols.values()) for i in range(40)],
            columns=list(cols), num_partitions=parts).order_by(
            "k", "x", descending=True, num_partitions=out_parts))
        assert t.num_partitions == j.num_partitions
        assert_frames_match(j, t)


class TestLimitSampleShow:
    def _df(self, m, n=10, parts=3):
        return m.frame({"x": np.arange(float(n))}, num_partitions=parts)

    def test_limit(self):
        j, t = _both(self._df)
        assert [r["x"] for r in t.limit(4).collect()] == [0.0, 1.0, 2.0, 3.0]
        assert t.limit(0).collect() == []
        assert t.limit(100).count() == 10
        with pytest.raises(ValueError, match=">= 0"):
            t.limit(-1)
        for n in (0, 4, 100):
            assert_frames_match(j.limit(n), t.limit(n))
            assert t.limit(n).estimated_rows() == j.limit(n).estimated_rows()

    def test_limit_preserves_string_columns(self):
        j, t = _both(lambda m: m.frame({"k": np.array(["a", "b", "c"], object),
                                        "x": np.arange(3.0)}).limit(2))
        assert [(r["k"], r["x"]) for r in t.collect()] == [("a", 0.0),
                                                          ("b", 1.0)]
        assert_frames_match(j, t)

    def test_sample_deterministic_and_bounds(self):
        j, t = _both(lambda m: self._df(m, 1000, parts=4))
        s1 = t.sample(0.3, seed=7).collect()
        s2 = t.sample(0.3, seed=7).collect()
        assert [r["x"] for r in s1] == [r["x"] for r in s2]
        assert 200 < len(s1) < 400          # ~300, loose bounds
        assert t.sample(0.0).count() == 0
        assert t.sample(1.0).count() == 1000
        with pytest.raises(ValueError, match="not in"):
            t.sample(1.5)
        # the same seed keeps the same rows in both packages
        assert_frames_match(j.sample(0.3, seed=7), t.sample(0.3, seed=7))
        assert t.sample(0.3).estimated_rows() == \
            j.sample(0.3).estimated_rows()

    def test_show_prints_table(self, capsys):
        outs = []
        for m in (jtf, ttf):
            df = m.analyze(m.frame({"x": np.arange(3.0),
                                    "v": np.ones((3, 6))}))
            df.show(2)
            outs.append(capsys.readouterr().out)
        out = outs[1]
        assert "| x" in out and "| v" in out
        assert "..." in out          # long vector cells elide
        assert out.count("\n") >= 6  # frame lines + 2 rows
        assert outs[1] == outs[0]


def _ragged_rows():
    return [(np.arange(i + 1, dtype=np.float64),) for i in range(7)]


class TestPadColumn:
    def test_pad_column_shapes_and_mask(self):
        j, t = _both(lambda m: m.frame(_ragged_rows(), columns=["v"],
                                       num_partitions=2).pad_column("v"))
        assert t.columns == ["v", "v_mask", "v_len"]
        rows = t.collect()
        assert len(rows) == 7
        for i, r in enumerate(rows):
            assert r["v"].shape == (7,)
            np.testing.assert_array_equal(r["v"][: i + 1], np.arange(i + 1))
            assert (r["v"][i + 1:] == 0).all()
            np.testing.assert_array_equal(
                r["v_mask"], (np.arange(7) < i + 1).astype(np.int32))
            assert r["v_len"] == i + 1
        assert_frames_match(j, t)

    def test_pad_column_pow2_and_block_op(self):
        j, t = _both(lambda m: m.frame(_ragged_rows(), columns=["v"],
                                       num_partitions=2).pad_column(
            "v", pow2=True))
        assert t.collect()[0]["v"].shape == (8,)  # 7 -> 8
        assert_frames_match(j, t)
        # the padded frame is block-op capable: masked per-row mean
        prev = ttf.default_device()
        ttf.set_default_device("cpu")
        try:
            out = t.map_blocks(lambda v, v_mask, v_len: {
                "mean": (v * v_mask).sum(axis=1) / v_len})
            for i, r in enumerate(out.collect()):
                assert r["mean"] == pytest.approx(np.arange(i + 1).mean())
        finally:
            ttf.set_default_device(prev)

    def test_pad_column_rejects_collision_and_rank(self):
        for m in (jtf, ttf):
            df = m.frame(_ragged_rows(), columns=["v"], num_partitions=2)
            with pytest.raises(ValueError, match="already exists"):
                df.pad_column("v", mask_col="v")
            with pytest.raises(KeyError, match="No column"):
                df.pad_column("nope")
            dense = m.frame({"m": np.zeros((3, 2, 2))})
            with pytest.raises(ValueError, match="1-d cells"):
                dense.pad_column("m")

    def test_pad_column_explicit_max_len_overflow(self):
        for m in (jtf, ttf):
            df = m.frame(_ragged_rows(), columns=["v"], num_partitions=2)
            with pytest.raises(ValueError):
                df.pad_column("v", max_len=3).blocks()

    def test_pad_column_named_columns_and_empty_cells(self):
        j, t = _both(lambda m: m.frame(
            [(np.arange(i % 3, dtype=np.float32), i) for i in range(2)],
            columns=["v", "n"], num_partitions=3).pad_column(
            "v", max_len=4, mask_col="m", len_col="l"))
        assert t.columns == ["v", "n", "m", "l"]
        assert_frames_match(j, t)
