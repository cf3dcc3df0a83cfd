"""The port's relational layer against the JAX package's
(``tests/test_relational.py``): broadcast and sort-merge joins, the sketch
combiners of ``aggregate``, and a star-schema chain (SSB Q2.1 and its
roll-up) fused over three joins.

The same seeded numpy inputs go through both packages. Joins must agree
EXACTLY: values, dtypes, schema, row order and block boundaries (joins
only move values). HLL and quantile states are bit-identical (host hashing
in uint64, integer folds), on the host fold (under 4,096 rows) and on the
device fold (the CPU executor here). Top-k is compared exactly only where
both packages fold the same blocks in the same order, and otherwise by its
guarantee. A float ``sum`` beside a sketch is held to rtol 1e-12 (the two
packages' segment sums add in different orders); the star-schema revenue is
integral, so its sums are exact in any order and compared for equality.

Under a device budget (``TestChunkedBuild``) a build table over the
ledger's resident threshold is probed in chunks and any other is a
spillable ledger entry; both packages are held to the same rows and the
same ``relational.build_chunks`` / ``memory.*`` counters.

Not mirrored here yet: the ``mesh8`` cases (mesh sort-merge, device loss,
external sort, partitioned joins, ``daggregate`` sketches, hot keys of a
salted ``daggregate``) wait for the parallel layer (ROADMAP A10); the
stream join and the stream sketch fold for the stream layer (A9).
"""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke
import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from chip_smoke import ssb_reference, ssb_tables
from tensorframes_tpu import relational as jrel
from tensorframes_tpu.engine.ops import (InputNotFoundError as JInputNotFound,
                                         InvalidTypeError as JInvalidType)
from tensorframes_tpu.relational import sketch as jsketch
from tensorframes_tpu_torch import relational as trel
from tensorframes_tpu_torch.engine.ops import (InputNotFoundError,
                                               InvalidTypeError)
from tensorframes_tpu_torch.relational import sketch as tsketch
from tensorframes_tpu_torch.utils.tracing import counters
from torch_parity import assert_frames_match, schema_tuple

# ``relational.join`` is the function; the modules by name
jjoin = importlib.import_module("tensorframes_tpu.relational.join")
tjoin = importlib.import_module("tensorframes_tpu_torch.relational.join")

RTOL_SUM = 1e-12


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    import jax
    if not hasattr(jax.core, "Literal"):
        from jax.extend import core as jax_extend_core
        monkeypatch.setattr(jax.core, "Literal", jax_extend_core.Literal,
                            raising=False)
    monkeypatch.setenv("TFT_ADAPTIVE", "0")
    monkeypatch.setenv("TFT_RESULT_CACHE", "0")
    monkeypatch.delenv("TFT_FUSE", raising=False)
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    yield
    ttf.set_default_device(prev)


def _both(build):
    """``build(package, relational)`` for the JAX package and the port."""
    return build(jtf, jrel), build(ttf, trel)


# ---------------------------------------------------------------------------
# the host oracle (plain python dicts), as in tests/test_relational.py
# ---------------------------------------------------------------------------

def oracle_join(left_rows, right_rows, left_names, right_names, on,
                how, right_fields, indicator=None):
    """Reference join: probe order preserved, matches in build-row
    order, left-join fill = NaN/0/'' by dtype kind."""
    on = [on] if isinstance(on, str) else list(on)
    l_on = [left_names.index(k) for k in on]
    r_on = [right_names.index(k) for k in on]
    r_val_idx = [i for i, n in enumerate(right_names) if n not in on]
    table = {}
    for r in right_rows:
        table.setdefault(tuple(r[i] for i in r_on), []).append(
            tuple(r[i] for i in r_val_idx))
    fills = []
    for i in r_val_idx:
        kind = np.dtype(right_fields[i].dtype.np_storage).kind
        fills.append(np.nan if kind == "f" else
                     (False if kind == "b" else
                      (0 if kind in "iu" else "")))
    out = []
    for row in left_rows:
        key = tuple(row[i] for i in l_on)
        matches = table.get(key, [])
        if matches:
            for m in matches:
                out.append(tuple(row) + m + ((1,) if indicator else ()))
        elif how == "left":
            out.append(tuple(row) + tuple(fills)
                       + ((0,) if indicator else ()))
    return out


def _rows(df):
    return [tuple(r) for r in df.collect()]


def _eq(a, b):
    """Tuple-row equality with NaN == NaN (the left-join fill)."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float) \
                    and np.isnan(x) and np.isnan(y):
                continue
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                if not np.array_equal(np.asarray(x), np.asarray(y),
                                      equal_nan=np.asarray(x).dtype.kind
                                      == "f"):
                    return False
                continue
            if x != y:
                return False
    return True


def _left_cols():
    return {"k": np.array([1, 2, 3, 4, 2, 9, 5, 2], np.int64),
            "v": np.array([10., 20., 30., 40., 21., 90., 50., 22.]),
            "tag": np.array(list("abcdefgh"), object)}


def _right_unique_cols():
    return {"k": np.array([2, 3, 5], np.int64),
            "w": np.array([200., 300., 500.]),
            "name": np.array(["two", "three", "five"], object)}


def _right_dup_cols():
    return {"k": np.array([2, 2, 3, 7], np.int64),
            "w": np.array([200., 201., 300., 700.]),
            "name": np.array(["two", "two'", "three", "seven"], object)}


def _oracle_for(left, right, on, how, indicator=None):
    return oracle_join(_rows(left), _rows(right), left.schema.names,
                       right.schema.names, on, how, list(right.schema),
                       indicator=indicator)


def _join_both(left_cols, right_cols, how="inner", parts=3,
               right_parts=1, strategy="broadcast", on="k", **kw):
    """The same join through both packages; returns ((jleft, jright,
    jout), (tleft, tright, tout))."""
    def build(m, rel):
        left = m.frame(dict(left_cols), num_partitions=parts)
        right = m.frame(dict(right_cols), num_partitions=right_parts)
        fn = rel.broadcast_join if strategy == "broadcast" \
            else rel.sort_merge_join
        return left, right, fn(left, right, on=on, how=how, **kw)
    return _both(build)


# ---------------------------------------------------------------------------
# broadcast hash join
# ---------------------------------------------------------------------------

class TestBroadcastJoin:
    @pytest.mark.parametrize("how", ["inner", "left"])
    @pytest.mark.parametrize("dup", [False, True])
    def test_oracle_equivalence(self, how, dup):
        right = _right_dup_cols() if dup else _right_unique_cols()
        (jl, jr, jo), (tl, tr, to) = _join_both(_left_cols(), right, how)
        assert _eq(_rows(to), _oracle_for(tl, tr, "k", how))
        assert_frames_match(jo, to)

    def test_indicator_column(self):
        (jl, jr, jo), (tl, tr, to) = _join_both(
            _left_cols(), _right_unique_cols(), "left",
            indicator="matched")
        assert to.schema.names[-1] == "matched"
        assert _eq(_rows(to), _oracle_for(tl, tr, "k", "left",
                                          indicator="matched"))
        assert_frames_match(jo, to)

    def test_empty_left(self):
        empty = {"k": np.empty(0, np.int64), "v": np.empty(0)}
        (_, _, jo), (_, _, to) = _join_both(empty, _right_unique_cols(),
                                            "left", parts=1)
        assert to.count() == 0
        assert to.schema.names == ["k", "v", "w", "name"]
        assert_frames_match(jo, to)

    @pytest.mark.parametrize("how", ["inner", "left"])
    def test_empty_right(self, how):
        empty = {"k": np.empty(0, np.int64), "w": np.empty(0)}
        (jl, jr, jo), (tl, tr, to) = _join_both(_left_cols(), empty, how)
        assert _eq(_rows(to), _oracle_for(tl, tr, "k", how))
        assert_frames_match(jo, to)

    def test_filter_to_zero_probe(self):
        def build(m, rel):
            left = m.frame(_left_cols(), num_partitions=3).filter(
                lambda k: k > 100)
            return rel.broadcast_join(left, m.frame(_right_unique_cols()),
                                      on="k", how="inner")
        jo, to = _both(build)
        assert to.count() == 0
        assert to.schema.names == ["k", "v", "tag", "w", "name"]
        assert_frames_match(jo, to)

    def test_multi_key_and_strings(self):
        left = {"a": np.array([1, 1, 2, 2], np.int64),
                "s": np.array(["x", "y", "x", "z"], object),
                "v": np.arange(4.0)}
        right = {"a": np.array([1, 2], np.int64),
                 "s": np.array(["y", "x"], object),
                 "w": np.array([7.0, 8.0])}
        for how in ("inner", "left"):
            (jl, jr, jo), (tl, tr, to) = _join_both(
                left, right, how, parts=2, on=["a", "s"])
            assert _eq(_rows(to), _oracle_for(tl, tr, ["a", "s"], how))
            assert_frames_match(jo, to)

    def test_block_boundaries_preserved(self):
        (jl, jr, jo), (tl, tr, to) = _join_both(
            _left_cols(), _right_unique_cols(), "left", parts=4)
        assert [b.num_rows for b in to.blocks()] == \
            [b.num_rows for b in tl.blocks()]
        assert_frames_match(jo, to)

    def test_vector_cells_ride_along(self):
        right = {"k": np.array([2, 3], np.int64),
                 "emb": np.arange(6.0).reshape(2, 3)}
        (jl, jr, jo), (tl, tr, to) = _join_both(
            {"k": np.array([3, 1, 2], np.int64)}, right, "left", parts=1)
        got = {int(r[0]): np.asarray(r[1]) for r in to.collect()}
        assert np.array_equal(got[3], [3., 4., 5.])
        assert np.array_equal(got[2], [0., 1., 2.])
        assert np.all(np.isnan(got[1]))
        assert_frames_match(jo, to)

    def test_tensorframe_join_method(self):
        def build(m, rel):
            left = m.frame(_left_cols(), num_partitions=3)
            return left, left.join(m.frame(_right_unique_cols()), on="k",
                                   how="left")
        (_, jo), (tl, to) = _both(build)
        assert _eq(_rows(to), _oracle_for(
            tl, ttf.frame(_right_unique_cols()), "k", "left"))
        assert_frames_match(jo, to)
        # the port's route record is the JAX package's without its mesh
        # inputs (limit, shuffle, estimated build bytes)
        assert to._join_route == {k: jo._join_route[k]
                                  for k in to._join_route}

    def test_validation_errors(self):
        for m, rel, not_found in ((jtf, jrel, JInputNotFound),
                                  (ttf, trel, InputNotFoundError)):
            left = m.frame(_left_cols())
            right = m.frame(_right_unique_cols())
            with pytest.raises(not_found, match="join key 'nope'"):
                rel.broadcast_join(left, right, on="nope")
            with pytest.raises(ValueError, match="duplicate column 'v'"):
                rel.broadcast_join(
                    left, m.frame({"k": np.array([1], np.int64),
                                   "v": np.array([1.0])}), on="k")
            with pytest.raises(ValueError, match="inner.*left|how"):
                rel.broadcast_join(left, right, on="k", how="outer")
            with pytest.raises(ValueError, match="already exists"):
                rel.broadcast_join(left, right, on="k", indicator="w")

    def test_plan_node_estimates_and_admission(self):
        (jl, jr, jo), (tl, tr, to) = _join_both(
            _left_cols(), _right_unique_cols(), "left")
        assert to.estimated_rows() == tl.count() == jo.estimated_rows()
        assert to.estimated_bytes() is not None and to.estimated_bytes() > 0
        # duplicate keys expand the estimate by the mean group span
        (_, _, jd), (_, _, td) = _join_both(_left_cols(), _right_dup_cols(),
                                            "inner")
        assert td.estimated_rows() == jd.estimated_rows()

    def test_downstream_fusion_and_pruning(self):
        import jax.numpy as jnp
        (jl, jr, jo), (tl, tr, to) = _join_both(
            _left_cols(), _right_unique_cols(), "left")
        jchain = jo.map_blocks(
            lambda v, w: {"z": v + jnp.nan_to_num(w)}).select(["k", "z"])
        tchain = to.map_blocks(
            lambda v, w: {"z": v + torch.nan_to_num(w)}).select(["k", "z"])
        expect = [(int(r[0]), float(r[1]) + (0.0 if np.isnan(r[3]) else r[3]))
                  for r in to.collect()]
        assert _rows(tchain) == expect
        assert_frames_match(jchain, tchain)
        info = "\n".join(tchain._plan_info or [])
        # pruning reached INTO the join: tag/name never materialized
        assert "join[broadcast,left]" in info
        assert "'tag'" in info and "pruned" in info
        jsrc = [ln for ln in jchain._plan_info if "source" in ln]
        tsrc = [ln for ln in tchain._plan_info if "source" in ln]
        assert tsrc == jsrc

    def test_gather_is_one_dispatch_per_block_of_the_needed_columns(
            self, monkeypatch):
        seen = []
        real = tjoin.BuildTable.gather_device

        def spy(self, names, idx, gid, executor=None):
            out = real(self, names, idx, gid, executor=executor)
            seen.append(tuple(out))
            return out
        monkeypatch.setattr(tjoin.BuildTable, "gather_device", spy)
        right = dict(_right_unique_cols(), w2=np.array([1., 2., 3.]))
        out = trel.broadcast_join(ttf.frame(_left_cols(), num_partitions=3),
                                  ttf.frame(right), on="k")
        chain = out.map_blocks(lambda v, w: {"z": v + w}).select(["z"])
        d0 = counters.get("relational.probe_dispatches")
        chain.blocks()
        assert chain._plan_info
        assert counters.get("relational.probe_dispatches") - d0 == 3
        assert seen == [("w",)] * 3  # not w2 (unnamed), not name (host)

    def test_build_is_resident_and_copied_once(self):
        build = tjoin.BuildTable(ttf.frame(_right_unique_cols()), "k")
        assert set(build.dev_cols) == {"w"}
        assert isinstance(build.dev_cols["w"], torch.Tensor)
        assert build.dev_cols["w"].dtype == torch.float64
        comp = build._probe_comp(("w",), build.build_rows)
        assert build._probe_comp(("w",), build.build_rows) is comp
        assert [s.shape.dims for s in comp.inputs] == [(-1,), (3,)]
        got = build.gather_device(["w"], np.array([2, 0, 0]), None)
        np.testing.assert_array_equal(got["w"], [500., 200., 200.])


# ---------------------------------------------------------------------------
# the build table under the memory ledger
# ---------------------------------------------------------------------------

_MEM = {"jax": importlib.import_module("tensorframes_tpu.memory"),
        "torch": importlib.import_module("tensorframes_tpu_torch.memory")}
_COUNTERS = {"jax": importlib.import_module(
    "tensorframes_tpu.utils.tracing").counters, "torch": counters}
_WATCHED = ("memory.", "relational.build_chunks",
            "relational.probe_dispatches", "pipeline.")


def _budgeted(run, limit):
    """``run(package, relational)`` in each package under a ``limit``-byte
    budget (``0``: none); returns ``{pkg: (value, watched counters)}``."""
    out = {}
    for name, (m, rel) in (("jax", (jtf, jrel)), ("torch", (ttf, trel))):
        c = _COUNTERS[name]
        c.reset()
        _MEM[name].configure(limit_bytes=limit)
        try:
            v = run(m, rel)
        finally:
            _MEM[name]._reset()
        out[name] = (v, {k: n for k, n in c.snapshot().items()
                         if k.startswith(_WATCHED)})
    assert out["torch"][1] == out["jax"][1], (out["torch"][1],
                                              out["jax"][1])
    return out


class TestChunkedBuild:
    def test_over_budget_build_bit_identical(self):
        n = 20000
        right = {"k": np.arange(n, dtype=np.int64),
                 "w": np.arange(n, dtype=np.float64),
                 "w2": np.arange(n, dtype=np.float64)}
        left = {"k": np.array([0, 5, n - 1, n + 7, 123], np.int64)}

        def run(m, rel):
            return _rows(rel.broadcast_join(
                m.frame(left, num_partitions=2), m.frame(right), on="k",
                how="left"))
        unlimited = _budgeted(run, 0)
        # build tensor bytes about 4x the budget
        res = _budgeted(run, int(n * 16 // 4))
        got = res["torch"][0]
        assert _eq(got, res["jax"][0])
        assert _eq(got, unlimited["torch"][0])
        assert _eq(got, _oracle_for(ttf.frame(left), ttf.frame(right), "k",
                                    "left"))
        assert res["torch"][1]["relational.build_chunks"] == 16
        assert res["torch"][1]["relational.probe_dispatches"] == 2 * 16
        assert "relational.build_chunks" not in unlimited["torch"][1]

    def test_chunk_spans_hold_whole_key_groups(self):
        """A key's duplicate rows never straddle two chunks: the spans cut
        at group starts."""
        right = {"k": np.repeat(np.arange(50, dtype=np.int64), 7),
                 "w": np.arange(350, dtype=np.float64)}
        spans = {}
        for name, m in (("jax", jtf), ("torch", ttf)):
            _MEM[name].configure(limit_bytes=700)  # threshold 350 B
            try:
                mod = jjoin if m is jtf else tjoin
                bt = mod.BuildTable(m.frame(right), "k")
                assert bt.chunks is not None and len(bt.chunks) == 16
                starts = set(bt.starts.tolist()) | {bt.build_rows}
                assert all(a in starts and b in starts
                           for a, b in bt.chunks)
                spans[name] = bt.chunks
            finally:
                _MEM[name]._reset()
        assert spans["torch"] == spans["jax"]
        left = {"k": np.array([3, 3, 49, 60, 0], np.int64)}

        def run(m, rel):
            return _rows(rel.broadcast_join(m.frame(left), m.frame(right),
                                            on="k", how="inner"))
        res = _budgeted(run, 700)
        assert _eq(res["torch"][0], res["jax"][0])
        assert len(res["torch"][0]) == 4 * 7

    def test_resident_build_spills_and_faults_back(self):
        """Under a budget that holds it, the build is a spillable ledger
        entry: spilled under pressure, faulted back at its next probe,
        with the same rows."""
        right = _right_unique_cols()
        left = _left_cols()

        def run(m, rel):
            mgr = _MEM["jax" if m is jtf else "torch"].active()
            out = rel.broadcast_join(m.frame(left, num_partitions=2),
                                     m.frame(right), on="k", how="left")
            first = _rows(out)
            snap = mgr.snapshot()
            assert mgr.make_room(mgr.limit)  # everything must go
            spilled = mgr.snapshot()["spilled_buffers"]
            out.uncache()
            return first, _rows(out), snap["resident_buffers"], spilled
        res = _budgeted(run, 10 ** 6)
        first, again, resident, spilled = res["torch"][0]
        assert _eq(first, again) and _eq(first, res["jax"][0][0])
        assert (resident, spilled) == (1, 1) == res["jax"][0][2:]
        assert res["torch"][1]["memory.spills"] == 1
        assert res["torch"][1]["memory.faults"] == 1

    def test_star_schema_with_chunked_builds(self):
        """Q2.1 at a small size with a budget under which the date and part
        builds probe in chunks: equal to the resident builds' result and
        to the numpy reference."""
        tables = ssb_small()
        want = ssb_reference(np, tables, True)

        def run(m, rel):
            return ssb_query(m, tables)[1].blocks()[0].columns
        resident = _budgeted(run, 0)["torch"][0]
        res = _budgeted(run, 40_000)
        assert res["torch"][1]["relational.build_chunks"] > 1
        for name, col in want.items():
            np.testing.assert_array_equal(res["torch"][0][name], col)
            np.testing.assert_array_equal(res["torch"][0][name],
                                          resident[name])
            np.testing.assert_array_equal(res["jax"][0][name], col)


# ---------------------------------------------------------------------------
# sort-merge join (host order_by; the mesh variant waits for A10)
# ---------------------------------------------------------------------------

def _smj_oracle(left, right, on, how, indicator=None):
    """Sort-merge oracle: the broadcast oracle over the key-sorted
    (stable) left side."""
    on_l = [on] if isinstance(on, str) else list(on)
    lrows = _rows(left)
    idx = [left.schema.names.index(k) for k in on_l]
    lrows = sorted(lrows, key=lambda r: tuple(r[i] for i in idx))
    rrows = _rows(right)
    ridx = [right.schema.names.index(k) for k in on_l]
    rrows = sorted(rrows, key=lambda r: tuple(r[i] for i in ridx))
    return oracle_join(lrows, rrows, left.schema.names, right.schema.names,
                       on_l, how, list(right.schema), indicator=indicator)


class TestSortMergeJoin:
    @pytest.mark.parametrize("how", ["inner", "left"])
    @pytest.mark.parametrize("dup", [False, True])
    def test_host_oracle(self, how, dup):
        right = _right_dup_cols() if dup else _right_unique_cols()
        (jl, jr, jo), (tl, tr, to) = _join_both(
            _left_cols(), right, how, strategy="sort_merge")
        assert _eq(_rows(to), _smj_oracle(tl, tr, "k", how))
        assert_frames_match(jo, to)

    @pytest.mark.parametrize("how", ["inner", "left"])
    def test_empty_sides(self, how):
        full = {"k": np.array([1, 2], np.int64), "v": np.array([1., 2.])}
        empty = {"k": np.empty(0, np.int64), "w": np.empty(0)}
        (jl, jr, jo), (tl, tr, to) = _join_both(
            full, empty, how, parts=1, strategy="sort_merge")
        assert _eq(_rows(to), _smj_oracle(tl, tr, "k", how))
        assert_frames_match(jo, to)
        (_, _, jo2), (_, _, to2) = _join_both(
            {"k": np.empty(0, np.int64), "v": np.empty(0)},
            {"k": np.array([1], np.int64), "w": np.array([1.])}, how,
            parts=1, strategy="sort_merge")
        assert to2.count() == 0
        assert_frames_match(jo2, to2)

    def test_string_key_rejected(self):
        for m, rel, err in ((jtf, jrel, JInvalidType),
                            (ttf, trel, InvalidTypeError)):
            left = m.frame({"k": np.array(["a"], object),
                            "v": np.array([1.0])})
            with pytest.raises(err, match="must be numeric"):
                rel.sort_merge_join(left, left.select(["k"]), on="k")

    def test_multi_key_and_indicator(self):
        left = {"a": np.array([2, 1, 2, 1, 3], np.int64),
                "b": np.array([0, 1, 0, 0, 1], np.int64),
                "v": np.arange(5.0)}
        right = {"a": np.array([1, 2, 2], np.int64),
                 "b": np.array([1, 0, 0], np.int64),
                 "w": np.array([10.0, 20.0, 21.0])}
        (jl, jr, jo), (tl, tr, to) = _join_both(
            left, right, "left", parts=2, strategy="sort_merge",
            on=["a", "b"], indicator="hit")
        assert _eq(_rows(to), _smj_oracle(tl, tr, ["a", "b"], "left",
                                          indicator="hit"))
        assert_frames_match(jo, to)

    def test_a_mesh_is_not_ported_yet(self):
        left = ttf.frame(_left_cols())
        right = ttf.frame(_right_unique_cols())
        with pytest.raises(NotImplementedError, match="A10"):
            trel.sort_merge_join(left, right, on="k", mesh=object())
        with pytest.raises(ValueError, match="needs a mesh"):
            trel.partitioned_hash_join(left, right, on="k")
        with pytest.raises(NotImplementedError, match="A10"):
            trel.partitioned_hash_join(left, right, on="k", mesh=object())


class TestRouting:
    @pytest.mark.parametrize("how", ["inner", "left"])
    @pytest.mark.parametrize("strategy", [None, "broadcast", "sort_merge"])
    def test_route_matches_the_jax_package(self, how, strategy):
        def build(m, rel):
            left = m.frame(_left_cols(), num_partitions=3)
            right = m.frame(_right_dup_cols())
            return rel.join(left, right, on="k", how=how, strategy=strategy)
        jo, to = _both(build)
        assert_frames_match(jo, to)
        if strategy is None:
            assert to._join_route == {"strategy": "broadcast",
                                      "reason": "no mesh", "how": how,
                                      "keys": ["k"]}
            assert to._join_route == {k: jo._join_route[k]
                                      for k in to._join_route}
        else:
            assert not hasattr(to, "_join_route")

    @pytest.mark.parametrize("strategy",
                             [None, "broadcast", "sort_merge", "partitioned"])
    def test_a_mesh_is_not_ported_yet(self, strategy):
        left = ttf.frame(_left_cols())
        with pytest.raises(NotImplementedError, match="A10"):
            trel.join(left, ttf.frame(_right_unique_cols()), on="k",
                      strategy=strategy, mesh=object())

    def test_unknown_strategy(self):
        left = ttf.frame(_left_cols())
        with pytest.raises(ValueError, match="unknown join strategy"):
            trel.join(left, left.select(["k"]), on="k", strategy="hash")


# ---------------------------------------------------------------------------
# sketches: states, error bounds and the aggregate path
# ---------------------------------------------------------------------------

def _sketch_data(n=12000, groups=3, seed=5):
    rng = np.random.default_rng(seed)
    return {"g": rng.integers(0, groups, n).astype(np.int64),
            "x": rng.lognormal(0.0, 1.5, n),
            "it": rng.integers(0, 500, n).astype(np.int64)}


def _agg_both(cols, fetches_of, parts, keys=("g",)):
    def build(m, rel):
        df = m.frame(dict(cols), num_partitions=parts)
        return m.aggregate(fetches_of(rel), df.group_by(*keys))
    return _both(build)


class TestSketchAggregate:
    def test_hll_error_bound(self):
        cols = _sketch_data()
        jo, to = _agg_both(cols, lambda rel: {"it": rel.approx_distinct(
            bits=10)}, parts=4)
        sk = trel.approx_distinct(bits=10)
        bound = 5 * sk.relative_error  # 5-sigma on 1.04/sqrt(m)
        for r in to.collect():
            true = len(np.unique(cols["it"][cols["g"] == r[0]]))
            assert abs(int(r[1]) - true) <= max(2, bound * true)
        assert_frames_match(jo, to)

    def test_quantile_error_bound(self):
        cols = _sketch_data()
        jo, to = _agg_both(cols, lambda rel: {"x": rel.approx_quantile(
            qs=(0.1, 0.5, 0.9), alpha=0.02)}, parts=4)
        sk = trel.approx_quantile(qs=(0.1, 0.5, 0.9), alpha=0.02)
        for r in to.collect():
            vals = cols["x"][cols["g"] == r[0]]
            for j, q in enumerate(sk.qs):
                true = np.quantile(vals, q, method="inverted_cdf")
                assert abs(np.asarray(r[1])[j] - true) <= \
                    sk.relative_error * abs(true)
        assert_frames_match(jo, to)

    def test_quantile_negative_and_zero(self):
        cols = {"g": np.zeros(6, np.int64),
                "x": np.array([-100.0, -1.0, 0.0, 0.0, 1.0, 100.0])}
        jo, to = _agg_both(cols, lambda rel: {"x": rel.approx_quantile(
            qs=0.5, alpha=0.01, min_value=1e-3, max_value=1e3)}, parts=1)
        assert to.collect()[0][1] == 0.0  # the exact zero bucket
        assert_frames_match(jo, to)

    def test_quantile_nan_rows_dropped(self):
        cols = {"g": np.zeros(6, np.int64),
                "x": np.array([np.nan, np.nan, np.nan, 10.0, 20.0, 30.0])}
        jo, to = _agg_both(cols, lambda rel: {"x": rel.approx_quantile(
            qs=0.5, alpha=0.01, min_value=1e-3, max_value=1e3)}, parts=2)
        sk = trel.approx_quantile(qs=0.5, alpha=0.01, min_value=1e-3,
                                  max_value=1e3)
        got = to.collect()[0][1]
        assert abs(got - 20.0) <= sk.relative_error * 20.0
        assert_frames_match(jo, to)

    def test_topk_exactness_above_threshold(self):
        rng = np.random.default_rng(11)
        n = 10000
        heavy = np.concatenate([np.full(4000, 77), np.full(2500, 13)])
        noise = rng.integers(1000, 9000, n - len(heavy))
        it = np.concatenate([heavy, noise]).astype(np.int64)
        rng.shuffle(it)
        cols = {"g": np.zeros(n, np.int64), "it": it}
        jo, to = _agg_both(cols, lambda rel: {"it": rel.approx_top_k(k=8)},
                           parts=5)
        row = to.collect()[0]
        items = list(np.asarray(row[1]))
        cts = dict(zip(items, np.asarray(row[2])))
        thr = n / (8 + 1)  # every item above n/(k+1) survives
        for item, true in ((77, 4000), (13, 2500)):
            assert item in items
            assert true - thr <= cts[item] <= true
        # the same blocks folded in the same order: the same exact state
        assert_frames_match(jo, to)

    def test_topk_guarantee_under_another_block_order(self):
        rng = np.random.default_rng(12)
        it = np.concatenate([np.full(3000, 5), rng.integers(100, 900, 3000)])
        rng.shuffle(it)
        n = len(it)
        outs = []
        for parts in (2, 7):
            df = ttf.frame({"g": np.zeros(n, np.int64),
                            "it": it.astype(np.int64)},
                           num_partitions=parts)
            outs.append(ttf.aggregate({"it": trel.approx_top_k(k=4)},
                                      df.group_by("g")).collect()[0])
        for row in outs:
            cts = dict(zip(np.asarray(row[1]), np.asarray(row[2])))
            assert 3000 - n / 5 <= cts[5] <= 3000

    def test_mixed_scalar_and_sketch(self):
        cols = _sketch_data(n=4000)
        jo, to = _agg_both(cols, lambda rel: {
            "x": "sum", "it": rel.approx_distinct(bits=8)}, parts=3)
        assert to.schema.names == ["g", "it", "x"]
        assert schema_tuple(to.schema) == schema_tuple(jo.schema)
        for r in to.collect():
            m = cols["g"] == r[0]
            np.testing.assert_allclose(r[2], cols["x"][m].sum(),
                                       rtol=RTOL_SUM)
        jc, tc = jo.blocks()[0].columns, to.blocks()[0].columns
        np.testing.assert_array_equal(tc["g"], jc["g"])
        np.testing.assert_array_equal(tc["it"], jc["it"])
        assert tc["it"].dtype == jc["it"].dtype == np.int64
        np.testing.assert_allclose(tc["x"], jc["x"], rtol=RTOL_SUM)

    def test_strings_distinct(self):
        cols = {"g": np.zeros(500, np.int64),
                "s": np.array([f"u{i % 37}" for i in range(500)], object)}
        jo, to = _agg_both(cols, lambda rel: {"s": rel.approx_distinct(
            bits=10)}, parts=2)
        assert abs(int(to.collect()[0][1]) - 37) <= 4
        assert_frames_match(jo, to)

    def test_validation(self):
        for m, rel, not_found in ((jtf, jrel, JInputNotFound),
                                  (ttf, trel, InputNotFoundError)):
            df = m.frame({"g": np.zeros(4, np.int64), "x": np.arange(4.0)})
            with pytest.raises(ValueError, match="integer"):
                m.aggregate({"x": rel.approx_top_k(4)}, df.group_by("g"))
            with pytest.raises(not_found):
                m.aggregate({"nope": rel.approx_distinct()},
                            df.group_by("g"))
            with pytest.raises(ValueError, match="sketch combiner"):
                m.aggregate({"x": "mean"}, df.group_by("g"))
            with pytest.raises(ValueError, match=r"\[4, 16\]"):
                rel.approx_distinct(bits=3)
            with pytest.raises(ValueError, match="alpha"):
                rel.approx_quantile(alpha=0.7)
            with pytest.raises(ValueError, match="k >= 1"):
                rel.approx_top_k(0)

    def test_bfloat16_hashes_distinct(self):
        ml_dtypes = pytest.importorskip("ml_dtypes")
        vals = [0.25, 0.5, 0.75, -0.0, 0.0, 3.0]
        # the port stores bf16 as f32 on the host; the JAX package as
        # ml_dtypes bf16; both hash through f64, exactly
        th = tsketch._hash64(np.array(vals, np.float32))
        jh = jsketch._hash64(np.array(vals, dtype=ml_dtypes.bfloat16))
        assert len(set(th[:3].tolist())) == 3  # not int-truncated
        assert th[3] == th[4]  # -0.0 == 0.0
        np.testing.assert_array_equal(th, jh)

    def test_bfloat16_fill_is_nan(self):
        from tensorframes_tpu_torch import dtypes
        from tensorframes_tpu_torch.schema import Field
        assert np.isnan(tjoin._fill_value(Field("b", dtypes.bfloat16)))
        right = ttf.frame({"k": np.array([2], np.int64),
                           "b": np.array([1.5], np.float32)},
                          schema=ttf.Schema([
                              Field("k", dtypes.int64),
                              Field("b", dtypes.bfloat16)]))
        right = ttf.analyze(right)
        out = trel.broadcast_join(ttf.frame({"k": np.array([1, 2],
                                                           np.int64)}),
                                  right, on="k", how="left")
        got = out.blocks()[0].columns["b"]
        assert got.dtype == np.float32
        assert np.isnan(got[0]) and got[1] == 1.5


@pytest.mark.parametrize("n", [100, 4095, 4096, 9000])
@pytest.mark.parametrize("kind", ["hll", "quantile"])
def test_sketch_states_bit_identical(n, kind):
    # below 4,096 rows both packages fold on the host, from 4,096 on the
    # device (here the CPU executor): the states agree bit for bit
    rng = np.random.default_rng(n)
    ids = rng.integers(0, 5, n).astype(np.int64)
    if kind == "hll":
        vals = rng.integers(0, 3000, n).astype(np.int64)
        jsk, tsk = jsketch.HllSketch(bits=9), tsketch.HllSketch(bits=9)
    else:
        vals = rng.lognormal(0.0, 2.0, n) * np.where(rng.random(n) < 0.2,
                                                     -1, 1)
        vals[::97] = np.nan
        jsk = jsketch.QuantileSketch(qs=(0.5, 0.9), alpha=0.01)
        tsk = tsketch.QuantileSketch(qs=(0.5, 0.9), alpha=0.01)
    jt = np.asarray(jsk.block_partial(vals, ids, 5))
    tt = tsk.block_partial(vals, ids, 5, device="cpu")
    assert tt.dtype == jt.dtype == np.int32
    np.testing.assert_array_equal(tt, jt)
    for name, col in tsk.finalize("c", tt).items():
        np.testing.assert_array_equal(col, jsk.finalize("c", jt)[name])


@pytest.mark.parametrize("kind", ["hll", "quantile", "top_k"])
def test_combine_and_merge_tables_match_the_jax_package(kind):
    rng = np.random.default_rng(8)
    make = {"hll": lambda m: m.HllSketch(bits=6),
            "quantile": lambda m: m.QuantileSketch(alpha=0.1),
            "top_k": lambda m: m.TopKSketch(k=3)}[kind]
    tsk, jsk = make(tsketch), make(jsketch)
    vals = rng.integers(0, 40, 600).astype(np.int64)
    a = tsk.block_partial(vals[:300], rng.integers(0, 4, 300), 4)
    b = tsk.block_partial(vals[300:], rng.integers(0, 3, 300), 3)
    np.testing.assert_array_equal(tsk.combine_np(a, a), jsk.combine_np(a, a))
    idx_a, idx_b = np.array([0, 2, 3, 5]), np.array([1, 2, 5])
    got = tsk.merge_tables(a, idx_a, b, idx_b, 6)
    np.testing.assert_array_equal(got, jsk.merge_tables(a, idx_a, b,
                                                        idx_b, 6))
    assert got.dtype == np.dtype(tsk.state_dtype)


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64,
                                   np.float32, bool, object])
def test_hash64_matches_the_jax_package(dtype):
    rng = np.random.default_rng(3)
    raw = rng.integers(-50, 50, 200)
    vals = np.array([f"s{v}" for v in raw], object) if dtype is object \
        else raw.astype(dtype)
    np.testing.assert_array_equal(tsketch._hash64(vals),
                                  jsketch._hash64(vals))
    w = tsketch._hash64(vals)
    np.testing.assert_array_equal(tsketch._clz64(w), jsketch._clz64(w))


def test_failing_device_fold_raises_and_does_not_fall_back(monkeypatch):
    from tensorframes_tpu_torch.engine import ops as tops

    def broken(*a, **k):
        raise RuntimeError("device fold failed")
    monkeypatch.setattr(tops, "_segment_reduce", broken)
    sk = tsketch.HllSketch(bits=8)
    vals = np.arange(5000, dtype=np.int64)
    ids = np.zeros(5000, np.int64)
    with pytest.raises(RuntimeError, match="device fold failed"):
        sk.block_partial(vals, ids, 1, device="cpu")
    df = ttf.frame({"g": ids, "v": vals})
    with pytest.raises(RuntimeError, match="device fold failed"):
        ttf.aggregate({"v": trel.approx_distinct(bits=8)}, df.group_by("g"))
    # under the threshold the host folds, as in the JAX package
    assert sk.block_partial(vals[:100], ids[:100], 1).shape == (1, 256)


def test_sketch_fold_counts_and_span():
    from tensorframes_tpu_torch.utils import tracing
    cols = _sketch_data(n=5000)
    df = ttf.frame(cols, num_partitions=1)
    f0 = counters.get("relational.sketch_folds")
    tracing.enable()
    try:
        tracing.timings.reset()
        ttf.aggregate({"it": trel.approx_distinct(bits=8),
                       "x": trel.approx_quantile()}, df.group_by("g"))
        spans = tracing.timings.snapshot()
    finally:
        tracing.disable()
    assert counters.get("relational.sketch_folds") - f0 == 2
    assert spans["aggregate.sketch_fold"]["count"] == 1
    assert "aggregate.segment_reduce" in spans


# ---------------------------------------------------------------------------
# hot keys: no salted daggregate in the port yet
# ---------------------------------------------------------------------------

class TestHotKeys:
    def test_no_salting_no_hot_keys(self):
        cols = {"k": np.arange(20, dtype=np.int64), "v": np.arange(20.0)}
        jo, to = _agg_both(cols, lambda rel: {"v": "sum"}, parts=1,
                           keys=("k",))
        assert to.hot_keys() == jo.hot_keys() == []
        assert ttf.frame(cols).hot_keys() == []


# ---------------------------------------------------------------------------
# the star-schema chain: SSB Q2.1 and its roll-up at small size, with the
# generator, the query and the numpy reference of chip_smoke.py's phase
# ---------------------------------------------------------------------------

def ssb_small(rows=5000):
    """SSB's tables at a small size: 200 parts, 20 suppliers, 300
    customers."""
    return ssb_tables(np, rows, parts=200, suppliers=20, customers=300)


def ssb_query(m, tables, partitions=3, **kw):
    return chip_smoke.ssb_query(m, tables, partitions, **kw)


class TestStarSchema:
    @pytest.mark.parametrize("q21", [True, False], ids=["q21", "rollup"])
    def test_query_matches_reference_and_jax_fused_and_unfused(
            self, monkeypatch, q21):
        tables = ssb_small()
        want = ssb_reference(np, tables, q21)
        f0 = counters.get("plan.fused_queries")
        tchain, tout = ssb_query(ttf, tables, q21=q21)
        tcols = tout.blocks()[0].columns
        assert tchain._plan_info, "the chain over the joins did not fuse"
        assert counters.get("plan.fused_queries") > f0
        for name, col in want.items():
            np.testing.assert_array_equal(tcols[name], col)
            assert tcols[name].dtype == col.dtype
        jchain, jout = ssb_query(jtf, tables, q21=q21)
        assert_frames_match(jout, tout)
        assert_frames_match(jchain, tchain)
        monkeypatch.setenv("TFT_FUSE", "0")
        uchain, uout = ssb_query(ttf, tables, q21=q21)
        assert_frames_match(tout, uout)  # bit-equal
        assert_frames_match(tchain, uchain)
        assert uchain._plan_info is None

    def test_unnamed_build_columns_are_never_gathered(self, monkeypatch):
        seen = []
        real = tjoin.BuildTable.gather_device

        def spy(self, names, idx, gid, executor=None):
            out = real(self, names, idx, gid, executor=executor)
            seen.append(tuple(out))
            return out
        monkeypatch.setattr(tjoin.BuildTable, "gather_device", spy)
        tables = ssb_small()
        d0 = counters.get("relational.probe_dispatches")
        chain, _ = ssb_query(ttf, tables)
        chain.blocks()
        assert counters.get("relational.probe_dispatches") - d0 == 9
        assert sorted({tuple(sorted(t)) for t in seen}) == [
            ("d_year",), ("p_brand1", "p_category"), ("s_region",)]
        explain = "\n".join(chain._plan_info)
        assert "join[broadcast,inner]['lo_suppkey']" in explain
        assert "s_nation" in explain and "pruned" in explain
        # per op, every join gathers every build column
        seen.clear()
        monkeypatch.setenv("TFT_FUSE", "0")
        ssb_query(ttf, tables)[0].blocks()
        assert sorted({tuple(sorted(t)) for t in seen}) == [
            ("d_year", "d_yearmonthnum"),
            ("p_brand1", "p_category", "p_mfgr"),
            ("s_nation", "s_region")]

    def test_sort_merge_equals_broadcast_after_aggregate(self):
        tables = ssb_small()
        _, bcast = ssb_query(ttf, tables)
        _, smj = ssb_query(ttf, tables, sort_merge=True)
        assert_frames_match(bcast, smj)
        _, jsmj = ssb_query(jtf, tables, sort_merge=True)
        assert_frames_match(jsmj, smj)

    @pytest.mark.parametrize("parts", [1, 3])
    def test_distinct_customers_by_year(self, parts):
        # one block of 5,000 rows folds on the device, three of 1,667 on
        # the host; both equal the JAX package's
        lineorder, date, _, _ = ssb_small()

        def build(m, rel):
            lo = m.frame(dict(lineorder), num_partitions=parts)
            j = lo.join(m.frame(dict(date)), on="lo_orderdate").select(
                ["d_year", "lo_custkey"])
            return m.aggregate({"lo_custkey": rel.approx_distinct(bits=12)},
                               j.group_by("d_year"))
        jo, to = _both(build)
        assert_frames_match(jo, to)
        cols = to.blocks()[0].columns
        year = date["d_year"][np.searchsorted(date["lo_orderdate"],
                                              lineorder["lo_orderdate"])]
        sk = trel.approx_distinct(bits=12)
        for y, est in zip(cols["d_year"], cols["lo_custkey"]):
            true = len(np.unique(lineorder["lo_custkey"][year == y]))
            assert abs(int(est) - true) <= 5 * sk.relative_error * true
