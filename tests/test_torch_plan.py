"""The port's logical plan against the JAX package's (``tests/test_plan.py``).

Each chain of ``test_plan.py`` runs through both packages on the same
frame (handed over block for block): the port's fused result must be bit
for bit its own ``TFT_FUSE=0`` result, and equal to the JAX package's
(values, dtypes, schema, row order, block boundaries; bit-equal for
elementwise f64 chains, rtol 1e-12 where a block reduction's summation
order may differ). Both packages must also reach the same fusion decision:
per-op or fused, the stages and their members, the columns the leaf reads,
and the row groups a parquet scan reads. The JAX side runs with
``TFT_ADAPTIVE=0`` and ``TFT_RESULT_CACHE=0``, the static plan the port
has. Counters are read as deltas.

A lambda that uses only operators is shared by both packages; one that
calls a library function has a twin per package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import io as jio
from tensorframes_tpu.engine.ops import InvalidShapeError as JInvalidShape
from tensorframes_tpu.memory.estimate import frame_estimate as jestimate
from tensorframes_tpu.plan.optimize import build_plan as jbuild
from tensorframes_tpu.plan.predicates import extract_atoms as jatoms
from tensorframes_tpu.utils.tracing import counters as jcounters
from tensorframes_tpu_torch import io as tio
from tensorframes_tpu_torch.computation import Computation, TensorSpec
from tensorframes_tpu_torch.engine.executor import BlockExecutor
from tensorframes_tpu_torch.engine.ops import InvalidShapeError
from tensorframes_tpu_torch.memory.estimate import frame_estimate
from tensorframes_tpu_torch.plan.optimize import build_plan
from tensorframes_tpu_torch.plan.predicates import (Atom, extract_atoms,
                                                    refutes)
from tensorframes_tpu_torch.shape import Shape, Unknown
from tensorframes_tpu_torch.utils import tracing
from tensorframes_tpu_torch.utils.tracing import counters
from torch_parity import assert_frames_match, to_port

RTOL = 1e-12


@pytest.fixture(autouse=True)
def _static_plan(monkeypatch):
    # the JAX package's predicates.py imports jax.core.Literal, which the
    # installed jax moved to jax.extend.core; without it that package
    # extracts no atoms and pushes nothing down
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


def _snapshot(frame):
    return [(b.num_rows, {n: (list(c) if not isinstance(c, np.ndarray)
                              else c) for n, c in b.columns.items()})
            for b in frame.blocks()]


def _assert_identical(fused, unfused):
    assert len(fused) == len(unfused), "block count differs"
    for i, ((nf, cf), (nu, cu)) in enumerate(zip(fused, unfused)):
        assert nf == nu, f"block {i}: row count {nf} != {nu}"
        assert list(cf) == list(cu), f"block {i}: columns differ"
        for n in cu:
            a, b = cf[n], cu[n]
            if isinstance(b, np.ndarray):
                assert isinstance(a, np.ndarray), (i, n)
                assert a.dtype == b.dtype, (i, n, a.dtype, b.dtype)
                assert a.shape == b.shape, (i, n, a.shape, b.shape)
                assert np.array_equal(a, b), (i, n)
            else:
                assert len(a) == len(b), (i, n)
                for x, y in zip(a, b):
                    if isinstance(y, np.ndarray):
                        assert np.array_equal(np.asarray(x), y), (i, n)
                    else:
                        assert x == y, (i, n)


def _decision(plan):
    """What a package decided for a chain: per-op (None), or the stages
    with their members, and the leaf's read and pruned columns."""
    if plan is None:
        return None
    return {"stages": [(st.label, st.inputs, st.outputs, st.passthrough,
                        st.mask) for st in plan.stages],
            "leaf_required": tuple(plan.leaf_required),
            "pruned": tuple(plan.pruned),
            "atoms": [(a.column, a.op, a.value) for a in plan.scan_atoms]}


def _both_packages(monkeypatch, jmake, tmake, jbuild_chain, tbuild_chain,
                   expect_fused=True, rtol=0.0):
    """Build and force the chain in both packages, fused and under
    ``TFT_FUSE=0``; assert the port's bit-identity, its agreement with
    the JAX package and the same fusion decision. Returns the port's
    fused chain."""
    jchain, tchain = jbuild_chain(jmake()), tbuild_chain(tmake())
    jd, td = _decision(jbuild(jchain)), _decision(build_plan(tchain))
    assert td == jd
    assert (td is not None) == expect_fused
    fused = _snapshot(tchain)
    jchain.blocks()
    assert bool(tchain._plan_info) == expect_fused
    assert tchain._plan_info == jchain._plan_info
    assert_frames_match(jchain, tchain, rtol=rtol)
    monkeypatch.setenv("TFT_FUSE", "0")
    tchain0 = tbuild_chain(tmake())
    assert build_plan(tchain0) is None
    unfused = _snapshot(tchain0)
    assert tchain0._plan_info is None
    monkeypatch.delenv("TFT_FUSE")
    _assert_identical(fused, unfused)
    return tchain


def _jframe(parts=4, rows=97):
    rng = np.random.default_rng(7)
    return jtf.frame(
        {"x": np.arange(float(rows)),
         "y": rng.random(rows),
         "k": (np.arange(rows) % 5).astype(np.int64),
         "v": rng.random((rows, 3)),
         "s": np.array([f"r{i}" for i in range(rows)], dtype=object)},
        num_partitions=parts)


def _pair(parts=4, rows=97):
    """The same frame in both packages, made afresh per call."""
    def j():
        return _jframe(parts, rows)

    def t():
        return to_port(_jframe(parts, rows))
    return j, t


def _shared(monkeypatch, build, parts=4, rows=97, **kw):
    j, t = _pair(parts, rows)
    return _both_packages(monkeypatch, j, t, build, build, **kw)


# ---------------------------------------------------------------------------
# equivalence: fused == TFT_FUSE=0 == the JAX package, and one decision
# ---------------------------------------------------------------------------

CHAINS = {
    "map_blocks_chain": lambda df: (
        df.map_blocks(lambda x: {"a": x + 1.0})
          .map_blocks(lambda a, y: {"b": a * y})
          .map_blocks(lambda b: {"c": b - 2.0})),
    "chain_with_filter_between_maps": lambda df: (
        df.map_blocks(lambda x: {"a": x * 2.0})
          .filter(lambda a: a % 4.0 == 0.0)
          .map_blocks(lambda a: {"b": a + 0.5})),
    "trim_chain": lambda df: (
        df.select(["x"])
          .map_blocks(lambda x: {"z": x[: x.shape[0] // 2]}, trim=True)
          .map_blocks(lambda z: {"w": z + 1.0})),
    "map_rows_chain": lambda df: (
        df.map_rows(lambda v: {"n": (v * v).sum()})
          .map_rows(lambda n: {"m": n + 1.0})
          .select(["n", "m", "s"])),
    "mixed_ops_with_select_pruning": lambda df: (
        df.map_blocks(lambda x, y: {"a": x + y})
          .select(["a", "k", "s"])
          .filter(lambda a: a > 1.0)
          .map_rows(lambda a: {"b": a * 0.5})
          .select(["b", "s"])),
    "two_filters": lambda df: (
        df.filter(lambda x: x > 5.0)
          .filter(lambda x: x < 60.0)
          .map_blocks(lambda x: {"a": x + 1.0})),
    "filter_drops_everything": lambda df: (
        df.map_blocks(lambda x: {"a": x + 1.0})
          .filter(lambda a: a < -1.0)
          .map_blocks(lambda a: {"b": a * 2.0})),
    "vector_columns_through_chain": lambda df: (
        df.map_blocks(lambda v: {"v2": v * 2.0})
          .filter(lambda x: x % 2.0 == 0.0)
          .select(["v", "v2", "x"])),
    "device_resident_stage_chaining": lambda df: (
        df.map_blocks(lambda x: {"a": x * 2.0})
          .filter(lambda a: a > 10.0)
          .map_blocks(lambda a: {"b": a + 1.0})),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_matches_unfused_and_jax(monkeypatch, name):
    # (v * v).sum() is a reduction over each row's 3 cells: its order is
    # each framework's own; (x + 1) * y - 2 is one XLA program in the JAX
    # package's fused stage, which XLA may contract into an FMA
    _shared(monkeypatch, CHAINS[name],
            rtol=RTOL if name in ("map_rows_chain", "map_blocks_chain")
            else 0.0)


def test_cross_row_map_blocks_fuses(monkeypatch):
    # z = x - mean(x) is cross-row but row-preserving: fusable; the mean's
    # summation order is each framework's own
    _shared(monkeypatch, lambda df: (
        df.map_blocks(lambda x: {"a": x - x.mean()})
          .map_blocks(lambda a: {"b": a * 3.0})), rtol=RTOL)


def test_filter_after_row_growing_trim(monkeypatch):
    # the mask length is the TRIM output's row count, not the stage
    # input's
    def j():
        return jtf.frame({"x": np.arange(4.0)}, num_partitions=1)

    def t():
        return to_port(j())
    _both_packages(
        monkeypatch, j, t,
        lambda df: (df.map_blocks(lambda x: {"y": jnp.concatenate([x, x])},
                                  trim=True)
                      .filter(lambda y: y < 2.0)),
        lambda df: (df.map_blocks(lambda x: {"y": torch.cat([x, x])},
                                  trim=True)
                      .filter(lambda y: y < 2.0)))


@pytest.mark.parametrize("parts", [1, 4])
def test_two_map_chain_partitions(monkeypatch, parts):
    _shared(monkeypatch, lambda df: (
        df.map_blocks(lambda x: {"a": x + 1.0})
          .map_blocks(lambda a: {"b": a * 2.0})), parts=parts)


def test_empty_partitions(monkeypatch):
    def j():
        return jtf.frame({"x": np.arange(3.0)}, num_partitions=1) \
            .repartition(5)

    def t():
        return to_port(jtf.frame({"x": np.arange(3.0)}, num_partitions=1)) \
            .repartition(5)
    chain = _both_packages(
        monkeypatch, j, t,
        *(2 * (lambda df: (df.map_blocks(lambda x: {"a": x + 1.0})
                             .map_blocks(lambda a: {"b": a * 2.0})),)))
    assert [b.num_rows for b in chain.blocks()] == [1, 1, 1, 0, 0]


def test_collect_and_count_equal(monkeypatch):
    j, t = _pair()
    jdf, tdf = j(), t()

    def build(df):
        return df.map_blocks(lambda x: {"a": x + 1.0}) \
                 .filter(lambda a: a > 10.0)
    chain = build(tdf)
    n1, rows1 = chain.count(), chain.collect()
    assert chain._plan_info
    assert n1 == build(jdf).count() == 87
    monkeypatch.setenv("TFT_FUSE", "0")
    chain0 = build(tdf)
    assert chain0.count() == n1
    for r1, r0 in zip(rows1, chain0.collect()):
        for a, b in zip(r1, r0):
            if isinstance(b, np.ndarray):
                assert np.array_equal(np.asarray(a), b)
            else:
                assert a == b


def test_reduction_over_fused_chain(monkeypatch):
    j, t = _pair()

    def chain(df):
        return df.map_blocks(lambda x: {"a": x + 1.0}) \
                 .map_blocks(lambda a: {"a_sq": a * a}).select(["a"])
    out1 = ttf.reduce_blocks(lambda a_input: {"a": a_input.sum()},
                             chain(t()))
    jout = jtf.reduce_blocks(lambda a_input: {"a": a_input.sum()},
                             chain(j()))
    monkeypatch.setenv("TFT_FUSE", "0")
    out0 = ttf.reduce_blocks(lambda a_input: {"a": a_input.sum()},
                             chain(t()))
    assert out1 == out0
    np.testing.assert_allclose(out1, jout, rtol=RTOL)


def test_fused_chain_into_keyed_aggregate(monkeypatch):
    # the slice's path: a fused chain ending in aggregate's float sum
    # (segment_sum's plain version on the CPU)
    j, t = _pair(parts=3)

    def chain(df):
        return df.map_blocks(lambda x, y: {"a": x * y}) \
                 .filter(lambda x: x >= 40.0) \
                 .map_rows(lambda a: {"w": a * 2.0}).select(["k", "w"])
    tc = chain(t())
    got = ttf.aggregate({"w": "sum"}, tc.group_by("k"))
    assert tc._plan_info
    want = jtf.aggregate({"w": "sum"}, chain(j()).group_by("k"))
    assert_frames_match(want, got, rtol=RTOL)
    monkeypatch.setenv("TFT_FUSE", "0")
    got0 = ttf.aggregate({"w": "sum"}, chain(t()).group_by("k"))
    assert_frames_match(got0, got)


# ---------------------------------------------------------------------------
# fallback: unplannable chains keep per-op semantics in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stop", [2, 61])
def test_row_count_violation_still_raises(stop):
    # x[:stop] is not provably row-preserving: v[:61] is Unknown to the
    # port's capture (61, 61, 2 rows in its probes), yet keeps 61 rows
    def chain(df):
        return df.select(["x"]).map_blocks(lambda x: {"z": x[:stop]}) \
                 .map_blocks(lambda z: {"w": z + 1.0})
    j, t = _pair(parts=1)  # one 97-row block
    jc, tc = chain(j()), chain(t())
    assert build_plan(tc) is None and jbuild(jc) is None
    with pytest.raises(JInvalidShape, match="trim"):
        jc.blocks()
    with pytest.raises(InvalidShapeError, match="trim"):
        tc.blocks()
    assert tc._plan_info is None


def test_slice_to_61_rows_on_61_row_blocks_stays_per_op(monkeypatch):
    # v[:61] on 61-row blocks keeps every row, so the per-op path runs;
    # it must still not fuse as row-preserving
    def chain(df):
        return df.map_blocks(lambda v: {"u": v[:61]}) \
                 .map_blocks(lambda u: {"t": u * 2.0})
    _shared(monkeypatch, chain, parts=2, rows=122, expect_fused=False)


def test_ragged_inputs_fall_back(monkeypatch):
    def j():
        return jtf.frame(
            [(1.0, np.arange(2.0)), (2.0, np.arange(5.0))],
            columns=["x", "r"]).analyze()

    def t():
        return ttf.frame(
            [(1.0, np.arange(2.0)), (2.0, np.arange(5.0))],
            columns=["x", "r"]).analyze()

    def chain(df):
        return df.map_rows(lambda r: {"n": r.sum()}) \
                 .map_rows(lambda n: {"m": n * 2.0})
    jc, tc = chain(j()), chain(t())
    assert_frames_match(jc, tc)
    assert tc._plan_info is None and jc._plan_info is None
    monkeypatch.setenv("TFT_FUSE", "0")
    _assert_identical(_snapshot(tc), _snapshot(chain(t())))


def test_explicit_executor_disables_planning():
    _, t = _pair()
    ex = BlockExecutor(device="cpu")
    chain = t().map_blocks(lambda x: {"a": x + 1.0}, executor=ex) \
               .map_blocks(lambda a: {"b": a * 2.0}, executor=ex)
    chain.blocks()
    assert chain._plan_info is None and chain._plan_node is None


def test_single_op_stays_per_op():
    j, t = _pair()
    one, jone = t().map_blocks(lambda x: {"a": x + 1.0}), \
        j().map_blocks(lambda x: {"a": x + 1.0})
    assert build_plan(one) is None and jbuild(jone) is None
    one.blocks()
    assert one._plan_info is None


def test_empty_final_schema_stays_per_op(monkeypatch):
    def chain(df):
        return df.map_blocks(lambda x: {"z": x[: x.shape[0] // 2]},
                             trim=True) \
                 .map_blocks(lambda z: {"w": z + 1.0}).select([])
    df = ttf.frame({"x": np.arange(8.0)}, num_partitions=2)
    c = chain(df)
    n1 = c.count()
    assert c._plan_info is None
    assert jbuild(chain(jtf.frame({"x": np.arange(8.0)},
                                  num_partitions=2))) is None
    monkeypatch.setenv("TFT_FUSE", "0")
    assert chain(df).count() == n1 == 4


def test_fuse_env_kill_switch(monkeypatch):
    monkeypatch.setenv("TFT_FUSE", "0")
    _, t = _pair()
    chain = t().map_blocks(lambda x: {"a": x + 1.0}) \
               .map_blocks(lambda a: {"b": a * 2.0})
    chain.blocks()
    assert chain._plan_info is None


# ---------------------------------------------------------------------------
# fewer dispatches, device-resident stages
# ---------------------------------------------------------------------------

def test_fused_chain_is_one_dispatch_per_block(monkeypatch):
    _, t = _pair(parts=4)
    df = t()

    def units(build):
        before = counters.get("pipeline.submitted") \
            + counters.get("pipeline.drained")
        build().blocks()
        return (counters.get("pipeline.submitted")
                + counters.get("pipeline.drained")) - before

    def chain():
        return (df.map_blocks(lambda x: {"a": x + 1.0})
                  .map_blocks(lambda a: {"b": a * 2.0})
                  .map_blocks(lambda b: {"c": b - 1.0})
                  .map_blocks(lambda c: {"d": c * 0.5}))
    fused = units(chain)
    monkeypatch.setenv("TFT_FUSE", "0")
    unfused = units(chain)
    assert fused == 2 * 4 and unfused == 4 * fused


def test_later_stage_runs_on_device_resident_inputs(monkeypatch):
    # map -> filter -> map: two stages; the second stage's input is the
    # first's device output, so only the first converts host->device
    _, t = _pair(parts=4)
    chain = CHAINS["device_resident_stage_chaining"](t())
    tracing.enable()
    try:
        tracing.timings.reset()
        chain.blocks()
        spans = tracing.timings.snapshot()
    finally:
        tracing.disable()
    assert len(build_plan(chain).stages) == 2
    assert spans["executor.convert"]["count"] == 4
    assert spans["executor.dispatch"]["count"] == 8
    text = "\n".join(chain._plan_info)
    assert "device-resident" in text and "mask applied host-side" in text


def test_fused_oom_falls_back_to_per_op(monkeypatch):
    from tensorframes_tpu_torch.plan import execute
    _, t = _pair()
    chain = CHAINS["map_blocks_chain"](t())
    want = _snapshot(CHAINS["map_blocks_chain"](t()))

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("injected")
    monkeypatch.setattr(execute, "_run", oom)
    before = counters.get("plan.oom_fallbacks")
    got = _snapshot(chain)
    # the outer chain, then its inner two-op chain, each fall back
    assert counters.get("plan.oom_fallbacks") == before + 2
    assert chain._plan_info is None
    _assert_identical(got, want)


def test_composed_computation_does_not_probe_its_members(monkeypatch):
    import tensorframes_tpu_torch.computation as comp_mod
    _, t = _pair()
    chain = CHAINS["map_blocks_chain"](t())
    plan = build_plan(chain)  # proofs probe each member once, cached
    calls = []
    real = comp_mod._run_probe
    monkeypatch.setattr(comp_mod, "_run_probe",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    from tensorframes_tpu_torch.plan import optimize
    monkeypatch.setattr(optimize, "_run_probe", comp_mod._run_probe)
    again = build_plan(chain)
    assert calls == []
    assert again.stages[0].comp is not plan.stages[0].comp


# ---------------------------------------------------------------------------
# plan-derived estimates
# ---------------------------------------------------------------------------

def _est_pair(cols, parts, build):
    jf = jtf.frame(cols, num_partitions=parts)
    return jestimate(build(jf)), frame_estimate(build(to_port(jf)))


def test_select_prices_per_column_not_schema_ratio():
    rows = 1000
    j, t = _est_pair({"x": np.arange(float(rows)), "v": np.ones((rows, 8))},
                     2, lambda df: df.select(["x"]))
    assert t == j == (rows, rows * 8)


def test_map_adds_fetch_bytes():
    rows = 500
    j, t = _est_pair({"x": np.arange(float(rows))}, 2,
                     lambda df: df.map_blocks(lambda x: {"a": x + 1.0}))
    assert t == j == (rows, 2 * rows * 8)


def test_unforced_estimate_comes_from_plan():
    rows = 256
    jf = jtf.frame({"x": np.arange(float(rows)),
                    "pad": np.ones((rows, 16))}, num_partitions=2)
    for df, est in ((jf, jestimate), (to_port(jf), frame_estimate)):
        chain = df.select(["x"]).map_blocks(lambda x: {"a": x * 2.0})
        assert chain._cache is None
        chain._rows_hint = None
        chain._bytes_hint = None
        assert est(chain) == (rows, 2 * rows * 8)
        assert chain.estimated_rows() == rows
        assert chain.estimated_bytes() == 2 * rows * 8


def test_filter_estimate_is_upper_bound_then_observed():
    def build(df):
        return df.filter(lambda x: x > 1e9) \
                 .map_blocks(lambda x: {"a": x + 1.0})
    j, t = _est_pair({"x": np.arange(100.0)}, 2, build)
    assert t == j and t[0] == 100
    df = ttf.frame({"x": np.arange(100.0)}, num_partitions=2)
    pred = lambda x: x >= 75.0  # noqa: E731
    df.filter(pred).map_blocks(lambda x: {"a": x + 1.0}).blocks()
    # the forcing observed 25 of 100 rows kept; a new chain over the same
    # predicate prices it
    rows, _ = frame_estimate(df.filter(pred)
                             .map_blocks(lambda x: {"a": x + 1.0}))
    assert rows == 25


# ---------------------------------------------------------------------------
# explain() renders the plan
# ---------------------------------------------------------------------------

def test_plan_section_in_explain():
    _, t = _pair()
    chain = CHAINS["device_resident_stage_chaining"](t())
    tracing.enable()
    try:
        chain.blocks()
        report = chain.explain()
    finally:
        tracing.disable()
    assert "plan" in report
    assert "fused stage" in report
    assert "1 dispatch/block" in report
    assert "plan.execute" in report


def test_no_plan_section_when_fusion_off(monkeypatch):
    monkeypatch.setenv("TFT_FUSE", "0")
    _, t = _pair()
    chain = t().map_blocks(lambda x: {"a": x + 1.0}) \
               .map_blocks(lambda a: {"b": a * 2.0})
    report = chain.explain()  # forces once with tracing on
    assert "fused stage" not in report
    assert "executor.dispatch" in report
    assert not tracing.enabled()


# ---------------------------------------------------------------------------
# parquet: pruning and row-group pushdown, against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture
def six_col_file(tmp_path):
    path = str(tmp_path / "six.parquet")
    cols = {f"c{i}": np.arange(40.0) + 10 * i for i in range(6)}
    jio.write_parquet(jtf.frame(cols, num_partitions=4), path)
    return path, cols


def _decoded(monkeypatch):
    names = []
    real = tio._column_to_numpy
    monkeypatch.setattr(tio, "_column_to_numpy",
                        lambda col, name: names.append(name)
                        or real(col, name))
    return names


def test_chain_reads_only_referenced_columns(six_col_file, monkeypatch):
    path, cols = six_col_file
    decoded = _decoded(monkeypatch)
    chain = tio.read_parquet(path) \
        .map_blocks(lambda c1, c4: {"s": c1 + c4}).select(["s"])
    out = chain.blocks()
    assert chain._plan_info and "pruned" in "\n".join(chain._plan_info)
    assert set(decoded) == {"c1", "c4"}
    got = np.concatenate([b.columns["s"] for b in out])
    assert np.array_equal(got, cols["c1"] + cols["c4"])


def _parquet_pair(path, **kw):
    return (lambda: jio.read_parquet(path, **kw),
            lambda: tio.read_parquet(path, **kw))


def test_pruned_chain_equals_unfused_and_jax(six_col_file, monkeypatch):
    path, _ = six_col_file
    build = lambda df: (df.map_blocks(lambda c0, c2: {"s": c0 * c2})  # noqa
                          .filter(lambda s: s > 100.0)
                          .select(["s", "c0"]))
    _both_packages(monkeypatch, *_parquet_pair(path), build, build)


def test_select_only_chain_prunes_scan(six_col_file, monkeypatch):
    path, cols = six_col_file
    decoded = _decoded(monkeypatch)
    out = tio.read_parquet(path).select(["c3"]).blocks()
    assert set(decoded) == {"c3"}
    assert np.array_equal(
        np.concatenate([b.columns["c3"] for b in out]), cols["c3"])


def test_empty_row_group_with_pruned_mid_select(tmp_path, monkeypatch):
    path = str(tmp_path / "er.parquet")
    src = jtf.frame({"a": np.arange(3.0), "b": np.ones(3)},
                    num_partitions=1).repartition(4)  # one 0-row group
    jio.write_parquet(src, path)
    build = lambda df: (df.select(["a", "b"])  # noqa: E731
                          .map_rows(lambda a: {"x": a * 2.0})
                          .select(["x"]))
    _both_packages(monkeypatch, *_parquet_pair(path), build, build)


def test_forcing_leaf_directly_reads_everything(six_col_file):
    path, cols = six_col_file
    df = tio.read_parquet(path)
    assert set(df.blocks()[0].columns) == set(cols)
    assert df.num_partitions == 4


@pytest.mark.parametrize("pred,kept_groups", [
    (lambda c0: c0 >= 20.0, 2),           # groups of 10 rows: 0-9, ...
    (lambda c0, c1: (c0 < 15.0) & (c1 > 12.0), 2),
    (lambda c0: c0 > 100.0, 0),
    (lambda c0: c0 + 1.0 > 20.0, 4),      # not an atom: nothing refuted
])
def test_row_group_pushdown_matches_jax(six_col_file, monkeypatch, pred,
                                        kept_groups):
    path, _ = six_col_file

    def build(df):
        return df.filter(pred).map_blocks(lambda c0: {"z": c0 * 2.0}) \
                 .select(["z"])
    sk = ("plan.pushdown_groups_skipped", "plan.pushdown_bytes_skipped")
    t0 = [counters.get(k) for k in sk] + [
        counters.get("io.parquet_row_groups_read")]
    j0 = [jcounters.get(k) for k in sk]
    _both_packages(monkeypatch, *_parquet_pair(path), build, build)
    t_skip = [counters.get(k) - v for k, v in zip(sk, t0)]
    j_skip = [jcounters.get(k) - v for k, v in zip(sk, j0)]
    assert t_skip == j_skip
    assert t_skip[0] == 4 - kept_groups
    # the fused run read only the kept groups, the unfused run all 4
    assert counters.get("io.parquet_row_groups_read") - t0[2] == \
        kept_groups + 4


@pytest.mark.parametrize("remake,atoms,kept", [
    # c0 dropped by the select and made again: the file's c0 statistics
    # say nothing of it, so nothing is pushed and every row is kept
    (lambda df: df.map_blocks(lambda c1: {"c0": c1 * 0.0 + 1e9}), [], 40),
    (lambda df: df.map_rows(lambda c1: {"c0": c1 * 0.0 + 1e9}), [], 40),
    # c0 kept by the select: still the file's values, still pushed
    (lambda df: df.map_blocks(lambda c1: {"z": c1 + 1.0}),
     [("c0", "ge", 100.0)], 0),
])
def test_pushdown_only_over_columns_still_from_the_scan(
        six_col_file, monkeypatch, remake, atoms, kept):
    path, _ = six_col_file

    def build(keep):
        return remake(tio.read_parquet(path).select(keep)) \
            .filter(lambda c0: c0 >= 100.0)
    keep = ["c1"] if atoms == [] else ["c0", "c1"]
    chain = build(keep)
    plan = build_plan(chain)
    assert [(a.column, a.op, a.value) for a in plan.scan_atoms] == atoms
    fused = _snapshot(chain)
    assert chain._plan_info
    assert sum(n for n, _ in fused) == kept
    monkeypatch.setenv("TFT_FUSE", "0")
    _assert_identical(fused, _snapshot(build(keep)))


def test_repartitioned_scan_pushes_down_and_remaps(six_col_file,
                                                   monkeypatch):
    path, _ = six_col_file
    build = lambda df: (df.filter(lambda c0: c0 >= 25.0)  # noqa: E731
                          .map_blocks(lambda c1: {"z": c1 + 1.0}))
    _both_packages(monkeypatch, *_parquet_pair(path, num_partitions=3),
                   build, build)


# ---------------------------------------------------------------------------
# predicate atoms against the JAX package's
# ---------------------------------------------------------------------------

def _jcomp(fn, cols):
    from tensorframes_tpu import dtypes as jdt
    from tensorframes_tpu.computation import Computation as JComputation
    from tensorframes_tpu.computation import TensorSpec as JSpec
    from tensorframes_tpu.shape import Shape as JShape
    return JComputation.trace(fn, [JSpec(n, jdt.by_name(t), JShape(-1))
                                   for n, t in cols.items()])


def _tcomp(fn, cols):
    from tensorframes_tpu_torch import dtypes as tdt
    return Computation.trace(fn, [TensorSpec(n, tdt.by_name(t),
                                             Shape(Unknown))
                                  for n, t in cols.items()])


ATOM_CASES = {
    "ge_literal": (lambda ts: ts >= 10_000_000, None, {"ts": "long"}),
    "literal_left": (lambda x: 2.0 < x, None, {"x": "double"}),
    "conjunction": (lambda x, y: (x > 3.0) & (y <= 0.5) & (x == 4.0), None,
                    {"x": "double", "y": "double"}),
    "widening_cast": (lambda x: x.astype(jnp.float64) > 3.0,
                      lambda x: x.double() > 3.0, {"x": "float"}),
    "narrowing_cast": (lambda x: x.astype(jnp.int32) > 3,
                       lambda x: x.to(torch.int32) > 3, {"x": "double"}),
    "disjunction": (lambda x: (x > 3.0) | (x < 1.0), None, {"x": "double"}),
    "arithmetic": (lambda x: x % 4.0 == 0.0, None, {"x": "double"}),
    "two_columns": (lambda x, y: x > y, None, {"x": "double",
                                               "y": "double"}),
}


@pytest.mark.parametrize("name", sorted(ATOM_CASES))
def test_extract_atoms_matches_jax(name):
    jfn, tfn, cols = ATOM_CASES[name]
    want = [tuple(a) for a in jatoms(_jcomp(jfn, cols))]
    got = [(a.column, a.op, a.value)
           for a in extract_atoms(_tcomp(tfn or jfn, cols))]
    assert got == want
    if name in ("narrowing_cast", "disjunction", "arithmetic",
                "two_columns"):
        assert got == []


def test_tensor_literal_is_read():
    comp = _tcomp(lambda x: x > torch.tensor(3.0, dtype=torch.float64),
                  {"x": "double"})
    assert extract_atoms(comp) == [Atom("x", "gt", 3.0, torch.float64)]


@pytest.mark.parametrize("atom,lo,hi,want", [
    (Atom("x", "ge", 10.0, torch.int64), 0, 9, True),
    (Atom("x", "ge", 10.0, torch.int64), 0, 10, False),
    (Atom("x", "gt", 3.0, torch.float64), 0.0, 3.0, True),
    (Atom("x", "lt", 3.0, torch.float64), 3.0, 9.0, True),
    (Atom("x", "le", 3.0, torch.float64), 3.0, 9.0, False),
    (Atom("x", "eq", 5.0, torch.float64), 6.0, 9.0, True),
    # torch compares an int column with a float literal in float32, where
    # 16777216 >= 16777217.0 holds: never refuted
    (Atom("x", "ge", 16777217.0, torch.float32), 0, 16777216, False),
    (Atom("x", "ge", 16777217.0, torch.int64), 0, 16777216, True),
    (Atom("x", "gt", 0.0, torch.int64), 0, 2 ** 60, False),
    (Atom("x", "gt", 0.0, None), None, 5, False),
])
def test_refutes(atom, lo, hi, want):
    assert refutes(atom, lo, hi, torch.int64) is want
