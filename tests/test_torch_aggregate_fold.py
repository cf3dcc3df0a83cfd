"""The computation form of ``aggregate`` through the port's segmented fold,
held against the JAX package's ``aggregate`` (whose fold is one jitted
``associative_scan``) on the same numpy inputs, and against the port's own
``CompactionBuffer`` path.

Tolerances: f64 rtol 1e-12 and f32 rtol 1e-5. The port's scan follows
``jax.lax.associative_scan``'s odd/even recursion level for level, so the
partials meet in the same tree; only the rounding of each combine may
differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu_torch import memory as tmem
from tensorframes_tpu_torch.computation import Computation
from tensorframes_tpu_torch.engine import ops as tops
from tensorframes_tpu_torch.engine.executor import BlockExecutor
from tensorframes_tpu_torch.utils import tracing as ttracing
from tensorframes_tpu_torch.utils.tracing import counters as tcounters
from torch_parity import assert_frames_match, to_port

RTOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    tcounters.reset()
    yield
    ttf.set_default_device(prev)


def _pair(cols, parts=1):
    j = jtf.analyze(jtf.frame(cols, num_partitions=parts))
    return j, to_port(j)


def _norm_j(x_input):
    return {"x": jnp.sqrt((x_input ** 2).sum(0))}


def _norm_t(x_input):
    return {"x": torch.sqrt((x_input ** 2).sum(0))}


class _OtherExecutor(BlockExecutor):
    """An executor of another kind than the default: the selection rule
    keeps the computation form on the CompactionBuffer path."""


def test_aggregate_generic_many_groups_single_program():
    """Mirrors ``test_ops.py::test_aggregate_generic_many_groups_single_
    program``: 10,000 keys in one block fold in O(log rows) vmapped calls,
    not one call per group."""
    rng = np.random.default_rng(5)
    n, G = 40_000, 10_000
    key = rng.integers(0, G, n).astype(np.int32)
    x = rng.standard_normal(n)
    j, t = _pair({"k": key, "x": x})
    jr = jtf.aggregate(_norm_j, j.group_by("k"))
    tr = ttf.aggregate(_norm_t, t.group_by("k"))
    assert_frames_match(jr, tr, rtol=1e-12)
    calls = tcounters.get("aggregate.fold_calls")
    # two vmapped calls a level of the scan, then one over the table
    assert 0 < calls <= 2 * int(np.ceil(np.log2(n))) + 1
    assert tcounters.get("aggregate.buffer_calls") == 0
    got = {r["k"]: r["x"] for r in tr.collect()}
    assert len(got) == len(np.unique(key))
    for k in list(got)[:50]:
        np.testing.assert_allclose(got[k], np.sqrt((x[key == k] ** 2).sum()),
                                   rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["single_row_groups", "one_group",
                                  "several_blocks", "vector_cells"])
def test_fold_matches_the_jax_package(case, dtype):
    rng = np.random.default_rng(11)
    n = 3_001
    parts = 1
    if case == "single_row_groups":
        key = rng.permutation(n)
    elif case == "one_group":
        key = np.full(n, 7)
    else:
        key = rng.integers(0, 97, n)
        parts = 4 if case == "several_blocks" else 1
    x = rng.standard_normal((n, 3) if case == "vector_cells" else n)
    j, t = _pair({"k": key, "x": x.astype(dtype)}, parts)
    jr = jtf.aggregate(lambda x_input: {"x": jnp.sum(x_input, axis=0)},
                       j.group_by("k"))
    tr = ttf.aggregate(lambda x_input: {"x": torch.sum(x_input, dim=0)},
                       t.group_by("k"))
    assert_frames_match(jr, tr, rtol=RTOL[dtype])
    assert tcounters.get("aggregate.fold_calls") > 0
    assert tcounters.get("aggregate.buffer_calls") == 0


def test_fold_of_two_fetches_with_a_norm(rng):
    n = 2_000
    cols = {"k": rng.integers(0, 50, n), "x": rng.standard_normal(n),
            "v": rng.standard_normal((n, 2))}
    j, t = _pair(cols, parts=3)
    jr = jtf.aggregate(lambda x_input, v_input: {
        "x": jnp.sqrt((x_input ** 2).sum(0)), "v": v_input.max(0)},
        j.group_by("k"))
    tr = ttf.aggregate(lambda x_input, v_input: {
        "x": torch.sqrt((x_input ** 2).sum(0)), "v": v_input.amax(0)},
        t.group_by("k"))
    assert_frames_match(jr, tr, rtol=1e-12)


def test_fold_of_a_deserialized_program(rng):
    """The port folds a deserialized program too (it vmaps the placed
    module); the JAX package keeps those on its buffer path. Same
    values."""
    n = 1_500
    cols = {"k": rng.integers(0, 40, n), "x": rng.standard_normal(n)}
    j, t = _pair(cols, parts=2)
    jc = jtf.Computation.deserialize(jtf.Computation.trace(
        _norm_j, {"x_input": (jtf.dtypes.double,
                              jtf.Shape((jtf.Unknown,)))}).serialize())
    tc = Computation.deserialize(Computation.trace(
        _norm_t, {"x_input": (ttf.dtypes.double,
                              ttf.Shape((ttf.Unknown,)))}).serialize())
    jr = jtf.aggregate(jc, j.group_by("k"))
    tr = ttf.aggregate(tc, t.group_by("k"))
    assert_frames_match(jr, tr, rtol=1e-12)
    assert tcounters.get("aggregate.fold_calls") > 0
    assert tcounters.get("aggregate.buffer_calls") == 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fold_matches_the_compaction_buffer_path(dtype):
    rng = np.random.default_rng(2)
    n = 4_000
    df = ttf.analyze(ttf.frame({"k": rng.integers(0, 300, n),
                                "x": rng.standard_normal(n).astype(dtype)},
                               num_partitions=3))
    fold = ttf.aggregate(_norm_t, df.group_by("k"))
    assert tcounters.get("aggregate.fold_calls") > 0
    tcounters.reset()
    buf = ttf.aggregate(_norm_t, df.group_by("k"),
                        executor=_OtherExecutor("cpu"))
    assert tcounters.get("aggregate.fold_calls") == 0
    assert tcounters.get("aggregate.buffer_calls") > 0
    a, b = fold.blocks()[0], buf.blocks()[0]
    np.testing.assert_array_equal(a.columns["k"], b.columns["k"])
    assert a.columns["x"].dtype == b.columns["x"].dtype == dtype
    np.testing.assert_allclose(a.columns["x"], b.columns["x"],
                               rtol=RTOL[dtype])


def test_selection_rule():
    """The fold runs under the default executor and under an explicit
    ``BlockExecutor``; an executor of another kind keeps the buffer path."""
    df = ttf.analyze(ttf.frame({"k": np.array([0, 1, 0, 1, 2]),
                                "x": np.arange(5.0)}))
    for ex, fold in ((None, True), (BlockExecutor("cpu"), True),
                     (_OtherExecutor("cpu"), False)):
        tcounters.reset()
        out = ttf.aggregate(lambda x_input: {"x": torch.sum(x_input, 0)},
                            df.group_by("k"), executor=ex)
        np.testing.assert_array_equal(out.blocks()[0].columns["x"],
                                      [2.0, 4.0, 4.0])
        assert (tcounters.get("aggregate.fold_calls") > 0) == fold
        assert (tcounters.get("aggregate.buffer_calls") > 0) == (not fold)


def test_a_program_vmap_cannot_batch_raises_naming_the_fold():
    df = ttf.analyze(ttf.frame({"k": np.array([0, 1, 0]),
                                "x": np.arange(3.0)}))

    def branchy(x_input):
        if x_input.sum() > 0:  # data-dependent control flow
            return {"x": x_input.sum(0)}
        return {"x": x_input.max(0).values}

    with pytest.raises(tops.FoldBatchingError,
                       match="segmented fold.*torch.func.vmap"):
        ttf.aggregate(branchy, df.group_by("k"))


def test_a_program_calling_segment_sum_raises_by_the_same_rule():
    """B1's op has no batching rule, so a computation-form aggregate whose
    program calls it cannot fold: it raises, naming the fold."""
    from tensorframes_tpu_torch.ops.segment_reduce import segment_sum
    df = ttf.analyze(ttf.frame({"k": np.array([0, 1, 0]),
                                "x": np.arange(3.0)}))

    def via_b1(x_input):
        ids = torch.zeros(x_input.shape[0], dtype=torch.int32)
        return {"x": segment_sum(x_input, ids, 1)[0]}

    with pytest.raises(tops.FoldBatchingError, match="no batching rule"):
        ttf.aggregate(via_b1, df.group_by("k"))


def test_fold_reserves_and_releases_and_opens_its_span():
    rng = np.random.default_rng(3)
    df = ttf.analyze(ttf.frame({"k": rng.integers(0, 4, 5000),
                                "x": rng.standard_normal(5000)},
                               num_partitions=2))
    mgr = tmem.configure(limit_bytes=10 ** 9)
    seen = []
    real = mgr.reserve

    def spy(nbytes, op="dispatch"):
        seen.append((nbytes, op))
        return real(nbytes, op)
    mgr.reserve = spy
    ttracing.enable()
    ttracing.timings.reset()
    try:
        ttf.aggregate(_norm_t, df.group_by("k"))
        spans = ttracing.timings.snapshot()
    finally:
        ttracing.disable()
        tmem._reset()
    folds = [s for s in seen if s[1] == "aggregate.segmented_fold"]
    # 2x the f64 values and the int64 ids of each block, then of the
    # second pass's 8 partial rows
    assert [n for n, _ in folds] == [2 * 2500 * 8 + 2500 * 8] * 2 \
        + [2 * 8 * 8 + 8 * 8]
    assert mgr.snapshot()["inflight_bytes"] == 0
    assert spans["aggregate.segmented_fold"]["count"] == 3
