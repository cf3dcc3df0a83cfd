"""The port's segment_sum (its plain version, on the CPU) against the JAX
package's segment_sum through XLA and the Pallas interpreter.

Tolerances: f64 to rtol 1e-12 (only the summation order differs), f32 to
rtol 1e-5, bf16 compared in f32 to rtol 2e-2 (8 bits of mantissa). The
Pallas interpreter accumulates in f32 whatever the values' dtype
(``segment_reduce.py:58-59`` of the JAX package), so against it f64 holds
to the f32 tolerance; against XLA's exact f64 it holds to 1e-12. The
CUDA kernel itself runs only on a GPU; chip_smoke.py holds it against
segment_sum_reference there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu.ops import segment_sum as jax_segment_sum
from tensorframes_tpu_torch.ops import segment_reduce
from tensorframes_tpu_torch.ops.segment_reduce import (
    plan_sort, segment_sum, segment_sum_reference)

TOL = {"float64": (1e-12, 1e-12), "float32": (1e-5, 1e-5),
       "bfloat16": (2e-2, 2e-2)}
JAX_IMPLS = ["xla", "interpret"]


def _torch(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(getattr(torch, dtype))


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _check(vals, ids, s, dtype, impl, block_rows=16):
    ref = jax_segment_sum(_jax(vals, dtype), jnp.asarray(ids, jnp.int32), s,
                          impl=impl, block_rows=block_rows)
    out = segment_sum(_torch(vals, dtype), torch.from_numpy(ids), s)
    assert tuple(out.shape) == tuple(ref.shape)
    assert out.dtype == getattr(torch, dtype)
    rtol, atol = TOL["float32" if (impl, dtype) == ("interpret", "float64")
                     else dtype]
    np.testing.assert_allclose(out.float().numpy() if dtype == "bfloat16"
                               else out.numpy(),
                               np.asarray(ref, np.float32 if dtype == "bfloat16"
                                          else None),
                               rtol=rtol, atol=atol)
    return out


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
class TestSegmentSumParity:
    def test_matches(self, rng, dtype, impl):
        vals = rng.standard_normal((100, 5))
        ids = rng.integers(0, 7, 100).astype(np.int32)
        _check(vals, ids, 7, dtype, impl)

    def test_out_of_range_ids_dropped(self, dtype, impl):
        vals = np.ones((10, 2))
        ids = np.asarray([0, 1, -1, 2, 5, 1, 0, -1, 2, 1], np.int32)
        out = _check(vals, ids, 3, dtype, impl, block_rows=4)
        assert float(out.float().sum()) == pytest.approx(2 * 7)

    def test_n_not_multiple_of_block(self, rng, dtype, impl):
        vals = rng.standard_normal((37, 3))
        ids = rng.integers(0, 5, 37).astype(np.int32)
        _check(vals, ids, 5, dtype, impl, block_rows=16)

    def test_1d_values(self, rng, dtype, impl):
        vals = rng.standard_normal(50)
        ids = rng.integers(0, 4, 50).astype(np.int32)
        out = _check(vals, ids, 4, dtype, impl, block_rows=8)
        assert tuple(out.shape) == (4,)

    def test_nd_values(self, rng, dtype, impl):
        vals = rng.standard_normal((30, 2, 3))
        ids = rng.integers(0, 5, 30).astype(np.int32)
        out = _check(vals, ids, 5, dtype, impl, block_rows=8)
        assert tuple(out.shape) == (5, 2, 3)

    def test_empty(self, dtype, impl):
        out = _check(np.zeros((0, 3)), np.zeros((0,), np.int32), 4, dtype,
                     impl)
        np.testing.assert_array_equal(out.float().numpy(), np.zeros((4, 3)))


def test_int64_ids_match_int32(rng):
    vals = torch.from_numpy(rng.standard_normal((64, 3)))
    ids = rng.integers(-2, 9, 64)
    a = segment_sum(vals, torch.from_numpy(ids), 8)
    b = segment_sum(vals, torch.from_numpy(ids.astype(np.int32)), 8)
    assert torch.equal(a, b)


def test_int_values_routed_to_exact_path(rng):
    vals = rng.integers(-5, 5, (40, 2)).astype(np.int32)
    ids = rng.integers(0, 3, 40).astype(np.int32)
    out = segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), 3)
    ref = np.zeros((3, 2), np.int64)
    np.add.at(ref, ids, vals.astype(np.int64))
    np.testing.assert_array_equal(out.numpy().astype(np.int64), ref)
    assert out.dtype == torch.int32
    jref = jax_segment_sum(jnp.asarray(vals), jnp.asarray(ids), 3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jref))
    # the kernel takes float values only: an explicit request on ints is an
    # error, not a silent detour
    with pytest.raises(ValueError, match="integer"):
        segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), 3,
                    impl="cuda")


def test_unknown_impl_rejected():
    vals = torch.zeros((4, 2), dtype=torch.int32)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="Unknown segment_sum impl"):
        segment_sum(vals, ids, 1, impl="bogus")


def test_cpu_tensor_takes_plain_version_and_counts_no_launch(rng):
    before = segment_reduce.launches
    vals = torch.from_numpy(rng.standard_normal((20, 2)))
    ids = torch.from_numpy(rng.integers(0, 3, 20))
    out = segment_sum(vals, ids, 3)
    assert torch.equal(out, segment_sum_reference(vals, ids, 3))
    assert segment_reduce.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        segment_reduce.segment_sum_cuda(torch.zeros(4, 2), torch.zeros(
            4, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        segment_sum(torch.zeros(4, 2), torch.zeros(4, dtype=torch.int32), 2,
                    impl="cuda")


@pytest.mark.parametrize("n,d,s,acc", [
    (20_000_000 // 8, 1, 100_000, 8),   # chip_smoke phase 2, per block
    (2_000_000 // 8, 64, 1024, 4),      # chip_smoke phase 3, per block
    (1, 1, 1, 4), (300, 5, 7, 8), (1000, 200, 3, 4), (50, 64, 100_000, 8),
    (1 << 22, 1, 1 << 27, 4),           # the sort's most passes
    (2 ** 31 - 1, 1, 2 ** 31 - 1, 8)])  # the largest the kernel takes
def test_sort_plan_covers_every_row_and_fits(n, d, s, acc):
    plan = plan_sort(n, d, s, acc)
    # keys run over [0, s], the sentinel s included: passes follow its bits
    bits = s.bit_length()
    assert plan.passes == -(-bits // 9)
    assert plan.digit_bits * plan.passes >= bits
    assert 1 <= plan.digit_bits <= 9
    # each grid the kernel is launched on covers its work, none empty, and
    # fits the grid's x dimension
    assert plan.tile == 4096 and plan.tile % 8 == 0
    assert plan.lanes == (32 if d >= 32 else 8)
    groups = 256 // plan.lanes  # segments or pieces per block
    rows = n
    for k, (hr, hb) in enumerate(zip(plan.head_rows, plan.head_blocks)):
        assert rows > plan.piece_rows and hr == -(-rows // plan.piece_rows)
        assert (hb - 1) * groups < hr <= hb * groups
        rows = hr
    assert rows <= plan.piece_rows  # the last level is one piece
    assert len(plan.head_rows) <= 8
    for blocks, work, per in ((plan.sort_blocks, n, plan.tile),
                              (plan.offset_blocks, s + 1, 256),
                              (plan.segment_blocks, s, groups)):
        assert (blocks - 1) * per < work <= blocks * per
    for blocks in (plan.sort_blocks, plan.offset_blocks,
                   plan.segment_blocks) + plan.head_blocks:
        assert 1 <= blocks <= 2 ** 31 - 1
    # scratch is O(n) plus the offsets: 16 bytes a row for keys and row
    # indices, histograms of at most 512 digits per 4096 rows, S + 1
    # offsets, one partial row per piece at each level; buffers aligned
    # and disjoint
    sizes = {k: size for k, (_, size) in plan.layout.items()}
    assert sizes["keys"] == sizes["idx"] == 8 * n
    assert sizes["hist"] <= 512 * 4 * plan.sort_blocks
    assert sizes["offsets"] == 4 * (s + 1)
    partial_rows = sum(plan.head_rows)
    # n / piece + n / piece^2 + ..., each rounded up
    assert (partial_rows - len(plan.head_rows)) * (plan.piece_rows - 1) <= n
    assert sum(sizes[f"head{k}"] for k in range(len(plan.head_rows))) \
        == partial_rows * d * acc
    spans = sorted(plan.layout.values())
    for (at, size), (nxt, _) in zip(spans, spans[1:] + [(plan.scratch_bytes,
                                                          0)]):
        assert at % 256 == 0 and at + size <= nxt
    assert plan.scratch_bytes <= 16 * n + 2048 * plan.sort_blocks + 2048 \
        + 4 * (s + 1) + partial_rows * d * acc + 256 * len(plan.layout)
    # the C struct carries the same numbers; the wrapper's cached pair is
    # this plan and its struct
    cached, launch = segment_reduce._planned(n, d, s, acc)
    assert cached == plan
    assert (launch.tile, launch.sort_blocks, launch.digit_bits,
            launch.passes, launch.offset_blocks, launch.lanes, launch.piece,
            launch.segment_blocks, launch.levels) == (
        plan.tile, plan.sort_blocks, plan.digit_bits, plan.passes,
        plan.offset_blocks, plan.lanes, plan.piece_rows,
        plan.segment_blocks, len(plan.head_rows))
    levels = len(plan.head_rows)
    assert list(launch.head_rows)[:levels] == list(plan.head_rows)
    assert list(launch.head_blocks)[:levels] == list(plan.head_blocks)
    assert list(launch.at)[:5 + levels] == [at for at, _ in spans]


def _climb(a, b, k, piece):
    for _ in range(k):
        if a >= b:
            break
        a, b = a // piece + 1, (b - 1) // piece + 1
    return a, b


def _tree_sums(keys, vals, s, plan):
    """The kernel's reduction (head_kernel per level, then segment_kernel)
    replayed on the CPU over sorted ``keys`` and ``vals`` in sorted order,
    exact in int64. Partial rows no group writes are poisoned, so reading
    one fails. Returns each segment's sum and its longest run of terms
    added at one level."""
    piece, poison = plan.piece_rows, np.iinfo(np.int64).min
    offsets = np.searchsorted(keys, np.arange(s + 1), side="left")
    levels = [vals]
    for k, rows in enumerate(plan.head_rows):
        src, dst = levels[-1], np.full(rows, poison, np.int64)
        for e in range(1, rows):
            key = keys[e * piece ** (k + 1)]
            if key >= s:
                continue
            a, b = _climb(offsets[key], offsets[key + 1], k, piece)
            r0 = e * piece
            if a < r0 < b:
                dst[e] = src[r0:min(b, r0 + piece)].sum()
        levels.append(dst)
    out, longest = np.zeros(s, np.int64), 0
    for seg in range(s):
        a, b, k = offsets[seg], offsets[seg + 1], 0
        while a < b and k <= len(plan.head_rows):
            end = min(b, (a // piece + 1) * piece)
            terms = levels[k][a:end]
            assert (terms != poison).all(), (seg, k, a, end)
            out[seg] += terms.sum()
            longest = max(longest, end - a)
            a, b = _climb(a, b, 1, piece)
            k += 1
        assert a >= b, f"segment {seg} has rows past the tree's top"
    return out, longest


@pytest.mark.parametrize("n,d", [(70_001, 64), (2_200_003, 1)])
@pytest.mark.parametrize("spread", ["random", "hot", "single", "sparse"])
def test_piece_tree_sums_every_row_once(n, d, spread):
    # the kernel's level arithmetic at the plan's own pieces (64 rows for
    # d >= 32, 1,024 below), on two levels of partials or more: every row
    # of every segment counted once, none of the sentinel's, each level's
    # chain at most one piece
    rng = np.random.default_rng(n + len(spread))
    s = {"single": 1, "sparse": 5000}.get(spread, 700)
    ids = rng.integers(-1, s + 2, n)
    if spread == "hot":
        ids = np.where(rng.random(n) < 0.9, s // 2, ids)
    elif spread == "single":
        ids = np.zeros(n, np.int64)
    plan = plan_sort(n, d, s, 8)
    assert len(plan.head_rows) >= 2
    keys = np.where((ids >= 0) & (ids < s), ids, s)
    order = np.argsort(keys, kind="stable")
    vals = rng.integers(0, 1 << 20, n)
    got, longest = _tree_sums(keys[order], vals[order], s, plan)
    valid = keys < s
    want = np.bincount(keys[valid], weights=vals[valid], minlength=s)
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert longest <= plan.piece_rows


@pytest.mark.parametrize("n,s", [(2 ** 31, 10), (10, 2 ** 31), (0, 3),
                                 (3, 0)])
def test_sort_plan_refuses_what_the_kernel_cannot_index(n, s):
    with pytest.raises(ValueError):
        plan_sort(n, 1, s, 4)


def test_torch_export_records_the_segment_sum_op():
    """A program that calls ``segment_sum`` exports with the
    ``tft::segment_sum`` op in its graph (not the plain version's ops), so
    a shipped program launches the kernel wherever it is placed on the
    card; on the CPU the op runs the plain version."""
    from tensorframes_tpu_torch.computation import Computation, TensorSpec
    from tensorframes_tpu_torch.shape import Shape, Unknown
    from tensorframes_tpu_torch import dtypes as tdt

    def prog(v, k):
        return {"s": segment_sum(v, k, 5)}

    comp = Computation.trace(prog, [
        TensorSpec("v", tdt.double, Shape(Unknown, 2)),
        TensorSpec("k", tdt.int32, Shape(Unknown))])
    shipped = Computation.deserialize(comp.serialize())
    targets = {str(n.target) for n in shipped.fn.exported.graph.nodes
               if n.op == "call_function"}
    assert "tft.segment_sum.default" in targets
    assert not any("index_add" in t for t in targets)
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.standard_normal((40, 2)))
    k = torch.from_numpy(rng.integers(-1, 6, 40).astype(np.int32))
    got = shipped({"v": v, "k": k})["s"]
    torch.testing.assert_close(got, segment_sum_reference(v, k, 5),
                               rtol=0, atol=0)


def test_segment_sum_op_has_no_batching_rule():
    ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="no batching rule"):
        torch.func.vmap(lambda v: segment_sum(v, ids, 2))(
            torch.ones(4, 3, 1, dtype=torch.float64))
