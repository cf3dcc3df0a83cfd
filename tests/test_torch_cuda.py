"""The port on the GPU: the CUDA ``segment_sum`` and ``flash_attention``
kernels against their plain versions, and keyed ``aggregate`` and the
transformer LM on the card against the JAX package on the CPU. Every test
here needs an NVIDIA GPU (marker ``cuda``) and skips without one; run them
on a machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu.models.transformer import (
    TransformerConfig as JaxConfig, TransformerLM as JaxLM)
from tensorframes_tpu_torch.models import (TransformerConfig, TransformerLM,
                                           params_from_jax)
from tensorframes_tpu_torch.ops import segment_reduce
from torch_parity import assert_frames_match, to_port

fa = importlib.import_module("tensorframes_tpu_torch.ops.flash_attention")

pytestmark = pytest.mark.cuda

# kernel against the exact (f64) plain version: f64 summation order only;
# f32 chains of at most one piece of terms at each level of the piece tree;
# bf16 one rounding
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    """The card as the default device. The memory ledger resolves its
    budget from the card (or a test's cap) at the test's first dispatch
    and is dropped after, so that no test inherits another's budget."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    prev = ttf.default_device()
    ttf.set_default_device("cuda")
    ttf.memory._reset()
    yield torch.device("cuda")
    ttf.memory._reset()
    ttf.set_default_device(prev)


@pytest.mark.parametrize("dtype", list(RTOL), ids=str)
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64], ids=str)
@pytest.mark.parametrize("n,d,s", [(1, 1, 1), (1000, 1, 7), (4099, 64, 300),
                                   (20_003, 3, 50_000),
                                   (250_000, 64, 1024)])  # a k-means block
@pytest.mark.parametrize("spread", ["random", "hot", "single"])
def test_kernel_matches_plain_and_is_deterministic(cuda, dtype, id_dtype,
                                                   n, d, s, spread):
    # random ids, with -1 and >= s dropped; a hot segment holding 90% of the
    # rows; or every row in one segment with s = 1
    rng = np.random.default_rng(n + d + s)
    ids = rng.integers(-1, s + 2, n)
    if spread == "hot":
        ids = np.where(rng.random(n) < 0.9, s // 2, ids)
    elif spread == "single":
        ids, s = np.zeros(n, np.int64), 1
    vals = torch.from_numpy(rng.random((n, d)) + 0.5).to(cuda, dtype)
    tid = torch.from_numpy(ids).to(cuda, id_dtype)
    before = segment_reduce.launches
    got = segment_reduce.segment_sum(vals, tid, s)
    again = segment_reduce.segment_sum(vals, tid, s)
    torch.cuda.synchronize()
    assert segment_reduce.launches - before == 2
    assert got.dtype == dtype and tuple(got.shape) == (s, d)
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    ref = segment_reduce.segment_sum_reference(vals.double(), tid, s)
    torch.testing.assert_close(got.double(), ref, rtol=RTOL[dtype], atol=0.0)


def test_kernel_wrapper_edges(cuda):
    empty = segment_reduce.segment_sum(
        torch.empty((0, 2, 3), device=cuda),
        torch.empty((0,), dtype=torch.int32, device=cuda), 4)
    assert tuple(empty.shape) == (4, 2, 3) and not bool(empty.any())
    vals = torch.ones((5, 2, 3), dtype=torch.float64, device=cuda)
    out = segment_reduce.segment_sum(
        vals, torch.tensor([0, 1, 1, -1, 9], device=cuda), 2)
    assert out[:, 0, 0].tolist() == [1.0, 2.0]
    ints = torch.ones((4, 2), dtype=torch.int32, device=cuda)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    before = segment_reduce.launches
    exact = segment_reduce.segment_sum(ints, ids, 1)  # exact plain path
    assert exact.tolist() == [[4, 4]] and segment_reduce.launches == before
    with pytest.raises(TypeError, match="f32, bf16 or f64"):
        segment_reduce.segment_sum_cuda(ints, ids, 1)
    with pytest.raises(ValueError, match="contiguous"):
        segment_reduce.segment_sum_cuda(
            torch.ones((4, 2), device=cuda).t(), ids[:2], 1)


def test_aggregate_on_the_card_matches_the_jax_package(cuda):
    rng = np.random.default_rng(11)
    # positive f32 values: an f32 sum near zero has no relative accuracy
    cols = {"k": rng.integers(0, 50, 3000), "x": rng.standard_normal(3000),
            "v": (rng.random((3000, 4)) + 0.5).astype(np.float32)}
    j = jtf.frame(cols, num_partitions=3)
    t = to_port(j)
    before = segment_reduce.launches
    got = ttf.aggregate({"x": "sum", "v": "sum"}, t.group_by("k"))
    assert segment_reduce.launches - before == 6  # 2 columns x 3 blocks
    want = jtf.aggregate({"x": "sum", "v": "sum"}, j.group_by("k"))
    assert_frames_match(want, got, rtol=1e-5)  # v is f32
    np.testing.assert_allclose(got.blocks()[0].columns["x"],
                               want.blocks()[0].columns["x"], rtol=1e-12)


def test_six_ops_on_the_card_match_the_jax_package(cuda):
    rng = np.random.default_rng(12)
    j = jtf.frame({"x": rng.standard_normal(500), "k": rng.integers(0, 5, 500)},
                  num_partitions=4)
    t = to_port(j)
    fn = lambda x: {"z": x + 3.0}  # noqa: E731
    assert_frames_match(jtf.map_blocks(fn, j), ttf.map_blocks(fn, t))
    assert_frames_match(jtf.map_rows(fn, j), ttf.map_rows(fn, t))
    pred = lambda x: x > 0  # noqa: E731
    assert_frames_match(jtf.filter_rows(pred, j), ttf.filter_rows(pred, t))
    np.testing.assert_allclose(
        ttf.reduce_blocks(lambda x_input: {"x": torch.sum(x_input)},
                          t.select(["x"])),
        jtf.reduce_blocks(lambda x_input: {"x": jnp.sum(x_input)},
                          j.select(["x"])), rtol=1e-12)
    add = lambda x_1, x_2: {"x": x_1 + x_2}  # noqa: E731
    np.testing.assert_allclose(ttf.reduce_rows(add, t.select(["x"])),
                               jtf.reduce_rows(add, j.select(["x"])),
                               rtol=1e-12)
    for comb in ("min", "max", "prod"):
        assert_frames_match(jtf.aggregate({"x": comb}, j.group_by("k")),
                            ttf.aggregate({"x": comb}, t.group_by("k")),
                            rtol=1e-12)


# flash_attention against its plain version widened to f64: f32 to 2e-5
# (the JAX kernel tests' bound; 3xTF32 products); bf16 and f16 to 1e-2
# (exact 16-bit q.k products, p split into two 16-bit halves, one rounding
# of the output to 8 or 11 bits)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}


@pytest.mark.parametrize("dtype", list(FLASH_TOL), ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,sq,sk,h,d", [(1, 8, 8, 1, 8), (2, 37, 37, 3, 16),
                                         (1, 24, 40, 2, 64),
                                         (1, 40, 24, 2, 128),
                                         (2, 300, 300, 2, 64),
                                         (2, 100, 260, 3, 128)])
def test_flash_kernel_matches_plain_and_is_deterministic(cuda, dtype, causal,
                                                         b, sq, sk, h, d):
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d))).to(
        cuda, dtype) for s in (sq, sk, sk))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    again = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches - before == 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    ref = fa.flash_attention_reference(q.double(), k.double(), v.double(),
                                       causal=causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.double(), ref, rtol=tol, atol=tol)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.ones((1, 4, 2, 8), device=cuda)
    with pytest.raises(TypeError, match="f32, bf16 or f16"):
        fa.flash_attention_cuda(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="f32, bf16 or f16"):
        fa.flash_attention(q, q.half(), q)
    wide = torch.ones((1, 4, 2, 129), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.ones((1, 2, 4, 8), device=cuda).transpose(1, 2)
        fa.flash_attention_cuda(strided, strided, strided)
    with pytest.raises(ValueError, match=r"\[B, Sq, H, D\]"):
        fa.flash_attention_cuda(q, torch.ones((1, 4, 3, 8), device=cuda), q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, q.cpu(), q)
    with pytest.raises(ValueError, match="Unknown flash_attention impl"):
        fa.flash_attention(q, q, q, impl="xla")
    with pytest.raises(NotImplementedError, match="forward only"):
        fa.flash_attention(q.requires_grad_(), q, q)
    # the public entry point makes strided inputs contiguous for the kernel
    s = torch.randn((1, 2, 5, 8), device=cuda).transpose(1, 2)
    torch.testing.assert_close(fa.flash_attention(s, s, s, causal=True),
                               fa.flash_attention_reference(s, s, s, True),
                               rtol=2e-5, atol=2e-5)


def test_transformer_on_the_card_matches_the_jax_package(cuda):
    small = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
    jm = JaxLM(JaxConfig(**small))
    params = jm.init(jax.random.PRNGKey(1))
    tm = TransformerLM(TransformerConfig(**small))
    assert tm.device.type == "cuda"
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    toks = np.random.default_rng(0).integers(0, 64, (2, 12)).astype(np.int32)
    before = fa.launches
    logits = tm.apply(torch.from_numpy(toks))
    assert fa.launches - before == 2  # one per layer
    np.testing.assert_allclose(logits.cpu().numpy(),
                               np.asarray(jm.apply(params, jnp.asarray(toks))),
                               rtol=2e-4, atol=2e-4)
    tgt = np.roll(toks, -1, axis=1)
    np.testing.assert_allclose(
        float(tm.loss(torch.from_numpy(toks), torch.from_numpy(tgt))),
        float(jm.loss(params, jnp.asarray(toks), jnp.asarray(tgt))),
        rtol=2e-4, atol=2e-4)
    prompt = toks[:, :5]
    want = np.asarray(jm.generate(params, jnp.asarray(prompt), 6))
    np.testing.assert_array_equal(
        tm.generate(torch.from_numpy(prompt), 6).cpu().numpy(), want)
    df = ttf.analyze(ttf.frame({"prompt": prompt.astype(np.int64)},
                               num_partitions=2))
    comp = np.concatenate([b.columns["completion"] for b in
                           tm.generate_via_frame(df, 6).blocks()])
    np.testing.assert_array_equal(comp, want)


# ---------------------------------------------------------------------------
# the logical plan on the card
# ---------------------------------------------------------------------------

def _plan_chain(df):
    return (df.map_blocks(lambda x: {"a": x * 2.0})
              .filter(lambda a: a > 0.0)
              .map_rows(lambda a: {"b": a * 0.5})
              .select(["k", "b"]))


def _plan_frame(parts=4):
    rng = np.random.default_rng(13)
    return ttf.frame({"x": rng.standard_normal(4000),
                      "y": rng.standard_normal(4000),
                      "k": rng.integers(0, 64, 4000)}, num_partitions=parts)


def test_fused_stages_chain_on_device_resident_tensors(cuda, monkeypatch):
    from tensorframes_tpu_torch.engine.executor import BlockExecutor
    from tensorframes_tpu_torch.plan.optimize import build_plan
    from tensorframes_tpu_torch.utils import tracing
    monkeypatch.delenv("TFT_FUSE", raising=False)
    seen = []
    real = BlockExecutor.run

    def spy(self, comp, arrays, *a, **k):
        seen.append({n: (type(v).__name__, getattr(v, "device", None))
                     for n, v in arrays.items()})
        return real(self, comp, arrays, *a, **k)
    monkeypatch.setattr(BlockExecutor, "run", spy)
    monkeypatch.setenv("TFT_PIPELINE_DEPTH", "1")  # serial: run() per block
    chain = _plan_chain(_plan_frame())
    assert len(build_plan(chain).stages) == 2
    tracing.enable()
    try:
        tracing.timings.reset()
        chain.blocks()
        spans = tracing.timings.snapshot()
    finally:
        tracing.disable()
    assert chain._plan_info
    assert spans["executor.convert"]["count"] == 4  # once per block
    assert spans["executor.dispatch"]["count"] == 8  # once per stage
    later = [s for s in seen if "a" in s]
    assert len(later) == 4
    for s in later:
        assert s["a"][0] == "Tensor" and s["a"][1].type == "cuda"


def test_fused_equals_unfused_on_the_card(cuda, monkeypatch):
    monkeypatch.delenv("TFT_FUSE", raising=False)
    fused = _plan_chain(_plan_frame())
    fused.blocks()
    assert fused._plan_info
    monkeypatch.setenv("TFT_FUSE", "0")
    unfused = _plan_chain(_plan_frame())
    assert_frames_match(unfused, fused)
    assert unfused._plan_info is None


def test_dsl_readme_x_plus_3_on_the_card(cuda):
    df = ttf.frame({"x": np.arange(10.0)}, num_partitions=2)
    with ttf.dsl.with_graph():
        z = (ttf.block(df, "x") + 3.0).named("z")
    out = df.map_blocks(z)
    assert [r["z"] for r in out.collect()] == [i + 3.0 for i in range(10)]


def test_fused_chain_into_aggregate_launches_segment_sum(cuda, monkeypatch):
    monkeypatch.delenv("TFT_FUSE", raising=False)
    chain = _plan_chain(_plan_frame())
    before = segment_reduce.launches
    got = ttf.aggregate({"b": "sum"}, chain.group_by("k"))
    assert chain._plan_info
    assert segment_reduce.launches - before == 4  # one per block
    monkeypatch.setenv("TFT_FUSE", "0")
    want = ttf.aggregate({"b": "sum"},
                         _plan_chain(_plan_frame()).group_by("k"))
    assert_frames_match(want, got)  # the same rows per block: bit-equal


# ---------------------------------------------------------------------------
# the relational layer on the card: joins gather on the device, sketches
# fold there from 4,096 rows
# ---------------------------------------------------------------------------

def _join_tables(rng, n=5000, m=300):
    right = {"k": rng.permutation(m).astype(np.int64)[: m - 20],
             "w": rng.standard_normal(m - 20),
             "f": rng.standard_normal(m - 20).astype(np.float32),
             "i": rng.integers(-9, 9, m - 20).astype(np.int32),
             "e": rng.standard_normal((m - 20, 3)),
             "s": np.array([f"r{i}" for i in range(m - 20)], object)}
    right["k"][::7] = right["k"][1::7][: len(right["k"][::7])]  # dup keys
    left = {"k": rng.integers(0, m, n).astype(np.int64),
            "x": rng.standard_normal(n)}
    return left, right


@pytest.mark.parametrize("how", ["inner", "left"])
def test_broadcast_join_on_the_card_equals_the_cpu_executor(cuda, how):
    from tensorframes_tpu_torch.engine.executor import BlockExecutor
    from tensorframes_tpu_torch.utils.tracing import counters
    left, right = _join_tables(np.random.default_rng(31))
    right["b"] = right["f"]  # a bfloat16 column: f32 on the host
    schema = ttf.Schema([
        ttf.Field("b", ttf.dtypes.bfloat16, block_shape=f.block_shape)
        if f.name == "b" else f for f in ttf.frame(right).schema])
    right_df = ttf.frame(right, schema=schema)
    gpu = ttf.relational.broadcast_join(
        ttf.frame(left, num_partitions=3), right_df, on="k", how=how,
        indicator="hit")
    build = gpu._plan_node.build
    assert all(t.is_cuda for t in build.dev_cols.values())
    d0 = counters.get("relational.probe_dispatches")
    gpu.blocks()
    assert counters.get("relational.probe_dispatches") - d0 == 3
    cpu = ttf.relational.broadcast_join(
        ttf.frame(left, num_partitions=3), right_df, on="k", how=how,
        indicator="hit", executor=BlockExecutor(device="cpu"))
    assert_frames_match(cpu, gpu)  # a gather moves values: bit-equal
    assert gpu.blocks()[0].columns["b"].dtype == np.float32


@pytest.mark.parametrize("kind", ["hll", "quantile"])
def test_sketch_device_fold_on_the_card_equals_the_host_fold(
        cuda, monkeypatch, kind):
    from tensorframes_tpu.relational import sketch as jsketch
    from tensorframes_tpu_torch.relational import sketch as tsketch
    rng = np.random.default_rng(32)
    n = 50_000
    ids = rng.integers(0, 7, n).astype(np.int64)
    if kind == "hll":
        vals = rng.integers(0, 30_000, n).astype(np.int64)
        sk, jsk = tsketch.HllSketch(bits=12), jsketch.HllSketch(bits=12)
    else:
        vals = rng.lognormal(0.0, 2.0, n)
        sk = tsketch.QuantileSketch(qs=(0.5, 0.99))
        jsk = jsketch.QuantileSketch(qs=(0.5, 0.99))
    card = sk.block_partial(vals, ids, 7, device="cuda")
    monkeypatch.setattr(tsketch, "DEVICE_FOLD_ROWS", 1 << 62)
    host = sk.block_partial(vals, ids, 7)
    assert card.dtype == host.dtype == np.int32
    np.testing.assert_array_equal(card, host)
    np.testing.assert_array_equal(card, np.asarray(jsk.block_partial(
        vals, ids, 7)))


def test_star_schema_chain_on_the_card_equals_the_cpu_run(cuda, monkeypatch):
    from chip_smoke import ssb_reference
    from test_torch_relational import ssb_query, ssb_small
    from tensorframes_tpu_torch.utils.tracing import counters
    monkeypatch.delenv("TFT_FUSE", raising=False)
    tables = ssb_small(20_000)
    for q21 in (True, False):
        before = segment_reduce.launches
        f0 = counters.get("plan.fused_queries")
        chain, gpu = ssb_query(ttf, tables, q21=q21)
        gpu.blocks()
        assert chain._plan_info
        assert counters.get("plan.fused_queries") > f0
        assert segment_reduce.launches - before == 3  # one per block
        ttf.set_default_device("cpu")
        try:
            _, cpu = ssb_query(ttf, tables, q21=q21)
            cpu.blocks()
        finally:
            ttf.set_default_device("cuda")
        # revenue is integral: every order of summation is exact
        assert_frames_match(cpu, gpu)
        want = ssb_reference(np, tables, q21)
        for name, col in want.items():
            np.testing.assert_array_equal(gpu.blocks()[0].columns[name], col)


def test_failing_device_fold_raises_on_the_card(cuda, monkeypatch):
    from tensorframes_tpu_torch.engine import ops as tops
    calls = []

    def broken(cname, values, ids, num_segments):
        calls.append(values.device.type)
        raise RuntimeError("device fold failed")
    monkeypatch.setattr(tops, "_segment_reduce", broken)
    df = ttf.frame({"g": np.zeros(5000, np.int64),
                    "v": np.arange(5000, dtype=np.int64)})
    with pytest.raises(RuntimeError, match="device fold failed"):
        ttf.aggregate({"v": ttf.approx_distinct(bits=8)}, df.group_by("g"))
    assert calls == ["cuda"]  # tried on the card, never again on the host


# ---------------------------------------------------------------------------
# recovery from a real torch.cuda.OutOfMemoryError under a memory cap
# ---------------------------------------------------------------------------

# the random-feature program of chip_smoke.py's OOM phase at a test's size:
# a [rows, 4096] f32 product; x @ W and + b hold two of them at once
_RFF_ROWS, _RFF_D, _RFF_F = 131_072, 16, 4096


@pytest.fixture
def capped(cuda):
    """Cap the process at 1.5 GiB over what it holds now, and put the
    fraction back to 1.0 in a ``finally``; yields the cap in bytes."""
    cuda = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(cuda).total_memory
    cap = torch.cuda.memory_allocated(cuda) + (3 << 29)
    torch.cuda.set_per_process_memory_fraction(cap / total, cuda)
    try:
        yield cap
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, cuda)
        torch.cuda.empty_cache()


def _rff(cuda, rows=_RFF_ROWS, parts=1):
    from chip_smoke import rff_query, rff_tables
    tables = rff_tables(np, rows, _RFF_D, _RFF_F, keys=1000)
    consts = tuple(torch.from_numpy(tables[k]).to(cuda)
                   for k in ("W", "b", "beta"))
    return tables, consts, lambda parts=parts: rff_query(
        ttf, torch.cos, consts, tables, parts)


def test_capture_of_a_closure_over_cuda_tensors(cuda):
    """map_rows and map_blocks over programs that close over tensors on
    the card capture (fake probes on the card's device) and run there."""
    W = torch.arange(16 * 8, dtype=torch.float32, device=cuda).reshape(16, 8)
    x = np.random.default_rng(0).standard_normal((50, 16)).astype(np.float32)
    df = ttf.frame({"x": x}, num_partitions=2)
    rows = df.map_rows(lambda x: {"z": x @ W})
    blocks = df.map_blocks(lambda x: {"z": x @ W})
    assert rows.schema["z"].dtype.name == "float"
    want = (torch.from_numpy(x).to(cuda) @ W).cpu().numpy()
    for out in (rows, blocks):
        got = np.concatenate([b.columns["z"] for b in out.blocks()])
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_real_oom_under_a_cap_is_split_by_map_rows(capped):
    """A block whose [131072, 4096] f32 product does not fit under the
    cap runs out of memory for real; map_rows halves it until it fits
    (the block and each half fail: 3 splits) and the result is bit-equal
    to the run over the leaf shapes."""
    from chip_smoke import rff_splits
    from tensorframes_tpu_torch.utils.tracing import counters
    _, _, query = _rff(torch.device("cuda"))
    counters.reset()
    sel, agg = query()
    z = np.concatenate([b.columns["z"] for b in sel.blocks()])
    assert counters.get("oom_split.dispatches") == rff_splits(
        _RFF_ROWS, _RFF_D, _RFF_F, 3 << 29) == 3
    assert counters.get("plan.oom_fallbacks") == 0
    sel4, _ = query(parts=4)  # the leaf shapes fit under the cap
    z4 = np.concatenate([b.columns["z"] for b in sel4.blocks()])
    assert counters.get("oom_split.dispatches") == 3
    assert np.array_equal(z.view(np.uint32), z4.view(np.uint32))


def test_the_same_oom_raises_through_map_blocks(capped):
    """map_blocks has no row-local contract: the real OOM propagates (and
    the plan's per-op re-run of it as well), never split."""
    from tensorframes_tpu_torch.utils.tracing import counters
    tables, consts, _ = _rff(torch.device("cuda"))
    W, b, beta = consts
    counters.reset()
    df = ttf.frame({"x": tables["x"]})
    out = df.map_blocks(lambda x: {"z": torch.cos(x @ W + b) @ beta})
    with pytest.raises(torch.cuda.OutOfMemoryError):
        out.blocks()
    assert counters.get("oom_split.dispatches") == 0


def test_is_oom_accepts_the_real_exception(capped):
    from tensorframes_tpu_torch import resilience
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(capped, dtype=torch.uint8, device="cuda")
    assert resilience.is_oom(ei.value)
    assert not resilience.is_transient(ei.value)
    assert resilience.error_kind(ei.value) == "oom"


def test_failed_submit_does_not_hold_the_attempts_memory(capped):
    """A submit whose program ran out of memory records the error without
    its frames: the 1 GiB the program's locals held when it failed is
    back in the allocator before the drain, which recovers the block by
    halving it."""
    from tensorframes_tpu_torch.engine import ops as tops
    from tensorframes_tpu_torch.engine.executor import BlockExecutor
    from tensorframes_tpu_torch.utils.tracing import counters
    tables, consts, _ = _rff(torch.device("cuda"), rows=32_768)
    W, b, beta = consts
    rows = tables["x"].shape[0]

    def prog(d):
        h = d["x"] @ W                  # 512 MiB, held by a local
        g = torch.cos(h + b)            # 512 MiB more
        if h.shape[0] == rows:          # the whole block asks for the cap
            torch.empty(capped, dtype=torch.uint8, device=h.device)
        return {"z": g @ beta}

    df = ttf.frame({"x": tables["x"]})
    comp = tops._map_computation(lambda x: {"z": x[:, 0]}, df.schema,
                                 block_level=True)
    comp = type(comp)(prog, comp.inputs, comp.outputs)
    counters.reset()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    pending = BlockExecutor().submit(comp, {"x": tables["x"]},
                                     row_local=True)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    assert held < (64 << 20), f"the failed attempt still holds {held} B"
    out = pending.drain()
    assert out["z"].shape == (rows,) and np.isfinite(out["z"]).all()
    assert counters.get("pipeline.sync_fallbacks") == 1
    assert counters.get("oom_split.dispatches") == 1


def test_a_broken_kernel_build_is_permanent_and_not_retried(
        cuda, monkeypatch, tmp_path):
    """A kernel source that does not compile raises KernelError from the
    build: classified permanent, tried once by the retry policy, and the
    keyed sum raises rather than fall back to the plain version."""
    from tensorframes_tpu_torch import resilience
    from tensorframes_tpu_torch.ops import _build
    from tensorframes_tpu_torch.utils.tracing import counters
    (tmp_path / "segment_sum.cu").write_text(
        (_build.CSRC / "segment_sum.cu").read_text()
        + "\nthis is not C++;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    counters.reset()
    calls = []

    def build():
        calls.append(1)
        return _build.load("segment_sum")

    with pytest.raises(resilience.KernelError, match="nvcc failed") as ei:
        resilience.default_policy().call(build, op="executor.dispatch")
    assert calls == [1]
    assert resilience.is_permanent(ei.value)
    assert counters.get("retry.executor.dispatch.retries") == 0
    before = segment_reduce.launches
    df = ttf.frame({"k": np.arange(100) % 7, "v": np.arange(100.0)})
    with pytest.raises(resilience.KernelError):
        ttf.aggregate({"v": "sum"}, df.group_by("k"))
    assert segment_reduce.launches == before


# ---------------------------------------------------------------------------
# the memory ledger and preemption on the card
# ---------------------------------------------------------------------------

def _pinned_base(a) -> bool:
    """Whether numpy array ``a`` views a pinned torch host tensor."""
    while a is not None and not isinstance(a, torch.Tensor):
        a = getattr(a, "base", None)
    return a is not None and a.is_pinned()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.int64], ids=str)
def test_spill_and_fault_back_through_pinned_memory(cuda, dtype):
    """A CUDA tensor spills to a pinned host buffer, bit for bit, gives its
    device bytes back to the allocator, and faults back to the card in its
    dtype."""
    rng = np.random.default_rng(11)
    t = torch.from_numpy(rng.standard_normal(100_003) * 1000).to(cuda, dtype)
    buf = ttf.memory.SpillableBuffer("t", {"x": t.clone()})
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated(cuda)
    freed = buf.spill()
    assert freed == t.numel() * t.element_size()
    assert torch.cuda.memory_allocated(cuda) <= live - freed
    host = buf._host["x"][0]
    assert _pinned_base(host)
    assert host.dtype == (np.uint16 if dtype == torch.bfloat16
                          else t.cpu().numpy().dtype)
    back = buf.get("x")
    assert back.is_cuda and back.dtype == dtype
    assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))


@pytest.mark.parametrize("keep_device", [True, False],
                         ids=["keep_device", "pinned_readback"])
def test_pending_block_spilled_early_on_the_card(cuda, keep_device):
    """A pending block the ledger spills lets its device tensors go before
    its drain: a keep_device block (a fused stage edge) copies its outputs
    to the host; a block already copying to pinned buffers waits on its
    event. The drain hands back the same values."""
    mgr = ttf.memory.configure(limit_bytes=1 << 30)
    comp = ttf.Computation.trace(
        lambda x: {"z": x * 2.0},
        [ttf.TensorSpec("x", ttf.dtypes.float32, ttf.Shape(-1))])
    x = np.random.default_rng(12).standard_normal(1 << 20).astype(np.float32)
    pending = ttf.BlockExecutor().submit(comp, {"x": x},
                                         keep_device=keep_device)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated(cuda)
    assert mgr.snapshot()["resident_bytes"] == 2 * x.nbytes
    assert mgr.make_room(mgr.limit)
    assert pending.mem_is_spilled() and pending._held is None
    assert torch.cuda.memory_allocated(cuda) <= live - 2 * x.nbytes
    out = pending.drain()
    assert isinstance(out["z"], np.ndarray) and out["z"].dtype == np.float32
    np.testing.assert_array_equal(out["z"], x * 2.0)
    assert mgr.snapshot()["resident_buffers"] == 0


def test_star_schema_with_chunked_builds_on_the_card(cuda):
    """Q2.1 at a small size under a budget that makes the date build probe
    in chunks (``relational.build_chunks`` > 1): equal to the resident
    builds' run and to the numpy reference."""
    from chip_smoke import ssb_query, ssb_reference, ssb_tables
    from tensorframes_tpu_torch.utils.tracing import counters
    tables = ssb_tables(np, 5000, parts=200, suppliers=20, customers=300)
    want = ssb_reference(np, tables, True)
    ttf.memory.configure(limit_bytes=0)
    resident = ssb_query(ttf, tables, 3)[1].blocks()[0].columns
    ttf.memory.configure(limit_bytes=40_000)
    c0 = counters.get("relational.build_chunks")
    cols = ssb_query(ttf, tables, 3)[1].blocks()[0].columns
    assert counters.get("relational.build_chunks") - c0 > 1
    for name, col in want.items():
        np.testing.assert_array_equal(cols[name], col)
        np.testing.assert_array_equal(cols[name], resident[name])


def test_fused_chain_parks_and_resumes_on_the_card(cuda, monkeypatch):
    """A fused two-stage chain, its first stage's edge device-resident,
    under a budget that spills pending edges: two injected preemptions
    park it at strictly later blocks, each resume dispatches only the
    blocks past its checkpoint, and the result equals the undisturbed
    run."""
    from tensorframes_tpu_torch.engine import preempt
    from tensorframes_tpu_torch.resilience import QueryPreempted, faults
    from tensorframes_tpu_torch.utils.tracing import counters
    monkeypatch.setenv("TFT_PIPELINE_DEPTH", "4")
    x = np.random.default_rng(13).standard_normal(8 * 4096)

    def chain():
        return (ttf.frame({"x": x}, num_partitions=8)
                .map_blocks(lambda x: {"y0": x * 2.0})
                .filter(lambda y0: y0 > -1.0)
                .map_blocks(lambda y0: {"y": y0 + 1.0}))
    want = np.concatenate([b.columns["y"] for b in chain().blocks()])
    ttf.memory.configure(limit_bytes=int(2 * 4096 * 8 * 2.5))
    df = chain()
    sc = preempt.PreemptionScope("q")
    counters.reset()
    faults.arm("preempt", 2)
    cursors = []
    try:
        for _ in range(5):
            try:
                with preempt.activate(sc):
                    blocks = df.blocks()
                break
            except QueryPreempted:
                cursors.append(sc.checkpoint.parked_blocks)
    finally:
        faults.reset()
    assert cursors == [1, 2] and df._plan_info
    assert counters.get("pipeline.resumed_blocks") == 3
    assert counters.get("pipeline.submitted") == 8
    assert counters.get("memory.spills") > 0
    got = np.concatenate([b.columns["y"] for b in blocks])
    np.testing.assert_array_equal(got, want)
