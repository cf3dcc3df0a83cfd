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
fab = importlib.import_module(
    "tensorframes_tpu_torch.ops.flash_attention_backward")

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


# the backward kernels against autograd of the plain version on the same
# inputs widened to f64, each cotangent's worst error over its reference's
# max-abs: f32 to 1e-4 (f32 products summed in another order, and the
# forward's 3xTF32 log-sum-exp); bf16 and f16 to 2e-2 (delta from the
# output rounded to 8 or 11 bits, and one rounding of each gradient). With
# Sk = 0 every reference is zero (dq) or empty (dk, dv), and so is the
# kernel's.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}


def flash_grads(q, k, v, g, causal):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal)
    return torch.autograd.grad(out, leaves, g)


def assert_grads_match(got, again, want, dtype):
    """Each cotangent bit-identical over two runs and within ``BWD_TOL``
    of its f64 reference's max-abs."""
    tops = [float(w.abs().max()) if w.numel() else 0.0 for w in want]
    for name, x, y, w, top in zip("qkv", got, again, want, tops):
        assert x.dtype == dtype and x.shape == w.shape, name
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8)), name
        assert bool(torch.isfinite(x).all()), name
        err = float((x.double() - w).abs().max()) if w.numel() else 0.0
        # with one key the softmax is constant and dq = dk = 0 up to
        # rounding: such a cotangent is held against the largest of three
        scale = top if top > 1e-6 * max(tops) else max(tops)
        assert err <= BWD_TOL[dtype] * scale, (name, err, top)


@pytest.mark.parametrize("dtype", list(BWD_TOL), ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,sq,sk,h,d", [(1, 1, 1, 1, 32), (1, 63, 65, 2, 40),
                                         (2, 64, 64, 3, 64),
                                         (1, 65, 63, 2, 128),
                                         (1, 200, 200, 1, 64),
                                         (2, 200, 63, 2, 32),
                                         (1, 63, 200, 2, 64),
                                         (1, 3, 0, 2, 16),
                                         (2, 37, 37, 2, 8),
                                         (1, 65, 33, 3, 16),
                                         (1, 65, 63, 2, 33),
                                         (2, 63, 200, 1, 100)])
def test_flash_backward_matches_plain_autograd_and_is_deterministic(
        cuda, dtype, causal, b, sq, sk, h, d):
    rng = np.random.default_rng(sq * 7 + sk + d)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, s, h, d))).to(
        cuda, dtype) for s in (sq, sk, sk, sq))
    before = (fa.launches, fab.launches)
    got = flash_grads(q, k, v, g, causal)
    again = flash_grads(q, k, v, g, causal)
    torch.cuda.synchronize()
    assert (fa.launches - before[0], fab.launches - before[1]) == (2, 2)
    want = fab.flash_attention_backward_reference(
        q.double(), k.double(), v.double(), g.double(), causal)
    assert_grads_match(got, again, want, dtype)
    _, lse = fa.flash_attention_cuda(q, k, v, causal, return_lse=True)
    torch.testing.assert_close(
        lse.double(), fa.flash_attention_reference(
            q.double(), k.double(), v.double(), causal, return_lse=True)[1],
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", list(BWD_TOL), ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [36, 64])
def test_flash_backward_takes_misaligned_inputs(cuda, dtype, causal, d):
    """Inputs whose data start off a 16-byte boundary, which ``cp.async``
    cannot copy: the kernels' own loader takes every tile."""
    from chip_smoke import misaligned

    rng = np.random.default_rng(d + causal)
    q, k, v, g = (misaligned(torch, torch.from_numpy(rng.standard_normal(
        (2, s, 2, d))).to(cuda, dtype)) for s in (65, 63, 63, 65))

    def grads():
        out, lse = fa.flash_attention_cuda(q, k, v, causal, return_lse=True)
        return fab.flash_attention_backward_cuda(q, k, v, out, lse, g, causal)

    before = fab.launches
    got, again = grads(), grads()
    torch.cuda.synchronize()
    assert fab.launches - before == 2
    want = fab.flash_attention_backward_reference(
        q.double(), k.double(), v.double(), g.double(), causal)
    assert_grads_match(got, again, want, dtype)


def test_flash_grad_on_the_card_never_takes_the_plain_version(cuda,
                                                              monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("the plain attention ran on the card")

    monkeypatch.setattr(fa, "flash_attention_reference", plain)
    monkeypatch.setattr(fab, "flash_attention_backward_reference", plain)
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 70, 2, 64))).to(
        cuda, torch.float32).requires_grad_() for _ in range(3))
    fa.flash_attention(q, k, v, causal=True).square().sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))


def test_a_shipped_program_calling_attention_launches_the_kernel(cuda):
    comp = ttf.Computation.trace(
        lambda x: {"z": fa.flash_attention(x, x, x, causal=True)},
        [ttf.TensorSpec("x", ttf.dtypes.float32, ttf.Shape(-1, 70, 2, 64))])
    back = ttf.Computation.deserialize(comp.serialize())
    x = np.random.default_rng(5).standard_normal((3, 70, 2, 64)).astype(
        np.float32)
    before = fa.launches
    rows = ttf.map_blocks(back, ttf.frame({"x": x})).collect()
    assert fa.launches - before == 1
    got = np.stack([np.asarray(r["z"]) for r in rows])
    t = torch.from_numpy(x).double()
    want = fa.flash_attention_reference(t, t, t, causal=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


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
    # an input that requires grad goes through the op and its backward
    # kernel; the backward wrapper refuses what its kernels do not take
    before = (fa.launches, fab.launches)
    x = q.clone().requires_grad_()
    fa.flash_attention(x, q, q).sum().backward()
    assert (fa.launches - before[0], fab.launches - before[1]) == (1, 1)
    out, lse = fa.flash_attention_cuda(q, q, q, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        fab.flash_attention_backward_cuda(q, q, q, out, lse[:1], out)
    with pytest.raises(TypeError, match="f32, bf16 or f16"):
        fab.flash_attention_backward_cuda(q, q, q, out.half(), lse, out)
    with pytest.raises(ValueError, match="head dim"):
        fab.flash_attention_backward_cuda(wide, wide, wide, wide,
                                          lse, wide)
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


# ---------------------------------------------------------------------------
# the stream layer on the card
# ---------------------------------------------------------------------------

def _stream_batches(n, rows, keys, seed):
    rng = np.random.default_rng(seed)
    return [{"k": rng.integers(0, keys, rows).astype(np.int64),
             "v": rng.random(rows),
             "ts": np.full(rows, float(i))} for i in range(n)]


def _stream_windows(stream, batches, **kw):
    h = (stream.from_source(stream.GeneratorSource(iter(batches)))
         .group_by("k")
         .aggregate({"v": "sum"}, window=stream.tumbling(4.0),
                    time_col="ts", **kw)
         .start())
    return h


def _numpy_windows(batches, size):
    allc = {c: np.concatenate([b[c] for b in batches]) for c in batches[0]}
    out = {}
    for w in np.unique(np.floor(allc["ts"] / size) * size):
        m = (allc["ts"] >= w) & (allc["ts"] < w + size)
        keys = np.unique(allc["k"][m])
        sums = np.array([allc["v"][m][allc["k"][m] == k].sum()
                         for k in keys])
        out[float(w)] = (keys, sums)
    return out


def test_windowed_stream_folds_through_the_kernel_on_the_card(cuda):
    from tensorframes_tpu_torch import stream
    batches = _stream_batches(8, 5000, 300, seed=31)
    h = _stream_windows(stream, batches, watermark_delay=100.0)
    before = segment_reduce.launches
    assert h.step()
    # the window's state stays on the card between batches
    (state,) = h._agg._windows.values()
    assert state.values["v"].device.type == "cuda"
    h.run()
    # one fold per batch (each batch lies in one tumbling window), each a
    # kernel launch
    assert segment_reduce.launches - before == 8
    frames = h.collect_updates()
    want = _numpy_windows(batches, 4.0)
    assert len(frames) == len(want) == 2
    for f in frames:
        cols = f.blocks()[0].columns
        keys, sums = want[float(cols["window_start"][0])]
        np.testing.assert_array_equal(cols["k"], keys)
        np.testing.assert_allclose(cols["v"], sums, rtol=1e-12)
    assert h.metrics()["batches_skipped"] == 0


def test_window_state_spills_and_faults_back_through_pinned_memory(cuda):
    from tensorframes_tpu_torch import stream
    batches = _stream_batches(6, 2000, 100, seed=32)
    # window 4 arrives, window 0 spills (cap 150 rows), then rows for
    # window 0 fault it back
    batches.append({"k": np.arange(100, dtype=np.int64),
                    "v": np.full(100, 0.5), "ts": np.full(100, 1.0)})
    ttf.memory.configure(limit_bytes=1 << 30)
    h = _stream_windows(stream, batches, watermark_delay=100.0,
                        max_state_rows=150)
    h.run(max_batches=6)
    agg = h._agg
    spilled = [w for w in agg._windows.values() if w.spilled]
    assert agg.state_spills >= 1 and spilled
    host, dev, dtype = spilled[0].values["v"]
    assert dev.type == "cuda" and dtype == torch.float64
    h.run()
    assert agg.state_faults >= 1 and agg.state_evictions == 0
    frames = h.collect_updates()
    want = _numpy_windows(batches, 4.0)
    for f in frames:
        cols = f.blocks()[0].columns
        keys, sums = want[float(cols["window_start"][0])]
        np.testing.assert_array_equal(cols["k"], keys)
        np.testing.assert_allclose(cols["v"], sums, rtol=1e-12)


def test_background_pump_drives_the_card(cuda):
    import time

    from tensorframes_tpu_torch import stream
    from tensorframes_tpu_torch.engine import pipeline
    batches = _stream_batches(6, 3000, 50, seed=33)
    src = stream.QueueSource(ttf.frame(dict(batches[0])).schema, maxsize=2)
    pool = pipeline.SlotPool(2)
    prev = pipeline.install_slot_pool(pool)
    try:
        h = (stream.from_source(src).group_by("k")
             .aggregate({"v": "sum"}, window=stream.tumbling(4.0),
                        time_col="ts")
             .start(name="bg-cuda"))
        before = segment_reduce.launches
        h.start_background(poll_interval=0.005)
        for b in batches:
            src.put(b)
        src.close()
        deadline = time.monotonic() + 60
        while not h.done() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert h.done() and h.error is None
        h.stop()
    finally:
        pipeline.install_slot_pool(prev)
    assert segment_reduce.launches - before == 6
    assert pool.leased() == 0
    want = _numpy_windows(batches, 4.0)
    frames = h.collect_updates()
    assert len(frames) == len(want)
    for f in frames:
        cols = f.blocks()[0].columns
        keys, sums = want[float(cols["window_start"][0])]
        np.testing.assert_allclose(cols["v"], sums, rtol=1e-12)


def test_stream_join_on_the_card_equals_the_cpu(cuda):
    from tensorframes_tpu_torch import stream
    rng = np.random.default_rng(34)
    batches = [{"k": rng.integers(0, 40, 2000).astype(np.int64),
                "x": rng.normal(size=2000)} for _ in range(3)]
    table = {"k": np.arange(30, dtype=np.int64),
             "w": rng.random(30), "c": np.arange(30, dtype=np.int32) % 7}

    def run():
        sf = (stream.from_source(stream.GeneratorSource(
                  iter([dict(b) for b in batches])))
              .join(ttf.frame(dict(table)), on="k", how="inner")
              .map_blocks(lambda x, w: {"y": x * w}))
        h = sf.start()
        h.run()
        return h.collect_updates()

    on_card = run()
    ttf.set_default_device("cpu")
    try:
        on_cpu = run()
    finally:
        ttf.set_default_device("cuda")
    assert len(on_card) == len(on_cpu) == 3
    for a, b in zip(on_cpu, on_card):
        assert_frames_match(a, b)


# -- shipped computations ---------------------------------------------------

def _shipped_map(device):
    """``z = x * 2 + arange(rows)`` (a device argument in its graph),
    serialized while ``device`` is the package default."""
    from tensorframes_tpu_torch.computation import Computation, TensorSpec
    from tensorframes_tpu_torch.shape import Shape, Unknown

    prev = ttf.default_device()
    ttf.set_default_device(device)
    try:
        return Computation.trace(
            lambda x: {"z": x * 2.0 + torch.arange(
                x.shape[0], device=x.device, dtype=x.dtype)},
            [TensorSpec("x", ttf.dtypes.double, Shape(Unknown))]).serialize()
    finally:
        ttf.set_default_device(prev)


@pytest.mark.parametrize("made_on", ["cpu", "cuda"])
def test_shipped_program_runs_on_either_device(cuda, made_on):
    """A blob made with the CPU or the card as the default device runs on
    the CPU executor and on the card, with equal results."""
    from tensorframes_tpu_torch.computation import Computation
    from tensorframes_tpu_torch.engine.executor import BlockExecutor

    comp = Computation.deserialize(_shipped_map(made_on))
    x = np.random.default_rng(4).random(5000)
    on_cpu = BlockExecutor("cpu").run(comp, {"x": x})["z"]
    on_card = BlockExecutor("cuda").run(comp, {"x": x}, keep_device=True)
    assert on_card["z"].is_cuda
    np.testing.assert_array_equal(on_card["z"].cpu().numpy(), on_cpu)
    np.testing.assert_array_equal(on_cpu, x * 2.0 + np.arange(5000))
    assert set(comp.fn._placed) == {"cpu", "cuda:0"}


def test_shipped_closure_over_a_cuda_table(cuda):
    """A program closing over a table on the card is traced there and its
    archive holds the table on the CPU; it runs on both devices."""
    from tensorframes_tpu_torch.computation import Computation, TensorSpec
    from tensorframes_tpu_torch.engine.executor import BlockExecutor
    from tensorframes_tpu_torch.shape import Shape

    P = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (8, 3))).to(cuda)
    comp = Computation.trace(lambda x: {"z": ((x @ P) ** 2).sum(-1)},
                             [TensorSpec("x", ttf.dtypes.double, Shape(8))])
    shipped = Computation.deserialize(comp.serialize())
    assert all(t.device.type == "cpu"
               for t in shipped.fn.exported.constants.values())
    x = np.random.default_rng(6).standard_normal((40, 8))
    df = ttf.frame({"x": x}, num_partitions=2)
    on_card = np.concatenate([b.columns["z"] for b in
                              ttf.map_rows(shipped, df).blocks()])
    want = ((x @ P.cpu().numpy()) ** 2).sum(-1)
    np.testing.assert_allclose(on_card, want, rtol=1e-12)
    on_cpu = np.concatenate([b.columns["z"] for b in ttf.map_rows(
        shipped, df, executor=BlockExecutor("cpu")).blocks()])
    np.testing.assert_allclose(on_cpu, want, rtol=1e-12)


def test_shipped_map_into_aggregate_launches_segment_sum(cuda):
    """A deserialized ``map_blocks`` -> ``aggregate({"z": "sum"})`` on the
    card launches segment_sum once per partition."""
    from tensorframes_tpu_torch.builder import map_blocks_builder
    from tensorframes_tpu_torch.computation import Computation, TensorSpec
    from tensorframes_tpu_torch.shape import Shape, Unknown

    blob = Computation.trace(
        lambda x: {"z": x + x},
        [TensorSpec("x", ttf.dtypes.double, Shape(Unknown))]).serialize()
    rng = np.random.default_rng(7)
    key, x = rng.integers(0, 1000, 200_000), rng.random(200_000)
    df = ttf.frame({"key": key, "x": x}, num_partitions=4)
    before = segment_reduce.launches
    zf = map_blocks_builder(df).graph(blob).build()
    agg = ttf.aggregate({"z": "sum"}, zf.select(["key", "z"]).group_by("key"))
    cols = agg.blocks()[0].columns
    assert segment_reduce.launches - before == 4
    np.testing.assert_allclose(
        cols["z"], np.bincount(key, weights=2 * x, minlength=1000),
        rtol=1e-12)


def test_interner_prepares_one_program_on_the_card(cuda):
    from tensorframes_tpu_torch.computation import Computation
    from tensorframes_tpu_torch.engine.executor import (
        BlockExecutor, set_computation_interner)
    from tensorframes_tpu_torch.serve import SharedCompileCache

    blob = _shipped_map("cpu")
    ex = BlockExecutor("cuda")
    x = np.arange(1000.0)
    cache = SharedCompileCache()
    prev = set_computation_interner(cache.intern)
    try:
        outs = [ex.run(Computation.deserialize(blob), {"x": x})["z"]
                for _ in range(2)]
    finally:
        set_computation_interner(prev)
    assert ex.compile_count == 1
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 1
    ex.run(Computation.deserialize(blob), {"x": x})
    assert ex.compile_count == 2
    for z in outs:
        np.testing.assert_array_equal(z, x * 3.0)


# ---------------------------------------------------------------------------
# the segmented fold, k-means variant B's capture and B1's torch.library op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=str)
def test_segmented_fold_on_the_card_matches_the_cpu(cuda, dtype):
    """The computation form of ``aggregate`` folds on the card and agrees
    with the port's CPU result (f64 rtol 1e-12, f32 rtol 1e-5: the same
    scan tree, rounded by each device)."""
    from tensorframes_tpu_torch.engine.executor import BlockExecutor
    from tensorframes_tpu_torch.utils.tracing import counters

    rng = np.random.default_rng(12)
    n = 400_000
    df = ttf.frame({"k": rng.integers(0, 1024, n),
                    "v": rng.standard_normal(n).astype(dtype)},
                   num_partitions=4)
    fn = lambda v_input: {"v": torch.sqrt((v_input ** 2).sum(0))}  # noqa
    c0 = counters.get("aggregate.fold_calls")
    card = ttf.aggregate(fn, df.group_by("k")).blocks()[0].columns
    assert counters.get("aggregate.fold_calls") > c0
    cpu = ttf.aggregate(fn, df.group_by("k"),
                        executor=BlockExecutor("cpu")).blocks()[0].columns
    np.testing.assert_array_equal(card["k"], cpu["k"])
    assert card["v"].dtype == cpu["v"].dtype == dtype
    np.testing.assert_allclose(card["v"], cpu["v"],
                               rtol=1e-12 if dtype == np.float64 else 1e-5)


def test_capture_of_kmeans_variant_b_over_cuda_centers(cuda):
    """Variant B's program closes over centers on the card and calls
    segment_sum twice: capture settles on fake probes (B1's fake kernel)
    without launching, and the map_blocks launches B1 twice per block."""
    from tensorframes_tpu_torch.computation import Computation, TensorSpec
    from tensorframes_tpu_torch.demos import kmeans
    from tensorframes_tpu_torch.shape import Shape, Unknown

    df, init, _ = kmeans.make_data(n=20_000, num_features=8, k=16,
                                   num_partitions=4)
    before = segment_reduce.launches
    comp = Computation.trace(
        kmeans._preagg_computation(init),
        [TensorSpec("features", ttf.dtypes.double, Shape(Unknown, 8))])
    assert segment_reduce.launches == before  # capture launched nothing
    assert [(s.name, tuple(s.shape.dims)) for s in comp.outputs] == [
        ("agg_counts", (1, 16)), ("agg_distances", (1,)),
        ("agg_points", (1, 16, 8))]
    got_c, got_d = kmeans.step_preaggregate(df, init)
    assert segment_reduce.launches - before == 8
    pts = np.concatenate([b.dense("features") for b in df.blocks()])
    d = ((pts[:, None, :] - init[None]) ** 2).sum(-1)
    idx = d.argmin(1)
    want = np.stack([pts[idx == j].mean(0) if (idx == j).any() else init[j]
                     for j in range(16)])
    np.testing.assert_allclose(got_c, want, rtol=1e-9)
    assert got_d == pytest.approx(float(d.min(1).sum()), rel=1e-9)


def test_segment_sum_op_fake_kernel_and_dispatch(cuda):
    """``torch.ops.tft.segment_sum``: its fake kernel gives [S, ...] in the
    values' dtype on fake CUDA tensors and launches nothing; on real CUDA
    tensors it launches the kernel once."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = segment_reduce.launches
    with FakeTensorMode():
        v = torch.empty(1000, 3, dtype=torch.float64, device=cuda)
        ids = torch.empty(1000, dtype=torch.int32, device=cuda)
        out = torch.ops.tft.segment_sum(v, ids, 17)
        assert tuple(out.shape) == (17, 3) and out.dtype == torch.float64
        assert out.device.type == "cuda"
    assert segment_reduce.launches == before
    v = torch.randn(1000, 3, dtype=torch.float64, device=cuda)
    ids = torch.randint(0, 17, (1000,), device=cuda)
    got = torch.ops.tft.segment_sum(v, ids, 17)
    assert segment_reduce.launches == before + 1
    torch.testing.assert_close(
        got, segment_reduce.segment_sum_reference(v, ids, 17),
        rtol=1e-12, atol=0)


def test_adaptive_layout_on_the_card_stages_pinned_units(cuda, monkeypatch):
    """The re-bucketed layout on the card: each coalesced unit is merged
    once into pinned host memory when it is dispatched, and the chain's
    blocks stay bit-identical to the static layout's, boundaries
    included."""
    from tensorframes_tpu_torch.plan import adaptive, execute
    from tensorframes_tpu_torch.utils.tracing import counters
    monkeypatch.setenv("TFT_RESULT_CACHE", "0")
    monkeypatch.delenv("TFT_ADAPTIVE", raising=False)
    staged = []
    real = execute._pinned_concat

    def spy(cols):
        buf = real(cols)
        staged.append(buf)
        return buf

    monkeypatch.setattr(execute, "_pinned_concat", spy)
    x = np.random.default_rng(5).standard_normal(48_000)
    df = ttf.frame({"x": x, "k": np.arange(48_000)}, num_partitions=48)
    df.cache()
    f = lambda x: {"z": x * 2.0 + 1.0}        # noqa: E731
    q = lambda z: z > 0.5                     # noqa: E731

    def snap():
        return [(b.num_rows, {n: np.asarray(c).copy()
                              for n, c in b.columns.items()})
                for b in df.map_rows(f).filter(q).select(["k", "z"])
                .blocks()]

    adaptive.invalidate_results()
    snap()                                    # measures: static layout
    assert not staged
    layouts = counters.get("plan.adaptive_layouts")
    got = snap()                              # re-bucketed
    assert counters.get("plan.adaptive_layouts") == layouts + 1
    assert staged and all(b is not None and b.is_pinned() for b in staged)
    monkeypatch.setenv("TFT_ADAPTIVE", "0")
    want = snap()
    assert len(got) == len(want) == 48
    for (na, ca), (nb, cb) in zip(got, want):
        assert na == nb and list(ca) == list(cb)
        for n in cb:
            assert ca[n].dtype == cb[n].dtype
            assert np.array_equal(ca[n], cb[n])


def test_scheduler_serves_two_tenants_aggregates_through_the_kernel(
        cuda, monkeypatch):
    """Two tenants' keyed f64 sums served as aggregates
    (``submit(grouped, fetches)``) by a ``QueryScheduler`` with two
    workers on the card: every block's B1 launch runs on a worker thread,
    inside the served query and before its future resolves, and each
    result equals numpy's to rtol 1e-12."""
    import threading

    from tensorframes_tpu_torch import serve
    rng = np.random.default_rng(12)
    n, keys = 200_000, 1_000
    x = rng.standard_normal(n)
    k = rng.integers(0, keys, n)
    want = np.bincount(k, weights=x + x, minlength=keys)
    real = segment_reduce.segment_sum_cuda
    threads = []

    def spy(values, ids, num_segments):
        threads.append(threading.current_thread().name)
        return real(values, ids, num_segments)

    monkeypatch.setattr(segment_reduce, "segment_sum_cuda", spy)

    def query():
        df = ttf.frame({"k": k, "x": x}, num_partitions=4)
        return df.map_blocks(lambda x: {"z": x + x}).select(["k", "z"]) \
            .group_by("k")

    before = segment_reduce.launches
    with serve.QueryScheduler(workers=2, name="cuda-two") as sched:
        futs = [sched.submit(query(), {"z": "sum"}, tenant=t)
                for t in ("a", "b", "a")]
        served = [f.result(timeout=120) for f in futs]
        launched = segment_reduce.launches - before
        on = list(threads)
        for frame in served:
            got = dict((int(r["k"]), float(r["z"])) for r in frame.collect())
            np.testing.assert_allclose([got[i] for i in range(keys)], want,
                                       rtol=1e-12)
        snap = sched.snapshot()
    assert snap["a"]["completed"] == 2 and snap["b"]["completed"] == 1
    assert launched == len(on) == 3 * 4, (launched, on)
    assert threading.current_thread().name not in on, on


def test_fabric_resumes_a_lost_workers_aggregate_on_the_card(
        cuda, monkeypatch, tmp_path):
    """A three-worker ``ServeFabric`` on the card: the worker serving a
    keyed f64 aggregate (``submit(grouped, fetches)``) is lost mid-query;
    the query resumes on a survivor from its persisted checkpoint (any
    device value in it restored to the card), every B1 launch takes
    values on the card, and the result is bit-equal to the serial run."""
    from tensorframes_tpu_torch import serve
    from tensorframes_tpu_torch.memory import checkpoint
    from tensorframes_tpu_torch.observability import flight
    from tensorframes_tpu_torch.resilience import faults
    rng = np.random.default_rng(13)
    n, keys, parts = 400_000, 2_000, 16
    x = rng.standard_normal(n)
    k = rng.integers(0, keys, n)

    def query():
        df = ttf.frame({"k": k, "x": x}, num_partitions=parts)
        return df.map_blocks(lambda x: {"z": x + x}).select(["k", "z"]) \
            .group_by("k")

    def host(frame):
        c = frame.blocks()[0].columns
        return tuple(np.asarray(c[n].cpu() if hasattr(c[n], "cpu")
                                else c[n]) for n in ("k", "z"))

    serial = host(ttf.aggregate({"z": "sum"}, query()))
    restored = []
    real_restore = checkpoint._restore

    def spy_restore(t):
        v = real_restore(t)
        if t[0] == "dev":
            restored.append(v.device.type)
        return v

    monkeypatch.setattr(checkpoint, "_restore", spy_restore)
    on = []
    real_kernel = segment_reduce.segment_sum_cuda

    def spy_kernel(values, ids, num_segments):
        on.append(values.device.type)
        return real_kernel(values, ids, num_segments)

    monkeypatch.setattr(segment_reduce, "segment_sum_cuda", spy_kernel)
    import gc

    from tensorframes_tpu_torch.plan import adaptive
    adaptive.invalidate_results()
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    with serve.ServeFabric(workers=3, monitor=False,
                           persist_dir=str(tmp_path), name="cuda-fab") as fab:
        before = segment_reduce.launches
        faults.arm("worker", fail_n=1)
        fq = fab.submit(query(), {"z": "sum"}, tenant="etl")
        got = host(fq.result(timeout=300))
        launched = segment_reduce.launches - before
        lost = fab.health_snapshot()["lost"]
        recs = [r for r in flight.for_query(fq.query_id)
                if r["kind"] == "fabric.resume_dispatch"]
        workers = {r.get("worker") for r in flight.for_query(fq.query_id)
                   if r.get("worker")}
        del fq
    faults.reset()
    np.testing.assert_array_equal(got[0], serial[0])
    np.testing.assert_array_equal(got[1], serial[1])
    assert lost == 1 and recs and recs[0]["from_checkpoint"]
    assert 0 < recs[0]["resumed_blocks"] < parts
    assert len(workers) == 2, workers
    assert set(restored) <= {"cuda"}, restored
    assert launched == parts == len(on) and set(on) == {"cuda"}, \
        (launched, on)
    del fab
    adaptive.invalidate_results()
    gc.collect()
    assert torch.cuda.memory_allocated() == mem0


# -- the parallel layer on the card ------------------------------------------

@pytest.mark.parametrize("shards", [1, 4])
def test_mesh_ops_on_the_card_launch_b1_on_every_shard(cuda, shards):
    """``distribute`` -> ``dfilter`` -> ``dreduce_blocks`` ->
    ``daggregate`` (host keys and device keys) over ``shards`` logical
    shards of the card: B1 launches once per shard and float sum column,
    and every result equals the same ops over CPU shards (f64 to rtol
    1e-12, f32 to 1e-5, min and integer results exactly)."""
    from tensorframes_tpu_torch import native, parallel

    assert native.available()
    rng = np.random.default_rng(17)
    n = 100_003
    df = ttf.frame({"k": rng.integers(-50, 5_000, n), "x": rng.random(n),
                    "v": rng.random((n, 3)).astype(np.float32),
                    "c": rng.integers(0, 9, n)}, num_partitions=3)

    def mesh_of(device):
        return parallel.DeviceMesh(np.array([device] * shards, dtype=object))

    results = {}
    for where, device in (("card", cuda), ("cpu", torch.device("cpu"))):
        dist = parallel.distribute(df, mesh_of(device))
        flt = parallel.dfilter(lambda x: x > 0.1, dist)
        out = {"min": parallel.dreduce_blocks({"x": "min"},
                                              flt.select(["x"]))["x"]}
        for max_groups in (None, 8_192):
            l0 = segment_reduce.launches
            agg = parallel.daggregate({"x": "sum", "v": "sum", "c": "sum"},
                                      flt, "k", max_groups=max_groups)
            out[max_groups] = agg.blocks()[0].columns
            if where == "card":
                assert segment_reduce.launches - l0 == 2 * shards
        results[where] = out
    card, cpu = results["card"], results["cpu"]
    assert float(card["min"]) == float(cpu["min"])
    for max_groups in (None, 8_192):
        a, b = card[max_groups], cpu[max_groups]
        np.testing.assert_array_equal(a["k"], b["k"])
        np.testing.assert_array_equal(a["c"], b["c"])
        np.testing.assert_allclose(a["x"], b["x"], rtol=1e-12)
        np.testing.assert_allclose(a["v"], b["v"], rtol=1e-5)


def _card_and_cpu_meshes(cuda, shards):
    from tensorframes_tpu_torch import parallel

    return {where: parallel.DeviceMesh(np.array([device] * shards,
                                                dtype=object))
            for where, device in (("card", cuda),
                                  ("cpu", torch.device("cpu")))}


def _host_columns(frame):
    blocks = frame.blocks()
    return {n: np.concatenate([np.asarray(b.columns[n]) for b in blocks])
            for n in frame.schema.names}


@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("descending", [False, True])
def test_dsort_on_the_card_equals_the_cpu(cuda, shards, descending):
    """``dsort`` on logical shards of the card (columnsort on 8, the
    one-device program on 1) against the same sort over CPU shards, bit
    for bit, with keys holding -0.0 and 0.0, NaN and -NaN, +-inf and the
    integer extremes, at a size where the card sorts by radix."""
    from tensorframes_tpu_torch import parallel

    rng = np.random.default_rng(23)
    n = 200_003
    f = np.round(rng.standard_normal(n), 2)
    f[rng.choice(n, 600, replace=False)] = [0.0, -0.0, np.nan, -np.nan,
                                            np.inf, -np.inf] * 100
    i = rng.integers(-40, 40, n)
    i[::997] = np.iinfo(np.int64).min
    i[5::991] = np.iinfo(np.int64).max
    df = ttf.frame({"f": f, "f32": f.astype(np.float32), "i": i,
                    "tag": np.arange(n)}, num_partitions=3)
    out = {}
    for where, mesh in _card_and_cpu_meshes(cuda, shards).items():
        dist = parallel.distribute(df, mesh)
        out[where] = [_host_columns(parallel.dsort(
            keys, dist, descending=descending).collect_frame())
            for keys in ("f", "f32", ["i", "f"])]
    for card, cpu in zip(out["card"], out["cpu"]):
        for name in card:
            np.testing.assert_array_equal(card[name], cpu[name])


@pytest.mark.parametrize("dtype", ["int64", "int32", "float64", "float32"])
def test_dexchange_on_the_card_places_by_the_host_hash(cuda, dtype):
    """The device key hash on the card places every row on the shard the
    CPU shards' exchange picks, in the same order, and for exact key
    dtypes on ``exchange_hash_host(keys) % 8``."""
    from tensorframes_tpu_torch import parallel

    rng = np.random.default_rng(29)
    n = 100_000
    k = (rng.standard_normal(n) * 1e4).astype(dtype)
    if dtype.startswith("float"):
        k[:6] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
    else:
        k[:2] = [np.iinfo(dtype).min, np.iinfo(dtype).max]
    df = ttf.frame({"k": k, "tag": np.arange(n)}, num_partitions=2)
    out = {}
    for where, mesh in _card_and_cpu_meshes(cuda, 8).items():
        ex = parallel.dexchange("k", parallel.distribute(df, mesh))
        rows = ex.padded_rows // 8
        tag = ex.host_read_padded("tag")
        out[where] = [tag[s * rows:s * rows + int(c)]
                      for s, c in enumerate(ex.per_shard_valid())]
    for a, b in zip(out["card"], out["cpu"]):
        np.testing.assert_array_equal(a, b)
    if dtype != "float32":
        dest = (parallel.exchange.exchange_hash_host([k])
                % np.uint64(8)).astype(np.int64)
        for s, tags in enumerate(out["card"]):
            np.testing.assert_array_equal(tags, np.flatnonzero(dest == s))


def test_shuffle_aggregate_and_joins_on_the_card(cuda, monkeypatch):
    """``shuffle_daggregate`` (B1 once per shard), the partitioned join and
    the mesh sort-merge join on 8 logical shards of the card, against the
    same calls over CPU shards."""
    from tensorframes_tpu_torch import parallel, relational

    monkeypatch.setenv("TFT_BROADCAST_LIMIT_BYTES", "1000")
    rng = np.random.default_rng(31)
    n = 50_000
    df = ttf.frame({"k": rng.integers(0, 20_000, n), "x": rng.random(n),
                    "c": rng.integers(-9, 9, n)}, num_partitions=4)
    left = ttf.frame({"k": rng.integers(0, 8_000, n), "lv": rng.random(n)},
                     num_partitions=3)
    right = ttf.frame({"k": rng.permutation(6_000), "w": rng.random(6_000)})
    out = {}
    for where, mesh in _card_and_cpu_meshes(cuda, 8).items():
        l0 = segment_reduce.launches
        agg = parallel.shuffle_daggregate(
            {"x": "sum", "c": "max"}, parallel.distribute(df, mesh), "k")
        res = {"agg": _host_columns(agg)}
        if where == "card":
            assert segment_reduce.launches - l0 == 8
        part = relational.join(left, right, "k", mesh=mesh)
        assert part._join_route["strategy"] == "partitioned"
        res["part"] = _host_columns(part)
        res["blocks"] = [b.num_rows for b in part.blocks()]
        res["smj"] = _host_columns(relational.sort_merge_join(
            left, right, "k", mesh=mesh))
        out[where] = res
    card, cpu = out["card"], out["cpu"]
    np.testing.assert_array_equal(card["agg"]["k"], cpu["agg"]["k"])
    np.testing.assert_array_equal(card["agg"]["c"], cpu["agg"]["c"])
    np.testing.assert_allclose(card["agg"]["x"], cpu["agg"]["x"], rtol=1e-12)
    assert card["blocks"] == cpu["blocks"]
    for name in ("part", "smj"):
        for c in card[name]:
            np.testing.assert_array_equal(card[name][c], cpu[name][c])


def _reset_elastic():
    from tensorframes_tpu_torch.parallel import elastic
    from tensorframes_tpu_torch.resilience import faults
    faults.reset()
    elastic._tracker.clear()
    elastic._upgrades.clear()
    elastic._lost_pool.clear()


def test_device_loss_on_card_shards_is_bit_identical(cuda):
    """A device lost on 8 logical shards of the card: the op shrinks onto
    7 shards of the same card, its result bit-identical to the healthy
    run, B1 launched once per surviving shard and sum column."""
    from tensorframes_tpu_torch import parallel
    from tensorframes_tpu_torch.resilience import faults

    _reset_elastic()
    rng = np.random.default_rng(37)
    n = 200_000
    df = ttf.frame({"key": rng.integers(0, 5_000, n), "x": rng.random(n),
                    "i": rng.integers(-50, 50, n)}, num_partitions=4)
    mesh = _card_and_cpu_meshes(cuda, 8)["card"]
    try:
        dist = parallel.distribute(df, mesh)
        healthy_map = parallel.dmap_blocks(lambda x: {"z": x + x}, dist)
        healthy = parallel.daggregate({"z": "sum", "i": "sum"},
                                      healthy_map.select(["key", "z", "i"]),
                                      "key")
        with faults.inject("device", 1,
                           message="DEVICE_LOST: injected: device 2 is "
                                   "lost"):
            lost_map = parallel.dmap_blocks(lambda x: {"z": x + x}, dist)
        assert lost_map.mesh.num_data_shards == 7
        assert all(d.type == "cuda" for d in lost_map.mesh.shard_devices())
        np.testing.assert_array_equal(
            _host_columns(lost_map.collect_frame())["z"],
            _host_columns(healthy_map.collect_frame())["z"])
        l0 = segment_reduce.launches
        with faults.inject("device", 1):
            agg = parallel.daggregate(
                {"z": "sum", "i": "sum"},
                healthy_map.select(["key", "z", "i"]), "key")
        torch.cuda.synchronize()
        assert segment_reduce.launches - l0 == 7  # one float sum column
        got, want = _host_columns(agg), _host_columns(healthy)
        np.testing.assert_array_equal(got["key"], want["key"])
        np.testing.assert_array_equal(got["i"], want["i"])
        np.testing.assert_allclose(got["z"], want["z"], rtol=1e-12)
    finally:
        _reset_elastic()


def test_lost_cpu_slot_never_moves_a_card_frame_to_the_cpu(cuda):
    """A card mesh and a CPU mesh of 8 slots each, in one process, lose
    their slot 0 (the ids repeat across meshes). Admitting onto the card
    frame takes the card's own slot back, never the CPU's: every shard
    stays on the card, and the CPU frame's slot comes back to the CPU."""
    from tensorframes_tpu_torch import parallel
    from tensorframes_tpu_torch.parallel import elastic
    from tensorframes_tpu_torch.resilience import faults

    _reset_elastic()
    meshes = _card_and_cpu_meshes(cuda, 8)
    x = np.arange(80_000, dtype=np.float64)
    df = ttf.frame({"x": x}, num_partitions=2)
    try:
        shrunk = {}
        for where in ("card", "cpu"):
            dist = parallel.distribute(df, meshes[where])
            with faults.inject("device", 1,
                               message="DEVICE_LOST: injected: device 0 "
                                       "is lost"):
                shrunk[where] = parallel.dmap_blocks(
                    lambda x: {"z": x + x}, dist)
            assert shrunk[where].mesh.num_data_shards == 7
        assert elastic.lost_pool() == [0]
        for where, kind in (("card", "cuda"), ("cpu", "cpu")):
            grown = parallel.admit_devices(shrunk[where])
            assert grown.mesh.num_data_shards == 8
            assert sorted(grown.mesh.flat_ids()) == list(range(8))
            assert all(d.type == kind for d in grown.mesh.shard_devices())
            for a in grown.columns.values():
                assert all(t.device.type == kind for t in a.shards)
            np.testing.assert_array_equal(
                _host_columns(grown.collect_frame())["z"], x + x)
        assert elastic.lost_pool() == []
    finally:
        _reset_elastic()


def test_fused_aggregate_launches_b1_once_per_shard(cuda):
    """``dmap -> daggregate`` through ``lazy()`` on 8 shards of the card:
    one mesh dispatch, B1 launched once per shard, equal to the eager
    chain and no fallback."""
    from tensorframes_tpu_torch import parallel
    from tensorframes_tpu_torch.utils.tracing import counters

    rng = np.random.default_rng(41)
    n = 100_000
    df = ttf.frame({"key": rng.integers(0, 3_000, n), "x": rng.random(n)},
                   num_partitions=4)
    dist = parallel.distribute(df, _card_and_cpu_meshes(cuda, 8)["card"])

    def chain(d):
        return parallel.daggregate(
            {"z": "sum"}, parallel.dmap_blocks(
                lambda x: {"z": x * 3.0}, d).select(["key", "z"]), "key")

    eager = _host_columns(chain(dist))
    d0, f0 = counters.get("mesh.dispatches"), counters.get("dplan.fallbacks")
    l0 = segment_reduce.launches
    fused = _host_columns(chain(dist.lazy()))
    torch.cuda.synchronize()
    assert segment_reduce.launches - l0 == 8
    assert counters.get("mesh.dispatches") - d0 == 1
    assert counters.get("dplan.fallbacks") == f0
    np.testing.assert_array_equal(fused["key"], eager["key"])
    np.testing.assert_allclose(fused["z"], eager["z"], rtol=1e-12)


def test_card_shard_times_reach_the_skew_tracker_cumulative(cuda,
                                                            monkeypatch):
    """While a trace is active, a mesh op on the card times each shard
    with a CUDA event after its work, measured from one start event: the
    times reach ``note_dispatch`` in cumulative (non-decreasing) order,
    one per shard, and land as ``shard_compute`` events once the trace
    is read after the work is done: the dispatch itself never waits."""
    from tensorframes_tpu_torch import parallel
    from tensorframes_tpu_torch.observability import events
    from tensorframes_tpu_torch.parallel import elastic
    from tensorframes_tpu_torch.utils import tracing

    seen = []
    real = elastic.note_dispatch
    monkeypatch.setattr(elastic, "note_dispatch",
                        lambda m, op, times: (seen.append((op, list(times))),
                                              real(m, op, times)))
    rng = np.random.default_rng(43)
    df = ttf.frame({"x": rng.random(400_000)}, num_partitions=2)
    dist = parallel.distribute(df, _card_and_cpu_meshes(cuda, 8)["card"])
    tracing.enable()
    try:
        parallel.dmap_blocks(lambda x: {"z": torch.sin(x) * x}, dist)
        trace = events.last_query()
        torch.cuda.synchronize()
        trace.settle()
    finally:
        tracing.disable()
        elastic._tracker.clear()
    ops = [op for op, _ in seen]
    assert "dmap_blocks" in ops
    times = seen[ops.index("dmap_blocks")][1]
    assert len(times) == 8
    assert all(t > 0.0 for t in times)
    assert all(b >= a for a, b in zip(times, times[1:]))
    comp = [ev for ev in trace.events if ev.etype == "shard_compute"]
    assert [ev.args["device"] for ev in comp] == list(range(8))
    assert [ev.dur for ev in comp] == times


def test_traced_card_dispatch_records_no_event_wait(cuda, monkeypatch):
    """A traced mesh op on the card calls no ``Event.synchronize``; its
    shard times are recorded once the trace is read after the work."""
    from tensorframes_tpu_torch import parallel
    from tensorframes_tpu_torch.observability import events
    from tensorframes_tpu_torch.utils import tracing

    waits = []
    real = torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda ev: (waits.append(ev), real(ev)))
    df = ttf.frame({"x": np.arange(400_000.0)}, num_partitions=2)
    dist = parallel.distribute(df, _card_and_cpu_meshes(cuda, 8)["card"])
    tracing.enable()
    try:
        parallel.dmap_blocks(lambda x: {"z": torch.sin(x) * x}, dist)
        trace = events.last_query()
    finally:
        tracing.disable()
    assert waits == []
    torch.cuda.synchronize()
    assert trace.count("shard_compute") == 8


def test_outputs_staged_off_the_card_open_the_stage_out_span(cuda):
    """A block whose outputs go to the host from the card opens
    ``executor.stage_out`` once; one whose outputs stay there opens none."""
    from tensorframes_tpu_torch.utils import tracing

    comp = ttf.Computation.trace(
        lambda x: {"z": x * 2.0},
        [ttf.TensorSpec("x", ttf.dtypes.float32, ttf.Shape(-1))])
    x = np.arange(1 << 16, dtype=np.float32)
    tracing.timings.reset()
    tracing.enable()
    try:
        out = ttf.BlockExecutor().submit(comp, {"x": x}).drain()
        ttf.BlockExecutor().submit(comp, {"x": x}, keep_device=True).drain()
        snap = tracing.timings.snapshot()
    finally:
        tracing.disable()
        tracing.timings.reset()
    np.testing.assert_array_equal(out["z"], x * 2.0)
    assert snap["executor.stage_out"]["count"] == 1


# -- the transformer on a mesh of card shards ---------------------------------

MESH_CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)


def _shards(device, shape, names):
    from tensorframes_tpu_torch import parallel

    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = [torch.device(device)] * devs.size
    return parallel.DeviceMesh(devs.reshape(shape), names,
                               data_axis=names[0])


def _mesh_run(device, make, steps=3):
    """``steps`` adam steps of ``make(model, mesh-of(device))`` from the
    JAX package's initial parameters on one numpy batch: ``(losses,
    global parameters on the CPU, B2 forward and backward launches)``."""
    cfg, build = make
    jm = JaxLM(JaxConfig(**cfg))
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))))
    model = TransformerLM(TransformerConfig(**cfg), device=device)
    step, init_state, to_init = build(model, device)
    state = init_state(to_init(params, cfg))
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg["vocab_size"], (8, 8)))
    before = (fa.launches, fab.launches)
    losses = []
    for _ in range(steps):
        state, loss = step(state, tok, torch.roll(tok, -1, 1))
        losses.append(float(loss))
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    counts = (fa.launches - before[0], fab.launches - before[1])
    whole = step.gather(state, torch.device("cpu"))["params"]
    return losses, whole, counts


def _stacked(params, cfg):
    layers = {n: torch.stack([params[f"layers.{i}.{n}"]
                              for i in range(cfg["n_layers"])])
              for n in ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2")}
    P = 2
    return {"outer": {n: params[n] for n in ("embed", "ln_f", "head")},
            "stages": {n: a.reshape((P, cfg["n_layers"] // P) + a.shape[1:])
                       for n, a in layers.items()}}


_MESH_CASES = {
    # name: (config, build(model, device) -> (step, init_state, to_init),
    #        B2 launches a step: layers x (data, model) shards)
    "data8": (MESH_CFG, lambda m, d: m.make_sharded_train_step(
        _shards(d, (8,), ("data",)), learning_rate=1e-2)
        + (lambda p, c: p,), 2 * 8),
    "data2_model4": (MESH_CFG, lambda m, d: m.make_sharded_train_step(
        _shards(d, (2, 4), ("data", "model")), learning_rate=1e-2)
        + (lambda p, c: p,), 2 * 8),
    "data2_model2_seq2": (MESH_CFG, lambda m, d: m.make_sharded_train_step(
        _shards(d, (2, 2, 2), ("data", "model", "seq")), seq_axis="seq",
        learning_rate=1e-2) + (lambda p, c: p,), 0),
    "moe_data2_model2_expert2": (
        dict(MESH_CFG, num_experts=4), lambda m, d: m.make_sharded_train_step(
            _shards(d, (2, 2, 2), ("data", "model", "expert")),
            expert_axis="expert", learning_rate=1e-2)
        + (lambda p, c: p,), 2 * 4),
    "pipeline_data2_pipe2": (
        dict(MESH_CFG, n_layers=4), lambda m, d: m.make_pipelined_train_step(
            _shards(d, (2, 2), ("data", "pipe")), learning_rate=1e-2)
        + (_stacked,), 4 * 2 * 2),
}


@pytest.mark.parametrize("case", list(_MESH_CASES))
def test_mesh_train_steps_on_the_card_match_the_cpu(cuda, case):
    """The dense, MoE and pipelined mesh steps on 8 (or 4) logical shards
    of the card against the same steps on CPU slots: losses to 2e-5
    relative (step 0 to 1e-5), parameters after 3 adam steps to 1e-4 of
    each one's max-abs (B2's 3xTF32 products against the CPU's f32 ones);
    B2 and its backward launched once per layer and (data, model) shard,
    or microbatch and data shard, a step (none through the ring)."""
    cfg, build, per_step = _MESH_CASES[case]
    ttf.set_default_device("cpu")
    want_losses, want, _ = _mesh_run("cpu", (cfg, build))
    ttf.set_default_device("cuda")
    losses, got, counts = _mesh_run("cuda", (cfg, build))
    for i, (a, b) in enumerate(zip(losses, want_losses)):
        assert abs(a - b) <= (1e-5 if i == 0 else 2e-5) * abs(b), (i, a, b)
    flat = got if "stages" not in got else {
        **{f"o.{k}": v for k, v in got["outer"].items()},
        **{f"s.{k}": v for k, v in got["stages"].items()}}
    ref = want if "stages" not in want else {
        **{f"o.{k}": v for k, v in want["outer"].items()},
        **{f"s.{k}": v for k, v in want["stages"].items()}}
    for name, w in ref.items():
        err = float((flat[name] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (name, err)
    assert counts == (3 * per_step,) * 2, counts


def test_ring_and_allreduce_on_the_card_match_the_cpu(cuda):
    from tensorframes_tpu_torch import parallel

    rng = np.random.default_rng(44)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, 64, 4, 16), dtype=np.float32)) for _ in range(3))
    kw = dict(seq_axis="seq", causal=True, batch_axis="data",
              head_axis="model")
    names = ("data", "seq", "model")
    want = parallel.ring_attention(q, k, v, _shards("cpu", (2, 2, 2), names),
                                   **kw)
    got = parallel.ring_attention(q.cuda(), k.cuda(), v.cuda(),
                                  _shards("cuda", (2, 2, 2), names), **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    x = torch.from_numpy(rng.random((8, 1001), dtype=np.float32))
    torch.testing.assert_close(
        parallel.ring_allreduce(x.cuda(), _shards("cuda", (8,), ("data",)))
        .cpu(), x.sum(0).expand(8, -1), rtol=1e-6, atol=0)


def test_two_ranks_share_the_card_under_gloo(cuda, tmp_path):
    """Two rank processes on the one card (gloo, 4 logical shards each):
    the JAX cluster worker's dmap, monoid-aggregate and dsort steps at
    its sizes, each checked against numpy in the rank, bit-identical
    across the ranks, B1 launched on each rank's 4 shards."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    from tensorframes_tpu_torch.ops import _build

    _build.build("segment_sum", "host_runtime")  # once, before the ranks
    cfg = {"device": "cuda", "shards": 4, "rows": [23, 17],
           "data": "worker", "seed": 0, "max_groups": 8,
           "composite_groups": 16, "below": 500.0,
           "ckpt": str(tmp_path / "ckpt"), "backend": None,
           "steps": ["dmap", "daggregate_monoid", "dsort"]}
    runs = chip_smoke.run_cluster(cfg, world=2, timeout=300,
                                  env={"TFT_BOOTSTRAP_TIMEOUT": "120"})
    reps = [r["report"] for r in runs]
    for run, rep in zip(runs, reps):
        assert run["rc"] == 0 and rep["failed"] is None, run["out"][-3000:]
        assert rep["backend"] == "gloo"
        assert rep["steps"]["daggregate_monoid"]["b1_launches"] == 4
    for step in cfg["steps"]:
        assert reps[0]["steps"][step]["digest"] == \
            reps[1]["steps"][step]["digest"], step


def test_native_core_runs_packages_on_the_card(cuda):
    """The native execution core on the card: a CUDA package of an f64 and
    an f32 ``x * 2.5 + 1`` bit-equal to the eager run (Triton's code
    compiled without FMA contraction), at 1, 2 and 1,000,003 rows from one
    package; a program that calls segment_sum launches B1 from inside its
    package, bit-equal to the eager run."""
    from tensorframes_tpu_torch import dtypes as tdt
    from tensorframes_tpu_torch import native_pjrt
    from tensorframes_tpu_torch.computation import Computation, TensorSpec
    from tensorframes_tpu_torch.engine.executor import BlockExecutor
    from tensorframes_tpu_torch.shape import Shape, Unknown

    ex = native_pjrt.PjrtBlockExecutor()
    assert ex.client.platform == "cuda" and ex.resolve().type == "cuda"
    eager = BlockExecutor("cuda")
    comp = Computation.trace(
        lambda x, y: {"a": x * 2.5 + 1.0, "b": y * 2.5 + 1.0},
        [TensorSpec("x", tdt.double, Shape(Unknown)),
         TensorSpec("y", tdt.float32, Shape(Unknown))])
    rng = np.random.default_rng(3)
    for n in (1, 2, 1_000_003):
        arrays = {"x": rng.standard_normal(n),
                  "y": rng.standard_normal(n).astype(np.float32)}
        got, want = ex.run(comp, arrays), eager.run(comp, arrays)
        for k in ("a", "b"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert ex.compile_count == 1
    seg = Computation.trace(
        lambda k, v: {"s": segment_reduce.segment_sum(v, k, 1000)},
        [TensorSpec("k", tdt.int64, Shape(Unknown)),
         TensorSpec("v", tdt.double, Shape(Unknown))])
    arrays = {"k": rng.integers(0, 1000, 250_000),
              "v": rng.random(250_000)}
    before = segment_reduce.launches
    got = ex.run(seg, arrays)
    torch.cuda.synchronize()
    assert segment_reduce.launches - before == 1
    np.testing.assert_array_equal(got["s"], eager.run(seg, arrays)["s"])


def test_native_mesh_aggregate_launches_b1_inside_its_package(cuda,
                                                              monkeypatch):
    """A monoid ``daggregate`` on 4 logical shards of the card through the
    native mesh (``TFT_EXECUTOR=pjrt``): one SPMD package, one dispatch,
    B1 launched once a shard from inside it, equal to the eager route."""
    from tensorframes_tpu_torch import parallel
    from tensorframes_tpu_torch.parallel import native_mesh

    rng = np.random.default_rng(41)
    n, keys = 400_003, 1_000
    key = rng.integers(0, keys, n)
    x = rng.random(n)
    mesh = parallel.DeviceMesh(np.array([torch.device("cuda")] * 4,
                                        dtype=object))
    df = ttf.frame({"key": key, "x": x})
    eager = parallel.daggregate({"x": "sum"}, parallel.distribute(df, mesh),
                                "key")
    monkeypatch.setenv("TFT_EXECUTOR", "pjrt")
    ex = native_mesh.executor_for(mesh)
    assert ex is not None and ex.client.platform == "cuda"
    dist = parallel.distribute(df, mesh)
    d0, b0 = ex.dispatch_count, segment_reduce.launches
    got = parallel.daggregate({"x": "sum"}, dist, "key")
    torch.cuda.synchronize()
    assert ex.dispatch_count == d0 + 1
    assert segment_reduce.launches - b0 == 4  # B1 on every shard, inside
    g, e = got.blocks()[0].columns, eager.blocks()[0].columns
    np.testing.assert_array_equal(g["key"], e["key"])
    np.testing.assert_allclose(g["x"], e["x"], rtol=1e-12)
    np.testing.assert_allclose(
        g["x"], np.bincount(key, weights=x, minlength=keys)[g["key"]],
        rtol=1e-12)
