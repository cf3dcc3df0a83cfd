"""Module by module, the port's data model, capture and engine parts against
the JAX package's: ``shape``, ``dtypes``, ``schema``, ``marshal``,
``computation``, ``engine/compaction``, ``engine/pipeline``,
``engine/executor`` and ``utils/tracing``. Everything compared here is
host-side metadata or exact arithmetic, so the comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import marshal as jmarshal
from tensorframes_tpu.engine import compaction as jcompaction
from tensorframes_tpu.engine import pipeline as jpipeline
from tensorframes_tpu_torch import marshal as tmarshal
from tensorframes_tpu_torch.engine import compaction as tcompaction
from tensorframes_tpu_torch.engine import pipeline as tpipeline
from tensorframes_tpu_torch.utils import tracing as ttracing
from torch_parity import assert_frames_match, schema_tuple


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    yield
    ttf.set_default_device(prev)


def _same(fn, framework_errors=False):
    """``fn(module)`` for both packages: equal results, or the same
    exception type and message. With ``framework_errors`` an error is
    raised by each framework's own code (a user program that fails), so
    only the fact that both raised is compared."""
    out = []
    for m in (jtf, ttf):
        try:
            out.append(("ok", fn(m)))
        except Exception as e:  # noqa: BLE001 - compared across packages
            out.append(("err",) if framework_errors
                       else ("err", type(e).__name__, str(e)))
    assert out[1] == out[0]
    return out[0]


# ---------------------------------------------------------------------------
# shape
# ---------------------------------------------------------------------------

SHAPES = [(), (-1,), (3,), (-1, 3), (-1, -1), (2, 3), (-1, 1, 4), (1,)]


@pytest.mark.parametrize("a", SHAPES, ids=str)
def test_shape_algebra(a):
    for b in SHAPES:
        _same(lambda m: (repr(m.Shape(*a)), m.Shape(*a).ndim,
                         m.Shape(*a).is_more_precise_than(m.Shape(*b)),
                         repr(m.Shape(*a).merge(m.Shape(*b))),
                         repr(m.Shape(*a).broadcast_with(m.Shape(*b))),
                         repr(m.Shape(*a).prepend(-1)),
                         m.Shape(*a).num_elements, m.Shape(*a).has_unknown))


def test_shape_tail_head_and_concrete():
    _same(lambda m: (repr(m.Shape(-1, 3).tail), m.Shape(-1, 3).head,
                     repr(m.Shape(4, 3).with_lead(-1)),
                     m.Shape(-1, 3).matches_concrete((7, 3)),
                     m.Shape(-1, 3).matches_concrete((7, 2))))
    _same(lambda m: m.Shape(-1, 3).assert_concrete("ctx"))


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["double", "float64", "f64", "float", "f32",
                                  "long", "i64", "int", "int32", "bfloat16",
                                  "bf16", "string", "nope"])
def test_dtype_vocabulary(name):
    _same(lambda m: (m.dtypes.by_name(name).name,
                     m.dtypes.by_name(name).np_storage,
                     m.dtypes.by_name(name).priority,
                     m.dtypes.by_name(name).tensor,
                     m.dtypes.by_name(name).is_floating))


def test_dtype_inference_and_widening():
    for dt in (np.float64, np.float32, np.float16, np.int64, np.int32,
               np.int8, np.uint16, np.bool_, np.str_, np.complex64):
        _same(lambda m: m.dtypes.from_numpy(dt).name)
    for v in (True, 3, 2.5, np.float32(1.0), np.int32(2), "s"):
        _same(lambda m: m.dtypes.from_python_value(v).name)
    names = ["double", "float", "long", "int", "bfloat16"]
    for a in names:
        for b in names:
            _same(lambda m: m.dtypes.widen(m.dtypes.by_name(a),
                                           m.dtypes.by_name(b)).name)


def test_device_dtype_policy():
    """double and long stay 64-bit on every device (the JAX package's CPU
    tests with x64); bfloat16 computes as torch.bfloat16."""
    want = {"double": torch.float64, "float": torch.float32,
            "long": torch.int64, "int": torch.int32,
            "bfloat16": torch.bfloat16}
    for name, tdt in want.items():
        got = ttf.dtypes.device_dtype(ttf.dtypes.by_name(name))
        assert got == tdt
        ref = jtf.dtypes.device_dtype(jtf.dtypes.by_name(name), "cpu")
        assert str(got).replace("torch.", "") == str(ref)
    with pytest.raises(ValueError, match="cannot be device tensors"):
        ttf.dtypes.device_dtype(ttf.dtypes.string)


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

def test_schema_inference_tree_and_merge(rng):
    cols = {"x": rng.standard_normal(4), "k": np.arange(4),
            "m": rng.standard_normal((4, 2, 3)),
            "f": np.ones(4, np.float32),
            "s": np.array(list("abcd"), dtype=object)}
    _same(lambda m: m.Schema.from_numpy_columns(cols).tree_string())
    _same(lambda m: schema_tuple(m.Schema.from_numpy_columns(cols)))
    _same(lambda m: repr(m.Schema.of(a="double", b="long", c="bf16")))
    _same(lambda m: schema_tuple(m.Schema.of(a="double").merged(
        m.Schema.of(a="double", b="int"))))
    _same(lambda m: m.Schema.of(a="double").merged(m.Schema.of(a="long")))
    _same(lambda m: m.Schema.of(a="double").select(["zz"]))


# ---------------------------------------------------------------------------
# marshal
# ---------------------------------------------------------------------------

MARSHAL_ROWS = {
    "dense": ([(1.0, 2, [1.0, 2.0]), (3.0, 4, [3.0, 4.0])], ["x", "n", "v"]),
    "ragged": ([(1, [1.0]), (2, [2.0, 3.0]), (3, [])], ["k", "v"]),
    "strings": ([("a", 1.0), ("bb", 2.0)], ["s", "x"]),
    "matrix": ([([[1.0, 2.0], [3.0, 4.0]],), ([[5.0, 6.0], [7.0, 8.0]],)],
               ["m"]),
}


@pytest.mark.parametrize("case", sorted(MARSHAL_ROWS))
@pytest.mark.parametrize("fast", [True, False])
def test_rows_columns_round_trip(case, fast):
    rows, names = MARSHAL_ROWS[case]
    jschema = jtf.frame(rows, columns=names).schema
    tschema = ttf.frame(rows, columns=names).schema
    jcols = jmarshal.rows_to_columns(rows, jschema, fast=fast)
    tcols = tmarshal.rows_to_columns(rows, tschema, fast=fast)
    assert list(tcols) == list(jcols)
    for n in jcols:
        if isinstance(jcols[n], np.ndarray):
            assert tcols[n].dtype == jcols[n].dtype
            np.testing.assert_array_equal(tcols[n], jcols[n])
        else:
            assert [c.tolist() for c in tcols[n]] == \
                [c.tolist() for c in jcols[n]]
    jback = jmarshal.columns_to_rows(jcols, jschema, fast=fast)
    tback = tmarshal.columns_to_rows(tcols, tschema, fast=fast)
    assert repr(tback) == repr(jback)


@pytest.mark.parametrize("n,dims", [(12, (-1, 3)), (12, (4, 3)),
                                    (12, (5, 3)), (10, (-1, 3)),
                                    (0, (-1, 3)), (12, (-1, -1))])
def test_infer_physical_shape(n, dims):
    _same(lambda m: (jmarshal if m is jtf else tmarshal)
          .infer_physical_shape(n, m.Shape(*dims), "ctx"))


# ---------------------------------------------------------------------------
# computation: output specs from capture
# ---------------------------------------------------------------------------

CAPTURE = {
    "add_const": (lambda x: {"z": x + 3.0}, (-1,), "double"),
    "static_61": (lambda v: {"w": v * 2, "s": v.sum(1), "h": v[:, :3]},
                  (-1, 61), "double"),
    "clamped_slice": (lambda v: {"w": v[:61]}, (-1,), "double"),
    "one_row": (lambda v: {"w": v[:1]}, (-1,), "double"),
    "reduce_rows_dim": (lambda v: {"w": v.sum(0)}, (-1, 2), "double"),
    "outer": (lambda v: {"w": v[:, None] * v[None, :]}, (-1,), "double"),
    "bool_out": (lambda v: {"p": v > 0}, (-1,), "double"),
    "int_keeps_type": (lambda v: {"q": v * 2}, (-1,), "int"),
    "float32": (lambda v: {"q": v + v}, (-1, 4), "float"),
    "bf16": (lambda v: {"q": v * 2}, (-1,), "bfloat16"),
    "not_reshapable": (lambda v: {"w": v.reshape(-1, 2)}, (-1,), "double"),
    "single_tensor": (lambda v: v * 2, (-1,), "double"),
}


@pytest.mark.parametrize("case", sorted(CAPTURE))
def test_capture_output_specs(case):
    fn, dims, dtype = CAPTURE[case]
    got = _same(lambda m: [repr(s) for s in m.Computation.trace(
        fn, [m.TensorSpec("v" if "x" not in fn.__code__.co_varnames
                          else "x", m.dtypes.by_name(dtype),
                          m.Shape(*dims))]).outputs], framework_errors=True)
    assert got[0] == ("err" if case == "not_reshapable" else "ok")


def test_capture_data_dependent_shape_probes_on_cpu():
    """``x[x > 0]`` has no meta shape: one tiny real CPU probe decides, and
    the row count it keeps depends on the data, so the dim is Unknown."""
    comp = ttf.Computation.trace(
        lambda x: {"z": x[x > 0]},
        [ttf.TensorSpec("x", ttf.dtypes.double, ttf.Shape(-1))])
    assert repr(comp.outputs) == "(z:double[?],)"
    df = ttf.frame({"x": np.array([-1.0, 2.0, -3.0, 4.0, 5.0])},
                   num_partitions=2)
    out = ttf.map_blocks(lambda x: {"z": x[x > 0]}, df, trim=True)
    assert [b.num_rows for b in out.blocks()] == [1, 2]
    assert [r["z"] for r in out.collect()] == [2.0, 4.0, 5.0]


def test_capture_of_a_closure_over_other_tensors_runs_nothing():
    """A program that mixes its inputs with a tensor it closes over fails
    on meta inputs; fake tensors then carry the shapes, so capture still
    runs nothing on data (as the JAX package's eval_shape) and gives the
    JAX package's specs."""
    from torch._subclasses.fake_tensor import is_fake

    seen = []

    def fn(v):
        seen.append("real" if v.device.type == "cpu" and not is_fake(v)
                    else "abstract")
        return {"y": v @ torch.arange(6.0, dtype=torch.float64).reshape(3, 2)}

    comp = ttf.Computation.trace(
        fn, [ttf.TensorSpec("v", ttf.dtypes.double, ttf.Shape(-1, 3))])
    want = jtf.Computation.trace(
        lambda v: {"y": v @ jnp.arange(6.0).reshape(3, 2)},
        [jtf.TensorSpec("v", jtf.dtypes.double, jtf.Shape(-1, 3))])
    assert repr(comp.outputs) == repr(want.outputs) == "(y:double[?,2],)"
    assert seen and set(seen) == {"abstract"}


def test_capture_probes_fake_tensors_on_the_default_cuda_device(
        monkeypatch):
    """A program closing over CUDA tensors (the card's constants) fails
    every probe with CPU inputs, meta and fake alike (``mm`` will not mix
    devices); capture then probes fake tensors on the package's default
    CUDA device before it runs anything on the CPU. Without a card the
    probe order is what can be checked here; ``tests/test_torch_cuda.py``
    runs such a closure on the card."""
    from tensorframes_tpu_torch import computation as tcomp

    tried = []
    real = tcomp._run_probe

    def probe(dict_fn, specs, shapes, device):
        tried.append(device)
        if device != "fake:cuda":
            raise RuntimeError("Expected all tensors to be on the same "
                               "device")
        return real(dict_fn, specs, shapes, device)

    monkeypatch.setattr(tcomp, "_run_probe", probe)
    prev = ttf.default_device()
    try:
        ttf.set_default_device("cuda")
        comp = ttf.Computation.trace(
            lambda v: {"y": v * 2.0},
            [ttf.TensorSpec("v", ttf.dtypes.float32, ttf.Shape(-1, 3))])
        assert repr(comp.outputs) == "(y:float[?,3],)"
        assert tried[:4] == ["meta", "fake", "fake:cuda", "fake:cuda"]
        assert "cpu" not in tried
        tried.clear()
        ttf.set_default_device("cpu")
        with pytest.raises(RuntimeError, match="same device"):
            ttf.Computation.trace(
                lambda v: {"y": v * 2.0},
                [ttf.TensorSpec("v", ttf.dtypes.float32, ttf.Shape(-1, 3))])
        assert tried == ["meta", "fake", "cpu"]
    finally:
        ttf.set_default_device(prev)


def test_analyze_graph_summaries():
    def build(m):
        comp = m.Computation.trace(
            lambda x, v: {"z": x + 1.0, "w": v * 2.0},
            [m.TensorSpec("x", m.dtypes.double, m.Shape(-1)),
             m.TensorSpec("v", m.dtypes.double, m.Shape(-1, 3))])
        return [repr(s) for s in m.analyze_graph(
            comp, shape_hints={"x": m.Shape(5)}, fetches=["z"])]

    _same(build)
    _same(lambda m: m.analyze_graph(m.Computation.trace(
        lambda x: {"z": x}, [m.TensorSpec("x", m.dtypes.double,
                                          m.Shape(-1))]), fetches=["q"]))


# ---------------------------------------------------------------------------
# engine: compaction, pipeline, executor
# ---------------------------------------------------------------------------

def _buffer_trace(mod, rng_seed, buffer_size):
    rng = np.random.default_rng(rng_seed)
    calls = []

    def reduce_fn(block):
        calls.append(len(block["x"]))
        return {"x": block["x"].sum(0), "v": block["v"].max(0)}

    buf = mod.CompactionBuffer(["x", "v"], reduce_fn, buffer_size)
    other = mod.CompactionBuffer(["x", "v"], reduce_fn, buffer_size)
    for i in range(7):
        buf.update({"x": rng.standard_normal(), "v": rng.standard_normal(3)})
        other.update_block({"x": rng.standard_normal(i + 1),
                            "v": rng.standard_normal((i + 1, 3))}, i + 1)
    buf.update_block({"x": np.empty(0), "v": np.empty((0, 3))}, 0)
    buf.merge(other)
    out = buf.evaluate()
    return calls, len(buf), out["x"], out["v"]


@pytest.mark.parametrize("buffer_size", [2, 3, 10])
def test_compaction_buffer(buffer_size):
    jcalls, jlen, jx, jv = _buffer_trace(jcompaction, 3, buffer_size)
    tcalls, tlen, tx, tv = _buffer_trace(tcompaction, 3, buffer_size)
    assert (tcalls, tlen) == (jcalls, jlen)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tv, jv)
    assert tcompaction.DEFAULT_BUFFER_SIZE == jcompaction.DEFAULT_BUFFER_SIZE
    for mod in (jcompaction, tcompaction):
        with pytest.raises(ValueError, match="buffer_size"):
            mod.CompactionBuffer(["x"], None, 1)
        with pytest.raises(ValueError, match="empty"):
            mod.CompactionBuffer(["x"], None, 2).evaluate()


@pytest.mark.parametrize("raw", ["", "1", "2", "7", "0", "-3", "junk"])
def test_pipeline_depth_env(monkeypatch, raw):
    monkeypatch.setenv("TFT_PIPELINE_DEPTH", raw)
    assert tpipeline.pipeline_depth() == jpipeline.pipeline_depth()
    assert tpipeline.pipeline_depth(4) == jpipeline.pipeline_depth(4)
    assert tpipeline.DEFAULT_DEPTH == jpipeline.DEFAULT_DEPTH


@pytest.mark.parametrize("depth", [1, 2, 3, 9])
def test_run_pipelined_window_order(depth):
    """Drains are FIFO and the window never holds more than ``depth``
    blocks; depth 1 runs the serial function."""
    events = []

    class Pending:
        def __init__(self, b):
            self.b = b

        def drain(self):
            return self.b

    def submit(b):
        events.append(("submit", b))
        return Pending(b)

    def drain(p, b):
        events.append(("drain", b))
        return p.drain() * 10

    before = ttracing.counters.get("pipeline.submitted")
    out = tpipeline.run_pipelined(range(6), lambda b: b * 10, submit, drain,
                                  depth=depth)
    assert out == [b * 10 for b in range(6)]
    if depth == 1:
        assert events == []
        return
    assert ttracing.counters.get("pipeline.submitted") - before == 6
    in_flight = 0
    for kind, _ in events:
        in_flight += 1 if kind == "submit" else -1
        assert in_flight <= depth
    assert [b for k, b in events if k == "drain"] == list(range(6))


def test_bfloat16_column_computes_in_bf16(rng):
    """A bfloat16 column is f32 on the host and bf16 on the device: the
    same rounding as the JAX package. The JAX package keeps bf16 outputs
    in an ml_dtypes array; the port, which does not use ml_dtypes, in f32
    (its storage dtype), so the values are compared in f32."""
    x = rng.standard_normal(9).astype(np.float32)
    k = np.arange(9) % 2
    frames = {m: m.frame({"x": x, "k": k},
                         schema=m.Schema.of(x="bfloat16", k="long"),
                         num_partitions=2) for m in (jtf, ttf)}
    outs = {m: m.map_blocks(lambda x: {"z": x * 3.0}, frames[m])
            for m in (jtf, ttf)}
    assert schema_tuple(outs[ttf].schema) == schema_tuple(outs[jtf].schema)
    tz = np.concatenate([b.columns["z"] for b in outs[ttf].blocks()])
    jz = np.concatenate([b.columns["z"] for b in outs[jtf].blocks()])
    assert tz.dtype == np.float32
    np.testing.assert_array_equal(tz, jz.astype(np.float32))
    aggs = {m: m.aggregate({"x": "sum"}, frames[m].group_by("k"))
            .blocks()[0].columns["x"] for m in (jtf, ttf)}
    np.testing.assert_allclose(aggs[ttf], aggs[jtf].astype(np.float32),
                               rtol=2e-2)


def test_executor_run_and_submit_agree(rng):
    ex = ttf.BlockExecutor(device="cpu")
    comp = ttf.Computation.trace(
        lambda x, i: {"z": x * 2.0, "j": i + 1},
        [ttf.TensorSpec("x", ttf.dtypes.double, ttf.Shape(-1)),
         ttf.TensorSpec("i", ttf.dtypes.int32, ttf.Shape(-1))])
    arrays = {"x": rng.standard_normal(5), "i": np.arange(5, dtype=np.int32)}
    ran = ex.run(comp, arrays)
    drained = ex.submit(comp, arrays).drain()
    for out in (ran, drained):
        assert out["z"].dtype == np.float64 and out["j"].dtype == np.int32
        np.testing.assert_array_equal(out["z"], arrays["x"] * 2.0)
        np.testing.assert_array_equal(out["j"], np.arange(1, 6))
    bad = ttf.Computation(lambda d: {"z": 3}, comp.inputs,
                          [ttf.TensorSpec("z", ttf.dtypes.double,
                                          ttf.Shape(-1))])
    with pytest.raises(TypeError, match="not a torch.Tensor"):
        ex.run(bad, arrays)


def test_tracing_spans_and_counters():
    ttracing.timings.reset()
    ttracing.enable()
    try:
        with ttracing.span("stage"):
            pass
        with ttracing.span("stage"):
            pass
    finally:
        ttracing.disable()
    with ttracing.span("off"):
        pass
    snap = ttracing.timings.snapshot()
    assert snap["stage"]["count"] == 2 and "off" not in snap
    ttracing.counters.inc("c", 3)
    assert ttracing.counters.get("c") >= 3


def test_api_fluent_forms_match(rng):
    cols = {"x": rng.standard_normal(12), "k": rng.integers(0, 3, 12)}
    j = jtf.frame(cols, num_partitions=3)
    from torch_parity import to_port
    t = to_port(j)
    fn = lambda x: {"z": x + 1.0}  # noqa: E731
    assert_frames_match(j.map_blocks(fn), t.map_blocks(fn))
    assert_frames_match(j.map_rows(fn), t.map_rows(fn))
    np.testing.assert_allclose(
        t.select(["x"]).reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}),
        j.select(["x"]).reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}),
        rtol=1e-12)
    assert_frames_match(jtf.analyze(j), ttf.analyze(t))
    assert ttf.explain(t) == jtf.explain(j)
