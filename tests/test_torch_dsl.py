"""The port's DSL against the JAX package's (``tests/test_dsl.py``).

Construction (naming, scoping, graph isolation, shape and dtype
inference) must agree node for node; programs built in the DSL must give
the same frames through both packages (exactly for elementwise maps,
rtol 1e-12 for reductions), and the port's lowering must equal the same
program written by hand in PyTorch, bit for bit.
"""

import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import dsl as jdsl
from tensorframes_tpu.shape import Shape as JShape
from tensorframes_tpu_torch import dsl
from tensorframes_tpu_torch import dtypes as dt
from tensorframes_tpu_torch.dsl import lower as dsl_lower
from tensorframes_tpu_torch.shape import Shape, Unknown
from torch_parity import assert_frames_match, to_port

RTOL = 1e-12


@pytest.fixture(autouse=True)
def fresh_graphs():
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    with dsl.with_graph(), jdsl.with_graph():
        yield
    ttf.set_default_device(prev)


def _both(build):
    """``build(dsl, Shape)`` in each package; the nodes it returns."""
    return build(jdsl, JShape), build(dsl, Shape)


def _same_nodes(j, t):
    j = j if isinstance(j, (list, tuple)) else [j]
    t = t if isinstance(t, (list, tuple)) else [t]
    assert [(n.name, n.op, n.dtype.name, tuple(n.shape.dims)) for n in t] \
        == [(n.name, n.op, n.dtype.name, tuple(n.shape.dims)) for n in j]


# ---------------------------------------------------------------------------
# construction / naming
# ---------------------------------------------------------------------------

def test_tf_convention_name_dedup():
    def build(d, S):
        x = d.placeholder("double", S(-1), name="x")
        return [x + 1.0, x + 2.0]
    j, t = _both(build)
    _same_nodes(j, t)
    assert [n.name for n in t] == ["Add", "Add_1"]


def test_scope_prefixes():
    def build(d, S):
        x = d.placeholder("double", S(-1), name="x")
        with d.scope("layer"):
            y = x + 1.0
            with d.scope("inner"):
                z = y * 2.0
        return [y, z]
    j, t = _both(build)
    _same_nodes(j, t)
    assert [n.name for n in t] == ["layer/Add", "layer/inner/Mul"]


def test_named_rename():
    j, t = _both(lambda d, S: (d.placeholder("double", S(-1), name="x")
                               + 3.0).named("z"))
    _same_nodes(j, t)
    assert t.name == "z"


def test_with_graph_resets_counters():
    for _ in range(2):
        with dsl.with_graph():
            a = dsl.constant(1.0) + dsl.constant(2.0)
            assert a.name == "Add"


def test_shape_and_dtype_inference():
    def build(d, S):
        x = d.placeholder("double", S(-1, 3), name="x")
        return [x + d.constant(np.ones(3)), d.reduce_sum(x, axis=0),
                d.reduce_min(x), d.reduce_mean(x, axis=-1)]
    j, t = _both(build)
    _same_nodes(j, t)
    assert t[0].shape == Shape(Unknown, 3) and t[0].dtype is dt.double
    assert t[1].shape == Shape(3)
    with pytest.raises(ValueError, match="out of range"):
        dsl.reduce_sum(dsl.placeholder("double", Shape(Unknown, 3)), axis=5)


def test_widening_int_plus_double():
    j, t = _both(lambda d, S: d.placeholder("int", S(-1), name="n") + 1.5)
    _same_nodes(j, t)
    assert t.dtype is dt.double


def test_fill_zeros_ones():
    def build(d, S):
        return [d.fill((2, 2), 3.0), d.zeros((3,)), d.ones((3,), dtype="int")]
    j, t = _both(build)
    _same_nodes(j, t)
    assert t[1].dtype is dt.double and t[2].dtype is dt.int32
    with pytest.raises(ValueError, match="concrete"):
        dsl.fill(Shape(Unknown), 1.0)
    with pytest.raises(ValueError, match="scalar"):
        dsl.fill((2,), np.ones(2))


# ---------------------------------------------------------------------------
# end to end through both engines
# ---------------------------------------------------------------------------

def _frames(cols, parts=2):
    j = jtf.frame(cols, num_partitions=parts)
    return j, to_port(j)


def test_dsl_map_blocks_readme_x_plus_3():
    # the reference README's flagship, x + 3 through the DSL
    j, t = _frames({"x": np.arange(10.0)})
    jz = (jtf.block(j, "x") + 3.0).named("z")
    z = (ttf.block(t, "x") + 3.0).named("z")
    out = t.map_blocks(z)
    assert [r["z"] for r in out.collect()] == [i + 3.0 for i in range(10)]
    assert_frames_match(j.map_blocks(jz), out)


def test_dsl_map_blocks_trim():
    j, t = _frames({"x": np.arange(4.0)}, parts=1)
    out = t.map_blocks(dsl.identity(ttf.block(t, "x")).named("z"),
                       trim=True)
    assert out.columns == ["z"] and out.count() == 4
    assert_frames_match(
        j.map_blocks(jdsl.identity(jtf.block(j, "x")).named("z"),
                     trim=True), out)


def test_dsl_map_rows():
    j, t = _frames({"x": np.arange(5.0)}, parts=1)
    x, jx = ttf.row(t, "x"), jtf.row(j, "x")
    out = t.map_rows((x * x).named("z"))
    assert [r["z"] for r in out.collect()] == [i * i for i in range(5)]
    assert_frames_match(j.map_rows((jx * jx).named("z")), out)


def test_dsl_reduce_blocks_sum():
    j, t = _frames({"x": np.arange(10.0)}, parts=3)
    x = dsl.reduce_sum(dsl.placeholder("double", Shape(Unknown),
                                       name="x_input"), axis=0).named("x")
    jx = jdsl.reduce_sum(jdsl.placeholder("double", JShape(-1),
                                          name="x_input"), axis=0).named("x")
    assert ttf.reduce_blocks(x, t) == jtf.reduce_blocks(jx, j) == 45.0


def test_dsl_reduce_rows_pairwise():
    j, t = _frames({"x": np.arange(6.0)})

    def build(d, S):
        x1 = d.placeholder("double", S.empty, name="x_1")
        x2 = d.placeholder("double", S.empty, name="x_2")
        return (x1 + x2).named("x")
    jx, x = _both(build)
    assert ttf.reduce_rows(x, t) == jtf.reduce_rows(jx, j) == 15.0


def test_dsl_aggregate():
    cols = {"key": np.array([0, 0, 1], np.int64),
            "x": np.array([1.0, 2.0, 10.0])}
    j, t = _frames(cols, parts=1)

    def build(d, S):
        return d.reduce_sum(d.placeholder("double", S(-1), name="x_input"),
                            axis=0).named("x")
    jx, x = _both(build)
    got = ttf.aggregate(x, t.group_by("key"))
    assert [(r["key"], r["x"]) for r in got.collect()] == \
        [(0, 3.0), (1, 10.0)]
    assert_frames_match(jtf.aggregate(jx, j.group_by("key")), got)


def test_dsl_duplicate_explicit_names_deduped():
    j, t = _frames({"x": np.arange(3.0)}, parts=1)
    x, jx = ttf.block(t, "x"), jtf.block(j, "x")
    a = (x + 1.0).named("z")
    b = (x + 2.0).named("z")
    assert (a.name, b.name) == ("z", "z_1")
    out = t.map_blocks([a, b])
    assert out.columns == ["x", "z", "z_1"]
    ja = (jx + 1.0).named("z")
    jb = (jx + 2.0).named("z")
    assert_frames_match(j.map_blocks([ja, jb]), out)


def test_block_placeholder_lead_is_unknown():
    t = ttf.frame({"v": np.ones((4, 3))})
    assert ttf.block(t, "v").shape == Shape(Unknown, 3)
    assert ttf.row(t, "v").shape == Shape(3)
    with pytest.raises(ValueError, match="Could not find column"):
        ttf.block(t, "nope")
    with pytest.raises(ValueError, match="Could not find column"):
        ttf.row(t, "nope")


@pytest.mark.parametrize("col,const", [("float", 1.5), ("int", 2),
                                       ("long", 1.5), ("double", 3)])
def test_mixed_dtype_arithmetic_matches_jax(col, const):
    # the node's widened dtype is what both packages compute in
    np_dt = {"float": np.float32, "int": np.int32, "long": np.int64,
             "double": np.float64}[col]
    j, t = _frames({"x": (np.arange(8) - 3).astype(np_dt)})
    jz = (jtf.block(j, "x") * const + 1).named("z")
    z = (ttf.block(t, "x") * const + 1).named("z")
    assert z.dtype.name == jz.dtype.name
    assert_frames_match(j.map_blocks(jz), t.map_blocks(z))


@pytest.mark.parametrize("op", ["sum", "min", "max", "mean"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_reductions_match_jax(op, axis):
    rng = np.random.default_rng(3)
    j, t = _frames({"v": rng.standard_normal((12, 3))}, parts=1)
    jz = getattr(jdsl, f"reduce_{op}")(jtf.block(j, "v"), axis=axis)
    z = getattr(dsl, f"reduce_{op}")(ttf.block(t, "v"), axis=axis)
    _same_nodes(jz, z)
    _, fn = dsl_lower.lower_nodes([z])
    _, jfn = __import__("tensorframes_tpu.dsl.lower",
                        fromlist=["lower_nodes"]).lower_nodes([jz])
    v = j.blocks()[0].columns["v"]
    np.testing.assert_allclose(fn({"v": torch.from_numpy(v)})[z.name],
                               np.asarray(jfn({"v": v})[jz.name]), rtol=RTOL)


def test_fill_lowers_on_the_inputs_device():
    x = dsl.placeholder("double", Shape(2), name="x")
    z = (x + dsl.ones((2,))).named("z")
    _, fn = dsl_lower.lower_nodes([z])
    out = fn({"x": torch.zeros(2, dtype=torch.float64)})["z"]
    assert out.dtype == torch.float64 and out.tolist() == [1.0, 1.0]


# ---------------------------------------------------------------------------
# lowering against the same program written in PyTorch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build_dsl,ref_fn", [
    (lambda x: x + 3.0, lambda x: x + 3.0),
    (lambda x: (x * 2.0) / (x + 1.0), lambda x: (x * 2.0) / (x + 1.0)),
    (lambda x: dsl.reduce_sum(x, axis=0), lambda x: torch.sum(x, dim=0)),
    (lambda x: dsl.reduce_min(x, axis=0), lambda x: torch.amin(x, dim=0)),
    (lambda x: ((x * 2.0 + 1.0) / 3.0), lambda x: (x * 2.0 + 1.0) / 3.0),
])
def test_dsl_lowering_equals_handwritten_torch(build_dsl, ref_fn):
    x = dsl.placeholder("double", Shape(4), name="x")
    fetch = build_dsl(x).named("z")
    _, fn = dsl_lower.lower_nodes([fetch])
    a = torch.from_numpy(np.linspace(-1.0, 2.0, 4))
    got, want = fn({"x": a})["z"], ref_fn(a)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


def test_dsl_and_torch_and_jax_numerical_agreement():
    j, t = _frames({"x": np.linspace(0.0, 1.0, 16)})
    z = ((ttf.block(t, "x") * 2.0 + 1.0) / 3.0).named("z")
    dsl_out = t.map_blocks(z)
    torch_out = t.map_blocks(lambda x: {"z": (x * 2.0 + 1.0) / 3.0})
    assert_frames_match(torch_out, dsl_out)
    # XLA on the CPU divides by a constant through its reciprocal, one
    # rounding more than torch's (and numpy's) division
    jz = ((jtf.block(j, "x") * 2.0 + 1.0) / 3.0).named("z")
    assert_frames_match(j.map_blocks(jz), dsl_out, rtol=RTOL)


def test_dsl_chain_fuses_like_a_torch_chain(monkeypatch):
    monkeypatch.delenv("TFT_FUSE", raising=False)
    _, t = _frames({"x": np.arange(8.0), "y": np.ones(8)})
    z = (ttf.block(t, "x") + ttf.block(t, "y")).named("z")
    chain = t.map_blocks(z).map_blocks(lambda z: {"w": z * 2.0})
    chain.blocks()
    assert chain._plan_info
    monkeypatch.setenv("TFT_FUSE", "0")
    assert_frames_match(t.map_blocks(z).map_blocks(lambda z: {"w": z * 2.0}),
                        chain)
