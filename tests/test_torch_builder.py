"""The port's shipped computations against the JAX package's: the wire
format (``Computation.serialize``/``deserialize``, ``TensorSpec`` JSON),
the op builder (``builder.py``) and the engine's ops over deserialized
programs.

The same seeded numpy inputs go through the JAX package's serialize ->
deserialize -> op and the port's. Values, dtypes, specs, row order and
error types and messages must agree: exactly for elementwise f64 maps,
rtol 1e-12 for f64 reductions, rtol 1e-5 for the f32 projection that
closes over a tensor. Mirrored cases of the JAX package are named in each
docstring (``tests/test_computation.py``, ``tests/test_builder_checkpoint
.py``).

Known difference: the JAX package's deserialized program raises
``ValueError`` when called directly at 0 rows (its symbolic row dim is
``>= 1``); the port's runs there. The engine never calls a program on an
empty block, so the engine path agrees (``ROADMAP.md`` §C).
"""

import io
import json
import struct

import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import dsl as jdsl
from tensorframes_tpu import dtypes as jdt
from tensorframes_tpu.builder import (
    aggregate_builder as j_aggregate_builder,
    map_blocks_builder as j_map_blocks_builder,
    reduce_blocks_builder as j_reduce_blocks_builder)
from tensorframes_tpu.computation import Computation as JComputation
from tensorframes_tpu.computation import TensorSpec as JSpec
from tensorframes_tpu.computation import analyze_graph as j_analyze_graph
from tensorframes_tpu.shape import Shape as JShape
from tensorframes_tpu_torch import builder, dsl
from tensorframes_tpu_torch import dtypes as dt
from tensorframes_tpu_torch.builder import (
    aggregate_builder, load_computation, map_blocks_builder,
    map_rows_builder, reduce_blocks_builder, reduce_rows_builder,
    save_computation)
from tensorframes_tpu_torch.computation import (Computation, TensorSpec,
                                                analyze_graph)
from tensorframes_tpu_torch.engine import ops as tops
from tensorframes_tpu_torch.shape import Shape, Unknown
from torch_parity import assert_frames_match

RTOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("TFT_ADAPTIVE", "0")
    monkeypatch.setenv("TFT_RESULT_CACHE", "0")
    monkeypatch.delenv("TFT_FUSE", raising=False)
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    with dsl.with_graph(), jdsl.with_graph():
        yield
    ttf.set_default_device(prev)


def _specs(**kw):
    """``name=(dtype name, dims)`` -> (JAX specs, port specs)."""
    j = [JSpec(n, jdt.by_name(d), JShape(*dims)) for n, (d, dims) in kw.items()]
    t = [TensorSpec(n, dt.by_name(d), Shape(*dims))
         for n, (d, dims) in kw.items()]
    return j, t


def _pair(jfn, tfn, **kw):
    """The same program traced in each package, serialized and
    deserialized there: (JAX computation, port computation)."""
    js, ts = _specs(**kw)
    jc = JComputation.deserialize(JComputation.trace(jfn, js).serialize())
    tc = Computation.deserialize(Computation.trace(tfn, ts).serialize())
    return jc, tc


def _spec_tuples(specs):
    return [(s.name, s.dtype.name, tuple(s.shape.dims)) for s in specs]


def _header(blob, magic_len):
    (hlen,) = struct.unpack_from("<I", blob, magic_len)
    return json.loads(blob[magic_len + 4:magic_len + 4 + hlen])


def _map_pair():
    return _pair(lambda x: {"z": x + 3.0, "w": x * 2.0},
                 lambda x: {"z": x + 3.0, "w": x * 2.0},
                 x=("double", (Unknown,)))


# -- wire format -------------------------------------------------------------

@pytest.mark.parametrize("name,dtype,dims", [
    ("x", "double", (Unknown,)), ("v", "float", (Unknown, 3)),
    ("k", "long", ()), ("m", "int", (2, Unknown, 4)),
    ("b", "bfloat16", (Unknown, 8))])
def test_tensor_spec_json_matches(name, dtype, dims):
    j = JSpec(name, jdt.by_name(dtype), JShape(*dims)).to_json()
    t = TensorSpec(name, dt.by_name(dtype), Shape(*dims))
    assert t.to_json() == j
    assert TensorSpec.from_json(j) == t


def test_serialize_roundtrip(rng):
    """Mirrors ``test_computation.py::test_serialize_roundtrip``."""
    jc, tc = _pair(lambda x: {"z": x * 2 + 1, "m": x.min(axis=0)},
                   lambda x: {"z": x * 2 + 1, "m": torch.amin(x, 0)},
                   x=("double", (Unknown, 2)))
    assert tc.input_names == jc.input_names == ["x"]
    assert tc.output_names == jc.output_names == ["m", "z"]
    assert _spec_tuples(tc.outputs) == _spec_tuples(jc.outputs)
    assert tc.output("z").shape == Shape(Unknown, 2)
    x = rng.standard_normal((5, 2))
    jout = jc({"x": x})
    tout = tc({"x": torch.from_numpy(x)})
    for n in ("m", "z"):
        assert tout[n].dtype == torch.float64
        np.testing.assert_array_equal(tout[n].numpy(), np.asarray(jout[n]))


def test_header_reads_as_the_jax_packages():
    js, ts = _specs(x=("double", (Unknown,)), y=("float", (Unknown, 3)))
    jblob = JComputation.trace(lambda x, y: {"z": x * 2.0, "s": y.sum(1)},
                               js).serialize()
    tblob = Computation.trace(lambda x, y: {"z": x * 2.0, "s": y.sum(1)},
                              ts).serialize()
    assert not tblob.startswith(b"TFTPU1")
    assert tblob.startswith(b"TFTORCH1\x00")
    jh, th = _header(jblob, 7), _header(tblob, 9)
    assert th["inputs"] == jh["inputs"]
    assert th["outputs"] == jh["outputs"]
    assert th["torch"]["version"] == torch.__version__
    assert th["torch"]["arg_dtypes"] == jh["native"]["arg_dtypes"] == \
        ["float64", "float32"]
    assert th["torch"]["rows"] == [0, None]
    assert tblob[-th["torch"]["archive_len"]:].startswith(b"PK\x03\x04")


def test_deserialize_rejects_garbage():
    """Mirrors ``test_computation.py::test_deserialize_rejects_garbage``:
    the same type and message."""
    with pytest.raises(ValueError) as je:
        JComputation.deserialize(b"not-a-computation")
    with pytest.raises(ValueError) as te:
        Computation.deserialize(b"not-a-computation")
    assert str(te.value) == str(je.value) == \
        "Not a serialized tensorframes-tpu computation"


def test_jax_blob_refused_by_the_port():
    js, _ = _specs(x=("double", (Unknown,)))
    jblob = JComputation.trace(lambda x: {"z": x + 1.0}, js).serialize()
    with pytest.raises(ValueError, match="StableHLO"):
        Computation.deserialize(jblob)
    with pytest.raises(ValueError, match="StableHLO"):
        map_blocks_builder(ttf.frame({"x": np.arange(3.0)})).graph(jblob)


def test_port_blob_refused_by_the_jax_package():
    _, ts = _specs(x=("double", (Unknown,)))
    tblob = Computation.trace(lambda x: {"z": x + 1.0}, ts).serialize()
    with pytest.raises(ValueError,
                       match="^Not a serialized tensorframes-tpu computation$"):
        JComputation.deserialize(tblob)


def test_from_stablehlo_names_from_exported():
    _, ts = _specs(x=("double", (3,)))
    with pytest.raises(NotImplementedError, match="from_exported"):
        Computation.from_stablehlo("module {}", ts)


def test_zero_and_one_row_direct_calls():
    """At 1 row both run; at 0 rows the JAX package's program raises and
    the port's returns an empty result (the recorded difference)."""
    jc, tc = _map_pair()
    one = np.array([2.5])
    jout, tout = jc({"x": one}), tc({"x": torch.from_numpy(one)})
    for n in ("w", "z"):
        np.testing.assert_array_equal(tout[n].numpy(), np.asarray(jout[n]))
    with pytest.raises(ValueError, match="dimension variable '_n'"):
        jc({"x": np.zeros(0)})
    tout = tc({"x": torch.zeros(0, dtype=torch.float64)})
    assert {n: tuple(v.shape) for n, v in tout.items()} == \
        {"w": (0,), "z": (0,)}


@pytest.mark.parametrize("x", [
    np.arange(3), np.arange(3.0, dtype=np.float32), np.ones((3, 2))],
    ids=["int64", "float32", "rank2"])
def test_direct_call_checks_inputs_against_the_signature(x):
    """A program declared ``double[?] -> double[?]`` called with int64,
    float32 or a (3, 2) ``x``: both packages raise the same ``ValueError``
    (the port used to answer in f32, compute in f32, or return (3, 2))."""
    jc, tc = _pair(lambda x: {"z": x + 1.0}, lambda x: {"z": x + 1.0},
                   x=("double", (Unknown,)))
    with pytest.raises(ValueError) as je:
        jc({"x": x})
    with pytest.raises(ValueError) as te:
        tc({"x": torch.from_numpy(x)})
    assert str(te.value) == str(je.value)
    assert str(te.value).startswith(
        "Rank mismatch for args[0]: expected (_n,) and called with (3, 2)"
        if x.ndim == 2 else
        f"Dtype mismatch for args[0]: expected float64 and called with "
        f"{x.dtype}")


def test_direct_call_checks_fixed_dims_of_a_later_argument():
    jc, tc = _pair(lambda x, y: {"z": x + y.sum(1)},
                   lambda x, y: {"z": x + y.sum(1)},
                   x=("double", (Unknown,)), y=("double", (Unknown, 3)))
    x, y = np.ones(3), np.ones((3, 2))
    with pytest.raises(ValueError) as je:
        jc({"x": x, "y": y})
    with pytest.raises(ValueError) as te:
        tc({"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    assert str(te.value) == str(je.value) == (
        "Shape mismatch for args[1].shape[1] (expected same constant): "
        "expected (_n, 3) and called with (3, 2)")


def test_deserialize_rejects_a_corrupt_archive():
    """A blob with the port's magic and a valid header followed by
    garbage raises ``ValueError`` in ``deserialize``, as the JAX package's
    does, not at the first call."""
    _, ts = _specs(x=("double", (Unknown,)))
    blob = Computation.trace(lambda x: {"z": x + 1.0}, ts).serialize()
    (hlen,) = struct.unpack_from("<I", blob, 9)
    head = blob[:9 + 4 + hlen]
    garbage = np.random.default_rng(0).integers(
        0, 256, len(blob) - len(head), dtype=np.uint8).tobytes()
    with pytest.raises(ValueError, match="Corrupt serialized computation"):
        Computation.deserialize(head + garbage)
    with pytest.raises(ValueError, match="Corrupt serialized computation"):
        Computation.deserialize(head + b"PK\x03\x04" + garbage[4:])


# -- analysis of deserialized programs ----------------------------------------

def _summaries(s):
    return [(x.name, x.is_input, x.is_output, x.dtype.name,
             tuple(x.shape.dims)) for x in s]


def test_analyze_graph_summaries():
    """Mirrors ``test_computation.py::test_analyze_graph_summaries`` on
    deserialized programs."""
    jc, tc = _pair(lambda x: {"z": x + 1.0}, lambda x: {"z": x + 1.0},
                   x=("double", (Unknown,)))
    assert _summaries(analyze_graph(tc)) == _summaries(j_analyze_graph(jc))
    assert [s.name for s in analyze_graph(tc)] == ["x", "z"]


def test_analyze_graph_hint_refines():
    """Mirrors ``test_computation.py::test_analyze_graph_hint_refines``."""
    jc, tc = _pair(lambda x: {"z": x}, lambda x: {"z": x * 1.0},
                   x=("double", (Unknown,)))
    t = analyze_graph(tc, shape_hints={"x": Shape(10)})
    j = j_analyze_graph(jc, shape_hints={"x": JShape(10)})
    assert _summaries(t) == _summaries(j)
    assert t[0].shape == Shape(10)


def test_analyze_graph_bad_hint_and_fetch():
    """Mirrors ``test_computation.py::test_analyze_graph_bad_hint_and_fetch``:
    the same errors and messages."""
    jc, tc = _pair(lambda x: {"z": x * 1.0}, lambda x: {"z": x * 1.0},
                   x=("double", (Unknown, 3)))
    for kw, jkw in (({"shape_hints": {"x": Shape(Unknown)}},
                     {"shape_hints": {"x": JShape(Unknown)}}),
                    ({"fetches": ["nope"]}, {"fetches": ["nope"]})):
        with pytest.raises(ValueError) as je:
            j_analyze_graph(jc, **jkw)
        with pytest.raises(ValueError) as te:
            analyze_graph(tc, **kw)
        assert str(te.value) == str(je.value)


# -- the builder ---------------------------------------------------------------

@pytest.mark.parametrize("parts", [1, 2, 3])
def test_builder_roundtrips_serialized_map(parts):
    """Mirrors ``test_builder_checkpoint.py::
    test_builder_roundtrips_serialized_map``."""
    x = np.arange(6.0)
    jdf = jtf.frame({"x": x}, num_partitions=parts)
    tdf = ttf.frame({"x": x}, num_partitions=parts)
    jb = JComputation.trace(lambda x: {"z": x + 3.0, "w": x * 2.0},
                            _specs(x=("double", (Unknown,)))[0]).serialize()
    tb = Computation.trace(lambda x: {"z": x + 3.0, "w": x * 2.0},
                           _specs(x=("double", (Unknown,)))[1]).serialize()
    jout = j_map_blocks_builder(jdf).graph(jb).build()
    tout = map_blocks_builder(tdf).graph(tb).build()
    assert_frames_match(jout, tout)
    assert [r["z"] for r in tout.collect()] == [i + 3.0 for i in range(6)]


def test_builder_fetches_subset():
    """Mirrors ``test_builder_checkpoint.py::test_builder_fetches_subset``."""
    x = np.arange(4.0)
    jdf, tdf = jtf.frame({"x": x}), ttf.frame({"x": x})
    js, ts = _specs(x=("double", (Unknown,)))
    jb = JComputation.trace(lambda x: {"z": x + 3.0, "w": x * 2.0},
                            js).serialize()
    tb = Computation.trace(lambda x: {"z": x + 3.0, "w": x * 2.0},
                           ts).serialize()
    jout = j_map_blocks_builder(jdf).graph(jb).fetches(["z"]).build()
    tout = map_blocks_builder(tdf).graph(tb).fetches(["z"]).build()
    assert tout.schema.names == ["x", "z"]
    assert_frames_match(jout, tout)
    with pytest.raises(ValueError) as je:
        j_map_blocks_builder(jdf).graph(jb).fetches(["nope"]).build()
    with pytest.raises(ValueError) as te:
        map_blocks_builder(tdf).graph(tb).fetches(["nope"]).build()
    assert str(te.value) == str(je.value)
    assert "not among computation outputs" in str(te.value)


def test_builder_reduce_and_aggregate():
    """Mirrors ``test_builder_checkpoint.py::test_builder_reduce_and_aggregate``."""
    x = np.arange(6.0)
    js, ts = _specs(x_input=("double", (Unknown,)))
    jb = JComputation.trace(lambda x_input: {"x": x_input.sum(0)},
                            js).serialize()
    tb = Computation.trace(lambda x_input: {"x": x_input.sum(0)},
                           ts).serialize()
    jr = j_reduce_blocks_builder(jtf.frame({"x": x}, num_partitions=2)) \
        .graph(jb).build()
    tr = reduce_blocks_builder(ttf.frame({"x": x}, num_partitions=2)) \
        .graph(tb).build()
    assert float(tr["x"]) == float(jr["x"]) == 15.0

    cols = {"key": np.array(["a", "b", "a", "b"]), "x": np.arange(4.0)}
    jagg = j_aggregate_builder(jtf.frame(cols).group_by("key")) \
        .graph(jb).build()
    tagg = aggregate_builder(ttf.frame(cols).group_by("key")) \
        .graph(tb).build()
    assert {r["key"]: r["x"] for r in tagg.collect()} == {"a": 2.0, "b": 4.0}
    assert_frames_match(jagg, tagg)


def test_builder_requires_graph():
    """Mirrors ``test_builder_checkpoint.py::test_builder_requires_graph``."""
    with pytest.raises(ValueError) as je:
        j_map_blocks_builder(jtf.frame({"x": np.arange(3.0)})).build()
    with pytest.raises(ValueError) as te:
        map_blocks_builder(ttf.frame({"x": np.arange(3.0)})).build()
    assert str(te.value) == str(je.value)
    assert "No computation attached" in str(te.value)


def test_builder_routes_garbage_to_deserialize():
    with pytest.raises(ValueError,
                       match="^Not a serialized tensorframes-tpu computation$"):
        map_blocks_builder(ttf.frame({"x": np.arange(3.0)})).graph(b"junk")


def test_save_load_computation_file(tmp_path):
    """Mirrors ``test_builder_checkpoint.py::test_save_load_computation_file``."""
    js, ts = _specs(x=("double", (Unknown,)))
    jp, tp = str(tmp_path / "j.tftc"), str(tmp_path / "t.tftc")
    from tensorframes_tpu.builder import (load_computation as j_load,
                                          save_computation as j_save)
    j_save(JComputation.trace(lambda x: {"z": x + 3.0, "w": x * 2.0}, js),
           jp)
    save_computation(Computation.trace(
        lambda x: {"z": x + 3.0, "w": x * 2.0}, ts), tp)
    x = np.arange(3.0)
    jout = jtf.map_blocks(j_load(jp), jtf.frame({"x": x}))
    tout = ttf.map_blocks(load_computation(tp), ttf.frame({"x": x}))
    assert [r["z"] for r in tout.collect()] == [3.0, 4.0, 5.0]
    assert_frames_match(jout, tout)


def test_builder_shape_override():
    _, ts = _specs(x=("double", (Unknown, 2)))
    tb = Computation.trace(lambda x: {"z": x * 2.0}, ts).serialize()
    df = ttf.frame({"x": np.arange(8.0).reshape(4, 2)})
    out = map_blocks_builder(df).graph(tb).shape({"z": (Unknown, 2)}) \
        .build()
    np.testing.assert_array_equal(out.blocks()[0].columns["z"],
                                  np.arange(8.0).reshape(4, 2) * 2.0)


# -- the engine over deserialized programs -------------------------------------

@pytest.mark.parametrize("n,parts", [(0, 1), (1, 1), (2, 4), (5, 3)])
def test_map_blocks_zero_and_one_row_blocks(rng, n, parts):
    """Empty frames, 1-row blocks and empty partitions through
    ``map_blocks`` of a deserialized program agree with the JAX package."""
    jc, tc = _map_pair()
    x = rng.standard_normal(n)
    jout = jtf.map_blocks(jc, jtf.frame({"x": x}, num_partitions=parts))
    tout = ttf.map_blocks(tc, ttf.frame({"x": x}, num_partitions=parts))
    assert_frames_match(jout, tout)


def test_map_rows_closure_over_a_tensor(rng):
    """The JL projection ``((x @ P) ** 2).sum(-1)`` closing over a
    [64, 16] f32 table, shipped and run row by row (``torch.func.vmap``
    over the placed program): rtol 1e-5 against the JAX package's live
    program. The JAX package cannot ``map_rows`` its deserialized program
    (``call_exported`` has no batching rule); the port can (``ROADMAP.md``
    §C)."""
    P = (rng.standard_normal((64, 16)) / 4.0).astype(np.float32)
    tP = torch.from_numpy(P)
    js, ts = _specs(x=("float", (64,)))
    jlive = JComputation.trace(lambda x: {"z": ((x @ P) ** 2).sum(-1)}, js)
    tc = Computation.deserialize(Computation.trace(
        lambda x: {"z": ((x @ tP) ** 2).sum(-1)}, ts).serialize())
    assert _spec_tuples(tc.outputs) == _spec_tuples(jlive.outputs)
    assert tc.fn.exported.constants, "the table was not lifted"
    x = rng.standard_normal((37, 64)).astype(np.float32)
    key = rng.integers(0, 5, 37)
    jout = jtf.map_rows(jlive, jtf.frame({"key": key, "x": x},
                                         num_partitions=3))
    tout = map_rows_builder(ttf.frame({"key": key, "x": x},
                                      num_partitions=3)) \
        .graph(tc.serialize()).build()
    assert_frames_match(jout, tout, rtol=1e-5)
    want = ((x.astype(np.float64) @ P) ** 2).sum(-1)
    np.testing.assert_allclose(
        np.concatenate([b.columns["z"] for b in tout.blocks()]), want,
        rtol=1e-5)


def test_dsl_program_shipped(rng):
    """A DSL program (``block(x) + block(y)``) serialized and run through
    ``map_blocks`` in both packages: exact."""
    cols = {"x": rng.standard_normal(9), "y": rng.standard_normal(9)}
    jdf = jtf.frame(cols, num_partitions=2)
    tdf = ttf.frame(cols, num_partitions=2)
    jz = (jtf.block(jdf, "x") + jtf.block(jdf, "y")).named("z")
    tz = (ttf.block(tdf, "x") + ttf.block(tdf, "y")).named("z")
    from tensorframes_tpu.engine import ops as jops
    jc = JComputation.deserialize(
        jops._map_computation(jz, jdf.schema, True).serialize())
    tc = Computation.deserialize(
        tops._map_computation(tz, tdf.schema, True).serialize())
    assert _spec_tuples(tc.inputs) == _spec_tuples(jc.inputs)
    assert_frames_match(jtf.map_blocks(jc, jdf), ttf.map_blocks(tc, tdf))


def test_filter_rows_deserialized(rng):
    x = rng.standard_normal(20)
    jc, tc = _pair(lambda x: {"keep": x > 0.0}, lambda x: {"keep": x > 0.0},
                   x=("double", (Unknown,)))
    jout = jtf.filter_rows(jc, jtf.frame({"x": x}, num_partitions=3))
    tout = ttf.filter_rows(tc, ttf.frame({"x": x}, num_partitions=3))
    assert_frames_match(jout, tout)


def test_reduce_rows_deserialized(rng):
    x = rng.standard_normal(11)
    js, ts = _specs(x_1=("double", ()), x_2=("double", ()))
    jc = JComputation.deserialize(JComputation.trace(
        lambda x_1, x_2: {"x": x_1 + x_2}, js).serialize())
    tc = Computation.deserialize(Computation.trace(
        lambda x_1, x_2: {"x": x_1 + x_2}, ts).serialize())
    jr = jtf.reduce_rows(jc, jtf.frame({"x": x}, num_partitions=3))
    tr = reduce_rows_builder(ttf.frame({"x": x}, num_partitions=3)) \
        .computation(tc).build()
    # the API unpacks a one-fetch result; the builder returns the dict
    np.testing.assert_allclose(float(tr["x"]), float(jr), rtol=RTOL)
    np.testing.assert_allclose(float(tr["x"]), x.sum(), rtol=RTOL)
    assert float(ttf.reduce_rows(tc, ttf.frame({"x": x}))) == \
        pytest.approx(x.sum(), rel=RTOL)


def test_aggregate_computation_form_deserialized(rng):
    """The computation form of ``aggregate`` over a deserialized program
    (the ``CompactionBuffer`` path in both packages): rtol 1e-12."""
    key = rng.integers(0, 7, 200)
    x = rng.standard_normal(200)
    js, ts = _specs(x_input=("double", (Unknown,)))
    jc = JComputation.deserialize(JComputation.trace(
        lambda x_input: {"x": x_input.sum(0)}, js).serialize())
    tc = Computation.deserialize(Computation.trace(
        lambda x_input: {"x": x_input.sum(0)}, ts).serialize())
    jagg = jtf.aggregate(jc, jtf.frame({"key": key, "x": x},
                                       num_partitions=3).group_by("key"))
    tagg = ttf.aggregate(tc, ttf.frame({"key": key, "x": x},
                                       num_partitions=3).group_by("key"))
    assert_frames_match(jagg, tagg, rtol=RTOL)


def test_deserialized_stage_fuses(monkeypatch, rng):
    """A deserialized ``map_blocks`` stage fuses with the chain after it
    as a live program does; the fused run equals ``TFT_FUSE=0`` and the
    JAX package's chain."""
    jc, tc = _map_pair()
    x = rng.standard_normal(12)

    def chain(m, c):
        return (m.frame({"x": x}, num_partitions=3).map_blocks(c)
                .map_rows(lambda z: {"v": z * 2.0}).select(["v", "w"]))

    fused = chain(ttf, tc)
    fused.blocks()
    assert fused._plan_info, "the deserialized stage did not fuse"
    monkeypatch.setenv("TFT_FUSE", "0")
    unfused = chain(ttf, tc)
    assert_frames_match(unfused, fused)
    assert_frames_match(chain(jtf, jc), fused)


# -- programs exported by other means -------------------------------------------

class _TwoOut(torch.nn.Module):
    def forward(self, x, y):
        return x * y, (x + y).sum(1)


def test_from_exported_reads_output_specs(rng):
    """A program exported by ``torch.export`` outside this package, run
    without output specs: its results are ``out_0``, ``out_1`` with the
    graph's shapes, as the JAX package names a bare StableHLO module's."""
    import jax

    _, ts = _specs(x=("double", (4, 3)), y=("double", (4, 3)))
    ep = torch.export.export(_TwoOut(), (torch.zeros(4, 3, dtype=torch.float64),
                                         torch.zeros(4, 3, dtype=torch.float64)))
    tc = Computation.from_exported(ep, ts)
    js, _ = _specs(x=("double", (4, 3)), y=("double", (4, 3)))
    text = jax.jit(lambda x, y: (x * y, (x + y).sum(1))).lower(
        np.zeros((4, 3)), np.zeros((4, 3))).as_text()
    jc = JComputation.from_stablehlo(text, js)
    assert _spec_tuples(tc.outputs) == _spec_tuples(jc.outputs) == \
        [("out_0", "double", (4, 3)), ("out_1", "double", (4,))]
    x, y = rng.standard_normal((4, 3)), rng.standard_normal((4, 3))
    tout = tc({"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    jout = jc({"x": x, "y": y})
    for n in ("out_0", "out_1"):
        np.testing.assert_array_equal(tout[n].numpy(), np.asarray(jout[n]))


def test_builder_bare_archive_needs_a_signature(rng):
    """A bare ``torch.export`` archive waits for ``.signature(...)``; a
    dict result names the outputs, read from the graph."""

    class Dyn(torch.nn.Module):
        def forward(self, x):
            return {"z": x * 3.0}

    ep = torch.export.export(
        Dyn(), (torch.zeros(8, dtype=torch.float64),),
        dynamic_shapes=({0: torch.export.Dim("rows")},))
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    archive = buf.getvalue()
    x = rng.standard_normal(10)
    df = ttf.frame({"x": x}, num_partitions=2)
    with pytest.raises(ValueError,
                       match="bare torch.export archive carries no signature"):
        map_blocks_builder(df).graph(archive).build()
    _, ts = _specs(x=("double", (Unknown,)))
    out = map_blocks_builder(df).graph(archive).signature(ts).build()
    assert out.schema["z"].block_shape == Shape(Unknown)
    np.testing.assert_array_equal(
        np.concatenate([b.columns["z"] for b in out.blocks()]), x * 3.0)


def test_package_exports_builder():
    assert ttf.builder is builder
    assert hasattr(jtf, "builder")
    assert set(builder.__all__) == set(jtf.builder.__all__)
