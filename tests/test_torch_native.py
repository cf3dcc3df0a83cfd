"""The port's host runtime (``tensorframes_tpu_torch/native.py`` over
``csrc/host_runtime.cpp``) against the JAX package's ``native`` module and
numpy on the same arrays, bit for bit: the ten cases of
``tests/test_native.py``, the numpy fallbacks under
``TFT_DISABLE_NATIVE=1``, the engine's use of it, and two processes
building the library at once.

The port builds its own library with ``g++`` at first use into
``build/kernels/``; the JAX package's is compiled from
``native/tfruntime.cpp`` into a temporary directory of this module's own.
"""

import gc
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import tensorframes_tpu.native as jnative
import tensorframes_tpu_torch as ttf
import tensorframes_tpu_torch.native as native
from tensorframes_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]


def _reload(module, monkeypatch=None, **env):
    """Forget ``module``'s loaded library so the next call loads again
    (under ``env`` when given)."""
    if monkeypatch is not None:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    module._load_attempted = False
    module._lib = None


@pytest.fixture(scope="module", autouse=True)
def built_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain; native fallback paths only")
    _reload(native)
    assert native.available(), "host_runtime failed to build or load"
    # the JAX package's library for the cross-package cases, compiled into
    # a directory of this module's own and loaded through TFT_NATIVE_LIB:
    # ``make -C native`` would write native/libtfruntime.so in place while
    # tests/test_native.py, in another worker, may be loading it
    jlib = tmp_path_factory.mktemp("jax_native") / "libtfruntime.so"
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-pthread",
                    str(ROOT / "native" / "tfruntime.cpp"), "-shared",
                    "-pthread", "-o", str(jlib)],
                   check=True, capture_output=True)
    prev = os.environ.get("TFT_NATIVE_LIB")
    os.environ["TFT_NATIVE_LIB"] = str(jlib)
    try:
        _reload(jnative)
        assert jnative.available(), "the JAX package's library did not load"
    finally:
        if prev is None:
            del os.environ["TFT_NATIVE_LIB"]
        else:
            os.environ["TFT_NATIVE_LIB"] = prev
    yield
    _reload(native)
    _reload(jnative)


@pytest.fixture
def fallback(monkeypatch):
    """The port with its numpy fallbacks only."""
    _reload(native, monkeypatch, TFT_DISABLE_NATIVE="1")
    assert not native.available()
    yield
    monkeypatch.delenv("TFT_DISABLE_NATIVE")
    _reload(native)


def test_version():
    assert native.lib_version().startswith("tfruntime")
    assert native.available() and jnative.available()


@pytest.mark.parametrize("src,dst", [
    (np.float64, np.float32), (np.float32, np.float64),
    (np.int64, np.int32), (np.int32, np.int64),
    (np.int64, np.float32), (np.float64, np.int64),
])
def test_convert_matches_astype(rng, src, dst):
    a = (rng.normal(size=300_000) * 100).astype(src)
    got = native.convert(a, dst)
    np.testing.assert_array_equal(got, a.astype(dst))
    assert got.dtype == np.dtype(dst)
    np.testing.assert_array_equal(got, jnative.convert(a, dst))


def test_convert_small_and_same_dtype(rng):
    a = rng.normal(size=10)
    assert native.convert(a, np.float64) is a
    np.testing.assert_array_equal(native.convert(a, np.float32),
                                  a.astype(np.float32))


def test_gather_rows(rng):
    src = rng.normal(size=(50_000, 8))
    idx = rng.integers(0, 50_000, size=30_000)
    got = native.gather_rows(src, idx)
    np.testing.assert_array_equal(got, src[idx])
    np.testing.assert_array_equal(got, jnative.gather_rows(src, idx))


def test_gather_rows_bad_index(rng):
    src = rng.normal(size=(50_000, 8))
    for bad in ([0, 50_000], [-1, 3]):
        with pytest.raises(IndexError, match="out of bounds"):
            native.gather_rows(src, np.array(bad))
        with pytest.raises(IndexError, match="out of bounds"):
            jnative.gather_rows(src, np.array(bad))


def test_pack_ragged(rng):
    cells = [rng.normal(size=rng.integers(0, 2000)) for _ in range(200)]
    values, offsets = native.pack_ragged(cells)
    assert offsets[0] == 0 and offsets[-1] == sum(c.size for c in cells)
    for i, c in enumerate(cells):
        np.testing.assert_array_equal(values[offsets[i]:offsets[i + 1]], c)
    jv, jo = jnative.pack_ragged(cells)
    np.testing.assert_array_equal(values, jv)
    np.testing.assert_array_equal(offsets, jo)


def test_pad_ragged(rng):
    cells = [rng.normal(size=rng.integers(1, 500)) for _ in range(300)]
    dense, mask = native.pad_ragged(cells)
    max_len = max(c.size for c in cells)
    assert dense.shape == (300, max_len) and mask.shape == (300, max_len)
    for i, c in enumerate(cells):
        np.testing.assert_array_equal(dense[i, :c.size], c)
        assert (dense[i, c.size:] == 0).all()
        assert mask[i, :c.size].all() and not mask[i, c.size:].any()
    jd, jm = jnative.pad_ragged(cells)
    np.testing.assert_array_equal(dense, jd)
    np.testing.assert_array_equal(mask, jm)
    assert mask.dtype == jm.dtype == np.uint8


def test_pad_ragged_overflow(rng):
    with pytest.raises(ValueError, match="max_len=10"):
        native.pad_ragged([np.ones(100_000)], max_len=10)


def test_empty_aligned_pool_roundtrip():
    native.pool_trim()
    a = native.empty_aligned((100_000,), np.float32)
    assert a.ctypes.data % 64 == 0
    a[:] = 1.5
    assert (a == 1.5).all()
    del a
    gc.collect()
    assert native.pool_bytes() > 0  # returned to the pool, not the OS
    b = native.empty_aligned((100_000,), np.float32)
    assert b.ctypes.data % 64 == 0
    del b
    gc.collect()
    native.pool_trim()
    assert native.pool_bytes() == 0


def test_engine_uses_native_paths(rng, monkeypatch):
    """End to end: the computation form of ``aggregate`` gathers each
    block's rows by key through ``native.gather_rows``, and its result
    equals the JAX package's."""
    import tensorframes_tpu as tft

    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    calls = []
    real = native.gather_rows

    def counting(src, idx):
        calls.append(len(idx))
        return real(src, idx)

    monkeypatch.setattr(native, "gather_rows", counting)
    try:
        keys = rng.integers(0, 5, size=1000).astype(np.int64)
        vals = rng.normal(size=1000)
        df = ttf.frame({"k": keys, "v": vals}, num_partitions=3)
        out = ttf.aggregate(lambda v_input: {"v": v_input.sum(0)},
                            df.group_by("k"))
        rows = sorted(out.collect(), key=lambda r: r["k"])
    finally:
        ttf.set_default_device(prev)
    assert sum(calls) == 1000 and len(calls) == 3
    jdf = tft.frame({"k": keys, "v": vals}, num_partitions=3)
    jrows = sorted(tft.aggregate(
        lambda v_input: {"v": v_input.sum(axis=0)}, jdf.group_by("k"))
        .collect(), key=lambda r: r["k"])
    assert [r["k"] for r in rows] == [r["k"] for r in jrows]
    for r, j in zip(rows, jrows):
        np.testing.assert_allclose(r["v"], vals[keys == r["k"]].sum(),
                                   rtol=1e-9)
        np.testing.assert_allclose(r["v"], j["v"], rtol=1e-12)


def test_pad_column_and_ragged_map_rows_go_through_native(rng, monkeypatch):
    """``TensorFrame.pad_column`` pads through ``native.pad_ragged`` and a
    ragged ``map_rows`` packs each shape group through
    ``native.pack_ragged``; both equal the JAX package's results."""
    import tensorframes_tpu as tft

    seen = []
    for name in ("pad_ragged", "pack_ragged"):
        real = getattr(native, name)

        def counting(*a, _real=real, _name=name, **k):
            seen.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(native, name, counting)
    cells = [rng.normal(size=int(n)) for n in rng.integers(1, 9, 40)]
    rows = [(c,) for c in cells]
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    try:
        padded = ttf.frame(rows, columns=["x"],
                           num_partitions=2).pad_column("x")
        blocks = padded.blocks()
        mapped = ttf.map_rows(lambda x: {"y": x * 2.0}, ttf.analyze(
            ttf.frame(rows, columns=["x"]))).collect()
    finally:
        ttf.set_default_device(prev)
    assert "pad_ragged" in seen and "pack_ragged" in seen
    jblocks = tft.frame(rows, columns=["x"], num_partitions=2).pad_column(
        "x").blocks()
    for b, j in zip(blocks, jblocks):
        for c in ("x", "x_mask", "x_len"):
            np.testing.assert_array_equal(b.columns[c], j.columns[c])
            assert b.columns[c].dtype == j.columns[c].dtype
    for r, c in zip(mapped, cells):
        np.testing.assert_array_equal(r["y"], c * 2.0)


def test_numpy_fallbacks_are_bit_equal(rng, fallback):
    """Under ``TFT_DISABLE_NATIVE=1`` every function runs its numpy
    equivalent, with results equal to the library's (the JAX package's)."""
    a = (rng.normal(size=300_000) * 100)
    np.testing.assert_array_equal(native.convert(a, np.int32),
                                  jnative.convert(a, np.int32))
    src = rng.normal(size=(50_000, 8))
    idx = rng.integers(0, 50_000, size=30_000)
    np.testing.assert_array_equal(native.gather_rows(src, idx),
                                  jnative.gather_rows(src, idx))
    with pytest.raises(IndexError, match="out of bounds"):
        native.gather_rows(src, np.array([0, 50_000]))
    cells = [rng.normal(size=rng.integers(0, 2000)) for _ in range(200)]
    for got, want in zip(native.pack_ragged(cells),
                         jnative.pack_ragged(cells)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(native.pad_ragged(cells),
                         jnative.pad_ragged(cells)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    with pytest.raises(ValueError):
        native.pad_ragged([np.ones(100_000)], max_len=10)
    b = native.empty_aligned((100_000,), np.float32)
    assert b.shape == (100_000,) and native.pool_bytes() == 0
    assert native.lib_version() is None


def test_tft_native_lib_names_a_prebuilt_library(monkeypatch):
    path = _build._library_path("host_runtime")
    assert path.exists()
    _reload(native, monkeypatch, TFT_NATIVE_LIB=str(path))
    try:
        assert native.available()
        assert native.lib_version().startswith("tfruntime")
    finally:
        monkeypatch.delenv("TFT_NATIVE_LIB")
        _reload(native)


def test_two_processes_build_the_library_at_once(tmp_path):
    """Two interpreters reach the first use together with an empty build
    directory: each compiles into a temporary file of its own and moves it
    into place, and both load a working library."""
    code = textwrap.dedent(f"""
        import sys, time
        from pathlib import Path
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        from tensorframes_tpu_torch.ops import _build
        _build.BUILD_DIR = Path({str(tmp_path / "kernels")!r})
        go = Path({str(tmp_path / "go")!r})
        while not go.exists():
            time.sleep(0.01)
        from tensorframes_tpu_torch import native
        assert native.available()
        a = np.arange(200_000, dtype=np.int64)
        assert np.array_equal(native.convert(a, np.float32),
                              a.astype(np.float32))
        print(_build._library_path("host_runtime"))
    """)
    env = {k: v for k, v in os.environ.items()
           if k not in ("TFT_DISABLE_NATIVE", "TFT_NATIVE_LIB")}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    (tmp_path / "go").write_text("")
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    libs = {out.strip() for out, _ in outs}
    assert len(libs) == 1
    built = sorted(x.name for x in (tmp_path / "kernels").iterdir())
    assert built == [Path(libs.pop()).name]  # no temporary file left


def test_port_marshal_validates_block_columns_as_the_jax_package():
    from tensorframes_tpu import marshal as jmarshal
    from tensorframes_tpu import schema as jschema
    from tensorframes_tpu import dtypes as jdt
    from tensorframes_tpu.shape import Shape as JShape
    from tensorframes_tpu_torch import marshal, schema, dtypes
    from tensorframes_tpu_torch.shape import Shape, Unknown

    cases = [
        (np.zeros((4, 3)), (Unknown, 3), None),
        (np.zeros((4, 2)), (Unknown, 3), "does not conform"),
        ([np.zeros(2), np.zeros(3)], None, None),
        ([np.zeros(2), np.zeros((3, 1))], (Unknown, Unknown), "cell rank"),
    ]
    for col, shape, err in cases:
        pf = schema.Field("v", dtypes.double,
                          block_shape=Shape(*shape) if shape else None)
        jf = jschema.Field("v", jdt.double,
                           block_shape=JShape(*shape) if shape else None)
        for mod, fld in ((marshal, pf), (jmarshal, jf)):
            if err is None:
                mod.validate_block_column("v", col, fld)
            else:
                with pytest.raises(ValueError, match=err):
                    mod.validate_block_column("v", col, fld)
