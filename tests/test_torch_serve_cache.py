"""The port's shared compile cache (``serve/cache.py``) and the executor's
interner hook against the JAX package's.

Mirrors ``tests/test_serve.py::TestSharedCompileCache``, all five cases,
with the interner installed directly through
``engine.executor.set_computation_interner`` (the port has no scheduler
yet). The same sequence of computations goes through both packages'
caches, and their statistics must be equal. The port prepares nothing per
shape; its ``BlockExecutor.compile_count`` counts the deserialized
programs it has placed on a device, so the executor cases ship their
programs as bytes first.
"""

import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as ttf
from tensorframes_tpu import dtypes as jdt
from tensorframes_tpu.computation import Computation as JComputation
from tensorframes_tpu.computation import TensorSpec as JSpec
from tensorframes_tpu.serve.cache import (
    SharedCompileCache as JCache,
    computation_signature as j_signature)
from tensorframes_tpu.shape import Shape as JShape
from tensorframes_tpu.shape import Unknown as JUnknown
from tensorframes_tpu_torch import dtypes as dt
from tensorframes_tpu_torch.computation import Computation, TensorSpec
from tensorframes_tpu_torch.engine.executor import (
    BlockExecutor, current_computation_interner, set_computation_interner)
from tensorframes_tpu_torch.serve import (SharedCompileCache,
                                          computation_signature)
from tensorframes_tpu_torch.shape import Shape, Unknown
from tensorframes_tpu_torch.utils.tracing import counters


@pytest.fixture(autouse=True)
def _cpu():
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    before = current_computation_interner()
    yield
    set_computation_interner(before)
    ttf.set_default_device(prev)


def _comp(fn):
    return Computation.trace(fn, [TensorSpec("x", dt.double,
                                             Shape(Unknown))])


def _jcomp(fn):
    return JComputation.trace(fn, [JSpec("x", jdt.double,
                                         JShape(JUnknown))])


def _shipped(fn):
    return Computation.deserialize(_comp(fn).serialize())


class TestSharedCompileCache:
    def test_identical_programs_intern_to_one(self):
        cache, jcache = SharedCompileCache(capacity=8), JCache(capacity=8)
        c1 = _comp(lambda x: {"z": x + 3.0})
        c2 = _comp(lambda x: {"z": x + 3.0})
        assert computation_signature(c1) == computation_signature(c2)
        assert cache.intern(c1) is c1
        assert cache.intern(c2) is c1
        j1, j2 = _jcomp(lambda x: {"z": x + 3.0}), _jcomp(
            lambda x: {"z": x + 3.0})
        jcache.intern(j1)
        jcache.intern(j2)
        st = cache.stats()
        assert st["hits"] == 1 and st["misses"] == 1
        assert st == jcache.stats()

    def test_different_programs_never_merge(self):
        cache = SharedCompileCache(capacity=8)
        add = _comp(lambda x: {"z": x + 3.0})
        mul = _comp(lambda x: {"z": x * 3.0})
        assert computation_signature(add) != computation_signature(mul)
        assert cache.intern(add) is add
        assert cache.intern(mul) is mul

    def test_captured_array_constants_distinguish(self):
        a = torch.arange(4.0, dtype=torch.float64)
        b = a + 1.0
        ca = _comp(lambda x: {"z": x[:4] + a})
        cb = _comp(lambda x: {"z": x[:4] + b})
        sa, sb = computation_signature(ca), computation_signature(cb)
        if sa is not None and sb is not None:
            assert sa != sb
        # at static shapes the programs export, and differ only in the
        # captured table
        spec = [TensorSpec("x", dt.double, Shape(4))]
        fa = Computation.trace(lambda x: {"z": x + a}, spec)
        fb = Computation.trace(lambda x: {"z": x + b}, spec)
        a2 = a.clone()  # equal values in another tensor
        fa2 = Computation.trace(lambda x: {"z": x + a2}, spec)
        assert None not in (computation_signature(fa),
                            computation_signature(fb))
        assert computation_signature(fa) != computation_signature(fb)
        assert computation_signature(fa) == computation_signature(fa2)

    def test_executor_hook_skips_recompiles(self):
        """The interner installed directly: two loads of one shipped
        program prepare one device program; uninstalled, a third load
        prepares anew."""
        ex = BlockExecutor()
        x = np.arange(32.0)
        cache = SharedCompileCache(capacity=8)
        prev = set_computation_interner(cache.intern)
        try:
            c1 = _shipped(lambda x: {"z": x + 7.0})
            c2 = _shipped(lambda x: {"z": x + 7.0})
            ex.run(c1, {"x": x})
            out = ex.run(c2, {"x": x})  # interned: c1's placed module
            np.testing.assert_array_equal(out["z"], x + 7.0)
            assert ex.compile_count == 1
            assert cache.stats()["hits"] >= 1
            assert c2.fn._placed == {}
        finally:
            set_computation_interner(prev)
        c3 = _shipped(lambda x: {"z": x + 7.0})
        ex.run(c3, {"x": x})
        assert ex.compile_count == 2

    def test_lru_bound(self):
        cache, jcache = SharedCompileCache(capacity=2), JCache(capacity=2)
        for k in range(4):
            cache.intern(_comp(lambda x, k=float(k): {"z": x + k}))
            jcache.intern(_jcomp(lambda x, k=float(k): {"z": x + k}))
        assert len(cache) == len(jcache) == 2
        assert cache.stats() == jcache.stats()


def test_symbolic_rows_keep_programs_apart():
    """``x * x.shape[0]`` and ``x * 2.0`` agree at 2 rows; under the
    symbolic row dim their graphs differ, in both packages."""
    rows, two = _comp(lambda x: {"z": x * x.shape[0]}), _comp(
        lambda x: {"z": x * 2.0})
    x = torch.arange(2.0, dtype=torch.float64)
    torch.testing.assert_close(rows({"x": x})["z"], two({"x": x})["z"])
    assert computation_signature(rows) != computation_signature(two)
    jrows, jtwo = _jcomp(lambda x: {"z": x * x.shape[0]}), _jcomp(
        lambda x: {"z": x * 2.0})
    assert j_signature(jrows) != j_signature(jtwo)
    cache = SharedCompileCache(capacity=8)
    assert cache.intern(rows) is rows and cache.intern(two) is two
    assert cache.stats()["misses"] == 2


def test_same_sequence_same_stats():
    """One sequence of programs through both packages' caches."""
    fns = [lambda x: {"z": x + 3.0}, lambda x: {"z": x * 3.0},
           lambda x: {"z": x + 3.0}, lambda x: {"z": x - 1.0},
           lambda x: {"z": x * 3.0}, lambda x: {"z": x + 3.0}]
    cache, jcache = SharedCompileCache(capacity=8), JCache(capacity=8)
    for fn in fns:
        cache.intern(_comp(fn))
        jcache.intern(_jcomp(fn))
    assert cache.stats() == jcache.stats() == {
        "entries": 3, "hits": 3, "misses": 3, "uncacheable": 0,
        "capacity": 8}


def test_uncacheable_program_runs_uninterned():
    """A program that cannot export symbolically (it reads a value on
    the host) gets no signature: counted, run un-interned, never failed."""
    comp = _comp(lambda x: {"z": x * float(x.sum())})
    assert computation_signature(comp) is None
    cache = SharedCompileCache(capacity=8)
    before = counters.get("serve.compile_cache.uncacheable")
    prev = set_computation_interner(cache.intern)
    try:
        out = BlockExecutor().run(comp, {"x": np.arange(4.0)})
    finally:
        set_computation_interner(prev)
    np.testing.assert_array_equal(out["z"], np.arange(4.0) * 6.0)
    assert cache.stats()["uncacheable"] == 1
    assert counters.get("serve.compile_cache.uncacheable") == before + 1


def test_failing_interner_never_gates():
    def broken(comp):
        raise RuntimeError("interner down")

    prev = set_computation_interner(broken)
    try:
        out = BlockExecutor().run(_comp(lambda x: {"z": x + 1.0}),
                                  {"x": np.arange(3.0)})
    finally:
        assert set_computation_interner(prev) is broken
    np.testing.assert_array_equal(out["z"], np.arange(3.0) + 1.0)


def test_map_rows_shares_the_vmapped_wrapper(rng):
    """Two loads of one shipped row program through ``map_rows``: the
    vmapped wrappers take their signatures from the programs', so the
    second interns to the first and only one program is placed."""
    P = torch.from_numpy(rng.standard_normal((8, 3)))
    blob = Computation.trace(lambda x: {"z": ((x @ P) ** 2).sum(-1)},
                             [TensorSpec("x", dt.double, Shape(8))]
                             ).serialize()
    x = rng.standard_normal((10, 8))
    df = ttf.frame({"x": x}, num_partitions=2)
    cache = SharedCompileCache(capacity=8)
    prev = set_computation_interner(cache.intern)
    try:
        c1, c2 = Computation.deserialize(blob), Computation.deserialize(blob)
        a = ttf.map_rows(c1, df).blocks()
        b = ttf.map_rows(c2, df).blocks()
    finally:
        set_computation_interner(prev)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.columns["z"], v.columns["z"])
    np.testing.assert_allclose(
        np.concatenate([u.columns["z"] for u in a]),
        ((x @ P.numpy()) ** 2).sum(-1), rtol=1e-12)
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 1
    assert list(c1.fn._placed) == ["cpu"] and c2.fn._placed == {}


def test_compile_count_counts_placements_per_device():
    ex = BlockExecutor()
    comp = _shipped(lambda x: {"z": x * 2.0})
    for n in (3, 5, 1):
        ex.run(comp, {"x": np.arange(float(n))})
    assert ex.compile_count == 1
    assert BlockExecutor().compile_count == 0
    live = _comp(lambda x: {"z": x * 2.0})
    ex.run(live, {"x": np.arange(3.0)})
    assert ex.compile_count == 1  # a live program prepares nothing
