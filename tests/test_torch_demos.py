"""The port's demos (``tensorframes_tpu_torch/demos/``) against the numpy
checks of ``tests/test_demos.py`` and against the JAX package's demos on
the same seeded data.

Tolerances: the numpy checks keep ``test_demos.py``'s (rtol 1e-5 for
k-means, 1e-6 for the means); port against JAX package is rtol 1e-12 at
f64 (the same math, summed in other orders).
"""

import numpy as np
import pytest

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from demos import geom_mean as jgm
from demos import groupby_scratch as jgs
from demos import kmeans as jkm
from tensorframes_tpu_torch.demos import geom_mean as gm
from tensorframes_tpu_torch.demos import groupby_scratch as gs
from tensorframes_tpu_torch.demos import kmeans as km
from tensorframes_tpu_torch.utils.tracing import counters as tcounters

RTOL = 1e-12


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    yield
    ttf.set_default_device(prev)


# -- kmeans -----------------------------------------------------------------

@pytest.fixture(scope="module")
def km_data():
    args = dict(n=200, num_features=3, k=2, num_partitions=3)
    return km.make_data(**args), jkm.make_data(**args)


def _numpy_step(pts, centers):
    d = ((pts[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    idx = d.argmin(1)
    new = np.stack([
        pts[idx == j].mean(0) if (idx == j).any() else centers[j]
        for j in range(centers.shape[0])])
    return new, float(d.min(1).sum())


def test_make_data_is_the_jax_packages(km_data):
    (df, init, true_c), (jdf, jinit, jtrue) = km_data
    np.testing.assert_array_equal(init, jinit)
    np.testing.assert_array_equal(true_c, jtrue)
    assert [b.num_rows for b in df.blocks()] == \
        [b.num_rows for b in jdf.blocks()]
    for a, b in zip(df.blocks(), jdf.blocks()):
        np.testing.assert_array_equal(a.dense("features"),
                                      b.dense("features"))


@pytest.mark.parametrize("variant", ["aggregate", "preaggregate"])
def test_kmeans_step_matches_numpy_and_the_jax_package(km_data, variant):
    (df, init, _), (jdf, _, _) = km_data
    step = getattr(km, f"step_{variant}")
    jstep = getattr(jkm, f"step_{variant}")
    pts = np.concatenate([b.dense("features") for b in df.blocks()])
    tcounters.reset()
    got_c, got_d = step(df, init)
    want_c, want_d = _numpy_step(pts, init)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5)
    assert got_d == pytest.approx(want_d, rel=1e-5)
    j_c, j_d = jstep(jdf, init)
    np.testing.assert_allclose(got_c, j_c, rtol=RTOL)
    assert got_d == pytest.approx(j_d, rel=RTOL)
    # variant A's aggregate folds; variant B has no keyed aggregate
    assert (tcounters.get("aggregate.fold_calls") > 0) == \
        (variant == "aggregate")
    assert tcounters.get("aggregate.buffer_calls") == 0


def test_kmeans_converges_to_true_centers(km_data):
    (df, init, true_centers), (jdf, _, _) = km_data
    centers, history = km.kmeans(df, init, num_iters=30)
    assert history == sorted(history, reverse=True)  # monotone improvement
    for t in true_centers:
        assert np.linalg.norm(centers - t, axis=1).min() < 0.5
    j_centers, j_history = jkm.kmeans(jdf, init, num_iters=30)
    assert len(history) == len(j_history)
    np.testing.assert_allclose(history, j_history, rtol=RTOL)
    np.testing.assert_allclose(centers, j_centers, rtol=RTOL)


@pytest.mark.parametrize("shards", [8, 1])
@pytest.mark.parametrize("variant", ["device_resident", "daggregate"])
def test_kmeans_mesh_step_matches_numpy_and_the_jax_package(
        km_data, variant, shards, monkeypatch):
    """Variants C and D on a distributed frame: the port on ``shards``
    logical CPU shards, the JAX package on its 8 virtual devices."""
    from tensorframes_tpu.parallel import distribute as jdistribute
    from tensorframes_tpu.parallel import local_mesh as jlocal_mesh
    from tensorframes_tpu_torch.parallel import distribute, local_mesh

    (df, init, _), (jdf, _, _) = km_data
    monkeypatch.setenv("TFT_CPU_DEVICE_COUNT", str(shards))
    dist = distribute(df, local_mesh())
    assert dist.mesh.num_data_shards == shards
    pts = np.concatenate([b.dense("features") for b in df.blocks()])
    step = getattr(km, f"step_{variant}")
    got_c, got_d = step(dist, init)
    want_c, want_d = _numpy_step(pts, init)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5)
    assert got_d == pytest.approx(want_d, rel=1e-5)
    j_c, j_d = getattr(jkm, f"step_{variant}")(
        jdistribute(jdf, jlocal_mesh()), init)
    np.testing.assert_allclose(got_c, j_c, rtol=RTOL)
    assert got_d == pytest.approx(j_d, rel=RTOL)
    # and the driver loop converges alike
    centers, history = km.kmeans(dist, init, num_iters=30, step=step)
    j_centers, j_history = jkm.kmeans(jdistribute(jdf, jlocal_mesh()), init,
                                      num_iters=30, step=getattr(
                                          jkm, f"step_{variant}"))
    assert len(history) == len(j_history)
    np.testing.assert_allclose(history, j_history, rtol=RTOL)
    np.testing.assert_allclose(centers, j_centers, rtol=RTOL)


# -- harmonic / geometric mean ----------------------------------------------

def _keys_and_x(df):
    x = np.concatenate([b.dense("x") for b in df.blocks()])
    keys = np.concatenate(
        [np.asarray([c for c in b.columns["key"]]) for b in df.blocks()])
    return keys, x


@pytest.mark.parametrize("mean", ["harmonic", "geometric"])
def test_mean_per_key(mean):
    df = gm.make_data(n=30)
    rows = getattr(gm, f"{mean}_mean_per_key")(df).collect()
    keys, x = _keys_and_x(df)
    got = {r["key"]: r[f"{mean}_mean"] for r in rows}
    assert set(got) == {"g0", "g1", "g2"}
    for g in got:
        grp = x[keys == g]
        want = (len(grp) / (1.0 / grp).sum() if mean == "harmonic"
                else np.exp(np.log(grp).mean()))
        assert got[g] == pytest.approx(want, rel=1e-6)
    jrows = getattr(jgm, f"{mean}_mean_per_key")(jgm.make_data(n=30)) \
        .collect()
    assert [r["key"] for r in rows] == [r["key"] for r in jrows]
    np.testing.assert_allclose([r[f"{mean}_mean"] for r in rows],
                               [r[f"{mean}_mean"] for r in jrows], rtol=RTOL)


def test_string_key_and_unused_column_ride_along():
    df = gm.make_data(n=12)
    out = ttf.map_blocks(lambda x: {"y": x * 2.0}, df)
    rows = out.collect()
    assert rows[0].fields == ("key", "x", "y")
    assert isinstance(rows[0]["key"], str)
    jrows = jtf.map_blocks(lambda x: {"y": x * 2.0},
                           jgm.make_data(n=12)).collect()
    assert [tuple(r) for r in rows] == [tuple(r) for r in jrows]


# -- groupby scratch + README examples --------------------------------------

def test_groupby_sum():
    rows = gs.groupby_sum()
    assert [(r["key"], r["x"]) for r in rows] == [("0", 3.0), ("1", 12.0)]
    assert [tuple(r) for r in rows] == [tuple(r) for r in jgs.groupby_sum()]


def test_readme_map_blocks():
    rows = gs.readme_map_blocks()
    assert [r["z"] for r in rows] == [3.0, 4.0, 5.0, 6.0, 7.0]
    assert [tuple(r) for r in rows] == \
        [tuple(r) for r in jgs.readme_map_blocks()]


def test_readme_reduce_vector():
    s, m = gs.readme_reduce_vector()
    np.testing.assert_allclose(s, [3.0, 3.0])
    np.testing.assert_allclose(m, [1.0, 1.0])
    js, jm = jgs.readme_reduce_vector()
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(m, jm)


def test_readme_dsl_map():
    rows = gs.readme_dsl_map()
    np.testing.assert_allclose([r["z"] for r in rows],
                               np.arange(5.0) * 0.1 + 3.0)
    assert [tuple(r) for r in rows] == \
        [tuple(r) for r in jgs.readme_dsl_map()]
