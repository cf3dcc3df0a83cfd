"""The mesh's lines of the decision audit, and the ``analytics`` demo, held
against the JAX package.

- each of the mesh's and the distributed plan's decision kinds
  (``dplan.fallback``, ``mesh.shrink``, ``mesh.grow``,
  ``mesh.rebalance``, ``mesh.exchange_skew``, ``mesh.salt``) renders with
  the JAX package's text from the same record;
- ``why`` reconstructs a real device loss on an 8-shard mesh, as
  ``tests/test_flight.py::TestWhy::test_why_reconstructs_a_mesh_shrink``
  does, with the JAX package's line;
- ``doctor()`` has the JAX package's mesh line;
- ``demos/analytics.py`` against ``tests/test_demos.py::
  test_analytics_pipeline_matches_numpy`` and against the JAX demo's rows
  over the same CSV file.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

import tensorframes_tpu as jtf
import tensorframes_tpu_torch as ttf
from tensorframes_tpu import parallel as jpar
from tensorframes_tpu.observability import decisions as jdec
from tensorframes_tpu.observability import flight as jflight
from tensorframes_tpu.parallel import elastic as jelastic
from tensorframes_tpu.resilience import faults as jfaults
from tensorframes_tpu_torch import parallel as tpar
from tensorframes_tpu_torch.observability import decisions as tdec
from tensorframes_tpu_torch.observability import flight as tflight
from tensorframes_tpu_torch.parallel import elastic as telastic
from tensorframes_tpu_torch.resilience import faults as tfaults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BOTH = [(jtf, jpar, jflight, jfaults, jelastic),
        (ttf, tpar, tflight, tfaults, telastic)]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("TFT_CPU_DEVICE_COUNT", "8")
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    for _, _, fl, fa, el in BOTH:
        fa.reset()
        fl.clear()
        el._lost_pool.clear()
        el._upgrades.clear()
        el._tracker.clear()
    yield
    for _, _, fl, fa, el in BOTH:
        fa.reset()
        el._lost_pool.clear()
        el._upgrades.clear()
    ttf.set_default_device(prev)


RECORDS = [
    {"kind": "dplan.fallback", "error": "RuntimeError: boom",
     "error_kind": "permanent", "stages": 2},
    {"kind": "mesh.shrink", "op": "dmap_blocks", "device": 3,
     "devices_before": 8, "devices_after": 7, "reshard_rows": 5},
    {"kind": "mesh.grow", "devices": [3], "devices_before": 7,
     "devices_after": 8},
    {"kind": "mesh.rebalance", "op": "daggregate", "ratio": 2.4,
     "threshold": 1.5, "streak": 3, "before": [5, 5, 5, 5],
     "after": [7, 7, 3, 3]},
    {"kind": "mesh.exchange_skew", "op": "dexchange", "ratio": 3.1,
     "threshold": 1.5, "rows": 400, "per_shard": [250, 50, 50, 50]},
    {"kind": "mesh.salt", "count": 2, "fraction": 0.25, "slots": 8,
     "rows": 4000, "groups": [0, 3]},
]


@pytest.mark.parametrize("rec", RECORDS, ids=[r["kind"] for r in RECORDS])
def test_each_mesh_kind_renders_with_the_jax_text(rec):
    got, want = tdec._detail(dict(rec)), jdec._detail(dict(rec))
    assert got == want
    # a line of its own, not the key=value fallback of an unknown kind
    assert not re.match(r"^\w+=", got), got


def test_the_mesh_kinds_are_anomalies_in_both():
    for kind in ("mesh.shrink", "mesh.rebalance", "dplan.fallback",
                 "mesh.exchange_skew"):
        assert kind in tdec.ANOMALY_KINDS and kind in jdec.ANOMALY_KINDS


def test_why_reconstructs_a_mesh_shrink():
    reports = []
    for top, par, fl, fa, _ in BOTH:
        dist = par.distribute(
            top.frame({"x": np.arange(40.0)}, num_partitions=1),
            par.local_mesh(8))
        with fl.scope("q-shrink"):
            with fa.inject("device", 1):
                out = par.dmap_blocks(lambda x: {"z": x * 2.0}, dist)
        assert out.mesh.num_devices == 7
        shr = [r for r in fl.for_query("q-shrink")
               if r["kind"] == "mesh.shrink"]
        assert len(shr) == 1
        assert (shr[0]["devices_before"], shr[0]["devices_after"],
                shr[0]["device"]) == (8, 7, 0)
        assert shr[0]["reshard_rows"] > 0
        report = top.why("q-shrink")
        assert "LOST" in report and "8 -> 7" in report
        reports.append([re.sub(r"\+\s*\d+\.\d+s", "", ln)
                        for ln in report.splitlines() if "LOST" in ln])
    assert reports[1] == reports[0]


MESH_LINE = re.compile(
    r"^  mesh     : (\d+|None) visible device\(s\) · lost pool "
    r"(empty|\[[\d, ]*\]) · \d+ shrink\(s\) / \d+ grow\(s\) / \d+ "
    r"rebalance\(s\)$")


def test_doctor_has_the_mesh_line():
    lines = []
    for top, par, _, fa, _ in BOTH:
        dist = par.distribute(top.frame({"x": np.arange(16.0)}),
                              par.local_mesh(8))
        with fa.inject("device", 1):
            par.dmap_blocks(lambda x: {"z": x + 1.0}, dist)
        out = top.doctor()
        mesh = [ln for ln in out.splitlines() if ln.startswith("  mesh ")]
        assert len(mesh) == 1 and MESH_LINE.match(mesh[0]), mesh
        assert "lost pool [0]" in mesh[0]
        # the shrink is an anomaly doctor() lists
        assert "mesh.shrink" in out
        lines.append(re.sub(r"\d+ visible", "N visible", mesh[0]))
    assert lines[1] == lines[0]


# -- the analytics demo ------------------------------------------------------

def _numpy_report(csv_path):
    raw = np.genfromtxt(csv_path, delimiter=",", names=True)
    keep = raw["value"] >= 0
    ref = {}
    for s, d, v in zip(raw["site"][keep].astype(int),
                       raw["sensor"][keep].astype(int), raw["value"][keep]):
        ref[(s, d)] = ref.get((s, d), 0.0) + v
    return ref


def test_analytics_pipeline_matches_numpy(tmp_path):
    from tensorframes_tpu_torch.demos import analytics as an

    csv_path = str(tmp_path / "readings.csv")
    an.make_csv(csv_path, n=3000, sites=3, sensors=4, seed=5)
    rows = an.pipeline(csv_path).collect()
    ref = _numpy_report(csv_path)
    got = {(r["site"], r["sensor"]): r["value"] for r in rows}
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-12)
    totals = [r["value"] for r in rows]
    assert totals == sorted(totals, reverse=True)


def test_analytics_rows_equal_the_jax_demos(tmp_path):
    sys.path.insert(0, ROOT)
    from demos import analytics as jan

    from tensorframes_tpu_torch.demos import analytics as tan

    csv_path = str(tmp_path / "readings.csv")
    jan.make_csv(csv_path, n=4000, sites=4, sensors=8, seed=3)
    ported = str(tmp_path / "ported.csv")
    tan.make_csv(ported, n=4000, sites=4, sensors=8, seed=3)
    with open(csv_path, "rb") as a, open(ported, "rb") as b:
        assert a.read() == b.read()  # the same generator, the same file
    want = jan.pipeline(csv_path, mesh=jpar.local_mesh(8)).collect()
    mesh = tpar.DeviceMesh(np.array([torch.device("cpu")] * 8,
                                    dtype=object))
    got = tan.pipeline(csv_path, mesh=mesh).collect()
    assert [(r["site"], r["sensor"]) for r in got] == \
        [(r["site"], r["sensor"]) for r in want]
    np.testing.assert_allclose([r["value"] for r in got],
                               [r["value"] for r in want], rtol=1e-12)


def test_analytics_main_runs(capsys, monkeypatch):
    from tensorframes_tpu_torch.demos import analytics as an

    out = an.main()
    assert out["groups"] == 32
    assert "(site, sensor) groups" in capsys.readouterr().out
