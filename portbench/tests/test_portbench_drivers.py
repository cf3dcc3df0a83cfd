"""Each cell at a small size on the CPU, through the harness as a run
drives it: the port's answers agree with the plain reference, and the
line carries the cell's metrics."""

import json
import subprocess
import sys

import pytest

from portbench import core, run
from portbench.tests.cells import CELLS, ROOT, SMALL, cpu_port  # noqa: F401

BENCH = core.load_benchmark()


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_cpu_agrees_with_the_reference(cell, trace, cpu_port):
    res, checks = run.run_cell(cell, 2 ** 31 + 17, 0.5, trace, "cpu",
                               overrides=SMALL[cell])
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert {c.name for c in checks} == set(
        core.load_workload(cell)["check"]["limits"])
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in core.cell_metrics(BENCH, section, cell)}
    got = set(res["metrics"])
    assert got <= want
    if not trace:
        assert got == want  # every end-to-end metric is read by host clock
    else:
        # the device's metrics read nothing on a CPU; the spans' do
        assert {"idle_share.analytics", "idle_share.inference",
                "idle_share.inference.b32",
                "keyed_sum_roofline"}.isdisjoint(got)
        assert "busy_s" in res["device"] and "breakdown" in res


def test_every_listed_item_has_its_file():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert core.load_config(c["name"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        spec = core.load_workload(w["traffic"])
        assert spec["config"] == w["config"] and spec["chips"] == w["chips"]
        assert spec["why"] == w["why"]
        assert hasattr(core.load_driver(spec["driver"]), "Cell")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(core.load_metric(m["name"]).read)


def test_main_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert run.main(["--workload", "tpch_q1", "--seed", "1",
                     "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """One short run of each cell as the benchmark runs it, on the card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    got = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         cell, "--seed", "5", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert got.returncode == 0, got.stderr[-3000:]
    res = json.loads(got.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
