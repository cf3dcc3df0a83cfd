"""A configuration, a cell, a driver and a metric added as new files, with
no existing file edited, are found by name and run."""

import json
import shutil
import textwrap

import pytest

from portbench import core, run
from portbench.tests.cells import ROOT, cpu_port  # noqa: F401

DRIVER = '''
"""A dummy kind: sums of seeded rows, on the port's default device."""
import torch
from portbench.core import Check


class Cell:
    def __init__(self, config, workload, seed, device):
        self.cfg, self.wl, self.seed, self.device = config, workload, seed, device
        self.got = []

    def setup(self):
        g = torch.Generator().manual_seed(self.seed)
        self.x = torch.rand(self.cfg["rows"], generator=g, dtype=torch.float64)

    def request(self, p):
        self.got.append((p["w"], float((self.x * p["w"]).sum())))
        return {"rows": float(self.cfg["rows"])}

    def release(self):
        pass

    def check(self):
        worst = max(abs(s - float(self.x.sum()) * w) for w, s in self.got)
        return [Check("sum_err", worst, self.wl["check"]["limits"]["sum_err"])]
'''

METRIC = '''
"""A dummy per-layer metric: requests completed in the window."""


def read(ctx):
    return float(len(ctx.window.done()))
'''


@pytest.fixture
def tree(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    pb = root / "portbench"
    (pb / "configs" / "dummy_rows.json").write_text(json.dumps(
        {"name": "dummy_rows", "source": "https://example.org/dummy",
         "rows": 1000, "precision": "float64", "reduced": []}))
    (pb / "workloads" / "dummy_cell.json").write_text(json.dumps(
        {"config": "dummy_rows", "driver": "dummy_kind", "chips": 1,
         "why": "a dummy", "traffic": {"params": {"w": {"integers": [1, 2]}}},
         "check": {"sample": 1, "limits": {"sum_err": 1e-9}}}))
    (pb / "drivers" / "dummy_kind.py").write_text(textwrap.dedent(DRIVER))
    (pb / "metrics" / "dummy_requests.py").write_text(METRIC)
    bench["configs"].append({"name": "dummy_rows", "source": "x",
                             "file": "portbench/configs/dummy_rows.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy_rows",
                               "traffic": "dummy_cell", "chips": 1,
                               "why": "a dummy"})
    bench["end_to_end"][0]["workloads"].append("dummy_cell")
    bench["per_layer"].append({"name": "dummy_requests", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "Dummy", "moves": "rows_per_s",
                               "workloads": ["dummy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    yield root
    after = {p: p.read_bytes() for p in before}
    assert after == before, "an existing file was edited"


@pytest.mark.parametrize("trace", [False, True])
def test_added_files_are_found_and_run(tree, trace, cpu_port):
    res, _ = run.run_cell("dummy_cell", 9, 0.2, trace, "cpu", root=tree)
    assert res["correct"], res
    if trace:
        assert res["metrics"]["dummy_requests"]["value"] >= 1
    else:
        assert set(res["metrics"]) == {"rows_per_s", "setup_s"}


def test_unknown_names_are_refused(tree):
    with pytest.raises(FileNotFoundError):
        core.load_workload("no_such_cell", tree)
    with pytest.raises(ValueError):
        core.load_workload("../BENCHMARK", tree)
