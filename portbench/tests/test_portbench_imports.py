"""Nothing under ``portbench/`` imports JAX or the JAX package, the plain
reference imports nothing of the port, and no file reads the JAX
package's benchmarks."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import core

PKG = Path(__file__).resolve().parents[1]
SOURCES = sorted(PKG.rglob("*.py"))


def imported(path: Path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import(path):
    bad = set(imported(path)) & set(core.FORBIDDEN_MODULES)
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("name", ["reference.py"])
def test_reference_imports_nothing_of_the_port(name):
    names = set(imported(PKG / name))
    assert not names & {"tensorframes_tpu_torch", "tensorframes_tpu",
                        "portbench"}, names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_reads_no_jax_benchmark_files(path):
    text = path.read_text()
    for word in ("benchmarks/", "bench.py", "BENCH_r", "MULTICHIP_",
                 "BASELINE.json", "chip_smoke"):
        if path.name == Path(__file__).name:
            continue
        assert f'"{word}' not in text and f"'{word}" not in text, (path, word)


def test_names_are_compared_whole(monkeypatch):
    fake = {"tensorframes_tpu_torch": 1, "tensorframes_tpu_torch.ops": 1,
            "jaxtyping": 1, "flaxen": 1}
    monkeypatch.setattr(sys, "modules", dict(fake))
    assert core.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", dict(
        fake, **{"tensorframes_tpu.ops": 1, "jax": 1, "jaxlib.xla": 1,
                 "flax": 1}))
    assert core.forbidden_modules() == ["flax", "jax", "jaxlib.xla",
                                        "tensorframes_tpu.ops"]


def test_a_run_loads_no_jax():
    """A whole small run in a fresh interpreter leaves no JAX module."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import run, core\n"
        "from portbench.tests.cells import SMALL\n"
        "res, _ = run.run_cell('tpch_q1', 7, 0.3, False, 'cpu',"
        " overrides=SMALL['tpch_q1'])\n"
        "assert res['correct'], res\n"
        "print(core.forbidden_modules())\n" % str(PKG.parent))
    env = {k: v for k, v in __import__("os").environ.items()}
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert got.returncode == 0, got.stderr[-3000:]
    assert got.stdout.strip().splitlines()[-1] == "[]"
