"""Discovery of the benchmark's files by name, and the records of a run.

Every cell, configuration, driver and metric is a file of its own under
``portbench/``, found from the name that ``BENCHMARK.json`` or a cell's
file gives, so a later change adds a file and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]  # the checkout
PACKAGE = "portbench"
# top-level module names a run may not hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tensorframes_tpu")
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")


def _checked(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name) or ".." in name:
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def load_workload(name: str, root: Path = ROOT) -> dict:
    """``portbench/workloads/<name>.json``: the cell's configuration name,
    driver kind, traffic parameters and correctness limits."""
    spec = _json(Path(root) / PACKAGE / "workloads" / f"{_checked(name)}.json")
    spec.setdefault("name", name)
    return spec


def load_config(name: str, root: Path = ROOT) -> dict:
    """``portbench/configs/<name>.json``: sizes, source and precision."""
    spec = _json(Path(root) / PACKAGE / "configs" / f"{_checked(name)}.json")
    spec.setdefault("name", name)
    return spec


def _module(kind: str, name: str, root: Path) -> ModuleType:
    path = Path(root) / PACKAGE / kind / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    mod_name = f"{PACKAGE}_{kind}_{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_driver(kind: str, root: Path = ROOT) -> ModuleType:
    """``portbench/drivers/<kind>.py``: defines ``Cell``."""
    return _module("drivers", kind, root)


def load_metric(name: str, root: Path = ROOT) -> ModuleType:
    """``portbench/metrics/<name>.py``: defines ``read(ctx)``, which
    returns the metric's value or ``None`` where it finds nothing to
    read."""
    return _module("metrics", name, root)


def cell_metrics(bench: dict, section: str, cell: str) -> List[dict]:
    """The entries of ``bench[section]`` that ``cell`` reports: those
    without ``workloads`` and those that list it."""
    return [m for m in bench.get(section, [])
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    """Modules in this process whose top-level name is JAX's, jaxlib's,
    flax's or the JAX package's, compared whole (``tensorframes_tpu_torch``
    is not ``tensorframes_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


@dataclasses.dataclass
class Request:
    """One request of the window: host-clock submit and done times (s),
    the work it completed (``rows``, ``images``) and whether it failed."""
    start: float
    end: float
    work: Dict[str, float]
    failed: bool = False


@dataclasses.dataclass
class Window:
    start: float
    end: float
    requests: List[Request]

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def done(self) -> List[Request]:
        return [r for r in self.requests if not r.failed]

    def total(self, key: str) -> Optional[float]:
        done = self.done()
        if not done or key not in done[0].work:
            return None
        return float(sum(r.work[key] for r in done))


@dataclasses.dataclass
class Check:
    """One number compared with its limit: ``value <= limit`` passes."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class MetricContext:
    """What a metric's reader sees: the cell's files, the window, the
    set-up time and, in a traced run, the profiler's trace."""
    workload: dict
    config: dict
    window: Window
    setup_s: float
    trace: object = None  # trace.TraceView in a --trace 1 run
