"""The kernel build's lock (``tensorframes_tpu_torch/ops/_build.py``).

Threads that reach a kernel's first use together (the serving scheduler's
workers) must run one ``nvcc`` per source and share one library handle;
two builds must never write the same temporary file. A fake ``nvcc`` on
``PATH`` counts its runs and writes a stub, and ``ctypes.CDLL`` is
replaced by a recorder, so the test runs on a machine with no CUDA.
"""

import os
import stat
import threading

import pytest

from tensorframes_tpu_torch.ops import _build

FAKE_NVCC = """#!/bin/sh
echo run >> "{log}"
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
echo "$out" >> "{outs}"
sleep 0.3
printf stub > "$out"
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log, outs = tmp_path / "runs.log", tmp_path / "outs.log"
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log, outs=outs))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}"
                       f"{os.environ.get('PATH', '')}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_loaded", {})
    opened = []

    class FakeCDLL:
        def __init__(self, path):
            opened.append(path)
            self.path = path

    monkeypatch.setattr(_build.ctypes, "CDLL", FakeCDLL)
    return log, outs, opened


def _runs(path):
    return path.read_text().splitlines() if path.exists() else []


def test_concurrent_first_use_runs_one_nvcc_and_shares_one_handle(
        fake_toolchain):
    log, outs, opened = fake_toolchain
    barrier = threading.Barrier(8)
    handles, errors = [], []

    def first_use():
        try:
            barrier.wait()
            handles.append(_build.load("segment_sum"))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert errors == []
    assert len(_runs(log)) == 1
    assert len(handles) == 8 and len({id(h) for h in handles}) == 1
    assert len(opened) == 1
    lib = _build._library_path("segment_sum")
    assert lib.read_text() == "stub"
    assert not list(lib.parent.glob("*.tmp"))


def test_two_sources_build_together_with_distinct_temporaries(
        fake_toolchain):
    log, outs, _ = fake_toolchain
    libs = _build.build("segment_sum", "flash_attention")
    assert set(libs) == {"segment_sum", "flash_attention"}
    assert len(_runs(log)) == 2
    tmps = _runs(outs)
    assert len(set(tmps)) == 2
    pid_thread = f".{os.getpid()}.{threading.get_ident()}.tmp"
    assert all(t.endswith(pid_thread) for t in tmps)
    # built once: a second call loads from the cache, no new nvcc
    assert _build.build("segment_sum")["segment_sum"] is \
        libs["segment_sum"]
    assert len(_runs(log)) == 2
