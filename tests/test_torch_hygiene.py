"""The port stands alone: it imports neither ``jax`` nor any module of
``tensorframes_tpu``, and it never carries on quietly on the CPU when the
GPU it runs on by default is missing."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as ttf

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tensorframes_tpu_torch"


def test_imports_and_runs_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "import tensorframes_tpu_torch as ttf\n"
        "ttf.set_default_device('cpu')\n"
        "df = ttf.frame({'x': np.arange(10.0)})\n"
        "rows = ttf.map_blocks(lambda x: {'z': x + 3.0}, df).collect()\n"
        "assert [r['z'] for r in rows] == [i + 3.0 for i in range(10)]\n"
        "from tensorframes_tpu_torch.models import (TransformerConfig,\n"
        "                                           TransformerLM)\n"
        "cfg = TransformerConfig(vocab_size=16, d_model=8, n_heads=2,\n"
        "                        n_layers=1, d_ff=16)\n"
        "lm = TransformerLM(cfg, device='cpu')\n"
        "assert tuple(lm.apply(np.zeros((1, 3), np.int64)).shape) == \\\n"
        "    (1, 3, 16)\n"
        "assert tuple(lm.generate(np.zeros((1, 3), np.int64), 2).shape) == \\\n"
        "    (1, 5)\n"
        "import os, tempfile\n"
        "path = os.path.join(tempfile.mkdtemp(), 't.parquet')\n"
        "ttf.write_parquet(ttf.frame({'x': np.arange(8.0), 'y': np.ones(8),\n"
        "                             'ts': np.arange(8)}, num_partitions=2),\n"
        "                  path)\n"
        "scan = ttf.read_parquet(path)\n"
        "with ttf.dsl.with_graph():\n"
        "    z = (ttf.block(scan, 'x') + ttf.block(scan, 'y')).named('z')\n"
        "chain = (scan.map_blocks(z).filter(lambda ts: ts >= 4)\n"
        "         .map_rows(lambda z: {'w': z * 2.0}).select(['w']))\n"
        "assert [r['w'] for r in chain.collect()] == [10.0, 12.0, 14.0, 16.0]\n"
        "assert chain._plan_info, 'the chain did not fuse'\n"
        "from tensorframes_tpu_torch import observability, resilience\n"
        "from tensorframes_tpu_torch.utils import tracing\n"
        "tracing.enable()\n"
        "rows = ttf.frame({'x': np.arange(16.0)}).map_rows(\n"
        "    lambda x: {'y': x * 2.0})\n"
        "with resilience.faults.inject('oom', fail_n=2):\n"
        "    assert [r['y'] for r in rows.collect()] == \\\n"
        "        [2.0 * i for i in range(16)]\n"
        "t = observability.last_query()\n"
        "assert t.count('oom_split') == 2, t.events\n"
        "assert len(observability.flight.for_query(t.query_id)) == 2\n"
        "assert resilience.is_oom(MemoryError())\n"
        "from tensorframes_tpu_torch import memory\n"
        "from tensorframes_tpu_torch.engine import preempt\n"
        "from tensorframes_tpu_torch.utils.tracing import counters\n"
        "memory.configure(limit_bytes=4096)\n"
        "big = ttf.frame({'x': np.arange(1024.0)}).map_rows(\n"
        "    lambda x: {'y': x + 1.0})\n"
        "assert [r['y'] for r in big.collect()][-1] == 1024.0\n"
        "assert counters.get('memory.proactive_splits') == 3\n"
        "memory.configure(limit_bytes=0)\n"
        "four = ttf.frame({'x': np.arange(8.0)}, num_partitions=4)\n"
        "four = four.map_rows(lambda x: {'y': x * 2.0})\n"
        "sc = preempt.PreemptionScope('q')\n"
        "resilience.faults.arm('preempt', 1)\n"
        "try:\n"
        "    with preempt.activate(sc):\n"
        "        four.blocks()\n"
        "    raise AssertionError('no park')\n"
        "except resilience.QueryPreempted:\n"
        "    pass\n"
        "with preempt.activate(sc):\n"
        "    assert [r['y'] for r in four.collect()] == \\\n"
        "        [2.0 * i for i in range(8)]\n"
        "assert counters.get('pipeline.resumed_blocks') == 1\n"
        "from tensorframes_tpu_torch import stream\n"
        "from tensorframes_tpu_torch.observability import metrics\n"
        "def gen():\n"
        "    for i in range(12):\n"
        "        yield {'k': np.arange(4) % 2, 'v': np.arange(4.0) + i,\n"
        "               'ts': np.full(4, float(i))}\n"
        "h = (stream.from_source(stream.GeneratorSource(gen()))\n"
        "     .group_by('k').aggregate({'v': 'sum'},\n"
        "                              window=stream.tumbling(4.0),\n"
        "                              time_col='ts', watermark_delay=1.0)\n"
        "     .start(name='hyg'))\n"
        "h.run()\n"
        "sums = [float(f.blocks()[0].columns['v'].sum())\n"
        "        for f in h.collect_updates()]\n"
        "assert sums == [48.0, 112.0, 176.0], sums\n"
        "assert 'tft_stream_batches_total{stream=\"hyg\"} 12' in \\\n"
        "    metrics.metrics_text()\n"
        "from tensorframes_tpu_torch import builder, serve\n"
        "from tensorframes_tpu_torch.engine import executor\n"
        "blob = ttf.Computation.trace(lambda x: {'z': x * 2.0},\n"
        "    [ttf.TensorSpec('x', ttf.dtypes.double, ttf.Shape(-1))])\\\n"
        "    .serialize()\n"
        "cache = serve.SharedCompileCache()\n"
        "executor.set_computation_interner(cache.intern)\n"
        "for _ in range(2):\n"
        "    shipped = builder.map_blocks_builder(\n"
        "        ttf.frame({'x': np.arange(4.0)})).graph(blob).build()\n"
        "    assert [r['z'] for r in shipped.collect()] == \\\n"
        "        [0.0, 2.0, 4.0, 6.0]\n"
        "executor.set_computation_interner(None)\n"
        "assert cache.stats()['hits'] == 1, cache.stats()\n"
        "assert sys.modules['jax'] is None\n"
        "bad = [k for k in sys.modules if k == 'tensorframes_tpu'\n"
        "       or k.startswith('tensorframes_tpu.') or k.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_imports_in_port_sources():
    files = sorted(PORT.rglob("*.py"))
    names = {str(f.relative_to(PORT)) for f in files}
    assert {"io.py", "dsl/__init__.py", "dsl/graph.py", "dsl/lower.py",
            "memory/estimate.py", "plan/__init__.py", "plan/nodes.py",
            "plan/predicates.py", "plan/optimize.py",
            "plan/execute.py", "resilience/__init__.py",
            "resilience/classify.py", "resilience/faults.py",
            "resilience/policy.py", "observability/__init__.py",
            "observability/events.py", "observability/flight.py",
            "observability/device.py", "memory/__init__.py",
            "memory/spill.py", "memory/manager.py", "memory/checkpoint.py",
            "memory/persist.py", "engine/preempt.py",
            "resilience/invariants.py", "observability/metrics.py",
            "observability/timeline.py", "stream/__init__.py",
            "stream/source.py", "stream/frame.py", "stream/aggregate.py",
            "stream/runtime.py", "stream/sink.py", "builder.py",
            "serve/__init__.py", "serve/cache.py", "plan/adaptive.py",
            "demos/__init__.py", "demos/kmeans.py", "demos/geom_mean.py",
            "demos/groupby_scratch.py", "native.py", "parallel/__init__.py",
            "parallel/mesh.py", "parallel/collectives.py",
            "parallel/elastic.py", "parallel/distributed.py",
            "parallel/exchange.py", "plan/dist.py", "parallel/cluster.py",
            "demos/analytics.py"} <= names
    offenders = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "ml_dtypes", "tensorframes_tpu"):
                offenders.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not offenders, offenders


def test_chip_smoke_rank_children_import_only_the_port():
    """The cluster phase's rank processes (``chip_smoke.CLUSTER_RANK``)
    import torch, numpy, the standard library and the port only."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    tree = ast.parse(chip_smoke.CLUSTER_RANK)
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    third_party = mods - set(sys.stdlib_module_names)
    assert third_party == {"numpy", "torch", "tensorframes_tpu_torch"}, \
        third_party


def test_demos_and_adaptive_run_without_jax():
    """The ported demos and the adaptive layer import and run in a
    process where ``jax`` cannot be imported."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import tensorframes_tpu_torch as ttf\n"
        "ttf.set_default_device('cpu')\n"
        "from tensorframes_tpu_torch.demos import (geom_mean,\n"
        "                                          groupby_scratch, kmeans)\n"
        "df, init, _ = kmeans.make_data(n=40, num_features=2, k=2,\n"
        "                               num_partitions=2)\n"
        "for step in (kmeans.step_aggregate, kmeans.step_preaggregate):\n"
        "    c, d = step(df, init)\n"
        "    assert c.shape == (2, 2) and d > 0\n"
        "import os\n"
        "os.environ['TFT_CPU_DEVICE_COUNT'] = '4'\n"
        "from tensorframes_tpu_torch import native, parallel\n"
        "dist = parallel.distribute(df, parallel.local_mesh())\n"
        "assert dist.mesh.num_data_shards == 4\n"
        "for step in (kmeans.step_device_resident, kmeans.step_daggregate):\n"
        "    c, d = step(dist, init)\n"
        "    assert c.shape == (2, 2) and d > 0\n"
        "import numpy as np\n"
        "from tensorframes_tpu_torch.resilience import faults\n"
        "xd = parallel.distribute(ttf.frame({'x': np.arange(8.0)}),\n"
        "                         parallel.local_mesh())\n"
        "with faults.inject('device', 1):\n"
        "    lost = parallel.dmap_blocks(lambda x: {'z': x + 1.0}, xd)\n"
        "assert lost.mesh.num_data_shards == 3\n"
        "lz = parallel.dmap_blocks(lambda x: {'z': x * 2.0}, xd.lazy())\n"
        "assert float(parallel.dreduce_blocks({'z': 'sum'}, lz)['z']) \\\n"
        "    == 56.0\n"
        "a = np.arange(100_000)\n"
        "assert (native.convert(a, np.float32) == a).all()\n"
        "assert len(geom_mean.geometric_mean_per_key(\n"
        "    geom_mean.make_data(n=9)).collect()) == 3\n"
        "assert len(groupby_scratch.groupby_sum()) == 2\n"
        "from tensorframes_tpu_torch.plan import adaptive\n"
        "assert adaptive.enabled() and adaptive.result_cache_enabled()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_no_port_file_names_the_jax_packages_native_directory():
    """The port builds its host runtime from its own ``csrc/`` and never
    reads ``native/``, which belongs to the JAX package."""
    import re

    files = [f for f in sorted(PORT.rglob("*")) if f.is_file()
             and f.suffix in (".py", ".cpp", ".cu", ".h")]
    files.append(ROOT / "chip_smoke.py")
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if re.search(r"\bnative/", f.read_text())]
    assert not offenders, offenders
    from tensorframes_tpu_torch import native
    from tensorframes_tpu_torch.ops import _build
    if native.available():
        loaded = Path(native._load()._name).resolve()
        assert loaded.parent == _build.BUILD_DIR.resolve(), loaded
        assert loaded.name.startswith("libhost_runtime-")


def test_first_dispatch_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = ttf.default_device()
    ttf.set_default_device("cuda")
    try:
        df = ttf.frame({"x": np.arange(4.0), "k": np.arange(4)})
        lazy = ttf.map_blocks(lambda x: {"z": x + 3.0}, df)  # no dispatch yet
        with pytest.raises(RuntimeError, match="no GPU"):
            lazy.collect()
        with pytest.raises(RuntimeError, match="no GPU"):
            ttf.aggregate({"x": "sum"}, df.group_by("k"))
        with pytest.raises(RuntimeError, match="no GPU"):
            ttf.reduce_blocks(lambda x_input: {"x": x_input.sum(0)},
                              df.select(["x"]))
    finally:
        ttf.set_default_device(prev)


def test_stream_fold_never_falls_back_to_the_cpu(monkeypatch):
    """A stream on the default CUDA device without a GPU: every batch's
    failure is counted as a skipped batch and nothing is emitted, and with
    ``TFT_STREAM_FAIL_FAST=1`` the error raises; no fold ever runs on the
    host instead."""
    from tensorframes_tpu_torch import stream

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = ttf.default_device()
    ttf.set_default_device("cuda")

    def agg():
        return (stream.from_source(stream.GeneratorSource(
            {"k": np.arange(4) % 2, "v": np.arange(4.0),
             "ts": np.full(4, float(i))} for i in range(2)))
            .group_by("k").aggregate({"v": "sum"},
                                     window=stream.tumbling(4.0),
                                     time_col="ts"))

    try:
        h = agg().start()
        h.run()
        assert h.metrics()["batches_skipped"] == 2
        assert h.metrics()["batches"] == 0
        assert h.collect_updates() == []
        monkeypatch.setenv("TFT_STREAM_FAIL_FAST", "1")
        with pytest.raises(RuntimeError, match="no GPU"):
            agg().start().run()
    finally:
        ttf.set_default_device(prev)


def test_chip_smoke_refuses_to_run_without_gpu(tmp_path):
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:  # the script alone, without the package
            (tmp_path / "chip_smoke.py").write_text(
                (ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(cwd),
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_device_memory_reads_the_card_or_nothing(monkeypatch):
    """``observability/device.py`` reads only the card's allocator: with
    no CUDA, or a card the process has not touched, it reports ``None``,
    never a host reading in its place."""
    from tensorframes_tpu_torch.observability import device as obs_device

    src = (PORT / "observability" / "device.py").read_text()
    for host_probe in ("psutil", "resource", "/proc/", "os.sysconf"):
        assert host_probe not in src, host_probe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obs_device._reset()
    try:
        assert obs_device.watermark() is None
        assert not obs_device.supported()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setattr(torch.cuda, "memory_stats", lambda i=None: {})
        obs_device._reset()
        assert obs_device.watermark() is None
        assert obs_device.supported()
    finally:
        obs_device._reset()
