#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's file (``portbench/workloads/<cell>.json``) names its
configuration and driver. Set-up (imports, CUDA, data and weights from the
seed, the program's state, the cell's own shapes warmed) is timed from the
start of this script to the first timed request. The window is one
client's closed loop: each request is sent when the one before it has
completed; the window closes with the first request to complete after
``--seconds``, so it holds every request it starts. With ``--trace 1`` the
window lasts the cell's ``trace_seconds`` at most, under
``torch.profiler`` with the port's spans on, and the line carries the
per-layer metrics; with ``--trace 0`` the end-to-end ones. After the
window the program's state is freed and a sample of its answers is held
against the plain reference; the numbers compared, each with its limit,
are the line's last key and the last lines on standard error.

Exit codes: 0 with a result line (``correct`` says whether the answers
held); 1 when the run failed; 3 when there is no CUDA card or fewer than
the cell asks for; 4 when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed place inside the checkout
_CACHE = ROOT / "build" / "portbench"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(_CACHE / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402
from portbench import trace as trace_mod  # noqa: E402
from portbench import traffic  # noqa: E402


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def _power_limit() -> str:
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return got.stdout.strip().splitlines()[0] if got.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def window_loop(cell, params, seconds: float) -> core.Window:
    requests = []
    t0 = time.perf_counter()
    reported = False
    while True:
        p = next(params)
        s = time.perf_counter()
        failed, work = False, {}
        try:
            work = cell.request(p)
        except Exception:  # a failed request is counted, not fatal
            failed = True
            if not reported:
                traceback.print_exc()
                reported = True
        e = time.perf_counter()
        requests.append(core.Request(s, e, work, failed))
        if e - t0 >= seconds:
            return core.Window(t0, e, requests)


def make_cell(workload: str, seed: int, device, root: Path = ROOT,
              overrides: dict = None):
    """The cell's driver object, its configuration and its workload, the
    port's default device and the configuration's precision flags set.
    ``overrides``: ``{"config": {...}, "workload": {...}}`` merged over
    the cell's files (the tests' small sizes)."""
    import torch
    import tensorframes_tpu_torch as ttf

    overrides = overrides or {}
    wl = _merge(core.load_workload(workload, root),
                overrides.get("workload", {}))
    cfg = _merge(core.load_config(wl["config"], root),
                 overrides.get("config", {}))
    dev = torch.device(device)
    ttf.set_default_device(dev)
    if "tf32" in cfg:
        torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    cell = core.load_driver(wl["driver"], root).Cell(cfg, wl, seed, dev)
    return cell, cfg, wl


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str, root: Path = ROOT, overrides: dict = None,
             t_start: float = None):
    """Run one cell on ``device``; returns ``(result, checks)``."""
    import torch
    from tensorframes_tpu_torch.utils import tracing

    t_start = T_START if t_start is None else t_start
    bench = core.load_benchmark(root)
    cell, cfg, wl = make_cell(workload, seed, device, root, overrides)
    dev = cell.device
    if dev.type == "cuda":
        torch.cuda.init()
    t_ready = time.perf_counter()
    section = "per_layer" if trace else "end_to_end"
    metrics = core.cell_metrics(bench, section, workload)
    readers = {m["name"]: core.load_metric(m["name"], root) for m in metrics}

    cell.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    params = traffic.requests(wl["traffic"], seed)
    view = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        length = min(seconds, float(wl.get("trace_seconds", seconds)))
        tracing.enable()
        with profile(activities=acts, record_shapes=True) as prof:
            with record_function(trace_mod.WINDOW):
                window = window_loop(cell, params, length)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        tracing.disable()
        ops = sorted({op for r in readers.values()
                      for op in getattr(r, "OPS", ())})
        view = trace_mod.TraceView(prof.events(), op_names=ops)
        del prof
    else:
        window = window_loop(cell, params, seconds)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    ctx = core.MetricContext(workload=wl, config=cfg, window=window,
                             setup_s=setup_s, trace=view)
    out_metrics = {}
    for m in metrics:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            out_metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}

    cell.release()
    gc.collect()
    checks = cell.check()
    failed = sum(r.failed for r in window.requests)
    correct = (failed == 0 and bool(window.done())
               and all(c.ok for c in checks))
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": int(wl.get("chips", 1)),
            "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        info["card"] = _power_limit()
    result = {"correct": correct, "attempted": len(window.requests),
              "failed": int(failed), "metrics": out_metrics, "device": info,
              # set-up in two parts: imports and CUDA, then the cell's own
              "setup_parts": {"imports_s": t_ready - t_start,
                              "cell_s": setup_s - (t_ready - t_start)},
              "window_s": window.seconds}
    if view is not None:
        info["busy_s"] = view.busy_s()
        info["window_s"] = view.window_s
        result["breakdown"] = {"device_ops": view.device_ops(),
                               "idle_gaps": view.idle_gaps()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    chips = int(core.load_workload(args.workload).get("chips", 1))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    try:
        result, checks = run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda")
    except Exception:
        traceback.print_exc()
        return 1
    loaded = core.forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
