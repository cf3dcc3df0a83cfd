#!/usr/bin/env python3
"""The readings that set the limits of ``correct``, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --program-seeds 11 12 ... --control-seeds 101 102 103

For each program seed, the cell is set up as a run sets it up, its closed
loop runs ``--seconds``, and the numbers a run compares are read (the
lower readings). For each control seed, the control takes the program's
place: the plain reference in the precision below the configuration's
(float32 for float64, TF32 operands for float32 with TF32 off) over the
same inputs, compared as the program's answers are (the upper readings).
One JSON line per seed, then one with the largest program reading and the
smallest control reading of each number. All seeds run in one process, so
the set-up of imports and CUDA is paid once.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run, traffic  # noqa: E402


def _free(device) -> None:
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def program_readings(workload: str, seed: int, seconds: float, device,
                     overrides: dict = None) -> dict:
    """The numbers a run of ``seed`` compares, after a window of
    ``seconds``."""
    cell, _, wl = run.make_cell(workload, seed, device, overrides=overrides)
    cell.setup()
    window = run.window_loop(cell, traffic.requests(wl["traffic"], seed),
                             seconds)
    cell.release()
    got = cell.readings()
    got["requests"] = len(window.requests)
    got["failed"] = sum(r.failed for r in window.requests)
    del cell
    _free(device)
    return got


def control_readings(workload: str, seed: int, device,
                     overrides: dict = None) -> dict:
    """The control's readings on the inputs of ``seed``."""
    cell, _, _ = run.make_cell(workload, seed, device, overrides=overrides)
    cell.make_inputs()
    got = cell.control()
    del cell
    _free(device)
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    out = open(args.out, "a") if args.out else None
    lower, upper = {}, {}

    def emit(line: dict) -> None:
        text = json.dumps(line)
        print(text, flush=True)
        if out is not None:
            out.write(text + "\n")
            out.flush()

    try:
        for seed in args.program_seeds:
            t0 = time.perf_counter()
            got = program_readings(args.workload, seed, args.seconds,
                                   "cuda")
            emit({"workload": args.workload, "role": "program", "seed": seed,
                  "readings": got, "seconds": time.perf_counter() - t0})
            for k, v in got.items():
                lower[k] = max(lower.get(k, v), v)
        for seed in args.control_seeds:
            t0 = time.perf_counter()
            got = control_readings(args.workload, seed, "cuda")
            emit({"workload": args.workload, "role": "control", "seed": seed,
                  "readings": got, "seconds": time.perf_counter() - t0})
            for k, v in got.items():
                upper[k] = min(upper.get(k, v), v)
        emit({"workload": args.workload, "lower": lower, "upper": upper})
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
