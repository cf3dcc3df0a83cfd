"""CPU rehearsals of ``chip_smoke.py``'s phases 3l
(``serve_three_tenants_20M``) and 3m (``fabric_three_workers_20M``, which
serves 3l's tenants and so runs after it) at a small size.

The phase runs as on the card, with the card's parts stood in for: a
segment_sum launch is counted for every float segment sum (the CPU runs
the kernel's plain version), the regression drill's queries take 0.3,
0.15 and 0.45 s of host work past their forcing in turn (a served query's
own host work varies), each block's dispatch is slowed by 5 ms so
that a preempt or a cancel lands mid-stream, and the card's memory
watermark is faked for part (d): a running whale holds three blocks until
it is asked to park. The profile of part (i) needs the card and is left
out. The phase writes its parquet file under ``build/data/`` and its
baselines and history under ``build/serve_persist/``, and removes the
latter.
"""

import importlib
import os
import time
import weakref

import numpy as np
import pytest
import torch

import chip_smoke
import tensorframes_tpu_torch as ttf
from tensorframes_tpu_torch import serve
from tensorframes_tpu_torch.engine import executor as engine_executor
from tensorframes_tpu_torch.engine import ops as engine_ops
from tensorframes_tpu_torch.observability import baseline, flight
from tensorframes_tpu_torch.observability import device as obs_device
from tensorframes_tpu_torch.ops import segment_reduce
from tensorframes_tpu_torch.plan import adaptive
from tensorframes_tpu_torch.utils import tracing

BLOCK_ROWS = 5_000  # the whale's rows a block: 40,000 rows in 8


def _rehearse_serve_three_tenants(monkeypatch, out):
    """Phase 3l at the rehearsal's size with the card's parts stood in
    for (module docstring); returns its summary, ``out`` filled."""
    monkeypatch.delenv("TFT_HISTORY_DIR", raising=False)
    monkeypatch.delenv("TFT_PERSIST_DIR", raising=False)
    # the phase runs as in a fresh process: no Computation of its module
    # level programs (etl_z) left over, canonicalized by another test's
    # scheduler, whose interner would short-circuit this run's
    monkeypatch.setattr(engine_ops, "_fetches_comp_cache",
                        weakref.WeakKeyDictionary())
    real_sum = engine_ops._segment_sum

    def counted(values, ids, num_segments):
        if values.is_floating_point():
            segment_reduce.launches += 1
        return real_sum(values, ids, num_segments)

    monkeypatch.setattr(engine_ops, "_segment_sum", counted)
    # the host work a served query does past its plan's forcing varies
    # from query to query (on the card, the aggregate's key
    # factorization); without it a loaded CPU's latency would jitter no
    # more than its forcing, and the drill's most-moved component would be
    # a coin toss between the two. The drill's queries take 0.3, 0.15 and
    # 0.45 s of it in turn: their latency's MAD is 0.15 s whatever the
    # load, and no warm run strays from the median.
    drill_runs = []
    real_note = baseline.note_fingerprint

    def note(fingerprint, portable):
        if (flight.current_query() or "").startswith("drill-"):
            time.sleep((0.3, 0.15, 0.45)[len(drill_runs) % 3])
            drill_runs.append(1)
        real_note(fingerprint, portable)

    monkeypatch.setattr(baseline, "note_fingerprint", note)

    real_launch = engine_executor.BlockExecutor._launch

    def slow_launch(self, *a, **k):
        time.sleep(0.005)
        return real_launch(self, *a, **k)

    monkeypatch.setattr(engine_executor.BlockExecutor, "_launch",
                        slow_launch)
    block_bytes = BLOCK_ROWS * 64 * 4

    def fake_watermark(device=None):
        if device is not None and torch.device(device).type == "cpu":
            return None
        s = serve.live_scheduler()
        live = 0
        if s is not None and s.name == "admit":
            for q in list(s._queries.values()):
                sc = q._scope
                if q.tenant == "etl" and sc is not None \
                        and not sc.preempt_requested:
                    live = 3 * block_bytes
        return {"live_bytes": live, "peak_bytes": live,
                "limit_bytes": 1 << 40, "devices": 1}

    monkeypatch.setattr(obs_device, "watermark", fake_watermark)
    with adaptive._fb_lock:
        adaptive._feedback.clear()
    return chip_smoke.phase_serve_three_tenants(
        ttf, np, torch, segment_reduce, n=40_000, parts=8, keys=1000,
        groups=20, ssb_rows=60_000, whale_rows=8 * BLOCK_ROWS,
        whale_parts=8, preempt_parts=40, child_small=20_000,
        device="cpu", profile=False, out=out)


def _restore(monkeypatch, prev):
    tracing.disable()
    ttf.set_default_device(prev)
    serve.shutdown_default_scheduler()
    # the memory ledger resolved under the fake watermark: resolve it
    # again against the real devices for the tests after this one
    monkeypatch.undo()
    ttf.memory._reset()
    ttf.memory.active()


def _parts(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"part"')]
    return [ln.split('"', 4)[3] for ln in lines]


def test_phase_serve_three_tenants_rehearsal(monkeypatch, capsys):
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    tracing.enable()
    out = {}
    try:
        summary = _rehearse_serve_three_tenants(monkeypatch, out)
    finally:
        _restore(monkeypatch, prev)
    parts = _parts(capsys)
    assert parts == ["3l_serial", "3l_a_mix", "3l_f_slo", "3l_b_rejections",
                     "3l_c_priority_preempt", "3l_d_admission",
                     "3l_e_regression_drill", "3l_h_reports",
                     "3l_g_history"], parts
    assert summary["total_s"] > 0 and "child_launches" in out
    root = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    assert not os.path.exists(os.path.join(root, "build", "serve_persist"))


def test_phase_fabric_three_workers_rehearsal(monkeypatch, capsys):
    """Phase 3m after phase 3l, both at the rehearsal's size: the fabric
    serves 3l's tenants, loses the etl's worker after 10 of its 40 blocks,
    restarts every worker and runs the chaos drill. The drill's card-bytes
    checks read nothing on the CPU."""
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    tracing.enable()
    out = {}
    try:
        _rehearse_serve_three_tenants(monkeypatch, out)
        launches0 = segment_reduce.launches
        summary = chip_smoke.phase_fabric_three_workers(
            ttf, np, torch, segment_reduce, out, small_rows=20_000,
            crash_after=10, device="cpu")
        launched = segment_reduce.launches - launches0
    finally:
        _restore(monkeypatch, prev)
    parts = _parts(capsys)
    assert parts[-6:] == ["3m_a_mix", "3m_b_worker_lost",
                          "3m_c_rolling_restart", "3m_d_chaos_drill",
                          "3m_e_fabric_off", "3m_counters"], parts
    assert summary["total_s"] > 0 and launched > 0
    root = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    for d in ("fabric_persist", "chaos_persist", "serve_persist"):
        assert not os.path.exists(os.path.join(root, "build", d)), d
