"""CPU rehearsal of ``chip_smoke.py``'s phase 5f (``transformer_mesh_8x2048``)
at a small size.

The phase runs as on the card, on meshes of CPU slots, with the card's
parts stood in for: a B2 launch is counted for every call of its plain
version through the op (and of the plain backward), ``time_ms`` is a host
timer, and the ``torch.cuda`` memory calls are stubbed. Every check of the
phase runs: the ring against B2's plain version and the allreduce against
the sum, each layout's step-0 loss and gradients against the one-device
step's and its launch counts, the MoE's dropped tokens at two capacity
factors, the pipeline, the logistic regression's mesh step and the
``train_lm`` demo's resume.
"""

import importlib
import time

import numpy as np
import pytest
import torch

import chip_smoke
import tensorframes_tpu_torch as ttf
from tensorframes_tpu_torch import models
from tensorframes_tpu_torch.utils import tracing

fa = importlib.import_module("tensorframes_tpu_torch.ops.flash_attention")
fab = importlib.import_module(
    "tensorframes_tpu_torch.ops.flash_attention_backward")

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=6, d_ff=64)


@pytest.fixture
def rehearsal(monkeypatch):
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    plain, plain_bwd = fa.flash_attention_reference, \
        fab.flash_attention_backward_reference

    def counted(*a, **kw):
        fa.launches += 1
        return plain(*a, **kw)

    def counted_bwd(*a, **kw):
        fab.launches += 1
        return plain_bwd(*a, **kw)

    def host_ms(torch_, fn, reps, flush):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    monkeypatch.setattr(fa, "flash_attention_reference", counted)
    monkeypatch.setattr(fab, "flash_attention_backward_reference",
                        counted_bwd)
    monkeypatch.setattr(chip_smoke, "time_ms", host_ms)
    emitted = []
    monkeypatch.setattr(chip_smoke, "emit", emitted.append)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    tracing.enable()
    try:
        yield emitted
    finally:
        tracing.disable()
        ttf.set_default_device(prev)


def test_phase_transformer_mesh_rehearsal(rehearsal):
    before = (fa.launches, fab.launches)
    info = chip_smoke.phase_transformer_mesh(
        np, torch, fa, fab, models, batch=8, seq=16, steps=3, lr=1e-2,
        cfg=models.TransformerConfig(**SMALL),
        moe_cfg=models.TransformerConfig(**dict(SMALL, n_layers=3),
                                         num_experts=8),
        logreg_rows=4096, logreg_features=16, demo_steps=(4, 6, 2),
        ring_elems=1000, device="cpu")
    parts = {e["part"]: e for e in rehearsal}
    assert sorted(parts) == info["parts"] == [
        "a_ring", "b_dense", "c_moe", "d_pipeline", "e_logreg",
        "f_train_lm_demo"]
    layouts = parts["b_dense"]["layouts"]
    assert [x["b2_per_step"] for x in layouts] == [48, 48, 0]
    assert [x["b2_launches"] for x in layouts] == [4 * 48, 4 * 48, 0]
    for x in layouts:
        assert x["losses"][-1] < x["losses"][0]
        assert x["step0_grad_max_rel_err"] <= 1e-4
    moe = parts["c_moe"]["by_capacity_factor"]
    assert moe["0.5"]["dropped_tokens"] > moe["1.25"]["dropped_tokens"]
    assert moe["0.5"]["layer0_switch_dropped"] > 0
    assert parts["d_pipeline"]["b2_per_step"] == 4 * 2 * 6
    assert [c["hops"] for c in parts["a_ring"]["collectives"]] == [8, 8, 14]
    assert info["compare_launches"]["flash_attention"] == 1 + 4
    # the forward and backward counts the phase itself held
    assert fa.launches - before[0] > 0 and fab.launches - before[1] > 0
