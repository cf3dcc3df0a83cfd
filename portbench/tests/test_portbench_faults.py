"""The harness with the timed path broken underneath: each fault a cell
can have makes ``correct`` come out false. The look for a chip is
skipped (the cells run on the CPU at small sizes)."""

import pytest
import torch

from portbench import run
from portbench.tests.cells import SMALL, cpu_port  # noqa: F401

KEYED = ["tpch_q1"]
RESNET = ["resnet50_b256", "resnet50_b32"]


def broken_sum(kind):
    from tensorframes_tpu_torch.engine import ops
    real = ops._segment_sum

    def bad(values, ids, num_segments):
        if kind == "half":  # half of the rows left out of every sum
            ids = ids.clone()
            ids[ids.shape[0] // 2:] = -1
            return real(values, ids, num_segments)
        out = real(values, ids, num_segments)
        out = out.clone()
        out[0] += 1  # one group's answer altered where it is produced
        return out
    return ops, bad


@pytest.mark.parametrize("kind", ["half", "altered"])
@pytest.mark.parametrize("cell", KEYED)
def test_keyed_faults_are_caught(cell, kind, monkeypatch, cpu_port):
    ops, bad = broken_sum(kind)
    monkeypatch.setattr(ops, "_segment_sum", bad)
    res, _ = run.run_cell(cell, 3, 0.3, False, "cpu", overrides=SMALL[cell])
    assert not res["correct"]
    failed = {k for k, v in res["checks"].items() if v["value"] > v["limit"]}
    assert failed & {"group_mismatch", "sum_rel_err"}, res["checks"]


@pytest.mark.parametrize("kind", ["half", "altered"])
@pytest.mark.parametrize("cell", RESNET)
def test_resnet_faults_are_caught(cell, kind, monkeypatch, cpu_port):
    from tensorframes_tpu_torch.models import resnet
    real = resnet.ResNet50.apply

    def bad(self, images, **kw):
        out = real(self, images, **kw)
        if callable(images):
            return out
        if kind == "half":  # half of the batch left out
            return out[: out.shape[0] // 2]
        out = out.clone()  # every image's answer altered in one logit
        out[:, 0] += 0.01 * out.abs().amax(dim=1)
        return out

    monkeypatch.setattr(resnet.ResNet50, "apply", bad)
    res, _ = run.run_cell(cell, 3, 0.3, False, "cpu", overrides=SMALL[cell])
    assert not res["correct"]
    failed = {k for k, v in res["checks"].items() if v["value"] > v["limit"]}
    assert failed & {"missing_images", "logit_rel_err"}, res["checks"]


@pytest.mark.parametrize("kind", ["skip_one", "swapped"])
@pytest.mark.parametrize("cell", RESNET)
def test_resnet_batch_norm_faults_are_caught(cell, kind, monkeypatch,
                                             cpu_port):
    """A folded batch norm broken in the program: one affine (the last
    block's second) skipped, or every affine's scale and bias swapped."""
    from tensorframes_tpu_torch.models import resnet
    real_forward = resnet._Affine.forward
    real_load = resnet.ResNet50.load_state_dict

    def load_and_mark(self, *a, **k):
        out = real_load(self, *a, **k)
        self.stages[-1][-1].bn2.skipped = True
        return out

    def bad(self, x):
        if kind == "swapped":
            return x * self.bias[:, None, None] + self.scale[:, None, None]
        if getattr(self, "skipped", False):
            return x
        return real_forward(self, x)

    monkeypatch.setattr(resnet.ResNet50, "load_state_dict", load_and_mark)
    monkeypatch.setattr(resnet._Affine, "forward", bad)
    res, _ = run.run_cell(cell, 3, 0.3, False, "cpu", overrides=SMALL[cell])
    assert not res["correct"]
    assert res["checks"]["logit_rel_err"]["value"] > \
        res["checks"]["logit_rel_err"]["limit"], res["checks"]


def test_a_request_that_raises_is_counted_failed(monkeypatch, cpu_port):
    from tensorframes_tpu_torch import parallel

    def boom(*a, **k):
        raise RuntimeError("injected")
    cell = "tpch_q1"
    calls = {"n": 0}
    real = parallel.daggregate

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] > 3:  # after the warm-up
            return boom()
        return real(*a, **k)
    monkeypatch.setattr(parallel, "daggregate", flaky)
    res, _ = run.run_cell(cell, 3, 0.2, False, "cpu", overrides=SMALL[cell])
    assert res["failed"] >= 1 and not res["correct"]
    assert torch.__version__  # the process is still usable
