"""ResNet-50 batch inference over a frame's image column.

Set-up makes a host pool of images and the weights from the seed (on the
card, in bulk), builds the port's ``models.ResNet50`` and loads the
weights into it. Each job is a fresh frame of ``blocks`` partitions of
``block_rows`` images, a window of the pool that starts at the request's
``offset``, through ``ResNet50.infer_via_frame(...).blocks()``; its logits
reach the host. After the window a sample of the completed images drawn
from the seed is held against :func:`reference.resnet50_logits`.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from portbench import data, reference, traffic
from portbench.core import Check


def logit_rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """The largest, over images, of ``max |got - want| / max |want|``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    diff = np.abs(got - want).max(axis=1)
    return float((diff / np.abs(want).max(axis=1)).max()) if len(diff) \
        else 0.0


class Cell:
    def __init__(self, config: dict, workload: dict, seed: int,
                 device: torch.device):
        self.cfg = config
        self.wl = workload
        self.seed = int(seed)
        self.device = device
        self.jobs: List[tuple] = []  # (offset, images asked, logits blocks)

    def make_inputs(self) -> None:
        self.pool = data.image_pool(self.cfg, self.seed, self.device)
        self.weights = data.resnet50_weights(self.cfg, self.seed, self.device)

    def setup(self) -> None:
        import tensorframes_tpu_torch as ttf
        from tensorframes_tpu_torch import models
        from tensorframes_tpu_torch.utils.tracing import counters

        self.ttf = ttf
        self.make_inputs()
        self.model = models.ResNet50(num_classes=int(self.cfg["num_classes"]),
                                     device=self.device)
        self.model.load_state_dict(self.weights, strict=True)
        warm = traffic.requests(self.wl["traffic"], self.seed, "warm")
        for _ in range(int(self.wl["traffic"].get("warm_requests", 1))):
            self.job(next(warm)["offset"])
        self.counters = counters
        self.cache_hits0 = counters.get("plan.result_cache_hits")

    def job(self, offset: int) -> List[np.ndarray]:
        job = self.wl["job"]
        n = int(job["blocks"]) * int(job["block_rows"])
        frame = self.ttf.frame({"image": self.pool[offset:offset + n]},
                               num_partitions=int(job["blocks"]))
        return [b.dense("logits")
                for b in self.model.infer_via_frame(frame).blocks()]

    def request(self, p: dict) -> Dict[str, float]:
        logits = self.job(int(p["offset"]))
        job = self.wl["job"]
        self.jobs.append((int(p["offset"]),
                          int(job["blocks"]) * int(job["block_rows"]),
                          logits))
        return {"images": float(sum(len(b) for b in logits))}

    def release(self) -> None:
        self.cache_hits = (self.counters.get("plan.result_cache_hits")
                           - self.cache_hits0)
        self.__dict__.pop("model", None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    def sampled(self):
        """A sample of the completed images drawn from the seed: their
        inputs and the program's logits."""
        rows, got = [], []
        for offset, _, logits in self.jobs:
            cat = np.concatenate(logits)
            rows.append(offset + np.arange(len(cat)))
            got.append(cat)
        rows, got = np.concatenate(rows), np.concatenate(got)
        idx = traffic.sample(self.seed, len(rows),
                             int(self.wl["check"]["sample"]), "check")
        return self.pool[rows[idx]], got[idx]

    def readings(self) -> Dict[str, float]:
        asked = sum(n for _, n, _ in self.jobs)
        got = sum(sum(len(b) for b in logits) for _, _, logits in self.jobs)
        nonfinite = sum(int((~np.isfinite(b)).sum())
                        for _, _, logits in self.jobs for b in logits)
        images, logits = self.sampled()
        ref = reference.resnet50_logits(self.weights, images, self.cfg,
                                        self.device)
        return {"missing_images": float(asked - got),
                "nonfinite_logits": float(nonfinite),
                "logit_rel_err": logit_rel_err(logits, ref),
                "cache_hits": float(self.cache_hits)}

    def check(self) -> List[Check]:
        limits = self.wl["check"]["limits"]
        got = self.readings()
        return [Check(n, got[n], float(limits[n])) for n in limits]

    def control(self) -> Dict[str, float]:
        """The control in the program's place: the reference with TF32
        operands over ``sample`` pool images drawn from the seed, compared
        with the float32 reference as the program's logits are."""
        idx = traffic.sample(self.seed, len(self.pool),
                             int(self.wl["check"]["sample"]), "control")
        images = self.pool[idx]
        ref = reference.resnet50_logits(self.weights, images, self.cfg,
                                        self.device)
        low = reference.resnet50_logits(self.weights, images, self.cfg,
                                        self.device, tf32=True)
        return {"logit_rel_err": logit_rel_err(low, ref)}
