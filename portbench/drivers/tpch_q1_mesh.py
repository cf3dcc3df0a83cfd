"""TPC-H's Q1 through the port's parallel layer, keys on the device.

Set-up makes the ``LINEITEM`` columns that Q1 reads from the seed
(:func:`data.lineitem`), frames them in the configuration's partitions
and distributes the frame once onto ``parallel.local_mesh()`` (the card's
one-shard mesh). Each query is Q1 with its own ``delta``:
``dfilter(l_shipdate <= 1998-12-01 - delta)`` -> ``dmap_blocks`` (the
discounted price, the charge and a count of one a row) ->
``daggregate`` of the five sums and the count by ``(l_returnflag,
l_linestatus)`` with ``max_groups``, whose group ids are built on the
card for every query's kept rows. Q1's averages are its sums over the
count, on the host.

A sample of the completed queries drawn from the seed (a reservoir, so
the window keeps ``sample`` answers, not thousands) is held against
:func:`reference.tpch_q1` after the window.
"""

from __future__ import annotations

import gc
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import data, reference, traffic
from portbench.core import Check

KEYS = ["l_returnflag", "l_linestatus"]
SUMMED = {"sum_qty": "l_quantity", "sum_base_price": "l_extendedprice",
          "sum_disc_price": "disc_price", "sum_charge": "charge",
          "sum_disc": "l_discount"}


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """The largest ``|got - want| / |want|`` (0 where both are 0)."""
    got = np.asarray(got, np.float64)
    diff = np.abs(got - want)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(diff == 0, 0.0, diff / np.abs(want))
    return float(rel.max()) if rel.size else 0.0


def compare(results: List[Tuple[dict, Dict[str, np.ndarray]]],
            cols: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers compared over ``results`` (``(params, answer)``):
    ``group_mismatch``, the answers whose groups, their order or their
    counts are not the reference's, and ``sum_rel_err``, the largest
    relative error of a group's sum among the others."""
    mismatch, worst = 0, 0.0
    for p, got in results:
        want = reference.tpch_q1(cols, p["delta"])
        same = all(len(got[k]) == len(want[k])
                   and np.array_equal(got[k], want[k])
                   for k in KEYS + ["count_order"])
        if not same:
            mismatch += 1
            continue
        for k in reference.Q1_SUMS:
            worst = max(worst, rel_err(got[k], want[k]))
    return {"group_mismatch": float(mismatch), "sum_rel_err": worst}


class Cell:
    def __init__(self, config: dict, workload: dict, seed: int,
                 device: torch.device):
        self.cfg = config
        self.wl = workload
        self.seed = int(seed)
        self.device = device
        self.results: List[Tuple[dict, Dict[str, np.ndarray]]] = []
        self.done = 0
        self.reservoir = traffic.stream(self.seed, "reservoir", "check")

    def make_inputs(self) -> None:
        self.cols = data.lineitem(self.cfg, self.seed, self.device)
        self.rows = len(self.cols["l_shipdate"])

    def setup(self) -> None:
        import tensorframes_tpu_torch as ttf
        from tensorframes_tpu_torch import parallel
        from tensorframes_tpu_torch.utils.tracing import counters

        self.make_inputs()
        frame = ttf.frame(self.cols,
                          num_partitions=int(self.cfg["partitions"]))
        self.mesh = parallel.local_mesh()
        self.dist = parallel.distribute(frame, self.mesh)
        warm = traffic.requests(self.wl["traffic"], self.seed, "warm")
        for _ in range(int(self.wl["traffic"].get("warm_requests", 1))):
            self.query(next(warm)["delta"])
        self.counters = counters
        self.cache_hits0 = counters.get("plan.result_cache_hits")

    def query(self, delta: int) -> Dict[str, np.ndarray]:
        """One Q1 through the port: its groups, counts and sums."""
        from tensorframes_tpu_torch import parallel

        cutoff = reference.q1_cutoff(delta)
        kept = parallel.dfilter(lambda l_shipdate: l_shipdate <= cutoff,
                                self.dist)
        priced = parallel.dmap_blocks(
            lambda l_extendedprice, l_discount, l_tax: {
                "disc_price": l_extendedprice * (1 - l_discount),
                "charge": l_extendedprice * (1 - l_discount) * (1 + l_tax),
                "count_order": torch.ones_like(l_tax, dtype=torch.int64)},
            kept)
        fetches = {c: "sum" for c in list(SUMMED.values()) + ["count_order"]}
        out = parallel.daggregate(fetches, priced.select(KEYS + sorted(fetches)),
                                  KEYS, max_groups=int(self.wl["max_groups"]))
        cols = out.blocks()[0].columns
        got = {k: np.asarray(cols[k]) for k in KEYS + ["count_order"]}
        got.update({k: np.asarray(cols[c]) for k, c in SUMMED.items()})
        return got

    def request(self, p: dict) -> Dict[str, float]:
        out = self.query(p["delta"])
        k = int(self.wl["check"]["sample"])
        if self.done < k:
            self.results.append((p, out))
        else:
            j = int(self.reservoir.integers(0, self.done + 1))
            if j < k:
                self.results[j] = (p, out)
        self.done += 1
        return {"rows": float(self.rows)}

    def release(self) -> None:
        self.cache_hits = (self.counters.get("plan.result_cache_hits")
                           - self.cache_hits0)
        for name in ("dist", "mesh"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    def device_columns(self) -> Dict[str, torch.Tensor]:
        """The harness's own columns on the device, for the reference."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.cols.items()}

    def readings(self) -> Dict[str, float]:
        got = compare(self.results, self.device_columns())
        got["cache_hits"] = float(self.cache_hits)
        return got

    def check(self) -> List[Check]:
        limits = self.wl["check"]["limits"]
        got = self.readings()
        return [Check(n, got[n], float(limits[n])) for n in limits]

    def control(self) -> Dict[str, float]:
        """The control in the program's place: Q1 in float32 over the
        window's first ``sample`` queries of this seed, compared as the
        program's answers are."""
        cols = self.device_columns()
        params = traffic.requests(self.wl["traffic"], self.seed)
        results = []
        for _ in range(int(self.wl["check"]["sample"])):
            p = next(params)
            results.append((p, reference.tpch_q1(cols, p["delta"],
                                                 torch.float32)))
        return compare(results, cols)
