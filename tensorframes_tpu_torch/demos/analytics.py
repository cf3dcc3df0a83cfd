"""End-to-end analytics pipeline: IO -> relational ops -> mesh -> report,
the port of ``demos/analytics.py``:

  read_csv -> analyze -> filter -> distribute -> daggregate (composite
  device-side keys) -> order_by -> show

Workload: per-sensor statistics over a synthetic readings table — drop
error-code rows, sum values per (site, sensor) on the mesh (the float sum
through the ``segment_sum`` kernel on every shard), rank the groups by
total on the host (daggregate returns a host frame).

Run:  python -m tensorframes_tpu_torch.demos.analytics
(on the default device; ``TFT_CPU_DEVICE_COUNT=8`` and
``ttf.set_default_device("cpu")`` give 8 CPU shards).
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict

import numpy as np

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import parallel as par

__all__ = ["make_csv", "pipeline", "main"]


def make_csv(path: str, n: int = 20_000, sites: int = 4,
             sensors: int = 8, seed: int = 0) -> None:
    """A readings table: site/sensor ids, a value, and some error rows
    (coded as negative values) that the pipeline must drop."""
    rng = np.random.default_rng(seed)
    site = rng.integers(0, sites, n)
    sensor = rng.integers(0, sensors, n)
    value = np.abs(rng.normal(10.0, 3.0, n))
    err = rng.random(n) < 0.05
    value[err] = -1.0                      # error code
    with open(path, "w") as f:
        f.write("site,sensor,value\n")
        for s, d, v in zip(site, sensor, value):
            f.write(f"{s},{d},{v:.6f}\n")


def pipeline(csv_path: str, mesh=None) -> "tft.TensorFrame":
    """The full pipeline; returns the ranked per-(site, sensor) report."""
    mesh = mesh or par.local_mesh()
    # int32 keys at parse time, as the JAX package's demo parses them:
    # device-side grouping keys on a device-exact key dtype
    df = tft.analyze(tft.io.read_csv(
        csv_path, num_partitions=4,
        dtypes={"site": "int32", "sensor": "int32"}))
    clean = df.filter(lambda value: value >= 0.0)

    dist = par.distribute(clean, mesh)
    agg = par.daggregate({"value": "sum"}, dist, ["site", "sensor"],
                         max_groups=64)
    ranked = agg.order_by("value", descending=True)
    return ranked


def main() -> Dict:
    d = tempfile.mkdtemp(prefix="tft_analytics_")
    csv_path = os.path.join(d, "readings.csv")
    make_csv(csv_path)
    ranked = pipeline(csv_path)
    ranked.show(5)
    rows = ranked.collect()
    top = rows[0]
    print(f"{len(rows)} (site, sensor) groups; top: site {top['site']} "
          f"sensor {top['sensor']} total {top['value']:.1f}")
    totals = [r["value"] for r in rows]
    assert totals == sorted(totals, reverse=True)
    return {"groups": len(rows), "top_total": top["value"]}


if __name__ == "__main__":
    main()
