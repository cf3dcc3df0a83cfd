"""Harmonic and geometric means per key, the port of
``demos/geom_mean.py``: a chained pipeline

  map_blocks (per-row transform) -> select -> group_by + aggregate (keyed
  sums) -> map_blocks (final ratio)

over a frame whose ``key`` is a *string* column that rides through the
tensor engine untouched, and whose original ``x`` is unused after the
first map (dropped by ``select``).
"""

from __future__ import annotations

import numpy as np
import torch

import tensorframes_tpu_torch as tft


def harmonic_mean_per_key(df: tft.TensorFrame,
                          col_key: str = "key") -> tft.TensorFrame:
    """Value column is ``x`` (the programs bind it by name)."""

    def invs_and_count(x):
        inv = 1.0 / x
        return {"invs": inv, "count": torch.ones_like(inv)}

    df2 = tft.map_blocks(invs_and_count, df)
    gb = df2.select([col_key, "invs", "count"]).group_by(col_key)

    def sums(invs_input, count_input):
        return {"invs": invs_input.sum(0), "count": count_input.sum(0)}

    df3 = tft.aggregate(sums, gb)

    def ratio(invs, count):
        return {"harmonic_mean": count / invs}

    return tft.map_blocks(ratio, df3).select([col_key, "harmonic_mean"])


def geometric_mean_per_key(df: tft.TensorFrame,
                           col_key: str = "key") -> tft.TensorFrame:
    """Value column is ``x`` (the programs bind it by name)."""

    def logs_and_count(x):
        lg = torch.log(x)
        return {"logs": lg, "count": torch.ones_like(lg)}

    df2 = tft.map_blocks(logs_and_count, df)
    gb = df2.select([col_key, "logs", "count"]).group_by(col_key)

    def sums(logs_input, count_input):
        return {"logs": logs_input.sum(0), "count": count_input.sum(0)}

    df3 = tft.aggregate(sums, gb)

    def finish(logs, count):
        return {"geometric_mean": torch.exp(logs / count)}

    return tft.map_blocks(finish, df3).select([col_key, "geometric_mean"])


def make_data(n: int = 60, num_partitions: int = 3, seed: int = 7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.5, 4.0, n)
    key = np.array([f"g{i % 3}" for i in range(n)], dtype=object)
    return tft.frame({"key": key, "x": x}, num_partitions=num_partitions)


def main():
    df = make_data()
    print("harmonic:", sorted(harmonic_mean_per_key(df).collect()))
    print("geometric:", sorted(geometric_mean_per_key(df).collect()))


if __name__ == "__main__":
    main()
