"""Minimal keyed aggregation and the README examples, the port of
``demos/groupby_scratch.py``: a string-keyed ``aggregate`` of a sum, the
``x + 3`` map over a 5-row frame, ``analyze`` + reduce over a vector
column, and the DSL map.
"""

from __future__ import annotations

import numpy as np
import torch

import tensorframes_tpu_torch as tft


def groupby_sum():
    """Sum x per string key '0'/'1'."""
    rows = [(str(x // 3), float(x)) for x in range(1, 6)]
    df = tft.frame(rows, columns=["key", "x"])
    gb = df.group_by("key")
    out = tft.aggregate(lambda x_input: {"x": x_input.sum(0)}, gb)
    return sorted(out.collect())


def readme_map_blocks():
    """Add 3 to every element of the x column."""
    df = tft.frame([(float(x),) for x in range(5)], columns=["x"])
    df2 = tft.map_blocks(lambda x: {"z": x + 3.0}, df)
    return df2.collect()


def readme_reduce_vector():
    """``analyze``, then the sum and the min over a vector column."""
    df = tft.frame([([1.0, 1.0],), ([2.0, 2.0],)], columns=["x"])
    df = tft.analyze(df)
    s = tft.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, df)
    m = tft.reduce_rows(lambda x_1, x_2: {"x": torch.minimum(x_1, x_2)}, df)
    return s, m


def readme_dsl_map():
    """The DSL's map on a double column."""
    from tensorframes_tpu_torch import dsl

    df = tft.frame({"x": np.arange(5.0) * 0.1})
    with dsl.with_graph():
        x = tft.block(df, "x")
        z = (x + 3.0).named("z")
        out = tft.map_blocks(z, df)
    return out.collect()


def main():
    print("groupby_sum:", groupby_sum())
    print("readme_map_blocks:", readme_map_blocks())
    s, m = readme_reduce_vector()
    print("reduce_sum:", s, "reduce_min:", m)
    print("dsl_map:", readme_dsl_map())


if __name__ == "__main__":
    main()
