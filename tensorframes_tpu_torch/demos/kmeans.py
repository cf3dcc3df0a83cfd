"""K-Means over a TensorFrame, the port of ``demos/kmeans.py``.

Two of the JAX package's coordination patterns over the same math:

- the distance computation is one matrix product
  (``|x|^2 + |c|^2 - 2 x.c``) on the executor's device;
- variant A (``step_aggregate``): ``map_blocks`` computes each point's
  assignment, then a keyed computation-form ``aggregate`` regroups by
  centroid index (through the engine's segmented fold);
- variant B (``step_preaggregate``): each block's centroid update is
  pre-aggregated inside the program by two calls of the port's
  ``segment_sum`` (the CUDA kernel on the card), with ``trim=True``
  emitting one row per block, then a small ``reduce_blocks`` combine.

Variants C and D (``distribute``, ``daggregate``) and E (the native
core's resident loop) wait for the layers they need (``ROADMAP.md`` A
items 7 and 8). The driver loop (``kmeans``) is the JAX package's:
centroids live on the host and each round's program closes over them,
placed on the package's default device.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.ops.segment_reduce import segment_sum


def _distances(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[n, k] squared distances: one matrix product and broadcasting."""
    sq = torch.sum(points * points, dim=1, keepdim=True)        # [n, 1]
    csq = torch.sum(centers * centers, dim=1)                   # [k]
    return sq + csq[None, :] - 2.0 * points @ centers.T         # [n, k]


def _on_device(centers: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(centers), device=tft.default_device())


# -- variant A: map_blocks + keyed aggregate --------------------------------

def step_aggregate(df: tft.TensorFrame,
                   centers: np.ndarray) -> Tuple[np.ndarray, float]:
    c = _on_device(centers)

    def assign(features):
        d = _distances(features, c)
        return {
            "indexes": torch.argmin(d, dim=1).to(torch.int32),
            "count": torch.ones(features.shape[0], dtype=torch.int64,
                                device=features.device),
            "min_distances": torch.amin(d, dim=1),
        }

    df2 = tft.map_blocks(assign, df)
    gb = df2.group_by("indexes")

    def summarize(features_input, count_input, min_distances_input):
        return {
            "features": features_input.sum(0),
            "count": count_input.sum(0),
            "min_distances": min_distances_input.sum(0),
        }

    df3 = tft.aggregate(summarize, gb)
    new_centers = centers.copy()
    total = 0.0
    for row in df3.collect():
        idx = int(row["indexes"])
        new_centers[idx] = np.asarray(row["features"]) / row["count"]
        total += float(row["min_distances"])
    return new_centers, total


# -- variant B: segment-sum pre-aggregation inside the program ---------------

def _preagg_computation(centers: np.ndarray) -> Callable:
    k = centers.shape[0]
    c = _on_device(centers)

    def preagg(features):
        d = _distances(features, c)
        idx = torch.argmin(d, dim=1).to(torch.int32)
        mind = torch.amin(d, dim=1)
        ones = torch.ones((features.shape[0], 1), dtype=features.dtype,
                          device=features.device)
        # one row per BLOCK: [1, k, m] sums, [1, k] counts, [1] distance
        pts = segment_sum(features, idx, k)
        cnt = segment_sum(ones, idx, k)[:, 0]
        return {
            "agg_points": pts[None],
            "agg_counts": cnt[None],
            "agg_distances": mind.sum()[None],
        }

    return preagg


def _combine_partials(rows_pts, rows_cnt, rows_dst, centers):
    pts = rows_pts.sum(0)                      # [k, m]
    cnt = rows_cnt.sum(0)                      # [k]
    new = np.where(cnt[:, None] > 0, pts / np.maximum(cnt, 1.0)[:, None],
                   centers)                    # empty cluster keeps center
    return new.astype(centers.dtype), float(rows_dst.sum())


def step_preaggregate(df: tft.TensorFrame,
                      centers: np.ndarray) -> Tuple[np.ndarray, float]:
    from tensorframes_tpu_torch.engine import ops as engine_ops

    df2 = tft.map_blocks(_preagg_computation(centers), df, trim=True)
    red = engine_ops.reduce_blocks(
        lambda agg_points_input, agg_counts_input, agg_distances_input: {
            "agg_points": agg_points_input.sum(0),
            "agg_counts": agg_counts_input.sum(0),
            "agg_distances": agg_distances_input.sum(0),
        }, df2)
    return _combine_partials(red["agg_points"][None],
                             red["agg_counts"][None],
                             np.asarray([red["agg_distances"]]), centers)


# -- driver loop --------------------------------------------------------------

def kmeans(df: tft.TensorFrame, init_centers: np.ndarray,
           num_iters: int = 50, step=step_preaggregate,
           verbose: bool = False):
    """Iterate until the total distance stops improving."""
    c = np.asarray(init_centers, np.float64)
    d = np.inf
    history = []
    for i in range(num_iters):
        c1, d1 = step(df, c)
        if verbose:
            print(f"Step = {i} , overall distance = {d1}")
        c = c1
        if d == d1:
            break
        d = d1
        history.append(d1)
    return c, history


def make_data(n: int = 1000, num_features: int = 4, k: int = 2,
              num_partitions: int = 4, seed: int = 1):
    """Gaussian blobs around k corners, separable so that convergence is
    checkable; the JAX package's generator draw for draw."""
    rng = np.random.default_rng(seed)
    true_centers = rng.uniform(-5, 5, (k, num_features))
    assign = rng.integers(0, k, n)
    pts = true_centers[assign] + rng.normal(0, 0.3, (n, num_features))
    df = tft.frame({"features": pts}, num_partitions=num_partitions)
    df = tft.analyze(df)
    init = pts[rng.choice(n, k, replace=False)]
    return df, init, true_centers


def main():
    df, init, _ = make_data()
    for name, step in [("aggregate", step_aggregate),
                       ("preaggregate", step_preaggregate)]:
        centers, history = kmeans(df, init, step=step, verbose=True)
        print(f"[{name}] converged after {len(history)} steps; "
              f"final distance {history[-1]:.3f}")
    print("centers:\n", centers)


if __name__ == "__main__":
    main()
