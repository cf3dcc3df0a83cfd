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
  emitting one row per block, then a small ``reduce_blocks`` combine;
- variant C (``step_device_resident``): variant B's program over a
  ``distribute``d frame that stays on the mesh's devices, through
  ``dmap_blocks(trim=True, row_aligned=False)``: per step only the
  centroids go out and the k x (m + 2) partials come back;
- variant D (``step_daggregate``): ``dmap_blocks`` appends each point's
  assignment and distance, then ``daggregate(max_groups=k)`` folds them
  into the k-row table with device-side keys (``segment_sum`` on every
  shard).

Variant E (the native core's resident loop) waits for the native
execution core (``ROADMAP.md`` A item 8). The driver loop (``kmeans``) is
the JAX package's: centroids live on the host and each round's program
closes over them, placed on the package's default device.
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

def _preagg_computation(centers: np.ndarray,
                        n_valid: int = None) -> Callable:
    """``n_valid`` masks pad rows on the device-resident path: their segment
    id becomes -1 (dropped by segment_sum) and their distance 0."""
    k = centers.shape[0]
    c = _on_device(centers)

    def preagg(features):
        d = _distances(features, c)
        idx = torch.argmin(d, dim=1).to(torch.int32)
        mind = torch.amin(d, dim=1)
        if n_valid is not None:
            valid = torch.arange(features.shape[0],
                                 device=features.device) < n_valid
            idx = torch.where(valid, idx, -1)
            mind = torch.where(valid, mind, 0.0)
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


# -- variant C: device-resident frame, centroids-only traffic ---------------

def step_device_resident(dist, centers: np.ndarray) -> Tuple[np.ndarray, float]:
    """One step on a ``distribute``d frame (``parallel.distributed``).

    ``dist`` stays on the devices; per-step host traffic is just the
    k x m centroid matrix out and k x (m+2) partials back.
    """
    from tensorframes_tpu_torch import dtypes as _dt
    from tensorframes_tpu_torch.computation import Computation, TensorSpec
    from tensorframes_tpu_torch.parallel.distributed import dmap_blocks
    from tensorframes_tpu_torch.shape import Shape, Unknown

    m = centers.shape[1]
    comp = Computation.trace(
        _preagg_computation(centers, n_valid=dist.num_rows),
        [TensorSpec("features", _dt.double, Shape(Unknown, m))])
    out = dmap_blocks(comp, dist, trim=True, row_aligned=False)
    return _combine_partials(np.asarray(out.columns["agg_points"]),
                             np.asarray(out.columns["agg_counts"]),
                             np.asarray(out.columns["agg_distances"]),
                             centers)


# -- variant D: the keyed aggregate at mesh scale, device-side keys ----------

def step_daggregate(dist, centers: np.ndarray) -> Tuple[np.ndarray, float]:
    """One step as a mesh-level keyed aggregate (variant A at mesh scale).

    ``dmap_blocks`` appends the assignment + per-point partials and
    ``daggregate(max_groups=k)`` folds them into the k-row table with
    DEVICE-side keys: per-step host traffic is the k x (m+2) table, and
    the key column never visits the host.
    """
    from tensorframes_tpu_torch.parallel.distributed import (daggregate,
                                                             dmap_blocks)

    k, m = centers.shape
    c = _on_device(centers)

    def assign_fn(features):
        d = _distances(features, c)
        return {"assign": torch.argmin(d, dim=1).to(torch.int32),
                "mind": torch.amin(d, dim=1),
                "ones": torch.ones((features.shape[0],),
                                   dtype=features.dtype,
                                   device=features.device)}

    scored = dmap_blocks(assign_fn, dist)
    # pad rows never reach the aggregate: daggregate marks them out in
    # its validity-aware group ids
    table = daggregate({"features": "sum", "mind": "sum", "ones": "sum"},
                       scored, "assign", max_groups=k)
    rows = table.collect()
    sums = np.zeros_like(centers)
    counts = np.zeros((k,))
    dist_total = 0.0
    for r in rows:
        i = int(r["assign"])
        sums[i] = np.asarray(r["features"])
        counts[i] = r["ones"]
        dist_total += float(r["mind"])
    safe = np.maximum(counts, 1.0)[:, None]
    new_centers = np.where(counts[:, None] > 0, sums / safe, centers)
    return new_centers, float(dist_total)


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

    # mesh variants (C: device-resident frame, D: mesh keyed aggregate)
    from tensorframes_tpu_torch.parallel.distributed import distribute
    from tensorframes_tpu_torch.parallel.mesh import local_mesh

    dist = distribute(df, local_mesh())
    for name, step in [("device_resident", step_device_resident),
                       ("daggregate", step_daggregate)]:
        centers, history = kmeans(dist, init, step=step)
        print(f"[{name}] converged after {len(history)} steps; "
              f"final distance {history[-1]:.3f}")
    print("[native_resident] skipped (the native execution core is "
          "ROADMAP.md A item 8)")


if __name__ == "__main__":
    main()
