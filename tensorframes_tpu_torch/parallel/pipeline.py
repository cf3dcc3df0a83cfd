"""Pipeline parallelism: GPipe-style stage execution over a mesh axis.

The port's counterpart of ``tensorframes_tpu/parallel/pipeline.py``. The
JAX package runs the schedule as one ``shard_map`` program: a
``lax.scan`` over ``M + P - 1`` ticks in which every device applies its
stage to the activation it holds and ``ppermute`` rotates activations one
hop. Microbatch ``m`` is picked up by stage 0 at tick ``m`` and emitted by
stage ``P-1`` at tick ``m + P - 1``. The port's single controller runs the
same schedule tick by tick, each stage on its shard's device, and moves
each activation one stage a tick (``.to`` the next stage's device). It
skips the bubble ticks, where a stage holds no microbatch: the JAX
schedule computes them on its buffers and masks the results away.
Autograd differentiates the schedule; its backward runs the stages in
reverse.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from .mesh import DeviceMesh

__all__ = ["pipeline_apply"]


def _to(tree, device):
    return pytree.tree_map(lambda a: a.to(device), tree)


def pipeline_parts(stage_fn: Callable, stage_params: Sequence[Any],
                   x: torch.Tensor, devices: Sequence[Sequence[torch.device]],
                   num_microbatches: int) -> torch.Tensor:
    """The schedule over placed stages: ``stage_params[p]`` is stage p's
    parameter tree (no leading stage dim) and ``devices[p][d]`` the device
    of stage p on data shard d. Each microbatch's rows are split over the
    data shards in contiguous blocks. Returns the full batch output on
    ``x``'s device."""
    P, nd, M = len(stage_params), len(devices[0]), num_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"Batch {B} not divisible into {M} microbatches")
    mbs = [torch.tensor_split(mb, nd) for mb in torch.chunk(x, M)]
    outs: List[List[Optional[torch.Tensor]]] = [[None] * nd
                                                for _ in range(M)]
    held: Dict[tuple, torch.Tensor] = {}  # (stage, shard) -> its input
    for t in range(M + P - 1):
        made = {}
        for p in range(P):
            m = t - p
            if not 0 <= m < M:
                continue  # a bubble: this stage holds no microbatch
            for d in range(nd):
                dev = devices[p][d]
                inp = mbs[m][d].to(dev) if p == 0 else held[p, d]
                act = stage_fn(_to(stage_params[p], dev), inp)
                if p == P - 1:
                    outs[m][d] = act
                else:
                    made[p + 1, d] = act.to(devices[p + 1][d])
        held = made
    return torch.cat([o.to(x.device) for row in outs for o in row])


def pipeline_apply(stage_fn: Callable, stacked_params, x: torch.Tensor,
                   mesh: DeviceMesh, pipe_axis: str = "pipe",
                   num_microbatches: Optional[int] = None,
                   data_axis: Optional[str] = None) -> torch.Tensor:
    """Run ``x`` through ``P`` pipeline stages over ``pipe_axis``.

    - ``stage_fn(params_for_one_stage, act) -> act``: one stage's compute;
      activations keep one shape throughout.
    - ``stacked_params``: a tree whose leaves have leading dim ``P``
      (stage-major); stage p's slice goes to shard p's device, and
      ``stage_fn`` sees it without the leading dim.
    - ``x``: [B, ...] batch; split into ``num_microbatches`` (default P)
      equal microbatches along dim 0.
    - ``data_axis``: when given, each microbatch's rows stay split over it
      through the pipeline (dp x pp composition).

    Returns the full batch output, on ``x``'s device. Autograd
    differentiates it, ``stacked_params`` included.
    """
    pipe_size = mesh.shape[pipe_axis]
    M = num_microbatches or pipe_size
    if x.shape[0] % M:
        raise ValueError(f"Batch {x.shape[0]} not divisible into {M} "
                         f"microbatches")
    nd = mesh.axis_size(data_axis)
    devices = []
    for p in range(pipe_size):
        row = []
        for d in range(nd):
            coords = {pipe_axis: p}
            if data_axis is not None:
                coords[data_axis] = d
            row.append(mesh.device_at(**coords))
        devices.append(row)
    stages = [pytree.tree_map(lambda a, p=p: a[p].to(devices[p][0]),
                              stacked_params) for p in range(pipe_size)]
    return pipeline_parts(stage_fn, stages, x, devices, M)
