"""Expert parallelism: a Switch-style top-1 MoE FFN over a mesh.

The port's counterpart of ``tensorframes_tpu/parallel/moe.py``. The JAX
package writes the dispatch and combine as one-hot einsums over a
``[T, E, C]`` tensor and lets XLA insert the all_to_all pair between the
token-sharded and expert-sharded layouts. Both are 0/1 permutations (an
expert-capacity slot holds at most one token), so the port computes them
as a scatter of token rows into the ``[E, C, D]`` buffer and a gather back
by the same indices: the same result, without the one-hot tensor (at the
transformer's full width it would be 16,384 x 8 x 2,560 f32, 1.34 GB a
layer).

Routing is global, as under GSPMD: the capacity comes from all T tokens
of the call, and a token's place in its expert's queue is its cumsum in
global token order, whichever shard holds it. Each shard picks its
tokens' experts; the [T] expert ids (ints) meet on the first shard's
device in global order, the positions are computed there, and every shard
gets back its keep mask and positions. The auxiliary loss is a product of
global means: each expert's assignment count and gate mass are summed
over the shards first.

Capacity semantics: each expert processes at most ``capacity =
max(1, ceil(tokens/experts * capacity_factor))`` tokens; overflow tokens
are dropped (their FFN delta is zero; the residual carries them through),
the Switch-Transformer contract. Counters ``moe.routed_tokens`` and
``moe.dropped_tokens`` count each call's tokens and drops.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..utils.tracing import counters
from .mesh import DeviceMesh

__all__ = ["init_switch_ffn", "switch_ffn"]


def init_switch_ffn(rng: Optional[torch.Generator], d_model: int, d_ff: int,
                    num_experts: int, dtype: torch.dtype = torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    """Switch FFN parameters drawn from ``rng`` (a CPU ``torch.Generator``;
    seed 0 if ``None``): ``router`` [D, E] in f32, ``w1`` [E, D, F] and
    ``w2`` [E, F, D] in ``dtype``, normal times ``sqrt(1/fan_in)``, on
    ``device`` (the package default if ``None``)."""
    if rng is None:
        rng = torch.Generator().manual_seed(0)
    device = resolve_device(device)
    scale_in = float(np.sqrt(1.0 / d_model).astype(np.float32))
    scale_out = float(np.sqrt(1.0 / d_ff).astype(np.float32))
    E, D, Fd = num_experts, d_model, d_ff
    router = torch.randn((D, E), generator=rng) * scale_in
    w1 = torch.randn((E, D, Fd), generator=rng) * scale_in
    w2 = torch.randn((E, Fd, D), generator=rng) * scale_out
    return {"router": router.to(device),
            "w1": w1.to(device, dtype), "w2": w2.to(device, dtype)}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def switch_parts(xs: Sequence[torch.Tensor], gidx: Sequence[torch.Tensor],
                 routers: Sequence[torch.Tensor],
                 w1s: Sequence[Sequence[torch.Tensor]],
                 w2s: Sequence[Sequence[torch.Tensor]],
                 expert_devices: Sequence[Sequence[torch.device]],
                 capacity_factor: float
                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The Switch FFN over tokens split across shards.

    - ``xs[i]``: shard i's tokens ``[T_i, D]`` on its device; ``gidx[i]``
      their indices ``[T_i]`` (int64, same device) in the global token
      order that sets queue positions; ``routers[i]`` the router there.
    - ``w1s[x][m]``, ``w2s[x][m]``: expert shard x's experts ``[E/ep, D,
      F/tp]`` and ``[E/ep, F/tp, D]`` with model shard m's columns of F,
      on ``expert_devices[x][m]``; the partial outputs of the model shards
      are summed in shard order.

    Returns each shard's output ``[T_i, D]`` on its device and the aux
    loss (f32) on the first shard's device.
    """
    dev0 = xs[0].device
    T = sum(int(x.shape[0]) for x in xs)
    ep, tp = len(w1s), len(w1s[0])
    El = int(w1s[0][0].shape[0])
    E = El * ep
    D = int(xs[0].shape[1])
    capacity = max(1, int(math.ceil(T / E * capacity_factor)))
    cdt = xs[0].dtype

    # route each shard's tokens where they are (router math in f32)
    gates, experts = [], []
    for x, router in zip(xs, routers):
        g = torch.softmax(x.to(torch.float32) @ router, dim=-1)  # [T_i, E]
        gates.append(g)
        experts.append(torch.argmax(g, dim=-1))
    # positions in global token order on the first shard's device
    expert_all = torch.empty(T, dtype=torch.int64, device=dev0)
    for e, gi in zip(experts, gidx):
        expert_all[gi.to(dev0)] = e.to(dev0)
    onehot = F.one_hot(expert_all, E)                       # [T, E]
    pos_all = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    keep_all = pos_all < capacity
    counters.inc("moe.routed_tokens", T)
    counters.inc("moe.dropped_tokens", int(T - int(keep_all.sum())))

    # dispatch: scatter each kept token's row into its expert's slot of
    # the [El * C, D] buffer of its expert shard; the other tokens write
    # into one spare row past the end, which is dropped
    slots = []  # slots[i][x]: row of shard i's tokens in shard x's buffer
    kept_gate = []
    for i, x in enumerate(xs):
        gi = gidx[i].to(dev0)
        keep = keep_all[gi].to(x.device)
        pos = pos_all[gi].to(x.device)
        e = experts[i]
        kept_gate.append(torch.gather(gates[i], 1, e[:, None])[:, 0]
                         * keep.to(torch.float32))
        slots.append([torch.where(keep & (e // El == j),
                                  (e - j * El) * capacity + pos,
                                  El * capacity) for j in range(ep)])
    ys = []
    for j in range(ep):
        dx = expert_devices[j][0]
        rows = torch.cat([s[j].to(dx) for s in slots])
        vals = torch.cat([x.to(dx) for x in xs])
        buf = torch.zeros((El * capacity + 1, D), dtype=cdt, device=dx)
        buf = buf.index_put((rows,), vals)[:-1].reshape(El, capacity, D)
        y = None
        for m in range(tp):
            dm = expert_devices[j][m]
            h = _gelu(torch.bmm(buf.to(dm), w1s[j][m]).to(torch.float32))
            part = torch.bmm(h.to(cdt), w2s[j][m]).to(dx)
            y = part if y is None else y + part
        ys.append(torch.cat([y.reshape(El * capacity, D),
                             y.new_zeros((1, D))]))
    # combine: gather each token's row back (zeros where it was not kept),
    # then the gate per token in f32
    outs = []
    for i, x in enumerate(xs):
        routed = None
        for j in range(ep):
            r = ys[j][slots[i][j].to(ys[j].device)].to(x.device)
            routed = r if routed is None else routed + r
        outs.append((routed.to(torch.float32) * kept_gate[i][:, None])
                    .to(cdt))

    # load-balancing auxiliary (Switch eq. 4): E * sum_e f_e * P_e, both
    # global means over the T tokens
    density = onehot.sum(dim=0).to(torch.float32) / T       # f_e
    mass = None
    for g in gates:
        s = g.sum(dim=0).to(dev0)
        mass = s if mass is None else mass + s
    aux = E * torch.sum(density * (mass / T))
    return outs, aux


def switch_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor],
               capacity_factor: float = 1.25,
               mesh: Optional[DeviceMesh] = None,
               expert_axis: Optional[str] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 MoE FFN. ``x``: [T, D] tokens -> ([T, D], aux_loss).

    With ``mesh`` + ``expert_axis``, the experts (and their [E, C, D]
    buffer) are split over the expert axis, expert shard j's slice on its
    device, and the tokens over the mesh's data axis in contiguous rows;
    the result is gathered on ``x``'s device. Routing stays global.
    """
    E = int(params["w1"].shape[0])
    if mesh is None or expert_axis is None:
        dev = x.device
        outs, aux = switch_parts(
            [x], [torch.arange(x.shape[0], device=dev)],
            [params["router"].to(dev)], [[params["w1"].to(dev)]],
            [[params["w2"].to(dev)]], [[dev]], capacity_factor)
        return outs[0], aux
    ep = mesh.shape[expert_axis]
    if E % ep:
        raise ValueError(f"switch_ffn: {E} experts do not split over "
                         f"{ep} shards of {expert_axis!r}")
    dp = mesh.num_data_shards
    rows = torch.arange(x.shape[0], device=x.device)
    xs, gidx, routers = [], [], []
    for d, (blk, idx) in enumerate(zip(torch.tensor_split(x, dp),
                                       torch.tensor_split(rows, dp))):
        dev = mesh.device_at(**{mesh.data_axis: d})
        xs.append(blk.to(dev))
        gidx.append(idx.to(dev))
        routers.append(params["router"].to(dev))
    El = E // ep
    devs = [[mesh.device_at(**{expert_axis: j})] for j in range(ep)]
    w1s = [[params["w1"][j * El:(j + 1) * El].to(devs[j][0])]
           for j in range(ep)]
    w2s = [[params["w2"][j * El:(j + 1) * El].to(devs[j][0])]
           for j in range(ep)]
    outs, aux = switch_parts(xs, gidx, routers, w1s, w2s, devs,
                             capacity_factor)
    return torch.cat([o.to(x.device) for o in outs]), aux.to(x.device)
