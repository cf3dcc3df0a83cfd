"""Ring collectives: sequence-parallel (ring) attention and ring allreduce.

The port's counterpart of ``tensorframes_tpu/parallel/ring.py``. The JAX
package runs both inside ``shard_map`` and moves data with ``ppermute``.
The port's mesh is single-controller with no compiler to insert the
collectives, so each shard's part is a tensor on that shard's device, a
ring step runs every shard's part in shard order, and a hop is
``.to(next_device)``: on logical shards of one card the tensor stays
where it is, across cards it is a peer copy.

``ring_attention`` splits the sequence dim of q/k/v over the axis and
rotates the k/v blocks around the ring, keeping the online softmax
statistics (running max ``m``, normalizer ``l``, accumulator ``o``) of
each query block, so a shard holds S/n of the sequence at a time. Causal
masking uses global positions. The block update is the JAX package's own
math in plain torch (einsums, ``-inf`` masking with its guards), not the
flash-attention kernel, which masks with -1e30 instead.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..observability.events import current_trace as _current_trace
from .mesh import DeviceMesh

__all__ = ["ring_attention", "ring_allreduce"]


def _sync(out) -> None:
    """Wait for the devices of the tensors in ``out`` (a tree of them)."""
    leaves = pytree.tree_leaves(out)
    for dev in {t.device for t in leaves if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _traced_ring_dispatch(kind: str, fn, axis: str, devices: int,
                          hops: int):
    """Run a ring program (``fn()``), recording a ``collective`` event on
    the active query trace. It is timed to completion only when a trace is
    active (a synchronize of the card); untraced, the launches stay
    asynchronous."""
    trace = _current_trace()
    if trace is None:
        return fn()
    t0 = trace.clock()
    out = fn()
    _sync(out)
    trace.add("collective", name=kind, ts=t0,
              dur=max(trace.clock() - t0, 0.0), axis=axis,
              devices=devices, hops=hops)
    return out


def _local_attn_update(q, k, v, m, l, o, scale, mask):
    """One flash-attention block update with blockwise softmax rescaling.

    q: [B, Sq, H, D]; k/v: [B, Sk, H, D]; m/l: [B, H, Sq]; o like q.
    ``mask``: [Sq, Sk] boolean or None.
    """
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask[None, None, :, :], scores, -torch.inf)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # guard fully-masked rows: keep m finite so exp() stays 0, not NaN
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(scores - m_safe[..., None])
    if mask is not None:
        p = torch.where(mask[None, None, :, :], p, 0.0)
    alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
    l_new = alpha * l + p.sum(dim=-1)
    o_new = o * alpha.transpose(1, 2)[..., None] + \
        torch.einsum("bhqk,bkhd->bqhd", p, v)
    return m_new, l_new, o_new


def _ring_parts(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], devices: Sequence[torch.device],
                causal: bool, scale: float) -> List[torch.Tensor]:
    """Ring attention over one ring: ``qs[i]``, ``ks[i]``, ``vs[i]`` are
    shard i's blocks ``[B, S/n, H, D]`` on ``devices[i]``, in sequence
    order. n steps; at step t shard i holds the k/v block of shard
    ``(i - t) % n``, runs the block update, then every block moves one
    shard along the ring (n hops of k and of v). Returns each shard's
    output block on its device."""
    n = len(qs)
    S = qs[0].shape[1]
    q_pos = [torch.arange(i * S, (i + 1) * S, device=devices[i])
             for i in range(n)]
    state = []
    for q in qs:
        B, _, H, _ = q.shape
        state.append((torch.full((B, H, S), -torch.inf, dtype=q.dtype,
                                 device=q.device),
                      torch.zeros((B, H, S), dtype=q.dtype, device=q.device),
                      torch.zeros_like(q)))
    k_cur, v_cur = list(ks), list(vs)
    for step in range(n):
        for i in range(n):
            # the k/v block now resident arrived from `step` hops upstream
            src = (i - step) % n
            mask = None
            if causal:
                k_pos = q_pos[src].to(devices[i])
                mask = q_pos[i][:, None] >= k_pos[None, :]
            state[i] = _local_attn_update(qs[i], k_cur[i], v_cur[i],
                                          *state[i], scale, mask)
        k_cur = [k_cur[(i - 1) % n].to(devices[i]) for i in range(n)]
        v_cur = [v_cur[(i - 1) % n].to(devices[i]) for i in range(n)]
    outs = []
    for _, l, o in state:
        l_safe = torch.where(l == 0.0, 1.0, l)
        outs.append(o / l_safe.transpose(1, 2)[..., None])
    return outs


Rings = Dict[Tuple[int, int], Tuple[List[torch.Tensor], List[torch.Tensor],
                                    List[torch.Tensor],
                                    List[torch.device]]]


def ring_attention_parts(rings: Rings, causal: bool, scale: float,
                         axis: str) -> Dict[Tuple[int, int],
                                            List[torch.Tensor]]:
    """Every ring of one attention call: ``rings[(b, h)]`` holds the q, k
    and v blocks and the devices of the ring of batch shard b and head
    shard h (those never communicate). One ``collective`` event for the
    call, as the JAX package records for one ``shard_map``."""
    n = len(next(iter(rings.values()))[0])

    def run():
        return {key: _ring_parts(qs, ks, vs, devs, causal, scale)
                for key, (qs, ks, vs, devs) in rings.items()}

    # n ring steps, each moving k AND v one hop
    return _traced_ring_dispatch("ring_attention", run, axis, n,
                                 hops=2 * n)


def _split(x: torch.Tensor, dim: int, n: int, what: str) -> List[torch.Tensor]:
    if x.shape[dim] % n:
        raise ValueError(f"ring_attention: the {what} dim ({x.shape[dim]}) "
                         f"does not split over {n} shards")
    return list(torch.chunk(x, n, dim=dim))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: DeviceMesh, seq_axis: Optional[str] = None,
                   causal: bool = False,
                   batch_axis: Optional[str] = None,
                   head_axis: Optional[str] = None) -> torch.Tensor:
    """Exact attention over a sequence sharded across a mesh axis.

    q/k/v: [batch, seq, heads, head_dim]; the sequence is split over
    ``seq_axis`` (defaults to the mesh's data axis) in shard order, each
    block on its shard's device. Returns the attention output, gathered
    on ``q``'s device. Each ring step computes one local q-block/k-block
    interaction and moves k/v one hop; softmax is exact via online
    (m, l, o) accumulation.

    ``batch_axis``/``head_axis`` additionally split the batch and head
    dims: attention is independent across batch and heads, so those axes
    never communicate; only k/v hop the ring over ``seq_axis``.
    """
    axis = seq_axis or mesh.data_axis
    n = mesh.shape[axis]
    nb, nh = mesh.axis_size(batch_axis), mesh.axis_size(head_axis)
    # python float so f32/bf16 inputs keep their dtype
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    qb, kb, vb = (_split(t, 0, nb, "batch") for t in (q, k, v))
    rings = {}
    for b in range(nb):
        qh, kh, vh = (_split(t[b], 2, nh, "head") for t in (qb, kb, vb))
        for h in range(nh):
            devs = []
            for i in range(n):
                coords = {axis: i}
                if batch_axis is not None:
                    coords[batch_axis] = b
                if head_axis is not None:
                    coords[head_axis] = h
                devs.append(mesh.device_at(**coords))
            qs, ks, vs = ([blk.to(d) for blk, d in
                           zip(_split(t[h], 1, n, "sequence"), devs)]
                          for t in (qh, kh, vh))
            rings[b, h] = (qs, ks, vs, devs)
    outs = ring_attention_parts(rings, causal, scale, axis)
    return torch.cat([torch.cat([torch.cat([o.to(q.device)
                                            for o in outs[b, h]], dim=1)
                                 for h in range(nh)], dim=2)
                      for b in range(nb)], dim=0)


def ring_allreduce(x: torch.Tensor, mesh: DeviceMesh,
                   axis: Optional[str] = None) -> torch.Tensor:
    """Bandwidth-optimal allreduce built from neighbour hops.

    ``x`` has shape [n, ...]: slice i is shard i's local value (on its
    device for the schedule). Returns the same shape, on ``x``'s device,
    where every slice is the full sum. The classic schedule: reduce-scatter
    then all-gather, 2(n-1) neighbour hops each moving 1/n of the payload.
    """
    ax = axis or mesh.data_axis
    n = mesh.shape[ax]
    if n == 1:
        return x
    if x.shape[0] != n:
        raise ValueError(
            f"ring_allreduce expects leading dim == axis size {n}, got "
            f"{x.shape[0]}")
    devs = [mesh.device_at(**{ax: i}) for i in range(n)]

    def run():
        size = x[0].numel()
        pad = (-size) % n
        chunks = []
        for i in range(n):
            flat = x[i].reshape(-1).to(devs[i])
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            chunks.append(flat.reshape(n, -1))
        # reduce-scatter: at step s every shard passes its partially
        # reduced chunk on and folds the arriving one, chunk (me - s - 1),
        # into it; after n-1 steps shard me owns fully reduced chunk me+1
        buf = [chunks[i][i] for i in range(n)]
        for s in range(n - 1):
            buf = [buf[(i - 1) % n].to(devs[i]) for i in range(n)]
            buf = [buf[i] + chunks[i][(i - s - 1) % n] for i in range(n)]
        # all-gather: rotate each fully reduced chunk around the ring
        outs = [torch.zeros_like(chunks[i]) for i in range(n)]
        idx = [(i + 1) % n for i in range(n)]
        for i in range(n):
            outs[i][idx[i]] = buf[i]
        cur = buf
        for _ in range(n - 1):
            cur = [cur[(i - 1) % n].to(devs[i]) for i in range(n)]
            # shard i-1 owned chunk i, so each arrival is one index lower
            idx = [(j - 1) % n for j in idx]
            for i in range(n):
                outs[i][idx[i]] = cur[i]
        return torch.stack([o.reshape(-1)[:size].reshape(x.shape[1:])
                            .to(x.device) for o in outs])

    return _traced_ring_dispatch("ring_allreduce", run, ax, n,
                                 hops=2 * (n - 1))
