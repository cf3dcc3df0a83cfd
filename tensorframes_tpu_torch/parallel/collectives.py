"""Collective combiners for mesh reductions.

The port's counterpart of ``tensorframes_tpu/parallel/collectives.py``.
When a mesh reduce's combine is one of the known associative monoids
(sum, min, max, prod), each shard reduces its own rows and the shards'
partials meet in the combiner's collective; each combiner carries its
neutral element, so the pad rows that make shards equal are masked to it.
Arbitrary user combines take the generic route (``distributed.py``).

On a single-controller mesh every shard's partial is a tensor on its own
device, and :attr:`Combiner.collective` folds the list onto the first
shard's device in shard order, so a run repeats bit for bit. ``ici`` keeps
the name of the JAX package's collective primitive for trace attribution.

A cluster mesh (``cluster.cluster_mesh``) spans processes, each holding
only its own shards. Its cross-process legs run here, over the cluster's
:class:`ClusterGroup`: :func:`gather_shard_parts` brings every shard's
partial to every process in GLOBAL shard order (never arrival order), so
each process folds the same list the same way and every process's result
is bit-identical; :func:`allgather_var` and :func:`allgather_object`
carry rows and small host values; :func:`route_pieces` moves row pieces
between shards with one ``all_to_all_single`` (uneven splits) per
exchange. Under gloo, which moves a CUDA tensor through host memory in
any case, every leg stages its tensors through pinned host memory by
design and counts the bytes in ``mesh.interstage_host_bytes``; under
NCCL the tensors stay on the card.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from ..utils.tracing import counters

__all__ = ["Combiner", "COMBINERS", "ClusterGroup", "allgather_var",
           "allgather_object", "gather_shard_parts", "route_pieces"]


class Combiner(NamedTuple):
    """An associative reduction: local block-reduce, mesh collective, and
    the padding-neutral element."""

    name: str
    local: Callable  # (block, axis) -> partial
    collective: Callable  # ([partial of each shard]) -> combined
    neutral: Callable  # (torch dtype) -> python scalar
    ici: str = "psum"  # the JAX package's primitive (trace attribution)


def _neutral_min(dt: torch.dtype):
    if dt.is_floating_point:
        return float("inf")
    return torch.iinfo(dt).max


def _neutral_max(dt: torch.dtype):
    if dt.is_floating_point:
        return float("-inf")
    return torch.iinfo(dt).min


def _fold(op: Callable) -> Callable:
    """The collective of a pairwise ``op``: the shards' partials folded in
    shard order onto the first partial's device."""

    def collective(parts: Sequence[torch.Tensor]) -> torch.Tensor:
        acc = parts[0]
        for p in parts[1:]:
            acc = op(acc, p.to(acc.device))
        return acc

    return collective


COMBINERS: Dict[str, Combiner] = {
    "sum": Combiner("sum", lambda b, axis=0: torch.sum(b, dim=axis),
                    _fold(torch.add), lambda dt: 0, ici="psum"),
    "min": Combiner("min", lambda b, axis=0: torch.amin(b, dim=axis),
                    _fold(torch.minimum), _neutral_min, ici="pmin"),
    "max": Combiner("max", lambda b, axis=0: torch.amax(b, dim=axis),
                    _fold(torch.maximum), _neutral_max, ici="pmax"),
    "prod": Combiner("prod", lambda b, axis=0: torch.prod(b, dim=axis),
                     _fold(torch.mul),
                     lambda dt: 1, ici="all_gather"),
}


# ---------------------------------------------------------------------------
# cross-process legs of a cluster mesh
# ---------------------------------------------------------------------------

class ClusterGroup:
    """The process group a cluster mesh's cross-process legs run over:
    this process's ``rank`` of ``size``, the ``backend`` (``"gloo"`` or
    ``"nccl"``) and the torch process group itself (``pg``, None for the
    default group)."""

    __slots__ = ("pg", "rank", "size", "backend")

    def __init__(self, pg, rank: int, size: int, backend: str):
        self.pg = pg
        self.rank = int(rank)
        self.size = int(size)
        self.backend = str(backend)

    def __repr__(self):
        return (f"ClusterGroup(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r})")


def _stage(group: ClusterGroup, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend moves it: under gloo a CUDA tensor goes through
    pinned host memory (counted in ``mesh.interstage_host_bytes``); NCCL
    takes it where it lies. Bools travel as uint8."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    t = t.contiguous()
    if group.backend == "gloo" and t.device.type != "cpu":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        counters.inc("mesh.interstage_host_bytes",
                     int(t.numel()) * int(t.element_size()))
        return host
    return t


def _unstage(t: torch.Tensor, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    if t.device != device:
        t = t.to(device)
    return t.to(torch.bool) if dtype == torch.bool else t


def allgather_object(group: ClusterGroup, obj: Any) -> List[Any]:
    """Every process's ``obj`` (small, picklable), in rank order."""
    import torch.distributed as tdist

    out: List[Any] = [None] * group.size
    tdist.all_gather_object(out, obj, group=group.pg)
    return out


def allgather_var(group: ClusterGroup, t: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``t``, in rank order, on ``t``'s device: the leading
    length may differ between processes, the trailing shape and the dtype
    may not."""
    import torch.distributed as tdist

    dtype, device = t.dtype, t.device
    x = _stage(group, t)
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    ns = [torch.empty_like(n) for _ in range(group.size)]
    tdist.all_gather(ns, n, group=group.pg)
    lens = [int(v.item()) for v in ns]
    top = max(lens)
    if x.shape[0] < top:
        x = torch.cat([x, x.new_zeros((top - x.shape[0],)
                                      + tuple(x.shape[1:]))])
    outs = [torch.empty_like(x) for _ in range(group.size)]
    tdist.all_gather(outs, x, group=group.pg)
    return [_unstage(o[:k], dtype, device) for o, k in zip(outs, lens)]


def gather_shard_parts(mesh, parts: Sequence[Optional[torch.Tensor]],
                       device: torch.device) -> List[Optional[torch.Tensor]]:
    """Every data shard's partial, in global shard order, on ``device``.

    ``parts`` holds one partial (or None) per shard this process holds
    (``mesh.local_shards()``), all of one shape and dtype. A
    single-controller mesh holds every shard, so ``parts`` is returned as
    it is; on a cluster mesh every process contributes its own and gets
    every process's back, ordered by shard, so a fold over the list is the
    same fold on every process."""
    if not mesh.is_cluster:
        return list(parts)
    group = mesh.group
    owner = mesh.shard_processes()
    proto = next((p for p in parts if p is not None), None)
    meta = allgather_object(group, (
        [p is not None for p in parts],
        None if proto is None else (tuple(proto.shape), str(proto.dtype))))
    shape_dtype = next((m[1] for m in meta if m[1] is not None), None)
    if shape_dtype is None:
        return [None] * len(owner)
    shape = shape_dtype[0]
    dtype = getattr(torch, shape_dtype[1].replace("torch.", ""))
    present = [p.to(device) for p in parts if p is not None]
    stacked = (torch.stack(present) if present
               else torch.empty((0,) + tuple(shape), dtype=dtype,
                                device=device))
    got = allgather_var(group, stacked)
    out: List[Optional[torch.Tensor]] = [None] * len(owner)
    for r in range(group.size):
        rows = iter(got[r])
        for s, here in zip([s for s, p in enumerate(owner) if p == r],
                           meta[r][0]):
            out[s] = next(rows) if here else None
    return out


def route_pieces(mesh, pieces: Dict[Tuple[int, int], torch.Tensor],
                 sizes: Dict[Tuple[int, int], int], like: torch.Tensor
                 ) -> Dict[Tuple[int, int], torch.Tensor]:
    """Move row pieces between data shards: ``pieces[(src, dst)]`` (rows
    of shard ``src``, held here, bound for shard ``dst``) arrive as
    ``result[(src, dst)]`` for every ``dst`` held here, each on ``dst``'s
    device. ``sizes`` gives every pair's row count and is the same on every
    process; ``like`` gives the trailing shape and dtype (one exchange
    moves one column).

    On a cluster mesh the pieces bound for other processes travel in one
    ``all_to_all_single`` with uneven splits, ordered by ``(src, dst)``
    within each process's block; pieces between two shards of one process
    never leave it."""
    devs = mesh.shard_devices()
    if not mesh.is_cluster:
        return {k: v.to(devs[k[1]]) for k, v in pieces.items()}
    import torch.distributed as tdist

    group = mesh.group
    me = group.rank
    owner = mesh.shard_processes()
    pairs = sorted(sizes)
    out: Dict[Tuple[int, int], torch.Tensor] = {}
    send, in_splits = [], []
    for r in range(group.size):
        rows = 0
        for pr in pairs:
            if owner[pr[0]] == me and owner[pr[1]] == r:
                if r == me:
                    out[pr] = pieces[pr].to(devs[pr[1]])
                else:
                    send.append(pieces[pr])
                    rows += int(sizes[pr])
        in_splits.append(rows)
    out_splits = [0 if r == me else sum(
        int(sizes[pr]) for pr in pairs
        if owner[pr[0]] == r and owner[pr[1]] == me)
        for r in range(group.size)]
    cell = tuple(like.shape[1:])
    home = mesh.local_shard_devices()[0]
    inp = _stage(group, torch.cat(send) if send else
                 torch.empty((0,) + cell, dtype=like.dtype, device=home))
    recv = torch.empty((sum(out_splits),) + cell, dtype=inp.dtype,
                       device=inp.device)
    tdist.all_to_all_single(recv, inp, out_splits, in_splits,
                            group=group.pg)
    lo = 0
    for r in range(group.size):
        if r == me:
            continue
        for pr in pairs:
            if owner[pr[0]] == r and owner[pr[1]] == me:
                n = int(sizes[pr])
                out[pr] = _unstage(recv[lo:lo + n], like.dtype,
                                   devs[pr[1]])
                lo += n
    return out
