"""Collective combiners for mesh reductions.

The port's counterpart of ``tensorframes_tpu/parallel/collectives.py``.
When a mesh reduce's combine is one of the known associative monoids
(sum, min, max, prod), each shard reduces its own rows and the shards'
partials meet in the combiner's collective; each combiner carries its
neutral element, so the pad rows that make shards equal are masked to it.
Arbitrary user combines take the generic route (``distributed.py``).

The mesh is single-controller: every shard's partial is a tensor on its
own device, and :attr:`Combiner.collective` folds the list onto the first
shard's device in shard order, so a run repeats bit for bit. ``ici`` keeps
the name of the JAX package's collective primitive for trace attribution.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence

import torch

__all__ = ["Combiner", "COMBINERS"]


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
