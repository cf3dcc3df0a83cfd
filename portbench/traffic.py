"""The one generator of traffic: a cell's ``traffic`` parameters and the
seed give the parameters of every request.

A cell's file holds::

    "traffic": {"loop": "closed", "clients": 1, "warm_requests": 2,
                "params": {"delta": {"integers": [60, 120]},
                           "offset": {"grid": [0, 2048, 256]}}}

- ``integers [lo, hi]``: a whole number in ``[lo, hi]``, both ends
  included, drawn independently for each request (a substitution
  parameter such as TPC-H's ``DELTA``);
- ``grid [lo, hi, step]``: the values ``lo, lo + step, ..., hi`` in an
  order the seed permutes, again after each pass; so every seed gets the
  same values, in another order, and one seed's window is no heavier
  than another's.

Each parameter has a stream of its own, so adding one changes no other.
The warm-up requests of set-up draw from streams of their own too.
"""

from __future__ import annotations

import zlib
from typing import Dict, Iterator

import numpy as np


def stream(seed: int, name: str, purpose: str) -> np.random.Generator:
    """A generator of its own for ``(seed, name, purpose)``; any whole
    ``seed``, taken modulo 2**64."""
    return np.random.default_rng(
        [int(seed) % 2 ** 64, zlib.crc32(name.encode()),
         zlib.crc32(purpose.encode())])


def _values(spec: dict, rng: np.random.Generator) -> Iterator[float]:
    if "integers" in spec:
        lo, hi = spec["integers"]
        while True:
            yield int(rng.integers(lo, hi + 1))
    if "grid" in spec:
        lo, hi, step = spec["grid"]
        values = list(range(lo, hi + 1, step))
        while True:
            for j in rng.permutation(len(values)):
                yield values[j]
    raise ValueError(f"unknown traffic parameter: {spec}")


def requests(traffic: dict, seed: int, purpose: str = "window"
             ) -> Iterator[Dict[str, float]]:
    """The parameters of request 0, 1, 2, ... (an endless iterator)."""
    params = traffic.get("params", {})
    its = {name: _values(spec, stream(seed, name, purpose))
           for name, spec in params.items()}
    while True:
        yield {name: next(it) for name, it in its.items()}


def sample(seed: int, population: int, k: int, purpose: str) -> np.ndarray:
    """``k`` distinct indices of ``range(population)`` drawn from the seed,
    ascending (all of them where ``k >= population``)."""
    rng = stream(seed, "sample", purpose)
    if k >= population:
        return np.arange(population)
    return np.sort(rng.choice(population, size=k, replace=False))
