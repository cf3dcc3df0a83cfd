"""DSL graph structure: nodes, implicit graphs, TF-style name scoping.

The port's counterpart of ``tensorframes_tpu/dsl/graph.py``, itself the
reference's Scala DSL core (``dsl/Operation.scala``, ``Paths.scala``):
operator nodes form a DAG; each node gets a TF-convention path — scope
prefixes joined with ``/``, duplicate base names deduplicated with ``_1``,
``_2`` suffixes — assigned from the *current graph*'s counters. The nodes
lower to a plain PyTorch function (see :mod:`.lower`).

Graphs are implicit and thread-local; ``with_graph()`` opens a fresh graph
(resetting name counters — the test-isolation contract of the reference's
``GraphScoping.testGraph``), ``scope(name)`` opens a name scope.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import dtypes as _dt
from ..shape import Shape

__all__ = ["Node", "Graph", "current_graph", "with_graph", "scope"]


class Graph:
    """Holds name-dedup counters and the scope stack for one DSL graph."""

    def __init__(self):
        self._counters: Dict[str, int] = {}
        self._scopes: List[str] = []
        self.nodes: List["Node"] = []

    def assign_name(self, base: str) -> str:
        prefix = "/".join(self._scopes)
        full_base = f"{prefix}/{base}" if prefix else base
        n = self._counters.get(full_base, 0)
        self._counters[full_base] = n + 1
        return full_base if n == 0 else f"{full_base}_{n}"

    def claim_name(self, name: str) -> str:
        """Claim an explicit (user-requested) name, deduplicating like TF."""
        return self.assign_name(name)


class _State(threading.local):
    def __init__(self):
        self.stack: List[Graph] = []
        self.default = Graph()


_state = _State()


def current_graph() -> Graph:
    return _state.stack[-1] if _state.stack else _state.default


@contextmanager
def with_graph(g: Optional[Graph] = None):
    """Run DSL construction in a fresh graph (fresh naming counters)."""
    g = g or Graph()
    _state.stack.append(g)
    try:
        yield g
    finally:
        _state.stack.pop()


@contextmanager
def scope(name: str):
    """TF-style name scope: nested ops get ``name/`` path prefixes."""
    g = current_graph()
    g._scopes.append(name)
    try:
        yield
    finally:
        g._scopes.pop()


class Node:
    """One DSL operation node.

    ``op`` names the abstract operation; ``impl`` is its torch lowering
    ``(input_tensors...) -> tensor``; ``parents`` the input nodes; ``value``
    an optional captured constant. Shape/dtype are inferred eagerly at
    construction (the reference's broadcastShape moment,
    ``dsl/DslImpl.scala:115-132``).
    """

    _tft_dsl_node = True  # duck-type marker for the engine

    def __init__(self, op: str, parents: Sequence["Node"],
                 dtype: _dt.DType, shape: Shape,
                 impl: Optional[Callable] = None,
                 value: Optional[np.ndarray] = None,
                 name: Optional[str] = None):
        g = current_graph()
        self.graph = g
        self.op = op
        self.parents = list(parents)
        self.dtype = dtype
        self.shape = shape
        self.impl = impl
        self.value = value
        self.name = g.claim_name(name) if name else g.assign_name(op)
        g.nodes.append(self)

    # -- naming ------------------------------------------------------------
    def named(self, name: str) -> "Node":
        """Rename this node (the reference's ``named`` operator,
        ``dsl/Operation.scala:40-44``)."""
        self.name = self.graph.claim_name(name)
        return self

    # -- operator sugar (reference dsl/Operation.scala:46-56) --------------
    def __add__(self, other):
        from . import add
        return add(self, other)

    def __radd__(self, other):
        from . import add
        return add(other, self)

    def __sub__(self, other):
        from . import sub
        return sub(self, other)

    def __rsub__(self, other):
        from . import sub
        return sub(other, self)

    def __mul__(self, other):
        from . import mul
        return mul(self, other)

    def __rmul__(self, other):
        from . import mul
        return mul(other, self)

    def __truediv__(self, other):
        from . import div
        return div(self, other)

    def __rtruediv__(self, other):
        from . import div
        return div(other, self)

    def __repr__(self):
        return (f"Node({self.name}: {self.op} "
                f"{self.dtype.name}{self.shape!r})")
