"""Embedded operator DSL: build computations without writing PyTorch.

The port's counterpart of ``tensorframes_tpu/dsl``, itself the parity
surface of the reference's Scala DSL (``dsl/package.scala:33-133``):
``placeholder``, ``constant``, ``identity``, ``add``, ``div`` (plus
``sub``/``mul`` sugar), ``fill``, ``zeros``, ``ones``, ``reduce_sum``,
``reduce_min`` (plus ``reduce_max``/``reduce_mean`` extras), operator
overloading on nodes, TF-convention name scoping (``scope``), per-graph
isolation (``with_graph``), and frame-derived placeholders (``block`` /
``row`` live in the package root API).

DSL nodes lower to the same :class:`~..computation.Computation` a PyTorch
function becomes (:mod:`.lower`). A binary op computes in the node's
widened dtype, the type the JAX package's promotion gives it (``int +
double`` is double, ``float + double`` is double), so both packages agree
where torch's own promotion would not.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .. import dtypes as _dt
from ..shape import Shape
from .graph import Graph, Node, current_graph, scope, with_graph

__all__ = [
    "Node", "Graph", "current_graph", "with_graph", "scope",
    "placeholder", "constant", "identity", "add", "sub", "mul", "div",
    "fill", "zeros", "ones",
    "reduce_sum", "reduce_min", "reduce_max", "reduce_mean",
]


def _as_node(x) -> Node:
    if isinstance(x, Node):
        return x
    return constant(x)


def placeholder(dtype: Union[_dt.DType, str], shape,
                name: Optional[str] = None) -> Node:
    """An input node; its name must match a frame column at execution
    (reference ``dsl/package.scala:48-56``)."""
    if isinstance(dtype, str):
        dtype = _dt.by_name(dtype)
    shape = shape if isinstance(shape, Shape) else Shape(tuple(shape))
    return Node("Placeholder", [], dtype, shape, impl=None, name=name)


def constant(value, dtype: Optional[_dt.DType] = None,
             name: Optional[str] = None) -> Node:
    """A captured constant (scalar / vector / matrix), the DenseTensor
    analogue (reference ``dsl/package.scala:68-76``)."""
    arr = np.asarray(value)
    if dtype is None:
        dtype = _dt.from_numpy(arr.dtype)
    if not dtype.tensor:
        raise ValueError(
            f"constant() requires a numeric tensor dtype, got {dtype.name}")
    arr = arr.astype(dtype.np_storage)
    return Node("Const", [], dtype, Shape(arr.shape),
                impl=None, value=arr, name=name)


def identity(x, name: Optional[str] = None) -> Node:
    x = _as_node(x)
    return Node("Identity", [x], x.dtype, x.shape,
                impl=lambda a: a, name=name)


def _binop(op: str, fn, a, b, name: Optional[str] = None) -> Node:
    a, b = _as_node(a), _as_node(b)
    shape = a.shape.broadcast_with(b.shape)
    dtype = _dt.widen(a.dtype, b.dtype)
    dd = _dt.device_dtype(dtype)
    return Node(op, [a, b], dtype, shape,
                impl=lambda x, y: fn(x.to(dd), y.to(dd)), name=name)


def add(a, b, name: Optional[str] = None) -> Node:
    return _binop("Add", lambda x, y: x + y, a, b, name)


def sub(a, b, name: Optional[str] = None) -> Node:
    return _binop("Sub", lambda x, y: x - y, a, b, name)


def mul(a, b, name: Optional[str] = None) -> Node:
    return _binop("Mul", lambda x, y: x * y, a, b, name)


def div(a, b, name: Optional[str] = None) -> Node:
    return _binop("Div", lambda x, y: x / y, a, b, name)


def fill(shape, value, name: Optional[str] = None) -> Node:
    """Tensor of ``shape`` filled with scalar ``value``
    (reference ``dsl/package.scala:93-99``)."""
    sh = shape if isinstance(shape, Shape) else Shape(tuple(shape))
    dims = sh.assert_concrete("fill requires a concrete shape")
    v = _as_node(value)
    if not v.shape.is_scalar:
        raise ValueError("fill value must be scalar")
    return Node("Fill", [v], v.dtype, sh,
                impl=lambda x: x.expand(dims).clone(), name=name)


def zeros(shape, dtype: Union[_dt.DType, str] = _dt.double,
          name: Optional[str] = None) -> Node:
    dt = _coerce(dtype)
    return fill(shape, constant(np.zeros((), dt.np_storage), dtype=dt),
                name=name)


def ones(shape, dtype: Union[_dt.DType, str] = _dt.double,
         name: Optional[str] = None) -> Node:
    dt = _coerce(dtype)
    return fill(shape, constant(np.ones((), dt.np_storage), dtype=dt),
                name=name)


def _coerce(dtype) -> _dt.DType:
    return _dt.by_name(dtype) if isinstance(dtype, str) else dtype


def _reduce(op: str, impl, x, axis, name: Optional[str]) -> Node:
    x = _as_node(x)
    if axis is None:
        shape = Shape.empty
    else:
        ax = axis if axis >= 0 else x.shape.ndim + axis
        if not (0 <= ax < x.shape.ndim):
            raise ValueError(f"reduce axis {axis} out of range for "
                             f"{x.shape!r}")
        shape = Shape(tuple(d for i, d in enumerate(x.shape.dims)
                            if i != ax))
    dims = tuple(range(x.shape.ndim)) if axis is None else axis
    return Node(op, [x], x.dtype, shape,
                impl=lambda a: impl(a, dims), name=name)


def reduce_sum(x, axis: Optional[int] = None,
               name: Optional[str] = None) -> Node:
    """Sum over one axis (or all axes when None), keeping the input dtype
    (reference ``dsl/package.scala:117-123``)."""
    return _reduce("Sum", lambda a, d: torch.sum(a, dim=d).to(a.dtype),
                   x, axis, name)


def reduce_min(x, axis: Optional[int] = None,
               name: Optional[str] = None) -> Node:
    return _reduce("Min", lambda a, d: torch.amin(a, dim=d), x, axis, name)


def reduce_max(x, axis: Optional[int] = None,
               name: Optional[str] = None) -> Node:
    return _reduce("Max", lambda a, d: torch.amax(a, dim=d), x, axis, name)


def reduce_mean(x, axis: Optional[int] = None,
                name: Optional[str] = None) -> Node:
    """Mean over one axis (or all); integer inputs average in double, as
    the JAX package's ``jnp.mean`` does with x64."""
    return _reduce("Mean", lambda a, d: torch.mean(
        a if a.is_floating_point() else a.double(), dim=d), x, axis, name)
