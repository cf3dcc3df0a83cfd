"""Lower DSL node DAGs to the Computation IR.

The port's counterpart of ``tensorframes_tpu/dsl/lower.py`` (the
reference's ``DslImpl.buildGraph`` + ``getClosure``,
``dsl/DslImpl.scala:37-74``): walk the fetch nodes' transitive closure,
turn placeholders into computation inputs, and emit one plain PyTorch
function evaluating the DAG. Fetch node names become output column names;
placeholder names must match frame columns (map ops) or follow the reduce
naming contracts. Constants become tensors on the device of the inputs.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import torch

from ..computation import Computation, TensorSpec
from ..schema import Schema
from .graph import Node

__all__ = ["closure", "lower_nodes", "nodes_to_computation",
           "nodes_to_reduce_computation"]


def _fetch_list(fetches) -> List[Node]:
    if isinstance(fetches, Node):
        return [fetches]
    return list(fetches)


def closure(fetches: Sequence[Node]) -> List[Node]:
    """Transitive parents of the fetches, topologically ordered."""
    seen: Dict[int, Node] = {}
    order: List[Node] = []

    def visit(n: Node):
        if id(n) in seen:
            return
        seen[id(n)] = n
        for p in n.parents:
            visit(p)
        order.append(n)

    for f in fetches:
        visit(f)
    return order


def lower_nodes(fetches: Sequence[Node]):
    """Build ``(placeholders, fn)``: the placeholder nodes and a pure
    dict->dict function evaluating the DAG with torch."""
    fetches = list(fetches)
    nodes = closure(fetches)
    placeholders = [n for n in nodes if n.op == "Placeholder"]

    def fn(inputs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        device = next((v.device for v in inputs.values()
                       if isinstance(v, torch.Tensor)), None)
        vals: Dict[int, torch.Tensor] = {}
        for n in nodes:
            if n.op == "Placeholder":
                vals[id(n)] = torch.as_tensor(inputs[n.name])
            elif n.op == "Const":
                vals[id(n)] = torch.as_tensor(n.value, device=device)
            else:
                vals[id(n)] = n.impl(*[vals[id(p)] for p in n.parents])
        return {f.name: vals[id(f)] for f in fetches}

    return placeholders, fn


def _check_unique_fetches(fetches: Sequence[Node]) -> None:
    names = [f.name for f in fetches]
    if len(set(names)) != len(names):
        raise ValueError(
            f"Could not infer a list of unique names for the output "
            f"columns: {names}")


def nodes_to_computation(fetches, schema: Schema,
                         block_level: bool) -> Computation:
    """DSL fetches -> Computation for the map ops.

    Placeholder shapes declared in the DSL are refined by the frame's
    column metadata when the metadata is more precise (the reference ships
    both and lets the engine reconcile, ``Node.hints`` +
    ``SchemaTransforms``)."""
    fetches = _fetch_list(fetches)
    _check_unique_fetches(fetches)
    placeholders, fn = lower_nodes(fetches)
    specs = []
    for p in placeholders:
        field = schema.get(p.name)
        shape = p.shape
        if field is not None and field.block_shape is not None:
            declared = field.block_shape if block_level \
                else field.block_shape.tail
            if declared.is_more_precise_than(shape):
                shape = declared
        specs.append(TensorSpec(p.name, p.dtype, shape))
    return Computation.trace(fn, specs, takes_dict=True)


def nodes_to_reduce_computation(fetches, schema: Schema,
                                suffixes: Sequence[str],
                                block_level: bool) -> Computation:
    """DSL fetches -> Computation for the reduce ops (the ``z_input`` /
    ``z_1``/``z_2`` contracts are validated by the engine afterwards)."""
    fetches = _fetch_list(fetches)
    _check_unique_fetches(fetches)
    placeholders, fn = lower_nodes(fetches)
    specs = [TensorSpec(p.name, p.dtype, p.shape) for p in placeholders]
    return Computation.trace(fn, specs, takes_dict=True)
