"""Checkpoint / resume for train states and parameter trees.

The port's counterpart of ``tensorframes_tpu/utils/checkpoint.py``, with
``torch.save`` where the JAX package uses Orbax:

 - :func:`save` writes a tree (dicts, lists and tuples) of tensors, numpy
   arrays, numpy scalars and plain Python values to ``path``, a directory
   holding one ``state.pt``. It is written under a temporary name and
   renamed into place, so a crash never leaves a torn checkpoint under the
   final name;
 - :func:`restore` reads it back with ``torch.load(weights_only=True)``:
   without a template every leaf comes back to the host (tensors as CPU
   tensors, numpy leaves as numpy), with ``like`` every leaf takes the
   device and dtype of the matching leaf of ``like`` (resume on the card);
 - :func:`save_step`, :func:`latest_step` and :func:`restore_step` keep
   stepped checkpoints as ``root/step_<8 digits>``, the JAX package's
   layout.

Numpy leaves are stored as tensors marked as numpy, since ``weights_only``
loading refuses numpy objects; they come back as numpy. A mesh column
(``parallel.distributed.ShardedArray``) is stored shard by shard and
restored onto the shards of its template. When the state holds columns of
a cluster mesh (``parallel.cluster``), every process saves and restores
together: each writes only its own shards, into ``state-p<i>of<n>.pt`` of
the same directory, and reads only its own back; barriers order the
writes before the rename into place and the rename before any process
returns, so no process reads before every process has written.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from .logging import get_logger

__all__ = ["save", "restore", "latest_step", "save_step", "restore_step"]

_log = get_logger("utils.checkpoint")

_FILE = "state.pt"
_NUMPY = "__tft_numpy__"  # a numpy leaf: {_NUMPY: tensor}
_SHARDED = "__tft_sharded__"  # a mesh column: {_SHARDED: {shards, ...}}


def _sharded_type():
    from ..parallel.distributed import ShardedArray
    return ShardedArray


def _cluster_group(tree: Any):
    """The cluster group of the first cluster mesh column in ``tree``."""
    if isinstance(tree, _sharded_type()):
        return tree.cluster.group if tree.cluster is not None else None
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            g = _cluster_group(v)
            if g is not None:
                return g
    return None


def _layout(a) -> dict:
    """Where a mesh column's shards lie: the shards held here and every
    shard's rows."""
    held = (a.cluster.local_shards() if a.cluster is not None
            else list(range(len(a.shards))))
    return {"index": held,
            "rows": list(a.rows) if a.rows is not None
            else [int(t.shape[0]) for t in a.shards]}


def _encode(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, _sharded_type()):
        return {_SHARDED: {"shards": [t.detach() for t in x.shards],
                           **_layout(x)}}
    if isinstance(x, (np.ndarray, np.generic)):
        return {_NUMPY: torch.from_numpy(np.array(x))}
    if isinstance(x, dict):
        return {k: _encode(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_encode(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"checkpoint.save: cannot store a leaf of type "
                    f"{type(x).__name__}")


def _decode(x: Any, like: Any, where: str) -> Any:
    if isinstance(x, dict) and set(x) == {_SHARDED}:
        rec = x[_SHARDED]
        cls = _sharded_type()
        if like is None:
            return cls(rec["shards"])
        if not isinstance(like, cls):
            raise ValueError(f"checkpoint.restore: {where} holds a mesh "
                             f"column, the template a "
                             f"{type(like).__name__}")
        want = _layout(like)
        if want != {"index": rec["index"], "rows": rec["rows"]}:
            raise ValueError(
                f"checkpoint.restore: {where} was saved from shards "
                f"{rec['index']} of rows {rec['rows']}, the template holds "
                f"shards {want['index']} of rows {want['rows']}")
        return like.like([t.to(device=ref.device, dtype=ref.dtype)
                          for t, ref in zip(rec["shards"], like.shards)])
    if isinstance(x, dict) and set(x) == {_NUMPY}:
        x = x[_NUMPY]
        if like is None:
            return x.numpy()
    if isinstance(x, torch.Tensor):
        if like is None:
            return x
        if isinstance(like, torch.Tensor):
            return x.to(device=like.device, dtype=like.dtype)
        if isinstance(like, (np.ndarray, np.generic)):
            return x.numpy().astype(like.dtype)
        raise ValueError(f"checkpoint.restore: {where} holds a tensor, the "
                         f"template a {type(like).__name__}")
    if isinstance(x, dict):
        if like is not None and (not isinstance(like, dict)
                                 or set(like) != set(x)):
            raise ValueError(f"checkpoint.restore: {where} does not match "
                             f"the template's keys")
        return {k: _decode(v, None if like is None else like[k],
                           f"{where}[{k!r}]") for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        if like is not None and len(like) != len(x):
            raise ValueError(f"checkpoint.restore: {where} has {len(x)} "
                             f"items, the template {len(like)}")
        return type(x)(_decode(v, None if like is None else like[i],
                               f"{where}[{i}]") for i, v in enumerate(x))
    return x


def _barrier(group) -> None:
    import torch.distributed as tdist

    tdist.barrier(group=group.pg)


def _process_file(group) -> str:
    return f"state-p{group.rank}of{group.size}.pt"


def save(path: str, state: Any) -> None:
    """Save a tree of tensors and arrays to ``path`` (a directory, replaced
    whole if it exists). A state holding cluster mesh columns is saved by
    every process together, each writing its own shards."""
    path = os.path.abspath(path)
    group = _cluster_group(state)
    if group is not None:
        _save_cluster(path, state, group)
        return
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, _FILE), "wb") as f:
        torch.save(_encode(state), f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        old = f"{path}.old-{os.getpid()}"
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, path)
    _log.debug("checkpoint saved to %s", path)


def _save_cluster(path: str, state: Any, group) -> None:
    """Every process writes its own file into one temporary directory,
    then rank 0 renames it into place (barriers between the steps)."""
    tmp = f"{path}.tmp"
    _barrier(group)
    if group.rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    _barrier(group)
    with open(os.path.join(tmp, _process_file(group)), "wb") as f:
        torch.save(_encode(state), f)
        f.flush()
        os.fsync(f.fileno())
    _barrier(group)
    if group.rank == 0:
        if os.path.exists(path):
            old = f"{path}.old"
            shutil.rmtree(old, ignore_errors=True)
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, path)
    _barrier(group)
    _log.debug("checkpoint saved to %s (process %d of %d)", path,
               group.rank, group.size)


def restore(path: str, like: Optional[Any] = None) -> Any:
    """Restore a tree from ``path``.

    With ``like`` (a matching tree, e.g. a freshly built train state),
    every leaf is restored onto the device and into the dtype of the
    matching leaf, a mesh column onto its template's shards. Without it,
    leaves come back to the host. A process of a cluster reads its own
    file (its own shards) only."""
    path = os.path.abspath(path)
    group = _cluster_group(like)
    name = _process_file(group) if group is not None else _FILE
    tree = torch.load(os.path.join(path, name), map_location="cpu",
                      weights_only=True)
    return _decode(tree, like, "state")


# -- stepped checkpoints (train loops) --------------------------------------

def _step_path(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"step_{step:08d}")


def save_step(root: str, step: int, state: Any) -> str:
    """Save under ``root/step_<n>``; returns the checkpoint path."""
    path = _step_path(root, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save(path, state)
    return path


def latest_step(root: str) -> Optional[int]:
    """Highest step saved under ``root``, or None."""
    root = os.path.abspath(root)
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_"):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore_step(root: str, state_like: Optional[Any] = None,
                 step: Optional[int] = None):
    """Restore ``(state, step)`` from ``root`` (latest step by default);
    returns ``(None, None)`` when nothing is saved — the cold-start case a
    resume-capable driver loop checks first."""
    if step is None:
        step = latest_step(root)
    if step is None:
        return None, None
    return restore(_step_path(root, step), like=state_like), step
