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
loading refuses numpy objects; they come back as numpy.
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


def _encode(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach()
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


def save(path: str, state: Any) -> None:
    """Save a tree of tensors and arrays to ``path`` (a directory, replaced
    whole if it exists)."""
    path = os.path.abspath(path)
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


def restore(path: str, like: Optional[Any] = None) -> Any:
    """Restore a tree from ``path``.

    With ``like`` (a matching tree, e.g. a freshly built train state),
    every leaf is restored onto the device and into the dtype of the
    matching leaf. Without it, leaves come back to the host."""
    path = os.path.abspath(path)
    tree = torch.load(os.path.join(path, _FILE), map_location="cpu",
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
