"""Out-of-core frames: the device-memory manager.

The port's counterpart of ``tensorframes_tpu/memory/__init__.py``. Public
surface:

- :func:`manager`: the process :class:`~.manager.MemoryManager` (created
  on first use; budget from ``TFT_MEM_LIMIT_BYTES``, or the card's
  allocator limit x ``TFT_MEM_FRACTION``);
- :func:`active`: the manager IF it has a budget, else ``None``: the
  hot-path gate every integration point checks first, so an unlimited
  process pays one global read per dispatch and nothing else;
- :func:`configure` / :func:`bypass` / :func:`_reset`: explicit control
  for tests and benchmarks;
- :class:`SpillableBuffer` / :class:`SpillableColumns`: the spill
  mechanics;
- :mod:`.persist`: the durable disk tier under the in-memory state
  (preemption checkpoints, result-cache entries; ``TFT_PERSIST_DIR``);
- :class:`QueryCheckpoint`: a preempted query's parked outputs.

Integration map: the block executor admits every dispatch
(``engine/executor.py``: reserve at submit, release at drain, proactive
pre-dispatch split on predicted overflow); pipelined pending blocks
register as spill candidates (their device buffers can be released to
host early); a join's build table registers its device columns (or is
probed in chunks when it outgrows the ledger's resident threshold); a
forced frame's block cache joins the host-side gauge. ``spill`` /
``fault`` / ``proactive_split`` / ``mem_wait`` / ``mem_sync_dispatch``
events join query traces.

The budget is resolved once per process, at first use. A process whose
default device is a card it has not touched yet (no allocator
statistics) resolves again at the next use instead of latching
unlimited, so the card's budget takes effect from the first dispatch
that finds the card initialized.

Not in this package yet: the ``tft_memory_*`` metrics provider (with
``observability/metrics.py``, ``ROADMAP.md`` A11) and the external sort
(with ``dsort``, A10).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Mapping, Optional

from . import persist
from .checkpoint import QueryCheckpoint
from .estimate import (blocks_estimate, frame_estimate, propagate_hints,
                       schema_row_bytes)
from .manager import MemoryManager
from .spill import (SpillableBuffer, SpillableColumns, array_nbytes,
                    host_value, is_device_value, to_pinned_host,
                    value_nbytes)

__all__ = [
    "MemoryManager", "manager", "active", "configure", "bypass",
    "SpillableBuffer", "SpillableColumns", "spillable_columns",
    "frame_estimate", "propagate_hints", "blocks_estimate",
    "schema_row_bytes", "array_nbytes", "host_value", "value_nbytes",
    "is_device_value", "to_pinned_host", "note_frame_cache",
    "forget_frame_cache", "QueryCheckpoint", "persist",
]

_lock = threading.Lock()
_manager: Optional[MemoryManager] = None
_active: Optional[MemoryManager] = None
_resolved = False


def _card_untouched() -> bool:
    """True when the default device is a card whose allocator has not been
    initialized yet: its budget cannot be read until it has."""
    import torch

    from ..device import default_device
    return (default_device().type == "cuda" and torch.cuda.is_available()
            and not torch.cuda.is_initialized())


def _resolve() -> None:
    global _manager, _active, _resolved
    with _lock:
        if _resolved:
            return
        m = MemoryManager()
        _manager = m
        _active = m if m.limited else None
        _resolved = m.limited or not _card_untouched()


def manager() -> MemoryManager:
    """The process memory manager (created on first use)."""
    if not _resolved:
        _resolve()
    return _manager


def active() -> Optional[MemoryManager]:
    """The manager when it has a budget, else ``None``: the zero-cost
    gate (unlimited processes take one global read per call)."""
    if not _resolved:
        _resolve()
    return _active


def configure(limit_bytes: Optional[int] = None,
              spill: Optional[bool] = None) -> MemoryManager:
    """Install a fresh manager with an explicit budget (tests and
    benchmarks; production uses the env knobs). ``limit_bytes=None``
    re-reads ``TFT_MEM_LIMIT_BYTES`` / the card's budget; ``0`` means
    explicitly unlimited. Returns the new manager."""
    global _manager, _active, _resolved
    with _lock:
        if limit_bytes == 0:
            m = MemoryManager(limit_bytes=-1, spill=spill)
        else:
            m = MemoryManager(limit_bytes=limit_bytes, spill=spill)
        _manager = m
        _active = m if m.limited else None
        _resolved = True
    return m


def _reset() -> None:
    """Drop the singleton so the next use re-reads the environment
    (tests monkeypatching ``TFT_MEM_LIMIT_BYTES`` call this)."""
    global _manager, _active, _resolved
    with _lock:
        _manager = None
        _active = None
        _resolved = False


@contextlib.contextmanager
def bypass():
    """Temporarily disable the memory manager entirely (benchmarks
    measuring the ledger's own overhead)."""
    global _active
    if not _resolved:
        _resolve()
    with _lock:
        prev, _active = _active, None
    try:
        yield
    finally:
        with _lock:
            _active = prev


def spillable_columns(name: str, cols: Mapping[str, Any],
                      mgr: Optional[MemoryManager] = None):
    """Wrap a column mapping as a registered LRU spill candidate when a
    budget is active; returns the mapping unchanged otherwise."""
    m = mgr if mgr is not None else active()
    if m is None or not m.spill_enabled:
        return cols if isinstance(cols, dict) else dict(cols)
    wrapped = SpillableColumns(name, cols, m)
    m.register(wrapped)
    return wrapped


def note_frame_cache(frame) -> None:
    """Record a frame's forced block cache for the host-side gauge."""
    m = active()
    if m is not None:
        m.note_frame_cache(frame)


def forget_frame_cache(frame) -> None:
    m = _active
    if m is not None:
        m.forget_frame_cache(frame)
