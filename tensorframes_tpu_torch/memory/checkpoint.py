"""Preemption checkpoints: parked block outputs, moved off the device.

The port's counterpart of ``tensorframes_tpu/memory/checkpoint.py``. When
a running query is preempted at a block boundary, the pipelined stream
has already drained some blocks and is about to give up the rest of its
window. Throwing the drained work away would make preemption cost a full
re-run; keeping it on the card would defeat the point of preempting (the
preemptor needs the memory). A :class:`QueryCheckpoint` is the middle
path:

- **completed block outputs are parked**: containers (``Block`` /
  ``dict``) are walked and every device tensor moves to a pinned host
  buffer through the spill machinery (:func:`~.spill.spill_value`:
  bit-identical per dtype, its device and dtype recorded), counted
  through the active ledger's spill accounting (``memory.spills`` /
  ``checkpoint:<query>`` events). Host numpy and ride-along values are
  kept by reference: they were never device bytes.
- **a cursor into the plan's block sequence**: the parked output count
  IS the cursor; on resume the stream restores the parked outputs (back
  to their devices, counted as ledger faults) and re-dispatches only the
  remaining blocks, bit-identical to an uninterrupted run because each
  block's computation is deterministic and the restored outputs
  round-tripped bit for bit.

A checkpoint holds at most ONE parked stream: forcing is sequential, so
the preempted query has exactly one stream in flight, and every upstream
stream's results are already cached on their frames. On resume the first
stream whose block count and tag match restores; a mismatch (the plan
changed under the query) discards the checkpoint and re-runs from
scratch: never wrong, at worst cold (``serve.checkpoint_discards``).

With the persist tier on (``TFT_PERSIST_DIR``), every park is written
through to disk (:func:`~.persist.save_checkpoint`), as numpy.

Cancellation (:meth:`QueryCheckpoint.free`) drops the parked buffers.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

from ..utils.logging import get_logger
from ..utils.tracing import counters
from . import spill as _spill

__all__ = ["QueryCheckpoint"]

_log = get_logger("memory.checkpoint")


def _park(v: Any, stats: dict) -> Tuple:
    """One output value -> a host-only parked form. Tags keep the
    structure reconstructible without constructing Blocks over
    placeholder values."""
    from ..frame import Block
    if isinstance(v, Block):
        return ("block", {k: _park(c, stats)
                          for k, c in v.columns.items()}, v.num_rows)
    if isinstance(v, dict):
        return ("dict", {k: _park(c, stats) for k, c in v.items()})
    if _spill.is_device_value(v):
        stats["moved"] += _spill.array_nbytes(v)
        return ("dev",) + _spill.spill_value(v)
    return ("raw", v)  # host numpy / lists / scalars: kept by reference


def _restore(t: Tuple) -> Any:
    kind = t[0]
    if kind == "block":
        from ..frame import Block
        return Block({k: _restore(c) for k, c in t[1].items()}, t[2])
    if kind == "dict":
        return {k: _restore(c) for k, c in t[1].items()}
    if kind == "dev":
        return _spill.restore_value(t[1:])
    return t[1]


class QueryCheckpoint:
    """Parked outputs + cursor of one preempted query (module docstring).

    Created lazily by the preemption scope on the first park; carried
    between the preempt and the resume; freed on any terminal state.
    """

    __slots__ = ("query_id", "parked_blocks", "moved_bytes", "_parked")

    def __init__(self, query_id: str):
        self.query_id = query_id
        # (values, total blocks, stream tag)
        self._parked: Optional[Tuple[List[Tuple], int, str]] = None
        self.parked_blocks = 0
        self.moved_bytes = 0

    @property
    def empty(self) -> bool:
        return self._parked is None

    def park_stream(self, outputs: Sequence[Any], total: int,
                    tag: str = "stream") -> int:
        """Park ``outputs`` (the stream's first ``len(outputs)`` drained
        results, FIFO order) with cursor ``total`` blocks under stream
        identity ``tag``. Returns the device bytes moved to host."""
        stats = {"moved": 0}
        vals = [_park(v, stats) for v in outputs]
        self._parked = (vals, int(total), str(tag))
        self.parked_blocks = len(vals)
        self.moved_bytes = int(stats["moved"])
        if self.moved_bytes:
            from . import active as _active
            m = _active()
            if m is not None:
                m.note_spill(self.moved_bytes,
                             f"checkpoint:{self.query_id}")
        counters.inc("pipeline.parked_blocks", len(vals))
        from . import persist as _persist
        if _persist.enabled():
            # write-through to the durable tier: a crash of THIS process
            # can resume the query in another one; best-effort, a failed
            # write degrades to a cold re-run
            _persist.save_checkpoint(self.query_id, self._parked,
                                     self.parked_blocks, self.moved_bytes)
        return self.moved_bytes

    def resume_stream(self, total: int,
                      tag: str = "stream") -> Optional[List[Any]]:
        """The parked outputs when ``total`` AND the stream ``tag`` match
        the parked record, else ``None`` (and the checkpoint is discarded:
        a mismatched stream means the execution path changed under the
        query, e.g. a fused plan falling back per-op; re-running from
        scratch is correct, resuming a different stream's outputs would
        not be)."""
        if self._parked is None:
            return None
        vals, t, parked_tag = self._parked
        self._parked = None
        if t != int(total) or parked_tag != str(tag) or len(vals) > t:
            counters.inc("serve.checkpoint_discards")
            _log.warning(
                "checkpoint of query %s parked %d/%d block(s) of stream "
                "%r but the resumed stream is %r over %d block(s); "
                "discarding and re-running from scratch",
                self.query_id, len(vals), t, parked_tag, tag, total)
            self.parked_blocks = 0
            self.moved_bytes = 0
            return None
        restored = [_restore(v) for v in vals]
        if self.moved_bytes:
            from . import active as _active
            m = _active()
            if m is not None:
                m.note_fault(self.moved_bytes,
                             f"checkpoint:{self.query_id}")
        self.parked_blocks = 0
        self.moved_bytes = 0
        return restored

    def free(self) -> None:
        """Drop the parked buffers (cancellation, terminal states)."""
        self._parked = None
        self.parked_blocks = 0
        self.moved_bytes = 0

    def __repr__(self):
        state = (f"{self.parked_blocks} block(s) parked"
                 if self._parked is not None else "empty")
        return f"QueryCheckpoint({self.query_id!r}, {state})"
