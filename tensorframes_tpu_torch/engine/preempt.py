"""Preemption tokens: cooperative query interruption at block boundaries.

The port's counterpart of ``tensorframes_tpu/engine/preempt.py``. A
caller sharing a card needs two things the engine could not do:
**cancel** a running query, and **preempt** a long one so that another
query runs now instead of after it. Both are cooperative: the pipeline's
submit/drain split gives every query natural yield points at block
boundaries, and killing a kernel mid-flight is neither possible nor
desirable. This module is the token that crosses into the engine:

- the caller (the JAX package's serving scheduler; ``ROADMAP.md`` A11 in
  the port) activates a :class:`PreemptionScope` (a contextvar) around a
  query's forcing and flips ``request_cancel`` / ``request_preempt`` from
  any thread;
- :func:`~.pipeline.run_pipelined` polls the scope between submits
  (:func:`boundary`): a cancel raises a classified
  :class:`~..resilience.QueryCancelled`; a preempt first **drains the
  in-flight window** (blocks are never killed mid-dispatch), then parks
  the completed outputs as a
  :class:`~..memory.checkpoint.QueryCheckpoint` (:func:`park`) and
  raises :class:`~..resilience.QueryPreempted` for the caller to
  re-queue;
- on resume the caller re-activates the scope with the checkpoint and
  the stream restores the parked outputs (:func:`resume_stream`),
  re-dispatching only the remaining blocks: bit-identical to an
  uninterrupted run.

The deterministic ``preempt`` fault site (``TFT_FAULTS=preempt:N``)
drives this path without a concurrent preemptor: :func:`boundary`
converts the injected fault into a preempt request. The ``worker`` site
of the JAX package (a park that doubles as a worker crash) comes with
the serving fabric (A11).

Zero-cost when idle: with no scope active, the engine pays one
contextvar read per stream (not per block).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Iterator, List, Optional, Sequence

from ..observability import events as _obs
from ..observability import flight as _flight
from ..resilience import QueryCancelled, QueryPreempted
from ..resilience import faults as _faults
from ..utils.logging import get_logger
from ..utils.tracing import counters

__all__ = ["PreemptionScope", "current_scope", "activate", "boundary",
           "park", "resume_stream"]

_log = get_logger("engine.preempt")

_scope: "contextvars.ContextVar[Optional[PreemptionScope]]" = \
    contextvars.ContextVar("tft_preempt_scope", default=None)


class PreemptionScope:
    """One query's preemption token + checkpoint carrier.

    Request flags are sticky until consumed: ``request_preempt`` is
    cleared when the stream parks (or when the query completes first —
    a preempt racing natural completion is a no-op); ``request_cancel``
    is never cleared (a cancelled query must not resume).
    """

    __slots__ = ("query_id", "checkpoint", "reason", "_cancel", "_preempt",
                 "_lock", "_tag_counts")

    def __init__(self, query_id: str, checkpoint=None):
        self.query_id = query_id
        self.checkpoint = checkpoint  # QueryCheckpoint or None
        self.reason = ""
        self._cancel = False
        self._preempt = False
        self._lock = threading.Lock()
        # per-run-attempt ordinal of each stream tag: counts restart at 0
        # on each attempt (park clears them), which is what makes the
        # ordinal a usable identity (see stream_ordinal)
        self._tag_counts: dict = {}

    def stream_ordinal(self, tag: str) -> int:
        """The 0-based index of this stream among same-tag streams of
        THIS run attempt. Tags are structural (op + comp in/out names
        + input plan) and can collide between near-identical sibling
        streams; the ordinal disambiguates them: a checkpoint parked as
        the Nth same-tag stream only restores into the Nth same-tag
        stream of the resumed run. A thunk that rebuilds its whole
        chain per call (losing upstream frame caches) shifts ordinals
        on resume — the mismatch then DISCARDS the checkpoint (cold
        re-run) instead of restoring a sibling's outputs (wrong
        data)."""
        n = self._tag_counts.get(tag, 0)
        self._tag_counts[tag] = n + 1
        return n

    # -- requests (any thread) --------------------------------------------
    def request_cancel(self, reason: str = "") -> None:
        with self._lock:
            self._cancel = True
            if reason:
                self.reason = reason

    def request_preempt(self, reason: str = "") -> None:
        with self._lock:
            if not self._cancel:
                self._preempt = True
                if reason:
                    self.reason = reason

    @property
    def cancel_requested(self) -> bool:
        return self._cancel

    @property
    def preempt_requested(self) -> bool:
        return self._preempt

    def _take_preempt(self) -> None:
        with self._lock:
            self._preempt = False

    def ensure_checkpoint(self):
        if self.checkpoint is None:
            from ..memory.checkpoint import QueryCheckpoint
            self.checkpoint = QueryCheckpoint(self.query_id)
        return self.checkpoint

    def __repr__(self):
        flags = []
        if self._cancel:
            flags.append("cancel")
        if self._preempt:
            flags.append("preempt")
        return (f"PreemptionScope({self.query_id!r}, "
                f"requested={'+'.join(flags) or 'none'})")


def current_scope() -> Optional[PreemptionScope]:
    return _scope.get()


@contextlib.contextmanager
def activate(scope: PreemptionScope) -> Iterator[PreemptionScope]:
    """Make ``scope`` the ambient preemption token for this thread's
    forcing (nested activations are a bug — one scope per query)."""
    token = _scope.set(scope)
    try:
        yield scope
    finally:
        _scope.reset(token)


def boundary(scope: PreemptionScope, progressed: bool = True) -> bool:
    """One block-boundary poll. Raises
    :class:`~..resilience.QueryCancelled` on a pending cancel; returns
    True when the caller should park and raise (preempt pending).

    ``progressed`` is False at the degenerate boundary before any block
    of this run has started: real requests are honored there (yielding
    with an empty prefix is correct), but the injected ``preempt``
    fault site only fires after strict progress — so every
    ``TFT_FAULTS=preempt:N``-driven preemption parks at a strictly
    later cursor than the last, and the drive always converges."""
    if scope.cancel_requested:
        cp = scope.checkpoint
        if cp is not None:
            cp.free()  # a cancelled query never resumes
        counters.inc("pipeline.cancelled_streams")
        # emitted HERE (the victim's thread) so the event lands in the
        # cancelled query's own trace, not the canceller's
        _obs.add_event("cancel", name=scope.query_id,
                       reason=scope.reason or "requested")
        _flight.record("preempt.cancel", query=scope.query_id,
                       reason=scope.reason or "requested")
        raise QueryCancelled(
            f"query {scope.query_id} cancelled at a block boundary"
            + (f" ({scope.reason})" if scope.reason else ""))
    if progressed and _faults.may_fire("preempt"):
        try:
            _faults.check("preempt")
        except _faults.InjectedFault as e:
            scope.request_preempt(f"injected fault: {e}")
    return scope.preempt_requested


def park(scope: PreemptionScope, outputs: Sequence, total: int,
         tag: Optional[str] = None):
    """Park ``outputs`` (the drained prefix of a ``total``-block stream)
    on the scope's checkpoint and raise
    :class:`~..resilience.QueryPreempted`. The caller has already
    drained its in-flight window. ``tag`` identifies the logical
    stream so a resume down a DIFFERENT execution path (e.g. a fused
    plan that fell back per-op between runs) can never restore the
    wrong stream's outputs. A tagless stream (``None`` — e.g. an
    ad-hoc ``PipelinedExecutor.map``) has no stable identity to resume
    into, so it yields WITHOUT checkpointing: two anonymous streams of
    equal length must never restore each other's outputs, and a full
    re-run is always correct."""
    scope._take_preempt()
    # this run attempt ends here: same-tag ordinals restart on the next
    # attempt (a caller may reuse its scope across the park and its
    # resume)
    scope._tag_counts.clear()
    if tag is None:
        counters.inc("pipeline.preempted_streams")
        _obs.add_event("preempt_park", name=scope.query_id, blocks=0,
                       total=int(total), bytes=0,
                       reason=scope.reason or "requested")
        _flight.record("preempt.park", query=scope.query_id, blocks=0,
                       total=int(total), bytes=0, anonymous=True,
                       reason=scope.reason or "requested")
        _log.info("query %s preempted at an anonymous stream boundary "
                  "%d/%d (%s); no checkpoint — resume re-runs it",
                  scope.query_id, len(outputs), total,
                  scope.reason or "requested")
        raise QueryPreempted(
            f"query {scope.query_id} preempted (anonymous stream, "
            f"no checkpoint)"
            + (f" ({scope.reason})" if scope.reason else ""))
    moved = scope.ensure_checkpoint().park_stream(outputs, total, tag)
    counters.inc("pipeline.preempted_streams")
    _obs.add_event("preempt_park", name=scope.query_id,
                   blocks=len(outputs), total=int(total), bytes=moved,
                   reason=scope.reason or "requested")
    _flight.record("preempt.park", query=scope.query_id,
                   blocks=len(outputs), total=int(total), bytes=moved,
                   reason=scope.reason or "requested")
    _log.info("query %s preempted at block boundary %d/%d (%s); %d B "
              "moved off-device", scope.query_id, len(outputs), total,
              scope.reason or "requested", moved)
    raise QueryPreempted(
        f"query {scope.query_id} preempted at block boundary "
        f"{len(outputs)}/{total}"
        + (f" ({scope.reason})" if scope.reason else ""))


def resume_stream(scope: PreemptionScope, total: int,
                  tag: Optional[str] = None) -> Optional[List]:
    """Restore a parked stream's outputs (the resume half); ``None``
    when nothing is parked, the parked stream does not match, or the
    stream is anonymous (``tag=None`` never parks, so it never
    restores)."""
    if tag is None:
        return None
    cp = scope.checkpoint
    if cp is None or cp.empty:
        return None
    restored = cp.resume_stream(total, tag)
    if restored:
        counters.inc("pipeline.resumed_blocks", len(restored))
        _obs.add_event("resume", name=scope.query_id,
                       blocks=len(restored), total=int(total))
        _flight.record("preempt.resume", query=scope.query_id,
                       blocks=len(restored), total=int(total))
        _log.info("query %s resumed: %d/%d block(s) restored from its "
                  "checkpoint; re-dispatching the rest",
                  scope.query_id, len(restored), total)
    return restored
