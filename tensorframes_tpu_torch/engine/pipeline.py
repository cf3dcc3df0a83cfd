"""Pipelined block execution: overlap H2D copies, compute and D2H copies.

The port's counterpart of ``tensorframes_tpu/engine/pipeline.py``. A
bounded window of **in-flight blocks**: block *k+1*'s host->device copy is
enqueued while block *k* computes and block *k-1* copies back. There are no
threads: the executor's ``submit`` half enqueues pinned non-blocking copies
and the computation's kernels on the current CUDA stream and records a CUDA
event after the device->host copies; ``drain`` waits on that event before
the host reads the outputs (a pinned buffer read before its event completes
would hold stale data).

At most ``TFT_PIPELINE_DEPTH`` blocks (default 3) are in flight, drained
strictly FIFO, so output order is preserved. Depth 1 (or a single-block
stream) runs the ops' serial per-block function in a plain loop, which is
bit-identical to the serial engine.

Resilience composition: the async fast path has no retry loop of its own.
A failure at submit (where an eager OOM surfaces, at the allocation) or at
the drain is attributed to its block, and that block re-runs synchronously
through ``executor.run``, and so through the retry and the OOM row split
(``pipeline.sync_fallbacks``, counted by ``PendingBlock.drain``). An
executor without a ``submit`` half runs its blocks eagerly at submit
through :class:`ReadyResult`.

Preemption composition: when the caller activates a
:class:`~.preempt.PreemptionScope` around a forcing, the stream polls it
between submits. A cancel raises a classified ``QueryCancelled`` at the
boundary (the undrained window is let go: its blocks' device buffers are
released with it); a preempt drains the in-flight window, parks the
drained prefix as a ``QueryCheckpoint`` (``memory/checkpoint.py``), and
raises ``QueryPreempted``. On resume the parked outputs restore and only
the remaining blocks dispatch (``pipeline.resumed_blocks``). A stream is
checkpointed only under its ``tag``: a tagless stream yields without one
and re-runs whole. With no scope active the cost is one contextvar read
per stream.

Observability: ``pipeline.submitted`` / ``pipeline.drained`` are
always-on counters; the window's occupancy is sampled into the
``pipeline.occupancy`` gauge at every submit, and submit and drain run in
``pipeline.submit`` / ``pipeline.drain`` spans, when tracing is on. With a
query trace open each block records ``block_submit`` / ``block_compute`` /
``block_drain`` events on its in-flight slot's track (``block_run`` at
depth 1), an ``occupancy`` sample per submit and the card's memory
watermark at each drain.

Not in this package yet: the serving layer's slot pool
(``SlotPool``/``install_slot_pool``, ``ROADMAP.md`` A11).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional, Sequence, TypeVar

from ..observability import device as _obs_device
from ..observability import events as _obs
from ..resilience import env_int
from ..utils.tracing import counters, gauge, span
from . import preempt as _preempt

__all__ = ["DEFAULT_DEPTH", "pipeline_depth", "stream_depth", "submit",
           "run_pipelined", "ReadyResult", "PipelinedExecutor"]

DEFAULT_DEPTH = 3

B = TypeVar("B")
R = TypeVar("R")


def pipeline_depth(explicit: Optional[int] = None) -> int:
    """The in-flight block window: ``explicit`` if given, else
    ``TFT_PIPELINE_DEPTH`` (default 3), floored at 1 (depth 1 = serial).
    Re-read per stream."""
    d = explicit if explicit is not None \
        else env_int("TFT_PIPELINE_DEPTH", DEFAULT_DEPTH)
    return max(1, d)


class ReadyResult:
    """A pending that drains to a value already in hand: the fallback for
    an executor without a ``submit`` half, whose block runs eagerly (and
    through that executor's own recovery) at submit time."""

    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    def drain(self):
        return self._value


def stream_depth(executor) -> Optional[int]:
    """The depth an executor pins for op-internal streams: a
    :class:`PipelinedExecutor` carries its own, anything else defers to
    ``TFT_PIPELINE_DEPTH`` (None)."""
    if isinstance(executor, PipelinedExecutor):
        return executor.depth
    return None


def submit(executor, comp, arrays, row_local: bool = False):
    """Submit one block on ``executor``: its async ``submit`` half when it
    has one, else an eager :class:`ReadyResult`. Returns an object with
    ``drain()``. ``row_local`` is the op's say that the program is
    row-local, so that an OOM'd block may split."""
    sub = getattr(executor, "submit", None)
    if sub is not None:
        return sub(comp, arrays, row_local=row_local)
    return ReadyResult(executor.run(comp, arrays, row_local=row_local))


def run_pipelined(blocks: Sequence[B],
                  serial_fn: Callable[[B], R],
                  submit_fn: Callable[[B], object],
                  drain_fn: Callable[[object, B], R],
                  depth: Optional[int] = None,
                  executor=None, tag: Optional[str] = None) -> List[R]:
    """Run a block stream through a bounded in-flight window, in order.

    ``serial_fn(b)`` is the serial per-block function, used verbatim when
    the effective depth is 1 or the stream has at most one block.
    ``submit_fn(b)`` starts a block (returns a pending with ``drain()``,
    or any finished value the paired ``drain_fn`` recognizes);
    ``drain_fn(pending, b)`` completes it. Drains are strictly FIFO.
    ``executor`` is the one the blocks run on: a traced drain samples the
    memory watermark of its device (``observability.device.sample``).
    ``tag`` names the logical stream for preemption checkpoints
    (``engine/preempt.py``): a checkpoint parked here only ever restores
    into a stream with the SAME tag and block count. Untagged streams
    (``None``) are still preemptible but never checkpoint.
    """
    blocks = list(blocks)
    d = pipeline_depth(depth)
    trace = _obs.current_trace()
    scope = _preempt.current_scope()
    device = None
    if trace is not None and hasattr(executor, "resolve"):
        device = executor.resolve()
    start = 0
    restored: Optional[List[R]] = None
    if scope is not None:
        if tag is not None:
            # disambiguate same-tag sibling streams within one run
            # attempt: the Nth same-tag stream parked only ever restores
            # into the Nth same-tag stream of the resume
            tag = f"{tag}#{scope.stream_ordinal(tag)}"
        # resume: a parked checkpoint restores the drained prefix and the
        # stream dispatches only the remaining blocks
        restored = _preempt.resume_stream(scope, len(blocks), tag)
        if restored:
            start = len(restored)
    if d <= 1 or len(blocks) - start <= 1:
        if trace is None and scope is None:
            return [serial_fn(b) for b in blocks]
        out0: List[R] = list(restored or ())
        for i in range(start, len(blocks)):
            b = blocks[i]
            if scope is not None and _preempt.boundary(scope, i > start):
                _preempt.park(scope, out0, len(blocks), tag)  # raises
            if trace is None:
                out0.append(serial_fn(b))
                continue
            rows, nbytes = _obs.block_meta(b)
            t0 = trace.clock()
            r = serial_fn(b)
            rows_out, _ = _obs.block_meta(r)
            trace.add("block_run", name=f"block {i}", ts=t0,
                      dur=trace.clock() - t0, track=1, block=i,
                      rows=rows, bytes=nbytes, rows_out=rows_out)
            out0.append(r)
        return out0

    out: List[R] = list(restored or ())
    # window entries: (pending, block, index, submit_end_ts)
    window: "deque" = deque()

    def drain_one() -> None:
        pending, b, i, t_sub = window.popleft()
        slot = i % d + 1
        t0 = 0.0
        if trace is not None:
            t0 = trace.clock()
            # the block's in-flight residency: submit end -> drain start
            trace.add("block_compute", name=f"compute b{i}", ts=t_sub,
                      dur=max(t0 - t_sub, 0.0), track=slot, block=i)
        with span("pipeline.drain"):
            result = drain_fn(pending, b)
        out.append(result)
        counters.inc("pipeline.drained")
        if trace is not None:
            rows_out, _ = _obs.block_meta(result)
            trace.add("block_drain", name=f"drain b{i}", ts=t0,
                      dur=trace.clock() - t0, track=slot, block=i,
                      rows_out=rows_out)
            _obs_device.sample(trace, "block_drain", device=device)

    pending = None
    try:
        for i in range(start, len(blocks)):
            b = blocks[i]
            if scope is not None and _preempt.boundary(scope, i > start):
                # preempt: finish what is in flight (never kill a
                # dispatched block), park the drained prefix, raise
                while window:
                    drain_one()
                _preempt.park(scope, out, len(blocks), tag)  # raises
            t0 = 0.0
            rows = nbytes = None
            if trace is not None:
                rows, nbytes = _obs.block_meta(b)
                t0 = trace.clock()
            with span("pipeline.submit"):
                pending = submit_fn(b)
            t1 = trace.clock() if trace is not None else 0.0
            window.append((pending, b, i, t1))
            counters.inc("pipeline.submitted")
            gauge("pipeline.occupancy", len(window))
            if trace is not None:
                trace.add("block_submit", name=f"submit b{i}", ts=t0,
                          dur=t1 - t0, track=i % d + 1, block=i, rows=rows,
                          bytes=nbytes)
                trace.add("occupancy", value=len(window))
            if len(window) >= d:
                drain_one()
        while window:
            drain_one()
    finally:
        # a stream unwinding mid-window (a cancel, a failed drain) lets
        # its undrained blocks go here, not when the exception is
        # collected: their device buffers return to the allocator
        window.clear()
        pending = None
    return out


class PipelinedExecutor:
    """A block-stream runner bound to an inner executor and a depth::

        pex = PipelinedExecutor(default_executor(), depth=4)
        results = pex.map(block_arrays, comp)   # ordered host dicts

    ``run`` delegates to the inner executor unchanged, so a
    ``PipelinedExecutor`` is accepted anywhere an ``executor=`` argument
    is; handing one to an op also pins the op's stream depth over
    ``TFT_PIPELINE_DEPTH``.
    """

    def __init__(self, inner, depth: Optional[int] = None):
        self.inner = inner
        self._depth = depth

    @property
    def depth(self) -> int:
        return pipeline_depth(self._depth)

    def resolve(self):
        return self.inner.resolve()

    def run(self, comp, arrays, row_local: bool = False,
            keep_device: bool = False):
        return self.inner.run(comp, arrays, row_local=row_local,
                              keep_device=keep_device)

    def submit(self, comp, arrays, row_local: bool = False):
        return submit(self.inner, comp, arrays, row_local=row_local)

    def map(self, block_arrays: Sequence, comp,
            row_local: bool = False) -> List:
        """Run ``comp`` over a sequence of input mappings, pipelined,
        results in input order."""
        return run_pipelined(
            block_arrays,
            lambda a: self.inner.run(comp, a, row_local=row_local),
            lambda a: self.submit(comp, a, row_local=row_local),
            lambda p, a: p.drain(),
            depth=self.depth, executor=self.inner)
