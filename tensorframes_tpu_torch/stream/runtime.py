"""The stream pump: batches through the engine with failure isolation.

The port's counterpart of ``tensorframes_tpu/stream/runtime.py``.
:class:`StreamHandle` drives one stream definition (a
:class:`~.frame.StreamingFrame`, optionally ending in a
:class:`~.aggregate.StreamingAggregation`): it polls the source, wraps
each block as a one-partition ``TensorFrame``, applies the per-batch
transforms (which force through the engine like any finite frame), folds
aggregations, and delivers outputs to sinks.

**Failure isolation**: each batch's forcing runs under the process
:class:`~..resilience.RetryPolicy`: transient failures retry with
backoff like a block dispatch; a batch that still fails (a permanent
error, an exhausted retry budget, the ``batch`` fault site) is **skipped
and counted** (``stream.batches_skipped``, a ``batch_skip`` trace event
and flight record with the classified kind) and the stream keeps
running. ``TFT_STREAM_FAIL_FAST=1`` turns skipping off (the classified
error raises out of ``step()``). Two classes of error are never counted
as poisoned data: a ``device_lost`` error re-attempts the batch once
before the skip path sees it, and a ``preempted``/``cancelled``
interruption (``QueryInterrupted``) is the operator stopping work and
raises out of ``step()``. The fold runs once, after the retried forcing
and outside the retry, so a retried batch never counts twice.

**Backpressure and the slot pool**: bounded sources (``QueueSource``)
push back on producers. With an :class:`~..engine.pipeline.SlotPool`
installed, the pump leases one slot for each batch (a single-block
frame, which the engine runs on its serial path without leasing), so
streams and other pipelined work share one in-flight bound; waits are
counted in ``stream.slot_waits`` and honour the resilience deadline.

**Observability**: each batch runs inside a ``stream.batch`` query trace
and span; always-on counters (``stream.batches`` / ``stream.rows`` /
``stream.batches_skipped`` / ``stream.late_rows`` /
``stream.windows_emitted``); live per-stream gauges through the metrics
provider ``stream`` (``tft_stream_*``: batch lag, watermark, state rows
and bytes, skipped batches), registered while handles live;
``handle.metrics()`` returns the same numbers as a dict. Every batch ends
in ``resilience.invariants.audit("stream.batch")``, so a leaked slot
lease or an unbalanced ledger names the batch that caused it, and batch
boundaries invite a timeline sample.

``batch_rows="adaptive"`` sizes batches by runtime feedback
(``plan/adaptive.py``'s ``AdaptiveBatcher``: AIMD over each executed
batch's wall, within the ledger's per-block ceiling); an int pins a row
target; ``None`` is one source block per batch. ``TFT_ADAPTIVE=0`` turns
both coalescing modes off.

A skipped batch and a batch that emits windows each append one record to
the durable query history (``observability/history.py``), and a slot
wait counts into the served query's cost vector
(``observability/baseline.py``).
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..engine import pipeline as _pipeline
from ..frame import TensorFrame
from ..observability import baseline as _baseline
from ..observability import events as _obs
from ..observability import metrics as _metrics
from ..observability import timeline as _timeline
from ..resilience import invariants as _invariants
from ..resilience import (QueryInterrupted, check_deadline,
                          default_policy, env_bool, env_int, error_kind,
                          faults)
from ..utils.logging import get_logger
from ..utils.tracing import counters, gauge, span

__all__ = ["StreamHandle", "live_handles"]

_log = get_logger("stream.runtime")

# live handles for the metrics provider (weak: a dropped handle
# unregisters itself by dying)
_live_lock = threading.Lock()
_live: "weakref.WeakSet[StreamHandle]" = weakref.WeakSet()
_provider_registered = False


def live_handles() -> List["StreamHandle"]:
    """Every live stream handle (``tft.health()``'s stream section and
    the metrics provider read the same set)."""
    with _live_lock:
        return list(_live)


def _register_provider() -> None:
    global _provider_registered
    with _live_lock:
        if _provider_registered:
            return
        _provider_registered = True
    _metrics.register_metrics_provider("stream", _render_metrics)


def _render_metrics() -> List[str]:
    with _live_lock:
        handles = list(_live)
    lines: List[str] = []
    if not handles:
        return lines
    lines.append("# HELP tft_stream_batches_total Batches processed per "
                 "stream (skipped ones excluded).")
    lines.append("# TYPE tft_stream_batches_total counter")
    rows: List[str] = ["# TYPE tft_stream_rows_total counter"]
    skipped: List[str] = ["# TYPE tft_stream_skipped_total counter"]
    late: List[str] = ["# TYPE tft_stream_late_rows_total counter"]
    state_rows: List[str] = [
        "# HELP tft_stream_state_rows Live aggregation state rows "
        "(device-resident) per stream.",
        "# TYPE tft_stream_state_rows gauge",
    ]
    state_bytes: List[str] = ["# TYPE tft_stream_state_bytes gauge"]
    watermark: List[str] = ["# TYPE tft_stream_watermark gauge"]
    lag: List[str] = ["# TYPE tft_stream_batch_lag_seconds gauge"]
    for h in handles:
        m = h.metrics()
        lab = f'stream="{_metrics._escape_label(h.name)}"'
        lines.append(f"tft_stream_batches_total{{{lab}}} {m['batches']}")
        rows.append(f"tft_stream_rows_total{{{lab}}} {m['rows']}")
        skipped.append(
            f"tft_stream_skipped_total{{{lab}}} {m['batches_skipped']}")
        late.append(f"tft_stream_late_rows_total{{{lab}}} "
                    f"{m['late_rows']}")
        state_rows.append(
            f"tft_stream_state_rows{{{lab}}} {m['state_rows']}")
        state_bytes.append(
            f"tft_stream_state_bytes{{{lab}}} {m['state_bytes']}")
        if m["watermark"] is not None:
            watermark.append(
                f"tft_stream_watermark{{{lab}}} {m['watermark']}")
        if m["batch_lag_s"] is not None:
            lag.append(f"tft_stream_batch_lag_seconds{{{lab}}} "
                       f"{m['batch_lag_s']:.6f}")
    out = lines + rows + skipped + late + state_rows + state_bytes
    # families with no samples this scrape render nothing, not a bare
    # TYPE header
    if len(watermark) > 1:
        out += watermark
    if len(lag) > 1:
        out += lag
    return out


class StreamHandle:
    """One running stream: pump, sinks, metrics. Created by
    ``StreamingFrame.start()`` / ``StreamingAggregation.start()``.

    Drive it synchronously — :meth:`step` processes at most one batch,
    :meth:`run` loops until exhaustion/limits — or start the background
    pump thread with :meth:`start_background`. Outputs buffer for
    :meth:`collect_updates` (bounded; overflow drops oldest, counted in
    ``stream.updates_dropped``) and flow to the ``sink`` object
    (``write(frame)``/``close()``) and the ``on_update`` callback.
    """

    def __init__(self, sframe, aggregation=None, sink=None,
                 on_update: Optional[Callable[[TensorFrame], None]] = None,
                 name: Optional[str] = None,
                 max_buffered: Optional[int] = None,
                 batch_rows=None):
        self._sframe = sframe
        self._agg = aggregation
        self._sink = sink
        self._on_update = on_update
        self.name = name or f"stream-{id(self) & 0xffff:x}"
        # batch sizing: "adaptive" sizes batches from runtime feedback
        # (AIMD over the measured batch wall inside the ledger ceiling);
        # an int coalesces already-available source blocks up to a fixed
        # row target; None (the default) processes one source block per
        # batch. TFT_ADAPTIVE=0 turns coalescing off.
        self._batcher = None
        self._fixed_rows: Optional[int] = None
        if batch_rows == "adaptive":
            from ..memory.estimate import schema_row_bytes
            try:
                rb = max(int(schema_row_bytes(sframe.source.schema)), 1)
            except Exception:  # noqa: BLE001 - a sizing hint only
                rb = 8
            from ..plan.adaptive import AdaptiveBatcher
            self._batcher = AdaptiveBatcher(row_bytes=rb)
        elif batch_rows is not None:
            self._fixed_rows = max(int(batch_rows), 1)
        cap = (max_buffered if max_buffered is not None
               else env_int("TFT_STREAM_BUFFER", 1024))
        self._updates: "deque[TensorFrame]" = deque(maxlen=max(1, cap))
        self._lock = threading.Lock()
        self._batches = 0
        self._rows = 0
        self._skipped = 0
        self._last_batch_s: Optional[float] = None
        self._last_done_at: Optional[float] = None
        self._finalized = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # the error that stopped a background pump (fail-fast mode)
        self.error: Optional[BaseException] = None
        with _live_lock:
            _live.add(self)
        _register_provider()

    # -- properties --------------------------------------------------------
    @property
    def schema(self):
        """The OUTPUT schema (aggregation's when terminal, else the
        transformed frame's)."""
        return (self._agg.schema if self._agg is not None
                else self._sframe.schema)

    def done(self) -> bool:
        """Source permanently exhausted and final windows flushed."""
        return self._finalized or self._stopped

    # -- pump --------------------------------------------------------------
    def step(self, timeout: float = 0.0) -> bool:
        """Process at most one batch; returns True when one was consumed
        (even if it was skipped). ``timeout`` bounds the source poll."""
        if self.done():
            return False
        try:
            block = self._sframe.source.poll(timeout)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            # a block the source rejects (schema drift, decode error) is
            # a poisoned batch too: skipped-and-counted, never fatal —
            # the offending item was consumed, so the stream proceeds
            kind = error_kind(e)
            counters.inc("stream.batches_skipped")
            with self._lock:
                self._skipped += 1
            _obs.add_event("batch_skip", name=self.name, site="source",
                           error=type(e).__name__, kind=kind)
            if env_bool("TFT_STREAM_FAIL_FAST", False):
                raise
            _log.error(
                "stream %s: source rejected a batch (%s: %s; classified "
                "%s); skipped — the stream continues", self.name,
                type(e).__name__, e, kind)
            return True
        if block is None:
            if self._sframe.source.done():
                self._finalize()
            return False
        if self._batcher is not None or self._fixed_rows is not None:
            block = self._fill_batch(block)
        processed_before = self._batches
        self._process(block)
        # batch-boundary quiesce point (resilience/invariants.py):
        # between batches every lease is back in the pool and the
        # ledger balances; catching a leak HERE names the batch that
        # caused it instead of whichever query closes last
        _invariants.audit("stream.batch")
        if self._batcher is not None and self._last_batch_s is not None \
                and self._batches > processed_before:
            # only a batch that EXECUTED feeds the sizer: a skipped batch
            # leaves _last_batch_s at the prior batch's wall
            self._batcher.observe(block.num_rows, self._last_batch_s)
        return True

    def _batch_target(self, buffered_rows: int) -> bool:
        """Keep filling the current batch? ``TFT_ADAPTIVE=0`` keeps one
        source block per batch, as the JAX package's gate does."""
        from ..plan import adaptive as _adaptive
        if not _adaptive.enabled():
            return False
        if self._fixed_rows is not None:
            return buffered_rows < self._fixed_rows
        return self._batcher.want_more(buffered_rows)

    def _fill_batch(self, first):
        """Coalesce already-available source blocks up to the row
        target (never waits: a batch is whatever the source has NOW,
        so latency is untouched). A poisoned poll mid-fill counts its
        skip and the buffered rows still process."""
        bufs = [first]
        rows = first.num_rows
        while self._batch_target(rows):
            try:
                nxt = self._sframe.source.poll(0.0)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                kind = error_kind(e)
                counters.inc("stream.batches_skipped")
                with self._lock:
                    self._skipped += 1
                _obs.add_event("batch_skip", name=self.name,
                               site="source", error=type(e).__name__,
                               kind=kind)
                if env_bool("TFT_STREAM_FAIL_FAST", False):
                    raise
                _log.error(
                    "stream %s: source rejected a batch mid-fill "
                    "(%s: %s; classified %s); skipped — the buffered "
                    "rows still process", self.name,
                    type(e).__name__, e, kind)
                break
            if nxt is None:
                break
            bufs.append(nxt)
            rows += nxt.num_rows
        if len(bufs) == 1:
            return first
        from ..frame import Block
        counters.inc("stream.batches_coalesced", len(bufs) - 1)
        return Block.concat(bufs, self._sframe.source.schema)

    def run(self, max_batches: Optional[int] = None,
            timeout_s: Optional[float] = None,
            poll_interval: float = 0.01) -> int:
        """Pump until the source is exhausted (finite streams), or until
        ``max_batches`` / ``timeout_s``; returns batches consumed."""
        n = 0
        give_up = (time.monotonic() + timeout_s
                   if timeout_s is not None else None)
        while not self.done():
            if max_batches is not None and n >= max_batches:
                break
            if give_up is not None and time.monotonic() >= give_up:
                break
            if self.step(timeout=poll_interval):
                n += 1
        return n

    def start_background(self, poll_interval: float = 0.05
                         ) -> "StreamHandle":
        """Pump on a daemon thread until :meth:`stop` or exhaustion.
        An error escaping :meth:`step` (only possible under
        ``TFT_STREAM_FAIL_FAST=1`` — the skip path swallows everything
        else) stops the pump and lands on :attr:`error` instead of
        dying silently on the daemon thread."""
        if self._thread is not None:
            raise RuntimeError(f"stream {self.name!r} already pumping")

        def pump():
            while not self._stop_evt.is_set() and not self.done():
                try:
                    self.step(timeout=poll_interval)
                except Exception as e:
                    self.error = e
                    counters.inc("stream.pump_errors")
                    _log.error(
                        "stream %s: background pump stopped on %s: %s",
                        self.name, type(e).__name__, e)
                    return
            # fall out on stop/exhaustion; finalize happens in step()

        self._thread = threading.Thread(
            target=pump, name=f"tft-{self.name}", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop pumping and close the sink (without finalizing windows —
        use ``run()`` to exhaustion for a clean flush). Idempotent."""
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._stopped = True
        self._close_sink()

    # -- one batch ---------------------------------------------------------
    def _process(self, block) -> None:
        i = self._batches + self._skipped
        t0 = time.perf_counter()

        def attempt():
            faults.check("batch")
            df = TensorFrame.from_blocks([block],
                                         self._sframe.source.schema)
            df = self._sframe._apply(df)
            df.blocks()  # force the per-batch plan
            return df

        pool = None
        try:
            with _obs.query_trace("stream.batch", stream=self.name,
                                  batch=i):
                with span("stream.batch"):
                    # everything failure-prone — slot wait (deadline
                    # expiry), forcing, fold — lives inside this try: an
                    # escape anywhere must hit the skip path below,
                    # never kill a pump thread
                    pool = self._lease_slot()
                    try:
                        df = default_policy().call(attempt,
                                                   op="stream.batch")
                    except Exception as e:
                        # a device_lost error is structural, not
                        # poisoned data: ONE re-attempt runs the batch
                        # before the skip path gets to count it (the
                        # JAX package's elastic layer shrinks the mesh
                        # in between; the port has one device)
                        if error_kind(e) != "device_lost":
                            raise
                        counters.inc("stream.device_lost_retries")
                        _obs.add_event("device_lost_retry",
                                       name=self.name, batch=i)
                        _log.warning(
                            "stream %s: batch %d hit a device loss "
                            "(%s); retrying once",
                            self.name, i, e)
                        df = default_policy().call(attempt,
                                                   op="stream.batch")
                    # fold AFTER the retried forcing, exactly once: the
                    # retry policy must never wrap ingest, whose commit
                    # mutates window state (a retried ingest would
                    # double-count the batch). ingest is all-or-nothing,
                    # so a failure here skips the whole batch with live
                    # state untouched.
                    outputs = (self._agg.ingest(df)
                               if self._agg is not None else [df])
        except (KeyboardInterrupt, SystemExit, QueryInterrupted):
            # a cancel/preempt is the OPERATOR stopping work, not
            # poisoned data: counting it as a skipped batch would hide a
            # deliberate interruption inside the data-quality counter
            raise
        except Exception as e:
            kind = error_kind(e)
            counters.inc("stream.batches_skipped")
            with self._lock:
                self._skipped += 1
            _obs.add_event("batch_skip", name=self.name, batch=i,
                           error=type(e).__name__, kind=kind)
            from ..observability import flight as _flight
            _flight.record("stream.batch_skip", stream=self.name,
                           batch=i, error=type(e).__name__,
                           error_kind=kind)
            # durable query history: a poisoned batch is the record a
            # post-mortem wants to find after the process dies
            from ..observability import history as _history
            _history.record_finish(
                f"{self.name}-b{i}", tenant=self.name,
                outcome="skipped", error=f"{type(e).__name__}: {e}",
                error_kind=kind, source="stream",
                summary=f"stream {self.name!r} batch {i} skipped")
            if env_bool("TFT_STREAM_FAIL_FAST", False):
                raise
            _log.error(
                "stream %s: batch %d poisoned (%s: %s; classified %s); "
                "skipped — the stream continues", self.name, i,
                type(e).__name__, e, kind)
            return
        finally:
            if pool is not None:
                pool.release()
        dt = time.perf_counter() - t0
        rows = sum(b.num_rows for b in df.blocks())
        with self._lock:
            self._batches += 1
            self._rows += rows
            self._last_batch_s = dt
            self._last_done_at = time.monotonic()
        counters.inc("stream.batches")
        counters.inc("stream.rows", rows)
        gauge("stream.batch_seconds", dt)
        # batch boundaries are the timeline's beat on streaming-only
        # processes (interval-gated; off-interval cost is one compare)
        _timeline.maybe_sample()
        if self._agg is not None and outputs:
            # durable query history: a window EMIT is the stream's
            # query-terminal moment (committed results left the runtime);
            # once per emit, never per batch
            from ..observability import history as _history
            _history.record_finish(
                f"{self.name}-b{i}", tenant=self.name, outcome="ok",
                run_s=dt, total_s=dt, est_rows=rows, source="stream",
                summary=f"stream {self.name!r} batch {i}: "
                        f"{len(outputs)} window frame(s) emitted")
        for frame in outputs:
            self._deliver(frame)

    # -- slot-pool composition --------------------------------------------
    def _lease_slot(self):
        """Lease ONE pool slot per batch when a serving scheduler's
        :class:`~..engine.pipeline.SlotPool` is installed, so streams
        and scheduled queries share the global in-flight bound. Safe by
        construction: stream batches are single-block frames, which the
        engine runs on its serial path WITHOUT leasing (``run_pipelined``
        only leases multi-block pipelined streams) — the handle and the
        engine never both hold slots for the same batch, so a slots=1
        pool cannot deadlock against its own forcing. Waits honor the
        ambient resilience deadline. Returns the pool to release, or
        None."""
        pool = _pipeline.current_slot_pool()
        if pool is None:
            return None
        if pool.try_acquire():
            return pool
        counters.inc("stream.slot_waits")
        tr = _obs.current_trace()
        t0 = tr.clock() if tr is not None else 0.0
        # measured always (on the contended path only), for the
        # sentinel's per-query slot_wait_s
        w0 = time.perf_counter()
        while not pool.try_acquire(timeout=0.05):
            check_deadline("stream.slot")
        _baseline.note_wait(time.perf_counter() - w0)
        if tr is not None:
            tr.add("slot_wait", ts=t0, dur=tr.clock() - t0)
        return pool

    # -- delivery ----------------------------------------------------------
    def _deliver(self, frame: TensorFrame) -> None:
        with self._lock:
            if len(self._updates) == self._updates.maxlen:
                counters.inc("stream.updates_dropped")
            self._updates.append(frame)
        if self._on_update is not None:
            try:
                self._on_update(frame)
            except Exception as e:
                counters.inc("stream.sink_errors")
                _log.error("stream %s: on_update callback failed: %s",
                           self.name, e)
        if self._sink is not None:
            try:
                self._sink.write(frame)
            except Exception as e:
                counters.inc("stream.sink_errors")
                _log.error("stream %s: sink write failed: %s",
                           self.name, e)

    def collect_updates(self) -> List[TensorFrame]:
        """Drain the buffered output frames (per-batch results, or
        emitted windows for aggregations) accumulated since the last
        call."""
        with self._lock:
            out = list(self._updates)
            self._updates.clear()
        return out

    def _finalize(self) -> None:
        if self._finalized:
            return
        self._finalized = True
        if self._agg is not None:
            try:
                frames = self._agg.finalize()
            except Exception as e:
                # a failed final flush must not kill the pump (or leave
                # the sink open): counted and logged, remaining windows
                # stay queryable through the aggregation object
                counters.inc("stream.finalize_errors")
                _log.error("stream %s: final window flush failed: %s",
                           self.name, e)
                frames = []
            for frame in frames:
                self._deliver(frame)
        self._close_sink()

    def _close_sink(self) -> None:
        sink = self._sink
        if sink is None:
            return
        close = getattr(sink, "close", None)
        if close is None:
            return
        try:
            close()
        except Exception as e:
            counters.inc("stream.sink_errors")
            _log.error("stream %s: sink close failed: %s", self.name, e)

    # -- introspection -----------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        """Live stream metrics (the dict twin of the ``tft_stream_*``
        Prometheus series)."""
        with self._lock:
            lag = (time.monotonic() - self._last_done_at
                   if self._last_done_at is not None else None)
            out = {
                "batches": self._batches,
                "rows": self._rows,
                "batches_skipped": self._skipped,
                "last_batch_s": self._last_batch_s,
                "batch_lag_s": lag,
                "late_rows": 0,
                "state_rows": 0,
                "state_bytes": 0,
                "live_windows": 0,
                "watermark": None,
                "windows_emitted": 0,
                "state_evictions": 0,
                "state_spills": 0,
                "state_faults": 0,
                "buffered_updates": len(self._updates),
            }
        if self._agg is not None:
            out["late_rows"] = self._agg.late_rows
            out["state_rows"] = self._agg.state_rows
            out["state_bytes"] = self._agg.state_bytes
            out["live_windows"] = self._agg.live_windows
            out["watermark"] = self._agg.watermark
            out["windows_emitted"] = self._agg.windows_emitted
            out["state_evictions"] = self._agg.state_evictions
            out["state_spills"] = self._agg.state_spills
            out["state_faults"] = self._agg.state_faults
        return out

    def __repr__(self):
        m = self.metrics()
        return (f"StreamHandle({self.name!r}, batches={m['batches']}, "
                f"skipped={m['batches_skipped']}, "
                f"state_rows={m['state_rows']}, done={self.done()})")
