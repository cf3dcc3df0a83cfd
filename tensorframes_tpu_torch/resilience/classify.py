"""Exception classification for the resilience layer.

The port's counterpart of ``tensorframes_tpu/resilience/classify.py``.
Three buckets, three responses:

- **transient**: worth retrying (connection hiccups, ``UNAVAILABLE`` /
  ``ABORTED`` / ``DEADLINE_EXCEEDED`` status words, injected faults).
  Retried under a :class:`~.policy.RetryPolicy`.
- **oom**: out of memory. Retrying the same program would fail the same
  way, but HALVING the rows and running the two halves usually succeeds
  for row-local computations (``engine/executor.py``'s row split). On the
  card that is ``torch.cuda.OutOfMemoryError``, matched by type, and the
  text of a cuBLAS workspace allocation that fails under pressure
  (``CUBLAS_STATUS_ALLOC_FAILED``), the card's counterpart of the TPU's
  ``RESOURCE_EXHAUSTED``; on the host a ``MemoryError``.
- **device_lost** / **worker_lost**, and the serving layer's rejections
  and interruptions: the whole of the JAX package's classifier is kept,
  with the contracts of the layers that raise them (the serving
  scheduler and fabric, preemption; the mesh, which is not ported yet),
  so that those layers land on the classification they were written
  against.
- **permanent**: everything else (shape errors, type errors, a kernel that
  fails to build or to launch): fail fast, loudly, once.

A hand-written kernel's build (``nvcc`` exit) or launch failure raises
:class:`KernelError`, which is permanent by type whatever its text holds
(an ``nvcc`` log can hold any word): it is never retried, never split, and
never gives way to the kernel's plain version.

Classification is otherwise string-based on purpose, as in the JAX
package: a status word in the message is the stable contract across a
C++/Python boundary, not the Python class.
"""

from __future__ import annotations

import os

import torch

__all__ = ["is_transient", "is_oom", "is_permanent", "is_device_lost",
           "is_worker_lost", "error_kind", "KernelError",
           "ServeRejected", "QueueFull", "OverQuota", "AdmissionDeadline",
           "QueryQuarantined", "InvariantViolation",
           "DeviceLost", "WorkerLost",
           "QueryInterrupted", "QueryPreempted", "QueryCancelled",
           "TRANSIENT_MARKERS", "OOM_MARKERS", "DEVICE_LOST_MARKERS",
           "WORKER_LOST_MARKERS"]


class KernelError(RuntimeError):
    """A hand-written CUDA kernel failed to build (``nvcc`` exited with an
    error, or is missing) or to launch. Deterministic: the same source
    fails the same build, so it is neither transient nor OOM, whatever its
    message says. Classified ``permanent``."""

    kind = "permanent"


class DeviceLost(RuntimeError):
    """A device of the mesh is gone (chip failure, host eviction, a
    lost ICI neighbor). Retrying the identical program would dispatch to
    the same dead device and fail identically, so this is NOT transient;
    the recovery is structural — ``parallel.elastic`` rebuilds a
    shrunken mesh over the survivors, re-shards the frame, and re-runs
    the op. Classified ``device_lost``.
    """

    kind = "device_lost"


class WorkerLost(RuntimeError):
    """A serving worker process is gone (crash, eviction, missed
    heartbeats past the fabric's lease). The process-group analogue of
    :class:`DeviceLost`: retrying against the dead worker would fail
    identically, so this is NOT transient; the recovery is structural —
    the serving fabric (``serve/fabric.py``) re-places the worker's
    tenants across the survivors and resumes its running queries from
    their persisted checkpoints (``memory/persist.py``), cold re-running
    only on a checkpoint mismatch. Classified ``worker_lost``.
    """

    kind = "worker_lost"


class QueryInterrupted(RuntimeError):
    """An operator- or scheduler-driven interruption of a running query
    (``serve/`` preemption and cancellation, ``engine/preempt.py``).

    NOT transient: retrying would re-run work the scheduler just asked
    to stop. The scheduler — not the retry loop — owns what happens
    next (re-queue a preempted query's checkpoint for resume; fail a
    cancelled one's future). Classified by ``kind``.
    """

    kind = "interrupted"
    retryable = False


class QueryPreempted(QueryInterrupted):
    """A running query was preempted at a block boundary: its in-flight
    blocks drained, its completed block outputs parked as a
    :class:`~..memory.checkpoint.QueryCheckpoint`, and the query
    re-queued — resume re-dispatches only the remaining blocks,
    bit-identical to an uninterrupted run (``docs/serving.md``)."""

    kind = "preempted"


class QueryCancelled(QueryInterrupted):
    """A query was cancelled (``QueryScheduler.cancel``): queued queries
    never run; running ones stop at the next block boundary and their
    checkpoint is freed. Surfaces on the query's future."""

    kind = "cancelled"


class ServeRejected(RuntimeError):
    """A load-related rejection from the serving layer (``serve/``).

    Unlike the engine's failures these are *policy* decisions: the query
    never ran, and the classification tells the client whether retrying
    later may succeed. ``kind`` is the classifier label exported on
    retry/giveup events and server stats; ``retryable`` feeds
    :func:`is_transient` (a full queue or an exhausted rows/sec budget
    clears with time; an admission-deadline shed does not retry itself).
    """

    kind = "rejected"
    retryable = True


class QueueFull(ServeRejected):
    """Per-tenant submission queue at its bounded depth (backpressure):
    the submit is rejected instead of queuing unboundedly. Retryable —
    the queue drains."""

    kind = "rejected"
    retryable = True


class OverQuota(ServeRejected):
    """The tenant's rows/sec budget (token bucket) cannot cover the
    query's estimated rows. Retryable — the bucket refills."""

    kind = "over_quota"
    retryable = True


class AdmissionDeadline(ServeRejected):
    """Admission control could not clear the query within its wait
    budget or deadline (estimated HBM footprint would cross the
    high-water mark): the query is shed instead of OOMing mid-flight.
    Not transient — the caller decides whether to resubmit."""

    kind = "deadline_admission"
    retryable = False


class QueryQuarantined(ServeRejected):
    """The query's plan fingerprint is quarantined: it failed
    permanently ``TFT_QUARANTINE_AFTER`` times in a row, so the
    scheduler fast-rejects it at submit instead of letting a
    deterministically-crashing plan eat retries, checkpoints, and
    worker restarts across the fabric (``serve/quarantine.py``). Not
    retryable as-is — the quarantine expires after its TTL (one probe
    re-admission) or is lifted manually with ``tft.unquarantine()``."""

    kind = "quarantined"
    retryable = False


class InvariantViolation(RuntimeError):
    """A cross-cutting invariant auditor found unbalanced books at a
    quiesce point (``resilience/invariants.py``): a leaked slot lease,
    an unbalanced memory reservation, rows lost across a plan or an
    exchange, inconsistent scheduler accounting. Raised in strict
    (chaos/test) mode; always-on mode flight-records and counts
    instead. NOT transient and NOT retryable: the state the next
    attempt would run on is exactly the state the auditor just proved
    wrong. Classified ``invariant``."""

    kind = "invariant"

# XLA/PJRT status words + socket-layer phrases that indicate the failure
# was environmental, not the program's fault.
TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "ABORTED",
    "DEADLINE_EXCEEDED",
    "CANCELLED",
    "connection refused",
    "connection reset",
    "socket closed",
    "temporarily unavailable",
    "injected transient fault",  # resilience.faults
)

# RESOURCE_EXHAUSTED is the TPU's status word; on the card a failed
# allocation of the caching allocator is torch.cuda.OutOfMemoryError
# ("CUDA out of memory"), matched by type in is_oom, and a cuBLAS
# workspace allocation that fails under the same pressure surfaces as
# CUBLAS_STATUS_ALLOC_FAILED
OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "CUBLAS_STATUS_ALLOC_FAILED",
    "out of memory",
    "Out of memory",
    "OOM",
)

# Status words that indicate a DEVICE died, not the program or the
# network: the PJRT/runtime phrasing a lost chip surfaces under.
# Checked BEFORE the transient markers — "UNAVAILABLE: device lost"
# must shrink the mesh, not spin the retry loop against a dead chip.
DEVICE_LOST_MARKERS = (
    "DEVICE_LOST",
    "device lost",
    "device is lost",
    "lost device",
)

# Status words that indicate a serving WORKER PROCESS died, not the
# program: missed-heartbeat declarations from the fabric coordinator and
# the `worker` fault site surface under these. Checked BEFORE the
# transient markers for the same reason as DEVICE_LOST: the recovery is
# re-placement, never a retry against the dead worker.
WORKER_LOST_MARKERS = (
    "WORKER_LOST",
    "worker lost",
    "worker is lost",
    "lost worker",
    "worker process died",
)


def _extra_transient_markers() -> tuple:
    """Operator-extensible marker list: ``TFT_TRANSIENT_ERRORS`` is a
    comma-separated set of additional substrings to treat as transient
    (an escape hatch for backend-specific status texts)."""
    raw = os.environ.get("TFT_TRANSIENT_ERRORS", "")
    return tuple(m.strip() for m in raw.split(",") if m.strip())


def is_oom(exc: BaseException) -> bool:
    """True when the failure is an out-of-memory shape — NOT retried
    as-is; the executor's split-block path handles it."""
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    if isinstance(exc, KernelError):
        return False
    msg = str(exc)
    return any(m in msg for m in OOM_MARKERS)


def is_device_lost(exc: BaseException) -> bool:
    """True when a mesh device is gone — NOT retried as-is; the elastic
    layer (``parallel.elastic``) shrinks the mesh and re-runs."""
    if isinstance(exc, DeviceLost):
        return True
    msg = str(exc)
    return any(m in msg for m in DEVICE_LOST_MARKERS)


def is_worker_lost(exc: BaseException) -> bool:
    """True when a serving worker process is gone — NOT retried as-is;
    the serving fabric (``serve/fabric.py``) re-places its tenants and
    resumes its queries from their persisted checkpoints."""
    if isinstance(exc, WorkerLost):
        return True
    msg = str(exc)
    return any(m in msg for m in WORKER_LOST_MARKERS)


def is_transient(exc: BaseException) -> bool:
    """True when retrying the same operation may legitimately succeed."""
    from .faults import InjectedFault

    if isinstance(exc, InjectedFault):
        return exc.transient
    if isinstance(exc, QueryInterrupted):
        # checked BEFORE the message markers: "CANCELLED" is a transient
        # PJRT status word, but a scheduler cancellation/preemption must
        # never spin a retry loop against the scheduler's own decision
        return False
    if isinstance(exc, ServeRejected):
        return exc.retryable  # queue drains / bucket refills; sheds don't
    if isinstance(exc, InvariantViolation):
        # the books the next attempt would run on are the books the
        # auditor just proved wrong — never spin a retry loop on them
        return False
    if isinstance(exc, KernelError):
        return False  # the same source builds and launches the same way
    if is_device_lost(exc):
        return False  # same program, same dead device: shrink, don't retry
    if is_worker_lost(exc):
        return False  # same dead worker: re-place, don't retry
    if is_oom(exc):
        return False  # same program, same memory: split, don't retry
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    msg = str(exc)
    if any(m in msg for m in TRANSIENT_MARKERS):
        return True
    extra = _extra_transient_markers()
    return bool(extra) and any(m in msg for m in extra)


def is_permanent(exc: BaseException) -> bool:
    return not is_transient(exc) and not is_oom(exc)


def error_kind(exc: BaseException) -> str:
    """The classifier's verdict as a stable label: the serving layer's
    own kinds (``rejected`` / ``over_quota`` / ``deadline_admission``)
    when the exception carries one, else ``device_lost`` / ``oom`` /
    ``transient`` / ``permanent``. Exported on retry/giveup trace
    events and in server stats so dashboards never re-derive the
    classification."""
    if isinstance(exc, QueryInterrupted):
        return exc.kind  # preempted / cancelled
    if isinstance(exc, ServeRejected):
        return exc.kind  # rejected / over_quota / … / quarantined
    if isinstance(exc, (InvariantViolation, KernelError)):
        return exc.kind  # "invariant" / "permanent"
    if is_device_lost(exc):
        return "device_lost"
    if is_worker_lost(exc):
        return "worker_lost"
    if is_oom(exc):
        return "oom"
    if is_transient(exc):
        return "transient"
    return "permanent"
