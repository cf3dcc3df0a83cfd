"""Resilient execution: retries, deadlines, fault injection, classification.

The port's counterpart of ``tensorframes_tpu/resilience/__init__.py``,
with the same exports:

- **policy** (:mod:`.policy`): :class:`RetryPolicy` (bounded attempts,
  exponential backoff with deterministic jitter, an overall deadline) and
  the :func:`deadline` context; every retry and giveup is counted
  (``retry.<op>.retries`` / ``.giveups``) and logged;
- **classification** (:mod:`.classify`): which exceptions are transient
  (retry), which are out of memory (split the block:
  ``torch.cuda.OutOfMemoryError``, ``MemoryError``, the TPU's and
  cuBLAS's status words), and which are permanent (fail fast; a kernel's
  build or launch failure, :class:`KernelError`, always is);
- **faults** (:mod:`.faults`): the deterministic fault-injection harness
  (``with faults.inject("oom", fail_n=2): ...``) that drives every
  recovery path on the CPU and on the card;
- **chaos** (:mod:`.chaos`): seeded multi-site schedules over the fault
  sites (``TFT_CHAOS="seed:42,rate:0.05,sites:worker|oom|disk"``), the
  same decision function as the JAX package's, replayable on their seed;
- **invariants** (:mod:`.invariants`): the auditors that hold the slot
  pool's leases, the memory ledger, the schedulers' and the fabric's
  query accounting and a fused query's rows against each other at
  quiesce points; strict (raising) under an active chaos schedule.

Consumers: ``engine/executor.py`` (dispatch retry, the row split of an
OOM'd row-local block), ``engine/pipeline.py`` (the drain's sync
fallback), ``plan/execute.py`` (a fused plan handed back to the per-op
path after an OOM its stage could not split), ``stream/runtime.py``
(a poisoned batch skipped and counted, a transient one retried).
"""

from .classify import (AdmissionDeadline, DeviceLost, InvariantViolation,
                       KernelError, OverQuota, QueryCancelled,
                       QueryInterrupted, QueryPreempted, QueryQuarantined,
                       QueueFull, ServeRejected, WorkerLost, error_kind,
                       is_device_lost, is_oom, is_permanent, is_transient,
                       is_worker_lost)
from .faults import InjectedFault, inject
from .policy import (DEFAULT_POLICY, ClusterInitError, DeadlineExceeded,
                     RetryPolicy, check_deadline, deadline, default_policy,
                     env_bool, env_float, env_int, remaining_time)
from . import chaos
from . import faults
from . import invariants

__all__ = [
    "RetryPolicy", "DeadlineExceeded", "ClusterInitError",
    "DEFAULT_POLICY", "default_policy", "deadline", "remaining_time",
    "check_deadline",
    "is_transient", "is_oom", "is_permanent", "is_device_lost",
    "is_worker_lost", "error_kind",
    "ServeRejected", "QueueFull", "OverQuota", "AdmissionDeadline",
    "QueryQuarantined", "InvariantViolation",
    "DeviceLost", "WorkerLost", "KernelError",
    "QueryInterrupted", "QueryPreempted", "QueryCancelled",
    "env_bool", "env_float", "env_int",
    "faults", "inject", "InjectedFault", "invariants", "chaos",
]
