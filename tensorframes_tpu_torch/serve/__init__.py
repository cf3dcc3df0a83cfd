"""The serving layer: the multi-tenant query scheduler, the serving
fabric over several of them, their statistics, poison-query quarantine
and the shared compile cache.

The port's counterpart of ``tensorframes_tpu/serve``:

- :class:`QueryScheduler` (``scheduler.py``): per-tenant bounded queues,
  weighted-fair stride selection, rows/sec quotas, deadlines, admission
  against the card's memory with preemption, priority preemption with
  park and resume, cancellation; ``ttf.submit()`` and
  ``TensorFrame.submit()`` use the process default
  (:func:`default_scheduler`);
- :func:`serve_report` and :class:`ServerStats` (``stats.py``), with the
  ``tft_serve_*`` metrics families;
- :func:`quarantine_status` and :func:`unquarantine` (``quarantine.py``);
- :class:`SharedCompileCache` (``cache.py``), which a scheduler installs
  as the executor's interner;
- :class:`ServeFabric` (``fabric.py``): tenants placed across
  :class:`FabricWorker` s (each a full scheduler), heartbeats and leases,
  a lost worker's queries resumed on a survivor from their persisted
  checkpoints (:class:`FabricQuery` survives its worker), rolling
  restarts behind an admission probe; :func:`live_fabric` is the open
  one, :func:`fabric_enabled` reads ``TFT_FABRIC``.
"""

from .cache import SharedCompileCache, computation_signature
from .fabric import (FabricQuery, FabricWorker, ServeFabric,
                     fabric_enabled, live_fabric)
from .quarantine import quarantine_status, unquarantine
from .scheduler import (QueryScheduler, SubmittedQuery, TenantQuota,
                        default_scheduler, live_scheduler,
                        set_default_scheduler, shutdown_default_scheduler)
from .stats import ServerStats, serve_report

__all__ = [
    "QueryScheduler", "SubmittedQuery", "TenantQuota",
    "default_scheduler", "set_default_scheduler",
    "shutdown_default_scheduler", "live_scheduler",
    "SharedCompileCache", "computation_signature",
    "ServerStats", "serve_report",
    "ServeFabric", "FabricQuery", "FabricWorker",
    "live_fabric", "fabric_enabled",
    "unquarantine", "quarantine_status",
]
