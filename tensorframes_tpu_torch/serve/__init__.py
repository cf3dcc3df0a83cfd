"""Serving layer: the shared compile cache.

The port's counterpart of ``tensorframes_tpu/serve``, so far only its
``cache`` module: :func:`computation_signature` and
:class:`SharedCompileCache`, whose ``intern`` is installed on the executor
with :func:`~..engine.executor.set_computation_interner`. The scheduler,
its statistics, quarantine and the serving fabric are not in this package
yet (``ROADMAP.md`` A11).
"""

from .cache import SharedCompileCache, computation_signature

__all__ = ["SharedCompileCache", "computation_signature"]
