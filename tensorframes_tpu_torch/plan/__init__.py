"""Lazy logical-plan IR between the frame surface and the engine.

The port's counterpart of ``tensorframes_tpu/plan``. The per-op engine
path dispatches every ``map_blocks`` / ``map_rows`` / ``filter_rows`` /
``select`` in a chain as its own dispatch with its own host<->device round
trip. This package closes that gap without touching the per-op path's
semantics:

- every lazy frame op *additionally* records a :class:`~.nodes.PlanNode`
  on its result frame (the thunk chain stays exactly as it was);
- forcing (``blocks()``, and therefore ``collect``/``count``/reductions/
  ``aggregate``) first offers the chain to the optimizer
  (:func:`~.execute.maybe_run`): adjacent row-local ops fuse into ONE
  composed :class:`~..computation.Computation` dispatched once per block
  through the default executor; column pruning and ``column <op>
  literal`` filter atoms push down into the parquet scan
  (``io.read_parquet``); intermediates between stages stay on the device;
- any chain the optimizer cannot *prove* equivalent (non-row-preserving
  computations, ragged inputs, explicit ``executor=`` overrides) falls
  back to the unchanged per-op thunk, which is also the whole path when
  ``TFT_FUSE=0``: the kill switch is bit-identical by construction;
- plan nodes carry per-column row/byte estimates
  (:meth:`~.nodes.PlanNode.estimate`) for unforced frames
  (``memory.estimate.frame_estimate``).

- execution feeds measurement back into the plan (:mod:`.adaptive`):
  feedback-driven re-bucketing of row-local chains, filter re-ordering,
  mid-plan re-plans and the plan-fingerprint result cache
  (``TFT_ADAPTIVE``, ``TFT_RESULT_CACHE``, both on by default).

Counters (``utils/tracing.counters``): ``plan.fused_queries``,
``plan.oom_fallbacks``, ``plan.pushdown_groups_skipped``,
``plan.pushdown_bytes_skipped``, ``plan.adaptive_*``, ``plan.replans``,
``plan.filter_reorders``, ``plan.result_cache_*``; span ``plan.execute``.

``plan.dist`` (:mod:`.dist`) is the distributed plan: lazy mesh d-op
chains (``DistributedFrame.lazy()``) fused into one stage per mesh stage.
"""

from __future__ import annotations

from .nodes import (FilterNode, MapBlocksNode, MapRowsNode, ParquetScanNode,
                    PlanNode, SelectNode, SourceNode, attach, node_for,
                    observed_selectivity, record_selectivity)
from .optimize import enabled
from .execute import maybe_run
from . import adaptive

__all__ = [
    "PlanNode", "SourceNode", "ParquetScanNode", "MapBlocksNode",
    "MapRowsNode", "FilterNode", "SelectNode", "attach", "node_for",
    "enabled", "maybe_run", "record_selectivity", "observed_selectivity",
    "adaptive", "dist",
]


def __getattr__(name):
    # plan.dist imports parallel.distributed (which imports engine.ops,
    # which imports this package): resolve the submodule lazily so the
    # package import graph stays acyclic
    if name == "dist":
        import importlib
        return importlib.import_module(__name__ + ".dist")
    raise AttributeError(name)
