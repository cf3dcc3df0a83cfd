"""Relational half: joins and mergeable sketch aggregates.

The port's counterpart of ``tensorframes_tpu/relational/``:

- **Joins** (:mod:`.join`): a broadcast hash join (the build side
  factorized once and held on the device, one gather program per probe
  block through the :class:`~..engine.executor.BlockExecutor`) and a host
  sort-merge join. Both are lazy plan leaves, so downstream chains fuse
  over them and pruning reaches into them.
- **Sketches** (:mod:`.sketch`): HyperLogLog distinct counts, DDSketch
  relative-error quantiles and Misra–Gries top-k heavy hitters, each a
  monoid combiner that drops into ``aggregate``'s ``{column: combiner}``
  mapping beside the scalar names.
"""

from __future__ import annotations

from .join import (BuildTable, broadcast_join, join,
                   partitioned_hash_join, sort_merge_join)
from .sketch import (SketchCombiner, approx_distinct, approx_quantile,
                     approx_top_k, hll_sketch, quantile_sketch,
                     top_k_sketch)

__all__ = [
    "join", "broadcast_join", "sort_merge_join",
    "partitioned_hash_join", "BuildTable",
    "SketchCombiner", "hll_sketch", "quantile_sketch", "top_k_sketch",
    "approx_distinct", "approx_quantile", "approx_top_k",
]
