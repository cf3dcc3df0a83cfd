"""Hot-key salting, the part of ``tensorframes_tpu/parallel/elastic.py``
that the single-controller data-parallel path runs.

``daggregate``'s monoid host-key path splits any key holding more than
``TFT_HOT_KEY_FRACTION`` of the rows across ``num_data_shards`` salt slots
(:func:`plan_key_salt`) and folds the per-salt partials back on the host
(:func:`fold_salted`), bounding the largest segment a shard's segment
reduce ever sees. On by default (``TFT_SALT_HOT_KEYS``); it acts on any
mesh of more than one shard. Device-loss recovery, skew-adaptive
repartitioning and elastic growth (``grow_mesh``, ``admit_devices``,
``probe_device``) are ``ROADMAP.md`` A item 7b.

Counter ``mesh.salted_keys``; trace event ``key_salt``; flight record
``mesh.salt``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..observability import events as _obs
from ..observability import flight as _flight
from ..observability import metrics as _metrics
from ..utils.env import env_bool, env_float
from ..utils.logging import get_logger
from ..utils.tracing import counters

__all__ = ["salt_fraction", "plan_key_salt", "fold_salted"]

_log = get_logger("parallel.elastic")


# ---------------------------------------------------------------------------
# hot-key salting (daggregate's monoid host-key path)
# ---------------------------------------------------------------------------

def salt_fraction() -> Optional[float]:
    """The hot-key frequency threshold, or None when salting is off
    (``TFT_SALT_HOT_KEYS``, default on; ``TFT_HOT_KEY_FRACTION``,
    default 0.5 — a key is hot above HALF the rows)."""
    if not env_bool("TFT_SALT_HOT_KEYS", True):
        return None
    frac = env_float("TFT_HOT_KEY_FRACTION", 0.5)
    if frac is None or not 0.0 < frac < 1.0:
        return None
    return frac


def plan_key_salt(dist, ids_host: np.ndarray, num_groups: int,
                  n_shards: int):
    """Salt hot groups across ``n_shards`` slots.

    ``ids_host`` are the frame's padded group ids on the host (``-1`` for
    pad rows). Returns ``(salted_ids, effective_groups, (hot, K),
    fractions)`` with ``salted_ids`` on the host — or None when no group
    crosses the threshold (or the frame is too small for salting to
    matter). Row ``r`` of a hot group lands in salt slot ``r % K``; slot 0
    keeps the original group id, slots 1..K-1 map to appended table rows
    that :func:`fold_salted` folds back, so cold groups and output order
    are untouched.
    """
    frac = salt_fraction()
    if frac is None or n_shards <= 1 or num_groups <= 0:
        return None
    n = dist.num_rows
    if n < 4 * n_shards:
        return None
    valid = ids_host >= 0
    counts = np.bincount(ids_host[valid], minlength=num_groups)
    hot = np.flatnonzero(counts > frac * n)
    if hot.size == 0:
        return None
    K = n_shards
    G = num_groups
    hot_rank = np.full(G, -1, np.int64)
    hot_rank[hot] = np.arange(hot.size)
    j = np.arange(ids_host.shape[0]) % K  # even spread within each shard
    salted = ids_host.astype(np.int64, copy=True)
    m = valid & (hot_rank[np.clip(ids_host, 0, G - 1)] >= 0) & (j > 0)
    salted[m] = G + hot_rank[ids_host[m]] * (K - 1) + (j[m] - 1)
    salted = salted.astype(np.int32)
    eff = G + int(hot.size) * (K - 1)
    counters.inc("mesh.salted_keys", int(hot.size))
    _obs.add_event("key_salt", name="daggregate", count=int(hot.size),
                   salt=K, groups=[int(g) for g in hot[:16]])
    _flight.record("mesh.salt", count=int(hot.size), fraction=frac,
                   slots=K, rows=n, groups=[int(g) for g in hot[:16]])
    _log.info("daggregate: %d hot key group(s) (> %.0f%% of %d rows) "
              "salted across %d slots", hot.size, frac * 100, n, K)
    # 4th element: each hot group's observed row fraction, the hot-key
    # observation frame.hot_keys() returns
    return salted, eff, (hot, K), counts[hot] / max(n, 1)


_SALT_FOLD = {"sum": np.add, "min": np.minimum, "max": np.maximum,
              "prod": np.multiply}


def fold_salted(table, salt_map: Tuple[np.ndarray, int],
                cname: str) -> np.ndarray:
    """Fold a ``[effective_groups, ...]`` salted partial table back to
    ``[num_groups, ...]`` with the combiner's numpy twin."""
    hot, K = salt_map
    t = np.asarray(table)
    G = t.shape[0] - hot.size * (K - 1)
    base = t[:G].copy()
    if hot.size:
        extras = t[G:].reshape((hot.size, K - 1) + t.shape[1:])
        stack = np.concatenate([base[hot][:, None], extras], axis=1)
        base[hot] = _SALT_FOLD[cname].reduce(stack, axis=1)
    return base


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

_MESH_FAMILIES = (
    ("mesh.salted_keys", "tft_mesh_salted_keys_total",
     "Hot key groups salted across shards by daggregate."),
    ("mesh.dispatches", "tft_mesh_dispatches_total",
     "Mesh-op dispatches (one per op, covering every shard)."),
    ("mesh.interstage_host_bytes", "tft_mesh_interstage_host_bytes_total",
     "Bytes crossing device->host BETWEEN chained mesh ops (dfilter "
     "survivor counts / keep masks)."),
)


def _render_metrics() -> List[str]:
    snap = counters.snapshot()
    lines: List[str] = []
    for key, fam, help_text in _MESH_FAMILIES:
        lines.append(f"# HELP {fam} {help_text}")
        lines.append(f"# TYPE {fam} counter")
        lines.append(f"{fam} {snap.get(key, 0)}")
    return lines


_metrics.register_metrics_provider("mesh", _render_metrics)
