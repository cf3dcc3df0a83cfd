"""External-memory sort: budget-sized device runs + host k-way merge.

The port's counterpart of ``tensorframes_tpu/memory/external_sort.py``.
``dsort``'s columnsort holds the whole frame on the devices; a frame
larger than the device budget takes this out-of-core path instead:

1. the input rows split into contiguous **runs**, each a quarter of the
   budget (``TFT_MEM_LIMIT_BYTES`` or the card's budget: input, output and
   staging fit at once);
2. each run sorts **on the device**, admitted against the ledger: a
   stable sort by the order-transformed keys (float negation and
   bitwise-not for ``descending``, as ``dsort`` transforms them), the
   run-local position breaking ties (:func:`lexsort_order`);
3. the sorted run moves to pinned host buffers (each move is a
   ``memory.spill``: a device intermediate leaving for the host);
4. the runs **k-way merge on the host**, adjacent pairs per round
   (log2(k) rounds). One numeric key without NaNs merges in O(n) by a
   vectorized two-pointer (``np.searchsorted`` interleave); several keys
   or NaN keys merge by a stable ``np.lexsort`` of the pair. Both keep the
   earlier run's rows first on ties, so the final order is the in-memory
   sort's: stable by original row position.

Stats ``{"runs", "rows", "bytes"}``; counters ``memory.external_sorts``
and ``memory.external_sort_runs``; spans ``memory.external_sort``,
``memory.run_sort`` and ``memory.kway_merge``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.logging import get_logger
from ..utils.tracing import counters, span
from .spill import array_nbytes, to_pinned_host

__all__ = ["external_sort", "lexsort_order"]

_log = get_logger("memory.external_sort")


def lexsort_order(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The permutation that sorts rows by ``keys`` lexicographically, the
    first key most significant, ties kept in row order: a chain of stable
    sorts from the least significant key. Floats order as XLA's sort
    does: -0.0 ties with 0.0, and every NaN, of either sign, sorts after
    +inf, NaNs tied with each other."""
    n = int(keys[0].shape[0])
    order = torch.arange(n, device=keys[0].device)
    for k in reversed(list(keys)):
        kk = k.index_select(0, order)
        if kk.is_floating_point():
            # one zero and one NaN: a radix sort (CUDA's) orders raw bit
            # patterns, which put -0.0 before 0.0 and -NaN before -inf
            kk = torch.where(kk == 0, 0.0, kk)
            kk = torch.where(torch.isnan(kk), float("nan"), kk)
        order = order.index_select(
            0, torch.sort(kk, stable=True).indices)
    return order


def _transform_key(k: np.ndarray, descending: bool) -> np.ndarray:
    """Order-reversing host transform matching ``dsort``'s device one:
    float negation, and bitwise-not for ints (never overflows)."""
    if not descending:
        return k
    return -k if np.dtype(k.dtype).kind == "f" else ~k


def _sort_one_run(keys_t: List[np.ndarray], cols: Dict[str, np.ndarray],
                  names: List[str], start: int, manager,
                  device: torch.device) -> Dict[str, Any]:
    """Sort one run on ``device`` within budget; returns the run record
    spilled to pinned host buffers."""
    run_bytes = (sum(a.nbytes for a in keys_t)
                 + sum(cols[n].nbytes for n in names))
    tok = 0
    if manager is not None:
        tok = manager.reserve(2 * run_bytes, op="memory.external_sort")
    try:
        with span("memory.run_sort"):
            dk = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in keys_t]
            order = lexsort_order(dk)
            # the run leaves the device into pinned buffers: this IS the
            # spill the external path exists to make
            rec = {
                "mk": [to_pinned_host(k.index_select(0, order))
                       for k in dk],
                "cols": {n: to_pinned_host(torch.from_numpy(
                    np.ascontiguousarray(cols[n])).to(device)
                    .index_select(0, order)) for n in names},
                "ids": to_pinned_host(order).astype(np.int64) + start,
            }
    finally:
        if manager is not None:
            manager.release(tok)
    if manager is not None:
        manager.note_spill(run_bytes, name=f"sort-run@{start}")
    return rec


def _merge_two(a: Dict[str, Any], b: Dict[str, Any],
               fast: bool) -> Dict[str, Any]:
    """Stable merge of two sorted runs; run ``a``'s rows (earlier original
    positions) come first on equal keys."""
    na = len(a["ids"])
    nb = len(b["ids"])
    if fast:
        ka, kb = a["mk"][0], b["mk"][0]
        pos_a = np.arange(na) + np.searchsorted(kb, ka, side="left")
        pos_b = np.arange(nb) + np.searchsorted(ka, kb, side="right")

        def interleave(x, y):
            out = np.empty((na + nb,) + x.shape[1:], x.dtype)
            out[pos_a] = x
            out[pos_b] = y
            return out
    else:
        cat = [np.concatenate([x, y]) for x, y in zip(a["mk"], b["mk"])]
        # np.lexsort is stable and its last key is primary; the runs
        # concatenate a-first, so ties keep original order (every NaN
        # sorts last and ties, as on the device)
        order = np.lexsort(tuple(reversed(cat)))

        def interleave(x, y):
            return np.concatenate([x, y])[order]

    return {
        "mk": [interleave(x, y) for x, y in zip(a["mk"], b["mk"])],
        "cols": {n: interleave(a["cols"][n], b["cols"][n])
                 for n in a["cols"]},
        "ids": interleave(a["ids"], b["ids"]),
    }


def external_sort(columns: Mapping[str, np.ndarray], keys: List[str],
                  descending: bool = False, manager=None,
                  run_bytes: Optional[int] = None, device=None
                  ) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                             Dict[str, int]]:
    """Sort host ``columns`` by ``keys`` out of core (module docstring),
    each run on ``device`` (default: the package's default device).

    Returns ``(sorted_columns, order, stats)``: ``order`` maps each output
    row to its input row (host ride-along columns permute with it) and
    ``stats`` is ``{"runs", "rows", "bytes"}``. The order is that of a
    stable in-memory sort by the transformed keys, ``dsort``'s over the
    same rows."""
    from ..device import resolve_device

    names = sorted(columns)
    for k in keys:
        if k not in columns:
            raise KeyError(f"No sort key column {k!r}; columns: {names}")
    n = int(next(iter(columns.values())).shape[0]) if columns else 0
    total = sum(array_nbytes(columns[c]) for c in names)
    if run_bytes is None:
        budget = getattr(manager, "limit", None)
        run_bytes = max(budget // 4, 1) if budget else max(total, 1)
    row_bytes = max(total // max(n, 1), 1)
    run_rows = max(int(run_bytes) // row_bytes, 1)
    stats = {"runs": 0, "rows": n, "bytes": total}
    if n == 0:
        return ({c: np.asarray(columns[c]) for c in names},
                np.empty(0, np.int64), stats)
    dev = resolve_device(device)

    keys_t = [_transform_key(np.asarray(columns[k]), descending)
              for k in keys]
    # the O(n) searchsorted merge needs one totally ordered key: NaNs
    # break its comparator, several keys need lexicographic ties
    fast = (len(keys) == 1
            and not (np.dtype(keys_t[0].dtype).kind == "f"
                     and bool(np.isnan(keys_t[0]).any())))

    runs: List[Dict[str, Any]] = []
    with span("memory.external_sort"):
        for start in range(0, n, run_rows):
            end = min(start + run_rows, n)
            run_cols = {c: np.ascontiguousarray(columns[c][start:end])
                        for c in names}
            run_keys = [k[start:end] for k in keys_t]
            runs.append(_sort_one_run(run_keys, run_cols, names, start,
                                      manager, dev))
        stats["runs"] = len(runs)
        counters.inc("memory.external_sorts")
        counters.inc("memory.external_sort_runs", len(runs))
        _log.debug("external sort: %d rows (%d B) in %d run(s) of <=%d "
                   "rows", n, total, len(runs), run_rows)
        with span("memory.kway_merge"):
            while len(runs) > 1:
                nxt = []
                for i in range(0, len(runs) - 1, 2):
                    nxt.append(_merge_two(runs[i], runs[i + 1], fast))
                if len(runs) % 2:
                    nxt.append(runs[-1])
                runs = nxt
    merged = runs[0]
    return dict(merged["cols"]), merged["ids"], stats
