"""Device-memory accounting: the card's memory watermarks on query traces.

The port's counterpart of ``tensorframes_tpu/observability/device.py``.
The allocator statistics of each visible CUDA card
(``torch.cuda.memory_stats(i)``: the caching allocator's live and peak
allocated bytes) are sampled at query start and end and around block
drains, so a finished :class:`~.events.QueryTrace` carries the live and
peak bytes the query saw, and an OOM split (``engine/executor.py``) is
tagged with the watermark at the moment it fired. ``bytes_limit`` is the
card's total memory times the process's memory fraction
(``torch.cuda.set_per_process_memory_fraction``), the cap the allocator
enforces.

Each reading names the device the work runs on (``device=``): a CUDA
device reads its own card only, any other device (the CPU) reads nothing
and returns ``None``, and ``None`` reads every visible card, as the JAX
package does. The executor's OOM split and a traced pipeline drain pass
the executor's device; query start and end pass the package default
device (:func:`~..device.default_device`).

Zero cost when off: every entry point is called only with an ACTIVE query
trace (``TFT_TRACE`` set), so with tracing off no statistics are read. A
process without CUDA reports nothing: the first probe latches the module
off (:func:`_reset` re-arms it, for tests). There is no host reading in
its place: the numbers are the card's or ``None``. A process that has not
touched its card yet reports ``None`` for that sample without latching
(reading would create the CUDA context it has not made).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ..utils.logging import get_logger

__all__ = ["raw_memory_stats", "sample", "watermark", "supported"]

_log = get_logger("observability.device")

_lock = threading.Lock()
_unsupported = False  # latched when the process has no CUDA


class _Card:
    """One visible CUDA card, read through ``torch.cuda``; ``memory_stats``
    returns the JAX package's key names (``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit``), or ``None`` before the
    process has touched the card."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def memory_stats(self) -> Optional[Dict[str, int]]:
        import torch

        ms = torch.cuda.memory_stats(self.index)
        if not ms:
            return None
        total = torch.cuda.get_device_properties(self.index).total_memory
        frac = getattr(torch.cuda, "get_per_process_memory_fraction", None)
        limit = int(total * frac(self.index)) if frac is not None else total
        return {"bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak",
                                                0)),
                "bytes_reserved": int(ms.get("reserved_bytes.all.current",
                                             0)),
                "bytes_limit": limit}


def _local_devices() -> List[Any]:
    """The visible CUDA cards (patchable in tests); ``[]`` without CUDA."""
    import torch

    if not torch.cuda.is_available():
        return []
    return [_Card(i) for i in range(torch.cuda.device_count())]


def _covered(device, n: int) -> List[int]:
    """The indices, among ``n`` visible cards, that a reading for
    ``device`` covers: every card for ``None``, a CUDA device's own card,
    and none for any other device (the CPU)."""
    if device is None:
        return list(range(n))
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return []
    return [device.index if device.index is not None
            else torch.cuda.current_device()]


def _reset() -> None:
    """Re-arm the unsupported latch (tests patch ``_local_devices``)."""
    global _unsupported
    with _lock:
        _unsupported = False


def raw_memory_stats(device=None
                     ) -> Optional[List[Tuple[int, Dict[str, Any]]]]:
    """``[(device_index, stats_dict), ...]`` for each card ``device``
    covers that reports allocator statistics, or ``None`` when none does.
    A process with no card latches the module off until :func:`_reset`."""
    global _unsupported
    with _lock:
        if _unsupported:
            return None
    try:
        devices = _local_devices()
        covered = _covered(device, len(devices)) if devices else []
    except Exception as e:  # a device probe must never kill a query
        _log.debug("device probe failed during memory sample: %s", e)
        return None
    if not devices:
        with _lock:
            _unsupported = True
        return None
    out: List[Tuple[int, Dict[str, Any]]] = []
    for i in covered:
        if not 0 <= i < len(devices):
            continue
        d = devices[i]
        try:
            ms = d.memory_stats()
        except Exception as e:
            _log.debug("memory_stats() of device %d failed: %s", i, e)
            ms = None
        if ms:
            out.append((i, ms))
    return out or None


def watermark(device=None) -> Optional[Dict[str, int]]:
    """``{"live_bytes", "peak_bytes", "limit_bytes", "devices"}`` summed
    across the cards ``device`` covers, or ``None`` when none reports."""
    stats = raw_memory_stats(device)
    if stats is None:
        return None
    live = peak = limit = 0
    for _, ms in stats:
        live += int(ms.get("bytes_in_use") or 0)
        peak += int(ms.get("peak_bytes_in_use") or ms.get("bytes_in_use")
                    or 0)
        limit += int(ms.get("bytes_limit") or 0)
    return {"live_bytes": live, "peak_bytes": peak, "limit_bytes": limit,
            "devices": len(stats)}


def sample(trace, tag: str, per_device: bool = False, device=None
           ) -> Optional[Dict[str, int]]:
    """Record one ``hbm_sample`` event on ``trace`` (summed across the
    cards ``device`` covers; ``per_device=True`` also puts one event per
    card on its device track). Returns the summed watermark, or ``None``
    when no card reports (the CPU)."""
    if trace is None:
        return None
    stats = raw_memory_stats(device)
    if stats is None:
        return None
    from .events import DEVICE_TRACK_BASE

    live = peak = 0
    for i, ms in stats:
        d_live = int(ms.get("bytes_in_use") or 0)
        d_peak = int(ms.get("peak_bytes_in_use") or d_live)
        live += d_live
        peak += d_peak
        if per_device:
            trace.add("hbm_sample", name=tag, tag=tag, device=i,
                      live_bytes=d_live, peak_bytes=d_peak,
                      track=DEVICE_TRACK_BASE + i)
    trace.add("hbm_sample", name=tag, tag=tag, live_bytes=live,
              peak_bytes=peak, devices=len(stats))
    return {"live_bytes": live, "peak_bytes": peak, "devices": len(stats)}


def supported() -> bool:
    """Whether sampling is still armed: True until a probe found no card
    (optimistically True before any probe)."""
    with _lock:
        return not _unsupported
