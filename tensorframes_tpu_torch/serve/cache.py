"""Shared cross-query compile cache: structural interning of Computations.

The port's counterpart of ``tensorframes_tpu/serve/cache.py``. A server
captures the same user program anew per submission, and every
:class:`~..computation.Computation` object carries its own state: the
placed module of a deserialized program (``computation._Program``) and the
vmapped wrapper of a row program. Interning reduces a Computation to a
**structural signature** and makes the first Computation seen with a
given signature canonical; later equivalents are swapped for it at the
executor boundary (:func:`~..engine.executor.set_computation_interner`),
so that state is built once.

The signature is a sha256 over the input and output specs, the text of
the graph ``torch.export`` gives under the SYMBOLIC row dim that
``Computation.serialize`` uses, and the shape, dtype and bytes of every
lifted constant and state entry. Symbolic tracing carries the correctness:
``x * x.shape[0]`` and ``x * 2.0`` agree at one probe size but not as
graphs. A program that cannot export symbolically gets ``None``: it is
counted as uncacheable and runs un-interned, never failed. The vmapped
wrapper of a row program takes its signature from the program's.

The cache holds canonical Computations strongly (a bounded LRU,
``TFT_SERVE_COMPILE_CACHE`` entries, default 512).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional

import torch

from ..observability.events import add_event as _obs_event
from ..resilience import env_int
from ..utils.logging import get_logger
from ..utils.tracing import counters

__all__ = ["SharedCompileCache", "computation_signature"]

_log = get_logger("serve.cache")

_SIG_ATTR = "_tft_serve_sig"
_CANON_ATTR = "_tft_serve_canon"


def computation_signature(comp) -> Optional[str]:
    """The structural signature of a Computation, or ``None`` when it
    cannot be derived safely (then the computation is uncacheable and
    runs un-interned). Cached on the object: one export per Computation
    per process."""
    sig = getattr(comp, _SIG_ATTR, False)
    if sig is not False:
        return sig
    try:
        sig = _build_signature(comp)
    except Exception as e:
        _log.debug("computation signature failed (%s: %s); marking "
                   "uncacheable", type(e).__name__, e)
        sig = None
    try:
        setattr(comp, _SIG_ATTR, sig)
    except Exception:
        _log.debug("could not cache signature on %r", comp)
    return sig


def _build_signature(comp) -> Optional[str]:
    base = getattr(comp, "_tft_vmap_of", None)
    if base is not None:
        bsig = computation_signature(base)
        return None if bsig is None else \
            hashlib.sha256(("vmap:" + bsig).encode()).hexdigest()
    from ..computation import _Program, export_program

    fn = comp.fn
    ep = fn.exported if isinstance(fn, _Program) else export_program(comp)
    h = hashlib.sha256()
    for s in comp.inputs:
        h.update(repr((s.name, s.dtype.name, s.shape.dims)).encode())
    for s in comp.outputs:
        h.update(repr((s.name, s.dtype.name, s.shape.dims)).encode())
    h.update(str(ep.graph).encode())
    # lifted constants are placeholders whose VALUES are not in the graph
    # text: two programs differing only in a captured table must not merge
    for name, t in sorted({**ep.state_dict, **ep.constants}.items()):
        h.update(name.encode())
        if isinstance(t, torch.Tensor):
            a = t.detach().cpu().contiguous()
            h.update(repr((tuple(a.shape), str(a.dtype))).encode())
            h.update(a.view(-1).view(torch.uint8).numpy().tobytes()
                     if a.numel() else b"")
        else:
            h.update(repr(t).encode())
    return h.hexdigest()


class SharedCompileCache:
    """Signature -> canonical Computation (bounded LRU, thread-safe).

    :meth:`intern` is the executor hook: it returns the canonical
    equivalent of ``comp`` (possibly ``comp`` itself, registering it).
    Hit/miss/uncacheable totals are exported through the always-on
    counters (``serve.compile_cache.*``) and, when a query trace is
    active, as ``shared_compile_cache`` events.
    """

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = max(1, capacity if capacity is not None
                            else env_int("TFT_SERVE_COMPILE_CACHE", 512))
        self._lock = threading.Lock()
        self._map: "OrderedDict[str, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.uncacheable = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def intern(self, comp):
        # resolved once per Computation OBJECT: later blocks of the same
        # query short-circuit here, so hits count avoided preparations
        # (one per duplicate computation), not block dispatches
        canon = getattr(comp, _CANON_ATTR, None)
        if canon is not None:
            return canon
        sig = computation_signature(comp)
        if sig is None:
            with self._lock:
                self.uncacheable += 1
            counters.inc("serve.compile_cache.uncacheable")
            return comp
        with self._lock:
            canon = self._map.get(sig)
            if canon is None or canon is comp:
                self._map[sig] = comp
                count_miss = canon is None
                if count_miss:
                    self.misses += 1
                self._map.move_to_end(sig)
                while len(self._map) > self.capacity:
                    self._map.popitem(last=False)
                canon = comp
                hit = False
            else:
                self._map.move_to_end(sig)
                self.hits += 1
                hit = True
                count_miss = False
        try:
            # the duplicate holds its canonical strongly: after an LRU
            # eviction the canonical's placed modules live on as long as
            # any equivalent computation does
            setattr(comp, _CANON_ATTR, canon)
        except Exception as e:
            _log.debug("could not cache canonical on %r: %s", comp, e)
        if hit:
            counters.inc("serve.compile_cache.hits")
            _obs_event("shared_compile_cache", hit=True)
        elif count_miss:
            counters.inc("serve.compile_cache.misses")
            _obs_event("shared_compile_cache", hit=False)
        return canon

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._map), "hits": self.hits,
                    "misses": self.misses,
                    "uncacheable": self.uncacheable,
                    "capacity": self.capacity}

    def clear(self) -> None:
        with self._lock:
            self._map.clear()
