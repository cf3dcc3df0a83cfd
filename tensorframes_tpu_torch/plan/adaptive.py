"""Adaptive execution: runtime feedback closes the planning loop.

The port's counterpart of ``tensorframes_tpu/plan/adaptive.py``. The plan
prices everything when it is built: filters at their upper bound, block
sizes fixed by the source layout. This module is the feedback half, in
three legs:

1. **Adaptive block sizing**: a per-plan :class:`StreamFeedback` record
   (observed blocks, rows and wall, and the pipeline's mean window
   occupancy) gates and sizes a coalesce/split pass
   (:func:`choose_layout`) that the plan executor runs between the leaf
   and its first fused stage. Small blocks waste dispatches and big ones
   fight the memory ledger, so the chosen size targets
   ``TFT_PIPELINE_DEPTH`` full slots within the ledger's headroom. The
   pass engages only for chains whose every device op is provably
   ROW-LOCAL (vmapped ``map_rows``, ``select``, and filters whose
   predicates are proven conjunctions of column-vs-literal atoms,
   :mod:`.predicates`), and only after a first measured forcing of the
   same plan shape; the executor restores the original block boundaries
   afterwards, so the re-bucketed run is bit-identical to the static
   layout, boundaries included.

2. **Mid-plan re-planning**: after the first unit of a re-bucketed
   stream the executor compares observed filter selectivities with what
   the plan priced; off by more than ``TFT_REPLAN_RATIO`` the optimizer
   re-runs with the observed values (``plan.replans``), re-ordering
   conjunctive filter stages by observed selectivity
   (:func:`~.optimize._reorder_filters`).

3. **Plan-fingerprint result cache**: ``(structural plan fingerprint,
   source versions)`` -> collected result, so a repeated hot query costs
   zero dispatches. Fingerprints pin the leaf's identity (a parquet
   footer's path, mtime, size and row-group range, or a forced source
   frame's identity and version counter), the canonical Computation
   objects of every op and the values each program reads
   (:func:`program_state`: a program that reads a tensor or other
   state that can change in place is never cached, since the port runs
   programs eagerly at every forcing). Admission is two-touch: a fingerprint must be
   SEEN twice before its result is stored, so one-off queries and stream
   batches (a fresh leaf each) never enter. Entries are LRU-evicted under
   ``TFT_RESULT_CACHE_BYTES`` / ``TFT_RESULT_CACHE_ENTRIES``; their
   blocks are host arrays (the port's frame caches hold no device
   tensors), counted in ``tft_plan_result_cache_bytes``. A source-version
   change (parquet append, ``uncache()``) changes the key. With the
   durable tier on (``TFT_PERSIST_DIR``, ``memory/persist.py``),
   parquet-rooted entries also write through under a PORTABLE
   fingerprint (:func:`portable_fingerprint`: footer identity and the
   computations' structural signatures of ``serve/cache.py``), and a
   memory miss falls through to disk before reporting cold
   (``plan.result_cache_warm_hits``). ``TFT_RESULT_CACHE=0`` turns the
   leg off.

``TFT_ADAPTIVE=0`` disables legs 1 and 2 wholesale; every unprovable case
(non-row-local ops, ragged inputs, an active preemption scope, whose
checkpoint tags pin the static block count) keeps the static layout
bit-identically. :func:`record_stream_feedback` also feeds each
forcing's wall to the performance sentinel (``observability/baseline.py``),
and :func:`query_fingerprint` is the key of its baselines and of the
serving quarantine.
"""

from __future__ import annotations

import functools
import hashlib
import os
import threading
import time
import types
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.env import env_bool, env_float, env_int
from ..utils.logging import get_logger
from ..utils.tracing import counters, gauge

__all__ = ["enabled", "result_cache_enabled", "replan_ratio",
           "StreamFeedback", "record_stream_feedback", "stream_feedback",
           "Layout", "choose_layout", "fingerprint", "program_state",
           "portable_fingerprint", "query_fingerprint", "cached_result",
           "offer_result", "invalidate_results", "result_cache_stats",
           "AdaptiveBatcher"]

_log = get_logger("plan.adaptive")


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

def enabled() -> bool:
    """``TFT_ADAPTIVE`` gate (default on): adaptive block sizing and
    mid-plan re-planning. ``TFT_ADAPTIVE=0`` is bit-identical to the
    static layout by construction."""
    return env_bool("TFT_ADAPTIVE", True)


def result_cache_enabled() -> bool:
    """``TFT_RESULT_CACHE`` gate (default on) for the plan-fingerprint
    result cache."""
    return env_bool("TFT_RESULT_CACHE", True)


def replan_ratio() -> float:
    """Observed-vs-priced selectivity deviation (either direction)
    beyond which the executor re-plans the remaining stages
    (``TFT_REPLAN_RATIO``, default 4)."""
    return max(env_float("TFT_REPLAN_RATIO", 4.0), 1.0)


def _max_block_bytes(depth: int) -> int:
    """Per-block ceiling for the re-bucketed layout: the ledger's
    budget split across a full pipeline window (with 2x dispatch
    headroom, the executor's own reservation estimate) when a budget
    exists, else ``TFT_ADAPTIVE_MAX_BLOCK_BYTES`` (default 64 MiB)."""
    cap = env_int("TFT_ADAPTIVE_MAX_BLOCK_BYTES", 64 << 20)
    from .. import memory as _memory
    mgr = _memory.active()
    if mgr is not None and mgr.limit is not None:
        cap = min(cap, max(1, mgr.limit // max(2 * depth, 2)))
    return max(cap, 1)


# ---------------------------------------------------------------------------
# per-plan stream feedback (leg 1's measurement half)
# ---------------------------------------------------------------------------

class StreamFeedback:
    """Accumulated observations of one plan shape's forcings."""

    __slots__ = ("forcings", "blocks", "rows", "wall_s", "occupancy")

    def __init__(self):
        self.forcings = 0
        self.blocks = 0
        self.rows = 0
        self.wall_s = 0.0
        self.occupancy: Optional[float] = None  # latest mean window occ

    def mean_block_rows(self) -> float:
        return self.rows / max(self.blocks, 1)

    def per_block_wall(self) -> float:
        return self.wall_s / max(self.blocks, 1)


_fb_lock = threading.Lock()
_feedback: "OrderedDict[str, StreamFeedback]" = OrderedDict()
_FEEDBACK_CAP = 256


def record_stream_feedback(key: str, blocks: int, rows: int,
                           wall_s: float,
                           occupancy: Optional[float] = None) -> None:
    """Fold one forcing's observations into the plan shape's record
    (LRU-capped registry; keys are the plan's stable stream tags)."""
    with _fb_lock:
        fb = _feedback.get(key)
        if fb is None:
            fb = _feedback[key] = StreamFeedback()
        _feedback.move_to_end(key)
        fb.forcings += 1
        fb.blocks += int(blocks)
        fb.rows += int(rows)
        fb.wall_s += float(wall_s)
        if occupancy is not None:
            fb.occupancy = float(occupancy)
        while len(_feedback) > _FEEDBACK_CAP:
            _feedback.popitem(last=False)
    # the same measured wall that calibrates layouts attributes the
    # serving query's cost in the performance sentinel's baselines
    from ..observability import baseline as _baseline
    _baseline.note_stage_wall(wall_s)


def stream_feedback(key: str) -> Optional[StreamFeedback]:
    with _fb_lock:
        fb = _feedback.get(key)
        if fb is not None:
            _feedback.move_to_end(key)
        return fb


# ---------------------------------------------------------------------------
# adaptive block layout (leg 1's decision half)
# ---------------------------------------------------------------------------

def _col_bytes(col) -> int:
    if isinstance(col, np.ndarray):
        return int(col.nbytes)
    return 8 * len(col)  # ragged ride-alongs: pointer-priced


class Layout:
    """A re-bucketed execution layout over one forcing's leaf blocks.

    ``units`` is the list the executor actually streams: each entry is
    ``(blocks, counts, orig_list)`` — the leaf blocks (or the slices of
    one split block) the unit runs as one, the rows of each of them (an
    int64 array), and the original index of each. A unit of several blocks is merged only when the executor
    stages it (``plan/execute.py``), so no coalesced copy outlives its
    dispatch; ``schema`` is the leaf schema that merge follows.
    ``empty_blocks`` are the 0-row originals
    (excluded from execution; the executor replays their empty-chain
    semantics verbatim). The executor counts each piece's rows that
    survive every host-side mask and re-splits the final outputs on the
    original boundaries, so the adaptive run is bit-identical to the
    static one, block boundaries included.
    """

    __slots__ = ("units", "schema", "empty_blocks", "n_orig",
                 "coalesced_from", "splits")

    def __init__(self, units, schema, empty_blocks, n_orig, coalesced_from,
                 splits):
        self.units = units
        self.schema = schema
        self.empty_blocks = empty_blocks  # [(orig index, block)]
        self.n_orig = n_orig
        self.coalesced_from = coalesced_from
        self.splits = splits


def _slice_cols(block, names: Sequence[str], lo: int, hi: int):
    out: Dict[str, object] = {}
    for n in names:
        c = block.columns[n]
        out[n] = c[lo:hi] if isinstance(c, np.ndarray) else list(c[lo:hi])
    return out


def choose_layout(plan, leaf_blocks, depth: int,
                  key: str) -> Optional["Layout"]:
    """The coalesce/split pass, or ``None`` for the static layout.

    Engages only (a) after a prior measured forcing of the same plan
    shape (:func:`record_stream_feedback` — the first forcing is
    always static, so the decision is fed by observation, not
    guesswork), and (b) when the re-bucketing actually changes the
    stream: more blocks than ``depth`` full slots need (coalesce), or
    a single block past twice the ledger-derived per-block ceiling
    (split). The chosen size targets ``depth`` equally-full slots
    within that ceiling.
    """
    fb = stream_feedback(key)
    if fb is None:
        return None  # first forcing: measure before adapting
    from ..frame import Block
    names = list(plan.leaf_required)
    # the restricted leaf schema drives the merge of a unit's blocks at
    # staging (Block.concat semantics: shape unification, ragged
    # fallback), so coalesced leaves can never drift from frame semantics
    try:
        concat_schema = plan.leaf.schema.select(names)
    except Exception as e:  # noqa: BLE001 - a leaf shape we can't cut
        _log.debug("adaptive layout: leaf schema unselectable (%s); "
                   "keeping the static layout", e)
        return None
    entries = []  # (orig index, block, bytes)
    empty_blocks = []
    for i, b in enumerate(leaf_blocks):
        if b.num_rows == 0:
            empty_blocks.append((i, b))
            continue
        if any(n not in b.columns for n in names):
            return None  # a leaf shape the pass did not expect
        entries.append((i, b, sum(_col_bytes(b.columns[n])
                                  for n in names)))
    if not entries:
        return None
    total_bytes = sum(e[2] for e in entries)
    max_bytes = _max_block_bytes(depth)
    ideal = max(depth, -(-total_bytes // max_bytes))
    needs_coalesce = len(entries) > max(ideal, 1) * 2
    needs_split = any(e[2] > 2 * max_bytes for e in entries)
    if not needs_coalesce and not needs_split:
        return None
    target_bytes = max(1, min(max_bytes, -(-total_bytes // ideal)))
    units = []
    coalesced_from = 0
    splits = 0
    run: List[Tuple[int, object, int]] = []
    run_bytes = 0

    def flush_run():
        nonlocal run, run_bytes, coalesced_from
        if not run:
            return
        if len(run) > 1:
            coalesced_from += len(run)
        units.append(([e[1] for e in run],
                      np.array([e[1].num_rows for e in run], np.int64),
                      [e[0] for e in run]))
        run, run_bytes = [], 0

    for i, b, nb in entries:
        if nb > 2 * max_bytes and b.num_rows > 1:
            # oversized block: split row-even into ceiling-sized parts
            flush_run()
            parts = min(int(-(-nb // max_bytes)), b.num_rows)
            bounds = np.linspace(0, b.num_rows, parts + 1).astype(int)
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                if hi <= lo:
                    continue
                pb = Block(_slice_cols(b, names, int(lo), int(hi)),
                           int(hi - lo))
                units.append(([pb], np.array([pb.num_rows], np.int64),
                              [i]))
            splits += 1
            continue
        if run and run_bytes + nb > target_bytes:
            flush_run()
        run.append((i, b, nb))
        run_bytes += nb
    flush_run()
    if len(units) == len(entries) and not splits:
        return None  # the pass changed nothing; keep the static stream
    counters.inc("plan.adaptive_layouts")
    if coalesced_from:
        counters.inc("plan.adaptive_coalesces")
    if splits:
        counters.inc("plan.adaptive_splits", splits)
    _log.debug("adaptive layout: %d leaf block(s) -> %d unit(s) "
               "(coalesced %d, split %d; target %d B/block, depth %d)",
               len(leaf_blocks), len(units), coalesced_from, splits,
               target_bytes, depth)
    return Layout(units, concat_schema, empty_blocks, len(leaf_blocks),
                  coalesced_from, splits)


# ---------------------------------------------------------------------------
# adaptive stream batch sizing (leg 1, streaming half)
# ---------------------------------------------------------------------------

class AdaptiveBatcher:
    """AIMD row-target sizer for a stream's batches: a batch that
    finished faster than ``TFT_ADAPTIVE_BATCH_MIN_S`` (default 5 ms) was
    dispatch-bound —
    double the row target; one slower than ``TFT_ADAPTIVE_BATCH_MAX_S``
    (default 100 ms) risks the ledger and latency — halve it. The
    target is capped so one batch stays within the ledger-derived
    per-block ceiling. With ``TFT_ADAPTIVE=0`` the sizer reports the
    pass-through target (one source block per batch)."""

    __slots__ = ("target", "row_bytes", "_min_s", "_max_s")

    def __init__(self, row_bytes: int = 8):
        self.target = 0  # 0 = pass-through until first observation
        self.row_bytes = max(int(row_bytes), 1)
        self._min_s = env_float("TFT_ADAPTIVE_BATCH_MIN_S", 0.005)
        self._max_s = env_float("TFT_ADAPTIVE_BATCH_MAX_S", 0.100)

    def cap_rows(self) -> int:
        from ..engine.pipeline import pipeline_depth
        return max(1, _max_block_bytes(pipeline_depth())
                   // self.row_bytes)

    def observe(self, rows: int, wall_s: float) -> None:
        if not enabled() or rows <= 0:
            return
        if self.target <= 0:
            self.target = int(rows)
        if wall_s < self._min_s:
            self.target = min(self.target * 2, self.cap_rows())
            counters.inc("stream.batch_grows")
        elif wall_s > self._max_s:
            self.target = max(self.target // 2, 1)
            counters.inc("stream.batch_shrinks")

    def want_more(self, buffered_rows: int) -> bool:
        """True while the handle should keep polling the source to fill
        the current batch."""
        return (enabled() and self.target > 0
                and buffered_rows < self.target
                and buffered_rows < self.cap_rows())


# ---------------------------------------------------------------------------
# plan-fingerprint result cache (leg 3)
# ---------------------------------------------------------------------------

class _CacheEntry:
    """One interned result. Its host bytes are accounted by the
    cache's OWN gauge (``tft_plan_result_cache_bytes``), not the
    frame-cache gauge: every frame served from the entry registers the
    same shared block list there already, and a second registration
    would double-count the bytes."""

    __slots__ = ("key", "_cache", "nbytes", "comps", "validators",
                 "__weakref__")

    def __init__(self, key, blocks, nbytes, comps, validators):
        self.key = key
        self._cache = blocks
        self.nbytes = nbytes
        self.comps = comps            # strong: pins the comp identities
        self.validators = validators  # [(frame weakref, version)]

    def valid(self) -> bool:
        # every pinned source must still be alive at the version it was
        # fingerprinted at (uncache() bumps _version; id() reuse after
        # GC is ruled out by the liveness check itself)
        for ref, version in self.validators:
            f = ref()
            if f is None or getattr(f, "_version", 0) != version:
                return False
        return True


_rc_lock = threading.Lock()
_results: "OrderedDict[tuple, _CacheEntry]" = OrderedDict()
_seen: "OrderedDict[tuple, float]" = OrderedDict()  # two-touch admission
_SEEN_CAP = 512


def _rc_budget() -> Tuple[int, int]:
    return (env_int("TFT_RESULT_CACHE_BYTES", 256 << 20),
            env_int("TFT_RESULT_CACHE_ENTRIES", 64))


# the packages whose functions, classes and modules a program state
# names, not walks: their globals are the library's, not the query's
_LIBRARIES = frozenset(("builtins", "math", "cmath", "operator", "functools",
                        "itertools", "numpy", "torch", "einops",
                        "tensorframes_tpu_torch"))
_STATE_BUDGET = 4096  # values walked per program before giving up


class _Unkeyable(Exception):
    """A value a program reads whose state no key can pin."""


def _library(module) -> bool:
    return isinstance(module, str) and \
        module.split(".", 1)[0] in _LIBRARIES


def _code_names(code) -> List[str]:
    names = list(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            names.extend(_code_names(c))
    return names


def _code_digest(code) -> str:
    h = hashlib.sha256(code.co_code)
    h.update(repr(code.co_names).encode())
    for c in code.co_consts:
        h.update(_code_digest(c).encode() if isinstance(c, types.CodeType)
                 else repr(c).encode())
    return h.hexdigest()


def program_state(comp) -> Optional[tuple]:
    """Everything ``comp``'s program reads besides its inputs, by value,
    or ``None`` when some of it cannot be pinned.

    The port runs a captured program eagerly at every forcing (the JAX
    package's ``jit`` bakes its closure in at the first trace), so what
    its function reads — closure cells, defaults, the module globals its
    code names, recursively through the functions it calls — is part of
    its result, and of the result cache's key. Scalars, strings, dtypes
    and containers of them enter by value; library code (torch, numpy,
    this package) by name; a deserialized program by its archive's
    digest. A tensor, an array or any other object that can change in
    place (an ``nn.Module``, a DSL graph's nodes) makes the program
    unkeyable, and its chain is never cached. The key holds no address,
    so it means the same thing in another process."""
    from ..computation import Computation, TensorSpec, _Program
    from ..dtypes import DType
    from ..shape import Shape
    seen: Dict[int, int] = {}
    left = [_STATE_BUDGET]

    def fn_state(f) -> tuple:
        code = f.__code__
        cells = []
        for c in f.__closure__ or ():
            try:
                cells.append(walk(c.cell_contents))
            except ValueError:  # a cell not yet bound
                cells.append(("unbound",))
        out = ("fn", f.__module__, f.__qualname__, _code_digest(code),
               tuple(cells), walk(f.__defaults__), walk(f.__kwdefaults__))
        if _library(f.__module__):
            return out
        g = f.__globals__
        return out + (tuple((n, walk(g[n])) for n in _code_names(code)
                            if n in g),)

    def walk(v) -> tuple:
        left[0] -= 1
        if left[0] < 0:
            raise _Unkeyable("more state than the walk's budget")
        if v is None or isinstance(v, (bool, int, float, complex, str,
                                       bytes)):
            return (type(v).__name__, repr(v))
        if isinstance(v, (torch.dtype, torch.device, np.dtype, DType,
                          Shape, TensorSpec)):
            return (type(v).__name__, repr(v))
        if isinstance(v, np.generic):
            return ("np", v.dtype.str, v.tobytes())
        if isinstance(v, (torch.Tensor, np.ndarray)):
            raise _Unkeyable("a tensor or an array can change in place")
        if id(v) in seen:
            return ("ref", seen[id(v)])
        seen[id(v)] = len(seen)
        if isinstance(v, (tuple, list)):
            return (type(v).__name__,) + tuple(walk(x) for x in v)
        if isinstance(v, (set, frozenset)):
            return (type(v).__name__,) + tuple(sorted(repr(walk(x))
                                                      for x in v))
        if isinstance(v, dict):
            return ("dict",) + tuple((walk(k), walk(x))
                                     for k, x in v.items())
        if isinstance(v, types.FunctionType):
            return fn_state(v)
        if isinstance(v, types.MethodType):
            return ("method", walk(v.__func__), walk(v.__self__))
        if isinstance(v, functools.partial):
            return ("partial", walk(v.func), walk(v.args),
                    walk(v.keywords))
        if isinstance(v, Computation):
            return ("comp", walk(v.fn))
        if isinstance(v, _Program):
            digest = getattr(v, "_tft_digest", None)
            if digest is None:
                digest = v._tft_digest = hashlib.sha256(
                    v.archive).hexdigest()
            return ("program", digest)
        if isinstance(v, types.ModuleType) and _library(v.__name__):
            return ("module", v.__name__)
        if isinstance(v, type) and _library(v.__module__):
            return ("type", v.__module__, v.__qualname__)
        if isinstance(v, types.BuiltinFunctionType):
            owner = v.__self__
            if owner is None or isinstance(owner, (types.ModuleType, type)):
                return ("builtin", getattr(v, "__module__", None),
                        v.__qualname__)
            return ("builtin", v.__qualname__, walk(owner))
        if isinstance(v, (np.ufunc, torch._ops.OpOverloadPacket,
                          torch._ops.OpOverload)):
            return ("op", str(v))
        raise _Unkeyable(f"{type(v).__qualname__} has no state a key can "
                         f"pin")

    try:
        return walk(comp)
    except _Unkeyable as e:
        _log.debug("result cache: %r is unkeyable (%s)", comp, e)
        return None


def _node_fp(node, validators, comps, depth: int) -> Optional[tuple]:
    """Structural fingerprint of one plan node (None = unfingerprintable
    — the forcing is simply not cached). Join children recurse through
    :func:`_chain_fp` so their FULL upstream chains key the entry."""
    kind = node.kind
    if kind == "parquet":
        try:
            st = os.stat(node.path)
        except OSError:
            return None
        return ("pq", node.path, st.st_mtime_ns, st.st_size,
                node.row_group_offset, node.row_group_limit,
                node.columns, node.num_partitions)
    if kind == "source":
        f = node.frame
        if f is None or getattr(f, "_cache", None) is None:
            return None  # unforced source: no stable version to pin
        validators.append((weakref.ref(f), getattr(f, "_version", 0)))
        return ("src", id(f), getattr(f, "_version", 0))
    if kind == "join":
        left = _chain_fp(node.left, validators, comps, depth + 1)
        if left is None:
            return None
        if node.right is not None:
            right = _chain_fp(node.right, validators, comps, depth + 1)
            if right is None:
                return None
        elif node.build is not None:
            # pin the BuildTable itself: its identity IS the built
            # right side's content at build time
            validators.append((weakref.ref(node.build), 0))
            right = ("build", id(node.build))
        else:
            return None
        return ("join", left, right, node.on, node.how, node.strategy)
    if kind in ("map_blocks", "map_rows", "filter"):
        state = program_state(node.comp)
        if state is None:
            return None
        if kind == "map_blocks":
            return ("mb", id(node.comp), state, node.trim)
        return ("mr" if kind == "map_rows" else "f", id(node.comp), state)
    if kind == "select":
        return ("sel", node.names)
    return None


def _chain_fp(node, validators, comps, depth: int) -> Optional[tuple]:
    """Fingerprint a whole ``input``-linked chain, leaf included."""
    parts: List[tuple] = []
    while node is not None and depth < 256:
        fp = _node_fp(node, validators, comps, depth)
        if fp is None:
            return None
        parts.append(fp)
        comp = getattr(node, "comp", None)
        if comp is not None:
            comps.append(comp)
        if node.kind == "join":
            node = None  # joins are leaves; children folded in above
        else:
            node = node.input
        depth += 1
    if node is not None:
        return None  # depth guard tripped: give up rather than collide
    return tuple(parts)


def fingerprint(frame) -> Optional[Tuple[tuple, list, list]]:
    """``(key, validators, comps)`` of a frame's recorded chain, or
    ``None`` when any node is unfingerprintable (fresh per-call
    computations, unforced sources, exotic leaves)."""
    node = getattr(frame, "_plan_node", None)
    if node is None:
        return None
    validators: List = []
    comps: List = []
    parts = _chain_fp(node, validators, comps, 0)
    if parts is None or len(parts) < 2:
        return None  # a bare leaf: its own block cache already covers it
    key = (parts, getattr(frame, "_version", 0))
    return key, validators, comps


def _portable_node_fp(node) -> Optional[tuple]:
    """Process-independent fingerprint of one plan node, or ``None``
    when the node's identity is process-local (``source`` pins a live
    frame by ``id()``; joins fold those in). Parquet leaves are already
    portable (footer identity: path + mtime + size); computations swap
    their ``id()`` for the structural signature the compile cache
    shares across workers (``serve/cache.py``), beside their
    :func:`program_state`, which holds no address."""
    kind = node.kind
    if kind == "parquet":
        try:
            st = os.stat(node.path)
        except OSError:
            return None
        return ("pq", node.path, st.st_mtime_ns, st.st_size,
                node.row_group_offset, node.row_group_limit,
                node.columns, node.num_partitions)
    if kind in ("map_blocks", "map_rows", "filter"):
        from ..serve.cache import computation_signature
        sig = computation_signature(node.comp)
        state = program_state(node.comp)
        if sig is None or state is None:
            return None
        if kind == "map_blocks":
            return ("mb", sig, state, node.trim)
        return ("mr" if kind == "map_rows" else "f", sig, state)
    if kind == "select":
        return ("sel", node.names)
    return None  # source/join: identity is this process's memory


def portable_fingerprint(frame) -> Optional[str]:
    """A fingerprint of ``frame``'s chain that means the same thing in
    ANOTHER process, or ``None`` when the chain has no portable
    identity. This is the durable result tier's key
    (``memory/persist.py``): a restarted worker that rebuilds the same
    parquet-rooted chain derives the same digest and serves the
    persisted result with zero dispatches — a warm hit. Chains rooted
    in in-memory frames are never persisted (their identity dies with
    the process that built them)."""
    node = getattr(frame, "_plan_node", None)
    if node is None:
        return None
    parts: List[tuple] = []
    has_pq = False
    depth = 0
    while node is not None and depth < 256:
        fp = _portable_node_fp(node)
        if fp is None:
            return None
        has_pq = has_pq or fp[0] == "pq"
        parts.append(fp)
        node = node.input
        depth += 1
    if node is not None or len(parts) < 2 or not has_pq:
        return None
    raw = repr((tuple(parts), getattr(frame, "_version", 0)))
    return hashlib.sha256(raw.encode()).hexdigest()


def _identity_node_fp(node) -> Optional[tuple]:
    """One plan node's identity for :func:`query_fingerprint`: the JAX
    package's rule, the structural signature of a node's program without
    the values it reads (a baseline keyed by a program whose state moved
    only calibrates another baseline, never serves a wrong result, so it
    needs none of :func:`program_state`'s soundness); ``("src", ...)``
    for an in-memory leaf, ``None`` for a join or another leaf."""
    kind = node.kind
    if kind == "parquet":
        return _portable_node_fp(node)
    if kind in ("map_blocks", "map_rows", "filter"):
        from ..serve.cache import computation_signature
        sig = computation_signature(node.comp)
        if sig is None:
            return None
        if kind == "map_blocks":
            return ("mb", sig, node.trim)
        return ("mr" if kind == "map_rows" else "f", sig)
    if kind == "select":
        return ("sel", node.names)
    if kind == "source" and node.frame is not None:
        f = node.frame
        try:
            rows = f.estimated_rows()
        except Exception:  # noqa: BLE001 - lazy source
            rows = None
        return ("src", repr(getattr(f, "schema", None)), rows)
    return None


def query_fingerprint(frame) -> Optional[Tuple[str, bool]]:
    """``(digest, portable)`` identity of a frame's chain for the
    performance sentinel's cost baselines (``observability/baseline.py``)
    and the poison-query quarantine, or ``None`` when the chain has no
    usable identity (a bare leaf, a join). Programs count by their
    structural signatures (:func:`_identity_node_fp`), so the same logical
    query re-submitted over fresh frame and program objects keeps one
    baseline. A parquet-rooted chain is portable: another process that
    builds the same chain over the same file derives the same digest, and
    its baseline persists (``memory/persist.py``). An in-memory leaf adds
    its schema and row estimate and is process-local, never persisted.

    Unlike the JAX package's, the digest is not the durable result tier's
    key: the port's :func:`portable_fingerprint` also holds each
    program's :func:`program_state`, which a DSL program does not have."""
    node = getattr(frame, "_plan_node", None)
    parts: List[tuple] = []
    portable = True
    has_pq = False
    depth = 0
    while node is not None and depth < 256:
        fp = _identity_node_fp(node)
        if fp is None:
            return None
        portable = portable and fp[0] != "src"
        has_pq = has_pq or fp[0] == "pq"
        parts.append(fp)
        node = node.input
        depth += 1
    if node is not None or len(parts) < 2:
        return None
    raw = repr((tuple(parts), getattr(frame, "_version", 0)))
    return (hashlib.sha256(raw.encode()).hexdigest(),
            portable and has_pq)


def aggregate_fingerprint(grouped, fetches) -> Optional[Tuple[str, bool]]:
    """``(digest, portable)`` identity of ``aggregate(fetches, grouped)``
    served as one query (``QueryScheduler.submit(grouped, fetches)``, a
    form the JAX package's scheduler does not take): the grouped chain's
    :func:`query_fingerprint` with the keys and each column's combiner,
    so that the served aggregate and its bare chain keep apart baselines
    and quarantine streaks. ``None`` when the chain has no identity or a
    combiner is not a name (a sketch combiner, a program)."""
    if not isinstance(fetches, dict) or not fetches or not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in fetches.items()):
        return None
    base = query_fingerprint(grouped.frame)
    if base is None:
        return None
    raw = repr((base[0], "aggregate", tuple(grouped.keys),
                tuple(sorted(fetches.items()))))
    return hashlib.sha256(raw.encode()).hexdigest(), base[1]


def _warm_lookup(frame, key, validators, comps) -> Optional[List]:
    """The durable tier's half of a miss: load the persisted result
    for the frame's PORTABLE fingerprint and re-admit it into the
    in-memory LRU under the live key. Counted separately
    (``plan.result_cache_warm_hits``) — a warm hit is a restart
    surviving, not a repeat forcing."""
    from ..memory import persist as _persist
    if not _persist.enabled():
        return None
    pfp = portable_fingerprint(frame)
    if pfp is None:
        return None
    blocks = _persist.load_result(pfp)
    if blocks is None:
        return None
    from ..memory.estimate import blocks_estimate
    _, nbytes = blocks_estimate(blocks)
    max_bytes, max_entries = _rc_budget()
    if nbytes <= max_bytes:
        entry = _CacheEntry(key, list(blocks), int(nbytes), comps,
                            validators)
        with _rc_lock:
            if key not in _results:
                _admit_locked(key, entry, max_bytes, max_entries)
    counters.inc("plan.result_cache_warm_hits")
    counters.inc("plan.result_cache_hit_bytes", int(nbytes))
    from ..observability import flight as _flight
    from ..observability.events import add_event
    add_event("result_cache_warm_hit", name=frame._plan,
              bytes=int(nbytes), blocks=len(blocks))
    _flight.record("plan.result_cache_warm_hit", bytes=int(nbytes),
                   blocks=len(blocks), fingerprint=pfp[:16])
    _log.info("warm result-cache hit for %s from the durable tier "
              "(%d block(s), %d B)", frame._plan, len(blocks), nbytes)
    return list(blocks)


def cached_result(frame) -> Optional[List]:
    """The interned blocks for ``frame``'s fingerprint, or ``None``
    (miss / disabled / unfingerprintable). A memory miss falls through
    to the durable tier (:func:`_warm_lookup`) before reporting cold."""
    if not result_cache_enabled():
        return None
    fp = fingerprint(frame)
    if fp is None:
        return None
    key, validators, comps = fp
    with _rc_lock:
        entry = _results.get(key)
        if entry is not None and not entry.valid():
            _results.pop(key, None)
            counters.inc("plan.result_cache_invalidations")
            entry = None
        if entry is not None:
            _results.move_to_end(key)
    if entry is None:
        warm = _warm_lookup(frame, key, validators, comps)
        if warm is not None:
            return warm
        # the "seen" mark is recorded by offer_result AFTER the
        # forcing, so admission counts FORCINGS, not lookups
        counters.inc("plan.result_cache_misses")
        return None
    counters.inc("plan.result_cache_hits")
    counters.inc("plan.result_cache_hit_bytes", entry.nbytes)
    from ..observability import flight as _flight
    from ..observability.events import add_event
    add_event("result_cache_hit", name=frame._plan, bytes=entry.nbytes,
              blocks=len(entry._cache))
    _flight.record("plan.result_cache_hit", bytes=entry.nbytes,
                   blocks=len(entry._cache))
    _log.debug("result cache hit for %s (%d block(s), %d B)",
               frame._plan, len(entry._cache), entry.nbytes)
    return list(entry._cache)


def _admit_locked(key, entry: _CacheEntry, max_bytes: int,
                  max_entries: int) -> List[_CacheEntry]:
    """Insert ``entry`` and LRU-sweep to budget. Caller holds
    ``_rc_lock``. Returns the evicted entries."""
    evicted: List[_CacheEntry] = []
    _results[key] = entry
    total = sum(e.nbytes for e in _results.values())
    while _results and (total > max_bytes
                        or len(_results) > max_entries):
        _, old = _results.popitem(last=False)
        total -= old.nbytes
        evicted.append(old)
    counters.inc("plan.result_cache_insertions")
    if evicted:
        counters.inc("plan.result_cache_evictions", len(evicted))
    gauge("plan.result_cache_bytes", total)
    gauge("plan.result_cache_entries", len(_results))
    return evicted


def offer_result(frame, blocks) -> None:
    """Intern a just-forced result. Two-touch admission: stored only
    when the same fingerprint was already seen once (hot queries repeat;
    one-off forcings and per-batch stream chains never re-key)."""
    if not result_cache_enabled() or not blocks:
        return
    fp = fingerprint(frame)
    if fp is None:
        return
    key, validators, comps = fp
    from ..memory.estimate import blocks_estimate
    _, nbytes = blocks_estimate(blocks)
    max_bytes, max_entries = _rc_budget()
    if nbytes > max_bytes:
        return
    evicted: List[_CacheEntry] = []
    with _rc_lock:
        if key in _results:
            return
        if _seen.pop(key, None) is None:
            # first sighting: record it, store nothing yet
            _seen[key] = time.monotonic()
            while len(_seen) > _SEEN_CAP:
                _seen.popitem(last=False)
            return
        entry = _CacheEntry(key, list(blocks), int(nbytes), comps,
                            validators)
        evicted = _admit_locked(key, entry, max_bytes, max_entries)
    from ..observability import flight as _flight
    _flight.record("plan.result_cache_admit", bytes=int(nbytes),
                   entries=len(blocks))
    if evicted:
        _flight.record("plan.result_cache_evict", entries=len(evicted),
                       bytes=sum(e.nbytes for e in evicted))
    from ..memory import persist as _persist
    if _persist.enabled():
        # write-through to the durable tier under the PORTABLE key:
        # a rolling restart then serves this result warm, zero
        # dispatches (process-local chains have no portable key and
        # stay memory-only)
        pfp = portable_fingerprint(frame)
        if pfp is not None and _persist.save_result(pfp, list(blocks)):
            _flight.record("plan.result_cache_persist",
                           bytes=int(nbytes), fingerprint=pfp[:16])


def invalidate_results() -> None:
    """Drop every interned result (tests; explicit source rewrites)."""
    with _rc_lock:
        _results.clear()
        _seen.clear()
        gauge("plan.result_cache_bytes", 0)
        gauge("plan.result_cache_entries", 0)


def result_cache_stats() -> Dict[str, int]:
    with _rc_lock:
        return {"entries": len(_results),
                "bytes": sum(e.nbytes for e in _results.values())}


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

_FAMILIES = (
    ("plan.result_cache_hits", "tft_plan_result_cache_hits_total",
     "Forcings served from the plan-fingerprint result cache."),
    ("plan.result_cache_misses", "tft_plan_result_cache_misses_total",
     "Result-cache lookups that missed."),
    ("plan.result_cache_warm_hits",
     "tft_plan_result_cache_warm_hits_total",
     "Memory misses served from the durable tier (restart survived)."),
    ("plan.result_cache_hit_bytes",
     "tft_plan_result_cache_hit_bytes_total",
     "Host bytes served from the result cache."),
    ("plan.result_cache_insertions",
     "tft_plan_result_cache_insertions_total",
     "Results interned (two-touch admission)."),
    ("plan.result_cache_evictions",
     "tft_plan_result_cache_evictions_total",
     "Entries LRU-evicted under the byte/entry budget."),
    ("plan.result_cache_invalidations",
     "tft_plan_result_cache_invalidations_total",
     "Entries dropped because a pinned source died or re-versioned."),
    ("plan.adaptive_layouts", "tft_plan_adaptive_layouts_total",
     "Forcings that ran a re-bucketed (coalesced/split) block layout."),
    ("plan.adaptive_coalesces", "tft_plan_adaptive_coalesces_total",
     "Adaptive layouts that merged dispatch-bound small blocks."),
    ("plan.adaptive_splits", "tft_plan_adaptive_splits_total",
     "Oversized blocks split to fit the ledger-derived ceiling."),
    ("plan.replans", "tft_plan_replans_total",
     "Mid-plan re-plans after an estimate missed by TFT_REPLAN_RATIO."),
    ("plan.filter_reorders", "tft_plan_filter_reorders_total",
     "Conjunctive filter runs re-ordered by observed selectivity."),
    ("stream.batch_grows", "tft_stream_batch_grows_total",
     "Adaptive stream batch targets doubled (dispatch-bound batches)."),
    ("stream.batch_shrinks", "tft_stream_batch_shrinks_total",
     "Adaptive stream batch targets halved (over-long batches)."),
)


def _render_metrics() -> List[str]:
    snap = counters.snapshot()
    lines: List[str] = []
    for key, fam, help_text in _FAMILIES:
        lines.append(f"# HELP {fam} {help_text}")
        lines.append(f"# TYPE {fam} counter")
        lines.append(f"{fam} {snap.get(key, 0)}")
    stats = result_cache_stats()
    lines.append("# HELP tft_plan_result_cache_bytes Host bytes "
                 "currently interned in the result cache.")
    lines.append("# TYPE tft_plan_result_cache_bytes gauge")
    lines.append(f"tft_plan_result_cache_bytes {stats['bytes']}")
    return lines


from ..observability import metrics as _metrics  # noqa: E402

_metrics.register_metrics_provider("plan.adaptive", _render_metrics)
