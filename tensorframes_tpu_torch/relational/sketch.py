"""Mergeable sketch aggregates: HLL, relative-error quantiles, top-k.

The port's counterpart of ``tensorframes_tpu/relational/sketch.py``. Each
sketch is a :class:`SketchCombiner`, a monoid over fixed-width per-group
state tables, so it drops into the same ``{column: combiner}`` mapping of
``aggregate`` that the scalar monoids (sum/min/max/prod) use: per-block
partial tables (``engine.ops._monoid_aggregate``) folded across blocks with
the sketch's combine.

Determinism: hashing and bucketing run on the host in float64/uint64
(``_hash64`` is a fixed splitmix64, with no process seed), and HLL and
quantile states fold with elementwise integer monoids, so the same rows give
BIT-IDENTICAL states here and in the JAX package. A ``bfloat16`` column is
f32 on this package's host; the JAX package hashes its bf16 cells through
f64 too, and both conversions are exact, so the hashes agree. Top-k
(Misra–Gries) is order-dependent in its exact state but keeps its error
guarantee under any merge order.

The fold of one block (:meth:`SketchCombiner._segment_fold`) runs on the
device at 4,096 rows or more, through the engine's segment reductions
(integer ``sum`` and ``scatter_reduce_(..., "amax")``, exact; the states
are int32, so the CUDA ``segment_sum`` kernel, which takes floats, is not
reached), and on the host below that. A device fold that fails raises: it
never falls back to the host.

Error bounds (held in ``tests/test_torch_relational.py``):

- HLL with ``2**bits`` registers: relative standard error
  ``1.04/sqrt(2**bits)``;
- quantile: within relative error ``sqrt(gamma) - 1`` (about ``alpha``) of
  the true quantile for values inside ``[min_value, max_value]``;
  out-of-range values clamp to the edge buckets;
- top-k: every item above ``n/(k+1)`` survives, counts within ``n/(k+1)``.

Not in this package yet: the stream and ``daggregate`` folds of the
sketches (the stream and parallel layers).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..schema import Field
from ..shape import Shape, Unknown

__all__ = ["SketchCombiner", "hll_sketch", "quantile_sketch",
           "top_k_sketch", "approx_distinct", "approx_quantile",
           "approx_top_k"]

# rows from which a block's fold runs on the device (below it, dispatch
# overhead dominates and the host folds)
DEVICE_FOLD_ROWS = 4096


# ---------------------------------------------------------------------------
# deterministic 64-bit hashing (host, vectorized)
# ---------------------------------------------------------------------------

def _splitmix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer over uint64 lanes (fixed constants, no
    process seed: the same rows hash the same in every path/process)."""
    with np.errstate(over="ignore"):
        z = x + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _hash64(values: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit hashes of a scalar column (numeric fast path
    over raw bit patterns; strings through blake2b)."""
    a = np.asarray(values)
    if a.dtype == object:
        import hashlib
        out = np.empty(len(a), np.uint64)
        for i, s in enumerate(a):
            h = hashlib.blake2b(str(s).encode("utf-8"),
                                digest_size=8).digest()
            out[i] = np.uint64(int.from_bytes(h, "little"))
        return _splitmix64(out)
    if a.dtype.kind == "f":
        # floats hash through f64 (exact from f32, and from bf16, which
        # this package stores as f32)
        x = np.ascontiguousarray(np.asarray(a, np.float64))
        # canonicalize -0.0 == 0.0 and all NaN payloads before hashing
        x = np.where(x == 0.0, 0.0, x)
        x = np.where(np.isnan(x), np.float64(np.nan), x)
        return _splitmix64(x.view(np.uint64))
    if a.dtype.kind == "b":
        return _splitmix64(a.astype(np.uint64))
    return _splitmix64(np.ascontiguousarray(a).astype(np.int64)
                       .view(np.uint64))


def _clz64(w: np.ndarray) -> np.ndarray:
    """Leading-zero count of uint64 lanes (0 -> 64), vectorized binary
    descent (6 steps, no per-row Python)."""
    n = np.zeros(w.shape, np.int64)
    x = np.asarray(w, np.uint64).copy()
    for b in (32, 16, 8, 4, 2, 1):
        top_zero = x < (np.uint64(1) << np.uint64(64 - b))
        n = np.where(top_zero, n + b, n)
        with np.errstate(over="ignore"):
            x = np.where(top_zero, x << np.uint64(b), x)
    return np.where(np.asarray(w) == 0, 64, n).astype(np.int32)


# ---------------------------------------------------------------------------
# the combiner protocol
# ---------------------------------------------------------------------------

class SketchCombiner:
    """A mergeable summary usable wherever a scalar combiner name is.

    State is a ``[groups, state_width]`` array of ``state_dtype``.
    ``elementwise`` names the scalar monoid the state merges with
    (``"max"`` / ``"sum"``), which the device fold reuses; ``None`` means
    the state merges through :meth:`combine_np` on the host (top-k).
    """

    name = "sketch"
    elementwise: Optional[str] = None
    state_width: int = 0
    state_dtype = np.int32

    # -- validation --------------------------------------------------------
    def validate_input(self, field) -> None:
        """Raise for a column this sketch cannot summarize."""

    # -- state -------------------------------------------------------------
    def neutral_table(self, groups: int) -> np.ndarray:
        return np.zeros((groups, self.state_width), self.state_dtype)

    def block_partial(self, values, ids: np.ndarray, num_groups: int,
                      device=None) -> np.ndarray:
        """One block of rows -> a ``[num_groups, S]`` state table (host
        values in their storage dtype; ``ids`` dense group ids per row).
        ``device`` is where a large block folds (default: the package's
        default device)."""
        raise NotImplementedError

    def combine_np(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Elementwise fold of two aligned state tables (exact for the
        integer states)."""
        if self.elementwise == "max":
            return np.maximum(a, b)
        if self.elementwise == "sum":
            return a + b
        raise NotImplementedError

    def merge_tables(self, old: np.ndarray, idx_old: np.ndarray,
                     new: np.ndarray, idx_new: np.ndarray,
                     m: int) -> np.ndarray:
        """Scatter-merge into a ``[m, S]`` union table."""
        out = self.neutral_table(m)
        out[idx_old] = old
        out[idx_new] = self.combine_np(out[idx_new], new)
        return out

    # -- output ------------------------------------------------------------
    def out_fields(self, name: str, in_field) -> List[Field]:
        raise NotImplementedError

    def finalize(self, name: str,
                 table: np.ndarray) -> Dict[str, np.ndarray]:
        """State table -> the output column(s) named by
        :meth:`out_fields`."""
        raise NotImplementedError

    def _segment_fold(self, slot: np.ndarray, weight: np.ndarray,
                      ids: np.ndarray, num_groups: int,
                      device=None) -> np.ndarray:
        """Shared scatter core: fold per-row ``weight`` into state slot
        ``(group, slot)`` with the sketch's elementwise monoid. From
        :data:`DEVICE_FOLD_ROWS` rows, ONE device segment reduction over
        the combined id space (``engine.ops._segment_reduce``, the monoid
        ``aggregate``'s own); below that, on the host. A device fold that
        fails raises."""
        S = self.state_width
        combined = ids.astype(np.int64) * S + slot.astype(np.int64)
        if len(combined) >= DEVICE_FOLD_ROWS:
            import torch

            from ..device import resolve_device
            from ..engine.executor import to_host
            from ..engine.ops import _segment_reduce
            dev = resolve_device(device)
            w = torch.from_numpy(np.ascontiguousarray(
                weight.astype(self.state_dtype))).to(dev)
            flat = to_host(_segment_reduce(
                self.elementwise, w, torch.from_numpy(combined).to(dev),
                num_groups * S))
            table = flat.reshape(num_groups, S)
            if self.elementwise == "max":
                # empty (group, slot) cells hold the segment identity
                # (int min); sketch registers are >= 0
                table = np.maximum(table, 0)
            return table.astype(self.state_dtype)
        table = self.neutral_table(num_groups)
        flat = table.reshape(-1)
        if self.elementwise == "max":
            np.maximum.at(flat, combined, weight.astype(self.state_dtype))
        else:
            np.add.at(flat, combined, weight.astype(self.state_dtype))
        return table


def _require_scalar_tensor(field, what: str) -> None:
    if field.sql_rank != 0:
        raise ValueError(
            f"{what} expects a scalar column; {field.name!r} holds "
            f"rank-{field.sql_rank} cells")


# ---------------------------------------------------------------------------
# HyperLogLog distinct counts
# ---------------------------------------------------------------------------

class HllSketch(SketchCombiner):
    """HyperLogLog distinct-count sketch: ``2**bits`` int32 registers per
    group, elementwise-max mergeable. Output: one int64 estimated distinct
    count per group; relative standard error ``1.04/sqrt(2**bits)``."""

    elementwise = "max"
    state_dtype = np.int32

    def __init__(self, bits: int = 10):
        if not 4 <= int(bits) <= 16:
            raise ValueError(f"hll bits must be in [4, 16], got {bits}")
        self.bits = int(bits)
        self.m = 1 << self.bits
        self.state_width = self.m
        self.name = f"approx_distinct(bits={self.bits})"

    @property
    def relative_error(self) -> float:
        return 1.04 / math.sqrt(self.m)

    def validate_input(self, field) -> None:
        _require_scalar_tensor(field, "approx_distinct")

    def block_partial(self, values, ids, num_groups, device=None):
        h = _hash64(values)
        reg = (h >> np.uint64(64 - self.bits)).astype(np.int64)
        w = h << np.uint64(self.bits)
        rho = np.minimum(_clz64(w) + 1, 64 - self.bits + 1)
        return self._segment_fold(reg, rho, ids, num_groups, device)

    def out_fields(self, name, in_field):
        from .. import dtypes as _dt
        return [Field(name, _dt.int64, block_shape=Shape(Unknown),
                      sql_rank=0)]

    def finalize(self, name, table):
        m = float(self.m)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        est = alpha * m * m / np.sum(
            np.power(2.0, -np.asarray(table, np.float64)), axis=1)
        zeros = np.sum(table == 0, axis=1).astype(np.float64)
        small = (est <= 2.5 * m) & (zeros > 0)
        with np.errstate(divide="ignore"):
            lin = m * np.log(np.where(zeros > 0, m / np.maximum(zeros, 1),
                                      1.0))
        est = np.where(small, lin, est)
        return {name: np.rint(est).astype(np.int64)}


# ---------------------------------------------------------------------------
# DDSketch-style relative-error quantiles
# ---------------------------------------------------------------------------

class QuantileSketch(SketchCombiner):
    """Log-bucketed quantile sketch (DDSketch scheme): int32 bucket counts
    over a fixed gamma-geometric grid, elementwise-sum mergeable. For
    values with ``min_value <= |v| <= max_value`` the returned quantile is
    within relative error ``sqrt(gamma) - 1`` (~``alpha``); smaller
    magnitudes collapse into an exact-zero bucket, larger ones clamp to the
    edge bucket. NaN rows are DROPPED (a NaN has no quantile rank)."""

    elementwise = "sum"
    state_dtype = np.int32

    def __init__(self, qs=0.5, alpha: float = 0.02,
                 min_value: float = 1e-6, max_value: float = 1e6):
        if not 0.0 < alpha < 0.5:
            raise ValueError(f"alpha must be in (0, 0.5), got {alpha}")
        if not 0.0 < min_value < max_value:
            raise ValueError(
                f"need 0 < min_value < max_value, got "
                f"{min_value}/{max_value}")
        self.qs = tuple(float(q) for q in
                        (qs if isinstance(qs, (tuple, list)) else (qs,)))
        for q in self.qs:
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"quantile {q} not in [0, 1]")
        if not self.qs:
            raise ValueError("need at least one quantile")
        self.alpha = float(alpha)
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lg = math.log(self.gamma)
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        # per sign: buckets i cover [min * gamma^i, min * gamma^(i+1))
        self.side = int(math.ceil(
            math.log(max_value / min_value) / self._lg)) + 1
        # layout: [neg side (reversed)] [zero] [pos side]
        self.state_width = 2 * self.side + 1
        self.name = (f"approx_quantile(q={list(self.qs)}, "
                     f"alpha={self.alpha})")

    @property
    def relative_error(self) -> float:
        """The guaranteed in-range bound: reps sit at the geometric
        bucket midpoint, so error <= sqrt(gamma) - 1."""
        return math.sqrt(self.gamma) - 1.0

    def validate_input(self, field) -> None:
        _require_scalar_tensor(field, "approx_quantile")
        if not field.dtype.tensor:
            raise ValueError(
                f"approx_quantile needs a numeric column; {field.name!r} "
                f"is {field.dtype.name}")

    def _bucket(self, v: np.ndarray) -> np.ndarray:
        x = np.asarray(v, np.float64)
        mag = np.abs(x)
        with np.errstate(divide="ignore", invalid="ignore"):
            i = np.floor(np.log(np.maximum(mag, self.min_value)
                                / self.min_value) / self._lg)
        i = np.clip(np.nan_to_num(i, nan=0.0), 0,
                    self.side - 1).astype(np.int64)
        zero = mag < self.min_value
        slot = np.where(x >= 0, self.side + 1 + i, self.side - 1 - i)
        return np.where(zero, self.side, slot).astype(np.int64)

    def _rep(self, slot: int) -> float:
        if slot == self.side:
            return 0.0
        if slot > self.side:
            i = slot - self.side - 1
            return self.min_value * self.gamma ** (i + 0.5)
        i = self.side - 1 - slot
        return -self.min_value * self.gamma ** (i + 0.5)

    def block_partial(self, values, ids, num_groups, device=None):
        x = np.asarray(values, np.float64)
        keep = ~np.isnan(x)
        if not keep.all():
            # NaN is not a value with a quantile rank: drop it (a sketch
            # counting it as data would drag every quantile toward
            # -min_value)
            x = x[keep]
            ids = np.asarray(ids)[keep]
        slot = self._bucket(x)
        ones = np.ones(len(slot), np.int32)
        return self._segment_fold(slot, ones, ids, num_groups, device)

    def out_fields(self, name, in_field):
        from .. import dtypes as _dt
        if len(self.qs) == 1:
            return [Field(name, _dt.double, block_shape=Shape(Unknown),
                          sql_rank=0)]
        return [Field(name, _dt.double,
                      block_shape=Shape(Unknown, len(self.qs)),
                      sql_rank=1)]

    def finalize(self, name, table):
        t = np.asarray(table, np.int64)
        g = t.shape[0]
        cum = np.cumsum(t, axis=1)
        n = cum[:, -1]
        out = np.zeros((g, len(self.qs)), np.float64)
        reps = np.array([self._rep(s) for s in range(self.state_width)])
        for j, q in enumerate(self.qs):
            r = np.maximum(1, np.ceil(q * n).astype(np.int64))
            # first bucket whose cumulative count reaches rank r (cum rows
            # are non-decreasing, so the count of entries below the rank
            # IS the index)
            pos = (cum < r[:, None]).sum(axis=1)
            pos = np.minimum(pos, self.state_width - 1)
            out[:, j] = reps[pos]
            out[n == 0, j] = np.nan
        if len(self.qs) == 1:
            return {name: out[:, 0]}
        return {name: out}


# ---------------------------------------------------------------------------
# Misra–Gries top-k heavy hitters
# ---------------------------------------------------------------------------

class TopKSketch(SketchCombiner):
    """Misra–Gries heavy-hitter summary over an INTEGER column: ``k``
    (item, count) slots per group packed as a ``[G, 2k]`` int64 state
    (items first, counts second; count 0 marks an empty slot).

    After summarizing ``n`` rows, every item with true frequency >
    ``n/(k+1)`` is present, and every kept count is an under-estimate by
    at most ``n/(k+1)``, under any merge order. Merging is a host table
    fold (``elementwise=None``). String/float heavy hitters: factorize to
    integer ids upstream.
    """

    elementwise = None
    state_dtype = np.int64

    def __init__(self, k: int = 8):
        if int(k) < 1:
            raise ValueError(f"top-k needs k >= 1, got {k}")
        self.k = int(k)
        self.state_width = 2 * self.k
        self.name = f"approx_top_k(k={self.k})"

    def validate_input(self, field) -> None:
        _require_scalar_tensor(field, "approx_top_k")
        if not field.dtype.tensor or \
                np.dtype(field.dtype.np_storage).kind not in "iub":
            raise ValueError(
                f"approx_top_k summarizes integer columns; "
                f"{field.name!r} is {field.dtype.name} (factorize "
                f"strings/floats to ids first)")

    def _compress(self, items: np.ndarray,
                  counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Misra–Gries reduction to k slots: subtract the (k+1)-th
        largest count from all, keep the positive ones."""
        if len(items) > self.k:
            dec = np.partition(counts, -(self.k + 1))[-(self.k + 1)]
            counts = counts - dec
            keep = counts > 0
            items, counts = items[keep], counts[keep]
            if len(items) > self.k:  # ties at the cut: deterministic trim
                order = np.lexsort((items, -counts))[: self.k]
                items, counts = items[order], counts[order]
        out_i = np.zeros(self.k, np.int64)
        out_c = np.zeros(self.k, np.int64)
        order = np.lexsort((items, -counts))
        out_i[: len(items)] = items[order]
        out_c[: len(items)] = counts[order]
        return out_i, out_c

    def _rows(self, state_row: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        items = state_row[: self.k]
        counts = state_row[self.k:]
        live = counts > 0
        return items[live], counts[live]

    def block_partial(self, values, ids, num_groups, device=None):
        v = np.asarray(values).astype(np.int64)
        ids = np.asarray(ids, np.int64)
        order = np.lexsort((v, ids))
        sv, si = v[order], ids[order]
        changed = np.ones(len(sv), bool)
        if len(sv) > 1:
            changed[1:] = (sv[1:] != sv[:-1]) | (si[1:] != si[:-1])
        starts = np.flatnonzero(changed)
        pair_counts = np.diff(np.append(starts, len(sv)))
        pair_items, pair_gids = sv[starts], si[starts]
        table = self.neutral_table(num_groups)
        gchg = np.ones(len(pair_gids), bool)
        if len(pair_gids) > 1:
            gchg[1:] = pair_gids[1:] != pair_gids[:-1]
        gstarts = np.flatnonzero(gchg)
        gends = np.append(gstarts[1:], len(pair_gids))
        for a, b in zip(gstarts, gends):
            g = int(pair_gids[a])
            it, ct = self._compress(pair_items[a:b], pair_counts[a:b])
            table[g, : self.k] = it
            table[g, self.k:] = ct
        return table

    def combine_np(self, a, b):
        a = np.asarray(a)
        b = np.asarray(b)
        out = np.zeros_like(a)
        for g in range(a.shape[0]):
            ia, ca = self._rows(a[g])
            ib, cb = self._rows(b[g])
            items = np.concatenate([ia, ib])
            counts = np.concatenate([ca, cb])
            if len(items):
                u, inv = np.unique(items, return_inverse=True)
                summed = np.zeros(len(u), np.int64)
                np.add.at(summed, inv, counts)
                it, ct = self._compress(u, summed)
            else:
                it = ct = np.zeros(self.k, np.int64)
            out[g, : self.k] = it
            out[g, self.k:] = ct
        return out

    def out_fields(self, name, in_field):
        from .. import dtypes as _dt
        return [Field(name, _dt.int64,
                      block_shape=Shape(Unknown, self.k), sql_rank=1),
                Field(f"{name}_counts", _dt.int64,
                      block_shape=Shape(Unknown, self.k), sql_rank=1)]

    def finalize(self, name, table):
        t = np.asarray(table, np.int64)
        return {name: t[:, : self.k].copy(),
                f"{name}_counts": t[:, self.k:].copy()}


# ---------------------------------------------------------------------------
# public constructors (the names users put in the fetches mapping)
# ---------------------------------------------------------------------------

def hll_sketch(bits: int = 10) -> HllSketch:
    """A HyperLogLog distinct-count combiner (``2**bits`` registers)."""
    return HllSketch(bits=bits)


def quantile_sketch(qs=0.5, alpha: float = 0.02,
                    min_value: float = 1e-6,
                    max_value: float = 1e6) -> QuantileSketch:
    """A mergeable relative-error quantile combiner (DDSketch grid)."""
    return QuantileSketch(qs=qs, alpha=alpha, min_value=min_value,
                          max_value=max_value)


def top_k_sketch(k: int = 8) -> TopKSketch:
    """A Misra–Gries top-k heavy-hitter combiner."""
    return TopKSketch(k=k)


# ergonomic aliases matching the combiner-name idiom
approx_distinct = hll_sketch
approx_quantile = quantile_sketch
approx_top_k = top_k_sketch
