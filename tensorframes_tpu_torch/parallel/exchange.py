"""Hash-repartition exchange: rows routed to the shards that own their keys.

The port's counterpart of ``tensorframes_tpu/parallel/exchange.py``. Both
join strategies of a mesh otherwise funnel through one device (broadcast
holds the whole build side on every probe path, sort-merge sorts both
sides whole); the exchange *repartitions rows by key*:

- **splitmix64 of the key on the device**, the host sketches' hash
  (``relational/sketch.py``) computed over (hi, lo) 32-bit halves held in
  int64 lanes, its products from 16-bit partial products, so that no lane
  overflows and no unsigned 64-bit arithmetic is needed: for exact key
  dtypes (ints, f64) the device hash equals the host hash bit for bit,
  and f32 keys hash their own 32-bit pattern, as the JAX package's do;
- **per-shard, per-destination counts** read back as one ``S x S`` int32
  matrix (counted in ``mesh.interstage_host_bytes``), which sizes the
  buckets;
- **the swap**: each shard orders its valid rows by destination (a
  stable sort, so a bucket keeps its source order) and cuts them into
  ``S`` buckets at the counts; bucket ``d`` of every shard moves to shard
  ``d`` (a device-to-device copy, a no-op between logical shards of one
  card), where the received buckets lie in (source shard, source row)
  order, padded to ``S * cap`` rows, and the counts become the result's
  ``shard_valid``;
- **string ride-alongs** replayed on the host from a carried row id.

The exchange admits its buffers with the ledger
(``memory.estimate.exchange_buffer_bytes`` and ``make_room``) and reports
skew: the ``mesh.exchange_*`` counters, an ``explain()`` imbalance line
against ``TFT_SKEW_WARN``, the flight record ``mesh.exchange_skew`` and
``plan.adaptive.record_stream_feedback``.

``TFT_SHUFFLE=0`` is the kill switch of the consumers (``join()``'s
routing, :func:`shuffle_daggregate`, ``partitioned_hash_join``), which
then take the broadcast, dense and sort-merge paths; the exchange itself
stays callable. The exchange dispatches through the elastic boundary
(``elastic.elastic_call``): a device lost mid-exchange shrinks the mesh,
re-shards the input and exchanges again over the survivors (placement is
then the hash modulo the surviving shard count). Under a device budget
with spilling on, its result is a spill candidate of the memory ledger.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import memory as _memory
from ..engine import ops as _ops
from ..engine.executor import to_host
from ..frame import TensorFrame
from ..observability import flight as _flight
from ..observability.events import current_trace, traced_query
from ..resilience import invariants as _invariants
from ..utils.env import env_bool, env_int
from ..utils.logging import get_logger
from ..utils.tracing import counters, span
from . import elastic as _elastic
from .mesh import refuse_cluster

__all__ = ["dexchange", "shuffle_daggregate", "shuffle_enabled",
           "shuffle_agg_groups_threshold", "exchange_hash_host"]

_log = get_logger("parallel.exchange")


def shuffle_enabled() -> bool:
    """The shuffle kill switch (``TFT_SHUFFLE``, default on). Off, the
    consumers (``join()``'s routing, ``partitioned_hash_join``,
    :func:`shuffle_daggregate` and ``daggregate``'s high-cardinality
    route) take the broadcast, dense and sort-merge paths."""
    return env_bool("TFT_SHUFFLE", True)


def shuffle_agg_groups_threshold():
    """Group count above which ``daggregate``'s monoid host-key path
    routes to the shuffle-partitioned aggregate
    (``TFT_SHUFFLE_AGG_GROUPS``, default 131072; <= 0 turns the route
    off)."""
    v = env_int("TFT_SHUFFLE_AGG_GROUPS", 1 << 17)
    return v if v and v > 0 else None


# ---------------------------------------------------------------------------
# splitmix64 over (hi, lo) 32-bit halves in int64 lanes
# ---------------------------------------------------------------------------
# the host _splitmix64's three 64-bit constants as (hi, lo) halves

_M32 = 0xFFFFFFFF
_SM_GAMMA = (0x9E3779B9, 0x7F4A7C15)
_SM_MUL1 = (0xBF58476D, 0x1CE4E5B9)
_SM_MUL2 = (0x94D049BB, 0x133111EB)


def _add64(ah, al, bh, bl):
    """(a + b) mod 2^64 over (hi, lo) halves."""
    lo = al + bl
    return (ah + bh + (lo >> 32)) & _M32, lo & _M32


def _mul32_wide(a, b):
    """The full 64-bit product of two 32-bit halves as (hi, lo), from
    16-bit partial products (each below 2^33 in an int64 lane)."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    mid = a0 * b1 + a1 * b0
    lo = a0 * b0 + ((mid & 0xFFFF) << 16)
    return (a1 * b1 + (mid >> 16) + (lo >> 32)) & _M32, lo & _M32


def _mul_lo32(a, b):
    """(a * b) mod 2^32 of two 32-bit halves, exact in int64."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    return (a0 * b0 + (((a0 * b1 + a1 * b0) & 0xFFFF) << 16)) & _M32


def _mul64(ah, al, bh, bl):
    """(a * b) mod 2^64 over (hi, lo) halves."""
    hi, lo = _mul32_wide(al, bl)
    return (hi + _mul_lo32(al, bh) + _mul_lo32(ah, bl)) & _M32, lo


def _xorshr64(h, l, n: int):
    """z ^ (z >> n) for 0 < n < 32 over (hi, lo) halves."""
    return h ^ (h >> n), l ^ (((l >> n) | (h << (32 - n))) & _M32)


def _splitmix64_pair(h, l):
    """The splitmix64 finalizer over (hi, lo) halves: the host
    ``_splitmix64``'s constants and shifts, so the device hash of an
    exact key dtype equals the host hash bit for bit."""
    h, l = _add64(h, l, *_SM_GAMMA)
    h, l = _xorshr64(h, l, 30)
    h, l = _mul64(h, l, *_SM_MUL1)
    h, l = _xorshr64(h, l, 27)
    h, l = _mul64(h, l, *_SM_MUL2)
    return _xorshr64(h, l, 31)


def _key_pair(a: torch.Tensor):
    """A device key column as the (hi, lo) halves of the 64-bit value the
    host ``_hash64`` hashes: ints sign-extend to 64-bit two's complement,
    bools are 0/1, floats map -0.0 to 0.0 and every NaN to one NaN first.
    f32 (and narrower floats, widened to f32) hash their own 32-bit
    pattern: the same on both sides of a join, whose key dtypes match,
    though not the host's f64 widening."""
    if a.is_floating_point():
        if a.element_size() < 4:
            a = a.float()
        a = torch.where(a == 0, 0.0, a)
        a = torch.where(torch.isnan(a), float("nan"), a).contiguous()
        if a.element_size() == 8:
            v = a.view(torch.int64)
            return (v >> 32) & _M32, v & _M32
        lo = a.view(torch.int32).to(torch.int64) & _M32
        return torch.zeros_like(lo), lo
    if a.dtype == torch.bool or a.dtype == torch.uint8:
        lo = a.to(torch.int64)
        return torch.zeros_like(lo), lo
    v = a.to(torch.int64)
    return (v >> 32) & _M32, v & _M32


def _hash_pairs(key_cols):
    """Chain the per-key hashes as the host sketches do:
    ``h = hash(k0)``, then ``h = splitmix64(h ^ hash(k))`` for each further
    key, where ``hash(k) = splitmix64(bits64(k))``."""
    h = l = None
    for a in key_cols:
        kh, kl = _splitmix64_pair(*_key_pair(a))
        if h is None:
            h, l = kh, kl
        else:
            h, l = _splitmix64_pair(h ^ kh, l ^ kl)
    return h, l


def _dest_from_hash(h, l, S: int) -> torch.Tensor:
    """The unsigned ``hash64 % S`` from its halves:
    ``((hi % S) * (2^32 % S) + lo % S) % S``."""
    return ((h % S) * ((1 << 32) % S) + (l % S)) % S


def exchange_hash_host(key_arrays: Sequence[np.ndarray]) -> np.ndarray:
    """The host twin of the device key hash (uint64 lanes): the sketch
    ``_hash64`` chain. String and mixed key sets hash here; for exact key
    dtypes ``exchange_hash_host(keys) % shards`` IS the shard the device
    picks."""
    from ..relational.sketch import _hash64, _splitmix64
    h = _hash64(np.asarray(key_arrays[0]))
    for k in key_arrays[1:]:
        h = _splitmix64(h ^ _hash64(np.asarray(k)))
    return h


# ---------------------------------------------------------------------------
# the public exchange
# ---------------------------------------------------------------------------

def _meta_dexchange(keys=None, dist=None, *a, **k):
    dist = k.get("dist", dist)
    keys = k.get("keys", keys)
    if dist is None:
        return {}
    m = dist.mesh
    return {"mesh_shape": m.shape, "shards": m.num_data_shards,
            "rows": dist.num_rows,
            "keys": [keys] if isinstance(keys, str) else list(keys or ())}


def dexchange(keys, dist):
    """Hash-repartition ``dist`` so every row lives on the shard that owns
    its key's hash (``splitmix64(key) % shards``).

    Placement is a function of the key VALUES and the shard count alone:
    two frames exchanged by keys of equal dtype on the same mesh put equal
    keys on the same shard (the partitioned join's invariant), and
    repeated exchanges place identically. Keys must be scalar columns;
    numeric keys hash on the devices, string or mixed key sets on the
    host, which then ships a destination column. Host (string) ride-along
    columns follow their rows on the host by a carried row id.

    Returns a frame with per-shard validity (``shard_valid``) whose rows
    lie, within each shard, in their original global order. A one-shard
    mesh returns ``dist`` itself."""
    from .distributed import _check_executor, _lazy_input
    _check_executor()
    refuse_cluster(dist.mesh, "dexchange")
    if _lazy_input(dist) is not None:
        from ..plan import dist as _dplan
        dist = _dplan.materialize(dist)
    keys = [keys] if isinstance(keys, str) else list(keys)
    if not keys:
        raise ValueError("dexchange needs at least one key column")
    for k in keys:
        f = dist.schema.get(k)
        if f is None:
            raise KeyError(
                f"No key column {k!r}; columns: {dist.schema.names}")
        if f.sql_rank != 0:
            raise _ops.InvalidTypeError(
                f"dexchange key {k!r} must be a scalar column")
    if dist.mesh.num_data_shards <= 1:
        return dist
    return _dexchange_eager(keys, dist)


@traced_query("dexchange", _meta_dexchange)
def _dexchange_eager(keys, dist):
    return _elastic.elastic_call("dexchange", dist,
                                 lambda d: _dexchange(keys, d))


def _dexchange(keys, dist):
    from .distributed import (DistributedFrame, ShardedArray, _trace_done,
                              _trace_shards)
    mesh = dist.mesh
    S = mesh.num_data_shards
    devs = mesh.shard_devices()
    dev0 = devs[0]
    if S <= 1:
        return dist
    if dist.padded_rows % S != 0:
        # non-tiling (trim/global-result) frames first normalize to the
        # even prefix layout: the same host round trip reshard uses
        dist = _elastic.reshard(dist, mesh)
    if dist.padded_rows >= 2 ** 31:
        raise ValueError(
            f"dexchange carries int32 row ids; {dist.padded_rows} padded "
            f"rows overflow them")
    t_start = time.perf_counter()
    rows_per = dist.padded_rows // S
    schema = dist.schema
    tensor_names = [f.name for f in schema if f.dtype.tensor]
    host_names = [f.name for f in schema if not f.dtype.tensor]
    counts_in = dist.per_shard_valid()

    if all(schema[k].dtype.tensor for k in keys):
        dests = [_dest_from_hash(*_hash_pairs(
            [dist.columns[k].shards[s] for k in keys]), S)
            for s in range(S)]
    else:
        # string or mixed keys: destinations from the host hash chain,
        # shipped as one column (both sides of a join take this path, as
        # their key dtypes match, so placement stays consistent)
        dest_host = (exchange_hash_host(
            [dist.host_read_padded(k) for k in keys])
            % np.uint64(S)).astype(np.int64)
        dests = [torch.from_numpy(
            dest_host[s * rows_per:(s + 1) * rows_per]).to(devs[s])
            for s in range(S)]

    # -- phase 1: per-shard, per-destination counts ------------------------
    with span("dexchange.counts"):
        dest_pad = []
        counts = []
        for s, dest in enumerate(dests):
            valid = torch.arange(rows_per, device=dest.device) \
                < int(counts_in[s])
            d = torch.where(valid, dest.clamp(0, S - 1), S)
            dest_pad.append(d)
            counts.append(torch.bincount(d, minlength=S + 1)[:S]
                          .to(torch.int32).to(dev0))
        cmat = to_host(torch.stack(counts)).astype(np.int64)  # [src, dst]
    counters.inc("mesh.interstage_host_bytes", 4 * S * S)
    maxc = int(cmat.max()) if cmat.size else 0
    # a bucket's capacity, rounded up to 16 rows; never beyond rows_per
    cap = min(max(((max(maxc, 1) + 15) // 16) * 16, 1), rows_per)

    # -- ledger admission on the receive buffers ----------------------------
    from ..memory.estimate import exchange_buffer_bytes
    est = exchange_buffer_bytes(
        [(tuple(dist.columns[n].shape[1:]), dist.columns[n].dtype)
         for n in tensor_names], S, cap,
        rowid_bytes=4 if host_names else 0)
    mgr = _memory.active()
    if mgr is not None and est:
        mgr.make_room(est)
    counters.inc("mesh.exchange_bytes", est)

    # -- phase 2: the swap ---------------------------------------------------
    trace = current_trace()
    clock = None
    if trace is not None:
        clock = _trace_shards(trace, "dexchange", dist)
        trace.add("collective", name="all_to_all", ts=clock.ts,
                  op="dexchange", columns=len(tensor_names))
    per_out = S * cap
    recv = cmat.sum(axis=0)  # rows each shard receives

    def route(shards):
        """Every source's valid rows ordered by destination and cut into
        buckets; destination ``d`` concatenates its buckets in source
        order and pads to ``per_out`` rows."""
        buckets = []
        for s, (t, d) in enumerate(zip(shards, dest_pad)):
            order = torch.argsort(d, stable=True)[:int(counts_in[s])]
            buckets.append(torch.split(t.index_select(0, order.to(
                t.device)), cmat[s].tolist()))
        out = []
        for dst, dev in enumerate(devs):
            parts = [buckets[s][dst].to(dev) for s in range(S)]
            tail = per_out - int(recv[dst])
            like = shards[0]
            parts.append(torch.zeros((tail,) + tuple(like.shape[1:]),
                                     dtype=like.dtype, device=dev))
            out.append(torch.cat(parts))
        return ShardedArray(out)

    with span("dexchange.dispatch"), torch.no_grad():
        new_cols: Dict[str, object] = {
            n: route(dist.columns[n].shards) for n in tensor_names}
        rowid = None
        if host_names:
            rowid = route([(s * rows_per + torch.arange(
                rows_per, device=d.device)).to(torch.int32)
                for s, d in enumerate(dest_pad)])
    if trace is not None:
        _trace_done(trace, "dexchange", clock, mesh)
    counters.inc("mesh.dispatches")

    total = int(recv.sum())
    if total != dist.num_rows:
        # raises in EVERY mode: rows lost across the swap are never a
        # count-and-continue condition
        _invariants.conserve(dist.num_rows, total,
                             f"dexchange (per-shard {recv.tolist()})")
    if rowid is not None:
        rowid_g = rowid.numpy()
        counters.inc("mesh.interstage_host_bytes", 4 * S * per_out)
        vmask = (np.arange(S * per_out) % per_out) < np.repeat(recv,
                                                               per_out)
        for n in host_names:
            src = np.asarray(dist.columns[n], object)
            out_a = np.full(S * per_out, None, object)
            out_a[vmask] = src[rowid_g[vmask]]
            new_cols[n] = out_a
    if mgr is not None and mgr.spill_enabled:
        new_cols = _memory.spillable_columns(
            f"dexchange@{id(dist):x}", new_cols, mgr)
    result = DistributedFrame(mesh, schema, new_cols, dist.num_rows,
                              shard_valid=recv)
    _note_exchange_skew(result, recv, total, S,
                        time.perf_counter() - t_start)
    return result


def _note_exchange_skew(result, recv: np.ndarray, total: int, S: int,
                        wall_s: float) -> None:
    """The exchange's skew report: the ``mesh.exchange_*`` counters, the
    ``explain()`` imbalance line (``result._exchange``), a flight record
    past ``TFT_SKEW_WARN`` and the adaptive layer's stream feedback."""
    from ..observability.report import _skew_threshold
    counters.inc("mesh.exchange_dispatches")
    counters.inc("mesh.exchange_rows", total)
    med = float(np.median(recv))
    mx = float(recv.max()) if recv.size else 0.0
    ratio = (mx / med) if med > 0 else (float("inf") if mx else 0.0)
    thr = _skew_threshold()
    result._exchange = {"op": "dexchange",
                        "per_shard": [int(v) for v in recv],
                        "ratio": ratio, "threshold": thr}
    if ratio > thr:
        counters.inc("mesh.exchange_skew_events")
        _flight.record("mesh.exchange_skew", op="dexchange",
                       ratio=round(min(ratio, 1e9), 3), threshold=thr,
                       rows=total, per_shard=[int(v) for v in recv[:16]])
        _log.info(
            "dexchange: partition imbalance %.2f over TFT_SKEW_WARN=%.2f "
            "(per-shard rows %s)", ratio, thr, [int(v) for v in recv])
    from ..plan.adaptive import record_stream_feedback
    record_stream_feedback("dexchange", blocks=S, rows=total,
                           wall_s=max(wall_s, 1e-9),
                           occupancy=(total / S) / mx if mx else None)


# ---------------------------------------------------------------------------
# shuffle-partitioned aggregation (high-cardinality keys)
# ---------------------------------------------------------------------------

def shuffle_daggregate(fetches, dist, keys) -> TensorFrame:
    """Keyed aggregation by hash-repartition: rows move to the shards that
    own their keys, each shard aggregates ONLY its own (disjoint) key
    range, and the shards' results concatenate and reorder to
    ``daggregate``'s ascending group order.

    For high-cardinality keys this replaces ``daggregate``'s dense
    ``[groups, ...]`` table on every shard (each holding EVERY group) by
    O(groups / shards) state per shard. ``daggregate``'s monoid host-key
    path routes here above ``TFT_SHUFFLE_AGG_GROUPS`` groups. Same result
    frame: the same groups, order and dtypes, exact for min/max and
    integer sums; float sums may reassociate. ``TFT_SHUFFLE=0``, a
    one-shard mesh, sketch combiners and non-monoid fetches go to
    ``daggregate`` unchanged."""
    from .distributed import daggregate
    refuse_cluster(dist.mesh, "shuffle_daggregate")
    keys = [keys] if isinstance(keys, str) else list(keys)
    if (not shuffle_enabled() or dist.mesh.num_data_shards <= 1
            or not _ops._monoid_mapping(fetches)
            or any(_ops._is_sketch(v) for v in fetches.values())):
        return daggregate(fetches, dist, keys)
    if dist.num_rows == 0:
        raise ValueError("aggregate on an empty distributed frame")
    return _shuffle_daggregate_impl(fetches, dist, keys)


def _shuffle_daggregate_impl(fetches, dist, keys) -> TensorFrame:
    """The exchanged monoid aggregation (callers validated the route):
    each exchanged shard's valid rows become a one-block host frame whose
    keyed ``aggregate`` runs on the package's device (a float sum through
    B1), then one stable lexsort of the concatenated groups."""
    from .. import api as _api
    from ..frame import Block
    from ..schema import Field, Schema
    from ..shape import Unknown

    fetch_names = sorted(fetches)
    needed = list(dict.fromkeys(list(keys) + fetch_names))
    sub = dist.select(needed) if set(needed) != set(dist.schema.names) \
        else dist
    with span("daggregate.shuffle"):
        ex = dexchange(keys, sub)
        S = ex.mesh.num_data_shards
        valid = ex.per_shard_valid()
        rows_per = ex.padded_rows // S
        host = {n: ex.host_read_padded(n) for n in needed}
        schema = ex.schema
        parts: List[Block] = []
        for s in range(S):
            k = int(valid[s])
            if k == 0:
                continue
            cols = {}
            for n in needed:
                a = host[n][s * rows_per: s * rows_per + k]
                f = schema[n]
                if isinstance(a, np.ndarray) and f.dtype.tensor \
                        and a.dtype != f.dtype.np_storage:
                    a = a.astype(f.dtype.np_storage)
                cols[n] = a
            shard_frame = TensorFrame.from_columns(
                cols, schema=schema.select(needed))
            part = _api.aggregate(dict(fetches),
                                  shard_frame.group_by(*keys))
            parts.append(Block.concat(part.blocks(), part.schema))
        out_fields = [schema[k] for k in keys] + [
            Field(f, schema[f].dtype,
                  block_shape=(schema[f].block_shape.with_lead(Unknown)
                               if schema[f].block_shape is not None
                               else None),
                  sql_rank=schema[f].sql_rank)
            for f in fetch_names]
        out_schema = Schema(out_fields)
        merged = Block.concat(parts, out_schema)
        # shards own disjoint hash ranges, not key ranges: one stable
        # lexsort restores daggregate's ascending group order
        order = _ops._factorize_keys([np.asarray(merged.columns[k])
                                      for k in keys]).order
        cols = {n: (merged.columns[n][order]
                    if isinstance(merged.columns[n], np.ndarray)
                    else [merged.columns[n][i] for i in order])
                for n in out_schema.names}
        counters.inc("mesh.shuffle_daggregates")
        return TensorFrame.from_blocks(
            [Block(cols, merged.num_rows)], out_schema)
