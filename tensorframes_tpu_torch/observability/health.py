"""``ttf.health()``: one machine-readable snapshot across every
subsystem.

The port's counterpart of ``tensorframes_tpu/observability/health.py``.
Each subsystem answers its own "how am I doing" (the memory ledger's
snapshot, the scheduler's per-tenant queues, the streams' watermarks, the
caches' hit counters); this module reads them together. It aggregates and
never measures: every number is read from state the subsystems keep
anyway, so ``health()`` is safe to poll. It never initializes CUDA: the
card's allocator is read only once the process has initialized it.

The top-level ``warnings`` list is the triage summary ``ttf.doctor()``
narrates: overflow admissions, shed or rejected queries, an SLO burning
its budget, skipped stream batches, performance regressions, invariant
violations, an unclean shutdown, cold history segments, quarantined
plans.

The ``fabric`` section is the open serving fabric's
:meth:`~..serve.fabric.ServeFabric.health_snapshot` (``{"running":
False}`` without one), and a worker declared lost raises a warning. The
``mesh`` section counts the devices a mesh would see
(``parallel.local_mesh``: the cards once CUDA is up, ``None`` before; the
logical CPU shards when the default device is the CPU), the elastic
layer's lost pool (a non-empty pool raises a warning: meshes are running
shrunken) and its shrink, grow, rebalance and dispatch counters.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

from ..utils import tracing
from ..utils.logging import get_logger
from . import baseline as _baseline
from . import flight as _flight
from . import slo as _slo

__all__ = ["health"]

_log = get_logger("observability.health")


def _backend_initialized() -> bool:
    """Whether CUDA is already initialized in this process, read WITHOUT
    initializing it: a health poll of a CPU-only process neither raises
    nor touches a card."""
    try:
        import torch
        return bool(torch.cuda.is_initialized())
    except Exception:  # noqa: BLE001 - no torch.cuda at all
        return False


def _mesh_section(counts: Dict[str, int]) -> Dict[str, Any]:
    visible = None
    try:
        from ..device import default_device
        if default_device().type != "cuda" or _backend_initialized():
            # else None: "not initialized yet", not "no devices"
            from ..parallel import mesh as _mesh
            visible = len(_mesh._visible_devices())
    except Exception as e:  # noqa: BLE001 - health must render regardless
        _log.debug("health: device enumeration failed: %s", e)
    lost: List[int] = []
    try:
        from ..parallel import elastic as _elastic
        lost = _elastic.lost_pool()
    except Exception as e:  # noqa: BLE001 - optional subsystem
        _log.debug("health: elastic lost pool unavailable: %s", e)
    return {
        "visible_devices": visible,
        "lost_pool": lost,
        "devices_lost": counts.get("mesh.devices_lost", 0),
        "shrinks": counts.get("mesh.shrinks", 0),
        "grows": counts.get("mesh.grows", 0),
        "rebalances": counts.get("mesh.rebalances", 0),
        "dispatches": counts.get("mesh.dispatches", 0),
    }


def _memory_section(counts: Dict[str, int]) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "limited": False, "limit_bytes": 0, "headroom_bytes": None,
        "inflight_bytes": 0, "resident_bytes": 0, "resident_buffers": 0,
        "spilled_bytes": 0, "spilled_buffers": 0, "device": None,
    }
    try:
        from .. import memory as _memory
        mgr = _memory.active()
    except Exception as e:  # noqa: BLE001 - health must render regardless
        _log.debug("health: memory manager unavailable: %s", e)
        mgr = None
    if mgr is not None:
        out.update(mgr.snapshot())
        out["limited"] = mgr.limited
        out["headroom_bytes"] = mgr.headroom()
    out["spills"] = counts.get("memory.spills", 0)
    out["spill_bytes_total"] = counts.get("memory.spill_bytes", 0)
    out["faults"] = counts.get("memory.faults", 0)
    out["overflow_admissions"] = counts.get("memory.overflow_admissions",
                                            0)
    out["proactive_splits"] = counts.get("memory.proactive_splits", 0)
    if _backend_initialized():
        # the card's caching allocator: bytes in use, their peak, and the
        # card's total memory
        try:
            from . import device as _device
            out["device"] = _device.watermark()
        except Exception as e:  # noqa: BLE001 - health must render
            _log.debug("health: card watermark unavailable: %s", e)
    return out


def _serve_section() -> Dict[str, Any]:
    try:
        from ..serve.scheduler import live_scheduler
        sched = live_scheduler()
    except Exception as e:  # noqa: BLE001 - optional subsystem
        _log.debug("health: serve layer unavailable: %s", e)
        sched = None
    if sched is None:
        return {"running": False}
    snap = sched.snapshot()
    return {
        "running": True,
        "name": sched.name,
        "workers": sched.workers,
        "slots": sched.slot_pool.slots,
        "queued": sum(s["queued"] for s in snap.values()),
        "inflight": sum(s["inflight"] for s in snap.values()),
        "tenants": {t: {"queued": s["queued"],
                        "inflight": s["inflight"],
                        "completed": s["completed"],
                        "failed": s["failed"],
                        "shed": s["shed"],
                        "rejected": s["rejected"]}
                    for t, s in snap.items()},
    }


def _cache_section(counts: Dict[str, int]) -> Dict[str, Any]:
    def ratio(hits: int, misses: int):
        total = hits + misses
        return (hits / total) if total else None

    compile_cache = None
    try:
        from ..serve.scheduler import live_scheduler
        sched = live_scheduler()
        if sched is not None and sched.compile_cache is not None:
            st = sched.compile_cache.stats()
            compile_cache = {**st,
                             "hit_ratio": ratio(st["hits"], st["misses"])}
    except Exception as e:  # noqa: BLE001 - optional subsystem
        _log.debug("health: compile cache unavailable: %s", e)
    result = {"entries": 0, "bytes": 0}
    try:
        from ..plan.adaptive import result_cache_stats
        result = result_cache_stats()
    except Exception as e:  # noqa: BLE001 - optional subsystem
        _log.debug("health: result cache unavailable: %s", e)
    rc_hits = counts.get("plan.result_cache_hits", 0)
    rc_misses = counts.get("plan.result_cache_misses", 0)
    return {
        "compile": compile_cache,
        "result": {**result, "hits": rc_hits, "misses": rc_misses,
                   "hit_ratio": ratio(rc_hits, rc_misses)},
        "engine_compile_hits": counts.get("compile_cache.hits", 0),
        "engine_compile_misses": counts.get("compile_cache.misses", 0),
    }


def _stream_section() -> Dict[str, Any]:
    handles = []
    try:
        from ..stream.runtime import live_handles
        handles = live_handles()
    except Exception as e:  # noqa: BLE001 - optional subsystem
        _log.debug("health: stream handles unavailable: %s", e)
    out: Dict[str, Any] = {}
    for h in handles:
        try:
            m = h.metrics()
        except Exception as e:  # noqa: BLE001 - a dying handle is not news
            _log.debug("health: stream %s metrics failed: %s",
                       getattr(h, "name", "?"), e)
            continue
        out[h.name] = {
            "batches": m["batches"],
            "batches_skipped": m["batches_skipped"],
            "watermark": m["watermark"],
            "batch_lag_s": m["batch_lag_s"],
            "state_rows": m["state_rows"],
            "state_bytes": m["state_bytes"],
            "late_rows": m["late_rows"],
            "done": h.done(),
        }
    return out


def _invariants_section(counts: Dict[str, int]) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "enabled": True, "strict": False, "audits": 0, "violations": 0,
        "rows_tainted": 0, "chaos": None,
    }
    try:
        from ..resilience import invariants as _invariants
        out["enabled"] = _invariants.enabled()
        out["strict"] = _invariants.strict_mode()
    except Exception as e:  # noqa: BLE001 - optional subsystem
        _log.debug("health: invariants unavailable: %s", e)
    out["audits"] = counts.get("invariants.audits", 0)
    out["violations"] = counts.get("invariants.violations", 0)
    out["rows_tainted"] = counts.get("invariants.rows.tainted", 0)
    try:
        from ..resilience import chaos as _chaos
        sched = _chaos.active()
        if sched is not None:
            out["chaos"] = sched.stats()
    except Exception as e:  # noqa: BLE001 - optional subsystem
        _log.debug("health: chaos schedule unavailable: %s", e)
    return out


def _history_section() -> Dict[str, Any]:
    try:
        from . import history as _history
        return _history.stats()
    except Exception as e:  # noqa: BLE001 - optional subsystem
        _log.debug("health: history archive unavailable: %s", e)
        return {"enabled": False}


def _quarantine_section() -> Dict[str, Any]:
    try:
        from ..serve import quarantine as _quarantine
        return _quarantine.status()
    except Exception as e:  # noqa: BLE001 - optional subsystem
        _log.debug("health: quarantine registry unavailable: %s", e)
        return {"active": {}, "streaks": {}}


def _fabric_section() -> Dict[str, Any]:
    try:
        from ..serve.fabric import live_fabric
        fab = live_fabric()
    except Exception as e:  # noqa: BLE001 - optional subsystem
        _log.debug("health: fabric unavailable: %s", e)
        fab = None
    if fab is None:
        return {"running": False}
    try:
        return fab.health_snapshot()
    except Exception as e:  # noqa: BLE001 - a closing fabric is not news
        _log.debug("health: fabric snapshot failed: %s", e)
        return {"running": False}


def _warnings(snap: Dict[str, Any]) -> List[str]:
    warns: List[str] = []
    mem = snap["memory"]
    if mem["overflow_admissions"]:
        warns.append(
            f"memory: {mem['overflow_admissions']} overflow "
            f"admission(s) — dispatches ran OVER the device budget; "
            f"shrink blocks or raise TFT_MEM_LIMIT_BYTES")
    mesh = snap["mesh"]
    if mesh["lost_pool"]:
        warns.append(
            f"mesh: device(s) {mesh['lost_pool']} lost and not "
            f"re-admitted — meshes are running shrunken "
            f"(parallel.elastic.admit_devices)")
    serve = snap["serve"]
    if serve.get("running"):
        for t, s in serve["tenants"].items():
            if s["shed"] or s["rejected"]:
                warns.append(
                    f"serve: tenant {t!r} had {s['shed']} shed / "
                    f"{s['rejected']} rejected quer(ies) — admission "
                    f"or queue pressure")
    fab = snap.get("fabric") or {}
    if fab.get("running") and fab.get("lost"):
        warns.append(
            f"fabric: {fab['lost']} worker(s) declared lost — their "
            f"tenants re-placed and queries re-dispatched; restart "
            f"them (ServeFabric.restart_worker) to restore capacity")
    for t, s in snap["slo"].items():
        burn = s.get("burn_rate")
        if burn is not None and burn > 1.0:
            warns.append(
                f"slo: tenant {t!r} burning its error budget at "
                f"{burn:.1f}x the sustainable rate "
                f"({s['objective_ms']:g} ms @ {s['target']:.4g})")
    for name, s in snap["streams"].items():
        if s["batches_skipped"]:
            warns.append(
                f"stream: {name!r} skipped {s['batches_skipped']} "
                f"poisoned batch(es)")
    perf = snap.get("perf") or {}
    for r in perf.get("recent_regressions", []):
        warns.append(
            f"perf: query {r['query']} regressed {r['sigma']}x sigma "
            f"past its baseline (plan {r['fingerprint']}…, most-moved "
            f"{r['component']}) — ttf.regressions() has the record")
    inv = snap.get("invariants") or {}
    if inv.get("violations"):
        warns.append(
            f"invariants: {inv['violations']} cross-cutting invariant "
            f"violation(s) recorded — accounting drifted somewhere; "
            f"the flight ring's invariant.violation records name the "
            f"auditor and quiesce point")
    hs = snap.get("history") or {}
    if hs.get("unclean"):
        u = hs["unclean"]
        warns.append(
            f"history: UNCLEAN SHUTDOWN detected — pid {u.get('pid')} "
            + (f"(worker {u['worker']}) " if u.get("worker") else "")
            + f"died without its clean-exit hook; ttf.postmortem() "
            f"has the triage report")
    if hs.get("corrupt_segments"):
        warns.append(
            f"history: {hs['corrupt_segments']} archive segment(s) "
            f"went cold (corrupt/truncated, unlinked) — records lost, "
            f"never wrong; earlier segments remain readable")
    quar = snap.get("quarantine") or {}
    for fp, info in (quar.get("active") or {}).items():
        warns.append(
            f"quarantine: plan {fp[:16]}… fast-rejected after "
            f"{info['failures']} permanent failure(s) — lifts in "
            f"{info['ttl_remaining_s']:.0f}s, or ttf.unquarantine() "
            f"now")
    return warns


def health() -> Dict[str, Any]:
    """One cross-subsystem snapshot: the ledger's headroom and spill
    pressure with the card's allocator, the mesh's devices and lost pool,
    serve queue depths and in-flight,
    compile and result cache hit ratios, per-stream watermark lag and
    state size, the serving fabric, SLO burn, the sentinel, the history,
    invariants,
    quarantine and the flight recorder's own liveness, plus a
    ``warnings`` triage list. Read-only; see the module docstring."""
    counts = tracing.counters.snapshot()
    snap: Dict[str, Any] = {
        "ts": time.time(),
        "memory": _memory_section(counts),
        "mesh": _mesh_section(counts),
        "serve": _serve_section(),
        "fabric": _fabric_section(),
        "caches": _cache_section(counts),
        "streams": _stream_section(),
        "slo": _slo.slo_status(),
        "flight": _flight.stats(),
        "history": _history_section(),
        "perf": _baseline.perf_stats(),
        "invariants": _invariants_section(counts),
        "quarantine": _quarantine_section(),
        "resilience": {
            "giveups": sum(v for k, v in counts.items()
                           if k.startswith("retry.")
                           and k.endswith(".giveups")),
            "retries": sum(v for k, v in counts.items()
                           if k.startswith("retry.")
                           and k.endswith(".retries")),
            "sync_fallbacks": counts.get("pipeline.sync_fallbacks", 0),
            "oom_splits": counts.get("oom_split.dispatches", 0),
            "plan_oom_fallbacks": counts.get("plan.oom_fallbacks", 0),
            "dplan_fallbacks": counts.get("dplan.fallbacks", 0),
        },
    }
    snap["warnings"] = _warnings(snap)
    return snap
