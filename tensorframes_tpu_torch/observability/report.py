"""Human-readable per-query reports: ``frame.explain()`` and
``ttf.last_query_report()``.

The port's counterpart of ``tensorframes_tpu/observability/report.py``.
One call renders what a query did: rows, blocks, bytes marshalled,
retries, OOM splits, sync fallbacks, compile-cache behaviour, preemption,
the card's memory peak, and the wall time by stage, all from the query's
own :class:`~.events.QueryTrace`, so overlapping queries do not mix their
numbers. :func:`frame_report` adds the logical plan's section (fused
stages, pruned columns, pushdown, resident edges) and a join's routing.

A mesh query adds its per-device section: rows, bytes and time per
shard (the ``shard_compute`` times the d-ops record on the device tracks:
CUDA events on a card, the host clock on the CPU), the straggler ratio
(max/median shard time, warned above ``TFT_SKEW_WARN``, default 2.0), a
fused distributed stage's line, and the elastic layer's ``mesh_shrink``,
``mesh_grow`` and ``rebalance`` lines. A mesh join adds its partitioned
build and its exchange's partition imbalance, judged against the same
threshold.
"""

from __future__ import annotations

import os
from typing import Optional

from ..utils import tracing
from . import events as _events

__all__ = ["render", "frame_report", "last_query_report"]

DEFAULT_SKEW_WARN = 2.0

_skew_malformed_warned = False


def _skew_threshold() -> float:
    """``TFT_SKEW_WARN`` (default 2.0); a malformed value warns once and
    reads as the default."""
    raw = os.environ.get("TFT_SKEW_WARN")
    if not raw:
        return DEFAULT_SKEW_WARN
    try:
        return float(raw)
    except ValueError:
        global _skew_malformed_warned
        if not _skew_malformed_warned:
            from ..utils.logging import get_logger
            get_logger("observability.report").warning(
                "ignoring malformed TFT_SKEW_WARN=%r (using %g)", raw,
                DEFAULT_SKEW_WARN)
            _skew_malformed_warned = True
        return DEFAULT_SKEW_WARN


def _fmt_bytes(n) -> str:
    # tolerant of None and strings: the decision audit feeds it whatever
    # a flight record carried
    try:
        v = float(n)
    except (TypeError, ValueError):
        return str(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(v) < 1024.0 or unit == "TiB":
            return f"{v:.1f} {unit}" if unit != "B" else f"{int(v)} B"
        v /= 1024.0
    return f"{int(n)} B"


def _fmt_secs(s: float) -> str:
    if s < 1e-3:
        return f"{s * 1e6:.0f} us"
    if s < 1.0:
        return f"{s * 1e3:.2f} ms"
    return f"{s:.3f} s"


def render(trace: "_events.QueryTrace") -> str:
    """Render one finished (or in-flight) trace as an aligned report."""
    s = trace.summary()
    lines = [
        f"query {s['query_id']} · {s['op']} · "
        f"{_fmt_secs(s['duration_s'])} · {s['blocks']} block(s)",
        f"  rows     : {s['rows_in']} in / {s['rows_out']} out · "
        f"{_fmt_bytes(s['bytes_in'])} marshalled",
    ]
    occ = (f", mean occupancy {s['occupancy_mean']:.2f}"
           if s["occupancy_mean"] is not None else "")
    if s["slots"] or occ:
        lines.append(f"  pipeline : {s['slots']} in-flight slot(s){occ}, "
                     f"{s['sync_fallbacks']} sync fallback(s)")
    lines.append(
        f"  resilience: {s['retries']} retried, {s['giveups']} gave up, "
        f"{s['oom_splits']} oom split(s), "
        f"{s['pad_fallbacks']} pad fallback(s)")
    compile_s = (f" · {_fmt_secs(s['compile_seconds'])} compiling"
                 if s["compile_seconds"] else "")
    lines.append(
        f"  compile  : {s['compile_misses']} miss(es) / "
        f"{s['compile_hits']} hit(s){compile_s}")
    if trace.meta:
        meta = " ".join(f"{k}={v}" for k, v in sorted(trace.meta.items())
                        if k != "plan")
        if meta:
            lines.append(f"  query    : {meta}")
    mesh = s["mesh"]
    if mesh is not None:
        ratio = mesh["straggler_ratio"]
        ratio_s = (f"straggler ratio {ratio:.2f} (max/median device time)"
                   if ratio is not None else "straggler ratio n/a")
        lines.append(f"  mesh     : {len(mesh['devices'])} device(s), "
                     f"{s['mesh_dispatches']} dispatch(es), "
                     f"{s['collectives']} collective(s), {ratio_s}")
        for d, acc in mesh["devices"].items():
            lines.append(f"    device {d}: {acc['rows']} rows · "
                         f"{_fmt_bytes(acc['bytes'])} · "
                         f"{_fmt_secs(acc['time_s'])}")
        if ratio is not None and ratio > _skew_threshold():
            lines.append(
                f"  WARNING  : device time imbalance — the slowest "
                f"device ran {ratio:.2f}x the median (threshold "
                f"{_skew_threshold():g}; straggling shard or skewed "
                f"rows, see the per-device table above; persistent "
                f"skew triggers re-partitioning)")
    for ev in list(trace.events):
        a = ev.args or {}
        if ev.etype == "adaptive_layout":
            lines.append(
                f"  adaptive : {a.get('blocks')} leaf block(s) "
                f"re-bucketed into {a.get('units')} (coalesced "
                f"{a.get('coalesced', 0)}, split {a.get('splits', 0)}) "
                f"— original boundaries restored")
        elif ev.etype == "replan":
            lines.append(
                f"  adaptive : mid-plan re-plan at block "
                f"{a.get('at_block')} — observed selectivity deviated "
                f"past TFT_REPLAN_RATIO; remaining filter stages "
                f"re-ordered")
        elif ev.etype == "result_cache_hit":
            lines.append(
                f"  adaptive : result cache HIT — {a.get('blocks')} "
                f"block(s) / {a.get('bytes')} B served with zero "
                f"dispatches")
        elif ev.etype == "sched_admission_preempt":
            lines.append(
                f"  admission: preempted query {a.get('victim')} "
                f"({a.get('victim_bytes')} B) to clear headroom "
                f"instead of shedding")
    for ev in list(trace.events):
        if ev.etype == "fused_stage":
            a = ev.args or {}
            res = (f", {a.get('resident')} column(s) pass through "
                   f"device-resident" if a.get("resident") else "")
            lines.append(
                f"  dplan    : fused stage '{ev.name}' — "
                f"{a.get('ops')} op(s) in ONE fused stage program, "
                f"{a.get('filters', 0)} in-program filter(s){res}")
            if a.get("wall_s") is not None:
                lines.append(
                    f"    stage shard time: {_fmt_secs(a['wall_s'])} "
                    f"across {a.get('shards')} shard(s) "
                    f"(~{_fmt_secs(a['wall_s'] / max(a.get('shards') or 1, 1))}"
                    f"/shard amortized)")
    for ev in list(trace.events):
        a = ev.args or {}
        if ev.etype == "mesh_shrink":
            lines.append(
                f"  elastic  : device {a.get('device')} lost — mesh "
                f"shrunk {a.get('devices_before')} -> "
                f"{a.get('devices_after')} device(s), "
                f"{a.get('reshard_rows')} row(s) re-sharded")
        elif ev.etype == "mesh_grow":
            lines.append(
                f"  elastic  : device(s) {a.get('devices')} "
                f"re-admitted (probe + warm-up) — mesh grown "
                f"{a.get('devices_before')} -> "
                f"{a.get('devices_after')} device(s)")
        elif ev.etype == "rebalance":
            lines.append(
                f"  rebalance: skew {a.get('ratio')} — per-shard "
                f"rows {a.get('before')} -> {a.get('after')}")
    if s["preempts"] or s["resumed_blocks"]:
        lines.append(
            f"  preempt  : parked {s['preempts']} time(s); "
            f"{s['resumed_blocks']} block(s) restored from checkpoint "
            f"instead of re-dispatched")
    if s["hbm"] is not None:
        h = s["hbm"]
        lines.append(f"  memory   : peak HBM {_fmt_bytes(h['peak'])} "
                     f"(live {_fmt_bytes(h['live_start'])} -> "
                     f"{_fmt_bytes(h['live_end'])})")
    if (s["spills"] or s["faults"] or s["proactive_splits"]
            or s["external_sort_runs"]):
        ext = (f", external sort in {s['external_sort_runs']} run(s)"
               if s["external_sort_runs"] else "")
        lines.append(
            f"  spill    : {s['spills']} spill(s) "
            f"({_fmt_bytes(s['spill_bytes'])} to host), "
            f"{s['faults']} fault(s), {s['proactive_splits']} proactive "
            f"split(s){ext}")
    extra = f" (+{s['dropped']} dropped)" if s["dropped"] else ""
    lines.append(f"  events   : {s['events']} recorded{extra}")
    with trace._lock:
        stages = {k: tuple(v) for k, v in trace.stages.items()}
    if stages:
        lines.append("  wall time by stage:")
        width = max(len(k) for k in stages)
        for name in sorted(stages, key=lambda k: -stages[k][1]):
            count, total = stages[name]
            lines.append(f"    {name:<{width}} {int(count):6d}x "
                         f"{total:12.6f}s")
    return "\n".join(lines)


def _with_plan(df, report: str) -> str:
    """The frame's own sections after the trace's: the optimized plan of
    its forcing (absent under ``TFT_FUSE=0`` or when the chain ran per
    op), the hot keys a salted ``daggregate`` observed, a join's routing
    decision, a partitioned join's build per shard and its exchange's
    partition imbalance."""
    info = getattr(df, "_plan_info", None)
    if info:
        report = report + "\n" + "\n".join(info)
    for h in getattr(df, "_hot_keys", None) or ():
        kv = ", ".join(f"{k}={v!r}" for k, v in h["keys"].items())
        frac = (f"{h['fraction']:.0%} of rows"
                if h.get("fraction") is not None else "hot")
        report += (f"\n  hot key  : {{{kv}}} — {frac}, salted across "
                   f"{h['salt_slots']} slot(s) (frame.hot_keys())")
    route = getattr(df, "_join_route", None)
    if route:
        # the join's routing decision (also on the flight ring as
        # relational.join_route; ttf.why() renders it)
        est = route.get("est_build_bytes")
        est_s = _fmt_bytes(est) if est is not None else "unknown"
        report += (f"\n  join     : auto-routed to "
                   f"{route['strategy']!r} ({route['reason']}) — "
                   f"est build {est_s} vs limit "
                   f"{_fmt_bytes(route['limit'])}, shuffle "
                   f"{'on' if route.get('shuffle') else 'off'}")
    pinfo = getattr(df, "_partitioned_info", None)
    if pinfo:
        report += (f"\n  shuffle  : partitioned build across "
                   f"{pinfo['shards']} shard(s) — max per-device build "
                   f"{_fmt_bytes(pinfo['max_build_bytes'])} of "
                   f"{_fmt_bytes(pinfo['global_build_bytes'])} global")
    ex = getattr(df, "_exchange_skew", None) \
        or getattr(df, "_exchange", None)
    if ex:
        flag = (" OVER TFT_SKEW_WARN"
                if ex["ratio"] > ex["threshold"] else "")
        report += (f"\n  exchange : partition imbalance {ex['ratio']:.2f} "
                   f"(threshold {ex['threshold']:.2f}{flag}); per-shard "
                   f"rows {ex['per_shard']}")
    return report


def frame_report(df) -> str:
    """``TensorFrame.explain()``: the execution report of the frame's
    forcing.

    A frame already forced with tracing on renders its recorded trace.
    Otherwise it is (re-)forced once with tracing on: ``explain()`` is an
    explicit request for the report, so it pays for one traced run rather
    than returning nothing."""
    t = getattr(df, "_trace", None)
    if t is None:
        if _events.current_trace() is not None:
            # re-forcing inside an active query would join that trace and
            # record nothing for this frame
            return ("(no query trace recorded — explain() was called "
                    "inside another active query; call it after that "
                    "query finishes)")
        was = tracing.enabled()
        if not was:
            tracing.enable()
        old_cache = df._cache
        try:
            df._cache = None  # re-force under a trace
            df.blocks()
        except BaseException:
            df._cache = old_cache  # a failed re-force keeps the result
            raise
        finally:
            if not was:
                tracing.disable()
        t = getattr(df, "_trace", None)
    if t is None:
        return _with_plan(
            df, "(no query trace recorded — the frame was forced inside "
                "another query or tracing stayed off)")
    return _with_plan(df, render(t))


def last_query_report() -> str:
    """The report of the most recently finished query (an eager op, such
    as ``reduce_blocks`` or ``aggregate``, has no frame to call
    ``explain()`` on)."""
    t: Optional[_events.QueryTrace] = _events.last_query()
    if t is None:
        return ("(no query recorded yet — enable tracing with TFT_TRACE=1 "
                "or tensorframes_tpu_torch.utils.tracing.enable() and run "
                "a query)")
    return render(t)
