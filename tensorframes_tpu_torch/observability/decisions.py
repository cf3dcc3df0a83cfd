"""Decision audit: ``ttf.why(query_id)`` and ``ttf.doctor()``.

The port's counterpart of ``tensorframes_tpu/observability/decisions.py``.
The flight recorder (:mod:`.flight`) keeps every runtime decision with the
inputs it was made from; this module turns the ring into answers.
:func:`why` reconstructs one query's causal chain (admission,
preemptions, re-plans, spills, its outcome), each line with its inputs,
with ``TFT_TRACE`` off and the query long gone: from the ring, then the
``TFT_FLIGHT_DUMP`` snapshots, then the durable history. :func:`doctor`
is the process-wide triage report: :func:`~.health.health`'s vitals and
warnings, the SLO burn table, and the recent anomalous decisions grouped
by kind.

The serving fabric's decisions (placement, re-placement, rebalance, a
worker's crash and loss, a query's resume on a survivor, restarts and
admission probes), a join's route, and the mesh's and the distributed
plan's (a device lost and the mesh shrunk, devices re-admitted, a skew
rebalance, an exchange's imbalance, hot keys salted, a fused stage
replayed per op) render as lines of their own, in the JAX package's
words; :func:`doctor` shows the mesh and the open fabric and merges
per-worker flight dumps. A record of an unknown kind renders as
``key=value``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from . import flight as _flight
from .report import _fmt_bytes

__all__ = ["why", "doctor"]

# kinds that indicate something went wrong: doctor() surfaces these (the
# JAX package's list)
ANOMALY_KINDS = (
    "serve.shed", "serve.reject", "serve.over_quota", "serve.preempt",
    "serve.admission_preempt", "serve.cancel", "resilience.giveup",
    "memory.overflow_admit", "memory.wait", "mesh.shrink",
    "mesh.rebalance", "plan.oom_fallback", "dplan.fallback",
    "pipeline.sync_fallback", "engine.oom_split", "preempt.park",
    "fabric.worker_lost", "fabric.worker_crash", "fabric.replace",
    "fabric.admit_probe_failed", "mesh.exchange_skew",
    "perf.regression", "invariant.violation", "serve.quarantine",
    "serve.quarantine_reject", "memory.persist_corrupt", "chaos.fire",
    "history.unclean_shutdown", "history.segment_corrupt",
)


def _detail(r: Dict[str, Any]) -> str:
    """One human line per decision kind, leading with the recorded
    inputs (estimate vs observation, threshold, alternative chosen);
    unknown kinds fall back to key=value so new record sites render
    without touching this table."""
    k = r["kind"]
    if k == "serve.start":
        return (f"started after {r.get('queue_wait_s', 0):.3f}s queued "
                f"(tenant {r.get('tenant')!r}, est "
                f"{_fmt_bytes(r.get('est_bytes') or 0)}"
                + (", resumed from checkpoint" if r.get("resumed")
                   else "") + ")")
    if k == "serve.admit":
        head = r.get("headroom")
        head_s = _fmt_bytes(head) if head is not None else "unlimited"
        wait = r.get("waited_s") or 0.0
        return (f"admitted: est {_fmt_bytes(r.get('est_bytes') or 0)} "
                f"vs headroom {head_s}"
                + (f" after waiting {wait:.3f}s" if wait else ""))
    if k == "serve.shed":
        return (f"SHED: est {_fmt_bytes(r.get('est_bytes') or 0)} "
                f"exceeds headroom "
                f"{_fmt_bytes(r.get('headroom') or 0)} and admission "
                f"could not clear within its "
                f"{r.get('budget_s')}s budget "
                f"(TFT_SERVE_ADMISSION_WAIT_S)")
    if k == "serve.reject":
        return (f"REJECTED at submit: tenant {r.get('tenant')!r} queue "
                f"full ({r.get('queued')}/{r.get('max_queue')})")
    if k == "serve.over_quota":
        return (f"REJECTED over quota: est {r.get('est_rows')} rows vs "
                f"{r.get('tokens') or 0:.0f} token(s) left of "
                f"{r.get('rate') or 0:g} rows/s")
    if k == "serve.preempt":
        return (f"asked to park: arriving tenant "
                f"{r.get('arriving')!r} (weight "
                f"{r.get('arriving_weight')}) outweighs "
                f"{r.get('victim_weight')} and all "
                f"{r.get('workers')} worker(s) were busy "
                f"(TFT_PREEMPT_AFTER_MS={r.get('after_ms')})")
    if k == "serve.admission_preempt":
        return (f"parked whale {r.get('victim')} "
                f"({_fmt_bytes(r.get('victim_bytes') or 0)}) to clear "
                f"{_fmt_bytes(r.get('shortfall') or 0)} of admission "
                f"shortfall instead of shedding")
    if k == "serve.cancel":
        return f"cancel requested while {r.get('state', 'live')}"
    if k == "serve.requeue":
        return (f"re-queued at its tenant-queue FRONT with "
                f"{r.get('parked_blocks')} block(s) checkpointed "
                f"(preemption #{r.get('preemptions')})")
    if k == "serve.finish":
        return (f"finished: {r.get('outcome')} after "
                f"{r.get('latency_s', 0):.3f}s end-to-end")
    if k == "preempt.park":
        return (f"parked at block boundary {r.get('blocks')}/"
                f"{r.get('total')} — "
                f"{_fmt_bytes(r.get('bytes') or 0)} checkpointed "
                f"off-device ({r.get('reason') or 'requested'})")
    if k == "preempt.resume":
        return (f"resumed: {r.get('blocks')}/{r.get('total')} block(s) "
                f"restored from checkpoint instead of re-dispatched")
    if k == "preempt.cancel":
        return (f"cancelled at a block boundary "
                f"({r.get('reason') or 'requested'})")
    if k == "plan.adaptive_layout":
        return (f"re-bucketed {r.get('blocks')} leaf block(s) into "
                f"{r.get('units')} unit(s) (coalesced "
                f"{r.get('coalesced')}, split {r.get('splits')}) "
                f"targeting {r.get('depth')} full pipeline slot(s)")
    if k == "plan.replan":
        return (f"mid-plan RE-PLAN at block {r.get('at_block')}: "
                f"filter selectivity observed {r.get('observed')} vs "
                f"priced {r.get('priced')} (deviation past "
                f"TFT_REPLAN_RATIO={r.get('ratio')}); remaining stages "
                f"re-ordered")
    if k == "plan.filter_reorder":
        return (f"filter run re-ordered by observed selectivity "
                f"{r.get('selectivities')} -> order {r.get('order')}")
    if k == "plan.oom_fallback":
        return (f"fused plan hit an unsplittable OOM ({r.get('error')}); "
                f"whole forcing re-ran per-op")
    if k == "dplan.fallback":
        return (f"fused mesh program failed ({r.get('error')}, "
                f"kind {r.get('error_kind')}); recorded chain replayed "
                f"per-op")
    if k == "plan.result_cache_hit":
        return (f"result cache HIT: {r.get('blocks')} block(s) / "
                f"{_fmt_bytes(r.get('bytes') or 0)} served with zero "
                f"dispatches")
    if k == "plan.result_cache_admit":
        return (f"result interned ({_fmt_bytes(r.get('bytes') or 0)}; "
                f"second sighting of the fingerprint)")
    if k == "plan.result_cache_evict":
        return (f"{r.get('entries')} result-cache entr(ies) "
                f"LRU-evicted under the budget")
    if k == "mesh.shrink":
        return (f"device {r.get('device')} LOST during "
                f"{r.get('op')!r}: mesh shrunk "
                f"{r.get('devices_before')} -> "
                f"{r.get('devices_after')} device(s), "
                f"{r.get('reshard_rows')} row(s) re-sharded through "
                f"the host")
    if k == "mesh.grow":
        return (f"device(s) {r.get('devices')} re-admitted after "
                f"probe+warm-up: mesh grown {r.get('devices_before')} "
                f"-> {r.get('devices_after')}")
    if k == "mesh.rebalance":
        return (f"persistent skew {r.get('ratio')} (> TFT_SKEW_WARN="
                f"{r.get('threshold')} for {r.get('streak')} "
                f"dispatches): rows re-partitioned {r.get('before')} "
                f"-> {r.get('after')}")
    if k == "mesh.exchange_skew":
        return (f"exchange partition imbalance {r.get('ratio')} "
                f"(> TFT_SKEW_WARN={r.get('threshold')}) during "
                f"{r.get('op')!r}: {r.get('rows')} row(s), per-shard "
                f"{r.get('per_shard')}")
    if k == "mesh.salt":
        return (f"{r.get('count')} hot key group(s) (> "
                f"{r.get('fraction')} of rows, TFT_HOT_KEY_FRACTION) "
                f"salted across {r.get('slots')} slot(s)")
    if k == "memory.spill":
        return (f"spilled {r.get('name')} "
                f"({_fmt_bytes(r.get('bytes') or 0)}) to pinned host "
                f"under budget pressure")
    if k == "memory.fault":
        return (f"faulted {r.get('name')} "
                f"({_fmt_bytes(r.get('bytes') or 0)}) back to device")
    if k == "memory.overflow_admit":
        return (f"OVERFLOW admission: {_fmt_bytes(r.get('bytes') or 0)} "
                f"for {r.get('op')} over the "
                f"{_fmt_bytes(r.get('limit') or 0)} budget "
                f"({r.get('cause')})")
    if k == "memory.wait":
        return (f"admission waited: {_fmt_bytes(r.get('bytes') or 0)} "
                f"for {r.get('op')} had no headroom")
    if k == "memory.proactive_split":
        return (f"block split BEFORE dispatch: est "
                f"{_fmt_bytes(r.get('bytes') or 0)} would overflow the "
                f"{_fmt_bytes(r.get('limit') or 0)} budget")
    if k == "engine.oom_split":
        return (f"allocator OOM ({r.get('error')}): {r.get('rows')} "
                f"row(s) re-dispatched as halves")
    if k == "pipeline.sync_fallback":
        return (f"async submit failed ({r.get('error')}); block re-ran "
                f"synchronously through the retry machinery")
    if k == "resilience.giveup":
        return (f"GAVE UP on {r.get('op')} after {r.get('attempts')} "
                f"attempt(s): {r.get('error')} (classified "
                f"{r.get('error_kind')})")
    if k == "stream.batch_skip":
        return (f"batch {r.get('batch')} poisoned ({r.get('error')}, "
                f"classified {r.get('error_kind')}); skipped")
    if k == "plan.result_cache_warm_hit":
        return (f"result cache WARM hit: {r.get('blocks')} block(s) / "
                f"{_fmt_bytes(r.get('bytes') or 0)} re-admitted from "
                f"the durable tier (fingerprint "
                f"{r.get('fingerprint')}…) — survived a restart")
    if k == "plan.result_cache_persist":
        return (f"result persisted to the durable tier "
                f"({_fmt_bytes(r.get('bytes') or 0)}, fingerprint "
                f"{r.get('fingerprint')}…)")
    if k == "relational.join_route":
        est = r.get("est_build_bytes")
        est_s = _fmt_bytes(est) if est is not None else "unknown"
        return (f"join routed to {r.get('strategy')!r} "
                f"({r.get('reason')}): est build {est_s}, keys "
                f"{r.get('keys')}, how={r.get('how')}")
    if k == "fabric.place":
        return (f"tenant {r.get('tenant')!r} placed on "
                f"{r.get('worker')} (least loaded: "
                f"{r.get('tenants_on_worker')} tenant(s) there)")
    if k == "fabric.replace":
        return (f"tenant {r.get('tenant')!r} re-placed "
                f"{r.get('source')} -> {r.get('worker')} "
                f"({r.get('reason')})")
    if k == "fabric.rebalance":
        return (f"tenant {r.get('tenant')!r} re-placed "
                f"{r.get('source')} -> {r.get('worker')}: SLO burn "
                f"{r.get('burn_rate')}x vs hottest peer "
                f"{r.get('peer_max')}x (> {r.get('factor')}x, "
                f"TFT_FABRIC_BURN_FACTOR)")
    if k == "fabric.worker_crash":
        return (f"worker {r.get('worker')} (epoch {r.get('epoch')}) "
                f"CRASHED: running queries parked to the durable "
                f"tier, in-memory caches died with it")
    if k == "fabric.worker_lost":
        return (f"worker {r.get('worker')} declared LOST after "
                f"{r.get('missed')} missed heartbeat(s) (classified "
                f"{r.get('classified')}); tenants re-placed, queries "
                f"re-dispatched")
    if k == "fabric.heartbeat_miss":
        return (f"worker {r.get('worker')} missed a heartbeat "
                f"({r.get('missed')}/{r.get('limit')} before the "
                f"lease expires)")
    if k == "fabric.resume_dispatch":
        cp = r.get("from_checkpoint")
        return (f"re-dispatched to {r.get('worker')} "
                f"({r.get('reason')}, attempt #{r.get('attempt')}): "
                + (f"{r.get('resumed_blocks')} block(s) resume from "
                   f"the persisted checkpoint" if cp
                   else "no checkpoint found — cold re-run"))
    if k == "fabric.worker_restart":
        return (f"rolling restart of {r.get('worker')}: epoch "
                f"{r.get('epoch')} -> {r.get('next_epoch')} (drain, "
                f"persist, re-admit via probe)")
    if k == "fabric.admit":
        return (f"worker {r.get('worker')} (epoch {r.get('epoch')}) "
                f"passed its admission probe")
    if k == "fabric.admit_probe_failed":
        return (f"worker {r.get('worker')} (epoch {r.get('epoch')}) "
                f"FAILED its admission probe ({r.get('error')}); not "
                f"admitted")
    if k == "history.unclean_shutdown":
        return (f"UNCLEAN SHUTDOWN: pid {r.get('pid')} "
                + (f"(worker {r['worker']}) " if r.get("worker") else "")
                + f"died without its clean-exit hook (history dir "
                f"{r.get('dir')}); ttf.postmortem() has the triage "
                f"report")
    if k == "history.segment_corrupt":
        return (f"history segment {r.get('segment')} went COLD "
                f"({r.get('why')}); unlinked — fewer records, never "
                f"wrong ones")
    if k == "perf.regression":
        return (f"PERF REGRESSION: latency {r.get('latency_s')}s vs "
                f"baseline {r.get('baseline_latency_s')}s "
                f"({r.get('latency_sigma')} sigma > "
                f"TFT_REGRESSION_SIGMA) over {r.get('runs')} warm "
                f"run(s) of plan {r.get('fingerprint')}…; most-moved: "
                f"{r.get('component')} {r.get('baseline')} -> "
                f"{r.get('observed')} ({r.get('sigma')} sigma)")
    skip = {"seq", "ts", "kind", "query"}
    kv = " ".join(f"{k2}={v!r}" for k2, v in r.items() if k2 not in skip)
    return kv or k


def _dumped_records_for(qid: str) -> List[Dict[str, Any]]:
    """The query's decisions recovered from the on-disk
    ``TFT_FLIGHT_DUMP`` snapshots (current file + its ``.1``
    rotation), for queries the live ring has already forgotten."""
    import os
    base = os.environ.get("TFT_FLIGHT_DUMP")
    if not base:
        return []
    paths = [p for p in (base, base + ".1") if os.path.exists(p)]
    if not paths:
        return []
    try:
        merged = _flight.load_dumps(paths)
    except Exception:  # noqa: BLE001 - post-mortem salvages what it can
        return []
    return [r for r in merged if str(r.get("query")) == qid]


def _render_chain(qid, recs: List[Dict[str, Any]], source: str) -> str:
    t0 = recs[0].get("ts", 0)
    lines = [f"query {qid} · {len(recs)} decision(s) recorded "
             f"({source}; TFT_TRACE-independent)"]
    for r in recs:
        w = f" w={r['worker']}" if r.get("worker") else ""
        lines.append(f"  +{r.get('ts', t0) - t0:8.3f}s "
                     f"{r['kind']:<24}{w} {_detail(r)}")
    return "\n".join(lines)


def why(query_id, scheduler=None) -> str:
    """Reconstruct the decision chain of one query, with ``TFT_TRACE``
    off, after the fact, and across a process restart. ``query_id`` is
    the serving id (``SubmittedQuery.query_id``, e.g. ``"serve-q17"``), a
    traced query's id, or any id work ran under a :func:`~.flight.scope`
    for; a ``SubmittedQuery`` is accepted too. Sources in order: the
    live flight ring, the ``TFT_FLIGHT_DUMP`` snapshots on disk, then the
    durable history (:func:`~.history.causal_chain`), so a query that
    finished before a crash still answers from the archive. Lines render
    oldest first, offset from the first decision."""
    qid = str(getattr(query_id, "query_id", query_id))
    recs = _flight.for_query(qid)
    if recs:
        return _render_chain(qid, recs, "flight ring")
    dumped = _dumped_records_for(qid)
    if dumped:
        return _render_chain(
            qid, dumped, "recovered from flight dump(s) on disk — the "
            "live ring has moved past it")
    from . import history as _history
    rec, decs = _history.causal_chain(qid)
    if rec is not None:
        lines = [f"query {qid} · durable history (ring and dumps hold "
                 f"no trace; archived record survives restarts)"]
        workers = rec.get("workers") or (
            [rec["worker"]] if rec.get("worker") else [])
        head = f"  outcome {rec.get('outcome')!r}"
        if rec.get("total_s") is not None:
            head += f" after {rec['total_s']:.3f}s end-to-end"
        if rec.get("tenant"):
            head += f" · tenant {rec['tenant']!r}"
        if workers:
            head += f" · worker(s) {' -> '.join(workers)}"
        if rec.get("migrations"):
            head += f" · {rec['migrations']} migration(s)"
        lines.append(head)
        if rec.get("summary"):
            lines.append(f"  {rec['summary']}")
        if rec.get("error"):
            lines.append(f"  error: {rec['error']}"
                         + (f" (classified {rec['error_kind']})"
                            if rec.get("error_kind") else ""))
        cost = rec.get("cost") or {}
        if cost:
            parts = [f"{k}={v}" for k, v in sorted(cost.items())
                     if isinstance(v, (int, float)) and v]
            if parts:
                lines.append("  cost: " + " ".join(parts[:8]))
        if decs:
            t0 = decs[0].get("ts", rec.get("ts", 0))
            lines.append(f"  {len(decs)} archived decision(s)"
                         + (f" (+{rec['decisions_dropped']} dropped by "
                            f"the digest cap, TFT_HISTORY_DECISIONS)"
                            if rec.get("decisions_dropped") else "")
                         + ":")
            for r in decs:
                w = f" w={r['worker']}" if r.get("worker") else ""
                lines.append(f"    +{r.get('ts', t0) - t0:8.3f}s "
                             f"{r['kind']:<24}{w} {_detail(r)}")
        return "\n".join(lines)
    if not _flight.enabled():
        return (f"(flight recorder disabled — TFT_FLIGHT=0; no "
                f"decisions recorded for {qid})")
    return (f"(no decisions recorded for query {qid!r} — it ran "
            f"before the flight ring's horizon, under no flight "
            f"scope, or never ran; the ring holds "
            f"{_flight.stats()['records']} decision(s), the dump and "
            f"the durable history hold no trace of it)")


def doctor(max_per_kind: int = 5,
           flight_dumps: Optional[Any] = None) -> str:
    """Process-wide triage: :func:`~.health.health`'s vitals and
    warnings, the SLO burn table, and the recent anomalous decisions of
    the flight ring grouped by kind (the newest ``max_per_kind`` each).

    ``flight_dumps``: a path or a list of paths of ``TFT_FLIGHT_DUMP``
    JSONL files, merged into the anomaly scan through
    :func:`~.flight.load_dumps` (each record tagged with the worker of
    its dump's header)."""
    from .health import health as _health
    snap = _health()
    lines = ["ttf.doctor() · process triage report"]
    mem = snap["memory"]
    if mem["limited"]:
        lines.append(
            f"  memory   : budget {_fmt_bytes(mem['limit_bytes'])} · "
            f"headroom {_fmt_bytes(mem['headroom_bytes'] or 0)} · "
            f"{mem['resident_buffers']} resident / "
            f"{mem['spilled_buffers']} spilled buffer(s) · "
            f"{mem['spills']} spill(s), "
            f"{mem['overflow_admissions']} overflow admission(s)")
    else:
        lines.append("  memory   : unlimited (no ledger budget)")
    mesh = snap["mesh"]
    lines.append(
        f"  mesh     : {mesh['visible_devices']} visible device(s) · "
        f"lost pool {mesh['lost_pool'] or 'empty'} · "
        f"{mesh['shrinks']} shrink(s) / {mesh['grows']} grow(s) / "
        f"{mesh['rebalances']} rebalance(s)")
    serve = snap["serve"]
    if serve.get("running"):
        lines.append(
            f"  serve    : {serve['name']!r} · {serve['queued']} "
            f"queued / {serve['inflight']} in flight across "
            f"{len(serve['tenants'])} tenant(s) · {serve['workers']} "
            f"worker(s), {serve['slots']} slot(s)")
    else:
        lines.append("  serve    : no scheduler running")
    fab = snap.get("fabric") or {}
    if fab.get("running"):
        ps = fab.get("persist") or {}
        lines.append(
            f"  fabric   : {fab['name']!r} · {fab['live']}/"
            f"{fab['workers']} worker(s) live, {fab['lost']} lost · "
            f"{fab['queries']['inflight']} quer(ies) in flight · "
            f"persist {_fmt_bytes((ps.get('checkpoint_bytes') or 0) + (ps.get('result_bytes') or 0))} "
            f"({ps.get('checkpoints', 0)} ckpt / "
            f"{ps.get('results', 0)} result)")
    for t, s in snap["slo"].items():
        if s["total"] == 0:
            continue
        lines.append(
            f"  slo      : tenant {t!r} — {s['objective_ms']:g} ms @ "
            f"{s['target']:.4g}: compliance "
            f"{s['compliance']:.4%} · burn {s['burn_rate']:.2f}x · "
            f"budget left {s['budget_remaining']:.1%}")
    for name, s in snap["streams"].items():
        lines.append(
            f"  stream   : {name!r} — {s['batches']} batch(es), "
            f"{s['batches_skipped']} skipped, watermark "
            f"{s['watermark']}, lag {s['batch_lag_s']}")
    fl = snap["flight"]
    lines.append(
        f"  flight   : {'on' if fl['enabled'] else 'OFF'} · "
        f"{fl['records']}/{fl['capacity']} decision(s) buffered · "
        f"{fl['dumps']} dump(s)")
    hs = snap.get("history") or {}
    if hs.get("enabled"):
        lines.append(
            f"  history  : {hs.get('segments', 0)} segment(s) "
            f"({_fmt_bytes(hs.get('bytes') or 0)}) · "
            f"{hs.get('records_written', 0)} record(s) archived this "
            f"process · {hs.get('corrupt_segments', 0)} cold segment(s)"
            + (" · UNCLEAN SHUTDOWN detected — ttf.postmortem()"
               if hs.get("unclean") else ""))
    else:
        lines.append("  history  : OFF (no TFT_HISTORY_DIR and no "
                     "durable tier; ttf.history() empty)")
    perf = snap.get("perf") or {}
    tls = perf.get("timeline") or {}
    lines.append(
        f"  perf     : {'on' if perf.get('enabled') else 'OFF'} · "
        f"{perf.get('warm_baselines', 0)}/{perf.get('baselines', 0)} "
        f"baseline(s) warm over "
        f"{perf.get('completions_total', 0)} completion(s) · "
        f"{perf.get('regressions_total', 0)} regression(s) · timeline "
        f"{tls.get('samples', 0)}/{tls.get('capacity', 0)} sample(s)")
    res = snap["resilience"]
    lines.append(
        f"  engine   : {res['retries']} retri(es), {res['giveups']} "
        f"giveup(s), {res['oom_splits']} oom split(s), "
        f"{res['sync_fallbacks']} sync fallback(s), "
        f"{res['plan_oom_fallbacks']}+{res['dplan_fallbacks']} plan "
        f"fallback(s)")
    inv = snap.get("invariants") or {}
    chaos = inv.get("chaos")
    chaos_s = (f" · chaos seed {chaos['seed']} rate {chaos['rate']:g} "
               f"({chaos['fired']} firing(s) over "
               f"{'|'.join(chaos['sites'])})" if chaos else "")
    lines.append(
        f"  invariant: audits {'on' if inv.get('enabled', True) else 'OFF'}"
        f"{' [strict]' if inv.get('strict') else ''} · "
        f"{inv.get('audits', 0)} audit(s), "
        f"{inv.get('violations', 0)} violation(s), "
        f"{inv.get('rows_tainted', 0)} tainted row ledger(s)"
        f"{chaos_s}")
    quar = snap.get("quarantine") or {}
    active_q = quar.get("active") or {}
    if active_q:
        lines.append(
            f"  quarantine: {len(active_q)} plan(s) fast-rejected "
            f"(after {quar.get('threshold')} permanent failures, TTL "
            f"{quar.get('ttl_s'):g}s — ttf.unquarantine() lifts):")
        for fp, info in sorted(active_q.items()):
            lines.append(
                f"    {fp[:20]}… — {info['failures']} failure(s), "
                f"lifts in {info['ttl_remaining_s']:.0f}s: "
                f"{info['error'] or '?'}")
    if snap["warnings"]:
        lines.append("  WARNINGS :")
        for w in snap["warnings"]:
            lines.append(f"    ! {w}")
    else:
        lines.append("  WARNINGS : none")
    pool = list(_flight.recent())
    source = "flight ring"
    if flight_dumps:
        merged = _flight.load_dumps(flight_dumps)
        pool = sorted(pool + merged,
                      key=lambda r: (r.get("ts", 0), r.get("seq", 0)))
        source = (f"flight ring + {len(merged)} record(s) from "
                  f"per-worker dump(s)")
    by_kind: Dict[str, List[Dict[str, Any]]] = {}
    for r in pool:
        if r.get("kind") in ANOMALY_KINDS:
            by_kind.setdefault(r["kind"], []).append(r)
    if by_kind:
        lines.append(f"  recent anomalous decisions ({source}):")
        now = time.time()
        for k in sorted(by_kind):
            recs = by_kind[k][-max_per_kind:]
            lines.append(f"    {k} ({len(by_kind[k])} total):")
            for r in recs:
                q = f" [{r['query']}]" if r.get("query") else ""
                w = f" w={r['worker']}" if r.get("worker") else ""
                lines.append(f"      -{now - r['ts']:7.1f}s{q}{w} "
                             f"{_detail(r)}")
    else:
        lines.append("  recent anomalous decisions: none recorded")
    # perf regressions grouped by plan fingerprint across workers: the
    # same plan regressing on several of them is one story
    by_fp: Dict[str, List[Dict[str, Any]]] = {}
    for r in pool:
        if r.get("kind") == "perf.regression" and r.get("fingerprint"):
            by_fp.setdefault(str(r["fingerprint"]), []).append(r)
    if by_fp:
        lines.append(f"  perf regressions by plan fingerprint "
                     f"({source}):")
        now = time.time()
        for fp in sorted(by_fp):
            recs = by_fp[fp]
            workers = sorted({str(r["worker"]) for r in recs
                              if r.get("worker")})
            comps = sorted({str(r.get("component")) for r in recs})
            w_s = f", worker(s) {', '.join(workers)}" if workers else ""
            lines.append(f"    plan {fp}… ({len(recs)} "
                         f"regression(s){w_s}; component(s) "
                         f"{', '.join(comps)}):")
            for r in recs[-max_per_kind:]:
                q = f" [{r['query']}]" if r.get("query") else ""
                lines.append(
                    f"      -{now - r.get('ts', now):7.1f}s{q} "
                    f"{r.get('component')}: {r.get('baseline')} -> "
                    f"{r.get('observed')} ({r.get('sigma')} sigma; "
                    f"latency {r.get('latency_s')}s vs "
                    f"{r.get('baseline_latency_s')}s)")
    return "\n".join(lines)
