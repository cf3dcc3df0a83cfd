"""Server-side observability: ``ServerStats``, ``serve_report()`` and the
per-tenant Prometheus families.

The port's counterpart of ``tensorframes_tpu/serve/stats.py``, over one
source of truth: the scheduler's per-tenant snapshot and the always-on
``query_latency_seconds`` histogram, which the scheduler observes with a
``tenant`` label at every completion.

- :class:`ServerStats`: per-tenant outcome totals, live queue depth and
  in-flight, the shared compile cache's totals, and per-tenant latency
  quantiles read back out of the histogram's buckets;
- :func:`serve_report`: the human-readable table (the serving twin of
  ``frame.explain()``);
- a metrics provider registered while a scheduler is live:
  ``tft_serve_queue_depth`` and ``tft_serve_inflight`` gauges and
  ``tft_serve_queries_total{tenant=...,outcome=...}`` counters, read live
  at scrape time.

While a :class:`~.fabric.ServeFabric` is open, :func:`serve_report` ends
in its placement table (worker epochs, lease state, tenant placement,
the durable tier's footprint).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..observability import baseline as _baseline
from ..observability import slo as _slo
from ..observability.metrics import (_escape_label as _escape,
                                     register_metrics_provider,
                                     unregister_metrics_provider)
from ..utils import tracing
from ..utils.logging import get_logger

__all__ = ["ServerStats", "serve_report"]

_log = get_logger("serve.stats")


def _latency_series(tenant: Optional[str] = None) -> List[dict]:
    """The ``query_latency_seconds`` histogram snapshots for op=serve
    (optionally one tenant), any outcome."""
    out = []
    for (family, labels), h in tracing.histograms.snapshot().items():
        if family != "query_latency_seconds":
            continue
        lab = dict(labels)
        if lab.get("op") != "serve":
            continue
        if tenant is not None and lab.get("tenant") != tenant:
            continue
        out.append(h)
    return out


def latency_quantile(q: float, tenant: Optional[str] = None
                     ) -> Optional[float]:
    """Estimate of the ``q`` quantile (e.g. 0.99) of serving latency
    from the histogram buckets: the bucket edge at/above the quantile
    rank — the standard Prometheus ``histogram_quantile``
    discretization, which also means a quantile landing in the ``+Inf``
    bucket CLAMPS to the largest finite bucket edge (the true tail is
    at least that; the buckets cannot say how much more). None before
    any observation."""
    series = _latency_series(tenant)
    total = sum(h["count"] for h in series)
    if total == 0:
        return None
    # merge the (identically-bucketed) series
    les = series[0]["les"]
    counts = [0] * len(les)
    for h in series:
        for i, c in enumerate(h["counts"]):
            counts[i] += c
    finite = [le for le in les if le != float("inf")]
    rank = q * total
    cum = 0
    for le, c in zip(les, counts):
        cum += c
        if cum >= rank:
            return le if le != float("inf") else (
                finite[-1] if finite else None)
    return None


class ServerStats:
    """A read-only view over a :class:`~.scheduler.QueryScheduler`.

    Note on latency: ``p50``/``p99`` read the PROCESS-GLOBAL
    ``query_latency_seconds`` histogram (filtered to ``op="serve"`` and
    the tenant label) — Prometheus-style cumulative series that are
    never reset, so they cover every scheduler this process has run,
    not only this one. For a fresh window, reset the registry
    (``utils.tracing.histograms.reset()``) or, on a real deployment,
    compute windowed quantiles from the scraped series (``rate()`` over
    buckets), which is the intended path.
    """

    def __init__(self, scheduler):
        self._scheduler = scheduler

    def snapshot(self) -> Dict[str, dict]:
        return self._scheduler.snapshot()

    def compile_cache(self) -> Optional[dict]:
        cc = self._scheduler.compile_cache
        return cc.stats() if cc is not None else None

    def p99(self, tenant: Optional[str] = None) -> Optional[float]:
        return latency_quantile(0.99, tenant)

    def p50(self, tenant: Optional[str] = None) -> Optional[float]:
        return latency_quantile(0.50, tenant)

    def render(self) -> str:
        snap = self.snapshot()
        sched = self._scheduler
        lines = [
            f"serve {sched.name!r} · {len(snap)} tenant(s) · "
            f"{sched.workers} worker(s) · "
            f"{sched.slot_pool.slots} pipeline slot(s)",
        ]
        if not snap:
            lines.append("  (no tenants yet — nothing submitted)")
        for name, s in snap.items():
            p99 = self.p99(name)
            p99_s = f"{p99 * 1000:.1f} ms" if p99 is not None else "n/a"
            lines.append(
                f"  tenant {name!r}: weight {s['weight']:g} · "
                f"{s['queued']} queued / {s['inflight']} in flight "
                f"(caps {s['max_queue']}/{s['max_inflight']})")
            lines.append(
                f"    {s['submitted']} submitted · {s['admitted']} "
                f"admitted · {s['completed']} completed · "
                f"{s['failed']} failed · p99 {p99_s}")
            lines.append(
                f"    rejected {s['rejected']} (queue full) · "
                f"over_quota {s['over_quota']} · shed {s['shed']} "
                f"(admission)")
            if s.get("quarantined"):
                lines.append(
                    f"    quarantined {s['quarantined']} (poison-plan "
                    f"fast-reject; ttf.unquarantine() lifts)")
            slo = _slo.slo_status(name).get(name)
            if slo is not None and slo["total"]:
                lines.append(
                    f"    SLO {slo['objective_ms']:g} ms @ "
                    f"{slo['target']:.4g}: compliance "
                    f"{slo['compliance']:.4%} · burn "
                    f"{slo['burn_rate']:.2f}x · budget left "
                    f"{slo['budget_remaining']:.1%} "
                    f"({slo['good']} good / {slo['bad']} bad)")
            if s.get("preempted") or s.get("cancelled"):
                lines.append(
                    f"    preempted {s.get('preempted', 0)} "
                    f"(checkpointed + resumed) · "
                    f"cancelled {s.get('cancelled', 0)}")
            regs = [r for r in _baseline.regressions()
                    if r.get("tenant") == name]
            if regs:
                last = regs[-1]
                lines.append(
                    f"    PERF: {len(regs)} regression(s) flagged · "
                    f"last: plan {last['fingerprint'][:16]}… "
                    f"{last['component']} {last['baseline']:g} -> "
                    f"{last['observed']:g} ({last['sigma']:g} sigma; "
                    f"ttf.regressions())")
        cc = self.compile_cache()
        if cc is not None:
            lines.append(
                f"  shared compile cache: {cc['entries']} entries · "
                f"{cc['hits']} hit(s) / {cc['misses']} miss(es) · "
                f"{cc['uncacheable']} uncacheable")
        try:
            from . import quarantine as _quarantine
            q = _quarantine.status()
        except Exception:  # noqa: BLE001 - report must render regardless
            q = {"active": {}}
        for fp, info in sorted((q.get("active") or {}).items()):
            lines.append(
                f"  QUARANTINE: plan {fp[:20]}… — {info['failures']} "
                f"permanent failure(s), lifts in "
                f"{info['ttl_remaining_s']:.0f}s "
                f"(ttf.unquarantine() lifts now)")
        return "\n".join(lines)


def serve_report(scheduler=None) -> str:
    """The serving layer's ``explain()``: per-tenant queues, in-flight,
    outcome totals, p99, SLOs, regressions, quarantines and the shared
    compile cache. Uses the most recently created live scheduler when
    none is given. While a :class:`~.fabric.ServeFabric` is open, its
    placement table is appended."""
    if scheduler is None:
        from .scheduler import live_scheduler
        scheduler = live_scheduler()
    if scheduler is None:
        return ("(no scheduler running — create a serve.QueryScheduler "
                "or submit a query through ttf.submit())")
    out = ServerStats(scheduler).render()
    try:
        from ..observability import history as _history
        hs = _history.stats()
    except Exception:  # noqa: BLE001 - report must render regardless
        hs = {"enabled": False}
    if hs.get("enabled"):
        out += (f"\n  history: {hs['segments']} segment(s) "
                f"({hs['bytes']} B) at {hs['dir']} · "
                f"{hs['records_written']} record(s) this process · "
                f"ttf.history() / ttf.why(qid)")
        if hs.get("unclean"):
            out += ("\n  UNCLEAN SHUTDOWN detected on startup — "
                    "ttf.postmortem() has the triage report")
    try:
        from .fabric import live_fabric
        fab = live_fabric()
    except Exception:  # noqa: BLE001 - report must render regardless
        fab = None
    if fab is not None:
        out = out + "\n\n" + fab.placement_report()
    return out


# ---------------------------------------------------------------------------
# Prometheus provider (live gauges; registered per live scheduler)
# ---------------------------------------------------------------------------

def _provider_lines(scheduler) -> List[str]:
    snap = scheduler.snapshot()
    lines = [
        "# HELP tft_serve_queue_depth Queries queued per tenant "
        "(live at scrape time).",
        "# TYPE tft_serve_queue_depth gauge",
    ]
    for name, s in snap.items():
        lines.append(f'tft_serve_queue_depth{{tenant="{_escape(name)}"}} '
                     f'{s["queued"]}')
    lines.append("# HELP tft_serve_inflight Queries executing per tenant "
                 "(live at scrape time).")
    lines.append("# TYPE tft_serve_inflight gauge")
    for name, s in snap.items():
        lines.append(f'tft_serve_inflight{{tenant="{_escape(name)}"}} '
                     f'{s["inflight"]}')
    from .scheduler import _OUTCOMES  # single source for outcome keys

    lines.append("# HELP tft_serve_queries_total Scheduler outcomes per "
                 "tenant (submitted/admitted/rejected/over_quota/shed/"
                 "completed/failed/preempted/cancelled).")
    lines.append("# TYPE tft_serve_queries_total counter")
    for name, s in snap.items():
        for key in _OUTCOMES:
            lines.append(
                f'tft_serve_queries_total{{tenant="{_escape(name)}",'
                f'outcome="{key}"}} {s[key]}')
    snap_c = tracing.counters.snapshot()
    for fam, key, help_s in (
            ("tft_serve_preemptions_total", "serve.preemptions",
             "Running queries parked at a block boundary with a "
             "resumable checkpoint."),
            ("tft_serve_cancelled_total", "serve.cancelled",
             "Queries cancelled (queued or at a block boundary)."),
            ("tft_serve_resumed_blocks_total", "pipeline.resumed_blocks",
             "Blocks restored from preemption checkpoints instead of "
             "re-dispatched."),
            ("tft_serve_checkpoint_discards_total",
             "serve.checkpoint_discards",
             "Preemption checkpoints discarded on resume (plan changed "
             "under the query; re-ran from scratch)."),
            ("tft_serve_quarantines_total", "serve.quarantines",
             "Plan fingerprints quarantined after a permanent-failure "
             "streak (poison-query fast-reject)."),
            ("tft_serve_quarantine_rejects_total", "serve.quarantined",
             "Submissions fast-rejected because their plan fingerprint "
             "is quarantined.")):
        lines.append(f"# HELP {fam} {help_s}")
        lines.append(f"# TYPE {fam} counter")
        lines.append(f"{fam} {snap_c.get(key, 0)}")
    cc = scheduler.compile_cache
    if cc is not None:
        st = cc.stats()
        lines.append("# HELP tft_serve_compile_cache_total Shared "
                     "cross-query compile cache interning outcomes.")
        lines.append("# TYPE tft_serve_compile_cache_total counter")
        for key in ("hits", "misses", "uncacheable"):
            lines.append(
                f'tft_serve_compile_cache_total{{result="{key}"}} '
                f'{st[key]}')
        lines.append("# HELP tft_serve_compile_cache_entries Canonical "
                     "computations currently interned.")
        lines.append("# TYPE tft_serve_compile_cache_entries gauge")
        lines.append(f"tft_serve_compile_cache_entries {st['entries']}")
    return lines


def register_scheduler_metrics(scheduler) -> None:
    register_metrics_provider(f"serve:{scheduler.name}:{id(scheduler)}",
                              lambda: _provider_lines(scheduler))


def unregister_scheduler_metrics(scheduler) -> None:
    unregister_metrics_provider(f"serve:{scheduler.name}:{id(scheduler)}")
