"""Per-tenant SLOs: latency objectives, error budgets, burn rates.

The port's counterpart of ``tensorframes_tpu/observability/slo.py``. The
scheduler observes every completion into the always-on
``query_latency_seconds{op="serve",tenant=...,outcome=...}`` histogram;
this module turns those observations into compliance at read time and
keeps no accounting of its own.

- :class:`SLO`: a latency objective (``objective_ms``) and a success
  target (``target``, e.g. 0.999). :func:`set_slo` pins one per tenant;
  others take the process default (``TFT_SLO_DEFAULT_MS``, 1000 ms;
  ``TFT_SLO_TARGET``, 0.999).
- :func:`slo_status`: ``good`` = successful queries at or under the
  objective, which rounds DOWN to the nearest histogram bucket edge
  (conservative and exactly reproducible: put objectives on bucket
  edges); ``bad`` = the rest, failed and shed outcomes included.
  ``burn_rate`` = (bad fraction) / (1 - target): 1.0 spends the error
  budget exactly at the allowed rate.
- :func:`on_burn`: callbacks that fire, edge-triggered and re-armed when
  the burn drops back under the threshold, from the scheduler's
  completion path, evaluated at most once a second per tenant.

Surfaces: ``serve_report()`` (an SLO line per tenant), the
``tft_serve_slo_*`` metrics families, and ``ttf.health()``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from ..utils import tracing
from ..utils.env import env_float as _env_float
from ..utils.logging import get_logger

__all__ = ["SLO", "set_slo", "clear_slos", "slo_for", "slo_status",
           "on_burn", "remove_burn_callback", "note_completion"]

_log = get_logger("observability.slo")

DEFAULT_OBJECTIVE_MS = 1000.0
DEFAULT_TARGET = 0.999


@dataclasses.dataclass(frozen=True)
class SLO:
    """One tenant's promise: ``target`` of queries complete successfully
    within ``objective_ms``."""

    objective_ms: float
    target: float = DEFAULT_TARGET

    def __post_init__(self):
        if self.objective_ms <= 0:
            raise ValueError(
                f"objective_ms must be > 0, got {self.objective_ms}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"target must be in (0, 1), got {self.target}")


_lock = threading.Lock()
_slos: Dict[str, SLO] = {}
# burn callbacks: name -> (fn(tenant, status_dict), threshold, fired set)
_callbacks: Dict[str, tuple] = {}
_fired: Dict[str, set] = {}
# completion-path throttle: tenant -> last evaluation monotonic time
_last_eval: Dict[str, float] = {}


def default_slo() -> SLO:
    """The zero-config fallback every unconfigured tenant gets."""
    return SLO(objective_ms=_env_float("TFT_SLO_DEFAULT_MS",
                                       DEFAULT_OBJECTIVE_MS),
               target=min(max(_env_float("TFT_SLO_TARGET",
                                         DEFAULT_TARGET), 1e-6),
                          1.0 - 1e-9))


def set_slo(tenant: str, objective_ms: float,
            target: float = DEFAULT_TARGET) -> SLO:
    """Pin ``tenant``'s latency objective and success target."""
    slo = SLO(objective_ms=float(objective_ms), target=float(target))
    with _lock:
        _slos[tenant] = slo
    return slo


def clear_slos() -> None:
    with _lock:
        _slos.clear()
        _fired.clear()
        _last_eval.clear()


def slo_for(tenant: str) -> SLO:
    with _lock:
        slo = _slos.get(tenant)
    return slo if slo is not None else default_slo()


def configured_tenants() -> List[str]:
    with _lock:
        return sorted(_slos)


# ---------------------------------------------------------------------------
# status arithmetic (read-time, from the serve latency histograms)
# ---------------------------------------------------------------------------

def _serve_series(tenant: Optional[str] = None) -> Dict[str, list]:
    """tenant -> [(outcome, hist_snapshot)] for op="serve" series."""
    out: Dict[str, list] = {}
    for (family, labels), h in tracing.histograms.snapshot().items():
        if family != "query_latency_seconds":
            continue
        lab = dict(labels)
        if lab.get("op") != "serve" or "tenant" not in lab:
            continue
        if tenant is not None and lab["tenant"] != tenant:
            continue
        out.setdefault(lab["tenant"], []).append(
            (lab.get("outcome", "ok"), h))
    return out


def _good_count(h, objective_s: float) -> int:
    """Observations at or under the largest bucket edge <= objective: the
    conservative, bucket-exact 'good' rule (module docstring)."""
    good = 0
    for le, c in zip(h["les"], h["counts"]):
        if le <= objective_s:
            good += c
        else:
            break
    return good


def _status_for(tenant: str, series: list) -> Dict[str, object]:
    slo = slo_for(tenant)
    objective_s = slo.objective_ms / 1000.0
    total = good = 0
    for outcome, h in series:
        total += h["count"]
        if outcome == "ok":
            good += _good_count(h, objective_s)
    bad = total - good
    compliance = good / total if total else None
    budget = 1.0 - slo.target
    burn = ((bad / total) / budget) if total else None
    return {
        "tenant": tenant,
        "objective_ms": slo.objective_ms,
        "target": slo.target,
        "total": total,
        "good": good,
        "bad": bad,
        "compliance": compliance,
        "error_budget": budget,
        # fraction of the budget left, cumulative over the histogram's
        # lifetime (negative = blown); None before any observation
        "budget_remaining": (1.0 - (bad / total) / budget) if total
        else None,
        "burn_rate": burn,
    }


def slo_status(tenant: Optional[str] = None) -> Dict[str, Dict]:
    """Per-tenant SLO status (module docstring for the field rules).
    Tenants appear once they have at least one completed serve query or
    an explicit :func:`set_slo`; cumulative over the process-global
    histogram registry, like every other ``tft_*`` series."""
    series = _serve_series(tenant)
    names = set(series)
    with _lock:
        cfg = set(_slos)
    if tenant is None:
        names |= cfg
    elif tenant in cfg:
        names.add(tenant)
    return {t: _status_for(t, series.get(t, [])) for t in sorted(names)}


# ---------------------------------------------------------------------------
# burn-rate alerting hook
# ---------------------------------------------------------------------------

def on_burn(fn: Callable[[str, Dict], None], threshold: float = 1.0,
            name: Optional[str] = None) -> str:
    """Register ``fn(tenant, status)`` to fire when a tenant's burn
    rate crosses ``threshold`` (edge-triggered; re-arms when it drops
    back under). Returns the registration name for
    :func:`remove_burn_callback`. Callbacks run on the scheduler's
    completion path: keep them cheap or hand off to a thread."""
    key = name or f"burn@{id(fn):x}"
    with _lock:
        _callbacks[key] = (fn, float(threshold))
        _fired[key] = set()
    return key


def remove_burn_callback(name: str) -> None:
    with _lock:
        _callbacks.pop(name, None)
        _fired.pop(name, None)


def note_completion(tenant: str) -> None:
    """Completion-path hook (called by the scheduler after it observes
    the latency): evaluates burn callbacks for ``tenant``, at most once
    per tenant per second. No callbacks registered = one lock + one
    dict probe."""
    with _lock:
        if not _callbacks:
            return
        now = time.monotonic()
        if now - _last_eval.get(tenant, 0.0) < 1.0:
            return
        _last_eval[tenant] = now
        cbs = list(_callbacks.items())
    status = slo_status(tenant).get(tenant)
    if status is None or status["burn_rate"] is None:
        return
    burn = status["burn_rate"]
    for key, (fn, threshold) in cbs:
        with _lock:
            fired = _fired.setdefault(key, set())
            if burn >= threshold and tenant not in fired:
                fired.add(tenant)
                should = True
            else:
                if burn < threshold:
                    fired.discard(tenant)
                should = False
        if should:
            try:
                fn(tenant, status)
            except Exception as e:  # noqa: BLE001 - alerting is advisory
                _log.error("burn callback %s failed for tenant %r: %s",
                           key, tenant, e)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _render_metrics() -> List[str]:
    status = slo_status()
    if not status:
        return []
    from .metrics import _escape_label as _esc
    fams = {
        "objective_ms": ("gauge", "Latency objective per tenant "
                                  "(configured or TFT_SLO_DEFAULT_MS)."),
        "target": ("gauge", "Success-fraction target per tenant."),
        # gauges, not counters: classification is recomputed at read
        # time against the CURRENT objective, so set_slo() mid-run can
        # legitimately move these in either direction
        "good_queries": ("gauge", "Queries at/under the current "
                                  "objective (bucket-edge rule)."),
        "bad_queries": ("gauge", "Queries over the current objective "
                                 "or failed/shed."),
        "burn_rate": ("gauge", "Error-budget burn rate (1.0 = spending "
                               "exactly the allowed rate)."),
        "budget_remaining": ("gauge", "Fraction of the error budget "
                                      "left (negative = blown)."),
    }
    key_of = {"good_queries": "good", "bad_queries": "bad"}
    lines: List[str] = []
    for suffix, (mtype, help_s) in fams.items():
        fam = f"tft_serve_slo_{suffix}"
        lines.append(f"# HELP {fam} {help_s}")
        lines.append(f"# TYPE {fam} {mtype}")
        for tenant, s in status.items():
            v = s[key_of.get(suffix, suffix)]
            if v is None:
                continue
            lines.append(f'{fam}{{tenant="{_esc(tenant)}"}} '
                         f'{v:.6g}' if isinstance(v, float)
                         else f'{fam}{{tenant="{_esc(tenant)}"}} {v}')
    return lines


def _register_metrics() -> None:
    from .metrics import register_metrics_provider
    register_metrics_provider("serve.slo", _render_metrics)
