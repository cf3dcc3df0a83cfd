"""Helpers that the metric readers under ``metrics/`` share."""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from . import arith
from .core import MetricContext


def rate(ctx: MetricContext, key: str) -> Optional[float]:
    """The work ``key`` of the requests completed in the window, over the
    window's host-clock seconds."""
    total = ctx.window.total(key)
    return None if total is None else total / ctx.window.seconds


def latency_ms(ctx: MetricContext, q: float) -> Optional[float]:
    """The ``q``-th percentile (numpy's linear interpolation) of the
    latency of every completed request, submit to result on the host."""
    done = ctx.window.done()
    if not done:
        return None
    return float(np.percentile([(r.end - r.start) * 1e3 for r in done], q))


def idle_share(ctx: MetricContext) -> Optional[float]:
    """Percent of the traced window with no kernel, copy or set on the
    card; nothing where the trace holds no device activity."""
    view = ctx.trace
    if view is None or not view.device:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s)


def span_share(ctx: MetricContext, names: Iterable[str]) -> Optional[float]:
    """Percent of the traced window covered by the union of the spans'
    intervals; nothing where none was recorded."""
    view = ctx.trace
    if view is None or not view.span_intervals(names):
        return None
    return 100.0 * view.span_seconds(names) / view.window_s


def resnet_mfu(ctx: MetricContext) -> Optional[float]:
    """The model's share of the card's float32 peak: model FLOPs
    (``arith.resnet_flops``) of the images completed in the window, over
    the window, over :data:`arith.PEAK_FLOPS` ``["float32"]`` (TF32 off)."""
    images = ctx.window.total("images")
    if not images:
        return None
    flops = arith.resnet_flops(ctx.config) * images
    return 100.0 * flops / ctx.window.seconds / arith.PEAK_FLOPS["float32"]
