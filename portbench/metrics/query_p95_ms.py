"""``query_p95_ms``: the 95th percentile of every query of the window,
from its submit to its result on the host (host clock)."""

from portbench.readers import latency_ms


def read(ctx):
    return latency_ms(ctx, 95.0)
