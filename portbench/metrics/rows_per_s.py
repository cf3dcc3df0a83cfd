"""``rows_per_s``: frame rows scanned by the queries completed in the
window, over the window (host clock)."""

from portbench.readers import rate


def read(ctx):
    return rate(ctx, "rows")
