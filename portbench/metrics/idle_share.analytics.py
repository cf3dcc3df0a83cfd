"""``idle_share.analytics``: percent of the traced window in which the
card ran no kernel, copy or set (``torch.profiler``), in the keyed-query
cells."""

from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
