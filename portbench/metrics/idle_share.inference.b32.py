"""``idle_share.inference.b32``: ``idle_share.inference`` read in
``resnet50_b32``: percent of the traced window in which the card ran no
kernel, copy or set (``torch.profiler``)."""

from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
