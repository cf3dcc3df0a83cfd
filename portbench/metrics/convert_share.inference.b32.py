"""``convert_share.inference.b32``: ``convert_share.inference`` read in
``resnet50_b32``: percent of the traced window covered by the executor's
span ``executor.convert`` (a block's host-to-device copy and cast)."""

from portbench.readers import span_share


def read(ctx):
    return span_share(ctx, ["executor.convert"])
