"""``stage_out_share.inference.b32``: ``stage_out_share.inference`` read
in ``resnet50_b32``: percent of the traced window covered by the
executor's span ``executor.stage_out`` (a block's outputs into pinned
host buffers, their copies off the card and the event)."""

from portbench.readers import span_share


def read(ctx):
    return span_share(ctx, ["executor.stage_out"])
