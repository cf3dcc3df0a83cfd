"""``stage_out_share.inference``: percent of the traced window covered by
the executor's span ``executor.stage_out`` (a block's outputs into pinned
host buffers, their copies off the card and the event,
``engine/executor.py``), in the inference cells."""

from portbench.readers import span_share


def read(ctx):
    return span_share(ctx, ["executor.stage_out"])
