"""``convert_share.inference``: percent of the traced window covered by
the executor's span ``executor.convert`` (a block's host-to-device copy
and cast, ``engine/executor.py``), in the inference cells."""

from portbench.readers import span_share


def read(ctx):
    return span_share(ctx, ["executor.convert"])
