"""``setup_s``: seconds from the start of ``run.py`` to the first timed
request (imports, CUDA, data and weights from the seed, the program's
state, the cell's shapes warmed; host clock)."""


def read(ctx):
    return ctx.setup_s
