"""``dop_wall_ms``: the parallel layer's host time a query
(``parallel/distributed.py``): the union of spans ``dmap_blocks.dispatch``,
``dfilter.dispatch``, ``daggregate.device_key_ids`` and
``daggregate.dispatch`` in the traced window, over the queries completed
in it, in milliseconds."""

SPANS = ("dmap_blocks.dispatch", "dfilter.dispatch",
         "daggregate.device_key_ids", "daggregate.dispatch")


def read(ctx):
    view = ctx.trace
    done = len(ctx.window.done())
    if view is None or not done or not view.span_intervals(SPANS):
        return None
    return 1e3 * view.span_seconds(SPANS) / done
