"""``keyed_sum_ms``: the keyed sum's device time a query
(``ops/segment_reduce.py``): every kernel launched under the span
``daggregate.keyed_sum`` (``parallel/distributed.py``: every shard's
table of every fetch column, B1 for a float sum, the plain ``index_add_``
for an integer one; not the collective or the copy to the host) in the
traced window, over the queries completed in it, in milliseconds. Timed by
the span, not by kernel names, so a rewrite of either sum still reads the
same work. Nothing where no kernel ran under the span."""

OPS = ("daggregate.keyed_sum",)


def read(ctx):
    view = ctx.trace
    done = len(ctx.window.done())
    if view is None or not done:
        return None
    seconds = sum(call.device_s for call in view.op_calls(OPS[0]))
    if seconds <= 0:
        return None
    return 1e3 * seconds / done
