"""``capture_ms``: the API layer's program capture a query
(``computation.py``): the union of the spans ``computation.capture`` (one
new program's output-shape probes on meta and fake tensors; a program
the cache holds opens none) in the traced window, over the queries
completed in it, in milliseconds. Nothing where no capture ran."""

SPANS = ("computation.capture",)


def read(ctx):
    view = ctx.trace
    done = len(ctx.window.done())
    if view is None or not done or not view.span_intervals(SPANS):
        return None
    return 1e3 * view.span_seconds(SPANS) / done
