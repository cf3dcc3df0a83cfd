"""``keyed_sum_roofline``: B1's share of its memory roofline
(``ops/segment_reduce.py``, the op ``tft::segment_sum``).

Every call of the op in the traced window: its least bytes from its
shapes (``arith.segment_sum_bytes``: each row's values and id read once,
each segment's sums written once), the values' item size from the
profiler's input dtypes (the configuration's precision where the profiler
gives none) and int32 ids (the port's), over the device time of every
kernel launched under the op, against 3.35 TB/s. Timed by the op, not by
kernel names, so a rewrite of the kernel still reads the same work.
Nothing where no call ran on the card."""

import math

from portbench import arith

OPS = ("tft::segment_sum",)


def _item(dtype, fallback):
    name = str(dtype or "").replace("torch.", "")
    return {"double": 8, "float": 4, "c10::Half": 2,
            "c10::BFloat16": 2}.get(name, arith.ITEM_BYTES.get(name,
                                                               fallback))


def read(ctx):
    view = ctx.trace
    if view is None:
        return None
    fallback = arith.ITEM_BYTES[ctx.config["precision"]]
    nbytes, seconds = 0, 0.0
    for call in view.op_calls(OPS[0]):
        if call.device_s <= 0 or len(call.shapes) < 2 or len(call.scalars) < 3:
            continue
        values = call.shapes[0]
        rows = values[0] if values else 0
        width = math.prod(values[1:]) if len(values) > 1 else 1
        item = _item(call.dtypes[0] if call.dtypes else None, fallback)
        nbytes += arith.segment_sum_bytes(rows, width, int(call.scalars[2]),
                                          item)
        seconds += call.device_s
    if seconds <= 0:
        return None
    return 100.0 * nbytes / arith.HBM_BYTES_PER_S / seconds
