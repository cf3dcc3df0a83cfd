"""``images_per_s.b32``: images whose logits reached the host in the
window, over the window (host clock), in ``resnet50_b32``: blocks of 32
spread wider than blocks of 256, so the cell has a bound of its own."""

from portbench.readers import rate


def read(ctx):
    return rate(ctx, "images")
