"""``images_per_s``: images whose logits reached the host in the window,
over the window (host clock)."""

from portbench.readers import rate


def read(ctx):
    return rate(ctx, "images")
