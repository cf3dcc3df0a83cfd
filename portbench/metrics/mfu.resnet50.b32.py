"""``mfu.resnet50.b32``: ``mfu.resnet50`` read in ``resnet50_b32``, where
it moves that cell's own ``images_per_s.b32``."""

from portbench.readers import resnet_mfu


def read(ctx):
    return resnet_mfu(ctx)
