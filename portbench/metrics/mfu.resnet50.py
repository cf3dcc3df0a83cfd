"""``mfu.resnet50``: the model's share of the card's float32 peak: model
FLOPs (``arith.resnet_flops``: two per multiply-add of every convolution
and the classifier, from the layer shapes) of the images completed in the
traced window, over the window, over 67 TFLOP/s (float32 outside the
tensor cores: the configuration runs with TF32 off), in
``resnet50_b256``."""

from portbench.readers import resnet_mfu


def read(ctx):
    return resnet_mfu(ctx)
