"""Hand-written device kernels, each beside its plain PyTorch version.

The name ``flash_attention`` here is the function, as in the JAX package;
its module (with the ``launches`` count) is
``importlib.import_module("tensorframes_tpu_torch.ops.flash_attention")``.
"""

from .flash_attention import flash_attention, flash_attention_reference
from .segment_reduce import segment_sum, segment_sum_reference

__all__ = ["flash_attention", "flash_attention_reference", "segment_sum",
           "segment_sum_reference"]
