"""Models on the port, each on one device: the decoder-only transformer LM
(scoring, decoding and the adam train step), ResNet-50 batch inference
over an image column (BASELINE config 4) and logistic regression through
the frame's ops (BASELINE config 5)."""

from .logreg import LogisticRegression
from .resnet import ResNet50
from .transformer import TransformerConfig, TransformerLM, params_from_jax

__all__ = ["LogisticRegression", "ResNet50", "TransformerLM",
           "TransformerConfig", "params_from_jax"]
