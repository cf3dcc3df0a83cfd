"""Models on the port: the decoder-only transformer LM (scoring, decoding
and the adam train step, on one device or on a mesh, with its MoE layers
and the GPipe step), ResNet-50 batch inference over an image column
(BASELINE config 4) and logistic regression through the frame's ops
(BASELINE config 5; its single-program step also over a data mesh)."""

from .logreg import LogisticRegression
from .resnet import ResNet50
from .transformer import TransformerConfig, TransformerLM, params_from_jax

__all__ = ["LogisticRegression", "ResNet50", "TransformerLM",
           "TransformerConfig", "params_from_jax"]
