"""Models on the port: the decoder-only transformer LM (single device)."""

from .transformer import TransformerConfig, TransformerLM, params_from_jax

__all__ = ["TransformerConfig", "TransformerLM", "params_from_jax"]
