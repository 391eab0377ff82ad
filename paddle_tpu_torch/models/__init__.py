"""Model definitions."""

from .transformer import TransformerLM

__all__ = ["TransformerLM"]
