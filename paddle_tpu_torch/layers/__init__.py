"""Layer modules."""

from .attention import MultiHeadAttention

__all__ = ["MultiHeadAttention"]
