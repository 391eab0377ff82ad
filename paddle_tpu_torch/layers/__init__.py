"""Layers: the program builders (as ``paddle_tpu.layers`` has them) and
the attention module the served model uses."""

from .attention import MultiHeadAttention, fused_attention, multi_head_attention
from .io import data
from .nn import (elementwise_add, embedding, fc, layer_norm, mean, reshape,
                 slice, softmax_with_cross_entropy)
from .tensor import create_parameter, fill_constant

__all__ = ["MultiHeadAttention", "fused_attention", "multi_head_attention",
           "data", "elementwise_add", "embedding", "fc", "layer_norm", "mean",
           "reshape", "slice", "softmax_with_cross_entropy",
           "create_parameter", "fill_constant"]
