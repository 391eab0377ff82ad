"""Layers: the program builders (as ``paddle_tpu.layers`` has them) and
the attention module the served model uses."""

from .attention import MultiHeadAttention, fused_attention, multi_head_attention
from .io import data
from .metric import accuracy
from .nn import (batch_norm, conv2d, cross_entropy, elementwise_add,
                 embedding, fc, fused_bottleneck, layer_norm, mean, pool2d,
                 reduce_sum, relu, reshape, slice, softmax,
                 softmax_with_cross_entropy, topk)
from .sequence import (dynamic_gru, dynamic_lstm, dynamic_lstmp,
                       sequence_first_step, sequence_last_step, sequence_pool)
from .tensor import argmax, create_parameter, fill_constant

__all__ = ["MultiHeadAttention", "fused_attention", "multi_head_attention",
           "data", "accuracy", "batch_norm", "conv2d", "cross_entropy",
           "elementwise_add", "embedding", "fc", "fused_bottleneck",
           "layer_norm", "mean", "pool2d", "reduce_sum", "relu", "reshape",
           "slice", "softmax", "softmax_with_cross_entropy", "topk",
           "dynamic_gru", "dynamic_lstm", "dynamic_lstmp",
           "sequence_first_step", "sequence_last_step", "sequence_pool",
           "argmax", "create_parameter", "fill_constant"]
