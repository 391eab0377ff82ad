"""Layers: the program builders (as ``paddle_tpu.layers`` has them) and
the attention module the served model uses. Importing the package
patches VarDesc's operators (math_op_patch.py), as the JAX package's
does."""

from . import learning_rate_scheduler, ops
from .attention import MultiHeadAttention, fused_attention, multi_head_attention
from .io import data
from .learning_rate_scheduler import (autoincreased_step_counter,
                                      exponential_decay, global_step_counter,
                                      inverse_time_decay, natural_exp_decay,
                                      noam_decay, piecewise_decay,
                                      polynomial_decay)
from .math_op_patch import monkey_patch_variable
from .metric import accuracy
from .nn import (batch_norm, cast, clip, clip_by_norm, conv2d, cross_entropy,
                 elementwise_add, elementwise_div, elementwise_max,
                 elementwise_min, elementwise_mul, elementwise_pow,
                 elementwise_sub, embedding, fc, fused_bottleneck,
                 layer_norm, mean, pool2d, reduce_sum, relu, reshape, scale,
                 slice, softmax, softmax_with_cross_entropy, topk)
from .ops import *  # noqa: F401,F403
from .sequence import (dynamic_gru, dynamic_lstm, dynamic_lstmp,
                       sequence_first_step, sequence_last_step, sequence_pool)
from .tensor import argmax, create_parameter, fill_constant, sums

monkey_patch_variable()

__all__ = (["MultiHeadAttention", "fused_attention", "multi_head_attention",
            "data", "accuracy", "batch_norm", "cast", "clip", "clip_by_norm",
            "conv2d", "cross_entropy", "elementwise_add", "elementwise_div",
            "elementwise_max", "elementwise_min", "elementwise_mul",
            "elementwise_pow", "elementwise_sub", "embedding", "fc",
            "fused_bottleneck", "layer_norm", "mean", "pool2d", "reduce_sum",
            "relu", "reshape", "scale", "slice", "softmax",
            "softmax_with_cross_entropy", "topk", "dynamic_gru",
            "dynamic_lstm", "dynamic_lstmp", "sequence_first_step",
            "sequence_last_step", "sequence_pool", "argmax",
            "create_parameter", "fill_constant", "sums"]
           + ops.__all__ + learning_rate_scheduler.__all__)
