"""Ops on tensors: the plain functions the modules call and the registered
ops the Executor runs, under the JAX package's op-type names. Importing
the package registers every ported op."""

from . import (attention_ops, fused_ops, math_ops, nn_ops, optimizer_ops,
               rnn_ops, sequence_ops, tensor_ops)

__all__ = ["attention_ops", "fused_ops", "math_ops", "nn_ops",
           "optimizer_ops", "rnn_ops", "sequence_ops", "tensor_ops"]
