"""Weight decay appended as gradient ops.

Counterpart of ``paddle_tpu/regularizer.py``: ``L2Decay`` adds
``coeff · param`` and ``L1Decay`` ``coeff · sign(param)`` to a
parameter's gradient, in the program, between the gradient clip and the
optimizer's update op. A parameter's own regularizer (its ParamAttr's)
wins over the optimizer's.
"""

from __future__ import annotations

from .core.program import default_main_program

__all__ = ["WeightDecayRegularizer", "L1DecayRegularizer",
           "L2DecayRegularizer", "L1Decay", "L2Decay",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self._regularization_coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        decay = block.create_var(grad.name + "@L2DECAY", shape=param.shape,
                                 dtype=param.dtype)
        decay.stop_gradient = True
        block.append_op("scale", {"X": param}, {"Out": decay},
                        {"scale": self._regularization_coeff})
        block.append_op("elementwise_add", {"X": grad, "Y": decay},
                        {"Out": grad})
        return grad


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self._regularization_coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        sign = block.create_var(grad.name + "@L1SIGN", shape=param.shape,
                                dtype=param.dtype)
        sign.stop_gradient = True
        decay = block.create_var(grad.name + "@L1DECAY", shape=param.shape,
                                 dtype=param.dtype)
        decay.stop_gradient = True
        block.append_op("sign", {"X": param}, {"Out": sign})
        block.append_op("scale", {"X": sign}, {"Out": decay},
                        {"scale": self._regularization_coeff})
        block.append_op("elementwise_add", {"X": grad, "Y": decay},
                        {"Out": grad})
        return grad


def append_regularization_ops(parameters_and_grads, regularization=None):
    """Append each parameter's decay ops (its own regularizer, else
    `regularization`); returns the pairs unchanged (the grads are
    rewritten in place, by name)."""
    block = default_main_program().global_block
    for param, grad in parameters_and_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if grad is not None and reg is not None:
            reg.append_regularization_op(param, grad, block)
    return list(parameters_and_grads)


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
