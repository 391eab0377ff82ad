"""Thin layer functions for the registered unary ops.

Counterpart of ``paddle_tpu/layers/ops.py``: one function a name of
``_UNARY_OPS``, each appending its op (X -> Out, attrs from the keyword
arguments) and returning the output var. The learning-rate schedules
(layers/learning_rate_scheduler.py) are written with them.
"""

from __future__ import annotations

from ..layer_helper import LayerHelper

_UNARY_OPS = [
    "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "softshrink",
    "sqrt", "rsqrt", "abs", "ceil", "floor", "cos", "sin", "round",
    "reciprocal", "square", "softplus", "softsign", "brelu", "leaky_relu",
    "soft_relu", "elu", "relu6", "pow", "stanh", "hard_sigmoid", "swish",
    "gelu", "thresholded_relu", "hard_shrink", "cumsum", "log_softmax",
]

__all__ = list(_UNARY_OPS)


def _make_layer(op_type):
    def layer(x, **kwargs):
        helper = LayerHelper(op_type)
        out = helper.create_tmp_variable(x.dtype)
        attrs = {k: v for k, v in kwargs.items()
                 if k != "name" and v is not None}
        helper.append_op(op_type, {"X": x}, {"Out": out}, attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"Append the `{op_type}` op to the main program."
    return layer


for _op in _UNARY_OPS:
    globals()[_op] = _make_layer(_op)
