"""Tensor-creation layer functions.

Counterpart of ``paddle_tpu/layers/tensor.py`` ``create_parameter``,
``fill_constant``, ``sums`` and ``argmax``.
"""

from __future__ import annotations

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["create_parameter", "fill_constant", "sums", "argmax"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_tmp_variable(dtype)
    out.stop_gradient = True
    helper.append_op("fill_constant", {}, {"Out": out},
                     {"shape": list(shape), "dtype": dtype, "value": float(value)})
    return out


def sums(input, out=None):
    """The multi-input ``sum`` op over `input` (a list of vars)."""
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_tmp_variable(input[0].dtype)
    helper.append_op("sum", {"X": list(input)}, {"Out": out})
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max")
    out = helper.create_tmp_variable("int64")
    out.stop_gradient = True
    helper.append_op("arg_max", {"X": x}, {"Out": out}, {"axis": axis})
    return out
