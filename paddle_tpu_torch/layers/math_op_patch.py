"""Operator overloading on VarDesc: `a + b`, `a * 2`, `a < b`, ...

Counterpart of ``paddle_tpu/layers/math_op_patch.py``: a Python scalar
operand becomes a ``scale`` op where it can (add, sub, mul, div) and a
``fill_constant`` var otherwise; var operands become the elementwise
ops, comparisons the compare ops (bool out). ``__eq__`` / ``__ne__`` are
left alone: VarDescs stay usable as dict keys.
"""

from __future__ import annotations

from ..core.program import VarDesc
from ..layer_helper import LayerHelper

__all__ = ["monkey_patch_variable"]


def _create_op(op_type, x, y, axis=-1, reverse=False):
    helper = LayerHelper(op_type)
    out = helper.create_tmp_variable(x.dtype)
    a, b = (y, x) if reverse else (x, y)
    helper.append_op(op_type, {"X": a, "Y": b}, {"Out": out}, {"axis": axis})
    return out


def _scalar_op(x, scale, bias):
    helper = LayerHelper("scale")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("scale", {"X": x}, {"Out": out},
                     {"scale": float(scale), "bias": float(bias)})
    return out


def _to_var(x, ref):
    """A Python scalar as a var of `ref`'s shape (batch dims as 1)."""
    from .tensor import fill_constant
    shape = list(ref.shape) if ref.shape else [1]
    shape = [1 if s == -1 else s for s in shape]
    return fill_constant(shape, ref.dtype, x)


def monkey_patch_variable():
    def binary(op_type):
        def impl(self, other):
            if isinstance(other, (int, float)):
                if op_type == "elementwise_add":
                    return _scalar_op(self, 1.0, other)
                if op_type == "elementwise_sub":
                    return _scalar_op(self, 1.0, -other)
                if op_type == "elementwise_mul":
                    return _scalar_op(self, other, 0.0)
                if op_type == "elementwise_div":
                    return _scalar_op(self, 1.0 / other, 0.0)
                other = _to_var(other, self)
            return _create_op(op_type, self, other)
        return impl

    def rbinary(op_type):
        def impl(self, other):
            if isinstance(other, (int, float)):
                if op_type == "elementwise_add":
                    return _scalar_op(self, 1.0, other)
                if op_type == "elementwise_mul":
                    return _scalar_op(self, other, 0.0)
                other = _to_var(other, self)
            return _create_op(op_type, self, other, reverse=True)
        return impl

    def compare(op_type):
        def impl(self, other):
            if isinstance(other, (int, float)):
                other = _to_var(other, self)
            helper = LayerHelper(op_type)
            out = helper.create_tmp_variable("bool")
            out.stop_gradient = True
            helper.append_op(op_type, {"X": self, "Y": other}, {"Out": out})
            return out
        return impl

    VarDesc.__add__ = binary("elementwise_add")
    VarDesc.__radd__ = rbinary("elementwise_add")
    VarDesc.__sub__ = binary("elementwise_sub")
    VarDesc.__rsub__ = rbinary("elementwise_sub")
    VarDesc.__mul__ = binary("elementwise_mul")
    VarDesc.__rmul__ = rbinary("elementwise_mul")
    VarDesc.__truediv__ = binary("elementwise_div")
    VarDesc.__rtruediv__ = rbinary("elementwise_div")
    VarDesc.__pow__ = binary("elementwise_pow")
    VarDesc.__neg__ = lambda self: _scalar_op(self, -1.0, 0.0)
    VarDesc.__lt__ = compare("less_than")
    VarDesc.__le__ = compare("less_equal")
    VarDesc.__gt__ = compare("greater_than")
    VarDesc.__ge__ = compare("greater_equal")
