"""LayerHelper: shared machinery of the layer functions.

Counterpart of ``paddle_tpu/layer_helper.py``: creates parameters (a var
in the main program plus its init op in the startup program), temporary
output vars, and the bias and activation tails, under the same unique
names as the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .core.program import (VarDesc, default_main_program,
                           default_startup_program, unique_name)
from .initializer import ConstantInitializer, Initializer, XavierInitializer
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name else unique_name(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    # -- inputs -------------------------------------------------------------
    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, VarDesc):
            return [inputs]
        return list(inputs)

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("bias_attr"))

    def input_dtype(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for v in inputs:
            if dtype is None:
                dtype = v.dtype
            elif dtype != v.dtype:
                raise ValueError("all inputs must have the same dtype")
        return dtype

    # -- variable creation --------------------------------------------------
    def create_parameter(self, attr: ParamAttr, shape: Sequence[int], dtype: str,
                         is_bias: bool = False,
                         default_initializer: Optional[Initializer] = None) -> VarDesc:
        if not isinstance(attr, ParamAttr):
            raise TypeError(f"attr must be a ParamAttr, got {attr!r}")
        # master weights: parameters are stored in float32 whatever the
        # layer computes in, as in the JAX package
        if dtype in ("bfloat16", "float16"):
            dtype = "float32"
        if attr.name is None:
            attr.name = unique_name(".".join([self.name, "b" if is_bias else "w"]))
        init = attr.initializer or default_initializer or (
            ConstantInitializer(0.0) if is_bias else XavierInitializer())

        startup_block = self.startup_program.global_block
        sv = startup_block.create_var(attr.name, shape=shape, dtype=dtype,
                                      persistable=True, is_parameter=True)
        init(sv, startup_block)

        block = self.main_program.global_block
        p = block.create_var(attr.name, shape=shape, dtype=dtype,
                             persistable=True, is_parameter=True)
        p.trainable = attr.trainable
        p.regularizer = attr.regularizer
        p.initializer = init
        p.stop_gradient = not attr.trainable
        if attr.gradient_clip is not None:
            p.need_clip = attr.gradient_clip
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        return p

    def create_tmp_variable(self, dtype: str = "float32", stop_gradient=False) -> VarDesc:
        return self.main_program.current_block().create_var(
            unique_name(".".join([self.name, "tmp"])), shape=(), dtype=dtype,
            stop_gradient=stop_gradient)

    def create_global_variable(self, name=None, persistable=False, dtype="float32",
                               shape=()):
        return self.main_program.global_block.create_var(
            name or unique_name(".".join([self.name, "tmp"])), shape=shape,
            dtype=dtype, persistable=persistable)

    def set_variable_initializer(self, var: VarDesc, initializer: Initializer):
        """Create var in the startup program and append its init op there."""
        sb = self.startup_program.global_block
        sv = sb.create_var(var.name, shape=var.shape, dtype=var.dtype,
                           persistable=True)
        initializer(sv, sb)

    # -- common tails -------------------------------------------------------
    def append_bias_op(self, input_var: VarDesc, dim_start: int = 1,
                       dim_end: Optional[int] = None,
                       size: Optional[list] = None) -> VarDesc:
        if size is None:
            size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if bias_attr is None:
            return input_var
        b = self.create_parameter(bias_attr, shape=size, dtype=input_var.dtype,
                                  is_bias=True)
        tmp = self.create_tmp_variable(input_var.dtype)
        self.append_op("elementwise_add", {"X": input_var, "Y": b}, {"Out": tmp},
                       {"axis": dim_start})
        return tmp

    def append_activation(self, input_var: VarDesc) -> VarDesc:
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_tmp_variable(input_var.dtype)
        self.append_op(act_type, {"X": input_var}, {"Out": tmp}, act)
        return tmp

