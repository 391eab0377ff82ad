"""Neural-network layer functions that build program ops.

Counterpart of the layers of ``paddle_tpu/layers/nn.py`` that the
Transformer LM builds: ``fc``, ``embedding``, ``layer_norm``,
``softmax_with_cross_entropy``, ``mean``, ``reshape``,
``elementwise_add`` and ``slice``. Each appends ops to the default main
program through LayerHelper, with the JAX package's op types, attrs and
names, and returns the output VarDesc.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.program import VarDesc
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["fc", "embedding", "layer_norm", "softmax_with_cross_entropy",
           "mean", "reshape", "elementwise_add", "slice"]


def _fresh_attr(attr) -> ParamAttr:
    """A copy of the ParamAttr (create_parameter fills its name in place)."""
    a = ParamAttr.to_attr(attr)
    return ParamAttr(name=a.name, initializer=a.initializer,
                     learning_rate=a.learning_rate, regularizer=a.regularizer,
                     trainable=a.trainable, gradient_clip=a.gradient_clip)


def fc(input, size: int, num_flatten_dims: int = 1, param_attr=None,
       bias_attr=None, act=None, is_test=False, name=None) -> VarDesc:
    """Fully connected: mul + bias + act. An fc over several inputs (one
    weight each, summed) is not ported."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    inputs_list = helper.multiple_input()
    if len(inputs_list) != 1:
        raise NotImplementedError(f"fc over {len(inputs_list)} inputs (the "
                                  "sum op) is not ported")
    (input_var,) = inputs_list
    if getattr(input_var, "seq_len_var", None):
        raise NotImplementedError("fc over a ragged sequence var is not "
                                  "ported")
    param_shape = [int(np.prod(input_var.shape[num_flatten_dims:]))] + [size]
    w = helper.create_parameter(_fresh_attr(param_attr), param_shape, dtype)
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op("mul", {"X": input_var, "Y": w}, {"Out": pre_bias},
                     {"x_num_col_dims": num_flatten_dims,
                      "y_num_col_dims": 1})
    if bias_attr is not False:
        pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims,
                                        size=[size])
    else:
        pre_act = pre_bias
    return helper.append_activation(pre_act)


def embedding(input, size: Sequence[int], is_sparse: bool = False,
              is_distributed: bool = False, padding_idx: Optional[int] = None,
              param_attr=None, dtype: str = "float32") -> VarDesc:
    """Embedding lookup. is_sparse builds as in the JAX package but its
    op raises when run (SelectedRows gradients are not ported);
    is_distributed (a vocab-sharded table) is not ported."""
    if is_distributed:
        raise NotImplementedError("embedding(is_distributed=True): sharded "
                                  "tables are not ported")
    if getattr(input, "seq_len_var", None):
        raise NotImplementedError("embedding over a ragged sequence var is "
                                  "not ported")
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(helper.param_attr, size, dtype)
    tmp = helper.create_tmp_variable(dtype)
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op("lookup_table", {"Ids": input, "W": w}, {"Out": tmp},
                     {"is_sparse": is_sparse, "is_distributed": is_distributed,
                      "padding_idx": padding_idx})
    return tmp


def layer_norm(input, scale: bool = True, shift: bool = True,
               begin_norm_axis: int = 1, epsilon: float = 1e-5,
               param_attr=None, bias_attr=None, act=None, name=None) -> VarDesc:
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    param_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": input}
    if scale:
        inputs["Scale"] = helper.create_parameter(
            helper.param_attr, param_shape, dtype,
            default_initializer=ConstantInitializer(1.0))
    if shift:
        inputs["Bias"] = helper.create_parameter(
            helper.bias_attr, param_shape, dtype, is_bias=True)
    mean_out = helper.create_tmp_variable("float32", stop_gradient=True)
    var_out = helper.create_tmp_variable("float32", stop_gradient=True)
    out = helper.create_tmp_variable(dtype)
    helper.append_op("layer_norm", inputs,
                     {"Y": out, "Mean": mean_out, "Variance": var_out},
                     {"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def _unary(op_type, x, attrs=None):
    helper = LayerHelper(op_type)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(op_type, {"X": x}, {"Out": out}, attrs or {})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_tmp_variable(logits.dtype)
    loss = helper.create_tmp_variable(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     {"Logits": logits, "Label": label},
                     {"Loss": loss, "Softmax": softmax_out},
                     {"soft_label": soft_label})
    return loss


def mean(x, name=None):
    return _unary("mean", x)


def reshape(x, shape, actual_shape=None, act=None, inplace=True, name=None):
    out = _unary("reshape", x, {"shape": list(shape)})
    if act:
        return _unary(act, out)
    return out


def elementwise_add(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper("elementwise_add")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("elementwise_add", {"X": x, "Y": y}, {"Out": out},
                     {"axis": axis})
    return _unary(act, out) if act else out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("slice", {"Input": input}, {"Out": out},
                     {"axes": list(axes), "starts": list(starts), "ends": list(ends)})
    return out
