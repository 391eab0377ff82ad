"""Neural-network layer functions that build program ops.

Counterpart of the layers of ``paddle_tpu/layers/nn.py`` that the
Transformer LM and ResNet build: ``fc``, ``embedding``, ``layer_norm``,
``softmax_with_cross_entropy``, ``mean``, ``reshape``,
``elementwise_add`` (and ``_sub`` / ``_mul`` / ``_div`` / ``_max`` /
``_min`` / ``_pow``), ``scale``, ``clip``, ``clip_by_norm``, ``cast``,
``slice``, ``conv2d``, ``pool2d``, ``batch_norm``, ``fused_bottleneck``,
``cross_entropy``, ``softmax``, ``relu`` and ``topk``. Each appends ops to the default main program through
LayerHelper, with the JAX package's op types, attrs and names, and
returns the output VarDesc.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.program import VarDesc
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .sequence import propagate_seq

__all__ = ["fc", "embedding", "layer_norm", "softmax_with_cross_entropy",
           "mean", "reshape", "elementwise_add", "slice", "conv2d", "pool2d",
           "batch_norm", "fused_bottleneck", "cross_entropy", "softmax",
           "relu", "topk", "reduce_sum", "elementwise_sub",
           "elementwise_mul", "elementwise_div", "elementwise_max",
           "elementwise_min", "elementwise_pow", "scale", "clip",
           "clip_by_norm", "cast"]


def _fresh_attr(attr) -> ParamAttr:
    """A copy of the ParamAttr (create_parameter fills its name in place)."""
    a = ParamAttr.to_attr(attr)
    return ParamAttr(name=a.name, initializer=a.initializer,
                     learning_rate=a.learning_rate, regularizer=a.regularizer,
                     trainable=a.trainable, gradient_clip=a.gradient_clip)


def fc(input, size: int, num_flatten_dims: int = 1, param_attr=None,
       bias_attr=None, act=None, is_test=False, name=None) -> VarDesc:
    """Fully connected: mul + bias + act. Over a sequence var [B, T, D]
    it is per timestep (the mul flattens at rank - 1) and the output
    keeps the var's @SEQ_LEN companion. An fc over several inputs (one
    weight each, summed) is not ported."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    inputs_list = helper.multiple_input()
    if len(inputs_list) != 1:
        raise NotImplementedError(f"fc over {len(inputs_list)} inputs (the "
                                  "sum op) is not ported")
    (input_var,) = inputs_list
    flatten = num_flatten_dims
    is_seq = (getattr(input_var, "seq_len_var", None)
              and len(input_var.shape) > 2 and num_flatten_dims == 1)
    if is_seq:
        # the reference's [T_total, D] row-major sequence fc becomes
        # [B, T, D] with x_num_col_dims = 2
        flatten = len(input_var.shape) - 1
    param_shape = [int(np.prod(input_var.shape[flatten:]))] + [size]
    w = helper.create_parameter(_fresh_attr(param_attr), param_shape, dtype)
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op("mul", {"X": input_var, "Y": w}, {"Out": pre_bias},
                     {"x_num_col_dims": flatten, "y_num_col_dims": 1})
    if bias_attr is not False:
        pre_act = helper.append_bias_op(pre_bias, dim_start=flatten,
                                        size=[size])
    else:
        pre_act = pre_bias
    out = helper.append_activation(pre_act)
    if is_seq:
        propagate_seq(input_var, out)
    return out


def embedding(input, size: Sequence[int], is_sparse: bool = False,
              is_distributed: bool = False, padding_idx: Optional[int] = None,
              param_attr=None, dtype: str = "float32") -> VarDesc:
    """Embedding lookup; over a sequence var the output [B, T, D] keeps
    its @SEQ_LEN companion. is_sparse builds as in the JAX package but
    its op raises when run (SelectedRows gradients are not ported);
    is_distributed (a vocab-sharded table) is not ported."""
    if is_distributed:
        raise NotImplementedError("embedding(is_distributed=True): sharded "
                                  "tables are not ported")
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(helper.param_attr, size, dtype)
    tmp = helper.create_tmp_variable(dtype)
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op("lookup_table", {"Ids": input, "W": w}, {"Out": tmp},
                     {"is_sparse": is_sparse, "is_distributed": is_distributed,
                      "padding_idx": padding_idx})
    if getattr(input, "seq_len_var", None):
        propagate_seq(input, tmp)
        tmp.shape = tuple(input.shape[:2]) + (size[1],)
        tmp.dtype = dtype
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


def _unary(op_type, x, attrs=None, out_dtype=None):
    helper = LayerHelper(op_type)
    out = helper.create_tmp_variable(out_dtype or x.dtype)
    helper.append_op(op_type, {"X": x}, {"Out": out}, attrs or {})
    return out


def _binary(op_type, x, y, attrs=None):
    helper = LayerHelper(op_type)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(op_type, {"X": x, "Y": y}, {"Out": out}, attrs or {})
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


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    """Sum over `dim` (an int or a list; every dim when None)."""
    helper = LayerHelper("reduce_sum")
    out = helper.create_tmp_variable(input.dtype)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        attrs = {"dim": dim if isinstance(dim, list) else [dim],
                 "keep_dim": keep_dim, "reduce_all": False}
    helper.append_op("reduce_sum", {"X": input}, {"Out": out}, attrs)
    return out


def mean(x, name=None):
    return _unary("mean", x)


def reshape(x, shape, actual_shape=None, act=None, inplace=True, name=None):
    out = _unary("reshape", x, {"shape": list(shape)})
    if act:
        return _unary(act, out)
    return out


def elementwise_add(x, y, axis=-1, act=None, name=None):
    out = _binary("elementwise_add", x, y, {"axis": axis})
    return _unary(act, out) if act else out


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    out = _binary("elementwise_sub", x, y, {"axis": axis})
    return _unary(act, out) if act else out


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    out = _binary("elementwise_mul", x, y, {"axis": axis})
    return _unary(act, out) if act else out


def elementwise_div(x, y, axis=-1, act=None, name=None):
    out = _binary("elementwise_div", x, y, {"axis": axis})
    return _unary(act, out) if act else out


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_max", x, y, {"axis": axis})


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_min", x, y, {"axis": axis})


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_pow", x, y, {"axis": axis})


def clip(x, min, max, name=None):
    return _unary("clip", x, {"min": float(min), "max": float(max)})


def clip_by_norm(x, max_norm, name=None):
    return _unary("clip_by_norm", x, {"max_norm": float(max_norm)})


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    out = _unary("scale", x, {"scale": float(scale), "bias": float(bias),
                              "bias_after_scale": bias_after_scale})
    return _unary(act, out) if act else out


def cast(x, dtype):
    return _unary("cast", x, {"in_dtype": x.dtype, "out_dtype": dtype},
                  out_dtype=dtype)


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("slice", {"Input": input}, {"Out": out},
                     {"axes": list(axes), "starts": list(starts), "ends": list(ends)})
    return out


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def cross_entropy(input, label, soft_label: bool = False) -> VarDesc:
    helper = LayerHelper("cross_entropy")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("cross_entropy", {"X": input, "Label": label}, {"Y": out},
                     {"soft_label": soft_label})
    return out


def conv2d(input, num_filters: int, filter_size, stride=1, padding=0,
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           use_cudnn: bool = True, use_mkldnn: bool = False, act=None,
           name=None) -> VarDesc:
    """NCHW convolution; the filter starts from normal(0, sqrt(2 /
    fan_in)). use_cudnn and use_mkldnn are recorded and ignored."""
    helper = LayerHelper("conv2d", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    groups = groups or 1
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    w = helper.create_parameter(
        helper.param_attr, filter_shape, dtype,
        default_initializer=NormalInitializer(0.0, (2.0 / fan_in) ** 0.5))
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op("conv2d", {"Input": input, "Filter": w},
                     {"Output": pre_bias},
                     {"strides": _pair(stride), "paddings": _pair(padding),
                      "dilations": _pair(dilation), "groups": groups,
                      "use_cudnn": use_cudnn})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2) \
        if bias_attr is not False else pre_bias
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type: str = "max", pool_stride=1,
           pool_padding=0, global_pooling: bool = False, use_cudnn=True,
           ceil_mode: bool = False, name=None, exclusive=True) -> VarDesc:
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("pool2d", {"X": input}, {"Out": out},
                     {"pooling_type": pool_type, "ksize": _pair(pool_size),
                      "strides": _pair(pool_stride),
                      "paddings": _pair(pool_padding),
                      "global_pooling": global_pooling, "ceil_mode": ceil_mode,
                      "exclusive": exclusive})
    return out


def _bn_state_vars(helper, pshape, dtype, param_attr, bias_attr,
                   moving_mean_name=None, moving_variance_name=None):
    """The one definition of batch-norm state (scale and bias parameters,
    persistable float32 running mean and variance, the saved-stat tmp
    vars), shared by batch_norm and fused_bottleneck, in the JAX
    package's creation order (the var names depend on it)."""
    scale = helper.create_parameter(
        param_attr, pshape, dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, pshape, dtype, is_bias=True)
    mean = helper.create_global_variable(
        name=moving_mean_name, dtype="float32", shape=pshape,
        persistable=True)
    mean.stop_gradient = True
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    variance = helper.create_global_variable(
        name=moving_variance_name, dtype="float32", shape=pshape,
        persistable=True)
    variance.stop_gradient = True
    helper.set_variable_initializer(variance, ConstantInitializer(1.0))
    saved_mean = helper.create_tmp_variable("float32", stop_gradient=True)
    saved_var = helper.create_tmp_variable("float32", stop_gradient=True)
    return scale, bias, mean, variance, saved_mean, saved_var


def batch_norm(input, act=None, is_test: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, param_attr=None, bias_attr=None,
               data_layout: str = "NCHW", in_place: bool = False, name=None,
               moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=False) -> VarDesc:
    """Batch norm; the running mean and variance are persistable vars
    that MeanOut/VarianceOut rebind each step. A relu act folds into the
    op (fuse_with_relu)."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    channels = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale, bias, mean, variance, saved_mean, saved_var = _bn_state_vars(
        helper, [channels], dtype, helper.param_attr, helper.bias_attr,
        moving_mean_name, moving_variance_name)
    out = helper.create_tmp_variable(dtype)
    fuse_relu = act == "relu"
    helper.append_op("batch_norm",
                     {"X": input, "Scale": scale, "Bias": bias,
                      "Mean": mean, "Variance": variance},
                     {"Y": out, "MeanOut": mean, "VarianceOut": variance,
                      "SavedMean": saved_mean, "SavedVariance": saved_var},
                     {"momentum": momentum, "epsilon": epsilon,
                      "is_test": is_test, "data_layout": data_layout,
                      "fuse_with_relu": fuse_relu})
    return out if fuse_relu else helper.append_activation(out)


def fused_bottleneck(input, ch_out, momentum: float = 0.9,
                     epsilon: float = 1e-5, is_test: bool = False,
                     name=None) -> VarDesc:
    """A stride-1 ResNet rest block (conv1x1-BN-relu, conv3x3-BN-relu,
    conv1x1-BN, + input, relu) as one op, in train and inference graphs
    alike (is_test switches the math), so the two share parameter
    names."""
    helper = LayerHelper("fused_bottleneck", name=name)
    dtype = input.dtype
    cin = input.shape[1]
    if ch_out * 4 != cin:
        raise ValueError(f"rest block: input channels {cin} != 4 * {ch_out}")

    def conv_w(cout, cink, k):
        return helper.create_parameter(
            ParamAttr(), [cout, cink, k, k], dtype,
            default_initializer=NormalInitializer(
                0.0, (2.0 / (cink * k * k)) ** 0.5))

    def bn_vars(c):
        return _bn_state_vars(helper, [c], dtype, ParamAttr(), ParamAttr())

    w1 = conv_w(ch_out, cin, 1)
    w2 = conv_w(ch_out, ch_out, 3)
    w3 = conv_w(cin, ch_out, 1)
    bns = (bn_vars(ch_out), bn_vars(ch_out), bn_vars(cin))
    out = helper.create_tmp_variable(dtype)
    inputs = {"X": input, "W1": w1, "W2": w2, "W3": w3}
    outputs = {"Out": out}
    for k, bn in zip(("1", "2", "3"), bns):
        scale, bias, mean, var, saved_m, saved_v = bn
        inputs.update({"Scale" + k: scale, "Bias" + k: bias, "Mean" + k: mean,
                       "Variance" + k: var})
        outputs.update({"MeanOut" + k: mean, "VarOut" + k: var,
                        "SavedMean" + k: saved_m, "SavedVar" + k: saved_v})
    helper.append_op("fused_bottleneck", inputs, outputs,
                     {"momentum": momentum, "epsilon": epsilon,
                      "is_test": is_test})
    return out


def softmax(input, use_cudnn=True, name=None):
    return _unary("softmax", input)


def relu(x, name=None):
    return _unary("relu", x)


def topk(input, k):
    helper = LayerHelper("top_k")
    values = helper.create_tmp_variable(input.dtype)
    indices = helper.create_tmp_variable("int64")
    indices.stop_gradient = True
    helper.append_op("top_k", {"X": input}, {"Out": values, "Indices": indices},
                     {"k": k})
    return values, indices
