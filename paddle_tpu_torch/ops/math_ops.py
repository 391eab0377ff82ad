"""Dense math ops, registered by the JAX package's names.

Counterparts in ``paddle_tpu/ops/math_ops.py``: the elementwise binary
ops (``elementwise_add`` / ``_sub`` / ``_mul`` / ``_div`` / ``_max`` /
``_min`` / ``_pow``, Paddle's axis broadcast), ``scale``, the
multi-input ``sum``, ``sign``, ``clip`` and ``clip_by_norm``, ``mul``
(flatten at ``x_num_col_dims`` / ``y_num_col_dims``, the core of
``layers.fc``), ``reduce_sum``, ``mean``, ``arg_max``, and the metric
ops ``top_k`` and ``accuracy``; and from ``ops/control_ops.py`` the
comparisons (``less_than`` ... ``not_equal``) and ``increment``, which
the learning-rate schedules use.
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op, same_shape
from . import nn_ops


def harmonize(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The mixed-precision rule of the JAX package: the Y (weight or
    bias) side follows X's float dtype, so bfloat16 activations meet
    float32 parameters in bfloat16 (autograd carries the gradient back to
    the parameter's dtype)."""
    if (y.dtype != x.dtype and x.is_floating_point()
            and y.is_floating_point()):
        return y.to(x.dtype)
    return y


def broadcast_y_to_x(x: torch.Tensor, y: torch.Tensor, axis: int):
    """Paddle's elementwise broadcast: Y's shape is a contiguous run of
    X's dims starting at `axis` (-1: trailing-aligned), Y in X's float
    dtype (``harmonize``). Trailing-aligned is torch's own broadcast, so
    Y is then returned as it is."""
    y = harmonize(x, y)
    xnd, ynd = x.dim(), y.dim()
    if axis == -1:
        axis = xnd - ynd
    if ynd == 0 or xnd == ynd or axis == xnd - ynd:
        return y
    return y.reshape([1] * axis + list(y.shape) + [1] * (xnd - axis - ynd))


def _ew_infer(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape, out.dtype = x.shape, x.dtype


def _register_elementwise(name, fn):
    def compute(ctx, ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        return {"Out": [fn(x, broadcast_y_to_x(x, y, attrs.get("axis", -1)))]}
    register_op(name, infer_shape=_ew_infer)(compute)


_register_elementwise("elementwise_add", torch.add)
_register_elementwise("elementwise_sub", torch.sub)
_register_elementwise("elementwise_mul", torch.mul)
_register_elementwise("elementwise_div", torch.div)
_register_elementwise("elementwise_max", torch.maximum)
_register_elementwise("elementwise_min", torch.minimum)
_register_elementwise("elementwise_pow", torch.pow)


@register_op("scale", infer_shape=same_shape())
def scale(ctx, ins, attrs):
    """Out = X * scale + bias, or (X + bias) * scale with
    bias_after_scale=False."""
    x = ins["X"][0]
    s, b = attrs.get("scale", 1.0), attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * s + b]}
    return {"Out": [(x + b) * s]}


@register_op("sum", infer_shape=_ew_infer)
def sum_op(ctx, ins, attrs):
    """The sum of N tensors, added left to right."""
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_op("sign", infer_shape=same_shape())
def sign(ctx, ins, attrs):
    return {"Out": [torch.sign(ins["X"][0])]}


@register_op("clip", infer_shape=same_shape())
def clip(ctx, ins, attrs):
    return {"Out": [torch.clamp(ins["X"][0], attrs["min"], attrs["max"])]}


@register_op("clip_by_norm", infer_shape=same_shape())
def clip_by_norm(ctx, ins, attrs):
    """Out = X * max_norm / max(‖X‖₂, max_norm)."""
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return {"Out": [x * (max_norm / torch.clamp_min(norm, max_norm))]}


@register_op("squared_l2_norm")
def squared_l2_norm(ctx, ins, attrs):
    return {"Out": [torch.sum(torch.square(ins["X"][0])).reshape(1)]}


# ---------------------------------------------------------------------------
# comparisons and increment (ops/control_ops.py)
# ---------------------------------------------------------------------------

def _cmp_infer(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape, out.dtype = x.shape, "bool"


def _register_compare(name, fn):
    def compute(ctx, ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        return {"Out": [fn(x, broadcast_y_to_x(x, y, attrs.get("axis", -1)))]}
    register_op(name, infer_shape=_cmp_infer)(compute)


_register_compare("less_than", torch.lt)
_register_compare("less_equal", torch.le)
_register_compare("greater_than", torch.gt)
_register_compare("greater_equal", torch.ge)
_register_compare("equal", torch.eq)
_register_compare("not_equal", torch.ne)


@register_op("increment")
def increment(ctx, ins, attrs):
    """X + step in X's own dtype (an integer counter stays an integer)."""
    x = ins["X"][0]
    return {"Out": [x + torch.tensor(attrs.get("step", 1.0), dtype=x.dtype)]}


def _mul_infer(op, block):
    x = block.var(op.input("X")[0])
    y = block.var(op.input("Y")[0])
    out = block.var(op.output("Out")[0])
    xn = op.attrs.get("x_num_col_dims", 1)
    yn = op.attrs.get("y_num_col_dims", 1)
    out.shape = tuple(x.shape[:xn]) + tuple(y.shape[yn:])
    out.dtype = x.dtype


@register_op("mul", infer_shape=_mul_infer)
def mul(ctx, ins, attrs):
    """Flatten X to 2-D at x_num_col_dims and Y at y_num_col_dims, GEMM,
    restore the leading dims. The fc case (Y whole, X's trailing dim
    contracted) is one ``torch.matmul``."""
    x, y = ins["X"][0], ins["Y"][0]
    y = harmonize(x, y)
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    if yn == 1 and len(xs) - xn == 1 and xs[-1] == ys[0]:
        return {"Out": [nn_ops.mul(x, y)]}
    x2 = x.reshape(math.prod(xs[:xn]) or 1, math.prod(xs[xn:]) or 1)
    y2 = y.reshape(math.prod(ys[:yn]) or 1, math.prod(ys[yn:]) or 1)
    return {"Out": [(x2 @ y2).reshape(xs[:xn] + ys[yn:])]}


def _reduce_infer(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    dims = op.attrs.get("dim", [0])
    keep = op.attrs.get("keep_dim", False)
    if op.attrs.get("reduce_all", False):
        out.shape = (1,) if keep else ()
    else:
        dims = [d % len(x.shape) for d in dims] if x.shape else []
        if keep:
            out.shape = tuple(1 if i in dims else s
                              for i, s in enumerate(x.shape))
        else:
            out.shape = tuple(s for i, s in enumerate(x.shape)
                              if i not in dims)
    out.dtype = x.dtype


@register_op("reduce_sum", infer_shape=_reduce_infer)
def reduce_sum(ctx, ins, attrs):
    """Sum over attrs["dim"] (every dim with reduce_all), keep_dim as
    asked."""
    x = ins["X"][0]
    keep = attrs.get("keep_dim", False)
    if attrs.get("reduce_all", False):
        out = x.sum()
        return {"Out": [out.reshape([1] * x.dim()) if keep else out]}
    dims = tuple(d % x.dim() for d in attrs.get("dim", [0]))
    return {"Out": [x.sum(dim=dims, keepdim=keep)]}


def _mean_infer(op, block):
    out = block.var(op.output("Out")[0])
    out.shape = (1,)
    out.dtype = block.var(op.input("X")[0]).dtype


@register_op("mean", infer_shape=_mean_infer)
def mean(ctx, ins, attrs):
    """Mean of every element, as a [1] tensor (the loss head)."""
    return {"Out": [ins["X"][0].mean().reshape(1)]}


def _arg_infer(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    axis = op.attrs.get("axis", -1) % max(len(x.shape), 1)
    out.shape = tuple(s for i, s in enumerate(x.shape) if i != axis)
    out.dtype = "int64"


@register_op("arg_max", infer_shape=_arg_infer)
def arg_max(ctx, ins, attrs):
    """Index of the first largest entry along attrs["axis"], in int32,
    the device width of the int64 var (as the JAX package)."""
    x = ins["X"][0]
    return {"Out": [torch.argmax(x, dim=attrs.get("axis", -1))
                    .to(torch.int32)]}


def _topk_infer(op, block):
    x = block.var(op.input("X")[0])
    shape = tuple(x.shape[:-1]) + (op.attrs["k"],)
    out = block.var(op.output("Out")[0])
    idx = block.var(op.output("Indices")[0])
    out.shape, out.dtype = shape, x.dtype
    idx.shape, idx.dtype = shape, "int64"


@register_op("top_k", infer_shape=_topk_infer)
def top_k(ctx, ins, attrs):
    """The k largest along the last dim, largest first; the indices in
    int32, the device width of the int64 var (as the JAX package)."""
    vals, idx = torch.topk(ins["X"][0], attrs["k"], dim=-1)
    return {"Out": [vals], "Indices": [idx.to(torch.int32)]}


@register_op("accuracy")
def accuracy(ctx, ins, attrs):
    """The fraction of rows whose top-k indices hold the label, with the
    count of such rows and the row count."""
    idx = ins["Indices"][0]
    label = ins["Label"][0].reshape(-1, 1).to(idx.dtype)
    correct = (idx == label).any(dim=1)
    total = correct.shape[0]
    num = correct.sum(dtype=torch.int32)
    return {"Accuracy": [(num.float() / float(total)).reshape(1)],
            "Correct": [num.reshape(1)],
            "Total": [torch.full((1,), total, dtype=torch.int32,
                                 device=idx.device)]}
