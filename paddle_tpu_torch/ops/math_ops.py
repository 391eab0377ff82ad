"""Dense math ops, registered by the JAX package's names.

Counterparts in ``paddle_tpu/ops/math_ops.py``: ``elementwise_add``
(Paddle's axis broadcast), ``mul`` (flatten at ``x_num_col_dims`` /
``y_num_col_dims``, the core of ``layers.fc``), ``reduce_sum``,
``mean``, ``arg_max``, and the metric ops ``top_k`` and ``accuracy``.
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from . import nn_ops


def broadcast_y_to_x(x: torch.Tensor, y: torch.Tensor, axis: int):
    """Paddle's elementwise broadcast: Y's shape is a contiguous run of
    X's dims starting at `axis` (-1: trailing-aligned). Trailing-aligned
    is torch's own broadcast, so Y is then returned as it is."""
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


@register_op("elementwise_add", infer_shape=_ew_infer)
def elementwise_add(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [x + broadcast_y_to_x(x, y, attrs.get("axis", -1))]}


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
