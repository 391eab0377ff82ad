"""Dense math ops, registered by the JAX package's names.

Counterparts in ``paddle_tpu/ops/math_ops.py``: ``elementwise_add``
(Paddle's axis broadcast), ``mul`` (flatten at ``x_num_col_dims`` /
``y_num_col_dims``, the core of ``layers.fc``) and ``mean``.
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from . import nn_ops


def broadcast_y_to_x(x: torch.Tensor, y: torch.Tensor, axis: int):
    """Paddle's elementwise broadcast: Y's shape is a contiguous run of
    X's dims starting at `axis` (-1: trailing-aligned)."""
    xnd, ynd = x.dim(), y.dim()
    if ynd == 0 or xnd == ynd:
        return y
    if axis == -1:
        axis = xnd - ynd
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


def _mean_infer(op, block):
    out = block.var(op.output("Out")[0])
    out.shape = (1,)
    out.dtype = block.var(op.input("X")[0]).dtype


@register_op("mean", infer_shape=_mean_infer)
def mean(ctx, ins, attrs):
    """Mean of every element, as a [1] tensor (the loss head)."""
    return {"Out": [ins["X"][0].mean().reshape(1)]}
