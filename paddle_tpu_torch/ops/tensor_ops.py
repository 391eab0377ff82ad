"""Tensor creation and shape ops, registered by the JAX package's names.

Counterparts in ``paddle_tpu/ops/tensor_ops.py``: ``fill_constant``,
``uniform_random``, ``gaussian_random``, ``cast``, ``reshape``,
``unsqueeze``, ``slice``, ``gather`` and ``lookup_table``. Random ops
draw from the run's ``torch.Generator``
(``ExecContext``), or from one seeded by the op's own nonzero ``seed``
attr; they give other numbers than JAX's PRNG from the same seed, with the
same distribution.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_op
from ..core.types import torch_dtype
from . import nn_ops


def _fill_infer(op, block):
    out = block.var(op.output("Out")[0])
    out.shape = tuple(op.attrs["shape"])
    out.dtype = op.attrs.get("dtype", "float32")


def _empty(ctx, attrs) -> torch.Tensor:
    return torch.empty(tuple(attrs["shape"]),
                       dtype=torch_dtype(attrs.get("dtype", "float32")),
                       device=ctx.device)


def _generator(ctx, attrs) -> torch.Generator:
    seed = attrs.get("seed", 0)
    if not seed:
        return ctx.generator
    return torch.Generator(device=ctx.device).manual_seed(int(seed))


@register_op("fill_constant", infer_shape=_fill_infer)
def fill_constant(ctx, ins, attrs):
    return {"Out": [_empty(ctx, attrs).fill_(attrs.get("value", 0.0))]}


@register_op("uniform_random", infer_shape=_fill_infer)
def uniform_random(ctx, ins, attrs):
    return {"Out": [_empty(ctx, attrs).uniform_(
        attrs.get("min", -1.0), attrs.get("max", 1.0),
        generator=_generator(ctx, attrs))]}


@register_op("gaussian_random", infer_shape=_fill_infer)
def gaussian_random(ctx, ins, attrs):
    return {"Out": [_empty(ctx, attrs).normal_(
        attrs.get("mean", 0.0), attrs.get("std", 1.0),
        generator=_generator(ctx, attrs))]}


def _cast_infer(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape = x.shape
    out.dtype = op.attrs["out_dtype"]


@register_op("cast", infer_shape=_cast_infer)
def cast(ctx, ins, attrs):
    """To the device dtype of out_dtype (64-bit narrowed)."""
    return {"Out": [ins["X"][0].to(torch_dtype(attrs["out_dtype"]))]}


def _reshape_infer(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    shape = list(op.attrs["shape"])
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    known = int(np.prod([s for s in shape if s != -1]))
    total = int(np.prod(x.shape)) if x.shape and all(d >= 0 for d in x.shape) else None
    if -1 in shape and total is not None:
        shape[shape.index(-1)] = total // known
    out.shape = tuple(shape)
    out.dtype = x.dtype


@register_op("reshape", infer_shape=_reshape_infer)
def reshape(ctx, ins, attrs):
    x = ins["X"][0]
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(attrs["shape"])]
    return {"Out": [x.reshape(shape)]}


def _unsqueeze_infer(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    shape = list(x.shape)
    for a in sorted(op.attrs["axes"]):
        shape.insert(a, 1)
    out.shape, out.dtype = tuple(shape), x.dtype


@register_op("unsqueeze", infer_shape=_unsqueeze_infer)
def unsqueeze(ctx, ins, attrs):
    x = ins["X"][0]
    for a in sorted(attrs["axes"]):
        x = x.unsqueeze(a)
    return {"Out": [x]}


def _slice_infer(op, block):
    x = block.var(op.input("Input")[0])
    out = block.var(op.output("Out")[0])
    shape = list(x.shape)
    for ax, st, en in zip(op.attrs["axes"], op.attrs["starts"], op.attrs["ends"]):
        size = x.shape[ax]
        st2 = max(st + size, 0) if st < 0 else min(st, size)
        en2 = max(en + size, 0) if en < 0 else min(en, size)
        shape[ax] = max(en2 - st2, 0)
    out.shape, out.dtype = tuple(shape), x.dtype


@register_op("slice", infer_shape=_slice_infer)
def slice_op(ctx, ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[ax] = slice(st, en)
    return {"Out": [x[tuple(idx)]]}


def _gather_infer(op, block):
    x = block.var(op.input("X")[0])
    idx = block.var(op.input("Index")[0])
    out = block.var(op.output("Out")[0])
    out.shape = tuple(idx.shape[:1]) + tuple(x.shape[1:])
    out.dtype = x.dtype


@register_op("gather", infer_shape=_gather_infer)
def gather(ctx, ins, attrs):
    """Rows of X along axis 0 at the flattened Index."""
    return {"Out": [nn_ops.gather(ins["X"][0], ins["Index"][0])]}


def _lookup_infer(op, block):
    ids = block.var(op.input("Ids")[0])
    w = block.var(op.input("W")[0])
    out = block.var(op.output("Out")[0])
    shape = list(ids.shape)
    if shape and shape[-1] == 1:
        shape = shape[:-1]
    out.shape = tuple(shape) + (w.shape[1],)
    out.dtype = w.dtype


@register_op("lookup_table", infer_shape=_lookup_infer)
def lookup_table(ctx, ins, attrs):
    """Embedding gather; padding_idx rows read as zero. Row-sparse
    (SelectedRows) gradients, is_sparse=True, are not ported."""
    if attrs.get("is_sparse"):
        raise NotImplementedError(
            "lookup_table(is_sparse=True): row-sparse (SelectedRows) "
            "gradients are not ported; build the embedding with "
            "is_sparse=False")
    ids, w = ins["Ids"][0], ins["W"][0]
    out = nn_ops.lookup_table(ids, w)
    pidx = attrs.get("padding_idx", -1)
    if pidx is not None and pidx >= 0:
        if ids.dim() > 1 and ids.shape[-1] == 1:
            ids = ids[..., 0]
        out = torch.where((ids == pidx)[..., None], 0.0, out)
    return {"Out": [out]}
