"""Ragged-sequence ops over the padded + lengths representation.

Counterpart of ``paddle_tpu/ops/sequence_ops.py``: a sequence batch is a
dense padded tensor [B, T, ...] plus an int32 lengths vector [B] (the
``@SEQ_LEN`` companion var); ops mask instead of compacting. Ported:
``time_mask``, ``_bshape`` and the ``sequence_pool`` op with its six pool
types. The other sequence ops are not ported.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op

__all__ = ["time_mask", "sequence_pool"]


def time_mask(seq_len: torch.Tensor, t: int, dtype=torch.bool
              ) -> torch.Tensor:
    """[B] lengths -> [B, T] mask."""
    steps = torch.arange(t, device=seq_len.device)
    return (steps[None, :] < seq_len[:, None]).to(dtype)


def _bshape(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B, T] mask broadcast to x's rank [B, T, ...]."""
    return mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 2))


def sequence_pool(x: torch.Tensor, seq_len: torch.Tensor,
                  pooltype: str = "average") -> torch.Tensor:
    """pooltype in {sum, average, sqrt, max, last, first}. x [B, T, ...],
    seq_len [B] -> [B, ...]; an empty sequence pools to 0 (sum, average,
    sqrt), -inf or the integer minimum (max), or its first row (last,
    first), as in the JAX package."""
    ptype = pooltype.lower()
    mask = _bshape(time_mask(seq_len, x.shape[1], x.dtype), x)
    tail = (-1,) + (1,) * (x.dim() - 2)
    if ptype == "sum":
        return torch.sum(x * mask, dim=1)
    if ptype in ("average", "sqrt"):
        denom = torch.clamp_min(seq_len, 1).to(x.dtype)
        if ptype == "sqrt":
            denom = torch.sqrt(denom)
        return torch.sum(x * mask, dim=1) / denom.reshape(tail)
    if ptype == "max":
        neg = (float("-inf") if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        return torch.amax(torch.where(mask.bool(), x,
                                      torch.full_like(x, neg)), dim=1)
    if ptype == "last":
        idx = torch.clamp_min(seq_len - 1, 0).long()
        idx = idx.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand(
            (-1, 1) + tuple(x.shape[2:]))
        return torch.gather(x, 1, idx).squeeze(1)
    if ptype == "first":
        return x[:, 0]
    raise ValueError(f"unknown pooltype {ptype}")


@register_op("sequence_pool")
def _sequence_pool_op(ctx, ins, attrs):
    """sequence_pool_op.cc. X: [B, T, ...], SeqLen: [B]; Out: [B, ...]."""
    return {"Out": [sequence_pool(ins["X"][0], ins["SeqLen"][0],
                                  attrs.get("pooltype", "average"))]}
