"""Attention ops on tensors.

Counterpart of ``paddle_tpu/ops/attention_ops.py``: the single-device
branch of ``scaled_dot_product_attention`` (a plain function and the
registered op of the Program path) and the two paged decode ops. The
kernels they reach are in ``kernels/flash_attention.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.registry import register_op
from ..kernels.flash_attention import (dot_product_attention,
                                       paged_decode_attention,
                                       paged_kv_update)

__all__ = ["scaled_dot_product_attention", "paged_kv_write",
           "paged_attention"]


def scaled_dot_product_attention(q, k, v, bias: Optional[torch.Tensor] = None,
                                 *, causal: bool = False, scale: float = 0.0,
                                 sp_mode: str = "none") -> torch.Tensor:
    """Q,K,V: [B, S, H, D]; optional additive bias [.., Sq, Sk].
    scale 0.0 means 1/sqrt(D). Sequence parallelism (sp_mode "ring" or
    "ulysses") is not ported and raises."""
    if sp_mode not in ("none", None):
        raise NotImplementedError(
            f"scaled_dot_product_attention(sp_mode={sp_mode!r}): sequence "
            "parallelism is not ported")
    return dot_product_attention(q, k, v, bias, causal=causal,
                                 scale=scale or None)


def _sdpa_infer(op, block):
    q = block.var(op.input("Q")[0])
    out = block.var(op.output("Out")[0])
    out.shape, out.dtype = q.shape, q.dtype


@register_op("scaled_dot_product_attention", infer_shape=_sdpa_infer)
def _sdpa_op(ctx, ins, attrs):
    """Q, K, V [B, S, H, D], optional BiasMask; attrs causal, scale (0.0:
    1/sqrt(D)), sp_mode ("none" only)."""
    bias = ins["BiasMask"][0] if ins.get("BiasMask") else None
    return {"Out": [scaled_dot_product_attention(
        ins["Q"][0], ins["K"][0], ins["V"][0], bias,
        causal=bool(attrs.get("causal", False)),
        scale=attrs.get("scale", 0.0),
        sp_mode=attrs.get("sp_mode", "none"))]}


def paged_kv_write(k_pool, v_pool, k, v, block_tables, context_lens):
    """Write each slot's new K/V row ([S, 1, H, D]) into its page of the
    pool ([NB, BS, H, D]) at position context_lens-1, in place. Slots
    with context length 0 write into the reserved null block 0."""
    return paged_kv_update(k_pool, v_pool, k[:, 0], v[:, 0], block_tables,
                           context_lens)


def paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                    scale: float = 0.0) -> torch.Tensor:
    """q [S, 1, H, D] (one decode token per slot) against the paged pool
    through each slot's block table; context_lens is the span INCLUDING
    the just-written token. Returns [S, 1, H, D]."""
    out = paged_decode_attention(q[:, 0], k_pool, v_pool, block_tables,
                                 context_lens, scale=scale or None)
    return out[:, None]
