"""Attention ops on tensors.

Counterpart of ``paddle_tpu/ops/attention_ops.py``: the single-device
branch of ``scaled_dot_product_attention`` and the two paged decode ops
of the decode-step program (models/transformer.py
``transformer_decode_step``), each a plain function and the registered
op of the Program path. The kernels they reach are in
``kernels/flash_attention.py``.

``paged_kv_write`` writes the pools it is fed IN PLACE (the JAX op
returns new arrays): its KOut and VOut are those same tensors, so a
step never copies a pool, and ``paged_attention`` reads the written
pool through them. Under AMP a float32 pool feed is cast to bfloat16 at
the step's entry (core/lowering.py), and the write lands in that copy,
which KOut and VOut then are: the JAX op's new bf16 pools.
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


def _paged_write_infer(op, block):
    for pool_in, pool_out in (("KPool", "KOut"), ("VPool", "VOut")):
        src = block.var(op.input(pool_in)[0])
        dst = block.var(op.output(pool_out)[0])
        dst.shape, dst.dtype = src.shape, src.dtype


@register_op("paged_kv_write", infer_shape=_paged_write_infer)
def _paged_kv_write_op(ctx, ins, attrs):
    """K, V [S, 1, H, D] into KPool, VPool [NB, BS, H, D] at position
    ContextLens-1 through BlockTables, in place; KOut and VOut are the
    written pools."""
    ko, vo = paged_kv_write(ins["KPool"][0], ins["VPool"][0], ins["K"][0],
                            ins["V"][0], ins["BlockTables"][0],
                            ins["ContextLens"][0])
    return {"KOut": [ko], "VOut": [vo]}


def _paged_attn_infer(op, block):
    q = block.var(op.input("Q")[0])
    out = block.var(op.output("Out")[0])
    out.shape, out.dtype = q.shape, q.dtype


@register_op("paged_attention", infer_shape=_paged_attn_infer)
def _paged_attention_op(ctx, ins, attrs):
    """Q [S, 1, H, D] against KPool, VPool through BlockTables and
    ContextLens; attr scale (0.0: 1/sqrt(D))."""
    return {"Out": [paged_attention(ins["Q"][0], ins["KPool"][0],
                                    ins["VPool"][0], ins["BlockTables"][0],
                                    ins["ContextLens"][0],
                                    scale=attrs.get("scale", 0.0))]}
