"""Multi-head attention module.

Counterpart of ``paddle_tpu/layers/attention.py`` ``multi_head_attention``
as the Transformer LM builds it (self-attention, named layer): four fc
projections whose parameters carry the JAX scope names
``{name}_{q,k,v,out}_{w,b}`` with weights in Paddle's [in, out] layout,
so JAX weights load by name. Attention is causal. ``forward`` is the
prefill (returning the per-head K/V for the paged cache); ``decode``
is one token per slot against the paged pool
(models/transformer.py ``_decode_attention``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops import attention_ops, nn_ops

__all__ = ["MultiHeadAttention"]

_TAGS = ("q", "k", "v", "out")


class MultiHeadAttention(nn.Module):

    def __init__(self, d_model: int, num_heads: int, name: str, *,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"num_heads {num_heads}")
        self.name = name
        self.num_heads = num_heads
        self.d_key = d_model // num_heads
        for tag in _TAGS:
            self.register_parameter(f"{name}_{tag}_w", nn.Parameter(
                torch.empty(d_model, d_model, device=device, dtype=dtype),
                requires_grad=False))
            self.register_parameter(f"{name}_{tag}_b", nn.Parameter(
                torch.zeros(d_model, device=device, dtype=dtype),
                requires_grad=False))

    def proj(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        return nn_ops.fc(x, getattr(self, f"{self.name}_{tag}_w"),
                         getattr(self, f"{self.name}_{tag}_b"))

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:2], self.num_heads, self.d_key)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x [B, S, d_model] -> (out [B, S, d_model], (k, v) [B, S, H, D])."""
        q, k, v = (self._heads(self.proj(x, t)) for t in ("q", "k", "v"))
        ctx = attention_ops.scaled_dot_product_attention(q, k, v,
                                                         causal=True)
        return self.proj(ctx.reshape(x.shape), "out"), (k, v)

    def decode(self, x: torch.Tensor, k_pool: torch.Tensor,
               v_pool: torch.Tensor, block_tables: torch.Tensor,
               context_lens: torch.Tensor) -> torch.Tensor:
        """x [S, 1, d_model]: write each slot's K/V row into its page (in
        place), then attend through the block table. Every slot's row is
        written before any slot attends, so the slots of one speculative
        chain see each other's rows."""
        q, k, v = (self._heads(self.proj(x, t)) for t in ("q", "k", "v"))
        attention_ops.paged_kv_write(k_pool, v_pool, k, v, block_tables,
                                     context_lens)
        ctx = attention_ops.paged_attention(q, k_pool, v_pool, block_tables,
                                            context_lens)
        return self.proj(ctx.reshape(x.shape), "out")
