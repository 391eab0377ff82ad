"""Multi-head attention: the program builders and the module.

Counterpart of ``paddle_tpu/layers/attention.py``.

* ``fused_attention`` and ``multi_head_attention`` build program ops
  (the ``scaled_dot_product_attention`` op between the fc projections),
  and ``paged_kv_write`` and ``paged_attention`` the decode step's paged
  ops (models/transformer.py ``_decode_attention``), with the JAX
  package's op types and names; the Executor runs them.
* ``MultiHeadAttention`` is the prefill block as a module
  (self-attention, named layer): four fc projections whose parameters
  carry the JAX scope names ``{name}_{q,k,v,out}_{w,b}`` with weights in
  Paddle's [in, out] layout, so JAX weights load by name. Attention is
  causal. ``forward`` returns the per-head K/V beside the output.
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch
from torch import nn

from ..layer_helper import LayerHelper
from ..ops import attention_ops, nn_ops
from ..param_attr import ParamAttr

__all__ = ["fused_attention", "multi_head_attention", "paged_kv_write",
           "paged_attention", "MultiHeadAttention"]


def fused_attention(q, k, v, bias=None, causal=False, scale=0.0,
                    sp_mode="none", name=None):
    """Fused attention on [B, S, H, D] vars. Returns [B, S, H, D]."""
    helper = LayerHelper("fused_attention", input=q, name=name)
    out = helper.create_tmp_variable(q.dtype)
    ins = {"Q": q, "K": k, "V": v}
    if bias is not None:
        ins["BiasMask"] = bias
    helper.append_op("scaled_dot_product_attention", ins, {"Out": out},
                     {"causal": bool(causal), "scale": float(scale),
                      "sp_mode": sp_mode})
    return out


def paged_kv_write(k_pool, v_pool, k, v, block_tables, context_lens,
                   name=None):
    """Write each slot's new K/V row ([S, 1, H, D]) into its page of the
    paged pool ([NB, BS, H, D]). Returns the updated (k_pool, v_pool)
    vars, which the decode program fetches as the next step's pools (the
    port's op writes the fed pools in place, so they are the same
    tensors)."""
    helper = LayerHelper("paged_kv_write", name=name)
    k_out = helper.create_tmp_variable(k_pool.dtype)
    v_out = helper.create_tmp_variable(v_pool.dtype)
    helper.append_op("paged_kv_write",
                     {"KPool": k_pool, "VPool": v_pool, "K": k, "V": v,
                      "BlockTables": block_tables,
                      "ContextLens": context_lens},
                     {"KOut": k_out, "VOut": v_out}, {})
    return k_out, v_out


def paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                    scale=0.0, name=None):
    """One decode token per slot (q [S, 1, H, D]) attends through its
    block table into the paged KV pool. Returns [S, 1, H, D]."""
    helper = LayerHelper("paged_attention", name=name)
    out = helper.create_tmp_variable(q.dtype)
    helper.append_op("paged_attention",
                     {"Q": q, "KPool": k_pool, "VPool": v_pool,
                      "BlockTables": block_tables,
                      "ContextLens": context_lens},
                     {"Out": out}, {"scale": float(scale)})
    return out


def multi_head_attention(queries, keys=None, values=None, *, num_heads,
                         d_key=None, d_value=None, d_model=None,
                         causal=False, sp_mode="none", dropout_rate=0.0,
                         param_attr=None, bias_attr=None, tp_shard=False,
                         kv_out=None, name=None):
    """Full MHA block on [B, S, d_model] vars: QKV projections, fused
    attention, output projection. Self-attention when keys/values are
    omitted. Dropout, tensor and sequence parallelism are not ported.

    kv_out: optional list — the per-head K and V vars ([B, S, H, d_key])
    are appended as a (k, v) pair, so a prefill export can fetch them for
    the paged decode cache (serving/decode)."""
    from . import nn as L

    if dropout_rate:
        raise NotImplementedError(
            f"multi_head_attention(dropout_rate={dropout_rate}): dropout is "
            "not ported")
    if tp_shard:
        raise NotImplementedError("multi_head_attention(tp_shard=True): "
                                  "tensor parallelism is not ported")
    if sp_mode not in ("none", None):
        raise NotImplementedError(f"multi_head_attention(sp_mode={sp_mode!r})"
                                  ": sequence parallelism is not ported")
    keys = queries if keys is None else keys
    values = keys if values is None else values
    dm = int(queries.shape[-1]) if d_model is None else int(d_model)
    d_key = dm // num_heads if d_key is None else d_key
    d_value = d_key if d_value is None else d_value

    def proj(x, width, tag):
        # each projection gets its own ParamAttr copy (create_parameter
        # fills attr.name in place); a named layer names its parameters
        # so that programs built apart share them through the scope
        pa = copy.copy(param_attr) if param_attr is not None else None
        ba = copy.copy(bias_attr) if bias_attr is not None else None
        if pa is not None and pa.name is not None:
            pa.name = f"{pa.name}.{tag}"
        if ba is not None and ba.name is not None:
            ba.name = f"{ba.name}.{tag}"
        if name is not None:
            pa = pa if pa is not None else ParamAttr(name=f"{name}_{tag}_w")
            if ba is None:
                ba = ParamAttr(name=f"{name}_{tag}_b")
        return L.fc(x, size=width, num_flatten_dims=2, param_attr=pa,
                    bias_attr=ba, name=None if name is None else f"{name}_{tag}")

    q = proj(queries, num_heads * d_key, "q")
    k = proj(keys, num_heads * d_key, "k")
    v = proj(values, num_heads * d_value, "v")

    qr = L.reshape(q, [0, 0, num_heads, d_key])
    kr = L.reshape(k, [0, 0, num_heads, d_key])
    vr = L.reshape(v, [0, 0, num_heads, d_value])
    if kv_out is not None:
        kv_out.append((kr, vr))

    ctx = fused_attention(qr, kr, vr, causal=causal, sp_mode=sp_mode,
                          name=name)
    merged = L.reshape(ctx, [0, 0, num_heads * d_value])
    return proj(merged, dm, "out")

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
