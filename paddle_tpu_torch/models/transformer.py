"""Decoder-only Transformer LM: the program builders and the module.

Counterpart of ``paddle_tpu/models/transformer.py``: pre-LN blocks
x + MHA(LN(x)), x + FFN(LN(x)), learned positional embeddings, an
untied lm head. Parameters carry the JAX package's names (``tok_emb``,
``pos_emb``, ``attn{i}_*``, ``ffn{i}_{in,out}_{w,b}``,
``ln{1,2}_{i}_{scale,bias}``, ``ln_f_*``, ``lm_head_*``) in its layouts,
so one set of weights runs in both packages and in both forms here.

* ``transformer_lm`` / ``transformer_lm_loss`` build the program the
  Executor trains (``paddle_tpu_torch.Executor``), as the JAX package's
  builders do.
* ``TransformerLM`` is the serving module. ``forward`` is
  ``transformer_lm`` with ``pos_table_len=max_context`` that also
  returns each layer's K/V: the prefill. ``decode_step`` is
  ``transformer_decode_step``: one token per slot against the paged
  pools, which it updates in place.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..initializer import NormalInitializer
from ..layers import io as L_io
from ..layers import nn as L
from ..layers import tensor as L_tensor
from ..layers.attention import MultiHeadAttention, multi_head_attention
from ..ops import nn_ops
from ..param_attr import ParamAttr

__all__ = ["transformer_lm", "transformer_lm_loss", "TransformerLM",
           "param_shapes", "CONFIG_KEYS"]

#: the keys of a model configuration (``TransformerLM`` arguments)
CONFIG_KEYS = ("vocab_size", "n_layers", "d_model", "n_heads", "d_ff",
               "max_context")


def param_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """{JAX parameter name: shape} of a transformer_lm configuration."""
    v, d, f = int(cfg["vocab_size"]), int(cfg["d_model"]), int(cfg["d_ff"])
    out = {"tok_emb": (v, d), "pos_emb": (int(cfg["max_context"]), d)}
    for i in range(int(cfg["n_layers"])):
        for ln in (f"ln1_{i}", f"ln2_{i}"):
            out[f"{ln}_scale"], out[f"{ln}_bias"] = (d,), (d,)
        for tag in ("q", "k", "v", "out"):
            out[f"attn{i}_{tag}_w"], out[f"attn{i}_{tag}_b"] = (d, d), (d,)
        out[f"ffn{i}_in_w"], out[f"ffn{i}_in_b"] = (d, f), (f,)
        out[f"ffn{i}_out_w"], out[f"ffn{i}_out_b"] = (f, d), (d,)
    out["ln_f_scale"], out["ln_f_bias"] = (d,), (d,)
    out["lm_head_w"], out["lm_head_b"] = (d, v), (v,)
    return out


# ---------------------------------------------------------------------------
# program builders
# ---------------------------------------------------------------------------

def _ffn(x, d_model, d_ff, idx):
    h = L.fc(x, size=d_ff, num_flatten_dims=2, act="gelu",
             param_attr=ParamAttr(name=f"ffn{idx}_in_w"),
             bias_attr=ParamAttr(name=f"ffn{idx}_in_b"), name=f"ffn{idx}_in")
    return L.fc(h, size=d_model, num_flatten_dims=2,
                param_attr=ParamAttr(name=f"ffn{idx}_out_w"),
                bias_attr=ParamAttr(name=f"ffn{idx}_out_b"),
                name=f"ffn{idx}_out")


def transformer_lm(src_ids, vocab_size, n_layers=2, d_model=128, n_heads=4,
                   d_ff=512, max_len=2048, dropout_rate=0.0,
                   causal=True, sp_mode="none", tp_shard=False,
                   remat=False, pos_table_len=None):
    """src_ids: [B, S] int64 var. Returns logits [B, S, vocab_size].

    pos_table_len: rows of the ``pos_emb`` parameter (default: S), the
    first S used. dropout, remat, tp_shard and sp_mode other than "none"
    are not ported and raise. The JAX builder's collect_kv is not taken:
    the serving module returns each layer's K/V itself."""
    if dropout_rate:
        raise NotImplementedError(f"transformer_lm(dropout_rate="
                                  f"{dropout_rate}): dropout is not ported")
    if remat:
        raise NotImplementedError(f"transformer_lm(remat={remat!r}): "
                                  "activation recomputation is not ported")
    seq_len = int(src_ids.shape[1])
    if seq_len > max_len:
        raise ValueError(f"sequence length {seq_len} exceeds max_len "
                         f"{max_len}; raise max_len")
    pos_rows = seq_len if pos_table_len is None else int(pos_table_len)
    if seq_len > pos_rows:
        raise ValueError(f"sequence length {seq_len} exceeds the "
                         f"pos_table_len {pos_rows} rows of pos_emb")
    emb = L.embedding(src_ids, [vocab_size, d_model],
                      param_attr=ParamAttr(
                          name="tok_emb",
                          initializer=NormalInitializer(scale=0.02)))
    pos = L_tensor.create_parameter([pos_rows, d_model], dtype="float32",
                                    name="pos_emb",
                                    default_initializer=NormalInitializer(
                                        scale=0.02))
    if pos_rows != seq_len:
        pos = L.slice(pos, axes=[0], starts=[0], ends=[seq_len])
    x = L.elementwise_add(emb, pos)
    for i in range(n_layers):
        ln1 = L.layer_norm(x, begin_norm_axis=2, name=f"ln1_{i}",
                           param_attr=ParamAttr(name=f"ln1_{i}_scale"),
                           bias_attr=ParamAttr(name=f"ln1_{i}_bias"))
        att = multi_head_attention(ln1, num_heads=n_heads, causal=causal,
                                   sp_mode=sp_mode, tp_shard=tp_shard,
                                   name=f"attn{i}")
        x = L.elementwise_add(x, att)
        ln2 = L.layer_norm(x, begin_norm_axis=2, name=f"ln2_{i}",
                           param_attr=ParamAttr(name=f"ln2_{i}_scale"),
                           bias_attr=ParamAttr(name=f"ln2_{i}_bias"))
        x = L.elementwise_add(x, _ffn(ln2, d_model, d_ff, i))
    x = L.layer_norm(x, begin_norm_axis=2, name="ln_f",
                     param_attr=ParamAttr(name="ln_f_scale"),
                     bias_attr=ParamAttr(name="ln_f_bias"))
    return L.fc(x, size=vocab_size, num_flatten_dims=2,
                param_attr=ParamAttr(name="lm_head_w"),
                bias_attr=ParamAttr(name="lm_head_b"), name="lm_head")


def transformer_lm_loss(vocab_size=1000, seq_len=128, **kw):
    """Build the data vars and the LM loss. Returns (avg_cost, logits)."""
    src = L_io.data("src_ids", [seq_len], dtype="int64")
    tgt = L_io.data("tgt_ids", [seq_len, 1], dtype="int64")
    logits = transformer_lm(src, vocab_size, **kw)
    loss = L.softmax_with_cross_entropy(logits, tgt)
    return L.mean(loss), logits


# ---------------------------------------------------------------------------
# the serving module
# ---------------------------------------------------------------------------

def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class _Block(nn.Module):
    """One pre-LN layer; parameter attributes are the JAX names."""

    def __init__(self, i: int, d_model: int, n_heads: int, d_ff: int,
                 device, dtype):
        super().__init__()
        self.i = i
        for ln in (f"ln1_{i}", f"ln2_{i}"):
            self.register_parameter(f"{ln}_scale",
                                    _param((d_model,), device, dtype))
            self.register_parameter(f"{ln}_bias",
                                    _param((d_model,), device, dtype))
        self.attn = MultiHeadAttention(d_model, n_heads, f"attn{i}",
                                       device=device, dtype=dtype)
        for tag, shape_w, width in (("in", (d_model, d_ff), d_ff),
                                    ("out", (d_ff, d_model), d_model)):
            self.register_parameter(f"ffn{i}_{tag}_w",
                                    _param(shape_w, device, dtype))
            self.register_parameter(f"ffn{i}_{tag}_b",
                                    _param((width,), device, dtype))

    def _p(self, name: str) -> torch.Tensor:
        return getattr(self, name.format(i=self.i))

    def ln(self, x, which: str):
        return nn_ops.layer_norm(x, self._p(f"{which}_{{i}}_scale"),
                                 self._p(f"{which}_{{i}}_bias"),
                                 begin_norm_axis=2)

    def ffn(self, x):
        h = nn_ops.fc(x, self._p("ffn{i}_in_w"), self._p("ffn{i}_in_b"),
                      act="gelu")
        return nn_ops.fc(h, self._p("ffn{i}_out_w"), self._p("ffn{i}_out_b"))


class TransformerLM(nn.Module):
    """transformer_lm with pos_table_len = max_context."""

    def __init__(self, vocab_size: int, n_layers: int, d_model: int,
                 n_heads: int, d_ff: int, max_context: int, *, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = dict(vocab_size=vocab_size, n_layers=n_layers,
                        d_model=d_model, n_heads=n_heads, d_ff=d_ff,
                        max_context=max_context)
        self.tok_emb = _param((vocab_size, d_model), device, dtype)
        self.pos_emb = _param((max_context, d_model), device, dtype)
        self.blocks = nn.ModuleList(
            _Block(i, d_model, n_heads, d_ff, device, dtype)
            for i in range(n_layers))
        self.ln_f_scale = _param((d_model,), device, dtype)
        self.ln_f_bias = _param((d_model,), device, dtype)
        self.lm_head_w = _param((d_model, vocab_size), device, dtype)
        self.lm_head_b = _param((vocab_size,), device, dtype)

    @classmethod
    def from_config(cls, cfg: Dict, **kw) -> "TransformerLM":
        return cls(**{k: int(cfg[k]) for k in CONFIG_KEYS}, **kw)

    # -- weights by JAX name -------------------------------------------------
    def jax_named_parameters(self) -> Dict[str, nn.Parameter]:
        """{JAX parameter name: parameter}: the last component of each
        module path is the name the JAX program gives the parameter."""
        return {n.rsplit(".", 1)[-1]: p for n, p in self.named_parameters()}

    @torch.no_grad()
    def load_jax_params(self, tensors: Dict[str, torch.Tensor]) -> None:
        """Copy {JAX name: tensor} into the parameters (validated by
        io.params_from_numpy)."""
        own = self.jax_named_parameters()
        if set(own) != set(tensors):
            raise ValueError(f"parameter names differ: missing "
                             f"{sorted(set(own) - set(tensors))}, extra "
                             f"{sorted(set(tensors) - set(own))}")
        for name, p in own.items():
            p.copy_(tensors[name])

    def _head(self, x):
        x = nn_ops.layer_norm(x, self.ln_f_scale, self.ln_f_bias,
                              begin_norm_axis=2)
        return nn_ops.fc(x, self.lm_head_w, self.lm_head_b)

    # -- prefill -------------------------------------------------------------
    def forward(self, src_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor,
                                                    torch.Tensor]]]:
        """src_ids [B, S] -> (logits [B, S, vocab], [(k, v) [B, S, H, D]]
        per layer)."""
        seq_len = src_ids.shape[1]
        if seq_len > self.pos_emb.shape[0]:
            raise ValueError(f"sequence length {seq_len} exceeds the "
                             f"{self.pos_emb.shape[0]} rows of pos_emb")
        x = nn_ops.lookup_table(src_ids, self.tok_emb) + self.pos_emb[:seq_len]
        kvs = []
        for blk in self.blocks:
            att, kv = blk.attn(blk.ln(x, "ln1"))
            kvs.append(kv)
            x = x + att
            x = x + blk.ffn(blk.ln(x, "ln2"))
        return self._head(x), kvs

    # -- one decode step -----------------------------------------------------
    def decode_step(self, token_ids: torch.Tensor,
                    context_lens: torch.Tensor, block_tables: torch.Tensor,
                    pools: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                    ) -> torch.Tensor:
        """token_ids [slots], context_lens [slots] int32 (span INCLUDING
        the new token; 0 = inactive slot), block_tables [slots, MB] int32,
        pools [(k_pool, v_pool)] per layer, each [NB, BS, H, D] and
        updated IN PLACE. Returns logits [slots, vocab]."""
        slots = token_ids.shape[0]
        emb = nn_ops.lookup_table(token_ids, self.tok_emb)[:, None]
        # the new token sits at position context_len-1; inactive slots (len
        # 0) clamp to row 0 — their rows only ever land in the null block
        pos_ids = torch.clamp(context_lens - 1, min=0)
        x = emb + nn_ops.gather(self.pos_emb, pos_ids)[:, None]
        for blk, (k_pool, v_pool) in zip(self.blocks, pools):
            x = x + blk.attn.decode(blk.ln(x, "ln1"), k_pool, v_pool,
                                    block_tables, context_lens)
            x = x + blk.ffn(blk.ln(x, "ln2"))
        return self._head(x).reshape(slots, -1)
