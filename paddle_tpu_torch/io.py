"""Weights across the two packages, and the decode bundle.

``params_from_numpy`` and ``scope_from_numpy`` take the JAX package's
state as numpy arrays by name: the parameters of a model, or the whole
persistable state of a trained program (parameters and optimizer
accumulators) as a port ``Scope``.

The decode bundle is the counterpart of ``paddle_tpu/io.py``
``export_decode_model``. The JAX
bundle holds StableHLO executables, which PyTorch cannot load; the port's
bundle holds what builds the model instead: ``serving.json`` with the
same ``decode`` section and prefill bucket specs (plus a ``format`` tag
and no executable files), and one ``<name>.npy`` per parameter, as the
JAX package's ``save_vars`` writes them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.scope import Scope
from .core.types import (device_dtype, normalize_dtype, resolve_device,
                         torch_dtype)
from .models.transformer import CONFIG_KEYS, TransformerLM, param_shapes
from .serving.batcher import env_int

__all__ = ["FORMAT", "params_from_numpy", "scope_from_numpy",
           "export_decode_model", "load_decode_bundle"]

#: format tag of a port decode bundle's serving.json
FORMAT = "paddle_tpu_torch.decode/1"


def params_from_numpy(arrays: Mapping[str, np.ndarray],
                      model_cfg: Dict) -> Dict[str, torch.Tensor]:
    """{JAX parameter name: array} -> {name: float32 CPU tensor}, checked
    against the configuration: a missing name, an extra name or a wrong
    shape raises ValueError."""
    want = param_shapes(model_cfg)
    missing = sorted(set(want) - set(arrays))
    extra = sorted(set(arrays) - set(want))
    if missing or extra:
        raise ValueError(f"parameters do not match the model: missing "
                         f"{missing}, extra {extra}")
    out = {}
    for name, shape in want.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != shape:
            raise ValueError(f"parameter {name!r} has shape {a.shape}, the "
                             f"model wants {shape}")
        a = np.ascontiguousarray(a, dtype=np.float32)
        out[name] = torch.from_numpy(a if a.flags.writeable else a.copy())
    return out


def scope_from_numpy(arrays: Mapping[str, np.ndarray], device=None
                     ) -> Scope:
    """{var name: array} -> a Scope of tensors on `device` (the first CUDA
    device by default), each in its device dtype (64-bit narrowed). Feed
    it the JAX scope's persistable vars to start both packages from one
    state."""
    device = resolve_device(device)
    scope = Scope()
    for name, a in arrays.items():
        a = np.array(a, copy=True)
        scope.set_var(name, torch.from_numpy(a).to(
            device=device, dtype=torch_dtype(normalize_dtype(a.dtype))))
    return scope


def export_decode_model(dirname: str, model_cfg: Dict, *,
                        params: Mapping[str, np.ndarray],
                        length_buckets: Sequence[int] = (64, 128),
                        slots: Optional[int] = None,
                        block_size: Optional[int] = None,
                        pool_blocks: Optional[int] = None,
                        prefill_batch_size: int = 1,
                        eos_id: Optional[int] = None) -> str:
    """Write the decode bundle for a transformer_lm configuration.

    model_cfg: vocab_size, n_layers, d_model, n_heads, d_ff, max_context.
    params: {JAX parameter name: array} (checked by params_from_numpy).
    slots / block_size / pool_blocks default from PT_DECODE_MAX_SLOTS /
    PT_DECODE_BLOCK_SIZE / PT_DECODE_POOL_BLOCKS (8 / 16 / 64), as in the
    JAX package. Block 0 of the pool is the reserved null block."""
    slots = slots or env_int("PT_DECODE_MAX_SLOTS", 8)
    block_size = block_size or env_int("PT_DECODE_BLOCK_SIZE", 16)
    pool_blocks = pool_blocks or env_int("PT_DECODE_POOL_BLOCKS", 64)
    cfg = {k: int(model_cfg[k]) for k in CONFIG_KEYS}
    vocab, n_layers, d_model, n_heads = (cfg["vocab_size"], cfg["n_layers"],
                                         cfg["d_model"], cfg["n_heads"])
    max_context = cfg["max_context"]
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by n_heads "
                         f"{n_heads}")
    head_dim = d_model // n_heads
    buckets = sorted(int(b) for b in length_buckets)
    if not buckets or buckets[-1] > max_context:
        raise ValueError(f"length_buckets {buckets} must be non-empty and "
                         f"bounded by max_context {max_context}")
    if pool_blocks < 2:
        raise ValueError("pool_blocks must be >= 2 (block 0 is the "
                         "reserved null block)")
    tensors = params_from_numpy(params, cfg)
    max_blocks_per_seq = -(-max_context // block_size)
    ids_dt = device_dtype("int64")
    i32 = "int32"

    os.makedirs(dirname, exist_ok=True)
    for name, t in tensors.items():
        np.save(os.path.join(dirname, f"{name}.npy"), t.numpy())

    B = prefill_batch_size
    kv_roles = [(f"k_{i}", f"v_{i}") for i in range(n_layers)]
    fetch_roles = ["logits"] + [n for pair in kv_roles for n in pair]
    buckets_meta = []
    for bound in buckets:
        fetches = [{"name": "logits", "shape": [B, bound, vocab],
                    "dtype": "float32", "batch_major": True}]
        fetches += [{"name": n, "shape": [B, bound, n_heads, head_dim],
                     "dtype": "float32", "batch_major": True}
                    for pair in kv_roles for n in pair]
        buckets_meta.append({
            "length": bound,
            "feeds": [{"name": "src_ids", "shape": [B, bound],
                       "dtype": ids_dt, "batch_major": True}],
            "fetches": fetches})
    pool_shape = [pool_blocks, block_size, n_heads, head_dim]
    dec_feeds = [{"name": "token_ids", "shape": [slots], "dtype": ids_dt},
                 {"name": "context_lens", "shape": [slots], "dtype": i32},
                 {"name": "block_tables",
                  "shape": [slots, max_blocks_per_seq], "dtype": i32}]
    dec_fetches = [{"name": "logits", "shape": [slots, vocab],
                    "dtype": "float32"}]
    for i in range(n_layers):
        dec_feeds += [{"name": f"{kv}_cache_{i}", "shape": pool_shape,
                       "dtype": "float32"} for kv in ("k", "v")]
        dec_fetches += [{"name": f"{kv}_cache_out_{i}", "shape": pool_shape,
                         "dtype": "float32"} for kv in ("k", "v")]
    base = buckets_meta[-1]
    meta = {
        "format": FORMAT,
        "feeds": base["feeds"], "fetch_names": fetch_roles,
        "fetches": base["fetches"], "batch_size": B,
        "buckets": buckets_meta, "var_dims": {"src_ids": [1]},
        "decode": {
            "feeds": dec_feeds, "fetches": dec_fetches,
            "slots": slots, "block_size": block_size,
            "pool_blocks": pool_blocks,
            "max_blocks_per_seq": max_blocks_per_seq,
            "max_context": max_context, "n_layers": n_layers,
            "n_heads": n_heads, "head_dim": head_dim,
            "vocab_size": vocab, "eos_id": eos_id,
            "prefill_roles": {"logits": "logits",
                              "kv": [list(p) for p in kv_roles]},
            "model_cfg": cfg,
        },
    }
    with open(os.path.join(dirname, "serving.json"), "w") as f:
        json.dump(meta, f)
    return dirname


def load_decode_bundle(dirname: str, device=None
                       ) -> Tuple[dict, TransformerLM]:
    """(serving.json metadata, TransformerLM with the bundle's weights on
    `device`, the first CUDA device by default)."""
    device = resolve_device(device)
    with open(os.path.join(dirname, "serving.json")) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{dirname} is not a {FORMAT} bundle (format "
                         f"{meta.get('format')!r}); export it with "
                         "paddle_tpu_torch.io.export_decode_model")
    cfg = meta["decode"]["model_cfg"]
    arrays = {name: np.load(os.path.join(dirname, f"{name}.npy"))
              for name in param_shapes(cfg)}
    model = TransformerLM.from_config(cfg, device=device)
    model.load_jax_params(params_from_numpy(arrays, cfg))
    return meta, model.eval()
