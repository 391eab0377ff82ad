"""paddle_tpu_torch.serving.decode — autoregressive generation: paged KV
cache + continuous batching, on the port's model and kernels.

Counterpart of ``paddle_tpu.serving.decode``:

    DecodeEngine            facade: admission + scheduler + metrics
      ├── DecodeModel       one bundle (io.export_decode_model):
      │                     length-bucketed prefill programs through
      │                     ModelVersion (the flash kernel), one
      │                     fixed-shape decode step of TransformerLM (the
      │                     paged kernel) over KV pools updated in place
      ├── DecodeScheduler   continuous batching, eviction, shedding
      ├── KVBlockPool       host accounting for the paged device pool
      ├── PrefixIndex       copy-on-write prefix sharing
      └── drafters          speculative decoding through idle slots

The host side (scheduler, pool accounting, prefix index, drafters) is a
copy of the JAX package's; only the device side differs.
"""

from __future__ import annotations

from .engine import DecodeEngine, DecodeModel
from .kv_cache import KVBlockPool, PoolExhausted, blocks_for_tokens
from .prefix import PrefixIndex
from .scheduler import DecodeScheduler, GenerationHandle, Sequence
from .spec import NGramDrafter, PrefillDrafter, accept_greedy

__all__ = ["DecodeEngine", "DecodeModel", "DecodeScheduler",
           "GenerationHandle", "Sequence", "KVBlockPool", "PoolExhausted",
           "blocks_for_tokens", "PrefixIndex", "NGramDrafter",
           "PrefillDrafter", "accept_greedy"]
