"""DecodeEngine: the generation facade over one exported decode bundle.

Counterpart of ``paddle_tpu/serving/decode/engine.py``. DecodeModel owns
the device side — the TransformerLM, whose prefill is served through the
port's ModelVersion (same bucket selection, padding, scatter) and whose
decode step runs the paged kernels, plus the device-resident KV pools,
which never round-trip through host numpy. DecodeScheduler owns the
host side — slots, block accounting, admission, eviction. DecodeEngine
wires them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..admission import AdmissionController, InvalidRequest, Overloaded
from ..batcher import env_float, env_int
from ..metrics import DecodeMetrics
from ..registry import ModelVersion
from ...core.types import resolve_device
from .kv_cache import (KVBlockPool, blocks_for_tokens, write_prefill_pages)
from .prefix import PrefixIndex
from .scheduler import DecodeScheduler, GenerationHandle
from .spec import resolve_drafter

__all__ = ["DecodeModel", "DecodeEngine"]


class DecodeModel:
    """One loaded decode bundle (io.export_decode_model dir) on one device.

    Unlike the JAX version, whose step returns new pool arrays that the
    next step is fed, the KV pools here are resident tensors UPDATED IN
    PLACE: the decode step writes each slot's new row into them, prefill
    seeding writes a sequence's pages into them, and copy_block /
    permute_blocks move blocks inside them. Every tensor is created on
    `self.device`, so the scheduler thread that calls these methods
    drives that device whatever its own current device is."""

    def __init__(self, model_dir: str, *, device=None, warmup: bool = True):
        with open(os.path.join(model_dir, "serving.json")) as f:
            meta = json.load(f)
        dec = meta.get("decode")
        if not dec:
            raise ValueError(
                f"{model_dir} has no decode section in serving.json — "
                "export with paddle_tpu_torch.io.export_decode_model")
        self.model_dir = model_dir
        self.device = resolve_device(device)
        self.prefill_model = ModelVersion.load(model_dir, device=self.device,
                                               warmup=warmup)
        self.model = self.prefill_model.model
        self.slots = int(dec["slots"])
        self.block_size = int(dec["block_size"])
        self.pool_blocks = int(dec["pool_blocks"])
        self.max_blocks_per_seq = int(dec["max_blocks_per_seq"])
        self.max_context = int(dec["max_context"])
        self.n_layers = int(dec["n_layers"])
        self.vocab_size = int(dec["vocab_size"])
        self.eos_id = dec.get("eos_id")
        self.max_prompt_len = self.prefill_model.bounds[-1]
        self._feed_meta = dec["feeds"]
        roles = dec["prefill_roles"]
        self._logits_role = roles["logits"]
        self._kv_roles = [tuple(p) for p in roles["kv"]]
        self.reset_pools()
        if warmup:
            self._warmup_decode()

    # -- device pools --------------------------------------------------------
    def reset_pools(self) -> None:
        shape = tuple(self._feed_meta[3]["shape"])
        self._pools: List[torch.Tensor] = [
            torch.zeros(shape, dtype=torch.float32, device=self.device)
            for _ in range(2 * self.n_layers)]

    def _warmup_decode(self) -> None:
        """One all-inactive step before the first real sequence. The pools
        are updated in place, so its writes are not discarded as in the
        JAX version: every slot writes row 0 of the null block 0, which no
        live sequence's mask ever reaches."""
        self.decode_step(np.zeros(self.slots, np.int64),
                         np.zeros(self.slots, np.int32),
                         np.zeros((self.slots, self.max_blocks_per_seq),
                                  np.int32))

    # -- prefill -------------------------------------------------------------
    def prefill(self, token_ids: Sequence[int]):
        """Run the prompt (or a resumed prompt+generated prefix) through
        its length bucket, padded with zeros. Returns (last-position
        logits [vocab] numpy, [(k_rows, v_rows)] device tensors per layer
        at the TRUE length)."""
        n = len(token_ids)
        dt = self.prefill_model.feed_dtypes()["src_ids"]
        ex = {"src_ids": np.asarray(token_ids, dtype=dt)}
        bucket = self.prefill_model.bucket_of(ex)
        results, _ = self.prefill_model.execute_batch(bucket, [ex])
        out = results[0]
        logits = out[self._logits_role][n - 1].cpu().numpy()
        kv = [(out[k][:n], out[v][:n]) for k, v in self._kv_roles]
        return logits, kv

    @torch.inference_mode()
    def seed_sequence(self, block_ids: Sequence[int], kv_rows,
                      skip_rows: int = 0) -> None:
        """Write one sequence's prefill K/V rows into its blocks.
        `skip_rows` rows at the front are already resident (aliased
        shared-prefix blocks, kv_cache.py refcounts) and MUST NOT be
        rewritten — only the tail past the shared prefix is written,
        into the tail blocks. A non-block-aligned skip means the whole
        prompt was matched (partial-tail alias), so nothing is written
        at all."""
        skip = int(skip_rows)
        nb = skip // self.block_size
        for i, (k_rows, v_rows) in enumerate(kv_rows):
            if k_rows.shape[0] <= skip:
                continue   # fully aliased: every row already resident
            if skip % self.block_size:
                raise ValueError(
                    f"skip_rows {skip} neither block-aligned nor the "
                    f"full prefill ({k_rows.shape[0]} rows)")
            write_prefill_pages(self._pools[2 * i], block_ids[nb:],
                                k_rows[skip:], self.block_size)
            write_prefill_pages(self._pools[2 * i + 1], block_ids[nb:],
                                v_rows[skip:], self.block_size)

    # -- the decode step -----------------------------------------------------
    @torch.inference_mode()
    def decode_step(self, token_ids: np.ndarray, context_lens: np.ndarray,
                    block_tables: np.ndarray) -> np.ndarray:
        """One fixed-shape step over all slots; writes each slot's new K/V
        row into the resident pools and returns logits [slots, vocab].
        Every slot's row is written before any slot attends, so the slots
        of one speculative chain (scheduler slot packing) see each other's
        rows."""
        metas = self._feed_meta

        def feed(a, meta):
            return torch.from_numpy(np.ascontiguousarray(
                a, dtype=np.dtype(meta["dtype"]))).to(self.device)

        pools = list(zip(self._pools[0::2], self._pools[1::2]))
        logits = self.model.decode_step(feed(token_ids, metas[0]),
                                        feed(context_lens, metas[1]),
                                        feed(block_tables, metas[2]), pools)
        return logits.cpu().numpy()

    @torch.inference_mode()
    def permute_blocks(self, mapping: Dict[int, int]) -> None:
        """Apply a kv_cache defrag mapping to the device pools: block
        old -> new for every moved block. Defrag maps overlap (a block
        can be both a source and a destination), so every source is
        read into a copy before any destination is written."""
        if not mapping:
            return
        src = torch.as_tensor(list(mapping.keys()), dtype=torch.long,
                              device=self.device)
        dst = torch.as_tensor(list(mapping.values()), dtype=torch.long,
                              device=self.device)
        for p in self._pools:
            p.index_copy_(0, dst, p.index_select(0, src))

    @torch.inference_mode()
    def copy_block(self, src: int, dst: int) -> None:
        """Device-copy one pool block (every layer, K and V) — the
        copy-on-write primitive: a sequence about to write into a
        shared block gets its own copy first."""
        for p in self._pools:
            p[dst].copy_(p[src])

    def describe(self) -> dict:
        return {
            "model_dir": self.model_dir, "device": str(self.device),
            "slots": self.slots, "block_size": self.block_size,
            "pool_blocks": self.pool_blocks,
            "max_context": self.max_context,
            "max_prompt_len": self.max_prompt_len,
            "prefill_buckets": self.prefill_model.bounds,
            "n_layers": self.n_layers, "vocab_size": self.vocab_size,
            "eos_id": self.eos_id,
        }


class DecodeEngine:
    """Continuous-batching generation over one decode bundle.

    >>> eng = DecodeEngine("/models/lm_decode")
    >>> h = eng.generate([5, 17, 9], max_new_tokens=32)
    >>> for tok in h.stream(): ...
    >>> h.result()["tokens"]

    `device` is where a model loaded from `model_dir` runs: the first
    CUDA device unless the caller passes another (``device="cpu"`` runs
    the plain PyTorch path).

    Knobs (constructor args win; env supplies deployment defaults):
    PT_DECODE_MAX_NEW_TOKENS (default generation budget),
    PT_SERVE_QUEUE_DEPTH / PT_SERVE_DEADLINE_MS (admission — shared with
    the one-shot engine on purpose: one admission policy per process),
    PT_KV_SHARE (copy-on-write prefix sharing, decode/prefix.py),
    PT_SPEC_DRAFT / PT_SPEC_K (speculative decoding, decode/spec.py).
    """

    def __init__(self, model_dir: Optional[str] = None, *,
                 model: Optional[DecodeModel] = None,
                 device=None,
                 queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 max_new_tokens: Optional[int] = None,
                 continuous: bool = True,
                 pool_blocks: Optional[int] = None,
                 metrics: Optional[DecodeMetrics] = None,
                 kv_share: Optional[bool] = None,
                 drafter: Optional[str] = None,
                 spec_k: Optional[int] = None,
                 name: str = "model", warmup: bool = True):
        if model is None:
            if model_dir is None:
                raise ValueError("DecodeEngine needs model_dir or model")
            model = DecodeModel(model_dir, device=device, warmup=warmup)
        self.model = model
        self.name = name
        self.max_new_tokens = (
            env_int("PT_DECODE_MAX_NEW_TOKENS", 64)
            if max_new_tokens is None else int(max_new_tokens))
        # pool_blocks may RESTRICT accounting below the artifact's pool
        # (partitioning one exported pool across tenants; forcing
        # eviction pressure in tests) — never exceed the device shape
        self.pool = KVBlockPool(min(pool_blocks or model.pool_blocks,
                                    model.pool_blocks), model.block_size)
        self.admission = AdmissionController(
            queue_depth=(env_int("PT_SERVE_QUEUE_DEPTH", 256)
                         if queue_depth is None else int(queue_depth)),
            max_batch_size=1,
            default_deadline_ms=(env_float("PT_SERVE_DEADLINE_MS", 0.0)
                                 if deadline_ms is None
                                 else float(deadline_ms)))
        self.metrics = metrics or DecodeMetrics(name)
        # KV economics: both OFF unless asked for — the plain engine's
        # accounting (exact block ids, zero blocks at idle) is a tested
        # contract, and sharing retains blocks past sequence lifetime
        self.kv_share = (bool(env_int("PT_KV_SHARE", 0))
                         if kv_share is None else bool(kv_share))
        self.index = (PrefixIndex(self.pool) if self.kv_share else None)
        spec = (os.environ.get("PT_SPEC_DRAFT", "")
                if drafter is None else drafter)
        self.drafter = resolve_drafter(spec, model)
        self.spec_k = (env_int("PT_SPEC_K", 4)
                       if spec_k is None else int(spec_k))
        self.scheduler = DecodeScheduler(model, self.pool, self.admission,
                                         self.metrics,
                                         continuous=continuous, name=name,
                                         prefix_index=self.index,
                                         drafter=self.drafter,
                                         spec_k=self.spec_k)

    # -- the request path ----------------------------------------------------
    def generate(self, prompt_ids: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 deadline_ms: Optional[float] = None, priority: int = 0,
                 eos_id: Optional[int] = None) -> GenerationHandle:
        """Admit one prompt; returns a GenerationHandle (stream() /
        result()). Raises typed admission errors reject-fast."""
        prompt = [int(t) for t in prompt_ids]
        max_new = (self.max_new_tokens if max_new_tokens is None
                   else int(max_new_tokens))
        if not prompt:
            raise InvalidRequest("prompt_ids must be non-empty")
        if max_new < 1:
            raise InvalidRequest(f"max_new_tokens {max_new} < 1")
        if any(t < 0 or t >= self.model.vocab_size for t in prompt):
            raise InvalidRequest(
                f"prompt ids outside [0, {self.model.vocab_size})")
        if len(prompt) > self.model.max_prompt_len:
            raise InvalidRequest(
                f"prompt length {len(prompt)} exceeds the largest "
                f"prefill bucket {self.model.max_prompt_len}")
        if len(prompt) + max_new > self.model.max_context:
            raise InvalidRequest(
                f"prompt {len(prompt)} + max_new {max_new} exceeds "
                f"max_context {self.model.max_context}")
        # a sequence the pool can NEVER hold is pool exhaustion by
        # construction: shed typed at submit instead of deadlocking the
        # admit loop (peak residency is prompt+max_new-1 cached tokens)
        peak = blocks_for_tokens(len(prompt) + max_new - 1,
                                 self.model.block_size)
        if peak > self.pool.capacity:
            self.metrics.on_shed("overload")
            raise Overloaded(
                f"sequence needs {peak} KV blocks at peak but the pool "
                f"holds {self.pool.capacity} — raise "
                f"PT_DECODE_POOL_BLOCKS or lower max_new_tokens")
        return self.scheduler.submit(prompt, max_new,
                                     deadline_ms=deadline_ms,
                                     priority=priority, eos_id=eos_id)

    # -- maintenance ---------------------------------------------------------
    def defrag(self) -> int:
        """Compact live blocks onto the lowest pool ids (host accounting
        + device permute). Returns blocks moved. Runs under the
        scheduler lock with zero live sequences — submission blocks on
        the same lock, so no sequence can be admitted (no decode step
        can touch the pools) mid-permute; raises RuntimeError when the
        engine is not idle."""

        def _do():
            mapping = self.pool.defrag()
            self.model.permute_blocks(mapping)
            if self.index is not None:
                # cached prefixes MOVE with their blocks — the index's
                # chains stay valid across compaction
                self.index.remap(mapping)
            return len(mapping)

        return self.scheduler.while_idle(_do)

    def kv_residency(self) -> dict:
        """Shared-block residency, the session-affinity health signal:
        a session's cached prefix lives HERE, so the fleet router's
        rendezvous hash should keep its follow-ups here too."""
        out = {"kv_blocks_shared": self.pool.blocks_shared,
               "kv_blocks_in_use": self.pool.blocks_in_use,
               "kv_blocks_indexed": (self.index.blocks_indexed
                                     if self.index is not None else 0)}
        if self.index is not None:
            out.update(prefix_hits=self.index.hits,
                       prefix_hit_tokens=self.index.hit_tokens)
        return out

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()

    def describe(self) -> dict:
        out = self.model.describe()
        out["continuous"] = self.scheduler.continuous
        out["max_new_tokens_default"] = self.max_new_tokens
        out["kv_share"] = self.kv_share
        out["drafter"] = (getattr(self.drafter, "name", "custom")
                          if self.drafter is not None else None)
        out["spec_k"] = self.spec_k if self.drafter is not None else 0
        return out

    def shutdown(self, drain: bool = True) -> None:
        self.scheduler.close(drain=drain)
