"""Paged KV-cache management: fixed-size blocks in a preallocated pool.

The device side is dumb on purpose — per layer, one K and one V array of
shape [pool_blocks, block_size, n_heads, head_dim] that the decode-step
artifact reads and writes through per-slot block tables. Everything
smart lives HERE, on the host: which blocks belong to which sequence,
what is free, when a sequence must be evicted because the pool is under
pressure, and the accounting an operator needs to size the pool
(utilization, high-water mark, eviction counts live in DecodeMetrics).

Block id 0 is the reserved NULL block: inactive decode slots point every
block-table entry at it, so their (masked, never-read) writes land
somewhere harmless. The allocator therefore never hands out block 0, and
usable capacity is (pool_blocks - 1) * block_size cached tokens.

Invariant the no-stale-leak test rides on: a sequence only ever reads
pool positions it has itself written — prefill writes rows [0, len) of
its blocks, each decode step writes exactly position context_len-1, and
attention is masked to [0, context_len). A freed block's stale contents
are unreachable from any later owner because the new owner rewrites
every position below its own mask before reading it.

Prefix sharing (serving/decode/prefix.py) extends the invariant with
per-block REFCOUNTS: a block holding the K/V of a token prefix may back
several owners at once — N sequences whose prompts share the prefix,
plus the prefix index's own cache reference. `alloc` hands a block out
at refcount 1, `share` adds an owner, `free` only RETURNS the block to
the free list when the last owner lets go. Aliasing preserves the
no-stale-leak reading because causal K/V rows are a pure function of
the token prefix — an aliased row IS the row the new owner's own
prefill would have written, byte for byte. A write into a shared block
is never allowed: the scheduler copies-on-write into a fresh block
first (DecodeModel.copy_block), so a shared block's contents are frozen
for as long as anyone else can read them.

Copied from ``paddle_tpu/serving/decode/kv_cache.py``; the port carries
its own copy because it never imports the JAX package. Only
``write_prefill_pages`` differs: it writes the torch pool in place.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence

import numpy as np
import torch

__all__ = ["PoolExhausted", "KVBlockPool", "blocks_for_tokens",
           "write_prefill_pages", "block_table_row"]


class PoolExhausted(Exception):
    """Internal allocator signal; the scheduler translates pool pressure
    into eviction or a typed admission error (Overloaded)."""


def blocks_for_tokens(tokens: int, block_size: int) -> int:
    return -(-max(int(tokens), 0) // block_size)


class KVBlockPool:
    """Host-side free-list accounting for the device block pool.

    Lowest-id-first allocation (a heap) keeps layouts deterministic —
    tests assert exact block ids — and makes `defrag` meaningful: after
    churn, live blocks can be compacted back down to the low ids so the
    high tail of the pool is contiguous free space (useful for shrinking
    a pool between load phases; the device remap is the caller's job,
    `DecodeEngine.defrag`).
    """

    def __init__(self, pool_blocks: int, block_size: int):
        if pool_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (0 is the null block)")
        self.pool_blocks = int(pool_blocks)
        self.block_size = int(block_size)
        self._free: List[int] = list(range(1, pool_blocks))
        heapq.heapify(self._free)
        #: block id -> owner count; a block is live while its count > 0
        self._ref: Dict[int, int] = {}
        self.high_water = 0

    # -- accounting ----------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Allocatable blocks (the null block excluded)."""
        return self.pool_blocks - 1

    @property
    def blocks_in_use(self) -> int:
        return len(self._ref)

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_shared(self) -> int:
        """Blocks with more than one live owner (the aliasing win)."""
        return sum(1 for n in self._ref.values() if n > 1)

    def utilization(self) -> float:
        return self.blocks_in_use / max(self.capacity, 1)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def blocks_for_tokens(self, tokens: int) -> int:
        return blocks_for_tokens(tokens, self.block_size)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    # -- alloc/free ----------------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free "
                f"({self.blocks_in_use}/{self.capacity} in use)")
        out = [heapq.heappop(self._free) for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        self.high_water = max(self.high_water, self.blocks_in_use)
        return out

    def share(self, ids: Sequence[int]) -> None:
        """Add one owner to each live block — aliasing a resident prefix
        into another sequence's block table. Only live blocks can gain
        owners; sharing a free block would resurrect stale contents."""
        for b in ids:
            if b == 0 or b not in self._ref:
                raise ValueError(f"sharing block {b} not allocated")
        for b in ids:
            self._ref[b] += 1

    def free(self, ids: Sequence[int]) -> None:
        """Drop one owner per block; a block returns to the free list
        only when its LAST owner lets go."""
        for b in ids:
            if b == 0 or b not in self._ref:
                raise ValueError(f"freeing block {b} not allocated")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                heapq.heappush(self._free, b)

    # -- defrag --------------------------------------------------------------
    def defrag(self) -> Dict[int, int]:
        """Compact live blocks onto the lowest ids. Returns the {old: new}
        mapping for every MOVED block (identity entries omitted); the
        caller must remap its block tables — including the prefix
        index's (PrefixIndex.remap) — and permute the device pools
        accordingly before the next step. Shared blocks MOVE like any
        other live block (every owner sees the same remap); refcounts
        ride along with the id."""
        live = sorted(self._ref)
        mapping: Dict[int, int] = {}
        target = 1
        for b in live:
            if b != target:
                mapping[b] = target
            target += 1
        if mapping:
            self._ref = {mapping.get(b, b): n for b, n in self._ref.items()}
            self._free = list(range(target, self.pool_blocks))
            heapq.heapify(self._free)
        return mapping


def write_prefill_pages(pool, block_ids: Sequence[int], rows,
                        block_size: int):
    """Scatter a sequence's prefill K or V rows ([written, H, D] tensor)
    into its freshly allocated blocks of the device pool, IN PLACE (the
    JAX version returns a new array). Returns the same pool."""
    n = len(block_ids)
    written = rows.shape[0]
    pad = n * block_size - written
    if pad < 0:
        raise ValueError(f"{written} rows exceed {n} blocks x {block_size}")
    pages = torch.zeros((n * block_size,) + tuple(rows.shape[1:]),
                        dtype=pool.dtype, device=pool.device)
    pages[:written] = rows
    idx = torch.as_tensor(list(block_ids), dtype=torch.long,
                          device=pool.device)
    pool.index_copy_(0, idx, pages.reshape((n, block_size) + pages.shape[1:]))
    return pool


def block_table_row(blocks: Sequence[int], width: int) -> np.ndarray:
    """A sequence's block list padded with the null block to table width."""
    row = np.zeros(width, np.int32)
    row[:len(blocks)] = blocks
    return row
