"""Host-side prefix index: which resident KV blocks cache which token
prefixes, at block granularity.

The economics: every session against the same deployment repeats the
same system prompt, so the pool fills with N identical copies of the
same K/V rows. Causal K/V is a pure function of the token prefix — row
i depends only on tokens [0, i] — so those copies are bitwise
interchangeable, and ONE resident copy can back every sequence that
shares the prefix. The index maps hashed token-prefix chains to block
ids; admission consults it and aliases matched blocks into the new
sequence's block table (KVBlockPool.share) instead of rewriting them.

Structure: a trie of nodes, one per FULL block of cached tokens. Each
node keys its direct children by the child block's token tuple (the
root children live in `_root`), so the whole prefix up to and including
a block identifies it, built incrementally. A lookup walks the chain
from the root; the first miss ends the match. Two different prefixes
can never collide onto one node because the full token content is the
key, not a lossy digest — and both the full-block walk and the
partial-tail probe only ever touch ONE parent's children, so admission
cost scales with the prompt, not with everything indexed.

Partial-block tail matches: a prompt that ends INSIDE a cached block
(prompt tail is a proper prefix of the block's cached tokens) aliases
that block too — rows [0, tail) of it are exactly the rows this prompt
would have written, and attention masks the rest. That aliased block is
where copy-on-write earns its name: the sequence's FIRST decode write
lands inside it, so the scheduler copies the block out before writing
(scheduler._cow_for_write). A prompt that DIVERGES inside a block gets
no alias for that block — rows past the divergence point belong to a
different prefix.

Ownership: the index holds its own pool reference on every indexed
block (share on insert, free on release) — a cached prefix stays
resident after the sequence that wrote it finishes, which is the whole
point. Under pool pressure the scheduler releases index references
leaf-first in LRU order (`release_lru`) BEFORE evicting running
sequences: cache beats nothing, but live work beats cache.

Single-threaded on purpose: only the scheduler thread touches the
index (same ownership rule as scheduler._waiting/_running).

Copied from ``paddle_tpu/serving/decode/prefix.py``; the port
carries its own copy because it never imports the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixIndex"]


class _Node:
    __slots__ = ("key", "parent", "block", "tokens", "kids", "tick")

    def __init__(self, key, parent: Optional["_Node"], block: int,
                 tokens: Tuple[int, ...]):
        self.key = key
        self.parent = parent
        self.block = block
        self.tokens = tokens
        #: direct children keyed by their token tuple — the next-block
        #: lookup AND the partial-tail probe scan only this dict
        self.kids: Dict[Tuple[int, ...], "_Node"] = {}
        self.tick = 0


class PrefixIndex:
    """Block-granular prefix cache over one KVBlockPool."""

    def __init__(self, pool, block_size: Optional[int] = None):
        self.pool = pool
        self.block_size = int(block_size or pool.block_size)
        #: flat registry (for counting, LRU-leaf scans, defrag remap);
        #: lookups go through the per-node `kids` dicts instead
        self._nodes: Dict[tuple, _Node] = {}
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.released = 0

    # -- accounting ----------------------------------------------------------
    @property
    def blocks_indexed(self) -> int:
        return len(self._nodes)

    def stats(self) -> dict:
        return {"blocks_indexed": self.blocks_indexed, "hits": self.hits,
                "misses": self.misses, "hit_tokens": self.hit_tokens,
                "released": self.released}

    def _key(self, parent: Optional[_Node], tokens: Tuple[int, ...]):
        return (id(parent) if parent is not None else None, tokens)

    def _kids(self, parent: Optional[_Node]) -> Dict[Tuple[int, ...],
                                                     _Node]:
        return parent.kids if parent is not None else self._root

    # -- lookup --------------------------------------------------------------
    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest resident prefix of `tokens`: (block ids, matched token
        count). Full blocks match whole; the final block may match
        PARTIALLY — only when the remaining prompt tail is a proper
        prefix of its cached tokens, so matched == len(tokens) and the
        caller's first decode write (position matched) lands inside the
        aliased block (the CoW case). The caller owns taking pool
        references (share) on the returned blocks."""
        bs = self.block_size
        toks = [int(t) for t in tokens]
        blocks: List[int] = []
        matched = 0
        parent: Optional[_Node] = None
        self._tick += 1
        while matched + bs <= len(toks):
            chunk = tuple(toks[matched:matched + bs])
            node = self._kids(parent).get(chunk)
            if node is None:
                break
            node.tick = self._tick
            blocks.append(node.block)
            matched += bs
            parent = node
        tail = len(toks) - matched
        if 0 < tail < bs:
            # one cached child whose tokens START with the tail gives a
            # partial alias; only this parent's DIRECT children are
            # candidates, so the probe scans just them
            want = tuple(toks[matched:])
            for ktoks, node in self._kids(parent).items():
                if ktoks[:tail] == want:
                    node.tick = self._tick
                    blocks.append(node.block)
                    matched = len(toks)
                    break
        if matched:
            self.hits += 1
            self.hit_tokens += matched
        else:
            self.misses += 1
        return blocks, matched

    # -- registration --------------------------------------------------------
    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Register a just-prefilled sequence's FULL blocks (the first
        floor(len/bs) of `blocks`, which cache tokens the sequence will
        never rewrite — decode writes land strictly past the prompt).
        New nodes take one pool reference each; existing nodes (the
        shared prefix the sequence itself aliased) are left alone.
        Returns the number of newly indexed blocks."""
        bs = self.block_size
        toks = [int(t) for t in tokens]
        parent: Optional[_Node] = None
        self._tick += 1
        added = 0
        for i in range(len(toks) // bs):
            chunk = tuple(toks[i * bs:(i + 1) * bs])
            node = self._kids(parent).get(chunk)
            if node is None:
                block = int(blocks[i])
                self.pool.share([block])
                key = self._key(parent, chunk)
                node = _Node(key, parent, block, chunk)
                self._nodes[key] = node
                self._kids(parent)[chunk] = node
                added += 1
            node.tick = self._tick
            parent = node
        return added

    # -- pressure ------------------------------------------------------------
    def release_lru(self, n: int = 1) -> int:
        """Drop the index's pool reference on up to `n` least-recently-
        used LEAF blocks (a parent must outlive its children — a chain
        is only walkable from the root). Returns blocks released; the
        pool reclaims each one whose other owners are also gone."""
        dropped = 0
        while dropped < n:
            leaves = [node for node in self._nodes.values()
                      if not node.kids]
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.tick)
            del self._nodes[victim.key]
            del self._kids(victim.parent)[victim.tokens]
            self.pool.free([victim.block])
            self.released += 1
            dropped += 1
        return dropped

    def clear(self) -> int:
        """Release every index reference (tests, shutdown)."""
        return self.release_lru(len(self._nodes))

    # -- defrag --------------------------------------------------------------
    def remap(self, mapping: Dict[int, int]) -> None:
        """Apply a pool defrag's {old: new} block mapping — the index's
        cached chains move with their blocks."""
        if not mapping:
            return
        for node in self._nodes.values():
            node.block = mapping.get(node.block, node.block)
