"""Host-side ragged-sequence containers and padding.

Counterpart of ``paddle_tpu/lod.py``. On the device a sequence batch is
padded dense + lengths (ops/sequence_ops.py); this module is the
host-side bridge: build from a list of variable-length sequences and pad
to a length rounded up to a multiple (8 by default), as the JAX package
does. Rows are copied by a numpy loop, which gives what the JAX
package's native ``pack_rows`` gives.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["LoDTensor", "pad_sequences", "create_lod_tensor"]


def _round_up(n: int, multiple: int) -> int:
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


class LoDTensor:
    """A batch of variable-length sequences.

    Level 1: ``sequences`` is a list of arrays. Nested (level-2) LoD:
    ``sequences`` is a list of LISTS with arrays at the leaves; ``lod()``
    returns one offset table per level and ``to_padded`` pads every
    nesting level ([B, S, W, ...] for level 2) with per-level lengths.
    """

    def __init__(self, sequences: Optional[Sequence] = None):
        self.sequences: List = [self._ingest(s) for s in (sequences or [])]

    @staticmethod
    def _ingest(s):
        """One element of ``sequences``. An ndarray is a leaf sequence; a
        list whose children are ndarrays (or deeper lists) is a nested
        element, rectangular ones included. A Python list of scalars or
        of rows stays a leaf [T] / [T, D]."""
        if isinstance(s, np.ndarray):
            return s
        if isinstance(s, (list, tuple)):
            if any(isinstance(c, (np.ndarray, list, tuple))
                   and LoDTensor._is_sequencey(c) for c in s):
                return [LoDTensor._ingest(c) for c in s]
        return np.asarray(s)

    @staticmethod
    def _is_sequencey(c) -> bool:
        """True when c is itself a sequence of sequences or an ndarray:
        its parent is a nesting level, not a leaf row matrix."""
        if isinstance(c, np.ndarray):
            return True
        return bool(c) and isinstance(c, (list, tuple)) and isinstance(
            c[0], (list, tuple, np.ndarray))

    @property
    def lod_level(self) -> int:
        def depth(x):
            return 1 if isinstance(x, np.ndarray) else 1 + max(
                (depth(c) for c in x), default=1)
        return max((depth(s) for s in self.sequences), default=1)

    @staticmethod
    def from_flat(data: np.ndarray, lod: Sequence[Sequence[int]]
                  ) -> "LoDTensor":
        """From flat data + offsets (any depth), as the reference builds
        one."""
        data = np.asarray(data)
        offsets = list(lod[-1])
        pieces: List = [data[offsets[i]:offsets[i + 1]]
                        for i in range(len(offsets) - 1)]
        for level in reversed(lod[:-1]):
            offs = list(level)
            pieces = [pieces[offs[i]:offs[i + 1]]
                      for i in range(len(offs) - 1)]
        t = LoDTensor()
        t.sequences = pieces  # the structure is explicit: no _ingest
        return t

    def set(self, data, place=None):
        self._flat = np.asarray(data)
        return self

    def set_lod(self, lod):
        self.sequences = LoDTensor.from_flat(self._flat, lod).sequences
        return self

    def lod(self):
        """Offset tables, outermost first."""
        levels: List[List[int]] = []
        layer = self.sequences
        while True:
            offs = [0]
            leaf = all(isinstance(s, np.ndarray) for s in layer)
            for s in layer:
                offs.append(offs[-1] + len(s))
            levels.append(offs)
            if leaf:
                return levels
            layer = [c for s in layer for c in s]

    def __len__(self):
        return len(self.sequences)

    def to_padded(self, pad_multiple: int = 8, pad_value=0,
                  max_len: Optional[int] = None):
        """Level 1 -> (padded [B, T, ...], lengths [B] int32). Level 2 ->
        (padded [B, S, W, ...], (outer_lens [B], inner_lens [B, S]))."""
        if self.lod_level <= 1:
            return self._pad_level1(self.sequences, pad_multiple, pad_value,
                                    max_len)
        assert self.lod_level == 2, "deeper nesting: pad recursively"
        b = len(self.sequences)
        outer_lens = np.asarray([len(s) for s in self.sequences], np.int32)
        s_len = int(outer_lens.max() if b else 1)
        leaves = [leaf for s in self.sequences for leaf in s]
        w = int(max_len if max_len is not None else
                _round_up(max((len(x) for x in leaves), default=1),
                          pad_multiple))
        tail = leaves[0].shape[1:] if leaves else ()
        dtype = leaves[0].dtype if leaves else np.float32
        out = np.full((b, s_len, w) + tuple(tail), pad_value, dtype)
        inner_lens = np.zeros((b, s_len), np.int32)
        for i, s in enumerate(self.sequences):
            for j, leaf in enumerate(s):
                out[i, j, :len(leaf)] = leaf
                inner_lens[i, j] = len(leaf)
        return out, (outer_lens, inner_lens)

    @staticmethod
    def _pad_level1(sequences, pad_multiple, pad_value, max_len):
        lens = np.asarray([len(s) for s in sequences], np.int32)
        if max_len is not None and len(lens) and int(lens.max()) > max_len:
            raise ValueError(
                f"pad_sequences: a sequence of length {int(lens.max())} "
                f"exceeds max_len={max_len} (bucketed on a different "
                "slot? pin pad_to only to slots that fit)")
        t = int(max_len if max_len is not None else
                _round_up(int(lens.max() if len(lens) else 1), pad_multiple))
        tail = sequences[0].shape[1:] if len(sequences) else ()
        dtype = sequences[0].dtype if len(sequences) else np.float32
        out = np.full((len(sequences), t) + tuple(tail), pad_value, dtype)
        for i, s in enumerate(sequences):
            out[i, :len(s)] = s
        return out, lens


def pad_sequences(seqs: Sequence, dtype=None, pad_multiple: int = 8,
                  pad_value=0, max_len: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """A list of per-sequence arrays or lists -> (padded, lengths);
    max_len pins the padded length."""
    arrs = [np.asarray(s, dtype=dtype) for s in seqs]
    return LoDTensor(arrs).to_padded(pad_multiple, pad_value,
                                     max_len=max_len)


def create_lod_tensor(data, recursive_seq_lens=None, place=None
                      ) -> LoDTensor:
    """A list of sequences, or flat data + per-level lengths (every level
    is cumulated to offsets)."""
    if recursive_seq_lens is None:
        return LoDTensor(data)
    lod = [np.concatenate([[0], np.cumsum(lens)]).tolist()
           for lens in recursive_seq_lens]
    return LoDTensor.from_flat(np.asarray(data), lod)
