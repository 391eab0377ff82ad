"""DataFeeder: minibatch rows -> feed dict.

Counterpart of ``paddle_tpu/data_feeder.py``: turns a list of sample
tuples (one entry per feed var, from a batched reader) into one numpy
array per var, in the var's dtype and shape; a sequence var (lod_level
>= 1) is padded and its @SEQ_LEN companion gets the lengths (lod.py). A
BucketedBatch (reader/bucketing.py) pins the padded length to its bucket
bound.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .core.program import VarDesc, default_main_program
from .lod import pad_sequences

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None, program=None):
        program = program or default_main_program()
        self.feed_vars: List[VarDesc] = []
        for v in feed_list:
            if isinstance(v, str):
                v = program.global_block.var(v)
            self.feed_vars.append(v)
        self.place = place

    def feed(self, iterable) -> Dict[str, np.ndarray]:
        """iterable: a list of sample tuples, one entry per feed var."""
        rows = list(iterable)
        pad_to = getattr(iterable, "pad_to", None)
        out: Dict[str, np.ndarray] = {}
        for i, var in enumerate(self.feed_vars):
            col = [row[i] for row in rows]
            dtype = np.dtype(var.dtype)
            if var.lod_level >= 1:
                seqs = [np.asarray(s, dtype).reshape(
                    (-1,) + tuple(d for d in var.shape[2:] if d != -1))
                    for s in col]
                # pin to the bucket bound only for slots that fit it
                use = pad_to if (pad_to is not None and seqs and
                                 max(len(s) for s in seqs) <= pad_to) \
                    else None
                padded, lens = pad_sequences(seqs, dtype=dtype, max_len=use)
                out[var.name] = padded
                if var.seq_len_var:
                    out[var.seq_len_var] = lens
            else:
                shape = tuple(d for d in var.shape[1:])
                arr = np.asarray(col, dtype)
                if shape and all(d > 0 for d in shape):
                    arr = arr.reshape((-1,) + shape)
                out[var.name] = arr
        return out
