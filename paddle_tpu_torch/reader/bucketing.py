"""Length bucketing: the pad length of a ragged sample.

Counterpart of ``bucket_bound`` in ``paddle_tpu/reader/bucketing.py``;
the serving path pads each prompt to its bucket with it.
"""

from __future__ import annotations

import bisect
from typing import Sequence

__all__ = ["bucket_bound"]


def bucket_bound(n: int, bounds: Sequence[int]) -> int:
    """The pad length for a sample of length `n` under sorted `bounds`:
    the smallest bound >= n, or — past the last bound — the next multiple
    of the last bound."""
    i = bisect.bisect_left(bounds, n)
    if i < len(bounds):
        return bounds[i]
    last = bounds[-1]
    return ((n + last - 1) // last) * last
