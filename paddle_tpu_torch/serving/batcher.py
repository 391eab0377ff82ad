"""Environment knobs of the serving plane.

Counterpart of ``env_int`` / ``env_float`` in
``paddle_tpu/serving/batcher.py``; the micro-batcher itself is not ported
yet.
"""

from __future__ import annotations

import os

__all__ = ["env_int", "env_float"]


def env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    try:
        return float(v) if v not in (None, "") else default
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v not in (None, "") else default
    except ValueError:
        return default
