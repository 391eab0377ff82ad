"""Decode-engine metrics.

Counterpart of ``DecodeMetrics`` in ``paddle_tpu/serving/metrics.py`` and
of the percentile helper in ``paddle_tpu/obs/metrics.py``; the one-shot
engine's metrics and the Prometheus exposition are not ported yet.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["DecodeMetrics", "percentiles"]


def percentiles(samples: List[float],
                qs=(0.50, 0.95, 0.99)) -> Dict[str, Optional[float]]:
    """p50/p95/p99 by nearest-rank over a sorted copy, in ms."""
    if not samples:
        return {f"p{int(q * 100)}_ms": None for q in qs}
    s = sorted(samples)
    n = len(s)

    def rank(q: float) -> float:
        i = min(n - 1, max(0, int(round(q * (n - 1)))))
        return round(s[i] * 1000.0, 3)

    return {f"p{int(q * 100)}_ms": rank(q) for q in qs}


class DecodeMetrics:
    """One decode engine's counters: sequences, tokens, continuous-batch
    slot occupancy, and KV-pool pressure. The decode axis is different
    enough from the request/batch axis that it gets its own type —
    tokens/s and slot occupancy are THE numbers for a generation engine,
    where QPS and batch fill are the numbers for a one-shot one."""

    def __init__(self, name: str,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._t0 = self._clock()
            self.received = 0
            self.completed = 0
            self.failed = 0
            self.shed_overload = 0
            self.shed_deadline = 0
            self.evictions = 0
            self.resumes = 0
            self.prefills = 0
            self.prefill_tokens = 0
            self.steps = 0
            self.tokens_out = 0
            self.slots_used_sum = 0
            self.slots_capacity_sum = 0
            self.prefill_s = 0.0
            self.decode_s = 0.0
            self.active = 0
            self.waiting = 0
            self.kv_blocks_in_use = 0
            self.kv_blocks_capacity = 0
            self.kv_high_water = 0
            # KV economics (decode/prefix.py + decode/spec.py)
            self.kv_shared_hits = 0
            self.kv_shared_tokens = 0
            self.kv_cow_copies = 0
            self.kv_blocks_shared = 0
            self.kv_blocks_indexed = 0
            self.spec_steps = 0
            self.spec_drafted = 0
            self.spec_accepted = 0
            self.spec_fallbacks = 0

    # -- recording ----------------------------------------------------------
    def on_received(self) -> None:
        with self._lock:
            self.received += 1

    def on_finished(self, ok: bool) -> None:
        with self._lock:
            if ok:
                self.completed += 1
            else:
                self.failed += 1

    def on_shed(self, kind: str) -> None:
        with self._lock:
            if kind == "overload":
                self.shed_overload += 1
            else:
                self.shed_deadline += 1

    def on_evicted(self) -> None:
        with self._lock:
            self.evictions += 1

    def on_resumed(self) -> None:
        with self._lock:
            self.resumes += 1

    def on_prefill(self, tokens: int, seconds: float) -> None:
        with self._lock:
            self.prefills += 1
            self.prefill_tokens += tokens
            self.prefill_s += seconds

    def on_step(self, used: int, capacity: int, seconds: float,
                tokens: int) -> None:
        with self._lock:
            self.steps += 1
            self.slots_used_sum += used
            self.slots_capacity_sum += capacity
            self.decode_s += seconds
            self.tokens_out += tokens

    def on_prefix_hit(self, tokens: int, blocks: int) -> None:
        with self._lock:
            self.kv_shared_hits += 1
            self.kv_shared_tokens += tokens

    def on_cow(self) -> None:
        with self._lock:
            self.kv_cow_copies += 1

    def on_spec(self, drafted: int, accepted: int) -> None:
        with self._lock:
            self.spec_steps += 1
            self.spec_drafted += drafted
            self.spec_accepted += accepted

    def on_spec_fallback(self) -> None:
        with self._lock:
            self.spec_fallbacks += 1

    def set_gauges(self, *, active: int, waiting: int, blocks_in_use: int,
                   blocks_capacity: int, high_water: int,
                   blocks_shared: int = 0,
                   blocks_indexed: int = 0) -> None:
        with self._lock:
            self.active = active
            self.waiting = waiting
            self.kv_blocks_in_use = blocks_in_use
            self.kv_blocks_capacity = blocks_capacity
            self.kv_high_water = high_water
            self.kv_blocks_shared = blocks_shared
            self.kv_blocks_indexed = blocks_indexed

    # -- reading ------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            elapsed = max(self._clock() - self._t0, 1e-9)
            occ = (self.slots_used_sum / self.slots_capacity_sum
                   if self.slots_capacity_sum else None)
            return {
                "model": self.name,
                "received": self.received,
                "completed": self.completed,
                "failed": self.failed,
                "shed_overload": self.shed_overload,
                "shed_deadline": self.shed_deadline,
                "evictions": self.evictions,
                "resumes": self.resumes,
                "prefills": self.prefills,
                "prefill_tokens": self.prefill_tokens,
                "decode_steps": self.steps,
                "tokens_out": self.tokens_out,
                "tokens_per_sec": round(self.tokens_out / elapsed, 2),
                "slot_occupancy": round(occ, 4) if occ is not None
                else None,
                "active": self.active,
                "waiting": self.waiting,
                "kv_blocks_in_use": self.kv_blocks_in_use,
                "kv_blocks_capacity": self.kv_blocks_capacity,
                "kv_high_water": self.kv_high_water,
                "kv_shared_hits": self.kv_shared_hits,
                "kv_shared_tokens": self.kv_shared_tokens,
                "kv_cow_copies": self.kv_cow_copies,
                "kv_blocks_shared": self.kv_blocks_shared,
                "kv_blocks_indexed": self.kv_blocks_indexed,
                "spec_steps": self.spec_steps,
                "spec_drafted": self.spec_drafted,
                "spec_accepted": self.spec_accepted,
                "spec_fallbacks": self.spec_fallbacks,
                "spec_acceptance_rate": (
                    round(self.spec_accepted / self.spec_drafted, 4)
                    if self.spec_drafted else None),
                "prefill_s": round(self.prefill_s, 6),
                "decode_s": round(self.decode_s, 6),
                "window_s": round(elapsed, 3),
            }
