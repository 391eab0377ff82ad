"""Serving metrics: per-model QPS, batch-fill ratio, queue depth, and
phase-split latency percentiles.

The four request phases mirror the training hot path's PhaseTimer
attribution (core/async_fetch.py) translated to the serving request
lifecycle:

    queue    submit -> the dispatcher picks the request's batch
    pad      gathering + zero-padding the batch into its bucket shape
    device   the compiled bucket executable, incl. host materialization
    scatter  splitting per-request rows back out of the batch outputs

pad/device/scatter are per-BATCH costs; every request in the batch is
charged the same share (the phases answer "where does a request's wall
time go", not "what does a request marginally cost"). Percentiles come
from a bounded ring of recent samples (default 2048) — a serving process
must not grow memory with request count, and "recent p99" is the number
an operator actually wants.

Snapshots are plain dicts (json-able) so tests assert on them and a
scrape renders them (obs/metrics.py render_prometheus). Counterpart of
``paddle_tpu/serving/metrics.py``: the same counters, snapshot keys and
exposition, so one sequence of events gives both packages one snapshot.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from ..core.async_fetch import PhaseTimer
from ..obs.metrics import REGISTRY, percentiles
from ..obs.metrics import render_prometheus  # noqa: F401 — re-export

__all__ = ["ServingPhaseTimer", "ModelMetrics", "DecodeMetrics",
           "ServingMetrics", "PHASES", "render_prometheus", "percentiles"]

PHASES = ("queue", "pad", "device", "scatter")

#: per-phase ring size for percentile estimation
RESERVOIR = 2048


class ServingPhaseTimer(PhaseTimer):
    """PhaseTimer (same span()/add() surface as the executor's) over the
    serving request phases. snapshot() is re-derived here: the training
    timer's host_overhead_pct reads training-phase keys that do not
    exist on this axis. Emitted trace spans land under the "serve"
    category (one timing source, two views — see PhaseTimer.add)."""

    PHASES = PHASES
    trace_cat = "serve"

    def snapshot(self, reset: bool = False) -> dict:
        with self._lock:
            out = {f"{p}_s": round(self._s[p], 6) for p in self.PHASES}
            out["batches"] = self._runs
            if reset:
                self._s = {p: 0.0 for p in self.PHASES}
                self._runs = 0
        return out


#: p50/p95/p99 by nearest-rank, in ms — shared with the train-plane
#: family (obs/metrics.py owns the one implementation now)
_percentiles = percentiles


class ModelMetrics:
    """One model's counters + phase timer + latency reservoirs.
    Thread-safe: submitters, the dispatcher, and HTTP scrapes all touch
    it concurrently."""

    def __init__(self, name: str,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self.timer = ServingPhaseTimer()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._t0 = self._clock()
            self.received = 0
            self.completed = 0
            self.failed = 0
            self.shed_overload = 0
            self.shed_deadline = 0
            self.batches = 0
            self.batch_slots_used = 0
            self.batch_slots_total = 0
            self.queue_depth = 0
            self.reloads = 0
            self._lat: Dict[str, deque] = {
                p: deque(maxlen=RESERVOIR) for p in PHASES}
            self._lat["total"] = deque(maxlen=RESERVOIR)
        self.timer.reset()

    # -- recording ----------------------------------------------------------
    def on_received(self, queue_depth: int) -> None:
        with self._lock:
            self.received += 1
            self.queue_depth = queue_depth

    def on_shed(self, kind: str) -> None:
        with self._lock:
            if kind == "overload":
                self.shed_overload += 1
            else:
                self.shed_deadline += 1

    def on_batch(self, used: int, capacity: int) -> None:
        with self._lock:
            self.batches += 1
            self.batch_slots_used += used
            self.batch_slots_total += capacity

    def on_done(self, ok: bool, queue_depth: int,
                phase_s: Optional[Dict[str, float]] = None,
                total_s: Optional[float] = None) -> None:
        with self._lock:
            if ok:
                self.completed += 1
            else:
                self.failed += 1
            self.queue_depth = queue_depth
            if phase_s:
                for p, s in phase_s.items():
                    if p in self._lat:
                        self._lat[p].append(s)
            if total_s is not None:
                self._lat["total"].append(total_s)

    def on_reload(self) -> None:
        with self._lock:
            self.reloads += 1

    # -- reading ------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            elapsed = max(self._clock() - self._t0, 1e-9)
            fill = (self.batch_slots_used / self.batch_slots_total
                    if self.batch_slots_total else None)
            out = {
                "model": self.name,
                "received": self.received,
                "completed": self.completed,
                "failed": self.failed,
                "shed_overload": self.shed_overload,
                "shed_deadline": self.shed_deadline,
                "queue_depth": self.queue_depth,
                "reloads": self.reloads,
                "batches": self.batches,
                "batch_fill_ratio": round(fill, 4) if fill is not None
                else None,
                "qps": round(self.completed / elapsed, 2),
                "window_s": round(elapsed, 3),
                "latency": {k: _percentiles(list(v))
                            for k, v in self._lat.items()},
            }
        out["phases"] = self.timer.snapshot()
        return out


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


class ServingMetrics:
    """The engine-wide registry: one ModelMetrics per model NAME (metrics
    deliberately survive hot reloads — a reload is an event on the
    model's timeline, not a new timeline). Decode engines report through
    the same registry under their own axis (`decode(name)`), so ONE
    snapshot — and one Prometheus scrape — covers both serving planes.

    Multi-engine processes (the fleet tier, serving/fleet/): `replica`
    namespaces this engine's series — every model/decode snapshot
    carries a `replica` key the Prometheus renderer turns into a
    `replica="<id>"` label, so two replicas serving the SAME model name
    scrape as distinct series instead of duplicates (validate_exposition
    rejects the duplicate). The pre-fleet single-engine assumption —
    one engine per process, model name alone identifies a series — is
    exactly what this parameter retires."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 replica: Optional[str] = None):
        self._clock = clock
        self.replica = replica
        self._lock = threading.Lock()
        self._models: Dict[str, ModelMetrics] = {}
        self._decode: Dict[str, DecodeMetrics] = {}

    def model(self, name: str) -> ModelMetrics:
        with self._lock:
            m = self._models.get(name)
            if m is None:
                m = self._models[name] = ModelMetrics(name,
                                                      clock=self._clock)
            return m

    def decode(self, name: str) -> DecodeMetrics:
        with self._lock:
            m = self._decode.get(name)
            if m is None:
                m = self._decode[name] = DecodeMetrics(name,
                                                       clock=self._clock)
            return m

    def snapshot(self, merge_registry: bool = True) -> dict:
        with self._lock:
            models = list(self._models.values())
            decode = list(self._decode.values())
        out = {"models": {m.name: m.snapshot() for m in models}}
        if decode:
            out["decode"] = {m.name: m.snapshot() for m in decode}
        if self.replica is not None:
            for sec in ("models", "decode"):
                for snap in out.get(sec, {}).values():
                    snap["replica"] = self.replica
        # every other plane reports through the same snapshot (and so
        # the same Prometheus scrape) via the unified MetricsRegistry
        # (obs/metrics.py): live input pipelines (pt_data_*), the
        # training loop (pt_train_*), and the predicted-vs-measured
        # drift monitor (pt_model_*) all ride along — one scrape, one
        # observability plane. A fleet router merging N replica
        # snapshots passes merge_registry=False per replica and merges
        # the registry sections ONCE — the one-engine-per-process
        # assumption the fleet satellite fix retires.
        if merge_registry:
            for section, snaps in REGISTRY.snapshot().items():
                if snaps:
                    out.setdefault(section, snaps)
        return out
