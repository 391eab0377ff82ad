"""Fleet metrics: the pt_fleet_* family on the one-pane exposition.

One provider per router, registered in the unified MetricsRegistry
(obs/metrics.py) under section "fleet" — so the same scrape that
carries pt_serve_*/pt_decode_*/pt_train_* carries the tier above them:
replica count, per-replica depth/health (pulled LIVE from the pool at
snapshot time — the same queue-depth/EWMA pair the router dispatches
on), dispatch counts per policy, sheds per class, failovers/rebuilds,
and autoscaler decisions.

Counters are recorded by the router/autoscaler; gauges are derived at
snapshot time from weakly-referenced sources (pool, router) so an
abandoned fleet neither pins memory nor keeps reporting — the registry
convention.

Counterpart of ``paddle_tpu/serving/fleet/metrics.py``, copied with the JAX
package's names and structure: the tier is host code over the port's
``ServingEngine`` and imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, Optional

from ...obs.metrics import REGISTRY

__all__ = ["FleetMetrics"]


class FleetMetrics:
    """One fleet's counters + live-derived gauges. Thread-safe: the
    router's dispatcher, the autoscaler loop, and HTTP scrapes all
    touch it concurrently."""

    def __init__(self, name: str = "fleet",
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._pool = None       # weakref, set by the router
        self._router = None     # weakref
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._t0 = self._clock()
            self.dispatched: Dict[str, int] = {}
            self.completed = 0
            self.failed = 0
            self.sheds: Dict[int, int] = {}
            self.sheds_deadline: Dict[int, int] = {}
            self.failovers = 0
            self.rebuilds = 0
            self.scale_up_events = 0
            self.scale_down_events = 0

    # -- wiring --------------------------------------------------------------
    def bind(self, pool=None, router=None) -> None:
        if pool is not None:
            self._pool = weakref.ref(pool)
        if router is not None:
            self._router = weakref.ref(router)

    def register(self) -> None:
        """Join the process-wide exposition (weakref section 'fleet');
        the router holds the strong reference. A second fleet in the
        same process under the same name gets a numeric suffix instead
        of silently shadowing the first (and unregistering the first
        must never take the second off the scrape) — the probe and the
        insert are one atomic registry operation, so concurrently
        constructed fleets can't race past each other either."""
        self.name = REGISTRY.register_unique("fleet", self.name, self)

    def unregister(self) -> None:
        REGISTRY.unregister("fleet", self.name)

    # -- recording -----------------------------------------------------------
    def on_dispatch(self, policy: str) -> None:
        with self._lock:
            self.dispatched[policy] = self.dispatched.get(policy, 0) + 1

    def on_done(self, ok: bool) -> None:
        with self._lock:
            if ok:
                self.completed += 1
            else:
                self.failed += 1

    def on_shed(self, cls: int, kind: str = "overload") -> None:
        with self._lock:
            book = (self.sheds if kind == "overload"
                    else self.sheds_deadline)
            book[int(cls)] = book.get(int(cls), 0) + 1

    def on_failover(self) -> None:
        with self._lock:
            self.failovers += 1

    def on_rebuild(self) -> None:
        with self._lock:
            self.rebuilds += 1

    def on_scale(self, direction: str) -> None:
        with self._lock:
            if direction == "up":
                self.scale_up_events += 1
            else:
                self.scale_down_events += 1

    # -- reading -------------------------------------------------------------
    def _live(self, ref) -> Optional[object]:
        return ref() if ref is not None else None

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "name": self.name,
                "completed": self.completed,
                "failed": self.failed,
                "failovers": self.failovers,
                "rebuilds": self.rebuilds,
                "dispatched": dict(self.dispatched),
                "sheds": {str(c): n for c, n in
                          sorted(self.sheds.items())},
                "sheds_deadline": {str(c): n for c, n in
                                   sorted(self.sheds_deadline.items())},
                "scale_events": {"up": self.scale_up_events,
                                 "down": self.scale_down_events},
                "window_s": round(max(self._clock() - self._t0, 1e-9),
                                  3),
            }
        pool = self._live(self._pool)
        if pool is not None:
            out["replicas"] = pool.size()
            out["replica_health"] = pool.health()
        router = self._live(self._router)
        if router is not None:
            out["policy"] = router.policy
            out["queue_depths"] = {str(c): n for c, n in
                                   router.queue_depths().items()}
        return out
