"""Metrics-driven autoscaling with hysteresis.

The control loop reads the SAME two signals the router dispatches on —
per-replica queue depth and the admission EWMA of batch service time
(pool.health(), i.e. the pt_fleet_replica_* gauges) — and scales the
pool between min and max replicas:

  scale UP fast    pressure (mean queued-per-replica, or mean backlog
                   seconds = depth x EWMA) above the up threshold for
                   `up_after` consecutive ticks (default 2) adds one
                   replica. Sustained depth is the honest signal; a
                   single bursty tick is not.
  scale DOWN slow  pressure below the down threshold for `down_after`
                   consecutive ticks (default 8) — an idle WINDOW, not
                   an idle moment — retires one replica (zero-drop:
                   pool.scale_to drains it). Never below min_replicas.
  hysteresis       the up and down thresholds are far apart, streaks
                   reset on every crossing, and every scale event
                   resets both streaks — an oscillating load that
                   alternates across a single threshold can never flap
                   the pool, which the hysteresis test drives tick by
                   tick with a synthetic health feed.

Every decision is logged as a `trace.instant` (cat="fleet") and counted
in the pt_fleet_scale_events_total metric. Armed in make_fleet by
PT_FLEET_AUTOSCALE=1; PT_FLEET_MIN/PT_FLEET_MAX bound it (pool knobs).
The loop itself is clock- and health-injectable so tests drive the
hysteresis math deterministically, no threads, no sleeps.

Counterpart of ``paddle_tpu/serving/fleet/autoscaler.py``, copied with the JAX
package's names and structure: the tier is host code over the port's
``ServingEngine`` and imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ...obs import trace as obs_trace

__all__ = ["Autoscaler"]


class Autoscaler:
    def __init__(self, pool, *, interval_s: float = 0.5,
                 up_depth: float = 4.0, down_depth: float = 0.5,
                 up_backlog_s: float = 1.0,
                 down_backlog_s: Optional[float] = None,
                 up_after: int = 2, down_after: int = 8,
                 metrics=None,
                 health: Optional[Callable[[], Dict[str, dict]]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if up_depth <= down_depth:
            raise ValueError("up_depth must exceed down_depth "
                             "(hysteresis band)")
        self.pool = pool
        self.interval_s = float(interval_s)
        self.up_depth = float(up_depth)
        self.down_depth = float(down_depth)
        self.up_backlog_s = float(up_backlog_s)
        # the backlog signal needs its OWN band: one shared threshold
        # in both predicates lets a steady load hover across it and
        # flap the pool (scale up spreads the backlog below the line,
        # scale down re-concentrates it above)
        self.down_backlog_s = (self.up_backlog_s / 4.0
                               if down_backlog_s is None
                               else float(down_backlog_s))
        if self.up_backlog_s <= self.down_backlog_s:
            raise ValueError("up_backlog_s must exceed down_backlog_s "
                             "(hysteresis band)")
        self.up_after = max(1, int(up_after))
        self.down_after = max(1, int(down_after))
        self.metrics = metrics
        self._health = health or pool.health
        self._clock = clock
        self._up_streak = 0
        self._down_streak = 0
        self._ticks = 0
        self._decisions = 0
        self._last_pressure = 0.0
        self._last_backlog_s = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the signal ----------------------------------------------------------
    def _read(self) -> None:
        health = [h for h in self._health().values()
                  if h.get("healthy", True)]
        if not health:
            self._last_pressure = 0.0
            self._last_backlog_s = 0.0
            return
        depths = [float(h.get("queue_depth") or 0) for h in health]
        backlog = [d * float(h.get("ewma_ms") or 0.0) / 1e3
                   for d, h in zip(depths, health)]
        self._last_pressure = sum(depths) / len(depths)
        self._last_backlog_s = sum(backlog) / len(backlog)

    # -- the decision (pure math — tests call tick() directly) --------------
    def tick(self) -> Optional[str]:
        """One control iteration. Returns "up" / "down" on a scale
        decision, None on hold."""
        self._ticks += 1
        if self.pool.size() < self.pool.min_replicas:
            # heal first: a pool left below its floor by failed
            # rebuilds reads pressure 0 from its empty health (the
            # hot condition could never fire) — the floor is a
            # contract, not a signal
            if self.pool.ensure_min():
                obs_trace.instant("fleet_scale", cat="fleet",
                                  direction="heal",
                                  replicas=self.pool.size())
        self._read()
        hot = (self._last_pressure >= self.up_depth
               or self._last_backlog_s >= self.up_backlog_s)
        idle = (self._last_pressure <= self.down_depth
                and self._last_backlog_s < self.down_backlog_s)
        if hot:
            self._up_streak += 1
            self._down_streak = 0
        elif idle:
            self._down_streak += 1
            self._up_streak = 0
        else:
            # the hysteresis band is neutral ground: BOTH streaks
            # reset, so a load hovering between the thresholds holds
            # the current size and never accumulates toward a decision
            self._up_streak = 0
            self._down_streak = 0
        n = self.pool.size()
        decision = None
        if (self._up_streak >= self.up_after
                and n < self.pool.max_replicas):
            decision = "up"
            target = n + 1
        elif (self._down_streak >= self.down_after
                and n > self.pool.min_replicas):
            decision = "down"
            target = n - 1
        if decision is None:
            return None
        try:
            ok = self.pool.scale_to(
                target, reason=f"autoscale_{decision}") == target
        except BaseException:   # noqa: BLE001 — a loader failure mid
            # scale-up must not kill the loop OR be recorded as a
            # scale event; streaks stay hot so the retry is immediate
            ok = False
        if not ok:
            return None
        # record only what actually happened: counters, trace, and the
        # streak reset all follow the SUCCESSFUL scale
        self._up_streak = self._down_streak = 0
        self._decisions += 1
        obs_trace.instant(
            "fleet_scale", cat="fleet", direction=decision,
            replicas=target,
            pressure=round(self._last_pressure, 3),
            backlog_s=round(self._last_backlog_s, 4))
        if self.metrics is not None:
            self.metrics.on_scale(decision)
        return decision

    # -- the loop ------------------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pt-fleet-autoscaler")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:   # noqa: BLE001 — a flaky health read
                # must not kill the control loop; the next tick retries
                pass

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(5.0)

    def describe(self) -> dict:
        return {"running": self._thread is not None,
                "interval_s": self.interval_s,
                "min_replicas": self.pool.min_replicas,
                "max_replicas": self.pool.max_replicas,
                "up_depth": self.up_depth,
                "down_depth": self.down_depth,
                "up_backlog_s": self.up_backlog_s,
                "down_backlog_s": self.down_backlog_s,
                "up_after": self.up_after,
                "down_after": self.down_after,
                "ticks": self._ticks,
                "decisions": self._decisions,
                "last_pressure": round(self._last_pressure, 3),
                "last_backlog_s": round(self._last_backlog_s, 4)}
