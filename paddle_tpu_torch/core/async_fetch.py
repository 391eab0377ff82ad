"""Per-phase wall-time accounting.

Counterpart of ``PhaseTimer`` in ``paddle_tpu/core/async_fetch.py``
(that module imports JAX, so the port keeps its own copy). The serving
plane's ``ServingPhaseTimer`` (serving/metrics.py) derives from it. The
lazy fetch handles (``LazyFetch``) are not ported.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

from ..obs import trace as obs_trace

__all__ = ["PhaseTimer"]


class PhaseTimer:
    """Per-phase wall-time accumulator (thread-safe: LazyFetch handles may
    be read from any thread, e.g. a metrics logger).

    Also a span emitter: every `add()` (which both direct calls and the
    span() context manager funnel through) lands the same interval on
    the structured trace (obs/trace.py) when PT_TRACE is armed — ONE
    timing source feeding two views, the cumulative phase accounting
    and the per-event timeline. `trace_cat` names the plane (subclasses
    override: the serving timer emits under "serve")."""

    PHASES = ("host_prep", "dispatch", "device", "fetch")
    trace_cat = "exec"

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._s: Dict[str, float] = {p: 0.0 for p in self.PHASES}
            self._runs = 0

    def add(self, phase: str, seconds: float):
        with self._lock:
            self._s[phase] += seconds
        if obs_trace.enabled():
            obs_trace.complete(phase, seconds, cat=self.trace_cat)

    def count_run(self):
        with self._lock:
            self._runs += 1

    class _Span:
        __slots__ = ("_timer", "_phase", "_t0")

        def __init__(self, timer, phase):
            self._timer, self._phase = timer, phase

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._timer.add(self._phase, time.perf_counter() - self._t0)
            return False

    def span(self, phase: str) -> "_Span":
        return self._Span(self, phase)

    def snapshot(self, reset: bool = False) -> dict:
        """Accounted seconds per phase + derived host_overhead_pct.

        host_overhead_pct = host-side share of ACCOUNTED time (prep +
        dispatch + fetch vs device wait). With lazy fetches the phases
        overlap device execution, so this is an attribution of where the
        host spent its time, not a wall-clock decomposition — exactly
        what "is the remaining MFU gap host or device" needs."""
        with self._lock:
            out = {f"{p}_s": round(self._s[p], 6) for p in self.PHASES}
            out["runs"] = self._runs
            host = (self._s["host_prep"] + self._s["dispatch"]
                    + self._s["fetch"])
            total = host + self._s["device"]
            out["host_overhead_pct"] = (round(host / total * 100.0, 2)
                                        if total > 0 else None)
            if reset:
                self._s = {p: 0.0 for p in self.PHASES}
                self._runs = 0
        return out
