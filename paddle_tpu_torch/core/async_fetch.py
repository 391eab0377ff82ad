"""Lazy fetch handles and per-phase wall-time accounting.

Counterpart of ``paddle_tpu/core/async_fetch.py`` (that module imports
JAX, so the port keeps its own copy):

* ``LazyFetch`` wraps one fetched device tensor. ``Executor.run`` /
  ``run_loop(lazy=True)`` return these as soon as the step is queued on
  the device; a handle waits only when it is read (``.numpy()``,
  ``float()``, ``np.asarray``), so the host prepares and queues step
  N+1 while the card runs step N. ``materialize`` reads every handle of
  a nested structure.
* ``PhaseTimer`` accumulates host_prep / dispatch / device / fetch
  seconds; the serving plane's ``ServingPhaseTimer``
  (serving/metrics.py) derives from it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..obs import trace as obs_trace
from .types import host_array

__all__ = ["PhaseTimer", "LazyFetch", "materialize"]


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


def _attach_deferred_context(e: BaseException, prov: dict) -> None:
    """Attach (epoch, step, fetch name) provenance to an error raised
    where a lazy handle is read: the device ran the step earlier, and the
    traceback alone points at the read."""
    if not prov:
        return
    note = ("deferred from device execution; in-flight fetch: "
            + ", ".join(f"{k}={v!r}" for k, v in sorted(prov.items())))
    add_note = getattr(e, "add_note", None)
    if callable(add_note):
        add_note(note)
    elif e.args and isinstance(e.args[0], str):
        e.args = (f"{e.args[0]}\n{note}",) + e.args[1:]
    else:
        e.args = e.args + (note,)


class LazyFetch:
    """Deferred fetch of one device tensor.

    On a CUDA tensor the handle records an event on the current stream
    when it is made (the step has been queued by then); reading it waits
    for that event, copies the tensor to numpy once and caches it. The
    wait is charged to the owner's "device" phase and the copy to its
    "fetch" phase. `.value()` returns the tensor without waiting.
    `provenance` (the fetch name; the Trainer adds epoch and step) is
    attached to an error raised by the read."""

    __slots__ = ("_val", "_timer", "_np", "_prov", "_event")

    def __init__(self, value: torch.Tensor, timer: Optional[PhaseTimer] = None,
                 provenance: Optional[dict] = None):
        self._val = value
        self._timer = timer
        self._np = None
        self._prov = dict(provenance) if provenance else {}
        self._event = None
        if value.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(value.device))

    def annotate(self, **context) -> "LazyFetch":
        """Merge provenance context (e.g. epoch=, step=); returns self."""
        self._prov.update(context)
        return self

    @property
    def provenance(self) -> dict:
        return dict(self._prov)

    # -- non-blocking surface ----------------------------------------------
    def value(self) -> torch.Tensor:
        """The device tensor; never waits."""
        return self._val

    @property
    def shape(self):
        return tuple(self._val.shape)

    @property
    def dtype(self):
        """The dtype ``numpy()`` returns."""
        if self._val.dtype == torch.bfloat16:
            return np.dtype(np.float32)
        return np.dtype(str(self._val.dtype).rsplit(".", 1)[-1])

    @property
    def ndim(self):
        return self._val.dim()

    def is_ready(self) -> bool:
        """True when the step that made the value has finished (never
        waits)."""
        return (self._np is not None or self._event is None
                or self._event.query())

    # -- blocking reads -----------------------------------------------------
    def _read(self) -> np.ndarray:
        if self._event is not None:
            if self._timer is not None:
                with self._timer.span("device"):
                    self._event.synchronize()
            else:
                self._event.synchronize()
        if self._timer is not None:
            with self._timer.span("fetch"):
                return host_array(self._val)
        return host_array(self._val)

    def numpy(self) -> np.ndarray:
        """Wait for the value and copy it to numpy (cached): the one
        synchronization point. A bfloat16 value comes back as float32,
        widened exactly (numpy has no bfloat16)."""
        if self._np is None:
            try:
                self._np = self._read()
            except Exception as e:
                _attach_deferred_context(e, self._prov)
                raise
        return self._np

    def block_until_ready(self) -> "LazyFetch":
        self.numpy()
        return self

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(np.ravel(self.numpy())[0])

    def __int__(self):
        return int(np.ravel(self.numpy())[0])

    def __bool__(self):
        return bool(self.numpy())

    def __getitem__(self, idx):
        return self.numpy()[idx]

    def __len__(self):
        return len(self.numpy())

    def __iter__(self):
        return iter(self.numpy())

    def __format__(self, spec):
        return format(float(self) if spec and spec[-1] in "eEfFgGn%"
                      else self.numpy(), spec)

    def __repr__(self):
        if self._np is None and not self.is_ready():
            return (f"LazyFetch(shape={self.shape}, dtype={self.dtype}, "
                    "pending)")
        return f"LazyFetch({self.numpy()!r})"


def materialize(obj):
    """Read every LazyFetch handle in nested lists/tuples/dicts into
    numpy; anything else passes through."""
    if isinstance(obj, LazyFetch):
        return obj.numpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(materialize(o) for o in obj)
    if isinstance(obj, dict):
        return {k: materialize(v) for k, v in obj.items()}
    return obj
