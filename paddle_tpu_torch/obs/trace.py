"""Structured tracing: the span core of the unified observability plane.

Every plane of the runtime — executor phases, trainer step/epoch/
checkpoint events, data-pipeline stages, the serving request lifecycle —
times itself already; what was missing is ONE causal timeline they all
land on. A `span` is a named, timed interval with attributes; finished
spans become Chrome-trace events (the JSON the Perfetto / chrome://
tracing UIs load natively, written by tools/trace_dump.py) in a bounded
process-wide ring buffer, so "why was this step/request slow" is
answerable from one artifact instead of four metric snapshots.

Design constraints, in order:

  1. near-zero cost off. Tracing is armed by ``PT_TRACE`` (read per
     call — one dict lookup — so it can be toggled at runtime); when
     off, ``span()`` returns a shared no-op and ``emit`` paths return
     before building anything. The documented budget is <= 1% on the
     disabled path (bench.py emits the measured ``trace_overhead_pct``
     per training config; tests pin a per-call bound).
  2. bounded memory. Events land in a ring (``PT_TRACE_BUF`` events,
     default 16384, re-read whenever the ring is recreated) — a long
     run_loop keeps the NEWEST window, it never grows.
  3. thread-correct. The active-span stack is thread-local: spans
     opened on a serving dispatcher thread or a map_batches worker can
     never parent under another thread's trainer step. Cross-thread
     causality is EXPLICIT: capture `current_context()` where the work
     is submitted and pass it as ``parent=`` (or enter
     ``use_context()``) where it runs — the serving batcher does
     exactly this to thread a request id from HTTP ingress through the
     dispatcher.

Clocks are monotonic (`time.perf_counter`), with one process-wide
origin, so events from every thread and plane share one timeline.

Copied from ``paddle_tpu/obs/trace.py`` without its ``jax.profiler``
hook (``device_profile``) and the postmortem bundle, which reads the
metrics plane the port does not carry yet; the port never imports the
JAX package.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = ["span", "instant", "complete", "enabled", "current_context",
           "use_context", "active_stack", "events", "drain", "reset",
           "new_id", "ENABLE_ENV", "BUF_ENV", "DEFAULT_BUF"]

ENABLE_ENV = "PT_TRACE"
BUF_ENV = "PT_TRACE_BUF"
DEFAULT_BUF = 16384

#: values of PT_TRACE that mean "off" (mirrors flags._Flags bool parse)
_OFF = ("", "0", "false", "no", "off")

#: one timeline origin for every thread and plane
_T0 = time.perf_counter()

_ids = itertools.count(1)          # span/trace ids (next() is atomic)
_ring_lock = threading.Lock()
_ring: Optional[deque] = None      # created lazily; maxlen from env


class _TLS(threading.local):
    def __init__(self):
        self.stack: List["Span"] = []     # open spans, innermost last
        self.ctx: Optional[dict] = None   # inherited cross-thread context


_tls = _TLS()


def enabled() -> bool:
    """Is tracing armed? One env-dict lookup — cheap enough to call on
    every would-be span, and toggleable at runtime (tests, bench A/B)."""
    return os.environ.get(ENABLE_ENV, "0").strip().lower() not in _OFF


def new_id() -> int:
    """A fresh process-unique id (request ids, trace ids)."""
    return next(_ids)


def _now_us() -> float:
    return (time.perf_counter() - _T0) * 1e6


def _buf_size() -> int:
    raw = os.environ.get(BUF_ENV, "").strip()
    if not raw:
        return DEFAULT_BUF
    try:
        n = int(raw)
    except ValueError:
        return DEFAULT_BUF
    return n if n > 0 else DEFAULT_BUF


def _append(event: dict) -> None:
    global _ring
    with _ring_lock:
        if _ring is None:
            _ring = deque(maxlen=_buf_size())
        _ring.append(event)


def _event(name: str, cat: str, ph: str, ts_us: float, dur_us: float,
           trace_id: Optional[int], span_id: Optional[int],
           parent_id: Optional[int], attrs: Optional[dict]) -> dict:
    args: Dict[str, object] = dict(attrs) if attrs else {}
    if trace_id is not None:
        args["trace_id"] = trace_id
    if span_id is not None:
        args["span_id"] = span_id
    if parent_id is not None:
        args["parent_id"] = parent_id
    ev = {"name": name, "cat": cat, "ph": ph,
          "ts": round(ts_us, 1), "pid": os.getpid(),
          "tid": threading.get_ident(), "args": args}
    if ph == "X":
        ev["dur"] = round(dur_us, 1)
    else:
        ev["s"] = "t"   # instant scope: thread
    return ev


class _Noop:
    """Shared no-op span for the disabled path: supports the context
    protocol and the Span surface, allocates nothing per use."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs):
        return self


NOOP = _Noop()


class Span:
    """One open interval on this thread's stack. Entering pushes it
    (children parent under it); exiting pops and emits the Chrome-trace
    "X" event. Create via `span()`."""

    __slots__ = ("name", "cat", "attrs", "trace_id", "span_id",
                 "parent_id", "_t0")

    def __init__(self, name: str, cat: str, attrs: dict,
                 parent: Optional[dict]):
        self.name = name
        self.cat = cat
        self.attrs = attrs
        top = _tls.stack[-1] if _tls.stack else None
        if top is not None:
            self.trace_id, self.parent_id = top.trace_id, top.span_id
        else:
            ctx = parent if parent is not None else _tls.ctx
            if ctx:
                self.trace_id = ctx.get("trace_id")
                self.parent_id = ctx.get("span_id")
            else:
                self.trace_id, self.parent_id = new_id(), None
        self.span_id = new_id()

    def annotate(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._t0 = _now_us()
        _tls.stack.append(self)
        return self

    def __exit__(self, *exc):
        # defensive pop: a mis-nested exit must not corrupt the stack
        if _tls.stack and _tls.stack[-1] is self:
            _tls.stack.pop()
        elif self in _tls.stack:
            _tls.stack.remove(self)
        t1 = _now_us()
        _append(_event(self.name, self.cat, "X", self._t0,
                       t1 - self._t0, self.trace_id, self.span_id,
                       self.parent_id, self.attrs))
        return False


def span(name: str, cat: str = "app", parent: Optional[dict] = None,
         **attrs):
    """Open a span: ``with trace.span("step", cat="train", epoch=e):``.
    Returns the shared no-op when tracing is off. `parent` (a
    `current_context()` dict) overrides the thread's inherited context
    when this thread's stack is empty — explicit cross-thread
    causality."""
    if not enabled():
        return NOOP
    return Span(name, cat, dict(attrs), parent)


def instant(name: str, cat: str = "app", parent: Optional[dict] = None,
            **attrs) -> None:
    """A zero-duration marker (guard anomaly, eviction, epoch edge)."""
    if not enabled():
        return
    ctx = _context_or(parent)
    _append(_event(name, cat, "i", _now_us(), 0.0,
                   ctx.get("trace_id") if ctx else None, new_id(),
                   ctx.get("span_id") if ctx else None, attrs))


def complete(name: str, dur_s: float, cat: str = "app",
             parent: Optional[dict] = None, end_ts: Optional[float] = None,
             **attrs) -> None:
    """Emit an already-measured interval ending now (or at `end_ts`, a
    `time.perf_counter()` reading) — the hook the existing timers use:
    PhaseTimer.add / PipelineMetrics.add know a duration, not a span
    object. Parented like span(): this thread's stack, else `parent`,
    else the inherited context."""
    if not enabled():
        return
    end_us = (_now_us() if end_ts is None
              else (end_ts - _T0) * 1e6)
    ctx = _context_or(parent)
    _append(_event(name, cat, "X", end_us - dur_s * 1e6, dur_s * 1e6,
                   ctx.get("trace_id") if ctx else None, new_id(),
                   ctx.get("span_id") if ctx else None, attrs))


def _context_or(parent: Optional[dict]) -> Optional[dict]:
    if _tls.stack:
        top = _tls.stack[-1]
        return {"trace_id": top.trace_id, "span_id": top.span_id}
    if parent is not None:
        return parent
    return _tls.ctx


def current_context() -> Optional[dict]:
    """{"trace_id", "span_id"} of the innermost open span on THIS
    thread (or the inherited context), or None. Capture it where work
    is submitted; pass it as `parent=` / `use_context()` where the work
    runs on another thread."""
    return _context_or(None)


def current_attrs() -> dict:
    """Provenance view of the innermost open span: its ids plus its
    attributes (a trainer step span carries epoch=/step=). Empty when
    tracing is off or no span is open — callers layer their own
    plumbing only in that case (the LazyFetch provenance contract)."""
    if not _tls.stack:
        return {}
    top = _tls.stack[-1]
    out = dict(top.attrs)
    out["span"] = f"{top.cat}:{top.name}#{top.span_id}"
    out["trace_id"] = top.trace_id
    return out


@contextmanager
def use_context(ctx: Optional[dict]):
    """Adopt a captured context as this thread's root parent (worker
    threads executing submitted work)."""
    prev = _tls.ctx
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


def active_stack() -> List[dict]:
    """This thread's open spans, outermost first — what the step
    watchdog attaches to a StepHungError dump (which phase/stage/
    request was in flight when the step hung)."""
    return [{"name": s.name, "cat": s.cat, "span_id": s.span_id,
             "trace_id": s.trace_id, "attrs": dict(s.attrs)}
            for s in _tls.stack]


def events() -> List[dict]:
    """Snapshot of the ring buffer (oldest first), non-destructive."""
    with _ring_lock:
        return list(_ring) if _ring is not None else []


def drain() -> List[dict]:
    """Pop every buffered event (tools/trace_dump.py's source)."""
    global _ring
    with _ring_lock:
        out = list(_ring) if _ring is not None else []
        _ring = None
    return out


def reset(buf: Optional[int] = None) -> None:
    """Clear the buffer; the next event re-reads PT_TRACE_BUF (or uses
    `buf`) for the ring size."""
    global _ring
    with _ring_lock:
        _ring = deque(maxlen=int(buf)) if buf else None
