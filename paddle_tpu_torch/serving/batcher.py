"""Dynamic micro-batcher: a bounded request queue drained by one
dispatcher thread per model version.

Counterpart of ``paddle_tpu/serving/batcher.py``. A device pays per
batch as much as per example: a bucket's step (the program's ops, each
a kernel launch) costs nearly the same wall time at fill 1 as at fill 4.
The micro-batcher turns independent online requests into full batches by
waiting — but only a little: a bucket's pending group is flushed the
moment it holds `max_batch_size` requests, or when its OLDEST request
has waited `max_wait_ms`, whichever comes first. Latency is therefore
bounded by max_wait_ms + one batch service time, and throughput
approaches batch_size x the sequential rate under load.

Shape buckets: requests are grouped by the bucket key the model derives
from their variable-length dims (reader/bucketing.py's bucket_bound over
the artifact's exported bounds), so requests of different padded shapes
never share a batch and each bucket replays one program lowered at load.

Failure containment: the dispatcher loop is wrapped per-batch — a crash
inside execution (including the `serve_dispatch` chaos site,
resilience/faults.py) fails THAT batch's futures with a typed
RequestFailed carrying the original error, and the loop keeps serving.
An engine thread dying silently would turn every later request into a
hang; this one cannot.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional

from ..obs import trace as obs_trace
from ..resilience import faults
from .admission import (AdmissionController, DeadlineExceeded,
                        ModelUnavailable, RequestFailed)
from .metrics import ModelMetrics

__all__ = ["Request", "MicroBatcher", "DEFAULT_MAX_WAIT_MS",
           "env_float", "env_int"]

#: PT_SERVE_MAX_WAIT_MS fallback — the single source for both a
#: standalone MicroBatcher and a ServingEngine-built one
DEFAULT_MAX_WAIT_MS = 2.0


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


class Request:
    """One queued example: feeds + deadline + the Future its caller
    holds. Timing fields feed the queue-phase latency metric.

    With tracing armed (PT_TRACE), each request is minted an id at
    submission and captures the submitter's span context (the HTTP
    ingress span, for front-end traffic) — the dispatcher thread
    parents the request's queue/batch spans under it, so one request's
    queue -> pad -> device -> scatter lifeline reads as one trace."""

    __slots__ = ("feeds", "bucket", "future", "deadline_t", "t_enqueue",
                 "rid", "ctx")

    def __init__(self, feeds, bucket, deadline_t: Optional[float]):
        self.feeds = feeds
        self.bucket = bucket
        self.future: Future = Future()
        self.deadline_t = deadline_t
        self.t_enqueue = time.monotonic()
        if obs_trace.enabled():
            self.rid = obs_trace.new_id()
            self.ctx = obs_trace.current_context()
        else:
            self.rid = None
            self.ctx = None


class MicroBatcher:
    """One model version's queue + dispatcher thread.

    model: an object with `batch_size`, `bucket_of(feeds)`, and
    `execute_batch(bucket, examples, timer=)` (registry.ModelVersion, or
    a stub in unit tests). Close with drain=True to serve every queued
    request before the thread exits (the hot-reload contract)."""

    def __init__(self, model, *, max_batch_size: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 admission: Optional[AdmissionController] = None,
                 metrics: Optional[ModelMetrics] = None,
                 name: str = "model"):
        self.model = model
        self.name = name
        self.max_batch_size = int(max_batch_size or model.batch_size)
        if self.max_batch_size > model.batch_size:
            # the artifact is shape-locked at its exported batch; a
            # larger micro-batch could never run in one dispatch
            self.max_batch_size = model.batch_size
        self.max_wait_ms = (
            env_float("PT_SERVE_MAX_WAIT_MS", DEFAULT_MAX_WAIT_MS)
            if max_wait_ms is None else float(max_wait_ms))
        self.admission = admission or AdmissionController(
            queue_depth=256, max_batch_size=self.max_batch_size)
        self.metrics = metrics or ModelMetrics(name)
        self._cv = threading.Condition()
        self._queue: deque = deque()
        #: dispatcher-owned: bucket key -> [Request] accumulating a batch
        self._pending: Dict[object, List[Request]] = {}
        self._closed = False
        self._drained = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"pt-serve[{name}]")
        self._thread.start()

    # -- client side ---------------------------------------------------------
    def queued(self) -> int:
        with self._cv:
            return len(self._queue) + sum(len(v) for v in
                                          self._pending.values())

    def service_estimate_s(self) -> Optional[float]:
        """The admission EWMA of batch service seconds (None until the
        first real batch) — the fleet tier's per-replica health signal
        (fleet/pool.py), read from the one estimate deadline shedding
        already maintains rather than a second bookkeeping path."""
        return self.admission.estimated_batch_s()

    def submit(self, feeds, deadline_ms: Optional[float] = None) -> Future:
        """Admit + enqueue one example; returns its Future. Raises the
        typed admission errors (Overloaded / DeadlineExceeded /
        InvalidRequest / ModelUnavailable) instead of queueing a request
        that cannot be served."""
        bucket = self.model.bucket_of(feeds)   # InvalidRequest on misfit
        deadline_t = self.admission.deadline_for(deadline_ms)
        with self._cv:
            if self._closed:
                raise ModelUnavailable(
                    f"model {self.name!r} is draining/unloaded")
            queued = len(self._queue) + sum(len(v) for v in
                                            self._pending.values())
            try:
                self.admission.admit(queued, deadline_t, model=self.name)
            except DeadlineExceeded:
                self.metrics.on_shed("deadline")
                raise
            except Exception:
                self.metrics.on_shed("overload")
                raise
            req = Request(feeds, bucket, deadline_t)
            self._queue.append(req)
            self.metrics.on_received(queued + 1)
            self._cv.notify()
        return req.future

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop accepting requests. drain=True serves everything already
        queued (hot reload / graceful shutdown); drain=False fails the
        backlog fast with ModelUnavailable."""
        with self._cv:
            self._closed = True
            if not drain:
                backlog = list(self._queue)
                self._queue.clear()
                for g in self._pending.values():
                    backlog.extend(g)
                self._pending.clear()
                for r in backlog:
                    if not r.future.done():
                        r.future.set_exception(ModelUnavailable(
                            f"model {self.name!r} unloaded before "
                            "dispatch"))
            self._cv.notify()
        self._drained.wait(timeout)
        self._thread.join(timeout)

    # -- dispatcher side -----------------------------------------------------
    def _flush_due(self, now: float) -> List:
        """Pop the batches that must run NOW: full chunks of
        max_batch_size (a group can outgrow the bound while the
        dispatcher was busy — each chunk is its own dispatch), groups
        whose oldest request aged past max_wait_ms, everything on
        close."""
        due = []
        max_wait = self.max_wait_ms / 1000.0
        for key in list(self._pending):
            group = self._pending[key]
            while len(group) >= self.max_batch_size:
                due.append((key, group[:self.max_batch_size]))
                group = group[self.max_batch_size:]
            if group and (self._closed
                          or now - group[0].t_enqueue >= max_wait):
                due.append((key, group))
                group = []
            if group:
                self._pending[key] = group
            else:
                self._pending.pop(key)
        return due

    def _next_deadline(self) -> Optional[float]:
        """Monotonic time of the earliest pending flush, else None."""
        if not self._pending:
            return None
        oldest = min(g[0].t_enqueue for g in self._pending.values() if g)
        return oldest + self.max_wait_ms / 1000.0

    def _loop(self) -> None:
        try:
            while True:
                with self._cv:
                    while True:
                        while self._queue:
                            r = self._queue.popleft()
                            self._pending.setdefault(r.bucket,
                                                     []).append(r)
                        now = time.monotonic()
                        due = self._flush_due(now)
                        if due:
                            break
                        if self._closed and not self._pending:
                            return
                        nxt = self._next_deadline()
                        self._cv.wait(None if nxt is None
                                      else max(nxt - now, 0.0))
                for _key, group in due:
                    self._run_batch(_key, group)
        finally:
            self._drained.set()

    def _run_batch(self, bucket, group: List[Request]) -> None:
        now = time.monotonic()
        live: List[Request] = []
        for r in group:
            if r.deadline_t is not None and now >= r.deadline_t:
                # expired while queued: shed instead of burning a batch
                # slot on a result nobody is waiting for anymore
                self.metrics.on_shed("deadline")
                if not r.future.done():
                    r.future.set_exception(DeadlineExceeded(
                        f"request spent {(now - r.t_enqueue) * 1000:.1f} "
                        "ms queued, past its deadline"))
            else:
                live.append(r)
        if not live:
            return
        queue_s = [now - r.t_enqueue for r in live]
        if obs_trace.enabled():
            # per-request queue spans, parented under each submitter's
            # context (the HTTP ingress span) — the measured wait ended
            # now, so the span is emitted with its known duration
            for r, qs in zip(live, queue_s):
                obs_trace.complete("queue", qs, cat="serve",
                                   parent=r.ctx, model=self.name,
                                   rid=r.rid)
        self.metrics.on_batch(len(live), self.max_batch_size)
        # the batch span parents the pad/device/scatter phase spans the
        # model's timer emits; a single-request batch adopts THAT
        # request's trace (the common online case — one request, one
        # causal timeline end to end), a coalesced batch records every
        # rid it serves
        batch_span = obs_trace.span(
            "batch", cat="serve",
            parent=(live[0].ctx if len(live) == 1 else None),
            model=self.name, n=len(live),
            rids=[r.rid for r in live])
        t0 = time.monotonic()
        try:
            with batch_span:
                faults.crash_point("serve_dispatch")
                results, phase_s = self.model.execute_batch(
                    bucket, [r.feeds for r in live],
                    timer=self.metrics.timer)
        except BaseException as e:  # noqa: BLE001 — typed + re-delivered
            batch_s = time.monotonic() - t0
            self.admission.observe_batch(batch_s)
            depth = self.queued()
            for r in live:
                if not r.future.done():
                    r.future.set_exception(RequestFailed(
                        f"dispatcher failed running a batch of "
                        f"{len(live)} on model {self.name!r}: {e}",
                        cause=e))
                self.metrics.on_done(False, depth)
            return  # the loop keeps serving: one bad batch != a dead engine
        batch_s = time.monotonic() - t0
        self.admission.observe_batch(batch_s)
        self.metrics.timer.count_run()
        done_t = time.monotonic()
        depth = self.queued()
        for r, res, qs in zip(live, results, queue_s):
            if not r.future.done():
                r.future.set_result(res)
            self.metrics.on_done(
                True, depth,
                phase_s=dict(phase_s, queue=qs),
                total_s=done_t - r.t_enqueue)
