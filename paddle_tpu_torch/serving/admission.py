"""Admission control for the online serving engine: typed errors +
reject-fast load shedding.

An overloaded serving system has exactly two honest answers: serve within
the deadline, or say NO immediately. Queuing a request it cannot serve in
time converts a cheap rejection (client retries elsewhere) into an
expensive timeout (client waited, capacity was burned padding and running
a batch whose result nobody reads). So admission is checked at SUBMIT
time against the queue bound AND the request's deadline — using a
decaying estimate of batch service time, so a deadline the queue ahead of
the request would already blow is rejected before it enqueues.

Error taxonomy (the typed surface every front end maps from — HTTP
status codes in serving/http.py, C-API error strings in serving_embed):

    Overloaded        queue at capacity — RETRYABLE (another replica, or
                      the same one after backoff, may accept)
    DeadlineExceeded  the request cannot / did not make its deadline —
                      not retryable as-is (a retry restarts the deadline;
                      that is the CLIENT's decision, not the layer's)
    ModelUnavailable  unknown model name, or the engine is shut down
    InvalidRequest    feed names / shapes / dtypes don't fit the model
                      (no bucket can hold it)
    RequestFailed     the dispatcher crashed while running the batch;
                      carries the original error as __cause__

`retryable(exc)` is the RetryPolicy-convention predicate (resilience/
retry.py): ``RetryPolicy(retry_on=serving.retryable)`` gives a client
bounded backoff on Overloaded without ever retrying a rejection that
would deterministically repeat.

Copied from ``paddle_tpu/serving/admission.py``; the port
carries its own copy because it never imports the JAX package.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = ["ServingError", "Overloaded", "DeadlineExceeded",
           "ModelUnavailable", "InvalidRequest", "RequestFailed",
           "retryable", "AdmissionController"]


class ServingError(RuntimeError):
    """Base of the serving engine's typed errors."""
    retryable = False
    http_status = 500


class Overloaded(ServingError):
    """Queue at capacity — rejected fast, worth retrying after backoff.

    When the fleet tier sheds under overload (serving/fleet/), the
    error carries WHICH priority class paid: `shed_class` is the class
    of the request that was shed (strictly the lowest class present —
    free tier absorbs overload before paid tier). None on single-engine
    queue-bound rejections, which predate classes."""
    retryable = True
    http_status = 429

    def __init__(self, message: str, shed_class: Optional[int] = None):
        super().__init__(message)
        self.shed_class = shed_class


class DeadlineExceeded(ServingError):
    """The request's deadline passed (or provably would) before service."""
    http_status = 504


class ModelUnavailable(ServingError):
    """No such model, or the engine/batcher is shut down."""
    http_status = 404


class InvalidRequest(ServingError):
    """Feed names/shapes/dtypes don't fit any bucket of the model."""
    http_status = 400


class RequestFailed(ServingError):
    """The dispatcher failed while executing this request's batch; the
    original error is chained as __cause__ (never swallowed)."""

    def __init__(self, message: str, cause: Optional[BaseException] = None):
        super().__init__(message)
        if cause is not None:
            self.__cause__ = cause


def retryable(exc: BaseException) -> bool:
    """RetryPolicy(retry_on=...) predicate: retry only errors a later
    attempt can plausibly outrun (today: Overloaded)."""
    return bool(getattr(exc, "retryable", False))


class AdmissionController:
    """Bounded queue depth + deadline-aware shedding.

    `observe_batch` feeds an exponentially-decayed estimate of batch
    service seconds; `admit` uses it to estimate how long the queue ahead
    of a new request will take (`ceil(queued / max_batch) * est`) and
    rejects a deadline that estimate already blows. The estimate starts
    at None (no shedding-by-estimate until the first real batch) so a
    cold engine never rejects on a guess.
    """

    def __init__(self, queue_depth: int, max_batch_size: int,
                 default_deadline_ms: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self.queue_depth = queue_depth
        self.max_batch_size = max(1, int(max_batch_size))
        self.default_deadline_ms = float(default_deadline_ms)
        self.clock = clock
        self._lock = threading.Lock()
        self._batch_s: Optional[float] = None  # EWMA of batch service time

    # -- deadlines -----------------------------------------------------------
    def deadline_for(self, deadline_ms: Optional[float]) -> Optional[float]:
        """Absolute monotonic deadline for a request, or None. Falls back
        to the engine-wide default (PT_SERVE_DEADLINE_MS; 0 = none)."""
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        if not deadline_ms or deadline_ms <= 0:
            return None
        return self.clock() + deadline_ms / 1000.0

    # -- service-time estimate ----------------------------------------------
    def observe_batch(self, seconds: float) -> None:
        with self._lock:
            if self._batch_s is None:
                self._batch_s = seconds
            else:
                self._batch_s = 0.8 * self._batch_s + 0.2 * seconds

    def estimated_batch_s(self) -> Optional[float]:
        with self._lock:
            return self._batch_s

    # -- the admission decision ---------------------------------------------
    def admit(self, queued: int, deadline_t: Optional[float],
              model: str = "") -> None:
        """Raise Overloaded / DeadlineExceeded instead of enqueuing a
        request that cannot be served; return silently to admit."""
        if queued >= self.queue_depth:
            raise Overloaded(
                f"serving queue for {model!r} at capacity "
                f"({queued}/{self.queue_depth} queued)")
        if deadline_t is None:
            return
        now = self.clock()
        if now >= deadline_t:
            raise DeadlineExceeded(
                f"request deadline already expired at admission "
                f"(model {model!r})")
        est = self.estimated_batch_s()
        if est is not None and queued > 0:
            # batches ahead of this request, pessimistically one more for
            # the batch it will ride in
            batches_ahead = -(-queued // self.max_batch_size) + 1
            if now + batches_ahead * est > deadline_t:
                raise DeadlineExceeded(
                    f"deadline-aware shed: ~{batches_ahead} batches x "
                    f"{est * 1000:.1f} ms queued ahead exceed the "
                    f"{(deadline_t - now) * 1000:.1f} ms budget "
                    f"(model {model!r})")
