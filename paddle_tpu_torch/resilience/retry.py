"""Bounded retry with exponential backoff + jitter, and the reader-restart
wrapper built on it.

One retry primitive for the whole package (checkpoint I/O, reader
restarts) instead of ad-hoc loops: the policy is a value (bounded
attempts, capped backoff, seeded jitter, a predicate for *which* errors
are worth retrying, an optional total-time deadline), and exhaustion
always re-raises the ORIGINAL error — a retry layer that replaces the
root cause with its own exception is a debugging hazard.

Copied from ``paddle_tpu/resilience/retry.py``; the port carries its own
copy because it never imports the JAX package. One seed gives the same
jitter sequence in both packages (``random.Random`` keyed by the seed).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterable, Optional, Tuple, Union

from . import faults

__all__ = ["RetryPolicy", "retry_call", "resilient_reader"]


class RetryPolicy:
    """How to retry: `retries` additional attempts after the first, delay
    ``base_delay * 2**k`` capped at `max_delay`, each scaled by a seeded
    jitter factor in [1, 1+jitter] (decorrelates a fleet of preempted
    workers hammering shared storage in lockstep). `retry_on` is an
    exception class/tuple or a predicate ``exc -> bool``; `deadline`
    (seconds of total elapsed time, None = unbounded) stops retrying even
    with attempts left. `sleep`/`clock` are injectable for tests."""

    def __init__(self, retries: int = 3, base_delay: float = 0.05,
                 max_delay: float = 2.0, jitter: float = 0.5,
                 retry_on: Union[type, Tuple[type, ...],
                                 Callable[[BaseException], bool]] = Exception,
                 deadline: Optional[float] = None, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        if retries < 0:
            raise ValueError("retries must be >= 0")
        self.retries = retries
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.jitter = jitter
        self.retry_on = retry_on
        self.deadline = deadline
        self.seed = seed
        self.sleep = sleep
        self.clock = clock

    def should_retry(self, exc: BaseException) -> bool:
        if callable(self.retry_on) and not isinstance(self.retry_on, type):
            return bool(self.retry_on(exc))
        return isinstance(exc, self.retry_on)

    def delays(self) -> Iterable[float]:
        """The backoff schedule, one delay per retry attempt."""
        rng = random.Random(f"{self.seed}:backoff")
        for k in range(self.retries):
            d = min(self.base_delay * (2.0 ** k), self.max_delay)
            yield d * (1.0 + self.jitter * rng.random())


class _Attempts:
    """Shared retry bookkeeping for retry_call and resilient_reader: one
    place decides retry-vs-reraise (filter, attempt budget, deadline) so
    the two loop shapes can never drift apart."""

    def __init__(self, policy: Optional[RetryPolicy],
                 on_retry: Optional[Callable]):
        self.policy = policy
        self.on_retry = on_retry
        self.n = 0
        self._delays = iter(policy.delays()) if policy is not None \
            else iter(())
        self._start = policy.clock() if policy is not None else 0.0

    def backoff_or_reraise(self, exc: BaseException) -> None:
        """Called from an except block: either sleeps the next backoff
        delay (recording the attempt, invoking on_retry) or re-raises the
        exception being handled — on a non-retryable error, attempt
        exhaustion, or a blown deadline."""
        p = self.policy
        if p is None or not p.should_retry(exc):
            raise
        delay = next(self._delays, None)
        if delay is None:
            raise
        if (p.deadline is not None
                and p.clock() - self._start + delay > p.deadline):
            raise
        self.n += 1
        if self.on_retry is not None:
            self.on_retry(exc, self.n, delay)
        p.sleep(delay)


def retry_call(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
               on_retry: Optional[Callable] = None, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying per `policy`. `on_retry` is
    invoked as ``on_retry(exc, attempt, delay)`` before each backoff
    sleep. Exhaustion (attempts or deadline) re-raises the original
    error."""
    attempts = _Attempts(policy or RetryPolicy(), on_retry)
    while True:
        try:
            return fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — filtered just below
            attempts.backoff_or_reraise(e)


def resilient_reader(reader: Callable, policy: Optional[RetryPolicy] = None,
                     on_retry: Optional[Callable] = None) -> Callable:
    """Wrap a reader (a callable returning an iterator of batches) so that
    an exception mid-epoch restarts it — re-invoking `reader()` and
    fast-forwarding past the batches already delivered, so the consumer
    sees each batch exactly once, in order, with no duplicates.

    This is the trainer's reader fault boundary: every delivered batch
    passes the ``reader_raise`` injection site (faults.py), INSIDE the
    retried region, so ``PT_FAULT_INJECT=reader_raise@N`` exercises
    exactly the restart machinery a flaky data source would. With
    ``policy=None`` the wrapper only hosts the fault site — no retries,
    errors propagate unchanged.

    Fast-forward replays the source's batches without delivering them:
    correct for deterministic readers (files, RecordIO, seeded shuffles);
    a nondeterministic source resumes on a *different* stream, which is
    exactly what it would give a fresh process too. A reader exposing
    ``iter_from(n)`` (the data-pipeline protocol, data/pipeline.py) fast-
    forwards through it instead — the skipped batches are never decoded.

    The wrapper is itself skippable (``wrapped.iter_from(n)`` starts with
    n batches already delivered — the Trainer's mid-epoch resume path)
    and forwards the pipeline's ``set_epoch``/``state`` surface, so a
    wrapped pipeline keeps its deterministic-resume contract."""

    cheap_skip = hasattr(reader, "iter_from")

    def wrapped(start: int = 0):
        delivered = int(start)
        attempts = _Attempts(policy, on_retry)
        while True:
            try:
                # freeze the fast-forward target: `delivered` grows as
                # this attempt yields, but only batches delivered by
                # PRIOR attempts (or the caller's `start`) are skipped
                to_skip = delivered
                if to_skip and cheap_skip:
                    it = reader.iter_from(to_skip)
                    skipped = to_skip
                else:
                    it = reader()
                    skipped = 0
                for item in it:
                    if skipped < to_skip:
                        skipped += 1
                        continue
                    faults.crash_point("reader_raise")
                    delivered += 1
                    yield item
                return
            except BaseException as e:  # noqa: BLE001 — filtered below
                attempts.backoff_or_reraise(e)

    wrapped.iter_from = wrapped
    for attr in ("set_epoch", "state", "restore", "metrics_snapshot"):
        if hasattr(reader, attr):
            setattr(wrapped, attr, getattr(reader, attr))
    #: True only when a budget is ARMED — double_buffer's stacking
    #: detection keys on this (a policy-less wrapper just hosts the
    #: fault site and stacks harmlessly)
    wrapped._pt_resilient = policy is not None
    return wrapped
