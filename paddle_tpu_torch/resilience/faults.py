"""Deterministic, seeded fault injection behind the PT_FAULT_INJECT knob.

Chaos runs and the resilience test suite need to crash the system at a
*named* point — mid-save, at the checkpoint commit, inside the reader, at
a trainer step boundary — without monkeypatching internals. Each such
point in the codebase calls ``crash_point(site)`` (or ``fire(site)`` when
the fault is a side effect rather than an exception, e.g. truncating a
write); with no plan armed these calls are a dict lookup and an early
return.

Grammar (the whole plan lives in one env var so a chaos run is just a
prefix on the launch command)::

    PT_FAULT_INJECT="io_write_truncate@3,step_crash@7,reader_raise@2:seed=0"

    plan    := spec (',' spec)* [':seed=' INT]
    spec    := site '@' trigger
    trigger := INT        one-shot: fire on the Nth hit of the site (1-based)
             | '*'        fire on every hit
             | 'p' FLOAT  fire each hit with probability FLOAT (seeded)

The same site may appear multiple times (``reader_raise@2,reader_raise@5``
fires on hits 2 and 5). Probabilistic triggers draw from a per-site
``random.Random`` seeded from ``seed`` + the site name, so a plan replays
identically across runs — determinism is the whole point: a chaos failure
must be reproducible by re-running with the same plan string.

Sites (the registry below is closed on purpose: a typo in a plan is an
error, not a silently-never-firing spec):

    io_crash            _atomic_save, before any bytes are written
    io_write_truncate   _atomic_save: half the bytes reach the final name,
                        then the "process dies" (torn write + crash)
    commit_crash        save_checkpoint, after all data is on disk but
                        before the _SUCCESS marker
    reader_raise        per batch inside the resilient reader wrapper
                        (retry.resilient_reader — the trainer data path)
    step_crash          Trainer.train, at the top of each step
    nan_loss            in-graph (guard.py): the step's loss becomes NaN
                        — hit once per GUARDED dispatch
    nan_grad            in-graph (guard.py): every parameter gradient
                        becomes NaN — hit once per GUARDED dispatch
    step_hang           watchdog.py: the device step never settles — hit
                        only when PT_STEP_DEADLINE_S is armed (an
                        unwatched injected hang would hang the run)
    serve_dispatch      serving/batcher.py: per flushed batch inside the
                        micro-batcher's dispatcher loop — the batch's
                        requests fail with a typed RequestFailed and the
                        loop keeps serving
    device_loss         Trainer.train, at the top of each step: one chip
                        drops out of the mesh (preemptible-VM eviction) —
                        the elastic supervisor re-plans on one fewer chip
    mesh_shrink         Trainer.train, at the top of each step: the mesh
                        halves (a host is preempted) — the elastic
                        supervisor re-plans on the surviving topology
    worker_crash        orchestrator.peer_worker, per heartbeat: the
                        worker dies (dead handle -> evicted as a crash)
    heartbeat_loss      orchestrator.peer_worker, per heartbeat: the
                        worker goes silent but stays alive (hung
                        collective -> killed, evicted as heartbeat_loss)

Copied from ``paddle_tpu/resilience/faults.py``; the port
carries its own copy because it never imports the JAX package.
"""

from __future__ import annotations

import os
import random
import re
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["SITES", "FaultInjected", "FaultPlan", "active_plan",
           "crash_point", "fire", "reset"]

#: site -> description; the parser rejects anything else
SITES: Dict[str, str] = {
    "io_crash": "crash in _atomic_save before writing",
    "io_write_truncate": "torn write: truncated bytes reach the final "
                         "name, then crash",
    "commit_crash": "crash after checkpoint data, before _SUCCESS",
    "reader_raise": "raise from the reader iteration (retried region)",
    "step_crash": "crash at a trainer step boundary",
    "nan_loss": "in-graph: the step's loss becomes NaN (guarded runs)",
    "nan_grad": "in-graph: every parameter gradient becomes NaN "
                "(guarded runs)",
    "step_hang": "the device step never settles (armed watchdog only)",
    "serve_dispatch": "crash inside the serving micro-batcher's "
                      "dispatcher loop, per flushed batch "
                      "(serving/batcher.py)",
    "router_dispatch": "replica crash at fleet-router dispatch, per "
                       "routed request (serving/fleet/router.py): the "
                       "router fails over to the next-best replica and "
                       "rebuilds the crashed one",
    "device_loss": "one chip drops out of the mesh at a trainer step "
                   "boundary (preemptible eviction); the elastic "
                   "supervisor re-plans on one fewer chip",
    "mesh_shrink": "the mesh halves at a trainer step boundary (host "
                   "preemption); the elastic supervisor re-plans on "
                   "the surviving topology",
    "worker_crash": "orchestrated worker dies at a heartbeat boundary "
                    "(resilience/orchestrator.py): the supervisor sees "
                    "a dead handle and evicts with cause worker_crash",
    "heartbeat_loss": "orchestrated worker stops renewing its lease but "
                      "stays alive — the hung-collective case "
                      "(resilience/orchestrator.py): the supervisor "
                      "kills it and evicts with cause heartbeat_loss",
    "spec_verify": "drafter crash mid-step at the speculative-decode "
                   "draft gathering point (serving/decode/scheduler.py "
                   "_gather_drafts): the scheduler falls back to plain "
                   "decode for that sequence's step — output stays "
                   "token-identical, the session survives",
}

ENV_VAR = "PT_FAULT_INJECT"


class FaultInjected(RuntimeError):
    """The injected failure. Deliberately a plain RuntimeError subclass:
    production code must treat it like any crash — anything that
    special-cases it would be testing a path real failures never take."""

    def __init__(self, site: str, hit: int):
        self.site = site
        self.hit = hit
        super().__init__(f"injected fault {site!r} (hit {hit})")


class _Trigger:
    __slots__ = ("kind", "at", "prob")

    def __init__(self, kind: str, at: int = 0, prob: float = 0.0):
        self.kind = kind      # "nth" | "every" | "prob"
        self.at = at
        self.prob = prob


class FaultPlan:
    """A parsed plan: per-site hit counters + triggers. Thread-safe —
    reader faults fire from prefetch worker threads."""

    def __init__(self, triggers: Dict[str, List[_Trigger]], seed: int = 0,
                 spec: str = ""):
        self.spec = spec
        self.seed = seed
        self._triggers = triggers
        self._hits: Dict[str, int] = {}
        self._rng: Dict[str, random.Random] = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        seed = 0
        body = spec.strip()
        m = re.search(r":seed=(\d+)$", body)
        if m:
            seed = int(m.group(1))
            body = body[:m.start()]
        triggers: Dict[str, List[_Trigger]] = {}
        for part in filter(None, (p.strip() for p in body.split(","))):
            sm = re.fullmatch(r"([a-z_]+)@(\*|p[0-9.]+|\d+)", part)
            if not sm:
                raise ValueError(
                    f"{ENV_VAR}: malformed spec {part!r} (want "
                    "site@N | site@* | site@pFLOAT)")
            site, trig = sm.group(1), sm.group(2)
            if site not in SITES:
                raise ValueError(
                    f"{ENV_VAR}: unknown site {site!r} (known: "
                    f"{', '.join(sorted(SITES))})")
            if trig == "*":
                t = _Trigger("every")
            elif trig.startswith("p"):
                p = float(trig[1:])
                if not 0.0 <= p <= 1.0:
                    raise ValueError(
                        f"{ENV_VAR}: probability out of [0,1] in {part!r}")
                t = _Trigger("prob", prob=p)
            else:
                n = int(trig)
                if n < 1:
                    raise ValueError(
                        f"{ENV_VAR}: hit index is 1-based in {part!r}")
                t = _Trigger("nth", at=n)
            triggers.setdefault(site, []).append(t)
        return cls(triggers, seed=seed, spec=spec)

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def fire(self, site: str) -> Optional[int]:
        """Record one hit of `site`; return the hit index if a trigger
        fires, else None."""
        if site not in SITES:
            raise KeyError(f"unregistered fault site {site!r}")
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            for t in self._triggers.get(site, ()):
                if t.kind == "every":
                    return hit
                if t.kind == "nth" and t.at == hit:
                    return hit
                if t.kind == "prob":
                    rng = self._rng.get(site)
                    if rng is None:
                        # string seeding is deterministic in python 3
                        # (sha512), independent of PYTHONHASHSEED
                        rng = self._rng[site] = random.Random(
                            f"{self.seed}:{site}")
                    if rng.random() < t.prob:
                        return hit
        return None


_EMPTY = FaultPlan({}, spec="")
_cache: Tuple[Optional[str], FaultPlan] = (None, _EMPTY)
_cache_lock = threading.Lock()


def active_plan() -> FaultPlan:
    """The plan for the current PT_FAULT_INJECT value. Parsed once per
    distinct env value; counters persist while the value is unchanged."""
    global _cache
    spec = os.environ.get(ENV_VAR)
    with _cache_lock:
        if spec == _cache[0]:
            return _cache[1]
        plan = _EMPTY if not spec else FaultPlan.parse(spec)
        _cache = (spec, plan)
        return plan


def reset() -> None:
    """Drop the cached plan (counters restart on next use). Tests."""
    global _cache
    with _cache_lock:
        _cache = (None, _EMPTY)


def fire(site: str) -> Optional[int]:
    """Hit `site`; return the hit index if the plan triggers, else None.
    For sites whose fault is a side effect (e.g. truncating a write)."""
    plan = active_plan()
    if not plan._triggers:
        return None
    return plan.fire(site)


def crash_point(site: str) -> None:
    """Hit `site`; raise FaultInjected when the plan triggers."""
    hit = fire(site)
    if hit is not None:
        raise FaultInjected(site, hit)
