"""Fleet router: one front door over N replicas.

Dispatch policies (PT_FLEET_POLICY picks the default for sessionless
traffic; a request carrying a session key ALWAYS routes affine):

  least_loaded    min over healthy replicas of queue-depth x
                  EWMA-service-time (pool.Replica.load_score — the same
                  two numbers the pt_serve_* metrics export). Skewed
                  fleets (one slow replica) self-balance: the slow
                  replica's depth and EWMA both grow, so its score does.
  round_robin     rotate over healthy replicas — the baseline policy
                  to compare least_loaded against.
  session affine  rendezvous (highest-random-weight) hash of the
                  session key over healthy replica ids: a session keeps
                  hitting the replica that holds its paged KV blocks,
                  and a scale event only remaps the sessions whose
                  replica actually changed (adding a replica moves
                  ~1/n of sessions; removing one moves only ITS
                  sessions). Replica ids are stable across rebuilds, so
                  a rebuilt replica keeps its sessions.

Failover: a dispatch that dies with `RequestFailed` (the replica's
dispatcher crashed running the batch) retries once on the next-best
replica — the retry budget and the what-is-retryable predicate both
live on an injectable resilience.RetryPolicy — and the dead replica is
marked unhealthy and rebuilt off to the side (pool.mark_unhealthy).
Submit-time refusals (Overloaded / ModelUnavailable from a replica that
is draining, and the `router_dispatch` chaos site's injected crash)
roll to the next healthy replica immediately. A request is never failed
while an untried healthy replica remains, and never retried on a
replica it already failed on.

Priority admission is the WeightedFairQueue (fleet/admission.py): one
router-level queue, weighted-fair service across classes, strict
lowest-class-first shedding under overload.

Counterpart of ``paddle_tpu/serving/fleet/router.py``, copied with the JAX
package's names and structure: the tier is host code over the port's
``ServingEngine`` and imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

from ...obs import trace as obs_trace
from ...resilience import faults
from ...resilience.retry import RetryPolicy
from ..admission import (ModelUnavailable, Overloaded, RequestFailed,
                         ServingError)
from .admission import PendingRequest, WeightedFairQueue
from .metrics import FleetMetrics
from .pool import Replica, ReplicaPool

__all__ = ["FleetRouter", "POLICIES", "crash_failover"]

POLICIES = ("least_loaded", "round_robin")


def crash_failover(exc: BaseException) -> bool:
    """The default failover predicate: retry a request whose batch died
    with the dispatcher (RequestFailed) — never a typed rejection that
    would deterministically repeat (InvalidRequest) and never a result
    the client already owns."""
    return isinstance(exc, RequestFailed)


def _rendezvous(session: str, candidates: List[Replica]) -> Replica:
    """Highest-random-weight hash: stable per (session, rid), minimal
    remap under membership change."""
    def score(r: Replica) -> int:
        h = hashlib.blake2b(f"{session}|{r.rid}".encode(),
                            digest_size=8)
        return int.from_bytes(h.digest(), "big")
    return max(candidates, key=score)


class FleetRouter:
    """Priority-admitted, policy-routed front door over a ReplicaPool.

    >>> pool = ReplicaPool(loader, replicas=4)
    >>> router = FleetRouter(pool)
    >>> fut = router.submit("ranker", {"x": ex}, priority=1,
    ...                     session="user-42")
    >>> router.predict("ranker", {"x": ex})          # blocking
    """

    def __init__(self, pool: ReplicaPool, *,
                 policy: Optional[str] = None,
                 queue_depth: int = 1024,
                 class_weights: Optional[Dict[int, float]] = None,
                 default_deadline_ms: float = 0.0,
                 failover: Optional[RetryPolicy] = None,
                 metrics: Optional[FleetMetrics] = None,
                 name: str = "fleet"):
        if policy is None:
            policy = os.environ.get("PT_FLEET_POLICY", "").strip() \
                or "least_loaded"
        if policy not in POLICIES:
            raise ValueError(f"unknown fleet policy {policy!r} "
                             f"(choose from {POLICIES} — session "
                             "affinity is per-request, via session=)")
        self.pool = pool
        self.policy = policy
        self.name = name
        self.default_deadline_ms = float(default_deadline_ms)
        self.failover = failover or RetryPolicy(retries=1,
                                                retry_on=crash_failover)
        self.metrics = metrics or FleetMetrics(name)
        self.metrics.bind(pool=pool, router=self)
        self.metrics.register()
        # registration may have suffixed the name (two fleets in one
        # process): the router follows, so status/scrape/traces agree
        self.name = self.metrics.name
        pool.metrics = self.metrics
        self.autoscaler = None   # attached by make_fleet / caller
        self._wfq = WeightedFairQueue(queue_depth,
                                      class_weights=class_weights)
        self._cv = threading.Condition()
        self._rr = 0
        self._closed = False
        self._loop_done = False   # set under _cv at dispatcher exit
        self._drained = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"pt-fleet[{name}]")
        self._thread.start()

    # -- client side ---------------------------------------------------------
    def queue_depths(self) -> Dict[int, int]:
        with self._cv:
            return self._wfq.depths()

    def _deadline_t(self, deadline_ms: Optional[float]) -> Optional[float]:
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        if not deadline_ms or deadline_ms <= 0:
            return None
        return time.monotonic() + float(deadline_ms) / 1e3

    def submit(self, model: str, feeds, *, priority: int = 0,
               session: Optional[str] = None,
               deadline_ms: Optional[float] = None) -> Future:
        """Admit one request into the fleet queue; returns a Future.
        Overloaded raises HERE when this request is the shed victim
        (reject-fast, shed_class attached); a queued lower-class victim
        it displaced gets the same typed error on its Future."""
        item = PendingRequest(model, feeds, cls=priority,
                              session=session,
                              deadline_t=self._deadline_t(deadline_ms))
        self._model_of(model)   # reject-fast: unknown names never queue
        with self._cv:
            if self._closed or self._loop_done:
                # _loop_done without _closed = the dispatcher died
                # abnormally; queueing would hang the client forever
                raise ModelUnavailable(
                    f"fleet {self.name!r} is shut down")
            try:
                victim = self._wfq.offer(item)
            except Overloaded:
                self.metrics.on_shed(item.cls)
                raise
            self._cv.notify()
        if victim is not None:
            self.metrics.on_shed(victim.cls)
            if not victim.future.done():
                victim.future.set_exception(Overloaded(
                    f"shed from the fleet queue by a class-"
                    f"{item.cls} arrival (lowest-class-first)",
                    shed_class=victim.cls))
        return item.future

    def predict(self, model: str, feeds, *, priority: int = 0,
                session: Optional[str] = None,
                deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None) -> Dict:
        fut = self.submit(model, feeds, priority=priority,
                          session=session, deadline_ms=deadline_ms)
        if timeout is None and deadline_ms:
            timeout = deadline_ms / 1e3 + 30.0
        return fut.result(timeout=timeout)

    def generate(self, model: str, prompt_ids, *,
                 session: Optional[str] = None, **kw):
        """Route one generation request (decode plane). Session-affine
        when a session key rides along — decode sessions keep hitting
        the replica that holds their paged KV blocks; the decode
        engine's own continuous-batching admission takes it from there.
        Dispatch-time refusals fail over to the next-best replica."""
        tried: set = set()
        busy: Optional[Overloaded] = None
        crashed: Optional[RequestFailed] = None
        healed = False
        while True:
            replica = self._pick_for(session, tried)
            if replica is None:
                if not healed and self.pool.ensure_min():
                    healed = True   # crash-emptied pool re-grown
                    continue
                if busy is not None:
                    raise busy   # every replica full — typed, retryable
                if crashed is not None:
                    raise crashed   # exhaustion surfaces the ORIGINAL
                raise ModelUnavailable(
                    f"no healthy replica can serve {model!r}")
            try:
                faults.crash_point("router_dispatch")
                handle = replica.engine.generate(model, prompt_ids, **kw)
            except faults.FaultInjected as e:
                self._replica_crashed(replica, e)
                tried.add(replica.rid)
                crashed = RequestFailed(
                    f"replica {replica.rid!r} crashed dispatching a "
                    f"generation to {model!r}: {e}", cause=e)
                continue
            except Overloaded as e:
                busy = e
                tried.add(replica.rid)
                continue
            except ModelUnavailable:
                tried.add(replica.rid)
                continue
            self.metrics.on_dispatch(
                "session_affine" if session is not None else self.policy)
            return handle

    # -- routing -------------------------------------------------------------
    def _pick_for(self, session: Optional[str],
                  excluded: set) -> Optional[Replica]:
        candidates = [r for r in self.pool.replicas()
                      if r.rid not in excluded]
        if not candidates:
            return None
        if session is not None:
            return _rendezvous(session, candidates)
        if self.policy == "round_robin":
            self._rr += 1
            return candidates[self._rr % len(candidates)]
        return min(candidates, key=lambda r: r.load_score())


    # -- dispatcher side -----------------------------------------------------
    def _loop(self) -> None:
        backoff = False
        try:
            while True:
                with self._cv:
                    if backoff:
                        # every replica queue was full a moment ago:
                        # poll — replica slots free when their batches
                        # complete (no cross-engine notification)
                        self._cv.wait(0.002)
                        backoff = False
                    while True:
                        item = self._wfq.pop()
                        if item is not None:
                            break
                        if self._closed:
                            # flagged under _cv so a late failover
                            # requeue can never land in a queue no
                            # thread will pop again
                            self._loop_done = True
                            return
                        self._cv.wait(0.5)
                try:
                    requeue = not self._dispatch(item)
                except BaseException as e:  # noqa: BLE001 — contained
                    # per-request containment, the batcher's lesson at
                    # router altitude: one poisoned request fails ITS
                    # future typed; the dispatcher thread keeps serving
                    if not item.future.done():
                        item.future.set_exception(RequestFailed(
                            f"fleet dispatch failed for "
                            f"{item.model!r}: {e}", cause=e))
                    self.metrics.on_done(False)
                    continue
                if requeue:
                    with self._cv:
                        self._wfq.push_front(item)
                    backoff = True
        finally:
            # on EVERY exit path — including an abnormal death the
            # per-item containment didn't cover — flag the loop done
            # under the cv, so submit() refuses new work and _requeue
            # fails over typed instead of feeding a queue nothing pops
            with self._cv:
                self._loop_done = True
            self._drained.set()

    def _requeue(self, item: PendingRequest) -> None:
        with self._cv:
            if not self._loop_done:
                self._wfq.push_front(item)
                self._cv.notify()
                return
        # the dispatcher already exited (shutdown raced this failover):
        # stranding the future in a dead queue would hang the client
        # forever — fail typed and retryable instead
        if not item.future.done():
            item.future.set_exception(Overloaded(
                f"fleet {self.name!r} shut down while failing over "
                f"{item.model!r}", shed_class=item.cls))
        self.metrics.on_done(False)

    def _dispatch(self, item: PendingRequest) -> bool:
        """Route one request to a replica; called from the dispatcher
        loop AND from failover callbacks (replica dispatcher threads).
        Returns False when the whole fleet is momentarily saturated
        (every healthy replica refused Overloaded) — the caller
        re-queues the request at the head of its class, so backpressure
        backs the FLEET queue up and the shed machinery engages there;
        a request is never failed over a transient full queue."""
        now = time.monotonic()
        if item.deadline_t is not None and now >= item.deadline_t:
            self.metrics.on_shed(item.cls, kind="deadline")
            if not item.future.done():
                from ..admission import DeadlineExceeded
                item.future.set_exception(DeadlineExceeded(
                    f"request spent {(now - item.t_enqueue) * 1e3:.1f} "
                    "ms in the fleet queue, past its deadline"))
            return True
        refused: set = set()
        busy = False
        healed = False
        while True:
            replica = self._pick_for(item.session,
                                     item.tried | refused)
            if replica is None:
                if busy:
                    return False    # saturated, not dead: requeue
                if not healed and self.pool.ensure_min():
                    # a crash-surrendered pool below its floor just
                    # minted fresh replicas (new ids, never in tried)
                    healed = True
                    continue
                if not item.future.done():
                    # exhaustion re-raises the ORIGINAL typed error
                    # (a single-replica fleet whose dispatcher crashed
                    # surfaces RequestFailed, never a 404 wrapper)
                    item.future.set_exception(
                        item.last_error if item.last_error is not None
                        else ModelUnavailable(
                            f"no healthy replica left to serve "
                            f"{item.model!r} "
                            f"(tried {sorted(item.tried)})"))
                self.metrics.on_done(False)
                return True
            remaining_ms = None
            if item.deadline_t is not None:
                remaining_ms = max(
                    (item.deadline_t - time.monotonic()) * 1e3, 1.0)
            try:
                faults.crash_point("router_dispatch")
                fut = replica.engine.submit(item.model, item.feeds,
                                            deadline_ms=remaining_ms)
            except faults.FaultInjected as e:
                # the chaos harness's deterministic replica crash at
                # dispatch: treat exactly like a dead dispatcher (the
                # typed surface a real dispatch crash would carry)
                self._replica_crashed(replica, e)
                item.tried.add(replica.rid)
                item.last_error = RequestFailed(
                    f"replica {replica.rid!r} crashed dispatching to "
                    f"model {item.model!r}: {e}", cause=e)
                continue
            except Overloaded:
                # this replica's queue is full — it is healthy, just
                # busy; never counts against the failover budget
                refused.add(replica.rid)
                busy = True
                continue
            except ModelUnavailable:
                # draining or mid-swap: roll to the next replica
                refused.add(replica.rid)
                continue
            except ServingError as e:
                if not item.future.done():
                    item.future.set_exception(e)
                self.metrics.on_done(False)
                return True
            self.metrics.on_dispatch(
                "session_affine" if item.session is not None
                else self.policy)
            fut.add_done_callback(
                lambda f, it=item, r=replica: self._on_result(it, r, f))
            return True

    def _replica_crashed(self, replica: Replica, exc: BaseException):
        self.metrics.on_failover()
        # pass the exact object: a straggler failure surfacing after
        # this slot was already rebuilt must not condemn the new engine
        self.pool.mark_unhealthy(replica.rid,
                                 cause=f"{type(exc).__name__}: {exc}",
                                 replica=replica)

    def _on_result(self, item: PendingRequest, replica: Replica,
                   fut: Future) -> None:
        exc = fut.exception()
        if exc is None:
            if not item.future.done():
                item.future.set_result(fut.result())
            self.metrics.on_done(True)
            return
        if (self.failover.should_retry(exc)
                and item.result_retries < self.failover.retries):
            # the replica's dispatcher died running this batch: mark it
            # unhealthy (rebuilt off to the side) and retry once on the
            # next-best replica
            item.result_retries += 1
            item.tried.add(replica.rid)
            item.last_error = exc
            self._replica_crashed(replica, exc)
            obs_trace.instant("fleet_failover", cat="fleet",
                              model=item.model, replica=replica.rid)
            if not self._dispatch(item):
                self._requeue(item)
            return
        if not item.future.done():
            item.future.set_exception(exc)
        self.metrics.on_done(False)

    # -- front-end surface (http.py serves a fleet like an engine) ----------
    is_fleet = True

    def models(self) -> Dict[str, dict]:
        for replica in self.pool.replicas():
            return replica.engine.models()
        return {}

    def _model_of(self, model: str):
        """The loaded model object behind `model` on any replica, or
        raise ModelUnavailable — the fleet keeps the single-engine
        reject-fast contract: a name no replica serves must never
        consume a queue slot (or shed a real request). Unhealthy
        replicas still count as catalog (a fleet mid-rebuild knows
        what it serves; the request queues and waits, it isn't a
        404)."""
        replicas = self.pool.all_replicas()
        if not replicas and self.pool.ensure_min():
            # a crash-emptied pool has no catalog to consult: heal to
            # the floor first — "the loader is down" must read as a
            # recoverable outage, not model-not-found
            replicas = self.pool.all_replicas()
        for replica in replicas:
            try:
                return replica.engine.registry.get(model).model
            except ModelUnavailable:
                continue
        raise ModelUnavailable(
            f"no replica of fleet {self.name!r} serves {model!r}")

    def model_info(self, model: str) -> tuple:
        """(feed_dtypes, version) in ONE catalog walk — the HTTP
        predict path needs both per request; walking the pool twice
        (plus submit's own reject-fast walk) would triple the registry
        lock traffic for the same answer."""
        m = self._model_of(model)
        fd = getattr(m, "feed_dtypes", None)
        return (fd() if callable(fd) else {},
                getattr(m, "version", None))

    def feed_dtypes(self, model: str) -> dict:
        return self.model_info(model)[0]

    def model_version(self, model: str) -> Optional[int]:
        return self.model_info(model)[1]

    def load_model(self, name: str, model_dir: str, **kw) -> int:
        """Fleet-wide (hot) reload: every replica swaps, each under the
        single-engine zero-drop contract."""
        ver = 0
        for replica in self.pool.all_replicas():
            ver = replica.engine.load_model(name, model_dir, **kw)
        return ver

    def status(self) -> dict:
        out = {
            "name": self.name,
            "policy": self.policy,
            "replicas": self.pool.health(),
            "min_replicas": self.pool.min_replicas,
            "max_replicas": self.pool.max_replicas,
            "queue": {str(c): n for c, n in
                      self.queue_depths().items()},
        }
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.describe()
        return out

    def metrics_snapshot(self) -> dict:
        """One pane for the whole tier: the fleet section + every
        replica's serving sections, namespaced by replica id (the
        multi-replica scrape stays duplicate-series-free), + the
        process-wide registry sections merged ONCE."""
        from ...obs.metrics import REGISTRY
        out: Dict[str, dict] = {"models": {}, "decode": {}}
        for replica in self.pool.all_replicas():
            # each snapshot already carries its replica id — the pool
            # stamps engine.metrics.replica at build; ONE mechanism
            snap = replica.engine.metrics.snapshot(merge_registry=False)
            for section in ("models", "decode"):
                for mname, msnap in snap.get(section, {}).items():
                    out[section][f"{replica.rid}/{mname}"] = msnap
        if not out["decode"]:
            del out["decode"]
        for section, snaps in REGISTRY.snapshot().items():
            if snaps:
                out.setdefault(section, snaps)
        return out

    # -- shutdown ------------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
        with self._cv:
            if self._closed:
                return
            self._closed = True
            backlog = [] if drain else self._wfq.drain()
            self._cv.notify()
        for item in backlog:
            if not item.future.done():
                item.future.set_exception(ModelUnavailable(
                    f"fleet {self.name!r} shut down before dispatch"))
        self._drained.wait(30.0)
        self._thread.join(5.0)
        self.pool.close(drain=drain)
        self.metrics.unregister()

    shutdown = close
