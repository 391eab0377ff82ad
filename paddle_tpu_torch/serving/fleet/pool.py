"""Replica pool: N worker replicas, each a full ServingEngine.

One `ServingEngine` in one process is one dispatcher thread per model —
correct, but a single engine cannot be "millions of users". The pool
hosts N engines (replicas) side by side in this process, each with its
own batcher/registry/metrics, so a router (fleet/router.py) can spread
independent requests across N concurrent dispatch pipelines. Replicas
are thread-hosted (the engines' own dispatcher threads), all on the
pool's one device: on the card their dispatcher and decode scheduler
threads launch onto the same device, each on the stream current in its
thread (the default stream), and the kernels' per-stream scratch is
guarded (kernels/flash_attention.py). The CPU tests run the whole tier
with ``device="cpu"``.

Health is NOT a second bookkeeping path: a replica's queue depth is the
same `ModelMetrics.queue_depth` gauge its `pt_serve_*` exposition
exports, and its service-time estimate is the same admission EWMA that
deadline shedding uses (serving/admission.py observe_batch). The router
and the autoscaler read the numbers the metrics plane already
maintains: the router is the metrics plane's first consumer.

Scale contract (the registry's build-warm-swap-drain contract, at
replica granularity):

  scale UP    new engines are built + model-loaded (warmup included)
              entirely off to the side; they join the routing set only
              once serving-ready — a scale-up can slow nothing down.
  scale DOWN  the retiring replica leaves the routing set FIRST, then
              its engine is shut down with drain=True: every request
              already queued on it is served before release. Zero
              in-flight futures are dropped, by construction.
  rebuild     a replica marked unhealthy (router failover on a crashed
              dispatch) leaves the routing set immediately; a fresh
              engine is built off to the side on a background thread
              and swaps into the same replica id (session affinity
              keys on the id, so rebuilt replicas keep their
              sessions). The old engine still drains what it can.

Knob defaults (constructor args win): PT_FLEET_REPLICAS initial size,
PT_FLEET_MIN / PT_FLEET_MAX the scale bounds.

Counterpart of ``paddle_tpu/serving/fleet/pool.py``, copied with the JAX
package's names and structure: the tier is host code over the port's
``ServingEngine`` and imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ...core.types import resolve_device
from ...obs import trace as obs_trace
from .. import ServingEngine
from ..batcher import env_int

__all__ = ["Replica", "ReplicaPool", "REBUILD_ATTEMPTS"]

#: bounded rebuild retries (short exponential backoff between) before a
#: crashed replica's slot is surrendered
REBUILD_ATTEMPTS = 3

#: least-loaded scoring needs a service-time guess before the first
#: real batch lands (admission's EWMA starts at None); 1 ms keeps the
#: score ordered by queue depth alone until a real estimate exists
DEFAULT_SERVICE_S = 1e-3


class Replica:
    """One worker: a replica id + the ServingEngine it hosts. The id is
    the stable routing identity — a rebuilt replica keeps its id (and
    therefore its affine sessions); the engine behind it is disposable.
    """

    __slots__ = ("rid", "engine", "healthy")

    def __init__(self, rid: str, engine: ServingEngine):
        self.rid = rid
        self.engine = engine
        self.healthy = True

    # -- the health signal (read from the metrics plane) ---------------------
    def signals(self) -> tuple:
        """(queue_depth, ewma_s) in ONE registry walk — the router's
        least-loaded score reads both per candidate per dispatch, so
        the walk (and its per-model lock traffic) happens once. Depth
        is the same per-model queue_depth gauge pt_serve_* exports,
        summed; the estimate is the largest per-model admission EWMA
        of batch service seconds (None until any model has served a
        batch)."""
        depth = 0
        est: Optional[float] = None
        for name in self.engine.registry.names():
            depth += max(0,
                         int(self.engine.metrics.model(name).queue_depth))
            try:
                s = self.engine.registry.get(name).batcher \
                    .service_estimate_s()
            except Exception:   # noqa: BLE001 — racing an unload
                continue
            if s is not None and (est is None or s > est):
                est = s
        return depth, est

    def queue_depth(self) -> int:
        return self.signals()[0]

    def service_estimate_s(self) -> Optional[float]:
        return self.signals()[1]

    def load_score(self) -> float:
        """queue-depth x EWMA-service-time: the least-loaded ranking
        key. +1 on depth so an idle replica with a slow history still
        ranks by its service time, not at exactly zero."""
        depth, est = self.signals()
        return (depth + 1) * (est if est is not None
                              else DEFAULT_SERVICE_S)

    def decode_residency(self) -> Optional[dict]:
        """Shared-KV residency + speculative acceptance, summed over
        this replica's decode engines (None when it hosts none). A
        session's cached prefix is replica-local state the rendezvous
        hash should respect: the router already keys sessions onto
        replica ids; this makes the *value* of that affinity (resident
        shared blocks, warm prefix index) visible next to queue depth
        in the same health dict operators and the autoscaler read."""
        engines = {name: eng
                   for name, eng in self.engine.decode_engines().items()
                   if hasattr(eng, "kv_residency")}  # duck-typed fakes
        if not engines:
            return None
        out = {"kv_blocks_shared": 0, "kv_blocks_in_use": 0,
               "kv_blocks_indexed": 0, "prefix_hits": 0,
               "prefix_hit_tokens": 0}
        drafted = accepted = 0
        for eng in engines.values():
            for key, val in eng.kv_residency().items():
                out[key] = out.get(key, 0) + int(val)
            snap = eng.metrics.snapshot()
            drafted += int(snap.get("spec_drafted", 0) or 0)
            accepted += int(snap.get("spec_accepted", 0) or 0)
        out["spec_acceptance_rate"] = (round(accepted / drafted, 4)
                                       if drafted else None)
        return out

    def health(self) -> dict:
        depth, est = self.signals()
        out = {"queue_depth": depth,
               "ewma_ms": None if est is None else round(est * 1e3, 3),
               "healthy": bool(self.healthy)}
        decode = self.decode_residency()
        if decode is not None:
            out["decode"] = decode
        return out


class ReplicaPool:
    """N replicas behind one build/scale/rebuild lifecycle.

    `loader(engine, rid)` populates a fresh engine with this fleet's
    models (load_model / load_model_object / load_decode_model) — the
    pool stays free of model-source policy, exactly like the registry
    stays free of queueing policy.
    """

    def __init__(self, loader: Callable[[ServingEngine, str], None], *,
                 replicas: Optional[int] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 engine_opts: Optional[dict] = None,
                 metrics=None, device=None):
        self._loader = loader
        #: every replica's engine runs here: the first CUDA device unless
        #: the caller names another; without a card the default raises
        self.device = resolve_device(device)
        self._engine_opts = dict(engine_opts or {})
        self.min_replicas = max(1, env_int("PT_FLEET_MIN", 1)
                                if min_replicas is None
                                else int(min_replicas))
        self.max_replicas = max(self.min_replicas,
                                env_int("PT_FLEET_MAX", 8)
                                if max_replicas is None
                                else int(max_replicas))
        n = (env_int("PT_FLEET_REPLICAS", 1) if replicas is None
             else int(replicas))
        n = min(max(n, self.min_replicas), self.max_replicas)
        self.metrics = metrics
        self._lock = threading.Lock()
        #: serializes scale/rebuild transitions (builds run unlocked)
        self._scale_lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}
        self._next_id = 0
        self._closed = False
        try:
            self.scale_to(n, reason="initial")
        except BaseException:
            # a later replica's build failed mid-scale: the ones
            # already published must not leak their dispatcher threads
            # for the process lifetime (the make_fleet lesson, at pool
            # altitude)
            self.close(drain=False)
            raise

    # -- introspection -------------------------------------------------------
    def replicas(self) -> List[Replica]:
        """Routing candidates: healthy replicas, in stable id order."""
        with self._lock:
            reps = sorted(self._replicas.values(),
                          key=lambda r: int(r.rid[1:]))
        return [r for r in reps if r.healthy]

    def all_replicas(self) -> List[Replica]:
        with self._lock:
            return sorted(self._replicas.values(),
                          key=lambda r: int(r.rid[1:]))

    def get(self, rid: str) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(rid)

    def size(self) -> int:
        with self._lock:
            return len(self._replicas)

    def health(self) -> Dict[str, dict]:
        return {r.rid: r.health() for r in self.all_replicas()}

    # -- lifecycle -----------------------------------------------------------
    def _build(self, rid: str) -> Replica:
        engine = ServingEngine(device=self.device, **self._engine_opts)
        # namespace this engine's pt_serve_*/pt_decode_* series: two
        # replicas serving the same model name must scrape as distinct
        # series (serving/metrics.py replica label)
        engine.metrics.replica = rid
        try:
            self._loader(engine, rid)
        except BaseException:
            engine.shutdown(drain=False)
            raise
        return Replica(rid, engine)

    def scale_to(self, n: int, reason: str = "") -> int:
        """Grow or shrink to `n` replicas (clamped to [min, max]).
        Returns the resulting size. Scale-down BLOCKS until the retiring
        replicas have drained — callers on a control loop get zero-drop
        for free; nobody races a half-dead replica because it leaves the
        routing set before its drain begins."""
        with self._scale_lock:
            return self._scale_locked(n, reason)

    def _scale_locked(self, n: int, reason: str) -> int:
        """scale_to's body; caller holds _scale_lock."""
        if self._closed:
            return self.size()
        n = min(max(int(n), self.min_replicas), self.max_replicas)
        # -- up: build off to the side, publish when serving-ready
        while self.size() < n:
            with self._lock:
                rid = f"r{self._next_id}"
                self._next_id += 1
            replica = self._build(rid)
            with self._lock:
                self._replicas[rid] = replica
            obs_trace.instant("fleet_replica_up", cat="fleet",
                              replica=rid, reason=reason,
                              replicas=self.size())
        # -- down: newest-first leaves routing, then drains
        retiring: List[Replica] = []
        with self._lock:
            while len(self._replicas) > n:
                rid = max(self._replicas,
                          key=lambda r: int(r[1:]))
                rep = self._replicas.pop(rid)
                rep.healthy = False
                retiring.append(rep)
        for rep in retiring:
            rep.engine.shutdown(drain=True)
            obs_trace.instant("fleet_replica_down", cat="fleet",
                              replica=rep.rid, reason=reason,
                              replicas=self.size())
        return self.size()

    def ensure_min(self) -> bool:
        """Heal toward min_replicas: a pool left below the floor by
        crash-surrendered slots (every rebuild attempt failed) mints
        fresh replicas as soon as the loader works again. Returns True
        when replicas were actually added; False when nothing was
        needed, the loader is still refusing, or a scale operation is
        already in flight. NEVER blocks on the scale lock: callers
        include replica dispatcher threads (router failover), and a
        blocking wait could deadlock against a scale-down draining
        that very dispatcher's engine — try-acquire, or step aside."""
        if self._closed or self.size() >= self.min_replicas:
            return False
        if not self._scale_lock.acquire(blocking=False):
            return False
        before = self.size()
        try:
            self._scale_locked(self.min_replicas, "heal_min")
        except BaseException:   # noqa: BLE001 — loader still (or
            # partially) down; anything that DID publish before the
            # failure still counts below, and the next request (or
            # autoscaler tick) retries the rest
            pass
        finally:
            self._scale_lock.release()
        return self.size() > before

    def mark_unhealthy(self, rid: str, cause: str = "",
                       replica: Optional[Replica] = None) -> bool:
        """Failover path: take `rid` out of routing NOW and rebuild its
        engine off to the side on a background thread. Idempotent —
        concurrent failovers on the same replica rebuild once. Callers
        holding the Replica object pass it: the slot is only condemned
        if it still holds THAT replica, so a straggler failure from an
        already-replaced engine (a late future off the drained old
        dispatcher) can never tear down the freshly rebuilt one."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or not rep.healthy or self._closed:
                return False
            if replica is not None and rep is not replica:
                return False    # stale failure: the slot moved on
            rep.healthy = False
        obs_trace.instant("fleet_replica_unhealthy", cat="fleet",
                          replica=rid, cause=cause)
        if self.metrics is not None:
            self.metrics.on_rebuild()
        t = threading.Thread(target=self._rebuild, args=(rid, rep),
                             daemon=True, name=f"pt-fleet-rebuild[{rid}]")
        t.start()
        return True

    def _rebuild(self, rid: str, dead: Replica) -> None:
        fresh: Optional[Replica] = None
        for attempt in range(REBUILD_ATTEMPTS):
            try:
                fresh = self._build(rid)
                break
            except BaseException as e:  # noqa: BLE001 — a failed
                # rebuild must not kill the pool; bounded retries ride
                # out transient loader failures, each visible on the
                # trace
                obs_trace.instant("fleet_rebuild_failed", cat="fleet",
                                  replica=rid, attempt=attempt,
                                  error=f"{type(e).__name__}")
                time.sleep(0.05 * (2.0 ** attempt))
        with self._lock:
            if self._closed or self._replicas.get(rid) is not dead:
                # the slot moved on (scale-down raced us): discard
                published = False
            elif fresh is None:
                # every attempt failed: give the slot up so size()
                # tells the operator the truth (an unhealthy zombie
                # counted as capacity would mask a dead fleet) — the
                # autoscaler's next scale-up mints a fresh slot
                del self._replicas[rid]
                published = False
            else:
                self._replicas[rid] = fresh
                published = True
        if published:
            obs_trace.instant("fleet_replica_rebuilt", cat="fleet",
                              replica=rid)
        elif fresh is not None:
            fresh.engine.shutdown(drain=False)
        else:
            obs_trace.instant("fleet_replica_lost", cat="fleet",
                              replica=rid, replicas=self.size())
        try:
            # the dead engine may still hold queued work — drain it on
            # EVERY path: its dispatcher survives batch crashes (the
            # per-batch containment contract), so queued futures get
            # served or failed typed, never stranded
            dead.engine.shutdown(drain=True)
        except Exception:   # noqa: BLE001 — it was already dead
            pass

    def close(self, drain: bool = True) -> None:
        with self._scale_lock:
            with self._lock:
                self._closed = True
                reps = list(self._replicas.values())
                self._replicas.clear()
            for rep in reps:
                rep.engine.shutdown(drain=drain)
