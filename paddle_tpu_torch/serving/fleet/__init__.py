"""paddle_tpu_torch.serving.fleet — the replica tier over the engine.

One ServingEngine is one process's worth of serving; many users are
served by a FLEET of them. This package is the tier in
front: N engine replicas (pool.py), a priority-admitted router
(router.py + admission.py) doing least-loaded / session-affine
dispatch with crash failover, and a metrics-driven autoscaler
(autoscaler.py) — all reporting as the pt_fleet_* family on the
one-pane exposition (metrics.py).

    ReplicaPool          N ServingEngines; zero-drop scale up/down
                         (build-warm-swap-drain, per replica); crashed
                         replicas rebuilt off to the side
    FleetRouter          WFQ priority admission (lowest-class-first
                         shed), least_loaded / round_robin policies,
                         per-request session affinity (rendezvous
                         hash), RequestFailed failover via RetryPolicy
    Autoscaler           queue-depth + EWMA control loop w/ hysteresis
    FleetMetrics         pt_fleet_* provider on the unified registry

Knobs (constructor args win; read with serving/batcher.py's env_int,
as the port has no flags.py registry):

    PT_FLEET_REPLICAS    initial replica count (default 1)
    PT_FLEET_MIN         scale floor (default 1)
    PT_FLEET_MAX         scale ceiling (default 8)
    PT_FLEET_POLICY      least_loaded (default) | round_robin
    PT_FLEET_AUTOSCALE   1 = make_fleet attaches + starts an Autoscaler

Every replica is a ServingEngine on the pool's device: the first CUDA
device unless the caller names another (``device="cpu"``, as the tests
do); without a card the default raises.

Counterpart of ``paddle_tpu/serving/fleet/__init__.py``, copied with the JAX
package's names and structure: the tier is host code over the port's
``ServingEngine`` and imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from .admission import PendingRequest, WeightedFairQueue, default_weight
from .autoscaler import Autoscaler
from .metrics import FleetMetrics
from .pool import Replica, ReplicaPool
from .router import POLICIES, FleetRouter, crash_failover

__all__ = ["ReplicaPool", "Replica", "FleetRouter", "Autoscaler",
           "FleetMetrics", "WeightedFairQueue", "PendingRequest",
           "POLICIES", "default_weight", "crash_failover", "make_fleet"]


def make_fleet(loader: Callable, *, replicas: Optional[int] = None,
               device=None,
               policy: Optional[str] = None,
               autoscale: Optional[bool] = None,
               autoscaler_opts: Optional[dict] = None,
               pool_opts: Optional[dict] = None,
               **router_opts) -> FleetRouter:
    """Deployment convenience: pool + router (+ autoscaler when
    PT_FLEET_AUTOSCALE / autoscale=True) in one call. `loader(engine,
    rid)` loads this fleet's models into each fresh replica engine, a
    ServingEngine on `device` (the first CUDA device by default)."""
    pool = ReplicaPool(loader, replicas=replicas, device=device,
                       **(pool_opts or {}))
    try:
        router = FleetRouter(pool, policy=policy, **router_opts)
    except BaseException:
        # the pool already built+warmed N live engines; a router that
        # refuses (e.g. a typo'd PT_FLEET_POLICY) must not leak their
        # dispatcher threads for the process lifetime
        pool.close(drain=False)
        raise
    if autoscale is None:
        autoscale = os.environ.get("PT_FLEET_AUTOSCALE",
                                   "").strip().lower() in ("1", "true",
                                                           "on", "yes")
    if autoscale:
        router.autoscaler = Autoscaler(pool, metrics=router.metrics,
                                       **(autoscaler_opts or {}))
        router.autoscaler.start()
    return router
