"""Fleet admission: priority classes + weighted-fair queueing + strict
lowest-class-first shedding.

The single-engine admission layer (serving/admission.py) answers "can
THIS queue take one more request". The fleet front door answers a
different question: when the whole tier is overloaded, WHO gets served
and WHO gets shed. Two mechanisms, deliberately separate:

  service order   weighted-fair queueing (virtual-time WFQ) across
                  priority classes: when every class is backlogged,
                  class c receives dispatch slots in proportion to its
                  weight (default ``2**c``), so paid traffic is served
                  faster WITHOUT starving the free tier — a pure
                  priority queue would.
  shed order      strictly lowest-class-first: when the router queue is
                  full, the victim is always the NEWEST request of the
                  LOWEST occupied class. An arriving request sheds an
                  already-queued lower-class request (and takes its
                  slot); an arriving request OF the lowest class is
                  itself shed. Free tier always absorbs overload before
                  paid tier — the typed `Overloaded` carries
                  ``shed_class`` so clients and metrics both see which
                  class paid.

The queue stores `PendingRequest`s — the router's unit of dispatch,
carrying the priority class, the optional session key, the deadline,
and the failover bookkeeping (replicas already tried).

Counterpart of ``paddle_tpu/serving/fleet/admission.py``, copied with the JAX
package's names and structure: the tier is host code over the port's
``ServingEngine`` and imports nothing of the JAX package.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

from ..admission import Overloaded

__all__ = ["PendingRequest", "WeightedFairQueue", "default_weight",
           "MAX_CLASS"]

#: priority classes clamp to [0, MAX_CLASS]: the class is a CLIENT
#: input (HTTP `priority` field), and an unbounded one would overflow
#: the default doubling weight (2.0**2000 -> OverflowError in pop(),
#: killing the dispatcher thread) or starve every lower class behind a
#: 1/2**N virtual clock that never advances. 16 doublings (weight
#: 65536) is already far steeper than any real tiering needs.
MAX_CLASS = 16


def default_weight(cls: int) -> float:
    """Class weight for WFQ service shares: each class up doubles the
    share. Override per-router via class_weights={cls: weight}."""
    return 2.0 ** min(int(cls), MAX_CLASS)


class PendingRequest:
    """One admitted-but-undispatched fleet request."""

    __slots__ = ("model", "feeds", "cls", "session", "deadline_t",
                 "future", "t_enqueue", "tried", "result_retries",
                 "last_error")

    def __init__(self, model: str, feeds, *, cls: int = 0,
                 session: Optional[str] = None,
                 deadline_t: Optional[float] = None):
        self.model = model
        self.feeds = feeds
        self.cls = min(max(0, int(cls)), MAX_CLASS)
        self.session = session
        self.deadline_t = deadline_t
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()
        #: replica ids this request already failed on (failover skips)
        self.tried: set = set()
        #: completed-with-RequestFailed retries consumed (failover cap)
        self.result_retries = 0
        #: the typed error of the newest failed attempt — when every
        #: replica has been tried, the ORIGINAL failure surfaces, never
        #: a "no replica left" wrapper (the retry-layer contract)
        self.last_error: Optional[BaseException] = None


class WeightedFairQueue:
    """Bounded multi-class queue with virtual-time weighted-fair pops.

    Not thread-safe by itself — the router serializes access under its
    own condition variable (the queue is a policy object, not a
    synchronization one).
    """

    def __init__(self, queue_depth: int,
                 class_weights: Optional[Dict[int, float]] = None,
                 weight: Callable[[int], float] = default_weight):
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self.queue_depth = int(queue_depth)
        # coerce NOW: a malformed weight must refuse at construction,
        # typed — not surface as a TypeError inside pop() on the
        # dispatcher thread the first time that class is served
        self._weights = {int(c): float(w)
                         for c, w in (class_weights or {}).items()}
        self._weight_fn = weight
        self._q: Dict[int, deque] = {}
        self._vtime: Dict[int, float] = {}
        self._v0 = 0.0   # virtual time of the most recent pop

    def weight(self, cls: int) -> float:
        w = self._weights.get(cls)
        if w is None:
            w = self._weight_fn(cls)
        return max(float(w), 1e-9)

    def __len__(self) -> int:
        return sum(len(q) for q in self._q.values())

    def depths(self) -> Dict[int, int]:
        return {c: len(q) for c, q in sorted(self._q.items()) if q}

    # -- admission -----------------------------------------------------------
    def offer(self, item: PendingRequest) -> Optional[PendingRequest]:
        """Admit `item`, or decide who sheds. Returns the evicted
        victim (caller fails its future, typed) when a lower-class
        request made room; raises Overloaded(shed_class=item.cls) when
        `item` itself is the lowest class present. Never drops silently.
        """
        victim: Optional[PendingRequest] = None
        if len(self) >= self.queue_depth:
            occupied = [c for c, q in self._q.items() if q]
            low = min(occupied) if occupied else item.cls
            if not occupied or low >= item.cls:
                raise Overloaded(
                    f"fleet queue at capacity ({len(self)}/"
                    f"{self.queue_depth}); class {item.cls} is the "
                    "lowest present — shed", shed_class=item.cls)
            # newest of the lowest class: it has invested the least
            # wait, and the oldest is closest to service
            victim = self._q[low].pop()
            if not self._q[low]:
                del self._q[low]
        q = self._q.get(item.cls)
        if q is None:
            q = self._q[item.cls] = deque()
            # a class waking from idle must not replay its unused
            # history: catch its virtual time up to the active frontier
            self._vtime[item.cls] = max(
                self._vtime.get(item.cls, 0.0), self._v0)
        q.append(item)
        return victim

    def push_front(self, item: PendingRequest) -> None:
        """Return a popped-but-undispatchable request to the head of
        its class (router backpressure: every replica queue is full —
        the request keeps its place, the fleet queue keeps backing up,
        and the shed machinery above engages). May transiently exceed
        queue_depth by the in-flight item; offer() uses >=."""
        q = self._q.get(item.cls)
        if q is None:
            q = self._q[item.cls] = deque()
            self._vtime[item.cls] = max(
                self._vtime.get(item.cls, 0.0), self._v0)
        q.appendleft(item)

    # -- service -------------------------------------------------------------
    def pop(self) -> Optional[PendingRequest]:
        """Next request in weighted-fair order (smallest virtual finish
        time; its class's clock advances by 1/weight)."""
        active = [(self._vtime[c], c) for c, q in self._q.items() if q]
        if not active:
            return None
        vt, cls = min(active)
        item = self._q[cls].popleft()
        if not self._q[cls]:
            del self._q[cls]
        self._v0 = vt
        self._vtime[cls] = vt + 1.0 / self.weight(cls)
        return item

    def drain(self) -> List[PendingRequest]:
        """Everything still queued, service order preserved per class."""
        out: List[PendingRequest] = []
        while True:
            item = self.pop()
            if item is None:
                return out
            out.append(item)
