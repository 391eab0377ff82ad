"""paddle_tpu_torch.serving — batched, multi-model online inference.

Counterpart of ``paddle_tpu/serving/__init__.py``: the throughput-
oriented online layer over the port's serving artifacts
(io.export_serving_model: a program lowered once a bucket, weights bound
on the card), rebuilt around coalescing as in the JAX package:

    ServingEngine                 the facade: config + registry + metrics
      ├── registry.ModelRegistry  named, versioned models; warmup-on-load;
      │     ModelVersion          atomic drain-based hot reload
      ├── batcher.MicroBatcher    bounded queue + dispatcher thread:
      │                           coalesce -> bucket-pad -> run -> scatter
      ├── admission               typed Overloaded/DeadlineExceeded errors,
      │                           reject-fast load shedding
      ├── metrics                 QPS, batch-fill, queue depth, phase
      │                           latency percentiles (snapshot-able)
      ├── decode                  the generation plane (DecodeEngine:
      │                           paged KV + continuous batching)
      └── http                    stdlib ThreadingHTTPServer front end

Engine-wide knobs (constructor args win; PT_SERVE_* env knobs supply
deployment defaults):

    PT_SERVE_MAX_BATCH     micro-batch bound (default: artifact batch)
    PT_SERVE_MAX_WAIT_MS   batch close deadline, ms (default 2)
    PT_SERVE_QUEUE_DEPTH   bounded queue per model (default 256)
    PT_SERVE_DEADLINE_MS   default per-request deadline, 0 = none

The engine runs its models on the first CUDA device unless it is given
``device`` (``device="cpu"`` runs the plain PyTorch path); without a
card the default raises. The fleet tier (``serving/fleet/``: a router
with weighted-fair admission over a pool of engines on one device, and
an autoscaler) fronts N engines; the embedded C API is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..core.types import resolve_device

from .admission import (AdmissionController, DeadlineExceeded,
                        InvalidRequest, ModelUnavailable, Overloaded,
                        RequestFailed, ServingError, retryable)
from .batcher import (DEFAULT_MAX_WAIT_MS, MicroBatcher, env_float,
                      env_int)
from .metrics import ServingMetrics
from .registry import ModelRegistry, ModelVersion

__all__ = ["ServingEngine", "ServingError", "Overloaded",
           "DeadlineExceeded", "ModelUnavailable", "InvalidRequest",
           "RequestFailed", "retryable", "MicroBatcher", "ModelRegistry",
           "ModelVersion", "AdmissionController", "ServingMetrics"]


class ServingEngine:
    """In-process multi-model serving engine.

    >>> engine = ServingEngine()                # the first CUDA device
    >>> engine.load_model("ranker", "/models/ranker_v7")
    >>> out = engine.predict("ranker", {"x": example})       # blocking
    >>> fut = engine.submit("ranker", {"x": example})        # async
    >>> engine.load_model("ranker", "/models/ranker_v8")     # hot reload
    >>> engine.metrics_snapshot()["models"]["ranker"]["qps"]
    """

    def __init__(self, max_batch_size: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None, device=None):
        self.device = resolve_device(device)
        self.max_batch_size = max_batch_size  # None = per-model artifact
        self.max_wait_ms = (env_float("PT_SERVE_MAX_WAIT_MS",
                                      DEFAULT_MAX_WAIT_MS)
                            if max_wait_ms is None else float(max_wait_ms))
        self.queue_depth = (env_int("PT_SERVE_QUEUE_DEPTH", 256)
                            if queue_depth is None else int(queue_depth))
        self.deadline_ms = (env_float("PT_SERVE_DEADLINE_MS", 0.0)
                            if deadline_ms is None else float(deadline_ms))
        self.metrics = ServingMetrics()
        self.registry = ModelRegistry(self._make_batcher, device=self.device)
        self._decode: Dict[str, object] = {}
        self._closed = False

    # -- wiring --------------------------------------------------------------
    def _make_batcher(self, name: str, model: ModelVersion) -> MicroBatcher:
        max_batch = self.max_batch_size
        if max_batch is None:
            max_batch = env_int("PT_SERVE_MAX_BATCH", model.batch_size)
        admission = AdmissionController(
            queue_depth=self.queue_depth,
            max_batch_size=min(max_batch, model.batch_size),
            default_deadline_ms=self.deadline_ms)
        return MicroBatcher(model, max_batch_size=max_batch,
                            max_wait_ms=self.max_wait_ms,
                            admission=admission,
                            metrics=self.metrics.model(name), name=name)

    # -- model lifecycle -----------------------------------------------------
    def load_model(self, name: str, model_dir: str,
                   version: Optional[int] = None,
                   warmup: bool = True) -> int:
        """Load `name` from a serving artifact dir; if `name` is already
        serving, this is an atomic hot reload (new version warmed before
        the swap, old version drained after). Returns the version id."""
        if self._closed:
            raise ModelUnavailable("engine is shut down")
        ver = self.registry.load(name, model_dir, version, warmup=warmup)
        if ver > 1:
            self.metrics.model(name).on_reload()
        return ver

    def load_model_object(self, name: str, model,
                          version: Optional[int] = None) -> int:
        """Serve an in-memory model object (batch_size / bucket_of /
        execute_batch surface) behind the full batcher + admission +
        metrics stack — the synthetic-replica hook the fleet tier's
        bench and tests load replicas with. Same swap semantics as
        load_model."""
        if self._closed:
            raise ModelUnavailable("engine is shut down")
        ver = self.registry.load_object(name, model, version)
        if ver > 1:
            self.metrics.model(name).on_reload()
        return ver

    def unload_model(self, name: str) -> None:
        self.registry.unload(name)

    def models(self) -> Dict[str, dict]:
        out = self.registry.describe()
        for name, eng in list(self._decode.items()):
            out[name] = dict(out.get(name, {}), decode=eng.describe())
        return out

    # -- the generation plane (paged KV + continuous batching) ---------------
    def load_decode_model(self, name: str, model_dir: str,
                          warmup: bool = True, **opts) -> dict:
        """Load (or hot-swap) a decode bundle (io.export_decode_model)
        under `name`. The new engine is built and warmed off to the
        side, the routing pointer swaps, then the old engine drains —
        the reload contract of the one-shot plane, kept. opts pass
        through to DecodeEngine (queue_depth, deadline_ms,
        max_new_tokens, continuous, kv_share, drafter, spec_k). The
        engine runs on this engine's device."""
        if self._closed:
            raise ModelUnavailable("engine is shut down")
        from .decode import DecodeEngine
        eng = DecodeEngine(model_dir, name=name, warmup=warmup,
                           device=self.device,
                           metrics=self.metrics.decode(name), **opts)
        old = self._decode.get(name)
        self._decode[name] = eng
        if old is not None:
            old.shutdown(drain=True)
        return eng.describe()

    def unload_decode_model(self, name: str) -> None:
        eng = self._decode.pop(name, None)
        if eng is not None:
            eng.shutdown(drain=True)

    def decode_engine(self, name: str):
        eng = self._decode.get(name)
        if eng is None:
            raise ModelUnavailable(
                f"no decode model named {name!r} is loaded")
        return eng

    def decode_engines(self) -> Dict[str, object]:
        """Snapshot of the loaded decode engines (name -> DecodeEngine).
        The fleet tier reads shared-KV residency and speculative
        acceptance off these for replica health."""
        return dict(self._decode)

    def generate(self, name: str, prompt_ids, **kw):
        """Admit one generation request; returns a GenerationHandle
        (stream() for live tokens, result() for the final dict). Typed
        admission errors raise here, reject-fast."""
        if self._closed:
            raise ModelUnavailable("engine is shut down")
        return self.decode_engine(name).generate(prompt_ids, **kw)

    # -- the request path ----------------------------------------------------
    def submit(self, name: str, feeds: Dict,
               deadline_ms: Optional[float] = None):
        """Async: admit + enqueue one example; returns a Future whose
        result is {fetch_name: np.ndarray}. Typed admission errors raise
        HERE (reject-fast), execution errors surface on the Future."""
        if self._closed:
            raise ModelUnavailable("engine is shut down")
        entry = self.registry.get(name)
        while True:
            try:
                return entry.batcher.submit(feeds, deadline_ms=deadline_ms)
            except ModelUnavailable:
                # raced a hot reload: the version we routed to closed
                # between registry.get() and submit(). A reload swaps the
                # routing pointer BEFORE draining the old batcher, so if
                # the name now routes to a different version, retry there
                # — the zero-drop contract covers this window too. A
                # truly unloaded name re-raises (from get(), or because
                # the routed entry is the one that just refused us).
                nxt = self.registry.get(name)
                if nxt is entry:
                    raise
                entry = nxt

    def predict(self, name: str, feeds: Dict,
                deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None) -> Dict:
        """Blocking single-request convenience over submit()."""
        fut = self.submit(name, feeds, deadline_ms=deadline_ms)
        if timeout is None and deadline_ms:
            timeout = deadline_ms / 1000.0 + 30.0   # deadline + margin
        return fut.result(timeout=timeout)

    # -- observability / shutdown -------------------------------------------
    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()

    def shutdown(self, drain: bool = True) -> None:
        """Stop all batchers + decode engines. drain=True serves the
        backlog first."""
        self._closed = True
        self.registry.close(drain=drain)
        for eng in list(self._decode.values()):
            eng.shutdown(drain=drain)
        self._decode.clear()
