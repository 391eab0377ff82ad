"""Multi-model registry: named, versioned models + atomic hot reload.

Counterpart of ``paddle_tpu/serving/registry.py``. A `ModelVersion` is
one loaded serving artifact dir (io.export_serving_model, or the prefill
side of io.export_decode_model): the serving.json metadata plus, per
shape bucket, its program lowered ONCE at load onto the version's device
(io.ServingProgram: core/lowering.py ``build_step_fn`` on the
``for_test`` program) with the persistables bound there once. A batch
runs that step under ``torch.inference_mode()`` — no state written back,
no per-call feed preparation. Loading WARMS every bucket: a zero batch
runs through each program, so the first real request pays no one-time
library initialization (cuBLAS handles, the CUDA kernels' build).

Hot reload is drain-based, not lock-based: the registry builds and warms
the NEW version entirely off to the side, atomically swaps the routing
pointer (one dict store under a mutex), then closes the OLD version's
batcher with drain=True — the old dispatcher finishes every request that
was already queued against it before the version is released. In-flight
requests therefore never see the swap; new requests never see the old
version. Zero requests are dropped by construction.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.types import resolve_device
from ..io import ServingProgram, read_serving_meta
from ..reader.bucketing import bucket_bound
from .admission import InvalidRequest, ModelUnavailable

__all__ = ["ModelVersion", "ModelRegistry"]


class _Bucket:
    """One shape bucket: its lowered program + its feed/fetch specs."""

    __slots__ = ("length", "run", "feeds", "fetches")

    def __init__(self, length: Optional[int], run: ServingProgram,
                 feeds: List[dict], fetches: List[dict]):
        self.length = length
        self.run = run
        self.feeds = feeds        # [{"name","shape","dtype"}...]
        self.fetches = fetches    # same, with "batch_major"


class ModelVersion:
    """One immutable loaded artifact on one device. Owns bucket
    selection, batch padding, execution, and scatter — the batcher only
    does queueing."""

    def __init__(self, model_dir: str, meta: dict, buckets: Dict, *,
                 version: int, device: torch.device,
                 state: Dict[str, torch.Tensor]):
        self.model_dir = model_dir
        self.version = version
        self.device = device
        #: {var name: tensor} the programs read, bound on the device once
        self.state = state
        self.batch_size = int(meta["batch_size"])
        self.fetch_names = list(meta["fetch_names"])
        self.feed_names = [m["name"] for m in meta["feeds"]]
        #: feed name -> indices of its bucketed (length) dims, full-shape
        #: coords (0 is the batch dim)
        self.var_dims: Dict[str, List[int]] = {
            k: list(v) for k, v in meta.get("var_dims", {}).items()}
        self._buckets = buckets                    # key(None|int) -> _Bucket
        self.bounds = sorted(k for k in buckets if k is not None)
        # the engine's whole padding/scatter model slices feeds on a
        # leading batch axis; an artifact with a static
        # (append_batch_size=False) feed cannot be coalesced — refuse at
        # load instead of silently mis-serving (io.load_serving_model
        # still serves such artifacts)
        static = [m["name"] for m in self._base_bucket().feeds
                  if m.get("batch_major") is False]
        if static:
            raise ValueError(
                f"serving engine requires batch-major feeds; {static} "
                "have no batch axis — serve this artifact via "
                "io.load_serving_model instead")

    # -- loading -------------------------------------------------------------
    @classmethod
    def load(cls, model_dir: str, *, version: int, device=None,
             warmup: bool = True) -> "ModelVersion":
        """Load an artifact onto `device` (the first CUDA device by
        default); a JAX StableHLO artifact raises ValueError."""
        meta = read_serving_meta(model_dir)
        device = resolve_device(device)
        state: Dict[str, torch.Tensor] = {}
        programs: Dict[str, ServingProgram] = {}
        buckets: Dict = {}
        for e, fn in zip(meta["buckets"], meta["programs"]):
            if fn not in programs:
                programs[fn] = ServingProgram(model_dir, fn, device, state)
            key = e["length"] if e["length"] is None else int(e["length"])
            buckets[key] = _Bucket(key, programs[fn], e["feeds"],
                                   e["fetches"])
        model = cls(model_dir, meta, buckets, version=version,
                    device=device, state=state)
        if warmup:
            model.warmup()
        return model

    def warmup(self) -> None:
        """Run a zero batch through EVERY bucket before the first real
        request arrives."""
        for key in self._buckets:
            b, feeds = self._pad(key, [])
            b.run(feeds)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _base_bucket(self) -> _Bucket:
        return self._buckets[self.bounds[-1] if self.bounds else None]

    def feed_dtypes(self) -> Dict[str, np.dtype]:
        """{feed name: numpy dtype} — the public surface front ends use
        for dtype-faithful request coercion."""
        return {m["name"]: np.dtype(m["dtype"])
                for m in self._base_bucket().feeds}

    # -- request classification ---------------------------------------------
    def bucket_of(self, feeds: Dict[str, np.ndarray]):
        """The bucket key for one EXAMPLE (feeds carry no batch dim), or
        raise InvalidRequest when no exported bucket can hold it."""
        if set(feeds) != set(self.feed_names):
            raise InvalidRequest(
                f"feeds {sorted(feeds)} != model feeds "
                f"{sorted(self.feed_names)}")
        need = 0
        for m in self._base_bucket().feeds:
            name = m["name"]
            ex = np.asarray(feeds[name])
            want = list(m["shape"][1:])   # example coords: drop batch dim
            if ex.ndim != len(want):
                raise InvalidRequest(
                    f"feed {name!r}: rank {ex.ndim} != {len(want)}")
            if not np.can_cast(ex.dtype, np.dtype(m["dtype"]),
                               casting="same_kind"):
                raise InvalidRequest(
                    f"feed {name!r}: dtype {ex.dtype} not same-kind "
                    f"castable to {m['dtype']}")
            var = set(d - 1 for d in self.var_dims.get(name, ()))
            for d, (got, exp) in enumerate(zip(ex.shape, want)):
                if d in var:
                    need = max(need, int(got))
                elif int(got) != int(exp):
                    raise InvalidRequest(
                        f"feed {name!r}: dim {d} is {got}, model wants "
                        f"{exp}")
        if not self.bounds:
            return None
        if need > self.bounds[-1]:
            raise InvalidRequest(
                f"length {need} exceeds the largest exported bucket "
                f"{self.bounds[-1]} (buckets: {self.bounds})")
        return bucket_bound(max(need, 1), self.bounds)

    # -- execution -----------------------------------------------------------
    def _pad(self, bucket_key, examples):
        """(bucket, its feeds on the device with `examples` in the
        leading rows and zeros elsewhere)."""
        b = self._buckets[bucket_key]
        feeds = {}
        for m in b.feeds:
            buf = np.zeros(tuple(m["shape"]), dtype=np.dtype(m["dtype"]))
            for r, ex in enumerate(examples):
                a = np.asarray(ex[m["name"]])
                buf[(r,) + tuple(slice(0, s) for s in a.shape)] = a
            feeds[m["name"]] = torch.from_numpy(buf).to(self.device)
        return b, feeds

    def execute_batch(self, bucket_key, examples: Sequence[Dict[str,
                                                                np.ndarray]],
                      timer=None, host: bool = True):
        """Pad `examples` (<= batch_size) into the bucket shape, run the
        bucket's program once, scatter rows back per example. Returns
        (results, phase_s): one {fetch_name: array} dict per example in
        order, plus this batch's pad/device/scatter seconds. The same
        spans land on `timer` (the model's cumulative phase accounting)
        when given.

        host=True (the engine's contract) gives numpy arrays; "device"
        then covers the run and the copy to the host. host=False gives
        views of the outputs on the device (the decode engine seeds its
        KV pools from them without a host round trip)."""
        B = self.batch_size
        if len(examples) > B:
            raise ValueError(f"{len(examples)} examples > batch {B}")
        phase_s: Dict[str, float] = {}

        def _mark(phase: str, t0: float) -> None:
            dt = time.perf_counter() - t0
            phase_s[phase] = dt
            if timer is not None:
                timer.add(phase, dt)

        t0 = time.perf_counter()
        b, feeds = self._pad(bucket_key, examples)
        _mark("pad", t0)

        t0 = time.perf_counter()
        outs = b.run(feeds)
        if host:
            outs = [o.cpu().numpy() for o in outs]   # the device sync
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        _mark("device", t0)

        t0 = time.perf_counter()
        results: List[Dict] = []
        # batch-major fetches scatter by row; others (reduced scalars,
        # parameter fetches) are replicated. The export-recorded flag is
        # authoritative — a fetch whose leading dim merely coincides with
        # the batch size must NOT be split
        for r in range(len(examples)):
            row = {}
            for name, o, m in zip(self.fetch_names, outs, b.fetches):
                part = o[r] if m["batch_major"] else o
                row[name] = part.copy() if host else part
            results.append(row)
        _mark("scatter", t0)
        return results, phase_s


class _Entry:
    __slots__ = ("name", "model", "batcher")

    def __init__(self, name: str, model: ModelVersion, batcher):
        self.name = name
        self.model = model
        self.batcher = batcher


class ModelRegistry:
    """name -> current (ModelVersion, batcher), with drain-on-swap
    reloads. `make_batcher(name, model)` is injected by the engine so the
    registry stays free of queueing policy. Artifacts load onto `device`
    (the first CUDA device by default)."""

    def __init__(self, make_batcher: Callable[[str, ModelVersion], object],
                 device=None):
        self._make_batcher = make_batcher
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        self._versions: Dict[str, int] = {}

    def _reserve_version(self, name: str,
                         version: Optional[int]) -> int:
        """Reserve a version id NOW, not after the (slow, unlocked)
        model build — two concurrent reloads must get distinct ids."""
        with self._lock:
            if version is None:
                version = self._versions.get(name, 0) + 1
            self._versions[name] = max(self._versions.get(name, 0),
                                       version)
        return version

    def _publish(self, name: str, model) -> None:
        """The swap tail every load path shares: build the new
        batcher, atomically swap the routing entry, then drain the old
        version's batcher (zero dropped in-flight requests)."""
        batcher = self._make_batcher(name, model)
        with self._lock:
            old = self._entries.get(name)
            self._entries[name] = _Entry(name, model, batcher)
        if old is not None:
            old.batcher.close(drain=True)

    def load(self, name: str, model_dir: str,
             version: Optional[int] = None, *,
             warmup: bool = True) -> int:
        """Load (or hot-reload) `name` from `model_dir`. Returns the
        version id. The new version is fully warmed BEFORE the swap; the
        old version drains all queued requests before release."""
        version = self._reserve_version(name, version)
        model = ModelVersion.load(model_dir, version=version,
                                  device=self.device, warmup=warmup)
        self._publish(name, model)
        return version

    def load_object(self, name: str, model,
                    version: Optional[int] = None) -> int:
        """Register an in-memory model object through the same
        batcher/entry path as an artifact load: anything with
        `batch_size`, `bucket_of(feeds)`, and `execute_batch(bucket,
        examples, timer=)` serves behind the engine's full queueing /
        admission / metrics stack. Swap semantics match load(): new
        batcher in, old batcher drained."""
        version = self._reserve_version(name, version)
        if getattr(model, "version", None) is None:
            try:
                model.version = version
            except (AttributeError, TypeError):
                pass   # slotted/frozen stubs keep their own identity
        self._publish(name, model)
        return version

    def get(self, name: str) -> _Entry:
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise ModelUnavailable(f"no model named {name!r} is loaded")
        return entry

    def unload(self, name: str) -> None:
        with self._lock:
            entry = self._entries.pop(name, None)
        if entry is not None:
            entry.batcher.close(drain=True)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def describe(self) -> dict:
        with self._lock:
            entries = list(self._entries.values())
        out = {}
        for e in entries:
            m = e.model
            # getattr-tolerant: load_object() models (unit stubs)
            # describe what they declare
            out[e.name] = {
                "version": getattr(m, "version", None),
                "model_dir": getattr(m, "model_dir", None),
                "batch_size": m.batch_size,
                "buckets": (m.bounds or [None]) if hasattr(m, "bounds")
                else [None],
                "feeds": getattr(m, "feed_names", []),
                "fetches": getattr(m, "fetch_names", []),
            }
        return out

    def close(self, drain: bool = True) -> None:
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            e.batcher.close(drain=drain)
