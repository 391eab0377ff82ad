"""One loaded model version: bucket selection, padding, run, scatter.

Counterpart of the prefill side of ``ModelVersion`` in
``paddle_tpu/serving/registry.py`` (``bucket_of``, ``execute_batch``),
over the port's model instead of deserialized StableHLO executables:
every length bucket runs the same ``TransformerLM`` on the prompt padded
with zeros to the bucket. The multi-model registry and its hot reload are
not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..io import load_decode_bundle
from ..reader.bucketing import bucket_bound
from .admission import InvalidRequest

__all__ = ["ModelVersion"]


class ModelVersion:
    """One immutable loaded bundle. Owns bucket selection, batch padding,
    execution, and scatter."""

    def __init__(self, model_dir: str, meta: dict, model):
        self.model_dir = model_dir
        self.model = model
        self.device = next(model.parameters()).device
        self.batch_size = int(meta["batch_size"])
        self.fetch_names = list(meta["fetch_names"])
        self.feed_names = [m["name"] for m in meta["feeds"]]
        #: feed name -> indices of its bucketed (length) dims, full-shape
        #: coords (0 is the batch dim)
        self.var_dims: Dict[str, List[int]] = {
            k: list(v) for k, v in meta.get("var_dims", {}).items()}
        self._buckets = {int(b["length"]): b for b in meta["buckets"]}
        self.bounds = sorted(self._buckets)

    # -- loading -------------------------------------------------------------
    @classmethod
    def load(cls, model_dir: str, *, device=None,
             warmup: bool = True) -> "ModelVersion":
        meta, model = load_decode_bundle(model_dir, device=device)
        mv = cls(model_dir, meta, model)
        if warmup:
            mv.warmup()
        return mv

    def warmup(self) -> None:
        """Run a zero batch through every bucket, so the first request
        pays no one-time library initialization."""
        for bound in self.bounds:
            self.execute_batch(bound, [])

    def _base_bucket(self) -> dict:
        return self._buckets[self.bounds[-1]]

    def feed_dtypes(self) -> Dict[str, np.dtype]:
        """{feed name: numpy dtype} for dtype-faithful request coercion."""
        return {m["name"]: np.dtype(m["dtype"])
                for m in self._base_bucket()["feeds"]}

    # -- request classification ---------------------------------------------
    def bucket_of(self, feeds: Dict[str, np.ndarray]) -> int:
        """The bucket key for one EXAMPLE (feeds carry no batch dim), or
        raise InvalidRequest when no exported bucket can hold it."""
        if set(feeds) != set(self.feed_names):
            raise InvalidRequest(
                f"feeds {sorted(feeds)} != model feeds "
                f"{sorted(self.feed_names)}")
        need = 0
        for m in self._base_bucket()["feeds"]:
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
        if need > self.bounds[-1]:
            raise InvalidRequest(
                f"length {need} exceeds the largest exported bucket "
                f"{self.bounds[-1]} (buckets: {self.bounds})")
        return bucket_bound(max(need, 1), self.bounds)

    # -- execution -----------------------------------------------------------
    @torch.inference_mode()
    def execute_batch(self, bucket_key: int,
                      examples: Sequence[Dict[str, np.ndarray]]):
        """Pad `examples` (<= batch_size) into the bucket shape, run the
        model once, scatter rows back per example. Returns (results,
        phase_s): one {fetch_name: tensor} dict per example, on the model's
        device, plus this batch's pad/device/scatter seconds."""
        b = self._buckets[bucket_key]
        B = self.batch_size
        if len(examples) > B:
            raise ValueError(f"{len(examples)} examples > batch {B}")
        phase_s: Dict[str, float] = {}

        def _mark(phase: str, t0: float) -> None:
            phase_s[phase] = time.perf_counter() - t0

        t0 = time.perf_counter()
        (feed,) = b["feeds"]
        buf = np.zeros(tuple(feed["shape"]), dtype=np.dtype(feed["dtype"]))
        for r, ex in enumerate(examples):
            a = np.asarray(ex[feed["name"]])
            buf[(r,) + tuple(slice(0, s) for s in a.shape)] = a
        src = torch.from_numpy(buf).to(self.device)
        _mark("pad", t0)

        t0 = time.perf_counter()
        logits, kvs = self.model(src)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        _mark("device", t0)

        t0 = time.perf_counter()
        outs = [logits] + [t for kv in kvs for t in kv]
        results = [{name: o[r] for name, o in zip(self.fetch_names, outs)}
                   for r in range(len(examples))]
        _mark("scatter", t0)
        return results, phase_s
