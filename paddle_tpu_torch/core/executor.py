"""Executor: run programs against a Scope on one device.

Counterpart of ``paddle_tpu/core/executor.py``. ``run`` feeds the
program, runs its step (core/lowering.py) on the executor's device and
writes the new persistable state back to the scope; ``run_loop`` runs
``n_steps`` steps in a host loop (the JAX package's ``lax.scan``) and
stacks the fetches. Both run the conv-epilogue fusion pass first
(analysis/fuse.py), as the JAX package's ``_run_impl`` does. The executor runs on the first CUDA device unless it
is given ``CPUPlace()``; without a card the default raises.

``lazy=True`` returns ``LazyFetch`` handles (core/async_fetch.py) over
the fetched device tensors as soon as the step is queued: nothing on
the dispatch path waits for the card. ``guard=True`` (the program
carries the ``step_health`` op, resilience/guard.py) draws the step's
fault code, runs the guarded update and fetches the health flag last.
``step_timings()`` reports the host_prep / dispatch / device / fetch
seconds of the runs (PhaseTimer).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..analysis import fuse as conv_fuse
from ..lod import LoDTensor, pad_sequences
from .async_fetch import LazyFetch, PhaseTimer
from .lowering import build_step_fn
from .program import Program, VarDesc, default_main_program
from .scope import Scope, global_scope
from .types import resolve_device, torch_dtype

__all__ = ["Place", "CPUPlace", "CUDAPlace", "Executor"]


class Place:
    """A device: kind "cpu" or "cuda", and an index."""

    def __init__(self, kind: str, index: int = 0):
        self.kind, self.index = kind, index

    def __repr__(self):
        return f"{self.kind.upper()}Place({self.index})"


def CPUPlace() -> Place:
    return Place("cpu")


def CUDAPlace(index: int = 0) -> Place:
    return Place("cuda", index)


class Executor:
    def __init__(self, place: Optional[Place] = None):
        self.place = place
        if place is None:
            self.device = resolve_device()
        elif place.kind == "cpu":
            self.device = torch.device("cpu")
        else:
            self.device = resolve_device(f"cuda:{place.index}")
        self._run_counter = 0
        self._timings = PhaseTimer()

    def step_timings(self, reset: bool = False) -> dict:
        """Accounted seconds per phase since the last reset (host_prep /
        dispatch / device / fetch, host_overhead_pct)."""
        return self._timings.snapshot(reset=reset)

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def _fetch_name(f) -> str:
        return f.name if isinstance(f, VarDesc) else str(f)

    def _prep_feed(self, program: Program, feed: Dict[str, object],
                   per_step: bool = False) -> Dict[str, torch.Tensor]:
        """Each feed as a tensor on the device in its var's (narrowed)
        dtype. A sequence var's feed may be a LoDTensor or a list of
        sequences: it is padded (lod.pad_sequences) and its @SEQ_LEN
        companion gets the lengths. A padded feed without its companion
        gets full lengths: [B] = T, or [N, B] = T with per_step (arrays
        with a leading [n_steps] axis, run_loop's per_step_feeds, which
        takes no ragged feed). An explicit companion feed is used as
        given."""
        block = program.global_block
        out = {}

        def put(name, val):
            t = val if isinstance(val, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(val))
            want = (torch_dtype(block.var(name).dtype) if block.has_var(name)
                    else torch_dtype(str(t.dtype).rsplit(".", 1)[-1]))
            out[name] = t.to(device=self.device, dtype=want)

        for name, val in feed.items():
            var = block.var(name) if block.has_var(name) else None
            seq_len_name = getattr(var, "seq_len_var", None)
            if isinstance(val, (LoDTensor, list, tuple)) and per_step:
                raise ValueError(
                    f"per-step feed {name!r}: ragged LoDTensor/list feeds "
                    "are not supported with per_step_feeds=True; pass a "
                    "padded [n_steps, B, T, ...] array (+ explicit "
                    f"{seq_len_name!r} lengths if sequences are not full)")
            if isinstance(val, LoDTensor):
                if val.lod_level > 1:
                    raise NotImplementedError(
                        f"feed {name!r}: nested (level-{val.lod_level}) "
                        "LoDTensor feeds are not supported by the executor "
                        "— call to_padded() yourself and feed the dense "
                        "array plus per-level length arrays explicitly")
                val, lens = val.to_padded()
                if seq_len_name:
                    put(seq_len_name, lens)
            elif seq_len_name and isinstance(val, (list, tuple)):
                dt = np.dtype(str(torch_dtype(var.dtype)).rsplit(".", 1)[-1])
                val, lens = pad_sequences(val, dtype=dt)
                put(seq_len_name, lens)
            elif seq_len_name and seq_len_name not in feed:
                # full-length sequences: [B, T, ...] -> lens [B] = T; with
                # a leading step axis, [N, B, T, ...] -> lens [N, B] = T
                shape = tuple(val.shape)
                lead = shape[:2] if per_step else shape[:1]
                put(seq_len_name, np.full(lead, shape[len(lead)], np.int32))
            put(name, val)
        return out

    def _state_for(self, program: Program, scope: Scope
                   ) -> Dict[str, torch.Tensor]:
        """The persistable vars the program reads that the scope holds."""
        block = program.global_block
        read = {n for op in block.ops for n in op.input_names()}
        state = {}
        for name in sorted(read):
            if not block.has_var(name) or not block.var(name).persistable:
                continue
            v = scope.find_var(name)
            if v is None:
                continue
            if v.device != self.device:
                raise ValueError(f"scope var {name!r} is on {v.device}; this "
                                 f"executor runs on {self.device}")
            state[name] = v
        return state

    def _generator(self, program: Program) -> torch.Generator:
        """The run's random stream: the program's seed and the run count,
        as the JAX package folds the run count into its key."""
        self._run_counter += 1
        seed = program.random_seed if program.random_seed is not None else 0
        return torch.Generator(device=self.device).manual_seed(
            (int(seed) << 32) + self._run_counter)

    def _prepare(self, program, feed, fetch_list, scope, guard,
                 per_step=False):
        t_prep = time.perf_counter()
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [self._fetch_name(f) for f in (fetch_list or [])]
        feed_t = self._prep_feed(program, feed or {}, per_step)
        # conv-epilogue fusion pre-pass (analysis/fuse.py): conv2d →
        # batch_norm (→ add) (→ relu) chains become fused_conv2d on a
        # clone, memoized per (fingerprint, fetch set); PT_FUSE=0 runs
        # the caller's program as it is
        program = conv_fuse.maybe_fuse(program, protect=fetch_names)
        if guard:
            from ..resilience import guard as guard_mod
            guard_mod.assert_instrumented(program)
            fetch_names = fetch_names + [guard_mod.HEALTH_VAR]
        state = self._state_for(program, scope)
        step, _ = build_step_fn(program, list(feed_t), fetch_names,
                                sorted(state), self.device, guard=guard)
        self._timings.add("host_prep", time.perf_counter() - t_prep)
        return program, scope, feed_t, state, step, fetch_names

    def _out(self, fetches, fetch_names, return_numpy: bool, lazy: bool):
        if lazy:
            return [LazyFetch(f, self._timings, provenance={"fetch": n})
                    for n, f in zip(fetch_names, fetches)]
        if return_numpy:
            with self._timings.span("fetch"):
                return [f.cpu().numpy() for f in fetches]
        return list(fetches)

    # -- entry points -------------------------------------------------------
    def run(self, program: Optional[Program] = None, feed: Optional[dict] = None,
            fetch_list: Optional[Sequence] = None, scope: Optional[Scope] = None,
            return_numpy: bool = True, lazy: bool = False,
            guard: bool = False):
        """Run one step of `program`; returns the fetches (numpy arrays,
        tensors on the device with return_numpy=False, LazyFetch handles
        with lazy=True; the health flag last with guard=True)."""
        program, scope, feed_t, state, step, names = self._prepare(
            program, feed, fetch_list, scope, guard)
        fault = 0
        if guard:
            from ..resilience import guard as guard_mod
            fault = guard_mod.fault_feed()
        with self._timings.span("dispatch"):
            fetches, new_state = step(state, feed_t,
                                      self._generator(program), fault)
        self._timings.count_run()
        for name, val in new_state.items():
            scope.set_var(name, val)
        return self._out(fetches, names, return_numpy, lazy)

    def run_loop(self, program: Optional[Program] = None,
                 feed: Optional[dict] = None,
                 fetch_list: Optional[Sequence] = None, n_steps: int = 1,
                 scope: Optional[Scope] = None, per_step_feeds: bool = False,
                 return_numpy: bool = True, lazy: bool = False,
                 guard: bool = False):
        """Run `n_steps` steps. per_step_feeds=False reuses one feed dict
        every step; True takes slice i of each feed array (leading
        [n_steps] axis) at step i. Returns each fetch stacked to
        [n_steps, ...]. With guard=True the fault code is drawn once a
        step under per_step_feeds and once a window otherwise, as the
        JAX package draws it."""
        program, scope, feed_t, state, step, names = self._prepare(
            program, feed, fetch_list, scope, guard, per_step_feeds)
        faults = [0] * n_steps
        if guard:
            from ..resilience import guard as guard_mod
            drawn = guard_mod.fault_feed(n_steps if per_step_feeds else None)
            faults = drawn if per_step_feeds else [drawn] * n_steps
        gen = self._generator(program)
        per_step = []
        with self._timings.span("dispatch"):
            for i in range(n_steps):
                f = ({k: v[i] for k, v in feed_t.items()} if per_step_feeds
                     else feed_t)
                fetches, new_state = step(state, f, gen, faults[i])
                state = dict(state, **new_state)
                per_step.append(fetches)
            stacked = [torch.stack(col) for col in zip(*per_step)]
        self._timings.count_run()
        for name, val in state.items():
            scope.set_var(name, val)
        return self._out(stacked, names, return_numpy, lazy)
