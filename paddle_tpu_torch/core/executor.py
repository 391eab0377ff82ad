"""Executor: run programs against a Scope on one device.

Counterpart of ``paddle_tpu/core/executor.py``. ``run`` feeds the
program, runs its step (core/lowering.py) on the executor's device and
writes the new persistable state back to the scope; ``run_loop`` runs
``n_steps`` steps in a host loop (the JAX package's ``lax.scan``) and
stacks the fetches. The executor runs on the first CUDA device unless it
is given ``CPUPlace()``; without a card the default raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

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

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def _fetch_name(f) -> str:
        return f.name if isinstance(f, VarDesc) else str(f)

    def _prep_feed(self, program: Program, feed: Dict[str, object]
                   ) -> Dict[str, torch.Tensor]:
        """Each feed as a tensor on the device in its var's (narrowed)
        dtype. Ragged list feeds are not ported."""
        out = {}
        for name, val in feed.items():
            if isinstance(val, (list, tuple)):
                raise NotImplementedError(
                    f"feed {name!r}: ragged list feeds are not ported; feed "
                    "a padded array")
            block = program.global_block
            t = val if isinstance(val, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(val))
            want = (torch_dtype(block.var(name).dtype) if block.has_var(name)
                    else torch_dtype(str(t.dtype).rsplit(".", 1)[-1]))
            out[name] = t.to(device=self.device, dtype=want)
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

    def _prepare(self, program, feed, fetch_list, scope, lazy, guard):
        if lazy:
            raise NotImplementedError("Executor.run(lazy=True): lazy fetch "
                                      "handles are not ported")
        if guard:
            raise NotImplementedError("Executor.run(guard=True): the guarded "
                                      "update is not ported")
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [self._fetch_name(f) for f in (fetch_list or [])]
        feed_t = self._prep_feed(program, feed or {})
        state = self._state_for(program, scope)
        step, _ = build_step_fn(program, list(feed_t), fetch_names,
                                sorted(state), self.device)
        return program, scope, feed_t, state, step

    @staticmethod
    def _out(fetches, return_numpy: bool):
        if return_numpy:
            return [f.cpu().numpy() for f in fetches]
        return list(fetches)

    # -- entry points -------------------------------------------------------
    def run(self, program: Optional[Program] = None, feed: Optional[dict] = None,
            fetch_list: Optional[Sequence] = None, scope: Optional[Scope] = None,
            return_numpy: bool = True, lazy: bool = False,
            guard: bool = False):
        """Run one step of `program`; returns the fetches (numpy arrays,
        or tensors on the device with return_numpy=False)."""
        program, scope, feed_t, state, step = self._prepare(
            program, feed, fetch_list, scope, lazy, guard)
        fetches, new_state = step(state, feed_t, self._generator(program))
        for name, val in new_state.items():
            scope.set_var(name, val)
        return self._out(fetches, return_numpy)

    def run_loop(self, program: Optional[Program] = None,
                 feed: Optional[dict] = None,
                 fetch_list: Optional[Sequence] = None, n_steps: int = 1,
                 scope: Optional[Scope] = None, per_step_feeds: bool = False,
                 return_numpy: bool = True, lazy: bool = False,
                 guard: bool = False):
        """Run `n_steps` steps. per_step_feeds=False reuses one feed dict
        every step; True takes slice i of each feed array (leading
        [n_steps] axis) at step i. Returns each fetch stacked to
        [n_steps, ...]."""
        program, scope, feed_t, state, step = self._prepare(
            program, feed, fetch_list, scope, lazy, guard)
        gen = self._generator(program)
        per_step = []
        for i in range(n_steps):
            f = ({k: v[i] for k, v in feed_t.items()} if per_step_feeds
                 else feed_t)
            fetches, new_state = step(state, f, gen)
            state = dict(state, **new_state)
            per_step.append(fetches)
        for name, val in state.items():
            scope.set_var(name, val)
        stacked = [torch.stack(col) for col in zip(*per_step)]
        return self._out(stacked, return_numpy)
