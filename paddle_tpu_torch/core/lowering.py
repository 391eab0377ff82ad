"""Program -> torch step function.

Counterpart of ``paddle_tpu/core/lowering.py``. The JAX package traces a
block into one XLA computation; the port runs the same ops eagerly, in
program order, over an environment planned once when the step is built:

    step(state, feed, generator, fault=0) -> (fetch_tuple, new_state)

* ``state`` — the persistable vars the program reads (parameters,
  optimizer accumulators), from the Scope;
* ``feed`` — the per-step inputs;
* the plan (``BlockPlan``) gives every var name a slot in a list and
  keeps only what is live: an output that no later op reads, no fetch
  names and no state carries is not bound (an op that can leave such
  outputs out, ``OpImpl.optional_outputs``, is not asked for them), and
  an op with no live output leaves the plan, but for the ops that draw
  from the run's generator (dropping one would move every later draw);
* a var marked ``stop_gradient`` is ``.detach()``-ed where an op writes
  it, and so is a fetch, where the value requires grad (in inference
  mode or under ``no_grad`` nothing does, and nothing is detached);
* the ``autodiff`` pseudo-op (backward.py) splits the block: the ops
  before it run with the parameters as leaf tensors that require grad,
  the loss is ``sum(loss.float()) * loss_scale``, ``torch.autograd.grad``
  binds each gradient to its ``@GRAD`` name, and the ops after it (the
  optimizer) run under ``torch.no_grad()``;
* mixed precision (``program.amp_dtype = "bfloat16"``), as the JAX
  package runs it: every float32 feed is cast to bfloat16 at the step's
  entry, and each float32 parameter leaf is cast to bfloat16 inside the
  differentiated forward, so ``torch.autograd.grad`` returns float32
  gradients of the float32 masters, which the optimizer ops update (the
  casts never reach the env the step's state is read from). An
  inference program's state is read as the Scope holds it (bfloat16
  after transpiler.Float16Transpiler).

Remat scopes are recorded in the IR but not ported: a program that uses
them raises here.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Set

import torch

from .program import Block, OpDesc, Program
from .registry import ExecContext, require_op

__all__ = ["AUTODIFF_OP", "PlannedOp", "BlockPlan", "run_op", "run_op_range",
           "run_block_with_autodiff", "build_step_fn"]

AUTODIFF_OP = "autodiff"

# ops that draw from the run's generator: they stay in the plan with no
# live output, as every later draw depends on theirs
_DRAWS = frozenset({"uniform_random", "gaussian_random"})

def _amp_dtype(program: Program) -> Optional[torch.dtype]:
    """The program's compute dtype under AMP (None without it); raises
    for an AMP dtype other than bfloat16."""
    amp = program.amp_dtype
    if amp is None:
        return None
    if amp != "bfloat16":
        raise NotImplementedError(
            f"program.amp_dtype={amp!r}: mixed precision in {amp} is not "
            "ported (bfloat16 is)")
    return torch.bfloat16


class PlannedOp:
    """One op resolved once, when its block is planned: its compute fn
    and attrs, its inputs as env slots by op slot, and its live outputs
    as (position in the op slot, env slot, detach?) by op slot, with the
    op slot's arity. Detach is asked only where the var is marked
    ``stop_gradient``. A step runs the plan with no registry lookup and
    no var lookup an op."""

    __slots__ = ("type", "compute", "attrs", "ins", "outs")

    def __init__(self, op: OpDesc, block: Block, index: Dict[str, int],
                 live_after: Set[str]):
        if "remat_scope" in op.attrs:
            raise NotImplementedError(
                f"op {op.type!r} sits in remat_scope "
                f"{op.attrs['remat_scope']!r}: activation recomputation is "
                "not ported; build without remat")
        impl = require_op(op.type)
        self.type = op.type
        self.attrs = op.attrs
        self.ins = tuple((slot, tuple(index[n] for n in names))
                         for slot, names in op.inputs.items())
        outs = []
        for slot, names in op.outputs.items():
            binds = tuple(
                (pos, index[n],
                 block.has_var(n) and block.var(n).stop_gradient)
                for pos, n in enumerate(names) if n in live_after)
            if binds:
                outs.append((slot, len(names), binds))
        self.outs = tuple(outs)
        self.compute = impl.compute
        if impl.optional_outputs:
            self.compute = functools.partial(
                impl.compute, wanted=frozenset(slot for slot, _, _ in outs))


class BlockPlan:
    """A block planned for a step that binds `inputs` (state and feeds)
    and reads `live_out` (fetches and state) afterwards: the slot of
    every name, the live ops in program order (the autodiff op left
    out: the forward's are ops[:bwd_idx], the optimizer's
    ops[bwd_idx:]), and, with an autodiff op, the slots the ops after
    it and the step's outputs read (``kept``), the loss's, and the
    parameters' and their gradients'."""

    def __init__(self, block: Block, inputs: Sequence[str],
                 live_out: Sequence[str]):
        self.index: Dict[str, int] = {}
        for n in inputs:
            self.slot(n)
        for op in block.ops:
            for n in op.input_names() + op.output_names():
                self.slot(n)
        for n in live_out:
            self.slot(n)
        self.bwd_idx: Optional[int] = None
        live = set(live_out)
        planned: List[PlannedOp] = []
        for op in reversed(block.ops):
            if op.type == AUTODIFF_OP:
                self._plan_autodiff(op, live)
                self.bwd_idx = len(planned)
                live.difference_update(op.attrs["grad_names"])
                live.add(op.attrs["loss"])
                live.update(op.attrs["params"])
                continue
            outs = op.output_names()
            if op.type not in _DRAWS and live.isdisjoint(outs):
                continue
            planned.append(PlannedOp(op, block, self.index, live))
            live.difference_update(outs)
            live.update(op.input_names())
        planned.reverse()
        if self.bwd_idx is not None:
            self.bwd_idx = len(planned) - self.bwd_idx
        self.ops = planned
        unbound = sorted(live - set(inputs))
        if unbound:
            raise KeyError(f"{unbound} are read by the program but neither "
                           "computed before, fed nor in the state")

    def slot(self, name: str) -> int:
        return self.index.setdefault(name, len(self.index))

    def _plan_autodiff(self, op: OpDesc, live_after: Set[str]) -> None:
        grads = set(op.attrs["grad_names"])
        self.kept = tuple(self.index[n] for n in sorted(live_after - grads))
        self.loss = self.index[op.attrs["loss"]]
        self.loss_scale = float(op.attrs.get("loss_scale", 1.0))
        self.params = tuple(self.slot(p) for p in op.attrs["params"])
        self.grads = tuple(self.slot(g) for g in op.attrs["grad_names"])


def run_op(op: PlannedOp, env: List, ctx: ExecContext):
    """Run one op's compute fn on its inputs from env; rebind its live
    outputs in env."""
    ins = {slot: [env[i] for i in idx] for slot, idx in op.ins}
    outs = op.compute(ctx, ins, op.attrs)
    for slot, n, binds in op.outs:
        vals = outs.get(slot)
        if vals is None:
            continue
        if len(vals) != n:
            raise RuntimeError(
                f"op {op.type}: slot {slot} produced {len(vals)} values for "
                f"{n} names")
        for pos, i, stop in binds:
            v = vals[pos]
            env[i] = v.detach() if stop and v.requires_grad else v


def run_op_range(plan: Sequence[PlannedOp], start: int, stop: int,
                 env: List, ctx: ExecContext):
    for op in plan[start:stop]:
        run_op(op, env, ctx)
    return env


def _poisoned(v: torch.Tensor) -> torch.Tensor:
    return torch.full_like(v, float("nan"))


def run_block_with_autodiff(plan: BlockPlan, env: List, ctx: ExecContext,
                            fault: int = 0,
                            amp: Optional[torch.dtype] = None):
    """Run a planned block that may hold one autodiff pseudo-op (see the
    module docstring). Every forward value but those the ops after the
    marker and the step's outputs read is dropped before the backward,
    so autograd frees activations as it goes. `fault` 1 / 2 poisons the
    loss / the gradients after the backward (the guard's fault sites).
    With `amp`, the forward reads each float32 parameter cast to it."""
    ops, bwd_idx = plan.ops, plan.bwd_idx
    if bwd_idx is None:
        with torch.no_grad():
            return run_op_range(ops, 0, len(ops), env, ctx)

    leaves = [env[p].detach().requires_grad_(True) for p in plan.params]
    fwd_env = list(env)
    with torch.enable_grad():
        for p, leaf in zip(plan.params, leaves):
            # the cast is differentiated: the gradient reaches the float32
            # master as float32
            fwd_env[p] = (leaf.to(amp) if amp is not None
                          and leaf.dtype == torch.float32 else leaf)
        run_op_range(ops, 0, bwd_idx, fwd_env, ctx)
        loss = fwd_env[plan.loss].float().sum() * plan.loss_scale
    kept = [(i, fwd_env[i]) for i in plan.kept]
    del fwd_env
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    del loss
    env = list(env)
    orig_params = [env[p] for p in plan.params]
    for i, v in kept:
        if v is not None:
            env[i] = v.detach()
    # the optimizer updates the parameters the step started from, not the
    # leaf copies the forward read
    for p, orig in zip(plan.params, orig_params):
        env[p] = orig
    for g_idx, leaf, g in zip(plan.grads, leaves, grads):
        # a parameter the loss does not reach gets a zero gradient, as
        # jax.value_and_grad gives it
        env[g_idx] = torch.zeros_like(leaf.detach()) if g is None else g
    if fault == 1 and env[plan.loss] is not None:
        env[plan.loss] = _poisoned(env[plan.loss])
    elif fault == 2:
        for g_idx in plan.grads:
            env[g_idx] = _poisoned(env[g_idx])
    with torch.no_grad():
        return run_op_range(ops, bwd_idx, len(ops), env, ctx)


def build_step_fn(program: Program, feed_names: Sequence[str],
                  fetch_names: Sequence[str], state_in_names: Sequence[str],
                  device: torch.device, guard: bool = False):
    """The step function of block 0 of `program`.

    Returns (step, state_out_names): state_out_names are the state vars
    carried through plus every persistable var an op writes (parameter
    updates, accumulators, startup initializers). With guard=True the
    fetches must name the health var (the executor appends it) and the
    update is the guarded select."""
    amp = _amp_dtype(program)
    block = program.global_block
    state_in = list(state_in_names)
    persist_written = []
    seen = set(state_in)
    for op in block.ops:
        for n in op.output_names():
            if n in seen or not block.has_var(n):
                continue
            if block.var(n).persistable:
                persist_written.append(n)
                seen.add(n)
    state_out_names = state_in + persist_written
    fetch_names = list(fetch_names)
    plan = BlockPlan(block, state_in + list(feed_names),
                     fetch_names + state_out_names)
    index = plan.index
    state_slots = [(n, index[n]) for n in state_in]
    feed_slots = [(n, index[n]) for n in feed_names]
    fetch_slots = [index[n] for n in fetch_names]
    out_slots = [(n, index[n]) for n in state_out_names]
    size = len(index)
    health_slot = None
    if guard:
        from ..resilience.guard import HEALTH_VAR
        health_slot = index[HEALTH_VAR]
    loss_scale = plan.loss_scale if plan.bwd_idx is not None else 1.0

    def step(state: Dict[str, torch.Tensor], feed: Dict[str, torch.Tensor],
             generator: torch.Generator, fault: int = 0):
        ctx = ExecContext(generator, device)
        ctx.loss_scale = loss_scale
        env: List = [None] * size
        for n, i in state_slots:
            env[i] = state[n]
        for n, i in feed_slots:
            v = feed[n]
            # AMP's entry cast: float32 feeds run in the compute dtype
            env[i] = (v.to(amp) if amp is not None
                      and v.dtype == torch.float32 else v)
        env = run_block_with_autodiff(plan, env, ctx, fault, amp)
        missing = [n for n, i in zip(fetch_names, fetch_slots)
                   if env[i] is None]
        if missing:
            raise KeyError(f"fetch {missing} is neither computed by the "
                           "program nor fed")
        fetches = tuple(v.detach() if v.requires_grad else v
                        for v in (env[i] for i in fetch_slots))
        new_state = {n: env[i] for n, i in out_slots if env[i] is not None}
        if health_slot is not None:
            # the guarded update: an unhealthy step keeps every state
            # value it started from (a var the step did not rebind is
            # its own old value already)
            healthy = env[health_slot]
            new_state = {n: (torch.where(healthy, v, state[n])
                             if n in state and v is not state[n] else v)
                         for n, v in new_state.items()}
        return fetches, new_state

    step.plan = plan
    return step, state_out_names
