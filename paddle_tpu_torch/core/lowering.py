"""Program -> torch step function.

Counterpart of ``paddle_tpu/core/lowering.py``. The JAX package traces a
block into one XLA computation; the port runs the same ops eagerly, in
program order, by rebinding names in an environment dict:

    step(state, feed, generator) -> (fetch_tuple, new_state)

* ``state`` — the persistable vars the program reads (parameters,
  optimizer accumulators), from the Scope;
* ``feed`` — the per-step inputs;
* a var marked ``stop_gradient`` is ``.detach()``-ed where an op writes
  it, and so is a fetch, where the value requires grad (in inference
  mode or under ``no_grad`` nothing does, and nothing is detached);
* the ``autodiff`` pseudo-op (backward.py) splits the block: the ops
  before it run with the parameters as leaf tensors that require grad,
  the loss is ``sum(loss.float()) * loss_scale``, ``torch.autograd.grad``
  binds each gradient to its ``@GRAD`` name, and the ops after it (the
  optimizer) run under ``torch.no_grad()``.

Remat scopes and AMP are recorded in the IR but not ported: a program
that uses them raises here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from .program import Block, OpDesc, Program
from .registry import ExecContext, require_op

__all__ = ["AUTODIFF_OP", "PlannedOp", "plan_ops", "run_op",
           "run_op_range", "post_forward_reads", "run_block_with_autodiff",
           "build_step_fn"]

AUTODIFF_OP = "autodiff"


class PlannedOp:
    """One op resolved once, when its block is lowered: its compute fn
    and attrs, its input names by slot, and its output names by slot,
    each with whether the value is detached (the var is marked
    ``stop_gradient``). A step runs the plan with no registry lookup and
    no var lookup an op."""

    __slots__ = ("type", "compute", "attrs", "ins", "outs")

    def __init__(self, op: OpDesc, block: Block):
        if "remat_scope" in op.attrs:
            raise NotImplementedError(
                f"op {op.type!r} sits in remat_scope "
                f"{op.attrs['remat_scope']!r}: activation recomputation is "
                "not ported; build without remat")
        self.type = op.type
        self.compute = require_op(op.type).compute
        self.attrs = op.attrs
        self.ins = tuple((slot, tuple(names))
                         for slot, names in op.inputs.items())
        self.outs = tuple(
            (slot, tuple(names),
             tuple(block.has_var(n) and block.var(n).stop_gradient
                   for n in names))
            for slot, names in op.outputs.items())


def plan_ops(ops: Sequence[OpDesc], block: Block) -> List[PlannedOp]:
    return [PlannedOp(op, block) for op in ops]


def run_op(op: PlannedOp, env: Dict[str, torch.Tensor], ctx: ExecContext):
    """Run one op's compute fn on its inputs from env; rebind its outputs
    in env."""
    ins = {slot: [env[n] for n in names] for slot, names in op.ins}
    outs = op.compute(ctx, ins, op.attrs)
    for slot, names, stops in op.outs:
        vals = outs.get(slot)
        if vals is None:
            continue
        if len(vals) != len(names):
            raise RuntimeError(
                f"op {op.type}: slot {slot} produced {len(vals)} values for "
                f"{len(names)} names {list(names)}")
        for n, v, stop in zip(names, vals, stops):
            env[n] = v.detach() if stop and v.requires_grad else v


def run_op_range(plan: Sequence[PlannedOp], start: int, stop: int,
                 env: Dict[str, torch.Tensor], ctx: ExecContext):
    for op in plan[start:stop]:
        run_op(op, env, ctx)
    return env


def _autodiff_index(block: Block) -> Optional[int]:
    return next((i for i, o in enumerate(block.ops)
                 if o.type == AUTODIFF_OP), None)


def post_forward_reads(block: Block) -> set:
    """Names the ops after the autodiff marker read, plus the loss: the
    values that must survive the forward. Empty without a marker."""
    ops = block.ops
    bwd_idx = _autodiff_index(block)
    if bwd_idx is None:
        return set()
    needed = {ops[bwd_idx].attrs["loss"]}
    for op in ops[bwd_idx + 1:]:
        needed.update(op.input_names())
    return needed


def run_block_with_autodiff(block: Block, env: Dict[str, torch.Tensor],
                            ctx: ExecContext, live_out=(),
                            plan: Optional[Sequence[PlannedOp]] = None):
    """Run a block that may hold one autodiff pseudo-op (see the module
    docstring). live_out: names the caller reads afterwards (fetches and
    state); every other forward value is dropped before the backward, so
    autograd frees activations as it goes. plan: the ops of the block but
    the autodiff op as build_step_fn planned them (planned here when
    not given)."""
    ops = block.ops
    bwd_idx = _autodiff_index(block)
    if plan is None:
        plan = _plan_block(block, bwd_idx)
    if bwd_idx is None:
        with torch.no_grad():
            return run_op_range(plan, 0, len(plan), env, ctx)

    bop = ops[bwd_idx]
    loss_name = bop.attrs["loss"]
    param_names = list(bop.attrs["params"])
    grad_names = list(bop.attrs["grad_names"])
    loss_scale = float(bop.attrs.get("loss_scale", 1.0))
    needed_after = post_forward_reads(block) | {loss_name} | set(live_out)

    leaves = [env[p].detach().requires_grad_(True) for p in param_names]
    fwd_env = dict(env)
    fwd_env.update(zip(param_names, leaves))
    with torch.enable_grad():
        run_op_range(plan, 0, bwd_idx, fwd_env, ctx)
        loss = fwd_env[loss_name].float().sum() * loss_scale
    kept = {k: v for k, v in fwd_env.items() if k in needed_after}
    del fwd_env
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    del loss
    orig_params = {p: env[p] for p in param_names}
    env = dict(env)
    env.update((k, v.detach()) for k, v in kept.items())
    # the optimizer updates the parameters the step started from, not the
    # leaf copies the forward read
    env.update(orig_params)
    for p, g_name, leaf, g in zip(param_names, grad_names, leaves, grads):
        # a parameter the loss does not reach gets a zero gradient, as
        # jax.value_and_grad gives it
        env[g_name] = torch.zeros_like(leaf.detach()) if g is None else g
    with torch.no_grad():
        return run_op_range(plan, bwd_idx, len(plan), env, ctx)


def _plan_block(block: Block, bwd_idx: Optional[int]) -> List[PlannedOp]:
    """The block's ops but the autodiff op, planned: the forward's are
    plan[:bwd_idx] and the optimizer's plan[bwd_idx:]."""
    ops = block.ops
    if bwd_idx is None:
        return plan_ops(ops, block)
    return plan_ops(ops[:bwd_idx] + ops[bwd_idx + 1:], block)


def build_step_fn(program: Program, feed_names: Sequence[str],
                  fetch_names: Sequence[str], state_in_names: Sequence[str],
                  device: torch.device):
    """The step function of block 0 of `program`.

    Returns (step, state_out_names): state_out_names are the state vars
    carried through plus every persistable var an op writes (parameter
    updates, accumulators, startup initializers)."""
    if program.amp_dtype is not None:
        raise NotImplementedError(
            f"program.amp_dtype={program.amp_dtype!r}: mixed precision is not "
            "ported; the port trains in float32")
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
    live_out = set(fetch_names) | set(state_out_names)
    plan = _plan_block(block, _autodiff_index(block))

    def step(state: Dict[str, torch.Tensor], feed: Dict[str, torch.Tensor],
             generator: torch.Generator):
        ctx = ExecContext(generator, device)
        env: Dict[str, torch.Tensor] = {}
        env.update(state)
        env.update(feed)
        env = run_block_with_autodiff(block, env, ctx, live_out, plan)
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch {missing} is neither computed by the "
                           "program nor fed")
        fetches = tuple(v.detach() if v.requires_grad else v
                        for v in (env[n] for n in fetch_names))
        new_state = {n: env[n] for n in state_out_names if n in env}
        return fetches, new_state

    return step, state_out_names
