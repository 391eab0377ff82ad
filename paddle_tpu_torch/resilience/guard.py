"""The step guard: an in-graph health flag and the guarded update.

Counterpart of ``paddle_tpu/resilience/guard.py``:

1. **step health** — one bool a step::

       healthy = isfinite(loss) ∧ isfinite(‖grads‖₂) ∧ ‖grads‖₂ ≤ PT_GUARD_MAX_GNORM

   computed by the ``step_health`` op that ``optimizer.minimize``
   appends when ``PT_GUARD`` is set (or ``instrument(program)`` on
   demand), directly after the backward boundary, so the norm is the
   raw ``@GRAD`` bindings', before clip and regularization rewrite
   them, divided by the loss scale. ``Executor.run(guard=True)``
   fetches it last.
2. **guarded update** — under ``guard=True`` the lowering returns
   ``torch.where(healthy, updated, old)`` for every persistable var
   (core/lowering.py): an anomalous step leaves parameters, optimizer
   state and step counters as they were.
3. **policy** (``PT_GUARD=skip|rollback|raise``, ``PT_GUARD_PATIENCE``),
   applied by the Trainer where it reads the flags.

The fault sites ``nan_loss`` and ``nan_grad`` (resilience/faults.py)
reach the step as a fault code the executor draws once a guarded step
(``fault_code``) and hands to the step as a host int (the JAX package
feeds it as ``__guard_fault__``): 1 turns the loss into NaN, 2 every
gradient, after the backward, so the health op and the update see what
a poisoned batch would give. Code 0 touches nothing.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

__all__ = [
    "HEALTH_VAR", "HEALTH_OP",
    "GuardConfigError", "StepAnomalyError", "RollbackSignal",
    "policy", "patience", "max_gnorm", "fault_code", "fault_feed",
    "instrument", "maybe_instrument", "is_instrumented",
    "assert_instrumented",
]

#: reserved name of the in-graph health scalar (the `step_health` output)
HEALTH_VAR = "__step_health__"
HEALTH_OP = "step_health"

POLICY_ENV = "PT_GUARD"
PATIENCE_ENV = "PT_GUARD_PATIENCE"
MAX_GNORM_ENV = "PT_GUARD_MAX_GNORM"

POLICIES = ("skip", "rollback", "raise")
_OFF = ("", "0", "off", "none", "false")


class GuardConfigError(RuntimeError):
    """Malformed or inconsistent PT_GUARD* configuration."""


class StepAnomalyError(RuntimeError):
    """PT_GUARD_PATIENCE consecutive anomalous steps under PT_GUARD=raise
    (or a rollback that cannot be made under PT_GUARD=rollback)."""


class RollbackSignal(Exception):
    """The Trainer's request to roll back to the newest verified
    checkpoint; never leaves Trainer.train."""

    def __init__(self, epoch: int, step: int, streak: int):
        self.epoch, self.step, self.streak = epoch, step, streak
        super().__init__(
            f"{streak} consecutive anomalous steps "
            f"(last: epoch {epoch} step {step})")


def policy() -> Optional[str]:
    """The armed recovery policy, or None when the guard is off."""
    raw = os.environ.get(POLICY_ENV, "").strip().lower()
    if raw in _OFF:
        return None
    if raw not in POLICIES:
        raise GuardConfigError(
            f"{POLICY_ENV}={raw!r}: unknown policy "
            f"(want {' | '.join(POLICIES)}, or unset/0 to disable)")
    return raw


def patience() -> int:
    """Consecutive anomalous steps before raise/rollback act (default 3)."""
    raw = os.environ.get(PATIENCE_ENV, "").strip()
    if not raw:
        return 3
    try:
        k = int(raw)
    except ValueError as e:
        raise GuardConfigError(f"{PATIENCE_ENV}={raw!r}: not an int") from e
    if k < 1:
        raise GuardConfigError(f"{PATIENCE_ENV} must be >= 1, got {k}")
    return k


def max_gnorm() -> float:
    """The global gradient-norm ceiling (default inf: only non-finite
    values trip the guard), read each guarded step."""
    raw = os.environ.get(MAX_GNORM_ENV, "").strip()
    if not raw:
        return float("inf")
    try:
        g = float(raw)
    except ValueError as e:
        raise GuardConfigError(f"{MAX_GNORM_ENV}={raw!r}: not a float") from e
    if not g > 0:
        raise GuardConfigError(f"{MAX_GNORM_ENV} must be > 0, got {g}")
    return g


# -- the fault code ----------------------------------------------------------

def fault_code() -> int:
    """One draw of the in-graph fault sites for one step: both sites are
    hit on every guarded step (so `nan_loss@N` means step N of the
    process); nan_loss wins when both fire."""
    from . import faults
    code = 1 if faults.fire("nan_loss") is not None else 0
    if faults.fire("nan_grad") is not None and code == 0:
        code = 2
    return code


def fault_feed(n_steps: Optional[int] = None):
    """The fault codes of one dispatch: an int for Executor.run (and a
    shared-feed run_loop: one draw a window), or a list of n_steps ints
    for per_step_feeds windows (one draw a step)."""
    if n_steps is None:
        return fault_code()
    return [fault_code() for _ in range(n_steps)]


# -- program instrumentation -------------------------------------------------

def is_instrumented(program) -> bool:
    return any(op.type == HEALTH_OP for op in program.global_block.ops)


def assert_instrumented(program) -> None:
    if not is_instrumented(program):
        raise GuardConfigError(
            "guarded execution requested but the program has no "
            f"{HEALTH_OP!r} op — set {POLICY_ENV} before building it "
            "(optimizer.minimize instruments the program) or call "
            "resilience.guard.instrument(program) explicitly")


def instrument(program=None):
    """Append the `step_health` op (idempotent): Health <- Loss and the
    raw `@GRAD` bindings of the program's autodiff boundary, placed
    directly after that boundary (the clip ops rewrite the @GRAD names
    in place further down)."""
    from ..core.lowering import AUTODIFF_OP
    from ..core.program import default_main_program
    program = program if program is not None else default_main_program()
    block = program.global_block
    bop = next((op for op in block.ops if op.type == AUTODIFF_OP), None)
    if bop is None:
        raise GuardConfigError(
            "cannot instrument a program without an autodiff boundary — "
            "run optimizer.minimize / append_backward first")
    existing = next((op for op in block.ops if op.type == HEALTH_OP), None)
    if existing is not None:
        existing.inputs["Loss"] = [bop.attrs["loss"]]
        existing.inputs["Grads"] = list(bop.attrs["grad_names"])
        program.invalidate_cache()
        return program
    hv = block.create_var(HEALTH_VAR, shape=(), dtype="bool")
    hv.stop_gradient = True
    op = block.append_op(HEALTH_OP,
                         {"Loss": [bop.attrs["loss"]],
                          "Grads": list(bop.attrs["grad_names"])},
                         {"Health": [hv]}, {})
    block.ops.remove(op)
    block.ops.insert(block.ops.index(bop) + 1, op)
    program.invalidate_cache()
    return program


def maybe_instrument(program=None):
    """Instrument iff PT_GUARD is armed (the optimizer.minimize hook)."""
    if policy() is None:
        return program
    return instrument(program)


# -- the step_health op ------------------------------------------------------

def grad_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """‖grads‖₂ over all of them, in float32 (0-dim)."""
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.sqrt(torch.sum(torch.square(torch.stack(norms))))


def _register_op() -> None:
    from ..core.registry import register_op

    def _health_shape(op, block):
        out = block.var(op.output("Health")[0])
        out.shape, out.dtype = (), "bool"

    @register_op(HEALTH_OP, infer_shape=_health_shape)
    def step_health(ctx, ins, attrs):
        loss = ins["Loss"][0]
        # the grads carry the autodiff loss scale: the ceiling is in
        # true-gradient units
        gnorm = grad_norm(ins.get("Grads", [])).to(loss.device) \
            / getattr(ctx, "loss_scale", 1.0)
        healthy = (torch.isfinite(loss).all() & torch.isfinite(gnorm)
                   & (gnorm <= max_gnorm()))
        return {"Health": [healthy]}


_register_op()
