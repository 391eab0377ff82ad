"""Autodiff as a program transform.

Counterpart of ``paddle_tpu/backward.py`` ``append_backward``: it picks
the differentiable parameters, declares the ``@GRAD`` vars, and appends
ONE ``autodiff`` pseudo-op. The lowering (core/lowering.py) runs the ops
before it with the parameters as leaf tensors and binds
``torch.autograd.grad`` of the loss to the ``@GRAD`` names. A block
differentiates once: a second ``append_backward`` of the same loss
merges its parameters into the existing autodiff op.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .core.lowering import AUTODIFF_OP
from .core.program import VarDesc, default_main_program

__all__ = ["GRAD_SUFFIX", "grad_var_name", "append_backward"]

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


def append_backward(loss: VarDesc, parameter_list: Optional[Sequence[str]] = None,
                    no_grad_set: Optional[set] = None,
                    callbacks=None) -> List[Tuple[VarDesc, VarDesc]]:
    """Append the gradient boundary for `loss`; returns [(param, grad)]."""
    program = default_main_program()
    block = program.global_block
    no_grad_set = set(no_grad_set or ())

    if parameter_list is not None:
        param_names = list(parameter_list)
    else:
        param_names = [p.name for p in block.all_parameters() if p.trainable]
    param_names = [p for p in param_names if p not in no_grad_set]

    grad_names = []
    pairs = []
    for p in param_names:
        pvar = block.var(p)
        g = block.create_var(grad_var_name(p), shape=pvar.shape, dtype=pvar.dtype)
        g.stop_gradient = True
        grad_names.append(g.name)
        pairs.append((pvar, g))

    loss_grad = block.create_var(grad_var_name(loss.name), shape=loss.shape,
                                 dtype=loss.dtype)
    loss_grad.stop_gradient = True

    existing = next((op for op in block.ops
                     if op.type == AUTODIFF_OP
                     and op.attrs.get("loss") == loss.name), None)
    if existing is not None:
        merged_p = list(existing.attrs["params"])
        merged_g = list(existing.attrs["grad_names"])
        for p, g in zip(param_names, grad_names):
            if p not in merged_p:
                merged_p.append(p)
                merged_g.append(g)
        existing.attrs["params"] = merged_p
        existing.attrs["grad_names"] = merged_g
        existing.outputs["Grads"] = list(merged_g)
        program.invalidate_cache()
        return pairs
    block.append_op(
        AUTODIFF_OP,
        inputs={}, outputs={"Grads": grad_names},
        attrs={"loss": loss.name, "params": param_names,
               "grad_names": grad_names, "loss_scale": 1.0})
    return pairs
