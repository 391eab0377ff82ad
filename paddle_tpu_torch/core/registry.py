"""Op registry: op type -> (compute fn, shape inference).

Counterpart of ``paddle_tpu/core/registry.py``. A compute fn takes
``(ctx, ins, attrs)`` with ``ins`` a dict of slot -> list of tensors and
returns a dict of slot -> list of tensors; shape inference runs when the
op is appended to a program. An op registered with ``optional_outputs``
takes a keyword ``wanted`` (the output slots a step reads) and may leave
those slots out when they are not wanted (core/lowering.py's plan). Gradients come from ``torch.autograd``
through the compute fns (core/lowering.py); an op whose backward is a
kernel wraps it in a ``torch.autograd.Function``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["OpImpl", "register_op", "get_op", "require_op",
           "registered_ops", "ExecContext", "same_shape"]


@dataclass
class OpImpl:
    type: str
    # compute(ctx, ins: Dict[str, List[Tensor]], attrs) -> Dict[str, List[Tensor]]
    compute: Callable
    infer_shape: Optional[Callable] = None
    optional_outputs: Tuple[str, ...] = ()


_REGISTRY: Dict[str, OpImpl] = {}


def register_op(type: str, infer_shape: Optional[Callable] = None,
                optional_outputs: Tuple[str, ...] = ()):
    """Decorator: @register_op("mean", infer_shape=_mean_infer)."""

    def deco(fn: Callable):
        if type in _REGISTRY:
            raise ValueError(f"op {type!r} registered twice")
        _REGISTRY[type] = OpImpl(type, fn, infer_shape,
                                 tuple(optional_outputs))
        return fn

    return deco


def get_op(type: str) -> Optional[OpImpl]:
    return _REGISTRY.get(type)


def require_op(type: str) -> OpImpl:
    impl = _REGISTRY.get(type)
    if impl is None:
        raise NotImplementedError(
            f"op {type!r} is not ported to paddle_tpu_torch (the port has "
            f"{len(_REGISTRY)} ops: {registered_ops()})")
    return impl


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)


class ExecContext:
    """Per-run context of the compute fns: the device and the random
    stream. The JAX package threads a PRNG key; the port draws from one
    explicit ``torch.Generator`` on the run's device, seeded from the
    program's ``random_seed`` and the executor's run counter."""

    def __init__(self, generator: torch.Generator, device: torch.device):
        self.generator = generator
        self.device = device


# ---------------------------------------------------------------------------
# Common shape-inference helpers
# ---------------------------------------------------------------------------

def same_shape(in_slot: str = "X", out_slot: str = "Out"):
    def infer(op, block):
        x = block.var(op.input(in_slot)[0])
        out = block.var(op.output(out_slot)[0])
        out.shape, out.dtype = x.shape, x.dtype
    return infer
