"""Low-precision inference: ``Float16Transpiler``.

Counterpart of ``paddle_tpu/transpiler/inference_transpiler.py``
``Float16Transpiler``. The float32 persistables the program declares are
cast to bfloat16 in the Scope (torch tensors, so no numpy bfloat16 type
is needed), their vars are re-typed, normalization statistics stay
float32, and ``amp_dtype`` is set: the step casts every float32 feed to
bfloat16 at its entry (core/lowering.py), so the whole forward runs in
bfloat16. The port runs bfloat16 AMP only: a program transpiled to
float16 raises "not ported" when its step is built.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.program import Program, default_main_program
from ..core.scope import Scope, global_scope

__all__ = ["Float16Transpiler"]

_TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class Float16Transpiler:
    """t = Float16Transpiler(); t.transpile(program, scope)"""

    #: per-op input slots whose vars stay float32 (normalization
    #: statistics: cast statistics would shift the normalized values)
    _KEEP_SLOTS = {"batch_norm": ("Mean", "Variance"),
                   "fused_bottleneck": ("Mean1", "Variance1", "Mean2",
                                        "Variance2", "Mean3", "Variance3")}

    def _stat_names(self, program: Program):
        keep = set()
        for block in program.blocks:
            for op in block.ops:
                for slot in self._KEEP_SLOTS.get(op.type, ()):
                    keep.update(op.input(slot))
        return keep

    def transpile(self, program: Optional[Program] = None,
                  scope: Optional[Scope] = None,
                  dtype: str = "bfloat16") -> Program:
        """Apply to an INFERENCE program (``clone(for_test=True).prune``
        or load_inference_model's result): the cast replaces the Scope's
        float32 values, which a training program would go on updating."""
        if dtype not in _TORCH:
            raise ValueError(
                f"Float16Transpiler: dtype must be 'bfloat16' or 'float16', "
                f"got {dtype!r}")
        program = program or default_main_program()
        scope = scope or global_scope()
        if any(op.type == "autodiff" for op in program.global_block.ops):
            raise ValueError(
                "Float16Transpiler needs an inference program (it would "
                "quantize the f32 master weights a training program "
                "updates); clone(for_test=True).prune([target]) first")
        target = _TORCH[dtype]
        keep = self._stat_names(program)
        for block in program.blocks:
            for var in block.vars.values():
                if (not var.persistable or var.dtype != "float32"
                        or var.name in keep):
                    continue
                val = scope.find_var(var.name)
                if val is None:
                    continue
                scope.set_var(var.name, val.to(target))
                var.dtype = dtype
        program.amp_dtype = dtype
        program.invalidate_cache()
        return program
