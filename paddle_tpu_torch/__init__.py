"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its module names and never imports it (nor JAX). Entry points run on the
first CUDA device unless the caller asks for the CPU; the CUDA kernels
under ``csrc/`` are built with nvcc at first use.

Two slices are ported:

* serving: the Transformer LM through the paged decode engine,
  ``paddle_tpu_torch.serving.decode.DecodeEngine``;
* training: programs built with ``layers`` under ``program_guard`` and
  trained by ``Executor`` (``Executor(CPUPlace())`` on the CPU), e.g.
  ``models.transformer.transformer_lm_loss`` with
  ``optimizer.AdamOptimizer``.
"""

from . import layers, ops, optimizer
from .core.executor import CPUPlace, CUDAPlace, Executor
from .core.program import (Program, default_main_program,
                           default_startup_program, program_guard)
from .core.scope import Scope, global_scope, scope_guard
from .param_attr import ParamAttr

__all__ = ["layers", "ops", "optimizer", "CPUPlace", "CUDAPlace", "Executor",
           "Program", "default_main_program", "default_startup_program",
           "program_guard", "Scope", "global_scope", "scope_guard",
           "ParamAttr"]
