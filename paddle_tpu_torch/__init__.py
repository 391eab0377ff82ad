"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its module names and never imports it (nor JAX). Entry points run on the
first CUDA device unless the caller asks for the CPU; the CUDA kernels
under ``csrc/`` are built with nvcc at first use.

Three slices are ported:

* serving: ``paddle_tpu_torch.serving.ServingEngine`` (micro-batching,
  hot reload, its HTTP front end ``serving.http`` and the Prometheus
  exposition ``obs.metrics``) over the artifacts of
  ``io.export_serving_model``, and the Transformer LM's decode bundle
  (``io.export_decode_model``) through the paged decode engine,
  ``serving.decode.DecodeEngine``;
* training: programs built with ``layers`` under ``program_guard`` and
  trained by ``Executor`` (``Executor(CPUPlace())`` on the CPU), e.g.
  ``models.transformer.transformer_lm_loss`` with
  ``optimizer.AdamOptimizer``;
* ResNet training: ``models.resnet.get_model`` (Momentum) through the
  same Executor, whose conv-fusion pass (``analysis.fuse``) runs the
  conv epilogues through the kernels of ``kernels.fused_conv``.
"""

from . import analysis, layers, ops, optimizer
from .core.executor import CPUPlace, CUDAPlace, Executor
from .core.program import (Program, default_main_program,
                           default_startup_program, program_guard)
from .core.scope import Scope, global_scope, scope_guard
from .param_attr import ParamAttr

__all__ = ["analysis", "layers", "ops", "optimizer", "CPUPlace", "CUDAPlace", "Executor",
           "Program", "default_main_program", "default_startup_program",
           "program_guard", "Scope", "global_scope", "scope_guard",
           "ParamAttr"]
