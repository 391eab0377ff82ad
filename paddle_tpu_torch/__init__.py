"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its module names and never imports it (nor JAX). Entry points run on the
first CUDA device unless the caller asks for the CPU; the CUDA kernels
under ``csrc/`` are built with nvcc at first use.

What is ported:

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
  conv epilogues through the kernels of ``kernels.fused_conv``;
* the training step's contract (gradient clipping ``clip``, weight
  decay ``regularizer``, learning-rate schedules
  ``layers.learning_rate_scheduler``, lazy fetches, the step guard
  ``resilience.guard``) and the ``Trainer`` over a reader, with
  crc32-verified checkpoints (``io.save_checkpoint``) and resume;
* bf16 inference: ``transpiler.Float16Transpiler`` casts an inference
  program's weights to bfloat16 (the decode step's among them).
"""

from . import (analysis, clip, io, layers, ops, optimizer, regularizer,
               resilience, transpiler)
from .core.executor import CPUPlace, CUDAPlace, Executor
from .core.program import (Program, default_main_program,
                           default_startup_program, program_guard)
from .core.scope import Scope, global_scope, scope_guard
from .data_feeder import DataFeeder
from .param_attr import ParamAttr
from .trainer import (BeginEpochEvent, BeginStepEvent, CheckpointConfig,
                      EndEpochEvent, EndStepEvent, Inferencer, Trainer)

__all__ = ["analysis", "clip", "io", "layers", "ops", "optimizer",
           "regularizer", "resilience", "transpiler", "CPUPlace", "CUDAPlace", "Executor",
           "Program", "default_main_program", "default_startup_program",
           "program_guard", "Scope", "global_scope", "scope_guard",
           "DataFeeder", "ParamAttr", "Trainer", "CheckpointConfig",
           "Inferencer", "BeginEpochEvent", "EndEpochEvent",
           "BeginStepEvent", "EndStepEvent"]
