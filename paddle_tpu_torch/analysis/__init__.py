"""Program analysis passes.

Counterpart of ``paddle_tpu/analysis/``. One pass is ported:
``fuse``, the conv-epilogue fusion pre-pass that the Executor runs on
every program (conv2d → batch_norm (→ add) (→ relu) chains rewritten
into ``fused_conv2d`` on a clone; ``PT_FUSE=0`` returns the caller's
object). The verifier, the cost and memory models and the planner are
not ported.
"""

from . import fuse

__all__ = ["fuse"]
