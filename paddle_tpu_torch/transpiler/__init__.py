"""Program-to-program rewrites.

Counterpart of ``paddle_tpu/transpiler/``. Ported: ``Float16Transpiler``
(bfloat16 inference). The others (``InferenceTranspiler``'s BN folding,
the distribute, pipeline and memory transpilers) are not ported yet.
"""

from .inference_transpiler import Float16Transpiler

__all__ = ["Float16Transpiler"]
