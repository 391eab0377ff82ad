"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its module names and never imports it (nor JAX). Entry points run on the
first CUDA device unless the caller passes ``device="cpu"``; the CUDA
kernels under ``csrc/`` are built with nvcc at first use.

The first slice serves the Transformer LM through the paged decode engine:
``paddle_tpu_torch.serving.decode.DecodeEngine``.
"""
