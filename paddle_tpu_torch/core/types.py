"""Dtype map and device resolution.

Counterpart of ``paddle_tpu/core/types.py``. The JAX package runs with
x64 off, so 64-bit host dtypes narrow to 32 bits on the device: token ids
fed as int64 are int32 on the JAX side, and the port keeps that width at
its public surfaces (exported feed specs, block tables, context lengths).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["device_dtype", "resolve_device"]


def device_dtype(dtype: str) -> str:
    """64-bit host dtypes narrow to 32-bit on device, as in the JAX
    package."""
    return {"int64": "int32", "float64": "float32"}.get(dtype, dtype)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the first CUDA device unless the
    caller names another. Asking for CUDA without a card raises — an entry
    point never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
