"""Dtype tags, variable kinds and device resolution.

Counterpart of ``paddle_tpu/core/types.py``. Variables carry a dtype tag
(a canonical string, serialized in the Program IR). The JAX package runs
with x64 off, so 64-bit host dtypes narrow to 32 bits on the device:
token ids fed as int64 are int32 on the JAX side, and the port keeps that
width at its public surfaces (feeds, exported specs, block tables).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["DTYPES", "normalize_dtype", "device_dtype", "torch_dtype",
           "VarKind", "resolve_device"]

DTYPES = ("float32", "float64", "bfloat16", "float16", "int8", "int32",
          "int64", "uint8", "bool")

_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16, "float16": torch.float16,
          "int8": torch.int8, "int32": torch.int32, "int64": torch.int64,
          "uint8": torch.uint8, "bool": torch.bool}


def normalize_dtype(dtype) -> str:
    """Map a numpy/torch/python dtype-like to a canonical dtype string."""
    if isinstance(dtype, str):
        name = dtype
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).rsplit(".", 1)[-1]
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = getattr(dtype, "name", None) or str(dtype)
    if "bfloat16" in name:
        name = "bfloat16"
    aliases = {"float": "float32", "double": "float64", "int": "int32",
               "long": "int64"}
    name = aliases.get(name, name)
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r} (normalized {name!r})")
    return name


def device_dtype(dtype: str) -> str:
    """64-bit host dtypes narrow to 32-bit on device, as in the JAX
    package."""
    return {"int64": "int32", "float64": "float32"}.get(dtype, dtype)


def torch_dtype(dtype: str) -> torch.dtype:
    """The torch dtype a var of this tag holds on the device (narrowed)."""
    return _TORCH[device_dtype(normalize_dtype(dtype))]


class VarKind:
    """Variable kinds of the IR; the port has dense vars only."""
    DENSE = "dense"


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
