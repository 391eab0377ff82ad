"""The plain ops the Transformer LM runs, on tensors.

Counterparts of registered ops of the JAX package:

* ``layer_norm``   — ops/nn_ops.py ``layer_norm`` (f32 statistics,
  epsilon 1e-5, scale and bias over the normalized dims);
* ``gelu``         — ops/nn_ops.py ``gelu`` (exact erf form);
* ``mul`` / ``fc`` — ops/math_ops.py ``mul`` and layers ``fc``, with the
  weight kept in Paddle's [in, out] layout;
* ``lookup_table`` — ops/tensor_ops.py ``lookup_table`` (embedding rows);
* ``gather``       — ops/tensor_ops.py ``gather`` (rows along axis 0).

The products stay ``torch.matmul``, as the JAX package leaves them to
XLA; on a card they run in full float32 unless the caller turns on TF32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["layer_norm", "gelu", "mul", "fc", "lookup_table", "gather"]


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, *,
               begin_norm_axis: int = 1, epsilon: float = 1e-5
               ) -> torch.Tensor:
    """Normalize over dims >= begin_norm_axis with f32 statistics."""
    dims = tuple(range(begin_norm_axis, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = torch.square(xf - mean).mean(dim=dims, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def mul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [in, out] (the fc/matmul-weight case of ``mul``)."""
    return torch.matmul(x, w)


_ACTS = {None: lambda x: x, "gelu": gelu}


def fc(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
       act: Optional[str] = None) -> torch.Tensor:
    """Fully connected over the last dim: act(x @ w + b)."""
    y = mul(x, w)
    if b is not None:
        y = y + b
    return _ACTS[act](y)


def lookup_table(ids: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Embedding rows w[ids]; a trailing ids dim of 1 is squeezed."""
    if ids.dim() > 1 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    return F.embedding(ids.long(), w)


def gather(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows of x along axis 0 at the flattened index."""
    return x.index_select(0, index.reshape(-1).long())
