"""The plain ops the Transformer LM runs, on tensors, and the registered
ops of the Program path that use them.

Counterparts of registered ops of the JAX package:

* ``layer_norm``   — ops/nn_ops.py ``layer_norm`` (f32 statistics,
  epsilon 1e-5, scale and bias over the normalized dims);
* ``gelu``         — ops/nn_ops.py ``gelu`` (exact erf form);
* ``mul`` / ``fc`` — ops/math_ops.py ``mul`` and layers ``fc``, with the
  weight kept in Paddle's [in, out] layout;
* ``lookup_table`` — ops/tensor_ops.py ``lookup_table`` (embedding rows);
* ``gather``       — ops/tensor_ops.py ``gather`` (rows along axis 0);
* ``softmax_with_cross_entropy`` — ops/nn_ops.py, hard labels: the loss
  is logsumexp minus the picked logit, differentiated by autograd.

The registered ``layer_norm``, ``gelu`` and ``softmax_with_cross_entropy``
ops (below the plain functions) run them for the Executor.

The products stay ``torch.matmul``, as the JAX package leaves them to
XLA; on a card they run in full float32 unless the caller turns on TF32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.registry import register_op, same_shape

__all__ = ["layer_norm", "gelu", "mul", "fc", "lookup_table", "gather",
           "softmax_with_cross_entropy"]


def _layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
                bias: Optional[torch.Tensor], begin_norm_axis: int,
                epsilon: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, variance), the statistics kept-dim and float32."""
    dims = tuple(range(begin_norm_axis, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = torch.square(xf - mean).mean(dim=dims, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    norm_shape = x.shape[begin_norm_axis:]
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    return y, mean, var


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, *,
               begin_norm_axis: int = 1, epsilon: float = 1e-5
               ) -> torch.Tensor:
    """Normalize over dims >= begin_norm_axis with f32 statistics."""
    return _layer_norm(x, scale, bias, begin_norm_axis, epsilon)[0]


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


def softmax_with_cross_entropy(logits: torch.Tensor, label: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard-label softmax cross-entropy over the last dim, in float32.
    label [..., 1] (or [...]) int. Returns (loss [..., 1], softmax), the
    softmax detached (a side output, off the gradient path as in the JAX
    package)."""
    lbl = label if label.shape[-1:] != (1,) else label[..., 0]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1, keepdim=True)
    picked = torch.gather(lf, -1, lbl.long()[..., None])
    return lse - picked, torch.exp(lf - lse).detach()


# ---------------------------------------------------------------------------
# registered ops (the Executor's path)
# ---------------------------------------------------------------------------

def _ln_infer(op, block):
    x = block.var(op.input("X")[0])
    y = block.var(op.output("Y")[0])
    y.shape, y.dtype = x.shape, x.dtype
    ba = op.attrs.get("begin_norm_axis", 1)
    rows = 1
    for s in x.shape[:ba]:
        rows *= s
    for slot in ("Mean", "Variance"):
        if op.output(slot):
            v = block.var(op.output(slot)[0])
            v.shape, v.dtype = (rows,), "float32"


@register_op("layer_norm", infer_shape=_ln_infer)
def _layer_norm_op(ctx, ins, attrs):
    y, mean, var = _layer_norm(
        ins["X"][0], ins["Scale"][0] if ins.get("Scale") else None,
        ins["Bias"][0] if ins.get("Bias") else None,
        attrs.get("begin_norm_axis", 1), attrs.get("epsilon", 1e-5))
    return {"Y": [y], "Mean": [mean.reshape(-1)],
            "Variance": [var.reshape(-1)]}


@register_op("gelu", infer_shape=same_shape())
def _gelu_op(ctx, ins, attrs):
    return {"Out": [gelu(ins["X"][0], attrs.get("approximate", False))]}


def _xent_infer(op, block):
    x = block.var(op.input("Logits")[0])
    out = block.var(op.output("Loss")[0])
    out.shape = tuple(x.shape[:-1]) + (1,)
    out.dtype = x.dtype


@register_op("softmax_with_cross_entropy", infer_shape=_xent_infer)
def _softmax_with_cross_entropy_op(ctx, ins, attrs):
    if attrs.get("soft_label", False):
        raise NotImplementedError("softmax_with_cross_entropy(soft_label="
                                  "True) is not ported")
    loss, soft = softmax_with_cross_entropy(ins["Logits"][0],
                                            ins["Label"][0])
    return {"Loss": [loss], "Softmax": [soft]}
