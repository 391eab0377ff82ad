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

The registered ``layer_norm`` and ``softmax_with_cross_entropy`` ops
(below the plain functions) run them for the Executor, and the JAX
package's activation table (``_ACTIVATIONS``: relu, sigmoid, tanh, gelu
and the rest) registers one op per entry.

The ResNet path adds the registered ``softmax``,
``cross_entropy``, ``conv2d``, ``pool2d`` and ``batch_norm`` ops, and
``_bn_train``: training-mode batch norm as a ``torch.autograd.Function``
with the JAX package's lean residuals (the input, scale, bias and two
per-channel vectors; x-hat and the ReLU mask are recomputed in the
backward). The convolutions are ``F.conv2d`` (cuDNN on the card), as
the JAX package leaves them to XLA.

The products stay ``torch.matmul``, as the JAX package leaves them to
XLA; on a card they run in full float32 unless the caller turns on TF32.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.registry import register_op, same_shape

__all__ = ["layer_norm", "gelu", "mul", "fc", "lookup_table", "gather",
           "softmax_with_cross_entropy", "conv2d", "pool2d",
           "BatchNormTrain"]


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


@register_op("layer_norm", infer_shape=_ln_infer,
             optional_outputs=("Mean", "Variance"))
def _layer_norm_op(ctx, ins, attrs, wanted=("Y", "Mean", "Variance")):
    y, mean, var = _layer_norm(
        ins["X"][0], ins["Scale"][0] if ins.get("Scale") else None,
        ins["Bias"][0] if ins.get("Bias") else None,
        attrs.get("begin_norm_axis", 1), attrs.get("epsilon", 1e-5))
    out = {"Y": [y]}
    if "Mean" in wanted:
        out["Mean"] = [mean.reshape(-1)]
    if "Variance" in wanted:
        out["Variance"] = [var.reshape(-1)]
    return out


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


# ---------------------------------------------------------------------------
# activations (ops/nn_ops.py :28-74): the JAX package's table, entry for
# entry, each registered as an op of its name (X -> Out, same shape)
# ---------------------------------------------------------------------------

def _where0(cond, x):
    return torch.where(cond, x, torch.zeros_like(x))


_ACTIVATIONS = {
    "relu": lambda x, a: torch.relu(x),
    "sigmoid": lambda x, a: torch.sigmoid(x),
    "logsigmoid": lambda x, a: F.logsigmoid(x),
    "tanh": lambda x, a: torch.tanh(x),
    "tanh_shrink": lambda x, a: x - torch.tanh(x),
    "exp": lambda x, a: torch.exp(x),
    "log": lambda x, a: torch.log(x),
    "sqrt": lambda x, a: torch.sqrt(x),
    "rsqrt": lambda x, a: torch.rsqrt(x),
    "abs": lambda x, a: torch.abs(x),
    "ceil": lambda x, a: torch.ceil(x),
    "floor": lambda x, a: torch.floor(x),
    "round": lambda x, a: torch.round(x),
    "reciprocal": lambda x, a: 1.0 / x,
    "square": lambda x, a: torch.square(x),
    "softplus": lambda x, a: torch.logaddexp(x, torch.zeros_like(x)),
    "softsign": lambda x, a: x / (1 + torch.abs(x)),
    "sin": lambda x, a: torch.sin(x),
    "cos": lambda x, a: torch.cos(x),
    "relu6": lambda x, a: torch.clamp(x, 0, a.get("threshold", 6.0)),
    "leaky_relu": lambda x, a: torch.where(x >= 0, x,
                                           a.get("alpha", 0.02) * x),
    "elu": lambda x, a: torch.where(x >= 0, x, a.get("alpha", 1.0)
                                    * (torch.exp(x) - 1)),
    "brelu": lambda x, a: torch.clamp(x, a.get("t_min", 0.0),
                                      a.get("t_max", 24.0)),
    "soft_relu": lambda x, a: torch.log1p(torch.exp(torch.clamp(
        x, -a.get("threshold", 40.0), a.get("threshold", 40.0)))),
    "hard_sigmoid": lambda x, a: torch.clamp(
        a.get("slope", 0.2) * x + a.get("offset", 0.5), 0, 1),
    "thresholded_relu": lambda x, a: _where0(x > a.get("threshold", 1.0), x),
    "hard_shrink": lambda x, a: _where0(
        torch.abs(x) > a.get("threshold", 0.5), x),
    "softshrink": lambda x, a: torch.sign(x) * torch.clamp_min(
        torch.abs(x) - a.get("lambda", 0.5), 0.0),
    "swish": lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x),
    "gelu": lambda x, a: gelu(x, a.get("approximate", False)),
    "pow": lambda x, a: torch.pow(x, a.get("factor", 1.0)),
    "stanh": lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
        a.get("scale_a", 0.67) * x),
}


def _make_activation(name, fn):
    def compute(ctx, ins, attrs):
        return {"Out": [fn(ins["X"][0], attrs)]}
    register_op(name, infer_shape=same_shape())(compute)


for _n, _f in _ACTIVATIONS.items():
    _make_activation(_n, _f)


# ---------------------------------------------------------------------------
# softmax and cross entropy (ops/nn_ops.py :88, :573)
# ---------------------------------------------------------------------------

def _softmax_bf16(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax`` of a bfloat16 x as XLA computes it in the JAX
    package's step: x - max rounded to bfloat16, its exp in float32, the
    sum of the exps rounded to bfloat16, each exp rounded to bfloat16
    before the division, the quotient rounded."""
    d = (x.float() - x.amax(dim, keepdim=True).float()).bfloat16()
    e = torch.exp(d.float())
    s = e.sum(dim, keepdim=True).bfloat16()
    return (e.bfloat16().float() / s.float()).bfloat16()


@register_op("softmax", infer_shape=same_shape())
def _softmax_op(ctx, ins, attrs):
    x, dim = ins["X"][0], attrs.get("axis", -1)
    if x.dtype == torch.bfloat16:
        return {"Out": [_softmax_bf16(x, dim)]}
    return {"Out": [torch.softmax(x, dim=dim)]}


def _ce_infer(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Y")[0])
    out.shape = tuple(x.shape[:-1]) + (1,)
    out.dtype = x.dtype


@register_op("cross_entropy", infer_shape=_ce_infer)
def _cross_entropy_op(ctx, ins, attrs):
    """Takes probabilities (post-softmax); hard int labels or soft
    distributions; log clamped at 1e-8 as in the JAX package."""
    x, label = ins["X"][0], ins["Label"][0]
    eps = 1e-8
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * torch.log(torch.clamp_min(x, eps)), dim=-1,
                          keepdim=True)
    else:
        lbl = label[..., 0] if label.shape[-1:] == (1,) else label
        p = torch.gather(x, -1, lbl.long()[..., None])
        loss = -torch.log(torch.clamp_min(p, eps))
    return {"Y": [loss]}


# ---------------------------------------------------------------------------
# convolution and pooling, NCHW (ops/nn_ops.py :133-362)
# ---------------------------------------------------------------------------

def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _conv_out_dim(size, k, pad, stride, dil=1):
    return (size + 2 * pad - (dil * (k - 1) + 1)) // stride + 1


def _conv2d_infer(op, block):
    x = block.var(op.input("Input")[0])
    w = block.var(op.input("Filter")[0])
    out = block.var(op.output("Output")[0])
    s, p, d = (_pair(op.attrs.get(k, v)) for k, v in
               (("strides", 1), ("paddings", 0), ("dilations", 1)))
    n, _, h, wd = x.shape
    oc, _, kh, kw = w.shape
    out.shape = (n, oc, _conv_out_dim(h, kh, p[0], s[0], d[0]),
                 _conv_out_dim(wd, kw, p[1], s[1], d[1]))
    out.dtype = x.dtype


def _harmonize_w(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The filter in x's float dtype (math_ops.harmonize, imported here:
    math_ops imports this module)."""
    from .math_ops import harmonize
    return harmonize(x, w)


def conv2d(x: torch.Tensor, w: torch.Tensor, attrs: dict) -> torch.Tensor:
    """NCHW input, OIHW filter, symmetric padding, the op's attrs. The
    filter takes x's float dtype first (a bfloat16 activation meets its
    float32 master in bfloat16), as the JAX package's ``_conv2d`` does.

    Grouped convolutions run natively, which is what the JAX package
    does for a shape its autotune has not measured; its dense expansion
    of the groups (PT_GCONV_DENSE=always) is not ported."""
    w = _harmonize_w(x, w)
    s = _pair(attrs.get("strides", 1))
    p = _pair(attrs.get("paddings", 0))
    d = _pair(attrs.get("dilations", 1))
    groups = attrs.get("groups", 1) or 1
    if 1 < groups < x.shape[1] and os.environ.get(
            "PT_GCONV_DENSE", "auto") in ("1", "always"):
        raise NotImplementedError("PT_GCONV_DENSE=always: the dense "
                                  "expansion of grouped convolutions is "
                                  "not ported; unset it")
    return F.conv2d(x, w, None, s, p, d, groups)


@register_op("conv2d", infer_shape=_conv2d_infer)
def _conv2d_op(ctx, ins, attrs):
    return {"Output": [conv2d(ins["Input"][0], ins["Filter"][0], attrs)]}


def _pool2d_infer(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    if op.attrs.get("global_pooling", False):
        out.shape = tuple(x.shape[:2]) + (1, 1)
    else:
        k = _pair(op.attrs["ksize"])
        s = _pair(op.attrs.get("strides", 1))
        p = _pair(op.attrs.get("paddings", 0))
        n, c, h, w = x.shape
        if op.attrs.get("ceil_mode", False):
            oh = -(-(h + 2 * p[0] - k[0]) // s[0]) + 1
            ow = -(-(w + 2 * p[1] - k[1]) // s[1]) + 1
        else:
            oh = (h + 2 * p[0] - k[0]) // s[0] + 1
            ow = (w + 2 * p[1] - k[1]) // s[1] + 1
        out.shape = (n, c, oh, ow)
    out.dtype = x.dtype


def pool2d(x: torch.Tensor, attrs: dict) -> torch.Tensor:
    """Max pooling pads with -inf; average pooling divides by the count
    of real elements in the window (``exclusive``, the default) or by
    the window size. The padding is symmetric and the output size is
    floored whatever ``ceil_mode`` says, as the JAX package computes it
    (its shape inference, which _pool2d_infer keeps, rounds up with
    ``ceil_mode``). Padding wider than half the window is not ported."""
    ptype = attrs.get("pooling_type", "max")
    if attrs.get("global_pooling", False):
        if ptype == "max":
            return x.amax(dim=(2, 3), keepdim=True)
        return x.mean(dim=(2, 3), keepdim=True)
    k = _pair(attrs["ksize"])
    s = _pair(attrs.get("strides", 1))
    p = _pair(attrs.get("paddings", 0))
    if 2 * p[0] > k[0] or 2 * p[1] > k[1]:
        raise NotImplementedError(f"pool2d with paddings {p} wider than "
                                  f"half the window {k} is not ported")
    if ptype == "max":
        return F.max_pool2d(x, k, s, p)
    return F.avg_pool2d(x, k, s, p,
                        count_include_pad=not attrs.get("exclusive", True))


@register_op("pool2d", infer_shape=_pool2d_infer)
def _pool2d_op(ctx, ins, attrs):
    return {"Out": [pool2d(ins["X"][0], attrs)]}


# ---------------------------------------------------------------------------
# batch norm (ops/nn_ops.py :369-502)
# ---------------------------------------------------------------------------

def _bn_infer(op, block):
    x = block.var(op.input("X")[0])
    y = block.var(op.output("Y")[0])
    y.shape, y.dtype = x.shape, x.dtype
    c = x.shape[1] if len(x.shape) > 1 else x.shape[0]
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        if op.output(slot):
            v = block.var(op.output(slot)[0])
            v.shape, v.dtype = (c,), "float32"


def _bshape(x: torch.Tensor):
    return (1, -1) + (1,) * (x.dim() - 2)


def _reduce_dims(x: torch.Tensor):
    return tuple(i for i in range(x.dim()) if i != 1)


def _bn_apply(x, mean, inv, scale, bias):
    """The normalize-scale-shift pass, the same expression in the
    forward and in the backward's recompute (the ReLU mask must see the
    same y)."""
    b = _bshape(x)
    return (x - mean.reshape(b).to(x.dtype)) * \
        (inv * scale).reshape(b).to(x.dtype) + bias.reshape(b).to(x.dtype)


def _bn_train_stats(x, eps):
    """Batch mean, E[x^2] - mean^2 (no clamp, as the JAX package's
    _bn_train_stats) and rsqrt(var + eps), in float32."""
    dims = _reduce_dims(x)
    xf = x.float()
    mean = xf.mean(dim=dims)
    var = torch.square(xf).mean(dim=dims) - torch.square(mean)
    return mean, var, torch.rsqrt(var + eps)


def stat_cotangents(momentum, g_new_mean, g_new_var, g_saved_mean,
                    g_saved_var):
    """The batch statistics' total cotangents (None where no output
    reached the loss) and the running stats' own: the shared tail of
    both lean VJPs."""
    def tot(g_new, g_saved):
        parts = [t for t in ((1 - momentum) * g_new if g_new is not None
                             else None, g_saved) if t is not None]
        return sum(parts) if parts else None

    return (tot(g_new_mean, g_saved_mean), tot(g_new_var, g_saved_var),
            None if g_new_mean is None else momentum * g_new_mean,
            None if g_new_var is None else momentum * g_new_var)


def add_stat_terms(dx, xf, mean, g_mean_tot, g_var_tot, m, b):
    """d mean/dx = 1/m and d var/dx = 2 (x - mean)/m, for the statistics
    that reach the loss (in a training step none does: they feed state)."""
    if g_mean_tot is not None:
        dx = dx + (g_mean_tot / m).reshape(b)
    if g_var_tot is not None:
        dx = dx + (xf - mean.reshape(b)) * (2.0 * g_var_tot / m).reshape(b)
    return dx


class BatchNormTrain(torch.autograd.Function):
    """Training-mode batch norm (+ ReLU) with the JAX package's lean VJP
    (``_bn_train``): the backward keeps only x, scale, bias, the batch
    mean and rsqrt(var + eps), and recomputes x-hat and the ReLU mask.
    Returns (y, new running mean, new running var, batch mean, batch
    var); every output has its exact cotangent, including the stats."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean_in, var_in, eps, momentum, relu):
        mean, var, inv = _bn_train_stats(x, eps)
        new_mean = momentum * mean_in + (1 - momentum) * mean
        new_var = momentum * var_in + (1 - momentum) * var
        y = _bn_apply(x, mean, inv, scale, bias)
        if relu:
            y = torch.clamp_min(y, 0)
        ctx.save_for_backward(x, scale, bias, mean, inv)
        ctx.momentum, ctx.relu = momentum, relu
        # outputs that do not reach the loss get None, not a zero tensor
        ctx.set_materialize_grads(False)
        return y, new_mean, new_var, mean, var

    @staticmethod
    def backward(ctx, gy, g_new_mean, g_new_var, g_saved_mean, g_saved_var):
        x, scale, bias, mean, inv = ctx.saved_tensors
        dims, b = _reduce_dims(x), _bshape(x)
        m = x.numel() // x.shape[1]
        if gy is None:
            gy = torch.zeros_like(x)
        if ctx.relu:
            y = _bn_apply(x, mean, inv, scale, bias)
            gy = torch.where(y > 0, gy, torch.zeros_like(gy))
        gyf, xf = gy.float(), x.float()
        xhat = (xf - mean.reshape(b)) * inv.reshape(b)
        dbeta = gyf.sum(dim=dims)
        dgamma = (gyf * xhat).sum(dim=dims)
        dx = (scale.float() * inv).reshape(b) * (
            gyf - (dbeta / m).reshape(b) - xhat * (dgamma / m).reshape(b))
        g_mean_tot, g_var_tot, g_mean_in, g_var_in = stat_cotangents(
            ctx.momentum, g_new_mean, g_new_var, g_saved_mean,
            g_saved_var)
        dx = add_stat_terms(dx, xf, mean, g_mean_tot, g_var_tot, m, b)
        return (dx.to(x.dtype), dgamma.to(scale.dtype), dbeta.to(bias.dtype),
                g_mean_in, g_var_in, None, None, None)


def _bn_train(x, scale, bias, mean_in, var_in, eps, momentum, relu):
    """(y, new_mean, new_var, batch mean, batch var) of training-mode
    batch norm, through BatchNormTrain."""
    return BatchNormTrain.apply(x, scale, bias, mean_in, var_in, eps,
                                momentum, relu)


@register_op("batch_norm", infer_shape=_bn_infer)
def _batch_norm_op(ctx, ins, attrs):
    """NCHW; the running stats are persistable vars that MeanOut/
    VarianceOut rebind by name. Inference (is_test or use_global_stats)
    normalizes with the running stats; training goes through _bn_train.
    fuse_with_relu folds the activation in. The JAX package's
    PT_BN_PLAIN_VJP A/B switch is not ported."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean_in, var_in = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    relu = bool(attrs.get("fuse_with_relu", False))
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        y = _bn_apply(x, mean_in, torch.rsqrt(var_in + eps), scale, bias)
        if relu:
            y = torch.clamp_min(y, 0)
        return {"Y": [y], "MeanOut": [mean_in], "VarianceOut": [var_in],
                "SavedMean": [mean_in], "SavedVariance": [var_in]}
    if os.environ.get("PT_BN_PLAIN_VJP"):
        raise NotImplementedError("PT_BN_PLAIN_VJP (autograd through the "
                                  "plain batch norm) is not ported; unset "
                                  "it")
    y, new_mean, new_var, mean, var = _bn_train(
        x, scale, bias, mean_in, var_in, eps, momentum, relu)
    return {"Y": [y], "MeanOut": [new_mean], "VarianceOut": [new_var],
            "SavedMean": [mean], "SavedVariance": [var]}
