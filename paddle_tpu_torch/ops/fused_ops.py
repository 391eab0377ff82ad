"""Fused conv ops: ``fused_conv2d`` and ``fused_bottleneck``.

Counterpart of ``paddle_tpu/ops/fused_ops.py``.

``fused_conv2d`` is what the conv-fusion pass (analysis/fuse.py)
rewrites conv2d → batch_norm (→ elementwise_add) (→ relu) chains into.
The conv is ``F.conv2d``; inference (is_test / use_global_stats) folds
the BN into the conv's weights and bias; training runs the epilogue
kernels of kernels/fused_conv.py through ``FusedConvEpilogue``, or the
``_bn_train`` composition with ``PT_FUSE_EPILOGUE=never``.

``fused_bottleneck`` is a stride-1 ResNet rest block (conv1x1 + BN +
ReLU, conv3x3 + BN + ReLU, conv1x1 + BN, + input, ReLU) as one op. By
default it runs the composition of the individual ops, as the JAX
package does. With ``PT_FUSED_BLOCK=always`` on the card, the blocks
the JAX package's gate takes (H == W, N >= 8, S >= CHAIN_MIN_S (196),
Cin % 128 == 0, C % 64 == 0), up to the C that the card's 1x1 kernels
take (``conv1x1_max_c``: 704 in float32, 256 in bfloat16) and, in
bfloat16, the row W that bwd_mid_bf16 takes (``chain_max_w``, 191), run
the bottleneck chain of kernels/fused_block.py (``_chain_block``),
forward and backward through its kernels; the others compose, forward
and backward.

Both ops take a bfloat16 input with float32 filters (a bf16 program, or
a float32 one under AMP): the filters follow x's float dtype, as the JAX
package harmonizes them. The epilogue kernels have bfloat16 versions, and
so do the chain's eight kernels, forward and backward: a bfloat16 block
that the chain's gate takes runs them, with or without a gradient. Any
other dtype than float32 and bfloat16 raises before any launch.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from ..kernels import fused_block as _fb
from ..kernels import fused_conv as _fc
from .math_ops import harmonize
from .nn_ops import _bn_train, _conv2d_infer, conv2d

__all__ = ["chain_requested", "fused_block_enabled", "chain_takes",
           "compose_block"]


def chain_requested() -> bool:
    """Whether PT_FUSED_BLOCK asks for the bottleneck chain (always, or
    1); the env alone, whatever the device."""
    return os.environ.get("PT_FUSED_BLOCK", "auto") in ("1", "always")


def fused_block_enabled(device: torch.device) -> bool:
    """The JAX package's gate of the bottleneck chain: off by default;
    PT_FUSED_BLOCK=always (or 1) takes it on the card. Elsewhere (the
    CPU) the op composes, as the JAX package does off the TPU."""
    return chain_requested() and device.type == "cuda"


def _conv(h, w, pad):
    return F.conv2d(h, w, None, 1, pad)


def compose_block(x, w1, w2, w3, bn_params, eps, momentum):
    """The rest block as the individual ops compute it, the lean BN VJP
    included: (out, the twelve stat outputs). The filters in x's dtype
    (the op harmonizes them)."""
    (g1, b1, m1, v1), (g2, b2, m2, v2), (g3, b3, m3, v3) = bn_params
    h1, nm1, nv1, sm1, sv1 = _bn_train(_conv(x, w1, 0), g1, b1, m1, v1, eps,
                                       momentum, True)
    h2, nm2, nv2, sm2, sv2 = _bn_train(_conv(h1, w2, 1), g2, b2, m2, v2, eps,
                                       momentum, True)
    h3, nm3, nv3, sm3, sv3 = _bn_train(_conv(h2, w3, 0), g3, b3, m3, v3, eps,
                                       momentum, False)
    out = torch.clamp_min(h3 + x, 0.0)
    return out, (nm1, nv1, sm1, sv1, nm2, nv2, sm2, sv2, nm3, nv3, sm3, sv3)


def _chain_block(x, w1, w2, w3, bn_params, eps, momentum):
    """The rest block through the bottleneck chain (FusedBottleneckRest):
    (out, the twelve stat outputs in compose_block's order), the running
    stats updated with the chain's batch stats."""
    n, cin, hh, ww = x.shape
    c = w1.shape[0]
    taps = w2.permute(2, 3, 0, 1).contiguous().reshape(9, c, c)
    (g1, b1, _, _), (g2, b2, _, _), (g3, b3, _, _) = bn_params
    outs = _fb.fused_bottleneck_rest(
        x.contiguous().reshape(n, cin, hh * ww), w1.reshape(c, cin), taps,
        w3.reshape(cin, c), g1.float(), b1.float(), g2.float(), b2.float(),
        g3.float(), b3.float(), hh, eps)
    stats = []
    for k, (_, _, mean_in, var_in) in enumerate(bn_params):
        sm, sv = outs[1 + 2 * k], outs[2 + 2 * k]
        stats += [momentum * mean_in + (1 - momentum) * sm,
                  momentum * var_in + (1 - momentum) * sv, sm, sv]
    return outs[0].reshape(n, cin, hh, ww), tuple(stats)


# the least H·W the chain takes: the JAX package's default (its
# PT_FUSED_BLOCK_MIN_S); 7² blocks compose
CHAIN_MIN_S = 196


def chain_takes(shape, c: int, dtype: torch.dtype, device_type: str) -> bool:
    """The JAX package's shape gate of the chain
    (paddle_tpu/ops/fused_ops.py:212-214) for a block input of `shape` [N,
    Cin, H, W] and C = `c`; on the card, also C and the row W within what
    the chain's kernels of `dtype` take (``conv1x1_max_c``,
    ``chain_max_w``; the plain versions on the CPU take any). The op asks
    once a call, so a block runs the chain both ways or composes both
    ways."""
    n, cin, hh, ww = shape
    if not (hh == ww and n >= 8 and hh * ww >= CHAIN_MIN_S
            and cin % 128 == 0 and c % 64 == 0):
        return False
    if device_type == "cpu":
        return True
    w_cap = _fb.chain_max_w(dtype)
    return (w_cap is None or ww <= w_cap) and c <= _fb.conv1x1_max_c(dtype)


def _chain_takes(x, w1) -> bool:
    """chain_takes on top of fused_block_enabled."""
    return fused_block_enabled(x.device) and chain_takes(
        tuple(x.shape), w1.shape[0], x.dtype, x.device.type)


def _folded(w, scale, bias, mean, var, eps):
    """The conv -> BN fold of inference: w' = w·γ·rsqrt(v + eps) per
    output channel, b' = β − m·γ·rsqrt(v + eps) as [1, C, 1, 1]."""
    inv = torch.rsqrt(var + eps)
    s = (scale * inv).float()
    wf = (w.float() * s.reshape(-1, 1, 1, 1)).to(w.dtype)
    return wf, (bias - mean * scale * inv).reshape(1, -1, 1, 1)


def _fused_conv2d_infer(op, block):
    _conv2d_infer(op, block)
    c = block.var(op.output("Output")[0]).shape[1]
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        if op.output(slot):
            v = block.var(op.output(slot)[0])
            v.shape, v.dtype = (c,), "float32"


@register_op("fused_conv2d", infer_shape=_fused_conv2d_infer)
def fused_conv2d(ctx, ins, attrs):
    """conv2d + batch_norm (+ elementwise_add) (+ relu) as one op; the
    BN's MeanOut/VarianceOut/SavedMean/SavedVariance are the unfused
    op's, so the fusion pass never changes state threading. A kernel
    that fails on the card raises here; nothing falls back."""
    x, w = ins["Input"][0], ins["Filter"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean_in, var_in = ins["Mean"][0], ins["Variance"][0]
    addend = ins["Addend"][0] if ins.get("Addend") else None
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    relu = attrs.get("act", "") == "relu"

    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        wf, bf = _folded(w, scale, bias, mean_in, var_in, eps)
        y = conv2d(x, wf, attrs) + bf.to(x.dtype)
        if addend is not None:
            y = y + addend
        if relu:
            y = torch.clamp_min(y, 0.0)
        return {"Output": [y], "MeanOut": [mean_in],
                "VarianceOut": [var_in], "SavedMean": [mean_in],
                "SavedVariance": [var_in]}

    a = conv2d(x, w, attrs)
    epilogue = (_fc.fused_conv_epilogue if _fc.epilogue_enabled()
                else _fc.reference_epilogue)
    y, nm, nv, sm, sv = epilogue(a, scale, bias, mean_in, var_in, addend,
                                 eps, momentum, relu)
    return {"Output": [y], "MeanOut": [nm], "VarianceOut": [nv],
            "SavedMean": [sm], "SavedVariance": [sv]}


_BN_OUT_SLOTS = ("MeanOut{k}", "VarOut{k}", "SavedMean{k}", "SavedVar{k}")


def _fused_bottleneck_infer(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape, out.dtype = x.shape, x.dtype
    c, cin = block.var(op.input("W2")[0]).shape[0], x.shape[1]
    for k, width in (("1", c), ("2", c), ("3", cin)):
        for slot in _BN_OUT_SLOTS:
            v = block.var(op.output(slot.format(k=k))[0])
            v.shape, v.dtype = (width,), "float32"


@register_op("fused_bottleneck", infer_shape=_fused_bottleneck_infer)
def fused_bottleneck(ctx, ins, attrs):
    x = ins["X"][0]
    w1, w2, w3 = ins["W1"][0], ins["W2"][0], ins["W3"][0]
    bn_params = [tuple(ins[s + k][0] for s in ("Scale", "Bias", "Mean",
                                               "Variance"))
                 for k in ("1", "2", "3")]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    # the filters in x's float dtype, as paddle_tpu/ops/fused_ops.py
    # harmonizes them before either branch (a bf16 block folds its BN into
    # bf16 filters)
    w1, w2, w3 = (harmonize(x, w) for w in (w1, w2, w3))

    if attrs.get("is_test", False):
        # inference: the running stats, folded into the conv weights; the
        # stat outputs pass the running stats through
        def conv_bn(h, w, pad, bn, act):
            wf, bf = _folded(w, *bn, eps)
            y = _conv(h, wf, pad) + bf.to(h.dtype)
            return torch.clamp_min(y, 0.0) if act else y

        h1 = conv_bn(x, w1, 0, bn_params[0], True)
        h2 = conv_bn(h1, w2, 1, bn_params[1], True)
        out = torch.clamp_min(conv_bn(h2, w3, 0, bn_params[2], False) + x,
                              0.0)
        stats = []
        for _, _, m, v in bn_params:
            stats += [m, v, m, v]
    elif _chain_takes(x, w1):
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"fused_bottleneck on {x.dtype} through the bottleneck chain"
                " (PT_FUSED_BLOCK=always): its kernels take float32 and "
                "bfloat16; not ported (unset PT_FUSED_BLOCK to compose the "
                "block)")
        out, stats = _chain_block(x, w1, w2, w3, bn_params, eps, momentum)
    else:
        out, stats = compose_block(x, w1, w2, w3, bn_params, eps, momentum)
    outs = {"Out": [out]}
    for i, k in enumerate(("1", "2", "3")):
        for j, slot in enumerate(_BN_OUT_SLOTS):
            outs[slot.format(k=k)] = [stats[4 * i + j]]
    return outs
