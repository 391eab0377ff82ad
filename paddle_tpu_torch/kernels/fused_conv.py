"""Conv-epilogue kernels: the batch statistics and the normalize (+ add)
(+ ReLU) pass over a raw conv output, and their plain PyTorch versions.

Counterpart of ``paddle_tpu/kernels/fused_conv.py``. The conv-fusion
pass (analysis/fuse.py) rewrites conv2d → batch_norm (→ add) (→ relu)
chains into ``fused_conv2d`` (ops/fused_ops.py). The conv stays
``F.conv2d``; its training epilogue is two passes over the conv output
``a``, laid out [N, C, S] (S = H·W):

* stats: one read of ``a``, per-channel Σa and Σa² in float32;
* apply: one read of ``a`` (and of the residual addend, when the pass
  absorbed an elementwise_add), one write of y = a·scale_c + shift_c
  (+ addend) (ReLU), with the BN folded to a per-channel affine.

Three kernels, written by hand for Hopper in
``paddle_tpu_torch/csrc/fused_conv.cu`` (its header says what bounds
them and what the design does about it):

* ``channel_stats`` replaces the Pallas ``channel_stats``
  (``_stats_kernel``);
* ``apply_epilogue`` replaces ``apply_epilogue`` without an addend
  (``_apply_kernel``);
* ``apply_epilogue_add`` replaces ``apply_epilogue`` with one
  (``_apply_add_kernel``).

Each wrapper runs its plain version (``channel_stats_reference``,
``apply_epilogue_reference``) only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises, and counts the launch in its
``launches`` attribute.

``FusedConvEpilogue`` is the ``torch.autograd.Function`` of the JAX
package's ``fused_conv_epilogue`` custom VJP: stats → affine fold →
apply forward, and the plain PyTorch port of its lean backward (the JAX
package has no backward kernel for it). ``epilogue_enabled`` is the
gate: ``PT_FUSE_EPILOGUE=never|0`` takes the ``_bn_train`` composition
(``reference_epilogue``), otherwise the op takes these kernels. The JAX
package's per-shape measurement behind the gate (``measure``,
``ensure_tuned``, ``tune_program``) is not ported.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from . import build

__all__ = ["channel_stats_reference", "apply_epilogue_reference",
           "channel_stats", "apply_epilogue", "apply_epilogue_add",
           "FusedConvEpilogue", "fused_conv_epilogue", "reference_epilogue",
           "epilogue_enabled"]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def channel_stats_reference(a: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a [N, C, S] -> (Σa [C], Σa² [C]) in float32."""
    af = a.float()
    return af.sum(dim=(0, 2)), (af * af).sum(dim=(0, 2))


def apply_epilogue_reference(a: torch.Tensor, scale_c: torch.Tensor,
                             shift_c: torch.Tensor,
                             addend: Optional[torch.Tensor] = None,
                             relu: bool = True) -> torch.Tensor:
    """a [N, C, S], scale_c/shift_c [C] float32, addend [N, C, S] or
    None: a·scale_c + shift_c (+ addend), then ReLU if asked."""
    y = a.float() * scale_c.reshape(1, -1, 1) + shift_c.reshape(1, -1, 1)
    if addend is not None:
        y = y + addend.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(a.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_WARPS = 8   # warps per block in every kernel of csrc/fused_conv.cu


def _fn(name: str, argtypes: tuple):
    return build.bind("fused_conv.cu", name, argtypes)


def _check(name: str, t: torch.Tensor, device: torch.device, shape) -> None:
    build.check(name, t, device, shape)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")



def _stats_split(n: int, c: int, sms: int) -> Tuple[int, int]:
    """(rows per block, blocks per channel) of the stats kernel: the
    batch is cut into slices so that C x slices fills the card with
    about 8 blocks per SM (at the stem, 64 channels alone would fill 64
    of 132 SMs)."""
    parts = min(n, -(-8 * sms // c))
    rows = -(-n // parts)
    return rows, -(-n // rows)


def channel_stats(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a [N, C, S] raw conv output -> (Σa [C], Σa² [C]) in float32.

    CPU tensors run ``channel_stats_reference``. CUDA tensors run
    csrc/fused_conv.cu: float32, contiguous, 16-byte aligned; the sums
    are deterministic (partials per batch slice, then a fixed-order pass
    over them; no atomics)."""
    if not build.on_card("channel_stats", a):
        return channel_stats_reference(a)
    if a.dim() != 3:
        raise ValueError(f"a must be [N, C, S], got {tuple(a.shape)}")
    n, c, s = a.shape
    _check("a", a, a.device, (n, c, s))
    rows, parts = _stats_split(n, c, build.sm_count(a.device))
    part = torch.empty((2, c, parts), dtype=torch.float32, device=a.device)
    out = torch.empty((2, c), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        build.launch("channel_stats",
                _fn("fused_conv_channel_stats_f32", (_P,) * 3 + (_I,) * 5
                    + (_P,)),
                a.data_ptr(), part.data_ptr(), out.data_ptr(), n, c, s, rows,
                parts, stream)
    channel_stats.launches += 1
    return out[0], out[1]


channel_stats.launches = 0


def _apply(name: str, symbol: str, a, scale_c, shift_c, addend, relu):
    if a.dim() != 3:
        raise ValueError(f"a must be [N, C, S], got {tuple(a.shape)}")
    n, c, s = a.shape
    _check("a", a, a.device, (n, c, s))
    _check("scale_c", scale_c, a.device, (c,))
    _check("shift_c", shift_c, a.device, (c,))
    if addend is not None:
        _check("addend", addend, a.device, (n, c, s))
    y = torch.empty_like(a)
    rows = n * c
    grid = max(1, min(-(-rows // _WARPS), 16 * build.sm_count(a.device)))
    args = [a.data_ptr()] + ([addend.data_ptr()] if addend is not None
                             else []) + [scale_c.data_ptr(),
                                         shift_c.data_ptr(), y.data_ptr()]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        build.launch(name, _fn(symbol, (_P,) * len(args) + (_I,) * 5 + (_P,)),
                *args, n, c, s, int(bool(relu)), grid, stream)
    return y


def apply_epilogue(a: torch.Tensor, scale_c: torch.Tensor,
                   shift_c: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """a [N, C, S]; scale_c/shift_c [C] float32 (the BN folded to an
    affine: scale_c = γ·rsqrt(v + eps), shift_c = β − m·scale_c):
    a·scale_c + shift_c, ReLU if asked. One read of a, one write of y.

    CPU tensors run ``apply_epilogue_reference``; CUDA tensors the
    kernel (float32, contiguous, 16-byte aligned)."""
    if not build.on_card("apply_epilogue", a):
        return apply_epilogue_reference(a, scale_c, shift_c, None, relu)
    y = _apply("apply_epilogue", "fused_conv_apply_f32", a, scale_c, shift_c,
               None, relu)
    apply_epilogue.launches += 1
    return y


apply_epilogue.launches = 0


def apply_epilogue_add(a: torch.Tensor, scale_c: torch.Tensor,
                       shift_c: torch.Tensor, addend: torch.Tensor,
                       relu: bool = True) -> torch.Tensor:
    """As ``apply_epilogue``, plus the residual addend [N, C, S] that the
    fusion pass absorbed: a·scale_c + shift_c + addend, ReLU if asked."""
    if not build.on_card("apply_epilogue_add", a):
        return apply_epilogue_reference(a, scale_c, shift_c, addend, relu)
    y = _apply("apply_epilogue_add", "fused_conv_apply_add_f32", a, scale_c,
               shift_c, addend, relu)
    apply_epilogue_add.launches += 1
    return y


apply_epilogue_add.launches = 0


# ---------------------------------------------------------------------------
# the differentiable epilogue (fused_conv.py :163-235)
# ---------------------------------------------------------------------------

class FusedConvEpilogue(torch.autograd.Function):
    """BN (+ add) (+ ReLU) over a raw conv output a [N, C, H, W] through
    the kernels. Returns (y, new running mean, new running var, batch
    mean, batch var), the quintuple of ops.nn_ops._bn_train. The batch
    variance is clamped at 0 (E[a²] − mean² can round below it), as in
    the JAX package's epilogue. The backward keeps a, scale, bias, the
    batch mean, rsqrt(var + eps) and the addend, recomputes x-hat and the
    ReLU mask, and gives every input its exact cotangent, the stats'
    included."""

    @staticmethod
    def forward(ctx, a, scale, bias, mean_in, var_in, addend, eps, momentum,
                relu):
        n, c, h, w = a.shape
        a3 = a.contiguous().reshape(n, c, h * w)
        ssum, ssq = channel_stats(a3)
        m = n * h * w
        mean = ssum / m
        var = torch.clamp_min(ssq / m - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        scale_c = scale.float() * inv
        shift_c = bias.float() - mean * scale_c
        if addend is None:
            y3 = apply_epilogue(a3, scale_c, shift_c, relu)
        else:
            y3 = apply_epilogue_add(a3, scale_c, shift_c,
                                    addend.contiguous().reshape(n, c, h * w),
                                    relu)
        new_mean = momentum * mean_in + (1 - momentum) * mean
        new_var = momentum * var_in + (1 - momentum) * var
        ctx.save_for_backward(a, scale, bias, mean, inv, addend)
        ctx.momentum, ctx.relu = momentum, relu
        ctx.set_materialize_grads(False)
        return y3.reshape(a.shape), new_mean, new_var, mean, var

    @staticmethod
    def backward(ctx, gy, g_new_mean, g_new_var, g_saved_mean, g_saved_var):
        from ..ops.nn_ops import add_stat_terms, stat_cotangents

        a, scale, bias, mean, inv, addend = ctx.saved_tensors
        dims, b = (0, 2, 3), (1, -1, 1, 1)
        m = a.shape[0] * a.shape[2] * a.shape[3]
        if gy is None:
            gy = torch.zeros_like(a)
        af = a.float()
        xhat = (af - mean.reshape(b)) * inv.reshape(b)
        sf = scale.float()
        if ctx.relu:
            # the pre-ReLU value, never stored, for the mask
            pre = xhat * sf.reshape(b) + bias.float().reshape(b)
            if addend is not None:
                pre = pre + addend.float()
            gy = torch.where(pre > 0, gy, torch.zeros_like(gy))
        g_add = gy.to(addend.dtype) if addend is not None else None
        gyf = gy.float()
        dbeta = gyf.sum(dim=dims)
        dgamma = (gyf * xhat).sum(dim=dims)
        da = (sf * inv).reshape(b) * (
            gyf - (dbeta / m).reshape(b) - xhat * (dgamma / m).reshape(b))
        g_mean_tot, g_var_tot, g_mean_in, g_var_in = stat_cotangents(
            ctx.momentum, g_new_mean, g_new_var, g_saved_mean, g_saved_var)
        da = add_stat_terms(da, af, mean, g_mean_tot, g_var_tot, m, b)
        return (da.to(a.dtype), dgamma.to(scale.dtype), dbeta.to(bias.dtype),
                g_mean_in, g_var_in, g_add, None, None, None)


def fused_conv_epilogue(a, scale, bias, mean_in, var_in, addend, eps,
                        momentum, relu):
    """The kernel-backed epilogue: (y, new_mean, new_var, mean, var)."""
    return FusedConvEpilogue.apply(a, scale, bias, mean_in, var_in, addend,
                                   eps, momentum, relu)


def reference_epilogue(a, scale, bias, mean_in, var_in, addend, eps,
                       momentum, relu):
    """The composition the gate takes with PT_FUSE_EPILOGUE=never: the
    _bn_train of ops/nn_ops.py, then the addend and the ReLU."""
    from ..ops.nn_ops import _bn_train

    if addend is None:
        return _bn_train(a, scale, bias, mean_in, var_in, eps, momentum,
                         relu)
    y, nm, nv, sm, sv = _bn_train(a, scale, bias, mean_in, var_in, eps,
                                  momentum, False)
    y = y + addend
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y, nm, nv, sm, sv


def epilogue_enabled() -> bool:
    """The gate of fused_conv2d's training epilogue: the kernels unless
    PT_FUSE_EPILOGUE is never or 0. The JAX package measures each shape
    to choose; the port has no measurement yet and takes the kernels."""
    return os.environ.get("PT_FUSE_EPILOGUE", "auto") not in ("0", "never")
