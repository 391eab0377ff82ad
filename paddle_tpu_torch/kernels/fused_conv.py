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
them and what the design does about it), each in a float32 and a
bfloat16 instance:

* ``channel_stats`` / ``channel_stats_bf16`` replace the Pallas
  ``channel_stats`` (``_stats_kernel``);
* ``apply_epilogue`` / ``apply_epilogue_bf16`` replace
  ``apply_epilogue`` without an addend (``_apply_kernel``);
* ``apply_epilogue_add`` / ``apply_epilogue_add_bf16`` replace
  ``apply_epilogue`` with one (``_apply_add_kernel``).

The bfloat16 kernels read a (and the addend) as bfloat16, compute in
float32 and round y once to bfloat16, where the Pallas kernels round
(``out_ref[0] = y.astype(out_ref.dtype)``); the sums, scale_c and
shift_c are float32 in both. The float32 wrappers hand a bfloat16 a to
the bfloat16 ones, which count their own launches; any other dtype, or
an addend of another dtype than a, raises on the card.

Each wrapper runs its plain version (``channel_stats_reference``,
``apply_epilogue_reference``) only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises, and counts the launch in its
``launches`` attribute. A call's host path is short: the plan of a
shape is computed once (``_plans``), a call allocates its output alone
(the stats kernel's tickets and partials live in one scratch buffer a
stream), and the device is switched only where it is not the current
one.

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
import functools
import os
from typing import Dict, Optional, Tuple

import torch

from . import build

__all__ = ["channel_stats_reference", "apply_epilogue_reference",
           "channel_stats", "apply_epilogue", "apply_epilogue_add",
           "channel_stats_bf16", "apply_epilogue_bf16",
           "apply_epilogue_add_bf16", "FusedConvEpilogue",
           "fused_conv_epilogue", "reference_epilogue", "epilogue_enabled"]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def channel_stats_reference(a: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a [N, C, S] -> (Σa [C], Σa² [C]) in float32: the sums of the
    float32 widening of a (exact for bfloat16), as the Pallas kernel
    sums them."""
    af = a.float()
    return af.sum(dim=(0, 2)), (af * af).sum(dim=(0, 2))


def apply_epilogue_reference(a: torch.Tensor, scale_c: torch.Tensor,
                             shift_c: torch.Tensor,
                             addend: Optional[torch.Tensor] = None,
                             relu: bool = True) -> torch.Tensor:
    """a [N, C, S], scale_c/shift_c [C] float32, addend [N, C, S] or
    None: a·scale_c + shift_c (+ addend), then ReLU if asked, in float32,
    rounded once to a's dtype (the Pallas kernels' one rounding). The
    affine is one fused multiply-add (addcmul), as XLA contracts the
    Pallas kernel's product and sum and as the CUDA kernels compute it."""
    y = torch.addcmul(shift_c.reshape(1, -1, 1), a.float(),
                      scale_c.reshape(1, -1, 1))
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
_L = ctypes.c_long
_THREADS = 256     # threads a block in every kernel of csrc/fused_conv.cu
_GROUP = 256       # channels a ticket of the stats kernel

# by the kernels' dtype: (elements of a thread's 16-byte vector, the
# (symbol, argument types) of the stats, apply and apply + add entry
# points of csrc/fused_conv.cu)
_STATS_ARGS = (_P,) * 4 + (_I,) * 5 + (_L, _P)
_APPLY_ARGS = (_P,) * 4 + (_I,) * 6 + (_P,)
_APPLY_ADD_ARGS = (_P,) * 5 + (_I,) * 6 + (_P,)
_KERNELS = {
    torch.float32: (4, ("fused_conv_channel_stats_f32", _STATS_ARGS),
                    ("fused_conv_apply_f32", _APPLY_ARGS),
                    ("fused_conv_apply_add_f32", _APPLY_ADD_ARGS)),
    torch.bfloat16: (8, ("fused_conv_channel_stats_bf16", _STATS_ARGS),
                     ("fused_conv_apply_bf16", _APPLY_ARGS),
                     ("fused_conv_apply_add_bf16", _APPLY_ADD_ARGS)),
}
# the float32 entry points by name (scripts/torch_fused_conv_probe.py)
_STATS, _APPLY, _APPLY_ADD = _KERNELS[torch.float32][1:]


def _fn(entry):
    return build.bind("fused_conv.cu", *entry)


def _lanes(cs: int, sms: int, per: int = 4) -> int:
    """Threads a row group of both kernels: a block reads per * lanes
    columns of each row of a [N, C*S] (per = 4 float32 or 8 bfloat16
    elements, one 16-byte vector a thread). The widest range that still
    gives four column ranges an SM (longer runs of a row a block); 32
    where the rows are read as scalars (C*S % per != 0)."""
    if cs % per == 0:
        for lanes in (256, 128, 64):
            if -(-cs // (per * lanes)) >= 4 * sms:
                return lanes
    return 32


def _stats_plan(n: int, c: int, s: int, sms: int,
                per: int = 4) -> Tuple[int, int, int]:
    """(lanes, rows a slice, partials a statistic) of the stats kernel:
    the rows are sliced only where the column ranges alone give fewer
    than two blocks an SM (at most one slice a row group)."""
    lanes = _lanes(c * s, sms, per)
    ranges = -(-c * s // (per * lanes))
    parts = max(1, min(-(-2 * sms // ranges), -(-n // (_THREADS // lanes))))
    rows = -(-n // parts)
    return lanes, rows, -(-n // rows) * (ranges + c)


def _apply_plan(n: int, c: int, s: int, sms: int,
                per: int = 4) -> Tuple[int, int]:
    """(lanes, rows a block) of the apply kernel: 4 rows a thread, 16
    where the column ranges number fewer than four an SM (there fewer,
    longer blocks run faster; elsewhere more, shorter ones:
    scripts/torch_fused_conv_probe.py)."""
    lanes = _lanes(c * s, sms, per)
    rows = 4 if -(-c * s // (per * lanes)) >= 4 * sms else 16
    return lanes, max(rows * (_THREADS // lanes), -(-n // 65535))


@functools.cache
def _plans(n: int, c: int, s: int, index: int, per: int = 4):
    sms = build.sm_count(torch.device("cuda", index))
    return _stats_plan(n, c, s, sms, per), _apply_plan(n, c, s, sms, per)


_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, int]] = {}


def _scratch_of(device: torch.device, stream: int, c: int,
                partials: int) -> Tuple[int, int]:
    """(tickets, partials) pointers of the stats kernel's scratch for
    `stream`: ceil(C / 256) int tickets, zeroed once and set back to 0 by
    each launch, then 2 * partials floats. Calls on one stream run in
    order and share it; calls on two streams never do."""
    key = (device.index, stream)
    buf, tickets = _scratch.get(key, (None, 0))
    if (buf is None or tickets * _GROUP < c
            or buf.numel() < tickets + 2 * partials):
        tickets = max(tickets, 64, -(-c // _GROUP))
        buf = torch.zeros(tickets + max(2 * partials, 1 << 16),
                          dtype=torch.float32, device=device)
        _scratch[key] = buf, tickets
    ptr = buf.data_ptr()
    return ptr, ptr + 4 * tickets


def _stats(a: torch.Tensor, dtype: torch.dtype
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the stats kernel of `dtype` (a must have it)."""
    if a.dim() != 3:
        raise ValueError(f"a must be [N, C, S], got {tuple(a.shape)}")
    n, c, s = a.shape
    dev = a.device
    per, entry, _, _ = _KERNELS[dtype]
    build.check("a", a, dev, (n, c, s), dtype, aligned=True)
    lanes, rows, partials = _plans(n, c, s, dev.index, per)[0]
    out = a.new_empty((2, c), dtype=torch.float32)
    with build.device_guard(dev):
        stream = build.stream(dev)
        tickets, part = _scratch_of(dev, stream, c, partials)
        build.launch("channel_stats", _fn(entry), a.data_ptr(),
                     out.data_ptr(), tickets, part, n, c, s, lanes, rows,
                     partials, stream)
    return out.unbind(0)


def channel_stats(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a [N, C, S] raw conv output -> (Σa [C], Σa² [C]) in float32.

    CPU tensors run ``channel_stats_reference``. CUDA tensors run
    csrc/fused_conv.cu: float32, contiguous, 16-byte aligned; one launch;
    the sums are deterministic (partials per column range and batch
    slice, then a fixed-order pass over them; no float atomics).
    bfloat16 CUDA tensors go to ``channel_stats_bf16``, which counts the
    launch."""
    if not build.on_card("channel_stats", a):
        return channel_stats_reference(a)
    if a.dtype == torch.bfloat16:
        return channel_stats_bf16(a)
    out = _stats(a, torch.float32)
    channel_stats.launches += 1
    return out


channel_stats.launches = 0


def channel_stats_bf16(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``channel_stats`` of a bfloat16 a [N, C, S]: the float32 sums of
    its float32 widening, in the float32 kernel's order of partials (its
    ticket scratch shared), 8 elements a thread's 16-byte load."""
    if not build.on_card("channel_stats_bf16", a):
        return channel_stats_reference(a)
    out = _stats(a, torch.bfloat16)
    channel_stats_bf16.launches += 1
    return out


channel_stats_bf16.launches = 0


def _apply(name: str, dtype: torch.dtype, a, scale_c, shift_c, addend,
           relu):
    """One launch of the apply kernel of `dtype` (a and the addend must
    have it; scale_c and shift_c are float32), with the addend or
    without."""
    if a.dim() != 3:
        raise ValueError(f"a must be [N, C, S], got {tuple(a.shape)}")
    n, c, s = a.shape
    dev = a.device
    per, _, apply, apply_add = _KERNELS[dtype]
    build.check("a", a, dev, (n, c, s), dtype, aligned=True)
    build.check("scale_c", scale_c, dev, (c,), aligned=True)
    build.check("shift_c", shift_c, dev, (c,), aligned=True)
    args = [a.data_ptr(), scale_c.data_ptr(), shift_c.data_ptr()]
    if addend is not None:
        build.check("addend", addend, dev, (n, c, s), dtype, aligned=True)
        args.insert(1, addend.data_ptr())
    lanes, rows = _plans(n, c, s, dev.index, per)[1]
    y = torch.empty_like(a)
    with build.device_guard(dev):
        build.launch(name, _fn(apply if addend is None else apply_add),
                     *args, y.data_ptr(), n, c, s, int(bool(relu)), lanes,
                     rows, build.stream(dev))
    return y


def apply_epilogue(a: torch.Tensor, scale_c: torch.Tensor,
                   shift_c: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """a [N, C, S]; scale_c/shift_c [C] float32 (the BN folded to an
    affine: scale_c = γ·rsqrt(v + eps), shift_c = β − m·scale_c):
    a·scale_c + shift_c, ReLU if asked. One read of a, one write of y.

    CPU tensors run ``apply_epilogue_reference``; CUDA tensors the
    kernel (float32, contiguous, 16-byte aligned); bfloat16 CUDA tensors
    go to ``apply_epilogue_bf16``."""
    if not build.on_card("apply_epilogue", a):
        return apply_epilogue_reference(a, scale_c, shift_c, None, relu)
    if a.dtype == torch.bfloat16:
        return apply_epilogue_bf16(a, scale_c, shift_c, relu)
    y = _apply("apply_epilogue", torch.float32, a, scale_c, shift_c, None,
               relu)
    apply_epilogue.launches += 1
    return y


apply_epilogue.launches = 0


def apply_epilogue_bf16(a: torch.Tensor, scale_c: torch.Tensor,
                        shift_c: torch.Tensor, relu: bool = True
                        ) -> torch.Tensor:
    """``apply_epilogue`` of a bfloat16 a (scale_c, shift_c float32):
    fmaf(a, scale_c, shift_c) in float32, ReLU, one rounding to
    bfloat16."""
    if not build.on_card("apply_epilogue_bf16", a):
        return apply_epilogue_reference(a, scale_c, shift_c, None, relu)
    y = _apply("apply_epilogue_bf16", torch.bfloat16, a, scale_c, shift_c,
               None, relu)
    apply_epilogue_bf16.launches += 1
    return y


apply_epilogue_bf16.launches = 0


def apply_epilogue_add(a: torch.Tensor, scale_c: torch.Tensor,
                       shift_c: torch.Tensor, addend: torch.Tensor,
                       relu: bool = True) -> torch.Tensor:
    """As ``apply_epilogue``, plus the residual addend [N, C, S] that the
    fusion pass absorbed: a·scale_c + shift_c + addend, ReLU if asked.
    bfloat16 CUDA tensors go to ``apply_epilogue_add_bf16``."""
    if not build.on_card("apply_epilogue_add", a):
        return apply_epilogue_reference(a, scale_c, shift_c, addend, relu)
    if a.dtype == torch.bfloat16:
        return apply_epilogue_add_bf16(a, scale_c, shift_c, addend, relu)
    y = _apply("apply_epilogue_add", torch.float32, a, scale_c, shift_c,
               addend, relu)
    apply_epilogue_add.launches += 1
    return y


apply_epilogue_add.launches = 0


def apply_epilogue_add_bf16(a: torch.Tensor, scale_c: torch.Tensor,
                            shift_c: torch.Tensor, addend: torch.Tensor,
                            relu: bool = True) -> torch.Tensor:
    """``apply_epilogue_add`` of a bfloat16 a and addend: the addend
    widened and added in float32, one rounding to bfloat16."""
    if not build.on_card("apply_epilogue_add_bf16", a):
        return apply_epilogue_reference(a, scale_c, shift_c, addend, relu)
    y = _apply("apply_epilogue_add_bf16", torch.bfloat16, a, scale_c,
               shift_c, addend, relu)
    apply_epilogue_add_bf16.launches += 1
    return y


apply_epilogue_add_bf16.launches = 0


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
