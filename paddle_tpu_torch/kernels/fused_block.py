"""The ResNet bottleneck chain: a stride-1 rest block (1x1 conv + BN +
ReLU, 3x3 conv + BN + ReLU, 1x1 conv + BN, + input, ReLU, every BN in
training mode) as four forward and four backward kernels, with the
plain PyTorch version of each.

Counterpart of ``paddle_tpu/kernels/fused_block.py``, with its layouts:
activations [N, C, S] with S = H·W, ``w1`` [C, Cin], ``taps`` [9, C, C]
indexed [ky*3 + kx] as [Cout, Cin], ``w3`` [Cin, C]; statistics are
float32 sums and sums of squares. The chain never materializes h1, h2 or
a3: the 3x3 and the last 1x1 normalize their input on load, and bn3's
statistics come analytically from the moments of h2 (mean(a3) = W3·mean
(h2), E[a3²] = diag(W3 E[h2 h2ᵀ] W3ᵀ)).

Eight kernels, written by hand for Hopper: the forward's entry points
in ``paddle_tpu_torch/csrc/fused_block.cu``, the backward's in
``csrc/fused_block_bwd.cu``, sharing the passes of
``csrc/fused_block.cuh`` that add per-tile sums in a fixed order. Every
product runs on the tensor cores in 3xTF32: ``conv1x1_stats``, W1·x
streamed through a ring of asynchronous copies, y and its sums in the
same launch, is ``csrc/conv1x1_stats_tc.cuh`` (on ``bwd_apply3``'s
tile, copies and product), ``conv3x3_norm_stats``, over halo tiles,
``csrc/conv3x3_tc.cuh``, ``norm_relu_moments``, a split-K Gram product over
the upper triangle, h normalized as it lands, ``csrc/moments_tc.cuh``,
``conv1x1_bn_residual``, over an h2 tile built once a block,
``csrc/conv1x1_tc.cuh`` (shared with ``bwd_final``'s dx),
``bwd_reduce3``, a split-K product fed by asynchronous copies (in
float32 on the CUDA cores), ``csrc/bwd_reduce3.cuh``, ``bwd_apply3``,
the stacked product [amat | bmat]·[g3; h2] fed by asynchronous copies,
``csrc/bwd_apply3_tc.cuh``, ``bwd_mid``, whose input gradient is the
3x3 kernel over da2 and whose tap gradients are a split-K
product over the padded grid, ``csrc/bwd_mid_tc.cuh``, and
``bwd_final``, whose dx folds da1 once and whose dW1 is a split-K
product over N·S, ``csrc/bwd_final_tc.cuh`` (each source's header says
what bounds its kernels and what the design does about it). Each
replaces the Pallas kernel of its name:

* forward: ``conv1x1_stats`` (``_k1_kernel``), ``conv3x3_norm_stats``
  (``_k2_kernel``), ``norm_relu_moments`` (``_moments_kernel``),
  ``conv1x1_bn_residual`` (``_assemble_kernel``);
* backward, in the order ``bottleneck_rest_bwd`` calls them:
  ``bwd_reduce3`` (``_b1a_kernel``), ``bwd_apply3`` (``_b1b_kernel``),
  ``bwd_mid`` (``_b2_kernel``), ``bwd_final`` (``_b3_kernel``).

All eight have bfloat16 versions, written by hand in
``csrc/fused_block_bf16.cu`` (bf16 ``mma.sync`` products summed in
float32, each bf16 output rounded once, the sums of the rounded values,
h rounded to bf16 before its products, a3 float32 through bn3's
affine): ``conv1x1_stats_bf16``, ``conv3x3_norm_stats_bf16``,
``norm_relu_moments_bf16``, ``conv1x1_bn_residual_bf16``, which
``bottleneck_rest_fwd`` takes on a bf16 x, and ``bwd_reduce3_bf16``,
``bwd_apply3_bf16``, ``bwd_mid_bf16``, ``bwd_final_bf16``, which
``bottleneck_rest_bwd`` takes on a bf16 x. The plain versions round
where the Pallas kernels round, on any dtype: bf16 operands widened to
float32 (their products are exact), float32 sums, one rounding of each
bf16 output; on bf16 the affines as XLA contracts them (the normalize
one fused multiply-add, the folded BN backward fma(g, p, a·q) + r).

Each wrapper runs its plain version (``*_reference``) only for tensors
on the CPU; for a CUDA tensor it launches its kernel or raises, and
counts the call in its ``launches`` attribute (one a call, whatever
number of CUDA launches the call makes).

``bottleneck_rest_fwd`` / ``bottleneck_rest_bwd`` are line-for-line
ports of the JAX package's; ``FusedBottleneckRest`` is the
``torch.autograd.Function`` of its ``fused_bottleneck_rest`` custom VJP,
returning (out, m1, v1, m2, v2, m3, v3), the batch statistics exact
cotangent citizens.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import build

__all__ = ["EPS_DEFAULT", "conv1x1_stats_reference",
           "conv3x3_norm_stats_reference", "norm_relu_moments_reference",
           "conv1x1_bn_residual_reference", "bwd_reduce3_reference",
           "bwd_apply3_reference", "bwd_mid_reference",
           "bwd_final_reference", "conv1x1_stats", "conv3x3_norm_stats",
           "norm_relu_moments", "conv1x1_bn_residual", "conv1x1_stats_bf16",
           "conv3x3_norm_stats_bf16", "norm_relu_moments_bf16",
           "conv1x1_bn_residual_bf16", "bwd_reduce3_bf16", "bwd_apply3_bf16",
           "bwd_mid_bf16", "bwd_final_bf16", "bwd_reduce3",
           "bwd_apply3", "bwd_mid", "bwd_final", "bottleneck_rest_fwd",
           "bottleneck_rest_bwd", "FusedBottleneckRest",
           "fused_bottleneck_rest"]

EPS_DEFAULT = 1e-5


def _col(v: torch.Tensor) -> torch.Tensor:
    """[C] -> [1, C, 1], to broadcast a per-channel vector over [N, C, S]."""
    return v.reshape(1, -1, 1)


def _norm_relu(a: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor) -> torch.Tensor:
    """relu(a·scale_c + shift_c) in float32, rounded to a's dtype. The
    affine is one fused multiply-add (addcmul), as XLA contracts the
    Pallas kernels' product and sum and as the CUDA kernels compute it."""
    return torch.clamp_min(torch.addcmul(_col(shift), a.float(),
                                         _col(scale)), 0.0).to(a.dtype)


def _sums(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    yf = y.float()
    return yf.sum(dim=(0, 2)), (yf * yf).sum(dim=(0, 2))


# ---------------------------------------------------------------------------
# plain versions of the forward kernels
# ---------------------------------------------------------------------------

def _product(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w [M, K] · x [N, K, S] in float32: the operands widened (a product
    of two bfloat16 values is exact in float32) and summed in float32, as
    the Pallas kernels' dots with a float32 result."""
    return torch.matmul(w.float(), x.float())


def conv1x1_stats_reference(x: torch.Tensor, w: torch.Tensor):
    """x [N, Cin, S], w [C, Cin] -> (y = W·x [N, C, S], Σy [C], Σy² [C]):
    y summed in float32 and rounded once to x's dtype, the sums of the
    rounded y (``_k1_kernel``)."""
    y = _product(w, x).to(x.dtype)
    return (y,) + _sums(y)


def conv3x3_norm_stats_reference(x: torch.Tensor, taps: torch.Tensor,
                                 scale: torch.Tensor, shift: torch.Tensor,
                                 h_side: int):
    """x [N, Cin, S] raw, taps [9, Cout, Cin], scale/shift [Cin]: the 3x3
    same-padded conv of h = relu(x·scale + shift), as nine shifted K=Cin
    products (h padded with zeros: an out-of-image tap reads 0), and its
    sums. h is rounded to x's dtype before the products, the nine taps
    summed in one float32 accumulator and y rounded once, the sums of the
    rounded y (``_k2_kernel``). Returns (y [N, Cout, S], Σy [Cout], Σy²
    [Cout])."""
    n, cin, s = x.shape
    w_side = s // h_side
    h = _norm_relu(x, scale, shift).reshape(n, cin, h_side, w_side)
    hp = F.pad(h, (1, 1, 1, 1))
    acc = None
    for ky in range(3):
        for kx in range(3):
            hs = hp[:, :, ky:ky + h_side, kx:kx + w_side].reshape(n, cin, s)
            t = _product(taps[ky * 3 + kx], hs)
            acc = t if acc is None else acc + t
    y = acc.to(x.dtype)
    return (y,) + _sums(y)


def norm_relu_moments_reference(x: torch.Tensor, scale: torch.Tensor,
                                shift: torch.Tensor):
    """x [N, C, S] raw -> (Σh [C], M2 = Σ_{n,s} h hᵀ [C, C]) of
    h = relu(x·scale + shift) rounded to x's dtype, in float32
    (``_moments_kernel``)."""
    n, c, s = x.shape
    h = _norm_relu(x, scale, shift).float().permute(1, 0, 2).reshape(c, n * s)
    return h.sum(dim=1), h @ h.T


def conv1x1_bn_residual_reference(x: torch.Tensor, residual: torch.Tensor,
                                  scale2: torch.Tensor, shift2: torch.Tensor,
                                  w: torch.Tensor, scale3: torch.Tensor,
                                  shift3: torch.Tensor) -> torch.Tensor:
    """x [N, C, S] raw a2, residual [N, Cout, S], w [Cout, C]:
    relu((W·relu(x·scale2 + shift2))·scale3 + shift3 + residual). h2 is
    rounded to x's dtype before the product; a3 stays float32 through
    bn3's affine (one fused multiply-add, as XLA contracts it) and the
    residual add, and the output is rounded once (``_assemble_kernel``)."""
    a3 = _product(w, _norm_relu(x, scale2, shift2))
    y = torch.addcmul(_col(shift3), a3, _col(scale3)) + residual.float()
    return torch.clamp_min(y, 0.0).to(x.dtype)


# ---------------------------------------------------------------------------
# plain versions of the backward kernels
# ---------------------------------------------------------------------------

def _affine(a: torch.Tensor, scale: torch.Tensor,
            shift: torch.Tensor) -> torch.Tensor:
    """a·scale_c + shift_c in float32 (a widened). On bfloat16 a, one fused
    multiply-add, as XLA contracts the Pallas kernels' product and sum
    and as the bf16 kernels compute it; on float32 a, the product rounded
    and then the sum, as the float32 kernels' masks take it
    (csrc/fused_block.cuh, ``positive``), so that both zero the same
    elements."""
    if a.dtype == torch.bfloat16:
        return torch.addcmul(_col(shift), a.float(), _col(scale))
    return a.float() * _col(scale) + _col(shift)


def _unfold(g: torch.Tensor, a: torch.Tensor, p: torch.Tensor,
            q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """da = g·p + a·q + r in float32, the folded BN backward. On bfloat16
    operands as XLA contracts the Pallas kernels' sum: a·q rounded, g·p
    added to it in one fused multiply-add, then r added; on float32, each
    product and sum rounded in turn."""
    gf, af = g.float(), a.float()
    if a.dtype == torch.bfloat16:
        return torch.addcmul(af * _col(q), gf, _col(p)) + _col(r)
    return gf * _col(p) + af * _col(q) + _col(r)


def bwd_reduce3_reference(dout, out, a2, scale2, shift2):
    """g3 = dout·(out > 0), P = Σ_n g3 h2ᵀ [Cin, C], Σg3 [Cin]."""
    g3 = torch.where(out > 0, dout, torch.zeros_like(dout))
    g3f = g3.float()
    h2 = _norm_relu(a2, scale2, shift2).float()
    return g3, torch.einsum("nis,ncs->ic", g3f, h2), g3f.sum(dim=(0, 2))


def bwd_apply3_reference(g3, a2, scale2, shift2, amat, bmat, v0, inv2, m2):
    """g2 = (A·g3 + B·h2 + v0)·(h2 > 0) and bn2's Σg2, Σg2·x̂2. h2 is
    rounded to a2's dtype before its product, g2 rounded once, the sums
    of the rounded g2 (``_b1b_kernel``)."""
    h2f = torch.clamp_min(_affine(a2, scale2, shift2), 0.0)
    dh2 = (torch.matmul(amat.float(), g3.float())
           + torch.matmul(bmat.float(), h2f.to(a2.dtype).float()) + _col(v0))
    g2 = torch.where(h2f > 0, dh2, torch.zeros_like(dh2)).to(g3.dtype)
    g2f = g2.float()
    xhat2 = _affine(a2, inv2, -m2 * inv2)
    return g2, g2f.sum(dim=(0, 2)), (g2f * xhat2).sum(dim=(0, 2))


def bwd_mid_reference(g2, a2, a1, scale1, shift1, p2, q2, r2, inv1, m1,
                      taps, h_side):
    """da2 = g2·p2 + a2·q2 + r2 (bn2 folded), rounded to a1's dtype; the
    3x3's input gradient dh1 and its nine tap gradients against h1
    rounded to a1's dtype; g1 = dh1·(h1 > 0) rounded once, and bn1's Σg1,
    Σg1·x̂1 of the rounded g1 (``_b2_kernel``). Returns (g1 [N, C, S],
    dtaps [9, Cout, Cin], Σg1, Σg1·x̂1)."""
    n, cout, s = g2.shape
    cin = taps.shape[2]
    w_side = s // h_side
    da2 = _unfold(g2, a2, p2, q2, r2)
    da2 = da2.to(a1.dtype).float().reshape(n, cout, h_side, w_side)
    h1f = torch.clamp_min(_affine(a1, scale1, shift1), 0.0)
    h1 = h1f.to(a1.dtype).float().reshape(n, cin, h_side, w_side)
    w2 = taps.float().reshape(3, 3, cout, cin).permute(2, 3, 0, 1)
    dh1 = F.conv_transpose2d(da2, w2, padding=1).reshape(n, cin, s)
    dw2 = torch.nn.grad.conv2d_weight(h1, tuple(w2.shape), da2, padding=1)
    dtaps = dw2.permute(2, 3, 0, 1).reshape(9, cout, cin)
    g1 = torch.where(h1f > 0, dh1, torch.zeros_like(dh1)).to(g2.dtype)
    g1f = g1.float()
    xhat1 = _affine(a1, inv1, -m1 * inv1)
    return g1, dtaps, g1f.sum(dim=(0, 2)), (g1f * xhat1).sum(dim=(0, 2))


def bwd_final_reference(g3, g1, a1, x, p1, q1, r1, w1):
    """da1 = g1·p1 + a1·q1 + r1, rounded to a1's dtype; dx = W1ᵀ·da1 + g3
    in float32, rounded once; dW1 = Σ_n da1 xᵀ (``_b3_kernel``)."""
    da1 = _unfold(g1, a1, p1, q1, r1).to(a1.dtype).float()
    dx = torch.matmul(w1.float().T, da1) + g3.float()
    return dx.to(g3.dtype), torch.einsum("ncs,nks->ck", da1, x.float())


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_BK = 8        # the 3x3 kernels' channels a stage: one k8 step


def _fn(name: str, argtypes: tuple):
    return build.bind("fused_block.cu", name, argtypes)


def _dims(name: str, t: torch.Tensor, n: int) -> None:
    if t.dim() != n:
        raise ValueError(f"{name} must have {n} dimensions, got "
                         f"{tuple(t.shape)}")


def _empty(device, *shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device)


_C3_BN = 224   # positions of a conv3x3 column tile (conv3x3::kBN)


def _conv3x3_grid(n: int, h: int, w: int) -> Tuple[int, int, int]:
    """(chunks, T, ring bytes) of conv3x3_norm_stats: each image computed
    on a padded grid of h rows of w + 2 positions, cut into chunks of 224
    positions (the last one past the grid's end), T = n · chunks column
    tiles (each by every tile of 64 output channels); the ring of 3
    stages in shared memory, each the nine taps' A slices [9][64][8] and
    a halo of 8 channel rows of 2R + 226 positions (R = min(w + 2, 226))
    at a pitch of 8 mod 32 floats."""
    chunks = -(-h * (w + 2) // _C3_BN)
    r = min(w + 2, _C3_BN + 2)
    pitch = (2 * r + _C3_BN + 2 + 23) // 32 * 32 + 8
    return chunks, n * chunks, 3 * (9 * 64 * 8 + 8 * pitch) * 4


_STREAM_BK = 16   # rows of K a streamed stage (bwd_apply3::kK)


def _stream_grid(n: int, s: int, c: int,
                 k: int) -> Tuple[int, int, int, int]:
    """(bn, T, rows, lda) of the products streamed through a ring
    (csrc/bwd_apply3_tc.cuh, K = Cin + C; csrc/conv1x1_stats_tc.cuh, K =
    Cin): tiles of 64 rows of C by bn = 128 columns of N·S where C <= 64,
    else 128 rows by 64 columns (a tile may hold the end of one image and
    the start of the next; the last one past N·S), T = ceil(N·S / bn)
    column tiles, each by every row tile; the weight read at rows = whole
    row tiles and a row pitch lda = K in whole 16-row stages."""
    bm = 64 if c <= 64 else 128
    bn = 8192 // bm
    return (bn, -(-n * s // bn), -(-c // bm) * bm,
            -(-k // _STREAM_BK) * _STREAM_BK)


def _stream_weight(w: torch.Tensor, rows: int, lda: int) -> torch.Tensor:
    """w [C, K] as the streamed product reads it, [rows, lda] at a 16-byte
    aligned address: w itself where it already is, else one zero-padded
    copy."""
    c, k = w.shape
    if (rows, lda) != (c, k):
        return F.pad(w, (0, lda - k, 0, rows - c))
    return w if w.data_ptr() % 16 == 0 else w.clone()


def conv1x1_stats(x: torch.Tensor, w: torch.Tensor):
    """x [N, Cin, S], w [C, Cin] -> (y = W·x [N, C, S], Σy [C], Σy² [C]).

    CPU tensors run ``conv1x1_stats_reference``. CUDA tensors run the
    kernel: float32, contiguous; the product in 3xTF32 on the tensor
    cores (within float32's rounding) over ``_stream_grid``'s tiles, W1
    itself where its rows fill whole tiles and Cin whole stages, else a
    zero-padded copy; the sums deterministic (a partial per output tile,
    then a fixed-order pass; no atomics)."""
    if not build.on_card("conv1x1_stats", x):
        return conv1x1_stats_reference(x, w)
    _dims("x", x, 3)
    _dims("w", w, 2)
    n, cin, s = x.shape
    c = w.shape[0]
    build.check("x", x, x.device, (n, cin, s))
    build.check("w", w, x.device, (c, cin))
    _, t, rows, lda = _stream_grid(n, s, c, cin)
    w = _stream_weight(w, rows, lda)
    y = _empty(x.device, n, c, s)
    part, stats = _empty(x.device, 2, c, t), _empty(x.device, 2, c)
    wide = s % 4 == 0 and x.data_ptr() % 16 == 0
    with build.device_guard(x.device):
        build.launch("conv1x1_stats",
                     _fn("fused_block_conv1x1_stats_f32",
                         (_P,) * 5 + (_I,) * 7 + (_P,)),
                     x.data_ptr(), w.data_ptr(), y.data_ptr(),
                     part.data_ptr(), stats.data_ptr(), n, cin, c, s, lda, t,
                     int(wide), build.stream(x.device))
    conv1x1_stats.launches += 1
    return y, stats[0], stats[1]


conv1x1_stats.launches = 0


def conv3x3_norm_stats(x: torch.Tensor, taps: torch.Tensor,
                       scale: torch.Tensor, shift: torch.Tensor,
                       h_side: int):
    """x [N, Cin, S] raw pre-BN activations, taps [9, Cout, Cin]
    ([ky*3 + kx]), scale/shift [Cin] float32, the folded BN applied with
    ReLU on load -> (y [N, Cout, S] raw, Σy [Cout], Σy² [Cout]).

    CPU tensors run ``conv3x3_norm_stats_reference``. CUDA tensors run
    the kernel: float32, contiguous, Cin a multiple of 8, S = h_side ·
    (S // h_side); products in 3xTF32 on the tensor cores (within
    float32's rounding), deterministic sums (``_conv3x3_grid``'s column
    tiles' partials added in a fixed order)."""
    if not build.on_card("conv3x3_norm_stats", x):
        return conv3x3_norm_stats_reference(x, taps, scale, shift, h_side)
    _dims("x", x, 3)
    _dims("taps", taps, 3)
    n, cin, s = x.shape
    cout = taps.shape[1]
    if h_side <= 0 or s % h_side:
        raise ValueError(f"S = {s} is not h_side = {h_side} rows")
    if cin % _BK:
        raise ValueError(f"Cin = {cin}: the kernel takes a multiple of "
                         f"{_BK}")
    build.check("x", x, x.device, (n, cin, s))
    build.check("taps", taps, x.device, (9, cout, cin))
    build.check("scale", scale, x.device, (cin,))
    build.check("shift", shift, x.device, (cin,))
    _, t, _ = _conv3x3_grid(n, h_side, s // h_side)
    if taps.data_ptr() % 16:
        taps = taps.clone()   # its rows are copied 16 bytes at a time
    y = _empty(x.device, n, cout, s)
    part, stats = _empty(x.device, 2, cout, t), _empty(x.device, 2, cout)
    with build.device_guard(x.device):
        build.launch("conv3x3_norm_stats",
                     _fn("fused_block_conv3x3_norm_stats_f32",
                         (_P,) * 7 + (_I,) * 6 + (_P,)),
                     x.data_ptr(), taps.data_ptr(), scale.data_ptr(),
                     shift.data_ptr(), y.data_ptr(), part.data_ptr(),
                     stats.data_ptr(), n, cin, cout, h_side, s // h_side, t,
                     build.stream(x.device))
    conv3x3_norm_stats.launches += 1
    return y, stats[0], stats[1]


conv3x3_norm_stats.launches = 0


_MID_KP = 32   # positions of a tap-gradient stage (bwd_mid::kKP)


def _bwd_mid_grid(n: int, h: int, w: int, c: int,
                  sms: int) -> Tuple[int, int]:
    """(splits, per) of bwd_mid's tap gradients: each image's padded grid
    of h rows of w + 2 positions cut into pieces of 32 (the last one past
    the grid's end), the n · pieces split into runs of `per`. The blocks
    of a split (3 dy rows x the 64 x 64 tiles of [C, C]) run two an SM;
    of the split counts from one wave's worth to two waves' worth, the
    one whose blocks fill their last wave best (the fewest on ties), as
    far as whole pieces allow. The splits cover every piece exactly once, each non-empty."""
    pieces = n * -(-h * (w + 2) // _MID_KP)
    tiles = -(-c // 64)
    blocks, wave = 3 * tiles * tiles, 2 * sms
    want = max(1, wave // blocks)

    def fill(splits):
        return splits * blocks / (-(-splits * blocks // wave) * wave)

    splits = max(range(want, max(want, 2 * wave // blocks) + 1),
                 key=lambda k: (fill(k), -k))
    per = -(-pieces // splits)
    return -(-pieces // per), per


_FINAL_KP = 32   # columns of N·S a dW1 stage (bwd_final::kWK)


def _bwd_final_grid(n: int, s: int, c: int, cin: int,
                    sms: int) -> Tuple[int, int]:
    """(splits, pieces) of bwd_final's dW1 over K = N·S: 32-column pieces
    of N·S (a piece may hold the end of one image and the start of the
    next; the last one past N·S), split p taking pieces [p · pieces //
    splits, (p + 1) · pieces // splits). The blocks of a split (the 64 x
    128 tiles of [C, Cin]) run two an SM; of the split counts from one
    wave's worth to four waves' worth, the one whose blocks fill their
    last wave best (the fewest on ties), at most one split a piece, so
    that none is empty."""
    pieces = -(-n * s // _FINAL_KP)
    blocks, wave = -(-c // 64) * -(-cin // 128), 2 * sms
    want = max(1, wave // blocks)

    def fill(splits):
        return splits * blocks / (-(-splits * blocks // wave) * wave)

    splits = max(range(want, max(want, 4 * wave // blocks) + 1),
                 key=lambda k: (fill(k), -k))
    return min(splits, pieces), pieces


_MOM_KP = 32   # columns of N·S a moments stage (moments::kK)
# the most positions N·S the moments kernel takes: the column of a
# piece's last position stays an int
_MOM_MAX_NS = 2 ** 31 - 1 - _MOM_KP


def _moments_tiles(c: int) -> list:
    """(r0, c0) of norm_relu_moments' tiles, in the kernel's block order:
    the 64-row x 128-column tiles of M2 [C, C] that reach the upper
    triangle, column tile by column tile, rows r0 = 0, 64, ... up to the
    tile that holds the diagonal's end there (moments::Tile)."""
    rows = -(-c // 64)
    return [(64 * rt, 128 * ct) for ct in range(-(-c // 128))
            for rt in range(min(2 * ct + 2, rows))]


@functools.cache   # at C 64 the search below weighs ~800 split counts
def _moments_grid(n: int, s: int, c: int, sms: int) -> Tuple[int, int, int]:
    """(tiles, splits, pieces) of norm_relu_moments over K = N·S:
    32-column pieces of N·S (a piece may hold the end of one image and the
    start of the next; the last one past N·S), split p taking pieces [p ·
    pieces // splits, (p + 1) · pieces // splits). The blocks of a split
    (the tiles of ``_moments_tiles``) run two an SM; of the split counts
    from one wave's worth to four waves' worth, the one whose blocks fill
    their last wave best (the fewest on ties), at most one split a piece,
    so that none is empty, and at most 65535."""
    pieces = -(-n * s // _MOM_KP)
    blocks, wave = len(_moments_tiles(c)), 2 * sms
    want = max(1, wave // blocks)

    def fill(splits):
        return splits * blocks / (-(-splits * blocks // wave) * wave)

    splits = max(range(want, max(want, 4 * wave // blocks) + 1),
                 key=lambda k: (fill(k), -k))
    return blocks, min(splits, pieces, 65535), pieces


def norm_relu_moments(x: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor):
    """x [N, C, S] raw -> (Σh [C], M2 = Σ_{n,s} h hᵀ [C, C]) of
    h = relu(x·scale + shift), the inputs of bn3's analytic statistics.

    CPU tensors run ``norm_relu_moments_reference``. CUDA tensors run the
    kernel: float32, contiguous, N·S at most 2³¹ - 33; the Gram product
    in 3xTF32 on the tensor cores (within float32's rounding), over the
    upper triangle, M2 exactly symmetric; N·S split across blocks
    (``_moments_grid``), the splits' partials added in a fixed order
    (deterministic)."""
    if not build.on_card("norm_relu_moments", x):
        return norm_relu_moments_reference(x, scale, shift)
    _dims("x", x, 3)
    n, c, s = x.shape
    if n * c * s == 0:
        raise ValueError(f"x {tuple(x.shape)} is empty")
    if n * s > _MOM_MAX_NS:
        raise ValueError(f"N·S = {n * s}: the kernel takes at most "
                         f"{_MOM_MAX_NS} positions")
    build.check("x", x, x.device, (n, c, s))
    build.check("scale", scale, x.device, (c,))
    build.check("shift", shift, x.device, (c,))
    _, splits, _ = _moments_grid(n, s, c, build.sm_count(x.device))
    wide = s % 4 == 0 and x.data_ptr() % 16 == 0
    part = _empty(x.device, splits, c, c + 1)
    out = _empty(x.device, c, c + 1)
    with build.device_guard(x.device):
        build.launch("norm_relu_moments",
                     _fn("fused_block_norm_relu_moments_f32",
                         (_P,) * 5 + (_I,) * 5 + (_P,)),
                     x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                     part.data_ptr(), out.data_ptr(), n, c, s, splits,
                     int(wide), build.stream(x.device))
    norm_relu_moments.launches += 1
    return out[:, c], out[:, :c]


norm_relu_moments.launches = 0


_RES_P = 64      # columns of N·S a conv1x1_bn_residual block (conv1x1::kP)
_RES_M = 128     # output rows a chunk (conv1x1::kM)


def _res_grid(n: int, s: int, cout: int, sms: int) -> Tuple[int, int]:
    """(blocks, splits) of conv1x1_bn_residual: 64-column blocks of N·S
    (a block may hold the end of one image and the start of the next; the
    last one past N·S), each by a share of Cout's 128-row chunks, split
    p taking chunks [p · chunks // splits, (p + 1) · chunks // splits).
    Waves count two blocks an SM (one runs above C 304, where the tile
    takes more than half an SM's shared memory; the grid stays right,
    only less even); where N·S alone gives 4 waves or more, one
    split; else, of the split counts up to 4 waves' worth, the one whose
    blocks fill their last wave best (the fewest on ties), at most one
    split a chunk, so that none is empty."""
    blocks, chunks = -(-n * s // _RES_P), -(-cout // _RES_M)
    wave = 2 * sms
    if blocks >= 4 * wave:
        return blocks, 1

    def fill(k):
        return k * blocks / (-(-k * blocks // wave) * wave)

    top = min(chunks, max(1, -(-4 * wave // blocks)))
    return blocks, max(range(1, top + 1), key=lambda k: (fill(k), -k))


def conv1x1_max_c(dtype: torch.dtype = torch.float32) -> int:
    """The most channels C that the chain's kernels of `dtype` take on the
    card: conv1x1_bn_residual's and bwd_final's, their K = C tile and W in
    one block's shared memory (float32: csrc/conv1x1_tc.cuh, 704; bfloat16:
    csrc/conv1x1_bf16_tc.cuh, 256). The chain's gate."""
    if dtype == torch.bfloat16:
        return _bf_fn("fused_block_bf16_conv1x1_max_k", ())()
    return _fn("fused_block_conv1x1_max_c", ())()


def chain_max_w(dtype: torch.dtype = torch.float32):
    """The widest row W that the chain's kernels of `dtype` take on the
    card: in bfloat16, bwd_mid_bf16's tap gradients (abw::kTapMaxW, 191);
    None in float32 (no limit). The chain's gate, beside conv1x1_max_c."""
    return _BF_TAP_MAX_W if dtype == torch.bfloat16 else None


def conv1x1_bn_residual(x: torch.Tensor, residual: torch.Tensor,
                        scale2: torch.Tensor, shift2: torch.Tensor,
                        w: torch.Tensor, scale3: torch.Tensor,
                        shift3: torch.Tensor) -> torch.Tensor:
    """x [N, C, S] raw a2, residual [N, Cout, S] (the block input),
    w [Cout, C]; scale2/shift2 [C] normalize x on load, scale3/shift3
    [Cout] are bn3's affine -> the block output [N, Cout, S].

    CPU tensors run ``conv1x1_bn_residual_reference``. CUDA tensors run
    the kernel (h2 built once a block of 64 columns of N·S, Cout's chunks
    shared out by ``_res_grid``): float32, contiguous, C at most
    ``conv1x1_max_c()`` (the entry point refuses more before it launches);
    the product in 3xTF32 on the tensor cores."""
    if not build.on_card("conv1x1_bn_residual", x):
        return conv1x1_bn_residual_reference(x, residual, scale2, shift2, w,
                                             scale3, shift3)
    _dims("x", x, 3)
    _dims("w", w, 2)
    n, c, s = x.shape
    cout = w.shape[0]
    build.check("x", x, x.device, (n, c, s))
    build.check("residual", residual, x.device, (n, cout, s))
    build.check("w", w, x.device, (cout, c))
    for name, v, k in (("scale2", scale2, c), ("shift2", shift2, c),
                       ("scale3", scale3, cout), ("shift3", shift3, cout)):
        build.check(name, v, x.device, (k,))
    _, splits = _res_grid(n, s, cout, build.sm_count(x.device))
    # W3ᵀ [C, ldw], its rows padded with zeros to a multiple of 4 (a fresh
    # tensor, 16-byte aligned: its rows are copied 16 bytes at a time)
    ldw = -(-cout // 4) * 4
    wt = F.pad(w.t(), (0, ldw - cout)).contiguous()
    out = _empty(x.device, n, cout, s)
    wide = s % 4 == 0 and all(t.data_ptr() % 16 == 0
                              for t in (x, residual))
    with build.device_guard(x.device):
        build.launch("conv1x1_bn_residual",
                     _fn("fused_block_conv1x1_bn_residual_f32",
                         (_P,) * 8 + (_I,) * 7 + (_P,)),
                     x.data_ptr(), residual.data_ptr(), wt.data_ptr(),
                     scale2.data_ptr(), shift2.data_ptr(), scale3.data_ptr(),
                     shift3.data_ptr(), out.data_ptr(), n, c, cout, s, ldw,
                     splits, int(wide), build.stream(x.device))
    conv1x1_bn_residual.launches += 1
    return out


conv1x1_bn_residual.launches = 0


# ---------------------------------------------------------------------------
# the bfloat16 forward kernels (csrc/fused_block_bf16.cu)
# ---------------------------------------------------------------------------

_BF_BN = 128   # columns of N·S of a 1x1 tile, positions of a 3x3 one
_BF_BK = 32    # rows of K a 1x1 stage, positions a moments stage
_BF_C3K = 16   # channels of a 3x3 stage (c3::kBK)
_BF_SPLITS = 128   # the moments' most splits (kMaxSplits)


def _bf_fn(name: str, argtypes: tuple):
    return build.bind("fused_block_bf16.cu", name, argtypes)


def _bf_max_c() -> int:
    return _bf_fn("fused_block_bf16_max_c", ())()


def _bf_check(name: str, t: torch.Tensor, device, shape) -> None:
    build.check(name, t, device, shape, torch.bfloat16, aligned=True)


def _bf_widths(**widths) -> None:
    """Refuse a C past what the bf16 kernels take, before any launch."""
    cap = _bf_max_c()
    for name, c in widths.items():
        if c > cap:
            raise ValueError(f"{name} = {c}: the bfloat16 kernels take at "
                             f"most {cap}")


def _bf_ns(n: int, s: int) -> None:
    """Refuse more positions N·S than the products over N·S take."""
    if n * s > _MOM_MAX_NS:
        raise ValueError(f"N·S = {n * s}: the kernel takes at most "
                         f"{_MOM_MAX_NS} positions")


def _bf_weight(w: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(w [M, K] as a 1x1 kernel reads it: [rows, lda] with rows whole row
    tiles (64 where M <= 64, else 128) and lda = K in whole 32-row stages,
    zero-padded where w is not; lda)."""
    m, k = w.shape
    bm = 64 if m <= 64 else 128
    rows, lda = -(-m // bm) * bm, -(-k // _BF_BK) * _BF_BK
    if (rows, lda) != (m, k):
        w = F.pad(w, (0, lda - k, 0, rows - m))
    return w, lda


def _bf_empty(device, *shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.bfloat16, device=device)


def conv1x1_stats_bf16(x: torch.Tensor, w: torch.Tensor):
    """``conv1x1_stats`` in bfloat16: x [N, Cin, S] and w [C, Cin] bf16 ->
    (y [N, C, S] bf16, Σy [C], Σy² [C] float32).

    CPU tensors run ``conv1x1_stats_reference``. CUDA tensors run the
    kernel: bf16, contiguous, 16-byte aligned, C and Cin at most the
    kernels' cap; the bf16 products summed in float32 on the tensor cores,
    y rounded once, the sums of the rounded y deterministic (a partial a
    column tile, then a fixed-order pass)."""
    if not build.on_card("conv1x1_stats_bf16", x):
        return conv1x1_stats_reference(x, w)
    _dims("x", x, 3)
    _dims("w", w, 2)
    n, cin, s = x.shape
    c = w.shape[0]
    _bf_check("x", x, x.device, (n, cin, s))
    _bf_check("w", w, x.device, (c, cin))
    _bf_widths(C=c, Cin=cin)
    t = -(-n * s // _BF_BN)
    wp, lda = _bf_weight(w)
    y = _bf_empty(x.device, n, c, s)
    part, stats = _empty(x.device, 2, c, t), _empty(x.device, 2, c)
    with build.device_guard(x.device):
        build.launch("conv1x1_stats_bf16",
                     _bf_fn("fused_block_conv1x1_stats_bf16",
                            (_P,) * 5 + (_I,) * 7 + (_P,)),
                     x.data_ptr(), wp.data_ptr(), y.data_ptr(),
                     part.data_ptr(), stats.data_ptr(), n, cin, c, s, lda, t,
                     int(s % 4 == 0), build.stream(x.device))
    conv1x1_stats_bf16.launches += 1
    return y, stats[0], stats[1]


conv1x1_stats_bf16.launches = 0


def conv3x3_norm_stats_bf16(x: torch.Tensor, taps: torch.Tensor,
                            scale: torch.Tensor, shift: torch.Tensor,
                            h_side: int):
    """``conv3x3_norm_stats`` in bfloat16: x [N, Cin, S] and taps [9, Cout,
    Cin] bf16, scale/shift [Cin] float32 -> (y [N, Cout, S] bf16, Σy, Σy²
    [Cout] float32).

    CPU tensors run ``conv3x3_norm_stats_reference``. CUDA tensors run the
    kernel: bf16, contiguous, 16-byte aligned, Cin a multiple of 16, S =
    h_side · (S // h_side); h rounded to bf16 as it lands, the nine taps'
    bf16 products in one float32 accumulator, y rounded once, deterministic
    sums of the rounded y."""
    if not build.on_card("conv3x3_norm_stats_bf16", x):
        return conv3x3_norm_stats_reference(x, taps, scale, shift, h_side)
    _dims("x", x, 3)
    _dims("taps", taps, 3)
    n, cin, s = x.shape
    cout = taps.shape[1]
    if h_side <= 0 or s % h_side:
        raise ValueError(f"S = {s} is not h_side = {h_side} rows")
    if cin % _BF_C3K:
        raise ValueError(f"Cin = {cin}: the kernel takes a multiple of "
                         f"{_BF_C3K}")
    _bf_check("x", x, x.device, (n, cin, s))
    _bf_check("taps", taps, x.device, (9, cout, cin))
    _vectors(x.device, cin, scale=scale, shift=shift)
    _bf_widths(Cin=cin, Cout=cout)
    t = n * -(-h_side * (s // h_side + 2) // _BF_BN)
    y = _bf_empty(x.device, n, cout, s)
    part, stats = _empty(x.device, 2, cout, t), _empty(x.device, 2, cout)
    with build.device_guard(x.device):
        build.launch("conv3x3_norm_stats_bf16",
                     _bf_fn("fused_block_conv3x3_norm_stats_bf16",
                            (_P,) * 7 + (_I,) * 6 + (_P,)),
                     x.data_ptr(), taps.data_ptr(), scale.data_ptr(),
                     shift.data_ptr(), y.data_ptr(), part.data_ptr(),
                     stats.data_ptr(), n, cin, cout, h_side, s // h_side, t,
                     build.stream(x.device))
    conv3x3_norm_stats_bf16.launches += 1
    return y, stats[0], stats[1]


conv3x3_norm_stats_bf16.launches = 0


def _bf_splits(blocks: int, n: int, s: int, sms: int) -> int:
    """The splits of N·S's 32-position pieces of a bf16 product over K =
    N·S whose splits have `blocks` blocks each: enough to fill two blocks
    an SM, at most one a piece and at most 128."""
    return max(1, min(-(-n * s // _BF_BK), _BF_SPLITS, -(-2 * sms // blocks)))


def _bf_moments_splits(n: int, s: int, c: int, sms: int) -> int:
    """The splits of norm_relu_moments_bf16: each tile of M2's upper
    triangle (64 x 64 where C <= 64, else 128 x 128) by `splits` runs of
    N·S's 32-position pieces (``_bf_splits``)."""
    nt = -(-c // (64 if c <= 64 else 128))
    return _bf_splits(nt * (nt + 1) // 2, n, s, sms)


_BF_POS = 64            # positions of a stage of the wgmma products
_BF_ABW_SPLITS = 1024   # their most splits (abw::kMaxSplits)
_BF_TAP_MAX_W = 191     # bwd_mid's widest row (abw::kTapMaxW)


def _bf_groups(s: int) -> int:
    """Channels a row of the wgmma products' tensor maps (abw::group_of):
    8 / gcd(S, 8), so that a row is a multiple of 16 bytes; each width of
    an operand must be a multiple of it."""
    return 8 // math.gcd(s, 8)


def _bf_stages(n: int, s: int) -> int:
    """The 64-position stages of N·S: ceil(S / 64) an image."""
    return n * -(-s // _BF_POS)


def _bf_abw_tiles(kind: str, ma: int, mb: int) -> int:
    """The blocks of a split of a wgmma product over N·S
    (csrc/abt_bf16_tc.cuh): bwd_reduce3 ("reduce3") 128 rows of Cin (ma)
    by 64, 128 or 256 of C (mb: all of it up to 256); bwd_final's dW1
    ("dw1", ma = C, mb = Cin) the same kernel's tiles of x's Cin rows by
    da1's C rows; the tap gradients ("taps") 64 x 64 tiles of (C, C), all
    nine taps a block."""
    if kind == "dw1":
        ma, mb, kind = mb, ma, "reduce3"
    if kind == "reduce3":
        bn = 64 if mb <= 64 else 128 if mb <= 128 else 256
        return -(-ma // 128) * -(-mb // bn)
    return -(-ma // 64) * -(-mb // 64)


def _bf_tile_rows(m: int, k: int) -> int:
    """Rows of M a block of the bf16 1x1 tile (csrc/conv1x1_bf16_tc.cuh,
    t1::rows_of): 256 where K fits beside them (K <= 128), else 128."""
    return 128 if m <= 128 or k > 128 else 256


def _bf_tile_splits(m: int, k: int, n: int, s: int, sms: int) -> int:
    """The splits of N·S's 64-position stages of the 1x1 tile over M rows
    and K channels: its row tiles side by side, one wave of blocks."""
    return _bf_abw_splits(-(-m // _bf_tile_rows(m, k)), n, s, sms)


def _bf_tile_weight(w: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(w [M, K] as the 1x1 tile reads it: [M, lda] with lda = K in whole
    64-column boxes, zero-padded where K is not; lda)."""
    k = w.shape[1]
    lda = -(-k // 64) * 64
    if lda != k:
        w = F.pad(w, (0, lda - k))
    return w.contiguous(), lda


def _bf_tile_k(k: int) -> None:
    """Refuse a K past what the bf16 1x1 tile holds, before any launch."""
    cap = conv1x1_max_c(torch.bfloat16)
    if k > cap:
        raise ValueError(f"C = {k}: the bfloat16 1x1 tile takes at most "
                         f"{cap}")


def _bf_abw_splits(tiles: int, n: int, s: int, sms: int) -> int:
    """The splits of N·S's 64-position stages of a wgmma product whose
    splits have `tiles` blocks each (one block an SM: its shared memory):
    one wave that fills the SMs, at most one a stage. Split p takes stages
    [p·Q // splits, (p + 1)·Q // splits)."""
    return max(1, min(_bf_stages(n, s), _BF_ABW_SPLITS, sms // tiles))


def _bf_group_widths(s: int, **widths) -> None:
    """Refuse a width that is not a multiple of _bf_groups(S)."""
    k = _bf_groups(s)
    for name, c in widths.items():
        if c % k:
            raise ValueError(f"{name} = {c}: at S = {s} the kernel takes a "
                             f"multiple of {k}")


def norm_relu_moments_bf16(x: torch.Tensor, scale: torch.Tensor,
                           shift: torch.Tensor):
    """``norm_relu_moments`` of a bfloat16 x [N, C, S] (scale/shift [C]
    float32) -> (Σh [C], M2 [C, C]) float32 of h rounded to bf16.

    CPU tensors run ``norm_relu_moments_reference``. CUDA tensors run the
    kernel: bf16, contiguous, 16-byte aligned; the Gram product's bf16
    products summed in float32 over the upper triangle, M2 exactly
    symmetric, the splits of N·S (``_bf_moments_splits``) added in a fixed
    order (deterministic)."""
    if not build.on_card("norm_relu_moments_bf16", x):
        return norm_relu_moments_reference(x, scale, shift)
    _dims("x", x, 3)
    n, c, s = x.shape
    if n * c * s == 0:
        raise ValueError(f"x {tuple(x.shape)} is empty")
    _bf_ns(n, s)
    _bf_check("x", x, x.device, (n, c, s))
    _vectors(x.device, c, scale=scale, shift=shift)
    _bf_widths(C=c)
    splits = _bf_moments_splits(n, s, c, build.sm_count(x.device))
    part = _empty(x.device, splits, c, c + 1)
    out = _empty(x.device, c, c + 1)
    with build.device_guard(x.device):
        build.launch("norm_relu_moments_bf16",
                     _bf_fn("fused_block_norm_relu_moments_bf16",
                            (_P,) * 5 + (_I,) * 5 + (_P,)),
                     x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                     part.data_ptr(), out.data_ptr(), n, c, s, splits,
                     int(s % 4 == 0), build.stream(x.device))
    norm_relu_moments_bf16.launches += 1
    return out[:, c], out[:, :c]


norm_relu_moments_bf16.launches = 0


def conv1x1_bn_residual_bf16(x: torch.Tensor, residual: torch.Tensor,
                             scale2: torch.Tensor, shift2: torch.Tensor,
                             w: torch.Tensor, scale3: torch.Tensor,
                             shift3: torch.Tensor) -> torch.Tensor:
    """``conv1x1_bn_residual`` in bfloat16: x [N, C, S] raw a2, residual
    [N, Cout, S] and w [Cout, C] bf16, the four affines float32 -> the
    block output [N, Cout, S] bf16.

    CPU tensors run ``conv1x1_bn_residual_reference``. CUDA tensors run
    the 1x1 tile on wgmma (csrc/conv1x1_bf16_tc.cuh): bf16, contiguous,
    16-byte aligned, C at most ``conv1x1_max_c(torch.bfloat16)``, Cout at
    most the kernels' cap, both multiples of ``_bf_groups(S)``; h2 rounded
    to bf16 once a stage, a3 float32 through bn3's affine and the residual
    add, the output rounded once; the stages of N·S split by
    ``_bf_tile_splits``."""
    if not build.on_card("conv1x1_bn_residual_bf16", x):
        return conv1x1_bn_residual_reference(x, residual, scale2, shift2, w,
                                             scale3, shift3)
    _dims("x", x, 3)
    _dims("w", w, 2)
    n, c, s = x.shape
    cout = w.shape[0]
    dev = x.device
    _bf_check("x", x, dev, (n, c, s))
    _bf_check("residual", residual, dev, (n, cout, s))
    _bf_check("w", w, dev, (cout, c))
    _vectors(dev, c, scale2=scale2, shift2=shift2)
    _vectors(dev, cout, scale3=scale3, shift3=shift3)
    _bf_widths(C=c, Cout=cout)
    _bf_tile_k(c)
    _bf_group_widths(s, C=c, Cout=cout)
    _bf_ns(n, s)
    splits = _bf_tile_splits(cout, c, n, s, build.sm_count(dev))
    wp, lda = _bf_tile_weight(w)
    out = _bf_empty(dev, n, cout, s)
    with build.device_guard(dev):
        build.launch("conv1x1_bn_residual_bf16",
                     _bf_fn("fused_block_conv1x1_bn_residual_bf16",
                            (_P,) * 8 + (_I,) * 6 + (_P,)),
                     x.data_ptr(), residual.data_ptr(), wp.data_ptr(),
                     scale2.data_ptr(), shift2.data_ptr(), scale3.data_ptr(),
                     shift3.data_ptr(), out.data_ptr(), n, c, cout, s, lda,
                     splits, build.stream(dev))
    conv1x1_bn_residual_bf16.launches += 1
    return out


conv1x1_bn_residual_bf16.launches = 0


def bwd_reduce3_bf16(dout, out, a2, scale2, shift2):
    """``bwd_reduce3`` in bfloat16: dout, out [N, Cin, S] and a2 [N, C, S]
    bf16, scale2/shift2 [C] float32 -> (g3 [N, Cin, S] bf16, P [Cin, C],
    Σg3 [Cin] float32).

    CPU tensors run ``bwd_reduce3_reference``. CUDA tensors run the
    kernel (csrc/abt_bf16_tc.cuh): bf16, contiguous, 16-byte aligned, Cin
    and C at most the kernels' cap and multiples of ``_bf_groups(S)``; g3
    exact, h2 rounded to bf16 as it lands, P's bf16 products summed in
    float32 on wgmma over splits of N·S (``_bf_abw_splits``) added in a
    fixed order (deterministic)."""
    if not build.on_card("bwd_reduce3_bf16", dout):
        return bwd_reduce3_reference(dout, out, a2, scale2, shift2)
    _dims("dout", dout, 3)
    _dims("a2", a2, 3)
    n, cin, s = dout.shape
    c = a2.shape[1]
    dev = dout.device
    _bf_check("dout", dout, dev, (n, cin, s))
    _bf_check("out", out, dev, (n, cin, s))
    _bf_check("a2", a2, dev, (n, c, s))
    _vectors(dev, c, scale2=scale2, shift2=shift2)
    _bf_widths(Cin=cin, C=c)
    _bf_group_widths(s, Cin=cin, C=c)
    _bf_ns(n, s)
    splits = _bf_abw_splits(_bf_abw_tiles("reduce3", cin, c), n, s,
                            build.sm_count(dev))
    g3 = _bf_empty(dev, n, cin, s)
    part, red = _empty(dev, splits, cin, c + 1), _empty(dev, cin, c + 1)
    with build.device_guard(dev):
        build.launch("bwd_reduce3_bf16",
                     _bf_fn("fused_block_bwd_reduce3_bf16",
                            (_P,) * 8 + (_I,) * 5 + (_P,)),
                     dout.data_ptr(), out.data_ptr(), a2.data_ptr(),
                     scale2.data_ptr(), shift2.data_ptr(), g3.data_ptr(),
                     part.data_ptr(), red.data_ptr(), n, cin, c, s, splits,
                     build.stream(dev))
    bwd_reduce3_bf16.launches += 1
    return g3, red[:, :c], red[:, c]


bwd_reduce3_bf16.launches = 0


def bwd_apply3_bf16(g3, a2, scale2, shift2, amat, bmat, v0, inv2, m2):
    """``bwd_apply3`` in bfloat16: g3 [N, Cin, S], a2 [N, C, S], amat [C,
    Cin] and bmat [C, C] bf16, the [C] vectors float32 -> (g2 [N, C, S]
    bf16, Σg2, Σg2·x̂2 [C] float32).

    CPU tensors run ``bwd_apply3_reference``. CUDA tensors run the kernel
    (one product [amat | bmat]·[g3; h2], h2 rounded to bf16 as it lands):
    bf16, contiguous, 16-byte aligned, Cin and C at most the kernels' cap;
    g2 rounded once where h2 > 0, deterministic sums of the rounded g2."""
    if not build.on_card("bwd_apply3_bf16", g3):
        return bwd_apply3_reference(g3, a2, scale2, shift2, amat, bmat, v0,
                                    inv2, m2)
    _dims("g3", g3, 3)
    _dims("a2", a2, 3)
    n, cin, s = g3.shape
    c = a2.shape[1]
    dev = g3.device
    _bf_check("g3", g3, dev, (n, cin, s))
    _bf_check("a2", a2, dev, (n, c, s))
    _bf_check("amat", amat, dev, (c, cin))
    _bf_check("bmat", bmat, dev, (c, c))
    _vectors(dev, c, scale2=scale2, shift2=shift2, v0=v0, inv2=inv2, m2=m2)
    _bf_widths(Cin=cin, C=c)
    t = -(-n * s // _BF_BN)
    stacked, lda = _bf_weight(torch.cat([amat, bmat], 1))
    g2 = _bf_empty(dev, n, c, s)
    part, stats = _empty(dev, 2, c, t), _empty(dev, 2, c)
    with build.device_guard(dev):
        build.launch("bwd_apply3_bf16",
                     _bf_fn("fused_block_bwd_apply3_bf16",
                            (_P,) * 11 + (_I,) * 7 + (_P,)),
                     g3.data_ptr(), a2.data_ptr(), scale2.data_ptr(),
                     shift2.data_ptr(), stacked.data_ptr(), v0.data_ptr(),
                     inv2.data_ptr(), m2.data_ptr(), g2.data_ptr(),
                     part.data_ptr(), stats.data_ptr(), n, cin, c, s, lda, t,
                     int(s % 4 == 0), build.stream(dev))
    bwd_apply3_bf16.launches += 1
    return g2, stats[0], stats[1]


bwd_apply3_bf16.launches = 0


def bwd_mid_bf16(g2, a2, a1, scale1, shift1, p2, q2, r2, inv1, m1, taps,
                 h_side):
    """``bwd_mid`` in bfloat16: g2, a2, a1 [N, C, S] and taps [9, C, C]
    bf16, the [C] vectors float32 -> (g1 [N, C, S] bf16, dtaps [9, C, C],
    Σg1, Σg1·x̂1 [C] float32).

    CPU tensors run ``bwd_mid_reference``. CUDA tensors run the kernels
    (da2 rounded once into a scratch; the input gradient, the 3x3 over
    da2 with the taps flipped and transposed, g1 rounded once where h1 >
    0; the nine tap gradients of da2 against h1 rounded to bf16 once, in
    one pass on wgmma (csrc/abt_bf16_tc.cuh), split by
    ``_bf_abw_splits``): bf16, contiguous, 16-byte aligned, C a multiple
    of 16 and at most the kernels' cap, S = h_side · (S // h_side), rows
    of at most 191; deterministic sums."""
    if not build.on_card("bwd_mid_bf16", g2):
        return bwd_mid_reference(g2, a2, a1, scale1, shift1, p2, q2, r2,
                                 inv1, m1, taps, h_side)
    _dims("g2", g2, 3)
    n, c, s = g2.shape
    if h_side <= 0 or s % h_side:
        raise ValueError(f"S = {s} is not h_side = {h_side} rows")
    if c % _BF_C3K:
        raise ValueError(f"C = {c}: the kernel takes a multiple of "
                         f"{_BF_C3K}")
    dev = g2.device
    for name, t in (("g2", g2), ("a2", a2), ("a1", a1)):
        _bf_check(name, t, dev, (n, c, s))
    _bf_check("taps", taps, dev, (9, c, c))
    _vectors(dev, c, scale1=scale1, shift1=shift1, p2=p2, q2=q2, r2=r2,
             inv1=inv1, m1=m1)
    _bf_widths(C=c)
    _bf_ns(n, s)
    w_side = s // h_side
    if w_side > _BF_TAP_MAX_W:
        raise ValueError(f"W = {w_side}: the kernel takes rows of at most "
                         f"{_BF_TAP_MAX_W}")
    t = n * -(-h_side * (w_side + 2) // _BF_BN)
    splits = _bf_abw_splits(_bf_abw_tiles("taps", c, c), n, s,
                            build.sm_count(dev))
    # the input gradient's taps: taps_t[t] = taps[8 - t]ᵀ (a fresh tensor,
    # 16-byte aligned)
    taps_t = taps.flip(0).transpose(1, 2).contiguous()
    da2, g1 = _bf_empty(dev, n, c, s), _bf_empty(dev, n, c, s)
    part, stats = _empty(dev, 2, c, t), _empty(dev, 2, c)
    wpart, dtaps = _empty(dev, splits, 9, c, c), _empty(dev, 9, c, c)
    with build.device_guard(dev):
        build.launch("bwd_mid_bf16",
                     _bf_fn("fused_block_bwd_mid_bf16",
                            (_P,) * 17 + (_I,) * 6 + (_P,)),
                     g2.data_ptr(), a2.data_ptr(), a1.data_ptr(),
                     scale1.data_ptr(), shift1.data_ptr(), p2.data_ptr(),
                     q2.data_ptr(), r2.data_ptr(), inv1.data_ptr(),
                     m1.data_ptr(), taps_t.data_ptr(), da2.data_ptr(),
                     g1.data_ptr(), part.data_ptr(), stats.data_ptr(),
                     wpart.data_ptr(), dtaps.data_ptr(), n, c, h_side,
                     w_side, t, splits, build.stream(dev))
    bwd_mid_bf16.launches += 1
    return g1, dtaps, stats[0], stats[1]


bwd_mid_bf16.launches = 0


def bwd_final_bf16(g3, g1, a1, x, p1, q1, r1, w1):
    """``bwd_final`` in bfloat16: g3, x [N, Cin, S], g1, a1 [N, C, S] and
    w1 [C, Cin] bf16, p1/q1/r1 [C] float32 -> (dx [N, Cin, S] bf16, dW1
    [C, Cin] float32).

    CPU tensors run ``bwd_final_reference``. CUDA tensors run the kernels
    (da1 rounded once into a scratch; dx = W1ᵀ·da1 + g3 rounded once on
    the 1x1 tile, csrc/conv1x1_bf16_tc.cuh, split by ``_bf_tile_splits``;
    dW1 = Σ da1·xᵀ on the wgmma split product, csrc/abt_bf16_tc.cuh, split
    by ``_bf_abw_splits`` and added in a fixed order): bf16, contiguous,
    16-byte aligned, C at most ``conv1x1_max_c(torch.bfloat16)``, Cin at
    most the kernels' cap, both multiples of ``_bf_groups(S)``;
    deterministic sums."""
    if not build.on_card("bwd_final_bf16", g3):
        return bwd_final_reference(g3, g1, a1, x, p1, q1, r1, w1)
    _dims("g3", g3, 3)
    _dims("g1", g1, 3)
    n, cin, s = g3.shape
    c = g1.shape[1]
    dev = g3.device
    _bf_check("g3", g3, dev, (n, cin, s))
    _bf_check("x", x, dev, (n, cin, s))
    _bf_check("g1", g1, dev, (n, c, s))
    _bf_check("a1", a1, dev, (n, c, s))
    _bf_check("w1", w1, dev, (c, cin))
    _vectors(dev, c, p1=p1, q1=q1, r1=r1)
    _bf_widths(Cin=cin, C=c)
    _bf_tile_k(c)
    _bf_group_widths(s, Cin=cin, C=c)
    _bf_ns(n, s)
    sms = build.sm_count(dev)
    splits = _bf_abw_splits(_bf_abw_tiles("dw1", c, cin), n, s, sms)
    w1t, lda = _bf_tile_weight(w1.t())
    dx, da1 = _bf_empty(dev, n, cin, s), _bf_empty(dev, n, c, s)
    wpart, dw1 = _empty(dev, splits, c, cin), _empty(dev, c, cin)
    with build.device_guard(dev):
        build.launch("bwd_final_bf16",
                     _bf_fn("fused_block_bwd_final_bf16",
                            (_P,) * 12 + (_I,) * 7 + (_P,)),
                     g3.data_ptr(), g1.data_ptr(), a1.data_ptr(),
                     x.data_ptr(), p1.data_ptr(), q1.data_ptr(),
                     r1.data_ptr(), w1t.data_ptr(), dx.data_ptr(),
                     da1.data_ptr(), wpart.data_ptr(), dw1.data_ptr(), n,
                     cin, c, s, lda, splits,
                     _bf_tile_splits(cin, c, n, s, sms), build.stream(dev))
    bwd_final_bf16.launches += 1
    return dx, dw1


bwd_final_bf16.launches = 0


_R3_BM = 128   # rows of Cin of a bwd_reduce3 tile (reduce3::kBM)
_R3_BK = 32    # columns of K of its stage (reduce3::kBK)


def _reduce3_grid(n: int, s: int, cin: int, c: int,
                  sms: int) -> Tuple[int, int, bool]:
    """(splits, chunk, wide) of bwd_reduce3 over K = N·S: its tiles (128
    rows of Cin by 64 columns of C where C <= 64, else 128) times the
    splits fill the SMs in one wave at one block an SM, as far as whole
    splits allow; each split a multiple of the 32-column stage, the
    splits covering N·S exactly, each non-empty. wide: 16-byte copies of
    4 columns, which stay inside one image only where S % 4 == 0."""
    bn = 64 if c <= 64 else 128
    tiles = -(-cin // _R3_BM) * -(-c // bn)
    ns = n * s
    want = max(1, sms // tiles)
    chunk = _R3_BK * -(-ns // (want * _R3_BK))
    return -(-ns // chunk), chunk, s % 4 == 0


def _bwd_fn(name: str, argtypes: tuple):
    return build.bind("fused_block_bwd.cu", name, argtypes)


def _vectors(device, n: int, **vecs) -> None:
    for name, v in vecs.items():
        build.check(name, v, device, (n,))


def bwd_reduce3(dout, out, a2, scale2, shift2):
    """dout, out [N, Cin, S], a2 [N, C, S] raw, scale2/shift2 [C] ->
    (g3 = dout·(out > 0) [N, Cin, S], P = Σ_{n,s} g3 h2ᵀ [Cin, C], Σg3
    [Cin]) with h2 = relu(a2·scale2 + shift2).

    CPU tensors run ``bwd_reduce3_reference``. CUDA tensors run the
    kernel: float32, contiguous; N·S split across blocks
    (``_reduce3_grid``), the splits' partials added in a fixed order
    (deterministic)."""
    if not build.on_card("bwd_reduce3", dout):
        return bwd_reduce3_reference(dout, out, a2, scale2, shift2)
    _dims("dout", dout, 3)
    _dims("a2", a2, 3)
    n, cin, s = dout.shape
    c = a2.shape[1]
    dev = dout.device
    build.check("dout", dout, dev, (n, cin, s))
    build.check("out", out, dev, (n, cin, s))
    build.check("a2", a2, dev, (n, c, s))
    _vectors(dev, c, scale2=scale2, shift2=shift2)
    splits, chunk, wide = _reduce3_grid(n, s, cin, c, build.sm_count(dev))
    g3 = _empty(dev, n, cin, s)
    part, red = _empty(dev, splits, cin, c + 1), _empty(dev, cin, c + 1)
    wide = wide and all(t.data_ptr() % 16 == 0 for t in (dout, out, a2, g3))
    with build.device_guard(dev):
        build.launch("bwd_reduce3",
                     _bwd_fn("fused_block_bwd_reduce3_f32",
                             (_P,) * 8 + (_I,) * 7 + (_P,)),
                     dout.data_ptr(), out.data_ptr(), a2.data_ptr(),
                     scale2.data_ptr(), shift2.data_ptr(), g3.data_ptr(),
                     part.data_ptr(), red.data_ptr(), n, cin, c, s, splits,
                     chunk, int(wide), build.stream(dev))
    bwd_reduce3.launches += 1
    return g3, red[:, :c], red[:, c]


bwd_reduce3.launches = 0


def bwd_apply3(g3, a2, scale2, shift2, amat, bmat, v0, inv2, m2):
    """g3 [N, Cin, S], a2 [N, C, S] raw, amat [C, Cin], bmat [C, C],
    scale2/shift2/v0/inv2/m2 [C] -> (g2 = (A·g3 + B·h2 + v0)·(h2 > 0)
    [N, C, S], Σg2 [C], Σg2·x̂2 [C]), x̂2 = a2·inv2 − m2·inv2.

    CPU tensors run ``bwd_apply3_reference``. CUDA tensors run the
    kernel (one product [amat | bmat]·[g3; h2] over ``_stream_grid``'s
    tiles): float32, contiguous; the product in 3xTF32 on the tensor
    cores, deterministic sums."""
    if not build.on_card("bwd_apply3", g3):
        return bwd_apply3_reference(g3, a2, scale2, shift2, amat, bmat, v0,
                                    inv2, m2)
    _dims("g3", g3, 3)
    _dims("a2", a2, 3)
    n, cin, s = g3.shape
    c = a2.shape[1]
    dev = g3.device
    build.check("g3", g3, dev, (n, cin, s))
    build.check("a2", a2, dev, (n, c, s))
    build.check("amat", amat, dev, (c, cin))
    build.check("bmat", bmat, dev, (c, c))
    _vectors(dev, c, scale2=scale2, shift2=shift2, v0=v0, inv2=inv2, m2=m2)
    _, t, rows, lda = _stream_grid(n, s, c, cin + c)
    # [amat | bmat] stacked once, zero-padded to whole row tiles and whole
    # stages of K (a fresh tensor, 16-byte aligned)
    stacked = F.pad(torch.cat([amat, bmat], 1),
                    (0, lda - cin - c, 0, rows - c))
    g2 = _empty(dev, n, c, s)
    part, stats = _empty(dev, 2, c, t), _empty(dev, 2, c)
    wide = s % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in (g3, a2))
    with build.device_guard(dev):
        build.launch("bwd_apply3",
                     _bwd_fn("fused_block_bwd_apply3_f32",
                             (_P,) * 11 + (_I,) * 7 + (_P,)),
                     g3.data_ptr(), a2.data_ptr(), scale2.data_ptr(),
                     shift2.data_ptr(), stacked.data_ptr(), v0.data_ptr(),
                     inv2.data_ptr(), m2.data_ptr(), g2.data_ptr(),
                     part.data_ptr(), stats.data_ptr(), n, cin, c, s, lda, t,
                     int(wide), build.stream(dev))
    bwd_apply3.launches += 1
    return g2, stats[0], stats[1]


bwd_apply3.launches = 0


def bwd_mid(g2, a2, a1, scale1, shift1, p2, q2, r2, inv1, m1, taps, h_side):
    """g2, a2, a1 [N, C, S], taps [9, C, C] ([ky*3 + kx], [Cout, Cin]),
    the [C] vectors -> (g1 [N, C, S], dtaps [9, C, C], Σg1 [C], Σg1·x̂1
    [C]): da2 = g2·p2 + a2·q2 + r2, the 3x3's input gradient dh1 (da2
    padded with zeros), g1 = dh1·(h1 > 0), and the tap gradients of
    da2 against h1 = relu(a1·scale1 + shift1) (padded with zeros).

    CPU tensors run ``bwd_mid_reference``. CUDA tensors run the kernels
    (da2 written once; the input gradient over it with the taps flipped
    and transposed, ``_conv3x3_grid``'s tiles; the tap gradients split
    by ``_bwd_mid_grid``): float32, contiguous, C a multiple of 8, S =
    h_side · (S // h_side); products in 3xTF32 on the tensor cores,
    deterministic sums."""
    if not build.on_card("bwd_mid", g2):
        return bwd_mid_reference(g2, a2, a1, scale1, shift1, p2, q2, r2,
                                 inv1, m1, taps, h_side)
    _dims("g2", g2, 3)
    n, c, s = g2.shape
    if h_side <= 0 or s % h_side:
        raise ValueError(f"S = {s} is not h_side = {h_side} rows")
    if c % _BK:
        raise ValueError(f"C = {c}: the kernel takes a multiple of {_BK}")
    dev = g2.device
    for name, t in (("g2", g2), ("a2", a2), ("a1", a1)):
        build.check(name, t, dev, (n, c, s))
    build.check("taps", taps, dev, (9, c, c))
    _vectors(dev, c, scale1=scale1, shift1=shift1, p2=p2, q2=q2, r2=r2,
             inv1=inv1, m1=m1)
    w_side = s // h_side
    _, t, _ = _conv3x3_grid(n, h_side, w_side)
    splits, per = _bwd_mid_grid(n, h_side, w_side, c, build.sm_count(dev))
    # the input gradient's taps: taps_t[t] = taps[8 - t]ᵀ (a fresh tensor,
    # 16-byte aligned)
    taps_t = taps.flip(0).transpose(1, 2).contiguous()
    da2, g1 = _empty(dev, n, c, s), _empty(dev, n, c, s)
    part, stats = _empty(dev, 2, c, t), _empty(dev, 2, c)
    wpart, dtaps = _empty(dev, splits, 9, c, c), _empty(dev, 9, c, c)
    with build.device_guard(dev):
        build.launch("bwd_mid",
                     _bwd_fn("fused_block_bwd_mid_f32",
                             (_P,) * 17 + (_I,) * 7 + (_P,)),
                     g2.data_ptr(), a2.data_ptr(), a1.data_ptr(),
                     scale1.data_ptr(), shift1.data_ptr(), p2.data_ptr(),
                     q2.data_ptr(), r2.data_ptr(), inv1.data_ptr(),
                     m1.data_ptr(), taps_t.data_ptr(), da2.data_ptr(),
                     g1.data_ptr(), part.data_ptr(), stats.data_ptr(),
                     wpart.data_ptr(), dtaps.data_ptr(), n, c, h_side,
                     w_side, t, splits, per, build.stream(dev))
    bwd_mid.launches += 1
    return g1, dtaps, stats[0], stats[1]


bwd_mid.launches = 0


def bwd_final(g3, g1, a1, x, p1, q1, r1, w1):
    """g3, x [N, Cin, S], g1, a1 [N, C, S], p1/q1/r1 [C], w1 [C, Cin] ->
    (dx = W1ᵀ·da1 + g3 [N, Cin, S], dW1 = Σ_{n,s} da1 xᵀ [C, Cin]) with
    da1 = g1·p1 + a1·q1 + r1.

    CPU tensors run ``bwd_final_reference``. CUDA tensors run the kernels
    (dx, folding da1 once into a scratch; dW1 split across blocks by
    ``_bwd_final_grid``): float32, contiguous; products in 3xTF32 on the
    tensor cores, deterministic sums."""
    if not build.on_card("bwd_final", g3):
        return bwd_final_reference(g3, g1, a1, x, p1, q1, r1, w1)
    _dims("g3", g3, 3)
    _dims("g1", g1, 3)
    n, cin, s = g3.shape
    c = g1.shape[1]
    dev = g3.device
    build.check("g3", g3, dev, (n, cin, s))
    build.check("x", x, dev, (n, cin, s))
    build.check("g1", g1, dev, (n, c, s))
    build.check("a1", a1, dev, (n, c, s))
    build.check("w1", w1, dev, (c, cin))
    _vectors(dev, c, p1=p1, q1=q1, r1=r1)
    splits, _ = _bwd_final_grid(n, s, c, cin, build.sm_count(dev))
    if cin % 4 or w1.data_ptr() % 16:
        # W1's rows are copied 16 bytes at a time: a fresh tensor, its rows
        # padded with zeros to a multiple of 4
        w1 = F.pad(w1, (0, -cin % 4))
    dx, da1 = _empty(dev, n, cin, s), _empty(dev, n, c, s)
    wpart, dw1 = _empty(dev, splits, c, cin), _empty(dev, c, cin)
    wide = s % 4 == 0 and all(t.data_ptr() % 16 == 0
                              for t in (g3, g1, a1, x))
    with build.device_guard(dev):
        build.launch("bwd_final",
                     _bwd_fn("fused_block_bwd_final_f32",
                             (_P,) * 12 + (_I,) * 7 + (_P,)),
                     g3.data_ptr(), g1.data_ptr(), a1.data_ptr(),
                     x.data_ptr(), p1.data_ptr(), q1.data_ptr(),
                     r1.data_ptr(), w1.data_ptr(), dx.data_ptr(),
                     da1.data_ptr(), wpart.data_ptr(), dw1.data_ptr(), n,
                     cin, c, s, w1.shape[1], splits, int(wide), build.stream(dev))
    bwd_final.launches += 1
    return dx, dw1


bwd_final.launches = 0


# ---------------------------------------------------------------------------
# the chain (fused_block.py :61-138, :501-565)
# ---------------------------------------------------------------------------

def _bn_affine(mean, var, gamma, beta, eps):
    scale = torch.rsqrt(var + eps) * gamma
    return mean, var, scale, beta - mean * scale


def _bn_fold(ssum, ssq, m_count, gamma, beta, eps=EPS_DEFAULT):
    """Training-mode BN from Σ and Σ² over m_count values: (mean, var,
    scale, shift), the affine a conv kernel's successor applies."""
    mean = ssum / m_count
    var = torch.clamp_min(ssq / m_count - mean * mean, 0.0)
    return _bn_affine(mean, var, gamma, beta, eps)


def _bn3_fold(w3, sum_h, m2h, m_count, gamma, beta, eps=EPS_DEFAULT):
    """bn3's (mean, var, scale, shift) without a3: the last conv is
    linear, so mean(a3) = W3·mean(h2) and E[a3²] = diag(W3 E[h2 h2ᵀ] W3ᵀ),
    from the moments Σh2 and M2 over m_count values."""
    w3f = w3.float()
    mean = w3f @ (sum_h / m_count)
    e2 = ((w3f @ (m2h / m_count)) * w3f).sum(dim=1)
    var = torch.clamp_min(e2 - mean * mean, 0.0)
    return _bn_affine(mean, var, gamma, beta, eps)


def bottleneck_rest_fwd(x, w1, taps2, w3, g1, b1, g2, b2, g3, b3, h_side,
                        eps=EPS_DEFAULT):
    """Forward of a stride-1 rest block without a shortcut conv.

    x [N, Cin, S] block input (S = h_side²); w1 [C, Cin]; taps2 [9, C, C];
    w3 [Cin, C]; g/b the BN scales and biases (float32). Returns (out
    [N, Cin, S], batch stats (m1, v1, m2, v2, m3, v3), aux) with aux =
    (a1, a2, Σh2, M2, sc1, sh1, sc2, sh2), what the backward needs. A
    bfloat16 x (with bfloat16 filters) takes the bfloat16 kernels; the BN
    folds stay float32, as the JAX package keeps them."""
    n, _, s = x.shape
    m_count = n * s
    if x.dtype == torch.bfloat16:
        k1, k2, k3, k4 = (conv1x1_stats_bf16, conv3x3_norm_stats_bf16,
                          norm_relu_moments_bf16, conv1x1_bn_residual_bf16)
    else:
        k1, k2, k3, k4 = (conv1x1_stats, conv3x3_norm_stats,
                          norm_relu_moments, conv1x1_bn_residual)

    a1, s1, q1 = k1(x, w1)
    m1, v1, sc1, sh1 = _bn_fold(s1, q1, m_count, g1, b1, eps)

    a2, s2, q2 = k2(a1, taps2, sc1, sh1, h_side)
    m2, v2, sc2, sh2 = _bn_fold(s2, q2, m_count, g2, b2, eps)

    sum_h, m2h = k3(a2, sc2, sh2)
    m3, v3, sc3, sh3 = _bn3_fold(w3, sum_h, m2h, m_count, g3, b3, eps)

    out = k4(a2, x, sc2, sh2, w3, sc3, sh3)
    return out, (m1, v1, m2, v2, m3, v3), (a1, a2, sum_h, m2h, sc1, sh1,
                                            sc2, sh2)


def _bn_affine_consts(sc, inv, m, sum_g, sum_gx, m_count, gm, gv):
    """The p/q/r constants of the folded BN backward: da = g·p + a·q + r
    (fused_block.py :141-157)."""
    c1 = sum_g / m_count
    c2 = sum_gx / m_count
    p = sc
    q = -sc * c2 * inv + 2.0 * gv / m_count
    r = -sc * c1 + sc * c2 * m * inv + gm / m_count - 2.0 * m * gv / m_count
    return p, q, r


def bottleneck_rest_bwd(res, dout, stat_cots, h_side, eps=EPS_DEFAULT):
    """The chain's backward from the forward's residuals res = (x, a1, a2,
    out, w1, taps, w3, γ1, γ2, γ3, m1, v1, m2, v2, m3, v3, Σh2, M2, sc1,
    sh1, sc2, sh2) and the cotangents of out and of the six batch stats.
    Returns (dx, dW1, dtaps, dW3, dγ1, dβ1, dγ2, dβ2, dγ3, dβ3). A
    bfloat16 x (with bfloat16 filters) takes the bfloat16 kernels; the BN
    folds stay float32, as the JAX package keeps them."""
    (x, a1, a2, out, w1, taps, w3, gam1, gam2, gam3,
     m1, v1, m2, v2, m3, v3, sum_h_raw, m2_raw, sc1, sh1, sc2, sh2) = res
    n, _, s = x.shape
    m_count = float(n * s)
    if x.dtype == torch.bfloat16:
        k1, k2, k3, k4 = (bwd_reduce3_bf16, bwd_apply3_bf16, bwd_mid_bf16,
                          bwd_final_bf16)
    else:
        k1, k2, k3, k4 = bwd_reduce3, bwd_apply3, bwd_mid, bwd_final
    gm1, gv1, gm2, gv2, gm3, gv3 = [t.float() for t in stat_cots]
    inv1 = torch.rsqrt(v1 + eps)
    inv2 = torch.rsqrt(v2 + eps)
    inv3 = torch.rsqrt(v3 + eps)
    w3f = w3.float()

    # bn3, analytic: a3 never existed
    g3t, p_mat, sum_g3 = k1(dout, out, a2, sc2, sh2)
    sum_g3a3 = (w3f * p_mat).sum(dim=1)
    sum_g3x3 = inv3 * (sum_g3a3 - m3 * sum_g3)
    dgam3, dbeta3 = sum_g3x3, sum_g3
    p3, q3, r3 = _bn_affine_consts(inv3 * gam3, inv3, m3, sum_g3, sum_g3x3,
                                   m_count, gm3, gv3)
    amat = (w3f * p3[:, None]).T.contiguous().to(w3.dtype)
    bmat = (w3f.T @ (w3f * q3[:, None])).to(w3.dtype)
    v0 = w3f.T @ r3
    dw3 = (p3[:, None] * p_mat + q3[:, None] * (w3f @ m2_raw)
           + r3[:, None] * sum_h_raw[None, :])

    # bn2 and the last 1x1's transpose
    g2, sum_g2, sum_g2x2 = k2(g3t, a2, sc2, sh2, amat, bmat, v0, inv2, m2)
    dgam2, dbeta2 = sum_g2x2, sum_g2
    p2, q2, r2 = _bn_affine_consts(inv2 * gam2, inv2, m2, sum_g2, sum_g2x2,
                                   m_count, gm2, gv2)

    # the 3x3's transpose, its tap gradients and bn1's reductions
    g1, dtaps, sum_g1, sum_g1x1 = k3(g2, a2, a1, sc1, sh1, p2, q2, r2, inv1,
                                     m1, taps, h_side)
    dgam1, dbeta1 = sum_g1x1, sum_g1
    p1, q1, r1 = _bn_affine_consts(inv1 * gam1, inv1, m1, sum_g1, sum_g1x1,
                                   m_count, gm1, gv1)

    # the first 1x1's transpose, the residual and dW1
    dx, dw1 = k4(g3t, g1, a1, x, p1, q1, r1, w1)

    return (dx, dw1.to(w1.dtype), dtaps.to(taps.dtype), dw3.to(w3.dtype),
            dgam1.to(gam1.dtype), dbeta1.to(gam1.dtype),
            dgam2.to(gam2.dtype), dbeta2.to(gam2.dtype),
            dgam3.to(gam3.dtype), dbeta3.to(gam3.dtype))


class FusedBottleneckRest(torch.autograd.Function):
    """The differentiable chain: (out, m1, v1, m2, v2, m3, v3). The six
    batch statistics have exact cotangents (they feed the running stats
    at the op). The backward runs ``bottleneck_rest_bwd`` from the
    forward's residuals: the four backward kernels on the card, their
    plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, w1, taps, w3, g1, b1, g2, b2, g3, b3, h_side, eps):
        out, stats, aux = bottleneck_rest_fwd(x, w1, taps, w3, g1, b1, g2, b2,
                                              g3, b3, h_side, eps)
        a1, a2, sum_h, m2h, sc1, sh1, sc2, sh2 = aux
        ctx.save_for_backward(x, a1, a2, out, w1, taps, w3, g1, g2, g3,
                              *stats, sum_h, m2h, sc1, sh1, sc2, sh2)
        ctx.h_side, ctx.eps = h_side, eps
        ctx.set_materialize_grads(False)
        return (out,) + stats

    @staticmethod
    def backward(ctx, dout, *stat_cots):
        res = ctx.saved_tensors
        # autograd may hand a strided cotangent; the kernels take it dense
        dout = torch.zeros_like(res[3]) if dout is None else dout.contiguous()
        cots = [torch.zeros_like(st) if g is None else g
                for g, st in zip(stat_cots, res[10:16])]
        return bottleneck_rest_bwd(res, dout, cots, ctx.h_side,
                                   ctx.eps) + (None, None)


def fused_bottleneck_rest(x, w1, taps, w3, g1, b1, g2, b2, g3, b3, h_side,
                          eps=EPS_DEFAULT):
    """The chain through ``FusedBottleneckRest``: (out, m1, v1, m2, v2,
    m3, v3)."""
    return FusedBottleneckRest.apply(x, w1, taps, w3, g1, b1, g2, b2, g3, b3,
                                     h_side, eps)
