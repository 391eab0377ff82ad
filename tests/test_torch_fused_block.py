"""The bottleneck chain of the port (kernels/fused_block.py and the
``fused_bottleneck`` op's chain branch) against the JAX package on the
CPU.

The plain versions of the four forward kernels and of the four backward
kernels are held against the JAX package's Pallas kernels run by the
Pallas interpreter (``paddle_tpu.kernels.fused_block.INTERPRET``, patched
for the test); ``bottleneck_rest_fwd`` against the JAX package's;
``FusedBottleneckRest``'s gradients against ``jax.grad`` of
``fused_bottleneck_rest``, with and without cotangents on the six batch
statistics; the op's chain helper against the port's ``compose_block``
and the JAX package's ``_compose_block``; one Momentum step of a
``fused_bottleneck`` program through the chain against the composed
step and the JAX package's. The backward wrappers refuse what their
kernels do not take before any launch, and receive dense operands from
a strided cotangent. The card's 3x3 kernel computes in 3xTF32 on the
tensor cores: an emulation of that arithmetic holds the plain version
to the forward tolerance at chain-like depths, and its column tiles
cover the padded grid; so do bwd_mid's and bwd_final's products, to
the backward limits, and their splits cover their K, and
conv1x1_bn_residual's, to the forward limit, whose grid covers N·S and
Cout and whose wrapper refuses what its kernel does not take before any
launch, and norm_relu_moments' Gram product, to the sums' limit, whose
grid covers N·S and M2's upper triangle and whose wrapper refuses what
its kernel does not take, and conv1x1_stats' product, to the forward
limit, whose grid covers N·S and whose wrapper reads W1 in place where
the chain's shapes fit; on the CPU the chain's gate leaves C to the
plain versions, which take any. Inputs come from
a numpy seed: N 2-8, Cin 16-256, C 8-64, H 4, 7 and 8 (S 16, 49 and
64), BN shifts that are not zero, so the 3x3's zero padding of h1 (not
of a1) and, in the backward, of da2 (not r2) shows at every edge.

Tolerances: float32 on both sides, sums in other orders. Forward outputs
within atol = rtol = 1e-5; sums within 1e-5 of the sum of their terms'
magnitudes; M2 (of h >= 0) within rtol 1e-5; gradients within 1e-4 of
each gradient's largest entry; the chain against the composition within
2e-5 (it takes its variances as E[a²] - m², bn3's analytically through
W3, where the composition reduces the materialized tensors).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core import program as jprog
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.kernels import fused_block as jfb
from paddle_tpu.ops import fused_ops as jfo

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import ExecContext, require_op
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import fused_block as tfb
from paddle_tpu_torch.ops import fused_ops as tfo

torch.set_num_threads(2)

EPS = 1e-5
FWD = dict(atol=1e-5, rtol=1e-5)
CHAIN = dict(atol=2e-5, rtol=2e-5)
SHAPES = [(2, 16, 8, 7), (4, 32, 8, 8), (8, 16, 8, 7)]   # N, Cin, C, H


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfb, "INTERPRET", True)


def _case(n, cin, c, h, seed=0):
    """The chain's inputs: a block input >= 0 (it follows a ReLU), He-
    scaled weights, BN scales around 1 and shifts around 0.2."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return dict(
        x=np.abs(rng.randn(n, cin, h * h)).astype(f32),
        w1=(rng.randn(c, cin) * np.sqrt(2.0 / cin)).astype(f32),
        taps=(rng.randn(9, c, c) * np.sqrt(2.0 / (9 * c))).astype(f32),
        w3=(rng.randn(cin, c) * np.sqrt(2.0 / c)).astype(f32),
        g1=(1 + 0.2 * rng.randn(c)).astype(f32),
        b1=(0.2 + 0.3 * rng.randn(c)).astype(f32),
        g2=(1 + 0.2 * rng.randn(c)).astype(f32),
        b2=(0.2 + 0.3 * rng.randn(c)).astype(f32),
        g3=(1 + 0.2 * rng.randn(cin)).astype(f32),
        b3=(0.2 + 0.3 * rng.randn(cin)).astype(f32),
        a=rng.randn(n, c, h * h).astype(f32) + 0.3,
        sc=(0.5 + rng.rand(c)).astype(f32),
        sh=(0.3 * rng.randn(c) + 0.2).astype(f32),
        sc3=(0.5 + rng.rand(cin)).astype(f32),
        sh3=(0.3 * rng.randn(cin)).astype(f32),
        res=rng.randn(n, cin, h * h).astype(f32))


ARGS = ("x", "w1", "taps", "w3", "g1", "b1", "g2", "b2", "g3", "b3")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _close_sum(got, want, terms):
    """A sum within 1e-5 of the sum of its terms' magnitudes."""
    assert np.all(np.abs(np.asarray(got) - np.asarray(want))
                  <= 1e-5 * np.asarray(terms)), (got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_conv1x1_stats_plain_matches_pallas(interpret, shape):
    n, cin, c, h = shape
    d = _case(*shape)
    jy, js, jq = jfb.conv1x1_stats(jnp.asarray(d["x"]), jnp.asarray(d["w1"]))
    ty, ts, tq = tfb.conv1x1_stats(torch.from_numpy(d["x"]),
                                   torch.from_numpy(d["w1"]))
    _close(ty, jy, **FWD)
    _close_sum(ts, js, np.abs(np.asarray(jy)).sum(axis=(0, 2)))
    _close(tq, jq, **FWD)


@pytest.mark.parametrize("shape", SHAPES)
def test_conv3x3_norm_stats_plain_matches_pallas(interpret, shape):
    n, cin, c, h = shape
    d = _case(*shape, seed=1)
    args = (d["a"], d["taps"], d["sc"], d["sh"])
    jy, js, jq = jfb.conv3x3_norm_stats(*map(jnp.asarray, args), h)
    ty, ts, tq = tfb.conv3x3_norm_stats(*map(torch.from_numpy, args), h)
    _close(ty, jy, **FWD)
    _close_sum(ts, js, np.abs(np.asarray(jy)).sum(axis=(0, 2)))
    _close(tq, jq, **FWD)


def _conv3x3_padding_a1(a, taps, sc, sh, h):
    """The trap: a conv that zero-pads a1 and normalizes after, so an
    out-of-image tap reads relu(shift) instead of 0."""
    n, c, s = a.shape
    ap = torch.nn.functional.pad(a.reshape(n, c, h, h), (1, 1, 1, 1))
    hp = torch.clamp_min(ap * sc.reshape(1, -1, 1, 1)
                         + sh.reshape(1, -1, 1, 1), 0.0)
    w2 = taps.reshape(3, 3, -1, c).permute(2, 3, 0, 1)
    return torch.nn.functional.conv2d(hp, w2).reshape(n, -1, s)


@pytest.mark.parametrize("h", [7, 8])
def test_conv3x3_pads_h_not_a1(interpret, h):
    """At H 7 and 8 with shifts above zero, the 3x3's out-of-image taps
    read 0: the plain version matches Pallas and a version that pads a1
    instead is far outside the tolerance on the border pixels."""
    d = _case(2, 16, 8, h, seed=2)
    sh = np.abs(d["sh"]) + 0.5
    args = (d["a"], d["taps"], d["sc"], sh)
    jy = np.asarray(jfb.conv3x3_norm_stats(*map(jnp.asarray, args), h)[0])
    t_args = tuple(map(torch.from_numpy, args))
    _close(tfb.conv3x3_norm_stats(*t_args, h)[0], jy, **FWD)
    wrong = _conv3x3_padding_a1(*t_args, h).numpy()
    border = np.ones((h, h), bool)
    border[1:-1, 1:-1] = False
    gap = np.abs(wrong - jy).reshape(2, 8, h, h)[:, :, border]
    assert gap.min() > 0 and gap.max() > 1e3 * FWD["atol"]
    interior = np.abs(wrong - jy).reshape(2, 8, h, h)[:, :, 1:-1, 1:-1]
    assert interior.max() <= 1e-5


def _tf32(x, nearest=True):
    """x as the tensor cores read it in TF32, by integer ops on the
    float32 bits: rounded to nearest, ties away from zero, as
    cvt.rna.tf32.f32 rounds (nearest), else truncated (the low 13
    mantissa bits dropped)."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000 if nearest else bits) & -8192).view(
        torch.float32)


def _pairs(a, b, products):
    """The 3xTF32 operand pairs of a product a·b: each operand split into
    big = tf32(v) (rounded) and small = v - big (truncated to TF32 by the
    tensor cores); the pairs small·big, big·small, big·big, or with
    products=1 big·big alone (plain TF32)."""
    ab, bb = _tf32(a), _tf32(b)
    asm, bs = _tf32(a - ab, False), _tf32(b - bb, False)
    return [(asm, bb), (ab, bs), (ab, bb)][-products:]


def _taps_tf32(src, taps, h, products):
    """The 3x3 of csrc/conv3x3_tc.cuh on the padded source src [N, Cin,
    h + 2, w + 2]: per tap the products of _pairs (each exact in float32)
    added in float32."""
    n, cin = src.shape[:2]
    w = src.shape[3] - 2
    y = torch.zeros(n, taps.shape[1], h * w)
    for ky in range(3):
        for kx in range(3):
            for a, b in _pairs(taps, src, products):
                win = b[:, :, ky:ky + h, kx:kx + w].reshape(n, cin, h * w)
                y = y + torch.matmul(a[ky * 3 + kx], win)
    return y


def _conv3x3_tf32(x, taps, scale, shift, h, products):
    """The card kernel's arithmetic (csrc/conv3x3_tc.cuh): h1 normalized
    once and padded with zeros, then _taps_tf32."""
    n, cin, s = x.shape
    hp = torch.nn.functional.pad(
        tfb._norm_relu(x, scale, shift).reshape(n, cin, h, s // h),
        (1, 1, 1, 1))
    return _taps_tf32(hp, taps, h, products)


@pytest.mark.parametrize("n,c,h", [(2, 256, 7), (2, 64, 14)])
def test_3xtf32_holds_the_plain_conv3x3_to_float32(n, c, h):
    """At chain-like K = 9C (2304 at C 256, 576 at C 64) the kernel's
    3xTF32 arithmetic, emulated, stays within atol = rtol = 1e-5 of the
    plain version (what it drops, small·small, is ~2^-22 of a product);
    one TF32 product alone is far outside that limit."""
    d = _case(n, c, c, h, seed=4)
    args = tuple(map(torch.from_numpy, (d["a"], d["taps"], d["sc"], d["sh"])))
    want = tfb.conv3x3_norm_stats_reference(*args, h)[0]
    limit = FWD["atol"] + FWD["rtol"] * want.abs()
    share = lambda y: float(((y - want).abs() / limit).max())
    assert share(_conv3x3_tf32(*args, h, products=3)) <= 0.5
    assert share(_conv3x3_tf32(*args, h, products=1)) > 10


def _mid_case(n, c, h, seed):
    """bwd_mid's operands: g2, a2, a1 [N, C, h²], bn2 folded into p2 (a
    scale around 1), q2 and r2, bn1's affine (shifts above zero), inv1,
    m1, He-scaled taps."""
    d = _case(n, c, c, h, seed=seed)
    rng = np.random.RandomState(seed + 1)
    f32 = np.float32
    vec = lambda scale, base=0.0: (base + scale * rng.randn(c)).astype(f32)
    return tuple(map(torch.from_numpy, (
        rng.randn(n, c, h * h).astype(f32), rng.randn(n, c, h * h).astype(f32),
        d["a"], d["sc"], d["sh"], vec(0.2, 1.0), vec(0.1), vec(0.1),
        np.abs(vec(0.2, 1.0)), vec(0.1), d["taps"])))


def _input_gradient_tf32(da2, taps, h, products):
    """bwd_mid's input gradient as the card computes it: conv3x3_tc.cuh's
    product over da2 padded with zeros on the grid of rows of w + 2, the
    taps flipped and each transposed (taps_t[t] = taps[8 - t]ᵀ)."""
    n, c, s = da2.shape
    dp = torch.nn.functional.pad(da2.reshape(n, c, h, s // h), (1, 1, 1, 1))
    return _taps_tf32(dp, taps.flip(0).transpose(1, 2), h, products)


def _tap_gradients_tf32(da2, h1, h, products, sms=132):
    """bwd_mid's tap gradients as the card computes them
    (csrc/bwd_mid_tc.cuh): K = the positions of each image's padded grid
    (rows of w + 2, da2 0 in the two extra columns and past the grid's
    end, h1 zero-bordered), cut in _bwd_mid_grid's splits of 32-position
    pieces; each k8 step's products of _pairs go into a fresh fragment
    (summed in float32), added into the split's float32 accumulator step
    after step; the splits added in split order."""
    n, c, s = da2.shape
    w = s // h
    wp = w + 2
    ppi = -(-h * wp // 32)
    length = ppi * 32
    pad = torch.nn.functional.pad
    dq = pad(pad(da2.reshape(n, c, h, w), (0, 2)).reshape(n, c, h * wp),
             (0, length - h * wp))
    hp = pad(pad(h1.reshape(n, c, h, w), (1, 1, 1, 1)).reshape(n, c, -1),
             (0, length + 2 * wp + 2 - (h + 2) * wp))

    def steps(t, offset):     # [N·length/8 k8 steps, C, 8]
        win = t[:, :, offset:offset + length]
        return win.reshape(n, c, length // 8, 8).permute(0, 2, 1, 3).reshape(
            -1, c, 8)

    a_pairs = [a for a, _ in _pairs(steps(dq, 0), steps(dq, 0), products)]
    b_pairs = [[b for _, b in _pairs(steps(hp, 0), steps(
        hp, (t // 3) * wp + t % 3), products)] for t in range(9)]
    splits, per = tfb._bwd_mid_grid(n, h, w, c, sms)
    total = torch.zeros(9, c, c)
    for sp in range(splits):
        acc = torch.zeros(9, c, c)
        k0, k1 = sp * per * 4, min(n * ppi, (sp + 1) * per) * 4
        for j0 in range(k0, k1, 256):
            j1 = min(k1, j0 + 256)
            f = sum(torch.matmul(a[j0:j1].unsqueeze(0),
                                 torch.stack([b[t][j0:j1] for t in range(9)])
                                 .transpose(2, 3))
                    for a, b in zip(a_pairs, zip(*b_pairs)))
            for k in range(j1 - j0):
                acc = acc + f[:, k]
        total = total + acc
    return total


@pytest.mark.parametrize("n,c,h", [(8, 64, 56), (32, 96, 28)])
def test_3xtf32_holds_bwd_mid_to_its_limits(n, c, h):
    """At chain-like depths (the input gradient's K = 9C; the tap
    gradients' K = N·S = 25,088 positions, 25,984 on the padded grid),
    bwd_mid's 3xTF32 arithmetic on the card, emulated, stays within half
    of its limits: g1 within atol = rtol = 1e-4 of the plain version,
    dtaps within 1e-5 of the sum of their terms' magnitudes. One TF32
    product is far outside g1's limit and outside dtaps'."""
    args = _mid_case(n, c, h, seed=21)
    g2, a2, a1, sc1, sh1, p2, q2, r2, inv1, m1, taps = args
    g1, dtaps = tfb.bwd_mid_reference(*args, h)[:2]
    col = lambda v: v.reshape(1, -1, 1)
    da2 = g2 * col(p2) + a2 * col(q2) + col(r2)
    h1 = tfb._norm_relu(a1, sc1, sh1)
    mask = a1 * col(sc1) + col(sh1) > 0
    limit = 1e-4 + 1e-4 * g1.abs()

    def g1_share(products):
        got = torch.where(mask, _input_gradient_tf32(da2, taps, h, products),
                          torch.zeros(()))
        return float(((got - g1).abs() / limit).max())

    terms = torch.nn.grad.conv2d_weight(
        h1.reshape(n, c, h, h), (c, c, 3, 3), da2.abs().reshape(n, c, h, h),
        padding=1).permute(2, 3, 0, 1).reshape(9, c, c)

    def dtaps_share(products):
        got = _tap_gradients_tf32(da2, h1, h, products)
        return float(((got - dtaps).abs() / (1e-5 * terms)).max())

    assert g1_share(3) <= 0.5 and dtaps_share(3) <= 0.5
    assert g1_share(1) > 10 and dtaps_share(1) > 1


@pytest.mark.parametrize("n,h,w,c,splits", [
    (128, 56, 56, 64, 88),    # ResNet-50's three chain stages: whole waves
    (128, 28, 28, 128, 22),   # of 3 dy rows x tiles x splits, two blocks
    (128, 14, 14, 256, 11),   # an SM (264, 264, 528 blocks)
    (2, 10, 12, 96, 10),      # a non-square image, a last piece past the
                              # grid's end
    (1, 3, 250, 72, 12),      # rows wider than a piece
    (2, 16, 20, 64, 22),      # fewer pieces than the wave wants: one each
    (3, 1, 1, 8, 3),
    (2, 4, 4, 1024, 1),       # one split's 768 blocks exceed two waves
])
def test_bwd_mid_grid_covers_the_padded_grid(n, h, w, c, splits):
    """bwd_mid's tap-gradient splits: each image's padded grid of h rows
    of w + 2 positions in whole 32-position pieces (one stage each, the
    last one past the grid's end, never into the next image), the splits
    runs of `per` pieces covering every piece of every image exactly
    once, none empty; at the chain's stages 3 dy rows x the 64 x 64 tiles
    of [C, C] x splits fill whole waves of the 132 SMs at two blocks an
    SM."""
    got_splits, per = tfb._bwd_mid_grid(n, h, w, c, 132)
    ppi = -(-h * (w + 2) // 32)
    assert (ppi - 1) * 32 < h * (w + 2) <= ppi * 32
    assert got_splits == splits and per > 0 and splits <= 65535
    runs = [range(sp * per, min(n * ppi, (sp + 1) * per))
            for sp in range(splits)]
    assert all(len(r) > 0 for r in runs)
    assert [j for r in runs for j in r] == list(range(n * ppi))
    tiles = -(-c // 64)
    if n == 128:
        assert 3 * tiles * tiles * splits % (2 * 132) == 0


def _final_case(n, cin, c, s, seed):
    """bwd_final's operands: g3, x [N, Cin, S] (x >= 0, a block input),
    g1, a1 [N, C, S], bn1 folded into p1 (a scale around 1), q1 and r1,
    He-scaled w1 [C, Cin]."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    vec = lambda scale, base=0.0: (base + scale * rng.randn(c)).astype(f32)
    return tuple(map(torch.from_numpy, (
        rng.randn(n, cin, s).astype(f32), rng.randn(n, c, s).astype(f32),
        rng.randn(n, c, s).astype(f32) + 0.3,
        np.abs(rng.randn(n, cin, s)).astype(f32), vec(0.2, 1.0), vec(0.1),
        vec(0.1), (rng.randn(c, cin) * np.sqrt(2.0 / cin)).astype(f32))))


def _dx_tf32(da1, w1, g3, products):
    """bwd_final's dx as the card computes it (csrc/bwd_final_tc.cuh): K
    = C in k8 steps (zero past C), each step's products of _pairs into a
    fresh fragment (summed in float32), added into the float32
    accumulator step after step; then + g3."""
    n, c, s = da1.shape
    pad = -c % 8
    a = torch.nn.functional.pad(w1.T, (0, pad))              # [Cin, Cp]
    b = torch.nn.functional.pad(da1, (0, 0, 0, pad))         # [N, Cp, S]
    pairs = _pairs(a, b, products)
    acc = torch.zeros(n, w1.shape[1], s)
    for k in range(0, c + pad, 8):
        acc = acc + sum(torch.matmul(pa[:, k:k + 8], pb[:, k:k + 8])
                        for pa, pb in pairs)
    return acc + g3


def _dw1_tf32(da1, x, products, sms=132):
    """bwd_final's dW1 as the card computes it: K = the N·S columns in
    _bwd_final_grid's splits of 32-column pieces (a piece may straddle
    two images; zero past N·S), each k8 step's products of _pairs into a
    fresh fragment (summed in float32), added into the split's float32
    accumulator step after step; the splits added in split order."""
    n, c, s = da1.shape
    cin = x.shape[1]
    splits, pieces = tfb._bwd_final_grid(n, s, c, cin, sms)
    length = pieces * 32

    def steps(t):     # [N·S, rows] columns -> [length / 8 k8 steps, rows, 8]
        cols = t.permute(1, 0, 2).reshape(t.shape[1], n * s)
        cols = torch.nn.functional.pad(cols, (0, length - n * s))
        return cols.reshape(-1, length // 8, 8).permute(1, 0, 2)

    pairs = _pairs(steps(da1), steps(x), products)
    total = torch.zeros(c, cin)
    for sp in range(splits):
        acc = torch.zeros(c, cin)
        k0, k1 = sp * pieces // splits * 4, (sp + 1) * pieces // splits * 4
        for j0 in range(k0, k1, 256):
            j1 = min(k1, j0 + 256)
            f = sum(torch.matmul(a[j0:j1], b[j0:j1].transpose(1, 2))
                    for a, b in pairs)
            for k in range(j1 - j0):
                acc = acc + f[k]
        total = total + acc
    return total


@pytest.mark.parametrize("n,cin,c,s", [(8, 256, 96, 3136),
                                      (128, 256, 64, 196)])
def test_3xtf32_holds_bwd_final_to_its_limits(n, cin, c, s):
    """At chain-like depths (dx's K = C; dW1's K = N·S = 25,088 columns,
    in _bwd_final_grid's splits), bwd_final's 3xTF32 arithmetic on the
    card, emulated, stays within half of its limits: dx within atol =
    rtol = 1e-4 of the plain version, dW1 within 1e-5 of the sum of its
    terms' magnitudes. With one TF32 product dx or dW1 falls outside its
    limit."""
    args = _final_case(n, cin, c, s, seed=22)
    g3, g1, a1, x, p1, q1, r1, w1 = args
    dx, dw1 = tfb.bwd_final_reference(*args)
    col = lambda v: v.reshape(1, -1, 1)
    da1 = g1 * col(p1) + a1 * col(q1) + col(r1)
    terms = torch.einsum("ncs,nks->ck", da1.abs(), x)

    def dx_share(products):
        got = _dx_tf32(da1, w1, g3, products)
        return float(((got - dx).abs() / (1e-4 + 1e-4 * dx.abs())).max())

    def dw1_share(products):
        got = _dw1_tf32(da1, x, products)
        return float(((got - dw1).abs() / (1e-5 * terms)).max())

    assert dx_share(3) <= 0.5 and dw1_share(3) <= 0.5
    assert dx_share(1) > 1 or dw1_share(1) > 1


def _res_case(n, cin, c, s, seed):
    """conv1x1_bn_residual's operands as the chain makes them: a2 [N, C,
    S] raw, bn2's affine folded from a2's batch statistics, a He-scaled
    W3 [Cin, C], bn3's affine from _bn3_fold on the plain moments of h2,
    the block input [N, Cin, S] >= 0."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    a2 = torch.from_numpy((rng.randn(n, c, s) + 0.3).astype(f32))
    w3 = torch.from_numpy((rng.randn(cin, c) * np.sqrt(2.0 / c)).astype(f32))
    g2, b2, g3, b3 = (torch.from_numpy(v.astype(f32)) for v in (
        1 + 0.2 * rng.randn(c), 0.2 + 0.3 * rng.randn(c),
        1 + 0.2 * rng.randn(cin), 0.2 + 0.3 * rng.randn(cin)))
    res = torch.from_numpy(np.abs(rng.randn(n, cin, s)).astype(f32))
    m = n * s
    _, _, sc2, sh2 = tfb._bn_fold(a2.sum(dim=(0, 2)),
                                  (a2 * a2).sum(dim=(0, 2)), m, g2, b2)
    sum_h, m2h = tfb.norm_relu_moments_reference(a2, sc2, sh2)
    _, _, sc3, sh3 = tfb._bn3_fold(w3, sum_h, m2h, m, g3, b3)
    return a2, res, sc2, sh2, w3, sc3, sh3


def _res_tf32(a2, res, sc2, sh2, w3, sc3, sh3, products):
    """conv1x1_bn_residual as the card computes it (csrc/conv1x1_tc.cuh):
    h2 normalized once, K = C in k8 steps (zero past C), each step's
    products of _pairs into a fresh fragment (summed in float32), added
    into the float32 accumulator step after step; then bn3's affine, the
    residual and the ReLU."""
    c = a2.shape[1]
    pad = -c % 8
    h2 = torch.nn.functional.pad(tfb._norm_relu(a2, sc2, sh2),
                                 (0, 0, 0, pad))               # [N, Cp, S]
    a = torch.nn.functional.pad(w3, (0, pad))                  # [Cout, Cp]
    pairs = _pairs(a, h2, products)
    acc = torch.zeros(a2.shape[0], w3.shape[0], a2.shape[2])
    for k in range(0, c + pad, 8):
        acc = acc + sum(torch.matmul(pa[:, k:k + 8], pb[:, k:k + 8])
                        for pa, pb in pairs)
    col = lambda v: v.reshape(1, -1, 1)
    return torch.clamp_min(acc * col(sc3) + col(sh3) + res, 0.0)


@pytest.mark.parametrize("n,cin,c,s", [(8, 256, 64, 3136),
                                      (16, 1024, 256, 196)])
def test_3xtf32_holds_conv1x1_bn_residual_to_float32(n, cin, c, s):
    """At the chain's widths (K = C 64 at 56², 256 at 14²), with bn3's
    affine from the plain moments as the chain makes it, the card's
    3xTF32 arithmetic for conv1x1_bn_residual, emulated, stays within
    half of the atol = rtol = 1e-5 limit of the plain version; one TF32
    product alone falls outside it."""
    args = _res_case(n, cin, c, s, seed=15)
    want = tfb.conv1x1_bn_residual_reference(*args)
    limit = FWD["atol"] + FWD["rtol"] * want.abs()

    def share(products):
        return float(((_res_tf32(*args, products) - want).abs()
                      / limit).max())

    assert share(3) <= 0.5
    assert share(1) > 1


@pytest.mark.parametrize("n,s,cout,blocks,splits", [
    (128, 3136, 256, 6272, 1),   # ResNet-50's three chain stages: 23.8
    (128, 784, 512, 1568, 1),    # and 5.9 waves of two blocks an SM; 1.5
    (128, 196, 1024, 392, 2),    # waves, the chunks shared out by two
    (8, 196, 256, 25, 2),        # few blocks: a split a chunk
    (2, 49, 72, 2, 1),           # one chunk: one split
    (3, 49, 1000, 3, 8),         # S % 4 != 0: blocks straddle images
    (1, 4, 128, 1, 1),
])
def test_res_grid_covers_n_s_and_cout(n, s, cout, blocks, splits):
    """conv1x1_bn_residual's grid: 64-column blocks cover every position
    of every image exactly once (the last block past N·S); splits p take
    Cout's 128-row chunks [p · chunks // splits, (p + 1) · chunks //
    splits), none empty, covering each chunk once; N·S alone from 4 waves
    of two blocks an SM on 132 SMs, else the split whose blocks fill
    their last wave best."""
    got_blocks, got_splits = tfb._res_grid(n, s, cout, 132)
    assert (got_blocks, got_splits) == (blocks, splits)
    assert (blocks - 1) * 64 < n * s <= blocks * 64
    covered = [(k // s, k % s) for b in range(blocks)
               for k in range(64 * b, min(n * s, 64 * b + 64))]
    assert covered == [(i, p) for i in range(n) for p in range(s)]
    chunks = -(-cout // 128)
    runs = [range(sp * chunks // splits, (sp + 1) * chunks // splits)
            for sp in range(splits)]
    assert all(len(r) > 0 for r in runs)
    assert [j for r in runs for j in r] == list(range(chunks))
    assert 128 * (chunks - 1) < cout <= 128 * chunks


@pytest.mark.parametrize("fault", ["float64", "strided", "shape"])
def test_conv1x1_bn_residual_refuses_before_launch(monkeypatch, fault):
    """The wrapper given tensors declared on the card (the CPU tensors
    here) refuses a float64 or a strided operand, or a residual of another
    Cout, TypeError or ValueError, before it reaches its kernel
    (build.bind patched to fail if it is reached)."""
    monkeypatch.setattr(build, "on_card", lambda what, t: True)

    def no_kernel(*a):
        raise AssertionError("reached the kernel")

    monkeypatch.setattr(build, "bind", no_kernel)
    monkeypatch.setattr(build, "sm_count", no_kernel)
    n, cout, c, s = 2, 16, 8, 49
    z = torch.zeros
    args = [z(n, c, s), z(n, cout, s), z(c), z(c), z(cout, c), z(cout),
            z(cout)]
    if fault == "float64":
        args[1] = args[1].double()
    elif fault == "strided":
        args[4] = z(c, cout).T
        assert not args[4].is_contiguous()
    else:
        args[1] = z(n, cout + 1, s)
    before = tfb.conv1x1_bn_residual.launches
    with pytest.raises(TypeError if fault == "float64" else ValueError):
        tfb.conv1x1_bn_residual(*args)
    assert tfb.conv1x1_bn_residual.launches == before


@pytest.mark.parametrize("n,s,c,cin,splits", [
    (128, 3136, 64, 256, 132),    # ResNet-50's three chain stages: whole
    (128, 784, 128, 512, 33),     # waves of tiles x splits, two blocks an
    (128, 196, 256, 1024, 33),    # SM (264, 264, 1056 blocks)
    (8, 3136, 96, 256, 66),
    (3, 100, 64, 256, 10),        # fewer pieces than the wave wants: one
    (3, 49, 96, 256, 5),          # each; S % 4 != 0, pieces straddle images
    (2, 7, 8, 16, 1),             # N·S 14: one piece
    (1, 4, 2048, 2048, 1),        # one split's 512 blocks near two waves
])
def test_bwd_final_grid_covers_n_s(n, s, c, cin, splits):
    """bwd_final's dW1 splits: N·S in whole 32-column pieces (one stage
    each, the last one past N·S), split p taking pieces [p · P // splits,
    (p + 1) · P // splits): every position of every image covered exactly
    once, no split empty; at the chain's stages the 64 x 128 tiles of [C,
    Cin] x splits fill whole waves of the 132 SMs at two blocks an SM."""
    got_splits, pieces = tfb._bwd_final_grid(n, s, c, cin, 132)
    assert (pieces - 1) * 32 < n * s <= pieces * 32
    assert got_splits == splits and 1 <= splits <= 65535
    runs = [range(sp * pieces // splits, (sp + 1) * pieces // splits)
            for sp in range(splits)]
    assert all(len(r) > 0 for r in runs)
    assert [j for r in runs for j in r] == list(range(pieces))
    covered = [(k // s, k % s) for j in range(pieces)
               for k in range(32 * j, min(n * s, 32 * j + 32))]
    assert covered == [(i, p) for i in range(n) for p in range(s)]
    if n == 128:
        tiles = -(-c // 64) * -(-cin // 128)
        assert tiles * splits % (2 * 132) == 0


def _apply3_case(n, cin, c, s, seed):
    """bwd_apply3's operands as the chain makes them: g3 [N, Cin, S], a2
    [N, C, S], bn2's affine (scales around 1, shifts around 0), bn3's
    backward folded through a He-scaled W3 [Cin, C] (amat = (W3·diag(p3))ᵀ,
    bmat = W3ᵀ·diag(q3)·W3, v0 = W3ᵀ·r3), inv2 and m2."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    vec = lambda k, scale, base=0.0: (base + scale * rng.randn(k)).astype(f32)
    w3 = (rng.randn(cin, c) * np.sqrt(2.0 / c)).astype(f32)
    p3, q3, r3 = vec(cin, 0.2, 1.0), vec(cin, 0.01), vec(cin, 0.01)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=f32)) for a in (
        rng.randn(n, cin, s), rng.randn(n, c, s), vec(c, 0.2, 1.0),
        vec(c, 0.1), (w3 * p3[:, None]).T, w3.T @ (w3 * q3[:, None]),
        w3.T @ r3, np.abs(vec(c, 0.2, 1.0)), vec(c, 0.1)))


def _apply3_tf32(g3, a2, sc2, sh2, amat, bmat, v0, products):
    """bwd_apply3's g2 as the card computes it (csrc/bwd_apply3_tc.cuh):
    [amat | bmat]·[g3; h2] with h2 = relu(a2·sc2 + sh2) (one rounding,
    as fmaf), K = Cin + C in k8 steps (zero past K), each step's products
    of _pairs into a fresh fragment (summed in float32), added into the
    float32 accumulator step after step; then + v0 where a2·sc2 + sh2 >
    0 (two roundings, as the plain version), else 0."""
    col = lambda v: v.reshape(1, -1, 1)
    k = g3.shape[1] + a2.shape[1]
    h2 = torch.clamp_min((a2.double() * col(sc2).double()
                          + col(sh2).double()).float(), 0.0)
    a = torch.nn.functional.pad(torch.cat([amat, bmat], 1), (0, -k % 8))
    b = torch.nn.functional.pad(torch.cat([g3, h2], 1), (0, 0, 0, -k % 8))
    pairs = _pairs(a, b, products)
    acc = torch.zeros(a2.shape)
    for k0 in range(0, k + -k % 8, 8):
        acc = acc + sum(torch.matmul(pa[:, k0:k0 + 8], pb[:, k0:k0 + 8])
                        for pa, pb in pairs)
    mask = a2 * col(sc2) + col(sh2) > 0
    return torch.where(mask, acc + col(v0), torch.zeros(()))


@pytest.mark.parametrize("n,cin,c,s", [(2, 1024, 256, 196),
                                      (4, 256, 96, 49),
                                      (3, 150, 20, 49)])
def test_3xtf32_holds_bwd_apply3_to_its_limits(n, cin, c, s):
    """At the chain's deepest K (Cin + C = 1280, the 14x14 stage) and at
    C that is not a multiple of 64 (nor, at 20, of 8; K = 170 is padded
    to whole k8 steps), bwd_apply3's 3xTF32 arithmetic on the card,
    emulated, stays within half of its limits: g2 within atol = rtol =
    1e-4 of the plain version, Σg2 and Σg2·x̂2 within 1e-5 of the sum of
    their terms' magnitudes. With one TF32 product g2 falls outside its
    limit."""
    args = _apply3_case(n, cin, c, s, seed=23)
    g3, a2, sc2, sh2, amat, bmat, v0, inv2, m2 = args
    g2, sum_g2, sum_gx = tfb.bwd_apply3_reference(*args)
    col = lambda v: v.reshape(1, -1, 1)
    xhat = a2 * col(inv2) + col(-m2 * inv2)

    def shares(products):
        got = _apply3_tf32(g3, a2, sc2, sh2, amat, bmat, v0, products)
        g2_share = float(((got - g2).abs() / (1e-4 + 1e-4 * g2.abs())).max())
        sums = [(got.sum(dim=(0, 2)), sum_g2, g2.abs()),
                ((got * xhat).sum(dim=(0, 2)), sum_gx, (g2 * xhat).abs())]
        return g2_share, max(float(((s - w).abs() / (1e-5 * t.sum(
            dim=(0, 2)))).max()) for s, w, t in sums)

    g2_share, sums_share = shares(3)
    assert g2_share <= 0.5 and sums_share <= 0.5
    assert shares(1)[0] > 1


@pytest.mark.parametrize("n,s,c,cin,bn,blocks", [
    (128, 3136, 64, 256, 128, 3136),   # ResNet-50's three chain stages
    (128, 784, 128, 512, 64, 1568),
    (128, 196, 256, 1024, 64, 784),    # two 128-row tiles of C
    (3, 49, 20, 150, 128, 2),          # tiles straddle images; K 170
    (2, 36, 136, 72, 64, 4),           # two row tiles, the second mostly
                                       # empty
    (1, 1, 8, 16, 128, 1),
])
def test_bwd_apply3_grid_covers_n_s(n, s, c, cin, bn, blocks):
    """bwd_apply3's tiles: 64 rows of C by 128 columns of N·S where C <=
    64, else 128 by 64; T column tiles covering every position of every
    image exactly once (a tile may hold the end of one image and the
    start of the next; the last one past N·S), T the last dimension of
    the part tensor [2, C, T]; the stacked [amat | bmat] padded to whole
    row tiles and to K = Cin + C in whole 16-row stages."""
    got_bn, t, rows, lda = tfb._stream_grid(n, s, c, cin + c)
    bm = 8192 // bn
    assert got_bn == bn and bm == (64 if c <= 64 else 128)
    assert (t - 1) * bn < n * s <= t * bn
    assert rows % bm == 0 and rows - bm < c <= rows
    assert rows // bm * t == blocks
    assert lda % 16 == 0 and lda - 16 < cin + c <= lda
    covered = [(k // s, k % s) for jt in range(t)
               for k in range(jt * bn, min(n * s, jt * bn + bn))]
    assert covered == [(i, p) for i in range(n) for p in range(s)]


def _stats_tf32(x, w, products):
    """conv1x1_stats' y as the card computes it
    (csrc/conv1x1_stats_tc.cuh): W1·x with K = Cin in k8 steps (zero past
    K), each step's products of _pairs into a fresh fragment (summed in
    float32), added into the float32 accumulator step after step."""
    k = x.shape[1]
    a = torch.nn.functional.pad(w, (0, -k % 8))
    b = torch.nn.functional.pad(x, (0, 0, 0, -k % 8))
    pairs = _pairs(a, b, products)
    acc = torch.zeros(x.shape[0], w.shape[0], x.shape[2])
    for k0 in range(0, k + -k % 8, 8):
        acc = acc + sum(torch.matmul(pa[:, k0:k0 + 8], pb[:, k0:k0 + 8])
                        for pa, pb in pairs)
    return acc


@pytest.mark.parametrize("n,cin,c,s", [(2, 1024, 256, 196),
                                      (4, 256, 96, 49),
                                      (3, 150, 72, 36)])
def test_3xtf32_holds_conv1x1_stats_to_float32(n, cin, c, s):
    """At the chain's deepest K (Cin = 1024, the 14x14 stage), at C that
    is not a multiple of 64 and at Cin that is not a multiple of 16 (150:
    K padded to whole k8 steps), conv1x1_stats' 3xTF32 arithmetic on the
    card, emulated, stays within half of its limits: y within atol = rtol
    = 1e-5 of the plain version, Σy and Σy² within 1e-5 of the sum of
    their terms' magnitudes. With one TF32 product y falls outside its
    limit."""
    rng = np.random.RandomState(29)
    x = torch.from_numpy(rng.rand(n, cin, s).astype(np.float32))
    w = torch.from_numpy((rng.randn(c, cin) * np.sqrt(2.0 / cin))
                         .astype(np.float32))
    y, sum_y, sum_q = tfb.conv1x1_stats_reference(x, w)

    def shares(products):
        got = _stats_tf32(x, w, products)
        y_share = float(((got - y).abs() / (1e-5 + 1e-5 * y.abs())).max())
        sums = [(got.sum(dim=(0, 2)), sum_y, y.abs()),
                ((got * got).sum(dim=(0, 2)), sum_q, y * y)]
        return y_share, max(float(((s - w).abs() / (1e-5 * t.sum(
            dim=(0, 2)))).max()) for s, w, t in sums)

    y_share, sums_share = shares(3)
    assert y_share <= 0.5 and sums_share <= 0.5
    assert shares(1)[0] > 1


@pytest.mark.parametrize("n,s,c,cin,bn,blocks,itself", [
    (128, 3136, 64, 256, 128, 3136, True),   # ResNet-50's three chain
    (128, 784, 128, 512, 64, 1568, True),    # stages: W1 itself
    (128, 196, 256, 1024, 64, 784, True),    # two 128-row tiles of C
    (3, 49, 72, 72, 64, 3, False),     # C 72: one 128-row tile, padded
    (2, 36, 64, 150, 128, 1, False),   # Cin 150: K padded to 160
    (1, 1, 8, 16, 128, 1, False),      # C 8: a 64-row tile
])
def test_conv1x1_stats_grid_covers_n_s(monkeypatch, n, s, c, cin, bn,
                                       blocks, itself):
    """conv1x1_stats' tiles: 64 rows of C by 128 columns of N·S where C
    <= 64, else 128 by 64, T column tiles covering every position of
    every image exactly once (a tile may hold the end of one image and
    the start of the next); W1 read at whole row tiles and K = Cin in
    whole 16-row stages: W1 itself where the chain's shapes already fit
    (a copy where it is not 16-byte aligned), else one zero-padded copy;
    and the wrapper, given tensors declared on the card (the CPU tensors
    here, two images at most), hands its kernel that W1, lda and T, with
    part [2, C, T] (the launch patched to record its arguments)."""
    got_bn, t, rows, lda = tfb._stream_grid(n, s, c, cin)
    bm = 8192 // bn
    assert got_bn == bn and bm == (64 if c <= 64 else 128)
    assert (t - 1) * bn < n * s <= t * bn
    assert rows % bm == 0 and rows - bm < c <= rows
    assert rows // bm * t == blocks
    assert lda % 16 == 0 and lda - 16 < cin <= lda
    covered = [(k // s, k % s) for jt in range(t)
               for k in range(jt * bn, min(n * s, jt * bn + bn))]
    assert covered == [(i, p) for i in range(n) for p in range(s)]
    w = torch.randn(c, cin)
    read = tfb._stream_weight(w, rows, lda)
    assert (read is w) == itself and read.shape == (rows, lda)
    assert torch.equal(read[:c, :cin], w)
    assert not read[c:].any() and not read[:, cin:].any()
    if itself:
        off = torch.zeros(c * cin + 1)[1:].view(c, cin)
        off.copy_(w)
        again = tfb._stream_weight(off, rows, lda)
        assert again.data_ptr() % 16 == 0 and torch.equal(again, w)

    n = min(n, 2)
    _, t, _, _ = tfb._stream_grid(n, s, c, cin)
    calls, shapes = [], []
    empty = tfb._empty
    monkeypatch.setattr(build, "on_card", lambda what, x: True)
    monkeypatch.setattr(build, "bind", lambda *a: None)
    monkeypatch.setattr(build, "launch",
                        lambda name, fn, *a: calls.append(a))
    monkeypatch.setattr(build, "device_guard",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(build, "stream", lambda d: 0)
    monkeypatch.setattr(tfb, "_empty", lambda d, *shape: (
        shapes.append(shape), empty(d, *shape))[1])
    tfb.conv1x1_stats(torch.rand(n, cin, s), w)
    (args,) = calls
    assert (args[1] == w.data_ptr()) == itself
    assert args[5:12] == (n, cin, c, s, lda, t, int(s % 4 == 0))
    assert (2, c, t) in shapes


def _moments_shares(r0, c0, c):
    """The warps of a moments tile (moments_tc.cuh's Share): its 32 x 32
    warp tiles (2 x 4, rows wr, columns wc) on or above the diagonal and
    inside C, in order, each shared by Q warps (Q = 4 for one, 2 for up
    to 3, else 1), warp w taking warp tile w % n and group w // n; and
    whether the tile holds its rows' diagonal, where its last warp adds
    up Σh for rows r0 .. r0 + 63. Returns ([(wr, wc)], Q, diagonal)."""
    warps = [(r0 + 32 * wm, c0 + 32 * wn) for wm in range(2)
             for wn in range(4)]
    busy = [(wr, wc) for wr, wc in warps if wr < c and wc < c and
            wc + 31 >= wr]
    q = 4 if len(busy) <= 1 else 2 if len(busy) <= 3 else 1
    return busy, q, r0 >= c0


def _moments_tf32(x, scale, shift, products, sms=132):
    """norm_relu_moments as the card computes it (csrc/moments_tc.cuh): h
    normalized once, zero past N·S; K = the N·S positions in
    _moments_grid's splits of 32-column pieces (a piece may straddle two
    images), each k8 step's products of _pairs into a fresh fragment
    (summed in float32), added into a float32 accumulator step after step,
    where Q warps share a warp tile one accumulator for every Q-th step,
    the Q added in order; Σh a float32 sum position after position; the
    splits added in split order; M2's upper triangle mirrored."""
    n, c, s = x.shape
    _, splits, pieces = tfb._moments_grid(n, s, c, sms)
    groups = torch.zeros(c, c, dtype=torch.long)
    for r0, c0 in tfb._moments_tiles(c):
        busy, q, _ = _moments_shares(r0, c0, c)
        for wr, wc in busy:
            groups[wr:wr + 32, wc:wc + 32] = q
    length = pieces * 32
    h = tfb._norm_relu(x, scale, shift).permute(1, 0, 2).reshape(c, n * s)
    h = torch.nn.functional.pad(h, (0, length - n * s))
    steps = h.reshape(c, length // 8, 8).permute(1, 0, 2)   # [k8, C, 8]
    pairs = _pairs(steps, steps, products)
    m2, sum_h = torch.zeros(c, c), torch.zeros(c)
    for sp in range(splits):
        k0, k1 = sp * pieces // splits * 4, (sp + 1) * pieces // splits * 4
        accs = {q: [torch.zeros(c, c) for _ in range(q)] for q in (1, 2, 4)}
        for j0 in range(k0, k1, 256):
            j1 = min(k1, j0 + 256)
            f = sum(torch.matmul(a[j0:j1], b[j0:j1].transpose(1, 2))
                    for a, b in pairs)
            for k in range(j1 - j0):
                for q, acc in accs.items():
                    acc[(j0 + k) % q] = acc[(j0 + k) % q] + f[k]
        acc = torch.zeros(c, c)
        for q, parts in accs.items():
            total = parts[0]
            for more in parts[1:]:
                total = total + more
            acc = torch.where(groups == q, total, acc)
        rows = torch.zeros(c)
        for p in range(8 * k0, 8 * k1):
            rows = rows + h[:, p]
        m2, sum_h = m2 + acc, sum_h + rows
    upper = torch.triu(m2)
    return sum_h, upper + torch.triu(m2, 1).T


@pytest.mark.parametrize("n,c,s", [(8, 64, 3136), (16, 256, 196)])
def test_3xtf32_holds_norm_relu_moments_to_its_limits(n, c, s):
    """At the chain's widths (C 64 over 25,088 positions, C 256 over
    3,136), with shifts > 0 on a quarter of the channels and more, the
    card's 3xTF32 arithmetic for norm_relu_moments, emulated, keeps Σh
    and M2 within half of their limits, rtol 1e-5 of Σ|terms| (h >= 0:
    the sums themselves), of the plain version. The share of one TF32
    product alone is printed, not asserted: for a Gram of nonnegative
    terms its truncations may stay inside the limit too."""
    rng = np.random.RandomState(16)
    f32 = np.float32
    x = torch.from_numpy((rng.randn(n, c, s) + 0.3).astype(f32))
    scale = torch.from_numpy((0.5 + rng.rand(c)).astype(f32))
    shift = torch.from_numpy((0.3 * rng.randn(c) + 0.2).astype(f32))
    assert int((shift > 0).sum()) >= c // 4
    want = tfb.norm_relu_moments_reference(x, scale, shift)

    def share(products):
        got = _moments_tf32(x, scale, shift, products)
        return max(float(((g - w).abs() / (1e-5 * w).clamp_min(1e-30))
                         .max()) for g, w in zip(got, want))

    three = share(3)
    print(f"largest share of the limit: 3xTF32 {three:.4f}, one TF32 "
          f"product {share(1):.4f}")
    assert three <= 0.5


@pytest.mark.parametrize("n,s,c,tiles,splits", [
    (128, 3136, 64, 1, 264),   # ResNet-50's three chain stages: whole
    (128, 784, 128, 2, 132),   # waves of tiles x splits, two blocks an SM
    (128, 196, 256, 6, 44),
    (3, 49, 72, 2, 5),         # S % 4 != 0, pieces straddle images; C 72:
                               # a second row tile, one piece a split
    (5, 45, 200, 6, 8),        # N·S 225, not a multiple of 32
    (2, 50, 130, 5, 4),        # C just past a 128-column tile
    (1, 7, 8, 1, 1),           # N·S 7: one piece
])
def test_moments_grid_covers_n_s_and_the_upper_triangle(n, s, c, tiles,
                                                        splits):
    """norm_relu_moments' grid: N·S in whole 32-column pieces (one stage
    each, the last one past N·S), split p taking pieces [p · P // splits,
    (p + 1) · P // splits): every position of every image covered exactly
    once, no split empty; the 64 x 128 tiles' computing warps write every
    entry (i <= j) of M2 exactly once, and every row's Σh comes from
    exactly one tile, whose last warp computes no warp tile; at the
    chain's stages tiles x splits fill whole waves of the 132 SMs at two
    blocks an SM."""
    got_tiles, got_splits, pieces = tfb._moments_grid(n, s, c, 132)
    assert (got_tiles, got_splits) == (tiles, splits)
    assert (pieces - 1) * 32 < n * s <= pieces * 32
    runs = [range(sp * pieces // splits, (sp + 1) * pieces // splits)
            for sp in range(splits)]
    assert all(len(r) > 0 for r in runs)
    assert [j for r in runs for j in r] == list(range(pieces))
    covered = [(k // s, k % s) for j in range(pieces)
               for k in range(32 * j, min(n * s, 32 * j + 32))]
    assert covered == [(i, p) for i in range(n) for p in range(s)]
    written = np.zeros((c, c), dtype=int)
    summed = np.zeros(c, dtype=int)
    for r0, c0 in tfb._moments_tiles(c):
        busy, q, diagonal = _moments_shares(r0, c0, c)
        assert len(busy) * q <= (7 if diagonal else 8)
        for wr, wc in busy:
            block = written[wr:wr + 32, wc:wc + 32]
            rows = np.arange(wr, wr + block.shape[0])[:, None]
            cols = np.arange(wc, wc + block.shape[1])[None, :]
            block += rows <= cols
        if diagonal:
            summed[r0:r0 + 64] += 1
    assert np.array_equal(written, np.triu(np.ones((c, c), dtype=int)))
    assert np.all(summed == 1)
    if n == 128:
        assert tiles * splits % (2 * 132) == 0


@pytest.mark.parametrize("fault", ["float64", "strided", "shape", "empty",
                                   "positions"])
def test_norm_relu_moments_refuses_before_launch(monkeypatch, fault):
    """The wrapper given tensors declared on the card (the CPU tensors
    here) refuses a float64 or strided x, a scale of another C, an empty
    x, or N·S past what the kernel takes (an expanded view, no memory),
    TypeError or ValueError, before it reaches its kernel (build.bind
    patched to fail if it is reached)."""
    monkeypatch.setattr(build, "on_card", lambda what, t: True)

    def no_kernel(*a):
        raise AssertionError("reached the kernel")

    monkeypatch.setattr(build, "bind", no_kernel)
    monkeypatch.setattr(build, "sm_count", no_kernel)
    n, c, s = 2, 8, 49
    x, scale, shift = torch.zeros(n, c, s), torch.ones(c), torch.ones(c)
    if fault == "float64":
        x = x.double()
    elif fault == "strided":
        x = torch.zeros(c, n, s).transpose(0, 1)
        assert not x.is_contiguous()
    elif fault == "shape":
        scale = torch.ones(c + 1)
    elif fault == "empty":
        x = torch.zeros(n, c, 0)
    else:
        x = torch.zeros(1, c, 1).expand(2 ** 16, c, 2 ** 15)
    before = tfb.norm_relu_moments.launches
    with pytest.raises(TypeError if fault == "float64" else ValueError):
        tfb.norm_relu_moments(x, scale, shift)
    assert tfb.norm_relu_moments.launches == before


@pytest.mark.parametrize("shape", SHAPES)
def test_norm_relu_moments_plain_matches_pallas(interpret, shape):
    d = _case(*shape, seed=3)
    args = (d["a"], d["sc"], d["sh"])
    js, jm = jfb.norm_relu_moments(*map(jnp.asarray, args))
    ts, tm = tfb.norm_relu_moments(*map(torch.from_numpy, args))
    # h >= 0, so each sum is the sum of its terms' magnitudes
    _close(ts, js, atol=0, rtol=1e-5)
    _close(tm, jm, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_conv1x1_bn_residual_plain_matches_pallas(interpret, shape):
    d = _case(*shape, seed=4)
    args = (d["a"], d["res"], d["sc"], d["sh"], d["w3"], d["sc3"], d["sh3"])
    jo = jfb.conv1x1_bn_residual(*map(jnp.asarray, args))
    to = tfb.conv1x1_bn_residual(*map(torch.from_numpy, args))
    _close(to, jo, **FWD)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_bottleneck_rest_fwd_matches_jax(interpret, shape):
    n, cin, c, h = shape
    d = _case(*shape, seed=5)
    j_out, j_stats, _ = jfb.bottleneck_rest_fwd(
        *(jnp.asarray(d[k]) for k in ARGS), h, EPS)
    t_out, t_stats, _ = tfb.bottleneck_rest_fwd(
        *(torch.from_numpy(d[k]) for k in ARGS), h, EPS)
    _close(t_out, j_out, **FWD)
    for got, want in zip(t_stats, j_stats):
        _close(got, want, **FWD)


def _backward_case(shape, seed):
    """The chain's forward residuals from the plain forward, cotangents of
    out from the seed."""
    n, cin, c, h = shape
    d = _case(*shape, seed=seed)
    rng = np.random.RandomState(seed + 100)
    j_args = [jnp.asarray(d[k]) for k in ARGS]
    out, stats, aux = jfb.bottleneck_rest_fwd(*j_args, h, EPS)
    a1, a2, sum_h, m2h, sc1, sh1, sc2, sh2 = aux
    return dict(d=d, h=h, out=out, stats=stats, a1=a1, a2=a2, sc1=sc1,
                sh1=sh1, sc2=sc2, sh2=sh2,
                dout=rng.randn(*out.shape).astype(np.float32),
                vecs=[rng.randn(c).astype(np.float32),
                      rng.randn(cin).astype(np.float32)])


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_backward_plain_kernels_match_pallas(interpret, shape):
    """Each of the four backward plain versions against its Pallas kernel
    on the chain's own residuals."""
    b = _backward_case(shape, seed=6)
    d, h = b["d"], b["h"]
    jargs = (jnp.asarray(b["dout"]), b["out"], b["a2"], b["sc2"], b["sh2"])
    jg3, jp, jsg = jfb.bwd_reduce3(*jargs)
    tg3, tp, tsg = tfb.bwd_reduce3(*map(_t, jargs))
    _close(tg3, jg3, **FWD)
    _close(tp, jp, atol=1e-4, rtol=1e-4)
    _close(tsg, jsg, atol=1e-4, rtol=1e-4)

    c, cin = d["w1"].shape
    rng = np.random.RandomState(7)
    amat = (rng.randn(c, cin) * 0.1).astype(np.float32)
    bmat = (rng.randn(c, c) * 0.1).astype(np.float32)
    vc = [rng.randn(c).astype(np.float32) * 0.1 for _ in range(5)]
    inv2, m2 = np.abs(vc[0]) + 0.5, vc[1]
    jargs = (jg3, b["a2"], b["sc2"], b["sh2"], amat, bmat, vc[2], inv2, m2)
    jg2, js2, jx2 = jfb.bwd_apply3(*map(jnp.asarray, jargs))
    tg2, ts2, tx2 = tfb.bwd_apply3(*map(_t, jargs))
    for got, want in ((tg2, jg2), (ts2, js2), (tx2, jx2)):
        _close(got, want, atol=1e-4, rtol=1e-4)

    inv1, m1 = np.abs(vc[3]) + 0.5, vc[4]
    jargs = (jg2, b["a2"], b["a1"], b["sc1"], b["sh1"], vc[0], vc[1], vc[2],
             inv1, m1, d["taps"])
    jmid = jfb.bwd_mid(*map(jnp.asarray, jargs), h)
    tmid = tfb.bwd_mid(*map(_t, jargs), h)
    for got, want in zip(tmid, jmid):
        scale = float(np.abs(_np(want)).max())
        assert float(np.abs(got.numpy() - _np(want)).max()) <= 1e-5 * scale

    jargs = (jg3, jmid[0], b["a1"], d["x"], vc[0], vc[1], vc[2], d["w1"])
    jdx, jdw1 = jfb.bwd_final(*map(jnp.asarray, jargs))
    tdx, tdw1 = tfb.bwd_final(*map(_t, jargs))
    for got, want in ((tdx, jdx), (tdw1, jdw1)):
        scale = float(np.abs(_np(want)).max())
        assert float(np.abs(got.numpy() - _np(want)).max()) <= 1e-5 * scale


@pytest.mark.parametrize("with_stat_cotangents", [False, True])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_chain_gradients_match_jax_grad(interpret, shape,
                                        with_stat_cotangents):
    """FusedBottleneckRest's gradients of every input against jax.grad of
    the JAX package's fused_bottleneck_rest (its custom VJP, Pallas in
    interpret mode): one weighted loss over out and, if asked, all six
    batch statistics."""
    n, cin, c, h = shape
    d = _case(*shape, seed=8)
    rng = np.random.RandomState(9)
    dvec = rng.randn(n, cin, h * h).astype(np.float32)
    cvecs = [rng.randn(k).astype(np.float32) for k in (c, c, c, c, cin, cin)]

    def j_loss(*a):
        o = jfb.fused_bottleneck_rest(*a, h, EPS)
        loss = jnp.sum(o[0] * dvec)
        if with_stat_cotangents:
            loss = loss + sum(jnp.sum(v * s) for v, s in zip(cvecs, o[1:]))
        return loss

    j_args = [jnp.asarray(d[k]) for k in ARGS]
    want = jax.grad(j_loss, argnums=tuple(range(10)))(*j_args)
    t_args = [torch.from_numpy(d[k]).requires_grad_(True) for k in ARGS]
    o = tfb.fused_bottleneck_rest(*t_args, h, EPS)
    loss = (o[0] * torch.from_numpy(dvec)).sum()
    if with_stat_cotangents:
        loss = loss + sum((torch.from_numpy(v) * s).sum()
                          for v, s in zip(cvecs, o[1:]))
    loss.backward()
    for name, t, w in zip(ARGS, t_args, want):
        w = np.asarray(w)
        err = float(np.abs(t.grad.numpy() - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), (name, err)


def _bn_params(d, c, cin, seed):
    rng = np.random.RandomState(seed)
    params = []
    for k, width in (("1", c), ("2", c), ("3", cin)):
        params.append((d["g" + k], d["b" + k],
                       (0.1 * rng.randn(width)).astype(np.float32),
                       (0.5 + rng.rand(width)).astype(np.float32)))
    return params


@pytest.mark.parametrize("shape", [(8, 16, 8, 7), (4, 32, 8, 8)])
def test_chain_block_matches_both_compositions(shape):
    """The op's chain helper (the plain chain on the CPU) against the
    port's compose_block and the JAX package's _compose_block: the output
    and all twelve stat outputs (running stats updated with momentum)."""
    n, cin, c, h = shape
    d = _case(*shape, seed=10)
    x = d["x"].reshape(n, cin, h, h)
    w1 = d["w1"].reshape(c, cin, 1, 1)
    w2 = d["taps"].reshape(3, 3, c, c).transpose(2, 3, 0, 1).copy()
    w3 = d["w3"].reshape(cin, c, 1, 1)
    bn = _bn_params(d, c, cin, seed=11)

    def torch_args():
        return ([torch.from_numpy(a) for a in (x, w1, w2, w3)]
                + [[tuple(map(torch.from_numpy, p)) for p in bn]])

    chain_out, chain_st = tfo._chain_block(*torch_args(), EPS, 0.9)
    comp_out, comp_st = tfo.compose_block(*torch_args(), EPS, 0.9)
    j_out, j_st = jfo._compose_block(
        *map(jnp.asarray, (x, w1, w2, w3)),
        [tuple(map(jnp.asarray, p)) for p in bn], EPS, 0.9)
    assert len(chain_st) == len(comp_st) == len(j_st) == 12
    for got, want in [(chain_out, comp_out)] + list(zip(chain_st, comp_st)):
        _close(got.numpy(), want.detach().numpy(), **CHAIN)
    for got, want in [(chain_out, j_out)] + list(zip(chain_st, j_st)):
        _close(got.numpy(), want, **CHAIN)


def _op_ins(x, w1, w2, w3, bn):
    ins = {"X": [x], "W1": [w1], "W2": [w2], "W3": [w3]}
    for k, params in zip("123", bn):
        for slot, v in zip(("Scale", "Bias", "Mean", "Variance"), params):
            ins[slot + k] = [v]
    return ins


@pytest.mark.parametrize("takes", [True, False])
def test_op_takes_the_chain_where_the_gate_does(monkeypatch, takes):
    """With the gate open (as PT_FUSED_BLOCK=always on the card), the
    fused_bottleneck op sends a block the JAX package's shape gate takes
    (N >= 8, H == W, S >= CHAIN_MIN_S, Cin % 128, C % 64) through
    the chain, and one it refuses (S below the minimum) through the
    composition; both agree with the composition."""
    n, cin, c, h = 8, 128, 64, 4
    monkeypatch.setattr(tfo, "fused_block_enabled", lambda device: True)
    monkeypatch.setattr(tfo, "CHAIN_MIN_S", 16 if takes else 17)
    calls = []
    chain = tfo._chain_block
    monkeypatch.setattr(tfo, "_chain_block",
                        lambda *a: calls.append(1) or chain(*a))
    d = _case(n, cin, c, h, seed=12)
    t = torch.from_numpy
    args = (t(d["x"].reshape(n, cin, h, h)), t(d["w1"].reshape(c, cin, 1, 1)),
            t(d["taps"].reshape(3, 3, c, c).transpose(2, 3, 0, 1).copy()),
            t(d["w3"].reshape(cin, c, 1, 1)))
    bn = [tuple(map(t, p)) for p in _bn_params(d, c, cin, seed=13)]
    ctx = ExecContext(torch.Generator(), torch.device("cpu"))
    outs = require_op("fused_bottleneck").compute(
        ctx, _op_ins(*args, bn), {"epsilon": EPS, "momentum": 0.9})
    assert calls == ([1] if takes else [])
    want_out, want_st = tfo.compose_block(*args, bn, EPS, 0.9)
    _close(outs["Out"][0].numpy(), want_out.numpy(), **CHAIN)
    slots = [s.format(k=k) for k in "123" for s in tfo._BN_OUT_SLOTS]
    for slot, want in zip(slots, want_st):
        _close(outs[slot][0].numpy(), want.numpy(), **CHAIN)


@pytest.mark.parametrize("c", [64, 768])
def test_chain_gate_takes_any_c_on_the_cpu(monkeypatch, c):
    """With the gate open, the chain's gate on the CPU (the plain versions
    run) takes C = 768 as it takes 64, past what the card's 1x1 kernels
    hold, and builds nothing to decide (build.bind patched to fail)."""
    def no_kernel(*a):
        raise AssertionError("reached a kernel library")

    monkeypatch.setattr(tfo, "fused_block_enabled", lambda device: True)
    monkeypatch.setattr(build, "bind", no_kernel)
    assert tfo._chain_takes(torch.zeros(8, 128, 14, 14),
                            torch.zeros(c, 128, 1, 1))


def _bwd_args(name, fault):
    """Valid operands of a backward wrapper (N 2, Cin 16, C 8, H 7), one
    of them made float64 or strided as `fault` says."""
    n, cin, c, s, h = 2, 16, 8, 49, 7
    z = torch.zeros

    def act(k):
        return z(n, k, s)

    vec = z(c)
    args = {"bwd_reduce3": [act(cin), act(cin), act(c), vec, vec],
            "bwd_apply3": [act(cin), act(c), vec, vec, z(c, cin), z(c, c),
                           vec, vec, vec],
            "bwd_mid": [act(c), act(c), act(c), vec, vec, vec, vec, vec, vec,
                        vec, z(9, c, c), h],
            "bwd_final": [act(cin), act(c), act(c), act(cin), vec, vec, vec,
                          z(c, cin)]}[name]
    # a second operand, so that the first (the one on_card reads) is not
    # the only one checked
    i = 1
    if fault == "float64":
        args[i] = args[i].double()
    else:
        args[i] = z(args[i].shape[::-1]).transpose(0, -1)
        assert not args[i].is_contiguous()
    return args


@pytest.mark.parametrize("fault", ["float64", "strided"])
@pytest.mark.parametrize("name", ["bwd_reduce3", "bwd_apply3", "bwd_mid",
                                  "bwd_final"])
def test_backward_wrappers_refuse_before_launch(monkeypatch, name, fault):
    """A backward wrapper given tensors declared on the card (the CPU
    tensors here) refuses a float64 or a strided operand, TypeError or
    ValueError, before it reaches its kernel (build.bind patched to fail
    if it is reached)."""
    monkeypatch.setattr(build, "on_card", lambda what, t: True)

    def no_kernel(*a):
        raise AssertionError("reached the kernel")

    monkeypatch.setattr(build, "bind", no_kernel)
    monkeypatch.setattr(build, "sm_count", no_kernel)
    before = getattr(tfb, name).launches
    err = TypeError if fault == "float64" else ValueError
    with pytest.raises(err):
        getattr(tfb, name)(*_bwd_args(name, fault))
    assert getattr(tfb, name).launches == before


@pytest.mark.parametrize("n,cin,c,s,blocks", [
    (128, 256, 64, 3136, 132),   # ResNet-50's three chain stages
    (128, 512, 128, 784, 132),
    (128, 1024, 256, 196, 128),  # 16 tiles: 8 splits
    (3, 256, 64, 100, 20),       # N·S 300: a ragged last stage, 16-byte
    (3, 256, 96, 49, 10),        # S % 4 != 0: 4-byte copies
    (2, 16, 8, 7, 1),            # N·S 14: one stage
    (1, 2048, 512, 4, 64),       # 64 tiles: one split
])
def test_reduce3_grid_covers_k_in_whole_stages(n, cin, c, s, blocks):
    """bwd_reduce3's splits cover N·S exactly, each non-empty, each chunk
    a multiple of the 32-column stage (so of the 4 columns of a copy);
    tiles x splits, one block an SM, fill the 132 SMs' one wave as far as
    whole splits and 32-column chunks allow; 16-byte copies exactly where
    S % 4 == 0. The kernel's entry point refuses any other grid."""
    ns = n * s
    splits, chunk, wide = tfb._reduce3_grid(n, s, cin, c, 132)
    assert chunk > 0 and chunk % 32 == 0 and chunk % 4 == 0
    assert (splits - 1) * chunk < ns <= splits * chunk
    assert 1 <= splits <= 65535
    assert wide == (s % 4 == 0)
    tiles = -(-cin // 128) * -(-c // (64 if c <= 64 else 128))
    assert tiles * splits == blocks


@pytest.mark.parametrize("n,h,w,chunks", [
    (128, 56, 56, 15),    # ResNet-50's three chain stages
    (128, 28, 28, 4),
    (128, 14, 14, 1),
    (2, 10, 12, 1),       # a non-square image
    (2, 16, 20, 2),       # a chunk that ends mid-row
    (1, 3, 250, 4),       # rows wider than a chunk: segmented halo
    (3, 1, 1, 1),
])
def test_conv3x3_grid_covers_the_padded_grid(n, h, w, chunks):
    """conv3x3_norm_stats' column tiles: chunks of 224 positions cover
    each image's padded grid of h rows of w + 2 exactly (the last chunk
    not empty); T = n · chunks, the count the kernel's entry point
    checks; the ring of 3 stages fits a block's 227 KB of shared memory
    at any width (two blocks an SM up to 56 pixels a row)."""
    got_chunks, t, ring = tfb._conv3x3_grid(n, h, w)
    assert got_chunks == chunks
    assert (chunks - 1) * 224 < h * (w + 2) <= chunks * 224
    assert t == n * chunks
    assert ring <= 232448     # a block's shared memory on sm_90
    # the halo's pitch keeps fragment reads on 32 banks: 8 mod 32 floats
    pitch = (ring // 12 - 9 * 64 * 8) // 8
    assert pitch % 32 == 8
    assert pitch >= 2 * min(w + 2, 226) + 226
    if w <= 56:
        assert 2 * (ring + 1024) <= 233472


def test_strided_dout_reaches_the_kernels_contiguous(monkeypatch):
    """FusedBottleneckRest.backward given a strided cotangent of out hands
    every backward wrapper contiguous operands (the kernels refuse strided
    ones on the card), and its gradients are those of a dense one."""
    n, cin, c, h = 2, 16, 8, 7
    d = _case(n, cin, c, h, seed=16)
    seen = []
    for name in ("bwd_reduce3", "bwd_apply3", "bwd_mid", "bwd_final"):
        wrapper = getattr(tfb, name)
        monkeypatch.setattr(tfb, name, lambda *a, w=wrapper: seen.append(a)
                            or w(*a))
    dvec = torch.from_numpy(np.random.RandomState(17).randn(
        n, h * h, cin).astype(np.float32))
    grads = []
    for dout in (dvec.transpose(1, 2), dvec.transpose(1, 2).contiguous()):
        t_args = [torch.from_numpy(d[k]).requires_grad_(True) for k in ARGS]
        o = tfb.fused_bottleneck_rest(*t_args, h, EPS)
        grads.append(torch.autograd.grad(o[0], t_args, dout))
    assert not dvec.transpose(1, 2).is_contiguous()
    tensors = [a for call in seen[:4] for a in call
               if isinstance(a, torch.Tensor)]
    assert len(seen) == 8 and len(tensors) == 5 + 9 + 11 + 8
    assert all(a.is_contiguous() for a in tensors)
    for got, want in zip(*grads):
        _close(got, want, atol=0, rtol=0)


def _bwd_mid_padding_wrong(g2, a2, a1, sc1, sh1, p2, q2, r2, taps, h):
    """The trap: da2 and h1 taken on the padded grid, so an out-of-image
    da2 reads r2 and an out-of-image h1 reads relu(sh1) instead of 0.
    Returns (dh1 before the mask, dtaps)."""
    col = lambda v: v.reshape(1, -1, 1, 1)
    n, c, _ = g2.shape
    pad = lambda t: torch.nn.functional.pad(t.reshape(n, c, h, h),
                                            (1, 1, 1, 1))
    da2 = pad(g2) * col(p2) + pad(a2) * col(q2) + col(r2)
    h1 = torch.clamp_min(pad(a1) * col(sc1) + col(sh1), 0.0)
    inner = da2[:, :, 1:-1, 1:-1]
    dh1 = torch.zeros(n, c, h, h)
    dtaps = torch.zeros(9, c, c)
    for t in range(9):
        dy, dx = t // 3 - 1, t % 3 - 1
        src = da2[:, :, 1 - dy:1 - dy + h, 1 - dx:1 - dx + h]
        dh1 += torch.einsum("oi,nohw->nihw", taps[t], src)
        hs = h1[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + h]
        dtaps[t] = torch.einsum("nohw,nihw->oi", inner, hs)
    return dh1.reshape(n, c, h * h), dtaps


@pytest.mark.parametrize("h", [7, 8])
def test_bwd_mid_pads_da2_and_h1_not_r2(interpret, h):
    """At H 7 and 8, with r2 and shift1 well above zero, the backward 3x3
    reads 0 outside the image for both da2 (the input gradient) and h1
    (the tap gradients): the plain version matches Pallas' bwd_mid, and a
    version that pads before the folds (an out-of-image da2 reading r2, an
    h1 reading relu(shift1)) is far outside the tolerance on the border
    pixels and on the tap gradients."""
    n, cin, c = 2, 16, 8
    b = _backward_case((n, cin, c, h), seed=18)
    rng = np.random.RandomState(19)
    vc = [rng.randn(c).astype(np.float32) for _ in range(4)]
    p2, q2 = np.abs(vc[0]) + 0.5, 0.1 * vc[1]
    r2 = np.abs(vc[2]) + 0.5
    sh1 = np.abs(np.asarray(b["sh1"])) + 0.5
    g2 = rng.randn(n, c, h * h).astype(np.float32)
    inv1, m1 = np.abs(vc[3]) + 0.5, 0.1 * vc[3]
    args = (g2, b["a2"], b["a1"], b["sc1"], sh1, p2, q2, r2, inv1, m1,
            b["d"]["taps"])
    jmid = jfb.bwd_mid(*map(jnp.asarray, args), h)
    tmid = tfb.bwd_mid(*map(_t, args), h)
    for got, want in zip(tmid, jmid):
        scale = float(np.abs(_np(want)).max())
        assert float(np.abs(got.numpy() - _np(want)).max()) <= 1e-5 * scale
    t = [_t(a) for a in args]
    dh1, dtaps = _bwd_mid_padding_wrong(*t[:8], t[10], h)
    mask = (torch.clamp_min(t[2] * t[3].reshape(1, -1, 1)
                            + t[4].reshape(1, -1, 1), 0.0) > 0).numpy()
    gap = (np.abs(np.where(mask, dh1.numpy(), 0.0) - _np(jmid[0]))
           .reshape(n, c, h, h))
    border = np.ones((h, h), bool)
    border[1:-1, 1:-1] = False
    scale = float(np.abs(_np(jmid[0])).max())
    assert gap[:, :, border].max() > 1e3 * 1e-5 * scale
    assert gap[:, :, 1:-1, 1:-1].max() <= 1e-5 * scale
    tap_scale = float(np.abs(_np(jmid[1])).max())
    assert float(np.abs(dtaps.numpy() - _np(jmid[1])).max()) > \
        1e3 * 1e-5 * tap_scale


def _block_program(pkg, prog_mod):
    """data [256, 4, 4] -> fused_bottleneck (C 64) -> global average pool
    -> fc 10 -> softmax cross-entropy, Momentum (lr 0.05, mu 0.9), built
    after reset_unique_names() so that both packages name every var
    alike."""
    prog_mod.reset_unique_names()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        data = pkg.layers.data("data", [256, 4, 4], dtype="float32")
        label = pkg.layers.data("label", [1], dtype="int64")
        h = pkg.layers.fused_bottleneck(data, 64)
        h = pkg.layers.pool2d(h, pool_type="avg", global_pooling=True)
        logits = pkg.layers.fc(h, size=10)
        avg = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits,
                                                                    label))
        pkg.optimizer.MomentumOptimizer(learning_rate=0.05,
                                        momentum=0.9).minimize(avg)
    return main, startup, avg


def test_momentum_step_through_the_chain_matches_composition(monkeypatch):
    """One Momentum step of a fused_bottleneck program (N 8, Cin 256, C
    64, 4x4) through the port's Executor on the CPU, from the JAX startup
    state, with the gate patched open (as PT_FUSED_BLOCK=always opens it
    on the card) and CHAIN_MIN_S lowered to 16: the block runs
    FusedBottleneckRest forward and backward (the plain versions). Every
    persistable after the step (parameters, running stats, velocities)
    matches the composed step's, and the loss the JAX package's composed
    step, within the chain-vs-composition tolerance."""
    jmain, jstart, javg = _block_program(jpt, jprog)
    tmain, _, tavg = _block_program(pt, tprog)
    exe, scope = jpt.Executor(), JScope()
    exe.run(jstart, scope=scope)
    names = sorted(v.name for v in jmain.global_block.vars.values()
                   if v.persistable)
    start = {n: np.array(scope.find_var(n)) for n in names}
    rng = np.random.RandomState(20)
    feed = {"data": np.abs(rng.randn(8, 256, 4, 4)).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
    jloss, = exe.run(jmain, feed=feed, fetch_list=[javg.name], scope=scope)
    backward = tfb.bottleneck_rest_bwd
    calls = []
    monkeypatch.setattr(tfb, "bottleneck_rest_bwd",
                        lambda *a: calls.append(1) or backward(*a))
    losses, ends = {}, {}
    for chain in (False, True):
        if chain:
            monkeypatch.setattr(tfo, "fused_block_enabled",
                                lambda device: True)
            monkeypatch.setattr(tfo, "CHAIN_MIN_S", 16)
        sc = tio.scope_from_numpy(start, "cpu")
        loss, = pt.Executor(pt.CPUPlace()).run(tmain, feed=feed,
                                               fetch_list=[tavg], scope=sc)
        losses[chain] = float(loss[0])
        ends[chain] = {n: sc.get_numpy(n) for n in names}
    assert calls == [1]
    assert any(n.endswith("_velocity_0") for n in names)
    _close(losses[True], float(jloss[0]), **CHAIN)
    _close(losses[False], float(jloss[0]), **CHAIN)
    for n in names:
        assert not np.array_equal(ends[True][n], start[n]) or \
            "learning_rate" in n, n
        _close(ends[True][n], ends[False][n], err_msg=n, **CHAIN)


def test_chain_block_hands_the_kernels_contiguous_operands(monkeypatch):
    """The kernels refuse strided tensors on the card: the op's chain
    helper gives FusedBottleneckRest contiguous float32 operands (the taps
    permuted out of the conv weight included)."""
    n, cin, c, h = 8, 16, 8, 7
    d = _case(n, cin, c, h, seed=14)
    seen = []
    chain = tfb.fused_bottleneck_rest
    monkeypatch.setattr(tfb, "fused_bottleneck_rest",
                        lambda *a: seen.append(a) or chain(*a))
    t = torch.from_numpy
    x = t(d["x"].reshape(n, cin, h, h)).transpose(2, 3)   # a strided input
    w2 = t(d["taps"].reshape(3, 3, c, c).transpose(2, 3, 0, 1).copy())
    bn = [tuple(map(t, p)) for p in _bn_params(d, c, cin, seed=15)]
    tfo._chain_block(x, t(d["w1"].reshape(c, cin, 1, 1)), w2,
                     t(d["w3"].reshape(cin, c, 1, 1)), bn, EPS, 0.9)
    tensors = [a for a in seen[0] if isinstance(a, torch.Tensor)]
    assert len(tensors) == 10
    assert all(a.is_contiguous() and a.dtype == torch.float32
               for a in tensors)
    _close(seen[0][2].numpy(), d["taps"], atol=0, rtol=0)
