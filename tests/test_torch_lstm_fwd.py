"""The LSTM forward's sequence kernel (csrc/fused_lstm.cu
``lstm_fwd_seq_kernel``) on the CPU: its arithmetic and its plan.

* Its product in numpy, as the kernel computes it: W and r split into
  TF32 big and small (W once here, at each use on the card: the same
  values); each k8 step's products
  small.big, big.small and big.big into a fresh fragment (the tensor
  cores' sums emulated in float64 over TF32 operands, truncated toward
  zero to float32), added into float32 accumulators; the K slices of the
  block's 8 warps (16 kb deep, kb = ceil(H / 128)) summed in warp order;
  then the cell in float32. Through the whole recurrence at T 100, it
  stays within atol = rtol = 1e-5 of ``lstm_seq_fwd_reference`` (the
  card's limit, tests/test_torch_gpu.py) at H 64 and 512.
* ``fwd_plan``: the bench shape and every shape the card tests, the
  model paths and chip_smoke.py use take the sequence kernel, and so
  does a batch past one row tile a block (its blocks take their tiles in
  turn); an H whose K slice cannot sit in a warp's registers (H > 512),
  or a batch past 64 row tiles a block, takes the step kernel; the grid
  never exceeds the co-resident count it is given.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import fused_lstm as fl

TOL = dict(atol=1e-5, rtol=1e-5)


def _split(x):
    """(big, small): big = x rounded to TF32 (to nearest, ties away), small
    = x - big, as tf32_mma.cuh's split."""
    u = x.view(np.uint32)
    big = ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)
    return big, (x - big).astype(np.float32)


def _tf32(x):
    return (x.view(np.uint32) & np.uint32(0xffffe000)).view(np.float32)


def _mma(c, a, b):
    """c + a b over TF32 operands (the low 13 bits dropped), summed in
    float64 and truncated toward zero to float32."""
    s = c.astype(np.float64) + (_tf32(a).astype(np.float64)
                                @ _tf32(b).astype(np.float64))
    f = s.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(s)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


class _Product:
    """r @ w as the sequence kernel sums it."""

    def __init__(self, w):
        h = w.shape[0]
        self.depth = 16 * -(-h // 128)
        self.warps = min(8, -(-h // self.depth))
        k = 8 * self.depth
        wp = np.zeros((k, w.shape[1]), np.float32)
        wp[:h] = w
        # k8 step ss of a k16 block: slot t <- 4 t + 2 ss, t + 4 <- + 1
        self.steps = []
        for v in range(self.warps):
            for q in range(self.depth // 16):
                base = v * self.depth + 16 * q
                for ss in (0, 1):
                    ks = ([base + 4 * t + 2 * ss for t in range(4)]
                          + [base + 4 * t + 2 * ss + 1 for t in range(4)])
                    self.steps.append((v, ks, _split(wp[ks])))
        self.h, self.k = h, k

    def __call__(self, r):
        rp = np.zeros((r.shape[0], self.k), np.float32)
        rp[:, :self.h] = r
        zero = np.zeros((r.shape[0], self.steps[0][2][0].shape[1]),
                        np.float32)
        parts = [zero.copy() for _ in range(self.warps)]
        for v, ks, (bb, bs) in self.steps:
            ab, as_ = _split(np.ascontiguousarray(rp[:, ks]))
            f = _mma(zero, as_, bb)
            f = _mma(f, ab, bs)
            f = _mma(f, ab, bb)
            parts[v] = (parts[v] + f).astype(np.float32)
        acc = parts[0]
        for p in parts[1:]:
            acc = (acc + p).astype(np.float32)
        return acc


def _sigmoid(x):
    return (np.float32(1) / (np.float32(1) + np.exp(-x))).astype(np.float32)


def _emulated_fwd(x, w, b, mask, r0, c0):
    product = _Product(w)
    h = w.shape[0]
    r, c = r0, c0
    rs, cs = [], []
    for t in range(x.shape[0]):
        g = ((x[t] + product(r)) + b).astype(np.float32)
        i, f, o = _sigmoid(g[:, :h]), _sigmoid(g[:, 2 * h:3 * h]), \
            _sigmoid(g[:, 3 * h:])
        cand = np.tanh(g[:, h:2 * h])
        c_new = f * c + i * cand
        r_new = o * np.tanh(c_new)
        m = mask[t][:, None]
        r = (m * r_new + (1 - m) * r).astype(np.float32)
        c = (m * c_new + (1 - m) * c).astype(np.float32)
        rs.append(r)
        cs.append(c)
    return np.stack(rs), np.stack(cs)


@pytest.mark.parametrize("h", [64, 512])
def test_3xtf32_holds_lstm_fwd_to_its_limit(h):
    t, b = 100, 4
    rng = np.random.default_rng(h)
    f = np.float32
    lim = (6.0 / (5 * h)) ** 0.5
    lens = np.array([1, t, 37, 64])
    d = dict(x=rng.standard_normal((t, b, 4 * h)).astype(f),
             w=rng.uniform(-lim, lim, (h, 4 * h)).astype(f),
             b=(0.1 * rng.standard_normal(4 * h)).astype(f),
             mask=(np.arange(t)[:, None] < lens[None, :]).astype(f),
             r0=(0.5 * rng.standard_normal((b, h))).astype(f),
             c0=rng.standard_normal((b, h)).astype(f))
    keys = ("x", "w", "b", "mask", "r0", "c0")
    got = _emulated_fwd(*(d[k] for k in keys))
    want = fl.lstm_seq_fwd_reference(*(torch.from_numpy(d[k]) for k in keys))
    for g, w_ in zip(got, want):
        torch.testing.assert_close(torch.from_numpy(g), w_, **TOL)


def _one(mt, kb, nt):
    return 1


# (B, H): the bench shape, the card-vs-CPU LSTM (chip_smoke.py), the
# card tests' shapes and the narrow model of the card's training test
CARD_SHAPES = [(64, 512), (8, 128), (3, 20), (1, 8), (17, 33), (4, 16),
               (4, 32), (2, 8), (128, 512), (65, 512), (96, 128)]


@pytest.mark.parametrize("b,h", CARD_SHAPES)
def test_card_shapes_take_the_sequence_kernel(b, h):
    p = fl.fwd_plan(b, h, 132, _one)
    assert p is not None
    assert p.grid[0] * fl.UNITS >= h > (p.grid[0] - 1) * fl.UNITS
    assert p.grid[1] * p.nt * 16 * p.mt >= b and p.mt <= fl.MAX_MT
    # no block takes a tile more than it must
    assert (p.grid[1] * (p.nt - 1) + 1) * 16 * p.mt < b + 16 * p.mt
    assert 1 <= p.nt <= fl.MAX_NT
    assert 8 * 16 * p.kb >= h > 8 * 16 * (p.kb - 1)
    assert p.kb <= fl.MAX_KB


@pytest.mark.parametrize("b,h", [(4, 2048), (1, 513), (64, 1024),
                                 (4097, 512), (16385, 128)])
def test_a_wide_h_takes_the_step_kernel(b, h):
    assert fl.fwd_plan(b, h, 132, _one) is None


def test_the_grid_never_exceeds_what_the_card_holds():
    seen = set()
    for sms in (1, 8, 132):
        for per_sm in (0, 1, 2):
            for b in (1, 16, 17, 64, 65, 128, 300, 5000):
                for h in (8, 33, 128, 129, 512):
                    p = fl.fwd_plan(b, h, sms, lambda *a: per_sm)
                    seen.add(p is None)
                    if p is not None:
                        assert p.grid[0] * p.grid[1] <= sms * per_sm
                        assert p.grid[1] * p.nt * 16 * p.mt >= b
    assert seen == {True, False}
    # on 132 SMs, one block each: two rows of blocks at H 512, eight at
    # H 128, each taking up to 64 row tiles of 32 a step
    assert fl.fwd_plan(64, 512, 132, _one) == (2, 4, 1, (64, 2))
    assert fl.fwd_plan(65, 512, 132, _one) == (2, 4, 2, (64, 2))
    assert fl.fwd_plan(4096, 512, 132, _one) == (2, 4, 64, (64, 2))
    assert fl.fwd_plan(4097, 512, 132, _one) is None
    assert fl.fwd_plan(256, 128, 132, _one) == (2, 1, 1, (16, 8))
    assert fl.fwd_plan(257, 128, 132, _one) == (2, 1, 2, (16, 5))
    assert fl.fwd_plan(16384, 128, 132, _one) == (2, 1, 64, (16, 8))
    # the occupancy is asked at the plan's own tile count
    asked = []
    fl.fwd_plan(200, 512, 132, lambda *a: asked.append(a) or 1)
    assert asked == [(2, 4, 1), (2, 4, 4)]
