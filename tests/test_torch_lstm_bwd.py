"""The LSTM backward's sequence kernel (csrc/fused_lstm.cu
``lstm_bwd_seq_kernel``) on the CPU: its arithmetic and its plan.

* Its recurrence in numpy, as the kernel computes it: step t's carried dr
  is the masked pass-through plus dgates_{t+1} W^T, that product in
  3xTF32 as the forward's (``_Product`` of tests/test_torch_lstm_fwd.py
  over K = 4H: W^T and dgates split into TF32 big and small, each k8
  step's three products into a fresh fragment, the K slices of the
  block's 8 warps, 16 kb deep with kb = ceil(H / 32), summed in warp
  order; a block's 16 units do not change a column's sum); the cell in float32; db summed as the kernel sums it: each
  cell thread over t from T-1 down (its row tiles in turn each step),
  then the block's rows in row order, then the row groups in order.
  The gates' recompute and dW as the launches around the sequence
  kernel compute them (``lstm_bwd_gemm_tc_kernel``): 3xTF32 with a fresh
  fragment each k8 step, k in order, added in float32, then (x + acc) +
  b for the gates. Through the whole recurrence at T 100 the outputs stay within atol = rtol = 1e-4 of
  ``lstm_seq_bwd_reference`` (the card's limit, tests/test_torch_gpu.py)
  at H 64 and 512, full length and ragged, and where the blocks take
  several row tiles in several row groups.
* ``bwd_plan``: the bench shape and every shape the card tests, the
  model paths and chip_smoke.py use take the sequence kernel; H > 512
  (a warp's K slice of W^T would not fit its 16 k16 blocks) or a batch
  past 28 row tiles of 16 a block takes the per-step path; the grid never
  exceeds the co-resident count it is given.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import fused_lstm as fl
from test_torch_lstm_fwd import (CARD_SHAPES, _Product, _mma, _one,
                                 _sigmoid, _split)

BWD_TOL = dict(atol=1e-4, rtol=1e-4)


def _tiles_of(plan, b):
    """[(row group y, [row tiles of y in turn])] of the plan at batch b."""
    rows = 16 * plan.mt
    n = -(-b // rows)
    gy = plan.grid[1]
    return [(y, list(range(y, n, gy))) for y in range(gy)]


def _tc_product(a, b):
    """a [M, K] @ b [K, N] as lstm_bwd_gemm_tc_kernel sums it: k8 steps in
    order, each step's three TF32 products into a fresh fragment, added
    into float32 accumulators."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    zero = np.zeros_like(acc)
    for k in range(0, a.shape[1], 8):
        ab, as_ = _split(np.ascontiguousarray(a[:, k:k + 8]))
        bb, bs = _split(np.ascontiguousarray(b[k:k + 8]))
        f = _mma(zero, as_, bb)
        f = _mma(f, ab, bs)
        f = _mma(f, ab, bb)
        acc = (acc + f).astype(np.float32)
    return acc


def _emulated_bwd(x, w, b, mask, r_prevs, c_prevs, drs, dcs, plan):
    f32 = np.float32
    t_len, bb, h4 = x.shape
    h = h4 // 4
    rows_all = r_prevs.reshape(-1, h)
    gates = ((x.reshape(-1, h4) + _tc_product(rows_all, w)) + b).astype(
        f32).reshape(x.shape)
    product = _Product(np.ascontiguousarray(w.T))   # K = 4H, N = H
    rows = 16 * plan.mt
    groups = _tiles_of(plan, bb)
    # each cell thread's sum of its dgates: [row group, row of a tile, 4H]
    thread_db = np.zeros((plan.grid[1], rows, h4), f32)
    drb = np.zeros((bb, h), f32)
    dc = np.zeros((bb, h), f32)
    dx = np.zeros_like(x)
    for t in reversed(range(t_len)):
        dr = drb + product(dx[t + 1]) if t + 1 < t_len else drb
        g = gates[t]
        i, f, o = _sigmoid(g[:, :h]), _sigmoid(g[:, 2 * h:3 * h]), \
            _sigmoid(g[:, 3 * h:])
        cand = np.tanh(g[:, h:2 * h])
        cp = c_prevs[t]
        c_new = f * cp + i * cand
        tc = np.tanh(c_new)
        m = mask[t][:, None]
        d_rt = dr + drs[t]
        d_ct = dc + dcs[t]
        dr_new, drb = d_rt * m, (d_rt * (1 - m)).astype(f32)
        dc_new, dc_prev = d_ct * m, d_ct * (1 - m)
        d_o = dr_new * tc
        dc_new = dc_new + dr_new * o * (1 - tc * tc)
        d_f, d_i, d_cand = dc_new * cp, dc_new * cand, dc_new * i
        dc = (dc_prev + dc_new * f).astype(f32)
        dx[t] = np.concatenate([d_i * i * (1 - i), d_cand * (1 - cand * cand),
                                d_f * f * (1 - f), d_o * o * (1 - o)], 1)
        for y, tiles in groups:
            for tile in tiles:
                lo = tile * rows
                n = min(rows, bb - lo)
                thread_db[y, :n] = (thread_db[y, :n]
                                    + dx[t, lo:lo + n]).astype(f32)
    dr0 = (drb + product(dx[0])).astype(f32)
    block_db = np.zeros((plan.grid[1], h4), f32)
    for r in range(rows):
        block_db = (block_db + thread_db[:, r]).astype(f32)
    db = np.zeros(h4, f32)
    for y in range(plan.grid[1]):
        db = (db + block_db[y]).astype(f32)
    dw = _tc_product(np.ascontiguousarray(rows_all.T), dx.reshape(-1, h4))
    return dx, dw, db, dr0, dc


def _case(t, b, h, lens, seed):
    """Backward inputs: the forward's carries of the model's Xavier-scale
    W from initial states that are not zero, cotangents ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    lim = (6.0 / (5 * h)) ** 0.5
    x = rng.standard_normal((t, b, 4 * h)).astype(f)
    w = rng.uniform(-lim, lim, (h, 4 * h)).astype(f)
    bias = (0.1 * rng.standard_normal(4 * h)).astype(f)
    mask = (np.arange(t)[:, None] < np.asarray(lens)[None, :]).astype(f)
    r0 = (0.5 * rng.standard_normal((b, h))).astype(f)
    c0 = rng.standard_normal((b, h)).astype(f)
    rs, cs = fl.lstm_seq_fwd_reference(*(torch.from_numpy(v) for v in
                                         (x, w, bias, mask, r0, c0)))
    r_prevs = np.concatenate([r0[None], rs[:-1].numpy()])
    c_prevs = np.concatenate([c0[None], cs[:-1].numpy()])
    drs = rng.standard_normal((t, b, h)).astype(f)
    dcs = rng.standard_normal((t, b, h)).astype(f)
    return x, w, bias, mask, r_prevs, c_prevs, drs, dcs


def _hold(args, plan):
    got = _emulated_bwd(*args, plan)
    want = fl.lstm_seq_bwd_reference(*(torch.from_numpy(v) for v in args))
    for name, g, w_ in zip(("dx", "dw", "db", "dr0", "dc0"), got, want):
        torch.testing.assert_close(torch.from_numpy(g), w_, **BWD_TOL,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("h", [64, 512])
@pytest.mark.parametrize("ragged", [False, True])
def test_3xtf32_holds_lstm_bwd_to_its_limit(h, ragged):
    t, b = 100, 4
    lens = [1, t, 37, 64] if ragged else [t] * b
    args = _case(t, b, h, lens, h + ragged)
    _hold(args, fl.bwd_plan(b, h, 132, _one))


def test_db_order_over_row_tiles_and_row_groups():
    """Blocks that take two row tiles a step in three row groups (on 8
    SMs: row group 0 takes tiles 0 and 3, 1 tiles 1 and 4, 2 tile 2):
    db's threads sum over t and their tiles in turn, then rows, then row
    groups."""
    t, b, h = 12, 70, 20
    plan = fl.bwd_plan(b, h, 8, _one)
    assert plan == (1, 1, 2, (2, 3))
    assert _tiles_of(plan, b) == [(0, [0, 3]), (1, [1, 4]), (2, [2])]
    rng = np.random.default_rng(3)
    lens = rng.integers(1, t + 1, b)
    lens[:2] = (1, t)
    _hold(_case(t, b, h, lens, 4), plan)


# the card tests' backward shapes past one row tile a block
BWD_CARD_SHAPES = CARD_SHAPES + [(300, 128), (200, 512)]


@pytest.mark.parametrize("b,h", BWD_CARD_SHAPES)
def test_card_shapes_take_the_backward_sequence_kernel(b, h):
    p = fl.bwd_plan(b, h, 132, _one)
    assert p is not None
    assert p.grid[0] * fl.UNITS_BWD >= h > (p.grid[0] - 1) * fl.UNITS_BWD
    assert p.mt == 1 and p.grid[1] * p.nt * 16 >= b
    assert (p.grid[1] * (p.nt - 1) + 1) * 16 < b + 16
    assert 1 <= p.nt <= fl.MAX_NT_BWD
    # the 8 warps' K slices cover 4H, and no warp's slice is idle for all
    assert 8 * 16 * p.kb >= 4 * h > 8 * 16 * (p.kb - 1)
    assert p.kb <= fl.MAX_KB_BWD


@pytest.mark.parametrize("b,h", [(4, 2048), (1, 513), (64, 1024),
                                 (1793, 512), (7169, 128)])
def test_a_wide_h_takes_the_per_step_backward(b, h):
    assert fl.bwd_plan(b, h, 132, _one) is None


def test_the_backward_grid_never_exceeds_what_the_card_holds():
    seen = set()
    for sms in (1, 8, 132):
        for per_sm in (0, 1, 2):
            for b in (1, 16, 17, 64, 65, 128, 300, 5000):
                for h in (8, 33, 128, 129, 512):
                    p = fl.bwd_plan(b, h, sms, lambda *a: per_sm)
                    seen.add(p is None)
                    if p is not None:
                        assert p.grid[0] * p.grid[1] <= sms * per_sm
                        assert p.grid[1] * p.nt * 16 * p.mt >= b
    assert seen == {True, False}
    # on 132 SMs, one block each: 32 unit groups of 16 x 4 rows of blocks
    # at H 512, each taking up to 28 row tiles of 16 a step; 16-deep k16
    # blocks: 4H over 8 warps
    assert fl.bwd_plan(64, 512, 132, _one) == (1, 16, 1, (32, 4))
    assert fl.bwd_plan(128, 512, 132, _one) == (1, 16, 2, (32, 4))
    assert fl.bwd_plan(1792, 512, 132, _one) == (1, 16, 28, (32, 4))
    assert fl.bwd_plan(1793, 512, 132, _one) is None
    assert fl.bwd_plan(8, 128, 132, _one) == (1, 4, 1, (8, 1))
    asked = []
    fl.bwd_plan(200, 512, 132, lambda *a: asked.append(a) or 1)
    assert asked == [(1, 16, 1), (1, 16, 4)]
