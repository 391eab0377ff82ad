"""The arithmetic of the bfloat16 LSTM kernels
(``paddle_tpu_torch/csrc/fused_lstm_bf16.cu``), emulated in PyTorch on the
CPU, and how far it moves from the plain versions.

``fwd_emulated`` and ``bwd_emulated`` repeat the kernels' summation order
and rounding points on bf16 inputs: each k16 block's 16 bf16 products
summed exactly (in float64) onto a float32 accumulator, as the tensor
cores add them; the forward's 8 warps' K slices (16 kb deep, kb =
ceil(H / 128)) each in its own accumulator, added in warp order, then
(x + sum) + b, the cell in float32 and both carries rounded to bf16; the
backward's gates' recompute and dW over k16 stages in order, the
recurrence's dgates W^T in 8 warp slices (kb = ceil(4H / 128)) of two
chains each (even and odd k16 blocks), the pass-through plus the warps'
sums in order, dgates rounded to bf16 into dx, db summed from the float32
dgates by a cell thread over t, the block over its 16 rows, then over the
row groups of ``bwd_plan`` on a card of 132 SMs of one block each.

Run as a script, it holds the emulation against ``lstm_seq_fwd_reference``
and ``lstm_seq_bwd_reference`` at the bench's shape (T 100, B 64, H 512;
full length and ragged, inputs as chip_smoke.py's ``lstm_case`` makes
them, rounded to bf16) and prints, for each output, the largest
|emulated - plain| over max|plain| and the largest share of the limit
2^-7 max|plain| + 2^-7 |plain|, how many elements differ, and for the
forward how many carries differ at each of steps 1, 10, 50 and 100 (how
far a carry that rounds to the neighbouring bf16 value travels):

    python scripts/lstm_bf16_arith.py [--t 100 --b 64 --h 512]
"""

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from paddle_tpu_torch.kernels import fused_lstm as fl  # noqa: E402

BF16_REL = 2.0 ** -7
SMS = 132


def _bf(v: torch.Tensor) -> torch.Tensor:
    """v rounded to bf16, back in float32."""
    return v.bfloat16().float()


def _blocks(k0: int, k1: int, limit: int):
    """The k16 blocks [k, k + 16) of [k0, k1) that start below limit."""
    return [(k, min(k + 16, limit)) for k in range(k0, k1, 16) if k < limit]


def _mma_sum(acc, a, b, k, k1):
    """acc + the block's products a[:, k:k1] b[k:k1], exact, rounded once."""
    return (acc.double() + a[:, k:k1].double() @ b[k:k1].double()).float()


def _warp_sums(a, b, width: int, kb: int, chains: int = 1):
    """sum over k of a[:, k] b[k] as the kernels' 8 warps take it: warp w
    the K slice [16 kb w, 16 kb (w + 1)), its k16 blocks in `chains`
    interleaved accumulators (added at the end), the warps in order."""
    total = None
    for w in range(8):
        blocks = _blocks(16 * kb * w, 16 * kb * (w + 1), width)
        if not blocks:
            break
        acc = [torch.zeros(a.shape[0], b.shape[1]) for _ in range(chains)]
        for q, (k, k1) in enumerate(blocks):
            acc[q % chains] = _mma_sum(acc[q % chains], a, b, k, k1)
        part = acc[0] if chains == 1 else acc[0] + acc[1]
        total = part if total is None else total + part
    return total


def _cell(gates, c, h):
    i = torch.sigmoid(gates[:, :h])
    cand = torch.tanh(gates[:, h:2 * h])
    f = torch.sigmoid(gates[:, 2 * h:3 * h])
    o = torch.sigmoid(gates[:, 3 * h:])
    return i, f, o, cand, f * c + i * cand


def fwd_emulated(x, w, b, mask, r0, c0):
    """(rs, cs) bf16 as the forward kernel computes them."""
    h = w.shape[0]
    kb = -(-h // 128)
    wf, bf = w.float(), b.float()
    r, c = r0.float(), c0.float()
    rs, cs = [], []
    for t in range(x.shape[0]):
        a = _warp_sums(r, wf, h, kb)
        gates = (x[t].float() + a) + bf
        _, _, o, _, c_new = _cell(gates, c, h)
        r_new = o * torch.tanh(c_new)
        m = mask[t][:, None].float()
        r = _bf(m * r_new + (1.0 - m) * r)
        c = _bf(m * c_new + (1.0 - m) * c)
        rs.append(r)
        cs.append(c)
    return torch.stack(rs).bfloat16(), torch.stack(cs).bfloat16()


def _stages(a, b):
    """a [M, K] b [K, N] over k16 stages of K in order, as the backward's
    products take them."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 16):
        acc = _mma_sum(acc, a, b, k, min(k + 16, a.shape[1]))
    return acc


def bwd_emulated(x, w, b, mask, r_prevs, c_prevs, drs, dcs, sms: int = SMS):
    """(dx bf16, dw, db, dr0, dc0) as the backward's three launches compute
    them; the row groups of db's sums are bwd_plan's on `sms` SMs of one
    block each."""
    t_len, bb, h4 = x.shape
    h = h4 // 4
    kb = -(-h4 // 128)
    wf = w.float()
    rows = r_prevs.reshape(-1, h).float()
    gates_all = ((x.reshape(-1, h4).float() + _stages(rows, wf))
                 + b.float()).reshape(t_len, bb, h4)
    groups = fl.bwd_plan(bb, h, sms, lambda *_: 1).grid[1]
    dr = torch.zeros(bb, h)
    dc = torch.zeros(bb, h)
    dx = torch.empty(t_len, bb, h4)
    # db's sums of the cell threads: thread (row group y, row cr) adds the
    # dgates of row cr of each of its tiles y, y + groups, ... in turn, t
    # from T-1 down
    thread = {}
    wt = wf.t()
    for t in reversed(range(t_len)):
        if t + 1 < t_len:
            dr = dr + _warp_sums(dx[t + 1], wt, h4, kb, chains=2)
        c_prev = c_prevs[t].float()
        i, f, o, cand, c_new = _cell(gates_all[t], c_prev, h)
        tc = torch.tanh(c_new)
        m = mask[t][:, None].float()
        d_rt = dr + drs[t].float()
        d_ct = dc + dcs[t].float()
        dr_new, dr_prev = d_rt * m, d_rt * (1.0 - m)
        dc_new, dc_prev = d_ct * m, d_ct * (1.0 - m)
        d_o = dr_new * tc
        dc_new = dc_new + dr_new * o * (1.0 - tc * tc)
        d_f, d_i, d_cand = dc_new * c_prev, dc_new * cand, dc_new * i
        dc_prev = dc_prev + dc_new * f
        dgates = torch.cat([d_i * i * (1.0 - i), d_cand * (1.0 - cand * cand),
                            d_f * f * (1.0 - f), d_o * o * (1.0 - o)], dim=1)
        dx[t] = _bf(dgates)
        for row in range(bb):
            tile, cr = divmod(row, 16)
            key = (tile % groups, cr)
            thread[key] = (dgates[row] if key not in thread
                           else thread[key] + dgates[row])
        dr, dc = dr_prev, dc_prev
    dr0 = dr + _warp_sums(dx[0], wt, h4, kb, chains=2)
    # db: each block's threads in row order, then the row groups in order
    db = None
    for y in range(groups):
        block = None
        for cr in range(16):
            v = thread.get((y, cr))
            if v is not None:
                block = v if block is None else block + v
        if block is not None:
            db = block if db is None else db + block
    dw = _stages(rows.t().contiguous(), dx.reshape(-1, h4))
    return dx.bfloat16(), dw, db, dr0, dc


def share(got, want) -> float:
    """The largest |got - want| over 2^-7 max|want| + 2^-7 |want|."""
    got, want = got.float(), want.float()
    lim = BF16_REL * want.abs().max() + BF16_REL * want.abs()
    return float(((got - want).abs() / lim).max())


def bench_inputs(t, b, h, lens, seed):
    """chip_smoke.py lstm_case's inputs on the CPU, rounded to bf16:
    x ~ N(0, 1), W ~ U(+-sqrt(6 / 5H)), small biases, initial states that
    are not zero, the mask of `lens` (None: full length), cotangents ~
    N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    lim = (6.0 / (5 * h)) ** 0.5
    w = (torch.rand(h, 4 * h, generator=gen) * 2 - 1) * lim
    if lens is None:
        mask = torch.ones(t, b)
    else:
        mask = (torch.arange(t)[:, None]
                < torch.as_tensor(lens)[None, :]).float()
    d = dict(x=torch.randn(t, b, 4 * h, generator=gen), w=w,
             b=0.1 * torch.randn(4 * h, generator=gen), mask=mask,
             r0=0.5 * torch.randn(b, h, generator=gen),
             c0=torch.randn(b, h, generator=gen),
             drs=torch.randn(t, b, h, generator=gen),
             dcs=torch.randn(t, b, h, generator=gen))
    return {k: v.bfloat16() for k, v in d.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t", type=int, default=100)
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--h", type=int, default=512)
    args = ap.parse_args()
    torch.set_num_threads(4)
    t, b, h = args.t, args.b, args.h
    gen = torch.Generator().manual_seed(11)
    ragged = torch.randint(1, t + 1, (b,), generator=gen)
    ragged[:2] = torch.tensor([1, t])
    for what, lens in (("full length", None), ("ragged", ragged.tolist())):
        d = bench_inputs(t, b, h, lens, 12)
        fwd = [d[k] for k in ("x", "w", "b", "mask", "r0", "c0")]
        want = fl.lstm_seq_fwd_reference(*fwd)
        got = fwd_emulated(*fwd)
        steps = [s for s in (1, 10, 50, 100) if s <= t]
        flips = [int((got[0][s - 1] != want[0][s - 1]).sum()) for s in steps]
        r_prevs = torch.cat([d["r0"][None], want[0][:-1]])
        c_prevs = torch.cat([d["c0"][None], want[1][:-1]])
        bwd = fwd[:4] + [r_prevs, c_prevs, d["drs"], d["dcs"]]
        bwant = fl.lstm_seq_bwd_reference(*bwd)
        bgot = bwd_emulated(*bwd)
        print(f"T {t}, B {b}, H {h}, {what}:")
        names = ("rs", "cs", "dx", "dw", "db", "dr0", "dc0")
        for n, g, w_ in zip(names, list(got) + list(bgot),
                            list(want) + list(bwant)):
            g, w_ = g.float(), w_.float()
            rel = float((g - w_).abs().max() / w_.abs().max())
            print(f"  {n}: largest |emulated - plain| / max|plain| "
                  f"{rel:.3e}, share of the limit {share(g, w_):.4f}, "
                  f"elements that differ {int((g != w_).sum())} of "
                  f"{g.numel()}")
        print(f"  r carries that differ at steps {steps}: {flips} of {b * h}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
