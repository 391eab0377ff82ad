"""Whole-sequence LSTM kernels (forward and backward) and their plain
PyTorch versions.

Counterpart of ``paddle_tpu/kernels/fused_lstm.py``. Time-major, as the
TPU kernels are: x [T, B, 4H] holds the pre-projected inputs, w [H, 4H]
the recurrent weight, b [4H] the gate bias, mask [T, B] the length mask,
r0/c0 [B, H] the initial state; the gate order is i, c, f, o; rows past
a sequence's length carry their state forward. The functions return the
CARRY sequences (rs, cs) [T, B, H]: the op multiplies them by the mask,
and the backward needs the carries, not the masked values.

Two kernels, written by hand for Hopper in
``paddle_tpu_torch/csrc/fused_lstm.cu`` (its header says what bounds
them and what the design does about it):

* ``lstm_seq_fwd`` replaces the Pallas ``lstm_seq_fwd`` (``_fwd_kernel``):
  one cooperative launch a sequence, each block's slice of W held in
  registers for all T steps, its row tiles taken one after another each
  step and a grid barrier between steps, where ``fwd_plan`` finds a grid
  the card holds at once (every H <= 512); else one launch per step, T
  in all;
* ``lstm_seq_bwd`` replaces the Pallas ``lstm_seq_bwd`` (``_bwd_kernel``):
  the gates' recompute (a 3xTF32 tensor-core product), then the reverse
  recurrence in one cooperative launch (each block's slice of W^T held
  in shared memory for all T steps, dgates_{t+1} read back from dx by
  every block after a grid barrier, db and dr0 inside the launch), then
  dW (the same product): 3 launches, where ``bwd_plan`` finds a grid the
  card holds at once (every H <= 512); else the same two products around
  two launches per step (the cell, then dgates W^T in slices), dr0 and
  db: 2T + 4 launches.

For bfloat16 inputs (mixed-precision training) two more kernels, in
``paddle_tpu_torch/csrc/fused_lstm_bf16.cu``, replace the same two
Pallas kernels as they run on bf16 tiles: ``lstm_seq_fwd_bf16`` (one
cooperative launch, W's slice held as bf16 ``mma.sync`` fragments, the
carries rounded to bf16 once a step) and ``lstm_seq_bwd_bf16`` (the
gates' recompute, the recurrence in one cooperative launch, dW: bf16
products with float32 accumulation, dgates rounded to bf16 before its
products, db from the float32 dgates). The float32 wrappers hand a
bfloat16 CUDA tensor to them. They take H a multiple of 8, at most 512,
and B within ``fwd_plan`` / ``bwd_plan``; any other shape raises (no
per-step bf16 path). The plain versions compute in the inputs' dtype
with the Pallas kernels' rounding points.

Each wrapper runs its plain version (``lstm_seq_fwd_reference``,
``lstm_seq_bwd_reference``) only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises, and counts the call in its
``launches`` attribute.

``LSTMSequence`` is the ``torch.autograd.Function`` of the JAX package's
``lstm_sequence`` custom VJP, with its residuals: it saves the carry
sequences, builds r_prevs / c_prevs by one concatenate and gives the
mask a zero gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from . import build

__all__ = ["lstm_seq_fwd_reference", "lstm_seq_bwd_reference",
           "SeqPlan", "fwd_plan", "bwd_plan", "lstm_seq_fwd",
           "lstm_seq_bwd", "lstm_seq_fwd_bf16", "lstm_seq_bwd_bf16",
           "LSTMSequence", "lstm_sequence"]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _cell(gates: torch.Tensor, c: torch.Tensor, h: int):
    """(i, f, o, cand, c_new) of one step from its gates [B, 4H]."""
    i = torch.sigmoid(gates[:, :h])
    cand = torch.tanh(gates[:, h:2 * h])
    f = torch.sigmoid(gates[:, 2 * h:3 * h])
    o = torch.sigmoid(gates[:, 3 * h:])
    return i, f, o, cand, f * c + i * cand


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """float32 for bfloat16 (or float16) inputs, else the inputs' own."""
    return torch.promote_types(x.dtype, torch.float32)


def lstm_seq_fwd_reference(x, w, b, mask, r0, c0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward recurrence step by step: (rs, cs) [T, B, H] in x's
    dtype. For bfloat16 inputs it rounds where the Pallas kernel does
    (``_fwd_kernel``): gates = x + r W + b and the cell in float32 (the
    bf16 products exact, summed in float32), both carries rounded to
    bfloat16 once a step, after the mask blend. For float32 (or wider)
    inputs the casts are no-ops."""
    h = w.shape[0]
    ct = _compute_dtype(x)
    wf, bf = w.to(ct), b.to(ct)
    r, c = r0, c0
    rs, cs = [], []
    for t in range(x.shape[0]):
        gates = x[t].to(ct) + r.to(ct) @ wf + bf
        _, _, o, _, c_new = _cell(gates, c.to(ct), h)
        r_new = o * torch.tanh(c_new)
        m = mask[t][:, None].to(ct)
        r = (m * r_new + (1.0 - m) * r.to(ct)).to(x.dtype)
        c = (m * c_new + (1.0 - m) * c.to(ct)).to(x.dtype)
        rs.append(r)
        cs.append(c)
    return torch.stack(rs), torch.stack(cs)


def lstm_seq_bwd_reference(x, w, b, mask, r_prevs, c_prevs, drs, dcs):
    """The reverse-time derivation of the TPU kernel (``_bwd_kernel``):
    the gates recomputed from r_prevs, (dr, dc) carried from step to
    step. Returns (dx [T, B, 4H] in x's dtype, dw [H, 4H], db [4H], dr0,
    dc0 float32). For bfloat16 inputs it rounds where the Pallas kernel
    does: the gates, the cell and the carried (dr, dc) in float32,
    dgates rounded to bfloat16 before it is written as dx and before both
    products (dgates W^T into dr, r_prevs^T dgates into dw), db summed
    from the unrounded float32 dgates. For float32 (or wider) inputs the
    casts are no-ops."""
    t_len, _, h4 = x.shape
    h = h4 // 4
    ct = _compute_dtype(x)
    wf = w.to(ct)
    gates_all = x.to(ct) + torch.matmul(r_prevs.to(ct), wf) + b.to(ct)
    dr = torch.zeros_like(drs[0], dtype=ct)
    dc = torch.zeros_like(dcs[0], dtype=ct)
    dx = torch.empty_like(x)
    # the unrounded dgates, which db sums (dx itself where x is not
    # narrower than float32)
    dg = dx if x.dtype == ct else torch.empty_like(x, dtype=ct)
    for t in reversed(range(t_len)):
        c_prev = c_prevs[t].to(ct)
        i, f, o, cand, c_new = _cell(gates_all[t], c_prev, h)
        tc = torch.tanh(c_new)
        m = mask[t][:, None].to(ct)
        d_rt = dr + drs[t].to(ct)
        d_ct = dc + dcs[t].to(ct)
        dr_new, dr_prev = d_rt * m, d_rt * (1.0 - m)
        dc_new, dc_prev = d_ct * m, d_ct * (1.0 - m)
        d_o = dr_new * tc
        dc_new = dc_new + dr_new * o * (1.0 - tc * tc)
        d_f, d_i, d_cand = dc_new * c_prev, dc_new * cand, dc_new * i
        dc_prev = dc_prev + dc_new * f
        dgates = torch.cat([d_i * i * (1.0 - i), d_cand * (1.0 - cand * cand),
                            d_f * f * (1.0 - f), d_o * o * (1.0 - o)], dim=1)
        dg[t] = dgates
        dx[t] = dgates
        dr = dr_prev + dx[t].to(ct) @ wf.t()
        dc = dc_prev
    dw = r_prevs.reshape(-1, h).to(ct).t() @ dx.reshape(-1, h4).to(ct)
    return dx, dw, dg.reshape(-1, h4).sum(dim=0), dr, dc


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


_F32_SOURCE, _BF16_SOURCE = "fused_lstm.cu", "fused_lstm_bf16.cu"


def _fn(name: str, argtypes: tuple, source: str = _F32_SOURCE):
    return build.bind(source, name, argtypes)


def _shapes(x: torch.Tensor) -> Tuple[int, int, int]:
    if x.dim() != 3 or x.shape[2] % 4 or min(x.shape) < 1:
        raise ValueError(f"x must be [T, B, 4H] with T, B, H >= 1, got "
                         f"{tuple(x.shape)}")
    t, b, h4 = x.shape
    return t, b, h4 // 4


def _dr_slices(b: int, h: int, sms: int) -> int:
    """K slices of the per-step dgates W^T product: enough 64 x 64 output
    tiles x slices for about two blocks per SM, each slice at least 128
    deep (at B 64, H 512: 8 tiles x 16 slices of 128)."""
    tiles = -(-b // 64) * -(-h // 64)
    return max(1, min(-(-2 * sms // tiles), 4 * h // 128))


# The forward sequence kernel's blocks: 8 hidden units (all four gate
# columns of each) over row tiles of at most 2 x 16 rows, at most 64 row
# tiles a block a step; a warp's K slice (H over 8 warps) at most 4 k16
# blocks deep: H <= 512. The backward's: 16 units over row tiles of 16
# rows, at most 28 a block a step; a warp's K slice (4H over 8 warps) at
# most 16 k16 blocks deep: H <= 512.
UNITS, MAX_MT, MAX_NT, MAX_KB = 8, 2, 64, 4
UNITS_BWD, MAX_NT_BWD, MAX_KB_BWD = 16, 28, 16


class SeqPlan(NamedTuple):
    mt: int                # 16-row tiles a row tile
    kb: int                # k16 blocks of each of a block's 8 warps
    nt: int                # row tiles a block takes a step, at most
    grid: Tuple[int, int]  # (unit groups, row groups)


def fwd_plan(b: int, h: int, sms: int,
             blocks_per_sm: Callable[[int, int, int], int]
             ) -> Optional[SeqPlan]:
    """The forward sequence kernel's launch for x [T, b, 4h] (any T >=
    1) on a card of `sms` SMs, each holding blocks_per_sm(mt, kb, nt)
    blocks at once: ceil(h / 8) unit groups x as many row groups as the
    card holds, each taking nt row tiles of 16 mt rows a step. None (the
    step kernel, T launches) where H > 512 (a warp's K slice of W would
    not fit in its registers), or a block would take more than 64 row
    tiles (on 132 SMs at one block each: B > 4096 at H 512, B > 16384 at
    H 128), or not one row of blocks fits."""
    return _seq_plan(b, h, -(-h // 128), MAX_KB, UNITS, MAX_MT, MAX_NT, sms,
                     blocks_per_sm)


def bwd_plan(b: int, h: int, sms: int,
             blocks_per_sm: Callable[[int, int, int], int]
             ) -> Optional[SeqPlan]:
    """The backward sequence kernel's launch, by the forward's rule with
    its own blocks: ceil(h / 16) unit groups (a block's slice of W^T,
    [4h, 16], in shared memory), row tiles of 16 rows (mt 1), its 8 warps
    splitting K = 4h, ceil(h / 32) k16 blocks each. None (the per-step path, 2T
    + 4 launches) where H > 512, or a block would take more than 28 row
    tiles (on 132 SMs at one block each: B > 1792 at H 512, B > 7168 at H
    128), or not one row of blocks fits."""
    return _seq_plan(b, h, -(-h // 32), MAX_KB_BWD, UNITS_BWD, 1,
                     MAX_NT_BWD, sms, blocks_per_sm)


def _seq_plan(b, h, kb, max_kb, units_a_block, max_mt, max_nt, sms,
              blocks_per_sm) -> Optional[SeqPlan]:
    if kb > max_kb:
        return None
    mt = min(max_mt, -(-b // 16))
    tiles = -(-b // (16 * mt))
    units = -(-h // units_a_block)
    rows = sms * blocks_per_sm(mt, kb, 1) // units
    if rows < 1:
        return None
    nt = -(-tiles // min(tiles, rows))
    grid = (units, -(-tiles // nt))
    if nt > max_nt or grid[0] * grid[1] > sms * blocks_per_sm(mt, kb, nt):
        return None
    return SeqPlan(mt, kb, nt, grid)


@functools.cache
def _blocks_per_sm(index: int, source: str, symbol: str, mt: int, kb: int,
                   nt: int) -> int:
    """cudaOccupancyMaxActiveBlocksPerMultiprocessor of a sequence
    kernel (`symbol`: its C query in `source`), once a (device, kernel,
    mt, kb, nt)."""
    out = ctypes.c_int(0)
    with build.device_guard(torch.device("cuda", index)):
        build.launch(symbol, _fn(symbol, (_I, _I, _I, _P), source), mt, kb,
                     nt, ctypes.byref(out))
    return out.value


# (source, forward query, backward query) of each input dtype's kernels
_QUERIES = {
    torch.float32: (_F32_SOURCE, "lstm_fwd_blocks_per_sm",
                    "lstm_bwd_blocks_per_sm"),
    torch.bfloat16: (_BF16_SOURCE, "lstm_fwd_bf16_blocks_per_sm",
                     "lstm_bwd_bf16_blocks_per_sm")}


@functools.cache
def _plan_of(b: int, h: int, index: int, dtype: torch.dtype = torch.float32
             ) -> Optional[SeqPlan]:
    source, fwd_query, _ = _QUERIES[dtype]
    return fwd_plan(b, h, build.sm_count(torch.device("cuda", index)),
                    functools.partial(_blocks_per_sm, index, source,
                                      fwd_query))


@functools.cache
def _bwd_plan_of(b: int, h: int, index: int,
                 dtype: torch.dtype = torch.float32) -> Optional[SeqPlan]:
    source, _, bwd_query = _QUERIES[dtype]
    return bwd_plan(b, h, build.sm_count(torch.device("cuda", index)),
                    functools.partial(_blocks_per_sm, index, source,
                                      bwd_query))


_SEQ = ("lstm_seq_fwd_seq_f32", (_P,) * 9 + (_I,) * 6 + (_P,))
_STEPS = ("lstm_seq_fwd_f32", (_P,) * 8 + (_I,) * 3 + (_P,))
_BWD_SEQ = ("lstm_seq_bwd_seq_f32", (_P,) * 16 + (_I,) * 6 + (_P,))
_BWD_STEPS = ("lstm_seq_bwd_f32", (_P,) * 16 + (_I,) * 4 + (_P,))
_SEQ_BF16 = ("lstm_seq_fwd_seq_bf16", (_P,) * 9 + (_I,) * 6 + (_P,))
_BWD_SEQ_BF16 = ("lstm_seq_bwd_seq_bf16", (_P,) * 16 + (_I,) * 6 + (_P,))

_barriers: Dict[Tuple[int, int], torch.Tensor] = {}


def _barrier_of(device: torch.device, stream: int) -> int:
    """The sequence kernels' barrier counters for `stream`: two int32,
    zeroed once and set back to 0 by each launch. Calls on one stream
    (forward and backward alike) run in order and share them; calls on
    two streams never do."""
    key = (device.index, stream)
    buf = _barriers.get(key)
    if buf is None:
        buf = _barriers[key] = torch.zeros(2, dtype=torch.int32,
                                           device=device)
    return buf.data_ptr()


def lstm_seq_fwd(x, w, b, mask, r0, c0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, B, 4H], w [H, 4H], b [4H], mask [T, B], r0/c0 [B, H] ->
    carry sequences (rs, cs) [T, B, H].

    CPU tensors run ``lstm_seq_fwd_reference``. CUDA tensors run
    csrc/fused_lstm.cu: float32, contiguous (any offset), any T, B, H >=
    1. The shape alone chooses the kernel (``fwd_plan``): the sequence
    kernel, one cooperative launch, for H <= 512 and B up to 64 row tiles
    of 32 a block (on 132 SMs: B <= 4096 at H 512, B <= 16384 at H 128);
    else the step kernel, T launches. A cooperative launch the runtime
    refuses raises. bfloat16 CUDA tensors go to ``lstm_seq_fwd_bf16``,
    which counts the launch."""
    if not build.on_card("lstm_seq_fwd", x):
        return lstm_seq_fwd_reference(x, w, b, mask, r0, c0)
    if x.dtype == torch.bfloat16:
        return lstm_seq_fwd_bf16(x, w, b, mask, r0, c0)
    t, bb, h = _shapes(x)
    dev = x.device
    build.check("x", x, dev, (t, bb, 4 * h))
    build.check("w", w, dev, (h, 4 * h))
    build.check("b", b, dev, (4 * h,))
    build.check("mask", mask, dev, (t, bb))
    build.check("r0", r0, dev, (bb, h))
    build.check("c0", c0, dev, (bb, h))
    rs = torch.empty((t, bb, h), dtype=torch.float32, device=dev)
    cs = torch.empty_like(rs)
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), mask.data_ptr(),
            r0.data_ptr(), c0.data_ptr(), rs.data_ptr(), cs.data_ptr())
    with build.device_guard(dev):
        stream = build.stream(dev)
        plan = _plan_of(bb, h, dev.index)
        if plan is None:
            build.launch("lstm_seq_fwd", _fn(*_STEPS), *ptrs, t, bb, h,
                         stream)
        else:
            build.launch("lstm_seq_fwd", _fn(*_SEQ), *ptrs,
                         _barrier_of(dev, stream), t, bb, h, plan.mt,
                         plan.kb, plan.nt, stream)
    lstm_seq_fwd.launches += 1
    return rs, cs


lstm_seq_fwd.launches = 0


def lstm_seq_bwd(x, w, b, mask, r_prevs, c_prevs, drs, dcs):
    """The inputs mirror the forward's residuals: r_prevs / c_prevs are
    the carry sequences shifted by one (element t holds the carry of
    step t-1, r0 / c0 at t = 0), drs / dcs the cotangents of rs / cs.
    Returns (dx [T, B, 4H], dw [H, 4H], db [4H], dr0, dc0 [B, H]).

    CPU tensors run ``lstm_seq_bwd_reference``. CUDA tensors run
    csrc/fused_lstm.cu: float32, contiguous, any T, B, H >= 1; every sum
    in a fixed order, no atomics, so two calls give the same bits. The
    shape alone chooses the path (``bwd_plan``): the recurrence in one
    cooperative launch (3 launches a call) for H <= 512 and B up to 28 row
    tiles of 16 a block (on 132 SMs: B <= 1792 at H 512); else 2T + 4
    launches. A cooperative launch the runtime refuses raises. bfloat16
    CUDA tensors go to ``lstm_seq_bwd_bf16``, which counts the call."""
    if not build.on_card("lstm_seq_bwd", x):
        return lstm_seq_bwd_reference(x, w, b, mask, r_prevs, c_prevs, drs,
                                      dcs)
    if x.dtype == torch.bfloat16:
        return lstm_seq_bwd_bf16(x, w, b, mask, r_prevs, c_prevs, drs, dcs)
    t, bb, h = _shapes(x)
    dev = x.device
    build.check("x", x, dev, (t, bb, 4 * h))
    build.check("w", w, dev, (h, 4 * h))
    build.check("b", b, dev, (4 * h,))
    build.check("mask", mask, dev, (t, bb))
    for name, v in (("r_prevs", r_prevs), ("c_prevs", c_prevs),
                    ("drs", drs), ("dcs", dcs)):
        build.check(name, v, dev, (t, bb, h))
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((t, bb, 4 * h), **f32)
    dw = torch.empty((h, 4 * h), **f32)
    db = torch.empty((4 * h,), **f32)
    dr0 = torch.empty((bb, h), **f32)
    dc0 = torch.empty((bb, h), **f32)
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), mask.data_ptr(),
            r_prevs.data_ptr(), c_prevs.data_ptr(), drs.data_ptr(),
            dcs.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
            dr0.data_ptr(), dc0.data_ptr())
    with build.device_guard(dev):
        stream = build.stream(dev)
        plan = _bwd_plan_of(bb, h, dev.index)
        if plan is None:
            slices = _dr_slices(bb, h, build.sm_count(dev))
            gates = torch.empty_like(dx)
            part = torch.empty((slices, bb, h), **f32)
            drb = torch.empty((bb, h), **f32)
            build.launch("lstm_seq_bwd", _fn(*_BWD_STEPS), *ptrs,
                         gates.data_ptr(), part.data_ptr(), drb.data_ptr(),
                         t, bb, h, slices, stream)
        else:
            # one scratch: the gates [T, B, 4H], then db's partial sums
            # [row groups, 4H]
            n = t * bb * 4 * h
            scratch = torch.empty((n + plan.grid[1] * 4 * h,), **f32)
            build.launch("lstm_seq_bwd", _fn(*_BWD_SEQ), *ptrs,
                         scratch.data_ptr(), scratch.data_ptr() + 4 * n,
                         _barrier_of(dev, stream), t, bb, h, plan.mt,
                         plan.kb, plan.nt, stream)
    lstm_seq_bwd.launches += 1
    return dx, dw, db, dr0, dc0


lstm_seq_bwd.launches = 0


# ---------------------------------------------------------------------------
# the bfloat16 kernels (mixed-precision training)
# ---------------------------------------------------------------------------

def _check_bf16(what: str, dev: torch.device, named) -> None:
    """The bf16 kernels' contract: every input bfloat16, contiguous and
    16-byte aligned (their copies move 8 bf16 at a time)."""
    for name, v, shape in named:
        build.check(f"{what}: {name}", v, dev, shape, torch.bfloat16,
                    aligned=True)


def _bf16_plan(what: str, plan: Optional[SeqPlan], b: int, h: int
               ) -> SeqPlan:
    if plan is None:
        raise ValueError(
            f"{what}: no grid the card holds at once for B {b}, H {h}: the "
            "bfloat16 kernels take H <= 512 and B within fwd_plan / "
            "bwd_plan's row tiles a block; no other bfloat16 path exists")
    return plan


def _bf16_shapes(what: str, x: torch.Tensor) -> Tuple[int, int, int]:
    t, b, h = _shapes(x)
    if h % 8:
        raise ValueError(f"{what}: the bfloat16 kernels take H a multiple "
                         f"of 8 (rows of 16 bytes), got H {h}")
    return t, b, h


def lstm_seq_fwd_bf16(x, w, b, mask, r0, c0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bfloat16 forward: carry sequences (rs, cs) [T, B, H] bfloat16.

    CPU tensors run ``lstm_seq_fwd_reference``. CUDA tensors run
    csrc/fused_lstm_bf16.cu's sequence kernel, one cooperative launch:
    every input bfloat16, contiguous and 16-byte aligned, H a multiple of
    8 and at most 512, B up to 64 row tiles of 32 a block over the rows
    of blocks the card holds at once (``fwd_plan``). Any other shape
    raises, and so does a cooperative launch the runtime refuses."""
    if not build.on_card("lstm_seq_fwd_bf16", x):
        return lstm_seq_fwd_reference(x, w, b, mask, r0, c0)
    what = "lstm_seq_fwd_bf16"
    t, bb, h = _bf16_shapes(what, x)
    dev = x.device
    _check_bf16(what, dev, (("x", x, (t, bb, 4 * h)), ("w", w, (h, 4 * h)),
                            ("b", b, (4 * h,)), ("mask", mask, (t, bb)),
                            ("r0", r0, (bb, h)), ("c0", c0, (bb, h))))
    rs = torch.empty((t, bb, h), dtype=torch.bfloat16, device=dev)
    cs = torch.empty_like(rs)
    with build.device_guard(dev):
        stream = build.stream(dev)
        plan = _bf16_plan(what, _plan_of(bb, h, dev.index, torch.bfloat16),
                          bb, h)
        build.launch(what, _fn(*_SEQ_BF16, _BF16_SOURCE), x.data_ptr(),
                     w.data_ptr(), b.data_ptr(), mask.data_ptr(),
                     r0.data_ptr(), c0.data_ptr(), rs.data_ptr(),
                     cs.data_ptr(), _barrier_of(dev, stream), t, bb, h,
                     plan.mt, plan.kb, plan.nt, stream)
    lstm_seq_fwd_bf16.launches += 1
    return rs, cs


lstm_seq_fwd_bf16.launches = 0


def lstm_seq_bwd_bf16(x, w, b, mask, r_prevs, c_prevs, drs, dcs):
    """The bfloat16 backward: (dx [T, B, 4H] bfloat16, dw [H, 4H], db [4H],
    dr0, dc0 [B, H] float32), the inputs as ``lstm_seq_bwd``'s.

    CPU tensors run ``lstm_seq_bwd_reference``. CUDA tensors run
    csrc/fused_lstm_bf16.cu: the gates' recompute, the recurrence in one
    cooperative launch, dW (3 launches); every input bfloat16, contiguous
    and 16-byte aligned, H a multiple of 8 and at most 512, B up to 28
    row tiles of 16 a block over the rows of blocks the card holds at
    once (``bwd_plan``); every sum in a fixed order, no atomics, so two
    calls give the same bits. Any other shape raises, and so does a
    cooperative launch the runtime refuses."""
    if not build.on_card("lstm_seq_bwd_bf16", x):
        return lstm_seq_bwd_reference(x, w, b, mask, r_prevs, c_prevs, drs,
                                      dcs)
    what = "lstm_seq_bwd_bf16"
    t, bb, h = _bf16_shapes(what, x)
    dev = x.device
    seq = (t, bb, h)
    _check_bf16(what, dev, (("x", x, (t, bb, 4 * h)), ("w", w, (h, 4 * h)),
                            ("b", b, (4 * h,)), ("mask", mask, (t, bb)),
                            ("r_prevs", r_prevs, seq),
                            ("c_prevs", c_prevs, seq), ("drs", drs, seq),
                            ("dcs", dcs, seq)))
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((t, bb, 4 * h), dtype=torch.bfloat16, device=dev)
    dw = torch.empty((h, 4 * h), **f32)
    db = torch.empty((4 * h,), **f32)
    dr0 = torch.empty((bb, h), **f32)
    dc0 = torch.empty((bb, h), **f32)
    with build.device_guard(dev):
        stream = build.stream(dev)
        plan = _bf16_plan(what, _bwd_plan_of(bb, h, dev.index,
                                             torch.bfloat16), bb, h)
        # one scratch: the float32 gates [T, B, 4H], then db's partial
        # sums [row groups, 4H]
        n = t * bb * 4 * h
        scratch = torch.empty((n + plan.grid[1] * 4 * h,), **f32)
        build.launch(what, _fn(*_BWD_SEQ_BF16, _BF16_SOURCE), x.data_ptr(),
                     w.data_ptr(), b.data_ptr(), mask.data_ptr(),
                     r_prevs.data_ptr(), c_prevs.data_ptr(), drs.data_ptr(),
                     dcs.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                     db.data_ptr(), dr0.data_ptr(), dc0.data_ptr(),
                     scratch.data_ptr(), scratch.data_ptr() + 4 * n,
                     _barrier_of(dev, stream), t, bb, h, plan.mt, plan.kb,
                     plan.nt, stream)
    lstm_seq_bwd_bf16.launches += 1
    return dx, dw, db, dr0, dc0


lstm_seq_bwd_bf16.launches = 0


# ---------------------------------------------------------------------------
# the differentiable sequence (fused_lstm.py :255-280)
# ---------------------------------------------------------------------------

class LSTMSequence(torch.autograd.Function):
    """(rs, cs) = the carry sequences of the whole-sequence LSTM, through
    ``lstm_seq_fwd``; the backward runs ``lstm_seq_bwd`` from the saved
    carries."""

    @staticmethod
    def forward(ctx, x, w, b, mask, r0, c0):
        rs, cs = lstm_seq_fwd(x, w, b, mask, r0, c0)
        ctx.save_for_backward(x, w, b, mask, r0, c0, rs, cs)
        return rs, cs

    @staticmethod
    def backward(ctx, drs, dcs):
        x, w, b, mask, r0, c0, rs, cs = ctx.saved_tensors
        r_prevs = torch.cat([r0[None], rs[:-1]], dim=0)
        c_prevs = torch.cat([c0[None], cs[:-1]], dim=0)
        dx, dw, db, dr0, dc0 = lstm_seq_bwd(
            x, w, b, mask, r_prevs, c_prevs, drs.contiguous(),
            dcs.contiguous())
        return (dx, dw.to(w.dtype), db.to(b.dtype), torch.zeros_like(mask),
                dr0.to(r0.dtype), dc0.to(c0.dtype))


def lstm_sequence(x, w, b, mask, r0, c0):
    """Differentiable fused whole-sequence LSTM: (rs, cs) [T, B, H]."""
    return LSTMSequence.apply(x, w, b, mask, r0, c0)
