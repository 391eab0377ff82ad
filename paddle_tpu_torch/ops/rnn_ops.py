"""Recurrent ops: the fused LSTM (``dynamic_lstm``), LSTM with a recurrent
projection (``lstmp``) and the GRU (``dynamic_gru``).

Counterpart of ``paddle_tpu/ops/rnn_ops.py``. Inputs are padded
[B, T, ...] with a lengths vector; the recurrence runs time-major with
length masking: rows past a sequence's length hold their last state,
and the stacked outputs are zero there.

``dynamic_lstm`` in the kernel's contract (no peepholes, no projection,
sigmoid/tanh/tanh, no mesh) runs the whole sequence through
``kernels.fused_lstm.LSTMSequence``: on the card the hand-written
forward and backward kernels, on the CPU their plain versions. Under
bfloat16 mixed precision its inputs (x, the recurrent weight, the gate
bias, the length mask and the initial state) arrive in bfloat16, as the
JAX package's do, so the card runs the bf16 kernels and the masked
outputs are bfloat16; the scan runs in bfloat16 too.
Everything else (peepholes, ``lstmp``, other activations, the GRU, or
``PT_FUSED_LSTM=never``) runs the scan in PyTorch ops, step by step:
that is what the JAX package runs for them too (its ``lax.scan``; no
kernel). ``dynamic_rnn``, the sub-block scanner, is not ported.
"""

from __future__ import annotations

import os

import torch

from ..core.registry import register_op
from ..kernels import fused_lstm
from .sequence_ops import time_mask

__all__ = ["dynamic_lstm", "lstmp", "dynamic_gru"]

_ACT = {
    "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "relu": lambda x: torch.clamp_min(x, 0), "identity": lambda x: x,
    None: torch.tanh,
}


def _kernel_contract(attrs, use_peep: bool, w_proj) -> bool:
    """The whole-sequence kernel's contract: the JAX package's
    ``_pallas_lstm_ok`` without its TPU tiling rule and backend test.
    PT_FUSED_LSTM=never (or 0) takes the scan."""
    if os.environ.get("PT_FUSED_LSTM", "auto") in ("0", "never"):
        return False
    if use_peep or w_proj is not None:
        return False
    return (attrs.get("gate_activation", "sigmoid") == "sigmoid"
            and attrs.get("cell_activation", "tanh") == "tanh"
            and attrs.get("candidate_activation", "tanh") == "tanh")


def _fused_lstm_ok(ctx, attrs, use_peep: bool, w_proj) -> bool:
    return (_kernel_contract(attrs, use_peep, w_proj) and ctx is not None
            and getattr(ctx, "mesh", None) is None)


def _lstm_scan(ins, attrs, w_proj=None, pact=None, ctx=None):
    """The shared LSTM recurrence (lstm_op.cc / lstmp_op.h). The carry is
    (recurrent state, cell): the hidden h [B, H] for plain LSTM, the
    projection r = pact(h @ w_proj) [B, P] for LSTMP. Gate layout i, c,
    f, o. Returns the masked (r, c) sequences [B, T, *]."""
    x = ins["Input"][0]
    w = ins["Weight"][0].to(x.dtype)
    seq_len = ins["SeqLen"][0]
    b_, t_, h4 = x.shape
    h = h4 // 4
    r_width = h if w_proj is None else w_proj.shape[1]
    use_peep = attrs.get("use_peepholes", False)
    bias = ins["Bias"][0].to(x.dtype).reshape(-1) if ins.get("Bias") else None
    b_gate = bias[:4 * h] if bias is not None else None
    b_peep = bias[4 * h:] if bias is not None and use_peep else None
    gact = _ACT[attrs.get("gate_activation", "sigmoid")]
    cact = _ACT[attrs.get("cell_activation", "tanh")]
    hact = _ACT[attrs.get("candidate_activation", "tanh")]
    reverse = attrs.get("is_reverse", False)

    xs = x.transpose(0, 1)                                    # [T, B, 4H]
    mask = time_mask(seq_len, t_, x.dtype).transpose(0, 1)   # [T, B]
    if reverse:
        xs, mask = torch.flip(xs, (0,)), torch.flip(mask, (0,))
    if ins.get("H0"):
        r0 = ins["H0"][0].to(x.dtype)       # [B, H] (the reference's)
        if w_proj is not None:
            # lstmp_op.h:174-183: project the initial hidden state
            r0 = pact(r0 @ w_proj)
    else:
        r0 = torch.zeros((b_, r_width), dtype=x.dtype, device=x.device)
    c0 = (ins["C0"][0].to(x.dtype) if ins.get("C0")
          else torch.zeros((b_, h), dtype=x.dtype, device=x.device))

    if _fused_lstm_ok(ctx, attrs, use_peep, w_proj):
        bz = b_gate if b_gate is not None else torch.zeros(
            4 * h, dtype=x.dtype, device=x.device)
        rs_c, cs_c = fused_lstm.lstm_sequence(
            xs.contiguous(), w.contiguous(), bz.contiguous(),
            mask.contiguous(), r0.contiguous(), c0.contiguous())
        # the op's outputs are the masked values; the kernel gives the
        # carries (its backward needs them)
        m3 = mask[:, :, None]
        rs, cs = rs_c * m3, cs_c * m3
    else:
        if use_peep:
            wic, wfc, woc = b_peep.split(h)
        r, c = r0, c0
        rs_l, cs_l = [], []
        for t in range(t_):
            gates = xs[t] + r @ w
            if b_gate is not None:
                gates = gates + b_gate
            gi, gc, gf, go = gates.split(h, dim=-1)
            if use_peep:
                gi = gi + wic * c
                gf = gf + wfc * c
            i = gact(gi)
            f = gact(gf)
            cand = cact(gc)
            c_new = f * c + i * cand
            if use_peep:
                go = go + woc * c_new
            o = gact(go)
            r_new = o * hact(c_new)
            if w_proj is not None:
                r_new = pact(r_new @ w_proj)
            m1 = mask[t][:, None]
            r = m1 * r_new + (1 - m1) * r
            c = m1 * c_new + (1 - m1) * c
            rs_l.append(r * m1)
            cs_l.append(c * m1)
        rs, cs = torch.stack(rs_l), torch.stack(cs_l)
    if reverse:
        rs, cs = torch.flip(rs, (0,)), torch.flip(cs, (0,))
    return rs.transpose(0, 1), cs.transpose(0, 1)


@register_op("dynamic_lstm")
def dynamic_lstm(ctx, ins, attrs):
    """lstm_op.cc. Input [B, T, 4H] (pre-projected x W_x), Weight [H, 4H]
    recurrent, Bias [1, 4H] (+ [1, 3H] peephole tail with
    use_peepholes). Outputs Hidden / Cell [B, T, H]."""
    hs, cs = _lstm_scan(ins, attrs, ctx=ctx)
    return {"Hidden": [hs], "Cell": [cs]}


@register_op("lstmp")
def lstmp(ctx, ins, attrs):
    """lstmp_op.cc / .h: LSTM with a recurrent projection layer. Input
    [B, T, 4H] pre-projected; the recurrent Weight [P, 4H] acts on the
    projected state r; ProjWeight [H, P] maps the cell output h to r =
    proj_act(h @ ProjWeight). H0 is a hidden state [B, H], projected
    before the first step. Outputs Projection [B, T, P], Cell [B, T, H]."""
    x = ins["Input"][0]
    w_proj = ins["ProjWeight"][0].to(x.dtype)
    pact = _ACT[attrs.get("proj_activation", "tanh")]
    rs, cs = _lstm_scan(ins, attrs, w_proj=w_proj, pact=pact)
    return {"Projection": [rs], "Cell": [cs]}


@register_op("dynamic_gru")
def dynamic_gru(ctx, ins, attrs):
    """gru_op.cc. Input [B, T, 3H] pre-projected, Weight [H, 3H] laid out
    [update u | reset r | candidate c] as gru_compute. Output [B, T, H]."""
    x = ins["Input"][0]
    w = ins["Weight"][0].to(x.dtype)
    seq_len = ins["SeqLen"][0]
    b_, t_, h3 = x.shape
    h = h3 // 3
    bias = (ins["Bias"][0].to(x.dtype).reshape(-1) if ins.get("Bias")
            else None)
    gact = _ACT[attrs.get("gate_activation", "sigmoid")]
    cact = _ACT[attrs.get("activation", "tanh")]
    reverse = attrs.get("is_reverse", False)
    w_ur, w_c = w[:, :2 * h], w[:, 2 * h:]

    xs = x.transpose(0, 1)
    mask = time_mask(seq_len, t_, x.dtype).transpose(0, 1)
    if reverse:
        xs, mask = torch.flip(xs, (0,)), torch.flip(mask, (0,))
    hid = (ins["H0"][0].to(x.dtype) if ins.get("H0")
           else torch.zeros((b_, h), dtype=x.dtype, device=x.device))
    hs = []
    for t in range(t_):
        xt = xs[t]
        gur = xt[:, :2 * h] + hid @ w_ur
        if bias is not None:
            gur = gur + bias[:2 * h]
        u, r = gact(gur).split(h, dim=-1)
        gc = xt[:, 2 * h:] + (r * hid) @ w_c
        if bias is not None:
            gc = gc + bias[2 * h:]
        cand = cact(gc)
        # gru_kernel.h:62: out = (1 - u) prev + u cand
        h_new = u * cand + (1.0 - u) * hid
        m1 = mask[t][:, None]
        hid = m1 * h_new + (1 - m1) * hid
        hs.append(hid * m1)
    out = torch.stack(hs)
    if reverse:
        out = torch.flip(out, (0,))
    return {"Hidden": [out.transpose(0, 1)]}
