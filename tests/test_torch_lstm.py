"""The port's LSTM (kernels/fused_lstm.py, ops/rnn_ops.py) against the
JAX package on the CPU.

* The kernels' plain versions against the JAX package's Pallas kernels
  run by the Pallas interpreter (``paddle_tpu.kernels.fused_lstm
  .INTERPRET``, patched for the test): ``lstm_seq_fwd_reference``
  against ``lstm_seq_fwd``, ``lstm_seq_bwd_reference`` against
  ``lstm_seq_bwd``.
* ``LSTMSequence``'s gradients against ``jax.grad`` of the interpreted
  ``lstm_sequence``, under one weighted loss over both outputs.
* The ops ``dynamic_lstm`` (peepholes off and on, is_reverse, H0/C0; in
  the kernel's contract through ``LSTMSequence`` and through the scan),
  ``lstmp`` and ``dynamic_gru`` against the JAX ops (its scan), outputs
  and the gradients of every input.

Inputs come from a numpy seed at small sizes (T 5-9, B 3-8, H 16-128),
with ragged lengths that include 1 and T, trailing steps that no
sequence reaches (the padding to a multiple of 8), and initial states
that are not zero. Tolerance: float32 on both sides, sums in another
order over at most 9 steps: atol = rtol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import fused_lstm as jfl
from paddle_tpu.ops import rnn_ops as jrnn

from paddle_tpu_torch.core.registry import ExecContext
from paddle_tpu_torch.kernels import fused_lstm as tfl
from paddle_tpu_torch.ops import rnn_ops as trnn

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)

# (T, B, H, lengths or None for full, initial state not zero)
CASES = [
    (5, 4, 16, None, False),
    (7, 8, 32, [7, 1, 3, 7, 5, 2, 6, 4], True),
    (9, 4, 128, [9, 1, 4, 6], True),
    (8, 3, 24, [1, 5, 3], True),   # steps 5..7 reach no sequence
]


def _mask(lens, t, b):
    lens = np.full(b, t) if lens is None else np.asarray(lens)
    return (np.arange(t)[:, None] < lens[None, :]).astype(np.float32)


def _case(t, b, h, lens, state, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    d = dict(x=rng.standard_normal((t, b, 4 * h)).astype(f),
             w=(rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(f),
             b=(0.1 * rng.standard_normal(4 * h)).astype(f),
             mask=_mask(lens, t, b),
             r0=np.zeros((b, h), f), c0=np.zeros((b, h), f),
             drs=rng.standard_normal((t, b, h)).astype(f),
             dcs=rng.standard_normal((t, b, h)).astype(f))
    if state:
        d["r0"] = (0.5 * rng.standard_normal((b, h))).astype(f)
        d["c0"] = rng.standard_normal((b, h)).astype(f)
    return d


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfl, "INTERPRET", True)


def _t(d, *keys):
    return [torch.from_numpy(d[k]) for k in keys]


def _j(d, *keys):
    return [jnp.asarray(d[k]) for k in keys]


FWD_KEYS = ("x", "w", "b", "mask", "r0", "c0")


@pytest.mark.parametrize("t,b,h,lens,state", CASES)
def test_forward_plain_matches_pallas(interpret, t, b, h, lens, state):
    d = _case(t, b, h, lens, state)
    want = jfl.lstm_seq_fwd(*_j(d, *FWD_KEYS))
    got = tfl.lstm_seq_fwd(*_t(d, *FWD_KEYS))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _prevs(d):
    rs, cs = (np.asarray(v) for v in
              tfl.lstm_seq_fwd_reference(*_t(d, *FWD_KEYS)))
    return (np.concatenate([d["r0"][None], rs[:-1]]),
            np.concatenate([d["c0"][None], cs[:-1]]))


@pytest.mark.parametrize("t,b,h,lens,state", CASES)
def test_backward_plain_matches_pallas(interpret, t, b, h, lens, state):
    d = _case(t, b, h, lens, state, seed=1)
    d["rp"], d["cp"] = _prevs(d)
    keys = ("x", "w", "b", "mask", "rp", "cp", "drs", "dcs")
    want = jfl.lstm_seq_bwd(*_j(d, *keys))
    got = tfl.lstm_seq_bwd(*_t(d, *keys))
    names = ("dx", "dw", "db", "dr0", "dc0")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def test_a_step_no_sequence_reaches_carries_the_state_and_its_gradient():
    """Steps past every length leave (r, c) as they were, and their
    cotangents flow through to the step before unchanged."""
    d = _case(6, 2, 8, [3, 2], True, seed=2)
    rs, cs = tfl.lstm_seq_fwd(*_t(d, *FWD_KEYS))
    for t in range(3, 6):
        assert torch.equal(rs[t], rs[2]) and torch.equal(cs[t], cs[2])
    d["rp"], d["cp"] = _prevs(d)
    dx, *_ = tfl.lstm_seq_bwd(*_t(d, "x", "w", "b", "mask", "rp", "cp",
                                  "drs", "dcs"))
    assert bool((dx[3:] == 0).all())


def test_wrappers_on_the_cpu_count_no_launch():
    d = _case(3, 2, 4, None, False)
    before = (tfl.lstm_seq_fwd.launches, tfl.lstm_seq_bwd.launches)
    x = torch.from_numpy(d["x"]).requires_grad_(True)
    rs, cs = tfl.lstm_sequence(x, *_t(d, "w", "b", "mask", "r0", "c0"))
    (rs.sum() + cs.sum()).backward()
    assert (tfl.lstm_seq_fwd.launches, tfl.lstm_seq_bwd.launches) == before


def test_wrappers_refuse_a_device_without_a_kernel():
    x = torch.zeros(2, 1, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfl.lstm_seq_fwd(x, x, x, x, x, x)
    with pytest.raises(ValueError, match="no kernel"):
        tfl.lstm_seq_bwd(x, x, x, x, x, x, x, x)


GW = (1.0, 0.7)   # weights of rs and cs in the loss


@pytest.mark.parametrize("t,b,h,lens,state", CASES)
def test_autograd_function_matches_jax_grad(interpret, t, b, h, lens, state):
    d = _case(t, b, h, lens, state, seed=3)
    g_rs, g_cs = d["drs"], d["dcs"]

    def loss(x, w, bias, r0, c0):
        rs, cs = jfl.lstm_sequence(x, w, bias, jnp.asarray(d["mask"]), r0,
                                   c0)
        return GW[0] * jnp.sum(rs * g_rs) + GW[1] * jnp.sum(cs * g_cs)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *_j(d, "x", "w", "b", "r0", "c0"))
    leaves = [v.requires_grad_(True) for v in _t(d, "x", "w", "b", "r0",
                                                 "c0")]
    x, w, bias, r0, c0 = leaves
    rs, cs = tfl.lstm_sequence(x, w, bias, torch.from_numpy(d["mask"]), r0,
                               c0)
    (GW[0] * (rs * torch.from_numpy(g_rs)).sum()
     + GW[1] * (cs * torch.from_numpy(g_cs)).sum()).backward()
    for name, leaf, wv in zip(("x", "w", "b", "r0", "c0"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(wv), **TOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

B, T, H, P = 4, 7, 16, 8
LENS = np.array([7, 1, 4, 6], np.int32)


def _op_inputs(kind, peep, h0, seed):
    """numpy inputs of one op: Input [B, T, gH], Weight, Bias, SeqLen
    (+ ProjWeight, H0, C0)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    gates = 3 if kind == "gru" else 4
    rec = P if kind == "lstmp" else H
    ins = {"Input": rng.standard_normal((B, T, gates * H)).astype(f),
           "Weight": (rng.standard_normal((rec, gates * H))
                      / np.sqrt(rec)).astype(f),
           "Bias": (0.1 * rng.standard_normal(
               (1, gates * H + (3 * H if peep else 0)))).astype(f),
           "SeqLen": LENS}
    if kind == "lstmp":
        ins["ProjWeight"] = (rng.standard_normal((H, P))
                             / np.sqrt(H)).astype(f)
    if h0:
        ins["H0"] = (0.5 * rng.standard_normal((B, H))).astype(f)
        if kind != "gru":
            ins["C0"] = rng.standard_normal((B, H)).astype(f)
    return ins


def _compare_op(jop, top, ins, attrs, out_slots, ctx=None):
    """Outputs and the gradients of every float input under a weighted
    loss over the outputs, JAX vs the port."""
    rng = np.random.default_rng(99)
    diff = [k for k, v in ins.items() if v.dtype == np.float32]
    jouts = jop(None, {k: [jnp.asarray(v)] for k, v in ins.items()}, attrs)
    weights = {s: rng.standard_normal(np.asarray(jouts[s][0]).shape)
               .astype(np.float32) for s in out_slots}

    def jloss(*vals):
        ji = {k: [jnp.asarray(v)] for k, v in ins.items()}
        ji.update({k: [v] for k, v in zip(diff, vals)})
        outs = jop(None, ji, attrs)
        return sum(jnp.sum(outs[s][0] * weights[s]) for s in out_slots)

    jgrads = jax.grad(jloss, argnums=tuple(range(len(diff))))(
        *(jnp.asarray(ins[k]) for k in diff))
    tins = {k: [torch.from_numpy(v)] for k, v in ins.items()}
    for k in diff:
        tins[k][0].requires_grad_(True)
    touts = top(ctx, tins, attrs)
    sum((touts[s][0] * torch.from_numpy(weights[s])).sum()
        for s in out_slots).backward()
    for s in out_slots:
        np.testing.assert_allclose(touts[s][0].detach().numpy(),
                                   np.asarray(jouts[s][0]), **TOL,
                                   err_msg=s)
    for k, g in zip(diff, jgrads):
        np.testing.assert_allclose(tins[k][0].grad.numpy(), np.asarray(g),
                                   **TOL, err_msg=f"d{k}")


def _fused_ctx():
    return ExecContext(torch.Generator(), torch.device("cpu"))


@pytest.mark.parametrize("peep,reverse,h0,fused", [
    (False, False, False, True), (False, True, True, True),
    (False, False, False, False), (False, True, True, False),
    (True, False, True, False), (True, True, False, False),
])
def test_dynamic_lstm_matches_jax(peep, reverse, h0, fused, monkeypatch):
    """fused: through LSTMSequence (the kernel's contract and a context,
    as the Executor runs it); else the scan (ctx None or peepholes)."""
    before = (tfl.lstm_seq_fwd.launches, tfl.lstm_seq_bwd.launches)
    calls = []
    real = tfl.LSTMSequence.apply
    monkeypatch.setattr(tfl.LSTMSequence, "apply",
                        lambda *a: calls.append(1) or real(*a))
    ins = _op_inputs("lstm", peep, h0, seed=10 + 2 * peep + reverse)
    attrs = {"use_peepholes": peep, "is_reverse": reverse}
    _compare_op(jrnn.dynamic_lstm, trnn.dynamic_lstm, ins, attrs,
                ("Hidden", "Cell"), ctx=_fused_ctx() if fused else None)
    assert len(calls) == int(fused)
    assert (tfl.lstm_seq_fwd.launches, tfl.lstm_seq_bwd.launches) == before


def test_fused_lstm_never_takes_the_scan(monkeypatch):
    monkeypatch.setenv("PT_FUSED_LSTM", "never")
    monkeypatch.setattr(tfl.LSTMSequence, "apply", None)
    ins = _op_inputs("lstm", False, True, seed=20)
    _compare_op(jrnn.dynamic_lstm, trnn.dynamic_lstm, ins, {},
                ("Hidden", "Cell"), ctx=_fused_ctx())


@pytest.mark.parametrize("attrs", [
    {"gate_activation": "relu"}, {"cell_activation": "identity"},
    {"candidate_activation": "sigmoid"}])
def test_other_activations_take_the_scan(attrs, monkeypatch):
    monkeypatch.setattr(tfl.LSTMSequence, "apply", None)
    ins = _op_inputs("lstm", False, False, seed=21)
    _compare_op(jrnn.dynamic_lstm, trnn.dynamic_lstm, ins,
                dict(attrs, use_peepholes=False), ("Hidden", "Cell"),
                ctx=_fused_ctx())


@pytest.mark.parametrize("peep,h0", [(False, True), (True, False)])
def test_lstmp_matches_jax(peep, h0):
    ins = _op_inputs("lstmp", peep, h0, seed=30 + peep)
    _compare_op(jrnn.lstmp, trnn.lstmp, ins,
                {"use_peepholes": peep, "proj_activation": "tanh"},
                ("Projection", "Cell"), ctx=_fused_ctx())


@pytest.mark.parametrize("reverse,h0", [(False, True), (True, False)])
def test_dynamic_gru_matches_jax(reverse, h0):
    ins = _op_inputs("gru", False, h0, seed=40 + reverse)
    _compare_op(jrnn.dynamic_gru, trnn.dynamic_gru, ins,
                {"is_reverse": reverse}, ("Hidden",))
