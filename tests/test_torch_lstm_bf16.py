"""The bfloat16 LSTM (kernels/fused_lstm.py's bf16 plain versions, the
arithmetic of csrc/fused_lstm_bf16.cu, and the stacked LSTM under bf16
mixed precision) against the JAX package on the CPU.

* (a) ``lstm_seq_fwd_reference`` / ``lstm_seq_bwd_reference`` on bf16
  inputs against the JAX package's Pallas kernels run by the Pallas
  interpreter on the same bf16 inputs (``paddle_tpu.kernels.fused_lstm
  .INTERPRET``, patched for the test): the output dtypes exactly (bf16
  rs, cs and dx; float32 dw, db, dr0 and dc0), the values within the
  limits below.
* (b) ``LSTMSequence``'s bf16 gradients against ``jax.grad`` of the
  interpreted ``lstm_sequence`` under one weighted loss over both
  outputs (dw, db, dr0 and dc0 reach the bf16 inputs rounded to bf16, as
  the JAX package's custom VJP casts them).
* (c) the CUDA kernels' arithmetic, emulated in float32 PyTorch
  (``scripts/lstm_bf16_arith.py``: their summation order and rounding
  points), against the plain versions within half of the limits.
* (d) the stacked LSTM (``stacked_dynamic_lstm.get_model(use_fused=True)``,
  vocab 100, embedding 32, hidden 128, batch 8, ragged sequences up to 8)
  with ``amp_dtype = "bfloat16"`` and Adam, port against JAX, the JAX
  startup state carried into the port. On the CPU the JAX op takes its
  ``lax.scan`` (``_pallas_lstm_ok`` asks for a TPU), which rounds at
  other places than the Pallas kernel, so the test patches
  ``paddle_tpu.ops.rnn_ops._pallas_lstm_ok`` to drop its backend test
  (its shape rules stay) and sets ``INTERPRET``: like against like.

Limits (bf16's unit roundoff is 2^-8): rs, cs and dx within 2^-7
max|ref| + 2^-7 |ref| (BF16_REL: the two sides sum the float32 products
in other orders, so a carry or a dgates element can round to the
neighbouring bf16 value, and that travels through later steps), the
float32 sums dw, db, dr0 and dc0 within 2^-9 max|ref| + 2^-9 |ref|
(SUM_REL); (b)'s bf16 gradients within BF16_REL. The AMP program: every
fetched var's dtype exactly, the loss within AMP_LOSS_RTOL, each
float32 gradient within AMP_GRAD_RTOL as rms of the difference over rms
of the JAX one (of the JAX package's AMP gradient and of its float32
gradient), as tests/test_torch_amp.py holds the LM; after two AMP Adam
steps every master within AMP_STEP_ATOL (5 lr) of the JAX package's and
each parameter's update within AMP_UPDATE_RTOL (rms), as chip_smoke.py
holds the card to the CPU. The gradients are held at the startup state
and at PRETRAIN float32 Adam steps of the JAX package past it: at the
startup state the biases' gradients cancel (p - y over a balanced batch
of two classes) below bf16's resolution of their terms in both packages:
there the JAX package's own AMP gradient of every bias is further than
AMP_GRAD_RTOL from its float32 gradient (the test holds that too), so
only the weights' gradients are held; PRETRAIN steps later every
gradient is.
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core import program as jprog
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import stacked_dynamic_lstm as jsdl

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.kernels import fused_lstm as tfl
from paddle_tpu_torch.models import stacked_dynamic_lstm as tsdl

jfl = importlib.import_module("paddle_tpu.kernels.fused_lstm")
jrnn = importlib.import_module("paddle_tpu.ops.rnn_ops")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import lstm_bf16_arith as arith  # noqa: E402

torch.set_num_threads(2)

BF16_REL, SUM_REL = 2.0 ** -7, 2.0 ** -9
AMP_LOSS_RTOL, AMP_GRAD_RTOL = 1e-2, 5e-2
LR = 1e-3                       # get_model's Adam
AMP_STEP_ATOL, AMP_UPDATE_RTOL = 5 * LR, 0.25
PRETRAIN = 20
BF16 = ml_dtypes.bfloat16

# (T, B, H, lengths or None for full, initial state not zero)
CASES = [
    (6, 8, 128, [6, 1, 3, 6, 5, 2, 6, 4], True),
    (5, 4, 16, None, False),
    (9, 4, 128, [9, 1, 4, 6], True),
    (8, 3, 24, [1, 5, 3], True),   # steps 5..7 reach no sequence
]


def _case(t, b, h, lens, state, seed=0):
    """Inputs from a numpy seed, rounded to bf16 (numpy arrays of
    ml_dtypes.bfloat16)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    lens = np.full(b, t) if lens is None else np.asarray(lens)
    d = dict(x=rng.standard_normal((t, b, 4 * h)).astype(f),
             w=(rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(f),
             b=(0.1 * rng.standard_normal(4 * h)).astype(f),
             mask=(np.arange(t)[:, None] < lens[None, :]).astype(f),
             r0=np.zeros((b, h), f), c0=np.zeros((b, h), f),
             drs=rng.standard_normal((t, b, h)).astype(f),
             dcs=rng.standard_normal((t, b, h)).astype(f))
    if state:
        d["r0"] = (0.5 * rng.standard_normal((b, h))).astype(f)
        d["c0"] = rng.standard_normal((b, h)).astype(f)
    return {k: v.astype(BF16) for k, v in d.items()}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfl, "INTERPRET", True)


def _t(d, *keys):
    return [torch.from_numpy(d[k].astype(np.float32)).bfloat16()
            for k in keys]


def _j(d, *keys):
    return [jnp.asarray(d[k]) for k in keys]


def _share(got, want, rel) -> float:
    """Largest |got - want| over rel max|want| + rel |want|."""
    got = np.asarray(torch.as_tensor(got).float() if torch.is_tensor(got)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    lim = rel * np.abs(want).max() + rel * np.abs(want)
    return float((np.abs(got - want) / lim).max())


def _np(x) -> np.ndarray:
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def _dtype(x) -> str:
    return str(x.dtype).rsplit(".", 1)[-1]


FWD_KEYS = ("x", "w", "b", "mask", "r0", "c0")
BWD_KEYS = ("x", "w", "b", "mask", "rp", "cp", "drs", "dcs")


def _prevs(d):
    rs, cs = (v.float().numpy() for v in
              tfl.lstm_seq_fwd_reference(*_t(d, *FWD_KEYS)))
    d["rp"] = np.concatenate([d["r0"].astype(np.float32)[None], rs[:-1]]
                             ).astype(BF16)
    d["cp"] = np.concatenate([d["c0"].astype(np.float32)[None], cs[:-1]]
                             ).astype(BF16)
    return d


@pytest.mark.parametrize("t,b,h,lens,state", CASES)
def test_bf16_forward_plain_matches_pallas(interpret, t, b, h, lens, state):
    d = _case(t, b, h, lens, state)
    want = jfl.lstm_seq_fwd(*_j(d, *FWD_KEYS))
    got = tfl.lstm_seq_fwd(*_t(d, *FWD_KEYS))
    for name, g, w in zip(("rs", "cs"), got, want):
        assert _dtype(g) == _dtype(w) == "bfloat16", name
        assert _share(g, _np(w), BF16_REL) <= 1, name


@pytest.mark.parametrize("t,b,h,lens,state", CASES)
def test_bf16_backward_plain_matches_pallas(interpret, t, b, h, lens, state):
    d = _prevs(_case(t, b, h, lens, state, seed=1))
    want = jfl.lstm_seq_bwd(*_j(d, *BWD_KEYS))
    got = tfl.lstm_seq_bwd(*_t(d, *BWD_KEYS))
    names = ("dx", "dw", "db", "dr0", "dc0")
    assert [_dtype(g) for g in got] == [_dtype(w) for w in want] == [
        "bfloat16"] + ["float32"] * 4
    for name, g, w in zip(names, got, want):
        rel = BF16_REL if name == "dx" else SUM_REL
        assert _share(g, _np(w), rel) <= 1, name


@pytest.mark.parametrize("t,b,h,lens,state", CASES[:3])
def test_bf16_autograd_function_matches_jax_grad(interpret, t, b, h, lens,
                                                 state):
    """One loss over both outputs, weighted by the cotangents: the
    gradients of x, w, b, r0 and c0 (bf16, as JAX's) within BF16_REL."""
    d = _case(t, b, h, lens, state, seed=2)
    wr, wc = (jnp.asarray(d[k]) for k in ("drs", "dcs"))

    def jloss(x, w, b, r0, c0):
        rs, cs = jfl.lstm_sequence(x, w, b, jnp.asarray(d["mask"]), r0, c0)
        return (jnp.sum(rs.astype(jnp.float32) * wr.astype(jnp.float32))
                + jnp.sum(cs.astype(jnp.float32) * wc.astype(jnp.float32)))

    keys = ("x", "w", "b", "r0", "c0")
    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*_j(d, *keys))
    x, w, bias, r0, c0 = (v.requires_grad_(True) for v in _t(d, *keys))
    mask, drs, dcs = _t(d, "mask", "drs", "dcs")
    rs, cs = tfl.lstm_sequence(x, w, bias, mask, r0, c0)
    ((rs.float() * drs.float()).sum()
     + (cs.float() * dcs.float()).sum()).backward()
    for name, g, wnt in zip(keys, (x.grad, w.grad, bias.grad, r0.grad,
                                   c0.grad), want):
        assert _dtype(g) == _dtype(wnt) == "bfloat16", name
        assert _share(g, _np(wnt), BF16_REL) <= 1, name


@pytest.mark.parametrize("t,b,h,ragged", [
    (6, 8, 128, True), (12, 40, 64, True),   # 40: three row groups
    (5, 3, 16, False), (9, 17, 136, True),
])
def test_kernels_arithmetic_emulated_holds_the_plain_versions(t, b, h,
                                                              ragged):
    """scripts/lstm_bf16_arith.py's emulation of the kernels' summation
    order and rounding points within half of the limits of the plain
    versions, forward and backward, on chip_smoke.py's kind of inputs."""
    lens = None
    if ragged:
        lens = np.random.default_rng(t + b).integers(1, t + 1, b)
        lens[:2] = (1, t)
        lens = lens.tolist()
    d = arith.bench_inputs(t, b, h, lens, 12)
    fwd = [d[k] for k in FWD_KEYS]
    want = tfl.lstm_seq_fwd_reference(*fwd)
    got = arith.fwd_emulated(*fwd)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert arith.share(g, w) <= 0.5
    bwd = fwd[:4] + [torch.cat([d["r0"][None], want[0][:-1]]),
                     torch.cat([d["c0"][None], want[1][:-1]]), d["drs"],
                     d["dcs"]]
    bwant = tfl.lstm_seq_bwd_reference(*bwd)
    bgot = arith.bwd_emulated(*bwd)
    assert bgot[0].dtype == torch.bfloat16
    assert arith.share(bgot[0], bwant[0]) <= 0.5
    for g, w in zip(bgot[1:], bwant[1:]):
        assert _share(g, w.numpy(), SUM_REL) <= 0.5


def test_bf16_wrappers_on_the_cpu_keep_bf16_and_count_no_launch():
    d = _case(3, 2, 16, None, True, seed=3)
    names = ("lstm_seq_fwd", "lstm_seq_bwd", "lstm_seq_fwd_bf16",
             "lstm_seq_bwd_bf16")
    before = [getattr(tfl, n).launches for n in names]
    x = _t(d, "x")[0].requires_grad_(True)
    rs, cs = tfl.lstm_sequence(x, *_t(d, "w", "b", "mask", "r0", "c0"))
    assert rs.dtype == cs.dtype == torch.bfloat16
    (rs.float().sum() + cs.float().sum()).backward()
    assert x.grad.dtype == torch.bfloat16
    for run in (tfl.lstm_seq_fwd_bf16, tfl.lstm_seq_fwd):
        out = run(*_t(d, *FWD_KEYS))
        assert [o.dtype for o in out] == [torch.bfloat16] * 2
    assert [getattr(tfl, n).launches for n in names] == before


def test_bf16_wrappers_refuse_a_device_without_a_kernel():
    x = torch.zeros(2, 1, 32, device="meta", dtype=torch.bfloat16)
    for run in (tfl.lstm_seq_fwd_bf16, tfl.lstm_seq_fwd):
        with pytest.raises(ValueError, match="no kernel"):
            run(x, x, x, x, x, x)


# ---------------------------------------------------------------------------
# (d) the stacked LSTM under bf16 mixed precision
# ---------------------------------------------------------------------------

CFG = dict(dict_size=100, lstm_size=128, emb_dim=32)
BATCH, SEQ = 8, 8


def _pallas_ok(ctx, attrs, use_peep, w_proj, b, h, t):
    """The JAX package's _pallas_lstm_ok without its backend test."""
    if use_peep or w_proj is not None:
        return False
    if (attrs.get("gate_activation", "sigmoid") != "sigmoid"
            or attrs.get("cell_activation", "tanh") != "tanh"
            or attrs.get("candidate_activation", "tanh") != "tanh"):
        return False
    if ctx is None or getattr(ctx, "mesh", None) is not None:
        return False
    return not (h % 128 or b % 8 or t < 4)


def _build(pkg, prog_mod, sdl, amp="bfloat16"):
    prog_mod.reset_unique_names()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        loss = sdl.get_model(use_fused=True, **CFG)[0]
    main.amp_dtype = amp
    return main, startup, loss


def _feed(i):
    """Ragged list feeds: lengths in [1, SEQ] with 1 and SEQ among them."""
    rng = np.random.RandomState(100 + i)
    lens = rng.randint(1, SEQ + 1, BATCH)
    lens[0], lens[1] = 1, SEQ
    return {"words": [rng.randint(0, CFG["dict_size"], (n, 1)).astype(
                "int64") for n in lens],
            "label": rng.randint(0, 2, (BATCH, 1)).astype("int64")}


def _rel(got, want) -> float:
    got, want = (np.asarray(v, np.float64) for v in (got, want))
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))


@pytest.fixture(scope="module")
def amp_runs():
    """From the JAX startup state (the start) and from PRETRAIN float32
    Adam steps past it (trained): each package's AMP step fetching the
    loss, every forward var and every gradient (the JAX package's float32
    gradients beside them); then, from the trained state, two AMP Adam
    steps in each package."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jfl, "INTERPRET", True)
    mp.setattr(jrnn, "_pallas_lstm_ok", _pallas_ok)
    try:
        jmain, jstart, jloss = _build(jpt, jprog, jsdl)
        jmain32 = _build(jpt, jprog, jsdl, amp=None)[0]
        tmain, _, tloss = _build(pt, tprog, tsdl)
        exe = jpt.Executor()
        jscope = JScope()
        exe.run(jstart, scope=jscope)
        persist = sorted(v.name for v in jmain.global_block.vars.values()
                         if v.persistable)
        params = [p.name for p in jmain.global_block.all_parameters()]
        fwd = []
        for op in jmain.global_block.ops:
            if op.type == "autodiff":
                break
            fwd += [n for n in op.output_names() if n not in fwd]
        fetch = [jloss.name] + fwd + [p + "@GRAD" for p in params]
        texe = pt.Executor(pt.CPUPlace())

        def state():
            return {n: np.array(jscope.find_var(n)) for n in persist}

        def jax_scope(arrays):
            s = JScope()
            for n, a in arrays.items():
                s.set_var(n, a)
            return s

        def one_step(arrays):
            j = exe.run(jmain, feed=_feed(0), fetch_list=fetch,
                        scope=jax_scope(arrays))
            j32 = exe.run(jmain32, feed=_feed(0), fetch_list=fetch,
                          scope=jax_scope(arrays))
            t = texe.run(tmain, feed=_feed(0), fetch_list=fetch,
                         scope=tio.scope_from_numpy(arrays, "cpu"),
                         return_numpy=False)
            return {k: dict(zip(fetch, v)) for k, v in
                    (("jax", j), ("jax32", j32), ("port", t))}

        out = dict(fetch=fetch, fwd=fwd, params=params, loss=jloss.name,
                   start=one_step(state()))
        for i in range(PRETRAIN):
            exe.run(jmain32, feed=_feed(50 + i), fetch_list=[jloss.name],
                    scope=jscope)
        trained = state()
        out["trained"] = one_step(trained)
        # two AMP Adam steps from the trained state in each package
        js, ts = jax_scope(trained), tio.scope_from_numpy(trained, "cpu")
        losses = []
        for i in range(2):
            lj, = exe.run(jmain, feed=_feed(10 + i), fetch_list=[jloss.name],
                          scope=js)
            lt, = texe.run(tmain, feed=_feed(10 + i), fetch_list=[jloss.name],
                           scope=ts)
            losses.append((float(np.ravel(lt)[0]), float(np.ravel(lj)[0])))
        out["steps"] = dict(
            losses=losses, start={p: trained[p] for p in params},
            jax={p: np.array(js.find_var(p)) for p in params},
            port={p: ts.get_numpy(p) for p in params},
            dtypes={p: ts.find_var(p).dtype for p in params})
        return out
    finally:
        mp.undo()


def test_amp_lstm_structure_matches_jax(amp_runs):
    """Every fetched var has the JAX package's dtype, exactly: bf16
    activations (the LSTM's outputs among them), float32 gradients; the
    masters stay float32 after the AMP steps."""
    for at in ("start", "trained"):
        run = amp_runs[at]
        assert [_dtype(run["port"][n]) for n in amp_runs["fetch"]] == [
            _dtype(np.asarray(run["jax"][n])) for n in amp_runs["fetch"]]
    run = amp_runs["start"]
    lstm_out = [n for n in amp_runs["fwd"] if n.startswith("lstm_")]
    assert lstm_out and all(_dtype(run["port"][n]) == "bfloat16"
                            for n in lstm_out)
    assert all(d == torch.float32 for d in
               amp_runs["steps"]["dtypes"].values())


@pytest.mark.parametrize("at", ["start", "trained"])
def test_amp_lstm_loss_and_gradients_match_jax(amp_runs, at):
    run = amp_runs[at]
    loss = amp_runs["loss"]
    np.testing.assert_allclose(_np(run["port"][loss]).reshape(-1)[0],
                               _np(run["jax"][loss]).reshape(-1)[0],
                               rtol=AMP_LOSS_RTOL)
    # every forward activation within bf16's limit of the JAX package's
    for n in amp_runs["fwd"]:
        want = _np(run["jax"][n])
        if want.dtype.kind == "f" and np.abs(want).max() > 0:
            assert _share(_np(run["port"][n]), want, BF16_REL) <= 1, n
    held = 0
    for p in amp_runs["params"]:
        if at == "start" and not p.endswith(".w_0"):
            # cancellation below bf16's resolution (docstring): the JAX
            # package's AMP gradient is no closer to its float32 one
            want, want32 = (_np(run[ref][p + "@GRAD"])
                            for ref in ("jax", "jax32"))
            assert _rel(want, want32) > AMP_GRAD_RTOL, p
            continue
        g = _np(run["port"][p + "@GRAD"])
        for ref in ("jax", "jax32"):
            want = _np(run[ref][p + "@GRAD"])
            assert _rel(g, want) <= AMP_GRAD_RTOL, (p, ref, _rel(g, want))
        held += 1
    weights = sum(p.endswith(".w_0") for p in amp_runs["params"])
    assert held == (weights if at == "start" else len(amp_runs["params"]))


def test_amp_lstm_adam_steps_match_jax(amp_runs):
    """Two AMP Adam steps from the trained state: losses within
    AMP_LOSS_RTOL, every master within AMP_STEP_ATOL, each parameter's
    update within AMP_UPDATE_RTOL (rms)."""
    steps = amp_runs["steps"]
    for got, want in steps["losses"]:
        assert abs(got - want) <= AMP_LOSS_RTOL * abs(want)
    for p, start in steps["start"].items():
        got, want = steps["port"][p], steps["jax"][p]
        assert float(np.abs(got - want).max()) <= AMP_STEP_ATOL, p
        assert _rel(got - start, want - start) <= AMP_UPDATE_RTOL, p
