"""The bottleneck chain's forward in bfloat16 (kernels/fused_block.py's
``*_bf16`` wrappers, ``bottleneck_rest_fwd`` on a bf16 block and the
``fused_bottleneck`` op's chain branch without a gradient) against the
JAX package on the CPU.

The four forward plain versions run on bf16 inputs against the JAX
package's Pallas kernels through the Pallas interpreter
(``paddle_tpu.kernels.fused_block.INTERPRET``, patched for the test).
Both round where the Pallas kernels round: bf16 products summed in
float32, y rounded once, the sums of the rounded y, h rounded to bf16
before any product uses it, a3 float32 through bn3's affine and the
residual add. They differ only in the order of float32 sums, so a y can
round to the neighbouring bf16 value: y is held bit for bit at
N 2, Cin 32, C 16, H 8 and elsewhere to at most FLIP_SHARE of its
elements, each one bf16 step from the Pallas kernel's; the float32 sums
within 1e-5 of the sum of their terms' magnitudes plus what those flips
move (the sum of |y - y'|, and of |y² - y'²|); Σh and M2 within rtol
1e-5. The plain versions of the parent tree summed the 3x3's nine taps
in bf16 and rounded a3 to bf16, and fail these (1203 of 2048 y of the
3x3, by up to 3.1e-2, and 579 of 4096 outputs of the residual 1x1
differ at N 2, Cin 32, C 16, H 8, on these tests' inputs).

The chain (``bottleneck_rest_fwd``) and the op through it carry a flip
into the next stage's BN fold, where it moves every h of a channel by
a little, so they are held to the bf16 limit 2^-7 max|jax| + 2^-7 |jax|
for the outputs (out, a1, a2) and rtol CHAIN_RTOL for the batch
statistics and running stats. A bf16 ResNet whose two rest blocks the
gate takes runs its training-mode forward, pruned to loss and accuracy,
through both packages' chains from one state: the loss within
LOSS_RTOL, the stat outputs within STAT_RTOL (relative rms, the largest
of them); a 3x3 that pads a1 instead of h1 (an out-of-image tap reads
relu(shift)) fails both. Last, the kernels' own order (the products of
a k16 block summed exactly and added to one float32 accumulator, block
after block, the 3x3's nine taps a 16-channel stage; one rounding) is
emulated in PyTorch at the chain's widths: the flips it makes against
the plain versions stay within phase 3's limits.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import paddle_tpu as jpt
from paddle_tpu.core import program as jprog
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.kernels import fused_block as jfb
from paddle_tpu.ops import fused_ops as jfo

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import ExecContext, require_op
from paddle_tpu_torch.kernels import fused_block as tfb
from paddle_tpu_torch.ops import fused_ops as tfo

torch.set_num_threads(2)

EPS = 1e-5
BF16_REL = 2.0 ** -7
STATS_RTOL = 1e-5
FLIP_SHARE = 1e-3
CHAIN_RTOL = 1e-2
SHAPES = [(2, 32, 16, 8), (2, 16, 8, 7), (4, 32, 8, 8), (8, 16, 8, 7)]
EXACT = (2, 32, 16, 8)     # N, Cin, C, H where y is bit for bit
BF = torch.bfloat16


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfb, "INTERPRET", True)


def _case(n, cin, c, h, seed=0):
    """tests/test_torch_fused_block.py's inputs, the activations and
    weights rounded to bf16 (scales, shifts and BN parameters float32)."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    d = dict(
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
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    for k in ("x", "w1", "taps", "w3", "a", "res"):
        t[k] = t[k].to(BF)
    return t


def _j(t: torch.Tensor):
    """The same values for the JAX package (bf16 stays bf16)."""
    v = jnp.asarray(t.float().numpy())
    return v.astype(jnp.bfloat16) if t.dtype == BF else v


def _t(a) -> torch.Tensor:
    """A JAX result as a torch tensor of its dtype."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(BF)
    return torch.from_numpy(np.asarray(a))


def _flips(got: torch.Tensor, want: torch.Tensor,
           one_step: bool = True) -> float:
    """The share of bf16 elements that differ; with one_step each must be
    one bf16 step (the neighbouring value of the same sign) from `want`
    (a sum near 0 taken in another order may change its sign: the
    emulation below holds those by the bf16 limit instead)."""
    assert got.dtype == want.dtype == BF and got.shape == want.shape
    gi, wi = got.view(torch.int16).int(), want.view(torch.int16).int()
    zero = (got.float() == 0) & (want.float() == 0)   # +0 against -0
    differ = (gi != wi) & ~zero
    if one_step:
        assert bool((~differ | ((gi - wi).abs() == 1)).all()), \
            "a y further than one bf16 step from the Pallas kernel's"
    return float(differ.float().mean())


def _hold_sums(s, q, rs, rq, y, ry):
    """The float32 sums Σy, Σy² of y against rs, rq of ry: within
    STATS_RTOL of their terms' magnitudes plus what the flips move."""
    yf, ryf = y.float(), ry.float()
    moved = (yf - ryf).abs()
    for got, want, terms, extra in (
            (s, rs, ryf.abs().sum(dim=(0, 2)), moved.sum(dim=(0, 2))),
            (q, rq, (ryf * ryf).sum(dim=(0, 2)),
             (moved * (yf.abs() + ryf.abs())).sum(dim=(0, 2)))):
        assert bool(((got - want).abs() <= STATS_RTOL * terms + extra)
                    .all()), (got, want)


def _hold_y(got, want, shape):
    share = _flips(got, want)
    if tuple(shape) == EXACT:
        assert share == 0.0
    assert share <= FLIP_SHARE, share


def _hold_bf16(got, want, what=""):
    got, want = got.float(), want.float()
    lim = BF16_REL * want.abs().max() + BF16_REL * want.abs()
    assert bool(((got - want).abs() <= lim).all()), \
        f"{what}: {float((got - want).abs().max()):.3e} beyond the limit"


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels, in bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_conv1x1_stats_plain_matches_pallas_in_bf16(interpret, shape):
    d = _case(*shape)
    jy, js, jq = jfb.conv1x1_stats(_j(d["x"]), _j(d["w1"]))
    y, s, q = tfb.conv1x1_stats_bf16(d["x"], d["w1"])
    assert y.dtype == BF and s.dtype == q.dtype == torch.float32
    _hold_y(y, _t(jy), shape)
    _hold_sums(s, q, _t(js), _t(jq), y, _t(jy))


@pytest.mark.parametrize("shape", SHAPES)
def test_conv3x3_norm_stats_plain_matches_pallas_in_bf16(interpret, shape):
    """The nine taps in one float32 accumulator, y rounded once (the
    parent tree's plain version summed them in bf16)."""
    h = shape[3]
    d = _case(*shape, seed=1)
    args = (d["a"], d["taps"], d["sc"], d["sh"])
    jy, js, jq = jfb.conv3x3_norm_stats(*map(_j, args), h)
    y, s, q = tfb.conv3x3_norm_stats_bf16(*args, h)
    _hold_y(y, _t(jy), shape)
    _hold_sums(s, q, _t(js), _t(jq), y, _t(jy))


@pytest.mark.parametrize("shape", SHAPES)
def test_norm_relu_moments_plain_matches_pallas_in_bf16(interpret, shape):
    d = _case(*shape, seed=2)
    args = (d["a"], d["sc"], d["sh"])
    jsum, jm2 = jfb.norm_relu_moments(*map(_j, args))
    tsum, tm2 = tfb.norm_relu_moments_bf16(*args)
    # h >= 0, rounded to bf16 in both: the sums are their terms' magnitudes
    for got, want in ((tsum, _t(jsum)), (tm2, _t(jm2))):
        assert bool(((got - want).abs() <= STATS_RTOL * want).all())


@pytest.mark.parametrize("shape", SHAPES)
def test_conv1x1_bn_residual_plain_matches_pallas_in_bf16(interpret, shape):
    """h2 rounded to bf16 before the product, a3 float32 through bn3's
    affine and the residual add, one rounding (the parent tree's plain
    version rounded a3 to bf16)."""
    d = _case(*shape, seed=3)
    args = (d["a"], d["res"], d["sc"], d["sh"], d["w3"], d["sc3"], d["sh3"])
    want = jfb.conv1x1_bn_residual(*map(_j, args))
    _hold_y(tfb.conv1x1_bn_residual_bf16(*args), _t(want), shape)


def test_bf16_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors each bf16 wrapper is its plain version, bit for bit,
    builds nothing and counts no launch."""
    d = _case(2, 32, 16, 8, seed=4)
    calls = {
        "conv1x1_stats_bf16": (d["x"], d["w1"]),
        "conv3x3_norm_stats_bf16": (d["a"], d["taps"], d["sc"], d["sh"], 8),
        "norm_relu_moments_bf16": (d["a"], d["sc"], d["sh"]),
        "conv1x1_bn_residual_bf16": (d["a"], d["res"], d["sc"], d["sh"],
                                     d["w3"], d["sc3"], d["sh3"])}
    for name, args in calls.items():
        fn = getattr(tfb, name)
        before = fn.launches
        got = fn(*args)
        want = getattr(tfb, name[:-5] + "_reference")(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
        assert fn.launches == before, name


# ---------------------------------------------------------------------------
# the chain and the op, in bf16
# ---------------------------------------------------------------------------

CHAIN_ARGS = ("x", "w1", "taps", "w3", "g1", "b1", "g2", "b2", "g3", "b3")


@pytest.mark.parametrize("shape", [(2, 32, 16, 8), (8, 16, 8, 7)])
def test_rest_fwd_in_bf16_matches_jax(interpret, shape):
    """bottleneck_rest_fwd on a bf16 block (the bf16 wrappers, float32 BN
    folds) against the JAX package's on its Pallas kernels: out, a1 and
    a2 bf16 within the bf16 limit, the six batch statistics and Σh2, M2
    within CHAIN_RTOL."""
    h = shape[3]
    d = _case(*shape, seed=5)
    args = [d[k] for k in CHAIN_ARGS]
    out, stats, aux = tfb.bottleneck_rest_fwd(*args, h)
    jout, jstats, jaux = jfb.bottleneck_rest_fwd(*map(_j, args), h)
    assert out.dtype == aux[0].dtype == aux[1].dtype == BF
    for name, got, want in (("out", out, jout), ("a1", aux[0], jaux[0]),
                            ("a2", aux[1], jaux[1])):
        _hold_bf16(got, _t(want), name)
    for got, want in list(zip(stats, jstats)) + list(zip(aux[2:4],
                                                         jaux[2:4])):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=CHAIN_RTOL, atol=CHAIN_RTOL * float(
                                       np.abs(np.asarray(want)).max()))


def _bn_params(d, c, cin, seed):
    rng = np.random.RandomState(seed)
    params = []
    for k, width in (("1", c), ("2", c), ("3", cin)):
        params.append((d["g" + k], d["b" + k],
                       torch.from_numpy((0.1 * rng.randn(width))
                                        .astype(np.float32)),
                       torch.from_numpy((0.5 + rng.rand(width))
                                        .astype(np.float32))))
    return params


def _op_ins(x, w1, w2, w3, bn):
    ins = {"X": [x], "W1": [w1], "W2": [w2], "W3": [w3]}
    for k, params in zip("123", bn):
        for slot, v in zip(("Scale", "Bias", "Mean", "Variance"), params):
            ins[slot + k] = [v]
    return ins


def test_op_in_bf16_through_the_chain_matches_jax(interpret, monkeypatch):
    """With the gate open (as PT_FUSED_BLOCK=always on the card) and no
    gradient wanted, the fused_bottleneck op sends a bf16 block through
    the chain; all 13 outputs against the JAX op through its Pallas chain
    (its _fused_block_enabled patched true, PT_FUSED_BLOCK_MIN_S lowered
    to the image): Out within the bf16 limit, the twelve stat outputs
    within CHAIN_RTOL."""
    n, cin, c, h = 8, 128, 64, 4
    monkeypatch.setenv("PT_FUSED_BLOCK", "always")
    monkeypatch.setenv("PT_FUSED_BLOCK_MIN_S", "16")
    monkeypatch.setattr(tfo, "fused_block_enabled", lambda device: True)
    monkeypatch.setattr(tfo, "CHAIN_MIN_S", 16)
    monkeypatch.setattr(jfo, "_fused_block_enabled", lambda ctx: True)
    calls = []
    chain = tfo._chain_block
    monkeypatch.setattr(tfo, "_chain_block",
                        lambda *a: calls.append(a[0].dtype) or chain(*a))
    d = _case(n, cin, c, h, seed=6)
    w2 = d["taps"].reshape(3, 3, c, c).permute(2, 3, 0, 1).contiguous()
    args = (d["x"].reshape(n, cin, h, h), d["w1"].reshape(c, cin, 1, 1), w2,
            d["w3"].reshape(cin, c, 1, 1))
    bn = _bn_params(d, c, cin, seed=7)
    attrs = {"epsilon": EPS, "momentum": 0.9}
    ctx = ExecContext(torch.Generator(), torch.device("cpu"))
    with torch.no_grad():
        outs = require_op("fused_bottleneck").compute(
            ctx, _op_ins(*args, bn), attrs)
    assert calls == [BF]
    jouts = jfo.fused_bottleneck(
        None, _op_ins(*map(_j, args), [tuple(map(_j, p)) for p in bn]),
        attrs)
    _hold_bf16(outs["Out"][0], _t(jouts["Out"][0]), "Out")
    slots = [s.format(k=k) for k in "123" for s in tfo._BN_OUT_SLOTS]
    assert len(slots) == 12
    for slot in slots:
        want = np.asarray(jouts[slot][0])
        np.testing.assert_allclose(outs[slot][0].numpy(), want,
                                   rtol=CHAIN_RTOL,
                                   atol=CHAIN_RTOL * float(np.abs(want).max()),
                                   err_msg=slot)


# ---------------------------------------------------------------------------
# the slice: a bf16 ResNet's training-mode forward through both chains
# ---------------------------------------------------------------------------

LOSS_RTOL, STAT_RTOL = 1e-2, 5e-2
RES_BATCH, RES_IMAGE, RES_CLASSES = 8, 4, 10


def _resnet_forward(pkg):
    """A bf16 ResNet cut to what the chain takes: a 3x3 stem conv + BN +
    ReLU to 256 channels, two rest blocks of C 64 (fused_bottleneck), the
    global average pool, an fc to 10 classes; pruned to its loss and
    accuracy. (main, loss, stat output names)."""
    layers = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup):
        x = layers.data("data", [3, RES_IMAGE, RES_IMAGE], dtype="bfloat16")
        label = layers.data("label", [1], dtype="int64")
        h = layers.batch_norm(input=layers.conv2d(
            input=x, num_filters=256, filter_size=3, padding=1,
            bias_attr=False), act="relu")
        h = layers.fused_bottleneck(h, ch_out=64)
        h = layers.fused_bottleneck(h, ch_out=64)
        h = layers.pool2d(h, pool_size=RES_IMAGE, pool_type="avg",
                          global_pooling=True)
        logits = layers.fc(h, size=RES_CLASSES)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(input=layers.softmax(logits), label=label)
    slots = [s.format(k=k) for k in "123" for s in tfo._BN_OUT_SLOTS]
    stats = [op.output(s)[0] for op in main.global_block.ops
             if op.type == "fused_bottleneck" for s in slots]
    return main.prune([loss.name, acc.name]), startup, loss, stats


def _padding_a1(x, taps, scale, shift, h_side):
    """The planted fault: a 3x3 that pads a1 and normalizes after, so an
    out-of-image tap reads relu(shift) instead of 0."""
    n, cin, s = x.shape
    a = F.pad(x.float().reshape(n, cin, h_side, s // h_side), (1, 1, 1, 1),
              value=0.0)
    hp = torch.clamp_min(a * scale.reshape(1, -1, 1, 1)
                         + shift.reshape(1, -1, 1, 1), 0.0).to(x.dtype)
    w = taps.float().reshape(3, 3, -1, cin).permute(2, 3, 0, 1)
    y = F.conv2d(hp.float(), w).reshape(n, -1, s).to(x.dtype)
    yf = y.float()
    return y, yf.sum(dim=(0, 2)), (yf * yf).sum(dim=(0, 2))


@pytest.mark.parametrize("fault", [None, "3x3 pads a1"])
def test_bf16_resnet_forward_through_both_chains(interpret, monkeypatch,
                                                 fault):
    """The slice: the same bf16 program in both packages, from the JAX
    package's startup state, its training-mode forward with both chains'
    gates open (no gradient): the loss within LOSS_RTOL and the stat
    outputs within STAT_RTOL (the largest relative rms over them, the
    running stats as their updates); the planted fault fails both."""
    monkeypatch.setenv("PT_FUSED_BLOCK", "always")
    monkeypatch.setenv("PT_FUSED_BLOCK_MIN_S", "16")
    monkeypatch.setattr(tfo, "fused_block_enabled", lambda device: True)
    monkeypatch.setattr(tfo, "CHAIN_MIN_S", 16)
    monkeypatch.setattr(jfo, "_fused_block_enabled", lambda ctx: True)
    if fault:
        monkeypatch.setattr(tfb, "conv3x3_norm_stats_bf16", _padding_a1)
    chained = []
    chain = tfo._chain_block
    monkeypatch.setattr(tfo, "_chain_block",
                        lambda *a: chained.append(a[0].dtype) or chain(*a))
    rng = np.random.RandomState(8)
    feed = {"data": rng.rand(RES_BATCH, 3, RES_IMAGE, RES_IMAGE)
            .astype(np.float32),
            "label": rng.randint(0, RES_CLASSES, (RES_BATCH, 1))
            .astype(np.int64)}
    got = {}
    for pkg, pm in ((jpt, jprog), (pt, tprog)):
        pm.reset_unique_names()
        main, startup, loss, stats = _resnet_forward(pkg)
        if pkg is jpt:
            exe, scope = jpt.Executor(), JScope()
            exe.run(startup, scope=scope)
            state = {n: np.array(scope.find_var(n))
                     for n in scope.local_var_names()}
        else:
            exe = pt.Executor(pt.CPUPlace())
            scope = tio.scope_from_numpy(state, "cpu")
        out = exe.run(main, feed=feed, fetch_list=[loss.name] + stats,
                      scope=scope)
        got[pkg] = (float(np.asarray(out[0]).ravel()[0]),
                    [np.asarray(v, np.float64) - state.get(n, 0)
                     for n, v in zip(stats, out[1:])])
    assert chained == [BF, BF]
    (jloss, jstats), (tloss, tstats) = got[jpt], got[pt]
    assert len(tstats) == len(jstats) == 24
    loss_rel = abs(tloss - jloss) / abs(jloss)
    stat_rel = max(np.sqrt(np.mean((t - j) ** 2)) / np.sqrt(np.mean(j ** 2))
                   for t, j in zip(tstats, jstats))
    ok = loss_rel <= LOSS_RTOL and stat_rel <= STAT_RTOL
    assert ok == (fault is None), (loss_rel, stat_rel)


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated: their K order in float32, one rounding
# ---------------------------------------------------------------------------

def _k16(w, x):
    """Σ_k w[m, k] x[n, k, s] as the kernels sum it: each k16 block's
    products exactly (float64, then float32), added block after block to
    one float32 accumulator."""
    acc = None
    for k0 in range(0, w.shape[1], 16):
        part = torch.matmul(w[:, k0:k0 + 16].double(),
                            x[:, k0:k0 + 16].double()).float()
        acc = part if acc is None else acc + part
    return acc


def _emulated_conv3x3(x, taps, scale, shift, h_side):
    """The 3x3 kernel's order: 16-channel stages, the nine taps of a stage
    in order, each a k16 block into one float32 accumulator."""
    n, cin, s = x.shape
    w_side = s // h_side
    hp = F.pad(tfb._norm_relu(x, scale, shift).reshape(n, cin, h_side,
                                                       w_side), (1, 1, 1, 1))
    acc = None
    for k0 in range(0, cin, 16):
        for t in range(9):
            ky, kx = divmod(t, 3)
            hs = hp[:, k0:k0 + 16, ky:ky + h_side, kx:kx + w_side]
            part = torch.matmul(taps[t][:, k0:k0 + 16].double(),
                                hs.reshape(n, 16, s).double()).float()
            acc = part if acc is None else acc + part
    return acc.to(x.dtype)


@pytest.mark.parametrize("stage", [(2, 256, 64, 14), (1, 512, 128, 14)])
def test_emulated_kernel_order_stays_within_phase3_limits(stage):
    """At the chain's widths, the kernels' order (emulated) against the
    plain versions on the same bf16 inputs: y and out within the bf16
    limit with at most FLIP_SHARE of their elements one step apart, the
    sums of the rounded y within the flip-aware limit."""
    n, cin, c, h = stage
    gen = torch.Generator().manual_seed(9)
    x = torch.rand(n, cin, h * h, generator=gen).to(BF)
    w1 = (torch.randn(c, cin, generator=gen) * (2 / cin) ** 0.5).to(BF)
    taps = (torch.randn(9, c, c, generator=gen) * (2 / (9 * c)) ** 0.5).to(BF)
    w3 = (torch.randn(cin, c, generator=gen) * (2 / c) ** 0.5).to(BF)
    gam = [1 + 0.2 * torch.randn(k, generator=gen) for k in (c, c, cin)]
    bet = [0.2 * torch.randn(k, generator=gen) for k in (c, c, cin)]
    m = n * h * h

    ry1, rs1, rq1 = tfb.conv1x1_stats_reference(x, w1)
    y1 = _k16(w1, x).to(BF)
    for y, ry, (rs, rq) in ((y1, ry1, (rs1, rq1)),):
        _hold_bf16(y, ry, "conv1x1_stats")
        assert _flips(y, ry, one_step=False) <= FLIP_SHARE
        yf = y.float()
        _hold_sums(yf.sum(dim=(0, 2)), (yf * yf).sum(dim=(0, 2)), rs, rq, y,
                   ry)
    _, _, sc1, sh1 = tfb._bn_fold(rs1, rq1, m, gam[0], bet[0])
    ry2, rs2, rq2 = tfb.conv3x3_norm_stats_reference(ry1, taps, sc1, sh1, h)
    y2 = _emulated_conv3x3(ry1, taps, sc1, sh1, h)
    _hold_bf16(y2, ry2, "conv3x3_norm_stats")
    assert _flips(y2, ry2, one_step=False) <= FLIP_SHARE
    y2f = y2.float()
    _hold_sums(y2f.sum(dim=(0, 2)), (y2f * y2f).sum(dim=(0, 2)), rs2, rq2,
               y2, ry2)
    _, _, sc2, sh2 = tfb._bn_fold(rs2, rq2, m, gam[1], bet[1])
    rsum_h, rm2h = tfb.norm_relu_moments_reference(ry2, sc2, sh2)
    hh = tfb._norm_relu(ry2, sc2, sh2).permute(1, 0, 2).reshape(c, -1)
    m2 = _k16(hh, hh.T.unsqueeze(0))[0]
    assert bool(((m2 - rm2h).abs() <= STATS_RTOL * rm2h).all())
    _, _, sc3, sh3 = tfb._bn3_fold(w3, rsum_h, rm2h, m, gam[2], bet[2])
    a3 = _k16(w3, tfb._norm_relu(ry2, sc2, sh2))
    out = torch.clamp_min(torch.addcmul(sh3.reshape(1, -1, 1), a3,
                                        sc3.reshape(1, -1, 1))
                          + x.float(), 0.0).to(BF)
    rout = tfb.conv1x1_bn_residual_reference(ry2, x, sc2, sh2, w3, sc3, sh3)
    _hold_bf16(out, rout, "conv1x1_bn_residual")
    assert _flips(out, rout, one_step=False) <= FLIP_SHARE
