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
from paddle_tpu_torch.kernels import build
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


def _tile1x1_order(w, x):
    """Σ_k w[m, k] x[n, k, s] as the bf16 1x1 tile
    (csrc/conv1x1_bf16_tc.cuh) sums it: K in 64-channel tiles, a tile's
    channels in its grouped tensor map's row order (channel g·i + j at row
    j·64/g + i, g = 8 / gcd(S, 8)), the tile's four k16 blocks in that
    order, each block's products exactly (float64, then float32) added to
    one float32 accumulator (_k16); channels past K zero."""
    k, s = w.shape[1], x.shape[2]
    g, kp = tfb._bf_groups(s), -(-k // 64) * 64
    per = 64 // g
    order = [64 * t + (r % per) * g + r // per for t in range(kp // 64)
             for r in range(64)]
    return _k16(F.pad(w.float(), (0, kp - k))[:, order],
                F.pad(x.float(), (0, 0, 0, kp - k))[:, order])


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


def _abw_order(a, b, splits):
    """Σ a[n, i, p] b[n, j, p] over N·S [Ma, Mb] as the wgmma products
    (csrc/abt_bf16_tc.cuh) add it: 64-position stages of one image (0 past
    S), each stage four k16 blocks, a block's products exactly (float64,
    then float32) added to one float32 accumulator block after block,
    stage after stage within a split (split p: stages [p·Q // splits, (p +
    1)·Q // splits)), the splits' partials added in split order."""
    n, ma, s = a.shape
    cpi = -(-s // 64)
    pad = cpi * 64 - s
    ap = F.pad(a.double(), (0, pad)).reshape(n, ma, cpi, 4, 16)
    bp = F.pad(b.double(), (0, pad)).reshape(n, b.shape[1], cpi, 4, 16)
    blocks = torch.einsum("nicqk,njcqk->ncqij", ap, bp).float().reshape(
        n * cpi * 4, ma, b.shape[1])
    stages, total = n * cpi, None
    for p in range(splits):
        acc = torch.zeros(ma, b.shape[1])
        for x in range(p * stages // splits, (p + 1) * stages // splits):
            for q in range(4):
                acc = acc + blocks[4 * x + q]
        total = acc if total is None else total + acc
    return total


def _abw_g3_sum(g3, splits):
    """Σg3 [Cin] as reduce3_bf16_kernel adds it: a thread's 8 positions of
    a row a stage in order onto its own float32 partial, stage after
    stage; a row's 8 partials in chunk order; the splits in order."""
    n, cin, s = g3.shape
    cpi = -(-s // 64)
    gp = F.pad(g3.float(), (0, cpi * 64 - s)).reshape(n, cin, cpi, 8, 8)
    gp = gp.permute(0, 2, 1, 3, 4).reshape(n * cpi, cin, 8, 8)
    stages, total = n * cpi, None
    for p in range(splits):
        part = torch.zeros(cin, 8)
        for x in range(p * stages // splits, (p + 1) * stages // splits):
            for e in range(8):
                part = part + gp[x, :, :, e]
        row = part[:, 0]
        for k in range(1, 8):
            row = row + part[:, k]
        total = row if total is None else total + row
    return total


@pytest.mark.parametrize("stage", [(2, 256, 64, 14), (1, 512, 128, 14)])
def test_emulated_kernel_order_stays_within_phase3_limits(stage):
    """At the chain's widths, the kernels' order (emulated) against the
    plain versions on the same bf16 inputs: y and out within the bf16
    limit with at most FLIP_SHARE of their elements one step apart, the
    sums of the rounded y within the flip-aware limit; and the backward's
    wgmma products in their order of stages, k16 blocks and splits
    (the splits _bf_abw_splits gives on 132 SMs): bwd_reduce3's P and Σg3
    within STATS_RTOL of their terms of the plain version's, bwd_mid's
    nine tap gradients within STATS_RTOL of their terms of the float64
    product, bwd_final's dW1 (Σ x·da1ᵀ on the same kernel) within
    STATS_RTOL of its terms (phase 3's limits); the 1x1 tile's order of
    k16 blocks (_tile1x1_order, its grouped channels at S 196) for
    conv1x1_bn_residual's out and bwd_final's dx, each within the bf16
    limit with at most FLIP_SHARE of its elements apart."""
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
    a3 = _tile1x1_order(w3, tfb._norm_relu(ry2, sc2, sh2))
    out = torch.clamp_min(torch.addcmul(sh3.reshape(1, -1, 1), a3,
                                        sc3.reshape(1, -1, 1))
                          + x.float(), 0.0).to(BF)
    rout = tfb.conv1x1_bn_residual_reference(ry2, x, sc2, sh2, w3, sc3, sh3)
    _hold_bf16(out, rout, "conv1x1_bn_residual")
    assert _flips(out, rout, one_step=False) <= FLIP_SHARE

    args = _bwd_inputs(stage, seed=9, stat_cots=True)
    dout, out3, a2, scale2, shift2 = args["bwd_reduce3"]
    g3, p3, sg3 = tfb.bwd_reduce3_reference(*args["bwd_reduce3"])
    h2 = tfb._norm_relu(a2, scale2, shift2).float()
    splits = tfb._bf_abw_splits(tfb._bf_abw_tiles("reduce3", cin, c), n,
                                h * h, 132)
    _hold_sum(_abw_order(g3.float(), h2, splits), p3,
              torch.einsum("nis,ncs->ic", g3.float().abs(), h2), what="P")
    _hold_sum(_abw_g3_sum(g3, splits), sg3, g3.float().abs().sum(dim=(0, 2)),
              what="Σg3")
    g2, a2m, a1, sc1, sh1, p2, q2, r2 = args["bwd_mid"][:8]
    da2 = tfb._unfold(g2, a2m, p2, q2, r2).to(BF).double()
    h1 = F.pad(tfb._norm_relu(a1, sc1, sh1).double().view(n, c, h, h),
               (1, 1, 1, 1))
    splits = tfb._bf_abw_splits(tfb._bf_abw_tiles("taps", c, c), n, h * h,
                                132)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        hs = h1[:, :, dy:dy + h, dx:dx + h].reshape(n, c, h * h)
        want = torch.einsum("ncs,nks->ck", da2, hs)
        terms = torch.einsum("ncs,nks->ck", da2.abs(), hs.abs())
        got = _abw_order(da2, hs, splits).double()
        assert bool(((got - want).abs() <= STATS_RTOL * terms).all()), tap
    g3, g1, a1, xb, p1, q1, r1, w1 = args["bwd_final"]
    rdx, rdw = tfb.bwd_final_reference(*args["bwd_final"])
    da1 = tfb._unfold(g1, a1, p1, q1, r1).to(BF).float()
    dx = (_tile1x1_order(w1.T, da1) + g3.float()).to(BF)
    _hold_bf16(dx, rdx, "dx")
    assert _flips(dx, rdx, one_step=False) <= FLIP_SHARE
    splits = tfb._bf_abw_splits(tfb._bf_abw_tiles("dw1", c, cin), n, h * h,
                                132)
    _hold_sum(_abw_order(xb.float(), da1, splits).T, rdw,
              torch.einsum("ncs,nks->ck", da1.abs(), xb.float()),
              what="dW1")


# ---------------------------------------------------------------------------
# the backward in bf16: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

BWD_KERNELS = ("bwd_reduce3", "bwd_apply3", "bwd_mid", "bwd_final")


def _bwd_inputs(shape, seed, stat_cots=False):
    """{kernel: args} of the four backward kernels in one run of the plain
    chain on a bf16 block (the bf16 forward, then bottleneck_rest_bwd on
    a bf16 cotangent of out and, with stat_cots, random cotangents of the
    six batch statistics), each kernel's inputs as its plain predecessors
    make them."""
    n, cin, c, h = shape
    d = _case(*shape, seed=seed)
    out, stats, aux = tfb.bottleneck_rest_fwd(*[d[k] for k in CHAIN_ARGS], h)
    a1, a2, sum_h, m2h, sc1, sh1, sc2, sh2 = aux
    res = (d["x"], a1, a2, out, d["w1"], d["taps"], d["w3"], d["g1"],
           d["g2"], d["g3"], *stats, sum_h, m2h, sc1, sh1, sc2, sh2)
    gen = torch.Generator().manual_seed(seed + 100)
    dout = torch.randn(out.shape, generator=gen).to(BF)
    cots = [torch.randn(s.shape, generator=gen) if stat_cots
            else torch.zeros_like(s) for s in stats]
    args = {}
    saved = {k: getattr(tfb, k + "_bf16") for k in BWD_KERNELS}

    def capture(name):
        def call(*a):
            args[name] = a
            return saved[name](*a)
        return call

    try:
        for k in BWD_KERNELS:
            setattr(tfb, k + "_bf16", capture(k))
        tfb.bottleneck_rest_bwd(res, dout, cots, h)
    finally:
        for k, fn in saved.items():
            setattr(tfb, k + "_bf16", fn)
    return args


def _jargs(args):
    return [_j(a) if isinstance(a, torch.Tensor) else a for a in args]


def _hold_sum(got, want, terms, moved=0.0, what=""):
    """A float32 sum within STATS_RTOL of its terms' magnitudes plus what
    the bf16 values that flipped move it."""
    assert got.dtype == torch.float32 and got.shape == want.shape, what
    lim = STATS_RTOL * terms + moved
    assert bool(((got - want).abs() <= lim).all()), \
        f"{what}: {float(((got - want).abs() / lim).max()):.3f} of the limit"


def _moved(got, want):
    return (got.float() - want.float()).abs()


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_reduce3_plain_matches_pallas_in_bf16(interpret, shape):
    """g3 bit for bit; P = Σ g3·h2ᵀ and Σg3 (of the same bf16 values in
    both) within STATS_RTOL of their terms' magnitudes."""
    args = _bwd_inputs(shape, seed=10)["bwd_reduce3"]
    jg3, jp, jsg = jfb.bwd_reduce3(*_jargs(args))
    g3, p, sg = tfb.bwd_reduce3_reference(*args)
    assert g3.dtype == BF and torch.equal(g3, _t(jg3))
    g3a = g3.float().abs()
    h2 = tfb._norm_relu(*args[2:]).float()
    _hold_sum(p, _t(jp), torch.einsum("nis,ncs->ic", g3a, h2), what="P")
    _hold_sum(sg, _t(jsg), g3a.sum(dim=(0, 2)), what="Σg3")


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_apply3_plain_matches_pallas_in_bf16(interpret, shape):
    """g2 = bf16((A·g3 + B·h2 + v0)·(h2f > 0)), h2f one fused multiply-add
    (the parent tree's plain version took a product and a sum, and put h2
    and its mask elsewhere): g2 bit for bit at EXACT, elsewhere at most
    FLIP_SHARE of it one bf16 step off; Σg2 and Σg2·x̂2 within the
    flip-aware limit."""
    args = _bwd_inputs(shape, seed=11)["bwd_apply3"]
    jg2, js, jq = jfb.bwd_apply3(*_jargs(args))
    g2, s, q = tfb.bwd_apply3_reference(*args)
    jg2 = _t(jg2)
    _hold_y(g2, jg2, shape)
    a2, inv2, m2 = args[1], args[7], args[8]
    xhat = tfb._affine(a2, inv2, -m2 * inv2).abs()
    moved = _moved(g2, jg2)
    _hold_sum(s, _t(js), jg2.float().abs().sum(dim=(0, 2)),
              moved.sum(dim=(0, 2)), "Σg2")
    _hold_sum(q, _t(jq), (jg2.float().abs() * xhat).sum(dim=(0, 2)),
              (moved * xhat).sum(dim=(0, 2)), "Σg2·x̂2")


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_mid_plain_matches_pallas_in_bf16(interpret, shape):
    """da2 = bf16(fma(g2, p2, a2·q2) + r2) and h1f one fused multiply-add,
    as XLA contracts them (the parent tree's plain version rounded each
    product and sum): g1 bit for bit at EXACT, elsewhere at most
    FLIP_SHARE of it one bf16 step off; the nine tap gradients (of the
    same bf16 da2 and h1 in both) within STATS_RTOL of their terms'
    magnitudes; Σg1, Σg1·x̂1 within the flip-aware limit."""
    h = shape[3]
    args = _bwd_inputs(shape, seed=12)["bwd_mid"]
    jg1, jdt, js, jq = jfb.bwd_mid(*_jargs(args))
    g1, dt, s, q = tfb.bwd_mid_reference(*args)
    jg1 = _t(jg1)
    _hold_y(g1, jg1, shape)
    g2, a2, a1, sc1, sh1, p2, q2, r2, inv1, m1, taps, _ = args
    n, c, sz = g2.shape
    da2 = tfb._unfold(g2, a2, p2, q2, r2).to(BF).float().abs()
    h1 = tfb._norm_relu(a1, sc1, sh1).float()
    terms = torch.nn.grad.conv2d_weight(
        h1.view(n, c, h, sz // h), (c, c, 3, 3), da2.view(n, c, h, sz // h),
        padding=1).permute(2, 3, 0, 1).reshape(9, c, c)
    _hold_sum(dt, _t(jdt), terms, what="dtaps")
    xhat = tfb._affine(a1, inv1, -m1 * inv1).abs()
    moved = _moved(g1, jg1)
    _hold_sum(s, _t(js), jg1.float().abs().sum(dim=(0, 2)),
              moved.sum(dim=(0, 2)), "Σg1")
    _hold_sum(q, _t(jq), (jg1.float().abs() * xhat).sum(dim=(0, 2)),
              (moved * xhat).sum(dim=(0, 2)), "Σg1·x̂1")


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_final_plain_matches_pallas_in_bf16(interpret, shape):
    """da1 = bf16(fma(g1, p1, a1·q1) + r1), as XLA contracts it (the parent
    tree's plain version rounded each product and sum); dx = bf16(W1ᵀ·da1
    + g3) bit for bit at EXACT, elsewhere at most FLIP_SHARE of it one
    bf16 step off; dW1 (of the same bf16 da1 and x in both) within
    STATS_RTOL of its terms' magnitudes."""
    args = _bwd_inputs(shape, seed=13)["bwd_final"]
    jdx, jdw = jfb.bwd_final(*_jargs(args))
    dx, dw = tfb.bwd_final_reference(*args)
    _hold_y(dx, _t(jdx), shape)
    g3, g1, a1, x, p1, q1, r1, _ = args
    da1 = tfb._unfold(g1, a1, p1, q1, r1).to(BF).float().abs()
    _hold_sum(dw, _t(jdw), torch.einsum("ncs,nks->ck", da1, x.float()),
              what="dW1")


def _contraction_probe(n=1, c=512, h=2, seed=14):
    """Operands on which a fused multiply-add and a rounded product differ:
    a2 constant per channel and sh = -(a2·sc rounded), so that a product
    then a sum gives exactly 0 and a fused multiply-add the product's
    rounding error, of either sign."""
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.randn(1, c, 1).astype(np.float32)).to(BF)
    a = a.expand(n, c, h * h).contiguous()
    sc = torch.from_numpy((1 + rng.rand(c)).astype(np.float32))
    sh = -(a[0, :, 0].float() * sc)
    return a, sc, sh


def test_backward_affines_round_where_the_pallas_kernels_do(interpret):
    """The affines XLA contracts in the interpreted Pallas kernels, on
    operands where contracting shows: with B = I and A = 0, bwd_apply3's
    g2 is h2 itself, relu(a2·sc2 + sh2) rounded, and its mask; with the
    centre tap I, bwd_mid's g1 is da2 under h1's mask; with W1 = I,
    bwd_final's dx is da1. da = g·p + a·q + r with a·q ≈ -g·p. The plain
    versions meet each bit for bit; the parent tree's (a product and a
    sum) miss hundreds."""
    a, sc, sh = _contraction_probe()
    n, c, s = a.shape
    zero = torch.zeros(n, c, s, dtype=BF)
    eye = torch.eye(c).to(BF)
    zc = torch.zeros(c)
    args = (zero, a, sc, sh, torch.zeros(c, c, dtype=BF), eye, zc, sc, sh)
    jg2 = _t(jfb.bwd_apply3(*_jargs(args))[0])
    assert int((jg2.float() != 0).sum()) > 100   # the mask shows
    assert torch.equal(tfb.bwd_apply3_reference(*args)[0], jg2)

    rng = np.random.RandomState(15)
    g = torch.from_numpy(rng.randn(n, c, s).astype(np.float32)).to(BF)
    p = torch.from_numpy((1 + rng.rand(c)).astype(np.float32))
    q = -p * (1 + 2.0 ** -16 * (1 + torch.from_numpy(rng.rand(c))
                                .float()))
    taps = torch.zeros(9, c, c, dtype=BF)
    taps[4] = eye
    # the mask: h1 = relu(a·sc + sh) on the probe; da2 = g·p + g·q (+ 0)
    args = (g, g, a, sc, sh, p, q, zc, sc, sh, taps, 2)
    jg1 = _t(jfb.bwd_mid(*_jargs(args[:-1]), 2)[0])
    assert torch.equal(tfb.bwd_mid_reference(*args)[0], jg1)
    args = (zero, g, g, zero, p, q, zc, eye)
    jdx = _t(jfb.bwd_final(*_jargs(args))[0])
    assert torch.equal(tfb.bwd_final_reference(*args)[0], jdx)
    # the parent tree's plain versions (a product and a sum) miss them
    split = (g.float() * p.reshape(1, -1, 1)
             + g.float() * q.reshape(1, -1, 1)).to(BF)
    assert int((split != jdx).sum()) > 100


def test_bf16_backward_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors each bf16 backward wrapper is its plain version, bit
    for bit, builds nothing and counts no launch."""
    args = _bwd_inputs((2, 32, 16, 8), seed=16)
    for name in BWD_KERNELS:
        fn = getattr(tfb, name + "_bf16")
        before = fn.launches
        got = fn(*args[name])
        want = getattr(tfb, name + "_reference")(*args[name])
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
        assert fn.launches == before, name


def _bf16_bwd_args(name, fault):
    """Valid bf16 operands of a backward wrapper (N 2, Cin 32, C 16, H 8),
    one of them broken as `fault` says."""
    n, cin, c, h = 2, 32, 16, 8
    s = h * h
    z = torch.zeros

    def act(k):
        return z(n, k, s, dtype=BF)

    vec = z(c)
    args = {"bwd_reduce3": [act(cin), act(cin), act(c), vec, vec],
            "bwd_apply3": [act(cin), act(c), vec, vec, z(c, cin, dtype=BF),
                           z(c, c, dtype=BF), vec, vec, vec],
            "bwd_mid": [act(c), act(c), act(c), vec, vec, vec, vec, vec, vec,
                        vec, z(9, c, c, dtype=BF), h],
            "bwd_final": [act(cin), act(c), act(c), act(cin), vec, vec, vec,
                          z(c, cin, dtype=BF)]}[name]
    i = 1   # not the operand on_card reads
    if fault == "float32":
        args[i] = args[i].float()
    elif fault == "strided":
        args[i] = z(args[i].shape[::-1], dtype=BF).transpose(0, -1)
    elif fault == "misaligned":
        t = args[i]
        args[i] = z(t.numel() + 1, dtype=BF)[1:].view(t.shape)
        assert args[i].data_ptr() % 16
    elif fault == "C % 16":
        c = 8
        args = [a[:, :c].contiguous() if isinstance(a, torch.Tensor)
                and a.dim() == 3 and a.shape[0] == n else a for a in args]
        args = [a[:c] if isinstance(a, torch.Tensor) and a.dim() == 1
                else a for a in args]
        args[10] = z(9, c, c, dtype=BF)
    return args


@pytest.mark.parametrize("fault", ["float32", "strided", "misaligned",
                                   "past the cap"])
@pytest.mark.parametrize("name", BWD_KERNELS)
def test_bf16_backward_wrappers_refuse_before_launch(monkeypatch, name,
                                                     fault):
    """A bf16 backward wrapper given tensors declared on the card (the CPU
    tensors here) refuses a float32 operand (TypeError), a strided one,
    one off 16 bytes, and a C past the kernels' cap (ValueError), before
    it reaches a kernel (build.bind and build.sm_count patched to fail;
    the cap patched to 8 for the last)."""
    monkeypatch.setattr(build, "on_card", lambda what, t: True)

    def no_kernel(*a):
        raise AssertionError("reached the kernel")

    monkeypatch.setattr(build, "bind", no_kernel)
    monkeypatch.setattr(build, "sm_count", no_kernel)
    monkeypatch.setattr(tfb, "_bf_max_c",
                        lambda: 8 if fault == "past the cap" else 4096)
    fn = getattr(tfb, name + "_bf16")
    before = fn.launches
    err = TypeError if fault == "float32" else ValueError
    with pytest.raises(err):
        fn(*_bf16_bwd_args(name, None if fault == "past the cap" else fault))
    assert fn.launches == before


def test_bf16_bwd_mid_refuses_c_not_a_multiple_of_16(monkeypatch):
    """bwd_mid_bf16's 3x3 takes C in k16 steps: C 8 raises ValueError
    before any launch."""
    monkeypatch.setattr(build, "on_card", lambda what, t: True)
    monkeypatch.setattr(build, "bind", lambda *a: 1 / 0)
    with pytest.raises(ValueError, match="multiple of 16"):
        tfb.bwd_mid_bf16(*_bf16_bwd_args("bwd_mid", "C % 16"))
    assert tfb.bwd_mid_bf16.launches == 0


@pytest.mark.parametrize("kind,ma,mb,blocks", [
    ("reduce3", 256, 64, 2),      # ResNet-50's three chain stages
    ("reduce3", 512, 128, 4),
    ("reduce3", 1024, 256, 8),
    ("reduce3", 32, 16, 1),       # one tile past both ends
    ("reduce3", 48, 48, 1),
    ("reduce3", 128, 512, 2),     # C past 256: two 256-row tiles
    ("taps", 64, 64, 1),
    ("taps", 128, 128, 4),
    ("taps", 256, 256, 16),
    ("taps", 80, 80, 4),          # C 80: rows past C in the last tiles
    ("taps", 16, 16, 1),
    ("dw1", 64, 256, 2),          # dW1 (ma = C, mb = Cin) at the stages
    ("dw1", 128, 512, 4),
    ("dw1", 256, 1024, 8),
    ("dw1", 16, 48, 1),
])
def test_bf16_abt_blocks_tile_a_and_b(kind, ma, mb, blocks):
    """The blocks of a split of the bf16 backward's products over N·S:
    A's rows by B's rows in the tiles the kernels take (bwd_reduce3 on
    wgmma: 128 rows of Cin by 64, 128 or 256 of C; dW1 the same kernel's
    tiles of Cin by C; the taps on wgmma: 64 x 64, all nine taps a
    block), each row of A and B in exactly one tile."""
    got = tfb._bf_abw_tiles(kind, ma, mb)
    if kind == "dw1":
        bm = 64 if ma <= 64 else 128 if ma <= 128 else 256
        bn = 128
    else:
        bm = 128 if kind == "reduce3" else 64
        bn = 64 if kind == "taps" or mb <= 64 else 128 if mb <= 128 else 256
    assert got == blocks
    tiles = [(r, c) for r in range(0, ma, bm) for c in range(0, mb, bn)]
    covered = {(i, j) for r, c in tiles for i in range(r, min(r + bm, ma))
               for j in range(c, min(c + bn, mb))}
    assert len(covered) == ma * mb
    assert len(tiles) == blocks


@pytest.mark.parametrize("kind,blocks,n,s,splits", [
    ("abw", 2, 128, 3136, 66),     # bwd_reduce3 at 56², 28², 14²
    ("abw", 4, 128, 784, 33),
    ("abw", 8, 128, 196, 16),
    ("abw", 1, 128, 3136, 132),    # the taps at 56² and 14²
    ("abw", 16, 128, 196, 8),
    ("abw", 1, 1, 20, 1),          # N·S 20: one stage
    ("abw", 1, 3, 49, 3),          # three images of one stage each
    ("abw", 200, 2, 3136, 1),      # more tiles than SMs: one split
    ("dw1", (64, 256), 128, 3136, 66),    # dW1 on abw:: at the stages
    ("dw1", (128, 512), 128, 784, 33),
    ("dw1", (256, 1024), 128, 196, 16),
    ("dw1", (16, 32), 1, 20, 1),          # N·S 20: one stage
    ("dw1", (64, 128), 3, 49, 3),         # three images of one stage
])
def test_bf16_splits_cover_n_s(kind, blocks, n, s, splits):
    """The splits of a bf16 product over N·S on 132 SMs. The wgmma
    products ("abw": one block an SM; "dw1": bwd_final's dW1, its blocks
    the tiles of (C, Cin)): one wave that fills the SMs, at most one a
    64-position stage of an image and at most 1024. The entry points'
    rule (split p takes [p·P // splits, (p + 1)·P // splits) of the P
    stages) then covers every stage once, each split non-empty."""
    if kind == "dw1":
        blocks = tfb._bf_abw_tiles("dw1", *blocks)
    got = tfb._bf_abw_splits(blocks, n, s, 132)
    pieces = tfb._bf_stages(n, s)
    assert pieces == n * -(-s // 64)
    assert 1 <= got <= min(1024, pieces)
    assert got * blocks <= 132 or got == 1
    assert got == pieces or (got + 1) * blocks > 132
    assert got == splits
    runs = [(p * pieces // got, (p + 1) * pieces // got) for p in range(got)]
    assert all(a < b for a, b in runs)
    assert runs[0][0] == 0 and runs[-1][1] == pieces
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))


@pytest.mark.parametrize("m,k,n,s,rows,splits,lda", [
    (256, 64, 128, 3136, 256, 132, 64),    # rows 16b and 13b's dx at 56²,
    (512, 128, 128, 784, 256, 66, 128),    # 28² and 14²: all of Cout at
    (1024, 256, 128, 196, 128, 16, 256),   # 56², row tiles side by side
    (80, 80, 2, 81, 128, 4, 128),          # K 80: W padded to 128
    (384, 128, 2, 64, 256, 2, 128),        # M past 256
    (64, 16, 1, 20, 128, 1, 64),           # one stage; K 16 padded
])
def test_bf16_1x1_tile_grid(m, k, n, s, rows, splits, lda):
    """The bf16 1x1 tile's grid (csrc/conv1x1_bf16_tc.cuh): 256 rows of M
    a block where K <= 128 (so that at 56² one block holds all of Cout),
    else 128; its row tiles times one wave of splits of N·S's 64-position
    stages (as the wgmma products'); W padded with zero columns to whole
    64-column boxes."""
    assert tfb._bf_tile_rows(m, k) == rows
    tiles = -(-m // rows)
    assert tfb._bf_tile_splits(m, k, n, s, 132) == splits == \
        tfb._bf_abw_splits(tiles, n, s, 132)
    w = torch.arange(m * k, dtype=torch.float32).reshape(m, k).to(BF)
    wp, got = tfb._bf_tile_weight(w)
    assert got == lda and wp.shape == (m, lda) and wp.is_contiguous()
    assert torch.equal(wp[:, :k], w) and not bool(wp[:, k:].any())


@pytest.mark.parametrize("dtype,device,w,takes", [
    (BF, "cuda", 192, False),          # past bwd_mid_bf16's rows: composes
    (BF, "cuda", 191, True),
    (torch.float32, "cuda", 192, True),  # the float32 kernels take any W
    (BF, "cpu", 192, True),            # the CPU: the plain versions, as
    (torch.float32, "cpu", 192, True),  # before
])
def test_chain_gate_composes_bf16_rows_past_bwd_mid(monkeypatch, dtype,
                                                    device, w, takes):
    """The chain's gate from a shape, a dtype and a device type
    (fused_ops.chain_takes): on the card a bf16 block whose row is wider
    than bwd_mid_bf16 takes (chain_max_w, 191) composes, as one whose C
    is past the 1x1 kernels' does; a bf16 block at W 191 and a float32
    one at W 192 take the chain; the CPU takes all of them. The op asks
    once a call, so forward and backward agree. (The kernels' C caps are
    stubbed: there is no library here; they are asked only on the card,
    past the row check.)"""
    asked = []
    monkeypatch.setattr(tfb, "conv1x1_max_c", lambda dt: asked.append(dt)
                        or (256 if dt == BF else 704))
    assert tfb.chain_max_w(BF) == 191 and tfb.chain_max_w() is None
    assert tfo.chain_takes((8, 256, w, w), 64, dtype, device) is takes
    assert asked == ([dtype] if device == "cuda" and takes else [])
    assert not tfo.chain_takes((8, 256, w, w), 320, BF, "cuda")
    if device == "cpu":
        monkeypatch.setattr(tfo, "fused_block_enabled", lambda d: True)
        assert tfo._chain_takes(torch.zeros(8, 256, w, w, dtype=dtype),
                                torch.zeros(64, 256, 1, 1))


@pytest.mark.parametrize("n,s", [(128, 3136), (128, 784), (128, 196),
                                 (3, 49), (2, 390), (1, 20)])
def test_bf16_abw_splits_take_every_stage_once(n, s):
    """For every split count the wgmma products may take at N, S (1 to
    the stages), the kernels' rule (split p runs stages [p·Q // splits,
    (p + 1)·Q // splits) of the Q = N·ceil(S / 64)) gives every stage to
    exactly one split, each split non-empty, and each stage lies in one
    image (positions 64 i .. of image x // ceil(S / 64))."""
    stages = tfb._bf_stages(n, s)
    cpi = -(-s // 64)
    for splits in range(1, min(stages, 300) + 1):
        seen = [0] * stages
        for p in range(splits):
            lo, hi = p * stages // splits, (p + 1) * stages // splits
            assert lo < hi
            for x in range(lo, hi):
                seen[x] += 1
        assert seen == [1] * stages, splits
    assert all(0 <= (x % cpi) * 64 < s for x in range(stages))


# ---------------------------------------------------------------------------
# the chain's backward and the op's gradient, in bf16, against JAX
# ---------------------------------------------------------------------------

# the chain's gradients other than dx against JAX's, of max|jax|: the
# filters' (dW1, dtaps, dW3: bf16, or float32 masters whose gradient is a
# bf16 one widened) within one bf16 step at their largest element, the
# six dγ, dβ (float32) within BN_GRAD_RTOL. The largest readings over
# the cases of the two tests below: 3.68e-3 (the op's dW1: one element a
# step off, just under the largest) and 8.55e-4 (the op's dBias1: its
# sums take dX's flips); the four vjp cases read at most 7.4e-7. Zeroed
# tap gradients read 1.0 on dtaps, a da1 folded without its r1 0.48 on
# dW1 (and 3.9 times dx's limit): each fails
# (test_rest_bwd_in_bf16_limits_fail_planted_faults)
FILTER_GRAD_RTOL = 2.0 ** -7
BN_GRAD_RTOL = 2e-3


def _grad_share(got, want, name):
    """|got - want| max over its limit: FILTER_GRAD_RTOL max|want| for a
    filter (w1, taps, w3; W1-W3 of the op), else BN_GRAD_RTOL max|want|."""
    got, want = got.float(), want.float()
    rtol = FILTER_GRAD_RTOL if name.lower()[:1] == "w" \
        or name == "taps" else BN_GRAD_RTOL
    return float((got - want).abs().max()) / (rtol * float(
        want.abs().max()))


def _no_dtaps(*args):
    g1, dtaps, s, q = tfb.bwd_mid_reference(*args)
    return g1, torch.zeros_like(dtaps), s, q


def _no_r1(g3, g1, a1, x, p1, q1, r1, w1):
    return tfb.bwd_final_reference(g3, g1, a1, x, p1, q1,
                                   torch.zeros_like(r1), w1)


FAULTS = {"no tap gradients": ("bwd_mid_bf16", _no_dtaps),
          "no r1 in da1": ("bwd_final_bf16", _no_r1)}


def _rest_bwd_shares(shape, stat_cots):
    """FusedBottleneckRest on a bf16 block against jax.vjp of the JAX
    package's fused_bottleneck_rest on the same bf16 inputs and
    cotangents (out's bf16 and, with stat_cots, random ones on the six
    batch statistics): {leaf: its largest share of its limit}, dx's
    against the bf16 limit 2^-7 max|jax| + 2^-7 |jax|."""
    n, cin, c, h = shape
    d = _case(*shape, seed=17)
    args = [d[k] for k in CHAIN_ARGS]
    gen = torch.Generator().manual_seed(18)
    dout = torch.randn(n, cin, h * h, generator=gen).to(BF)
    widths = (c, c, c, c, cin, cin)
    cots = [torch.randn(k, generator=gen) if stat_cots else torch.zeros(k)
            for k in widths]
    jout, jvjp = __import__("jax").vjp(
        lambda *a: jfb.fused_bottleneck_rest(*a, h, EPS), *map(_j, args))
    want = jvjp((_j(dout),) + tuple(map(_j, cots)))
    leaves = [a.clone().requires_grad_(True) for a in args]
    outs = tfb.fused_bottleneck_rest(*leaves, h, EPS)
    torch.autograd.backward(outs, (dout,) + tuple(cots))
    assert outs[0].dtype == BF and leaves[0].grad.dtype == BF
    dx, wdx = leaves[0].grad.float(), _t(want[0]).float()
    shares = {"x": float(((dx - wdx).abs() / (
        BF16_REL * wdx.abs().max() + BF16_REL * wdx.abs())).max())}
    for name, leaf, w in zip(CHAIN_ARGS[1:], leaves[1:], want[1:]):
        assert leaf.grad.dtype == leaf.dtype, name
        shares[name] = _grad_share(leaf.grad, _t(w), name)
    return shares


@pytest.mark.parametrize("shape,stat_cots", [((2, 32, 16, 8), False),
                                             ((2, 32, 16, 8), True),
                                             ((8, 16, 8, 7), False),
                                             ((4, 64, 32, 6), True)])
def test_rest_bwd_in_bf16_matches_jax_vjp(interpret, shape, stat_cots):
    """FusedBottleneckRest on a bf16 block (the bf16 wrappers' plain
    versions, float32 BN folds) against jax.vjp of the JAX package's
    fused_bottleneck_rest (its custom VJP on the interpreted Pallas
    kernels) on the same bf16 inputs and cotangents: dx bf16 within the
    bf16 limit 2^-7 max|jax| + 2^-7 |jax|; dW1, dtaps, dW3 (bf16) within
    FILTER_GRAD_RTOL of max|jax| and the six dγ, dβ (float32) within
    BN_GRAD_RTOL of it."""
    shares = _rest_bwd_shares(shape, stat_cots)
    assert all(v <= 1 for v in shares.values()), shares


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_rest_bwd_in_bf16_limits_fail_planted_faults(interpret, monkeypatch,
                                                     fault):
    """The vjp test's limits fail a backward whose bwd_mid drops its tap
    gradients (dtaps reads 1.0 of max|jax|) and one whose bwd_final folds
    da1 without r1 (dW1 and dx move): each fault takes some leaf past its
    limit."""
    name, fn = FAULTS[fault]
    monkeypatch.setattr(tfb, name, fn)
    shares = _rest_bwd_shares((2, 32, 16, 8), True)
    assert any(v > 1 for v in shares.values()), shares


def test_op_gradient_in_bf16_through_the_chain_matches_jax(interpret,
                                                            monkeypatch):
    """With the gate open (as PT_FUSED_BLOCK=always on the card), the
    fused_bottleneck op sends a bf16 block with a gradient wanted through
    the chain; the gradients of one loss over Out (bf16 cotangents) of x,
    the three filters (float32 masters, cast to bf16 in the op) and the
    six BN scales and biases, against jax.grad of the JAX op through its
    Pallas chain (its _fused_block_enabled patched true): dX within the
    bf16 limit, W1-W3 within FILTER_GRAD_RTOL of max|jax|, the six
    scales and biases within BN_GRAD_RTOL of it."""
    import jax
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
    d = _case(n, cin, c, h, seed=19)
    w2 = d["taps"].float().reshape(3, 3, c, c).permute(2, 3, 0, 1)
    base = [d["x"].reshape(n, cin, h, h),
            d["w1"].float().reshape(c, cin, 1, 1), w2.contiguous(),
            d["w3"].float().reshape(cin, c, 1, 1)]
    bn = _bn_params(d, c, cin, seed=20)
    gen = torch.Generator().manual_seed(21)
    dvec = torch.randn(n, cin, h, h, generator=gen).to(BF)
    attrs = {"epsilon": EPS, "momentum": 0.9}
    names = ["X", "W1", "W2", "W3"] + [f"{s}{k}" for k in "123"
                                       for s in ("Scale", "Bias")]

    def j_loss(x, w1, w2_, w3, *sb):
        params = [(sb[2 * i], sb[2 * i + 1]) + tuple(map(_j, bn[i][2:]))
                  for i in range(3)]
        outs = jfo.fused_bottleneck(None, _op_ins(x, w1, w2_, w3, params),
                                    attrs)
        return (outs["Out"][0].astype("float32")
                * _j(dvec).astype("float32")).sum()

    jleaves = list(map(_j, base)) + [_j(v) for p in bn for v in p[:2]]
    want = jax.grad(j_loss, argnums=tuple(range(10)))(*jleaves)
    leaves = [t.clone().requires_grad_(True) for t in base] + [
        v.clone().requires_grad_(True) for p in bn for v in p[:2]]
    params = [(leaves[4 + 2 * i], leaves[5 + 2 * i]) + tuple(bn[i][2:])
              for i in range(3)]
    ctx = ExecContext(torch.Generator(), torch.device("cpu"))
    outs = require_op("fused_bottleneck").compute(
        ctx, _op_ins(*leaves[:4], params), attrs)
    (outs["Out"][0].float() * dvec.float()).sum().backward()
    assert calls == [BF]
    _hold_bf16(leaves[0].grad, _t(want[0]), "dX")
    shares = {name: _grad_share(leaf.grad, _t(w), name)
              for name, leaf, w in zip(names[1:], leaves[1:], want[1:])}
    assert all(v <= 1 for v in shares.values()), shares


# ---------------------------------------------------------------------------
# the slice: a Momentum step of a bf16 ResNet through the chain
# ---------------------------------------------------------------------------

STEP_LOSS_RTOL, BF16_SPREAD = 1e-2, 2.0


def _resnet_train(pkg, dtype="bfloat16", amp=False):
    """_resnet_forward's ResNet (a stem conv + BN + ReLU to 256 channels,
    two rest blocks of C 64, pool, fc) with a Momentum step, its data var
    of `dtype` (float32 masters either way), under amp_dtype "bfloat16"
    with amp. (main, startup, loss)."""
    layers = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 4
    with pkg.program_guard(main, startup):
        x = layers.data("data", [3, RES_IMAGE, RES_IMAGE], dtype=dtype)
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
        pkg.optimizer.MomentumOptimizer(learning_rate=0.1,
                                        momentum=0.9).minimize(loss)
    if amp:
        main.amp_dtype = "bfloat16"
    return main, startup, loss


def _train_feed(seed):
    rng = np.random.RandomState(seed)
    return {"data": rng.rand(RES_BATCH, 3, RES_IMAGE, RES_IMAGE)
            .astype(np.float32) - 0.5,
            "label": rng.randint(0, RES_CLASSES, (RES_BATCH, 1))
            .astype(np.int64)}


def _distance(got, want):
    """(largest, median) relative rms of each var's update against
    want's, over the vars want moves."""
    rel = [float((got[n] - w).norm() / w.norm()) for n, w in want.items()
           if w.norm() > 0]
    return max(rel), float(np.median(rel))


@pytest.mark.parametrize("fault", [None, "no tap gradients"])
def test_bf16_momentum_step_through_the_chain_matches_composition(
        monkeypatch, fault):
    """The slice on the CPU: one Momentum step of a bf16 ResNet whose two
    rest blocks the gate takes, from one startup state, through the chain
    (PT_FUSED_BLOCK=always; the gate patched to follow it, CHAIN_MIN_S
    down to the image) and composed, beside the same program in float32
    composed from the same state: both blocks through the chain in bf16,
    every master float32; the chain's loss within STEP_LOSS_RTOL of the
    float32 loss, and its updates (parameters, velocities, running
    stats; the largest and the median relative rms over the vars) within
    BF16_SPREAD times the bf16 composition's distance from float32 (0.19
    and 0.11 here: bf16's own spread at init). A chain whose bwd_mid
    drops its tap gradients fails."""
    monkeypatch.setattr(tfo, "fused_block_enabled",
                        lambda device: tfo.chain_requested())
    monkeypatch.setattr(tfo, "CHAIN_MIN_S", 16)
    if fault:
        monkeypatch.setattr(tfb, "bwd_mid_bf16", _no_dtaps)
    chained = []
    chain = tfo._chain_block
    monkeypatch.setattr(tfo, "_chain_block",
                        lambda *a: chained.append(a[0].dtype) or chain(*a))
    feed = _train_feed(22)
    got, start = {}, None
    for what, dtype, mode in (("float32", "float32", "never"),
                              ("bf16", "bfloat16", "never"),
                              ("chain", "bfloat16", "always")):
        tprog.reset_unique_names()
        main, startup, loss = _resnet_train(pt, dtype)
        exe = pt.Executor(pt.CPUPlace())
        if start is None:
            scope0 = pt.Scope()
            exe.run(startup, scope=scope0)
            start = {n: scope0.find_var(n).clone()
                     for n in scope0.local_var_names()}
        monkeypatch.setenv("PT_FUSED_BLOCK", mode)
        scope = pt.Scope()
        for n, v in start.items():
            scope.set_var(n, v.clone())
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        got[what] = (float(np.asarray(out).ravel()[0]),
                     {n: scope.find_var(n).double() - v.double()
                      for n, v in start.items()})
        assert all(scope.find_var(n).dtype == torch.float32
                   for n, v in start.items() if v.is_floating_point())
    assert chained == [BF, BF]
    f32_loss, f32_up = got["float32"]
    chain_loss = got["chain"][0]
    spread = _distance(got["bf16"][1], f32_up)
    dist = _distance(got["chain"][1], f32_up)
    ok = (np.isfinite(chain_loss)
          and abs(chain_loss - f32_loss) <= STEP_LOSS_RTOL * abs(f32_loss)
          and all(d <= BF16_SPREAD * r for d, r in zip(dist, spread)))
    assert ok == (fault is None), (chain_loss, f32_loss, dist, spread)


def test_amp_step_through_the_chain_trains(monkeypatch):
    """An AMP program with a backward over fused_bottleneck builds and
    trains with PT_FUSED_BLOCK=always (the chain has bfloat16 kernels
    forward and backward): the float32 ResNet above under amp_dtype
    "bfloat16", its gate open on the CPU (the plain versions in bf16):
    both blocks through the chain in bf16, two steps with finite losses,
    every master float32 and moved."""
    monkeypatch.setenv("PT_FUSED_BLOCK", "always")
    monkeypatch.setattr(tfo, "fused_block_enabled", lambda device: True)
    monkeypatch.setattr(tfo, "CHAIN_MIN_S", 16)
    chained = []
    chain = tfo._chain_block
    monkeypatch.setattr(tfo, "_chain_block",
                        lambda *a: chained.append(a[0].dtype) or chain(*a))
    tprog.reset_unique_names()
    main, startup, loss = _resnet_train(pt, "float32", amp=True)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block.all_parameters()]
    start = {n: scope.find_var(n).clone() for n in params}
    losses = [float(np.asarray(exe.run(main, feed=_train_feed(23 + i),
                                       fetch_list=[loss], scope=scope)[0])
                    .ravel()[0]) for i in range(2)]
    assert chained == [BF, BF] * 2
    assert all(np.isfinite(losses))
    for n in params:
        v = scope.find_var(n)
        assert v.dtype == torch.float32, n
        assert not torch.equal(v, start[n]), n
