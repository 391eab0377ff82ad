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
and the JAX package's ``_compose_block``. Inputs come from a numpy seed:
N 2-8, Cin 16-32, C 8, H 7 and 8 (S 49 and 64), BN shifts that are not
zero, so the 3x3's zero padding of h (not of a1) shows at every edge.

Tolerances: float32 on both sides, sums in other orders. Forward outputs
within atol = rtol = 1e-5; sums within 1e-5 of the sum of their terms'
magnitudes; M2 (of h >= 0) within rtol 1e-5; gradients within 1e-4 of
each gradient's largest entry; the chain against the composition within
2e-5 (it takes its variances as E[a²] - m², bn3's analytically through
W3, where the composition reduces the materialized tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import fused_block as jfb
from paddle_tpu.ops import fused_ops as jfo

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


@pytest.mark.parametrize("name,n_args", [("bwd_reduce3", 5),
                                         ("bwd_apply3", 9), ("bwd_mid", 12),
                                         ("bwd_final", 8)])
def test_backward_wrappers_raise_on_the_card(monkeypatch, name, n_args):
    """The backward kernels are not ported: a wrapper given a card tensor
    raises NotImplementedError naming them (simulated here by declaring
    the CPU tensor on the card)."""
    monkeypatch.setattr(build, "on_card", lambda what, t: True)
    z = torch.zeros(1, 1, 1)
    with pytest.raises(NotImplementedError, match="rows 10-13"):
        getattr(tfb, name)(*([z] * n_args))


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
