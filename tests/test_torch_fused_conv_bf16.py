"""The bfloat16 conv epilogue of the port (kernels/fused_conv.py) against
the JAX package on the CPU.

Inputs come from a numpy seed and are rounded to bfloat16 on both sides
(ml_dtypes on the JAX side, the same bits on the port's). The plain
versions of the three bfloat16 kernels are held against the JAX
package's Pallas kernels run by the Pallas interpreter
(``paddle_tpu.kernels.fused_conv.INTERPRET``, patched for the test) at
shapes with S = 49 and 35 and C·S not a multiple of 8 (the kernels' rows
then start off 16-byte alignment): apply, with and without the addend
and the ReLU, bit for bit (both compute a·scale + shift as one fused
multiply-add in float32, add the addend and round once to bfloat16); the
float32 sums of the stats, whose order differs, within STATS_RTOL of the
sum of their terms' magnitudes.

``FusedConvEpilogue`` is held against ``fused_conv_epilogue``'s custom
VJP in bfloat16 (a and the addend bfloat16; the BN scale and bias
float32 as in a bfloat16 program, or bfloat16 as under AMP) under one
weighted loss over all five outputs, and ``reference_epilogue`` against
the JAX package's ``_reference_epilogue`` (``_bn_train``). Limits: y, the
addend's and a's gradients (bfloat16) within 2^-7 max|jax| + 2^-7 |jax|,
bfloat16's unit roundoff being 2^-8 (the two packages' statistics are
float32 sums in other orders, so scale and shift differ in their last
bits and an element can round to the neighbouring bfloat16 value; the
composition rounds after each of its bfloat16 ops in eager PyTorch,
where XLA on the CPU keeps the chain in float32); the statistics and the
float32 gradients of the BN's scale and bias within atol = rtol = 1e-4
(sums over N·S of products of the same bfloat16 cotangent).

Then the CUDA kernels' plans in bfloat16, emulated in numpy: 8 elements
a thread, each element of a added once into its own channel, the stats'
order within STATS_RTOL of the plain version and of float64, and the
apply kernel's channel map; and what the wrappers refuse before any
launch.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import fused_conv as jfc

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import fused_conv as tfc

torch.set_num_threads(2)

STATS_RTOL = 1e-5
BF16_REL = 2.0 ** -7
F32 = dict(atol=1e-4, rtol=1e-4)
WEIGHTS = (1.0, 0.3, 0.3, 0.2, 0.2)
# S = 49, 35, 35; C·S = 147, 140, 175: no row a multiple of 8 elements
SHAPES = [(2, 3, 7, 7), (3, 4, 5, 7), (2, 5, 5, 7)]


def _bf16(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


def _t(x: np.ndarray) -> torch.Tensor:
    """A numpy array as a torch tensor, bfloat16 by its bits."""
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x).astype(np.float32)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _hold_bf16(got, want, what=""):
    got, want = _np(got), _np(want)
    limit = BF16_REL * np.abs(want).max() + BF16_REL * np.abs(want)
    assert np.all(np.abs(got - want) <= limit), \
        f"{what}: {np.abs(got - want).max():.3e} beyond the bf16 limit"


def _case(shape, seed=0, params="float32"):
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    p = _bf16 if params == "bfloat16" else (lambda x: x)
    return dict(a=_bf16(rng.standard_normal(shape) + 0.3),
                add=_bf16(rng.standard_normal(shape)),
                g=p(np.linspace(0.5, 1.5, c).astype(np.float32)),
                b=p(np.linspace(-0.1, 0.1, c).astype(np.float32)),
                rm=rng.standard_normal(c).astype(np.float32) * 0.1,
                rv=rng.uniform(0.5, 1.5, c).astype(np.float32))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfc, "INTERPRET", True)


@pytest.mark.parametrize("shape", SHAPES)
def test_channel_stats_bf16_plain_matches_pallas(interpret, shape):
    n, c, h, w = shape
    a = _case(shape)["a"].reshape(n, c, h * w)
    want = jfc.channel_stats(jnp.asarray(a))
    got = tfc.channel_stats_bf16(_t(a))
    af = a.astype(np.float64)
    terms = (np.abs(af).sum(axis=(0, 2)), (af * af).sum(axis=(0, 2)))
    for x, y, m in zip(got, want, terms):
        assert x.dtype == torch.float32
        assert np.all(np.abs(x.numpy() - np.asarray(y)) <= STATS_RTOL * m)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_apply_bf16_plain_matches_pallas_bit_for_bit(interpret, shape,
                                                     with_add, relu):
    n, c, h, w = shape
    d = _case(shape, 1)
    a = d["a"].reshape(n, c, h * w)
    add = d["add"].reshape(n, c, h * w) if with_add else None
    sc, sh = d["g"] * 1.7, d["b"] - 0.2
    want = jfc.apply_epilogue(jnp.asarray(a), jnp.asarray(sc),
                              jnp.asarray(sh),
                              None if add is None else jnp.asarray(add), relu)
    if with_add:
        got = tfc.apply_epilogue_add_bf16(_t(a), _t(sc), _t(sh), _t(add),
                                          relu)
    else:
        got = tfc.apply_epilogue_bf16(_t(a), _t(sc), _t(sh), relu)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_f32_wrappers_hand_bf16_to_the_bf16_plain_versions():
    """On the CPU the float32 wrappers and the bfloat16 ones give the same
    bits for a bfloat16 a, and no wrapper counts a launch."""
    names = ("channel_stats", "apply_epilogue", "apply_epilogue_add",
             "channel_stats_bf16", "apply_epilogue_bf16",
             "apply_epilogue_add_bf16")
    before = [getattr(tfc, k).launches for k in names]
    d = _case(SHAPES[0], 2)
    a, add = _t(d["a"].reshape(2, 3, 49)), _t(d["add"].reshape(2, 3, 49))
    sc, sh = _t(d["g"]), _t(d["b"])
    for x, y in zip(tfc.channel_stats(a), tfc.channel_stats_bf16(a)):
        assert torch.equal(x, y)
    assert torch.equal(tfc.apply_epilogue(a, sc, sh).view(torch.int16),
                       tfc.apply_epilogue_bf16(a, sc, sh).view(torch.int16))
    assert torch.equal(
        tfc.apply_epilogue_add(a, sc, sh, add).view(torch.int16),
        tfc.apply_epilogue_add_bf16(a, sc, sh, add).view(torch.int16))
    assert [getattr(tfc, k).launches for k in names] == before


def _jax_grads(fn, d, with_add, relu):
    def loss(a, g, b, rm, rv, add):
        outs = fn(a, g, b, rm, rv, add if with_add else None, 1e-5, 0.9,
                  relu)
        return sum(jnp.sum(o.astype(jnp.float32) * w)
                   for o, w in zip(outs, WEIGHTS)), outs

    argnums = (0, 1, 2, 3, 4) + ((5,) if with_add else ())
    (_, outs), grads = jax.value_and_grad(loss, argnums=argnums,
                                          has_aux=True)(
        *(jnp.asarray(d[k]) for k in ("a", "g", "b", "rm", "rv", "add")))
    return list(outs), list(grads)


def _torch_grads(fn, d, with_add, relu):
    keys = ("a", "g", "b", "rm", "rv") + (("add",) if with_add else ())
    leaves = {k: _t(d[k]).requires_grad_(True) for k in keys}
    outs = fn(leaves["a"], leaves["g"], leaves["b"], leaves["rm"],
              leaves["rv"], leaves.get("add"), 1e-5, 0.9, relu)
    sum((o.float() * w).sum() for o, w in zip(outs, WEIGHTS)).backward()
    return [o.detach() for o in outs], [leaves[k].grad for k in keys]


def _hold_epilogue(got, want, with_add):
    (gy, *gstats), grads = got
    (wy, *wstats), wgrads = want
    assert gy.dtype == torch.bfloat16 and wy.dtype == jnp.bfloat16
    _hold_bf16(gy, wy, "y")
    for x, y in zip(gstats, wstats):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(_np(x), _np(y), **F32)
    keys = ("a", "g", "b", "rm", "rv") + (("add",) if with_add else ())
    for k, x, y in zip(keys, grads, wgrads):
        assert str(x.dtype).rsplit(".", 1)[-1] == str(y.dtype), k
        if k in ("a", "add"):
            _hold_bf16(x, y, f"d{k}")
        else:
            np.testing.assert_allclose(_np(x), _np(y), err_msg=k, **F32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("params", ["float32", "bfloat16"])
def test_fused_conv_epilogue_bf16_matches_pallas_vjp(interpret, shape,
                                                     with_add, relu, params):
    """FusedConvEpilogue (the bf16 plain versions on the CPU) against the
    Pallas-backed custom VJP in bfloat16: forward and every gradient."""
    d = _case(shape, 3, params)
    _hold_epilogue(_torch_grads(tfc.fused_conv_epilogue, d, with_add, relu),
                   _jax_grads(jfc.fused_conv_epilogue, d, with_add, relu),
                   with_add)


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("params", ["float32", "bfloat16"])
def test_reference_epilogue_bf16_matches_jax(shape, with_add, params):
    """The PT_FUSE_EPILOGUE=never composition (_bn_train) in bfloat16
    against the JAX package's, forward and backward."""
    d = _case(shape, 4, params)
    _hold_epilogue(_torch_grads(tfc.reference_epilogue, d, with_add, True),
                   _jax_grads(jfc._reference_epilogue, d, with_add, True),
                   with_add)


# ---------------------------------------------------------------------------
# the bfloat16 kernels' plans, emulated in numpy
# ---------------------------------------------------------------------------
#
# csrc/fused_conv.cu's bfloat16 instances read a [N, C, S] as N rows of
# C·S elements cut into column ranges of 8·lanes: a thread owns 8 columns
# (one 16-byte vector, or 8 scalars 32 apart where C·S % 8 != 0). The
# emulation follows the stats kernel step for step in float32 with the
# plan the wrapper takes (``_stats_plan(..., per=8)``).

# (N, C, S, SMs the plan is made for): S = 49, 196, 7, 3, 1, 35; C·S % 8
# != 0 (rows read as scalars); row slices; more than one ticket; lanes
# 32-256
PLAN_CASES = [(4, 8, 49, 2), (40, 4, 49, 8), (6, 12, 196, 1),
              (16, 64, 196, 2), (24, 8, 7, 4), (9, 5, 3, 2), (7, 12, 1, 2),
              (3, 7, 13, 2), (2, 300, 5, 1), (5, 3, 35, 2),
              (64, 64, 64, 1)]
PER = 8


def _butterfly(v):
    """The result of a warp's __shfl_xor_sync tree over its lanes."""
    v = v.copy()
    o = len(v) // 2
    while o:
        v = (v + v[np.arange(len(v)) ^ o]).astype(np.float32)
        o //= 2
    return v[0]


def _fma(x, y, z):
    return np.float32(np.float64(x) * np.float64(y) + np.float64(z))


def _columns(lane, lanes, vec):
    return [PER * lane + i if vec else lane + lanes * i for i in range(PER)]


def _emulate_stats(a, lanes, rows):
    """(Σa, Σa²) of a [N, C, S] (bfloat16 values in float32) as the
    bfloat16 stats kernel adds them."""
    n, c, s = a.shape
    cs, e, groups = c * s, PER * lanes, 256 // lanes
    ranges, parts = -(-cs // e), -(-n // rows)
    flat = a.reshape(n, cs)
    part = np.zeros((2, parts, ranges + c), np.float32)
    for p in range(parts):
        n1 = min(n, (p + 1) * rows)
        for b in range(ranges):
            e0, e1 = b * e, min(b * e + e, cs)
            s1 = np.zeros((groups, e), np.float32)
            s2 = np.zeros((groups, e), np.float32)
            for r in range(groups):
                for m in range(p * rows + r, n1, groups):
                    v = np.zeros(e, np.float32)
                    v[:e1 - e0] = flat[m, e0:e1]
                    s1[r] = (s1[r] + v).astype(np.float32)
                    s2[r] = np.array([_fma(x, x, y) for x, y in
                                      zip(v, s2[r])], np.float32)
            col1, col2 = s1[0].copy(), s2[0].copy()
            for r in range(1, groups):
                col1 = (col1 + s1[r]).astype(np.float32)
                col2 = (col2 + s2[r]).astype(np.float32)
            for ch in range(e0 // s, (e1 - 1) // s + 1):
                lo, hi = max(e0, ch * s) - e0, min(e1, (ch + 1) * s) - e0
                for k, col in enumerate((col1, col2)):
                    lane = np.zeros(32, np.float32)
                    for j in range(lo, hi):
                        lane[(j - lo) % 32] += col[j]
                    part[k, p, b + ch] = _butterfly(lane)
    out = np.zeros((2, c), np.float32)
    for g in range(-(-c // 256)):
        nch = min(c - 256 * g, 256)
        tpc = 1
        while tpc < 32 and 2 * tpc * nch <= 256:
            tpc *= 2
        for ch in range(256 * g, 256 * g + nch):
            b_lo = ch * s // e
            nbc = ((ch + 1) * s - 1) // e - b_lo + 1
            for k in range(2):
                sub = np.zeros(tpc, np.float32)
                for q in range(nbc * parts):
                    sub[q % tpc] += part[k, q // nbc, b_lo + q % nbc + ch]
                out[k, ch] = _butterfly(sub) if tpc > 1 else sub[0]
    return out[0], out[1]


@pytest.mark.parametrize("n,c,s,sms", PLAN_CASES)
def test_bf16_stats_order_covers_each_element_once(n, c, s, sms):
    """Every element is added once, into its own channel: with a = 1 each
    channel counts N·S, with a = its channel + 1 it sums (c + 1)·N·S."""
    lanes, rows, _ = tfc._stats_plan(n, c, s, sms, PER)
    chan = np.broadcast_to(np.arange(c, dtype=np.float32)[None, :, None],
                           (n, c, s))
    count, _ = _emulate_stats(np.ones((n, c, s), np.float32), lanes, rows)
    total, _ = _emulate_stats(chan + 1, lanes, rows)
    np.testing.assert_array_equal(count, np.full(c, n * s, np.float32))
    np.testing.assert_array_equal(total, (np.arange(c) + 1.0) * n * s)


@pytest.mark.parametrize("n,c,s,sms", PLAN_CASES)
def test_bf16_stats_order_matches_plain_and_float64(n, c, s, sms):
    """The bfloat16 kernel's order gives Σa and Σa² within STATS_RTOL of
    the sum of their terms' magnitudes, against the plain version and
    against float64, on bfloat16 inputs."""
    a = _bf16(np.random.default_rng(n * c + s).standard_normal((n, c, s))
              + 0.5)
    lanes, rows, _ = tfc._stats_plan(n, c, s, sms, PER)
    got = _emulate_stats(a.astype(np.float32), lanes, rows)
    plain = [x.numpy() for x in tfc.channel_stats_bf16(_t(a))]
    a64 = a.astype(np.float64)
    exact = (a64.sum(axis=(0, 2)), (a64 * a64).sum(axis=(0, 2)))
    terms = (np.abs(a64).sum(axis=(0, 2)), exact[1])
    for g, p, x, t in zip(got, plain, exact, terms):
        assert np.all(np.abs(g - p) <= STATS_RTOL * t)
        assert np.all(np.abs(g - x) <= STATS_RTOL * t)


@pytest.mark.parametrize("n,c,s,sms", PLAN_CASES)
def test_bf16_apply_channel_map_is_exact(n, c, s, sms):
    """The bfloat16 apply kernel's blocks, row groups and threads reach
    every element once, and each thread's 8 columns take the channel the
    element has."""
    lanes, rows = tfc._apply_plan(n, c, s, sms, PER)
    cs, e, groups = c * s, PER * lanes, 256 // lanes
    vec = cs % PER == 0
    seen = np.zeros((n, cs), np.int64)
    chan = np.full((n, cs), -1)
    for b in range(-(-cs // e)):
        for p in range(-(-n // rows)):
            n1 = min(n, (p + 1) * rows)
            for r in range(groups):
                for lane in range(lanes):
                    cols = [b * e + x for x in _columns(lane, lanes, vec)]
                    for col in (x for x in cols if x < cs):
                        for m in range(p * rows + r, n1, groups):
                            seen[m, col] += 1
                            chan[m, col] = col // s
    assert np.all(seen == 1)
    exact = np.broadcast_to(np.arange(c)[:, None], (c, s)).reshape(cs)
    np.testing.assert_array_equal(chan, np.broadcast_to(exact, (n, cs)))


@pytest.mark.parametrize("n,c,s,sms", PLAN_CASES + [
    (128, 64, 12544, 132), (128, 512, 49, 132), (128, 2048, 49, 132),
    (128, 256, 196, 132), (70000, 4, 4, 132)])
def test_bf16_plans_fit_the_kernels(n, c, s, sms):
    """The bfloat16 plans the wrappers pass are ones the entry points
    take: lanes of the built instances (32 where C·S % 8 != 0), grid
    dimensions in range, the partials the kernel indexes."""
    lanes, rows, partials = tfc._stats_plan(n, c, s, sms, PER)
    alanes, arows = tfc._apply_plan(n, c, s, sms, PER)
    for ln in (lanes, alanes):
        assert ln in ((32, 64, 128, 256) if c * s % PER == 0 else (32,))
    ranges = -(-c * s // (PER * lanes))
    assert partials == -(-n // rows) * (ranges + c)
    assert -(-n // rows) <= 65535 and -(-n // arows) <= 65535
    assert -(-n // rows) == 1 or ranges < 2 * sms


@pytest.mark.parametrize("fault", ["float16", "addend_f32", "a_f32_add_bf16",
                                   "scale_bf16"])
def test_wrappers_refuse_before_any_launch(fault, monkeypatch):
    """On the card (here: build.on_card patched true, build.bind patched
    to fail) a dtype the kernels do not take raises TypeError in the
    wrapper's checks, before a plan is made or an entry point bound:
    float16; a bfloat16 a with a float32 addend (and the reverse); a
    bfloat16 scale."""
    def no_launch(*a, **k):
        raise AssertionError("an entry point was bound")

    monkeypatch.setattr(build, "on_card", lambda name, t: True)
    monkeypatch.setattr(build, "bind", no_launch)
    monkeypatch.setattr(tfc, "_plans", no_launch)
    a = torch.zeros(2, 3, 8, dtype=torch.bfloat16)
    sc = torch.ones(3)
    with pytest.raises(TypeError):
        if fault == "float16":
            tfc.channel_stats(a.half())
        elif fault == "addend_f32":
            tfc.apply_epilogue_add(a, sc, sc, a.float())
        elif fault == "a_f32_add_bf16":
            tfc.apply_epilogue_add(a.float(), sc, sc, a)
        else:
            tfc.apply_epilogue(a, sc.bfloat16(), sc)
