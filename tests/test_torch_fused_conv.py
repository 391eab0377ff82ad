"""The conv epilogue of the port (kernels/fused_conv.py, ops/nn_ops.py
``_bn_train``) against the JAX package on the CPU.

The plain versions of the three kernels are held against the JAX
package's Pallas kernels run by the Pallas interpreter
(``paddle_tpu.kernels.fused_conv.INTERPRET``, patched for the test), and
``FusedConvEpilogue`` and ``_bn_train`` against ``fused_conv_epilogue``
and ``_bn_train``, forward and backward, under one weighted loss over
all five outputs (the statistics' cotangents included). Shapes include
S = 49 and 35, which are not multiples of 4, as at the 7x7 stage.

Tolerances: float32 on both sides, sums in other orders: forward
outputs within atol = rtol = 1e-5, gradients within 1e-4 (each sums
over N·S products of the upstream gradient).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import fused_conv as jfc
from paddle_tpu.ops import nn_ops as jnn

from paddle_tpu_torch.kernels import fused_conv as tfc
from paddle_tpu_torch.ops import nn_ops as tnn

torch.set_num_threads(2)

FWD = dict(atol=1e-5, rtol=1e-5)
BWD = dict(atol=1e-4, rtol=1e-4)
WEIGHTS = (1.0, 0.3, 0.3, 0.2, 0.2)
SHAPES = [(2, 3, 7, 7), (3, 4, 5, 7), (2, 8, 4, 4)]


def _case(shape, seed=0):
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    return dict(a=rng.standard_normal(shape).astype(np.float32) + 0.3,
                add=rng.standard_normal(shape).astype(np.float32),
                g=np.linspace(0.5, 1.5, c).astype(np.float32),
                b=np.linspace(-0.1, 0.1, c).astype(np.float32),
                rm=rng.standard_normal(c).astype(np.float32) * 0.1,
                rv=rng.uniform(0.5, 1.5, c).astype(np.float32))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfc, "INTERPRET", True)


@pytest.mark.parametrize("shape", SHAPES)
def test_channel_stats_plain_matches_pallas(interpret, shape):
    n, c, h, w = shape
    a = _case(shape)["a"].reshape(n, c, h * w)
    want = jfc.channel_stats(jnp.asarray(a))
    got = tfc.channel_stats(torch.from_numpy(a))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **FWD)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_apply_plain_matches_pallas(interpret, shape, with_add, relu):
    n, c, h, w = shape
    d = _case(shape, 1)
    a = d["a"].reshape(n, c, h * w)
    add = d["add"].reshape(n, c, h * w) if with_add else None
    sc, sh = d["g"] * 1.7, d["b"] - 0.2
    want = jfc.apply_epilogue(jnp.asarray(a), jnp.asarray(sc),
                              jnp.asarray(sh),
                              None if add is None else jnp.asarray(add), relu)
    ta, tsc, tsh = (torch.from_numpy(x) for x in (a, sc, sh))
    if with_add:
        got = tfc.apply_epilogue_add(ta, tsc, tsh, torch.from_numpy(add),
                                     relu)
    else:
        got = tfc.apply_epilogue(ta, tsc, tsh, relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_wrappers_on_the_cpu_count_no_launch():
    before = (tfc.channel_stats.launches, tfc.apply_epilogue.launches,
              tfc.apply_epilogue_add.launches)
    a = torch.ones(2, 3, 5)
    tfc.channel_stats(a)
    tfc.apply_epilogue(a, torch.ones(3), torch.zeros(3))
    tfc.apply_epilogue_add(a, torch.ones(3), torch.zeros(3), a)
    assert (tfc.channel_stats.launches, tfc.apply_epilogue.launches,
            tfc.apply_epilogue_add.launches) == before


def _jax_grads(fn, d, with_add, relu):
    def loss(a, g, b, rm, rv, add):
        outs = fn(a, g, b, rm, rv, add if with_add else None, 1e-5, 0.9,
                  relu)
        return sum(jnp.sum(o * w) for o, w in zip(outs, WEIGHTS)), outs

    argnums = (0, 1, 2, 3, 4) + ((5,) if with_add else ())
    (_, outs), grads = jax.value_and_grad(loss, argnums=argnums,
                                          has_aux=True)(
        *(jnp.asarray(d[k]) for k in ("a", "g", "b", "rm", "rv", "add")))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _torch_grads(fn, d, with_add, relu):
    keys = ("a", "g", "b", "rm", "rv") + (("add",) if with_add else ())
    leaves = {k: torch.from_numpy(d[k]).requires_grad_(True) for k in keys}
    outs = fn(leaves["a"], leaves["g"], leaves["b"], leaves["rm"],
              leaves["rv"], leaves.get("add"), 1e-5, 0.9, relu)
    sum((o * w).sum() for o, w in zip(outs, WEIGHTS)).backward()
    return ([o.detach().numpy() for o in outs],
            [leaves[k].grad.numpy() for k in keys])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_fused_conv_epilogue_matches_pallas_vjp(interpret, shape, with_add,
                                                relu):
    """FusedConvEpilogue (the kernels' plain versions on the CPU) against
    the Pallas-backed custom VJP, forward and every gradient."""
    d = _case(shape, 2)
    want_out, want_g = _jax_grads(jfc.fused_conv_epilogue, d, with_add, relu)
    got_out, got_g = _torch_grads(tfc.fused_conv_epilogue, d, with_add, relu)
    for x, y in zip(got_out, want_out):
        np.testing.assert_allclose(x, y, **FWD)
    for x, y in zip(got_g, want_g):
        np.testing.assert_allclose(x, y, **BWD)


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("with_add", [False, True])
def test_reference_epilogue_matches_jax(shape, with_add):
    """The PT_FUSE_EPILOGUE=never composition against the JAX package's
    _reference_epilogue, forward and backward."""
    d = _case(shape, 3)
    want_out, want_g = _jax_grads(jfc._reference_epilogue, d, with_add, True)
    got_out, got_g = _torch_grads(tfc.reference_epilogue, d, with_add, True)
    for x, y in zip(got_out, want_out):
        np.testing.assert_allclose(x, y, **FWD)
    for x, y in zip(got_g, want_g):
        np.testing.assert_allclose(x, y, **BWD)


@pytest.mark.parametrize("shape", [(2, 3, 7, 7), (4, 5)])
@pytest.mark.parametrize("relu", [False, True])
def test_bn_train_matches_jax(shape, relu):
    """BatchNormTrain against the JAX package's _bn_train custom VJP, on
    an NCHW and a 2-D input."""
    d = _case(shape + (1,) * (4 - len(shape)), 4)
    d["a"] = d["a"].reshape(shape)

    def jfn(a, g, b, rm, rv, add, eps, mom, r):
        return jnn._bn_train(a, g, b, rm, rv, eps, mom, r)

    def tfn(a, g, b, rm, rv, add, eps, mom, r):
        return tnn._bn_train(a, g, b, rm, rv, eps, mom, r)

    want_out, want_g = _jax_grads(jfn, d, False, relu)
    got_out, got_g = _torch_grads(tfn, d, False, relu)
    for x, y in zip(got_out, want_out):
        np.testing.assert_allclose(x, y, **FWD)
    for x, y in zip(got_g, want_g):
        np.testing.assert_allclose(x, y, **BWD)


def test_stat_outputs_off_the_loss_need_no_cotangent():
    """In a training step the statistics feed state, not the loss: their
    grads arrive as None, and the input gradient equals the one a zero
    cotangent gives."""
    d = _case((2, 3, 7, 7), 5)
    a = torch.from_numpy(d["a"]).requires_grad_(True)
    args = [torch.from_numpy(d[k]) for k in ("g", "b", "rm", "rv")]
    y = tfc.fused_conv_epilogue(a, *args, None, 1e-5, 0.9, True)[0]
    (y * 2.0).sum().backward()
    a2 = torch.from_numpy(d["a"]).requires_grad_(True)
    outs = tfc.fused_conv_epilogue(a2, *args, None, 1e-5, 0.9, True)
    ((outs[0] * 2.0).sum() + sum((o * 0.0).sum() for o in outs[1:])
     ).backward()
    np.testing.assert_allclose(a.grad.numpy(), a2.grad.numpy(), **FWD)


def test_epilogue_gate(monkeypatch):
    monkeypatch.delenv("PT_FUSE_EPILOGUE", raising=False)
    assert tfc.epilogue_enabled()
    for off in ("never", "0"):
        monkeypatch.setenv("PT_FUSE_EPILOGUE", off)
        assert not tfc.epilogue_enabled()


# ---------------------------------------------------------------------------
# the CUDA kernels' index maps and summation order, emulated in numpy
# ---------------------------------------------------------------------------
#
# csrc/fused_conv.cu reads a [N, C, S] as N rows of C·S floats cut into
# column ranges of 4·lanes floats; a block (b, p) takes range b over row
# slice p, its 256 threads in 256 / lanes row groups. The emulation below
# follows the stats kernel step for step in float32 (each thread down its
# rows, the row groups in order, a warp per channel segment with its
# shuffle tree, then the ticket holder's pass over the partials, slice
# by slice), with the plan the wrapper takes (``_stats_plan``).

STATS_RTOL = 1e-5
# (N, C, S, SMs the plan is made for): S = 49, 196, 7, 3, 1; C*S % 4 != 0
# (rows read as scalars); row slices; more than one ticket; lanes 32-256
PLAN_CASES = [(4, 8, 49, 2), (40, 4, 49, 8), (6, 12, 196, 1),
              (16, 64, 196, 2), (24, 8, 7, 4), (9, 5, 3, 2), (7, 12, 1, 2),
              (3, 7, 13, 2), (2, 300, 5, 1), (5, 3, 196, 2)]


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


def _emulate_stats(a, lanes, rows):
    """(Σa, Σa²) of a [N, C, S] float32 as the stats kernel adds them."""
    n, c, s = a.shape
    cs, e, groups = c * s, 4 * lanes, 256 // lanes
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
def test_stats_kernel_order_covers_each_element_once(n, c, s, sms):
    """Every element is added once, into its own channel: with a = 1 each
    channel counts N·S, with a = its channel + 1 it sums (c + 1)·N·S."""
    lanes, rows, _ = tfc._stats_plan(n, c, s, sms)
    chan = np.broadcast_to(np.arange(c, dtype=np.float32)[None, :, None],
                           (n, c, s))
    count, _ = _emulate_stats(np.ones((n, c, s), np.float32), lanes, rows)
    total, _ = _emulate_stats(chan + 1, lanes, rows)
    np.testing.assert_array_equal(count, np.full(c, n * s, np.float32))
    np.testing.assert_array_equal(total, (np.arange(c) + 1.0) * n * s)


@pytest.mark.parametrize("n,c,s,sms", PLAN_CASES)
def test_stats_kernel_order_matches_plain_and_float64(n, c, s, sms):
    """The kernel's summation order gives Σa and Σa² within STATS_RTOL of
    the sum of their terms' magnitudes, against the plain version and
    against float64."""
    a = np.random.default_rng(n * c + s).standard_normal(
        (n, c, s)).astype(np.float32) + 0.5
    lanes, rows, _ = tfc._stats_plan(n, c, s, sms)
    got = _emulate_stats(a, lanes, rows)
    plain = [x.numpy() for x in tfc.channel_stats(torch.from_numpy(a))]
    a64 = a.astype(np.float64)
    exact = (a64.sum(axis=(0, 2)), (a64 * a64).sum(axis=(0, 2)))
    terms = (np.abs(a64).sum(axis=(0, 2)), exact[1])
    for g, p, x, t in zip(got, plain, exact, terms):
        assert np.all(np.abs(g - p) <= STATS_RTOL * t)
        assert np.all(np.abs(g - x) <= STATS_RTOL * t)


@pytest.mark.parametrize("n,c,s,sms", PLAN_CASES)
def test_apply_kernel_channel_map_is_exact(n, c, s, sms):
    """The apply kernel's blocks, row groups and threads reach every
    element of a once, and each thread's four columns take the channel
    the element has."""
    lanes, rows = tfc._apply_plan(n, c, s, sms)
    cs, e, groups = c * s, 4 * lanes, 256 // lanes
    vec = cs % 4 == 0
    seen = np.zeros((n, cs), np.int64)
    chan = np.full((n, cs), -1)
    for b in range(-(-cs // e)):
        for p in range(-(-n // rows)):
            n1 = min(n, (p + 1) * rows)
            for r in range(groups):
                for lane in range(lanes):
                    cols = [b * e + (4 * lane + i if vec else lane + lanes * i)
                            for i in range(4)]
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
def test_plans_fit_the_kernels(n, c, s, sms):
    """The plans the wrappers pass are ones the entry points take: lanes
    of the built instances (32 where rows are read as scalars), grid
    dimensions in range, the partials the kernel indexes."""
    lanes, rows, partials = tfc._stats_plan(n, c, s, sms)
    alanes, arows = tfc._apply_plan(n, c, s, sms)
    for ln in (lanes, alanes):
        assert ln in ((32, 64, 128, 256) if c * s % 4 == 0 else (32,))
    ranges = -(-c * s // (4 * lanes))
    assert partials == -(-n // rows) * (ranges + c)
    assert -(-n // rows) <= 65535 and -(-n // arows) <= 65535
    assert -(-n // rows) == 1 or ranges < 2 * sms


def test_stats_scratch_is_one_buffer_a_stream():
    """The stats kernel's tickets and partials: one zeroed buffer a
    (device, stream), grown when a call needs more; two streams never
    share one."""
    saved = dict(tfc._scratch)
    tfc._scratch.clear()
    try:
        cpu = torch.device("cpu")
        t1, p1 = tfc._scratch_of(cpu, 11, 64, 100)
        assert tfc._scratch_of(cpu, 11, 64, 100) == (t1, p1)
        t2, _ = tfc._scratch_of(cpu, 12, 64, 100)
        assert t2 != t1
        buf, tickets = tfc._scratch[(None, 11)]
        assert tickets >= 1 and p1 - t1 == 4 * tickets
        assert not bool(buf.any())
        tfc._scratch_of(cpu, 11, 300 * 256, 1 << 20)
        buf, tickets = tfc._scratch[(None, 11)]
        assert tickets * 256 >= 300 * 256
        assert buf.numel() >= tickets + 2 * (1 << 20)
    finally:
        tfc._scratch.clear()
        tfc._scratch.update(saved)


@pytest.mark.parametrize("fault,error", [
    (None, None), ("device", ValueError), ("dtype", TypeError),
    ("shape", ValueError), ("layout", ValueError),
    ("alignment", ValueError)])
def test_check_refuses_what_a_kernel_does_not_take(fault, error):
    """build.check, every wrapper's one check of its tensors: the device,
    then float32, the shape, contiguity, and 16-byte alignment where the
    wrapper asks for it (the conv-epilogue kernels read float4)."""
    from paddle_tpu_torch.kernels import build

    cpu = torch.device("cpu")
    t, device, shape = torch.zeros(4, 8), cpu, (4, 8)
    if fault == "device":
        device = torch.device("cuda", 0)
    elif fault == "dtype":
        t = t.double()
    elif fault == "shape":
        shape = (8, 4)
    elif fault == "layout":
        t = torch.zeros(8, 4).t()
    elif fault == "alignment":
        t = torch.zeros(33)[1:].view(4, 8)
        build.check("t", t, device, shape)   # taken where not asked
    if error is None:
        build.check("t", t, device, shape, aligned=True)
        return
    with pytest.raises(error, match="t "):
        build.check("t", t, device, shape, aligned=True)


@pytest.mark.parametrize("module", ["flash_attention", "fused_block",
                                    "fused_conv", "fused_lstm"])
def test_wrappers_take_the_device_and_stream_from_build(module):
    """Every kernel wrapper enters its tensor's device through
    build.device_guard and takes the stream from build.stream: none
    enters torch.cuda.device or reads current_stream itself."""
    from paddle_tpu_torch.kernels import build

    text = (Path(build.__file__).parent / f"{module}.py").read_text()
    assert "build.device_guard(" in text and "build.stream(" in text
    assert "torch.cuda.device(" not in text
    assert "current_stream(" not in text
