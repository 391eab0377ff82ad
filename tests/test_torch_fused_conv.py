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
