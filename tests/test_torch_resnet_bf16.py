"""bfloat16 ResNet training through the port's Executor against the JAX
package, on the CPU: the ops of the path in bfloat16, the conv filters'
dtype, and the narrow ResNet of tests/test_torch_resnet.py as a bfloat16
program (``data`` bfloat16, float32 master parameters, as
``resnet.get_model(dtype="bfloat16")`` builds it) and as a float32
program under ``amp_dtype = "bfloat16"``.

The narrow ResNet (16x16, batch 4, 10 classes, both ``fused_xent``
settings) is built in both packages after ``reset_unique_names()``; the
JAX float32 startup state is carried into the port's Scope by name, and
both take 3 Momentum steps (lr 0.05, mu 0.9) on feeds made from a numpy
seed, with both epilogue settings: the port's default (the epilogue
kernels' plain versions) against the JAX package with
``fused_conv.INTERPRET`` patched to True and
``PT_FUSE_EPILOGUE=always`` (its Pallas epilogue, interpreted), and
``PT_FUSE_EPILOGUE=never`` (``_bn_train``) on both sides.

The limits come first from the JAX package's own spread at this shape:
its bfloat16 runs (both programs, both ``fused_xent`` and both epilogue
settings) against its float32 run from the same state. The JAX
package's largest spreads over the eight cases were: the step-0 loss
(one forward from one state) 5.06e-4 (relative), the loss at any of the
3 steps 2.54e-2; the first step's gradients, as the relative rms of all
of them together, 0.378, and as the median over the parameters of each
one's relative rms 0.298; the parameters' updates after 3 steps 0.514
(together) and 0.458 (median); the running means and variances 7.45e-3
(together). Batch norm at init in batches of 4 cancels: a BN scale's
gradient is a small difference of large sums, so bfloat16's 2^-8 moves
it by tens of percent in either package. The port rounds where the JAX
package's bfloat16 run rounds; the two differ only in the order of
float32 sums inside an op (a conv, a reduction), a part of what
separates bfloat16 from float32. So the gradients, the updates and the
running stats, each an aggregate over every element, are held within
the JAX package's own largest spread, rounded up in its second digit:
GRAD_RTOL 0.38, GRAD_MEDIAN_RTOL 0.30, UPDATE_RTOL 0.52,
UPDATE_MEDIAN_RTOL 0.46, STAT_RTOL 7.5e-3. The port's largest readings
over the eight cases are 0.253, 0.189, 0.395, 0.359 and 5.2e-3. The
losses, one number each, are held to twice the JAX package's own:
STEP0_RTOL 2e-3 (the port's largest 1.0e-3) and LOSS_RTOL 6e-2 (the
port's largest 3.5e-2). Planted faults fail these limits: a step that
leaves the parameters where they were reads 1.0 for the updates, and a
step that sees half of each batch reads at least 1.35 for the
gradients, 1.44 for the updates and 3.1e-2 for the step-0 loss
(``test_bf16_momentum_check_catches_planted_faults``). All these
readings are printed by ``scripts/resnet_bf16_spread_cpu.py``. The structure
is held exactly: the IR, the loss's and the predictions' dtypes, every
gradient float32, every parameter, velocity and running stat float32
after the steps.

The inference clone of the bfloat16 program (every BN folded into its
conv, in bfloat16 filters) is held to the JAX package's clone within
2^-6 max|jax| + 2^-6 |jax| (bfloat16 through ten convs: each package
rounds at other places); a float32 feed into the bfloat16 data var
crosses as the JAX Executor casts it, bit for bit. The ops of the path
are held one by one to the JAX package's op on the same bfloat16 inputs,
bit for bit where both round once from the same float32 value, else
within one bfloat16 step (2^-7 max|jax| + 2^-7 |jax|).
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core import program as jprog
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.kernels import fused_conv as jfc
from paddle_tpu.models import resnet as jres

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.models import resnet as tres

torch.set_num_threads(2)

BATCH, IMAGE, CLASSES, STEPS, LR = 4, 16, 10, 3, 0.05
BF16_REL = 2.0 ** -7
STEP0_RTOL = 2e-3
LOSS_RTOL = 6e-2
GRAD_RTOL, GRAD_MEDIAN_RTOL = 0.38, 0.30
UPDATE_RTOL, UPDATE_MEDIAN_RTOL = 0.52, 0.46
STAT_RTOL = 7.5e-3
CLONE_REL = 2.0 ** -6


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _rel(got, want):
    return _rms(np.asarray(got, np.float64) - want) / _rms(want)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x).astype(np.float32)


def _dtype(x) -> str:
    return str(x.dtype).rsplit(".", 1)[-1]


def _bf16(x) -> np.ndarray:
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


def _t(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.array(x).view(np.uint16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _hold(got, want, rel=BF16_REL, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    limit = rel * np.abs(want).max() + rel * np.abs(want)
    assert np.all(np.abs(got - want) <= limit), \
        f"{what}: {np.abs(got - want).max():.3e} beyond the limit"


@pytest.fixture
def pallas_epilogue(monkeypatch):
    """Both packages on their kernels' epilogue: the port's default, the
    JAX package's Pallas kernels through the interpreter."""
    monkeypatch.setattr(jfc, "INTERPRET", True)
    monkeypatch.setenv("PT_FUSE_EPILOGUE", "always")


# ---------------------------------------------------------------------------
# the conv filters take the input's dtype
# ---------------------------------------------------------------------------

def _conv_program(pkg, what):
    """A forward program over a bfloat16 data var [4, 8, 8, 8] for each
    op that holds a conv filter; returns (main, startup, out)."""
    layers = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = layers.data("data", [8, 8, 8], dtype="bfloat16")
        if what.startswith("conv2d"):
            out = layers.conv2d(input=x, num_filters=6, filter_size=3,
                                padding=1, bias_attr=False)
        elif what.startswith("fused_conv2d"):
            conv = layers.conv2d(input=x, num_filters=6, filter_size=3,
                                 padding=1, bias_attr=False)
            out = layers.batch_norm(input=conv, act="relu")
        else:
            out = layers.fused_bottleneck(x, ch_out=2)
    return main, startup, out


@pytest.mark.parametrize("what", ["conv2d", "fused_conv2d",
                                  "fused_conv2d is_test", "fused_bottleneck",
                                  "fused_bottleneck is_test"])
def test_bf16_data_meets_float32_filters_as_in_jax(what, pallas_epilogue):
    """A bfloat16 data var into conv2d, fused_conv2d (training, and the
    inference clone's BN fold) and fused_bottleneck (composed, and its
    fold): the float32 filters take the input's dtype, the output is
    bfloat16 and matches the JAX package's within one bfloat16 step."""
    outs = []
    rng = np.random.RandomState(7)
    feed = {"data": _bf16(rng.randn(4, 8, 8, 8))}
    state = None
    for pkg, pm in ((jpt, jprog), (pt, tprog)):
        pm.reset_unique_names()
        main, startup, out = _conv_program(pkg, what)
        if what.endswith("is_test"):
            main = main.clone(for_test=True)
        if pkg is jpt:
            exe, scope = jpt.Executor(), JScope()
            exe.run(startup, scope=scope)
            state = {n: np.array(scope.find_var(n)) for n in
                     scope.local_var_names()}
            # running stats that are not the startup's 0 and 1, for the fold
            for n in state:
                if n.endswith(("mean", "variance")) or "_mean" in n or \
                        "_variance" in n:
                    state[n] = (state[n] + rng.rand(*state[n].shape) * 0.5
                                ).astype(np.float32)
                    scope.set_var(n, jnp.asarray(state[n]))
            got, = exe.run(main, feed=feed, fetch_list=[out.name],
                           scope=scope, return_numpy=False)
        else:
            got, = pt.Executor(pt.CPUPlace()).run(
                main, feed=feed, fetch_list=[out.name],
                scope=tio.scope_from_numpy(state, "cpu"), return_numpy=False)
        outs.append(got)
    want, got = outs
    assert _dtype(got) == _dtype(want) == "bfloat16"
    _hold(got, want, what=what)


@pytest.mark.parametrize("grad", [False, True])
def test_bf16_block_through_the_chain_is_not_ported(monkeypatch, grad):
    """Where the chain's gate is open (PT_FUSED_BLOCK=always on the card;
    here fused_block_enabled patched true, CHAIN_MIN_S down to the
    image), a bfloat16 block takes the chain with no gradient wanted
    (under no_grad) and with one (a filter that requires grad): the
    chain's kernels have bf16 versions forward and backward; a float16
    block raises "not ported" before the chain is called; a float32 block
    of the same shape takes the chain either way."""
    from paddle_tpu_torch.ops import fused_ops

    calls = []
    monkeypatch.setattr(fused_ops, "fused_block_enabled", lambda d: True)
    monkeypatch.setattr(fused_ops, "CHAIN_MIN_S", 16)
    monkeypatch.setattr(fused_ops, "_chain_block",
                        lambda *a: calls.append(a[0].dtype) or (a[0], ()))
    cin, c = 128, 64
    rng = np.random.RandomState(5)
    ins = {"X": [torch.from_numpy(rng.randn(8, cin, 4, 4).astype(
               np.float32)).bfloat16()],
           "W1": [torch.randn(c, cin, 1, 1).requires_grad_(grad)],
           "W2": [torch.randn(c, c, 3, 3)],
           "W3": [torch.randn(cin, c, 1, 1)]}
    for k, width in (("1", c), ("2", c), ("3", cin)):
        ins.update({"Scale" + k: [torch.ones(width)],
                    "Bias" + k: [torch.zeros(width)],
                    "Mean" + k: [torch.zeros(width)],
                    "Variance" + k: [torch.ones(width)]})
    ctx = treg.ExecContext(torch.Generator(), torch.device("cpu"))
    op = treg.require_op("fused_bottleneck").compute
    with torch.set_grad_enabled(grad), pytest.raises(IndexError):  # no stats
        op(ctx, ins, {})
    assert calls == [torch.bfloat16]
    calls.clear()
    half = dict(ins, X=[ins["X"][0].half()])
    with torch.set_grad_enabled(grad), pytest.raises(NotImplementedError,
                                                      match="not ported"):
        op(ctx, half, {})
    assert calls == []
    ins["X"] = [ins["X"][0].float()]
    with pytest.raises(IndexError):   # the stand-in returns no stats
        op(ctx, ins, {})
    assert calls == [torch.float32]


# ---------------------------------------------------------------------------
# the ops of the path, one by one, on bfloat16 inputs
# ---------------------------------------------------------------------------

def _op_case(name):
    """(op type, JAX inputs, port inputs, attrs, output slots)."""
    rng = np.random.RandomState(11)
    x4 = _bf16(rng.randn(4, 6, 7, 7))
    if name == "pool2d max":
        ins = {"X": [x4]}
        return "pool2d", ins, {"pooling_type": "max", "ksize": [3, 3],
                               "strides": [2, 2], "paddings": [1, 1]}, ["Out"]
    if name == "pool2d global avg":
        return "pool2d", {"X": [x4]}, {"pooling_type": "avg", "ksize": [7, 7],
                                       "global_pooling": True}, ["Out"]
    if name == "mul float32 weight":
        return "mul", {"X": [_bf16(rng.randn(4, 24))],
                       "Y": [rng.randn(24, 10).astype(np.float32)]}, \
            {"x_num_col_dims": 1, "y_num_col_dims": 1}, ["Out"]
    if name == "elementwise_add":
        return "elementwise_add", {"X": [x4], "Y": [_bf16(rng.randn(
            4, 6, 7, 7))]}, {"axis": -1}, ["Out"]
    if name == "elementwise_add float32 bias":
        return "elementwise_add", {"X": [_bf16(rng.randn(4, 10))],
                                   "Y": [rng.randn(10).astype(np.float32)]}, \
            {"axis": 1}, ["Out"]
    if name == "relu":
        return "relu", {"X": [x4]}, {}, ["Out"]
    logits = _bf16(rng.randn(4, 10) * 3)
    label = rng.randint(0, 10, (4, 1)).astype(np.int64)
    if name == "softmax_with_cross_entropy":
        return "softmax_with_cross_entropy", {"Logits": [logits],
                                              "Label": [label]}, {}, ["Loss"]
    if name == "softmax":
        return "softmax", {"X": [logits]}, {"axis": -1}, ["Out"]
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits)))
    if name == "cross_entropy":
        return "cross_entropy", {"X": [probs], "Label": [label]}, {}, ["Y"]
    if name == "mean":
        return "mean", {"X": [_bf16(rng.rand(4, 1) * 3)]}, {}, ["Out"]
    if name == "top_k":
        return "top_k", {"X": [probs]}, {"k": 1}, ["Out", "Indices"]
    if name == "accuracy":
        idx = np.asarray(jax.lax.top_k(jnp.asarray(probs), 1)[1])
        return "accuracy", {"Out": [probs[:, :1]], "Indices": [idx],
                            "Label": [label]}, {}, ["Accuracy", "Correct",
                                                    "Total"]
    assert name == "momentum"
    p, g, v = (rng.randn(24).astype(np.float32) for _ in range(3))
    return "momentum", {"Param": [p], "Grad": [g], "Velocity": [v],
                        "LearningRate": [np.full((1,), 0.05, np.float32)]}, \
        {"mu": 0.9}, ["ParamOut", "VelocityOut"]


OPS = ["pool2d max", "pool2d global avg", "mul float32 weight",
       "elementwise_add", "elementwise_add float32 bias", "relu",
       "softmax_with_cross_entropy", "softmax", "cross_entropy", "mean",
       "top_k", "accuracy", "momentum"]


@pytest.mark.parametrize("name", OPS)
def test_op_in_bf16_matches_jax(name):
    """Each op of the bfloat16 ResNet step on the JAX package's inputs:
    the same output dtypes, and the values bit for bit where both round
    once from one float32 value, else within one bfloat16 step."""
    op, ins, attrs, slots = _op_case(name)
    jout = jreg.require_op(op).compute(
        None, {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        attrs)
    ctx = treg.ExecContext(torch.Generator(), torch.device("cpu"))
    tout = treg.require_op(op).compute(
        ctx, {k: [_t(v) for v in vs] for k, vs in ins.items()}, attrs)
    for slot in slots:
        want, got = jout[slot][0], tout[slot][0]
        assert _dtype(got) == _dtype(want), slot
        if _dtype(got) in ("int32", "int64"):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        elif _dtype(got) == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7, err_msg=slot)
        else:
            _hold(got, want, what=f"{name} {slot}")


def test_softmax_with_cross_entropy_bf16_gradient_matches_jax():
    """The loss's gradient into bfloat16 logits (the JAX package's lean
    VJP, dlogits rounded once to bfloat16) within one bfloat16 step."""
    op, ins, attrs, _ = _op_case("softmax_with_cross_entropy")
    logits, label = ins["Logits"][0], ins["Label"][0]
    impl = jreg.require_op(op).compute

    def jloss(lg):
        out = impl(None, {"Logits": [lg], "Label": [jnp.asarray(label)]},
                   attrs)["Loss"][0]
        return jnp.sum(out * jnp.arange(1.0, 5.0).reshape(4, 1))

    want = jax.grad(jloss)(jnp.asarray(logits))
    lg = _t(logits).requires_grad_(True)
    ctx = treg.ExecContext(torch.Generator(), torch.device("cpu"))
    out = treg.require_op(op).compute(
        ctx, {"Logits": [lg], "Label": [_t(label)]}, attrs)["Loss"][0]
    (out * torch.arange(1.0, 5.0).reshape(4, 1)).sum().backward()
    assert lg.grad.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _hold(lg.grad, want, what="dlogits")


def test_float32_feed_into_bf16_data_var_crosses_as_in_jax():
    """A float32 array fed to a bfloat16 data var is rounded to bfloat16
    on the host, as the JAX Executor's astype does: the same bits; and
    the program it feeds gives what the bfloat16 array gives."""
    data = np.random.RandomState(3).rand(4, 3, 32, 32).astype(
        np.float32) - 0.5
    jmain = jpt.Program()
    with jpt.program_guard(jmain, jpt.Program()):
        jpt.layers.data("data", [3, 32, 32], dtype="bfloat16")
    want = jpt.Executor()._prep_feed(jmain, {"data": data})["data"]
    tprog.reset_unique_names()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        avg = tres.get_model(data_set="cifar10", depth=8,
                             dtype="bfloat16")[0]
    exe = pt.Executor(pt.CPUPlace())
    got = exe._prep_feed(main, {"data": data})["data"]
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    bits = got.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(bits, np.asarray(want).view(np.uint16))
    np.testing.assert_array_equal(
        bits, data.astype(ml_dtypes.bfloat16).view(np.uint16))
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    test = main.clone(for_test=True).prune([avg.name])
    label = np.zeros((4, 1), np.int64)
    a, b = (exe.run(test, feed={"data": d, "label": label},
                    fetch_list=[avg], scope=scope, return_numpy=False)[0]
            for d in (data, data.astype(ml_dtypes.bfloat16)))
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the narrow ResNet, 3 Momentum steps against the JAX package
# ---------------------------------------------------------------------------

def _narrow(pkg, res, fused_xent, dtype):
    layers = pkg.layers
    x = layers.data("data", [3, IMAGE, IMAGE], dtype=dtype)
    label = layers.data("label", [1], dtype="int64")
    c1 = res.conv_bn_layer(x, 8, 3, 1, 1)
    p1 = layers.pool2d(input=c1, pool_type="max", pool_size=3,
                       pool_stride=2, pool_padding=1)
    r1 = res.layer_warp(res.bottleneck, p1, 4, 2, 1)
    r2 = res.layer_warp(res.bottleneck, r1, 8, 2, 2)
    pool = layers.pool2d(input=r2, pool_size=4, pool_type="avg",
                         global_pooling=True)
    if fused_xent:
        logits = layers.fc(input=pool, size=CLASSES, act=None)
        predict = layers.softmax(logits)
        cost = layers.softmax_with_cross_entropy(logits, label)
    else:
        predict = layers.fc(input=pool, size=CLASSES, act="softmax")
        cost = layers.cross_entropy(input=predict, label=label)
    avg = layers.mean(cost)
    layers.accuracy(input=predict, label=label)
    pkg.optimizer.MomentumOptimizer(learning_rate=LR,
                                    momentum=0.9).minimize(avg)
    return avg, predict


def _build(pkg, prog_mod, res, fused_xent, kind):
    """kind: "float32", "bf16" (a bfloat16 data var) or "amp"."""
    prog_mod.reset_unique_names()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        avg, predict = _narrow(pkg, res, fused_xent,
                               "bfloat16" if kind == "bf16" else "float32")
    if kind == "amp":
        main.amp_dtype = "bfloat16"
    return main, startup, avg, predict


def _feeds(i, kind):
    rng = np.random.RandomState(300 + i)
    data = rng.rand(BATCH, 3, IMAGE, IMAGE).astype(np.float32) - 0.5
    label = ((data[:, 0, 0, 0] + 0.5) * 9.999).astype(np.int64)
    if kind == "bf16":
        data = data.astype(ml_dtypes.bfloat16)
    return {"data": data, "label": label.reshape(-1, 1)}


def _persistables(main):
    return sorted(v.name for v in main.global_block.vars.values()
                  if v.persistable)


def _jax_run(main, avg, predict, start, kind, params):
    exe, scope = jpt.Executor(), JScope()
    for n, v in start.items():
        scope.set_var(n, jnp.asarray(v))
    losses, dtypes, grads = [], None, None
    for i in range(STEPS):
        fetch = [avg.name] + ([predict.name] + [p + "@GRAD" for p in params]
                              if i == 0 else [])
        out = exe.run(main, feed=_feeds(i, kind), fetch_list=fetch,
                      scope=scope, return_numpy=False)
        losses.append(float(_f32(out[0]).reshape(-1)[0]))
        if i == 0:
            dtypes = [_dtype(o) for o in out]
            grads = {p: _f32(g) for p, g in zip(params, out[2:])}
    end = {n: np.array(scope.find_var(n)) for n in start}
    test = main.clone(for_test=True).prune([predict.name])
    infer, = exe.run(test, feed=_feeds(7, kind), fetch_list=[predict.name],
                     scope=scope, return_numpy=False)
    return dict(losses=losses, dtypes=dtypes, grads=grads, end=end,
                infer=infer)


def _port_run(main, avg, predict, start, kind, params, feeds=_feeds):
    exe = pt.Executor(pt.CPUPlace())
    scope = tio.scope_from_numpy(start, "cpu")
    losses, dtypes, grads = [], None, None
    for i in range(STEPS):
        fetch = [avg] + ([predict] + [p + "@GRAD" for p in params]
                         if i == 0 else [])
        out = exe.run(main, feed=feeds(i, kind), fetch_list=fetch,
                      scope=scope, return_numpy=False)
        losses.append(float(_f32(out[0]).reshape(-1)[0]))
        if i == 0:
            dtypes = [_dtype(o) for o in out]
            grads = {p: _f32(g) for p, g in zip(params, out[2:])}
    return dict(losses=losses, dtypes=dtypes, grads=grads,
                end={n: scope.find_var(n) for n in start})


@pytest.fixture(scope="module")
def start():
    """The JAX package's float32 startup state of the narrow ResNet."""
    main, startup, _, _ = _build(jpt, jprog, jres, True, "float32")
    scope = JScope()
    jpt.Executor().run(startup, scope=scope)
    return {n: np.array(scope.find_var(n)) for n in _persistables(main)}


CASES = [(kind, fx, ep) for kind in ("bf16", "amp") for fx in (True, False)
         for ep in ("kernels", "composition")]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{k}-{'fused_xent' if f else 'softmax_head'}-{e}"
                     for k, f, e in CASES])
def runs(request, start):
    """Both packages' runs of one case from the JAX startup state."""
    kind, fx, epilogue = request.param
    saved = (jfc.INTERPRET, os.environ.get("PT_FUSE_EPILOGUE"))
    jfc.INTERPRET = epilogue == "kernels"
    os.environ["PT_FUSE_EPILOGUE"] = ("always" if epilogue == "kernels"
                                      else "never")
    try:
        jmain, _, javg, jpred = _build(jpt, jprog, jres, fx, kind)
        tmain, _, tavg, tpred = _build(pt, tprog, tres, fx, kind)
        params = [p.name for p in jmain.global_block.all_parameters()]
        jax_run = _jax_run(jmain, javg, jpred, start, kind, params)
        port_run = _port_run(tmain, tavg, tpred, start, kind, params)
    finally:
        jfc.INTERPRET = saved[0]
        if saved[1] is None:
            os.environ.pop("PT_FUSE_EPILOGUE", None)
        else:
            os.environ["PT_FUSE_EPILOGUE"] = saved[1]
    return dict(kind=kind, epilogue=epilogue, jmain=jmain, tmain=tmain,
                tavg=tavg, tpred=tpred, params=params, start=start,
                predict=tpred.name, jax=jax_run, port=port_run)


def test_bf16_programs_build_as_in_jax(runs):
    """The same build calls give the same IR in both packages: the
    bfloat16 data var, float32 parameters, amp_dtype where asked."""
    assert runs["tmain"].to_dict() == runs["jmain"].to_dict()
    block = runs["tmain"].global_block
    assert block.var("data").dtype == ("bfloat16" if runs["kind"] == "bf16"
                                       else "float32")
    assert {p.dtype for p in block.all_parameters()} == {"float32"}


def test_bf16_structure_matches_jax(runs):
    """The loss's and the predictions' dtypes are the JAX package's, every
    gradient is float32, and every parameter, velocity and running stat
    is float32 after the steps."""
    assert runs["port"]["dtypes"] == runs["jax"]["dtypes"]
    assert set(runs["port"]["dtypes"][2:]) == {"float32"}
    for n, v in runs["port"]["end"].items():
        assert v.dtype == torch.float32, n
        assert runs["jax"]["end"][n].dtype == np.float32, n


def _together(got, want, names, base=None):
    """The relative rms difference of the named arrays taken together
    (less `base` where given)."""
    def cat(d):
        return np.concatenate([(d[n] - (0 if base is None else base[n]))
                               .ravel() for n in names])
    return _rel(cat(got), cat(want))


def _readings(port, jax_, params, start):
    """{reading: (value, limit)} of a port run against the JAX run."""
    loss = [abs(a - b) / abs(b) for a, b in zip(port["losses"],
                                               jax_["losses"])]
    end, jend = {n: _f32(v) for n, v in port["end"].items()}, jax_["end"]
    stats = [n for n in end if n not in params and "velocity" not in n
             and "learning_rate" not in n]
    assert stats
    return {
        "step-0 loss": (loss[0], STEP0_RTOL),
        "loss": (max(loss), LOSS_RTOL),
        "gradients": (_together(port["grads"], jax_["grads"], params),
                      GRAD_RTOL),
        "gradients, median": (float(np.median(
            [_rel(port["grads"][p], jax_["grads"][p]) for p in params])),
            GRAD_MEDIAN_RTOL),
        "updates": (_together(end, jend, params, start), UPDATE_RTOL),
        "updates, median": (float(np.median(
            [_rel(end[p] - start[p], jend[p] - start[p]) for p in params])),
            UPDATE_MEDIAN_RTOL),
        "running stats": (_together(end, jend, stats), STAT_RTOL)}


def _misfits(port, jax_, params, start):
    """The readings beyond their limits (empty: within all of them)."""
    return {k: v for k, v in _readings(port, jax_, params, start).items()
            if not (np.isfinite(v[0]) and v[0] <= v[1])}


def test_bf16_momentum_steps_match_jax(runs):
    """Losses, first-step gradients, updates and running stats after 3
    Momentum steps within the limits above; the learning rate the
    same bits."""
    port, jax_ = runs["port"], runs["jax"]
    assert all(np.isfinite(port["losses"]))
    assert _misfits(port, jax_, runs["params"], runs["start"]) == {}
    for n in port["end"]:
        if "learning_rate" in n:
            np.testing.assert_array_equal(_f32(port["end"][n]),
                                          jax_["end"][n])


def _half_batch(i, kind):
    return {k: v[:BATCH // 2] for k, v in _feeds(i, kind).items()}


@pytest.mark.parametrize("fault", ["zero update", "half batch"])
def test_bf16_momentum_check_catches_planted_faults(runs, fault,
                                                    monkeypatch):
    """The limits above can fail: a port run whose steps leave the
    parameters where they started fails the updates' limits, and one
    whose steps see half of each batch fails the step-0 loss's, the
    gradients' and the updates' limits."""
    params, start = runs["params"], runs["start"]
    if fault == "zero update":
        bad = dict(runs["port"], end={
            n: (torch.from_numpy(start[n].copy()) if n in params else v)
            for n, v in runs["port"]["end"].items()})
        want = {"updates", "updates, median"}
    else:
        monkeypatch.setenv("PT_FUSE_EPILOGUE", "always" if runs["epilogue"]
                           == "kernels" else "never")
        bad = _port_run(runs["tmain"], runs["tavg"], runs["tpred"], start,
                        runs["kind"], params, feeds=_half_batch)
        want = {"step-0 loss", "gradients", "gradients, median", "updates",
                "updates, median"}
    got = _misfits(bad, runs["jax"], params, start)
    assert want <= set(got), got


def test_bf16_inference_clone_matches_jax(runs):
    """clone(for_test=True) then prune to the predictions, both packages
    from the JAX state after the JAX steps (every BN folded into its
    conv, the filters in the input's dtype)."""
    exe = pt.Executor(pt.CPUPlace())
    scope = tio.scope_from_numpy(runs["jax"]["end"], "cpu")
    test = runs["tmain"].clone(for_test=True).prune([runs["predict"]])
    got, = exe.run(test, feed=_feeds(7, runs["kind"]),
                   fetch_list=[runs["predict"]], scope=scope,
                   return_numpy=False)
    want = runs["jax"]["infer"]
    assert _dtype(got) == _dtype(want)
    assert bool(torch.isfinite(got.float()).all())
    _hold(got, want, CLONE_REL, "predictions")
