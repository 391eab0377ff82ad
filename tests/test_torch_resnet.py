"""ResNet training through the port's Executor against the JAX package.

A narrow ResNet built from ``resnet.conv_bn_layer``, ``layer_warp`` and
``bottleneck`` at 16x16, batch 4, 10 classes: the stem (conv 3x3 + BN +
ReLU), the 3x3 max pool, a projection block of stride 1 and one of
stride 2, each followed by a ``fused_bottleneck`` rest block, the global
average pool and the fc head, with both ``fused_xent`` settings, and
Momentum (mu 0.9). Both packages build it after ``reset_unique_names()``;
the JAX startup state is carried into the port's Scope by name, then
both take 3 Momentum steps on feeds made from a numpy seed, on the CPU.
The Executor of each package runs its conv-fusion pass, so every conv +
BN chain outside the rest blocks runs as ``fused_conv2d``: in the port
through ``FusedConvEpilogue`` (the kernels' plain versions on the CPU),
or the ``_bn_train`` composition with PT_FUSE_EPILOGUE=never; in the JAX
package through its composition (an untuned shape off the TPU).

Tolerances: float32 on both sides, sums in other orders: losses within
rtol 1e-4; first-step gradients within atol 1e-5, rtol 1e-4; after 3
steps each parameter's update (end minus start), each velocity and each
running mean and variance within 1e-3 of JAX's as rms
(rms(port - JAX) <= 1e-3 * rms(JAX)), and the running stats also within
1e-5 elementwise. The inference clone's predictions within atol 1e-5,
rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core import program as jprog
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import resnet as jres

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import ExecContext, require_op
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.ops import fused_ops

torch.set_num_threads(2)

BATCH, IMAGE, CLASSES, STEPS, LR = 4, 16, 10, 3, 0.05
STATE_RTOL, STAT_ATOL = 1e-3, 1e-5


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a.astype(np.float64)))))


def _narrow(pkg, res, fused_xent):
    """The narrow ResNet's training program; returns (avg, predict)."""
    layers = pkg.layers
    x = layers.data("data", [3, IMAGE, IMAGE], dtype="float32")
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


def _build(pkg, prog_mod, res, fused_xent):
    prog_mod.reset_unique_names()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        avg, predict = _narrow(pkg, res, fused_xent)
    return main, startup, avg, predict


def _feeds(i):
    rng = np.random.RandomState(300 + i)
    data = rng.rand(BATCH, 3, IMAGE, IMAGE).astype(np.float32) - 0.5
    label = ((data[:, 0, 0, 0] + 0.5) * 9.999).astype(np.int64)
    return {"data": data, "label": label.reshape(-1, 1)}


def _persistables(main):
    return sorted(v.name for v in main.global_block.vars.values()
                  if v.persistable)


@pytest.fixture(scope="module", params=[True, False],
                ids=["fused_xent", "softmax_head"])
def run(request):
    """Build both programs, then the JAX side: startup, STEPS Momentum
    steps (step-1 gradients fetched), the inference clone's predictions."""
    fx = request.param
    jmain, jstart, javg, jpred = _build(jpt, jprog, jres, fx)
    tmain, tstart, tavg, tpred = _build(pt, tprog, tres, fx)
    exe, scope = jpt.Executor(), JScope()
    exe.run(jstart, scope=scope)
    names = _persistables(jmain)
    start = {n: np.array(scope.find_var(n)) for n in names}
    params = [p.name for p in jmain.global_block.all_parameters()]
    losses, grads = [], None
    for i in range(STEPS):
        fetch = [javg.name] + ([p + "@GRAD" for p in params] if i == 0
                               else [])
        out = exe.run(jmain, feed=_feeds(i), fetch_list=fetch, scope=scope)
        losses.append(float(out[0][0]))
        if i == 0:
            grads = dict(zip(params, out[1:]))
    end = {n: np.array(scope.find_var(n)) for n in names}
    jtest = jmain.clone(for_test=True).prune([jpred.name])
    infer, = exe.run(jtest, feed=_feeds(7), fetch_list=[jpred.name],
                     scope=scope)
    return dict(fused_xent=fx, jmain=jmain, tmain=tmain, tavg=tavg,
                tpred=tpred, start=start, losses=losses, grads=grads,
                end=end, params=params, infer=infer)


def test_programs_and_names_match(run):
    """The same build calls give the same IR and the same persistable
    names (parameters, BN running stats, Momentum velocities), so that
    scope_from_numpy carries every var across."""
    assert run["tmain"].to_dict() == run["jmain"].to_dict()
    assert _persistables(run["tmain"]) == sorted(run["start"])
    kinds = {n.split(".")[0].rsplit("_", 1)[0] for n in run["start"]}
    assert {"conv2d", "batch_norm", "fused_bottleneck", "fc",
            "learning_rate"} <= kinds
    assert any(n.endswith("_velocity_0") for n in run["start"])


@pytest.mark.parametrize("epilogue", ["kernels", "composition"])
def test_momentum_steps_match_jax(run, epilogue, monkeypatch):
    if epilogue == "composition":
        monkeypatch.setenv("PT_FUSE_EPILOGUE", "never")
    exe = pt.Executor(pt.CPUPlace())
    scope = tio.scope_from_numpy(run["start"], "cpu")
    params = run["params"]
    for i in range(STEPS):
        fetch = [run["tavg"]] + ([p + "@GRAD" for p in params] if i == 0
                                 else [])
        out = exe.run(run["tmain"], feed=_feeds(i), fetch_list=fetch,
                      scope=scope)
        np.testing.assert_allclose(out[0][0], run["losses"][i], rtol=1e-4)
        if i == 0:
            for p, g in zip(params, out[1:]):
                np.testing.assert_allclose(g, run["grads"][p], atol=1e-5,
                                           rtol=1e-4, err_msg=p)
    assert run["losses"][-1] < run["losses"][0]
    for n, want in run["end"].items():
        got = scope.get_numpy(n)
        is_param = n in params
        if is_param:
            got, want = got - run["start"][n], want - run["start"][n]
        elif "velocity" not in n and n.startswith(("batch_norm",
                                                   "fused_bottleneck")):
            np.testing.assert_allclose(got, want, atol=STAT_ATOL, rtol=0,
                                       err_msg=n)
        if "learning_rate" in n:
            np.testing.assert_array_equal(got, want)
            continue
        assert _rms(got - want) <= STATE_RTOL * _rms(want), \
            f"{n}: rms diff {_rms(got - want):.3e} vs rms {_rms(want):.3e}"


def test_inference_clone_matches_jax(run):
    """clone(for_test=True) then prune to the predictions: every BN folds
    into its conv (fused_conv2d's and fused_bottleneck's is_test
    branches), on the state after the JAX steps."""
    exe = pt.Executor(pt.CPUPlace())
    scope = tio.scope_from_numpy(run["end"], "cpu")
    test = run["tmain"].clone(for_test=True).prune([run["tpred"].name])
    assert {op.type for op in test.global_block.ops} <= {
        "conv2d", "batch_norm", "fused_bottleneck", "pool2d", "mul",
        "elementwise_add", "softmax", "relu"}
    got, = exe.run(test, feed=_feeds(7), fetch_list=[run["tpred"]],
                   scope=scope)
    np.testing.assert_allclose(got, run["infer"], atol=1e-5, rtol=1e-4)
    # inference leaves the state as it was: no update, no running stat
    for n, v in run["end"].items():
        np.testing.assert_array_equal(scope.get_numpy(n), v, err_msg=n)


def test_cifar10_depth8_forward_matches_jax():
    """resnet_cifar10(depth=8): basic blocks, identity and projection
    shortcuts (the fusion pass absorbs both kinds of residual add), a
    forward program in training mode, from the JAX startup state."""
    built = []
    for pkg, prog_mod, res in ((jpt, jprog, jres), (pt, tprog, tres)):
        prog_mod.reset_unique_names()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data("data", [3, 32, 32], dtype="float32")
            predict = res.resnet_cifar10(x, 10, depth=8)
        built.append((main, startup, predict))
    (jmain, jstart, jpred), (tmain, _, tpred) = built
    assert tmain.to_dict() == jmain.to_dict()
    exe, scope = jpt.Executor(), JScope()
    exe.run(jstart, scope=scope)
    state = {n: np.array(scope.find_var(n)) for n in _persistables(jmain)}
    feed = {"data": np.random.RandomState(5).rand(2, 3, 32, 32)
            .astype(np.float32)}
    want, = exe.run(jmain, feed=feed, fetch_list=[jpred.name], scope=scope)
    got, = pt.Executor(pt.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[tpred],
        scope=tio.scope_from_numpy(state, "cpu"))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def _momentum_ins(grad):
    p = torch.ones(4)
    return {"Param": [p], "Grad": [grad], "Velocity": [torch.zeros(4)],
            "LearningRate": [torch.full((1,), 0.1)]}


@pytest.mark.parametrize("what", ["dtype", "fused_block", "sparse_momentum",
                                  "gconv_dense", "bn_plain_vjp"])
def test_what_is_not_ported_raises(what, monkeypatch):
    """Each branch the ResNet slice leaves out raises instead of running
    something else."""
    ctx = ExecContext(torch.Generator(), torch.device("cpu"))
    if what == "dtype":
        # float32 and bfloat16 programs build
        # (tests/test_torch_resnet_bf16.py); float16 is not ported
        with pt.program_guard(pt.Program(), pt.Program()):
            with pytest.raises(NotImplementedError, match="not ported"):
                tres.get_model(data_set="imagenet", depth=50,
                               dtype="float16")
    elif what == "fused_block":
        # the JAX package's gate: open for always (or 1) on the card
        # only; off the card the op composes, as the JAX package does
        for mode, on_card in (("always", True), ("1", True), ("auto", False),
                              ("never", False), ("0", False)):
            monkeypatch.setenv("PT_FUSED_BLOCK", mode)
            assert fused_ops.fused_block_enabled(
                torch.device("cuda")) is on_card
            assert fused_ops.fused_block_enabled(
                torch.device("cpu")) is False
    elif what == "sparse_momentum":
        grad = torch.sparse_coo_tensor([[1]], [1.0], (4,),
                                       check_invariants=True)
        with pytest.raises(NotImplementedError, match="not ported"):
            require_op("momentum").compute(ctx, _momentum_ins(grad),
                                           {"mu": 0.9})
        out = require_op("momentum").compute(
            ctx, _momentum_ins(torch.ones(4)), {"mu": 0.9,
                                                "use_nesterov": True})
        np.testing.assert_allclose(out["ParamOut"][0].numpy(), 1 - 0.19)
    else:
        x = torch.ones(1, 4, 5, 5)
        if what == "gconv_dense":
            monkeypatch.setenv("PT_GCONV_DENSE", "always")
            op, ins = "conv2d", {"Input": [x],
                                 "Filter": [torch.ones(4, 2, 3, 3)]}
            attrs = {"groups": 2}
        else:
            monkeypatch.setenv("PT_BN_PLAIN_VJP", "1")
            op, ins = "batch_norm", {"X": [x], "Scale": [torch.ones(4)],
                                     "Bias": [torch.zeros(4)],
                                     "Mean": [torch.zeros(4)],
                                     "Variance": [torch.ones(4)]}
            attrs = {}
        with pytest.raises(NotImplementedError, match="not ported"):
            require_op(op).compute(ctx, ins, attrs)
