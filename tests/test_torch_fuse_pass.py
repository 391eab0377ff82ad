"""The port's conv-fusion pass (analysis/fuse.py) against the JAX
package's, on the CPU.

The same build calls in both packages give the same program; each
package's ``fuse_program`` must then give the same fused program, op for
op (type, slots, var names, attrs). ResNet-50 (``get_model``, imagenet,
fused_xent) is built without running it; the legality cases of the JAX
package's tests/test_conv_fusion.py run on a small residual net (conv +
BN + ReLU main path, conv + BN shortcut, residual add + ReLU). Fused and
unfused programs give the same step in the port's Executor, within
atol = rtol = 1e-5 (float32, the epilogue's sums in another order).
"""

from collections import Counter

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.analysis import fuse as jfuse
from paddle_tpu.core import program as jprog
from paddle_tpu.models import resnet as jres

import paddle_tpu_torch as pt
from paddle_tpu_torch.analysis import fuse as tfuse
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.lowering import AUTODIFF_OP
from paddle_tpu_torch.models import resnet as tres

torch.set_num_threads(2)

PACKAGES = {"jax": (jpt, jprog, jres, jfuse), "port": (pt, tprog, tres, tfuse)}


def _fused_ops(program):
    return [op for op in program.global_block.ops
            if op.type == "fused_conv2d"]


def _ops(program):
    return [op.to_dict() for op in program.global_block.ops]


@pytest.fixture(scope="module")
def resnet50():
    out = {}
    for name, (pkg, prog_mod, res, fuse) in PACKAGES.items():
        prog_mod.reset_unique_names()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            avg, _, _, _ = res.get_model(data_set="imagenet", depth=50,
                                         fused_xent=True,
                                         learning_rate=0.005)
        fused, n = fuse.fuse_program(main, protect=[avg.name])
        out[name] = dict(main=main, startup=startup, fused=fused, n=n)
    return out


def test_resnet50_programs_match_before_the_pass(resnet50):
    j, t = resnet50["jax"], resnet50["port"]
    assert [op.type for op in t["main"].global_block.ops] == \
        [op.type for op in j["main"].global_block.ops]
    assert t["main"].to_dict() == j["main"].to_dict()
    assert t["startup"].to_dict() == j["startup"].to_dict()


def test_resnet50_fused_programs_match_op_for_op(resnet50):
    j, t = resnet50["jax"], resnet50["port"]
    assert t["n"] == j["n"] == 17
    assert _ops(t["fused"]) == _ops(j["fused"])
    assert t["fused"].to_dict() == j["fused"].to_dict()


def test_resnet50_fused_op_counts(resnet50):
    """17 fused_conv2d (13 without an addend, 4 shortcuts that absorbed
    the residual add and the tail ReLU), 12 fused_bottleneck rest blocks,
    161 momentum updates of 25,557,032 parameters, and no standalone
    conv2d, batch_norm or relu left."""
    fused = resnet50["port"]["fused"]
    counts = Counter(op.type for op in fused.global_block.ops)
    with_add = [op for op in _fused_ops(fused) if op.input("Addend")]
    assert (counts["fused_conv2d"], len(with_add)) == (17, 4)
    assert counts["fused_bottleneck"] == 12
    assert counts["momentum"] == 161
    assert {"conv2d", "batch_norm", "relu"}.isdisjoint(counts)
    assert counts["pool2d"] == 2 and counts["mul"] == 1
    for op in with_add:
        assert op.attrs["act"] == "relu"
        assert op.attrs["fused_from"] == ["conv2d", "batch_norm",
                                          "elementwise_add", "relu"]
    n_params = sum(int(np.prod(p.shape)) for p in
                   fused.global_block.all_parameters())
    assert n_params == 25_557_032


def _residual_net(pkg, prog_mod, kind="residual"):
    """conv+bn(relu) main path, conv+bn shortcut, residual add + relu,
    global pool, fc, mean, SGD (the JAX package's test net, with a mean
    head). kind "multi_consumer" gives the conv output a second reader."""
    prog_mod.reset_unique_names()
    layers = pkg.layers
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start):
        x = layers.data("x", shape=(8, 12, 12), dtype="float32")
        c = layers.conv2d(x, num_filters=8, filter_size=3, padding=1,
                          bias_attr=False)
        y = layers.batch_norm(c, act="relu")
        if kind == "multi_consumer":
            loss = layers.elementwise_add(layers.mean(y), layers.mean(c))
            return main, start, loss
        sc = layers.conv2d(x, num_filters=8, filter_size=1, bias_attr=False)
        sb = layers.batch_norm(sc)
        r = layers.relu(layers.elementwise_add(y, sb))
        p = layers.pool2d(r, pool_type="avg", global_pooling=True)
        pred = layers.fc(layers.reshape(p, shape=(-1, 8)), size=1)
        loss = layers.mean(pred)
        pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, start, loss


def _both(kind="residual", dtype_edit=False, protect_conv=False):
    """Each package's (original, fused, #chains) for one legality case."""
    out = {}
    for name, (pkg, prog_mod, _, fuse) in PACKAGES.items():
        main, _, loss = _residual_net(pkg, prog_mod, kind)
        protect = [loss.name]
        if dtype_edit:
            bn = next(op for op in main.global_block.ops
                      if op.type == "batch_norm")
            main.global_block.vars[bn.output("Y")[0]].dtype = "bfloat16"
        if protect_conv:
            protect.append(next(op for op in main.global_block.ops
                                if op.type == "conv2d").output("Output")[0])
        before = _ops(main)
        fused, n = fuse.fuse_program(main, protect=protect)
        assert _ops(main) == before   # the pass rewrites a clone
        out[name] = (main, fused, n)
    assert _ops(out["port"][1]) == _ops(out["jax"][1])
    return out["port"]


def test_residual_chains_fuse():
    main, fused, n = _both()
    assert n == 2
    plain = [op for op in _fused_ops(fused) if not op.attrs["with_add"]]
    resid = [op for op in _fused_ops(fused) if op.attrs["with_add"]]
    assert len(plain) == len(resid) == 1
    assert plain[0].attrs["act"] == "relu"
    assert plain[0].attrs["fused_from"] == ["conv2d", "batch_norm"]
    assert resid[0].attrs["fused_from"] == [
        "conv2d", "batch_norm", "elementwise_add", "relu"]
    assert resid[0].input("Addend") == plain[0].output("Output")
    kinds = [op.type for op in fused.global_block.ops]
    assert "batch_norm" not in kinds and "relu" not in kinds
    ad = [op for op in fused.global_block.ops if op.type == AUTODIFF_OP]
    assert len(ad) == 1
    for nm in ad[0].attrs["grad_names"]:
        assert nm in fused.global_block.vars


@pytest.mark.parametrize("case", ["multi_consumer", "protected", "dtype"])
def test_refusals(case):
    """A conv output with a second reader, a protected intermediate and
    a dtype change through the epilogue each keep their chain unfused;
    the protected case still fuses the other chain."""
    _, fused, n = _both(kind=case if case == "multi_consumer" else
                        "residual", dtype_edit=case == "dtype",
                        protect_conv=case == "protected")
    assert n == {"multi_consumer": 0, "protected": 1, "dtype": 1}[case]
    assert len(_fused_ops(fused)) == n


def test_pt_fuse_off_returns_the_same_object(monkeypatch):
    main, _, loss = _residual_net(pt, tprog)
    fp = main.fingerprint()
    monkeypatch.setenv("PT_FUSE", "0")
    assert tfuse.maybe_fuse(main, protect=[loss.name]) is main
    assert main.fingerprint() == fp
    monkeypatch.setenv("PT_FUSE", "1")
    out = tfuse.maybe_fuse(main, protect=[loss.name])
    assert out is not main and _fused_ops(out)
    # memoized per (fingerprint, protected names)
    assert tfuse.maybe_fuse(main, protect=[loss.name]) is out
    main.global_block.create_var("extra", shape=(1,))
    assert main.fingerprint() != fp


def test_fused_and_unfused_steps_agree(monkeypatch):
    """One SGD step of the residual net with the pass on and off, from
    one startup state, in the port's Executor."""
    main, start, loss = _residual_net(pt, tprog)
    exe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.random.RandomState(0).randn(4, 8, 12, 12)
            .astype(np.float32)}
    scope0 = pt.Scope()
    exe.run(start, scope=scope0)
    names = sorted(scope0.local_var_names())
    results = []
    for flag in ("1", "0"):
        monkeypatch.setenv("PT_FUSE", flag)
        scope = pt.Scope()
        for n in names:
            scope.set_var(n, scope0.find_var(n).clone())
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        results.append((out, {n: scope.get_numpy(n) for n in names}))
    (lf, sf), (lu, su) = results
    np.testing.assert_allclose(lf, lu, atol=1e-5, rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(sf[n], su[n], atol=1e-5, rtol=1e-5,
                                   err_msg=n)


def test_clone_and_prune():
    """clone(for_test=True) sets every is_test attr and leaves the
    original alone; prune keeps what the target needs."""
    tprog.reset_unique_names()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        _, _, predict, _ = tres.get_model(data_set="cifar10", depth=8)
    test = main.clone(for_test=True)
    assert test.to_dict() != main.to_dict()
    bns = [op for op in test.global_block.ops if op.type == "batch_norm"]
    assert bns and all(op.attrs["is_test"] for op in bns)
    assert not any(op.attrs["is_test"] for op in main.global_block.ops
                   if op.type == "batch_norm")
    pruned = test.prune([predict.name])
    kinds = {op.type for op in pruned.global_block.ops}
    assert "momentum" not in kinds and AUTODIFF_OP not in kinds
    assert kinds <= {"conv2d", "batch_norm", "elementwise_add", "relu",
                     "pool2d", "mul", "softmax"}
