"""bfloat16 mixed-precision training (``Program.amp_dtype``) through the
port's Program/Executor against the JAX package, on the CPU.

The same calls build ``transformer_lm_loss`` + ``SGDOptimizer`` in both
packages (2 layers, width 64, 2 heads, sequence 32, vocab 200) with
``amp_dtype = "bfloat16"``; the JAX startup state is carried into the
port's Scope by name and both take one step on feeds made from a numpy
seed. What is held:

* the structure, exactly: the dtype of every var the forward writes
  (bfloat16 activations, float32 layer-norm statistics, loss and
  softmax), of every ``@GRAD`` (float32) and of every master after the
  step (float32);
* the numbers, within bf16's limits (its unit roundoff is 2^-8, 3.9e-3):
  the loss within AMP_LOSS_RTOL; each parameter's float32 gradient and
  its SGD update (the master's change, linear in the gradient) within
  AMP_GRAD_RTOL as rms of the difference over rms of the JAX one. The key
  biases' gradients are zero in exact arithmetic (q . b_k is the same
  for every key of a row), so they are rounding noise in both packages:
  each must stay below KEY_BIAS_RATIO of its layer's query-bias gradient
  (rms).

AMP_GRAD_RTOL is 5e-2: bf16 rounds at other places in the two packages
(XLA on the CPU keeps chains of elementwise ops in float32 between the
bfloat16 casts; eager PyTorch rounds after each op), and at this shape
the JAX package's own AMP gradients are 3.1e-2 (rms, relative) from its
float32 gradients, the port's 1.7e-2; the two packages' AMP gradients
differ by 3.1e-2. The same limit holds the port's AMP gradients to the
JAX package's float32 ones.

Then the port counterparts of tests/test_loop_amp.py's AMP tests, a
bf16 fetch (eager and lazy), the Trainer's checkpoint of an AMP program,
the conv ops under AMP (no op is refused: every kernel has a bfloat16
version), and the LSTM
under AMP: the stacked LSTM's program builds and trains (its numbers
against the JAX package are tests/test_torch_lstm_bf16.py's), and a
peephole ``dynamic_lstm``, which no kernel takes, runs the scan in
bfloat16 as the JAX package's ``lax.scan`` does (every fetch's dtype
exactly, the loss within AMP_LOSS_RTOL, the LSTM's hidden output within
2^-7 max|jax| + 2^-7 |jax|, each float32 gradient within AMP_GRAD_RTOL).
"""

import glob
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core import program as jprog
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as jtfm

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.models import transformer as ttfm

torch.set_num_threads(2)

CFG = dict(vocab_size=200, seq_len=32, n_layers=2, d_model=64, n_heads=2,
           d_ff=128, max_len=32)
BATCH, LR = 4, 0.1
AMP_LOSS_RTOL = 1e-2
AMP_GRAD_RTOL = 5e-2
KEY_BIAS_RATIO = 1e-2


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _rel(got, want):
    return _rms(np.asarray(got, np.float64) - want) / _rms(want)


def _build(pkg, prog_mod, tfm, amp="bfloat16"):
    prog_mod.reset_unique_names()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        avg, logits = tfm.transformer_lm_loss(**CFG)
        pkg.optimizer.SGDOptimizer(learning_rate=LR).minimize(avg)
    main.amp_dtype = amp
    return main, startup, avg, logits


def _feed():
    src = np.random.RandomState(100).randint(0, CFG["vocab_size"],
                                             (BATCH, CFG["seq_len"]))
    return {"src_ids": src.astype("int64"),
            "tgt_ids": src[..., None].astype("int64")}


def _forward_vars(main):
    """Every var an op before the autodiff op writes."""
    names = []
    for op in main.global_block.ops:
        if op.type == "autodiff":
            break
        names += [n for n in op.output_names() if n not in names]
    return names


def _dtype_name(x) -> str:
    return str(x.dtype).rsplit(".", 1)[-1]


@pytest.fixture(scope="module")
def runs():
    """One AMP SGD step in each package from the JAX startup state (and
    the JAX package's float32 step beside it), fetching the loss, every
    forward var and every gradient."""
    jmain, jstart, javg, _ = _build(jpt, jprog, jtfm)
    jmain32 = _build(jpt, jprog, jtfm, amp=None)[0]
    tmain, _, tavg, _ = _build(pt, tprog, ttfm)
    exe = jpt.Executor()
    jscope = JScope()
    exe.run(jstart, scope=jscope)
    persist = sorted(v.name for v in jmain.global_block.vars.values()
                     if v.persistable)
    start = {n: np.array(jscope.find_var(n)) for n in persist}
    params = [p.name for p in jmain.global_block.all_parameters()]
    fwd = _forward_vars(jmain)
    fetch = [javg.name] + fwd + [p + "@GRAD" for p in params]
    jout = exe.run(jmain, feed=_feed(), fetch_list=fetch, scope=jscope)
    j32scope = JScope()
    for n, a in start.items():
        j32scope.set_var(n, a)
    j32 = exe.run(jmain32, feed=_feed(), fetch_list=fetch, scope=j32scope)
    scope = tio.scope_from_numpy(start, "cpu")
    tout = pt.Executor(pt.CPUPlace()).run(tmain, feed=_feed(),
                                          fetch_list=fetch, scope=scope,
                                          return_numpy=False)
    return dict(fetch=fetch, fwd=fwd, params=params, start=start,
                jax=dict(zip(fetch, jout)), jax32=dict(zip(fetch, j32)),
                port=dict(zip(fetch, tout)), tavg=tavg.name,
                jmasters={p: np.array(jscope.find_var(p)) for p in params},
                tscope=scope)


def test_amp_structure_matches_jax(runs):
    """Every fetched var has the JAX package's dtype, exactly: bf16
    activations, float32 statistics, loss and gradients; the masters
    stay float32 after the step."""
    jax, port = runs["jax"], runs["port"]
    assert [_dtype_name(port[n]) for n in runs["fetch"]] == \
        [_dtype_name(np.asarray(jax[n])) for n in runs["fetch"]]
    dtypes = {_dtype_name(port[n]) for n in runs["fwd"]}
    assert dtypes == {"bfloat16", "float32"}
    for p in runs["params"]:
        assert _dtype_name(port[p + "@GRAD"]) == "float32", p
        assert runs["tscope"].find_var(p).dtype == torch.float32, p


def test_amp_loss_gradients_and_sgd_step_match_jax(runs):
    jax, jax32, port = runs["jax"], runs["jax32"], runs["port"]
    loss = runs["tavg"]
    np.testing.assert_allclose(float(port[loss].reshape(-1)[0]),
                               float(np.ravel(jax[loss])[0]),
                               rtol=AMP_LOSS_RTOL)
    worst = 0.0
    for p in runs["params"]:
        g = port[p + "@GRAD"].numpy()
        want, want32 = (np.asarray(x[p + "@GRAD"], np.float64)
                        for x in (jax, jax32))
        if p.endswith("_k_b"):
            q_b = p[:-len("_k_b")] + "_q_b@GRAD"
            for got, ref in ((g, port[q_b].numpy()), (want, jax[q_b])):
                assert _rms(got) <= KEY_BIAS_RATIO * _rms(ref), p
            continue
        worst = max(worst, _rel(g, want))
        assert _rel(g, want) <= AMP_GRAD_RTOL, (p, _rel(g, want))
        assert _rel(g, want32) <= AMP_GRAD_RTOL, (p, _rel(g, want32))
        update = runs["tscope"].get_numpy(p) - runs["start"][p]
        want_update = runs["jmasters"][p] - runs["start"][p]
        assert _rel(update, want_update) <= AMP_GRAD_RTOL, p
    assert worst > 0.0


# ---------------------------------------------------------------------------
# the port counterparts of tests/test_loop_amp.py's AMP tests
# ---------------------------------------------------------------------------

def _mlp_program(in_dim=4, hidden=8, lr=0.1, dtype="float32"):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [in_dim], dtype=dtype)
        y = pt.layers.data("y", [1], dtype=dtype)
        h = pt.layers.fc(input=x, size=hidden, act="relu")
        pred = pt.layers.fc(input=h, size=1)
        loss = pt.layers.mean(pt.layers.square(
            pt.layers.elementwise_sub(pred, y)))
        pt.optimizer.SGDOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, loss


def _mlp_feed(rng, batch=8, in_dim=4, dtype="float32"):
    x = rng.rand(batch, in_dim).astype("float32")
    y = (x.sum(axis=1, keepdims=True) * 0.5).astype("float32")
    if dtype == "bfloat16":
        x, y = x.astype(ml_dtypes.bfloat16), y.astype(ml_dtypes.bfloat16)
    return {"x": x, "y": y}


def _train_mlp(main, startup, loss, feed):
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    losses, = exe.run_loop(main, feed=feed, fetch_list=[loss], n_steps=8,
                           scope=scope)
    return losses, scope


def test_amp_f32_masters_train():
    main, startup, loss = _mlp_program()
    main.amp_dtype = "bfloat16"
    losses, scope = _train_mlp(main, startup, loss,
                               _mlp_feed(np.random.RandomState(0)))
    assert losses.dtype == np.float32
    assert losses[-1] < losses[0]
    for p in main.global_block.all_parameters():
        assert scope.find_var(p.name).dtype == torch.float32, p.name


def test_master_weights_for_bf16_activations():
    """bfloat16 data (numpy bfloat16 feeds) with float32 parameters and
    no AMP: harmonize casts the parameters where they meet the
    activations; the gradients reach the float32 masters."""
    main, startup, loss = _mlp_program(dtype="bfloat16")
    for p in main.global_block.all_parameters():
        assert p.dtype == "float32", p.name
    losses, scope = _train_mlp(main, startup, loss, _mlp_feed(
        np.random.RandomState(0), dtype="bfloat16"))
    assert losses[-1] < losses[0]
    for p in main.global_block.all_parameters():
        assert scope.find_var(p.name).dtype == torch.float32, p.name


def test_amp_masters_accumulate_sub_resolution_updates():
    """The optimizer updates the float32 masters, not the bf16-cast
    copies: per-step deltas below bf16's resolution still accumulate."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [1])
        y = pt.layers.data("y", [1])
        pred = pt.layers.fc(input=x, size=1, param_attr=pt.ParamAttr(
            initializer=pt.initializer.ConstantInitializer(1.0)),
            bias_attr=False)
        loss = pt.layers.mean(pt.layers.square(
            pt.layers.elementwise_sub(pred, y)))
        pt.optimizer.SGDOptimizer(learning_rate=5e-5).minimize(loss)
    main.amp_dtype = "bfloat16"
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((4, 1), np.float32),
            "y": np.full((4, 1), 2.0, np.float32)}
    for _ in range(20):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    w = float(scope.get_numpy(main.global_block.all_parameters()[0].name).ravel()[0])
    # grad = 2 (w - 2) ~ -2, so a step moves w by ~1e-4, far below bf16's
    # resolution at 1.0 (0.0078); 20 steps accumulate ~2e-3 in the master
    assert w > 1.0 + 1e-3, w


def test_amp_dtype_survives_clone_and_json():
    main, _, _ = _mlp_program()
    main.amp_dtype = "bfloat16"
    assert main.clone().amp_dtype == "bfloat16"
    assert main.clone(for_test=True).amp_dtype == "bfloat16"
    assert pt.Program.from_dict(
        json.loads(main.to_json())).amp_dtype == "bfloat16"


def test_amp_inference_clone_runs_in_float32_with_the_masters():
    """The inference clone keeps amp_dtype; with no autodiff op nothing
    casts the parameters, so an LM over int ids computes in float32 (as
    the JAX package's clone does) and agrees with the float32 program."""
    main, startup, _, logits = _build(pt, tprog, ttfm)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"src_ids": _feed()["src_ids"]}
    test = main.clone(for_test=True).prune([logits.name])
    assert test.amp_dtype == "bfloat16"
    got, = exe.run(test, feed=feed, fetch_list=[logits], scope=scope,
                   return_numpy=False)
    test.amp_dtype = None
    want, = exe.run(test, feed=feed, fetch_list=[logits], scope=scope,
                    return_numpy=False)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# fetching bfloat16, the step's contract and the Trainer under AMP
# ---------------------------------------------------------------------------

def test_bf16_fetch_comes_back_as_float32_numpy():
    """numpy has no bfloat16: a bf16 fetch comes back widened to float32
    (exactly), eagerly and through a LazyFetch handle."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4], dtype="bfloat16")
        h = pt.layers.fc(input=x, size=8, act="relu")
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": _mlp_feed(np.random.RandomState(0), dtype="bfloat16")["x"]}
    dev, = exe.run(main, feed=feed, fetch_list=[h], scope=scope,
                   return_numpy=False)
    assert dev.dtype == torch.bfloat16
    want = dev.float().numpy()
    eager, = exe.run(main, feed=feed, fetch_list=[h], scope=scope)
    lazy, = exe.run(main, feed=feed, fetch_list=[h], scope=scope, lazy=True)
    assert lazy.dtype == np.float32
    for got in (eager, lazy.numpy(), np.asarray(lazy)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert float(lazy) == float(want.reshape(-1)[0])


def test_step_contract_and_trainer_checkpoint_under_amp(tmp_path):
    """Under AMP the clip, the L2 decay, the guard and Adam run on float32
    gradients and masters, and the Trainer's checkpoint holds float32
    masters equal to the scope's."""
    rs = np.random.RandomState(11)
    data = [(rs.randn(4).astype(np.float32),
             rs.randn(1).astype(np.float32)) for _ in range(16)]

    def reader():
        for b in range(0, len(data), 4):
            yield data[b:b + 4]

    def train_func():
        x = pt.layers.data("x", [4])
        y = pt.layers.data("y", [1])
        h = pt.layers.fc(x, size=8, act="tanh")
        pred = pt.layers.fc(h, size=1)
        return [pt.layers.mean(pt.layers.square(
            pt.layers.elementwise_sub(pred, y)))]

    def optimizer_func():
        pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(0.5))
        return pt.optimizer.AdamOptimizer(
            learning_rate=0.05, regularization=pt.regularizer.L2Decay(1e-3))

    tprog.reset_unique_names()
    ckpt = str(tmp_path / "ckpt")
    trainer = pt.Trainer(train_func, optimizer_func, place=pt.CPUPlace(),
                         checkpoint_config=pt.CheckpointConfig(
                             ckpt, step_interval=2))
    trainer.train_program.amp_dtype = "bfloat16"
    params = [p.name for p in trainer.train_program.global_block.all_parameters()]
    grads, = [trainer.exe.run(
        trainer.train_program, feed={"x": np.stack([d[0] for d in data[:4]]),
                                     "y": np.stack([d[1] for d in data[:4]])},
        fetch_list=[p + "@GRAD" for p in params], scope=trainer.scope,
        return_numpy=False)]
    assert all(g.dtype == torch.float32 for g in grads)
    losses = []

    def handler(event):
        if isinstance(event, pt.EndStepEvent):
            losses.append(float(np.ravel(np.asarray(event.metrics[0]))[0]))
    trainer.train(num_epochs=2, event_handler=handler, reader=reader)
    assert len(losses) == 8 and np.isfinite(losses).all()
    state = {n: trainer.scope.find_var(n) for n in
             trainer.scope.local_var_names()}
    assert all(state[p].dtype == torch.float32 for p in params)
    assert all(v.dtype == torch.float32 for n, v in state.items()
               if "_moment" in n)
    serials = sorted(glob.glob(os.path.join(ckpt, "checkpoint_*")))
    assert serials
    for p in params:
        (path,) = glob.glob(os.path.join(serials[-1], "**", p + ".npy"),
                            recursive=True)
        saved = np.load(path)
        assert saved.dtype == np.float32, p
        np.testing.assert_array_equal(saved, state[p].numpy())


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _refused_program(what):
    """(main, startup, loss, feed) of a small program whose step needs
    `what`: conv2d + batch_norm + relu (the Executor's fusion pass makes
    it one fused_conv2d), a fused_bottleneck block."""
    tprog.reset_unique_names()
    main, startup = pt.Program(), pt.Program()
    rng = np.random.RandomState(0)
    with pt.program_guard(main, startup):
        img = pt.layers.data("img", [16, 8, 8])
        if what == "fused_bottleneck":
            out = pt.layers.fused_bottleneck(img, ch_out=4)
        else:
            out = pt.layers.batch_norm(pt.layers.conv2d(
                img, num_filters=4, filter_size=3, padding=1,
                bias_attr=False), act="relu")
        loss = pt.layers.mean(out)
        pt.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, loss, {
        "img": rng.randn(2, 16, 8, 8).astype(np.float32)}


@pytest.mark.parametrize("what", ["fused_conv2d", "fused_bottleneck"])
def test_amp_refuses_ops_without_a_bf16_kernel(what, monkeypatch):
    """Every kernel has a bfloat16 version, so no op is refused under
    AMP; the program runs without AMP and with it. The conv epilogue has
    bfloat16 kernels, so fused_conv2d runs under AMP (a finite loss,
    float32 masters); fused_bottleneck trains under AMP too, composed and
    where PT_FUSED_BLOCK asks for the chain (always or 1): the chain has
    bfloat16 kernels forward and backward."""
    monkeypatch.delenv("PT_FUSED_BLOCK", raising=False)
    main, startup, loss, feed = _refused_program(what)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    main.amp_dtype = "bfloat16"
    out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(out).all()
    for p in main.global_block.all_parameters():
        assert scope.find_var(p.name).dtype == torch.float32, p.name
    if what == "fused_bottleneck":
        for mode in ("always", "1"):
            monkeypatch.setenv("PT_FUSED_BLOCK", mode)
            out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            assert np.isfinite(out).all()
            for p in main.global_block.all_parameters():
                assert scope.find_var(p.name).dtype == torch.float32


def test_amp_lstm_program_builds_and_trains():
    """The stacked LSTM (dynamic_lstm over LSTMSequence, whose bf16 kernels
    the card runs) under AMP: the step builds, the loss comes back as
    bfloat16 widened to float32 and falls over Adam steps on one feed,
    and the masters stay float32."""
    from paddle_tpu_torch.models import stacked_dynamic_lstm

    tprog.reset_unique_names()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        loss = stacked_dynamic_lstm.get_model(
            dict_size=100, lstm_size=32, emb_dim=16, use_fused=True)[0]
    main.amp_dtype = "bfloat16"
    rng = np.random.RandomState(0)
    feed = {"words": rng.randint(0, 100, (4, 8)).astype("int64"),
            "label": rng.randint(0, 2, (4, 1)).astype("int64")}
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    losses = []
    for _ in range(6):
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        assert out.dtype == np.float32
        losses.append(float(out.reshape(-1)[0]))
    assert np.isfinite(losses).all() and min(losses[1:]) < losses[0]
    for p in main.global_block.all_parameters():
        assert scope.find_var(p.name).dtype == torch.float32, p.name


def _peephole_program(pkg, prog_mod):
    prog_mod.reset_unique_names()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        words = pkg.layers.data(name="words", shape=[1], lod_level=1,
                                dtype="int64")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        emb = pkg.layers.embedding(input=words, size=[100, 16])
        proj = pkg.layers.fc(input=emb, size=4 * 32)
        hidden, _ = pkg.layers.dynamic_lstm(proj, size=4 * 32,
                                            use_peepholes=True)
        last = pkg.layers.sequence_pool(hidden, "last")
        prob = pkg.layers.fc(input=last, size=2, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(input=prob,
                                                        label=label))
        pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    main.amp_dtype = "bfloat16"
    return main, startup, loss, hidden


def test_amp_peephole_lstm_runs_the_bf16_scan_as_jax_does():
    jmain, jstart, jloss, jhidden = _peephole_program(jpt, jprog)
    tmain = _peephole_program(pt, tprog)[0]
    exe, jscope = jpt.Executor(), JScope()
    exe.run(jstart, scope=jscope)
    start = {v.name: np.array(jscope.find_var(v.name))
             for v in jmain.global_block.vars.values() if v.persistable}
    params = [p.name for p in jmain.global_block.all_parameters()]
    rng = np.random.RandomState(3)
    lens = rng.randint(1, 9, 4)
    lens[0], lens[1] = 1, 8
    feed = {"words": [rng.randint(0, 100, (n, 1)).astype("int64")
                      for n in lens],
            "label": rng.randint(0, 2, (4, 1)).astype("int64")}
    fetch = [jloss.name, jhidden.name] + [p + "@GRAD" for p in params]
    jout = exe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
    tout = pt.Executor(pt.CPUPlace()).run(
        tmain, feed=feed, fetch_list=fetch,
        scope=tio.scope_from_numpy(start, "cpu"), return_numpy=False)
    assert [_dtype_name(t) for t in tout] == [
        _dtype_name(np.asarray(j)) for j in jout]
    assert _dtype_name(tout[1]) == "bfloat16"
    got = [t.float().numpy() for t in tout]
    want = [np.asarray(j).astype(np.float32) for j in jout]
    np.testing.assert_allclose(got[0].reshape(-1)[0], want[0].reshape(-1)[0],
                               rtol=AMP_LOSS_RTOL)
    lim = 2.0 ** -7 * (np.abs(want[1]).max() + np.abs(want[1]))
    assert (np.abs(got[1] - want[1]) <= lim).all()
    for p, g, w in zip(params, got[2:], want[2:]):
        assert _rel(g, w) <= AMP_GRAD_RTOL, (p, _rel(g, w))


def test_amp_dtype_other_than_bfloat16_is_not_ported():
    main, startup, loss = _mlp_program()
    main.amp_dtype = "float16"
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(NotImplementedError, match="not ported"):
        exe.run(main, feed=_mlp_feed(np.random.RandomState(0)),
                fetch_list=[loss], scope=scope)
