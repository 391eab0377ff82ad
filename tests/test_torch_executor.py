"""Training through the port's Program/Executor against the JAX package.

The same calls build ``transformer_lm_loss`` + ``AdamOptimizer`` in both
packages (2 layers, width 64, 2 heads, sequence 32, vocab 200). The JAX
startup state is carried into the port's Scope by name, then both take
the same Adam steps on feeds made from a numpy seed, on the CPU.

Tolerances: float32 on both sides with sums in other orders through two
layers and a 200-way softmax: losses within rtol 1e-4; first-step
gradients within atol 1e-5, rtol 1e-4. After 3 steps each parameter's
update (end minus start) and each Adam accumulator agree as a whole:
rms(port - JAX) <= STATE_RTOL * rms(JAX). The key biases are the
exception: their gradient is zero in exact arithmetic (q . b_k is the
same for every key of a row, and softmax ignores it), so their
gradients, moments and updates are rounding noise that Adam scales to
about 1e-2 lr; both packages must leave them within 0.05 lr (rms) of
where they started. Measured against the JAX package: updates within
1.3e-4 relative, moments within 1e-5; key-bias updates 3e-7..7e-7 rms,
against 1.6e-4 for the smallest real update.
"""

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
from paddle_tpu_torch.core.types import torch_dtype
from paddle_tpu_torch.models import transformer as ttfm

torch.set_num_threads(2)

CFG = dict(vocab_size=200, seq_len=32, n_layers=2, d_model=64, n_heads=2,
           d_ff=128, max_len=32)
LR, BATCH, STEPS = 1e-4, 4, 3
STATE_RTOL = 1e-3
ZERO_GRAD_MOVE = 0.05 * LR


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a.astype(np.float64)))))


def _assert_state_matches(got_end, want_end, start, names):
    """Each parameter's update and each accumulator, as a whole, within
    STATE_RTOL (rms); the key biases and their moments as the module
    docstring says."""
    for n in names:
        got, want = got_end[n], want_end[n]
        is_acc = "_moment" in n or "_pow_acc" in n
        if not is_acc:
            got, want = got - start[n], want - start[n]
        if n.split("_moment")[0].endswith("_k_b"):
            if not is_acc:
                assert max(_rms(got), _rms(want)) <= ZERO_GRAD_MOVE, n
            continue
        err = _rms(got - want)
        assert err <= STATE_RTOL * _rms(want), \
            f"{n}: rms diff {err:.3e} vs rms {_rms(want):.3e}"


def _build(pkg, prog_mod, tfm):
    prog_mod.reset_unique_names()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        avg, logits = tfm.transformer_lm_loss(**CFG)
        pkg.optimizer.AdamOptimizer(learning_rate=LR).minimize(avg)
    return main, startup, avg, logits


def _feeds(i):
    rng = np.random.RandomState(100 + i)
    src = rng.randint(0, CFG["vocab_size"], (BATCH, CFG["seq_len"]))
    return {"src_ids": src.astype("int64"), "tgt_ids": src[..., None]
            .astype("int64")}


def _persistables(main):
    return {v.name: v for v in main.global_block.vars.values()
            if v.persistable}


@pytest.fixture(scope="module")
def built():
    jmain, jstart, javg, _ = _build(jpt, jprog, jtfm)
    tmain, tstart, tavg, _ = _build(pt, tprog, ttfm)
    return dict(jmain=jmain, jstart=jstart, javg=javg, tmain=tmain,
                tstart=tstart, tavg=tavg)


@pytest.fixture(scope="module")
def jax_run(built):
    """The JAX side: startup, then STEPS Adam steps. Returns the start
    state, per-step losses, step-1 gradients and the final state."""
    exe, scope = jpt.Executor(), JScope()
    exe.run(built["jstart"], scope=scope)
    names = sorted(_persistables(built["jmain"]))
    start = {n: np.array(scope.find_var(n)) for n in names}
    params = [p.name for p in built["jmain"].global_block.all_parameters()]
    losses, grads = [], None
    for i in range(STEPS):
        fetch = [built["javg"].name] + ([p + "@GRAD" for p in params]
                                        if i == 0 else [])
        out = exe.run(built["jmain"], feed=_feeds(i), fetch_list=fetch,
                      scope=scope)
        losses.append(float(out[0][0]))
        if i == 0:
            grads = dict(zip(params, out[1:]))
    end = {n: np.array(scope.find_var(n)) for n in names}
    return dict(start=start, losses=losses, grads=grads, end=end,
                params=params)


def test_programs_match_op_for_op(built):
    """The same build calls give the same programs: op types in order
    first (the readable failure), then the whole IR (every op's slots
    and attrs, every var's name, shape, dtype and flags)."""
    for which in ("main", "start"):
        jprog_, tprog_ = built["j" + which], built["t" + which]
        assert [op.type for op in tprog_.global_block.ops] == \
            [op.type for op in jprog_.global_block.ops]
        assert tprog_.to_dict() == jprog_.to_dict()
    assert sorted(_persistables(built["tmain"])) == \
        sorted(_persistables(built["jmain"]))


def test_startup_gives_every_var_its_shape_and_value(built):
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(built["tstart"], scope=scope)
    block = built["tstart"].global_block
    for op in block.ops:
        (name,) = op.output("Out")
        t = scope.find_var(name)
        var = block.var(name)
        assert tuple(t.shape) == var.shape and \
            t.dtype == torch_dtype(var.dtype), name
        if op.type == "fill_constant":
            assert bool((t == op.attrs["value"]).all()), name
        elif op.type == "uniform_random":
            assert op.attrs["min"] <= float(t.min()) and \
                float(t.max()) <= op.attrs["max"], name
            assert float(t.std()) > 0.2 * op.attrs["max"], name
        else:
            assert op.type == "gaussian_random"
            assert abs(float(t.std()) - op.attrs["std"]) < \
                0.1 * op.attrs["std"], name
    assert set(scope.local_var_names()) == set(_persistables(built["tmain"]))


def test_adam_steps_match_jax(built, jax_run):
    exe = pt.Executor(pt.CPUPlace())
    scope = tio.scope_from_numpy(jax_run["start"], "cpu")
    params = jax_run["params"]
    assert params == [p.name for p in
                      built["tmain"].global_block.all_parameters()]
    for i in range(STEPS):
        fetch = [built["tavg"]] + ([p + "@GRAD" for p in params]
                                   if i == 0 else [])
        out = exe.run(built["tmain"], feed=_feeds(i), fetch_list=fetch,
                      scope=scope)
        np.testing.assert_allclose(out[0][0], jax_run["losses"][i],
                                   rtol=1e-4)
        if i == 0:
            for p, g in zip(params, out[1:]):
                np.testing.assert_allclose(g, jax_run["grads"][p],
                                           atol=1e-5, rtol=1e-4,
                                           err_msg=p)
    names = sorted(jax_run["end"])
    _assert_state_matches({n: scope.get_numpy(n) for n in names},
                          jax_run["end"], jax_run["start"], names)


def test_run_loop_equals_run_calls(built, jax_run):
    feeds = [_feeds(i) for i in range(STEPS)]
    stacked = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
    exe = pt.Executor(pt.CPUPlace())
    s_loop = tio.scope_from_numpy(jax_run["start"], "cpu")
    s_run = tio.scope_from_numpy(jax_run["start"], "cpu")
    loop_losses, = exe.run_loop(built["tmain"], feed=stacked,
                                fetch_list=[built["tavg"]], n_steps=STEPS,
                                scope=s_loop, per_step_feeds=True)
    run_losses = [exe.run(built["tmain"], feed=f, fetch_list=[built["tavg"]],
                          scope=s_run)[0] for f in feeds]
    assert loop_losses.shape == (STEPS, 1)
    np.testing.assert_array_equal(loop_losses, np.stack(run_losses))
    for n in jax_run["start"]:
        np.testing.assert_array_equal(s_loop.get_numpy(n),
                                      s_run.get_numpy(n), err_msg=n)


def test_program_and_module_give_the_same_logits(built, jax_run):
    """Two steps through the Program path, then the scope's parameters
    loaded by name into TransformerLM: its forward logits equal the
    Executor's logits from an inference program built with the same
    names (float32, other product shapes: atol = rtol = 1e-5)."""
    exe = pt.Executor(pt.CPUPlace())
    scope = tio.scope_from_numpy(jax_run["start"], "cpu")
    for i in range(2):
        exe.run(built["tmain"], feed=_feeds(i), fetch_list=[built["tavg"]],
                scope=scope)
    infer = pt.Program()
    with pt.program_guard(infer, pt.Program()):
        src = pt.layers.data("src_ids", [CFG["seq_len"]], dtype="int64")
        logits = ttfm.transformer_lm(
            src, CFG["vocab_size"], **{k: CFG[k] for k in
                                       ("n_layers", "d_model", "n_heads",
                                        "d_ff", "max_len")})
    ids = _feeds(5)["src_ids"]
    got, = exe.run(infer, feed={"src_ids": ids}, fetch_list=[logits],
                   scope=scope)
    model = ttfm.TransformerLM(CFG["vocab_size"], CFG["n_layers"],
                               CFG["d_model"], CFG["n_heads"], CFG["d_ff"],
                               max_context=CFG["seq_len"], device="cpu")
    model.load_jax_params({p: scope.find_var(p) for p in
                           ttfm.param_shapes(model.cfg)})
    with torch.no_grad():
        want = model(torch.from_numpy(ids))[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)



def test_program_and_module_agree_at_head_dim_256():
    """The same check at the flash kernels' widest head (d_model 512, 2
    heads of 256) from the port's own startup, with the inference program
    reading a 24-token prompt through the 32-row pos_emb the model was
    trained with (pos_table_len, the slice the serving module takes)."""
    cfg = dict(CFG, d_model=512, n_heads=2, d_ff=1024)
    tprog.reset_unique_names()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    with pt.program_guard(main, startup):
        avg, _ = ttfm.transformer_lm_loss(**cfg)
        pt.optimizer.AdamOptimizer(learning_rate=LR).minimize(avg)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    for i in range(2):
        exe.run(main, feed=_feeds(i), fetch_list=[avg], scope=scope)
    n = 24
    infer = pt.Program()
    with pt.program_guard(infer, pt.Program()):
        src = pt.layers.data("src_ids", [n], dtype="int64")
        logits = ttfm.transformer_lm(
            src, cfg["vocab_size"], pos_table_len=cfg["seq_len"],
            **{k: cfg[k] for k in ("n_layers", "d_model", "n_heads", "d_ff",
                                   "max_len")})
    assert "slice" in [op.type for op in infer.global_block.ops]
    ids = _feeds(5)["src_ids"][:, :n]
    got, = exe.run(infer, feed={"src_ids": ids}, fetch_list=[logits],
                   scope=scope)
    model = ttfm.TransformerLM(cfg["vocab_size"], cfg["n_layers"],
                               cfg["d_model"], cfg["n_heads"], cfg["d_ff"],
                               max_context=cfg["seq_len"], device="cpu")
    model.load_jax_params({p: scope.find_var(p) for p in
                           ttfm.param_shapes(model.cfg)})
    with torch.no_grad():
        want = model(torch.from_numpy(ids))[0].numpy()
    assert got.shape == (BATCH, n, cfg["vocab_size"])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

def test_sgd_step_matches_jax():
    """SGDOptimizer: one step of a one-layer LM from the carried JAX
    state gives the JAX parameters (lr 0.1, so the update is visible)."""
    cfg = dict(CFG, n_layers=1)
    built = []
    for pkg, prog_mod, tfm in ((jpt, jprog, jtfm), (pt, tprog, ttfm)):
        prog_mod.reset_unique_names()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            avg, _ = tfm.transformer_lm_loss(**cfg)
            pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(avg)
        built.append((main, startup, avg))
    (jmain, jstart, javg), (tmain, _, tavg) = built
    assert [op.type for op in tmain.global_block.ops] == \
        [op.type for op in jmain.global_block.ops]
    jexe, jscope = jpt.Executor(), JScope()
    jexe.run(jstart, scope=jscope)
    names = sorted(_persistables(jmain))
    start = {n: np.array(jscope.find_var(n)) for n in names}
    jloss, = jexe.run(jmain, feed=_feeds(0), fetch_list=[javg], scope=jscope)
    scope = tio.scope_from_numpy(start, "cpu")
    tloss, = pt.Executor(pt.CPUPlace()).run(tmain, feed=_feeds(0),
                                            fetch_list=[tavg], scope=scope)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    for n in names:
        np.testing.assert_allclose(scope.get_numpy(n),
                                   np.array(jscope.find_var(n)), atol=1e-5,
                                   rtol=1e-4, err_msg=n)


@pytest.mark.parametrize("what", ["remat", "dropout", "tp_shard", "sp_mode",
                                  "amp", "is_sparse", "trainer_parallel",
                                  "trainer_plan", "op", "fc_inputs"])
def test_what_is_not_ported_raises(what):
    """Each part of training the port leaves out raises a clear error,
    on the CPU as on every device, instead of running without it."""
    kw = dict(CFG)
    build_kw = {"remat": dict(remat=True), "dropout": dict(dropout_rate=0.1),
                "tp_shard": dict(tp_shard=True),
                "sp_mode": dict(sp_mode="ring")}.get(what, {})
    tprog.reset_unique_names()
    main, startup = pt.Program(), pt.Program()
    if what == "fc_inputs":
        with pt.program_guard(main, startup):
            x = pt.layers.data("x", [4], dtype="float32")
            with pytest.raises(NotImplementedError, match="not ported"):
                pt.layers.fc([x, x], size=3)
        return
    if what.startswith("trainer_"):
        trainer_kw = {"trainer_parallel": dict(parallel=True),
                      "trainer_plan": dict(plan={"mesh": {"dp": 2}})}[what]

        def train_func():
            return [ttfm.transformer_lm_loss(**kw)[0]]
        with pytest.raises(NotImplementedError, match="not ported"):
            pt.Trainer(train_func,
                       lambda: pt.optimizer.AdamOptimizer(learning_rate=LR),
                       place=pt.CPUPlace(), **trainer_kw)
        return
    if build_kw:
        with pt.program_guard(main, startup):
            with pytest.raises(NotImplementedError, match="not ported"):
                ttfm.transformer_lm_loss(**kw, **build_kw)
        return
    with pt.program_guard(main, startup):
        if what == "is_sparse":
            ids = pt.layers.data("ids", [4], dtype="int64")
            emb = pt.layers.embedding(ids, [10, 8], is_sparse=True)
            avg = pt.layers.mean(emb)
        else:
            avg, _ = ttfm.transformer_lm_loss(**kw)
        if what == "op":
            main.global_block.append_op("dropout", {"X": avg}, {"Out": avg})
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = ({"ids": np.zeros((2, 4), np.int64)} if what == "is_sparse"
            else _feeds(0))
    if what == "amp":
        main.amp_dtype = "bfloat16"
    with pytest.raises(NotImplementedError, match="not ported"):
        exe.run(main, feed=feed, fetch_list=[avg], scope=scope)


def test_minimize_appends_step_health_under_pt_guard(monkeypatch):
    """With PT_GUARD set, minimize appends the step-health op directly
    after the backward boundary, as the JAX package's does; without it,
    none."""
    for policy in ("", "skip"):
        monkeypatch.setenv("PT_GUARD", policy)
        built = []
        for pkg, prog_mod, tfm in ((jpt, jprog, jtfm), (pt, tprog, ttfm)):
            prog_mod.reset_unique_names()
            main = pkg.Program()
            with pkg.program_guard(main, pkg.Program()):
                avg, _ = tfm.transformer_lm_loss(**CFG)
                pkg.optimizer.AdamOptimizer(learning_rate=LR).minimize(avg)
            built.append([(op.type, op.inputs) for op in
                          main.global_block.ops])
        assert built[1] == built[0]
        types = [t for t, _ in built[1]]
        assert ("step_health" in types) == bool(policy)
        if policy:
            assert types.index("step_health") == \
                types.index("autodiff") + 1
