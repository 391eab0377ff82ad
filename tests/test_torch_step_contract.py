"""The training step's contract in the port against the JAX package.

Gradient clipping (clip.py), weight decay (regularizer.py), per-parameter
learning rates, bfloat16 optimizer state (PT_OPT_STATE_DTYPE), a second
append_backward on one block, the learning-rate schedules
(layers/learning_rate_scheduler.py), lazy fetch handles
(core/async_fetch.py) and the step guard (resilience/guard.py), each
built by the same calls in both packages, on the CPU, from numpy seeds.
The JAX startup state is carried into the port's Scope by name.

Tolerances: the ops and the schedules' rates, float32 elementwise work
and short sums, atol = rtol = 1e-5 (the integer and bool ops exactly);
losses rtol 1e-5; updated state (parameters and accumulators) atol 1e-5,
rtol 1e-4, as tests/test_torch_executor.py holds it; bfloat16 moments
within one bfloat16 step (rtol 2^-7) of JAX's, since float32 values
that agree to 1e-7 can round to neighbouring bfloat16 numbers. The
guard's skipped steps leave the state bit-identical, and its flag equals
JAX's. On the LM (2 layers, width 32) the key biases are left out of the
state check, as test_torch_executor.py explains: their gradient is zero
in exact arithmetic and Adam scales its rounding noise up.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jpt
from paddle_tpu.core import program as jprog
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as jtfm
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.resilience import guard as jguard

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.async_fetch import LazyFetch, materialize
from paddle_tpu_torch.core.registry import ExecContext
from paddle_tpu_torch.models import transformer as ttfm
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.resilience import guard as tguard

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
STATE_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_RTOL = 2.0 ** -7
PKGS = {"jax": (jpt, jprog), "torch": (pt, tprog)}


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    """No armed fault plan or guard knob leaks between tests."""
    for var in ("PT_FAULT_INJECT", "PT_GUARD", "PT_GUARD_PATIENCE",
                "PT_GUARD_MAX_GNORM", "PT_OPT_STATE_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


def _arm(monkeypatch, spec):
    monkeypatch.setenv("PT_FAULT_INJECT", spec)
    jfaults.reset()
    tfaults.reset()


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the ops the contract appends
# ---------------------------------------------------------------------------

_X = 2 * _rand(0, 2, 3, 4)
_Y3 = _rand(1, 3)
_OP_CASES = {
    "scale": ({"X": [_X]}, {"scale": 2.5, "bias": 0.5}),
    "scale_bias_first": ({"X": [_X]}, {"scale": 2.5, "bias": 0.5,
                                        "bias_after_scale": False}),
    "sign": ({"X": [_X]}, {}),
    "elementwise_sub": ({"X": [_X], "Y": [_Y3]}, {"axis": 1}),
    "elementwise_mul": ({"X": [_X], "Y": [_rand(2, 4)]}, {"axis": -1}),
    "elementwise_div": ({"X": [_X], "Y": [np.abs(_Y3) + 0.5]}, {"axis": 1}),
    "elementwise_max": ({"X": [_X], "Y": [_rand(3, 2, 3, 4)]}, {}),
    "elementwise_min": ({"X": [_X], "Y": [_rand(3, 2, 3, 4)]}, {}),
    "elementwise_pow": ({"X": [np.abs(_X) + 0.1],
                         "Y": [np.float32([1.5])]}, {}),
    "clip": ({"X": [_X]}, {"min": -0.5, "max": 0.7}),
    "clip_by_norm": ({"X": [_X]}, {"max_norm": 1.0}),
    "clip_by_norm_inactive": ({"X": [_X]}, {"max_norm": 100.0}),
    "squared_l2_norm": ({"X": [_X]}, {}),
    "sum": ({"X": [_X, 2 * _X, _rand(4, 2, 3, 4)]}, {}),
    "sqrt": ({"X": [np.abs(_X)]}, {}),
    "exp": ({"X": [_X]}, {}),
    "floor": ({"X": [_X]}, {}),
    "ceil": ({"X": [_X]}, {}),
    "cast": ({"X": [_X]}, {"in_dtype": "float32", "out_dtype": "int32"}),
    "cast_bool": ({"X": [_X > 0]}, {"in_dtype": "bool",
                                    "out_dtype": "float32"}),
    "increment": ({"X": [np.float32([3.0])]}, {"step": 1.0}),
    "increment_int": ({"X": [np.int32([3])]}, {"step": 2.0}),
    "less_than": ({"X": [_X], "Y": [_Y3]}, {"axis": 1}),
    "less_equal": ({"X": [np.floor(_X)], "Y": [np.float32([0.0])]}, {}),
    "greater_than": ({"X": [_X], "Y": [_Y3]}, {"axis": 1}),
    "greater_equal": ({"X": [np.floor(_X)], "Y": [np.float32([0.0])]}, {}),
    "equal": ({"X": [np.floor(_X)], "Y": [np.float32([0.0])]}, {}),
    "not_equal": ({"X": [np.floor(_X)], "Y": [np.float32([0.0])]}, {}),
}


@pytest.mark.parametrize("case", sorted(_OP_CASES))
def test_op_matches_jax(case):
    ins, attrs = _OP_CASES[case]
    op_type = {"scale_bias_first": "scale", "cast_bool": "cast",
               "increment_int": "increment",
               "clip_by_norm_inactive": "clip_by_norm"}.get(case, case)
    want = np.asarray(jreg.get_op(op_type).compute(
        None, {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        attrs)["Out"][0])
    ctx = ExecContext(torch.Generator(), torch.device("cpu"))
    got = treg.require_op(op_type).compute(
        ctx, {k: [torch.from_numpy(np.asarray(v)) for v in vs]
              for k, vs in ins.items()}, attrs)["Out"][0].numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# programs built by the same calls in both packages
# ---------------------------------------------------------------------------

def _feed(i, batch=4):
    rs = np.random.RandomState(100 + i)
    x = rs.randn(batch, 4).astype(np.float32)
    y = (np.sin(x).sum(1, keepdims=True) * 0.5).astype(np.float32)
    return {"x": x, "y": y}


def _regression(pkg, param_attr=None):
    """fc(8, tanh) -> fc(1), mean squared error."""
    x = pkg.layers.data("x", [4])
    y = pkg.layers.data("y", [1])
    h = pkg.layers.fc(x, size=8, act="tanh", param_attr=param_attr)
    pred = pkg.layers.fc(h, size=1)
    return pkg.layers.mean(pkg.layers.square(
        pkg.layers.elementwise_sub(pred, y)))


def _build(which, make_opt, param_attr=None, clip=None, before=None,
           net=None):
    """(main, startup, loss) of `which` package: the net, an optional
    set_gradient_clip, an optional `before(pkg, loss)` hook, then
    make_opt(pkg).minimize(loss)."""
    pkg, prog_mod = PKGS[which]
    prog_mod.reset_unique_names()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        loss = (net or _regression)(
            pkg, param_attr(pkg) if param_attr else None)
        if clip is not None:
            pkg.clip.set_gradient_clip(clip(pkg))
        if before is not None:
            before(pkg, loss)
        make_opt(pkg).minimize(loss)
    return main, startup, loss


def _persistables(main):
    return sorted(n for n, v in main.global_block.vars.items()
                  if v.persistable)


def _jax_state(jscope, names):
    return {n: np.asarray(jscope.find_var(n)) for n in names
            if jscope.find_var(n) is not None}


def _to_port_scope(arrays):
    """The JAX state as a port Scope on the CPU; bfloat16 arrays (which
    torch cannot take from numpy) go through float32."""
    scope = pt.Scope()
    for n, a in arrays.items():
        if a.dtype.name == "bfloat16":
            scope.set_var(n, torch.from_numpy(a.astype(np.float32))
                          .to(torch.bfloat16))
        else:
            scope.set_var(n, pt.io._tensor(a, "cpu"))
    return scope


def _port_state(scope, names):
    out = {}
    for n in names:
        v = scope.find_var(n)
        if v is not None:
            out[n] = v.float().numpy() if v.dtype == torch.bfloat16 \
                else v.numpy()
    return out


def _train_both(make_opt, steps=3, feeds=_feed, **build_kw):
    """The same steps from the same startup state in both packages:
    (port losses, JAX losses, port state, JAX state, port main)."""
    jmain, jstart, jloss = _build("jax", make_opt, **build_kw)
    tmain, _, tloss = _build("torch", make_opt, **build_kw)
    assert [op.type for op in tmain.global_block.ops] == \
        [op.type for op in jmain.global_block.ops]
    names = _persistables(jmain)
    assert names == _persistables(tmain)
    jexe, jscope = jpt.Executor(), JScope()
    jexe.run(jstart, scope=jscope)
    scope = _to_port_scope(_jax_state(jscope, names))
    texe = pt.Executor(pt.CPUPlace())
    jl, tl = [], []
    for i in range(steps):
        jl.append(float(jexe.run(jmain, feed=feeds(i), fetch_list=[jloss],
                                 scope=jscope)[0].ravel()[0]))
        tl.append(float(texe.run(tmain, feed=feeds(i), fetch_list=[tloss],
                                 scope=scope)[0].ravel()[0]))
    return (tl, jl, _port_state(scope, names), _jax_state(jscope, names),
            tmain)


def _assert_close_state(got, want, tol=STATE_TOL, skip=lambda n: False):
    assert set(got) == set(want)
    for n in sorted(want):
        if skip(n):
            continue
        np.testing.assert_allclose(got[n], np.asarray(want[n], np.float32),
                                   err_msg=n, **tol)


_ADAM = (lambda pkg: pkg.optimizer.AdamOptimizer(learning_rate=0.05))
_SGD = (lambda pkg: pkg.optimizer.SGDOptimizer(learning_rate=0.1))


@pytest.mark.parametrize("reg", ["L1Decay", "L2Decay", "param_over_opt"])
def test_regularizer_matches_jax(reg):
    """Weight decay on every gradient (SGD shows it undiluted); a
    parameter's own regularizer wins over the optimizer's."""
    if reg == "param_over_opt":
        def opt(pkg):
            return pkg.optimizer.SGDOptimizer(
                0.1, regularization=pkg.regularizer.L2Decay(0.5))
        kw = dict(param_attr=lambda pkg: pkg.ParamAttr(
            regularizer=pkg.regularizer.L1Decay(0.3)))
    else:
        def opt(pkg):
            return pkg.optimizer.SGDOptimizer(
                0.1, regularization=getattr(pkg.regularizer, reg)(0.3))
        kw = {}
    tl, jl, got, want, tmain = _train_both(opt, **kw)
    types = [op.type for op in tmain.global_block.ops]
    assert ("sign" in types) == (reg != "L2Decay")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_close_state(got, want)


@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_gradient_clip_matches_jax(clip):
    """Each gradient-clip class, set tight enough to act on every step."""
    make = {"value": lambda pkg: pkg.clip.GradientClipByValue(0.01),
            "norm": lambda pkg: pkg.clip.GradientClipByNorm(0.01),
            "global_norm": lambda pkg: pkg.clip.GradientClipByGlobalNorm(
                0.01)}[clip]
    tl, jl, got, want, tmain = _train_both(_SGD, clip=make)
    want_op = {"value": "clip", "norm": "clip_by_norm",
               "global_norm": "squared_l2_norm"}[clip]
    assert want_op in [op.type for op in tmain.global_block.ops]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_close_state(got, want)


def test_error_clip_by_value_matches_jax():
    """ErrorClipByValue appends its clip on a gradient by name."""
    def before(pkg, loss):
        pkg.backward.append_backward(loss)
        pkg.clip.ErrorClipByValue(0.005).append_clip_op(
            pkg.default_main_program().global_block, "fc_0.w_0@GRAD")
    tl, jl, got, want, tmain = _train_both(_SGD, before=before)
    assert "clip" in [op.type for op in tmain.global_block.ops]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_close_state(got, want)


def test_per_parameter_learning_rate_matches_jax():
    tl, jl, got, want, tmain = _train_both(
        _ADAM, param_attr=lambda pkg: pkg.ParamAttr(learning_rate=0.3))
    assert "scale" in [op.type for op in tmain.global_block.ops]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_close_state(got, want)


@pytest.mark.parametrize("opt", ["adam", "momentum"])
def test_bfloat16_optimizer_state_matches_jax(opt, monkeypatch):
    """PT_OPT_STATE_DTYPE=bfloat16: the moments are stored in bfloat16,
    the update is computed in float32, the parameters stay float32."""
    monkeypatch.setenv("PT_OPT_STATE_DTYPE", "bfloat16")
    make = _ADAM if opt == "adam" else (
        lambda pkg: pkg.optimizer.MomentumOptimizer(0.1, momentum=0.9))
    tl, jl, got, want, tmain = _train_both(make, steps=2)
    block = tmain.global_block
    moments = [n for n in got if "_moment" in n or "_velocity" in n]
    assert moments and all(block.var(n).dtype == "bfloat16" for n in moments)
    assert all(block.var(n).dtype == "float32"
               for n in got if "_pow_acc" in n)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_close_state(got, want, skip=lambda n: n in moments)
    for n in moments:
        np.testing.assert_allclose(got[n], np.asarray(want[n], np.float32),
                                   rtol=BF16_RTOL, atol=1e-30, err_msg=n)


def test_second_append_backward_merges_matches_jax():
    """An append_backward over one parameter, then minimize: one autodiff
    op whose parameter list is the merge, and the same training."""
    def before(pkg, loss):
        pkg.backward.append_backward(loss, parameter_list=["fc_1.w_0"])
    tl, jl, got, want, tmain = _train_both(_ADAM, before=before)
    bops = [op for op in tmain.global_block.ops if op.type == "autodiff"]
    assert len(bops) == 1
    assert bops[0].attrs["params"][0] == "fc_1.w_0"
    assert sorted(bops[0].attrs["params"]) == sorted(
        p.name for p in tmain.global_block.all_parameters())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_close_state(got, want)


# ---------------------------------------------------------------------------
# the learning-rate schedules
# ---------------------------------------------------------------------------

_SCHEDULES = {
    "exponential_decay": lambda L: L.exponential_decay(0.1, 5, 0.5,
                                                       staircase=True),
    "natural_exp_decay": lambda L: L.natural_exp_decay(0.1, 5, 0.3),
    "inverse_time_decay": lambda L: L.inverse_time_decay(0.1, 4, 0.5),
    "polynomial_decay": lambda L: L.polynomial_decay(0.1, 12, 0.001,
                                                     power=2.0),
    "polynomial_decay_cycle": lambda L: L.polynomial_decay(
        0.1, 6, 0.001, power=1.0, cycle=True),
    "piecewise_decay": lambda L: L.piecewise_decay([4, 9, 15],
                                                   [0.1, 0.05, 0.01, 0.002]),
    "noam_decay": lambda L: L.noam_decay(64, warmup_steps=6),
}


def _schedule_values(which, name, steps=20):
    pkg, prog_mod = PKGS[which]
    prog_mod.reset_unique_names()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        lr = _SCHEDULES[name](pkg.layers)
    if which == "jax":
        exe, scope = pkg.Executor(), JScope()
    else:
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    vals = [float(np.ravel(exe.run(main, fetch_list=[lr], scope=scope)[0])[0])
            for _ in range(steps)]
    counter = float(np.ravel(np.asarray(
        scope.find_var("@LR_DECAY_COUNTER@")))[0])
    return vals, counter, [op.type for op in main.global_block.ops]


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_schedule_matches_jax_over_20_steps(name):
    got, gcount, gops = _schedule_values("torch", name)
    want, wcount, wops = _schedule_values("jax", name)
    assert gops == wops and gops[0] == "increment"
    assert gcount == wcount == 20.0
    np.testing.assert_allclose(got, want, **TOL)
    assert len(set(got)) > 1, "the schedule never moved"


# ---------------------------------------------------------------------------
# the whole contract on the LM, and lazy handles
# ---------------------------------------------------------------------------

LM = dict(vocab_size=120, seq_len=16, n_layers=2, d_model=32, n_heads=2,
          d_ff=64, max_len=16)


def _lm_feed(i, batch=3):
    rs = np.random.RandomState(300 + i)
    src = rs.randint(0, LM["vocab_size"], (batch, LM["seq_len"]))
    return {"src_ids": src.astype("int64"), "tgt_ids": src[..., None]}


def _lm_net(pkg, param_attr):
    tfm = jtfm if pkg is jpt else ttfm
    avg, _ = tfm.transformer_lm_loss(**LM)
    return avg


def _lm_opt(pkg):
    lr = pkg.layers.noam_decay(LM["d_model"], warmup_steps=2) * 2e-3
    return pkg.optimizer.AdamOptimizer(
        learning_rate=lr, regularization=pkg.regularizer.L2Decay(1e-4))


def test_lm_step_contract_matches_jax(monkeypatch):
    """noam_decay, a global-norm clip, L2 decay and Adam under
    PT_GUARD=skip on transformer_lm_loss: 3 steps in both packages."""
    monkeypatch.setenv("PT_GUARD", "skip")
    tl, jl, got, want, tmain = _train_both(
        _lm_opt, net=_lm_net, feeds=_lm_feed,
        clip=lambda pkg: pkg.clip.GradientClipByGlobalNorm(0.5))
    types = [op.type for op in tmain.global_block.ops]
    assert types.index("step_health") == types.index("autodiff") + 1
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert got["@LR_DECAY_COUNTER@"][0] == 3.0
    _assert_close_state(got, want,
                        skip=lambda n: n.split("_moment")[0].endswith("_k_b"))


def test_lazy_handles_read_what_an_eager_run_reads():
    runs = {}
    for lazy in (False, True):
        main, startup, loss = _build("torch", _ADAM)
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        init = {n: scope.get_numpy(n) for n in _persistables(main)
                if scope.find_var(n) is not None}
        runs[lazy] = (main, loss, exe, scope, init)
    (main, loss, exe, scope, init), (lmain, lloss, lexe, lscope, _) = \
        runs[False], runs[True]
    for n, a in init.items():   # one start for both
        lscope.set_var(n, torch.from_numpy(a.copy()))
    for i in range(3):
        want, = exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
        got, = lexe.run(lmain, feed=_feed(i), fetch_list=[lloss],
                        scope=lscope, lazy=True)
        assert isinstance(got, LazyFetch)
        assert got.provenance == {"fetch": lloss.name}
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.is_ready()
        np.testing.assert_array_equal(np.asarray(got), want)
        assert float(got) == float(want[0])
        np.testing.assert_array_equal(materialize([got, {"a": got}])[1]["a"],
                                      want)
    stacked = {k: np.stack([_feed(3 + i)[k] for i in range(2)])
               for k in _feed(0)}
    want, = exe.run_loop(main, feed=stacked, fetch_list=[loss], n_steps=2,
                         scope=scope, per_step_feeds=True)
    got, = lexe.run_loop(lmain, feed=stacked, fetch_list=[lloss], n_steps=2,
                         scope=lscope, per_step_feeds=True, lazy=True)
    np.testing.assert_array_equal(got.numpy(), want)
    for n in init:
        np.testing.assert_array_equal(lscope.get_numpy(n),
                                      scope.get_numpy(n), err_msg=n)
    timings = lexe.step_timings()   # the startup run and 4 runs
    assert timings["runs"] == 5 and timings["fetch_s"] > 0


# ---------------------------------------------------------------------------
# the step guard
# ---------------------------------------------------------------------------

def _guarded(monkeypatch, which="torch", clip=None):
    monkeypatch.setenv("PT_GUARD", "skip")
    return _build(which, lambda pkg: pkg.optimizer.MomentumOptimizer(
        0.1, momentum=0.9), clip=clip)


def _state(scope, main):
    return {n: scope.get_numpy(n) for n in _persistables(main)
            if scope.find_var(n) is not None}


def test_minimize_instruments_only_under_pt_guard(monkeypatch):
    main, _, _ = _build("torch", _SGD)
    assert not tguard.is_instrumented(main)
    with pytest.raises(tguard.GuardConfigError, match="step_health"):
        pt.Executor(pt.CPUPlace()).run(main, feed=_feed(0), guard=True,
                                       scope=pt.Scope())
    main, _, _ = _guarded(monkeypatch)
    types = [op.type for op in main.global_block.ops]
    assert types.index("step_health") == types.index("autodiff") + 1
    monkeypatch.setenv("PT_GUARD", "sometimes")
    with pytest.raises(tguard.GuardConfigError, match="unknown policy"):
        tguard.policy()


@pytest.mark.parametrize("site", ["nan_loss", "nan_grad"])
def test_injected_anomaly_leaves_the_state_bit_identical(monkeypatch, site):
    main, startup, loss = _guarded(monkeypatch)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope, guard=True)
    before = _state(scope, main)
    _arm(monkeypatch, f"{site}@1")
    got_loss, health = exe.run(main, feed=_feed(1), fetch_list=[loss],
                               scope=scope, guard=True, lazy=True)
    assert not bool(health)
    assert np.isnan(float(got_loss)) == (site == "nan_loss")
    after = _state(scope, main)
    for n in before:
        np.testing.assert_array_equal(after[n], before[n], err_msg=n)
    _arm(monkeypatch, "")
    _, health = exe.run(main, feed=_feed(2), fetch_list=[loss], scope=scope,
                        guard=True)
    assert bool(health)
    assert any(not np.array_equal(after[n], scope.get_numpy(n))
               for n in after), "a healthy step after a skip must train"


def test_guarded_run_matches_unguarded_bit_for_bit_when_healthy(monkeypatch):
    main, startup, loss = _guarded(monkeypatch)
    results = []
    for guard in (False, True):
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        torch.manual_seed(1)
        exe.run(startup, scope=scope)
        for i in range(3):
            exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope,
                    guard=guard)
        results.append(_state(scope, main))
    for n in results[0]:
        np.testing.assert_array_equal(results[1][n], results[0][n], err_msg=n)


@pytest.mark.parametrize("ceiling", [None, "1e-6", "0.05"])
def test_step_health_matches_jax(monkeypatch, ceiling):
    """The flag on a healthy step, under a ceiling below the raw norm,
    and (0.05) one between the clipped norm and the raw one: the norm is
    taken before the clip, in both packages."""
    if ceiling:
        monkeypatch.setenv("PT_GUARD_MAX_GNORM", ceiling)
    clip = lambda pkg: pkg.clip.GradientClipByGlobalNorm(1e-3)  # noqa: E731
    flags = {}
    jmain, jstart, jloss = _guarded(monkeypatch, "jax", clip=clip)
    tmain, _, tloss = _guarded(monkeypatch, "torch", clip=clip)
    jexe, jscope = jpt.Executor(), JScope()
    jexe.run(jstart, scope=jscope)
    scope = _to_port_scope(_jax_state(jscope, _persistables(jmain)))
    flags["jax"] = bool(np.asarray(jexe.run(
        jmain, feed=_feed(0), fetch_list=[jloss], scope=jscope,
        guard=True)[-1]))
    flags["torch"] = bool(pt.Executor(pt.CPUPlace()).run(
        tmain, feed=_feed(0), fetch_list=[tloss], scope=scope,
        guard=True)[-1])
    assert flags["torch"] == flags["jax"] == (ceiling is None)


def test_run_loop_reports_per_step_health(monkeypatch):
    main, startup, loss = _guarded(monkeypatch)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    _arm(monkeypatch, "nan_loss@2")
    stacked = {k: np.stack([_feed(i)[k] for i in range(3)]) for k in _feed(0)}
    losses, health = exe.run_loop(main, feed=stacked, fetch_list=[loss],
                                  n_steps=3, scope=scope,
                                  per_step_feeds=True, guard=True,
                                  lazy=True)
    assert np.asarray(health).tolist() == [True, False, True]
    losses = np.asarray(losses).ravel()
    assert np.isnan(losses[1]) and np.isfinite(losses[[0, 2]]).all()


def test_guard_knobs_match_jax(monkeypatch):
    for raw in ("", "skip", "rollback", "raise", "off"):
        monkeypatch.setenv("PT_GUARD", raw)
        assert tguard.policy() == jguard.policy()
    for raw in ("", "2", "7"):
        monkeypatch.setenv("PT_GUARD_PATIENCE", raw)
        assert tguard.patience() == jguard.patience()
    for bad in ("0", "x"):
        monkeypatch.setenv("PT_GUARD_PATIENCE", bad)
        with pytest.raises(tguard.GuardConfigError):
            tguard.patience()
    monkeypatch.setenv("PT_GUARD_MAX_GNORM", "2.5")
    assert tguard.max_gnorm() == jguard.max_gnorm() == 2.5
    monkeypatch.setenv("PT_GUARD_MAX_GNORM", "-1")
    with pytest.raises(tguard.GuardConfigError):
        tguard.max_gnorm()
