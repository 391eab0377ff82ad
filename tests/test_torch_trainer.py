"""The port's Trainer, checkpoints and resume against the JAX package.

A small regression net (fc(8, tanh) -> fc(1), mean squared error) with
the step's contract (Adam under an exponential_decay schedule, a
global-norm clip, L2 decay) is trained by ``paddle_tpu.Trainer`` and by
the port's ``Trainer(place=CPUPlace())`` from one startup state (the JAX
trainer's persistables, loaded by the port through ``param_path``), on
batches made from a numpy seed. The scenarios mirror
tests/test_io_trainer.py, tests/test_trainer_loop.py,
tests/test_async_hotpath.py and tests/test_guardrails.py:

* 2 epochs with steps_per_loop 1 and 3, lazy metrics between log steps;
* a preemption mid-epoch (SIGTERM, or request_preemption) and its
  resume, bit for bit against the uninterrupted run, through a program
  that draws from the run's random stream (the run counter travels in
  the trainer args);
* PT_GUARD=skip / raise / rollback after injected anomalies;
* a corrupted serial, quarantined and skipped;
* a checkpoint written by the JAX Trainer resumed by the port's, and the
  other way round, each reaching the other's losses.

Tolerances: losses rtol 1e-5; state (parameters, moments, the schedule's
counter) atol 1e-5, rtol 1e-4, as tests/test_torch_executor.py holds it;
the port against itself (resume, rollback) bit for bit.
"""

import logging
import os
import signal

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core import program as jprog
from paddle_tpu.obs.metrics import TrainMetrics as JTrainMetrics
from paddle_tpu.obs.metrics import render_prometheus as jrender
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.resilience import manifest as jmanifest

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.obs.metrics import TrainMetrics, render_prometheus
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.resilience import guard as tguard

torch.set_num_threads(2)

STATE_TOL = dict(atol=1e-5, rtol=1e-4)
BATCH, N_BATCHES = 4, 6
PKGS = {"jax": (jpt, jprog), "torch": (pt, tprog)}


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ("PT_FAULT_INJECT", "PT_GUARD", "PT_GUARD_PATIENCE",
                "PT_GUARD_MAX_GNORM", "PT_OPT_STATE_DTYPE",
                "PADDLE_TRAINING_ROLE"):
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


_RS = np.random.RandomState(11)
_DATA = []
for _ in range(BATCH * N_BATCHES):
    _x = _RS.randn(4).astype(np.float32)
    _DATA.append((_x, (np.sin(_x).sum(keepdims=True) * 0.5)
                  .astype(np.float32)))


def _reader():
    for b in range(0, len(_DATA), BATCH):
        yield _DATA[b:b + BATCH]


def _make(which, ckpt_dir=None, param_path=None, noise=False, **cfg_kw):
    """A Trainer of `which` package over the regression net; noise=True
    (port only) adds 0.01 x a gaussian_random draw to the input, so
    each run reads the run's random stream."""
    pkg, prog_mod = PKGS[which]
    prog_mod.reset_unique_names()

    def train_func():
        x = pkg.layers.data("x", [4])
        y = pkg.layers.data("y", [1])
        if noise:
            block = pkg.default_main_program().global_block
            n = block.create_var("noise", shape=(BATCH, 4))
            block.append_op("gaussian_random", {}, {"Out": n},
                            {"shape": [BATCH, 4], "mean": 0.0, "std": 1.0})
            x = pkg.layers.elementwise_add(x, pkg.layers.scale(n, 0.01))
        h = pkg.layers.fc(x, size=8, act="tanh")
        pred = pkg.layers.fc(h, size=1)
        return [pkg.layers.mean(pkg.layers.square(
            pkg.layers.elementwise_sub(pred, y)))]

    def optimizer_func():
        lr = pkg.layers.exponential_decay(0.05, 4, 0.7)
        pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(0.5))
        return pkg.optimizer.AdamOptimizer(
            learning_rate=lr, regularization=pkg.regularizer.L2Decay(1e-3))

    cfg = (pkg.CheckpointConfig(ckpt_dir, **cfg_kw)
           if ckpt_dir is not None else None)
    kw = dict(param_path=param_path, checkpoint_config=cfg)
    if which == "torch":
        kw["place"] = pt.CPUPlace()
    return pkg.Trainer(train_func, optimizer_func, **kw)


def _start_dir(tmp_path):
    """The JAX trainer's startup persistables, the start of every run."""
    d = str(tmp_path / "start")
    if not os.path.isdir(d):
        j = _make("jax")
        jpt.io.save_persistables(j.exe, d, j.train_program, scope=j.scope)
    return d


def _train(trainer, epochs=2, on_step=None, **kw):
    """Losses by (epoch, step) (a window's steps apart)."""
    losses = {}

    def handler(event):
        if isinstance(event, (jpt.EndStepEvent, pt.EndStepEvent)):
            if event.metrics:
                vals = np.ravel(np.asarray(event.metrics[0]))
                for k, v in enumerate(vals):
                    losses[(event.epoch, event.step + k)] = float(v)
            if on_step is not None:
                on_step(event)
    trainer.train(num_epochs=epochs, event_handler=handler,
                  reader=_reader, **kw)
    return losses


def _state(trainer):
    block = trainer.train_program.global_block
    out = {}
    for n, v in block.vars.items():
        if not v.persistable:
            continue
        val = trainer.scope.find_var(n)
        if val is not None:
            out[n] = (val.numpy() if isinstance(val, torch.Tensor)
                      else np.asarray(val))
    return out


def _assert_state(got, want, exact=False):
    assert set(got) == set(want)
    for n in sorted(want):
        if exact:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        else:
            np.testing.assert_allclose(got[n], want[n], err_msg=n,
                                       **STATE_TOL)


def _assert_losses(got, want):
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[k] for k in sorted(got)],
                               [want[k] for k in sorted(want)], rtol=1e-5)


# ---------------------------------------------------------------------------
# the loop against the JAX Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps_per_loop", [1, 3])
def test_trainer_matches_jax_over_two_epochs(tmp_path, steps_per_loop):
    start = _start_dir(tmp_path)
    kinds = {}

    def note(event):
        if event.metrics:
            kinds[event.step] = type(event.metrics[0]).__name__
    j = _make("jax", param_path=start)
    want = _train(j, steps_per_loop=steps_per_loop, log_every=2)
    t = _make("torch", param_path=start)
    got = _train(t, steps_per_loop=steps_per_loop, log_every=2,
                 on_step=note)
    assert len(got) == 2 * N_BATCHES
    _assert_losses(got, want)
    _assert_state(_state(t), _state(j))
    assert _state(t)["@LR_DECAY_COUNTER@"][0] == 2 * N_BATCHES
    # lazy handles between log steps, numpy on them
    if steps_per_loop == 1:
        assert kinds[0] == "ndarray" and kinds[1] == "LazyFetch"
    snap = t.train_metrics.snapshot()
    assert (snap["steps"], snap["epochs"], snap["examples"]) == \
        (2 * N_BATCHES, 2, 2 * N_BATCHES * BATCH)
    # the snapshot has the JAX provider's keys, and renders to its
    # pt_train_* lines
    assert set(snap) == set(JTrainMetrics().snapshot())

    def train_lines(text):
        return [ln for ln in text.splitlines() if "pt_train_" in ln]
    lines = train_lines(render_prometheus({"train": {"trainer": snap}}))
    assert lines and lines == train_lines(
        jrender({"train": {"trainer": snap}}))
    assert set(TrainMetrics().snapshot()) == set(snap)


def test_default_trainer_raises_without_a_card():
    """Trainer() runs on the card unless given CPUPlace(); without a card
    it raises (before any step) rather than training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tprog.reset_unique_names()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Trainer(lambda: [pt.layers.mean(pt.layers.data("x", [4]))],
                   lambda: pt.optimizer.SGDOptimizer(0.1))


def test_test_and_inference_model_match_jax(tmp_path):
    start = _start_dir(tmp_path)
    j = _make("jax", param_path=start)
    t = _make("torch", param_path=start)
    np.testing.assert_allclose(t.test(_reader), j.test(_reader), rtol=1e-5)
    d = str(tmp_path / "infer")
    t.save_inference_model(d, ["x"], [t.train_func_outputs[0]])
    assert jmanifest.verify_dir(d)[0] == "ok"
    prog, feeds, fetches = pt.io.load_inference_model(
        d, pt.Executor(pt.CPUPlace()), scope=pt.Scope())
    assert feeds == ["x"] and len(fetches) == 1
    with open(os.path.join(d, "fc_0.w_0.npy"), "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\x00\x01\x02\x03")
    with pytest.raises(pt.io.CheckpointCorruptError):
        pt.io.load_inference_model(d, pt.Executor(pt.CPUPlace()),
                                   scope=pt.Scope())


def test_data_feeder_matches_jax():
    rows = [(np.arange(4, dtype=np.float32) + i, [i, i + 1][: 1 + i % 2],
             np.float32([i])) for i in range(3)]
    out = {}
    for which, (pkg, prog_mod) in PKGS.items():
        prog_mod.reset_unique_names()
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            x = pkg.layers.data("x", [4])
            s = pkg.layers.data("s", [1], dtype="int64", lod_level=1)
            y = pkg.layers.data("y", [1])
            out[which] = pkg.DataFeeder([x, s, y]).feed(rows)
    assert sorted(out["torch"]) == sorted(out["jax"])
    for k in out["jax"]:
        np.testing.assert_array_equal(out["torch"][k], out["jax"][k])
        assert out["torch"][k].dtype == out["jax"][k].dtype, k


# ---------------------------------------------------------------------------
# preemption and resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["sigterm", "request"])
def test_preempted_run_resumes_bit_for_bit(tmp_path, how):
    """Preempted mid-epoch 1 (log_every 3: lazy metrics in between), the
    run checkpoints at the step boundary; a new Trainer over the same
    dir resumes there and ends where the uninterrupted run ends, through
    the run's random draws."""
    start = _start_dir(tmp_path)
    a = _make("torch", str(tmp_path / "a"), start, noise=True,
              step_interval=4)
    want = _train(a, log_every=3)

    def kill(event):
        if (event.epoch, event.step) == (1, 2):
            if how == "sigterm":
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                b.request_preemption()
    b = _make("torch", str(tmp_path / "b"), start, noise=True,
              step_interval=4)
    first = _train(b, on_step=kill, log_every=3)
    assert b.preempted and max(first) == (1, 2)
    c = _make("torch", str(tmp_path / "b"), start, noise=True,
              step_interval=4)
    assert (c.checkpoint_cfg.epoch_id, c.checkpoint_cfg.step_id) == (1, 3)
    rest = _train(c, log_every=3)
    assert min(rest) == (1, 3)
    assert {k: want[k] for k in rest} == rest
    _assert_state(_state(c), _state(a), exact=True)


def test_corrupt_serial_is_quarantined_and_skipped(tmp_path):
    start = _start_dir(tmp_path)
    d = str(tmp_path / "ck")
    a = _make("torch", d, start, step_interval=2, max_num_checkpoints=3)
    _train(a, epochs=1)
    serials = sorted(int(n.split("_")[1]) for n in os.listdir(d))
    newest = os.path.join(d, f"checkpoint_{serials[-1]}")
    # the JAX package verifies what the port wrote
    assert jmanifest.verify_dir(newest)[0] == "ok"
    with open(os.path.join(newest, "fc_0.w_0.npy"), "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\xff\xfe\xfd\xfc")
    with pytest.raises(pt.io.CheckpointCorruptError):
        pt.io.load_checkpoint(pt.Executor(pt.CPUPlace()), d, serials[-1],
                              a.train_program, scope=pt.Scope())
    with pytest.warns(UserWarning, match="quarantined"):
        b = _make("torch", d, start, step_interval=2)
    assert b.checkpoint_cfg.load_serial == serials[-2]
    assert os.path.isdir(newest + ".corrupt") and not os.path.isdir(newest)
    older = jpt.io.load_checkpoint(
        None, d, serials[-2], main_program=_make("jax").train_program,
        scope=jpt.Scope())
    assert (b.checkpoint_cfg.epoch_id, b.checkpoint_cfg.step_id) == \
        (older["epoch_id"], older["step_id"])


@pytest.mark.parametrize("site", ["io_write_truncate@3", "commit_crash@1"])
def test_crashed_save_is_never_selected(tmp_path, monkeypatch, site):
    """A save that dies mid-write (a torn .npy) or before its _SUCCESS
    marker leaves no committed serial: the newest committed one stays
    the resume point, and the next save clears the leftovers."""
    start = _start_dir(tmp_path)
    d = str(tmp_path / "ck")
    t = _make("torch", d, start)
    pt.io.save_checkpoint(t.exe, d, trainer_args={"step_id": 1},
                          main_program=t.train_program, scope=t.scope)
    _arm(monkeypatch, site)
    with pytest.raises(tfaults.FaultInjected):
        pt.io.save_checkpoint(t.exe, d, trainer_args={"step_id": 2},
                              main_program=t.train_program, scope=t.scope)
    _arm(monkeypatch, "")
    assert pt.io.get_latest_checkpoint_serial(d) == 0
    assert pt.io.load_checkpoint(t.exe, d, None, t.train_program,
                                 scope=t.scope) == {"step_id": 1}
    assert pt.io.save_checkpoint(t.exe, d, main_program=t.train_program,
                                 scope=t.scope) == 1
    assert jmanifest.verify_dir(os.path.join(d, "checkpoint_1"))[0] == "ok"


# ---------------------------------------------------------------------------
# the guard's policies
# ---------------------------------------------------------------------------

def test_skip_policy_skips_the_step_and_trains_on(tmp_path, monkeypatch,
                                                  caplog):
    monkeypatch.setenv("PT_GUARD", "skip")
    start = _start_dir(tmp_path)
    t = _make("torch", param_path=start)
    snaps = {}

    def snap(event):
        snaps[event.step] = t.scope.get_numpy("fc_0.w_0")
    _arm(monkeypatch, "nan_loss@4")      # hit 4 = step 3
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch"):
        _train(t, epochs=1, on_step=snap)
    np.testing.assert_array_equal(snaps[3], snaps[2])
    assert not np.array_equal(snaps[2], snaps[1])
    assert not np.array_equal(snaps[4], snaps[3])
    assert any("anomalous step (epoch 0 step 3)" in r.message
               for r in caplog.records)
    assert t.train_metrics.snapshot()["anomalies"] == 1


@pytest.mark.parametrize("plan,raises", [("nan_loss@3,nan_loss@4", True),
                                         ("nan_loss@2,nan_loss@5", False)])
def test_raise_policy_after_patience_matches_jax(tmp_path, monkeypatch, plan,
                                                 raises):
    monkeypatch.setenv("PT_GUARD", "raise")
    monkeypatch.setenv("PT_GUARD_PATIENCE", "2")
    start = _start_dir(tmp_path)
    for which in ("jax", "torch"):
        t = _make(which, param_path=start)
        _arm(monkeypatch, plan)
        if raises:
            with pytest.raises(RuntimeError, match="2 consecutive"):
                _train(t, epochs=1)
        else:
            _train(t, epochs=1)


def test_rollback_matches_the_uninterrupted_run_and_jax(tmp_path,
                                                        monkeypatch):
    """Steps 3 and 4 poisoned, patience 2: the step-4 read rolls back to
    the serial of step boundary 3 and replays steps 3-5 clean. The port
    ends bit for bit where its clean run ends, and where JAX ends."""
    monkeypatch.setenv("PT_GUARD", "rollback")
    monkeypatch.setenv("PT_GUARD_PATIENCE", "2")
    start = _start_dir(tmp_path)
    clean = _make("torch", str(tmp_path / "clean"), start, step_interval=3)
    _train(clean, epochs=1)
    ends, seen = {}, {}
    for which in ("jax", "torch"):
        t = _make(which, str(tmp_path / which), start, step_interval=3)
        steps = []
        _arm(monkeypatch, "nan_loss@4,nan_loss@5")
        _train(t, epochs=1, on_step=lambda e, s=steps: s.append(e.step))
        assert t._guard_rollbacks == 1
        ends[which], seen[which] = _state(t), steps
    assert seen["torch"] == seen["jax"] == [0, 1, 2, 3, 4, 3, 4, 5]
    _assert_state(ends["torch"], _state(clean), exact=True)
    _assert_state(ends["torch"], ends["jax"])
    monkeypatch.delenv("PT_GUARD_PATIENCE")
    t = _make("torch", param_path=start)
    with pytest.raises(tguard.GuardConfigError, match="CheckpointConfig"):
        _train(t)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_checkpoint_resumes_in_the_other_package(tmp_path, writer, reader):
    """`writer`'s Trainer is preempted at epoch 0 step 3 and checkpoints;
    `reader`'s Trainer over that dir resumes at step 4 and reaches the
    losses and state of `writer`'s uninterrupted run."""
    start = _start_dir(tmp_path)
    full = _make(writer, str(tmp_path / "full"), start, step_interval=4)
    want = _train(full)
    d = str(tmp_path / "shared")
    w = _make(writer, d, start, step_interval=4)
    _train(w, on_step=lambda e: (w.request_preemption()
                                 if (e.epoch, e.step) == (0, 3) else None))
    assert w.preempted
    r = _make(reader, d, start, step_interval=4)
    assert (r.checkpoint_cfg.epoch_id, r.checkpoint_cfg.step_id) == (0, 4)
    got = _train(r)
    assert min(got) == (0, 4)
    _assert_losses(got, {k: want[k] for k in got})
    _assert_state(_state(r), _state(full))
