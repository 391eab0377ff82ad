"""The event-driven Trainer and the Inferencer.

Counterpart of ``paddle_tpu/trainer.py``: ``Trainer(train_func,
optimizer_func, place, param_path, checkpoint_config)`` builds the
training program under its own program pair (``train_func`` returns
``[loss, *metrics]``, ``optimizer_func`` an optimizer whose ``minimize``
appends the backward, clip, decay, update and, with ``PT_GUARD``, the
step-health op), runs the startup program on the executor's device
(the first CUDA device unless ``place=CPUPlace()``) and, with a
``CheckpointConfig``, resumes from the newest checkpoint serial that
verifies.

``train(num_epochs, event_handler, reader, feed_order, double_buffer,
steps_per_loop, reader_retry, log_every)`` loops over the reader:

* every step goes through ``Executor.run`` (``run_loop`` over windows
  of ``steps_per_loop`` same-shaped batches) with lazy fetches: the
  EndStepEvent carries numpy metrics on steps where ``step %
  log_every == 0`` and LazyFetch handles in between, so the host
  queues the next step while the card runs this one;
* ``double_buffer`` puts the next batch on the device (a pinned host
  copy, ``non_blocking``) before the current step is dispatched;
* ``reader_retry`` restarts a failing reader and skips what it had
  delivered (resilience/retry.py);
* ``PT_GUARD=skip|raise|rollback`` (resilience/guard.py): every step
  carries the health flag and the guarded update; the flags are read at
  log, checkpoint and epoch boundaries; after ``PT_GUARD_PATIENCE``
  consecutive anomalies ``raise`` raises StepAnomalyError and
  ``rollback`` restores the newest verified serial and replays from it;
* checkpoints every ``step_interval`` steps and ``epoch_interval``
  epochs (io.save_checkpoint: crc32 manifests, ``_SUCCESS``, scrolling);
  the trainer args record the next (epoch, step) and the executor's run
  counter, which seeds each run's random stream, so a resumed run draws
  what an uninterrupted one draws;
* SIGTERM / SIGINT (from the main thread) or ``request_preemption()``
  checkpoint at the next step boundary and return with
  ``preempted=True``; a mid-epoch resume skips the batches already
  trained on.

Not ported, and refused before any step: ``parallel=True``, ``plan``,
``reshard``, host-RAM embedding tables and multi-process training
(``PADDLE_TRAINING_ROLE``).
"""

from __future__ import annotations

import itertools
import logging
import os
import signal
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import io as io_mod
from .core.async_fetch import LazyFetch, materialize
from .core.executor import Executor, Place
from .core.program import Program, program_guard
from .core.scope import Scope, scope_guard
from .core.types import torch_dtype
from .data_feeder import DataFeeder

__all__ = ["BeginEpochEvent", "EndEpochEvent", "BeginStepEvent",
           "EndStepEvent", "CheckpointConfig", "Trainer", "Inferencer"]

_log = logging.getLogger("paddle_tpu_torch")


def _shape_chunks(batches, n: int):
    """Consecutive feed dicts grouped into windows of <= n with the same
    shapes and dtypes (a change of shape flushes the window, so a
    stacked window stays rectangular)."""
    def sig(feed):
        return tuple(sorted((k, tuple(np.shape(v)), str(v.dtype)
                             if hasattr(v, "dtype")
                             else str(np.asarray(v).dtype))
                            for k, v in feed.items()))

    window, cur = [], None
    for feed in batches:
        s = sig(feed)
        if window and (s != cur or len(window) == n):
            yield window
            window = []
        window.append(feed)
        cur = s
    if window:
        yield window


def _window_examples(window, n_in_window: int) -> int:
    """The example count of one window (pt_train_* accounting): the batch
    dim of a feed array, dim 1 of a stacked [n, B, ...] window."""
    try:
        feed = window if isinstance(window, dict) else window[0]
        shp = np.shape(next(iter(feed.values())))
        if isinstance(window, dict):
            return int(shp[1]) * n_in_window if len(shp) > 1 \
                else n_in_window
        return int(shp[0]) * n_in_window if shp else n_in_window
    except Exception:   # noqa: BLE001 — metrics must not stop the loop
        return 0


def _observe_loss(tm, metrics) -> None:
    """The newest read loss (metrics[0], already numpy) on pt_train_*."""
    if tm is None or not metrics:
        return
    try:
        tm.observe_loss(float(np.asarray(metrics[0]).reshape(-1)[-1]))
    except Exception:   # noqa: BLE001 — metrics must not stop the loop
        pass


class BeginEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig:
    def __init__(self, checkpoint_dir: Optional[str] = None,
                 max_num_checkpoints: int = 3, epoch_interval: int = 1,
                 step_interval: int = 10):
        self.checkpoint_dir = checkpoint_dir or os.path.join(
            os.getcwd(), "checkpoint")
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = max(epoch_interval, 1)
        self.step_interval = max(step_interval, 1)
        self.epoch_id = 0
        self.step_id = 0
        self.load_serial = None


def _refuse(what: str):
    raise NotImplementedError(f"Trainer({what}): not ported; the port "
                              "trains on one device in one process")


class Trainer:
    """train_func must return [loss] (or [loss, *metrics])."""

    def __init__(self, train_func: Callable, optimizer_func: Callable,
                 place: Optional[Place] = None,
                 param_path: Optional[str] = None, parallel: bool = False,
                 checkpoint_config: Optional[CheckpointConfig] = None,
                 plan=None, reshard: bool = False):
        if parallel:
            _refuse("parallel=True")
        if plan is not None:
            _refuse("plan=...")
        if reshard:
            _refuse("reshard=True")
        if os.getenv("PADDLE_TRAINING_ROLE") is not None:
            _refuse("PADDLE_TRAINING_ROLE: multi-process training")
        self.parallel = False
        self.place = place
        self.checkpoint_cfg = checkpoint_config
        #: True when train() returned early on a preemption, after its
        #: checkpoint
        self.preempted = False
        self._preempt_signal: Optional[int] = None
        self.scope = Scope()
        self.startup_program = Program()
        self.train_program = Program()

        with program_guard(self.train_program, self.startup_program):
            outs = train_func()
            if isinstance(outs, tuple):
                outs = list(outs)
            if not isinstance(outs, list):
                outs = [outs]
            self.train_func_outputs = outs
            self.loss = outs[0]
            optimizer = optimizer_func()
            optimizer.minimize(self.loss)
        blk = self.train_program.global_block
        for op in blk.ops:
            if op.type == "lookup_table" and (
                    op.inputs["W"][0].endswith("@ROWS")
                    or blk.var(op.inputs["W"][0]).is_data):
                _refuse(f"host-RAM embedding table {op.inputs['W'][0]!r}")

        self.exe = Executor(place)
        with scope_guard(self.scope):
            self.exe.run(self.startup_program, scope=self.scope)
            if param_path:
                io_mod.load_persistables(self.exe, param_path,
                                         self.train_program,
                                         scope=self.scope)
            if self.checkpoint_cfg:
                serial = io_mod.get_latest_checkpoint_serial(
                    self.checkpoint_cfg.checkpoint_dir)
                if serial >= 0:
                    self.checkpoint_cfg.load_serial = serial
                    # verify=False: the serial was just verified
                    args = io_mod.load_checkpoint(
                        self.exe, self.checkpoint_cfg.checkpoint_dir, serial,
                        self.train_program, scope=self.scope, verify=False)
                    self._restore_trainer_args(args)

    def _restore_trainer_args(self, args: Optional[dict]) -> None:
        """The resume point and the executor's run counter (its random
        streams) from a checkpoint's trainer args."""
        if not args:
            return
        self.checkpoint_cfg.epoch_id = args.get("epoch_id", 0)
        step_id = args.get("step_id", 0)
        if args.get("args_version", 1) < 2 and step_id:
            # version-1 args recorded the last completed step; version 2
            # records the next one
            step_id += 1
        self.checkpoint_cfg.step_id = step_id
        self.exe._run_counter = int(
            args.get("run_counter", self.exe._run_counter))

    # -- train loop ---------------------------------------------------------
    def train(self, num_epochs: int, event_handler: Callable,
              reader: Callable, feed_order: Optional[list] = None,
              double_buffer: bool = True, steps_per_loop: int = 1,
              reader_retry=None, log_every: int = 1):
        """Train `num_epochs` epochs over `reader` (see the module
        docstring). `reader` yields lists of sample tuples (DataFeeder,
        in `feed_order`) or feed dicts."""
        from .obs.metrics import REGISTRY, TrainMetrics
        from .resilience import guard as guard_mod
        from .resilience.retry import RetryPolicy, resilient_reader
        self.train_metrics = TrainMetrics()
        REGISTRY.register("train", self.train_metrics.name,
                          self.train_metrics)
        self._guard_policy = guard_mod.policy()
        if self._guard_policy:
            guard_mod.patience()  # a malformed knob fails here
            if not guard_mod.is_instrumented(self.train_program):
                raise guard_mod.GuardConfigError(
                    "PT_GUARD is set but the training program carries no "
                    "step-health op — set PT_GUARD before constructing the "
                    "Trainer (optimizer.minimize instruments the program)")
            if self._guard_policy == "rollback" and not self.checkpoint_cfg:
                raise guard_mod.GuardConfigError(
                    "PT_GUARD=rollback restores the newest verified "
                    "checkpoint serial: pass a CheckpointConfig (or use "
                    "PT_GUARD=skip|raise)")
        self._bad_streak = 0
        self._pending_health = []
        self._guard_rollbacks = 0
        self._last_rollback_at = None
        if isinstance(reader_retry, RetryPolicy):
            retry_policy = reader_retry
        elif reader_retry:
            retry_policy = RetryPolicy(retries=int(reader_retry))
        else:
            retry_policy = None
        # installed in any case: it hosts the reader_raise fault site
        reader = resilient_reader(reader, policy=retry_policy)
        self.preempted = False
        self._preempt_signal = None
        restore_handlers = {}
        if threading.current_thread() is threading.main_thread():
            def _request_preempt(signum, frame):
                self._preempt_signal = signum
                # one-shot: a second signal acts at once
                signal.signal(signum,
                              restore_handlers.get(signum, signal.SIG_DFL))
            for sig in (signal.SIGTERM, signal.SIGINT):
                restore_handlers[sig] = signal.signal(sig, _request_preempt)
        try:
            while True:
                try:
                    self._train_impl(num_epochs, event_handler, reader,
                                     feed_order, double_buffer,
                                     steps_per_loop, max(int(log_every), 1))
                    break
                except guard_mod.RollbackSignal as rb:
                    self._guard_rollback(rb)
        finally:
            for sig, old in restore_handlers.items():
                signal.signal(sig, old)

    def request_preemption(self, signum: int = signal.SIGTERM) -> None:
        """A preemption notice from any thread: train() checkpoints at
        the next step boundary and returns with ``preempted=True``."""
        self._preempt_signal = signum

    def _preempt_exit(self, epoch_id: int, next_step: int,
                      already_saved: bool) -> bool:
        """At a step boundary: if a preemption arrived, checkpoint
        (unless this boundary just saved) and ask for a clean exit. With
        no CheckpointConfig, SIGTERM still stops cleanly and Ctrl-C
        raises KeyboardInterrupt."""
        if self._preempt_signal is None:
            return False
        if self.checkpoint_cfg:
            if not already_saved:
                self._drain_health()
                self._save_checkpoint(epoch_id, next_step)
        elif self._preempt_signal == signal.SIGINT:
            raise KeyboardInterrupt
        self.preempted = True
        return True

    # -- the guard's policy (PT_GUARD) ----------------------------------------
    def _drain_health(self) -> None:
        """Read the pending health flags and apply the PT_GUARD policy
        (only at log, checkpoint and epoch boundaries)."""
        if not self._pending_health:
            return
        from .obs import trace as obs_trace
        from .resilience import guard as guard_mod
        patience = guard_mod.patience()
        pend, self._pending_health = self._pending_health, []
        for epoch_id, step0, _n, handle in pend:
            flags = np.ravel(np.asarray(handle)).astype(bool)
            for i, ok in enumerate(flags):
                if ok:
                    self._bad_streak = 0
                    continue
                self._bad_streak += 1
                _log.warning(
                    "[guard] anomalous step (epoch %d step %d): non-finite "
                    "loss/grads or grad-norm over PT_GUARD_MAX_GNORM — "
                    "update skipped (consecutive: %d/%d, policy=%s)",
                    epoch_id, step0 + i, self._bad_streak, patience,
                    self._guard_policy)
                obs_trace.instant("guard_anomaly", cat="train",
                                  epoch=epoch_id, step=step0 + i,
                                  streak=self._bad_streak,
                                  policy=self._guard_policy)
                self.train_metrics.on_anomaly()
                if self._bad_streak < patience:
                    continue
                if self._guard_policy == "raise":
                    raise guard_mod.StepAnomalyError(
                        f"{self._bad_streak} consecutive anomalous steps "
                        f"(last: epoch {epoch_id} step {step0 + i}); "
                        "the weights were never touched (guarded update) — "
                        "PT_GUARD=skip|rollback recovers in place")
                if self._guard_policy == "rollback":
                    raise guard_mod.RollbackSignal(epoch_id, step0 + i,
                                                   self._bad_streak)

    def _guard_rollback(self, rb) -> None:
        """Restore the newest verified serial and its resume point. An
        anomaly that recurs at the same (epoch, step) after a rollback
        replays deterministically: escalate instead of looping."""
        from .obs import trace as obs_trace
        from .resilience import guard as guard_mod
        if self._last_rollback_at == (rb.epoch, rb.step):
            raise guard_mod.StepAnomalyError(
                f"the anomaly at epoch {rb.epoch} step {rb.step} recurred "
                "after rolling back — the failure replays "
                "deterministically (bad input shard or diverged config); "
                "refusing to rollback-loop") from rb
        ckpt_dir = self.checkpoint_cfg.checkpoint_dir
        serial = io_mod.get_latest_checkpoint_serial(ckpt_dir)
        if serial < 0:
            raise guard_mod.StepAnomalyError(
                "PT_GUARD=rollback: no verified checkpoint serial to roll "
                f"back to in {ckpt_dir!r}") from rb
        self.checkpoint_cfg.epoch_id = 0
        self.checkpoint_cfg.step_id = 0
        with scope_guard(self.scope):
            args = io_mod.load_checkpoint(
                self.exe, ckpt_dir, serial, self.train_program,
                scope=self.scope, verify=False)
        if not args:
            raise guard_mod.StepAnomalyError(
                f"PT_GUARD=rollback: checkpoint serial {serial} in "
                f"{ckpt_dir!r} carries no trainer args (resume point) — "
                "cannot roll back to a checkpoint this trainer did not "
                "write") from rb
        self._restore_trainer_args(args)
        self.checkpoint_cfg.load_serial = serial
        self._pending_health = []
        self._bad_streak = 0
        self._guard_rollbacks += 1
        self._last_rollback_at = (rb.epoch, rb.step)
        obs_trace.instant("guard_rollback", cat="train", epoch=rb.epoch,
                          step=rb.step, serial=serial)
        self.train_metrics.on_rollback()
        _log.warning(
            "[guard] %d consecutive anomalous steps (epoch %d step %d): "
            "rolled back to verified checkpoint serial %d — resuming at "
            "epoch %d step %d", rb.streak, rb.epoch, rb.step, serial,
            self.checkpoint_cfg.epoch_id, self.checkpoint_cfg.step_id)

    # -- feeds ---------------------------------------------------------------
    def _upload(self, feed: dict) -> dict:
        """A feed dict on the executor's device: each array in its var's
        device dtype, copied from pinned host memory with non_blocking
        on a card (the copy overlaps the step queued before it)."""
        block = self.train_program.global_block
        cuda = self.exe.device.type == "cuda"
        out = {}
        for k, v in feed.items():
            if not isinstance(v, (np.ndarray, torch.Tensor)):
                out[k] = v      # ragged lists: the executor pads them
                continue
            t = v if isinstance(v, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(v))
            if block.has_var(k):
                t = t.to(torch_dtype(block.var(k).dtype))
            if cuda and t.device.type == "cpu":
                t = t.pin_memory().to(self.exe.device, non_blocking=True)
            out[k] = t
        return out

    def _one_ahead(self, feeds):
        """Upload feed i+1 before feed i is handed out (double_buffer)."""
        it = iter(feeds)
        try:
            cur = next(it)
        except StopIteration:
            return
        cur = self._upload(cur) if isinstance(cur, dict) else cur
        for nxt in it:
            nxt = self._upload(nxt) if isinstance(nxt, dict) else nxt
            yield cur
            cur = nxt
        yield cur

    def _train_impl(self, num_epochs, event_handler, reader, feed_order,
                    double_buffer, steps_per_loop, log_every=1):
        from .obs import trace as obs_trace
        from .resilience import faults
        tm = self.train_metrics
        guard_on = bool(self._guard_policy)
        executor = self.exe
        with scope_guard(self.scope):
            feeder = DataFeeder(self._feed_vars(feed_order),
                                program=self.train_program)
            start_epoch = (self.checkpoint_cfg.epoch_id
                           if self.checkpoint_cfg else 0)
            use_loop = steps_per_loop > 1

            def _strip_health(outs, epoch_id, step0, n):
                """Queue the health flag (fetched last) for the next
                boundary's read; annotate the handles with (epoch,
                step)."""
                if guard_on:
                    health, outs = outs[-1], list(outs[:-1])
                    self._pending_health.append((epoch_id, step0, n, health))
                for m in outs:
                    if isinstance(m, LazyFetch):
                        m.annotate(epoch=epoch_id, step=step0)
                return outs

            def _run_window(feed, fetch, n, epoch_id, step0):
                with obs_trace.span("step", cat="train", epoch=epoch_id,
                                    step=step0, n=n):
                    outs = executor.run_loop(
                        self.train_program, feed=feed, fetch_list=fetch,
                        n_steps=n, scope=self.scope, per_step_feeds=True,
                        lazy=True, guard=guard_on)
                    return _strip_health(outs, epoch_id, step0, n)

            def _run_one(feed, fetch, epoch_id, step_id):
                with obs_trace.span("step", cat="train", epoch=epoch_id,
                                    step=step_id, n=1):
                    outs = executor.run(self.train_program, feed=feed,
                                        fetch_list=fetch, scope=self.scope,
                                        lazy=True, guard=guard_on)
                    return _strip_health(outs, epoch_id, step_id, 1)

            for epoch_id in range(start_epoch, num_epochs):
                # a mid-epoch resume skips the batches the checkpoint's
                # run had trained on and keeps the step numbering
                resume_step = (self.checkpoint_cfg.step_id
                               if self.checkpoint_cfg
                               and epoch_id == start_epoch else 0)
                epoch_reader = reader if not resume_step else (
                    lambda r=reader, n=resume_step:
                    itertools.islice(r(), n, None))
                event_handler(BeginEpochEvent(epoch_id))
                obs_trace.instant("epoch_begin", cat="train",
                                  epoch=epoch_id)
                # pt_train_* step time: wall time between read
                # boundaries over the steps between them; the first
                # boundary only seeds
                tm_boundary = None
                tm_pending_steps = 0
                batches = (d if isinstance(d, dict) else feeder.feed(d)
                           for d in epoch_reader())
                if use_loop:
                    def _stacked_windows(batches=batches):
                        # a dict is a full stacked window; a list is a
                        # fragment (shape change or epoch tail)
                        for window in _shape_chunks(batches, steps_per_loop):
                            if len(window) == steps_per_loop:
                                yield {k: np.stack([f[k] for f in window])
                                       for k in window[0]}
                            else:
                                yield window
                    windows = _stacked_windows()
                    if double_buffer:
                        windows = self._one_ahead(windows)
                    step_id = resume_step
                    for window in windows:
                        faults.crash_point("step_crash")
                        n_in_window = (steps_per_loop
                                       if isinstance(window, dict)
                                       else len(window))
                        begin = BeginStepEvent(epoch_id, step_id)
                        event_handler(begin)
                        fetch = (self.train_func_outputs
                                 if begin.fetch_metrics else [])
                        if isinstance(window, dict):
                            metrics = _run_window(window, fetch, n_in_window,
                                                  epoch_id, step_id)
                        else:
                            # fragments run step by step
                            per = [_run_one(f, fetch, epoch_id, step_id + k)
                                   for k, f in enumerate(window)]
                            metrics = [np.stack([np.asarray(m) for m in ms])
                                       for ms in zip(*per)] \
                                if per and fetch else []
                        log_boundary = (
                            step_id % log_every == 0
                            or step_id // log_every
                            != (step_id + n_in_window - 1) // log_every)
                        if log_boundary:
                            metrics = materialize(metrics)
                            _observe_loss(tm, metrics)
                        event_handler(EndStepEvent(epoch_id, step_id,
                                                   metrics))
                        if log_boundary:
                            self._drain_health()
                        now = time.perf_counter()
                        tm_pending_steps += n_in_window
                        ms = None
                        if log_boundary:
                            if tm_boundary is not None:
                                ms = ((now - tm_boundary) * 1e3
                                      / tm_pending_steps)
                            tm_boundary, tm_pending_steps = now, 0
                        tm.observe_step(
                            ms, n=n_in_window,
                            examples=_window_examples(window, n_in_window))
                        prev_step, step_id = step_id, step_id + n_in_window
                        iv = (self.checkpoint_cfg.step_interval
                              if self.checkpoint_cfg else 0)
                        saved = bool(iv and prev_step // iv != step_id // iv)
                        if saved:
                            # anomalies are judged before a serial commits
                            self._drain_health()
                            self._save_checkpoint(epoch_id, step_id)
                        if self._preempt_exit(epoch_id, step_id, saved):
                            return
                else:
                    if double_buffer:
                        batches = self._one_ahead(batches)
                    for step_id, feed in enumerate(batches,
                                                   start=resume_step):
                        faults.crash_point("step_crash")
                        begin = BeginStepEvent(epoch_id, step_id)
                        event_handler(begin)
                        fetch = (self.train_func_outputs
                                 if begin.fetch_metrics else [])
                        metrics = _run_one(feed, fetch, epoch_id, step_id)
                        log_boundary = step_id % log_every == 0
                        if log_boundary:
                            metrics = materialize(metrics)
                            _observe_loss(tm, metrics)
                        event_handler(EndStepEvent(epoch_id, step_id,
                                                   metrics))
                        if log_boundary:
                            self._drain_health()
                        now = time.perf_counter()
                        tm_pending_steps += 1
                        ms = None
                        if log_boundary:
                            if tm_boundary is not None:
                                ms = ((now - tm_boundary) * 1e3
                                      / tm_pending_steps)
                            tm_boundary, tm_pending_steps = now, 0
                        tm.observe_step(ms, n=1,
                                        examples=_window_examples([feed], 1))
                        # every step_interval completed steps; the args
                        # record step_id + 1, the next step to run
                        iv = (self.checkpoint_cfg.step_interval
                              if self.checkpoint_cfg else 0)
                        saved = bool(iv and step_id // iv
                                     != (step_id + 1) // iv)
                        if saved:
                            self._drain_health()
                            self._save_checkpoint(epoch_id, step_id + 1)
                        if self._preempt_exit(epoch_id, step_id + 1, saved):
                            return
                event_handler(EndEpochEvent(epoch_id))
                obs_trace.instant("epoch_end", cat="train", epoch=epoch_id)
                tm.on_epoch()
                self._drain_health()
                saved = self._epoch_checkpoint(epoch_id)
                if self._preempt_exit(epoch_id + 1, 0, saved):
                    return

    def test(self, reader: Callable, feed_order: Optional[list] = None):
        """The mean of each train_func output over `reader`'s batches,
        through the for_test clone; one host read at the end."""
        test_program = self.train_program.clone(for_test=True)
        with scope_guard(self.scope):
            feeder = DataFeeder(self._feed_vars(feed_order),
                                program=self.train_program)
            cols = None
            count = 0
            for d in reader():
                feed = d if isinstance(d, dict) else feeder.feed(d)
                outs = self.exe.run(test_program, feed=feed,
                                    fetch_list=self.train_func_outputs,
                                    scope=self.scope, return_numpy=False)
                vals = [o.reshape(-1)[0] for o in outs]
                if cols is None:
                    cols = [[] for _ in vals]
                for c, v in zip(cols, vals):
                    c.append(v)
                count += 1
            # a left-to-right float64 sum on the host, as the JAX package
            return [sum(torch.stack(c).double().cpu().numpy().tolist())
                    / max(count, 1) for c in (cols or [])]

    def save_params(self, param_path: str):
        with scope_guard(self.scope):
            io_mod.save_persistables(self.exe, param_path, self.train_program,
                                     scope=self.scope)

    def save_inference_model(self, param_path, feeded_var_names, target_vars):
        with scope_guard(self.scope):
            io_mod.save_inference_model(param_path, feeded_var_names,
                                        target_vars, self.exe,
                                        self.train_program, scope=self.scope)

    def stop(self):
        pass

    # -- internals ----------------------------------------------------------
    def _feed_vars(self, feed_order):
        block = self.train_program.global_block
        if feed_order is None:
            return [v for v in block.vars.values()
                    if getattr(v, "is_data", False)
                    and not v.name.endswith("@SEQ_LEN")]
        return [block.var(n) for n in feed_order]

    def _epoch_checkpoint(self, epoch_id) -> bool:
        """The end-of-epoch checkpoint, saved as (epoch_id + 1, 0): a
        resume continues at the next epoch."""
        if (self.checkpoint_cfg and
                (epoch_id + 1) % self.checkpoint_cfg.epoch_interval == 0):
            self._save_checkpoint(epoch_id + 1, 0)
            return True
        return False

    def _save_checkpoint(self, epoch_id, step_id):
        """The trainer args record the resume point (the next epoch and
        step to run) and the executor's run counter."""
        from .obs import trace as obs_trace
        with obs_trace.span("checkpoint", cat="train", epoch=epoch_id,
                            step=step_id):
            io_mod.save_checkpoint(
                self.exe, self.checkpoint_cfg.checkpoint_dir, trainer_id=0,
                trainer_args={"args_version": 2, "epoch_id": epoch_id,
                              "step_id": step_id,
                              "run_counter": self.exe._run_counter},
                main_program=self.train_program,
                max_num_checkpoints=self.checkpoint_cfg.max_num_checkpoints,
                scope=self.scope)
        self.train_metrics.on_checkpoint()


class Inferencer:
    """The for_test program `infer_func` builds, over parameters loaded
    from `param_path` by name."""

    def __init__(self, infer_func: Callable, param_path: str,
                 place: Optional[Place] = None, parallel: bool = False):
        if parallel:
            raise NotImplementedError("Inferencer(parallel=True): not "
                                      "ported")
        self.scope = Scope()
        self.inference_program = Program()
        startup = Program()
        with program_guard(self.inference_program, startup):
            self.predict_var = infer_func()
        self.inference_program = self.inference_program.clone(for_test=True)
        self.exe = Executor(place)
        with scope_guard(self.scope):
            io_mod.load_vars(self.exe, param_path, self.inference_program,
                             predicate=lambda v: v.is_parameter,
                             scope=self.scope)

    def infer(self, inputs: dict, return_numpy: bool = True):
        with scope_guard(self.scope):
            return self.exe.run(self.inference_program, feed=inputs,
                                fetch_list=[self.predict_var],
                                scope=self.scope, return_numpy=return_numpy)
