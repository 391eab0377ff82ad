"""The port's fleet tier (paddle_tpu_torch/serving/fleet/) against the JAX
package's, on the CPU.

Scripted inputs go through both packages' fleets, over the synthetic
replica models of tests/test_fleet.py (served through
``ServingEngine.load_model_object``), and each decision is held to the
JAX package's:

* the replica each session lands on (rendezvous hash over replica ids);
* the weighted-fair queue's pop order and its shed order, with the shed
  class on the typed ``Overloaded``;
* the autoscaler's decisions over one scripted ``FakePool`` signal trace;
* ``RetryPolicy``'s delays for a seed;
* the ``pt_fleet_*`` series' names and labels in the Prometheus text;
* the ``/v1/fleet`` body and the typed-error bodies over HTTP.

One end-to-end case serves a 2-layer ``transformer_lm`` artifact,
exported by both packages from one startup state, through a 2-replica
fleet in each: the answers agree within 1e-5 (float32 in two
frameworks, sums in other orders), and a decode bundle's ``generate``
through the router gives the same tokens. Then the classes of
tests/test_fleet.py, replayed on the port; the timing is driven by
events and gates (a wait polls a condition), and the autoscaler by
explicit ``tick()`` calls. Part A of the program path (core/lowering.py
liveness) is held here too: the planned prefill drops its dead outputs
and still matches the JAX bundle, and the LM's training step still
matches JAX's Executor.
"""

from __future__ import annotations

import json
import re
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import io as jio
from paddle_tpu.models import transformer as jtfm
from paddle_tpu.obs import metrics as jobs
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.resilience import retry as jretry
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import admission as jadm
from paddle_tpu.serving import fleet as jfleet
from paddle_tpu.serving import http as jhttp

import paddle_tpu_torch as tpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.models import transformer as ttfm
from paddle_tpu_torch.obs import metrics as tobs
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.resilience import retry as tretry
from paddle_tpu_torch.serving import ServingEngine as TEngine
from paddle_tpu_torch.serving import admission as tadm
from paddle_tpu_torch.serving import fleet as tfleet
from paddle_tpu_torch.serving import http as thttp
from paddle_tpu_torch.serving.fleet import (Autoscaler, FleetRouter,
                                            PendingRequest, ReplicaPool,
                                            WeightedFairQueue, make_fleet)
from paddle_tpu_torch.serving.metrics import ServingMetrics

TOL = dict(atol=1e-5, rtol=1e-5)

PKGS = {
    "jax": types.SimpleNamespace(
        fleet=jfleet, faults=jfaults, retry=jretry, adm=jadm, http=jhttp,
        obs=jobs, Engine=JEngine, device={}),
    "torch": types.SimpleNamespace(
        fleet=tfleet, faults=tfaults, retry=tretry, adm=tadm, http=thttp,
        obs=tobs, Engine=TEngine, device={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def fresh_fault_plans(monkeypatch):
    monkeypatch.delenv("PT_FAULT_INJECT", raising=False)
    for P in PKGS.values():
        P.faults.reset()
    yield
    for P in PKGS.values():
        P.faults.reset()


def _wait_until(pred, timeout: float = 15.0) -> None:
    """Poll `pred` until it holds; fail the test after `timeout` s."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            pytest.fail("condition never held")
        time.sleep(0.005)


class SyntheticModel:
    """One replica's 'model' (tests/test_fleet.py's): doubles x,
    optionally waits on a gate, optionally crashes (a dead dispatcher),
    counts the examples it served and tags results with its replica."""

    batch_size = 4
    version = None

    def __init__(self, rid: str = "?"):
        self.rid = rid
        self.crash = False
        self.served = 0
        self._lock = threading.Lock()
        self.gate = None   # a threading.Event execution waits on
        self.started = threading.Event()   # set as a batch starts

    def bucket_of(self, feeds):
        return None

    def execute_batch(self, bucket, examples, timer=None):
        self.started.set()
        if self.gate is not None:
            assert self.gate.wait(20.0), "test gate never released"
        if self.crash:
            raise RuntimeError(f"replica {self.rid} dispatcher died")
        with self._lock:
            self.served += len(examples)
        out = [{"y": np.asarray(e["x"], np.float64) * 2.0,
                "rid": np.asarray(int(self.rid[1:]))}
               for e in examples]
        return out, {"pad": 0.0, "device": 0.0, "scatter": 0.0}


def _make(P=PKGS["torch"], n=2, policy="least_loaded", queue_depth=1024,
          gate=None, gates=None, engine_opts=None, **router_kw):
    """A fleet of package P over synthetic replicas; returns (router,
    {rid: model}). gates: {rid: Event} per-replica gates."""
    models = {}

    def loader(engine, rid):
        m = models.get(rid)
        if m is None:
            m = models[rid] = SyntheticModel(rid)
            m.gate = (gates or {}).get(rid, gate)
        engine.load_model_object("m", m)

    pool = P.fleet.ReplicaPool(loader, replicas=n, max_replicas=max(n, 8),
                               engine_opts=engine_opts, **P.device)
    router = P.fleet.FleetRouter(pool, policy=policy,
                                 queue_depth=queue_depth, **router_kw)
    return router, models


def _fire(router, n, priority=0, session=None, x0=0):
    return [router.submit("m", {"x": np.float32(x0 + i)},
                          priority=priority, session=session)
            for i in range(n)]


def _served_by(router, session):
    fut = router.submit("m", {"x": np.float32(1)}, session=session)
    return int(fut.result(timeout=10)["rid"])


# ---------------------------------------------------------------------------
# the port against the JAX package, decision by decision
# ---------------------------------------------------------------------------

class TestParity:
    def test_sessions_land_on_the_same_replica(self):
        sessions = [f"user-{i}" for i in range(32)]
        got = {}
        for name, P in PKGS.items():
            router, _ = _make(P, 4)
            try:
                got[name] = {s: _served_by(router, s) for s in sessions}
                router.pool.scale_to(5)
                got[name + "@5"] = {s: _served_by(router, s)
                                    for s in sessions}
            finally:
                router.close()
        assert got["torch"] == got["jax"]
        assert got["torch@5"] == got["jax@5"]
        assert len(set(got["torch"].values())) > 1

    @pytest.mark.parametrize("depth,script", [
        (4, [0, 1, 0, 1, 2, 1, 1, 0, 3, 2, 0, 0, 5]),
        (3, [2, 2, 2, 1, 0, 3, 3, 3, 1, 9, 2000]),
        (64, [i % 3 for i in range(40)] + [7] * 30),
    ])
    def test_wfq_pop_and_shed_order(self, depth, script):
        def run(P):
            wfq = P.fleet.WeightedFairQueue(depth)
            log = []
            for i, cls in enumerate(script):
                item = P.fleet.PendingRequest("m", i, cls=cls)
                try:
                    victim = wfq.offer(item)
                    log.append(("victim", None if victim is None
                                else (victim.feeds, victim.cls)))
                except P.adm.Overloaded as e:
                    log.append(("shed", e.shed_class, str(e)))
                if i % 4 == 3:
                    got = wfq.pop()
                    log.append(("pop", got.feeds, got.cls))
            log.append(("depths", wfq.depths()))
            log.append(("drain", [(x.feeds, x.cls) for x in wfq.drain()]))
            return log

        assert run(PKGS["torch"]) == run(PKGS["jax"])

    def test_autoscaler_decisions_over_one_trace(self):
        trace = ([10, 10, 10, 0, 10, 0, 2, 2, 2] + [0] * 12 + [10] * 6
                 + [3, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 5, 5, 5])
        ewma = [10.0, 600.0, 2500.0]

        def run(P):
            pool = FakePool(2, lo=1, hi=4)
            it = iter(enumerate(trace))

            def feed():
                i, d = next(it)
                return {f"r{r}": {"queue_depth": d,
                                  "ewma_ms": ewma[i % 3] if i > 20
                                  else 10.0, "healthy": True}
                        for r in range(pool.size())}
            asc = P.fleet.Autoscaler(pool, health=feed, up_depth=4.0,
                                     down_depth=0.5, up_backlog_s=1.0,
                                     up_after=2, down_after=4)
            decisions = [asc.tick() for _ in trace]
            desc = asc.describe()
            return decisions, pool.scale_calls, desc

        assert run(PKGS["torch"]) == run(PKGS["jax"])

    @pytest.mark.parametrize("kw", [
        dict(), dict(seed=7), dict(retries=6, base_delay=0.01, seed=3),
        dict(retries=5, max_delay=0.1, jitter=0.0, seed=11),
    ])
    def test_retry_policy_delays_for_a_seed(self, kw):
        got = {}
        for name, P in PKGS.items():
            slept, seen = [], []
            policy = P.retry.RetryPolicy(sleep=slept.append, **kw)
            calls = {"n": 0}

            def flaky():
                calls["n"] += 1
                if calls["n"] <= policy.retries:
                    raise OSError(f"attempt {calls['n']}")
                return calls["n"]

            out = P.retry.retry_call(
                flaky, policy=policy,
                on_retry=lambda e, n, d: seen.append((str(e), n, d)))
            got[name] = (list(policy.delays()), slept, seen, out)
        assert got["torch"] == got["jax"]

    def test_retry_exhaustion_reraises_the_original(self):
        for P in PKGS.values():
            policy = P.retry.RetryPolicy(retries=2, sleep=lambda s: None)
            with pytest.raises(OSError, match="root cause"):
                P.retry.retry_call(
                    lambda: (_ for _ in ()).throw(OSError("root cause")),
                    policy=policy)

    def test_fleet_series_names_and_labels(self):
        def series(P):
            router, _ = _make(P, 2, policy="round_robin")
            try:
                for f in _fire(router, 6, priority=1, session="s"):
                    f.result(timeout=10)
                for f in _fire(router, 4):
                    f.result(timeout=10)
                with pytest.raises(P.adm.ModelUnavailable):
                    router.submit("nope", {"x": np.float32(1)})
                text = P.obs.render_prometheus(router.metrics_snapshot())
                assert P.obs.validate_exposition(text) == []
            finally:
                router.close()
            out = set()
            for line in text.splitlines():
                m = re.match(r"(pt_fleet_\w+)(\{[^}]*\})?\s", line)
                if m:
                    out.add((m.group(1), m.group(2) or ""))
            return out

        got = series(PKGS["torch"])
        assert got == series(PKGS["jax"])
        assert ("pt_fleet_replicas", '{fleet="fleet"}') in got

    def test_http_fleet_and_typed_error_bodies(self):
        def bodies(P):
            gate = threading.Event()
            gate.set()
            router, models = _make(P, 1, queue_depth=1,
                                   gates={"r0": gate},
                                   engine_opts={"queue_depth": 1,
                                                "max_wait_ms": 0.5})
            server, _ = P.http.start_http_server(router)
            base = f"http://127.0.0.1:{server.server_address[1]}"
            out = {}
            try:
                out["predict"] = _http(f"{base}/v1/models/m:predict",
                                       {"feeds": {"x": 3.0},
                                        "priority": 1},
                                       {"X-PT-Session": "u1"})
                st = _http(f"{base}/v1/fleet")
                for h in st[1]["replicas"].values():
                    h["ewma_ms"] = h["ewma_ms"] is not None
                out["fleet"] = st
                out["bad_priority"] = _http(
                    f"{base}/v1/models/m:predict",
                    {"feeds": {"x": 1.0}, "priority": "gold"})
                out["unknown"] = _http(f"{base}/v1/models/typo:predict",
                                       {"feeds": {"x": 1.0}})
                # overload: one request blocked on the gate, one queued in
                # the replica's engine, one waiting in the fleet queue; the
                # next class-0 arrival is the shed victim
                gate.clear()
                models["r0"].started.clear()
                futs = [router.submit("m", {"x": np.float32(0)})]
                _wait_until(models["r0"].started.is_set)
                futs.append(router.submit("m", {"x": np.float32(1)}))
                _wait_until(lambda: not router.queue_depths() and
                            router.pool.health()["r0"]["queue_depth"] == 1)
                futs.append(router.submit("m", {"x": np.float32(2)}))
                _wait_until(lambda: router.queue_depths() == {0: 1})
                out["overloaded"] = _http(f"{base}/v1/models/m:predict",
                                          {"feeds": {"x": 1.0}})
                gate.set()
                out["drained"] = [float(f.result(timeout=10)["y"])
                                  for f in futs]
            finally:
                gate.set()
                server.shutdown()
                server.server_close()
                router.close()
            return out

        got = bodies(PKGS["torch"])
        assert got == bodies(PKGS["jax"])
        assert got["fleet"][0] == 200 and got["overloaded"][0] == 429
        assert got["overloaded"][1]["shed_class"] == 0
        assert got["bad_priority"][0] == 400 and got["unknown"][0] == 404

    def test_single_engine_has_no_fleet_route(self):
        got = {}
        for name, P in PKGS.items():
            engine = P.Engine(**P.device)
            server, _ = P.http.start_http_server(engine)
            try:
                got[name] = _http(
                    f"http://127.0.0.1:{server.server_address[1]}/v1/fleet")
            finally:
                server.shutdown()
                server.server_close()
                engine.shutdown()
        assert got["torch"] == got["jax"] and got["torch"][0] == 404


def _http(url, payload=None, headers=None):
    """(status, JSON body) of a GET (payload None) or a JSON POST."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data,
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---------------------------------------------------------------------------
# end to end: a transformer_lm artifact and a decode bundle behind 2-replica
# fleets of both packages
# ---------------------------------------------------------------------------

LM = dict(vocab_size=50, n_layers=2, d_model=32, n_heads=2, d_ff=64)
LM_SEQ, LM_BATCH = 16, 2
DEC_CFG = dict(vocab_size=43, n_layers=2, d_model=16, n_heads=2, d_ff=32,
               max_context=32)
DEC_GEOMETRY = dict(length_buckets=(8, 16), slots=3, block_size=4,
                    pool_blocks=24)


@pytest.fixture(scope="module")
def one_thread():
    """CPU products split over threads are not bit-reproducible run to
    run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lm_program(pkg):
    tfm = jtfm if pkg is jpt else ttfm
    pkg.core.program.reset_unique_names()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        src = pkg.layers.data("src_ids", [LM_SEQ], dtype="int64")
        logits = tfm.transformer_lm(src, max_len=LM_SEQ, **LM)
    return main, startup, logits


@pytest.fixture(scope="module")
def lm_artifacts(tmp_path_factory, one_thread):
    """(JAX artifact, port artifact, JAX decode bundle, port decode
    bundle), each pair from one JAX startup state."""
    root = tmp_path_factory.mktemp("torch_fleet")
    main, startup, logits = _lm_program(jpt)
    scope = jpt.Scope()
    jdir, tdir = str(root / "lm_jax"), str(root / "lm_torch")
    with jpt.scope_guard(scope):
        jpt.Executor().run(startup)
        jio.export_serving_model(jdir, ["src_ids"], [logits],
                                 main_program=main, scope=scope,
                                 batch_size=LM_BATCH)
    state = {v.name: np.asarray(scope.find_var(v.name))
             for v in main.list_vars() if v.persistable}
    tmain, _, tlogits = _lm_program(tpt)
    tio.export_serving_model(tdir, ["src_ids"], [tlogits],
                             main_program=tmain,
                             scope=tio.scope_from_numpy(state, "cpu"),
                             batch_size=LM_BATCH)

    jpt.core.program.reset_unique_names()
    main, startup = jpt.Program(), jpt.Program()
    with jpt.program_guard(main, startup):
        jtfm.transformer_lm_loss(
            seq_len=DEC_CFG["max_context"], max_len=DEC_CFG["max_context"],
            **{k: DEC_CFG[k] for k in ("vocab_size", "n_layers", "d_model",
                                       "n_heads", "d_ff")})
    scope = jpt.Scope()
    jdec, tdec = str(root / "dec_jax"), str(root / "dec_torch")
    with jpt.scope_guard(scope):
        jpt.Executor().run(startup)
        jio.export_decode_model(jdec, DEC_CFG, scope=scope, **DEC_GEOMETRY)
    params = {p.name: np.asarray(scope.find_var(p.name))
              for p in main.all_parameters()}
    tio.export_decode_model(tdec, DEC_CFG, params=params, **DEC_GEOMETRY)
    return jdir, tdir, jdec, tdec, logits.name


def test_lm_fleet_answers_and_generations_match_jax(lm_artifacts):
    jdir, tdir, jdec, tdec, fetch = lm_artifacts
    rng = np.random.default_rng(5)
    reqs = [{"src_ids": rng.integers(1, LM["vocab_size"], LM_SEQ)}
            for _ in range(6)]
    prompts = [rng.integers(1, DEC_CFG["vocab_size"], n).tolist()
               for n in (5, 11)]
    got = {}
    for name, (P, art, dec) in {"jax": (PKGS["jax"], jdir, jdec),
                                "torch": (PKGS["torch"], tdir,
                                          tdec)}.items():
        def loader(engine, rid, art=art, dec=dec):
            engine.load_model("lm", art)
            engine.load_decode_model("lm_decode", dec, warmup=False)

        router = P.fleet.make_fleet(loader, replicas=2, **P.device)
        try:
            futs = [router.submit("lm", r, priority=i % 3,
                                  session=f"s{i % 2}" if i < 4 else None)
                    for i, r in enumerate(reqs)]
            outs = [np.asarray(f.result(timeout=120)[fetch]) for f in futs]
            gens = [router.generate("lm_decode", p, max_new_tokens=6,
                                    session="chat").result()["tokens"]
                    for p in prompts]
            assert router.pool.size() == 2
        finally:
            router.close()
        got[name] = outs, gens
    for o_t, o_j in zip(*(got[k][0] for k in ("torch", "jax"))):
        assert o_t.shape == (LM_SEQ, LM["vocab_size"])
        np.testing.assert_allclose(o_t, o_j, **TOL)
    assert got["torch"][1] == got["jax"][1]


def _dead_layer_norm_outputs(plan, block):
    """(the layer norms' Mean / Variance names, the env slots the plan
    binds); every planned layer norm is asked for Y alone."""
    lns = [op for op in block.ops if op.type == "layer_norm"]
    dead = {n for op in lns for s in ("Mean", "Variance")
            for n in op.output(s)}
    bound = {i for op in plan.ops for _, _, binds in op.outs
             for _, i, _ in binds}
    for op in plan.ops:
        if op.type == "layer_norm":
            assert [slot for slot, _, _ in op.outs] == ["Y"]
            assert op.compute.keywords == {"wanted": frozenset({"Y"})}
    return dead, {n for n, i in plan.index.items() if i in bound}


def test_planned_prefill_drops_dead_outputs_and_matches_jax(lm_artifacts):
    """core/lowering.py's plan: the layer norms' Mean / Variance, which
    no op, fetch or state reads, are neither computed nor bound; the
    served prefill (the decode bundle's 16 bucket) still matches the JAX
    bundle's within 1e-5."""
    _, _, jdec, tdec, _ = lm_artifacts
    from paddle_tpu.serving.decode import DecodeModel as JDecodeModel
    from paddle_tpu_torch.serving.decode import DecodeModel

    tm = DecodeModel(tdec, device="cpu", warmup=False)
    jm = JDecodeModel(jdec, warmup=False)
    prog = tm.prefill_model._buckets[16].run
    dead, bound = _dead_layer_norm_outputs(
        prog._step.plan, prog.program.global_block)
    assert len(dead) == 2 * (2 * DEC_CFG["n_layers"] + 1)
    assert not dead & bound
    toks = list(range(3, 16))
    t_logits, t_kv = tm.prefill(toks)
    j_logits, j_kv = jm.prefill(toks)
    np.testing.assert_allclose(t_logits, np.asarray(j_logits), **TOL)
    for (tk, tv), (jk, jv) in zip(t_kv, j_kv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_planned_training_step_keeps_what_the_optimizer_reads(one_thread):
    """The LM's SGD step through the planned program (dead outputs
    dropped before the backward; the optimizer's reads and the state
    kept) against JAX's Executor from one startup state: the loss within
    rtol 1e-4 and every persistable within atol 1e-5, rtol 1e-4, as
    tests/test_torch_executor.py holds the step."""
    cfg = dict(vocab_size=37, seq_len=8, n_layers=1, d_model=16,
               n_heads=2, d_ff=32, max_len=8)
    rng = np.random.default_rng(3)
    src = rng.integers(0, cfg["vocab_size"], (2, cfg["seq_len"]))
    feed = {"src_ids": src.astype(np.int64),
            "tgt_ids": src[..., None].astype(np.int64)}
    built = []
    for pkg, tfm in ((jpt, jtfm), (tpt, ttfm)):
        pkg.core.program.reset_unique_names()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            avg, _ = tfm.transformer_lm_loss(**cfg)
            pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(avg)
        built.append((main, startup, avg))
    (jmain, jstart, javg), (tmain, _, tavg) = built
    jexe, jscope = jpt.Executor(), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    names = sorted(v.name for v in jmain.list_vars() if v.persistable)
    start = {n: np.array(jscope.find_var(n)) for n in names}
    jloss, = jexe.run(jmain, feed=feed, fetch_list=[javg], scope=jscope)
    scope = tio.scope_from_numpy(start, "cpu")
    tloss, = tpt.Executor(tpt.CPUPlace()).run(tmain, feed=feed,
                                              fetch_list=[tavg],
                                              scope=scope)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    for n in names:
        np.testing.assert_allclose(scope.get_numpy(n),
                                   np.array(jscope.find_var(n)), atol=1e-5,
                                   rtol=1e-4, err_msg=n)
    step, _ = lowering.build_step_fn(
        tmain, ["src_ids", "tgt_ids"], [tavg.name], names,
        torch.device("cpu"))
    dead, bound = _dead_layer_norm_outputs(step.plan, tmain.global_block)
    assert len(dead) == 2 * (2 * cfg["n_layers"] + 1)
    assert not dead & bound
    # what the optimizer reads survives the forward (the parameters),
    # and every parameter's gradient has its slot
    params = [p.name for p in tmain.global_block.all_parameters()]
    names_of = {i: n for n, i in step.plan.index.items()}
    assert set(params) <= {names_of[i] for i in step.plan.kept}
    assert {names_of[i] for i in step.plan.grads} == \
        {p + "@GRAD" for p in params}


# ---------------------------------------------------------------------------
# tests/test_fleet.py's classes, on the port
# ---------------------------------------------------------------------------

class TestDispatch:
    def test_basic_dispatch_and_results(self):
        router, _ = _make(n=2)
        try:
            futs = _fire(router, 16)
            for i, f in enumerate(futs):
                assert float(f.result(timeout=10)["y"]) == 2.0 * i
            snap = router.metrics.snapshot()
            assert snap["completed"] == 16
            assert sum(snap["dispatched"].values()) == 16
        finally:
            router.close()

    def test_round_robin_splits_evenly(self):
        router, models = _make(n=2, policy="round_robin")
        try:
            for f in _fire(router, 24):
                f.result(timeout=10)
            assert sorted(m.served for m in models.values()) == [12, 12]
        finally:
            router.close()

    def test_least_loaded_avoids_a_stalled_replica(self):
        # r0 is held shut: its queue depth grows with every request it
        # takes, so least_loaded sends the rest to r1. Round-robin
        # (above) splits blindly.
        stall = threading.Event()
        router, models = _make(n=2, gates={"r0": stall})
        try:
            futs = []
            for i in range(24):
                futs.extend(_fire(router, 1, x0=i))
                _wait_until(lambda: not router.queue_depths())
            _wait_until(lambda: models["r1"].served
                        + sum(not f.done() for f in futs) == 24)
            stall.set()
            for i, f in enumerate(futs):
                assert float(f.result(timeout=10)["y"]) == 2.0 * i
            assert models["r1"].served > 3 * models["r0"].served, (
                models["r0"].served, models["r1"].served)
        finally:
            stall.set()
            router.close()

    def test_unknown_policy_refused(self):
        pool = ReplicaPool(
            lambda e, r: e.load_model_object("m", SyntheticModel(r)),
            replicas=1, device="cpu")
        try:
            with pytest.raises(ValueError):
                FleetRouter(pool, policy="wishful")
        finally:
            pool.close()

    def test_default_device_is_the_card(self, monkeypatch):
        # no card here: a pool that names no device raises before it
        # builds a replica; there is no fallback to the CPU
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        built = []
        with pytest.raises(RuntimeError):
            ReplicaPool(lambda e, r: built.append(r), replicas=1)
        with pytest.raises(RuntimeError):
            make_fleet(lambda e, r: built.append(r), replicas=1)
        assert built == []


class TestSessionAffinity:
    def test_same_session_same_replica(self):
        router, _ = _make(n=4)
        try:
            sessions = [f"user-{i}" for i in range(24)]
            first = {s: _served_by(router, s) for s in sessions}
            again = {s: _served_by(router, s) for s in sessions}
            assert first == again
            assert len(set(first.values())) > 1
        finally:
            router.close()

    def test_affinity_stable_across_scale_events(self):
        router, _ = _make(n=3, queue_depth=4096)
        try:
            sessions = [f"user-{i}" for i in range(40)]
            at3 = {s: _served_by(router, s) for s in sessions}
            router.pool.scale_to(4)
            at4 = {s: _served_by(router, s) for s in sessions}
            moved = [s for s in sessions if at4[s] != at3[s]]
            assert all(at4[s] == 3 for s in moved)
            assert len(moved) < len(sessions) // 2
            router.pool.scale_to(3)
            at3b = {s: _served_by(router, s) for s in sessions}
            for s in sessions:
                if at4[s] != 3:
                    assert at3b[s] == at4[s]
        finally:
            router.close()

    def test_affinity_survives_rebuild(self):
        router, models = _make(n=3)
        try:
            rid = _served_by(router, "sticky")
            models[f"r{rid}"].crash = True
            fut = router.submit("m", {"x": np.float32(1)},
                                session="sticky")
            assert int(fut.result(timeout=10)["rid"]) != rid
            models[f"r{rid}"].crash = False

            def rebuilt():
                rep = router.pool.get(f"r{rid}")
                return rep is not None and rep.healthy
            _wait_until(rebuilt)
            assert _served_by(router, "sticky") == rid
        finally:
            router.close()


class TestPriorityAdmission:
    def test_wfq_service_shares_follow_weights(self):
        wfq = WeightedFairQueue(10_000)
        for i in range(300):
            wfq.offer(PendingRequest("m", None, cls=i % 2))
        order = [wfq.pop().cls for _ in range(150)]
        c1 = sum(order)
        c0 = len(order) - c1
        assert 1.5 <= c1 / max(c0, 1) <= 2.5, (c0, c1)
        assert 0 in order[:10]

    def test_wfq_shed_strictly_lowest_class_first(self):
        wfq = WeightedFairQueue(4)
        for cls in (0, 1, 0, 1):
            assert wfq.offer(PendingRequest("m", None, cls=cls)) is None
        assert wfq.offer(PendingRequest("m", None, cls=2)).cls == 0
        assert wfq.offer(PendingRequest("m", None, cls=1)).cls == 0
        with pytest.raises(tadm.Overloaded) as ei:
            wfq.offer(PendingRequest("m", None, cls=1))
        assert ei.value.shed_class == 1
        with pytest.raises(tadm.Overloaded) as ei:
            wfq.offer(PendingRequest("m", None, cls=0))
        assert ei.value.shed_class == 0
        assert wfq.offer(PendingRequest("m", None, cls=3)).cls == 1

    def test_overload_free_tier_absorbs_sheds(self):
        gate = threading.Event()
        router, _ = _make(n=1, queue_depth=64, gate=gate,
                          engine_opts={"queue_depth": 4,
                                       "max_wait_ms": 0.5})
        served, shed, futs = 0, [], []
        try:
            for i in range(200):
                cls = 1 if i % 4 == 3 else 0
                try:
                    futs.append((cls, router.submit(
                        "m", {"x": np.float32(i)}, priority=cls)))
                except tadm.Overloaded as e:
                    assert e.shed_class == cls
                    shed.append(cls)
            gate.set()
            for cls, f in futs:
                try:
                    f.result(timeout=30)
                    served += 1
                except tadm.Overloaded as e:
                    assert e.shed_class == cls
                    shed.append(cls)
            assert served + len(shed) == 200
            assert len(shed) >= 30
            assert shed.count(0) / len(shed) >= 0.9
            assert shed.count(1) / 50 < shed.count(0) / 150
            snap = router.metrics.snapshot()
            assert snap["sheds"].get("0", 0) == shed.count(0)
            assert snap["sheds"].get("1", 0) == shed.count(1)
        finally:
            gate.set()
            router.close()

    def test_hostile_priority_cannot_kill_the_dispatcher(self):
        from paddle_tpu_torch.serving.fleet.admission import MAX_CLASS
        router, _ = _make(n=1)
        try:
            hostile = router.submit("m", {"x": np.float32(7)},
                                    priority=2000)
            assert float(hostile.result(timeout=10)["y"]) == 14.0
            for i, f in enumerate(_fire(router, 8)):
                assert float(f.result(timeout=10)["y"]) == 2.0 * i
        finally:
            router.close()
        wfq = WeightedFairQueue(10)
        wfq.offer(PendingRequest("m", None, cls=10**9))
        got = wfq.pop()
        assert got.cls == MAX_CLASS and wfq.pop() is None

    def test_deadline_passthrough_to_replica(self):
        gate = threading.Event()
        router, models = _make(n=1, gate=gate)
        try:
            head = _fire(router, 1)
            _wait_until(models["r0"].started.is_set)
            t0 = time.monotonic()
            late = router.submit("m", {"x": np.float32(1)}, deadline_ms=30)
            # the late request waits behind the gated head past its
            # deadline
            _wait_until(lambda: time.monotonic() > t0 + 0.06)
            gate.set()
            head[0].result(timeout=10)
            with pytest.raises(tadm.DeadlineExceeded):
                late.result(timeout=10)
        finally:
            gate.set()
            router.close()


class TestFailoverAndScale:
    def test_request_failed_fails_over_and_rebuilds(self):
        router, models = _make(n=2)
        try:
            for f in _fire(router, 4):
                f.result(timeout=10)
            models["r0"].crash = True
            for f in _fire(router, 12):
                assert int(f.result(timeout=20)["rid"]) == 1
            snap = router.metrics.snapshot()
            assert snap["failovers"] >= 1 and snap["rebuilds"] >= 1
            models["r0"].crash = False

            def rebuilt():
                rep = router.pool.get("r0")
                return rep is not None and rep.healthy
            _wait_until(rebuilt)
        finally:
            router.close()

    def test_router_dispatch_chaos_site_failover(self, monkeypatch):
        monkeypatch.setenv("PT_FAULT_INJECT", "router_dispatch@3")
        tfaults.reset()
        router, _ = _make(n=2)
        try:
            for i, f in enumerate(_fire(router, 10)):
                assert float(f.result(timeout=20)["y"]) == 2.0 * i
            snap = router.metrics.snapshot()
            assert snap["failovers"] == 1
            assert snap["completed"] == 10
        finally:
            router.close()

    def test_zero_dropped_futures_scale_down_plus_crash(self, monkeypatch):
        monkeypatch.setenv("PT_FAULT_INJECT", "router_dispatch@40")
        tfaults.reset()
        router, _ = _make(n=3, queue_depth=4096)
        results, errors = [], []
        lock = threading.Lock()

        def client(seed):
            for i in range(40):
                x = seed * 1000 + i
                try:
                    got = router.predict("m", {"x": np.float32(x)},
                                         priority=i % 2, timeout=30)
                    with lock:
                        results.append((x, float(got["y"])))
                except Exception as e:  # noqa: BLE001 — the drop count
                    with lock:
                        errors.append(f"{type(e).__name__}: {e}")
        try:
            threads = [threading.Thread(target=client, args=(s,))
                       for s in range(4)]
            for t in threads:
                t.start()
            _wait_until(lambda: len(results) >= 20)   # mid-fire
            router.pool.scale_to(2, reason="test")
            for t in threads:
                t.join(60)
                assert not t.is_alive()
            assert not errors, errors[:3]
            assert len(results) == 160
            assert all(y == 2.0 * x for x, y in results)
            assert router.pool.size() == 2
            assert router.metrics.snapshot()["failovers"] == 1
        finally:
            router.close()

    def test_single_replica_crash_surfaces_original_error(self):
        router, models = _make(n=1)
        try:
            for f in _fire(router, 2):
                f.result(timeout=10)
            models["r0"].crash = True
            with pytest.raises(tadm.RequestFailed):
                router.predict("m", {"x": np.float32(1)}, timeout=20)
        finally:
            router.close()

    def test_unknown_model_rejects_fast(self):
        router, _ = _make(n=2)
        try:
            with pytest.raises(tadm.ModelUnavailable):
                router.submit("nope", {"x": np.float32(1)}, priority=9)
            assert router.metrics.snapshot()["sheds"] == {}
        finally:
            router.close()

    def test_failed_rebuild_surrenders_slot_and_drains_dead_engine(self):
        state = {"built": 0}

        def loader(engine, rid):
            state["built"] += 1
            if state.get("fail"):
                raise RuntimeError("model store unreachable")
            engine.load_model_object("m", SyntheticModel(rid))

        pool = ReplicaPool(loader, replicas=1, device="cpu")
        router = FleetRouter(pool, queue_depth=64)
        try:
            for f in _fire(router, 2):
                f.result(timeout=10)
            state["fail"] = True
            pool.mark_unhealthy("r0", replica=pool.get("r0"))
            _wait_until(lambda: pool.size() == 0)
            assert state["built"] == 1 + 3   # bounded retries
            state["fail"] = False
            got = router.predict("m", {"x": np.float32(3)}, timeout=20)
            assert float(got["y"]) == 6.0
            assert pool.size() == 1
        finally:
            router.close()

    def test_generate_exhaustion_surfaces_original_error(self, monkeypatch):
        monkeypatch.setenv("PT_FAULT_INJECT", "router_dispatch@1")
        tfaults.reset()
        router, _ = _make(n=1)
        try:
            for rep in router.pool.all_replicas():
                rep.engine._decode["g"] = FakeDecodeEngine(rep.rid)
            with pytest.raises(tadm.RequestFailed):
                router.generate("g", [1, 2])
        finally:
            router.close()

    def test_pool_init_midbuild_failure_leaks_no_replicas(self):
        def loader(engine, rid):
            if rid == "r2":
                raise RuntimeError("bad artifact dir")
            engine.load_model_object("poolleak", SyntheticModel(rid))

        with pytest.raises(RuntimeError):
            ReplicaPool(loader, replicas=3, device="cpu")
        _wait_until(lambda: not [t for t in threading.enumerate()
                                 if "pt-serve[poolleak]" in t.name])

    def test_make_fleet_bad_policy_leaks_no_replicas(self):
        before = {t.name for t in threading.enumerate()}
        with pytest.raises(ValueError):
            make_fleet(lambda e, r: e.load_model_object(
                "leakm", SyntheticModel(r)),
                replicas=2, policy="least-loaded", device="cpu")
        _wait_until(lambda: not [t for t in threading.enumerate()
                                 if "pt-serve[leakm]" in t.name
                                 and t.name not in before])

    def test_stale_failover_cannot_condemn_rebuilt_replica(self):
        router, _ = _make(n=2)
        try:
            for f in _fire(router, 4):
                f.result(timeout=10)
            old = router.pool.get("r0")
            assert router.pool.mark_unhealthy("r0", replica=old)

            def rebuilt():
                rep = router.pool.get("r0")
                return rep is not None and rep.healthy and rep is not old
            _wait_until(rebuilt)
            assert not router.pool.mark_unhealthy("r0", replica=old)
            assert router.pool.get("r0").healthy
        finally:
            router.close()

    def test_second_fleet_gets_its_own_metrics_name(self):
        ra, _ = _make(n=1)
        rb, _ = _make(n=1)
        try:
            assert ra.name != rb.name
            snap = ra.metrics_snapshot()["fleet"]
            assert ra.name in snap and rb.name in snap
            ra.close()
            assert rb.name in rb.metrics_snapshot()["fleet"]
        finally:
            rb.close()

    def test_requeue_after_shutdown_fails_typed_not_hangs(self):
        router, _ = _make(n=1)
        for f in _fire(router, 2):
            f.result(timeout=10)
        router.close()
        item = PendingRequest("m", {"x": np.float32(1)}, cls=1)
        router._requeue(item)
        with pytest.raises(tadm.Overloaded) as ei:
            item.future.result(timeout=5)
        assert ei.value.shed_class == 1

    def test_all_replicas_dead_surfaces_original_error(self):
        router, models = _make(n=2)
        try:
            for f in _fire(router, 4):
                f.result(timeout=10)
            for m in models.values():
                m.crash = True
            with pytest.raises(tadm.RequestFailed):
                router.predict("m", {"x": np.float32(1)}, timeout=20)
        finally:
            router.close()


class FakePool:
    def __init__(self, size=1, lo=1, hi=4):
        self._n = size
        self.min_replicas = lo
        self.max_replicas = hi
        self.scale_calls = []

    def size(self):
        return self._n

    def scale_to(self, n, reason=""):
        self.scale_calls.append((n, reason))
        self._n = min(max(n, self.min_replicas), self.max_replicas)
        return self._n

    def health(self):
        return {}

    def ensure_min(self):
        return False


def _asc(pool, feed, **kw):
    kw.setdefault("up_depth", 4.0)
    kw.setdefault("down_depth", 0.5)
    kw.setdefault("up_after", 2)
    kw.setdefault("down_after", 4)
    return Autoscaler(pool, health=feed, **kw)


def _feed_of(depths):
    it = iter(depths)

    def feed():
        return {"r0": {"queue_depth": next(it), "ewma_ms": 10.0,
                       "healthy": True}}
    return feed


class TestAutoscalerHysteresis:
    def test_up_fast_on_sustained_depth(self):
        pool = FakePool(1)
        asc = _asc(pool, _feed_of([10, 10, 10]))
        assert asc.tick() is None
        assert asc.tick() == "up"
        assert pool._n == 2

    def test_down_slow_after_idle_window(self):
        pool = FakePool(3)
        asc = _asc(pool, _feed_of([0] * 5))
        assert [asc.tick() for _ in range(3)] == [None, None, None]
        assert asc.tick() == "down"
        assert pool._n == 2

    def test_no_flapping_on_oscillating_load(self):
        pool = FakePool(2)
        asc = _asc(pool, _feed_of([10, 0] * 10))
        assert [asc.tick() for _ in range(20)] == [None] * 20
        assert pool.scale_calls == []

    def test_band_holds_streaks_at_zero(self):
        pool = FakePool(2)
        asc = _asc(pool, _feed_of([2] * 8))
        assert all(asc.tick() is None for _ in range(8))

    def test_never_below_min_never_above_max(self):
        pool = FakePool(1, lo=1, hi=2)
        asc = _asc(pool, _feed_of([0] * 12 + [10] * 12))
        for _ in range(12):
            asc.tick()
        assert pool._n == 1
        for _ in range(12):
            asc.tick()
        assert pool._n == 2
        assert all(1 <= n <= 2 for n, _ in pool.scale_calls)

    def test_backlog_seconds_signal_scales_up(self):
        def feed():
            return {"r0": {"queue_depth": 2, "ewma_ms": 600.0,
                           "healthy": True}}
        pool = FakePool(1)
        asc = _asc(pool, feed, up_backlog_s=1.0)
        asc.tick()
        assert asc.tick() == "up"

    def test_hysteresis_band_required(self):
        with pytest.raises(ValueError):
            Autoscaler(FakePool(1), up_depth=1.0, down_depth=1.0)
        with pytest.raises(ValueError):
            Autoscaler(FakePool(1), up_backlog_s=1.0, down_backlog_s=1.0)

    def test_no_flapping_on_steady_backlog_hover(self):
        state = {"n": 2}

        def feed():
            per = 2.0 / state["n"]
            return {f"r{i}": {"queue_depth": 0.4 * per, "ewma_ms": 2500.0,
                              "healthy": True}
                    for i in range(state["n"])}

        pool = FakePool(2, lo=1, hi=4)

        def scale_to(n, reason=""):
            pool._n = state["n"] = min(max(n, 1), 4)
            pool.scale_calls.append((n, reason))
            return pool._n
        pool.scale_to = scale_to
        asc = _asc(pool, feed, up_backlog_s=1.0)
        decisions = [asc.tick() for _ in range(20)]
        assert decisions.count("up") == 1
        assert "down" not in decisions
        assert state["n"] == 3

    def test_heal_to_min_before_signal(self):
        pool = FakePool(0, lo=2, hi=4)
        healed = []
        pool.ensure_min = lambda: (healed.append(True),
                                   pool.scale_to(2))[1] == 2
        _asc(pool, lambda: {}).tick()
        assert healed and pool._n == 2

    def test_live_fleet_autoscales_up_and_back_down(self):
        # a real router under a held-back load, ticked by hand: up on
        # the live depth, then back down through the idle window
        gate = threading.Event()
        router, _ = _make(n=1, queue_depth=4096, gate=gate)
        asc = Autoscaler(router.pool, metrics=router.metrics,
                         up_depth=4.0, up_after=2, down_after=3)
        try:
            futs = _fire(router, 64)
            _wait_until(lambda: router.pool.health()["r0"]["queue_depth"]
                        >= 8)
            assert asc.tick() is None
            assert asc.tick() == "up"
            assert router.pool.size() == 2
            gate.set()
            for f in futs:
                f.result(timeout=30)
            assert [asc.tick() for _ in range(3)] == [None, None, "down"]
            assert router.pool.size() == 1
            snap = router.metrics.snapshot()
            assert snap["scale_events"] == {"up": 1, "down": 1}
        finally:
            gate.set()
            router.close()


class TestFleetMetrics:
    def test_replica_namespace_regression(self):
        s0, s1 = ServingMetrics(), ServingMetrics()
        for s in (s0, s1):
            s.model("m").on_received(1)

        def merged():
            out = {"models": {}}
            for i, s in enumerate((s0, s1)):
                out["models"].update(
                    {f"r{i}/{k}": v for k, v in
                     s.snapshot(merge_registry=False)["models"].items()})
            return tobs.render_prometheus(out)

        assert any("duplicate series" in p
                   for p in tobs.validate_exposition(merged()))
        s0.replica, s1.replica = "r0", "r1"
        text = merged()
        assert tobs.validate_exposition(text) == []
        assert 'replica="r0"' in text

    def test_fleet_scrape_conformant_and_complete(self):
        router, _ = _make(n=2)
        try:
            for f in _fire(router, 8, priority=1, session="s"):
                f.result(timeout=10)
            text = tobs.render_prometheus(router.metrics_snapshot())
            assert tobs.validate_exposition(text) == []
            assert "pt_fleet_replicas" in text
            assert "pt_fleet_dispatch_total" in text
            assert 'replica="r0"' in text and 'replica="r1"' in text
            assert text.count('pt_serve_received_total{model="m"') == 2
        finally:
            router.close()

    def test_registry_sections_merge_once(self):
        router, _ = _make(n=3)
        try:
            snap = router.metrics_snapshot()
            assert list(snap["fleet"]) == ["fleet"]
            fl = snap["fleet"]["fleet"]
            assert fl["replicas"] == 3
            assert set(fl["replica_health"]) == {"r0", "r1", "r2"}
        finally:
            router.close()


class TestFleetHTTP:
    def test_fleet_routes(self):
        router, _ = _make(n=2)
        server, _t = thttp.start_http_server(router)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            status, out = _http(f"{base}/v1/models/m:predict",
                                {"feeds": {"x": 3.0}, "priority": 1},
                                {"X-PT-Session": "u1"})
            assert status == 200 and out["fetches"]["y"]["data"] == 6.0
            status, st = _http(f"{base}/v1/fleet")
            assert set(st["replicas"]) == {"r0", "r1"}
            assert st["policy"] == "least_loaded"
            with urllib.request.urlopen(
                    f"{base}/v1/metrics?format=prometheus") as r:
                text = r.read().decode()
            assert "pt_fleet_replicas" in text
            assert tobs.validate_exposition(text) == []
            rids = {int(_http(f"{base}/v1/models/m:predict",
                              {"feeds": {"x": 1.0}},
                              {"X-PT-Session": "u1"}
                              )[1]["fetches"]["rid"]["data"])
                    for _ in range(6)}
            assert len(rids) == 1
            assert _http(f"{base}/v1/models/m:predict",
                         {"feeds": {"x": 1.0}, "priority": "gold"})[0] == 400
            assert _http(f"{base}/v1/models/typo:predict",
                         {"feeds": {"x": 1.0}})[0] == 404
        finally:
            server.shutdown()
            server.server_close()
            router.close()


class FakeDecodeEngine:
    """handle=True: generate returns a handle whose result() is the dict
    (the surface HTTP's non-streaming :generate reads)."""

    def __init__(self, rid, handle=False):
        self.rid = rid
        self.calls = []
        self.handle = handle

    def generate(self, prompt_ids, **kw):
        self.calls.append((list(prompt_ids), kw))
        out = {"replica": self.rid, "tokens": [1, 2, 3]}
        return types.SimpleNamespace(result=lambda: out) if self.handle \
            else out

    def shutdown(self, drain=True):
        pass


class TestGenerateRouting:
    def test_generate_routes_session_affine(self):
        router, _ = _make(n=3)
        try:
            for rep in router.pool.all_replicas():
                rep.engine._decode["g"] = FakeDecodeEngine(rep.rid)
            first = router.generate("g", [1, 2], session="chat-7",
                                    priority=2)
            for _ in range(4):
                again = router.generate("g", [3], session="chat-7")
                assert again["replica"] == first["replica"]
            eng = next(rep.engine._decode["g"]
                       for rep in router.pool.all_replicas()
                       if rep.rid == first["replica"])
            assert eng.calls[0][1].get("priority") == 2
            snap = router.metrics.snapshot()
            assert snap["dispatched"].get("session_affine", 0) >= 5
        finally:
            router.close()

    def test_generate_over_http_carries_the_session(self):
        router, _ = _make(n=3)
        server, _t = thttp.start_http_server(router)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            for rep in router.pool.all_replicas():
                rep.engine._decode["g"] = FakeDecodeEngine(rep.rid,
                                                           handle=True)
            replicas = {_http(f"{base}/v1/models/g:generate",
                              {"prompt_ids": [1, 2], "stream": False,
                               "priority": 1},
                              {"X-PT-Session": "chat-9"})[1]["replica"]
                        for _ in range(3)}
            assert len(replicas) == 1
            eng = router.pool.get(replicas.pop()).engine._decode["g"]
            assert eng.calls[0][1] == {"priority": 1}
        finally:
            server.shutdown()
            server.server_close()
            router.close()


class TestKnobs:
    def test_make_fleet_reads_knobs(self, monkeypatch):
        monkeypatch.setenv("PT_FLEET_REPLICAS", "2")
        monkeypatch.setenv("PT_FLEET_POLICY", "round_robin")
        monkeypatch.setenv("PT_FLEET_AUTOSCALE", "1")
        monkeypatch.setenv("PT_FLEET_MAX", "3")
        monkeypatch.setenv("PT_FLEET_MIN", "2")
        router = make_fleet(
            lambda e, r: e.load_model_object("m", SyntheticModel(r)),
            autoscaler_opts={"interval_s": 30.0}, device="cpu")
        try:
            assert router.pool.size() == 2
            assert router.policy == "round_robin"
            assert router.pool.max_replicas == 3
            assert router.pool.min_replicas == 2
            assert router.autoscaler is not None
            assert router.status()["autoscaler"]["running"]
        finally:
            router.close()
            assert router.autoscaler.describe()["running"] is False

    def test_constructor_args_win(self, monkeypatch):
        monkeypatch.setenv("PT_FLEET_REPLICAS", "3")
        monkeypatch.setenv("PT_FLEET_AUTOSCALE", "1")
        router = make_fleet(
            lambda e, r: e.load_model_object("m", SyntheticModel(r)),
            replicas=1, autoscale=False, policy="least_loaded",
            device="cpu")
        try:
            assert router.pool.size() == 1
            assert router.autoscaler is None
        finally:
            router.close()
