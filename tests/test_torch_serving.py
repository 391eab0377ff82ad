"""The port's one-shot serving plane against the JAX package, on the CPU.

The two model fixtures of tests/test_serving.py (a fixed-shape
classifier with a float and an argmax fetch; a length-bucketed model
whose reduce_sum makes padding harmless) and a 2-layer, d_model-32
``transformer_lm`` are built by the same calls in both packages, from
one JAX startup state (``scope_from_numpy``), and exported by each
package's ``io.export_serving_model``: StableHLO on the JAX side,
programs and ``.npy`` weights on the port's. Then:

* engine — the port's ``ServingEngine(device="cpu")`` answers the JAX
  engine's requests: float fetches within atol = rtol = 1e-5 (float32
  in two frameworks, sums in other orders), the argmax identical; the
  JAX tests of tests/test_serving.py replayed on the port (fetch specs,
  batch_major, static feeds refused, coalescing bit-identical to a
  request padded alone, no padding leak, typed validation, zero drops on
  hot reload and on the reload race, shedding, deadlines, chaos in the
  dispatcher, close without drain, metrics);
* exposition — one sequence of ``on_*`` calls with one injected clock
  gives equal snapshots in both packages; ``render_prometheus`` of one
  snapshot is the JAX text but for ``pt_build_info``;
* HTTP — both servers on ``port=0`` give the same bodies, statuses and
  NDJSON streams, but for timings and the format tag;
* the decode bundle — its prefill programs are ``transformer_lm(...,
  collect_kv=)``'s, and ``ServingEngine.load_model`` serves them within
  1e-5 of the JAX bundle's one-shot prefill (logits and every K/V).
"""

import itertools
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import io as jio
from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer as jtfm
from paddle_tpu.obs import metrics as jobs
from paddle_tpu.serving import http as jhttp
from paddle_tpu.serving import metrics as jmetrics

import paddle_tpu_torch as tpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import transformer as ttfm
from paddle_tpu_torch.obs import metrics as tobs
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import http as thttp
from paddle_tpu_torch.serving import metrics as tmetrics
from paddle_tpu_torch.serving.admission import (AdmissionController,
                                                DeadlineExceeded,
                                                InvalidRequest,
                                                ModelUnavailable,
                                                Overloaded, RequestFailed)
from paddle_tpu_torch.serving.batcher import MicroBatcher

TOL = dict(atol=1e-5, rtol=1e-5)
LM = dict(vocab_size=50, n_layers=2, d_model=32, n_heads=2, d_ff=64)
LM_SEQ, LM_BATCH = 16, 2
DEC_CFG = dict(vocab_size=43, n_layers=2, d_model=16, n_heads=2, d_ff=32,
               max_context=32)
DEC_GEOMETRY = dict(length_buckets=(8, 16), slots=3, block_size=4,
                    pool_blocks=24)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """CPU products split over threads are not bit-reproducible run to
    run; the coalescing checks compare bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# artifacts: one model, two packages, one startup state
# ---------------------------------------------------------------------------

def _static(pkg):
    x = pkg.layers.data("x", [6])
    hid = pkg.layers.fc(input=x, size=8, act="relu")
    probs = pkg.layers.fc(input=hid, size=3, act="softmax")
    return ["x"], [probs, pkg.layers.argmax(probs, axis=1)]


def _bucketed(pkg):
    x = pkg.layers.data("x", [-1, 4])
    h = pkg.layers.reduce_sum(x, dim=1)
    return ["x"], [pkg.layers.fc(input=h, size=3, act="softmax")]


def _coincide(pkg):
    x = pkg.layers.data("x", [3])
    probs = pkg.layers.fc(input=x, size=3, act="softmax")
    return ["x"], [probs, pkg.layers.reduce_sum(probs, dim=0)]


def _pinned(pkg):
    x = pkg.layers.data("x", [3])
    return ["x"], [pkg.layers.reshape(x, [2, 3])]


def _static_feed(pkg):
    x = pkg.layers.data("x", [4])
    w = pkg.layers.data("w", [4], append_batch_size=False)
    return ["x", "w"], [pkg.layers.elementwise_add(x, w)]


def _lm(pkg):
    tfm = jtfm if pkg is jpt else ttfm
    src = pkg.layers.data("src_ids", [LM_SEQ], dtype="int64")
    return ["src_ids"], [tfm.transformer_lm(src, max_len=LM_SEQ, **LM)]


def _build(pkg, define):
    pkg.core.program.reset_unique_names()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        feeds, targets = define(pkg)
    return main, startup, feeds, targets


def _export_both(root, name, define, **kw):
    """(JAX artifact dir, port artifact dir, JAX state) of one model."""
    main, startup, feeds, targets = _build(jpt, define)
    scope = jpt.Scope()
    jdir, tdir = str(root / f"{name}_jax"), str(root / f"{name}_torch")
    with jpt.scope_guard(scope):
        jpt.Executor().run(startup)
        jio.export_serving_model(jdir, feeds, targets, main_program=main,
                                 scope=scope, **kw)
    state = {v.name: np.asarray(scope.find_var(v.name))
             for v in main.list_vars() if v.persistable}
    tmain, _, tfeeds, ttargets = _build(tpt, define)
    tio.export_serving_model(tdir, tfeeds, ttargets, main_program=tmain,
                             scope=tio.scope_from_numpy(state, "cpu"), **kw)
    return jdir, tdir, state


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serving")
    return {
        "static": _export_both(root, "static", _static, batch_size=4),
        "bucketed": _export_both(root, "bucketed", _bucketed, batch_size=4,
                                 length_buckets=(4, 8)),
        "lm": _export_both(root, "lm", _lm, batch_size=LM_BATCH),
    }


@pytest.fixture(scope="module")
def decode_bundles(tmp_path_factory):
    """(JAX decode bundle, port decode bundle) of one model."""
    jpt.core.program.reset_unique_names()
    main, startup = jpt.Program(), jpt.Program()
    with jpt.program_guard(main, startup):
        jtfm.transformer_lm_loss(
            seq_len=DEC_CFG["max_context"],
            max_len=DEC_CFG["max_context"],
            **{k: DEC_CFG[k] for k in ("vocab_size", "n_layers", "d_model",
                                       "n_heads", "d_ff")})
    scope = jpt.Scope()
    root = tmp_path_factory.mktemp("torch_serving_decode")
    jdir, tdir = str(root / "jax"), str(root / "torch")
    with jpt.scope_guard(scope):
        jpt.Executor().run(startup)
        jio.export_decode_model(jdir, DEC_CFG, scope=scope, **DEC_GEOMETRY)
    params = {p.name: np.asarray(scope.find_var(p.name))
              for p in main.all_parameters()}
    tio.export_decode_model(tdir, DEC_CFG, params=params, **DEC_GEOMETRY)
    return jdir, tdir


def _meta(d):
    with open(os.path.join(d, "serving.json")) as f:
        return json.load(f)


def _first(result):
    return next(iter(result.values()))


def _engines(**kw):
    return (jserving.ServingEngine(**kw),
            tserving.ServingEngine(device="cpu", **kw))


# ---------------------------------------------------------------------------
# export metadata
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["static", "bucketed", "lm"])
def test_serving_json_is_the_jax_schema(artifacts, kind):
    """Feeds, fetch names, fetch specs (batch_major included), batch
    size, var_dims and the bucket entries but their file equal the JAX
    artifact's; the port adds its format tag and a program a bucket."""
    jdir, tdir, _ = artifacts[kind]
    jm, tm = _meta(jdir), _meta(tdir)
    assert tm["format"] == tio.FORMAT
    for key in ("feeds", "fetch_names", "fetches", "batch_size",
                "var_dims"):
        assert tm[key] == jm[key], key
    assert [dict(b, file=None) for b in jm["buckets"]] == \
        [dict(b, file=None) for b in tm["buckets"]]
    assert len(tm["programs"]) == len(tm["buckets"])
    for fn in tm["programs"]:
        assert os.path.exists(os.path.join(tdir, fn))


def test_export_records_fetch_meta(artifacts):
    meta = _meta(artifacts["static"][1])
    assert [m["dtype"] for m in meta["fetches"]] == ["float32", "int32"]
    assert [m["shape"] for m in meta["fetches"]] == [[4, 3], [4]]
    assert [m["name"] for m in meta["fetches"]] == meta["fetch_names"]


def test_bucketed_export_artifacts(artifacts):
    d = artifacts["bucketed"][1]
    meta = _meta(d)
    assert [b["length"] for b in meta["buckets"]] == [4, 8]
    for b in meta["buckets"]:
        assert b["feeds"][0]["shape"] == [4, b["length"], 4]
        assert b["fetches"][0]["shape"] == [4, 3]
    assert meta["var_dims"] == {"x": [1]}
    # the buckets share one program: the inference model of the dir
    assert set(meta["programs"]) == {tio.MODEL_FILENAME}
    predict, feeds, fetches = tio.load_serving_model(d, device="cpu")
    assert (feeds, fetches) == (["x"], meta["fetch_names"])
    assert predict(np.zeros((4, 8, 4), np.float32))[0].shape == (4, 3)


def test_non_batch_major_fetch_replicated(tmp_path):
    """A fetch whose leading dim merely COINCIDES with the batch size is
    replicated to every request, not scattered row by row, as in the JAX
    engine (batch_major from a run at batch + 1)."""
    jdir, tdir, _ = _export_both(tmp_path, "coincide", _coincide,
                                 batch_size=3)
    assert _meta(tdir)["fetches"] == _meta(jdir)["fetches"]
    assert [m["batch_major"] for m in _meta(tdir)["fetches"]] == \
        [True, False]
    predict, _, _ = tio.load_serving_model(tdir, device="cpu")
    row = np.arange(3, dtype=np.float32)
    pad = np.zeros((3, 3), np.float32)
    pad[0] = row
    ref = predict(pad)
    engine = tserving.ServingEngine(device="cpu", max_batch_size=1,
                                    max_wait_ms=0.0)
    engine.load_model("m", tdir)
    try:
        out = list(engine.predict("m", {"x": row}, timeout=30).values())
    finally:
        engine.shutdown()
    np.testing.assert_array_equal(out[0], ref[0][0])
    assert out[1].shape == (3,)
    np.testing.assert_array_equal(out[1], ref[1])


def test_batch_pinned_coincident_fetch_refused(tmp_path):
    """A program that cannot run at batch + 1 (a shape error) leaves no
    ground truth for a fetch whose leading dim equals the batch size:
    the port refuses the export rather than guess batch-major."""
    main, _, feeds, targets = _build(tpt, _pinned)
    with pytest.raises(ValueError, match="does not run at batch 3"):
        tio.export_serving_model(str(tmp_path / "pinned"), feeds, targets,
                                 main_program=main,
                                 scope=tio.scope_from_numpy({}, "cpu"),
                                 batch_size=2)


def test_export_raises_a_program_error(tmp_path, monkeypatch):
    """An error of the program's own at batch + 1 that is not a shape
    error is raised, not taken for a pinned batch."""
    real = tio.build_step_fn

    def build(program, feed_names, *a, **kw):
        step, rest = real(program, feed_names, *a, **kw)

        def run(state, feeds, gen):
            if feeds["x"].shape[0] == 5:
                raise KeyError("a fault at batch 5")
            return step(state, feeds, gen)
        return run, rest

    monkeypatch.setattr(tio, "build_step_fn", build)
    main, _, feeds, targets = _build(tpt, _static)
    scope = tio.scope_from_numpy(
        {v.name: np.zeros(v.shape, np.float32)
         for v in main.list_vars() if v.persistable}, "cpu")
    with pytest.raises(KeyError, match="a fault at batch 5"):
        tio.export_serving_model(str(tmp_path / "fault"), feeds, targets,
                                 main_program=main, scope=scope,
                                 batch_size=4)


def test_static_feed_artifact_refused_at_load(tmp_path):
    """A feed without a batch axis cannot be coalesced: the engine
    refuses the artifact at load; load_serving_model serves it."""
    jdir, tdir, _ = _export_both(tmp_path, "static_feed", _static_feed,
                                 batch_size=2)
    assert [m["batch_major"] for m in _meta(tdir)["feeds"]] == [True, False]
    assert _meta(tdir)["feeds"] == _meta(jdir)["feeds"]
    engine = tserving.ServingEngine(device="cpu")
    try:
        with pytest.raises(ValueError, match="batch-major"):
            engine.load_model("m", tdir)
    finally:
        engine.shutdown()
    predict, _, _ = tio.load_serving_model(tdir, device="cpu")
    xv, wv = np.ones((2, 4), np.float32), np.arange(4, dtype=np.float32)
    np.testing.assert_allclose(predict(xv, wv)[0], xv + wv)


def test_jax_artifact_refused(artifacts):
    """A StableHLO artifact handed to the port raises, naming both
    formats."""
    jdir = artifacts["static"][0]
    engine = tserving.ServingEngine(device="cpu")
    try:
        for load in (lambda: tio.load_serving_model(jdir, device="cpu"),
                     lambda: engine.load_model("m", jdir)):
            with pytest.raises(ValueError) as ei:
                load()
            assert tio.FORMAT in str(ei.value)
            assert "StableHLO" in str(ei.value)
    finally:
        engine.shutdown()


def test_engine_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserving.ServingEngine()


def test_load_inference_model_of_a_jax_dir(artifacts, tmp_path):
    """A directory the JAX save_inference_model wrote (__model__.json and
    one .npy a var) loads into the port and runs through its Executor
    within 1e-5 of the JAX run; the port writes the same program dict."""
    main, startup, feeds, targets = _build(jpt, _static)
    scope, d = jpt.Scope(), str(tmp_path / "infer_jax")
    x = np.random.RandomState(3).rand(5, 6).astype(np.float32)
    with jpt.scope_guard(scope):
        exe = jpt.Executor()
        exe.run(startup)
        jio.save_inference_model(d, feeds, targets, exe, main_program=main)
        jprog, jfeeds, jfetch = jio.load_inference_model(d, exe)
        want = exe.run(jprog, feed={"x": x}, fetch_list=jfetch)
    texe, tscope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    prog, tfeeds, tfetch = tio.load_inference_model(d, texe, scope=tscope)
    assert tfeeds == jfeeds == ["x"]
    got = texe.run(prog, feed={"x": x}, fetch_list=tfetch, scope=tscope)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **TOL)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    tmain, _, tf, tt = _build(tpt, _static)
    td = str(tmp_path / "infer_torch")
    tio.save_inference_model(td, tf, tt, texe, main_program=tmain,
                             scope=tscope)
    with open(os.path.join(d, "__model__.json")) as f:
        jmodel = json.load(f)
    with open(os.path.join(td, "__model__.json")) as f:
        assert json.load(f) == jmodel


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _requests(kind, n, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "static":
        return [{"x": rng.rand(6).astype(np.float32)} for _ in range(n)]
    if kind == "bucketed":
        return [{"x": rng.rand(rng.randint(1, 9), 4).astype(np.float32)}
                for _ in range(n)]
    return [{"src_ids": rng.randint(0, LM["vocab_size"], LM_SEQ)
             .astype(np.int64)} for _ in range(n)]


@pytest.mark.parametrize("kind", ["static", "bucketed", "lm"])
def test_engine_matches_jax(artifacts, kind):
    jdir, tdir, _ = artifacts[kind]
    jeng, teng = _engines(max_wait_ms=10.0)
    jeng.load_model("m", jdir)
    teng.load_model("m", tdir)
    try:
        reqs = _requests(kind, 9)
        jfuts = [jeng.submit("m", r) for r in reqs]
        tfuts = [teng.submit("m", r) for r in reqs]
        for jf, tf in zip(jfuts, tfuts):
            want, got = jf.result(timeout=60), tf.result(timeout=60)
            assert list(got) == list(want)
            for name, w in want.items():
                g = got[name]
                assert g.dtype == w.dtype and g.shape == w.shape, name
                if np.issubdtype(w.dtype, np.integer):
                    np.testing.assert_array_equal(g, w)
                else:
                    np.testing.assert_allclose(g, w, **TOL)
        assert teng.models()["m"] == dict(jeng.models()["m"],
                                          model_dir=tdir)
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_batch_coalescing_bit_identical(artifacts):
    tdir = artifacts["bucketed"][1]
    rng = np.random.RandomState(0)
    examples = [rng.rand(n, 4).astype("float32")
                for n in (3, 4, 6, 8, 2, 5, 1, 7)]
    batched = tserving.ServingEngine(device="cpu", max_wait_ms=20.0)
    batched.load_model("m", tdir)
    seq = tserving.ServingEngine(device="cpu", max_batch_size=1,
                                 max_wait_ms=0.0)
    seq.load_model("m", tdir)
    try:
        futs = [batched.submit("m", {"x": e}) for e in examples]
        got = [_first(f.result(timeout=60)) for f in futs]
        want = [_first(seq.predict("m", {"x": e}, timeout=60))
                for e in examples]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
        assert batched.metrics_snapshot()["models"]["m"]["batches"] < 8
    finally:
        batched.shutdown()
        seq.shutdown()


def test_bucket_padding_never_leaks(artifacts):
    rng = np.random.RandomState(7)
    a = rng.rand(3, 4).astype("float32")
    engine = tserving.ServingEngine(device="cpu", max_wait_ms=20.0)
    engine.load_model("m", artifacts["bucketed"][1])
    try:
        alone = _first(engine.predict("m", {"x": a}, timeout=60))
        for _ in range(3):
            others = [rng.rand(n, 4).astype("float32") for n in (4, 2, 8, 6)]
            futs = [engine.submit("m", {"x": e}) for e in [a] + others]
            with_tenants = _first(futs[0].result(timeout=60))
            [f.result(timeout=60) for f in futs[1:]]
            assert with_tenants.tobytes() == alone.tobytes()
    finally:
        engine.shutdown()


def test_request_validation_typed(artifacts):
    engine = tserving.ServingEngine(device="cpu")
    engine.load_model("m", artifacts["bucketed"][1])
    try:
        for bad in ({"x": np.zeros((9, 4), "float32")},    # past 8
                    {"y": np.zeros((4, 4), "float32")},    # feed name
                    {"x": np.zeros((4,), "float32")},      # rank
                    {"x": np.zeros((4, 4), "complex64")},  # dtype kind
                    {"x": np.zeros((4, 5), "float32")}):   # static dim
            with pytest.raises(InvalidRequest):
                engine.submit("m", bad)
        # int -> float32 is a same-kind widening: admitted by design
        engine.predict("m", {"x": np.zeros((4, 4), "int32")}, timeout=60)
        with pytest.raises(ModelUnavailable):
            engine.submit("nope", {"x": np.zeros((4, 4), "float32")})
    finally:
        engine.shutdown()


def test_hot_reload_drops_nothing(artifacts):
    tdir = artifacts["bucketed"][1]
    engine = tserving.ServingEngine(device="cpu", max_wait_ms=2.0)
    assert engine.load_model("m", tdir) == 1
    stop = threading.Event()
    errors, completed = [], [0]

    def client(seed):
        rng = np.random.RandomState(seed)
        while not stop.is_set():
            try:
                r = engine.predict(
                    "m", {"x": rng.rand(rng.randint(1, 9),
                                        4).astype("float32")}, timeout=60)
                assert _first(r).shape == (3,)
                completed[0] += 1
            except Exception as e:  # noqa: BLE001 — the assertion target
                errors.append(repr(e))
                return

    threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.2)
        for _ in range(3):                      # three reloads under fire
            assert engine.load_model("m", tdir) > 1
            time.sleep(0.1)
    finally:
        stop.set()
        for t in threads:
            t.join()
        engine.shutdown()
    assert errors == [] and completed[0] > 0
    snap = engine.metrics_snapshot()["models"]["m"]
    assert snap["received"] == snap["completed"]    # zero dropped
    assert snap["failed"] == 0 and snap["reloads"] == 3


def test_submit_survives_reload_race(artifacts):
    """The version a submit routed to closes under it (hot reload):
    engine.submit retries against the newly routed version."""
    tdir = artifacts["bucketed"][1]
    engine = tserving.ServingEngine(device="cpu", max_wait_ms=2.0)
    engine.load_model("m", tdir)
    stale = engine.registry.get("m")
    engine.load_model("m", tdir)                # drains + closes stale
    real_get = engine.registry.get
    raced = []

    def stale_then_real(name):
        if not raced:
            raced.append(1)
            return stale
        return real_get(name)

    engine.registry.get = stale_then_real
    try:
        out = engine.predict("m", {"x": np.ones((4, 4), np.float32)},
                             timeout=30)
        assert _first(out).shape == (3,) and raced
    finally:
        engine.registry.get = real_get
        engine.shutdown()


# ---------------------------------------------------------------------------
# unit plane: a model stub under the port's MicroBatcher
# ---------------------------------------------------------------------------

class StubModel:
    """batch_size-4 'model' whose executor doubles x and can be blocked
    on an Event to hold the dispatcher mid-batch deterministically."""

    batch_size = 4

    def __init__(self, gate: threading.Event = None):
        self.gate = gate
        self.batches = []

    def bucket_of(self, feeds):
        if "x" not in feeds:
            raise InvalidRequest("stub wants feed 'x'")
        return None

    def execute_batch(self, bucket, examples, timer=None):
        if self.gate is not None:
            self.gate.wait(10.0)
        self.batches.append(len(examples))
        out = [{"y": np.asarray(e["x"], dtype=np.float64) * 2.0}
               for e in examples]
        return out, {"pad": 0.0, "device": 0.0, "scatter": 0.0}


def _stub_batcher(gate=None, queue_depth=64, max_wait_ms=1.0):
    model = StubModel(gate)
    admission = AdmissionController(queue_depth=queue_depth,
                                    max_batch_size=model.batch_size)
    batcher = MicroBatcher(model, max_wait_ms=max_wait_ms,
                           admission=admission,
                           metrics=tmetrics.ModelMetrics("stub"),
                           name="stub")
    return model, batcher


def _wait_dispatched(batcher):
    deadline = time.monotonic() + 5.0
    while batcher.queued() > 0 and time.monotonic() < deadline:
        time.sleep(0.001)


def test_overload_sheds_fast_and_typed():
    gate = threading.Event()
    model, batcher = _stub_batcher(gate=gate, queue_depth=2,
                                   max_wait_ms=0.0)
    try:
        first = batcher.submit({"x": np.float32(1)})
        _wait_dispatched(batcher)
        q1 = batcher.submit({"x": np.float32(2)})
        q2 = batcher.submit({"x": np.float32(3)})
        t0 = time.monotonic()
        with pytest.raises(Overloaded):
            batcher.submit({"x": np.float32(4)})
        assert time.monotonic() - t0 < 0.5      # rejected FAST, not queued
        gate.set()
        for f, x in ((first, 1.0), (q1, 2.0), (q2, 3.0)):
            assert float(f.result(timeout=10)["y"]) == 2.0 * x
        snap = batcher.metrics.snapshot()
        assert snap["shed_overload"] == 1 and snap["completed"] == 3
    finally:
        gate.set()
        batcher.close()


def test_deadline_expired_in_queue_is_typed():
    gate = threading.Event()
    model, batcher = _stub_batcher(gate=gate, max_wait_ms=0.0)
    try:
        blocker = batcher.submit({"x": np.float32(0)})
        _wait_dispatched(batcher)
        doomed = batcher.submit({"x": np.float32(1)}, deadline_ms=20.0)
        time.sleep(0.05)                         # let the deadline lapse
        gate.set()
        assert float(blocker.result(timeout=10)["y"]) == 0.0
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=10)
        assert batcher.metrics.snapshot()["shed_deadline"] == 1
    finally:
        gate.set()
        batcher.close()


def test_deadline_aware_admission_sheds_before_queueing():
    gate = threading.Event()
    model, batcher = _stub_batcher(gate=gate, max_wait_ms=0.0)
    try:
        batcher.admission.observe_batch(0.5)     # est: 500 ms per batch
        batcher.submit({"x": np.float32(0)})     # something queued ahead
        with pytest.raises(DeadlineExceeded):
            batcher.submit({"x": np.float32(1)}, deadline_ms=5.0)
    finally:
        gate.set()
        batcher.close()


def test_dispatcher_chaos_recovers(monkeypatch):
    """serve_dispatch@1: the first flushed batch dies inside the
    dispatcher loop — its request gets a typed error carrying the
    injected fault as __cause__, and the loop keeps serving."""
    monkeypatch.setenv("PT_FAULT_INJECT", "serve_dispatch@1")
    faults.reset()
    model, batcher = _stub_batcher(max_wait_ms=0.0)
    try:
        doomed = batcher.submit({"x": np.float32(1)})
        with pytest.raises(RequestFailed) as ei:
            doomed.result(timeout=10)
        assert isinstance(ei.value.__cause__, faults.FaultInjected)
        assert ei.value.__cause__.site == "serve_dispatch"
        ok = batcher.submit({"x": np.float32(2)})
        assert float(ok.result(timeout=10)["y"]) == 4.0
        snap = batcher.metrics.snapshot()
        assert snap["failed"] == 1 and snap["completed"] == 1
    finally:
        batcher.close()
        faults.reset()


def test_close_without_drain_fails_backlog_typed():
    gate = threading.Event()
    model, batcher = _stub_batcher(gate=gate, max_wait_ms=0.0)
    blocker = batcher.submit({"x": np.float32(0)})
    _wait_dispatched(batcher)
    queued = batcher.submit({"x": np.float32(1)})
    gate.set()
    batcher.close(drain=False)
    blocker.result(timeout=10)
    with pytest.raises(ModelUnavailable):
        queued.result(timeout=10)
    with pytest.raises(ModelUnavailable):
        batcher.submit({"x": np.float32(2)})


def test_metrics_snapshot_consistent():
    model, batcher = _stub_batcher(max_wait_ms=1.0)
    try:
        futs = [batcher.submit({"x": np.float32(i)}) for i in range(10)]
        for f in futs:
            f.result(timeout=10)
        snap = batcher.metrics.snapshot()
        assert snap["received"] == 10 and snap["failed"] == 0
        assert snap["completed"] == 10
        assert snap["batches"] == len(model.batches)
        assert sum(model.batches) == 10
        assert snap["batch_fill_ratio"] == pytest.approx(
            10 / (len(model.batches) * 4), abs=1e-4)
        assert snap["qps"] > 0
        for phase in ("queue", "pad", "device", "scatter", "total"):
            assert set(snap["latency"][phase]) == {"p50_ms", "p95_ms",
                                                   "p99_ms"}
        assert snap["latency"]["total"]["p50_ms"] is not None
        assert snap["phases"]["batches"] == snap["batches"]
    finally:
        batcher.close()


def test_load_model_object_serves_a_stub():
    engine = tserving.ServingEngine(device="cpu", max_wait_ms=0.0)
    try:
        assert engine.load_model_object("stub", StubModel()) == 1
        assert engine.load_model_object("stub", StubModel()) == 2
        assert float(engine.predict("stub", {"x": np.float32(3)},
                                    timeout=10)["y"]) == 6.0
        desc = engine.models()["stub"]
        assert desc["version"] == 2 and desc["batch_size"] == 4
        assert engine.metrics_snapshot()["models"]["stub"]["reloads"] == 1
    finally:
        engine.shutdown()
    with pytest.raises(ModelUnavailable):
        engine.submit("stub", {"x": np.float32(1)})


def test_serving_phase_timer_axes():
    t = tmetrics.ServingPhaseTimer()
    with t.span("pad"):
        pass
    t.count_run()
    snap = t.snapshot(reset=True)
    assert set(snap) == {"queue_s", "pad_s", "device_s", "scatter_s",
                         "batches"}
    assert snap["batches"] == 1 and t.snapshot()["batches"] == 0


# ---------------------------------------------------------------------------
# metrics and the Prometheus exposition against the JAX package
# ---------------------------------------------------------------------------

def _drive(mod):
    """One sequence of events into a ServingMetrics of `mod`, on a clock
    that advances 0.25 s a read."""
    clock = itertools.count(100.0, 0.25)
    sm = mod.ServingMetrics(clock=lambda: next(clock))
    m = sm.model("ranker")
    for depth in (1, 2, 3):
        m.on_received(depth)
    m.on_shed("overload")
    m.on_shed("deadline")
    m.on_batch(2, 4)
    for i in range(5):
        m.on_done(True, 1, phase_s={"queue": 0.001 * i, "pad": 0.0005,
                                    "device": 0.003 + 1e-4 * i,
                                    "scatter": 0.0001},
                  total_s=0.005 + 1e-3 * i)
    m.on_done(False, 0)
    m.on_reload()
    m.timer.add("pad", 0.0005)
    m.timer.add("device", 0.003)
    m.timer.count_run()
    d = sm.decode("lm")
    d.on_received()
    d.on_prefill(12, 0.01)
    d.on_step(3, 8, 0.004, 3)
    d.on_prefix_hit(8, 2)
    d.on_cow()
    d.on_spec(3, 2)
    d.on_spec_fallback()
    d.on_evicted()
    d.on_resumed()
    d.on_finished(True)
    d.on_shed("overload")
    d.set_gauges(active=1, waiting=2, blocks_in_use=5, blocks_capacity=63,
                 high_water=7, blocks_shared=1, blocks_indexed=2)
    return sm.snapshot(merge_registry=False)


def test_serving_metrics_snapshot_matches_jax():
    assert _drive(tmetrics) == _drive(jmetrics)


def test_snapshot_merges_the_registry():
    class Provider:
        def snapshot(self):
            return {"name": "t0", "steps": 3, "loss": 0.5}

    p = Provider()
    tobs.REGISTRY.register("train", "t0", p)
    try:
        snap = tmetrics.ServingMetrics().snapshot()
        assert snap["train"] == {"t0": p.snapshot()}
        assert tobs.global_snapshot()["train"] == {"t0": p.snapshot()}
    finally:
        tobs.REGISTRY.unregister("train", "t0")
    assert "train" not in tmetrics.ServingMetrics().snapshot()
    assert tmetrics.percentiles is tobs.percentiles


def _every_family(snap):
    """A snapshot with every section render_prometheus reads."""
    return dict(
        snap,
        fleet={"f": {"name": "f", "replicas": 2, "completed": 5,
                     "failed": 0, "failovers": 1, "rebuilds": 0,
                     "dispatched": {"p2c": 5}, "sheds": {"1": 2},
                     "sheds_deadline": {"0": 1},
                     "scale_events": {"up": 1}, "queue_depths": {"0": 3},
                     "replica_health": {"r0": {"queue_depth": 1,
                                               "ewma_ms": 2.5,
                                               "healthy": True}}}},
        data={"pipe": {"batches": 4, "samples": 16, "batches_per_sec": 2.0,
                       "workers": 2, "stages": {"map": {"busy_s": 0.5,
                                                        "occupancy": 0.25}}}},
        train={"t\"0\n": {"steps": 3, "loss": 0.5, "grad_norm": None,
                          "step_time": {"p50_ms": 1.5, "p95_ms": 2.0}}},
        model={"prog": {"predicted_step_ms": 2.0, "steps": 4,
                        "bound": "compute"}},
        op={"prog": {"coverage_pct": 90.0, "top_ops": [
            {"name": "mul_0", "type": "mul", "measured_ms": 1.0,
             "share_pct": 50.0}]}},
        calib={"t": {"replans": 1, "drift_streak": 2,
                     "calibration_version": "abc"}},
        elastic={"e": {"name": "e", "restarts": 1, "downtime_s": 0.5,
                       "restarts_by_site": {"step": 1}}},
        orch={"o": {"name": "o", "workers_live": 3, "lease_age_max_s": 0.1,
                    "evictions_by_cause": {"worker_crash": 1}}})


def _drop_build_info(text):
    return [ln for ln in text.splitlines() if "pt_build_info" not in ln]


def test_render_prometheus_matches_jax():
    snap = _every_family(_drive(tmetrics))
    tt, jt = tobs.render_prometheus(snap), jobs.render_prometheus(snap)
    assert _drop_build_info(tt) == _drop_build_info(jt)
    assert tmetrics.render_prometheus is tobs.render_prometheus
    assert tobs.validate_exposition(tt) == []
    assert jobs.validate_exposition(tt) == []
    info = [ln for ln in tt.splitlines()
            if ln.startswith("pt_build_info{")]
    assert len(info) == 1 and f'torch="{torch.__version__}"' in info[0]


@pytest.mark.parametrize("text", [
    "pt_x 1\n",                                         # no TYPE
    "# TYPE pt_x gauge\npt_x{a=\"b} 1\n",               # unterminated
    "# TYPE pt_x gauge\npt_x{a=\"b\"} one\n",           # non-numeric
    "# TYPE pt_x gauge\npt_x{a=\"1\"} 1\npt_x{a=\"1\"} 2\n",  # duplicate
    "# TYPE pt_x gauges\n# TYPE pt_x gauge\n",          # bad, dup TYPE
    "# TYPE pt_x gauge\npt_x{a=b} 1\n",                 # unquoted label
])
def test_validate_exposition_matches_jax(text):
    assert tobs.validate_exposition(text) == jobs.validate_exposition(text)
    assert tobs.validate_exposition(text)


def test_build_info_labels(monkeypatch):
    labels = tobs.build_info_labels()
    assert set(labels) == {"torch", "chip", "knobs", "calibration"}
    assert labels["torch"] == torch.__version__
    want = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")
    assert labels["chip"] == want
    monkeypatch.setenv("PT_COST_CHIP", "h100")
    assert tobs.build_info_labels()["chip"] == "h100"


# ---------------------------------------------------------------------------
# HTTP: both front ends on port 0
# ---------------------------------------------------------------------------

def _call(url, payload=None, raw=None):
    """(status, body bytes) of a GET (payload None) or a JSON POST."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"},
        method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def servers(artifacts, decode_bundles):
    """{"jax": base url, "torch": base url} of two front ends over one
    model: the static classifier as "clf" and the decode bundle as
    "lm"."""
    jeng, teng = _engines(max_wait_ms=5.0)
    jeng.load_model("clf", artifacts["static"][0])
    teng.load_model("clf", artifacts["static"][1])
    jeng.load_decode_model("lm", decode_bundles[0], warmup=False)
    teng.load_decode_model("lm", decode_bundles[1], warmup=False)
    out, started = {}, []
    for name, mod, eng in (("jax", jhttp, jeng), ("torch", thttp, teng)):
        server, _ = mod.start_http_server(eng, port=0)
        started.append((server, eng))
        out[name] = f"http://127.0.0.1:{server.server_address[1]}"
    out["engines"] = {"jax": jeng, "torch": teng}
    yield out
    for server, eng in started:
        server.shutdown()
        server.server_close()
        eng.shutdown()


def _both(servers, path, payload=None, raw=None):
    return {k: _call(servers[k] + path, payload, raw)
            for k in ("jax", "torch")}


def test_http_predict_matches_jax(servers):
    x = (np.arange(6) % 5 * 0.25).astype("float32")
    res = _both(servers, "/v1/models/clf:predict",
                {"feeds": {"x": x.tolist()}})
    (js, jb), (ts, tb) = res["jax"], res["torch"]
    assert js == ts == 200
    jb, tb = json.loads(jb), json.loads(tb)
    assert tb["model_version"] == jb["model_version"] == 1
    assert list(tb["fetches"]) == list(jb["fetches"])
    for name, want in jb["fetches"].items():
        got = tb["fetches"][name]
        assert (got["shape"], got["dtype"]) == (want["shape"],
                                                want["dtype"])
        np.testing.assert_allclose(got["data"], want["data"], **TOL)


@pytest.mark.parametrize("path,payload,raw", [
    ("/v1/models/ghost:predict", {"feeds": {"x": [0.0] * 6}}, None),
    ("/v1/models/clf:predict", {"nope": 1}, None),
    ("/v1/models/clf:predict", {"feeds": {"x": [0.0] * 5}}, None),
    ("/v1/models/clf:predict", {"feeds": {"x": [[0.0] * 6]}}, None),
    ("/v1/models/clf:predict", None, b"{not json"),
    ("/v1/models/clf:predict", None, b"[1, 2]"),
    ("/v1/models/clf:reload", {}, None),
    ("/v1/models/ghost:generate", {"prompt_ids": [1, 2]}, None),
    ("/v1/models/lm:generate", {"prompt_ids": []}, None),
    ("/v1/models/lm:generate", {"prompt_ids": [1] * 40}, None),
    ("/v1/nothing", {}, None),
    ("/v1/fleet", None, None),
    ("/v1/nothing", None, None),
])
def test_http_typed_errors_match_jax(servers, path, payload, raw):
    res = _both(servers, path, payload, raw)
    (js, jb), (ts, tb) = res["jax"], res["torch"]
    assert ts == js and ts >= 400
    assert json.loads(tb)["error"] == json.loads(jb)["error"]


def test_http_models_metrics_and_reload(servers, artifacts):
    res = _both(servers, "/v1/models")
    jm, tm = (json.loads(res[k][1])["models"] for k in ("jax", "torch"))
    for m in (jm, tm):
        m["clf"].pop("model_dir")
        m["lm"]["decode"].pop("model_dir")
        m["lm"]["decode"].pop("device", None)
    assert tm == jm
    res = _both(servers, "/v1/metrics")
    js, ts = (json.loads(res[k][1]) for k in ("jax", "torch"))
    # the JAX process registry may carry other planes' sections
    assert set(ts) == {"models", "decode"} <= set(js)
    assert set(ts["models"]["clf"]) == set(js["models"]["clf"])
    assert set(ts["decode"]["lm"]) == set(js["decode"]["lm"])
    for path in ("/metrics?format=prometheus",
                 "/v1/metrics?format=prometheus"):
        res = _both(servers, path)
        texts = {k: res[k][1].decode() for k in ("jax", "torch")}
        assert res["torch"][0] == 200
        assert tobs.validate_exposition(texts["torch"]) == []

        def series(text):
            return {re.sub(r"\} .*", "}", ln) for ln in text.splitlines()
                    if ln.startswith(("pt_serve_", "pt_decode_", "pt_kv_",
                                      "pt_spec_"))}

        assert series(texts["torch"]) == series(texts["jax"])
    res = {k: _call(servers[k] + "/v1/models/clf:reload",
                    {"model_dir": artifacts["static"][i]})
           for i, k in enumerate(("jax", "torch"))}
    assert res["torch"][0] == res["jax"][0] == 200
    assert json.loads(res["torch"][1]) == json.loads(res["jax"][1]) == \
        {"model": "clf", "version": 2}


@pytest.mark.parametrize("stream", [True, False])
def test_http_generate_matches_jax(servers, stream):
    res = _both(servers, "/v1/models/lm:generate",
                {"prompt_ids": [5, 6, 7, 8, 9], "max_new_tokens": 6,
                 "stream": stream})
    (js, jb), (ts, tb) = res["jax"], res["torch"]
    assert js == ts == 200
    jl = [json.loads(ln) for ln in jb.decode().splitlines()]
    tl = [json.loads(ln) for ln in tb.decode().splitlines()]
    assert tl == jl
    final = tl[-1]
    assert len(final["tokens"]) == 6 and final["finish_reason"] == "length"
    if stream:
        assert [d["token"] for d in tl[:-1]] == final["tokens"]
        assert final["done"] is True


# ---------------------------------------------------------------------------
# the decode bundle's prefill: transformer_lm(collect_kv=) programs
# ---------------------------------------------------------------------------

def _collect(pkg, tfm, bound):
    pkg.core.program.reset_unique_names()
    main, kvs = pkg.Program(), []
    with pkg.program_guard(main, pkg.Program()):
        src = pkg.layers.data("src_ids", [bound], dtype="int64")
        logits = tfm.transformer_lm(
            src, DEC_CFG["vocab_size"], n_layers=DEC_CFG["n_layers"],
            d_model=DEC_CFG["d_model"], n_heads=DEC_CFG["n_heads"],
            d_ff=DEC_CFG["d_ff"], max_len=DEC_CFG["max_context"],
            pos_table_len=DEC_CFG["max_context"], collect_kv=kvs)
    return main, logits, kvs


def test_collect_kv_appends_the_jax_names_and_shapes():
    jmain, jl, jkv = _collect(jpt, jtfm, 8)
    tmain, tl, tkv = _collect(tpt, ttfm, 8)
    assert len(tkv) == DEC_CFG["n_layers"]
    head = DEC_CFG["d_model"] // DEC_CFG["n_heads"]
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        assert (tk.name, tv.name) == (jk.name, jv.name)
        assert tk.shape == tv.shape == tuple(jk.shape) == \
            (-1, 8, DEC_CFG["n_heads"], head)
    assert tl.name == jl.name
    assert [o.type for o in tmain.global_block.ops] == \
        [o.type for o in jmain.global_block.ops]


def test_decode_prefill_programs_are_transformer_lm(decode_bundles):
    """Each bucket's program file is the prefill program the JAX
    transformer_lm builds (the same ops and vars), pruned to the logits
    and every K/V."""
    meta = _meta(decode_bundles[1])
    for bucket, fn in zip(meta["buckets"], meta["programs"]):
        main, logits, kvs = _collect(jpt, jtfm, bucket["length"])
        targets = [logits.name] + [n for k, v in kvs
                                   for n in (k.name, v.name)]
        want = main.clone(for_test=True).prune(targets=targets,
                                               feeds=["src_ids"])
        with open(os.path.join(decode_bundles[1], fn)) as f:
            got = json.load(f)
        assert got["fetch_names"] == targets
        assert got["program"] == want.to_dict()


@pytest.mark.parametrize("n", [3, 8, 13])
def test_decode_bundle_served_by_load_model_matches_jax(decode_bundles, n):
    """ServingEngine.load_model serves a decode bundle's prefill side
    unchanged: logits and every K/V within 1e-5 of the JAX bundle's."""
    jeng, teng = _engines(max_wait_ms=0.0)
    jeng.load_model("p", decode_bundles[0], warmup=False)
    teng.load_model("p", decode_bundles[1], warmup=False)
    ids = np.random.RandomState(n).randint(1, DEC_CFG["vocab_size"], n)
    try:
        want = jeng.predict("p", {"src_ids": ids}, timeout=60)
        got = teng.predict("p", {"src_ids": ids}, timeout=60)
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert list(got) == list(want) == _meta(decode_bundles[1])["fetch_names"]
    for name, w in want.items():
        np.testing.assert_allclose(got[name], np.asarray(w), **TOL,
                                   err_msg=name)


def test_decode_facade_matches_jax(decode_bundles):
    """load_decode_model + generate through both engines: the same
    tokens."""
    jeng, teng = _engines()
    try:
        out = []
        for eng, d in ((jeng, decode_bundles[0]), (teng, decode_bundles[1])):
            eng.load_decode_model("lm", d, warmup=False)
            hs = [eng.generate("lm", p, max_new_tokens=5)
                  for p in ([1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12])]
            out.append([h.result(timeout=120) for h in hs])
        assert out[1] == out[0]
        assert teng.models()["lm"]["decode"]["device"] == "cpu"
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_port_imports_no_jax():
    root = os.path.join(os.path.dirname(__file__), "..")
    pat = re.compile(r"^\s*(import jax|from jax|import paddle_tpu\b|"
                     r"from paddle_tpu\b[^_])", re.M)
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "paddle_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    hits = [f for f in files if pat.search(open(f).read())]
    assert hits == []
