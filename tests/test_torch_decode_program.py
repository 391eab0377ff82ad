"""The decode step as a program, and bfloat16 decode through
``Float16Transpiler``, against the JAX package on the CPU.

The same calls build ``transformer_decode_step`` in both packages (2
layers, d_model 64, 2 heads of 32, d_ff 128, vocab 50, context 32, 3
slots, 4-token blocks, 20 pool blocks); the JAX startup state goes into
the port's Scope by name and both run STEPS decode steps on feeds made
from a numpy seed (ragged lengths, an idle slot, random pools), each
step fed the pools the last one wrote. What is held:

* the ops the step adds: ``unsqueeze`` and ``gather`` against the JAX
  ops exactly; the registered ``paged_kv_write`` and ``paged_attention``
  against the JAX ops in float32 (the pools exactly, the output within
  TOL) and in bfloat16 (the pools exactly, the output within 2^-7
  max|jax| + 2^-7 |jax|), their vars' shapes and dtypes as the JAX
  package infers them;
* float32: the logits and every written pool of every step within
  atol = rtol = 1e-4 (TOL; two frameworks' float32 sums: the largest
  reading is 2e-6); the pools are written in place, and the fetched pools
  are the fed tensors;
* bfloat16 (both programs transpiled by their ``Float16Transpiler``):
  the port's logits and pools over all steps within 2x the JAX
  package's own bfloat16-vs-float32 distance (relative rms; the readings
  are 1.07x and 0.84x), and a step whose pool write is skipped (a
  planted fault) failing that limit (86x); bfloat16 pools are written
  in place, float32 ones cast at the step's entry and written in that
  copy;
* ``Float16Transpiler`` on tests/test_inference_deploy.py's program
  (conv2d, batch_norm in test mode, fc + softmax): the vars it casts and
  keeps are the JAX transpiler's, the Scope's values bfloat16 (the
  statistics float32), the predictions within 2x the JAX package's own
  bf16-vs-float32 distance of the JAX transpiled program's and within
  the JAX test's 2e-2 of float32; its refusals;
* the bundle's step program: it shares the prefill's weight tensors, a
  bundle without it is refused, and two DecodeModels stepping from two
  threads give the logits and pools of one thread.
"""

import os
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jpt
from paddle_tpu.models import transformer as jtfm
from paddle_tpu.ops import attention_ops as jattn
from paddle_tpu.ops import tensor_ops as jtensor
from paddle_tpu.transpiler.inference_transpiler import (
    Float16Transpiler as JFloat16Transpiler)

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import ExecContext, require_op
from paddle_tpu_torch.models import transformer as ttfm
from paddle_tpu_torch.ops import attention_ops as tattn
from paddle_tpu_torch.serving.decode import DecodeModel
from paddle_tpu_torch.transpiler import Float16Transpiler

torch.set_num_threads(2)

V, L, DM, H, FF, MAXC = 50, 2, 64, 2, 128, 32
BS, NB, SLOTS = 4, 20, 3
MB = MAXC // BS
GEO = dict(n_layers=L, d_model=DM, n_heads=H, d_ff=FF, max_context=MAXC,
           slots=SLOTS, block_size=BS, pool_blocks=NB,
           max_blocks_per_seq=MB)
STEPS = 4
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 2.0 ** -7
SPREAD = 2.0     # the port's bf16 distance over the JAX package's own


def _rrms(got, want) -> float:
    got = np.stack([np.asarray(g, np.float64) for g in got])
    want = np.stack([np.asarray(w, np.float64) for w in want])
    return float(np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))


def _bf16_np(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _bf16_share(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    lim = BF16_REL * np.abs(want).max() + BF16_REL * np.abs(want)
    return float((np.abs(got - want) / np.maximum(lim, 1e-30)).max())


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

def _run_op(op_type, ins, attrs=None):
    ctx = ExecContext(None, torch.device("cpu"))
    return require_op(op_type).compute(ctx, ins, attrs or {})


@pytest.mark.parametrize("axes,shape", [([1], (4, 6)), ([0, 2], (3, 5)),
                                         ([2], (2, 3, 4))])
def test_unsqueeze_matches_jax(axes, shape):
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    want = np.asarray(jtensor.unsqueeze(None, {"X": [jnp.asarray(x)]},
                                        {"axes": axes})["Out"][0])
    got = _run_op("unsqueeze", {"X": [torch.from_numpy(x)]},
                  {"axes": axes})["Out"][0]
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("index", [[3, 0, 3, 7], [[1], [5]], [0]])
def test_gather_matches_jax(index):
    x = np.random.RandomState(1).randn(8, 5).astype(np.float32)
    idx = np.asarray(index, np.int32)
    want = np.asarray(jtensor.gather(None, {"X": [jnp.asarray(x)],
                                            "Index": [jnp.asarray(idx)]},
                                     {})["Out"][0])
    got = _run_op("gather", {"X": [torch.from_numpy(x)],
                             "Index": [torch.from_numpy(idx)]})["Out"][0]
    np.testing.assert_array_equal(got.numpy(), want)


def _layer_vars(pkg, dtype):
    """{role: (shape, dtype)} of the vars the layers declare: the paged
    pair over data vars of `dtype`, unsqueeze and gather."""
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        data = pkg.layers.data
        kp = data("kp", [NB, BS, H, 8], dtype=dtype, append_batch_size=False)
        vp = data("vp", [NB, BS, H, 8], dtype=dtype, append_batch_size=False)
        q = data("q", [SLOTS, 1, H, 8], dtype=dtype, append_batch_size=False)
        tables = data("t", [SLOTS, MB], dtype="int32",
                      append_batch_size=False)
        lens = data("l", [SLOTS], dtype="int32", append_batch_size=False)
        ko, vo = pkg.layers.paged_kv_write(kp, vp, q, q, tables, lens)
        out = pkg.layers.paged_attention(q, ko, vo, tables, lens)
        un = pkg.layers.unsqueeze(lens, [1])
        ga = pkg.layers.gather(kp, lens)
    return {role: (tuple(v.shape), v.dtype) for role, v in
            (("KOut", ko), ("VOut", vo), ("Out", out), ("unsqueeze", un),
             ("gather", ga))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_infer_the_jax_shapes(dtype):
    assert _layer_vars(pt, dtype) == _layer_vars(jpt, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_registered_paged_ops_match_jax(dtype):
    """paged_kv_write then paged_attention through the registry, on [S,
    1, H, D] rows: ragged lengths, an idle slot (which writes into the
    null block and reads zeros) and a table padded with the null
    block."""
    rng = np.random.RandomState(3)
    s, h, d, nb, bs = 4, 2, 16, 12, 4
    arrays = {"KPool": rng.randn(nb, bs, h, d),
              "VPool": rng.randn(nb, bs, h, d),
              "K": rng.randn(s, 1, h, d), "V": rng.randn(s, 1, h, d)}
    q = rng.randn(s, 1, h, d)
    tables = np.array([[2, 5, 0], [7, 0, 0], [0, 0, 0], [1, 3, 9]], np.int32)
    lens = np.array([6, 1, 0, 11], np.int32)
    conv = (_bf16_np if dtype == "bfloat16"
            else lambda a: np.asarray(a, np.float32))
    arrays = {k: conv(a) for k, a in arrays.items()}
    q = conv(q)
    jins = {k: [jnp.asarray(a)] for k, a in arrays.items()}
    jins.update(BlockTables=[jnp.asarray(tables)],
                ContextLens=[jnp.asarray(lens)])
    jw = jattn.paged_kv_write(None, jins, {})
    jout = jattn.paged_attention(None, {
        "Q": [jnp.asarray(q)], "KPool": jw["KOut"], "VPool": jw["VOut"],
        "BlockTables": jins["BlockTables"],
        "ContextLens": jins["ContextLens"]}, {})["Out"][0]

    tdt = getattr(torch, dtype)
    tins = {k: [torch.from_numpy(np.asarray(a, np.float32)).to(tdt)]
            for k, a in arrays.items()}
    tins.update(BlockTables=[torch.from_numpy(tables)],
                ContextLens=[torch.from_numpy(lens)])
    tw = _run_op("paged_kv_write", tins)
    assert tw["KOut"][0] is tins["KPool"][0], "the write is in place"
    assert tw["VOut"][0] is tins["VPool"][0]
    tout = _run_op("paged_attention", {
        "Q": [torch.from_numpy(np.asarray(q, np.float32)).to(tdt)],
        "KPool": tw["KOut"], "VPool": tw["VOut"],
        "BlockTables": tins["BlockTables"],
        "ContextLens": tins["ContextLens"]})["Out"][0]
    for slot in ("KOut", "VOut"):
        np.testing.assert_array_equal(tw[slot][0].float().numpy(),
                                      np.asarray(jw[slot][0], np.float32))
    assert tout.dtype == tdt and tout.shape == (s, 1, h, d)
    got, want = tout.float().numpy(), np.asarray(jout, np.float32)
    assert np.all(got[2] == 0)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert _bf16_share(got, want) <= 1.0


# ---------------------------------------------------------------------------
# the decode-step program
# ---------------------------------------------------------------------------

def _build(pkg, tfm):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        logits, pools, feeds = tfm.transformer_decode_step(V, **GEO)
    fetch = [logits] + [v for kv in pools for v in kv]
    return main, fetch, feeds


@pytest.fixture(scope="module")
def programs():
    """(JAX main, JAX fetches, the JAX startup state by name, port main,
    port fetches, feed names)."""
    jpt.core.program.reset_unique_names()
    jmain, startup = jpt.Program(), jpt.Program()
    with jpt.program_guard(jmain, startup):
        jlogits, jpools, feeds = jtfm.transformer_decode_step(V, **GEO)
    scope = jpt.Scope()
    with jpt.scope_guard(scope):
        jpt.Executor().run(startup)
    params = {p.name: np.asarray(scope.find_var(p.name))
              for p in jmain.all_parameters()}
    tprog.reset_unique_names()
    tmain, tfetch, tfeeds = _build(pt, ttfm)
    assert tfeeds == feeds
    return dict(jmain=jmain, jfetch=[jlogits] + [v for kv in jpools
                                                 for v in kv],
                params=params, tmain=tmain, tfetch=tfetch, feeds=feeds)


def _step_feeds():
    """STEPS feeds of the step but for the pools, and the first pools."""
    rng = np.random.RandomState(7)
    pools = [rng.randn(NB, BS, H, DM // H).astype(np.float32)
             for _ in range(2 * L)]
    tables = np.zeros((SLOTS, MB), np.int32)
    tables[0, :3] = [3, 7, 1]
    tables[2, :4] = [2, 9, 11, 5]
    lens = np.array([5, 0, 9], np.int32)
    out = []
    for _ in range(STEPS):
        lens = np.where(lens > 0, lens + 1, 0).astype(np.int32)
        out.append({"token_ids": rng.randint(0, V, SLOTS).astype(np.int64),
                    "context_lens": lens.copy(), "block_tables": tables})
    return out, pools


def _pool_names():
    return [f"{kv}_cache_{i}" for i in range(L) for kv in "kv"]


def _jax_steps(main, fetch, scope):
    feeds, pools = _step_feeds()
    exe, logits = jpt.Executor(), []
    for fd in feeds:
        fd = dict(fd, **dict(zip(_pool_names(), pools)))
        with jpt.scope_guard(scope):
            res = exe.run(main, feed=fd, fetch_list=fetch)
        logits.append(np.asarray(res[0], np.float32))
        pools = list(res[1:])
    return logits, [np.asarray(p, np.float32) for p in pools]


def _port_steps(main, fetch, scope, pools=None):
    """STEPS steps through the port's Executor, fed torch tensors: the
    pools the last step fetched (by default the first pools as float32
    tensors)."""
    feeds, first = _step_feeds()
    pools = [torch.from_numpy(p) for p in first] if pools is None else pools
    exe, logits = pt.Executor(pt.CPUPlace()), []
    for fd in feeds:
        fd = {k: torch.from_numpy(v) for k, v in fd.items()}
        fd.update(zip(_pool_names(), pools))
        res = exe.run(main, feed=fd, fetch_list=fetch, scope=scope,
                      return_numpy=False)
        logits.append(res[0].float().numpy())
        pools = list(res[1:])
    return logits, pools


def _jax_scope(params):
    scope = jpt.Scope()
    for n, a in params.items():
        scope.set_var(n, a.copy())
    return scope


def test_decode_step_program_matches_jax(programs):
    p = programs
    jl, jp = _jax_steps(p["jmain"], p["jfetch"], _jax_scope(p["params"]))
    pools = [torch.from_numpy(a) for a in _step_feeds()[1]]
    tl, tp = _port_steps(p["tmain"], p["tfetch"],
                         tio.scope_from_numpy(p["params"], device="cpu"),
                         pools)
    assert all(a is b for a, b in zip(tp, pools)), \
        "the step writes the fed pools in place and fetches them"
    for got, want in zip(tl, jl):
        assert got.shape == (SLOTS, V)
        np.testing.assert_allclose(got, want, **TOL)
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.fixture(scope="module")
def bf16_runs(programs):
    """Both packages' float32 and transpiled bfloat16 runs of the step."""
    p = programs
    jl, jp = _jax_steps(p["jmain"], p["jfetch"], _jax_scope(p["params"]))
    jmain = p["jmain"].clone(for_test=True)
    jscope = _jax_scope(p["params"])
    JFloat16Transpiler().transpile(jmain, jscope)
    # the JAX package's verifier (on under its tests) holds the transpiled
    # program's activations to their float32 descriptors, which its
    # transpiler leaves as they were: off for this run
    saved = os.environ.get("PT_VERIFY")
    os.environ["PT_VERIFY"] = "0"
    try:
        jl16, jp16 = _jax_steps(jmain, p["jfetch"], jscope)
    finally:
        if saved is None:
            del os.environ["PT_VERIFY"]
        else:
            os.environ["PT_VERIFY"] = saved
    return dict(jl=jl, jp=jp, jl16=jl16, jp16=jp16)


def _port_bf16(programs, pools=None):
    tmain = programs["tmain"].clone(for_test=True)
    scope = tio.scope_from_numpy(programs["params"], device="cpu")
    Float16Transpiler().transpile(tmain, scope)
    return _port_steps(tmain, programs["tfetch"], scope, pools)


def test_transpiled_decode_step_matches_jax(programs, bf16_runs):
    r = bf16_runs
    tl, tp = _port_bf16(programs)
    assert all(t.dtype == torch.bfloat16 for t in tp)
    own = _rrms(r["jl16"], r["jl"])
    got = _rrms(tl, r["jl16"])
    assert got <= SPREAD * own, (got, own)
    own_pools = _rrms(r["jp16"], r["jp"])
    got_pools = _rrms([t.float().numpy() for t in tp], r["jp16"])
    assert got_pools <= SPREAD * own_pools, (got_pools, own_pools)


def test_transpiled_decode_step_limit_fails_a_skipped_write(
        programs, bf16_runs, monkeypatch):
    """A step whose pool write is skipped (the pools fetched unwritten)
    reads far outside the limit."""
    monkeypatch.setattr(tattn, "paged_kv_update", lambda kp, vp, *a: (kp, vp))
    r = bf16_runs
    tl, _ = _port_bf16(programs)
    assert _rrms(tl, r["jl16"]) > SPREAD * _rrms(r["jl16"], r["jl"])


def test_transpiled_step_writes_bf16_pools_in_place_and_float32_ones_in_a_copy(
        programs):
    """bfloat16 pools fed to the transpiled step are the tensors it
    writes and fetches; float32 pools are cast at the step's entry, the
    write lands in that copy (the JAX semantics: new bfloat16 pools) and
    the float32 pools stay as they were. Both give the same logits."""
    first = _step_feeds()[1]
    f32 = [torch.from_numpy(a.copy()) for a in first]
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in first]
    l32, p32 = _port_bf16(programs, f32)
    lbf, pbf = _port_bf16(programs, bf)
    assert all(a is b for a, b in zip(pbf, bf))
    assert not any(a is b for a, b in zip(p32, f32))
    for t, a in zip(f32, first):
        np.testing.assert_array_equal(t.numpy(), a)
    for a, b in zip(l32, lbf):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(p32, pbf):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Float16Transpiler on tests/test_inference_deploy.py's program
# ---------------------------------------------------------------------------

def _deploy_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = pkg.layers.data("img", [3, 16, 16])
        h = pkg.layers.conv2d(img, num_filters=8, filter_size=3, padding=1,
                              act="relu")
        h = pkg.layers.batch_norm(h, act="relu", is_test=True)
        pred = pkg.layers.fc(h, size=10, act="softmax")
    return main, startup, pred


def test_float16_transpiler_matches_jax():
    jpt.core.program.reset_unique_names()
    jmain, jstartup, jpred = _deploy_program(jpt)
    tprog.reset_unique_names()
    tmain, _, tpred = _deploy_program(pt)
    feed = {"img": np.random.RandomState(0).rand(2, 3, 16, 16)
            .astype(np.float32)}
    jscope, jexe = jpt.Scope(), jpt.Executor()
    with jpt.scope_guard(jscope):
        jexe.run(jstartup)
        # the moving statistics away from their start, so that keeping
        # them float32 shows
        (bn,) = [op for op in jmain.global_block.ops
                 if op.type == "batch_norm"]
        stats = {bn.input("Mean")[0]: 0.1, bn.input("Variance")[0]: 1.3}
        for name, value in stats.items():
            shape = jmain.global_block.var(name).shape
            jscope.set_var(name, np.full(shape, value, np.float32))
        state = {v.name: np.asarray(jscope.find_var(v.name))
                 for v in jmain.global_block.vars.values() if v.persistable}
        (want32,) = jexe.run(jmain, feed=feed, fetch_list=[jpred])
        JFloat16Transpiler().transpile(jmain, jscope)
        (want,) = jexe.run(jmain, feed=feed, fetch_list=[jpred])
    texe = pt.Executor(pt.CPUPlace())
    tscope = tio.scope_from_numpy(state, device="cpu")
    (got32,) = texe.run(tmain, feed=feed, fetch_list=[tpred], scope=tscope)
    Float16Transpiler().transpile(tmain, tscope)
    (got,) = texe.run(tmain, feed=feed, fetch_list=[tpred], scope=tscope)

    def dtypes(main):
        return {v.name: v.dtype for v in main.global_block.vars.values()
                if v.persistable}

    assert dtypes(tmain) == dtypes(jmain)
    cast = {n for n, d in dtypes(tmain).items() if d == "bfloat16"}
    kept = {n for n, d in dtypes(tmain).items() if d == "float32"}
    assert cast and set(stats) <= kept
    for n in cast:
        assert tscope.find_var(n).dtype == torch.bfloat16, n
    for n in kept:
        assert tscope.find_var(n).dtype == torch.float32, n
    assert tmain.amp_dtype == jmain.amp_dtype == "bfloat16"
    np.testing.assert_allclose(got32, np.asarray(want32), atol=1e-5,
                               rtol=1e-5)
    want = np.asarray(want, np.float32)
    assert _rrms([got], [want]) <= SPREAD * _rrms([want],
                                                  [np.asarray(want32)])
    np.testing.assert_allclose(got, np.asarray(want32), atol=2e-2,
                               rtol=2e-2)


def test_float16_transpiler_refusals():
    tprog.reset_unique_names()
    main, startup, pred = _deploy_program(pt)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    with pytest.raises(ValueError, match="bfloat16' or 'float16"):
        Float16Transpiler().transpile(main, scope, dtype="int8")
    train = main.clone()
    with pt.program_guard(train, pt.Program()):
        pt.optimizer.SGDOptimizer(learning_rate=0.1).minimize(
            pt.layers.mean(train.global_block.var(pred.name)))
    with pytest.raises(ValueError, match="inference program"):
        Float16Transpiler().transpile(train, scope)
    Float16Transpiler().transpile(main, scope, dtype="float16")
    with pytest.raises(NotImplementedError, match="float16 is not ported"):
        pt.Executor(pt.CPUPlace()).run(
            main, feed={"img": np.zeros((1, 3, 16, 16), np.float32)},
            fetch_list=[pred], scope=scope)


# ---------------------------------------------------------------------------
# the bundle's step program
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bundle(programs, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("decode_program") / "bundle")
    cfg = dict(vocab_size=V, **{k: GEO[k] for k in ttfm.CONFIG_KEYS
                                if k != "vocab_size"})
    tio.export_decode_model(d, cfg, params=programs["params"],
                            length_buckets=(8, 16), slots=SLOTS,
                            block_size=BS, pool_blocks=NB)
    return d


def test_bundle_step_shares_the_prefill_weights(bundle):
    meta, prefill, step = tio.load_decode_bundle(bundle, device="cpu")
    assert meta["decode_program"] == tio.DECODE_FILENAME
    assert step.state and all(step.state[n] is prefill.state[n]
                              for n in step.state)
    assert step.feed_names[:3] == ["token_ids", "context_lens",
                                   "block_tables"]
    assert len(step.fetch_names) == 1 + 2 * L


def test_bundle_without_a_step_program_is_refused(bundle, tmp_path):
    import json
    import shutil

    old = str(tmp_path / "old")
    shutil.copytree(bundle, old)
    path = os.path.join(old, "serving.json")
    with open(path) as f:
        meta = json.load(f)
    del meta["decode_program"]
    with open(path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="re-export"):
        tio.load_decode_bundle(old, device="cpu")


def test_decode_models_from_two_threads_match_one_thread(bundle):
    """Two DecodeModels of one bundle (a fleet's replicas in one process)
    step from two threads at once, with a short switch interval; each
    gives the logits and pools that stepping it alone gives."""
    import sys

    feeds, first = _step_feeds()
    models = [DecodeModel(bundle, device="cpu", warmup=False)
              for _ in range(3)]

    def run(m, out):
        m._pools = [torch.from_numpy(p.copy()) for p in first]
        for _ in range(3):
            for fd in feeds:
                out.append(m.decode_step(fd["token_ids"],
                                         fd["context_lens"],
                                         fd["block_tables"]))
        out.extend(p.clone() for p in m._pools)

    alone = []
    run(models[2], alone)
    outs = [[], []]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(m, o))
                   for m, o in zip(models, outs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for out in outs:
        assert len(out) == len(alone)
        for a, b in zip(out, alone):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
            else:
                np.testing.assert_array_equal(a, b)
