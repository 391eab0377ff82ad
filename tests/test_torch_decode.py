"""The port's decode slice vs the JAX package, on the CPU.

One tiny Transformer LM (the widths of tests/test_decode.py) is built and
initialized by the JAX package; its weights go into a JAX decode bundle
and, through ``params_from_numpy``, into a port bundle. The two are then
held together layer by layer:

* bundle — parameter names and shapes, serving.json's decode section,
  ModelVersion bucket selection;
* model — DecodeModel prefill (logits, per-layer K/V) and a run of decode
  steps (logits, the pools after the writes), including speculative slot
  packing and an idle slot. Whole-model float32 in two frameworks:
  atol = rtol = 1e-4;
* pools — the port moves blocks in place; defrag with overlapping maps and
  a copy-on-write copy give the pools JAX's functional update gives;
* engine — greedy generate is token-identical in both engines under
  continuous batching, eviction, EOS, defrag and prefix sharing with
  speculative decoding.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu import io as jio
from paddle_tpu.models import transformer as jtfm
from paddle_tpu.serving import decode as jdecode
from paddle_tpu.serving.registry import ModelVersion as JModelVersion

from paddle_tpu_torch import io as tio
from paddle_tpu_torch.models.transformer import param_shapes
from paddle_tpu_torch.serving import decode as tdecode
from paddle_tpu_torch.serving.admission import InvalidRequest

torch.set_num_threads(2)

V, L, DM, H, FF, MAXC = 43, 2, 16, 2, 32, 48
BLOCK, POOL, SLOTS = 4, 40, 3
BUCKETS = (8, 16, 32)
CFG = dict(vocab_size=V, n_layers=L, d_model=DM, n_heads=H, d_ff=FF,
           max_context=MAXC)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """(JAX bundle dir, port bundle dir, {name: array}) of one model."""
    pt.core.program.reset_unique_names()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        jtfm.transformer_lm_loss(vocab_size=V, seq_len=MAXC, n_layers=L,
                                 d_model=DM, n_heads=H, d_ff=FF, max_len=MAXC)
    scope = pt.Scope()
    root = tmp_path_factory.mktemp("torch_decode")
    jdir, tdir = str(root / "jax"), str(root / "torch")
    geometry = dict(length_buckets=BUCKETS, slots=SLOTS, block_size=BLOCK,
                    pool_blocks=POOL)
    with pt.scope_guard(scope):
        pt.Executor().run(startup)
        jio.export_decode_model(jdir, CFG, scope=scope, **geometry)
    params = {p.name: np.asarray(scope.find_var(p.name))
              for p in main.all_parameters()}
    tio.export_decode_model(tdir, CFG, params=params, **geometry)
    return jdir, tdir, params


@pytest.fixture(scope="module")
def models(bundles):
    jdir, tdir, _ = bundles
    return (jdecode.DecodeModel(jdir, warmup=False),
            tdecode.DecodeModel(tdir, device="cpu", warmup=False))


def _prompts(seed, n, lo=2, hi=9):
    rng = np.random.RandomState(seed)
    return [list(int(t) for t in rng.randint(1, V, rng.randint(lo, hi)))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# bundle
# ---------------------------------------------------------------------------

def test_jax_parameters_are_the_ports(bundles):
    _, _, params = bundles
    assert {n: a.shape for n, a in params.items()} == param_shapes(CFG)


def test_params_from_numpy_refuses_mismatches(bundles):
    _, _, params = bundles
    assert set(tio.params_from_numpy(params, CFG)) == set(params)
    missing = dict(params)
    missing.pop("lm_head_b")
    extra = dict(params, stray=np.zeros(3, np.float32))
    wrong = dict(params, pos_emb=np.zeros((MAXC + 1, DM), np.float32))
    for bad, needle in ((missing, "missing ['lm_head_b']"),
                        (extra, "extra ['stray']"), (wrong, "pos_emb")):
        with pytest.raises(ValueError, match=needle.replace("[", r"\[")
                           .replace("]", r"\]")):
            tio.params_from_numpy(bad, CFG)


def test_bundle_metadata_matches_jax(bundles):
    jdir, tdir, _ = bundles
    metas = []
    for d in (jdir, tdir):
        with open(os.path.join(d, "serving.json")) as f:
            metas.append(json.load(f))
    jm, tm = metas
    assert tm["format"] == tio.FORMAT
    jdec = dict(jm["decode"])
    jdec.pop("file")
    assert tm["decode"] == jdec
    for key in ("fetch_names", "batch_size", "var_dims", "feeds", "fetches"):
        assert tm[key] == jm[key], key
    for jb, tb in zip(jm["buckets"], tm["buckets"]):
        jb = dict(jb)
        jb.pop("file")
        assert tb == jb


def test_load_refuses_a_jax_bundle(bundles):
    jdir, _, _ = bundles
    with pytest.raises(ValueError, match="not a paddle_tpu_torch"):
        tio.load_decode_bundle(jdir, device="cpu")


def test_bucket_selection_matches_jax(bundles, models):
    jdir, _, _ = bundles
    jmv, tmv = JModelVersion.load(jdir, version=1, warmup=False), \
        models[1].prefill_model
    for n in (1, 8, 9, 16, 17, 32):
        ex = {"src_ids": np.arange(n, dtype=np.int32) % V}
        assert tmv.bucket_of(ex) == jmv.bucket_of(ex)
    for bad in ({"src_ids": np.zeros(33, np.int32)},
                {"src_ids": np.zeros((2, 3), np.int32)},
                {"src_ids": np.zeros(3, np.float32)},
                {"ids": np.zeros(3, np.int32)}):
        with pytest.raises(InvalidRequest):
            tmv.bucket_of(bad)
    res, phases = tmv.execute_batch(16, [{"src_ids": np.arange(5)}])
    assert res[0]["logits"].shape == (16, V)
    assert res[0]["k_1"].shape == (16, H, DM // H)
    assert set(phases) == {"pad", "device", "scatter"}


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 8, 13, 32])
def test_prefill_matches_jax(models, n):
    jm, tm = models
    prompt = _prompts(n, 1, n, n + 1)[0]
    jl, jkv = jm.prefill(prompt)
    tl, tkv = tm.prefill(prompt)
    np.testing.assert_allclose(tl, np.asarray(jl), **TOL)
    assert len(tkv) == L
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_decode_steps_match_jax(models):
    """Seed two sequences, then step: slot 0 plain, slot 1 its own
    sequence with a drafted token packed into slot 2 over the same table
    for two steps, then slot 2 idle. Logits and every pool agree."""
    jm, tm = models
    for m in models:
        m.reset_pools()
    a, b = _prompts(3, 2, 6, 9)
    blocks = {0: [1, 2, 3, 4], 1: [5, 6, 7, 8]}
    for m in models:
        for seq, prompt in ((0, a), (1, b)):
            _, kv = m.prefill(prompt)
            m.seed_sequence(blocks[seq], kv)
    lens = [len(a), len(b)]
    rng = np.random.RandomState(9)
    for step in range(6):
        tokens = np.zeros(SLOTS, np.int64)
        ctx = np.zeros(SLOTS, np.int32)
        tables = np.zeros((SLOTS, jm.max_blocks_per_seq), np.int32)
        for seq in (0, 1):
            tokens[seq] = rng.randint(1, V)
            ctx[seq] = lens[seq] + 1
            tables[seq, :4] = blocks[seq]
        if step < 2:   # slot packing: slot 2 drafts sequence 1's next token
            tokens[2], ctx[2] = rng.randint(1, V), lens[1] + 2
            tables[2] = tables[1]
        jl = np.asarray(jm.decode_step(tokens, ctx, tables))
        tl = tm.decode_step(tokens, ctx, tables)
        np.testing.assert_allclose(tl, jl, **TOL)
        lens = [n + 1 for n in lens]
    for jp, tp in zip(jm._pools, tm._pools):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def test_in_place_block_moves_match_jax(models):
    """Defrag maps overlap (a block is both a source and a destination);
    the port's in-place permute and CoW copy equal JAX's functional
    p.at[dst].set(p[src])."""
    jm, tm = models
    rng = np.random.RandomState(4)
    shape = tuple(tm._pools[0].shape)
    pools = [rng.randn(*shape).astype(np.float32) for _ in tm._pools]
    jm._pools = [jnp.asarray(p) for p in pools]
    tm._pools = [torch.from_numpy(p.copy()) for p in pools]
    for m in models:
        m.permute_blocks({5: 2, 7: 5, 9: 7, 12: 9, 3: 1})
        m.copy_block(2, 11)
        m.permute_blocks({})
    for jp, tp in zip(jm._pools, tm._pools):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # the chain really moved: new 5 holds old 7, new 2 (and 11) old 5
    np.testing.assert_array_equal(tm._pools[0][5].numpy(), pools[0][7])
    np.testing.assert_array_equal(tm._pools[0][11].numpy(), pools[0][5])
    for m in models:
        m.reset_pools()


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _shared_prefix_prompts():
    base = [5, 6, 7, 8, 5, 6, 7, 8, 9, 10]
    return [base, base[:6], base + [11, 5, 6], base[:9] + [3, 3]]


# each scenario: engine kwargs and waves of (prompt, max_new, generate
# kwargs); a wave is submitted at once and drained before the next, and a
# "defrag" wave compacts the idle engine's pool
SCENARIOS = {
    "continuous": ({}, [[(p, m, {}) for p, m in
                         zip(_prompts(11, 6), [5, 9, 3, 12, 7, 4])]]),
    "eviction": ({"pool_blocks": 9},
                 [[(p, 12, {"priority": pr}) for p, pr in
                   zip(_prompts(5, 3, 7, 8), [1, 0, 0])]]),
    "static": ({"continuous": False},
               [[(p, m, {}) for p, m in zip(_prompts(51, 4), [3, 9, 3, 9])]]),
    # the unrelated prompt's freed blocks leave a hole below the indexed
    # prefix blocks, so defrag moves them and the index follows
    "defrag": ({"kv_share": True},
               [[(p, 6, {}) for p in _prompts(77, 1, 6, 7)
                 + _shared_prefix_prompts()[:1]],
                "defrag",
                [(p, 6, {}) for p in _shared_prefix_prompts()[1:]]]),
    # a prompt ending inside an indexed block forces a copy-on-write; the
    # repeating prompt gives the n-gram drafter proposals for idle slots
    "kv_share_ngram": ({"kv_share": True, "drafter": "ngram", "spec_k": 3},
                       [[(_shared_prefix_prompts()[0], 14, {})],
                        [(_shared_prefix_prompts()[1], 14, {}),
                         ([1, 2, 3] * 3, 14, {})],
                        [(p, 14, {}) for p in _shared_prefix_prompts()[2:]]]),
}


def _serve(engine_cls, model, kwargs, waves):
    eng = engine_cls(model=model, name="lm", **kwargs)
    out, moved = [], []
    try:
        for wave in waves:
            if wave == "defrag":
                moved.append(eng.defrag())
                continue
            handles = [eng.generate(p, max_new_tokens=m, **kw)
                       for p, m, kw in wave]
            out += [h.result(timeout=120) for h in handles]
        return out, moved, eng.metrics_snapshot()
    finally:
        eng.shutdown()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_token_identical_to_jax(models, scenario):
    kwargs, waves = SCENARIOS[scenario]
    jm, tm = models
    jout, jmoved, _ = _serve(jdecode.DecodeEngine, jm, kwargs, waves)
    tout, tmoved, snap = _serve(tdecode.DecodeEngine, tm, kwargs, waves)
    assert [r["tokens"] for r in tout] == [r["tokens"] for r in jout]
    assert [r["finish_reason"] for r in tout] == \
        [r["finish_reason"] for r in jout]
    assert tmoved == jmoved
    assert snap["failed"] == 0
    if scenario == "eviction":
        assert snap["evictions"] > 0 and snap["resumes"] > 0
    if scenario == "defrag":
        assert tmoved[0] > 0, "defrag moved no block"
    if kwargs.get("kv_share"):
        assert snap["kv_shared_hits"] > 0
    if kwargs.get("drafter"):
        assert snap["spec_drafted"] > 0 and snap["kv_cow_copies"] > 0


def test_engine_eos_matches_jax(models):
    jm, tm = models
    p = _prompts(41, 1, 5, 6)[0]
    plain, _, _ = _serve(jdecode.DecodeEngine, jm, {}, [[(p, 8, {})]])
    eos = plain[0]["tokens"][1]
    wave = [[(p, 8, {"eos_id": eos})]]
    jout, _, _ = _serve(jdecode.DecodeEngine, jm, {}, wave)
    tout, _, _ = _serve(tdecode.DecodeEngine, tm, {}, wave)
    assert tout[0]["tokens"] == jout[0]["tokens"]
    assert tout[0]["finish_reason"] == jout[0]["finish_reason"] == "eos"
    assert tout[0]["tokens"][-1] == eos


def test_default_device_engine_raises_without_a_card(bundles):
    _, tdir, _ = bundles
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdecode.DecodeEngine(tdir)
