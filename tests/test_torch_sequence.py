"""Ragged sequences and the stacked LSTM through the port's Program /
Executor, against the JAX package on the CPU.

* ``sequence_pool`` (the six pool types) and the activation table (every
  entry, values and gradients) against the JAX ops.
* ``lod.pad_sequences`` / ``LoDTensor`` and the Executor's ragged feeds
  (a list of sequences, a LoDTensor, a padded array without lengths,
  per-step arrays, explicit lengths) against the JAX Executor's
  ``_prep_feed``.
* ``stacked_dynamic_lstm.get_model(use_fused=True)`` builds the JAX
  package's program dict, and its inference clone, pruned, too; the
  ``@SEQ_LEN`` companion survives clone, prune, the dict round trip and
  the fusion pass.
* The whole slice: a narrow model (vocab 100, embedding 16, hidden 32,
  batch 4, ragged T 8) takes three Adam steps in both packages from one
  state (the JAX startup carried across with ``io.scope_from_numpy``).

Tolerances: elementwise ops and short sums atol = rtol = 1e-5; the
training steps as tests/test_torch_executor.py holds the Transformer:
losses within rtol 1e-4, first-step gradients within atol 1e-5 and rtol
1e-4, and after three steps every state element within atol 1e-5 and
rtol 1e-4 (the updates are small against their parameters: a step moves
each by at most the learning rate, 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import lod as jlod
from paddle_tpu.core import program as jprog
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import stacked_dynamic_lstm as jsdl
from paddle_tpu.ops import nn_ops as jnn
from paddle_tpu.ops import sequence_ops as jseq

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import lod as tlod
from paddle_tpu_torch.analysis import fuse as tfuse
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op
from paddle_tpu_torch.models import stacked_dynamic_lstm as tsdl
from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.ops import sequence_ops as tseq

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# sequence_pool and the activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ptype", ["sum", "average", "sqrt", "max", "last",
                                   "first"])
def test_sequence_pool_matches_jax(ptype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 3)).astype(np.float32)
    lens = np.array([7, 1, 4, 0, 3], np.int32)
    want = jseq.sequence_pool(None, {"X": [jnp.asarray(x)],
                                     "SeqLen": [jnp.asarray(lens)]},
                              {"pooltype": ptype})["Out"][0]
    xt = torch.from_numpy(x).requires_grad_(True)
    got = get_op("sequence_pool").compute(
        None, {"X": [xt], "SeqLen": [torch.from_numpy(lens)]},
        {"pooltype": ptype})["Out"][0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    if ptype == "max":
        return   # the empty row pools to -inf: no gradient to compare
    g = rng.standard_normal(got.shape).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(jseq.sequence_pool(
        None, {"X": [v], "SeqLen": [jnp.asarray(lens)]},
        {"pooltype": ptype})["Out"][0] * g))(jnp.asarray(x))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), **TOL)


def test_time_mask_matches_jax():
    lens = np.array([3, 0, 5], np.int32)
    want = jseq.time_mask(jnp.asarray(lens), 6, jnp.float32)
    got = tseq.time_mask(torch.from_numpy(lens), 6, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


POSITIVE = {"log", "sqrt", "rsqrt", "pow", "reciprocal"}


@pytest.mark.parametrize("name", sorted(jnn._ACTIVATIONS))
def test_activation_matches_jax(name):
    assert sorted(tnn._ACTIVATIONS) == sorted(jnn._ACTIVATIONS)
    rng = np.random.default_rng(1)
    x = (rng.uniform(0.2, 3.0, (4, 9)) if name in POSITIVE
         else 3 * rng.standard_normal((4, 9))).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    fn = jnn._ACTIVATIONS[name]
    want = fn(jnp.asarray(x), {})
    jg = jax.grad(lambda v: jnp.sum(fn(v, {}) * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = get_op(name).compute(None, {"X": [xt]}, {})["Out"][0]
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), **TOL)


# ---------------------------------------------------------------------------
# padding and ragged feeds
# ---------------------------------------------------------------------------

def _seqs(lens, seed=0, tail=(1,)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, (n,) + tail).astype(np.int64) for n in lens]


@pytest.mark.parametrize("lens,kw", [
    ([3, 9, 1], {}), ([8, 8], {}), ([5, 2], {"pad_multiple": 1}),
    ([4, 6], {"max_len": 12, "pad_value": -1})])
def test_pad_sequences_matches_jax(lens, kw):
    seqs = _seqs(lens)
    want = jlod.pad_sequences(seqs, **kw)
    got = tlod.pad_sequences(seqs, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_lod_tensor_matches_jax():
    flat = np.arange(20, dtype=np.float32).reshape(10, 2)
    lens = [[2, 1], [3, 4, 3]]
    jt, tt = (m.create_lod_tensor(flat, lens) for m in (jlod, tlod))
    assert tt.lod() == jt.lod() and tt.lod_level == jt.lod_level == 2
    (ja, (jo, ji)), (ta, (to, ti)) = jt.to_padded(), tt.to_padded()
    for g, w in ((ta, ja), (to, jo), (ti, ji)):
        np.testing.assert_array_equal(g, w)
    seqs = _seqs([2, 5, 3], seed=1)
    np.testing.assert_array_equal(tlod.LoDTensor(seqs).to_padded()[0],
                                  jlod.LoDTensor(seqs).to_padded()[0])


def _feed_programs():
    progs = []
    for pkg in (jpt, pt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            pkg.layers.data("words", [1], lod_level=1, dtype="int64")
            pkg.layers.data("label", [1], dtype="int64")
        progs.append(main)
    return progs


def _prep_both(feed_j, feed_t, per_step=False):
    jmain, tmain = _feed_programs()
    want = jpt.Executor()._prep_feed(jmain, feed_j, per_step=per_step)
    got = pt.Executor(pt.CPUPlace())._prep_feed(tmain, feed_t, per_step)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
    return got


@pytest.mark.parametrize("kind", ["list", "lod_tensor", "padded",
                                  "explicit_lengths", "per_step"])
def test_ragged_feeds_match_jax_executor(kind):
    seqs = _seqs([3, 9, 1, 6], seed=2)
    label = np.array([[0], [1], [1], [0]], np.int64)
    if kind == "list":
        feeds = ({"words": seqs, "label": label},) * 2
    elif kind == "lod_tensor":
        feeds = ({"words": jlod.LoDTensor(seqs), "label": label},
                 {"words": tlod.LoDTensor(seqs), "label": label})
    elif kind == "padded":
        padded, _ = jlod.pad_sequences(seqs)
        feeds = ({"words": padded},) * 2
    elif kind == "explicit_lengths":
        padded, lens = jlod.pad_sequences(seqs)
        feeds = ({"words": padded, "words@SEQ_LEN": lens},) * 2
    else:
        padded = np.stack([jlod.pad_sequences(seqs)[0]] * 3)
        got = _prep_both({"words": padded}, {"words": padded},
                         per_step=True)
        assert tuple(got["words@SEQ_LEN"].shape) == (3, 4)
        return
    got = _prep_both(*feeds)
    lens = got["words@SEQ_LEN"].tolist()
    want_lens = ([16] * 4 if kind == "padded" else [3, 9, 1, 6])
    assert lens == want_lens and tuple(got["words"].shape) == (4, 16, 1)


def test_ragged_list_feeds_refused_per_step():
    _, tmain = _feed_programs()
    with pytest.raises(ValueError, match="per_step"):
        pt.Executor(pt.CPUPlace())._prep_feed(
            tmain, {"words": _seqs([2, 3])}, per_step=True)


# ---------------------------------------------------------------------------
# the stacked LSTM program
# ---------------------------------------------------------------------------

NARROW = dict(dict_size=100, lstm_size=32, emb_dim=16)
BATCH, MAX_T, STEPS = 4, 8, 3


def _build(pkg, prog_mod, sdl):
    prog_mod.reset_unique_names()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        loss, acc, logit, feeds = sdl.get_model(use_fused=True, **NARROW)
    return dict(main=main, startup=startup, loss=loss, acc=acc, logit=logit,
                feeds=feeds)


@pytest.fixture(scope="module")
def built():
    return {"j": _build(jpt, jprog, jsdl), "t": _build(pt, tprog, tsdl)}


def test_program_matches_jax_op_for_op(built):
    j, t = built["j"], built["t"]
    assert t["feeds"] == j["feeds"] == ["words", "label"]
    for which in ("main", "startup"):
        assert [op.type for op in t[which].global_block.ops] == \
            [op.type for op in j[which].global_block.ops]
        assert t[which].to_dict() == j[which].to_dict()
    words = t["main"].global_block.var("words")
    assert words.seq_len_var == "words@SEQ_LEN" and words.lod_level == 1
    assert words.shape == (-1, -1, 1)


def test_inference_clone_matches_jax(built):
    j, t = built["j"], built["t"]
    tinf = t["main"].clone(for_test=True).prune([t["logit"].name])
    jinf = j["main"].clone(for_test=True).prune([j["logit"].name])
    assert tinf.to_dict() == jinf.to_dict()
    assert [op.type for op in tinf.global_block.ops] == [
        "lookup_table", "mul", "elementwise_add", "tanh", "mul",
        "elementwise_add", "dynamic_lstm", "sequence_pool", "mul",
        "elementwise_add", "softmax"]


def test_seq_len_companion_survives_program_transforms(built):
    main = built["t"]["main"]
    seq_vars = {n: (v.seq_len_var, v.lod_level)
                for n, v in main.global_block.vars.items() if v.seq_len_var}
    assert len(seq_vars) >= 6   # words, embedding, two fc, the LSTM pair
    for prog in (main.clone(), main.clone(for_test=True),
                 tprog.Program.from_dict(main.to_dict()),
                 tfuse.maybe_fuse(main, protect=[built["t"]["loss"].name])):
        got = {n: (v.seq_len_var, v.lod_level)
               for n, v in prog.global_block.vars.items() if v.seq_len_var}
        assert got == seq_vars
    pruned = main.prune([built["t"]["logit"].name])
    for n, v in pruned.global_block.vars.items():
        if n in seq_vars:
            assert (v.seq_len_var, v.lod_level) == seq_vars[n]


def test_use_fused_false_is_not_ported():
    with pt.program_guard(pt.Program(), pt.Program()):
        with pytest.raises(NotImplementedError, match="not ported"):
            tsdl.get_model(use_fused=False, **NARROW)


def _feeds(i):
    rng = np.random.RandomState(300 + i)
    lens = rng.randint(1, MAX_T + 1, BATCH)
    lens[0], lens[1] = 1, MAX_T
    words = [rng.randint(0, NARROW["dict_size"], (n, 1)).astype("int64")
             for n in lens]
    label = rng.randint(0, 2, (BATCH, 1)).astype("int64")
    return {"words": words, "label": label}


@pytest.fixture(scope="module")
def jax_run(built):
    j = built["j"]
    exe, scope = jpt.Executor(), JScope()
    exe.run(j["startup"], scope=scope)
    names = sorted(v.name for v in j["main"].global_block.vars.values()
                   if v.persistable)
    start = {n: np.array(scope.find_var(n)) for n in names}
    params = [p.name for p in j["main"].global_block.all_parameters()]
    losses, grads = [], None
    for i in range(STEPS):
        fetch = [j["loss"].name] + ([p + "@GRAD" for p in params]
                                    if i == 0 else [])
        out = exe.run(j["main"], feed=_feeds(i), fetch_list=fetch,
                      scope=scope)
        losses.append(float(out[0][0]))
        if i == 0:
            grads = dict(zip(params, out[1:]))
    end = {n: np.array(scope.find_var(n)) for n in names}
    return dict(start=start, losses=losses, grads=grads, end=end,
                params=params)


def test_adam_steps_match_jax(built, jax_run):
    t = built["t"]
    exe = pt.Executor(pt.CPUPlace())
    scope = tio.scope_from_numpy(jax_run["start"], "cpu")
    params = jax_run["params"]
    for i in range(STEPS):
        fetch = [t["loss"]] + ([p + "@GRAD" for p in params]
                               if i == 0 else [])
        out = exe.run(t["main"], feed=_feeds(i), fetch_list=fetch,
                      scope=scope)
        np.testing.assert_allclose(out[0][0], jax_run["losses"][i],
                                   rtol=1e-4)
        if i == 0:
            for p, g in zip(params, out[1:]):
                np.testing.assert_allclose(g, jax_run["grads"][p],
                                           atol=1e-5, rtol=1e-4, err_msg=p)
    for n, want in jax_run["end"].items():
        np.testing.assert_allclose(scope.get_numpy(n), want, atol=1e-5,
                                   rtol=1e-4, err_msg=n)


def test_inference_clone_runs_and_gives_probabilities(built, jax_run):
    t = built["t"]
    name = t["logit"].name
    test = t["main"].clone(for_test=True).prune([name])
    scope = tio.scope_from_numpy(jax_run["start"], "cpu")
    feed = {"words": _feeds(0)["words"]}
    pred, = pt.Executor(pt.CPUPlace()).run(test, feed=feed,
                                           fetch_list=[name], scope=scope)
    jscope = JScope()
    for n, v in jax_run["start"].items():
        jscope.set_var(n, jnp.asarray(v))
    jtest = built["j"]["main"].clone(for_test=True).prune([name])
    want, = jpt.Executor().run(jtest, feed=feed, fetch_list=[name],
                               scope=jscope)
    assert pred.shape == (BATCH, 2)
    np.testing.assert_allclose(pred.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(pred, want, **TOL)
