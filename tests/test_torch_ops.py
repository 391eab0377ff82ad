"""The port's plain ops and model pieces vs the JAX package's ops.

paddle_tpu_torch/ops/nn_ops.py and ops/attention_ops.py against the
registered op functions they mirror, called directly on numpy inputs made
from a seed. Tolerance: float32 elementwise work and short sums,
atol = rtol = 1e-5. The host-side helpers (bucketing, decode metrics)
must agree exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops import attention_ops as jattn
from paddle_tpu.ops import math_ops as jmath
from paddle_tpu.ops import nn_ops as jnn
from paddle_tpu.ops import tensor_ops as jtensor
from paddle_tpu.obs.metrics import percentiles as jpercentiles
from paddle_tpu.reader.bucketing import bucket_bound as jbucket_bound
from paddle_tpu.serving.metrics import DecodeMetrics as JDecodeMetrics

from paddle_tpu_torch.ops import attention_ops as tattn
from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.reader.bucketing import bucket_bound
from paddle_tpu_torch.serving.metrics import DecodeMetrics, percentiles

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _j(op, ins, attrs=None, slot="Out"):
    ins = {k: [jnp.asarray(v)] for k, v in ins.items()}
    return np.asarray(op(None, ins, attrs or {})[slot][0])


@pytest.mark.parametrize("ba", [1, 2])
def test_layer_norm_matches_jax(ba):
    x = 3 * _rand(0, 2, 5, 8) + 1
    scale, bias = _rand(1, *x.shape[ba:]), _rand(2, *x.shape[ba:])
    want = _j(jnn.layer_norm, {"X": x, "Scale": scale.reshape(-1),
                               "Bias": bias.reshape(-1)},
              {"begin_norm_axis": ba}, slot="Y")
    got = tnn.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                         torch.from_numpy(bias), begin_norm_axis=ba)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(approximate):
    x = 4 * _rand(3, 64)
    want = np.asarray(jnn._ACTIVATIONS["gelu"](
        jnp.asarray(x), {"approximate": approximate}))
    got = tnn.gelu(torch.from_numpy(x), approximate=approximate)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fc_matches_jax_mul_and_bias():
    x, w, b = _rand(4, 2, 3, 8), _rand(5, 8, 6), _rand(6, 6)
    want = _j(jmath.mul, {"X": x, "Y": w}, {"x_num_col_dims": 2}) + b
    got = tnn.fc(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want = np.asarray(jnn._ACTIVATIONS["gelu"](jnp.asarray(want), {}))
    got = tnn.fc(*map(torch.from_numpy, (x, w, b)), act="gelu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", [(7,), (2, 5), (3, 1)])
def test_lookup_table_matches_jax(shape):
    w = _rand(7, 11, 4)
    ids = np.random.RandomState(8).randint(0, 11, shape).astype(np.int32)
    want = _j(jtensor.lookup_table, {"Ids": ids, "W": w})
    got = tnn.lookup_table(torch.from_numpy(ids), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_matches_jax():
    x = _rand(9, 10, 3)
    idx = np.array([[4], [0], [9], [4]], np.int32)
    want = _j(jtensor.gather, {"X": x, "Index": idx})
    got = tnn.gather(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


class _Ctx:
    """The lowering context the sdpa op reads: a single device."""
    mesh = None


def _SDPA(ctx, ins, attrs):
    return jattn.scaled_dot_product_attention(_Ctx(), ins, attrs)


def test_sdpa_op_matches_jax():
    q, k, v = (_rand(10 + i, 2, 12, 2, 8) for i in range(3))
    want = _j(_SDPA, {"Q": q, "K": k, "V": v}, {"causal": True})
    got = tattn.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(NotImplementedError, match="not ported"):
        tattn.scaled_dot_product_attention(
            *map(torch.from_numpy, (q, k, v)), sp_mode="ring")


def test_paged_ops_match_jax():
    """paged_kv_write then paged_attention, the decode step's per-layer
    pair, on [S, 1, H, D] rows."""
    rng = np.random.RandomState(12)
    s, h, d, nb, bs = 3, 2, 8, 7, 4
    pools = [rng.randn(nb, bs, h, d).astype(np.float32) for _ in range(2)]
    k, v, q = (rng.randn(s, 1, h, d).astype(np.float32) for _ in range(3))
    tables = np.array([[2, 3], [5, 0], [0, 0]], np.int32)
    lens = np.array([6, 2, 0], np.int32)
    ins = {"KPool": pools[0], "VPool": pools[1], "K": k, "V": v,
           "BlockTables": tables, "ContextLens": lens}
    jins = {n: [jnp.asarray(a)] for n, a in ins.items()}
    jw = jattn.paged_kv_write(None, jins, {})
    jout = jattn.paged_attention(None, {
        "Q": [jnp.asarray(q)], "KPool": jw["KOut"], "VPool": jw["VOut"],
        "BlockTables": jins["BlockTables"],
        "ContextLens": jins["ContextLens"]}, {})["Out"][0]
    tk, tv = (torch.from_numpy(p.copy()) for p in pools)
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lens)
    tattn.paged_kv_write(tk, tv, torch.from_numpy(k), torch.from_numpy(v),
                         tt, tl)
    tout = tattn.paged_attention(torch.from_numpy(q), tk, tv, tt, tl)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jw["KOut"][0]))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("n", [1, 8, 9, 32, 33, 70])
def test_bucket_bound_matches_jax(n):
    assert bucket_bound(n, (8, 16, 32)) == jbucket_bound(n, (8, 16, 32))


@pytest.mark.parametrize("n", [0, 1, 2, 7, 100])
def test_percentiles_match_jax(n):
    samples = list(np.random.RandomState(n).exponential(0.01, n))
    assert percentiles(samples) == jpercentiles(samples)
    assert percentiles(samples, qs=(0.1, 0.9)) == \
        jpercentiles(samples, qs=(0.1, 0.9))


def test_decode_metrics_match_jax():
    """The same events, on the same fake clock, give the same snapshot."""
    snaps = []
    for cls in (DecodeMetrics, JDecodeMetrics):
        now = [10.0]
        m = cls("lm", clock=lambda: now[0])
        for _ in range(3):
            m.on_received()
        m.on_prefill(17, 0.25)
        m.on_step(3, 4, 0.01, 3)
        m.on_step(2, 4, 0.02, 5)
        m.on_spec(4, 3)
        m.on_prefix_hit(8, 2)
        m.on_cow()
        m.on_evicted()
        m.on_resumed()
        m.on_shed("overload")
        m.on_shed("deadline")
        m.on_finished(True)
        m.on_finished(False)
        m.set_gauges(active=2, waiting=1, blocks_in_use=9,
                     blocks_capacity=40, high_water=11, blocks_shared=2,
                     blocks_indexed=3)
        now[0] = 12.5
        snaps.append(m.snapshot())
    assert snaps[0] == snaps[1]
