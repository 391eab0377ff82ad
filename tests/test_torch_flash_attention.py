"""The port's attention kernels, plain versions vs the JAX package.

Inputs come from numpy seeds and go through the JAX function and its
counterpart in paddle_tpu_torch/kernels/flash_attention.py on the CPU,
where every port wrapper runs its plain version. The JAX side runs its
reference and, where it has one, its Pallas kernel in interpret mode (as
tests/test_attention.py and tests/test_decode.py run them).

Tolerance: float32 on both sides, sums in another order: atol = rtol =
1e-5.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa

# the package re-exports a function of the module's name
jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, b, sq, sk, h, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, h, d).astype(np.float32)
    v = rng.randn(b, sk, h, d).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 16, 16, 2, 8), (1, 5, 23, 3, 16),
                                          (2, 64, 96, 2, 32)])
def test_mha_reference_matches_jax(causal, b, sq, sk, h, d):
    q, k, v = _qkv(sq + sk, b, sq, sk, h, d)
    want = np.asarray(jfa.mha_reference(*map(jnp.asarray, (q, k, v)),
                                        causal=causal))
    got = tfa.mha_reference(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    got = tfa.dot_product_attention(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_mha_reference_bias_and_scale_match_jax():
    q, k, v = _qkv(3, 2, 12, 20, 2, 8)
    bias = np.random.RandomState(4).randn(2, 2, 12, 20).astype(np.float32)
    want = np.asarray(jfa.mha_reference(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(bias), causal=True,
        scale=0.3))
    got = tfa.dot_product_attention(*_t(q, k, v), torch.from_numpy(bias),
                                    causal=True, scale=0.3).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(64, 64), (32, 96)])
def test_flash_fwd_matches_jax_kernel_interpret(causal, sq, sk):
    """O and logsumexp of the port's flash forward (its plain version on
    CPU) against the Pallas forward in interpret mode, block 32."""
    q, k, v = _qkv(7, 2, sq, sk, 2, 32)
    out = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                              interpret=True, block_q=32, block_k=32)
    q3, k3, v3 = (jfa._bshd_to_3d(jnp.asarray(x)) for x in (q, k, v))
    _, lse = jfa._flash_fwd(q3, k3, v3, scale=1 / np.sqrt(32), causal=causal,
                            block_q=32, block_k=32, interpret=True)
    o, tlse = tfa.flash_attention_fwd(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse)[..., 0],
                               **TOL)


def _paged_inputs(seed, s, h, d, nb, bs, lens):
    rng = np.random.RandomState(seed)
    mb = -(-max(lens) // bs) + 1
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((s, mb), np.int32)
    used = 0
    for i, n in enumerate(lens):
        need = -(-n // bs)
        tables[i, :need] = perm[used:used + need]
        used += need
    return (rng.randn(s, h, d).astype(np.float32),
            rng.randn(nb, bs, h, d).astype(np.float32),
            rng.randn(nb, bs, h, d).astype(np.float32), tables,
            np.asarray(lens, np.int32))


@pytest.mark.parametrize("s,h,d,nb,bs,lens", [
    (3, 2, 8, 10, 4, [7, 1, 0]),
    (4, 2, 16, 30, 4, [13, 0, 40, 4]),
])
def test_paged_reference_matches_jax(s, h, d, nb, bs, lens):
    args = _paged_inputs(s * nb, s, h, d, nb, bs, lens)
    want = np.asarray(jfa.paged_attention_reference(*map(jnp.asarray, args)))
    got = tfa.paged_decode_attention(*_t(*args)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(tfa.paged_attention_reference(*_t(*args))
                               .numpy(), want, **TOL)
    for i, n in enumerate(lens):
        if n == 0:
            assert np.all(got[i] == 0)


def test_paged_matches_jax_kernel_interpret():
    """d=128, bs=8: the Pallas paged kernel in interpret mode, ragged
    lengths and an idle slot."""
    args = _paged_inputs(11, 3, 2, 128, 12, 8, [13, 0, 21])
    want = np.asarray(jfa.paged_decode_attention(*map(jnp.asarray, args),
                                                 interpret=True))
    got = tfa.paged_decode_attention(*_t(*args)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[1] == 0)


def test_paged_kv_update_in_place_matches_jax():
    """Write rows at ragged positions (and from an idle slot into the null
    block) in place; the pools equal JAX's functional update."""
    rng = np.random.RandomState(5)
    s, h, d, nb, bs = 4, 2, 8, 9, 4
    kp, vp = (rng.randn(nb, bs, h, d).astype(np.float32) for _ in range(2))
    kn, vn = (rng.randn(s, h, d).astype(np.float32) for _ in range(2))
    tables = np.array([[3, 5, 0], [7, 0, 0], [1, 2, 4], [0, 0, 0]], np.int32)
    lens = np.array([6, 1, 12, 0], np.int32)
    jk, jv = jfa.paged_kv_update(*map(jnp.asarray,
                                      (kp, vp, kn, vn, tables, lens)))
    tk, tv = _t(kp.copy(), vp.copy())
    rk, rv = tfa.paged_kv_update(tk, tv, *_t(kn, vn, tables, lens))
    assert rk is tk and rv is tv, "the pools are updated in place"
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_cpu_wrappers_count_no_launches():
    """On the CPU the wrappers run the plain versions: no kernel, no
    launch counted."""
    q, k, v = _t(*_qkv(1, 1, 8, 8, 2, 8))
    n = tfa.flash_attention_fwd.launches
    tfa.flash_attention_fwd(q, k, v, causal=True)
    tfa.dot_product_attention(q, k, v, causal=True)
    assert tfa.flash_attention_fwd.launches == n
    args = _t(*_paged_inputs(2, 2, 2, 8, 6, 4, [5, 0]))
    n = tfa.paged_decode_attention.launches
    tfa.paged_decode_attention(*args)
    assert tfa.paged_decode_attention.launches == n
