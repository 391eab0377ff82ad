"""The port's flash-attention backward, plain versions vs the JAX package.

Inputs and the output cotangent come from numpy seeds. The JAX side is
``jax.vjp`` through ``flash_attention(..., interpret=True)``, which runs
the two Pallas backward kernels in interpret mode (as
tests/test_attention.py runs them); its blocks are min(128, S), so every
shape here is one Pallas block while the port's kernels tile it 64 x 32.
The port side is ``flash_attention_bwd_reference`` and the CPU gradients
of the ``FlashAttention`` autograd function, which on the CPU run the
chunked-scan plain versions of the two kernels.

Tolerance: float32 on both sides, sums in another order: atol = rtol =
1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)

CASES = [  # b, sq, sk, h, d, causal
    (2, 64, 64, 2, 64, False),
    (2, 64, 64, 2, 64, True),
    (1, 32, 96, 2, 128, True),     # sq < sk: bottom-right causal
    (1, 48, 48, 2, 128, False),
    (1, 32, 32, 1, 256, True),
    (1, 40, 72, 1, 256, False),
    (2, 77, 77, 2, 64, True),      # 77: neither 64 nor 32 divides it
    (1, 77, 101, 1, 128, True),
]


def _inputs(seed, b, sq, sk, h, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, h, d).astype(np.float32)
    v = rng.randn(b, sk, h, d).astype(np.float32)
    do = rng.randn(b, sq, h, d).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal):
    if not jfa._HAS_PLTPU:
        pytest.skip("the Pallas TPU backend is not importable: jax.vjp "
                    "would run the XLA fallback, not the kernels")

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, interpret=True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("b,sq,sk,h,d,causal", CASES)
def test_backward_matches_pallas_interpret(b, sq, sk, h, d, causal):
    q, k, v, do = _inputs(sq * 31 + sk + d, b, sq, sk, h, d)
    want = _jax_grads(q, k, v, do, causal)

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal=causal)
    got = tfa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo,
                                            causal=causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", **TOL)

    # the autograd function (CPU: the same plain versions, through the
    # wrappers) gives the same gradients
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = tfa.FlashAttention.apply(*leaves, causal, None)
    out.backward(tdo)
    for name, leaf, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w,
                                   err_msg=f"autograd d{name}", **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_autograd_through_mha(causal):
    """The chunked plain backward equals torch.autograd through the plain
    forward, including a query-block edge (S = 300 over 128-row
    chunks)."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(3, 1, 300, 300, 2, 64))
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, causal=causal)
    got = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                            causal=causal)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    tfa.mha_reference(*leaves, causal=causal).backward(do)
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad, **TOL)


def test_dot_product_attention_grads_on_cpu_are_plain_autograd():
    """On the CPU the dispatcher keeps the plain path: its gradients are
    autograd's through mha_reference, and no kernel launch is counted."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(4, 1, 40, 40, 2, 64))
    counts = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    tfa.dot_product_attention(*leaves, causal=True).backward(do)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad, **TOL)
    assert counts == (tfa.flash_attention_fwd.launches,
                      tfa.flash_attention_bwd_dq.launches,
                      tfa.flash_attention_bwd_dkv.launches)
