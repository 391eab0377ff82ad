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
from test_torch_fused_block import _pairs, _tf32

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


# The kernel's k order within a k16 block: k8 step s takes elements
# 4 t + 2 s and 4 t + 2 s + 1 of the block, t = 0 .. 3.
_K16 = torch.tensor([0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15])


def _mm_tf32(a, b, products, acc=None):
    """acc (zeros by default) + a [.., M, K] · b [.., K, N] as the
    kernels' mma.sync products run it: K's order permuted within each k16
    block as the kernels read it, then over K in k8 steps, each step's
    products (each exact in float32) summed into a fresh fragment, added
    into the accumulator in float32. The sums inside a fragment round to
    nearest here, where the tensor cores truncate."""
    assert a.shape[-1] % 16 == 0
    perm = (torch.arange(0, a.shape[-1], 16)[:, None] + _K16).reshape(-1)
    a, b = a[..., perm], b[..., perm, :]
    if acc is None:
        acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        f = torch.zeros_like(acc)
        for x, y in _pairs(a[..., k0:k0 + 8], b[..., k0:k0 + 8, :],
                           products):
            f = f + torch.matmul(x, y)
        acc = acc + f
    return acc


def _flash_fwd_tf32(q, k, v, causal, products, block=64):
    """csrc/flash_attention.cu's arithmetic on [B, S, H, D] inputs, but
    for the tensor cores' truncating sums (see _mm_tf32): per
    tile of 64 query rows, the key tiles of 64 up to the causal diagonal
    (K and V zero-filled past sk, Q past sq), S = Q·Kᵀ in TF32 products
    times the scale, -inf past sk and DEFAULT_MASK_VALUE past the
    diagonal, the online softmax in float32, acc = alpha·acc + P·V in
    TF32 products; O = acc / l_safe, lse = m + log(l_safe)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / np.sqrt(d)
    pad = lambda x, n: torch.nn.functional.pad(
        x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d),
        (0, 0, 0, n - x.shape[1]))
    nq, nk = -(-sq // block), -(-sk // block)
    qp, kp, vp = pad(q, nq * block), pad(k, nk * block), pad(v, nk * block)
    o = torch.zeros(b * h, nq * block, d)
    lse = torch.zeros(b * h, nq * block)
    for qt in range(nq):
        q0 = qt * block
        rows = torch.arange(q0, q0 + block)[:, None] + (sk - sq)
        n_tiles = (min(sk - 1, q0 + block - 1 + sk - sq) // block + 1
                   if causal else nk)
        m = torch.full((b * h, block), -np.inf)
        l = torch.zeros(b * h, block)
        acc = torch.zeros(b * h, block, d)
        for kt in range(n_tiles):
            k0 = kt * block
            kt_, vt_ = kp[:, k0:k0 + block], vp[:, k0:k0 + block]
            s = _mm_tf32(qp[:, q0:q0 + block], kt_.transpose(1, 2),
                         products) * scale
            keys = torch.arange(k0, k0 + block)[None, :]
            if causal:
                s = torch.where(keys > rows, tfa.DEFAULT_MASK_VALUE, s)
            s = torch.where(keys >= sk, -np.inf, s)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(s == -np.inf, 0.0, torch.exp(s - m_new[..., None]))
            alpha = torch.where(m == -np.inf, 0.0, torch.exp(m - m_new))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _mm_tf32(p, vt_, products)
            m = m_new
        l_safe = torch.where(l == 0, 1.0, l)
        o[:, q0:q0 + block] = acc / l_safe[..., None]
        lse[:, q0:q0 + block] = m + torch.log(l_safe)
    o = o[:, :sq].reshape(b, h, sq, d).permute(0, 2, 1, 3)
    return o, lse[:, :sq]


@pytest.mark.parametrize("sq,sk,d,causal", [
    (256, 256, 256, True),    # a prefill bucket's shape, four query tiles
    (100, 230, 64, True),     # sq < sk, an offset of 130: not whole tiles
    (70, 150, 128, False),    # sk not a multiple of the tile
])
def test_3xtf32_holds_flash_fwd_to_its_limits(sq, sk, d, causal):
    """The forward kernel's arithmetic, emulated (both products in
    3xTF32 with a fresh fragment a k8 step, the online softmax over key
    tiles of 64 with its masks), keeps O and lse within half the 1e-5
    limit of the plain version; with one TF32 product O falls outside
    the limit."""
    q, k, v = _t(*_qkv(sq + sk + d, 1, sq, sk, 2, d))
    want_o, want_lse = tfa.flash_attention_fwd_reference(q, k, v,
                                                         causal=causal)

    def share(got, want):
        limit = TOL["atol"] + TOL["rtol"] * want.abs()
        return float(((got - want).abs() / limit).max())
    o, lse = _flash_fwd_tf32(q, k, v, causal, products=3)
    assert share(o, want_o) <= 0.5 and share(lse, want_lse) <= 0.5
    o1, _ = _flash_fwd_tf32(q, k, v, causal, products=1)
    assert share(o1, want_o) > 1


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


def _paged_split(q, k_pool, v_pool, tables, lens, p, scale=None):
    """The arithmetic of csrc/paged_attention.cu's split kernel in
    PyTorch: each (slot, head)'s keys cut into splits of P positions; a
    split that starts at or past the slot's length does nothing; a live
    split's partial is (m, l, acc) = (max score, sum of exp(s - m),
    sum of exp(s - m) v); the live splits' partials are combined in split
    order, rescaled to the largest m, and divided by l (by 1 where l = 0);
    an idle slot gives zeros; a table id out of range reads block 0."""
    s_n, h, d = q.shape
    bs, nb = k_pool.shape[1], k_pool.shape[0]
    scale = 1.0 / np.sqrt(d) if scale is None else scale
    tables = torch.where((tables < 0) | (tables >= nb), 0, tables).long()
    out = torch.zeros_like(q)
    for slot in range(s_n):
        ctx = min(max(int(lens[slot]), 0), tables.shape[1] * bs)
        parts = []
        for k0 in range(0, ctx, p):
            pos = torch.arange(k0, min(k0 + p, ctx))
            rows = tables[slot, pos // bs] * bs + pos % bs
            k = k_pool.reshape(nb * bs, h, d)[rows]          # [n, H, D]
            v = v_pool.reshape(nb * bs, h, d)[rows]
            s = torch.einsum("hd,nhd->hn", q[slot], k) * scale
            m = s.amax(dim=1)
            e = torch.exp(s - m[:, None])
            parts.append((m, e.sum(dim=1), torch.einsum("hn,nhd->hd", e, v)))
        if not parts:
            continue
        gm = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        gl, acc = torch.zeros(h), torch.zeros(h, d)
        for m, l, a in parts:
            f = torch.exp(m - gm)
            gl = gl + l * f
            acc = acc + a * f[:, None]
        out[slot] = acc / torch.where(gl == 0, 1.0, gl)[:, None]
    return out


@pytest.mark.parametrize("bs", [4, 8, 16])
@pytest.mark.parametrize("p", [16, 64, 128])
def test_paged_split_arithmetic_matches_jax(p, bs):
    """Lengths 0, 1, P - 1, P, P + 1 and the table's whole capacity, and
    ids out of range (-3 and NB + 5 inside two slots' lengths, read as
    the null block; 7 * NB past a length, never read): the split
    kernel's arithmetic against the JAX package's reference given the
    table with those ids set to 0."""
    cap = -(-(3 * p + 5) // bs) * bs
    lens = [0, 1, p - 1, p, p + 1, cap]
    nb = 2 + sum(-(-n // bs) for n in lens)
    q, kp, vp, tables, lens_a = _paged_inputs(p + bs, 6, 2, 16, nb, bs, lens)
    tables = tables[:, :cap // bs].copy()
    safe = tables.copy()
    tables[5, 1] = -3
    tables[4, 0] = nb + 5
    tables[1, -1] = 7 * nb
    safe[5, 1] = safe[4, 0] = 0
    want = np.asarray(jfa.paged_attention_reference(
        *map(jnp.asarray, (q, kp, vp, safe, lens_a))))
    got = _paged_split(*_t(q, kp, vp, tables, lens_a), p).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[0] == 0)
    np.testing.assert_allclose(
        tfa.paged_attention_reference(*_t(q, kp, vp, safe, lens_a)).numpy(),
        want, **TOL)


@pytest.mark.parametrize("p", [16, tfa.PAGED_SPLIT_KEYS])
def test_paged_split_arithmetic_matches_jax_kernel_interpret(p):
    """The inputs of test_paged_matches_jax_kernel_interpret (d=128, bs=8,
    ragged lengths and an idle slot), the Pallas kernel in interpret mode
    against the split kernel's arithmetic at P 16 (two splits for the
    21-key slot) and at the wrapper's P."""
    args = _paged_inputs(11, 3, 2, 128, 12, 8, [13, 0, 21])
    want = np.asarray(jfa.paged_decode_attention(*map(jnp.asarray, args),
                                                 interpret=True))
    got = _paged_split(*_t(*args), p).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[1] == 0)


@pytest.mark.parametrize("capacity", [1, 16, 1024, 1025, 32768])
def test_paged_split_plan_is_a_rule_of_the_shape(capacity):
    """P is a fixed number of keys (one the probe sweeps); the splits
    cover the table's capacity, whatever the lengths are."""
    p, n_split = tfa.paged_split_plan(capacity)
    assert p == tfa.PAGED_SPLIT_KEYS and p in (16, 32, 64, 128, 256, 512)
    assert n_split == -(-capacity // p) and (n_split - 1) * p < capacity


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
