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
1e-5. The last tests hold the card's dQ and dK/dV kernels
(csrc/flash_attention_bwd.cu) on the CPU: their 3xTF32 arithmetic,
emulated, against the plain versions within half the kernels' 1e-4
limit, and their shared-memory layouts against bank conflicts.
"""

import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa
from test_torch_flash_attention import _mm_tf32

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
# the dQ kernel against its plain version on the card (chip_smoke.py's
# BWD_ATOL / BWD_RTOL, tests/test_torch_gpu.py's BWD_TOL)
BWD_LIMIT = dict(atol=1e-4, rtol=1e-4)

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


def _flash_dq_tf32(q, k, v, do, lse, delta, causal, products, bq=64,
                   bk=32):
    """csrc/flash_attention_bwd.cu's dQ arithmetic on [B, S, H, D] inputs,
    but for the tensor cores' truncating sums (see _mm_tf32): per
    tile of 64 query rows (Q and dO zero past sq), the key tiles of 32 up
    to the causal diagonal (K and V zero past sk); S = Q·Kᵀ and dP = dO·Vᵀ
    in TF32 products; s = S·scale, DEFAULT_MASK_VALUE past the diagonal;
    p = exp(s - lse) and dS = p·(dP - delta)·scale in float32, both 0 for
    rows past sq and keys past sk; dQ += dS·K in TF32 products."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / np.sqrt(d)
    nq, nk = -(-sq // bq), -(-sk // bk)

    def pad(x, n):
        return torch.nn.functional.pad(
            x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d),
            (0, 0, 0, n - x.shape[1]))
    qp, dop = pad(q, nq * bq), pad(do, nq * bq)
    kp, vp = pad(k, nk * bk), pad(v, nk * bk)
    row_pad = (0, nq * bq - sq)
    lse_p = torch.nn.functional.pad(lse, row_pad)
    delta_p = torch.nn.functional.pad(delta, row_pad)
    dq = torch.zeros(b * h, nq * bq, d)
    for qt in range(nq):
        q0 = qt * bq
        rows = torch.arange(q0, q0 + bq)[:, None]
        n_tiles = (min(sk - 1, q0 + bq - 1 + sk - sq) // bk + 1
                   if causal else nk)
        acc = torch.zeros(b * h, bq, d)
        lse_t = lse_p[:, q0:q0 + bq, None]
        delta_t = delta_p[:, q0:q0 + bq, None]
        for kt in range(n_tiles):
            k0 = kt * bk
            kt_, vt_ = kp[:, k0:k0 + bk], vp[:, k0:k0 + bk]
            s = _mm_tf32(qp[:, q0:q0 + bq], kt_.transpose(1, 2),
                         products) * scale
            dp = _mm_tf32(dop[:, q0:q0 + bq], vt_.transpose(1, 2), products)
            keys = torch.arange(k0, k0 + bk)[None, :]
            if causal:
                s = torch.where(keys > rows + (sk - sq),
                                tfa.DEFAULT_MASK_VALUE, s)
            valid = (rows < sq) & (keys < sk)
            p = torch.where(valid, torch.exp(s - lse_t), 0.0)
            ds = torch.where(valid, p * (dp - delta_t) * scale, 0.0)
            acc = _mm_tf32(ds, kt_, products, acc)
        dq[:, q0:q0 + bq] = acc
    return dq[:, :sq].reshape(b, h, sq, d).permute(0, 2, 1, 3)


@pytest.mark.parametrize("sq,sk,d,causal", [
    (128, 128, 256, True),    # the training step's head_dim, two query tiles
    (100, 230, 64, True),     # sq < sk, an offset of 130: not whole tiles
    (70, 150, 128, False),    # sk not a multiple of the key tile of 32
])
def test_3xtf32_holds_flash_dq_to_its_limit(sq, sk, d, causal):
    """The dQ kernel's arithmetic, emulated (its three products in 3xTF32
    with a fresh fragment a k8 step, key tiles of 32 with their masks, dS
    in float32), keeps dQ within half the 1e-4 limit of the plain
    version; with one TF32 product dQ falls outside the limit."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(sq + sk + d, 1, sq, sk, 2, d))
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, causal=causal)
    delta = tfa.flash_attention_bwd_delta(o, do)
    want = tfa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                causal=causal)

    def share(got):
        limit = BWD_LIMIT["atol"] + BWD_LIMIT["rtol"] * want.abs()
        return float(((got - want).abs() / limit).max())
    assert share(_flash_dq_tf32(q, k, v, do, lse, delta, causal, 3)) <= 0.5
    assert share(_flash_dq_tf32(q, k, v, do, lse, delta, causal, 1)) > 1



def _flash_dkv_tf32(q, k, v, do, lse, delta, causal, products, bq=64,
                    bk=32):
    """csrc/flash_attention_bwd.cu's dK/dV arithmetic on [B, S, H, D]
    inputs, but for the tensor cores' truncating sums (see _mm_tf32): per
    tile of 32 keys (K and V zero past sk), the query tiles of 64 from the
    first that reaches the causal diagonal (Q and dO zero past sq); Sᵀ =
    K·Qᵀ and dPᵀ = V·dOᵀ in TF32 products; s = Sᵀ·scale, DEFAULT_MASK_VALUE
    past the diagonal; p = exp(s - lse) and dS = p·(dPᵀ - delta)·scale in
    float32, lse and delta by the column (the query), both 0 for queries
    past sq and keys past sk; dV += Pᵀ·dO and dK += dSᵀ·Q in TF32
    products."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / np.sqrt(d)
    nq, nk = -(-sq // bq), -(-sk // bk)

    def pad(x, n):
        return torch.nn.functional.pad(
            x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d),
            (0, 0, 0, n - x.shape[1]))
    qp, dop = pad(q, nq * bq), pad(do, nq * bq)
    kp, vp = pad(k, nk * bk), pad(v, nk * bk)
    row_pad = (0, nq * bq - sq)
    lse_p = torch.nn.functional.pad(lse, row_pad)
    delta_p = torch.nn.functional.pad(delta, row_pad)
    dk = torch.zeros(b * h, nk * bk, d)
    dv = torch.zeros(b * h, nk * bk, d)
    for kt in range(nk):
        k0 = kt * bk
        keys = torch.arange(k0, k0 + bk)[:, None]
        kt_, vt_ = kp[:, k0:k0 + bk], vp[:, k0:k0 + bk]
        first = max(0, k0 - (sk - sq)) // bq if causal else 0
        acc_k = torch.zeros(b * h, bk, d)
        acc_v = torch.zeros(b * h, bk, d)
        for qt in range(first, nq):
            q0 = qt * bq
            qt_, dot_ = qp[:, q0:q0 + bq], dop[:, q0:q0 + bq]
            s = _mm_tf32(kt_, qt_.transpose(1, 2), products) * scale
            dp = _mm_tf32(vt_, dot_.transpose(1, 2), products)
            queries = torch.arange(q0, q0 + bq)[None, :]
            if causal:
                s = torch.where(keys > queries + (sk - sq),
                                tfa.DEFAULT_MASK_VALUE, s)
            valid = (queries < sq) & (keys < sk)
            p = torch.where(valid, torch.exp(s - lse_p[:, None, q0:q0 + bq]),
                            0.0)
            ds = torch.where(
                valid, p * (dp - delta_p[:, None, q0:q0 + bq]) * scale, 0.0)
            acc_v = _mm_tf32(p, dot_, products, acc_v)
            acc_k = _mm_tf32(ds, qt_, products, acc_k)
        dk[:, k0:k0 + bk] = acc_k
        dv[:, k0:k0 + bk] = acc_v
    return tuple(x[:, :sk].reshape(b, h, sk, d).permute(0, 2, 1, 3)
                 for x in (dk, dv))


@pytest.mark.parametrize("sq,sk,d,causal", [
    (128, 128, 256, True),    # the training step's head_dim, two query tiles
    (100, 230, 64, True),     # sq < sk, an offset of 130: not whole tiles
    (70, 150, 128, False),    # sk not a multiple of the key tile of 32
])
def test_3xtf32_holds_flash_dkv_to_its_limit(sq, sk, d, causal):
    """The dK/dV kernel's arithmetic, emulated (its four products in
    3xTF32 with a fresh fragment a k8 step, query tiles of 64 from the
    causal start with their masks, p and dS in float32), keeps dK and dV
    within half the 1e-4 limit of the plain version; with one TF32
    product one of them falls outside the limit."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(sq + sk + d + 1, 1, sq, sk, 2, d))
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, causal=causal)
    delta = tfa.flash_attention_bwd_delta(o, do)
    want = tfa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal=causal)

    def shares(got):
        return [float(((g - w).abs()
                       / (BWD_LIMIT["atol"] + BWD_LIMIT["rtol"] * w.abs()))
                      .max()) for g, w in zip(got, want)]
    assert max(shares(_flash_dkv_tf32(q, k, v, do, lse, delta, causal,
                                      3))) <= 0.5
    assert max(shares(_flash_dkv_tf32(q, k, v, do, lse, delta, causal,
                                      1))) > 1

def _kv_swizzle(d, r):
    """csrc/flash_attention_bwd.cu's kv_swizzle: K's and V's 16-byte
    chunk c of key row r sits at chunk c ^ _kv_swizzle(d, r)."""
    lo = (r >> 2) & 1
    return (lo if d == 256 else lo << 1) | ((((r >> 3) ^ r) & 1) << 2)


def _most_on_one_bank(addrs, width):
    """The most distinct words one bank serves in one phase of a warp's
    shared-memory access of `width` words a lane at word addresses
    `addrs`: a quarter warp a phase for 16-byte accesses, half a warp
    for 8-byte ones."""
    per = {4: 8, 2: 16, 1: 32}[width]
    most = 0
    for p in range(0, 32, per):
        banks = {}
        for a in addrs[p:p + per]:
            for w in range(a, a + width):
                banks.setdefault(w % 32, set()).add(w)
        most = max(most, max(len(v) for v in banks.values()))
    return most


@pytest.mark.parametrize("d", [64, 128, 256])
def test_kv_swizzle_keeps_both_reads_of_k_on_distinct_banks(d):
    """The dQ kernel's layout of a key tile (32 rows at a pitch of d
    floats, chunks swizzled) is a permutation of each row's chunks, and
    both of its reads of K take one wavefront a phase: along the rows
    (Q·Kᵀ's B operand: lane (g, t) reads chunk d0 / 4 + t of row 16 sn +
    8 j + g) and down them (dS·K's: row k0 + 4 t + 2 st + e, the lane's
    d / 32 columns from d / 4 wn + d / 32 g, in 16-byte reads, 8-byte at
    d 64)."""
    nt = d // 32
    for r in range(32):
        assert sorted(c % 8 ^ _kv_swizzle(d, r) | c // 8 * 8
                      for c in range(d // 4)) == list(range(d // 4))
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for sn, j, d0 in itertools.product(range(2), range(2), range(0, d, 16)):
        addrs = [(16 * sn + 8 * j + g) * d
                 + 4 * ((d0 // 4 + t) ^ _kv_swizzle(d, 16 * sn + 8 * j + g))
                 for g, t in lanes]
        assert _most_on_one_bank(addrs, 4) == 1
    for wn, k0, st, e, c in itertools.product(
            range(4), (0, 16), range(2), range(2), range(max(1, nt // 4))):
        addrs = []
        for g, t in lanes:
            r, col = k0 + 4 * t + 2 * st + e, wn * (d // 4) + nt * g
            chunk = (col // 4 + c if nt >= 4 else col // 4) ^ _kv_swizzle(d, r)
            addrs.append(r * d + 4 * chunk + (0 if nt >= 4 else col % 4))
        assert _most_on_one_bank(addrs, 4 if nt >= 4 else 2) == 1


@pytest.mark.parametrize("d", [64, 128, 256])
def test_kv_swizzle_keeps_the_dkv_kernels_reads_on_distinct_banks(d):
    """The dK/dV kernel's layouts. Its query tile (64 rows of Q or dO at a
    pitch of d floats, chunks swizzled, copied as two 32-row halves with
    the halves' own row numbers) lands each chunk once, and both of its
    reads take one wavefront a phase: along the rows (Sᵀ's and dPᵀ's B
    operand: lane (g, t) reads chunk d0 / 4 + t of row 16 sn + 8 j + g, sn
    0..3) and down them (dV's and dK's: row k0 + 4 t + 2 st + e, k0 0..48,
    the lane's d / 32 columns from d / 4 wn + d / 32 g). K and V (32 rows
    at a pitch of d + 16), the A operand of Sᵀ and dPᵀ, and Pᵀ and dSᵀ (32
    rows at a pitch of 80), the A operand of dV and dK, are read in one
    wavefront a phase too (lane (g, t): rows r0 + g and r0 + g + 8, chunk t
    of a k16 block); Pᵀ's and dSᵀ's float2 stores at most two ways."""
    nt, lp = d // 32, 64 + 16
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    landed = {}
    for half, i, e in itertools.product(range(2), range(256),
                                        range(d // 32)):
        r, c0 = i // 8, i % 8   # copy_rows: 8 threads a row
        row, chunk = 32 * half + r, c0 + 8 * e
        at = (row, (c0 ^ _kv_swizzle(d, r)) + 8 * e)
        assert at not in landed
        landed[at] = (row, chunk)
        assert at[1] == chunk ^ _kv_swizzle(d, row)   # where reads look
    assert len(landed) == 64 * d // 4
    for sn, j, d0 in itertools.product(range(4), range(2), range(0, d, 16)):
        addrs = [(16 * sn + 8 * j + g) * d
                 + 4 * ((d0 // 4 + t) ^ _kv_swizzle(d, 16 * sn + 8 * j + g))
                 for g, t in lanes]
        assert _most_on_one_bank(addrs, 4) == 1
    for wn, k0, st, e, c in itertools.product(
            range(4), range(0, 64, 16), range(2), range(2),
            range(max(1, nt // 4))):
        addrs = []
        for g, t in lanes:
            r, col = k0 + 4 * t + 2 * st + e, wn * (d // 4) + nt * g
            chunk = (col // 4 + c if nt >= 4 else col // 4) ^ _kv_swizzle(d, r)
            addrs.append(r * d + 4 * chunk + (0 if nt >= 4 else col % 4))
        assert _most_on_one_bank(addrs, 4 if nt >= 4 else 2) == 1
    for pitch, width in ((d + 16, d), (lp, 64)):
        for wm, h, k0 in itertools.product(range(2), range(2),
                                           range(0, width, 16)):
            addrs = [(16 * wm + g + 8 * h) * pitch + k0 + 4 * t
                     for g, t in lanes]
            assert _most_on_one_bank(addrs, 4) == 1
    for wm, wn, j, hr in itertools.product(range(2), range(4), range(2),
                                           range(2)):
        addrs = [(16 * wm + g + 8 * hr) * lp + 16 * wn + 8 * j + 2 * t
                 for g, t in lanes]
        assert _most_on_one_bank(addrs, 2) <= 2
