"""The bfloat16 flash-attention kernels (csrc/flash_attention_bf16.cu) on
the CPU: their arithmetic, emulated, against the plain versions, and the
plain versions in bfloat16 against the JAX package's functions.

The kernels multiply bf16 operands exactly on the tensor cores and add
in float32; they round two float32 tiles to bf16 before multiplying
them: P (for P V and P^T dO) and dS (for dS K and dS^T Q), and write O,
dQ, dK and dV once as bf16. ``_fwd_bf16`` / ``_bwd_bf16`` repeat that
arithmetic in float32 PyTorch on bf16 inputs made from numpy seeds: the
forward's online softmax in the log2 domain over the key tiles the
kernel walks (``KEY_TILE``), the backward's p = 2^(s scale log2 e - lse
log2 e) (dQ's and dK/dV's alike), dQ's sums over the key tiles its
kernel streams (``DQ_KEY_TILE``) and dK/dV's over the query tiles
(``DKV_QUERY_TILE``), each tile's products added in float32.

Limits, as chip_smoke.py and tests/test_torch_gpu.py hold the kernels on
the card (bf16's unit roundoff is 2^-8): O, dQ, dK and dV within
2^-7 max|plain| + 2^-7 |plain| of the plain version (the output's own
rounding is up to 2^-8 |plain|, P's and dS's roundings add errors of
2^-8 of single terms); lse, float32 in both, within atol = rtol = 1e-4.
The emulation must stay within half of them (it measured up to 0.45 on
the card and in the g++ emulation of the source,
scripts/emulate_flash_bf16_cpu.py). The plain versions in bf16 against
the JAX package's (mha_reference, the Pallas kernels in interpret mode,
the XLA backward) are held to the same limits.
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
torch.set_num_threads(2)

BF16_REL = 2.0 ** -7
LSE_TOL = 1e-4
LOG2E = 1.4426950408889634
# the kernels' tiles at each head_dim (csrc/flash_attention_bf16.cu): the
# forward's keys a tile (kFwdBK), dQ's (kDqBK), dK/dV's query rows a tile
# (kDkvBQ)
KEY_TILE = {64: 64, 128: 64, 256: 64}
DQ_KEY_TILE = {64: 64, 128: 64, 256: 64}
DKV_QUERY_TILE = {64: 64, 128: 64, 256: 64}

CASES = [  # b, sq, sk, h, d, causal
    (1, 64, 64, 2, 64, True),
    (2, 77, 77, 1, 128, True),     # 77: neither tile divides it
    (1, 40, 100, 2, 64, False),
    (1, 96, 130, 1, 256, True),    # sq < sk: bottom-right causal
    (2, 128, 128, 2, 64, False),
    (1, 200, 200, 2, 256, True),   # 200: a second block half empty
    (1, 90, 256, 2, 256, True),    # sq < sk, sq not a multiple of 64
]


def _inputs(seed, b, sq, sk, h, d):
    """q, k, v, dO in bf16 from a numpy seed."""
    rng = np.random.RandomState(seed)
    shapes = ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d), (b, sq, h, d))
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).bfloat16()
            for s in shapes]


def _share(got, want, tol=None) -> float:
    """Largest |got - want| over the limit (module docstring)."""
    got, want = got.float(), want.float()
    if tol is None:
        lim = BF16_REL * want.abs().max() + BF16_REL * want.abs()
    else:
        lim = tol + tol * want.abs()
    return float(((got - want).abs() / lim).max())


def _bf16(x):
    return x.bfloat16().float()


def _scores(q, k, causal, scale, q_off, k0=0):
    """[B, H, Sq, Kt] f32 scores of q against the keys k0.. of k, entries
    past the bottom-right aligned causal diagonal (query i at key position
    i + q_off) set to DEFAULT_MASK_VALUE."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(q.shape[1])[:, None] + q_off
        kpos = torch.arange(k0, k0 + k.shape[1])[None, :]
        s = torch.where(kpos <= qpos, s, tfa.DEFAULT_MASK_VALUE)
    return s


def _fwd_bf16(q, k, v, causal):
    """The forward kernel's arithmetic: its key tiles with the online
    softmax in float32 in the log2 domain (scores times scale log2 e, p =
    2^(x - m)), P rounded to bf16 for P V, O = acc / l rounded to bf16,
    lse = m ln 2 + log l."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    tile = KEY_TILE[d]
    m = torch.full((b, h, sq, 1), -float("inf"))
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, sk, tile):
        # the masked value stays kMaskValue, as the kernel sets it after
        # scaling
        s = _scores(q, k[:, k0:k0 + tile], causal, d ** -0.5 * LOG2E,
                    sk - sq, k0)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.where(m == -float("inf"), torch.zeros(()),
                            torch.exp2(m - m_new))
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bkhd->bhqd", _bf16(p), v[:, k0:k0 + tile].float())
        m = m_new
    o = (acc / l).permute(0, 2, 1, 3).bfloat16()
    return o, (m * LOG2E ** -1 + torch.log(l)).reshape(b * h, sq)


def _bwd_bf16(q, k, v, do, lse, delta, causal):
    """The backward kernels' arithmetic: p = 2^(s scale log2 e - lse log2
    e) and dS = p (dP - delta) scale in float32; dQ = round(dS) K summed
    tile by tile over dQ's key tiles, dK = round(dS)^T Q and dV =
    round(P)^T dO over dK/dV's query tiles, each in float32, and rounded
    to bf16."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5
    lse4 = lse.reshape(b, h, sq, 1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    delta4 = delta.reshape(b, h, sq, 1)
    p = torch.exp2(_scores(q, k, causal, scale * LOG2E, sk - sq)
                   - lse4 * LOG2E)
    ds = _bf16(p * (dp - delta4) * scale)
    dq = torch.zeros(b, sq, h, d)
    tile = DQ_KEY_TILE[d]
    for k0 in range(0, sk, tile):
        keys = slice(k0, k0 + tile)
        dq += torch.einsum("bhqk,bkhd->bqhd", ds[..., keys],
                           k[:, keys].float())
    dk = torch.zeros(b, sk, h, d)
    dv = torch.zeros(b, sk, h, d)
    tile = DKV_QUERY_TILE[d]
    for q0 in range(0, sq, tile):
        rows = slice(q0, q0 + tile)
        dk += torch.einsum("bhqk,bqhd->bkhd", ds[:, :, rows],
                           q[:, rows].float())
        dv += torch.einsum("bhqk,bqhd->bkhd", _bf16(p[:, :, rows]),
                           do[:, rows].float())
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("b,sq,sk,h,d,causal", CASES)
def test_bf16_arithmetic_holds_the_plain_versions(b, sq, sk, h, d, causal):
    """The three kernels' bf16 arithmetic, emulated, within half of
    their limits of the plain versions; the plain versions' outputs are
    bf16 (lse float32), as the kernels'."""
    q, k, v, do = _inputs(sq * 31 + sk + d, b, sq, sk, h, d)
    ro, rlse = tfa.flash_attention_fwd_reference(q, k, v, causal=causal)
    delta = tfa.flash_attention_bwd_delta(ro, do)
    want = tfa.flash_attention_bwd_reference(q, k, v, ro, rlse, do,
                                             causal=causal)
    assert ro.dtype == torch.bfloat16 and rlse.dtype == torch.float32
    assert all(w.dtype == torch.bfloat16 for w in want)
    assert delta.dtype == torch.float32
    o, lse = _fwd_bf16(q, k, v, causal)
    assert _share(o, ro) <= 0.5
    assert _share(lse, rlse, LSE_TOL) <= 0.5
    for got, w in zip(_bwd_bf16(q, k, v, do, rlse, delta, causal), want):
        assert _share(got, w) <= 0.5


def _jnp(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def _np(x):
    return torch.from_numpy(np.asarray(x).astype(np.float32))


@pytest.mark.parametrize("b,sq,sk,h,d,causal", CASES[:3] + CASES[-1:])
def test_plain_versions_in_bf16_match_jax(b, sq, sk, h, d, causal):
    """The plain versions take bf16 as the JAX package's functions do:
    the forward against mha_reference and, where the Pallas backend
    imports, the Pallas forward in interpret mode; the backward against
    the JAX backward rule's XLA path (its chunked scan, float32 inside,
    outputs in the inputs' dtype), all on bf16 inputs."""
    q, k, v, do = _inputs(sq + 3 * sk + d, b, sq, sk, h, d)
    ro, rlse = tfa.flash_attention_fwd_reference(q, k, v, causal=causal)
    jo = jfa.mha_reference(_jnp(q), _jnp(k), _jnp(v), causal=causal)
    assert jo.dtype == jnp.bfloat16
    assert _share(_np(jo), ro.float()) <= 0.5
    if jfa._HAS_PLTPU:
        po = jfa.flash_attention(_jnp(q), _jnp(k), _jnp(v), causal=causal,
                                 interpret=True)
        assert po.dtype == jnp.bfloat16
        assert _share(_np(po), ro.float()) <= 0.5
    scale = d ** -0.5
    lse3 = jnp.asarray(rlse.numpy()).reshape(b * h, sq, 1)
    res = (_jnp(q), _jnp(k), _jnp(v), _jnp(ro), lse3)
    with jax.default_device(jax.devices("cpu")[0]):
        jgrads = jfa._flash_bwd_rule(scale, causal, 128, 128, False, res,
                                     _jnp(do))
    got = tfa.flash_attention_bwd_reference(q, k, v, ro, rlse, do,
                                            causal=causal)
    for name, g, w in zip("qkv", got, jgrads):
        assert w.dtype == jnp.bfloat16, name
        assert _share(g, _np(w)) <= 0.5, f"d{name}"


def test_wrappers_keep_bf16_on_the_cpu():
    """On the CPU the wrappers of both dtypes run the plain versions in
    the inputs' dtype and count no launch; FlashAttention's gradients of
    bf16 inputs are bf16."""
    q, k, v, do = _inputs(5, 1, 48, 48, 2, 64)
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv", "flash_attention_fwd_bf16",
             "flash_attention_bwd_dq_bf16", "flash_attention_bwd_dkv_bf16")
    before = [getattr(tfa, n).launches for n in names]
    o, lse = tfa.flash_attention_fwd_bf16(q, k, v, causal=True)
    o2, _ = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert o.dtype == torch.bfloat16 and torch.equal(o, o2)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    tfa.FlashAttention.apply(*leaves, True, None).backward(do)
    want = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16
        assert torch.equal(leaf.grad, w)
    assert [getattr(tfa, n).launches for n in names] == before


def test_ml_dtypes_bf16_is_the_torch_bf16():
    """The JAX side's bf16 (ml_dtypes) and torch's have the same bits, so
    the comparisons above compare like with like."""
    x = np.random.RandomState(0).randn(64).astype(np.float32)
    a = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    b = torch.from_numpy(x).bfloat16().view(torch.int16).numpy()
    assert np.array_equal(a, b.view(np.uint16))
