"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

They skip where no CUDA device is present, and import no JAX, so that on
a machine with a card and without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the card, at the
serving path's shapes and at small ragged ones; the plain versions are
held against the JAX package by tests/test_torch_flash_attention.py.
Tolerance: float32 on both sides with TF32 off, sums in another order,
so atol = rtol = 1e-5.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa

pytestmark = pytest.mark.gpu

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen).cuda()


@pytest.mark.parametrize("b,sq,sk,h,d,causal", [
    (1, 128, 128, 8, 256, True),     # the smallest prefill bucket
    (1, 1024, 1024, 8, 256, True),   # the largest
    (2, 77, 77, 3, 64, True),        # ragged, one partial tile
    (1, 5, 300, 2, 128, True),       # sq < sk: bottom-right causal
    (2, 100, 33, 2, 256, False),     # sq > sk, not causal
])
def test_flash_kernel_matches_plain(cuda, b, sq, sk, h, d, causal):
    gen = torch.Generator().manual_seed(sq * 7 + sk)
    q = _randn(gen, b, sq, h, d)
    k, v = _randn(gen, b, sk, h, d), _randn(gen, b, sk, h, d)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
    torch.testing.assert_close(o, ro, **TOL)
    torch.testing.assert_close(lse, rlse, **TOL)
    torch.testing.assert_close(
        fa.dot_product_attention(q, k, v, causal=causal),
        fa.mha_reference(q, k, v, causal=causal), **TOL)


def _paged_case(gen, s, h, d, nb, bs, lens):
    mb = -(-max(lens) // bs) + 1
    perm = torch.randperm(nb - 1, generator=gen) + 1
    tables = torch.zeros(s, mb, dtype=torch.int32)
    used = 0
    for i, n in enumerate(lens):
        need = -(-n // bs)
        tables[i, :need] = perm[used:used + need]
        used += need
    return (_randn(gen, s, h, d), _randn(gen, nb, bs, h, d),
            _randn(gen, nb, bs, h, d), tables.cuda(),
            torch.tensor(lens, dtype=torch.int32).cuda())


@pytest.mark.parametrize("s,h,d,nb,bs,lens", [
    (8, 8, 256, 513, 16, [1024, 1, 17, 500, 0, 999, 64, 777]),
    (3, 2, 128, 12, 8, [13, 0, 40]),
    (2, 1, 256, 30, 4, [65, 3]),
])
def test_paged_kernel_matches_plain(cuda, s, h, d, nb, bs, lens):
    gen = torch.Generator().manual_seed(nb)
    args = _paged_case(gen, s, h, d, nb, bs, lens)
    out = fa.paged_decode_attention(*args)
    torch.testing.assert_close(out, fa.paged_attention_reference(*args),
                               **TOL)
    for i, n in enumerate(lens):
        if n == 0:
            assert bool((out[i] == 0).all())


def test_wrappers_never_fall_back(cuda, monkeypatch):
    """With every plain version patched to raise, CUDA calls still
    succeed and count one launch each."""
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in ("mha_reference", "flash_attention_fwd_reference",
                 "paged_attention_reference"):
        monkeypatch.setattr(fa, name, boom)
    gen = torch.Generator().manual_seed(0)
    q = _randn(gen, 1, 64, 2, 128)
    n_flash = fa.flash_attention_fwd.launches
    fa.dot_product_attention(q, q, q, causal=True)
    fa.flash_attention_fwd(q, q, q)
    assert fa.flash_attention_fwd.launches == n_flash + 2
    n_paged = fa.paged_decode_attention.launches
    fa.paged_decode_attention(*_paged_case(gen, 2, 2, 128, 6, 8, [9, 0]))
    assert fa.paged_decode_attention.launches == n_paged + 1
    torch.cuda.synchronize()


def test_kernels_refuse_what_they_do_not_take(cuda):
    gen = torch.Generator().manual_seed(1)
    q = _randn(gen, 1, 64, 2, 128)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.bfloat16(), q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError):
        t = q.transpose(1, 2)
        fa.flash_attention_fwd(t, t, t)
    with pytest.raises(ValueError):
        fa.dot_product_attention(q, q, q, bias=torch.zeros(64, 64).cuda())
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, q[:, :32], q[:, :32], causal=True)
    with pytest.raises(ValueError):
        x = _randn(gen, 1, 8, 2, 32)
        fa.flash_attention_fwd(x, x, x)
    args = list(_paged_case(gen, 2, 2, 128, 6, 8, [9, 3]))
    bad = list(args)
    bad[1] = args[1].double()
    with pytest.raises(TypeError):
        fa.paged_decode_attention(*bad)
    bad = list(args)
    bad[3] = args[3].long()
    with pytest.raises(TypeError):
        fa.paged_decode_attention(*bad)
    bad = list(args)
    bad[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        fa.paged_decode_attention(*bad)


def test_decode_model_cuda_matches_cpu(cuda, tmp_path):
    """A small bundle (head_dim 128, so both kernels take it) served on the
    card agrees with the same bundle on the CPU: prefill logits and K/V,
    then decode-step logits and the pools after their writes. Whole-model
    float32 in two summation orders: atol = rtol = 1e-4."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.models.transformer import param_shapes
    from paddle_tpu_torch.serving.decode import DecodeModel

    cfg = dict(vocab_size=101, n_layers=2, d_model=256, n_heads=2, d_ff=512,
               max_context=96)
    rng = np.random.default_rng(0)
    params = {n: (0.05 * rng.standard_normal(s)).astype(np.float32)
              for n, s in param_shapes(cfg).items()}
    io.export_decode_model(str(tmp_path), cfg, params=params,
                           length_buckets=(32, 96), slots=3, block_size=8,
                           pool_blocks=20)
    models = [DecodeModel(str(tmp_path), device=dev, warmup=False)
              for dev in ("cpu", cuda)]
    prompt = rng.integers(1, 101, 37).tolist()
    outs = [m.prefill(prompt) for m in models]
    np.testing.assert_allclose(outs[1][0], outs[0][0], atol=1e-4, rtol=1e-4)
    for (kc, vc), (kg, vg) in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(kg.cpu(), kc, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(vg.cpu(), vc, atol=1e-4, rtol=1e-4)
    blocks = list(range(1, 1 + -(-45 // 8)))
    for m, (_, kv) in zip(models, outs):
        m.seed_sequence(blocks, kv)
    n_paged = fa.paged_decode_attention.launches
    for step in range(6):
        tokens = np.array([5 + step, 7, 0], np.int64)
        lens = np.array([38 + step, 39 + step, 0], np.int32)
        tables = np.zeros((3, models[0].max_blocks_per_seq), np.int32)
        tables[0, :len(blocks)] = blocks
        tables[1, :len(blocks)] = blocks
        logits = [m.decode_step(tokens, lens, tables) for m in models]
        np.testing.assert_allclose(logits[1], logits[0], atol=1e-4,
                                   rtol=1e-4)
    assert fa.paged_decode_attention.launches == n_paged + 6 * 2
    for pc, pg in zip(models[0]._pools, models[1]._pools):
        torch.testing.assert_close(pg.cpu(), pc, atol=1e-4, rtol=1e-4)
