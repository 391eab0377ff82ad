"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

They skip where no CUDA device is present, and import no JAX, so that on
a machine with a card and without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the card, at the
serving and training paths' shapes and at small ragged ones; the plain
versions are held against the JAX package by
tests/test_torch_flash_attention.py and tests/test_torch_flash_backward.py.
Tolerance: float32 on both sides with TF32 off, sums in another order,
so atol = rtol = 1e-5; the backward kernels 1e-4, since each dK/dV entry
sums up to S products in another order.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa

pytestmark = pytest.mark.gpu

TOL = dict(atol=1e-5, rtol=1e-5)
BWD_TOL = dict(atol=1e-4, rtol=1e-4)


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


@pytest.mark.parametrize("b,sq,sk,h,d,causal", [
    (1, 128, 128, 8, 256, True),
    (1, 1024, 1024, 8, 256, True),   # the training path's shape, per batch
    (2, 77, 77, 3, 64, True),        # ragged, partial tiles
    (1, 5, 300, 2, 128, True),       # sq < sk: bottom-right causal
    (2, 100, 33, 2, 256, False),     # sq > sk, not causal
])
def test_flash_backward_kernels_match_plain(cuda, b, sq, sk, h, d, causal):
    gen = torch.Generator().manual_seed(sq * 5 + sk)
    q, do = _randn(gen, b, sq, h, d), _randn(gen, b, sq, h, d)
    k, v = _randn(gen, b, sk, h, d), _randn(gen, b, sk, h, d)
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
    delta = fa.flash_attention_bwd_delta(o, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                        causal=causal)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                            causal=causal)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, **BWD_TOL)


def test_flash_autograd_on_the_card_matches_plain_autograd(cuda):
    """dot_product_attention on CUDA goes through FlashAttention: one
    forward and one launch of each backward kernel per call, gradients
    equal to autograd through mha_reference."""
    gen = torch.Generator().manual_seed(9)
    q, k, v, do = (_randn(gen, 2, 200, 4, 128) for _ in range(4))
    counts = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fa.dot_product_attention(*leaves, causal=True).backward(do)
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fa.mha_reference(*refs, causal=True).backward(do)
    for got, ref in zip(leaves, refs):
        torch.testing.assert_close(got.grad, ref.grad, **BWD_TOL)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in
                                                          counts)


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
                 "flash_attention_bwd_dq_reference",
                 "flash_attention_bwd_dkv_reference",
                 "flash_attention_bwd_reference",
                 "paged_attention_reference"):
        monkeypatch.setattr(fa, name, boom)
    gen = torch.Generator().manual_seed(0)
    q = _randn(gen, 1, 64, 2, 128)
    n_flash = fa.flash_attention_fwd.launches
    n_bwd = (fa.flash_attention_bwd_dq.launches,
             fa.flash_attention_bwd_dkv.launches)
    leaf = q.clone().requires_grad_(True)
    fa.dot_product_attention(leaf, q, q, causal=True).sum().backward()
    fa.flash_attention_fwd(q, q, q)
    assert fa.flash_attention_fwd.launches == n_flash + 2
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (n_bwd[0] + 1,
                                                     n_bwd[1] + 1)
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


def test_training_on_the_card_matches_the_cpu(cuda):
    """The same program and startup state on the card and on the CPU:
    two Adam steps agree (float32 through two layers, sums in other
    orders): losses within rtol 1e-4, every state element within 1e-5,
    and each parameter's update and each Adam moment within 1e-3 as rms,
    as tests/test_torch_executor.py holds the port to the JAX package
    (the key biases, whose gradient is zero in exact arithmetic, by the
    1e-5 alone). Each step launched the backward kernels once per
    layer."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.transformer import transformer_lm_loss

    cfg = dict(vocab_size=300, seq_len=64, n_layers=2, d_model=256,
               n_heads=2, d_ff=512, max_len=64)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        avg, _ = transformer_lm_loss(**cfg)
        pt.optimizer.AdamOptimizer(learning_rate=1e-4).minimize(avg)
    cpu_exe, cpu_scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    gpu_exe, gpu_scope = pt.Executor(), pt.Scope()
    names = sorted(cpu_scope.local_var_names())
    start = {n: cpu_scope.get_numpy(n) for n in names}
    for n in names:
        gpu_scope.set_var(n, cpu_scope.find_var(n).to(gpu_exe.device))
    rng = np.random.RandomState(0)
    n_bwd = fa.flash_attention_bwd_dkv.launches
    for _ in range(2):
        src = rng.randint(0, 64, (2, 64)).astype(np.int64)
        feed = {"src_ids": src, "tgt_ids": src[..., None]}
        lc, = cpu_exe.run(main, feed=feed, fetch_list=[avg], scope=cpu_scope)
        lg, = gpu_exe.run(main, feed=feed, fetch_list=[avg], scope=gpu_scope)
        np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert fa.flash_attention_bwd_dkv.launches == n_bwd + 2 * 2

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a.astype(np.float64)))))

    for n in names:
        got, want = gpu_scope.get_numpy(n), cpu_scope.get_numpy(n)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=n)
        if n.split("_moment")[0].endswith("_k_b"):
            continue
        if not ("_moment" in n or "_pow_acc" in n):
            got, want = got - start[n], want - start[n]
        assert rms(got - want) <= 1e-3 * rms(want), n
