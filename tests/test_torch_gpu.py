"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

They skip where no CUDA device is present, and import no JAX, so that on
a machine with a card and without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the card, at the
serving and training paths' shapes and at small ragged ones; the plain
versions are held against the JAX package by
tests/test_torch_flash_attention.py, tests/test_torch_flash_backward.py,
tests/test_torch_fused_conv.py, tests/test_torch_lstm.py and
tests/test_torch_fused_block.py. Tolerance: float32 on both sides with
TF32 off (products and convolutions), sums in another order, so atol =
rtol = 1e-5; the backward kernels 1e-4, since each dK/dV entry sums up to
S products in another order; the channel sums as chip_smoke.py holds
them (the sum of squares within rtol 1e-5, the sum within 1e-5 of the
sum of |a|); the LSTM forward 1e-5 and its backward 1e-4 (dW sums T*B
products in another order); the bottleneck chain's forward outputs
1e-5, its backward's elementwise outputs 1e-4 (g3 bitwise), and every
sum of the chain within 1e-5 of the sum of its terms' magnitudes.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_block as fb
from paddle_tpu_torch.kernels import fused_conv as fc
from paddle_tpu_torch.kernels import fused_lstm as fl

pytestmark = pytest.mark.gpu

TOL = dict(atol=1e-5, rtol=1e-5)
BWD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen).cuda()


def _kernels_of(fn, calls: int, per_call: int = 1):
    """Names of the CUDA kernels that `calls` calls of fn launched, by
    torch.profiler. The profiler on the card at times drops kernel events
    of a session (chip_smoke.device_host takes such a profile again): a
    profile that holds fewer events than calls x per_call is taken again,
    up to five times; one that holds as many or more is returned at
    once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if len(names) >= calls * per_call:
            break
    return names


@pytest.mark.parametrize("b,sq,sk,h,d,causal", [
    (1, 128, 128, 8, 256, True),     # the smallest prefill bucket
    (1, 1024, 1024, 8, 256, True),   # the largest
    (2, 77, 77, 3, 64, True),        # ragged, one partial tile
    (1, 5, 300, 2, 128, True),       # sq < sk: bottom-right causal
    (2, 100, 33, 2, 256, False),     # sq > sk, not causal
    (1, 100, 230, 2, 256, True),     # causal sq < sk, offset 130: not whole tiles
    (2, 70, 150, 2, 64, False),      # sk % 64 != 0, not causal
    (2, 70, 150, 2, 128, False),
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


def test_flash_kernel_at_the_training_shape_is_repeatable(cuda):
    """B 8, S 1024, H 8, D 256, causal (an LM training step's shape): two
    calls are bit-identical, and within TOL of the plain version."""
    gen = torch.Generator().manual_seed(13)
    q, k, v = (_randn(gen, 8, 1024, 8, 256) for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, causal=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    torch.testing.assert_close(o, ro, **TOL)
    torch.testing.assert_close(lse, rlse, **TOL)


@pytest.mark.parametrize("b,sq,sk,h,d,causal", [
    (1, 128, 128, 8, 256, True),
    (1, 1024, 1024, 8, 256, True),   # the training path's shape, per batch
    (2, 77, 77, 3, 64, True),        # ragged, partial tiles
    (1, 5, 300, 2, 128, True),       # sq < sk: bottom-right causal
    (2, 100, 33, 2, 256, False),     # sq > sk, not causal
    (1, 100, 230, 2, 64, True),      # causal sq < sk, offset 130: not whole tiles
    (2, 70, 150, 2, 128, False),     # sk % 32 != 0, not causal
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


def test_flash_dq_kernel_at_the_training_shape_is_repeatable(cuda):
    """B 8, S 1024, H 8, D 256, causal (an LM training step's shape): two
    calls of the dQ kernel are bit-identical, and within BWD_TOL of the
    plain version."""
    gen = torch.Generator().manual_seed(14)
    q, k, v, do = (_randn(gen, 8, 1024, 8, 256) for _ in range(4))
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    delta = fa.flash_attention_bwd_delta(o, do)
    args = (q, k, v, do, lse, delta)
    dq = fa.flash_attention_bwd_dq(*args, causal=True)
    assert torch.equal(dq, fa.flash_attention_bwd_dq(*args, causal=True))
    torch.testing.assert_close(
        dq, fa.flash_attention_bwd_dq_reference(*args, causal=True),
        **BWD_TOL)


def test_flash_dkv_kernel_at_the_training_shape_is_repeatable(cuda):
    """B 8, S 1024, H 8, D 256, causal (an LM training step's shape): two
    calls of the dK/dV kernel are bit-identical, and dK and dV within
    BWD_TOL of the plain version."""
    gen = torch.Generator().manual_seed(15)
    q, k, v, do = (_randn(gen, 8, 1024, 8, 256) for _ in range(4))
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    delta = fa.flash_attention_bwd_delta(o, do)
    args = (q, k, v, do, lse, delta)
    dk, dv = fa.flash_attention_bwd_dkv(*args, causal=True)
    dk2, dv2 = fa.flash_attention_bwd_dkv(*args, causal=True)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    rk, rv = fa.flash_attention_bwd_dkv_reference(*args, causal=True)
    torch.testing.assert_close(dk, rk, **BWD_TOL)
    torch.testing.assert_close(dv, rv, **BWD_TOL)


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


def _paged_case(gen, s, h, d, nb, bs, lens, mb=None):
    mb = mb or -(-max(lens) // bs) + 1
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


def _paged_want(args):
    """The plain version on the table with out-of-range ids set to 0, the
    null block the kernel reads for them."""
    q, kp, vp, tables, lens = args
    safe = torch.where((tables < 0) | (tables >= kp.shape[0]), 0, tables)
    return fa.paged_attention_reference(q, kp, vp, safe, lens)


@pytest.mark.parametrize("d,bs", [(128, 4), (256, 8), (128, 16), (256, 16)])
def test_paged_kernel_at_the_split_edges(cuda, d, bs):
    """Lengths 0, 1, P - 1, P, P + 1 and the table's whole capacity (a
    slot at full capacity), P the kernel's keys a split; two calls give
    the same bits."""
    p = fa.paged_split_plan(1)[0]
    cap = -(-(3 * p + 5) // bs) * bs
    lens = [0, 1, p - 1, p, p + 1, cap]
    nb = 2 + sum(-(-n // bs) for n in lens)
    gen = torch.Generator().manual_seed(d + bs)
    args = _paged_case(gen, 6, 2, d, nb, bs, lens, mb=cap // bs)
    out = fa.paged_decode_attention(*args)
    again = fa.paged_decode_attention(*args)
    torch.testing.assert_close(out, fa.paged_attention_reference(*args),
                               **TOL)
    assert bool((out[0] == 0).all())
    assert torch.equal(out, again)


@pytest.mark.parametrize("d", [128, 256])
def test_paged_kernel_reads_the_null_block_for_ids_out_of_range(cuda, d):
    """Ids -3 and NB + 5 inside two slots' lengths read the null block 0;
    an id 7 * NB past a length is never read."""
    gen = torch.Generator().manual_seed(d)
    p = fa.paged_split_plan(1)[0]
    lens = [2 * p + 3, 0, p, 9]
    q, kp, vp, tables, lens_t = _paged_case(gen, 4, 2, d, 40, 8, lens)
    tables = tables.cpu()
    tables[0, 1] = -3
    tables[2, 0] = 40 + 5
    tables[3, -1] = 7 * 40
    args = (q, kp, vp, tables.cuda(), lens_t)
    out = fa.paged_decode_attention(*args)
    torch.testing.assert_close(out, _paged_want(args), **TOL)
    assert bool((out[1] == 0).all())


def test_paged_kernel_combines_more_splits_than_a_block_has_threads(cuda):
    """A slot of 130 P + 7 keys: 131 live splits, more than the 128
    threads of the block that combines them."""
    p = fa.paged_split_plan(1)[0]
    n = 130 * p + 7
    gen = torch.Generator().manual_seed(6)
    args = _paged_case(gen, 2, 1, 128, 3 + -(-n // 4), 4, [n, 3])
    out = fa.paged_decode_attention(*args)
    torch.testing.assert_close(out, fa.paged_attention_reference(*args),
                               **TOL)
    assert torch.equal(out, fa.paged_decode_attention(*args))


def test_paged_kernel_with_every_slot_idle_writes_zeros(cuda):
    gen = torch.Generator().manual_seed(3)
    args = _paged_case(gen, 3, 2, 256, 6, 4, [0, 0, 0], mb=3)
    out = fa.paged_decode_attention(*args)
    assert bool((out == 0).all())


def test_paged_kernel_is_one_launch_and_one_allocation_a_call(cuda):
    """At chip_smoke.py phase 3's shape: one CUDA launch a call (the
    profiler), no host sync (the lengths are never read on the host:
    sync debug mode raises on one), and no allocation but the output."""
    gen = torch.Generator().manual_seed(4)
    args = _paged_case(gen, 8, 8, 256, 513, 16,
                       [1024, 1, 17, 500, 0, 999, 64, 777], mb=64)
    fa.paged_decode_attention(*args)  # built, scratch made
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [fa.paged_decode_attention(*args) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == (
        before + 3)
    kernels = _kernels_of(lambda: fa.paged_decode_attention(*args), 3)
    assert len(kernels) == 3, kernels
    assert all("paged_split_kernel" in k for k in kernels), kernels
    for out in outs:
        torch.testing.assert_close(out, fa.paged_attention_reference(*args),
                                   **TOL)


def test_paged_kernel_on_two_streams_keeps_its_tickets_apart(cuda):
    """Calls queued on two streams in turn with no sync between them: each
    stream has its own tickets and partials (shared ones would mix the
    two streams' splits), so every output matches its plain version."""
    gen = torch.Generator().manual_seed(5)
    lens = [1024, 300, 0, 777]
    cases = [_paged_case(gen, 4, 8, 256, 200, 16, lens, mb=64)
             for _ in range(2)]
    fa.paged_decode_attention(*cases[0])
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in cases]
    outs = [[], []]
    for _ in range(4):
        for i, (st, args) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(st):
                outs[i].append(fa.paged_decode_attention(*args))
    torch.cuda.synchronize()
    keys = {k for k in fa._paged_scratch if k[1] in
            {st.cuda_stream for st in streams}}
    assert len(keys) == 2
    for args, got in zip(cases, outs):
        want = fa.paged_attention_reference(*args)
        for out in got:
            torch.testing.assert_close(out, want, **TOL)


def test_paged_kernel_from_two_threads_matches_one_thread(cuda):
    """Two host threads launch the paged kernel at once on the default
    stream, as two fleet replicas' decode schedulers do in one process,
    with the scratch dropped first so that calls grow it while the other
    thread launches: every output has the bits of the same call from one
    thread, and the launch count is exact."""
    gen = torch.Generator().manual_seed(6)
    cases = [_paged_case(gen, s, 8, 256, 300, 16,
                         [(97 * i * s) % 1000 + 1 for i in range(s)],
                         mb=64)
             for s in (1, 2, 4, 8, 3, 8, 6, 5)]
    want = [fa.paged_decode_attention(*args) for args in cases]
    torch.cuda.synchronize()
    fa._paged_scratch.clear()
    start = threading.Barrier(2)
    got = [[], []]

    def worker(k):
        start.wait(30)
        for _ in range(20):
            for args in cases[k::2] + cases[1 - k::2]:
                got[k].append((args, fa.paged_decode_attention(*args)))

    n0 = fa.paged_decode_attention.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert fa.paged_decode_attention.launches - n0 == 2 * 20 * len(cases)
    by_case = {id(args): w for args, w in zip(cases, want)}
    for k in range(2):
        assert len(got[k]) == 20 * len(cases)
        for args, out in got[k]:
            assert torch.equal(out, by_case[id(args)])


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


def _serving_artifact(d, seq=64, batch=4):
    """An io.export_serving_model artifact of transformer_lm at 2 layers,
    d_model 256, 2 heads (head_dim 128), src_ids [seq], batch `batch`,
    from the port's own startup on the CPU."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io
    from paddle_tpu_torch.models.transformer import transformer_lm

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 5
    with pt.program_guard(main, startup):
        src = pt.layers.data("src_ids", [seq], dtype="int64")
        logits = transformer_lm(src, 101, n_layers=2, d_model=256,
                                n_heads=2, d_ff=512, max_len=seq)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    io.export_serving_model(d, ["src_ids"], [logits], main_program=main,
                            scope=scope, batch_size=batch)
    return logits.name


def test_serving_engine_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The one-shot engine on the card serves 8 requests within 1e-5 of
    the same artifact's engine on the CPU, two flash forward launches (one
    a layer) a batch."""
    from paddle_tpu_torch.serving import ServingEngine

    name = _serving_artifact(str(tmp_path))
    rng = np.random.default_rng(1)
    reqs = [{"src_ids": rng.integers(0, 101, 64)} for _ in range(8)]
    engines = [ServingEngine(device=dev, max_wait_ms=20.0)
               for dev in ("cpu", cuda)]
    try:
        for e in engines:
            e.load_model("lm", str(tmp_path))
        n0 = fa.flash_attention_fwd.launches
        outs = [[f.result(timeout=120) for f in
                 [e.submit("lm", r) for r in reqs]] for e in engines]
        batches = engines[1].metrics_snapshot()["models"]["lm"]["batches"]
        assert fa.flash_attention_fwd.launches - n0 == 2 * batches > 0
        for want, got in zip(*outs):
            assert got[name].shape == (64, 101)
            np.testing.assert_allclose(got[name], want[name], **TOL)
    finally:
        for e in engines:
            e.shutdown()


def test_hot_reload_on_the_card_drops_nothing(cuda, tmp_path):
    import threading

    from paddle_tpu_torch.serving import ServingEngine

    _serving_artifact(str(tmp_path), seq=32)
    engine = ServingEngine(max_wait_ms=2.0)
    engine.load_model("lm", str(tmp_path))
    stop, errors = threading.Event(), []

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            try:
                engine.predict("lm", {"src_ids": rng.integers(0, 101, 32)},
                               timeout=120)
            except Exception as e:  # noqa: BLE001 — the assertion target
                errors.append(repr(e))
                return

    threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(2):
            assert engine.load_model("lm", str(tmp_path)) > 1
    finally:
        stop.set()
        for t in threads:
            t.join()
        engine.shutdown()
    snap = engine.metrics_snapshot()["models"]["lm"]
    assert errors == [] and snap["failed"] == 0 and snap["reloads"] == 2
    assert snap["received"] == snap["completed"] > 0


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


# ResNet-50's nine epilogue shapes (C, S), the stem first
RESNET_EPILOGUES = [(64, 12544), (64, 3136), (256, 3136), (128, 784),
                    (512, 784), (256, 196), (1024, 196), (512, 49),
                    (2048, 49)]


@pytest.mark.parametrize("n,c,s", [
    (128, 64, 12544),    # the ResNet-50 stem at batch 128
    (128, 1024, 196),    # stage 3: rows start mid-vector
    (128, 2048, 49),     # stage 4
    (4, 3, 49), (3, 5, 7), (1, 1, 1), (2, 7, 13),
] + [(4, c, s) for c, s in RESNET_EPILOGUES])
def test_epilogue_kernels_match_plain(cuda, n, c, s):
    gen = torch.Generator().manual_seed(n + c + s)
    a = _randn(gen, n, c, s) + 0.5
    d = _randn(gen, n, c, s)
    ssum, ssq = fc.channel_stats(a)
    rsum, rsq = fc.channel_stats_reference(a)
    assert bool(((ssum - rsum).abs() <= 1e-5 * a.abs().sum(dim=(0, 2)))
                .all())
    torch.testing.assert_close(ssq, rsq, atol=0, rtol=1e-5)
    sc, sh = _randn(gen, c).abs() + 0.5, _randn(gen, c)
    for relu in (False, True):
        torch.testing.assert_close(
            fc.apply_epilogue(a, sc, sh, relu),
            fc.apply_epilogue_reference(a, sc, sh, None, relu), **TOL)
        torch.testing.assert_close(
            fc.apply_epilogue_add(a, sc, sh, d, relu),
            fc.apply_epilogue_reference(a, sc, sh, d, relu), **TOL)


@pytest.mark.parametrize("n,c,s", [(128, 256, 196), (128, 2048, 49),
                                   (128, 64, 12544), (3, 600, 5), (2, 7, 13)])
def test_channel_stats_gives_the_same_bits_twice(cuda, n, c, s):
    """Two calls on one input give identical bits: the sums run in one
    fixed order, and the tickets are back at 0 after each call."""
    gen = torch.Generator().manual_seed(c + s)
    a = _randn(gen, n, c, s) + 0.5
    first = fc.channel_stats(a)
    second = fc.channel_stats(a)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_epilogue_wrappers_never_fall_back(cuda, monkeypatch):
    """With the plain versions patched to raise, FusedConvEpilogue on the
    card runs forward and backward and counts one launch of each kernel
    it uses."""
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(fc, "channel_stats_reference", boom)
    monkeypatch.setattr(fc, "apply_epilogue_reference", boom)
    gen = torch.Generator().manual_seed(3)
    a = _randn(gen, 4, 8, 7, 7).requires_grad_(True)
    add = _randn(gen, 4, 8, 7, 7)
    g, b, m, v = (_randn(gen, 8).abs() + 0.5, _randn(gen, 8),
                  torch.zeros(8).cuda(), torch.ones(8).cuda())
    before = (fc.channel_stats.launches, fc.apply_epilogue.launches,
              fc.apply_epilogue_add.launches)
    y = fc.fused_conv_epilogue(a, g, b, m, v, None, 1e-5, 0.9, True)[0]
    y2 = fc.fused_conv_epilogue(a, g, b, m, v, add, 1e-5, 0.9, True)[0]
    (y.sum() + y2.sum()).backward()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(a.grad).all())
    assert (fc.channel_stats.launches, fc.apply_epilogue.launches,
            fc.apply_epilogue_add.launches) == (before[0] + 2,
                                                before[1] + 1,
                                                before[2] + 1)


def test_epilogue_kernels_refuse_what_they_do_not_take(cuda):
    gen = torch.Generator().manual_seed(4)
    a = _randn(gen, 2, 3, 8)
    sc = torch.ones(3).cuda()
    with pytest.raises(TypeError):
        fc.channel_stats(a.double())
    with pytest.raises(ValueError):
        fc.channel_stats(a.transpose(0, 1))
    with pytest.raises(ValueError):
        fc.apply_epilogue(a, sc[:2], sc)
    flat = torch.zeros(2 * 3 * 8 + 1).cuda()
    with pytest.raises(ValueError, match="aligned"):
        fc.apply_epilogue(flat[1:].view(2, 3, 8), sc, sc)
    with pytest.raises(ValueError):
        fc.apply_epilogue_add(a, sc, sc, a[:1])


def test_resnet_step_on_the_card_matches_the_cpu(cuda):
    """A narrow bottleneck ResNet (stem, max pool, projection blocks of
    stride 1 and 2, fused_bottleneck rest blocks, 32 px, batch 4) from
    one startup state: two Momentum steps on the card and on the CPU
    agree (losses within rtol 1e-4; every state element within 1e-5;
    each update, velocity and running stat within 1e-3 as rms), and each
    card step launched every epilogue kernel once per fused_conv2d op."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.analysis import fuse
    from paddle_tpu_torch.models import resnet

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("data", [3, 32, 32])
        label = pt.layers.data("label", [1], dtype="int64")
        h = resnet.conv_bn_layer(x, 16, 3, 1, 1)
        h = pt.layers.pool2d(h, pool_size=3, pool_type="max", pool_stride=2,
                             pool_padding=1)
        h = resnet.layer_warp(resnet.bottleneck, h, 8, 2, 1)
        h = resnet.layer_warp(resnet.bottleneck, h, 16, 2, 2)
        h = pt.layers.pool2d(h, pool_size=8, pool_type="avg",
                             global_pooling=True)
        logits = pt.layers.fc(h, size=10)
        avg = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits,
                                                                  label))
        pt.optimizer.MomentumOptimizer(learning_rate=0.05,
                                       momentum=0.9).minimize(avg)
    fused = fuse.maybe_fuse(main, protect=[avg.name])
    n_ops = sum(op.type == "fused_conv2d" for op in fused.global_block.ops)
    params = {p.name for p in main.global_block.all_parameters()}
    cpu_exe, cpu_scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    gpu_exe, gpu_scope = pt.Executor(), pt.Scope()
    names = sorted(cpu_scope.local_var_names())
    start = {n: cpu_scope.get_numpy(n) for n in names}
    for n in names:
        gpu_scope.set_var(n, cpu_scope.find_var(n).to(gpu_exe.device))
    rng = np.random.RandomState(0)
    n_stats = fc.channel_stats.launches
    for _ in range(2):
        data = rng.rand(4, 3, 32, 32).astype(np.float32) - 0.5
        feed = {"data": data, "label": rng.randint(0, 10, (4, 1))}
        lc, = cpu_exe.run(main, feed=feed, fetch_list=[avg], scope=cpu_scope)
        lg, = gpu_exe.run(main, feed=feed, fetch_list=[avg], scope=gpu_scope)
        np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert fc.channel_stats.launches == n_stats + 2 * n_ops

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a.astype(np.float64)))))

    for n in names:
        got, want = gpu_scope.get_numpy(n), cpu_scope.get_numpy(n)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=n)
        if n in params:
            got, want = got - start[n], want - start[n]
        assert rms(got - want) <= 1e-3 * rms(want), n


def _lstm_case(gen, t, b, h, lens):
    """LSTM kernel inputs on the card: the model's Xavier-scale W,
    initial states that are not zero, the mask of `lens` (None: full)."""
    lim = (6.0 / (5 * h)) ** 0.5
    mask = torch.ones(t, b) if lens is None else (
        torch.arange(t)[:, None] < torch.tensor(lens)[None, :]).float()
    d = dict(x=torch.randn(t, b, 4 * h, generator=gen),
             w=(torch.rand(h, 4 * h, generator=gen) * 2 - 1) * lim,
             b=0.1 * torch.randn(4 * h, generator=gen), mask=mask,
             r0=0.5 * torch.randn(b, h, generator=gen),
             c0=torch.randn(b, h, generator=gen),
             drs=torch.randn(t, b, h, generator=gen),
             dcs=torch.randn(t, b, h, generator=gen))
    return {k: v.cuda() for k, v in d.items()}


@pytest.mark.parametrize("t,b,h,lens", [
    (100, 64, 512, None),                       # the bench shape
    (100, 64, 512, [1, 100] + [37] * 30 + [64] * 32),
    (5, 3, 20, [5, 1, 3]),      # H not a multiple of the 16-unit tile
    (1, 1, 8, None), (9, 17, 33, [9, 1] + [4] * 15),
    (8, 4, 16, [3, 1, 5, 2]),   # trailing steps no sequence reaches
    (3, 4, 2048, None),         # H > 512: the step kernel, T launches
    # past one row tile a block: two tiles a block in turn each step
    (6, 96, 512, [6, 1] + [3] * 94), (4, 300, 128, None),
])
def test_lstm_kernels_match_plain(cuda, t, b, h, lens):
    gen = torch.Generator().manual_seed(t + b + h)
    d = _lstm_case(gen, t, b, h, lens)
    fwd = [d[k] for k in ("x", "w", "b", "mask", "r0", "c0")]
    # every shape up to H 512 takes the sequence kernel, wider ones the
    # step kernel
    assert (fl._plan_of(b, h, cuda.index or 0) is None) == (h > 512)
    rs, cs = fl.lstm_seq_fwd(*fwd)
    rrs, rcs = fl.lstm_seq_fwd_reference(*fwd)
    torch.testing.assert_close(rs, rrs, **TOL)
    torch.testing.assert_close(cs, rcs, **TOL)
    r_prevs = torch.cat([d["r0"][None], rrs[:-1]])
    c_prevs = torch.cat([d["c0"][None], rcs[:-1]])
    bwd = fwd[:4] + [r_prevs, c_prevs, d["drs"], d["dcs"]]
    for got, want in zip(fl.lstm_seq_bwd(*bwd),
                         fl.lstm_seq_bwd_reference(*bwd)):
        torch.testing.assert_close(got, want, **BWD_TOL)
    # dW and db are deterministic: no atomics, fixed-order sums
    again = fl.lstm_seq_bwd(*bwd)
    first = fl.lstm_seq_bwd(*bwd)
    for x, y in zip(again, first):
        assert torch.equal(x, y)


def _lstm_fwd_args(t, b, h, lens, seed):
    d = _lstm_case(torch.Generator().manual_seed(seed), t, b, h, lens)
    return [d[k] for k in ("x", "w", "b", "mask", "r0", "c0")]


@pytest.mark.parametrize("t,b,h,lens", [
    (100, 64, 512, [1, 100] + [37] * 30 + [64] * 32),
    (9, 17, 33, [9, 1] + [4] * 15),
    (3, 4, 2048, None),
    (50, 128, 512, None),
])
def test_lstm_forward_gives_the_same_bits_twice(cuda, t, b, h, lens):
    fwd = _lstm_fwd_args(t, b, h, lens, 7)
    first = fl.lstm_seq_fwd(*fwd)
    again = fl.lstm_seq_fwd(*fwd)
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_lstm_forward_takes_r0_at_any_offset(cuda, offset):
    """r0 a contiguous view `offset` floats into a larger buffer (its rows
    off 16 bytes): the step-0 loads of r take the 4-byte path, and the
    result has the bits of an aligned r0's."""
    fwd = _lstm_fwd_args(6, 64, 512, [6, 1] + [4] * 62, 11)
    r0 = fwd[4]
    buf = torch.zeros(r0.numel() + offset, device=r0.device)
    view = buf[offset:].view(r0.shape)
    view.copy_(r0)
    assert view.data_ptr() % 16
    aligned = fl.lstm_seq_fwd(*fwd)
    got = fl.lstm_seq_fwd(*fwd[:4], view, fwd[5])
    torch.cuda.synchronize()
    for x, y in zip(got, aligned):
        assert torch.equal(x, y)
    for x, y in zip(got, fl.lstm_seq_fwd_reference(*fwd)):
        torch.testing.assert_close(x, y, **TOL)


def _two_streams(run, reference, args, kernel, tol):
    """Two calls of `run` queued on two streams with no sync between
    them (after a call on each, so that its barrier counters and its
    outputs' memory exist before the profile: an allocation between the
    two launches can hold the second back until the first has ended).
    Returns whether the streams' barriers differ, the profiled spans of
    `kernel` ([start, end] us) and whether every output is within `tol`
    of `reference`'s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    streams = [torch.cuda.Stream() for _ in args]
    for st, a in zip(streams, args):
        with torch.cuda.stream(st):
            run(*a)
    torch.cuda.synchronize()
    out, barriers = [], []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for st, a in zip(streams, args):
            with torch.cuda.stream(st):
                barriers.append(fl._barrier_of(a[0].device, st.cuda_stream))
                out.append(run(*a))
        torch.cuda.synchronize()
    spans = [[e.time_range.start, e.time_range.end] for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    close = all(torch.allclose(x, y, **tol)
                for got, a in zip(out, args)
                for x, y in zip(got, reference(*a)))
    return {"apart": barriers[0] != barriers[1], "spans": spans,
            "close": close}


LSTM_COUNT_SHAPES = ((100, 64, 512), (24, 8, 128))


def _lstm_profiles() -> dict:
    """What the LSTM kernels' profiler tests read, profiled in this
    process: the kernels of 3 forward and of 3 backward calls at each of
    LSTM_COUNT_SHAPES, and two 16-block calls of each on two streams
    (long enough to overlap). The lstm_profiles fixture runs it in a
    fresh process: in a process that has profiled many calls before,
    torch.profiler recorded fewer kernel events than were launched."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for t, b, h in LSTM_COUNT_SHAPES:
        fwd = _lstm_fwd_args(t, b, h, None, 10)
        fl.lstm_seq_fwd(*fwd)
        bwd = _lstm_bwd_args(t, b, h, None, 12)
        fl.lstm_seq_bwd(*bwd)
        torch.cuda.synchronize()
        out[f"fwd {t} {b} {h}"] = _kernels_of(lambda: fl.lstm_seq_fwd(*fwd),
                                              3)
        out[f"bwd {t} {b} {h}"] = _kernels_of(lambda: fl.lstm_seq_bwd(*bwd),
                                              3, 3)
    out["fwd streams"] = _two_streams(
        fl.lstm_seq_fwd, fl.lstm_seq_fwd_reference,
        [_lstm_fwd_args(1000, 8, 128, None, s) for s in (8, 9)],
        "lstm_fwd_seq_kernel", TOL)
    out["bwd streams"] = _two_streams(
        fl.lstm_seq_bwd, fl.lstm_seq_bwd_reference,
        [_lstm_bwd_args(1000, 8, 128, None, s) for s in (15, 16)],
        "lstm_bwd_seq_kernel", BWD_TOL)
    return out


@pytest.fixture(scope="module")
def lstm_profiles():
    """_lstm_profiles() of a fresh Python process on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_gpu as t; "
            "print(json.dumps(t._lstm_profiles()))")
    run = subprocess.run([sys.executable, "-c", code, here],
                         cwd=os.path.dirname(here), capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _overlapped(spans) -> bool:
    return len(spans) == 2 and max(s[0] for s in spans) < min(
        s[1] for s in spans)


def test_lstm_forward_on_two_streams_keeps_its_barriers_apart(
        lstm_profiles):
    """Two sequence-kernel calls queued on two streams with no sync
    between them, small enough (16 blocks each) to be resident at once
    and long enough to overlap: each stream has its own barrier counters
    (a shared count would release either grid early), so both match their
    plain versions."""
    got = lstm_profiles["fwd streams"]
    assert got["apart"]
    # the two grids ran at the same time
    assert _overlapped(got["spans"]), got["spans"]
    assert got["close"]


@pytest.mark.parametrize("t,b,h", LSTM_COUNT_SHAPES)
def test_lstm_forward_is_one_launch_a_call(lstm_profiles, t, b, h):
    kernels = lstm_profiles[f"fwd {t} {b} {h}"]
    assert len(kernels) == 3, kernels
    assert all("lstm_fwd_seq_kernel" in k for k in kernels), kernels


def _lstm_bwd_args(t, b, h, lens, seed):
    """The backward's inputs: the forward's, carries that are not zero
    (r_prevs, c_prevs) and cotangents ~ N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    d = _lstm_case(gen, t, b, h, lens)
    r_prevs = 0.5 * _randn(gen, t, b, h)
    c_prevs = _randn(gen, t, b, h)
    return [d[k] for k in ("x", "w", "b", "mask")] + [
        r_prevs, c_prevs, d["drs"], d["dcs"]]


@pytest.mark.parametrize("t,b,h", LSTM_COUNT_SHAPES)
def test_lstm_backward_is_three_launches_a_call(lstm_profiles, t, b, h):
    """The gates' recompute, the recurrence's one cooperative launch and
    dW: 3 CUDA launches a call (the per-step path: 2T + 4)."""
    kernels = lstm_profiles[f"bwd {t} {b} {h}"]
    assert len(kernels) == 9, kernels
    assert sum("lstm_bwd_seq_kernel" in k for k in kernels) == 3, kernels


def test_lstm_backward_gives_the_same_bits_twice(cuda):
    """The ragged bench shape: every sum in a fixed order, no atomics."""
    bwd = _lstm_bwd_args(100, 64, 512, [1, 100] + [37] * 30 + [64] * 32, 13)
    assert fl._bwd_plan_of(64, 512, cuda.index or 0) is not None
    first = fl.lstm_seq_bwd(*bwd)
    again = fl.lstm_seq_bwd(*bwd)
    for x, y in zip(first, again):
        assert torch.equal(x, y)


def test_lstm_backward_past_one_row_tile_a_block(cuda):
    """B 200 at H 512: 13 row tiles of 16 over 4 row groups, so each block
    takes up to 4 tiles in turn each step and db adds four row groups."""
    lens = [20, 1] + [7] * 99 + [13] * 99
    bwd = _lstm_bwd_args(20, 200, 512, lens, 14)
    plan = fl._bwd_plan_of(200, 512, cuda.index or 0)
    assert plan.nt >= 2 and plan.grid[1] >= 2, plan
    got = fl.lstm_seq_bwd(*bwd)
    for x, y in zip(got, fl.lstm_seq_bwd_reference(*bwd)):
        torch.testing.assert_close(x, y, **BWD_TOL)
    for x, y in zip(got, fl.lstm_seq_bwd(*bwd)):
        assert torch.equal(x, y)


def test_lstm_backward_on_two_streams_keeps_its_barriers_apart(
        lstm_profiles):
    """Two backward calls queued on two streams with no sync between
    them, small enough (16 blocks each) to be resident at once and long
    enough to overlap: each stream has its own barrier counters, so both
    match their plain versions."""
    got = lstm_profiles["bwd streams"]
    assert got["apart"]
    assert _overlapped(got["spans"]), got["spans"]
    assert got["close"]


def test_lstm_wrappers_never_fall_back(cuda, monkeypatch):
    """With the plain versions patched to raise, LSTMSequence on the card
    runs forward and backward and counts one launch of each kernel."""
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(fl, "lstm_seq_fwd_reference", boom)
    monkeypatch.setattr(fl, "lstm_seq_bwd_reference", boom)
    gen = torch.Generator().manual_seed(5)
    d = _lstm_case(gen, 6, 4, 32, [6, 1, 3, 5])
    x = d["x"].requires_grad_(True)
    before = (fl.lstm_seq_fwd.launches, fl.lstm_seq_bwd.launches)
    rs, cs = fl.lstm_sequence(x, d["w"], d["b"], d["mask"], d["r0"],
                              d["c0"])
    (rs.sum() + 0.5 * cs.sum()).backward()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x.grad).all())
    assert (fl.lstm_seq_fwd.launches, fl.lstm_seq_bwd.launches) == (
        before[0] + 1, before[1] + 1)


def test_lstm_kernels_refuse_what_they_do_not_take(cuda):
    gen = torch.Generator().manual_seed(6)
    d = _lstm_case(gen, 4, 2, 8, None)
    fwd = [d[k] for k in ("x", "w", "b", "mask", "r0", "c0")]
    with pytest.raises(TypeError):
        fl.lstm_seq_fwd(*([fwd[0].double()] + fwd[1:]))
    with pytest.raises(ValueError):
        fl.lstm_seq_fwd(*([fwd[0].transpose(0, 1)] + fwd[1:]))
    with pytest.raises(ValueError):
        fl.lstm_seq_fwd(*(fwd[:1] + [fwd[1][:, :16]] + fwd[2:]))
    with pytest.raises(ValueError):
        fl.lstm_seq_fwd(*(fwd[:3] + [fwd[3][:2]] + fwd[4:]))
    with pytest.raises(ValueError):
        fl.lstm_seq_fwd(*(fwd[:4] + [fwd[4].cpu()] + fwd[5:]))
    rp = torch.zeros(4, 2, 8).cuda()
    with pytest.raises(ValueError):
        fl.lstm_seq_bwd(*fwd[:4], rp, rp, rp, rp[:3])


def test_lstm_step_on_the_card_matches_the_cpu(cuda):
    """The narrow stacked LSTM (vocab 100, embedding 16, hidden 32,
    batch 4) from one startup state: two Adam steps on ragged list feeds
    on the card and on the CPU agree (losses within rtol 1e-4, every
    state element within 1e-5, each update and moment within 1e-3 as
    rms), and each card step launched each LSTM kernel once."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import stacked_dynamic_lstm as sdl

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        loss, _, _, _ = sdl.get_model(dict_size=100, lstm_size=32,
                                      emb_dim=16, use_fused=True)
    cpu_exe, cpu_scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    gpu_exe, gpu_scope = pt.Executor(), pt.Scope()
    names = sorted(cpu_scope.local_var_names())
    start = {n: cpu_scope.get_numpy(n) for n in names}
    for n in names:
        gpu_scope.set_var(n, cpu_scope.find_var(n).to(gpu_exe.device))
    rng = np.random.RandomState(0)
    before = (fl.lstm_seq_fwd.launches, fl.lstm_seq_bwd.launches)
    for _ in range(2):
        lens = [1, 8] + list(rng.randint(1, 9, 2))
        feed = {"words": [rng.randint(0, 100, (n, 1)) for n in lens],
                "label": rng.randint(0, 2, (4, 1))}
        lc, = cpu_exe.run(main, feed=feed, fetch_list=[loss],
                          scope=cpu_scope)
        lg, = gpu_exe.run(main, feed=feed, fetch_list=[loss],
                          scope=gpu_scope)
        np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert (fl.lstm_seq_fwd.launches, fl.lstm_seq_bwd.launches) == (
        before[0] + 2, before[1] + 2)

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a.astype(np.float64)))))

    for n in names:
        got, want = gpu_scope.get_numpy(n), cpu_scope.get_numpy(n)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=n)
        if not ("_moment" in n or "_pow_acc" in n):
            got, want = got - start[n], want - start[n]
        assert rms(got - want) <= 1e-3 * rms(want), n


def _chain_case(gen, n, cin, c, h, w=None):
    """Inputs of the chain's kernels on the card at h rows of w pixels (w
    = h by default): a block input >= 0, He-scaled weights, a raw a (for
    the kernels that normalize it) and BN affines with shifts that are
    not zero."""
    s = h * (h if w is None else w)
    d = dict(x=torch.rand(n, cin, s, generator=gen),
             w1=torch.randn(c, cin, generator=gen) * (2 / cin) ** 0.5,
             taps=torch.randn(9, c, c, generator=gen) * (2 / (9 * c)) ** 0.5,
             w3=torch.randn(cin, c, generator=gen) * (2 / c) ** 0.5,
             a=torch.randn(n, c, s, generator=gen) + 0.3,
             sc=torch.rand(c, generator=gen) + 0.5,
             sh=0.3 * torch.randn(c, generator=gen) + 0.2,
             sc3=torch.rand(cin, generator=gen) + 0.5,
             sh3=0.3 * torch.randn(cin, generator=gen),
             g=[1 + 0.2 * torch.randn(k, generator=gen) for k in (c, c, cin)],
             b=[0.2 * torch.randn(k, generator=gen) for k in (c, c, cin)])
    return {k: ([t.cuda() for t in v] if isinstance(v, list) else v.cuda())
            for k, v in d.items()}


def _sums_close(got, want, terms):
    assert bool(((got - want).abs() <= 1e-5 * terms).all())


@pytest.mark.parametrize("n,cin,c,h", [
    (2, 256, 64, 56),    # S 3136: the 56x56 stage
    (4, 256, 64, 14),    # S 196: rows start mid-vector
    (3, 256, 96, 7),     # S 49, C not a multiple of the 64-row tile
    (8, 256, 96, 14),
    # the 3x3's halo tiles (224 positions of a grid of rows of W + 2):
    (2, 512, 128, 28),   # the 28x28 stage's widths: chunks end mid-row
    (1, 1024, 256, 14),  # the 14x14 stage's: two 128-row tiles of Cout
    (2, 256, 64, (10, 12)),   # a non-square image, S 120
    (2, 128, 64, (16, 20)),   # two chunks an image, the first ends mid-row
    (1, 64, 72, (3, 250)),    # rows wider than a chunk; Cout 72: zero rows
])
def test_chain_kernels_match_plain(cuda, n, cin, c, h):
    """Each forward kernel against its plain version: outputs within TOL,
    sums within 1e-5 of their terms' magnitudes; the 3x3 also from taps
    that are not 16-byte aligned, and each sum kernel's second call
    bit-identical."""
    h, w = h if isinstance(h, tuple) else (h, h)
    gen = torch.Generator().manual_seed(n + cin + c + h + (w if w != h else 0))
    d = _chain_case(gen, n, cin, c, h, w)
    y, s1, q1 = fb.conv1x1_stats(d["x"], d["w1"])
    ry, rs1, rq1 = fb.conv1x1_stats_reference(d["x"], d["w1"])
    torch.testing.assert_close(y, ry, **TOL)
    _sums_close(s1, rs1, ry.abs().sum(dim=(0, 2)))
    torch.testing.assert_close(q1, rq1, atol=0, rtol=1e-5)
    args = (d["a"], d["taps"], d["sc"], d["sh"], h)
    y2, s2, q2 = fb.conv3x3_norm_stats(*args)
    ry2, rs2, rq2 = fb.conv3x3_norm_stats_reference(*args)
    torch.testing.assert_close(y2, ry2, **TOL)
    _sums_close(s2, rs2, ry2.abs().sum(dim=(0, 2)))
    torch.testing.assert_close(q2, rq2, atol=0, rtol=1e-5)
    again = fb.conv3x3_norm_stats(*args)
    assert all(torch.equal(u, v) for u, v in zip((y2, s2, q2), again))
    offset = torch.empty(d["taps"].numel() + 1, device="cuda")[1:]
    offset.copy_(d["taps"].reshape(-1))
    assert offset.data_ptr() % 16
    shifted = fb.conv3x3_norm_stats(d["a"], offset.view_as(d["taps"]),
                                    d["sc"], d["sh"], h)
    assert all(torch.equal(u, v) for u, v in zip((y2, s2, q2), shifted))
    sum_h, m2h = fb.norm_relu_moments(d["a"], d["sc"], d["sh"])
    rsum_h, rm2h = fb.norm_relu_moments_reference(d["a"], d["sc"], d["sh"])
    torch.testing.assert_close(sum_h, rsum_h, atol=0, rtol=1e-5)
    torch.testing.assert_close(m2h, rm2h, atol=1e-6, rtol=1e-5)
    args = (d["a"], d["x"], d["sc"], d["sh"], d["w3"], d["sc3"], d["sh3"])
    torch.testing.assert_close(fb.conv1x1_bn_residual(*args),
                               fb.conv1x1_bn_residual_reference(*args), **TOL)
    # deterministic: fixed-order sums, no atomics
    again = fb.norm_relu_moments(d["a"], d["sc"], d["sh"])
    assert torch.equal(again[1], m2h) and torch.equal(again[0], sum_h)
    assert torch.equal(fb.conv1x1_stats(d["x"], d["w1"])[2], q1)


@pytest.mark.parametrize("n,cin,c,s,offset", [
    (2, 256, 64, 3136, 0),    # the three chain stages' widths: W1 itself
    (2, 512, 128, 784, 0),
    (4, 1024, 256, 196, 0),   # two 128-row tiles of C
    (2, 64, 64, 49, 0),       # S % 4 != 0: 4-byte copies, tiles straddling
                              # images
    (2, 64, 64, 64, 1),       # x and W1 4 bytes off 16-byte alignment
    (3, 72, 64, 36, 0),       # Cin 72: W1 padded to K 80
    (2, 256, 72, 30, 0),      # C 72: a partial 128-row tile
    (2, 128, 130, 20, 3),     # C 130 and 200: a second row tile mostly
    (1, 96, 200, 45, 0),      # empty; N·S 40 and 45, one partial tile
    (3, 64, 8, 50, 0),        # C 8; N·S 150, not a multiple of the tile
])
def test_conv1x1_stats_kernel_matches_plain(cuda, n, cin, c, s, offset):
    """conv1x1_stats alone at the chain's widths and at shapes the chain's
    gate never makes: y within TOL of the plain version, Σy and Σy²
    within 1e-5 of their terms' magnitudes, a second call bit-identical;
    x and W1 off 16-byte alignment (4-byte copies of x, W1 copied) give
    the bits of the aligned call."""
    gen = torch.Generator().manual_seed(n + cin + c + s)
    x = torch.rand(n, cin, s, generator=gen).cuda()
    w = (torch.randn(c, cin, generator=gen) * (2 / cin) ** 0.5).cuda()
    got = fb.conv1x1_stats(x, w)
    want = fb.conv1x1_stats_reference(x, w)
    torch.testing.assert_close(got[0], want[0], **TOL)
    _sums_close(got[1], want[1], want[0].abs().sum(dim=(0, 2)))
    _sums_close(got[2], want[2], want[2])
    again = fb.conv1x1_stats(x, w)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if offset:
        xo = torch.empty(x.numel() + offset, device="cuda")[offset:]
        wo = torch.empty(w.numel() + offset, device="cuda")[offset:]
        xo, wo = xo.view_as(x).copy_(x), wo.view_as(w).copy_(w)
        assert xo.data_ptr() % 16 and wo.data_ptr() % 16
        shifted = fb.conv1x1_stats(xo, wo)
        assert all(torch.equal(a, b) for a, b in zip(got, shifted))


@pytest.mark.parametrize("n,c,s", [
    (3, 72, 49),     # S % 4 != 0: 4-byte copies; C 72: a second row tile
    (5, 200, 45),    # N·S 225, not a multiple of 32; tiles off the diagonal
    (2, 130, 100),   # C just past a 128-column tile
    (2, 64, 3136),   # the 56x56 stage's C and S
    (6, 256, 196),   # the 14x14 stage's
    (1, 8, 7),       # one piece, most of it zero-filled
])
def test_norm_relu_moments_at_odd_shapes(cuda, n, c, s):
    """The moments kernel against its plain version where its tiles,
    pieces and copies are ragged, every shift > 0 (a zero-filled row or
    position normalized to relu(shift) would show): Σh and M2 within rtol
    1e-5 of their terms (h >= 0: the sums themselves), M2 exactly
    symmetric, a second call bit-identical; where S % 4 == 0, a2 at an
    address that is not 16-byte aligned (4-byte copies) gives the same
    bits."""
    gen = torch.Generator().manual_seed(n * 1000 + c + s)
    a = _randn(gen, n, c, s) + 0.3
    sc = (torch.rand(c, generator=gen) + 0.5).cuda()
    sh = (0.3 * torch.rand(c, generator=gen) + 0.05).cuda()
    sum_h, m2h = fb.norm_relu_moments(a, sc, sh)
    rsum_h, rm2h = fb.norm_relu_moments_reference(a, sc, sh)
    _sums_close(sum_h, rsum_h, rsum_h)
    _sums_close(m2h, rm2h, rm2h)
    assert torch.equal(m2h, m2h.T)
    again = fb.norm_relu_moments(a, sc, sh)
    assert torch.equal(again[0], sum_h) and torch.equal(again[1], m2h)
    if s % 4 == 0:
        offset = torch.empty(a.numel() + 1, device="cuda")[1:]
        offset.copy_(a.reshape(-1))
        assert offset.data_ptr() % 16
        narrow = fb.norm_relu_moments(offset.view_as(a), sc, sh)
        assert torch.equal(narrow[0], sum_h) and torch.equal(narrow[1], m2h)


def test_norm_relu_moments_refuses_what_it_does_not_take(cuda):
    """A float64 or strided x, a scale of another C, an empty x and N·S
    past 2³¹ - 33 (an expanded view: no memory) are refused, TypeError or
    ValueError, before any launch."""
    gen = torch.Generator().manual_seed(10)
    a = _randn(gen, 2, 8, 7)
    sc, sh = torch.ones(8, device="cuda"), torch.ones(8, device="cuda")
    before = fb.norm_relu_moments.launches
    with pytest.raises(TypeError):
        fb.norm_relu_moments(a.double(), sc, sh)
    strided = a.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    with pytest.raises(ValueError):
        fb.norm_relu_moments(strided, sc, sh)
    with pytest.raises(ValueError):
        fb.norm_relu_moments(a, sc[:4], sh[:4])
    with pytest.raises(ValueError):
        fb.norm_relu_moments(a[:, :, :0], sc, sh)
    wide = torch.zeros(1, 8, 1, device="cuda").expand(2 ** 16, 8, 2 ** 15)
    with pytest.raises(ValueError, match="positions"):
        fb.norm_relu_moments(wide, sc, sh)
    assert fb.norm_relu_moments.launches == before


def test_chain_wrappers_never_fall_back(cuda, monkeypatch):
    """With the four plain versions patched to raise, the chain's forward
    runs on the card through its kernels, one launch of each."""
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    names = ("conv1x1_stats", "conv3x3_norm_stats", "norm_relu_moments",
             "conv1x1_bn_residual")
    for name in names:
        monkeypatch.setattr(fb, name + "_reference", boom)
    gen = torch.Generator().manual_seed(8)
    d = _chain_case(gen, 2, 128, 64, 14)
    before = [getattr(fb, name).launches for name in names]
    out, stats, _ = fb.bottleneck_rest_fwd(d["x"], d["w1"], d["taps"],
                                           d["w3"], d["g"][0], d["b"][0],
                                           d["g"][1], d["b"][1], d["g"][2],
                                           d["b"][2], 14)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert [getattr(fb, name).launches for name in names] == [
        k + 1 for k in before]


def test_chain_kernels_refuse_what_they_do_not_take(cuda):
    gen = torch.Generator().manual_seed(9)
    d = _chain_case(gen, 2, 16, 8, 7)
    with pytest.raises(TypeError):
        fb.conv1x1_stats(d["x"].double(), d["w1"])
    with pytest.raises(ValueError):
        fb.conv1x1_stats(d["x"].transpose(0, 1), d["w1"])
    with pytest.raises(ValueError):
        fb.conv1x1_stats(d["x"], d["w1"][:, :8])
    with pytest.raises(ValueError):
        fb.conv3x3_norm_stats(d["a"], d["taps"].transpose(1, 2), d["sc"],
                              d["sh"], 7)
    with pytest.raises(ValueError):
        fb.conv3x3_norm_stats(d["a"][:, :6], d["taps"][:, :, :6],
                              d["sc"][:6], d["sh"][:6], 7)  # Cin % 8
    with pytest.raises(ValueError):       # S is not h_side rows
        fb.conv3x3_norm_stats(d["a"], d["taps"], d["sc"], d["sh"], 5)
    with pytest.raises(TypeError):
        fb.conv3x3_norm_stats(d["a"], d["taps"], d["sc"].double(), d["sh"],
                              7)
    with pytest.raises(ValueError):
        fb.conv3x3_norm_stats(d["a"], d["taps"], d["sc"], d["sh"][:4], 7)
    with pytest.raises(TypeError):
        fb.norm_relu_moments(d["a"], d["sc"].double(), d["sh"])
    with pytest.raises(ValueError):
        fb.conv1x1_bn_residual(d["a"], d["x"][:1], d["sc"], d["sh"],
                               d["w3"], d["sc3"], d["sh3"])
    # C = 720: past what the h2 tile and the W ring hold in one block's
    # shared memory, refused by the entry point before any launch
    assert fb.conv1x1_max_c() == 704
    wide = {k: torch.zeros(*shape, device="cuda") for k, shape in (
        ("a", (2, 720, 49)), ("sc", (720,)), ("w3", (16, 720)))}
    before = fb.conv1x1_bn_residual.launches
    with pytest.raises(RuntimeError):
        fb.conv1x1_bn_residual(wide["a"], d["x"], wide["sc"], wide["sc"],
                               wide["w3"], d["sc3"], d["sh3"])
    assert fb.conv1x1_bn_residual.launches == before


@pytest.mark.parametrize("c,takes", [(704, True), (768, False)])
def test_chain_gate_keeps_c_within_the_1x1_kernels(cuda, monkeypatch, c,
                                                   takes):
    """With PT_FUSED_BLOCK=always, the chain's gate on the card takes a
    block up to the C that conv1x1_bn_residual's and bwd_final's tile
    holds (704) and sends a wider one (768) to the composition, where
    the kernels would refuse it."""
    from paddle_tpu_torch.ops import fused_ops
    monkeypatch.setenv("PT_FUSED_BLOCK", "always")
    x = torch.zeros(8, 1024, 14, 14, device="cuda")
    w1 = torch.zeros(c, 1024, 1, 1, device="cuda")
    assert fused_ops._chain_takes(x, w1) == takes


def test_conv1x1_bn_residual_at_the_56_training_shape_is_repeatable(cuda):
    """conv1x1_bn_residual at ResNet-50's 56x56 chain stage at batch 128
    (Cin 256, C 64): within TOL of its plain version, a second call
    bit-identical (no sums across blocks)."""
    gen = torch.Generator().manual_seed(56)
    d = _chain_case(gen, 128, 256, 64, 56)
    args = (d["a"], d["x"], d["sc"], d["sh"], d["w3"], d["sc3"], d["sh3"])
    got = fb.conv1x1_bn_residual(*args)
    torch.testing.assert_close(got, fb.conv1x1_bn_residual_reference(*args),
                               **TOL)
    assert torch.equal(fb.conv1x1_bn_residual(*args), got)


@pytest.mark.parametrize("n,cout,c,h,offset", [
    (3, 256, 64, 7, 0),          # S 49: 4-byte accesses, 64-column blocks
                                 # straddling images
    (2, 256, 64, (10, 12), 0),   # S 120
    (2, 96, 40, (5, 6), 0),      # S 30, even but not a multiple of 4
    (2, 72, 64, 14, 0),          # Cout 72: a partial 128-row chunk
    (2, 256, 72, 14, 0),         # C 72: a partial 16-channel stage
    (2, 256, 512, 14, 0),        # C 512 and 704 (the most): one block an
    (2, 128, 704, 14, 0),        # SM, past two at C 304
    (2, 256, 64, 14, 1),         # W3 and the residual 4 bytes off 16-byte
                                 # alignment: 4-byte accesses at S % 4 == 0
    (8, 1024, 256, 14, 0),       # 25 blocks: Cout's 8 chunks in 8 splits
])
def test_conv1x1_bn_residual_takes_shapes_the_chain_does_not(cuda, n, cout,
                                                             c, h, offset):
    """conv1x1_bn_residual alone at shapes the chain's gate never makes:
    within TOL of its plain version, a second call bit-identical."""
    h, w = h if isinstance(h, tuple) else (h, h)
    gen = torch.Generator().manual_seed(n + cout + c + h + w + offset)
    d = _chain_case(gen, n, cout, c, h, w)

    def shifted(t):
        buf = torch.empty(t.numel() + offset, device="cuda")[offset:]
        buf.copy_(t.reshape(-1))
        return buf.view_as(t)

    w3, x = shifted(d["w3"]), shifted(d["x"])
    assert w3.data_ptr() % 16 == x.data_ptr() % 16 == 4 * offset
    args = (d["a"], x, d["sc"], d["sh"], w3, d["sc3"], d["sh3"])
    got = fb.conv1x1_bn_residual(*args)
    torch.testing.assert_close(got, fb.conv1x1_bn_residual_reference(*args),
                               **TOL)
    assert torch.equal(fb.conv1x1_bn_residual(*args), got)


def _chain_op_ins(x, w1, w2, w3, bn):
    ins = {"X": [x], "W1": [w1], "W2": [w2], "W3": [w3]}
    for k, params in zip("123", bn):
        for slot, v in zip(("Scale", "Bias", "Mean", "Variance"), params):
            ins[slot + k] = [v]
    return ins


def test_fused_bottleneck_op_takes_the_chain(cuda, monkeypatch):
    """The fused_bottleneck op (N 8, Cin 128, C 64, H 14) with
    PT_FUSED_BLOCK=always runs the chain's kernels and agrees with
    compose_block: the output within 1e-4 and the twelve stat outputs
    within 1e-4 relative (the chain takes bn3's stats analytically)."""
    from paddle_tpu_torch.core.registry import ExecContext, require_op
    from paddle_tpu_torch.ops import fused_ops

    monkeypatch.setenv("PT_FUSED_BLOCK", "always")
    gen = torch.Generator().manual_seed(10)
    n, cin, c, h = 8, 128, 64, 14
    x = torch.rand(n, cin, h, h, generator=gen).cuda()
    w1 = (torch.randn(c, cin, 1, 1, generator=gen) * (2 / cin) ** 0.5).cuda()
    w2 = (torch.randn(c, c, 3, 3, generator=gen) * (2 / (9 * c)) ** 0.5
          ).cuda()
    w3 = (torch.randn(cin, c, 1, 1, generator=gen) * (2 / c) ** 0.5).cuda()
    bn = [tuple(t.cuda() for t in (
        1 + 0.2 * torch.randn(k, generator=gen),
        0.2 * torch.randn(k, generator=gen),
        0.1 * torch.randn(k, generator=gen),
        torch.rand(k, generator=gen) + 0.5)) for k in (c, c, cin)]
    before = fb.conv3x3_norm_stats.launches
    outs = require_op("fused_bottleneck").compute(
        ExecContext(torch.Generator(), torch.device("cuda")),
        _chain_op_ins(x, w1, w2, w3, bn), {"epsilon": 1e-5, "momentum": 0.9})
    want, want_st = fused_ops.compose_block(x, w1, w2, w3, bn, 1e-5, 0.9)
    torch.cuda.synchronize()
    assert fb.conv3x3_norm_stats.launches == before + 1
    torch.testing.assert_close(outs["Out"][0], want, atol=1e-4, rtol=1e-4)
    slots = [s.format(k=k) for k in "123" for s in fused_ops._BN_OUT_SLOTS]
    for slot, w in zip(slots, want_st):
        torch.testing.assert_close(outs[slot][0], w, atol=1e-5, rtol=1e-4)


_BWD = ("bwd_reduce3", "bwd_apply3", "bwd_mid", "bwd_final")


def _bwd_inputs(gen, n, cin, c, h, w=None):
    """{kernel: args} of the four backward wrappers as bottleneck_rest_bwd
    calls them after the chain's forward of a _chain_case (h rows of w
    pixels, w = h by default), with a random cotangent of out and zero
    stat cotangents, the wrappers replaced by their plain versions: each
    kernel's inputs as its plain predecessors make them."""
    d = _chain_case(gen, n, cin, c, h, w)
    g, b = d["g"], d["b"]
    out, stats, aux = fb.bottleneck_rest_fwd(
        d["x"], d["w1"], d["taps"], d["w3"], g[0], b[0], g[1], b[1], g[2],
        b[2], h)
    a1, a2, sum_h, m2h, sc1, sh1, sc2, sh2 = aux
    res = (d["x"], a1, a2, out, d["w1"], d["taps"], d["w3"], g[0], g[1],
           g[2], *stats, sum_h, m2h, sc1, sh1, sc2, sh2)
    dout = torch.randn(n, cin, h * (h if w is None else w),
                       generator=gen).cuda()
    args = {}

    def plain(name):
        ref = getattr(fb, name + "_reference")

        def call(*a):
            args[name] = a
            return ref(*a)
        return call

    with pytest.MonkeyPatch.context() as mp:
        for name in _BWD:
            mp.setattr(fb, name, plain(name))
        fb.bottleneck_rest_bwd(res, dout, [torch.zeros_like(s)
                                           for s in stats], h)
    return args


def _bwd_terms(name, args, want):
    """The sum of the magnitudes of each summed output's terms, in the
    order the wrapper returns its outputs (None: an elementwise output)."""
    col = lambda v: v.reshape(1, -1, 1)
    if name == "bwd_reduce3":
        dout, out, a2, sc2, sh2 = args
        g3 = want[0].abs()
        return (None, torch.einsum("nis,ncs->ic", g3,
                                   fb._norm_relu(a2, sc2, sh2)),
                g3.sum(dim=(0, 2)))
    if name == "bwd_apply3":
        a2, inv2, m2 = args[1], args[7], args[8]
        g2 = want[0]
        xh = a2 * col(inv2) + col(-m2 * inv2)
        return (None, g2.abs().sum(dim=(0, 2)),
                (g2 * xh).abs().sum(dim=(0, 2)))
    if name == "bwd_mid":
        g2, a2, a1, sc1, sh1, p2, q2, r2, inv1, m1, taps, h = args
        n, c, s = g2.shape
        da2 = (g2 * col(p2) + a2 * col(q2) + col(r2)).abs()
        h1 = fb._norm_relu(a1, sc1, sh1).view(n, c, h, s // h)
        dw = torch.nn.grad.conv2d_weight(h1, (c, c, 3, 3),
                                         da2.view(n, c, h, s // h), padding=1)
        g1 = want[0]
        xh = a1 * col(inv1) + col(-m1 * inv1)
        return (None, dw.permute(2, 3, 0, 1).reshape(9, c, c),
                g1.abs().sum(dim=(0, 2)), (g1 * xh).abs().sum(dim=(0, 2)))
    g3, g1, a1, x, p1, q1, r1, _ = args
    da1 = (g1 * col(p1) + a1 * col(q1) + col(r1)).abs()
    return None, torch.einsum("ncs,nks->ck", da1, x)


@pytest.mark.parametrize("n,cin,c,h", [
    (2, 256, 64, 56),    # S 3136: the 56x56 stage
    (4, 256, 64, 14),    # S 196
    (3, 256, 96, 7),     # S 49, C not a multiple of the 64-row tile;
                         # bwd_reduce3's 4-byte copies
    (8, 256, 96, 14),
    (2, 512, 128, 28),   # the 28x28 stage's widths
    (1, 1024, 256, 14),  # the 14x14 stage's: two column tiles of C
    (3, 256, 64, 10),    # N·S 300: a ragged last stage, 16-byte copies
    # bwd_mid's tiles of the padded grid (rows of W + 2): the input
    # gradient's 224-position chunks, the tap gradients' 32-position
    # pieces
    (2, 256, 96, (10, 12)),   # H != W; C 96: rows past the 64-row tile;
                              # the last piece (160) past the grid (140)
    (2, 128, 64, (16, 20)),   # two chunks an image, the last one partial
    (1, 64, 72, (3, 250)),    # rows wider than a chunk: three halo
                              # segments; C 72
    (2, 128, 136, (6, 9)),    # C 136: three 64-row tiles, the last
                              # mostly empty
])
def test_chain_backward_kernels_match_plain(cuda, n, cin, c, h):
    """Each backward kernel against its plain version on the chain's own
    inputs: g3 bitwise, g2, g1 and dx within BWD_TOL, every sum over N·S
    within 1e-5 of its terms' magnitudes; a second call bit-identical."""
    h, w = h if isinstance(h, tuple) else (h, h)
    gen = torch.Generator().manual_seed(n + cin + c + h + 1
                                        + (w if w != h else 0))
    args = _bwd_inputs(gen, n, cin, c, h, w)
    for name, a in args.items():
        got = getattr(fb, name)(*a)
        want = getattr(fb, name + "_reference")(*a)
        for i, (gt, wt, terms) in enumerate(zip(got, want,
                                                _bwd_terms(name, a, want))):
            if terms is None and name == "bwd_reduce3":
                assert torch.equal(gt, wt), name
            elif terms is None:
                torch.testing.assert_close(gt, wt, **BWD_TOL)
            else:
                _sums_close(gt, wt, terms)
        again = getattr(fb, name)(*a)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), name


@pytest.mark.parametrize("n,cin,c,s,offset", [
    (3, 150, 20, 49, 0),     # Cin % 4 != 0: W1's rows padded to 152; C %
                             # 8 != 0: K zero-filled past C; S % 4 != 0:
                             # 4-byte copies, 64-column tiles and 32-column
                             # pieces straddling images
    (2, 132, 44, 100, 1),    # 16-byte copies; W1 a view 4 bytes off 16-byte
                             # alignment (copied); Cin past one 128-row chunk
])
def test_bwd_final_kernels_take_shapes_the_chain_does_not(cuda, n, cin, c,
                                                         s, offset):
    """bwd_final alone at shapes the chain's gate never makes: dx within
    BWD_TOL of the plain version, dW1 within 1e-5 of its terms'
    magnitudes, a second call bit-identical."""
    gen = torch.Generator().manual_seed(n + cin + c + s)
    g3, x = _randn(gen, n, cin, s), _randn(gen, n, cin, s).abs()
    g1, a1 = _randn(gen, n, c, s), _randn(gen, n, c, s) + 0.3
    p1, q1, r1 = (1 + 0.2 * _randn(gen, c), 0.1 * _randn(gen, c),
                  0.1 * _randn(gen, c))
    w1 = _randn(gen, c * cin + offset)[offset:].view(c, cin)
    args = (g3, g1, a1, x, p1, q1, r1, w1)
    got = fb.bwd_final(*args)
    want = fb.bwd_final_reference(*args)
    torch.testing.assert_close(got[0], want[0], **BWD_TOL)
    _sums_close(got[1], want[1], _bwd_terms("bwd_final", args, want)[1])
    again = fb.bwd_final(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("n,cin,c,s,offset", [
    (3, 150, 20, 49, 0),     # Cin % 16 != 0: a K stage straddles g3 and h2;
                             # C % 8 != 0; S % 4 != 0: 4-byte copies, a
                             # 128-column tile spanning three images
    (2, 100, 44, 100, 1),    # 16-byte copies; amat a view 4 bytes off
                             # 16-byte alignment
    (2, 72, 136, 36, 0),     # C 136: two 128-row tiles, the second mostly
                             # empty; 64-column tiles spanning two images
    (1, 64, 96, 30, 3),      # S even but not a multiple of 4: 4-byte
                             # copies at 128-row tiles
])
def test_bwd_apply3_kernel_takes_shapes_the_chain_does_not(cuda, n, cin, c,
                                                          s, offset):
    """bwd_apply3 alone at shapes the chain's gate never makes: g2 within
    BWD_TOL of the plain version, Σg2 and Σg2·x̂2 within 1e-5 of their
    terms' magnitudes, a second call bit-identical."""
    gen = torch.Generator().manual_seed(n + cin + c + s)
    g3, a2 = _randn(gen, n, cin, s), _randn(gen, n, c, s)
    sc2, sh2 = 1 + 0.2 * _randn(gen, c), 0.1 * _randn(gen, c)
    amat = (_randn(gen, c * cin + offset) * (2 / c) ** 0.5)[offset:].view(
        c, cin)
    assert amat.data_ptr() % 16 == 4 * offset % 16
    bmat = _randn(gen, c, c) * 0.1 / c ** 0.5
    v0, m2 = 0.1 * _randn(gen, c), 0.1 * _randn(gen, c)
    inv2 = (1 + 0.2 * _randn(gen, c)).abs()
    args = (g3, a2, sc2, sh2, amat, bmat, v0, inv2, m2)
    got = fb.bwd_apply3(*args)
    want = fb.bwd_apply3_reference(*args)
    torch.testing.assert_close(got[0], want[0], **BWD_TOL)
    terms = _bwd_terms("bwd_apply3", args, want)
    _sums_close(got[1], want[1], terms[1])
    _sums_close(got[2], want[2], terms[2])
    again = fb.bwd_apply3(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_chain_backward_wrappers_never_fall_back(cuda, monkeypatch):
    """With the four backward plain versions patched to raise, the
    chain's backward runs on the card through its kernels, one launch of
    each."""
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in _BWD:
        monkeypatch.setattr(fb, name + "_reference", boom)
    gen = torch.Generator().manual_seed(11)
    d = _chain_case(gen, 2, 128, 64, 14)
    args = [d["x"], d["w1"], d["taps"], d["w3"]] + [
        t for pair in zip(d["g"], d["b"]) for t in pair]
    args = [t.clone().requires_grad_(True) for t in args]
    before = [getattr(fb, name).launches for name in _BWD]
    out = fb.fused_bottleneck_rest(*args, 14)[0]
    grads = torch.autograd.grad(out, args, torch.randn_like(out))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert [getattr(fb, name).launches for name in _BWD] == [
        k + 1 for k in before]


def test_chain_backward_kernels_refuse_what_they_do_not_take(cuda):
    gen = torch.Generator().manual_seed(12)
    args = _bwd_inputs(gen, 2, 128, 64, 7)
    for name, a in args.items():
        for i, t in enumerate(a):
            if not isinstance(t, torch.Tensor):
                continue
            bad = list(a)
            bad[i] = t.double()
            with pytest.raises(TypeError):
                getattr(fb, name)(*bad)
            if t.dim() >= 2:
                bad[i] = t.transpose(0, 1).contiguous().transpose(0, 1)
                assert not bad[i].is_contiguous()
                with pytest.raises(ValueError):
                    getattr(fb, name)(*bad)
    with pytest.raises(ValueError):       # C % 8
        fb.bwd_mid(*(t[:, :6].contiguous() for t in args["bwd_mid"][:3]),
                   *args["bwd_mid"][3:])


def _chain_program(pt):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        data = pt.layers.data("data", [256, 14, 14])
        label = pt.layers.data("label", [1], dtype="int64")
        h = pt.layers.fused_bottleneck(data, 64)
        h = pt.layers.pool2d(h, pool_type="avg", global_pooling=True)
        logits = pt.layers.fc(h, size=10)
        avg = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits,
                                                                  label))
        pt.optimizer.MomentumOptimizer(learning_rate=0.05,
                                       momentum=0.9).minimize(avg)
    return main, startup, avg


def test_training_through_the_chain_matches_the_composition(cuda,
                                                            monkeypatch):
    """One Momentum step of a fused_bottleneck program (N 8, Cin 256, C
    64, 14x14) from one startup state, composed and with
    PT_FUSED_BLOCK=always: the chain's step runs the four forward and the
    four backward kernels once each, and every persistable after it
    (parameters, running stats, velocities) and the loss agree with the
    composed step's within the chain-vs-composition tolerance (2e-5, as
    tests/test_torch_fused_block.py holds them on the CPU)."""
    import paddle_tpu_torch as pt

    main, startup, avg = _chain_program(pt)
    exe, scope0 = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope0)
    names = sorted(scope0.local_var_names())
    rng = np.random.RandomState(0)
    feed = {"data": rng.rand(8, 256, 14, 14).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1))}
    kernels = ("conv1x1_stats", "conv3x3_norm_stats", "norm_relu_moments",
               "conv1x1_bn_residual") + _BWD
    losses, ends = {}, {}
    for mode in ("never", "always"):
        monkeypatch.setenv("PT_FUSED_BLOCK", mode)
        scope = pt.Scope()
        for n in names:
            scope.set_var(n, scope0.find_var(n).clone())
        before = [getattr(fb, k).launches for k in kernels]
        loss, = exe.run(main, feed=feed, fetch_list=[avg], scope=scope)
        after = [getattr(fb, k).launches for k in kernels]
        assert [a - b for a, b in zip(after, before)] == (
            [1] * 8 if mode == "always" else [0] * 8)
        losses[mode] = float(loss[0])
        ends[mode] = {n: scope.get_numpy(n) for n in names}
    np.testing.assert_allclose(losses["always"], losses["never"], atol=2e-5,
                               rtol=2e-5)
    for n in names:
        np.testing.assert_allclose(ends["always"][n], ends["never"][n],
                                   atol=2e-5, rtol=2e-5, err_msg=n)


# ---------------------------------------------------------------------------
# the Trainer on the card: resume and the guard (chip_smoke.py phase 15's
# (b) and (c) at a small width)
# ---------------------------------------------------------------------------

_TR_CFG = dict(vocab_size=200, seq_len=128, n_layers=2, d_model=256,
               n_heads=2, d_ff=512, max_len=128)
_TR_STEPS, _TR_INTERVAL = 6, 3


def _tr_feed(i):
    rs = np.random.RandomState(900 + i)
    src = rs.randint(0, _TR_CFG["vocab_size"], (2, _TR_CFG["seq_len"]))
    return {"src_ids": src.astype("int64"), "tgt_ids": src[..., None]}


def _tr_reader():
    return (_tr_feed(i) for i in range(_TR_STEPS))


def _card_trainer(ckpt_dir):
    """A Trainer on the card (its default place) with the step's
    contract: noam_decay, a global-norm clip, L2 decay, Adam."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.program import unique_name_guard
    from paddle_tpu_torch.models.transformer import transformer_lm_loss

    def train_func():
        pt.default_startup_program().random_seed = 3
        return [transformer_lm_loss(**_TR_CFG)[0]]

    def optimizer_func():
        lr = pt.layers.noam_decay(_TR_CFG["d_model"], warmup_steps=4) * 0.05
        pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(1.0))
        return pt.optimizer.AdamOptimizer(
            learning_rate=lr, regularization=pt.regularizer.L2Decay(1e-4))

    cfg = pt.CheckpointConfig(ckpt_dir, max_num_checkpoints=1,
                              step_interval=_TR_INTERVAL)
    with unique_name_guard():
        return pt.Trainer(train_func, optimizer_func, checkpoint_config=cfg)


def _tr_state(trainer):
    block = trainer.train_program.global_block
    return {n: trainer.scope.find_var(n) for n, v in block.vars.items()
            if v.persistable and trainer.scope.find_var(n) is not None}


def test_trainer_resumes_on_the_card_as_the_uninterrupted_run(
        cuda, tmp_path, monkeypatch):
    """A Trainer on the card checkpoints at step 3 of 6; a new Trainer
    over that serial resumes at step 4, and its losses and final state
    are within 1e-5 (relative) of the uninterrupted run's; each step
    launched each flash kernel n_layers times."""
    import paddle_tpu_torch as pt

    monkeypatch.setenv("PT_GUARD", "skip")
    ckpt, snap = str(tmp_path / "ckpt"), str(tmp_path / "snap")
    n0 = fa.flash_attention_bwd_dkv.launches
    a = _card_trainer(ckpt)
    assert a.exe.device.type == "cuda"
    losses = {}

    def on_a(event):
        if isinstance(event, pt.BeginStepEvent) and \
                event.step == _TR_INTERVAL:
            # keep the step-3 serial: the next save scrolls it away
            (serial,) = os.listdir(ckpt)
            os.makedirs(os.path.join(snap, serial))
            for f in os.listdir(os.path.join(ckpt, serial)):
                os.link(os.path.join(ckpt, serial, f),
                        os.path.join(snap, serial, f))
        if isinstance(event, pt.EndStepEvent):
            losses[event.step] = event.metrics[0]
    a.train(num_epochs=1, event_handler=on_a, reader=_tr_reader, log_every=2)
    r = _card_trainer(snap)
    assert r.checkpoint_cfg.step_id == _TR_INTERVAL
    rlosses = {}
    r.train(num_epochs=1, reader=_tr_reader, log_every=2,
            event_handler=lambda e: rlosses.__setitem__(e.step, e.metrics[0])
            if isinstance(e, pt.EndStepEvent) else None)
    assert sorted(rlosses) == list(range(_TR_INTERVAL, _TR_STEPS))
    np.testing.assert_allclose([float(rlosses[k]) for k in sorted(rlosses)],
                               [float(losses[k]) for k in sorted(rlosses)],
                               rtol=1e-5)
    got, want = _tr_state(r), _tr_state(a)
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n].cpu().numpy(),
                                   want[n].cpu().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    steps = _TR_STEPS + (_TR_STEPS - _TR_INTERVAL)
    assert fa.flash_attention_bwd_dkv.launches - n0 == \
        _TR_CFG["n_layers"] * steps


def test_guarded_nan_grad_step_on_the_card_changes_nothing(
        cuda, tmp_path, monkeypatch):
    """Under PT_GUARD=skip a step whose gradients are poisoned
    (PT_FAULT_INJECT=nan_grad@1) reads health false and leaves every
    persistable var, the step counter included, bit-identical; the next
    clean step trains."""
    from paddle_tpu_torch.resilience import faults

    monkeypatch.setenv("PT_GUARD", "skip")
    t = _card_trainer(str(tmp_path / "ckpt"))
    t.exe.run(t.train_program, feed=_tr_feed(0), fetch_list=[t.loss],
              scope=t.scope, guard=True)
    before = {n: v.clone() for n, v in _tr_state(t).items()}
    monkeypatch.setenv("PT_FAULT_INJECT", "nan_grad@1")
    faults.reset()
    try:
        loss, health = t.exe.run(t.train_program, feed=_tr_feed(1),
                                 fetch_list=[t.loss], scope=t.scope,
                                 guard=True, lazy=True)
        assert not bool(health) and np.isfinite(float(loss))
    finally:
        monkeypatch.delenv("PT_FAULT_INJECT")
        faults.reset()
    after = _tr_state(t)
    assert "@LR_DECAY_COUNTER@" in after
    for n in before:
        assert torch.equal(after[n], before[n]), n
    _, health = t.exe.run(t.train_program, feed=_tr_feed(2),
                          fetch_list=[t.loss], scope=t.scope, guard=True)
    assert bool(health)
    assert not torch.equal(_tr_state(t)["@LR_DECAY_COUNTER@"],
                           before["@LR_DECAY_COUNTER@"])
