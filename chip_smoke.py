#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure ends the run with a non-zero exit code and
no result line:

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels from the sources in paddle_tpu_torch/csrc, one
   nvcc per source, all at once;
3. hold each kernel against its plain PyTorch version at the main paths'
   shapes (the flash kernels at B 1 for the prefill buckets and at B 8,
   S 1024 for a training step), and time the kernel, the plain version,
   PyTorch's scaled_dot_product_attention forward (flash forward) and
   its backward less its forward (flash backward), beside each kernel's
   bound;
4. serve the Transformer LM at full width (vocab 32000, 6 layers,
   d_model 2048, 8 heads, d_ff 8192, context 1024, 8 slots, 16-token
   blocks, random weights from --seed) through DecodeEngine: 12 requests,
   launch counts read around the run, then a teacher-forced check of two
   requests against the prefill path, then device time by kernel
   (torch.profiler) for one prefill per bucket and for decode steps;
5. train the same model at full width (batch 8, sequence 1024, Adam at
   lr 1e-4, float32) through Program / program_guard / Executor: startup,
   one warm-up step and TRAIN_STEPS timed steps on the bench's pool-probe
   feeds, launch counts read around them, finite and falling losses,
   then device time by kernel for one step; then the trained weights
   loaded into the serving module (TransformerLM) give the logits of an
   inference program built by the same builder;
6. take two Adam steps of one reduced program (2 layers, d_model 256,
   2 heads, sequence 128, batch 2) from one startup state on the card and
   on the CPU, and hold losses, state and each update together;
7. print the kernels' JSON line, the card line and the result line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, float32 flop/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# kernel vs plain version, both float32 on the card with TF32 off: the
# sums run in another order (tiles, pages, cuBLAS), about 1e-6 apart
KERNEL_ATOL = KERNEL_RTOL = 1e-5
# the backward kernels: each dK/dV entry sums up to 1024 products of p or
# dS and a row of dO or Q, in another order than the plain version
BWD_ATOL = BWD_RTOL = 1e-4
# card vs CPU, the same program from one state, two Adam steps: losses
# within the CPU parity tests' rtol; every state element within
# PARAM_ATOL (4.4e-7 measured on the H100); each parameter's update and
# each accumulator within STATE_RTOL of the CPU's, as rms, as
# tests/test_torch_executor.py holds the port to the JAX package (but for
# the key biases: their gradient is zero in exact arithmetic, so their
# updates and moments are rounding noise, held by PARAM_ATOL alone)
LOSS_RTOL, PARAM_ATOL, STATE_RTOL = 1e-4, 1e-5, 1e-3
# the Program path and the serving module at full width, the same ops on
# the same card
MODULE_ATOL = MODULE_RTOL = 1e-5
# decode path vs prefill path on the same tokens: f32 through every layer
# at width 2048, with GEMV-shaped vs GEMM-shaped products and paged vs
# flash attention sums, so the logits differ by more than one kernel does
LOGIT_TOL = 1e-3

MODEL = dict(vocab_size=32000, n_layers=6, d_model=2048, n_heads=8,
             d_ff=8192, max_context=1024)
BUCKETS = (128, 256, 512, 1024)
SLOTS, BLOCK, POOL_BLOCKS = 8, 16, 513
N_REQUESTS, MAX_NEW = 12, 32
# bench.py bench_transformer's TPU arm (bench.py:822-833)
TRAIN = dict(batch=8, seq_len=1024, lr=1e-4)
TRAIN_STEPS = 6
LM_PROBE_POOL = 64
# the flash kernels' checks, (batch, sequence) at H 8, D 256, causal: the
# prefill buckets' batch 1 (and a ragged length), and a training step;
# the kernels line reports the training shape
FLASH_SHAPES = ((1, 128), (1, 1024), (1, 333), (8, 1024))
LINE_SHAPE = (8, 1024)
REDUCED = dict(vocab_size=32000, n_layers=2, d_model=256, n_heads=2,
               d_ff=1024, seq_len=128, batch=2)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, n: int) -> float:
    """Mean ms of one call over n back-to-back calls, by CUDA events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(torch, got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL) -> float:
    """Largest |got - want|; raises if any element is outside the
    stated tolerance or not finite."""
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("kernel output is not finite")
    if not bool((diff <= atol + rtol * want.abs()).all()):
        raise RuntimeError(f"kernel disagrees with its plain version: "
                           f"max abs err {float(diff.max()):.3e}")
    return float(diff.max())


def check_flash(torch, F, fa, card):
    """Flash forward vs its plain version at H=8, D=256, causal, at each
    of FLASH_SHAPES."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    row, errs = None, []
    for b, s in FLASH_SHAPES:
        q, k, v = (torch.randn(b, s, 8, 256, device="cuda", generator=gen)
                   for _ in range(3))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max(max_err(torch, o, ro), max_err(torch, lse, rlse))
        errs.append(err)
        pairs = b * s * (s + 1) // 2 * 8
        nbytes = 4 * b * (4 * s * 8 * 256 + 8 * s)
        b_ms, b_by = bound_ms(nbytes, 4 * 256 * pairs)
        ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v,
                                                           causal=True), 20)
        plain = cuda_ms(torch, lambda: fa.flash_attention_fwd_reference(
            q, k, v, causal=True), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20)
        print(f"flash_attention_fwd B={b} S={s}: max_abs_err {err:.3e} (tol "
              f"atol {KERNEL_ATOL} rtol {KERNEL_RTOL}), kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}) [{card}]")
        if (b, s) == LINE_SHAPE:
            row = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib)
    row["max_abs_err"] = max(errs)
    return row


def check_flash_bwd(torch, F, fa, card):
    """The two backward kernels vs their plain versions at H=8, D=256,
    causal, at each of FLASH_SHAPES, from the plain forward's O and lse;
    SDPA's backward (autograd through it, less its forward) as the
    yardstick of the pair."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, errs = {}, {"dq": [], "dkv": []}
    for b, s in FLASH_SHAPES:
        q, k, v, do = (torch.randn(b, s, 8, 256, device="cuda",
                                   generator=gen) for _ in range(4))
        o, lse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
        delta = fa.flash_attention_bwd_delta(o, do)
        args = (q, k, v, do, lse, delta)
        dq = fa.flash_attention_bwd_dq(*args, causal=True)
        dk, dv = fa.flash_attention_bwd_dkv(*args, causal=True)
        rq, rk, rv = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                      causal=True)
        torch.cuda.synchronize()
        errs["dq"].append(max_err(torch, dq, rq, BWD_ATOL, BWD_RTOL))
        errs["dkv"].append(max(max_err(torch, dk, rk, BWD_ATOL, BWD_RTOL),
                               max_err(torch, dv, rv, BWD_ATOL, BWD_RTOL)))
        pairs = b * s * (s + 1) // 2 * 8
        in_bytes = 4 * b * (4 * s * 8 * 256 + 2 * 8 * s)
        out = 4 * b * s * 8 * 256
        bounds = {"dq": bound_ms(in_bytes + out, 6 * 256 * pairs),
                  "dkv": bound_ms(in_bytes + 2 * out, 8 * 256 * pairs)}
        pair = {"dq": (fa.flash_attention_bwd_dq,
                       fa.flash_attention_bwd_dq_reference),
                "dkv": (fa.flash_attention_bwd_dkv,
                        fa.flash_attention_bwd_dkv_reference)}
        ms = {part: cuda_ms(torch, lambda f=f: f(*args, causal=True), 20)
              for part, (f, _) in pair.items()}
        plain = {part: cuda_ms(torch, lambda r=r: r(*args, causal=True), 5)
                 for part, (_, r) in pair.items()}
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2)
        fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20)
        both = cuda_ms(torch, lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            (qt, kt, vt), dot), 20)
        lib = both - fwd
        total_bound = bound_ms(in_bytes + 3 * out, 14 * 256 * pairs)
        print(f"flash_attention_bwd B={b} S={s}: max_abs_err dq "
              f"{errs['dq'][-1]:.3e}, dk/dv {errs['dkv'][-1]:.3e} (tol atol "
              f"{BWD_ATOL} rtol {BWD_RTOL}); dq kernel {ms['dq']:.4f} ms "
              f"(plain {plain['dq']:.4f}, bound {bounds['dq'][0]:.4f} "
              f"{bounds['dq'][1]}), dk/dv kernel {ms['dkv']:.4f} ms (plain "
              f"{plain['dkv']:.4f}, bound {bounds['dkv'][0]:.4f} "
              f"{bounds['dkv'][1]}); both {ms['dq'] + ms['dkv']:.4f} ms vs "
              f"bound {total_bound[0]:.4f} ms ({14 * 256 * pairs / 1e9:.2f} "
              f"GFLOP) and sdpa backward {lib:.4f} ms (sdpa fwd+bwd "
              f"{both:.4f}, fwd {fwd:.4f}) [{card}]")
        if (b, s) == LINE_SHAPE:
            for part in ("dq", "dkv"):
                rows[part] = dict(ms=ms[part], plain_ms=plain[part],
                                  bound_ms=bounds[part][0],
                                  bound_by=bounds[part][1], library_ms=lib)
    for part in ("dq", "dkv"):
        rows[part]["max_abs_err"] = max(errs[part])
    return rows["dq"], rows["dkv"]


def check_paged(torch, fa, card):
    """Paged decode vs its plain version: 8 slots, H=8, D=256, BS=16,
    ragged lengths up to 1024 with one idle (length 0) slot."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    h, d, mb = 8, 256, MODEL["max_context"] // BLOCK
    k_pool, v_pool = (torch.randn(POOL_BLOCKS, BLOCK, h, d, device="cuda",
                                  generator=gen) for _ in range(2))
    lens = torch.tensor([1024, 1, 17, 500, 0, 999, 64, 777], dtype=torch.int32)
    perm = torch.randperm(POOL_BLOCKS - 1, generator=torch.Generator()
                          .manual_seed(3)) + 1
    tables = torch.zeros(SLOTS, mb, dtype=torch.int32)
    used = 0
    for i, n in enumerate(lens.tolist()):
        nb = -(-n // BLOCK)
        tables[i, :nb] = perm[used:used + nb]
        used += nb
    q = torch.randn(SLOTS, h, d, device="cuda", generator=gen)
    tables, lens = tables.cuda(), lens.cuda()
    out = fa.paged_decode_attention(q, k_pool, v_pool, tables, lens)
    ref = fa.paged_attention_reference(q, k_pool, v_pool, tables, lens)
    torch.cuda.synchronize()
    err = max_err(torch, out, ref)
    if bool(out[4].abs().max() != 0):
        raise RuntimeError("the idle slot's output is not zero")
    keys = int(lens.sum())
    nbytes = 4 * (2 * keys * h * d + 2 * SLOTS * h * d + SLOTS * mb + SLOTS)
    b_ms, b_by = bound_ms(nbytes, 4 * keys * h * d)
    ms = cuda_ms(torch, lambda: fa.paged_decode_attention(
        q, k_pool, v_pool, tables, lens), 50)
    plain = cuda_ms(torch, lambda: fa.paged_attention_reference(
        q, k_pool, v_pool, tables, lens), 10)
    print(f"paged_decode_attention slots={SLOTS} lens={lens.tolist()}: "
          f"max_abs_err {err:.3e} (tol atol {KERNEL_ATOL} rtol "
          f"{KERNEL_RTOL}), kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}) [{card}]")
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, max_abs_err=err)


def make_params(np, param_shapes, seed: int) -> dict:
    """normal(0, 0.02) weights and embeddings, zero biases, unit LN scales
    (the JAX package's initializers for this model)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in param_shapes(MODEL).items():
        if name.endswith("_scale"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith(("_b", "_bias")):
            out[name] = np.zeros(shape, np.float32)
        else:
            a = rng.standard_normal(shape, dtype=np.float32)
            a *= 0.02
            out[name] = a
    return out


def teacher_forced(np, engine, prompt, generated):
    """Replay one finished request on the idle engine: decode-path logits
    (prefill the prompt, then one decode step per generated token) and
    prefill-path logits (one prefill of prompt + generated[:-1]) for the
    same positions. Returns (decode logits, prefill logits), [n, vocab]."""
    from paddle_tpu_torch.serving.decode.kv_cache import block_table_row

    model, pool = engine.model, engine.pool
    blocks = pool.alloc(pool.blocks_for_tokens(len(prompt) + len(generated)))
    try:
        logits, kv = model.prefill(prompt)
        model.seed_sequence(blocks, kv)
        dec = [logits]
        for j, tok in enumerate(generated[:-1]):
            tokens = np.zeros(model.slots, np.int64)
            lens = np.zeros(model.slots, np.int32)
            tables = np.zeros((model.slots, model.max_blocks_per_seq),
                              np.int32)
            tokens[0], lens[0] = tok, len(prompt) + j + 1
            tables[0] = block_table_row(blocks, model.max_blocks_per_seq)
            dec.append(model.decode_step(tokens, lens, tables)[0])
    finally:
        pool.free(blocks)
    full = np.asarray(prompt + generated[:-1], np.int32)
    pm = model.prefill_model
    res, _ = pm.execute_batch(pm.bucket_of({"src_ids": full}),
                              [{"src_ids": full}])
    n0 = len(prompt) - 1
    pre = res[0]["logits"][n0:n0 + len(generated)].cpu().numpy()
    return np.stack(dec), pre


def kernel_class(name: str) -> str:
    n = name.lower()
    if "paged_decode" in n:
        return "paged_decode_attention (port kernel)"
    if "flash_fwd" in n:
        return "flash_attention_fwd (port kernel)"
    if "flash_bwd_dq" in n:
        return "flash_attention_bwd_dq (port kernel)"
    if "flash_bwd_dkv" in n:
        return "flash_attention_bwd_dkv (port kernel)"
    if "gemm" in n or "gemv" in n:
        return "matmul (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset"
    return "other PyTorch kernels"


def profiled(torch, fn, n: int):
    """(wall ms per call, {kernel name: device ms per call}) over n calls
    under torch.profiler; each call ends in a host sync of its own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / n)
    return 1e3 * wall / n, by_name


def print_profile(what: str, wall_ms: float, by_name: dict, card: str):
    if not by_name:
        print(f"profile {what}: wall {wall_ms:.3f} ms per call; the "
              f"profiler saw no device time [{card}]")
        return
    busy = sum(by_name.values())
    print(f"profile {what}: wall {wall_ms:.3f} ms per call, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.3f} [{card}]")
    classes = {}
    for name, ms in by_name.items():
        classes[kernel_class(name)] = classes.get(kernel_class(name), 0) + ms
    for cls, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"  {cls}: {ms:.3f} ms ({ms / wall_ms:.3f} of wall)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:.3f} ms  {name[:100]}")


def profile_main_path(np, torch, engine, card, seed: int, steps: int = 10):
    """Where the time goes on the idle engine: one prefill per bucket, and
    decode steps with every slot holding a live sequence."""
    from paddle_tpu_torch.serving.decode.kv_cache import block_table_row

    model, pool = engine.model, engine.pool
    rng = np.random.default_rng(seed + 2)
    for bound in BUCKETS:
        toks = rng.integers(1, MODEL["vocab_size"], bound).tolist()
        wall, by_name = profiled(torch, lambda: model.prefill(toks), 3)
        print_profile(f"prefill bucket {bound}", wall, by_name, card)
    lens = rng.integers(64, MODEL["max_context"] - steps - 2,
                        model.slots).astype(np.int32)
    blocks = [pool.alloc(pool.blocks_for_tokens(int(n) + steps + 2))
              for n in lens]
    try:
        for n, blk in zip(lens, blocks):
            _, kv = model.prefill(
                rng.integers(1, MODEL["vocab_size"], int(n)).tolist())
            model.seed_sequence(blk, kv)
        tables = np.stack([block_table_row(b, model.max_blocks_per_seq)
                           for b in blocks])
        state = {"lens": lens.copy()}

        def step():
            state["lens"] += 1
            model.decode_step(
                rng.integers(1, MODEL["vocab_size"], model.slots),
                state["lens"], tables)

        wall, by_name = profiled(torch, step, steps)
    finally:
        for blk in blocks:
            pool.free(blk)
    print_profile(f"decode step ({model.slots} live slots, context "
                  f"{int(lens.min())}..{int(lens.max())}, {int(lens.sum())} "
                  f"keys, + {steps} steps)", wall, by_name, card)


def main_path(np, torch, fa, card, seed: int):
    from paddle_tpu_torch import io
    from paddle_tpu_torch.models.transformer import param_shapes
    from paddle_tpu_torch.serving.decode import DecodeEngine

    t0 = time.perf_counter()
    params = make_params(np, param_shapes, seed)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(1, MODEL["vocab_size"],
                            int(rng.integers(64, 901))).tolist()
               for _ in range(N_REQUESTS)]
    with tempfile.TemporaryDirectory() as d:
        io.export_decode_model(d, MODEL, params=params,
                               length_buckets=BUCKETS, slots=SLOTS,
                               block_size=BLOCK, pool_blocks=POOL_BLOCKS)
        del params
        engine = DecodeEngine(d, name="lm")
    print(f"main path: weights made, exported and loaded in "
          f"{time.perf_counter() - t0:.1f} s; prompt lengths "
          f"{[len(p) for p in prompts]}")
    try:
        fa.flash_attention_fwd.launches = 0
        fa.paged_decode_attention.launches = 0
        t0 = time.perf_counter()
        handles = [engine.generate(p, max_new_tokens=MAX_NEW)
                   for p in prompts]
        results = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                    "paged_decode_attention":
                        fa.paged_decode_attention.launches}
        print(f"main path launches: {launches}")
        for name, n in launches.items():
            if n == 0:
                raise RuntimeError(f"{name} was not launched on the main "
                                   "path")
        for r in results:
            if (len(r["tokens"]) != MAX_NEW or r["finish_reason"] != "length"
                    or not all(0 <= t < MODEL["vocab_size"]
                               for t in r["tokens"])):
                raise RuntimeError(f"bad generation result {r}")
        snap = engine.metrics_snapshot()
        step_ms = 1e3 * snap["decode_s"] / snap["decode_steps"]
        print(f"main path: {N_REQUESTS} requests x {MAX_NEW} tokens in "
              f"{wall:.3f} s: {snap['tokens_out'] / wall:.1f} tokens/s, "
              f"{snap['decode_steps']} decode steps at {step_ms:.3f} ms "
              f"mean, slot occupancy {snap['slot_occupancy']}, "
              f"{snap['prefills']} prefills [{card}]")
        for bound in BUCKETS:
            toks = rng.integers(1, MODEL["vocab_size"], bound).tolist()
            engine.model.prefill(toks)
            t0 = time.perf_counter()
            for _ in range(3):
                engine.model.prefill(toks)
            print(f"prefill bucket {bound}: "
                  f"{1e3 * (time.perf_counter() - t0) / 3:.3f} ms [{card}]")
        for i in (0, N_REQUESTS - 1):
            gen = results[i]["tokens"]
            dec, pre = teacher_forced(np, engine, prompts[i], gen)
            diff = float(np.abs(dec - pre).max())
            top2 = np.sort(pre, axis=1)[:, -2:]
            sure = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL
            agree = pre.argmax(axis=1) == np.asarray(gen)
            print(f"teacher-forced request {i} (prompt {len(prompts[i])}): "
                  f"decode vs prefill logits max abs diff {diff:.3e} (tol "
                  f"{LOGIT_TOL}), {int(sure.sum())}/{len(gen)} tokens with "
                  f"top-2 gap > tol, all identical: "
                  f"{bool(agree[sure].all())}")
            if not (np.isfinite(dec).all() and diff <= LOGIT_TOL
                    and agree[sure].all()):
                raise RuntimeError("teacher-forced check failed")
        profile_main_path(np, torch, engine, card, seed)
    finally:
        engine.shutdown()
    return launches


def lm_probe_feeds(np, i, batch, seqlen, vocab):
    """bench.py lm_probe_feeds: batch i of the current-token copy task
    over an LM_PROBE_POOL-id pool."""
    vrng = np.random.RandomState(7000 + i)
    src = vrng.randint(0, min(vocab, LM_PROBE_POOL),
                       (batch, seqlen)).astype("int64")
    return {"src_ids": src, "tgt_ids": src[..., None]}


def build_lm(pt, cfg, seq_len, seed):
    from paddle_tpu_torch.models.transformer import transformer_lm_loss

    main_prog, startup = pt.Program(), pt.Program()
    main_prog.random_seed = startup.random_seed = seed
    with pt.program_guard(main_prog, startup):
        avg, _ = transformer_lm_loss(
            vocab_size=cfg["vocab_size"], seq_len=seq_len,
            n_layers=cfg["n_layers"], d_model=cfg["d_model"],
            n_heads=cfg["n_heads"], d_ff=cfg["d_ff"], max_len=seq_len)
        pt.optimizer.AdamOptimizer(learning_rate=TRAIN["lr"]).minimize(avg)
    return main_prog, startup, avg


TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


def train_path(np, torch, fa, card, seed: int):
    """Full-width training through the Executor; returns the launch
    counts of the run (startup, warm-up and timed steps)."""
    import paddle_tpu_torch as pt

    b, s = TRAIN["batch"], TRAIN["seq_len"]
    main_prog, startup, avg = build_lm(pt, MODEL, s, seed)
    n_params = sum(int(np.prod(v.shape)) for v in
                   main_prog.global_block.all_parameters())
    exe, scope = pt.Executor(), pt.Scope()
    torch.cuda.reset_peak_memory_stats()
    for name in TRAIN_KERNELS:
        getattr(fa, name).launches = 0
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    losses, step_s = [], []
    for i in range(1 + TRAIN_STEPS):
        feed = lm_probe_feeds(np, i, b, s, MODEL["vocab_size"])
        t0 = time.perf_counter()
        loss, = exe.run(main_prog, feed=feed, fetch_list=[avg], scope=scope)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss[0]))
    launches = {name: getattr(fa, name).launches for name in TRAIN_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = 1e3 * sum(step_s[1:]) / TRAIN_STEPS
    print(f"train path: {n_params} parameters, startup {t_init:.2f} s, "
          f"losses {losses}, warm-up step {1e3 * step_s[0]:.1f} ms, "
          f"{TRAIN_STEPS} timed steps {[round(1e3 * x, 1) for x in step_s[1:]]}"
          f" ms: {ms:.3f} ms per step, {b * s / ms * 1e3:.1f} tokens/s, "
          f"peak memory {peak_gb:.2f} GB [{card}]")
    print(f"train path launches: {launches}")
    want = MODEL["n_layers"] * (1 + TRAIN_STEPS)
    for name, n in launches.items():
        if n != want:
            raise RuntimeError(f"{name} was launched {n} times on the "
                               f"training path, expected {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"training losses are not finite and falling: "
                           f"{losses}")
    feed = lm_probe_feeds(np, 1 + TRAIN_STEPS, b, s, MODEL["vocab_size"])
    wall, by_name = profiled(torch, lambda: exe.run(
        main_prog, feed=feed, fetch_list=[avg], scope=scope), 1)
    print_profile(f"training step (batch {b}, sequence {s})", wall, by_name,
                  card)
    program_vs_module(np, torch, pt, scope, card)
    return launches


def program_vs_module(np, torch, pt, scope, card):
    """The trained weights, by name, in the serving module: its forward
    logits equal those of an inference program that the training
    builder makes, on one sequence of the training length."""
    from paddle_tpu_torch.models.transformer import (TransformerLM,
                                                     param_shapes,
                                                     transformer_lm)

    s = TRAIN["seq_len"]
    infer = pt.Program()
    with pt.program_guard(infer, pt.Program()):
        src = pt.layers.data("src_ids", [s], dtype="int64")
        logits = transformer_lm(src, MODEL["vocab_size"], max_len=s,
                                **{k: MODEL[k] for k in ("n_layers",
                                                         "d_model", "n_heads",
                                                         "d_ff")})
    ids = np.random.default_rng(5).integers(
        0, MODEL["vocab_size"], (1, s)).astype(np.int64)
    exe = pt.Executor()
    got, = exe.run(infer, feed={"src_ids": ids}, fetch_list=[logits],
                   scope=scope, return_numpy=False)
    cfg = dict(MODEL, max_context=s)
    model = TransformerLM.from_config(cfg, device=exe.device)
    model.load_jax_params({p: scope.find_var(p) for p in param_shapes(cfg)})
    with torch.no_grad():
        want = model(torch.from_numpy(ids).to(exe.device))[0]
    torch.cuda.synchronize()
    diff = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= MODULE_ATOL + MODULE_RTOL * want.abs()).all())
    print(f"program vs module, full width, trained weights, 1 x {s} tokens: "
          f"logits max abs diff {float(diff.max()):.3e} (tol atol "
          f"{MODULE_ATOL} rtol {MODULE_RTOL}), logits max abs "
          f"{float(want.abs().max()):.3e} [{card}]")
    if not ok:
        raise RuntimeError("the Program path and the serving module disagree")
    del model


def card_vs_cpu(np, torch, card, seed: int):
    """One reduced program from one startup state: two Adam steps on the
    card and on the CPU agree."""
    import paddle_tpu_torch as pt

    cfg = {k: REDUCED[k] for k in ("vocab_size", "n_layers", "d_model",
                                   "n_heads", "d_ff")}
    s, b = REDUCED["seq_len"], REDUCED["batch"]
    main_prog, startup, avg = build_lm(pt, cfg, s, seed)
    cpu, gpu = pt.Executor(pt.CPUPlace()), pt.Executor()
    cpu_scope, gpu_scope = pt.Scope(), pt.Scope()
    cpu.run(startup, scope=cpu_scope)
    names = sorted(cpu_scope.local_var_names())
    start = {n: cpu_scope.get_numpy(n) for n in names}
    for name in names:
        gpu_scope.set_var(name, cpu_scope.find_var(name).to(gpu.device))
    loss_diff = []
    for i in range(2):
        feed = lm_probe_feeds(np, i, b, s, cfg["vocab_size"])
        lc, = cpu.run(main_prog, feed=feed, fetch_list=[avg], scope=cpu_scope)
        lg, = gpu.run(main_prog, feed=feed, fetch_list=[avg], scope=gpu_scope)
        loss_diff.append(abs(float(lg[0]) - float(lc[0])))
        if not loss_diff[-1] <= LOSS_RTOL * abs(float(lc[0])):
            raise RuntimeError(f"step {i}: card loss {lg[0]} vs CPU {lc[0]}")

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a.astype(np.float64)))))

    worst, worst_rel = 0.0, 0.0
    for n in names:
        got, want = gpu_scope.get_numpy(n), cpu_scope.get_numpy(n)
        worst = max(worst, float(np.abs(got - want).max()))
        is_acc = "_moment" in n or "_pow_acc" in n
        if not is_acc:
            got, want = got - start[n], want - start[n]
        if n.split("_moment")[0].endswith("_k_b"):
            continue
        if rms(want) > 0:
            worst_rel = max(worst_rel, rms(got - want) / rms(want))
        if not rms(got - want) <= STATE_RTOL * rms(want):
            raise RuntimeError(f"{n}: card vs CPU rms diff "
                               f"{rms(got - want):.3e}, rms {rms(want):.3e}")
    print(f"card vs CPU, reduced program, 2 Adam steps: loss diffs "
          f"{loss_diff} (tol rtol {LOSS_RTOL}), largest state diff "
          f"{worst:.3e} (tol atol {PARAM_ATOL}), largest relative rms diff "
          f"of an update or accumulator {worst_rel:.3e} (tol {STATE_RTOL}) "
          f"[{card}]")
    if not worst <= PARAM_ATOL:
        raise RuntimeError("card and CPU states disagree")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    report = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(report) or 'nothing (cached)'}")
    for src, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    dq_row, dkv_row = check_flash_bwd(torch, F, fa, card)
    rows = {"flash_attention_fwd": check_flash(torch, F, fa, card),
            "paged_decode_attention": check_paged(torch, fa, card),
            "flash_attention_bwd_dq": dq_row,
            "flash_attention_bwd_dkv": dkv_row}
    launches = main_path(np, torch, fa, card, args.seed)
    trained = train_path(np, torch, fa, card, args.seed)
    # the forward kernel runs on both main paths
    launches["flash_attention_fwd"] += trained["flash_attention_fwd"]
    launches.update(flash_attention_bwd_dq=trained["flash_attention_bwd_dq"],
                    flash_attention_bwd_dkv=trained["flash_attention_bwd_dkv"])
    card_vs_cpu(np, torch, card, args.seed)

    meta = {"flash_attention_fwd": (
                "paddle_tpu_torch/csrc/flash_attention.cu",
                "paddle_tpu/kernels/flash_attention.py:151"),
            "paged_decode_attention": (
                "paddle_tpu_torch/csrc/paged_attention.cu",
                "paddle_tpu/kernels/flash_attention.py:570"),
            "flash_attention_bwd_dq": (
                "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                "paddle_tpu/kernels/flash_attention.py:279"),
            "flash_attention_bwd_dkv": (
                "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                "paddle_tpu/kernels/flash_attention.py:298")}
    kernels = [dict(name=name, route="cuda", source=meta[name][0],
                    replaces=meta[name][1], launches=launches[name], **row)
               for name, row in rows.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
