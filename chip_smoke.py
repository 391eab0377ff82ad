#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure ends the run with a non-zero exit code and
no result line:

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels from the sources in paddle_tpu_torch/csrc;
3. hold each kernel against its plain PyTorch version at the serving
   path's shapes, and time the kernel, the plain version and (for flash
   attention) PyTorch's scaled_dot_product_attention;
4. serve the Transformer LM at full width (vocab 32000, 6 layers,
   d_model 2048, 8 heads, d_ff 8192, context 1024, 8 slots, 16-token
   blocks, random weights from --seed) through DecodeEngine: 12 requests,
   launch counts read around the run, then a teacher-forced check of two
   requests against the prefill path, then device time by kernel
   (torch.profiler) for one prefill per bucket and for decode steps;
5. print the kernels' JSON line, the card line and the result line.
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
# decode path vs prefill path on the same tokens: f32 through every layer
# at width 2048, with GEMV-shaped vs GEMM-shaped products and paged vs
# flash attention sums, so the logits differ by more than one kernel does
LOGIT_TOL = 1e-3

MODEL = dict(vocab_size=32000, n_layers=6, d_model=2048, n_heads=8,
             d_ff=8192, max_context=1024)
BUCKETS = (128, 256, 512, 1024)
SLOTS, BLOCK, POOL_BLOCKS = 8, 16, 513
N_REQUESTS, MAX_NEW = 12, 32


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


def max_err(torch, got, want) -> float:
    """Largest |got - want|; raises if any element is outside the
    stated tolerance or not finite."""
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("kernel output is not finite")
    if not bool((diff <= KERNEL_ATOL + KERNEL_RTOL * want.abs()).all()):
        raise RuntimeError(f"kernel disagrees with its plain version: "
                           f"max abs err {float(diff.max()):.3e}")
    return float(diff.max())


def check_flash(torch, F, fa, card):
    """Flash forward vs its plain version at B=1, H=8, D=256, causal."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    row, errs = None, []
    for s in (128, 1024, 333):
        q, k, v = (torch.randn(1, s, 8, 256, device="cuda", generator=gen)
                   for _ in range(3))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max(max_err(torch, o, ro), max_err(torch, lse, rlse))
        errs.append(err)
        pairs = s * (s + 1) // 2 * 8
        nbytes = 4 * (4 * s * 8 * 256 + 8 * s)
        b_ms, b_by = bound_ms(nbytes, 4 * 256 * pairs)
        ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v,
                                                           causal=True), 20)
        plain = cuda_ms(torch, lambda: fa.flash_attention_fwd_reference(
            q, k, v, causal=True), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20)
        print(f"flash_attention_fwd S={s}: max_abs_err {err:.3e} (tol "
              f"atol {KERNEL_ATOL} rtol {KERNEL_RTOL}), kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}) [{card}]")
        if s == max(BUCKETS):
            row = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib)
    row["max_abs_err"] = max(errs)
    return row


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

    rows = {"flash_attention_fwd": check_flash(torch, F, fa, card),
            "paged_decode_attention": check_paged(torch, fa, card)}
    launches = main_path(np, torch, fa, card, args.seed)

    meta = {"flash_attention_fwd": (
                "paddle_tpu_torch/csrc/flash_attention.cu",
                "paddle_tpu/kernels/flash_attention.py:151"),
            "paged_decode_attention": (
                "paddle_tpu_torch/csrc/paged_attention.cu",
                "paddle_tpu/kernels/flash_attention.py:570")}
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
