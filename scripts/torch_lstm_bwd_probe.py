"""Where the time of the port's LSTM backward goes, on one GPU.

At chip_smoke.py's bench shape (T 100, B 64, H 512), full length and
ragged (``check_lstm``'s lengths), at the card-vs-CPU width (T 100, B 8,
H 128) and at twice the bench batch (T 100, B 128, H 512: two row tiles
a block), for the wrapper ``fused_lstm.lstm_seq_bwd`` (the sequence
kernel under the plan it takes), for the per-step path of this tree (2T + 4
launches, the backward of the shapes no plan takes) and, with ``--parent
DIR`` (DIR holds another tree, e.g. the parent unpacked by ``git
archive``), for that tree's wrapper, imported with its own ``build.py`` as
a package of its own, in turns (parent, this, this, parent), and so for
each ``--also DIR``:

* device ms a call and CUDA launches a call (``torch.profiler``), split
  by kernel: the recurrence (``lstm_bwd_seq_kernel``), the gates'
  recompute, dW, the rest;
* us a recurrence step (the recurrence's device time over T);
* the back-to-back event time that ``chip_smoke.cuda_ms`` reports;
* TFLOP/s of the products the data needs (the rows a sequence reaches:
  the recompute, dgates W^T and dW) and the shares of the f32 bound (67
  TFLOP/s) and of the 3xTF32 bound (three TF32 products each at 495
  TFLOP/s), each the larger of its operations and the bytes over 3.35
  TB/s.

Then builds of ``fused_lstm.cu`` that drop parts of the sequence kernel's
step, called through its entry point at the wrapper's plan, the
recurrence's device ms a call and us a step: ``barriers only`` (no
dgates loads, product or cell: a step is two __syncthreads, the inputs'
prefetch and the grid barrier), ``+ loads`` (the copies of dgates_{t+1}
from L2 land through the ring; no mma), ``+ product`` (the 3xTF32
product, no cell), the whole kernel, the whole kernel with a ring of 2
stages a warp instead of 4 (and ``+ loads`` so), and the whole kernel
without its grid barrier (its steps then read dgates that may not have
landed: a time, not a result). The differences split a step into
barrier, loads, product and cell. ptxas' registers and spills of the
sequence kernel, its HMMA and FFMA counts and its commonest opcodes
are printed. Every wrapper
call is first held against ``lstm_seq_bwd_reference`` (atol = rtol =
1e-4), two calls bit for bit.

Run from the repository root on a machine with the CUDA toolkit:
``python scripts/torch_lstm_bwd_probe.py [--parent DIR] [--also DIR]``.
"""

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
import torch_chain_ab as ab  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_lstm as fl  # noqa: E402
from torch_lstm_fwd_probe import parent_module  # noqa: E402

SOURCE = "fused_lstm.cu"
TOL = 1e-4
PRODUCT = ("        bwd_product(acc, ring, dg, wl, row0, B, K, k0, kb, g, tq, "
           "lane);\n", "")
MMA = (("        mma0(f[ss][j], as[ss], bb[ss][j][0], bb[ss][j][1]);",
        "        f[ss][j][0] = f[ss][j][1] = f[ss][j][2] = f[ss][j][3] = 0.f;"),
       ("        mma(f[ss][j], ab[ss], bs[ss][j][0], bs[ss][j][1]);", "        ;"),
       ("        mma(f[ss][j], ab[ss], bb[ss][j][0], bb[ss][j][1]);", "        ;"))
CELL = ("      if (col_ok && b < B) {\n        // dr carried",
        "      if (false) {\n        // dr carried")
RING = "constexpr int kUnitsB = 16, kMaxKBB = 16, kRing = 4, kMaxNTB = 28;"
RING2 = (RING, RING.replace("kRing = 4", "kRing = 2"))
BARRIER = ("      if (threadIdx.x == 0) grid_sync(bar, (unsigned)(T - t) * blocks);\n",
           "")
VARIANTS = {
    "barriers only": (PRODUCT, CELL),
    "+ loads": MMA + (CELL,),
    "+ product": (CELL,),
    "whole": (),
    "ring 2": (RING2,),
    "+ loads, ring 2": MMA + (CELL, RING2),
    "no grid barrier": (BARRIER,),
}
SPLIT = ("barriers only", "+ loads", "+ product", "whole")
# the backward's kernels by name: its parts (this tree's, and the f32
# SIMT products of older trees)
PARTS = (("recurrence", ("lstm_bwd_seq_kernel",)),
         ("gates", ("lstm_bwd_gemm_tc_kernel<true>",
                    "lstm_gemm_kernel<true, false>")),
         ("dW", ("lstm_bwd_gemm_tc_kernel<false>",
                 "lstm_gemm_kernel<false, false>")))


def part_of(name: str) -> str:
    for part, keys in PARTS:
        if any(key in name for key in keys):
            return part
    return "rest"


def compile_variants(out_dir: Path):
    """({name: library}, {name: ptxas log}) of builds of fused_lstm.cu
    with VARIANTS' substitutions, built in parallel."""
    jobs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        text = (build.CSRC / SOURCE).read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {SOURCE} has no {old!r}")
            text = text.replace(old, new)
        (vdir / SOURCE).write_text(text)
        (vdir / "tf32_mma.cuh").write_text(
            (build.CSRC / "tf32_mma.cuh").read_text())
        lib = vdir / "fused_lstm.so"
        jobs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(lib), str(vdir / SOURCE)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name], logs[name] = lib, log
    return libs, logs


def registers(log: str) -> list:
    """ptxas' stack, spills and registers of the sequence kernel."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1) if "lstm_bwd_seq_kernel" in m.group(1) else None
        elif name and ("spill" in line or "Used" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
            if "Used" in line:
                name = None
    return out


def instructions(lib: Path) -> list:
    """The sequence kernel's HMMA and FFMA counts and its 12 commonest
    opcodes, from its SASS."""
    out = []
    for name, text in sorted(ab.sass(lib).items()):
        if "lstm_bwd_seq_kernel" not in name:
            continue
        ops = {}
        for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)", text):
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
        out.append(f"{name}: {text.count('HMMA')} HMMA, {text.count('FFMA')}"
                   f" FFMA; {sum(ops.values())} instructions, "
                   f"{', '.join(f'{k} {v}' for k, v in top)}")
    return out


def entry(lib: Path):
    fn = getattr(ctypes.CDLL(str(lib)), fl._BWD_SEQ[0])
    fn.argtypes = list(fl._BWD_SEQ[1])
    fn.restype = ctypes.c_int
    return fn


def case(t, b, h, ragged, seed):
    """chip_smoke.check_lstm's backward inputs: the forward's carries
    (plain version) and cotangents; ragged: its lengths (1 and T among
    them)."""
    lens = None
    if ragged:
        rng = np.random.default_rng(seed + 11)
        lens = rng.integers(1, t + 1, b)
        lens[:2] = (1, t)
        lens = lens.tolist()
    d = chip_smoke.lstm_case(torch, t, b, h, lens, seed + 12)
    fwd = [d[k] for k in ("x", "w", "b", "mask", "r0", "c0")]
    rrs, rcs = fl.lstm_seq_fwd_reference(*fwd)
    live = t * b if lens is None else int(sum(lens))
    return fwd[:4] + [torch.cat([d["r0"][None], rrs[:-1]]),
                      torch.cat([d["c0"][None], rcs[:-1]]), d["drs"],
                      d["dcs"]], live


def by_part(fn, n: int = 10):
    """({part: device ms a call}, launches a call) from torch.profiler
    over n calls; None where five profiles lost kernel events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels and len(kernels) % n == 0:
            parts = {}
            for e in kernels:
                key = part_of(e.name)
                parts[key] = (parts.get(key, 0.0)
                              + e.time_range.elapsed_us() / 1e3 / n)
            return parts, len(kernels) // n
    return None, None


def line(name, parts, launches, ev, t, prod, nbytes):
    f32 = chip_smoke.bound_ms(nbytes, 3 * prod)[0]
    tf32 = chip_smoke.bound_ms(nbytes, 9 * prod,
                               chip_smoke.TF32_FLOPS_PER_S)[0]
    if parts is None:
        return f"  {name}: device not measured, event {ev:.4f} ms"
    dev = sum(parts.values())
    split = ", ".join(f"{k} {v:.4f}" for k, v in sorted(parts.items()))
    rec = parts.get("recurrence")
    step = "" if rec is None else f", {1e3 * rec / t:.3f} us a step"
    return (f"  {name}: device {dev:.4f} ms a call ({split}), {launches} "
            f"launches a call{step}, event {ev:.4f} ms; "
            f"{3 * prod / dev / 1e9:.2f} TFLOP/s; share of the f32 bound "
            f"{f32 / dev:.3f}, of the 3xTF32 bound {tf32 / dev:.3f}")


def check(mod, args):
    got = mod.lstm_seq_bwd(*args)
    again = mod.lstm_seq_bwd(*args)
    want = fl.lstm_seq_bwd_reference(*args)
    torch.cuda.synchronize()
    share = max(float(((g - w).abs() / (TOL + TOL * w.abs())).max())
                for g, w in zip(got, want))
    if share > 1:
        raise RuntimeError(f"{mod.__name__}: outside the 1e-4 limit "
                           f"({share:.3f} of it)")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise RuntimeError(f"{mod.__name__}: two calls differ")
    return share


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--also", type=Path, action="append", default=[],
                    help="another tree, timed in turns with this one")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_lstm_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(f"card: {card}")
    build.build([SOURCE])
    parent = parent_module(args.parent) if args.parent else None
    if parent is not None:
        parent.build.build([SOURCE])
    also = {f"also {i}": parent_module(tree, f"_also{i}_kernels")
            for i, tree in enumerate(args.also)}
    for mod in also.values():
        mod.build.build([SOURCE])
    libs, logs = compile_variants(build.BUILD_DIR / "lstm_bwd_probe")
    for reg in registers(logs["whole"]):
        print(f"ptxas {reg}")
    for ins in instructions(libs["whole"]):
        print(f"sass {ins}")
    fns = {name: entry(lib) for name, lib in libs.items()}
    dev = torch.device("cuda", torch.cuda.current_device())
    steps = fl._fn(*fl._BWD_STEPS)
    for t, b, h, ragged in ((100, 64, 512, False), (100, 64, 512, True),
                            (100, 8, 128, False), (100, 128, 512, False)):
        bwd, live = case(t, b, h, ragged, args.seed)
        prod = 2 * live * h * 4 * h
        nbytes = 4 * (2 * t * b * 4 * h + 2 * h * 4 * h + 2 * 4 * h + t * b
                      + 4 * t * b * h + 2 * b * h)
        plan = fl._bwd_plan_of(b, h, dev.index)
        shares = {"this tree": check(fl, bwd)}
        if parent is not None:
            shares["parent"] = check(parent, bwd)
        for name, mod in also.items():
            shares[name] = check(mod, bwd)
        print(f"T {t}, B {b}, H {h}, {'ragged' if ragged else 'full length'}"
              f" ({live} live rows): plan {plan}; largest share of the 1e-4 "
              f"limit {', '.join(f'{k} {v:.4f}' for k, v in shares.items())}"
              f" [{card}]")
        ptrs = [v.data_ptr() for v in bwd]
        f32 = dict(dtype=torch.float32, device=dev)
        outs = [torch.empty(t, b, 4 * h, **f32), torch.empty(h, 4 * h, **f32),
                torch.empty(4 * h, **f32), torch.empty(b, h, **f32),
                torch.empty(b, h, **f32)]
        optrs = [o.data_ptr() for o in outs]
        gates = torch.empty(t, b, 4 * h, **f32)
        slices = fl._dr_slices(b, h, build.sm_count(dev))
        part = torch.empty(slices, b, h, **f32)
        drb = torch.empty(b, h, **f32)
        dbp = torch.empty(plan.grid[1], 4 * h, **f32)
        stream = build.stream(dev)

        def per_step_path():
            build.launch("steps", steps, *ptrs, *optrs, gates.data_ptr(),
                         part.data_ptr(), drb.data_ptr(), t, b, h, slices,
                         stream)

        calls = {"this tree": lambda: fl.lstm_seq_bwd(*bwd),
                 "per-step path (this tree)": per_step_path}
        order = list(calls)
        if parent is not None:
            calls["parent"] = lambda: parent.lstm_seq_bwd(*bwd)
            order = ["parent", "this tree", "this tree", "parent",
                     "per-step path (this tree)"]
        for name, mod in also.items():
            calls[name] = lambda mod=mod: mod.lstm_seq_bwd(*bwd)
            order += [name, "this tree", "this tree", name]
        got = {}
        for name in order:
            parts, launches = by_part(calls[name])
            ev = chip_smoke.cuda_ms(torch, calls[name], 10)
            got.setdefault(name, []).append((parts, launches, ev))
        for name, ms in got.items():
            parts = None
            if all(m[0] is not None for m in ms):
                keys = set().union(*(m[0] for m in ms))
                parts = {k: sum(m[0].get(k, 0.0) for m in ms) / len(ms)
                         for k in keys}
            ev = sum(m[2] for m in ms) / len(ms)
            print(line(name, parts, ms[0][1], ev, t, prod, nbytes))
            if len(ms) > 1:
                print(f"    in turns: device "
                      f"{[None if m[0] is None else round(sum(m[0].values()), 4) for m in ms]}"
                      f" ms, event {[round(m[2], 4) for m in ms]} ms")
        barrier = fl._barrier_of(dev, stream)
        split = {}
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                build.launch(name, fn, *ptrs, *optrs, gates.data_ptr(),
                             dbp.data_ptr(), barrier, t, b, h, plan.mt,
                             plan.kb, plan.nt, stream)
            parts, launches = by_part(call)
            split[name] = None if parts is None else parts.get("recurrence")
            print(line(f"{name} build", parts, launches,
                       chip_smoke.cuda_ms(torch, call, 10), t, prod, nbytes))
        us = [None if split[n] is None else 1e3 * split[n] / t
              for n in SPLIT]
        if None not in us:
            print(f"  a recurrence step: barrier {us[0]:.3f} us, loads "
                  f"{us[1] - us[0]:.3f} us, product {us[2] - us[1]:.3f} us,"
                  f" cell {us[3] - us[2]:.3f} us (whole {us[3]:.3f} us)")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
