"""Time the bf16 chain's wgmma products (csrc/abt_bf16_tc.cuh) against
another tree's build of ``csrc/fused_block_bf16.cu``, in turns, on the
card.

At each of ResNet-50's three chain stages (``chip_smoke.CHAIN_SHAPES``,
batch ``--batch``), on the inputs phase 3 makes (``chip_smoke.chain_case``
rounded to bf16, ``chip_smoke.chain_bwd_inputs`` from a bf16 cotangent of
out): ``bwd_reduce3_bf16`` (row 10b) and ``bwd_mid_bf16`` (row 12b), each
held to phase 3's limits against its plain version
(``chip_smoke.bf16_bwd_readings``) in both trees, then timed by CUDA
events in turns (other, this, this, other; 20 calls each), and the tap
pass alone (the tap kernel and its fixed-order pass over the splits, by
torch.profiler over 10 calls of bwd_mid_bf16) with its tensor-core rate
(18 C² N·S operations over the tap kernel's time; 989 TFLOP/s dense bf16
is the card's peak). Each row's bound is phase 3's (bytes at 3.35 TB/s,
products at 989 TFLOP/s). Also printed: ptxas' registers and spill stores
of each tree's kernels of the two rows, and the card's name and power
limit beside every time. ``--parent DIR`` holds the other tree (e.g. the
parent commit unpacked by ``git archive`` into the git-ignored
_chipwork/parent): its kernels package is imported as a package of its
own and builds its own ``fused_block_bf16.cu``.

With ``--step`` it instead times the bench's bf16 ResNet-50 program
(``chip_smoke.build_resnet50_bf16``, batch 128, 224 px, phase 22's
centred feed) trained through the bf16 chain (``PT_FUSED_BLOCK=always``)
with the chain of the tree ``--tree DIR`` (this one by default, imported
from DIR): the wall a step (host clock, each step ending in its loss's
fetch) over 6 steps after 2 of warm-up, then the device time of 3
profiled steps by kernel class (``chip_smoke.kernel_class`` of that
tree) and the idle share; one process a tree, so that two trees run in
turns from a shell loop.

With ``--ablate`` it times, at the three stages, the two kernels of
this tree beside builds of ``csrc/abt_bf16_tc.cuh`` made by removing
work from copies of the source (each compiled with ``nvcc`` as the build
compiles it, the wrappers pointed at it): the tap kernel without its
``wgmma`` (the fragments gathered, nothing multiplied), without its A
gathers (each ldmatrix reading the zero row: no address arithmetic, no
masks), without the normalisation of h1 (the ring's tiles left as they
are), and with none of the three (its copies only); the reduce3 kernel
without its ``wgmma``, without its transforms (g3 and h2 neither made nor
written back, g3 not stored), and with neither. Kernel time by
torch.profiler over 10 calls of each wrapper; the ablations compute
nothing useful.

    python scripts/torch_chain_bf16_probe.py --parent _chipwork/parent
    for t in _chipwork/parent . . _chipwork/parent; do
        python scripts/torch_chain_bf16_probe.py --step --tree $t; done
    python scripts/torch_chain_bf16_probe.py --ablate
"""

import argparse
import ctypes
import importlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def _tree() -> Path:
    """The tree whose package and chip_smoke this process imports: --tree's
    where given (--step), else this one."""
    if "--tree" in sys.argv:
        return Path(sys.argv[sys.argv.index("--tree") + 1]).resolve()
    return ROOT


sys.path.insert(0, str(_tree()))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_block as fb  # noqa: E402

SOURCE = "fused_block_bf16.cu"
ROWS = ("bwd_reduce3", "bwd_mid")
# the kernels of the two rows in ptxas' (mangled) names and in the
# profiler's: this tree's (abw::) and the parent's (ab::abt_bf16_kernel,
# mode 0 the reduce3, 1 the taps)
PTXAS = {"bwd_reduce3": r"abw\d*reduce3_bf16_kernel|abt_bf16_kernelILi\d+ELi"
                        r"\d+ELi0E",
         "bwd_mid": r"abw\d*taps_bf16_kernel|abt_bf16_kernelILi\d+ELi\d+ELi1E|"
                    r"conv3x3_bf16_kernelILi\d+ELi1E|fold_bf16"}
TAP_KERNEL = re.compile(r"taps_bf16_kernel|abt_bf16_kernel<\d+, \d+, 1")
R3_KERNEL = re.compile(r"reduce3_bf16_kernel|abt_bf16_kernel<\d+, \d+, 0")
# the ablations: (row, what, [(text of csrc/abt_bf16_tc.cuh, its stand-in)])
ABLATIONS = (
    ("bwd_mid", "no wgmma", [
        ("      sm90::wgmma_rs<64, 0>(acc[dxi], a[0], sm90::desc_k(dtile, ks), 1);\n"
         "      sm90::wgmma_rs<64, 0>(acc[dxi], a[1], sm90::desc_k(dtile, ks + 1), 1);\n",
         "")]),
    ("bwd_mid", "no A gathers", [
        ("      ldsm_x4<true>(a[0], a_row(ks, dxi - 1));\n"
         "      ldsm_x4<true>(a[1], a_row(ks + 1, dxi - 1));\n",
         "      ldsm_x4<true>(a[0], zero);\n      ldsm_x4<true>(a[1], zero);\n")]),
    ("bwd_mid", "no normalisation", [
        ("      for (int pc = tw; pc < chunks; pc += 3) {",
         "      for (int pc = tw; pc < 0; pc += 3) {")]),
    ("bwd_mid", "copies only", [
        ("      sm90::wgmma_rs<64, 0>(acc[dxi], a[0], sm90::desc_k(dtile, ks), 1);\n"
         "      sm90::wgmma_rs<64, 0>(acc[dxi], a[1], sm90::desc_k(dtile, ks + 1), 1);\n",
         ""),
        ("      ldsm_x4<true>(a[0], a_row(ks, dxi - 1));\n"
         "      ldsm_x4<true>(a[1], a_row(ks + 1, dxi - 1));\n",
         "      ldsm_x4<true>(a[0], zero);\n      ldsm_x4<true>(a[1], zero);\n"),
        ("      for (int pc = tw; pc < chunks; pc += 3) {",
         "      for (int pc = tw; pc < 0; pc += 3) {")]),
    ("bwd_reduce3", "no wgmma", [
        ("      sm90::wgmma_ss<BN, 0>(acc, sm90::desc_k(sa, ks), sm90::desc_k(sb, ks),\n"
         "                            1);\n", "")]),
    ("bwd_reduce3", "no transforms", [
        ("#pragma unroll kUnrollG\n    for (int it = 0; it < 4; ++it) {",
         "#pragma unroll kUnrollG\n    for (int it = 0; it < 0; ++it) {"),
        ("    if (first && (S & 7) != 0) {", "    if (false) {"),
        ("#pragma unroll kUnrollH\n    for (int it = 0; it < HT; ++it) {",
         "#pragma unroll kUnrollH\n    for (int it = 0; it < 0; ++it) {")]),
    ("bwd_reduce3", "copies only", [
        ("      sm90::wgmma_ss<BN, 0>(acc, sm90::desc_k(sa, ks), sm90::desc_k(sb, ks),\n"
         "                            1);\n", ""),
        ("#pragma unroll kUnrollG\n    for (int it = 0; it < 4; ++it) {",
         "#pragma unroll kUnrollG\n    for (int it = 0; it < 0; ++it) {"),
        ("    if (first && (S & 7) != 0) {", "    if (false) {"),
        ("#pragma unroll kUnrollH\n    for (int it = 0; it < HT; ++it) {",
         "#pragma unroll kUnrollH\n    for (int it = 0; it < 0; ++it) {")]),
)


def parent_module(parent: Path):
    """The other tree's kernels/fused_block.py, imported with its own
    build.py as the package _parent_kernels."""
    pkg = types.ModuleType("_parent_kernels")
    pkg.__path__ = [str(parent / "paddle_tpu_torch" / "kernels")]
    sys.modules["_parent_kernels"] = pkg
    return importlib.import_module("_parent_kernels.fused_block")


def regs(report: dict, row: str) -> str:
    got = [f"{e[:60]}: {r} registers, {s} bytes spilled"
           for e, (r, s) in cs.ptxas_of(report, SOURCE).items()
           if re.search(PTXAS[row], e)]
    return "; ".join(got) if got else "not measured (cached build)"


def tap_pass_ms(fn) -> tuple:
    """(tap kernel ms, its split pass ms) a call of bwd_mid_bf16, from the
    profiler; None where it saw no device time."""
    _, by_name, _ = cs.profiled(torch, fn, 10)
    if not by_name:
        return None, None
    tap = sum(ms for name, ms in by_name.items() if TAP_KERNEL.search(name))
    split = sum(ms for name, ms in by_name.items()
                if "split_sum_kernel" in name)
    return tap, split


def kernel_ms(fn, pattern) -> float:
    """Device ms a call of the kernels whose names match `pattern`."""
    _, by_name, _ = cs.profiled(torch, fn, 10)
    return sum(ms for name, ms in by_name.items() if pattern.search(name))


def ablate_mode(card: str, n: int) -> int:
    """The two kernels beside builds with parts of their work removed."""
    root = Path(tempfile.mkdtemp(prefix="abw_ablate_", dir=build.BUILD_DIR))
    build.build([SOURCE])
    jobs = {}
    for i, (row, what, edits) in enumerate(ABLATIONS):
        d = root / str(i)
        shutil.copytree(build.CSRC, d)
        text = (d / "abt_bf16_tc.cuh").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{row} {what}: the source moved")
            text = text.replace(old, new)
        (d / "abt_bf16_tc.cuh").write_text(text)
        lib = d / "variant.so"
        jobs[i] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(d / SOURCE)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for i, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation {ABLATIONS[i][:2]}: nvcc failed\n{log}")
        libs[i] = ctypes.CDLL(str(lib))
    real = fb._bf_fn

    def pointed(lib):
        def fn(name, argtypes):
            f = getattr(lib, name)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            return f
        return fn

    gen = torch.Generator(device="cuda").manual_seed(18)
    bf = torch.bfloat16
    pattern = {"bwd_mid": TAP_KERNEL, "bwd_reduce3": R3_KERNEL}
    try:
        for cin, c, h in cs.CHAIN_SHAPES:
            s = h * h
            d = cs.chain_case(torch, n, cin, c, h, gen)
            for k in ("x", "w1", "taps", "w3"):
                d[k] = d[k].to(bf)
            dout = torch.randn(n, cin, s, device="cuda", generator=gen).to(bf)
            inputs = cs.chain_bwd_inputs(torch, fb, d, dout, h, "_bf16")
            del d, dout
            for row in ROWS:
                call = (lambda row=row:
                        getattr(fb, row + "_bf16")(*inputs[row]))
                fb._bf_fn = real
                got = {"the kernel": kernel_ms(call, pattern[row])}
                for i, (r, what, _) in enumerate(ABLATIONS):
                    if r != row:
                        continue
                    fb._bf_fn = pointed(libs[i])
                    got[what] = kernel_ms(call, pattern[row])
                fb._bf_fn = real
                print(f"{row}_bf16 kernel, Cin {cin}, C {c}, {h}x{h}, batch "
                      f"{n}: " + ", ".join(f"{k} {v:.4f} ms"
                                           for k, v in got.items())
                      + f" [{card}]")
            del inputs
            torch.cuda.empty_cache()
    finally:
        fb._bf_fn = real
        shutil.rmtree(root, ignore_errors=True)
    return 0


def step_mode(card: str) -> int:
    """The bf16 program's chain step of this process's tree: wall and
    device by kernel class."""
    import numpy as np

    import paddle_tpu_torch as pt

    build.build()
    b, img = cs.RESNET["batch"], cs.RESNET["image"]
    bf = cs.build_resnet50_bf16(pt, 0)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(bf["startup"], scope=scope)
    feed = {k: torch.from_numpy(v).to(exe.device)
            for k, v in cs.resnet_varied(np, 0, b, img, center=0.5).items()}
    os.environ["PT_FUSED_BLOCK"] = "always"

    def step():
        loss, = exe.run(bf["main"], feed=feed, fetch_list=[bf["avg"]],
                        scope=scope)
        return float(loss[0])

    for _ in range(2):
        step()
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        times.append(1e3 * (time.perf_counter() - t0))
    wall, by_name, _ = cs.profiled(torch, step, 3)
    classes = {}
    for name, ms in by_name.items():
        k = cs.kernel_class(name)
        classes[k] = classes.get(k, 0.0) + ms
    busy = sum(by_name.values())
    top = sorted(classes.items(), key=lambda kv: -kv[1])[:8]
    print(f"bf16 chain step ({_tree().name or _tree()}): wall "
          f"{sum(times) / len(times):.3f} ms a step (steps "
          f"{[round(t, 2) for t in times]}), profiled wall {wall:.3f} ms, "
          f"device {busy:.3f} ms, idle share {1 - busy / wall:.3f}; "
          + "; ".join(f"{k} {ms:.3f}" for k, ms in top) + f" [{card}]")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--tree", type=Path)
    ap.add_argument("--batch", type=int, default=cs.RESNET["batch"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}")
    if args.step:
        return step_mode(card)
    if args.ablate:
        return ablate_mode(card, args.batch)
    if args.parent is None:
        ap.error("--parent DIR is needed without --step")
    trees = {"this": fb, "other": parent_module(args.parent.resolve())}
    reports = {"this": build.build([SOURCE]),
               "other": trees["other"].build.build([SOURCE])}
    for row in ROWS:
        for name, rep in reports.items():
            print(f"{row}_bf16 ({name}): {regs(rep, row)}")
    gen = torch.Generator(device="cuda").manual_seed(18)
    n, bf = args.batch, torch.bfloat16
    for cin, c, h in cs.CHAIN_SHAPES:
        s, m = h * h, n * h * h
        d = cs.chain_case(torch, n, cin, c, h, gen)
        for k in ("x", "w1", "taps", "w3"):
            d[k] = d[k].to(bf)
        dout = torch.randn(n, cin, s, device="cuda", generator=gen).to(bf)
        inputs = cs.chain_bwd_inputs(torch, fb, d, dout, h, "_bf16")
        del d, dout
        ea, ex = n * c * s, n * cin * s
        bounds = {
            "bwd_reduce3": cs.bound_ms(
                2 * (3 * ex + ea) + 4 * (2 * c + cin * (c + 1)),
                2 * cin * c * m, cs.BF16_FLOPS_PER_S),
            "bwd_mid": cs.bound_ms(
                2 * (4 * ea + 9 * c * c) + 4 * (9 * c + 9 * c * c),
                36 * c * c * m, cs.BF16_FLOPS_PER_S),
            "taps": cs.bound_ms(2 * 2 * ea + 4 * 9 * c * c,
                                18 * c * c * m, cs.BF16_FLOPS_PER_S)}
        for row in ROWS:
            a = inputs[row]
            want = getattr(fb, row + "_reference")(*a)
            calls, shares = {}, {}
            for name, mod in trees.items():
                fn = (lambda mod=mod, row=row, a=a:
                      getattr(mod, row + "_bf16")(*a))
                got = fn()
                torch.cuda.synchronize()
                readings = cs.bf16_bwd_readings(torch, fb, row, a, got, want)
                shares[name] = max(sh for sh, _ in readings.values())
                if shares[name] > 1:
                    raise RuntimeError(f"{row}_bf16 ({name}) beyond its "
                                       f"limits: {readings}")
                calls[name] = fn
                del got
            times = {"this": [], "other": []}
            for name in ("other", "this", "this", "other"):
                times[name].append(cs.cuda_ms(torch, calls[name], 20))
            mean = {k: sum(v) / len(v) for k, v in times.items()}
            bound, by = bounds[row]
            print(f"{row}_bf16 Cin {cin}, C {c}, {h}x{h}, batch {n}: this "
                  f"{mean['this']:.4f} ms ({', '.join(f'{t:.4f}' for t in times['this'])}), "
                  f"other {mean['other']:.4f} ms ({', '.join(f'{t:.4f}' for t in times['other'])}), "
                  f"{mean['other'] / mean['this']:.2f}x; bound {bound:.4f} ms "
                  f"({by}), this at {bound / mean['this']:.3f} of it; "
                  f"largest share of its limits this {shares['this']:.4f}, "
                  f"other {shares['other']:.4f} [{card}]")
            if row == "bwd_mid":
                tb, tby = bounds["taps"]
                for name in ("other", "this"):
                    tap, split = tap_pass_ms(calls[name])
                    if tap is None:
                        print(f"tap pass ({name}): the profiler saw no "
                              f"device time [{card}]")
                        continue
                    print(f"tap pass ({name}) C {c}, {h}x{h}: tap kernel "
                          f"{tap:.4f} ms + split pass {split:.4f} ms, "
                          f"{18 * c * c * m / tap / 1e9:.1f} TFLOP/s on the "
                          f"tensor cores ({18 * c * c * m / tap / 1e9 / 989:.3f}"
                          f" of 989); bound {tb:.4f} ms ({tby}) [{card}]")
        del inputs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
