"""Time the bf16 chain's wgmma kernels (csrc/abt_bf16_tc.cuh,
csrc/conv1x1_bf16_tc.cuh) against another tree's build of
``csrc/fused_block_bf16.cu``, in turns, on the card.

At each of ResNet-50's three chain stages (``chip_smoke.CHAIN_SHAPES``,
batch ``--batch``), on the inputs phase 3 makes (``chip_smoke.chain_case``
rounded to bf16; the forward's plain versions for
``conv1x1_bn_residual_bf16``, ``chip_smoke.chain_bwd_inputs`` from a bf16
cotangent of out for the backward), each row
(``conv1x1_bn_residual`` row 16b, ``bwd_final`` row 13b, ``bwd_reduce3``
row 10b and ``bwd_mid`` row 12b) is held to phase
3's limits against its plain version (``chip_smoke.bf16_share``,
``chip_smoke.bf16_bwd_readings``) in both trees, then timed by CUDA events
in turns (other, this, this, other; 20 calls each), beside the library
call phase 3 times as its yardstick. For bwd_final its launches apart
(the fold, dx's tile, dW1 and its fixed-order pass over the splits, by
torch.profiler over 10 calls), for bwd_mid its tap pass (the tap kernel
and its pass) with its tensor-core rate (18 C² N·S operations over the
tap kernel's time; 989 TFLOP/s dense bf16 is the card's peak). Each
row's bound is phase 3's (bytes at 3.35 TB/s, products at 989 TFLOP/s).
Also printed: ptxas' registers and spill stores of each tree's kernels of
the rows, and the card's name and power limit beside every time.
``--parent DIR`` holds the other tree (e.g. the parent commit unpacked by
``git archive`` into the git-ignored _chipwork/parent): its kernels
package is imported as a package of its own and builds its own
``fused_block_bf16.cu``.

With ``--step`` it instead times the bench's bf16 ResNet-50 program
(``chip_smoke.build_resnet50_bf16``, batch 128, 224 px, phase 22's
centred feed) trained through the bf16 chain (``PT_FUSED_BLOCK=always``)
with the chain of the tree ``--tree DIR`` (this one by default, imported
from DIR): the wall a step (host clock, each step ending in its loss's
fetch) over 6 steps after 2 of warm-up, then the device time of 3
profiled steps by kernel class (``chip_smoke.kernel_class`` of that
tree) and the idle share; one process a tree, so that two trees run in
turns from a shell loop.

With ``--ablate`` it times, at the three stages, the wgmma kernels of
the rows of this tree beside builds of their sources made by removing
work from copies (each compiled with ``nvcc`` as the build compiles it,
the wrappers pointed at it): the 1x1 tile (rows 16b and 13b's dx) without
its ``wgmma``, without its epilogue's stores (the TMA stores and the
consumers' write-out), and with its copies alone (no B transform, no
``wgmma``, no epilogue, no stores); the tap kernel without its ``wgmma``
(the fragments gathered, nothing multiplied), without its A gathers
(each ldmatrix reading the zero row: no address arithmetic, no masks),
without the normalisation of h1 (the ring's tiles left as they are), and
with none of the three (its copies only); the reduce3 kernel without its
``wgmma``, without its transforms (g3 and h2 neither made nor written
back, g3 not stored), and with neither. Kernel time by torch.profiler over
10 calls of each wrapper; the ablations compute nothing useful.

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
ROWS = ("conv1x1_bn_residual", "bwd_final", "bwd_reduce3", "bwd_mid")
# the kernels of the rows in ptxas' (mangled) names, this tree's and the
# parent's: 16b and 13b's dx on t1:: (the parent: c1:: modes 1 and 3),
# dW1 and P on abw:: (the parent: ab::abt_bf16_kernel mode 2 for dW1)
PTXAS = {"conv1x1_bn_residual": r"tile1x1_bf16_kernelILi\d+ELi0E|"
                                r"conv1x1_bf16_kernelILi\d+ELi1E",
         "bwd_final": r"tile1x1_bf16_kernelILi\d+ELi1E|reduce3_bf16_kernel"
                      r"ILi\d+ELi1E|conv1x1_bf16_kernelILi\d+ELi3E|"
                      r"abt_bf16_kernelILi\d+ELi\d+ELi2E|fold_bf16",
         "bwd_reduce3": r"abw\d*reduce3_bf16_kernelILi\d+E(Li0E)?E",
         "bwd_mid": r"abw\d*taps_bf16_kernel|"
                    r"conv3x3_bf16_kernelILi\d+ELi1E|fold_bf16"}
TAP_KERNEL = re.compile(r"taps_bf16_kernel")
R3_KERNEL = re.compile(r"reduce3_bf16_kernel<\d+, 0>|reduce3_bf16_kernel<\d+>")
TILE_KERNEL = re.compile(r"tile1x1_bf16_kernel")
# bwd_final's launches apart, by the profiler's names (this tree's and the
# parent's)
FINAL_PARTS = (("fold", r"fold_bf16_kernel"),
               ("dx", r"tile1x1_bf16_kernel|conv1x1_bf16_kernel<\d+, 3"),
               ("dW1", r"reduce3_bf16_kernel<\d+, 1>|abt_bf16_kernel<\d+, "
                       r"\d+, 2"),
               ("splits", r"split_sum_kernel"))
TILE = "conv1x1_bf16_tc.cuh"
ABW = "abt_bf16_tc.cuh"
TILE_NO_WGMMA = (TILE, """          sm90::wgmma_ss<64, 1>(
              acc[mt], sm90::desc_k(sa + (mt * KT + kt) * abw::kTile, ks),
              sm90::desc_mn(sb + kt * abw::kTile, ks), (kt | ks) != 0);
""", "          ;\n")
TILE_NO_STORES = ((TILE, "          sm90::tma_store_4d(&ty,",
                   "          if (false) sm90::tma_store_4d(&ty,"),
                  (TILE, "      for (int it = 0; it < RW / 16; ++it) {",
                   "      for (int it = 0; it < 0; ++it) {"))
TILE_NO_TRANSFORM = (
    TILE, "(kMode == kResidual || k > 1) && it < 64 / RP * KT;",
    "(kMode == kResidual || k > 1) && it < 0;")
TILE_NO_EPILOGUE = (TILE, """        for (int j = 0; j < 8; ++j) {
          const int x = 8 * j + 2 * t + sk;""", """        for (int j = 0; j < 0; ++j) {
          const int x = 8 * j + 2 * t + sk;""")
# the ablations: (row, what, [(source, its text, its stand-in)])
ABLATIONS = (
    ("conv1x1_bn_residual", "no wgmma", [TILE_NO_WGMMA]),
    ("conv1x1_bn_residual", "no epilogue stores", list(TILE_NO_STORES)),
    ("conv1x1_bn_residual", "copies only",
     [TILE_NO_WGMMA, TILE_NO_TRANSFORM, TILE_NO_EPILOGUE,
      *TILE_NO_STORES]),
    ("bwd_final", "no wgmma", [TILE_NO_WGMMA]),
    ("bwd_final", "no epilogue stores", list(TILE_NO_STORES)),
    ("bwd_final", "copies only",
     [TILE_NO_WGMMA, TILE_NO_TRANSFORM, TILE_NO_EPILOGUE,
      *TILE_NO_STORES]),
    ("bwd_mid", "no wgmma", [
        (ABW, "      sm90::wgmma_rs<64, 0>(acc[dxi], a[0], sm90::desc_k(dtile, ks), 1);\n"
         "      sm90::wgmma_rs<64, 0>(acc[dxi], a[1], sm90::desc_k(dtile, ks + 1), 1);\n",
         "")]),
    ("bwd_mid", "no A gathers", [
        (ABW, "      ldsm_x4<true>(a[0], a_row(ks, dxi - 1));\n"
         "      ldsm_x4<true>(a[1], a_row(ks + 1, dxi - 1));\n",
         "      ldsm_x4<true>(a[0], zero);\n      ldsm_x4<true>(a[1], zero);\n")]),
    ("bwd_mid", "no normalisation", [
        (ABW, "      for (int pc = tw; pc < chunks; pc += 3) {",
         "      for (int pc = tw; pc < 0; pc += 3) {")]),
    ("bwd_mid", "copies only", [
        (ABW, "      sm90::wgmma_rs<64, 0>(acc[dxi], a[0], sm90::desc_k(dtile, ks), 1);\n"
         "      sm90::wgmma_rs<64, 0>(acc[dxi], a[1], sm90::desc_k(dtile, ks + 1), 1);\n",
         ""),
        (ABW, "      ldsm_x4<true>(a[0], a_row(ks, dxi - 1));\n"
         "      ldsm_x4<true>(a[1], a_row(ks + 1, dxi - 1));\n",
         "      ldsm_x4<true>(a[0], zero);\n      ldsm_x4<true>(a[1], zero);\n"),
        (ABW, "      for (int pc = tw; pc < chunks; pc += 3) {",
         "      for (int pc = tw; pc < 0; pc += 3) {")]),
    ("bwd_reduce3", "no wgmma", [
        (ABW, "      sm90::wgmma_ss<BN, 0>(acc, sm90::desc_k(sa, ks), sm90::desc_k(sb, ks),\n"
         "                            1);\n", "")]),
    ("bwd_reduce3", "no transforms", [
        (ABW, "#pragma unroll kUnrollG\n      for (int it = 0; it < 4; ++it) {",
         "#pragma unroll kUnrollG\n      for (int it = 0; it < 0; ++it) {"),
        (ABW, "      if (first && (S & 7) != 0) {", "      if (false) {"),
        (ABW, "#pragma unroll kUnrollH\n      for (int it = 0; it < HT; ++it) {",
         "#pragma unroll kUnrollH\n      for (int it = 0; it < 0; ++it) {")]),
    ("bwd_reduce3", "copies only", [
        (ABW, "      sm90::wgmma_ss<BN, 0>(acc, sm90::desc_k(sa, ks), sm90::desc_k(sb, ks),\n"
         "                            1);\n", ""),
        (ABW, "#pragma unroll kUnrollG\n      for (int it = 0; it < 4; ++it) {",
         "#pragma unroll kUnrollG\n      for (int it = 0; it < 0; ++it) {"),
        (ABW, "      if (first && (S & 7) != 0) {", "      if (false) {"),
        (ABW, "#pragma unroll kUnrollH\n      for (int it = 0; it < HT; ++it) {",
         "#pragma unroll kUnrollH\n      for (int it = 0; it < 0; ++it) {")]),
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


def row_inputs(gen, n: int, cin: int, c: int, h: int) -> dict:
    """{row: its wrapper's args} at one chain stage, as phase 3 makes
    them: conv1x1_bn_residual's from the bf16 forward's plain versions
    (chip_smoke.check_chain_bf16), the backward's by
    chip_smoke.chain_bwd_inputs from a bf16 cotangent of out."""
    bf, s, m = torch.bfloat16, h * h, n * h * h
    d = cs.chain_case(torch, n, cin, c, h, gen)
    for k in ("x", "w1", "taps", "w3"):
        d[k] = d[k].to(bf)
    dout = torch.randn(n, cin, s, device="cuda", generator=gen).to(bf)
    inputs = cs.chain_bwd_inputs(torch, fb, d, dout, h, "_bf16")
    ra1, rs1, rq1 = fb.conv1x1_stats_reference(d["x"], d["w1"])
    _, _, sc1, sh1 = fb._bn_fold(rs1, rq1, m, d["gam"][0], d["bet"][0])
    ra2, rs2, rq2 = fb.conv3x3_norm_stats_reference(ra1, d["taps"], sc1, sh1,
                                                    h)
    _, _, sc2, sh2 = fb._bn_fold(rs2, rq2, m, d["gam"][1], d["bet"][1])
    sum_h, m2h = fb.norm_relu_moments_reference(ra2, sc2, sh2)
    _, _, sc3, sh3 = fb._bn3_fold(d["w3"], sum_h, m2h, m, d["gam"][2],
                                  d["bet"][2])
    inputs["conv1x1_bn_residual"] = (ra2, d["x"], sc2, sh2, d["w3"], sc3,
                                     sh3)
    return inputs


def row_bounds(n: int, cin: int, c: int, h: int) -> dict:
    """{row: (bound ms, what bounds it)} as phase 3 counts them, and the
    tap pass's."""
    s, m = h * h, n * h * h
    ea, ex = n * c * s, n * cin * s
    return {
        "conv1x1_bn_residual": cs.bound_ms(
            2 * (ea + 2 * ex + cin * c) + 4 * (2 * c + 2 * cin),
            2 * cin * c * m, cs.BF16_FLOPS_PER_S),
        "bwd_final": cs.bound_ms(
            2 * (3 * ex + 2 * ea + c * cin) + 4 * (3 * c + c * cin),
            4 * c * cin * m, cs.BF16_FLOPS_PER_S),
        "bwd_reduce3": cs.bound_ms(
            2 * (3 * ex + ea) + 4 * (2 * c + cin * (c + 1)),
            2 * cin * c * m, cs.BF16_FLOPS_PER_S),
        "bwd_mid": cs.bound_ms(
            2 * (4 * ea + 9 * c * c) + 4 * (9 * c + 9 * c * c),
            36 * c * c * m, cs.BF16_FLOPS_PER_S),
        "taps": cs.bound_ms(2 * 2 * ea + 4 * 9 * c * c,
                            18 * c * c * m, cs.BF16_FLOPS_PER_S)}


def library_call(row: str, a):
    """Phase 3's yardstick of a row: one PyTorch call (or two) computing
    the same products on the same bf16 inputs."""
    if row == "conv1x1_bn_residual":
        ra2, _, sc2, sh2, w3 = a[:5]
        n, c, s = ra2.shape
        h2 = fb._norm_relu(ra2, sc2, sh2)
        side = int(round(s ** 0.5))
        return lambda: torch.nn.functional.conv2d(
            h2.view(n, c, side, side), w3.view(w3.shape[0], c, 1, 1))
    if row == "bwd_final":
        _, g1, a1, x, p1, q1, r1, w1 = a
        da1 = fb._unfold(g1, a1, p1, q1, r1).to(torch.bfloat16)
        return lambda: (torch.matmul(w1.T, da1),
                        torch.bmm(da1, x.transpose(1, 2)).sum(dim=0))
    return None


def readings(row: str, a, got, want) -> float:
    """The largest share of a row's phase 3 limits (1 is the limit)."""
    if row == "conv1x1_bn_residual":
        return cs.bf16_share(torch, got, want)
    return max(sh for sh, _ in cs.bf16_bwd_readings(
        torch, fb, row, a, got, want).values())


def final_parts(fn) -> dict:
    """{launch: device ms} of a call of bwd_final_bf16, from the profiler
    (empty where it saw no device time)."""
    _, by_name, _ = cs.profiled(torch, fn, 10)
    parts = {}
    for part, pat in FINAL_PARTS:
        parts[part] = sum(ms for name, ms in by_name.items()
                          if re.search(pat, name))
    return parts if by_name else {}


def ablate_mode(card: str, n: int) -> int:
    """The rows' wgmma kernels beside builds with parts of their work
    removed."""
    root = Path(tempfile.mkdtemp(prefix="abw_ablate_", dir=build.BUILD_DIR))
    build.build([SOURCE])
    jobs = {}
    for i, (row, what, edits) in enumerate(ABLATIONS):
        d = root / str(i)
        shutil.copytree(build.CSRC, d)
        for name, old, new in edits:
            text = (d / name).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{row} {what}: the source moved")
            (d / name).write_text(text.replace(old, new))
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
    pattern = {"bwd_mid": TAP_KERNEL, "bwd_reduce3": R3_KERNEL,
               "conv1x1_bn_residual": TILE_KERNEL, "bwd_final": TILE_KERNEL}
    try:
        for cin, c, h in cs.CHAIN_SHAPES:
            inputs = row_inputs(gen, n, cin, c, h)
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
    n = args.batch
    for cin, c, h in cs.CHAIN_SHAPES:
        m = n * h * h
        inputs = row_inputs(gen, n, cin, c, h)
        bounds = row_bounds(n, cin, c, h)
        for row in ROWS:
            a = inputs[row]
            want = getattr(fb, row + "_reference")(*a)
            calls, shares = {}, {}
            for name, mod in trees.items():
                fn = (lambda mod=mod, row=row, a=a:
                      getattr(mod, row + "_bf16")(*a))
                got = fn()
                torch.cuda.synchronize()
                shares[name] = readings(row, a, got, want)
                if shares[name] > 1:
                    raise RuntimeError(f"{row}_bf16 ({name}) beyond its "
                                       f"limits: {shares[name]:.4f}")
                calls[name] = fn
                del got
            times = {"this": [], "other": []}
            for name in ("other", "this", "this", "other"):
                times[name].append(cs.cuda_ms(torch, calls[name], 20))
            mean = {k: sum(v) / len(v) for k, v in times.items()}
            bound, by = bounds[row]
            lib = library_call(row, a)
            lib_ms = (f"; library {cs.cuda_ms(torch, lib, 20):.4f} ms"
                      if lib else "")
            print(f"{row}_bf16 Cin {cin}, C {c}, {h}x{h}, batch {n}: this "
                  f"{mean['this']:.4f} ms ({', '.join(f'{t:.4f}' for t in times['this'])}), "
                  f"other {mean['other']:.4f} ms ({', '.join(f'{t:.4f}' for t in times['other'])}), "
                  f"{mean['other'] / mean['this']:.2f}x; bound {bound:.4f} ms "
                  f"({by}), this at {bound / mean['this']:.3f} of it"
                  f"{lib_ms}; largest share of its limits this "
                  f"{shares['this']:.4f}, other {shares['other']:.4f} "
                  f"[{card}]")
            if row == "bwd_final":
                for name in ("other", "this"):
                    parts = final_parts(calls[name])
                    print(f"bwd_final_bf16 launches ({name}) C {c}, {h}x{h}: "
                          + (", ".join(f"{k} {v:.4f} ms"
                                       for k, v in parts.items())
                             if parts else "the profiler saw no device "
                                           "time") + f" [{card}]")
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
