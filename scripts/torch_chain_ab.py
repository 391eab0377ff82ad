"""The bottleneck chain's kernels of two trees of this repository side
by side on one GPU: their SASS, their outputs and their times.

Builds ``csrc/fused_block.cu`` and ``csrc/fused_block_bwd.cu`` of a
second checkout (``--parent DIR``, for example a ``git archive`` of the
parent commit unpacked there) with this tree's nvcc flags, and holds
them against this tree's libraries:

* the SASS of every kernel function both libraries have (``cuobjdump
  -sass``), function by function, the anonymous namespace's per-file
  name left out; and bwd_final's dx kernel, which this tree runs as an
  instance of ``csrc/conv1x1_tc.cuh``'s kernel, against a parent's
  ``bwd_final_dx_kernel`` of the same WIDE, the names stripped;
* the outputs of the eight kernels, through this tree's wrappers with
  the library swapped, at ResNet-50's three chain stages (batch 128),
  each on the inputs the chain makes, as ``chip_smoke.py`` phase 3
  makes them; bit for bit, but for the kernels redesigned on tensor
  cores against a parent's float32 ones: ``conv1x1_stats`` and
  ``conv1x1_bn_residual``, held to the parent's within atol = rtol =
  1e-5 (conv1x1_stats' Σy and Σy² within 1e-5 of their terms' sums), and
  ``norm_relu_moments``, whose Σh and M2 are held to the parent's within
  rtol 1e-5 of their terms (h >= 0: the sums themselves); a parent whose
  entry point takes other arguments (the float32 SIMT kernels': W3
  itself, a column chunk, no row pitch) is called through that entry
  point with that kernel's grid;
* their times, by CUDA events over 10 calls, in turns: parent, this
  tree, this tree, parent.

Run from this tree's root on a machine with the CUDA toolkit:
``python scripts/torch_chain_ab.py --parent DIR``.
"""

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_block as fb  # noqa: E402

SOURCES = ("fused_block.cu", "fused_block_bwd.cu")
FORWARD = chip_smoke.CHAIN_KERNELS
KERNELS = FORWARD + chip_smoke.CHAIN_BWD_KERNELS
# the anonymous namespace's name: a hash, the file name's length and the
# file name, another hash (8 hex digits each, so that the next name's
# length, in decimal, is left alone)
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")
# branch labels, numbered across the library's functions
LABEL = re.compile(r"\.L_x_\d+")


def parent_libraries(parent: Path, out: Path) -> dict:
    """{source: path of the parent's library}, built in parallel."""
    out.mkdir(parents=True, exist_ok=True)
    jobs = {src: (out / f"{Path(src).stem}.so", subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
         str(out / f"{Path(src).stem}.so"),
         str(parent / "paddle_tpu_torch" / "csrc" / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in SOURCES}
    libs = {}
    for src, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {src}:\n{log}")
        libs[src] = lib
    return libs


def sass(lib: Path) -> dict:
    """{function name: its SASS}, the anonymous namespace's name
    replaced in both, runs of blanks made one, and each function's branch
    labels numbered anew in the order they appear."""
    tool = shutil.which("cuobjdump") or str(
        Path(build.nvcc_path()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in ANON.sub("ANON", text).splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:   # the columns' padding follows the file
            funcs[name].append(" ".join(line.split()))
    for lines in funcs.values():
        labels = {}
        for i, line in enumerate(lines):
            lines[i] = LABEL.sub(lambda m: labels.setdefault(
                m.group(0), f".L_{len(labels)}"), line)
    return {k: "\n".join(v) for k, v in funcs.items()}


def dx_pairs(a: dict, b: dict) -> list:
    """[(WIDE, the parent's name, this tree's name)] of bwd_final's dx
    kernel: the parent's bwd_final_dx_kernel<WIDE> and this tree's
    conv1x1_tc_kernel<bwd_final::Dx, WIDE>, where each has exactly one."""
    out = []
    for flag in "10":
        pa = [k for k in a if f"bwd_final_dx_kernelILb{flag}E" in k]
        pb = [k for k in b if "conv1x1_tc_kernel" in k
              and "bwd_final2Dx" in k and f"Lb{flag}E" in k]
        if len(pa) == 1 and len(pb) == 1:
            out.append((flag == "1", pa[0], pb[0]))
    return out


def parent_takes_w3(parent: Path) -> bool:
    """Whether the parent's conv1x1_bn_residual entry point takes W3
    [Cout, C] itself (a2, x, w3, sc2, sh2, sc3, sh3, out, N, C, Cout, S,
    stream), as the SIMT kernel's did, rather than W3ᵀ and its grid."""
    text = (parent / "paddle_tpu_torch" / "csrc" / "fused_block.cu"
            ).read_text()
    entry = text[text.index("fused_block_conv1x1_bn_residual_f32("):]
    return "ldw" not in entry[:entry.index(")")]


def w3_entry(a2, x, sc2, sh2, w3, sc3, sh3):
    """conv1x1_bn_residual through an entry point that takes W3 itself."""
    n, c, s = a2.shape
    cout = w3.shape[0]
    out = torch.empty(n, cout, s, device=a2.device)
    fn = build.bind("fused_block.cu", "fused_block_conv1x1_bn_residual_f32",
                    (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 4
                    + (ctypes.c_void_p,))
    build.launch("conv1x1_bn_residual", fn, a2.data_ptr(), x.data_ptr(),
                 w3.data_ptr(), sc2.data_ptr(), sh2.data_ptr(),
                 sc3.data_ptr(), sh3.data_ptr(), out.data_ptr(), n, c, cout,
                 s, torch.cuda.current_stream().cuda_stream)
    return out


def parent_takes_chunk(parent: Path) -> bool:
    """Whether the parent's norm_relu_moments entry point takes (splits,
    chunk), as the float32 SIMT kernel's did, rather than (splits,
    wide)."""
    text = (parent / "paddle_tpu_torch" / "csrc" / "fused_block.cu"
            ).read_text()
    entry = text[text.index("fused_block_norm_relu_moments_f32("):]
    return "chunk" in entry[:entry.index(")")]


def simt_grid(ns: int, c: int, sms: int):
    """(splits, chunk) of the float32 SIMT moments kernel: 64- or
    128-square tiles of [C, C], enough splits of K = N·S for ~4 blocks an
    SM, each a multiple of 8 columns."""
    b = 64 if c <= 64 else 128
    want = max(1, -(-4 * sms // (-(-c // b)) ** 2))
    chunk = 8 * -(-ns // (want * 8))
    return -(-ns // chunk), chunk


def chunk_entry(a2, scale, shift):
    """norm_relu_moments through an entry point that takes (splits,
    chunk), on the SIMT kernel's grid."""
    n, c, s = a2.shape
    splits, chunk = simt_grid(n * s, c, build.sm_count(a2.device))
    part = torch.empty(splits, c, c + 1, device=a2.device)
    out = torch.empty(c, c + 1, device=a2.device)
    fn = build.bind("fused_block.cu", "fused_block_norm_relu_moments_f32",
                    (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5
                    + (ctypes.c_void_p,))
    build.launch("norm_relu_moments", fn, a2.data_ptr(), scale.data_ptr(),
                 shift.data_ptr(), part.data_ptr(), out.data_ptr(), n, c, s,
                 splits, chunk, torch.cuda.current_stream().cuda_stream)
    return out[:, c], out[:, :c]


def parent_takes_no_pitch(parent: Path) -> bool:
    """Whether the parent's conv1x1_stats entry point takes W1 itself and
    no row pitch (x, w, y, part, stats, N, Cin, C, S, T, stream), as the
    float32 SIMT kernel's did, T the 128-column tiles of N·S."""
    text = (parent / "paddle_tpu_torch" / "csrc" / "fused_block.cu"
            ).read_text()
    entry = text[text.index("fused_block_conv1x1_stats_f32("):]
    return "lda" not in entry[:entry.index(")")]


def simt_stats_entry(x, w):
    """conv1x1_stats through an entry point that takes W1 itself, on the
    float32 SIMT kernel's grid."""
    n, cin, s = x.shape
    c = w.shape[0]
    t = -(-n * s // 128)
    y = torch.empty(n, c, s, device=x.device)
    part = torch.empty(2, c, t, device=x.device)
    stats = torch.empty(2, c, device=x.device)
    fn = build.bind("fused_block.cu", "fused_block_conv1x1_stats_f32",
                    (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5
                    + (ctypes.c_void_p,))
    build.launch("conv1x1_stats", fn, x.data_ptr(), w.data_ptr(),
                 y.data_ptr(), part.data_ptr(), stats.data_ptr(), n, cin, c,
                 s, t, torch.cuda.current_stream().cuda_stream)
    return y, stats[0], stats[1]


def chain_inputs(d, dout, h):
    """{kernel: args} of the chain's eight wrappers in one forward and
    backward of the stage d, each wrapper replaced by its plain version."""
    g, b = d["gam"], d["bet"]
    args, names = {}, FORWARD + chip_smoke.CHAIN_BWD_KERNELS
    wrappers = {k: getattr(fb, k) for k in names}

    def plain(name):
        def call(*a):
            args[name] = a
            return getattr(fb, name + "_reference")(*a)
        return call

    try:
        for k in names:
            setattr(fb, k, plain(k))
        out, stats, aux = fb.bottleneck_rest_fwd(
            d["x"], d["w1"], d["taps"], d["w3"], g[0], b[0], g[1], b[1],
            g[2], b[2], h)
        a1, a2, sum_h, m2h, sc1, sh1, sc2, sh2 = aux
        res = (d["x"], a1, a2, out, d["w1"], d["taps"], d["w3"], g[0], g[1],
               g[2], *stats, sum_h, m2h, sc1, sh1, sc2, sh2)
        fb.bottleneck_rest_bwd(res, dout, [torch.zeros_like(s)
                                           for s in stats], h)
    finally:
        for k, w in wrappers.items():
            setattr(fb, k, w)
    return args


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    build.build(SOURCES)
    mine = {src: build._target(src) for src in SOURCES}
    theirs = parent_libraries(args.parent.resolve(),
                              build.BUILD_DIR / "parent")
    for src in SOURCES:
        a, b = sass(theirs[src]), sass(mine[src])
        common = sorted(set(a) & set(b))
        same = [k for k in common if a[k] == b[k]]
        print(f"{src}: {len(common)} kernel functions in both, SASS "
              f"identical in {len(same)}; only the parent's: "
              f"{len(set(a) - set(b))}, only this tree's: "
              f"{len(set(b) - set(a))}")
        for k in sorted(set(common) - set(same)):
            print(f"  SASS differs: {k}")
        for wide, pa, pb in dx_pairs(a, b):
            lines = (a[pa].splitlines(), b[pb].splitlines())
            diff = sum(x != y for x, y in zip(*lines)) + abs(
                len(lines[0]) - len(lines[1]))
            print(f"  bwd_final's dx, WIDE {int(wide)}, the names stripped: "
                  f"SASS {'identical' if a[pa] == b[pb] else 'DIFFERS'} "
                  f"({len(lines[0])} / {len(lines[1])} lines, {diff} "
                  f"differ)")
    libs = {"parent": {s: ctypes.CDLL(str(p)) for s, p in theirs.items()},
            "this tree": {s: build.library(s) for s in SOURCES}}

    def use(which):
        build._loaded.update(libs[which])
        build.bind.cache_clear()

    old_entry = parent_takes_w3(args.parent.resolve())
    old_moments = parent_takes_chunk(args.parent.resolve())
    old_stats = parent_takes_no_pitch(args.parent.resolve())
    gen = torch.Generator(device="cuda").manual_seed(8)
    n = chip_smoke.RESNET["batch"]
    for cin, c, h in chip_smoke.CHAIN_SHAPES:
        d = chip_smoke.chain_case(torch, n, cin, c, h, gen)
        dout = torch.randn(n, cin, h * h, device="cuda", generator=gen)
        inputs = chain_inputs(d, dout, h)
        del d, dout
        notes = []
        for k in KERNELS:
            def call(which, k=k):
                if (k == "conv1x1_bn_residual" and which == "parent"
                        and old_entry):
                    return (w3_entry(*inputs[k]),)
                if (k == "norm_relu_moments" and which == "parent"
                        and old_moments):
                    return chunk_entry(*inputs[k])
                if k == "conv1x1_stats" and which == "parent" and old_stats:
                    return simt_stats_entry(*inputs[k])
                out = getattr(fb, k)(*inputs[k])
                return out if isinstance(out, tuple) else (out,)
            outs = {}
            for which in libs:
                use(which)
                outs[which] = call(which)
            torch.cuda.synchronize()
            if k == "conv1x1_bn_residual" or (k == "conv1x1_stats"
                                              and old_stats):
                (mine, *sums), (theirs, *want) = (outs["this tree"],
                                                  outs["parent"])
                share = chip_smoke.limit_share(torch, mine, theirs)
                if sums:   # Σy within 1e-5 of Σ|y|, Σy² of itself
                    terms = (theirs.abs().sum(dim=(0, 2)), want[1])
                    share = max([share] + [
                        float(((x - y).abs() / (1e-5 * z)).max())
                        for x, y, z in zip(sums, want, terms)])
                verdict = (f"within 1e-5 of the parent (share {share:.4f})"
                           if share <= 1 else f"DIFFERS (share {share:.4f})")
            elif k == "norm_relu_moments":
                share = max(float(((x - y).abs() / (1e-5 * y.abs())
                                   .clamp_min(1e-30)).max())
                            for x, y in zip(outs["this tree"],
                                            outs["parent"]))
                verdict = (f"Σh, M2 within rtol 1e-5 of the parent's (share "
                           f"{share:.4f})" if share <= 1
                           else f"DIFFERS (share {share:.4f})")
            else:
                verdict = ("bit-identical" if all(
                    torch.equal(x, y) for x, y in
                    zip(outs["parent"], outs["this tree"])) else "DIFFERS")
            del outs
            times = []
            for which in ("parent", "this tree", "this tree", "parent"):
                use(which)
                times.append(chip_smoke.cuda_ms(
                    torch, lambda w=which: call(w), 10))
            ratio = (times[1] + times[2]) / (times[0] + times[3])
            notes.append(f"{k} {verdict}, "
                         f"ms parent {times[0]:.4f} / {times[3]:.4f}, this "
                         f"tree {times[1]:.4f} / {times[2]:.4f} "
                         f"({ratio:.4f}x)")
        use("this tree")
        print(f"chain stage Cin {cin}, C {c}, {h}x{h}, batch {n}: "
              + "; ".join(notes) + f" [{card}]", flush=True)
        del inputs
    return 0


if __name__ == "__main__":
    sys.exit(main())
