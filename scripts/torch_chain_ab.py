"""The bottleneck chain's kernels of two trees of this repository side
by side on one GPU: their SASS, their outputs and their times.

Builds ``csrc/fused_block.cu`` and ``csrc/fused_block_bwd.cu`` of a
second checkout (``--parent DIR``, for example a ``git archive`` of the
parent commit unpacked there) with this tree's nvcc flags, and holds
them against this tree's libraries:

* the SASS of every kernel function both libraries have (``cuobjdump
  -sass``), function by function, the anonymous namespace's per-file
  name left out;
* the outputs of the kernels whose entry points both libraries have,
  through this tree's wrappers with the library swapped, bit for bit:
  the four forward kernels and ``bwd_reduce3``, ``bwd_mid`` and
  ``bwd_final``, at ResNet-50's three chain stages (batch 128), each on
  the inputs the chain makes, as ``chip_smoke.py`` phase 3 makes them;
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
KERNELS = FORWARD + ("bwd_reduce3", "bwd_mid", "bwd_final")
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
    libs = {"parent": {s: ctypes.CDLL(str(p)) for s, p in theirs.items()},
            "this tree": {s: build.library(s) for s in SOURCES}}

    def use(which):
        build._loaded.update(libs[which])
        build.bind.cache_clear()

    gen = torch.Generator(device="cuda").manual_seed(8)
    n = chip_smoke.RESNET["batch"]
    for cin, c, h in chip_smoke.CHAIN_SHAPES:
        d = chip_smoke.chain_case(torch, n, cin, c, h, gen)
        dout = torch.randn(n, cin, h * h, device="cuda", generator=gen)
        inputs = chain_inputs(d, dout, h)
        del d, dout
        notes = []
        for k in KERNELS:
            call = lambda k=k: getattr(fb, k)(*inputs[k])   # noqa: E731
            outs = {}
            for which in libs:
                use(which)
                outs[which] = call()
            torch.cuda.synchronize()
            equal = all(torch.equal(x, y) for x, y in
                        zip(outs["parent"], outs["this tree"]))
            del outs
            times = []
            for which in ("parent", "this tree", "this tree", "parent"):
                use(which)
                times.append(chip_smoke.cuda_ms(torch, call, 10))
            ratio = (times[1] + times[2]) / (times[0] + times[3])
            notes.append(f"{k} {'bit-identical' if equal else 'DIFFERS'}, "
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
