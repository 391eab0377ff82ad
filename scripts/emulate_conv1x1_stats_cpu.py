"""Run the conv1x1_stats kernel of ``paddle_tpu_torch/csrc/
conv1x1_stats_tc.cuh`` on the CPU, before any GPU sees it.

The harness of ``scripts/emulate_moments_cpu.py``: copies of
``conv1x1_stats_tc.cuh`` and the headers it includes
(``bwd_apply3_tc.cuh``, ``conv3x3_tc.cuh``, ``fused_block.cuh``),
rewritten for g++ (threads for a block's threads, a per-thread queue of
copies that lands at ``wait_group``, a per-warp exchange for
``mma.sync`` m16n8k8 TF32 whose sums are taken in double and truncated
toward zero, shared memory filled with NaN so that a read before its
copy lands shows), with the C entry point pasted from
``csrc/fused_block.cu``. Builds that with ``g++ -std=c++20`` into
``paddle_tpu_torch/_build/`` and calls the wrapper itself
(``fused_block.conv1x1_stats``, with ``build.bind`` pointed at the
emulation) on CPU tensors at each N,Cin,C,S given (x uniform in [0, 1),
W1 He-scaled): the largest share of the y limit (atol = rtol = 1e-5)
and of the sums' (1e-5 of their terms' magnitudes) against the plain
version; whether a second call gives the same bits, and whether x 4
bytes off 16-byte alignment (4-byte copies) does. Exits 1 if any shape
misses.

    python scripts/emulate_conv1x1_stats_cpu.py 2,256,64,49 3,72,72,36
"""

import argparse
import contextlib
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import emulate_moments_cpu as emu  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_block as fb  # noqa: E402

HEADERS = ("fused_block.cuh", "conv3x3_tc.cuh", "bwd_apply3_tc.cuh",
           "conv1x1_stats_tc.cuh")
ENTRY = ("fused_block.cu", "fused_block_conv1x1_stats_f32")


def entry_point(source: str, name: str) -> str:
    """The C entry point `name` of a source, from its line to its closing
    brace at the start of a line."""
    text = (build.CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + name + r"\(.*?\n}\n", text, re.S)
    if m is None:
        raise RuntimeError(f"{source} has no entry point {name}")
    return m.group(0)


def compile_library(out: Path) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    for name in HEADERS:
        (out / name).write_text(emu.rewrite(name, False))
    (out / "cuda_emu.h").write_text(emu.EMU_H)
    (out / "emu_rt.cpp").write_text(emu.EMU_RT)
    (out / "unit.cpp").write_text(
        '#include "cuda_emu.h"\n'
        + "".join(f'#include "{h}"\n' for h in HEADERS)
        + entry_point(*ENTRY))
    lib = out / "conv1x1_stats_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-ffp-contract=off", "-include", "cuda_emu.h",
                    "-o", str(lib), "unit.cpp", "emu_rt.cpp"], cwd=out,
                   check=True)
    return ctypes.CDLL(str(lib))


@contextlib.contextmanager
def emulated(lib):
    """The wrapper takes CPU tensors as the card's and launches the
    emulation."""
    def bind(source, symbol, argtypes):
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    saved = (build.on_card, build.bind, build.device_guard, build.stream)
    build.on_card = lambda name, t: True
    build.bind = bind
    build.device_guard = lambda d: contextlib.nullcontext()
    build.stream = lambda d: 0
    try:
        yield
    finally:
        build.on_card, build.bind, build.device_guard, build.stream = saved


def sum_share(got, want, terms):
    return float(((got - want).abs() / (1e-5 * terms).clamp_min(1e-30))
                 .max())


def worst(*shares):
    """The largest share, NaN if any is."""
    return float(torch.tensor(shares).max())


def stats_case(lib, n, cin, c, s):
    gen = torch.Generator().manual_seed(n + cin + c + s)
    x = torch.rand(n, cin, s, generator=gen)
    w = torch.randn(c, cin, generator=gen) * (2 / cin) ** 0.5
    y, sy, qy = fb.conv1x1_stats_reference(x, w)
    with emulated(lib):
        got = fb.conv1x1_stats(x, w)
        again = fb.conv1x1_stats(x, w)
        off = torch.empty(x.numel() + 1)[1:].view_as(x)
        off.copy_(x)
        shifted = fb.conv1x1_stats(off, w)
    y_share = float(((got[0] - y).abs() / (1e-5 + 1e-5 * y.abs())).max())
    sums = worst(sum_share(got[1], sy, y.abs().sum(dim=(0, 2))),
                 sum_share(got[2], qy, qy))
    same = [all(torch.equal(a, b) for a, b in zip(got, o))
            for o in (again, shifted)]
    bn, t, rows, lda = fb._stream_grid(n, s, c, cin)
    padded = "itself" if (rows, lda) == (c, cin) else "padded"
    print(f"conv1x1_stats N {n}, Cin {cin}, C {c}, S {s}: "
          f"{rows * bn // 8192} row tile(s) x {t} column tiles, W1 "
          f"{padded}; "
          f"largest share of the limit y {y_share:.4f}, Σy and Σy² "
          f"{sums:.4f}; a second call the same bits {same[0]}; x 4 bytes "
          f"off alignment the same bits {same[1]}", flush=True)
    return y_share <= 1 and sums <= 1 and all(same)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="+", help="N,Cin,C,S")
    args = ap.parse_args()
    torch.set_num_threads(1)
    lib = compile_library(build.BUILD_DIR / "conv1x1_stats_emulation")
    ok = [stats_case(lib, *map(int, sh.split(","))) for sh in args.shapes]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
