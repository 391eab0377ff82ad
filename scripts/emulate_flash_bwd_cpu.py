"""Run the flash-attention backward kernels of ``paddle_tpu_torch/csrc/
flash_attention_bwd.cu`` (dQ and dK/dV) on the CPU, before any GPU sees
them.

The harness of ``scripts/emulate_moments_cpu.py``: copies of the source
and the headers it includes (``common.cuh``, ``tf32_mma.cuh``),
rewritten for g++ (threads for a block's threads, a per-thread queue of
copies that lands at ``wait_group``, a per-warp exchange for
``mma.sync`` m16n8k8 TF32 whose sums are taken in double and truncated
toward zero, shared memory filled with NaN so that a read before its
copy lands shows). ``tf32_mma.cuh``'s block of copy and mma helpers is
replaced. Two libraries are built with ``g++ -std=c++20`` into
``paddle_tpu_torch/_build/``: one whose copies land at ``wait_group``,
one whose copies land as they are issued (a copy issued before its
buffer's last reader is done then shows). The entry points are called
through ``ctypes`` on CPU tensors at each B,Sq,Sk,H,D,causal given, from
the plain forward's O and lse: the largest share of the 1e-4 limit
(atol = rtol) of dQ, dK and dV against the plain versions, whether a
second call gives the same bits, and whether both landings do. Exits 1
if any shape misses.

    python scripts/emulate_flash_bwd_cpu.py 1,128,128,2,256,1 2,77,77,1,64,1
"""

import argparse
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
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402

SOURCE = "flash_attention_bwd.cu"
HEADERS = ("common.cuh", "tf32_mma.cuh")
LIMIT = 1e-4

# tf32_mma.cuh's block of copy and mma helpers, emulated; EMU_EAGER lands
# each copy as it is issued
HELPERS = r"""// ---- asynchronous copies and the tensor-core product (emulated)
__device__ __forceinline__ void emu_copy(float* dst, const float* src,
                                         int bytes, int n) {
#ifdef EMU_EAGER
  std::memset(dst, 0, bytes);
  if (n) std::memcpy(dst, src, n);
#else
  emu_open.push_back({dst, src, bytes, n});
#endif
}
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  emu_copy(dst, src, 16, ok ? 16 : 0);
}
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  emu_copy(dst, src, 4, ok ? 4 : 0);
}
__device__ __forceinline__ void commit() {
  emu_groups.push_back(std::move(emu_open));
  emu_open.clear();
}
template <int N>
__device__ __forceinline__ void wait_prior() {
  emu_land(N);
}
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  const float z[4] = {0.f, 0.f, 0.f, 0.f};
  emu_mma(d, a, b0, b1, z);
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  const float c[4] = {d[0], d[1], d[2], d[3]};
  emu_mma(d, a, b0, b1, c);
}
"""


# what the attention sources use beyond the chain's emulation: gridDim,
# set by each launch, and a declaration of the (uncalled) warp shuffle
EXTRA_H = r"""
#pragma once
#include "cuda_emu.h"
float __shfl_xor_sync(unsigned, float, int);
inline thread_local dim3 gridDim;
"""


def _launch(m) -> str:
    """emu's launch, with gridDim set in each of the block's threads."""
    cfg = emu._top_split(m.group(2))
    smem = cfg[2] if len(cfg) > 2 else "0"
    return (f"emu_launch(dim3({cfg[0]}), dim3({cfg[1]}), (int)({smem}), "
            f"[&] {{ gridDim = dim3({cfg[0]}); {m.group(1)}({m.group(3)}); "
            f"}});")


def rewrite(name: str) -> str:
    text = (build.CSRC / name).read_text()
    text = text.replace("#include <cuda_runtime.h>\n",
                        '#include "flash_emu.h"\n')
    if name == "tf32_mma.cuh":
        a = text.index("// ---- asynchronous copies and the tensor-core "
                       "product")
        b = text.index("// ------------------------------------------------"
                       "-----------------------------", a)
        text = text[:a] + HELPERS + text[b:]
    text = text.replace(
        "extern __shared__ float4 smem4[];",
        "float4* smem4 = reinterpret_cast<float4*>(emu_dyn_smem);")
    text = emu.LAUNCH.sub(_launch, text)
    if "asm" in re.sub(r"//.*", "", text):
        raise RuntimeError(f"{name}: inline assembly left after the rewrite")
    return text


def compile_library(out: Path, eager: bool) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    for name in HEADERS + (SOURCE,):
        (out / name).write_text(rewrite(name))
    (out / "cuda_emu.h").write_text(emu.EMU_H)
    (out / "flash_emu.h").write_text(EXTRA_H)
    (out / "emu_rt.cpp").write_text(emu.EMU_RT)
    (out / "unit.cpp").write_text(f'#include "flash_emu.h"\n'
                                  f'#include "{SOURCE}"\n')
    lib = out / "flash_bwd_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-ffp-contract=off", "-include", "flash_emu.h",
                    *(["-DEMU_EAGER"] if eager else []), "-o", str(lib),
                    "unit.cpp", "emu_rt.cpp"], cwd=out, check=True)
    lib = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_dq_f32.argtypes = [P] * 7 + [I] * 5 + [F, I, P]
    lib.flash_attention_bwd_dkv_f32.argtypes = [P] * 8 + [I] * 5 + [F, I, P]
    return lib


def run(lib, q, k, v, do, lse, delta, causal):
    """(dQ, dK, dV) of one call of each entry point."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dq = torch.full_like(q, float("nan"))
    dk, dv = (torch.full_like(k, float("nan")) for _ in range(2))
    ins = [x.data_ptr() for x in (q, k, v, do, lse, delta)]
    tail = (b, h, sq, sk, d, d ** -0.5, int(causal), None)
    if lib.flash_attention_bwd_dq_f32(*ins, dq.data_ptr(), *tail):
        raise RuntimeError("dQ refused")
    if lib.flash_attention_bwd_dkv_f32(*ins, dk.data_ptr(), dv.data_ptr(),
                                       *tail):
        raise RuntimeError("dK/dV refused")
    return dq, dk, dv


def case(libs, b, sq, sk, h, d, causal):
    gen = torch.Generator().manual_seed(b + sq + 3 * sk + h + d)
    q, do = (torch.randn(b, sq, h, d, generator=gen) for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, generator=gen) for _ in range(2))
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
    delta = fa.flash_attention_bwd_delta(o, do)
    args = (q, k, v, do, lse, delta)
    want = (fa.flash_attention_bwd_dq_reference(*args, causal=causal),
            *fa.flash_attention_bwd_dkv_reference(*args, causal=causal))
    got = run(libs["wait"], *args, causal)
    again = run(libs["wait"], *args, causal)
    eager = run(libs["eager"], *args, causal)
    shares = [float(((x - w).abs() / (LIMIT + LIMIT * w.abs())).max())
              for x, w in zip(got, want)]
    same = [all(torch.equal(x, y) for x, y in zip(got, o))
            for o in (again, eager)]
    print(f"B {b}, Sq {sq}, Sk {sk}, H {h}, D {d}, causal {causal}: largest "
          f"share of the 1e-4 limit dQ {shares[0]:.4f}, dK {shares[1]:.4f}, "
          f"dV {shares[2]:.4f}; a second call the same bits {same[0]}; "
          f"copies landing at once the same bits {same[1]}", flush=True)
    return max(shares) <= 1 and all(same)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="+", help="B,Sq,Sk,H,D,causal")
    args = ap.parse_args()
    torch.set_num_threads(1)
    libs = {name: compile_library(build.BUILD_DIR / f"flash_bwd_emu_{name}",
                                  name == "eager")
            for name in ("wait", "eager")}
    ok = []
    for shape in args.shapes:
        b, sq, sk, h, d, causal = map(int, shape.split(","))
        ok.append(case(libs, b, sq, sk, h, d, bool(causal)))
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
