"""Run the norm_relu_moments kernel of ``paddle_tpu_torch/csrc/
moments_tc.cuh`` on the CPU, before any GPU sees it.

Copies ``moments_tc.cuh`` and the headers it includes
(``fused_block.cuh``, ``conv3x3_tc.cuh``), rewritten for g++: CUDA's
qualifiers defined away, ``threadIdx`` / ``blockIdx`` thread-local,
``__shared__`` static, the dynamic shared memory a per-block buffer
filled with NaN (a read before its copy lands shows), ``__syncthreads``
a ``std::barrier``, each ``<<<grid, block, smem, stream>>>`` launch a
call that runs the blocks one after another, each as ``block``
``std::thread``s; ``cp.async`` a per-thread queue of copies that land at
``wait_group`` (zero-filled where the source size is 0); ``mma.sync``
m16n8k8 TF32 an exchange of the warp's fragments through a per-warp
barrier (PTX's fragment layouts), each product of TF32 operands (the
low 13 bits dropped) summed in double and truncated toward zero to
float32, as the tensor cores truncate. Builds that with ``g++
-std=c++20`` into a shared library in ``paddle_tpu_torch/_build/``,
calls the entry point through ``ctypes`` on CPU tensors at the shapes
given (N,C,S), with ``_moments_grid``'s splits for ``--sms`` SMs, and
prints the largest share of the rtol 1e-5 limit of Σh and of M2 against
the plain version, whether M2 is exactly symmetric, and whether the
16-byte and 4-byte copy paths (where S % 4 == 0) give the same bits.
``--normalize-padding`` builds the kernel with its landing normalizing
positions past N·S too (what a zero-fill normalized to relu(shift)
would give), to show that the check sees it. Inputs: a2 = randn + 0.3,
every shift > 0.

    python scripts/emulate_moments_cpu.py 2,64,64 3,72,49 5,200,45
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

from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_block as fb  # noqa: E402

EMU_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
extern thread_local uint3 threadIdx, blockIdx;
struct __attribute__((aligned(16))) float4 { float x, y, z, w; };
struct __attribute__((aligned(8))) float2 { float x, y; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
using std::max;
using std::min;
void __syncthreads();
extern float* emu_dyn_smem;
struct EmuCopy { float* dst; const float* src; int bytes, n; };
extern thread_local std::vector<std::vector<EmuCopy>> emu_groups;
extern thread_local std::vector<EmuCopy> emu_open;
inline void emu_land(size_t keep) {
  while (emu_groups.size() > keep) {
    for (auto& c : emu_groups.front()) {
      std::memset(c.dst, 0, c.bytes);
      if (c.n) std::memcpy(c.dst, c.src, c.n);
    }
    emu_groups.erase(emu_groups.begin());
  }
}
struct EmuWarp {
  uint32_t a[32][4], b[32][2];
  float c[32][4];
  std::barrier<>* bar;
};
extern EmuWarp* emu_warps;
inline float emu_tf32(uint32_t u) { return __uint_as_float(u & 0xffffe000u); }
inline void emu_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                    uint32_t b1, const float (&c)[4]) {
  const int lane = threadIdx.x & 31;
  EmuWarp& W = emu_warps[threadIdx.x >> 5];
  for (int i = 0; i < 4; ++i) {
    W.a[lane][i] = a[i];
    W.c[lane][i] = c[i];
  }
  W.b[lane][0] = b0;
  W.b[lane][1] = b1;
  W.bar->arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i >> 1), n = 2 * t + (i & 1);
    double s = c[i];
    for (int k = 0; k < 8; ++k)
      s += (double)emu_tf32(W.a[4 * (r & 7) + (k & 3)][(r >> 3) + 2 * (k >> 2)])
           * (double)emu_tf32(W.b[4 * n + (k & 3)][k >> 2]);
    float f = (float)s;
    if (std::fabs((double)f) > std::fabs(s)) f = std::nextafter(f, 0.f);
    out[i] = f;
  }
  W.bar->arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}
void emu_launch(dim3 grid, dim3 block, int smem_bytes,
                std::function<void()> fn);
"""

EMU_RT = r"""
#include <deque>
#include <limits>
#include <thread>
#include "cuda_emu.h"
thread_local uint3 threadIdx, blockIdx;
float* emu_dyn_smem;
thread_local std::vector<std::vector<EmuCopy>> emu_groups;
thread_local std::vector<EmuCopy> emu_open;
EmuWarp* emu_warps;
static std::barrier<>* emu_block_bar;
void __syncthreads() { emu_block_bar->arrive_and_wait(); }
void emu_launch(dim3 grid, dim3 block, int smem_bytes,
                std::function<void()> fn) {
  const int nt = block.x, nw = (nt + 31) / 32;
  std::vector<float> smem(smem_bytes / 4 + 4);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::fill(smem.begin(), smem.end(),
                std::numeric_limits<float>::quiet_NaN());
      emu_dyn_smem = smem.data();
      std::barrier<> bar(nt);
      emu_block_bar = &bar;
      std::vector<EmuWarp> warps(nw);
      std::deque<std::barrier<>> bars;
      for (int w = 0; w < nw; ++w) {
        bars.emplace_back(32);
        warps[w].bar = &bars.back();
      }
      emu_warps = warps.data();
      std::vector<std::thread> threads;
      for (int t = 0; t < nt; ++t)
        threads.emplace_back([&, t] {
          threadIdx = {(unsigned)t, 0, 0};
          blockIdx = {bx, by, 0};
          fn();
          emu_groups.clear();
          emu_open.clear();
        });
      for (auto& th : threads) th.join();
    }
}
"""

# conv3x3_tc.cuh's block of copy and mma helpers, emulated
HELPERS = r"""// ---- asynchronous copies and the tensor-core product (emulated)
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  emu_open.push_back({dst, src, 16, ok ? 16 : 0});
}
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  emu_open.push_back({dst, src, 4, 4});
}
__device__ __forceinline__ void commit() {
  emu_groups.push_back(std::move(emu_open));
  emu_open.clear();
}
__device__ __forceinline__ void wait_prior_1() { emu_land(1); }
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

UNIT = r"""
#include "cuda_emu.h"
#include "fused_block.cuh"
#include "moments_tc.cuh"
extern "C" int moments(const float* a2, const float* scale,
                       const float* shift, float* part, float* out, int N,
                       int C, int S, int splits, int wide) {
  if (!moments::grid_ok(a2, N, C, S, splits, wide)) return 1;
  return wide ? moments::launch<true>(a2, scale, shift, part, out, N, C, S,
                                      splits, nullptr)
              : moments::launch<false>(a2, scale, shift, part, out, N, C,
                                       S, splits, nullptr);
}
"""

LAUNCH = re.compile(r"(\w+(?:<[^;<>]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);", re.S)
LANDING_CHECK = "  if (j * kK + L::kCols * L::lane() >= NS) return;\n"


def _top_split(text: str) -> list:
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "([<"
        depth -= ch in ")]>"
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts + [cur.strip()]


def _launch(m) -> str:
    cfg = _top_split(m.group(2))
    smem = cfg[2] if len(cfg) > 2 else "0"
    return (f"emu_launch(dim3({cfg[0]}), dim3({cfg[1]}), (int)({smem}), "
            f"[&] {{ {m.group(1)}({m.group(3)}); }});")


def rewrite(name: str, normalize_padding: bool) -> str:
    text = (build.CSRC / name).read_text()
    text = text.replace("#include <cuda_runtime.h>\n", '#include "cuda_emu.h"\n')
    if name == "conv3x3_tc.cuh":
        a = text.index("// ---- asynchronous copies and the tensor-core product")
        b = text.index("// ------------------------------------------------"
                       "-----------------------------", a)
        text = text[:a] + HELPERS + text[b:]
    if name == "moments_tc.cuh" and normalize_padding:
        assert LANDING_CHECK in text
        text = text.replace(LANDING_CHECK, "")
    text = text.replace('asm volatile("cp.async.wait_group %0;\\n" ::"n"(N));',
                        "emu_land(N);")
    text = re.sub(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                  r"float* \1 = emu_dyn_smem;", text)
    text = LAUNCH.sub(_launch, text)
    if "asm" in re.sub(r"//.*", "", text):
        raise RuntimeError(f"{name}: inline assembly left after the rewrite")
    return text


def compile_library(out: Path, normalize_padding: bool) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    for name in ("fused_block.cuh", "conv3x3_tc.cuh", "moments_tc.cuh"):
        (out / name).write_text(rewrite(name, normalize_padding))
    (out / "cuda_emu.h").write_text(EMU_H)
    (out / "emu_rt.cpp").write_text(EMU_RT)
    (out / "unit.cpp").write_text(UNIT)
    lib = out / "moments_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-ffp-contract=off", "-include", "cuda_emu.h",
                    "-o", str(lib), "unit.cpp", "emu_rt.cpp"], cwd=out,
                   check=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="+", help="N,C,S")
    ap.add_argument("--sms", type=int, default=2)
    ap.add_argument("--normalize-padding", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(1)
    lib = compile_library(build.BUILD_DIR / "moments_emulation",
                          args.normalize_padding)
    fn = lib.moments
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    for shape in args.shapes:
        n, c, s = map(int, shape.split(","))
        gen = torch.Generator().manual_seed(100 * n + c + s)
        a2 = torch.randn(n, c, s, generator=gen) + 0.3
        scale = torch.rand(c, generator=gen) + 0.5
        shift = 0.3 * torch.rand(c, generator=gen) + 0.1
        tiles, splits, pieces = fb._moments_grid(n, s, c, args.sms)
        want = fb.norm_relu_moments_reference(a2, scale, shift)
        got = {}
        for wide in ([False, True] if s % 4 == 0 else [False]):
            part = torch.full((splits, c, c + 1), float("nan"))
            out = torch.full((c, c + 1), float("nan"))
            err = fn(a2.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                     part.data_ptr(), out.data_ptr(), n, c, s, splits,
                     int(wide))
            if err:
                raise RuntimeError(f"{shape}: refused ({err})")
            got[wide] = (out[:, c].clone(), out[:, :c].clone())
        sum_h, m2 = got[False]
        shares = [float(((g - w).abs() / (1e-5 * w).clamp_min(1e-30)).max())
                  for g, w in zip((sum_h, m2), want)]
        same = (all(torch.equal(x, y) for x, y in zip(got[False], got[True]))
                if True in got else None)
        print(f"N {n}, C {c}, S {s}: {tiles} tile(s), {splits} split(s) of "
              f"{pieces} pieces; largest share of the limit Σh "
              f"{shares[0]:.4f}, M2 {shares[1]:.4f}; M2 symmetric "
              f"{torch.equal(m2, m2.T)}; 16-byte and 4-byte copies the "
              f"same bits {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
