"""Run the conv-epilogue kernels of ``paddle_tpu_torch/csrc/fused_conv.cu``
on the CPU, before any GPU sees them.

Copies ``fused_conv.cu`` and ``common.cuh``, rewritten for g++: CUDA's
qualifiers defined away, ``threadIdx`` / ``blockIdx`` thread-local,
``gridDim`` set by each launch, ``__shared__`` static, ``__syncthreads``
a ``std::barrier``, ``__shfl_xor_sync`` an exchange through a per-warp
buffer and barrier, ``atomicAdd`` on the stats kernel's tickets a
``std::atomic_ref``, ``__threadfence`` a sequentially consistent fence;
each ``<<<grid, block, smem, stream>>>`` launch a call that runs the
blocks one after another in a shuffled order (so that the block that
draws a ticket's last number is not always the last of the grid), each
as ``block`` ``std::thread``s. Builds that with ``g++ -std=c++20`` into
``paddle_tpu_torch/_build/`` and calls the wrappers themselves
(``fused_conv.channel_stats``, ``apply_epilogue``,
``apply_epilogue_add``, with ``build.bind`` pointed at the emulation,
``build.sm_count`` at ``--sms`` and every output allocated full of NaN)
on CPU tensors at each N,C,S given (a = randn + 0.5): the plan (lanes,
column ranges, row slices, tickets), the largest share of the stats'
limit (1e-5 of the sum of their terms' magnitudes) against the plain
version, whether a second call gives the same bits (the tickets set back
to 0), and the largest share of apply's limit (atol = rtol = 1e-5), with
and without the addend and the ReLU. Exits 1 if any shape misses.

    python scripts/emulate_fused_conv_cpu.py 4,64,49 3,5,7 1,1,1 2,7,13
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

from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_conv as fc  # noqa: E402

EMU_H = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
extern thread_local uint3 threadIdx, blockIdx;
extern dim3 gridDim;
struct __attribute__((aligned(16))) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct __attribute__((aligned(16))) uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return 0; }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
using std::fmaf;
using std::fmaxf;
using std::max;
using std::min;
void __syncthreads();
float __shfl_xor_sync(unsigned mask, float x, int offset);
void emu_launch(dim3 grid, dim3 block, std::function<void()> fn);
"""

EMU_RT = r"""
#include <deque>
#include <random>
#include <thread>
#include <vector>
#include "cuda_emu.h"
thread_local uint3 threadIdx, blockIdx;
dim3 gridDim;
static std::barrier<>* emu_block_bar;
struct EmuWarp { float v[32]; std::barrier<>* bar; };
static EmuWarp* emu_warps;
static unsigned emu_seed = 1;
void __syncthreads() { emu_block_bar->arrive_and_wait(); }
float __shfl_xor_sync(unsigned, float x, int offset) {
  const int lane = threadIdx.x & 31;
  EmuWarp& w = emu_warps[threadIdx.x >> 5];
  w.v[lane] = x;
  w.bar->arrive_and_wait();
  const float r = w.v[lane ^ offset];
  w.bar->arrive_and_wait();
  return r;
}
void emu_launch(dim3 grid, dim3 block, std::function<void()> fn) {
  gridDim = grid;
  std::vector<uint3> order;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) order.push_back({bx, by, 0});
  std::shuffle(order.begin(), order.end(), std::mt19937(emu_seed++));
  const int nt = block.x, nw = (nt + 31) / 32;
  for (const uint3 blk : order) {
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
        blockIdx = blk;
        fn();
      });
    for (auto& th : threads) th.join();
  }
}
"""

LAUNCH = re.compile(r"(\w+(?:<[^;<>]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);", re.S)


def _launch(m) -> str:
    grid, block = [x.strip() for x in m.group(2).split(",")[:2]]
    return (f"emu_launch(dim3({grid}), dim3({block}), "
            f"[&] {{ {m.group(1)}({m.group(3)}); }});")


def rewrite(name: str) -> str:
    text = (build.CSRC / name).read_text()
    text = text.replace("#include <cuda_runtime.h>\n",
                        '#include "cuda_emu.h"\n')
    text = LAUNCH.sub(_launch, text)
    if "<<<" in text or "asm" in re.sub(r"//.*", "", text):
        raise RuntimeError(f"{name}: a launch or inline assembly is left")
    return text


def compile_library(out: Path) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    (out / "common.cuh").write_text(rewrite("common.cuh"))
    (out / "fused_conv.cpp").write_text(rewrite("fused_conv.cu"))
    (out / "cuda_emu.h").write_text(EMU_H)
    (out / "emu_rt.cpp").write_text(EMU_RT)
    lib = out / "fused_conv_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-ffp-contract=off", "-include", "cuda_emu.h",
                    "-o", str(lib), "fused_conv.cpp", "emu_rt.cpp"],
                   cwd=out, check=True)
    return ctypes.CDLL(str(lib))


@contextlib.contextmanager
def emulated(lib, sms: int):
    """The wrappers take CPU tensors as the card's, launch the emulation
    and get their outputs full of NaN."""
    def bind(source, symbol, argtypes):
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    saved = (build.on_card, build.bind, build.sm_count, build.device_guard,
             build.stream, torch.Tensor.new_empty, torch.empty_like)
    build.on_card = lambda name, t: True
    build.bind = bind
    build.sm_count = lambda device: sms
    build.device_guard = lambda device: contextlib.nullcontext()
    build.stream = lambda device: 0
    torch.Tensor.new_empty = lambda t, shape, **kw: t.new_full(
        shape, float("nan"), **kw)
    torch.empty_like = lambda t: torch.full_like(t, float("nan"))
    fc._plans.cache_clear()
    try:
        yield
    finally:
        (build.on_card, build.bind, build.sm_count, build.device_guard,
         build.stream, torch.Tensor.new_empty, torch.empty_like) = saved
        fc._plans.cache_clear()


def case(lib, sms, n, c, s):
    gen = torch.Generator().manual_seed(1000 * n + 10 * c + s)
    a = torch.randn(n, c, s, generator=gen) + 0.5
    d = torch.randn(n, c, s, generator=gen)
    sc = torch.rand(c, generator=gen) + 0.5
    sh = torch.randn(c, generator=gen)
    with emulated(lib, sms):
        got = fc.channel_stats(a)
        again = fc.channel_stats(a)
        plan = fc._plans(n, c, s, a.device.index)
        ys = {(add, relu): (fc.apply_epilogue_add(a, sc, sh, d, relu) if add
                            else fc.apply_epilogue(a, sc, sh, relu))
              for add in (False, True) for relu in (False, True)}
        buf, count = fc._scratch[(a.device.index, 0)]
        tickets = buf[:count].view(torch.int32)
    want = fc.channel_stats_reference(a)
    terms = (a.abs().sum(dim=(0, 2)), (a * a).sum(dim=(0, 2)))
    stats = max(float(((g - w).abs() / (1e-5 * m)).max())
                for g, w, m in zip(got, want, terms))
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    apply = max(float(((y - w).abs() / (1e-5 + 1e-5 * w.abs())).max())
                for (add, relu), y in ys.items()
                for w in [fc.apply_epilogue_reference(
                    a, sc, sh, d if add else None, relu)])
    (lanes, rows, width), (_, arows) = plan
    ranges = -(-c * s // (4 * lanes))
    print(f"N {n}, C {c}, S {s}: {'float4' if c * s % 4 == 0 else 'scalar'}"
          f" rows, lanes {lanes}, {ranges} column range(s) x "
          f"{-(-n // rows)} slice(s) (apply x {-(-n // arows)}), "
          f"{-(-c // fc._GROUP)} ticket(s); largest share of the limit: "
          f"stats {stats:.4f}, apply {apply:.4f}; a second call the same "
          f"bits {same}; tickets back at 0 {int(tickets.abs().sum()) == 0}",
          flush=True)
    return (stats <= 1 and apply <= 1 and same
            and int(tickets.abs().sum()) == 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="+", help="N,C,S")
    ap.add_argument("--sms", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(1)
    lib = compile_library(build.BUILD_DIR / "fused_conv_emulation")
    ok = [case(lib, args.sms, *map(int, sh.split(",")))
          for sh in args.shapes]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
