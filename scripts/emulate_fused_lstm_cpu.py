"""Run the LSTM sequence kernels of ``paddle_tpu_torch/csrc/fused_lstm.cu``
(the forward, or with ``--bwd`` the backward) on the CPU, before any GPU
sees them.

The harness of ``scripts/emulate_flash_bwd_cpu.py`` (copies of the source
and of ``tf32_mma.cuh``, its block of copy and mma helpers replaced: a
per-thread queue of copies that lands at ``wait_group``, ``mma.sync``
m16n8k8 TF32 an exchange of the warp's fragments summed in double and
truncated toward zero), with one change for the grid barrier: every
thread of the grid is a fiber (``ucontext``) of one host thread, so
that all the blocks of a cooperative launch run at once and meet at the
barrier. A fiber yields at ``__syncthreads``, ``__syncwarp``, the mma
exchange and each turn of the barrier's spin; the barrier counters are
``std::atomic_ref``. Each block's dynamic shared memory is filled with
NaN, so that a read before its copy lands shows. Launches with
``<<<...>>>`` (the step kernel, the backward's products) run their
blocks one after another.
Two libraries are built with ``g++ -std=c++20`` into
``paddle_tpu_torch/_build/``: one whose copies land at ``wait_group``,
one whose copies land as they are issued.

The wrapper ``fused_lstm.lstm_seq_fwd`` itself is called on CPU tensors
(``build.bind`` pointed at the emulation, ``build.sm_count`` and the
emulated card at ``--sms`` SMs of one block, every output allocated full
of NaN) at each T,B,H[,r][,o] given (r: ragged lengths in [1, T], 1 and
T among them; o: r0 a view 4 bytes into a larger buffer): the plan it
took (``fused_lstm.fwd_plan``), the largest share of the atol = rtol =
1e-5 limit of rs and cs against ``lstm_seq_fwd_reference``, whether a
second call gives the same bits, whether copies landing at once do,
whether the barrier counters are back at 0, and how many 16-byte copies
had a source or destination off 16 bytes (a fault on the card). Last, a
cooperative launch whose grid the emulated card cannot hold must raise.

With ``--bwd`` the wrapper ``fused_lstm.lstm_seq_bwd`` instead, on the
forward's carries (``lstm_seq_fwd_reference``) and cotangents from the
same seed: the plan it took (``fused_lstm.bwd_plan``), the largest share
of the atol = rtol = 1e-4 limit of dx, dw, db, dr0 and dc0 against
``lstm_seq_bwd_reference``, and the same checks of bits, counters,
alignment and a refused launch (o does not apply). Exits 1 if any check
misses.

    python scripts/emulate_fused_lstm_cpu.py 5,3,8 6,4,20,r 7,5,33,r \\
        4,8,128 5,17,128,r,o 3,40,129,r 3,2,512 2,64,512,r 2,2,600 \\
        2,4,512,o 2,96,512,r
    python scripts/emulate_fused_lstm_cpu.py --sms 8 4,70,20,r 3,200,8,o \\
        3,97,16,r
    python scripts/emulate_fused_lstm_cpu.py --bwd 5,3,20,r 1,1,8 \\
        9,17,33,r 8,4,16,r 4,8,128 3,40,129,r 3,2,512,r 2,64,512,r \\
        2,96,512,r 2,2,600
    python scripts/emulate_fused_lstm_cpu.py --bwd --sms 8 4,70,20,r \\
        3,97,16,r
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

import emulate_flash_bwd_cpu as flash_emu  # noqa: E402
import emulate_moments_cpu as emu  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_lstm as fl  # noqa: E402

SOURCE = "fused_lstm.cu"
LIMIT = 1e-5
BWD_LIMIT = 1e-4

EMU_H = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <type_traits>
#include <utility>
#include <vector>
#include <ucontext.h>
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
struct __attribute__((aligned(16))) float4 { float x, y, z, w; };
struct __attribute__((aligned(8))) float2 { float x, y; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorCooperativeLaunchTooLarge = 720
};
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
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
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
[[noreturn]] inline void __trap() { std::abort(); }
using std::max;
using std::min;

// ---- fibers: every thread of a launch, on one host thread
struct EmuCopy { float* dst; const float* src; int bytes, n; };
void emu_yield();
struct EmuBar {
  int n = 0, count = 0;
  unsigned gen = 0;
  void arrive_and_wait() {
    const unsigned g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
    } else {
      while (gen == g) emu_yield();
    }
  }
};
struct EmuWarp {
  uint32_t a[32][4], b[32][2];
  float c[32][4];
  EmuBar bar;
};
struct EmuBlock {
  std::vector<float> smem;
  EmuBar bar;
  std::vector<EmuWarp> warps;
};
struct EmuFiber {
  ucontext_t ctx;
  uint3 tid, bid;
  EmuBlock* blk;
  std::vector<std::vector<EmuCopy>> groups;
  std::vector<EmuCopy> open;
  bool done;
};
extern EmuFiber* emu_cur;
extern dim3 gridDim;
#define threadIdx (emu_cur->tid)
#define blockIdx (emu_cur->bid)
#define emu_groups (emu_cur->groups)
#define emu_open (emu_cur->open)
#define emu_dyn_smem (emu_cur->blk->smem.data())
inline void __syncthreads() { emu_cur->blk->bar.arrive_and_wait(); }
inline void __syncwarp() {
  emu_cur->blk->warps[threadIdx.x >> 5].bar.arrive_and_wait();
}
inline void emu_land(size_t keep) {
  while (emu_groups.size() > keep) {
    for (auto& c : emu_groups.front()) {
      std::memset(c.dst, 0, c.bytes);
      if (c.n) std::memcpy(c.dst, c.src, c.n);
    }
    emu_groups.erase(emu_groups.begin());
  }
}
inline float emu_tf32(uint32_t u) { return __uint_as_float(u & 0xffffe000u); }
inline void emu_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                    uint32_t b1, const float (&c)[4]) {
  const int lane = threadIdx.x & 31;
  EmuWarp& W = emu_cur->blk->warps[threadIdx.x >> 5];
  for (int i = 0; i < 4; ++i) {
    W.a[lane][i] = a[i];
    W.c[lane][i] = c[i];
  }
  W.b[lane][0] = b0;
  W.b[lane][1] = b1;
  W.bar.arrive_and_wait();
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
  W.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}
// <<<grid, block, smem>>>: the blocks one after another; a cooperative
// launch: all its blocks at once, refused beyond emu_sms x emu_per_sm
void emu_launch(dim3 grid, dim3 block, int smem_bytes,
                std::function<void()> fn);
int emu_coop(dim3 grid, dim3 block, int smem_bytes, std::function<void()> fn);
extern int emu_sms, emu_per_sm, emu_misaligned;
template <class... A, std::size_t... I>
inline void emu_call(void (*fn)(A...), void** args, std::index_sequence<I...>) {
  fn(*static_cast<std::remove_reference_t<A>*>(args[I])...);
}
template <class... A>
inline cudaError_t cudaLaunchCooperativeKernel(void (*fn)(A...), dim3 grid,
                                               dim3 block, void** args,
                                               size_t smem, cudaStream_t) {
  return emu_coop(grid, block, (int)smem, [=] {
    emu_call(fn, args, std::index_sequence_for<A...>{});
  });
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* out, F, int, size_t) {
  *out = emu_per_sm;
  return 0;
}
"""

EMU_RT = r"""
#include <limits>
#include <sys/mman.h>
#include "cuda_emu.h"
EmuFiber* emu_cur;
dim3 gridDim;
int emu_sms = 132, emu_per_sm = 1, emu_misaligned = 0;
static ucontext_t emu_main;
static std::function<void()>* emu_fn;
constexpr size_t kStack = 64 << 10;
void emu_yield() { swapcontext(&emu_cur->ctx, &emu_main); }
static void emu_entry() {
  (*emu_fn)();
  emu_cur->groups.clear();
  emu_cur->open.clear();
  emu_cur->done = true;
}
// Runs the fibers of `blocks` (x, y) until all are done: each pass gives
// every live fiber a turn, up to its next yield.
static void emu_run(const std::vector<uint3>& ids, dim3 block, int smem_bytes,
                    std::function<void()>& fn) {
  const int nt = block.x, nw = (nt + 31) / 32;
  std::vector<EmuBlock> blocks(ids.size());
  for (auto& b : blocks) {
    b.smem.assign(smem_bytes / 4 + 4, std::numeric_limits<float>::quiet_NaN());
    b.bar.n = nt;
    b.warps.resize(nw);
    for (auto& w : b.warps) w.bar.n = 32;
  }
  const size_t n = ids.size() * nt;
  char* stacks = static_cast<char*>(
      mmap(nullptr, n * kStack, PROT_READ | PROT_WRITE,
           MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0));
  if (stacks == MAP_FAILED) std::abort();
  std::vector<EmuFiber> fibers(n);
  emu_fn = &fn;
  for (size_t i = 0; i < n; ++i) {
    EmuFiber& f = fibers[i];
    f.tid = {(unsigned)(i % nt), 0, 0};
    f.bid = ids[i / nt];
    f.blk = &blocks[i / nt];
    f.done = false;
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = stacks + i * kStack;
    f.ctx.uc_stack.ss_size = kStack;
    f.ctx.uc_link = &emu_main;
    makecontext(&f.ctx, emu_entry, 0);
  }
  for (long pass = 0;; ++pass) {
    if (pass > 50000000) std::abort();  // no progress: a deadlock
    bool live = false;
    for (auto& f : fibers)
      if (!f.done) {
        live = true;
        emu_cur = &f;
        swapcontext(&emu_main, &f.ctx);
      }
    if (!live) break;
  }
  munmap(stacks, n * kStack);
}
void emu_launch(dim3 grid, dim3 block, int smem_bytes,
                std::function<void()> fn) {
  gridDim = grid;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx)
        emu_run({{bx, by, bz}}, block, smem_bytes, fn);
}
int emu_coop(dim3 grid, dim3 block, int smem_bytes, std::function<void()> fn) {
  if (grid.x * grid.y > (unsigned)(emu_sms * emu_per_sm))
    return cudaErrorCooperativeLaunchTooLarge;
  gridDim = grid;
  std::vector<uint3> ids;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) ids.push_back({bx, by, 0});
  emu_run(ids, block, smem_bytes, fn);
  return 0;
}
extern "C" void emu_set_card(int sms, int per_sm) {
  emu_sms = sms;
  emu_per_sm = per_sm;
}
// 16-byte copies from or to an address off 16 bytes since the last call
// (on the card, a misaligned-address fault)
extern "C" int emu_take_misaligned() {
  const int n = emu_misaligned;
  emu_misaligned = 0;
  return n;
}
"""

# fused_lstm.cu's grid barrier, on the fibers: the spin yields
GRID = r"""// ---- grid barrier (emulated)
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned target) {
  std::atomic_ref<unsigned>(*count).fetch_add(1u, std::memory_order_release);
  while (std::atomic_ref<unsigned>(*count).load(std::memory_order_acquire) <
         target)
    emu_yield();
}
"""


# the emulated 16-byte copy counts a source or destination off 16 bytes
COPY16 = ("void copy16(float* dst, const float* src, bool ok) {\n",
          "void copy16(float* dst, const float* src, bool ok) {\n"
          "  emu_misaligned += (reinterpret_cast<uintptr_t>(src) |\n"
          "                     reinterpret_cast<uintptr_t>(dst)) % 16 != 0;\n")


def rewrite(name: str) -> str:
    text = (build.CSRC / name).read_text()
    text = text.replace("#include <cuda_runtime.h>\n",
                        '#include "cuda_emu.h"\n')
    if name == "tf32_mma.cuh":
        a = text.index("// ---- asynchronous copies and the tensor-core "
                       "product")
        b = text.index("// ------------------------------------------------"
                       "-----------------------------", a)
        helpers = flash_emu.HELPERS.replace(*COPY16)
        if helpers == flash_emu.HELPERS:
            raise RuntimeError("the emulated copy16 was not found")
        text = text[:a] + helpers + text[b:]
    if name == SOURCE:
        a = text.index("// ---- grid barrier")
        b = text.index("// ------------------------------------------------"
                       "-----------------------------", a)
        text = text[:a] + GRID + text[b:]
    text = text.replace(
        "extern __shared__ float4 smem4[];",
        "float4* smem4 = reinterpret_cast<float4*>(emu_dyn_smem);")
    text = emu.LAUNCH.sub(emu._launch, text)
    if "asm" in re.sub(r"//.*", "", text) or "<<<" in text:
        raise RuntimeError(f"{name}: a launch or inline assembly is left")
    return text


def compile_library(out: Path, eager: bool) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    for name in ("tf32_mma.cuh", SOURCE):
        (out / name).write_text(rewrite(name))
    (out / "cuda_emu.h").write_text(EMU_H)
    (out / "emu_rt.cpp").write_text(EMU_RT)
    (out / "unit.cpp").write_text(f'#include "{SOURCE}"\n')
    lib = out / "fused_lstm_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-ffp-contract=off", "-include", "cuda_emu.h",
                    *(["-DEMU_EAGER"] if eager else []), "-o", str(lib),
                    "unit.cpp", "emu_rt.cpp"], cwd=out, check=True)
    return ctypes.CDLL(str(lib))


def _nan_empty(*shape, dtype=None, device=None, **_):
    return torch.full(*shape if len(shape) == 1 else (shape,), float("nan"),
                      dtype=dtype, device=device)


@contextlib.contextmanager
def emulated(lib, sms: int):
    """The wrapper takes CPU tensors as the card's, launches the emulation
    and gets its outputs full of NaN."""
    def bind(source, symbol, argtypes):
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    saved = (build.on_card, build.bind, build.sm_count, build.device_guard,
             build.stream, torch.empty, torch.empty_like)
    build.on_card = lambda name, t: True
    build.bind = bind
    build.sm_count = lambda device: sms
    build.device_guard = lambda device: contextlib.nullcontext()
    build.stream = lambda device: 0
    torch.empty = _nan_empty
    torch.empty_like = lambda t: torch.full_like(t, float("nan"))
    plans = (fl._plan_of, fl._bwd_plan_of, fl._blocks_per_sm)
    for fn in plans:
        fn.cache_clear()
    fl._barriers.clear()
    try:
        yield
    finally:
        (build.on_card, build.bind, build.sm_count, build.device_guard,
         build.stream, torch.empty, torch.empty_like) = saved
        for fn in plans:
            fn.cache_clear()


def inputs(t, b, h, ragged, offset=False):
    """chip_smoke.lstm_case's inputs, from a seed, on the CPU; offset: r0
    a view 4 bytes into a larger buffer."""
    gen = torch.Generator().manual_seed(100 * t + 10 * b + h)
    lim = (6.0 / (5 * h)) ** 0.5
    if ragged:
        lens = torch.randint(1, t + 1, (b,), generator=gen)
        lens[0] = 1
        lens[-1] = t
        mask = (torch.arange(t)[:, None] < lens[None, :]).float()
    else:
        mask = torch.ones(t, b)
    x = torch.randn(t, b, 4 * h, generator=gen)
    w = (torch.rand(h, 4 * h, generator=gen) * 2 - 1) * lim
    bias = 0.1 * torch.randn(4 * h, generator=gen)
    r0 = 0.5 * torch.randn(b, h, generator=gen)
    if offset:
        r0 = torch.cat([torch.zeros(1), r0.flatten()])[1:].view(b, h)
    return x, w, bias, mask, r0, torch.randn(b, h, generator=gen)


def bwd_inputs(t, b, h, ragged):
    """The backward's inputs: the forward's, its carries shifted by one
    step (r_prevs, c_prevs) and cotangents ~ N(0, 1), from the seed."""
    x, w, bias, mask, r0, c0 = inputs(t, b, h, ragged)
    rs, cs = fl.lstm_seq_fwd_reference(x, w, bias, mask, r0, c0)
    gen = torch.Generator().manual_seed(7 * t + b + h)
    return (x, w, bias, mask, torch.cat([r0[None], rs[:-1]]),
            torch.cat([c0[None], cs[:-1]]), torch.randn(t, b, h, generator=gen),
            torch.randn(t, b, h, generator=gen))


def case(libs, sms, t, b, h, ragged, offset, bwd=False):
    if bwd:
        args, run, plan, limit = (bwd_inputs(t, b, h, ragged), fl.lstm_seq_bwd,
                                  fl._bwd_plan_of, BWD_LIMIT)
        want = fl.lstm_seq_bwd_reference(*args)
        other = "2T + 4 launches"
    else:
        args, run, plan, limit = (inputs(t, b, h, ragged, offset),
                                  fl.lstm_seq_fwd, fl._plan_of, LIMIT)
        want = fl.lstm_seq_fwd_reference(*args)
        other = "step kernel, T launches"
    with emulated(libs["wait"], sms):
        took = plan(b, h, None)
        got = run(*args)
        again = run(*args)
        counters = [v.clone() for v in fl._barriers.values()]
    with emulated(libs["eager"], sms):
        eager = run(*args)
    misaligned = sum(lib.emu_take_misaligned() for lib in libs.values())
    share = max(float(((g - w).abs() / (limit + limit * w.abs())).max())
                for g, w in zip(got, want))
    same = [all(torch.equal(x, y) for x, y in zip(got, o))
            for o in (again, eager)]
    zero = all(int(c.abs().sum()) == 0 for c in counters)
    print(f"{'bwd' if bwd else 'fwd'} T {t}, B {b}, H {h}, "
          f"{'ragged' if ragged else 'full length'}"
          f"{', r0 4 bytes off 16' if offset else ''}: "
          f"{took or other}; largest share of the {limit:g} "
          f"limit {share:.4f}; a second call the same bits {same[0]}; "
          f"copies landing at once the same bits {same[1]}; barrier "
          f"counters back at 0 {zero}; misaligned 16-byte copies "
          f"{misaligned}", flush=True)
    return share <= 1 and all(same) and zero and not misaligned


def refused(lib, sms, bwd=False) -> bool:
    """A plan whose grid the emulated card (one SM) cannot hold: the
    cooperative launch is refused and the wrapper raises."""
    if bwd:
        args, run, plan = bwd_inputs(3, 4, 64, False), fl.lstm_seq_bwd, \
            fl._bwd_plan_of
    else:
        args, run, plan = inputs(3, 4, 64, False), fl.lstm_seq_fwd, \
            fl._plan_of
    lib.emu_set_card(1, 1)
    try:
        with emulated(lib, 132):
            plan(4, 64, None)   # a plan for 132 SMs ...
            try:
                run(*args)    # ... launched on one
            except RuntimeError as e:
                print(f"a grid larger than the card: raised ({e})")
                return True
    finally:
        lib.emu_set_card(sms, 1)
    print("a grid larger than the card: no error")
    return False


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="+", help="T,B,H[,r]")
    ap.add_argument("--sms", type=int, default=132)
    ap.add_argument("--bwd", action="store_true",
                    help="the backward (lstm_seq_bwd) instead")
    args = ap.parse_args()
    torch.set_num_threads(1)
    libs = {name: compile_library(build.BUILD_DIR / f"lstm_emu_{name}",
                                  name == "eager")
            for name in ("wait", "eager")}
    for lib in libs.values():
        lib.emu_set_card.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.emu_set_card(args.sms, 1)
    ok = []
    for shape in args.shapes:
        parts = shape.split(",")
        t, b, h = map(int, parts[:3])
        flags = set(parts[3:])
        if not flags <= ({"r"} if args.bwd else {"r", "o"}):
            ap.error(f"{shape}: flags are r (ragged) and, for the forward, "
                     f"o (offset r0)")
        ok.append(case(libs, args.sms, t, b, h, "r" in flags, "o" in flags,
                       args.bwd))
    ok.append(refused(libs["wait"], args.sms, args.bwd))
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
