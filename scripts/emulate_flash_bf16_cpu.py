"""Run the bfloat16 flash-attention kernels of ``paddle_tpu_torch/csrc/
flash_attention_bf16.cu`` (forward, dQ, dK/dV) on the CPU, before any GPU
sees them.

The harness of ``scripts/emulate_flash_bwd_cpu.py``: a copy of the source
and of ``common.cuh`` and ``sm90.cuh``, rewritten for g++ (threads for a
block's threads, ``gridDim`` set by each launch, shared memory filled
with 0xff bytes, a NaN in bf16 and in float32, so that a read before its
tile lands shows). The source's block of conversions, shuffles and
exponentials is replaced: ``cvt.rn.bf16x2.f32`` becomes a round to
nearest even on the bits, the xor shuffle an exchange through a per-warp
barrier, ``ex2.approx`` exp2 with subnormal results flushed to 0.
``sm90.cuh``'s block of PTX is replaced by models of Hopper's units, and
its descriptor arithmetic kept:

* shared addresses are offsets from the 1024-byte boundary below the
  block's dynamic shared memory (which starts past it, as nothing promises
  the card's is aligned);
* a TMA box load reads the tensor map's box (zeros past any dimension's
  end) and writes it with the 128-byte swizzle (address bits 4-6 XOR bits
  7-9), then completes its bytes on the mbarrier; a TMA store reads the
  box back through the same swizzle and writes what lies inside the
  tensor; either's shared memory must be 1024-byte aligned;
* an mbarrier has a count, pending arrivals, a transaction count and a
  phase: a phase ends when the arrivals and the announced bytes are all
  in, a wait on parity p returns once the phase of parity p is over, and
  an arrival beyond the count or bytes beyond those announced abort;
* named barriers count their threads by generation;
* a ``wgmma.mma_async`` (SS or RS, m64nNk16 for N = 32 to 256) is held
  until the ``wait_group`` that retires its group: then each thread
  computes its own accumulators, reading A from the warpgroup's
  registers as they were when the product started (RS) or through its
  descriptor (SS), and B through its descriptor, each element's address
  decoded as the PTX ISA lays out the canonical K-major and MN-major
  layouts with the 128-byte swizzle, products summed in double; so
  accumulators read before their wait, or a tile released or rewritten
  before the products that read it retire, show;
* ``setmaxnreg``, ``wgmma.fence`` and the proxy fence do nothing (so a
  missing ``fence.proxy.async`` between generic stores and the wgmma
  that reads them, as dQ's dS tile, shows only on the card);
* the grids' L2 budget is 150,000 bytes, so that their groups of heads
  hold one or two heads at the shapes emulated.

The models run the kernels' order of events, not the card's timing:
threads interleave as the host schedules them. Two libraries are built
with ``g++ -std=c++20`` into ``paddle_tpu_torch/_build/``: one whose TMA
loads land at the first wait on their mbarrier (a tile read without that
wait then holds the 0xff fill or an older tile), one whose loads land as
they start (a tile reloaded before the products that read it retire
then shows). The entry points are called through ``ctypes`` on CPU
tensors at each B,Sq,Sk,H,D,causal given, bf16 inputs from a seed, the
backward from the plain forward's O and lse: the largest share of the
kernels' limits (2^-7 max|plain| + 2^-7 |plain| for O, dQ, dK and dV;
1e-4 for lse) against the plain versions, whether a second call gives
the same bits, and whether both landings do. Exits 1 if any shape
misses.

    python scripts/emulate_flash_bf16_cpu.py 1,128,128,2,64,1 1,129,129,2,256,1
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

import emulate_flash_bwd_cpu as bwd_emu  # noqa: E402
import emulate_moments_cpu as emu  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402

SOURCE = "flash_attention_bf16.cu"
HEADERS = ("common.cuh", "sm90.cuh")
BF16_REL = 2.0 ** -7
LSE_TOL = 1e-4

HELPERS = r"""// ---- conversions, shuffles and exponentials (emulated)
inline uint32_t emu_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return emu_bf16(lo) | emu_bf16(hi) << 16;
}
__device__ __forceinline__ float shfl_xor(float x, int m) {
  const int lane = threadIdx.x & 31;
  EmuWarp& W = emu_warps[threadIdx.x >> 5];
  W.c[lane][0] = x;
  W.bar->arrive_and_wait();
  const float r = W.c[lane ^ m][0];
  W.bar->arrive_and_wait();
  return r;
}
__device__ __forceinline__ float ex2(float x) {
  const float r = std::exp2(x);
  return std::fpclassify(r) == FP_SUBNORMAL ? 0.f : r;
}
"""

SM90_HELPERS = r"""// ---- Hopper's asynchronous units (emulated)
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <map>
#include <mutex>
// the tensor map's fields, in place of the driver's opaque 128 bytes
struct CUtensorMap {
  const char* base;
  uint64_t dims[4], strides[4];
  uint32_t box[4];
};
#define __grid_constant__
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warps[threadIdx.x >> 5].bar->arrive_and_wait();
}
namespace sm90 {
[[noreturn]] inline void emu_fail(const char* what) {
  std::fprintf(stderr, "sm90 emulation: %s\n", what);
  std::abort();
}
// shared addresses: offsets from the 1024-byte boundary below the block's
// dynamic shared memory
inline char* emu_window() {
  return reinterpret_cast<char*>(reinterpret_cast<uintptr_t>(emu_dyn_smem) &
                                 ~uintptr_t(1023));
}
inline uint32_t smem_u32(const void* p) {
  return (uint32_t)(static_cast<const char*>(p) - emu_window());
}
inline uint32_t emu_swizzle(uint32_t a) { return a ^ (((a >> 7) & 7) << 4); }

inline std::mutex emu_mu;
inline std::condition_variable emu_cv;
struct EmuBar { uint32_t count, pending; int64_t tx; uint32_t phase; };
inline std::map<uint32_t, EmuBar> emu_bars;
inline EmuBar& emu_bar(uint32_t bar) {
  auto it = emu_bars.find(bar);
  if (it == emu_bars.end()) emu_fail("an mbarrier used before its init");
  return it->second;
}
inline void emu_bar_step(EmuBar& b) {
  if (b.tx < 0) emu_fail("more bytes landed than were announced");
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1;
    b.pending = b.count;
    emu_cv.notify_all();
  }
}
inline void emu_bar_arrival(uint32_t bar, int64_t bytes) {
  std::lock_guard<std::mutex> lk(emu_mu);
  EmuBar& b = emu_bar(bar);
  if (b.pending == 0) emu_fail("an arrival beyond the mbarrier's count");
  b.tx += bytes;
  --b.pending;
  emu_bar_step(b);
}
inline void bar_init(uint32_t bar, uint32_t count) {
  std::lock_guard<std::mutex> lk(emu_mu);
  emu_bars[bar] = {count, count, 0, 0};
}
inline void bar_init_fence() {}
inline void bar_arrive(uint32_t bar) { emu_bar_arrival(bar, 0); }
inline void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  emu_bar_arrival(bar, bytes);
}
inline void fence_proxy_async() {}

struct EmuNamed { int count = 0; unsigned gen = 0; };
inline std::map<int, EmuNamed> emu_named;
inline void emu_named_arrival(int id, int threads, bool wait) {
  std::unique_lock<std::mutex> lk(emu_mu);
  EmuNamed& b = emu_named[id];
  const unsigned gen = b.gen;
  if (++b.count == threads) {
    b.count = 0;
    ++b.gen;
    emu_cv.notify_all();
  } else if (wait) {
    emu_cv.wait(lk, [&] { return b.gen != gen; });
  }
}
inline void named_sync(int id, int threads) {
  emu_named_arrival(id, threads, true);
}
inline void named_arrive(int id, int threads) {
  emu_named_arrival(id, threads, false);
}

// the box at (c0, c1, c2, c3), innermost first, zeros past any dimension's
// end, written densely from dst with the 128-byte swizzle; returns its bytes
inline uint32_t emu_tma_copy(uint32_t dst, const CUtensorMap& map,
                             const int (&c)[4]) {
  const uint32_t* box = map.box;
  uint32_t off = 0;
  for (uint32_t i3 = 0; i3 < box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < box[1]; ++i1)
        for (uint32_t i0 = 0; i0 < box[0]; ++i0, off += 2) {
          const int64_t x[4] = {c[0] + (int64_t)i0, c[1] + (int64_t)i1,
                                c[2] + (int64_t)i2, c[3] + (int64_t)i3};
          uint16_t v = 0;
          bool in = true;
          int64_t src = 0;
          for (int d = 0; d < 4; ++d) {
            in = in && x[d] >= 0 && x[d] < (int64_t)map.dims[d];
            src += x[d] * (int64_t)map.strides[d];
          }
          if (in) std::memcpy(&v, map.base + src, 2);
          std::memcpy(emu_window() + emu_swizzle(dst + off), &v, 2);
        }
  return off;
}
// a box load in flight: it lands (its bytes written and completed on its
// mbarrier) at the first wait on that mbarrier, or at once (EMU_EAGER)
struct EmuTma {
  uint32_t dst;
  CUtensorMap map;
  int c[4];
  uint32_t bar;
};
inline std::vector<EmuTma> emu_tma_queue;
// with emu_mu held
inline void emu_tma_land(uint32_t bar) {
  for (size_t i = 0; i < emu_tma_queue.size();) {
    if (emu_tma_queue[i].bar != bar) {
      ++i;
      continue;
    }
    const EmuTma op = emu_tma_queue[i];
    emu_tma_queue.erase(emu_tma_queue.begin() + i);
    EmuBar& b = emu_bar(bar);
    b.tx -= emu_tma_copy(op.dst, op.map, op.c);
    emu_bar_step(b);
  }
}
inline void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                        int c0, int c1, int c2, int c3) {
  if (dst % 1024) emu_fail("a swizzled TMA box not on 1024 bytes");
  std::lock_guard<std::mutex> lk(emu_mu);
  emu_tma_queue.push_back({dst, *map, {c0, c1, c2, c3}, bar});
#ifdef EMU_EAGER
  emu_tma_land(bar);
#endif
  emu_cv.notify_all();
}
inline bool bar_try_wait(uint32_t bar, uint32_t parity) {
  std::lock_guard<std::mutex> lk(emu_mu);
  emu_tma_land(bar);
  return emu_bar(bar).phase != parity;
}
inline void bar_wait(uint32_t bar, uint32_t parity) {
  std::unique_lock<std::mutex> lk(emu_mu);
  emu_cv.wait(lk, [&] {
    emu_tma_land(bar);
    return emu_bar(bar).phase != parity;
  });
}

// the box at src (swizzled) to its coordinates, those past a
// dimension's end not written
inline void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                         int c1, int c2, int c3) {
  if (src % 1024) emu_fail("a swizzled TMA box not on 1024 bytes");
  const int c[4] = {c0, c1, c2, c3};
  const uint32_t* box = map->box;
  uint32_t off = 0;
  for (uint32_t i3 = 0; i3 < box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < box[1]; ++i1)
        for (uint32_t i0 = 0; i0 < box[0]; ++i0, off += 2) {
          const int64_t x[4] = {c[0] + (int64_t)i0, c[1] + (int64_t)i1,
                                c[2] + (int64_t)i2, c[3] + (int64_t)i3};
          bool in = true;
          int64_t dst = 0;
          for (int d = 0; d < 4; ++d) {
            in = in && x[d] >= 0 && x[d] < (int64_t)map->dims[d];
            dst += x[d] * (int64_t)map->strides[d];
          }
          if (in)
            std::memcpy(const_cast<char*>(map->base) + dst,
                        emu_window() + emu_swizzle(src + off), 2);
        }
}
inline void bulk_commit() {}
inline void bulk_wait_read() {}

template <int N>
inline void regs_dec() {}
template <int N>
inline void regs_inc() {}

// wgmma: held per thread until the wait that retires its group
struct EmuWgOp {
  float* d;
  int n, tb, accumulate;
  bool rs;
  uint64_t da, db;
  uint32_t slot;
};
inline thread_local std::vector<EmuWgOp> emu_wg_open;
inline thread_local std::deque<std::vector<EmuWgOp>> emu_wg_groups;
inline thread_local uint32_t emu_wg_seq;
// each warpgroup's A registers of its last 256 RS products
inline uint32_t emu_wg_a[4][256][128][4];
inline void wg_fence() {}
inline void wg_commit() {
  emu_wg_groups.push_back(std::move(emu_wg_open));
  emu_wg_open.clear();
}
inline float emu_bf16_value(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}
// element (i, k) of an operand, i along M or N, k along the k16 step: a
// K-major (tb 0) or MN-major (tb 1) tile with the 128-byte swizzle
inline float emu_operand(uint64_t desc, int tb, int i, int k) {
  if ((desc >> 62) != 1) emu_fail("a descriptor without the 128-byte swizzle");
  if ((desc >> 49) & 7) emu_fail("a descriptor with a base offset");
  const uint32_t start = (uint32_t)(desc & 0x3fff) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3fff) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3fff) << 4;
  const uint32_t a =
      tb == 0
          ? start + (i / 8) * sbo + (i % 8) * 128 + (k / 8) * 16 + (k % 8) * 2
          : start + (i / 64) * lbo + (i % 64) * 2 + (k / 8) * sbo +
                (k % 8) * 128;
  uint16_t h;
  std::memcpy(&h, emu_window() + emu_swizzle(a), 2);
  return emu_bf16_value(h);
}
// element (row, k) of an RS product's A: mma.sync's m16n8k16 A fragments,
// warp row / 16 holding its 16 rows
inline float emu_rs_a(int wg, uint32_t slot, int row, int k) {
  const int holder = 32 * (row / 16) + 4 * (row % 8) + (k % 8) / 2;
  const int reg = (row % 16) / 8 + 2 * (k / 8);
  return emu_bf16_value((uint16_t)(emu_wg_a[wg][slot][holder][reg] >> (16 * (k & 1))));
}
inline void emu_wg_eval(const EmuWgOp& op) {
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  float out[128];
  for (int j = 0; j < op.n / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * w + g + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
      double s = op.accumulate ? op.d[4 * j + e] : 0.0;
      for (int k = 0; k < 16; ++k) {
        const float av = op.rs ? emu_rs_a(wg, op.slot, row, k)
                               : emu_operand(op.da, 0, row, k);
        s += (double)av * (double)emu_operand(op.db, op.tb, col, k);
      }
      out[4 * j + e] = (float)s;
    }
  for (int i = 0; i < op.n / 2; ++i) op.d[i] = out[i];
}
template <int N>
inline void wg_wait() {
  // every thread of the warpgroup has started its products (and left
  // its A registers)
  named_sync(100 + threadIdx.x / 128, 128);
  while (emu_wg_groups.size() > (size_t)N) {
    for (const EmuWgOp& op : emu_wg_groups.front()) emu_wg_eval(op);
    emu_wg_groups.pop_front();
  }
}
template <int N>
inline void fence_operands(float (&)[N]) {}
inline void fence_operands(uint32_t (&)[4]) {}
template <int N, int TB>
inline void emu_wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  emu_wg_open.push_back({d, N, TB, accumulate, false, da, db, 0});
}
template <int TB>
inline void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                         int accumulate) {
  emu_wgmma_ss<32, TB>(d, da, db, accumulate);
}
template <int TB>
inline void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                         int accumulate) {
  emu_wgmma_ss<64, TB>(d, da, db, accumulate);
}
template <int TB>
inline void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                          int accumulate) {
  emu_wgmma_ss<128, TB>(d, da, db, accumulate);
}
template <int N, int TB>
inline void emu_wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db,
                         int accumulate) {
  const uint32_t slot = emu_wg_seq++ % 256;
  for (int r = 0; r < 4; ++r)
    emu_wg_a[threadIdx.x / 128][slot][threadIdx.x % 128][r] = a[r];
  emu_wg_open.push_back({d, N, TB, accumulate, true, 0, db, slot});
}
template <int TB>
inline void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                         int accumulate) {
  emu_wgmma_rs<32, TB>(d, a, db, accumulate);
}
template <int TB>
inline void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                         int accumulate) {
  emu_wgmma_rs<64, TB>(d, a, db, accumulate);
}
template <int TB>
inline void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                          uint64_t db, int accumulate) {
  emu_wgmma_rs<128, TB>(d, a, db, accumulate);
}
template <int TB>
inline void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                          uint64_t db, int accumulate) {
  emu_wgmma_rs<256, TB>(d, a, db, accumulate);
}

inline int encode_bshd(CUtensorMap* map, const void* base, int B, int S,
                       int H, int D, int rows) {
  *map = {static_cast<const char*>(base),
          {(uint64_t)D, (uint64_t)H, (uint64_t)S, (uint64_t)B},
          {2, 2ull * D, 2ull * H * D, 2ull * S * H * D},
          {64, 1, (uint32_t)rows, 1}};
  return 0;
}

}  // namespace sm90
"""

L2_BUDGET = "constexpr long kL2Budget = 24l << 20;"
NAN_FILL = ("std::fill(smem.begin(), smem.end(),\n"
            "                std::numeric_limits<float>::quiet_NaN());")


def rewrite(name: str) -> str:
    text = (build.CSRC / name).read_text()
    text = text.replace("#include <cuda_runtime.h>\n",
                        '#include "flash_emu.h"\n')
    blocks = {SOURCE: ("// ---- conversions, shuffles and exponentials",
                       HELPERS),
              "sm90.cuh": ("// ---- Hopper's asynchronous units",
                           SM90_HELPERS)}
    if name in blocks:
        start, helpers = blocks[name]
        a = text.index(start)
        b = text.index("// ------------------------------------------------"
                       "-----------------------------", a)
        text = text[:a] + helpers + text[b:]
    text = text.replace(
        "extern __shared__ float4 smem4[];",
        "float4* smem4 = reinterpret_cast<float4*>(emu_dyn_smem);")
    if name == SOURCE:
        # an L2 of 300 KB: the grids' groups of heads hold one or two heads
        # at the shapes emulated
        if L2_BUDGET not in text:
            raise RuntimeError("the grids' L2 budget moved")
        text = text.replace(L2_BUDGET, "constexpr long kL2Budget = 150000;")
    text = emu.LAUNCH.sub(bwd_emu._launch, text)
    if "asm" in re.sub(r"//.*", "", text):
        raise RuntimeError(f"{name}: inline assembly left after the rewrite")
    return text


def compile_library(out: Path, eager: bool) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    for name in HEADERS + (SOURCE,):
        (out / name).write_text(rewrite(name))
    if NAN_FILL not in emu.EMU_RT:
        raise RuntimeError("the harness's shared-memory fill moved")
    (out / "cuda_emu.h").write_text(emu.EMU_H)
    (out / "flash_emu.h").write_text(bwd_emu.EXTRA_H)
    (out / "emu_rt.cpp").write_text(emu.EMU_RT.replace(
        NAN_FILL, "std::memset(smem.data(), 0xff, smem.size() * 4);"))
    (out / "unit.cpp").write_text(f'#include "flash_emu.h"\n'
                                  f'#include "{SOURCE}"\n')
    lib = out / "flash_bf16_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-ffp-contract=off", "-include", "flash_emu.h",
                    *(["-DEMU_EAGER"] if eager else []), "-o", str(lib),
                    "unit.cpp", "emu_rt.cpp"], cwd=out, check=True)
    lib = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd_bf16.argtypes = [P] * 5 + [I] * 5 + [F, I, P]
    lib.flash_attention_bwd_dq_bf16.argtypes = [P] * 7 + [I] * 5 + [F, I, P]
    lib.flash_attention_bwd_dkv_bf16.argtypes = [P] * 8 + [I] * 5 + [F, I, P]
    for fn in (lib.flash_attention_fwd_bf16, lib.flash_attention_bwd_dq_bf16,
               lib.flash_attention_bwd_dkv_bf16):
        fn.restype = I
    return lib


def _nan_like(x, dtype=None):
    return torch.full(x.shape, float("nan"), dtype=dtype or x.dtype)


def run(lib, q, k, v, do, causal):
    """(O, lse, dQ, dK, dV) of one call of each entry point; the backward
    from the plain forward's O and lse."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    tail = (b, h, sq, sk, d, d ** -0.5, int(causal), None)
    o = _nan_like(q)
    lse = torch.full((b * h, sq), float("nan"))
    if lib.flash_attention_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    o.data_ptr(), lse.data_ptr(), *tail):
        raise RuntimeError("forward refused")
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
    delta = fa.flash_attention_bwd_delta(ro, do)
    ins = [x.data_ptr() for x in (q, k, v, do, rlse, delta)]
    dq, dk, dv = _nan_like(q), _nan_like(k), _nan_like(v)
    if lib.flash_attention_bwd_dq_bf16(*ins, dq.data_ptr(), *tail):
        raise RuntimeError("dQ refused")
    if lib.flash_attention_bwd_dkv_bf16(*ins, dk.data_ptr(), dv.data_ptr(),
                                        *tail):
        raise RuntimeError("dK/dV refused")
    return o, lse, dq, dk, dv


def share(got, want, tol=None) -> float:
    """The largest |got - want| over the limit: 2^-7 max|want| + 2^-7
    |want| (bf16 outputs) or `tol` (atol = rtol)."""
    got, want = got.float(), want.float()
    if tol is None:
        lim = BF16_REL * want.abs().max() + BF16_REL * want.abs()
    else:
        lim = tol + tol * want.abs()
    return float(((got - want).abs() / lim).max())


def case(libs, b, sq, sk, h, d, causal):
    gen = torch.Generator().manual_seed(b + sq + 3 * sk + h + d)
    q, do = (torch.randn(b, sq, h, d, generator=gen).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, generator=gen).bfloat16()
            for _ in range(2))
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
    want = (ro, rlse, *fa.flash_attention_bwd_reference(
        q, k, v, ro, rlse, do, causal=causal))
    got = run(libs["wait"], q, k, v, do, causal)
    again = run(libs["wait"], q, k, v, do, causal)
    eager = run(libs["eager"], q, k, v, do, causal)
    shares = [share(x, w, LSE_TOL if i == 1 else None)
              for i, (x, w) in enumerate(zip(got, want))]
    same = [all(torch.equal(x, y) for x, y in zip(got, o))
            for o in (again, eager)]
    print(f"B {b}, Sq {sq}, Sk {sk}, H {h}, D {d}, causal {causal}: largest "
          f"share of the limit O {shares[0]:.4f}, lse {shares[1]:.4f}, dQ "
          f"{shares[2]:.4f}, dK {shares[3]:.4f}, dV {shares[4]:.4f}; a second "
          f"call the same bits {same[0]}; TMA landing at once the same "
          f"bits {same[1]}", flush=True)
    return max(shares) <= 1 and all(same)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="+", help="B,Sq,Sk,H,D,causal")
    args = ap.parse_args()
    torch.set_num_threads(1)
    libs = {name: compile_library(build.BUILD_DIR / f"flash_bf16_emu_{name}",
                                  name == "eager")
            for name in ("wait", "eager")}
    ok = []
    for shape in args.shapes:
        b, sq, sk, h, d, causal = map(int, shape.split(","))
        ok.append(case(libs, b, sq, sk, h, d, bool(causal)))
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
