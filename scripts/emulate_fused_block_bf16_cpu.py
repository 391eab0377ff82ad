"""Run the bfloat16 bottleneck-chain kernels of
``paddle_tpu_torch/csrc/fused_block_bf16.cu``, forward and backward, on
the CPU, before any GPU sees them.

``scripts/emulate_fused_lstm_cpu.py``'s harness (every thread of a launch
a fiber of one host thread, yielding at ``__syncthreads`` and at each
warp exchange; ``<<<...>>>`` launches block after block; each block's
dynamic shared memory filled with 0xff bytes, NaN in bf16 and in float32,
so that a read before a store shows), with the source's block of PTX
replaced: ``mma.sync`` m16n8k16 bf16 as
``scripts/emulate_fused_lstm_bf16_cpu.py`` emulates it (PTX's A, B and C
fragment layouts, the 16 products summed in double onto the accumulator
and truncated toward zero), and ``ldmatrix`` x4 (plain and ``.trans``) an
exchange of the warp's row addresses, each lane taking PTX's fragment of
each 8 x 8 matrix; a row address off 16 bytes, or outside the block's
shared memory, is counted, and so is an ``__ldg`` off its type's size.
``csrc/fused_block.cuh`` (the fixed-order passes) is rewritten the same
way. ``csrc/sm90.cuh``'s block of PTX becomes C++ models on the fibers
(the wgmma kernels of ``csrc/abt_bf16_tc.cuh`` and
``csrc/conv1x1_bf16_tc.cuh``): TMA box loads writing the 128-byte swizzle
(a box whose innermost coordinate is off 16 bytes refused), TMA stores
reading it back at the wait that retires their group (or, in a second
build, both landing at once: the same bits), mbarriers, named barriers
and wgmma read through its descriptors; a store never waited for is
counted. Built with ``g++ -std=c++20`` into ``paddle_tpu_torch/_build/``.

The wrappers themselves (``fused_block.conv1x1_stats_bf16``,
``conv3x3_norm_stats_bf16``, ``norm_relu_moments_bf16``,
``conv1x1_bn_residual_bf16``; ``bwd_reduce3_bf16``, ``bwd_apply3_bf16``,
``bwd_mid_bf16``, ``bwd_final_bf16``) are called on CPU tensors under that
script's ``emulated`` (``build.bind`` pointed at the emulation,
``build.sm_count`` at ``--sms``, every output allocated full of NaN), at
each N,Cin,C,H[,W] given, on
the chain's inputs made as it makes them (x >= 0 and He-scaled weights
rounded to bf16; each stage's input the plain version of the stage
before; BN folds from the plain sums; the backward's on one run of the
plain chain's backward from a bf16 cotangent of out and random
cotangents of the six batch statistics). Printed: each y's largest share
of the bf16 limit 2^-7 max|plain| + 2^-7 |plain| against the plain
version and the share of its elements that differ at all; each sum's
largest share of its limit (the float32 order, 1e-5 of the sum of its
terms' magnitudes, plus what the flipped y move: the sum of |y - plain
y|), and its share of the float32 limit alone; whether M2 is exactly symmetric; for the backward, g3 bit for bit,
g2, g1 and dx as y, the sums of g2 and g1 as y's and the products over
N·S (P, Σg3, dW1; dtaps against its float64 product) within STATS_RTOL
of their terms' magnitudes, as ``chip_smoke.bf16_bwd_readings`` holds
them in phase 3;
whether a second call gives the same bits; and the counts of misaligned
or stray accesses. Exits 1 if any check misses.

    python scripts/emulate_fused_block_bf16_cpu.py 2,32,16,8 2,128,64,14 \\
        1,256,64,16 3,128,128,7 2,64,128,6,10 8,128,64,5 2,48,80,9 \\
        1,64,64,3,130 1,512,256,14 2,384,128,8 1,256,80,7
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

import chip_smoke as cs  # noqa: E402
import emulate_fused_lstm_bf16_cpu as lstm_bf16_emu  # noqa: E402
import emulate_fused_lstm_cpu as lstm_emu  # noqa: E402
import emulate_moments_cpu as emu  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_block as fb  # noqa: E402

SOURCE = "fused_block_bf16.cu"
HEADERS = ("fused_block.cuh", "sm90.cuh", "abt_bf16_tc.cuh",
           "conv1x1_bf16_tc.cuh")
BF16_REL = 2.0 ** -7
STATS_RTOL = 1e-5
DASHES = "// " + "-" * 77

# ldmatrix x4: lanes 8 j .. 8 j + 7 give matrix j's rows; lane 4 g + t
# takes row g, elements 2 t and 2 t + 1 of each matrix (with .trans, rows
# 2 t and 2 t + 1 of column g)
LDSM = r"""
inline int emu_outside = 0;
template <bool kTrans>
inline void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  const int lane = threadIdx.x & 31;
  EmuWarp& W = emu_cur->blk->warps[threadIdx.x >> 5];
  const char* lo = reinterpret_cast<const char*>(emu_cur->blk->smem.data());
  const char* at = reinterpret_cast<const char*>(p);
  emu_misaligned += reinterpret_cast<uintptr_t>(p) % 16 != 0;
  emu_outside += at < lo || at + 16 > lo + 4 * emu_cur->blk->smem.size();
  W.p[lane] = p;
  W.bar.arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int j = 0; j < 4; ++j) {
    const uint32_t a = kTrans ? W.p[8 * j + 2 * t][g] : W.p[8 * j + g][2 * t];
    const uint32_t b = kTrans ? W.p[8 * j + 2 * t + 1][g]
                              : W.p[8 * j + g][2 * t + 1];
    r[j] = a | b << 16;
  }
  W.bar.arrive_and_wait();
}
"""

# cvt.rn.bf16x2.f32: each of the pair rounded to nearest, ties to even
CVT = r"""
inline uint32_t cvt_bf2(float lo, float hi) {
  const auto rn = [](float x) {
    const uint32_t u = __float_as_uint(x);
    return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
  };
  return rn(lo) | rn(hi) << 16;
}
"""

# fused_block.cuh's mask rounds its product and its sum (the CUDA
# intrinsics)
ROUNDED = r"""
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
"""

# csrc/sm90.cuh's block of PTX on the fibers: the models of
# scripts/emulate_flash_bf16_cpu.py (TMA box loads writing the 128-byte
# swizzle and landing at the first wait on their mbarrier, or at once with
# EMU_EAGER; mbarrier phases that abort on an extra arrival or on bytes
# not announced; named barriers; wgmma SS and RS read through their
# descriptors and held until the wait_group that retires them, each
# thread's accumulators summed in double), a wait yielding its fiber
# instead of blocking a host thread, and aborting after kSpins turns (a
# deadlock).
SM90_FIBER = r"""// ---- Hopper's asynchronous units (emulated on the fibers)
#include <cstdio>
#include <deque>
#include <map>
typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;
struct CUtensorMap {
  const char* base;
  uint64_t dims[4], strides[4];
  uint32_t box[4];
  bool swizzle;
};
#define __grid_constant__
namespace sm90 {
constexpr long kSpins = 2000000;
[[noreturn]] inline void emu_fail(const char* what) {
  std::fprintf(stderr, "sm90 emulation: %s\n", what);
  std::abort();
}
inline char* emu_window() {
  return reinterpret_cast<char*>(reinterpret_cast<uintptr_t>(emu_dyn_smem) &
                                 ~uintptr_t(1023));
}
inline uint32_t smem_u32(const void* p) {
  return (uint32_t)(static_cast<const char*>(p) - emu_window());
}
inline uint32_t emu_swizzle(uint32_t a) { return a ^ (((a >> 7) & 7) << 4); }

struct EmuBar { uint32_t count, pending; int64_t tx; uint32_t phase; };
inline std::map<std::pair<const void*, uint32_t>, EmuBar> emu_bars;
inline EmuBar& emu_bar(uint32_t bar) {
  auto it = emu_bars.find({emu_cur->blk, bar});
  if (it == emu_bars.end()) emu_fail("an mbarrier used before its init");
  return it->second;
}
inline void emu_bar_step(EmuBar& b) {
  if (b.tx < 0) emu_fail("more bytes landed than were announced");
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1;
    b.pending = b.count;
  }
}
inline void emu_bar_arrival(uint32_t bar, int64_t bytes) {
  EmuBar& b = emu_bar(bar);
  if (b.pending == 0) emu_fail("an arrival beyond the mbarrier's count");
  b.tx += bytes;
  --b.pending;
  emu_bar_step(b);
}
inline void bar_init(uint32_t bar, uint32_t count) {
  emu_bars[{emu_cur->blk, bar}] = {count, count, 0, 0};
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
  EmuNamed& b = emu_named[id];
  const unsigned gen = b.gen;
  if (++b.count == threads) {
    b.count = 0;
    ++b.gen;
  } else if (wait) {
    for (long spins = 0; b.gen == gen; ++spins) {
      if (spins > kSpins) emu_fail("a named barrier that never fills");
      emu_yield();
    }
  }
}
inline void named_sync(int id, int threads) {
  emu_named_arrival(id, threads, true);
}
inline void named_arrive(int id, int threads) {
  emu_named_arrival(id, threads, false);
}

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
          std::memcpy(emu_window() + (map.swizzle ? emu_swizzle(dst + off)
                                                  : dst + off), &v, 2);
        }
  return off;
}
struct EmuTma {
  uint32_t dst;
  CUtensorMap map;
  int c[4];
  uint32_t bar;
  const void* blk;
};
inline std::vector<EmuTma> emu_tma_queue;
inline void emu_tma_land(uint32_t bar) {
  for (size_t i = 0; i < emu_tma_queue.size();) {
    if (emu_tma_queue[i].bar != bar || emu_tma_queue[i].blk != emu_cur->blk) {
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
  if (dst % (map->swizzle ? 1024 : 128))
    emu_fail("a TMA box not on 1024 bytes (swizzled) or 128 (dense)");
  // the card never completes a box whose innermost coordinate is off 16
  // bytes
  if (((c0 % 8) + 8) % 8) emu_fail("a TMA box's innermost coordinate off 16 bytes");
  emu_tma_queue.push_back({dst, *map, {c0, c1, c2, c3}, bar, emu_cur->blk});
#ifdef EMU_EAGER
  emu_tma_land(bar);
#endif
}
// a poll that fails yields the fiber; kSpins failed polls in a row of one
// thread abort (a deadlock)
inline long emu_polls[1024];
inline bool bar_try_wait(uint32_t bar, uint32_t parity) {
  emu_tma_land(bar);
  if (emu_bar(bar).phase != parity) {
    emu_polls[threadIdx.x] = 0;
    return true;
  }
  if (++emu_polls[threadIdx.x] > kSpins)
    emu_fail("an mbarrier phase that never ends");
  emu_yield();
  return false;
}
inline void bar_wait(uint32_t bar, uint32_t parity) {
  while (!bar_try_wait(bar, parity)) {
  }
}
// TMA stores: a thread's stores since its last commit are a group; a
// group reads its box from shared memory (through the swizzle) and writes
// it to its coordinates, those past a dimension's end not written, at the
// wait that retires it, or at once with EMU_EAGER: a tile changed after
// the store, or not yet written when it is issued, gives other bits in one
// of the two builds
struct EmuStore {
  CUtensorMap map;
  uint32_t src;
  int c[4];
};
struct EmuStores {
  std::vector<EmuStore> open;
  std::deque<std::vector<EmuStore>> groups;
};
inline std::map<std::pair<const void*, int>, EmuStores> emu_stores;
inline EmuStores& emu_my_stores() {
  return emu_stores[{emu_cur->blk, (int)threadIdx.x}];
}
inline void emu_store_copy(const EmuStore& op) {
  const uint32_t* box = op.map.box;
  uint32_t off = 0;
  for (uint32_t i3 = 0; i3 < box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < box[1]; ++i1)
        for (uint32_t i0 = 0; i0 < box[0]; ++i0, off += 2) {
          const int64_t x[4] = {op.c[0] + (int64_t)i0, op.c[1] + (int64_t)i1,
                                op.c[2] + (int64_t)i2, op.c[3] + (int64_t)i3};
          bool in = true;
          int64_t dst = 0;
          for (int d = 0; d < 4; ++d) {
            in = in && x[d] >= 0 && x[d] < (int64_t)op.map.dims[d];
            dst += x[d] * (int64_t)op.map.strides[d];
          }
          const uint32_t a = op.src + off;
          if (in)
            std::memcpy(const_cast<char*>(op.map.base) + dst,
                        emu_window() + (op.map.swizzle ? emu_swizzle(a) : a),
                        2);
        }
}
inline void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                         int c1, int c2, int c3) {
  if (src % (map->swizzle ? 1024 : 128))
    emu_fail("a TMA store not on 1024 bytes (swizzled) or 128 (dense)");
  if (((c0 % 8) + 8) % 8)
    emu_fail("a TMA store's innermost coordinate off 16 bytes");
  EmuStore op{*map, src, {c0, c1, c2, c3}};
#ifdef EMU_EAGER
  emu_store_copy(op);
  op.map.box[0] = 0;  // done: its wait copies nothing
#endif
  emu_my_stores().open.push_back(op);
}
inline void bulk_commit() {
  EmuStores& s = emu_my_stores();
  s.groups.push_back(std::move(s.open));
  s.open.clear();
}
inline void bulk_wait_read() {
  EmuStores& s = emu_my_stores();
  if (!s.open.empty()) emu_fail("a TMA store waited for before its commit");
  for (const auto& group : s.groups)
    for (const EmuStore& op : group) emu_store_copy(op);
  s.groups.clear();
}

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
struct EmuWgState {
  std::vector<EmuWgOp> open;
  std::deque<std::vector<EmuWgOp>> groups;
  uint32_t seq = 0;
};
inline EmuWgState emu_wg[1024];
// each warpgroup's A registers of its last 256 RS products
inline uint32_t emu_wg_a[8][256][128][4];
inline void wg_fence() {}
inline void wg_commit() {
  EmuWgState& s = emu_wg[threadIdx.x];
  s.groups.push_back(std::move(s.open));
  s.open.clear();
}
inline float emu_bf16_value(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}
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
inline float emu_rs_a(int wg, uint32_t slot, int row, int k) {
  const int holder = 32 * (row / 16) + 4 * (row % 8) + (k % 8) / 2;
  const int reg = (row % 16) / 8 + 2 * (k / 8);
  return emu_bf16_value(
      (uint16_t)(emu_wg_a[wg][slot][holder][reg] >> (16 * (k & 1))));
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
  // every thread of the warpgroup has started its products (and left its
  // A registers)
  named_sync(100 + threadIdx.x / 128, 128);
  EmuWgState& s = emu_wg[threadIdx.x];
  while (s.groups.size() > (size_t)N) {
    for (const EmuWgOp& op : s.groups.front()) emu_wg_eval(op);
    s.groups.pop_front();
  }
}
template <int N>
inline void fence_operands(float (&)[N]) {}
inline void fence_operands(uint32_t (&)[4]) {}
template <int N, int TB>
inline void emu_wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  emu_wg[threadIdx.x].open.push_back({d, N, TB, accumulate, false, da, db, 0});
}
template <int TB>
inline void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  emu_wgmma_ss<32, TB>(d, da, db, acc);
}
template <int TB>
inline void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  emu_wgmma_ss<64, TB>(d, da, db, acc);
}
template <int TB>
inline void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  emu_wgmma_ss<128, TB>(d, da, db, acc);
}
template <int TB>
inline void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  emu_wgmma_ss<256, TB>(d, da, db, acc);
}
template <int N, int TB>
inline void emu_wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db,
                         int accumulate) {
  EmuWgState& s = emu_wg[threadIdx.x];
  const uint32_t slot = s.seq++ % 256;
  for (int r = 0; r < 4; ++r)
    emu_wg_a[threadIdx.x / 128][slot][threadIdx.x % 128][r] = a[r];
  s.open.push_back({d, N, TB, accumulate, true, 0, db, slot});
}
template <int TB>
inline void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                         int acc) {
  emu_wgmma_rs<32, TB>(d, a, db, acc);
}
template <int TB>
inline void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                         int acc) {
  emu_wgmma_rs<64, TB>(d, a, db, acc);
}
template <int TB>
inline void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                          int acc) {
  emu_wgmma_rs<128, TB>(d, a, db, acc);
}
template <int TB>
inline void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                          uint64_t db, int acc) {
  emu_wgmma_rs<256, TB>(d, a, db, acc);
}

inline int encode_4d(CUtensorMap* map, const void* base,
                     const cuuint64_t (&dims)[4],
                     const cuuint64_t (&strides)[3],
                     const cuuint32_t (&box)[4], bool swizzle = true) {
  for (int d = 0; d < 3; ++d)
    if (strides[d] % 16) return 1;  // as cuTensorMapEncodeTiled does
  if (reinterpret_cast<uintptr_t>(base) % 16 || (box[0] * 2) % 16 ||
      (swizzle && box[0] * 2 > 128))
    return 1;
  *map = {static_cast<const char*>(base),
          {dims[0], dims[1], dims[2], dims[3]},
          {2, strides[0], strides[1], strides[2]},
          {box[0], box[1], box[2], box[3]},
          swizzle};
  return 0;
}

}  // namespace sm90
"""

UNIT = r"""
#include "fused_block_bf16.cu"
extern "C" int emu_take_outside() {
  const int n = emu_outside;
  emu_outside = 0;
  return n;
}
// TMA stores never waited for (their tile's shared memory may be gone)
extern "C" int emu_take_unwaited() {
  int n = 0;
  for (const auto& kv : sm90::emu_stores)
    n += (int)(kv.second.open.size() + kv.second.groups.size());
  sm90::emu_stores.clear();
  return n;
}
"""


def rewrite(name: str) -> str:
    text = (build.CSRC / name).read_text()
    text = text.replace("#include <cuda_runtime.h>\n",
                        '#include "cuda_emu.h"\n')
    blocks = {SOURCE: ("// ---- bf16 tensor-core product and its fragment",
                       lstm_bf16_emu.MMA + LDSM + CVT),
              "sm90.cuh": ("// ---- Hopper's asynchronous units", SM90_FIBER)}
    if name in blocks:
        start, helpers = blocks[name]
        a = text.index(start)
        b = text.index(DASHES, a)
        text = text[:a] + helpers + text[b:]
    text = text.replace(
        "extern __shared__ float4 smem4[];",
        "float4* smem4 = reinterpret_cast<float4*>(emu_dyn_smem);")
    text = emu.LAUNCH.sub(emu._launch, text)
    if "asm" in re.sub(r"//.*", "", text) or "<<<" in text:
        raise RuntimeError(f"{name}: a launch or inline assembly is left")
    return text


def emu_header() -> str:
    h = lstm_emu.EMU_H + lstm_bf16_emu.VECTORS + ROUNDED
    for old, new in (
            ("  float c[32][4];\n",
             "  float c[32][4];\n  const uint16_t* p[32];\n"),
            ("template <class T> inline T __ldg(const T* p) { return *p; }",
             "extern int emu_misaligned;\n"
             "template <class T> inline T __ldg(const T* p) {\n"
             "  emu_misaligned += reinterpret_cast<uintptr_t>(p) % sizeof(T)"
             " != 0;\n  return *p;\n}")):
        if old not in h:
            raise RuntimeError(f"the harness has no {old!r}")
        h = h.replace(old, new)
    return h


def compile_library(out: Path, eager: bool = False) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    for name in HEADERS + (SOURCE,):
        (out / name).write_text(rewrite(name))
    (out / "cuda_emu.h").write_text(emu_header())
    rt = lstm_emu.EMU_RT.replace(
        "std::numeric_limits<float>::quiet_NaN()",
        "__uint_as_float(0xffffffffu)")
    if rt == lstm_emu.EMU_RT:
        raise RuntimeError("the shared-memory fill was not found")
    (out / "emu_rt.cpp").write_text(rt)
    (out / "unit.cpp").write_text(UNIT)
    lib = out / "fused_block_bf16_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-ffp-contract=off", "-include", "cuda_emu.h",
                    *(["-DEMU_EAGER"] if eager else []), "-o", str(lib),
                    "unit.cpp", "emu_rt.cpp"], cwd=out, check=True)
    return ctypes.CDLL(str(lib))


def chain_inputs(n, cin, c, h, w, seed):
    """The chain's inputs in bf16 (a block input >= 0, He-scaled weights)
    and its float32 BN parameters, from a seed."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    bf = torch.bfloat16
    return dict(x=torch.rand(n, cin, h * w, generator=gen).to(bf),
                w1=(randn(c, cin) * (2 / cin) ** 0.5).to(bf),
                taps=(randn(9, c, c) * (2 / (9 * c)) ** 0.5).to(bf),
                w3=(randn(cin, c) * (2 / c) ** 0.5).to(bf),
                gam=[1 + 0.2 * randn(k) for k in (c, c, cin)],
                bet=[0.2 * randn(k) for k in (c, c, cin)])


def y_share(got, want):
    """(largest share of the bf16 limit, share of elements that differ)."""
    got, want = got.float(), want.float()
    lim = BF16_REL * want.abs().max() + BF16_REL * want.abs()
    return (float(((got - want).abs() / lim.clamp_min(1e-30)).max()),
            float((got != want).float().mean()))


def sum_share(got, want, terms, moved=0.0):
    """Largest share of a sum's limit STATS_RTOL Σ|terms| + moved."""
    lim = STATS_RTOL * terms + moved
    return float(((got - want).abs() / lim.clamp_min(1e-30)).max())


BWD = ("bwd_reduce3", "bwd_apply3", "bwd_mid", "bwd_final")


def bwd_case(lib, sms, d, h, seed, eager=None):
    """The four bf16 backward kernels against their plain versions, on the
    inputs of one run of the plain chain's backward from a bf16
    cotangent of out and random cotangents of the six batch statistics
    (chip_smoke.chain_bwd_inputs), at phase 3's limits
    (chip_smoke.bf16_bwd_readings): (ok, [notes], [same bits]); with
    `eager` (the library whose TMA loads land at once), bwd_reduce3 and
    bwd_mid (the wgmma products) run there too, for the same bits."""
    gen = torch.Generator().manual_seed(seed + 1000)
    n, cin, s = d["x"].shape
    c = d["w1"].shape[0]
    dout = torch.randn(n, cin, s, generator=gen).to(torch.bfloat16)
    cots = [0.1 * torch.randn(k, generator=gen)
            for k in (c, c, c, c, cin, cin)]
    args = cs.chain_bwd_inputs(torch, fb, d, dout, h, "_bf16", cots)
    notes, ok, same = [], True, []
    for name in BWD:
        fn = getattr(fb, name + "_bf16")
        with lstm_emu.emulated(lib, sms):
            got = fn(*args[name])
            again = fn(*args[name])
        same.append(all(torch.equal(a, b) for a, b in zip(got, again)))
        if eager is not None and name in ("bwd_reduce3", "bwd_mid",
                                          "bwd_final"):
            with lstm_emu.emulated(eager, sms):
                landed = fn(*args[name])
            same.append(all(torch.equal(a, b) for a, b in zip(got, landed)))
        want = getattr(fb, name + "_reference")(*args[name])
        for what, (share, differ) in cs.bf16_bwd_readings(
                torch, fb, name, args[name], got, want).items():
            notes.append(f"{what} {share:.4f}" + (
                "" if differ is None else f" (differ {differ:.5f})"))
            ok = ok and share <= 1
    return ok, notes, same


def case(lib, sms, n, cin, c, h, w, seed, eager=None):
    d = chain_inputs(n, cin, c, h, w, seed)
    x, w1, taps, w3 = d["x"], d["w1"], d["taps"], d["w3"]
    m = n * h * w
    out, ok = [], True

    def run(fn, *args):
        with lstm_emu.emulated(lib, sms):
            first = fn(*args)
            again = fn(*args)
        same = all(torch.equal(a, b) for a, b in zip(first, again)) \
            if isinstance(first, tuple) else torch.equal(first, again)
        return first, same

    def stage_y(name, y, ry, s, q, rs, rq):
        nonlocal ok
        share, differ = y_share(y, ry)
        moved = (y.float() - ry.float()).abs()
        yf = ry.float()
        ss = sum_share(s, rs, yf.abs().sum(dim=(0, 2)), moved.sum(dim=(0, 2)))
        sq = sum_share(q, rq, (yf * yf).sum(dim=(0, 2)),
                       (moved * (y.float().abs() + yf.abs())).sum(dim=(0, 2)))
        alone = max(sum_share(s, rs, yf.abs().sum(dim=(0, 2))),
                    sum_share(q, rq, (yf * yf).sum(dim=(0, 2))))
        out.append(f"{name} y {share:.4f} (differ {differ:.5f}), Σ {ss:.4f}, "
                   f"Σ² {sq:.4f} (of the float32 limit alone {alone:.4f})")
        ok = ok and share <= 1 and ss <= 1 and sq <= 1 \
            and bool(torch.isfinite(y.float()).all())

    (y1, s1, q1), same1 = run(fb.conv1x1_stats_bf16, x, w1)
    ry1, rs1, rq1 = fb.conv1x1_stats_reference(x, w1)
    stage_y("conv1x1_stats", y1, ry1, s1, q1, rs1, rq1)
    _, _, sc1, sh1 = fb._bn_fold(rs1, rq1, m, d["gam"][0], d["bet"][0])
    (y2, s2, q2), same2 = run(fb.conv3x3_norm_stats_bf16, ry1, taps, sc1,
                              sh1, h)
    ry2, rs2, rq2 = fb.conv3x3_norm_stats_reference(ry1, taps, sc1, sh1, h)
    stage_y("conv3x3_norm_stats", y2, ry2, s2, q2, rs2, rq2)
    _, _, sc2, sh2 = fb._bn_fold(rs2, rq2, m, d["gam"][1], d["bet"][1])
    (sum_h, m2h), same3 = run(fb.norm_relu_moments_bf16, ry2, sc2, sh2)
    rsum_h, rm2h = fb.norm_relu_moments_reference(ry2, sc2, sh2)
    # h >= 0: Σh and M2 are their terms' magnitudes summed
    sh_share = sum_share(sum_h, rsum_h, rsum_h)
    m2_share = sum_share(m2h, rm2h, rm2h)
    sym = torch.equal(m2h, m2h.T)
    out.append(f"norm_relu_moments Σh {sh_share:.4f}, M2 {m2_share:.4f}, "
               f"symmetric {sym}")
    ok = ok and sh_share <= 1 and m2_share <= 1 and sym
    _, _, sc3, sh3 = fb._bn3_fold(w3, rsum_h, rm2h, m, d["gam"][2],
                                  d["bet"][2])
    args = (ry2, x, sc2, sh2, w3, sc3, sh3)
    y4, same4 = run(fb.conv1x1_bn_residual_bf16, *args)
    if eager is not None:
        with lstm_emu.emulated(eager, sms):
            same4 = same4 and torch.equal(
                y4, fb.conv1x1_bn_residual_bf16(*args))
    share, differ = y_share(y4, fb.conv1x1_bn_residual_reference(*args))
    out.append(f"conv1x1_bn_residual out {share:.4f} (differ {differ:.5f})")
    ok = ok and share <= 1 and bool(torch.isfinite(y4.float()).all())
    same = [same1, same2, same3, same4]
    bok, bnotes, bsame = bwd_case(lib, sms, d, h, seed, eager)
    ok = ok and bok
    out.append("backward " + ", ".join(bnotes))
    same += bsame
    misaligned = sum(x.emu_take_misaligned() for x in (lib, eager) if x)
    outside = sum(x.emu_take_outside() for x in (lib, eager) if x)
    unwaited = sum(x.emu_take_unwaited() for x in (lib, eager) if x)
    print(f"N {n}, Cin {cin}, C {c}, {h}x{w}: " + "; ".join(out)
          + f"; a second call (and the wgmma kernels with TMA landing and "
          f"storing at once) the same bits {same}; misaligned accesses "
          f"{misaligned}; ldmatrix rows outside shared memory {outside}; "
          f"TMA stores not waited for {unwaited}", flush=True)
    return (ok and all(same) and not misaligned and not outside
            and not unwaited)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="+", help="N,Cin,C,H[,W]")
    ap.add_argument("--sms", type=int, default=132)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(1)
    lib = compile_library(build.BUILD_DIR / "fused_block_bf16_emu")
    eager = compile_library(build.BUILD_DIR / "fused_block_bf16_emu_eager",
                            eager=True)
    ok = []
    for i, shape in enumerate(args.shapes):
        dims = [int(v) for v in shape.split(",")]
        n, cin, c, h = dims[:4]
        w = dims[4] if len(dims) > 4 else h
        ok.append(case(lib, args.sms, n, cin, c, h, w, args.seed + i, eager))
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
