// Whole-sequence LSTM kernels for Hopper (sm_90a), bfloat16 inputs
// (mixed-precision training).
//
// Replace the TPU kernels of paddle_tpu/kernels/fused_lstm.py as they run on
// bf16 tiles (bench.py's LSTM trains under amp_dtype "bfloat16"):
//   lstm_seq_fwd (_fwd_kernel): gates = x_t + r_{t-1} W + b in float32 (the
//     bf16 products exact, summed in float32), the cell in float32, and both
//     carries rounded to bf16 once a step, after the mask blend
//     (r_t = bf16(m r' + (1 - m) r), c_t the same); rs, cs bf16 [T, B, H];
//   lstm_seq_bwd (_bwd_kernel): the gates recomputed in float32 from the
//     bf16 r_{t-1} and W; dr and dc carried in float32; dgates rounded to
//     bf16 before it is written as dx and before both products (dgates W^T
//     into dr, r_{t-1}^T dgates into dW); db sums the unrounded float32
//     dgates; dW, db, dr0 and dc0 float32.
// Gate order i, c, f, o; rows past a sequence's length carry their state.
//
// What bounds them on the H100: on paper the operations, the forward
// barely. At the bench shape (T 100, B 64, H 512) the forward does 13.4
// GFLOP of bf16 products (0.0136 ms at 989 TFLOP/s) and moves ~42 MB
// (0.012 ms); the backward 40.3 GFLOP (0.041 ms) and ~85 MB (0.025 ms).
// In practice, as for the float32 kernels (csrc/fused_lstm.cu), the
// recurrence bounds them: step t needs all of r_{t-1} (the backward: all
// of dgates_{t+1}), so the time is per-step latency: a grid barrier, the
// loads of the step's operand from L2, a short product and the cell.
//
// What the design does about it: csrc/fused_lstm.cu's structure, with bf16
// mma.sync.m16n8k16 (float32 accumulators) in place of its 3xTF32 split.
//   Forward (lstm_fwd_seq_bf16_kernel): one cooperative launch a sequence.
//   A block owns 8 hidden units, all four gate columns of each (32
//   columns), and holds its [H, 32] slice of W for all T steps as raw B
//   fragments (32 registers a thread at H 512, half the float32 kernel's).
//   The batch is cut into row tiles of 16 mt <= 32 rows; a block takes its
//   tiles one after another each step. A tile: each of the 8 warps copies
//   its rows x 16 kb-deep K slice of r_{t-1} (bf16: half the float32
//   kernel's bytes) from L2 (cp.async.cg, one group a k16 block) and
//   multiplies each k16 block as it lands; the 8 warps' partial sums go to
//   shared memory and each (row, unit) thread adds them in warp order, then
//   (x + sum) + b as the Pallas kernel adds them, the cell, and the two
//   carries rounded to bf16. The carries stay in shared memory from step to
//   step as their ROUNDED values (the Pallas kernel's bf16 scratch), so
//   every step reads what the plain version reads. Grid barrier: a counter
//   of the stream (one thread a block arrives by a release add, leaves by
//   an ld.acquire.gpu spin; the last block out sets it back to 0).
//   Backward (lstm_seq_bwd_seq_bf16): three launches. (1) The gates of
//   every step at once, G = X + R_prev W + b, float32, and (3) dW =
//   R_prev^T dx over the T*B rows: bf16 products (lstm_bwd_gemm_bf16_kernel:
//   64 x 128 tiles, K in 16-deep stages through a ring of 3 of cp.async, k
//   in order). (2) The reverse recurrence in one cooperative launch
//   (lstm_bwd_seq_bf16_kernel): a block owns 16 units and holds W^T's
//   [4H, 16] slice as bf16 B fragments in shared memory (64 KB at H 512);
//   each step every block reads its row tile's bf16 dgates_{t+1} back from
//   dx (the rounded values, which are the product's operand) through a
//   ring of 4 k16 stages, each warp a 4H/8-deep K slice in two mma chains
//   (even and odd k16 blocks, added at the end); the warps' partial sums are
//   added in warp order by one thread a cell, whose carried (dr, dc) stay in
//   shared memory in float32. db is summed from the float32 dgates in the
//   launch (a cell thread over t, the block over its rows, row group 0 over
//   the row groups, in that fixed order), never from dx; dr0 is a product
//   after the last barrier.
// Every sum runs in a fixed order and no float atomics: two calls give the
// same bits. Inputs are contiguous and 16-byte aligned, H a multiple of 8
// (rows of 16 bytes) and at most 512; the wrappers refuse anything else
// (there is no per-step bf16 path). Transcendentals are expf/tanhf.
#include <cstdint>

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;

typedef uint16_t bf16;  // the bits of one bfloat16

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// bf16 bits -> float, float -> bf16 bits rounded to nearest, ties to even
// (finite values), by integer ops on the bits
__device__ __forceinline__ float bf(bf16 h) {
  return __uint_as_float((uint32_t)h << 16);
}
__device__ __forceinline__ bf16 to_bf(float x) {
  const uint32_t u = __float_as_uint(x);
  return (bf16)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}
// two bf16 in one register, lo in the low half (the lower k)
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)lo | (uint32_t)hi << 16;
}

// ---- bf16 tensor-core product -----------------------------------------------
// d += a b over one m16n8k16 tile: a (16 x 16, row) and b (16 x 8, col)
// bf16, float32 accumulators. Within each k16 block the k order is permuted
// (slot 2 t + e <- element 4 t + e, slot 2 t + 8 + e <- 4 t + 2 + e), so
// that a lane's A values of a row are 4 consecutive bf16, one 8-byte read.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// -----------------------------------------------------------------------------

// A 16-byte copy of 8 bf16 (cp.async.cg: L2, never the non-coherent path,
// since rs and dx are written within the launches that read them)
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, bool ok) {
  copy16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src),
         ok);
}

// The A fragment of a k16 block from a lane's 8-byte reads of rows g and
// g + 8 (lo, hi): k 4 tq .. 4 tq + 3 of each.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* lo,
                                       const bf16* hi) {
  const uint2 l = *reinterpret_cast<const uint2*>(lo);
  const uint2 h = *reinterpret_cast<const uint2*>(hi);
  a[0] = l.x;
  a[1] = h.x;
  a[2] = l.y;
  a[3] = h.y;
}

namespace seq {

constexpr int kWarps = kThreads / 32;
constexpr int kMaxKB = 4;  // k16 blocks of a warp's K slice: H <= 512
// 8 units a block (32 columns, 4 n8 tiles) over row tiles of at most
// 16 kMaxMT rows, at most kMaxNT a block a step (csrc/fused_lstm.cu's
// block, measured against 4 and 16 units: PERF.md §6)
constexpr int kUnits = 8, kN = 4 * kUnits, kNT = kN / 8, kMaxMT = 2;
constexpr int kMaxNT = 64;
// a spin at the grid barrier longer than this traps (a fault, not a hang)
constexpr unsigned long long kSpinLimitNs = 5000000000ull;

// bf16 between two rows of a warp's r slice (16 kb deep): 32 bytes mod 128
// (or 96), so that the 8-byte fragment reads of 4 rows fall on 32 banks.
__host__ __device__ constexpr int row_stride(int kb) {
  return 16 * (kb + 1 - kb % 2);
}
// Floats of a warp's region: its r slice (bf16), later its [rows][N + 8]
// float partials.
__host__ __device__ constexpr int region(int mt, int kb) {
  return 16 * mt * (row_stride(kb) / 2 > kN + 8 ? row_stride(kb) / 2 : kN + 8);
}
// the warps' regions, then c and r of each thread's cell in each of nt
// row tiles (float32 copies of the bf16 carries)
constexpr int smem_bytes(int mt, int kb, int nt) {
  return (kWarps * region(mt, kb) + 2 * nt * kThreads) * 4;
}

// ---- grid barrier ----------------------------------------------------------
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// One thread of each block, between two __syncthreads: its release add
// makes every write of the block before the first one visible to the
// grid before the count moves; its acquire spin waits until `target`
// blocks have arrived (the pattern of CUTLASS's GenericBarrier).
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned target) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count)
               : "memory");
  const unsigned long long t0 = clock_ns();
  while (load_acquire(count) < target)
    if (clock_ns() - t0 > kSpinLimitNs) __trap();
}
// -----------------------------------------------------------------------------

// At a launch's end: the last block out sets the counters back to 0
// (bar[1] counts the blocks out; every block has passed every barrier by
// then).
__device__ __forceinline__ void grid_done(unsigned* bar, unsigned blocks) {
  if (threadIdx.x == 0 && atomicAdd(bar + 1, 1u) == blocks - 1) {
    bar[0] = 0u;
    bar[1] = 0u;
  }
}

// Wait until at most n of this thread's groups of copies are in flight.
__device__ __forceinline__ void wait_left(int n) {
  switch (n) {
    case 0: wait_prior<0>(); break;
    case 1: wait_prior<1>(); break;
    case 2: wait_prior<2>(); break;
    default: wait_prior<3>(); break;
  }
}

// A warp's rows x [k0, k0 + 16 kb) slice of r_{t-1} into its region, one
// group of 16-byte copies a k16 block; rows past B and k past H are zero
// (H % 8 == 0: a chunk is all in or all out).
__device__ __forceinline__ void load_r(bf16* mine, const bf16* rp, int row0,
                                       int rows, int B, int H, int k0, int kb,
                                       int stride, int lane) {
#pragma unroll
  for (int q = 0; q < kMaxKB; ++q) {
    if (q >= kb) break;
    for (int e = lane; e < rows * 2; e += 32) {
      const int rr = e / 2, kk = 16 * q + 8 * (e % 2);
      const int b = row0 + rr, k = k0 + kk;
      const bool ok = b < B && k < H;
      copy8(mine + rr * stride + kk, ok ? rp + (long)b * H + k : rp, ok);
    }
    commit();
  }
}

// acc[i][j] += the warp's rows x its K slice of r times W's slice: each
// k16 block as its copies land.
__device__ __forceinline__ void product(float (&acc)[kMaxMT][kNT][4],
                                        const bf16* mine,
                                        const uint32_t (&wf)[kMaxKB][kNT][2],
                                        int mt, int kb, int stride, int g,
                                        int tq) {
#pragma unroll
  for (int q = 0; q < kMaxKB; ++q) {
    if (q >= kb) break;
    wait_left(kb - 1 - q);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kMaxMT; ++i) {
      if (i >= mt) break;
      const bf16* p = mine + (16 * i + g) * stride + 16 * q + 4 * tq;
      uint32_t a[4];
      a_frag(a, p, p + 8 * stride);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mma_bf16(acc[i][j], a, wf[q][j][0], wf[q][j][1]);
    }
  }
}

// The step-t x (gates i, c, f, o) and mask of the cell (b, u).
__device__ __forceinline__ void load_x(float (&xg)[4], float& m, const bf16* x,
                                       const bf16* mask, int t, int b, int B,
                                       int H, int u) {
  const long row = (long)t * B + b;
  m = bf(mask[row]);
#pragma unroll
  for (int q = 0; q < 4; ++q) xg[q] = bf(x[row * 4 * H + q * H + u]);
}

// The whole sequence. blockIdx.x takes units [U x, U x + U); blockIdx.y
// the row tiles y, y + gridDim.y, ... (at most nt, each 16 mt rows), one
// after another each step; warp w the K slice [16 kb w, 16 kb w + 16 kb);
// thread (row, unit) = (tid / U, tid % U) one cell of each tile, whose
// rounded c and r stay in shared memory from step to step. The block's
// gate columns interleave: column 4 j + q is gate q of unit u0 + j. bar[0]
// counts arrivals at the grid barrier, bar[1] blocks done; both start and
// end at 0.
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_seq_bf16_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w,
                         const bf16* __restrict__ bias,
                         const bf16* __restrict__ mask,
                         const bf16* __restrict__ r0,
                         const bf16* __restrict__ c0, bf16* rs,
                         bf16* __restrict__ cs, unsigned* bar, int T, int B,
                         int H, int mt, int kb, int nt) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int u0 = blockIdx.x * kUnits;
  const int rows = 16 * mt;
  const int stride = row_stride(kb), pn = kN + 8;
  const int reg = region(mt, kb);
  float* const part = smem + warp * reg;
  bf16* const mine = reinterpret_cast<bf16*>(part);
  float* const cst = smem + kWarps * reg + threadIdx.x;
  float* const rst = cst + nt * kThreads;
  const int k0 = warp * 16 * kb;
  // warps whose K slice starts past H add nothing: they sit the steps out
  const int kwarps = min(kWarps, (H + 16 * kb - 1) / (16 * kb));
  const bool busy = warp < kwarps;
  // the block's row tiles: blockIdx.y + l gridDim.y for l < tiles
  const int tiles = ((B + rows - 1) / rows - (int)blockIdx.y +
                     (int)gridDim.y - 1) / (int)gridDim.y;
  const long bh = (long)B * H;
  const unsigned blocks = gridDim.x * gridDim.y;

  // W's slice as B fragments, for all T steps: register e of k16 block q
  // holds k = k0 + 16 q + 4 tq + 2 e and k + 1 (the A fragments' k order);
  // column 8 j + g is gate col % 4 of unit u0 + col / 4, so that a cell's
  // four gates are adjacent
  uint32_t wf[kMaxKB][kNT][2];
#pragma unroll
  for (int q = 0; q < kMaxKB; ++q) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = 8 * j + g, u = u0 + col / 4;
      const bf16* wc = w + (long)(col % 4) * H + u;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = k0 + 16 * q + 4 * tq + 2 * e;
        const bool ok = q < kb && u < H && k < H;  // H % 8 == 0: k + 1 too
        wf[q][j][e] = ok ? pack(__ldg(wc + (long)k * 4 * H),
                                __ldg(wc + (long)(k + 1) * 4 * H))
                         : 0u;
      }
    }
  }

  // the thread's cells: row cr of each tile, unit u; their state, the
  // bias and the x and mask of the cell next in turn
  const int cr = threadIdx.x / kUnits, u = u0 + threadIdx.x % kUnits;
  const bool col_ok = cr < rows && u < H;
  float bg[4] = {0.f, 0.f, 0.f, 0.f};
  float m = 0.f, xg[4] = {0.f, 0.f, 0.f, 0.f};
  for (int l = 0; l < tiles; ++l) {
    const int b = (blockIdx.y + l * gridDim.y) * rows + cr;
    const bool cell = col_ok && b < B;
    cst[l * kThreads] = cell ? bf(c0[(long)b * H + u]) : 0.f;
    rst[l * kThreads] = cell ? bf(r0[(long)b * H + u]) : 0.f;
  }
  if (col_ok) {
#pragma unroll
    for (int q = 0; q < 4; ++q) bg[q] = bf(bias[q * H + u]);
    if (blockIdx.y * rows + cr < B)
      load_x(xg, m, x, mask, 0, blockIdx.y * rows + cr, B, H, u);
  }

  for (int t = 0; t < T; ++t) {
    const bf16* rp = t == 0 ? r0 : rs + (t - 1) * bh;
    for (int l = 0; l < tiles; ++l) {
      const int row0 = (blockIdx.y + l * gridDim.y) * rows;
      float acc[kMaxMT][kNT][4];
#pragma unroll
      for (int i = 0; i < kMaxMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      if (busy) {
        load_r(mine, rp, row0, rows, B, H, k0, kb, stride, lane);
        product(acc, mine, wf, mt, kb, stride, g, tq);
        wait_prior<0>();
        __syncwarp();
        // the warp's partial sums over the r slice it no longer reads
#pragma unroll
        for (int i = 0; i < kMaxMT; ++i) {
          if (i >= mt) break;
          float* p = part + (16 * i + g) * pn + 2 * tq;
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            *reinterpret_cast<float2*>(p + 8 * j) =
                make_float2(acc[i][j][0], acc[i][j][1]);
            *reinterpret_cast<float2*>(p + 8 * pn + 8 * j) =
                make_float2(acc[i][j][2], acc[i][j][3]);
          }
        }
      }
      __syncthreads();
      const int b = row0 + cr;
      if (col_ok && b < B) {
        // the partial sums in warp order, then (x + acc) + b as the Pallas
        // kernel adds them
        const float* p = smem + cr * pn + 4 * (threadIdx.x % kUnits);
        float4 a = *reinterpret_cast<const float4*>(p);
        for (int v = 1; v < kwarps; ++v) {
          const float4 e = *reinterpret_cast<const float4*>(p + v * reg);
          a = make_float4(a.x + e.x, a.y + e.y, a.z + e.z, a.w + e.w);
        }
        const float gs[4] = {(xg[0] + a.x) + bg[0], (xg[1] + a.y) + bg[1],
                             (xg[2] + a.z) + bg[2], (xg[3] + a.w) + bg[3]};
        const float i = sigmoid(gs[0]), f = sigmoid(gs[2]);
        const float o = sigmoid(gs[3]), cand = tanhf(gs[1]);
        const float c = cst[l * kThreads], r = rst[l * kThreads];
        const float c_new = f * c + i * cand;
        const float r_new = o * tanhf(c_new);
        // both carries rounded to bf16 once, after the mask blend
        const bf16 r_t = to_bf(m * r_new + (1.f - m) * r);
        const bf16 c_t = to_bf(m * c_new + (1.f - m) * c);
        rst[l * kThreads] = bf(r_t);
        cst[l * kThreads] = bf(c_t);
        rs[t * bh + (long)b * H + u] = r_t;
        cs[t * bh + (long)b * H + u] = c_t;
      }
      // the x and mask of the cell next in turn (the next tile, or the
      // first of the next step) are on their way during the next tile's
      // product or the grid barrier
      const bool last = l + 1 == tiles;
      const int nb = last ? blockIdx.y * rows + cr : row0 + gridDim.y * rows
                                                         + cr;
      if (col_ok && nb < B && (!last || t + 1 < T))
        load_x(xg, m, x, mask, last ? t + 1 : t, nb, B, H, u);
      // the partials are read before the next tile's copies land on them
      __syncthreads();
    }
    if (t + 1 < T) {
      if (threadIdx.x == 0) grid_sync(bar, (t + 1) * blocks);
      __syncthreads();
    }
  }
  grid_done(bar, blocks);
}

// ---------------------------------------------------------------------------
// backward: one persistent launch over the reverse recurrence
// ---------------------------------------------------------------------------

// A block owns kUnitsB hidden units (two n8 tiles) over row tiles of 16
// rows, at most kMaxNTB of them a step; a warp's K slice of 4H is at most
// kMaxKBB k16 blocks (8 warps: H <= 512), streamed through a ring of kRing
// k16 stages (csrc/fused_lstm.cu's block and ring).
constexpr int kUnitsB = 16, kMaxKBB = 16, kRing = 4, kMaxNTB = 28;
constexpr int kStage = 16 * 16;       // bf16 of a stage: 16 rows x k16
constexpr int kPartB = 16 * kUnitsB;  // floats of a warp's partial sums
// W's fragments (a uint4 a lane a k16 block of its warp's slice), the
// warps' rings (bf16) and partial sums, then dr and dc of each thread's
// cell in each of nt row tiles
constexpr int bwd_smem_bytes(int kb, int nt) {
  return kWarps * kb * 32 * 16 + kWarps * (kRing * kStage * 2 + kPartB * 4) +
         2 * nt * kThreads * 4;
}

// acc[j] += the warp's 16 rows x [k0, k0 + 16 kb) slice of dgates (bf16
// rows of K = 4H) times W's slice B(k, n) = W[u0 + n, k] (n8 tile j). The
// slice streams through a ring of kRing k16 stages, kRing - 1 ahead of the
// product, one 16-byte copy a lane a stage (cp.async.cg: dx is written
// within the launch); every row starts on 16 bytes (dx is the wrapper's
// own, K % 8 == 0). W's fragments come from shared memory: wl is the lane's
// uint4 of k16 block 0, 32 apart a block. Even and odd k16 blocks feed two
// mma chains, added at the end (a fixed order).
__device__ __forceinline__ void bwd_product(float (&acc)[2][4], bf16* ring,
                                            const bf16* dg, const uint4* wl,
                                            int row0, int B, int K, int k0,
                                            int kb, int g, int tq, int lane) {
  // the lane's copy of a stage: row lane / 2, bf16 8 (lane % 2) .. + 7
  const int kk = k0 + 8 * (lane % 2);
  const int b = row0 + lane / 2;
  const bool row_ok = b < B;
  const bf16* src = dg + (row_ok ? (long)b * K + kk : 0);
  const auto issue = [&](int q) {
    const bool ok = row_ok && kk + 16 * q < K;
    copy8(ring + (q % kRing) * kStage + 8 * lane, ok ? src + 16 * q : dg, ok);
  };
#pragma unroll
  for (int q = 0; q < kRing - 1; ++q) {
    if (q < kb) issue(q);
    commit();
  }
  float f[2][2][4];  // [chain][n8 tile]
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[c][j][e] = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxKBB; ++q) {
    if (q >= kb) break;
    // stage q + kRing - 1 lands in the slot stage q - 1 left
    if (q + kRing - 1 < kb) issue(q + kRing - 1);
    commit();
    wait_prior<kRing - 1>();
    __syncwarp();
    const bf16* p = ring + (q % kRing) * kStage + g * 16 + 4 * tq;
    uint32_t a[4];
    a_frag(a, p, p + 8 * 16);
    // the slot is read: the next stage's copies may land on it
    __syncwarp();
    const uint4 wv = wl[32 * q];
    mma_bf16(f[q % 2][0], a, wv.x, wv.y);
    mma_bf16(f[q % 2][1], a, wv.z, wv.w);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += f[0][j][e] + f[1][j][e];
}

// The step-t inputs of the cell (b, u): its float32 gates (i, c, f, o),
// c_{t-1}, the cotangents of r_t and c_t, and the mask. Read-only in the
// launch.
__device__ __forceinline__ void load_cell(float (&gg)[4], float (&in)[4],
                                          const float* gates,
                                          const bf16* c_prevs,
                                          const bf16* drs, const bf16* dcs,
                                          const bf16* mask, int t, int b,
                                          int B, int H, int u) {
  const long row = (long)t * B + b, idx = row * H + u;
#pragma unroll
  for (int q = 0; q < 4; ++q) gg[q] = __ldg(gates + row * 4 * H + q * H + u);
  in[0] = bf(__ldg(c_prevs + idx));
  in[1] = bf(__ldg(drs + idx));
  in[2] = bf(__ldg(dcs + idx));
  in[3] = bf(__ldg(mask + row));
}

// The reverse recurrence, t from T-1 down to 0, then dr0. blockIdx.x takes
// units [U x, U x + U), U = kUnitsB, and holds B(k, n) = W[u0 + n, k] for
// k over all 4H as bf16 B fragments in shared memory for all T steps;
// blockIdx.y the row tiles y, y + gridDim.y, ... (at most nt, each 16
// rows), one after another each step; warp w the K slice [16 kb w, 16 kb w
// + 16 kb) of 4H; thread (row, unit) = (tid / U, tid % U) one cell of each
// tile, whose carried dr (the masked pass-through) and dc stay in shared
// memory in float32. Step t: dr = pass-through + dgates_{t+1} W^T (the
// bf16 dgates_{t+1} read from dx, where the step before wrote it), the
// partial sums of the 8 warps added in warp order; then the cell writes
// bf16(dgates_t) into dx and adds the float32 dgates_t into db's sums; a
// grid barrier. The pass after step 0 (t = -1) is the product alone, into
// dr0. db: each cell thread sums its own float32 dgates over t (and its
// tiles, in turn), the block its rows in row order into dbp[blockIdx.y]
// before the last barrier, and the blocks of row group 0 the row groups
// in order after it. bar as the forward's.
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_seq_bf16_kernel(const float* __restrict__ gates,
                         const bf16* __restrict__ w,
                         const bf16* __restrict__ mask,
                         const bf16* __restrict__ c_prevs,
                         const bf16* __restrict__ drs,
                         const bf16* __restrict__ dcs, bf16* dx,
                         float* __restrict__ db, float* dbp,
                         float* __restrict__ dr0, float* __restrict__ dc0,
                         unsigned* bar, int T, int B, int H, int kb, int nt) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int u0 = blockIdx.x * kUnitsB;
  const int rows = 16, K = 4 * H;
  // the lane's W fragments, 32 uint4 apart a k16 block
  uint4* const wl = reinterpret_cast<uint4*>(smem4) + warp * kb * 32 + lane;
  bf16* const ring = reinterpret_cast<bf16*>(smem4 + kWarps * kb * 32) +
                     warp * kRing * kStage;
  float* const part = reinterpret_cast<float*>(smem4 + kWarps * kb * 32) +
                      kWarps * kRing * kStage / 2;
  float* const drt = part + kWarps * kPartB + threadIdx.x;
  float* const dct = drt + nt * kThreads;
  const int k0 = warp * 16 * kb;
  const int kwarps = min(kWarps, (K + 16 * kb - 1) / (16 * kb));
  const bool busy = warp < kwarps;
  const int tiles = ((B + rows - 1) / rows - (int)blockIdx.y +
                     (int)gridDim.y - 1) / (int)gridDim.y;
  const unsigned blocks = gridDim.x * gridDim.y;

  // W's slice as B fragments: register pair j of k16 block s holds
  // W[u0 + 8 j + g][k .. k + 3], k = k0 + 16 s + 4 tq (b0: k, k + 1; b1:
  // k + 2, k + 3), one 8-byte read (K % 16 == 0: a block is all in or
  // all out). Only the lane that writes a fragment reads it.
  for (int s = 0; s < kb; ++s) {
    const int k = k0 + 16 * s + 4 * tq;
    uint2 v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int u = u0 + 8 * j + g;
      v[j] = u < H && k < K
                 ? __ldg(reinterpret_cast<const uint2*>(w + (long)u * K + k))
                 : make_uint2(0u, 0u);
    }
    wl[32 * s] = make_uint4(v[0].x, v[0].y, v[1].x, v[1].y);
  }

  const int cr = threadIdx.x / kUnitsB, j = threadIdx.x % kUnitsB;
  const int u = u0 + j;
  const bool col_ok = u < H;
  for (int l = 0; l < tiles; ++l) {
    drt[l * kThreads] = 0.f;
    dct[l * kThreads] = 0.f;
  }
  float dbs[4] = {0.f, 0.f, 0.f, 0.f};
  // the inputs of the cell next in turn: gates, then c_{t-1}, dr_t, dc_t, m
  float gg[4] = {0.f, 0.f, 0.f, 0.f}, in[4] = {0.f, 0.f, 0.f, 0.f};
  if (col_ok && blockIdx.y * rows + cr < B)
    load_cell(gg, in, gates, c_prevs, drs, dcs, mask, T - 1,
              blockIdx.y * rows + cr, B, H, u);

  for (int t = T - 1; t >= -1; --t) {
    const bf16* dg = dx + (long)(t + 1) * B * K;  // dgates_{t+1}
    const bool carried = t + 1 < T;
    for (int l = 0; l < tiles; ++l) {
      const int row0 = (blockIdx.y + l * gridDim.y) * rows;
      if (carried && busy) {
        float acc[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
        bwd_product(acc, ring, dg, wl, row0, B, K, k0, kb, g, tq, lane);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float* p = part + warp * kPartB + g * kUnitsB + 8 * jj + 2 * tq;
          *reinterpret_cast<float2*>(p) = make_float2(acc[jj][0], acc[jj][1]);
          *reinterpret_cast<float2*>(p + 8 * kUnitsB) =
              make_float2(acc[jj][2], acc[jj][3]);
        }
      }
      __syncthreads();
      const int b = row0 + cr;
      if (col_ok && b < B) {
        // dr carried = the pass-through + the partial sums in warp order
        float p = 0.f;
        if (carried) {
          p = part[threadIdx.x];
          for (int v = 1; v < kwarps; ++v)
            p += part[v * kPartB + threadIdx.x];
        }
        const float dr = drt[l * kThreads] + p;
        if (t >= 0) {
          const float i = sigmoid(gg[0]), cand = tanhf(gg[1]);
          const float f = sigmoid(gg[2]), o = sigmoid(gg[3]);
          const float cp = in[0], m = in[3];
          const float c_new = f * cp + i * cand;
          const float tc = tanhf(c_new);
          const float d_rt = dr + in[1], d_ct = dct[l * kThreads] + in[2];
          const float dr_new = d_rt * m, dr_prev = d_rt * (1.f - m);
          float dc_new = d_ct * m, dc_prev = d_ct * (1.f - m);
          const float d_o = dr_new * tc;
          dc_new = dc_new + dr_new * o * (1.f - tc * tc);
          const float d_f = dc_new * cp, d_i = dc_new * cand;
          const float d_cand = dc_new * i;
          dc_prev = dc_prev + dc_new * f;
          const float dg4[4] = {d_i * i * (1.f - i),
                                d_cand * (1.f - cand * cand),
                                d_f * f * (1.f - f), d_o * o * (1.f - o)};
          bf16* dxb = dx + ((long)t * B + b) * K + u;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dxb[q * H] = to_bf(dg4[q]);  // the products' operand
            dbs[q] += dg4[q];            // db: the unrounded dgates
          }
          drt[l * kThreads] = dr_prev;
          dct[l * kThreads] = dc_prev;
          if (t == 0) dc0[(long)b * H + u] = dc_prev;
        } else {
          dr0[(long)b * H + u] = dr;
        }
      }
      // the inputs of the cell next in turn (the next tile, or the first
      // of the step before) are on their way during the next tile's
      // product or the grid barrier
      const bool last = l + 1 == tiles;
      const int nb = last ? blockIdx.y * rows + cr
                          : row0 + gridDim.y * rows + cr;
      if (col_ok && nb < B && t >= 0 && (!last || t >= 1))
        load_cell(gg, in, gates, c_prevs, drs, dcs, mask, last ? t - 1 : t,
                  nb, B, H, u);
      // the partials are read before the next tile's product writes them
      __syncthreads();
    }
    if (t == 0) {
      // the block's db, its rows added in row order (in the partials'
      // space, read by now)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[q * kThreads + threadIdx.x] = dbs[q];
      __syncthreads();
      if (threadIdx.x < 4 * kUnitsB) {
        const int q = threadIdx.x / kUnitsB, jj = threadIdx.x % kUnitsB;
        if (u0 + jj < H) {
          float s = 0.f;
          for (int r = 0; r < rows; ++r)
            s += part[q * kThreads + r * kUnitsB + jj];
          dbp[(long)blockIdx.y * K + q * H + u0 + jj] = s;
        }
      }
    }
    if (t >= 0) {
      if (threadIdx.x == 0) grid_sync(bar, (unsigned)(T - t) * blocks);
      __syncthreads();
    }
  }
  // db: the row groups' sums in blockIdx.y order
  if (blockIdx.y == 0 && threadIdx.x < 4 * kUnitsB) {
    const int q = threadIdx.x / kUnitsB, jj = threadIdx.x % kUnitsB;
    if (u0 + jj < H) {
      float s = 0.f;
      for (int y = 0; y < (int)gridDim.y; ++y)
        s += __ldcg(dbp + (long)y * K + q * H + u0 + jj);
      db[q * H + u0 + jj] = s;
    }
  }
  grid_done(bar, blocks);
}

// 0, or the cudaError_t of setting kernel's shared memory to `bytes`
template <class Kernel>
inline cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace seq

// ---------------------------------------------------------------------------
// the backward's whole-sequence products on tensor cores:
// C[m][n] = (addend[m][n] +) sum over k of A(m, k) B[k][n] (+ bias[n]), in
// float32; A(m, k) = A[m lda + k] if A_K (the gates' recompute: r_prevs W),
// else A[k lda + m] (dW = r_prevs^T dx); A, B, addend and bias bf16, B
// row-major [K][N]; M, N and K multiples of 8, A and B 16-byte aligned.
// ---------------------------------------------------------------------------

namespace tc {

// A block owns BM x BN of C: 8 warps, 2 x 4, of 32 x 32 (kMT = 2 m16 x 4
// n8 tiles). K streams in stages of 16 through a ring of 3 in shared
// memory, two stages ahead, one 16-byte copy a thread (A; the first half of
// the block) or two (B): A as [BM][16] (A_K: 32 bytes a row, so that the
// 8-byte fragment reads of 4 rows fall on 32 banks) or [16][BM + 8], B as
// [16][BN + 8]. The fragments of A^T and B pair bf16 of two k rows, read
// one at a time. k in order: two calls give the same bits.
constexpr int kMT = 2, kBM = 32 * kMT, kBN = 128, kRing = 3;
constexpr int kAPitchM = kBM + 8, kBPitch = kBN + 8;
constexpr int kAStage = kBM * 16 > 16 * kAPitchM ? kBM * 16 : 16 * kAPitchM;
constexpr int kBStage = 16 * kBPitch;

template <bool A_K>
__global__ void __launch_bounds__(kThreads, 2)
lstm_bwd_gemm_bf16_kernel(const bf16* __restrict__ A, long lda,
                          const bf16* __restrict__ Bm, long ldb,
                          float* __restrict__ C, long ldc,
                          const bf16* __restrict__ addend,
                          const bf16* __restrict__ bias, int M, int N,
                          int K) {
  __shared__ __align__(16) bf16 As[kRing][kAStage];
  __shared__ __align__(16) bf16 Bs[kRing][kBStage];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int stages = (K + 15) / 16;

  // a stage: A's 128 16-byte chunks (threads 0-127), B's 256
  const auto issue = [&](int st) {
    if (st < stages) {
      const int k0 = 16 * st, slot = st % kRing;
      const int c = threadIdx.x;
      if (c < 128) {
        if (A_K) {  // row m0 + c / 2, k0 + 8 (c % 2) .. + 7
          const int m = m0 + c / 2, k = k0 + 8 * (c % 2);
          const bool ok = m < M && k < K;
          copy8(&As[slot][(c / 2) * 16 + 8 * (c % 2)],
                ok ? A + (long)m * lda + k : A, ok);
        } else {  // row k0 + c / 8, m0 + 8 (c % 8) .. + 7
          const int k = k0 + c / 8, m = m0 + 8 * (c % 8);
          const bool ok = k < K && m < M;
          copy8(&As[slot][(c / 8) * kAPitchM + 8 * (c % 8)],
                ok ? A + (long)k * lda + m : A, ok);
        }
      }
      // row k0 + c / 16, n0 + 8 (c % 16) .. + 7
      const int k = k0 + c / 16, n = n0 + 8 * (c % 16);
      const bool ok = k < K && n < N;
      copy8(&Bs[slot][(c / 16) * kBPitch + 8 * (c % 16)],
            ok ? Bm + (long)k * ldb + n : Bm, ok);
    }
    commit();
  };

  float acc[kMT][4][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  issue(0);
  issue(1);
  for (int st = 0; st < stages; ++st) {
    wait_prior<1>();
    // stage st landed for every thread, and every thread has left the
    // slot stage st + 2 lands in
    __syncthreads();
    issue(st + 2);
    const bf16* sa = As[st % kRing];
    const bf16* sb = Bs[st % kRing];
    uint32_t a[kMT][4], b[4][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int r = wm * 16 * kMT + 16 * i + g;
      if (A_K) {
        a_frag(a[i], sa + r * 16 + 4 * tq, sa + (r + 8) * 16 + 4 * tq);
      } else {
        const bf16* p = sa + 4 * tq * kAPitchM + r;
#pragma unroll
        for (int h = 0; h < 2; ++h)  // rows r, r + 8
#pragma unroll
          for (int e = 0; e < 2; ++e)  // k 4 tq + 2 e, + 1
            a[i][h + 2 * e] = pack(p[2 * e * kAPitchM + 8 * h],
                                   p[(2 * e + 1) * kAPitchM + 8 * h]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bf16* p = sb + 4 * tq * kBPitch + wn * 32 + 8 * j + g;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        b[j][e] = pack(p[2 * e * kBPitch], p[(2 * e + 1) * kBPitch]);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
  }
  // (addend + acc) + bias, as the Pallas kernel adds them
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 16 * kMT + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + 8 * j + 2 * tq + e;
          if (n >= N) continue;
          float v = acc[i][j][2 * h + e];
          if (addend != nullptr) v = bf(addend[(long)m * ldc + n]) + v;
          if (bias != nullptr) v = v + bf(bias[n]);
          C[(long)m * ldc + n] = v;
        }
    }
}

template <bool A_K>
int launch(const bf16* A, long lda, const bf16* Bm, long ldb, float* C,
           long ldc, const bf16* addend, const bf16* bias, int M, int N,
           int K, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  lstm_bwd_gemm_bf16_kernel<A_K><<<grid, kThreads, 0, s>>>(
      A, lda, Bm, ldb, C, ldc, addend, bias, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x [T, B, 4H], w [H, 4H], b [4H], mask [T, B], r0 and c0 [B, H]; rs and cs
// [T, B, H] out. All bf16, contiguous, 16-byte aligned, H % 8 == 0. One
// cooperative launch of the sequence kernel on `stream`: mt 16-row tiles
// make a row tile (1 or 2), kb k16 blocks a warp (1 to 4, 8 x 16 kb >= H),
// nt row tiles at most a block (1 to 64; the grid's rows of blocks are the
// fewest that give no block more); bar two unsigned counters at 0, set
// back to 0 by the launch (a buffer of the stream's own). Returns a
// cudaError_t (0 = launched; cudaErrorCooperativeLaunchTooLarge where the
// grid cannot be resident at once).
extern "C" int lstm_seq_fwd_seq_bf16(const bf16* x, const bf16* w,
                                     const bf16* b, const bf16* mask,
                                     const bf16* r0, const bf16* c0, bf16* rs,
                                     bf16* cs, unsigned* bar, int T, int B,
                                     int H, int mt, int kb, int nt,
                                     void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H % 8 || mt < 1 || mt > seq::kMaxMT ||
      kb < 1 || kb > seq::kMaxKB || seq::kWarps * 16 * kb < H || nt < 1 ||
      nt > seq::kMaxNT)
    return (int)cudaErrorInvalidValue;
  const int tiles = (B + 16 * mt - 1) / (16 * mt);
  const int gy = (tiles + nt - 1) / nt;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const int smem = seq::smem_bytes(mt, kb, nt);
  const cudaError_t e = seq::set_smem(seq::lstm_fwd_seq_bf16_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((H + seq::kUnits - 1) / seq::kUnits, gy);
  void* args[] = {&x, &w, &b, &mask, &r0, &c0, &rs, &cs, &bar,
                  &T, &B, &H, &mt, &kb, &nt};
  return (int)cudaLaunchCooperativeKernel(
      seq::lstm_fwd_seq_bf16_kernel, grid, dim3(kThreads), args, smem,
      static_cast<cudaStream_t>(stream));
}

// Blocks of the forward's sequence kernel at (mt, kb, nt) that an SM holds
// at once, into *out. Returns a cudaError_t.
extern "C" int lstm_fwd_bf16_blocks_per_sm(int mt, int kb, int nt, int* out) {
  if (mt < 1 || mt > seq::kMaxMT || kb < 1 || kb > seq::kMaxKB || nt < 1 ||
      nt > seq::kMaxNT)
    return (int)cudaErrorInvalidValue;
  const int smem = seq::smem_bytes(mt, kb, nt);
  const cudaError_t e = seq::set_smem(seq::lstm_fwd_seq_bf16_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, seq::lstm_fwd_seq_bf16_kernel, kThreads, smem);
}

// Blocks of the backward's sequence kernel at (mt, kb, nt) that an SM
// holds at once, into *out. Returns a cudaError_t.
extern "C" int lstm_bwd_bf16_blocks_per_sm(int mt, int kb, int nt, int* out) {
  if (mt != 1 || kb < 1 || kb > seq::kMaxKBB || nt < 1 || nt > seq::kMaxNTB)
    return (int)cudaErrorInvalidValue;
  const int smem = seq::bwd_smem_bytes(kb, nt);
  const cudaError_t e = seq::set_smem(seq::lstm_bwd_seq_bf16_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, seq::lstm_bwd_seq_bf16_kernel, kThreads, smem);
}

// x [T, B, 4H], w [H, 4H], b [4H], mask [T, B], r_prevs, c_prevs, drs, dcs
// [T, B, H] (element t of r_prevs / c_prevs holds the carry of step t-1,
// r0 / c0 at t = 0), all bf16, contiguous, 16-byte aligned, H % 8 == 0;
// dx [T, B, 4H] bf16, dw [H, 4H], db [4H], dr0, dc0 [B, H] float32 out.
// Three launches on `stream`: the gates' recompute into `gates` [T, B, 4H]
// (float32 scratch), the sequence kernel (dx, db, dr0, dc0), dW. mt 1
// (row tiles of 16), kb k16 blocks a warp (1 to 16, 8 x 16 kb >= 4H), nt
// row tiles at most a block (1 to 28); dbp [row groups, 4H] float32
// scratch for db's partial sums; bar as the forward's. Returns a
// cudaError_t (0 = launched; cudaErrorCooperativeLaunchTooLarge where the
// grid cannot be resident at once).
extern "C" int lstm_seq_bwd_seq_bf16(
    const bf16* x, const bf16* w, const bf16* b, const bf16* mask,
    const bf16* r_prevs, const bf16* c_prevs, const bf16* drs,
    const bf16* dcs, bf16* dx, float* dw, float* db, float* dr0, float* dc0,
    float* gates, float* dbp, unsigned* bar, int T, int B, int H, int mt,
    int kb, int nt, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H % 8 || mt != 1 || kb < 1 ||
      kb > seq::kMaxKBB || seq::kWarps * 16 * kb < 4 * H || nt < 1 ||
      nt > seq::kMaxNTB || ((long)T * B + tc::kBM - 1) / tc::kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles = (B + 15) / 16;
  const int gy = (tiles + nt - 1) / nt;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = T * B;
  // gates [R, 4H] = x + r_prevs w + b
  int e = tc::launch<true>(r_prevs, H, w, 4L * H, gates, 4L * H, x, b, R,
                           4 * H, H, s);
  if (e != 0) return e;
  const int smem = seq::bwd_smem_bytes(kb, nt);
  e = (int)seq::set_smem(seq::lstm_bwd_seq_bf16_kernel, smem);
  if (e != 0) return e;
  const dim3 grid((H + seq::kUnitsB - 1) / seq::kUnitsB, gy);
  const float* cgates = gates;
  void* args[] = {&cgates, &w,   &mask, &c_prevs, &drs, &dcs, &dx, &db,
                  &dbp,    &dr0, &dc0,  &bar,     &T,   &B,   &H,  &kb, &nt};
  e = (int)cudaLaunchCooperativeKernel(seq::lstm_bwd_seq_bf16_kernel, grid,
                                       dim3(kThreads), args, smem, s);
  if (e != 0) return e;
  // dw [H, 4H] = r_prevs^T dx over the R rows
  return tc::launch<false>(r_prevs, H, dx, 4L * H, dw, 4L * H, nullptr,
                           nullptr, H, 4 * H, R, s);
}
