// Whole-sequence LSTM kernels for Hopper (sm_90a), float32.
//
// Replace the TPU kernels of paddle_tpu/kernels/fused_lstm.py:
//   lstm_seq_fwd (Pallas body _fwd_kernel): for t in 0..T-1,
//     gates = x_t + r @ W + b (gate order i, c, f, o),
//     c' = sigmoid(f) c + sigmoid(i) tanh(c^), r' = sigmoid(o) tanh(c'),
//     r_t = m r' + (1 - m) r and c_t = m c' + (1 - m) c (rows past a
//     sequence's length carry their state forward);
//     it writes the carry sequences rs, cs [T, B, H];
//   lstm_seq_bwd (_bwd_kernel): the reverse-time recurrence from the
//     carries of the step before (r_prevs, c_prevs) and the cotangents of
//     rs and cs: dx = dgates [T, B, 4H], dW = sum_t r_{t-1}^T dgates_t
//     [H, 4H], db = sum over t and b of dgates_t [4H], dr0, dc0 [B, H].
//
// What bounds them on the H100: operations, on paper. At the bench shape
// (T 100, B 64, H 512) the forward does 13.4 GFLOP of products (0.200 ms
// at the 67 TFLOP/s float32 peak, 0.081 ms as 3xTF32 at 495 TFLOP/s) and
// moves ~83 MB (0.025 ms); the backward 40.3 GFLOP (0.601 ms: the gate
// recompute, dgates @ W^T and dW; 0.244 ms as 3xTF32) and ~157 MB. In
// practice the recurrence bounds them: step t needs all of r_{t-1} (the
// backward: all of dgates_{t+1}), so each step is a [B, H] x [H, 4H]
// product that cannot start before the previous one ends, and at B 64 one
// step is too little work to fill 132 SMs for long. The time is per-step
// latency.
//
// What the design does about it. The TPU kernel keeps W [H, 4H] in one
// core's VMEM across a sequential grid.
//   Forward: one persistent launch a sequence (lstm_fwd_seq_kernel,
//   launched cooperatively, so the runtime refuses a grid that cannot be
//   resident at once rather than let it hang). W at H 512 (4 MiB) is
//   spread over the grid's registers: a block owns 8 hidden units, all
//   four gate columns of each (32 columns), and loads its [H, 32] slice
//   of W once, as raw mma.sync B fragments (64 registers a thread at H
//   512), for all T steps. The batch is cut into row tiles of 16 mt <= 32
//   rows; the grid's rows of blocks share them out, and a block takes its
//   tiles one after another each step (at B 64, H 512: 64 x 2 blocks of
//   one tile, 64 KB of r read from L2 a block a step; at B 128, 64 x 2 of
//   two). A tile: each of the 8 warps takes a 16 kb-deep slice of K,
//   copies its rows x K slice of r_{t-1} from L2 (cp.async.cg, one group
//   a k16 block, 16 bytes a copy where the rows start on 16 bytes, else
//   ld.global.cg; never the non-coherent path: rs is written within the
//   launch) and multiplies it as it lands in 3xTF32 (a fresh fragment
//   each k8 step, as csrc/tf32_mma.cuh's products); the 8 warps' partial
//   sums go to shared memory and each (row, unit) thread adds them in
//   warp order (deterministic) and applies the gate nonlinearities; c and
//   r of its cells stay in shared memory from step to step (c is written
//   to cs, never read back). The x and mask of the thread's next cell are
//   on their way during the next tile's product or the grid barrier (a
//   counter in a scratch buffer of the stream: one thread a block arrives
//   by a release add and leaves by an ld.acquire.gpu spin, between two
//   __syncthreads; the last block out sets it back to 0).
//   Where no grid fits (H > 512, or more than 64 tiles a block), the
//   forward is the step kernel's: one launch per step
//   (lstm_fwd_step_kernel, looped in the C entry): a block of 16 units x
//   16 rows over 128-deep shared-memory stages of r and W.
//   Backward (lstm_seq_bwd_seq_f32): three launches. (1) The gates of
//   every step at once, G = X + R_prev W + b (R_prev is known), and (3)
//   dW = R_prev^T dx over the T*B rows: one 3xTF32 mma.sync product
//   (tc::lstm_bwd_gemm_tc_kernel: 64 x 128 tiles, K in 16-deep stages
//   through a ring of 3 of cp.async, k in order). (2) The reverse
//   recurrence in one cooperative launch (seq::lstm_bwd_seq_kernel), t
//   from T-1 down to 0: dr_{t} for any unit needs all of dgates_{t+1},
//   so a step is dgates_{t+1} W^T then the cell, with a grid barrier
//   between steps. A block owns 16 units and holds W^T's [4H, 16] slice
//   as raw B fragments in shared memory (128 KB at H 512) for all T
//   steps; the blocks exchange only dgates, through dx, which they write
//   anyway: each step every block reads its row tile's dgates_{t+1} (16
//   rows x 4H) from L2 by cp.async.cg, each warp a 4H/8-deep K slice
//   through a ring of 4 k16 stages, in 3xTF32 with its stage's mma chains
//   interleaved and their adds deferred past the next stage's wait; the
//   warps' partial sums are added in warp order by one thread a cell,
//   whose carried (dr, dc) stay in shared memory; the next cell's inputs
//   are on their way during the barrier. db is summed in the launch (a
//   cell thread over t, the block over its rows, row group 0 over the row
//   groups, in that fixed order), and so is dr0 (a product after the
//   last barrier). At T 100, B 64, H 512 a step is about 6 us: its
//   dgates loads (a latency chain of 16 stages), the barrier, the
//   product and the cell (PERF.md).
//   Where no grid fits (H > 512, or more than 28 tiles of 16 a block),
//   the backward is the per-step path (lstm_seq_bwd_f32): the same two
//   products around two launches a step, (a) a cell kernel, one thread
//   per (row, unit), that turns the carried (dr, dc) and the step's
//   cotangents into dgates_t (written to dx) and the masked carries, and
//   (b) dgates_t W^T in K slices, each slice's partial product into its
//   own buffer (an f32 SIMT tiled product, 64 x 64 tiles, 4 x 4 outputs a
//   thread), which the next cell kernel adds in a fixed order; then dr0
//   and db: 2T + 4 launches.
// Every sum runs in a fixed order and no float atomics: two calls give
// the same bits. Transcendentals are expf/tanhf (no fast-math
// intrinsics).
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// ---------------------------------------------------------------------------
// forward step
// ---------------------------------------------------------------------------

constexpr int kFU = 16;  // hidden units per block
constexpr int kFB = 16;  // batch rows per block
constexpr int kFK = 128;  // depth of one shared-memory stage

// One step: blockIdx.x takes units [16 x, 16 x + 16), blockIdx.y batch
// rows [16 y, 16 y + 16). Thread (ty, tx) = (row, unit).
__global__ void __launch_bounds__(kThreads)
lstm_fwd_step_kernel(const float* __restrict__ x_t,
                     const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ m_t,
                     const float* __restrict__ r_prev,
                     const float* __restrict__ c_prev,
                     float* __restrict__ r_out, float* __restrict__ c_out,
                     int B, int H) {
  __shared__ float rs[kFB][kFK + 1];
  __shared__ float ws[kFK][4 * kFU];
  const int tx = threadIdx.x % kFU;
  const int ty = threadIdx.x / kFU;
  const int u0 = blockIdx.x * kFU;
  const int b0 = blockIdx.y * kFB;
  const long h4 = 4L * H;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < H; k0 += kFK) {
    // a whole stage's loads are issued before the first store: one L2
    // round trip a stage, not one a load
#pragma unroll
    for (int j = 0; j < kFB * kFK / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int rr = i / kFK, kk = i % kFK;
      const int gb = b0 + rr, gk = k0 + kk;
      rs[rr][kk] = (gb < B && gk < H) ? r_prev[(long)gb * H + gk] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kFK * 4 * kFU / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int kk = i / (4 * kFU), col = i % (4 * kFU);
      const int g = col / kFU, gu = u0 + col % kFU, gk = k0 + kk;
      ws[kk][col] = (gk < H && gu < H) ? w[gk * h4 + (long)g * H + gu] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kFK; ++kk) {
      const float a = rs[ty][kk];
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g] = fmaf(a, ws[kk][g * kFU + tx], acc[g]);
    }
    __syncthreads();
  }
  const int b = b0 + ty, u = u0 + tx;
  if (b >= B || u >= H) return;
  const float* xb = x_t + b * h4;
  const float gi = (xb[u] + acc[0]) + bias[u];
  const float gc = (xb[H + u] + acc[1]) + bias[H + u];
  const float gf = (xb[2 * H + u] + acc[2]) + bias[2 * H + u];
  const float go = (xb[3 * H + u] + acc[3]) + bias[3 * H + u];
  const float i = sigmoid(gi), f = sigmoid(gf), o = sigmoid(go);
  const float cand = tanhf(gc);
  const long idx = (long)b * H + u;
  const float c = c_prev[idx], r = r_prev[idx];
  const float c_new = f * c + i * cand;
  const float r_new = o * tanhf(c_new);
  const float m = m_t[b];
  r_out[idx] = m * r_new + (1.f - m) * r;
  c_out[idx] = m * c_new + (1.f - m) * c;
}

// ---------------------------------------------------------------------------
// forward: one persistent launch a sequence
// ---------------------------------------------------------------------------

namespace seq {

constexpr int kWarps = kThreads / 32;
constexpr int kMaxKB = 4;  // k16 blocks of a warp's K slice: H <= 512
// U hidden units a block, all four gate columns of each (N columns, NT
// n8 tiles), over row tiles of at most 16 kMaxMT batch rows. U 8 over 32
// rows with W raw in registers: U 4 over 64 rows with W pre-split took
// 1.3x its time, U 16 over 16 rows with W in shared memory as much
// (PERF.md §6). A block takes at most kMaxNT row tiles a step.
constexpr int kUnits = 8, kN = 4 * kUnits, kNT = kN / 8, kMaxMT = 2;
constexpr int kMaxNT = 64;
// a spin at the grid barrier longer than this traps (a fault, not a hang)
constexpr unsigned long long kSpinLimitNs = 5000000000ull;

// Floats between two rows of a warp's r slice (16 kb deep): 16 mod 32, so
// that the 16-byte fragment reads of rows g and g + 1 hit other banks.
__host__ __device__ constexpr int row_stride(int kb) {
  return 16 * (kb + 1 - kb % 2);
}
// Floats of a warp's region: its r slice, later its [rows][N + 8] partials.
__host__ __device__ constexpr int region(int mt, int kb) {
  return 16 * mt * (row_stride(kb) > kN + 8 ? row_stride(kb) : kN + 8);
}
// the warps' regions, then c and r of each thread's cell in each of nt
// row tiles
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
// group of copies a k16 block; rows past B and k past H are zero. 16-byte
// copies where every row of rp starts on 16 bytes (vec: H % 4 == 0 and rp
// aligned; r0 may be any contiguous view), else 4-byte L2 loads
// (ld.global.cg).
__device__ __forceinline__ void load_r(float* mine, const float* rp,
                                       bool vec, int row0, int rows, int B,
                                       int H, int k0, int kb, int stride,
                                       int lane) {
#pragma unroll
  for (int q = 0; q < kMaxKB; ++q) {
    if (q >= kb) break;
    if (vec) {
      for (int e = lane; e < rows * 4; e += 32) {
        const int rr = e / 4, kk = 16 * q + 4 * (e % 4);
        const int b = row0 + rr, k = k0 + kk;
        const bool ok = b < B && k < H;
        copy16(mine + rr * stride + kk, ok ? rp + (long)b * H + k : rp, ok);
      }
    } else {
      for (int e = lane; e < rows * 16; e += 32) {
        const int rr = e / 16, kk = 16 * q + e % 16;
        const int b = row0 + rr, k = k0 + kk;
        mine[rr * stride + kk] =
            b < B && k < H ? __ldcg(rp + (long)b * H + k) : 0.f;
      }
    }
    commit();
  }
}

// acc[i][j] += the warp's rows x its K slice of r times W's slice, in
// 3xTF32: each k16 block as its copies land, r and W split at each k8
// step, a fresh fragment a k8 step (small terms first), as tf32_mma.cuh's
// mma3.
__device__ __forceinline__ void product(
    float (&acc)[kMaxMT][kNT][4], const float* mine,
    const float (&wf)[2 * kMaxKB][kNT][2], int mt, int kb, int stride,
    int g, int tq) {
#pragma unroll
  for (int q = 0; q < kMaxKB; ++q) {
    if (q >= kb) break;
    wait_left(kb - 1 - q);
    __syncwarp();
    float4 lo[kMaxMT], hi[kMaxMT];
#pragma unroll
    for (int i = 0; i < kMaxMT; ++i) {
      if (i >= mt) break;
      const float* p = mine + (16 * i + g) * stride + 16 * q + 4 * tq;
      lo[i] = *reinterpret_cast<const float4*>(p);
      hi[i] = *reinterpret_cast<const float4*>(p + 8 * stride);
    }
#pragma unroll
    for (int ss = 0; ss < 2; ++ss) {
      const int s = 2 * q + ss;
      uint32_t bb[kNT][2], bs[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) split(wf[s][j][e], bb[j][e], bs[j][e]);
#pragma unroll
      for (int i = 0; i < kMaxMT; ++i) {
        if (i >= mt) break;
        uint32_t ab[4], as[4];
        a_frag(lo[i], hi[i], ss, ab, as);
        float f[kNT][4];
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma0(f[j], as, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(f[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(f[j], ab, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += f[j][e];
      }
    }
  }
}

// The step-t x (gates i, c, f, o) and mask of the cell (b, u).
__device__ __forceinline__ void load_x(float (&xg)[4], float& m,
                                       const float* x, const float* mask,
                                       int t, int b, int B, int H, int u) {
  const long row = (long)t * B + b;
  m = mask[row];
#pragma unroll
  for (int q = 0; q < 4; ++q) xg[q] = x[row * 4 * H + q * H + u];
}

// The whole sequence. blockIdx.x takes units [U x, U x + U); blockIdx.y
// the row tiles y, y + gridDim.y, ... (at most nt, each 16 mt rows),
// one after another each step; warp w the K slice [16 kb w, 16 kb w + 16
// kb); thread (row, unit) = (tid / U, tid % U) one cell of each tile,
// whose c and r stay in shared memory from step to step. The block's
// gate columns interleave: column 4 j + q is gate q of unit u0 + j.
// bar[0] counts arrivals at the grid barrier, bar[1] blocks done; both
// start and end at 0.
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_seq_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ mask,
                    const float* __restrict__ r0,
                    const float* __restrict__ c0, float* rs,
                    float* __restrict__ cs, unsigned* bar, int T, int B,
                    int H, int mt, int kb, int nt) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int u0 = blockIdx.x * kUnits;
  const int rows = 16 * mt;
  const int stride = row_stride(kb), pn = kN + 8;
  const int reg = region(mt, kb);
  float* const mine = smem + warp * reg;
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

  // W's slice as B fragments, for all T steps: k8 step s of the warp's
  // slice is k16 block s / 2, its slot tq (tq + 4) element 4 tq + 2 (s %
  // 2) (+ 1), as a_frag permutes r; column 8 j + g is gate col % 4 of
  // unit u0 + col / 4, so that a cell's four gates are adjacent
  float wf[2 * kMaxKB][kNT][2];
#pragma unroll
  for (int s = 0; s < 2 * kMaxKB; ++s) {
    const int k = k0 + 16 * (s / 2) + 4 * tq + 2 * (s % 2);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = 8 * j + g, u = u0 + col / 4;
      const float* wc = w + (long)(col % 4) * H + u;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        wf[s][j][e] = s < 2 * kb && u < H && k + e < H
                          ? __ldg(wc + (k + e) * 4L * H)
                          : 0.f;
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
    cst[l * kThreads] = cell ? c0[(long)b * H + u] : 0.f;
    rst[l * kThreads] = cell ? r0[(long)b * H + u] : 0.f;
  }
  if (col_ok) {
#pragma unroll
    for (int q = 0; q < 4; ++q) bg[q] = bias[q * H + u];
    if (blockIdx.y * rows + cr < B)
      load_x(xg, m, x, mask, 0, blockIdx.y * rows + cr, B, H, u);
  }

  for (int t = 0; t < T; ++t) {
    const float* rp = t == 0 ? r0 : rs + (t - 1) * bh;
    const bool vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(rp) % 16 == 0;
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
        load_r(mine, rp, vec, row0, rows, B, H, k0, kb, stride, lane);
        product(acc, mine, wf, mt, kb, stride, g, tq);
        wait_prior<0>();
        __syncwarp();
        // the warp's partial sums over the r slice it no longer reads
#pragma unroll
        for (int i = 0; i < kMaxMT; ++i) {
          if (i >= mt) break;
          float* p = mine + (16 * i + g) * pn + 2 * tq;
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
        // the partial sums in warp order, then (x + acc) + b as the step
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
        const float r_t = m * r_new + (1.f - m) * r;
        const float c_t = m * c_new + (1.f - m) * c;
        rst[l * kThreads] = r_t;
        cst[l * kThreads] = c_t;
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
// rows, at most kMaxNTB of them a step (its shared memory); a warp's K
// slice of 4H is at most kMaxKBB k16 blocks (8 warps: H <= 512), and a
// ring of kRing k16 stages of it is in flight a warp (2, 3 and 4
// measured: scripts/torch_lstm_bwd_probe.py). 16 units, W in shared
// memory, halve the dgates each step reads from L2 against 8 units with W
// in registers (PERF.md).
constexpr int kUnitsB = 16, kMaxKBB = 16, kRing = 4, kMaxNTB = 28;
constexpr int kStage = 16 * 16;       // floats of a stage: 16 rows x k16
constexpr int kPartB = 16 * kUnitsB;  // floats of a warp's partial sums
// W's fragments (a float4 a lane a k8 step of its warp's slice), the
// warps' rings and partial sums, then dr and dc of each thread's cell in
// each of nt row tiles
constexpr int bwd_smem_bytes(int kb, int nt) {
  return (kWarps * 2 * kb * 32 * 4 + kWarps * (kRing * kStage + kPartB) +
          2 * nt * kThreads) * 4;
}

// acc[j] += the warp's 16 rows x [k0, k0 + 16 kb) slice of dgates (rows
// of K = 4H floats) times W's slice B(k, n) = W[u0 + n, k] (n8 tile j),
// in 3xTF32 as product() above. The slice streams through a ring of kRing
// k16 stages, kRing - 1 ahead of the product; cp.async.cg (L2), since
// dgates is written within the launch; every row starts on 16 bytes (dx
// is the wrapper's own) and K % 4 == 0, so every copy is 16 bytes. W's
// fragments come from shared memory: wl is the lane's float4 of k8 step
// 0, 32 float4 apart a step. A stage's four mma chains interleave, and its
// fragments are added into acc after the next stage's wait (in k8-step
// order), so that their latency passes under it.
__device__ __forceinline__ void bwd_product(float (&acc)[2][4], float* ring,
                                            const float* dg,
                                            const float4* wl, int row0,
                                            int B, int K, int k0, int kb,
                                            int g, int tq, int lane) {
  // the lane's copies of a stage: 16-byte chunks e = lane + 32 j of 16
  // rows x 16 floats, row e / 4, floats 4 (lane % 4) of the k16 block
  const int kk = k0 + 4 * (lane % 4);
  const float* src[2];
  bool row_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int b = row0 + (lane + 32 * j) / 4;
    row_ok[j] = b < B;
    src[j] = dg + (row_ok[j] ? (long)b * K + kk : 0);
  }
  const auto issue = [&](int q) {
    float* st = ring + (q % kRing) * kStage + 4 * lane;
    const bool k_ok = kk + 16 * q < K;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = row_ok[j] && k_ok;
      copy16(st + 128 * j, ok ? src[j] + 16 * q : dg, ok);
    }
  };
#pragma unroll
  for (int q = 0; q < kRing - 1; ++q) {
    if (q < kb) issue(q);
    commit();
  }
  float f[2][2][4];  // the last stage's fragments [k8 step][n8 tile]
#pragma unroll
  for (int q = 0; q < kMaxKBB; ++q) {
    if (q >= kb) break;
    // stage q + kRing - 1 lands in the slot stage q - 1 left
    if (q + kRing - 1 < kb) issue(q + kRing - 1);
    commit();
    wait_prior<kRing - 1>();
    __syncwarp();
    const float* p = ring + (q % kRing) * kStage + g * 16 + 4 * tq;
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 8 * 16);
    // the slot is read: the next stage's copies may land on it
    __syncwarp();
    const float4 wv[2] = {wl[32 * (2 * q)], wl[32 * (2 * q + 1)]};
    if (q > 0)
#pragma unroll
      for (int ss = 0; ss < 2; ++ss)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += f[ss][j][e];
    uint32_t bb[2][2][2], bs[2][2][2], ab[2][4], as[2][4];
#pragma unroll
    for (int ss = 0; ss < 2; ++ss) {
      split(wv[ss].x, bb[ss][0][0], bs[ss][0][0]);
      split(wv[ss].y, bb[ss][0][1], bs[ss][0][1]);
      split(wv[ss].z, bb[ss][1][0], bs[ss][1][0]);
      split(wv[ss].w, bb[ss][1][1], bs[ss][1][1]);
      a_frag(lo, hi, ss, ab[ss], as[ss]);
    }
#pragma unroll
    for (int ss = 0; ss < 2; ++ss)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma0(f[ss][j], as[ss], bb[ss][j][0], bb[ss][j][1]);
#pragma unroll
    for (int ss = 0; ss < 2; ++ss)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma(f[ss][j], ab[ss], bs[ss][j][0], bs[ss][j][1]);
#pragma unroll
    for (int ss = 0; ss < 2; ++ss)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma(f[ss][j], ab[ss], bb[ss][j][0], bb[ss][j][1]);
  }
#pragma unroll
  for (int ss = 0; ss < 2; ++ss)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += f[ss][j][e];
}

// The step-t inputs of the cell (b, u): its gates (i, c, f, o), c_{t-1},
// the cotangents of r_t and c_t, and the mask. Read-only in the launch.
__device__ __forceinline__ void load_cell(float (&gg)[4], float (&in)[4],
                                          const float* gates,
                                          const float* c_prevs,
                                          const float* drs, const float* dcs,
                                          const float* mask, int t, int b,
                                          int B, int H, int u) {
  const long row = (long)t * B + b, idx = row * H + u;
#pragma unroll
  for (int q = 0; q < 4; ++q) gg[q] = __ldg(gates + row * 4 * H + q * H + u);
  in[0] = __ldg(c_prevs + idx);
  in[1] = __ldg(drs + idx);
  in[2] = __ldg(dcs + idx);
  in[3] = __ldg(mask + row);
}

// The reverse recurrence, t from T-1 down to 0, then dr0. blockIdx.x takes
// units [U x, U x + U), U = kUnitsB, and holds B(k, n) = W[u0 + n, k] for
// k over all 4H as raw mma.sync B fragments in shared memory for all T
// steps; blockIdx.y the row tiles y, y + gridDim.y, ... (at most nt, each
// 16 rows), one after another each step; warp w the K slice [16 kb w, 16
// kb w + 16 kb) of 4H; thread (row, unit) = (tid / U, tid % U) one cell of
// each tile, whose carried dr (the masked pass-through) and dc stay in
// shared memory from step to step. Step t: dr = pass-through + dgates_{t+1}
// W^T (dgates_{t+1} read from dx, where the step before wrote it: the
// blocks exchange nothing else), the partial sums of the 8 warps added in
// warp order; then the cell writes dgates_t into dx; a grid barrier. The
// pass after step 0 (t = -1) is the product alone, into dr0. db: each cell
// thread sums its own dgates over t (and its tiles, in turn), the block its
// rows in row order into dbp[blockIdx.y] before the last barrier, and the
// blocks of row group 0 the row groups in order after it. bar as the
// forward's.
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_seq_kernel(const float* __restrict__ gates,
                    const float* __restrict__ w,
                    const float* __restrict__ mask,
                    const float* __restrict__ c_prevs,
                    const float* __restrict__ drs,
                    const float* __restrict__ dcs, float* dx,
                    float* __restrict__ db, float* dbp,
                    float* __restrict__ dr0, float* __restrict__ dc0,
                    unsigned* bar, int T, int B, int H, int kb, int nt) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int u0 = blockIdx.x * kUnitsB;
  const int rows = 16, K = 4 * H;
  // the lane's W fragments, 32 float4 apart a k8 step
  float4* const wl = smem4 + warp * 2 * kb * 32 + lane;
  float* const ring = smem + kWarps * 2 * kb * 128 + warp * kRing * kStage;
  float* const part = smem + kWarps * (2 * kb * 128 + kRing * kStage);
  float* const drt = part + kWarps * kPartB + threadIdx.x;
  float* const dct = drt + nt * kThreads;
  const int k0 = warp * 16 * kb;
  const int kwarps = min(kWarps, (K + 16 * kb - 1) / (16 * kb));
  const bool busy = warp < kwarps;
  const int tiles = ((B + rows - 1) / rows - (int)blockIdx.y +
                     (int)gridDim.y - 1) / (int)gridDim.y;
  const unsigned blocks = gridDim.x * gridDim.y;

  // W's slice as B fragments: k8 step s of the warp's slice is k16 block
  // s / 2, its slot tq (tq + 4) element 4 tq + 2 (s % 2) (+ 1), as a_frag
  // permutes dgates; column g of n8 tile j is unit u0 + 8 j + g; a lane's
  // float4 holds (j 0: e 0, 1; j 1: e 0, 1). Only the lane that writes a
  // fragment reads it.
  for (int s = 0; s < 2 * kb; ++s) {
    const int k = k0 + 16 * (s / 2) + 4 * tq + 2 * (s % 2);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int u = u0 + 8 * (e / 2) + g, ke = k + e % 2;
      v[e] = u < H && ke < K ? __ldg(w + (long)u * K + ke) : 0.f;
    }
    wl[32 * s] = make_float4(v[0], v[1], v[2], v[3]);
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
    const float* dg = dx + (long)(t + 1) * B * K;  // dgates_{t+1}
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
          float* dxb = dx + ((long)t * B + b) * K + u;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dxb[q * H] = dg4[q];
            dbs[q] += dg4[q];
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
// The per-step path's product, dgates_t W^T in K slices: C[z][m][n] = sum
// over k in slice z of A[m lda + k] B[n ldb + k]. Slice z covers k in
// [z kps, (z + 1) kps).
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 32;

__global__ void __launch_bounds__(kThreads)
lstm_gemm_kernel(const float* __restrict__ A, long lda,
                 const float* __restrict__ Bm, long ldb, float* __restrict__ C,
                 long ldc, long slice_stride, int M, int N, int K, int kps) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * kps;
  const int ke = min(K, kb + kps);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = kb; k0 < ke; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kBM * kBK / kThreads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int mm = e / kBK, kk = e % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = gm < M && gk < ke ? A[gm * lda + gk] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBN * kBK / kThreads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int nn = e / kBK, kk = e % kBK;
      const int gn = n0 + nn, gk = k0 + kk;
      Bs[kk][nn] = gn < N && gk < ke ? Bm[gn * ldb + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* Cz = C + blockIdx.z * slice_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) Cz[gm * ldc + gn] = acc[i][j];
    }
  }
}

int launch_gemm(const float* A, long lda, const float* Bm, long ldb, float* C,
                long ldc, long slice_stride, int M, int N, int K, int slices,
                cudaStream_t s) {
  const int kps = ((K + slices - 1) / slices + kBK - 1) / kBK * kBK;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, slices);
  lstm_gemm_kernel<<<grid, kThreads, 0, s>>>(A, lda, Bm, ldb, C, ldc,
                                             slice_stride, M, N, K, kps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the backward's whole-sequence products on tensor cores:
// C[m][n] = (addend[m][n] +) sum over k of A(m, k) B[k][n] (+ bias[n]),
// A(m, k) = A[m lda + k] if A_K (the gates' recompute: r_prevs W), else
// A[k lda + m] (dW = r_prevs^T dx); B row-major [K][N], N % 4 == 0.
// ---------------------------------------------------------------------------

namespace tc {

// A block owns BM x BN of C: 8 warps, 2 x 4, of 32 x 32 (kMT = 2 m16 x 4
// n8 tiles, 32 accumulators a thread; tiles of 32 rows, twice the blocks,
// were slower: PERF.md). K streams in stages of 16 through a ring
// of 3 in shared memory, two stages ahead: A as [BM][16] at a pitch of 20
// (A_K) or [16][BM] at a pitch of BM + 8, B as [16][BN] at BN + 8, so
// that a fragment's 8 rows x 4 k fall on 32 banks. 3xTF32 with a fresh
// fragment each k8 step (tf32_mma.cuh's mma3), k in order: two calls give
// the same bits.
constexpr int kMT = 2, kBM = 32 * kMT, kBN = 128, kRing = 3;
constexpr int kAPitchK = 20, kAPitchM = kBM + 8, kBPitch = kBN + 8;
constexpr int kAStage = kBM * kAPitchK > 16 * kAPitchM ? kBM * kAPitchK
                                                        : 16 * kAPitchM;
constexpr int kBStage = 16 * kBPitch;

// 16 bytes from src (4 floats, each in bounds where ok[e]) to dst:
// one 16-byte copy where vec, else four 4-byte ones.
__device__ __forceinline__ void copy_chunk(float* dst, const float* src,
                                           bool vec, const bool (&ok)[4],
                                           const float* base) {
  if (vec) {
    copy16(dst, ok[0] ? src : base, ok[0]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) copy4(dst + e, ok[e] ? src + e : base, ok[e]);
  }
}

template <bool A_K>
__global__ void __launch_bounds__(kThreads, 2)
lstm_bwd_gemm_tc_kernel(const float* __restrict__ A, long lda,
                        const float* __restrict__ Bm, long ldb,
                        float* __restrict__ C, long ldc,
                        const float* __restrict__ addend,
                        const float* __restrict__ bias, int M, int N, int K,
                        bool vec_a, bool vec_b) {
  __shared__ __align__(16) float As[kRing][kAStage];
  __shared__ __align__(16) float Bs[kRing][kBStage];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int stages = (K + 15) / 16;

  // a stage: A's 256 16-byte chunks, one a thread; B's 512, two
  const auto issue = [&](int st) {
    if (st < stages) {
      const int k0 = 16 * st, slot = st % kRing;
      const int c = threadIdx.x;
      bool ok[4];
      if (A_K) {  // row m0 + c / 4, k0 + 4 (c % 4) .. + 3
        const int m = m0 + c / 4, k = k0 + 4 * (c % 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) ok[e] = m < M && k + e < K;
        copy_chunk(&As[slot][(c / 4) * kAPitchK + 4 * (c % 4)],
                   A + (long)m * lda + k, vec_a, ok, A);
      } else {  // row k0 + c / 16, m0 + 4 (c % 16) .. + 3
        const int k = k0 + c / 16, m = m0 + 4 * (c % 16);
#pragma unroll
        for (int e = 0; e < 4; ++e) ok[e] = k < K && m + e < M;
        copy_chunk(&As[slot][(c / 16) * kAPitchM + 4 * (c % 16)],
                   A + (long)k * lda + m, vec_a, ok, A);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // row k0 + cc / 32, n0 + 4 (cc % 32)
        const int cc = c + kThreads * h;
        const int k = k0 + cc / 32, n = n0 + 4 * (cc % 32);
#pragma unroll
        for (int e = 0; e < 4; ++e) ok[e] = k < K && n + e < N;
        copy_chunk(&Bs[slot][(cc / 32) * kBPitch + 4 * (cc % 32)],
                   Bm + (long)k * ldb + n, vec_b, ok, Bm);
      }
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
    const float* sa = As[st % kRing];
    const float* sb = Bs[st % kRing];
#pragma unroll
    for (int kk = 0; kk < 16; kk += 8) {
      uint32_t ab[1][kMT][4], asl[1][kMT][4], bb[1][4][2], bsl[1][4][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int r = wm * 16 * kMT + 16 * i + g;
        float a[4];
        if (A_K) {
          const float* p = sa + r * kAPitchK + kk + tq;
          a[0] = p[0];
          a[1] = p[8 * kAPitchK];
          a[2] = p[4];
          a[3] = p[8 * kAPitchK + 4];
        } else {
          const float* p = sa + (kk + tq) * kAPitchM + r;
          a[0] = p[0];
          a[1] = p[8];
          a[2] = p[4 * kAPitchM];
          a[3] = p[4 * kAPitchM + 8];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) split(a[e], ab[0][i][e], asl[0][i][e]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* p = sb + (kk + tq) * kBPitch + wn * 32 + 8 * j + g;
        split(p[0], bb[0][j][0], bsl[0][j][0]);
        split(p[4 * kBPitch], bb[0][j][1], bsl[0][j][1]);
      }
      mma3<1, kMT, 4, 4>(acc, ab, asl, bb, bsl, 0);
    }
  }
  // (addend + acc) + bias, as the plain version adds them
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
          if (addend != nullptr) v = addend[(long)m * ldc + n] + v;
          if (bias != nullptr) v = v + bias[n];
          C[(long)m * ldc + n] = v;
        }
    }
}

template <bool A_K>
int launch(const float* A, long lda, const float* Bm, long ldb, float* C,
           long ldc, const float* addend, const float* bias, int M, int N,
           int K, bool vec_a, cudaStream_t s) {
  const bool vec_b = ldb % 4 == 0 && reinterpret_cast<uintptr_t>(Bm) % 16 == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  lstm_bwd_gemm_tc_kernel<A_K><<<grid, kThreads, 0, s>>>(
      A, lda, Bm, ldb, C, ldc, addend, bias, M, N, K, vec_a, vec_b);
  return (int)cudaGetLastError();
}

// gates [R, 4H] = x + r_prevs w + b and dw [H, 4H] = r_prevs^T dx, over
// the R = T B rows
inline int gates(const float* x, const float* w, const float* b,
                 const float* r_prevs, float* out, int R, int H,
                 cudaStream_t s) {
  const bool vec = H % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(r_prevs) % 16 == 0;
  return launch<true>(r_prevs, H, w, 4L * H, out, 4L * H, x, b, R, 4 * H, H,
                      vec, s);
}
inline int dw(const float* r_prevs, const float* dx, float* out, int R,
              int H, cudaStream_t s) {
  const bool vec = H % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(r_prevs) % 16 == 0;
  return launch<false>(r_prevs, H, dx, 4L * H, out, 4L * H, nullptr, nullptr,
                       H, 4 * H, R, vec, s);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// backward step: the cell
// ---------------------------------------------------------------------------

// One thread per (b, u). The carried dr is drb (the masked pass-through
// written by the previous cell launch) plus the S slices of dgates W^T,
// added in slice order; `first` (t = T-1) starts both carries at zero.
__global__ void __launch_bounds__(kThreads)
lstm_bwd_cell_kernel(const float* __restrict__ g_t,
                     const float* __restrict__ cp_t,
                     const float* __restrict__ m_t,
                     const float* __restrict__ drs_t,
                     const float* __restrict__ dcs_t,
                     const float* __restrict__ part, int S,
                     float* __restrict__ drb, float* __restrict__ dc,
                     float* __restrict__ dx_t, int B, int H, int first) {
  const long idx = (long)blockIdx.x * kThreads + threadIdx.x;
  const long n = (long)B * H;
  if (idx >= n) return;
  const int b = (int)(idx / H), u = (int)(idx % H);
  float d_rt = drs_t[idx];
  float d_ct = dcs_t[idx];
  if (!first) {
    float carry = drb[idx];
    for (int s = 0; s < S; ++s) carry += part[s * n + idx];
    d_rt = carry + d_rt;
    d_ct = dc[idx] + d_ct;
  }
  const long h4 = 4L * H;
  const float* g = g_t + b * h4;
  const float i = sigmoid(g[u]), cand = tanhf(g[H + u]);
  const float f = sigmoid(g[2 * H + u]), o = sigmoid(g[3 * H + u]);
  const float cp = cp_t[idx];
  const float c_new = f * cp + i * cand;
  const float tc = tanhf(c_new);
  const float m = m_t[b];
  const float dr_new = d_rt * m, dr_prev = d_rt * (1.f - m);
  float dc_new = d_ct * m, dc_prev = d_ct * (1.f - m);
  const float d_o = dr_new * tc;
  dc_new = dc_new + dr_new * o * (1.f - tc * tc);
  const float d_f = dc_new * cp, d_i = dc_new * cand, d_cand = dc_new * i;
  dc_prev = dc_prev + dc_new * f;
  float* dxb = dx_t + b * h4;
  dxb[u] = d_i * i * (1.f - i);
  dxb[H + u] = d_cand * (1.f - cand * cand);
  dxb[2 * H + u] = d_f * f * (1.f - f);
  dxb[3 * H + u] = d_o * o * (1.f - o);
  drb[idx] = dr_prev;
  dc[idx] = dc_prev;
}

// dr0 = drb + the S slices of dgates_0 W^T, in slice order.
__global__ void __launch_bounds__(kThreads)
lstm_bwd_final_kernel(const float* __restrict__ part, int S,
                      const float* __restrict__ drb, float* __restrict__ dr0,
                      long n) {
  const long idx = (long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  float carry = drb[idx];
  for (int s = 0; s < S; ++s) carry += part[s * n + idx];
  dr0[idx] = carry;
}

// db[k] = sum over the R rows of dx[r][k]: block of 32 columns x 8 row
// groups; group g sums rows g, g + 8, ... in order, then group 0 adds the
// 8 group sums in order.
__global__ void __launch_bounds__(kThreads)
lstm_bwd_db_kernel(const float* __restrict__ dx, float* __restrict__ db,
                   long R, int N) {
  __shared__ float sh[8][32];
  const int lane = threadIdx.x % 32, grp = threadIdx.x / 32;
  const int k = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (k < N)
    for (long r = grp; r < R; r += 8) s += dx[r * N + k];
  sh[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && k < N) {
    float t = 0.f;
    for (int g = 0; g < 8; ++g) t += sh[g][lane];
    db[k] = t;
  }
}

}  // namespace

// x [T, B, 4H], w [H, 4H], b [4H], mask [T, B], r0 and c0 [B, H]; rs and cs
// [T, B, H] out. All float32, contiguous. One cooperative launch of the
// sequence kernel on `stream`: mt 16-row tiles make a row tile (1 or 2),
// kb k16 blocks a warp (1 to 4, 8 x 16 kb >= H), nt row tiles at most a
// block (1 to 64; the grid's rows of blocks are the fewest that give no
// block more); bar two unsigned counters at 0, set back to 0 by the
// launch (a buffer of the stream's own). Returns a cudaError_t (0 =
// launched; cudaErrorCooperativeLaunchTooLarge where the grid cannot be
// resident at once).
extern "C" int lstm_seq_fwd_seq_f32(const float* x, const float* w,
                                    const float* b, const float* mask,
                                    const float* r0, const float* c0,
                                    float* rs, float* cs, unsigned* bar,
                                    int T, int B, int H, int mt, int kb,
                                    int nt, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || mt < 1 || mt > seq::kMaxMT || kb < 1 ||
      kb > seq::kMaxKB || seq::kWarps * 16 * kb < H || nt < 1 ||
      nt > seq::kMaxNT)
    return (int)cudaErrorInvalidValue;
  const int tiles = (B + 16 * mt - 1) / (16 * mt);
  const int gy = (tiles + nt - 1) / nt;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const int smem = seq::smem_bytes(mt, kb, nt);
  const cudaError_t e = seq::set_smem(seq::lstm_fwd_seq_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((H + seq::kUnits - 1) / seq::kUnits, gy);
  void* args[] = {&x, &w, &b, &mask, &r0, &c0, &rs, &cs, &bar,
                  &T, &B, &H, &mt, &kb, &nt};
  return (int)cudaLaunchCooperativeKernel(
      seq::lstm_fwd_seq_kernel, grid, dim3(kThreads), args, smem,
      static_cast<cudaStream_t>(stream));
}

// Blocks of the sequence kernel at (mt, kb, nt) that an SM holds at
// once, into *out. Returns a cudaError_t.
extern "C" int lstm_fwd_blocks_per_sm(int mt, int kb, int nt, int* out) {
  if (mt < 1 || mt > seq::kMaxMT || kb < 1 || kb > seq::kMaxKB || nt < 1 ||
      nt > seq::kMaxNT)
    return (int)cudaErrorInvalidValue;
  const int smem = seq::smem_bytes(mt, kb, nt);
  const cudaError_t e = seq::set_smem(seq::lstm_fwd_seq_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, seq::lstm_fwd_seq_kernel, kThreads, smem);
}

// Blocks of the backward's sequence kernel at (mt, kb, nt) that an SM
// holds at once, into *out. Returns a cudaError_t.
extern "C" int lstm_bwd_blocks_per_sm(int mt, int kb, int nt, int* out) {
  if (mt != 1 || kb < 1 || kb > seq::kMaxKBB || nt < 1 || nt > seq::kMaxNTB)
    return (int)cudaErrorInvalidValue;
  const int smem = seq::bwd_smem_bytes(kb, nt);
  const cudaError_t e = seq::set_smem(seq::lstm_bwd_seq_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, seq::lstm_bwd_seq_kernel, kThreads, smem);
}

// The same function in T launches of the step kernel on `stream` (the
// forward for the shapes no sequence-kernel plan takes). Returns a
// cudaError_t (0 = launched).
extern "C" int lstm_seq_fwd_f32(const float* x, const float* w,
                                const float* b, const float* mask,
                                const float* r0, const float* c0, float* rs,
                                float* cs, int T, int B, int H,
                                void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || (B + kFB - 1) / kFB > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((H + kFU - 1) / kFU, (B + kFB - 1) / kFB);
  const long bh = (long)B * H;
  for (int t = 0; t < T; ++t) {
    const float* rp = t == 0 ? r0 : rs + (t - 1) * bh;
    const float* cp = t == 0 ? c0 : cs + (t - 1) * bh;
    lstm_fwd_step_kernel<<<grid, kThreads, 0, s>>>(
        x + t * 4 * bh, w, b, mask + (long)t * B, rp, cp, rs + t * bh,
        cs + t * bh, B, H);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// x, dx [T, B, 4H]; w [H, 4H]; b [4H]; mask [T, B]; r_prevs, c_prevs, drs,
// dcs [T, B, H] (element t of r_prevs / c_prevs holds the carry of step
// t-1, r0 / c0 at t = 0); dw [H, 4H], db [4H], dr0, dc0 [B, H] out.
// Scratch: gates [T, B, 4H], part [S, B, H], drb [B, H]. S slices of the
// per-step dgates W^T product. All float32, contiguous. 2T + 4 launches on
// `stream`. Returns a cudaError_t (0 = launched).
extern "C" int lstm_seq_bwd_f32(const float* x, const float* w,
                                const float* b, const float* mask,
                                const float* r_prevs, const float* c_prevs,
                                const float* drs, const float* dcs, float* dx,
                                float* dw, float* db, float* dr0, float* dc0,
                                float* gates, float* part, float* drb, int T,
                                int B, int H, int S, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || S <= 0 || S > 65535 ||
      ((long)T * B + tc::kBM - 1) / tc::kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long bh = (long)B * H, h4 = 4L * H;
  const int R = T * B;
  int e = tc::gates(x, w, b, r_prevs, gates, R, H, s);
  if (e != 0) return e;
  const int cell_grid = (int)((bh + kThreads - 1) / kThreads);
  for (int t = T - 1; t >= 0; --t) {
    lstm_bwd_cell_kernel<<<cell_grid, kThreads, 0, s>>>(
        gates + t * B * h4, c_prevs + t * bh, mask + (long)t * B,
        drs + t * bh, dcs + t * bh, part, S, drb, dc0, dx + t * B * h4, B, H,
        t == T - 1);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
    // part[z][b][j] = sum over k in slice z of dgates_t[b][k] w[j][k]
    e = launch_gemm(dx + t * B * h4, h4, w, h4, part, H, bh, B, H, (int)h4,
                    S, s);
    if (e != 0) return e;
  }
  lstm_bwd_final_kernel<<<cell_grid, kThreads, 0, s>>>(part, S, drb, dr0, bh);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  e = tc::dw(r_prevs, dx, dw, R, H, s);
  if (e != 0) return e;
  lstm_bwd_db_kernel<<<(int)((h4 + 31) / 32), kThreads, 0, s>>>(dx, db, R,
                                                                 (int)h4);
  return (int)cudaGetLastError();
}

// The same function with the recurrence in one cooperative launch of the
// backward's sequence kernel: the gates' recompute, the sequence kernel
// (dx, db, dr0, dc0), dW; 3 launches on `stream`. mt 1 (row tiles of 16),
// kb k16 blocks a warp (1 to 16, 8 x 16 kb >= 4H), nt row tiles at most a
// block (1 to 32; the grid's rows of blocks are the fewest that give no
// block more); dbp [row groups, 4H] scratch
// for db's partial sums; bar as the forward's. Returns a cudaError_t (0 =
// launched; cudaErrorCooperativeLaunchTooLarge where the grid cannot be
// resident at once).
extern "C" int lstm_seq_bwd_seq_f32(
    const float* x, const float* w, const float* b, const float* mask,
    const float* r_prevs, const float* c_prevs, const float* drs,
    const float* dcs, float* dx, float* dw, float* db, float* dr0,
    float* dc0, float* gates, float* dbp, unsigned* bar, int T, int B, int H,
    int mt, int kb, int nt, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || mt != 1 || kb < 1 ||
      kb > seq::kMaxKBB || seq::kWarps * 16 * kb < 4 * H || nt < 1 ||
      nt > seq::kMaxNTB || ((long)T * B + tc::kBM - 1) / tc::kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles = (B + 15) / 16;
  const int gy = (tiles + nt - 1) / nt;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = T * B;
  int e = tc::gates(x, w, b, r_prevs, gates, R, H, s);
  if (e != 0) return e;
  const int smem = seq::bwd_smem_bytes(kb, nt);
  e = (int)seq::set_smem(seq::lstm_bwd_seq_kernel, smem);
  if (e != 0) return e;
  const dim3 grid((H + seq::kUnitsB - 1) / seq::kUnitsB, gy);
  const float* cgates = gates;
  void* args[] = {&cgates, &w,   &mask, &c_prevs, &drs, &dcs, &dx, &db,
                  &dbp,    &dr0, &dc0,  &bar,     &T,   &B,   &H,  &kb, &nt};
  e = (int)cudaLaunchCooperativeKernel(seq::lstm_bwd_seq_kernel, grid,
                                       dim3(kThreads), args, smem, s);
  if (e != 0) return e;
  return tc::dw(r_prevs, dx, dw, R, H, s);
}
