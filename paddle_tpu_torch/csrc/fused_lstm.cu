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
// recompute, dgates @ W^T and dW) and ~157 MB. In practice the recurrence
// bounds them: step t needs all of r_{t-1}, so each step is a [B, H] x
// [H, 4H] product that cannot start before the previous one ends, and at
// B 64 one step is too little work to fill 132 SMs for long. The time is
// per-step latency.
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
//   Backward: the gates of every step are recomputed at once by one tiled
//   product G = X + R_prev W + b (R_prev is known). Then each step t, from
//   T-1 down to 0, is two launches, because dr_{t-1} for any unit needs
//   all of dgates_t: (1) a cell kernel, one thread per (row, unit), turns
//   the carried (dr, dc) and the step's cotangents into dgates_t (written
//   to dx) and the masked carries; (2) dgates_t W^T in K slices, each
//   slice's partial product into its own buffer. The next step's cell
//   kernel adds the slices in a fixed order: no atomics, deterministic.
//   dW = R_prev^T dx is one tiled product over the T*B rows after the
//   loop, db a column sum in a fixed order: also deterministic.
// The product kernel is one template (64 x 64 tiles, 4 x 4 outputs a
// thread, 32-deep shared-memory stages) over the three operand layouts.
// Every stage issues all its loads before its first shared-memory store.
// Transcendentals are expf/tanhf (no fast-math intrinsics).
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
  // the last block out sets the counters back to 0: every block has
  // passed every barrier by then
  if (threadIdx.x == 0 && atomicAdd(bar + 1, 1u) == blocks - 1) {
    bar[0] = 0u;
    bar[1] = 0u;
  }
}

// 0, or the cudaError_t of setting the kernel's shared memory to `bytes`
inline cudaError_t set_smem(int bytes) {
  return cudaFuncSetAttribute(lstm_fwd_seq_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace seq

// ---------------------------------------------------------------------------
// tiled product: C[z][m][n] = sum over k in slice z of A(m, k) B(k, n)
// (+ addend[m][n]) (+ bias[n]). A(m, k) is A[m * lda + k] if A_K (k
// contiguous), else A[k * lda + m]; B(k, n) is B[n * ldb + k] if B_K,
// else B[k * ldb + n]. Slice z covers k in [z * kps, (z + 1) * kps).
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 32;

template <bool A_K, bool B_K>
__global__ void __launch_bounds__(kThreads)
lstm_gemm_kernel(const float* __restrict__ A, long lda,
                 const float* __restrict__ Bm, long ldb, float* __restrict__ C,
                 long ldc, long slice_stride, const float* __restrict__ addend,
                 const float* __restrict__ bias, int M, int N, int K,
                 int kps) {
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
      const int mm = A_K ? e / kBK : e % kBM;
      const int kk = A_K ? e % kBK : e / kBM;
      const int gm = m0 + mm, gk = k0 + kk;
      float v = 0.f;
      if (gm < M && gk < ke)
        v = A_K ? A[gm * lda + gk] : A[gk * lda + gm];
      As[kk][mm] = v;
    }
#pragma unroll
    for (int j = 0; j < kBN * kBK / kThreads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int nn = B_K ? e / kBK : e % kBN;
      const int kk = B_K ? e % kBK : e / kBN;
      const int gn = n0 + nn, gk = k0 + kk;
      float v = 0.f;
      if (gn < N && gk < ke)
        v = B_K ? Bm[gn * ldb + gk] : Bm[gk * ldb + gn];
      Bs[kk][nn] = v;
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
      if (gn >= N) continue;
      float v = acc[i][j];
      if (addend != nullptr) v = addend[gm * ldc + gn] + v;
      if (bias != nullptr) v = v + bias[gn];
      Cz[gm * ldc + gn] = v;
    }
  }
}

template <bool A_K, bool B_K>
int launch_gemm(const float* A, long lda, const float* Bm, long ldb, float* C,
                long ldc, long slice_stride, const float* addend,
                const float* bias, int M, int N, int K, int slices,
                cudaStream_t s) {
  const int kps = ((K + slices - 1) / slices + kBK - 1) / kBK * kBK;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, slices);
  lstm_gemm_kernel<A_K, B_K><<<grid, kThreads, 0, s>>>(
      A, lda, Bm, ldb, C, ldc, slice_stride, addend, bias, M, N, K, kps);
  return (int)cudaGetLastError();
}

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
  const cudaError_t e = seq::set_smem(smem);
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
  const cudaError_t e = seq::set_smem(smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, seq::lstm_fwd_seq_kernel, kThreads, smem);
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
      ((long)T * B + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long bh = (long)B * H, h4 = 4L * H;
  const int R = T * B;
  // gates of every step: x + r_prevs @ w + b
  int e = launch_gemm<true, false>(r_prevs, H, w, h4, gates, h4, 0, x, b, R,
                                   (int)h4, H, 1, s);
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
    e = launch_gemm<true, true>(dx + t * B * h4, h4, w, h4, part, H, bh,
                                nullptr, nullptr, B, H, (int)h4, S, s);
    if (e != 0) return e;
  }
  lstm_bwd_final_kernel<<<cell_grid, kThreads, 0, s>>>(part, S, drb, dr0, bh);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  // dw[j][k] = sum over the T*B rows r of r_prevs[r][j] dx[r][k]
  e = launch_gemm<false, false>(r_prevs, H, dx, h4, dw, h4, 0, nullptr,
                                nullptr, H, (int)h4, R, 1, s);
  if (e != 0) return e;
  lstm_bwd_db_kernel<<<(int)((h4 + 31) / 32), kThreads, 0, s>>>(dx, db, R,
                                                                 (int)h4);
  return (int)cudaGetLastError();
}
