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
// at the 67 TFLOP/s float32 peak) and moves ~83 MB (0.025 ms); the
// backward 40.3 GFLOP (0.601 ms: the gate recompute, dgates @ W^T and dW)
// and ~157 MB. In practice the recurrence bounds them: step t needs all
// of r_{t-1}, so each step is a [B, H] x [H, 4H] product that cannot start
// before the previous one ends, and at B 64 one step is too little work
// to fill 132 SMs for long. The time is per-step latency.
//
// What the design does about it. The TPU kernel keeps W [H, 4H] in one
// core's VMEM across a sequential grid; here W at H 512 is 4 MiB, more than
// an SM's shared memory, but it stays in the 50 MB L2 from step to step.
//   Forward: one launch per step (the step loop runs in the C entry, on
//   the caller's stream, so Python pays one call per sequence). A block
//   owns 16 hidden units, all four gate columns of each, and 16 batch
//   rows, so the gate nonlinearities and the (r, c) update stay inside the
//   block: 256 threads, one (row, unit) each with its four gate sums, over
//   128-deep shared-memory stages of r and of W's columns (40 KB). At
//   B 64, H 512 that is 128 blocks a step and 4 stages.
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
// [T, B, H] out. All float32, contiguous. T launches of the step kernel
// on `stream`. Returns a cudaError_t (0 = launched).
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
