// bwd_mid for Hopper (sm_90a): the 3x3's input gradient and its tap
// gradients, both on tensor cores in 3xTF32 over tiles of the padded grid.
// Included by fused_block_bwd.cu only.
//
// Replaces the Pallas body _b2_kernel of bwd_mid in
// paddle_tpu/kernels/fused_block.py:295-388 (pallas_call at :399). For
// g2, a2, a1 [N, C, H*W], taps [9, C, C] ([(dy+1)*3 + (dx+1)], [Cout,
// Cin]) and bn2 folded into p2, q2, r2 [C]:
//   da2 = g2 * p2 + a2 * q2 + r2;
//   dh1[p] = sum_t taps[t]^T da2[p - off_t] (da2 padded with 0, never r2),
//   g1 = dh1 where a1 * sc1 + sh1 > 0, and bn1's sum g1, sum g1 * xhat1;
//   dtaps[t] = sum_{n,p} da2[p] h1[p + off_t]^T, h1 = relu(a1 * sc1 + sh1)
//   padded with 0 (never relu(sh1)).
//
// What bounds it on the H100 (batch 128; C, S = 64, 3136 / 128, 784 /
// 256, 196): two products of 29.6 GFLOP at every stage, 0.89 ms at the 67
// TFLOP/s float32 FMA rate; as three TF32 products each, 177.6 GFLOP of
// tensor-core work, 0.36 ms at the 495 TFLOP/s dense TF32 rate. The 0.41
// GB of g2, a2, a1 and g1 take 0.12 ms at 3.35 TB/s. Operations bound it.
//
// The design, three launches and the two fixed-order passes:
//   - fold: da2 written once, [N, C, S] scratch (103 MB at 56x56, 0.09 ms
//     of traffic). Both products then read one source through one copy a
//     value. Folding on landing instead would need a second landing
//     buffer in the input gradient's ring (113 KB a block at 56, two
//     blocks an SM with no room to spare) and the same again in the tap
//     gradients, which would fold every value once for each dy row.
//   - the input gradient: conv3x3_tc.cuh's kernel, the forward's 3x3 on
//     tensor cores, over da2 (AsIs: the halo takes da2 as it lands, 0
//     outside the image) by taps_t[t] = taps[8 - t]^T, which the wrapper
//     makes with one permutation (9 C^2 floats). Its epilogue (MaskedStats)
//     masks with a1 and writes g1 and the row partials of bn1's sums.
//   - the tap gradients: one split-K product over K = the positions of the
//     padded grid (width W + 2, its two extra columns 0 in da2), all nine
//     taps in three blocks, one a dy row. A block owns 64 rows of Cout, 64
//     of Cin, one dy and a split: a range of 32-position pieces of the
//     images' grids. A stage holds da2 [64 co][32 positions] and h1 [64
//     ci][34 positions] from dy * (W + 2) on, both 4-byte cp.async
//     (zero-filled outside the image and past C), h1 normalized once a
//     value by the thread that copied it. The three taps of the row read
//     the h1 rows at offsets 0, 1, 2: no pixel is decoded per tap, and no
//     operand is loaded once for each tap. K is the position, so
//     mma.sync.m16n8k8.row.col takes A straight from da2's [co][pos] rows
//     and B from h1's [ci][pos] rows; a pitch of 36 floats (4 mod 32) puts
//     either fragment's 8 rows x 4 positions on 32 banks at any offset.
//     8 warps as 2 (co) x 4 (ci), each 32 x 16 for three taps: 48
//     accumulators a thread. A ring of 3 stages, copies one ahead, one
//     barrier a stage (as in conv3x3_tc.cuh), two blocks an SM.
//   - 3xTF32 as in conv3x3_tc.cuh, splits in registers as fragments are
//     read; each k8 step's three products of a tile go into a fresh
//     fragment, added in float32 (the tensor cores truncate as they
//     accumulate). Each split writes its partial dtaps into part [splits,
//     9, C, C]; finish_splits adds them in split order. No atomics: two
//     calls are bit-identical.
//
// Registers (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 128 a thread in both
// products, the bound two blocks an SM set; the tap gradients spill
// nothing, the input gradient's instance 4 bytes (in its epilogue).
//
// What holds it back (PERF.md, row 12; scripts/torch_bwd_mid_probe.py):
// the input gradient is the forward's kernel, ~0.71-0.77 ms a stage; the
// tap gradients' product alone runs its mma at ~155-165 TFLOP/s, held
// back by the instructions around it (fragment reads, splits, fresh
// fragments' adds): a build with each mma replaced by integer work is no
// faster.
#pragma once

#include <cstdint>

#include "conv3x3_tc.cuh"
#include "fused_block.cuh"

namespace {
namespace bwd_mid {

using conv3x3::kMT;
using conv3x3::kNT;
using conv3x3::Tile;

// ---- the input gradient: conv3x3_tc.cuh's policies ---------------------------

// Land policy: da2 as it lands.
struct AsIs {
  __device__ __forceinline__ float2 channel(int) const {
    return make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ float value(float v, float2) const { return v; }
};

// Out policy: g1 = acc where a * sc + sh > 0, else 0, at the kept
// positions of [N, M, S]; each row's partial sums of g1 and of g1 * (a *
// inv - mean * inv) into red.
struct MaskedStats {
  const float* a;
  const float* sc;
  const float* sh;
  const float* inv;
  const float* mean;
  float* g;
  __device__ __forceinline__ void store(const float (&acc)[kMT][kNT][4],
                                        const int (&off)[kNT][2],
                                        const Tile& tl, int wm, int wn,
                                        int gq, int t, int M, int S,
                                        float* red) const {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int lr = 32 * wm + 16 * i + gq + 8 * hr, m = tl.m0 + lr;
        float s = 0.f, q = 0.f;
        if (m < M) {
          const long row = ((long)tl.n * M + m) * S;
          const float scm = __ldg(sc + m), shm = __ldg(sh + m);
          const float im = __ldg(inv + m), xs = -__ldg(mean + m) * im;
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (off[j][c] >= 0) {
                const float av = __ldg(a + row + off[j][c]);
                const float v =
                    positive(av, scm, shm) ? acc[i][j][2 * hr + c] : 0.f;
                g[row + off[j][c]] = v;
                s += v;
                q = fmaf(v, fmaf(av, im, xs), q);
              }
        }
        red[lr * 16 + wn * 4 + t] = s;
        red[(conv3x3::kBM + lr) * 16 + wn * 4 + t] = q;
      }
  }
};

// da2 = g2 * p + a2 * q + r. Block (n * C + c, a run of 256 positions).
__global__ void __launch_bounds__(kThreads)
bwd_mid_fold_kernel(const float* __restrict__ g2, const float* __restrict__ a2,
                    const float* __restrict__ p, const float* __restrict__ q,
                    const float* __restrict__ r, float* __restrict__ da2,
                    int C, int S) {
  const int s = blockIdx.y * kThreads + threadIdx.x;
  if (s >= S) return;
  const int c = blockIdx.x % C;
  const long e = (long)blockIdx.x * S + s;
  da2[e] = fmaf(__ldg(g2 + e), __ldg(p + c),
                fmaf(__ldg(a2 + e), __ldg(q + c), __ldg(r + c)));
}

// ---- the tap gradients -------------------------------------------------------

constexpr int kBM = 64;                  // rows of Cout a block
constexpr int kBN = 64;                  // rows of Cin a block
constexpr int kKP = 32;                  // positions a stage: 4 k8 steps
constexpr int kPitch = 36;               // 4 mod 32: conflict-free fragments
constexpr int kStage = (kBM + kBN) * kPitch;
constexpr int kRing = 3;
constexpr int kSmem = kRing * kStage * (int)sizeof(float);

// 32-position pieces of an image's padded grid of H rows of W + 2.
__host__ __device__ inline int pieces(int H, int W) {
  return (int)(((long)H * (W + 2) + kKP - 1) / kKP);
}

// 4 bytes, zero-filled unless ok (src is then not read).
__device__ __forceinline__ void copy4z(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   conv3x3::shared_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// Where a block works: its rows of Cout and of Cin, its dy row of taps,
// the image geometry.
struct WTile {
  int m0, n0, dy, C, H, W, Wp, S, ppi;
  // the pixel of output position q of the padded grid, -1 for one of its
  // two extra columns or past its end
  __device__ __forceinline__ int out_pixel(int q) const {
    const int y = q / Wp, x = q - y * Wp;
    return (y < H && x < W) ? y * W + x : -1;
  }
  // the pixel of position r of the zero-bordered grid, -1 on its border
  __device__ __forceinline__ int pad_pixel(int r) const {
    const int y = r / Wp, x = r - y * Wp;
    return (y >= 1 && y <= H && x >= 1 && x <= W) ? (y - 1) * W + x - 1 : -1;
  }
};

// The copies of piece j (image n, positions q0..q0+31) into stage st:
// da2 rows co at q0 + col, h1 rows ci at q0 + dy * Wp + col (thread: column
// tid % 32 of rows tid / 32 + 8k; the h1 rows' columns 32 and 33 by the
// threads tid < 128).
__device__ __forceinline__ void copy_stage(float* st, int j,
                                           const float* __restrict__ da2,
                                           const float* __restrict__ a1,
                                           const WTile& tl) {
  const int n = j / tl.ppi, q0 = (j - n * tl.ppi) * kKP;
  const int col = threadIdx.x & 31, row = threadIdx.x >> 5;
  const long img = (long)n * tl.C * tl.S;
  const int pd = tl.out_pixel(q0 + col);
  const int r0 = q0 + tl.dy * tl.Wp;
  const int ph = tl.pad_pixel(r0 + col);
  float* hs = st + kBM * kPitch;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int r = row + 8 * k, co = tl.m0 + r, ci = tl.n0 + r;
    const bool okd = pd >= 0 && co < tl.C, okh = ph >= 0 && ci < tl.C;
    copy4z(st + r * kPitch + col, da2 + img + (okd ? (long)co * tl.S + pd : 0),
           okd);
    copy4z(hs + r * kPitch + col, a1 + img + (okh ? (long)ci * tl.S + ph : 0),
           okh);
  }
  if (threadIdx.x < 2 * kBN) {
    const int r = threadIdx.x >> 1, c = kKP + (threadIdx.x & 1);
    const int ci = tl.n0 + r, p = tl.pad_pixel(r0 + c);
    const bool ok = p >= 0 && ci < tl.C;
    copy4z(hs + r * kPitch + c, a1 + img + (ok ? (long)ci * tl.S + p : 0), ok);
  }
}

// The thread's own h1 slots of landed piece j, normalized in place:
// relu(a1 * sc + sh) inside the image, 0 outside (rows past C hold 0 with
// sc = sh = 0).
__device__ __forceinline__ void normalize(float* st, int j, const float* ksc,
                                          const float* ksh, const WTile& tl) {
  const int n = j / tl.ppi, q0 = (j - n * tl.ppi) * kKP;
  const int col = threadIdx.x & 31, row = threadIdx.x >> 5;
  const int r0 = q0 + tl.dy * tl.Wp;
  float* hs = st + kBM * kPitch;
  const bool in = tl.pad_pixel(r0 + col) >= 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int r = row + 8 * k;
    float* v = hs + r * kPitch + col;
    *v = in ? relu_affine(*v, ksc[r], ksh[r]) : 0.f;
  }
  if (threadIdx.x < 2 * kBN) {
    const int r = threadIdx.x >> 1, c = kKP + (threadIdx.x & 1);
    float* v = hs + r * kPitch + c;
    *v = tl.pad_pixel(r0 + c) >= 0 ? relu_affine(*v, ksc[r], ksh[r]) : 0.f;
  }
}

// acc[dx] += the products of one stage for taps (dy, dx), in 3xTF32. Warp
// (wm, wn) owns rows co = 32 wm + 16 i + {g, g + 8} and columns ci = 16 wn
// + 8 j + {2 t, 2 t + 1}. A[co][k] = da2 at position k, B[k][ci] = h1 at
// position k + dx.
__device__ __forceinline__ void product(float (&acc)[3][2][2][4],
                                        const float* st, int wm, int wn,
                                        int g, int t) {
  const float* da = st + (32 * wm + g) * kPitch + t;
  const float* hb = st + (kBM + 16 * wn + g) * kPitch + t;
#pragma unroll 1
  for (int k = 0; k < kKP; k += 8) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* a = da + 16 * i * kPitch + k;
      conv3x3::split(a[0], ab[i][0], as[i][0]);
      conv3x3::split(a[8 * kPitch], ab[i][1], as[i][1]);
      conv3x3::split(a[4], ab[i][2], as[i][2]);
      conv3x3::split(a[8 * kPitch + 4], ab[i][3], as[i][3]);
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      uint32_t bb[2][2], bs[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* b = hb + 8 * j * kPitch + k + dx;
        conv3x3::split(b[0], bb[j][0], bs[j][0]);
        conv3x3::split(b[4], bb[j][1], bs[j][1]);
      }
      float f[2][2][4];
      // one pass a term, the small ones first
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          conv3x3::mma0(f[j][i], as[i], bb[j][0], bb[j][1]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          conv3x3::mma(f[j][i], ab[i], bs[j][0], bs[j][1]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          conv3x3::mma(f[j][i], ab[i], bb[j][0], bb[j][1]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[dx][i][j][r] += f[j][i][r];
        }
    }
  }
}

// Block (dy + 3 * (Cout tile + tiles * Cin tile), split): the split's
// partial dtaps of taps 3 dy .. 3 dy + 2, part[split] [9, C, C]. The
// split takes pieces [split * per, min(P, (split + 1) * per)).
__global__ void __launch_bounds__(kThreads, 2)
bwd_mid_wgrad_kernel(const float* __restrict__ da2,
                     const float* __restrict__ a1,
                     const float* __restrict__ sc1,
                     const float* __restrict__ sh1, float* __restrict__ part,
                     int C, int H, int W, int tiles, int P, int per) {
  extern __shared__ __align__(16) float ring[];
  __shared__ float ksc[kBN], ksh[kBN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  WTile tl;
  tl.dy = blockIdx.x % 3;
  const int tile = blockIdx.x / 3;
  tl.m0 = (tile % tiles) * kBM;
  tl.n0 = (tile / tiles) * kBN;
  tl.C = C;
  tl.H = H;
  tl.W = W;
  tl.Wp = W + 2;
  tl.S = H * W;
  tl.ppi = pieces(H, W);
  if (tid < kBN) {
    const int ci = tl.n0 + tid;
    ksc[tid] = ci < C ? __ldg(sc1 + ci) : 0.f;
    ksh[tid] = ci < C ? __ldg(sh1 + ci) : 0.f;
  }
  __syncthreads();
  float acc[3][2][2][4];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[dx][i][j][r] = 0.f;

  const int jb = blockIdx.y * per;
  const int stages = min(P, jb + per) - jb;
  auto buffer = [&](int s) { return ring + (s % kRing) * kStage; };
  copy_stage(buffer(0), jb, da2, a1, tl);
  conv3x3::commit();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) copy_stage(buffer(s + 1), jb + s + 1, da2, a1, tl);
    conv3x3::commit();
    conv3x3::wait_prior_1();
    normalize(buffer(s), jb + s, ksc, ksh, tl);
    __syncthreads();
    product(acc, buffer(s), wm, wn, g, t);
  }

  float* out = part + ((long)blockIdx.y * 9 + 3 * tl.dy) * C * C;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int co = tl.m0 + 32 * wm + 16 * i + g + 8 * (r >> 1);
          const int ci = tl.n0 + 16 * wn + 8 * j + 2 * t + (r & 1);
          if (co < C && ci < C)
            out[((long)dx * C + co) * C + ci] = acc[dx][i][j][r];
        }
}

// What the wrapper's _conv3x3_grid and _bwd_mid_grid compute: the input
// gradient's grid as conv3x3::grid_ok takes it; the tap gradients' splits
// cover the N * pieces(H, W) pieces exactly, each non-empty.
bool grid_ok(const float* taps_t, int N, int C, int H, int W, int T,
             int splits, int per) {
  if (!conv3x3::grid_ok(taps_t, N, C, C, H, W, T)) return false;
  const long P = (long)N * pieces(H, W);
  return (long)N * C < INT_MAX && (H * W + kThreads - 1) / kThreads <= 65535 &&
         P < INT_MAX && per > 0 && splits > 0 &&
         splits <= 65535 && (long)(splits - 1) * per < P &&
         (long)splits * per >= P && 3L * ((C + kBM - 1) / kBM) *
                                            ((C + kBM - 1) / kBM) < INT_MAX;
}

// da2 = g2 * p2 + a2 * q2 + r2 into da2 [N, C, H*W].
int fold(const float* g2, const float* a2, const float* p2, const float* q2,
         const float* r2, float* da2, int N, int C, int S, cudaStream_t s) {
  bwd_mid_fold_kernel<<<dim3(N * C, (S + kThreads - 1) / kThreads), kThreads,
                        0, s>>>(g2, a2, p2, q2, r2, da2, C, S);
  return (int)cudaGetLastError();
}

// g1 and bn1's sums: conv3x3_tc.cuh's kernel over da2 by taps_t.
int input_gradient(const float* da2, const float* taps_t, const float* a1,
                   const float* sc1, const float* sh1, const float* inv1,
                   const float* m1, float* g1, float* part, float* stats,
                   int N, int C, int H, int W, int T, cudaStream_t s) {
  return conv3x3::launch(da2, taps_t, AsIs{},
                         MaskedStats{a1, sc1, sh1, inv1, m1, g1}, part, stats,
                         N, C, C, H, W, T, s);
}

// dtaps: the splits' partials into wpart, then added in split order.
int tap_gradients(const float* da2, const float* a1, const float* sc1,
                  const float* sh1, float* wpart, float* dtaps, int N, int C,
                  int H, int W, int splits, int per, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      bwd_mid_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (C + kBM - 1) / kBM;
  bwd_mid_wgrad_kernel<<<dim3(3 * tiles * tiles, splits), kThreads, kSmem,
                         s>>>(da2, a1, sc1, sh1, wpart, C, H, W, tiles,
                              N * pieces(H, W), per);
  return finish_splits(wpart, dtaps, 9L * C * C, splits, s);
}

int launch(const float* g2, const float* a2, const float* a1,
           const float* sc1, const float* sh1, const float* p2,
           const float* q2, const float* r2, const float* inv1,
           const float* m1, const float* taps_t, float* da2, float* g1,
           float* part, float* stats, float* wpart, float* dtaps, int N,
           int C, int H, int W, int T, int splits, int per, cudaStream_t s) {
  int err = fold(g2, a2, p2, q2, r2, da2, N, C, H * W, s);
  if (!err)
    err = input_gradient(da2, taps_t, a1, sc1, sh1, inv1, m1, g1, part, stats,
                         N, C, H, W, T, s);
  if (!err)
    err = tap_gradients(da2, a1, sc1, sh1, wpart, dtaps, N, C, H, W, splits,
                        per, s);
  return err;
}

}  // namespace bwd_mid
}  // namespace
