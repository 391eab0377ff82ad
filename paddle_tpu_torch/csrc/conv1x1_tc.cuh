// The 1x1 product of two bottleneck-chain kernels for Hopper (sm_90a), on
// tensor cores in 3xTF32, over a K = C tile built once a block:
// conv1x1_bn_residual's, and bwd_final's dx. Included by fused_block.cu
// and bwd_final_tc.cuh.
//
// conv1x1_bn_residual replaces the Pallas body _assemble_kernel of
// paddle_tpu/kernels/fused_block.py:735-745 (pallas_call at :756). For a2
// [N, C, S] raw, bn2's affine sc2, sh2 [C], W3 [Cout, C], bn3's affine
// sc3, sh3 [Cout] and the block input x [N, Cout, S]:
//   h2 = relu(a2 * sc2 + sh2);
//   out = relu((W3 h2) * sc3 + sh3 + x).
// bwd_final's dx (bwd_final_tc.cuh) is dx = W1^T da1 + g3, the same
// product with another tile (da1 folded from g1 and a1) and another
// epilogue.
//
// What bounds conv1x1_bn_residual on the H100 (batch 128; Cout, C, S =
// 256, 64, 3136 / 512, 128, 784 / 1024, 256, 196): 13.2 GFLOP at every
// stage, 0.196 ms at the 67 TFLOP/s float32 FMA rate; as three TF32
// products, 39.5 GFLOP of tensor-core work, 0.080 ms at the 495 TFLOP/s
// dense TF32 rate. Each tensor read once and out written once: 925 / 463
// / 232 MB, 0.276 / 0.138 / 0.069 ms at 3.35 TB/s. Bytes bound it at
// 56x56 and 28x28, operations at 14x14.
//
// The design:
//   - The tile. A block owns 64 consecutive columns j = n * S + p of N * S
//     (a run may hold the end of one image and the start of the next, so
//     S = 196 and 49 leave no column idle) and all of the output rows, or
//     a share of their 128-row chunks (below). It reads its K = C operand
//     there once and builds it into a [Cp][72] tile in shared memory (Cp =
//     C rounded up to 16; zeros past C and past N * S): h2 = relu_affine
//     (a2) for conv1x1_bn_residual, the da1 fold for bwd_final, each value
//     once. 16-byte reads where S % 4 == 0 (4 columns then stay in one
//     image) and the operands are 16-byte aligned, 4-byte reads otherwise.
//     The SIMT kernel this replaces normalized a2 once for each 64 or 128
//     rows of Cout: 2 / 4 / 8 times at the three stages.
//   - The weight stream. Output rows come in chunks of 128. W^T [C, ldw]
//     (the wrapper's copy, rows zero-padded to ldw, a multiple of 4) comes
//     in stages of 16 channels x 128 rows, 16-byte cp.async zero-filled
//     past C and ldw, through a ring of 3; the first stage lands while the
//     tile is built. W is 64 KB-1 MB and stays in L2.
//   - The product: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 in
//     3xTF32 with conv3x3_tc.cuh's split, mma0 and mma; each k8 step's
//     three products of a tile go into a fresh fragment, added into the
//     float32 accumulators in float32 (the tensor cores truncate as they
//     accumulate). A[m][k] = W^T[k][m], B[k][j] = tile[k][j], both staged
//     channel-major at a pitch of 8 mod 32 floats, so that a fragment's 8
//     rows x 4 k (4 k x 8 columns) fall on 32 banks. 8 warps as 4 x 2,
//     each 32 rows x 32 columns.
//   - The epilogue, a chunk at a time: out = relu(fma(acc, sc3, sh3) + x)
//     (bwd_final: dx = acc + g3), float2 reads and writes where S % 4 ==
//     0 (columns 2t and 2t + 1 then lie in one image), 4-byte accesses
//     with their own offsets otherwise; the accumulators zeroed for the
//     next chunk. conv1x1_bn_residual reads a chunk's residual into
//     registers before its first stage, so that it lands under the
//     chunk's products (32 registers a thread, no spill).
//   - The Cout split (conv1x1_bn_residual only): where N * S / 64 blocks
//     fill the SMs' two blocks each poorly, a second grid dimension shares
//     the chunks out, each block building its tile again (C x 64 values,
//     cheap against 128 x C x 64 x 3 products a chunk); the wrapper's
//     _res_grid picks the count.
//   - C up to kMaxC (704): the tile and the ring in one block's shared
//     memory; two blocks an SM up to C 304, one above.
//   - No sums across blocks: two calls are bit-identical.
//
// One kernel, two uses: conv1x1_tc_kernel<Use, WIDE> takes its tile,
// the read before a chunk's products, its epilogue and its split through
// a Use policy (BnResidual below; bwd_final's Dx), over one flat list of
// operands: the epilogue's addend add, five read-only operands in0..in4
// (in0 the tile's source), W^T, out and a second output aux.
//
// Registers (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 128 a thread in both
// instances of conv1x1_bn_residual (WIDE or not) and in bwd_final's dx,
// the bound two blocks an SM set; no spills, no stack. The sharing costs
// bwd_final nothing: its dx instances compile to the SASS of a dx kernel
// written alone, names aside (scripts/torch_chain_ab.py against a tree
// that has one).
//
// What holds conv1x1_bn_residual back (scripts/
// torch_conv1x1_bn_residual_probe.py on an NVIDIA H100 80GB HBM3,
// 700.00 W, the run PERF.md row 16 names): 0.4460 / 0.3409 / 0.3450 ms
// at the three stages, 2.074 TB/s at 56x56, 115.7 / 114.4 TFLOP/s of
// TF32 at 28x28 / 14x14. Without the W^T copies 9.4% / 9.5% / 8.6%
// faster: each block streams all of W^T past its 64 columns, N * S *
// Cout * C / 16 bytes (~400 MB at each stage) out of L2. Without the
// residual 11.9% / 6.5% / 8.1% faster, without the tile 4.8% / 3.2% /
// 2.8%; each mma replaced by integer work 1.5% / 5.4% / 3.7% slower
// (PERF.md, lesson 8). The residual read in the epilogue instead, ten
// rounds in turns with the kernel: 1.2759x / 1.1230x / 0.9958x its time
// (medians); one split instead of two at 14x14 4.8% slower.
#pragma once

#include <climits>
#include <cstdint>

#include "conv3x3_tc.cuh"
#include "fused_block.cuh"

namespace {
namespace conv1x1 {

using conv3x3::commit;
using conv3x3::copy16;
using conv3x3::mma;
using conv3x3::mma0;
using conv3x3::split;
using conv3x3::wait_prior_1;

constexpr int kRing = 3;                 // W stages in the ring
constexpr int kP = 64;                   // columns of N * S a block
constexpr int kDP = kP + 8;              // the tile's pitch: 8 mod 32
constexpr int kM = 128;                  // output rows a chunk
constexpr int kK = 16;                   // channels of W a stage
constexpr int kAP = kM + 8;              // a W stage's pitch: 8 mod 32
constexpr int kStage = kK * kAP;

// C rounded up to whole W stages: the tile's rows.
__host__ __device__ constexpr int padded_c(int C) {
  return (C + kK - 1) / kK * kK;
}
constexpr int smem_bytes(int C) {
  return (padded_c(C) * kDP + kRing * kStage) * (int)sizeof(float);
}
// the most channels whose tile and ring fit one block's shared memory:
// 704 (two blocks an SM up to 304)
constexpr int kMaxC =
    (conv3x3::kMaxSmem / (int)sizeof(float) - kRing * kStage) / kDP / kK * kK;
static_assert(smem_bytes(kMaxC) <= conv3x3::kMaxSmem &&
              smem_bytes(kMaxC + kK) > conv3x3::kMaxSmem, "kMaxC");

// Stage s of the W^T stream into st [kK][kAP]: chunk s / slices (rows 128
// (s / slices) .. + 127 of the output), channels 16 (s % slices) .. + 15.
// Thread: 16 bytes at column 4 (tid % 32) of rows tid / 32 and tid / 32 +
// 8; zero-filled past C and past ldw, W^T's row pitch (a multiple of 4,
// zeros past the output rows).
__device__ __forceinline__ void copy_w(float* st, int s, int slices,
                                       const float* __restrict__ w, int C,
                                       int ldw) {
  const int ci = (s / slices) * kM + 4 * (threadIdx.x & 31);
  const int c0 = (s % slices) * kK, row = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kK / 8; ++k) {
    const int c = c0 + row + 8 * k;
    const bool ok = c < C && ci < ldw;
    copy16(st + (row + 8 * k) * kAP + 4 * (threadIdx.x & 31),
           w + (ok ? c * ldw + ci : 0), ok);
  }
}

// acc += the products of one W stage w (channels c0 .. c0 + 15; d the
// tile from row c0 on) in 3xTF32. Warp (wm, wn) owns rows 32 wm + 16 i +
// {g, g + 8} of the chunk and columns 32 wn + 8 j + {2 t, 2 t + 1}.
// A[ci][k] = w[k][ci], B[k][col] = d[k][col].
__device__ __forceinline__ void product(float (&acc)[2][4][4], const float* w,
                                        const float* d, int wm, int wn, int g,
                                        int t) {
  const float* wa = w + t * kAP + 32 * wm + g;
  const float* db = d + t * kDP + 32 * wn + g;
#pragma unroll
  for (int k = 0; k < kK; k += 8) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* a = wa + k * kAP + 16 * i;
      split(a[0], ab[i][0], as[i][0]);
      split(a[8], ab[i][1], as[i][1]);
      split(a[4 * kAP], ab[i][2], as[i][2]);
      split(a[4 * kAP + 8], ab[i][3], as[i][3]);
    }
#pragma unroll
    for (int j0 = 0; j0 < 4; j0 += 2) {
      uint32_t bb[2][2], bs[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float* b = db + k * kDP + 8 * (j0 + jj);
        split(b[0], bb[jj][0], bs[jj][0]);
        split(b[4 * kDP], bb[jj][1], bs[jj][1]);
      }
      float f[2][2][4];
      // one pass a term, the small ones first
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma0(f[jj][i], as[i], bb[jj][0], bb[jj][1]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma(f[jj][i], ab[i], bs[jj][0], bs[jj][1]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(f[jj][i], ab[i], bb[jj][0], bb[jj][1]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j0 + jj][r] += f[jj][i][r];
        }
    }
  }
}

// Block (64 columns of N * S from 64 blockIdx.x; with Use::kSplit, share
// blockIdx.y of gridDim.y of the output's 128-row chunks): out there, the
// K = C tile built once by Use::tile; Use::fetch runs before a chunk's
// first stage, Use::epilogue after its last.
template <class Use, bool WIDE>
__global__ void __launch_bounds__(kThreads, 2)
conv1x1_tc_kernel(const float* __restrict__ add, const float* __restrict__ in0,
                  const float* __restrict__ in1, const float* __restrict__ in2,
                  const float* __restrict__ in3, const float* __restrict__ in4,
                  const float* __restrict__ w, float* __restrict__ out,
                  float* __restrict__ aux, int M, int C, int S, int NS,
                  int ldw) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t = lane & 3;
  const int Cp = padded_c(C), slices = Cp / kK;
  int first = 0, stages = (M + kM - 1) / kM * slices;
  if constexpr (Use::kSplit) {
    const int chunks = (M + kM - 1) / kM;
    first = (int)(blockIdx.y * chunks / gridDim.y) * slices;
    stages = (int)((blockIdx.y + 1) * chunks / gridDim.y) * slices;
  }
  const int j0 = blockIdx.x * kP;
  float* d = smem;
  float* ring = smem + Cp * kDP;
  auto buffer = [&](int s) { return ring + (s % kRing) * kStage; };

  copy_w(buffer(first), first, slices, w, C, ldw);   // lands during the tile
  commit();
  Use::template tile<WIDE>(d, in0, in1, in2, in3, in4, aux, C, Cp, S, NS,
                           j0);

  // the offsets n * M * S + p of this thread's columns, -1 past N * S
  int off[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = j0 + 32 * wn + 8 * j + 2 * t + c;
      const int n = col / S;
      off[j][c] = col < NS ? n * M * S + (col - n * S) : -1;
    }
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  typename Use::Early early;

  for (int s = first; s < stages; ++s) {
    if (s + 1 < stages) copy_w(buffer(s + 1), s + 1, slices, w, C, ldw);
    commit();
    wait_prior_1();
    __syncthreads();
    const int slice = s % slices;
    if (slice == 0)
      Use::template fetch<WIDE>(early, off, add,
                                (s / slices) * kM + 32 * wm + g, M, S);
    product(acc, buffer(s), d + slice * kK * kDP, wm, wn, g, t);
    if (slice + 1 < slices) continue;
    // the chunk's epilogue at its rows, then acc = 0
    Use::template epilogue<WIDE>(early, acc, off, add, in3, in4, out,
                                 (s / slices) * kM + 32 * wm + g, M, S);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  }
}

// ---- conv1x1_bn_residual ---------------------------------------------------

// The Use of conv1x1_bn_residual: in0 = a2, in1 = sc2, in2 = sh2, in3 =
// sc3, in4 = sh3, add = x (the block input); no aux. A chunk's residual
// is read into registers before its first stage, so that it lands under
// the chunk's products.
struct BnResidual {
  static constexpr bool kSplit = true;
  struct Early {
    float2 r[2][2][4];
  };

  // h2 at columns j0 .. j0 + 63 into the tile d [Cp][kDP], 0 past C and
  // past N * S. WIDE: 16 bytes a thread, column group tid % 16 of rows tid
  // / 16 + 16 k; else 4 bytes, column tid % 64 of rows tid / 64 + 4 k.
  template <bool WIDE>
  __device__ static __forceinline__ void tile(
      float* d, const float* __restrict__ a2, const float* __restrict__ sc,
      const float* __restrict__ sh, const float* __restrict__,
      const float* __restrict__, float* __restrict__, int C, int Cp, int S,
      int NS, int j0) {
    constexpr int kCols = WIDE ? 4 : 1, kLanes = kP / kCols;
    constexpr int kRows = kThreads / kLanes;
    const int lane = threadIdx.x % kLanes, row = threadIdx.x / kLanes;
    const int j = j0 + kCols * lane;
    const bool in = j < NS;
    const int n = in ? j / S : 0;
    const int base = n * C * S + (j - n * S);
#pragma unroll 4
    for (int c = row; c < Cp; c += kRows) {
      float v[kCols];
#pragma unroll
      for (int e = 0; e < kCols; ++e) v[e] = 0.f;
      if (in && c < C) {
        const int o = base + c * S;
        const float scc = __ldg(sc + c), shc = __ldg(sh + c);
        if constexpr (WIDE) {
          const float4 av = __ldg(reinterpret_cast<const float4*>(a2 + o));
          v[0] = relu_affine(av.x, scc, shc);
          v[1] = relu_affine(av.y, scc, shc);
          v[2] = relu_affine(av.z, scc, shc);
          v[3] = relu_affine(av.w, scc, shc);
        } else {
          v[0] = relu_affine(__ldg(a2 + o), scc, shc);
        }
      }
      if constexpr (WIDE)
        *reinterpret_cast<float4*>(d + c * kDP + 4 * lane) =
            make_float4(v[0], v[1], v[2], v[3]);
      else
        d[c * kDP + lane] = v[0];
    }
  }

  // The residual at this thread's outputs of the chunk whose rows start at
  // ci0.
  template <bool WIDE>
  __device__ static __forceinline__ void fetch(Early& e,
                                               const int (&off)[4][2],
                                               const float* __restrict__ x,
                                               int ci0, int M, int S) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int ci = ci0 + 16 * i + 8 * hr;
        if (ci >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (WIDE) {
            if (off[j][0] >= 0)
              e.r[i][hr][j] = __ldg(
                  reinterpret_cast<const float2*>(x + off[j][0] + ci * S));
          } else {
            if (off[j][0] >= 0) e.r[i][hr][j].x = __ldg(x + off[j][0] + ci * S);
            if (off[j][1] >= 0) e.r[i][hr][j].y = __ldg(x + off[j][1] + ci * S);
          }
        }
      }
  }

  // out = relu(acc * sc3 + sh3 + x) at the chunk's rows ci0 + 16 i + 8 hr,
  // x from fetch.
  template <bool WIDE>
  __device__ static __forceinline__ void epilogue(
      const Early& e, const float (&acc)[2][4][4], const int (&off)[4][2],
      const float* __restrict__, const float* __restrict__ sc3,
      const float* __restrict__ sh3, float* __restrict__ out, int ci0, int M,
      int S) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int ci = ci0 + 16 * i + 8 * hr;
        if (ci >= M) continue;
        const float s3 = __ldg(sc3 + ci), h3 = __ldg(sh3 + ci);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 r = e.r[i][hr][j];
          if constexpr (WIDE) {
            // S % 4 == 0: columns 2t and 2t + 1 lie in one image
            if (off[j][0] < 0) continue;
            *reinterpret_cast<float2*>(out + off[j][0] + ci * S) =
                make_float2(fmaxf(fmaf(acc[i][j][2 * hr], s3, h3) + r.x, 0.f),
                            fmaxf(fmaf(acc[i][j][2 * hr + 1], s3, h3) + r.y,
                                  0.f));
          } else {
            if (off[j][0] >= 0)
              out[off[j][0] + ci * S] =
                  fmaxf(fmaf(acc[i][j][2 * hr], s3, h3) + r.x, 0.f);
            if (off[j][1] >= 0)
              out[off[j][1] + ci * S] =
                  fmaxf(fmaf(acc[i][j][2 * hr + 1], s3, h3) + r.y, 0.f);
          }
        }
      }
  }
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

// What the wrapper computes: W^T at a row pitch ldw >= Cout, a multiple
// of 4, 16-byte aligned; 1 <= splits <= the 128-row chunks of Cout (none
// empty); every offset inside an int; C <= kMaxC; with wide, S % 4 == 0
// and a2, x and out 16-byte aligned.
bool bn_residual_ok(const float* a2, const float* x, const float* wt,
                    const float* out, int N, int C, int Cout, int S, int ldw,
                    int splits, int wide) {
  if (N <= 0 || C <= 0 || C > kMaxC || Cout <= 0 || S <= 0) return false;
  const long big = Cout > C ? Cout : C;
  if ((long)N * big * S >= INT_MAX || (long)C * ldw >= INT_MAX) return false;
  if (ldw < Cout || ldw % 4 || !aligned16(wt)) return false;
  if (splits < 1 || splits > 65535 || splits > (Cout + kM - 1) / kM)
    return false;
  return !wide || (S % 4 == 0 && aligned16(a2) && aligned16(x) &&
                   aligned16(out));
}

// out over 64-column blocks of N * S x splits of Cout's chunks.
template <bool WIDE>
int bn_residual(const float* a2, const float* x, const float* wt,
                const float* sc2, const float* sh2, const float* sc3,
                const float* sh3, float* out, int N, int C, int Cout, int S,
                int ldw, int splits, cudaStream_t s) {
  const int NS = N * S, bytes = smem_bytes(C);
  const cudaError_t e = cudaFuncSetAttribute(
      conv1x1_tc_kernel<BnResidual, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  conv1x1_tc_kernel<BnResidual, WIDE>
      <<<dim3((NS + kP - 1) / kP, splits), kThreads, bytes, s>>>(
          x, a2, sc2, sh2, sc3, sh3, wt, out, nullptr, Cout, C, S, NS, ldw);
  return (int)cudaGetLastError();
}

}  // namespace conv1x1
}  // namespace
