// Conv-epilogue kernels for Hopper (sm_90a), float32.
//
// Replace the TPU kernels of paddle_tpu/kernels/fused_conv.py:
//   channel_stats (Pallas body _stats_kernel): per-channel sum and sum of
//     squares of a raw conv output a [N, C, S] (S = H*W), over the batch
//     and the image;
//   apply_epilogue (_apply_kernel): y = a * scale[c] + shift[c], then ReLU
//     if asked;
//   apply_epilogue with an addend (_apply_add_kernel): y = a * scale[c] +
//     shift[c] + addend, then ReLU if asked.
//
// What bounds them on the H100: bytes. They do 2 to 4 flops per element
// and move 4 (stats), 8 (apply) or 12 (apply with an addend) bytes for it,
// so the reads and writes at 3.35 TB/s are the roof: at the ResNet-50 stem,
// [128, 64, 112, 112], stats reads 411 MB (0.123 ms) and apply moves
// 822 MB (0.245 ms); at [128, 512, 7, 7] stats reads 12.8 MB (0.0038 ms),
// so there a launch's fixed costs count as much as the bytes.
//
// What the design does about it. The TPU kernel holds a whole image in
// VMEM and walks the batch as a sequential grid, carrying the sums from
// step to step; an SM cannot hold an image, and blocks run in no order.
// Both kernels here read a as a matrix of N rows of C*S floats (one image
// a row) and cut it into column ranges of 4 * LANES floats: a thread owns
// four columns, the same in every row, and walks the rows. A column's
// channel, column / S, is fixed, so a thread finds its four channels once
// and not once an element: at S = 49 or 196 a float4 that straddles two
// channels costs nothing, and every lane of a warp reads 16 bytes of every
// row whatever S is (a warp a row: 512 contiguous bytes). When C*S % 4 != 0
// rows start off 16-byte alignment, and a thread reads its four columns as
// scalars, 32 apart (LANES = 32). Rows are read U at a time, U independent
// 16-byte loads a thread in flight before their arithmetic.
//
// Apply: a block takes a column range and a slice of rows; each thread
// loads its four channels' scale and shift once, then reads a (and the
// addend), computes fmaf(a, scale, shift) (+ addend) (then fmaxf with 0)
// and writes y, element for element the same arithmetic as before.
//
// Stats: one launch, deterministic, no float atomics. Block (b, p) sums its
// column range over row slice p: each thread down its rows, then the R row
// groups of the block in order, then each channel's columns within the
// block by a warp (a fixed shuffle tree), one partial a (channel, column
// range, slice). The partials of channels [256 g, 256 g + 256) go to a
// ticket g: each block that holds one of them takes the ticket with an
// integer atomicAdd after __threadfence(), and the block that draws the
// last number adds those channels' partials in slice order, writes their
// sums and sets the ticket back to 0 for the next call on the stream (the
// wrapper keeps the tickets and the partials in one scratch a stream, so a
// call allocates its output alone). The split into column ranges
// and row slices fills the card at the stem as at 7x7: the wrapper picks
// LANES so that there are at least four column ranges an SM, and slices
// the rows only where the column ranges alone fill less than two blocks an
// SM.
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 256;      // channels a ticket
constexpr int kMaxTouch = 8;     // tickets a block can hold: at most
                                 // (1024 / S + 1) / 256 + 2 = 6
constexpr int kStatsRows = 8;    // rows a thread loads before adding them
constexpr int kApplyRows = 4;    // rows a thread loads before computing

// Offset of a thread's column i within its block's 4 * LANES columns.
template <int LANES, bool VEC>
__device__ __forceinline__ int column(int lane, int i) {
  return VEC ? 4 * lane + i : lane + LANES * i;
}

// A 16-byte load through the read-only path.
__device__ __forceinline__ float4 load4(const float4* p) { return __ldg(p); }

__device__ __forceinline__ void acc(float v, float& s1, float& s2) {
  s1 += v;
  s2 = fmaf(v, v, s2);
}

// Channel sums of a [N, C*S] (row = image) into out [2, C]. part holds
// the partials: part_k[P][nb + C] at part + k * L, the partial of (channel
// c, column range b, slice p) at p * (nb + C) + b + c.
template <int LANES, bool VEC>
__global__ void __launch_bounds__(kThreads)
channel_stats_kernel(const float* __restrict__ a, float* __restrict__ out,
                     int* __restrict__ tickets, float* __restrict__ part,
                     int N, int C, int S, int rows_per, long L) {
  constexpr int R = kThreads / LANES;
  constexpr int E = 4 * LANES;
  const long CS = (long)C * S;
  const int nb = gridDim.x, P = gridDim.y;
  const int b = blockIdx.x, p = blockIdx.y;
  const int t = threadIdx.x, lane = t % LANES, r = t / LANES;
  const long E0 = (long)b * E;
  const int n1 = min(N, (p + 1) * rows_per);
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (VEC) {
    const long e = E0 + 4 * lane;
    if (e < CS) {
      const float4* src = reinterpret_cast<const float4*>(a + e);
      const long step = CS / 4;
      for (int n = p * rows_per + r; n < n1; n += R * kStatsRows) {
        float4 v[kStatsRows];
#pragma unroll
        for (int u = 0; u < kStatsRows; ++u) {
          const int m = n + u * R;
          v[u] = m < n1 ? load4(src + m * step)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kStatsRows; ++u) {
          acc(v[u].x, s1[0], s2[0]);
          acc(v[u].y, s1[1], s2[1]);
          acc(v[u].z, s1[2], s2[2]);
          acc(v[u].w, s1[3], s2[3]);
        }
      }
    }
  } else {
    bool ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ok[i] = E0 + column<LANES, VEC>(lane, i) < CS;
    for (int n = p * rows_per + r; n < n1; n += R * kStatsRows) {
      float v[kStatsRows][4];
#pragma unroll
      for (int u = 0; u < kStatsRows; ++u) {
        const int m = n + u * R;
        const float* row = a + m * CS + E0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[u][i] = m < n1 && ok[i] ? __ldg(row + column<LANES, VEC>(lane, i))
                                    : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kStatsRows; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc(v[u][i], s1[i], s2[i]);
    }
  }

  // the R row groups' column sums, added in order into row group 0's
  __shared__ float red[2][R * E];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = r * E + column<LANES, VEC>(lane, i);
    red[0][k] = s1[i];
    red[1][k] = s2[i];
  }
  __syncthreads();
  if constexpr (R > 1) {
    for (int e = t; e < E; e += kThreads) {
      float x1 = red[0][e], x2 = red[1][e];
      for (int k = 1; k < R; ++k) {
        x1 += red[0][k * E + e];
        x2 += red[1][k * E + e];
      }
      red[0][e] = x1;
      red[1][e] = x2;
    }
    __syncthreads();
  }

  // one partial a channel of the range: a warp adds its columns
  const long Eend = min(E0 + E, CS);
  const int cf = (int)(E0 / S), cl = (int)((Eend - 1) / S);
  float* part1 = part;
  float* part2 = part + L;
  const long pb = (long)p * (nb + C) + b;
  const int warp = t >> 5, wl = t & 31;
  for (int c = cf + warp; c <= cl; c += kWarps) {
    const int lo = (int)(max(E0, (long)c * S) - E0);
    const int hi = (int)(min(Eend, (long)(c + 1) * S) - E0);
    float x1 = 0.f, x2 = 0.f;
    for (int e = lo + wl; e < hi; e += 32) {
      x1 += red[0][e];
      x2 += red[1][e];
    }
    x1 = ptt::warp_sum(x1);
    x2 = ptt::warp_sum(x2);
    if (wl == 0) {
      part1[pb + c] = x1;
      part2[pb + c] = x2;
    }
  }

  // a ticket for each group of channels the range holds; the block that
  // draws a group's last number adds that group's partials
  __shared__ int last[kMaxTouch];
  const int g0 = cf / kGroup, ng = cl / kGroup - g0 + 1;
  __syncthreads();
  if (t < ng) {
    const int g = g0 + t;
    const long c_lo = (long)g * kGroup, c_hi = min((long)C, c_lo + kGroup);
    const int want = (int)((c_hi * S - 1) / E - c_lo * S / E + 1) * P;
    __threadfence();
    last[t] = atomicAdd(tickets + g, 1) == want - 1;
  }
  __syncthreads();
  for (int k = 0; k < ng; ++k) {
    if (!last[k]) continue;
    __threadfence();
    const int g = g0 + k;
    const int c_lo = g * kGroup, nch = min(C - c_lo, kGroup);
    int tpc = 1;  // threads a channel
    while (tpc < 32 && 2 * tpc * nch <= kThreads) tpc *= 2;
    const int lc = t / tpc, sub = t % tpc, c = c_lo + lc;
    float x1 = 0.f, x2 = 0.f;
    if (lc < nch) {
      const long b_lo = (long)c * S / E;
      const int nbc = (int)(((long)(c + 1) * S - 1) / E - b_lo + 1);
      // unrolled so that the reads of a channel's partials from L2 are
      // in flight together; the adds stay in order
#pragma unroll 4
      for (int q = sub; q < nbc * P; q += tpc) {
        const long i = (long)(q / nbc) * (nb + C) + b_lo + q % nbc + c;
        x1 += __ldcg(part1 + i);
        x2 += __ldcg(part2 + i);
      }
    }
    for (int o = tpc / 2; o > 0; o >>= 1) {
      x1 += __shfl_xor_sync(0xffffffffu, x1, o);
      x2 += __shfl_xor_sync(0xffffffffu, x2, o);
    }
    if (lc < nch && sub == 0) {
      out[c] = x1;
      out[C + c] = x2;
    }
    if (t == 0) tickets[g] = 0;
  }
}

template <bool ADD, bool RELU>
__device__ __forceinline__ float epi(float v, float sc, float sh, float d) {
  float o = fmaf(v, sc, sh);
  if constexpr (ADD) o += d;
  if constexpr (RELU) o = fmaxf(o, 0.f);
  return o;
}

// y = a * scale[c] + shift[c] (+ addend) (ReLU) over the column range
// blockIdx.x and the row slice blockIdx.y.
template <bool ADD, bool RELU, int LANES, bool VEC>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ a, const float* __restrict__ addend,
             const float* __restrict__ scale, const float* __restrict__ shift,
             float* __restrict__ y, int N, int C, int S, int rows_per) {
  constexpr int R = kThreads / LANES;
  constexpr int E = 4 * LANES;
  const long CS = (long)C * S;
  const int lane = threadIdx.x % LANES, r = threadIdx.x / LANES;
  const long E0 = (long)blockIdx.x * E;
  const int n1 = min(N, ((int)blockIdx.y + 1) * rows_per);
  bool ok[4];
  float sc[4], sh[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long e = E0 + column<LANES, VEC>(lane, i);
    ok[i] = e < CS;
    const int c = ok[i] ? (int)(e / S) : 0;
    sc[i] = __ldg(scale + c);
    sh[i] = __ldg(shift + c);
  }
  if constexpr (VEC) {
    if (!ok[0]) return;
    const long off = E0 + 4 * lane;
    for (int n = blockIdx.y * rows_per + r; n < n1; n += R * kApplyRows) {
      float4 v[kApplyRows], d[kApplyRows];
#pragma unroll
      for (int u = 0; u < kApplyRows; ++u) {
        const int m = n + u * R;
        v[u] = d[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m < n1) {
          v[u] = load4(reinterpret_cast<const float4*>(a + m * CS + off));
          if constexpr (ADD)
            d[u] = load4(reinterpret_cast<const float4*>(addend + m * CS +
                                                         off));
        }
      }
#pragma unroll
      for (int u = 0; u < kApplyRows; ++u) {
        const int m = n + u * R;
        if (m < n1) {
          float4 o;
          o.x = epi<ADD, RELU>(v[u].x, sc[0], sh[0], d[u].x);
          o.y = epi<ADD, RELU>(v[u].y, sc[1], sh[1], d[u].y);
          o.z = epi<ADD, RELU>(v[u].z, sc[2], sh[2], d[u].z);
          o.w = epi<ADD, RELU>(v[u].w, sc[3], sh[3], d[u].w);
          *reinterpret_cast<float4*>(y + m * CS + off) = o;
        }
      }
    }
  } else {
    for (int n = blockIdx.y * rows_per + r; n < n1; n += R * kApplyRows) {
      float v[kApplyRows][4], d[kApplyRows][4];
#pragma unroll
      for (int u = 0; u < kApplyRows; ++u) {
        const int m = n + u * R;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long k = m * CS + E0 + column<LANES, VEC>(lane, i);
          const bool in = m < n1 && ok[i];
          v[u][i] = in ? __ldg(a + k) : 0.f;
          d[u][i] = ADD && in ? __ldg(addend + k) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kApplyRows; ++u) {
        const int m = n + u * R;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (m < n1 && ok[i])
            y[m * CS + E0 + column<LANES, VEC>(lane, i)] =
                epi<ADD, RELU>(v[u][i], sc[i], sh[i], d[u][i]);
      }
    }
  }
}

// Column ranges of a [N, C*S] at LANES float4 (or scalar) columns a
// thread row; 0 if LANES is not one the kernels are built for.
long column_ranges(long CS, int lanes) {
  const bool vec = CS % 4 == 0;
  if (vec ? (lanes != 32 && lanes != 64 && lanes != 128 && lanes != 256)
          : lanes != 32)
    return 0;
  return (CS + 4L * lanes - 1) / (4L * lanes);
}

// f(lanes, vec) with both as compile-time constants (std::integral_constant
// and std::bool_constant): the instance of a kernel that the wrapper's
// `lanes` and the rows' alignment pick (32, 64, 128 or 256 float4 lanes;
// 32 scalar lanes where C * S % 4 != 0).
template <class F>
int with_lanes(int lanes, bool vec, F f) {
  using std::bool_constant;
  using std::integral_constant;
  if (!vec) return f(integral_constant<int, 32>(), bool_constant<false>());
  switch (lanes) {
    case 32:
      return f(integral_constant<int, 32>(), bool_constant<true>());
    case 64:
      return f(integral_constant<int, 64>(), bool_constant<true>());
    case 128:
      return f(integral_constant<int, 128>(), bool_constant<true>());
    default:
      return f(integral_constant<int, 256>(), bool_constant<true>());
  }
}

template <bool ADD>
int launch_apply(const float* a, const float* addend, const float* scale,
                 const float* shift, float* y, int N, int C, int S, int relu,
                 int lanes, int rows_per, cudaStream_t s) {
  if (N <= 0 || C <= 0 || S <= 0 || rows_per <= 0)
    return (int)cudaErrorInvalidValue;
  const long CS = (long)C * S, nb = column_ranges(CS, lanes);
  const long P = (N + (long)rows_per - 1) / rows_per;
  if (nb == 0 || nb > 0x7fffffffL || P > 65535 || (long)N * CS > (1L << 40))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nb, (unsigned)P);
  return with_lanes(lanes, CS % 4 == 0, [&](auto kl, auto kv) {
    constexpr int LANES = decltype(kl)::value;
    constexpr bool VEC = decltype(kv)::value;
    if (relu)
      apply_kernel<ADD, true, LANES, VEC><<<grid, kThreads, 0, s>>>(
          a, addend, scale, shift, y, N, C, S, rows_per);
    else
      apply_kernel<ADD, false, LANES, VEC><<<grid, kThreads, 0, s>>>(
          a, addend, scale, shift, y, N, C, S, rows_per);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// a [N, C, S] float32, contiguous, 16-byte aligned; out [2, C] float32:
// the sums and the sums of squares. tickets: ceil(C / 256) ints, 0 before
// the launch and 0 after it; part: 2 * L floats of scratch, L = P * (nb +
// C) for P = ceil(N / rows_per) row slices and nb the column ranges of
// `lanes` (32, 64, 128 or 256 where C * S % 4 == 0, else 32); tickets and
// part used by no launch on another stream. One launch on `stream`.
// Returns a cudaError_t (0 = launched).
extern "C" int fused_conv_channel_stats_f32(const float* a, float* out,
                                            int* tickets, float* part, int N,
                                            int C, int S, int lanes,
                                            int rows_per, long L,
                                            void* stream) {
  if (N <= 0 || C <= 0 || S <= 0 || rows_per <= 0)
    return (int)cudaErrorInvalidValue;
  const long CS = (long)C * S, nb = column_ranges(CS, lanes);
  const long P = (N + (long)rows_per - 1) / rows_per;
  if (nb == 0 || nb > 0x7fffffffL || P > 65535 || (long)N * CS > (1L << 40) ||
      L != P * (nb + C))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)nb, (unsigned)P);
  return with_lanes(lanes, CS % 4 == 0, [&](auto kl, auto kv) {
    channel_stats_kernel<decltype(kl)::value, decltype(kv)::value>
        <<<grid, kThreads, 0, s>>>(a, out, tickets, part, N, C, S, rows_per,
                                   L);
    return (int)cudaGetLastError();
  });
}

// a, y [N, C, S]; scale, shift [C]; all float32, contiguous, 16-byte
// aligned. relu: 0 or 1. lanes as for the stats; rows_per: rows a block
// (blocks of 256 threads: 256 / lanes row groups of lanes threads).
extern "C" int fused_conv_apply_f32(const float* a, const float* scale,
                                    const float* shift, float* y, int N,
                                    int C, int S, int relu, int lanes,
                                    int rows_per, void* stream) {
  return launch_apply<false>(a, nullptr, scale, shift, y, N, C, S, relu,
                             lanes, rows_per,
                             static_cast<cudaStream_t>(stream));
}

// As fused_conv_apply_f32, plus the residual addend [N, C, S].
extern "C" int fused_conv_apply_add_f32(const float* a, const float* addend,
                                        const float* scale, const float* shift,
                                        float* y, int N, int C, int S,
                                        int relu, int lanes, int rows_per,
                                        void* stream) {
  return launch_apply<true>(a, addend, scale, shift, y, N, C, S, relu, lanes,
                            rows_per, static_cast<cudaStream_t>(stream));
}
