// Conv-epilogue kernels for Hopper (sm_90a), float32 and bfloat16.
//
// Replace the TPU kernels of paddle_tpu/kernels/fused_conv.py:
//   channel_stats (Pallas body _stats_kernel): per-channel sum and sum of
//     squares of a raw conv output a [N, C, S] (S = H*W), over the batch
//     and the image;
//   apply_epilogue (_apply_kernel): y = a * scale[c] + shift[c], then ReLU
//     if asked;
//   apply_epilogue with an addend (_apply_add_kernel): y = a * scale[c] +
//     shift[c] + addend, then ReLU if asked.
// Each in two instances, by the type of a (and of the addend and y): float
// and bfloat16. The sums, scale and shift are float32 in both. A bfloat16
// element is widened to float32 (exact), the arithmetic is float32, and y
// is rounded once to bfloat16, to nearest with ties to even, where the
// Pallas kernels round (out_ref[0] = y.astype(out_ref.dtype)).
//
// What bounds them on the H100: bytes. They do 2 to 4 flops per element
// and move 4 (stats), 8 (apply) or 12 (apply with an addend) bytes for it
// in float32, half that in bfloat16, so the reads and writes at 3.35 TB/s
// are the roof: at the ResNet-50 stem, [128, 64, 112, 112], float32 stats
// reads 411 MB (0.123 ms) and apply moves 822 MB (0.245 ms), bfloat16 0.061
// and 0.123 ms; at [128, 512, 7, 7] float32 stats reads 12.8 MB (0.0038
// ms), so there a launch's fixed costs count as much as the bytes.
//
// What the design does about it. The TPU kernel holds a whole image in
// VMEM and walks the batch as a sequential grid, carrying the sums from
// step to step; an SM cannot hold an image, and blocks run in no order.
// Both kernels here read a as a matrix of N rows of C*S elements (one
// image a row) and cut it into column ranges of V * LANES elements, V the
// elements of one 16-byte vector (4 float, 8 bfloat16): a thread owns V
// columns, the same in every row, and walks the rows. A column's channel,
// column / S, is fixed, so a thread finds its V channels once and not once
// an element: at S = 49 or 196 a vector that straddles two channels costs
// nothing, and every lane of a warp reads 16 bytes of every row whatever S
// is (a warp a row: 512 contiguous bytes). When C*S % V != 0 rows start off
// 16-byte alignment, and a thread reads its V columns as scalars, 32 apart
// (LANES = 32). Rows are read U at a time, U independent 16-byte loads a
// thread in flight before their arithmetic. The bfloat16 instances differ
// from the float ones only in V and in the widening and rounding of each
// element: the same blocks, rows a thread, plans and order of sums.
//
// Apply: a block takes a column range and a slice of rows; each thread
// loads its V channels' scale and shift once, then reads a (and the
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

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 256;      // channels a ticket
constexpr int kMaxTouch = 16;    // tickets a block can hold: at most
                                 // (8 * 256 / S + 1) / 256 + 2 = 10
constexpr int kStatsRows = 8;    // rows a thread loads before adding them
constexpr int kApplyRows = 4;    // rows a thread loads before computing

typedef uint16_t bf16;  // the bits of one bfloat16

// An element type: V of them in a 16-byte vector (read as a uint4), widened
// to float and rounded back.
template <class T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int V = 4;
  __device__ static float widen(float x) { return x; }
  __device__ static float narrow(float x) { return x; }
  __device__ static void unpack(uint4 r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Elem<bf16> {
  static constexpr int V = 8;
  __device__ static float widen(bf16 h) {
    return __uint_as_float((uint32_t)h << 16);
  }
  // rounded to nearest, ties to even; a NaN stays a (quiet) NaN
  __device__ static bf16 narrow(float x) {
    const uint32_t u = __float_as_uint(x);
    if ((u & 0x7fffffffu) > 0x7f800000u) return (bf16)((u >> 16) | 0x40u);
    return (bf16)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
  }
  __device__ static void unpack(uint4 r, float (&v)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (uint32_t)narrow(v[2 * k]) | (uint32_t)narrow(v[2 * k + 1]) << 16;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Offset of a thread's column i within its block's V * LANES columns.
template <int V, int LANES, bool VEC>
__device__ __forceinline__ int column(int lane, int i) {
  return VEC ? V * lane + i : lane + LANES * i;
}

__device__ __forceinline__ void acc(float v, float& s1, float& s2) {
  s1 += v;
  s2 = fmaf(v, v, s2);
}

// Channel sums of a [N, C*S] (row = image) into out [2, C]. part holds
// the partials: part_k[P][nb + C] at part + k * L, the partial of (channel
// c, column range b, slice p) at p * (nb + C) + b + c.
template <class T, int LANES, bool VEC>
__global__ void __launch_bounds__(kThreads)
channel_stats_kernel(const T* __restrict__ a, float* __restrict__ out,
                     int* __restrict__ tickets, float* __restrict__ part,
                     int N, int C, int S, int rows_per, long L) {
  using El = Elem<T>;
  constexpr int V = El::V;
  constexpr int R = kThreads / LANES;
  constexpr int E = V * LANES;
  const long CS = (long)C * S;
  const int nb = gridDim.x, P = gridDim.y;
  const int b = blockIdx.x, p = blockIdx.y;
  const int t = threadIdx.x, lane = t % LANES, r = t / LANES;
  const long E0 = (long)b * E;
  const int n1 = min(N, (p + 1) * rows_per);
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if constexpr (VEC) {
    const long e = E0 + V * lane;
    if (e < CS) {
      const uint4* src = reinterpret_cast<const uint4*>(a + e);
      const long step = CS / V;
      for (int n = p * rows_per + r; n < n1; n += R * kStatsRows) {
        uint4 raw[kStatsRows];
#pragma unroll
        for (int u = 0; u < kStatsRows; ++u) {
          const int m = n + u * R;
          raw[u] = m < n1 ? __ldg(src + m * step) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kStatsRows; ++u) {
          float v[V];
          El::unpack(raw[u], v);
#pragma unroll
          for (int i = 0; i < V; ++i) acc(v[i], s1[i], s2[i]);
        }
      }
    }
  } else {
    bool ok[V];
#pragma unroll
    for (int i = 0; i < V; ++i)
      ok[i] = E0 + column<V, LANES, VEC>(lane, i) < CS;
    for (int n = p * rows_per + r; n < n1; n += R * kStatsRows) {
      float v[kStatsRows][V];
#pragma unroll
      for (int u = 0; u < kStatsRows; ++u) {
        const int m = n + u * R;
        const T* row = a + m * CS + E0;
#pragma unroll
        for (int i = 0; i < V; ++i)
          v[u][i] = m < n1 && ok[i]
                        ? El::widen(__ldg(row + column<V, LANES, VEC>(lane, i)))
                        : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kStatsRows; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) acc(v[u][i], s1[i], s2[i]);
    }
  }

  // the R row groups' column sums, added in order into row group 0's
  __shared__ float red[2][R * E];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = r * E + column<V, LANES, VEC>(lane, i);
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
template <class T, bool ADD, bool RELU, int LANES, bool VEC>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ a, const T* __restrict__ addend,
             const float* __restrict__ scale, const float* __restrict__ shift,
             T* __restrict__ y, int N, int C, int S, int rows_per) {
  using El = Elem<T>;
  constexpr int V = El::V;
  constexpr int R = kThreads / LANES;
  constexpr int E = V * LANES;
  const long CS = (long)C * S;
  const int lane = threadIdx.x % LANES, r = threadIdx.x / LANES;
  const long E0 = (long)blockIdx.x * E;
  const int n1 = min(N, ((int)blockIdx.y + 1) * rows_per);
  bool ok[V];
  float sc[V], sh[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const long e = E0 + column<V, LANES, VEC>(lane, i);
    ok[i] = e < CS;
    const int c = ok[i] ? (int)(e / S) : 0;
    sc[i] = __ldg(scale + c);
    sh[i] = __ldg(shift + c);
  }
  if constexpr (VEC) {
    if (!ok[0]) return;
    const long off = E0 + V * lane;
    for (int n = blockIdx.y * rows_per + r; n < n1; n += R * kApplyRows) {
      uint4 v[kApplyRows], d[kApplyRows];
#pragma unroll
      for (int u = 0; u < kApplyRows; ++u) {
        const int m = n + u * R;
        v[u] = d[u] = make_uint4(0, 0, 0, 0);
        if (m < n1) {
          v[u] = __ldg(reinterpret_cast<const uint4*>(a + m * CS + off));
          if constexpr (ADD)
            d[u] = __ldg(reinterpret_cast<const uint4*>(addend + m * CS +
                                                        off));
        }
      }
#pragma unroll
      for (int u = 0; u < kApplyRows; ++u) {
        const int m = n + u * R;
        if (m < n1) {
          float fv[V], fd[V], o[V];
          El::unpack(v[u], fv);
          El::unpack(d[u], fd);
#pragma unroll
          for (int i = 0; i < V; ++i)
            o[i] = epi<ADD, RELU>(fv[i], sc[i], sh[i], fd[i]);
          *reinterpret_cast<uint4*>(y + m * CS + off) = El::pack(o);
        }
      }
    }
  } else {
    for (int n = blockIdx.y * rows_per + r; n < n1; n += R * kApplyRows) {
      float v[kApplyRows][V], d[kApplyRows][V];
#pragma unroll
      for (int u = 0; u < kApplyRows; ++u) {
        const int m = n + u * R;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const long k = m * CS + E0 + column<V, LANES, VEC>(lane, i);
          const bool in = m < n1 && ok[i];
          v[u][i] = in ? El::widen(__ldg(a + k)) : 0.f;
          d[u][i] = ADD && in ? El::widen(__ldg(addend + k)) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kApplyRows; ++u) {
        const int m = n + u * R;
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (m < n1 && ok[i])
            y[m * CS + E0 + column<V, LANES, VEC>(lane, i)] =
                El::narrow(epi<ADD, RELU>(v[u][i], sc[i], sh[i], d[u][i]));
      }
    }
  }
}

// Column ranges of a [N, C*S] at LANES V-element vectors (or scalar
// columns) a thread row; 0 if LANES is not one the kernels are built for.
long column_ranges(long CS, int lanes, int V) {
  const bool vec = CS % V == 0;
  if (vec ? (lanes != 32 && lanes != 64 && lanes != 128 && lanes != 256)
          : lanes != 32)
    return 0;
  return (CS + (long)V * lanes - 1) / ((long)V * lanes);
}

// f(lanes, vec) with both as compile-time constants (std::integral_constant
// and std::bool_constant): the instance of a kernel that the wrapper's
// `lanes` and the rows' alignment pick (32, 64, 128 or 256 vector lanes;
// 32 scalar lanes where C * S % V != 0).
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

template <class T>
int launch_stats(const T* a, float* out, int* tickets, float* part, int N,
                 int C, int S, int lanes, int rows_per, long L,
                 cudaStream_t s) {
  constexpr int V = Elem<T>::V;
  if (N <= 0 || C <= 0 || S <= 0 || rows_per <= 0)
    return (int)cudaErrorInvalidValue;
  const long CS = (long)C * S, nb = column_ranges(CS, lanes, V);
  const long P = (N + (long)rows_per - 1) / rows_per;
  if (nb == 0 || nb > 0x7fffffffL || P > 65535 || (long)N * CS > (1L << 40) ||
      L != P * (nb + C))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nb, (unsigned)P);
  return with_lanes(lanes, CS % V == 0, [&](auto kl, auto kv) {
    channel_stats_kernel<T, decltype(kl)::value, decltype(kv)::value>
        <<<grid, kThreads, 0, s>>>(a, out, tickets, part, N, C, S, rows_per,
                                   L);
    return (int)cudaGetLastError();
  });
}

template <class T, bool ADD>
int launch_apply(const T* a, const T* addend, const float* scale,
                 const float* shift, T* y, int N, int C, int S, int relu,
                 int lanes, int rows_per, cudaStream_t s) {
  constexpr int V = Elem<T>::V;
  if (N <= 0 || C <= 0 || S <= 0 || rows_per <= 0)
    return (int)cudaErrorInvalidValue;
  const long CS = (long)C * S, nb = column_ranges(CS, lanes, V);
  const long P = (N + (long)rows_per - 1) / rows_per;
  if (nb == 0 || nb > 0x7fffffffL || P > 65535 || (long)N * CS > (1L << 40))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nb, (unsigned)P);
  return with_lanes(lanes, CS % V == 0, [&](auto kl, auto kv) {
    constexpr int LANES = decltype(kl)::value;
    constexpr bool VEC = decltype(kv)::value;
    if (relu)
      apply_kernel<T, ADD, true, LANES, VEC><<<grid, kThreads, 0, s>>>(
          a, addend, scale, shift, y, N, C, S, rows_per);
    else
      apply_kernel<T, ADD, false, LANES, VEC><<<grid, kThreads, 0, s>>>(
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
  return launch_stats(a, out, tickets, part, N, C, S, lanes, rows_per, L,
                      static_cast<cudaStream_t>(stream));
}

// As fused_conv_channel_stats_f32 for a bfloat16 a (its bits as uint16);
// out float32. nb counts column ranges of 8 * lanes elements, and lanes is
// 32, 64, 128 or 256 where C * S % 8 == 0, else 32.
extern "C" int fused_conv_channel_stats_bf16(const bf16* a, float* out,
                                             int* tickets, float* part, int N,
                                             int C, int S, int lanes,
                                             int rows_per, long L,
                                             void* stream) {
  return launch_stats(a, out, tickets, part, N, C, S, lanes, rows_per, L,
                      static_cast<cudaStream_t>(stream));
}

// a, y [N, C, S]; scale, shift [C]; all float32, contiguous, 16-byte
// aligned. relu: 0 or 1. lanes as for the stats; rows_per: rows a block
// (blocks of 256 threads: 256 / lanes row groups of lanes threads).
extern "C" int fused_conv_apply_f32(const float* a, const float* scale,
                                    const float* shift, float* y, int N,
                                    int C, int S, int relu, int lanes,
                                    int rows_per, void* stream) {
  return launch_apply<float, false>(a, nullptr, scale, shift, y, N, C, S,
                                    relu, lanes, rows_per,
                                    static_cast<cudaStream_t>(stream));
}

// As fused_conv_apply_f32, plus the residual addend [N, C, S].
extern "C" int fused_conv_apply_add_f32(const float* a, const float* addend,
                                        const float* scale, const float* shift,
                                        float* y, int N, int C, int S,
                                        int relu, int lanes, int rows_per,
                                        void* stream) {
  return launch_apply<float, true>(a, addend, scale, shift, y, N, C, S, relu,
                                   lanes, rows_per,
                                   static_cast<cudaStream_t>(stream));
}

// As fused_conv_apply_f32 with a and y bfloat16 (scale and shift float32);
// lanes as for fused_conv_channel_stats_bf16.
extern "C" int fused_conv_apply_bf16(const bf16* a, const float* scale,
                                     const float* shift, bf16* y, int N,
                                     int C, int S, int relu, int lanes,
                                     int rows_per, void* stream) {
  return launch_apply<bf16, false>(a, nullptr, scale, shift, y, N, C, S,
                                   relu, lanes, rows_per,
                                   static_cast<cudaStream_t>(stream));
}

// As fused_conv_apply_bf16, plus the bfloat16 residual addend [N, C, S].
extern "C" int fused_conv_apply_add_bf16(const bf16* a, const bf16* addend,
                                         const float* scale,
                                         const float* shift, bf16* y, int N,
                                         int C, int S, int relu, int lanes,
                                         int rows_per, void* stream) {
  return launch_apply<bf16, true>(a, addend, scale, shift, y, N, C, S, relu,
                                  lanes, rows_per,
                                  static_cast<cudaStream_t>(stream));
}
