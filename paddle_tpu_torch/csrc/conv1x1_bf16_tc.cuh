// The bf16 chain's 1x1 tile on Hopper's warpgroup products, fed by TMA
// (csrc/sm90.cuh): y = W·B over K channels at every position of N·S, with
// the addend of an epilogue brought beside it, for conv1x1_bn_residual_bf16
// (tile1x1_bf16_kernel<BM, kResidual>) and bwd_final_bf16's dx
// (tile1x1_bf16_kernel<BM, kDx>). Included by csrc/fused_block_bf16.cu
// after csrc/abt_bf16_tc.cuh, whose stages, grouped tensor maps, skewed
// and tail boxes and gathers (abw::) it uses.
//
// Replaces, in bf16, paddle_tpu/kernels/fused_block.py's _assemble_kernel
// (:735, pallas_call :756): out = relu(fma(W3 h2, sc3, sh3) + x), h2 =
// bf16(relu(fma(a2, sc2, sh2))), a3 float32, out rounded once; and the dx
// of its _b3_kernel (:436, pallas_call :466): dx = bf16(W1ᵀ da1 + g3). The
// earlier design (c1::conv1x1_bf16_kernel modes 1 and 3, still the tile of
// conv1x1_stats_bf16 and bwd_apply3_bf16) read the residual and wrote the
// output a bf16 at a time, ran K = 64 in two 32-deep stages through
// registers, re-read and re-normalized a2 in each row tile of Cout, on
// mma.sync.
//
// What bounds it on the H100 (ResNet-50's chain stages, batch 128): the
// residual (g3) in and the output out, M = Cout (Cin) rows each, and the K
// = C rows of a2 (da1): 462.4 / 231.2 / 115.6 MB at 56² / 28² / 14², 0.1380
// / 0.0690 / 0.0345 ms at 3.35 TB/s; its 13.2 GFLOP are 0.0133 ms at 989
// TFLOP/s: bytes.
//
// The design. One block an SM (its shared memory), warp-specialised, the
// stages of a split in a ring (abw::load_rows: B's K rows in 64-row
// tiles and the addend's BM rows, each a tile of 128-byte swizzled rows;
// grouped maps, skewed boxes and tail boxes where S % 8 != 0), each stage
// through four roles in turn on mbarriers:
//   - warp 0's lane 0 keeps the ring full by TMA (full);
//   - warpgroup 1 makes B in place (h2 = bf16(relu(fma(a2, sc, sh))), 0
//     past S; for kDx only the rows of skewed boxes moved back), a row's
//     8 chunks 8 lanes of one warp, which read before any writes; then a
//     proxy fence (ready);
//   - two consumer warpgroups own BM / 2 rows of M each: K / 16 SS wgmma
//     m64n64k16 a 64-row tile (A K-major by desc_k, B MN-major by
//     desc_mn: positions along N), then the epilogue in float32 over the
//     addend's tile in shared memory, each output pair rounded once and
//     written back in place over the pair it read (no two-byte global
//     loads or stores); where S % 8 != 0 they write the tile out from
//     shared memory, in 8-byte runs where S % 4 == 0, else value by value
//     (done);
//   - warp 1's lane 0 stores the tile by one TMA store where S % 8 == 0,
//     waits until the store has read it and frees the stage (empty).
// A = W [M][K] (K-major) is brought once a block into shared memory in
// the order wgmma reads it (rows and columns permuted as the grouped maps
// permute the channels of the addend and of B). BM is 256 where K <= 128,
// so at 56² one block covers all of Cout and each a2 tile is read and
// normalized once; where M is wider the row tiles of a split run side by
// side (blockIdx.x) and share B's tiles through L2. The ring holds as
// many stages as shared memory takes, up to 4 (3 at K 256).
// Registers: 128 a thread by the launch bounds, moved by setmaxnreg to 56
// (copies and stores), 104 (B's makers) and 176 (consumers); 32 (BM 128)
// or 64 (BM 256) float32 accumulators a consumer thread. At 14² (K 256,
// 8 row tiles of Cout 1024) every row tile makes and reads all of B: a
// 64-thread maker (warps 2-3 of warpgroup 0) took 0.21 ms there, 128
// threads 0.14.
#pragma once

namespace t1 {

// Warpgroups: 0 the copies and the stores, 1 B's makers, 2-3 consumers.
constexpr int kThreads = 512;
constexpr int kMakers = 128;           // threads that make B
constexpr int kConsumer0 = 256;        // the first consumer thread
// setmaxnreg of the three kinds of warpgroup: 56 + 104 + 2 x 176 = 4 x
// 128, the 64K registers of a block (at 40 the copies spill; at 4 rows
// in flight the makers do)
constexpr int kProducerRegs = 56;
constexpr int kMakerRegs = 104;
constexpr int kConsumerRegs = 176;
constexpr int kRowsInFlight = 2;       // rows of B a maker reads, then writes
constexpr int kMaxK = 256;             // the widest K a block holds whole
constexpr int kMaxRing = 4;            // stages in flight at most
constexpr uint32_t kSmemCap = 232448;  // a block's dynamic shared memory
// the epilogues: kResidual out = bf16(relu(fma(acc, sc3, sh3) + residual))
// with B = h2 made from a2; kDx dx = bf16(acc + g3) with B = da1 as it is
enum { kResidual = 0, kDx = 1 };

// The tails of a tile of `rows` channels in k boxes: the 8 values past
// each box row of boxes 1 .. k - 1 (box 0 starts on 16 bytes).
__host__ __device__ constexpr uint32_t tails_of(int rows, int k) {
  return (uint32_t)(k - 1) * abw::tail_bytes(rows / k);
}

// The block's shared memory from its (1024-byte aligned) base: W's tile
// (BM / 64 row tiles by kt 64-column boxes), then the ring of stages (B's
// kt tiles, the addend's BM rows, then their tails), h2's normalize
// (kMaxK scales, then shifts), and the mbarriers full, ready, done and
// empty of each stage.
struct Layout {
  uint32_t ring, stage, add, btail, atail, vec, bar, bytes;
  __host__ __device__ Layout(int bm, int kt, int k, int ns) {
    ring = (uint32_t)bm * kt * 128;
    add = (uint32_t)kt * abw::kTile;
    btail = add + (uint32_t)bm * 128;
    atail = btail + kt * tails_of(64, k);
    stage = (atail + tails_of(bm, k) + 1023u) & ~1023u;
    vec = ring + ns * stage;
    bar = vec + 2 * kMaxK * 4;
    bytes = bar + 32 * ns + 1024;
  }
};

struct Args {
  const bf16* w;      // A: [M][lda], K-major (W3, or W1ᵀ), zeros past K
  const float* sc;    // kResidual: h2's normalize [K]
  const float* sh;
  const float* f0;    // kResidual: bn3's affine [M]
  const float* f1;
  bf16* y;            // [N, M, S] (written by the consumers where k > 1)
  int N, M, K, S, lda, cpi, stages, splits, k, lk, kt, ring;
};

template <int BM, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
tile1x1_bf16_kernel(const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap te,
                    const __grid_constant__ CUtensorMap tb_tail,
                    const __grid_constant__ CUtensorMap te_tail,
                    const __grid_constant__ CUtensorMap ty, const Args p) {
  constexpr int MT = BM / 128;            // 64-row tiles a consumer warpgroup
  constexpr int RW = BM / 2;              // rows a consumer warpgroup
  constexpr int kLogBM = BM == 256 ? 8 : 7;
  extern __shared__ float4 smem4[];
  const uint32_t base = sm90::aligned_base(smem4);
  char* const sp = reinterpret_cast<char*>(smem4) +
                   (base - sm90::smem_u32(smem4));
  const int KT = p.kt, NS = p.ring, k = p.k, S = p.S, M = p.M;
  const Layout L(BM, KT, k, NS);
  // full: the stage's boxes have landed; ready: B is made; done: the
  // epilogue's tile is written (and, where k > 1, written out); empty:
  // the tile has been stored, the stage is free
  const auto full = [&](int s) { return base + L.bar + 8 * s; };
  const auto ready = [&](int s) { return full(NS + s); };
  const auto done = [&](int s) { return full(2 * NS + s); };
  const auto empty = [&](int s) { return full(3 * NS + s); };
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      sm90::bar_init(full(s), 1);
      sm90::bar_init(ready(s), kMakers);  // each thread that makes B
      sm90::bar_init(done(s), 2);     // a thread of each consumer warpgroup
      sm90::bar_init(empty(s), 1);    // the store thread
    }
    sm90::bar_init_fence();
  }
  const int m0 = BM * (int)blockIdx.x, split = blockIdx.y;
  const int g0 = (int)((long)split * p.stages / p.splits);
  const int nst = (int)((long)(split + 1) * p.stages / p.splits) - g0;
  const int lb = 6 - p.lk;          // log2 of a K tile's box rows
  const int la = kLogBM - p.lk;     // log2 of the addend's box rows
  // W's tile, once, by all threads: W's row m0 + m at the tile row that
  // the addend's grouped map gives channel m, its channel c at the column
  // that B's gives c (k = 1: both as they are); 0 past M (and, by the
  // wrapper's padding, past K); and h2's normalize in B's row order
  {
    const int chunks = 8 * KT;  // 16-byte chunks of a row of 64 KT columns
    for (int i = tid; i < BM * chunks; i += kThreads) {
      const int m = i / chunks, q = i - m * chunks;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + m < M)
        v = __ldg(reinterpret_cast<const uint4*>(p.w + (long)(m0 + m) * p.lda +
                                                 8 * q));
      const int r = ((m & (k - 1)) << la) | (m >> p.lk);
      const int rr = r & 63, kt = q >> 3;
      char* const row = sp + ((r >> 6) * KT + kt) * abw::kTile + rr * 128;
      if (k == 1) {
        *reinterpret_cast<uint4*>(row + ((((q & 7) ^ rr) & 7) << 4)) = v;
        continue;
      }
      bf16 h[8];
      abw::unpack8(v, h);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int cc = 8 * (q & 7) + e;
        const int c = ((cc & (k - 1)) << lb) | (cc >> p.lk);
        *reinterpret_cast<bf16*>(row + ((((c >> 3) ^ rr) & 7) << 4) +
                                 (c & 7) * 2) = h[e];
      }
    }
  }
  float* const vec = reinterpret_cast<float*>(sp + L.vec);
  if (kMode == kResidual) {
    for (int r = tid; r < 64 * KT; r += kThreads) {
      const int ch = 64 * (r >> 6) + abw::chan_of(r & 63, p.lk, lb);
      vec[r] = ch < p.K ? __ldg(p.sc + ch) : 0.f;  // h2 0 past K
      vec[kMaxK + r] = ch < p.K ? __ldg(p.sh + ch) : 0.f;
    }
  }
  sm90::fence_proxy_async();
  __syncthreads();  // the barriers, W's tile and the vectors are in place

  if (tid < kConsumer0) {
    if (wg == 0)
      sm90::regs_dec<kProducerRegs>();
    else
      sm90::regs_dec<kMakerRegs>();
    if (wg == 1) {
      // B's rows in place, a stage ahead of the consumers: h2 (0 past S
      // and past K), or da1's rows of boxes j >= 1 moved back by their
      // skew; a row's 8 chunks are 8 lanes of one warp, which read before
      // any writes, and a warp's 4 rows lie in one box, so a warp skips or
      // transforms together
      constexpr int RP = kMakers / 8;  // rows a pass
      const int u = tid - 128, cc = u & 7;
      for (int q = 0; q < nst; ++q) {
        const int s = q % NS;
        int n, s0;
        abw::stage_of(g0 + q, p.cpi, n, s0);
        const int lim = min(abw::kPos, S - s0);
        abw::wait(full(s), (q / NS) & 1);
        char* const st = sp + L.ring + s * L.stage;
        // kRowsInFlight rows a thread: their reads, then their writes
        constexpr int F = kRowsInFlight;
        char* const tails = st + L.btail - abw::tail_bytes(64 / k);
        for (int it = 0; (kMode == kResidual || k > 1) && it < 64 / RP * KT;
             it += F) {
          bf16 a[F][8];
          bool make[F];
#pragma unroll
          for (int i = 0; i < F; ++i) {
            const int r = (u >> 3) + RP * (it + i), kt = r >> 6, rr = r & 63;
            const int sk = abw::skew_of(rr >> lb, S);
            make[i] = kMode == kResidual || sk != 0;
            if (make[i])
              abw::gather8(st + kt * abw::kTile, tails + kt * tails_of(64, k),
                           rr, 8 * cc + sk, a[i]);
          }
          if (k > 1) __syncwarp();
#pragma unroll
          for (int i = 0; i < F; ++i) {
            if (!make[i]) continue;
            const int r = (u >> 3) + RP * (it + i), kt = r >> 6, rr = r & 63;
            uint4 v;
            if (kMode == kResidual) {
              const float sc = vec[r], sh = vec[kMaxK + r];
              uint32_t w[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int x = 8 * cc + 2 * e;
                w[e] = cvt_bf2(
                    x < lim ? relu_affine(bf(a[i][2 * e]), sc, sh) : 0.f,
                    x + 1 < lim ? relu_affine(bf(a[i][2 * e + 1]), sc, sh)
                                : 0.f);
              }
              v = make_uint4(w[0], w[1], w[2], w[3]);
            } else {
              v = abw::pack8(a[i]);
            }
            *reinterpret_cast<uint4*>(st + kt * abw::kTile + rr * 128 +
                                      ((cc ^ (rr & 7)) << 4)) = v;
          }
        }
        sm90::fence_proxy_async();
        sm90::bar_arrive(ready(s));
      }
    } else if (tid == 0) {
      // the loads: B's kt tiles and the addend's rows a stage
      const uint32_t bytes =
          KT * abw::stage_bytes(64, k) + abw::stage_bytes(BM, k);
      for (int q = 0; q < nst; ++q) {
        const int s = q % NS;
        int n, s0;
        abw::stage_of(g0 + q, p.cpi, n, s0);
        abw::wait(empty(s), ((q / NS) & 1) ^ 1);
        sm90::bar_expect_tx(full(s), bytes);
        const uint32_t st = base + L.ring + s * L.stage;
        for (int kt = 0; kt < KT; ++kt)
          abw::load_rows(st + kt * abw::kTile,
                         st + L.btail + kt * tails_of(64, k) -
                             abw::tail_bytes(64 / k),
                         &tb, &tb_tail, full(s), n, s0, 64 * kt, 64, k, S);
        abw::load_rows(st + L.add,
                       st + L.atail - abw::tail_bytes(BM / k), &te,
                       &te_tail, full(s), n, s0, m0, BM, k, S);
      }
    } else if (tid == 32) {
      // the stores: each stage's tile out by one TMA store where S % 8
      // == 0 (positions past S and rows past M are not written), the
      // stage freed once the store has read it
      for (int q = 0; q < nst; ++q) {
        const int s = q % NS;
        int n, s0;
        abw::stage_of(g0 + q, p.cpi, n, s0);
        abw::wait(done(s), (q / NS) & 1);
        if (k == 1) {
          sm90::tma_store_4d(&ty, base + L.ring + s * L.stage + L.add, s0,
                             m0, n, 0);
          sm90::bulk_commit();
          sm90::bulk_wait_read();
        }
        sm90::bar_arrive(empty(s));
      }
    }
    return;
  }

  sm90::regs_inc<kConsumerRegs>();
  const int u = tid - kConsumer0, cw = u >> 7, uw = u & 127;
  const int lane = tid & 31, warp = (tid / 32) & 3, g = lane >> 2, t = lane & 3;
  // this thread's epilogue rows r = RW cw + 64 mt + 16 warp + g + 8 hf
  // and their bn3 affines
  float s3[MT][2], h3[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = RW * cw + 64 * mt + 16 * warp + g + 8 * hf;
      const int ch = m0 + abw::chan_of(r, p.lk, la);
      s3[mt][hf] = kMode == kResidual && ch < M ? __ldg(p.f0 + ch) : 0.f;
      h3[mt][hf] = kMode == kResidual && ch < M ? __ldg(p.f1 + ch) : 0.f;
    }
  const uint32_t sa = base + cw * MT * KT * abw::kTile;
  float acc[MT][32];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[mt][e] = 0.f;
  for (int q = 0; q < nst; ++q) {
    const int s = q % NS;
    int n, s0;
    abw::stage_of(g0 + q, p.cpi, n, s0);
    const int lim = min(abw::kPos, S - s0);
    abw::wait(ready(s), (q / NS) & 1);
    char* const st = sp + L.ring + s * L.stage;
    const uint32_t sb = base + L.ring + s * L.stage;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) sm90::fence_operands(acc[mt]);
    sm90::wg_fence();
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          sm90::wgmma_ss<64, 1>(
              acc[mt], sm90::desc_k(sa + (mt * KT + kt) * abw::kTile, ks),
              sm90::desc_mn(sb + kt * abw::kTile, ks), (kt | ks) != 0);
    sm90::wg_commit();
    sm90::wg_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) sm90::fence_operands(acc[mt]);

    // the epilogue over the addend's tile, in place: a thread's pairs of
    // positions x, x + 1 (x = 8 j + 2 t) of its rows, at their box's skew
    char* const et = st + L.add;
    char* const etail = st + L.atail - abw::tail_bytes(BM / k);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = RW * cw + 64 * mt + 16 * warp + g + 8 * hf;
        const int sk = abw::skew_of(r >> la, S);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int x = 8 * j + 2 * t + sk;
          char* const a0 = abw::value_at(et, etail, r, x);
          char* const a1 = abw::value_at(et, etail, r, x + 1);
          bf16 e0, e1;
          if ((sk & 1) == 0) {  // the pair is 4 bytes
            const uint32_t ev = *reinterpret_cast<const uint32_t*>(a0);
            e0 = (bf16)(ev & 0xffffu), e1 = (bf16)(ev >> 16);
          } else {
            e0 = *reinterpret_cast<const bf16*>(a0);
            e1 = *reinterpret_cast<const bf16*>(a1);
          }
          const float v0 = acc[mt][4 * j + 2 * hf];
          const float v1 = acc[mt][4 * j + 2 * hf + 1];
          uint32_t o;
          if (kMode == kResidual)
            o = cvt_bf2(fmaxf(fmaf(v0, s3[mt][hf], h3[mt][hf]) + bf(e0), 0.f),
                        fmaxf(fmaf(v1, s3[mt][hf], h3[mt][hf]) + bf(e1), 0.f));
          else
            o = cvt_bf2(v0 + bf(e0), v1 + bf(e1));
          if ((sk & 1) == 0) {
            *reinterpret_cast<uint32_t*>(a0) = o;
          } else {
            *reinterpret_cast<bf16*>(a0) = (bf16)(o & 0xffffu);
            *reinterpret_cast<bf16*>(a1) = (bf16)(o >> 16);
          }
        }
      }
    if (k == 1) {
      sm90::fence_proxy_async();  // the store thread's TMA store reads it
    } else {
      // rows start off 16 bytes: each row's 8 lanes write it from the tile
      // as two runs of 4 lanes x 8 bytes where S % 4 == 0 (whole 32-byte
      // sectors a store), else value by value, lane c at positions c + 8 e
      sm90::named_sync(2 + cw, 128);
      const int cc = uw & 7;
#pragma unroll 1
      for (int it = 0; it < RW / 16; ++it) {
        const int r = RW * cw + (uw >> 3) + 16 * it;
        const int ch = m0 + abw::chan_of(r, p.lk, la);
        if (ch >= M) continue;
        const int sk = abw::skew_of(r >> la, S);
        bf16* const dst = p.y + ((long)n * M + ch) * S + s0;
        if ((S & 3) == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 32 * h + 4 * cc;
            if (x >= lim) continue;
            const uint2 v = *reinterpret_cast<const uint2*>(
                abw::value_at(et, etail, r, x + sk));
            if (x + 4 <= lim) {
              *reinterpret_cast<uint2*>(dst + x) = v;
            } else {
              const bf16 hv[4] = {(bf16)(v.x & 0xffffu), (bf16)(v.x >> 16),
                                  (bf16)(v.y & 0xffffu), (bf16)(v.y >> 16)};
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (x + e < lim) dst[x + e] = hv[e];
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int x = cc + 8 * e;
            if (x < lim)
              dst[x] = *reinterpret_cast<const bf16*>(
                  abw::value_at(et, etail, r, x + sk));
          }
        }
      }
    }
    sm90::named_sync(2 + cw, 128);  // the warpgroup's rows are done
    if (uw == 0) sm90::bar_arrive(done(s));
  }
}

// ---------------------------------------------------------------------------
// the host side
// ---------------------------------------------------------------------------

// Rows of M a block: 256 where K fits beside them, else 128.
inline int rows_of(int M, int K) { return M <= 128 || K > 128 ? 128 : 256; }

// The most stages in flight that the block's shared memory holds.
inline int ring_of(int bm, int kt, int k) {
  for (int ns = kMaxRing; ns >= 1; --ns)
    if (Layout(bm, kt, k, ns).bytes <= kSmemCap) return ns;
  return 0;
}

template <int BM, int kMode>
int launch_bm(const CUtensorMap (&maps)[5], const Args& p, int rtiles,
              cudaStream_t s) {
  const Layout L(BM, p.kt, p.k, p.ring);
  cudaFuncSetAttribute(tile1x1_bf16_kernel<BM, kMode>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L.bytes);
  tile1x1_bf16_kernel<BM, kMode><<<dim3((unsigned)rtiles,
                                        (unsigned)p.splits),
                                   kThreads, L.bytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], p);
  return (int)cudaGetLastError();
}

// y [N, M, S] = the epilogue of kMode over W·B, B [N, K, S] (a2 or da1),
// the addend e [N, M, S] (the residual or g3), w [M, lda] (lda a multiple
// of 64 >= K, zeros past K); K at most kMaxK, M and K multiples of
// abw::group_of(S); split p takes the 64-position stages [p Q / splits, (p
// + 1) Q / splits) of the Q = N ceil(S / 64), for every row tile.
template <int kMode>
int launch(const bf16* b, const bf16* e, const bf16* w, const float* sc,
           const float* sh, const float* f0, const float* f1, bf16* y, int N,
           int M, int K, int S, int lda, int splits, cudaStream_t s) {
  if (!abw::ok(N, M, K, S, splits) || K > kMaxK || lda % 64 || lda < K ||
      (reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(y)) % 16)
    return (int)cudaErrorInvalidValue;
  const int k = abw::group_of(S), bm = rows_of(M, K), kt = (K + 63) / 64;
  const int ns = ring_of(bm, kt, k);
  CUtensorMap maps[5];
  if (ns == 0 || abw::encode_rows(&maps[0], b, N, K, S, 64, false) ||
      abw::encode_rows(&maps[1], e, N, M, S, bm, false) ||
      abw::encode_rows(&maps[2], b, N, K, S, 64, true) ||
      abw::encode_rows(&maps[3], e, N, M, S, bm, true))
    return (int)cudaErrorInvalidValue;
  maps[4] = maps[1];  // the store's map: y where k == 1, else not read
  if (k == 1 && abw::encode_rows(&maps[4], y, N, M, S, bm, false))
    return (int)cudaErrorInvalidValue;
  const Args p{w, sc, sh, f0, f1, y, N, M, K, S, lda,
               (S + abw::kPos - 1) / abw::kPos, (int)abw::stages_of(N, S),
               splits, k, abw::log2_of(k), kt, ns};
  const int rtiles = (M + bm - 1) / bm;
  return bm == 128 ? launch_bm<128, kMode>(maps, p, rtiles, s)
                   : launch_bm<256, kMode>(maps, p, rtiles, s);
}

}  // namespace t1
