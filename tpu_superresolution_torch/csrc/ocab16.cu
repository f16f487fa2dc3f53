// K8w16 and K8bw16 — HAT's fused OCAB core at window 16, forward and
// backward, on Hopper's wgmma: 256 queries of a window against the 576
// keys of its 24 x 24 overlap window (upstream HAT's OCAB: ws 16, overlap
// ratio 0.5).
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_ocab.py
//           fused_ocab_core: _fwd_kernel (pallas_call at :311) and
//           _bwd_kernel (pallas_call at :354), at Nq 256, Nk 576.
// Math: that of kernels/fused_ocab.py ocab_core_plain / ocab_core_bwd_plain:
//         A_h  = softmax(q_h k_h^T + bias[h])     (q pre-scaled, fp32)
//         x1   = sw + proj(concat_h bf16(bf16(A_h) v_h))   (fp32)
//         out  = x1 + fc2(bf16(gelu(fc1(bf16(LN2(x1))))))
//       and its backward, with bf16 GEMM operands, fp32 accumulation and
//       the plain version's casts.  The softmax backward's row term
//       rowsum(dA * A) is taken as rowsum(dO * O) (equal in exact
//       arithmetic); the bias sum of the proj is over bf16(dx1) (K5b's
//       column sums of dattn), the others over their operands as there.
// Bound on the H100: at the HAT-SRx4 train step (128 windows, C 180, 6
//       heads of 30, hidden 360) the forward does ~24.2 GFLOP against ~92
//       MB (~0.028 ms at 3.35 TB/s), the backward ~68.4 GFLOP against
//       ~173 MB (~0.069 ms at 989 TFLOP/s).
// Design: K5w16's split (csrc/swin_block_bwd16.cu).  Everything
//       but the attention is token-local, so it runs as K5a
//       (csrc/swin_block_bwd.cuh) over a window's four 64-token units on
//       ``pack_ocab_tiles``' weight stream (``pack_block_tiles``' layout,
//       its qkv part zero), the window layout read as a [windows, 16, 16,
//       C] map; the attention runs as kernels of its own over (window,
//       head) units.  q, k and v come head-major, [windows, nh, N, hdp]
//       bf16 with each row swizzled as the head tiles sit in shared
//       memory (kernels/fused_ocab.py ``to_heads``: C 180's 360-byte rows
//       fit no bulk copy, a head's 64-byte rows do), so a unit's operands
//       are three or four bulk copies.  On the OCAB's path the operands
//       come from the qkv map [B, H, W, 3C] by ocab_heads_kernel (the q
//       windows and the overlap windows with their zero border, head-major,
//       swizzled; one 16-byte store a thread), and ocab_heads_bwd_kernel
//       takes dq, dk, dv back to the map (each element's up to four
//       windows summed in a fixed order in fp32).  Deterministic: static
//       schedules, ordered sums, no atomics.
//   forward (K8w16), two launches (three with the gather from the map):
//     1 ocab_attn_kernel<256, 576, hdp, false>: a fixed head a CTA (cph
//       CTAs a head, each walking its windows in order), the unit's q, k,
//       v bulk-copied (88 KB at hd 32, two stages); each consumer
//       warpgroup takes two 64-query tiles: S against the nine 64-key
//       blocks with the gathered bias (read from L2, [nh, 256, 576] fp32),
//       the row max and sum online, then P = exp(s - max) / sum rounded
//       once and O += P V -> K5a's workspace tiles; the row max and 1 /
//       sum -> [windows, nh, 2, 256] fp32, for the backward.
//     2 K5a MODE_OFWD: O read back, x1 = sw + O Wproj^T + b (fp32, a slot's
//       L2 scratch), LN2 -> y2c, per 64-column hidden chunk h1 = y2c
//       Wfc1^T, GELU, fc2 accumulated over the chunks in registers
//       (wgmma, A from registers, the stream's fc2 tiles K-major), out.
//   backward (K8bw16), four launches (five with the gather's backward):
//     1 K5a MODE_MID on the forward's O: x1, LN2, the MLP forward and
//       back, LN2's backward: dsw = dx1 (K5a's d extra), dattn, dO -> the
//       head tiles, D = rowsum(dO O).
//     2 ocab_attn_kernel<256, 576, hdp, true>: per (window, head), q, k,
//       v, dO, the row statistics and D (107 KB at hd 32); a query-row
//       pass (S, P from the stored statistics, dP = dO V^T, dS, dQ = dS
//       K, the bias gradient += dS) and a key-row pass (S^T = K Q^T, P^T,
//       dP^T, dK = dS^T Q, dV = P^T dO), so no sum crosses CTAs; each CTA
//       owns a [256, 576] fp32 partial of its head's bias gradient, each
//       thread its entries.  The buffer is 77.9 MB at 132 CTAs (the WMMA
//       kernel's was 453 MB, one a window), but the traffic is not
//       smaller: every unit after a CTA's first reads and writes its
//       590 KB partial, a working set past L2, so at the HAT-SRx4 train
//       step it moves 906 MB by design (the read-modify-writes, the
//       first writes and K5c's read), the same bytes as the old buffer
//       written and read once.  Summing straight into the 1,521-entry
//       table is the way to cut it.
//     3 K5b (csrc/swin_block_bwd.cu): dW = dY^T X over the 64-token units
//       for the proj, fc1 and fc2, and the bias sums.
//     4 K5c: the splits', the LayerNorm sums' and the bias-gradient
//       partials summed in a fixed order.
#include "swin_block_bwd.cuh"

namespace swin_bwd {

// K5a's OCAB modes, compiled in swin_block_bwd_i16_<cp>_<hdp>.cu (the
// middle) and swin_block_bwd_i16o_<cp>_<hdp>.cu (the forward's tail)
#define OCAB_TAIL_EXTERN(CP_, HDP_)                                                         \
  extern template int launch_window<16, CP_, HDP_, MODE_MID>(const Args&, int, cudaStream_t); \
  extern template int launch_window<16, CP_, HDP_, MODE_OFWD>(const Args&, int, cudaStream_t);
OCAB_TAIL_EXTERN(96, 16)
OCAB_TAIL_EXTERN(96, 32)
OCAB_TAIL_EXTERN(192, 32)
#undef OCAB_TAIL_EXTERN

}  // namespace swin_bwd

namespace {

using namespace swin_bwd;

constexpr int OA_CONS = 2;                       // consumer warpgroups
constexpr int OA_THREADS = 128 * (OA_CONS + 1);  // + the loader's warpgroup
constexpr int OCAB_NQ = 256;                     // ws 16
constexpr int OCAB_NK = 576;                     // ows 24

// The attention kernels' shared memory (kernels/fused_ocab.py ocab16_plan
// reckons the same): two stages of a unit's head tiles ([NQ, hdp] q and,
// for the backward, dO; [NK, hdp] k and v), the backward's row statistics
// (row max, 1 / sum, D), four barriers.
template <int NQ, int NK, int HDP, bool BWD>
struct OaLayout {
  static constexpr int RB = 2 * HDP;
  static constexpr int QB = NQ * RB;  // a head's q (or dO) tile, bytes
  static constexpr int KB = NK * RB;  // its k (or v) tile
  static constexpr int TILES = (BWD ? 2 : 1) * QB + 2 * KB;
  static constexpr int STAT = BWD ? 3 * NQ * 4 : 0;
  static constexpr int STAGE = TILES + STAT;
  static constexpr int SMEM = 1024 + 2 * STAGE + 4 * 8;
  static_assert(NQ % 128 == 0 && NK % 64 == 0, "64-row tiles, two query tiles a consumer");
  static_assert(QB % 1024 == 0 && KB % 1024 == 0 && STAT % 1024 == 0, "1024-byte aligned tiles");
  static_assert(SMEM <= SMEM_LIMIT, "two stages within the shared memory");
};

struct OcabAttnArgs {
  const bf16* q;      // [windows][nh][NQ][HDP], rows swizzled as in shared memory; q pre-scaled
  const bf16* k;      // [windows][nh][NK][HDP]
  const bf16* v;
  const bf16* doh;    // [windows][nh][NQ][HDP] (backward; K5a's middle)
  const float* drow;  // [windows][nh][NQ]: rowsum(dO O) (backward)
  float* stat;        // [windows][nh][2][NQ]: row max, 1 / sum (the forward writes them)
  const float* bias;  // [nh][NQ][NK] fp32, the gathered bias
  bf16* o;            // forward: O as K5a's workspace, [windows NQ / 64][o_tiles][64][64]
  bf16* dq;           // backward: shaped as q, k, v
  bf16* dk;
  bf16* dv;
  float* prpb;        // backward: [cph][nh][NQ][NK], a CTA's bias-gradient partial
  int windows, nh, cph, o_tiles;
};

// The gathered bias of the thread's score entries, rows row0 and row0 + 8
// of the queries (`brow` row row0 of the head's [NQ, NK] bias), the keys'
// columns col0 + 8 (e >> 2) + 2 q + (e & 1) in the accumulator's layout.
template <int NK>
__device__ __forceinline__ void bias_rows(float (&tv)[32], const float* brow, int col0, int q) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float2 t =
          __ldg(reinterpret_cast<const float2*>(brow + h2 * 8 * NK + col0 + 8 * j + 2 * q));
      tv[4 * j + 2 * h2] = t.x;
      tv[4 * j + 2 * h2 + 1] = t.y;
    }
}

// The same transposed (the key-row pass): rows the keys key0, key0 + 8,
// columns the queries qcol0 + 8 (e >> 2) + 2 q + (e & 1).
template <int NK>
__device__ __forceinline__ void bias_cols(float (&tv)[32], const float* bh, int key0, int qcol0,
                                          int q) {
#pragma unroll
  for (int e = 0; e < 32; ++e)
    tv[e] = __ldg(bh + static_cast<size_t>(qcol0 + 8 * (e >> 2) + 2 * q + (e & 1)) * NK + key0 +
                  8 * ((e >> 1) & 1));
}

// A [64, HDP] result (rows r0, r0 + 8 of the thread) -> a head-major
// [rows][HDP] bf16 tile in global memory, swizzled as the operands.
template <int HDP>
__device__ __forceinline__ void store_rows(bf16* t, const float (&v)[HDP / 2], int r0, int q) {
  char* b = reinterpret_cast<char*>(t);
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int d = 8 * j + 2 * q;
    *reinterpret_cast<uint32_t*>(b + hopper::swizzled_offset<2 * HDP>(r0 * 2 * HDP + 2 * d)) =
        pack_bf16(v[4 * j], v[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(b + hopper::swizzled_offset<2 * HDP>((r0 + 8) * 2 * HDP + 2 * d)) =
        pack_bf16(v[4 * j + 2], v[4 * j + 3]);
  }
}

// The OCAB's attention: the forward's O and row statistics (BWD false) or
// the attention backward (BWD true), one (window, head) unit a stage.
template <int NQ, int NK, int HDP, bool BWD>
__global__ void __launch_bounds__(OA_THREADS, 1) ocab_attn_kernel(const OcabAttnArgs a) {
  using L = OaLayout<NQ, NK, HDP, BWD>;
  constexpr int RB = L::RB, QTN = NQ / 64, KTN = NK / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + 2 * L::STAGE;  // full[2], empty[2]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hh = blockIdx.x / a.cph, first = blockIdx.x - hh * a.cph;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(bars + 8u * s, 1);
      hopper::mbar_init(bars + 8u * (2 + s), 4 * OA_CONS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * OA_CONS) {
    // ---------------------------------------------------------- the loader
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid != 128 * OA_CONS) return;
    int i = 0;
    for (int w = first; w < a.windows; w += a.cph, ++i) {
      const int st = i & 1;
      hopper::mbar_wait(bars + 8u * (2 + st), ((i >> 1) & 1) ^ 1);
      const uint32_t full = bars + 8u * st, at = base + st * L::STAGE;
      const size_t unit = static_cast<size_t>(w) * a.nh + hh;
      hopper::mbar_arrive_expect_tx(full, L::STAGE);
      hopper::bulk_copy(at, a.q + unit * NQ * HDP, L::QB, full);
      hopper::bulk_copy(at + L::QB, a.k + unit * NK * HDP, L::KB, full);
      hopper::bulk_copy(at + L::QB + L::KB, a.v + unit * NK * HDP, L::KB, full);
      if constexpr (BWD) {
        hopper::bulk_copy(at + L::QB + 2 * L::KB, a.doh + unit * NQ * HDP, L::QB, full);
        hopper::bulk_copy(at + L::TILES, a.stat + unit * 2 * NQ, 2 * NQ * 4, full);
        hopper::bulk_copy(at + L::TILES + 2 * NQ * 4, a.drow + unit * NQ, NQ * 4, full);
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int cw = warp >> 2, wi = warp & 3, q = lane & 3;
  const int r0 = 16 * wi + (lane >> 2);  // the thread's rows of a 64-row tile: r0, r0 + 8
  const float neg_inf = -__int_as_float(0x7f800000);
  const float* bh = a.bias + static_cast<size_t>(hh) * NQ * NK;
  float* prpb = BWD ? a.prpb + (static_cast<size_t>(first) * a.nh + hh) * NQ * NK : nullptr;
  int i = 0;
  for (int w = first; w < a.windows; w += a.cph, ++i) {
    const int st = i & 1;
    const uint32_t qbuf = base + st * L::STAGE, kbuf = qbuf + L::QB, vbuf = kbuf + L::KB;
    const size_t unit = static_cast<size_t>(w) * a.nh + hh;
    hopper::mbar_wait(bars + 8u * st, (i >> 1) & 1);
    if constexpr (!BWD) {
      // ======== per query tile: the row max and sum, then O = P V
#pragma unroll 1
      for (int qt = cw; qt < QTN; qt += OA_CONS) {
        const int row0 = 64 * qt + r0;
        uint32_t qf[HDP / 16][4];
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) tile_frag<RB>(qf[kk], qbuf, row0, q, kk);
        const float* brow = bh + static_cast<size_t>(row0) * NK;
        float mx[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f};
        float sc[32], tv[32];
#pragma unroll 1
        for (int kb = 0; kb < KTN; ++kb) {
          zero<32>(sc);
          hopper::wgmma_fence();
          rows_product<HDP>(sc, qf, kbuf + kb * 64 * RB);
          hopper::wgmma_commit();
          bias_rows<NK>(tv, brow, 64 * kb, q);
          hopper::wgmma_wait<0>();
          hopper::fence_operands(sc);
          float bm[2] = {neg_inf, neg_inf};
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            sc[e] += tv[e];
            bm[(e >> 1) & 1] = fmaxf(bm[(e >> 1) & 1], sc[e]);
          }
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            bm[h2] = fmaxf(bm[h2], __shfl_xor_sync(0xffffffffu, bm[h2], 1));
            bm[h2] = fmaxf(bm[h2], __shfl_xor_sync(0xffffffffu, bm[h2], 2));
            const float mn = fmaxf(mx[h2], bm[h2]);
            l[h2] *= __expf(mx[h2] - mn);
            mx[h2] = mn;
          }
#pragma unroll
          for (int e = 0; e < 32; ++e) l[(e >> 1) & 1] += __expf(sc[e] - mx[(e >> 1) & 1]);
        }
        const float inv[2] = {__fdividef(1.f, quad_sum(l[0])), __fdividef(1.f, quad_sum(l[1]))};
        float o[HDP / 2];
        zero<HDP / 2>(o);
#pragma unroll 1
        for (int kb = 0; kb < KTN; ++kb) {
          zero<32>(sc);
          hopper::wgmma_fence();
          rows_product<HDP>(sc, qf, kbuf + kb * 64 * RB);
          hopper::wgmma_commit();
          bias_rows<NK>(tv, brow, 64 * kb, q);
          hopper::wgmma_wait<0>();
          hopper::fence_operands(sc);
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int h2 = (e >> 1) & 1;
            sc[e] = __expf(sc[e] + tv[e] - mx[h2]) * inv[h2];
          }
          uint32_t pf[4][4];
          to_frags(pf, sc);
          hopper::wgmma_fence();
          block_product<HDP>(o, pf, vbuf + kb * 64 * RB);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
        }
        hopper::fence_operands(o);
        store_head<HDP>(a.o + (static_cast<size_t>(w) * QTN + qt) * a.o_tiles * TILE_ELEMS, o, r0,
                        hh * HDP, q);
        if (q == 0) {
          for (int h2 = 0; h2 < 2; ++h2) {
            a.stat[unit * 2 * NQ + row0 + 8 * h2] = mx[h2];
            a.stat[unit * 2 * NQ + NQ + row0 + 8 * h2] = inv[h2];
          }
        }
      }
    } else {
      const uint32_t dob = vbuf + L::KB;
      // sm: [0, NQ) the row max, [NQ, 2 NQ) 1 / sum, [2 NQ, 3 NQ) D
      const float* sm = reinterpret_cast<const float*>(smem_raw + (qbuf + L::TILES - raw));
      const bool init = i == 0;  // this CTA's first unit writes its partial
      // ======== the query rows: S, P, dP = dO V^T, dS; bias gradient += dS; dQ = dS K
#pragma unroll 1
      for (int qt = cw; qt < QTN; qt += OA_CONS) {
        const int row0 = 64 * qt + r0;
        uint32_t qf[HDP / 16][4], dof[HDP / 16][4];
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          tile_frag<RB>(qf[kk], qbuf, row0, q, kk);
          tile_frag<RB>(dof[kk], dob, row0, q, kk);
        }
        float mr[2], ir[2], dr[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          mr[h2] = sm[row0 + 8 * h2];
          ir[h2] = sm[NQ + row0 + 8 * h2];
          dr[h2] = sm[2 * NQ + row0 + 8 * h2];
        }
        const float* brow = bh + static_cast<size_t>(row0) * NK;
        float dq[HDP / 2];
        zero<HDP / 2>(dq);
#pragma unroll 1
        for (int kb = 0; kb < KTN; ++kb) {
          // the thread's entries of the partial, loaded while the block's
          // products run
          float* pr = prpb + static_cast<size_t>(row0) * NK + 64 * kb + 2 * q;
          float2 t[8][2];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2)
              t[j][h2] = init ? make_float2(0.f, 0.f)
                              : *reinterpret_cast<const float2*>(pr + 8 * h2 * NK + 8 * j);
          float sc[32], dp[32], tv[32];
          zero<32>(sc);
          zero<32>(dp);
          hopper::wgmma_fence();
          rows_product<HDP>(sc, qf, kbuf + kb * 64 * RB);
          rows_product<HDP>(dp, dof, vbuf + kb * 64 * RB);
          hopper::wgmma_commit();
          bias_rows<NK>(tv, brow, 64 * kb, q);
          hopper::wgmma_wait<0>();
          hopper::fence_operands(sc);
          hopper::fence_operands(dp);
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int h2 = (e >> 1) & 1;
            const float p = __expf(sc[e] + tv[e] - mr[h2]) * ir[h2];
            dp[e] = p * (dp[e] - dr[h2]);  // dS
          }
          uint32_t dsf[4][4];
          to_frags(dsf, dp);
          hopper::wgmma_fence();
          block_product<HDP>(dq, dsf, kbuf + kb * 64 * RB);
          hopper::wgmma_commit();
          // the bias gradient += dS while dQ runs
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2)
              *reinterpret_cast<float2*>(pr + 8 * h2 * NK + 8 * j) = make_float2(
                  t[j][h2].x + dp[4 * j + 2 * h2], t[j][h2].y + dp[4 * j + 2 * h2 + 1]);
          hopper::wgmma_wait<0>();
        }
        hopper::fence_operands(dq);
        store_rows<HDP>(a.dq + unit * NQ * HDP, dq, row0, q);
      }
      // ======== the key rows: S^T = K Q^T, P^T, dP^T = V dO^T, dS^T;
      //          dK = dS^T Q, dV = P^T dO
#pragma unroll 1
      for (int kt = cw; kt < KTN; kt += OA_CONS) {
        const int row0 = 64 * kt + r0;
        uint32_t kf[HDP / 16][4], vf[HDP / 16][4];
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          tile_frag<RB>(kf[kk], kbuf, row0, q, kk);
          tile_frag<RB>(vf[kk], vbuf, row0, q, kk);
        }
        float dk[HDP / 2], dv[HDP / 2];
        zero<HDP / 2>(dk);
        zero<HDP / 2>(dv);
#pragma unroll 1
        for (int qb = 0; qb < QTN; ++qb) {
          float sc[32], dp[32], tv[32];
          zero<32>(sc);
          zero<32>(dp);
          hopper::wgmma_fence();
          rows_product<HDP>(sc, kf, qbuf + qb * 64 * RB);
          rows_product<HDP>(dp, vf, dob + qb * 64 * RB);
          hopper::wgmma_commit();
          bias_cols<NK>(tv, bh, row0, 64 * qb, q);
          hopper::wgmma_wait<0>();
          hopper::fence_operands(sc);
          hopper::fence_operands(dp);
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int col = 64 * qb + 8 * (e >> 2) + 2 * q + (e & 1);  // the query
            const float p = __expf(sc[e] + tv[e] - sm[col]) * sm[NQ + col];
            sc[e] = p;
            dp[e] = p * (dp[e] - sm[2 * NQ + col]);
          }
          uint32_t pf[4][4], sf[4][4];
          to_frags(pf, sc);
          to_frags(sf, dp);
          hopper::wgmma_fence();
          block_product<HDP>(dk, sf, qbuf + qb * 64 * RB);
          block_product<HDP>(dv, pf, dob + qb * 64 * RB);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
        }
        hopper::fence_operands(dk);
        hopper::fence_operands(dv);
        store_rows<HDP>(a.dk + unit * NK * HDP, dk, row0, q);
        store_rows<HDP>(a.dv + unit * NK * HDP, dv, row0, q);
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bars + 8u * (2 + st));  // the stage is free
  }
}

// The element offset of (row r, dim d) in a head-major [rows, hdp] tile
// stored as the attention kernels' shared-memory tiles (hopper.cuh
// swizzled_offset with 2 hdp-byte rows).
__device__ __forceinline__ int tile_elem(int r, int d, int hdp) {
  const int rb = 2 * hdp;
  return r * hdp + (((d >> 3) ^ (((r * rb) >> 7) & (rb / 16 - 1))) << 3) + (d & 7);
}

struct HeadsArgs {
  const bf16* qkv;   // [b, h, w, 3c], q pre-scaled
  bf16* op[3];       // q [windows, nh, 256, hdp], k and v [windows, nh, 576, hdp]
  int b, h, w, c, nh, hdp;
};

// The OCAB's operands from its qkv map: blockIdx.y the part (q, k, v),
// blockIdx.x a (window, head) unit; q's 16 x 16 window tokens, k's and
// v's 24 x 24 overlap window with a zero border of 4, each row's hd dims
// then zero to hdp, stored swizzled: one 16-byte chunk (8 dims of a row)
// a thread, 2-byte loads (hd need not be even).
__global__ void __launch_bounds__(256) ocab_heads_kernel(const HeadsArgs a) {
  const int part = blockIdx.y, unit = blockIdx.x;
  const int nwh = a.h / 16, nww = a.w / 16;
  const int win = unit / a.nh, hh = unit - win * a.nh;
  const int bimg = win / (nwh * nww), wr = win - bimg * nwh * nww;
  const int wy = wr / nww, wx = wr - wy * nww;
  const int side = part == 0 ? 16 : 24, border = part == 0 ? 0 : 4;
  const int n = side * side, hd = a.c / a.nh, cpr = a.hdp / 8;
  const int rb = 2 * a.hdp;
  bf16* dst = a.op[part] + static_cast<size_t>(unit) * n * a.hdp;
  const unsigned short* src0 = reinterpret_cast<const unsigned short*>(a.qkv) +
                               static_cast<size_t>(bimg) * a.h * a.w * 3 * a.c + part * a.c +
                               hh * hd;
  for (int i = threadIdx.x; i < n * cpr; i += blockDim.x) {
    const int r = i / cpr, js = i - r * cpr;
    const int j = js ^ (((r * rb) >> 7) & (rb / 16 - 1));  // the chunk's dims 8 j ..
    const int y = wy * 16 + r / side - border, x = wx * 16 + r % side - border;
    uint32_t u[4] = {0u, 0u, 0u, 0u};
    if (y >= 0 && y < a.h && x >= 0 && x < a.w) {
      const unsigned short* sp = src0 + (static_cast<size_t>(y) * a.w + x) * 3 * a.c + 8 * j;
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const uint32_t lo = 8 * j + e < hd ? sp[e] : 0u;
        const uint32_t hi = 8 * j + e + 1 < hd ? sp[e + 1] : 0u;
        u[e / 2] = lo | (hi << 16);
      }
    }
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * a.hdp + 8 * js) =
        make_uint4(u[0], u[1], u[2], u[3]);
  }
}

struct HeadsBwdArgs {
  const bf16* g[3];  // dq, dk, dv in the operands' layout
  bf16* gqkv;        // [b, h, w, 3c]
  int b, h, w, c, nh, hdp;
};

// The gather's backward: a thread a map element (pixel, channel); q's from
// its one position, k's and v's from the (up to four) overlap windows that
// hold it, (rows window wy, wy - 1) x (columns wx, wx - 1) summed as
// (g(wy, wx) + g(wy - 1, wx)) + (g(wy, wx - 1) + g(wy - 1, wx - 1)) in
// fp32, rounded once (kernels/fused_ocab.py map_heads_bwd_plain's order).
__global__ void __launch_bounds__(256) ocab_heads_bwd_kernel(const HeadsBwdArgs a) {
  const int c3 = 3 * a.c, hd = a.c / a.nh, nwh = a.h / 16, nww = a.w / 16;
  const long long total = static_cast<long long>(a.b) * a.h * a.w * c3;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * 256) {
    const int ch = static_cast<int>(i % c3);
    const long long pix = i / c3;
    const int x = static_cast<int>(pix % a.w);
    const long long t = pix / a.w;
    const int y = static_cast<int>(t % a.h), bimg = static_cast<int>(t / a.h);
    const int part = ch / a.c, cc = ch - part * a.c, hh = cc / hd, d = cc - hh * hd;
    float s;
    if (part == 0) {
      const int win = (bimg * nwh + y / 16) * nww + x / 16;
      s = __bfloat162float(a.g[0][(static_cast<size_t>(win) * a.nh + hh) * 256 * a.hdp +
                                  tile_elem((y % 16) * 16 + x % 16, d, a.hdp)]);
    } else {
      const int py = y + 4, px = x + 4;
      float tm[2][2];
#pragma unroll
      for (int ay = 0; ay < 2; ++ay)
#pragma unroll
        for (int ax = 0; ax < 2; ++ax) {
          const int wy = py / 16 - ay, wx = px / 16 - ax;
          const int ry = py - 16 * wy, rx = px - 16 * wx;
          const bool in = wy >= 0 && wy < nwh && wx >= 0 && wx < nww && ry < 24 && rx < 24;
          tm[ay][ax] = in ? __bfloat162float(
                                a.g[part][(static_cast<size_t>((bimg * nwh + wy) * nww + wx) *
                                               a.nh + hh) * 576 * a.hdp +
                                          tile_elem(ry * 24 + rx, d, a.hdp)])
                          : 0.f;
        }
      s = (tm[0][0] + tm[1][0]) + (tm[0][1] + tm[1][1]);
    }
    a.gqkv[i] = __float2bfloat16(s);
  }
}

template <int HDP, bool BWD>
int launch_attn(const OcabAttnArgs& a, cudaStream_t s) {
  using L = OaLayout<OCAB_NQ, OCAB_NK, HDP, BWD>;
  auto kernel = ocab_attn_kernel<OCAB_NQ, OCAB_NK, HDP, BWD>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<a.nh * a.cph, OA_THREADS, L::SMEM, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool BWD>
int launch_attn_hdp(const OcabAttnArgs& a, int hdp, cudaStream_t s) {
  return hdp == 16 ? launch_attn<16, BWD>(a, s) : launch_attn<32, BWD>(a, s);
}

template <int MODE>
int launch_tail(const Args& a, int cp, int hdp, int grid, cudaStream_t s) {
  if (cp == 96 && hdp == 16) return launch_window<16, 96, 16, MODE>(a, grid, s);
  if (cp == 96 && hdp == 32) return launch_window<16, 96, 32, MODE>(a, grid, s);
  if (cp == 192 && hdp == 32) return launch_window<16, 192, 32, MODE>(a, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan (kernels/fused_ocab.py ocab16_plan): batch, h, w (the map the
// windows tile, row-major windows of 16 x 16 tokens; window layout is h =
// w = 16), c, nh, hidden, cp, hdp (the stream's padded widths), stages
// (K5a's ring), gelu_tanh, grid (K5a's CTAs), splits (K5b's), cph (the
// attention kernels' CTAs a head).
struct Geo {
  int batch, h, w, c, nh, hidden, cp, hdp, stages, gelu_tanh, grid, splits, cph, windows;
};

Geo read_geo(const int* g) {
  const int windows = g[1] % 16 || g[2] % 16 ? -1 : g[0] * (g[1] / 16) * (g[2] / 16);
  return Geo{g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7], g[8], g[9], g[10], g[11], g[12],
             windows};
}

bool geo_ok(const Geo& g) {
  const bool widths = (g.cp == 96 && (g.hdp == 16 || g.hdp == 32)) || (g.cp == 192 && g.hdp == 32);
  const long long units = 4LL * g.windows, pairs = (units + NCONS - 1) / NCONS;
  return widths && g.windows >= 0 && g.batch >= 0 && g.c >= 1 && g.c <= g.cp && g.nh >= 1 &&
         g.nh <= MAX_HEADS && g.c % g.nh == 0 && g.c / g.nh <= g.hdp && g.nh * g.hdp <= g.cp &&
         g.hidden >= 1 && g.stages >= 2 && g.stages <= MAX_STAGES &&
         g.grid >= 1 && (pairs == 0 || g.grid <= pairs) && g.splits >= 1 &&
         (units == 0 || g.splits <= units) && g.cph >= 1 &&
         (g.windows == 0 || g.cph <= g.windows);
}

// K5a's arguments for the OCAB: the [batch, h, w, c] map of sw (window
// layout: [windows, 16, 16, c]), shift 0, the stream and its biases, O as
// the workspace's first operand; the other operands set by the caller.
Args tail_args(const Geo& g, const void* sw, const void* tiles, const void* bproj,
               const void* bfc1, const void* bfc2, const void* g2, const void* b2, const void* o,
               float eps) {
  Args a{};
  a.batch = g.batch;
  a.h = g.h;
  a.w = g.w;
  a.c = g.c;
  a.nh = g.nh;
  a.chunks = (g.hidden + HC - 1) / HC;
  a.gelu_tanh = g.gelu_tanh;
  a.stages = g.stages;
  a.eps = eps;
  a.vl = 4 * g.cp;
  a.x = static_cast<const bf16*>(sw);
  a.tiles = static_cast<const bf16*>(tiles);
  a.bproj = static_cast<const float*>(bproj);
  a.bfc1 = static_cast<const float*>(bfc1);
  a.bfc2 = static_cast<const float*>(bfc2);
  a.g2 = static_cast<const float*>(g2);
  a.b2 = static_cast<const float*>(b2);
  a.op[OP_O] = const_cast<bf16*>(static_cast<const bf16*>(o));
  a.op_tiles[OP_O] = (g.cp + 63) / 64;
  return a;
}

OcabAttnArgs attn_args(const Geo& g, const void* q, const void* k, const void* v,
                       const void* bias, const void* o, const void* stat) {
  OcabAttnArgs t{};
  t.q = static_cast<const bf16*>(q);
  t.k = static_cast<const bf16*>(k);
  t.v = static_cast<const bf16*>(v);
  t.bias = static_cast<const float*>(bias);
  t.o = const_cast<bf16*>(static_cast<const bf16*>(o));
  t.stat = const_cast<float*>(static_cast<const float*>(stat));
  t.windows = g.windows;
  t.nh = g.nh;
  t.cph = g.cph;
  t.o_tiles = (g.cp + 63) / 64;
  return t;
}

}  // namespace

// K8w16's two launches on one stream.  q [windows, nh, 256, hdp], k, v
// [windows, nh, 576, hdp] (kernels/fused_ocab.py ``to_heads``, or
// ocab_heads_kernel from the qkv map), sw, out [batch, h, w, c] bf16 (the windows
// row-major over the map; window layout [windows, 256, c] is h = w = 16); tiles and the fp32 biases and LN2 parameters as
// ``pack_ocab_tiles`` lays them out; bias [nh, 256, 576] fp32.  Outputs
// besides out: o (K5a's workspace operand, [windows 4][cp / 64][64][64],
// zero past the heads' columns) and stat [windows, nh, 2, 256] fp32, which
// the backward reads; x1ws [grid][2][64 cp] fp32 scratch.  geo: the plan
// (this entry checks it).
extern "C" int sr_ocab16_fwd_bf16(const void* q, const void* k, const void* v, const void* sw,
                                  void* out, const void* tiles, const void* bproj,
                                  const void* bfc1, const void* bfc2, const void* g2,
                                  const void* b2, const void* bias, void* o, void* stat,
                                  void* x1ws, const int* geo, float eps, void* stream) {
  const Geo g = read_geo(geo);
  if (!geo_ok(g) || !aligned_to(q, 16) || !aligned_to(k, 16) || !aligned_to(v, 16) ||
      !aligned_to(tiles, 16) || !aligned_to(bproj, 8) || !aligned_to(bfc1, 8) ||
      !aligned_to(bfc2, 8) || !aligned_to(bias, 16) || !aligned_to(o, 16) ||
      !aligned_to(stat, 16) || !aligned_to(x1ws, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.windows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int status = launch_attn_hdp<false>(attn_args(g, q, k, v, bias, o, stat), g.hdp, s);
  if (status != 0) return status;
  Args a = tail_args(g, sw, tiles, bproj, bfc1, bfc2, g2, b2, o, eps);
  a.out = static_cast<bf16*>(out);
  a.x1ws = static_cast<float*>(x1ws);
  return launch_tail<MODE_OFWD>(a, g.cp, g.hdp, g.grid, s);
}

// K8bw16's four launches on one stream.  ct, sw, dsw [batch, h, w, c]
// bf16; q, k, v and dq, dk, dv head-major as the forward's; tiles, biases,
// LN2 parameters and bias as the forward's; o and stat the forward's
// outputs.  Workspaces (kernels/fused_ocab.py ``ocab16_bytes`` sizes
// them): ws the dW operands of the 64-token units (y2c, act, dattn, dh1,
// dmlp: cp / 64, chunks, cp / 64, chunks, cp / 64 tiles a unit), doh
// [windows, nh, 256, hdp] and drow [windows, nh, 256] (the middle's dO and
// D), x1ws [units + units % 2][64 cp], pvec the middle's LN2 sums
// [grid][2][4][4 cp], prpb [cph][nh][256][576], pw K5b's splits';
// outputs gv ([the weight stream's gradient | the bias sums in the
// stream's bias layout | the LN sums g1 b1 g2 b2, cp each], fp32) and
// dbias [nh, 256, 576].
extern "C" int sr_ocab16_bwd_bf16(const void* ct, const void* q, const void* k, const void* v,
                                  const void* sw, void* dq, void* dk, void* dv, void* dsw,
                                  const void* tiles, const void* bproj, const void* bfc1,
                                  const void* bfc2, const void* g2, const void* b2,
                                  const void* bias, const void* o, const void* stat, void* ws,
                                  void* doh, void* drow, void* x1ws, void* pvec, void* prpb,
                                  void* pw, void* gv, void* dbias, const int* geo, float eps,
                                  void* stream) {
  const Geo g = read_geo(geo);
  if (!geo_ok(g) || !aligned_to(q, 16) || !aligned_to(k, 16) || !aligned_to(v, 16) ||
      !aligned_to(dq, 4) || !aligned_to(dk, 4) || !aligned_to(dv, 4) || !aligned_to(tiles, 16) ||
      !aligned_to(bproj, 8) || !aligned_to(bfc1, 8) || !aligned_to(bfc2, 8) ||
      !aligned_to(bias, 16) || !aligned_to(o, 16) || !aligned_to(stat, 16) ||
      !aligned_to(ws, 16) || !aligned_to(doh, 16) || !aligned_to(drow, 16) ||
      !aligned_to(x1ws, 16) || !aligned_to(pvec, 8) || !aligned_to(prpb, 8) || !aligned_to(pw, 4) ||
      !aligned_to(gv, 4) || !aligned_to(dbias, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.windows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long units = 4LL * g.windows;
  const int kc = (g.cp + 63) / 64;
  Args a = tail_args(g, sw, tiles, bproj, bfc1, bfc2, g2, b2, o, eps);
  a.ct = static_cast<const bf16*>(ct);
  a.dextra = static_cast<bf16*>(dsw);  // dx1 = dsw
  a.doh = static_cast<bf16*>(doh);
  a.drow = static_cast<float*>(drow);
  a.x1ws = static_cast<float*>(x1ws);
  a.pvec = static_cast<float*>(pvec);
  const int ops[] = {OP_Y2C, OP_ACT, OP_DATTN, OP_DH1, OP_DMLP};
  const int tiles_of[] = {kc, a.chunks, kc, a.chunks, kc};
  bf16* p = static_cast<bf16*>(ws);
  for (int i = 0; i < 5; ++i) {
    a.op[ops[i]] = p;
    a.op_tiles[ops[i]] = tiles_of[i];
    p += units * tiles_of[i] * TILE_ELEMS;
  }
  int status = launch_tail<MODE_MID>(a, g.cp, g.hdp, g.grid, s);
  if (status != 0) return status;

  OcabAttnArgs t = attn_args(g, q, k, v, bias, o, stat);
  t.doh = a.doh;
  t.drow = a.drow;
  t.dq = static_cast<bf16*>(dq);
  t.dk = static_cast<bf16*>(dk);
  t.dv = static_cast<bf16*>(dv);
  t.prpb = static_cast<float*>(prpb);
  status = launch_attn_hdp<true>(t, g.hdp, s);
  if (status != 0) return status;

  // K5b over the proj, fc1 and fc2 (no qkv operands: its product has no
  // units), then K5c; the stream's layout as ``pack_block_tiles``'
  const int pwid = part_width(g.cp), nhalf = g.cp / pwid, q3 = 3 * g.hdp;
  const long long stream_len = static_cast<long long>(g.nh) * kc * q3 * 64 +
                               static_cast<long long>(nhalf) * kc * pwid * 64 +
                               static_cast<long long>(a.chunks) * (kc * 4096 + nhalf * pwid * 64);
  const long long bias_len = g.nh * q3 + 2LL * g.cp + a.chunks * HC;
  float* wgrad = static_cast<float*>(gv);
  float* vec = wgrad + stream_len;
  const long long ln_rows = static_cast<long long>(g.grid) * NCONS * 4;
  return launch_wgrad_reduce(
      a, units, g.cp, g.hdp, g.splits, static_cast<float*>(pw), wgrad, vec,
      {static_cast<const float*>(pvec), ln_rows, a.vl, vec + bias_len},
      {static_cast<const float*>(prpb), g.cph, static_cast<long long>(g.nh) * OCAB_NQ * OCAB_NK,
       static_cast<float*>(dbias)},
      s);
}

// The OCAB's operands from its qkv map (ocab_heads_kernel): qkv [b, h, w,
// 3c] bf16 (h, w multiples of 16) -> q [windows, nh, 256, hdp], k, v
// [windows, nh, 576, hdp], as kernels/fused_ocab.py map_heads_plain.
extern "C" int sr_ocab16_heads_bf16(const void* qkv, void* q, void* k, void* v, int b, int h,
                                    int w, int c, int nh, int hdp, void* stream) {
  if (b < 0 || h % 16 || w % 16 || c < 1 || nh < 1 || c % nh || c / nh > hdp ||
      (hdp != 16 && hdp != 32) || !aligned_to(q, 16) || !aligned_to(k, 16) || !aligned_to(v, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long units = static_cast<long long>(b) * (h / 16) * (w / 16) * nh;
  if (units == 0) return 0;
  HeadsArgs a{static_cast<const bf16*>(qkv),
              {static_cast<bf16*>(q), static_cast<bf16*>(k), static_cast<bf16*>(v)},
              b, h, w, c, nh, hdp};
  ocab_heads_kernel<<<dim3(static_cast<unsigned>(units), 3), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Its backward (ocab_heads_bwd_kernel): dq, dk, dv in the operands' layout
// -> dqkv [b, h, w, 3c] bf16, as kernels/fused_ocab.py map_heads_bwd_plain.
extern "C" int sr_ocab16_heads_bwd_bf16(const void* dq, const void* dk, const void* dv,
                                        void* dqkv, int b, int h, int w, int c, int nh, int hdp,
                                        void* stream) {
  if (b < 0 || h % 16 || w % 16 || c < 1 || nh < 1 || c % nh || c / nh > hdp ||
      (hdp != 16 && hdp != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(b) * h * w * 3 * c;
  if (total == 0) return 0;
  HeadsBwdArgs a{{static_cast<const bf16*>(dq), static_cast<const bf16*>(dk),
                  static_cast<const bf16*>(dv)},
                 static_cast<bf16*>(dqkv), b, h, w, c, nh, hdp};
  const long long blocks = (total + 255) / 256;
  ocab_heads_bwd_kernel<<<static_cast<unsigned>(blocks < 132 * 64 ? blocks : 132 * 64), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
