// K5w16 and K5r — the backward of one Swin transformer block on the K7
// route, with the gradient of HAT's additive term `extra`, on Hopper's
// wgmma, at any MLP hidden (K5a walks it in 64-column chunks): K5w16 at
// window 16 (256-token windows, the block kernel's C and heads: upstream
// HAT-SRx4's HAB at hidden 360, the JAX train CLI's HAT at hidden 720),
// K5r at window 8 past the block kernel's widths (SwinIR-L: C 240, 8
// heads, hidden 480 or 960; to C 256, 8 heads of hd <= 32, one
// instantiation at padded width 256).
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_block.py
//           _mega_backward -> _bwd_kernel (pallas_call at :1080) at ws 16
//           and at ws 8 at those widths, where megakernel_tpu_ok (:210)
//           holds (upstream HAT-SRx4; SwinIR-L, models/swinir.py:223-228).
// Math: that of csrc/swin_block_bwd.cu (kernels/fused_block.py::
//       swin_block_bwd_plain): recompute the forward, chain the cotangent
//       through MLP, LN2, proj, attention, qkv and LN1, with bf16 GEMM
//       operands, fp32 accumulation and the same casts; the bias and the
//       shift mask from the [nh, 31^2] table and one code a token.  One
//       difference in arithmetic: the softmax backward's row term
//       rowsum(dA * A) is taken as rowsum(dO * O) per head (equal in exact
//       arithmetic, since O = A V and dA = dO V^T).
// Bound on the H100: at HAT-SRx4's train shape [8,64,64,180] (128
//       windows, 6 heads of 30, hidden 360) ~64.8 GFLOP of bf16 products
//       at the unpadded widths against ~59 MB in and out: compute-bound,
//       ~0.066 ms at the 989 TFLOP/s peak.  The design moves ~625 MB
//       (workspaces written and read once; chip_smoke.py's "bytes moved"
//       line), ~0.19 ms at 3.35 TB/s; its launches are latency-bound.
//       K5r at SwinIR-L's [8,64,64,240] (512 windows, 8 heads of 30,
//       hidden 480): ~89.1 GFLOP against ~47 MB, ~0.090 ms at the peak.
//       The MLP's share is 10 C hidden a token (fc1 recomputed, two
//       products back for each of fc1 and fc2), so hidden 720 at C 180 takes
//       K5w16 to ~86.1 GFLOP (~0.087 ms), hidden 960 at C 240 K5r to
//       ~126.8 GFLOP (~0.128 ms).
// Design: everything but the attention is token-local, so the window's
//       four 64-token tiles run through K5a (csrc/swin_block_bwd.cuh) as
//       its units, on the forward's pack_block_tiles stream, and the
//       attention runs as kernels of its own over (window, head) units.
//       Seven launches, all deterministic (static schedules, ordered sums,
//       no atomics):
//   1 K5a front: LN1 -> yc (workspace); per head q, k, v -> the window's
//       [ws^2, hdp] head tiles, swizzled as in shared memory.
//   2 attn16_kernel<ws, hdp, false>: per (window, head), the head's q, k, v
//       bulk-copied (48 KB at hd 32, two stages); each consumer warpgroup
//       takes two 64-query tiles: S against the four 64-key blocks, the
//       row max and sum online, then P = exp(s - max) / sum rounded once
//       and O += P V -> the workspace's O; the row max and 1 / sum ->
//       [windows, nh, 2, 256] fp32, written once.
//   3 K5a middle: O read back, x1, LN2, the MLP forward and back, LN2's
//       backward (dx1 fp32 to a per-tile scratch, dextra), dattn, do ->
//       the window's head tiles and the row term D = rowsum(do o).
//   4 attn16_kernel<ws, hdp, true>: per (window, head), q, k, v, do, the row
//       statistics and D (67 KB); a query-row pass (S, P from the stored
//       statistics, dP = dO V^T, dS, dQ = dS K, d(rpb) += dS) and a
//       key-row pass (S^T = K Q^T, P^T, dP^T, dK = dS^T Q, dV = P^T dO),
//       so no sum crosses CTAs.  The grid keeps a fixed head a CTA (cph
//       CTAs a head, each walking its windows in order), and each thread
//       owns its entries of its CTA's [256, 256] fp32 d(rpb) partial
//       (34.6 MB in all at the train shape, L2's; a block's entries are
//       loaded before its products are issued).  At ws 8 (K5r) a window is
//       one 64-token tile, so a stage holds four windows of the CTA's head
//       (a consumer warpgroup takes two), and each consumer warpgroup keeps
//       its [64, 64] d(rpb) partial in registers over all its windows,
//       stored once at the end ([cph][2][nh][64][64]).
//   5 K5a tail: dy = dqkv Wqkv, LN1's backward, dx = dx1 + LN1^T(dy).
//   6 K5b (csrc/swin_block_bwd.cu): dW = dY^T X over the 64-token units.
//   7 K5c: the splits', the LayerNorm sums' and the d(rpb) partials summed
//       in a fixed order.
//       The weights' gradients come out in the forward stream's tile space;
//       kernels/fused_block.py fold_block_grads maps them to raw space.
#include "swin_block_bwd.cuh"

namespace swin_bwd {

// K5a's tiled instantiations, compiled in swin_block_bwd_i16_<cp>_<hdp>.cu
// (K5w16) and swin_block_bwd_i8w_256_32.cu (K5r)
#define K5_TILED_EXTERN(WS_, CP_, HDP_)                                                       \
  extern template int launch_window<WS_, CP_, HDP_, MODE_FRONT>(const Args&, int, cudaStream_t); \
  extern template int launch_window<WS_, CP_, HDP_, MODE_MID>(const Args&, int, cudaStream_t);   \
  extern template int launch_window<WS_, CP_, HDP_, MODE_TAIL>(const Args&, int, cudaStream_t);
K5_TILED_EXTERN(16, 96, 16)
K5_TILED_EXTERN(16, 96, 32)
K5_TILED_EXTERN(16, 192, 32)
K5_TILED_EXTERN(8, 256, 32)
#undef K5_TILED_EXTERN

}  // namespace swin_bwd

namespace {

using namespace swin_bwd;

constexpr int AT_CONS = 2;                                   // consumer warpgroups
constexpr int AT_THREADS = 128 * (AT_CONS + 1);              // + the loader's warpgroup
constexpr int AT_TABLE_BYTES = 4096;                         // one head's <= 961 fp32

// A window of the attention kernels: its tokens (NT), 64-token tiles
// (TPW), table entries a head (T2) and the table index of equal positions;
// the windows of a stage (WPS): one at ws 16, four at ws 8, two query
// tiles a consumer warpgroup either way.
template <int WS>
struct AtWindow {
  static constexpr int NT = WS * WS;
  static constexpr int TPW = NT / 64;
  static constexpr int WPS = TPW == 1 ? 4 : 1;
  static constexpr int T2 = (2 * WS - 1) * (2 * WS - 1);
  static constexpr int REL0 = (WS - 1) * (2 * WS - 1) + WS - 1;
  static_assert(NT % 64 == 0 && WPS * TPW == 2 * AT_CONS, "two query tiles a consumer");
  static_assert(T2 * 4 <= AT_TABLE_BYTES, "one head's table");
};

// The attention kernels' shared memory (kernels/fused_block.py
// _tiled_plan reckons the same): two stages, each the WPS windows' head
// tiles ([NT, hdp] bf16 each: q, k, v, and for the backward do), then
// their row statistics (the backward's: row max, 1 / sum, D); the head's
// bias table, four barriers.
template <int WS, int HDP, bool BWD>
struct AtLayout {
  using W = AtWindow<WS>;
  static constexpr int RB = 2 * HDP;
  static constexpr int HT = W::NT * RB;
  static constexpr int TILES = (BWD ? 4 : 3) * HT;    // a window's head tiles
  static constexpr int STAT = BWD ? 3 * W::NT * 4 : 0;  // a window's row statistics
  static constexpr int STAGE = W::WPS * (TILES + STAT);
  static constexpr int SMEM = 1024 + 2 * STAGE + AT_TABLE_BYTES + 4 * 8;
  static_assert(STAGE % 1024 == 0 && TILES % 1024 == 0, "the tiles' 1024-byte alignment");
};

struct AttnArgs {
  const bf16* qkvh;    // [windows][nh][3][NT][HDP]
  const bf16* doh;     // [windows][nh][NT][HDP] (backward)
  const float* drow;   // [windows][nh][NT] (backward)
  float* stat;         // [windows][nh][2][NT]: row max, 1 / sum
  bf16* o;             // the workspace's O: [units][o_tiles][64][64] (forward)
  bf16* dqkv;          // the workspace's dqkv: [units][dqkv_tiles][64][64] (backward)
  float* prpb;         // ws 16: [cph][nh][256][256]; ws 8: [cph][2][nh][64][64] (backward)
  const float* table;  // [nh, T2]
  const int* codes;    // [windows of an image, NT] where shifted, else [1, NT]
  int windows, per_img, nh, cph, o_tiles, dqkv_tiles, shifted;
};

// Query code cq against key code ck: the table index, bit 16 where the
// shift regions differ (the -100 of the shift mask).
template <int WS>
__device__ __forceinline__ int term16(int cq, int ck, bool shifted) {
  const int idx = (cq & 0xffff) - (ck & 0xffff) + AtWindow<WS>::REL0;
  return idx | ((shifted && (static_cast<unsigned>(cq ^ ck) >> 16) != 0) << 16);
}

// The score block's bias terms: element e of the accumulator holds (row
// h2 = (e >> 1) & 1, column col0 + 8 (e >> 2) + 2 q + (e & 1)); `rows_q`
// says whether the rows are the queries (else the keys).
template <int WS>
__device__ __forceinline__ void bias_terms(int (&bc)[32], float (&tv)[32], const float* tb,
                                           const int* codes, const int (&rc)[2], int col0, int q,
                                           bool rows_q, bool shifted) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int cc = __ldg(codes + col0 + 8 * (e >> 2) + 2 * q + (e & 1));
    const int r = rc[(e >> 1) & 1];
    bc[e] = rows_q ? term16<WS>(r, cc, shifted) : term16<WS>(cc, r, shifted);
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) tv[e] = tb[bc[e] & 0xffff];
}
// s + bias (+ the mask where the regions differ), as the plain version
// adds them: (q k^T + rpb) + mask.
__device__ __forceinline__ float biased(float s, float t, int bc) {
  const float v = s + t;
  return (bc & 0x10000) ? v + -100.f : v;
}

// (rows_product, block_product, to_frags, zero and store_head: csrc/
// swin_block_bwd.cuh, shared with the OCAB core's attention, csrc/ocab16.cu)

// The attention of K5w16 / K5r: the forward's recompute of O (BWD false)
// or the attention backward (BWD true), a stage of WPS windows of the
// CTA's head at a time; consumer warpgroup cw takes the stage's query
// tiles cw and cw + 2.
template <int WS, int HDP, bool BWD>
__global__ void __launch_bounds__(AT_THREADS, 1) attn16_kernel(const AttnArgs a) {
  using L = AtLayout<WS, HDP, BWD>;
  using W = AtWindow<WS>;
  constexpr int RB = L::RB, Q3 = 3 * HDP, NT = W::NT, TPW = W::TPW, WPS = W::WPS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t table_at = base + 2 * L::STAGE;
  const uint32_t bars = table_at + AT_TABLE_BYTES;  // full[2], empty[2]
  float* tb = reinterpret_cast<float*>(smem_raw + (table_at - raw));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hh = blockIdx.x / a.cph, first = blockIdx.x - hh * a.cph;
  const int groups = (a.windows + WPS - 1) / WPS;  // stages of WPS windows
  for (int i = tid; i < W::T2; i += AT_THREADS) tb[i] = a.table[hh * W::T2 + i];
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(bars + 8u * s, 1);
      hopper::mbar_init(bars + 8u * (2 + s), 4 * AT_CONS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * AT_CONS) {
    // ---------------------------------------------------------- the loader
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid != 128 * AT_CONS) return;
    int i = 0;
    for (int gr = first; gr < groups; gr += a.cph, ++i) {
      const int st = i & 1;
      hopper::mbar_wait(bars + 8u * (2 + st), ((i >> 1) & 1) ^ 1);
      const uint32_t full = bars + 8u * st, at = base + st * L::STAGE;
      const int nw = min(WPS, a.windows - gr * WPS);
      hopper::mbar_arrive_expect_tx(full, nw * (L::TILES + L::STAT));
      for (int w = 0; w < nw; ++w) {
        const size_t unit = static_cast<size_t>(gr * WPS + w) * a.nh + hh;
        const uint32_t wt = at + w * L::TILES;
        hopper::bulk_copy(wt, a.qkvh + unit * 3 * NT * HDP, 3 * L::HT, full);
        if constexpr (BWD) {
          const uint32_t ws = at + WPS * L::TILES + w * L::STAT;
          hopper::bulk_copy(wt + 3 * L::HT, a.doh + unit * NT * HDP, L::HT, full);
          hopper::bulk_copy(ws, a.stat + unit * 2 * NT, 2 * NT * 4, full);
          hopper::bulk_copy(ws + 2 * NT * 4, a.drow + unit * NT, NT * 4, full);
        }
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int cw = warp >> 2, wi = warp & 3, q = lane & 3;
  const int r0 = 16 * wi + (lane >> 2);  // the thread's rows of a 64-row tile: r0, r0 + 8
  const bool shifted = a.shifted != 0;
  const float neg_inf = -__int_as_float(0x7f800000);
  // ws 16: the CTA's [256, 256] d(rpb) partial in memory, each thread
  // owning its entries; ws 8: the consumer warpgroup's [64, 64] one in
  // registers (rp, in the accumulator's layout), stored at the end
  float* prpb = !BWD ? nullptr
                : TPW > 1 ? a.prpb + (static_cast<size_t>(first) * a.nh + hh) * NT * NT
                          : a.prpb + ((static_cast<size_t>(first) * AT_CONS + cw) * a.nh + hh) * 4096;
  float rp[TPW == 1 ? 32 : 1];
  zero<TPW == 1 ? 32 : 1>(rp);
  int i = 0;
  for (int gr = first; gr < groups; gr += a.cph, ++i) {
    const int st = i & 1;
    const uint32_t sbase = base + st * L::STAGE;
    hopper::mbar_wait(bars + 8u * st, (i >> 1) & 1);
    if constexpr (!BWD) {
      // ======== per query tile: the row max and sum, then O = P V
#pragma unroll 1
      for (int t2 = 0; t2 < 2; ++t2) {
        const int ti = cw + 2 * t2, w = WPS == 1 ? 0 : ti / TPW, qt = ti % TPW;
        const int wv = gr * WPS + w;
        if (WPS > 1 && wv >= a.windows) continue;  // a ragged last stage
        const uint32_t qbuf = sbase + w * L::TILES, kbuf = qbuf + L::HT, vbuf = kbuf + L::HT;
        const int* codes = a.codes + (shifted ? wv % a.per_img : 0) * NT;
        const size_t unit = static_cast<size_t>(wv) * a.nh + hh;
        const int row0 = 64 * qt + r0;
        uint32_t qf[HDP / 16][4];
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) tile_frag<RB>(qf[kk], qbuf, row0, q, kk);
        const int rc[2] = {__ldg(codes + row0), __ldg(codes + row0 + 8)};
        float mx[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f};
        float sc[32], tv[32];
        int bc[32];
#pragma unroll 1
        for (int kb = 0; kb < TPW; ++kb) {
          zero<32>(sc);
          hopper::wgmma_fence();
          rows_product<HDP>(sc, qf, kbuf + kb * 64 * RB);
          hopper::wgmma_commit();
          bias_terms<WS>(bc, tv, tb, codes, rc, 64 * kb, q, true, shifted);
          hopper::wgmma_wait<0>();
          hopper::fence_operands(sc);
          float bm[2] = {neg_inf, neg_inf};
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            sc[e] = biased(sc[e], tv[e], bc[e]);
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
        for (int kb = 0; kb < TPW; ++kb) {
          zero<32>(sc);
          hopper::wgmma_fence();
          rows_product<HDP>(sc, qf, kbuf + kb * 64 * RB);
          hopper::wgmma_commit();
          bias_terms<WS>(bc, tv, tb, codes, rc, 64 * kb, q, true, shifted);
          hopper::wgmma_wait<0>();
          hopper::fence_operands(sc);
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int h2 = (e >> 1) & 1;
            sc[e] = __expf(biased(sc[e], tv[e], bc[e]) - mx[h2]);
            sc[e] *= inv[h2];
          }
          uint32_t pf[4][4];
          to_frags(pf, sc);
          hopper::wgmma_fence();
          block_product<HDP>(o, pf, vbuf + kb * 64 * RB);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
        }
        hopper::fence_operands(o);
        store_head<HDP>(a.o + (static_cast<size_t>(wv) * TPW + qt) * a.o_tiles * TILE_ELEMS, o,
                        r0, hh * HDP, q);
        if (q == 0) {
          for (int h2 = 0; h2 < 2; ++h2) {
            a.stat[unit * 2 * NT + row0 + 8 * h2] = mx[h2];
            a.stat[unit * 2 * NT + NT + row0 + 8 * h2] = inv[h2];
          }
        }
      }
    } else {
      const bool init = i == 0;  // ws 16: this CTA's first unit writes its d(rpb) partial
      // ======== the query rows: S, P, dP = dO V^T, dS; d(rpb) += dS; dQ = dS K
#pragma unroll 1
      for (int t2 = 0; t2 < 2; ++t2) {
        const int ti = cw + 2 * t2, w = WPS == 1 ? 0 : ti / TPW, qt = ti % TPW;
        const int wv = gr * WPS + w;
        if (WPS > 1 && wv >= a.windows) continue;  // a ragged last stage
        const uint32_t qbuf = sbase + w * L::TILES, kbuf = qbuf + L::HT, vbuf = kbuf + L::HT;
        const uint32_t dob = vbuf + L::HT;
        // sm: [0, NT) the row max, [NT, 2 NT) 1 / sum, [2 NT, 3 NT) D
        const float* sm =
            reinterpret_cast<const float*>(smem_raw + (sbase + WPS * L::TILES + w * L::STAT - raw));
        const int* codes = a.codes + (shifted ? wv % a.per_img : 0) * NT;
        const int row0 = 64 * qt + r0;
        uint32_t qf[HDP / 16][4], dof[HDP / 16][4];
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          tile_frag<RB>(qf[kk], qbuf, row0, q, kk);
          tile_frag<RB>(dof[kk], dob, row0, q, kk);
        }
        const int rc[2] = {__ldg(codes + row0), __ldg(codes + row0 + 8)};
        float mr[2], ir[2], dr[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          mr[h2] = sm[row0 + 8 * h2];
          ir[h2] = sm[NT + row0 + 8 * h2];
          dr[h2] = sm[2 * NT + row0 + 8 * h2];
        }
        float dq[HDP / 2];
        zero<HDP / 2>(dq);
#pragma unroll 1
        for (int kb = 0; kb < TPW; ++kb) {
          // ws 16: the thread's entries of the d(rpb) partial, loaded while
          // the block's products run
          float* pr = TPW > 1 ? prpb + static_cast<size_t>(row0) * NT + 64 * kb + 2 * q : nullptr;
          float2 t[8][2];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2)
              t[j][h2] = TPW == 1 || init
                             ? make_float2(0.f, 0.f)
                             : *reinterpret_cast<const float2*>(pr + 8 * h2 * NT + 8 * j);
          float sc[32], dp[32], tv[32];
          int bc[32];
          zero<32>(sc);
          zero<32>(dp);
          hopper::wgmma_fence();
          rows_product<HDP>(sc, qf, kbuf + kb * 64 * RB);
          rows_product<HDP>(dp, dof, vbuf + kb * 64 * RB);
          hopper::wgmma_commit();
          bias_terms<WS>(bc, tv, tb, codes, rc, 64 * kb, q, true, shifted);
          hopper::wgmma_wait<0>();
          hopper::fence_operands(sc);
          hopper::fence_operands(dp);
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int h2 = (e >> 1) & 1;
            const float p = __expf(biased(sc[e], tv[e], bc[e]) - mr[h2]) * ir[h2];
            dp[e] = p * (dp[e] - dr[h2]);  // dS
          }
          uint32_t dsf[4][4];
          to_frags(dsf, dp);
          hopper::wgmma_fence();
          block_product<HDP>(dq, dsf, kbuf + kb * 64 * RB);
          hopper::wgmma_commit();
          // d(rpb) += dS while dQ runs
          if constexpr (TPW == 1) {
#pragma unroll
            for (int e = 0; e < 32; ++e) rp[e] += dp[e];
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2)
                *reinterpret_cast<float2*>(pr + 8 * h2 * NT + 8 * j) = make_float2(
                    t[j][h2].x + dp[4 * j + 2 * h2], t[j][h2].y + dp[4 * j + 2 * h2 + 1]);
          }
          hopper::wgmma_wait<0>();
        }
        hopper::fence_operands(dq);
        store_head<HDP>(a.dqkv + (static_cast<size_t>(wv) * TPW + qt) * a.dqkv_tiles * TILE_ELEMS,
                        dq, r0, hh * Q3, q);
      }
      // ======== the key rows: S^T = K Q^T, P^T, dP^T = V dO^T, dS^T;
      //          dK = dS^T Q, dV = P^T dO
#pragma unroll 1
      for (int t2 = 0; t2 < 2; ++t2) {
        const int ti = cw + 2 * t2, w = WPS == 1 ? 0 : ti / TPW, kt = ti % TPW;
        const int wv = gr * WPS + w;
        if (WPS > 1 && wv >= a.windows) continue;
        const uint32_t qbuf = sbase + w * L::TILES, kbuf = qbuf + L::HT, vbuf = kbuf + L::HT;
        const uint32_t dob = vbuf + L::HT;
        const float* sm =
            reinterpret_cast<const float*>(smem_raw + (sbase + WPS * L::TILES + w * L::STAT - raw));
        const int* codes = a.codes + (shifted ? wv % a.per_img : 0) * NT;
        const int row0 = 64 * kt + r0;
        uint32_t kf[HDP / 16][4], vf[HDP / 16][4];
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          tile_frag<RB>(kf[kk], kbuf, row0, q, kk);
          tile_frag<RB>(vf[kk], vbuf, row0, q, kk);
        }
        const int rc[2] = {__ldg(codes + row0), __ldg(codes + row0 + 8)};
        float dk[HDP / 2], dv[HDP / 2];
        zero<HDP / 2>(dk);
        zero<HDP / 2>(dv);
#pragma unroll 1
        for (int qb = 0; qb < TPW; ++qb) {
          float sc[32], dp[32], tv[32];
          int bc[32];
          zero<32>(sc);
          zero<32>(dp);
          hopper::wgmma_fence();
          rows_product<HDP>(sc, kf, qbuf + qb * 64 * RB);
          rows_product<HDP>(dp, vf, dob + qb * 64 * RB);
          hopper::wgmma_commit();
          bias_terms<WS>(bc, tv, tb, codes, rc, 64 * qb, q, false, shifted);
          hopper::wgmma_wait<0>();
          hopper::fence_operands(sc);
          hopper::fence_operands(dp);
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int col = 64 * qb + 8 * (e >> 2) + 2 * q + (e & 1);  // the query
            const float p = __expf(biased(sc[e], tv[e], bc[e]) - sm[col]) * sm[NT + col];
            sc[e] = p;
            dp[e] = p * (dp[e] - sm[2 * NT + col]);
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
        bf16* ws = a.dqkv + (static_cast<size_t>(wv) * TPW + kt) * a.dqkv_tiles * TILE_ELEMS;
        store_head<HDP>(ws, dk, r0, hh * Q3 + HDP, q);
        store_head<HDP>(ws, dv, r0, hh * Q3 + 2 * HDP, q);
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bars + 8u * (2 + st));  // the stage is free
  }
  if constexpr (BWD && TPW == 1) {  // ws 8: the consumer warpgroup's d(rpb) partial, once
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        *reinterpret_cast<float2*>(prpb + (r0 + 8 * h2) * 64 + 8 * j + 2 * q) =
            make_float2(rp[4 * j + 2 * h2], rp[4 * j + 2 * h2 + 1]);
  }
}

template <int WS, int HDP, bool BWD>
int launch_attn(const AttnArgs& a, cudaStream_t s) {
  using L = AtLayout<WS, HDP, BWD>;
  auto kernel = attn16_kernel<WS, HDP, BWD>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<a.nh * a.cph, AT_THREADS, L::SMEM, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_k5a(const Args& a, int ws, int cp, int hdp, int grid, cudaStream_t s) {
  if (ws == 16 && cp == 96 && hdp == 16) return launch_window<16, 96, 16, MODE>(a, grid, s);
  if (ws == 16 && cp == 96 && hdp == 32) return launch_window<16, 96, 32, MODE>(a, grid, s);
  if (ws == 16 && cp == 192 && hdp == 32) return launch_window<16, 192, 32, MODE>(a, grid, s);
  if (ws == 8 && cp == 256 && hdp == 32) return launch_window<8, 256, 32, MODE>(a, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

using namespace swin_bwd;

// K5w16's / K5r's seven launches on one stream.  ct, x, extra (or null),
// dx, dextra [batch, h, w, c] bf16; tiles, biases, LN params, table [nh,
// (2ws-1)^2] and codes as kernels/fused_block.py ``pack_block_tiles`` and
// ops/window.py ``window_codes_tensor`` lay them out; scales [batch, 2]
// or null.  Workspaces (kernels/fused_block.py ``_tiled_plan`` /
// ``tiled_bwd_bytes`` size them): ws the dW operands of the 64-token
// units, qkvh and doh the head tiles, x1ws the per-unit x1 / dx1 scratch
// (units + units % 2 slices: an odd last unit's twin writes its own),
// pvec the middle's then the tail's LayerNorm partials, stat the row
// statistics, drow the row term, prpb the d(rpb) partials, pw the splits'
// partials; outputs wgrad (the weight stream's layout, fp32) with vec
// right after it (the bias sums in pack_block_tiles' bias layout, then
// the LN sums) and rpb [nh, ws^2, ws^2].  geo: batch, h, w, c, nh,
// hidden, ws, shift, shifted, cp, hdp, stages, gelu_tanh, grid (K5a's
// CTAs), splits (K5b's), cph (the attention's CTAs a head) — the plan;
// this entry checks it.  ws 16 takes the block kernel's C and heads (cp /
// hdp 96 / 16, 96 / 32, 192 / 32; <= 6 heads), ws 8 cp 256, hdp 32 (<= 8
// heads); both any hidden (the chunk loops and every buffer sized by it
// are counted from a.chunks).
extern "C" int sr_swin_block_bwd_tiled_bf16(
    const void* ct, const void* x, const void* extra, void* dx, void* dextra, const void* tiles,
    const void* bqkv, const void* bproj, const void* bfc1, const void* bfc2, const void* g1,
    const void* b1, const void* g2, const void* b2, const void* table, const void* codes,
    const void* scales, void* ws, void* qkvh, void* doh, void* x1ws, void* pvec, void* stat,
    void* drow, void* prpb, void* pw, void* vec, void* rpb, void* wgrad, const int* geo,
    float eps, void* stream) {
  Args a{};
  a.batch = geo[0];
  a.h = geo[1];
  a.w = geo[2];
  a.c = geo[3];
  a.nh = geo[4];
  const int hidden = geo[5], wsz = geo[6];
  a.shift = geo[7];
  a.shifted = geo[8];
  const int cp = geo[9], hdp = geo[10];
  a.stages = geo[11];
  a.gelu_tanh = geo[12];
  const int grid = geo[13], splits = geo[14], cph = geo[15];
  a.chunks = (hidden + HC - 1) / HC;
  a.eps = eps;
  const bool w16 = wsz == 16;
  const bool widths = w16 ? (cp == 96 && (hdp == 16 || hdp == 32)) || (cp == 192 && hdp == 32)
                          : wsz == 8 && cp == 256 && hdp == 32;
  const int max_heads = w16 ? MAX_HEADS : K5R_MAX_HEADS;
  const long long windows =
      widths ? static_cast<long long>(a.batch) * (a.h / wsz) * (a.w / wsz) : 0;
  const int nt = wsz * wsz, wps = w16 ? 1 : 4;
  const long long units = nt / 64 * windows, pairs = (units + NCONS - 1) / NCONS;
  const long long groups = (windows + wps - 1) / wps;
  if (!widths || a.c < 1 || a.c > cp || a.nh < 1 || a.nh > max_heads || a.c % a.nh ||
      a.c / a.nh > hdp || a.nh * hdp > cp || hidden < 1 ||
      a.h % wsz || a.w % wsz || a.shift < 0 || a.shift >= wsz || grid < 1 ||
      (pairs > 0 && grid > pairs) || splits < 1 || (units > 0 && splits > units) || cph < 1 ||
      (groups > 0 && cph > groups) || !aligned_to(tiles, 16) || !aligned_to(bqkv, 8) ||
      !aligned_to(bproj, 8) || !aligned_to(bfc1, 8) || !aligned_to(bfc2, 8) ||
      !aligned_to(ws, 16) || !aligned_to(qkvh, 16) || !aligned_to(doh, 16) ||
      !aligned_to(x1ws, 16) || !aligned_to(pvec, 8) || !aligned_to(stat, 16) ||
      !aligned_to(drow, 16) || !aligned_to(prpb, 8) ||
      (a.c % 2 == 0 && !(aligned_to(x, 4) && aligned_to(ct, 4) && aligned_to(dx, 4) &&
                         (!extra || (aligned_to(extra, 4) && aligned_to(dextra, 4))))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (windows == 0) return 0;
  a.ct = static_cast<const bf16*>(ct);
  a.x = static_cast<const bf16*>(x);
  a.extra = static_cast<const bf16*>(extra);
  a.dx = static_cast<bf16*>(dx);
  a.dextra = static_cast<bf16*>(dextra);
  a.tiles = static_cast<const bf16*>(tiles);
  a.bqkv = static_cast<const float*>(bqkv);
  a.bproj = static_cast<const float*>(bproj);
  a.bfc1 = static_cast<const float*>(bfc1);
  a.bfc2 = static_cast<const float*>(bfc2);
  a.g1 = static_cast<const float*>(g1);
  a.b1 = static_cast<const float*>(b1);
  a.g2 = static_cast<const float*>(g2);
  a.b2 = static_cast<const float*>(b2);
  a.table = static_cast<const float*>(table);
  a.codes = static_cast<const int*>(codes);
  a.scales = static_cast<const float*>(scales);
  const int kc = (cp + 63) / 64, q3 = 3 * hdp;
  const int qt = (a.nh * q3 + 63) / 64;
  const int tiles_of[N_OPS] = {kc, kc, kc, a.chunks, qt, kc, a.chunks, kc};
  bf16* p = static_cast<bf16*>(ws);
  for (int o = 0; o < N_OPS; ++o) {
    a.op[o] = p;
    a.op_tiles[o] = tiles_of[o];
    p += units * tiles_of[o] * TILE_ELEMS;
  }
  a.qkvh = static_cast<bf16*>(qkvh);
  a.doh = static_cast<bf16*>(doh);
  a.drow = static_cast<float*>(drow);
  a.x1ws = static_cast<float*>(x1ws);
  a.vl = 4 * cp;
  const long long ln_rows = static_cast<long long>(grid) * NCONS * 4;
  float* pv_mid = static_cast<float*>(pvec);
  float* pv_tail = pv_mid + ln_rows * a.vl;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  AttnArgs t;
  t.qkvh = a.qkvh;
  t.doh = a.doh;
  t.drow = a.drow;
  t.stat = static_cast<float*>(stat);
  t.o = a.op[OP_O];
  t.dqkv = a.op[OP_DQKV];
  t.prpb = static_cast<float*>(prpb);
  t.table = a.table;
  t.codes = a.codes;
  t.windows = static_cast<int>(windows);
  t.per_img = (a.h / wsz) * (a.w / wsz);
  t.nh = a.nh;
  t.cph = cph;
  t.o_tiles = a.op_tiles[OP_O];
  t.dqkv_tiles = a.op_tiles[OP_DQKV];
  t.shifted = a.shifted;
  const auto attn = [&](bool bwd) {
    if (!w16) return bwd ? launch_attn<8, 32, true>(t, s) : launch_attn<8, 32, false>(t, s);
    if (hdp == 16) return bwd ? launch_attn<16, 16, true>(t, s) : launch_attn<16, 16, false>(t, s);
    return bwd ? launch_attn<16, 32, true>(t, s) : launch_attn<16, 32, false>(t, s);
  };

  a.pvec = pv_mid;  // (the front writes no LayerNorm sums)
  int status = launch_k5a<MODE_FRONT>(a, wsz, cp, hdp, grid, s);
  if (status == 0) status = attn(false);
  if (status == 0) status = launch_k5a<MODE_MID>(a, wsz, cp, hdp, grid, s);
  if (status == 0) status = attn(true);
  a.pvec = pv_tail;
  if (status == 0) status = launch_k5a<MODE_TAIL>(a, wsz, cp, hdp, grid, s);
  if (status != 0) return status;
  const long long bias_len = a.nh * q3 + 2LL * cp + a.chunks * HC;
  // the d(rpb) partials: ws 16 a CTA's [nh][256][256], ws 8 a consumer
  // warpgroup's [nh][64][64]
  const long long rpb_rows = w16 ? cph : static_cast<long long>(cph) * 2;
  return launch_wgrad_reduce(
      a, units, cp, hdp, splits, static_cast<float*>(pw), static_cast<float*>(wgrad),
      static_cast<float*>(vec),
      {pv_mid, 2 * ln_rows, a.vl, static_cast<float*>(vec) + bias_len},
      {static_cast<const float*>(prpb), rpb_rows, static_cast<long long>(a.nh) * nt * nt,
       static_cast<float*>(rpb)},
      s);
}
