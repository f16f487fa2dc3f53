// K8 and K8b — HAT's fused OCAB core at windows 7 and 8 ((ws, ows) = (7,
// 10): 49 queries of a window against the 100 keys of its overlap window;
// (8, 12): 64 against 144), forward and backward, on Hopper's wgmma.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_ocab.py
//           fused_ocab_core: _fwd_kernel (pallas_call at :311) and
//           _bwd_kernel (pallas_call at :354).
// Math: that of kernels/fused_ocab.py ocab_core_plain and
//       ocab_core_bwd_plain (the latter for the cotangent ct) of
//         A_h  = softmax(q_h k_h^T + bias[h])     (q pre-scaled, fp32)
//         x1   = sw + proj(concat_h bf16(bf16(A_h) v_h))   (fp32)
//         out  = x1 + fc2(bf16(gelu(fc1(bf16(LN2(x1))))))
//       with bf16 GEMM operands, fp32 accumulation and the plain
//       version's casts; as K8bw16 (csrc/ocab16.cu), the softmax
//       backward's row term rowsum(dA * A) is taken as rowsum(dO * O)
//       and the bias sum of the proj is over bf16(dx1).  The zero-padded
//       border keys of the overlap gather are real keys (score = the bias
//       alone) and are not masked; only the keys this kernel adds to fill
//       its 64-key blocks are.
// Bound on the H100: at HAT's train step (800 windows, C 96, 6 heads of
//       16, hidden 384) the forward ~8 GFLOP against ~54 MB, the backward
//       ~21 GFLOP against ~100 MB: memory, ~0.016 and ~0.03 ms.
// Design: K8w16 / K8bw16's split at windows 7 and 8, on K5's and K8bw16's
//       machinery, on one weight pack (``pack_ocab_tiles``' stream, made
//       once a training call).  Everything but the attention is
//       token-local and runs as K5a (csrc/swin_block_bwd.cuh) over units
//       of one window (64 rows; at ws 7 the 49 tokens and 15 pad rows,
//       whose operands are zero), the window layout [windows, ws^2, C]
//       read as a [windows, ws, ws, C] map.  The attention runs as a
//       kernel of its own over (window, head) units, a fixed head a CTA:
//       q, k, v head-major [windows, nh, N, hdp] bf16, each row swizzled
//       as the tiles sit in shared memory (kernels/fused_ocab.py
//       ``to_heads``), so a unit's operands are bulk copies of its real
//       rows into tiles of 64 query rows and 128 / 192 key rows whose pad
//       rows are zeroed once and never written.  The forward keeps the
//       head-major q, k, v, O and the row statistics for the backward
//       (kernels/fused_ocab.py ``OcabCoreFunction``), so the backward
//       neither gathers nor recomputes the attention.  Deterministic:
//       static schedules, ordered sums, no atomics.
//   The forward (K8), three launches:
//     0 ocab_win_heads_kernel: q, k, v from the window layout to the
//       head-major operands (``to_heads``' layout), a 16-byte store a
//       thread in output order, 16-byte loads where hd and C allow.
//     1 ocab_win_attn_kernel<ws, ows, hdp, false>: per unit the row max
//       and sum over the key blocks (the gathered bias read from L2, -inf
//       on the pad keys), then P = exp(s - max) / sum rounded once and O
//       = P V -> K5a's workspace tile (the pad rows zero); the row max and
//       1 / sum -> [windows, nh, 2, 64] (the pad rows 0 and 0, so every P
//       on them is 0).
//     2 K5a MODE_OFWD on that O: x1 = sw + O Wproj^T + b (fp32, a slot's
//       scratch), LN2, per 64-column hidden chunk fc1, GELU and fc2
//       summed in fp32, then fc2's bias and the residual: the output,
//       rounded once (the pad rows not stored).
//   The backward (K8b), four launches on the forward's q, k, v, O and
//       row statistics:
//     0 K5a MODE_MID: x1, LN2, the MLP forward and back, LN2's backward:
//       dsw = dx1, the dW operands, dO -> head tiles [windows, nh, 64,
//       hdp] and D = rowsum(dO O) [windows, nh, 64].
//     1 ocab_win_attn_kernel<ws, ows, hdp, true>: per unit a query-row
//       pass (S, P from the row statistics, dP = dO V^T, dS = P (dP - D),
//       dQ = dS K; the bias gradient += dS) and a key-row pass (S^T, P^T,
//       dP^T, dK = dS^T Q, dV = P^T dO), so no sum crosses CTAs; dQ, dK
//       and dV go straight to the window layout.  A CTA walks its head's
//       windows two a stage, one a consumer warpgroup (its two stages
//       through an mbarrier ring fed by a loader warp), and each consumer
//       keeps its own [64, nk] fp32 bias-gradient partial in shared
//       memory (each thread its entries), summed over its windows; at
//       the end the two are added (consumer 0's, then 1's) and written
//       once: [cph][nh][nq][nk], 4.9 MB at 132 CTAs of (8, 12), where
//       K8bw16's read-modify-writes of [256, 576] partials move 906 MB.
//     2 K5b (csrc/swin_block_bwd.cu): dW = dY^T X over the units for the
//       proj, fc1 and fc2, and the bias sums.
//     3 K5c: the splits', the LayerNorm sums' and the CTAs' bias-gradient
//       partials summed in a fixed order.
#include "swin_block_bwd.cuh"

namespace swin_bwd {

// K5a's forward tail and middle at ws 7 and 8, compiled in
// swin_block_bwd_i7of_ / _i8of_<cp>_<hdp>.cu and swin_block_bwd_i7o_ /
// _i8o_<cp>_<hdp>.cu
#define OCAB_K5A_EXTERN(WS_, CP_, HDP_)                                                         \
  extern template int launch_window<WS_, CP_, HDP_, MODE_OFWD>(const Args&, int, cudaStream_t); \
  extern template int launch_window<WS_, CP_, HDP_, MODE_MID>(const Args&, int, cudaStream_t);
OCAB_K5A_EXTERN(7, 96, 16)
OCAB_K5A_EXTERN(7, 96, 32)
OCAB_K5A_EXTERN(7, 192, 32)
OCAB_K5A_EXTERN(8, 96, 16)
OCAB_K5A_EXTERN(8, 96, 32)
OCAB_K5A_EXTERN(8, 192, 32)
#undef OCAB_K5A_EXTERN

}  // namespace swin_bwd

namespace {

using namespace swin_bwd;

constexpr int OW_CONS = 2;                       // consumer warpgroups: a window each
constexpr int OW_THREADS = 128 * (OW_CONS + 1);  // + the loader's warpgroup
constexpr int UNIT_ROWS = 64;                    // a unit's query rows (K5a's tile)

// The row stride (fp32) of a consumer's bias-gradient partial: even, and
// 8 or 24 words mod 32, so a quarter warp's float2 accesses (four rows, 8
// words each) take distinct banks.
__host__ __device__ constexpr int part_ld(int nk) {
  return (nk + 7) / 8 * 8 % 32 == 8 || (nk + 7) / 8 * 8 % 32 == 24 ? (nk + 7) / 8 * 8
                                                                   : (nk + 7) / 8 * 8 + 8;
}

// Shared memory: two stages of two windows' tiles (q [64, hdp], k and v
// [NKP, hdp], for the backward dO [64, hdp] and the row statistics: max,
// 1 / sum, D), the backward's two bias-gradient partials, four barriers.
// kernels/fused_ocab.py ocab_bwd_plan reckons the same.
template <int WS, int OWS, int HDP, bool BWD>
struct OwLayout {
  static constexpr int NQ = WS * WS, NK = OWS * OWS;
  static constexpr int NKP = (NK + 63) / 64 * 64;
  static constexpr int RB = 2 * HDP;
  static constexpr int QB = UNIT_ROWS * RB;  // a q (or dO) tile, bytes
  static constexpr int KB = NKP * RB;        // a k (or v) tile
  static constexpr int STAT = BWD ? 1024 : 0;  // 3 x 64 fp32, padded
  static constexpr int WIN = QB + 2 * KB + (BWD ? QB + STAT : 0);
  static constexpr int STAGE = OW_CONS * WIN;
  static constexpr int LDP = part_ld(NK);
  static constexpr int PART = BWD ? OW_CONS * UNIT_ROWS * LDP * 4 : 0;
  static constexpr int SMEM = 1024 + 2 * STAGE + PART + 4 * 8;
  // bytes a window's bulk copies bring
  static constexpr int TX = NQ * RB + 2 * NK * RB + (BWD ? QB + 3 * UNIT_ROWS * 4 : 0);
  static_assert(NQ <= UNIT_ROWS && NK % 2 == 0, "a window one 64-row tile; key pairs");
  static_assert(QB % 1024 == 0 && KB % 1024 == 0 && WIN % 1024 == 0, "1024-byte aligned tiles");
  static_assert((NQ * RB) % 16 == 0 && (NK * RB) % 16 == 0, "bulk copies of 16-byte multiples");
  static_assert(SMEM <= SMEM_LIMIT, "within the shared memory");
};

struct OwArgs {
  const bf16* q;      // [windows][nh][NQ][HDP], rows swizzled as in shared memory; q pre-scaled
  const bf16* k;      // [windows][nh][NK][HDP]
  const bf16* v;
  const bf16* doh;    // [windows][nh][64][HDP] (backward; K5a's middle)
  const float* drow;  // [windows][nh][64]: rowsum(dO O) (backward)
  float* stat;        // [windows][nh][2][64]: row max, 1 / sum (the forward writes them)
  const float* bias;  // [nh][NQ][NK] fp32, the gathered bias
  bf16* o;            // forward: O as K5a's workspace, [windows][o_tiles][64][64]
  bf16* dq;           // backward: in window layout, [windows][NQ][c] and [windows][NK][c]
  bf16* dk;
  bf16* dv;
  float* prpb;        // backward: [cph][nh][NQ][NK], a CTA's bias-gradient partial
  int windows, nh, cph, o_tiles, c;
};

// The gathered bias of the thread's score entries: query rows row0 and
// row0 + 8 (0 past NQ), key columns col0 + 8 (e >> 2) + 2 q + (e & 1)
// (-inf past NK: the keys the 64-key blocks add), in the accumulator's
// layout.
template <int NQ, int NK>
__device__ __forceinline__ void win_bias_rows(float (&tv)[32], const float* bh, int row0, int col0,
                                             int q) {
  const float neg_inf = -__int_as_float(0x7f800000);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = row0 + 8 * h2, col = col0 + 8 * j + 2 * q;
      float2 t = make_float2(neg_inf, neg_inf);
      if (col < NK)
        t = row < NQ ? __ldg(reinterpret_cast<const float2*>(bh + row * NK + col))
                     : make_float2(0.f, 0.f);
      tv[4 * j + 2 * h2] = t.x;
      tv[4 * j + 2 * h2 + 1] = t.y;
    }
}

// The same transposed (the key-row pass): rows the keys key0, key0 + 8,
// columns the queries 8 (e >> 2) + 2 q + (e & 1).
template <int NQ, int NK>
__device__ __forceinline__ void win_bias_cols(float (&tv)[32], const float* bh, int key0, int q) {
  const float neg_inf = -__int_as_float(0x7f800000);
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int qc = 8 * (e >> 2) + 2 * q + (e & 1), key = key0 + 8 * ((e >> 1) & 1);
    tv[e] = key >= NK ? neg_inf : qc < NQ ? __ldg(bh + qc * NK + key) : 0.f;
  }
}

// A head's [64, HDP] result (rows r0, r0 + 8 of the thread) -> its real
// rows (< n) and dims (< hd) in a window's [n][c] rows of the window
// layout, at columns col0 + d: bf16 pairs where hd is even (so c is, and
// every pair 4-byte aligned), else elements.
template <int HDP>
__device__ __forceinline__ void store_window_rows(bf16* t, const float (&v)[HDP / 2], int r0,
                                                  int q, int n, int c, int hd, int col0) {
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int d = 8 * j + 2 * q;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = r0 + 8 * h2;
      if (r >= n || d >= hd) continue;
      bf16* at = t + static_cast<size_t>(r) * c + col0 + d;
      const float lo = v[4 * j + 2 * h2], hi = v[4 * j + 2 * h2 + 1];
      if ((hd & 1) == 0) {
        *reinterpret_cast<uint32_t*>(at) = pack_bf16(lo, hi);
      } else {
        at[0] = __float2bfloat16(lo);
        if (d + 1 < hd) at[1] = __float2bfloat16(hi);
      }
    }
  }
}

// The OCAB's attention at ws 7 / 8: the forward's O and row statistics
// (BWD false) or the attention backward (BWD true).  CTA (head hh, index
// first) walks windows first, first + cph, ...: window 2 i + cw of that
// walk is consumer cw's in stage i.
template <int WS, int OWS, int HDP, bool BWD>
__global__ void __launch_bounds__(OW_THREADS, 1) ocab_win_attn_kernel(const OwArgs a) {
  using L = OwLayout<WS, OWS, HDP, BWD>;
  constexpr int NQ = L::NQ, NK = L::NK, RB = L::RB, KTN = L::NKP / 64, LDP = L::LDP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t part_at = base + 2 * L::STAGE;
  const uint32_t bars = part_at + L::PART;  // full[2], empty[2]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hh = blockIdx.x / a.cph, first = blockIdx.x - hh * a.cph;
  const int mine = first < a.windows ? (a.windows - first + a.cph - 1) / a.cph : 0;
  const int stages = (mine + OW_CONS - 1) / OW_CONS;
  // the tiles' pad rows (and the partials) start at zero; bulk copies write
  // only the real rows
  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw + (base - raw));
    for (int i = tid; i < (2 * L::STAGE + L::PART) / 16; i += OW_THREADS)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(bars + 8u * s, 1);
      hopper::mbar_init(bars + 8u * (2 + s), 4 * OW_CONS);
    }
    hopper::mbar_init_fence();
  }
  hopper::fence_proxy_async();
  __syncthreads();

  if (warp >= 4 * OW_CONS) {
    // ---------------------------------------------------------- the loader
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid != 128 * OW_CONS) return;
    for (int i = 0; i < stages; ++i) {
      const int st = i & 1, n = mine - OW_CONS * i < OW_CONS ? mine - OW_CONS * i : OW_CONS;
      hopper::mbar_wait(bars + 8u * (2 + st), ((i >> 1) & 1) ^ 1);
      const uint32_t full = bars + 8u * st;
      hopper::mbar_arrive_expect_tx(full, n * L::TX);
      for (int s = 0; s < n; ++s) {
        const int w = first + (OW_CONS * i + s) * a.cph;
        const size_t unit = static_cast<size_t>(w) * a.nh + hh;
        const uint32_t at = base + st * L::STAGE + s * L::WIN;
        hopper::bulk_copy(at, a.q + unit * NQ * HDP, NQ * RB, full);
        hopper::bulk_copy(at + L::QB, a.k + unit * NK * HDP, NK * RB, full);
        hopper::bulk_copy(at + L::QB + L::KB, a.v + unit * NK * HDP, NK * RB, full);
        if constexpr (BWD) {
          const uint32_t sa = at + 2 * L::QB + 2 * L::KB;
          hopper::bulk_copy(at + L::QB + 2 * L::KB, a.doh + unit * UNIT_ROWS * HDP, L::QB, full);
          hopper::bulk_copy(sa, a.stat + unit * 2 * UNIT_ROWS, 2 * UNIT_ROWS * 4, full);
          hopper::bulk_copy(sa + 2 * UNIT_ROWS * 4, a.drow + unit * UNIT_ROWS, UNIT_ROWS * 4,
                            full);
        }
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int cw = warp >> 2, wi = warp & 3, q = lane & 3;
  const int r0 = 16 * wi + (lane >> 2);  // the thread's rows of a 64-row tile: r0, r0 + 8
  const float* bh = a.bias + static_cast<size_t>(hh) * NQ * NK;
  float* part = reinterpret_cast<float*>(smem_raw + (part_at - raw)) + cw * UNIT_ROWS * LDP;
  for (int i = 0; i < stages; ++i) {
    const int st = i & 1, j = OW_CONS * i + cw;
    hopper::mbar_wait(bars + 8u * st, (i >> 1) & 1);
    if (j < mine) {
      const int w = first + j * a.cph;
      const size_t unit = static_cast<size_t>(w) * a.nh + hh;
      const uint32_t qbuf = base + st * L::STAGE + cw * L::WIN, kbuf = qbuf + L::QB,
                     vbuf = kbuf + L::KB;
      uint32_t qf[HDP / 16][4];
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) tile_frag<RB>(qf[kk], qbuf, r0, q, kk);
      if constexpr (!BWD) {
        // ======== the row max and sum over the key blocks, then O = P V
        const float neg_inf = -__int_as_float(0x7f800000);
        float mx[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f};
        float sc[32], tv[32];
#pragma unroll 1
        for (int kb = 0; kb < KTN; ++kb) {
          zero<32>(sc);
          hopper::wgmma_fence();
          rows_product<HDP>(sc, qf, kbuf + kb * 64 * RB);
          hopper::wgmma_commit();
          win_bias_rows<NQ, NK>(tv, bh, r0, 64 * kb, q);
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
          win_bias_rows<NQ, NK>(tv, bh, r0, 64 * kb, q);
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
        // the pad rows: O zero, statistics (0, 0)
#pragma unroll
        for (int e = 0; e < HDP / 2; ++e)
          if (r0 + 8 * ((e >> 1) & 1) >= NQ) o[e] = 0.f;
        store_head<HDP>(a.o + static_cast<size_t>(w) * a.o_tiles * TILE_ELEMS, o, r0, hh * HDP, q);
        if (q == 0) {
          for (int h2 = 0; h2 < 2; ++h2) {
            const bool real = r0 + 8 * h2 < NQ;
            a.stat[unit * 2 * UNIT_ROWS + r0 + 8 * h2] = real ? mx[h2] : 0.f;
            a.stat[unit * 2 * UNIT_ROWS + UNIT_ROWS + r0 + 8 * h2] = real ? inv[h2] : 0.f;
          }
        }
      } else {
        const uint32_t dob = vbuf + L::KB;
        // sm: [0, 64) the row max, [64, 128) 1 / sum, [128, 192) D
        const float* sm = reinterpret_cast<const float*>(smem_raw + (dob + L::QB - raw));
        // ======== the query rows: S, P, dP = dO V^T, dS; the partial += dS; dQ = dS K
        {
          uint32_t dof[HDP / 16][4];
#pragma unroll
          for (int kk = 0; kk < HDP / 16; ++kk) tile_frag<RB>(dof[kk], dob, r0, q, kk);
          float mr[2], ir[2], dr[2];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            mr[h2] = sm[r0 + 8 * h2];
            ir[h2] = sm[UNIT_ROWS + r0 + 8 * h2];
            dr[h2] = sm[2 * UNIT_ROWS + r0 + 8 * h2];
          }
          float dq[HDP / 2];
          zero<HDP / 2>(dq);
#pragma unroll 1
          for (int kb = 0; kb < KTN; ++kb) {
            float sc[32], dp[32], tv[32];
            zero<32>(sc);
            zero<32>(dp);
            hopper::wgmma_fence();
            rows_product<HDP>(sc, qf, kbuf + kb * 64 * RB);
            rows_product<HDP>(dp, dof, vbuf + kb * 64 * RB);
            hopper::wgmma_commit();
            win_bias_rows<NQ, NK>(tv, bh, r0, 64 * kb, q);
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
            // the partial += dS over the real keys while dQ runs (the pad
            // rows' dS is 0)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int col = 64 * kb + 8 * jj + 2 * q;
              if (col < NK)
#pragma unroll
                for (int h2 = 0; h2 < 2; ++h2) {
                  float2* pp = reinterpret_cast<float2*>(part + (r0 + 8 * h2) * LDP + col);
                  const float2 t = *pp;
                  *pp = make_float2(t.x + dp[4 * jj + 2 * h2], t.y + dp[4 * jj + 2 * h2 + 1]);
                }
            }
            hopper::wgmma_wait<0>();
          }
          hopper::fence_operands(dq);
          store_window_rows<HDP>(a.dq + static_cast<size_t>(w) * NQ * a.c, dq, r0, q, NQ, a.c,
                                 a.c / a.nh, hh * (a.c / a.nh));
        }
        // ======== the key rows: S^T = K Q^T, P^T, dP^T = V dO^T, dS^T;
        //          dK = dS^T Q, dV = P^T dO
#pragma unroll 1
        for (int kt = 0; kt < KTN; ++kt) {
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
          float sc[32], dp[32], tv[32];
          zero<32>(sc);
          zero<32>(dp);
          hopper::wgmma_fence();
          rows_product<HDP>(sc, kf, qbuf);
          rows_product<HDP>(dp, vf, dob);
          hopper::wgmma_commit();
          win_bias_cols<NQ, NK>(tv, bh, row0, q);
          hopper::wgmma_wait<0>();
          hopper::fence_operands(sc);
          hopper::fence_operands(dp);
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int col = 8 * (e >> 2) + 2 * q + (e & 1);  // the query
            const float p = __expf(sc[e] + tv[e] - sm[col]) * sm[UNIT_ROWS + col];
            sc[e] = p;
            dp[e] = p * (dp[e] - sm[2 * UNIT_ROWS + col]);
          }
          uint32_t pf[4][4], sf[4][4];
          to_frags(pf, sc);
          to_frags(sf, dp);
          hopper::wgmma_fence();
          block_product<HDP>(dk, sf, qbuf);
          block_product<HDP>(dv, pf, dob);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_operands(dk);
          hopper::fence_operands(dv);
          const int hd = a.c / a.nh;
          store_window_rows<HDP>(a.dk + static_cast<size_t>(w) * NK * a.c, dk, row0, q, NK, a.c,
                                 hd, hh * hd);
          store_window_rows<HDP>(a.dv + static_cast<size_t>(w) * NK * a.c, dv, row0, q, NK, a.c,
                                 hd, hh * hd);
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bars + 8u * (2 + st));  // the stage is free
  }
  if constexpr (BWD) {
    // the two consumers' partials, added in a fixed order, written once
    asm volatile("bar.sync 3, %0;\n" ::"n"(128 * OW_CONS) : "memory");
    const float* p0 = reinterpret_cast<const float*>(smem_raw + (part_at - raw));
    const float* p1 = p0 + UNIT_ROWS * LDP;
    float* out = a.prpb + (static_cast<size_t>(first) * a.nh + hh) * NQ * NK;
    for (int e = tid; e < NQ * NK; e += 128 * OW_CONS) {
      const int r = e / NK, c = e - r * NK;
      out[e] = p0[r * LDP + c] + p1[r * LDP + c];
    }
  }
}

struct WinHeadsArgs {
  const bf16* src[3];  // q [windows][NQ][c], k, v [windows][NK][c]: the window layout
  bf16* dst[3];        // OwArgs' q, k, v: [windows][nh][N][hdp], rows swizzled
  int n[3], windows, c, nh, hdp;
};

// q, k, v from the window layout to the head-major operands
// (kernels/fused_ocab.py ``to_heads``): blockIdx.y the part, a thread a
// 16-byte chunk (8 dims of a row) of the part's output in order, grid-
// stride; the chunk's dims 8 j .. 8 j + 7 of the row's head (j the stored
// chunk's swizzle), zero past hd.  WIDE where hd and c are multiples of 8
// (a chunk wholly real or wholly padding): one 16-byte load; else 2-byte
// loads (hd need not be even).
template <bool WIDE>
__global__ void __launch_bounds__(256) ocab_win_heads_kernel(const WinHeadsArgs a) {
  const int part = blockIdx.y, n = a.n[part], hd = a.c / a.nh;
  const int cpr = a.hdp / 8, rb = 2 * a.hdp;
  const long long per_unit = static_cast<long long>(n) * cpr;
  const long long total = static_cast<long long>(a.windows) * a.nh * per_unit;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(a.src[part]);
  uint4* dst = reinterpret_cast<uint4*>(a.dst[part]);
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * 256) {
    const long long unit = i / per_unit;
    const int rem = static_cast<int>(i - unit * per_unit);
    const int r = rem / cpr, js = rem - r * cpr;
    const int j = js ^ (((r * rb) >> 7) & (rb / 16 - 1));  // the chunk's dims 8 j ..
    const long long win = unit / a.nh;
    const int hh = static_cast<int>(unit - win * a.nh);
    const unsigned short* sp = src + (win * n + r) * a.c + hh * hd + 8 * j;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (WIDE) {
      if (8 * j < hd) u = __ldg(reinterpret_cast<const uint4*>(sp));
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const uint32_t lo = 8 * j + e < hd ? sp[e] : 0u;
        const uint32_t hi = 8 * j + e + 1 < hd ? sp[e + 1] : 0u;
        w[e / 2] = lo | (hi << 16);
      }
      u = make_uint4(w[0], w[1], w[2], w[3]);
    }
    dst[i] = u;
  }
}

int launch_win_heads(const WinHeadsArgs& a, cudaStream_t s) {
  // blocks enough for the largest part's chunks, at most eight an SM
  const int n_most = a.n[0] > a.n[1] ? a.n[0] : a.n[1];
  const long long chunks = static_cast<long long>(a.windows) * a.nh * n_most * (a.hdp / 8);
  const long long blocks = (chunks + 255) / 256;
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long cap = 8LL * (sms > 0 ? sms : 1);
  const dim3 grid(static_cast<unsigned>(blocks < 1 ? 1 : blocks < cap ? blocks : cap), 3);
  const int hd = a.c / a.nh;
  bool wide = hd % 8 == 0 && a.c % 8 == 0;
  for (int p = 0; p < 3; ++p) wide = wide && aligned_to(a.src[p], 16);
  if (wide)
    ocab_win_heads_kernel<true><<<grid, 256, 0, s>>>(a);
  else
    ocab_win_heads_kernel<false><<<grid, 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int WS, int OWS, int HDP, bool BWD>
int launch_attn(const OwArgs& a, cudaStream_t s) {
  using L = OwLayout<WS, OWS, HDP, BWD>;
  auto kernel = ocab_win_attn_kernel<WS, OWS, HDP, BWD>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<a.nh * a.cph, OW_THREADS, L::SMEM, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool BWD>
int launch_attn_at(const OwArgs& a, int ws, int hdp, cudaStream_t s) {
  if (ws == 7) return hdp == 16 ? launch_attn<7, 10, 16, BWD>(a, s) : launch_attn<7, 10, 32, BWD>(a, s);
  return hdp == 16 ? launch_attn<8, 12, 16, BWD>(a, s) : launch_attn<8, 12, 32, BWD>(a, s);
}

template <int WS, int MODE>
int launch_k5a(const Args& a, int cp, int hdp, int grid, cudaStream_t s) {
  if (cp == 96 && hdp == 16) return launch_window<WS, 96, 16, MODE>(a, grid, s);
  if (cp == 96 && hdp == 32) return launch_window<WS, 96, 32, MODE>(a, grid, s);
  if (cp == 192 && hdp == 32) return launch_window<WS, 192, 32, MODE>(a, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan (kernels/fused_ocab.py ocab_bwd_plan): windows, ws, ows, c, nh,
// hidden, cp, hdp (the stream's padded widths), stages (K5a's ring),
// gelu_tanh, grid (K5a's CTAs), splits (K5b's), cph (the attention
// kernels' CTAs a head).
struct Geo {
  int windows, ws, ows, c, nh, hidden, cp, hdp, stages, gelu_tanh, grid, splits, cph;
};

bool geo_ok(const Geo& g) {
  const bool widths = (g.cp == 96 && (g.hdp == 16 || g.hdp == 32)) || (g.cp == 192 && g.hdp == 32);
  const bool window = (g.ws == 7 && g.ows == 10) || (g.ws == 8 && g.ows == 12);
  const long long pairs = (static_cast<long long>(g.windows) + NCONS - 1) / NCONS;
  return widths && window && g.windows >= 0 && g.c >= 1 && g.c <= g.cp && g.nh >= 1 &&
         g.nh <= MAX_HEADS && g.c % g.nh == 0 && g.c / g.nh <= g.hdp && g.nh * g.hdp <= g.cp &&
         g.hidden >= 1 && g.stages >= 2 && g.stages <= MAX_STAGES &&
         g.grid >= 1 && (pairs == 0 || g.grid <= pairs) && g.splits >= 1 &&
         (g.windows == 0 || g.splits <= g.windows) && g.cph >= 1 &&
         (g.windows == 0 || g.cph <= g.windows);
}

// K5a's arguments for the OCAB at ws 7 / 8: the window layout as a
// [windows, ws, ws, c] map (shift 0) of sw, the weight stream and its
// biases, O as the workspace's first operand; the rest set by the caller.
Args k5a_args(const Geo& g, const void* sw, const void* tiles, const void* bproj,
              const void* bfc1, const void* bfc2, const void* g2, const void* b2, const void* o,
              float eps) {
  Args a{};
  a.batch = g.windows;
  a.h = a.w = g.ws;
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

// The attention kernels' arguments on the head-major q, k, v.
OwArgs attn_args(const Geo& g, const void* qh, const void* kh, const void* vh,
                 const void* bias, const void* o, const void* stat) {
  OwArgs t{};
  t.q = static_cast<const bf16*>(qh);
  t.k = static_cast<const bf16*>(kh);
  t.v = static_cast<const bf16*>(vh);
  t.bias = static_cast<const float*>(bias);
  t.o = const_cast<bf16*>(static_cast<const bf16*>(o));
  t.stat = const_cast<float*>(static_cast<const float*>(stat));
  t.windows = g.windows;
  t.nh = g.nh;
  t.cph = g.cph;
  t.o_tiles = (g.cp + 63) / 64;
  t.c = g.c;
  return t;
}

}  // namespace

// K8's three launches on one stream.  q, sw, out [windows, ws^2, c] and
// k, v [windows, ows^2, c] bf16 in the window layout; tiles and the fp32
// biases and LN2 parameters as ``pack_ocab_tiles`` lays them out; bias
// [nh, ws^2, ows^2] fp32.  Outputs besides out, which the backward reads
// (kernels/fused_ocab.py ``ocab_fwd_bytes`` sizes them): qh [windows, nh,
// ws^2, hdp], kh, vh [windows, nh, ows^2, hdp] (the head-major operands,
// ``to_heads``' layout), o (K5a's workspace operand O,
// [windows][cp / 64][64][64], zero past the heads' columns: the caller
// zeroes those) and stat [windows, nh, 2, 64]; x1ws [grid][2][64 cp] fp32
// scratch.  geo: the plan (this entry checks it).
extern "C" int sr_ocab_fwd_bf16(const void* q, const void* k, const void* v, const void* sw,
                                void* out, const void* tiles, const void* bproj,
                                const void* bfc1, const void* bfc2, const void* g2,
                                const void* b2, const void* bias, void* qh, void* kh, void* vh,
                                void* o, void* stat, void* x1ws, const int* geo, float eps,
                                void* stream) {
  const Geo g{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], geo[6],
              geo[7], geo[8], geo[9], geo[10], geo[11], geo[12]};
  if (!geo_ok(g) || !aligned_to(q, 2) || !aligned_to(k, 2) || !aligned_to(v, 2) ||
      !aligned_to(qh, 16) || !aligned_to(kh, 16) || !aligned_to(vh, 16) ||
      !aligned_to(tiles, 16) || !aligned_to(bproj, 8) || !aligned_to(bfc1, 8) ||
      !aligned_to(bfc2, 8) || !aligned_to(bias, 8) || !aligned_to(o, 16) ||
      !aligned_to(stat, 16) || !aligned_to(x1ws, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.windows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  WinHeadsArgs h{};
  h.src[0] = static_cast<const bf16*>(q);
  h.src[1] = static_cast<const bf16*>(k);
  h.src[2] = static_cast<const bf16*>(v);
  h.dst[0] = static_cast<bf16*>(qh);
  h.dst[1] = static_cast<bf16*>(kh);
  h.dst[2] = static_cast<bf16*>(vh);
  h.n[0] = g.ws * g.ws;
  h.n[1] = h.n[2] = g.ows * g.ows;
  h.windows = g.windows;
  h.c = g.c;
  h.nh = g.nh;
  h.hdp = g.hdp;
  int status = launch_win_heads(h, s);
  if (status != 0) return status;
  status = launch_attn_at<false>(attn_args(g, qh, kh, vh, bias, o, stat), g.ws, g.hdp, s);
  if (status != 0) return status;
  Args a = k5a_args(g, sw, tiles, bproj, bfc1, bfc2, g2, b2, o, eps);
  a.out = static_cast<bf16*>(out);
  a.x1ws = static_cast<float*>(x1ws);
  return g.ws == 7 ? launch_k5a<7, MODE_OFWD>(a, g.cp, g.hdp, g.grid, s)
                   : launch_k5a<8, MODE_OFWD>(a, g.cp, g.hdp, g.grid, s);
}

// K8b's four launches on one stream.  ct, sw, dsw, dq [windows, ws^2, c]
// and dk, dv [windows, ows^2, c] bf16 in the window layout; tiles, the
// fp32 biases, LN2 parameters and bias as the forward's; qh, kh, vh, o and
// stat the forward's outputs.  Workspaces (kernels/fused_ocab.py
// ``ocab_bwd_bytes`` sizes them): ws the dW operands of the units (y2c,
// act, dattn, dh1, dmlp: cp / 64, chunks, cp / 64, chunks, cp / 64 tiles a
// unit), doh [windows, nh, 64, hdp] and drow [windows, nh, 64] (the
// middle's dO and D), x1ws [windows + windows % 2][64 cp], pvec the
// middle's LN2 sums [grid][2][4][4 cp], prpb [cph][nh][ws^2][ows^2], pw
// K5b's splits'; outputs gv ([the weight stream's gradient | the bias sums
// in the stream's bias layout | the LN sums g1 b1 g2 b2, cp each], fp32)
// and dbias [nh, ws^2, ows^2].
extern "C" int sr_ocab_bwd_bf16(const void* ct, const void* sw, void* dq, void* dk, void* dv,
                                void* dsw, const void* tiles, const void* bproj,
                                const void* bfc1, const void* bfc2, const void* g2,
                                const void* b2, const void* bias, const void* qh,
                                const void* kh, const void* vh, const void* o,
                                const void* stat, void* ws, void* doh, void* drow, void* x1ws,
                                void* pvec, void* prpb, void* pw, void* gv, void* dbias,
                                const int* geo, float eps, void* stream) {
  const Geo g{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], geo[6],
              geo[7], geo[8], geo[9], geo[10], geo[11], geo[12]};
  if (!geo_ok(g) || !aligned_to(qh, 16) || !aligned_to(kh, 16) || !aligned_to(vh, 16) ||
      !aligned_to(dq, 4) || !aligned_to(dk, 4) || !aligned_to(dv, 4) || !aligned_to(tiles, 16) ||
      !aligned_to(bproj, 8) || !aligned_to(bfc1, 8) || !aligned_to(bfc2, 8) ||
      !aligned_to(bias, 8) || !aligned_to(o, 16) || !aligned_to(stat, 16) ||
      !aligned_to(ws, 16) || !aligned_to(doh, 16) || !aligned_to(drow, 16) ||
      !aligned_to(x1ws, 16) || !aligned_to(pvec, 8) || !aligned_to(prpb, 4) ||
      !aligned_to(pw, 4) || !aligned_to(gv, 4) || !aligned_to(dbias, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.windows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kc = (g.cp + 63) / 64;
  const int nq = g.ws * g.ws, nk = g.ows * g.ows;

  // K5a's middle
  Args a = k5a_args(g, sw, tiles, bproj, bfc1, bfc2, g2, b2, o, eps);
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
    p += static_cast<size_t>(g.windows) * tiles_of[i] * TILE_ELEMS;
  }
  int status = g.ws == 7 ? launch_k5a<7, MODE_MID>(a, g.cp, g.hdp, g.grid, s)
                         : launch_k5a<8, MODE_MID>(a, g.cp, g.hdp, g.grid, s);
  if (status != 0) return status;

  OwArgs t = attn_args(g, qh, kh, vh, bias, o, stat);
  t.doh = a.doh;
  t.drow = a.drow;
  t.dq = static_cast<bf16*>(dq);
  t.dk = static_cast<bf16*>(dk);
  t.dv = static_cast<bf16*>(dv);
  t.prpb = static_cast<float*>(prpb);
  status = launch_attn_at<true>(t, g.ws, g.hdp, s);
  if (status != 0) return status;

  // K5b over the proj, fc1 and fc2 (no qkv operands), then K5c; the
  // stream's layout as ``pack_block_tiles``'
  const int pwid = part_width(g.cp), nhalf = g.cp / pwid, q3 = 3 * g.hdp;
  const long long stream_len = static_cast<long long>(g.nh) * kc * q3 * 64 +
                               static_cast<long long>(nhalf) * kc * pwid * 64 +
                               static_cast<long long>(a.chunks) * (kc * 4096 + nhalf * pwid * 64);
  const long long bias_len = g.nh * q3 + 2LL * g.cp + a.chunks * HC;
  float* wgrad = static_cast<float*>(gv);
  float* vec = wgrad + stream_len;
  const long long ln_rows = static_cast<long long>(g.grid) * NCONS * 4;
  return launch_wgrad_reduce(
      a, g.windows, g.cp, g.hdp, g.splits, static_cast<float*>(pw), wgrad, vec,
      {static_cast<const float*>(pvec), ln_rows, a.vl, vec + bias_len},
      {static_cast<const float*>(prpb), g.cph, static_cast<long long>(g.nh) * nq * nk,
       static_cast<float*>(dbias)},
      s);
}
