// K7's attention, and K15 / K16 where it is the fastest kernel — window
// attention whose keys stream through an mbarrier ring, on Hopper's wgmma.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_attention.py
//           fused_window_block_attention (pallas_call at :229; oracle
//           _reference_impl :177): its biased, masked softmax attention,
//           between K7's qkv and proj products (csrc/window_attn.cu); and
//           tpu_superresolution_tpu/ops/pallas/window_attention.py
//           fused_window_attention / batched_window_attention (:193,
//           :352) for the shapes kernels/window_attention.py::k15_route
//           sends here (the heads of more than 32 dims the wgmma kernel
//           does not take: masked units, K16 at hd 33-64, more than 256
//           keys, heads past 64 dims);
//           and, as K9's attention (csrc/dat_rect.cu), DAT's rect-window
//           branches: tpu_superresolution_tpu/ops/pallas/fused_rect_attn.py
//           fused_rect_attention (pallas_call at :433).
// Math (per window w and head h):
//         out[w, h] = softmax(scale q k^T + bias[h] + mask[w % nW]) v
//       scores and softmax fp32 (in the log2 domain), P rounded to bf16
//       once (or, split_p, as two bf16 parts), fp32 sums.  The bias and
//       mask come either dense ([nH, Nq, Nk] and [nW, Nq, Nk] fp32 read
//       from device memory) or, K7's Swin windows ("rel"), as the
//       relative-position table [(2ws-1)^2, nH] fp32 (the head's column
//       resident in shared memory) and a code per token, [n_codes, N]
//       int32: bits 0-15 the token's position y (2ws-1) + x, bits 16-31
//       its shift region.  bias = table[pos_q - pos_k + (ws-1)(2ws-1) +
//       ws-1] (ops/window.py::relative_position_index; a ws x ws_w rect
//       window, K9's: position y (2ws_w-1) + x, offset (ws-1)(2ws_w-1) +
//       ws_w-1, table [(2ws-1)(2ws_w-1), nH]), mask = -100 where
//       the regions differ (ops/window.py::shift_attn_mask): the same fp32
//       values as the dense form, from arithmetic in place of ~1.3 GB of
//       L2 reads a HAT-SRx4 call.
// Layouts: q, k, v either [BW, nH, N, hd] bf16, repacked by the producer
//       with cp.async into the swizzled layout wgmma reads ("repack": K15,
//       K16), or K7's head-split qkv workspace [3, BW, nH, nb, N, hb]
//       (csrc/window_attn.cu's epilogue writes each (part, window, head,
//       block) run already swizzled), a run taken by one bulk copy
//       ("bulk").  The output is [BW, nH, Nq, hd] (head-major), K7's
//       token-major [BW * N, nH * nb * hb] that its proj product reads, or
//       (K9) each row at its pixel of the [B, H, W, C] map.
//       Heads are padded to hb = 16, 32 or 64 dims, nb blocks of hb
//       (hd 65-128: two 64-dim blocks, and so on).
// Design: a persistent grid of nH x G CTAs (csrc/window_attn_wg.cu's
//       head-major walk: CTA (h, g) takes windows g, g + G, ...).
//       Warpgroup 2 produces (setmaxnreg gives its registers away): it
//       fills a ring of "items", each a run of query rows and of key rows
//       of one (window, head) unit, with their codes; warpgroups 0 and 1
//       consume alternate (unit, query-tile group) pairs.  Where two
//       stages of a whole unit fit, an item is the whole unit ("whole";
//       K7 at N 256: 64-row query tiles against two 128-key chunks); else
//       ("stream") an item is one 64-row
//       query tile and one key chunk, the pair's items consecutive for
//       its consumer and interleaved between the two, with an online
//       softmax across chunks, so no window is too large (ws 32: 1024
//       keys).  S = Q K^T of a chunk (128 keys, 64 for units of at most
//       64) is one wgmma m64 x chunk x k16 a k-step over
//       the head's hb-dim blocks; O = P V with P from registers (WgmmaRS) and
//       V an MN-major B, at most two 64-dim blocks (128 output columns)
//       a pass: past 128 dims the items run once per pass of V's columns,
//       recomputing S (their registers hold one pass's O).  The epilogue
//       stages O / l in shared memory and stores 16-byte vectors.
// Bound on the H100: HAT-SRx4's attention (K7's at [25,64,64,180], ws
//       16, 6 heads padded to 32 dims): 20.1 GFLOP of QK^T and PV (0.020
//       ms at the bf16 peak), 157M exp2 (~0.04 ms of the SFUs), 118 MB of
//       q, k, v in and 39 MB out (0.047 ms): memory- and SFU-bound.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int QT = 64;             // query rows a tile (wgmma's M)
constexpr int NCONS = 2;           // consumer warpgroups
constexpr int NTHREADS = 128 * (NCONS + 1);
constexpr int PRODUCER_REGS = 72;  // setmaxnreg: 128 x 72 + 256 x 216 <= 64K
constexpr int CONSUMER_REGS = 216;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const bf16* q;        // repack: [BW, nh, nq, hd]; bulk: the workspace (k, v follow)
  const bf16* k;
  const bf16* v;
  const float* bias;    // dense [nh, nq, nk]; rel: table [tsize, nh]
  const float* mask;    // dense [n_mask, nq, nk] or null
  const int* codes;     // rel: [n_codes, nk]
  bf16* out;            // [BW, nh, nq, hd], token-major [BW * nq, nh * nb * hb] or pixels
  int bw, nh, nq, nk, hd, nb, n_mask, n_codes, tsize, toff;
  int wsh, wsw;          // rel: the window's rows and columns
  // pixel output (K9): row t of window w to its pixel of the [B, h, w,
  // ld] map, rolled back by (sh, sw) on the hp x wp padded map, columns
  // col0 + head * hd; a pad token's row is not stored
  int pix, pix_h, pix_w, pix_hp, pix_wp, pix_sh, pix_sw, pix_ld, pix_col0, pix_nwin, pix_nwx;
  int shifted;           // rel: the codes' region bits are read (else ignored)
  int per_head, stages, ncons;
  int qi, pi, ki;       // query tiles, passes, key chunks an item
  int nqt, passes, nkc;
  int bulk, tokmajor, vec, vec_out;
  float scale_log2;
  uint32_t q_blk, kv_blk, codes_off, stage_bytes, staging_bytes, table_bytes;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void consumer_barrier(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(cw + 1) : "memory");  // one warpgroup
}

// Rows [0, rows) of columns [col0, col0 + ncols) of a [*, ld] bf16 array
// at `src` into the swizzled [rows][HB] block at shared address `dst`, by
// the producer warpgroup's thread t, `vec` bf16 a copy.
template <int HB>
__device__ __forceinline__ void repack_block(uint32_t dst, const bf16* src, int rows, int ld,
                                             int col0, int ncols, int vec, int t) {
  constexpr int RB = HB * 2;
  if (vec == 8) {
    const int cpr = ncols >> 3;
    for (int i = t; i < rows * cpr; i += 128) {
      const int r = i / cpr, c = i - r * cpr;
      hopper::cp_async<16>(dst + hopper::swizzled_offset<RB>(r * RB + c * 16),
                           src + static_cast<long long>(r) * ld + col0 + 8 * c, 16);
    }
  } else if (vec == 2) {
    const int cpr = ncols >> 1;
    for (int i = t; i < rows * cpr; i += 128) {
      const int r = i / cpr, c = i - r * cpr;
      hopper::cp_async<4>(dst + hopper::swizzled_offset<RB>(r * RB + c * 4),
                          src + static_cast<long long>(r) * ld + col0 + 2 * c, 4);
    }
  } else {
    for (int i = t; i < rows * ncols; i += 128) {
      const int r = i / ncols, c = i - r * ncols;
      const unsigned short e = __ldg(reinterpret_cast<const unsigned short*>(src) +
                                     static_cast<long long>(r) * ld + col0 + c);
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(
                       dst + hopper::swizzled_offset<RB>(r * RB + c * 2)),
                   "h"(e)
                   : "memory");
    }
  }
}

// The item order, shared by the producer and the consumers: a CTA's
// pairs (unit, query-tile group, pass group) in groups of ncons; within a
// group, for each key group, one item of each pair of the group.
struct Order {
  int npairs_unit, nkg, npairs, ncons;
  __device__ __forceinline__ int group_size(int grp) const {
    return min(ncons, npairs - grp * ncons);
  }
};

// 2^x by the SFU's approximation (relative error ~2^-22; 0 at -inf).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The rel form's scores of one chunk in the log2 domain, in place: slice
// j's columns c0 + {0, 1, 8, 9} (c0 = kbase + 16 j + 2 q4) of rows r0 and
// r1; the bias tab_r[-pos(col)] and, kMasked, -100 where the regions
// differ, each added by one fmaf with log2 e as the dense form adds them,
// so that the values are the same; kFull: every column is a key (no
// test).  Returns the rows' maxima over the chunk.
template <int NS, bool kMasked, bool kFull>
__device__ __forceinline__ void rel_scores(float (&sc)[NS * 8], const int* scodes, int kbase,
                                           int q4, const float* tab0, const float* tab1,
                                           int qreg0, int qreg1, float sl, int nk, float& mx0,
                                           float& mx1) {
  const float neg_inf = -__int_as_float(0x7f800000);
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int c0 = kbase + j * 16 + 2 * q4;
    const int2 kc01 = *reinterpret_cast<const int2*>(scodes + c0);  // (col even)
    const int2 kc89 = *reinterpret_cast<const int2*>(scodes + c0 + 8);
    const int kcode[4] = {kc01.x, kc01.y, kc89.x, kc89.y};
#pragma unroll
    for (int e2 = 0; e2 < 4; ++e2) {
      const int e0 = 4 * (e2 >> 1) + (e2 & 1);  // row r0's element; r1's is e0 + 2
      const int kpos = kcode[e2] & 0xffff;
      float x0 = fmaf(tab0[-kpos], LOG2E, sc[8 * j + e0] * sl);
      float x1 = fmaf(tab1[-kpos], LOG2E, sc[8 * j + e0 + 2] * sl);
      if constexpr (kMasked) {
        const int kreg = kcode[e2] >> 16;
        x0 = fmaf(qreg0 != kreg ? -100.f : 0.f, LOG2E, x0);
        x1 = fmaf(qreg1 != kreg ? -100.f : 0.f, LOG2E, x1);
      }
      if constexpr (!kFull) {
        const int col = c0 + 8 * (e2 >> 1) + (e2 & 1);
        x0 = col < nk ? x0 : neg_inf;
        x1 = col < nk ? x1 : neg_inf;
      }
      sc[8 * j + e0] = x0;
      sc[8 * j + e0 + 2] = x1;
    }
    const float* t = sc + 8 * j;
    mx0 = fmaxf(mx0, fmaxf(fmaxf(t[0], t[1]), fmaxf(t[4], t[5])));
    mx1 = fmaxf(mx1, fmaxf(fmaxf(t[2], t[3]), fmaxf(t[6], t[7])));
  }
}

// HB: head block width; OB: 64-dim blocks of O a pass (1, or 2 at HB
// 64); NS: 16-key slices a chunk; kRel: the table + codes bias and mask;
// kSplitP: P V in two bf16 parts.
template <int HB, int OB, int NS, bool kRel, bool kSplitP>
__global__ void __launch_bounds__(NTHREADS, 1) window_attn_stream_kernel(const Args a) {
  constexpr int RB = HB * 2;
  constexpr int KC = NS * 16;
  constexpr int SC = OB * HB;  // staging columns
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t zero_tile = ring + a.stages * a.stage_bytes;  // 16 zero rows of 128 bytes
  const uint32_t staging = zero_tile + 2048u;
  const uint32_t table_at = staging + a.staging_bytes;
  const uint32_t bars = table_at + a.table_bytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (MAX_STAGES + s); };
  const float* stab = reinterpret_cast<const float*>(smem_raw + (table_at - raw));
  const float neg_inf = -__int_as_float(0x7f800000);

  const int tid = threadIdx.x;
  const int h = blockIdx.x / a.per_head, g = blockIdx.x % a.per_head;
  if constexpr (kRel) {
    float* t = reinterpret_cast<float*>(smem_raw + (table_at - raw));
    for (int i = tid; i < a.tsize; i += NTHREADS) t[i] = a.bias[i * a.nh + h];
  }
  for (uint32_t i = tid * 16u; i < a.stages * a.stage_bytes + 2048u; i += NTHREADS * 16u)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(ring + i), "r"(0u)
                 : "memory");
  hopper::fence_proxy_async();  // the zeros, before wgmma reads them
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      hopper::mbar_init(full(s), 129);  // every producer thread, and thread 0 once more
      hopper::mbar_init(empty(s), 128);  // the consuming warpgroup
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int n_units = (a.bw - g + a.per_head - 1) / a.per_head;  // windows g, g + G, ...
  Order ord;
  ord.npairs_unit = (a.nqt / a.qi) * (a.passes / a.pi);
  ord.nkg = a.nkc / a.ki;
  ord.npairs = n_units * ord.npairs_unit;
  ord.ncons = a.ncons;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform role
  const long long plane = static_cast<long long>(a.nq) * a.nk;
  const int qrows = a.qi * QT, krows = a.ki * KC;  // rows an item holds

  if (wg == NCONS) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int t = tid - 128 * NCONS;
    const long long part = static_cast<long long>(a.bw) * a.nh * a.nb * a.nk * HB;
    int it = 0;
    for (int grp = 0; grp * a.ncons < ord.npairs; ++grp) {
      const int gs = ord.group_size(grp);
      for (int kg = 0; kg < ord.nkg; ++kg) {
        for (int c = 0; c < gs; ++c, ++it) {
          const int pair = grp * a.ncons + c;
          const int u = pair / ord.npairs_unit, pr = pair - u * ord.npairs_unit;
          const int qg = pr / (a.passes / a.pi);
          const int w = g + u * a.per_head;
          const int s = it % a.stages;
          if (it >= a.stages) hopper::mbar_wait(empty(s), ((it / a.stages) - 1) & 1);
          const uint32_t qd = ring + s * a.stage_bytes;
          const uint32_t kd = qd + a.nb * a.q_blk, vd = kd + a.nb * a.kv_blk;
          const int q0 = qg * qrows, k0 = kg * krows;
          const int nqr = min(qrows, a.nq - q0), nkr = min(krows, a.nk - k0);
          const long long wh = static_cast<long long>(w) * a.nh + h;
          if (a.bulk) {
            if (t == 0) {
              hopper::mbar_arrive_expect_tx(
                  full(s), static_cast<uint32_t>(a.nb) * (nqr + 2 * nkr) * RB);
              for (int b = 0; b < a.nb; ++b) {
                const bf16* run = a.q + (wh * a.nb + b) * a.nk * HB;
                hopper::bulk_copy(qd + b * a.q_blk, run + q0 * HB, nqr * RB, full(s));
                hopper::bulk_copy(kd + b * a.kv_blk, run + part + k0 * HB, nkr * RB, full(s));
                hopper::bulk_copy(vd + b * a.kv_blk, run + 2 * part + k0 * HB, nkr * RB,
                                  full(s));
              }
            }
            if constexpr (kRel) {
              int* dst = reinterpret_cast<int*>(smem_raw + (qd + a.codes_off - raw));
              const int* src = a.codes + static_cast<long long>(w % a.n_codes) * a.nk;
              for (int i = t; i < a.nk; i += 128) dst[i] = __ldg(src + i);
            }
            hopper::mbar_arrive(full(s));
          } else {
            const bf16* qs = a.q + (wh * a.nq + q0) * a.hd;
            const bf16* ks = a.k + (wh * a.nk + k0) * a.hd;
            const bf16* vs = a.v + (wh * a.nk + k0) * a.hd;
            for (int b = 0; b < a.nb; ++b) {
              const int col0 = b * HB, nc = min(HB, a.hd - col0);
              repack_block<HB>(qd + b * a.q_blk, qs, nqr, a.hd, col0, nc, a.vec, t);
              repack_block<HB>(kd + b * a.kv_blk, ks, nkr, a.hd, col0, nc, a.vec, t);
              repack_block<HB>(vd + b * a.kv_blk, vs, nkr, a.hd, col0, nc, a.vec, t);
            }
            if (t == 0) hopper::mbar_arrive(full(s));
            if (a.vec == 1)
              hopper::mbar_arrive(full(s));  // (shared stores: ordered by the arrive)
            else
              hopper::cp_async_arrive_noinc(full(s));
          }
        }
      }
    }
    hopper::cp_async_wait_all();
    return;
  }
  // ------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int cw = wg, ct = tid & 127, wi = ct >> 5, lane = tid & 31, q4 = lane & 3;
  if (cw >= a.ncons) return;
  bf16* sg = reinterpret_cast<bf16*>(smem_raw + (staging + cw * (QT * SC * 2) - raw));
  const float sl = a.scale_log2;
  const int hdw = a.nb * HB;
  float o[OB][HB / 2];  // finite from here on
#pragma unroll
  for (int b = 0; b < OB; ++b)
#pragma unroll
    for (int e = 0; e < HB / 2; ++e) o[b][e] = 0.f;
  float m0 = neg_inf, m1 = neg_inf, l0 = 0.f, l1 = 0.f;
  int it0 = 0;  // the first item of the group
  for (int grp = 0; grp * a.ncons < ord.npairs; ++grp) {
    const int gs = ord.group_size(grp);
    if (cw < gs) {
      const int pair = grp * a.ncons + cw;
      const int u = pair / ord.npairs_unit, pr = pair - u * ord.npairs_unit;
      const int qg = pr / (a.passes / a.pi), pg = pr - qg * (a.passes / a.pi);
      const int w = g + u * a.per_head;
      const long long wh = static_cast<long long>(w) * a.nh + h;
      const float* gbias = kRel ? nullptr : a.bias + h * plane;
      const float* mwin =
          (!kRel && a.mask) ? a.mask + static_cast<long long>(w % a.n_mask) * plane : nullptr;
      for (int kg = 0; kg < ord.nkg; ++kg) {
        const int it = it0 + kg * gs + cw;
        const int s = it % a.stages;
        hopper::mbar_wait(full(s), (it / a.stages) & 1);
        // the producer's generic-proxy writes (and the bulk copies'
        // bytes), visible through the barrier, before this thread's wgmma
        hopper::fence_proxy_async();
        const uint32_t qd = ring + s * a.stage_bytes;
        const uint32_t kd = qd + a.nb * a.q_blk, vd = kd + a.nb * a.kv_blk;
        const int* scodes = reinterpret_cast<const int*>(smem_raw + (qd + a.codes_off - raw));
        for (int ql = 0; ql < a.qi; ++ql) {
          const int qt = qg * a.qi + ql;
          const int r0 = qt * QT + wi * 16 + (lane >> 2), r1 = r0 + 8;
          // the rows' table rows: bias(r, col) = tab_r[-pos(col)]
          const float* tab0 = stab;
          const float* tab1 = stab;
          int qreg0 = 0, qreg1 = 0;
          if constexpr (kRel) {
            const int c0 = scodes[r0], c1 = scodes[r1];  // zero past nq
            tab0 = stab + (c0 & 0xffff) + a.toff;
            tab1 = stab + (c1 & 0xffff) + a.toff;
            qreg0 = c0 >> 16;
            qreg1 = c1 >> 16;
          }
          for (int pl = 0; pl < a.pi; ++pl) {
            const int pass = pg * a.pi + pl;
            if (kg == 0) {  // o needs no zeroing: its rescale by exp2(-inf) does it
              m0 = m1 = neg_inf;
              l0 = l1 = 0.f;
            }
            for (int kl = 0; kl < a.ki; ++kl) {
              const int kc = kg * a.ki + kl;  // the chunk; its rows in the item from kl KC
              const int nsub = min(NS, (a.nk - kc * KC + 15) >> 4);
              // S = Q K^T: the chunk's KC keys as one wgmma N (its
              // accumulator element 8 j + e is 16-key slice j's e); the
              // rows past the keys are stale or another part's, finite, and
              // their scores are replaced below.  One head block (OB 1)
              // unrolled; past 64 dims a loop over the blocks.
              float sc[NS * 8];
              hopper::wgmma_fence();
              const int nbl = OB == 1 ? 1 : a.nb;
              for (int b = 0; b < nbl; ++b) {
                const uint64_t dq =
                    hopper::desc_swizzled<RB>(qd + b * a.q_blk + ql * QT * RB);
                const uint64_t dk = hopper::desc_swizzled<RB>(kd + b * a.kv_blk + kl * KC * RB);
#pragma unroll
                for (int kk = 0; kk < HB / 16; ++kk)
                  hopper::Wgmma<KC>::mma(sc, dq + 2 * kk, dk + 2 * kk, b > 0 || kk > 0);
              }
              hopper::wgmma_commit();
              hopper::wgmma_wait<0>();
              hopper::fence_operands(sc);
              float mx0 = neg_inf, mx1 = neg_inf;
              if constexpr (kRel) {
                // uniform branches: the regions only where the block is
                // shifted, and a chunk inside the keys needs no key test
                const bool full = (kc + 1) * KC <= a.nk;
                if (full && !a.shifted)
                  rel_scores<NS, false, true>(sc, scodes, kc * KC, q4, tab0, tab1, qreg0, qreg1,
                                              sl, a.nk, mx0, mx1);
                else if (full)
                  rel_scores<NS, true, true>(sc, scodes, kc * KC, q4, tab0, tab1, qreg0, qreg1,
                                             sl, a.nk, mx0, mx1);
                else if (a.shifted)
                  rel_scores<NS, true, false>(sc, scodes, kc * KC, q4, tab0, tab1, qreg0, qreg1,
                                              sl, a.nk, mx0, mx1);
                else
                  rel_scores<NS, false, false>(sc, scodes, kc * KC, q4, tab0, tab1, qreg0, qreg1,
                                               sl, a.nk, mx0, mx1);
              } else {
#pragma unroll
                for (int j = 0; j < NS; ++j) {
#pragma unroll
                  for (int e2 = 0; e2 < 4; ++e2) {
                    // columns col, col + 1 of rows r0 (e 0, 1 / 4, 5) and r1
                    const int col = kc * KC + j * 16 + 8 * (e2 >> 1) + 2 * q4 + (e2 & 1);
                    const int e0 = 4 * (e2 >> 1) + (e2 & 1);  // row r0's element
                    float x0 = neg_inf, x1 = neg_inf;
                    if (col < a.nk) {
                      x0 = sc[8 * j + e0] * sl;
                      x1 = sc[8 * j + e0 + 2] * sl;
                      // pad query rows without bias (dropped at the store)
                      if (r0 < a.nq) {
                        const long long at = static_cast<long long>(r0) * a.nk + col;
                        x0 = fmaf(gbias[at], LOG2E, x0);
                        if (mwin) x0 = fmaf(mwin[at], LOG2E, x0);
                      }
                      if (r1 < a.nq) {
                        const long long at = static_cast<long long>(r1) * a.nk + col;
                        x1 = fmaf(gbias[at], LOG2E, x1);
                        if (mwin) x1 = fmaf(mwin[at], LOG2E, x1);
                      }
                    }
                    sc[8 * j + e0] = x0;
                    sc[8 * j + e0 + 2] = x1;
                  }
                  const float* t = sc + 8 * j;
                  mx0 = fmaxf(mx0, fmaxf(fmaxf(t[0], t[1]), fmaxf(t[4], t[5])));
                  mx1 = fmaxf(mx1, fmaxf(fmaxf(t[2], t[3]), fmaxf(t[6], t[7])));
                }
              }
#pragma unroll
              for (int d = 1; d <= 2; d <<= 1) {
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
              }
              // finite: every chunk holds a real key, the bias and mask finite
              const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
              const float al0 = fast_exp2(m0 - mn0), al1 = fast_exp2(m1 - mn1);  // 0 first
              l0 *= al0;
              l1 *= al1;
#pragma unroll
              for (int b = 0; b < OB; ++b)
#pragma unroll
                for (int t = 0; t < HB / 8; ++t) {
                  o[b][4 * t] *= al0;
                  o[b][4 * t + 1] *= al0;
                  o[b][4 * t + 2] *= al1;
                  o[b][4 * t + 3] *= al1;
                }
              m0 = mn0;
              m1 = mn1;
              uint32_t pa[NS][4];
              uint32_t plo[kSplitP ? NS : 1][4];
#pragma unroll
              for (int j = 0; j < NS; ++j) {
                float p[8];
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  p[e] = fast_exp2(sc[8 * j + e] - ((e & 2) ? mn1 : mn0));  // 0 at -inf
                  if (e & 2)
                    l1 += p[e];
                  else
                    l0 += p[e];
                }
#pragma unroll
                for (int f = 0; f < 4; ++f) pa[j][f] = pack_bf16(p[2 * f], p[2 * f + 1]);
                if constexpr (kSplitP) {
#pragma unroll
                  for (int f = 0; f < 4; ++f) {
                    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&pa[j][f]);
                    plo[j][f] =
                        pack_bf16(p[2 * f] - __low2float(hi), p[2 * f + 1] - __high2float(hi));
                  }
                }
              }
              hopper::wgmma_fence();
#pragma unroll
              for (int b = 0; b < OB; ++b) {
                const int blk = pass * OB + b;  // past nb: the zero tile, columns never stored
#pragma unroll
                for (int j = 0; j < NS; ++j) {
                  const uint64_t dv = hopper::desc_swizzled<RB>(
                      j < nsub && blk < a.nb ? vd + blk * a.kv_blk + (kl * KC + j * 16) * RB
                                             : zero_tile);
                  hopper::WgmmaRS<HB>::mma(o[b], pa[j], dv, 1);
                  if constexpr (kSplitP) hopper::WgmmaRS<HB>::mma(o[b], plo[j], dv, 1);
                }
              }
              hopper::wgmma_commit();
              hopper::wgmma_wait<0>();
#pragma unroll
              for (int b = 0; b < OB; ++b) hopper::fence_operands(o[b]);
            }
            // the item's last read of its stage: hand it back
            if (ql == a.qi - 1 && pl == a.pi - 1) hopper::mbar_arrive(empty(s));
            if (kg < ord.nkg - 1) continue;
            // ---- epilogue of (unit, query tile, pass): O / l -> staging -> out
            float s0 = l0, s1 = l1;
#pragma unroll
            for (int d = 1; d <= 2; d <<= 1) {
              s0 += __shfl_xor_sync(0xffffffffu, s0, d);
              s1 += __shfl_xor_sync(0xffffffffu, s1, d);
            }
            const float inv0 = 1.f / s0, inv1 = 1.f / s1;
            consumer_barrier(cw);  // the last epilogue's copy-out has read the staging tile
            const int rl0 = wi * 16 + (lane >> 2), rl1 = rl0 + 8;
#pragma unroll
            for (int b = 0; b < OB; ++b)
#pragma unroll
              for (int t = 0; t < HB / 8; ++t) {
                const int col = b * HB + 8 * t + 2 * q4;
                *reinterpret_cast<uint32_t*>(sg + rl0 * SC + col) =
                    pack_bf16(o[b][4 * t] * inv0, o[b][4 * t + 1] * inv0);
                *reinterpret_cast<uint32_t*>(sg + rl1 * SC + col) =
                    pack_bf16(o[b][4 * t + 2] * inv1, o[b][4 * t + 3] * inv1);
              }
            consumer_barrier(cw);
            const int rows = min(QT, a.nq - qt * QT);
            const int c0 = pass * SC;  // the pass's first column
            if (a.pix) {
              const int img = w / a.pix_nwin, wrem = w - img * a.pix_nwin;
              const int wy = wrem / a.pix_nwx, wx = wrem - wy * a.pix_nwx;
              const bool pairs = (a.hd & 1) == 0;  // ld, col0 even: 4-byte pairs
              const int per = pairs ? a.hd >> 1 : a.hd;
              for (int e = ct; e < rows * per; e += 128) {
                const int r = e / per, k = e - r * per;
                const int t = qt * QT + r;
                const int ty = t / a.wsw, tx = t - ty * a.wsw;
                int yy = wy * a.wsh + ty + a.pix_sh, xx = wx * a.wsw + tx + a.pix_sw;
                yy -= yy >= a.pix_hp ? a.pix_hp : 0;
                xx -= xx >= a.pix_wp ? a.pix_wp : 0;
                if (yy >= a.pix_h || xx >= a.pix_w) continue;
                bf16* dst = a.out +
                            ((static_cast<long long>(img) * a.pix_h + yy) * a.pix_w + xx) * a.pix_ld +
                            a.pix_col0 + h * a.hd;
                if (pairs)
                  *reinterpret_cast<uint32_t*>(dst + 2 * k) =
                      *reinterpret_cast<const uint32_t*>(sg + r * SC + 2 * k);
                else
                  dst[k] = sg[r * SC + k];
              }
            } else if (a.tokmajor) {
              // [BW * nq, nh * hdw]: each row's pass columns, 16-byte vectors
              const int vpr = min(SC, hdw - c0) / 8;
              bf16* dst = a.out + (static_cast<long long>(w) * a.nq + qt * QT) * a.nh * hdw +
                          static_cast<long long>(h) * hdw + c0;
              for (int e = ct; e < rows * vpr; e += 128) {
                const int r = e / vpr, vv = e - r * vpr;
                *reinterpret_cast<uint4*>(dst + static_cast<long long>(r) * a.nh * hdw + 8 * vv) =
                    *reinterpret_cast<const uint4*>(sg + r * SC + 8 * vv);
              }
            } else {
              const int ncols = min(SC, a.hd - c0);
              bf16* dst = a.out + (wh * a.nq + qt * QT) * a.hd + c0;
              if (a.vec_out) {
                const int vpr = ncols / 8;
                for (int e = ct; e < rows * vpr; e += 128) {
                  const int r = e / vpr, vv = e - r * vpr;
                  *reinterpret_cast<uint4*>(dst + static_cast<long long>(r) * a.hd + 8 * vv) =
                      *reinterpret_cast<const uint4*>(sg + r * SC + 8 * vv);
                }
              } else {
                for (int e = ct; e < rows * ncols; e += 128) {
                  const int r = e / ncols, c = e - r * ncols;
                  dst[static_cast<long long>(r) * a.hd + c] = sg[r * SC + c];
                }
              }
            }
          }
        }
      }
    }
    it0 += gs * ord.nkg;
  }
}

template <int HB, int OB, int NS, bool kRel, bool kSplitP>
int launch(const Args& a, size_t smem, int grid, cudaStream_t stream) {
  auto kernel = window_attn_stream_kernel<HB, OB, NS, kRel, kSplitP>;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once: the most any launch takes
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HB, int OB, int NS>
int launch_mode(const Args& a, size_t smem, int grid, cudaStream_t s, bool rel, bool split_p) {
  if (rel) return launch<HB, OB, NS, true, false>(a, smem, grid, s);
  return split_p ? launch<HB, OB, NS, false, true>(a, smem, grid, s)
                 : launch<HB, OB, NS, false, false>(a, smem, grid, s);
}

}  // namespace

// The launch plan (kernels/window_attention.py::stream_plan decides it;
// this entry checks it): hb 16, 32 or 64 with nb = ceil(hd / hb) blocks
// (nb 1 below 64 dims), ob 64-dim blocks of O a pass (1, or 2 at hb 64
// with nb > 1), ns 16-key slices a chunk (8, or 4 for a whole unit of at
// most 64 keys), stages,
// whole (one item a unit) or stream (a 64-row query tile, a pass and a
// key chunk an item).  bulk: q is K7's head-split workspace [3, bw, nh,
// nb, nq, hb] (k and v unused); else q, k, v [bw, nh, n, hd].  rel: bias
// is the table [tsize, nh], codes [n_codes, nk] (nq == nk; bulk only),
// their region bits read only where `shifted` (the -100 mask of a shifted
// block; an unshifted block's scores ignore them), the window ws x ws_w
// (ws_w 0: square; table [(2ws-1)(2ws_w-1), nh], position y (2ws_w-1) +
// x); else bias [nh, nq, nk] and mask [n_mask, nq, nk] or null.
// tokmajor: out [bw * nq, nh * nb * hb], else [bw, nh, nq, hd]; pix (K9,
// bulk, rel, one head block): {h, w, hp, wp, sh, sw, ld, col0}, the rows
// to their pixels of out [B, h, w, ld] (see Args).
extern "C" int sr_window_attention_stream_bf16(
    const void* q, const void* k, const void* v, const void* bias, const void* mask,
    const void* codes, void* out, int bw, int nh, int nq, int nk, int hd, int n_mask,
    int n_codes, int ws, int shifted, int split_p, float scale, int per_head, int hb, int ob, int ns,
    int stages, int whole, int bulk, int tokmajor, int ws_w, const int* pix, void* stream) {
  const bool rel = codes != nullptr;
  if (ws_w == 0) ws_w = ws;
  if (nh < 1 || nq < 1 || nk < 1 || hd < 1 || per_head < 1 || (mask && n_mask < 1) ||
      (rel && (mask || !bulk || nq != nk || n_codes < 1 || ws < 1 || split_p)) ||
      (bulk && nq != nk) || stages < 1 || stages > MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (hd + hb - 1) / hb;
  const bool shape_ok = (hb == 16 && hd <= 16) || (hb == 32 && hd > 16 && hd <= 32) ||
                        (hb == 64 && hd > 32);
  if (!shape_ok || !(ob == 1 || (ob == 2 && hb == 64 && nb > 1)) ||
      (ns != 8 && !(ns == 4 && ob == 1 && whole && nk <= 64)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bw == 0) return 0;
  const int kc = 16 * ns, rb = 2 * hb;
  auto a1024 = [](uint32_t b) { return (b + 1023u) & ~1023u; };
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.codes = static_cast<const int*>(codes);
  a.out = static_cast<bf16*>(out);
  a.bw = bw;
  a.nh = nh;
  a.nq = nq;
  a.nk = nk;
  a.hd = hd;
  a.nb = nb;
  a.n_mask = n_mask;
  a.n_codes = n_codes;
  a.shifted = shifted != 0;
  a.tsize = (2 * ws - 1) * (2 * ws_w - 1);
  a.toff = (ws - 1) * (2 * ws_w - 1) + ws_w - 1;
  a.wsh = ws;
  a.wsw = ws_w;
  a.pix = pix != nullptr;
  if (a.pix) {
    if (!rel || tokmajor || nb != 1 || ws < 1 || ws_w < 1 || ws * ws_w != nq)
      return static_cast<int>(cudaErrorInvalidValue);
    a.pix_h = pix[0];
    a.pix_w = pix[1];
    a.pix_hp = pix[2];
    a.pix_wp = pix[3];
    a.pix_sh = pix[4];
    a.pix_sw = pix[5];
    a.pix_ld = pix[6];
    a.pix_col0 = pix[7];
    if (a.pix_hp % ws || a.pix_wp % ws_w || a.pix_h > a.pix_hp || a.pix_w > a.pix_wp ||
        ((hd & 1) == 0 && ((a.pix_ld | a.pix_col0) & 1)))
      return static_cast<int>(cudaErrorInvalidValue);
    a.pix_nwx = a.pix_wp / ws_w;
    a.pix_nwin = (a.pix_hp / ws) * a.pix_nwx;
    if (bw % a.pix_nwin) return static_cast<int>(cudaErrorInvalidValue);
  }
  a.per_head = per_head < bw ? per_head : bw;
  a.stages = stages;
  a.ncons = NCONS;
  a.nqt = (nq + QT - 1) / QT;
  a.passes = (nb + ob - 1) / ob;
  a.nkc = (nk + kc - 1) / kc;
  a.qi = whole ? a.nqt : 1;
  a.pi = whole ? a.passes : 1;
  a.ki = whole ? a.nkc : 1;
  a.bulk = bulk;
  a.tokmajor = tokmajor;
  const bool a16 = aligned_to(q, 16) && (bulk || (aligned_to(k, 16) && aligned_to(v, 16)));
  const bool a4 = aligned_to(q, 4) && (bulk || (aligned_to(k, 4) && aligned_to(v, 4)));
  a.vec = (hd % 8 == 0 && a16) ? 8 : (hd % 2 == 0 && a4) ? 2 : 1;
  if (bulk && !a16) return static_cast<int>(cudaErrorInvalidValue);
  a.vec_out = hd % 8 == 0 && aligned_to(out, 16);
  if (tokmajor && !aligned_to(out, 16)) return static_cast<int>(cudaErrorInvalidValue);
  a.scale_log2 = scale * LOG2E;
  const uint32_t qrows = whole ? a.nqt * QT : QT;
  const uint32_t krows = whole ? a.nkc * kc : kc;  // S reads whole chunks
  a.q_blk = a1024(qrows * rb);
  a.kv_blk = a1024(krows * rb);
  a.codes_off = nb * (a.q_blk + 2 * a.kv_blk);
  const uint32_t code_rows = qrows > static_cast<uint32_t>(a.nkc * kc) ? qrows : a.nkc * kc;
  a.stage_bytes = a.codes_off + (rel ? a1024(code_rows * 4) : 0u);
  a.staging_bytes = NCONS * QT * ob * hb * 2;
  a.table_bytes = rel ? (static_cast<uint32_t>(a.tsize) * 4 + 15u) & ~15u : 0u;
  if (rel && (a.tsize > 65535 || nk > a.tsize)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 1024 + size_t(stages) * a.stage_bytes + 2048 + a.staging_bytes +
                      a.table_bytes + 16 * MAX_STAGES;
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = nh * a.per_head;
  const auto s = static_cast<cudaStream_t>(stream);
  if (ob == 2) return launch_mode<64, 2, 8>(a, smem, grid, s, rel, split_p);
  if (ns == 4) {
    if (hb == 16) return launch_mode<16, 1, 4>(a, smem, grid, s, rel, split_p);
    if (hb == 32) return launch_mode<32, 1, 4>(a, smem, grid, s, rel, split_p);
    return launch_mode<64, 1, 4>(a, smem, grid, s, rel, split_p);
  }
  if (hb == 16) return launch_mode<16, 1, 8>(a, smem, grid, s, rel, split_p);
  if (hb == 32) return launch_mode<32, 1, 8>(a, smem, grid, s, rel, split_p);
  return launch_mode<64, 1, 8>(a, smem, grid, s, rel, split_p);
}
