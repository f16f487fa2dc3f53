// K8 and K8b at window 16 — HAT's fused OCAB core, forward and backward,
// for 256-query windows against 576 keys (ws 16, overlap window 24:
// upstream HAT-SRx4's OCAB in training).
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_ocab.py
//           fused_ocab_core: _fwd_kernel (pallas_call at :311) and
//           _bwd_kernel (pallas_call at :354), at Nq 256, Nk 576.
// Math: that of csrc/ocab.cu (kernels/fused_ocab.py ocab_core_plain and
//       ocab_core_bwd_plain):
//         A_h  = softmax(q_h k_h^T + bias[h])     (q pre-scaled, fp32)
//         x1   = sw + proj(concat_h bf16(A_h v_h))
//         out  = x1 + fc2(gelu(fc1(LN2(x1))))
//       and its backward, with bf16 GEMM operands, fp32 accumulation and
//       the same casts.  The softmax backward's row term rowsum(dA * A)
//       is taken as rowsum(dO * O) (equal in exact arithmetic).
// Bound on the H100: at the HAT-SRx4 train step (128 windows, C 180, 6
//       heads of 30, hidden 360) the forward does ~24.2 GFLOP against
//       ~88 MB (bandwidth-bound, ~0.026 ms), the backward ~68.4 GFLOP
//       against ~153 MB (~0.069 ms); this first version pads like K8
//       (C -> 192, hd -> 32, hidden -> 384).
// Design: K8's one-CTA-a-window design holds all keys of a window in
//       shared memory; 576 keys of 64-row score tiles do not fit beside
//       the rest, so the keys stream in 64-row tiles:
//       forward: one 256-thread CTA per (window, 64-query tile), 512 at
//          the train step; the tiled attention core (window_attn_core.cuh,
//          online softmax, P rounded to bf16 as K8 does) per head, then
//          K8's proj -> residual -> LN2 -> MLP -> residual on the 64 rows.
//       backward: one 256-thread CTA per window.  Phase A, per query
//          tile: the attention core again (O, and each row's log-sum-exp
//          kept in shared memory), then K8b's tail forward and backward
//          on the 64 rows (dsw, dO -> workspace).  Phase B, per head: Q
//          and dO of all 256 rows in shared memory, dQ in an fp32
//          accumulator; per key tile dK and dV accumulate over the four
//          query tiles in order, P rebuilt from the log-sum-exp, dS =
//          P (dO V^T - D) with D = rowsum(dO * O); dS (fp32) goes to the
//          window's bias-gradient partial, 6 x 256 x 576 floats a window
//          (453 MB at the train step).  Weight gradients by
//          csrc/wgrad.cuh's split-K products and ordered reductions, as
//          K8b: deterministic, no atomics.
#include "common.cuh"
#include "swin_common.cuh"
#include "wgrad.cuh"
#include "window_attn_core.cuh"

namespace {

constexpr int NQ = 256;  // queries of a window (16 x 16)
constexpr int NK = 576;  // keys of its overlap window (24 x 24)
constexpr int T = wattn::T;
constexpr int QTILES = NQ / T;
constexpr int KTILES = NK / T;
constexpr int CP = 192;
constexpr int HDP = wattn::HDP;
constexpr int HIDP = 384;
constexpr int MAX_HEADS = CP / HDP;
constexpr int NWARPS = wattn::NWARPS;
constexpr int NTHREADS = wattn::NTHREADS;

constexpr int LDX = CP;         // fp32
constexpr int LDY = CP + 8;     // bf16
constexpr int LDH = HIDP + 8;   // bf16 hidden
constexpr int LDHD = wattn::LDH;  // bf16 head tiles
constexpr int LDS = T + 4;      // fp32 score tile
constexpr int LDP = T + 8;      // bf16 probability tile

// the attention core's buffers (later the hidden layer), then the tail's
constexpr int OFF_R = wattn::CORE_SMEM;
constexpr int OFF_Y = OFF_R + T * LDX * 4;
constexpr int OFF_O = OFF_Y + T * LDY * 2;
constexpr int OFF_STAT = OFF_O + T * LDY * 2;
constexpr int FWD_SMEM = OFF_STAT;
constexpr int OFF_LSE = OFF_STAT + 2 * T * 4;
constexpr int BWD_SMEM = OFF_LSE + MAX_HEADS * NQ * 4;
// the backward's phase B (over the phase-A buffers before OFF_STAT)
constexpr int OFF_QH = 0;
constexpr int OFF_DOH = OFF_QH + NQ * LDHD * 2;
constexpr int OFF_DQ = OFF_DOH + NQ * LDHD * 2;
constexpr int OFF_KT = OFF_DQ + NQ * HDP * 4;
constexpr int OFF_VT = OFF_KT + T * LDHD * 2;
constexpr int OFF_DK = OFF_VT + T * LDHD * 2;
constexpr int OFF_DV = OFF_DK + T * HDP * 4;
constexpr int OFF_SS = OFF_DV + T * HDP * 4;
constexpr int OFF_PS = OFF_SS + T * LDS * 4;
constexpr int OFF_DR = OFF_PS + T * LDP * 2;
constexpr int OFF_STGB = OFF_DR + NQ * 4;
constexpr int END_B = OFF_STGB + NWARPS * 256 * 4;
static_assert(BWD_SMEM <= 232448, "over the 227 KB shared-memory limit");
static_assert(END_B <= OFF_STAT, "phase B must not overlap the statistics");
static_assert(T * LDH * 2 <= wattn::OFF_STG, "the hidden layer must leave the staging tiles");
static_assert(T * LDX * 4 <= OFF_STAT - OFF_Y, "fp32 dy must fit the two bf16 buffers");
static_assert(OFF_R % 128 == 0 && OFF_Y % 128 == 0 && OFF_O % 128 == 0 && OFF_STAT % 128 == 0 &&
                  OFF_LSE % 128 == 0 && OFF_DOH % 128 == 0 && OFF_DQ % 128 == 0 &&
                  OFF_KT % 128 == 0 && OFF_VT % 128 == 0 && OFF_DK % 128 == 0 &&
                  OFF_DV % 128 == 0 && OFF_SS % 128 == 0 && OFF_PS % 128 == 0 &&
                  OFF_DR % 128 == 0 && OFF_STGB % 128 == 0,
              "shared buffers must stay 128-byte aligned");

// Offsets in a (window, tile) partial-sum row, as csrc/ocab.cu
// (kernels/fused_ocab.py _VEC_OFFSETS).
constexpr int V_G2 = 0, V_B2 = CP, V_BPROJ = 2 * CP, V_BFC1 = 3 * CP, V_BFC2 = 3 * CP + HIDP,
              VEC_LEN = 4 * CP + HIDP;

struct Ocab16Args {
  const bf16* q;   // [windows, NQ, c], pre-scaled
  const bf16* k;   // [windows, NK, c]
  const bf16* v;   // [windows, NK, c]
  const bf16* sw;  // [windows, NQ, c]
  const bf16* ct;  // backward: [windows, NQ, c]
  bf16* out;       // forward: [windows, NQ, c]
  bf16* dq;        // backward outputs, shaped as q, k, v, sw
  bf16* dk;
  bf16* dv;
  bf16* dsw;
  const bf16* wproj;  // [CP, CP], input columns head-padded to HDP
  const float* bproj;
  const float* g2;
  const float* b2;
  const bf16* wfc1;   // [HIDP, CP]
  const float* bfc1;
  const bf16* wfc2;   // [CP, HIDP]
  const float* bfc2;
  const float* bias;  // [nh, NQ, NK]
  // backward workspace, [windows * NQ][cols]
  bf16* g_o;      // CP
  bf16* g_y2c;    // CP
  bf16* g_act;    // HIDP
  bf16* g_dmlp;   // CP
  bf16* g_dh1;    // HIDP
  bf16* g_dattn;  // CP
  bf16* g_do;     // CP
  float* g_x1;    // [windows * T][CP]: one tile's rows per CTA
  float* g_h1;    // [windows * T][HIDP]
  float* part;    // [windows * QTILES][VEC_LEN]
  float* dsp;     // [windows][nh][NQ][NK]
  int c, nh, gelu_tanh;
  float eps;
};

// rows [t0, t0 + rows) of head hh of a [.., c] window tensor -> a
// [rows][LDHD] bf16 tile, zero past hd (rows of hd elements need not be
// aligned)
__device__ __forceinline__ void load_head(bf16* dst, const bf16* src, int c, int hd, int hh,
                                          int t0, int rows, int tid) {
  const bf16 zero = __float2bfloat16(0.f);
  src += static_cast<long long>(t0) * c + hh * hd;
  for (int i = tid; i < rows * HDP; i += NTHREADS) {
    const int r = i / HDP, d = i % HDP;
    dst[r * LDHD + d] = d < hd ? src[static_cast<long long>(r) * c + d] : zero;
  }
}

// The forward's attention, all heads, for query tile q0 of window `win`:
// O -> os (bf16, head-padded columns, zero elsewhere); with `lse`, each
// row's log-sum-exp of head hh -> lse[hh * NQ + q0 + r].
__device__ __forceinline__ void attention_tile(const Ocab16Args& a, unsigned char* smem,
                                               long long win, int q0, bf16* os, float* lse) {
  const int tid = threadIdx.x, hd = a.c / a.nh;
  for (int i = tid; i < T * LDY; i += NTHREADS) os[i] = __float2bfloat16(0.f);
  const float* row_m = reinterpret_cast<const float*>(smem + wattn::OFF_STAT);
  for (int hh = 0; hh < a.nh; ++hh) {
    wattn::attend_head<false>(
        smem, NQ, NK, KTILES, q0, a.bias + static_cast<long long>(hh) * NQ * NK, nullptr, 1.f,
        [&](bf16* dst, int part, int t0) {
          const bf16* src = part == 0 ? a.q + win * NQ * a.c
                                      : (part == 1 ? a.k : a.v) + win * NK * a.c;
          load_head(dst, src, a.c, hd, hh, t0, T, tid);
        },
        [&](int r, int d, float v) { os[r * LDY + hh * HDP + d] = __float2bfloat16(v); });
    // the core's running max and sum of each row, read before the next
    // head's call resets them (by the same thread)
    if (lse && tid < T) lse[hh * NQ + q0 + tid] = row_m[tid] + logf(row_m[T + tid]);
  }
}

// x1 = rs + os @ Wproj^T + bproj (fp32 in rs)
__device__ __forceinline__ void proj_residual(const Ocab16Args& a, float* rs, const bf16* os,
                                              float* stg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Acc acc[4];
  for (int strip = warp; strip < CP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip<CP>(acc, os, LDY, a.wproj, n0);
    strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
      float b[8], x[8];
      load8(b, a.bproj + n);
      load8(x, rs + r * LDX + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] += v[i] + b[i];
      store8_f32(rs + r * LDX + n, x);
    });
  }
}

// rows [r0, r0 + 64) of a [windows, NQ, c] tensor -> fp32 rs (zero pad)
__device__ __forceinline__ void load_rows(float* rs, const bf16* src, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < T; r += NWARPS)
    for (int i = lane; i < CP; i += 32)
      rs[r * LDX + i] = i < c ? __bfloat162float(src[static_cast<long long>(r) * c + i]) : 0.f;
}

__global__ void __launch_bounds__(NTHREADS, 1) ocab16_fwd_kernel(const __grid_constant__ Ocab16Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem + OFF_R);
  bf16* ys = reinterpret_cast<bf16*>(smem + OFF_Y);
  bf16* os = reinterpret_cast<bf16*>(smem + OFF_O);
  bf16* hs = reinterpret_cast<bf16*>(smem);  // over the attention core, after it
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* stg = wattn::staging(smem, warp);
  const long long win = blockIdx.x / QTILES;
  const int q0 = static_cast<int>(blockIdx.x % QTILES) * T;
  const long long r0 = win * NQ + q0;
  const int c = a.c;

  load_rows(rs, a.sw + r0 * c, c);
  attention_tile(a, smem, win, q0, os, nullptr);
  proj_residual(a, rs, os, stg);
  __syncthreads();
  layernorm_rows<T, NWARPS>(rs, LDX, ys, LDY, CP, a.g2, a.b2, c, a.eps, warp, lane);
  __syncthreads();
  Acc acc[4];
  for (int strip = warp; strip < HIDP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip<CP>(acc, ys, LDY, a.wfc1, n0);
    strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
      float b[8];
      load8(b, a.bfc1 + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = gelu(v[i] + b[i], a.gelu_tanh);
      store8_bf16(hs + r * LDH + n, v);
    });
  }
  __syncthreads();
  for (int strip = warp; strip < CP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip<HIDP>(acc, hs, LDH, a.wfc2, n0);
    strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
      float b[8], x[8];
      load8(b, a.bfc2 + n);
      load8(x, rs + r * LDX + n);
      bf16* dst = a.out + (r0 + r) * c;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (n + i < c) dst[n + i] = __float2bfloat16(x[i] + v[i] + b[i]);
    });
  }
}

__global__ void __launch_bounds__(NTHREADS, 1) ocab16_bwd_kernel(const __grid_constant__ Ocab16Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem + OFF_R);
  bf16* ys = reinterpret_cast<bf16*>(smem + OFF_Y);
  bf16* os = reinterpret_cast<bf16*>(smem + OFF_O);
  float* dys = reinterpret_cast<float*>(smem + OFF_Y);  // fp32 over ys + os
  bf16* big = reinterpret_cast<bf16*>(smem);           // dh1, over the attention core
  float* mu2 = reinterpret_cast<float*>(smem + OFF_STAT);
  float* r2 = mu2 + T;
  float* lse = reinterpret_cast<float*>(smem + OFF_LSE);
  bf16* qh = reinterpret_cast<bf16*>(smem + OFF_QH);
  bf16* doh = reinterpret_cast<bf16*>(smem + OFF_DOH);
  float* dqa = reinterpret_cast<float*>(smem + OFF_DQ);
  bf16* kt_s = reinterpret_cast<bf16*>(smem + OFF_KT);
  bf16* vt_s = reinterpret_cast<bf16*>(smem + OFF_VT);
  float* dka = reinterpret_cast<float*>(smem + OFF_DK);
  float* dva = reinterpret_cast<float*>(smem + OFF_DV);
  float* ss = reinterpret_cast<float*>(smem + OFF_SS);
  bf16* ps = reinterpret_cast<bf16*>(smem + OFF_PS);
  float* drow = reinterpret_cast<float*>(smem + OFF_DR);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = a.c, hd = c / a.nh;
  const long long win = blockIdx.x;
  const long long row0 = win * NQ;          // workspace and [.., NQ, c] rows
  const long long srow0 = win * T;          // scratch rows
  Acc acc[4];

  // ================= phase A: tail forward and backward per query tile =====
  for (int t = 0; t < QTILES; ++t) {
    float* stg = wattn::staging(smem, warp);
    float* part = a.part + (win * QTILES + t) * VEC_LEN;
    const long long tr0 = row0 + t * T;
    load_rows(rs, a.sw + tr0 * c, c);
    attention_tile(a, smem, win, t * T, os, lse);
    copy_rows<T, NTHREADS>(os, LDY, a.g_o + tr0 * CP, CP, CP, tid);
    proj_residual(a, rs, os, stg);
    __syncthreads();
    layernorm_rows<T, NWARPS>(rs, LDX, ys, LDY, CP, a.g2, a.b2, c, a.eps, warp, lane, mu2, r2);
    __syncthreads();
    for (int i = tid; i < T * CP / 4; i += NTHREADS) {
      const int r = i / (CP / 4), cv = (i % (CP / 4)) * 4;
      *reinterpret_cast<float4*>(a.g_x1 + (srow0 + r) * CP + cv) =
          *reinterpret_cast<const float4*>(rs + r * LDX + cv);
    }
    copy_rows<T, NTHREADS>(ys, LDY, a.g_y2c + tr0 * CP, CP, CP, tid);
    // h1 = y2c @ Wfc1^T + bfc1 (fp32 scratch), act = bf16(gelu(h1))
    for (int strip = warp; strip < HIDP / 16; strip += NWARPS) {
      const int n0 = strip * 16;
      gemm_strip<CP>(acc, ys, LDY, a.wfc1, n0);
      strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
        float b[8];
        load8(b, a.bfc1 + n);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] += b[i];
        store8_f32(a.g_h1 + (srow0 + r) * HIDP + n, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = gelu(v[i], a.gelu_tanh);
        store8_bf16(a.g_act + (tr0 + r) * HIDP + n, v);
      });
    }
    __syncthreads();
    // ct -> rs (fp32), dmlp = bf16(ct) -> ys, dbfc2 = the fp32 sum of ct
    load_rows(rs, a.ct + tr0 * c, c);
    __syncthreads();
    for (int i = tid; i < T * CP / 8; i += NTHREADS) {
      const int r = i / (CP / 8), cv = (i % (CP / 8)) * 8;
      float v[8];
      load8(v, rs + r * LDX + cv);
      store8_bf16(ys + r * LDY + cv, v);
    }
    for (int j = tid; j < CP; j += NTHREADS) {
      float s = 0.f;
      for (int r = 0; r < T; ++r) s += rs[r * LDX + j];
      part[V_BFC2 + j] = s;
    }
    __syncthreads();
    copy_rows<T, NTHREADS>(ys, LDY, a.g_dmlp + tr0 * CP, CP, CP, tid);
    // dh1 = bf16((dmlp @ Wfc2) * gelu'(h1)) -> big
    for (int strip = warp; strip < HIDP / 16; strip += NWARPS) {
      const int n0 = strip * 16;
      gemm_strip_kn<CP>(acc, ys, LDY, a.wfc2, HIDP, n0);
      strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
        float hv[8];
        load8(hv, a.g_h1 + (srow0 + r) * HIDP + n);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] *= gelu_grad(hv[i], a.gelu_tanh);
        store8_bf16(big + r * LDH + n, v);
        store8_bf16(a.g_dh1 + (tr0 + r) * HIDP + n, v);
      });
    }
    __syncthreads();
    column_sums<T, NTHREADS>(big, LDH, HIDP, part + V_BFC1, tid);
    // dy2 = dh1 @ Wfc1 -> dys (fp32 over ys and os)
    for (int strip = warp; strip < CP / 16; strip += NWARPS) {
      const int n0 = strip * 16;
      gemm_strip_kn<HIDP>(acc, big, LDH, a.wfc1, CP, n0);
      strip_epilogue(acc, stg, lane, n0,
                     [&](int r, int n, float (&v)[8]) { store8_f32(dys + r * LDX + n, v); });
    }
    __syncthreads();
    // dx1 = ct + LN2^T(dy2) in rs; dg2, db2; dsw = dx1
    layernorm_backward_rows<NWARPS, NTHREADS>(
        dys, rs, LDX, a.g2, mu2, r2, [&](int r, int i) { return a.g_x1[(srow0 + r) * CP + i]; },
        T, c, part + V_G2, part + V_B2, tid, warp, lane);
    for (int r = warp; r < T; r += NWARPS) {
      bf16* dst = a.dsw + (tr0 + r) * c;
      for (int i = lane; i < c; i += 32) dst[i] = __float2bfloat16(rs[r * LDX + i]);
    }
    __syncthreads();
    // dbproj = the fp32 sum of dx1; dattn = bf16(dx1) -> ys
    for (int j = tid; j < CP; j += NTHREADS) {
      float s = 0.f;
      for (int r = 0; r < T; ++r) s += rs[r * LDX + j];
      part[V_BPROJ + j] = s;
    }
    for (int i = tid; i < T * CP / 8; i += NTHREADS) {
      const int r = i / (CP / 8), cv = (i % (CP / 8)) * 8;
      float v[8];
      load8(v, rs + r * LDX + cv);
      store8_bf16(ys + r * LDY + cv, v);
    }
    __syncthreads();
    copy_rows<T, NTHREADS>(ys, LDY, a.g_dattn + tr0 * CP, CP, CP, tid);
    // dO = bf16(dattn @ Wproj) -> workspace
    for (int strip = warp; strip < CP / 16; strip += NWARPS) {
      const int n0 = strip * 16;
      gemm_strip_kn<CP>(acc, ys, LDY, a.wproj, CP, n0);
      strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
        store8_bf16(a.g_do + (tr0 + r) * CP + n, v);
      });
    }
    __syncthreads();
  }

  // ================= phase B: attention backward per head =================
  float* stg = reinterpret_cast<float*>(smem + OFF_STGB) + warp * 256;
  auto to_head = [&](const float* src, bf16* dst, int rows) {  // fp32 [rows][32] -> head lanes
    for (int i = tid; i < rows * HDP; i += NTHREADS) {
      const int r = i / HDP, d = i % HDP;
      if (d < hd) dst[static_cast<long long>(r) * c + d] = __float2bfloat16(src[i]);
    }
  };
  for (int hh = 0; hh < a.nh; ++hh) {
    load_head(qh, a.q + row0 * c, c, hd, hh, 0, NQ, tid);
    for (int i = tid; i < NQ * 4; i += NTHREADS) {
      const int r = i >> 2, cv = (i & 3) * 8;
      *reinterpret_cast<uint4*>(doh + r * LDHD + cv) =
          *reinterpret_cast<const uint4*>(a.g_do + (row0 + r) * CP + hh * HDP + cv);
    }
    for (int i = tid; i < NQ * HDP; i += NTHREADS) dqa[i] = 0.f;
    __syncthreads();
    // D = rowsum(dO * O) of the head
    for (int r = warp; r < NQ; r += NWARPS) {
      const float o = __bfloat162float(a.g_o[(row0 + r) * CP + hh * HDP + lane]);
      const float d = warp_sum(__bfloat162float(doh[r * LDHD + lane]) * o);
      if (lane == 0) drow[r] = d;
    }
    const float* bh = a.bias + static_cast<long long>(hh) * NQ * NK;
    const float* lh = lse + hh * NQ;
    float* dsh = a.dsp + (win * a.nh + hh) * NQ * NK;
    for (int kt = 0; kt < KTILES; ++kt) {
      load_head(kt_s, a.k + win * NK * c, c, hd, hh, kt * T, T, tid);
      load_head(vt_s, a.v + win * NK * c, c, hd, hh, kt * T, T, tid);
      for (int i = tid; i < 2 * T * HDP; i += NTHREADS) dka[i] = 0.f;  // dka, dva
      __syncthreads();
      for (int qt = 0; qt < QTILES; ++qt) {
        const bf16* qrows = qh + qt * T * LDHD;
        const bf16* dorows = doh + qt * T * LDHD;
        // S = Q K^T (64 x 64)
        for (int tile = warp; tile < 16; tile += NWARPS) {
          const int mt = tile >> 2, nt = tile & 3;
          Acc s;
          wmma::fill_fragment(s, 0.f);
#pragma unroll
          for (int k = 0; k < HDP; k += 16) {
            FragA fa;
            FragBt fb;
            wmma::load_matrix_sync(fa, qrows + mt * 16 * LDHD + k, LDHD);
            wmma::load_matrix_sync(fb, kt_s + nt * 16 * LDHD + k, LDHD);
            wmma::mma_sync(s, fa, fb, s);
          }
          wmma::store_matrix_sync(ss + mt * 16 * LDS + nt * 16, s, LDS, wmma::mem_row_major);
        }
        __syncthreads();
        // P = exp(S + bias - lse): fp32 in ss, bf16 in ps
        for (int r = warp * 4 + (lane >> 3); r < T; r += NWARPS * 4) {
          const int q = qt * T + r, c0 = (lane & 7) * 8;
          float v[8], b[8];
          load8(v, ss + r * LDS + c0);
          load8(b, bh + static_cast<long long>(q) * NK + kt * T + c0);
          const float l = lh[q];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = expf(v[i] + b[i] - l);
          store8_f32(ss + r * LDS + c0, v);
          store8_bf16(ps + r * LDP + c0, v);
        }
        __syncthreads();
        // dV += P^T dO: 4 key tiles x 2 column tiles, one a warp
        for (int tile = warp; tile < 8; tile += NWARPS) {
          const int mt = tile >> 1, nt = tile & 1;
          Acc d;
          float* dst = dva + mt * 16 * HDP + nt * 16;
          wmma::load_matrix_sync(d, dst, HDP, wmma::mem_row_major);
#pragma unroll
          for (int k = 0; k < T; k += 16) {
            FragAt fa;
            FragB fb;
            wmma::load_matrix_sync(fa, ps + k * LDP + mt * 16, LDP);
            wmma::load_matrix_sync(fb, dorows + k * LDHD + nt * 16, LDHD);
            wmma::mma_sync(d, fa, fb, d);
          }
          wmma::store_matrix_sync(dst, d, HDP, wmma::mem_row_major);
        }
        __syncthreads();
        // dS = P (dO V^T - D): fp32 to the bias-gradient partial, bf16 over P
        for (int tile = warp; tile < 16; tile += NWARPS) {
          const int mt = tile >> 2, nt = tile & 3;
          Acc s;
          wmma::fill_fragment(s, 0.f);
#pragma unroll
          for (int k = 0; k < HDP; k += 16) {
            FragA fa;
            FragBt fb;
            wmma::load_matrix_sync(fa, dorows + mt * 16 * LDHD + k, LDHD);
            wmma::load_matrix_sync(fb, vt_s + nt * 16 * LDHD + k, LDHD);
            wmma::mma_sync(s, fa, fb, s);
          }
          wmma::store_matrix_sync(stg, s, 16, wmma::mem_row_major);
          __syncwarp();
          const int rr = mt * 16 + (lane >> 1), cc = nt * 16 + (lane & 1) * 8;
          float da[8], p[8];
          load8(da, stg + (lane >> 1) * 16 + (lane & 1) * 8);
          load8(p, ss + rr * LDS + cc);
          const float dd = drow[qt * T + rr];
#pragma unroll
          for (int i = 0; i < 8; ++i) da[i] = p[i] * (da[i] - dd);
          store8_f32(dsh + static_cast<long long>(qt * T + rr) * NK + kt * T + cc, da);
          store8_bf16(ps + rr * LDP + cc, da);
          __syncwarp();
        }
        __syncthreads();
        // dQ += dS K (the tile's rows), dK += dS^T Q: the same 4 x 2
        // tiles, one a warp (one tile loop over both fragment kinds
        // crashed cicc 12.9)
        for (int tile = warp; tile < 8; tile += NWARPS) {
          const int mt = tile >> 1, nt = tile & 1;
          Acc d;
          float* dst = dqa + (qt * T + mt * 16) * HDP + nt * 16;
          wmma::load_matrix_sync(d, dst, HDP, wmma::mem_row_major);
          for (int k = 0; k < T; k += 16) {
            FragA fa;
            FragB fb;
            wmma::load_matrix_sync(fa, ps + mt * 16 * LDP + k, LDP);
            wmma::load_matrix_sync(fb, kt_s + k * LDHD + nt * 16, LDHD);
            wmma::mma_sync(d, fa, fb, d);
          }
          wmma::store_matrix_sync(dst, d, HDP, wmma::mem_row_major);
          Acc e;
          float* dst2 = dka + mt * 16 * HDP + nt * 16;
          wmma::load_matrix_sync(e, dst2, HDP, wmma::mem_row_major);
          for (int k = 0; k < T; k += 16) {
            FragAt fa;
            FragB fb;
            wmma::load_matrix_sync(fa, ps + k * LDP + mt * 16, LDP);
            wmma::load_matrix_sync(fb, qrows + k * LDHD + nt * 16, LDHD);
            wmma::mma_sync(e, fa, fb, e);
          }
          wmma::store_matrix_sync(dst2, e, HDP, wmma::mem_row_major);
        }
        __syncthreads();
      }
      const long long kr0 = (win * NK + kt * T) * c + hh * hd;
      to_head(dka, a.dk + kr0, T);
      to_head(dva, a.dv + kr0, T);
      __syncthreads();
    }
    to_head(dqa, a.dq + row0 * c + hh * hd, NQ);
    __syncthreads();
  }
}

}  // namespace

static Ocab16Args ocab16_args(const void* q, const void* k, const void* v, const void* sw,
                              const void* wproj, const void* bproj, const void* g2,
                              const void* b2, const void* wfc1, const void* bfc1,
                              const void* wfc2, const void* bfc2, const void* bias, int c, int nh,
                              int gelu_tanh, float eps) {
  Ocab16Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.sw = static_cast<const bf16*>(sw);
  a.wproj = static_cast<const bf16*>(wproj);
  a.bproj = static_cast<const float*>(bproj);
  a.g2 = static_cast<const float*>(g2);
  a.b2 = static_cast<const float*>(b2);
  a.wfc1 = static_cast<const bf16*>(wfc1);
  a.bfc1 = static_cast<const float*>(bfc1);
  a.wfc2 = static_cast<const bf16*>(wfc2);
  a.bfc2 = static_cast<const float*>(bfc2);
  a.bias = static_cast<const float*>(bias);
  a.c = c;
  a.nh = nh;
  a.gelu_tanh = gelu_tanh;
  a.eps = eps;
  return a;
}

static bool ocab16_widths_ok(int c, int nh) {
  return c >= 1 && c <= CP && nh >= 1 && nh <= MAX_HEADS && c % nh == 0 && c / nh <= HDP;
}

extern "C" int sr_ocab16_fwd_bf16(const void* q, const void* k, const void* v, const void* sw,
                                  void* out, const void* wproj, const void* bproj, const void* g2,
                                  const void* b2, const void* wfc1, const void* bfc1,
                                  const void* wfc2, const void* bfc2, const void* bias,
                                  int windows, int c, int nh, int gelu_tanh, float eps,
                                  void* stream) {
  if (!ocab16_widths_ok(c, nh)) return static_cast<int>(cudaErrorInvalidValue);
  if (windows == 0) return 0;
  Ocab16Args a = ocab16_args(q, k, v, sw, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2, bias, c,
                             nh, gelu_tanh, eps);
  a.out = static_cast<bf16*>(out);
  const cudaError_t err = cudaFuncSetAttribute(
      ocab16_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  ocab16_fwd_kernel<<<static_cast<unsigned int>(windows) * QTILES, NTHREADS, FWD_SMEM,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sr_ocab16_bwd_bf16(const void* ct, const void* q, const void* k, const void* v,
                                  const void* sw, void* dq, void* dk, void* dv, void* dsw,
                                  const void* wproj, const void* bproj, const void* g2,
                                  const void* b2, const void* wfc1, const void* bfc1,
                                  const void* wfc2, const void* bfc2, const void* bias,
                                  void* ws16, void* ws32, void* part_win, void* dsp, void* part_w,
                                  void* vec, void* dbias, void* wgrad, int windows, int c, int nh,
                                  int gelu_tanh, float eps, int splits, int rows, void* stream) {
  if (!ocab16_widths_ok(c, nh)) return static_cast<int>(cudaErrorInvalidValue);
  if (windows == 0) return 0;
  const long long tokens = static_cast<long long>(windows) * NQ;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Ocab16Args a = ocab16_args(q, k, v, sw, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2, bias, c,
                             nh, gelu_tanh, eps);
  a.ct = static_cast<const bf16*>(ct);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dsw = static_cast<bf16*>(dsw);
  // bf16 workspace segments in the order of kernels/fused_ocab.py
  // K8W16_BF16_COLS: o, y2c, act, dmlp, dh1, dattn, do; fp32: the x1 and
  // h1 scratch rows
  bf16* p16 = static_cast<bf16*>(ws16);
  bf16** segs16[] = {&a.g_o, &a.g_y2c, &a.g_act, &a.g_dmlp, &a.g_dh1, &a.g_dattn, &a.g_do};
  const int cols16[] = {CP, CP, HIDP, CP, HIDP, CP, CP};
  for (int i = 0; i < 7; ++i) {
    *segs16[i] = p16;
    p16 += tokens * cols16[i];
  }
  a.g_x1 = static_cast<float*>(ws32);
  a.g_h1 = a.g_x1 + static_cast<long long>(windows) * T * CP;
  a.part = static_cast<float*>(part_win);
  a.dsp = static_cast<float*>(dsp);
  cudaError_t err = cudaFuncSetAttribute(
      ocab16_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  ocab16_bwd_kernel<<<static_cast<unsigned int>(windows), NTHREADS, BWD_SMEM, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const bf16* gs[] = {a.g_dattn, a.g_dh1, a.g_dmlp};
  const bf16* acts[] = {a.g_o, a.g_y2c, a.g_act};
  const int ms[] = {CP, HIDP, CP};
  const int ns[] = {CP, CP, HIDP};
  int status = weight_grads(gs, acts, ms, ns, 3, tokens, splits, rows,
                            static_cast<float*>(part_w), static_cast<float*>(wgrad), st);
  if (status != 0) return status;
  status = reduce_rows(static_cast<const float*>(part_win),
                       static_cast<long long>(windows) * QTILES, VEC_LEN,
                       static_cast<float*>(vec), st);
  if (status != 0) return status;
  return reduce_rows(static_cast<const float*>(dsp), windows,
                     static_cast<long long>(nh) * NQ * NK, static_cast<float*>(dbias), st);
}
