// The window-attention core shared by K7 (csrc/window_attn.cu: qkv,
// attention and proj of a Swin block) and K16 (csrc/batched_attn.cu:
// attention alone on pre-split q, k, v): one head of one 64-query tile,
//
//     O = softmax(scale * Q K^T + rpb + mask) V          (fp32 scores)
//
// over a window of n tokens, any n.  The keys stream in 64-row tiles
// with an online softmax (running max and sum per row, the fp32 output
// rescaled per key tile), so one head's score matrix never has to fit
// in shared memory (256 KB at n = 256).  Pad keys (>= n) get -inf, pad
// query rows are computed on zeros without bias and dropped by the
// caller.  GEMM operands bf16, fp32 accumulation; heads padded to HDP =
// 32 dims with zeros.  The probabilities enter P V rounded to bf16 (K7),
// or with kSplitP as two bf16 parts, P = P_hi + P_lo, in two products
// (K16): ~16 significant bits, so the output matches fp32 probabilities
// (the JAX reference's) to its own final rounding.
#pragma once

#include <mma.h>

#include "common.cuh"
#include "swin_common.cuh"

namespace {

using namespace nvcuda;

namespace wattn {

constexpr int HDP = 32;               // padded head dim
constexpr int T = 64;                 // query / key rows per tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDH = HDP + 8;          // bf16 q, k, v tiles
constexpr int LDS = T + 4;            // fp32 scores
constexpr int LDP = T + 8;            // bf16 probabilities
constexpr int OFF_Q = 0;
constexpr int OFF_K = OFF_Q + T * LDH * 2;
constexpr int OFF_V = OFF_K + T * LDH * 2;
constexpr int OFF_S = OFF_V + T * LDH * 2;
constexpr int OFF_P = OFF_S + T * LDS * 4;
constexpr int OFF_PLO = OFF_P + T * LDP * 2;      // bf16 P_lo (kSplitP)
constexpr int OFF_ACC = OFF_PLO + T * LDP * 2;    // fp32 [64][32] running output
constexpr int OFF_STAT = OFF_ACC + T * HDP * 4;   // fp32 m, l, alpha [64] each
constexpr int OFF_STG = OFF_STAT + 3 * T * 4 + 256;  // (rounded up to 128 bytes)
constexpr int CORE_SMEM = OFF_STG + NWARPS * 256 * 4;  // per-warp 16x16 fp32 staging
static_assert(OFF_K % 128 == 0 && OFF_V % 128 == 0 && OFF_S % 128 == 0 && OFF_P % 128 == 0 &&
                  OFF_PLO % 128 == 0 && OFF_ACC % 128 == 0 && OFF_STAT % 128 == 0 &&
                  OFF_STG % 128 == 0 && CORE_SMEM % 128 == 0,
              "shared buffers must stay 128-byte aligned");

// The calling warp's 16x16 fp32 staging tile of the core's layout.
__device__ __forceinline__ float* staging(unsigned char* smem, int warp) {
  return reinterpret_cast<float*>(smem + OFF_STG) + warp * 256;
}

// One head of the query tile [q0, q0 + 64).  `load(dst, part, t0)` fills
// a [64][LDH] bf16 tile with rows [t0, t0 + 64) of q (part 0), k (1) or
// v (2) of this head, zero past n and past the head's dims; `store(r, d,
// value)` receives O[r][d] / l for r < 64 and d < HDP.  `rp` is the
// head's [n, n] fp32 bias, `mwin` the window's [n, n] fp32 mask or null.
// All threads of the block call it; it ends with a barrier, so the next
// head may reuse every buffer.
template <bool kSplitP, class Load, class Store>
__device__ __forceinline__ void attend_head(unsigned char* smem, int n, int tiles, int q0,
                                            const float* rp, const float* mwin, float scale,
                                            Load load, Store store) {
  bf16* qs = reinterpret_cast<bf16*>(smem + OFF_Q);
  bf16* ks = reinterpret_cast<bf16*>(smem + OFF_K);
  bf16* vs = reinterpret_cast<bf16*>(smem + OFF_V);
  float* ss = reinterpret_cast<float*>(smem + OFF_S);
  bf16* ps = reinterpret_cast<bf16*>(smem + OFF_P);
  bf16* ps_lo = reinterpret_cast<bf16*>(smem + OFF_PLO);
  float* oacc = reinterpret_cast<float*>(smem + OFF_ACC);
  float* row_m = reinterpret_cast<float*>(smem + OFF_STAT);
  float* row_l = row_m + T;
  float* row_a = row_l + T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stg = staging(smem, warp);
  const float neg_inf = -__int_as_float(0x7f800000);

  load(qs, 0, q0);
  for (int i = tid; i < T * HDP; i += NTHREADS) oacc[i] = 0.f;
  if (tid < T) {
    row_m[tid] = neg_inf;
    row_l[tid] = 0.f;
  }
  for (int kt = 0; kt < tiles; ++kt) {
    const int k0 = kt * T;
    load(ks, 1, k0);
    load(vs, 2, k0);
    __syncthreads();
    // S = Q K^T: 16 tiles, 2 a warp
    for (int tile = warp; tile < 16; tile += NWARPS) {
      const int mt = tile >> 2, nt = tile & 3;
      Acc s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int k = 0; k < HDP; k += 16) {
        FragA fa;
        FragBt fb;
        wmma::load_matrix_sync(fa, qs + mt * 16 * LDH + k, LDH);
        wmma::load_matrix_sync(fb, ks + nt * 16 * LDH + k, LDH);
        wmma::mma_sync(s, fa, fb, s);
      }
      wmma::store_matrix_sync(ss + mt * 16 * LDS + nt * 16, s, LDS, wmma::mem_row_major);
    }
    __syncthreads();
    // online softmax over this key tile: eight lanes a row, eight
    // columns a lane; pad keys -inf, pad query rows without bias
    for (int r = warp * 4 + (lane >> 3); r < T; r += NWARPS * 4) {
      const int c0 = (lane & 7) * 8;
      const int qr = q0 + r;
      float v[8];
      load8(v, ss + r * LDS + c0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = k0 + c0 + i;
        if (col >= n) {
          v[i] = neg_inf;
        } else {
          v[i] *= scale;
          if (qr < n) {
            v[i] += rp[static_cast<long long>(qr) * n + col];
            if (mwin) v[i] += mwin[static_cast<long long>(qr) * n + col];
          }
        }
      }
      float mt = v[0];
#pragma unroll
      for (int i = 1; i < 8; ++i) mt = fmaxf(mt, v[i]);
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mt);  // finite: key 0 is real, the mask finite
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = expf(v[i] - m_new);
        sum += v[i];
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      store8_bf16(ps + r * LDP + c0, v);
      if (kSplitP) {
        float lo[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) lo[i] = v[i] - __bfloat162float(__float2bfloat16(v[i]));
        store8_bf16(ps_lo + r * LDP + c0, lo);
      }
      __syncwarp();
      if ((lane & 7) == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();
    // O = alpha O + P V: 8 tiles of 16 x 16, one a warp
    {
      const int mt = warp >> 1, nt = warp & 1;
      Acc o;
      wmma::fill_fragment(o, 0.f);
#pragma unroll
      for (int k = 0; k < T; k += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, ps + mt * 16 * LDP + k, LDP);
        wmma::load_matrix_sync(fb, vs + k * LDH + nt * 16, LDH);
        wmma::mma_sync(o, fa, fb, o);
        if (kSplitP) {
          wmma::load_matrix_sync(fa, ps_lo + mt * 16 * LDP + k, LDP);
          wmma::mma_sync(o, fa, fb, o);
        }
      }
      wmma::store_matrix_sync(stg, o, 16, wmma::mem_row_major);
      __syncwarp();
      const int rr = mt * 16 + (lane >> 1), cc = nt * 16 + (lane & 1) * 8;
      float pv[8];
      load8(pv, stg + (lane >> 1) * 16 + (lane & 1) * 8);
      const float alpha = row_a[rr];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        oacc[rr * HDP + cc + i] = oacc[rr * HDP + cc + i] * alpha + pv[i];
      __syncwarp();
    }
    __syncthreads();
  }
  for (int i = tid; i < T * HDP; i += NTHREADS) {
    const int r = i / HDP, d = i % HDP;
    store(r, d, oacc[i] / row_l[r]);
  }
  __syncthreads();
}

}  // namespace wattn

}  // namespace
