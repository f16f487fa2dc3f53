// WMMA helpers shared by K1's WMMA tail (csrc/swin_tail.cu) and the tiled
// attention core (csrc/window_attn_core.cuh): 16x16x16 bf16 fragments with fp32
// accumulation, 64-row strip GEMMs against weights read straight from
// global memory, and the staged epilogue that hands each lane eight
// consecutive accumulator columns.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;

// acc[mt] = A[MT 16 rows x k_dim] (shared, row-major) @ W[n0:n0+16,
// 0:k_dim]^T (W global, [out, in] row-major with leading dimension ldw),
// over acc's MT 16-row tiles.  Read as a column-major B fragment, each
// thread's k-pairs of W are contiguous 4-byte words.
template <int MT>
__device__ __forceinline__ void gemm_strip_rt(Acc (&acc)[MT], const bf16* a, int lda,
                                              const bf16* w, int ldw, int n0, int k_dim) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) wmma::fill_fragment(acc[mt], 0.f);
  const bf16* wrow = w + static_cast<long long>(n0) * ldw;
  for (int k = 0; k < k_dim; k += 16) {
    FragBt fb;
    wmma::load_matrix_sync(fb, wrow + k, ldw);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      FragA fa;
      wmma::load_matrix_sync(fa, a + mt * 16 * lda + k, lda);
      wmma::mma_sync(acc[mt], fa, fb, acc[mt]);
    }
  }
}

__device__ __forceinline__ void load8(float (&v)[8], const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// dst[0:8] = bf16(v[0:8]) as one 16-byte store.
__device__ __forceinline__ void store8_bf16(bf16* dst, const float (&v)[8]) {
  __align__(16) __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
}

// Hand the accumulators to `fn(row, col, v[8])`, eight consecutive
// columns of one row per lane, through the warp's 16x16 fp32 staging
// tile (the WMMA fragment layout is opaque).
template <int MT, typename Fn>
__device__ __forceinline__ void strip_epilogue(Acc (&acc)[MT], float* stg, int lane, int n0,
                                               Fn fn) {
  const int rr = lane >> 1, cc = (lane & 1) * 8;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    wmma::store_matrix_sync(stg, acc[mt], 16, wmma::mem_row_major);
    __syncwarp();
    float v[8];
    load8(v, stg + rr * 16 + cc);
    fn(mt * 16 + rr, n0 + cc, v);
    __syncwarp();
  }
}

__device__ __forceinline__ float gelu(float u, int tanh_form) {
  if (tanh_form) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * u * (1.f + tanhf(k * (u + 0.044715f * u * u * u)));
  }
  return 0.5f * u * (1.f + erff(u * 0.7071067811865476f));
}

__device__ __forceinline__ void store8_f32(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// LayerNorm of the fp32 rows xs[t][0:c] into bf16 ys[t][0:cpad] (zero
// past c), for ROWS rows: fp32 fast-variance statistics (E[x^2] - E[x]^2
// clamped at 0).  Row t belongs to warp t % NWARPS and column i to lane
// i % 32, the mapping every per-token pass of the kernels uses.
template <int ROWS, int NWARPS>
__device__ __forceinline__ void layernorm_rows(const float* xs, int ldx, bf16* ys, int ldy,
                                               int cpad, const float* g, const float* b, int c,
                                               float eps, int warp, int lane) {
  const float inv_c = 1.f / static_cast<float>(c);
  for (int t = warp; t < ROWS; t += NWARPS) {
    float s = 0.f, sq = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float v = xs[t * ldx + i];
      s += v;
      sq += v * v;
    }
    s = warp_sum(s);
    sq = warp_sum(sq);
    const float mu = s * inv_c;
    const float rstd = rsqrtf(fmaxf(sq * inv_c - mu * mu, 0.f) + eps);
    for (int i = lane; i < cpad; i += 32)
      ys[t * ldy + i] = i < c ? __float2bfloat16((xs[t * ldx + i] - mu) * rstd * g[i] + b[i])
                              : __float2bfloat16(0.f);
  }
}

}  // namespace
