// Helpers shared by DAT's block kernels: K9 (csrc/dat_rect.cu), K14
// (csrc/dat_channel.cu) and K10 (csrc/dat_tail.cu).  On top of
// swin_common.cuh's 64-row strip GEMM: the same GEMM and epilogue for
// any number of 16-row tiles, the depthwise 3x3 of DAT's conv branch,
// and a bf16 rounding of fp32 values.
#pragma once

#include <mma.h>

#include "common.cuh"
#include "swin_common.cuh"

using namespace nvcuda;

namespace {

// acc[mt] = A[16*MT x K_DIM] (shared, row-major) @ W[n0:n0+16, 0:K_DIM]^T,
// W global [out, in] with leading dimension K_DIM (gemm_strip for MT
// row tiles).
template <int MT, int K_DIM>
__device__ __forceinline__ void gemm_tiles(Acc (&acc)[MT], const bf16* a, int lda,
                                           const bf16* w, int n0) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) wmma::fill_fragment(acc[mt], 0.f);
  const bf16* wrow = w + static_cast<long long>(n0) * K_DIM;
  for (int k = 0; k < K_DIM; k += 16) {
    FragBt fb;
    wmma::load_matrix_sync(fb, wrow + k, K_DIM);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      FragA fa;
      wmma::load_matrix_sync(fa, a + mt * 16 * lda + k, lda);
      wmma::mma_sync(acc[mt], fa, fb, acc[mt]);
    }
  }
}

// strip_epilogue for MT row tiles: fn(row, col, v[8]) per lane.
template <int MT, typename Fn>
__device__ __forceinline__ void tiles_epilogue(Acc (&acc)[MT], float* stg, int lane, int n0,
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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Depthwise 3x3 with SAME zero padding of the bf16 map v [.., h, w, c]
// at pixel (r, q) of image `img`, channels ch and ch + 1 (ch even):
// fp32 sum over the taps in (dy, dx) order, then the bias; wdw is
// [9][c] fp32, tap-major.
__device__ __forceinline__ float2 dwconv3x3_pair(const bf16* v, int img, int r, int q, int h,
                                                 int w, int c, int ch, const float* wdw,
                                                 const float* bdw) {
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int rr = r + dy - 1;
    if (rr < 0 || rr >= h) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int qq = q + dx - 1;
      if (qq < 0 || qq >= w) continue;
      const long long off = ((static_cast<long long>(img) * h + rr) * w + qq) * c + ch;
      const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(v + off);
      const int tap = dy * 3 + dx;
      a0 += __bfloat162float(t.x) * wdw[tap * c + ch];
      a1 += __bfloat162float(t.y) * wdw[tap * c + ch + 1];
    }
  }
  return make_float2(a0 + bdw[ch], a1 + bdw[ch + 1]);
}

}  // namespace
