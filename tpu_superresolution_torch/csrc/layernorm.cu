// K2 — row LayerNorm over the channel axis of a [rows, C] bf16 map.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/layernorm.py
//           pallas_layernorm (_ln_kernel), reached via layernorm_spatial.
// Math: fp32 statistics with the fast variance E[x^2] - E[x]^2 clamped
//       at 0, eps 1e-5, output in bf16 (the input dtype).
// Bound on the H100: memory.  A row is 180 bf16 = 360 bytes and the
//       kernel does ~5 flops per byte, far below the ~295 flop/byte
//       ridge, so the time is the bytes read and written.
// Design: one warp per row, 8 rows per 256-thread block.  Lanes stride
//       the channels so a warp's loads are contiguous; the row's sums are
//       warp shuffles (no shared memory, no block barrier).  The second
//       pass re-reads the row, which the first pass left in L1.  Later
//       work: 16-byte vector loads and more rows per warp.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

__global__ void __launch_bounds__(kRowsPerBlock * 32)
    layernorm_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                          const float* __restrict__ b, bf16* __restrict__ y,
                          long long rows, int c, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= rows) return;
  const bf16* xr = x + row * c;
  bf16* yr = y + row * c;
  float s = 0.f, sq = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float v = __bfloat162float(xr[i]);
    s += v;
    sq += v * v;
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  const float inv_c = 1.f / static_cast<float>(c);
  const float mu = s * inv_c;
  const float var = fmaxf(sq * inv_c - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);
  for (int i = lane; i < c; i += 32) {
    const float v = __bfloat162float(xr[i]);
    yr[i] = __float2bfloat16((v - mu) * rstd * g[i] + b[i]);
  }
}

}  // namespace

extern "C" int sr_layernorm_bf16(const void* x, const void* g, const void* b, void* y,
                                 long long rows, int c, float eps, void* stream) {
  if (rows <= 0) return 0;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layernorm_rows_kernel<<<static_cast<unsigned int>(blocks), kRowsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<bf16*>(y), rows, c, eps);
  return static_cast<int>(cudaGetLastError());
}
