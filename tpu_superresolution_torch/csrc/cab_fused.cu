// K12 — HAT's CAB front in one pass: LayerNorm -> conv3x3 (C -> Cmid)
// -> exact GELU -> conv3x3 (Cmid -> C), NHWC.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/cab_conv.py
//           fused_ln_cab_convs -> _forward -> _kernel (pallas_call at
//           :209); oracle _reference (:153).
// Math: y1 = gelu_erf(conv3x3(LN(x)) + c1), y = conv3x3(y1) + c2, both
//       convs SAME with zero padding: LN's output is zero outside the
//       image, and so is conv2's input (cab_conv.py:143-148).  LN uses
//       fp32 fast-variance statistics (E[x^2] - E[x]^2 clamped at 0);
//       GEMM operands bf16 with fp32 accumulation; y1 rounds to bf16.
//       The SE gate stays outside, as in the JAX package.
// Tiles: one 256-thread block per 8 x 8 output pixels.  The block
//       recomputes the halo: LN on the 12 x 12 input tile, conv1 on the
//       10 x 10 tile, conv2 on the 8 x 8 outputs.  Each tile is a flat
//       array of 12-pixel rows in shared memory, so a conv tap (dy, dx)
//       is the same array shifted by dy*12 + dx rows and every tap's A
//       operand is a plain WMMA tile (an implicit GEMM with no gather);
//       the two columns of each row past the tile's width compute
//       values no valid output reads.  conv1 runs 128 rows (8 WMMA
//       tiles) for 100 used, conv2 96 rows for 64 outputs.  A warp owns
//       one 16-column tile of 64 (conv1) or 48 (conv2) rows.
// Bound on the H100: HAT-SRx4's CAB (C 180 -> 60 -> 180) does 388,800
//       FLOP a pixel against 4 bytes of x in and out: 39.8 GFLOP on the
//       bench batch [25,64,64,180], 0.040 ms at the bf16 peak, vs 73.7
//       MB (0.022 ms): compute-bound; HAT's (96 -> 32 -> 96) 13.5 GFLOP
//       vs 47.0 MB: even.  This first version does ~2x the products (the
//       halo and the flat rows) and reads the weights (2 x 194 KB at C
//       180, more than fits beside a tile) from L2 through the WMMA B
//       fragments.  Two M tiles a warp in conv1 (every warp busy at Cmid
//       32) with the next B fragment fetched ahead measured 5% faster at
//       C 96 and 32% slower at C 180 on the H100 (PERF.md).
#include <mma.h>

#include "common.cuh"
#include "dat_common.cuh"
#include "swin_common.cuh"

using namespace nvcuda;

namespace {

constexpr int MAX_C = 256;
constexpr int MAX_MID = 128;
constexpr int TH = 8, TW = 8;    // output pixels per block
constexpr int FW = TW + 4;       // flat row width of every tile
constexpr int LN_ROWS = 160;     // (TH+4)*FW = 144 used, room for conv1's shifted reads
constexpr int M1 = 128;          // conv1 rows: (TH+2)*FW = 120, padded to 8 WMMA tiles
constexpr int M2 = TH * FW;      // conv2 rows: 96
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
static_assert(M1 + 2 * FW + 2 <= LN_ROWS && M2 + 2 * FW + 2 <= M1,
              "a tap's shifted rows must stay inside the tile below");

struct CabArgs {
  const bf16* x;
  const float* g;
  const float* b;
  const bf16* k1;   // [9 * ck][cmp]: tap-major, row-major K x N
  const float* c1;  // [cmp]
  const bf16* k2;   // [9 * cmp][co]
  const float* c2;  // [co]
  bf16* y;
  int batch, h, w, c, ck, cmp, co;
  float eps;
};

// acc[mt] = sum over the 9 taps of A_tap[16*mt + m0 ..][0:kdim] @ W_tap
// [0:kdim][n0:n0+16], A_tap the shared tile shifted by dy*FW + dx rows
// (leading dimension lda), W global row-major [9*kdim][ldw].
template <int MT>
__device__ __forceinline__ void conv_tiles(Acc (&acc)[MT], const bf16* a, int lda, int m0,
                                           const bf16* w, int ldw, int n0, int kdim) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) wmma::fill_fragment(acc[mt], 0.f);
  for (int tap = 0; tap < 9; ++tap) {
    const int off = (tap / 3) * FW + tap % 3;
    for (int k = 0; k < kdim; k += 16) {
      FragB fb;
      wmma::load_matrix_sync(fb, w + static_cast<long long>(tap * kdim + k) * ldw + n0, ldw);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        FragA fa;
        wmma::load_matrix_sync(fa, a + (m0 + mt * 16 + off) * lda + k, lda);
        wmma::mma_sync(acc[mt], fa, fb, acc[mt]);
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREADS) ln_cab_convs_kernel(const CabArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldl = a.ck + 16, ldy = a.cmp + 16;  // multiples of 16: every row 32-byte aligned
  bf16* ln = reinterpret_cast<bf16*>(smem);
  bf16* y1 = ln + LN_ROWS * ldl;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stg = reinterpret_cast<float*>(y1 + M1 * ldy) + warp * 256;

  const int tiles_w = (a.w + TW - 1) / TW, tiles_h = (a.h + TH - 1) / TH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const int oy0 = ((blockIdx.x / tiles_w) % tiles_h) * TH;
  const long long img = blockIdx.x / (tiles_w * tiles_h);
  const int c = a.c;

  // ---- LN of the 12 x 12 input tile (zero outside the image) ----
  const float inv_c = 1.f / static_cast<float>(c);
  for (int t = warp; t < LN_ROWS; t += NWARPS) {
    bf16* row = ln + t * ldl;
    const int py = oy0 - 2 + t / FW, px = ox0 - 2 + t % FW;
    if (t >= (TH + 4) * FW || py < 0 || py >= a.h || px < 0 || px >= a.w) {
      for (int i = lane; i < a.ck; i += 32) row[i] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* xr = a.x + ((img * a.h + py) * a.w + px) * c;
    float v[MAX_C / 32];
    float s = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_C / 32; ++j) {
      const int i = lane + 32 * j;
      v[j] = i < c ? __bfloat162float(xr[i]) : 0.f;
      s += v[j];
      sq += v[j] * v[j];
    }
    s = warp_sum(s);
    sq = warp_sum(sq);
    const float mu = s * inv_c;
    const float rstd = rsqrtf(fmaxf(sq * inv_c - mu * mu, 0.f) + a.eps);
#pragma unroll
    for (int j = 0; j < MAX_C / 32; ++j) {
      const int i = lane + 32 * j;
      if (i < c) row[i] = __float2bfloat16((v[j] - mu) * rstd * a.g[i] + a.b[i]);
      else if (i < a.ck) row[i] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  // ---- y1 = gelu(conv1(LN) + c1) on the 10 x 10 tile, zero outside the image ----
  {
    constexpr int MT = 4;
    const int units = (a.cmp / 16) * (M1 / 16 / MT);
    for (int u = warp; u < units; u += NWARPS) {
      const int n0 = (u % (a.cmp / 16)) * 16, m0 = (u / (a.cmp / 16)) * MT * 16;
      Acc acc[MT];
      conv_tiles<MT>(acc, ln, ldl, m0, a.k1, a.cmp, n0, a.ck);
      tiles_epilogue<MT>(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
        const int row = m0 + r;
        const int ry = row / FW, rx = row % FW;
        const int py = oy0 - 1 + ry, px = ox0 - 1 + rx;
        const bool inside = ry < TH + 2 && rx < TW + 2 && py >= 0 && py < a.h && px >= 0 &&
                            px < a.w;
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = inside ? gelu(v[i] + a.c1[n + i], 0) : 0.f;
        store8_bf16(y1 + row * ldy + n, v);
      });
    }
  }
  __syncthreads();

  // ---- y = conv2(y1) + c2 on the 8 x 8 outputs ----
  {
    constexpr int MT = 3;
    const int units = (a.co / 16) * (M2 / 16 / MT);
    for (int u = warp; u < units; u += NWARPS) {
      const int n0 = (u % (a.co / 16)) * 16, m0 = (u / (a.co / 16)) * MT * 16;
      Acc acc[MT];
      conv_tiles<MT>(acc, y1, ldy, m0, a.k2, a.co, n0, a.cmp);
      tiles_epilogue<MT>(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
        const int row = m0 + r;
        const int py = oy0 + row / FW, px = ox0 + row % FW;
        if (row % FW >= TW || py >= a.h || px >= a.w) return;
        bf16* yr = a.y + ((img * a.h + py) * a.w + px) * c;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (n + i < c) yr[n + i] = __float2bfloat16(v[i] + a.c2[n + i]);
      });
    }
  }
}

}  // namespace

extern "C" int sr_ln_cab_convs_bf16(const void* x, const void* g, const void* b, const void* k1,
                                    const void* c1, const void* k2, const void* c2, void* y,
                                    int batch, int h, int w, int c, int cmid, float eps,
                                    void* stream) {
  if (c < 1 || c > MAX_C || cmid < 1 || cmid > MAX_MID)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * h * w == 0) return 0;
  CabArgs a;
  a.x = static_cast<const bf16*>(x);
  a.g = static_cast<const float*>(g);
  a.b = static_cast<const float*>(b);
  a.k1 = static_cast<const bf16*>(k1);
  a.c1 = static_cast<const float*>(c1);
  a.k2 = static_cast<const bf16*>(k2);
  a.c2 = static_cast<const float*>(c2);
  a.y = static_cast<bf16*>(y);
  a.batch = batch;
  a.h = h;
  a.w = w;
  a.c = c;
  a.ck = (c + 15) / 16 * 16;
  a.cmp = (cmid + 15) / 16 * 16;
  a.co = a.ck;
  a.eps = eps;
  const int smem = LN_ROWS * (a.ck + 16) * 2 + M1 * (a.cmp + 16) * 2 + NWARPS * 256 * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      ln_cab_convs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(batch) * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  ln_cab_convs_kernel<<<static_cast<unsigned int>(blocks), NTHREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
