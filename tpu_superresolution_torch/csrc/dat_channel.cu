// K14 — the front half of DAT's channel block: LN1 -> qkv -> XCiT
// channel attention over all tokens of an image, and the conv branch.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_channel_attn.py
//           fused_channel_attention -> _kernel (pallas_call at :209).
// Math (dat_arch.py:441-509 up to the AIM gating), per image of T = H*W
//       tokens and per head h of hd channels:
//         y = LN1(x) (fp32 fast-variance statistics, eps 1e-5), bf16
//         q, k, v = y Wqkv + bqkv, bf16
//         G_h[d, e] = sum_t q[t, d] k[t, e] (fp32), |q_d|^2 = sum_t q^2
//         A_h = softmax_e(t_h G_h[d, e] / (max(|q_d|, 1e-12) max(|k_e|, 1e-12)))
//         attened_x[t, h*hd + d] = sum_e bf16(A_h[d, e]) v[t, h*hd + e]
//         conv_x = erf-GELU(dwconv3x3(v) + b), BatchNorm folded
// Launches (the TPU kernel's two grid phases; blocks run in no order
//       here, so the sum over tokens is a separate pass):
//       (1) chan_qkv_kernel, one 256-thread block per strip of 256
//           tokens of an image, four sub-tiles of 64: LN1, q|k|v =
//           [64 x 192] x [192 x 576] (heads padded to 32 columns, so head
//           h's columns start at h*32), v written out, and the strip's
//           block-diagonal gram (6 blocks of 32 x 32, WMMA q_h^T k_h
//           accumulated in registers over the sub-tiles) and squared
//           norms of q and k written as partial sums;
//       (2) chan_softmax_kernel, one 1024-thread block per (image, head):
//           the partials summed in strip order (deterministic, no
//           atomics), normalised, times the temperature, softmax over e
//           with one warp per row d, rounded to bf16;
//       (3) chan_apply_kernel, one block per 64 tokens: out = v A^T
//           (WMMA per head, bf16 A, fp32 accumulation) and the conv
//           branch on the same v.
// v is kept from (1) and not recomputed: the conv branch needs it, and
//       re-reading costs one [T, C] bf16 pass against LN1 and a product.
// Bound on the H100 at [25,64,64,180]: ~0.31 MFLOP per token (qkv
//       194,400, gram and v A^T 2 x 2 x 180 x 30, the conv) against
//       ~111 MB for x, attened_x and conv_x plus v written and read:
//       compute-bound in principle; this first version runs (1) at one
//       WMMA warp per 16-column strip and round-trips v (~37 MB).
#include <mma.h>

#include "common.cuh"
#include "dat_common.cuh"
#include "swin_common.cuh"

using namespace nvcuda;

namespace {

constexpr int CP = 192;           // padded channels: 6 heads x 32
constexpr int HDP = 32;
constexpr int NH_MAX = CP / HDP;  // 6
constexpr int QKV = 3 * CP;       // 576
constexpr int TS = 64;            // tokens per sub-tile
constexpr int SUB = 4;            // sub-tiles per strip
constexpr int STRIP = TS * SUB;   // 256 tokens
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int GRAM = HDP * HDP;   // one head's block

constexpr int LDY = CP + 8;       // bf16
constexpr int LDQ = QKV + 8;      // bf16
constexpr int OFF_Y = 0;
constexpr int OFF_QKV = OFF_Y + TS * LDY * 2;
constexpr int OFF_STG = OFF_QKV + TS * LDQ * 2;
constexpr int SMEM_BYTES = OFF_STG + NWARPS * 256 * 4;
static_assert(SMEM_BYTES <= 232448, "over the 227 KB shared-memory limit");
static_assert(OFF_QKV % 128 == 0 && OFF_STG % 128 == 0, "128-byte aligned buffers");
static_assert((NH_MAX * 4) % NWARPS == 0, "gram tiles per warp");

struct ChanArgs {
  const bf16* x;
  bf16* v;
  const float* g1;
  const float* b1;
  const bf16* wqkv;   // [QKV][CP] [out, in], head-padded
  const float* bqkv;  // [QKV]
  float* part_gram;   // [B][strips][NH_MAX][32][32]
  float* part_sq;     // [B][strips][2][CP]
  int batch, tokens, c, nh, hd, strips;
  float eps;
};

__global__ void __launch_bounds__(NTHREADS) chan_qkv_kernel(const ChanArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem + OFF_Y);
  bf16* qkv = reinterpret_cast<bf16*>(smem + OFF_QKV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stg = reinterpret_cast<float*>(smem + OFF_STG) + warp * 256;
  const int strip = blockIdx.x % a.strips;
  const int img = blockIdx.x / a.strips;
  const int c = a.c;
  const float inv_c = 1.f / static_cast<float>(c);

  constexpr int GT = NH_MAX * 4 / NWARPS;  // gram tiles per warp (3)
  Acc g[GT];
#pragma unroll
  for (int j = 0; j < GT; ++j) wmma::fill_fragment(g[j], 0.f);
  float sq0 = 0.f, sq1 = 0.f;  // squared norms of columns tid and tid + 256 of q|k

  for (int sub = 0; sub < SUB; ++sub) {
    const int t0 = strip * STRIP + sub * TS;
    // ---- LN1 rows (tokens past the image: zero) ----
    for (int t = warp; t < TS; t += NWARPS) {
      bf16* yr = ys + t * LDY;
      if (t0 + t >= a.tokens) {
        for (int i = lane; i < CP; i += 32) yr[i] = __float2bfloat16(0.f);
        continue;
      }
      const bf16* xr = a.x + (static_cast<long long>(img) * a.tokens + t0 + t) * c;
      float xv[CP / 32];
      float s = 0.f, sq = 0.f;
#pragma unroll
      for (int k = 0; k < CP / 32; ++k) {
        const int i = lane + 32 * k;
        const float v = i < c ? __bfloat162float(xr[i]) : 0.f;
        xv[k] = v;
        s += v;
        sq += v * v;
      }
      s = warp_sum(s);
      sq = warp_sum(sq);
      const float mu = s * inv_c;
      const float rstd = rsqrtf(fmaxf(sq * inv_c - mu * mu, 0.f) + a.eps);
#pragma unroll
      for (int k = 0; k < CP / 32; ++k) {
        const int i = lane + 32 * k;
        yr[i] = __float2bfloat16(i < c ? (xv[k] - mu) * rstd * a.g1[i] + a.b1[i] : 0.f);
      }
    }
    __syncthreads();
    // ---- q|k|v = y W + b -> bf16 [64][576]; rows past the image 0 ----
    {
      Acc acc[4];
      for (int strip16 = warp; strip16 < QKV / 16; strip16 += NWARPS) {
        const int n0 = strip16 * 16;
        gemm_strip<CP>(acc, ys, LDY, a.wqkv, n0);
        strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
          float b[8];
          load8(b, a.bqkv + n);
          const bool pad = t0 + r >= a.tokens;
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = pad ? 0.f : v[i] + b[i];
          store8_bf16(qkv + r * LDQ + n, v);
        });
      }
    }
    __syncthreads();
    // ---- v out; gram blocks q_h^T k_h; squared norms ----
    for (int t = warp; t < TS; t += NWARPS) {
      if (t0 + t >= a.tokens) continue;
      bf16* vr = a.v + (static_cast<long long>(img) * a.tokens + t0 + t) * c;
      for (int i = lane; i < c; i += 32)
        vr[i] = qkv[t * LDQ + 2 * CP + (i / a.hd) * HDP + i % a.hd];
    }
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      const int tile = warp + NWARPS * j;  // head, 16-row block, 16-column block
      const int hh = tile >> 2, mt = (tile >> 1) & 1, nt = tile & 1;
#pragma unroll
      for (int k = 0; k < TS; k += 16) {
        FragAt fa;  // (d, t) = q[t][hh*32 + d]: column-major q_h^T
        FragB fb;   // (t, e) = k[t][hh*32 + e]
        wmma::load_matrix_sync(fa, qkv + k * LDQ + hh * HDP + mt * 16, LDQ);
        wmma::load_matrix_sync(fb, qkv + k * LDQ + CP + hh * HDP + nt * 16, LDQ);
        wmma::mma_sync(g[j], fa, fb, g[j]);
      }
    }
    for (int t = 0; t < TS; ++t) {
      const float v0 = __bfloat162float(qkv[t * LDQ + tid]);
      sq0 += v0 * v0;
      if (tid + NTHREADS < 2 * CP) {
        const float v1 = __bfloat162float(qkv[t * LDQ + tid + NTHREADS]);
        sq1 += v1 * v1;
      }
    }
    __syncthreads();
  }
  // ---- the strip's partial sums ----
  const long long part = static_cast<long long>(img) * a.strips + strip;
#pragma unroll
  for (int j = 0; j < GT; ++j) {
    const int tile = warp + NWARPS * j;
    const int hh = tile >> 2, mt = (tile >> 1) & 1, nt = tile & 1;
    wmma::store_matrix_sync(a.part_gram + (part * NH_MAX + hh) * GRAM + mt * 16 * HDP + nt * 16,
                            g[j], HDP, wmma::mem_row_major);
  }
  a.part_sq[part * 2 * CP + tid] = sq0;
  if (tid + NTHREADS < 2 * CP) a.part_sq[part * 2 * CP + tid + NTHREADS] = sq1;
}

// A[img][h] = bf16(softmax_e(t_h G[d, e] / (|q_d| |k_e|))), rows and
// columns past hd zero.  Thread (d = warp, e = lane).
__global__ void __launch_bounds__(1024) chan_softmax_kernel(const float* part_gram,
                                                            const float* part_sq,
                                                            const float* temperature, float* attn,
                                                            int strips, int nh, int hd) {
  const int img = blockIdx.x / nh, hh = blockIdx.x % nh;
  const int d = threadIdx.x >> 5, e = threadIdx.x & 31;
  float gs = 0.f, qq = 0.f, kk = 0.f;
  for (int s = 0; s < strips; ++s) {
    const long long part = static_cast<long long>(img) * strips + s;
    gs += part_gram[(part * NH_MAX + hh) * GRAM + d * HDP + e];
    qq += part_sq[part * 2 * CP + hh * HDP + d];
    kk += part_sq[part * 2 * CP + CP + hh * HDP + e];
  }
  float* out = attn + (static_cast<long long>(img) * NH_MAX + hh) * GRAM + d * HDP + e;
  if (d >= hd) {
    *out = 0.f;
    return;
  }
  const float qn = fmaxf(sqrtf(qq), 1e-12f), kn = fmaxf(sqrtf(kk), 1e-12f);
  const float sc = e < hd ? gs / (qn * kn) * temperature[hh] : -__int_as_float(0x7f800000);
  const float m = warp_max(sc);
  const float ex = e < hd ? expf(sc - m) : 0.f;
  const float sum = warp_sum(ex);
  *out = round_bf16(ex / sum);
}

// attened_x = v A^T and conv_x = erf-GELU(dwconv3x3(v)), one 256-thread
// block per tile of 64 tokens: the tile's v (head-padded to 32 columns)
// and the image's A (bf16 values) go to shared memory, each head's
// [64 x 32] x [32 x 32] product is WMMA with fp32 accumulation, and the
// conv branch reads v's 3x3 neighbourhood from global memory.
constexpr int LDV = CP + 8;       // bf16 v tile
constexpr int LDA_T = HDP + 8;    // bf16 A rows
constexpr int AP_OFF_V = 0;
constexpr int AP_OFF_A = AP_OFF_V + TS * LDV * 2;
constexpr int AP_OFF_STG = AP_OFF_A + NH_MAX * HDP * LDA_T * 2;
constexpr int AP_SMEM = AP_OFF_STG + NWARPS * 256 * 4;
static_assert(AP_OFF_A % 128 == 0 && AP_OFF_STG % 128 == 0, "128-byte aligned buffers");
static_assert(AP_SMEM <= 48 * 1024, "static shared memory");

__global__ void __launch_bounds__(NTHREADS) chan_apply_kernel(
    const bf16* v, const float* attn, bf16* out, bf16* conv, const float* wdw, const float* bdw,
    int h, int w, int c, int nh, int hd) {
  __shared__ __align__(128) unsigned char smem[AP_SMEM];
  bf16* vs = reinterpret_cast<bf16*>(smem + AP_OFF_V);
  bf16* as = reinterpret_cast<bf16*>(smem + AP_OFF_A);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stg = reinterpret_cast<float*>(smem + AP_OFF_STG) + warp * 256;
  const int tokens = h * w;
  const int tiles = (tokens + TS - 1) / TS;
  const int img = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * TS;
  const bf16* vimg = v + static_cast<long long>(img) * tokens * c;

  for (int i = tid; i < TS * CP; i += NTHREADS) {
    const int t = i / CP, col = i % CP, hh = col / HDP, e = col % HDP;
    vs[t * LDV + col] = (t0 + t < tokens && hh < nh && e < hd)
                            ? vimg[static_cast<long long>(t0 + t) * c + hh * hd + e]
                            : __float2bfloat16(0.f);
  }
  const float* aimg = attn + static_cast<long long>(img) * NH_MAX * GRAM;
  for (int i = tid; i < NH_MAX * GRAM; i += NTHREADS)
    as[(i / HDP) * LDA_T + i % HDP] = __float2bfloat16(aimg[i]);
  __syncthreads();

  // out_h = V_h A_h^T: B(e, d) = A_h[d][e], a column-major read of A_h
  for (int tile = warp; tile < nh * 8; tile += NWARPS) {
    const int hh = tile >> 3, mt = (tile >> 1) & 3, nt = tile & 1;
    Acc o;
    wmma::fill_fragment(o, 0.f);
#pragma unroll
    for (int k = 0; k < HDP; k += 16) {
      FragA fa;
      FragBt fb;
      wmma::load_matrix_sync(fa, vs + mt * 16 * LDV + hh * HDP + k, LDV);
      wmma::load_matrix_sync(fb, as + (hh * HDP + nt * 16) * LDA_T + k, LDA_T);
      wmma::mma_sync(o, fa, fb, o);
    }
    wmma::store_matrix_sync(stg, o, 16, wmma::mem_row_major);
    __syncwarp();
    const int rr = lane >> 1, cc = (lane & 1) * 8;
    const int t = t0 + mt * 16 + rr;
    if (t < tokens) {
      bf16* orow = out + (static_cast<long long>(img) * tokens + t) * c + hh * hd;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = nt * 16 + cc + i;
        if (d < hd) orow[d] = __float2bfloat16(stg[rr * 16 + cc + i]);
      }
    }
    __syncwarp();
  }

  const int c2 = c / 2;
  for (int i = tid; i < TS * c2; i += NTHREADS) {
    const int t = t0 + i / c2, ch = (i % c2) * 2;
    if (t >= tokens) continue;
    const float2 s = dwconv3x3_pair(v, img, t / w, t % w, h, w, c, ch, wdw, bdw);
    *reinterpret_cast<__nv_bfloat162*>(conv + (static_cast<long long>(img) * tokens + t) * c +
                                       ch) = __floats2bfloat162_rn(gelu(s.x, 0), gelu(s.y, 0));
  }
}

}  // namespace

extern "C" int sr_dat_channel_bf16(const void* x, void* out, void* v, void* conv, const void* g1,
                                   const void* b1, const void* wqkv, const void* bqkv,
                                   const void* temperature, const void* wdw, const void* bdw,
                                   void* part_gram, void* part_sq, void* attn, int batch, int h,
                                   int w, int c, int nh, int strips, float eps, void* stream) {
  const int hd = nh > 0 ? c / nh : 0;
  if (c > CP || (c & 1) || nh < 1 || nh > NH_MAX || hd * nh != c || hd > HDP)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tokens = static_cast<long long>(h) * w;
  if (batch == 0 || tokens == 0) return 0;
  if (strips != (tokens + STRIP - 1) / STRIP) return static_cast<int>(cudaErrorInvalidValue);
  ChanArgs a;
  a.x = static_cast<const bf16*>(x);
  a.v = static_cast<bf16*>(v);
  a.g1 = static_cast<const float*>(g1);
  a.b1 = static_cast<const float*>(b1);
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.bqkv = static_cast<const float*>(bqkv);
  a.part_gram = static_cast<float*>(part_gram);
  a.part_sq = static_cast<float*>(part_sq);
  a.batch = batch;
  a.tokens = static_cast<int>(tokens);
  a.c = c;
  a.nh = nh;
  a.hd = hd;
  a.strips = strips;
  a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      chan_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  chan_qkv_kernel<<<static_cast<unsigned int>(batch) * strips, NTHREADS, SMEM_BYTES, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chan_softmax_kernel<<<static_cast<unsigned int>(batch) * nh, 1024, 0, s>>>(
      a.part_gram, a.part_sq, static_cast<const float*>(temperature), static_cast<float*>(attn),
      strips, nh, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (tokens + TS - 1) / TS;
  chan_apply_kernel<<<static_cast<unsigned int>(batch * tiles), NTHREADS, 0, s>>>(
      a.v, static_cast<const float*>(attn), static_cast<bf16*>(out), static_cast<bf16*>(conv),
      static_cast<const float*>(wdw), static_cast<const float*>(bdw), h, w, c, nh, hd);
  return static_cast<int>(cudaGetLastError());
}
