// K10 — the tail of a DAT block: AIM gating -> proj -> residual -> LN2
// -> SGFN -> residual, for both block types.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_datb_tail.py
//           fused_datb_tail -> _kernel (pallas_call at :374).
// Math (dat_arch.py:420-437, :510-527, :38-90, :559-562), per pixel, with
//       u the channel-gated tensor that also feeds the spatial map and
//       w_px the pixel-gated one (spatial block: u = attened_x, w_px =
//       conv_x; channel block: u = conv_x, w_px = attened_x):
//         m  = sigmoid(w2 . bf16(erf-GELU(W1 u + b1)) + b2)  (BN folded in W1)
//         sg = bf16(u * gate + w_px * m)            gate [B, C], sigmoid applied
//         x2 = x + sg Wproj + bproj                 (fp32)
//         h  = erf-GELU(bf16(LN2(x2)) Wfc1 + bfc1)  (fp32); h1, h2 = halves
//         h2 = bf16(LN_sg(h2));  d = dwconv3x3(h2) + bdw (SAME zero pad)
//         out = x2 + bf16(h1 * d) Wfc2 + bfc2
//       LayerNorms: fp32 fast-variance statistics, eps 1e-5; GEMMs bf16
//       operands with fp32 accumulation.
// Tiles: one 256-thread block per 4 x 8 output pixels.  The depthwise
//       conv needs h2 on a one-pixel halo, so the block recomputes the
//       chain up to LN_sg on the 6 x 10 halo pixels (60 of 64 GEMM rows)
//       from neighbour reads of x, u and w_px; halo pixels outside the
//       image are the conv's zero padding and are skipped as taps.
//       Nothing but the output is written: no intermediate leaves the SM.
// Bound on the H100 at [25,64,64,180]: ~0.26 MFLOP per pixel (spatial
//       map, proj, fc1, fc2) against ~147 MB (x, u, w_px read, out
//       written): compute-bound in principle.  This first version does
//       the proj and fc1 products 2x over (the 60-row halo for 32 pixels)
//       and holds one block per SM (~191 KB of shared memory: x2 fp32
//       [64][192], h fp32 [64][388], a bf16 operand [64][200], the fc2
//       operand [32][200]).
#include <mma.h>

#include "common.cuh"
#include "dat_common.cuh"
#include "swin_common.cuh"

using namespace nvcuda;

namespace {

constexpr int CP = 192;           // padded channels and SGFN half
constexpr int SPP = 16;           // padded spatial-map width
constexpr int HID = 2 * CP;       // fc1 rows: h1 at 0, h2 at CP
constexpr int TH = 4, TW = 8;     // output pixels per block
constexpr int HH = TH + 2, HW = TW + 2;
constexpr int NHALO = HH * HW;    // 60
constexpr int R = 64;             // GEMM rows (the halo tile, padded)
constexpr int NI = TH * TW;       // 32 output pixels
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
static_assert(NHALO <= R, "the halo tile must fit the 64 GEMM rows");

constexpr int LDX = CP;           // fp32 x2
constexpr int LDH = HID + 4;      // fp32 h
constexpr int LDA = CP + 8;       // bf16 operands
constexpr int OFF_X = 0;
constexpr int OFF_H = OFF_X + R * LDX * 4;
constexpr int OFF_A = OFF_H + R * LDH * 4;
constexpr int OFF_G = OFF_A + R * LDA * 2;
constexpr int OFF_STG = OFF_G + NI * LDA * 2;
constexpr int OFF_MISC = OFF_STG + NWARPS * 256 * 4;
constexpr int SMEM_BYTES = OFF_MISC + 2 * R * 4;
static_assert(SMEM_BYTES <= 232448, "over the 227 KB shared-memory limit");
static_assert(OFF_H % 128 == 0 && OFF_A % 128 == 0 && OFF_G % 128 == 0 &&
                  OFF_STG % 128 == 0 && OFF_MISC % 128 == 0,
              "shared buffers must stay 128-byte aligned");

struct TailArgs {
  const bf16* x;
  const bf16* u;
  const bf16* wpx;
  const float* gate;   // [B, C]
  bf16* out;
  const bf16* sp_w1;   // [SPP][CP]
  const float* sp_b1;  // [SPP]
  const float* sp_w2;  // [SPP]
  const float* sp_b2;  // [1]
  const bf16* wproj;   // [CP][CP]
  const float* bproj;  // [CP]
  const float* g2;
  const float* b2;
  const bf16* wfc1;    // [HID][CP]
  const float* bfc1;   // [HID]
  const float* gsg;
  const float* bsg;
  const float* wdw;    // [9][half]
  const float* bdw;    // [half]
  const bf16* wfc2;    // [CP][CP]
  const float* bfc2;   // [CP]
  int batch, h, w, c, half;
  float eps;
};

__global__ void __launch_bounds__(NTHREADS, 1) datb_tail_kernel(const TailArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + OFF_X);
  float* hs = reinterpret_cast<float*>(smem + OFF_H);
  bf16* as = reinterpret_cast<bf16*>(smem + OFF_A);
  bf16* gs = reinterpret_cast<bf16*>(smem + OFF_G);
  int* pix = reinterpret_cast<int*>(smem + OFF_MISC);          // halo row -> pixel or -1
  float* sig = reinterpret_cast<float*>(smem + OFF_MISC) + R;  // spatial map
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stg = reinterpret_cast<float*>(smem + OFF_STG) + warp * 256;

  const int tiles_w = (a.w + TW - 1) / TW, tiles_h = (a.h + TH - 1) / TH;
  const int tx = blockIdx.x % tiles_w;
  const int ty = (blockIdx.x / tiles_w) % tiles_h;
  const int img = blockIdx.x / (tiles_w * tiles_h);
  const int c = a.c, half = a.half;

  if (tid < R) {
    int p = -1;
    if (tid < NHALO) {
      const int r = ty * TH + tid / HW - 1, q = tx * TW + tid % HW - 1;
      if (r >= 0 && r < a.h && q >= 0 && q < a.w) p = (img * a.h + r) * a.w + q;
    }
    pix[tid] = p;
  }
  __syncthreads();
  // ---- u rows -> bf16 operand (rows outside the image: zero) ----
  for (int t = warp; t < R; t += NWARPS) {
    const int p = pix[t];
    const bf16* ur = a.u + static_cast<long long>(p) * c;
    for (int i = lane; i < CP; i += 32)
      as[t * LDA + i] = (p >= 0 && i < c) ? ur[i] : __float2bfloat16(0.f);
  }
  __syncthreads();
  Acc acc[4];
  // ---- spatial map m = sigmoid(w2 . bf16(gelu(W1 u + b1)) + b2): one warp ----
  if (warp == 0) {
    gemm_strip<CP>(acc, as, LDA, a.sp_w1, 0);
    strip_epilogue(acc, stg, lane, 0, [&](int r, int n, float (&v)[8]) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        part += round_bf16(gelu(v[i] + a.sp_b1[n + i], 0)) * a.sp_w2[n + i];
      part += __shfl_xor_sync(0xffffffffu, part, 1);  // the row's other 8 columns
      if ((lane & 1) == 0) sig[r] = 1.f / (1.f + expf(-(part + a.sp_b2[0])));
    });
  }
  __syncthreads();
  // ---- sg = bf16(u * gate + w_px * m), in place ----
  const float* gate = a.gate + static_cast<long long>(img) * c;
  for (int t = warp; t < R; t += NWARPS) {
    const int p = pix[t];
    if (p < 0) continue;
    const bf16* wr = a.wpx + static_cast<long long>(p) * c;
    const float m = sig[t];
    for (int i = lane; i < c; i += 32)
      as[t * LDA + i] = __float2bfloat16(__bfloat162float(as[t * LDA + i]) * gate[i] +
                                         __bfloat162float(wr[i]) * m);
  }
  __syncthreads();
  // ---- x2 = x + sg Wproj + bproj (fp32) ----
  for (int strip = warp; strip < CP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip<CP>(acc, as, LDA, a.wproj, n0);
    strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
      const int p = pix[r];
      const bf16* xr = a.x + static_cast<long long>(p) * c;
      float b[8];
      load8(b, a.bproj + n);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] += b[i] + ((p >= 0 && n + i < c) ? __bfloat162float(xr[n + i]) : 0.f);
      store8_f32(xs + r * LDX + n, v);
    });
  }
  __syncthreads();
  // ---- LN2 -> bf16 operand ----
  layernorm_rows<R, NWARPS>(xs, LDX, as, LDA, CP, a.g2, a.b2, c, a.eps, warp, lane);
  __syncthreads();
  // ---- h = gelu(y Wfc1 + bfc1) (fp32) ----
  for (int strip = warp; strip < HID / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip<CP>(acc, as, LDA, a.wfc1, n0);
    strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
      float b[8];
      load8(b, a.bfc1 + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = gelu(v[i] + b[i], 0);
      store8_f32(hs + r * LDH + n, v);
    });
  }
  __syncthreads();
  // ---- bf16(LN_sg(h2)) -> the operand buffer ----
  layernorm_rows<R, NWARPS>(hs + CP, LDH, as, LDA, CP, a.gsg, a.bsg, half, a.eps, warp, lane);
  __syncthreads();
  // ---- g = bf16(h1 * (dwconv3x3(h2) + bdw)) on the 32 output pixels ----
  for (int idx = tid; idx < NI * CP; idx += NTHREADS) {
    const int i = idx / CP, ch = idx % CP;
    const int hr = (i / TW + 1) * HW + i % TW + 1;  // the pixel's halo row
    float g = 0.f;
    if (ch < half && pix[hr] >= 0) {
      float s = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int tr = hr + (dy - 1) * HW + dx - 1;
          if (pix[tr] >= 0)
            s += __bfloat162float(as[tr * LDA + ch]) * a.wdw[(dy * 3 + dx) * half + ch];
        }
      }
      g = hs[hr * LDH + ch] * (s + a.bdw[ch]);
    }
    gs[i * LDA + ch] = __float2bfloat16(g);
  }
  __syncthreads();
  // ---- out = x2 + g Wfc2 + bfc2 ----
  Acc acc2[2];
  for (int strip = warp; strip < CP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_tiles<2, CP>(acc2, gs, LDA, a.wfc2, n0);
    tiles_epilogue(acc2, stg, lane, n0, [&](int i, int n, float (&v)[8]) {
      const int hr = (i / TW + 1) * HW + i % TW + 1;
      const int p = pix[hr];
      if (p < 0) return;
      float b[8], x2[8];
      load8(b, a.bfc2 + n);
      load8(x2, xs + hr * LDX + n);
      bf16* orow = a.out + static_cast<long long>(p) * c;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (n + k < c) orow[n + k] = __float2bfloat16(x2[k] + v[k] + b[k]);
    });
  }
}

}  // namespace

extern "C" int sr_dat_tail_bf16(const void* x, const void* u, const void* wpx, const void* gate,
                                void* out, const void* sp_w1, const void* sp_b1,
                                const void* sp_w2, const void* sp_b2, const void* wproj,
                                const void* bproj, const void* g2, const void* b2,
                                const void* wfc1, const void* bfc1, const void* gsg,
                                const void* bsg, const void* wdw, const void* bdw,
                                const void* wfc2, const void* bfc2, int batch, int h, int w,
                                int c, int half, float eps, void* stream) {
  if (c > CP || half > CP || c < 1 || half < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * h * w == 0) return 0;
  TailArgs a;
  a.x = static_cast<const bf16*>(x);
  a.u = static_cast<const bf16*>(u);
  a.wpx = static_cast<const bf16*>(wpx);
  a.gate = static_cast<const float*>(gate);
  a.out = static_cast<bf16*>(out);
  a.sp_w1 = static_cast<const bf16*>(sp_w1);
  a.sp_b1 = static_cast<const float*>(sp_b1);
  a.sp_w2 = static_cast<const float*>(sp_w2);
  a.sp_b2 = static_cast<const float*>(sp_b2);
  a.wproj = static_cast<const bf16*>(wproj);
  a.bproj = static_cast<const float*>(bproj);
  a.g2 = static_cast<const float*>(g2);
  a.b2 = static_cast<const float*>(b2);
  a.wfc1 = static_cast<const bf16*>(wfc1);
  a.bfc1 = static_cast<const float*>(bfc1);
  a.gsg = static_cast<const float*>(gsg);
  a.bsg = static_cast<const float*>(bsg);
  a.wdw = static_cast<const float*>(wdw);
  a.bdw = static_cast<const float*>(bdw);
  a.wfc2 = static_cast<const bf16*>(wfc2);
  a.bfc2 = static_cast<const float*>(bfc2);
  a.batch = batch;
  a.h = h;
  a.w = w;
  a.c = c;
  a.half = half;
  a.eps = eps;
  const cudaError_t err = cudaFuncSetAttribute(
      datb_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(batch) * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  datb_tail_kernel<<<static_cast<unsigned int>(blocks), NTHREADS, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
