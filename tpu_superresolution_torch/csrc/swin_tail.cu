// K1's tail on the K7 route — the rest of a Swin block after its window
// attention, for any window: the attention residual (window reverse and
// cyclic unshift in the addressing), HAT's `extra`, LN2, the MLP and its
// residual.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_block.py
//           K1 fused_swin_block -> _mega_forward -> _kernel (pallas_call
//           at :958): the part of the whole-block body after the
//           attention projection, for the blocks the whole-block kernel
//           (csrc/swin_block.cu, ws 7 / 8, C <= 192) does not take.  With
//           K2 (LN1) and K7 (qkv, attention, proj) before it, it computes
//           K1's function at ws 16 (upstream HAT-SRx4) and any other window.
// Math (per pixel p of x [B, H, W, C], C <= 256, any MLP hidden):
//         x1  = x + m1 * attn[win(p), tok(p)] + extra
//         out = x1 + m2 * fc2(gelu(fc1(LN2(x1))))
//       where attn [B*nW, N = ws*ws, C] is K7's output on the windows of
//       the map cyclically shifted by s: pixel (i, j) sits at (i', j') =
//       ((i - s) mod H, (j - s) mod W) there, window win = (b, i' / ws,
//       j' / ws) and token tok = (i' % ws) * ws + j' % ws.  (m1, m2) =
//       scales[b] (1 when scales is null); `extra` (null, or bf16 [B, H,
//       W, C]) is not scaled.  LayerNorm in fp32 fast-variance form, eps
//       given; GELU tanh or erf; bf16 GEMM operands with fp32
//       accumulation; the residual stream fp32 between the loads and the
//       single rounding at the store — K1's arithmetic.
// Design: one 256-thread block per 64 pixels (rows of the flat map, so
//       x, extra and out are read and written row-contiguously, two
//       channels a lane, and only the attention rows are gathered).  x1
//       stays fp32 in shared memory [64][CK]; LN2's output bf16
//       [64][CK+8]; the MLP hidden is processed in chunks of 128 columns
//       (bf16 [64][136], one 16-column strip a warp): fc1 + GELU of a
//       chunk, then its fc2 partial product added into x1 (times m2,
//       fc2's bias with the first chunk), so any hidden width fits.
//       Weights ([out, in], zero-padded to multiples of 16 by the host
//       packing) are read from L2 by the WMMA fragments.  Shared memory
//       is sized by C: ~98 KB at C 180, so two blocks share an SM and
//       hide each other's L2 latency (~124 KB at C 256: one).
// Bound on the H100: HAT-SRx4's bench batch ([25,64,64,180], hidden 360)
//       needs 4*C*hidden = 259,200 FLOP a pixel, 26.5 GFLOP = 0.027 ms at
//       the bf16 peak, against x, attn, extra in and out (147 MB, 0.044
//       ms): memory-bound in principle.
#include <mma.h>

#include "common.cuh"
#include "swin_common.cuh"

using namespace nvcuda;

namespace {

constexpr int MAX_C = 256;
constexpr int HC = 128;  // hidden columns per chunk
constexpr int T = 64;    // pixels per block
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDH = HC + 8;  // bf16 hidden chunk

// Shared-memory layout for CK padded channels (a multiple of 16, so
// every buffer starts 128-byte aligned): x1 fp32 [T][CK], LN2 output
// bf16 [T][CK + 8], the hidden chunk bf16 [T][LDH], m2 per row, and a
// 1 KB epilogue tile per warp.
struct Layout {
  int off_y, off_h, off_m2, off_stg, bytes;
  __host__ __device__ constexpr explicit Layout(int ck)
      : off_y(T * ck * 4),
        off_h(off_y + T * (ck + 8) * 2),
        off_m2(off_h + T * LDH * 2),
        off_stg(off_m2 + T * 4),
        bytes(off_stg + NWARPS * 256 * 4) {}
};
static_assert(Layout(MAX_C).bytes <= 232448, "over the 227 KB shared-memory limit");

struct TailArgs {
  const bf16* x;      // [B, H, W, C]
  const bf16* attn;   // [B*nW, N, C]
  const bf16* extra;  // [B, H, W, C] or null
  bf16* y;            // [B, H, W, C]
  const float* g2;
  const float* b2;
  const bf16* wfc1;   // [HK, CK]
  const float* bfc1;  // [HK]
  const bf16* wfc2;   // [CK, HK]
  const float* bfc2;  // [CK]
  const float* scales;  // [B, 2] or null
  long long rows;       // B*H*W
  int h, w, c, ck, hk, ws, shift, gelu_tanh;
  int pairs;  // C even and x, attn, extra, y 4-byte aligned: bf16x2 loads and stores
  float eps;
};

__global__ void __launch_bounds__(NTHREADS, 2) swin_tail_kernel(const TailArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(a.ck);
  const int ldx = a.ck, ldy = a.ck + 8;
  float* xs = reinterpret_cast<float*>(smem);
  bf16* ys = reinterpret_cast<bf16*>(smem + lay.off_y);
  bf16* hs = reinterpret_cast<bf16*>(smem + lay.off_h);
  float* m2s = reinterpret_cast<float*>(smem + lay.off_m2);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stg = reinterpret_cast<float*>(smem + lay.off_stg) + warp * 256;

  const long long r0 = static_cast<long long>(blockIdx.x) * T;
  const int hw = a.h * a.w, n = a.ws * a.ws;
  const int nww = a.w / a.ws, nwh = a.h / a.ws;

  // ---- x1 = x + m1 * attn + extra -> fp32 shared (columns c..ck zero;
  // rows past the map zero, never stored) ----
  const bool pairs = a.pairs;
  for (int t = warp; t < T; t += NWARPS) {
    const long long p = r0 + t;
    float* xr = xs + t * ldx;
    if (p < a.rows) {
      const int bidx = static_cast<int>(p / hw), rem = static_cast<int>(p % hw);
      const int si = (rem / a.w - a.shift + a.h) % a.h;
      const int sj = (rem % a.w - a.shift + a.w) % a.w;
      const long long win = (static_cast<long long>(bidx) * nwh + si / a.ws) * nww + sj / a.ws;
      const int tok = (si % a.ws) * a.ws + sj % a.ws;
      const bf16* xp = a.x + p * a.c;
      const bf16* ap = a.attn + (win * n + tok) * a.c;
      const bf16* ep = a.extra ? a.extra + p * a.c : nullptr;
      const float m1 = a.scales ? a.scales[2 * bidx] : 1.f;
      if (pairs) {
        for (int k = 2 * lane; k < a.ck; k += 64) {
          float2 v = make_float2(0.f, 0.f);
          if (k < a.c) {
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xp + k));
            const float2 av = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ap + k));
            v = make_float2(xv.x + m1 * av.x, xv.y + m1 * av.y);
            if (ep) {
              const float2 ev =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ep + k));
              v.x += ev.x;
              v.y += ev.y;
            }
          }
          *reinterpret_cast<float2*>(xr + k) = v;
        }
      } else {
        for (int k = lane; k < a.ck; k += 32) {
          float v = 0.f;
          if (k < a.c) {
            v = __bfloat162float(xp[k]) + m1 * __bfloat162float(ap[k]);
            if (ep) v += __bfloat162float(ep[k]);
          }
          xr[k] = v;
        }
      }
      if (lane == 0) m2s[t] = a.scales ? a.scales[2 * bidx + 1] : 1.f;
    } else {
      for (int k = lane; k < a.ck; k += 32) xr[k] = 0.f;
      if (lane == 0) m2s[t] = 0.f;
    }
  }
  // LN2 reads each row in the warp that wrote it
  __syncwarp();
  layernorm_rows<T, NWARPS>(xs, ldx, ys, ldy, a.ck, a.g2, a.b2, a.c, a.eps, warp, lane);
  __syncthreads();

  // ---- MLP, one hidden chunk at a time ----
  Acc acc[4];
  for (int h0 = 0; h0 < a.hk; h0 += HC) {
    const int hc = min(HC, a.hk - h0);
    // hidden[:, h0:h0+hc] = gelu(LN2(x1) Wfc1[h0:h0+hc]^T + bfc1)
    for (int strip = warp; strip < hc / 16; strip += NWARPS) {
      const int n0 = strip * 16;
      gemm_strip_rt(acc, ys, ldy, a.wfc1, a.ck, h0 + n0, a.ck);
      strip_epilogue(acc, stg, lane, n0, [&](int r, int col, float (&v)[8]) {
        float b[8];
        load8(b, a.bfc1 + h0 + col);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = gelu(v[i] + b[i], a.gelu_tanh);
        store8_bf16(hs + r * LDH + col, v);
      });
    }
    __syncthreads();
    // x1 += m2 * (hidden chunk Wfc2[:, h0:h0+hc]^T (+ bfc2 with the first chunk));
    // pad columns of x1 receive + 0 (zero weight rows and bias)
    for (int strip = warp; strip < a.ck / 16; strip += NWARPS) {
      const int n0 = strip * 16;
      gemm_strip_rt(acc, hs, LDH, a.wfc2 + h0, a.hk, n0, hc);
      strip_epilogue(acc, stg, lane, n0, [&](int r, int col, float (&v)[8]) {
        float b[8], x[8];
        if (h0 == 0) {
          load8(b, a.bfc2 + col);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) b[i] = 0.f;
        }
        load8(x, xs + r * ldx + col);
        const float m2 = m2s[r];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] += m2 * (v[i] + b[i]);
        store8_f32(xs + r * ldx + col, x);
      });
    }
    __syncthreads();
  }

  // ---- out, rows inside the map ----
  for (int t = warp; t < T; t += NWARPS) {
    const long long p = r0 + t;
    if (p >= a.rows) break;
    bf16* yr = a.y + p * a.c;
    const float* xr = xs + t * ldx;
    if (pairs) {
      for (int k = 2 * lane; k < a.c; k += 64)
        *reinterpret_cast<__nv_bfloat162*>(yr + k) = __floats2bfloat162_rn(xr[k], xr[k + 1]);
    } else {
      for (int k = lane; k < a.c; k += 32) yr[k] = __float2bfloat16(xr[k]);
    }
  }
}

}  // namespace

extern "C" int sr_swin_tail_bf16(const void* x, const void* attn, const void* extra, void* y,
                                 const void* g2, const void* b2, const void* wfc1,
                                 const void* bfc1, const void* wfc2, const void* bfc2,
                                 const void* scales, int batch, int h, int w, int c, int hidden,
                                 int ws, int shift, int gelu_tanh, float eps, void* stream) {
  if (c < 1 || c > MAX_C || hidden < 1 || ws < 1 || h % ws || w % ws || shift < 0 ||
      shift >= ws)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(batch) * h * w;
  if (rows == 0) return 0;
  const int ck = (c + 15) / 16 * 16;
  const int smem_bytes = Layout(ck).bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      swin_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  TailArgs a;
  a.x = static_cast<const bf16*>(x);
  a.attn = static_cast<const bf16*>(attn);
  a.extra = static_cast<const bf16*>(extra);
  a.y = static_cast<bf16*>(y);
  a.g2 = static_cast<const float*>(g2);
  a.b2 = static_cast<const float*>(b2);
  a.wfc1 = static_cast<const bf16*>(wfc1);
  a.bfc1 = static_cast<const float*>(bfc1);
  a.wfc2 = static_cast<const bf16*>(wfc2);
  a.bfc2 = static_cast<const float*>(bfc2);
  a.scales = static_cast<const float*>(scales);
  a.rows = rows;
  a.h = h;
  a.w = w;
  a.c = c;
  a.ck = ck;
  a.hk = (hidden + 15) / 16 * 16;
  a.ws = ws;
  a.shift = shift;
  a.gelu_tanh = gelu_tanh;
  a.pairs = c % 2 == 0 && aligned_to(x, 4) && aligned_to(attn, 4) && aligned_to(y, 4) &&
            (!extra || aligned_to(extra, 4));
  a.eps = eps;
  swin_tail_kernel<<<static_cast<unsigned int>((rows + T - 1) / T), NTHREADS, smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
