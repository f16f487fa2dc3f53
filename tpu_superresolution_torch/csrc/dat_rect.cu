// K9 — the front half of DAT's spatial block: LN1 -> qkv -> the two
// rectangular-window attention branches, and the conv branch.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_rect_attn.py
//           fused_rect_attention -> _kernel (pallas_call at :433).
// Math (dat_arch.py:247-438 up to the AIM gating), for x [B, H, W, C]:
//         y = LN1(x) (fp32 fast-variance statistics, eps 1e-5), bf16
//         q, k, v = y Wqkv + bqkv, bf16, q pre-scaled by hd^-0.5
//         branch 0 (channels 0..C/2-1): s0 x s1 windows; branch 1
//         (C/2..C-1): s1 x s0 windows; nh/2 heads each; per window and
//         head softmax(q k^T + bias[h] + mask) v in fp32 with bf16
//         operands; mask = -100 where the shifted windows' region ids
//         differ (not -inf)
//         conv_x = erf-GELU(dwconv3x3(v) + b), BatchNorm folded into
//         the depthwise kernel, SAME zero padding, true coordinates
// Geometry: q, k, v are zero-padded after the projection to Hp x Wp,
//       multiples of max(s0, s1) (dat_arch.py:376-385), and a shifted
//       block rolls them by (-hsp/2, -wsp/2).  Token t of window (wy, wx)
//       of a branch sits at (pr, pc) = (wy*hsp + t/wsp, wx*wsp + t%wsp)
//       in the rolled frame, i.e. at ((pr+sh) mod Hp, (pc+sw) mod Wp) of
//       the padded map: a real pixel when inside H x W, else a pad token
//       (q = k = v = 0; a real key whose score is the bias alone, its
//       output not stored).  Outputs are written at true coordinates:
//       no roll pass, no pad pass, no shape gate.
// Launches: (1) rect_attn_kernel, one 256-thread block per (image,
//       branch, window): the window's x rows, LN1, the branch's q|k|v
//       product [128 x 192] x [192 x 288], then per head S = q k^T, the
//       softmax, O = P v; it also writes its half of v at true
//       coordinates; (2) dwconv_gelu_kernel over v.
// Bound on the H100 at [25,64,64,180]: ~0.30 MFLOP per token (the qkv
//       product, both branches' attention over 128 keys, the conv
//       branch) against ~111 MB in and out: compute-bound in principle.
//       This first version keeps one window per SM (~183 KB of shared
//       memory: y / scores fp32 [128][132] aliased, q|k|v bf16 [128][296],
//       probabilities bf16 [128][136]), reads the weights from L2
//       through WMMA fragments, and round-trips v (~37 MB) for the conv
//       branch, whose 3x3 halo crosses window borders.
#include <mma.h>

#include "common.cuh"
#include "dat_common.cuh"
#include "swin_common.cuh"

using namespace nvcuda;

namespace {

constexpr int NT = 128;            // tokens per window (s0 * s1)
constexpr int CP = 192;            // padded channels
constexpr int HDP = 32;            // padded head dim
constexpr int NHB = 3;             // heads per branch, padded
constexpr int PART = NHB * HDP;    // 96 columns of q, of k, of v
constexpr int QKVB = 3 * PART;     // 288 columns per branch
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

constexpr int LDY = CP + 8;        // bf16
constexpr int LDQ = QKVB + 8;      // bf16
constexpr int LDS = NT + 4;        // fp32
constexpr int LDP = NT + 8;        // bf16

constexpr int Y_BYTES = NT * LDY * 2;
constexpr int S_BYTES = NT * LDS * 4;
constexpr int OFF_Y = 0;           // LN1 output, then the scores
constexpr int OFF_QKV = OFF_Y + (S_BYTES > Y_BYTES ? S_BYTES : Y_BYTES);
constexpr int OFF_P = OFF_QKV + NT * LDQ * 2;
constexpr int OFF_STG = OFF_P + NT * LDP * 2;
constexpr int OFF_TOK = OFF_STG + NWARPS * 256 * 4;
constexpr int SMEM_BYTES = OFF_TOK + 2 * NT * 4;
static_assert(SMEM_BYTES <= 232448, "over the 227 KB shared-memory limit");
static_assert(OFF_QKV % 128 == 0 && OFF_P % 128 == 0 && OFF_STG % 128 == 0 &&
                  OFF_TOK % 128 == 0,
              "shared buffers must stay 128-byte aligned");

struct RectArgs {
  const bf16* x;
  bf16* out;          // attened_x [B, H, W, C]
  bf16* v;            // v [B, H, W, C] (for the conv branch)
  const float* g1;
  const float* b1;
  const bf16* wqkv;   // [2][QKVB][CP], [out, in]
  const float* bqkv;  // [2][QKVB]
  const float* bias;  // [2][nhb][NT][NT]
  int batch, h, w, c, nhb, hd, s0, s1, shifted;
  float eps;
};

__global__ void __launch_bounds__(NTHREADS, 1) rect_attn_kernel(const RectArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem + OFF_Y);
  float* ss = reinterpret_cast<float*>(smem + OFF_Y);
  bf16* qkv = reinterpret_cast<bf16*>(smem + OFF_QKV);
  bf16* ps = reinterpret_cast<bf16*>(smem + OFF_P);
  int* tok_pix = reinterpret_cast<int*>(smem + OFF_TOK);  // pixel index or -1 (pad)
  int* tok_reg = tok_pix + NT;                             // shift-mask region id

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stg = reinterpret_cast<float*>(smem + OFF_STG) + warp * 256;

  const int ms = max(a.s0, a.s1);
  const int hp = (a.h + ms - 1) / ms * ms, wp = (a.w + ms - 1) / ms * ms;
  const int nwin = hp * wp / NT;
  const int win = blockIdx.x % nwin;
  const int br = (blockIdx.x / nwin) & 1;
  const int img = blockIdx.x / (2 * nwin);
  const int hsp = br ? a.s1 : a.s0, wsp = br ? a.s0 : a.s1;
  const int sh = a.shifted ? hsp / 2 : 0, sw = a.shifted ? wsp / 2 : 0;
  const int nwx = wp / wsp;
  const int wy = win / nwx, wx = win % nwx;
  const int c = a.c, half = c / 2;

  if (tid < NT) {
    const int pr = wy * hsp + tid / wsp, pc = wx * wsp + tid % wsp;
    const int r = (pr + sh) % hp, q = (pc + sw) % wp;
    tok_pix[tid] = (r < a.h && q < a.w) ? (img * a.h + r) * a.w + q : -1;
    // rect_shift_region_ids on the padded map, in rolled coordinates
    const int rr = pr < hp - hsp ? 0 : (pr < hp - sh ? 1 : 2);
    const int rc = pc < wp - wsp ? 0 : (pc < wp - sw ? 1 : 2);
    tok_reg[tid] = 3 * rr + rc;
  }
  __syncthreads();

  // ---- LN1 of the window's tokens -> bf16 ys (pad tokens: zero rows) ----
  const float inv_c = 1.f / static_cast<float>(c);
  for (int t = warp; t < NT; t += NWARPS) {
    const int p = tok_pix[t];
    bf16* yr = ys + t * LDY;
    if (p < 0) {
      for (int i = lane; i < CP; i += 32) yr[i] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* xr = a.x + static_cast<long long>(p) * c;
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

  // ---- the branch's q|k|v = y W + b -> bf16 [128][288]; pad tokens 0 ----
  const bf16* wb = a.wqkv + static_cast<long long>(br) * QKVB * CP;
  const float* bb = a.bqkv + br * QKVB;
  {
    Acc acc[4];
    for (int item = warp; item < 2 * (QKVB / 16); item += NWARPS) {
      const int r0 = (item / (QKVB / 16)) * 64;
      const int n0 = (item % (QKVB / 16)) * 16;
      gemm_strip<CP>(acc, ys + r0 * LDY, LDY, wb, n0);
      strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
        const int t = r0 + r;
        float b[8];
        load8(b, bb + n);
        const bool pad = tok_pix[t] < 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = pad ? 0.f : v[i] + b[i];
        store8_bf16(qkv + t * LDQ + n, v);
      });
    }
  }
  __syncthreads();

  // ---- the branch's half of v at true coordinates (the conv branch) ----
  for (int t = warp; t < NT; t += NWARPS) {
    const int p = tok_pix[t];
    if (p < 0) continue;
    bf16* vr = a.v + static_cast<long long>(p) * c + br * half;
    for (int i = lane; i < half; i += 32)
      vr[i] = qkv[t * LDQ + 2 * PART + (i / a.hd) * HDP + i % a.hd];
  }

  // ---- attention, one head at a time ----
  for (int hh = 0; hh < a.nhb; ++hh) {
    // S = Q_h K_h^T (q carries the scale); the LN1 rows in ys are dead
    for (int tile = warp; tile < 64; tile += NWARPS) {
      const int mt = tile >> 3, nt = tile & 7;
      Acc s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int k = 0; k < HDP; k += 16) {
        FragA fa;
        FragBt fb;
        wmma::load_matrix_sync(fa, qkv + mt * 16 * LDQ + hh * HDP + k, LDQ);
        wmma::load_matrix_sync(fb, qkv + nt * 16 * LDQ + PART + hh * HDP + k, LDQ);
        wmma::mma_sync(s, fa, fb, s);
      }
      wmma::store_matrix_sync(ss + mt * 16 * LDS + nt * 16, s, LDS, wmma::mem_row_major);
    }
    __syncthreads();
    // softmax(S + bias + mask) in fp32 -> bf16; 16 lanes per row, 8
    // columns per lane
    const float* bh = a.bias + (static_cast<long long>(br) * a.nhb + hh) * NT * NT;
    for (int r = warp * 2 + (lane >> 4); r < NT; r += NWARPS * 2) {
      const int c0 = (lane & 15) * 8;
      float v[8], t[8];
      load8(v, ss + r * LDS + c0);
      load8(t, bh + r * NT + c0);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += t[i];
      if (a.shifted) {
        const int rg = tok_reg[r];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (tok_reg[c0 + i] != rg) v[i] -= 100.f;
      }
      float m = v[0];
#pragma unroll
      for (int i = 1; i < 8; ++i) m = fmaxf(m, v[i]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = expf(v[i] - m);
        sum += v[i];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float inv = 1.f / sum;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= inv;
      store8_bf16(ps + r * LDP + c0, v);
    }
    __syncthreads();
    // O_h = P V_h, written at the tokens' true pixels (hd of 32 columns)
    for (int tile = warp; tile < 16; tile += NWARPS) {
      const int mt = tile >> 1, nt = tile & 1;
      Acc o;
      wmma::fill_fragment(o, 0.f);
#pragma unroll
      for (int k = 0; k < NT; k += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, ps + mt * 16 * LDP + k, LDP);
        wmma::load_matrix_sync(fb, qkv + k * LDQ + 2 * PART + hh * HDP + nt * 16, LDQ);
        wmma::mma_sync(o, fa, fb, o);
      }
      wmma::store_matrix_sync(stg, o, 16, wmma::mem_row_major);
      __syncwarp();
      const int rr = lane >> 1, cc = (lane & 1) * 8;
      const int p = tok_pix[mt * 16 + rr];
      if (p >= 0) {
        bf16* orow = a.out + static_cast<long long>(p) * c + br * half + hh * a.hd;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int d = nt * 16 + cc + i;
          if (d < a.hd) orow[d] = __float2bfloat16(stg[rr * 16 + cc + i]);
        }
      }
      __syncwarp();
    }
    // the next head's S writes only ss; its barrier orders this head's
    // reads of ps before the next softmax writes it
  }
}

// conv_x = erf-GELU(dwconv3x3(v)): one thread per pixel and channel pair.
__global__ void dwconv_gelu_kernel(const bf16* v, bf16* out, const float* wdw, const float* bdw,
                                   int batch, int h, int w, int c) {
  const int c2 = c / 2;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(batch) * h * w * c2) return;
  const int ch = static_cast<int>(i % c2) * 2;
  const long long pix = i / c2;
  const int q = static_cast<int>(pix % w);
  const int r = static_cast<int>((pix / w) % h);
  const int img = static_cast<int>(pix / (static_cast<long long>(w) * h));
  const float2 s = dwconv3x3_pair(v, img, r, q, h, w, c, ch, wdw, bdw);
  *reinterpret_cast<__nv_bfloat162*>(out + pix * c + ch) =
      __floats2bfloat162_rn(gelu(s.x, 0), gelu(s.y, 0));
}

}  // namespace

extern "C" int sr_dat_rect_bf16(const void* x, void* out, void* v, void* conv, const void* g1,
                                const void* b1, const void* wqkv, const void* bqkv,
                                const void* bias, const void* wdw, const void* bdw, int batch,
                                int h, int w, int c, int nhb, int hd, int s0, int s1, int shifted,
                                float eps, void* stream) {
  if (s0 * s1 != NT || c > CP || (c & 1) || nhb > NHB || hd > HDP || nhb * hd * 2 != c)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pixels = static_cast<long long>(batch) * h * w;
  if (pixels == 0) return 0;
  RectArgs a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.v = static_cast<bf16*>(v);
  a.g1 = static_cast<const float*>(g1);
  a.b1 = static_cast<const float*>(b1);
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.bqkv = static_cast<const float*>(bqkv);
  a.bias = static_cast<const float*>(bias);
  a.batch = batch;
  a.h = h;
  a.w = w;
  a.c = c;
  a.nhb = nhb;
  a.hd = hd;
  a.s0 = s0;
  a.s1 = s1;
  a.shifted = shifted;
  a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaFuncSetAttribute(rect_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ms = s0 > s1 ? s0 : s1;
  const long long hp = (h + ms - 1) / ms * ms, wp = (w + ms - 1) / ms * ms;
  const long long blocks = static_cast<long long>(batch) * 2 * (hp * wp / NT);
  rect_attn_kernel<<<static_cast<unsigned int>(blocks), NTHREADS, SMEM_BYTES, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = pixels * (c / 2);
  dwconv_gelu_kernel<<<static_cast<unsigned int>((work + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(v), static_cast<bf16*>(conv), static_cast<const float*>(wdw),
      static_cast<const float*>(bdw), batch, h, w, c);
  return static_cast<int>(cudaGetLastError());
}
