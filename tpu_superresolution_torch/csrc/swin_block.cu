// K1 and K6 — one whole Swin transformer block forward per window, for
// window size 8 (K1) or 7 (K6), with an optional additive term `extra`.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_block.py
//           K1  fused_swin_block -> _mega_forward -> _kernel (strip mode,
//               pallas_call at :958), `extra` included;
//           K6  fused_packed_windows_block -> _packed_forward (forward
//               pallas_call at :1427) and K13 fused_spatial_windows_block
//               -> _spatial_forward (:1532), which compute the same
//               function on windows partitioned and token-padded in HBM
//               (K6) or read from the spatial map (K13).  This kernel
//               reads windows straight from the spatial map, so one
//               instantiation per window size covers all three.
// Math (per window of NT = WS*WS tokens, C <= 192 channels, nh heads of
//       hd <= 32, MLP hidden <= 384):
//         x1  = x + m1 * proj(softmax(q k^T * scale + rpb[h] + mask[win]) v)
//               + extra
//               with q, k, v = LN1(x) Wqkv + bqkv
//         out = x1 + m2 * fc2(gelu(fc1(LN2(x1))))
//       where (m1, m2) = scales[b] are the sample's stochastic-depth
//       branch scales (1 when scales is null: the multiply is then exact)
//       and `extra` (null, or bf16 [B, H, W, C] read at x's addresses) is
//       HAT's conv_scale * CAB branch, not scaled by m1.
//       LayerNorm uses fp32 fast-variance statistics (E[x^2] - E[x]^2,
//       clamped at 0, eps 1e-5); softmax is fp32; GELU is tanh or erf;
//       matmul operands are bf16 with fp32 accumulation; the residual
//       stream stays fp32 inside the block.
// Cyclic shift: the window's token (i, j) reads and writes pixel
//       ((wy*WS + i + s) mod H, (wx*WS + j + s) mod W), so the block
//       computes cyclic_unshift(block(cyclic_shift(x, s)), s) with no roll
//       pass and no partition in HBM.
// Token padding: every shared buffer holds NTP = 64 token rows, so the
//       GEMMs are whole 16x16x16 WMMA tiles for either window.  At WS = 7
//       rows 49..63 are zero inputs whose results are never stored, and
//       key columns 49..63 get -inf scores (no probability mass).  The
//       padding wastes 15/64 of the rows.
// Bound on the H100: SwinIR-M's block (C 180, [25,64,64,180]) does ~41
//       MFLOP of bf16 GEMMs per window against ~46 KB of activations in
//       and out, HAT's (C 96, ws 7) ~12 MFLOP against ~29 KB (x, extra,
//       out), so both are compute-bound in principle; this first version
//       runs SwinIR's at ~6% of the bf16 peak.  One 384-thread block per
//       window holds ~209 KB of shared memory, so an SM runs one window
//       at a time through ~20 barrier-separated phases (clock64 timing of
//       one block: GEMMs ~55%, attention ~25%, loads + LayerNorms ~20%),
//       and each 16x16 accumulator tile passes through a shared-memory
//       staging tile because the WMMA fragment layout is opaque.  At
//       HAT's widths the fixed CP = 192 / HDP = 32 padding (C 96 -> 192,
//       hd 16 -> 32) and the token padding roughly double the GEMM work.
// Design: everything between the x read and the out write stays in
//       shared memory: x/x1 fp32 [64][192], LN output bf16 [64][200],
//       qkv bf16 [64][584] (reused for the MLP hidden [64][392]), one
//       head's scores fp32 [64][68] and probabilities bf16 [64][72], the
//       attention output bf16 [64][200], and a 1 KB epilogue tile per
//       warp.  Head dims are zero-padded to 32 and channels to 192 by the
//       host-side weight packing (pack_block_weights).  Each warp owns
//       64x16 output strips.  wgmma, TMA weight staging, several windows
//       per block and a CP = 96 instantiation are later work.
#include <mma.h>

#include "common.cuh"
#include "swin_common.cuh"

using namespace nvcuda;

namespace {

constexpr int NTP = 64;      // token rows of every buffer: a window's WS*WS, padded
constexpr int CP = 192;      // padded channels
constexpr int HDP = 32;      // padded head dim
constexpr int QKVP = 3 * CP;  // 576
constexpr int HIDP = 384;     // padded MLP hidden
constexpr int NWARPS = 12;
constexpr int NTHREADS = NWARPS * 32;

constexpr int LDX = CP;         // fp32
constexpr int LDY = CP + 8;     // bf16
constexpr int LDQKV = QKVP + 8;  // bf16
constexpr int LDH = HIDP + 8;   // bf16
constexpr int LDS = NTP + 4;    // fp32
constexpr int LDP = NTP + 8;    // bf16
constexpr int LDO = CP + 8;     // bf16

constexpr int OFF_X = 0;
constexpr int OFF_Y = OFF_X + NTP * LDX * 4;
constexpr int OFF_QKV = OFF_Y + NTP * LDY * 2;
constexpr int QKV_BYTES = NTP * LDQKV * 2 > NTP * LDH * 2 ? NTP * LDQKV * 2 : NTP * LDH * 2;
constexpr int OFF_S = OFF_QKV + QKV_BYTES;
constexpr int OFF_P = OFF_S + NTP * LDS * 4;
constexpr int OFF_O = OFF_P + NTP * LDP * 2;
constexpr int OFF_STG = OFF_O + NTP * LDO * 2;
constexpr int SMEM_BYTES = OFF_STG + NWARPS * 256 * 4;
static_assert(SMEM_BYTES <= 232448, "over the 227 KB shared-memory limit");
static_assert(OFF_Y % 128 == 0 && OFF_QKV % 128 == 0 && OFF_S % 128 == 0 &&
                  OFF_P % 128 == 0 && OFF_O % 128 == 0 && OFF_STG % 128 == 0,
              "shared buffers must stay 128-byte aligned");

struct BlockArgs {
  const bf16* x;
  const bf16* extra;  // [batch, h, w, c] or null
  bf16* y;
  const float* g1;
  const float* b1;
  const float* g2;
  const float* b2;
  // GEMM weights are [out, in] (the nn.Linear layout, zero-padded), so
  // a 16x16 B fragment is read as column-major: each thread's k-pairs
  // are contiguous 4-byte words.
  const bf16* wqkv;   // [QKVP, CP], q rows pre-scaled
  const float* bqkv;  // [QKVP]
  const bf16* wproj;  // [CP, CP]  (columns = head-padded attention channels)
  const float* bproj;  // [CP]
  const bf16* wfc1;   // [HIDP, CP]
  const float* bfc1;  // [HIDP]
  const bf16* wfc2;   // [CP, HIDP]
  const float* bfc2;  // [CP]
  const float* rpb;   // [nh, NT, NT]
  const float* mask;  // [nW, NT, NT] or null
  const float* scales;  // [batch, 2] or null
  int batch, h, w, c, nh, shift, gelu_tanh;
  float eps;
};

template <int WS>
__global__ void __launch_bounds__(NTHREADS, 1) swin_block_kernel(const BlockArgs a) {
  constexpr int NT = WS * WS;  // tokens per window
  static_assert(NT <= NTP && NTP - NT < 16, "the token pad must stay under one WMMA tile");
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + OFF_X);
  bf16* ys = reinterpret_cast<bf16*>(smem + OFF_Y);
  bf16* qkv = reinterpret_cast<bf16*>(smem + OFF_QKV);
  bf16* hs = qkv;  // MLP hidden reuses the qkv buffer
  float* ss = reinterpret_cast<float*>(smem + OFF_S);
  bf16* ps = reinterpret_cast<bf16*>(smem + OFF_P);
  bf16* os = reinterpret_cast<bf16*>(smem + OFF_O);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stg = reinterpret_cast<float*>(smem + OFF_STG) + warp * 256;

  const int nww = a.w / WS, nwh = a.h / WS;
  const int win = blockIdx.x % (nwh * nww);  // window index inside the image
  const int bidx = blockIdx.x / (nwh * nww);
  const int wy = win / nww, wx = win % nww;
  const int c = a.c;
  const float m1 = a.scales ? a.scales[2 * bidx] : 1.f;
  const float m2 = a.scales ? a.scales[2 * bidx + 1] : 1.f;

  // element offset of the window's token t (< NT) in x, extra and y
  auto token_offset = [&](int t) -> long long {
    const int r = (wy * WS + t / WS + a.shift) % a.h;
    const int q = (wx * WS + t % WS + a.shift) % a.w;
    return ((static_cast<long long>(bidx) * a.h + r) * a.w + q) * c;
  };

  // ---- x -> fp32 shared (pad tokens zero); zero the attention output ----
  for (int t = warp; t < NTP; t += NWARPS) {
    if (t < NT) {
      const bf16* xr = a.x + token_offset(t);
      for (int i = lane; i < c; i += 32) xs[t * LDX + i] = __bfloat162float(xr[i]);
    } else {
      for (int i = lane; i < c; i += 32) xs[t * LDX + i] = 0.f;
    }
  }
  for (int i = tid; i < NTP * LDO; i += NTHREADS) os[i] = __float2bfloat16(0.f);
  __syncwarp();
  layernorm_rows<NTP, NWARPS>(xs, LDX, ys, LDY, CP, a.g1, a.b1, c, a.eps, warp, lane);
  __syncthreads();

  Acc acc[4];

  // ---- qkv = LN1(x) @ Wqkv + bqkv  -> bf16 [64][576] ----
  for (int strip = warp; strip < QKVP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip<CP>(acc, ys, LDY, a.wqkv, n0);
    strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
      float b[8];
      load8(b, a.bqkv + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += b[i];
      store8_bf16(qkv + r * LDQKV + n, v);
    });
  }
  __syncthreads();

  // ---- attention, one head at a time ----
  const float* mwin = a.mask ? a.mask + static_cast<long long>(win) * NT * NT : nullptr;
  for (int hh = 0; hh < a.nh; ++hh) {
    // S = Q_h K_h^T (q already carries the softmax scale)
    for (int tile = warp; tile < 16; tile += NWARPS) {
      const int mt = tile >> 2, nt = tile & 3;
      Acc s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int k = 0; k < HDP; k += 16) {
        FragA fa;
        FragBt fb;
        wmma::load_matrix_sync(fa, qkv + mt * 16 * LDQKV + hh * HDP + k, LDQKV);
        wmma::load_matrix_sync(fb, qkv + nt * 16 * LDQKV + CP + hh * HDP + k, LDQKV);
        wmma::mma_sync(s, fa, fb, s);
      }
      wmma::store_matrix_sync(ss + mt * 16 * LDS + nt * 16, s, LDS, wmma::mem_row_major);
    }
    __syncthreads();
    // softmax(S + rpb + mask) in fp32 -> bf16 probabilities; a warp
    // takes four rows per pass, eight lanes per row, eight columns per
    // lane, so a row's reductions are three shuffles.  Pad key columns
    // get -inf (probability 0); pad query rows get no bias (finite,
    // never stored).  Column 0 is always a real key, so the max is finite.
    const float* rp = a.rpb + static_cast<long long>(hh) * NT * NT;
    for (int r = warp * 4 + (lane >> 3); r < NTP; r += NWARPS * 4) {
      const int c0 = (lane & 7) * 8;
      float v[8];
      load8(v, ss + r * LDS + c0);
      if constexpr (NT == NTP) {
        float t[8];
        load8(t, rp + r * NT + c0);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] += t[i];
        if (mwin) {
          load8(t, mwin + r * NT + c0);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] += t[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = c0 + i;
          if (col >= NT) {
            v[i] = -__int_as_float(0x7f800000);  // -inf
          } else if (r < NT) {
            v[i] += rp[r * NT + col];
            if (mwin) v[i] += mwin[r * NT + col];
          }
        }
      }
      float m = v[0];
#pragma unroll
      for (int i = 1; i < 8; ++i) m = fmaxf(m, v[i]);
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = expf(v[i] - m);
        sum += v[i];
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float inv = 1.f / sum;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= inv;
      store8_bf16(ps + r * LDP + c0, v);
    }
    __syncthreads();
    // O_h = P V_h -> attention output columns [hh*32, hh*32+32)
    for (int tile = warp; tile < 8; tile += NWARPS) {
      const int mt = tile >> 1, nt = tile & 1;
      Acc o;
      wmma::fill_fragment(o, 0.f);
#pragma unroll
      for (int k = 0; k < NTP; k += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, ps + mt * 16 * LDP + k, LDP);
        wmma::load_matrix_sync(fb, qkv + k * LDQKV + 2 * CP + hh * HDP + nt * 16, LDQKV);
        wmma::mma_sync(o, fa, fb, o);
      }
      wmma::store_matrix_sync(stg, o, 16, wmma::mem_row_major);
      __syncwarp();
      float v[8];
      load8(v, stg + (lane >> 1) * 16 + (lane & 1) * 8);
      store8_bf16(os + (mt * 16 + (lane >> 1)) * LDO + hh * HDP + nt * 16 + (lane & 1) * 8, v);
      __syncwarp();
    }
    // The next head's S step writes only ss; its barrier orders this
    // head's reads of ps before the next softmax writes it.
  }
  __syncthreads();

  // ---- x1 = x + m1 * (O @ Wproj + bproj) (fp32, in place) ----
  for (int strip = warp; strip < CP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip<CP>(acc, os, LDO, a.wproj, n0);
    // columns >= C of the padded weights and bias are zero, so the pad
    // columns of xs (never read) only receive + 0
    strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
      float b[8], x[8];
      load8(b, a.bproj + n);
      load8(x, xs + r * LDX + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] += m1 * (v[i] + b[i]);
      store8_f32(xs + r * LDX + n, x);
    });
  }
  __syncthreads();

  // ---- x1 += extra (unscaled), then LN2: the same (row, lane) mapping,
  // so each lane reads back only what it wrote ----
  if (a.extra) {
    for (int t = warp; t < NT; t += NWARPS) {
      const bf16* er = a.extra + token_offset(t);
      for (int i = lane; i < c; i += 32) xs[t * LDX + i] += __bfloat162float(er[i]);
    }
  }
  layernorm_rows<NTP, NWARPS>(xs, LDX, ys, LDY, CP, a.g2, a.b2, c, a.eps, warp, lane);
  __syncthreads();

  // ---- MLP: fc1 -> GELU -> fc2, residual ----
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
      load8(x, xs + r * LDX + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] += m2 * (v[i] + b[i]);
      store8_f32(xs + r * LDX + n, x);
    });
  }
  __syncthreads();

  // ---- out -> the same (shifted) pixels; pad tokens are not stored ----
  for (int t = warp; t < NT; t += NWARPS) {
    bf16* yr = a.y + token_offset(t);
    for (int i = lane; i < c; i += 32) yr[i] = __float2bfloat16(xs[t * LDX + i]);
  }
}

template <int WS>
int launch_block(const BlockArgs& a, cudaStream_t stream) {
  // The shared-memory opt-in is a per-device attribute: set it on the
  // current device at every launch (a few microseconds).
  const cudaError_t err = cudaFuncSetAttribute(
      swin_block_kernel<WS>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long windows = static_cast<long long>(a.batch) * (a.h / WS) * (a.w / WS);
  if (windows == 0) return 0;
  swin_block_kernel<WS><<<static_cast<unsigned int>(windows), NTHREADS, SMEM_BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sr_swin_block_bf16(const void* x, const void* extra, void* y, const void* g1,
                                  const void* b1, const void* g2, const void* b2,
                                  const void* wqkv, const void* bqkv, const void* wproj,
                                  const void* bproj, const void* wfc1, const void* bfc1,
                                  const void* wfc2, const void* bfc2, const void* rpb,
                                  const void* mask, const void* scales, int batch, int h, int w,
                                  int c, int nh, int ws, int shift, int gelu_tanh, float eps,
                                  void* stream) {
  BlockArgs a;
  a.x = static_cast<const bf16*>(x);
  a.extra = static_cast<const bf16*>(extra);
  a.y = static_cast<bf16*>(y);
  a.g1 = static_cast<const float*>(g1);
  a.b1 = static_cast<const float*>(b1);
  a.g2 = static_cast<const float*>(g2);
  a.b2 = static_cast<const float*>(b2);
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.bqkv = static_cast<const float*>(bqkv);
  a.wproj = static_cast<const bf16*>(wproj);
  a.bproj = static_cast<const float*>(bproj);
  a.wfc1 = static_cast<const bf16*>(wfc1);
  a.bfc1 = static_cast<const float*>(bfc1);
  a.wfc2 = static_cast<const bf16*>(wfc2);
  a.bfc2 = static_cast<const float*>(bfc2);
  a.rpb = static_cast<const float*>(rpb);
  a.mask = static_cast<const float*>(mask);
  a.scales = static_cast<const float*>(scales);
  a.batch = batch;
  a.h = h;
  a.w = w;
  a.c = c;
  a.nh = nh;
  a.shift = shift;
  a.gelu_tanh = gelu_tanh;
  a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ws) {
    case 7:
      return launch_block<7>(a, s);
    case 8:
      return launch_block<8>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
