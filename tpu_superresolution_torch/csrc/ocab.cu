// K8 — HAT's fused OCAB core at windows 7 and 8, forward: cross-window
// attention -> proj -> residual -> LN2 -> MLP -> residual, one CTA per
// query window.  Its backward, K8b, is csrc/ocab_bwd.cu.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_ocab.py
//           fused_ocab_core: _fwd_kernel (pallas_call at :311).
// Math (per window: Nq = ws^2 queries, Nk = ows^2 keys, nh heads of hd,
//       C <= 192 channels, MLP hidden <= 384):
//         A_h  = softmax(q_h k_h^T + bias[h])     (q pre-scaled, fp32)
//         x1   = sw + proj(concat_h bf16(A_h v_h))
//         out  = x1 + fc2(gelu(fc1(LN2(x1))))
//       with bf16 GEMM operands and fp32 accumulation, casting to bf16
//       where the JAX kernels cast (kernels/fused_ocab.py holds the plain
//       versions).  The caller keeps the JAX split: LN1, the qkv product
//       and the overlap gather run outside as plain ops; the zero-padded
//       border keys of the gather are real keys (score = bias alone) and
//       are not masked.
// Bound on the H100: at HAT's train shape (800 windows, C 96, 6 heads of
//       16, hidden 384, 49 queries x 100 keys) the forward does ~8 GFLOP
//       of bf16 products at the unpadded widths against ~53 MB in and
//       out: bandwidth-bound at ~16 us.  This first version pads like
//       the block kernels (C -> 192, hd -> 32, queries -> 64 rows, keys
//       -> a multiple of 16) and runs one window per SM; PERF.md has its
//       times.
// Design: one 384-thread CTA per window with the block kernels' WMMA
//       strip GEMMs (csrc/swin_common.cuh).  q, k and v are loaded one
//       head at a time into [rows][40] bf16 tiles (zero-padded to 32
//       lanes), so the per-window K / V footprint is small; the
//       probabilities of one head live in shared memory as fp32 and
//       bf16.  Shared memory (ws 7 / ws 8): 204 / 216 KB.
#include "common.cuh"
#include "swin_common.cuh"

namespace {

constexpr int NQP = 64;  // query rows of every buffer
constexpr int CP = 192;
constexpr int HDP = 32;
constexpr int HIDP = 384;
constexpr int NWARPS = 12;
constexpr int NTHREADS = NWARPS * 32;

constexpr int LDX = CP;        // fp32
constexpr int LDY = CP + 8;    // bf16
constexpr int LDO = CP + 8;    // bf16
constexpr int LDH = HIDP + 8;  // bf16
constexpr int LDHD = HDP + 8;  // bf16, one head's q / k / v

template <int WS, int OWS>
struct Shape {
  static constexpr int NQ = WS * WS;
  static constexpr int NK = OWS * OWS;
  static constexpr int NKP = (NK + 15) / 16 * 16;  // key rows, whole WMMA tiles
  static constexpr int LDS = NKP + 4;              // fp32
  static constexpr int LDP = NKP + 8;              // bf16
  static constexpr int OFF_R = 0;
  static constexpr int OFF_Y = OFF_R + NQP * LDX * 4;
  static constexpr int OFF_O = OFF_Y + NQP * LDY * 2;
  static constexpr int OFF_BIG = OFF_O + NQP * LDO * 2;
  static constexpr int BIG_BYTES = NQP * LDH * 2;
  static constexpr int OFF_S = OFF_BIG + BIG_BYTES;
  static constexpr int OFF_P = OFF_S + NQP * LDS * 4;
  static constexpr int OFF_STG = OFF_P + NQP * LDP * 2;
  static constexpr int OFF_STAT = OFF_STG + NWARPS * 256 * 4;
  static constexpr int SMEM_BYTES = OFF_STAT + 2 * NQP * 4;
  static_assert(NQ <= NQP && NQP - NQ < 16, "the query pad must stay under one WMMA tile");
  static_assert(SMEM_BYTES <= 232448, "over the 227 KB shared-memory limit");
  static_assert((NQP + 2 * NKP) * LDHD * 2 <= BIG_BYTES, "one head's q, k, v must fit");
  static_assert(OFF_Y % 128 == 0 && OFF_O % 128 == 0 && OFF_BIG % 128 == 0 &&
                    OFF_S % 128 == 0 && OFF_P % 128 == 0 && OFF_STG % 128 == 0 &&
                    OFF_STAT % 128 == 0,
                "shared buffers must stay 128-byte aligned");
};

struct OcabArgs {
  const bf16* q;   // [windows, Nq, c], pre-scaled
  const bf16* k;   // [windows, Nk, c]
  const bf16* v;   // [windows, Nk, c]
  const bf16* sw;  // [windows, Nq, c]
  bf16* out;       // [windows, Nq, c]
  const bf16* wproj;  // [CP, CP], input columns head-padded to HDP
  const float* bproj;
  const float* g2;
  const float* b2;
  const bf16* wfc1;   // [HIDP, CP]
  const float* bfc1;
  const bf16* wfc2;   // [CP, HIDP]
  const float* bfc2;
  const float* bias;  // [nh, Nq, Nk]
  int c, nh, gelu_tanh;
  float eps;
};

template <int WS, int OWS>
struct Ocab {
  using S = Shape<WS, OWS>;
  static constexpr int NQ = S::NQ, NK = S::NK, NKP = S::NKP, LDS = S::LDS, LDP = S::LDP;

  const OcabArgs& a;
  unsigned char* smem;
  int tid, warp, lane, hd;
  long long win;
  float* rs;
  bf16* ys;
  bf16* os;
  bf16* big;
  float* ss;
  bf16* ps;
  float* stg;
  bf16* qh;
  bf16* kh;
  bf16* vh;

  __device__ Ocab(const OcabArgs& args, unsigned char* sm) : a(args), smem(sm) {
    tid = threadIdx.x;
    warp = tid >> 5;
    lane = tid & 31;
    hd = a.c / a.nh;
    win = blockIdx.x;
    rs = reinterpret_cast<float*>(smem + S::OFF_R);
    ys = reinterpret_cast<bf16*>(smem + S::OFF_Y);
    os = reinterpret_cast<bf16*>(smem + S::OFF_O);
    big = reinterpret_cast<bf16*>(smem + S::OFF_BIG);
    ss = reinterpret_cast<float*>(smem + S::OFF_S);
    ps = reinterpret_cast<bf16*>(smem + S::OFF_P);
    stg = reinterpret_cast<float*>(smem + S::OFF_STG) + warp * 256;
    qh = big;
    kh = qh + NQP * LDHD;
    vh = kh + NKP * LDHD;
  }

  // rows [win][0:n][0:c] of a [windows, n, c] tensor -> fp32 rs (zero pad)
  __device__ void load_rows(const bf16* src) {
    const bf16* base = src + win * NQ * a.c;
    for (int t = warp; t < NQP; t += NWARPS)
      for (int i = lane; i < CP; i += 32)
        rs[t * LDX + i] = (t < NQ && i < a.c) ? __bfloat162float(base[t * a.c + i]) : 0.f;
  }

  // head hh of q, k, v -> [rows][LDHD] bf16 tiles, zero past hd and past
  // the real rows
  __device__ void load_head(int hh) {
    const bf16* qb = a.q + win * NQ * a.c + hh * hd;
    const bf16* kb = a.k + win * NK * a.c + hh * hd;
    const bf16* vb = a.v + win * NK * a.c + hh * hd;
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < NQP * HDP; i += NTHREADS) {
      const int r = i / HDP, j = i % HDP;
      qh[r * LDHD + j] = (r < NQ && j < hd) ? qb[r * a.c + j] : zero;
    }
    for (int i = tid; i < NKP * HDP; i += NTHREADS) {
      const int r = i / HDP, j = i % HDP;
      const bool real = r < NK && j < hd;
      kh[r * LDHD + j] = real ? kb[r * a.c + j] : zero;
      vh[r * LDHD + j] = real ? vb[r * a.c + j] : zero;
    }
  }

  // S = q_h k_h^T -> ss (fp32)
  __device__ void scores() {
    for (int tile = warp; tile < 4 * (NKP / 16); tile += NWARPS) {
      const int mt = tile / (NKP / 16), nt = tile % (NKP / 16);
      Acc s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int k = 0; k < HDP; k += 16) {
        FragA fa;
        FragBt fb;
        wmma::load_matrix_sync(fa, qh + mt * 16 * LDHD + k, LDHD);
        wmma::load_matrix_sync(fb, kh + nt * 16 * LDHD + k, LDHD);
        wmma::mma_sync(s, fa, fb, s);
      }
      wmma::store_matrix_sync(ss + mt * 16 * LDS + nt * 16, s, LDS, wmma::mem_row_major);
    }
  }

  // A = softmax(S + bias[hh]) in fp32 -> ss (fp32) and ps (bf16), one
  // warp per row.  Pad key columns get -inf (probability 0); pad query
  // rows get no bias (finite, never stored).  Column 0 is a real key.
  __device__ void softmax(int hh) {
    constexpr int PER_LANE = (NKP + 31) / 32;
    const float* bh = a.bias + static_cast<long long>(hh) * NQ * NK;
    for (int r = warp; r < NQP; r += NWARPS) {
      float v[PER_LANE];
      float m = -__int_as_float(0x7f800000);
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) {
        const int j = lane + 32 * u;
        v[u] = -__int_as_float(0x7f800000);
        if (j < NK) v[u] = ss[r * LDS + j] + (r < NQ ? bh[r * NK + j] : 0.f);
        m = fmaxf(m, v[u]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) {
        v[u] = expf(v[u] - m);
        sum += v[u];
      }
      const float inv = 1.f / warp_sum(sum);
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) {
        const int j = lane + 32 * u;
        if (j < NKP) {
          ss[r * LDS + j] = v[u] * inv;
          ps[r * LDP + j] = __float2bfloat16(v[u] * inv);
        }
      }
    }
  }

  // the attention output of every head -> os (bf16, head-padded columns)
  __device__ void attention_forward() {
    for (int hh = 0; hh < a.nh; ++hh) {
      load_head(hh);
      __syncthreads();
      scores();
      __syncthreads();
      softmax(hh);
      __syncthreads();
      for (int tile = warp; tile < 8; tile += NWARPS) {
        const int mt = tile >> 1, nt = tile & 1;
        Acc o;
        wmma::fill_fragment(o, 0.f);
#pragma unroll
        for (int k = 0; k < NKP; k += 16) {
          FragA fa;
          FragB fb;
          wmma::load_matrix_sync(fa, ps + mt * 16 * LDP + k, LDP);
          wmma::load_matrix_sync(fb, vh + k * LDHD + nt * 16, LDHD);
          wmma::mma_sync(o, fa, fb, o);
        }
        wmma::store_matrix_sync(stg, o, 16, wmma::mem_row_major);
        __syncwarp();
        float v[8];
        load8(v, stg + (lane >> 1) * 16 + (lane & 1) * 8);
        store8_bf16(os + (mt * 16 + (lane >> 1)) * LDO + hh * HDP + nt * 16 + (lane & 1) * 8, v);
        __syncwarp();
      }
      __syncthreads();
    }
  }

  // rs += o @ Wproj^T + bproj (x1 = sw + attention, fp32)
  __device__ void proj_residual() {
    Acc acc[4];
    for (int strip = warp; strip < CP / 16; strip += NWARPS) {
      const int n0 = strip * 16;
      gemm_strip<CP>(acc, os, LDO, a.wproj, n0);
      strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
        float b[8], x[8];
        load8(b, a.bproj + n);
        load8(x, rs + r * LDX + n);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] += v[i] + b[i];
        store8_f32(rs + r * LDX + n, x);
      });
    }
  }

  // LN2 of rs -> ys (bf16, zero pad columns)
  __device__ void layernorm2() {
    layernorm_rows<NQP, NWARPS>(rs, LDX, ys, LDY, CP, a.g2, a.b2, a.c, a.eps, warp, lane);
  }
};

template <int WS, int OWS>
__global__ void __launch_bounds__(NTHREADS, 1) ocab_fwd_kernel(const __grid_constant__ OcabArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ocab<WS, OWS> k(a, smem);
  constexpr int NQ = Ocab<WS, OWS>::NQ;
  k.load_rows(a.sw);
  for (int i = k.tid; i < NQP * LDO; i += NTHREADS) k.os[i] = __float2bfloat16(0.f);
  __syncthreads();
  k.attention_forward();
  k.proj_residual();
  __syncthreads();
  k.layernorm2();
  __syncthreads();
  // MLP: fc1 -> GELU -> hidden (bf16, over the q / k / v tiles) -> fc2
  bf16* hs = k.big;
  Acc acc[4];
  for (int strip = k.warp; strip < HIDP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip<CP>(acc, k.ys, LDY, a.wfc1, n0);
    strip_epilogue(acc, k.stg, k.lane, n0, [&](int r, int n, float (&v)[8]) {
      float b[8];
      load8(b, a.bfc1 + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = gelu(v[i] + b[i], a.gelu_tanh);
      store8_bf16(hs + r * LDH + n, v);
    });
  }
  __syncthreads();
  for (int strip = k.warp; strip < CP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip<HIDP>(acc, hs, LDH, a.wfc2, n0);
    strip_epilogue(acc, k.stg, k.lane, n0, [&](int r, int n, float (&v)[8]) {
      if (r >= NQ) return;
      float b[8], x[8];
      load8(b, a.bfc2 + n);
      load8(x, k.rs + r * LDX + n);
      bf16* dst = a.out + (k.win * NQ + r) * a.c;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (n + i < a.c) dst[n + i] = __float2bfloat16(x[i] + v[i] + b[i]);
    });
  }
}

template <int WS, int OWS>
int launch(const OcabArgs& a, long long windows, cudaStream_t stream) {
  constexpr int smem = Shape<WS, OWS>::SMEM_BYTES;
  auto kernel = ocab_fwd_kernel<WS, OWS>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(windows), NTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const OcabArgs& a, long long windows, int ws, int ows, cudaStream_t stream) {
  if (ws == 7 && ows == 10) return launch<7, 10>(a, windows, stream);
  if (ws == 8 && ows == 12) return launch<8, 12>(a, windows, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

OcabArgs weights_args(const void* wproj, const void* bproj, const void* g2, const void* b2,
                      const void* wfc1, const void* bfc1, const void* wfc2, const void* bfc2,
                      const void* bias, int c, int nh, int gelu_tanh, float eps) {
  OcabArgs a = {};
  a.wproj = static_cast<const bf16*>(wproj);
  a.bproj = static_cast<const float*>(bproj);
  a.g2 = static_cast<const float*>(g2);
  a.b2 = static_cast<const float*>(b2);
  a.wfc1 = static_cast<const bf16*>(wfc1);
  a.bfc1 = static_cast<const float*>(bfc1);
  a.wfc2 = static_cast<const bf16*>(wfc2);
  a.bfc2 = static_cast<const float*>(bfc2);
  a.bias = static_cast<const float*>(bias);
  a.c = c;
  a.nh = nh;
  a.gelu_tanh = gelu_tanh;
  a.eps = eps;
  return a;
}

}  // namespace

extern "C" int sr_ocab_fwd_bf16(const void* q, const void* k, const void* v, const void* sw,
                                void* out, const void* wproj, const void* bproj, const void* g2,
                                const void* b2, const void* wfc1, const void* bfc1,
                                const void* wfc2, const void* bfc2, const void* bias,
                                int windows, int c, int nh, int ws, int ows, int gelu_tanh,
                                float eps, void* stream) {
  if (windows == 0) return 0;
  OcabArgs a = weights_args(wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2, bias, c, nh,
                            gelu_tanh, eps);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.sw = static_cast<const bf16*>(sw);
  a.out = static_cast<bf16*>(out);
  return dispatch(a, windows, ws, ows, static_cast<cudaStream_t>(stream));
}
