// K8 — HAT's fused OCAB core, forward and backward: cross-window
// attention -> proj -> residual -> LN2 -> MLP -> residual, one CTA per
// query window.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_ocab.py
//           fused_ocab_core: _fwd_kernel (pallas_call at :311) and
//           _bwd_kernel (pallas_call at :354).
// Math (per window: Nq = ws^2 queries, Nk = ows^2 keys, nh heads of hd,
//       C <= 192 channels, MLP hidden <= 384):
//         A_h  = softmax(q_h k_h^T + bias[h])     (q pre-scaled, fp32)
//         x1   = sw + proj(concat_h bf16(A_h v_h))
//         out  = x1 + fc2(gelu(fc1(LN2(x1))))
//       and the backward of that for the cotangent ct:
//         dmlp = bf16(ct)  dWfc2, dbfc2 = sum ct (fp32)
//         dh1  = bf16(dmlp Wfc2 * gelu'(h1))   dWfc1, dbfc1
//         dx1  = ct + LN2^T(dh1 Wfc1)   dg2, db2;  dsw = dx1
//         dattn = bf16(dx1)  dWproj, dbproj = sum dx1 (fp32)
//         do   = bf16(dattn Wproj); per head dV = A^T do, dA = do V^T,
//                dS = A (dA - rowsum(dA A)), dQ = dS K, dK = dS^T Q,
//                d bias[h] = sum over windows of dS (fp32)
//       with bf16 GEMM operands and fp32 accumulation, casting to bf16
//       where the JAX kernels cast (kernels/fused_ocab.py holds the plain
//       versions).  The caller keeps the JAX split: LN1, the qkv product
//       and the overlap gather run outside as plain ops, whose autograd
//       scatters dk / dv back; the zero-padded border keys of the gather
//       are real keys (score = bias alone) and are not masked.
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
//       bf16.  Shared memory (ws 7 / ws 8): 204 / 216 KB.  The backward
//       recomputes the forward per window and chains the cotangent; its
//       weight gradients are deterministic: the per-window kernel
//       writes the operand pairs (o, dattn), (y2c, dh1), (a, dmlp) to a
//       bf16 workspace and its bias / LayerNorm / dS partial sums to an
//       fp32 one, then csrc/wgrad.cuh's split-K products and ordered
//       reductions sum them.  Pad query rows carry zero sw and zero ct;
//       pad key rows zero k and v with -inf scores, so every gradient
//       operand is exactly zero on them.
#include "common.cuh"
#include "swin_common.cuh"
#include "wgrad.cuh"

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

// Offsets in a window's fp32 partial-sum vector (kernels/fused_ocab.py
// _VEC_OFFSETS); the per-head dS [nh][Nq][Nk] follows at VEC_LEN.
constexpr int V_G2 = 0, V_B2 = CP, V_BPROJ = 2 * CP, V_BFC1 = 3 * CP, V_BFC2 = 3 * CP + HIDP,
              VEC_LEN = 4 * CP + HIDP;

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
  static_assert(NQP * LDS * 4 <= NQP * LDX * 4, "fp32 dA must fit the residual buffer");
  static_assert(NQP * LDX * 4 <= OFF_BIG - OFF_Y, "fp32 dy must fit the two bf16 buffers");
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
  const bf16* ct;  // backward: [windows, Nq, c]
  bf16* out;       // forward: [windows, Nq, c]
  bf16* dq;        // backward outputs, shaped as q, k, v, sw
  bf16* dk;
  bf16* dv;
  bf16* dsw;
  const bf16* wproj;  // [CP, CP], input columns head-padded to HDP
  const float* bproj;
  const float* g2;
  const float* b2;
  const bf16* wfc1;   // [HIDP, CP]
  const float* bfc1;
  const bf16* wfc2;   // [CP, HIDP]
  const float* bfc2;
  const float* bias;  // [nh, Nq, Nk]
  // backward workspace, [windows * NQP][cols]
  bf16* g_o;      // CP
  bf16* g_y2c;    // CP
  bf16* g_act;    // HIDP
  bf16* g_dmlp;   // CP
  bf16* g_dh1;    // HIDP
  bf16* g_dattn;  // CP
  float* g_x1;    // CP
  float* g_h1;    // HIDP
  float* part;    // [windows][vec_len]
  int vec_len;
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

  // LN2 of rs -> ys (bf16, zero pad columns); mean and rstd when asked
  __device__ void layernorm2(float* mu_out = nullptr, float* r_out = nullptr) {
    layernorm_rows<NQP, NWARPS>(rs, LDX, ys, LDY, CP, a.g2, a.b2, a.c, a.eps, warp, lane, mu_out,
                                r_out);
  }

  // 16 x 16 accumulator tile -> rows [r0, r0 + 16) x head lanes
  // [c0, c0 + 16) of a [windows, rows, c] output, real rows and lanes only
  __device__ void tile_to_global(Acc& t, bf16* out, int rows, int r0, int hh, int c0) {
    wmma::store_matrix_sync(stg, t, 16, wmma::mem_row_major);
    __syncwarp();
    const int r = r0 + (lane >> 1), cb = c0 + (lane & 1) * 8;
    if (r < rows) {
      bf16* dst = out + (win * rows + r) * a.c + hh * hd;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (cb + i < hd) dst[cb + i] = __float2bfloat16(stg[(lane >> 1) * 16 + (lane & 1) * 8 + i]);
    }
    __syncwarp();
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
__global__ void __launch_bounds__(NTHREADS, 1) ocab_bwd_kernel(const __grid_constant__ OcabArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using K = Ocab<WS, OWS>;
  using S = typename K::S;
  constexpr int NQ = K::NQ, NK = K::NK, NKP = K::NKP, LDS = K::LDS, LDP = K::LDP;
  K k(a, smem);
  float* dys = reinterpret_cast<float*>(smem + S::OFF_Y);  // fp32 dy over ys + os
  float* das = k.rs;                                        // fp32 dA over the residual
  float* mu2 = reinterpret_cast<float*>(smem + S::OFF_STAT);
  float* r2 = mu2 + NQP;
  const int tid = k.tid, warp = k.warp, lane = k.lane, c = a.c;
  const long long row0 = k.win * NQP;
  float* part = a.part + k.win * a.vec_len;
  auto grow = [&](bf16* base, int ld, int r) { return base + (row0 + r) * ld; };
  // the window's NQP rows of a shared bf16 buffer -> its workspace rows
  auto to_workspace = [&](const bf16* src, int lds, bf16* dst, int cols) {
    copy_rows<NQP, NTHREADS>(src, lds, dst + row0 * cols, cols, cols, tid);
  };
  Acc acc[4];

  // ================= forward recompute =================
  k.load_rows(a.sw);
  for (int i = tid; i < NQP * LDO; i += NTHREADS) k.os[i] = __float2bfloat16(0.f);
  __syncthreads();
  k.attention_forward();
  to_workspace(k.os, LDO, a.g_o, CP);
  k.proj_residual();
  __syncthreads();
  k.layernorm2(mu2, r2);
  __syncthreads();
  for (int i = tid; i < NQP * CP / 4; i += NTHREADS) {
    const int r = i / (CP / 4), cv = (i % (CP / 4)) * 4;
    *reinterpret_cast<float4*>(a.g_x1 + (row0 + r) * CP + cv) =
        *reinterpret_cast<const float4*>(k.rs + r * LDX + cv);
  }
  to_workspace(k.ys, LDY, a.g_y2c, CP);
  // h1 = y2c @ Wfc1^T + bfc1 (fp32 to the workspace), a = bf16(gelu(h1))
  for (int strip = warp; strip < HIDP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip<CP>(acc, k.ys, LDY, a.wfc1, n0);
    strip_epilogue(acc, k.stg, lane, n0, [&](int r, int n, float (&v)[8]) {
      float b[8];
      load8(b, a.bfc1 + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += b[i];
      store8_f32(a.g_h1 + (row0 + r) * HIDP + n, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = gelu(v[i], a.gelu_tanh);
      store8_bf16(grow(a.g_act, HIDP, r) + n, v);
    });
  }
  __syncthreads();

  // ================= backward =================
  // ct -> rs (fp32, pad rows zero), dmlp = bf16(ct) -> ys
  k.load_rows(a.ct);
  __syncthreads();
  for (int i = tid; i < NQP * CP / 8; i += NTHREADS) {
    const int r = i / (CP / 8), cv = (i % (CP / 8)) * 8;
    float v[8];
    load8(v, k.rs + r * LDX + cv);
    store8_bf16(k.ys + r * LDY + cv, v);
  }
  // dbfc2 = sum of the fp32 cotangent
  for (int j = tid; j < CP; j += NTHREADS) {
    float s = 0.f;
    for (int t = 0; t < NQ; ++t) s += k.rs[t * LDX + j];
    part[V_BFC2 + j] = s;
  }
  __syncthreads();
  to_workspace(k.ys, LDY, a.g_dmlp, CP);
  // dh1 = bf16((dmlp @ Wfc2) * gelu'(h1)) -> big
  bf16* dh = k.big;
  for (int strip = warp; strip < HIDP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip_kn<CP>(acc, k.ys, LDY, a.wfc2, HIDP, n0);
    strip_epilogue(acc, k.stg, lane, n0, [&](int r, int n, float (&v)[8]) {
      float hv[8];
      load8(hv, a.g_h1 + (row0 + r) * HIDP + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= gelu_grad(hv[i], a.gelu_tanh);
      store8_bf16(dh + r * LDH + n, v);
      store8_bf16(grow(a.g_dh1, HIDP, r) + n, v);
    });
  }
  __syncthreads();
  column_sums<NQP, NTHREADS>(dh, LDH, HIDP, part + V_BFC1, tid);
  // dy2 = dh1 @ Wfc1 -> dys (fp32, over ys and os: o is in the workspace)
  for (int strip = warp; strip < CP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip_kn<HIDP>(acc, dh, LDH, a.wfc1, CP, n0);
    strip_epilogue(acc, k.stg, lane, n0,
                   [&](int r, int n, float (&v)[8]) { store8_f32(dys + r * LDX + n, v); });
  }
  __syncthreads();

  // LN2 backward over the real rows: dg2, db2 partials; dx1 = ct +
  // LN2^T(dy2) in rs; dsw = dx1 (each lane reads back what it wrote)
  layernorm_backward_rows<NWARPS, NTHREADS>(
      dys, k.rs, LDX, a.g2, mu2, r2, [&](int t, int i) { return a.g_x1[(row0 + t) * CP + i]; },
      NQ, c, part + V_G2, part + V_B2, tid, warp, lane);
  for (int t = warp; t < NQ; t += NWARPS) {
    bf16* dst = a.dsw + (k.win * NQ + t) * c;
    for (int i = lane; i < c; i += 32) dst[i] = __float2bfloat16(k.rs[t * LDX + i]);
  }
  __syncthreads();
  // dbproj = sum of the fp32 dx1; dattn = bf16(dx1) -> ys
  for (int j = tid; j < CP; j += NTHREADS) {
    float s = 0.f;
    for (int t = 0; t < NQ; ++t) s += k.rs[t * LDX + j];
    part[V_BPROJ + j] = s;
  }
  for (int i = tid; i < NQP * CP / 8; i += NTHREADS) {
    const int r = i / (CP / 8), cv = (i % (CP / 8)) * 8;
    float v[8];
    load8(v, k.rs + r * LDX + cv);
    store8_bf16(k.ys + r * LDY + cv, v);
  }
  __syncthreads();
  to_workspace(k.ys, LDY, a.g_dattn, CP);
  // do = bf16(dattn @ Wproj) -> os
  for (int strip = warp; strip < CP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip_kn<CP>(acc, k.ys, LDY, a.wproj, CP, n0);
    strip_epilogue(acc, k.stg, lane, n0,
                   [&](int r, int n, float (&v)[8]) { store8_bf16(k.os + r * LDO + n, v); });
  }
  __syncthreads();

  // attention backward, one head at a time (dA over the residual buffer)
  for (int hh = 0; hh < a.nh; ++hh) {
    k.load_head(hh);
    __syncthreads();
    k.scores();
    __syncthreads();
    k.softmax(hh);
    __syncthreads();
    constexpr int KT = NKP / 16;
    for (int tile = warp; tile < KT * 2 + 4 * KT; tile += NWARPS) {
      Acc t;
      wmma::fill_fragment(t, 0.f);
      if (tile < KT * 2) {  // dV = A^T do  (rows: keys)
        const int mt = tile >> 1, nt = tile & 1;
#pragma unroll
        for (int kk = 0; kk < NQP; kk += 16) {
          FragAt fa;
          FragB fb;
          wmma::load_matrix_sync(fa, k.ps + kk * LDP + mt * 16, LDP);
          wmma::load_matrix_sync(fb, k.os + kk * LDO + hh * HDP + nt * 16, LDO);
          wmma::mma_sync(t, fa, fb, t);
        }
        k.tile_to_global(t, a.dv, NK, mt * 16, hh, nt * 16);
      } else {  // dA = do V^T
        const int i = tile - KT * 2, mt = i / KT, nt = i % KT;
#pragma unroll
        for (int kk = 0; kk < HDP; kk += 16) {
          FragA fa;
          FragBt fb;
          wmma::load_matrix_sync(fa, k.os + mt * 16 * LDO + hh * HDP + kk, LDO);
          wmma::load_matrix_sync(fb, k.vh + nt * 16 * LDHD + kk, LDHD);
          wmma::mma_sync(t, fa, fb, t);
        }
        wmma::store_matrix_sync(das + mt * 16 * LDS + nt * 16, t, LDS, wmma::mem_row_major);
      }
    }
    __syncthreads();
    // dS = A (dA - rowsum(dA A)): fp32 partial for d bias, bf16 into ps
    constexpr int PER_LANE = (NKP + 31) / 32;
    float* dsp = part + VEC_LEN + static_cast<long long>(hh) * NQ * NK;
    for (int r = warp; r < NQP; r += NWARPS) {
      float dot = 0.f;
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) {
        const int j = lane + 32 * u;
        if (j < NKP) dot += k.ss[r * LDS + j] * das[r * LDS + j];
      }
      dot = warp_sum(dot);
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) {
        const int j = lane + 32 * u;
        if (j < NKP) {
          const float d = k.ss[r * LDS + j] * (das[r * LDS + j] - dot);
          k.ps[r * LDP + j] = __float2bfloat16(d);
          if (r < NQ && j < NK) dsp[r * NK + j] = d;
        }
      }
    }
    __syncthreads();
    for (int tile = warp; tile < 8 + KT * 2; tile += NWARPS) {
      Acc t;
      wmma::fill_fragment(t, 0.f);
      if (tile < 8) {  // dQ = dS K
        const int mt = tile >> 1, nt = tile & 1;
#pragma unroll
        for (int kk = 0; kk < NKP; kk += 16) {
          FragA fa;
          FragB fb;
          wmma::load_matrix_sync(fa, k.ps + mt * 16 * LDP + kk, LDP);
          wmma::load_matrix_sync(fb, k.kh + kk * LDHD + nt * 16, LDHD);
          wmma::mma_sync(t, fa, fb, t);
        }
        k.tile_to_global(t, a.dq, NQ, mt * 16, hh, nt * 16);
      } else {  // dK = dS^T Q
        const int i = tile - 8, mt = i >> 1, nt = i & 1;
#pragma unroll
        for (int kk = 0; kk < NQP; kk += 16) {
          FragAt fa;
          FragB fb;
          wmma::load_matrix_sync(fa, k.ps + kk * LDP + mt * 16, LDP);
          wmma::load_matrix_sync(fb, k.qh + kk * LDHD + nt * 16, LDHD);
          wmma::mma_sync(t, fa, fb, t);
        }
        k.tile_to_global(t, a.dk, NK, mt * 16, hh, nt * 16);
      }
    }
    __syncthreads();
  }
}

template <int WS, int OWS>
int launch(const OcabArgs& a, long long windows, bool backward, cudaStream_t stream) {
  constexpr int smem = Shape<WS, OWS>::SMEM_BYTES;
  auto kernel = backward ? ocab_bwd_kernel<WS, OWS> : ocab_fwd_kernel<WS, OWS>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(windows), NTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const OcabArgs& a, long long windows, int ws, int ows, bool backward,
             cudaStream_t stream) {
  if (ws == 7 && ows == 10) return launch<7, 10>(a, windows, backward, stream);
  if (ws == 8 && ows == 12) return launch<8, 12>(a, windows, backward, stream);
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
  return dispatch(a, windows, ws, ows, false, static_cast<cudaStream_t>(stream));
}

extern "C" int sr_ocab_bwd_bf16(const void* ct, const void* q, const void* k, const void* v,
                                const void* sw, void* dq, void* dk, void* dv, void* dsw,
                                const void* wproj, const void* bproj, const void* g2,
                                const void* b2, const void* wfc1, const void* bfc1,
                                const void* wfc2, const void* bfc2, const void* bias, void* ws16,
                                void* ws32, void* part_win, void* part_w, void* vec,
                                void* wgrad, int windows, int c, int nh, int ws, int ows,
                                int gelu_tanh, float eps, int splits, int rows, void* stream) {
  if (windows == 0) return 0;
  const long long tokens = static_cast<long long>(windows) * NQP;  // workspace rows
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  OcabArgs a = weights_args(wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2, bias, c, nh,
                            gelu_tanh, eps);
  a.ct = static_cast<const bf16*>(ct);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.sw = static_cast<const bf16*>(sw);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dsw = static_cast<bf16*>(dsw);
  // bf16 workspace segments in the order of kernels/fused_ocab.py
  // K8_BF16_COLS: o, y2c, act, dmlp, dh1, dattn; fp32: x1, h1
  bf16* p16 = static_cast<bf16*>(ws16);
  bf16** segs16[] = {&a.g_o, &a.g_y2c, &a.g_act, &a.g_dmlp, &a.g_dh1, &a.g_dattn};
  const int cols16[] = {CP, CP, HIDP, CP, HIDP, CP};
  for (int i = 0; i < 6; ++i) {
    *segs16[i] = p16;
    p16 += tokens * cols16[i];
  }
  a.g_x1 = static_cast<float*>(ws32);
  a.g_h1 = a.g_x1 + tokens * CP;
  a.part = static_cast<float*>(part_win);
  a.vec_len = VEC_LEN + nh * (ws * ws) * (ows * ows);
  const int status = dispatch(a, windows, ws, ows, true, st);
  if (status != 0) return status;

  const bf16* gs[] = {a.g_dattn, a.g_dh1, a.g_dmlp};
  const bf16* acts[] = {a.g_o, a.g_y2c, a.g_act};
  const int ms[] = {CP, HIDP, CP};
  const int ns[] = {CP, CP, HIDP};
  const int wstatus = weight_grads(gs, acts, ms, ns, 3, tokens, splits, rows,
                                   static_cast<float*>(part_w), static_cast<float*>(wgrad), st);
  if (wstatus != 0) return wstatus;
  return reduce_rows(static_cast<const float*>(part_win), windows, a.vec_len,
                     static_cast<float*>(vec), st);
}
