// K5 and K6's backward — the backward of one Swin transformer block (the
// gradient of csrc/swin_block.cu), for window size 8 (K5) or 7 (K6's
// backward), with the gradient of HAT's additive term `extra`.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_block.py
//           K5  _mega_backward -> _bwd_kernel (pallas_call at :1080),
//               with and without `extra` (has_extra);
//           K6  _packed_backward -> _bwd_kernel (pallas_call at :1604),
//               the same arithmetic on windows the caller partitioned and
//               token-padded in HBM.  This kernel reads the windows from
//               the spatial map, so one source serves both.
// Math: recompute the forward for each window (LN1 -> qkv -> per-head
//       softmax(q k^T + rpb + mask) -> AV -> proj -> x1 = x + m1 attn
//       + extra -> LN2 -> fc1 -> GELU), then chain the cotangent ct:
//         dmlp = bf16(ct m2)        dWfc2 = dmlp^T a,   dbfc2 = sum dmlp
//         dh1  = bf16(dmlp Wfc2 * gelu'(h1))   dWfc1, dbfc1
//         dx1  = ct + LN2^T(dh1 Wfc1)  (fast-variance form; dg2, db2)
//         dextra = dx1  (when the forward had `extra`)
//         dattn = bf16(dx1 m1)      dWproj, dbproj
//         do   = bf16(dattn Wproj); per head: dV = A^T do,
//                dS = A (dA - rowsum(dA A)) with dA = do V^T,
//                dQ = dS K, dK = dS^T Q (dS, dq, dk, dv in bf16)
//         dx   = dx1 + LN1^T(dqkv Wqkv)     dWqkv, dbqkv, dg1, db1
//       with bf16 GEMM operands and fp32 accumulation, casting to bf16
//       at the JAX kernel's points, so the kernel and the plain bf16
//       version (kernels/fused_block.py::swin_block_bwd_plain) round
//       alike.  Gradients come out in the packed layout of the forward's
//       weights ([out, in], q pre-scaled, heads and channels
//       zero-padded); the wrapper maps them to raw weight space.
// Bound on the H100: at SwinIR's train shape [8,64,64,180] the block's
//       backward does ~51 GFLOP of bf16 products at the unpadded widths
//       (14 recompute without fc2, 17 activation gradients, 3 attention
//       backward, 17 the four weight-gradient products) against ~37 MB
//       in and out, so it is compute-bound: ~52 us at the 989 TFLOP/s
//       bf16 peak; HAT's at [8,70,70,96] ~25 GFLOP, ~26 us.  The WMMA
//       kernels below run at a few % of the peak (PERF.md).
// Design: the TPU kernel sums the weight gradients in VMEM across a
//       sequential grid; a Hopper grid has no order.  So the work is
//       three deterministic launches:
//       K5a  one 384-thread CTA per window (the forward's shift-by-
//            addressing: it reads x, extra and ct at the shifted pixels
//            and writes dx and dextra there, with the same mask).  It
//            writes each window's GEMM operand pairs (yc, dqkv), (o,
//            dattn), (y2c, dh1), (a, dmlp) to a bf16 workspace, the
//            per-window LayerNorm and bias partial sums and dS to an
//            fp32 workspace, and dx.  It holds one head's A and dS at a
//            time and keeps 210 KB of shared memory: the fp32 residual /
//            cotangent [64][192], a 73 KB bf16 buffer that holds qkv,
//            then the MLP gradient, then qkv again (reloaded from the
//            workspace) and finally dqkv, two bf16 [64][200] buffers
//            that alias an fp32 [64][192] one, the score / probability
//            tiles and the per-warp staging.  x1 and h1 (fp32) go
//            through the workspace too.
//       K5b, K5c  csrc/wgrad.cuh: split-K WMMA weight-gradient products
//            and ordered reductions.
// Token padding (ws 7): every buffer keeps NTP = 64 token rows, as in
//       the forward.  Rows 49..63 have zero x and zero cotangent, so
//       every gradient operand (dmlp, dh1, dattn, dqkv) is exactly zero
//       there and they add nothing to a weight-gradient product, bias sum
//       or LayerNorm sum; their activations (LN of a zero row = b) stay
//       finite.  Key columns 49..63 get -inf scores, so A and dS are
//       exactly 0 there.  The ws-7 rpb and mask rows are not 16-byte
//       aligned and are read as scalars; the rpb gradient is written as
//       [nh][49][49] per window.
#include "common.cuh"
#include "swin_common.cuh"
#include "wgrad.cuh"

namespace {

constexpr int NTP = 64;  // token rows of every buffer: a window's WS*WS, padded
constexpr int CP = 192;
constexpr int HDP = 32;
constexpr int QKVP = 3 * CP;
constexpr int HIDP = 384;
constexpr int NWARPS = 12;
constexpr int NTHREADS = NWARPS * 32;

constexpr int LDX = CP;          // fp32
constexpr int LDY = CP + 8;      // bf16
constexpr int LDQKV = QKVP + 8;  // bf16
constexpr int LDH = HIDP + 8;    // bf16
constexpr int LDS = NTP + 4;     // fp32
constexpr int LDP = NTP + 8;     // bf16
constexpr int LDO = CP + 8;      // bf16

constexpr int OFF_R = 0;
constexpr int OFF_BIG = OFF_R + NTP * LDX * 4;
constexpr int OFF_Y = OFF_BIG + NTP * LDQKV * 2;
constexpr int OFF_O = OFF_Y + NTP * LDY * 2;
constexpr int OFF_S = OFF_O + NTP * LDO * 2;
constexpr int OFF_P = OFF_S + NTP * LDS * 4;
constexpr int OFF_STG = OFF_P + NTP * LDP * 2;
constexpr int OFF_STAT = OFF_STG + NWARPS * 256 * 4;
constexpr int SMEM_BYTES = OFF_STAT + 4 * NTP * 4;
static_assert(SMEM_BYTES <= 232448, "over the 227 KB shared-memory limit");
static_assert(NTP * LDH <= NTP * LDQKV, "the MLP gradient must fit the qkv buffer");
static_assert(NTP * LDX * 4 <= OFF_S - OFF_Y, "fp32 dy must fit the two bf16 buffers");
static_assert(NTP * LDS * 4 <= OFF_O - OFF_Y, "fp32 dA must fit the first bf16 buffer");
static_assert(OFF_BIG % 128 == 0 && OFF_Y % 128 == 0 && OFF_O % 128 == 0 && OFF_S % 128 == 0 &&
                  OFF_P % 128 == 0 && OFF_STG % 128 == 0 && OFF_STAT % 128 == 0,
              "shared buffers must stay 128-byte aligned");

// Offsets in a window's fp32 partial-sum vector (kernels/fused_block.py
// _VEC_OFFSETS); the per-head dS [nh][N][N] (N = ws^2) follows at VEC_LEN.
constexpr int V_G1 = 0, V_B1 = CP, V_G2 = 2 * CP, V_B2 = 3 * CP, V_BQKV = 4 * CP,
              V_BPROJ = 7 * CP, V_BFC1 = 8 * CP, V_BFC2 = 8 * CP + HIDP, VEC_LEN = 9 * CP + HIDP;

struct BwdArgs {
  const bf16* ct;
  const bf16* x;
  const bf16* extra;  // [batch, h, w, c] or null
  bf16* dx;
  bf16* dextra;       // written when extra is not null
  const float* g1;
  const float* b1;
  const float* g2;
  const float* b2;
  const bf16* wqkv;   // [QKVP, CP]
  const float* bqkv;
  const bf16* wproj;  // [CP, CP]
  const float* bproj;
  const bf16* wfc1;   // [HIDP, CP]
  const float* bfc1;
  const bf16* wfc2;   // [CP, HIDP]
  const float* bfc2;
  const float* rpb;   // [nh, N, N]
  const float* mask;  // [nW, N, N] or null
  const float* scales;
  // workspace, [tokens][cols] with tokens (NTP per window) in window-major order
  bf16* g_yc;    // CP
  bf16* g_qkv;   // QKVP
  bf16* g_o;     // CP
  bf16* g_y2c;   // CP
  bf16* g_act;   // HIDP
  bf16* g_dmlp;  // CP
  bf16* g_dh1;   // HIDP
  bf16* g_dattn;  // CP
  bf16* g_dqkv;  // QKVP
  float* g_x1;   // CP
  float* g_h1;   // HIDP
  float* part;   // [windows][vec_len]
  int vec_len;
  int batch, h, w, c, nh, shift, gelu_tanh;
  float eps;
};

template <int WS>
__global__ void __launch_bounds__(NTHREADS, 1) swin_block_bwd_window(const BwdArgs a) {
  constexpr int NT = WS * WS;  // real tokens per window
  static_assert(NT <= NTP && NTP - NT < 16, "the token pad must stay under one WMMA tile");
  extern __shared__ __align__(128) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem + OFF_R);     // x, x1, then ct, dx1
  bf16* big = reinterpret_cast<bf16*>(smem + OFF_BIG);    // qkv / dh1 / qkv / dqkv
  bf16* ys = reinterpret_cast<bf16*>(smem + OFF_Y);       // yc, y2c, dmlp, dattn
  bf16* os = reinterpret_cast<bf16*>(smem + OFF_O);       // o, do
  float* dys = reinterpret_cast<float*>(smem + OFF_Y);    // fp32 dy over ys + os
  float* das = reinterpret_cast<float*>(smem + OFF_Y);    // fp32 dA over ys
  float* ss = reinterpret_cast<float*>(smem + OFF_S);     // scores, then A (fp32)
  bf16* ps = reinterpret_cast<bf16*>(smem + OFF_P);       // A, then dS (bf16)
  float* mu1 = reinterpret_cast<float*>(smem + OFF_STAT);
  float* r1 = mu1 + NTP;
  float* mu2 = r1 + NTP;
  float* r2 = mu2 + NTP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stg = reinterpret_cast<float*>(smem + OFF_STG) + warp * 256;

  const int nww = a.w / WS, nwh = a.h / WS;
  const int win = blockIdx.x % (nwh * nww);
  const int bidx = blockIdx.x / (nwh * nww);
  const int wy = win / nww, wx = win % nww;
  const int c = a.c;
  const float m1 = a.scales ? a.scales[2 * bidx] : 1.f;
  const float m2 = a.scales ? a.scales[2 * bidx + 1] : 1.f;
  const long long row0 = static_cast<long long>(blockIdx.x) * NTP;
  float* part = a.part + static_cast<long long>(blockIdx.x) * a.vec_len;

  // element offset of the window's token t (< NT) in x, extra, ct, dx, dextra
  auto token_offset = [&](int t) -> long long {
    const int r = (wy * WS + t / WS + a.shift) % a.h;
    const int q = (wx * WS + t % WS + a.shift) % a.w;
    return ((static_cast<long long>(bidx) * a.h + r) * a.w + q) * c;
  };
  auto grow = [&](bf16* base, int ld, int r) { return base + (row0 + r) * ld; };

  Acc acc[4];

  // ================= forward recompute =================
  for (int t = warp; t < NTP; t += NWARPS) {
    const bf16* xr = t < NT ? a.x + token_offset(t) : nullptr;
    for (int i = lane; i < CP; i += 32)
      rs[t * LDX + i] = (xr && i < c) ? __bfloat162float(xr[i]) : 0.f;
  }
  for (int i = tid; i < NTP * LDO; i += NTHREADS) os[i] = __float2bfloat16(0.f);
  __syncwarp();
  layernorm_rows<NTP, NWARPS>(rs, LDX, ys, LDY, CP, a.g1, a.b1, c, a.eps, warp, lane, mu1,
                              r1);
  __syncthreads();
  copy_rows<NTP, NTHREADS>(ys, LDY, a.g_yc + row0 * CP, CP, CP, tid);

  // qkv = yc @ Wqkv^T + bqkv -> bf16 (shared and workspace)
  for (int strip = warp; strip < QKVP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip<CP>(acc, ys, LDY, a.wqkv, n0);
    strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
      float b[8];
      load8(b, a.bqkv + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += b[i];
      store8_bf16(big + r * LDQKV + n, v);
      store8_bf16(grow(a.g_qkv, QKVP, r) + n, v);
    });
  }
  __syncthreads();

  // attention forward, one head at a time -> o (bf16)
  const float* mwin = a.mask ? a.mask + static_cast<long long>(win) * NT * NT : nullptr;
  auto scores = [&](int hh) {
    for (int tile = warp; tile < 16; tile += NWARPS) {
      const int mt = tile >> 2, nt = tile & 3;
      Acc s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int k = 0; k < HDP; k += 16) {
        FragA fa;
        FragBt fb;
        wmma::load_matrix_sync(fa, big + mt * 16 * LDQKV + hh * HDP + k, LDQKV);
        wmma::load_matrix_sync(fb, big + nt * 16 * LDQKV + CP + hh * HDP + k, LDQKV);
        wmma::mma_sync(s, fa, fb, s);
      }
      wmma::store_matrix_sync(ss + mt * 16 * LDS + nt * 16, s, LDS, wmma::mem_row_major);
    }
  };
  // softmax(S + rpb + mask) in fp32: A kept in ss (fp32) and ps (bf16).
  // Pad key columns get -inf (probability 0); pad query rows get no bias
  // (finite; their cotangent is zero).  Column 0 is always a real key.
  auto softmax = [&](int hh) {
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
      store8_f32(ss + r * LDS + c0, v);
      store8_bf16(ps + r * LDP + c0, v);
    }
  };
  for (int hh = 0; hh < a.nh; ++hh) {
    scores(hh);
    __syncthreads();
    softmax(hh);
    __syncthreads();
    for (int tile = warp; tile < 8; tile += NWARPS) {
      const int mt = tile >> 1, nt = tile & 1;
      Acc o;
      wmma::fill_fragment(o, 0.f);
#pragma unroll
      for (int k = 0; k < NTP; k += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, ps + mt * 16 * LDP + k, LDP);
        wmma::load_matrix_sync(fb, big + k * LDQKV + 2 * CP + hh * HDP + nt * 16, LDQKV);
        wmma::mma_sync(o, fa, fb, o);
      }
      wmma::store_matrix_sync(stg, o, 16, wmma::mem_row_major);
      __syncwarp();
      float v[8];
      load8(v, stg + (lane >> 1) * 16 + (lane & 1) * 8);
      store8_bf16(os + (mt * 16 + (lane >> 1)) * LDO + hh * HDP + nt * 16 + (lane & 1) * 8, v);
      __syncwarp();
    }
  }
  __syncthreads();
  copy_rows<NTP, NTHREADS>(os, LDO, a.g_o + row0 * CP, CP, CP, tid);

  // x1 = x + m1 * (o @ Wproj^T + bproj), fp32 in place
  for (int strip = warp; strip < CP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip<CP>(acc, os, LDO, a.wproj, n0);
    strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
      float b[8], x[8];
      load8(b, a.bproj + n);
      load8(x, rs + r * LDX + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] += m1 * (v[i] + b[i]);
      store8_f32(rs + r * LDX + n, x);
    });
  }
  __syncthreads();
  // x1 += extra (unscaled), in LN2's (row, lane) mapping
  if (a.extra) {
    for (int t = warp; t < NT; t += NWARPS) {
      const bf16* er = a.extra + token_offset(t);
      for (int i = lane; i < c; i += 32) rs[t * LDX + i] += __bfloat162float(er[i]);
    }
  }
  layernorm_rows<NTP, NWARPS>(rs, LDX, ys, LDY, CP, a.g2, a.b2, c, a.eps, warp, lane, mu2,
                              r2);
  __syncthreads();
  for (int i = tid; i < NTP * CP / 4; i += NTHREADS) {
    const int r = i / (CP / 4), cv = (i % (CP / 4)) * 4;
    *reinterpret_cast<float4*>(a.g_x1 + (row0 + r) * CP + cv) =
        *reinterpret_cast<const float4*>(rs + r * LDX + cv);
  }
  copy_rows<NTP, NTHREADS>(ys, LDY, a.g_y2c + row0 * CP, CP, CP, tid);

  // h1 = y2c @ Wfc1^T + bfc1 (fp32 to the workspace), a = bf16(gelu(h1))
  for (int strip = warp; strip < HIDP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip<CP>(acc, ys, LDY, a.wfc1, n0);
    strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
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
  // ct -> rs (fp32, pad rows zero), dmlp = bf16(ct m2) -> ys
  for (int t = warp; t < NTP; t += NWARPS) {
    const bf16* cr = t < NT ? a.ct + token_offset(t) : nullptr;
    for (int i = lane; i < CP; i += 32) {
      const float v = (cr && i < c) ? __bfloat162float(cr[i]) : 0.f;
      rs[t * LDX + i] = v;
      ys[t * LDY + i] = __float2bfloat16(v * m2);
    }
  }
  __syncthreads();
  copy_rows<NTP, NTHREADS>(ys, LDY, a.g_dmlp + row0 * CP, CP, CP, tid);
  column_sums<NTP, NTHREADS>(ys, LDY, CP, part + V_BFC2, tid);

  // dh1 = bf16((dmlp @ Wfc2) * gelu'(h1)) -> big
  for (int strip = warp; strip < HIDP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip_kn<CP>(acc, ys, LDY, a.wfc2, HIDP, n0);
    strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
      float hv[8];
      load8(hv, a.g_h1 + (row0 + r) * HIDP + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= gelu_grad(hv[i], a.gelu_tanh);
      store8_bf16(big + r * LDH + n, v);
      store8_bf16(grow(a.g_dh1, HIDP, r) + n, v);
    });
  }
  __syncthreads();
  column_sums<NTP, NTHREADS>(big, LDH, HIDP, part + V_BFC1, tid);

  // dy2 = dh1 @ Wfc1 -> dys (fp32)
  for (int strip = warp; strip < CP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip_kn<HIDP>(acc, big, LDH, a.wfc1, CP, n0);
    strip_epilogue(acc, stg, lane, n0,
                   [&](int r, int n, float (&v)[8]) { store8_f32(dys + r * LDX + n, v); });
  }
  __syncthreads();

  // LN2 backward over the real rows (dy2 is zero on the pad rows): dg2,
  // db2 partials; dx1 = ct + LN2^T(dy2) in rs
  layernorm_backward_rows<NWARPS, NTHREADS>(
      dys, rs, LDX, a.g2, mu2, r2, [&](int t, int i) { return a.g_x1[(row0 + t) * CP + i]; },
      NT, c, part + V_G2, part + V_B2, tid, warp, lane);
  // dextra = dx1 at the same pixels (each lane reads back what it wrote)
  if (a.extra) {
    for (int t = warp; t < NT; t += NWARPS) {
      bf16* dr = a.dextra + token_offset(t);
      for (int i = lane; i < c; i += 32) dr[i] = __float2bfloat16(rs[t * LDX + i]);
    }
  }
  __syncthreads();

  // dattn = bf16(dx1 m1) -> ys
  for (int i = tid; i < NTP * CP / 8; i += NTHREADS) {
    const int r = i / (CP / 8), cv = (i % (CP / 8)) * 8;
    float v[8];
    load8(v, rs + r * LDX + cv);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] *= m1;
    store8_bf16(ys + r * LDY + cv, v);
  }
  __syncthreads();
  copy_rows<NTP, NTHREADS>(ys, LDY, a.g_dattn + row0 * CP, CP, CP, tid);
  column_sums<NTP, NTHREADS>(ys, LDY, CP, part + V_BPROJ, tid);
  // qkv back from the workspace into big (dh1 is no longer needed)
  copy_rows<NTP, NTHREADS>(a.g_qkv + row0 * QKVP, QKVP, big, LDQKV, QKVP, tid);
  // do = bf16(dattn @ Wproj) -> os
  for (int strip = warp; strip < CP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip_kn<CP>(acc, ys, LDY, a.wproj, CP, n0);
    strip_epilogue(acc, stg, lane, n0,
                   [&](int r, int n, float (&v)[8]) { store8_bf16(os + r * LDO + n, v); });
  }
  __syncthreads();

  // attention backward, one head at a time; dq, dk, dv -> workspace
  auto tile_to_dqkv = [&](Acc& t, int r0, int col) {
    wmma::store_matrix_sync(stg, t, 16, wmma::mem_row_major);
    __syncwarp();
    float v[8];
    load8(v, stg + (lane >> 1) * 16 + (lane & 1) * 8);
    store8_bf16(grow(a.g_dqkv, QKVP, r0 + (lane >> 1)) + col + (lane & 1) * 8, v);
    __syncwarp();
  };
  for (int hh = 0; hh < a.nh; ++hh) {
    scores(hh);
    __syncthreads();
    softmax(hh);
    __syncthreads();
    for (int tile = warp; tile < 24; tile += NWARPS) {
      Acc t;
      wmma::fill_fragment(t, 0.f);
      if (tile < 8) {  // dV = A^T do  (rows: keys)
        const int mt = tile >> 1, nt = tile & 1;
#pragma unroll
        for (int k = 0; k < NTP; k += 16) {
          FragAt fa;
          FragB fb;
          wmma::load_matrix_sync(fa, ps + k * LDP + mt * 16, LDP);
          wmma::load_matrix_sync(fb, os + k * LDO + hh * HDP + nt * 16, LDO);
          wmma::mma_sync(t, fa, fb, t);
        }
        tile_to_dqkv(t, mt * 16, 2 * CP + hh * HDP + nt * 16);
      } else {  // dA = do V^T
        const int mt = (tile - 8) >> 2, nt = (tile - 8) & 3;
#pragma unroll
        for (int k = 0; k < HDP; k += 16) {
          FragA fa;
          FragBt fb;
          wmma::load_matrix_sync(fa, os + mt * 16 * LDO + hh * HDP + k, LDO);
          wmma::load_matrix_sync(fb, big + nt * 16 * LDQKV + 2 * CP + hh * HDP + k, LDQKV);
          wmma::mma_sync(t, fa, fb, t);
        }
        wmma::store_matrix_sync(das + mt * 16 * LDS + nt * 16, t, LDS, wmma::mem_row_major);
      }
    }
    __syncthreads();
    // dS = A (dA - rowsum(dA A)): fp32 partial for d rpb, bf16 into ps
    float* dsp = part + VEC_LEN + static_cast<long long>(hh) * NT * NT;
    for (int r = warp * 4 + (lane >> 3); r < NTP; r += NWARPS * 4) {
      const int c0 = (lane & 7) * 8;
      float p[8], d[8];
      load8(p, ss + r * LDS + c0);
      load8(d, das + r * LDS + c0);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) dot += d[i] * p[i];
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = p[i] * (d[i] - dot);
      if constexpr (NT == NTP) {
        store8_f32(dsp + r * NT + c0, d);
      } else if (r < NT) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (c0 + i < NT) dsp[r * NT + c0 + i] = d[i];
      }
      store8_bf16(ps + r * LDP + c0, d);
    }
    __syncthreads();
    for (int tile = warp; tile < 16; tile += NWARPS) {
      const int mt = (tile & 7) >> 1, nt = tile & 1;
      Acc t;
      wmma::fill_fragment(t, 0.f);
      if (tile < 8) {  // dQ = dS K
#pragma unroll
        for (int k = 0; k < NTP; k += 16) {
          FragA fa;
          FragB fb;
          wmma::load_matrix_sync(fa, ps + mt * 16 * LDP + k, LDP);
          wmma::load_matrix_sync(fb, big + k * LDQKV + CP + hh * HDP + nt * 16, LDQKV);
          wmma::mma_sync(t, fa, fb, t);
        }
        tile_to_dqkv(t, mt * 16, hh * HDP + nt * 16);
      } else {  // dK = dS^T Q
#pragma unroll
        for (int k = 0; k < NTP; k += 16) {
          FragAt fa;
          FragB fb;
          wmma::load_matrix_sync(fa, ps + k * LDP + mt * 16, LDP);
          wmma::load_matrix_sync(fb, big + k * LDQKV + hh * HDP + nt * 16, LDQKV);
          wmma::mma_sync(t, fa, fb, t);
        }
        tile_to_dqkv(t, mt * 16, CP + hh * HDP + nt * 16);
      }
    }
    __syncthreads();
  }

  // dqkv from the workspace into big; heads >= nh are zero (also written)
  for (int i = tid; i < NTP * QKVP / 8; i += NTHREADS) {
    const int r = i / (QKVP / 8), cv = (i % (QKVP / 8)) * 8;
    bf16* g = grow(a.g_dqkv, QKVP, r) + cv;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if ((cv % CP) / HDP < a.nh) {
      v = *reinterpret_cast<const uint4*>(g);
    } else {
      *reinterpret_cast<uint4*>(g) = v;
    }
    *reinterpret_cast<uint4*>(big + r * LDQKV + cv) = v;
  }
  __syncthreads();
  column_sums<NTP, NTHREADS>(big, LDQKV, QKVP, part + V_BQKV, tid);

  // dy = dqkv @ Wqkv -> dys (fp32)
  for (int strip = warp; strip < CP / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip_kn<QKVP>(acc, big, LDQKV, a.wqkv, CP, n0);
    strip_epilogue(acc, stg, lane, n0,
                   [&](int r, int n, float (&v)[8]) { store8_f32(dys + r * LDX + n, v); });
  }
  __syncthreads();

  // LN1 backward over the real rows (x re-read at its shifted pixels);
  // dx -> the same pixels
  layernorm_backward_rows<NWARPS, NTHREADS>(
      dys, rs, LDX, a.g1, mu1, r1,
      [&](int t, int i) { return __bfloat162float(a.x[token_offset(t) + i]); }, NT, c,
      part + V_G1, part + V_B1, tid, warp, lane);
  __syncwarp();
  for (int t = warp; t < NT; t += NWARPS) {
    bf16* dr = a.dx + token_offset(t);
    for (int i = lane; i < c; i += 32) dr[i] = __float2bfloat16(rs[t * LDX + i]);
  }
}

template <int WS>
int launch_bwd_window(const BwdArgs& a, long long windows, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      swin_block_bwd_window<WS>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  swin_block_bwd_window<WS>
      <<<static_cast<unsigned int>(windows), NTHREADS, SMEM_BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sr_swin_block_bwd_bf16(
    const void* ct, const void* x, const void* extra, void* dx, void* dextra, const void* g1,
    const void* b1, const void* g2, const void* b2, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* wfc1, const void* bfc1, const void* wfc2,
    const void* bfc2, const void* rpb, const void* mask, const void* scales, void* ws16,
    void* ws32, void* part_win, void* part_w, void* vec, void* wgrad, int batch, int h, int w,
    int c, int nh, int ws, int shift, int gelu_tanh, float eps, int splits, int rows,
    void* stream) {
  if (ws != 7 && ws != 8) return static_cast<int>(cudaErrorInvalidValue);
  const long long windows = static_cast<long long>(batch) * (h / ws) * (w / ws);
  if (windows == 0) return 0;
  const long long tokens = windows * NTP;  // workspace rows
  const int nt = ws * ws;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  BwdArgs a;
  a.ct = static_cast<const bf16*>(ct);
  a.x = static_cast<const bf16*>(x);
  a.extra = static_cast<const bf16*>(extra);
  a.dx = static_cast<bf16*>(dx);
  a.dextra = static_cast<bf16*>(dextra);
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
  // bf16 workspace segments, [tokens][cols] each, in the order of
  // kernels/fused_block.py K5_BF16_COLS; fp32: x1, h1
  bf16* p16 = static_cast<bf16*>(ws16);
  bf16** segs16[] = {&a.g_yc, &a.g_qkv, &a.g_o, &a.g_y2c, &a.g_act,
                     &a.g_dmlp, &a.g_dh1, &a.g_dattn, &a.g_dqkv};
  const int cols16[] = {CP, QKVP, CP, CP, HIDP, CP, HIDP, CP, QKVP};
  for (int i = 0; i < 9; ++i) {
    *segs16[i] = p16;
    p16 += tokens * cols16[i];
  }
  a.g_x1 = static_cast<float*>(ws32);
  a.g_h1 = a.g_x1 + tokens * CP;
  a.part = static_cast<float*>(part_win);
  a.vec_len = VEC_LEN + nh * nt * nt;
  a.batch = batch;
  a.h = h;
  a.w = w;
  a.c = c;
  a.nh = nh;
  a.shift = shift;
  a.gelu_tanh = gelu_tanh;
  a.eps = eps;
  const int status = ws == 8 ? launch_bwd_window<8>(a, windows, st)
                             : launch_bwd_window<7>(a, windows, st);
  if (status != 0) return status;

  const bf16* gs[] = {a.g_dqkv, a.g_dattn, a.g_dh1, a.g_dmlp};
  const bf16* acts[] = {a.g_yc, a.g_o, a.g_y2c, a.g_act};
  const int ms[] = {QKVP, CP, HIDP, CP};
  const int ns[] = {CP, CP, CP, HIDP};
  const int wstatus = weight_grads(gs, acts, ms, ns, 4, tokens, splits, rows,
                                   static_cast<float*>(part_w), static_cast<float*>(wgrad), st);
  if (wstatus != 0) return wstatus;
  return reduce_rows(static_cast<const float*>(part_win), windows, a.vec_len,
                     static_cast<float*>(vec), st);
}
