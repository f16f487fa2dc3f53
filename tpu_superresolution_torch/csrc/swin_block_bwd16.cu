// K5 at window 16 — the backward of one Swin transformer block of
// 256-token windows (the K7 route's block: K2 + K7 + K1t), with the
// gradient of HAT's additive term `extra`.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_block.py
//           _mega_backward -> _bwd_kernel (pallas_call at :1080) at ws 16,
//           where megakernel_tpu_ok(16, w) holds (upstream HAT-SRx4).
// Math: that of csrc/swin_block_bwd.cu (kernels/fused_block.py::
//       swin_block_bwd_plain): recompute the forward, chain the cotangent
//       through MLP, LN2, proj, attention, qkv and LN1, with bf16 GEMM
//       operands, fp32 accumulation and the same casts.  One difference
//       in arithmetic: the softmax backward's row term rowsum(dA * A) is
//       taken as rowsum(dO * O) per head (equal in exact arithmetic, since
//       O = A V and dA = dO V^T), so no second pass over the scores.
// Bound on the H100: at HAT-SRx4's train shape [8,64,64,180] (128
//       windows, 6 heads of 30, hidden 360) ~64.8 GFLOP of bf16 products
//       at the unpadded widths against ~59 MB in and out: compute-bound,
//       ~0.066 ms at the 989 TFLOP/s peak.  This first version pads like
//       K5 (C -> 192, hd -> 32, hidden -> 384) and runs one CTA a window.
// Design: a window of 256 tokens does not fit K5's one-tile CTA, so
//       the CTA walks it in four 64-row tiles.  Before it, two launches
//       of other kernels recompute LN1 (K2) and qkv (K7's qkv launch)
//       into a [tokens][576] bf16 workspace (kernels/fused_block.py).
//       Then one 384-thread CTA per window runs four phases:
//       0  per head, the keys and values of all 256 tokens in shared
//          memory; per query tile the 64 x 256 fp32 scores (66 KB), an
//          exact softmax, O = P V -> workspace;
//       1  per tile: proj -> x1 (+ extra) -> LN2 -> fc1 -> GELU, then
//          the chain back through the MLP and LN2 (dx1, d extra) to
//          dattn and dO = dattn Wproj -> workspace;
//       2  per head, per tile in order: scores and softmax again, dV +=
//          P^T dO and dK += dS^T Q in fp32 shared-memory accumulators
//          (256 x 32 each), dQ = dS K -> workspace, dS (fp32) -> the
//          window's bias-gradient partial;
//       3  per tile: dqkv -> dy = dqkv Wqkv -> LN1 backward, dx = dx1 +
//          LN1^T(dy) at the shifted pixels.
//       Bias and LayerNorm sums are written per (window, tile) and the
//       weight gradients by csrc/wgrad.cuh's split-K products; ordered
//       reductions make every gradient deterministic (no atomics).
//       Shared memory: 224 KB (phase 0/2) over 172 KB (phase 1/3).
#include "common.cuh"
#include "swin_common.cuh"
#include "wgrad.cuh"

namespace {

constexpr int WS = 16;
constexpr int N = WS * WS;  // tokens of a window
constexpr int T = 64;       // rows of a tile
constexpr int TILES = N / T;
constexpr int CP = 192;
constexpr int HDP = 32;
constexpr int QKVP = 3 * CP;
constexpr int HIDP = 384;
constexpr int MAX_HEADS = CP / HDP;
constexpr int NWARPS = 12;
constexpr int NTHREADS = NWARPS * 32;

constexpr int LDX = CP;          // fp32 rows
constexpr int LDY = CP + 8;      // bf16
constexpr int LDH = HIDP + 8;    // bf16 hidden
constexpr int LDQKV = QKVP + 8;  // bf16 dqkv
constexpr int LDHD = HDP + 8;    // bf16 head tiles
constexpr int LDS = N + 4;       // fp32 scores
constexpr int LDP = N + 8;       // bf16 probabilities

// phases 0 and 2
constexpr int OFF_K = 0;
constexpr int OFF_V = OFF_K + N * LDHD * 2;
constexpr int OFF_Q = OFF_V + N * LDHD * 2;
constexpr int OFF_DO = OFF_Q + T * LDHD * 2;
constexpr int OFF_S = OFF_DO + T * LDHD * 2;
constexpr int OFF_P = OFF_S + T * LDS * 4;
constexpr int OFF_DK = OFF_P + T * LDP * 2;
constexpr int OFF_DV = OFF_DK + N * HDP * 4;
constexpr int OFF_D = OFF_DV + N * HDP * 4;
constexpr int END_A = OFF_D + T * 4;
// phases 1 and 3 (over the same bytes)
constexpr int OFF_R = 0;
constexpr int OFF_Y = OFF_R + T * LDX * 4;
constexpr int OFF_O = OFF_Y + T * LDY * 2;
constexpr int OFF_BIG = OFF_O + T * LDY * 2;
constexpr int OFF_STAT = OFF_BIG + T * LDQKV * 2;
constexpr int END_B = OFF_STAT + 2 * T * 4;
constexpr int OFF_STG = END_A > END_B ? END_A : END_B;
constexpr int SMEM_BYTES = OFF_STG + NWARPS * 256 * 4;
static_assert(SMEM_BYTES <= 232448, "over the 227 KB shared-memory limit");
static_assert(T * LDX * 4 <= OFF_BIG - OFF_Y, "fp32 dy must fit the two bf16 buffers");
static_assert(T * LDH <= T * LDQKV, "dh1 must fit the dqkv buffer");
static_assert(OFF_V % 128 == 0 && OFF_Q % 128 == 0 && OFF_DO % 128 == 0 && OFF_S % 128 == 0 &&
                  OFF_P % 128 == 0 && OFF_DK % 128 == 0 && OFF_DV % 128 == 0 &&
                  OFF_D % 128 == 0 && OFF_Y % 128 == 0 && OFF_O % 128 == 0 &&
                  OFF_BIG % 128 == 0 && OFF_STAT % 128 == 0 && OFF_STG % 128 == 0,
              "shared buffers must stay 128-byte aligned");

// Offsets in a (window, tile) partial-sum row, as csrc/swin_block_bwd.cu
// (kernels/fused_block.py _VEC_OFFSETS).
constexpr int V_G1 = 0, V_B1 = CP, V_G2 = 2 * CP, V_B2 = 3 * CP, V_BQKV = 4 * CP,
              V_BPROJ = 7 * CP, V_BFC1 = 8 * CP, V_BFC2 = 8 * CP + HIDP, VEC_LEN = 9 * CP + HIDP;

struct Bwd16Args {
  const bf16* ct;
  const bf16* x;
  const bf16* extra;  // [batch, h, w, c] or null
  bf16* dx;
  bf16* dextra;       // written when extra is not null
  const bf16* qkv;    // [tokens][QKVP], q pre-scaled, heads padded to HDP
  const float* g1;
  const float* b1;
  const float* g2;
  const float* b2;
  const bf16* wqkv;   // [QKVP, CP]
  const bf16* wproj;  // [CP, CP]
  const float* bproj;
  const bf16* wfc1;   // [HIDP, CP]
  const float* bfc1;
  const bf16* wfc2;   // [CP, HIDP]
  const float* bfc2;
  const float* rpb;   // [nh, N, N]
  const float* mask;  // [nW, N, N] or null
  const float* scales;
  // bf16 workspace, [tokens][cols], tokens window-major
  bf16* g_o;      // CP
  bf16* g_y2c;    // CP
  bf16* g_act;    // HIDP
  bf16* g_dmlp;   // CP
  bf16* g_dh1;    // HIDP
  bf16* g_dattn;  // CP
  bf16* g_do;     // CP
  bf16* g_dqkv;   // QKVP
  float* g_dx1;   // [tokens][CP]
  float* g_x1;    // [windows * T][CP]: one tile's rows per CTA
  float* g_h1;    // [windows * T][HIDP]
  float* part;    // [windows * TILES][VEC_LEN]
  float* dsp;     // [windows][nh][N][N]
  int h, w, c, nh, shift, gelu_tanh;
  float eps;
};

__global__ void __launch_bounds__(NTHREADS, 1) swin_block_bwd16_window(const Bwd16Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + OFF_K);
  bf16* vs = reinterpret_cast<bf16*>(smem + OFF_V);
  bf16* qs = reinterpret_cast<bf16*>(smem + OFF_Q);
  bf16* dos = reinterpret_cast<bf16*>(smem + OFF_DO);
  float* ss = reinterpret_cast<float*>(smem + OFF_S);
  bf16* ps = reinterpret_cast<bf16*>(smem + OFF_P);
  float* dka = reinterpret_cast<float*>(smem + OFF_DK);
  float* dva = reinterpret_cast<float*>(smem + OFF_DV);
  float* drow = reinterpret_cast<float*>(smem + OFF_D);
  float* rs = reinterpret_cast<float*>(smem + OFF_R);
  bf16* ys = reinterpret_cast<bf16*>(smem + OFF_Y);
  bf16* os = reinterpret_cast<bf16*>(smem + OFF_O);
  float* dys = reinterpret_cast<float*>(smem + OFF_Y);  // fp32 over ys + os
  bf16* big = reinterpret_cast<bf16*>(smem + OFF_BIG);
  float* mu = reinterpret_cast<float*>(smem + OFF_STAT);
  float* rstd = mu + T;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stg = reinterpret_cast<float*>(smem + OFF_STG) + warp * 256;
  const int nww = a.w / WS, nwh = a.h / WS;
  const int win = blockIdx.x % (nwh * nww);
  const int bidx = blockIdx.x / (nwh * nww);
  const int wy = win / nww, wx = win % nww;
  const int c = a.c;
  const float m1 = a.scales ? a.scales[2 * bidx] : 1.f;
  const float m2 = a.scales ? a.scales[2 * bidx + 1] : 1.f;
  const long long row0 = static_cast<long long>(blockIdx.x) * N;  // workspace rows
  const long long srow0 = static_cast<long long>(blockIdx.x) * T;  // scratch rows
  const float* mwin = a.mask ? a.mask + static_cast<long long>(win) * N * N : nullptr;

  // element offset of the window's token t in x, extra, ct, dx, dextra
  auto token_offset = [&](int t) -> long long {
    const int r = (wy * WS + t / WS + a.shift) % a.h;
    const int q = (wx * WS + t % WS + a.shift) % a.w;
    return ((static_cast<long long>(bidx) * a.h + r) * a.w + q) * c;
  };
  auto part_of = [&](int t) { return a.part + (static_cast<long long>(blockIdx.x) * TILES + t) * VEC_LEN; };
  // rows [r0, r0 + rows) of the 32 columns at `col` of a workspace with
  // `ld` columns -> a [rows][LDHD] tile
  auto load_cols = [&](bf16* dst, const bf16* src, int ld, int col, int r0, int rows) {
    for (int i = tid; i < rows * 4; i += NTHREADS) {
      const int r = i >> 2, cv = (i & 3) * 8;
      *reinterpret_cast<uint4*>(dst + r * LDHD + cv) =
          *reinterpret_cast<const uint4*>(src + (row0 + r0 + r) * ld + col + cv);
    }
  };
  // S = Q K^T (64 x 256) -> ss
  auto scores = [&]() {
    for (int tile = warp; tile < 64; tile += NWARPS) {
      const int mt = tile >> 4, nt = tile & 15;
      Acc s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int k = 0; k < HDP; k += 16) {
        FragA fa;
        FragBt fb;
        wmma::load_matrix_sync(fa, qs + mt * 16 * LDHD + k, LDHD);
        wmma::load_matrix_sync(fb, ks + nt * 16 * LDHD + k, LDHD);
        wmma::mma_sync(s, fa, fb, s);
      }
      wmma::store_matrix_sync(ss + mt * 16 * LDS + nt * 16, s, LDS, wmma::mem_row_major);
    }
  };
  // A = softmax(S + rpb + mask) of tile t, head hh: fp32 in ss, bf16 in
  // ps; one warp a row, eight columns a lane (every key is real)
  auto softmax = [&](int hh, int t) {
    const float* rp = a.rpb + static_cast<long long>(hh) * N * N;
    for (int r = warp; r < T; r += NWARPS) {
      const int q = t * T + r, c0 = lane * 8;
      float v[8], u[8];
      load8(v, ss + r * LDS + c0);
      load8(u, rp + q * N + c0);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += u[i];
      if (mwin) {
        load8(u, mwin + q * N + c0);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] += u[i];
      }
      float m = v[0];
#pragma unroll
      for (int i = 1; i < 8; ++i) m = fmaxf(m, v[i]);
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = expf(v[i] - m);
        sum += v[i];
      }
      const float inv = 1.f / warp_sum(sum);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= inv;
      store8_f32(ss + r * LDS + c0, v);
      store8_bf16(ps + r * LDP + c0, v);
    }
  };
  // a 16x16 accumulator tile -> bf16 rows [r0, r0 + 16), columns [col,
  // col + 16) of a workspace with `ld` columns
  auto tile_out = [&](Acc& t, bf16* dst, int ld, long long r0, int col) {
    wmma::store_matrix_sync(stg, t, 16, wmma::mem_row_major);
    __syncwarp();
    float v[8];
    load8(v, stg + (lane >> 1) * 16 + (lane & 1) * 8);
    store8_bf16(dst + (r0 + (lane >> 1)) * ld + col + (lane & 1) * 8, v);
    __syncwarp();
  };
  Acc acc[4];

  // ================= phase 0: attention forward -> O =================
  for (int hh = 0; hh < MAX_HEADS; ++hh) {
    if (hh >= a.nh) {  // the padded heads' columns of O are zero
      for (int i = tid; i < N * 4; i += NTHREADS) {
        const int r = i >> 2, cv = (i & 3) * 8;
        *reinterpret_cast<uint4*>(a.g_o + (row0 + r) * CP + hh * HDP + cv) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      continue;
    }
    load_cols(ks, a.qkv, QKVP, CP + hh * HDP, 0, N);
    load_cols(vs, a.qkv, QKVP, 2 * CP + hh * HDP, 0, N);
    for (int t = 0; t < TILES; ++t) {
      load_cols(qs, a.qkv, QKVP, hh * HDP, t * T, T);
      __syncthreads();
      scores();
      __syncthreads();
      softmax(hh, t);
      __syncthreads();
      for (int tile = warp; tile < 8; tile += NWARPS) {  // O = P V (64 x 32)
        const int mt = tile >> 1, nt = tile & 1;
        Acc o;
        wmma::fill_fragment(o, 0.f);
        for (int k = 0; k < N; k += 16) {
          FragA fa;
          FragB fb;
          wmma::load_matrix_sync(fa, ps + mt * 16 * LDP + k, LDP);
          wmma::load_matrix_sync(fb, vs + k * LDHD + nt * 16, LDHD);
          wmma::mma_sync(o, fa, fb, o);
        }
        tile_out(o, a.g_o, CP, row0 + t * T + mt * 16, hh * HDP + nt * 16);
      }
      __syncthreads();
    }
  }

  // ================= phase 1: tail forward and backward per tile =================
  for (int t = 0; t < TILES; ++t) {
    float* part = part_of(t);
    const long long tr0 = row0 + t * T;
    for (int r = warp; r < T; r += NWARPS) {
      const bf16* xr = a.x + token_offset(t * T + r);
      for (int i = lane; i < CP; i += 32) rs[r * LDX + i] = i < c ? __bfloat162float(xr[i]) : 0.f;
    }
    copy_rows<T, NTHREADS>(a.g_o + tr0 * CP, CP, os, LDY, CP, tid);
    __syncthreads();
    // x1 = x + m1 * (o @ Wproj^T + bproj)
    for (int strip = warp; strip < CP / 16; strip += NWARPS) {
      const int n0 = strip * 16;
      gemm_strip<CP>(acc, os, LDY, a.wproj, n0);
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
    if (a.extra) {  // + extra, in LN2's (row, lane) mapping
      for (int r = warp; r < T; r += NWARPS) {
        const bf16* er = a.extra + token_offset(t * T + r);
        for (int i = lane; i < c; i += 32) rs[r * LDX + i] += __bfloat162float(er[i]);
      }
    }
    layernorm_rows<T, NWARPS>(rs, LDX, ys, LDY, CP, a.g2, a.b2, c, a.eps, warp, lane, mu, rstd);
    __syncthreads();
    for (int i = tid; i < T * CP / 4; i += NTHREADS) {
      const int r = i / (CP / 4), cv = (i % (CP / 4)) * 4;
      *reinterpret_cast<float4*>(a.g_x1 + (srow0 + r) * CP + cv) =
          *reinterpret_cast<const float4*>(rs + r * LDX + cv);
    }
    copy_rows<T, NTHREADS>(ys, LDY, a.g_y2c + tr0 * CP, CP, CP, tid);
    // h1 = y2c @ Wfc1^T + bfc1 (fp32 scratch), act = bf16(gelu(h1))
    for (int strip = warp; strip < HIDP / 16; strip += NWARPS) {
      const int n0 = strip * 16;
      gemm_strip<CP>(acc, ys, LDY, a.wfc1, n0);
      strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
        float b[8];
        load8(b, a.bfc1 + n);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] += b[i];
        store8_f32(a.g_h1 + (srow0 + r) * HIDP + n, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = gelu(v[i], a.gelu_tanh);
        store8_bf16(a.g_act + (tr0 + r) * HIDP + n, v);
      });
    }
    __syncthreads();

    // ct -> rs (fp32), dmlp = bf16(ct m2) -> ys
    for (int r = warp; r < T; r += NWARPS) {
      const bf16* cr = a.ct + token_offset(t * T + r);
      for (int i = lane; i < CP; i += 32) {
        const float v = i < c ? __bfloat162float(cr[i]) : 0.f;
        rs[r * LDX + i] = v;
        ys[r * LDY + i] = __float2bfloat16(v * m2);
      }
    }
    __syncthreads();
    copy_rows<T, NTHREADS>(ys, LDY, a.g_dmlp + tr0 * CP, CP, CP, tid);
    column_sums<T, NTHREADS>(ys, LDY, CP, part + V_BFC2, tid);
    // dh1 = bf16((dmlp @ Wfc2) * gelu'(h1)) -> big
    for (int strip = warp; strip < HIDP / 16; strip += NWARPS) {
      const int n0 = strip * 16;
      gemm_strip_kn<CP>(acc, ys, LDY, a.wfc2, HIDP, n0);
      strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
        float hv[8];
        load8(hv, a.g_h1 + (srow0 + r) * HIDP + n);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] *= gelu_grad(hv[i], a.gelu_tanh);
        store8_bf16(big + r * LDH + n, v);
        store8_bf16(a.g_dh1 + (tr0 + r) * HIDP + n, v);
      });
    }
    __syncthreads();
    column_sums<T, NTHREADS>(big, LDH, HIDP, part + V_BFC1, tid);
    // dy2 = dh1 @ Wfc1 -> dys (fp32 over ys and os)
    for (int strip = warp; strip < CP / 16; strip += NWARPS) {
      const int n0 = strip * 16;
      gemm_strip_kn<HIDP>(acc, big, LDH, a.wfc1, CP, n0);
      strip_epilogue(acc, stg, lane, n0,
                     [&](int r, int n, float (&v)[8]) { store8_f32(dys + r * LDX + n, v); });
    }
    __syncthreads();
    // dx1 = ct + LN2^T(dy2) in rs; dg2, db2; dextra = dx1; dx1 -> workspace
    layernorm_backward_rows<NWARPS, NTHREADS>(
        dys, rs, LDX, a.g2, mu, rstd, [&](int r, int i) { return a.g_x1[(srow0 + r) * CP + i]; },
        T, c, part + V_G2, part + V_B2, tid, warp, lane);
    for (int r = warp; r < T; r += NWARPS) {
      if (a.extra) {
        bf16* dr = a.dextra + token_offset(t * T + r);
        for (int i = lane; i < c; i += 32) dr[i] = __float2bfloat16(rs[r * LDX + i]);
      }
      for (int i = lane; i < CP; i += 32) a.g_dx1[(tr0 + r) * CP + i] = rs[r * LDX + i];
    }
    __syncthreads();
    // dattn = bf16(dx1 m1) -> ys
    for (int i = tid; i < T * CP / 8; i += NTHREADS) {
      const int r = i / (CP / 8), cv = (i % (CP / 8)) * 8;
      float v[8];
      load8(v, rs + r * LDX + cv);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] *= m1;
      store8_bf16(ys + r * LDY + cv, v);
    }
    __syncthreads();
    copy_rows<T, NTHREADS>(ys, LDY, a.g_dattn + tr0 * CP, CP, CP, tid);
    column_sums<T, NTHREADS>(ys, LDY, CP, part + V_BPROJ, tid);
    // dO = bf16(dattn @ Wproj) -> workspace
    for (int strip = warp; strip < CP / 16; strip += NWARPS) {
      const int n0 = strip * 16;
      gemm_strip_kn<CP>(acc, ys, LDY, a.wproj, CP, n0);
      strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
        store8_bf16(a.g_do + (tr0 + r) * CP + n, v);
      });
    }
    __syncthreads();
  }

  // ================= phase 2: attention backward per head =================
  for (int hh = 0; hh < a.nh; ++hh) {
    load_cols(ks, a.qkv, QKVP, CP + hh * HDP, 0, N);
    load_cols(vs, a.qkv, QKVP, 2 * CP + hh * HDP, 0, N);
    for (int i = tid; i < 2 * N * HDP; i += NTHREADS) dka[i] = 0.f;  // dka, dva
    float* dsh = a.dsp + (static_cast<long long>(blockIdx.x) * a.nh + hh) * N * N;
    for (int t = 0; t < TILES; ++t) {
      load_cols(qs, a.qkv, QKVP, hh * HDP, t * T, T);
      load_cols(dos, a.g_do, CP, hh * HDP, t * T, T);
      __syncthreads();
      // D = rowsum(dO * O) of the head
      for (int r = warp; r < T; r += NWARPS) {
        const float o = __bfloat162float(a.g_o[(row0 + t * T + r) * CP + hh * HDP + lane]);
        const float d = warp_sum(__bfloat162float(dos[r * LDHD + lane]) * o);
        if (lane == 0) drow[r] = d;
      }
      scores();
      __syncthreads();
      softmax(hh, t);
      __syncthreads();
      // dV += P^T dO: 16 key tiles x 2 column tiles
      for (int tile = warp; tile < 32; tile += NWARPS) {
        const int mt = tile >> 1, nt = tile & 1;
        Acc d;
        float* dst = dva + mt * 16 * HDP + nt * 16;
        wmma::load_matrix_sync(d, dst, HDP, wmma::mem_row_major);
#pragma unroll
        for (int k = 0; k < T; k += 16) {
          FragAt fa;
          FragB fb;
          wmma::load_matrix_sync(fa, ps + k * LDP + mt * 16, LDP);
          wmma::load_matrix_sync(fb, dos + k * LDHD + nt * 16, LDHD);
          wmma::mma_sync(d, fa, fb, d);
        }
        wmma::store_matrix_sync(dst, d, HDP, wmma::mem_row_major);
      }
      __syncthreads();
      // dS = A (dO V^T - D): fp32 to the bias-gradient partial, bf16 over P
      for (int tile = warp; tile < 64; tile += NWARPS) {
        const int mt = tile >> 4, nt = tile & 15;
        Acc s;
        wmma::fill_fragment(s, 0.f);
#pragma unroll
        for (int k = 0; k < HDP; k += 16) {
          FragA fa;
          FragBt fb;
          wmma::load_matrix_sync(fa, dos + mt * 16 * LDHD + k, LDHD);
          wmma::load_matrix_sync(fb, vs + nt * 16 * LDHD + k, LDHD);
          wmma::mma_sync(s, fa, fb, s);
        }
        wmma::store_matrix_sync(stg, s, 16, wmma::mem_row_major);
        __syncwarp();
        const int rr = mt * 16 + (lane >> 1), cc = nt * 16 + (lane & 1) * 8;
        float da[8], p[8];
        load8(da, stg + (lane >> 1) * 16 + (lane & 1) * 8);
        load8(p, ss + rr * LDS + cc);
        const float dd = drow[rr];
#pragma unroll
        for (int i = 0; i < 8; ++i) da[i] = p[i] * (da[i] - dd);
        store8_f32(dsh + static_cast<long long>(t * T + rr) * N + cc, da);
        store8_bf16(ps + rr * LDP + cc, da);
        __syncwarp();
      }
      __syncthreads();
      // dQ = dS K -> workspace; dK += dS^T Q
      for (int tile = warp; tile < 40; tile += NWARPS) {
        if (tile < 8) {
          const int mt = tile >> 1, nt = tile & 1;
          Acc d;
          wmma::fill_fragment(d, 0.f);
          for (int k = 0; k < N; k += 16) {
            FragA fa;
            FragB fb;
            wmma::load_matrix_sync(fa, ps + mt * 16 * LDP + k, LDP);
            wmma::load_matrix_sync(fb, ks + k * LDHD + nt * 16, LDHD);
            wmma::mma_sync(d, fa, fb, d);
          }
          tile_out(d, a.g_dqkv, QKVP, row0 + t * T + mt * 16, hh * HDP + nt * 16);
        } else {
          const int mt = (tile - 8) >> 1, nt = tile & 1;
          Acc d;
          float* dst = dka + mt * 16 * HDP + nt * 16;
          wmma::load_matrix_sync(d, dst, HDP, wmma::mem_row_major);
#pragma unroll
          for (int k = 0; k < T; k += 16) {
            FragAt fa;
            FragB fb;
            wmma::load_matrix_sync(fa, ps + k * LDP + mt * 16, LDP);
            wmma::load_matrix_sync(fb, qs + k * LDHD + nt * 16, LDHD);
            wmma::mma_sync(d, fa, fb, d);
          }
          wmma::store_matrix_sync(dst, d, HDP, wmma::mem_row_major);
        }
      }
      __syncthreads();
    }
    // dK, dV of the head -> workspace
    for (int i = tid; i < N * HDP / 8; i += NTHREADS) {
      const int r = i / (HDP / 8), cv = (i % (HDP / 8)) * 8;
      float v[8];
      load8(v, dka + r * HDP + cv);
      store8_bf16(a.g_dqkv + (row0 + r) * QKVP + CP + hh * HDP + cv, v);
      load8(v, dva + r * HDP + cv);
      store8_bf16(a.g_dqkv + (row0 + r) * QKVP + 2 * CP + hh * HDP + cv, v);
    }
    __syncthreads();
  }

  // ================= phase 3: qkv and LN1 backward per tile =================
  for (int t = 0; t < TILES; ++t) {
    float* part = part_of(t);
    const long long tr0 = row0 + t * T;
    // dqkv -> big; the padded heads' columns are zero (also written)
    for (int i = tid; i < T * QKVP / 8; i += NTHREADS) {
      const int r = i / (QKVP / 8), cv = (i % (QKVP / 8)) * 8;
      bf16* g = a.g_dqkv + (tr0 + r) * QKVP + cv;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if ((cv % CP) / HDP < a.nh) {
        v = *reinterpret_cast<const uint4*>(g);
      } else {
        *reinterpret_cast<uint4*>(g) = v;
      }
      *reinterpret_cast<uint4*>(big + r * LDQKV + cv) = v;
    }
    for (int i = tid; i < T * CP / 4; i += NTHREADS) {
      const int r = i / (CP / 4), cv = (i % (CP / 4)) * 4;
      *reinterpret_cast<float4*>(rs + r * LDX + cv) =
          *reinterpret_cast<const float4*>(a.g_dx1 + (tr0 + r) * CP + cv);
    }
    // LN1 statistics of the tile's x rows (layernorm_rows' arithmetic)
    for (int r = warp; r < T; r += NWARPS) {
      const bf16* xr = a.x + token_offset(t * T + r);
      float s = 0.f, sq = 0.f;
      for (int i = lane; i < c; i += 32) {
        const float v = __bfloat162float(xr[i]);
        s += v;
        sq += v * v;
      }
      s = warp_sum(s);
      sq = warp_sum(sq);
      const float inv_c = 1.f / static_cast<float>(c);
      const float m = s * inv_c;
      if (lane == 0) {
        mu[r] = m;
        rstd[r] = rsqrtf(fmaxf(sq * inv_c - m * m, 0.f) + a.eps);
      }
    }
    __syncthreads();
    column_sums<T, NTHREADS>(big, LDQKV, QKVP, part + V_BQKV, tid);
    // dy = dqkv @ Wqkv -> dys (fp32)
    for (int strip = warp; strip < CP / 16; strip += NWARPS) {
      const int n0 = strip * 16;
      gemm_strip_kn<QKVP>(acc, big, LDQKV, a.wqkv, CP, n0);
      strip_epilogue(acc, stg, lane, n0,
                     [&](int r, int n, float (&v)[8]) { store8_f32(dys + r * LDX + n, v); });
    }
    __syncthreads();
    layernorm_backward_rows<NWARPS, NTHREADS>(
        dys, rs, LDX, a.g1, mu, rstd,
        [&](int r, int i) { return __bfloat162float(a.x[token_offset(t * T + r) + i]); }, T, c,
        part + V_G1, part + V_B1, tid, warp, lane);
    __syncwarp();
    for (int r = warp; r < T; r += NWARPS) {
      bf16* dr = a.dx + token_offset(t * T + r);
      for (int i = lane; i < c; i += 32) dr[i] = __float2bfloat16(rs[r * LDX + i]);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int sr_swin_block_bwd16_bf16(
    const void* ct, const void* x, const void* extra, void* dx, void* dextra, const void* yc,
    const void* qkv, const void* g1, const void* b1, const void* g2, const void* b2,
    const void* wqkv, const void* wproj, const void* bproj, const void* wfc1, const void* bfc1,
    const void* wfc2, const void* bfc2, const void* rpb, const void* mask, const void* scales,
    void* ws16, void* ws32, void* part_win, void* dsp, void* part_w, void* vec, void* drpb,
    void* wgrad, int batch, int h, int w, int c, int nh, int shift, int gelu_tanh, float eps,
    int splits, int rows, void* stream) {
  if (h % WS || w % WS || c < 1 || c > CP || nh < 1 || nh > MAX_HEADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long windows = static_cast<long long>(batch) * (h / WS) * (w / WS);
  if (windows == 0) return 0;
  const long long tokens = windows * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  Bwd16Args a;
  a.ct = static_cast<const bf16*>(ct);
  a.x = static_cast<const bf16*>(x);
  a.extra = static_cast<const bf16*>(extra);
  a.dx = static_cast<bf16*>(dx);
  a.dextra = static_cast<bf16*>(dextra);
  a.qkv = static_cast<const bf16*>(qkv);
  a.g1 = static_cast<const float*>(g1);
  a.b1 = static_cast<const float*>(b1);
  a.g2 = static_cast<const float*>(g2);
  a.b2 = static_cast<const float*>(b2);
  a.wqkv = static_cast<const bf16*>(wqkv);
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
  // kernels/fused_block.py K5W16_BF16_COLS; fp32: dx1, then the x1 and h1
  // scratch rows
  bf16* p16 = static_cast<bf16*>(ws16);
  bf16** segs16[] = {&a.g_o, &a.g_y2c, &a.g_act, &a.g_dmlp, &a.g_dh1, &a.g_dattn, &a.g_do,
                     &a.g_dqkv};
  const int cols16[] = {CP, CP, HIDP, CP, HIDP, CP, CP, QKVP};
  for (int i = 0; i < 8; ++i) {
    *segs16[i] = p16;
    p16 += tokens * cols16[i];
  }
  a.g_dx1 = static_cast<float*>(ws32);
  a.g_x1 = a.g_dx1 + tokens * CP;
  a.g_h1 = a.g_x1 + windows * T * CP;
  a.part = static_cast<float*>(part_win);
  a.dsp = static_cast<float*>(dsp);
  a.h = h;
  a.w = w;
  a.c = c;
  a.nh = nh;
  a.shift = shift;
  a.gelu_tanh = gelu_tanh;
  a.eps = eps;
  cudaError_t err = cudaFuncSetAttribute(
      swin_block_bwd16_window, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  swin_block_bwd16_window<<<static_cast<unsigned int>(windows), NTHREADS, SMEM_BYTES, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const bf16* gs[] = {a.g_dqkv, a.g_dattn, a.g_dh1, a.g_dmlp};
  const bf16* acts[] = {static_cast<const bf16*>(yc), a.g_o, a.g_y2c, a.g_act};
  const int ms[] = {QKVP, CP, HIDP, CP};
  const int ns[] = {CP, CP, CP, HIDP};
  int status = weight_grads(gs, acts, ms, ns, 4, tokens, splits, rows,
                            static_cast<float*>(part_w), static_cast<float*>(wgrad), st);
  if (status != 0) return status;
  status = reduce_rows(static_cast<const float*>(part_win), windows * TILES, VEC_LEN,
                       static_cast<float*>(vec), st);
  if (status != 0) return status;
  return reduce_rows(static_cast<const float*>(dsp), windows,
                     static_cast<long long>(nh) * N * N, static_cast<float*>(drpb), st);
}
