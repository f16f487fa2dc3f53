// K1 and K6 — one whole Swin transformer block forward per window, for
// window size 8 (K1) or 7 (K6), with an optional additive term `extra`,
// on Hopper's wgmma.
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
// Math (per window of NT = WS*WS tokens, C <= 192 channels, nh <= 6 heads
//       of hd <= 32, MLP hidden <= 384):
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
//       stream stays fp32 inside the block.  rpb[h][i][j] is the
//       [(2ws-1)^2] table's entry at pos_i - pos_j + (ws-1)(2ws-1) + ws-1
//       and mask[win][i][j] is -100 where the tokens' shift regions
//       differ, both from one int32 code a token (bits 0-15 pos, 16-31
//       the region; ops/window.py::window_token_codes): the same fp32
//       values as the gathered bias and shift_attn_mask, added in the
//       same order.
// Cyclic shift: the window's token (i, j) reads and writes pixel
//       ((wy*WS + i + s) mod H, (wx*WS + j + s) mod W), so the block
//       computes cyclic_unshift(block(cyclic_shift(x, s)), s) with no roll
//       pass and no partition in HBM.
// Bound on the H100: SwinIR-M's block (C 180, hidden 360, ws 8) does
//       ~36 MFLOP of bf16 products a window against ~46 KB of activations
//       in and out, HAT's (C 96, hidden 384, ws 7) ~12 MFLOP against
//       ~29 KB: compute-bound (0.0187 ms at [8,64,64,180], 0.0297 at
//       [25,70,70,96]).  Feeding the tensor cores is the limit in
//       practice: the weights (~0.6 MB at C 180) stream from L2 once a
//       window pair, and every step between two products is a barrier.
// Design:
//     - Persistent CTAs of 384 threads, one an SM, walk window pairs.
//       Consumer warpgroups 0 and 1 each own a window's 64 token rows as
//       one wgmma m64 tile, so every weight tile in shared memory serves
//       two windows.  Warpgroup 2 feeds the weights (one thread; setmaxnreg
//       gives its registers to the consumers, 232 each, where 9 warps
//       would leave 168 and spill at width 192): kernels/fused_block.py
//       ``pack_block_tiles`` lays them out as one stream of [N, 64]
//       K-major 128B-swizzled tiles in the consumers' order (a head's qkv
//       per 64-column K chunk; the proj and fc2 in 96-column N halves;
//       per 64-column hidden chunk, fc1's K chunks then fc2's halves),
//       and one bulk copy a tile fills a ring stage under mbarriers.
//     - wgmma m64 x N x k16, fp32 accumulators in registers; every
//       epilogue runs on them: LN1 / LN2 statistics of a row are a
//       thread's 2 x CP/8 pairs plus two quad shuffles; q goes to the
//       A fragments of Q K^T in registers, k and v to the head's
//       swizzled [64, HDP] tiles; the scores take the bias and the mask
//       and the softmax in registers; P is the A operand of P V from
//       registers; the GELU of an fc1 chunk is the A operand of fc2.
//     - Padding by the width: CP = 96 or 192 (the instantiations), HDP =
//       16 or 32, the hidden in 64-column chunks; every loop around a
//       wgmma has a compile-time trip count except those over heads,
//       hidden chunks and windows, which run whole commit groups.  At ws
//       7, rows 49-63 are zero inputs never stored and keys 49-63 score
//       -inf.
//     - Shared memory (a window; CP 192, HDP 32 / CP 96, HDP 16): the
//       LN output and A operand, KC x [64, 64] swizzled chunks (24 / 16
//       KB); R, the attention output (A of the proj) beside the window's
//       x as bf16 pairs in each thread's registers' order, later x1 in
//       fp32 the same way (48 / 28 KB); the head's k and v (8 / 4 KB).
//       Two windows, the [nh, (2ws-1)^2] table, barriers and 5 / 8
//       stages of 12 KB: 226 / 198 KB of 227 KB (fused_block.block_plan).
//     - Latency, measured by clock64 marks on one CTA (an instrumented
//       copy; HAT's shape, ~62K cycles a window pair): no load waits behind a
//       branch (x, extra and the biases are loaded in one batch, the
//       column clamped into the row, before the products they follow;
//       the next pair's rows are prefetched into L2 during the MLP);
//       the GELU's division is the approximate one (the IEEE division's
//       slow-path branch made 32 serial chains, ~6K cycles a hidden
//       chunk); the bias terms of a window's 32 scores a thread are
//       indexed once for all heads.  The heads' softmax and the MLP's
//       chunks are the largest shares left.
//     - No atomics: the output is the same bit for bit on every run.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NCONS = 2;                      // consumer warpgroups: a window each
constexpr int NTHREADS = 128 * (NCONS + 1);   // + the weight feeder's warpgroup
// setmaxnreg: an SM sub-partition holds one warp of each warpgroup, 16K
// registers: 32 x (2 x 232 + 40) <= 16384
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int STAGE_BYTES = 12288;          // a ring stage: one [<= 96, 64] tile
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_HEADS = 6;
constexpr int TABLE_BYTES = MAX_HEADS * 225 * 4;  // [nh, (2ws-1)^2] fp32, ws <= 8
constexpr int HC = 64;  // MLP hidden columns a chunk

__host__ __device__ constexpr int round1024(int v) { return (v + 1023) / 1024 * 1024; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int CP, int HDP>
struct Layout {
  static_assert(CP == 96 || CP == 192, "compiled widths");
  static_assert(HDP == 16 || HDP == 32, "compiled head dims");
  static constexpr int KC = (CP + 63) / 64;  // 64-column K chunks of an A operand
  static constexpr int NH = CP / 96;         // 96-column N halves of the proj and fc2
  static constexpr int RB = 2 * HDP;         // bytes a row of the head's k and v tiles
  static constexpr int A_BYTES = KC * 8192;  // [64, 64] bf16 chunks
  static constexpr int X_BYTES = 128 * CP;   // x: CP / 4 bf16 pairs a thread
  static constexpr int R_BYTES = round1024(cmax(A_BYTES + X_BYTES, 256 * CP));  // x1: CP / 2 fp32
  static constexpr int KV_BYTES = 64 * RB;
  static constexpr int WIN_BYTES = A_BYTES + R_BYTES + 2 * KV_BYTES;
  static constexpr int QKV_TILE = 3 * HDP * 128;
  static constexpr int FIXED = 1024 + NCONS * WIN_BYTES + TABLE_BYTES + 2 * MAX_STAGES * 8;
};

struct Args {
  const bf16* x;
  const bf16* extra;  // [batch, h, w, c] or null
  bf16* y;
  const bf16* tiles;  // the weight stream (pack_block_tiles)
  const float* bqkv;  // [nh, 3, HDP], q pre-scaled
  const float* bproj;  // [CP]
  const float* bfc1;  // [chunks * 64]
  const float* bfc2;  // [CP]
  const float* g1;
  const float* b1;
  const float* g2;
  const float* b2;
  const float* table;  // [nh, (2ws-1)^2]
  const int* codes;    // [windows of an image, ws * ws] where shifted, else [1, ws * ws]
  const float* scales;  // [batch, 2] or null
  int batch, h, w, c, nh, chunks, shift, shifted, gelu_tanh, stages;
  float eps;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// The bf16 pairs (8 j + 2 q, + 1) of the thread's two rows, zero past c
// and in rows that are not real (`ok`; their pointers still point at a
// real row).  The branch on `even` (c even: one 4-byte load a pair, the
// row 4-byte aligned) is uniform and outside the loops, and every load
// is unconditional (the column clamped into the row), so all of them are
// in flight at once.
template <int NJ>
__device__ __forceinline__ void load_rows(uint32_t (&v)[NJ][2], const bf16* const (&row)[2],
                                          const bool (&ok)[2], int q, int c, bool even) {
  if (even) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int col = 8 * j + 2 * q;
        const uint32_t u =
            __ldg(reinterpret_cast<const unsigned int*>(row[h2] + (col < c ? col : c - 2)));
        v[j][h2] = ok[h2] && col < c ? u : 0u;
      }
  } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int col = 8 * j + 2 * q;
        const unsigned short* r = reinterpret_cast<const unsigned short*>(row[h2]);
        const uint32_t lo = __ldg(r + (col < c ? col : c - 1));
        const uint32_t hi = __ldg(r + (col + 1 < c ? col + 1 : c - 1));
        v[j][h2] = ok[h2] ? (col < c ? lo : 0u) | (col + 1 < c ? hi << 16 : 0u) : 0u;
      }
  }
}

// fp32 (v[col], v[col + 1]) of a [c] vector (zero past c)
__device__ __forceinline__ float2 load_vec2(const float* v, int col, int c) {
  return make_float2(col < c ? __ldg(v + col) : 0.f, col + 1 < c ? __ldg(v + col + 1) : 0.f);
}

// GELU's two forms: tanh's as 0.5 u (1 + tanh t) = u - u / (e^2t + 1),
// one exp and an approximate division (+-inf t give u and 0: a division
// with IEEE rounding branches to a slow path, and 32 such branches a
// hidden chunk measured ~6K cycles), erf's exact.
template <bool TANH>
__device__ __forceinline__ float gelu(float u) {
  if (TANH) {
    const float t = 0.7978845608028654f * (u + 0.044715f * u * u * u);  // sqrt(2 / pi) (...)
    return u - __fdividef(u, __expf(2.f * t) + 1.f);
  }
  return 0.5f * u * (1.f + erff(u * 0.7071067811865476f));
}

// GELU(hacc + bias) of a 64-column hidden chunk as fc2's A fragments
// (k-step kb: columns 16 kb.., WgmmaRS's layout); bb[j]: the bias at
// columns 8 j + 2 q, + 1.
template <bool TANH>
__device__ __forceinline__ void hidden_fragments(uint32_t (&f)[4][4], const float (&h)[32],
                                                 const float2 (&b)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bb = b[j];
    f[j / 2][2 * (j & 1)] = pack_bf16(gelu<TANH>(h[4 * j] + bb.x), gelu<TANH>(h[4 * j + 1] + bb.y));
    f[j / 2][2 * (j & 1) + 1] =
        pack_bf16(gelu<TANH>(h[4 * j + 2] + bb.x), gelu<TANH>(h[4 * j + 3] + bb.y));
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void wg_barrier(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(cw + 1) : "memory");  // one consumer warpgroup
}

// The weight ring as the consumers walk it: tile g sits in stage g % S
// with phase (g / S) & 1; a warp's lane 0 releases a stage once the
// warp's wgmma on it has completed (8 arrivals free it).
struct Ring {
  uint32_t stages_at, bars;
  int S, g;
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8u * (MAX_STAGES + s); }
  __device__ __forceinline__ uint32_t acquire() const {
    hopper::mbar_wait(full(g % S), (g / S) & 1);
    return stages_at + (g % S) * STAGE_BYTES;
  }
  __device__ __forceinline__ void release(int tile, int lane) const {
    if (lane == 0) hopper::mbar_arrive(empty(tile % S));
  }
};

// acc (+)= A[64 x CP] (KC swizzled chunks at `a_at`) @ the next KC ring
// tiles ([N, 64] each): one commit group a tile, the previous tile
// released once the next is issued.
template <int N, int CP>
__device__ __forceinline__ void gemm_a_smem(float (&acc)[N / 2], uint32_t a_at, Ring& rg,
                                            int lane) {
  constexpr int KC = (CP + 63) / 64;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const uint32_t tile = rg.acquire();
    hopper::wgmma_fence();
    const uint64_t da = hopper::desc_sw128(a_at + kc * 8192), db = hopper::desc_sw128(tile);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (16 * (4 * kc + k) < CP) hopper::Wgmma<N>::mma(acc, da + 2 * k, db + 2 * k, 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (kc > 0) rg.release(rg.g - 1, lane);
    ++rg.g;
  }
  hopper::wgmma_wait<0>();
  rg.release(rg.g - 1, lane);
  hopper::fence_operands(acc);
}

template <int WS, int CP, int HDP>
__global__ void __launch_bounds__(NTHREADS, 1) swin_block_wg_kernel(const Args a) {
  using L = Layout<CP, HDP>;
  constexpr int NT = WS * WS;
  constexpr int T2 = (2 * WS - 1) * (2 * WS - 1);
  constexpr int REL0 = (WS - 1) * (2 * WS - 1) + WS - 1;  // relative index of pos_i == pos_j
  constexpr int NJ = CP / 8;                               // 8-column groups of a row
  static_assert(NT <= 64, "one m64 tile a window");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const int S = a.stages;
  const uint32_t wins = ring + S * STAGE_BYTES;
  const uint32_t table_at = wins + NCONS * L::WIN_BYTES;
  const uint32_t bars = table_at + TABLE_BYTES;
  float* table = reinterpret_cast<float*>(smem_raw + (table_at - raw));
  Ring rg{ring, bars, S, 0};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < a.nh * T2; i += NTHREADS) table[i] = a.table[i];
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(rg.full(s), 1);   // the feeder's expect_tx; the bytes complete it
      hopper::mbar_init(rg.empty(s), 4 * NCONS);  // lane 0 of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int nww = a.w / WS, per_img = (a.h / WS) * nww;
  const int windows = a.batch * per_img;
  const int pairs = (windows + NCONS - 1) / NCONS;
  if (warp >= 4 * NCONS) {
    // ------------------------------------------------------ weight feeder
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid != 128 * NCONS) return;
    int g = 0;
    for (int pr = blockIdx.x; pr < pairs; pr += gridDim.x) {
      const char* src = reinterpret_cast<const char*>(a.tiles);
      auto push = [&](uint32_t bytes) {
        const int st = g % S;
        hopper::mbar_wait(rg.empty(st), ((g / S) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(rg.full(st), bytes);
        hopper::bulk_copy(ring + st * STAGE_BYTES, src, bytes, rg.full(st));
        src += bytes;
        ++g;
      };
      for (int i = 0; i < a.nh * L::KC; ++i) push(L::QKV_TILE);
      for (int i = 0; i < L::NH * L::KC; ++i) push(96 * 128);
      for (int j = 0; j < a.chunks; ++j) {
        for (int i = 0; i < L::KC; ++i) push(HC * 128);
        for (int i = 0; i < L::NH; ++i) push(96 * 128);
      }
    }
    return;
  }
  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int cw = warp >> 2, wi = warp & 3, q = lane & 3, ct = tid & 127;
  const int r0 = 16 * wi + (lane >> 2);  // the thread's token rows r0, r0 + 8
  const uint32_t abuf = wins + cw * L::WIN_BYTES;
  const uint32_t rbuf = abuf + L::A_BYTES;
  const uint32_t kbuf = rbuf + L::R_BYTES, vbuf = kbuf + L::KV_BYTES;
  // R: the attention output (the proj's A operand, [64, 64] swizzled
  // chunks) then the x stash; after the proj, x1 over the whole of it
  uint32_t* xst = reinterpret_cast<uint32_t*>(smem_raw + (rbuf - raw) + L::A_BYTES);
  float2* x1st = reinterpret_cast<float2*>(smem_raw + (rbuf - raw));
  const bool even = (a.c & 1) == 0;
  const bool shifted = a.shifted != 0;  // the caller's mask, not the codes' shape
  const float inv_c = 1.f / static_cast<float>(a.c);
  const float neg_inf = -__int_as_float(0x7f800000);
  auto a_off = [](uint32_t base, int row, int col) {  // bf16 (row, col) of swizzled chunks
    return base + (col >> 6) * 8192 + hopper::sw128_offset(row, (col & 63) * 2);
  };
  auto st32 = [](uint32_t at, uint32_t v) {
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(v) : "memory");
  };

  // element offset of token t (< NT) of window wv (cyclically shifted)
  auto token_off = [&](int wv, int t) {
    const int bidx = wv / per_img, win = wv - bidx * per_img;
    const int wy = win / nww, wx = win - wy * nww;
    const int rr = (wy * WS + t / WS + a.shift) % a.h;
    const int cc = (wx * WS + t % WS + a.shift) % a.w;
    return ((static_cast<long long>(bidx) * a.h + rr) * a.w + cc) * a.c;
  };

  for (int pr = blockIdx.x; pr < pairs; pr += gridDim.x) {
    const int w0 = NCONS * pr + cw;
    const bool active = w0 < windows;  // an odd last window: the other one recomputes, stores nothing
    const int wv = active ? w0 : windows - 1;
    const int bidx = wv / per_img, win = wv - bidx * per_img;
    const float m1 = a.scales ? a.scales[2 * bidx] : 1.f;
    const float m2 = a.scales ? a.scales[2 * bidx + 1] : 1.f;
    const bf16* xrow[2];
    const bf16* erow[2];
    bf16* yrow[2];
    bool row_ok[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int t = r0 + 8 * h2;
      row_ok[h2] = t < NT;
      const long long off = token_off(wv, row_ok[h2] ? t : 0);
      xrow[h2] = a.x + off;
      erow[h2] = a.extra ? a.extra + off : nullptr;
      yrow[h2] = a.y + off;
    }
    // each score's term from the tokens' codes, for every head: the table
    // index pos_i - pos_j + REL0, bit 16 set where the shift regions
    // differ (mask -100), bit 17 past the keys (index 0, score -inf); pad
    // rows take token 0's code
    const int* crow = a.codes + (shifted ? win : 0) * NT;
    int bcode[32];
    {
      int rcode[2], kcode[16];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) rcode[h2] = __ldg(crow + (row_ok[h2] ? r0 + 8 * h2 : 0));
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int col = 8 * (e >> 1) + 2 * q + (e & 1);
        kcode[e] = __ldg(crow + (col < NT ? col : 0));
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int h2 = (e >> 1) & 1, kc = kcode[2 * (e >> 2) + (e & 1)];
        const int col = 8 * (e >> 2) + 2 * q + (e & 1);
        const bool differ = shifted && (static_cast<unsigned>(rcode[h2] ^ kc) >> 16) != 0;
        bcode[e] = col >= NT ? 1 << 17
                             : ((rcode[h2] & 0xffff) - (kc & 0xffff) + REL0) | (differ << 16);
      }
    }
    wg_barrier(cw);  // the last pair's readers of R and the A buffer are done

    // ---- x (zero past C and in pad rows), LN1 -> the A buffer; x -> R
    {
      uint32_t xp[NJ][2];
      load_rows<NJ>(xp, xrow, row_ok, q, a.c, even);
      float s[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float2 f = unpack_bf16(xp[j][h2]);
          s[h2] += f.x + f.y;
          sq[h2] += f.x * f.x + f.y * f.y;
        }
      float mu[2], rs[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mu[h2] = quad_sum(s[h2]) * inv_c;
        rs[h2] = rsqrtf(fmaxf(quad_sum(sq[h2]) * inv_c - mu[h2] * mu[h2], 0.f) + a.eps);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 8 * j + 2 * q;
        const float2 g = load_vec2(a.g1, col, a.c), b = load_vec2(a.b1, col, a.c);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float2 f = unpack_bf16(xp[j][h2]);
          const float v0 = col < a.c ? (f.x - mu[h2]) * rs[h2] * g.x + b.x : 0.f;
          const float v1 = col + 1 < a.c ? (f.y - mu[h2]) * rs[h2] * g.y + b.y : 0.f;
          st32(a_off(abuf, r0 + 8 * h2, col), pack_bf16(v0, v1));
          xst[(2 * j + h2) * 128 + ct] = xp[j][h2];
        }
      }
    }
    hopper::fence_proxy_async();  // the LN1 writes, before wgmma reads them
    wg_barrier(cw);

    // ---- attention, a head at a time: qkv, S = Q K^T, softmax, O = P V
    for (int hh = 0; hh < a.nh; ++hh) {
      float acc[3 * HDP / 2];
#pragma unroll
      for (int e = 0; e < 3 * HDP / 2; ++e) acc[e] = 0.f;
      // the bias, loaded while the products run (no load crosses a wgmma wait)
      float2 bqv[3 * HDP / 8];
#pragma unroll
      for (int j = 0; j < 3 * HDP / 8; ++j)
        bqv[j] = __ldg(reinterpret_cast<const float2*>(a.bqkv + hh * 3 * HDP + 8 * j + 2 * q));
      gemm_a_smem<3 * HDP, CP>(acc, abuf, rg, lane);
      // q -> A fragments; k, v -> the head's swizzled [64, HDP] tiles
      wg_barrier(cw);  // the last head's Q K^T and P V have read k and v
      uint32_t qf[HDP / 16][4];
#pragma unroll
      for (int j = 0; j < 3 * HDP / 8; ++j) {
        const int n = 8 * j + 2 * q;
        const float2 bb = bqv[j];
        const uint32_t lo = pack_bf16(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
        const uint32_t hi = pack_bf16(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
        if (8 * j < HDP) {
          qf[j / 2][2 * (j & 1)] = lo;
          qf[j / 2][2 * (j & 1) + 1] = hi;
        } else {
          const uint32_t dst = 8 * j < 2 * HDP ? kbuf : vbuf;
          const int d = (8 * j) % HDP + 2 * q;
          st32(dst + hopper::swizzled_offset<L::RB>(r0 * L::RB + d * 2), lo);
          st32(dst + hopper::swizzled_offset<L::RB>((r0 + 8) * L::RB + d * 2), hi);
        }
      }
      hopper::fence_proxy_async();
      wg_barrier(cw);
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        hopper::WgmmaRSK<64>::mma(sc, qf[kk], hopper::desc_swizzled<L::RB>(kbuf) + 2 * kk, 1);
      hopper::wgmma_commit();
      // the head's bias terms (the table at the codes' relative index),
      // read while Q K^T runs
      const float* tb = table + hh * T2;
      float tv[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) tv[e] = tb[bcode[e] & 0xffff];
      hopper::wgmma_wait<0>();
      hopper::fence_operands(sc);
      // + bias, + the shift mask, -inf past the keys; softmax in fp32
      float mx[2] = {neg_inf, neg_inf};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int h2 = (e >> 1) & 1, bc = bcode[e];
        const float v = sc[e] + tv[e];
        sc[e] = NT < 64 && (bc & 0x20000) ? neg_inf : (bc & 0x10000) ? v + -100.f : v;
        mx[h2] = fmaxf(mx[h2], sc[e]);
      }
      float l[2] = {0.f, 0.f};
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int h2 = (e >> 1) & 1;
        sc[e] = __expf(sc[e] - mx[h2]);  // 0 at -inf; key 0 is real, so the max is finite
        l[h2] += sc[e];
      }
      const float inv0 = __fdividef(1.f, quad_sum(l[0])), inv1 = __fdividef(1.f, quad_sum(l[1]));
      uint32_t pf[4][4];
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        pf[kb][0] = pack_bf16(sc[8 * kb] * inv0, sc[8 * kb + 1] * inv0);
        pf[kb][1] = pack_bf16(sc[8 * kb + 2] * inv1, sc[8 * kb + 3] * inv1);
        pf[kb][2] = pack_bf16(sc[8 * kb + 4] * inv0, sc[8 * kb + 5] * inv0);
        pf[kb][3] = pack_bf16(sc[8 * kb + 6] * inv1, sc[8 * kb + 7] * inv1);
      }
      float o[HDP / 2];
#pragma unroll
      for (int e = 0; e < HDP / 2; ++e) o[e] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        hopper::WgmmaRS<HDP>::mma(o, pf[kb], hopper::desc_swizzled<L::RB>(vbuf + kb * 16 * L::RB),
                                  1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(o);
      // O_h -> columns hh * HDP.. of the attention output
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        const int col = hh * HDP + 8 * j + 2 * q;
        st32(a_off(rbuf, r0, col), pack_bf16(o[4 * j], o[4 * j + 1]));
        st32(a_off(rbuf, r0 + 8, col), pack_bf16(o[4 * j + 2], o[4 * j + 3]));
      }
    }
    // the proj reads CP columns: zero those past the heads
    for (int col = a.nh * HDP + 2 * q; col < CP; col += 8) {
      st32(a_off(rbuf, r0, col), 0u);
      st32(a_off(rbuf, r0 + 8, col), 0u);
    }
    hopper::fence_proxy_async();
    wg_barrier(cw);

    // ---- x1 = x + m1 (O Wproj + bproj) + extra, in the proj's registers
    // (extra's loads in flight during the proj)
    uint32_t ep[NJ][2];
    if (a.extra) {
      load_rows<NJ>(ep, erow, row_ok, q, a.c, even);
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j) ep[j][0] = ep[j][1] = 0u;
    }
    float pacc[L::NH][48];
#pragma unroll
    for (int hf = 0; hf < L::NH; ++hf) {
#pragma unroll
      for (int e = 0; e < 48; ++e) pacc[hf][e] = 0.f;
      gemm_a_smem<96, CP>(pacc[hf], rbuf, rg, lane);
    }
    float s[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < L::NH; ++hf)
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int jg = 12 * hf + j, col = 8 * jg + 2 * q;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bproj + col));
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float2 xv = unpack_bf16(xst[(2 * jg + h2) * 128 + ct]);
          const float2 ev = unpack_bf16(ep[jg][h2]);  // zero without extra
          const float v0 = xv.x + m1 * (pacc[hf][4 * j + 2 * h2] + bb.x) + ev.x;
          const float v1 = xv.y + m1 * (pacc[hf][4 * j + 2 * h2 + 1] + bb.y) + ev.y;
          pacc[hf][4 * j + 2 * h2] = v0;
          pacc[hf][4 * j + 2 * h2 + 1] = v1;
          s[h2] += v0 + v1;  // zero past C
          sq[h2] += v0 * v0 + v1 * v1;
        }
      }
    float mu[2], rs[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      mu[h2] = quad_sum(s[h2]) * inv_c;
      rs[h2] = rsqrtf(fmaxf(quad_sum(sq[h2]) * inv_c - mu[h2] * mu[h2], 0.f) + a.eps);
    }
    wg_barrier(cw);  // every thread has read its x from R and the proj has read O
    // LN2 -> the A buffer; x1 -> R
#pragma unroll
    for (int hf = 0; hf < L::NH; ++hf)
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int jg = 12 * hf + j, col = 8 * jg + 2 * q;
        const float2 g = load_vec2(a.g2, col, a.c), b = load_vec2(a.b2, col, a.c);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float v0 = pacc[hf][4 * j + 2 * h2], v1 = pacc[hf][4 * j + 2 * h2 + 1];
          st32(a_off(abuf, r0 + 8 * h2, col),
               pack_bf16(col < a.c ? (v0 - mu[h2]) * rs[h2] * g.x + b.x : 0.f,
                         col + 1 < a.c ? (v1 - mu[h2]) * rs[h2] * g.y + b.y : 0.f));
          x1st[(2 * jg + h2) * 128 + ct] = make_float2(v0, v1);
        }
      }
    hopper::fence_proxy_async();
    wg_barrier(cw);

    // ---- MLP in 64-column hidden chunks: fc1 (A from the buffer), GELU,
    // fc2 (A from registers), accumulated over the chunks
    float acc2[L::NH][48];
#pragma unroll
    for (int hf = 0; hf < L::NH; ++hf)
#pragma unroll
      for (int e = 0; e < 48; ++e) acc2[hf][e] = 0.f;
    if (pr + static_cast<int>(gridDim.x) < pairs) {
      // the next pair's rows of x and extra into L2 while the MLP runs
      // (thread q of a row takes its q-th 128-byte line)
      const int nw = min(NCONS * (pr + static_cast<int>(gridDim.x)) + cw, windows - 1);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int t = r0 + 8 * h2;
        if (t < NT && 64 * q < a.c) {
          const long long off = token_off(nw, t) + 64 * q;
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a.x + off));
          if (a.extra) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a.extra + off));
        }
      }
    }
    for (int jc = 0; jc < a.chunks; ++jc) {
      float hacc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) hacc[e] = 0.f;
      float2 b1v[8];  // the chunk's bias, loaded while fc1 runs
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b1v[j] = __ldg(reinterpret_cast<const float2*>(a.bfc1 + HC * jc + 8 * j + 2 * q));
      gemm_a_smem<HC, CP>(hacc, abuf, rg, lane);
      uint32_t hf16[4][4];
      if (a.gelu_tanh)
        hidden_fragments<true>(hf16, hacc, b1v);
      else
        hidden_fragments<false>(hf16, hacc, b1v);
#pragma unroll
      for (int hf = 0; hf < L::NH; ++hf) {
        const uint32_t tile = rg.acquire();
        hopper::wgmma_fence();
        const uint64_t db = hopper::desc_sw128(tile);
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) hopper::WgmmaRSK<96>::mma(acc2[hf], hf16[kb], db + 2 * kb, 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        if (hf > 0) rg.release(rg.g - 1, lane);
        ++rg.g;
      }
      hopper::wgmma_wait<0>();
      rg.release(rg.g - 1, lane);
    }
#pragma unroll
    for (int hf = 0; hf < L::NH; ++hf) hopper::fence_operands(acc2[hf]);

    // ---- out = x1 + m2 (fc2 + bfc2), in the accumulators (every load
    // before any store), then the window's real rows and channels stored
#pragma unroll
    for (int hf = 0; hf < L::NH; ++hf)
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int jg = 12 * hf + j;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bfc2 + 8 * jg + 2 * q));
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float2 x1 = x1st[(2 * jg + h2) * 128 + ct];
          acc2[hf][4 * j + 2 * h2] = x1.x + m2 * (acc2[hf][4 * j + 2 * h2] + bb.x);
          acc2[hf][4 * j + 2 * h2 + 1] = x1.y + m2 * (acc2[hf][4 * j + 2 * h2 + 1] + bb.y);
        }
      }
#pragma unroll
    for (int hf = 0; hf < L::NH; ++hf)
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int col = 8 * (12 * hf + j) + 2 * q;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          if (!active || !row_ok[h2] || col >= a.c) continue;
          const float v0 = acc2[hf][4 * j + 2 * h2], v1 = acc2[hf][4 * j + 2 * h2 + 1];
          if (even) {
            *reinterpret_cast<uint32_t*>(yrow[h2] + col) = pack_bf16(v0, v1);
          } else {
            yrow[h2][col] = __float2bfloat16(v0);
            if (col + 1 < a.c) yrow[h2][col + 1] = __float2bfloat16(v1);
          }
        }
      }
  }
}

template <int WS, int CP, int HDP>
int launch(const Args& a, cudaStream_t stream) {
  using L = Layout<CP, HDP>;
  const int smem = L::FIXED + a.stages * STAGE_BYTES;
  if (a.stages < 2 || a.stages > MAX_STAGES || smem > SMEM_LIMIT || a.nh * HDP > CP)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = swin_block_wg_kernel<WS, CP, HDP>;
  static const cudaError_t attr =  // once: the most any launch takes
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long pairs =
      (static_cast<long long>(a.batch) * (a.h / WS) * (a.w / WS) + NCONS - 1) / NCONS;
  if (pairs == 0) return 0;
  const int grid = pairs < sms ? static_cast<int>(pairs) : sms;
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int WS>
int launch_ws(const Args& a, int cp, int hdp, cudaStream_t s) {
  if (cp == 96 && hdp == 16) return launch<WS, 96, 16>(a, s);
  if (cp == 96 && hdp == 32) return launch<WS, 96, 32>(a, s);
  if (cp == 192 && hdp == 32) return launch<WS, 192, 32>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, extra (or null), y [batch, h, w, c] bf16; tiles, the biases, the
// table and the codes as kernels/fused_block.py ``pack_block_tiles`` and
// ops/window.py ``window_codes_tensor`` lay them out (shifted: the codes
// hold a row a window of the image and carry the mask's regions, else
// one row); scales [batch, 2] or null;
// cp, hdp, stages: the launch plan (fused_block.block_plan decides it;
// this entry only checks it).  cudaErrorInvalidValue where the shapes or
// the plan are outside the kernel.
extern "C" int sr_swin_block_bf16(const void* x, const void* extra, void* y, const void* tiles,
                                  const void* bqkv, const void* bproj, const void* bfc1,
                                  const void* bfc2, const void* g1, const void* b1,
                                  const void* g2, const void* b2, const void* table,
                                  const void* codes, const void* scales, int batch, int h, int w,
                                  int c, int nh, int hidden, int ws, int shift, int shifted,
                                  int cp, int hdp, int stages, int gelu_tanh, float eps,
                                  void* stream) {
  if (c < 1 || c > cp || nh < 1 || nh > MAX_HEADS || c % nh || c / nh > hdp || hidden < 1 ||
      hidden > 384 || (ws != 7 && ws != 8) || h % ws || w % ws || shift < 0 || shift >= ws ||
      !aligned_to(tiles, 16) || !aligned_to(bqkv, 8) || !aligned_to(bproj, 8) ||
      !aligned_to(bfc1, 8) || !aligned_to(bfc2, 8) ||
      (c % 2 == 0 && !(aligned_to(x, 4) && aligned_to(y, 4) && (!extra || aligned_to(extra, 4)))))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.extra = static_cast<const bf16*>(extra);
  a.y = static_cast<bf16*>(y);
  a.tiles = static_cast<const bf16*>(tiles);
  a.bqkv = static_cast<const float*>(bqkv);
  a.bproj = static_cast<const float*>(bproj);
  a.bfc1 = static_cast<const float*>(bfc1);
  a.bfc2 = static_cast<const float*>(bfc2);
  a.g1 = static_cast<const float*>(g1);
  a.b1 = static_cast<const float*>(b1);
  a.g2 = static_cast<const float*>(g2);
  a.b2 = static_cast<const float*>(b2);
  a.table = static_cast<const float*>(table);
  a.codes = static_cast<const int*>(codes);
  a.scales = static_cast<const float*>(scales);
  a.batch = batch;
  a.h = h;
  a.w = w;
  a.c = c;
  a.nh = nh;
  a.chunks = (hidden + HC - 1) / HC;
  a.shift = shift;
  a.shifted = shifted;
  a.gelu_tanh = gelu_tanh;
  a.stages = stages;
  a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ws == 7 ? launch_ws<7>(a, cp, hdp, s) : launch_ws<8>(a, cp, hdp, s);
}
