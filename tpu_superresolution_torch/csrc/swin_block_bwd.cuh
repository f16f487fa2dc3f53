// The per-window kernel of K5 / K6b (K5a in csrc/swin_block_bwd.cu, which
// describes the design) and what it shares with K5b: one template, whose
// six instantiations (ws 7 / 8 x the forward's widths 96 / 16, 96 / 32,
// 192 / 32) are compiled in files of their own, in parallel
// (swin_block_bwd_i<ws>_<cp>_<hdp>.cu).  At ws 16 (K5w16, csrc/
// swin_block_bwd16.cu) the same template runs a window's four 64-token
// tiles as its units, in three modes around the attention kernels: the
// front (LN1, qkv), the middle (proj .. do, with O read back) and the
// tail (dy, LN1's backward, dx); swin_block_bwd_i16_<cp>_<hdp>.cu.  K5r
// runs the same three modes at ws 8, a window one unit, at padded width
// 256 (the proj's and fc2's N parts of 128 rows; the wide accumulators
// walked in 128-column halves, see SPLIT below);
// swin_block_bwd_i8w_256_32.cu.  HAT's OCAB core at ws 16 (K8w16 /
// K8bw16, csrc/ocab16.cu) runs the middle as its backward's token-local
// part (the residual x its sw, d extra its dsw) and a fourth mode as its
// forward's tail (O read back, x1, LN2, the MLP, the residual: the
// output); swin_block_bwd_i16o_<cp>_<hdp>.cu.  At ws 7 and 8 (K8 and K8b,
// csrc/ocab_bwd.cu) the forward's tail and the middle run a window a unit
// (ws 7: 49 real rows of 64); swin_block_bwd_i7of_ / _i8of_<cp>_<hdp>.cu
// (the tail) and swin_block_bwd_i7o_ / _i8o_<cp>_<hdp>.cu (the middle).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace swin_bwd {

constexpr int NCONS = 2;                      // consumer warpgroups: a window each
constexpr int NTHREADS = 128 * (NCONS + 1);   // + the weight feeder's warpgroup
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_HEADS = 6;                  // the block kernel's widths (K5, K6b, K5w16)
constexpr int K5R_MAX_HEADS = 8;              // K5r's (its tiled modes keep no table)
constexpr int TABLE_BYTES = MAX_HEADS * 225 * 4;  // [nh, (2ws-1)^2] fp32, ws <= 8
constexpr int HC = 64;                        // MLP hidden columns a chunk
constexpr int TILE_ELEMS = 64 * 64;           // a workspace tile: [64 tokens, 64]
constexpr int W16_TOKENS = 256;               // a ws-16 window: four 64-token units

// What a launch of K5a runs: a whole ws-7 / ws-8 window a unit, or at ws
// 16 one of the three token-local parts of a 64-token tile, or the OCAB
// forward's tail over one (MODE_OFWD).
enum { MODE_WHOLE, MODE_FRONT, MODE_MID, MODE_TAIL, MODE_OFWD };

__host__ __device__ constexpr int round1024(int v) { return (v + 1023) / 1024 * 1024; }

// Rows of an N part of the proj's and fc2's tiles in the weight stream
// (kernels/fused_block.py block_plan's pw): 96 at the block kernel's
// widths, 128 at K5r's 256.  A ring stage holds one [pw, 64] tile.
__host__ __device__ constexpr int part_width(int cp) { return cp == 256 ? 128 : 96; }

// The per-window shared memory of K5a (kernels/fused_block.py bwd_plan
// reckons the same): the A buffer (yc, y2c, dattn, yc), the R buffer (O,
// dmlp, the heads' do tiles), the head's q, k, v tiles and the softmax
// row statistics (max, 1 / sum, rowsum(dA A)).
template <int CP, int HDP>
struct Layout {
  static_assert(CP == 96 || CP == 192 || CP == 256, "compiled widths");
  static_assert(HDP == 16 || HDP == 32, "compiled head dims");
  static constexpr int KC = (CP + 63) / 64;  // 64-column K chunks of an A operand
  static constexpr int PW = part_width(CP);  // rows of an N part of the proj and fc2 tiles
  static constexpr int NH = CP / PW;         // N parts of the proj and fc2 tiles
  static constexpr int STAGE = PW * 128;     // a ring stage: one [<= PW, 64] tile
  static constexpr int RB = 2 * HDP;         // bytes a row of a head's [64, hdp] tile
  static constexpr int A_BYTES = KC * 8192;
  static constexpr int R_BYTES = KC * 8192;  // >= the heads' do tiles: nh hdp <= CP
  static constexpr int HT_BYTES = 64 * RB;   // one head tile
  static constexpr int STAT_BYTES = 1024;
  static constexpr int WIN_BYTES = A_BYTES + R_BYTES + 3 * HT_BYTES + STAT_BYTES;
  static constexpr int QKV_TILE = 3 * HDP * 128;
  static constexpr int CHUNK_BYTES = KC * 8192 + NH * STAGE;  // fc1 then fc2 tiles of a chunk
  static constexpr int FIXED = 1024 + NCONS * WIN_BYTES + TABLE_BYTES + 2 * MAX_STAGES * 8;
};

// The eight dW operands of the workspace, in this order: X of each
// product, then dY: yc, o, y2c, act, dqkv, dattn, dh1, dmlp.
enum { OP_YC, OP_O, OP_Y2C, OP_ACT, OP_DQKV, OP_DATTN, OP_DH1, OP_DMLP, N_OPS };

struct Args {
  const bf16* ct;
  const bf16* x;
  const bf16* extra;  // [batch, h, w, c] or null
  bf16* dx;
  bf16* dextra;       // dx1 where not null (the caller passes it with extra)
  bf16* out;          // MODE_OFWD's output, [batch, h, w, c]
  const bf16* tiles;  // the forward's weight stream (pack_block_tiles)
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
  bf16* op[N_OPS];     // workspace operands, [windows][op_tiles][64][64] swizzled
  int op_tiles[N_OPS];
  float* x1ws;  // [grid][NCONS][64 CP]: x1, then dx1 (tiled: [units + units % 2][64 CP];
                // MODE_OFWD: [grid][NCONS][64 CP], x1 only)
  float* pvec;  // [grid][NCONS][4][vl]: LayerNorm sums per warp
  float* prpb;  // [grid][NCONS][nh][64][64]: d(rpb) (not in the tiled modes)
  // the tiled modes (swin_block_bwd16.cu): a window's heads as [ws^2,
  // HDP] tiles, rows swizzled as the head tiles in shared memory
  bf16* qkvh;   // [windows][nh][3][ws^2][HDP]: q (pre-scaled), k, v (the front)
  bf16* doh;    // [windows][nh][ws^2][HDP]: do (the middle; at ws 7 64 rows, the
                //   pad rows' zero)
  float* drow;  // [windows][nh][ws^2]: rowsum(do o) per head (the middle; ws 7: 64)
  int vl;       // the LN sums' vector: g1 | b1 | g2 | b2, CP each
  int batch, h, w, c, nh, chunks, shift, shifted, gelu_tanh, stages;
  float eps;
};

// One segment of K5c's ordered sums: out[j] = sum over the rows r of
// part[r][j], [rows][cols] fp32.
struct RSeg {
  const float* part;
  long long rows, cols;
  float* out;
};

// K5b and K5c (csrc/swin_block_bwd.cu) on the workspace K5a left in
// `a.op` over `units` 64-token units: the four dW products split over
// the units into `pw`, then the ordered sums of pw -> [wgrad | vec's
// bias part], and of the two segments `ln` (the LayerNorm sums' partials)
// and `rpb` (the d(rpb) partials).
int launch_wgrad_reduce(const Args& a, long long units, int cp, int hdp, int splits, float* pw,
                        float* wgrad, float* vec, const RSeg& ln, const RSeg& rpb,
                        cudaStream_t s);

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// The bf16 pairs (8 j + 2 q, + 1) of the thread's two rows, zero past c
// and in rows that are not real; every load unconditional (clamped), as
// csrc/swin_block.cu.
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

// One bf16 pair (col, col + 1) of a [c]-wide row, zero past c and in rows
// that are not real: two 2-byte loads, clamped into the row, no branch
// (any C).
__device__ __forceinline__ uint32_t load_pair_u32(const bf16* row, bool ok, int col, int c) {
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  const uint32_t lo = __ldg(r + (col < c ? col : c - 1));
  const uint32_t hi = __ldg(r + (col + 1 < c ? col + 1 : c - 1));
  return ok ? (col < c ? lo : 0u) | (col + 1 < c ? hi << 16 : 0u) : 0u;
}

__device__ __forceinline__ float2 load_pair(const bf16* row, bool ok, int col, int c) {
  return unpack_bf16(load_pair_u32(row, ok, col, c));
}

// Stores (col, col + 1) of a row where they are below `c` (0 for a row
// that must not be written).
__device__ __forceinline__ void store_pair(bf16* row, int col, int c, float v0, float v1) {
  if (col < c) row[col] = __float2bfloat16(v0);
  if (col + 1 < c) row[col + 1] = __float2bfloat16(v1);
}

__device__ __forceinline__ float2 load_vec2(const float* v, int col, int c) {
  return make_float2(col < c ? __ldg(v + col) : 0.f, col + 1 < c ? __ldg(v + col + 1) : 0.f);
}

// GELU's two forms and their derivative, from one tanh / erf:
// (gelu(u), gelu'(u)), as kernels/fused_block.py gelu / gelu_grad.
template <bool TANH>
__device__ __forceinline__ float2 gelu_and_grad(float u) {
  if (TANH) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    const float th = tanhf(k * (u + 0.044715f * u * u * u));
    return make_float2(0.5f * u * (1.f + th),
                       0.5f * (1.f + th) +
                           0.5f * u * (1.f - th * th) * k * (1.f + 3.f * 0.044715f * u * u));
  }
  const float phi = 0.5f * (1.f + erff(u * 0.7071067811865476f));
  return make_float2(u * phi, phi + u * __expf(-0.5f * u * u) * 0.3989422804014327f);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void wg_barrier(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(cw + 1) : "memory");  // one consumer warpgroup
}

__device__ __forceinline__ void st32(uint32_t at, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld32(uint32_t at) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(at) : "memory");
  return v;
}

// Element offset of (row, col) in a workspace operand of a window: [64,
// 64] tiles along the columns, each 128B-swizzled as the wgmma tiles are.
__device__ __forceinline__ int ws_off(int row, int col) {
  return (col >> 6) * TILE_ELEMS + row * 64 + ((((col & 63) >> 3) ^ (row & 7)) << 3) + (col & 7);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], both from shared memory, A
// K-major (TA 0) or MN-major (TA 1), B K-major (TB 0) or MN-major (TB 1)
// (the instruction's transpose bits), D as hopper::Wgmma<64>'s.
template <int TA, int TB>
struct Wgmma64T {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

// The weight ring as the consumers walk it (csrc/swin_block.cu's): tile g
// in stage g % S with phase (g / S) & 1; lane 0 of each consumer warp
// releases a stage once its wgmma on it completed (8 arrivals free it).
struct Ring {
  uint32_t stages_at, bars;
  int S, g;
  uint32_t stage;  // bytes a stage
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8u * (MAX_STAGES + s); }
  __device__ __forceinline__ uint32_t acquire() const {
    hopper::mbar_wait(full(g % S), (g / S) & 1);
    return stages_at + (g % S) * stage;
  }
  __device__ __forceinline__ void release(int tile, int lane) const {
    if (lane == 0) hopper::mbar_arrive(empty(tile % S));
  }
};

// acc (+)= A[64 x CP] (KC swizzled chunks at `a_at`) @ the next KC ring
// tiles read K-major ([N, 64] each: Y W^T).
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

// acc[64 x 64] (+)= A[64 x CP] (KC swizzled chunks at `a_at`) @ the next
// NH ring tiles read MN-major ([PW rows of K, 64 of N] each: dY W, K the
// tile's out rows).
template <int CP>
__device__ __forceinline__ void gemm_mn(float (&acc)[32], uint32_t a_at, Ring& rg, int lane) {
  constexpr int PW = part_width(CP), NH = CP / PW;
#pragma unroll
  for (int hf = 0; hf < NH; ++hf) {
    const uint32_t tile = rg.acquire();
    hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < PW / 16; ++s) {
      const int col = PW * hf + 16 * s;
      const uint64_t da = hopper::desc_sw128(a_at + (col >> 6) * 8192) + 2 * ((col & 63) >> 4);
      Wgmma64T<0, 1>::mma(acc, da, hopper::desc_sw128(tile + s * 2048), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (hf > 0) rg.release(rg.g - 1, lane);
    ++rg.g;
  }
  hopper::wgmma_wait<0>();
  rg.release(rg.g - 1, lane);
  hopper::fence_operands(acc);
}

// acc[kc] (+)= F @ the next KC ring tiles read MN-major: F the A fragments
// of KS k16 steps ([64 x 16 KS] in registers), each tile [16 KS rows of
// K, 64 of N] (dy2 += dh1 Wfc1 and dy += dqkv_h Wqkv_h).
template <int KS, int KC>
__device__ __forceinline__ void rs_mn(float (&acc)[KC][32], const uint32_t (&f)[KS][4], Ring& rg,
                                      int lane) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const uint32_t tile = rg.acquire();
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      hopper::WgmmaRS<64>::mma(acc[kc], f[kk], hopper::desc_sw128(tile + kk * 2048), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (kc > 0) rg.release(rg.g - 1, lane);
    ++rg.g;
  }
  hopper::wgmma_wait<0>();
  rg.release(rg.g - 1, lane);
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) hopper::fence_operands(acc[kc]);
}

// The warp's 16-row sums of columns 8 j + 2 q (+ 1), j < NJV, of values
// in the accumulator layout (v[4 j + {0, 1}] row r0, v[4 j + {2, 3}] row
// r0 + 8), added to p[8 j + 2 q] by lanes 0-3 (the same thread owns the
// same columns on every call: no ordering needed); j < nj only.
template <int NJV>
__device__ __forceinline__ void colsum(float* p, const float (&v)[4 * NJV], int lane, bool on,
                                       int nj = NJV) {
  float2 s[NJV];
#pragma unroll
  for (int j = 0; j < NJV; ++j) {
    s[j] = make_float2(v[4 * j] + v[4 * j + 2], v[4 * j + 1] + v[4 * j + 3]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s[j].x += __shfl_xor_sync(0xffffffffu, s[j].x, o);
      s[j].y += __shfl_xor_sync(0xffffffffu, s[j].y, o);
    }
  }
  if (on && lane < 4) {  // every load before any store: one round trip
    float2* d = reinterpret_cast<float2*>(p + 2 * lane);
    float2 t[NJV];
#pragma unroll
    for (int j = 0; j < NJV; ++j)
      if (j < nj) t[j] = d[4 * j];
#pragma unroll
    for (int j = 0; j < NJV; ++j)
      if (j < nj) d[4 * j] = make_float2(t[j].x + s[j].x, t[j].y + s[j].y);
  }
}

// A fragments of k16 step kk of a [64, RB/2] head tile (RB-byte rows,
// swizzled; rows r0, r0 + 8).
template <int RB>
__device__ __forceinline__ void tile_frag(uint32_t (&f)[4], uint32_t tile, int r0, int q, int kk) {
  const int c0 = 16 * kk + 2 * q;
  f[0] = ld32(tile + hopper::swizzled_offset<RB>(r0 * RB + c0 * 2));
  f[1] = ld32(tile + hopper::swizzled_offset<RB>((r0 + 8) * RB + c0 * 2));
  f[2] = ld32(tile + hopper::swizzled_offset<RB>(r0 * RB + (c0 + 8) * 2));
  f[3] = ld32(tile + hopper::swizzled_offset<RB>((r0 + 8) * RB + (c0 + 8) * 2));
}

// acc = A (fragments of HDP / 16 k16 steps) x the 64 rows of a head tile
// at `bt` read K-major: S = Q K^T, S^T = K Q^T, dP = dO V^T, dP^T = V dO^T.
template <int HDP>
__device__ __forceinline__ void rows_product(float (&acc)[32], const uint32_t (&af)[HDP / 16][4],
                                             uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    hopper::WgmmaRSK<64>::mma(acc, af[kk], hopper::desc_swizzled<2 * HDP>(bt) + 2 * kk, 1);
}

// acc += F (a 64 x 64 block as four k16 A fragments) x the 64 rows of a
// head tile at `bt` read MN-major: O += P V, dQ += dS K, dK += dS^T Q,
// dV += P^T dO.
template <int HDP>
__device__ __forceinline__ void block_product(float (&acc)[HDP / 2], const uint32_t (&f)[4][4],
                                              uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::WgmmaRS<HDP>::mma(acc, f[kk], hopper::desc_swizzled<2 * HDP>(bt + kk * 16 * 2 * HDP),
                              1);
}

__device__ __forceinline__ void to_frags(uint32_t (&f)[4][4], const float (&v)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) f[kk][i] = pack_bf16(v[8 * kk + 2 * i], v[8 * kk + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&v)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) v[e] = 0.f;
}

// bf16 pairs of a [64, HDP] result (rows r0, r0 + 8) -> the workspace
// operand `ws` of unit tiles, columns col0 + d.
template <int HDP>
__device__ __forceinline__ void store_head(bf16* ws, const float (&v)[HDP / 2], int r0, int col0,
                                           int q) {
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = col0 + 8 * j + 2 * q;
    *reinterpret_cast<uint32_t*>(ws + ws_off(r0, col)) = pack_bf16(v[4 * j], v[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(ws + ws_off(r0 + 8, col)) = pack_bf16(v[4 * j + 2], v[4 * j + 3]);
  }
}

// acc[hf] (+)= F @ the next NP ring tiles read K-major, F the A fragments
// of one 64-column hidden chunk, each tile an N part [96 rows of N, 64 of
// K] (the OCAB forward's fc2: out += act Wfc2^T).
template <int NP>
__device__ __forceinline__ void rs_k96(float (&acc)[NP][48], const uint32_t (&f)[4][4], Ring& rg,
                                       int lane) {
#pragma unroll
  for (int hf = 0; hf < NP; ++hf) {
    const uint32_t tile = rg.acquire();
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::WgmmaRSK<96>::mma(acc[hf], f[kk], hopper::desc_sw128(tile) + 2 * kk, 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (hf > 0) rg.release(rg.g - 1, lane);
    ++rg.g;
  }
  hopper::wgmma_wait<0>();
  rg.release(rg.g - 1, lane);
#pragma unroll
  for (int hf = 0; hf < NP; ++hf) hopper::fence_operands(acc[hf]);
}

template <int WS, int CP, int HDP, int MODE = MODE_WHOLE>
__global__ void __launch_bounds__(NTHREADS, 1) swin_block_bwd_kernel(const Args a) {
  using L = Layout<CP, HDP>;
  // the tiled modes: a unit is one 64-token tile of a window (ws 16: tile
  // u % 4 of window u / 4; ws 8: window u; ws 7, the OCAB's middle:
  // window u, its 49 tokens in a 64-row tile)
  constexpr bool TILED = MODE != MODE_WHOLE;
  static_assert(TILED ? (WS == 16 || WS == 8 || (WS == 7 && (MODE == MODE_MID || MODE == MODE_OFWD)))
                      : (WS == 7 || WS == 8),
                "ws 16 (K5w16), ws 8 (K5r, K8, K8b) and ws 7 (K8's tail, K8b's middle) run as "
                "the tiled modes, ws 7 / 8 whole");
  constexpr int WTOK = WS * WS;                 // a window's tokens
  constexpr int TPW = TILED ? (WTOK + 63) / 64 : 1;  // units a window
  constexpr int NT = TILED ? (WTOK < 64 ? WTOK : 64) : WS * WS;  // a unit's real rows
  constexpr int HROWS = TILED ? TPW * 64 : WTOK;  // rows of the head tiles doh / drow
  constexpr int T2 = (2 * WS - 1) * (2 * WS - 1);
  constexpr int REL0 = (WS - 1) * (2 * WS - 1) + WS - 1;  // relative index of pos_i == pos_j
  constexpr int NJ = CP / 8;                               // 8-column groups of a row
  constexpr int KC = L::KC, NH = L::NH, RB = L::RB, Q3 = 3 * HDP, PW = L::PW;
  constexpr int GP = PW / 8;                               // 8-column groups of an N part
  // SPLIT (K5r, cp 256): a [64, 256] fp32 accumulator is 128 registers a
  // thread, so the proj's x1, dy2 and dy are walked in 128-column halves
  // (dy2's and dy's first half parked in fp32 in a free buffer meanwhile)
  constexpr bool SPLIT = CP == 256;
  constexpr int KD = SPLIT ? KC / 2 : KC;  // dy2's and dy's K chunks a pass
  static_assert(!SPLIT || TILED, "cp 256 runs the tiled modes only");
  static_assert(MODE != MODE_OFWD || !SPLIT, "the OCAB forward's tail: cp <= 192");
  static_assert(NT <= 64, "one m64 tile a window");
  static_assert(NJ % GP == 0, "the proj's N parts and the dmlp groups");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const int S = a.stages;
  const uint32_t wins = ring + S * L::STAGE;
  const uint32_t table_at = wins + NCONS * L::WIN_BYTES;
  const uint32_t bars = table_at + TABLE_BYTES;
  float* table = reinterpret_cast<float*>(smem_raw + (table_at - raw));
  Ring rg{ring, bars, S, 0, static_cast<uint32_t>(L::STAGE)};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if constexpr (!TILED)
    for (int i = tid; i < a.nh * T2; i += NTHREADS) table[i] = a.table[i];
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(rg.full(s), 1);
      hopper::mbar_init(rg.empty(s), 4 * NCONS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int nww = a.w / WS, per_img = (a.h / WS) * nww;
  const int windows = a.batch * per_img * TPW;  // units
  const int pairs = (windows + NCONS - 1) / NCONS;
  if (warp >= 4 * NCONS) {
    // ------------------------------------------------------ weight feeder
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid != 128 * NCONS) return;
    const char* base = reinterpret_cast<const char*>(a.tiles);
    const char* proj0 = base + static_cast<size_t>(a.nh) * KC * L::QKV_TILE;
    const char* mlp0 = proj0 + NH * KC * L::STAGE;
    int g = 0;
    auto push = [&](const char* src, uint32_t bytes) {
      const int st = g % S;
      hopper::mbar_wait(rg.empty(st), ((g / S) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(rg.full(st), bytes);
      hopper::bulk_copy(ring + st * L::STAGE, src, bytes, rg.full(st));
      ++g;
    };
    auto qkv_all = [&]() {
      for (int i = 0; i < a.nh * KC; ++i) push(base + i * L::QKV_TILE, L::QKV_TILE);
    };
    // fc1's K chunks [k0, k1) of hidden chunk j (read MN-major: dy2)
    auto fc1_k = [&](int j, int k0, int k1) {
      const char* ch = mlp0 + static_cast<size_t>(j) * L::CHUNK_BYTES;
      for (int kc = k0; kc < k1; ++kc) push(ch + kc * 8192, 8192);
    };
    for (int pr = blockIdx.x; pr < pairs; pr += gridDim.x) {
      if constexpr (MODE == MODE_WHOLE || MODE == MODE_FRONT) qkv_all();    // F1
      if constexpr (MODE == MODE_WHOLE || MODE == MODE_MID) {
        for (int i = 0; i < NH * KC; ++i) push(proj0 + i * L::STAGE, L::STAGE);  // F2
        for (int j = 0; j < a.chunks; ++j) {                                // M
          const char* ch = mlp0 + static_cast<size_t>(j) * L::CHUNK_BYTES;
          for (int kc = 0; kc < KC; ++kc) push(ch + kc * 8192, 8192);
          for (int hf = 0; hf < NH; ++hf) push(ch + KC * 8192 + hf * L::STAGE, L::STAGE);
          fc1_k(j, 0, KD);
        }
        if constexpr (SPLIT)                                                // M, dy2's 2nd half
          for (int j = 0; j < a.chunks; ++j) fc1_k(j, KD, KC);
        for (int kc = 0; kc < KC; ++kc)                                     // P
          for (int hf = 0; hf < NH; ++hf) push(proj0 + (hf * KC + kc) * L::STAGE, L::STAGE);
      }
      if constexpr (MODE == MODE_WHOLE) qkv_all();                          // A2
      if constexpr (MODE == MODE_OFWD) {  // F2, then per hidden chunk fc1 (h1) and fc2 (out)
        for (int i = 0; i < NH * KC; ++i) push(proj0 + i * L::STAGE, L::STAGE);
        for (int j = 0; j < a.chunks; ++j) {
          const char* ch = mlp0 + static_cast<size_t>(j) * L::CHUNK_BYTES;
          for (int kc = 0; kc < KC; ++kc) push(ch + kc * 8192, 8192);
          for (int hf = 0; hf < NH; ++hf) push(ch + KC * 8192 + hf * L::STAGE, L::STAGE);
        }
      }
      if constexpr (MODE == MODE_WHOLE || MODE == MODE_TAIL) {              // D
        if constexpr (SPLIT) {  // each half of dy: every head's K chunks of that half
          for (int k0 = 0; k0 < KC; k0 += KD)
            for (int hh = 0; hh < a.nh; ++hh)
              for (int kc = k0; kc < k0 + KD; ++kc)
                push(base + (hh * KC + kc) * L::QKV_TILE, L::QKV_TILE);
        } else {
          qkv_all();
        }
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
  const uint32_t qbuf = rbuf + L::R_BYTES, kbuf = qbuf + L::HT_BYTES, vbuf = kbuf + L::HT_BYTES;
  float* stat = reinterpret_cast<float*>(smem_raw + (vbuf + L::HT_BYTES - raw));  // [3][64]
  const bool even = (a.c & 1) == 0;
  const bool shifted = a.shifted != 0;
  const float inv_c = 1.f / static_cast<float>(a.c);
  const float neg_inf = -__int_as_float(0x7f800000);
  const int slot = blockIdx.x * NCONS + cw;
  float* pv = a.pvec + (static_cast<size_t>(slot) * 4 + wi) * a.vl;
  float* prpb = TILED ? nullptr : a.prpb + static_cast<size_t>(slot) * a.nh * 4096;
  // the LN sums' vector: g1 | b1 | g2 | b2, CP each (the bias sums are K5b's)
  enum { V_G1, V_B1, V_G2, V_B2 };
  auto pv_at = [&](int part) { return pv + part * CP; };
  auto a_off = [](uint32_t base, int row, int col) {  // bf16 (row, col) of swizzled chunks
    return base + (col >> 6) * 8192 + hopper::sw128_offset(row, (col & 63) * 2);
  };
  auto head_off = [](int row, int d) {  // byte offset of (row, d) in a head tile
    return hopper::swizzled_offset<RB>(row * RB + d * 2);
  };

  // this thread's entries of its partials start at zero (the OCAB
  // forward's tail writes none)
  if (MODE != MODE_OFWD && lane < 4)
    for (int col = 2 * lane; col < a.vl; col += 8)
      *reinterpret_cast<float2*>(pv + col) = make_float2(0.f, 0.f);
  if constexpr (!TILED)
    for (int hh = 0; hh < a.nh; ++hh)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          *reinterpret_cast<float2*>(prpb + hh * 4096 + (r0 + 8 * h2) * 64 + 8 * j + 2 * q) =
              make_float2(0.f, 0.f);

  // unit wv's token t: its window and the token's place in it
  auto token_off = [&](int wv, int t) {
    const int wn = TILED ? wv / TPW : wv, tt = TILED ? (wv % TPW) * 64 + t : t;
    const int bidx = wn / per_img, win = wn - bidx * per_img;
    const int wy = win / nww, wx = win - wy * nww;
    const int rr = (wy * WS + tt / WS + a.shift) % a.h;
    const int cc = (wx * WS + tt % WS + a.shift) % a.w;
    return ((static_cast<long long>(bidx) * a.h + rr) * a.w + cc) * a.c;
  };

  for (int pr = blockIdx.x; pr < pairs; pr += gridDim.x) {
    const int w0 = NCONS * pr + cw;
    const bool active = w0 < windows;  // an odd last window: the other one recomputes, stores nothing
    const int wv = active ? w0 : windows - 1;
    const int wn = TILED ? wv / TPW : wv, sub = TILED ? wv % TPW : 0;  // window, its tile
    const int bidx = wn / per_img, win = wn - bidx * per_img;
    // x1 turns into dx1 in place, so the inactive twin of the tiled modes
    // has a scratch slice of its own (the last, `windows`): on its active
    // partner's it could read dx1 as x1
    // (the OCAB forward's tail reads x1 back in the same pass: a slice a slot)
    float* x1ws =
        a.x1ws + static_cast<size_t>(TILED && MODE != MODE_OFWD ? (active ? wv : windows) : slot) *
                     64 * CP;
    const float m1 = a.scales ? a.scales[2 * bidx] : 1.f;
    const float m2 = a.scales ? a.scales[2 * bidx + 1] : 1.f;
    bool row_ok[2];
    long long roff[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int t = r0 + 8 * h2;
      row_ok[h2] = t < NT;
      roff[h2] = token_off(wv, row_ok[h2] ? t : 0);
    }
    const bf16* const xrow[2] = {a.x + roff[0], a.x + roff[1]};
    auto ws_at = [&](int o) { return a.op[o] + static_cast<size_t>(wv) * a.op_tiles[o] * TILE_ELEMS; };
    // (the inactive twin of an odd last window writes the same bits)
    auto ws_pair = [&](int o, int row, int col, uint32_t v) {
      *reinterpret_cast<uint32_t*>(ws_at(o) + ws_off(row, col)) = v;
    };
    // an operand whole in the A or R buffer (its chunks are the
    // workspace's tiles, byte for byte) leaves by bulk copies; the buffer
    // is rewritten only after bulk_wait_read and a barrier
    auto ws_bulk = [&](int o, uint32_t buf) {
      if (ct != 0) return;
      for (int kc = 0; kc < KC; ++kc)
        hopper::bulk_store(ws_at(o) + kc * TILE_ELEMS, buf + kc * 8192, 8192);
      hopper::bulk_commit();
    };
    // the columns a row of dx / dextra takes: none for a pad row or the
    // inactive twin
    int c_out[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) c_out[h2] = active && row_ok[h2] ? a.c : 0;
    // the tokens' codes: the thread's rows; the columns' read where used
    const int* codes = TILED ? nullptr : a.codes + (shifted ? win : 0) * NT;
    int rcode[2] = {0, 0};
    if constexpr (!TILED)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) rcode[h2] = __ldg(codes + (row_ok[h2] ? r0 + 8 * h2 : 0));
    // the score's term at row h2 and column slot e2 = 2 (e >> 2) + (e & 1)
    // (column 8 (e2 >> 1) + 2 q + (e2 & 1)): the table index, bit 16 where
    // the shift regions differ; `rows_are_keys` swaps the roles (the
    // key-row pass)
    auto term = [&](int h2, int e2, bool rows_are_keys) {
      const int col = 8 * (e2 >> 1) + 2 * q + (e2 & 1);
      const int rc = rcode[h2], kc = __ldg(codes + (col < NT ? col : 0));
      const int idx = rows_are_keys ? (kc & 0xffff) - (rc & 0xffff) + REL0
                                    : (rc & 0xffff) - (kc & 0xffff) + REL0;
      const bool differ = shifted && (static_cast<unsigned>(rc ^ kc) >> 16) != 0;
      return idx | (differ << 16);
    };

    // LN1 of the window's x -> the A buffer; the rows' statistics
    float mu1[2], rs1[2];
    auto ln1 = [&](bool store) {
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
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mu1[h2] = quad_sum(s[h2]) * inv_c;
        rs1[h2] = rsqrtf(fmaxf(quad_sum(sq[h2]) * inv_c - mu1[h2] * mu1[h2], 0.f) + a.eps);
      }
      if (!store) return;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 8 * j + 2 * q;
        const float2 g = load_vec2(a.g1, col, a.c), b = load_vec2(a.b1, col, a.c);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float2 f = unpack_bf16(xp[j][h2]);
          const float v0 = col < a.c ? (f.x - mu1[h2]) * rs1[h2] * g.x + b.x : 0.f;
          const float v1 = col + 1 < a.c ? (f.y - mu1[h2]) * rs1[h2] * g.y + b.y : 0.f;
          const uint32_t u = pack_bf16(v0, v1);
          st32(a_off(abuf, r0 + 8 * h2, col), u);
        }
      }
    };
    // a head's qkv (+ bias) from the A buffer: q as A fragments, k and v
    // (and q, where `q_tile`) into the head tiles
    auto head_qkv = [&](int hh, uint32_t (&qf)[HDP / 16][4], bool q_tile) {
      float acc[3 * HDP / 2];
#pragma unroll
      for (int e = 0; e < 3 * HDP / 2; ++e) acc[e] = 0.f;
      float2 bqv[3 * HDP / 8];
#pragma unroll
      for (int j = 0; j < 3 * HDP / 8; ++j)
        bqv[j] = __ldg(reinterpret_cast<const float2*>(a.bqkv + hh * Q3 + 8 * j + 2 * q));
      gemm_a_smem<3 * HDP, CP>(acc, abuf, rg, lane);
      wg_barrier(cw);  // the last head's products have read the head tiles
#pragma unroll
      for (int j = 0; j < 3 * HDP / 8; ++j) {
        const float2 bb = bqv[j];
        const uint32_t lo = pack_bf16(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
        const uint32_t hi = pack_bf16(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
        const int part = (8 * j) / HDP, d = (8 * j) % HDP + 2 * q;
        if (part == 0) {
          qf[j / 2][2 * (j & 1)] = lo;
          qf[j / 2][2 * (j & 1) + 1] = hi;
        }
        if (part > 0 || q_tile) {
          const uint32_t dst = part == 0 ? qbuf : part == 1 ? kbuf : vbuf;
          st32(dst + head_off(r0, d), lo);
          st32(dst + head_off(r0 + 8, d), hi);
        }
      }
      hopper::fence_proxy_async();
      wg_barrier(cw);
    };
    // S = Q K^T + the bias and mask, -inf past the keys, softmax: P in
    // fp32 (sc), its row max and 1 / sum
    auto softmax_rows = [&](int hh, const uint32_t (&qf)[HDP / 16][4], float (&sc)[32],
                            float (&mx)[2], float (&inv)[2]) {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        hopper::WgmmaRSK<64>::mma(sc, qf[kk], hopper::desc_swizzled<RB>(kbuf) + 2 * kk, 1);
      hopper::wgmma_commit();
      const float* tb = table + hh * T2;
      int bc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = 8 * (e >> 2) + 2 * q + (e & 1);
        bc[e] = col >= NT ? 1 << 17 : term((e >> 1) & 1, 2 * (e >> 2) + (e & 1), false);
      }
      float tv[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) tv[e] = tb[bc[e] & 0xffff];
      hopper::wgmma_wait<0>();
      hopper::fence_operands(sc);
      mx[0] = mx[1] = neg_inf;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int h2 = (e >> 1) & 1;
        const float v = sc[e] + tv[e];
        sc[e] = NT < 64 && (bc[e] & 0x20000) ? neg_inf : (bc[e] & 0x10000) ? v + -100.f : v;
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
        sc[e] = __expf(sc[e] - mx[h2]);
        l[h2] += sc[e];
      }
      inv[0] = __fdividef(1.f, quad_sum(l[0]));
      inv[1] = __fdividef(1.f, quad_sum(l[1]));
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] *= inv[(e >> 1) & 1];
    };

    wg_barrier(cw);  // the last pair's readers of every buffer are done

    if constexpr (MODE == MODE_WHOLE || MODE == MODE_FRONT) {
    // ================================ F1: LN1, the attention forward
    ln1(true);
    hopper::fence_proxy_async();
    wg_barrier(cw);
    ws_bulk(OP_YC, abuf);
    if constexpr (MODE == MODE_FRONT) {
      // the heads' q, k, v -> the window's [ws^2, HDP] head tiles
      // (the attention kernels' operands); O's columns past the heads zero
      for (int hh = 0; hh < a.nh; ++hh) {
        float acc[3 * HDP / 2];
#pragma unroll
        for (int e = 0; e < 3 * HDP / 2; ++e) acc[e] = 0.f;
        float2 bqv[3 * HDP / 8];
#pragma unroll
        for (int j = 0; j < 3 * HDP / 8; ++j)
          bqv[j] = __ldg(reinterpret_cast<const float2*>(a.bqkv + hh * Q3 + 8 * j + 2 * q));
        gemm_a_smem<3 * HDP, CP>(acc, abuf, rg, lane);
        char* hq = reinterpret_cast<char*>(
            a.qkvh + (static_cast<size_t>(wn) * a.nh + hh) * 3 * WTOK * HDP);
#pragma unroll
        for (int j = 0; j < 3 * HDP / 8; ++j) {
          const int part = (8 * j) / HDP, d = (8 * j) % HDP + 2 * q, row = 64 * sub + r0;
          char* t = hq + part * WTOK * RB;
          *reinterpret_cast<uint32_t*>(t + head_off(row, d)) =
              pack_bf16(acc[4 * j] + bqv[j].x, acc[4 * j + 1] + bqv[j].y);
          *reinterpret_cast<uint32_t*>(t + head_off(row + 8, d)) =
              pack_bf16(acc[4 * j + 2] + bqv[j].x, acc[4 * j + 3] + bqv[j].y);
        }
      }
      for (int col = a.nh * HDP + 2 * q; col < KC * 64; col += 8) {
        ws_pair(OP_O, r0, col, 0u);
        ws_pair(OP_O, r0 + 8, col, 0u);
      }
      if (ct == 0) hopper::bulk_wait_read();  // yc's copy: the next unit rewrites the A buffer
      continue;
    } else {
    for (int hh = 0; hh < a.nh; ++hh) {
      uint32_t qf[HDP / 16][4];
      head_qkv(hh, qf, false);
      float sc[32], mx[2], inv[2];
      softmax_rows(hh, qf, sc, mx, inv);
      uint32_t pf[4][4];
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        pf[kb][0] = pack_bf16(sc[8 * kb], sc[8 * kb + 1]);
        pf[kb][1] = pack_bf16(sc[8 * kb + 2], sc[8 * kb + 3]);
        pf[kb][2] = pack_bf16(sc[8 * kb + 4], sc[8 * kb + 5]);
        pf[kb][3] = pack_bf16(sc[8 * kb + 6], sc[8 * kb + 7]);
      }
      float o[HDP / 2];
#pragma unroll
      for (int e = 0; e < HDP / 2; ++e) o[e] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        hopper::WgmmaRS<HDP>::mma(o, pf[kb], hopper::desc_swizzled<RB>(vbuf + kb * 16 * RB), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(o);
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        const int col = hh * HDP + 8 * j + 2 * q;
        const uint32_t lo = pack_bf16(o[4 * j], o[4 * j + 1]);
        const uint32_t hi = pack_bf16(o[4 * j + 2], o[4 * j + 3]);
        st32(a_off(rbuf, r0, col), lo);
        st32(a_off(rbuf, r0 + 8, col), hi);
      }
    }
    for (int col = a.nh * HDP + 2 * q; col < CP; col += 8) {  // the proj reads CP columns
      st32(a_off(rbuf, r0, col), 0u);
      st32(a_off(rbuf, r0 + 8, col), 0u);
    }
    hopper::fence_proxy_async();
    wg_barrier(cw);
    ws_bulk(OP_O, rbuf);
    }
    } else if constexpr (MODE == MODE_MID || MODE == MODE_OFWD) {
      // O (the attention kernel's, in the workspace) -> the R buffer
      const uint4* src = reinterpret_cast<const uint4*>(ws_at(OP_O));
      uint4* dst = reinterpret_cast<uint4*>(smem_raw + (rbuf - raw));
      for (int i = ct; i < KC * 512; i += 128) dst[i] = src[i];
      hopper::fence_proxy_async();
      wg_barrier(cw);
    }

    if constexpr (MODE == MODE_WHOLE || MODE == MODE_MID || MODE == MODE_OFWD) {
    // ================================ F2: x1, LN2; dmlp
    float mu2[2], rs2[2];
    if constexpr (SPLIT) {
      // x1 a 128-column part at a time, straight to the scratch; LN2 from
      // the scratch once both parts' sums are in
      float s[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll 1
      for (int hf = 0; hf < NH; ++hf) {
        uint32_t xr[GP][2], er[GP][2];  // the part's x and extra, in flight during its product
#pragma unroll
        for (int j = 0; j < GP; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int col = PW * hf + 8 * j + 2 * q;
            xr[j][h2] = load_pair_u32(xrow[h2], row_ok[h2], col, a.c);
            er[j][h2] = a.extra ? load_pair_u32(a.extra + roff[h2], row_ok[h2], col, a.c) : 0u;
          }
        float pacc[PW / 2];
#pragma unroll
        for (int e = 0; e < PW / 2; ++e) pacc[e] = 0.f;
        gemm_a_smem<PW, CP>(pacc, rbuf, rg, lane);
#pragma unroll
        for (int j = 0; j < GP; ++j) {
          const int jg = GP * hf + j, col = 8 * jg + 2 * q;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bproj + col));
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float2 xv = unpack_bf16(xr[j][h2]);
            const float2 ev = unpack_bf16(er[j][h2]);
            const float v0 = xv.x + m1 * (pacc[4 * j + 2 * h2] + bb.x) + ev.x;
            const float v1 = xv.y + m1 * (pacc[4 * j + 2 * h2 + 1] + bb.y) + ev.y;
            s[h2] += v0 + v1;  // zero past C
            sq[h2] += v0 * v0 + v1 * v1;
            reinterpret_cast<float2*>(x1ws)[(2 * jg + h2) * 128 + ct] = make_float2(v0, v1);
          }
        }
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mu2[h2] = quad_sum(s[h2]) * inv_c;
        rs2[h2] = rsqrtf(fmaxf(quad_sum(sq[h2]) * inv_c - mu2[h2] * mu2[h2], 0.f) + a.eps);
      }
      wg_barrier(cw);  // every warp's proj has read O: the R buffer takes dmlp
#pragma unroll
      for (int j0 = 0; j0 < NJ; j0 += 8) {
        float2 x1v[8][2];  // every load before any store
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            x1v[j][h2] = reinterpret_cast<const float2*>(x1ws)[(2 * (j0 + j) + h2) * 128 + ct];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * (j0 + j) + 2 * q;
          const float2 g = load_vec2(a.g2, col, a.c), b = load_vec2(a.b2, col, a.c);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float2 v = x1v[j][h2];
            st32(a_off(abuf, r0 + 8 * h2, col),
                 pack_bf16(col < a.c ? (v.x - mu2[h2]) * rs2[h2] * g.x + b.x : 0.f,
                           col + 1 < a.c ? (v.y - mu2[h2]) * rs2[h2] * g.y + b.y : 0.f));
          }
        }
      }
    } else {
      float pacc[NH][48];
      float s[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < NH; ++hf) {
        // the half's x and extra, in flight during its proj product
        uint32_t xr[12][2], er[12][2];
#pragma unroll
        for (int j = 0; j < 12; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int col = 8 * (12 * hf + j) + 2 * q;
            xr[j][h2] = load_pair_u32(xrow[h2], row_ok[h2], col, a.c);
            er[j][h2] = a.extra ? load_pair_u32(a.extra + roff[h2], row_ok[h2], col, a.c) : 0u;
          }
#pragma unroll
        for (int e = 0; e < 48; ++e) pacc[hf][e] = 0.f;
        gemm_a_smem<96, CP>(pacc[hf], rbuf, rg, lane);
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          const int jg = 12 * hf + j, col = 8 * jg + 2 * q;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bproj + col));
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float2 xv = unpack_bf16(xr[j][h2]);
            const float2 ev = unpack_bf16(er[j][h2]);
            const float v0 = xv.x + m1 * (pacc[hf][4 * j + 2 * h2] + bb.x) + ev.x;
            const float v1 = xv.y + m1 * (pacc[hf][4 * j + 2 * h2 + 1] + bb.y) + ev.y;
            pacc[hf][4 * j + 2 * h2] = v0;
            pacc[hf][4 * j + 2 * h2 + 1] = v1;
            s[h2] += v0 + v1;  // zero past C
            sq[h2] += v0 * v0 + v1 * v1;
          }
        }
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mu2[h2] = quad_sum(s[h2]) * inv_c;
        rs2[h2] = rsqrtf(fmaxf(quad_sum(sq[h2]) * inv_c - mu2[h2] * mu2[h2], 0.f) + a.eps);
      }
      if (ct == 0) hopper::bulk_wait_read();  // yc's and O's copies
      wg_barrier(cw);  // every warp's proj has read O: the R buffer takes dmlp
#pragma unroll
      for (int hf = 0; hf < NH; ++hf)
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          const int jg = 12 * hf + j, col = 8 * jg + 2 * q;
          const float2 g = load_vec2(a.g2, col, a.c), b = load_vec2(a.b2, col, a.c);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float v0 = pacc[hf][4 * j + 2 * h2], v1 = pacc[hf][4 * j + 2 * h2 + 1];
            const uint32_t u = pack_bf16(col < a.c ? (v0 - mu2[h2]) * rs2[h2] * g.x + b.x : 0.f,
                                         col + 1 < a.c ? (v1 - mu2[h2]) * rs2[h2] * g.y + b.y : 0.f);
            st32(a_off(abuf, r0 + 8 * h2, col), u);
            reinterpret_cast<float2*>(x1ws)[(2 * jg + h2) * 128 + ct] = make_float2(v0, v1);
          }
        }
    }
    if constexpr (MODE == MODE_OFWD) {
      // ============================== the OCAB forward's MLP: out = x1 +
      // fc2(gelu(fc1(y2c))), fc2 summed over every chunk in fp32 before
      // its bias and the residual, one rounding at the store
      hopper::fence_proxy_async();
      wg_barrier(cw);  // y2c whole in the A buffer
      float oacc[NH][48];
#pragma unroll
      for (int hf = 0; hf < NH; ++hf) zero<48>(oacc[hf]);
      for (int jc = 0; jc < a.chunks; ++jc) {
        float hacc[32];
        zero<32>(hacc);
        gemm_a_smem<HC, CP>(hacc, abuf, rg, lane);
        uint32_t f[4][4];  // bf16(gelu(h1)) as the A fragments of fc2
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bfc1 + HC * jc + 8 * j + 2 * q));
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float u0 = hacc[4 * j + 2 * h2] + bb.x, u1 = hacc[4 * j + 2 * h2 + 1] + bb.y;
            const float g0 = a.gelu_tanh ? gelu_and_grad<true>(u0).x : gelu_and_grad<false>(u0).x;
            const float g1 = a.gelu_tanh ? gelu_and_grad<true>(u1).x : gelu_and_grad<false>(u1).x;
            f[j / 2][2 * (j & 1) + h2] = pack_bf16(g0, g1);
          }
        }
        rs_k96<NH>(oacc, f, rg, lane);
      }
#pragma unroll
      for (int hf = 0; hf < NH; ++hf)
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          const int jg = 12 * hf + j, col = 8 * jg + 2 * q;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bfc2 + col));
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float2 x1 = reinterpret_cast<const float2*>(x1ws)[(2 * jg + h2) * 128 + ct];
            store_pair(a.out + roff[h2], col, c_out[h2],
                       (x1.x + oacc[hf][4 * j + 2 * h2]) + bb.x,
                       (x1.y + oacc[hf][4 * j + 2 * h2 + 1]) + bb.y);
          }
        }
      continue;
    } else {
    {  // dmlp = bf16(ct m2) -> the R buffer, the workspace
#pragma unroll
      for (int j0 = 0; j0 < NJ; j0 += GP) {
        uint32_t cr[GP][2];  // every load first
#pragma unroll
        for (int jj = 0; jj < GP; ++jj)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            cr[jj][h2] = load_pair_u32(a.ct + roff[h2], row_ok[h2], 8 * (j0 + jj) + 2 * q, a.c);
#pragma unroll
        for (int jj = 0; jj < GP; ++jj) {
          const int col = 8 * (j0 + jj) + 2 * q;
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float2 c2 = unpack_bf16(cr[jj][h2]);
            const uint32_t u = pack_bf16(c2.x * m2, c2.y * m2);
            st32(a_off(rbuf, r0 + 8 * h2, col), u);
          }
        }
      }
    }
    hopper::fence_proxy_async();
    wg_barrier(cw);
    ws_bulk(OP_Y2C, abuf);
    ws_bulk(OP_DMLP, rbuf);

    // ================================ M: the MLP, forward and back
    // one hidden chunk: h1 (recompute), act and dh1 to the workspace, dh1
    // as `f`, the A fragments of dy2 += dh1 Wfc1
    auto mlp_chunk = [&](int jc, uint32_t (&f)[4][4]) {
      float hacc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) hacc[e] = 0.f;
      gemm_a_smem<HC, CP>(hacc, abuf, rg, lane);
      // act -> the workspace; gelu'(h1) in place of h1
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bfc1 + HC * jc + 8 * j + 2 * q));
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float2 g0, g1;
          if (a.gelu_tanh) {
            g0 = gelu_and_grad<true>(hacc[4 * j + 2 * h2] + bb.x);
            g1 = gelu_and_grad<true>(hacc[4 * j + 2 * h2 + 1] + bb.y);
          } else {
            g0 = gelu_and_grad<false>(hacc[4 * j + 2 * h2] + bb.x);
            g1 = gelu_and_grad<false>(hacc[4 * j + 2 * h2 + 1] + bb.y);
          }
          ws_pair(OP_ACT, r0 + 8 * h2, HC * jc + 8 * j + 2 * q, pack_bf16(g0.x, g1.x));
          hacc[4 * j + 2 * h2] = g0.y;
          hacc[4 * j + 2 * h2 + 1] = g1.y;
        }
      }
      float dacc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) dacc[e] = 0.f;
      gemm_mn<CP>(dacc, rbuf, rg, lane);
      // dh1 = bf16(dmlp Wfc2 * gelu'(h1)): A fragments, the workspace
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t lo = pack_bf16(dacc[4 * j] * hacc[4 * j], dacc[4 * j + 1] * hacc[4 * j + 1]);
        const uint32_t hi =
            pack_bf16(dacc[4 * j + 2] * hacc[4 * j + 2], dacc[4 * j + 3] * hacc[4 * j + 3]);
        f[j / 2][2 * (j & 1)] = lo;
        f[j / 2][2 * (j & 1) + 1] = hi;
        const int col = HC * jc + 8 * j + 2 * q;
        ws_pair(OP_DH1, r0, col, lo);
        ws_pair(OP_DH1, r0 + 8, col, hi);
      }
    };
    // LN2's backward is written twice: here for the block kernel's widths,
    // in the else branch for cp 256 (one shared version raised the cp-192
    // spills and K5's time).  A fix to one copy goes into the other, as
    // for LN1's backward in D.
    if constexpr (!SPLIT) {
    float dy2[KC][32];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int e = 0; e < 32; ++e) dy2[kc][e] = 0.f;
    for (int jc = 0; jc < a.chunks; ++jc) {
      uint32_t f[4][4];
      mlp_chunk(jc, f);
      rs_mn<4, KC>(dy2, f, rg, lane);
    }

    // ================================ L2: LN2 backward -> dx1, dextra, dattn
    {
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        float2 x1v[8][2];  // the tile's x1, every load before any store
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            x1v[j][h2] = 8 * kc + j < NJ
                             ? reinterpret_cast<const float2*>(x1ws)[(2 * (8 * kc + j) + h2) * 128 + ct]
                             : make_float2(0.f, 0.f);
        float gn[32];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int jg = 8 * kc + j, col = 8 * jg + 2 * q;
          const float2 g = load_vec2(a.g2, col, a.c);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float2 n = make_float2(0.f, 0.f);
            if (jg < NJ) {
              const float2 x1 = x1v[j][h2];
              n.x = col < a.c ? (x1.x - mu2[h2]) * rs2[h2] : 0.f;
              n.y = col + 1 < a.c ? (x1.y - mu2[h2]) * rs2[h2] : 0.f;
            }
            const float d0 = dy2[kc][4 * j + 2 * h2], d1 = dy2[kc][4 * j + 2 * h2 + 1];
            s1[h2] += d0 * g.x + d1 * g.y;
            s2[h2] += d0 * g.x * n.x + d1 * g.y * n.y;
            gn[4 * j + 2 * h2] = d0 * n.x;
            gn[4 * j + 2 * h2 + 1] = d1 * n.y;
          }
        }
        if (8 * kc < NJ) {
          colsum<8>(pv_at(V_G2) + 64 * kc, gn, lane, active, NJ - 8 * kc);
          colsum<8>(pv_at(V_B2) + 64 * kc, dy2[kc], lane, active, NJ - 8 * kc);
        }
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        s1[h2] = quad_sum(s1[h2]) * inv_c;
        s2[h2] = quad_sum(s2[h2]) * inv_c;
      }
      if (ct == 0) hopper::bulk_wait_read();  // y2c's and dmlp's copies
      wg_barrier(cw);  // every warp's fc1 has read y2c: the A buffer takes dattn
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (8 * kc >= NJ) continue;
        float2 x1v[8][2], ctv2[8][2];  // every load before any store
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int jg = 8 * kc + j;
            x1v[j][h2] = jg < NJ ? reinterpret_cast<const float2*>(x1ws)[(2 * jg + h2) * 128 + ct]
                                 : make_float2(0.f, 0.f);
            ctv2[j][h2] = load_pair(a.ct + roff[h2], row_ok[h2], 8 * jg + 2 * q, a.c);
          }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int jg = 8 * kc + j, col = 8 * jg + 2 * q;
          if (jg >= NJ) break;
          const float2 g = load_vec2(a.g2, col, a.c);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float2* x1p = reinterpret_cast<float2*>(x1ws) + (2 * jg + h2) * 128 + ct;
            const float2 x1 = x1v[j][h2];
            const float2 ctv = ctv2[j][h2];
            const float n0 = col < a.c ? (x1.x - mu2[h2]) * rs2[h2] : 0.f;
            const float n1 = col + 1 < a.c ? (x1.y - mu2[h2]) * rs2[h2] : 0.f;
            const float d0 = dy2[kc][4 * j + 2 * h2], d1 = dy2[kc][4 * j + 2 * h2 + 1];
            float v0 = ctv.x + rs2[h2] * (d0 * g.x - s1[h2] - n0 * s2[h2]);
            float v1 = ctv.y + rs2[h2] * (d1 * g.y - s1[h2] - n1 * s2[h2]);
            if (col >= a.c) v0 = 0.f;
            if (col + 1 >= a.c) v1 = 0.f;
            *x1p = make_float2(v0, v1);  // dx1 over x1
            if (a.dextra) store_pair(a.dextra + roff[h2], col, c_out[h2], v0, v1);
            const uint32_t u = pack_bf16(v0 * m1, v1 * m1);
            st32(a_off(abuf, r0 + 8 * h2, col), u);
          }
        }
      }
    }
    } else {
    // K5r: dy2 in two halves of K chunks, the first on the
    // chunks' pass, parked in fp32 in the R buffer (dmlp's, free once
    // every product has read it), the second against dh1 read back from
    // the workspace (this thread's own stores)
    float dy2[KD][32];
#pragma unroll
    for (int k = 0; k < KD; ++k)
#pragma unroll
      for (int e = 0; e < 32; ++e) dy2[k][e] = 0.f;
    for (int jc = 0; jc < a.chunks; ++jc) {
      uint32_t f[4][4];
      mlp_chunk(jc, f);
      rs_mn<4, KD>(dy2, f, rg, lane);
    }

    // ================================ L2: LN2 backward -> dx1, dextra, dattn
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
    // dy2's 64-column chunk kc (d): the LN2 sums (s1, s2, the g2 / b2
    // column sums)
    auto l2_sums = [&](int kc, const float (&d)[32]) {
      float2 x1v[8][2];  // the tile's x1, every load before any store
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          x1v[j][h2] = 8 * kc + j < NJ
                           ? reinterpret_cast<const float2*>(x1ws)[(2 * (8 * kc + j) + h2) * 128 + ct]
                           : make_float2(0.f, 0.f);
      float gn[32];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int jg = 8 * kc + j, col = 8 * jg + 2 * q;
        const float2 g = load_vec2(a.g2, col, a.c);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float2 n = make_float2(0.f, 0.f);
          if (jg < NJ) {
            const float2 x1 = x1v[j][h2];
            n.x = col < a.c ? (x1.x - mu2[h2]) * rs2[h2] : 0.f;
            n.y = col + 1 < a.c ? (x1.y - mu2[h2]) * rs2[h2] : 0.f;
          }
          const float d0 = d[4 * j + 2 * h2], d1 = d[4 * j + 2 * h2 + 1];
          s1[h2] += d0 * g.x + d1 * g.y;
          s2[h2] += d0 * g.x * n.x + d1 * g.y * n.y;
          gn[4 * j + 2 * h2] = d0 * n.x;
          gn[4 * j + 2 * h2 + 1] = d1 * n.y;
        }
      }
      if (8 * kc < NJ) {
        colsum<8>(pv_at(V_G2) + 64 * kc, gn, lane, active, NJ - 8 * kc);
        colsum<8>(pv_at(V_B2) + 64 * kc, d, lane, active, NJ - 8 * kc);
      }
    };
    // chunk kc's dx1 over x1 in the scratch, dextra, dattn -> the A buffer
    auto l2_out = [&](int kc, const float (&d)[32]) {
      if (8 * kc >= NJ) return;
      float2 x1v[8][2], ctv2[8][2];  // every load before any store
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int jg = 8 * kc + j;
          x1v[j][h2] = jg < NJ ? reinterpret_cast<const float2*>(x1ws)[(2 * jg + h2) * 128 + ct]
                               : make_float2(0.f, 0.f);
          ctv2[j][h2] = load_pair(a.ct + roff[h2], row_ok[h2], 8 * jg + 2 * q, a.c);
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int jg = 8 * kc + j, col = 8 * jg + 2 * q;
        if (jg >= NJ) break;
        const float2 g = load_vec2(a.g2, col, a.c);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float2* x1p = reinterpret_cast<float2*>(x1ws) + (2 * jg + h2) * 128 + ct;
          const float2 x1 = x1v[j][h2];
          const float2 ctv = ctv2[j][h2];
          const float n0 = col < a.c ? (x1.x - mu2[h2]) * rs2[h2] : 0.f;
          const float n1 = col + 1 < a.c ? (x1.y - mu2[h2]) * rs2[h2] : 0.f;
          const float d0 = d[4 * j + 2 * h2], d1 = d[4 * j + 2 * h2 + 1];
          float v0 = ctv.x + rs2[h2] * (d0 * g.x - s1[h2] - n0 * s2[h2]);
          float v1 = ctv.y + rs2[h2] * (d1 * g.y - s1[h2] - n1 * s2[h2]);
          if (col >= a.c) v0 = 0.f;
          if (col + 1 >= a.c) v1 = 0.f;
          *x1p = make_float2(v0, v1);  // dx1 over x1
          if (a.dextra) store_pair(a.dextra + roff[h2], col, c_out[h2], v0, v1);
          const uint32_t u = pack_bf16(v0 * m1, v1 * m1);
          st32(a_off(abuf, r0 + 8 * h2, col), u);
        }
      }
    };
#pragma unroll
    for (int k = 0; k < KD; ++k) l2_sums(k, dy2[k]);
    if (ct == 0) hopper::bulk_wait_read();  // y2c's and dmlp's copies
    wg_barrier(cw);  // every warp's fc1 has read y2c: the A buffer takes dattn
    {
      float* park = reinterpret_cast<float*>(smem_raw + (rbuf - raw));  // [KD][32][128] fp32
#pragma unroll
      for (int k = 0; k < KD; ++k)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          park[(32 * k + e) * 128 + ct] = dy2[k][e];
          dy2[k][e] = 0.f;
        }
      const bf16* dh1 = ws_at(OP_DH1);
      for (int jc = 0; jc < a.chunks; ++jc) {
        uint32_t f[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = HC * jc + 8 * j + 2 * q;
          f[j / 2][2 * (j & 1)] = *reinterpret_cast<const uint32_t*>(dh1 + ws_off(r0, col));
          f[j / 2][2 * (j & 1) + 1] = *reinterpret_cast<const uint32_t*>(dh1 + ws_off(r0 + 8, col));
        }
        rs_mn<4, KD>(dy2, f, rg, lane);
      }
#pragma unroll
      for (int k = 0; k < KD; ++k) l2_sums(KD + k, dy2[k]);
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      s1[h2] = quad_sum(s1[h2]) * inv_c;
      s2[h2] = quad_sum(s2[h2]) * inv_c;
    }
#pragma unroll
    for (int k = 0; k < KD; ++k) l2_out(KD + k, dy2[k]);
    {
      const float* park = reinterpret_cast<const float*>(smem_raw + (rbuf - raw));
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        float d[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) d[e] = park[(32 * k + e) * 128 + ct];
        l2_out(k, d);
      }
    }
    }
    hopper::fence_proxy_async();
    wg_barrier(cw);
    ws_bulk(OP_DATTN, abuf);

    // ================================ P: do = dattn Wproj -> the head tiles
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      float dacc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) dacc[e] = 0.f;
      gemm_mn<CP>(dacc, abuf, rg, lane);
      if constexpr (MODE == MODE_MID) {
        // do -> the window's head tiles, and each head's row term
        // rowsum(do o) (the bf16 do and the workspace's o)
        constexpr int HPC = 64 / HDP;  // heads a 64-column chunk
        float ds[HPC][2];
#pragma unroll
        for (int hc = 0; hc < HPC; ++hc) ds[hc][0] = ds[hc][1] = 0.f;
        const bf16* ob = ws_at(OP_O);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * kc + 8 * j + 2 * q;
          const int hh = col / HDP, d = col % HDP;
          const uint32_t lo = pack_bf16(dacc[4 * j], dacc[4 * j + 1]);
          const uint32_t hi = pack_bf16(dacc[4 * j + 2], dacc[4 * j + 3]);
          if (hh < a.nh) {
            char* t = reinterpret_cast<char*>(
                a.doh + (static_cast<size_t>(wn) * a.nh + hh) * HROWS * HDP);
            *reinterpret_cast<uint32_t*>(t + head_off(64 * sub + r0, d)) = lo;
            *reinterpret_cast<uint32_t*>(t + head_off(64 * sub + r0 + 8, d)) = hi;
            const float2 o0 = unpack_bf16(*reinterpret_cast<const uint32_t*>(ob + ws_off(r0, col)));
            const float2 o1 =
                unpack_bf16(*reinterpret_cast<const uint32_t*>(ob + ws_off(r0 + 8, col)));
            const float2 d0 = unpack_bf16(lo), d1 = unpack_bf16(hi);
            ds[j / (HDP / 8)][0] += d0.x * o0.x + d0.y * o0.y;
            ds[j / (HDP / 8)][1] += d1.x * o1.x + d1.y * o1.y;
          }
        }
#pragma unroll
        for (int hc = 0; hc < HPC; ++hc)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float v = quad_sum(ds[hc][h2]);
            const int hh = 64 * kc / HDP + hc;
            if (q == 0 && hh < a.nh)
              a.drow[(static_cast<size_t>(wn) * a.nh + hh) * HROWS + 64 * sub + r0 + 8 * h2] = v;
          }
      } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * kc + 8 * j + 2 * q;
        const int hh = col / HDP, d = col % HDP;
        if (hh < a.nh) {
          const uint32_t t = rbuf + hh * L::HT_BYTES;
          st32(t + head_off(r0, d), pack_bf16(dacc[4 * j], dacc[4 * j + 1]));
          st32(t + head_off(r0 + 8, d), pack_bf16(dacc[4 * j + 2], dacc[4 * j + 3]));
        }
      }
      }
    }
    if (ct == 0) hopper::bulk_wait_read();  // dattn's copy
    wg_barrier(cw);  // every warp's do product has read dattn: the A buffer takes yc
    if constexpr (MODE == MODE_MID) continue;
    }
    }

    if constexpr (MODE == MODE_TAIL) ln1(false);  // LN1's statistics for its backward
    if constexpr (MODE == MODE_WHOLE) {
    // ================================ A2: the attention backward, a head at a time
    ln1(true);
    hopper::fence_proxy_async();
    wg_barrier(cw);
    for (int hh = 0; hh < a.nh; ++hh) {
      uint32_t qf[HDP / 16][4];
      head_qkv(hh, qf, true);
      const uint32_t dob = rbuf + hh * L::HT_BYTES;
      const float* tb = table + hh * T2;
      float* pr_h = prpb + hh * 4096;
      // ---- the query rows: P, dA = do V^T, dS, dQ = dS K
      {
        float sc[32], mx[2], inv[2];
        softmax_rows(hh, qf, sc, mx, inv);
        uint32_t dof[HDP / 16][4];
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) tile_frag<RB>(dof[kk], dob, r0, q, kk);
        float da[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) da[e] = 0.f;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk)
          hopper::WgmmaRSK<64>::mma(da, dof[kk], hopper::desc_swizzled<RB>(vbuf) + 2 * kk, 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(da);
        float dsum[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 32; ++e) dsum[(e >> 1) & 1] += da[e] * sc[e];
        dsum[0] = quad_sum(dsum[0]);
        dsum[1] = quad_sum(dsum[1]);
        uint32_t dsf[4][4];
#pragma unroll
        for (int e = 0; e < 32; ++e) da[e] = sc[e] * (da[e] - dsum[(e >> 1) & 1]);  // dS
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
          dsf[kb][0] = pack_bf16(da[8 * kb], da[8 * kb + 1]);
          dsf[kb][1] = pack_bf16(da[8 * kb + 2], da[8 * kb + 3]);
          dsf[kb][2] = pack_bf16(da[8 * kb + 4], da[8 * kb + 5]);
          dsf[kb][3] = pack_bf16(da[8 * kb + 6], da[8 * kb + 7]);
        }
        float dq[HDP / 2];
#pragma unroll
        for (int e = 0; e < HDP / 2; ++e) dq[e] = 0.f;
        hopper::wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < 4; ++kb)
          hopper::WgmmaRS<HDP>::mma(dq, dsf[kb], hopper::desc_swizzled<RB>(kbuf + kb * 16 * RB),
                                    1);
        hopper::wgmma_commit();
        if (active) {  // d(rpb) += dS, while dQ runs; every load before any store
          float2 t[8][2];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2)
              t[j][h2] = *reinterpret_cast<const float2*>(pr_h + (r0 + 8 * h2) * 64 + 8 * j + 2 * q);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2)
              *reinterpret_cast<float2*>(pr_h + (r0 + 8 * h2) * 64 + 8 * j + 2 * q) =
                  make_float2(t[j][h2].x + da[4 * j + 2 * h2], t[j][h2].y + da[4 * j + 2 * h2 + 1]);
        }
        if (q == 0) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            stat[r0 + 8 * h2] = mx[h2];
            stat[64 + r0 + 8 * h2] = inv[h2];
            stat[128 + r0 + 8 * h2] = dsum[h2];
          }
        }
        hopper::wgmma_wait<0>();
        hopper::fence_operands(dq);
#pragma unroll
        for (int j = 0; j < HDP / 8; ++j) {
          const int col = hh * Q3 + 8 * j + 2 * q;
          const uint32_t lo = pack_bf16(dq[4 * j], dq[4 * j + 1]);
          const uint32_t hi = pack_bf16(dq[4 * j + 2], dq[4 * j + 3]);
          ws_pair(OP_DQKV, r0, col, lo);
          ws_pair(OP_DQKV, r0 + 8, col, hi);
        }
      }
      wg_barrier(cw);  // the query rows' statistics are in shared memory
      // ---- the key rows: P^T, dP^T = V do^T, dS^T, dK = dS^T Q, dV = P^T do
      {
        uint32_t kf[HDP / 16][4], vf[HDP / 16][4];
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          tile_frag<RB>(kf[kk], kbuf, r0, q, kk);
          tile_frag<RB>(vf[kk], vbuf, r0, q, kk);
        }
        float st[32], dp[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) st[e] = dp[e] = 0.f;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk)
          hopper::WgmmaRSK<64>::mma(st, kf[kk], hopper::desc_swizzled<RB>(qbuf) + 2 * kk, 1);
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk)
          hopper::WgmmaRSK<64>::mma(dp, vf[kk], hopper::desc_swizzled<RB>(dob) + 2 * kk, 1);
        hopper::wgmma_commit();
        int bc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int h2 = (e >> 1) & 1, col = 8 * (e >> 2) + 2 * q + (e & 1);
          bc[e] = col >= NT || r0 + 8 * h2 >= NT ? 1 << 17
                                                  : term(h2, 2 * (e >> 2) + (e & 1), true);
        }
        float tv[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) tv[e] = tb[bc[e] & 0xffff];
        hopper::wgmma_wait<0>();
        hopper::fence_operands(st);
        hopper::fence_operands(dp);
        uint32_t pf[4][4], sf[4][4];
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = 8 * (e >> 2) + 2 * q + (e & 1);  // the query
          const float v = st[e] + tv[e];
          const float s = (bc[e] & 0x10000) ? v + -100.f : v;
          const float p = (bc[e] & 0x20000) ? 0.f : __expf(s - stat[col]) * stat[64 + col];
          st[e] = p;
          dp[e] = p * (dp[e] - stat[128 + col]);
        }
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pf[kb][i] = pack_bf16(st[8 * kb + 2 * i], st[8 * kb + 2 * i + 1]);
            sf[kb][i] = pack_bf16(dp[8 * kb + 2 * i], dp[8 * kb + 2 * i + 1]);
          }
        }
        float dk[HDP / 2], dv[HDP / 2];
#pragma unroll
        for (int e = 0; e < HDP / 2; ++e) dk[e] = dv[e] = 0.f;
        hopper::wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < 4; ++kb)
          hopper::WgmmaRS<HDP>::mma(dk, sf[kb], hopper::desc_swizzled<RB>(qbuf + kb * 16 * RB), 1);
#pragma unroll
        for (int kb = 0; kb < 4; ++kb)
          hopper::WgmmaRS<HDP>::mma(dv, pf[kb], hopper::desc_swizzled<RB>(dob + kb * 16 * RB), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(dk);
        hopper::fence_operands(dv);
        auto store_part = [&](int part, const float (&dd)[HDP / 2]) {
#pragma unroll
          for (int j = 0; j < HDP / 8; ++j) {
            const int col = hh * Q3 + part * HDP + 8 * j + 2 * q;
            ws_pair(OP_DQKV, r0, col, pack_bf16(dd[4 * j], dd[4 * j + 1]));
            ws_pair(OP_DQKV, r0 + 8, col, pack_bf16(dd[4 * j + 2], dd[4 * j + 3]));
          }
        };
        store_part(1, dk);
        store_part(2, dv);
      }
    }
    }

    // ================================ D: dy = dqkv Wqkv, LN1 backward, dx
    if constexpr ((MODE == MODE_WHOLE || MODE == MODE_TAIL) && SPLIT) {
      // K5r: dy in two halves of K chunks, each over every head;
      // the first parked in fp32 in the A buffer (free in this mode).
      // LN1's backward here and in the branch below are two copies of one
      // computation (see LN2's in M): a fix to one goes into the other.
      float dy[KD][32];
      auto dqkv_dy = [&]() {  // dy = sum over the heads of dqkv_h Wqkv_h, a pass's K chunks
#pragma unroll
        for (int k = 0; k < KD; ++k)
#pragma unroll
          for (int e = 0; e < 32; ++e) dy[k][e] = 0.f;
        for (int hh = 0; hh < a.nh; ++hh) {
          // the head's dqkv as A fragments: this thread's own workspace writes
          uint32_t f[Q3 / 16][4];
          const bf16* src = ws_at(OP_DQKV);
#pragma unroll
          for (int kk = 0; kk < Q3 / 16; ++kk) {
            const int c0 = hh * Q3 + 16 * kk + 2 * q;
            f[kk][0] = *reinterpret_cast<const uint32_t*>(src + ws_off(r0, c0));
            f[kk][1] = *reinterpret_cast<const uint32_t*>(src + ws_off(r0 + 8, c0));
            f[kk][2] = *reinterpret_cast<const uint32_t*>(src + ws_off(r0, c0 + 8));
            f[kk][3] = *reinterpret_cast<const uint32_t*>(src + ws_off(r0 + 8, c0 + 8));
          }
          rs_mn<Q3 / 16, KD>(dy, f, rg, lane);
        }
      };
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
      auto d_sums = [&](int kc, const float (&d)[32]) {  // chunk kc's LN1 sums
        if (8 * kc >= NJ) return;
        uint32_t xr[8][2];  // every load first
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            xr[j][h2] = load_pair_u32(xrow[h2], row_ok[h2], 64 * kc + 8 * j + 2 * q, a.c);
        float gn[32];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * kc + 8 * j + 2 * q;
          const float2 g = load_vec2(a.g1, col, a.c);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float2 xv = unpack_bf16(xr[j][h2]);
            const float n0 = col < a.c ? (xv.x - mu1[h2]) * rs1[h2] : 0.f;
            const float n1 = col + 1 < a.c ? (xv.y - mu1[h2]) * rs1[h2] : 0.f;
            const float d0 = d[4 * j + 2 * h2], d1 = d[4 * j + 2 * h2 + 1];
            s1[h2] += d0 * g.x + d1 * g.y;
            s2[h2] += d0 * g.x * n0 + d1 * g.y * n1;
            gn[4 * j + 2 * h2] = d0 * n0;
            gn[4 * j + 2 * h2 + 1] = d1 * n1;
          }
        }
        colsum<8>(pv_at(V_G1) + 64 * kc, gn, lane, active, NJ - 8 * kc);
        colsum<8>(pv_at(V_B1) + 64 * kc, d, lane, active, NJ - 8 * kc);
      };
      auto d_out = [&](int kc, const float (&d)[32]) {  // chunk kc's dx = dx1 + LN1^T(dy)
        if (8 * kc >= NJ) return;
        float2 xv2[8][2], dx1v[8][2];  // every load before any store
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int jg = 8 * kc + j;
            xv2[j][h2] = load_pair(xrow[h2], row_ok[h2], 8 * jg + 2 * q, a.c);
            dx1v[j][h2] = jg < NJ ? reinterpret_cast<const float2*>(x1ws)[(2 * jg + h2) * 128 + ct]
                                  : make_float2(0.f, 0.f);
          }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int jg = 8 * kc + j, col = 8 * jg + 2 * q;
          if (jg >= NJ) break;
          const float2 g = load_vec2(a.g1, col, a.c);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float2 xv = xv2[j][h2];
            const float2 dx1 = dx1v[j][h2];
            const float n0 = (xv.x - mu1[h2]) * rs1[h2], n1 = (xv.y - mu1[h2]) * rs1[h2];
            const float d0 = d[4 * j + 2 * h2], d1 = d[4 * j + 2 * h2 + 1];
            const float v0 = dx1.x + rs1[h2] * (d0 * g.x - s1[h2] - n0 * s2[h2]);
            const float v1 = dx1.y + rs1[h2] * (d1 * g.y - s1[h2] - n1 * s2[h2]);
            store_pair(a.dx + roff[h2], col, c_out[h2], v0, v1);
          }
        }
      };
      dqkv_dy();
#pragma unroll
      for (int k = 0; k < KD; ++k) d_sums(k, dy[k]);
      {
        float* park = reinterpret_cast<float*>(smem_raw + (abuf - raw));  // [KD][32][128] fp32
#pragma unroll
        for (int k = 0; k < KD; ++k)
#pragma unroll
          for (int e = 0; e < 32; ++e) park[(32 * k + e) * 128 + ct] = dy[k][e];
        dqkv_dy();
#pragma unroll
        for (int k = 0; k < KD; ++k) d_sums(KD + k, dy[k]);
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        s1[h2] = quad_sum(s1[h2]) * inv_c;
        s2[h2] = quad_sum(s2[h2]) * inv_c;
      }
#pragma unroll
      for (int k = 0; k < KD; ++k) d_out(KD + k, dy[k]);
      {
        const float* park = reinterpret_cast<const float*>(smem_raw + (abuf - raw));
#pragma unroll
        for (int k = 0; k < KD; ++k) {
          float d[32];
#pragma unroll
          for (int e = 0; e < 32; ++e) d[e] = park[(32 * k + e) * 128 + ct];
          d_out(k, d);
        }
      }
    } else if constexpr (MODE == MODE_WHOLE || MODE == MODE_TAIL) {
      float dy[KC][32];
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
#pragma unroll
        for (int e = 0; e < 32; ++e) dy[kc][e] = 0.f;
      for (int hh = 0; hh < a.nh; ++hh) {
        // the head's dqkv as A fragments: this thread's own workspace writes
        uint32_t f[Q3 / 16][4];
        const bf16* src = ws_at(OP_DQKV);
#pragma unroll
        for (int kk = 0; kk < Q3 / 16; ++kk) {
          const int c0 = hh * Q3 + 16 * kk + 2 * q;
          f[kk][0] = *reinterpret_cast<const uint32_t*>(src + ws_off(r0, c0));
          f[kk][1] = *reinterpret_cast<const uint32_t*>(src + ws_off(r0 + 8, c0));
          f[kk][2] = *reinterpret_cast<const uint32_t*>(src + ws_off(r0, c0 + 8));
          f[kk][3] = *reinterpret_cast<const uint32_t*>(src + ws_off(r0 + 8, c0 + 8));
        }
        rs_mn<Q3 / 16, KC>(dy, f, rg, lane);
      }
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (8 * kc >= NJ) continue;
        uint32_t xr[8][2];  // every load first
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            xr[j][h2] = load_pair_u32(xrow[h2], row_ok[h2], 64 * kc + 8 * j + 2 * q, a.c);
        float gn[32];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * kc + 8 * j + 2 * q;
          const float2 g = load_vec2(a.g1, col, a.c);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float2 xv = unpack_bf16(xr[j][h2]);
            const float n0 = col < a.c ? (xv.x - mu1[h2]) * rs1[h2] : 0.f;
            const float n1 = col + 1 < a.c ? (xv.y - mu1[h2]) * rs1[h2] : 0.f;
            const float d0 = dy[kc][4 * j + 2 * h2], d1 = dy[kc][4 * j + 2 * h2 + 1];
            s1[h2] += d0 * g.x + d1 * g.y;
            s2[h2] += d0 * g.x * n0 + d1 * g.y * n1;
            gn[4 * j + 2 * h2] = d0 * n0;
            gn[4 * j + 2 * h2 + 1] = d1 * n1;
          }
        }
        colsum<8>(pv_at(V_G1) + 64 * kc, gn, lane, active, NJ - 8 * kc);
        colsum<8>(pv_at(V_B1) + 64 * kc, dy[kc], lane, active, NJ - 8 * kc);
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        s1[h2] = quad_sum(s1[h2]) * inv_c;
        s2[h2] = quad_sum(s2[h2]) * inv_c;
      }
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (8 * kc >= NJ) continue;
        float2 xv2[8][2], dx1v[8][2];  // every load before any store
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int jg = 8 * kc + j;
            xv2[j][h2] = load_pair(xrow[h2], row_ok[h2], 8 * jg + 2 * q, a.c);
            dx1v[j][h2] = jg < NJ ? reinterpret_cast<const float2*>(x1ws)[(2 * jg + h2) * 128 + ct]
                                  : make_float2(0.f, 0.f);
          }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int jg = 8 * kc + j, col = 8 * jg + 2 * q;
          if (jg >= NJ) break;
          const float2 g = load_vec2(a.g1, col, a.c);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float2 xv = xv2[j][h2];
            const float2 dx1 = dx1v[j][h2];
            const float n0 = (xv.x - mu1[h2]) * rs1[h2], n1 = (xv.y - mu1[h2]) * rs1[h2];
            const float d0 = dy[kc][4 * j + 2 * h2], d1 = dy[kc][4 * j + 2 * h2 + 1];
            const float v0 = dx1.x + rs1[h2] * (d0 * g.x - s1[h2] - n0 * s2[h2]);
            const float v1 = dx1.y + rs1[h2] * (d1 * g.y - s1[h2] - n1 * s2[h2]);
            store_pair(a.dx + roff[h2], col, c_out[h2], v0, v1);
          }
        }
      }
    }
  }
  if (ct == 0) hopper::bulk_wait();  // the workspace copies have landed
}

template <int WS, int CP, int HDP, int MODE = MODE_WHOLE>
int launch_window(const Args& a, int grid, cudaStream_t stream) {
  using L = Layout<CP, HDP>;
  const int smem = L::FIXED + a.stages * L::STAGE;
  if (a.stages < 2 || a.stages > MAX_STAGES || smem > SMEM_LIMIT || a.nh * HDP > CP)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = swin_block_bwd_kernel<WS, CP, HDP, MODE>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swin_bwd
