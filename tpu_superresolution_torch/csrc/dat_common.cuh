// The kernels that DAT's two block fronts share: K9, the spatial front
// (csrc/dat_rect.cu), and K14, the channel front (csrc/dat_channel.cu).
// Each source instantiates its own mode.
//
// front_product_kernel<MODE>: LN1 and the qkv product of every pixel.
//       A persistent grid (one 384-thread CTA an SM) walks 128-row tiles
//       (tile (image, j): rows j*128 .. of the image's Hp x Wp map, read
//       row-major; a row past H x W is a pad token, whose x row is zero).
//       Warps 0-2 produce: the tile's x rows by cp.async into the
//       128B-swizzled A buffer (three 64-column chunks, C <= 192, zeros
//       past C and at pad rows), then LN1 in place, four rows a warp at
//       once (fp32 fast-variance statistics, eps as given); two A
//       buffers, so the next tile's LN overlaps this tile's product.
//       Warp 3 streams the packed weight ([6 N tiles][3 chunks][96][64],
//       128B-swizzled, one bulk copy a stage) through a ring of six
//       stages.  Warpgroups 1 and 2 each run wgmma m64 x 96 x k16 on 64
//       rows, fp32 accumulators, N tiles in pairs into two accumulator
//       sets, and, per N tile of three 32-column heads, the mode's
//       epilogue: + bias, one rounding to bf16 into a staging tile, then
//       16-byte stores.
//       MODE_RECT (K9): N tile (part, branch) goes to the branch's
//         head-split q|k|v workspace [3][BW][nhb][N][32], each (part,
//         window, head) run swizzled as csrc/window_attn_stream.cu's bulk
//         copies read it, at the token's (window, token) in the branch's
//         rolled, padded window order; pad tokens get zeros.  The v tiles
//         also go to v [B, H, W, C] at true coordinates.
//       MODE_CHAN (K14): N tiles q(heads 0-2), k(0-2), q(3-5), k(3-5),
//         v(0-2), v(3-5).  After each k tile both warpgroups meet and
//         eight warps compute the tile's block-diagonal gram q_h^T k_h
//         (mma.sync m16n8k16 from ldmatrix.trans'd staging, a head's 32 x
//         32 block as two 16-row blocks; wgmma's m64 is twice hd) and the
//         squared norms (a column a thread, rows in order), written as the
//         tile's partial sums: [B][tiles an image][6][32][32] and [..][2]
//         [192].  v goes to v [B, H, W, C].
// dat_conv_kernel<APPLY, V>: the conv branch, erf-GELU(dwconv3x3(v) + b)
//       (BatchNorm folded, SAME zero padding), on 8 x 16-pixel tiles: the
//       tile's v with its one-pixel halo by cp.async (V bf16 a copy) into
//       shared memory, each thread a (column, V channels) down the tile's
//       rows with the 3 x 3 window in registers.  APPLY (K14): also out =
//       v A^T for each head, A the image's bf16 [6][32][32] in shared
//       memory, one warp a tile row (16 pixels, one mma.sync m16 tile).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {
namespace datf {

constexpr int MODE_RECT = 0;
constexpr int MODE_CHAN = 1;

constexpr int BM = 128;          // rows a tile: two consumer warpgroups of 64
constexpr int MAX_CHUNKS = 3;    // 64-column chunks of C <= 192
constexpr int BN = 96;           // columns an N tile: three heads of 32
constexpr int N_TILES = 6;       // 576 = q, k, v of six 32-column head slots
constexpr int HDP = 32;
constexpr int kThreads = 384;
constexpr int kLnThreads = 96;   // producer warps 0-2
constexpr int LN_ROWS = 4;       // rows a producer warp normalises at once
constexpr int A_CHUNK = BM * 128;
constexpr int A_BYTES = MAX_CHUNKS * A_CHUNK;
constexpr int W_STAGE = BN * 128;
constexpr int STAGES = 6;
constexpr int LDE = BN + 8;      // staging row, bf16 (208 bytes: ldmatrix rows conflict-free)
constexpr int E_BYTES = BM * LDE * 2;
constexpr int ROW_INTS = 5;      // a tile row: (window, token) of each branch, pixel or -1
constexpr int OFF_W = 2 * A_BYTES;
constexpr int OFF_E = OFF_W + STAGES * W_STAGE;
constexpr int OFF_ROWS = OFF_E + 2 * E_BYTES;
constexpr int OFF_BAR = OFF_ROWS + BM * ROW_INTS * 4;
constexpr int N_BARS = 2 * STAGES + 4;  // w full / empty, A full / empty x 2
constexpr int SMEM = 1024 + OFF_BAR + 8 * N_BARS;
static_assert(SMEM <= 232448, "over the 227 KB shared-memory limit");
static_assert(OFF_W % 1024 == 0 && OFF_E % 16 == 0 && OFF_BAR % 8 == 0, "alignment");

struct FrontArgs {
  const bf16* x;       // [B, H, W, C]
  const float* g1;
  const float* b1;
  const bf16* wstream; // [6][3][96][64], 128B-swizzled
  const float* bias;   // [576]
  bf16* v;             // [B, H, W, C]
  bf16* ws0;           // K9: branch workspaces [3][bw][nh][ntok][32]
  bf16* ws1;
  float* part_gram;    // K14: [B][tpi][6][32][32]
  float* part_sq;      // K14: [B][tpi][2][192]
  int h, w, c, hp, wp, tpi, tiles, vec;
  int nh;              // K9: heads a branch; K14: heads
  int hd, ntok;
  int hsp[2], wsp[2], sh[2], sw[2];
  long long bw;        // K9: windows of a branch
  float eps;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.f + erff(u * 0.7071067811865476f));
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, fp32 out (row.col).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Producer warps 0-2 (thread t of 96): the tile's x rows into the A
// buffer at shared address `abuf` (row r, column col at chunk col / 64,
// sw128_offset(r, 2 (col % 64))), V bf16 a cp.async, zero past C and at
// pad rows; then LN1 in place.  Warp-per-row: a row's pieces are lanes.
template <int V>
__device__ __forceinline__ void produce_tile(const FrontArgs& a, uint32_t abuf, uint8_t* base,
                                             int img, int pos0, int t) {
  const int wi = t >> 5, lane = t & 31;
  constexpr int ppr = MAX_CHUNKS * 64 / V;  // pieces a row, to the padded width
  const int hw = a.hp * a.wp;
  for (int r = wi; r < BM; r += 3) {
    const int pos = pos0 + r;
    const int y = pos / a.wp, xq = pos - y * a.wp;
    const bool real = pos < hw && y < a.h && xq < a.w;
    const bf16* row = a.x + ((static_cast<long long>(img) * a.h + y) * a.w + xq) * a.c;
    for (int p = lane; p < ppr; p += 32) {
      const int col = p * V;
      const bool ok = real && col < a.c;
      hopper::cp_async<2 * V>(abuf + (col >> 6) * A_CHUNK + hopper::sw128_offset(r, (col & 63) * 2),
                              ok ? static_cast<const void*>(row + col) : a.x, ok ? 2 * V : 0);
    }
  }
  hopper::cp_async_wait_all();
  named_barrier(1, kLnThreads);
  // LN1 in place, LN_ROWS rows a warp at once: their reductions'
  // shuffles interleave (one row at a time waits on ten dependent
  // shuffles); the lane's gains and biases in registers
  const float inv_c = 1.f / static_cast<float>(a.c);
  float gv[MAX_CHUNKS][2], bv[MAX_CHUNKS][2];
#pragma unroll
  for (int j = 0; j < MAX_CHUNKS; ++j) {
    const int col = 64 * j + 2 * lane;
    const bool in = col < a.c;  // C even: both columns in
    gv[j][0] = in ? __ldg(a.g1 + col) : 0.f;
    gv[j][1] = in ? __ldg(a.g1 + col + 1) : 0.f;
    bv[j][0] = in ? __ldg(a.b1 + col) : 0.f;
    bv[j][1] = in ? __ldg(a.b1 + col + 1) : 0.f;
  }
  for (int rb = wi; rb < BM; rb += 3 * LN_ROWS) {
    float v[LN_ROWS][MAX_CHUNKS][2], s[LN_ROWS], sq[LN_ROWS];
    bool ok[LN_ROWS];
#pragma unroll
    for (int i = 0; i < LN_ROWS; ++i) {
      const int r = rb + 3 * i;
      const int pos = pos0 + r;
      const int y = pos / a.wp, xq = pos - y * a.wp;
      ok[i] = r < BM && pos < hw && y < a.h && xq < a.w;  // else: zeros stay zeros
      s[i] = sq[i] = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_CHUNKS; ++j) {
        v[i][j][0] = v[i][j][1] = 0.f;
        if (ok[i]) {
          const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(
              base + j * A_CHUNK + hopper::sw128_offset(r, 4 * lane));
          v[i][j][0] = __low2float(p);
          v[i][j][1] = __high2float(p);
        }
        s[i] += v[i][j][0] + v[i][j][1];  // zero past C
        sq[i] += v[i][j][0] * v[i][j][0] + v[i][j][1] * v[i][j][1];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < LN_ROWS; ++i) {
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
        sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], o);
      }
#pragma unroll
    for (int i = 0; i < LN_ROWS; ++i) {
      if (!ok[i]) continue;
      const int r = rb + 3 * i;
      const float mu = s[i] * inv_c;
      const float rstd = rsqrtf(fmaxf(sq[i] * inv_c - mu * mu, 0.f) + a.eps);
#pragma unroll
      for (int j = 0; j < MAX_CHUNKS; ++j) {
        if (64 * j + 2 * lane < a.c) {
          const float y0 = (v[i][j][0] - mu) * rstd * gv[j][0] + bv[j][0];
          const float y1 = (v[i][j][1] - mu) * rstd * gv[j][1] + bv[j][1];
          *reinterpret_cast<uint32_t*>(base + j * A_CHUNK + hopper::sw128_offset(r, 4 * lane)) =
              pack_bf16(y0, y1);
        }
      }
    }
  }
}

// A tile row's (window, token) in each branch's rolled, padded window
// order and its pixel (-1: a pad token; window -1: past the map).
__device__ __forceinline__ void row_info(const FrontArgs& a, int img, int pos, int* out) {
  const int hw = a.hp * a.wp;
  const int y = pos / a.wp, xq = pos - y * a.wp;
  out[4] = (pos < hw && y < a.h && xq < a.w) ? (img * a.h + y) * a.w + xq : -1;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if (pos >= hw) {
      out[2 * b] = out[2 * b + 1] = -1;
      continue;
    }
    int pr = y - a.sh[b], pc = xq - a.sw[b];
    pr += pr < 0 ? a.hp : 0;
    pc += pc < 0 ? a.wp : 0;
    const int wy = pr / a.hsp[b], wx = pc / a.wsp[b];
    out[2 * b] = (img * (a.hp / a.hsp[b]) + wy) * (a.wp / a.wsp[b]) + wx;
    out[2 * b + 1] = (pr - wy * a.hsp[b]) * a.wsp[b] + (pc - wx * a.wsp[b]);
  }
}

// v [.., C] at the rows' pixels: `cnt` heads of hd from the staging
// columns (head h's dim d at h * 32 + d), to columns col0 + h * hd + d.
__device__ __forceinline__ void store_v(const FrontArgs& a, const bf16* e, const int* rows,
                                        int r0, int ct, int col0, int cnt) {
  const int seg = cnt * a.hd;
  if ((a.hd & 1) == 0) {  // pairs: C, hd, col0 even
    const int np = seg >> 1;
    for (int i = ct; i < 64 * np; i += 128) {
      const int r = i / np, k = 2 * (i - r * np);
      const int p = rows[(r0 + r) * ROW_INTS + 4];
      if (p < 0) continue;
      const int hh = k / a.hd, dd = k - hh * a.hd;
      *reinterpret_cast<uint32_t*>(a.v + static_cast<long long>(p) * a.c + col0 + k) =
          *reinterpret_cast<const uint32_t*>(e + (r0 + r) * LDE + hh * HDP + dd);
    }
  } else {
    for (int i = ct; i < 64 * seg; i += 128) {
      const int r = i / seg, k = i - r * seg;
      const int p = rows[(r0 + r) * ROW_INTS + 4];
      if (p < 0) continue;
      const int hh = k / a.hd, dd = k - hh * a.hd;
      a.v[static_cast<long long>(p) * a.c + col0 + k] = e[(r0 + r) * LDE + hh * HDP + dd];
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1) front_product_kernel(const FrontArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (sbase - raw);
  const uint32_t ring = sbase + OFF_W;
  const uint32_t bars = sbase + OFF_BAR;
  bf16* e0 = reinterpret_cast<bf16*>(gbase + OFF_E);
  bf16* e1 = e0 + BM * LDE;
  int* rows = reinterpret_cast<int*>(gbase + OFF_ROWS);
  auto wfull = [&](int s) { return bars + 8u * s; };
  auto wempty = [&](int s) { return bars + 8u * (STAGES + s); };
  auto afull = [&](int b) { return bars + 8u * (2 * STAGES + b); };
  auto aempty = [&](int b) { return bars + 8u * (2 * STAGES + 2 + b); };

  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(wfull(s), 1);
      hopper::mbar_init(wempty(s), 8);  // lane 0 of each consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      hopper::mbar_init(afull(b), kLnThreads);
      hopper::mbar_init(aempty(b), 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 0) {
    if (tid < kLnThreads) {
      int it = 0;
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++it) {
        const int buf = it & 1;
        hopper::mbar_wait(aempty(buf), ((it >> 1) & 1) ^ 1);
        const int img = tile / a.tpi;
        const int pos0 = (tile - img * a.tpi) * BM;
        const uint32_t abuf = sbase + buf * A_BYTES;
        if (a.vec == 4)
          produce_tile<4>(a, abuf, gbase + buf * A_BYTES, img, pos0, tid);
        else
          produce_tile<2>(a, abuf, gbase + buf * A_BYTES, img, pos0, tid);
        hopper::mbar_arrive(afull(buf));  // (shared stores: ordered by the arrive)
      }
    } else if (tid == kLnThreads) {
      int g = 0;
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x)
        for (int st = 0; st < N_TILES * MAX_CHUNKS; ++st, ++g) {
          const int s = g % STAGES;
          hopper::mbar_wait(wempty(s), ((g / STAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(wfull(s), W_STAGE);
          hopper::bulk_copy(ring + s * W_STAGE,
                            a.wstream + static_cast<long long>(st) * BN * 64, W_STAGE,
                            wfull(s));
        }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  const int cw = wg - 1, ct = tid - 128 * wg, wi = ct >> 5, q4 = lane & 3;
  const int r0 = cw * 64;  // this warpgroup's rows of the tile
  float acc0[BN / 2], acc1[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0.f;
  int g = 0, it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++it) {
    const int buf = it & 1;
    const int img = tile / a.tpi, j = tile - img * a.tpi;
    const uint32_t abuf = sbase + buf * A_BYTES;
    named_barrier(2 + cw, 128);  // the last tile's copy-outs have read `rows`
    if (ct < 64) row_info(a, img, j * BM + r0 + ct, rows + (r0 + ct) * ROW_INTS);
    hopper::mbar_wait(afull(buf), (it >> 1) & 1);
    hopper::fence_proxy_async();
    // N tile nt's product into d, one commit group: its three stages g0 +
    // 3 nt .. of the ring (scale-d 0 on the first k-step: no zeroing)
    const int g0 = g;
    g += N_TILES * MAX_CHUNKS;
    auto issue = [&](float (&d)[BN / 2], int nt) {
#pragma unroll
      for (int ch = 0; ch < MAX_CHUNKS; ++ch) {
        const int gg = g0 + nt * MAX_CHUNKS + ch, s = gg % STAGES;
        hopper::mbar_wait(wfull(s), (gg / STAGES) & 1);
        const uint64_t da = hopper::desc_sw128(abuf + ch * A_CHUNK + r0 * 128);
        const uint64_t db = hopper::desc_sw128(ring + s * W_STAGE);
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          hopper::Wgmma<BN>::mma(d, da + 2 * k, db + 2 * k, (ch | k) ? 1 : 0);
      }
      hopper::wgmma_commit();
    };
    auto release = [&](int nt) {
      if (lane == 0)
        for (int ch = 0; ch < MAX_CHUNKS; ++ch)
          hopper::mbar_arrive(wempty((g0 + nt * MAX_CHUNKS + ch) % STAGES));
    };
    // the epilogue of N tile nt (d complete): + bias, one rounding, into
    // the staging tile, then the mode's copy-out
    auto epilogue = [&](const float (&d)[BN / 2], int nt) {
      const bool chan_k = MODE == MODE_CHAN && (nt == 1 || nt == 3);
      bf16* e = chan_k ? e1 : e0;
      named_barrier(2 + cw, 128);  // the last copy-out has read these rows
      const int rl = r0 + wi * 16 + (lane >> 2);
      const bool zero0 = MODE == MODE_CHAN && rows[rl * ROW_INTS + 4] < 0;
      const bool zero1 = MODE == MODE_CHAN && rows[(rl + 8) * ROW_INTS + 4] < 0;
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const int col = 8 * jj + 2 * q4;
        const float b0 = __ldg(a.bias + nt * BN + col), b1 = __ldg(a.bias + nt * BN + col + 1);
        *reinterpret_cast<uint32_t*>(e + rl * LDE + col) =
            zero0 ? 0u : pack_bf16(d[4 * jj] + b0, d[4 * jj + 1] + b1);
        *reinterpret_cast<uint32_t*>(e + (rl + 8) * LDE + col) =
            zero1 ? 0u : pack_bf16(d[4 * jj + 2] + b0, d[4 * jj + 3] + b1);
      }
      if constexpr (MODE == MODE_RECT) {
        named_barrier(2 + cw, 128);
        const int part = nt >> 1, br = nt & 1;
        bf16* wsb = br ? a.ws1 : a.ws0;
        const long long run = static_cast<long long>(a.ntok) * HDP;
        const long long part_off = static_cast<long long>(part) * a.bw * a.nh * run;
        const int per_row = a.nh * 4;  // 16-byte pieces: 8 dims of a head
        for (int i = ct; i < 64 * per_row; i += 128) {
          const int r = i / per_row, rem = i - r * per_row;
          const int hh = rem >> 2, vv = rem & 3;
          const int* ri = rows + (r0 + r) * ROW_INTS;
          const int win = ri[2 * br], tok = ri[2 * br + 1];
          if (win < 0) continue;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (ri[4] >= 0) val = *reinterpret_cast<const uint4*>(e + (r0 + r) * LDE + hh * HDP + 8 * vv);
          uint32_t off = static_cast<uint32_t>(tok) * 64u + 16u * vv;
          off ^= ((off >> 7) & 3u) << 4;
          *reinterpret_cast<uint4*>(wsb + part_off + (static_cast<long long>(win) * a.nh + hh) * run +
                                    off / 2) = val;
        }
        if (part == 2) store_v(a, e, rows, r0, ct, br * a.nh * a.hd, a.nh);
      } else {
        if (nt >= 4) {
          named_barrier(2 + cw, 128);
          const int grp = nt - 4;
          store_v(a, e, rows, r0, ct, 3 * grp * a.hd, min(3, a.nh - 3 * grp));
        } else if (chan_k) {
          // ---- the tile's gram and squared norms of heads 3 grp .. 3 grp + 2
          named_barrier(4, 256);  // both warpgroups' q and k rows are staged
          const int grp = nt >> 1;
          const int gw = cw * 4 + wi;
          const long long tp = static_cast<long long>(img) * a.tpi + j;
          if (gw < 6) {
            const int hh = gw >> 1, mt = gw & 1;
            float acc[4][4];
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
            const uint32_t qs = hopper::smem_addr(e0), ks = hopper::smem_addr(e1);
#pragma unroll 2
            for (int kt = 0; kt < BM / 16; ++kt) {
              uint32_t af[4];
              ldmatrix_x4_trans(af, qs + 2u * ((kt * 16 + (lane >> 4) * 8 + (lane & 7)) * LDE +
                                               hh * HDP + mt * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
              for (int nb = 0; nb < 2; ++nb) {
                uint32_t bfr[4];
                ldmatrix_x4_trans(bfr, ks + 2u * ((kt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                                      LDE +
                                                  hh * HDP + nb * 16 + (lane >> 4) * 8));
                mma16816(acc[2 * nb], af, bfr[0], bfr[1]);
                mma16816(acc[2 * nb + 1], af, bfr[2], bfr[3]);
              }
            }
            float* gout = a.part_gram + (tp * 6 + 3 * grp + hh) * (HDP * HDP);
            const int dr = mt * 16 + (lane >> 2);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const int ec = n * 8 + 2 * q4;
              *reinterpret_cast<float2*>(gout + dr * HDP + ec) = make_float2(acc[n][0], acc[n][1]);
              *reinterpret_cast<float2*>(gout + (dr + 8) * HDP + ec) =
                  make_float2(acc[n][2], acc[n][3]);
            }
            // squared norms: column gw * 32 + lane of [q | k] (96 + 96), rows in order
            const int col = gw * 32 + lane;
            const bf16* src = (col < BN ? e0 : e1) + (col % BN);
            float s = 0.f;
#pragma unroll 8
            for (int r = 0; r < BM; ++r) {
              const float v = __bfloat162float(src[r * LDE]);
              s += v * v;
            }
            a.part_sq[tp * 384 + (col < BN ? 0 : 192) + grp * BN + col % BN] = s;
          }
          named_barrier(4, 256);  // the staging tiles are read
        }
      }
    };
    // N tiles in pairs, each named statically: N tile nt + 1's product
    // runs while nt's epilogue does; the ring's six stages hold both
    // tiles' chunks
    issue(acc0, 0);
#pragma unroll 1
    for (int nt = 0; nt < N_TILES; nt += 2) {
      issue(acc1, nt + 1);
      hopper::wgmma_wait<1>();
      hopper::fence_operands(acc0);
      release(nt);
      epilogue(acc0, nt);
      if (nt + 2 < N_TILES) {
        issue(acc0, nt + 2);
        hopper::wgmma_wait<1>();
      } else {
        hopper::wgmma_wait<0>();
        if (lane == 0) hopper::mbar_arrive(aempty(buf));
      }
      hopper::fence_operands(acc1);
      release(nt + 1);
      epilogue(acc1, nt + 1);
    }
  }
}

template <int MODE>
int launch_front(const FrontArgs& a, int grid, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      front_product_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (a.tiles == 0) return 0;
  front_product_kernel<MODE><<<grid, kThreads, SMEM, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ the conv

constexpr int CTR = 8;    // output rows a tile (one warp each in the apply)
constexpr int CTW = 16;   // output columns a tile (one mma m16 tile)
constexpr int CPIX = (CTR + 2) * (CTW + 2);
constexpr int CTHREADS = 256;
constexpr int LDA = HDP + 8;  // A rows in shared memory (bf16; conflict-free b loads)

struct ConvArgs {
  const bf16* v;
  const float* wdw;   // [9][C]
  const float* bdw;   // [C]
  bf16* conv;
  const float* attn;  // APPLY: [B][6][32][32], bf16 values
  bf16* out;
  int h, w, c, nh, hd, tiles_x, tiles_y;
};

template <int V>
struct VecT;
template <>
struct VecT<4> { typedef uint2 type; };
template <>
struct VecT<2> { typedef uint32_t type; };

__device__ __forceinline__ uint32_t smem_pair(const bf16* p, int e, int hd) {
  const uint16_t lo = e < hd ? *reinterpret_cast<const uint16_t*>(p + e) : 0;
  const uint16_t hi = e + 1 < hd ? *reinterpret_cast<const uint16_t*>(p + e + 1) : 0;
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

template <bool APPLY, int V>
__global__ void __launch_bounds__(CTHREADS) dat_conv_kernel(const ConvArgs a) {
  typedef typename VecT<V>::type Vec;
  extern __shared__ __align__(16) uint8_t csmem[];
  bf16* vt = reinterpret_cast<bf16*>(csmem);                   // [CPIX][C]
  bf16* as = vt + ((CPIX * a.c + 7) & ~7);                      // [6][32][LDA]
  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const int tx = blk % a.tiles_x;
  blk /= a.tiles_x;
  const int ty = blk % a.tiles_y, img = blk / a.tiles_y;
  const int y0 = ty * CTR, x0 = tx * CTW;
  const int nv = a.c / V;
  const bf16* vimg = a.v + static_cast<long long>(img) * a.h * a.w * a.c;
  const uint32_t vts = hopper::smem_addr(vt);
  for (int i = tid; i < CPIX * nv; i += CTHREADS) {
    const int pix = i / nv, k = i - pix * nv;
    const int yy = y0 - 1 + pix / (CTW + 2), xx = x0 - 1 + pix % (CTW + 2);
    const bool ok = yy >= 0 && yy < a.h && xx >= 0 && xx < a.w;
    const bf16* src = ok ? vimg + (static_cast<long long>(yy) * a.w + xx) * a.c + k * V : a.v;
    hopper::cp_async<2 * V>(vts + 2u * (pix * a.c + k * V), src, ok ? 2 * V : 0);
  }
  if constexpr (APPLY) {
    const float* aimg = a.attn + static_cast<long long>(img) * 6 * HDP * HDP;
    for (int i = tid; i < 6 * HDP * HDP; i += CTHREADS)
      as[(i / HDP) * LDA + i % HDP] = __float2bfloat16(aimg[i]);  // exact: bf16 values
  }
  hopper::cp_async_wait_all();
  __syncthreads();

  // ---- conv_x: a thread a (column, V channels), down the tile's rows
  for (int item = tid; item < CTW * nv; item += CTHREADS) {
    const int qo = item / nv, ch = (item - qo * nv) * V;
    const int xq = x0 + qo;
    if (xq >= a.w) continue;
    float kr[9][V], br[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
#pragma unroll
      for (int t = 0; t < 9; ++t) kr[t][k] = __ldg(a.wdw + t * a.c + ch + k);
      br[k] = __ldg(a.bdw + ch + k);
    }
    float win[3][3][V];
    auto load_row = [&](float (&dst)[3][V], int srow) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const Vec raw = *reinterpret_cast<const Vec*>(vt + (srow * (CTW + 2) + qo + dx) * a.c + ch);
        const bf16* el = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int k = 0; k < V; ++k) dst[dx][k] = __bfloat162float(el[k]);
      }
    };
    load_row(win[0], 0);
    load_row(win[1], 1);
#pragma unroll
    for (int ro = 0; ro < CTR; ++ro) {
      if (y0 + ro >= a.h) break;
      load_row(win[2], ro + 2);
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] += win[dy][dx][k] * kr[3 * dy + dx][k];
      __align__(8) bf16 o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = __float2bfloat16(gelu_erf(acc[k] + br[k]));
      *reinterpret_cast<Vec*>(a.conv + ((static_cast<long long>(img) * a.h + y0 + ro) * a.w + xq) *
                                           a.c + ch) = *reinterpret_cast<const Vec*>(o);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int k = 0; k < V; ++k) {
          win[0][dx][k] = win[1][dx][k];
          win[1][dx][k] = win[2][dx][k];
        }
    }
  }

  if constexpr (APPLY) {
    // ---- attened_x = v A^T per head: warp wi's tile row, 16 pixels
    const int wi = tid >> 5, lane = tid & 31, gq = lane >> 2, q4 = lane & 3;
    const int yy = y0 + wi;
    if (yy < a.h) {
      const bf16* p0 = vt + ((wi + 1) * (CTW + 2) + gq + 1) * a.c;  // token gq
      const bf16* p1 = p0 + 8 * a.c;                                  // token gq + 8
      for (int hh = 0; hh < a.nh; ++hh) {
        float acc[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
        const bf16* ah = as + hh * HDP * LDA;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int e = ks * 16 + 2 * q4;
          uint32_t af[4];
          af[0] = smem_pair(p0 + hh * a.hd, e, a.hd);
          af[1] = smem_pair(p1 + hh * a.hd, e, a.hd);
          af[2] = smem_pair(p0 + hh * a.hd, e + 8, a.hd);
          af[3] = smem_pair(p1 + hh * a.hd, e + 8, a.hd);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const bf16* brow = ah + (n * 8 + gq) * LDA + e;  // B(k = e, n = d) = A[d][e]
            mma16816(acc[n], af, *reinterpret_cast<const uint32_t*>(brow),
                     *reinterpret_cast<const uint32_t*>(brow + 8));
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int dcol = n * 8 + 2 * q4;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int xq = x0 + gq + 8 * half;
            if (xq >= a.w) continue;
            bf16* dst = a.out + ((static_cast<long long>(img) * a.h + yy) * a.w + xq) * a.c +
                        hh * a.hd + dcol;
            const float o0 = acc[n][2 * half], o1 = acc[n][2 * half + 1];
            if ((a.hd & 1) == 0) {
              if (dcol < a.hd) *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o0, o1);
            } else {
              if (dcol < a.hd) dst[0] = __float2bfloat16(o0);
              if (dcol + 1 < a.hd) dst[1] = __float2bfloat16(o1);
            }
          }
        }
      }
    }
  }
}

inline size_t conv_smem(int c, bool apply) {
  return ((static_cast<size_t>(CPIX) * c + 7) & ~static_cast<size_t>(7)) * 2 +
         (apply ? 6 * HDP * LDA * 2 : 0);
}

template <bool APPLY>
int launch_conv(const ConvArgs& a, int batch, cudaStream_t s) {
  const size_t smem = conv_smem(a.c, APPLY);
  const long long blocks = static_cast<long long>(batch) * a.tiles_x * a.tiles_y;
  if (blocks == 0) return 0;
  cudaError_t err;
  if (a.c % 4 == 0) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        dat_conv_kernel<APPLY, 4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(conv_smem(192, APPLY)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    dat_conv_kernel<APPLY, 4><<<static_cast<unsigned>(blocks), CTHREADS, smem, s>>>(a);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        dat_conv_kernel<APPLY, 2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(conv_smem(192, APPLY)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    dat_conv_kernel<APPLY, 2><<<static_cast<unsigned>(blocks), CTHREADS, smem, s>>>(a);
  }
  err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace datf
}  // namespace
