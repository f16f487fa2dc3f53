// K10 — the tail of a DAT block: AIM gating -> proj -> residual -> LN2
// -> SGFN -> residual, for both block types, on Hopper's wgmma.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_datb_tail.py
//           fused_datb_tail -> _kernel (pallas_call at :374).
// Math (dat_arch.py:420-437, :510-527, :38-90, :559-562), per pixel, with
//       u the channel-gated tensor that also feeds the spatial map and
//       w_px the pixel-gated one (spatial block: u = attened_x, w_px =
//       conv_x; channel block: u = conv_x, w_px = attened_x):
//         m  = sigmoid(w2 . bf16(erf-GELU(W1 u + b1)) + b2)  (BN folded in W1)
//         sg = bf16(u * gate + w_px * m)            gate [B, C], sigmoid applied
//         x2 = x + sg Wproj + bproj                 (fp32)
//         h  = erf-GELU(bf16(LN2(x2)) Wfc1 + bfc1)  (fp32); h1, h2 = halves
//         h2 = bf16(LN_sg(h2));  d = dwconv3x3(h2) + bdw (SAME zero pad)
//         out = x2 + bf16(h1 * d) Wfc2 + bfc2
//       LayerNorms: fp32 fast-variance statistics, eps 1e-5; GEMMs bf16
//       operands with fp32 accumulation.  C <= 192, SGFN half <= 384.
// Bound on the H100: ~0.26 MFLOP a pixel at DATConfig()'s C 180 / half
//       180 (0.45 at the published x4's half 360) against 8 C bytes (x,
//       u, w_px read, out written): 0.0440 ms by bytes at [25,64,64,180],
//       0.0477 by operations at half 360 (chip_smoke.py's K10 rows).
// Design:
//     - Persistent CTAs walk units (image, strip, band): a band of BR
//       image rows of a strip of <= 64 pixels (a whole row where W <= 64;
//       else 62 output columns plus one halo column each side), so an
//       image row is one wgmma m64 tile.  The chain up to LN_sg runs once
//       a pixel of the band and its two halo rows (rows outside the image
//       are the conv's zero padding), not on a 2-D halo of every tile.
//     - Two consumer warpgroups share each row: every product's N is
//       split, warpgroup w taking rows 32 w .. 32 w + 31 of each [64, 64]
//       weight tile (wgmma m64n32), so each thread owns the columns 64 n +
//       32 w + 8 j + 2 q (+1) of its two rows and the elementwise work
//       (GELUs, LayerNorms, the depthwise conv, epilogues) is spread over
//       eight warps, two a scheduler; the LayerNorms' row sums meet in
//       shared memory.  A feeder warpgroup (one thread; setmaxnreg gives
//       its registers to the consumers, 232 each, where 9 warps would
//       leave 168 and spill at CP 192) streams the weights
//       (kernels/fused_datb_tail.py ``pack_tail_weights``: [N, 64] K-major
//       128B-swizzled tiles in the consumers' order, <= 8 KB each) through
//       an mbarrier ring, one bulk copy a tile that both warpgroups read.
//     - Row t's chain: u -> the A buffer; the spatial map (N 16, each
//       warpgroup all of it), sg in place, the proj with x added in its
//       registers, x2 to a per-CTA fp32 workspace in each thread's
//       register order, LN2 -> the A buffer; fc1's h2 half in 64-column
//       chunks twice: once for LN_sg's statistics, once normalised into
//       the ring of three bf16 h2 rows (XOR-swizzled 4-byte words: the
//       depthwise conv's reads are conflict-free).  Recomputing the h2
//       chunks costs C x half MACs a pixel and keeps the fp32 h2 out of
//       shared memory, which the ring of h2 rows fills at half 384.
//     - Row t-1's output, once row t's h2 is in the ring: per 64-column
//       chunk of h1, fc1 (A: row t-1's LN2 output, kept in the second A
//       buffer), GELU, the depthwise conv from the ring at the thread's
//       own accumulator positions (every load issued before its sums, the
//       tile's edge rows by a select, not a branch), the gate product
//       bf16 into a [64, 64] A chunk, fc2 accumulated over the chunks;
//       then x2 + fc2 + bfc2 stored.
//     - Shared memory at CP 192 / half 384: the ring of h2 rows 144 KB,
//       two A buffers 48 KB, the gate-product chunk 8 KB, 2 weight stages
//       of 8 KB (tail_plan; 8 stages at half <= 192).
//     - No atomics: the output is the same bit for bit on every run.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NCONS = 256;                 // two consumer warpgroups
constexpr int NTHREADS = NCONS + 128;      // + the weight feeder's warpgroup
// setmaxnreg: an SM sub-partition holds one warp of each warpgroup, 16K
// registers: 32 x (2 x 232 + 40) <= 16384
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int STAGE_BYTES = 8192;          // a ring stage: one [<= 64, 64] bf16 tile
constexpr int SP_TILE = 16 * 128;          // a spatial-map tile [16, 64]
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_HP = 384;
constexpr int ROWS = 64;                   // pixels a tile (the wgmma m64)

// offsets (floats) of the fp32 vectors in the `vec` block, CP / HP the
// padded width and half (kernels/fused_datb_tail.py ``vec_offsets``)
struct VecOff {
  int spb1, spw2, spb2, bproj, g2, b2, bfc1, gsg, bsg, wdw, bdw, bfc2;
};

__device__ __forceinline__ VecOff vec_offsets(int cp, int hp) {
  VecOff o;
  o.spb1 = 0;
  o.spw2 = 16;
  o.spb2 = 32;
  o.bproj = 36;
  o.g2 = o.bproj + cp;
  o.b2 = o.g2 + cp;
  o.bfc1 = o.b2 + cp;  // h1 at 0, h2 at hp
  o.gsg = o.bfc1 + 2 * hp;
  o.bsg = o.gsg + hp;
  o.wdw = o.bsg + hp;  // [9][hp]
  o.bdw = o.wdw + 9 * hp;
  o.bfc2 = o.bdw + hp;
  return o;
}

struct Args {
  const bf16* x;
  const bf16* u;
  const bf16* wpx;
  const float* gate;   // [B, C]
  bf16* out;
  const bf16* tiles;   // the weight stream (pack_tail_weights)
  const float* vec;    // biases, norms, w2 and the depthwise taps, padded
  float* x2ws;         // [grid, 2, 64 * CP] fp32
  int batch, h, w, c, half, hp, halo, seg, strips, band, nbands, units, stages;
  float eps;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.f + erff(u * 0.7071067811865476f));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void cons_barrier() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void st32(uint32_t at, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(v) : "memory");
}

// The thread's column pair jn (0 .. 4 NC - 1): 64 n + 32 wg + 8 j + 2 q
// with n = jn / 4, j = jn % 4 (its accumulator group j of N tile n).
__device__ __forceinline__ int col_of(int jn, int wg, int q) {
  return 64 * (jn >> 2) + 32 * wg + 8 * (jn & 3) + 2 * q;
}

// The bf16 pairs at the thread's columns of its two rows, zero past c and
// in rows that are not real (`ok`; their pointers still point at a real
// pixel).  Every load is unconditional (the column clamped into the
// row), so all of them are in flight at once.
template <int NJ>
__device__ __forceinline__ void load_rows(uint32_t (&v)[NJ][2], const bf16* const (&row)[2],
                                          const bool (&ok)[2], int wg, int q, int c,
                                          bool even) {
  if (even) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int col = col_of(j, wg, q);
        const uint32_t u =
            __ldg(reinterpret_cast<const unsigned int*>(row[h2] + (col < c ? col : c - 2)));
        v[j][h2] = ok[h2] && col < c ? u : 0u;
      }
  } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int col = col_of(j, wg, q);
        const unsigned short* r = reinterpret_cast<const unsigned short*>(row[h2]);
        const uint32_t lo = __ldg(r + (col < c ? col : c - 1));
        const uint32_t hi = __ldg(r + (col + 1 < c ? col + 1 : c - 1));
        v[j][h2] = ok[h2] ? (col < c ? lo : 0u) | (col + 1 < c ? hi << 16 : 0u) : 0u;
      }
  }
}

// The weight ring as the consumers walk it: tile g sits in stage g % S
// with phase (g / S) & 1; lane 0 of each consumer warp releases a stage
// once the warp's wgmma on it has completed (8 arrivals free it).
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

// acc[n] (+)= A[64 x 64 KC] (KC swizzled [64, 64] chunks at `a_at`) @ N
// rows from `b_off` bytes into each of the next KC * NT ring tiles (K
// chunk outer, N tile inner): one commit group a tile, the previous tile
// released once the next is issued.
template <int NT, int KC, int N>
__device__ __forceinline__ void gemm_ring(float (&acc)[NT][N / 2], uint32_t a_at, Ring& rg,
                                          int lane, uint32_t b_off) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint32_t tile = rg.acquire();
      hopper::wgmma_fence();
      const uint64_t da = hopper::desc_sw128(a_at + kc * 8192);
      const uint64_t db = hopper::desc_sw128(tile + b_off);
#pragma unroll
      for (int k = 0; k < 4; ++k) hopper::Wgmma<N>::mma(acc[n], da + 2 * k, db + 2 * k, 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (kc > 0 || n > 0) rg.release(rg.g - 1, lane);
      ++rg.g;
    }
  }
  hopper::wgmma_wait<0>();
  rg.release(rg.g - 1, lane);
#pragma unroll
  for (int n = 0; n < NT; ++n) hopper::fence_operands(acc[n]);
}

template <int NC>
__global__ void __launch_bounds__(NTHREADS, 1) datb_tail_wg_kernel(const Args a) {
  constexpr int CP = 64 * NC;  // padded channels
  constexpr int KC = NC;       // 64-column K chunks of an A operand
  constexpr int NJ = 4 * NC;   // the thread's column pairs of a row
  constexpr int A_BYTES = KC * 8192;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const int S = a.stages, HP = a.hp, hpc = a.hp / 64;
  const uint32_t abufs = ring + S * STAGE_BYTES;
  const uint32_t gbuf = abufs + 2 * A_BYTES;  // the gate product, fc2's A chunk
  const uint32_t slots = gbuf + 8192;
  const uint32_t slot_bytes = ROWS * HP * 2;
  const uint32_t red_at = slots + 3 * slot_bytes;  // [2 norms][2 wg][64 rows] float2
  const uint32_t bars = red_at + 2 * 2 * ROWS * 8;
  Ring rg{ring, bars, S, 0};
  const VecOff vo = vec_offsets(CP, HP);
  const float* vec = a.vec;
  float2* red = reinterpret_cast<float2*>(smem_raw + (red_at - raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(rg.full(s), 1);  // the feeder's expect_tx; the bytes complete it
      hopper::mbar_init(rg.empty(s), NCONS / 32);  // lane 0 of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // the stream's segments (bytes): the chain's spatial map, proj and fc1
  // h2 half, then the output's (fc1 h1 chunk, fc2 chunk) pairs
  const long long proj_at = KC * SP_TILE;
  const long long h2_at = proj_at + static_cast<long long>(KC) * NC * STAGE_BYTES;
  const long long out_at = h2_at + static_cast<long long>(hpc) * KC * STAGE_BYTES;
  auto unit_rows = [&](int un, int& img, int& strip, int& r0, int& r1) {
    const int band = un % a.nbands, rest = un / a.nbands;
    strip = rest % a.strips;
    img = rest / a.strips;
    r0 = band * a.band;
    r1 = min(r0 + a.band, a.h);
  };

  if (warp >= NCONS / 32) {
    // ------------------------------------------------------ weight feeder
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid != NCONS) return;
    const char* base = reinterpret_cast<const char*>(a.tiles);
    int g = 0;
    auto push = [&](const char* src, uint32_t bytes) {
      const int st = g % S;
      hopper::mbar_wait(rg.empty(st), ((g / S) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(rg.full(st), bytes);
      hopper::bulk_copy(ring + st * STAGE_BYTES, src, bytes, rg.full(st));
      ++g;
    };
    for (int un = blockIdx.x; un < a.units; un += gridDim.x) {
      int img, strip, r0, r1;
      unit_rows(un, img, strip, r0, r1);
      for (int t = r0 - 1; t <= r1; ++t) {
        if (t >= 0 && t < a.h) {
          for (int i = 0; i < KC; ++i) push(base + i * SP_TILE, SP_TILE);
          for (int i = 0; i < KC * NC; ++i) push(base + proj_at + i * STAGE_BYTES, STAGE_BYTES);
          for (int pass = 0; pass < 2; ++pass)
            for (int i = 0; i < hpc * KC; ++i) push(base + h2_at + i * STAGE_BYTES, STAGE_BYTES);
        }
        if (t - 1 >= r0)
          for (int i = 0; i < hpc * (KC + NC); ++i)
            push(base + out_at + i * STAGE_BYTES, STAGE_BYTES);
      }
    }
    return;
  }
  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2, q = lane & 3, ct = tid;
  const uint32_t b_off = wg * 32 * 128;  // the warpgroup's 32 rows of an N tile
  const int rr[2] = {16 * (warp & 3) + (lane >> 2), 16 * (warp & 3) + (lane >> 2) + 8};
  const bool even = (a.c & 1) == 0;
  const float inv_c = 1.f / static_cast<float>(a.c);
  const float inv_half = 1.f / static_cast<float>(a.half);
  auto a_off = [](uint32_t base, int row, int col) {  // bf16 (row, col) of swizzled chunks
    return base + (col >> 6) * 8192 + hopper::sw128_offset(row, (col & 63) * 2);
  };
  // the 4-byte word of channels (ch, ch + 1) of tile row p in an h2 slot
  auto h2_word = [&](int p, int ch) { return p * (HP >> 1) + ((ch >> 1) ^ ((p & 7) << 2)); };
  // the row sums (s, sq) of both warpgroups' columns: lane q == 0 of each
  // quad posts its warpgroup's, a barrier, then every thread adds both
  auto row_stats = [&](int which, float (&s)[2], float (&sq)[2]) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      s[h2] = quad_sum(s[h2]);
      sq[h2] = quad_sum(sq[h2]);
      if (q == 0) red[(which * 2 + wg) * ROWS + rr[h2]] = make_float2(s[h2], sq[h2]);
    }
    cons_barrier();
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float2 p0 = red[(which * 2) * ROWS + rr[h2]], p1 = red[(which * 2 + 1) * ROWS + rr[h2]];
      s[h2] = p0.x + p1.x;
      sq[h2] = p0.y + p1.y;
    }
  };

  for (int un = blockIdx.x; un < a.units; un += gridDim.x) {
    int img, strip, r0, r1;
    unit_rows(un, img, strip, r0, r1);
    const int cb = strip * a.seg - a.halo;          // the column of tile row 0
    const int out_lo = strip * a.seg, out_hi = min(out_lo + a.seg, a.w);
    int col[2];
    bool valid[2], is_out[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      col[h2] = cb + rr[h2];
      valid[h2] = col[h2] >= 0 && col[h2] < a.w;
      is_out[h2] = col[h2] >= out_lo && col[h2] < out_hi;
    }
    const float* gate = a.gate + static_cast<long long>(img) * a.c;

    for (int t = r0 - 1; t <= r1; ++t) {
      const int k = t - r0 + 1;  // 0 .. band + 1
      const uint32_t slot = slots + (k % 3) * slot_bytes;
      const uint32_t abuf = abufs + (k & 1) * A_BYTES;
      float2* x2st = reinterpret_cast<float2*>(a.x2ws) +
                     (static_cast<long long>(blockIdx.x) * 2 + (k & 1)) * (ROWS * CP / 2);
      cons_barrier();  // row k - 2's output has read this slot, this A buffer
      if (t < 0 || t >= a.h) {
        // ---- a row outside the image: the conv's zero padding
        for (int i = ct; i < ROWS * HP / 2; i += NCONS) st32(slot + 4 * i, 0u);
      } else {
        const bf16* urow[2];
        const bf16* wrow[2];
        const bf16* xrow[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int cc = valid[h2] ? col[h2] : 0;
          const long long off = ((static_cast<long long>(img) * a.h + t) * a.w + cc) * a.c;
          urow[h2] = a.u + off;
          wrow[h2] = a.wpx + off;
          xrow[h2] = a.x + off;
        }
        // ---- u -> the A buffer (w_px, x and the gate in flight)
        uint32_t up[NJ][2], wp[NJ][2], xp[NJ][2];
        float2 gv[NJ];
        load_rows<NJ>(up, urow, valid, wg, q, a.c, even);
        load_rows<NJ>(wp, wrow, valid, wg, q, a.c, even);
        load_rows<NJ>(xp, xrow, valid, wg, q, a.c, even);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int cc = col_of(j, wg, q);
          const float g0 = __ldg(gate + min(cc, a.c - 1)), g1 = __ldg(gate + min(cc + 1, a.c - 1));
          gv[j] = make_float2(cc < a.c ? g0 : 0.f, cc + 1 < a.c ? g1 : 0.f);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) st32(a_off(abuf, rr[h2], col_of(j, wg, q)), up[j][h2]);
        hopper::fence_proxy_async();
        cons_barrier();
        // ---- the spatial map m = sigmoid(w2 . bf16(gelu(W1 u + b1)) + b2),
        // all 16 columns in each warpgroup
        float sacc[1][8];
#pragma unroll
        for (int e = 0; e < 8; ++e) sacc[0][e] = 0.f;
        gemm_ring<1, KC, 16>(sacc, abuf, rg, lane, 0);
        float m[2];
        {
          float part[2] = {0.f, 0.f};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = 8 * j + 2 * q;
            const float2 b1 = *reinterpret_cast<const float2*>(vec + vo.spb1 + n);
            const float2 w2 = *reinterpret_cast<const float2*>(vec + vo.spw2 + n);
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2)
              part[h2] += round_bf16(gelu_erf(sacc[0][4 * j + 2 * h2] + b1.x)) * w2.x +
                          round_bf16(gelu_erf(sacc[0][4 * j + 2 * h2 + 1] + b1.y)) * w2.y;
          }
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            m[h2] = 1.f / (1.f + __expf(-(quad_sum(part[h2]) + vec[vo.spb2])));
        }
        cons_barrier();  // every warp's spatial-map wgmma has read u
        // ---- sg = bf16(u * gate + w_px * m), in place
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float2 uv = unpack_bf16(up[j][h2]), wv = unpack_bf16(wp[j][h2]);
            st32(a_off(abuf, rr[h2], col_of(j, wg, q)),
                 pack_bf16(uv.x * gv[j].x + wv.x * m[h2], uv.y * gv[j].y + wv.y * m[h2]));
          }
        hopper::fence_proxy_async();
        cons_barrier();
        // ---- x2 = x + sg Wproj + bproj (fp32) -> the workspace; LN2
        float pacc[NC][16];
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 16; ++e) pacc[n][e] = 0.f;
        gemm_ring<NC, KC, 32>(pacc, abuf, rg, lane, b_off);
        float s[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn) {
          const int n = jn >> 2, j = jn & 3, cc = col_of(jn, wg, q);
          const float2 bb = *reinterpret_cast<const float2*>(vec + vo.bproj + cc);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float2 xv = unpack_bf16(xp[jn][h2]);
            const float v0 = pacc[n][4 * j + 2 * h2] + bb.x + xv.x;
            const float v1 = pacc[n][4 * j + 2 * h2 + 1] + bb.y + xv.y;
            pacc[n][4 * j + 2 * h2] = v0;
            pacc[n][4 * j + 2 * h2 + 1] = v1;
            x2st[(2 * jn + h2) * NCONS + ct] = make_float2(v0, v1);
            s[h2] += v0 + v1;  // zero past C
            sq[h2] += v0 * v0 + v1 * v1;
          }
        }
        row_stats(0, s, sq);  // also: every warp's proj wgmma has read sg
        float mu[2], rs[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          mu[h2] = s[h2] * inv_c;
          rs[h2] = rsqrtf(fmaxf(sq[h2] * inv_c - mu[h2] * mu[h2], 0.f) + a.eps);
        }
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn) {
          const int n = jn >> 2, j = jn & 3, cc = col_of(jn, wg, q);
          const float2 g = *reinterpret_cast<const float2*>(vec + vo.g2 + cc);
          const float2 b = *reinterpret_cast<const float2*>(vec + vo.b2 + cc);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            st32(a_off(abuf, rr[h2], cc),
                 pack_bf16((pacc[n][4 * j + 2 * h2] - mu[h2]) * rs[h2] * g.x + b.x,
                           (pacc[n][4 * j + 2 * h2 + 1] - mu[h2]) * rs[h2] * g.y + b.y));
        }
        hopper::fence_proxy_async();
        cons_barrier();
        // ---- fc1's h2 half, GELU: LN_sg's statistics, then LN_sg -> the slot
        float mu2[2] = {0.f, 0.f}, rs2[2] = {0.f, 0.f};
        uint32_t* slot_w = reinterpret_cast<uint32_t*>(smem_raw + (slot - raw));
        for (int pass = 0; pass < 2; ++pass) {
          float s2[2] = {0.f, 0.f}, sq2[2] = {0.f, 0.f};
          for (int jc = 0; jc < hpc; ++jc) {
            float hacc[1][16];
#pragma unroll
            for (int e = 0; e < 16; ++e) hacc[0][e] = 0.f;
            gemm_ring<1, KC, 32>(hacc, abuf, rg, lane, b_off);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int ch = 64 * jc + 32 * wg + 8 * j + 2 * q;
              const float2 bb = *reinterpret_cast<const float2*>(vec + vo.bfc1 + HP + ch);
              const float2 g = *reinterpret_cast<const float2*>(vec + vo.gsg + ch);
              const float2 b = *reinterpret_cast<const float2*>(vec + vo.bsg + ch);
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2) {
                const float v0 = gelu_erf(hacc[0][4 * j + 2 * h2] + bb.x);
                const float v1 = gelu_erf(hacc[0][4 * j + 2 * h2 + 1] + bb.y);
                if (pass == 0) {
                  s2[h2] += v0 + v1;  // zero past the half
                  sq2[h2] += v0 * v0 + v1 * v1;
                } else {
                  slot_w[h2_word(rr[h2], ch)] =
                      valid[h2] ? pack_bf16((v0 - mu2[h2]) * rs2[h2] * g.x + b.x,
                                            (v1 - mu2[h2]) * rs2[h2] * g.y + b.y)
                                : 0u;
                }
              }
            }
          }
          if (pass == 0) {
            row_stats(1, s2, sq2);
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              mu2[h2] = s2[h2] * inv_half;
              rs2[h2] = rsqrtf(fmaxf(sq2[h2] * inv_half - mu2[h2] * mu2[h2], 0.f) + a.eps);
            }
          }
        }
      }
      if (t - 1 < r0) continue;
      cons_barrier();  // row t's h2 is in its slot
      // ---- row t - 1's output: h1 chunk, the depthwise conv, the gate
      // product -> fc2's A chunk, fc2 over the chunks
      const int ko = k - 1;
      const uint32_t obuf = abufs + (ko & 1) * A_BYTES;
      const uint32_t* sl[3] = {
          reinterpret_cast<const uint32_t*>(smem_raw + (slots - raw) + ((ko + 2) % 3) * slot_bytes),
          reinterpret_cast<const uint32_t*>(smem_raw + (slots - raw) + (ko % 3) * slot_bytes),
          reinterpret_cast<const uint32_t*>(smem_raw + (slots - raw) + ((ko + 1) % 3) * slot_bytes)};
      const float2* x2o = reinterpret_cast<const float2*>(a.x2ws) +
                          (static_cast<long long>(blockIdx.x) * 2 + (ko & 1)) * (ROWS * CP / 2);
      if (t + 1 <= r1 && t + 1 < a.h) {
        // the next chain row's u and w_px (warpgroup 0) and x (warpgroup
        // 1) into L2 while this output runs: thread q of a quad takes the
        // q-th 128-byte line of its pixel's row
        const long long off0 = (static_cast<long long>(img) * a.h + t + 1) * a.w;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          if (!valid[h2] || 128 * q >= 2 * a.c) continue;
          const long long off = (off0 + col[h2]) * a.c + 64 * q;
          if (wg == 0) {
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a.u + off));
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a.wpx + off));
          } else {
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a.x + off));
          }
        }
      }
      float acc2[NC][16];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 16; ++e) acc2[n][e] = 0.f;
      for (int jc = 0; jc < hpc; ++jc) {
        float hacc[1][16];
#pragma unroll
        for (int e = 0; e < 16; ++e) hacc[0][e] = 0.f;
        gemm_ring<1, KC, 32>(hacc, obuf, rg, lane, b_off);
        // the depthwise conv at the thread's 4 channel pairs of its two
        // rows: each tap's loads together, a neighbour past the tile's
        // edge (outside the image) selected away
        const int ch0 = 64 * jc + 32 * wg + 2 * q;
        float2 d[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 bd = *reinterpret_cast<const float2*>(vec + vo.bdw + ch0 + 8 * j);
          d[j][0] = d[j][1] = bd;
        }
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int p0 = rr[0] + dx - 1, p1 = rr[1] + dx - 1;  // p0 >= -1, p1 <= 64
            const bool ok0 = p0 >= 0, ok1 = p1 < ROWS;
            const int q0 = ok0 ? p0 : 0, q1 = ok1 ? p1 : ROWS - 1;
            float2 wt[4];
            uint32_t hv[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int ch = ch0 + 8 * j;
              wt[j] = *reinterpret_cast<const float2*>(vec + vo.wdw + (3 * dy + dx) * HP + ch);
              hv[j][0] = sl[dy][h2_word(q0, ch)];
              hv[j][1] = sl[dy][h2_word(q1, ch)];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 v0 = unpack_bf16(ok0 ? hv[j][0] : 0u);
              const float2 v1 = unpack_bf16(ok1 ? hv[j][1] : 0u);
              d[j][0].x += v0.x * wt[j].x;
              d[j][0].y += v0.y * wt[j].y;
              d[j][1].x += v1.x * wt[j].x;
              d[j][1].y += v1.y * wt[j].y;
            }
          }
        uint32_t gp[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 b1 = *reinterpret_cast<const float2*>(vec + vo.bfc1 + ch0 + 8 * j);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            gp[j][h2] = pack_bf16(gelu_erf(hacc[0][4 * j + 2 * h2] + b1.x) * d[j][h2].x,
                                  gelu_erf(hacc[0][4 * j + 2 * h2 + 1] + b1.y) * d[j][h2].y);
        }
        cons_barrier();  // both warpgroups' fc2 has read the last chunk's product
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            st32(a_off(gbuf, rr[h2], 32 * wg + 8 * j + 2 * q), gp[j][h2]);
        hopper::fence_proxy_async();
        cons_barrier();
        gemm_ring<NC, 1, 32>(acc2, gbuf, rg, lane, b_off);
      }
      // ---- out = x2 + fc2 + bfc2 on the strip's output columns (every
      // load before any store)
      bf16* orow[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int cc = is_out[h2] ? col[h2] : 0;
        orow[h2] = a.out + ((static_cast<long long>(img) * a.h + (t - 1)) * a.w + cc) * a.c;
      }
      float2 x2v[NJ][2];
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) x2v[jn][h2] = x2o[(2 * jn + h2) * NCONS + ct];
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn) {
        const int n = jn >> 2, j = jn & 3, cc = col_of(jn, wg, q);
        const float2 bb = *reinterpret_cast<const float2*>(vec + vo.bfc2 + cc);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float v0 = x2v[jn][h2].x + acc2[n][4 * j + 2 * h2] + bb.x;
          const float v1 = x2v[jn][h2].y + acc2[n][4 * j + 2 * h2 + 1] + bb.y;
          if (!is_out[h2] || cc >= a.c) continue;
          if (even) {
            *reinterpret_cast<uint32_t*>(orow[h2] + cc) = pack_bf16(v0, v1);
          } else {
            orow[h2][cc] = __float2bfloat16(v0);
            if (cc + 1 < a.c) orow[h2][cc + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

template <int NC>
int launch(const Args& a, int grid, cudaStream_t stream) {
  const int smem = 1024 + a.stages * STAGE_BYTES + 2 * NC * 8192 + 8192 +
                   3 * ROWS * a.hp * 2 + 2 * 2 * ROWS * 8 + 2 * MAX_STAGES * 8;
  if (a.stages < 2 || a.stages > MAX_STAGES || smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = datb_tail_wg_kernel<NC>;
  static const cudaError_t attr =  // once: the most any launch takes
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, u, w_px, out [batch, h, w, c] bf16; gate [batch, c] fp32; tiles and
// vec as kernels/fused_datb_tail.py ``pack_tail_weights`` lays them out;
// x2ws an fp32 workspace of grid * 2 * 64 * cp; geo = {batch, h, w, c,
// half, cp, hp, halo, seg, strips, band, nbands, units, grid, stages}:
// the launch plan (fused_datb_tail.tail_plan decides it; this entry only
// checks it).  cudaErrorInvalidValue where the shapes or the plan are
// outside the kernel.
extern "C" int sr_dat_tail_bf16(const void* x, const void* u, const void* wpx, const void* gate,
                                void* out, const void* tiles, const void* vec, void* x2ws,
                                const int* geo, float eps, void* stream) {
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.u = static_cast<const bf16*>(u);
  a.wpx = static_cast<const bf16*>(wpx);
  a.gate = static_cast<const float*>(gate);
  a.out = static_cast<bf16*>(out);
  a.tiles = static_cast<const bf16*>(tiles);
  a.vec = static_cast<const float*>(vec);
  a.x2ws = static_cast<float*>(x2ws);
  a.batch = geo[0];
  a.h = geo[1];
  a.w = geo[2];
  a.c = geo[3];
  a.half = geo[4];
  const int cp = geo[5];
  a.hp = geo[6];
  a.halo = geo[7];
  a.seg = geo[8];
  a.strips = geo[9];
  a.band = geo[10];
  a.nbands = geo[11];
  a.units = geo[12];
  const int grid = geo[13];
  a.stages = geo[14];
  a.eps = eps;
  const int strips_want = a.w <= ROWS ? 1 : (a.w + ROWS - 3) / (ROWS - 2);
  if (a.c < 1 || a.c > 192 || cp != (a.c + 63) / 64 * 64 || a.half < 1 || a.half > MAX_HP ||
      a.hp != (a.half + 63) / 64 * 64 || a.halo != (a.w > ROWS) ||
      a.seg != (a.w > ROWS ? ROWS - 2 : a.w) || a.strips != strips_want || a.band < 1 ||
      a.nbands != (a.h + a.band - 1) / a.band ||
      static_cast<long long>(a.units) != static_cast<long long>(a.batch) * a.strips * a.nbands ||
      grid < 1 || grid > a.units || !aligned_to(tiles, 16) || !aligned_to(vec, 8) ||
      !aligned_to(x2ws, 16) ||
      (a.c % 2 == 0 && !(aligned_to(x, 4) && aligned_to(u, 4) && aligned_to(wpx, 4) &&
                         aligned_to(out, 4))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(a.batch) * a.h * a.w == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cp == 64) return launch<1>(a, grid, s);
  if (cp == 128) return launch<2>(a, grid, s);
  return launch<3>(a, grid, s);
}
