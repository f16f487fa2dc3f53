// K1t on Hopper's wgmma — K1's tail on the K7 route for C <= 256: the
// attention residual (window reverse and cyclic unshift in the
// addressing), HAT's `extra`, LN2, the MLP and its residual.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_block.py
//           K1 fused_swin_block -> _mega_forward -> _kernel (pallas_call
//           at :958): its body after the attention projection (:485-512),
//           for the blocks the whole-block kernel (csrc/swin_block.cu) does
//           not take.  Past C 256 csrc/swin_tail.cu (WMMA) computes the
//           same function (kernels/fused_block.py ``tail_route``).
// Math (per pixel p of x [B, H, W, C], C <= 256, any MLP hidden):
//         x1  = x + m1 * attn[win(p), tok(p)] + extra          (fp32)
//         y2  = bf16(LN2(x1))         fast-variance statistics, eps given
//         h   = bf16(gelu(y2 Wfc1^T + bfc1))     tanh or erf, per chunk
//         out = bf16(x1 + m2 * (sum over hidden chunks of h Wfc2^T + bfc2))
//       the JAX order: fc2 accumulated in fp32 over every chunk before
//       its bias, m2 and the residual, one rounding at the store.  attn
//       [B*nW, ws*ws, C] is K7's output on the windows of the map
//       cyclically shifted by s: pixel (i, j) is token ((i-s) mod H % ws,
//       (j-s) mod W % ws) of window ((i-s) mod H / ws, (j-s) mod W / ws).
//       (m1, m2) = scales[b] (1 when scales is null); `extra` unscaled.
// Bound on the H100: HAT-SRx4's bench batch ([25,64,64,180], hidden 360)
//       moves x, attn, extra in and out, 147.7 MB (0.0441 ms at 3.35
//       TB/s), against 26.5 GFLOP (0.0268 ms); SwinIR-L's ([25,64,64,240],
//       hidden 480, no extra) 47.2 GFLOP (0.0477 ms) against 147.9 MB.
// Design:
//     - Persistent CTAs, one an SM, walk units of 64 consecutive rows of
//       the flat [B*H*W, C] map: one wgmma m64 tile (HAT-SRx4's bench
//       batch: 1600 units, 12.1 rounds of 132 CTAs).  Two consumer
//       warpgroups share each unit and split every product's N: warpgroup
//       w owns output channels [w CP/2, (w+1) CP/2) of fc2 (a [64, CP/2]
//       fp32 accumulator: 48 registers a thread at CP 192, 64 at CP 256)
//       and hidden columns [32 w, 32 w + 32) of each 64-column chunk.
//       (Units in pairs, a warpgroup a unit, would need the whole [64, CP]
//       accumulator a thread and leave 6.06 rounds, the 7th on 8 CTAs.)
//     - LN2's output goes once a unit through a swizzled [64, CP] buffer
//       into registers (ldmatrix): fc1 takes it as wgmma's A from
//       registers, so each chunk reads only its weights from shared
//       memory.  The GELU'd bf16 halves of a chunk meet in a
//       double-buffered swizzled [64, 64] A chunk; fc2 of the chunk reads
//       it from shared memory with the warpgroup's N half of B.  The
//       hidden runs in an even number of chunks (a last odd one zero), fc1
//       into two register buffers: fc1 of chunk k+2 and fc2 of chunk k are
//       in the tensor cores while GELU(k+1) runs, then one named barrier.
//     - A feeder thread streams the weights (``pack_block_tail``: per
//       64-column hidden chunk, fc1's [64, CP] rows as CP/64 K-major
//       128B-swizzled [64, 64] tiles, then fc2's [CP, 64] tile) through an
//       mbarrier ring of CP x 128-byte stages, one bulk copy a stage, in
//       the consumers' order: fc1(0), fc1(1), then (fc1(k+2), fc2(k)).
//       setmaxnreg gives the feeder warpgroup's registers to the consumers.
//     - Three loader warps of that warpgroup copy the next unit's inputs
//       into shared staging while the current unit's MLP runs: x and
//       extra, 64 C contiguous bf16 a unit, by one bulk copy each (dense
//       rows); the attention rows one by one at a stride of 16 (2k + 1)
//       bytes (free of bank conflicts for the consumers' reads in their
//       accumulator layout, 8 rows x 4 words a warp), by a bulk copy a row
//       where rows are 16-byte multiples (C % 8 == 0), else by cp.async of
//       8 or 4 bytes (C 180's 360-byte rows start 8-byte aligned), else
//       (odd C) element copies.  A pixel's attention row follows from its
//       (window, token); rows are copied one by one, so a run of tokens
//       that wraps at the map's edge under the shift needs no case of its
//       own.
//     - x1 stays in registers at CP <= 192; at CP 256 (no room beside the
//       accumulators) it goes to a per-CTA fp32 workspace in L2 between
//       LN2 and the epilogue.  LN2's row sums meet across the warpgroups
//       in shared memory; g2, b2 and bfc2 are read from shared memory,
//       each chunk's fc1 bias is loaded a chunk ahead (a global load
//       between two shared stores waits out its whole latency).
//     - GELU's erf is the JAX kernel's own polynomial (one reciprocal and
//       one exp), the kernel's largest share of SIMT work.
//     - No atomics: the output is the same bit for bit on every run.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NCONS = 256;                 // two consumer warpgroups
constexpr int NLOAD = 96;                  // loader warps 9-11
constexpr int NTHREADS = NCONS + 128;      // + the feeder / loader warpgroup
// setmaxnreg: an SM sub-partition holds one warp of each warpgroup, 16K
// registers: 32 x (2 x 232 + 40) <= 16384
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int ROWS = 64;                   // pixels a unit (the wgmma m64)
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_C = 256;

// How the loaders copy a row: bulk copy, cp.async of 8 or 4 bytes, or
// element by element.
enum CopyMode { COPY_BULK = 0, COPY_8 = 1, COPY_4 = 2, COPY_2 = 3 };

struct Args {
  const bf16* x;       // [rows, c]
  const bf16* attn;    // [windows, ws * ws, c]
  const bf16* extra;   // [rows, c] or null
  bf16* out;           // [rows, c]
  const bf16* tiles;   // the weight stream (pack_block_tail)
  const float* vec;    // g2 [cp], b2 [cp], bfc2 [cp], bfc1 [chunks * 64], zero-padded
  const float* scales;  // [batch, 2] or null
  float* x1ws;         // [grid, 64 * cp] fp32 at cp 256, else null
  long long rows;      // batch * h * w
  int h, w, c, ws, shift, chunks, units, stages, rsb, mode, xe_bulk, out16, gelu_tanh;
  float eps;
};

// The staging's row of x and extra in elements: C rounded up to even, so
// that every pair the consumers read is one aligned word (dense rows, a
// unit one contiguous copy, wherever C is even).
__host__ __device__ constexpr int xe_ld(int c) { return c + (c & 1); }

// Shared memory (bytes from the 1024-aligned base): the ring, the LN2 /
// output buffer, two GELU'd chunks, the staging (x, attn at `rsb` a row,
// extra), the LN2 row sums, g2 / b2 / bfc2, the barriers.
struct Layout {
  int ln, gelu, stg, attn, extra, red, vec, bars, bytes;
  __host__ __device__ Layout(int nc, int stages, int c, int rsb, bool with_extra) {
    const int stage = nc * 8192;
    ln = stages * stage;
    gelu = ln + stage;
    stg = gelu + 2 * 8192;
    attn = stg + ROWS * 2 * xe_ld(c);  // a multiple of 256
    extra = attn + ROWS * rsb;
    red = extra + (with_extra ? ROWS * 2 * xe_ld(c) : 0);
    vec = red + 2 * ROWS * 8;
    bars = vec + 3 * nc * 64 * 4;
    bytes = 1024 + bars + (2 * MAX_STAGES + 2) * 8;
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// GELU's two forms: tanh's as csrc/swin_block.cu computes it, u - u /
// (e^2t + 1) with one exp and an approximate division; erf's with the
// JAX kernel's own erf (fused_block.py ``_erf_poly``: Abramowitz & Stegun
// 7.1.26, |error| <= 1.5e-7), one approximate reciprocal and one exp.
template <bool TANH>
__device__ __forceinline__ float gelu(float u) {
  if (TANH) {
    const float t = 0.7978845608028654f * (u + 0.044715f * u * u * u);
    return u - __fdividef(u, __expf(2.f * t) + 1.f);
  }
  const float x = u * 0.7071067811865476f, ax = fabsf(x);
  const float t = __fdividef(1.f, 1.f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf = copysignf(1.f - poly * __expf(-ax * ax), x);
  return 0.5f * u * (1.f + erf);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void cons_barrier() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void load_barrier() {
  asm volatile("bar.sync 2, 96;\n" ::: "memory");
}

__device__ __forceinline__ void st32(uint32_t at, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(v) : "memory");
}

// byte address of bf16 (row, col) in KC swizzled [64, 64] chunks at `base`
__device__ __forceinline__ uint32_t a_off(uint32_t base, int row, int col) {
  return base + (col >> 6) * 8192 + hopper::sw128_offset(row, (col & 63) * 2);
}

// The row of pixel p's attention output in attn [windows * ws * ws, c].
__device__ __forceinline__ long long attn_row(const Args& a, long long p) {
  const long long hw = static_cast<long long>(a.h) * a.w;
  const long long b = p / hw;
  const int rem = static_cast<int>(p - b * hw);
  int i = rem / a.w, j = rem - (rem / a.w) * a.w;
  i -= a.shift;
  j -= a.shift;
  if (i < 0) i += a.h;
  if (j < 0) j += a.w;
  const int wy = i / a.ws, wx = j / a.ws;
  const long long win = (b * (a.h / a.ws) + wy) * (a.w / a.ws) + wx;
  return win * (a.ws * a.ws) + (i - wy * a.ws) * a.ws + (j - wx * a.ws);
}

// The weight ring as the consumers walk it: tile g sits in stage g % S
// with phase (g / S) & 1; lane 0 of each consumer warp releases a stage
// once the warp's wgmma on it has completed (8 arrivals free it).
struct Ring {
  uint32_t stages_at, bars, stage_bytes;
  int S, g;
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8u * (MAX_STAGES + s); }
  __device__ __forceinline__ uint32_t acquire() const {
    hopper::mbar_wait(full(g % S), (g / S) & 1);
    return stages_at + (g % S) * stage_bytes;
  }
  __device__ __forceinline__ void release(int tile, int lane) const {
    if (lane == 0) hopper::mbar_arrive(empty(tile % S));
  }
};

// GELU(hacc + bias) of the warpgroup's 32 columns of a hidden chunk
// (m64n32's layout; b[j] the bias at its columns 8 j + 2 q, + 1) -> bf16
// into the swizzled [64, 64] chunk at `buf`.
template <bool TANH>
__device__ __forceinline__ void gelu_chunk(const float (&h)[16], const float2 (&b)[4], uint32_t buf,
                                           const int (&rr)[2], int wg, int q) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = 32 * wg + 8 * j + 2 * q;
    const float2 bb = b[j];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      st32(a_off(buf, rr[h2], col),
           pack_bf16(gelu<TANH>(h[4 * j + 2 * h2] + bb.x), gelu<TANH>(h[4 * j + 2 * h2 + 1] + bb.y)));
  }
}

template <int NC>
__global__ void __launch_bounds__(NTHREADS, 1) swin_tail_wg_kernel(const Args a) {
  constexpr int CP = 64 * NC;          // padded channels
  constexpr int NJ = 4 * NC;           // a thread's column pairs of a row (its N half)
  constexpr int KB = 4 * NC;           // k16 blocks of fc1's K
  constexpr int STAGE = NC * 8192;     // a ring stage: fc1's chunk or fc2's chunk
  constexpr bool X1_REGS = NC <= 3;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int S = a.stages;
  const Layout lay(NC, S, a.c, a.rsb, a.extra != nullptr);
  const uint32_t lnbuf = base + lay.ln, gbuf = base + lay.gelu;
  const uint32_t bars = base + lay.bars;
  const uint32_t sfull = bars + 8u * 2 * MAX_STAGES, sempty = sfull + 8u;
  uint8_t* const sm = smem_raw + (base - raw);  // generic pointer of `base`
  float2* red = reinterpret_cast<float2*>(sm + lay.red);
  float* vs = reinterpret_cast<float*>(sm + lay.vec);
  Ring rg{base, bars, STAGE, S, 0};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(rg.full(s), 1);            // the feeder's expect_tx; the bytes complete it
      hopper::mbar_init(rg.empty(s), NCONS / 32);  // lane 0 of each consumer warp
    }
    hopper::mbar_init(sfull, NLOAD + 1);           // every loader thread + the expect_tx
    hopper::mbar_init(sempty, NCONS / 32);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= NCONS / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == NCONS) {
      // ------------------------------------------------------ weight feeder
      const char* tiles = reinterpret_cast<const char*>(a.tiles);
      int g = 0;
      auto push = [&](int chunk, int which) {  // which 0: fc1's, 1: fc2's
        const int st = g % S;
        hopper::mbar_wait(rg.empty(st), ((g / S) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(rg.full(st), STAGE);
        hopper::bulk_copy(base + st * STAGE, tiles + (2LL * chunk + which) * STAGE, STAGE,
                          rg.full(st));
        ++g;
      };
      for (int un = blockIdx.x; un < a.units; un += gridDim.x) {
        push(0, 0);
        push(1, 0);
        for (int k = 0; k < a.chunks; ++k) {
          if (k + 2 < a.chunks) push(k + 2, 0);
          push(k, 1);
        }
      }
      return;
    }
    if (warp < NCONS / 32 + 1) return;
    // ---------------------------------------------------- activation loader
    const int lt = tid - (NCONS + 32), lw = lt >> 5;
    const uint32_t row_bytes = 2u * a.c;
    const uint32_t stg_a = base + lay.attn;
    unsigned short* const xs16 = reinterpret_cast<unsigned short*>(sm + lay.stg);
    unsigned short* const es16 = reinterpret_cast<unsigned short*>(sm + lay.extra);
    int i = 0;
    for (int un = blockIdx.x; un < a.units; un += gridDim.x, ++i) {
      const long long p0 = static_cast<long long>(un) * ROWS;
      const int rows_u = static_cast<int>(min(static_cast<long long>(ROWS), a.rows - p0));
      const uint32_t xe_bytes = rows_u * row_bytes;  // a unit of x (or extra): contiguous
      const uint32_t xe_bulk = a.xe_bulk ? xe_bytes & ~15u : 0u;
      hopper::mbar_wait(sempty, (i & 1) ^ 1);  // the consumers have read the last unit
      if (lt == 0)
        hopper::mbar_arrive_expect_tx(
            sfull, (a.extra ? 2 : 1) * xe_bulk + (a.mode == COPY_BULK ? xe_bytes : 0u));
      load_barrier();  // every byte is expected before any copy lands
      // x and extra: one bulk copy each into dense rows; the elements past
      // its 16-byte multiple (or all, where C is odd or x or extra is not
      // 16-byte aligned) one by one, at rows of xe_ld(C)
      if (lt == 0 && xe_bulk) {
        hopper::bulk_copy(base + lay.stg, a.x + p0 * a.c, xe_bulk, sfull);
        if (a.extra) hopper::bulk_copy(base + lay.extra, a.extra + p0 * a.c, xe_bulk, sfull);
      }
      {
        const unsigned short* x16 = reinterpret_cast<const unsigned short*>(a.x + p0 * a.c);
        const unsigned short* e16 =
            a.extra ? reinterpret_cast<const unsigned short*>(a.extra + p0 * a.c) : nullptr;
        for (uint32_t e = xe_bulk / 2 + lt; e < xe_bytes / 2; e += NLOAD) {
          const uint32_t r = e / a.c, at = r * xe_ld(a.c) + (e - r * a.c);
          xs16[at] = __ldg(x16 + e);
          if (a.extra) es16[at] = __ldg(e16 + e);
        }
      }
      // attn: each pixel's row (its window and token) at `rsb` a row
      if (a.mode == COPY_BULK) {
        if (lt < rows_u)
          hopper::bulk_copy(stg_a + lt * a.rsb, a.attn + attn_row(a, p0 + lt) * a.c, row_bytes,
                            sfull);
      } else {
        // a warp a row (rows lw, lw + 3, ...), its lanes along the row;
        // lane l holds the attention row of the warp's l-th row
        const int r_l = lw + 3 * lane;
        const long long arow_l = r_l < rows_u ? attn_row(a, p0 + r_l) : 0;
        const int gran = a.mode == COPY_8 ? 8 : a.mode == COPY_4 ? 4 : 2;
        const int pieces = static_cast<int>(row_bytes) / gran;
        for (int k = 0;; ++k) {
          const int r = lw + 3 * k;
          if (r >= rows_u) break;
          const char* src =
              reinterpret_cast<const char*>(a.attn + __shfl_sync(0xffffffffu, arow_l, k) * a.c);
          const uint32_t dst = stg_a + r * a.rsb;
          for (int e = lane; e < pieces; e += 32) {
            if (a.mode == COPY_8) {
              hopper::cp_async<8>(dst + 8 * e, src + 8 * e, 8);
            } else if (a.mode == COPY_4) {
              hopper::cp_async<4>(dst + 4 * e, src + 4 * e, 4);
            } else {
              *reinterpret_cast<unsigned short*>(sm + (dst - base) + 2 * e) =
                  __ldg(reinterpret_cast<const unsigned short*>(src) + e);
            }
          }
        }
        if (a.mode != COPY_2) hopper::cp_async_wait_all();
      }
      hopper::mbar_arrive(sfull);  // release: this thread's copies are in shared memory
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2, q = lane & 3, ct = tid;
  const int rr[2] = {16 * (warp & 3) + (lane >> 2), 16 * (warp & 3) + (lane >> 2) + 8};
  const bool even = (a.c & 1) == 0;
  const float inv_c = 1.f / static_cast<float>(a.c);
  const long long hw = static_cast<long long>(a.h) * a.w;
  // g2, b2, bfc2 into shared memory (read first after a barrier)
  for (int e = ct; e < 3 * CP; e += NCONS) vs[e] = __ldg(a.vec + e);
  const float* g2 = vs;
  const float* b2 = vs + CP;
  const float* bfc2 = vs + 2 * CP;
  const float* bfc1 = a.vec + 3 * CP;
  const uint32_t b1_off = wg * 32 * 128;          // the warpgroup's 32 rows of an fc1 tile
  const uint32_t b2_off = wg * (CP / 2) * 128;    // its CP/2 rows of an fc2 tile
  // the thread's column pair jn of a row: its warpgroup's N half
  auto col_of = [&](int jn) { return wg * (CP / 2) + 8 * jn + 2 * q; };
  float2* x1w = X1_REGS ? nullptr
                        : reinterpret_cast<float2*>(a.x1ws) +
                              static_cast<long long>(blockIdx.x) * (ROWS * CP / 2);
  bf16* outs = reinterpret_cast<bf16*>(sm + lay.ln);
  const uint8_t* xs = sm + lay.stg;
  const uint8_t* as = sm + lay.attn;
  const uint8_t* es = sm + lay.extra;
  const int xld = xe_ld(a.c);

  int i = 0;
  for (int un = blockIdx.x; un < a.units; un += gridDim.x, ++i) {
    const long long p0 = static_cast<long long>(un) * ROWS;
    const int rows_u = static_cast<int>(min(static_cast<long long>(ROWS), a.rows - p0));
    bool ok[2];
    float m1[2] = {1.f, 1.f}, m2[2] = {1.f, 1.f};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      ok[h2] = rr[h2] < rows_u;
      if (a.scales) {
        const long long b = (p0 + (ok[h2] ? rr[h2] : 0)) / hw;
        m1[h2] = __ldg(a.scales + 2 * b);
        m2[h2] = __ldg(a.scales + 2 * b + 1);
      }
    }

    // ---- x1 = x + m1 attn + extra from the staging (zero past C and in
    // rows past the map), its row sums
    hopper::mbar_wait(sfull, i & 1);
    float2 x1[NJ][2];
    float s[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
    // every load unconditional (the column clamped into the row, x read
    // again where there is no extra), so that all are in flight at once
    const uint8_t* es_or_x = a.extra ? es : xs;
#pragma unroll
    for (int jn = 0; jn < NJ; ++jn) {
      const int col = col_of(jn);
      const int cc = col < a.c ? col : 0;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int e = 2 * (rr[h2] * xld + cc);
        const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(xs + e));
        const float2 av =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(as + rr[h2] * a.rsb + 2 * cc));
        float2 ev = unpack_bf16(*reinterpret_cast<const uint32_t*>(es_or_x + e));
        if (!a.extra) ev = make_float2(0.f, 0.f);
        float v0 = xv.x + m1[h2] * av.x + ev.x;
        float v1 = xv.y + m1[h2] * av.y + ev.y;
        if (!ok[h2] || col >= a.c) v0 = 0.f;
        if (!ok[h2] || col + 1 >= a.c) v1 = 0.f;
        x1[jn][h2] = make_float2(v0, v1);
        s[h2] += v0 + v1;
        sq[h2] += v0 * v0 + v1 * v1;
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(sempty);  // the loaders may fill the next unit
    if (!X1_REGS) {
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) __stcg(x1w + (2 * jn + h2) * NCONS + ct, x1[jn][h2]);
    }

    // ---- LN2: the row sums of both warpgroups, then bf16 into the buffer
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      s[h2] = quad_sum(s[h2]);
      sq[h2] = quad_sum(sq[h2]);
      if (q == 0) red[wg * ROWS + rr[h2]] = make_float2(s[h2], sq[h2]);
    }
    cons_barrier();
    float mu[2], rs[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float2 p_0 = red[rr[h2]], p_1 = red[ROWS + rr[h2]];
      mu[h2] = (p_0.x + p_1.x) * inv_c;
      rs[h2] = rsqrtf(fmaxf((p_0.y + p_1.y) * inv_c - mu[h2] * mu[h2], 0.f) + a.eps);
    }
#pragma unroll
    for (int jn = 0; jn < NJ; ++jn) {
      const int col = col_of(jn);
      const float2 g = *reinterpret_cast<const float2*>(g2 + col);
      const float2 b = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        st32(a_off(lnbuf, rr[h2], col),
             pack_bf16((x1[jn][h2].x - mu[h2]) * rs[h2] * g.x + b.x,
                       (x1[jn][h2].y - mu[h2]) * rs[h2] * g.y + b.y));
    }
    cons_barrier();
    // fc1's A fragments: the warp's 16 rows, all of K
    uint32_t af[KB][4];
    {
      const int row = 16 * (warp & 3) + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
        hopper::ldmatrix_x4(af[kb], a_off(lnbuf, row, 16 * kb + 8 * (lane >> 4)));
    }

    // ---- the MLP over an even number of hidden chunks (the last one
    // zero where the hidden's chunks are odd): fc1 of chunk k+2 and fc2 of
    // chunk k in the tensor cores while GELU(k+1) runs, fc1's accumulators
    // in two buffers (A: even chunks, B: odd), so no wgmma sits under a
    // branch
    float acc2[CP / 4];
#pragma unroll
    for (int e = 0; e < CP / 4; ++e) acc2[e] = 0.f;
    float hA[16], hB[16];
    // fc1 of the next ring tile into h; returns the tile's index
    auto fc1 = [&](float (&h)[16]) {
      const int g = rg.g;
      const uint32_t tile = rg.acquire();
      ++rg.g;
      hopper::wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
        hopper::WgmmaRSK<32>::mma(h, af[kb],
                                  hopper::desc_sw128(tile + (kb >> 2) * 8192 + b1_off) +
                                      2 * (kb & 3),
                                  kb > 0);
      hopper::wgmma_commit();
      return g;
    };
    // fc2 of chunk k (A: its GELU'd chunk, B: the warpgroup's N half of
    // the next ring tile); returns the tile's index
    auto fc2 = [&](int k) {
      const int g = rg.g;
      const uint32_t tile = rg.acquire();
      ++rg.g;
      hopper::wgmma_fence();
      const uint64_t da = hopper::desc_sw128(gbuf + (k & 1) * 8192);
      const uint64_t db = hopper::desc_sw128(tile + b2_off);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) hopper::Wgmma<CP / 2>::mma(acc2, da + 2 * ks, db + 2 * ks, 1);
      hopper::wgmma_commit();
      return g;
    };
    float2 b1[4];  // fc1's bias at the thread's columns of the chunk GELU takes next
    auto bias1 = [&](int jc) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b1[j] = __ldg(reinterpret_cast<const float2*>(bfc1 + 64 * jc + 32 * wg + 8 * j + 2 * q));
    };
    // GELU of chunk jc (its fc1 complete in h) -> its A chunk; then the
    // next chunk's bias
    auto gelu_to = [&](float (&h)[16], int jc) {
      hopper::fence_operands(h);
      if (a.gelu_tanh)
        gelu_chunk<true>(h, b1, gbuf + (jc & 1) * 8192, rr, wg, q);
      else
        gelu_chunk<false>(h, b1, gbuf + (jc & 1) * 8192, rr, wg, q);
      hopper::fence_proxy_async();  // the chunk's generic stores before fc2's wgmma reads
      if (jc + 1 < a.chunks) bias1(jc + 1);
    };
    // one step: fc2(k) (and fc1(k+2) into hn) issued, GELU(k+1) from hg,
    // then both complete and every tile released; a barrier
    auto step = [&](float (&hn)[16], float (&hg)[16], int k) {
      const int g1 = fc1(hn);
      const int g2i = fc2(k);
      gelu_to(hg, k + 1);
      hopper::wgmma_wait<0>();
      rg.release(g1, lane);
      rg.release(g2i, lane);
      cons_barrier();  // chunk k+1's halves stored; both warpgroups' fc2(k) done
    };
    {
      bias1(0);
      const int g0 = fc1(hA);
      const int g1 = fc1(hB);
      hopper::wgmma_wait<1>();  // fc1(0) done; fc1(1) in flight
      gelu_to(hA, 0);
      hopper::wgmma_wait<0>();
      rg.release(g0, lane);
      rg.release(g1, lane);
      cons_barrier();
    }
    int k = 0;
    for (; k + 2 < a.chunks; k += 2) {
      step(hA, hB, k);      // fc1(k+2) -> A, fc2(k), GELU(k+1) from B
      step(hB, hA, k + 1);  // fc1(k+3) -> B, fc2(k+1), GELU(k+2) from A
    }
    {
      const int g2i = fc2(k);
      gelu_to(hB, k + 1);
      hopper::wgmma_wait<0>();
      rg.release(g2i, lane);
      cons_barrier();
    }
    {
      const int g2i = fc2(k + 1);
      hopper::wgmma_wait<0>();
      rg.release(g2i, lane);
    }
    hopper::fence_operands(acc2);

    // ---- out = x1 + m2 (acc + bfc2), rounded once.  Where x1 is in
    // registers, through the LN2 buffer as dense [rows, C] bf16 (its A
    // fragments are in registers) to the output in 16-byte pieces, each
    // warp 512 contiguous bytes an instruction; at CP 256, where x1 comes
    // back from L2, from the registers in bf16 pairs with no barrier (the
    // warps then do not wait for each other's loads: measured faster)
    float2 ov[NJ][2];
#pragma unroll
    for (int jn = 0; jn < NJ; ++jn) {
      const float2 bb = *reinterpret_cast<const float2*>(bfc2 + col_of(jn));
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const float2 xv = X1_REGS ? x1[jn][h2] : __ldcg(x1w + (2 * jn + h2) * NCONS + ct);
        ov[jn][h2] = make_float2(xv.x + m2[h2] * (acc2[4 * jn + 2 * h2] + bb.x),
                                 xv.y + m2[h2] * (acc2[4 * jn + 2 * h2 + 1] + bb.y));
      }
    }
    bf16* const out = a.out + p0 * a.c;
    if constexpr (X1_REGS) {
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn) {
        const int col = col_of(jn);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          if (!ok[h2] || col >= a.c) continue;
          const int e = rr[h2] * a.c + col;
          if (even) {
            st32(lnbuf + 2 * e, pack_bf16(ov[jn][h2].x, ov[jn][h2].y));
          } else {
            outs[e] = __float2bfloat16(ov[jn][h2].x);
            if (col + 1 < a.c) outs[e + 1] = __float2bfloat16(ov[jn][h2].y);
          }
        }
      }
      cons_barrier();
      const int out_elems = rows_u * a.c;
      if (a.out16 && out_elems % 8 == 0) {
        const uint4* src = reinterpret_cast<const uint4*>(outs);
        uint4* dst = reinterpret_cast<uint4*>(out);
        for (int v = ct; v < out_elems / 8; v += NCONS) dst[v] = src[v];
      } else {
        for (int e = ct; e < out_elems; e += NCONS) out[e] = outs[e];
      }
    } else {
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn) {
        const int col = col_of(jn);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          if (!ok[h2] || col >= a.c) continue;
          bf16* o = out + rr[h2] * a.c + col;
          if (even) {
            *reinterpret_cast<uint32_t*>(o) = pack_bf16(ov[jn][h2].x, ov[jn][h2].y);
          } else {
            o[0] = __float2bfloat16(ov[jn][h2].x);
            if (col + 1 < a.c) o[1] = __float2bfloat16(ov[jn][h2].y);
          }
        }
      }
    }
  }
}

template <int NC>
int launch(const Args& a, int grid, cudaStream_t stream) {
  const int smem = Layout(NC, a.stages, a.c, a.rsb, a.extra != nullptr).bytes;
  if (a.stages < 2 || a.stages > MAX_STAGES || smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = swin_tail_wg_kernel<NC>;
  static const cudaError_t attr =  // once: the most any launch takes
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, extra, out [batch, h, w, c] bf16 (extra may be null); attn [batch *
// (h / ws) * (w / ws), ws * ws, c] bf16; tiles and vec as
// kernels/fused_block.py ``pack_block_tail`` lays them out (route
// "wgmma"); scales [batch, 2] fp32 or null; x1ws an fp32 workspace of grid
// * 64 * cp at cp 256 (else null); geo = {batch, h, w, c, hidden, cp,
// chunks, ws, shift, units, grid, stages, rsb, gelu_tanh}: the launch plan
// (fused_block.tail_wg_plan decides it; this entry only checks it).
// cudaErrorInvalidValue where the shapes or the plan are outside the kernel.
extern "C" int sr_swin_tail_wg_bf16(const void* x, const void* attn, const void* extra,
                                    void* out, const void* tiles, const void* vec,
                                    const void* scales, void* x1ws, const int* geo, float eps,
                                    void* stream) {
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.attn = static_cast<const bf16*>(attn);
  a.extra = static_cast<const bf16*>(extra);
  a.out = static_cast<bf16*>(out);
  a.tiles = static_cast<const bf16*>(tiles);
  a.vec = static_cast<const float*>(vec);
  a.scales = static_cast<const float*>(scales);
  a.x1ws = static_cast<float*>(x1ws);
  const int batch = geo[0];
  a.h = geo[1];
  a.w = geo[2];
  a.c = geo[3];
  const int hidden = geo[4], cp = geo[5];
  a.chunks = geo[6];
  a.ws = geo[7];
  a.shift = geo[8];
  a.units = geo[9];
  const int grid = geo[10];
  a.stages = geo[11];
  a.rsb = geo[12];
  a.gelu_tanh = geo[13];
  a.eps = eps;
  a.rows = static_cast<long long>(batch) * a.h * a.w;
  const int half_words = (a.c + 1) / 2;
  const int rsb_want = 4 * (half_words + ((12 - half_words % 8) % 8));  // 16 (2k + 1) bytes
  if (a.c < 1 || a.c > MAX_C || cp != (a.c + 63) / 64 * 64 || hidden < 1 ||
      a.chunks != (hidden + 127) / 128 * 2 || a.ws < 1 || a.h % a.ws || a.w % a.ws || a.shift < 0 ||
      a.shift >= a.ws || static_cast<long long>(a.units) != (a.rows + ROWS - 1) / ROWS ||
      grid < 1 || grid > a.units || a.rsb != rsb_want || !aligned_to(tiles, 16) ||
      !aligned_to(vec, 16) || (scales && !aligned_to(scales, 4)) ||
      (cp == MAX_C) != (x1ws != nullptr) || (x1ws && !aligned_to(x1ws, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.rows == 0) return 0;
  a.mode = a.c % 8 == 0 && aligned_to(attn, 16)  ? COPY_BULK
         : a.c % 4 == 0 && aligned_to(attn, 8) ? COPY_8
         : a.c % 2 == 0 && aligned_to(attn, 4) ? COPY_4 : COPY_2;
  a.xe_bulk = a.c % 2 == 0 && aligned_to(x, 16) && (!extra || aligned_to(extra, 16));
  a.out16 = aligned_to(out, 16);
  if (a.c % 2 == 0 && !aligned_to(out, 4)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cp == 64) return launch<1>(a, grid, s);
  if (cp == 128) return launch<2>(a, grid, s);
  if (cp == 192) return launch<3>(a, grid, s);
  return launch<4>(a, grid, s);
}
