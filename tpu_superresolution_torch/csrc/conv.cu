// K3 + K4 — NHWC direct convolution as an implicit GEMM on Hopper's
// warpgroup tensor cores (wgmma, bf16 in, fp32 accumulate), + bias, one
// bf16 rounding.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/cab_conv.py
//           conv3x3_halo (_conv_kernel)  -> K3 (3x3, pad 1)
//           conv_halo    (_convk_kernel) -> K4 (any kh x kw, asymmetric
//                                           zero pad)
//           both through sr_conv_bf16.
// Math: y[b, oy, ox, n] = act(bias[n] + sum_{dy, dx, ci}
//         x[b, oy + dy - pad_top, ox + dx - pad_left, ci] * w[dy, dx, ci, n])
//       act the identity, or the exact-erf GELU (HAT's CAB conv1 where
//       the CAB is past K12's widths: kernels/cab_conv.py::ln_cab_convs)
//       with x read as 0 outside the image (SAME output size).  The GEMM:
//       M = b*h*w pixels, N = Cout, K = kh*kw*Cin, walked in K steps of
//       one tap and one 64-channel chunk (zero-filled past Cin).
// Operands: x stays NHWC.  The weight arrives packed (kernels/cab_conv.py
//       ``pack_conv_weight``): one [N, 64] tile per (N tile, chunk, tap),
//       K-major (row n: output channel n's 64 channels, 128 bytes) and
//       already 128B-swizzled, so one bulk copy (cp.async.bulk, completing
//       on an mbarrier) puts a tap's tile, or a chunk's run of taps, in
//       shared memory exactly as wgmma reads it.  Cout is padded to N, a
//       compiled tile width (16, 32, 48, 64, 96, 128, 192, 256); wider
//       Cout walks several N tiles.
// Bound on the H100: at the C-180 trunk's 180 -> 180 3x3 conv on 25 tiles
//       of 64^2 the GEMM is 59.7 GFLOP against 74 MB moved once, so the
//       tensor cores bound it (0.060 ms).  What the kernel pays is feeding
//       them: the operands' traffic from L2 (near 4 TB/s a card at best),
//       the gather of activations whose 360-byte pixel rows TMA cannot
//       address, and one mbarrier round trip (a few hundred cycles) per
//       ring stage, which small N (K4's 48, HAT's 96) cannot hide behind
//       its short wgmma step.
// Design: a persistent grid (one 384-thread CTA an SM walking tiles; the
//       producer loads the next tile while the consumers store this one).
//       Warpgroup 0 produces, warpgroups 1 and 2 each run wgmma m64 x N x
//       k16 on 64 output rows with fp32 accumulators in registers (N / 2 a
//       thread), keep one group in flight and release a stage (one arrive
//       a warp) once the group reading it has completed.  Operands live in
//       the K-major 128B-swizzled layout (hopper.cuh).  Two routes, chosen
//       from static shapes by ``conv_route`` (kernels/cab_conv.py):
//       - halo (K4's reconstructions, HAT's 96 -> 96, conv_before_upsample
//         and every shape but those below): a CTA computes an 8 x 16-pixel
//         block (8 x 24 with three consumer warpgroups where that pads the
//         width less: HAT's 70 -> 72, not 80); per chunk the producer
//         gathers the block's halo once with cp.async (zero-filled outside
//         the image), and every tap's A operand is a window of it, read by
//         wgmma in place (its start row need not be 1024-aligned: the
//         swizzle phase comes from the address bits).  A pixel is read
//         from L2 ~1.4 times at 3x3, ~1.9 at 5x5, not 9 or 25 times, and B
//         stages carry up to 288 / N taps each, so one barrier round trip
//         buys several taps' products.
//       - flat (3x3 convs at N 192 and 256, the C-180 trunk and SwinIR-L's
//         240, where it measured faster, and kernels too wide for the
//         halo's shared memory): a CTA computes
//         128 consecutive pixels of the flattened b*h*w index (row, image
//         and tensor ends cost only masking); each (tap, chunk) step
//         gathers its 128 x 64 A tile with cp.async from per-thread row
//         pointers and tap masks set once a tile, and B comes in the same
//         stage.
//       The producer's cp.async copies are 16, 8 or 4 bytes (the widest
//       that divides Cin; element loads for odd Cin) and arrive on the
//       stage's full barrier as they land (cp.async.mbarrier.arrive.noinc:
//       the producer never waits for its own copies); the consumers fence
//       them to the async proxy before wgmma reads them.
//       Epilogue: + bias (staged in shared memory once a CTA), bf16 into a
//       staging tile in shared memory, then one bulk copy (cp.async.bulk)
//       of each contiguous run of y where it is 16-byte aligned, else
//       coalesced stores.  Where the weight is packed on every call
//       (autograd), a small kernel packs it first, in the same call.
//       Any Cin, Cout, kh, kw and image size is taken.  Tried and dropped
//       (slower on the H100): a producer warp and two CTAs an SM for small
//       N, CTA pairs multicasting each weight stage (the pair's lockstep
//       cost more than the halved L2 traffic saved), 8 x 8 blocks with a
//       halo each, and two wgmma groups in flight.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 128;  // output pixels a CTA
constexpr int BK = 64;   // K elements a step: one 128-byte swizzled row
constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kProducers = 128;

constexpr int A_BYTES = BM * BK * 2;
constexpr int kSmemMax = 232448;  // a CTA's shared memory on the H100

template <int N>
__host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + N * BK * 2;
}

// The epilogue's staging tile, BM x N bf16, and the bias, N fp32.
template <int N>
__host__ __device__ constexpr int ebuf_bytes() {
  return BM * N * 2 + N * 4;
}

// As many ring stages as fit beside the staging tile, the barriers, the
// per-row pixel table and the slack for aligning the ring, at most 8.
template <int N>
__host__ __device__ constexpr int stages() {
  return (kSmemMax - 1024 - ebuf_bytes<N>() - 16 * 8 - BM * 8) / stage_bytes<N>() < 8
             ? (kSmemMax - 1024 - ebuf_bytes<N>() - 16 * 8 - BM * 8) / stage_bytes<N>()
             : 8;
}

template <int N>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + stages<N>() * stage_bytes<N>() + ebuf_bytes<N>() + 2 * stages<N>() * 8 + BM * 8;
}

struct Params {
  const bf16* x;
  const bf16* wp;
  const float* bias;
  bf16* y;
  int h, w, cin, cout, kw, pad_top, pad_left;
  int m_total;  // b * h * w
  int taps, chunks;
  int vec;      // A copy width in bf16: 8, 4, 2 or 1
  int y16;      // y is 16-byte aligned
  int gelu;     // the exact-erf GELU on (sum + bias) before the rounding
  int n_tiles;
  // the halo route
  int batch, tiles_x, tiles_y;  // 8 x TW-pixel blocks of an image
  int hh, hw;                   // a block's halo: (8 + kh - 1) x (TW + kw - 1) pixels
  int halo_bytes;               // one chunk's halo buffer
  int stages;                   // B ring stages
};

// One A tile (BM rows x BK channels of tap (dy, dx), chunk c0) into the
// swizzled stage at `a_s`, from the tile's pixel table `rows` (any V).
// Thread t copies V channels at a fixed offset of every (BM / CPR)-th
// row; rows past the image, halo pixels and channels past Cin are
// zero-filled.  Only the first `kvalid` channels are written (the
// consumers read no further).
template <int V>
__device__ __forceinline__ void load_a_table(const Params& p, const int2* rows, uint32_t a_s,
                                             int t, int dy, int dx, int c0, int kvalid) {
  constexpr int CPR = BK / V;  // copies a row
  constexpr int RS = kProducers / CPR;
  const int cr = (t % CPR) * V;
  if (cr >= kvalid) return;
  const bool in_c = c0 + cr < p.cin;
  const int shift = dy * p.w + dx;
#pragma unroll 8
  for (int i = 0; i < CPR; ++i) {
    const int r = t / CPR + RS * i;
    const int2 e = rows[r];
    const int yy = (e.y >> 16) + dy, xx = (e.y & 0xFFFF) + dx;
    const bool ok = in_c && static_cast<unsigned>(yy) < static_cast<unsigned>(p.h) &&
                    static_cast<unsigned>(xx) < static_cast<unsigned>(p.w);
    const bf16* src =
        ok ? p.x + static_cast<long long>(e.x + shift) * p.cin + c0 + cr : p.x;
    const uint32_t dst = a_s + hopper::sw128_offset(r, cr * 2);
    if constexpr (V == 1) {
      const unsigned short v = ok ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
    } else {
      hopper::cp_async<2 * V>(dst, src, ok ? 2 * V : 0);
    }
  }
}

// The same for V = 8 or 4 and at most 32 taps, from registers set once a
// tile: each of the thread's rows' source pointer (its pixel, channel
// offset cr) and tap mask (bit tap: the tap reads inside the image), so
// that a copy costs a test, an add and the cp.async.  The rows are RS
// apart, a multiple of 8, so all share one swizzle phase.
template <int V>
struct ARows {
  static constexpr int CPR = BK / V;
  static constexpr int RS = kProducers / CPR;
  static constexpr int NR = BM / RS;
  const bf16* ptr[NR];
  uint32_t mask[NR];

  __device__ __forceinline__ void init(const Params& p, int m0, int t) {
    const int cr = (t % CPR) * V, kh = p.taps / p.kw;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int m = m0 + t / CPR + RS * i;
      uint32_t bits = 0;
      if (m < p.m_total) {
        const int rem = m % (p.h * p.w);
        const int yy = rem / p.w - p.pad_top, xx = rem % p.w - p.pad_left;
        for (int dy = 0; dy < kh; ++dy)
          for (int dx = 0; dx < p.kw; ++dx)
            if (static_cast<unsigned>(yy + dy) < static_cast<unsigned>(p.h) &&
                static_cast<unsigned>(xx + dx) < static_cast<unsigned>(p.w))
              bits |= 1u << (dy * p.kw + dx);
      }
      mask[i] = bits;
      ptr[i] = p.x + static_cast<long long>(m) * p.cin + cr;  // read only where bits allow
    }
  }

  // step_off: (dy * W + dx) * Cin + c0 of the step's tap and chunk
  __device__ __forceinline__ void load(const Params& p, uint32_t a_s, int t, int tap,
                                       long long step_off, int c0, int kvalid) const {
    const int cr = (t % CPR) * V;
    if (cr >= kvalid) return;
    const bool in_c = c0 + cr < p.cin;
    const uint32_t dst = a_s + hopper::sw128_offset(t / CPR, cr * 2);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const bool ok = in_c && ((mask[i] >> tap) & 1u);
      hopper::cp_async<2 * V>(dst + i * RS * 128, ok ? ptr[i] + step_off : p.x, ok ? 2 * V : 0);
    }
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void producer_barrier() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // warpgroup 0 alone
}

template <int NT = 256>
__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(NT) : "memory");  // the NT consumer threads
}

// The epilogue's function of a sum: + bias, then (HAT's CAB conv1 on the
// "wide" route) the exact-erf GELU.
__device__ __forceinline__ float epilogue(float v, float b, int gelu) {
  v += b;
  return gelu ? 0.5f * v * (1.f + erff(v * 0.7071067811865476f)) : v;
}

// A consumer thread's accumulators through `epilogue`, rounded to bf16,
// into the staging tile: d[4j + {0, 1}] at element e0 + 8j + 2q (+1),
// d[4j + {2, 3}] at e1 + ...; columns from ncols on are not written.
template <int N>
__device__ __forceinline__ void write_staging(const float (&d)[N / 2], bf16* ebuf,
                                              const float* bias, int e0, int e1, int ld,
                                              int ncols, int q, int gelu) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = j * 8 + 2 * q;  // this thread's columns c, c + 1
    if (c < ncols) {
      const float b0 = bias[c];
      const bool two = c + 1 < ncols;
      const float b1 = two ? bias[c + 1] : 0.f;
      bf16* r0 = ebuf + e0 + c;
      bf16* r1 = ebuf + e1 + c;
      if (two && (ld & 1) == 0) {
        *reinterpret_cast<uint32_t*>(r0) =
            pack_bf16(epilogue(d[4 * j], b0, gelu), epilogue(d[4 * j + 1], b1, gelu));
        *reinterpret_cast<uint32_t*>(r1) =
            pack_bf16(epilogue(d[4 * j + 2], b0, gelu), epilogue(d[4 * j + 3], b1, gelu));
      } else {
        r0[0] = __float2bfloat16(epilogue(d[4 * j], b0, gelu));
        r1[0] = __float2bfloat16(epilogue(d[4 * j + 2], b0, gelu));
        if (two) {
          r0[1] = __float2bfloat16(epilogue(d[4 * j + 1], b1, gelu));
          r1[1] = __float2bfloat16(epilogue(d[4 * j + 3], b1, gelu));
        }
      }
    }
  }
}

// The epilogue of one 128 x N tile: consumer warpgroup `cw` adds the bias
// to its accumulators, rounds them to bf16 into the staging tile `ebuf`
// (row stride ld: Cout when one N tile covers Cout, so that the tile is
// y's contiguous block of rows, else N), and the block goes out by one
// bulk copy where it is 16-byte aligned, else by both warpgroups'
// coalesced stores.  Consumer thread 0 issues the bulk copy and, before
// ebuf is written again, waits until the copy has read it.
template <int N>
__device__ __forceinline__ void store_tile(const Params& p, const float (&d)[N / 2], bf16* ebuf,
                                           const float* sbias, int m0, int n0, int cw, int ct) {
  const int lane = ct & 31, q = lane & 3;
  const int r0 = cw * 64 + (ct >> 5) * 16 + (lane >> 2);  // and r0 + 8
  const int ld = p.n_tiles == 1 ? p.cout : N;
  const int ncols = min(N, p.cout - n0);
  const float* bias = p.n_tiles == 1 ? sbias : p.bias + n0;
  const bool issuer = ct == 0 && cw == 0;
  if (issuer) hopper::bulk_wait_read();
  consumer_barrier();  // the last tile's copy-out has read ebuf
  write_staging<N>(d, ebuf, bias, r0 * ld, (r0 + 8) * ld, ld, ncols, q, p.gelu);
  hopper::fence_proxy_async();  // the staging writes, before the bulk copy reads them
  consumer_barrier();
  const int rows = min(BM, p.m_total - m0);
  if (p.n_tiles == 1) {
    // one contiguous block of rows * Cout values at y + m0 * Cout (16-byte
    // aligned: m0 is a multiple of 128)
    const long long total = static_cast<long long>(rows) * p.cout;
    bf16* dst = p.y + static_cast<long long>(m0) * p.cout;
    if (p.y16 && total % 8 == 0) {
      if (issuer) {
        hopper::bulk_store(dst, hopper::smem_addr(ebuf), static_cast<uint32_t>(total * 2));
        hopper::bulk_commit();
      }
    } else {
      for (long long i = ct + 128 * cw; i < total; i += 256) dst[i] = ebuf[i];
    }
  } else {
    for (int i = ct + 128 * cw; i < rows * ncols; i += 256) {
      const int r = i / ncols, c = i - r * ncols;
      p.y[static_cast<long long>(m0 + r) * p.cout + n0 + c] = ebuf[r * ld + c];
    }
  }
}

// The flat route's warpgroup 0: fills the ring for the CTA's tiles.  VR 8
// or 4: A from per-thread row registers (ARows); VR 0: from the tile's
// pixel table, any copy width.  Each thread's copies of a step arrive on
// the stage's full barrier when they land (the producers never wait for
// their own copies); thread 0 adds B, the step's packed weight tile, by
// one bulk copy whose bytes complete the same barrier.
template <int N, int VR>
__device__ __forceinline__ void produce(const Params& p, uint32_t ring, uint32_t bars,
                                        int2* rows, int t) {
  constexpr int SB = stage_bytes<N>();
  constexpr int kStages = stages<N>();
  const int steps = p.taps * p.chunks;
  const int tiles = (p.m_total + BM - 1) / BM * p.n_tiles;
  ARows<VR == 0 ? 8 : VR> ar;
  int g = 0;  // this CTA's step count over its tiles: stage g % kStages
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / p.n_tiles * BM, n0 = tile % p.n_tiles * N;
    if constexpr (VR == 0) {
      // Each tile row's pixel: its flat index and (y, x); y far outside
      // the image for rows past the tensor, so every tap reads zeros.
      producer_barrier();  // the last tile's gathers have read the table
      const int m = m0 + t;
      int yy = -16384, xx = 0;
      if (m < p.m_total) {
        const int rem = m % (p.h * p.w);
        yy = rem / p.w;
        xx = rem % p.w;
      }
      rows[t] = make_int2(m, static_cast<int>(static_cast<unsigned>(yy) << 16) | xx);
      producer_barrier();
    } else {
      ar.init(p, m0, t);
    }
    const bf16* b_src = p.wp + static_cast<long long>(n0) * steps * BK;
    for (int s = 0; s < steps; ++s, ++g) {
      const int st = g % kStages;
      hopper::mbar_wait(bars + 8u * (kStages + st), ((g / kStages) & 1) ^ 1);  // empty
      const int tap = s / p.chunks, c0 = (s - tap * p.chunks) * BK;
      const int dy = tap / p.kw - p.pad_top, dx = tap % p.kw - p.pad_left;
      const int kvalid = min(BK, (p.cin - c0 + 15) & ~15);
      const uint32_t a_s = ring + st * SB, b_s = a_s + A_BYTES;
      if constexpr (VR == 0) {
        switch (p.vec) {
          case 8: load_a_table<8>(p, rows, a_s, t, dy, dx, c0, kvalid); break;
          case 4: load_a_table<4>(p, rows, a_s, t, dy, dx, c0, kvalid); break;
          case 2: load_a_table<2>(p, rows, a_s, t, dy, dx, c0, kvalid); break;
          default: load_a_table<1>(p, rows, a_s, t, dy, dx, c0, kvalid); break;
        }
      } else {
        ar.load(p, a_s, t, tap, static_cast<long long>(dy * p.w + dx) * p.cin + c0, c0, kvalid);
      }
      if (t == 0) {
        hopper::mbar_arrive_expect_tx(bars + 8u * st, N * 128);
        // tile (n tile, chunk, tap) of the packed weight
        hopper::bulk_copy(b_s, b_src + (c0 / BK * p.taps + tap) * N * BK, N * 128,
                          bars + 8u * st);
      }
      const uint32_t full = bars + 8u * st;
      if (VR == 0 && p.vec == 1) {
        // shared stores and copies: complete them, then arrive
        hopper::cp_async_wait_all();
        hopper::mbar_arrive(full);
      } else {
        // the barrier counts this thread's arrival once its copies land
        hopper::cp_async_arrive_noinc(full);
      }
    }
  }
}

// Persistent: CTA i takes tiles i, i + gridDim.x, ... (tile t: pixels
// (t / n_tiles) * 128.., channels (t % n_tiles) * N..); the ring's stage
// and phase run on over the CTA's tiles, so the producer loads the next
// tile while the consumers store this one.
template <int N>
__global__ void __launch_bounds__(kThreads, 1) conv_nhwc_wgmma_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int SB = stage_bytes<N>();
  constexpr int kStages = stages<N>();
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t bars = ring + kStages * SB;  // full[s], then empty[s]
  int2* rows = reinterpret_cast<int2*>(smem_raw + (bars + 16 * kStages - raw));
  bf16* ebuf = reinterpret_cast<bf16*>(smem_raw + (bars + 16 * kStages + BM * 8 - raw));
  float* sbias = reinterpret_cast<float*>(ebuf + BM * N);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // every producer thread's A copies, and thread 0's expect_tx for B
      hopper::mbar_init(full(s), kProducers + 1);
      hopper::mbar_init(empty(s), 2 * 4);      // lane 0 of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int steps = p.taps * p.chunks;  // (tap, 64-channel chunk), tap-major
  const int tiles = (p.m_total + BM - 1) / BM * p.n_tiles;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform role
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    if (p.vec == 8 && p.taps <= 32)
      produce<N, 8>(p, ring, bars, rows, tid);
    else if (p.vec == 4 && p.taps <= 32)
      produce<N, 4>(p, ring, bars, rows, tid);
    else
      produce<N, 0>(p, ring, bars, rows, tid);
  } else {
    // --------------------------------------------------------- consumers
    const int cw = wg - 1;  // rows 64 cw .. 64 cw + 63 of the tile
    const int ct = tid - 128 * wg;
    if (p.n_tiles == 1)  // read by the epilogues, after their first barrier
      for (int i = ct + 128 * cw; i < p.cout; i += 256) sbias[i] = p.bias[i];
    int g = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      float d[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
      for (int s = 0; s < steps; ++s, ++g) {
        const int st = g % kStages;
        hopper::mbar_wait(full(st), (g / kStages) & 1);
        // the producers' generic-proxy writes, visible to this thread
        // through the barrier, ordered before its wgmma's async-proxy reads
        hopper::fence_proxy_async();
        const int ksub = (min(BK, p.cin - s % p.chunks * BK) + 15) >> 4;
        const uint64_t da = hopper::desc_sw128(ring + st * SB + cw * 64 * 128);
        const uint64_t db = hopper::desc_sw128(ring + st * SB + A_BYTES);
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
          if (k < ksub) hopper::Wgmma<N>::mma(d, da + 2 * k, db + 2 * k, 1);
        hopper::wgmma_commit();
        // one group in flight: the previous step's has completed
        hopper::wgmma_wait<1>();
        if (s > 0 && lane == 0) hopper::mbar_arrive(empty((g - 1) % kStages));
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands(d);
      if (lane == 0) hopper::mbar_arrive(empty((g - 1) % kStages));
      store_tile<N>(p, d, ebuf, sbias, tile / p.n_tiles * BM, tile % p.n_tiles * N, cw, ct);
    }
    if (ct == 0 && cw == 0) hopper::bulk_wait();  // the last tile's bulk copy has landed
  }
}


// ================================================================ halo route
//
// A CTA computes an 8-row x TW-pixel block of one image with CWG = TW / 8
// consumer warpgroups (2, or 3 where a 24-pixel block wastes less of the
// image's width: 70 pads to 72, not 80), warpgroup cw taking columns
// 8 cw .. 8 cw + 7, so each of its 64 rows is one 8-pixel group of an
// image row.  For each 64-channel chunk the producer gathers the block's
// halo, (8 + kh - 1) x (TW + kw - 1) pixels, once into a swizzled buffer
// (two buffers, double-buffered over the chunks); every tap's A operand
// is then a window of that buffer, read by wgmma in place: start row
// dy * (TW + kw - 1) + dx + 8 cw, its 8-row groups one halo row apart.
// Only B, the taps' weight tiles, goes through the ring.  Each input
// pixel is read from L2 about (8 + kh - 1) (TW + kw - 1) / (8 TW) times
// (1.4 at 3x3 and TW 16, 1.9 at 5x5) instead of kh * kw times.

constexpr int TH = 8;  // a halo-route block's rows

template <int TW>
__device__ __forceinline__ void block_origin(const Params& p, int blk, int& b, int& y0,
                                             int& x0) {
  const int per_img = p.tiles_y * p.tiles_x;
  b = blk / per_img;
  const int rem = blk - b * per_img;
  y0 = rem / p.tiles_x * TH;
  x0 = rem % p.tiles_x * TW;
}

// One chunk's halo into the swizzled buffer `hbuf` (halo pixel i is row
// i): V channels a copy, zero outside the image and past Cin; only the
// first `kvalid` channels.  Thread t copies channel offset (t % CPP) V of
// every (128 / CPP)-th halo pixel, walking (row, column) incrementally.
template <int V>
__device__ __forceinline__ void load_halo(const Params& p, uint32_t hbuf, int t, int b, int y0,
                                          int x0, int c0, int kvalid) {
  constexpr int CPP = BK / V;          // copies a pixel
  constexpr int PS = kProducers / CPP;  // pixels between a thread's copies
  const int cr = (t % CPP) * V;
  if (cr >= kvalid) return;
  const bool in_c = c0 + cr < p.cin;
  const int npx = p.hh * p.hw;
  int px = t / CPP, hy = px / p.hw, hx = px - hy * p.hw;
  const bf16* base = p.x + static_cast<long long>(b) * p.h * p.w * p.cin + c0 + cr;
  for (; px < npx; px += PS) {
    const int yy = y0 - p.pad_top + hy, xx = x0 - p.pad_left + hx;
    const bool ok = in_c && static_cast<unsigned>(yy) < static_cast<unsigned>(p.h) &&
                    static_cast<unsigned>(xx) < static_cast<unsigned>(p.w);
    const bf16* src = ok ? base + (static_cast<long long>(yy) * p.w + xx) * p.cin : p.x;
    const uint32_t dst = hbuf + hopper::sw128_offset(px, cr * 2);
    if constexpr (V == 1) {
      const unsigned short v = ok ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
    } else {
      hopper::cp_async<2 * V>(dst, src, ok ? 2 * V : 0);
    }
    hx += PS;  // PS <= 16, p.hw >= 8: at most two wraps
    while (hx >= p.hw) {
      hx -= p.hw;
      ++hy;
    }
  }
}

// The halo route's epilogue: as store_tile, for an 8 x TW-pixel block
// (ebuf row TW ty + tx); each image row's run of nx * Cout values goes
// out by one bulk copy where it is 16-byte aligned.
template <int N, int CWG>
__device__ __forceinline__ void store_block(const Params& p, const float (&d)[N / 2], bf16* ebuf,
                                            const float* sbias, int blk, int n0, int cw,
                                            int ct) {
  constexpr int TW = 8 * CWG, NT = 128 * CWG;
  const int lane = ct & 31, q = lane & 3;
  const int i0 = (ct >> 5) * 16 + (lane >> 2);  // the warpgroup's rows i0, i0 + 8
  const int ld = p.n_tiles == 1 ? p.cout : N;
  const int ncols = min(N, p.cout - n0);
  const float* bias = p.n_tiles == 1 ? sbias : p.bias + n0;
  const bool issuer = ct == 0 && cw == 0;
  // warpgroup row i: block row i / 8, column 8 cw + i % 8
  const int e0 = TW * (i0 >> 3) + 8 * cw + (i0 & 7), e1 = e0 + TW;
  if (issuer) hopper::bulk_wait_read();
  consumer_barrier<NT>();  // the last block's copy-out has read ebuf
  write_staging<N>(d, ebuf, bias, e0 * ld, e1 * ld, ld, ncols, q, p.gelu);
  hopper::fence_proxy_async();  // the staging writes, before the bulk copies read them
  consumer_barrier<NT>();
  int b, y0, x0;
  block_origin<TW>(p, blk, b, y0, x0);
  const int nx = min(TW, p.w - x0), ny = min(TH, p.h - y0);
  const int u = ct + 128 * cw;  // 0 .. NT - 1
  for (int ty = 0; ty < ny; ++ty) {
    const long long pix = (static_cast<long long>(b) * p.h + y0 + ty) * p.w + x0;
    const bf16* src = ebuf + ty * TW * ld;
    if (p.n_tiles == 1) {
      // the row's nx pixels are one contiguous run of nx * Cout values
      const int len = nx * p.cout;
      bf16* dst = p.y + pix * p.cout;
      if (p.y16 && (pix * p.cout) % 8 == 0 && len % 8 == 0 && (ty * TW * ld) % 8 == 0) {
        if (issuer) hopper::bulk_store(dst, hopper::smem_addr(src), len * 2);
      } else {
        for (int i = u; i < len; i += NT) dst[i] = src[i];
      }
    } else {
      for (int i = u; i < nx * ncols; i += NT) {
        const int px = i / ncols, c = i - px * ncols;
        p.y[(pix + px) * p.cout + n0 + c] = src[px * ld + c];
      }
    }
  }
  if (issuer) hopper::bulk_commit();
}

// Taps a B stage carries: about 36 KB of weight tiles (18 at N 16, 6 at
// 48, 3 at 96, 1 from 192 up), so that small N pays one barrier round
// trip for several taps' products (measured on the H100: 36 KB beat 24
// and 48 at HAT's 96 -> 96 and K4's 64 -> 48).
template <int N>
__host__ __device__ constexpr int taps_per_stage() {
  return 288 / N > 1 ? 288 / N : 1;
}

template <int N, int CWG>
__global__ void __launch_bounds__(128 * (CWG + 1), 1) conv_nhwc_halo_kernel(const Params p) {
  constexpr int T = taps_per_stage<N>();
  constexpr int TW = 8 * CWG;  // block width; consumer threads 128 CWG
  constexpr int TILE = N * BK * 2;  // one tap's B tile, bytes
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t halo0 = (raw + 1023u) & ~1023u;
  const uint32_t bring = halo0 + 2 * p.halo_bytes;  // B stages, T * TILE bytes each
  const int S = p.stages;
  const uint32_t bars = bring + S * T * TILE;  // halo full[2], empty[2], B full[S], empty[S]
  bf16* ebuf = reinterpret_cast<bf16*>(smem_raw + (bars + (4 + 2 * S) * 8 - raw));
  float* sbias = reinterpret_cast<float*>(ebuf + 64 * CWG * N);
  auto halo_full = [&](int i) { return bars + 8u * i; };
  auto halo_empty = [&](int i) { return bars + 8u * (2 + i); };
  auto b_full = [&](int s) { return bars + 8u * (4 + s); };
  auto b_empty = [&](int s) { return bars + 8u * (4 + S + s); };

  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(halo_full(i), kProducers);  // every producer thread's copies
      hopper::mbar_init(halo_empty(i), 4 * CWG);    // lane 0 of each consumer warp
    }
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(b_full(s), 1);  // thread 0's expect_tx; the bytes complete it
      hopper::mbar_init(b_empty(s), 4 * CWG);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int spc = (p.taps + T - 1) / T;  // B stages a chunk
  const int tiles = p.batch * p.tiles_y * p.tiles_x * p.n_tiles;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform role
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    const int t = tid;
    int g = 0, hc = 0;  // B stages (thread 0's count) and halo chunks so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int blk = tile / p.n_tiles, nt = tile - blk * p.n_tiles;
      int b, y0, x0;
      block_origin<TW>(p, blk, b, y0, x0);
      for (int c = 0; c < p.chunks; ++c, ++hc) {
        const int hb = hc & 1, c0 = c * BK;
        const int kvalid = min(BK, (p.cin - c0 + 15) & ~15);
        hopper::mbar_wait(halo_empty(hb), ((hc >> 1) & 1) ^ 1);
        const uint32_t hbuf = halo0 + hb * p.halo_bytes;
        switch (p.vec) {
          case 8: load_halo<8>(p, hbuf, t, b, y0, x0, c0, kvalid); break;
          case 4: load_halo<4>(p, hbuf, t, b, y0, x0, c0, kvalid); break;
          case 2: load_halo<2>(p, hbuf, t, b, y0, x0, c0, kvalid); break;
          default: load_halo<1>(p, hbuf, t, b, y0, x0, c0, kvalid); break;
        }
        if (p.vec == 1) {
          hopper::cp_async_wait_all();  // (none: element loads and shared stores)
          hopper::mbar_arrive(halo_full(hb));
        } else {
          hopper::cp_async_arrive_noinc(halo_full(hb));
        }
        if (t == 0) {
          // B: the chunk's tap tiles are contiguous in the packed weight
          // (tile (n tile, chunk, tap)); up to T of them a bulk copy
          const bf16* src = p.wp + (static_cast<long long>(nt * p.chunks + c) * p.taps) * N * BK;
          for (int j = 0; j < spc; ++j, ++g) {
            const int st = g % S, ntaps = min(T, p.taps - j * T);
            hopper::mbar_wait(b_empty(st), ((g / S) & 1) ^ 1);
            hopper::mbar_arrive_expect_tx(b_full(st), ntaps * TILE);
            hopper::bulk_copy(bring + st * T * TILE, src + j * T * N * BK, ntaps * TILE,
                              b_full(st));
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    const int cw = wg - 1;  // block columns 8 cw .. 8 cw + 7
    const int ct = tid - 128 * wg;
    if (p.n_tiles == 1)  // read by the epilogues, after their first barrier
      for (int i = ct + 128 * cw; i < p.cout; i += 128 * CWG) sbias[i] = p.bias[i];
    const uint32_t group_bytes = p.hw * 128;  // one halo row
    int g = 0, hc = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      float d[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
      for (int c = 0; c < p.chunks; ++c, ++hc) {
        const int hb = hc & 1;
        const int ksub = (min(BK, p.cin - c * BK) + 15) >> 4;
        hopper::mbar_wait(halo_full(hb), (hc >> 1) & 1);
        // the producers' generic-proxy writes of the halo, visible to this
        // thread through the barrier, ordered before its wgmma's reads
        hopper::fence_proxy_async();
        const uint32_t hbuf = halo0 + hb * p.halo_bytes + 8 * cw * 128;
        for (int j = 0; j < spc; ++j, ++g) {
          const int st = g % S, tap0 = j * T, ntaps = min(T, p.taps - tap0);
          hopper::mbar_wait(b_full(st), (g / S) & 1);
          hopper::wgmma_fence();
          for (int i = 0; i < ntaps; ++i) {
            const int dy = (tap0 + i) / p.kw, dx = tap0 + i - dy * p.kw;
            const uint64_t da = hopper::desc_sw128(hbuf + (dy * p.hw + dx) * 128, group_bytes);
            const uint64_t db = hopper::desc_sw128(bring + st * T * TILE + i * TILE);
#pragma unroll
            for (int k = 0; k < BK / 16; ++k)
              if (k < ksub) hopper::Wgmma<N>::mma(d, da + 2 * k, db + 2 * k, 1);
          }
          hopper::wgmma_commit();
          // one group in flight: the previous stage's has completed
          hopper::wgmma_wait<1>();
          if (j > 0 && lane == 0) hopper::mbar_arrive(b_empty((g - 1) % S));
        }
        // the chunk's last group done: its B stage and the halo are free
        hopper::wgmma_wait<0>();
        if (lane == 0) {
          hopper::mbar_arrive(b_empty((g - 1) % S));
          hopper::mbar_arrive(halo_empty(hb));
        }
      }
      hopper::fence_operands(d);
      const int blk = tile / p.n_tiles;
      store_block<N, CWG>(p, d, ebuf, sbias, blk, (tile - blk * p.n_tiles) * N, cw, ct);
    }
    if (ct == 0 && cw == 0) hopper::bulk_wait();  // the last block's bulk copies have landed
  }
}

constexpr int kMaxDevices = 64;

// The current device's SM count (looked up once a device), after setting
// `kernel`'s dynamic shared memory limit to kSmemMax (once a device and
// kernel: `done` is the kernel's own flags).
int prepare(const void* kernel, bool* done, int* sms) {
  static int sm_counts[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    done[dev] = true;
  }
  if (sm_counts[dev] == 0) {
    e = cudaDeviceGetAttribute(&sm_counts[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *sms = sm_counts[dev];
  return 0;
}

// The halo route's shared memory: two halo buffers, the B ring, the
// barriers and the staging tile; `stages` B stages (at most 8; 0 when
// fewer than 2 fit, and the route does not take the shape).
// One chunk's halo buffer for a TW-wide block, 1024-byte aligned.
__host__ __device__ constexpr int halo_buffer_bytes(int kh, int kw, int tw) {
  return ((TH + kh - 1) * (tw + kw - 1) * 128 + 1023) / 1024 * 1024;
}

// The halo route's B ring stages beside two halo buffers, the staging tile
// (64 CWG rows) and the barriers: at most 8, 0 when fewer than 2 fit.
template <int N>
int halo_stages(int kh, int kw, int cwg) {
  const int fixed = 1024 + 2 * halo_buffer_bytes(kh, kw, 8 * cwg) + 64 * cwg * N * 2 + N * 4 + 4 * 8;
  const int s = (kSmemMax - fixed) / (taps_per_stage<N>() * N * 128 + 16);
  return s < 2 ? 0 : (s > 8 ? 8 : s);
}

template <int N>
int launch_flat(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<N>();
  static bool done[kMaxDevices] = {};
  int sms = 0;
  const int e = prepare(reinterpret_cast<const void*>(conv_nhwc_wgmma_kernel<N>), done, &sms);
  if (e != 0) return e;
  const long long tiles = (static_cast<long long>(p.m_total) + BM - 1) / BM * p.n_tiles;
  conv_nhwc_wgmma_kernel<N><<<static_cast<unsigned int>(tiles < sms ? tiles : sms), kThreads,
                              bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int CWG>
int launch_halo_blocks(Params p, int kh, cudaStream_t stream) {
  constexpr int TW = 8 * CWG;
  p.stages = halo_stages<N>(kh, p.kw, CWG);
  if (p.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  p.halo_bytes = halo_buffer_bytes(kh, p.kw, TW);
  p.hh = TH + kh - 1;
  p.hw = TW + p.kw - 1;
  p.tiles_y = (p.h + TH - 1) / TH;
  p.tiles_x = (p.w + TW - 1) / TW;
  const int bytes = 1024 + 2 * p.halo_bytes + p.stages * (taps_per_stage<N>() * N * 128 + 16) +
                    4 * 8 + 64 * CWG * N * 2 + N * 4;
  static bool done[kMaxDevices] = {};
  int sms = 0;
  const int e = prepare(reinterpret_cast<const void*>(conv_nhwc_halo_kernel<N, CWG>), done, &sms);
  if (e != 0) return e;
  const long long tiles = static_cast<long long>(p.batch) * p.tiles_y * p.tiles_x * p.n_tiles;
  conv_nhwc_halo_kernel<N, CWG><<<static_cast<unsigned int>(tiles < sms ? tiles : sms),
                                  128 * (CWG + 1), bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// 24-pixel blocks (three consumer warpgroups: 512 threads, so N <= 128
// for their registers) where they pad the image's width less than
// 16-pixel blocks do and their shared memory fits; else 16-pixel blocks.
// kernels/cab_conv.py ``halo_block_width`` mirrors this choice.
template <int N>
int launch_halo(const Params& p, int kh, cudaStream_t stream) {
  if constexpr (N <= 128) {
    if ((p.w + 23) / 24 * 24 < (p.w + 15) / 16 * 16 && halo_stages<N>(kh, p.kw, 3) > 0)
      return launch_halo_blocks<N, 3>(p, kh, stream);
  }
  return launch_halo_blocks<N, 2>(p, kh, stream);
}

template <int N>
int launch(const Params& p, int route, int kh, cudaStream_t stream) {
  return route == 1 ? launch_halo<N>(p, kh, stream) : launch_flat<N>(p, stream);
}

// The weight packing of kernels/cab_conv.py ``pack_conv_weight`` on the
// card (the call that packs on every launch, under autograd): one thread a
// 16-byte chunk of wp[n tile][chunk * taps + tap][n][64], swizzled (chunk
// jp of row n holds channels 64 chunk + 8 (jp ^ n % 8) .. + 7), from the
// [kh, kw, Cin, Cout] kernel; zero past Cin and Cout.
__global__ void pack_weight_kernel(const bf16* __restrict__ k, bf16* __restrict__ wp, int taps,
                                   int cin, int cout, int chunks, int n_tile, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int jp = static_cast<int>(i & 7);
  long long r = i >> 3;
  const int n = static_cast<int>(r % n_tile);
  r /= n_tile;
  const int step = static_cast<int>(r % (chunks * taps));
  const int nt = static_cast<int>(r / (chunks * taps));
  const int c = step / taps, tap = step - c * taps;
  const int co = nt * n_tile + n, ci0 = c * BK + 8 * (jp ^ (n & 7));
  __align__(16) bf16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = (co < cout && ci0 + e < cin)
               ? k[(static_cast<long long>(tap) * cin + ci0 + e) * cout + co]
               : __float2bfloat16(0.f);
  reinterpret_cast<uint4*>(wp)[i] = *reinterpret_cast<const uint4*>(v);
}

}  // namespace

// x [batch, h, w, cin] bf16 NHWC; wp the packed weight [n_tiles, chunks *
// kh * kw, n_tile, 64] bf16 (chunks = ceil(cin / 64)); bias [cout] fp32;
// y [batch, h, w, cout] bf16.  n_tile: a compiled N (16, 32, 48, 64, 96,
// 128, 192, 256); vec: the A copy width in bf16 (8, 4, 2 or 1; it must
// divide cin and x must be aligned to it); route: 1 halo, 0 flat; gelu:
// 1 applies the exact-erf GELU after the bias (before the rounding).  kernel:
// null, or the [kh, kw, cin, cout] bf16 weight to pack into wp first.
// Returns cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int sr_conv_bf16(const void* x, const void* wp, const void* bias, void* y, int batch,
                            int h, int wd, int cin, int cout, int kh, int kw, int pad_top,
                            int pad_left, int n_tile, int n_tiles, int vec, int route,
                            int gelu, const void* kernel, void* stream) {
  const long long m_total = static_cast<long long>(batch) * h * wd;
  if (m_total == 0 || cout == 0) return 0;
  const bool vec_ok = (vec == 8 || vec == 4 || vec == 2 || vec == 1) && cin % vec == 0 &&
                      aligned_to(x, 2 * vec);
  if (m_total > (1LL << 30) || n_tiles <= 0 || (route != 0 && route != 1) || h >= 16384 ||
      wd >= 65536 || cin <= 0 || kh <= 0 || kw <= 0 || !vec_ok ||
      static_cast<long long>(n_tile) * n_tiles < cout || !aligned_to(wp, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.wp = static_cast<const bf16*>(wp);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<bf16*>(y);
  p.h = h;
  p.w = wd;
  p.cin = cin;
  p.cout = cout;
  p.kw = kw;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  p.m_total = static_cast<int>(m_total);
  p.taps = kh * kw;
  p.chunks = (cin + BK - 1) / BK;
  p.vec = vec;
  p.n_tiles = n_tiles;
  p.batch = batch;
  p.y16 = aligned_to(y, 16);
  p.gelu = gelu;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel != nullptr) {
    // pack the [kh, kw, Cin, Cout] kernel into wp first (same stream)
    const long long total = static_cast<long long>(n_tiles) * p.chunks * p.taps * n_tile * 8;
    pack_weight_kernel<<<static_cast<unsigned int>((total + 255) / 256), 256, 0, s>>>(
        static_cast<const bf16*>(kernel), const_cast<bf16*>(p.wp), p.taps, cin, cout, p.chunks,
        n_tile, total);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  switch (n_tile) {
    case 16: return launch<16>(p, route, kh, s);
    case 32: return launch<32>(p, route, kh, s);
    case 48: return launch<48>(p, route, kh, s);
    case 64: return launch<64>(p, route, kh, s);
    case 96: return launch<96>(p, route, kh, s);
    case 128: return launch<128>(p, route, kh, s);
    case 192: return launch<192>(p, route, kh, s);
    case 256: return launch<256>(p, route, kh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

