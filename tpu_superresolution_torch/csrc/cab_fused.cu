// K12 — HAT's CAB front in one pass: LayerNorm -> conv3x3 (C -> Cmid)
// -> exact GELU -> conv3x3 (Cmid -> C), NHWC, on Hopper's wgmma.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/cab_conv.py
//           fused_ln_cab_convs -> _forward -> _kernel (pallas_call at
//           :209); oracle _reference (:153).
// Math: y1 = gelu_erf(conv3x3(LN(x)) + c1), y = conv3x3(y1) + c2, both
//       convs SAME with zero padding: LN's output is zero outside the
//       image, and so is conv2's input (cab_conv.py:143-148: conv1 on the
//       halo rows past the border is not conv2's padding).  LN uses fp32
//       fast-variance statistics (E[x^2] - E[x]^2 clamped at 0) and
//       rounds to bf16; GEMM operands bf16 with fp32 accumulation; y1
//       rounds to bf16 once, after the GELU.  The SE gate stays outside,
//       as in the JAX package.
// Blocks: a persistent grid (one 384-thread CTA an SM) walks 14 x 14
//       output blocks.  A block's conv1 runs on the 16 x 16 pixels around
//       it (four wgmma m64 tiles of 8 x 8 pixels, none wasted) and its
//       conv2 on 2 x 2 tiles of 8 x 8 (196 of 256 rows used).  Operands
//       live in csrc/conv.cu's halo layout: a pixel is one 128-byte row
//       of 64 channels, 128B-swizzled; a tap's A operand is a window of a
//       halo buffer read in place (start at the tap's pixel, 8-pixel core
//       matrices one halo row apart), so no operand is copied per tap.
// Design: two launches.  ln_stats_kernel computes every pixel's LN
//       statistics (128 pixels' rows a block, copied to shared memory by
//       16-byte loads, a thread a row) into a workspace: in
//       the fused kernel's producer the statistics of a halo's 324 pixels
//       cost ~1.6x the reads and a chain of warp reductions a pixel, which
//       measured slower than the whole pass.  The fused kernel (416
//       threads): warpgroup 0 reads the halo's statistics, then, per
//       64-channel chunk, takes the raw chunk by cp.async (8 bytes a copy,
//       zero outside the image and past C, all in flight at once) into one
//       of three halo buffers and normalise it in place, swizzled, the
//       buffers a ring of items: a block's chunks, then its y1 (a buffer
//       the producer hands over unwritten), so that the next block's
//       chunks load while this block's conv2 runs.  Warp 12 feeds the
//       packed weights (kernels/cab_conv.py ``pack_cab``: one
//       [N, 64] 128B-swizzled tile a (chunk or pass, tap), bulk-copied) in
//       runs of taps through a ring of stages under mbarriers: both 3x3
//       weights (2 x 221 KB at C 180) do not fit beside a block, so they
//       stream, as K3's do.  Warpgroups 1 and 2 consume, each one row of
//       8 x 8 tiles: conv1 as wgmma m64 x N1 x k16 (N1 = Cmid rounded up
//       to 16, 32, 64 or 128) over 9 taps x the chunks; + c1, GELU in
//       registers, zeroed outside the image, bf16 into the y1 items (the
//       16 x 16 pixels in the same swizzled layout, an item a 64-channel
//       chunk of Cmid: two at Cmid 65-128); then conv2 as wgmma m64 x N2
//       x k16 over 9 taps a y1 chunk, in passes of N2 (48, 64 or 96)
//       output channels, + c2; each warp stages 8 pixels' outputs and
//       stores each pixel's run of channels whole.  At N1 128 a block's
//       items are its C chunks and two y1 items; the three slots still
//       hold them (the next block's first chunk loads into the third slot
//       while conv2 reads both y1 items).
//       Measured on the H100 (clock64 timelines of one CTA): the first
//       producer, three warps issuing dependent shared-memory round trips,
//       took ~20K cycles a chunk and bounded the kernel; its loads are now
//       plain shared accesses eight pixels a step, the next chunk's copies
//       in flight meanwhile.
// Bound on the H100: HAT-SRx4's CAB (C 180 -> 60 -> 180) does 388,800
//       FLOP a pixel against 4 bytes of x in and out: 39.8 GFLOP on the
//       bench batch [25,64,64,180], 0.040 ms at the bf16 peak, vs 73.7 MB
//       (0.022 ms): compute-bound; HAT's (96 -> 32 -> 96) 13.5 GFLOP vs
//       47.0 MB: even.  The 14 x 14 blocks do 1.31x the products (conv2's
//       unused rows) and feed both weights from L2 once a block.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int OB = 14;             // output block side
constexpr int HS = 18;             // halo side: the input halo and the y1 buffer
constexpr int HPX = HS * HS;       // 324 pixel rows
constexpr int HBUF = (HPX * 128 + 1023) / 1024 * 1024;  // one 64-channel chunk buffer
constexpr int kThreads = 416;    // warpgroup 0: LN; 1, 2: consumers; warp 12: the weights
// At N1 128 conv1's accumulators alone take 128 registers a consumer
// thread, all 416 threads may have (an SM sub-partition's 16K registers
// over its four warps): there the weights get a whole warpgroup (512
// threads) and setmaxnreg moves registers to the consumers,
// 32 x (120 + 2 x 184 + 24) = 16384 a sub-partition.
template <int N1>
__host__ __device__ constexpr int threads_of() { return N1 > 64 ? 512 : kThreads; }
constexpr int kLnRegs = 120, kConsumerRegs = 184, kFeederRegs = 24;
constexpr int kLnThreads = 128;
constexpr int kSmemMax = 232448;
constexpr int kStageBytes = 24576;  // a weight stage: a run of taps' tiles
constexpr int kMaxStages = 4;
constexpr int kSlots = 3;  // halo buffers: a ring of a block's LN chunks and its y1 chunks
constexpr int MAX_C = 256;
constexpr int MAX_N1 = 128;  // Cmid <= 128: y1 in one or two 64-channel chunks
constexpr int MAX_SC2 = 384;  // conv2's padded bias: passes * N2 <= 288 at C <= 256

struct Params {
  const bf16* x;
  const float2* stats;  // [batch * h * w] (mean, rstd): ln_stats_kernel's
  const float* g;
  const float* b;
  const bf16* w1;   // [chunks, 9, N1, 64] swizzled
  const float* c1;  // [N1]
  const bf16* w2;   // [passes, N1 / 64 or 1, 9, N2, 64] swizzled: a pass's y1 chunks
  const float* c2;  // [passes * N2]
  bf16* y;
  int batch, h, w, c, cmid, chunks, passes;
  int tiles_y, tiles_x;
  int stages;
  int vec_in;   // 4: x read 4 channels (8 bytes) at a time (C % 4 == 0), else 1
  int vec_out;  // bytes a store piece: 16 (C % 8 == 0), 8 (C % 4 == 0), 4 (C even) or 2
};

// Taps a weight stage carries: as many of a chunk's or pass's 9 as fit.
// The feed is latency-bound (a block's 180-432 KB of weights from L2), so
// the ring is four small stages, three copies in flight, rather than two
// large ones.
template <int N>
__host__ __device__ constexpr int taps_per_stage() {
  return kStageBytes / (N * 128) < 9 ? kStageBytes / (N * 128) : 9;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

__device__ __forceinline__ void block_origin(const Params& p, int blk, int& img, int& oy0,
                                             int& ox0) {
  const int per = p.tiles_y * p.tiles_x;
  img = blk / per;
  const int rem = blk - img * per;
  oy0 = rem / p.tiles_x * OB;
  ox0 = rem % p.tiles_x * OB;
}

__device__ __forceinline__ void ln_barrier() {
  asm volatile("bar.sync 3, 128;\n" ::: "memory");  // the LN warpgroup
}

__device__ __forceinline__ void consumers_barrier() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both consumer warpgroups
}

// The weight runs of one block, in the consumers' order: conv1's chunks
// (each 9 taps in runs of T1), then conv2's passes (each y1 chunk's 9
// taps in runs of T2).
template <int N1, int N2>
struct Runs {
  static constexpr int T1 = taps_per_stage<N1>(), T2 = taps_per_stage<N2>();
  static constexpr int R1 = (9 + T1 - 1) / T1, R2 = (9 + T2 - 1) / T2;  // runs a chunk / pass
  static constexpr int Y1 = N1 > 64 ? 2 : 1;  // y1 chunks (halo items) of a block
};

template <int N1, int N2>
__global__ void __launch_bounds__(threads_of<N1>(), 1) cab_wgmma_kernel(const Params p) {
  constexpr int NT = threads_of<N1>();
  using R = Runs<N1, N2>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  // kSlots buffers of 18 x 18 pixel rows, a ring of items: a block's LN
  // chunks, then its y1 (written by the consumers)
  const uint32_t halo0 = (raw + 1023u) & ~1023u;
  const uint32_t ring = halo0 + kSlots * HBUF;
  const int S = p.stages;
  const uint32_t bars = ring + S * kStageBytes;  // halo full[2], empty[2], w full[S], empty[S]
  float2* stats =
      reinterpret_cast<float2*>(smem_raw + (bars + (2 * kSlots + 2 * kMaxStages) * 8 - raw));
  float* sg = reinterpret_cast<float*>(stats + HPX);
  float* sb = sg + MAX_C;
  float* sc1 = sb + MAX_C;
  float* sc2 = sc1 + MAX_N1;
  // after sc2: each consumer warp's output staging, 8 pixels x (N2 + 8) bf16
  const int cwarp = (threadIdx.x >> 5) - 4;  // consumer warp 0..7 (producer warps: < 0)
  bf16* wstage = reinterpret_cast<bf16*>(sc2 + MAX_SC2) + max(cwarp, 0) * 8 * (N2 + 8);
  auto halo_full = [&](int i) { return bars + 8u * i; };
  auto halo_empty = [&](int i) { return bars + 8u * (kSlots + i); };
  auto w_full = [&](int s) { return bars + 8u * (2 * kSlots + s); };
  auto w_empty = [&](int s) { return bars + 8u * (2 * kSlots + kMaxStages + s); };
  // item hc of the halo ring: slot hc % kSlots, phase (hc / kSlots) & 1
  auto slot = [](int hc) { return hc % kSlots; };
  auto phase = [](int hc) { return (hc / kSlots) & 1; };

  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < p.c; i += NT) {
    sg[i] = p.g[i];
    sb[i] = p.b[i];
  }
  for (int i = tid; i < N1; i += NT) sc1[i] = p.c1[i];
  for (int i = tid; i < p.passes * N2; i += NT) sc2[i] = p.c2[i];
  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) {
      hopper::mbar_init(halo_full(i), kLnThreads);
      hopper::mbar_init(halo_empty(i), 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(w_full(s), 1);      // the feeder's expect_tx; the bytes complete it
      hopper::mbar_init(w_empty(s), 8);
    }
    hopper::mbar_init_fence();
  }
  hopper::fence_proxy_async();
  __syncthreads();

  const int blocks = p.batch * p.tiles_y * p.tiles_x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform role
  if (wg == 3) {
    // --------------------------------------------------- weight feeder
    if constexpr (NT > kThreads)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kFeederRegs));
    if (tid != 3 * 128) return;
    int g = 0;
    for (int blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
      for (int part = 0; part < 2; ++part) {
        const int reps = part == 0 ? p.chunks : p.passes * R::Y1;
        const int T = part == 0 ? R::T1 : R::T2, nr = part == 0 ? R::R1 : R::R2;
        const int tile = (part == 0 ? N1 : N2) * 128;
        const bf16* src = part == 0 ? p.w1 : p.w2;
        for (int rep = 0; rep < reps; ++rep)
          for (int r = 0; r < nr; ++r, ++g) {
            const int st = g % S, tap0 = r * T, ntaps = min(T, 9 - tap0);
            hopper::mbar_wait(w_empty(st), ((g / S) & 1) ^ 1);
            hopper::mbar_arrive_expect_tx(w_full(st), ntaps * tile);
            hopper::bulk_copy(ring + st * kStageBytes,
                              src + (static_cast<long long>(rep) * 9 + tap0) * (tile / 2),
                              ntaps * tile, w_full(st));
          }
      }
    }
    return;
  }
  if (wg == 0) {
    if constexpr (NT > kThreads)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLnRegs));
    // ------------------------------------------------------ LN producer
    const int t = tid;  // 0..127
    int hc = 0;
    for (int blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
      int img, oy0, ox0;
      block_origin(p, blk, img, oy0, ox0);
      const bf16* xi = p.x + static_cast<long long>(img) * p.h * p.w * p.c;
      ln_barrier();  // the last block's chunks have read the statistics
      // each halo pixel's mean and rstd (ln_stats_kernel's, read from
      // device memory; rstd -1 outside the image)
      for (int px = t; px < HPX; px += kLnThreads) {
        const int yy = oy0 - 2 + px / HS, xx = ox0 - 2 + px % HS;
        stats[px] = yy >= 0 && yy < p.h && xx >= 0 && xx < p.w
                        ? __ldg(p.stats + (static_cast<long long>(img) * p.h + yy) * p.w + xx)
                        : make_float2(0.f, -1.f);
      }
      ln_barrier();
      if (p.vec_in == 4) {
        // each chunk's raw x by cp.async (8 bytes, zero-filled outside the
        // image and past C; no registers held, so every piece is in flight
        // at once), the next chunk's copies issued before this chunk's LN
        // in place.  A thread's pieces keep 4 fixed channels (128 threads,
        // 16 pieces a pixel), so its g and b sit in registers.
        const int k = 4 * (t & 15), px0 = t >> 4, base = hc;  // chunk ch is item base + ch
        constexpr int kStep = kLnThreads / 16;                // pixels a pass of the threads
        constexpr int kPx = (HPX + kStep - 1) / kStep;       // a thread's pixels: px0 + 8 i
        static_assert(kPx <= 64, "a bit a pixel");
        // which of the thread's pixels lie inside the image (bit i: px0 + 8 i)
        uint64_t inside = 0;
#pragma unroll
        for (int i = 0; i < kPx; ++i)
          if (px0 + kStep * i < HPX && stats[px0 + kStep * i].y >= 0.f) inside |= 1ull << i;
        auto issue = [&](int ch) {
          const uint32_t hbuf = halo0 + slot(base + ch) * HBUF;
          hopper::mbar_wait(halo_empty(slot(base + ch)), phase(base + ch) ^ 1);
          const int ci = ch * 64 + k;
#pragma unroll 8
          for (int i = 0; i < kPx; ++i) {
            const int px = px0 + kStep * i;
            if (px >= HPX) break;
            const int yy = oy0 - 2 + px / HS, xx = ox0 - 2 + px % HS;
            const bool ok = ((inside >> i) & 1) && ci < p.c;
            const bf16* src = ok ? xi + (static_cast<long long>(yy) * p.w + xx) * p.c + ci : p.x;
            hopper::cp_async<8>(hbuf + hopper::sw128_offset(px, 2 * k), src, ok ? 8 : 0);
          }
          hopper::cp_async_commit();
        };
        issue(0);
        for (int ch = 0; ch < p.chunks; ++ch) {
          if (ch + 1 < p.chunks) {
            issue(ch + 1);
            hopper::cp_async_wait_group<1>();
          } else {
            hopper::cp_async_wait_group<0>();
          }
          ln_barrier();  // every thread's pieces of this chunk have landed
          uint8_t* hbuf = smem_raw + (halo0 + slot(base + ch) * HBUF - raw);
          const int ci = ch * 64 + k;
          const bool in_c = ci < p.c;
          const float4 gg = in_c ? *reinterpret_cast<const float4*>(sg + ci) : float4{};
          const float4 bb = in_c ? *reinterpret_cast<const float4*>(sb + ci) : float4{};
          // plain shared loads and stores, eight pixels a step: the compiler
          // overlaps their latencies
#pragma unroll 8
          for (int i = 0; i < kPx; ++i) {
            const int px = px0 + kStep * i;
            if (px >= HPX) break;
            uint2* at = reinterpret_cast<uint2*>(hbuf + hopper::sw128_offset(px, 2 * k));
            const uint2 r = *at;
            const float2 st = stats[px];
            uint2 out = make_uint2(0u, 0u);
            if (((inside >> i) & 1) && in_c) {
              const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
              const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
              out.x = pack_bf16((a.x - st.x) * st.y * gg.x + bb.x,
                                (a.y - st.x) * st.y * gg.y + bb.y);
              out.y = pack_bf16((b.x - st.x) * st.y * gg.z + bb.z,
                                (b.y - st.x) * st.y * gg.w + bb.w);
            }
            *at = out;
          }
          hopper::mbar_arrive(halo_full(slot(base + ch)));  // (shared stores: by the arrive)
        }
        hc = base + p.chunks;
      } else {
        for (int ch = 0; ch < p.chunks; ++ch, ++hc) {
          const int hb = slot(hc), c0 = ch * 64;
          hopper::mbar_wait(halo_empty(hb), phase(hc) ^ 1);
          const uint32_t hbuf = halo0 + hb * HBUF;
          // channel pairs (c0 + 2k, +1) of every halo pixel: 32 a pixel
          for (int e = t; e < HPX * 32; e += kLnThreads) {
            const int px = e >> 5, k = 2 * (e & 31), ci = c0 + k;
            const float2 st = stats[px];
            float v0 = 0.f, v1 = 0.f;
            if (st.y >= 0.f && ci < p.c) {
              const int yy = oy0 - 2 + px / HS, xx = ox0 - 2 + px % HS;
              const bf16* xr = xi + (static_cast<long long>(yy) * p.w + xx) * p.c + ci;
              v0 = (__bfloat162float(xr[0]) - st.x) * st.y * sg[ci] + sb[ci];
              if (ci + 1 < p.c)
                v1 = (__bfloat162float(xr[1]) - st.x) * st.y * sg[ci + 1] + sb[ci + 1];
            }
            asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(hbuf + hopper::sw128_offset(px, 2 * k)),
                         "r"(pack_bf16(v0, v1))
                         : "memory");
          }
          hopper::mbar_arrive(halo_full(hb));  // (shared stores: ordered by the arrive)
        }
      }
      // the block's y1 items: each buffer, once free, goes to the consumers
      // unwritten (they write y1 into it and release it after conv2)
      for (int yc = 0; yc < R::Y1; ++yc, ++hc) {
        hopper::mbar_wait(halo_empty(slot(hc)), phase(hc) ^ 1);
        hopper::mbar_arrive(halo_full(slot(hc)));
      }
    }
    return;
  }
  // ------------------------------------------------------------ consumers
  if constexpr (NT > kThreads)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1, ct = tid - 128 * wg, q = lane & 3;
  const int i0 = (ct >> 5) * 16 + (lane >> 2);  // the thread's tile rows i0, i0 + 8
  const uint32_t group = HS * 128;              // one halo row between core matrices
  const int ksub2 = (min(64, p.cmid) + 15) >> 4;  // y1 chunk 0's k-steps
  const int ksub2b = (max(p.cmid - 64, 0) + 15) >> 4;  // chunk 1's
  int g = 0, hc = 0;
  for (int blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    int img, oy0, ox0;
    block_origin(p, blk, img, oy0, ox0);
    // ---- conv1 on region rows 8 cw .. 8 cw + 7, columns 0-7 and 8-15
    float a1[2][N1 / 2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < N1 / 2; ++e) a1[m][e] = 0.f;
    for (int ch = 0; ch < p.chunks; ++ch, ++hc) {
      const int hb = slot(hc);
      const int ksub = (min(64, p.c - ch * 64) + 15) >> 4;
      hopper::mbar_wait(halo_full(hb), phase(hc));
      hopper::fence_proxy_async();  // the LN writes, before wgmma reads them
      const uint32_t hbuf = halo0 + hb * HBUF;
      for (int r = 0; r < R::R1; ++r, ++g) {
        const int st = g % S, tap0 = r * R::T1, ntaps = min(R::T1, 9 - tap0);
        hopper::mbar_wait(w_full(st), (g / S) & 1);
        hopper::wgmma_fence();
        for (int i = 0; i < ntaps; ++i) {
          const int dy = (tap0 + i) / 3, dx = (tap0 + i) % 3;
          const uint64_t db = hopper::desc_sw128(ring + st * kStageBytes + i * N1 * 128);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const uint64_t da =
                hopper::desc_sw128(hbuf + ((8 * cw + dy) * HS + 8 * m + dx) * 128, group);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (k < ksub) hopper::Wgmma<N1>::mma(a1[m], da + 2 * k, db + 2 * k, 1);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // one group in flight: the previous run's is done
        if (r > 0 && lane == 0) hopper::mbar_arrive(w_empty((g - 1) % S));
      }
      hopper::wgmma_wait<0>();
      if (lane == 0) {
        hopper::mbar_arrive(w_empty((g - 1) % S));
        hopper::mbar_arrive(halo_empty(hb));
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) hopper::fence_operands(a1[m]);
    // ---- y1 = gelu(conv1 + c1), zero outside the image, into the block's
    // y1 items (halo buffers the producer hands over unwritten; their rows
    // and columns past the 16 x 16 pixels feed only outputs past the
    // block): channel n into item n / 64
    uint32_t y1bufs[R::Y1];
#pragma unroll
    for (int yc = 0; yc < R::Y1; ++yc) {
      hopper::mbar_wait(halo_full(slot(hc + yc)), phase(hc + yc));
      y1bufs[yc] = halo0 + slot(hc + yc) * HBUF;
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int i = i0 + 8 * h2;
        const int ry = 8 * cw + i / 8, rx = 8 * m + i % 8;  // region pixel
        const int yy = oy0 - 1 + ry, xx = ox0 - 1 + rx;
        const bool in = yy >= 0 && yy < p.h && xx >= 0 && xx < p.w;
        const int px = (ry + 1) * HS + rx + 1;  // y1 buffer pixel (origin at the block - 2)
#pragma unroll
        for (int j = 0; j < N1 / 8; ++j) {
          const int n = 8 * j + 2 * q;
          const float v0 = in ? gelu_erf(a1[m][4 * j + 2 * h2] + sc1[n]) : 0.f;
          const float v1 = in ? gelu_erf(a1[m][4 * j + 2 * h2 + 1] + sc1[n + 1]) : 0.f;
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                           y1bufs[j / 8] + hopper::sw128_offset(px, 2 * (n & 63))),
                       "r"(pack_bf16(v0, v1))
                       : "memory");
        }
      }
    hopper::fence_proxy_async();  // the y1 writes, before wgmma reads them
    consumers_barrier();
    // ---- conv2 on output rows 8 cw .. 8 cw + 7 (valid < 14), in passes of
    // N2, each reducing over the y1 chunks
    for (int pass = 0; pass < p.passes; ++pass) {
      float a2[2][N2 / 2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < N2 / 2; ++e) a2[m][e] = 0.f;
      for (int rr = 0; rr < R::Y1 * R::R2; ++rr, ++g) {
        const int yc = R::Y1 > 1 ? rr / R::R2 : 0, r = rr - yc * R::R2;
        const uint32_t y1buf = yc ? y1bufs[R::Y1 - 1] : y1bufs[0];
        const int ks = yc == 0 ? ksub2 : ksub2b;
        const int st = g % S, tap0 = r * R::T2, ntaps = min(R::T2, 9 - tap0);
        hopper::mbar_wait(w_full(st), (g / S) & 1);
        hopper::wgmma_fence();
        for (int i = 0; i < ntaps; ++i) {
          const int dy = (tap0 + i) / 3, dx = (tap0 + i) % 3;
          const uint64_t db = hopper::desc_sw128(ring + st * kStageBytes + i * N2 * 128);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            // output pixel (oy, ox) reads y1 at (oy + dy - 1, ox + dx - 1):
            // buffer pixel (oy + dy + 1, ox + dx + 1)
            const uint64_t da = hopper::desc_sw128(
                y1buf + ((8 * cw + dy + 1) * HS + 8 * m + dx + 1) * 128, group);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (k < ks) hopper::Wgmma<N2>::mma(a2[m], da + 2 * k, db + 2 * k, 1);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        if (rr > 0 && lane == 0) hopper::mbar_arrive(w_empty((g - 1) % S));
      }
      hopper::wgmma_wait<0>();
      if (lane == 0) hopper::mbar_arrive(w_empty((g - 1) % S));
#pragma unroll
      for (int m = 0; m < 2; ++m) hopper::fence_operands(a2[m]);
      // ---- y = conv2 + c2 at the block's valid pixels: each warp stages
      // 8 pixels' N2 channels at a time, then stores each pixel's run of
      // them whole (16-, 8-, 4- or 2-byte pieces): coalesced, where pairs
      // straight from the accumulators would touch 8 pixels' rows an
      // instruction
      const int n0 = pass * N2, nc = min(N2, p.c - n0);
      const int vb = p.vec_out, ppr = nc * 2 / vb;  // bytes a piece, pieces a pixel
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
          for (int j = 0; j < N2 / 8; ++j) {
            const int n = 8 * j + 2 * q;
            *reinterpret_cast<uint32_t*>(wstage + (lane >> 2) * (N2 + 8) + n) =
                pack_bf16(a2[m][4 * j + 2 * h2] + sc2[n0 + n],
                          a2[m][4 * j + 2 * h2 + 1] + sc2[n0 + n + 1]);
          }
          __syncwarp();
          const int by = 8 * cw + 2 * (ct >> 5) + h2, yy = oy0 + by;
          for (int e = lane; e < 8 * ppr; e += 32) {
            const int r = e / ppr, v = e - r * ppr;
            const int bx = 8 * m + r, xx = ox0 + bx;
            if (by >= OB || bx >= OB || yy >= p.h || xx >= p.w) continue;
            char* dst = reinterpret_cast<char*>(
                p.y + ((static_cast<long long>(img) * p.h + yy) * p.w + xx) * p.c + n0) + v * vb;
            const char* src = reinterpret_cast<const char*>(wstage + r * (N2 + 8)) + v * vb;
            if (vb == 16)
              *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            else if (vb == 8)
              *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
            else if (vb == 4)
              *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
            else
              *reinterpret_cast<unsigned short*>(dst) =
                  *reinterpret_cast<const unsigned short*>(src);
          }
          __syncwarp();
        }
    }
    // conv2's last wgmma has read y1 (wait<0> above): release its items
    if (lane == 0)
      for (int yc = 0; yc < R::Y1; ++yc) hopper::mbar_arrive(halo_empty(slot(hc + yc)));
    hc += R::Y1;
  }
}

// LN's statistics of every pixel, fp32 fast variance: a block copies 128
// pixels' rows (one contiguous run of x) into shared memory by 16-byte
// loads, then a thread sums its pixel's row there.
constexpr int kStatsPx = 128;

__global__ void __launch_bounds__(kStatsPx) ln_stats_kernel(const bf16* __restrict__ x,
                                                            float2* __restrict__ stats,
                                                            long long pixels, int c, float eps) {
  extern __shared__ uint4 srow[];  // kStatsPx * c bf16
  const long long p0 = static_cast<long long>(blockIdx.x) * kStatsPx;
  const int np = static_cast<int>(min(static_cast<long long>(kStatsPx), pixels - p0));
  const int n = np * c, n16 = n / 8;  // elements, whole 16-byte pieces
  const bf16* src = x + p0 * c;  // 16-byte aligned: kStatsPx * c * 2 bytes a block
  for (int i = threadIdx.x; i < n16; i += kStatsPx)
    srow[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
  bf16* sb = reinterpret_cast<bf16*>(srow);
  for (int i = 8 * n16 + threadIdx.x; i < n; i += kStatsPx) sb[i] = src[i];
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= np) return;
  float s = 0.f, sq = 0.f;
  const bf16* row = sb + t * c;
  if (c % 2 == 0) {
    for (int i = 0; i < c; i += 2) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + i));
      s += v.x + v.y;
      sq += v.x * v.x + v.y * v.y;
    }
  } else {
    for (int i = 0; i < c; ++i) {
      const float v = __bfloat162float(row[i]);
      s += v;
      sq += v * v;
    }
  }
  const float inv_c = 1.f / static_cast<float>(c);
  const float mu = s * inv_c;
  stats[p0 + t] = make_float2(mu, rsqrtf(fmaxf(sq * inv_c - mu * mu, 0.f) + eps));
}

template <int N1, int N2>
int launch(Params p, cudaStream_t stream) {
  // alignment slack, the halo ring, the barriers, the statistics, g, b,
  // c1, c2, the consumer warps' output staging; then the weight stages
  constexpr int fixed = 1024 + kSlots * HBUF + (2 * kSlots + 2 * kMaxStages) * 8 + HPX * 8 +
                        (2 * MAX_C + MAX_N1 + MAX_SC2) * 4 + 8 * 8 * (N2 + 8) * 2;
  p.stages = (kSmemMax - fixed) / kStageBytes;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  if (p.stages < 2 || p.passes * N2 > MAX_SC2) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = fixed + p.stages * kStageBytes;
  static int sms = 0;
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev]) {
    e = cudaFuncSetAttribute(cab_wgmma_kernel<N1, N2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    done[dev] = true;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = p.batch * p.tiles_y * p.tiles_x;
  cab_wgmma_kernel<N1, N2><<<blocks < sms ? blocks : sms, threads_of<N1>(), bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int N1>
int launch_n2(const Params& p, int n2, cudaStream_t s) {
  switch (n2) {
    case 48: return launch<N1, 48>(p, s);
    case 64: return launch<N1, 64>(p, s);
    case 96: return launch<N1, 96>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Two launches: LN's statistics of every pixel into `stats` [batch * h *
// w] float2 (a workspace), then the fused kernel.  x [batch, h, w, c]
// bf16 NHWC; g, b [c] fp32; w1 the packed conv1
// [ceil(c / 64), 9, n1, 64] and c1 [n1]; w2 the packed conv2 [passes,
// ceil(cmid / 64), 9, n2, 64] and c2 [passes * n2] (kernels/cab_conv.py
// ``pack_cab``); n1 16, 32, 64 or 128 (cmid <= n1; cmid > 64 exactly at
// 128), n2 48, 64 or 96 (passes * n2 >= c); y like x.
extern "C" int sr_ln_cab_convs_bf16(const void* x, const void* g, const void* b, const void* w1,
                                    const void* c1, const void* w2, const void* c2, void* y,
                                    void* stats, int batch, int h, int w, int c, int cmid,
                                    int n1, int n2, int passes, float eps, void* stream) {
  if (c < 1 || c > MAX_C || cmid < 1 || cmid > n1 || (cmid > 64) != (n1 > 64) || passes < 1 ||
      static_cast<long long>(passes) * n2 < c || !aligned_to(w1, 16) || !aligned_to(w2, 16) ||
      !aligned_to(x, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * h * w == 0) return 0;
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.g = static_cast<const float*>(g);
  p.b = static_cast<const float*>(b);
  p.w1 = static_cast<const bf16*>(w1);
  p.c1 = static_cast<const float*>(c1);
  p.w2 = static_cast<const bf16*>(w2);
  p.c2 = static_cast<const float*>(c2);
  p.y = static_cast<bf16*>(y);
  p.batch = batch;
  p.h = h;
  p.w = w;
  p.c = c;
  p.cmid = cmid;
  p.chunks = (c + 63) / 64;
  p.passes = passes;
  p.tiles_y = (h + OB - 1) / OB;
  p.tiles_x = (w + OB - 1) / OB;
  p.vec_in = c % 4 == 0 && aligned_to(x, 8) ? 4 : 1;
  p.vec_out = c % 8 == 0 && aligned_to(y, 16) ? 16 : c % 4 == 0 && aligned_to(y, 8) ? 8
              : c % 2 == 0 && aligned_to(y, 4) ? 4 : 2;
  p.stats = static_cast<const float2*>(stats);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long pixels = static_cast<long long>(batch) * h * w;
  static bool stats_attr[64] = {};  // the dynamic shared memory limit, set once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!stats_attr[dev]) {
    e = cudaFuncSetAttribute(ln_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kStatsPx * MAX_C * 2);
    if (e != cudaSuccess) return static_cast<int>(e);
    stats_attr[dev] = true;
  }
  ln_stats_kernel<<<static_cast<unsigned int>((pixels + kStatsPx - 1) / kStatsPx), kStatsPx,
                    kStatsPx * c * 2, s>>>(p.x, static_cast<float2*>(stats), pixels, c, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (n1) {
    case 16: return launch_n2<16>(p, n2, s);
    case 32: return launch_n2<32>(p, n2, s);
    case 64: return launch_n2<64>(p, n2, s);
    case 128: return launch_n2<128>(p, n2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
