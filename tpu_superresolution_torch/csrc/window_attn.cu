// K7's product launch — y = x W^T + b on Hopper's warpgroup tensor cores
// (wgmma, bf16 in, fp32 accumulate, one bf16 rounding): K7's qkv and
// proj products (kernels/fused_attention.py), the ws-16 block backward's
// qkv recompute (fused_block.py, qkv_product).
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_attention.py
//           fused_window_block_attention -> _fused_forward (pallas_call
//           at :229): its qkv and output-projection matmuls (the
//           attention between them is csrc/window_attn_stream.cu).
// Math: y[r, n] = b[n] + sum_k x[r, k] w[n, k], x [rows, C] bf16 (any C),
//       w the packed [N_out, C] weight; fp32 sums, one rounding.  Two
//       epilogues: plain (y [rows, n_out], row-major) or head-split, K7's
//       qkv: column n = (part, head, d) of [3][nH][hdw] and row r = (window
//       w, token t) of [BW][N], stored at ws[part][w][head][d / hb][t][d %
//       hb] with each (part, w, head, block) run of N x hb values in the
//       swizzled layout wgmma reads (hopper.cuh: rows of 2 hb bytes, the
//       16-byte chunk j of row t at j ^ ((t 2 hb / 128) % (2 hb / 16))),
//       so that the attention's producer copies a unit's q, k or v block
//       with one bulk copy.
// Operands: the weight arrives packed (kernels/fused_attention.py
//       ``pack_product_weight``): one [N, 64] tile a (N tile, 64-column
//       chunk of C), K-major and already 128B-swizzled, one bulk copy a
//       ring stage; C and the output width are zero-padded.  x stays
//       row-major: a stage's [128, 64] chunk of it comes by cp.async (16,
//       8 or 4 bytes, the widest that divides C; element loads at odd C),
//       zero-filled past the rows and C, written in the swizzled layout.
// Design: a persistent grid (one 384-thread CTA an SM) walks (128-row
//       tile, N tile) pairs; warpgroup 0 produces, feeding a ring of up to
//       eight (A chunk, B tile) stages under mbarriers; warpgroups 1 and 2
//       each run wgmma m64 x N x k16 on 64 rows with fp32 accumulators in
//       registers, keep one group in flight and release a stage when the
//       group reading it is done.  C streams through the ring in 64-column
//       chunks, so no C is too wide.  The epilogue adds the bias, rounds
//       into a staging tile in shared memory and stores 16-byte pieces
//       (each warpgroup its own 64 rows, behind its own barrier): the
//       producer loads the next tile meanwhile.
// Bound on the H100: HAT-SRx4's qkv ([102400, 180] -> 540, head-split
//       and padded to 576 at hd 32) is 19.9 GFLOP (0.020 ms at the bf16
//       peak) against 37 MB in and 118 MB out (0.046 ms): memory-bound;
//       what the kernel adds is the L2 traffic of every CTA reading the
//       whole weight and the x chunk once per N tile.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 128;  // rows a tile
constexpr int BK = 64;   // K elements a stage: one 128-byte swizzled row
constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kProducers = 128;
constexpr int A_BYTES = BM * BK * 2;
constexpr int kSmemMax = 232448;
constexpr int kMaxStages = 8;

template <int N>
__host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + N * BK * 2;
}

// The epilogue's staging tile: 128 rows of N bf16, rows 8 values apart
// more than N so that a warp's pair writes fall in distinct banks.
template <int N>
__host__ __device__ constexpr int ebuf_bytes() {
  return BM * (N + 8) * 2;
}

template <int N>
__host__ __device__ constexpr int stages() {
  return (kSmemMax - 1024 - 16 * kMaxStages - ebuf_bytes<N>()) / stage_bytes<N>() < kMaxStages
             ? (kSmemMax - 1024 - 16 * kMaxStages - ebuf_bytes<N>()) / stage_bytes<N>()
             : kMaxStages;
}

template <int N>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + stages<N>() * stage_bytes<N>() + 16 * kMaxStages + ebuf_bytes<N>();
}

struct Params {
  const bf16* x;       // [rows, c]
  const bf16* wp;      // [n_tiles, chunks, N, 64] swizzled
  const float* bias;   // [n_tiles * N]
  bf16* y;
  long long rows;
  int c, chunks, n_tiles, n_out, vec;
  int vec_out;         // plain epilogue: 16-byte pieces (n_out % 8 == 0, y 16-byte aligned)
  // head-split epilogue (split != 0)
  int split, bw, ntok, nh, hdw, hb, nb;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Warpgroup 0: for each of the CTA's tiles and each 64-column chunk, the
// [128, 64] x chunk (V bf16 a copy: thread t copies columns (t % CPR) V ..
// of every (128 / CPR)-th row) and, by thread 0's bulk copy, the chunk's
// packed B tile, into the next ring stage.
template <int N, int V>
__device__ __forceinline__ void produce(const Params& p, uint32_t ring, uint32_t bars, int t) {
  constexpr int SB = stage_bytes<N>();
  constexpr int S = stages<N>();
  constexpr int CPR = BK / V;
  constexpr int RS = kProducers / CPR;
  constexpr int NR = BM / RS;
  const long long tiles = (p.rows + BM - 1) / BM * p.n_tiles;
  const int cr = (t % CPR) * V;
  int g = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long m0 = tile / p.n_tiles * BM;
    const int nt = static_cast<int>(tile % p.n_tiles);
    for (int ch = 0; ch < p.chunks; ++ch, ++g) {
      const int st = g % S;
      const uint32_t full = bars + 8u * st;
      hopper::mbar_wait(bars + 8u * (S + st), ((g / S) & 1) ^ 1);  // empty
      const uint32_t a_s = ring + st * SB;
      const int c0 = ch * BK;
      const bool in_c = c0 + cr < p.c;
#pragma unroll 8
      for (int i = 0; i < NR; ++i) {
        const int r = t / CPR + RS * i;
        const long long row = m0 + r;
        const bool ok = in_c && row < p.rows;
        const bf16* src = ok ? p.x + row * p.c + c0 + cr : p.x;
        const uint32_t dst = a_s + hopper::sw128_offset(r, cr * 2);
        if constexpr (V == 1) {
          const unsigned short v = ok ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
          asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
        } else {
          hopper::cp_async<2 * V>(dst, src, ok ? 2 * V : 0);
        }
      }
      if (t == 0) {
        hopper::mbar_arrive_expect_tx(full, N * 128);
        hopper::bulk_copy(a_s + A_BYTES,
                          p.wp + (static_cast<long long>(nt) * p.chunks + ch) * N * BK, N * 128,
                          full);
      }
      if constexpr (V == 1)
        hopper::mbar_arrive(full);  // (shared stores: ordered by the arrive)
      else
        hopper::cp_async_arrive_noinc(full);
    }
  }
  hopper::cp_async_wait_all();
}

__device__ __forceinline__ void consumer_barrier(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(cw + 1) : "memory");  // one warpgroup
}

// The epilogue of consumer warpgroup cw's 64 rows of a tile (rows m0 +
// 64 cw.., columns n0..): + bias, one rounding, bf16 pairs into the
// staging tile, then 16-byte pieces of it to y (plain: rows of y where
// they are 16-byte aligned, else elements) or to the head-split
// workspace (a piece is 8 dims of one head block: one swizzled chunk).
template <int N>
__device__ __forceinline__ void store(const Params& p, const float (&d)[N / 2], bf16* ebuf,
                                      long long m0, int n0, int cw, int ct) {
  constexpr int LDE = N + 8;
  const int lane = ct & 31, q = lane & 3;
  const int r0 = cw * 64 + (ct >> 5) * 16 + (lane >> 2);  // and r0 + 8
  consumer_barrier(cw);  // the last tile's copy-out has read these rows
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * q;
    const float b0 = __ldg(p.bias + n0 + c), b1 = __ldg(p.bias + n0 + c + 1);  // padded
    *reinterpret_cast<uint32_t*>(ebuf + r0 * LDE + c) = pack_bf16(d[4 * j] + b0, d[4 * j + 1] + b1);
    *reinterpret_cast<uint32_t*>(ebuf + (r0 + 8) * LDE + c) =
        pack_bf16(d[4 * j + 2] + b0, d[4 * j + 3] + b1);
  }
  consumer_barrier(cw);
  const int ncols = min(N, p.n_out - n0);
  const int rows = static_cast<int>(min(static_cast<long long>(64), p.rows - m0 - 64 * cw));
  const bf16* src = ebuf + cw * 64 * LDE;
  if (!p.split) {
    bf16* dst = p.y + (m0 + 64 * cw) * p.n_out + n0;
    if (p.vec_out) {
      const int vpr = (ncols + 7) / 8;  // n_out % 8 == 0: whole pieces
      for (int e = ct; e < rows * vpr; e += 128) {
        const int r = e / vpr, v = e - r * vpr;
        *reinterpret_cast<uint4*>(dst + static_cast<long long>(r) * p.n_out + 8 * v) =
            *reinterpret_cast<const uint4*>(src + r * LDE + 8 * v);
      }
    } else {
      for (int e = ct; e < rows * ncols; e += 128) {
        const int r = e / ncols, c = e - r * ncols;
        dst[static_cast<long long>(r) * p.n_out + c] = src[r * LDE + c];
      }
    }
    return;
  }
  // head split: row = (window w, token t); a piece's 8 columns = 8 dims of
  // one (part, head, block)
  const int rb = 2 * p.hb, width = p.nh * p.hdw, vpr = ncols / 8;
  const long long run = static_cast<long long>(p.ntok) * p.hb;  // values a block
  for (int e = ct; e < rows * vpr; e += 128) {
    const int r = e / vpr, v = e - r * vpr;
    const long long row = m0 + 64 * cw + r;
    const long long w = row / p.ntok;
    const int t = static_cast<int>(row - w * p.ntok);
    const int col = n0 + 8 * v;
    const int part = col / width, rem = col - part * width;
    const int head = rem / p.hdw, dd = rem - head * p.hdw;
    const int blk = dd / p.hb, el = dd - blk * p.hb;
    uint32_t off = static_cast<uint32_t>(t) * rb + 2 * el;
    off ^= ((off >> 7) & (rb / 16 - 1)) << 4;
    bf16* dst = p.y + (((static_cast<long long>(part) * p.bw + w) * p.nh + head) * p.nb + blk) *
                          run + off / 2;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src + r * LDE + 8 * v);
  }
}

// One k-step of the tile's product into d.  N 264 (C 264's qkv and proj:
// one tile, or three for 792) is two wgmmas, N 136 then 128, whose
// accumulators sit end to end in d as one N-264 instruction's would (its
// second B starts at row 136, 17 swizzle atoms in).
template <int N>
__device__ __forceinline__ void mma_tile(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 264) {
    hopper::Wgmma<136>::mma(reinterpret_cast<float(&)[68]>(d[0]), da, db, 1);
    hopper::Wgmma<128>::mma(reinterpret_cast<float(&)[64]>(d[68]), da, db + (136 * 128 >> 4), 1);
  } else {
    hopper::Wgmma<N>::mma(d, da, db, 1);
  }
}

// Persistent: CTA i takes tiles i, i + gridDim.x, ... (tile t: rows
// (t / n_tiles) * 128.., columns (t % n_tiles) * N..); the ring's stage
// and phase run on over the CTA's tiles.
template <int N>
__global__ void __launch_bounds__(kThreads, 1) window_product_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int SB = stage_bytes<N>();
  constexpr int S = stages<N>();
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t bars = ring + S * SB;  // full[s], then empty[s]
  bf16* ebuf = reinterpret_cast<bf16*>(smem_raw + (bars + 16 * kMaxStages - raw));
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S + s); };

  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full(s), kProducers + 1);  // every producer's copies + B's expect_tx
      hopper::mbar_init(empty(s), 2 * 4);          // lane 0 of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform role
  if (wg == 0) {
    switch (p.vec) {
      case 8: produce<N, 8>(p, ring, bars, tid); break;
      case 4: produce<N, 4>(p, ring, bars, tid); break;
      case 2: produce<N, 2>(p, ring, bars, tid); break;
      default: produce<N, 1>(p, ring, bars, tid); break;
    }
    return;
  }
  const int cw = wg - 1, ct = tid - 128 * wg;
  const long long tiles = (p.rows + BM - 1) / BM * p.n_tiles;
  int g = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float d[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
    for (int ch = 0; ch < p.chunks; ++ch, ++g) {
      const int st = g % S;
      hopper::mbar_wait(full(st), (g / S) & 1);
      // the producers' generic-proxy writes, visible through the barrier,
      // ordered before this thread's wgmma reads
      hopper::fence_proxy_async();
      const int ksub = (min(BK, p.c - ch * BK) + 15) >> 4;
      const uint64_t da = hopper::desc_sw128(ring + st * SB + cw * 64 * 128);
      const uint64_t db = hopper::desc_sw128(ring + st * SB + A_BYTES);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        if (k < ksub) mma_tile<N>(d, da + 2 * k, db + 2 * k);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // one group in flight: the previous stage's is done
      if (ch > 0 && lane == 0) hopper::mbar_arrive(empty((g - 1) % S));
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(d);
    if (lane == 0) hopper::mbar_arrive(empty((g - 1) % S));
    store<N>(p, d, ebuf, tile / p.n_tiles * BM, static_cast<int>(tile % p.n_tiles) * N, cw, ct);
  }
}

constexpr int kMaxDevices = 64;

template <int N>
int launch(const Params& p, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev]) {
    e = cudaFuncSetAttribute(window_product_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<N>());
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    done[dev] = true;
  }
  const long long tiles = (p.rows + BM - 1) / BM * p.n_tiles;
  window_product_kernel<N><<<static_cast<unsigned int>(tiles < sms[dev] ? tiles : sms[dev]),
                             kThreads, smem_bytes<N>(), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [rows, c] bf16 times the packed weight wp [n_tiles, ceil(c / 64),
// n_tile, 64] (kernels/fused_attention.py ``pack_product_weight``) plus
// bias [n_tiles * n_tile] fp32.  split 0: y [rows, n_out] bf16 (n_out <=
// n_tiles * n_tile).  split 1: K7's qkv, rows = bw * ntok, n_out = 3 * nh
// * hdw, y the head-split workspace [3, bw, nh, hdw / hb, ntok, hb] (each
// run swizzled; hb 16, 32 or 64).  n_tile: a compiled N (16, 32, 64, 96,
// 128, 144, 192, 256, 264); vec: the x copy width in bf16 (8, 4, 2 or 1; it
// divides c and x is aligned to it).  Returns cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int sr_window_product_bf16(const void* x, const void* wp, const void* bias, void* y,
                                      long long rows, int c, int n_tile, int n_tiles, int n_out,
                                      int vec, int split, int bw, int ntok, int nh, int hdw,
                                      int hb, void* stream) {
  const bool vec_ok = (vec == 8 || vec == 4 || vec == 2 || vec == 1) && c % vec == 0 &&
                      aligned_to(x, 2 * vec);
  if (rows < 0 || c < 1 || n_tiles < 1 || n_out < 1 ||
      static_cast<long long>(n_tile) * n_tiles < n_out || !vec_ok || !aligned_to(wp, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (split && (bw < 1 || ntok < 1 || nh < 1 || static_cast<long long>(bw) * ntok != rows ||
                (hb != 16 && hb != 32 && hb != 64) || hdw < hb || hdw % hb ||
                n_out != 3 * nh * hdw || !aligned_to(y, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.wp = static_cast<const bf16*>(wp);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<bf16*>(y);
  p.rows = rows;
  p.c = c;
  p.chunks = (c + BK - 1) / BK;
  p.n_tiles = n_tiles;
  p.n_out = n_out;
  p.vec = vec;
  p.vec_out = n_out % 8 == 0 && aligned_to(y, 16);
  p.split = split;
  p.bw = bw;
  p.ntok = ntok;
  p.nh = nh;
  p.hdw = hdw;
  p.hb = hb;
  p.nb = split ? hdw / hb : 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_tile) {
    case 16: return launch<16>(p, s);
    case 32: return launch<32>(p, s);
    case 64: return launch<64>(p, s);
    case 96: return launch<96>(p, s);
    case 128: return launch<128>(p, s);
    case 144: return launch<144>(p, s);
    case 192: return launch<192>(p, s);
    case 256: return launch<256>(p, s);
    case 264: return launch<264>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
