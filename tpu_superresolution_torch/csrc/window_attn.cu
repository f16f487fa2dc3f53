// K7 — fused window attention: qkv product, biased and masked window
// softmax attention, output projection, for any window of N tokens.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_attention.py
//           fused_window_block_attention -> _fused_forward (pallas_call
//           at :229); oracle _reference_impl (:177).
// Math (per window w of N tokens, C <= 256 channels, nh <= 8 heads of
//       hd <= 32):
//         qkv = xw Wqkv^T + bqkv             (q rows pre-scaled by hd^-0.5)
//         S_h = q_h k_h^T + rpb[h] + mask[w % nW]          (fp32)
//         out = concat_h(softmax(S_h) v_h) Wproj^T + bproj
//       GEMM operands bf16 with fp32 accumulation; the softmax in fp32.
// Design: two launches.  (1) qkv_gemm_kernel: one 256-thread block per
//       64 token rows computes the rows' q|k|v into a bf16 workspace
//       [BW*N, 3*nh*32] (heads padded to 32 dims by the host packing).
//       (2) window_attn_kernel: one 256-thread block per (window, 64-query
//       tile) streams the window's keys in 64-row tiles per head with an
//       online softmax (running max and sum, the fp32 output rescaled per
//       key tile), then multiplies the tile's head-concatenated output by
//       Wproj.  At N = 256 one head's fp32 score matrix is 256 KB and
//       does not fit in shared memory; the tile holds 64 x 64 scores.
//       That attention core is window_attn_core.cuh, shared with K16.
//       Pad keys (>= N) get -inf, pad query rows are computed on zeros
//       and not stored.  Weights are read from L2 by the WMMA fragments.
//       Splitting the qkv product into its own launch keeps each key
//       tile's k and v computed once, not once per query tile; the
//       workspace costs one bf16 write and one read of 3*nh*32 columns a
//       token.
// Bound on the H100: HAT-SRx4's bench batch ([25,64,64,180] at ws 16,
//       N = 256) needs 443,520 FLOP a token (qkv 194,400, QK^T and AV
//       184,320, proj 64,800): 45.4 GFLOP, 0.046 ms at the bf16 peak,
//       against 73.7 MB of x in and out (0.022 ms): compute-bound.  This
//       first version pays the head padding (hd 30 -> 32), three
//       barriers a key tile and staging of every accumulator through
//       shared memory (the WMMA fragment layout is opaque).  Two heads in
//       flight with each warp's rows, softmax state and output held in
//       registers and cp.async double-buffered key tiles measured no
//       faster on the H100 (PERF.md); wgmma and TMA are later work.
#include <mma.h>

#include "common.cuh"
#include "swin_common.cuh"
#include "window_attn_core.cuh"

using namespace nvcuda;

namespace {

constexpr int MAX_C = 256;
constexpr int MAX_HEADS = 8;
constexpr int HDP = 32;
constexpr int T = 64;  // query / key / token rows per tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

// ---- launch 1: the qkv product ----
constexpr int LDX = MAX_C + 8;  // bf16
constexpr int QKV_SMEM = T * LDX * 2 + NWARPS * 256 * 4;

__global__ void __launch_bounds__(NTHREADS)
    qkv_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                    const float* __restrict__ bqkv, bf16* __restrict__ qkv, long long rows,
                    int c, int ck, int n3) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stg = reinterpret_cast<float*>(smem + T * LDX * 2) + warp * 256;
  const long long r0 = static_cast<long long>(blockIdx.x) * T;

  for (int i = tid; i < T * ck; i += NTHREADS) {
    const int r = i / ck, k = i % ck;
    const long long row = r0 + r;
    xs[r * LDX + k] = (row < rows && k < c) ? x[row * c + k] : __float2bfloat16(0.f);
  }
  __syncthreads();
  Acc acc[4];
  for (int strip = warp; strip < n3 / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip_rt(acc, xs, LDX, wqkv, ck, n0, ck);
    strip_epilogue(acc, stg, lane, n0, [&](int r, int n, float (&v)[8]) {
      if (r0 + r >= rows) return;
      float b[8];
      load8(b, bqkv + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += b[i];
      store8_bf16(qkv + (r0 + r) * n3 + n, v);
    });
  }
}

// ---- launch 2: attention (window_attn_core.cuh) and proj per (window,
// 64-query tile) ----
using wattn::LDH;
constexpr int LDO = MAX_HEADS * HDP + 8;  // bf16 head-concatenated output
constexpr int OFF_O = wattn::CORE_SMEM;
constexpr int ATTN_SMEM = OFF_O + T * LDO * 2;
static_assert(ATTN_SMEM <= 232448, "over the 227 KB shared-memory limit");
static_assert(wattn::HDP == HDP && wattn::T == T && wattn::NTHREADS == NTHREADS,
              "the attention core's tiles are this kernel's");

struct AttnArgs {
  const bf16* qkv;     // [BW*N, 3A]
  const bf16* wproj;   // [CO, A]
  const float* bproj;  // [CO]
  const float* rpb;    // [nh, N, N]
  const float* mask;   // [n_mask, N, N] or null
  bf16* out;           // [BW, N, C]
  int n, c, co, nh, n_mask, tiles;
};

// rows [t0, t0 + 64) of columns [col, col + 32) of the window's workspace
// rows into a [64][LDH] tile; rows >= N are zero.  One 16-byte vector a
// thread.
__device__ __forceinline__ void load_head_tile(bf16* dst, const bf16* base, int t0, int n,
                                               int n3, int col, int tid) {
  const int r = tid >> 2, cv = (tid & 3) * 8;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (t0 + r < n)
    v = *reinterpret_cast<const uint4*>(base + static_cast<long long>(t0 + r) * n3 + col + cv);
  *reinterpret_cast<uint4*>(dst + r * LDH + cv) = v;
}

__global__ void __launch_bounds__(NTHREADS) window_attn_kernel(const AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* os = reinterpret_cast<bf16*>(smem + OFF_O);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stg = wattn::staging(smem, warp);

  const int n = a.n, nh = a.nh;
  const int att = nh * HDP, n3 = 3 * att;
  const long long win = blockIdx.x / a.tiles;
  const int q0 = static_cast<int>(blockIdx.x % a.tiles) * T;
  const bf16* base = a.qkv + win * n * static_cast<long long>(n3);
  const float* mwin =
      a.mask ? a.mask + (win % a.n_mask) * static_cast<long long>(n) * n : nullptr;

  for (int hh = 0; hh < nh; ++hh) {
    // the head's q, k, v columns of the workspace; O_h / l -> the head's
    // 32 columns of the concatenated output (q carries the softmax scale)
    wattn::attend_head<false>(
        smem, n, a.tiles, q0, a.rpb + static_cast<long long>(hh) * n * n, mwin, 1.f,
        [&](bf16* dst, int part, int t0) {
          load_head_tile(dst, base, t0, n, n3, part * att + hh * HDP, tid);
        },
        [&](int r, int d, float v) { os[r * LDO + hh * HDP + d] = __float2bfloat16(v); });
  }

  // ---- out = O Wproj^T + bproj, rows < N and columns < C stored ----
  Acc acc[4];
  for (int strip = warp; strip < a.co / 16; strip += NWARPS) {
    const int n0 = strip * 16;
    gemm_strip_rt(acc, os, LDO, a.wproj, att, n0, att);
    strip_epilogue(acc, stg, lane, n0, [&](int r, int col, float (&v)[8]) {
      if (q0 + r >= n) return;
      bf16* orow = a.out + (win * n + q0 + r) * static_cast<long long>(a.c);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (col + i < a.c) orow[col + i] = __float2bfloat16(v[i] + a.bproj[col + i]);
    });
  }
}

}  // namespace

extern "C" int sr_window_attention_bf16(const void* xw, const void* wqkv, const void* bqkv,
                                        const void* wproj, const void* bproj, const void* rpb,
                                        const void* mask, void* qkv_ws, void* out, int bw, int n,
                                        int c, int nh, int n_mask, void* stream) {
  if (c < 1 || c > MAX_C || nh < 1 || nh > MAX_HEADS || c % nh || c / nh > HDP || n < 1 ||
      (mask && (n_mask < 1 || bw % n_mask)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bw == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ck = (c + 15) / 16 * 16;
  const int n3 = 3 * nh * HDP;
  const long long rows = static_cast<long long>(bw) * n;
  qkv_gemm_kernel<<<static_cast<unsigned int>((rows + T - 1) / T), NTHREADS, QKV_SMEM, s>>>(
      static_cast<const bf16*>(xw), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<bf16*>(qkv_ws), rows, c, ck, n3);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(window_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ATTN_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  AttnArgs a;
  a.qkv = static_cast<const bf16*>(qkv_ws);
  a.wproj = static_cast<const bf16*>(wproj);
  a.bproj = static_cast<const float*>(bproj);
  a.rpb = static_cast<const float*>(rpb);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<bf16*>(out);
  a.n = n;
  a.c = c;
  a.co = ck;
  a.nh = nh;
  a.n_mask = n_mask;
  a.tiles = (n + T - 1) / T;
  window_attn_kernel<<<static_cast<unsigned int>(static_cast<long long>(bw) * a.tiles), NTHREADS,
                       ATTN_SMEM, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
