// K16 — batched window attention on pre-split q, k, v.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/window_attention.py
//           batched_window_attention -> _batched_forward (pallas_call at
//           :352); oracle window_attention_reference (:229).
// Math (per window w of N tokens and head h, hd <= 32):
//         out[w, h] = softmax(scale * q[w, h] k[w, h]^T + bias[h]
//                             + mask[w % nW]) v[w, h]
//       q, k, v, out [BW, nH, N, hd] bf16; bias [nH, N, N] and mask
//       [nW, N, N] fp32; scores and softmax in fp32.  DAT's shift mask is
//       additive -100, and the pad tokens of a padded map are real keys:
//       both are the caller's data, not special cases here.
// Design: the attention core of K7 (window_attn_core.cuh) without the
//       qkv and proj products: one 256-thread block per (window, head,
//       64-query tile) streams the window's keys in 64-row tiles with an
//       online softmax, so any N runs (DAT's 128 and 256, no padding of
//       the window count: the TPU kernel's `group` is a TPU detail).  The
//       head's rows are loaded element by element and zero-padded to 32
//       dims (DAT's hd is 30, whose 60-byte rows allow no 16-byte loads).
//       The probabilities enter P V as two bf16 parts (the core's
//       kSplitP): K16's output feeds training, where probabilities rounded
//       to bf16 moved the smallest gradients (DynamicPosBias's, ~1e-9)
//       farther from the fp32 path's than the plain bf16 path's (PERF.md).
// Bound on the H100: the DAT train step's [256, 3, 128, 30] call does
//       4 N hd = 15,360 FLOP a query row (1.5 GFLOP, 0.0015 ms at the bf16
//       peak) against 23.8 MB of q, k, v, out and bias (0.0071 ms):
//       memory-bound.  This first version re-reads each window's keys
//       once per query tile (twice at N = 128) and the bias and mask
//       from L2, pays the head padding and three barriers a key tile.
#include <mma.h>

#include "common.cuh"
#include "window_attn_core.cuh"

namespace {

using wattn::HDP;
using wattn::LDH;
using wattn::NTHREADS;
using wattn::T;

struct BatchedArgs {
  const bf16* q;       // [BW, nh, N, hd]
  const bf16* k;
  const bf16* v;
  const float* bias;   // [nh, N, N]
  const float* mask;   // [n_mask, N, N] or null
  bf16* out;           // [BW, nh, N, hd]
  int n, nh, hd, n_mask, tiles;
  float scale;
};

__global__ void __launch_bounds__(NTHREADS) batched_attn_kernel(const BatchedArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int n = a.n, hd = a.hd;
  const int q0 = static_cast<int>(blockIdx.x % a.tiles) * T;
  const long long wh = blockIdx.x / a.tiles;  // window * nh + head
  const int hh = static_cast<int>(wh % a.nh);
  const long long win = wh / a.nh;
  const long long off = wh * n * static_cast<long long>(hd);
  const bf16* src[3] = {a.q + off, a.k + off, a.v + off};
  const float* mwin =
      a.mask ? a.mask + (win % a.n_mask) * static_cast<long long>(n) * n : nullptr;
  const bf16 zero = __float2bfloat16(0.f);

  wattn::attend_head<true>(
      smem, n, a.tiles, q0, a.bias + static_cast<long long>(hh) * n * n, mwin, a.scale,
      // rows [t0, t0 + 64) of q, k or v into a [64][LDH] tile: eight
      // elements a thread, zero past N and past hd
      [&](bf16* dst, int part, int t0) {
        const int r = tid >> 2, cv = (tid & 3) * 8;
        const bf16* row = src[part] + static_cast<long long>(t0 + r) * hd;
        const bool live = t0 + r < n;
        __align__(16) bf16 e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = (live && cv + i < hd) ? row[cv + i] : zero;
        *reinterpret_cast<uint4*>(dst + r * LDH + cv) = *reinterpret_cast<const uint4*>(e);
      },
      [&](int r, int d, float val) {
        if (q0 + r < n && d < hd)
          a.out[off + static_cast<long long>(q0 + r) * hd + d] = __float2bfloat16(val);
      });
}

}  // namespace

extern "C" int sr_batched_window_attention_bf16(const void* q, const void* k, const void* v,
                                                const void* bias, const void* mask, void* out,
                                                int bw, int nh, int n, int hd, int n_mask,
                                                float scale, void* stream) {
  if (nh < 1 || n < 1 || hd < 1 || hd > HDP || (mask && n_mask < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bw == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      batched_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wattn::CORE_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  BatchedArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<bf16*>(out);
  a.n = n;
  a.nh = nh;
  a.hd = hd;
  a.n_mask = n_mask;
  a.tiles = (n + T - 1) / T;
  a.scale = scale;
  const long long blocks = static_cast<long long>(bw) * nh * a.tiles;
  batched_attn_kernel<<<static_cast<unsigned int>(blocks), NTHREADS, wattn::CORE_SMEM,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
