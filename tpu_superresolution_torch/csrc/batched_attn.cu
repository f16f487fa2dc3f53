// K15 and K16 — window attention on pre-split q, k, v, square or
// rectangular: the "tiled" route of kernels/window_attention.py::
// k15_route (the heads of <= 32 dims the wgmma and square kernels,
// csrc/window_attn_wg.cu and csrc/batched_attn_wg.cu, do not take, but
// K15's masked ones: K16 at windows of other than 128 or 256 tokens,
// HAT-SRx4's 256 queries x 576 keys).
//
// Replaces: tpu_superresolution_tpu/ops/pallas/window_attention.py
//           fused_window_attention (pallas_call at :193; K15: Nq != Nk
//           allowed, HAT's OCAB) and batched_window_attention ->
//           _batched_forward (pallas_call at :352; K16: DAT's rect
//           windows); oracle window_attention_reference (:229).
// Math (per window w and head h, hd <= 32):
//         out[w, h] = softmax(scale * q[w, h] k[w, h]^T + bias[h]
//                             + mask[w % nW]) v[w, h]
//       q, out [BW, nH, Nq, hd] and k, v [BW, nH, Nk, hd] bf16; bias
//       [nH, Nq, Nk] and mask [nW, Nq, Nk] fp32; scores and softmax in
//       fp32.  DAT's shift mask is additive -100, the pad tokens of DAT's
//       padded map and the zero rows of HAT's overlap gather at the image
//       border are real keys (their score is the bias alone): all three
//       are the caller's data, not special cases here.
// Design: the tiled attention core (window_attn_core.cuh, K7's first
//       design, without its qkv and proj): one 256-thread block per (window, head,
//       64-query tile) streams the window's Nk keys in 64-row tiles with
//       an online softmax, so any Nq and Nk run (HAT's 49 x 100 leaves a
//       partial query tile and a partial key tile) and no window count is
//       padded.  The TPU kernel's layout work (P windows packed into one
//       block-diagonal [P Nq, P Nk] tile, tokens and windows padded to
//       multiples of 8) has no counterpart.  Rows are read with 16-byte
//       loads where hd % 8 == 0 (HAT's hd 16) and element by element
//       otherwise (DAT's and HAT-SRx4's hd 30, whose 60-byte rows allow
//       none), zero-padded to 32 dims; the 16-byte loads save 2-4% at hd
//       16 (PERF.md).  The caller picks how the probabilities enter P V
//       (split_p): K16 as two bf16 parts (the core's kSplitP), since its
//       output feeds training, where probabilities rounded to bf16 moved
//       the smallest gradients (DynamicPosBias's, ~1e-9) farther from
//       the fp32 path's than the plain bf16 path's; K15 rounded to bf16
//       once, as the JAX module path does, within the same error bound
//       and 0.5-7% faster (PERF.md).
// Bound on the H100 (4 Nk hd FLOP a query row; q, k, v, out in bf16, the
//       bias and mask in fp32, each once): memory-bound at every shape
//       on the port's paths.  HAT-SRx4's OCAB at the bench batch
//       ([400, 6, 256, 30] against 576 keys): 42.5 GFLOP (0.043 ms at
//       the bf16 peak) against 243 MB (0.073 ms); the DAT train step's
//       [256, 3, 128, 30]: 1.5 GFLOP against 23.8 MB (0.0071 ms).  This
//       first version re-reads each window's keys once per query tile
//       (4 times at Nq 256) and the bias and mask from L2, pays the head
//       padding and three barriers a key tile.
#include <cstdint>

#include <mma.h>

#include "common.cuh"
#include "window_attn_core.cuh"

namespace {

using wattn::HDP;
using wattn::LDH;
using wattn::NTHREADS;
using wattn::T;

struct BatchedArgs {
  const bf16* q;       // [BW, nh, nq, hd]
  const bf16* k;       // [BW, nh, nk, hd]
  const bf16* v;
  const float* bias;   // [nh, nq, nk]
  const float* mask;   // [n_mask, nq, nk] or null
  bf16* out;           // [BW, nh, nq, hd]
  int nq, nk, nh, hd, n_mask, qtiles, ktiles;
  float scale;
};

// kVec: hd % 8 == 0 and q, k, v 16-byte aligned, so every 8-element
// piece of a row is one 16-byte load.  kSplitP: P enters P V as two
// bf16 parts (the core's kSplitP), else rounded to bf16 once.
template <bool kVec, bool kSplitP>
__global__ void __launch_bounds__(NTHREADS) batched_attn_kernel(const BatchedArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nq = a.nq, nk = a.nk, hd = a.hd;
  const int q0 = static_cast<int>(blockIdx.x % a.qtiles) * T;
  const long long wh = blockIdx.x / a.qtiles;  // window * nh + head
  const int hh = static_cast<int>(wh % a.nh);
  const long long win = wh / a.nh;
  const long long qoff = wh * nq * static_cast<long long>(hd);
  const long long koff = wh * nk * static_cast<long long>(hd);
  const bf16* src[3] = {a.q + qoff, a.k + koff, a.v + koff};
  const long long plane = static_cast<long long>(nq) * nk;
  const float* mwin = a.mask ? a.mask + (win % a.n_mask) * plane : nullptr;
  const bf16 zero = __float2bfloat16(0.f);

  wattn::attend_head<kSplitP>(
      smem, nq, nk, a.ktiles, q0, a.bias + hh * plane, mwin, a.scale,
      // rows [t0, t0 + 64) of q, k or v into a [64][LDH] tile: eight
      // elements a thread, zero past the part's rows and past hd
      [&](bf16* dst, int part, int t0) {
        const int r = tid >> 2, cv = (tid & 3) * 8;
        const bf16* row = src[part] + static_cast<long long>(t0 + r) * hd;
        const bool live = t0 + r < (part == 0 ? nq : nk);
        if (kVec) {
          uint4 e = make_uint4(0, 0, 0, 0);
          if (live && cv < hd) e = *reinterpret_cast<const uint4*>(row + cv);
          *reinterpret_cast<uint4*>(dst + r * LDH + cv) = e;
        } else {
          __align__(16) bf16 e[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) e[i] = (live && cv + i < hd) ? row[cv + i] : zero;
          *reinterpret_cast<uint4*>(dst + r * LDH + cv) = *reinterpret_cast<const uint4*>(e);
        }
      },
      [&](int r, int d, float val) {
        if (q0 + r < nq && d < hd)
          a.out[qoff + static_cast<long long>(q0 + r) * hd + d] = __float2bfloat16(val);
      });
}

template <bool kVec, bool kSplitP>
int launch(const BatchedArgs& a, long long blocks, cudaStream_t stream) {
  auto kernel = batched_attn_kernel<kVec, kSplitP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wattn::CORE_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(blocks), NTHREADS, wattn::CORE_SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K16 calls it with nq = nk, K15 with HAT's OCAB's ws^2 queries and ows^2
// keys (or any other pair); split_p picks the probabilities' form.
extern "C" int sr_batched_window_attention_bf16(const void* q, const void* k, const void* v,
                                                const void* bias, const void* mask, void* out,
                                                int bw, int nh, int nq, int nk, int hd,
                                                int n_mask, int split_p, float scale,
                                                void* stream) {
  if (nh < 1 || nq < 1 || nk < 1 || hd < 1 || hd > HDP || (mask && n_mask < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bw == 0) return 0;
  BatchedArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<bf16*>(out);
  a.nq = nq;
  a.nk = nk;
  a.nh = nh;
  a.hd = hd;
  a.n_mask = n_mask;
  a.qtiles = (nq + T - 1) / T;
  a.ktiles = (nk + T - 1) / T;
  a.scale = scale;
  const long long blocks = static_cast<long long>(bw) * nh * a.qtiles;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(q) | reinterpret_cast<std::uintptr_t>(k) |
                         reinterpret_cast<std::uintptr_t>(v)) % 16) == 0;
  if (hd % 8 == 0 && aligned)
    return split_p ? launch<true, true>(a, blocks, s) : launch<true, false>(a, blocks, s);
  return split_p ? launch<false, true>(a, blocks, s) : launch<false, false>(a, blocks, s);
}
