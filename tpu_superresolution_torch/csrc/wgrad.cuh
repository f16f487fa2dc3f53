// The deterministic weight-gradient stage shared by the per-window
// backward kernels (K5 / K6's backward, csrc/swin_block_bwd.cu, and K8's
// backward, csrc/ocab.cu).  Each per-window kernel writes its GEMM operand
// pairs (G, Act) to a bf16 workspace, [tokens][cols] per operand; then
//   wgrad_kernel      dW[m][n] = sum_t G[t][m] Act[t][n] for up to four
//                     products, as 64x64 output tiles over row chunks
//                     (split-K), WMMA from shared-memory stages, one fp32
//                     partial per chunk;
//   reduce_rows_kernel an ordered sum over the chunks (and, for the
//                     per-window bias / LayerNorm partial sums, over the
//                     windows), so the result does not depend on the
//                     order in which blocks run.
// The TPU kernels sum these gradients in VMEM across their sequential
// grid; a Hopper grid has no order, hence the two extra launches.
#pragma once

#include "swin_common.cuh"

namespace {

constexpr int WG_TILE = 64;
constexpr int WG_STEP = 64;
constexpr int WG_LD = WG_TILE + 8;
constexpr int WG_THREADS = 128;
constexpr int WG_MAX = 4;

struct WGemm {
  const bf16* g;    // [tokens][m]
  const bf16* act;  // [tokens][n]
  int m, n;
  long long out_off;  // offset of this product in a chunk's partial
  int tile0;          // first tile index of this product
};

struct WGradArgs {
  WGemm gemm[WG_MAX];
  int ngemm;
  long long tokens;
  int rows;  // rows per chunk (a multiple of WG_STEP)
  float* part;  // [chunks][total outputs]
  long long part_stride;
};

__global__ void __launch_bounds__(WG_THREADS) wgrad_kernel(const WGradArgs a) {
  __shared__ __align__(128) bf16 sg[WG_STEP * WG_LD];
  __shared__ __align__(128) bf16 sa[WG_STEP * WG_LD];
  int gi = 0;
  while (gi < a.ngemm - 1 && static_cast<int>(blockIdx.x) >= a.gemm[gi + 1].tile0) ++gi;
  const WGemm gm = a.gemm[gi];
  const int local = blockIdx.x - gm.tile0;
  const int tiles_n = gm.n / WG_TILE;
  const int m0 = (local / tiles_n) * WG_TILE, n0 = (local % tiles_n) * WG_TILE;
  const long long t_begin = static_cast<long long>(blockIdx.y) * a.rows;
  const long long t_end = t_begin + a.rows < a.tokens ? t_begin + a.rows : a.tokens;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (long long t0 = t_begin; t0 < t_end; t0 += WG_STEP) {
    for (int i = tid; i < WG_STEP * WG_TILE / 8; i += WG_THREADS) {
      const int r = i / (WG_TILE / 8), cv = (i % (WG_TILE / 8)) * 8;
      *reinterpret_cast<uint4*>(sg + r * WG_LD + cv) =
          *reinterpret_cast<const uint4*>(gm.g + (t0 + r) * gm.m + m0 + cv);
      *reinterpret_cast<uint4*>(sa + r * WG_LD + cv) =
          *reinterpret_cast<const uint4*>(gm.act + (t0 + r) * gm.n + n0 + cv);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WG_STEP; k += 16) {
      FragAt fa[2];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], sg + k * WG_LD + wm + i * 16, WG_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], sa + k * WG_LD + wn + j * 16, WG_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = a.part + blockIdx.y * a.part_stride + gm.out_off;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(out + static_cast<long long>(m0 + wm + i * 16) * gm.n + n0 + wn +
                                  j * 16,
                              acc[i][j], gm.n, wmma::mem_row_major);
}

// out[j] = sum_r part[r][j], rows summed in order.
__global__ void reduce_rows_kernel(const float* part, long long nrows, long long ncols,
                                   float* out) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= ncols) return;
  float s = 0.f;
  for (long long r = 0; r < nrows; ++r) s += part[r * ncols + j];
  out[j] = s;
}

int reduce_rows(const float* part, long long nrows, long long ncols, float* out,
                cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((ncols + 255) / 256);
  reduce_rows_kernel<<<blocks, 256, 0, stream>>>(part, nrows, ncols, out);
  return static_cast<int>(cudaGetLastError());
}

// The weight gradients dW_i[m_i][n_i] = sum_t gs_i[t][m_i] acts_i[t][n_i]
// of `n` (<= WG_MAX) products over `tokens` rows (a multiple of WG_STEP;
// m_i, n_i multiples of WG_TILE), concatenated into `out`: wgrad_kernel
// over `splits` chunks of `rows` rows into `part`, then the ordered sum.
int weight_grads(const bf16* const* gs, const bf16* const* acts, const int* ms, const int* ns,
                 int n, long long tokens, int splits, int rows, float* part, float* out,
                 cudaStream_t stream) {
  WGradArgs g;
  long long off = 0;
  int tiles = 0;
  for (int i = 0; i < n; ++i) {
    g.gemm[i].g = gs[i];
    g.gemm[i].act = acts[i];
    g.gemm[i].m = ms[i];
    g.gemm[i].n = ns[i];
    g.gemm[i].out_off = off;
    g.gemm[i].tile0 = tiles;
    off += static_cast<long long>(ms[i]) * ns[i];
    tiles += (ms[i] / WG_TILE) * (ns[i] / WG_TILE);
  }
  g.ngemm = n;
  g.tokens = tokens;
  g.rows = rows;
  g.part = part;
  g.part_stride = off;
  wgrad_kernel<<<dim3(tiles, splits), WG_THREADS, 0, stream>>>(g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce_rows(part, splits, off, out, stream);
}

}  // namespace
