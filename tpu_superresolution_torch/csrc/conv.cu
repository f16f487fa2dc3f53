// K3 + K4 — NHWC direct convolution as an implicit GEMM on bf16 tensor
// cores (WMMA 16x16x16, fp32 accumulate), + bias, bf16 store.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/cab_conv.py
//           conv3x3_halo (_conv_kernel)  -> sr_conv3x3_bf16 (K3, pad 1)
//           conv_halo    (_convk_kernel) -> sr_conv_bf16    (K4, any kh x kw,
//                                           asymmetric zero pad)
// Math: y[b, oy, ox, n] = bias[n] + sum_{dy, dx, ci}
//         x[b, oy + dy - pad_top, ox + dx - pad_left, ci] * w[dy, dx, ci, n]
//       with x read as 0 outside the image (SAME output size).  The
//       weight keeps the JAX package's [kh, kw, Cin, Cout] layout, so the
//       K index (tap, ci) is a row of a row-major [kh*kw*Cin, Cout] matrix.
// Bound on the H100: tensor-core throughput and operand staging.  At the
//       main path's 180->180 3x3 conv the GEMM is M = pixels, N = 180,
//       K = 1620, ~225 flop per byte of activations read once, but this
//       kernel re-reads each input pixel kh*kw times (once per tap, from
//       L2) and stages every tile through one shared-memory buffer with a
//       barrier per K step, so it runs well below the ridge.
// Design: one 128-thread block per 64-pixel x 64-channel output tile;
//       four warps each own a 32x32 quadrant (2x2 WMMA tiles).  The K
//       loop walks taps x 32-channel chunks; each step stages a 64x32 A
//       tile (pixels gathered with the halo zeroed by predicate) and a
//       32x64 B tile in shared memory, the next step's tiles travelling
//       from global memory into registers during this step's MMAs.
//       Channel tails of Cin and Cout are zero-filled, so any Cin/Cout and
//       any image size are taken: there is no shape gate.  Loads are V-wide (V = 8, 4, 2 or 1 bf16) where
//       Cin, Cout and the pointers allow.  A multi-stage cp.async / TMA
//       ring and wgmma are later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDA = BK + 8;  // 40 bf16: keeps WMMA rows 32-byte aligned
constexpr int LDB = BN + 8;  // 72 bf16
constexpr int LDC = BN + 4;  // 68 fp32
constexpr int kThreads = 128;

// V consecutive bf16 values as one 2V-byte word.
template <int V> struct VecType;
template <> struct VecType<8> { typedef uint4 T; };
template <> struct VecType<4> { typedef uint2 T; };
template <> struct VecType<2> { typedef unsigned int T; };
template <> struct VecType<1> { typedef unsigned short T; };

template <int V>
__global__ void __launch_bounds__(kThreads)
    conv_nhwc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const float* __restrict__ bias, bf16* __restrict__ y, int batch,
                     int h, int wd, int cin, int cout, int kh, int kw, int pad_top,
                     int pad_left) {
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];

  constexpr int A_VECS = BM * BK / V / kThreads;  // A vectors per thread
  constexpr int A_PER_ROW = BK / V;
  constexpr int B_VECS = BK * BN / V / kThreads;
  constexpr int B_PER_ROW = BN / V;

  const long long m_total = static_cast<long long>(batch) * h * wd;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;

  // The output pixel of each A vector this thread stages (fixed over K).
  int a_b[A_VECS], a_y[A_VECS], a_x[A_VECS];
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const int idx = tid + i * kThreads;
    const long long m = m0 + idx / A_PER_ROW;
    if (m < m_total) {
      const long long hw = static_cast<long long>(h) * wd;
      a_b[i] = static_cast<int>(m / hw);
      const int rem = static_cast<int>(m % hw);
      a_y[i] = rem / wd;
      a_x[i] = rem % wd;
    } else {
      a_b[i] = -1;
      a_y[i] = 0;
      a_x[i] = 0;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // K steps walk taps x BK-channel chunks.  The next step's operands are
  // fetched into registers while the tensor cores work on this step's
  // shared-memory tiles, so global latency overlaps the MMAs.
  typedef typename VecType<V>::T Vec;
  const int nchunks = (cin + BK - 1) / BK;
  const int steps = kh * kw * nchunks;
  Vec ra[A_VECS], rb[B_VECS];
  auto fetch = [&](int it) {
    const int tap = it / nchunks, c0 = (it % nchunks) * BK;
    const int dy = tap / kw - pad_top, dx = tap % kw - pad_left;
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int k = ((tid + i * kThreads) % A_PER_ROW) * V;
      const int iy = a_y[i] + dy, ix = a_x[i] + dx;
      ra[i] = Vec{};
      if (a_b[i] >= 0 && iy >= 0 && iy < h && ix >= 0 && ix < wd && c0 + k < cin) {
        const long long off =
            ((static_cast<long long>(a_b[i]) * h + iy) * wd + ix) * cin + c0 + k;
        ra[i] = __ldg(reinterpret_cast<const Vec*>(x + off));
      }
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / B_PER_ROW, n = (idx % B_PER_ROW) * V;
      rb[i] = Vec{};
      if (c0 + r < cin && n0 + n < cout) {
        const long long off = (static_cast<long long>(tap) * cin + c0 + r) * cout + n0 + n;
        rb[i] = __ldg(reinterpret_cast<const Vec*>(w + off));
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<Vec*>(As + (idx / A_PER_ROW) * LDA + (idx % A_PER_ROW) * V) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<Vec*>(Bs + (idx / B_PER_ROW) * LDB + (idx % B_PER_ROW) * V) = rb[i];
    }
  };

  fetch(0);
  stage();
  __syncthreads();
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) fetch(it + 1);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDA + ks, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + ks * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if (it + 1 < steps) {
      stage();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: + bias, bf16, V-wide stores along the channel axis.
  constexpr int O_VECS = BM * BN / V / kThreads;
#pragma unroll
  for (int i = 0; i < O_VECS; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / B_PER_ROW, n = (idx % B_PER_ROW) * V;
    const long long m = m0 + r;
    if (m >= m_total || n0 + n >= cout) continue;
    __align__(16) bf16 vals[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      vals[e] = __float2bfloat16(Cs[r * LDC + n + e] + bias[n0 + n + e]);
    bf16* dst = y + m * cout + n0 + n;
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(vals);
    } else if constexpr (V == 2) {
      *reinterpret_cast<unsigned int*>(dst) = *reinterpret_cast<const unsigned int*>(vals);
    } else {
      dst[0] = vals[0];
    }
  }
}

template <int V>
void launch(const void* x, const void* w, const void* bias, void* y, int batch, int h,
            int wd, int cin, int cout, int kh, int kw, int pad_top, int pad_left,
            cudaStream_t stream) {
  const long long m_total = static_cast<long long>(batch) * h * wd;
  const dim3 grid(static_cast<unsigned int>((m_total + BM - 1) / BM), (cout + BN - 1) / BN);
  conv_nhwc_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(y), batch, h, wd, cin, cout, kh, kw,
      pad_top, pad_left);
}

// Widest vector (in bf16 elements) that divides both channel counts and
// keeps every pointer aligned.
int pick_vec(const void* x, const void* w, const void* y, int cin, int cout) {
  for (int v = 8; v > 1; v >>= 1) {
    if (cin % v == 0 && cout % v == 0 && aligned_to(x, 2 * v) && aligned_to(w, 2 * v) &&
        aligned_to(y, 2 * v))
      return v;
  }
  return 1;
}

}  // namespace

extern "C" int sr_conv_bf16(const void* x, const void* w, const void* bias, void* y,
                            int batch, int h, int wd, int cin, int cout, int kh, int kw,
                            int pad_top, int pad_left, void* stream) {
  if (static_cast<long long>(batch) * h * wd == 0 || cout == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_vec(x, w, y, cin, cout)) {
    case 8:
      launch<8>(x, w, bias, y, batch, h, wd, cin, cout, kh, kw, pad_top, pad_left, s);
      break;
    case 4:
      launch<4>(x, w, bias, y, batch, h, wd, cin, cout, kh, kw, pad_top, pad_left, s);
      break;
    case 2:
      launch<2>(x, w, bias, y, batch, h, wd, cin, cout, kh, kw, pad_top, pad_left, s);
      break;
    default:
      launch<1>(x, w, bias, y, batch, h, wd, cin, cout, kh, kw, pad_top, pad_left, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sr_conv3x3_bf16(const void* x, const void* w, const void* bias, void* y,
                               int batch, int h, int wd, int cin, int cout, void* stream) {
  return sr_conv_bf16(x, w, bias, y, batch, h, wd, cin, cout, 3, 3, 1, 1, stream);
}
