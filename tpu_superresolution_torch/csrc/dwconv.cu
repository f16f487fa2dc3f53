// K11 — depthwise 3x3 convolution with SAME zero padding, plus bias.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/cab_conv.py dwconv3x3_halo
//           (pallas_call at :506); oracle its `reference` (:472).
// Math: out[b, i, j, c] = bias[c] + sum over dy, dx in 0..2 of
//       x[b, i + dy - 1, j + dx - 1, c] * k[dy, dx, c]  (zero outside)
//       x, out [B, H, W, C] bf16; k [9, C] tap-major and bias [C] fp32;
//       the sum in fp32, one rounding to bf16 at the end.
// Design: one 256-thread block per (image, 8-row tile, 32-column tile,
//       64-channel chunk) stages the tile's input with its one-pixel halo
//       ([10][34][64] bf16, 43.5 KB) and the chunk's taps and bias in
//       shared memory, then each thread walks one column and vector of V
//       channels down the tile's rows with its 3 x 3 window of input
//       vectors in registers (three new vectors a row): V = 8 (16-byte
//       loads and stores) where C % 8 == 0, else 4, 2 or 1, so the vector
//       never straddles a pixel.  Each input element is read from device
//       memory once per tile it touches (10/8 x 34/32 = 1.33 reads an
//       element), each output written once.
// Bound on the H100: 18 FLOP per output element against 4 bytes (bf16
//       in and out): memory-bound.  At the DAT train step's [8, 64, 64,
//       180], 5.9 MB in and 5.9 MB out: 0.0035 ms at 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int TR = 8;     // output rows per block
constexpr int TW = 32;    // output columns per block
constexpr int CC = 64;    // channels per block
constexpr int NTHREADS = 256;

template <int V>
struct VecOf;
template <>
struct VecOf<8> { typedef uint4 type; };
template <>
struct VecOf<4> { typedef uint2 type; };
template <>
struct VecOf<2> { typedef unsigned int type; };
template <>
struct VecOf<1> { typedef unsigned short type; };

template <int V>
__global__ void __launch_bounds__(NTHREADS)
    dwconv3x3_kernel(const bf16* __restrict__ x, const float* __restrict__ k9,
                     const float* __restrict__ bias, bf16* __restrict__ out, int h, int w, int c,
                     int col_tiles) {
  typedef typename VecOf<V>::type Vec;
  constexpr int NV = CC / V;  // vectors per pixel of the chunk
  __shared__ __align__(16) bf16 xs[(TR + 2) * (TW + 2) * CC];
  __shared__ float ks[9 * CC];
  __shared__ float bs[CC];
  const int tid = threadIdx.x;
  const int img = blockIdx.z;
  const int r0 = blockIdx.y * TR;
  const int q0 = (blockIdx.x % col_tiles) * TW;
  const int c0 = (blockIdx.x / col_tiles) * CC;
  const long long base = static_cast<long long>(img) * h * w;

  for (int i = tid; i < 9 * CC; i += NTHREADS) {
    const int ch = c0 + i % CC;
    ks[i] = ch < c ? k9[(i / CC) * c + ch] : 0.f;
  }
  for (int i = tid; i < CC; i += NTHREADS) bs[i] = c0 + i < c ? bias[c0 + i] : 0.f;
  // the input tile with its halo; zeros outside the image and past C
  for (int i = tid; i < (TR + 2) * (TW + 2) * NV; i += NTHREADS) {
    const int vec = i % NV, pix = i / NV;
    const int rr = r0 - 1 + pix / (TW + 2), qq = q0 - 1 + pix % (TW + 2);
    const int ch = c0 + vec * V;
    Vec val;
    if (rr >= 0 && rr < h && qq >= 0 && qq < w && ch < c)
      val = *reinterpret_cast<const Vec*>(x + (base + static_cast<long long>(rr) * w + qq) * c +
                                          ch);
    else
      val = Vec();
    *reinterpret_cast<Vec*>(xs + pix * CC + vec * V) = val;
  }
  __syncthreads();
  // each thread one (column, channel vector) of the tile down all TR
  // rows, with the 3 x 3 window of input vectors in registers: one new
  // row of three vectors from shared memory per output row
  for (int i = tid; i < TW * NV; i += NTHREADS) {
    const int vec = i % NV, qo = i / NV;
    const int q = q0 + qo, ch = c0 + vec * V;
    if (q >= w || ch >= c) continue;
    float win[3][3][V];
    auto load_row = [&](float (&dst)[3][V], int srow) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const Vec raw = *reinterpret_cast<const Vec*>(xs + (srow * (TW + 2) + qo + dx) * CC +
                                                      vec * V);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int k = 0; k < V; ++k) dst[dx][k] = __bfloat162float(e[k]);
      }
    };
    load_row(win[0], 0);
    load_row(win[1], 1);
#pragma unroll
    for (int ro = 0; ro < TR; ++ro) {
      if (r0 + ro >= h) break;
      load_row(win[2], ro + 2);
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* kt = ks + (dy * 3 + dx) * CC + vec * V;
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] += win[dy][dx][k] * kt[k];
        }
      }
      __align__(16) bf16 o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = __float2bfloat16(acc[k] + bs[vec * V + k]);
      *reinterpret_cast<Vec*>(out + (base + static_cast<long long>(r0 + ro) * w + q) * c + ch) =
          *reinterpret_cast<const Vec*>(o);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int k = 0; k < V; ++k) {
          win[0][dx][k] = win[1][dx][k];
          win[1][dx][k] = win[2][dx][k];
        }
    }
  }
}

template <int V>
cudaError_t launch(const bf16* x, const float* k9, const float* bias, bf16* out, int b, int h,
                   int w, int c, cudaStream_t s) {
  const int col_tiles = (w + TW - 1) / TW;
  const dim3 grid(col_tiles * ((c + CC - 1) / CC), (h + TR - 1) / TR, b);
  dwconv3x3_kernel<V><<<grid, NTHREADS, 0, s>>>(x, k9, bias, out, h, w, c, col_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sr_dwconv3x3_bf16(const void* x, const void* k9, const void* bias, void* out,
                                 int b, int h, int w, int c, void* stream) {
  if (b < 0 || h < 0 || w < 0 || c < 1 || b > 65535 || (h + TR - 1) / TR > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(b) * h * w == 0) return 0;
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* op = static_cast<bf16*>(out);
  const float* kp = static_cast<const float*>(k9);
  const float* bp = static_cast<const float*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest vector that divides C and both pointers' alignment
  cudaError_t err;
  if (c % 8 == 0 && aligned_to(x, 16) && aligned_to(out, 16))
    err = launch<8>(xp, kp, bp, op, b, h, w, c, s);
  else if (c % 4 == 0 && aligned_to(x, 8) && aligned_to(out, 8))
    err = launch<4>(xp, kp, bp, op, b, h, w, c, s);
  else if (c % 2 == 0 && aligned_to(x, 4) && aligned_to(out, 4))
    err = launch<2>(xp, kp, bp, op, b, h, w, c, s);
  else
    err = launch<1>(xp, kp, bp, op, b, h, w, c, s);
  return static_cast<int>(err);
}
