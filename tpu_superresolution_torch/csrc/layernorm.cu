// K2 — row LayerNorm over the channel axis of a [rows, C] bf16 map.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/layernorm.py
//           pallas_layernorm (_ln_kernel, pallas_call at :54), reached
//           via layernorm_spatial.
// Math: fp32 sums of x and x^2 per row, the fast variance E[x^2] - E[x]^2
//       clamped at 0, eps given, rsqrt, then (x - mu) rstd g + b, output
//       in bf16 (the input dtype): kernels/layernorm.py layernorm_plain.
// Bound on the H100: memory.  A row of C 180 is 360 bytes in and 360 out
//       and the kernel does ~5 flops a byte, far below the ~295 flop/byte
//       ridge: at [102400, 180] 73.7 MB, 0.022 ms at 3.35 TB/s.
// Design (kernels/layernorm.py ``layernorm_plan`` picks the numbers from
//       C, the C entry checks them): a persistent grid of 256-thread CTAs,
//       four an SM (two past 3 chunks a lane), striding over bands of rows.  A warp's lanes split
//       into groups of G (4, 8, 16 or 32) lanes, a row a group, so a warp
//       takes a band of 32 / G consecutive rows at once (their bytes are
//       contiguous); band i of warp w of the grid's W warps is band
//       w + i W.  A lane holds NPL 4-channel chunks of its row (chunk
//       l + G j for its place l in the group): the row is read from
//       memory once into registers, as 8-byte loads where C % 4 == 0 and
//       the pointers allow (a row of C 180 starts 8-byte but not 16-byte
//       aligned every other row), else element by element (any C, odd C
//       included: the scalar form of the same schedule), kept packed as
//       bf16; a warp takes its bands two at a time (w + 2 i W and
//       w + (2 i + 1) W) and issues the next two's loads before these two's
//       sums, so four bands of a warp are in flight.  The row sums are
//       shuffles within the group.  g and b sit in shared memory by
//       chunk, loaded once a CTA.  Past 4 x 32 x 6 channels
//       (C > 768), one warp a row walks it twice (the second read from
//       L1 / L2).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_NPL = 6;  // 4-channel chunks a lane

// Chunk j of the row at `p` (channels 4 j .. 4 j + 3), four bf16 packed
// in a uint2 as loaded (zero past c): an 8-byte load, or (VEC false) four
// 2-byte ones.
template <bool VEC>
__device__ __forceinline__ uint2 load_chunk(const bf16* p, int j, int c) {
  const int k = 4 * j;
  if (VEC) return k < c ? __ldg(reinterpret_cast<const uint2*>(p + k)) : make_uint2(0u, 0u);
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  uint32_t e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = k + i < c ? __ldg(s + k + i) : 0u;
  return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
}

__device__ __forceinline__ float4 unpack4(uint2 u) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <bool VEC>
__device__ __forceinline__ void store_chunk(bf16* p, int j, int c, float4 v) {
  const int k = 4 * j;
  if (VEC) {
    if (k >= c) return;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p + k) = u;
    return;
  }
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (k + e < c) p[k + e] = __float2bfloat16(f[e]);
}

// The sum over the G lanes of a group (G a power of two, groups aligned).
__device__ __forceinline__ float group_sum(float v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// CTAs an SM the register budget allows: four at up to 3 chunks a lane
// (64 registers), two past (kernels/layernorm.py layernorm_plan sizes the
// grid so).
__host__ __device__ constexpr int ctas_per_sm(int npl) { return npl <= 3 ? 4 : 2; }

template <int NPL, bool VEC>
__global__ void __launch_bounds__(THREADS, ctas_per_sm(NPL))
    layernorm_bands_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                           const float* __restrict__ b, bf16* __restrict__ y, long long rows,
                           int c, int group, float eps) {
  __shared__ float4 gb[2][MAX_NPL * 32];  // g, b by 4-channel chunk, zero past c
  const int chunks = (c + 3) / 4;
  for (int j = threadIdx.x; j < chunks; j += THREADS) {
    float v[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = 4 * j + e < c;
      v[0][e] = in ? g[4 * j + e] : 0.f;
      v[1][e] = in ? b[4 * j + e] : 0.f;
    }
    gb[0][j] = make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
    gb[1][j] = make_float4(v[1][0], v[1][1], v[1][2], v[1][3]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / group;  // rows of a band
  const int sub = lane / group, gl = lane - sub * group;
  const long long warps = static_cast<long long>(gridDim.x) * (THREADS / 32);
  const long long bands = (rows + per_warp - 1) / per_warp;
  const float inv_c = 1.f / static_cast<float>(c);
  // two bands an iteration (band, band + W), the next two loaded before
  // these are summed: four bands of the warp in flight, as packed bf16
  auto load_band = [&](uint2 (&v)[NPL], long long bd) {
    const long long row = bd * per_warp + sub;
    if (bd >= bands) return;
    const bf16* p = x + (row < rows ? row : rows - 1) * c;
#pragma unroll
    for (int i = 0; i < NPL; ++i) v[i] = load_chunk<VEC>(p, gl + group * i, c);
  };
  auto finish_band = [&](const uint2 (&u)[NPL], long long bd) {
    float4 v[NPL];
    float s = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      v[i] = unpack4(u[i]);
      s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
      sq += (v[i].x * v[i].x + v[i].y * v[i].y) + (v[i].z * v[i].z + v[i].w * v[i].w);
    }
    s = group_sum(s, group);
    sq = group_sum(sq, group);
    const float mu = s * inv_c;
    const float rstd = rsqrtf(fmaxf(sq * inv_c - mu * mu, 0.f) + eps);
    const long long row = bd * per_warp + sub;
    if (bd >= bands || row >= rows) return;
    bf16* q = y + row * c;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int j = gl + group * i;
      if (4 * j >= c) continue;
      const float4 gv = gb[0][j], bv = gb[1][j];
      store_chunk<VEC>(q, j, c,
                       make_float4((v[i].x - mu) * rstd * gv.x + bv.x,
                                   (v[i].y - mu) * rstd * gv.y + bv.y,
                                   (v[i].z - mu) * rstd * gv.z + bv.z,
                                   (v[i].w - mu) * rstd * gv.w + bv.w));
    }
  };
  long long band = static_cast<long long>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
  uint2 c0[NPL], c1[NPL], n0[NPL], n1[NPL];
  load_band(c0, band);
  load_band(c1, band + warps);
  for (; band < bands; band += 2 * warps) {
    load_band(n0, band + 2 * warps);
    load_band(n1, band + 3 * warps);
    finish_band(c0, band);
    finish_band(c1, band + warps);
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      c0[i] = n0[i];
      c1[i] = n1[i];
    }
  }
}

// Past MAX_NPL chunks a lane: one warp a row, the row walked twice.
__global__ void __launch_bounds__(THREADS)
    layernorm_wide_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                          const float* __restrict__ b, bf16* __restrict__ y, long long rows,
                          int c, float eps) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (THREADS / 32);
  const float inv_c = 1.f / static_cast<float>(c);
  for (long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
       row < rows; row += warps) {
    const bf16* p = x + row * c;
    float s = 0.f, sq = 0.f;
    for (int k = lane; k < c; k += 32) {
      const float v = __bfloat162float(p[k]);
      s += v;
      sq += v * v;
    }
    s = warp_sum(s);
    sq = warp_sum(sq);
    const float mu = s * inv_c;
    const float rstd = rsqrtf(fmaxf(sq * inv_c - mu * mu, 0.f) + eps);
    bf16* q = y + row * c;
    for (int k = lane; k < c; k += 32)
      q[k] = __float2bfloat16((__bfloat162float(p[k]) - mu) * rstd * g[k] + b[k]);
  }
}

template <int NPL>
cudaError_t launch_npl(bool vec, int grid, cudaStream_t s, const bf16* x, const float* g,
                       const float* b, bf16* y, long long rows, int c, int group, float eps) {
  if (vec)
    layernorm_bands_kernel<NPL, true><<<grid, THREADS, 0, s>>>(x, g, b, y, rows, c, group, eps);
  else
    layernorm_bands_kernel<NPL, false><<<grid, THREADS, 0, s>>>(x, g, b, y, rows, c, group, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y [rows, c] bf16; g, b [c] fp32.  The plan (kernels/layernorm.py
// layernorm_plan): `group` lanes a row and `npl` chunks a lane, with
// group * npl * 4 >= c and npl <= 6 (npl 0: the wide kernel, any c), on
// `grid` CTAs.  8-byte accesses where c % 4 == 0 and x, y are 8-byte
// aligned.
extern "C" int sr_layernorm_bf16(const void* x, const void* g, const void* b, void* y,
                                 long long rows, int c, int group, int npl, int grid, float eps,
                                 void* stream) {
  const bool groups_ok = group == 4 || group == 8 || group == 16 || group == 32;
  if (rows == 0) return 0;
  if (rows < 0 || c < 1 || grid < 1 || npl < 0 || npl > MAX_NPL ||
      (npl > 0 && (!groups_ok || 4LL * group * npl < c)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(b);
  bf16* yp = static_cast<bf16*>(y);
  const bool vec = c % 4 == 0 && aligned_to(x, 8) && aligned_to(y, 8);
  cudaError_t e;
  switch (npl) {
    case 1: e = launch_npl<1>(vec, grid, s, xp, gp, bp, yp, rows, c, group, eps); break;
    case 2: e = launch_npl<2>(vec, grid, s, xp, gp, bp, yp, rows, c, group, eps); break;
    case 3: e = launch_npl<3>(vec, grid, s, xp, gp, bp, yp, rows, c, group, eps); break;
    case 4: e = launch_npl<4>(vec, grid, s, xp, gp, bp, yp, rows, c, group, eps); break;
    case 5: e = launch_npl<5>(vec, grid, s, xp, gp, bp, yp, rows, c, group, eps); break;
    case 6: e = launch_npl<6>(vec, grid, s, xp, gp, bp, yp, rows, c, group, eps); break;
    default:
      layernorm_wide_kernel<<<grid, THREADS, 0, s>>>(xp, gp, bp, yp, rows, c, eps);
      e = cudaGetLastError();
  }
  return static_cast<int>(e);
}
