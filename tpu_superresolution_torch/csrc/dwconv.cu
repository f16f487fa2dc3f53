// K11 — depthwise 3x3 convolution with SAME zero padding, plus bias.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/cab_conv.py dwconv3x3_halo
//           (pallas_call at :506); oracle its `reference` (:472).
// Math: out[b, i, j, c] = bias[c] + sum over dy, dx in 0..2 of
//       x[b, i + dy - 1, j + dx - 1, c] * k[dy, dx, c]  (zero outside)
//       x, out [B, H, W, C] bf16; k [9, C] tap-major and bias [C] fp32;
//       the sum in fp32, one rounding to bf16 at the end.
// Bound on the H100: 18 FLOP per output element against 4 bytes (bf16
//       in and out): memory-bound.  At the DAT train step's [8, 64, 64,
//       180], 5.9 MB in and 5.9 MB out: 0.0035 ms at 3.35 TB/s each way.
//
// Two routes, chosen by kernels/dwconv.py::dwconv_plan from the shapes
// (and here from the pointers' alignment):
//
// "rows" (shapes whose image row, W * C bf16, is a whole number
//       of 16-byte pieces and whose band, sized for one CTA an SM, has
//       at least 8 rows: the published DAT x4's [25, 64, 64, C]).  In
//       NHWC an image row is one
//       contiguous run of W * C values (23 KB at 64 x 180), and its
//       horizontal neighbours of element e are e - C and e + C, zero
//       outside the run.  A CTA owns a band of `rows` output rows of one
//       image and a segment of `seg` columns (all of W where four input
//       rows fit shared memory), and walks down the band: its input rows
//       (the segment with one pixel each side) arrive in a ring of up to
//       eight buffers by one bulk copy each, completing on an mbarrier, so
//       the next rows are in flight while this one is computed.  A step
//       computes two output rows, whose middle input rows it reads once
//       for both (4 input rows for 2 outputs instead of 6: shared-memory
//       reads, not device memory, bound the step); after each step
//       thread 0 refills the buffers of the rows that fell out of the
//       window.  Thread t computes the 8-element
//       vectors t, t + NT, ... of each output row (16-byte loads and
//       stores, coalesced across the block), the neighbours' vectors at
//       +-C loaded at the alignment C allows (8 bytes at C 180).  NT is a
//       multiple of C / gcd(C, 8), so 8 NT is a multiple of C and every
//       vector of a thread holds the same 8 channels: its 72 taps and 8
//       biases sit in registers (a vector may straddle two pixels; its
//       channels then wrap, which the per-element taps follow).  The
//       output goes out by the threads' 16-byte stores straight from
//       registers: staging a row would need a fifth row of shared memory,
//       which at [25, 64, 64, 360] (46 KB a row) does not fit.  The grid
//       is sized to the SM count (one band a CTA), so each input row is
//       read (rows + 2) / rows times (1.15x at [25, 64, 64, 360]).  A
//       short band pays the wait for its first four rows with nothing to
//       overlap it: at [8, 64, 64, 180] (bands of 4) the tiles kernel is
//       faster, so the plan gives it those shapes.
// "tiles" (the first design; the other shapes, and pointers not 16-byte
//       aligned): one 256-thread block per (image, 8-row tile, 32-column
//       tile, 64-channel chunk) stages the tile's input with its one-pixel
//       halo ([10][34][64] bf16, 43.5 KB) and the chunk's taps and bias in
//       shared memory, then each thread walks one column and vector of V
//       channels down the tile's rows with its 3 x 3 window of input
//       vectors in registers: V = 8 where C % 8 == 0, else 4, 2 or 1, so
//       the vector never straddles a pixel.
#include "common.cuh"
#include "hopper.cuh"

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


// ------------------------------------------------------------ "rows" route

constexpr int MAX_SLOTS = 8;
constexpr int ROWS_MAX_THREADS = 512;
constexpr int ROWS_SMEM = 232448 - 1024;  // the row buffers' shared memory, at most

struct RowArgs {
  const bf16* x;
  const float* k9;
  const float* bias;
  bf16* out;
  int h, w, c;
  int rows;        // output rows a CTA
  int seg;         // columns a CTA
  int slots;       // input-row buffers
  int slot_elems;  // bf16 elements a buffer (a multiple of 64)
  int bands, segs;
};

// Eight bf16 at `p` (aligned to SA elements) as floats.
template <int SA>
__device__ __forceinline__ void load8_at(float (&f)[8], const bf16* p) {
  if constexpr (SA == 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const bf16* e = reinterpret_cast<const bf16*>(&r);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
  } else if constexpr (SA == 4) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint2 r = *reinterpret_cast<const uint2*>(p + 4 * j);
      const bf16* e = reinterpret_cast<const bf16*>(&r);
#pragma unroll
      for (int i = 0; i < 4; ++i) f[4 * j + i] = __bfloat162float(e[i]);
    }
  } else if constexpr (SA == 2) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(p + 2 * j);
      f[2 * j] = __low2float(r);
      f[2 * j + 1] = __high2float(r);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(p[i]);
  }
}

// SA: the alignment, in elements, of the +-C neighbour vectors (8, 4, 2
// or 1: the largest power of two dividing C, at most 8).  PR: output rows
// a step (2: the two rows share their middle input rows, so a step reads
// 4 input rows for 2 outputs, not 6; it needs 4 row buffers).
template <int SA, int PR>
__global__ void __launch_bounds__(ROWS_MAX_THREADS, 1) dwconv3x3_rows_kernel(const RowArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full_bars[MAX_SLOTS];
  const int tid = threadIdx.x, nt = blockDim.x;
  int blk = blockIdx.x;
  const int sg = blk % a.segs;
  blk /= a.segs;
  const int band = blk % a.bands, img = blk / a.bands;
  const int r0 = band * a.rows, r1 = min(a.h, r0 + a.rows);
  const long long wc = static_cast<long long>(a.w) * a.c;
  const int x0 = sg * a.seg, x1 = min(a.w, x0 + a.seg);
  const long long e0 = static_cast<long long>(x0) * a.c, e1 = static_cast<long long>(x1) * a.c;
  // the buffered range of each input row: the segment and one pixel each
  // side, widened to 8-element (16-byte) boundaries
  const long long ls = (e0 - a.c > 0 ? e0 - a.c : 0) & ~7LL;
  const long long le = min(wc, (e1 + a.c + 7) & ~7LL);
  const uint32_t bytes = static_cast<uint32_t>((le - ls) * 2);
  const int y_lo = max(0, r0 - 1), y_hi = min(a.h, r1 + 1);
  const bf16* xin = a.x + static_cast<long long>(img) * a.h * wc + ls;
  const bf16* buf = reinterpret_cast<const bf16*>(smem);
  const uint32_t buf_s = hopper::smem_addr(smem);
  const uint32_t bar0 = hopper::smem_addr(full_bars);
  auto slot_of = [&](int y) { return (y - y_lo) % a.slots; };
  // input row y, indexed by its element in the image row
  auto row_at = [&](int y) { return buf + static_cast<long long>(slot_of(y)) * a.slot_elems - ls; };
  auto issue = [&](int y) {
    const uint32_t bar = bar0 + 8u * slot_of(y);
    hopper::mbar_arrive_expect_tx(bar, bytes);
    hopper::bulk_copy(buf_s + 2u * slot_of(y) * a.slot_elems, xin + y * wc, bytes, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < a.slots; ++s) hopper::mbar_init(bar0 + 8u * s, 1);
    hopper::mbar_init_fence();
    for (int y = y_lo; y < y_hi && y < y_lo + a.slots; ++y) issue(y);
  }
  // this thread's 8 channels (the same for all its vectors) and their
  // taps and biases
  float kr[9][8], br[8];
  {
    int ch = static_cast<int>((8LL * tid) % a.c);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int t = 0; t < 9; ++t) kr[t][i] = a.k9[t * a.c + ch];
      br[i] = a.bias[ch];
      ch = ch + 1 == a.c ? 0 : ch + 1;
    }
  }
  __syncthreads();
  const int nvec = static_cast<int>((e1 - e0) >> 3);
  for (int r = r0; r < r1; r += PR) {
    const int nr = min(PR, r1 - r);  // output rows this step
    // input rows r - 1 .. r + nr (those inside the image) have landed
    for (int y = max(0, r - 1); y <= min(a.h - 1, r + nr); ++y)
      hopper::mbar_wait(bar0 + 8u * slot_of(y), ((y - y_lo) / a.slots) & 1);
    bf16* orow = a.out + (static_cast<long long>(img) * a.h + r) * wc;
    for (int v = tid; v < nvec; v += nt) {
      const long long e = e0 + 8LL * v;
      // each input row's three vectors feed every output row of the step
      // that reads them; each output row sums its taps dy-major, dx = 0,
      // 1, 2, from zero, the bias last: the "tiles" kernel's order, so
      // both routes round alike
      float acc[PR][8];
#pragma unroll
      for (int p = 0; p < PR; ++p)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[p][i] = 0.f;
#pragma unroll
      for (int dy = 0; dy < PR + 2; ++dy) {
        const int y = r + dy - 1;
        if (y < 0 || y >= a.h || dy > nr + 1) continue;
        const bf16* row = row_at(y);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float f[8];
          if (dx == 1) {
            load8_at<8>(f, row + e);
          } else if (dx == 0 ? e >= a.c : e + 8 + a.c <= wc) {
            load8_at<SA>(f, row + e + (dx - 1) * a.c);
          } else {  // the row's first or last pixel: no neighbour that side
            const long long n = e + (dx - 1) * a.c;
#pragma unroll
            for (int i = 0; i < 8; ++i)
              f[i] = n + i >= 0 && n + i < wc ? __bfloat162float(row[n + i]) : 0.f;
          }
#pragma unroll
          for (int p = 0; p < PR; ++p) {
            const int t = dy - p;  // this input row's tap row for output row r + p
            if (t >= 0 && t <= 2 && p < nr) {
#pragma unroll
              for (int i = 0; i < 8; ++i) acc[p][i] += f[i] * kr[3 * t + dx][i];
            }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < PR; ++p) {
        if (p < nr) {
          __align__(16) bf16 o[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) o[i] = __float2bfloat16(acc[p][i] + br[i]);
          *reinterpret_cast<uint4*>(orow + p * wc + e) = *reinterpret_cast<const uint4*>(o);
        }
      }
    }
    __syncthreads();  // every thread is done with input rows r - 1 .. r + nr - 2
    if (tid == 0) {
      for (int y = r - 1; y < r + nr - 1; ++y) {
        if (y >= y_lo && y + a.slots < y_hi) {
          hopper::fence_proxy_async();  // the buffer's generic reads, before the bulk copy's writes
          issue(y + a.slots);
        }
      }
    }
  }
}

template <int SA, int PR>
cudaError_t launch_rows(const RowArgs& a, int b, int threads, cudaStream_t s) {
  auto kernel = dwconv3x3_rows_kernel<SA, PR>;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once: the largest ring
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ROWS_SMEM);
  if (attr != cudaSuccess) return attr;
  kernel<<<b * a.bands * a.segs, threads, a.slots * a.slot_elems * 2, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// geom: {B, H, W, C, threads, rows, seg, slots, slot_elems, step}
// (kernels/dwconv.py::dwconv_plan; one pointer, so that a launch converts
// six arguments, not fourteen).  threads 0: the "tiles" route; else the
// "rows" route with `threads` threads a CTA, `rows` output rows and `seg`
// columns a CTA, `slots` row buffers of `slot_elems` elements.
extern "C" int sr_dwconv3x3_bf16(const void* x, const void* k9, const void* bias, void* out,
                                 const int* geom, void* stream) {
  const int b = geom[0], h = geom[1], w = geom[2], c = geom[3], threads = geom[4],
            rows = geom[5], seg = geom[6], slots = geom[7], slot_elems = geom[8],
            step = geom[9];
  if (b < 0 || h < 0 || w < 0 || c < 1 || b > 65535 || (h + TR - 1) / TR > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(b) * h * w == 0) return 0;
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* op = static_cast<bf16*>(out);
  const float* kp = static_cast<const float*>(k9);
  const float* bp = static_cast<const float*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads > 0 && aligned_to(x, 16) && aligned_to(out, 16)) {
    const int g = c % 8 == 0 ? 8 : c % 4 == 0 ? 4 : c % 2 == 0 ? 2 : 1;
    if (threads > ROWS_MAX_THREADS || (threads * 8) % c || rows < 1 || seg < 1 || slots < 3 ||
        slots > MAX_SLOTS || (step != 1 && step != 2) || (step == 2 && slots < 4) ||
        (static_cast<long long>(w) * c) % 8 || (seg * c) % 8 ||
        slot_elems % 64 || static_cast<long long>(slots) * slot_elems * 2 > ROWS_SMEM ||
        static_cast<long long>(seg + 2) * c + 14 > slot_elems)
      return static_cast<int>(cudaErrorInvalidValue);
    RowArgs a;
    a.x = xp;
    a.k9 = kp;
    a.bias = bp;
    a.out = op;
    a.h = h;
    a.w = w;
    a.c = c;
    a.rows = rows;
    a.seg = seg;
    a.slots = slots;
    a.slot_elems = slot_elems;
    a.bands = (h + rows - 1) / rows;
    a.segs = (w + seg - 1) / seg;
    cudaError_t err;
    const bool two = step == 2;
    if (g == 8)
      err = two ? launch_rows<8, 2>(a, b, threads, s) : launch_rows<8, 1>(a, b, threads, s);
    else if (g == 4)
      err = two ? launch_rows<4, 2>(a, b, threads, s) : launch_rows<4, 1>(a, b, threads, s);
    else if (g == 2)
      err = two ? launch_rows<2, 2>(a, b, threads, s) : launch_rows<2, 1>(a, b, threads, s);
    else
      err = two ? launch_rows<1, 2>(a, b, threads, s) : launch_rows<1, 1>(a, b, threads, s);
    return static_cast<int>(err);
  }
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
