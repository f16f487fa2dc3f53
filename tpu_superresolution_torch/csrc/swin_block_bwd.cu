// K5 and K6's backward — the backward of one Swin transformer block (the
// gradient of csrc/swin_block.cu), for window size 8 (K5) or 7 (K6b), with
// the gradient of HAT's additive term `extra`, on Hopper's wgmma.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_block.py
//           K5  _mega_backward -> _bwd_kernel (pallas_call at :1080),
//               with and without `extra` (has_extra);
//           K6b _packed_backward -> _bwd_kernel (pallas_call at :1604),
//               the same arithmetic on windows the caller partitioned and
//               token-padded in HBM.  This kernel reads the windows from
//               the spatial map, so one source serves both.
// Math: recompute the forward for each window (LN1 -> qkv -> per-head
//       softmax(q k^T + rpb + mask) -> AV -> proj -> x1 = x + m1 attn
//       + extra -> LN2 -> fc1 -> GELU), then chain the cotangent ct:
//         dmlp = bf16(ct m2)        dWfc2 = dmlp^T a,   dbfc2 = sum dmlp
//         dh1  = bf16(dmlp Wfc2 * gelu'(h1))   dWfc1, dbfc1
//         dx1  = ct + LN2^T(dh1 Wfc1)  (fast-variance form; dg2, db2)
//         dextra = dx1  (when the forward had `extra`)
//         dattn = bf16(dx1 m1)      dWproj, dbproj
//         do   = bf16(dattn Wproj); per head: dV = A^T do,
//                dS = A (dA - rowsum(dA A)) with dA = do V^T,
//                dQ = dS K, dK = dS^T Q (dS, dq, dk, dv in bf16)
//         dx   = dx1 + LN1^T(dqkv Wqkv)     dWqkv, dbqkv, dg1, db1
//       with bf16 GEMM operands and fp32 accumulation, casting to bf16
//       at the JAX kernel's points, so the kernel and the plain bf16
//       version (kernels/fused_block.py::swin_block_bwd_plain) round
//       alike.  The weight gradients come out in the layout of the
//       forward's weight stream (``pack_block_tiles``: q pre-scaled,
//       heads and widths zero-padded, 128B-swizzled [N, 64] tiles); the
//       wrapper folds them to raw weight space (``fold_block_grads``).
// Bound on the H100: at SwinIR's train shape [8,64,64,180] the block's
//       backward does ~51 GFLOP of bf16 products at the unpadded widths
//       (14 recompute without fc2, 17 activation gradients, 3 attention
//       backward, 17 the four weight-gradient products) against ~37 MB
//       in and out, so it is compute-bound: ~52 us at the 989 TFLOP/s
//       bf16 peak; HAT's at [8,70,70,96] ~25 GFLOP, ~26 us.
// Design: three launches, all deterministic (static schedules, ordered
//       sums, no atomics):
//   K5a ``swin_block_bwd_kernel``: persistent CTAs of 384 threads, one an
//       SM, walk window pairs as the forward does: consumer warpgroups 0
//       and 1 each own a window's 64 token rows as one wgmma m64 tile;
//       warpgroup 2 (one thread; setmaxnreg 40 / 232) streams the
//       forward's own ``pack_block_tiles`` tiles through an mbarrier ring
//       in the backward's order: qkv, proj (recompute); per hidden chunk
//       fc1, fc2, fc1; proj; qkv (the heads' recompute); qkv (dy).  The
//       products Y W^T read a tile as a K-major B, the products dY W read
//       the same bytes as an MN-major B (the transpose bit), so one
//       stream serves both directions.  Per window:
//         F1  x -> LN1 -> yc (A buffer); per head qkv, Q K^T, the bias
//             from the [nh, (2ws-1)^2] table + one code a token, softmax,
//             P V -> O (R buffer);
//         F2  x1 = x + m1 (O Wproj + b) + extra (fp32, to a per-CTA
//             scratch), LN2 -> y2c (A buffer); dmlp -> R buffer;
//         M   per 64-column hidden chunk: h1 = y2c Wfc1^T (recompute),
//             act, gelu'(h1); dmlp Wfc2 (MN-major B) -> dh1 in registers,
//             the A fragments of dy2 += dh1 Wfc1 (MN-major B);
//         L2  LN2 backward in dy2's registers: dx1 (to the scratch),
//             dextra, dattn -> A buffer;
//         P   do = dattn Wproj (MN-major B) -> the heads' [64, hdp] tiles
//             in the R buffer;
//         A2  yc again; per head: qkv again; S, P, dA = do V^T, dS, dQ =
//             dS K in the query rows; then S^T, P^T, dP^T = V do^T, dS^T,
//             dK = dS^T Q and dV = P^T do in the key rows (the softmax
//             row statistics through shared memory), so every operand is
//             a register fragment or a swizzled tile;
//         D   dy = sum over heads of dqkv_h Wqkv_h (MN-major B, A
//             fragments read back from the workspace), LN1 backward, dx.
//       The dW operand pairs (yc, dqkv), (o, dattn), (y2c, dh1), (act,
//       dmlp) go to a bf16 workspace as [64 tokens, 64] 128B-swizzled
//       tiles, a window's 64 tokens one K step of K5b; the five that sit
//       whole in the A or R buffer (yc, o, y2c, dmlp, dattn) leave by
//       bulk copies, the others from registers.  The LN sums go
//       to per-(CTA, warp) fp32 partials, d(rpb) to a per-(CTA,
//       warpgroup) [nh, 64, 64] fp32 partial; each thread owns its
//       entries, so the read-modify-writes need no ordering.  A tile's
//       loads from the scratch, the cotangent and the partials are issued
//       together before the stores that follow them (the compiler keeps a
//       load behind a store that may alias it: a round trip each, PERF.md
//       §6); bf16 pairs of the maps are loaded and stored without a branch
//       on C's parity (with one, the width-192 files took minutes to
//       build; without, seconds).  The kernel is latency-bound (two warps
//       a scheduler, each small product waited for).
//   K5b ``wgrad_wg_kernel``: dW = dY^T X for the four products as a wgmma
//       GEMM over tokens, both operands token-major (A and B MN-major),
//       64 x <= 192 output tiles, split over windows; a producer warp
//       bulk-copies the workspace's 8 KB tiles through a 3-stage ring;
//       each split writes an fp32 partial in the weight stream's layout,
//       and the bias sums db = dY^T 1 after it (a tile of ones as one
//       more B: the column sums K5a would otherwise reduce per window).
//   K5c ``reduce_ordered_kernel``: the splits', the warps' and the
//       warpgroups' partials summed in a fixed order.
// Token padding (ws 7): every window keeps 64 token rows.  Rows 49..63
//       have zero x and zero cotangent, so every gradient operand (dmlp,
//       dh1, dattn, do, dqkv) is exactly zero there and adds nothing to a
//       weight-gradient product, bias sum or LayerNorm sum; their
//       activations stay finite.  Keys 49..63 score -inf, so A and dS are
//       0 there; in the key-row pass, pad keys and pad queries give P^T 0.
#include "swin_block_bwd.cuh"

namespace swin_bwd {

// K5a's instantiations, each compiled in its own file
extern template int launch_window<7, 96, 16>(const Args&, int, cudaStream_t);
extern template int launch_window<7, 96, 32>(const Args&, int, cudaStream_t);
extern template int launch_window<7, 192, 32>(const Args&, int, cudaStream_t);
extern template int launch_window<8, 96, 16>(const Args&, int, cudaStream_t);
extern template int launch_window<8, 96, 32>(const Args&, int, cudaStream_t);
extern template int launch_window<8, 192, 32>(const Args&, int, cudaStream_t);

template <int WS>
int launch_window_ws(const Args& a, int cp, int hdp, int grid, cudaStream_t s) {
  if (cp == 96 && hdp == 16) return launch_window<WS, 96, 16>(a, grid, s);
  if (cp == 96 && hdp == 32) return launch_window<WS, 96, 32>(a, grid, s);
  if (cp == 192 && hdp == 32) return launch_window<WS, 192, 32>(a, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------------ K5b
// dW = dY^T X of the four products, token-major operands in the
// workspace's [64 tokens, 64] tiles; a unit is one 64-row tile of dW's
// rows (dY's columns) by up to three 64-column tiles of X, over a split
// of the windows.  Its fp32 partial goes to the weight stream's layout.
// A unit of the first X group also sums dY's columns, db = dY^T 1 (a
// resident tile of ones as one more B), into the bias vector's layout
// after the stream.
constexpr int WG_CONS = 128;
constexpr int WG_THREADS = WG_CONS + 32;  // + a producer warp
constexpr int WG_STAGES = 3;
constexpr int WG_STAGE = 4 * 8192;  // the dY tile and <= 3 X tiles
constexpr int WG_SMEM = 1024 + WG_STAGES * WG_STAGE + 8192 + 2 * WG_STAGES * 8;  // + the ones

struct WGemm {
  const bf16* dy;  // workspace operand: [windows][dy_tiles][64][64]
  const bf16* x;   // [windows][x_tiles][64][64]
  int dy_tiles, x_tiles;
  int n_groups;  // of <= 3 X tiles; a unit per (dY tile, group)
  int kind;  // 0 qkv, 1 proj, 2 fc1, 3 fc2
  int bias_off, bias_rows;  // its bias in the bias vector: [bias_off, + bias_rows)
};

struct WArgs {
  WGemm g[4];
  int unit0[5];  // first unit of each product
  int windows, splits;
  int nh, hdp, kc, nhalf, pw;  // pw: rows of the proj's and fc2's N parts
  long long stream_len;  // elements of the weight stream
  long long row_len;     // a split's partial: the stream, then the bias vector
  float* part;           // [splits][row_len]
};

// Offset in the weight stream (pack_block_tiles' layout, N parts of pw
// rows: 96, or 128 at K5r's cp 256) of dW's entry
// (row m, column n) of product `kind`, or -1 where the stream has none.
__device__ __forceinline__ long long stream_offset(const WArgs& a, int kind, int m, int n) {
  const int q3 = 3 * a.hdp;
  const long long p0 = static_cast<long long>(a.nh) * a.kc * q3 * 64;
  const long long p1 = p0 + static_cast<long long>(a.nhalf) * a.kc * a.pw * 64;
  const long long chunk = static_cast<long long>(a.kc) * 4096 + a.nhalf * a.pw * 64;
  auto swz = [](int r, int k) { return ((((k >> 3) ^ r) & 7) << 3) | (k & 7); };
  if (kind == 0) {  // rows h 3 hdp + r, columns kc 64 + k
    const int h = m / q3, r = m - h * q3;
    if (h >= a.nh) return -1;
    return (static_cast<long long>(h) * a.kc + (n >> 6)) * q3 * 64 + r * 64 + swz(r, n & 63);
  }
  if (kind == 2) {  // hidden rows j 64 + r
    const int j = m >> 6, r = m & 63;
    return p1 + j * chunk + (n >> 6) * 4096 + r * 64 + swz(r, n & 63);
  }
  // proj / fc2: out rows hf pw + r (m < 256, so hf <= 2: no division)
  const int hf = (m >= a.pw) + (m >= 2 * a.pw), r = m - hf * a.pw;
  if (hf >= a.nhalf) return -1;
  if (kind == 1) return p0 + (static_cast<long long>(hf) * a.kc + (n >> 6)) * a.pw * 64 + r * 64 +
                        swz(r, n & 63);
  return p1 + (n >> 6) * chunk + static_cast<long long>(a.kc) * 4096 + hf * a.pw * 64 + r * 64 +
         swz(r, n & 63);
}

template <int NN, bool ONES>
__device__ __forceinline__ void wgrad_mainloop(float (&acc)[3][32], float (&accb)[32],
                                               uint32_t ring, uint32_t ones, uint32_t bars,
                                               int nw, int lane) {
  for (int i = 0; i < nw; ++i) {
    const int st = i % WG_STAGES;
    hopper::mbar_wait(bars + 8u * st, (i / WG_STAGES) & 1);
    const uint32_t at = ring + st * WG_STAGE;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hopper::desc_sw128(at + kk * 2048);
#pragma unroll
      for (int t = 0; t < NN; ++t)
        Wgmma64T<1, 1>::mma(acc[t], da, hopper::desc_sw128(at + (t + 1) * 8192 + kk * 2048), 1);
      if (ONES) Wgmma64T<1, 1>::mma(accb, da, hopper::desc_sw128(ones + kk * 2048), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (i > 0 && lane == 0) hopper::mbar_arrive(bars + 8u * (WG_STAGES + (i - 1) % WG_STAGES));
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < 3; ++t) hopper::fence_operands(acc[t]);
  hopper::fence_operands(accb);
}

__global__ void __launch_bounds__(WG_THREADS, 2) wgrad_wg_kernel(const WArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t ones = ring + WG_STAGES * WG_STAGE;  // [64, 64] bf16 ones
  const uint32_t bars = ones + 8192;                   // full[3], empty[3]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x % a.splits, unit = blockIdx.x / a.splits;
  int gi = 0;
  while (gi < 3 && unit >= a.unit0[gi + 1]) ++gi;
  const WGemm g = a.g[gi];
  const int local = unit - a.unit0[gi];
  const int mt = local / g.n_groups, nt0 = 3 * (local % g.n_groups);
  const int nn = g.x_tiles - nt0 < 3 ? g.x_tiles - nt0 : 3;
  const int wbeg = static_cast<int>(static_cast<long long>(a.windows) * split / a.splits);
  const int wend = static_cast<int>(static_cast<long long>(a.windows) * (split + 1) / a.splits);
  const int nw = wend - wbeg;
  const bool with_bias = nt0 == 0;
  if (with_bias) {
    for (int i = tid; i < 8192 / 4; i += WG_THREADS) st32(ones + 4 * i, 0x3f803f80u);  // bf16 1, 1
    hopper::fence_proxy_async();
  }
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      hopper::mbar_init(bars + 8u * s, 1);
      hopper::mbar_init(bars + 8u * (WG_STAGES + s), 4);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (warp == 4) {  // the producer: one thread's bulk copies
    if (lane != 0) return;
    for (int i = 0; i < nw; ++i) {
      const int st = i % WG_STAGES, w = wbeg + i;
      hopper::mbar_wait(bars + 8u * (WG_STAGES + st), ((i / WG_STAGES) & 1) ^ 1);
      const uint32_t full = bars + 8u * st, at = ring + st * WG_STAGE;
      hopper::mbar_arrive_expect_tx(full, 8192u * (1 + nn));
      hopper::bulk_copy(at, g.dy + (static_cast<size_t>(w) * g.dy_tiles + mt) * TILE_ELEMS, 8192,
                        full);
      for (int t = 0; t < nn; ++t)
        hopper::bulk_copy(at + (t + 1) * 8192,
                          g.x + (static_cast<size_t>(w) * g.x_tiles + nt0 + t) * TILE_ELEMS,
                          8192, full);
    }
    return;
  }
  float acc[3][32], accb[32];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[t][e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) accb[e] = 0.f;
  if (with_bias) {
    if (nn == 3)
      wgrad_mainloop<3, true>(acc, accb, ring, ones, bars, nw, lane);
    else if (nn == 2)
      wgrad_mainloop<2, true>(acc, accb, ring, ones, bars, nw, lane);
    else
      wgrad_mainloop<1, true>(acc, accb, ring, ones, bars, nw, lane);
  } else {
    if (nn == 3)
      wgrad_mainloop<3, false>(acc, accb, ring, ones, bars, nw, lane);
    else if (nn == 2)
      wgrad_mainloop<2, false>(acc, accb, ring, ones, bars, nw, lane);
    else
      wgrad_mainloop<1, false>(acc, accb, ring, ones, bars, nw, lane);
  }
  float* out = a.part + static_cast<long long>(split) * a.row_len;
  const int q = lane & 3, row = 64 * mt + 16 * warp + (lane >> 2);
  if (with_bias && q == 0) {  // column 0 of dY^T 1: the rows' sums
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int m = row + 8 * h2;
      if (m < g.bias_rows) out[a.stream_len + g.bias_off + m] = accb[2 * h2];
    }
  }
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (t >= nn) break;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int m = row + 8 * ((e >> 1) & 1);
      const int n = 64 * (nt0 + t) + 8 * (e >> 2) + 2 * q + (e & 1);
      const long long off = stream_offset(a, g.kind, m, n);
      if (off >= 0) out[off] = acc[t][e];
    }
  }
}

// ------------------------------------------------------------------ K5c
// out[j] = sum_r part[r][j] for three segments (RSeg), rows summed in a
// fixed order: 8 slices of rows in order, then the slices in order.
constexpr int RED_SLICES = 8;

__global__ void __launch_bounds__(32 * RED_SLICES) reduce_ordered_kernel(RSeg s0, RSeg s1,
                                                                         RSeg s2) {
  const RSeg s = blockIdx.y == 0 ? s0 : blockIdx.y == 1 ? s1 : s2;
  __shared__ float red[RED_SLICES][33];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const long long col = static_cast<long long>(blockIdx.x) * 32 + lane;
  float acc = 0.f;
  if (col < s.cols) {
    const long long r0 = s.rows * slice / RED_SLICES, r1 = s.rows * (slice + 1) / RED_SLICES;
    for (long long r = r0; r < r1; ++r) acc += s.part[r * s.cols + col];
  }
  red[slice][lane] = acc;
  __syncthreads();
  if (slice == 0 && col < s.cols) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < RED_SLICES; ++i) t += red[i][lane];
    s.out[col] = t;
  }
}

int launch_wgrad_reduce(const Args& a, long long units, int cp, int hdp, int splits, float* pw,
                        float* wgrad, float* vec, const RSeg& ln, const RSeg& rpb,
                        cudaStream_t s) {
  const int pwid = part_width(cp), kc = (cp + 63) / 64, nhalf = cp / pwid, q3 = 3 * hdp;
  WArgs w;
  // (dY, X, kind): qkv (dqkv, yc), proj (dattn, o), fc1 (dh1, y2c), fc2 (dmlp, act);
  // their biases in pack_block_tiles' bias layout: bqkv | bproj | bfc1 | bfc2
  const int nq = a.nh * q3, hid = a.chunks * HC;
  const int bias_offs[4] = {0, nq, nq + cp, nq + cp + hid};
  const int bias_rows[4] = {nq, cp, hid, cp};
  const long long bias_len = nq + 2LL * cp + hid;
  const int dys[4] = {OP_DQKV, OP_DATTN, OP_DH1, OP_DMLP};
  const int xs[4] = {OP_YC, OP_O, OP_Y2C, OP_ACT};
  int n_units = 0;
  for (int i = 0; i < 4; ++i) {
    WGemm& g = w.g[i];
    g.dy = a.op[dys[i]];
    g.x = a.op[xs[i]];
    g.dy_tiles = a.op_tiles[dys[i]];
    g.x_tiles = a.op_tiles[xs[i]];
    g.n_groups = (g.x_tiles + 2) / 3;
    g.kind = i;
    g.bias_off = bias_offs[i];
    g.bias_rows = bias_rows[i];
    w.unit0[i] = n_units;
    n_units += g.dy_tiles * g.n_groups;
  }
  w.unit0[4] = n_units;
  w.windows = static_cast<int>(units);
  w.splits = splits;
  w.nh = a.nh;
  w.hdp = hdp;
  w.kc = kc;
  w.nhalf = nhalf;
  w.pw = pwid;
  w.stream_len = static_cast<long long>(a.nh) * kc * q3 * 64 + nhalf * kc * pwid * 64 +
                 static_cast<long long>(a.chunks) * (kc * 4096 + nhalf * pwid * 64);
  w.row_len = w.stream_len + bias_len;
  w.part = pw;
  static const cudaError_t wattr = cudaFuncSetAttribute(
      wgrad_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (wattr != cudaSuccess) return static_cast<int>(wattr);
  wgrad_wg_kernel<<<n_units * splits, WG_THREADS, WG_SMEM, s>>>(w);
  const int status = static_cast<int>(cudaGetLastError());
  if (status != 0) return status;

  // the weight stream's and the biases' gradients are contiguous in
  // [wgrad | vec]; the LN sums follow the biases in vec
  const RSeg segs[3] = {{pw, splits, w.row_len, wgrad}, ln, rpb};
  long long cols = 0;
  for (const RSeg& sg : segs) cols = sg.cols > cols ? sg.cols : cols;
  reduce_ordered_kernel<<<dim3(static_cast<unsigned>((cols + 31) / 32), 3), 32 * RED_SLICES, 0,
                          s>>>(segs[0], segs[1], segs[2]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swin_bwd

using namespace swin_bwd;

// K5a, K5b and K5c on one stream.  ct, x, extra (or null), dx, dextra
// [batch, h, w, c] bf16; tiles, biases, LN params, table and codes as
// kernels/fused_block.py ``pack_block_tiles`` and ops/window.py
// ``window_codes_tensor`` lay them out; scales [batch, 2] or null.
// Workspaces (kernels/fused_block.py ``bwd_plan`` sizes them): ws the dW
// operands, x1ws, pvec, prpb, pw (the splits' partials); outputs wgrad
// (the weight stream's layout, fp32) with vec right after it (the bias
// sums in pack_block_tiles' bias layout, then the LN sums) and rpb [nh,
// 64, 64].  geo: batch, h, w, c, nh, hidden, ws, shift, shifted, cp,
// hdp, stages, gelu_tanh, grid, splits (the plan; this entry checks it).
extern "C" int sr_swin_block_bwd_bf16(const void* ct, const void* x, const void* extra, void* dx,
                                      void* dextra, const void* tiles, const void* bqkv,
                                      const void* bproj, const void* bfc1, const void* bfc2,
                                      const void* g1, const void* b1, const void* g2,
                                      const void* b2, const void* table, const void* codes,
                                      const void* scales, void* ws, void* x1ws, void* pvec,
                                      void* prpb, void* pw, void* vec, void* rpb, void* wgrad,
                                      const int* geo, float eps, void* stream) {
  Args a{};
  a.batch = geo[0];
  a.h = geo[1];
  a.w = geo[2];
  a.c = geo[3];
  a.nh = geo[4];
  const int hidden = geo[5], wsz = geo[6];
  a.shift = geo[7];
  a.shifted = geo[8];
  const int cp = geo[9], hdp = geo[10];
  a.stages = geo[11];
  a.gelu_tanh = geo[12];
  const int grid = geo[13], splits = geo[14];
  a.chunks = (hidden + HC - 1) / HC;
  a.eps = eps;
  const long long windows =
      wsz > 0 ? static_cast<long long>(a.batch) * (a.h / wsz) * (a.w / wsz) : 0;
  const long long pairs = (windows + NCONS - 1) / NCONS;
  if ((wsz != 7 && wsz != 8) || a.c < 1 || a.c > cp || a.nh < 1 || a.nh > MAX_HEADS ||
      a.c % a.nh || a.c / a.nh > hdp || a.nh * hdp > cp || hidden < 1 || hidden > 384 ||
      a.h % wsz || a.w % wsz || a.shift < 0 || a.shift >= wsz || grid < 1 ||
      (pairs > 0 && grid > pairs) || splits < 1 || (windows > 0 && splits > windows) ||
      !aligned_to(tiles, 16) || !aligned_to(bqkv, 8) || !aligned_to(bproj, 8) ||
      !aligned_to(bfc1, 8) || !aligned_to(bfc2, 8) || !aligned_to(ws, 16) ||
      !aligned_to(x1ws, 16) || !aligned_to(pvec, 8) || !aligned_to(prpb, 8) ||
      (a.c % 2 == 0 && !(aligned_to(x, 4) && aligned_to(ct, 4) && aligned_to(dx, 4) &&
                         (!extra || (aligned_to(extra, 4) && aligned_to(dextra, 4))))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (windows == 0) return 0;
  a.ct = static_cast<const bf16*>(ct);
  a.x = static_cast<const bf16*>(x);
  a.extra = static_cast<const bf16*>(extra);
  a.dx = static_cast<bf16*>(dx);
  a.dextra = static_cast<bf16*>(dextra);
  a.tiles = static_cast<const bf16*>(tiles);
  a.bqkv = static_cast<const float*>(bqkv);
  a.bproj = static_cast<const float*>(bproj);
  a.bfc1 = static_cast<const float*>(bfc1);
  a.bfc2 = static_cast<const float*>(bfc2);
  a.g1 = static_cast<const float*>(g1);
  a.b1 = static_cast<const float*>(b1);
  a.g2 = static_cast<const float*>(g2);
  a.b2 = static_cast<const float*>(b2);
  a.table = static_cast<const float*>(table);
  a.codes = static_cast<const int*>(codes);
  a.scales = static_cast<const float*>(scales);
  const int kc = (cp + 63) / 64, q3 = 3 * hdp;
  const int qt = (a.nh * q3 + 63) / 64;
  const int tiles_of[N_OPS] = {kc, kc, kc, a.chunks, qt, kc, a.chunks, kc};
  bf16* p = static_cast<bf16*>(ws);
  for (int o = 0; o < N_OPS; ++o) {
    a.op[o] = p;
    a.op_tiles[o] = tiles_of[o];
    p += windows * tiles_of[o] * TILE_ELEMS;
  }
  a.x1ws = static_cast<float*>(x1ws);
  a.pvec = static_cast<float*>(pvec);
  a.prpb = static_cast<float*>(prpb);
  a.vl = 4 * cp;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int status = wsz == 7 ? launch_window_ws<7>(a, cp, hdp, grid, s)
                        : launch_window_ws<8>(a, cp, hdp, grid, s);
  if (status != 0) return status;

  const long long bias_len = a.nh * q3 + 2LL * cp + a.chunks * HC;
  return launch_wgrad_reduce(
      a, windows, cp, hdp, splits, static_cast<float*>(pw), static_cast<float*>(wgrad),
      static_cast<float*>(vec),
      {static_cast<const float*>(pvec), static_cast<long long>(grid) * NCONS * 4, a.vl,
       static_cast<float*>(vec) + bias_len},
      {static_cast<const float*>(prpb), static_cast<long long>(grid) * NCONS,
       static_cast<long long>(a.nh) * 4096, static_cast<float*>(rpb)},
      s);
}
