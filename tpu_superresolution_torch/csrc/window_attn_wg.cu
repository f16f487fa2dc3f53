// K15 on Hopper's wgmma — window attention on pre-split q, k, v
// (the "wgmma" route of kernels/window_attention.py::k15_route).
//
// Replaces: tpu_superresolution_tpu/ops/pallas/window_attention.py
//           fused_window_attention (pallas_call at :193; K15, HAT's OCAB
//           at serving); oracle window_attention_reference (:229).
// Math (per window w and head h, hd <= 64, Nk <= 256, no mask):
//         out[w, h] = softmax(scale * q[w, h] k[w, h]^T + bias[h]) v[w, h]
//       q, out [BW, nH, Nq, hd] and k, v [BW, nH, Nk, hd] bf16; bias
//       [nH, Nq, Nk] fp32; scores and softmax in fp32 (in the log2
//       domain: scores times log2(e), exp2).  HAT's zero overlap rows
//       are real keys.
// Design: a persistent grid of nH x G CTAs (G = SMs / nH, at most the
//       window count): CTA (h, g) walks windows g, g + G, ... of head h
//       ("head-major"), so the head's fp32 bias [Nq, Nk] (pre-multiplied
//       by log2 e) is loaded into shared memory once per CTA (19.6 KB at
//       HAT's 49 x 100, 36.9 KB at hat_fast's 64 x 144), not re-read from
//       L2 by every unit as the tiled kernel does (~294 MB a HAT call).
//       Warpgroup 2 is the producer (setmaxnreg: it gives its registers
//       to the consumers): it fills a ring of up to four stages, one
//       (window, head) unit each, with the unit's q, k and v: each a
//       contiguous run of N x hd bf16 in device memory, repacked by
//       cp.async (16 bytes where hd % 8 == 0, else 4 or, at odd hd, 2 by
//       plain loads) into the swizzled [rows][HDP] layout wgmma reads
//       (HDP = hd rounded up to 16, 32 or 64; rows of 32, 64 or 128 bytes
//       under the matching 32B / 64B / 128B swizzle), completing on the
//       stage's full mbarrier.  A bulk copy cannot do that repack (it
//       writes bytes verbatim, and wgmma needs the swizzle).  The ring is
//       zeroed once, and the producer writes only real rows and dims, so
//       pad rows and dims stay zero (slices past the keys read a zero
//       tile, so that no wgmma sits in a branch: ptxas serialises those).
//       Warpgroups 0 and 1 consume alternate units: S = Q K^T as wgmma
//       m64n16k16 on 16-key slices (hd / 16 k-steps, one at hd 16), so a
//       query tile's whole row of up to 256 keys sits in registers and its
//       softmax is a plain one.  The head's bias is held as a padded table
//       (times log2 e, -inf past Nk, 0 past Nq, rows 8 banks apart), and a
//       unit takes the fewest slices that hold the keys (4, 7, 8, 9, 12 or
//       16: 7 for HAT's 100 keys, 9 for hat_fast's 144), so a score costs
//       one FMA and half a float2 load.  O = P V as wgmma with P from
//       registers (rounded to bf16 once) and V from shared memory as a
//       transposed (MN-major) B.  Nq > 64 runs 64-row query tiles one after
//       another on the unit's stage.  The output tile is staged in shared
//       memory and written by one bulk copy where hd % 8 == 0 (a unit's
//       rows are one contiguous run), else by coalesced stores.
//       The kernel takes only unmasked units of at most 256 keys with P
//       rounded once whose table fits beside two stages (HAT's OCABs at
//       every head dim to 64): there it is the fastest of the kernels;
//       with a mask, split P or more keys the square, stream or tiled
//       kernel is faster (chip_smoke.py's route check), and k15_route
//       sends those shapes there.
// Bound on the H100 (4 Nk hd FLOP a query row; q, k, v, out in bf16, the
//       bias once): memory-bound.  HAT's OCAB at the bench batch
//       ([2500, 6, 49, 16] against 100 keys): 143 MB, 0.0427 ms; hat_fast
//       ([1600, 6, 64, 16] x 144): 128 MB, 0.0382 ms.  The exp2 of every
//       score (7.4M rows x 112 at HAT) is the next limit (~0.03 ms of the
//       SFU at 16 a clock an SM).
#include <cstdint>

#include "window_attn_wg.cuh"

namespace {

using namespace wg_attn;

constexpr int QT = 64;             // query rows a tile (wgmma's M)
constexpr int NCONS = 2;           // consumer warpgroups
constexpr int NTHREADS = 128 * (NCONS + 1);  // + the producer warpgroup
constexpr int PRODUCER_REGS = 72;  // setmaxnreg: 128 x 72 + 256 x 216 <= 64K
constexpr int CONSUMER_REGS = 216;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;
// 16-key slices a unit: the compiled counts (the smallest that holds Nk)
constexpr int SLICES[] = {4, 7, 8, 9, 12, 16};

struct Args {
  const bf16* q;       // [BW, nh, nq, hd]
  const bf16* k;       // [BW, nh, nk, hd]
  const bf16* v;
  const float* bias;   // [nh, nq, nk]
  bf16* out;           // [BW, nh, nq, hd]
  int bw, nh, nq, nk, hd;
  int per_head;        // CTAs a head (G)
  int vec;             // elements a copy: 8, 2 or 1
  int stages;          // ring stages (even: each consumer reuses its own)
  int bulk_out;
  int ldb;             // the bias table's row stride (floats)
  float scale_log2;    // scale * log2(e)
  uint32_t q_bytes, kv_bytes, stage_bytes, staging_bytes, bias_bytes;
};

// HDP: padded head dim.  NS: 16-key slices a unit (Nk <= 16 NS); the
// bias in shared memory as a padded table pre-multiplied by log2 e (-inf
// past Nk, 0 past Nq), so the scores need no tests.
template <int HDP, int NS>
__global__ void __launch_bounds__(NTHREADS, 1) window_attn_wg_kernel(const Args a) {
  constexpr int RB = HDP * 2;  // bytes a row of a q, k or v part
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t zero_tile = ring + a.stages * a.stage_bytes;  // 16 zero rows (2 KB)
  const uint32_t staging = zero_tile + 2048u;
  const uint32_t sbias_at = staging + a.staging_bytes;
  const uint32_t bars = sbias_at + a.bias_bytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (MAX_STAGES + s); };
  float* sbias = reinterpret_cast<float*>(smem_raw + (sbias_at - raw));
  const long long plane = static_cast<long long>(a.nq) * a.nk;
  const float neg_inf = -__int_as_float(0x7f800000);

  const int tid = threadIdx.x;
  const int h = blockIdx.x / a.per_head, g = blockIdx.x % a.per_head;
  const int nqt = (a.nq + QT - 1) / QT;
  {
    // [nqt * 64][ldb] fp32: bias * log2 e; -inf past Nk; 0 past Nq
    const float* src = a.bias + h * plane;
    const int rows = nqt * QT;
    for (int i = tid; i < rows * a.ldb; i += NTHREADS) {
      const int r = i / a.ldb, c = i - r * a.ldb;
      sbias[i] = c >= a.nk ? neg_inf : r < a.nq ? src[r * a.nk + c] * LOG2E : 0.f;
    }
  }
  // zero the ring and the zero tile: the producer writes real rows and
  // dims only
  for (uint32_t i = tid * 16u; i < a.stages * a.stage_bytes + 2048u; i += NTHREADS * 16u)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(ring + i), "r"(0u)
                 : "memory");
  hopper::fence_proxy_async();  // the zeros, before wgmma reads them
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      hopper::mbar_init(full(s), 128);   // every producer thread's copies
      hopper::mbar_init(empty(s), 128);  // the consuming warpgroup's threads
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int n_units = (a.bw - g + a.per_head - 1) / a.per_head;  // windows g, g + G, ...
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform role
  if (wg == NCONS) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int t = tid - 128 * NCONS;
    for (int i = 0; i < n_units; ++i) {
      const int s = i % a.stages;
      if (i >= a.stages) hopper::mbar_wait(empty(s), ((i / a.stages) - 1) & 1);
      const long long wh = static_cast<long long>(g + i * a.per_head) * a.nh + h;
      const uint32_t qd = ring + s * a.stage_bytes, kd = qd + a.q_bytes, vd = kd + a.kv_bytes;
      load_part<HDP>(qd, a.q + wh * a.nq * a.hd, a.nq, a.hd, a.vec, t);
      load_part<HDP>(kd, a.k + wh * a.nk * a.hd, a.nk, a.hd, a.vec, t);
      load_part<HDP>(vd, a.v + wh * a.nk * a.hd, a.nk, a.hd, a.vec, t);
      if (a.vec == 1)
        hopper::mbar_arrive(full(s));  // (shared stores: ordered by the arrive)
      else
        hopper::cp_async_arrive_noinc(full(s));
    }
    hopper::cp_async_wait_all();
    return;
  }
  // ------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int cw = wg, ct = tid & 127, wi = ct >> 5, lane = tid & 31, q4 = lane & 3;
  const uint32_t stg = staging + cw * (QT * RB);
  bf16* sg = reinterpret_cast<bf16*>(smem_raw + (stg - raw));
  const float sl = a.scale_log2;
  const int nsub = (a.nk + 15) >> 4;  // slices holding keys
  for (int i = cw; i < n_units; i += NCONS) {  // a unit a consumer in turn
    const int s = i % a.stages;
    hopper::mbar_wait(full(s), (i / a.stages) & 1);
    // the producer's generic-proxy writes, visible through the barrier,
    // ordered before this thread's wgmma (async-proxy) reads
    hopper::fence_proxy_async();
    const int w = g + i * a.per_head;
    const long long wh = static_cast<long long>(w) * a.nh + h;
    const uint32_t qd = ring + s * a.stage_bytes, kd = qd + a.q_bytes, vd = kd + a.kv_bytes;
    for (int qt = 0; qt < nqt; ++qt) {
      const int r0 = qt * QT + wi * 16 + (lane >> 2);
      float o[HDP / 2];
#pragma unroll
      for (int e = 0; e < HDP / 2; ++e) o[e] = 0.f;
      float l0 = 0.f, l1 = 0.f;
      const uint64_t dq = hopper::desc_swizzled<RB>(qd + qt * QT * RB);
      float sc[NS][8];
      // S = Q K^T on 16-key slices, hd / 16 k-steps of 32 bytes; every
      // slice issued (the zero tile past the keys), so that no wgmma sits
      // in a branch
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const uint64_t dk = hopper::desc_swizzled<RB>(j < nsub ? kd + j * 16 * RB : zero_tile);
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk)
          hopper::Wgmma<16>::mma(sc[j], dq + 2 * kk, dk + 2 * kk, kk);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      // scores in the log2 domain, the bias from the table
      float mx0 = neg_inf, mx1 = neg_inf;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        hopper::fence_operands(sc[j]);
        const float* b0 = sbias + r0 * a.ldb + j * 16 + 2 * q4;
        const float* b1 = b0 + 8 * a.ldb;
        const float2 u0 = *reinterpret_cast<const float2*>(b0);
        const float2 u1 = *reinterpret_cast<const float2*>(b1);
        const float2 u2 = *reinterpret_cast<const float2*>(b0 + 8);
        const float2 u3 = *reinterpret_cast<const float2*>(b1 + 8);
        sc[j][0] = fmaf(sc[j][0], sl, u0.x);
        sc[j][1] = fmaf(sc[j][1], sl, u0.y);
        sc[j][2] = fmaf(sc[j][2], sl, u1.x);
        sc[j][3] = fmaf(sc[j][3], sl, u1.y);
        sc[j][4] = fmaf(sc[j][4], sl, u2.x);
        sc[j][5] = fmaf(sc[j][5], sl, u2.y);
        sc[j][6] = fmaf(sc[j][6], sl, u3.x);
        sc[j][7] = fmaf(sc[j][7], sl, u3.y);
        mx0 = fmaxf(mx0, fmaxf(fmaxf(sc[j][0], sc[j][1]), fmaxf(sc[j][4], sc[j][5])));
        mx1 = fmaxf(mx1, fmaxf(fmaxf(sc[j][2], sc[j][3]), fmaxf(sc[j][6], sc[j][7])));
      }
#pragma unroll
      for (int d = 1; d <= 2; d <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
      }
      // finite: every row holds a real key, the bias finite
      // P = exp2(S - m) into A fragments: slice j is the k-step j of P V
      uint32_t pa[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          p[e] = exp2f(sc[j][e] - ((e & 2) ? mx1 : mx0));  // 0 at -inf
          if (e & 2)
            l1 += p[e];
          else
            l0 += p[e];
        }
#pragma unroll
        for (int f = 0; f < 4; ++f) pa[j][f] = pack_bf16(p[2 * f], p[2 * f + 1]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const uint64_t dv = hopper::desc_swizzled<RB>(j < nsub ? vd + j * 16 * RB : zero_tile);
        hopper::WgmmaRS<HDP>::mma(o, pa[j], dv, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(o);
      // the stage's last read: hand it back to the producer
      if (qt + 1 == nqt) hopper::mbar_arrive(empty(s));
#pragma unroll
      for (int d = 1; d <= 2; d <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, d);
        l1 += __shfl_xor_sync(0xffffffffu, l1, d);
      }
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      // epilogue: O / l, rounded to bf16, staged as the tile's dense
      // [rows][hd] block, then one bulk copy (or coalesced stores)
      const int rows = min(QT, a.nq - qt * QT);
      if (ct == 0) hopper::bulk_wait_read();
      consumer_barrier(cw);  // the last tile's copy-out has read the staging tile
      const int rl0 = wi * 16 + (lane >> 2), rl1 = rl0 + 8;
#pragma unroll
      for (int t = 0; t < HDP / 8; ++t) {
        const int col = 8 * t + 2 * q4;
        if (a.hd % 2 == 0) {
          if (col < a.hd) {
            if (rl0 < rows)
              *reinterpret_cast<uint32_t*>(sg + rl0 * a.hd + col) =
                  pack_bf16(o[4 * t] * inv0, o[4 * t + 1] * inv0);
            if (rl1 < rows)
              *reinterpret_cast<uint32_t*>(sg + rl1 * a.hd + col) =
                  pack_bf16(o[4 * t + 2] * inv1, o[4 * t + 3] * inv1);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rl = (e & 2) ? rl1 : rl0;
            if (col + (e & 1) < a.hd && rl < rows)
              sg[rl * a.hd + col + (e & 1)] =
                  __float2bfloat16(o[4 * t + e] * ((e & 2) ? inv1 : inv0));
          }
        }
      }
      hopper::fence_proxy_async();  // the staging writes, before the bulk copy reads them
      consumer_barrier(cw);
      bf16* dst = a.out + (wh * a.nq + qt * QT) * a.hd;
      if (a.bulk_out) {
        if (ct == 0) {
          hopper::bulk_store(dst, stg, static_cast<uint32_t>(rows * a.hd * 2));
          hopper::bulk_commit();
        }
      } else {
        for (int e = ct; e < rows * a.hd; e += 128) dst[e] = sg[e];
      }
    }
  }
  if (ct == 0) hopper::bulk_wait();  // the last tile's copy has landed
}

template <int HDP, int NS>
int launch(const Args& a, size_t smem, int grid, cudaStream_t stream) {
  auto kernel = window_attn_wg_kernel<HDP, NS>;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once: the most any launch takes
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_hdp(const Args& a, size_t smem, int grid, cudaStream_t s, int ns) {
  switch (ns) {
    case 4: return launch<HDP, 4>(a, smem, grid, s);
    case 7: return launch<HDP, 7>(a, smem, grid, s);
    case 8: return launch<HDP, 8>(a, smem, grid, s);
    case 9: return launch<HDP, 9>(a, smem, grid, s);
    case 12: return launch<HDP, 12>(a, smem, grid, s);
    default: return launch<HDP, 16>(a, smem, grid, s);
  }
}

}  // namespace

// per_head: CTAs a head (kernels/window_attention.py::wg_ctas_per_head);
// slices, stages: the launch plan (window_attention.py::wg_plan decides
// it; this entry only checks it).  Returns cudaErrorInvalidValue where the
// shapes are outside the kernel (hd > 64) or the plan does not fit them: a
// slice count that is not compiled or does not hold the keys, stages that
// do not pair up with the two consumers, more than the shared memory.
extern "C" int sr_window_attention_wg_bf16(const void* q, const void* k, const void* v,
                                           const void* bias, void* out, int bw, int nh, int nq,
                                           int nk, int hd, float scale, int per_head,
                                           int slices, int stages, void* stream) {
  if (nh < 1 || nq < 1 || nk < 1 || hd < 1 || hd > 64 || per_head < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  bool compiled = false;
  for (int c : SLICES) compiled = compiled || c == slices;
  if (!compiled || 16 * slices < nk || stages < NCONS || stages > MAX_STAGES ||
      stages % NCONS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bw == 0) return 0;
  const int hdp = hd <= 16 ? 16 : hd <= 32 ? 32 : 64;
  const uint32_t rb = 2u * hdp;
  auto part = [&](int rows) { return (static_cast<uint32_t>(rows) * rb + 1023u) & ~1023u; };
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.bw = bw;
  a.nh = nh;
  a.nq = nq;
  a.nk = nk;
  a.hd = hd;
  a.per_head = per_head < bw ? per_head : bw;
  a.scale_log2 = scale * LOG2E;
  const int nqp = (nq + QT - 1) / QT * QT;
  a.q_bytes = part(nqp);
  a.kv_bytes = part((nk + 15) / 16 * 16);
  a.stage_bytes = a.q_bytes + 2 * a.kv_bytes;
  a.staging_bytes = NCONS * QT * rb;
  const size_t fixed = 1024 + 2048 + a.staging_bytes + 16 * MAX_STAGES;
  // the bias table: rows 8 banks apart, so that a warp's float2 reads
  // take two wavefronts
  a.ldb = 16 * slices + 8;
  a.bias_bytes = static_cast<uint32_t>(nqp) * a.ldb * 4;
  a.stages = stages;
  const size_t smem = fixed + a.bias_bytes + size_t(a.stages) * a.stage_bytes;
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const bool a16 = aligned_to(q, 16) && aligned_to(k, 16) && aligned_to(v, 16);
  const bool a4 = aligned_to(q, 4) && aligned_to(k, 4) && aligned_to(v, 4);
  a.vec = (hd % 8 == 0 && a16) ? 8 : (hd % 2 == 0 && a4) ? 2 : 1;
  a.bulk_out = hd % 8 == 0 && aligned_to(out, 16);
  const int grid = nh * a.per_head;
  const auto s = static_cast<cudaStream_t>(stream);
  if (hdp == 16) return launch_hdp<16>(a, smem, grid, s, slices);
  if (hdp == 32) return launch_hdp<32>(a, smem, grid, s, slices);
  return launch_hdp<64>(a, smem, grid, s, slices);
}
