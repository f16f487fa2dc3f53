// K16 on Hopper's wgmma — DAT's batched window attention (the "square"
// route of kernels/window_attention.py::k15_route).
//
// Replaces: tpu_superresolution_tpu/ops/pallas/window_attention.py
//           batched_window_attention -> _batched_forward (pallas_call at
//           :352, _batched_kernel :245); oracle window_attention_reference
//           (:229).
// Math (per window w and head h; N = 128 or 256 tokens a window, hd <= 64,
//       at N 256 hd <= 32):
//         out[w, h] = softmax(scale * q[w, h] k[w, h]^T + bias[h]
//                             + mask[w % nW]) v[w, h]
//       q, k, v, out [BW, nH, N, hd] bf16; bias [nH, N, N] and mask [nW,
//       N, N] fp32 (or no mask); scores and softmax in fp32 with the
//       plain version's arithmetic (scale * s + (bias + mask), exp); P
//       enters P V as three bf16 parts (P to fp32's 24 bits: K16's split
//       P made exact; with two parts, 16 bits, the output's bf16 rounding
//       differs from the fp32 softmax's in ~0.2% of its elements, with
//       three in ~0.02%), and the row sums are of the unrounded P.  DAT's
//       shift mask is additive -100 and the pad tokens of its padded map
//       are real keys: the caller's data, not special cases here.
// Design: a persistent grid over "keys" (head h, mask plane m, block rb of
//       128 query rows), G CTAs a key: CTA (key, g) walks windows m + nW j,
//       j = g, g + G, ... (every window of its mask plane: w % nW = m), so
//       bias[h] + mask[m] over its 128 query rows is summed once into a
//       resident fp32 table ([128, N + 8]: 69.6 KB at N
//       128, 135.2 KB at N 256, rows 8 banks apart), not re-read from L2
//       by every unit (the tiled kernel reads 64 KB of bias and mask a
//       block).  Each consumer warpgroup builds its own 64 rows of it
//       while the producer fills the first stages.  Warpgroup 2 is the
//       producer (setmaxnreg gives its registers away): a ring of up to
//       four stages, one (window, head, row block) unit each: the unit's
//       128 query rows and the window's N key and value rows, each a
//       contiguous run in device memory, repacked by cp.async (16 bytes
//       where hd % 8 == 0, else 4: hd 30's 60-byte rows admit no bulk
//       copy or tensor map) into the swizzled [rows][HDP] layout wgmma
//       reads (HDP = 16, 32 or 64); the ring is zeroed once and only real
//       dims are written.  Both consumer warpgroups take every unit, one
//       64-row query tile each, so a window's keys are read once a row
//       block (once at N 128, twice at N 256; the tiled kernel reads them
//       once a 64-row tile).  A consumer walks the keys in groups of 128
//       (64 at HDP 64) with an online softmax: S = Q K^T as wgmma
//       m64n16k16 on the group's 16-key slices (the group's scores in
//       registers), one FMA with the table a score, the running max (O
//       and the row sums rescaled by exp of its change), P = exp(S -
//       max) split into its three bf16 parts, O += P V as wgmma with P
//       from registers and V a transposed (MN-major) B, the high part's
//       products in one accumulator, the two smaller parts' in another,
//       summed at the end; one stage hand-back (both consumers'
//       arrivals) and one barrier pair a unit.  The output tile is staged
//       in shared memory and leaves by one bulk copy (a 64-row tile of a
//       head is one contiguous run of 128 hd bytes).  No wgmma sits under
//       a runtime branch (ptxas serialises those): the slices, the head
//       dim and the query tile are compile-time or address arithmetic.
// Bound on the H100 (4 N hd FLOP a query row; q, k, v, out in bf16, the
//       bias and mask once): memory.  The DAT train step's [256, 3, 128,
//       30]: 23.8 MB, 0.0071 ms; the bench batch's [800, 3, 128, 30]
//       masked: 76.0 MB, 0.0227 ms.  By design the keys are read once
//       more at N 256 (through L2: the two row blocks' CTAs walk the same
//       windows side by side) and each CTA reads its table's 64-128 KB of
//       bias and mask once.  What holds it above the bound: a unit's
//       exp of every score and its chains of wgmma (three products a key
//       slice), the producer's 4-byte copies (hd 30), which share the
//       SM's issue slots with the consumers, and at N 256 a ring of two
//       stages beside the table, so loads and compute overlap little.
#include <cstdint>

#include "window_attn_wg.cuh"

namespace {

using namespace wg_attn;

constexpr int QT = 64;                      // query rows a consumer's tile (wgmma's M)
constexpr int NCONS = 2;                    // consumer warpgroups: a query tile each
constexpr int ROWS = NCONS * QT;            // query rows a unit (a row block)
constexpr int NTHREADS = 128 * (NCONS + 1);  // + the producer warpgroup
constexpr int PRODUCER_REGS = 72;           // setmaxnreg: 128 x 72 + 256 x 216 <= 64K
constexpr int CONSUMER_REGS = 216;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;

struct SqArgs {
  const bf16* q;       // [BW, nh, n, hd]
  const bf16* k;
  const bf16* v;
  const float* bias;   // [nh, n, n]
  const float* mask;   // [n_mask, n, n] or null
  bf16* out;           // [BW, nh, n, hd]
  int bw, nh, hd;
  int n_mask;          // mask planes (1 without a mask)
  int row_blocks;      // n / 128
  int per_key;         // CTAs a key (G)
  int vec;             // elements a copy: 8, 2 or 1
  int vec_table;       // bias and mask 16-byte aligned: float4 loads
  int stages;
  int bulk_out;
  int ldb;             // the table's row stride (floats)
  float scale;
  uint32_t q_bytes, kv_bytes, stage_bytes, staging_bytes, table_bytes;
};

// HDP: padded head dim; NS: 16-key slices a window (N = 16 NS).
template <int HDP, int NS>
__global__ void __launch_bounds__(NTHREADS, 1) batched_attn_wg_kernel(const SqArgs a) {
  constexpr int RB = HDP * 2;  // bytes a row of a q, k or v part
  constexpr int N = 16 * NS;
  // 16-key slices a group of the online softmax: a group's scores and P's
  // three parts in registers beside O's two accumulators
  constexpr int GS = HDP == 64 ? 4 : 8;
  static_assert(NS % GS == 0, "whole groups");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t staging = ring + a.stages * a.stage_bytes;
  const uint32_t table_at = staging + a.staging_bytes;
  const uint32_t bars = table_at + a.table_bytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (MAX_STAGES + s); };
  float* table = reinterpret_cast<float*>(smem_raw + (table_at - raw));

  const int tid = threadIdx.x;
  const int key = blockIdx.x / a.per_key, g = blockIdx.x - key * a.per_key;
  const int rb = key % a.row_blocks, hm = key / a.row_blocks;
  const int m = hm % a.n_mask, h = hm / a.n_mask;
  // the key's windows m, m + nW, ...; this CTA's the j-th, j = g, g + G, ...
  const int nj = a.bw > m ? (a.bw - m + a.n_mask - 1) / a.n_mask : 0;
  const int n_units = nj > g ? (nj - g + a.per_key - 1) / a.per_key : 0;
  if (n_units == 0) return;  // (a mask plane past the windows)
  auto window_of = [&](int i) { return m + (g + i * a.per_key) * a.n_mask; };

  // zero the ring: the producer writes real dims only
  for (uint32_t i = tid * 16u; i < a.stages * a.stage_bytes; i += NTHREADS * 16u)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(ring + i), "r"(0u)
                 : "memory");
  hopper::fence_proxy_async();  // the zeros, before wgmma reads them
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      hopper::mbar_init(full(s), 128);          // every producer thread's copies
      hopper::mbar_init(empty(s), 128 * NCONS);  // both consumers' threads
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform role
  if (wg == NCONS) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int t = tid - 128 * NCONS;
    for (int i = 0; i < n_units; ++i) {
      const int s = i % a.stages;
      if (i >= a.stages) hopper::mbar_wait(empty(s), ((i / a.stages) - 1) & 1);
      const long long wh = static_cast<long long>(window_of(i)) * a.nh + h;
      const uint32_t qd = ring + s * a.stage_bytes, kd = qd + a.q_bytes, vd = kd + a.kv_bytes;
      load_part<HDP>(qd, a.q + (wh * N + rb * ROWS) * a.hd, ROWS, a.hd, a.vec, t);
      load_part<HDP>(kd, a.k + wh * N * a.hd, N, a.hd, a.vec, t);
      load_part<HDP>(vd, a.v + wh * N * a.hd, N, a.hd, a.vec, t);
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
  {
    // this consumer's 64 rows of the table: bias[h] + mask[m]
    // over the row block's rows 64 cw .. 64 cw + 63
    const size_t row0 = static_cast<size_t>(rb) * ROWS + cw * QT;
    const float* bsrc = a.bias + (static_cast<size_t>(h) * N + row0) * N;
    const float* msrc = a.mask ? a.mask + (static_cast<size_t>(m) * N + row0) * N : nullptr;
    float* dst = table + cw * QT * a.ldb;
    if (a.vec_table) {
      // N / 8 float4s a thread, eight loads (and eight of the mask) in
      // flight before their stores
#pragma unroll 1
      for (int i0 = 0; i0 < N / 8; i0 += 8) {
        float4 b[8], u[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = 4 * (ct + 128 * (i0 + e));
          b[e] = __ldg(reinterpret_cast<const float4*>(bsrc + i));
          u[e] = msrc ? __ldg(reinterpret_cast<const float4*>(msrc + i))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = 4 * (ct + 128 * (i0 + e)), r = i / N;
          *reinterpret_cast<float4*>(dst + r * a.ldb + (i - r * N)) =
              make_float4(b[e].x + u[e].x, b[e].y + u[e].y, b[e].z + u[e].z, b[e].w + u[e].w);
        }
      }
    } else {
      for (int i = ct; i < QT * N; i += 128) {
        const int r = i / N, c = i - r * N;
        dst[r * a.ldb + c] = __ldg(bsrc + i) + (msrc ? __ldg(msrc + i) : 0.f);
      }
    }
    consumer_barrier(cw);
  }
  const uint32_t stg = staging + cw * (QT * RB);
  bf16* sg = reinterpret_cast<bf16*>(smem_raw + (stg - raw));
  const float sl = a.scale;
  const int rt = wi * 16 + (lane >> 2);  // the thread's rows of the tile: rt, rt + 8
  const float* trow0 = table + (cw * QT + rt) * a.ldb + 2 * q4;
  const float* trow1 = trow0 + 8 * a.ldb;
  for (int i = 0; i < n_units; ++i) {
    const int s = i % a.stages;
    hopper::mbar_wait(full(s), (i / a.stages) & 1);
    // the producer's generic-proxy writes, visible through the barrier,
    // ordered before this thread's wgmma (async-proxy) reads
    hopper::fence_proxy_async();
    const long long wh = static_cast<long long>(window_of(i)) * a.nh + h;
    const uint32_t qd = ring + s * a.stage_bytes, kd = qd + a.q_bytes, vd = kd + a.kv_bytes;
    // the keys in groups of GS 16-key slices, an online softmax across
    // the groups: S = Q K^T on a group's slices (HDP / 16 k-steps of 32
    // bytes), the scores times the scale plus the table's bias and mask,
    // the running max, O and l rescaled, P = exp(S - max) as three bf16
    // parts (hi, mid, lo: P to fp32's 24 bits), O += P V on wgmma with P
    // from registers
    const uint64_t dq = hopper::desc_swizzled<RB>(qd + cw * QT * RB);
    const float neg_inf = -__int_as_float(0x7f800000);
    float mx0 = neg_inf, mx1 = neg_inf, l0 = 0.f, l1 = 0.f;
    float o[HDP / 2], o2[HDP / 2];  // P_hi V; P_mid V + P_lo V
#pragma unroll
    for (int e = 0; e < HDP / 2; ++e) o[e] = o2[e] = 0.f;
#pragma unroll 1
    for (int g = 0; g < NS / GS; ++g) {
      float sc[GS][8];
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < GS; ++j) {
        const uint64_t dk = hopper::desc_swizzled<RB>(kd + (GS * g + j) * 16 * RB);
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk)
          hopper::Wgmma<16>::mma(sc[j], dq + 2 * kk, dk + 2 * kk, kk);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      float bm0 = mx0, bm1 = mx1;
#pragma unroll
      for (int j = 0; j < GS; ++j) {
        hopper::fence_operands(sc[j]);
        const int col = 16 * (GS * g + j);
        const float2 u0 = *reinterpret_cast<const float2*>(trow0 + col);
        const float2 u1 = *reinterpret_cast<const float2*>(trow1 + col);
        const float2 u2 = *reinterpret_cast<const float2*>(trow0 + col + 8);
        const float2 u3 = *reinterpret_cast<const float2*>(trow1 + col + 8);
        sc[j][0] = fmaf(sc[j][0], sl, u0.x);
        sc[j][1] = fmaf(sc[j][1], sl, u0.y);
        sc[j][2] = fmaf(sc[j][2], sl, u1.x);
        sc[j][3] = fmaf(sc[j][3], sl, u1.y);
        sc[j][4] = fmaf(sc[j][4], sl, u2.x);
        sc[j][5] = fmaf(sc[j][5], sl, u2.y);
        sc[j][6] = fmaf(sc[j][6], sl, u3.x);
        sc[j][7] = fmaf(sc[j][7], sl, u3.y);
        bm0 = fmaxf(bm0, fmaxf(fmaxf(sc[j][0], sc[j][1]), fmaxf(sc[j][4], sc[j][5])));
        bm1 = fmaxf(bm1, fmaxf(fmaxf(sc[j][2], sc[j][3]), fmaxf(sc[j][6], sc[j][7])));
      }
#pragma unroll
      for (int d = 1; d <= 2; d <<= 1) {
        bm0 = fmaxf(bm0, __shfl_xor_sync(0xffffffffu, bm0, d));
        bm1 = fmaxf(bm1, __shfl_xor_sync(0xffffffffu, bm1, d));
      }
      // rescale to the new max (by 0 on the first group: the max was -inf)
      const float a0 = expf(mx0 - bm0), a1 = expf(mx1 - bm1);
      mx0 = bm0;
      mx1 = bm1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int e = 0; e < HDP / 2; ++e) {
        o[e] *= (e & 2) ? a1 : a0;
        o2[e] *= (e & 2) ? a1 : a0;
      }
      uint32_t ph[GS][4], pm[GS][4], pl[GS][4];
#pragma unroll
      for (int j = 0; j < GS; ++j) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          p[e] = expf(sc[j][e] - ((e & 2) ? mx1 : mx0));
          if (e & 2)
            l1 += p[e];
          else
            l0 += p[e];
        }
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2 * f], p[2 * f + 1]);
          const float2 hf = __bfloat1622float2(hi);
          const float r0 = p[2 * f] - hf.x, r1 = p[2 * f + 1] - hf.y;
          const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
          const float2 mf = __bfloat1622float2(mid);
          ph[j][f] = *reinterpret_cast<const uint32_t*>(&hi);
          pm[j][f] = *reinterpret_cast<const uint32_t*>(&mid);
          pl[j][f] = pack_bf16(r0 - mf.x, r1 - mf.y);
        }
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < GS; ++j) {
        const uint64_t dv = hopper::desc_swizzled<RB>(vd + (GS * g + j) * 16 * RB);
        hopper::WgmmaRS<HDP>::mma(o, ph[j], dv, 1);
        hopper::WgmmaRS<HDP>::mma(o2, pm[j], dv, 1);
        hopper::WgmmaRS<HDP>::mma(o2, pl[j], dv, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(o);
      hopper::fence_operands(o2);
    }
#pragma unroll
    for (int e = 0; e < HDP / 2; ++e) o[e] += o2[e];
    hopper::mbar_arrive(empty(s));  // this consumer's last read of the stage
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, d);
      l1 += __shfl_xor_sync(0xffffffffu, l1, d);
    }

    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    // epilogue: O / l, rounded to bf16, staged as the tile's dense [64][hd]
    // block, then one bulk copy (or coalesced stores)
    if (ct == 0) hopper::bulk_wait_read();
    consumer_barrier(cw);  // the last tile's copy-out has read the staging tile
    const int rl1 = rt + 8;
#pragma unroll
    for (int t = 0; t < HDP / 8; ++t) {
      const int col = 8 * t + 2 * q4;
      if (a.hd % 2 == 0) {
        if (col < a.hd) {
          *reinterpret_cast<uint32_t*>(sg + rt * a.hd + col) =
              pack_bf16(o[4 * t] * inv0, o[4 * t + 1] * inv0);
          *reinterpret_cast<uint32_t*>(sg + rl1 * a.hd + col) =
              pack_bf16(o[4 * t + 2] * inv1, o[4 * t + 3] * inv1);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + (e & 1) < a.hd)
            sg[((e & 2) ? rl1 : rt) * a.hd + col + (e & 1)] =
                __float2bfloat16(o[4 * t + e] * ((e & 2) ? inv1 : inv0));
      }
    }
    hopper::fence_proxy_async();  // the staging writes, before the bulk copy reads them
    consumer_barrier(cw);
    bf16* dst = a.out + (wh * N + rb * ROWS + cw * QT) * a.hd;
    if (a.bulk_out) {
      if (ct == 0) {
        hopper::bulk_store(dst, stg, static_cast<uint32_t>(QT * a.hd * 2));
        hopper::bulk_commit();
      }
    } else {
      for (int e = ct; e < QT * a.hd; e += 128) dst[e] = sg[e];
    }
  }
  if (ct == 0) hopper::bulk_wait();  // the last tile's copy has landed
}

template <int HDP, int NS>
int launch(const SqArgs& a, size_t smem, int grid, cudaStream_t stream) {
  auto kernel = batched_attn_wg_kernel<HDP, NS>;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once: the most any launch takes
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K16 at N 128 or 256 (hd <= 64; at N 256 hd <= 32).  per_key: CTAs a
// (head, mask plane, row block); stages: the ring's
// (kernels/window_attention.py::sq_plan and sq_ctas_per_key decide them;
// this entry only checks them).  n_mask: the mask's planes (window w takes
// mask[w % n_mask]; ignored without a mask).  Returns
// cudaErrorInvalidValue where the shapes are outside the kernel or the
// plan does not fit them.
extern "C" int sr_batched_window_attention_wg_bf16(const void* q, const void* k, const void* v,
                                                   const void* bias, const void* mask,
                                                   void* out, int bw, int nh, int n, int hd,
                                                   int n_mask, float scale, int per_key,
                                                   int stages, void* stream) {
  const int hdp = hd <= 16 ? 16 : hd <= 32 ? 32 : 64;
  if (nh < 1 || hd < 1 || hd > 64 || (n != 128 && n != 256) || (n == 256 && hdp == 64) ||
      per_key < 1 || stages < 1 || stages > MAX_STAGES || (mask && n_mask < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bw == 0) return 0;
  const uint32_t rb = 2u * hdp;
  SqArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<bf16*>(out);
  a.bw = bw;
  a.nh = nh;
  a.hd = hd;
  a.n_mask = mask ? n_mask : 1;
  a.row_blocks = n / ROWS;
  a.per_key = per_key;
  a.scale = scale;
  a.q_bytes = ROWS * rb;
  a.kv_bytes = static_cast<uint32_t>(n) * rb;
  a.stage_bytes = a.q_bytes + 2 * a.kv_bytes;
  a.staging_bytes = NCONS * QT * rb;
  a.ldb = n + 8;  // rows 8 banks apart: a warp's float2 reads take two wavefronts
  a.table_bytes = static_cast<uint32_t>(ROWS) * a.ldb * 4;
  a.stages = stages;
  const size_t smem = 1024 + size_t(stages) * a.stage_bytes + a.staging_bytes + a.table_bytes +
                      16 * MAX_STAGES;
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const bool a16 = aligned_to(q, 16) && aligned_to(k, 16) && aligned_to(v, 16);
  const bool a4 = aligned_to(q, 4) && aligned_to(k, 4) && aligned_to(v, 4);
  a.vec = (hd % 8 == 0 && a16) ? 8 : (hd % 2 == 0 && a4) ? 2 : 1;
  a.vec_table = aligned_to(bias, 16) && (!mask || aligned_to(mask, 16));
  a.bulk_out = aligned_to(out, 16);
  const int grid = nh * a.n_mask * a.row_blocks * per_key;
  const auto s = static_cast<cudaStream_t>(stream);
  if (n == 128) {
    if (hdp == 16) return launch<16, 8>(a, smem, grid, s);
    if (hdp == 32) return launch<32, 8>(a, smem, grid, s);
    return launch<64, 8>(a, smem, grid, s);
  }
  if (hdp == 16) return launch<16, 16>(a, smem, grid, s);
  return launch<32, 16>(a, smem, grid, s);
}
