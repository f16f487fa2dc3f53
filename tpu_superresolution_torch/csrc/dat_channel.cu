// K14 — the front half of DAT's channel block: LN1 -> qkv -> XCiT
// channel attention over all tokens of an image, and the conv branch.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_channel_attn.py
//           fused_channel_attention -> _kernel (pallas_call at :209).
// Math (dat_arch.py:441-509 up to the AIM gating), per image of T = H*W
//       tokens and per head h of hd channels:
//         y = LN1(x) (fp32 fast-variance statistics, eps 1e-5), bf16
//         q, k, v = y Wqkv + bqkv, bf16
//         G_h[d, e] = sum_t q[t, d] k[t, e] (fp32), |q_d|^2 = sum_t q^2
//         A_h = softmax_e(t_h G_h[d, e] / (max(|q_d|, 1e-12) max(|k_e|, 1e-12)))
//         attened_x[t, h*hd + d] = sum_e bf16(A_h[d, e]) v[t, h*hd + e]
//         conv_x = erf-GELU(dwconv3x3(v) + b), BatchNorm folded
// Launches (the TPU kernel's two grid phases; blocks run in no order
//       here, so the sum over tokens is a separate pass):
//       (1) front_product_kernel<MODE_CHAN> (csrc/dat_common.cuh), a
//           persistent wgmma product over 128-token tiles of each image:
//           LN1, q|k|v (heads padded to 32 columns), v written out, and
//           each tile's block-diagonal gram (mma.sync, a head's 32 x 32
//           block) and squared norms of q and k as partial sums;
//       (2) chan_softmax_kernel, one 1024-thread block per (image, head):
//           the partials summed in tile order (deterministic, no
//           atomics), normalised, times the temperature, softmax over e
//           with one warp per row d, rounded to bf16;
//       (3) dat_conv_kernel<true> (csrc/dat_common.cuh) over 8 x 16-pixel
//           tiles: the conv branch and out = v A^T (mma.sync, A resident
//           in shared memory) from one staging of v with its halo.
// v is kept from (1) and not recomputed: the conv branch needs it, and
//       re-reading costs one [T, C] bf16 pass against LN1 and a product.
// Bound on the H100 at [25,64,64,180]: 22.5 GFLOP (qkv 19.9; 0.023 ms at
//       the bf16 peak) against 111 MB of x in, attened_x and conv_x out
//       (0.033 ms).  By design the call moves ~185 MB (v written and read
//       besides, the partials ~20 MB): ~0.055 ms at 3.35 TB/s.
#include "common.cuh"
#include "dat_common.cuh"

namespace {

constexpr int CP = 192;           // padded channels: 6 heads x 32
constexpr int HDP = 32;
constexpr int NH_MAX = CP / HDP;  // 6
constexpr int GRAM = HDP * HDP;   // one head's block

// A[img][h] = bf16(softmax_e(t_h G[d, e] / (|q_d| |k_e|))), rows and
// columns past hd zero.  Thread (d = warp, e = lane).
__global__ void __launch_bounds__(1024) chan_softmax_kernel(const float* part_gram,
                                                            const float* part_sq,
                                                            const float* temperature, float* attn,
                                                            int strips, int nh, int hd) {
  const int img = blockIdx.x / nh, hh = blockIdx.x % nh;
  const int d = threadIdx.x >> 5, e = threadIdx.x & 31;
  float gs = 0.f, qq = 0.f, kk = 0.f;
  for (int s = 0; s < strips; ++s) {  // in tile order: the same bits on every run
    const long long part = static_cast<long long>(img) * strips + s;
    gs += part_gram[(part * NH_MAX + hh) * GRAM + d * HDP + e];
    qq += part_sq[part * 2 * CP + hh * HDP + d];
    kk += part_sq[part * 2 * CP + CP + hh * HDP + e];
  }
  float* out = attn + (static_cast<long long>(img) * NH_MAX + hh) * GRAM + d * HDP + e;
  if (d >= hd) {
    *out = 0.f;
    return;
  }
  const float qn = fmaxf(sqrtf(qq), 1e-12f), kn = fmaxf(sqrtf(kk), 1e-12f);
  const float sc = e < hd ? gs / (qn * kn) * temperature[hh] : -__int_as_float(0x7f800000);
  const float m = warp_max(sc);
  const float ex = e < hd ? expf(sc - m) : 0.f;
  const float sum = warp_sum(ex);
  *out = __bfloat162float(__float2bfloat16(ex / sum));  // A in bf16
}

}  // namespace

// geom (kernels/fused_channel_attn.py::chan_geometry): {B, H, W, C, nh,
// product grid, tiles an image, x copy width}.  part_gram [B][tiles
// an image][6][32][32] and part_sq [..][2][192] fp32, attn [B][6][32][32]
// fp32: the call's scratch.  v [B, H, W, C] is written (the conv's input).
extern "C" int sr_dat_channel_bf16(const void* x, void* out, void* conv, void* v, const void* g1,
                                   const void* b1, const void* wstream, const void* bqkv,
                                   const void* temperature, const void* wdw, const void* bdw,
                                   void* part_gram, void* part_sq, void* attn, const int* geom,
                                   float eps, void* stream) {
  const int batch = geom[0], h = geom[1], w = geom[2], c = geom[3], nh = geom[4],
            grid = geom[5], tpi = geom[6], vec = geom[7];
  const int hd = nh > 0 ? c / nh : 0;
  const long long tokens = static_cast<long long>(h) * w;
  if (c > CP || (c & 1) || nh < 1 || nh > NH_MAX || hd * nh != c || hd > HDP ||
      tpi != (tokens + datf::BM - 1) / datf::BM ||
      (vec != 4 && vec != 2) || c % vec || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || tokens == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  datf::FrontArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.g1 = static_cast<const float*>(g1);
  a.b1 = static_cast<const float*>(b1);
  a.wstream = static_cast<const bf16*>(wstream);
  a.bias = static_cast<const float*>(bqkv);
  a.v = static_cast<bf16*>(v);
  a.part_gram = static_cast<float*>(part_gram);
  a.part_sq = static_cast<float*>(part_sq);
  a.h = h;
  a.w = w;
  a.c = c;
  a.hp = h;  // no padding: the tile rows past H x W are past the image
  a.wp = w;
  a.tpi = tpi;
  a.tiles = batch * tpi;
  a.vec = vec;
  a.nh = nh;
  a.hd = hd;
  a.ntok = 1;
  for (int b = 0; b < 2; ++b) a.hsp[b] = a.wsp[b] = 1;
  a.eps = eps;
  int err = datf::launch_front<datf::MODE_CHAN>(a, grid < a.tiles ? grid : a.tiles, s);
  if (err) return err;
  chan_softmax_kernel<<<static_cast<unsigned int>(batch) * nh, 1024, 0, s>>>(
      a.part_gram, a.part_sq, static_cast<const float*>(temperature), static_cast<float*>(attn),
      tpi, nh, hd);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  datf::ConvArgs ca = {};
  ca.v = static_cast<const bf16*>(v);
  ca.wdw = static_cast<const float*>(wdw);
  ca.bdw = static_cast<const float*>(bdw);
  ca.conv = static_cast<bf16*>(conv);
  ca.attn = static_cast<const float*>(attn);
  ca.out = static_cast<bf16*>(out);
  ca.h = h;
  ca.w = w;
  ca.c = c;
  ca.nh = nh;
  ca.hd = hd;
  ca.tiles_x = (w + datf::CTW - 1) / datf::CTW;
  ca.tiles_y = (h + datf::CTR - 1) / datf::CTR;
  return datf::launch_conv<true>(ca, batch, s);
}
