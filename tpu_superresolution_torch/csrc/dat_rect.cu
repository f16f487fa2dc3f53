// K9 — the front half of DAT's spatial block: LN1 -> qkv -> the two
// rectangular-window attention branches, and the conv branch.
//
// Replaces: tpu_superresolution_tpu/ops/pallas/fused_rect_attn.py
//           fused_rect_attention -> _kernel (pallas_call at :433).
// Math (dat_arch.py:247-438 up to the AIM gating), for x [B, H, W, C]:
//         y = LN1(x) (fp32 fast-variance statistics, eps 1e-5), bf16
//         q, k, v = y Wqkv + bqkv, bf16, q pre-scaled by hd^-0.5
//         branch 0 (channels 0..C/2-1): s0 x s1 windows; branch 1
//         (C/2..C-1): s1 x s0 windows; nh/2 heads each; per window and
//         head softmax(q k^T + bias[h] + mask) v, fp32 scores and
//         softmax, P rounded once to bf16; bias[h](i, j) =
//         table[pos_i - pos_j + (hsp-1)(2wsp-1) + wsp-1, h], the
//         DynamicPosBias output [(2hsp-1)(2wsp-1), nh/2] gathered by
//         relative_position_index; mask = -100 where the shifted
//         windows' region ids differ (not -inf)
//         conv_x = erf-GELU(dwconv3x3(v) + b), BatchNorm folded into
//         the depthwise kernel, SAME zero padding, true coordinates
// Geometry: q, k, v are zero-padded after the projection to Hp x Wp,
//       multiples of max(s0, s1) (dat_arch.py:376-385), and a shifted
//       block rolls them by (-hsp/2, -wsp/2).  Token t of window (wy, wx)
//       of a branch sits at (pr, pc) = (wy*hsp + t/wsp, wx*wsp + t%wsp)
//       in the rolled frame, i.e. at ((pr+sh) mod Hp, (pc+sw) mod Wp) of
//       the padded map: a real pixel when inside H x W, else a pad token
//       (q = k = v = 0; a real key whose score is the bias alone, its
//       output not stored).  Outputs are written at true coordinates:
//       no roll pass, no pad pass, no shape gate.
// Launches (one call, four launches):
//       (1) front_product_kernel<MODE_RECT> (csrc/dat_common.cuh): LN1
//           and the qkv product over the padded map's rows, each branch's
//           q, k, v written into its head-split workspace in the branch's
//           rolled, padded window order, and v at true coordinates;
//       (2), (3) csrc/window_attn_stream.cu's attention, once a branch,
//           over (window, head) units: the rel form (the branch's table
//           resident in shared memory, one int32 code a token: position
//           y (2wsp-1) + x in bits 0-15, the shift region in 16-31), the
//           outputs stored straight to their pixels of attened_x;
//       (4) dat_conv_kernel<false> (csrc/dat_common.cuh): the conv branch.
// Bound on the H100 at [25,64,64,180] split (8, 16): 29.7 GFLOP (qkv
//       19.9, attention 9.4; 0.030 ms at the bf16 peak) against 111 MB of
//       x in and attened_x, conv_x out (0.033 ms).  By design the call
//       moves ~420 MB (the q|k|v workspaces written and read, 2 x 118 MB;
//       v written and read, 2 x 37 MB; x, the outputs): ~0.13 ms at 3.35
//       TB/s.
#include "common.cuh"
#include "dat_common.cuh"

extern "C" int sr_window_attention_stream_bf16(
    const void* q, const void* k, const void* v, const void* bias, const void* mask,
    const void* codes, void* out, int bw, int nh, int nq, int nk, int hd, int n_mask,
    int n_codes, int ws, int shifted, int split_p, float scale, int per_head, int hb, int ob,
    int ns, int stages, int whole, int bulk, int tokmajor, int ws_w, const int* pix,
    void* stream);

// geom (kernels/fused_rect_attn.py::rect_geometry): {B, H, W, C, nhb, hd,
// s0, s1, shifted, Hp, Wp, product grid, tiles an image, x copy width,
// stream plan hb, ob, ns, stages, whole, per_head, n_codes}.
// ws0 / ws1: the branches' workspaces, 3 * B * Hp * Wp * nhb * 32 bf16
// each; tables [2][(2 s0 - 1)(2 s1 - 1)][nhb] fp32; codes0 / codes1
// [n_codes][s0 s1] int32.  v [B, H, W, C] is written (the conv's input).
extern "C" int sr_dat_rect_bf16(const void* x, void* out, void* conv, void* v, void* ws0,
                                void* ws1, const void* g1, const void* b1, const void* wstream,
                                const void* bqkv, const void* tables, const void* codes0,
                                const void* codes1, const void* wdw, const void* bdw,
                                const int* geom, float eps, void* stream) {
  const int batch = geom[0], h = geom[1], w = geom[2], c = geom[3], nhb = geom[4],
            hd = geom[5], s0 = geom[6], s1 = geom[7], shifted = geom[8], hp = geom[9],
            wp = geom[10], grid = geom[11], tpi = geom[12], vec = geom[13];
  const int n = s0 * s1, ms = s0 > s1 ? s0 : s1, mn = s0 < s1 ? s0 : s1;
  if (n > 256 || n % 64 || ms % mn || c > 192 || (c & 1) || nhb < 1 || nhb > 3 || hd > 32 ||
      nhb * hd * 2 != c || hp % ms || wp % ms || hp < h || wp < w ||
      tpi != (hp * wp + datf::BM - 1) / datf::BM ||
      (vec != 4 && vec != 2) || c % vec || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * h * w == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  datf::FrontArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.g1 = static_cast<const float*>(g1);
  a.b1 = static_cast<const float*>(b1);
  a.wstream = static_cast<const bf16*>(wstream);
  a.bias = static_cast<const float*>(bqkv);
  a.v = static_cast<bf16*>(v);
  a.ws0 = static_cast<bf16*>(ws0);
  a.ws1 = static_cast<bf16*>(ws1);
  a.h = h;
  a.w = w;
  a.c = c;
  a.hp = hp;
  a.wp = wp;
  a.tpi = tpi;
  a.tiles = batch * tpi;
  a.vec = vec;
  a.nh = nhb;
  a.hd = hd;
  a.ntok = n;
  for (int b = 0; b < 2; ++b) {
    a.hsp[b] = b ? s1 : s0;
    a.wsp[b] = b ? s0 : s1;
    a.sh[b] = shifted ? a.hsp[b] / 2 : 0;
    a.sw[b] = shifted ? a.wsp[b] / 2 : 0;
  }
  a.bw = static_cast<long long>(batch) * hp * wp / n;
  a.eps = eps;
  int err = datf::launch_front<datf::MODE_RECT>(a, grid < a.tiles ? grid : a.tiles, s);
  if (err) return err;

  const int tsize = (2 * s0 - 1) * (2 * s1 - 1);
  for (int b = 0; b < 2; ++b) {
    const int pix[8] = {h, w, hp, wp, a.sh[b], a.sw[b], c, b * nhb * hd};
    err = sr_window_attention_stream_bf16(
        b ? ws1 : ws0, nullptr, nullptr, static_cast<const float*>(tables) + b * tsize * nhb,
        nullptr, b ? codes1 : codes0, out, static_cast<int>(a.bw), nhb, n, n, hd, 0, geom[20],
        a.hsp[b], shifted, 0, 1.f, geom[19], geom[14], geom[15], geom[16], geom[17], geom[18],
        1, 0, a.wsp[b], pix, stream);
    if (err) return err;
  }

  datf::ConvArgs ca = {};
  ca.v = static_cast<const bf16*>(v);
  ca.wdw = static_cast<const float*>(wdw);
  ca.bdw = static_cast<const float*>(bdw);
  ca.conv = static_cast<bf16*>(conv);
  ca.h = h;
  ca.w = w;
  ca.c = c;
  ca.tiles_x = (w + datf::CTW - 1) / datf::CTW;
  ca.tiles_y = (h + datf::CTR - 1) / datf::CTR;
  return datf::launch_conv<false>(ca, batch, s);
}
