"""Hand-written Hopper (sm_90a) kernels of the port, with their plain
PyTorch versions and launch counters.

Each wrapper takes a CPU tensor through its plain version and a CUDA
tensor through its kernel (or raises); there is no fallback from one to
the other.  The CUDA sources live in ``../csrc`` and are built at first
use (``_lib.build``).

Every ``pl.pallas_call`` of the JAX package
(``tpu_superresolution_tpu/ops/pallas/``), and where it stands in the
port.  "On path": SwinIR-M x4 serving (S) and fine-tuning (T), HAT x4
serving (H) and training (HT) (``hat``, ws 7; ``hat_fast``, ws 8), DAT
x4 serving (D), HAT-SRx4 serving (H16: upstream's HAT, window 16, C 180),
every other Swin block outside the block kernel's envelope (W: any
other window, width, head count or head dim), DAT training (DT) and DAT's module
chain at serving where K9, K14 or K10 refuse a block's shapes (DC: splits
past N 256, C > 192, hd > 32, among others),
HAT-SRx4 training (H16T: window 16, C 180, hidden 360) and SwinIR-L
fine-tuning (LT: ws 8, C 240, 8 heads, hidden 480).

==== ========================================================== ======== ==================================================
 #   JAX file:line of pallas_call . entry function                on path  port
==== ========================================================== ======== ==================================================
K1   fused_block.py:958 . fused_swin_block (_mega_forward)         S,T,H    CUDA csrc/swin_block.cu (ws 8, extra; wgmma, fused_block.block_plan), fused_block.fused_windows_block
     (the same function at any other window or width)             H16,W,   K2 + K7 + K1's tail (K1t), CUDA csrc/swin_tail_wg.cu (wgmma, C <= 256) or csrc/swin_tail.cu (past it, any C; fused_block.tail_route), fused_block.fused_block_tail
                                                                  H16T,LT
K5   fused_block.py:1080 . _mega_backward                          T,HT     CUDA csrc/swin_block_bwd.cu (ws 8, extra; wgmma on the forward's tiles, fused_block.bwd_plan), fused_block.SwinBlockFunction
     (at ws 16, the K7 route's block, counted as K5w16)            H16T     CUDA csrc/swin_block_bwd16.cu (K5a's ws-16 modes + two attention kernels, fused_block.bwd16_plan), fused_block.WindowBlockFunction
     (at ws 8 past the block kernel's widths, counted as K5r)     LT       CUDA csrc/swin_block_bwd16.cu (K5a's ws-8 modes at cp 256, csrc/swin_block_bwd_i8w_256_32.cu; fused_block.k5r_plan), fused_block.WindowBlockFunction
K2   layernorm.py:54 . pallas_layernorm (layernorm_spatial)        all      CUDA csrc/layernorm.cu (bands of rows, a lane group a row; layernorm.layernorm_plan), layernorm.layernorm
K3   cab_conv.py:307 . conv3x3_halo                                all      CUDA csrc/conv.cu, cab_conv.conv3x3
K4   cab_conv.py:418 . conv_halo                                   all      CUDA csrc/conv.cu, cab_conv.conv_k
K6   fused_block.py:1427 . fused_packed_windows_block (forward)    H,HT     CUDA csrc/swin_block.cu (ws 7, extra), fused_block.fused_windows_block
K6b  fused_block.py:1604 . _packed_backward                        HT       CUDA csrc/swin_block_bwd.cu (ws 7, extra; K5's ws-7 instantiation), fused_block.SwinBlockFunction
K13  fused_block.py:1532 . fused_spatial_windows_block             H        the K6 instantiation (it reads windows from the spatial map)
K8   fused_ocab.py:311 . fused_ocab_core (_fwd_kernel)             HT       CUDA csrc/ocab_bwd.cu (wgmma: the gather to head-major q, k, v, the attention over (window, head) units + K5a's OCAB tail; fused_ocab.ocab_bwd_plan), fused_ocab.OcabCoreFunction
     (at (ws, ows) (16, 24), counted as K8w16)                     H16,H16T CUDA csrc/ocab16.cu (wgmma: the gather from the qkv map, the attention over (window, head) units + K5a's OCAB tail; fused_ocab.ocab16_plan), fused_ocab.Ocab16Function (+ OcabHeadsFunction)
K8b  fused_ocab.py:354 . fused_ocab_core (_bwd_kernel)             HT       CUDA csrc/ocab_bwd.cu (on K8's kept q, k, v, O and row statistics: K5a's middle, the attention backward, K5b, K5c), fused_ocab.OcabCoreFunction
     (at (16, 24), counted as K8bw16)                              H16T     CUDA csrc/ocab16.cu (K5a's middle, the attention backward, the gather's backward, K5b, K5c), fused_ocab.Ocab16Function (+ OcabHeadsFunction)
K9   fused_rect_attn.py:433 . fused_rect_attention                 D        CUDA csrc/dat_rect.cu (+ dat_common.cuh's product and conv, window_attn_stream.cu's attention), fused_rect_attn.rect_attention
K14  fused_channel_attn.py:209 . fused_channel_attention           D        CUDA csrc/dat_channel.cu (+ dat_common.cuh's product and conv), fused_channel_attn.channel_attention
K10  fused_datb_tail.py:374 . fused_datb_tail                      D,DC     CUDA csrc/dat_tail.cu (C <= 192, half <= 384; fused_datb_tail.tail_plan), fused_datb_tail.datb_tail
K7   fused_attention.py:229 . fused_window_block_attention         H16,W,   CUDA csrc/window_attn.cu (the qkv and proj product) + csrc/window_attn_stream.cu
                                                                  H16T,LT  (the attention), fused_attention.fused_window_attention
K12  cab_conv.py:209 . fused_ln_cab_convs                          H,HT,    CUDA csrc/cab_fused.cu (C <= 256, Cmid <= 128), cab_conv.fused_ln_cab_convs
                                                                  H16,H16T
K11  cab_conv.py:506 . dwconv3x3_halo                              DT,DC    CUDA csrc/dwconv.cu ("rows" or "tiles", dwconv.dwconv_plan), dwconv.dwconv3x3
K15  window_attention.py:193 . fused_window_attention              H        CUDA csrc/window_attn_wg.cu, csrc/batched_attn.cu or csrc/window_attn_stream.cu
                                                                           (window_attention.k15_route), window_attention.fused_window_attention
K16  window_attention.py:352 . batched_window_attention            DT,DC    CUDA csrc/batched_attn_wg.cu (wgmma, N 128 / 256), csrc/batched_attn.cu or csrc/window_attn_stream.cu
                                                                           (window_attention.k15_route), window_attention.batched_window_attention
==== ========================================================== ======== ==================================================

One CUDA kernel, templated on the window size (and on its padded width
and head dim), serves K1, K6 and K13: its ws = 8 launches count as K1,
its ws = 7 launches as K6; one
backward kernel likewise serves K5 (ws 8) and K6's backward (ws 7, K6b).
In training, K1-K4, K1t, K6, K7, K8, K12 and K15 run through
``torch.autograd.Function``s: K1's backward is K5, K6's is K6b, K8's is
K8b; K2-K4's, K7's and K12's backwards are torch autograd of their
plain versions, as the JAX package leaves those backwards to XLA, and so
are K1t's and K15's (the JAX package has no K15 backward: its HAT
trains the OCAB through K8).  A K7-route block that
``fused_block.tiled_bwd_ok`` takes trains through
``fused_block.WindowBlockFunction`` instead, at any MLP hidden: at ws 16
within the block kernel's C and heads (C <= 192, <= 6 heads of hd <= 32)
its backward is K5 at ws 16 (K5w16), at ws 8 past the block kernel's
widths (C <= 256, <= 8 heads of hd <= 32: SwinIR-L) K5r; both recompute
LN1 and qkv in their own launches, and its forward is the route's K2, K7
and K1t, counted as such.  Elsewhere on the K7 route (ws 24, 32, ...; ws
16 past C 192 or 6 heads; ws 8 past C 256 or 8 heads; hd > 32; no qkv
bias) the block backward is still autograd of the plain versions
(ROADMAP Queue 2).
HAT's OCAB runs K15 as its attention at serving at ws 7 and 8, and
wherever K8 refuses its shapes (``fused_ocab.ocab_ok``: C > 192, more
than 6 heads, hd > 32, windows other than 7, 8 and 16; any hidden);
elsewhere in training it takes
K8 / K8b (K8w16 / K8bw16 at ws 16), and at ws 16 it serves on K8w16 too
(``models.hat.OCAB.takes_fused``, the card's choice).  A Swin
block takes the block kernel or the K7 route by its static shapes
(``fused_block.block_route``); a K7 call is three CUDA launches (the qkv
product into a head-split workspace, the attention, the proj product),
counted once, and takes any width, head count, head dim and window; K1's
tail kernel (counted as K1t) completes the block.  A HAT CAB takes K12
(two launches, LN's statistics and the fused kernel, counted once) or,
past its widths, K2 + K3 + K3 (``cab_conv.cab_route``).  A DAT block at
serving is K9 (spatial) or K14 (channel), then K10, where their limits
take its shapes (``models.dat.dat_route``); a K9 call is four CUDA
launches, a K14 call three, a K10 call one, each counted once per
wrapper call.  Otherwise, and in training, the block runs the module
chain: K2 for its LayerNorms, K11 for its depthwise convs and K16 for its
rect-window attention; K11's and K16's backwards are torch autograd of
their plain versions.

For ``torch.export``, every kernel an inference forward launches (K1,
K1t, K2, K3, K4, K6, K7, K8w16, K9, K10, K11, K12, K14, K15, K16;
``custom_ops.EXPORTABLE``) is also a ``torch.library`` custom op
(``custom_ops.py``, registered when this package is imported), which its
wrapper calls only while an export traces; the training-only kernels
(K5, K5r, K5w16, K6b, K8, K8b, K8bw16) have none.
"""

from __future__ import annotations

from typing import Dict

from tpu_superresolution_torch.kernels import (
    cab_conv,
    custom_ops,  # noqa: F401  (registers the tpu_sr:: ops)
    dwconv,
    fused_attention,
    fused_block,
    fused_channel_attn,
    fused_datb_tail,
    fused_ocab,
    fused_rect_attn,
    layernorm,
    window_attention,
)

COUNTERS = {
    "K1": fused_block.launches,
    "K1t": fused_block.launches_tail,
    "K2": layernorm.launches,
    "K3": cab_conv.launches_conv3x3,
    "K4": cab_conv.launches_conv_k,
    "K5": fused_block.launches_bwd,
    "K5r": fused_block.launches_bwd_r,
    "K5w16": fused_block.launches_bwd_w16,
    "K6": fused_block.launches_ws7,
    "K6b": fused_block.launches_bwd_ws7,
    "K7": fused_attention.launches,
    "K8": fused_ocab.launches,
    "K8b": fused_ocab.launches_bwd,
    "K8w16": fused_ocab.launches_w16,
    "K8bw16": fused_ocab.launches_bwd_w16,
    "K9": fused_rect_attn.launches,
    "K10": fused_datb_tail.launches,
    "K11": dwconv.launches,
    "K12": cab_conv.launches_ln_cab,
    "K14": fused_channel_attn.launches,
    "K15": window_attention.launches_rect,
    "K16": window_attention.launches,
}


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


def read_counters() -> Dict[str, int]:
    return {k: c.count for k, c in COUNTERS.items()}
