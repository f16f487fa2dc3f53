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
every other Swin block outside the block kernel's envelope (W: other
windows, C up to 256, up to 8 heads), DAT training (DT) and DAT's module
chain at serving where K9, K14 or K10 refuse a block's shapes (DC: the
published DAT x4's split (8, 32) and expansion 4, among others).

==== ========================================================== ======== ==================================================
 #   JAX file:line of pallas_call . entry function                on path  port
==== ========================================================== ======== ==================================================
K1   fused_block.py:958 . fused_swin_block (_mega_forward)         S,T,H    CUDA csrc/swin_block.cu (ws 8, extra), fused_block.fused_windows_block
     (the same function at any other window or width)             H16,W    K2 + K7 + K1's tail, CUDA csrc/swin_tail.cu, fused_block.fused_block_tail (K1t)
K5   fused_block.py:1080 . _mega_backward                          T,HT     CUDA csrc/swin_block_bwd.cu (ws 8, extra), fused_block.SwinBlockFunction
K2   layernorm.py:54 . pallas_layernorm (layernorm_spatial)        all      CUDA csrc/layernorm.cu, layernorm.layernorm
K3   cab_conv.py:307 . conv3x3_halo                                all      CUDA csrc/conv.cu, cab_conv.conv3x3
K4   cab_conv.py:418 . conv_halo                                   all      CUDA csrc/conv.cu, cab_conv.conv_k
K6   fused_block.py:1427 . fused_packed_windows_block (forward)    H,HT     CUDA csrc/swin_block.cu (ws 7, extra), fused_block.fused_windows_block
K6b  fused_block.py:1604 . _packed_backward                        HT       CUDA csrc/swin_block_bwd.cu (ws 7, extra), fused_block.SwinBlockFunction
K13  fused_block.py:1532 . fused_spatial_windows_block             H        the K6 instantiation (it reads windows from the spatial map)
K8   fused_ocab.py:311 . fused_ocab_core (_fwd_kernel)             HT       CUDA csrc/ocab.cu, fused_ocab.fused_ocab_core
K8b  fused_ocab.py:354 . fused_ocab_core (_bwd_kernel)             HT       CUDA csrc/ocab.cu, fused_ocab.OcabCoreFunction
K9   fused_rect_attn.py:433 . fused_rect_attention                 D        CUDA csrc/dat_rect.cu, fused_rect_attn.rect_attention
K14  fused_channel_attn.py:209 . fused_channel_attention           D        CUDA csrc/dat_channel.cu, fused_channel_attn.channel_attention
K10  fused_datb_tail.py:374 . fused_datb_tail                      D        CUDA csrc/dat_tail.cu, fused_datb_tail.datb_tail
K7   fused_attention.py:229 . fused_window_block_attention         H16,W    CUDA csrc/window_attn.cu (any N), fused_attention.fused_window_attention
K12  cab_conv.py:209 . fused_ln_cab_convs                          H,HT,H16 CUDA csrc/cab_fused.cu, cab_conv.fused_ln_cab_convs
K11  cab_conv.py:506 . dwconv3x3_halo                              DT,DC    CUDA csrc/dwconv.cu, dwconv.dwconv3x3
K15  window_attention.py:193 . fused_window_attention              no       to port (HAT's OCAB at serving)
K16  window_attention.py:352 . batched_window_attention            DT,DC    CUDA csrc/batched_attn.cu (K7's core), window_attention.batched_window_attention
==== ========================================================== ======== ==================================================

One CUDA kernel, templated on the window size, serves K1, K6 and K13:
its ws = 8 launches count as K1, its ws = 7 launches as K6; one
backward kernel likewise serves K5 (ws 8) and K6's backward (ws 7, K6b).
In training, K1-K4, K1t, K6, K7, K8 and K12 run through
``torch.autograd.Function``s: K1's backward is K5, K6's is K6b, K8's is
K8b; K2-K4's, K7's and K12's backwards are torch autograd of their
plain versions, as the JAX package leaves those backwards to XLA, and so
is K1t's (the block backward at other windows is still to port).  A Swin
block takes the block kernel or the K7 route by its static shapes
(``fused_block.block_route``); a K7 call is two CUDA launches (the qkv
product, then attention + proj), counted once; on the K7 route K1's
tail kernel (counted as K1t) completes the block.  A DAT block at
serving is K9 (spatial) or K14 (channel), then K10, where their limits
take its shapes (``models.dat.dat_route``); a K9 call is two CUDA
launches, a K14 call three, a K10 call one, each counted once per
wrapper call.  Otherwise, and in training, the block runs the module
chain: K2 for its LayerNorms, K11 for its depthwise convs and K16 for its
rect-window attention; K11's and K16's backwards are torch autograd of
their plain versions.
"""

from __future__ import annotations

from typing import Dict

from tpu_superresolution_torch.kernels import (
    cab_conv,
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
    "K6": fused_block.launches_ws7,
    "K6b": fused_block.launches_bwd_ws7,
    "K7": fused_attention.launches,
    "K8": fused_ocab.launches,
    "K8b": fused_ocab.launches_bwd,
    "K9": fused_rect_attn.launches,
    "K10": fused_datb_tail.launches,
    "K11": dwconv.launches,
    "K12": cab_conv.launches_ln_cab,
    "K14": fused_channel_attn.launches,
    "K16": window_attention.launches,
}


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


def read_counters() -> Dict[str, int]:
    return {k: c.count for k, c in COUNTERS.items()}
