#!/usr/bin/env python3
"""Drive the PyTorch port's SwinIR-M x4 serving, evaluation and
fine-tuning paths, its HAT x4 serving and training paths, its DAT x4
serving and training paths (the published DAT x4's widths among them),
its HAT-SRx4 (upstream HAT, window 16) serving and training paths, and
its CNN families (MS_ResUNet, the train CLI's default, and UNet2D) with
the data path's native decoder, decoded-image cache, blur,
normalization and MRCCM preparation once on one NVIDIA H100 and check
them.  Run from the repository root:

    python3 chip_smoke.py

Phases (a failure in any raises, and the script exits non-zero):
1. device   the card's name, compute capability 9.0, power limit;
2. build    nvcc-compile the port's kernels from csrc/ (seconds, ptxas);
3. kernels  each kernel against its plain PyTorch version at the
            main paths' shapes (K3/K4 at 14 shapes: the bench tiles, a
            whole image, the train batch with the weight packed in the
            call, HAT's tiles, a [1,52,76,180] image, ThreeConv's 180->45
            and 45->180, SwinIR-L's 240->240 and the composed x2, x3 and
            x4 reconstructions, each with its route, its ratio to cuDNN,
            its share of the bound and 20 calls timed back to back; K1
            at the train batch and SwinIR-M's bench batch [25,64,64,180]
            (shift 0 and 4), also with stochastic-depth branch scales and
            with HAT's `extra` at hat_fast's widths; K6, the
            ws-7 block, at HAT's tile batch with `extra` and at SwinIR's
            widths without; at every K1 / K6 row the K7 route's
            composition of the same block (K2, the gathers, K7, K1t)
            timed beside the kernel, alone and back to back, in both
            orders; K5, the block backward on the forward's packed
            tiles, on dx and its 13 parameter gradients, timed alone and
            20 calls back to back, its bytes moved by design, two runs
            bit-identical): the error vs the plain version in bf16
            and in fp32 (TF32 off), each against its stated bound; the
            median time of kernel, plain version and, where one PyTorch
            call computes the same function, that call; the bound (bytes
            or operations at the H100's published peaks); then the
            training kernels at the HAT train step's shapes: K6b (the
            ws-7 block backward) and K5 with d`extra`, on dx, d extra
            and the 13 parameter gradients (as K5's rows: b2b, bytes,
            two runs bit-identical), K8 (the OCAB core: its three
            launches, each timed by the profiler) and K8b (its backward
            on K8's kept tensors, four launches, on dq, dk, dv, d sw and
            9 gradients), each with two runs bit-identical, then both at
            K8B_ENVELOPE's widths; then
            DAT's kernels at DATConfig()'s widths on the bench tile
            batch and on a [2,52,76,180] image (sides not multiples of
            16): K9 at split (8, 16) and the published DAT x4's (8, 32),
            unshifted and shifted, K14 (two runs bit-identical) and K10,
            each K9 / K14 row alone, 20 calls back to back, its bytes
            moved by design and, on the bench batch, each of its
            launches timed by the profiler; K10 at the published DAT
            x4's SGFN half 360, each output in bf16 ulps against the
            plain bf16 and fp32 versions, each K10 row beside the module
            chain's composition of its tail; then K7
            (window attention for any window, width and head dim: its
            product and stream attention kernels) at HAT-SRx4's
            [25,64,64,180] ws 16 unshifted and shift 8, at SwinIR-L's
            widths (C 240, 8 heads, ws 8, shifted), at ws 6 (N 36) and
            at ws 32 (N 1024), the bias as table + token codes and
            dense, beside F.linear + SDPA + F.linear; its product launch
            beside cuBLAS; K1's tail on the K7 route (K1t: the
            attention residual through the window reverse and unshift,
            `extra`, LN2, the MLP and its residual) at HAT-SRx4's
            widths (ws 16, shift 8, extra) and SwinIR-L's (ws 8, shift
            4, branch scales) on the wgmma kernel, each beside the WMMA
            kernel on the same call, alone and back to back, two runs
            bit-identical, and at C 264 / 576 on the WMMA kernel
            (``fused_block.tail_route``); and K12 (LN + the CAB's two convs) at
            the HAT-SRx4, HAT, hat_fast and HAT-S shapes and at C 256 /
            Cmid 128 (y1 in two 64-channel chunks), also timed
            against K2 + cuDNN convs + GELU and against the port's K2 +
            K3 (GELU) + K3; each in
            bf16 ulps likewise; then DAT's module-chain kernels: K16
            (batched window attention) at the DAT train step's
            [256,3,128,30], the bench batch's [800,3,128,30] and the
            published DAT x4's N 256, with and without the shift mask,
            timed beside SDPA, and K11 (depthwise 3x3) at [8,64,64,180]
            and [25,64,64,360], timed beside cuDNN's grouped conv (both
            K11 kernels, "rows" and "tiles", timed and held equal bit
            for bit); K16 also at branches of hd 44 and 64, each row
            with two runs bit-identical; then
            K15 (window attention, Nq queries against Nk keys: the wgmma,
            tiled or stream kernel, by shape) at HAT's OCAB on the
            bench batch ([2500,6,49,16] against 100 keys), hat_fast's
            ([1600,6,64,16] against 144), HAT-SRx4's ([400,6,256,30]
            against 576) and its train step's ([128,...]), square with
            the shift mask ([1600,6,64,30], mask [64,64,64]), at hd 44,
            45 and 64, hd 96 and a masked unit of 1024 keys, timed
            beside SDPA; at every K16 and K15 row each kernel that takes
            the shape is checked and timed, and a route check line says
            whether k15_route's kernel was the fastest; then the ws-16 training
            kernels at the HAT-SRx4 train step's shapes: K5w16 (the K7
            route's block backward, on the forward's pack_block_tiles
            stream) at [8,64,64,180] shift 8 (masked) and shift 0 with
            `extra` and branch scales, timed alone and 20 calls back to
            back, its bytes moved by design, each of its seven launches
            timed (torch.profiler), two runs bit-identical; K8w16 and
            K8bw16 (the OCAB core and its backward, timed with the
            gather from the qkv map and its backward, as the OCAB runs
            them) on 128 windows of 256 queries x 576 keys (K8w16 also
            on the serving batch's 400), each within 8 bf16 ulps (outputs,
            activation gradients) and 0.02 relative (parameter
            gradients); then K5r at SwinIR-L's [8,64,64,240]; then the
            training kernels at any MLP hidden (``phase_mlp4_kernels``):
            K5w16 at [8,64,64,180] with hidden 720 (the JAX train CLI's
            HAT at window 16: mlp 4), shift 8 and 0, `extra`, branch
            scales; K5r at [8,64,64,240] with hidden 960 (SwinIR-L at mlp
            4); K8w16 / K8bw16 on 128 windows, K8 / K8b on 800 windows of
            (7, 10) and 512 of (8, 12), at C 180 and hidden 720; the
            OCAB's serving route at ws 16 and mlp 4; each within its
            existing bound, timed, with its bound;
4. serve    SwinIR-M x4 (seeded random weights, exported to a .pth) behind
            SRService + make_server on 127.0.0.1, three PNG requests;
            status, size, finite output, launch counts per model call,
            and PSNR >= 50 dB of the served tiled output against the
            plain fp32 path;
5. bench    the bench.py workload (256^2 LR, tile 64, overlap 8, x4, bf16,
            25 tiles in one batch, 10 timed iterations) in MPix/s, for the
            kernels and for the plain path, and K3/K4's device time in one
            profiled forward (likewise in the HAT, DAT and HAT-SRx4
            bench phases); then the evaluate CLI
            (``cli.evaluate.main(--device cuda --no-exact)``) on SwinIR-M
            x4 over a synthetic test split of 8 images of 1024^2 at the
            bench tiles (batch 2, two PNG triplets) and with
            --self_ensemble over its first 4 (batch 1, one triplet):
            the report, the PNGs, launches per model call as the serve
            phase's (x8 under the ensemble), dataset-mean PSNR within
            0.05 dB and SSIM within 1e-3 of the same Evaluator.run of the
            plain fp32 model on the card, every image's SR >= 50 dB
            against the plain fp32 SR, the steady MPix/s and compile_s;
            the bicubic baseline on the card against the CPU's (1e-3
            dB); then SwinIR-M x4 at window 7
            (its blocks run K6): launches and PSNR vs the plain fp32 path;
            and one SwinIR-L-width forward (embed 240, 8 heads, ws 8,
            depths 9x6, 3conv, nearest+conv; 4 tiles of 64^2), whose
            blocks take the K7 route (K2, K7, K1t): launches and PSNR
            likewise; then forwards at widths past the block kernel's
            (depth (2,), 4 tiles of 64^2): SwinIR at C 264 in 6 heads, C
            180 in 4 heads, C 576 in 8 heads and C 192 in 2 heads (hd
            96) (K2, K7, K1t a block), HAT at embed 264 (its CABs on K2 +
            K3 with the GELU + K3): launches and PSNR likewise;
6. hat      HAT x4 (HATConfig(): embed 96, depths 6x4, ws 7; seeded
            random weights, exported to a .pth) behind SRService with
            --model hat: the three requests and checks of the serve phase
            (every CAB is K12, every OCAB's attention K15); then the bench
            workload for HAT in
            MPix/s, kernels vs plain, with a torch.profiler split of one
            forward, and one hat_fast (ws 8) forward, whose blocks are K1
            with `extra`;
7. dat      DAT x4 (DATConfig(): embed 180, depths 6x6, heads 6, split
            (8, 16); seeded random weights with perturbed BatchNorm
            statistics, exported to a .pth) behind SRService with --model
            dat: the serve phase's requests and checks (launches per call
            K9 18, K14 18, K10 36, K3 8, K4 1, K2 2); the bench workload
            for DAT in MPix/s, kernels vs plain, with a torch.profiler
            split of one forward by kernel and plain op;
8. train    SwinIR-M x4 fine-tuning (drop path 0.1, batch 8, lr_patch 64)
            through ``cli.finetune.main(--device cuda)`` for one epoch of
            8 steps + validation on a synthetic DeepRockSR-layout set;
            launches per step, median ms per step and images/s for the
            kernels and the plain bf16 path, a profiled step, the cost
            of the blocks' per-step weight packing (pack_block_tiles,
            which K1 and K5 both read), and the first step's loss,
            grad norm and per-parameter gradient cosine against the
            plain fp32 path;
9. hat-train HAT x4 training (HATConfig() at full width and depth, drop
            path 0.1, batch 8, --patch_size 64, L1, AdamW, clip 1.0)
            through ``cli.train.main(--model hat --device cuda)`` for one
            epoch of 2 steps + validation on a synthetic DeepRockSR-layout
            set; launches per step, ms per step for the kernels and the
            plain bf16 path, a profiled step split by part (forward
            kernels and plain ops, the backward by autograd node: K6b,
            K8b, K12, the rest; idle), the first step's gradients
            against the plain fp32 path (with the plain bf16 path beside
            it), the HABs' per-step weight packing; then a hat_fast step
            (K1 / K5 with `extra`): launches, packing and first-step
            gradients;
10. hat_srx4 HAT-SRx4 (upstream HAT_SRx4_ImageNet-pretrain.yml: window
            16, embed 180, depths 6x6, heads 6, mlp 2, compress 3,
            squeeze 30, overlap 0.5; seeded random weights, exported to a
            .pth) behind SRService with --model hat: the serve phase's
            requests and checks (launches per call K7 36, K1t 36, K12
            36, K15 6, K2 50, K3 8, K4 1, K1 = K6 = 0; the tiled output >= 50 dB against
            the plain fp32 path), the bench workload in MPix/s, kernels
            vs plain, and a torch.profiler split of one forward;
10b. hat_srx4-train HAT-SRx4 training (hat_srx4_config(), drop path 0.1,
            batch 8, --patch_size 64, L1, AdamW, clip 1.0) through
            ``cli.train.main(--model hat --window_size 16 --embed_dim 180
            --t_depths 6x6 --t_heads 6x6 --mlp_ratio 2 --device cuda)`` for
            one epoch of 2 steps + validation; launches per step (K5w16
            36, K7 36, K2 44, K8w16 6, K8bw16 6, K15 0), ms per step for the kernels and
            the plain bf16 path, peak memory, the step's autograd graph
            (no block or OCAB backward left to autograd of plain ops), a
            profiled step split by part, and the first step's gradients
            against the plain fp32 path;
10c. hat_mlp4-train the same through the train CLI with the JAX train
            CLI's flags alone (no --mlp_ratio: HATConfig's mlp 4, hidden
            720; ``hat_mlp4_config()``): launches per step exactly
            HAT_SRX4_TRAIN_PER_STEP (the same routes, a wider MLP), ms per
            step and peak memory for the kernels and the plain bf16 path,
            the step's graph (every HAB's backward K5w16's, every OCAB's
            K8bw16's), the first step's gradients against plain fp32;
10d. hat_mlp4-serve its checkpoint through ``cli.upscale.main`` (one
            whole-image call, its OCABs on K8w16: launches exactly
            HAT_SRX4_PER_CALL; the PNG equal to the same forward's, that
            forward >= 50 dB from plain fp32) and ``interop.export`` at
            [8,64,64,3] (the loaded program bit-identical to eager, the
            same launches);
11. dat_x4  the published DAT x4 (split (8, 32), expansion 4; seeded
            random weights, perturbed BatchNorm statistics): its .pth
            behind SRService (which loads it at split (8, 16): K9 and K14
            fronts, K10 tails), the serve phase's checks; then the model
            at (8, 32) on the bench workload, whose spatial fronts take
            K9 at N 256 and whose tails K10: launches per call (K9 18,
            K14 18, K10 36, K2 2, K16 = K11 = 0), >= 50 dB against the
            plain fp32 path, MPix/s kernels vs plain, a profiled split;
12. dat-train DAT x4 training (DATConfig() at full width and depth, drop
            path 0.1, batch 8, --patch_size 64, L1, AdamW, clip 1.0,
            --ema_decay 0.999) through ``cli.train.main(--model dat
            --device cuda)`` for one epoch of 2 steps + validation;
            launches per step (K16 36, K11 72, K9 = K14 = K10 = 0), ms
            per step and images/s for the kernels and the plain bf16
            path, a profiled step split by part, and the first step's
            loss, gradients and BatchNorm statistics against the plain
            fp32 path from weights whose attention is of trained size
            (with DAT's exception for gradients below bf16's
            resolution, BF16_FLOOR, calibrated on the plain bf16 path's
            spread under K16 mis-roundings), and the gate's controls:
            fresh mis-rounded K16s pass, five wrong K16s fail;
13. k16-stream the stream kernel's masked split-P path (K16 at windows
            the square kernel does not take): one shifted DAT spatial
            block at hd 30 with K16 forced to the stream kernel beside
            the square kernel, output and every gradient against the
            plain fp32 path; then DAT's first-step gate at C 180 in 4
            heads (hd 45), whose K16 take the square kernel with heads
            padded to 64 dims;
14. cnn-data  what the machine has for the native PNG decoder (g++,
            libpng's header, h5py) and whether it builds; MRCCM
            preparation through ``cli.prepare_mrccm.main(--force_4x)`` on
            classic .mat volumes (LR 24 x 70^2 resized to 64^2, HR 24 x
            256^2): split counts, layout, 16-bit slices; one batch through
            the loader's decoder (native where it builds) against PIL;
15. cnn-train MS_ResUNet x4 at full width through ``cli.train.main`` with
            no --model (the JAX CLI's default: batch 8 of 100^2 HR
            patches, pre-upscale on the card) with --do_blur --normalize
            --cache_decoded for 2 epochs: the native decoder's calls per
            epoch's training loop (the second from the cache), no kernel
            launch (cuDNN convs); the step's median ms and images/s; the
            first step, bf16 against the plain fp32 path (loss, the
            gradients, the BatchNorm batch statistics); then UNet2D
            (--residual, --patch_size 128) for one epoch on the MRCCM set;
16. cnn-evaluate ``cli.evaluate.main`` with no --model on MS_ResUNet's
            checkpoint (the bicubic baseline on): dataset PSNR within 0.05
            dB of the plain fp32 model's on the card, MPix/s; then
            ``cli.upscale.main(--model unet2d)`` on an MRCCM test slice;
17. swinir-data SwinIR-M x4 through ``cli.train.main(--model swinir
            --do_blur --normalize --cache_decoded)``: 2 steps +
            validation, launches = 2 x TRAIN_PER_STEP + PER_CALL (K1-K5
            under the new data path);
18. trace   a one-epoch SwinIR-M x4 fine-tune with ``--trace``: the
            timeline's spans ``epoch 1`` / ``val 1``, its counters
            ``train_loss`` / ``val_psnr``, launches;
19. remat   ``use_remat``: one SwinIR-M x4, one HAT-SRx4 x4 and one
            DAT x4 train step with and without it (and without it again,
            the run-to-run floor): loss, every gradient and DAT's
            BatchNorm statistics equal, the launches (the block kernels'
            routes not recomputed, DAT's module chain recomputed), then
            each setting's step peak memory and median step time (the
            two settings' steps interleaved);
20. compare ``cli.compare.main``: DAT x4 against SwinIR-M x4 on whole
            500^2 / 125^2 images from the port's checkpoints: panels,
            PSNR / SSIM, each side's SR against its plain fp32 forward;
21. mat-eval ``cli.mat_eval.main`` on classic .mat volumes (a
            single-channel SwinIR-M x4, tile 64 / 8): its [baseline] and
            [result] lines against the plain fp32 path;
22. export  ``interop.export`` of SwinIR-M x4 at [25,64,64,3] bf16 with
            K1-K4 as custom ops, then of HAT x4, hat_fast, HAT-SRx4, DAT
            x4, the published DAT x4, a DAT x4 at C 240 (the module
            chain: K11, K16), SwinIR at ws 7 and SwinIR-L at the same
            tiles and MS_ResUNet x4 and UNet2D on them pre-upscaled
            [25,256,256,1], every inference kernel as its tpu_sr:: op:
            each loaded program bit-identical to the eager kernel path,
            its launches and eager's exactly the family's per-call
            table, within PSNR_MIN_DB of plain fp32; the export's
            seconds and size, a call's ms loaded against eager with
            each one's device busy time; the host cost of a launch
            through its custom op against the direct launch;
23. dp      ``parallel/`` on SwinIR-M x4 at full width (drop path 0):
            at world 1 over NCCL one ``make_dp_train_step`` step (batch 8
            of 64^2 LR crops) against ``make_train_step`` from the same
            weights (loss 1%, grad norm 5%, update cosine >= 0.98, the
            same launches), both steps' medians interleaved, and
            ``sharded_tiled_forward`` on the bench image bit-identical to
            ``tiled_forward``; at world 2, two processes of this script
            (``--dp-child``) on the one card over gloo on CUDA tensors,
            the sharded forward against world 1's and the dp step on the
            same global batch against world 1's, with their times; DAT
            x4 at world 1: the kernel-route forward after a dp step
            against plain fp32 from the stepped state (>= 50 dB);
24. ablate  ``utils.ablate``: K2 against F.layer_norm at [102400, 180],
            interleaved rounds, min / median / spread.
The evaluate phase also prints ``Evaluator.run``'s mfu beside MPix/s,
with the counted and the analytic FLOPs.

The second-to-last stdout line is a JSON object describing each kernel
(launches summed over the serve, evaluate, SwinIR ws-7, SwinIR-L, wide,
hat, dat, train, hat-train, hat_srx4, hat_srx4-train, hat_mlp4-train,
hat_mlp4-serve, swinir_l-train,
dat_x4, dat-train, swinir-data, trace, remat, compare, mat-eval, export
and dp phases, the dp phase's child processes' among them); the last is
{"ok": true, "device": {...}}.  There is no CPU path: with no CUDA
device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import types
import tempfile
import threading
import time
import urllib.request

SEED = 0
PSNR_MIN_DB = 50.0
# Error bounds, in bf16 ulps at the reference output's largest magnitude:
# one ulp is the spacing of bf16 values there (2^(e-7) for magnitudes in
# [2^e, 2^(e+1))).  A kernel that rounds its bf16 output once is within
# 1 ulp of the fp32 result; the bounds leave room for bf16 operands and
# the plain version's own roundings.
ULP_BOUND = {"K1": 8, "K1t": 8, "K2": 4, "K3": 4, "K4": 4, "K6": 8, "K7": 8, "K8": 8, "K8w16": 8,
             "K9": 8, "K10": 8, "K11": 4, "K12": 8, "K14": 8, "K15": 8, "K16": 8}
# The backward kernels (K5, K6b, K8b): each activation gradient (dx,
# d extra; dq, dk, dv, d sw) within this many bf16 ulps at its max |ref|,
# and every parameter gradient within this relative Frobenius error of
# the plain version (in fp32 and in bf16): the kernels round their GEMM
# operands to bf16 at the plain bf16 version's points, so both sit as
# far from fp32 as the plain bf16 version does; the bound leaves room
# for that and for sums taken in another order.
K5_DX_ULPS = 16
K5_REL_BOUND = 0.02
# Published H100 SXM peaks: dense bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

KERNELS = {
    "K1": dict(name="swin_block", route="cuda",
               source="tpu_superresolution_torch/csrc/swin_block.cu",
               replaces="tpu_superresolution_tpu/ops/pallas/fused_block.py:958"),
    "K2": dict(name="layernorm", route="cuda",
               source="tpu_superresolution_torch/csrc/layernorm.cu",
               replaces="tpu_superresolution_tpu/ops/pallas/layernorm.py:54"),
    "K3": dict(name="conv3x3", route="cuda",
               source="tpu_superresolution_torch/csrc/conv.cu",
               replaces="tpu_superresolution_tpu/ops/pallas/cab_conv.py:307"),
    "K4": dict(name="conv_k", route="cuda",
               source="tpu_superresolution_torch/csrc/conv.cu",
               replaces="tpu_superresolution_tpu/ops/pallas/cab_conv.py:418"),
    "K5": dict(name="swin_block_bwd", route="cuda",
               source="tpu_superresolution_torch/csrc/swin_block_bwd.cu",
               replaces="tpu_superresolution_tpu/ops/pallas/fused_block.py:1080"),
    "K6": dict(name="swin_block_ws7", route="cuda",
               source="tpu_superresolution_torch/csrc/swin_block.cu",
               replaces="tpu_superresolution_tpu/ops/pallas/fused_block.py:1427"),
    "K6b": dict(name="swin_block_bwd_ws7", route="cuda",
                source="tpu_superresolution_torch/csrc/swin_block_bwd.cu",
                replaces="tpu_superresolution_tpu/ops/pallas/fused_block.py:1604"),
    "K8": dict(name="ocab", route="cuda",
               source="tpu_superresolution_torch/csrc/ocab_bwd.cu",
               replaces="tpu_superresolution_tpu/ops/pallas/fused_ocab.py:311"),
    "K8b": dict(name="ocab_bwd", route="cuda",
                source="tpu_superresolution_torch/csrc/ocab_bwd.cu",
                replaces="tpu_superresolution_tpu/ops/pallas/fused_ocab.py:354"),
    "K9": dict(name="dat_rect_attention", route="cuda",
               source="tpu_superresolution_torch/csrc/dat_rect.cu",
               replaces="tpu_superresolution_tpu/ops/pallas/fused_rect_attn.py:433"),
    "K10": dict(name="dat_block_tail", route="cuda",
                source="tpu_superresolution_torch/csrc/dat_tail.cu",
                replaces="tpu_superresolution_tpu/ops/pallas/fused_datb_tail.py:374"),
    "K14": dict(name="dat_channel_attention", route="cuda",
                source="tpu_superresolution_torch/csrc/dat_channel.cu",
                replaces="tpu_superresolution_tpu/ops/pallas/fused_channel_attn.py:209"),
    # K7: the stream attention kernel between two launches of its product
    # kernel (csrc/window_attn.cu)
    "K7": dict(name="window_attention", route="cuda",
               source="tpu_superresolution_torch/csrc/window_attn_stream.cu",
               replaces="tpu_superresolution_tpu/ops/pallas/fused_attention.py:229"),
    "K12": dict(name="ln_cab_convs", route="cuda",
                source="tpu_superresolution_torch/csrc/cab_fused.cu",
                replaces="tpu_superresolution_tpu/ops/pallas/cab_conv.py:209"),
    # K1's function at the windows and widths the block kernel does not
    # take is K2 (LN1) + K7 + this tail kernel
    # (csrc/swin_tail_wg.cu to C 256, the main paths'; the WMMA kernel
    # csrc/swin_tail.cu past it: fused_block.tail_route)
    "K1t": dict(name="swin_block_tail", route="cuda",
                source="tpu_superresolution_torch/csrc/swin_tail_wg.cu",
                replaces="tpu_superresolution_tpu/ops/pallas/fused_block.py:958"),
    "K11": dict(name="dwconv3x3", route="cuda",
                source="tpu_superresolution_torch/csrc/dwconv.cu",
                replaces="tpu_superresolution_tpu/ops/pallas/cab_conv.py:506"),
    "K16": dict(name="batched_window_attention", route="cuda",
                source="tpu_superresolution_torch/csrc/batched_attn_wg.cu",
                replaces="tpu_superresolution_tpu/ops/pallas/window_attention.py:352"),
    # HAT's OCAB: the wgmma kernel (window_attention.k15_route; the tiled
    # kernel in csrc/batched_attn.cu and K7's stream kernel take the other
    # shapes)
    "K15": dict(name="fused_window_attention", route="cuda",
                source="tpu_superresolution_torch/csrc/window_attn_wg.cu",
                replaces="tpu_superresolution_tpu/ops/pallas/window_attention.py:193"),
    # K5, K8 and K8b at window 16 (HAT-SRx4 training): kernels of their own
    "K5w16": dict(name="swin_block_bwd_ws16", route="cuda",
                  source="tpu_superresolution_torch/csrc/swin_block_bwd16.cu",
                  replaces="tpu_superresolution_tpu/ops/pallas/fused_block.py:1080"),
    "K8w16": dict(name="ocab_ws16", route="cuda",
                  source="tpu_superresolution_torch/csrc/ocab16.cu",
                  replaces="tpu_superresolution_tpu/ops/pallas/fused_ocab.py:311"),
    "K8bw16": dict(name="ocab_bwd_ws16", route="cuda",
                   source="tpu_superresolution_torch/csrc/ocab16.cu",
                   replaces="tpu_superresolution_tpu/ops/pallas/fused_ocab.py:354"),
    # K5 at window 8 past the block kernel's widths (SwinIR-L training):
    # K5w16's launches at ws 8, K5a at padded width 256
    # (csrc/swin_block_bwd_i8w_256_32.cu)
    "K5r": dict(name="swin_block_bwd_ws8_wide", route="cuda",
                source="tpu_superresolution_torch/csrc/swin_block_bwd16.cu",
                replaces="tpu_superresolution_tpu/ops/pallas/fused_block.py:1080"),
}
# K1t's correctness-only shapes on the wgmma kernel (chip_smoke's
# _tail_cases): [B, H, W, C], hidden, ws, shift, extra, branch scales,
# tanh GELU.  C 44: cp.async of 8 bytes and a ragged last unit (24 rows);
# C 45: element copies and stores (odd C, a last unit of 36 rows whose
# bytes are no multiple of 16); C 46: cp.async of 4 bytes; C 256 at hidden
# 200: x1 through the workspace, a part hidden chunk; C 64 and 120: the
# one- and two-chunk widths, ws 16.  C 2304 (mlp 1): the WMMA kernel past
# C 2272, x1 and LN2's output in its global scratch (fused_block.tail_spills).
K1T_ENVELOPE = (((1, 12, 18, 44), 88, 6, 3, True, True, False),
                ((1, 10, 10, 45), 100, 5, 2, True, False, True),
                ((2, 6, 6, 46), 92, 6, 3, False, True, False),
                ((2, 16, 16, 256), 200, 8, 4, True, True, True),
                ((1, 8, 8, 64), 64, 8, 4, False, False, True),
                ((3, 16, 16, 120), 480, 16, 8, True, True, False),
                ((1, 16, 16, 2304), 2304, 8, 4, True, True, False))
# K5r's correctness-only shapes at SwinIR-L's widths (phase_k5r_kernels):
# [B, H, W, C], shift, extra.  25 and 9 windows: an odd last unit, whose
# pair's idle consumer warpgroup recomputes it, and a last attention stage
# of one window; 3 windows: fewer than a stage.
K5R_ENVELOPE = (((1, 40, 40, 240), 4, False),
                ((3, 8, 24, 240), 0, True),
                ((1, 8, 24, 240), 4, True))
# Launches per SwinIR-M x4 model call on the serving path (--no-exact).
PER_CALL = {"K1": 36, "K1t": 0, "K2": 2, "K3": 8, "K4": 1, "K5": 0, "K5r": 0, "K5w16": 0, "K6": 0,
            "K6b": 0, "K7": 0, "K8": 0, "K8b": 0, "K8w16": 0, "K8bw16": 0, "K9": 0, "K10": 0,
            "K11": 0, "K12": 0, "K14": 0, "K15": 0, "K16": 0}
# Per HAT x4 model call (--no-exact): K6 per HAB (24); K12 per HAB's CAB
# (24: its LN1 inside); K15 per OCAB's attention (4); K2 for patch_norm,
# norm and each OCAB's two norms (8); K3 for the 4 RHAG convs,
# conv_after_body and conv_before_upsample; K4 for the composed
# reconstruction.  hat_fast runs K1 where hat runs K6.
HAT_PER_CALL = dict(PER_CALL, K1=0, K2=10, K3=6, K4=1, K6=24, K12=24, K15=4)
HAT_FAST_PER_CALL = dict(HAT_PER_CALL, K1=24, K6=0)
# SwinIR-M x4 from a checkpoint of window 7: its 36 blocks run K6.
SWINIR_WS7_PER_CALL = dict(PER_CALL, K1=0, K6=36)
# SwinIR-L's widths (embed 240, 8 heads, ws 8, depths 9x6, 3conv,
# nearest+conv): every block takes the K7 route (C 240 > 192): K7 and
# K1t 54 each, K2 for patch_norm, norm and each block's LN1 (56); K3 for
# the two 3x3 convs of each 3conv (9 RSTBs and conv_after_body: 20),
# conv_before_upsample, conv_up1, conv_up2 and conv_hr; no K4.
SWINIR_L_PER_CALL = dict(PER_CALL, K1=0, K1t=54, K2=56, K3=24, K4=0, K7=54)
# SwinIR-L fine-tuning (finetune CLI, batch 8 of 64^2 LR crops), per train
# step: the forward's launches (SWINIR_L_PER_CALL) and each block's
# backward K5r (54; it recomputes LN1 and qkv in its own launches).
SWINIR_L_TRAIN_PER_STEP = dict(SWINIR_L_PER_CALL, K5r=54)
# Per HAT-SRx4 model call (window 16, depths 6x6; --no-exact): every HAB
# takes the K7 route (K7 and K1t 36 each) and its CAB K12 (36); each OCAB
# the fused route, K8w16 (6; models.hat.OCAB.takes_fused); K2 for
# patch_norm, norm, each HAB's LN1 (36) and each OCAB's LN1 (6); K3 for
# the 6 RHAG convs, conv_after_body and conv_before_upsample; K4 for the
# composed reconstruction; no block kernel, no K15.
HAT_SRX4_PER_CALL = dict(PER_CALL, K1=0, K1t=36, K2=44, K3=8, K4=1, K7=36, K8w16=6, K12=36)
# Per DAT x4 model call (DATConfig(): depths 6x6, split (8, 16); --no-exact):
# K9 per spatial block (18, 9 of them shifted), K14 per channel block
# (18), K10 per block (36); K2 for before_RG and norm; K3 for the 6 group
# convs, conv_after_body and conv_before_upsample; K4 for the composed
# reconstruction.  One K9 call is 4 CUDA launches, one K14 call 3.
DAT_PER_CALL = dict(PER_CALL, K1=0, K2=2, K3=8, K4=1, K9=18, K10=36, K14=18)
# The published DAT x4 (DAT's test_DAT_x4.yml: split (8, 32), expansion 4;
# SGFN half 360), per bench call: K9 takes the spatial fronts at N 256
# (18), K14 the channel fronts (18), K10 every block tail (36); K2 for
# before_RG and norm; no module-chain front, so no K16 or K11.
DAT_X4_PER_CALL = dict(PER_CALL, K1=0, K2=2, K3=8, K4=1, K9=18, K10=36, K14=18)
# A published DAT x4 .pth served: the split is not in the weights, so the
# checkpoint loads at (8, 16) with expansion 4 (infer_dat_config, as the
# JAX package): K9 and K14 fronts, K10 tails.
DAT_X4_SERVE_PER_CALL = dict(PER_CALL, K1=0, K2=2, K3=8, K4=1, K9=18, K10=36, K14=18)
# Fine-tuning: batch 8 of 64^2 LR crops; per train step, with the
# composed reconstruction (fused_reconstruct, the config's default): K1
# per block forward, K5 per block backward, K2-K4 forwards (their
# backwards are autograd of the plain versions).
TRAIN_BATCH = 8
TRAIN_LR_PATCH = 64
# Timed steps per train path, few enough to keep the script's phases
# within ~4 minutes: the kernels of the SwinIR and HAT (ws 7) phases over
# TRAIN_TIMED_STEPS after 4 warm-up steps; their plain bf16 paths, and
# both paths of the DAT (~1 s a step, host-bound; its plain path after
# 1) and HAT-SRx4 phases, over DAT_TIMED_STEPS after 2.
TRAIN_TIMED_STEPS = 6
# SwinIR-L fine-tuning: rounds of one step with K5r and one with the
# autograd backward, in turns
SWINIR_L_AB_ROUNDS = 4
DAT_TIMED_STEPS = 3
TRAIN_PER_STEP = dict(PER_CALL, K5=36)
# HAT x4 training (HATConfig(), batch 8 of 64^2 LR crops, reflect-padded
# to 70^2), per train step: K6 forward and K6b backward per HAB (24); K8
# and K8b per OCAB core (4); K2 for patch_norm, norm and each OCAB's LN1
# (4; its LN2 is inside K8); K12 per HAB's CAB (24, its backward autograd
# of the plain version); K3 for the 4 RHAG convs, conv_after_body and
# conv_before_upsample; K4 for the composed reconstruction.  hat_fast
# runs K1 / K5 where hat runs K6 / K6b.
HAT_TRAIN_PER_STEP = dict(PER_CALL, K1=0, K2=6, K3=6, K6=24, K6b=24, K8=4, K8b=4, K12=24)
HAT_FAST_TRAIN_PER_STEP = dict(HAT_TRAIN_PER_STEP, K1=24, K5=24, K6=0, K6b=0)
# DAT x4 training (DATConfig(), batch 8 of 64^2 LR crops), per train step:
# every block on the module chain (BatchNorm on batch statistics): K16 per
# rect branch of the 18 spatial blocks (36), K11 per conv branch and per
# sg_conv (72), K2 for before_RG, norm and each block's LN1, LN2 and
# sg_norm (110), K3 for the 6 group convs, conv_after_body and
# conv_before_upsample, K4 for the composed reconstruction; no K9, K14,
# K10.  K11's and K16's backwards are autograd of their plain versions.
DAT_TRAIN_PER_STEP = dict(PER_CALL, K1=0, K2=110, K3=8, K4=1, K11=72, K16=36)
# HAT-SRx4 training (hat_srx4_config(), batch 8 of 64^2 LR crops), per
# train step: each HAB's CAB K12, LN1 K2, K7 and K1t forward and K5w16
# backward (36 each; K5w16 recomputes LN1 and qkv in its own launches);
# each OCAB's LN1 K2 (6), K8w16 forward and K8bw16 backward (6 each); K2
# for patch_norm and norm; K3 for the 6 RHAG convs, conv_after_body and
# conv_before_upsample; K4 for the composed reconstruction.  No K15 (the
# OCABs take the fused route).
HAT_SRX4_TRAIN_PER_STEP = dict(PER_CALL, K1=0, K1t=36, K2=44, K3=8, K4=1, K5w16=36, K7=36,
                               K8w16=6, K8bw16=6, K12=36)
# The ws-16 training kernels' activation gradients (dx, d extra; dq, dk,
# dv, d sw) are held to this many bf16 ulps at each one's max |ref|, as
# the forwards' outputs (ULP_BOUND), not to K5_DX_ULPS.
W16_ULPS = 8
# First step, kernels (bf16) vs the plain fp32 path from the same weights,
# batch and stochastic-depth masks: bf16 activations keep ~3 significant
# digits, so loss and grad norm agree to about a percent and every
# parameter's gradient points the same way.
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GNORM_RTOL = 5e-2
TRAIN_COS_MIN = 0.98
# A parameter whose plain bf16 gradient (no kernels) is itself below
# TRAIN_COS_MIN against fp32 is limited by bf16, not by a kernel (a sum
# that cancels to near zero, whose sign the rounding decides).  It is
# left out of the cosine gate only if every element of its fp32 and
# kernel gradients is below AdamW's eps: an AdamW step then moves it by
# under |g| / eps of the learning rate, whichever path computed it.
ADAMW_EPS = 1e-8
# BF16_FLOOR: DAT's DynamicPosBias parameters (the MLP that makes each
# rect branch's position bias) get gradients of ~1e-8 to 1e-6 of the
# global norm: each bias-table entry sums ~10^4 score gradients that
# cancel (every row of dS sums to 0), below what bf16 activations
# resolve.  The plain bf16 path, with no kernel, reaches only cosine
# 0.93-0.99 against fp32 on them (NVIDIA H100 80GB HBM3, 700 W, see
# PERF.md), and at that noise floor two bf16 paths that differ in a few
# roundings disagree as much.
# DAT's gate therefore also passes a parameter whose kernel gradient is
# no farther from fp32 (relative L2) than GATE_MARGIN times the plain bf16
# path's spread there: the largest error among the plain bf16 path and
# runs of it with K16's output mis-rounded (1 ulp, the other bf16
# neighbour) at GATE_CAL_FRAC of the elements, one run a seed of
# GATE_CAL_SEEDS.  Those runs stand for correct K16s: the square and tiled
# kernels round 1.9e-4 and 2.0e-3 of their outputs otherwise than the
# plain version (PERF.md §6).  One sample of that noise (the plain path
# alone, twice its error) failed 6 of 6 such draws (PERF.md); the
# controls of the dat-train phase hold the calibrated gate to passing
# fresh draws and failing wrong K16s.
# With 8 runs at the seeded weights the worst parameter of 6 fresh draws
# lay 1.09-1.87 times the spread, the square kernel's 1.01, the shift
# mask applied to the wrong windows 9.46 times, heads stored out of
# order 244.8 times (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
GATE_CAL_SEEDS = tuple(range(101, 113))
GATE_CAL_FRAC = 2e-3
GATE_MARGIN = 3.0
# The DAT gate runs from weights whose attention is of a trained model's
# size (``_dat_trained_size``).  At the reference initialisation the rect
# bias tables have std 0.031 (|bias| <= 0.11) and the scores q k^T std
# 0.071, so the softmax is near uniform and a K16 that drops a head's
# bias or applies the scale twice moves the gradients no more than
# bf16's rounding does (PERF.md).  DynamicPosBias's last layer times
# DAT_GATE_BIAS_GAIN and q's and k's rows of every spatial qkv times
# DAT_GATE_QK_GAIN give bias tables of std ~2 and scores of std ~2 (the
# dat-train phase logs both sizes before and after).  At a bias gain of
# 32 head 0's bias dropped read 3.66 times the spread, a correct K16 up
# to 2.06; at 64, 10.19 and 2.90 with 8 calibration runs, 9.07 and 1.68
# with 12 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
DAT_GATE_BIAS_GAIN = 64.0
DAT_GATE_QK_GAIN = 5.0


def log(msg: str) -> None:
    print(msg, flush=True)


def bf16_ulp(mag: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(mag, 2.0 ** -100))) - 7)


def cuda_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Median of `iters` CUDA-event timings of fn() after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, calls: int = 20) -> float:
    """Median over 5 runs of `calls` back-to-back calls of fn() between two
    CUDA events, per call: the device time when the host keeps the queue
    full (cuda_ms times one call from an idle device, so it also counts
    the host's work before the launch)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# ----------------------------------------------------------------- phases


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a CUDA device only")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} capability={cap} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(smi)
    if cap != (9, 0):
        raise RuntimeError(f"expected a Hopper card (capability (9, 0)), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


def phase_build():
    from tpu_superresolution_torch.kernels import _lib

    path, seconds, out = _lib.build(verbose=True)
    _lib.library()
    log(f"[build] {path.name} in {seconds:.1f} s "
        f"({'compiled' if out else 'already built'})")
    for line in out.splitlines():
        if (("registers" in line or "spill" in line or "error" in line or "C7515" in line)
                and "C7519" not in line):
            log(f"[build] {line.strip()}")
    # the wgmma kernels by name (csrc/conv.cu: K3/K4's flat and halo routes;
    # csrc/window_attn.cu and window_attn_stream.cu: K7's product and
    # attention; csrc/cab_fused.cu: K12; csrc/swin_block.cu: K1 / K6;
    # csrc/swin_block_bwd*.cu: K5a, K5w16's attention kernels;
    # csrc/ocab16.cu: K8w16 / K8bw16's attention and gathers; csrc/ocab_bwd.cu:
    # K8 / K8b's attention; csrc/batched_attn_wg.cu: K16; csrc/layernorm.cu: K2;
    # csrc/dat_common.cuh: K9 / K14's product and conv), with their
    # template arguments: registers, shared memory, spills
    kinds = ("conv_nhwc_wgmma_kernel", "conv_nhwc_halo_kernel", "window_product_kernel",
             "window_attn_stream_kernel", "cab_wgmma_kernel", "swin_block_wg_kernel",
             "datb_tail_wg_kernel", "swin_tail_wg_kernel", "swin_block_bwd_kernel", "attn16_kernel",
             "ocab_attn_kernel", "ocab_heads_kernel", "ocab_heads_bwd_kernel",
             "ocab_win_attn_kernel", "batched_attn_wg_kernel", "layernorm_bands_kernel",
             "front_product_kernel", "dat_conv_kernel")
    name = None
    for line in out.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
            args = lambda k: fn.split(k + "I")[1].split("EEv")[0].split("E")
            name = next((f"{k} <{','.join(t[2:] for t in args(k) if t)}>" if k + "I" in fn
                         else k for k in kinds if k in fn), None)
        elif name and ("spill" in line or "Used" in line):
            log(f"[build] {name}: {line.strip()}")
            if "Used" in line:
                name = None


def _random_block(gen, device, c=180, nh=6, hidden=360, ws=8):
    """Block weights with O(1) activations (bf16-representable GEMM
    weights, so the fp32 reference uses the kernel's exact values)."""
    import torch

    from tpu_superresolution_torch.kernels.fused_block import SwinBlockWeights

    def r(*shape, scale=1.0, bf=False):
        t = torch.randn(*shape, generator=gen) * scale
        t = t.bfloat16().float() if bf else t
        return t.to(device)

    return SwinBlockWeights(
        g1=1 + r(c, scale=0.1), b1=r(c, scale=0.1),
        wqkv=r(3 * c, c, scale=c ** -0.5, bf=True), bqkv=r(3 * c, scale=0.1),
        wproj=r(c, c, scale=c ** -0.5, bf=True), bproj=r(c, scale=0.1),
        g2=1 + r(c, scale=0.1), b2=r(c, scale=0.1),
        wfc1=r(hidden, c, scale=c ** -0.5, bf=True), bfc1=r(hidden, scale=0.1),
        wfc2=r(c, hidden, scale=hidden ** -0.5, bf=True), bfc2=r(c, scale=0.1),
        table=r((2 * ws - 1) ** 2, nh), num_heads=nh,
    )


def bound_ms(flops: float, nbytes: float):
    """The least time the card could take: the larger of operations over
    the bf16 tensor-core peak and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _record(results, key, label, err, t_kernel, t_plain, work, t_library=None):
    flops, nbytes = work
    b_ms, b_by = bound_ms(flops, nbytes)
    log(f"[kernels] {key} {label}: kernel {t_kernel:.4f} ms, plain bf16 {t_plain:.4f} ms, "
        f"library {'none' if t_library is None else f'{t_library:.4f} ms'}, bound "
        f"{b_ms:.4f} ms by {b_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    results.setdefault(key, []).append(dict(
        label=label, err=err, ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=t_library))


def _compare(results, key, label, out, ref_bf16, ref_fp32, t_kernel, t_plain, work,
             t_library=None):
    """A one-output kernel: see _compare_outputs."""
    _compare_outputs(results, key, label, (out,), (ref_bf16,), (ref_fp32,), t_kernel, t_plain,
                     work, t_library)


def _swin_work(shape, c=180, hidden=360, backward=False, ws=8, extra=False):
    """(FLOPs, bytes) of one Swin block forward (K1, K6) or backward (K5)
    at the unpadded widths: per token the qkv, proj, fc1 and fc2 products
    and the ws^2-key attention (QK^T, AV); the backward recomputes all but
    fc2 and does two products per forward one.  Bytes: x (and extra, or
    ct) read, the output (dx) written in bf16, weights and fp32 gradients
    once."""
    tokens = math.prod(shape[:3])
    fwd = {"qkv": 2 * c * 3 * c, "attn": 2 * 2 * ws * ws * c, "proj": 2 * c * c,
           "fc1": 2 * c * hidden, "fc2": 2 * c * hidden}
    per_token = sum(fwd.values())
    weights = 3 * c * c + c * c + 2 * c * hidden
    if not backward:
        return tokens * per_token, tokens * c * 2 * (3 if extra else 2) + weights * 2
    per_token = per_token - fwd["fc2"] + 2 * per_token
    return tokens * per_token, tokens * c * 2 * (5 if extra else 3) + weights * (2 + 4)


def _compare_grads(results, key, label, got, ref16, ref32, act_fields, param_fields,
                   t_kernel, t_plain, work, ulps=K5_DX_ULPS):
    """A backward kernel's outputs: each activation gradient within
    `ulps` bf16 ulps at its max |ref|, each parameter gradient in
    relative Frobenius error, against the plain version in fp32 (and
    bf16), beside the plain bf16 version's own error."""
    bad, errs = [], []
    for k in act_fields:
        a, r16, r32 = getattr(got, k).float(), getattr(ref16, k).float(), getattr(ref32, k).float()
        mag = float(r32.abs().max())
        bound = ulps * bf16_ulp(mag)
        e32, e16 = float((a - r32).abs().max()), float((a - r16).abs().max())
        own = float((r16 - r32).abs().max())
        ok = math.isfinite(e32) and e32 <= bound and e16 <= bound
        errs.append(e32)
        log(f"[kernels] {key} {label} {k if k.startswith('d') else 'd' + k}: max_abs_err vs plain fp32 {e32:.3e}, vs plain bf16 "
            f"{e16:.3e} (bound {bound:.3e} = {ulps} bf16 ulp at max|ref| {mag:.3f}; "
            f"plain bf16 vs fp32 {own:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(k)
    for k in param_fields:
        a, r16, r32 = getattr(got, k).float(), getattr(ref16, k).float(), getattr(ref32, k).float()
        norm = float(r32.norm()) or 1.0
        rel32 = float((a - r32).norm()) / norm
        rel16 = float((a - r16).norm()) / norm
        own = float((r16 - r32).norm()) / norm
        good = math.isfinite(rel32) and rel32 <= K5_REL_BOUND and rel16 <= K5_REL_BOUND
        log(f"[kernels] {key} {label} d{k}: rel err vs plain fp32 {rel32:.3e}, vs plain bf16 "
            f"{rel16:.3e} (bound {K5_REL_BOUND}; plain bf16 vs fp32 {own:.3e}) "
            f"{'ok' if good else 'FAIL'}")
        if not good:
            bad.append(k)
    if bad:
        raise RuntimeError(f"{key} {label}: kernel disagrees with its plain version on {bad}")
    _record(results, key, label, max(errs), t_kernel, t_plain, work)


def _check_deterministic(key, label, a, b, fields):
    """Two runs of a backward kernel on the same inputs: every output the
    same bits (static schedules, ordered sums, no atomics)."""
    import torch

    torch.cuda.synchronize()
    bad = [k for k in fields if not torch.equal(getattr(a, k), getattr(b, k))]
    log(f"[kernels] {key} {label}: two runs {'bit-identical' if not bad else 'DIFFER'} on "
        f"{len(fields)} outputs")
    if bad:
        raise RuntimeError(f"{key} {label}: not deterministic on {bad}")


def _bwd_bytes_log(key, shape, c, nh, hidden, ws):
    """The backward's bytes moved per call by its design
    (csrc/swin_block_bwd.cu): activations in and out, the dW workspace
    written by K5a and read by K5b, x1's scratch and the partials each
    written and read once (K5b's repeated reads of an X tile by other
    output tiles are L2's)."""
    import torch

    from tpu_superresolution_torch.kernels import _lib
    from tpu_superresolution_torch.kernels.fused_block import bwd_bytes, bwd_grid, bwd_plan

    windows = shape[0] * (shape[1] // ws) * (shape[2] // ws)
    plan = bwd_plan(c, nh, hidden)
    grid, splits = bwd_grid(plan, windows, _lib.sm_count(torch.cuda.current_device()))
    sizes = bwd_bytes(plan, windows, nh, grid, splits)
    acts = math.prod(shape) * 2 * (3 if key == "K5" and c == 180 else 5)
    moved = acts + 2 * sum(sizes.values())
    log(f"[kernels] {key} {list(shape)} bytes moved by the design: " + ", ".join(
        f"{k} {v / 1e6:.1f} MB" for k, v in sizes.items())
        + f"; activations {acts / 1e6:.1f} MB; in all {moved / 1e6:.1f} MB "
        f"({moved / PEAK_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s); K5a grid {grid}, "
        f"K5b splits {splits} x {plan.units} units")


def _k7_route(w, ws, shift, mask, gelu_approx, scales, extra, shape):
    """The K7 route's composition of one block (what the models run
    where the block kernel does not take the widths): K2 for LN1, the
    shift and partition gathers, K7's three launches (the bias as the
    table + the map's token codes) and K1t, the weights packed once."""
    import functools

    import torch

    from tpu_superresolution_torch.kernels import fused_attention as fa
    from tpu_superresolution_torch.kernels import fused_block as fb
    from tpu_superresolution_torch.kernels.layernorm import layernorm
    from tpu_superresolution_torch.ops.window import window_codes_tensor

    pa = fa.pack_window_attention(w.wqkv, w.bqkv, w.wproj, w.bproj, table=w.table, ws=ws)
    pt = fb.pack_block_tail(w.g2, w.b2, w.wfc1, w.bfc1, w.wfc2, w.bfc2)
    codes = window_codes_tensor(shape[1], shape[2], ws, shift if mask is not None else 0,
                                torch.device("cuda"))

    def attention(xw, w_, ws_, mask_):
        return fa.fused_window_attention(xw, w.wqkv, w.bqkv, w.wproj, w.bproj, None, mask_,
                                         packed=pa, codes=codes)

    return lambda x: fb.swin_block_plain(
        x, w, ws, shift, mask, gelu_approx, scales, extra,
        ln1=lambda x, g, b: layernorm(x.contiguous(), g, b), attention=attention,
        tail=functools.partial(fb.fused_block_tail, packed=pt))


def _against_k7_route(key, label, run, route, x):
    """The block kernel and the K7 route's composition on the same
    inputs, each timed alone and 20 calls back to back, twice in the
    order kernel, composition, composition, kernel (the mean of the two);
    logged beside each other.  Returns the composition's b2b time."""
    fns = {"kernel": run, "K7 route": lambda: route(x)}
    alone, b2b = ({n: [] for n in fns} for _ in range(2))
    for n in ("kernel", "K7 route", "K7 route", "kernel"):
        alone[n].append(cuda_ms(fns[n]))
        b2b[n].append(queued_ms(fns[n]))
    mean = lambda v: sum(v) / len(v)
    t = {n: mean(v) for n, v in alone.items()}
    q = {n: mean(v) for n, v in b2b.items()}
    log(f"[kernels] {key} {label} against the K7 route (K2 + gathers + K7 + K1t): " + "; ".join(
        f"{n} {t[n]:.4f} ms ({' / '.join(f'{v:.4f}' for v in alone[n])}), b2b {q[n]:.4f} "
        f"({' / '.join(f'{v:.4f}' for v in b2b[n])})" for n in fns)
        + f"; kernel / K7 route {t['kernel'] / t['K7 route']:.2f}x alone, "
        f"{q['kernel'] / q['K7 route']:.2f}x b2b")
    return q["K7 route"]


def phase_kernels():
    import torch

    from tpu_superresolution_torch.kernels.fused_block import (
        GRAD_FIELDS,
        fused_swin_block_backward,
        fused_windows_block,
        pack_block_tiles,
        swin_block_bwd_plain,
        swin_block_plain,
    )
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    bf = torch.bfloat16
    res = {}

    # K1: swin block, shift 0 and 4 on the train batch and SwinIR-M's
    # bench batch (25 tiles of 64^2), a whole image, and the train batch
    # with stochastic-depth branch scales; at each row beside the K7
    # route's composition of the same block
    w = _random_block(gen, dev)
    tiles = pack_block_tiles(w)  # the forward's stream, which the backward (K5) reads too
    scales = torch.tensor([[1.0 / 0.9, 0.0], [1.0 / 0.9, 1.0 / 0.9]] * 4, device=dev)
    for shape, shift, sc in (((8, 64, 64, 180), 0, None), ((8, 64, 64, 180), 4, None),
                             ((25, 64, 64, 180), 0, None), ((25, 64, 64, 180), 4, None),
                             ((1, 256, 256, 180), 4, None), ((8, 64, 64, 180), 0, scales),
                             ((8, 64, 64, 180), 4, scales)):
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        mask = shift_mask_tensor(shape[1], shape[2], 8, shift, dev) if shift else None
        run = lambda: fused_windows_block(x, w, 8, shift, mask, True, packed=tiles,
                                          branch_scales=sc)
        out = run()
        ref16 = swin_block_plain(x, w, 8, shift, mask, True, sc)
        ref32 = swin_block_plain(x.float(), w, 8, shift, mask, True, sc)
        torch.cuda.synchronize()
        label = f"{list(shape)} shift {shift}" + ("" if sc is None else " branch scales")
        route = _k7_route(w, 8, shift, mask, True, sc, None, shape)
        t_route = _against_k7_route("K1", label, run, route, x)
        _compare(res, "K1", f"{label} (b2b {queued_ms(run):.4f} ms, K7 route b2b "
                 f"{t_route:.4f})", out, ref16, ref32, cuda_ms(run),
                 cuda_ms(lambda: swin_block_plain(x, w, 8, shift, mask, True, sc)),
                 _swin_work(shape))
        del out, ref16, ref32

    # The HAT block (C 96, 6 heads, hidden 384) with its CAB term `extra`:
    # K6 (ws 7) on the HAT bench's 25 tiles of 64^2 reflect-padded to 70^2,
    # K1 (ws 8) on hat_fast's 25 tiles of 64^2; and K6 at SwinIR's widths
    # without extra (a SwinIR checkpoint of window 7).
    for key, ws, shape, shift, (c, nh, hidden), with_extra in (
            ("K6", 7, (25, 70, 70, 96), 0, (96, 6, 384), True),
            ("K6", 7, (25, 70, 70, 96), 3, (96, 6, 384), True),
            ("K6", 7, (8, 56, 56, 180), 3, (180, 6, 360), False),
            ("K1", 8, (25, 64, 64, 96), 0, (96, 6, 384), True),
            ("K1", 8, (25, 64, 64, 96), 4, (96, 6, 384), True)):
        wb = _random_block(gen, dev, c, nh, hidden, ws)
        pk = pack_block_tiles(wb)
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        ex = (0.05 * torch.randn(*shape, generator=gen)).to(dev, bf) if with_extra else None
        mask = shift_mask_tensor(shape[1], shape[2], ws, shift, dev) if shift else None
        run = lambda: fused_windows_block(x, wb, ws, shift, mask, True, extra=ex, packed=pk)
        plain = lambda: swin_block_plain(x, wb, ws, shift, mask, True, extra=ex)
        out = run()
        ref16 = plain()
        ref32 = swin_block_plain(x.float(), wb, ws, shift, mask, True,
                                 extra=None if ex is None else ex.float())
        torch.cuda.synchronize()
        label = f"{list(shape)} ws {ws} shift {shift}" + (" extra" if with_extra else "")
        route = _k7_route(wb, ws, shift, mask, True, None, ex, shape)
        t_route = _against_k7_route(key, label, run, route, x)
        _compare(res, key, f"{label} (b2b {queued_ms(run):.4f} ms, K7 route b2b "
                 f"{t_route:.4f})", out, ref16, ref32, cuda_ms(run), cuda_ms(plain),
                 _swin_work(shape, c, hidden, ws=ws, extra=with_extra))
        del out, ref16, ref32

    # K5: the block backward at the train shape, shift 0 and 4, scales on,
    # on the forward's weight stream; the first row run twice for the same bits
    shape = (8, 64, 64, 180)
    for shift in (0, 4):
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        ct = (0.1 * torch.randn(*shape, generator=gen)).to(dev, bf)
        mask = shift_mask_tensor(shape[1], shape[2], 8, shift, dev) if shift else None
        run = lambda: fused_swin_block_backward(ct, x, w, 8, shift, mask, True, scales,
                                                packed=tiles)
        got = run()
        if shift == 0:
            _check_deterministic("K5", f"{list(shape)} shift {shift}", got, run(),
                                 ("dx",) + GRAD_FIELDS)
        ref16 = swin_block_bwd_plain(ct, x, w, 8, shift, mask, True, scales)
        ref32 = swin_block_bwd_plain(ct.float(), x.float(), w, 8, shift, mask, True, scales)
        torch.cuda.synchronize()
        _bwd_bytes_log("K5", shape, 180, 6, 360, 8)
        _compare_grads(res, "K5", f"{list(shape)} shift {shift} branch scales (b2b "
                       f"{queued_ms(run):.4f} ms)", got, ref16,
                       ref32, ("dx",), GRAD_FIELDS, cuda_ms(run),
                       cuda_ms(lambda: swin_block_bwd_plain(ct, x, w, 8, shift, mask, True,
                                                            scales)),
                       _swin_work(shape, backward=True))
        del got, ref16, ref32

    _layernorm_cases(res, gen, dev)

    # K3: 3x3 convs 180->180 and 180->64 on bench tiles, a whole image and
    # the train batch, HAT's 96->96 on its tiles, a [1,52,76,180] image
    # (sides not multiples of 8 or 16), ThreeConv's 180->45 and 45->180
    # and SwinIR-L's 240->240; K4: the composed 5x5 64->48 reconstruction
    # conv on bench tiles and the train batch, and the composed x2 and x3
    # kernels as ops/fused_upsample.py builds them.  Inference shapes run
    # with the weight packed once (as the models cache it), the train
    # batch with the packing in every call (as under autograd).
    _conv_cases(res, gen, dev, CONV_CASES)
    return res


# K2's rows: the bench trunk (25 tiles of 64^2, C 180), the train batch
# (8 x 64^2), HAT's trunk (25 tiles of 70^2, C 96) and SwinIR-L's (C 240)
LN_CASES = ((25 * 64 * 64, 180), (8 * 64 * 64, 180), (25 * 70 * 70, 96), (25 * 64 * 64, 240))


def _layernorm_cases(res, gen, dev):
    """K2 at LN_CASES against its plain version: one call from an idle
    device (cuda_ms, which counts the wrapper's host work before the
    launch), 20 calls back to back (queued_ms: the device time where the
    host keeps up), the wrapper's host time a call (_enqueue_ms), the
    kernel's device time by the profiler and F.layer_norm's times."""
    import torch
    import torch.nn.functional as F

    from tpu_superresolution_torch.kernels.layernorm import layernorm, layernorm_plain

    bf = torch.bfloat16
    for rows, c in LN_CASES:
        x = torch.randn(rows, c, generator=gen).to(dev, bf)
        g = (1 + 0.1 * torch.randn(c, generator=gen)).to(dev)
        b = (0.1 * torch.randn(c, generator=gen)).to(dev)
        g16, b16 = g.to(bf), b.to(bf)
        run = lambda: layernorm(x, g, b)
        lib = lambda: F.layer_norm(x, (c,), g16, b16, 1e-5)
        out = run()
        t_lib = cuda_ms(lib)
        _compare(res, "K2", f"[{rows}, {c}] (b2b {queued_ms(run):.4f} ms, host "
                 f"{_enqueue_ms(run):.4f} ms a call; F.layer_norm b2b {queued_ms(lib):.4f} ms)",
                 out, layernorm_plain(x, g, b), layernorm_plain(x.float(), g, b), cuda_ms(run),
                 cuda_ms(lambda: layernorm_plain(x, g, b)),
                 (8 * x.numel(), 2 * x.numel() * 2 + 2 * c * 4), t_lib)
        # the kernel's device time alone (b2b reads the host's rate where
        # the wrapper takes longer than the kernel)
        _launch_split("K2", f"[{rows}, {c}]", run, (("the kernel", "layernorm_", ""),), calls=10)
        del x, out


# K3/K4 cases: (key, input shape, Cout (or "x2"/"x3": the composed
# reconstruction), k, weight packed once[, the GELU in the epilogue]);
# the first of each key is its row in the JSON line.  The last two are
# the CAB of HAT at embed 264 (past K12's widths: K2 + K3 + K3).
CONV_CASES = [("K3", (25, 64, 64, 180), 180, 3, True),
              ("K3", (25, 64, 64, 180), 64, 3, True),
              ("K3", (1, 256, 256, 180), 180, 3, True),
              ("K3", (1, 256, 256, 180), 64, 3, True),
              ("K3", (8, 64, 64, 180), 180, 3, False),
              ("K3", (25, 70, 70, 96), 96, 3, True),
              ("K4", (25, 64, 64, 64), 48, 5, True),
              ("K4", (8, 64, 64, 64), 48, 5, False),
              ("K3", (1, 52, 76, 180), 180, 3, True),
              ("K3", (25, 64, 64, 180), 45, 3, True),
              ("K3", (25, 64, 64, 45), 180, 3, True),
              ("K3", (25, 64, 64, 240), 240, 3, True),
              ("K4", (25, 64, 64, 64), "x2", 5, True),
              ("K4", (25, 64, 64, 64), "x3", 5, True),
              ("K3", (4, 70, 70, 264), 88, 3, True, True),
              ("K3", (4, 70, 70, 88), 264, 3, True)]


def _conv_cases(res, gen, dev, cases):
    """Each K3/K4 case against its plain version, timed beside cuDNN; its
    route, its ratio to cuDNN and its share of the bound."""
    import torch
    import torch.nn.functional as F

    from tpu_superresolution_torch.kernels.cab_conv import (
        conv3x3,
        conv_k,
        conv_plain,
        conv_route,
        conv_vec,
        pack_conv_weight,
    )

    bf = torch.bfloat16
    for key, shape, cout, k, prepacked, *act in cases:
        gelu = bool(act and act[0])
        cin = shape[-1]
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        if isinstance(cout, str):  # a composed reconstruction kernel
            comp = _random_composed(gen, int(cout[1:]), cin, dev)
            kern, bias, pad = comp.kernel, comp.bias, comp.pad
            label = f"{list(shape)} -> {int(kern.shape[3])}, 5x5 ({cout} reconstruction)"
            cout = int(kern.shape[3])
        else:
            kern = (torch.randn(k, k, cin, cout, generator=gen) * (k * k * cin) ** -0.5).to(dev, bf)
            bias = (0.1 * torch.randn(cout, generator=gen)).to(dev)
            pad = ((k // 2, k // 2), (k // 2, k // 2))
            label = f"{list(shape)} -> {cout}, {k}x{k}{' + GELU' if gelu else ''}"
        packed = pack_conv_weight(kern) if prepacked else None
        label += "" if prepacked else " (weight packed in the call)"
        fn = ((lambda: conv3x3(x, kern, bias, packed, gelu=gelu)) if key == "K3"
              else (lambda: conv_k(x, kern, bias, pad, packed)))
        out = fn()
        # the one-call library yardstick: cuDNN on the same NHWC tensor
        xn, wn, b16 = x.permute(0, 3, 1, 2), kern.permute(3, 2, 0, 1).contiguous(), bias.to(bf)
        (pt, pb), (pl, pr) = pad
        lib = ((lambda: F.conv2d(xn, wn, b16, padding=k // 2)) if pt == pb and pl == pr
               else (lambda: F.conv2d(F.pad(xn, (pl, pr, pt, pb)), wn, b16)))
        pixels = math.prod(shape[:3])
        plan = conv_route(cin, cout, k, k)
        t_kernel, t_lib = cuda_ms(fn), cuda_ms(lib)
        plain = lambda: conv_plain(x, kern, bias, pad, gelu)
        _compare(res, key, label, out,
                 plain(), conv_plain(x.float(), kern.float(), bias, pad, gelu),
                 t_kernel, cuda_ms(plain),
                 (2 * pixels * cin * cout * k * k,
                  pixels * (cin + cout) * 2 + kern.numel() * 2 + cout * 4),
                 t_lib)
        row = res[key][-1]
        if gelu:
            log(f"[kernels] {key} {label}: the same conv without the GELU "
                f"{cuda_ms(lambda: conv3x3(x, kern, bias, packed)):.4f} ms")
        log(f"[kernels] {key} {label}: route {plan.describe(conv_vec(x, plan))}; "
            f"{row['ms'] / t_lib:.3f}x cuDNN, {row['bound_ms'] / row['ms']:.1%} of the bound; "
            f"20 calls back to back: kernel {queued_ms(fn):.4f} ms, cuDNN {queued_ms(lib):.4f} ms "
            f"a call")
        del out


def _random_composed(gen, scale, cin, device):
    """The composed reconstruction (x2: conv nf -> 4 nf, PixelShuffle(2);
    x3: conv -> 9 nf, PixelShuffle(3); then conv_last nf -> 3) as
    ops/fused_upsample.py builds it for K4, from seeded random weights."""
    import torch
    import torch.nn as nn

    from tpu_superresolution_torch.models.blocks import PixelShuffleUpsample, hwio
    from tpu_superresolution_torch.ops.fused_upsample import compose_upsample

    up, last = PixelShuffleUpsample(scale, cin), nn.Conv2d(cin, 3, 3, 1, 1)
    with torch.no_grad():
        for p in list(up.parameters()) + list(last.parameters()):
            scale = p[0].numel() ** -0.5 if p.dim() > 1 else 0.1
            p.copy_(torch.randn(p.shape, generator=gen) * scale)
    return compose_upsample(up.stages(), (hwio(last.weight), last.bias), torch.bfloat16, device)

    return res


def _random_ocab(gen, device, c=96, nh=6, hidden=384):
    """OCAB weights with O(1) activations (bf16-representable GEMM
    weights), as _random_block's."""
    import torch

    from tpu_superresolution_torch.kernels.fused_ocab import OcabWeights

    def r(*shape, scale=1.0, bf=False):
        t = torch.randn(*shape, generator=gen) * scale
        return (t.bfloat16().float() if bf else t).to(device)

    return OcabWeights(
        wproj=r(c, c, scale=c ** -0.5, bf=True), bproj=r(c, scale=0.1),
        g2=1 + r(c, scale=0.1), b2=r(c, scale=0.1),
        wfc1=r(hidden, c, scale=c ** -0.5, bf=True), bfc1=r(hidden, scale=0.1),
        wfc2=r(c, hidden, scale=hidden ** -0.5, bf=True), bfc2=r(c, scale=0.1), num_heads=nh)


def _ocab_work(windows, nq, nk, c, nh, hidden, backward=False, qkv_map=False):
    """(FLOPs, bytes) of K8 (or its backward) at the unpadded widths: per
    window QK^T and AV over nq x nk, proj, fc1 and fc2; the backward
    recomputes all but fc2 and does two products per forward one.
    Bytes: q, sw, k, v read once, the output written (the backward: ct
    read, dq, dk, dv, dsw written), in bf16; with `qkv_map` (the map
    entry) the qkv map and x in their place, each token once (the
    backward: ct, qkv and x read, d qkv and dx written); weights in bf16,
    bias in fp32 (and their fp32 gradients)."""
    fwd = {"qk": 2 * nq * nk * c, "av": 2 * nq * nk * c, "proj": 2 * nq * c * c,
           "fc1": 2 * nq * c * hidden, "fc2": 2 * nq * c * hidden}
    per = sum(fwd.values())
    weights, bias = c * c + 2 * c * hidden, nh * nq * nk
    acts = (4 * nq if qkv_map else 2 * nq + 2 * nk) * c * 2
    if not backward:
        return windows * per, windows * (acts + nq * c * 2) + weights * 2 + bias * 4
    per = per - fwd["fc2"] + 2 * per
    return (windows * per, windows * (2 * acts + nq * c * 2) + weights * (2 + 4)
            + bias * (4 + 4))


def _ocab_map_windows(qkv, x):
    """The window-layout operands of the OCAB's maps at (16, 24): q and
    sw [BW, 256, C], k and v [BW, 576, C] (the zero border)."""
    from tpu_superresolution_torch.ops.window import overlap_windows, window_partition

    q, k, v = qkv.chunk(3, -1)
    return (window_partition(q, 16), overlap_windows(k, 16, 24), overlap_windows(v, 16, 24),
            window_partition(x, 16))


def _ocab_map_plain(qkv, x, w, bias, gelu_approx):
    """The plain version of the map entry (``fused_ocab_core_map``): the
    window gathers, the plain core, the window reverse."""
    from tpu_superresolution_torch.kernels.fused_ocab import ocab_core_plain
    from tpu_superresolution_torch.ops.window import window_reverse

    b, h, wd, _ = x.shape
    return window_reverse(ocab_core_plain(*_ocab_map_windows(qkv, x), w, bias, gelu_approx), 16,
                          h, wd)


def _ocab_map_bwd_plain(ct, q, k, v, sw, w, bias, gelu_approx, shape):
    """The plain version of the map entry's backward: the plain core's
    backward on the window-layout operands, then dq, dk, dv into the qkv
    map `shape` through the gathers' autograd and dsw to the map."""
    import torch

    from tpu_superresolution_torch.kernels.fused_ocab import ocab_core_bwd_plain
    from tpu_superresolution_torch.ops.window import window_reverse

    r = ocab_core_bwd_plain(ct, q, k, v, sw, w, bias, gelu_approx)
    leaf = torch.zeros(shape, dtype=q.dtype, device=q.device, requires_grad=True)
    dqkv, = torch.autograd.grad(_ocab_map_windows(leaf, leaf[..., :1])[:3], leaf,
                                [r.dq, r.dk, r.dv])
    return r, dqkv, window_reverse(r.dsw, 16, shape[1], shape[2])


def phase_train_kernels(res):
    """The training kernels at the HAT train step's shapes (batch 8 of
    64^2 LR crops; ws 7 pads them to 70^2): K6b, the ws-7 block backward,
    at [8,70,70,96] shift 0 and 3 with `extra` and branch scales; K5 with
    d`extra` at hat_fast's [8,64,64,96]; K8 and K8b, the OCAB core and
    its backward, on HAT's 800 windows (49 queries x 100 keys) and
    hat_fast's 512 (64 x 144) (``_ocab_cases``), then K8B_ENVELOPE; then
    HAT's and hat_fast's OCAB at the serving batch on the fused route
    (K8) against the module path (``_ocab_serve_routes``).  Each against
    its plain version in bf16 and fp32, with times and bounds, into
    `res`."""
    import torch

    from tpu_superresolution_torch.kernels.fused_block import (
        GRAD_FIELDS,
        fused_swin_block_backward,
        pack_block_tiles,
        swin_block_bwd_plain,
    )
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    bf = torch.bfloat16
    scales = torch.tensor([[1.0 / 0.9, 0.0], [1.0 / 0.9, 1.0 / 0.9]] * 4, device=dev)
    c, nh, hidden = 96, 6, 384
    for key, ws, shape, shift in (("K6b", 7, (8, 70, 70, c), 0), ("K6b", 7, (8, 70, 70, c), 3),
                                  ("K5", 8, (8, 64, 64, c), 0), ("K5", 8, (8, 64, 64, c), 4)):
        wb = _random_block(gen, dev, c, nh, hidden, ws)
        pk = pack_block_tiles(wb)  # the forward's stream, which K6b / K5 read
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        ct = (0.1 * torch.randn(*shape, generator=gen)).to(dev, bf)
        ex = (0.05 * torch.randn(*shape, generator=gen)).to(dev, bf)
        mask = shift_mask_tensor(shape[1], shape[2], ws, shift, dev) if shift else None
        run = lambda: fused_swin_block_backward(ct, x, wb, ws, shift, mask, True, scales,
                                                packed=pk, extra=ex)
        plain = lambda: swin_block_bwd_plain(ct, x, wb, ws, shift, mask, True, scales, ex)
        got = run()
        if shift == 0:  # the same bits on a second run
            _check_deterministic(key, f"{list(shape)} ws {ws} shift {shift}", got, run(),
                                 ("dx", "extra") + GRAD_FIELDS)
        ref16 = plain()
        ref32 = swin_block_bwd_plain(ct.float(), x.float(), wb, ws, shift, mask, True, scales,
                                     ex.float())
        torch.cuda.synchronize()
        _bwd_bytes_log(key, shape, c, nh, hidden, ws)
        _compare_grads(res, key, f"{list(shape)} ws {ws} shift {shift} extra, branch scales "
                       f"(b2b {queued_ms(run):.4f} ms)",
                       got, ref16, ref32, ("dx", "extra"), GRAD_FIELDS, cuda_ms(run),
                       cuda_ms(plain), _swin_work(shape, c, hidden, backward=True, ws=ws,
                                                 extra=True))
        del got, ref16, ref32

    _ocab_cases(res, gen, dev, c, nh, hidden)
    _ocab_bwd_envelope(gen, dev)
    # HAT's and hat_fast's OCABs at serving (the module path serves them)
    _ocab_serve_routes(gen, dev, c, nh, 7, hidden / c, (25, 70, 70))
    _ocab_serve_routes(gen, dev, c, nh, 8, hidden / c, (25, 64, 64))
    return res


def _ocab_cases(res, gen, dev, c, nh, hidden):
    """K8 and K8b on HAT's 800 windows (49 queries x 100 keys) and
    hat_fast's 512 (64 x 144) against their plain versions: K8 (its three
    launches on one ``pack_ocab_tiles`` pack) and K8b (its four launches
    on K8's kept head-major q, k, v, O and row statistics), each with two
    runs bit-identical, back-to-back times, its launches by part, its
    bytes by design and its host time, into `res`."""
    import torch

    from tpu_superresolution_torch.kernels import _lib, fused_ocab

    bf = torch.bfloat16
    for ws, ows, windows in ((7, 10, 800), (8, 12, 512)):
        w = _random_ocab(gen, dev, c, nh, hidden)
        nq, nk = ws * ws, ows * ows
        rnd = lambda *shape, sc=1.0: (sc * torch.randn(*shape, generator=gen)).to(dev, bf)
        # q carries the hd^-0.5 pre-scale: O(1) scores
        q, k, v, sw = rnd(windows, nq, c, sc=0.25), rnd(windows, nk, c), rnd(windows, nk, c), \
            rnd(windows, nq, c)
        bias = (0.5 * torch.randn(nh, nq, nk, generator=gen)).to(dev)
        ct = rnd(windows, nq, c, sc=0.1)
        f32 = [t.float() for t in (q, k, v, sw)]
        label = f"{windows} windows, {nq} queries x {nk} keys, C {c}, hidden {hidden}"
        # K8 as a training call runs it: one pack, the three launches
        pk = fused_ocab.pack_ocab_tiles(w)
        fwd = lambda: fused_ocab._launch_fwd(q, k, v, sw, pk, bias, True)
        run = lambda: fwd()[0]
        plain = lambda: fused_ocab.ocab_core_plain(q, k, v, sw, w, bias, True)
        out, kept = fwd()
        if not torch.equal(out, run()):
            raise RuntimeError(f"K8 {label}: two runs differ")
        log(f"[kernels] K8 {label}: two runs bit-identical")
        _ocab_fwd_bytes_log(windows, ws, ows, c, nh, hidden)
        _launch_split("K8", label, run, _k8_parts(ws))
        full = lambda: fused_ocab.fused_ocab_core(q, k, v, sw, w, bias, True)
        _compare(res, "K8", f"{label} (b2b {queued_ms(run):.4f} ms; with the packing "
                 f"{cuda_ms(full):.4f}, b2b {queued_ms(full):.4f}; host {_enqueue_ms(full):.4f} "
                 f"ms a call, of it the packing "
                 f"{_enqueue_ms(lambda: fused_ocab.pack_ocab_tiles(w)):.4f})",
                 out, plain(), fused_ocab.ocab_core_plain(*f32, w, bias, True), cuda_ms(run),
                 cuda_ms(plain), _ocab_work(windows, nq, nk, c, nh, hidden))
        # K8b on the kept tensors: the four launches a training backward runs
        runb = lambda: _ocab_grads(fused_ocab._launch_bwd(ct, sw, nk, pk, bias, True, kept))
        plainb = lambda: fused_ocab.ocab_core_bwd_plain(ct, q, k, v, sw, w, bias, True)
        got = runb()
        fields = ("dq", "dk", "dv", "dsw") + fused_ocab.GRAD_FIELDS + ("bias",)
        _check_deterministic("K8b", label, got, runb(), fields)
        standalone = fused_ocab.fused_ocab_core_backward(ct, q, k, v, sw, w, bias, True)
        _check_deterministic("K8b", f"{label} (the standalone entry, its own forward, against "
                             f"the kept tensors')", got, standalone, fields)
        ref16 = plainb()
        ref32 = fused_ocab.ocab_core_bwd_plain(ct.float(), *f32, w, bias, True)
        torch.cuda.synchronize()
        _ocab_bwd_bytes_log(windows, ws, ows, c, nh, hidden)
        _launch_split("K8b", label, runb, _k8b_parts(ws))
        p = fused_ocab.ocab_bwd_plan(ws, ows, c, nh, hidden, windows,
                                     _lib.sm_count(torch.cuda.current_device()))
        gv = torch.zeros(p.block.stream_len + p.block.vec_len, device=dev)
        log(f"[kernels] K8b {label} host time a call (enqueue, median of 20) of the fold "
            f"{_enqueue_ms(lambda: fused_ocab._fold_grads(gv, c, nh, hidden)):.4f} ms")
        _compare_grads(res, "K8b", f"{label} (b2b {queued_ms(runb):.4f} ms, host "
                       f"{_enqueue_ms(runb):.4f} ms a call)", got, ref16, ref32,
                       ("dq", "dk", "dv", "dsw"), fused_ocab.GRAD_FIELDS + ("bias",),
                       cuda_ms(runb), cuda_ms(plainb),
                       _ocab_work(windows, nq, nk, c, nh, hidden, backward=True))
        del out, kept, got, standalone, ref16, ref32


def _ocab_grads(r):
    """K8b's ``_launch_bwd`` result (dq, dk, dv, dsw, gradients) as
    ``OcabGrads``."""
    from tpu_superresolution_torch.kernels.fused_ocab import OcabGrads

    dq, dk, dv, dsw, g = r
    return OcabGrads(dq=dq, dk=dk, dv=dv, dsw=dsw, **g)


def _k8_parts(ws):
    """K8's launches by name (csrc/ocab_bwd.cu) for _launch_split: (part,
    name head, name tail); the rest of a call's device time is O's
    zeroing (at C 96 none)."""
    return (("gather to head-major", "ocab_win_heads_kernel", ""),
            ("attention", "ocab_win_attn_kernel", "false>("),
            ("K5a OCAB tail", f"swin_block_bwd_kernel<{ws},", ", 4>("))


def _k8b_parts(ws):
    """K8b's launches by name (csrc/ocab_bwd.cu) for _launch_split: (part,
    name head, name tail)."""
    return (("K5a middle", f"swin_block_bwd_kernel<{ws},", ", 2>("),
            ("attention backward", "ocab_win_attn_kernel", "true>("),
            ("K5b dW", "wgrad_wg_kernel", ""), ("K5c sums", "reduce_ordered_kernel", ""))


# K8's and K8b's correctness-only shapes past HAT's widths, one a compiled
# (ws, width, head dim) the main path does not run: (ws, ows, windows, C,
# heads, hidden); odd window counts leave a CTA's last stage one window
K8B_ENVELOPE = ((7, 10, 37, 64, 2, 128), (7, 10, 45, 180, 6, 360), (8, 12, 25, 64, 2, 200),
                (8, 12, 13, 144, 6, 288))


def _ocab_bwd_envelope(gen, dev):
    """K8 and K8b at K8B_ENVELOPE's widths against their plain versions
    (fp32), each with two runs bit-identical."""
    import torch

    from tpu_superresolution_torch.kernels import fused_ocab

    bf = torch.bfloat16
    for ws, ows, windows, c, nh, hidden in K8B_ENVELOPE:
        w = _random_ocab(gen, dev, c, nh, hidden)
        nq, nk = ws * ws, ows * ows
        rnd = lambda *shape, sc=1.0: (sc * torch.randn(*shape, generator=gen)).to(dev, bf)
        q, k, v, sw = rnd(windows, nq, c, sc=(c // nh) ** -0.5), rnd(windows, nk, c), \
            rnd(windows, nk, c), rnd(windows, nq, c)
        bias = (0.5 * torch.randn(nh, nq, nk, generator=gen)).to(dev)
        ct = rnd(windows, nq, c, sc=0.1)
        args = (q, k, v, sw)
        label = f"envelope {windows} windows ({ws}, {ows}), C {c}, {nh} heads, hidden {hidden}"
        fwd = lambda: fused_ocab.fused_ocab_core(q, k, v, sw, w, bias, False)
        out = fwd()
        if not torch.equal(out, fwd()):
            raise RuntimeError(f"K8 {label}: two runs differ")
        _compare({}, "K8", label + " (two runs bit-identical)", out,
                 fused_ocab.ocab_core_plain(*args, w, bias, False),
                 fused_ocab.ocab_core_plain(*(t.float() for t in args), w, bias, False), 0.0, 0.0,
                 _ocab_work(windows, nq, nk, c, nh, hidden))
        run = lambda: fused_ocab.fused_ocab_core_backward(ct, q, k, v, sw, w, bias, False)
        got = run()
        _check_deterministic("K8b", label, got, run(), ("dq", "dk", "dv", "dsw")
                             + fused_ocab.GRAD_FIELDS + ("bias",))
        _compare_grads({}, "K8b", label, got,
                       fused_ocab.ocab_core_bwd_plain(ct, *args, w, bias, False),
                       fused_ocab.ocab_core_bwd_plain(ct.float(), *(t.float() for t in args), w,
                                                      bias, False),
                       ("dq", "dk", "dv", "dsw"), fused_ocab.GRAD_FIELDS + ("bias",), 0.0, 0.0,
                       _ocab_work(windows, nq, nk, c, nh, hidden, backward=True))
        del out, got


def _ocab_fwd_bytes_log(windows, ws, ows, c, nh, hidden):
    """K8's bytes moved per call by the design (csrc/ocab_bwd.cu): q, k, v
    read in the window layout by the gather, the head-major q, k, v
    written and read, O written and read, the row statistics and x1's
    scratch written (x1's read back once), sw read and the output written,
    the bias read by the attention kernel and the weight stream by every
    K5a CTA (from L2)."""
    import torch

    from tpu_superresolution_torch.kernels import _lib
    from tpu_superresolution_torch.kernels import fused_ocab as fo

    p = fo.ocab_bwd_plan(ws, ows, c, nh, hidden, windows,
                         _lib.sm_count(torch.cuda.current_device()))
    sizes = fo.ocab_fwd_bytes(p, nh)
    nq, nk = ws * ws, ows * ows
    win = windows * (nq + 2 * nk) * c * 2
    tok = windows * nq * c * 2
    moved = (win + 2 * (sizes["head-major q, k, v"] + sizes["O"] + sizes["x1 scratch"])
             + sizes["row statistics"] + 2 * tok + nh * nq * nk * 4)
    log(f"[kernels] K8 {windows} windows ({ws}, {ows}) bytes moved by the design: q, k, v in "
        f"{win / 1e6:.1f} MB, sw in and out {2 * tok / 1e6:.1f} MB, "
        + ", ".join(f"{k} {v / 1e6:.2f} MB" for k, v in sizes.items())
        + f" (each written once, all but the statistics read once); in all {moved / 1e6:.1f} "
        f"MB ({moved / PEAK_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s); K5a grid {p.grid} over "
        f"{windows} units, attention {p.cph} CTAs a head, shared memory {p.block.smem} / "
        f"{p.att_fwd_smem} B")


def _ocab_bwd_bytes_log(windows, ws, ows, c, nh, hidden):
    """K8b's bytes moved per call by the design (csrc/ocab_bwd.cu): K8's
    kept head-major q, k, v, O and row statistics read (q, k, v and the
    statistics by the attention kernel, O by K5a's middle), each
    workspace of ``ocab_bwd_bytes`` written once and read once, dq, dk, dv
    written in the window layout, ct, sw and dsw, the bias read by the
    attention kernel."""
    import torch

    from tpu_superresolution_torch.kernels import _lib
    from tpu_superresolution_torch.kernels import fused_ocab as fo

    p = fo.ocab_bwd_plan(ws, ows, c, nh, hidden, windows,
                         _lib.sm_count(torch.cuda.current_device()))
    sizes = fo.ocab_bwd_bytes(p, nh)
    kept = fo.ocab_fwd_bytes(p, nh)
    kept.pop("x1 scratch")
    b, nq, nk = p.block, ws * ws, ows * ows
    win = windows * (nq + 2 * nk) * c * 2  # dq, dk, dv in the window layout
    tok = windows * nq * c * 2
    moved = win + sum(kept.values()) + 3 * tok + 2 * sum(sizes.values()) + nh * nq * nk * 4
    log(f"[kernels] K8b {windows} windows ({ws}, {ows}) bytes moved by the design: dq, dk, dv "
        f"out {win / 1e6:.1f} MB, K8's kept "
        + ", ".join(f"{k} {v / 1e6:.2f} MB" for k, v in kept.items())
        + f" read once, ct, sw, dsw {3 * tok / 1e6:.1f} MB, "
        + ", ".join(f"{k} {v / 1e6:.2f} MB" for k, v in sizes.items())
        + f" (each written and read once); in all {moved / 1e6:.1f} MB "
        f"({moved / PEAK_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s); K5a grid {p.grid} over "
        f"{windows} units, K5b splits {p.splits}, attention {p.cph} CTAs a head, shared memory "
        f"{b.smem} / {p.att_bwd_smem} B")


# the tiled block backward's counter by window (csrc/swin_block_bwd16.cu)
TILED_KEYS = {16: "K5w16", 8: "K5r"}


def _tiled_bytes_log(shape, c, nh, hidden, ws=16, extra=True):
    """K5w16's / K5r's bytes moved per call by its design
    (csrc/swin_block_bwd16.cu): activations in and out, then each buffer
    written once and read once (the workspace by K5b, the head tiles and
    row statistics by the attention kernels, dx1 by the tail, the
    partials by K5c)."""
    import torch

    from tpu_superresolution_torch.kernels import _lib
    from tpu_superresolution_torch.kernels.fused_block import bwd16_plan, k5r_plan, tiled_bwd_bytes

    key = TILED_KEYS[ws]
    windows = shape[0] * (shape[1] // ws) * (shape[2] // ws)
    plan_of = bwd16_plan if ws == 16 else k5r_plan
    p = plan_of(c, nh, hidden, windows, _lib.sm_count(torch.cuda.current_device()))
    sizes = tiled_bwd_bytes(p, nh)
    acts = math.prod(shape) * 2 * (5 if extra else 3)  # x, ct (, extra) in; dx (, d extra) out
    moved = acts + 2 * sum(sizes.values())
    log(f"[kernels] {key} {list(shape)} bytes moved by the design: " + ", ".join(
        f"{k} {v / 1e6:.1f} MB" for k, v in sizes.items())
        + f"; activations {acts / 1e6:.1f} MB; in all {moved / 1e6:.1f} MB "
        f"({moved / PEAK_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s); K5a grid {p.grid} over "
        f"{p.units} 64-token units, attention {p.cph} CTAs a head over {p.att_units} (window, "
        f"head) units, {p.wps} windows a stage, in {p.rounds} rounds (the last on "
        f"{p.tail_ctas} CTAs), shared memory "
        f"{p.block.smem} / {p.att_fwd_smem} / {p.att_bwd_smem} B, K5b splits {p.splits} x "
        f"{p.block.units} units")


def _tiled_parts(ws):
    """K5w16's (ws 16) / K5r's (ws 8) launches by kernel name
    (csrc/swin_block_bwd16.cu): K5a's modes, the attention kernels, K5b,
    K5c."""
    k5a, att = f"swin_block_bwd_kernel<{ws},", f"attn16_kernel<{ws},"
    return (("front (LN1, qkv)", k5a, ", 1>("), ("attention forward", att, "false>("),
            ("middle (proj .. do)", k5a, ", 2>("), ("attention backward", att, "true>("),
            ("tail (dy, LN1, dx)", k5a, ", 3>("), ("K5b dW", "wgrad_wg_kernel", ""),
            ("K5c sums", "reduce_ordered_kernel", ""))


def _tiled_split(run, calls=3, ws=16):
    """Each of K5w16's (K5r's at ws 8) launches timed by torch.profiler
    over `calls` calls: device ms a call by part, and the rest of the
    call's device time (the wrapper's allocations, the fold)."""
    import torch

    from tpu_superresolution_torch.utils.profiling import device_split, kernel_ms

    key = TILED_KEYS[ws]
    run()
    torch.cuda.synchronize()
    try:
        kernels = device_split(lambda: [run() for _ in range(calls)]).kernels
    except Exception as e:  # the split is a reading aid, not a check
        log(f"[kernels] {key} profiler failed: {type(e).__name__}: {e}")
        return
    parts, seen = [], set()
    for label, head, tail in _tiled_parts(ws):
        ev = [e for e in kernels if head in e.name and tail in e.name]
        seen.update(id(e) for e in ev)
        parts.append(f"{label} {sum(kernel_ms(e) for e in ev) / calls:.4f} ms "
                     f"x{len(ev) // calls}")
    rest = sum(kernel_ms(e) for e in kernels if id(e) not in seen) / calls
    busy = sum(kernel_ms(e) for e in kernels) / calls
    log(f"[kernels] {key} launches by part (profiler, {calls} calls): " + ", ".join(parts)
        + f"; other device work {rest:.4f} ms; busy {busy:.4f} ms a call")


def phase_w16_kernels(res):
    """The ws-16 training kernels at the HAT-SRx4 train step's shapes
    (``hat_srx4_config()``, batch 8 of 64^2 LR crops): K5w16 at hidden
    360 (``_k5w16_rows``); K8w16 and K8bw16 on the step's 128 windows and
    K8w16 on the serving batch's 400 (``_k8w16_rows``); then
    OCAB16_ENVELOPE, the gathers and the serving route, into `res`."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 7)
    _k5w16_rows(res, gen, dev, 360)
    _k8w16_rows(res, gen, dev, 360, (8, 25))
    _ocab16_envelope(res, gen, dev)
    _ocab16_gather_check(gen, dev)
    _ocab_serve_routes(gen, dev)
    return res


def _k5w16_rows(res, gen, dev, hidden, split=True):
    """K5w16, the K7 route's block backward, at the HAT-SRx4 train step's
    [8,64,64,180], 6 heads, MLP `hidden`: shift 8 (with the mask) and
    shift 0, `extra` and branch scales, on the forward's weight stream
    (``pack_block_tiles``), on dx, d extra and the 13 parameter
    gradients, each run twice for the same bits, timed alone and 20
    calls back to back, with its bytes moved by design and (with `split`)
    each launch's time; against its plain version in bf16 and fp32,
    within W16_ULPS bf16 ulps (dx, d extra) and K5_REL_BOUND (parameter
    gradients), with times and bounds, into `res`."""
    import torch

    from tpu_superresolution_torch.kernels.fused_block import (
        GRAD_FIELDS,
        fused_swin_block_backward,
        pack_block_tiles,
        swin_block_bwd_plain,
    )
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    bf = torch.bfloat16
    scales = torch.tensor([[1.0 / 0.9, 0.0], [1.0 / 0.9, 1.0 / 0.9]] * 4, device=dev)
    c, nh, ws = 180, 6, 16
    shape = (8, 64, 64, c)
    wb = _random_block(gen, dev, c, nh, hidden, ws)
    pk = pack_block_tiles(wb)  # the stream WindowBlockFunction packs once a step
    x = torch.randn(*shape, generator=gen).to(dev, bf)
    ct = (0.1 * torch.randn(*shape, generator=gen)).to(dev, bf)
    ex = (0.05 * torch.randn(*shape, generator=gen)).to(dev, bf)
    for shift in (8, 0):
        mask = shift_mask_tensor(shape[1], shape[2], ws, shift, dev) if shift else None
        run = lambda: fused_swin_block_backward(ct, x, wb, ws, shift, mask, True, scales,
                                                packed=pk, extra=ex)
        plain = lambda: swin_block_bwd_plain(ct, x, wb, ws, shift, mask, True, scales, ex)
        got, again = run(), run()
        ref16 = plain()
        ref32 = swin_block_bwd_plain(ct.float(), x.float(), wb, ws, shift, mask, True, scales,
                                     ex.float())
        torch.cuda.synchronize()
        if shift:
            _tiled_bytes_log(shape, c, nh, hidden)
        _compare_grads(res, "K5w16", f"{list(shape)} hidden {hidden} ws {ws} shift {shift} extra, "
                       f"branch scales (b2b {queued_ms(run):.4f} ms)", got, ref16, ref32,
                       ("dx", "extra"), GRAD_FIELDS, cuda_ms(run), cuda_ms(plain),
                       _swin_work(shape, c, hidden, backward=True, ws=ws, extra=True),
                       ulps=W16_ULPS)
        _check_deterministic("K5w16", f"{list(shape)} hidden {hidden} ws {ws} shift {shift}", got,
                             again, ("dx", "extra") + GRAD_FIELDS)
        if split:
            _tiled_split(run)
        del got, again, ref16, ref32


def _k8w16_rows(res, gen, dev, hidden, batches):
    """K8w16 and K8bw16, the OCAB core and its backward, as the OCAB
    calls them (the map entry with its gather from the qkv map; the
    backward with the gather's backward), at C 180, 6 heads, MLP
    `hidden`, 256 queries x 576 keys a window, on [batch, 64, 64] maps
    for each of `batches` (8: the train step's 128 windows, forward and
    backward; 25: the serving batch's 400, the forward alone), each run
    twice for the same bits, beside its launches alone, with its bytes
    moved by design and each launch's time; against its plain version in
    bf16 and fp32, within W16_ULPS bf16 ulps (outputs, activation
    gradients) and K5_REL_BOUND (parameter gradients), into `res`."""
    import torch

    from tpu_superresolution_torch.kernels import fused_ocab
    from tpu_superresolution_torch.ops.window import window_partition

    bf = torch.bfloat16
    c, nh, nq, nk = 180, 6, 256, 576
    w = _random_ocab(gen, dev, c, nh, hidden)
    rnd = lambda *shape, sc=1.0: (sc * torch.randn(*shape, generator=gen)).to(dev, bf)
    bias = (0.5 * torch.randn(nh, nq, nk, generator=gen)).to(dev)
    pk = fused_ocab.pack_ocab_tiles(w)
    hdp = pk.layout.hdp
    # the OCAB's main path: the K8w16 call is the map entry (the gather from
    # the qkv map, then K8w16's launches), the K8bw16 call what the autograd
    # nodes run (K8bw16's launches on the forward's O and row statistics,
    # then the gather's backward); each beside its launches alone on the
    # gathered operands
    for batch in batches:
        mshape = (batch, 64, 64)
        windows = batch * 16
        qkv, x = rnd(*mshape, 3 * c), rnd(*mshape, c)
        qkv[..., :c] *= 0.25
        qh, kh, vh = fused_ocab._launch_heads(qkv, nh, hdp)
        q, k, v, sw = _ocab_map_windows(qkv, x)
        f32 = [t.float() for t in (q, k, v, sw)]
        label = (f"{windows} windows ({'train step' if batch == 8 else 'serving batch'}, "
                 f"{list(mshape) + [c]} map), {nq} queries x {nk} keys, C {c}, hidden {hidden}")
        run = lambda: fused_ocab.fused_ocab_core_map(qkv, x, w, bias, True, pk)
        launches = lambda: fused_ocab._launch_fwd16(qh, kh, vh, x, pk, bias, True)[0]
        plain = lambda: _ocab_map_plain(qkv, x, w, bias, True)
        out, again, alone = run(), run(), launches()
        torch.cuda.synchronize()
        if not torch.equal(out, alone):
            raise RuntimeError("K8w16: the map entry's output differs from its launches'")
        _compare(res, "K8w16", f"{label}; the call with its gather (b2b {queued_ms(run):.4f} ms; "
                 f"K8w16's launches alone {cuda_ms(launches):.4f} ms, b2b "
                 f"{queued_ms(launches):.4f})", window_partition(out, 16),
                 window_partition(plain(), 16),
                 fused_ocab.ocab_core_plain(*f32, w, bias, True), cuda_ms(run), cuda_ms(plain),
                 _ocab_work(windows, nq, nk, c, nh, hidden, qkv_map=True))
        _check_deterministic("K8w16", label, types.SimpleNamespace(out=out),
                             types.SimpleNamespace(out=again), ("out",))
        _ocab16_bytes_log(windows, c, nh, hidden, backward=batch == 8)
        if batch != 8:
            _ocab16_split(run, None)
            del out, again, alone, qkv, x, qh, kh, vh, q, k, v, sw, f32
            continue
        ctm = rnd(*mshape, c, sc=0.1)
        ct = window_partition(ctm, 16)
        _, o, stat = fused_ocab._launch_fwd16(qh, kh, vh, x, pk, bias, True)
        launchesb = lambda: fused_ocab._launch_bwd16(ctm, qh, kh, vh, x, pk, bias, True, o, stat)

        def runb():
            dq, dk, dv, dx, g = launchesb()
            return fused_ocab._launch_heads_bwd(dq, dk, dv, qkv.shape, nh, hdp), dq, dk, dv, dx, g

        def raw(r):
            dqkv, dq, dk, dv, dx, g = r
            if not torch.equal(dqkv, fused_ocab.map_heads_bwd_plain(dq, dk, dv, qkv.shape, nh,
                                                                    hdp)):
                raise RuntimeError("K8bw16: the gather's backward differs from its plain version")
            return fused_ocab.OcabGrads(dq=fused_ocab.from_heads(dq, c),
                                        dk=fused_ocab.from_heads(dk, c),
                                        dv=fused_ocab.from_heads(dv, c),
                                        dsw=window_partition(dx, 16), **g)

        plainb = lambda: _ocab_map_bwd_plain(ct, q, k, v, sw, w, bias, True, qkv.shape)
        got, again = raw(runb()), raw(runb())
        ref16 = fused_ocab.ocab_core_bwd_plain(ct, q, k, v, sw, w, bias, True)
        ref32 = fused_ocab.ocab_core_bwd_plain(ct.float(), *f32, w, bias, True)
        torch.cuda.synchronize()
        fields = fused_ocab.GRAD_FIELDS + ("bias",)
        _compare_grads(res, "K8bw16", f"{label}; the call with the gather's backward (b2b "
                       f"{queued_ms(runb):.4f} ms; K8bw16's launches alone "
                       f"{cuda_ms(launchesb):.4f} ms, b2b {queued_ms(launchesb):.4f})", got,
                       ref16, ref32, ("dq", "dk", "dv", "dsw"), fields, cuda_ms(runb),
                       cuda_ms(plainb),
                       _ocab_work(windows, nq, nk, c, nh, hidden, backward=True, qkv_map=True),
                       ulps=W16_ULPS)
        _check_deterministic("K8bw16", label, got, again, ("dq", "dk", "dv", "dsw") + fields)
        _ocab16_split(run, runb)
        log(f"[kernels] K8w16 {windows} windows hidden {hidden} host time a call (enqueue, "
            f"median of 20): {_enqueue_ms(run):.4f} ms (its launches alone "
            f"{_enqueue_ms(launches):.4f}); K8bw16 {_enqueue_ms(runb):.4f} ms")
        del out, again, alone, got, ref16, ref32, o, stat, qkv, x, ctm, ct, qh, kh, vh, f32


def _ocab16_gather_check(gen, dev):
    """K8w16's gather from the qkv map (``ocab_heads_kernel``) and its
    backward (``ocab_heads_bwd_kernel``), launched inside the K8w16 and
    K8bw16 calls of the OCAB's map entry, against their plain versions
    (``map_heads_plain``, ``map_heads_bwd_plain``) on HAT-SRx4's qkv maps
    (the bench batch and the train batch): the same values, and each
    one's time beside its plain version's and its bytes' bound."""
    import torch

    from tpu_superresolution_torch.kernels import fused_ocab as fo

    nh, hdp, c = 6, 32, 180
    for shape in ((25, 64, 64, 3 * c), (8, 64, 64, 3 * c)):
        qkv = torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
        got, want = fo._launch_heads(qkv, nh, hdp), fo.map_heads_plain(qkv, nh, hdp)
        grads = [torch.randn(t.shape, generator=gen).to(dev, torch.bfloat16) for t in got]
        gb = fo._launch_heads_bwd(*grads, shape, nh, hdp)
        wb = fo.map_heads_bwd_plain(*grads, shape, nh, hdp)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(gb, wb)
        ops = sum(t.numel() for t in got) * 2
        fwd_b, bwd_b = qkv.numel() * 2 + ops, ops + qkv.numel() * 2
        t = [cuda_ms(f) for f in (lambda: fo._launch_heads(qkv, nh, hdp),
                                  lambda: fo.map_heads_plain(qkv, nh, hdp),
                                  lambda: fo._launch_heads_bwd(*grads, shape, nh, hdp),
                                  lambda: fo.map_heads_bwd_plain(*grads, shape, nh, hdp))]
        log(f"[kernels] K8w16's gather from the qkv map {list(shape)}: "
            f"{'the same values as' if same else 'DIFFERS from'} its plain version, forward "
            f"and backward; forward {t[0]:.4f} ms (plain {t[1]:.4f}; bound "
            f"{fwd_b / PEAK_BYTES_PER_S * 1e3:.4f} ms by bytes, {fwd_b / 1e6:.1f} MB), backward "
            f"{t[2]:.4f} ms (plain {t[3]:.4f}; bound {bwd_b / PEAK_BYTES_PER_S * 1e3:.4f} ms, "
            f"{bwd_b / 1e6:.1f} MB)")
        if not same:
            raise RuntimeError(f"K8w16's gather {list(shape)} disagrees with its plain version")


# K8w16 / K8bw16 past HAT-SRx4's widths (every instantiation: cp 192 / hdp
# 32, cp 96 / hdp 32, cp 96 / hdp 16): (windows, C, heads, hidden, entry):
# the window-layout entry and fused_ocab_core_backward (None), the
# window-layout entry under autograd ("autograd"), or a map through
# fused_ocab_core_map under autograd
OCAB16_ENVELOPE = ((5, 144, 6, 288, None), (6, 64, 2, 128, (1, 32, 48)),
                   (3, 96, 6, 192, "autograd"))


def _ocab16_envelope(res, gen, dev):
    """K8w16 and K8bw16 at the other widths ``ocab_ok`` takes (HAT-S's C
    144, hd 16 and cp 96) and odd window counts, one case on a [1, 32,
    48, C] map through ``fused_ocab_core_map`` (its q, k, v gradients
    through the gather's backward kernel, against the plain ones through the
    gathers' autograd), one through the window-layout entry's autograd
    (``to_heads`` and ``Ocab16Function``), against the plain versions
    within W16_ULPS / K5_REL_BOUND (untimed)."""
    import torch

    from tpu_superresolution_torch.kernels import fused_ocab as fo
    from tpu_superresolution_torch.ops.window import overlap_windows, window_partition

    bf = torch.bfloat16
    rnd = lambda *s, sc=1.0: (sc * torch.randn(*s, generator=gen)).to(dev, bf)
    for windows, c, nh, hidden, shape in OCAB16_ENVELOPE:
        w = _random_ocab(gen, dev, c, nh, hidden)
        bias = (0.5 * torch.randn(nh, 256, 576, generator=gen)).to(dev)
        label = f"{windows} windows, C {c}, {nh} heads, hidden {hidden} (untimed)"
        acts = ("dq", "dk", "dv", "dsw")
        if shape is None:
            q, k, v, sw = rnd(windows, 256, c, sc=0.25), rnd(windows, 576, c), \
                rnd(windows, 576, c), rnd(windows, 256, c)
            ct = rnd(windows, 256, c, sc=0.1)
            out = fo.fused_ocab_core(q, k, v, sw, w, bias, False)
            got = fo.fused_ocab_core_backward(ct, q, k, v, sw, w, bias, False)
        elif shape == "autograd":
            label = label.replace(" (", ", the window entry's autograd (")
            q, k, v, sw = rnd(windows, 256, c, sc=0.25), rnd(windows, 576, c), \
                rnd(windows, 576, c), rnd(windows, 256, c)
            ct = rnd(windows, 256, c, sc=0.1)
            leaves = [t.clone().requires_grad_() for t in (q, k, v, sw, bias)]
            params = [getattr(w, f).clone().requires_grad_() for f in fo.GRAD_FIELDS]
            wl = fo.OcabWeights(num_heads=nh, **dict(zip(fo.GRAD_FIELDS, params)))
            outg = fo.fused_ocab_core(*leaves[:4], wl, leaves[4], False)
            outg.backward(ct)
            out = outg.detach()
            got = types.SimpleNamespace(
                **{f: t.grad for f, t in zip(("dq", "dk", "dv", "dsw", "bias"), leaves)},
                **{f: p.grad for f, p in zip(fo.GRAD_FIELDS, params)})
        else:
            label = label.replace(" (", f", a {list(shape) + [c]} map (")
            qkv, x, ctm = rnd(*shape, 3 * c), rnd(*shape, c), rnd(*shape, c, sc=0.1)
            qkv[..., :c] *= 0.25
            leaves = [t.clone().requires_grad_() for t in (qkv, x, bias)]
            params = [getattr(w, f).clone().requires_grad_() for f in fo.GRAD_FIELDS]
            wl = fo.OcabWeights(num_heads=nh, **dict(zip(fo.GRAD_FIELDS, params)))
            outm = fo.fused_ocab_core_map(leaves[0], leaves[1], wl, leaves[2], False)
            outm.backward(ctm)
            qq, kk, vv = qkv.chunk(3, -1)
            q, k, v, sw = window_partition(qq, 16), overlap_windows(kk, 16, 24), \
                overlap_windows(vv, 16, 24), window_partition(x, 16)
            out, ct = window_partition(outm.detach(), 16), window_partition(ctm, 16)
            # the plain fp32 dq, dk, dv into the map through the gathers' autograd
            ref = fo.ocab_core_bwd_plain(ct.float(), *(t.float() for t in (q, k, v, sw)), w,
                                         bias, False)
            lq = torch.zeros(qkv.shape, device=dev, requires_grad=True)
            qs, ks, vs = lq.chunk(3, -1)
            torch.autograd.backward([window_partition(qs, 16), overlap_windows(ks, 16, 24),
                                     overlap_windows(vs, 16, 24)], [ref.dq, ref.dk, ref.dv])
            err = (leaves[0].grad.float() - lq.grad).abs().max().item()
            bound = W16_ULPS * bf16_ulp(lq.grad.abs().max().item())
            log(f"[kernels] K8bw16 {label} d qkv (the gather's backward): max_abs_err vs plain "
                f"fp32 {err:.3e} (bound {bound:.3e}) {'ok' if err <= bound else 'FAIL'}")
            if not err <= bound:
                raise RuntimeError(f"K8bw16 {label}: d qkv disagrees with the plain version")
            acts = ("dsw",)
            got = types.SimpleNamespace(dsw=window_partition(leaves[1].grad, 16),
                                        bias=leaves[2].grad,
                                        **{f: p.grad for f, p in zip(fo.GRAD_FIELDS, params)})
        args = (q, k, v, sw)
        _compare({}, "K8w16", label, out, fo.ocab_core_plain(*args, w, bias, False),
                 fo.ocab_core_plain(*(t.float() for t in args), w, bias, False), 0.0, 0.0,
                 _ocab_work(windows, 256, 576, c, nh, hidden))
        _compare_grads({}, "K8bw16", label, got, fo.ocab_core_bwd_plain(ct, *args, w, bias, False),
                       fo.ocab_core_bwd_plain(ct.float(), *(t.float() for t in args), w, bias,
                                              False), acts, fo.GRAD_FIELDS + ("bias",), 0.0, 0.0,
                       _ocab_work(windows, 256, 576, c, nh, hidden, backward=True),
                       ulps=W16_ULPS)


def _ocab16_bytes_log(windows, c, nh, hidden, backward=True):
    """K8w16's (and K8bw16's) bytes moved per call of the map entry by
    the design (csrc/ocab16.cu): the gather reading the qkv map and
    writing the head-major q, k, v, each attention kernel reading them,
    x and the output (ct, dx), then each buffer of ``ocab16_bytes``
    written once and read once, and the gather's backward reading dq,
    dk, dv and writing d qkv (the backward's bias-gradient partials:
    every unit but a CTA's first reads and writes its [256, 576] entries,
    K5c reads them once)."""
    import torch

    from tpu_superresolution_torch.kernels import _lib
    from tpu_superresolution_torch.kernels import fused_ocab as fo

    p = fo.ocab16_plan(c, nh, hidden, windows, _lib.sm_count(torch.cuda.current_device()))
    sizes = fo.ocab16_bytes(p, nh)
    b, n = p.block, windows * nh
    heads = n * (fo.W16_NQ + 2 * fo.W16_NK) * b.hdp * 2
    tok = windows * fo.W16_NQ * c * 2
    gather = 3 * tok + heads  # the qkv map read, the head-major operands written
    fwd_keys = ("O", "row statistics", "x1 scratch")
    fwd = (gather + heads + 2 * tok + 2 * sum(sizes[k] for k in fwd_keys)
           + nh * fo.W16_NQ * fo.W16_NK * 4)
    log(f"[kernels] K8w16 {windows} windows bytes moved by the design: the gather "
        f"{gather / 1e6:.1f} MB (qkv map in, head-major q, k, v out), head-major q, k, v "
        f"{heads / 1e6:.1f} MB, x and out {2 * tok / 1e6:.1f} MB, " + ", ".join(
            f"{k} {sizes[k] / 1e6:.1f} MB" for k in fwd_keys)
        + f" (each written and read once); in all {fwd / 1e6:.1f} MB "
        f"({fwd / PEAK_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s); K5a grid {p.grid} over "
        f"{p.units} 64-token units, attention {p.cph} CTAs a head over {n} (window, head) "
        f"units in {p.rounds} rounds (the last on {p.tail_ctas} CTAs), shared memory "
        f"{b.smem} / {p.att_fwd_smem} B")
    if not backward:
        return
    part = sizes["bias-gradient partials"]
    # each unit after a CTA's first reads and writes its partial; the
    # first writes it; K5c reads it
    moved_part = (n - nh * p.cph) * part // (nh * p.cph) * 2 + 2 * part
    old = 2 * n * fo.W16_NQ * fo.W16_NK * 4  # the WMMA kernel's buffer, written and read once
    bwd_keys = [k for k in sizes if k not in ("x1 scratch", "bias-gradient partials")]
    moved = (2 * heads + gather + 3 * tok + 2 * sum(sizes[k] for k in bwd_keys) + moved_part
             + nh * fo.W16_NQ * fo.W16_NK * 4 * 2)
    log(f"[kernels] K8bw16 {windows} windows bytes moved by the design: head-major q, k, v "
        f"in and dq, dk, dv out {2 * heads / 1e6:.1f} MB, the gather's backward "
        f"{gather / 1e6:.1f} MB, ct, x, dx {3 * tok / 1e6:.1f} MB, "
        + ", ".join(f"{k} {sizes[k] / 1e6:.1f} MB" for k in bwd_keys)
        + f" (each written and read once); bias-gradient partials {part / 1e6:.1f} MB "
        f"({p.cph} CTAs a head), moving {moved_part / 1e6:.1f} MB (read-modify-writes, first "
        f"writes, K5c's read; the WMMA kernel's 453 MB buffer written and read once moved "
        f"{old / 1e6:.1f} MB); in all {moved / 1e6:.1f} MB "
        f"({moved / PEAK_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s); K5b splits {p.splits} x "
        f"{b.units} units, attention shared memory {p.att_bwd_smem} B")


def _enqueue_ms(fn, calls: int = 20) -> float:
    """Median host time for fn() to return, the device drained before
    each call: the wrapper's own cost a call (launches enqueued, not
    run)."""
    import torch

    fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _ocab16_split(run, runb, calls=3):
    """K8w16's and K8bw16's launches timed by torch.profiler over `calls`
    calls each (csrc/ocab16.cu): device ms a call by launch, and the rest
    of a call's device time (packing, the fold)."""
    import torch

    from tpu_superresolution_torch.utils.profiling import device_split, kernel_ms

    for key, fn, parts in (
            ("K8w16", run, (("the gather", "ocab_heads_kernel", ""),
                            ("attention forward", "ocab_attn_kernel", "false>("),
                            ("K5a OCAB tail", "swin_block_bwd_kernel<16,", ", 4>("))),
            ("K8bw16", runb, (("K5a middle", "swin_block_bwd_kernel<16,", ", 2>("),
                              ("attention backward", "ocab_attn_kernel", "true>("),
                              ("K5b dW", "wgrad_wg_kernel", ""),
                              ("K5c sums", "reduce_ordered_kernel", ""),
                              ("the gather's backward", "ocab_heads_bwd_kernel", "")))):
        if fn is None:
            continue
        fn()
        torch.cuda.synchronize()
        try:
            kernels = device_split(lambda: [fn() for _ in range(calls)]).kernels
        except Exception as e:  # the split is a reading aid, not a check
            log(f"[kernels] {key} profiler failed: {type(e).__name__}: {e}")
            return
        out, seen = [], set()
        for label, head, tail in parts:
            ev = [e for e in kernels if head in e.name and tail in e.name]
            seen.update(id(e) for e in ev)
            out.append(f"{label} {sum(kernel_ms(e) for e in ev) / max(len(ev), 1):.4f} ms "
                       f"({len(ev)} launches seen in {calls} calls)")
        rest = sum(kernel_ms(e) for e in kernels if id(e) not in seen) / calls
        busy = sum(kernel_ms(e) for e in kernels) / calls
        log(f"[kernels] {key} launches by part (profiler, {calls} calls): " + ", ".join(out)
            + f"; other device work {rest:.4f} ms; busy {busy:.4f} ms a call")


def _ocab_serve_routes(gen, dev, c=180, nh=6, ws=16, mlp=2.0, maps=(25, 64, 64)):
    """An OCAB's serving route, measured: an eval-mode OCAB (by default
    HAT-SRx4's widths, C 180, 6 heads, mlp 2, on the bench call's batch
    [25, 64, 64, 180], 400 windows; also HAT's and hat_fast's at ws 7 and
    8) on `maps`, its forward on the fused route (LN1, qkv, K8w16 with
    its gather to the head-major operands at ws 16; K8, packing its
    weights, at ws 7 and 8) and on the module path (LN1, qkv, the
    gathers, K15, the proj, LN2, the MLP) timed in turns (module, fused,
    fused, module) in this call; then the work after the qkv product
    alone on each.  At ws 16 the map entry against the window-layout
    entry, bit for bit.  Both outputs against the plain fp32 forward.
    The route the model serves on is ``models.hat.OCAB.takes_fused``'s."""
    import torch

    from tpu_superresolution_torch.kernels import fused_ocab as fo
    from tpu_superresolution_torch.models.hat import OCAB
    from tpu_superresolution_torch.ops.window import (
        overlap_windows,
        window_partition,
        window_reverse,
    )

    ocab = OCAB(c, ws, 0.5, nh, True, mlp, False)
    with torch.no_grad():
        for p in ocab.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        ocab.norm1.weight.add_(1.0)
        ocab.norm2.weight.add_(1.0)
    ocab = ocab.to(dev).eval()
    x = torch.randn(*maps, c, generator=gen).to(dev, torch.bfloat16)
    windows = maps[0] * (maps[1] // ws) * (maps[2] // ws)
    with torch.no_grad():
        ref = ocab._module(x.float(), True)
        outs, times = {}, {"module": [], "fused": []}
        for route in ("module", "fused", "fused", "module"):
            fn = (lambda: ocab._fused(x, False)) if route == "fused" else \
                (lambda: ocab._module(x, False))
            outs[route] = fn()
            times[route].append(cuda_ms(fn))
        # the work after the qkv product on each route
        qf, qm = ocab.qkv_map(x, False, True), ocab.qkv_map(x, False, False)
        if ws == 16:
            # the map entry (one gather to the head-major operands, x and the
            # output in map layout) against the window-layout entry: the same bits
            q, k, v = qf.chunk(3, -1)
            ws_, ows_ = ocab.window_size, ocab.overlap_win_size
            windowed = window_reverse(fo.fused_ocab_core(
                window_partition(q, ws_), overlap_windows(k, ws_, ows_),
                overlap_windows(v, ws_, ows_), window_partition(x, ws_), fo.OcabWeights(
                    wproj=ocab.proj.weight, bproj=ocab.proj.bias, g2=ocab.norm2.weight,
                    b2=ocab.norm2.bias, wfc1=ocab.mlp.fc1.weight, bfc1=ocab.mlp.fc1.bias,
                    wfc2=ocab.mlp.fc2.weight, bfc2=ocab.mlp.fc2.bias, num_heads=nh),
                ocab.bias_oca(), False), ws_, maps[1], maps[2])
            same = torch.equal(ocab.fused_core(x, qf, False), windowed)
            log(f"[kernels] OCAB fused route: the map entry (fused_ocab_core_map) and the "
                f"window-layout entry {'bit-identical' if same else 'DIFFER'}")
            if not same:
                raise RuntimeError("fused_ocab_core_map differs from fused_ocab_core")
        core_fused = cuda_ms(lambda: ocab.fused_core(x, qf, False))
        core_module = cuda_ms(lambda: ocab.module_core(x, qm, False))
    for route, out in outs.items():
        err = float((out.float() - ref).abs().max())
        log(f"[kernels] OCAB ws {ws} serving route {route}: max_abs_err vs the plain fp32 forward "
            f"{err:.3e} (max|ref| {float(ref.abs().max()):.3f})")
        if not math.isfinite(err) or err > 0.1 * float(ref.abs().max()):
            raise RuntimeError(f"OCAB ws {ws} {route} route disagrees with the plain forward: "
                               f"{err}")
    tf, tm = statistics.mean(times["fused"]), statistics.mean(times["module"])
    log(f"[kernels] OCAB serving route at ws {ws}, {list(maps) + [c]} ({windows} windows): "
        f"forward fused {times['fused'][0]:.4f} / {times['fused'][1]:.4f} ms, module path "
        f"{times['module'][0]:.4f} / {times['module'][1]:.4f} ms (in turns); after the qkv "
        f"product: {'the gather and K8w16' if ws == 16 else 'the packing and K8'} "
        f"{core_fused:.4f} ms, the gathers, K15, proj, LN2, MLP, "
        f"residuals {core_module:.4f} ms; {'fused' if tf < tm else 'module path'} faster by "
        f"{abs(tm - tf):.4f} ms; serving takes "
        f"{'the fused route' if ocab.eval().takes_fused() else 'the module path'}")


def phase_k5r_kernels(res):
    """K5r, the K7 route's block backward at ws 8 past the block kernel's
    widths, at SwinIR-L's train shape (batch 8 of 64^2 LR crops: [8, 64,
    64, 240], 512 windows, 8 heads of 30, hidden 480): shift 4 (with the
    mask) without `extra`, as SwinIR-L's odd blocks run it, and shift 0
    with `extra` (``_k5r_rows``); then, for correctness only,
    K5R_ENVELOPE's odd window counts, into `res`."""
    import torch

    from tpu_superresolution_torch.kernels.fused_block import (
        GRAD_FIELDS,
        fused_swin_block_backward,
        swin_block_bwd_plain,
    )
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 19)
    bf = torch.bfloat16
    c, hidden, ws = 240, 480, 8
    wb, pk = _k5r_rows(res, gen, dev, hidden, ((4, False), (0, True)))
    # correctness only: odd window counts (the last unit pair's idle twin)
    # with a ragged last attention stage, both branches on in the last image
    envelope = {}  # these rows' times stay out of the kernels line
    for shape, shift, with_extra in K5R_ENVELOPE:
        b = shape[0]
        sc = torch.tensor([[1.0 / 0.9, 0.0]] * (b - 1) + [[1.0 / 0.9, 1.0 / 0.9]], device=dev)
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        ct = (0.1 * torch.randn(*shape, generator=gen)).to(dev, bf)
        extra = (0.05 * torch.randn(*shape, generator=gen)).to(dev, bf) if with_extra else None
        mask = shift_mask_tensor(shape[1], shape[2], ws, shift, dev) if shift else None
        run = lambda: fused_swin_block_backward(ct, x, wb, ws, shift, mask, True, sc,
                                                packed=pk, extra=extra)
        plain = lambda: swin_block_bwd_plain(ct, x, wb, ws, shift, mask, True, sc, extra)
        got, again = run(), run()
        ref16 = plain()
        ref32 = swin_block_bwd_plain(ct.float(), x.float(), wb, ws, shift, mask, True, sc,
                                     None if extra is None else extra.float())
        torch.cuda.synchronize()
        acts = ("dx",) if extra is None else ("dx", "extra")
        windows = b * (shape[1] // ws) * (shape[2] // ws)
        label = (f"envelope {list(shape)} ({windows} windows) ws {ws} shift {shift}"
                 f"{'' if extra is None else ' extra'}, branch scales")
        _compare_grads(envelope, "K5r", label, got, ref16, ref32, acts, GRAD_FIELDS,
                       cuda_ms(run), cuda_ms(plain),
                       _swin_work(shape, c, hidden, backward=True, ws=ws,
                                  extra=extra is not None))
        _check_deterministic("K5r", label, got, again, acts + GRAD_FIELDS)
        del got, again, ref16, ref32
    return res


def _k5r_rows(res, gen, dev, hidden, runs):
    """K5r at SwinIR-L's train shape [8, 64, 64, 240], 8 heads of 30, MLP
    `hidden`, for each (shift, with `extra`) of `runs`, branch scales on,
    on the forward's weight stream (``pack_block_tiles``), on dx (d extra)
    and the 13 parameter gradients; each run twice for the same bits,
    timed alone and 20 calls back to back, with its bytes moved by design
    and each launch's time; against its plain version in bf16 and fp32,
    within K5_DX_ULPS bf16 ulps (activation gradients) and K5_REL_BOUND
    (parameter gradients), with times and bounds, into `res`.  Returns
    the block's weights and their pack."""
    import torch

    from tpu_superresolution_torch.kernels.fused_block import (
        GRAD_FIELDS,
        fused_swin_block_backward,
        pack_block_tiles,
        swin_block_bwd_plain,
    )
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    bf = torch.bfloat16
    scales = torch.tensor([[1.0 / 0.9, 0.0], [1.0 / 0.9, 1.0 / 0.9]] * 4, device=dev)
    c, nh, ws = 240, 8, 8
    shape = (8, 64, 64, c)
    wb = _random_block(gen, dev, c, nh, hidden, ws)
    pk = pack_block_tiles(wb)  # the stream WindowBlockFunction packs once a step
    x = torch.randn(*shape, generator=gen).to(dev, bf)
    ct = (0.1 * torch.randn(*shape, generator=gen)).to(dev, bf)
    ex = (0.05 * torch.randn(*shape, generator=gen)).to(dev, bf)
    for shift, with_extra in runs:
        extra = ex if with_extra else None
        mask = shift_mask_tensor(shape[1], shape[2], ws, shift, dev) if shift else None
        run = lambda: fused_swin_block_backward(ct, x, wb, ws, shift, mask, True, scales,
                                                packed=pk, extra=extra)
        plain = lambda: swin_block_bwd_plain(ct, x, wb, ws, shift, mask, True, scales, extra)
        got, again = run(), run()
        ref16 = plain()
        ref32 = swin_block_bwd_plain(ct.float(), x.float(), wb, ws, shift, mask, True, scales,
                                     None if extra is None else extra.float())
        torch.cuda.synchronize()
        acts = ("dx",) if extra is None else ("dx", "extra")
        _tiled_bytes_log(shape, c, nh, hidden, ws=ws, extra=extra is not None)
        _compare_grads(res, "K5r", f"{list(shape)} hidden {hidden} ws {ws} shift {shift}"
                       f"{'' if extra is None else ' extra'}, branch scales (b2b "
                       f"{queued_ms(run):.4f} ms)", got, ref16, ref32, acts, GRAD_FIELDS,
                       cuda_ms(run), cuda_ms(plain),
                       _swin_work(shape, c, hidden, backward=True, ws=ws,
                                  extra=extra is not None))
        _check_deterministic("K5r", f"{list(shape)} hidden {hidden} ws {ws} shift {shift}", got,
                             again, acts + GRAD_FIELDS)
        _tiled_split(run, ws=ws)
        del got, again, ref16, ref32
    return wb, pk


# The JAX train CLI's HAT at window 16 (no --mlp_ratio: HATConfig's mlp 4)
# and SwinIR-L at mlp 4: the MLP hidden of each
MLP4_HIDDEN = 720
SWINIR_L_MLP4_HIDDEN = 960


def phase_mlp4_kernels(res):
    """The training kernels at any MLP hidden, at the shapes of the JAX
    train CLI's HAT at window 16 (mlp 4: C 180, 6 heads, hidden 720) and
    of SwinIR-L at mlp 4 (C 240, 8 heads, hidden 960): K5w16 at
    [8,64,64,180] shift 8 and shift 0, `extra` and branch scales
    (``_k5w16_rows``); K5r at [8,64,64,240] shift 4 (``_k5r_rows``);
    K8w16 / K8bw16 on the train step's 128 windows (``_k8w16_rows``); K8
    / K8b on 800 windows of (7, 10) and 512 of (8, 12) at C 180
    (``_ocab_cases``); then the OCAB's serving route at ws 16 and mlp 4,
    each against its plain version with times and bounds, appended to
    `res` (each kernel's first row stays its main path's)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 28)
    _k5w16_rows(res, gen, dev, MLP4_HIDDEN)
    _k5r_rows(res, gen, dev, SWINIR_L_MLP4_HIDDEN, ((4, False),))
    _k8w16_rows(res, gen, dev, MLP4_HIDDEN, (8,))
    _ocab_cases(res, gen, dev, 180, 6, MLP4_HIDDEN)
    _ocab_serve_routes(gen, dev, mlp=MLP4_HIDDEN / 180)
    return res


def _random_dat_block(gen, device, c=180, nh=6, split=(8, 16), hidden=360):
    """One DAT block's weights at DATConfig()'s widths with O(1)
    activations (bf16-representable GEMM weights): the spatial and
    channel fronts (K9, K14) and the tail (K10)."""
    import torch

    from tpu_superresolution_torch.kernels.fused_channel_attn import ChanAttnWeights
    from tpu_superresolution_torch.kernels.fused_datb_tail import TailWeights
    from tpu_superresolution_torch.kernels.fused_rect_attn import (
        RectAttnWeights,
        rect_bias_from_table,
    )

    def r(*shape, scale=1.0, bf=False):
        t = torch.randn(*shape, generator=gen) * scale
        return (t.bfloat16().float() if bf else t).to(device)

    s0, s1 = split
    half, m = hidden // 2, c // 16
    front = dict(g1=1 + r(c, scale=0.1), b1=r(c, scale=0.1),
                 wqkv=r(3 * c, c, scale=c ** -0.5, bf=True), bqkv=r(3 * c, scale=0.1),
                 wdw=r(3, 3, c, scale=1 / 3), bdw=r(c, scale=0.1), num_heads=nh)
    # the branches' DynamicPosBias tables, and the dense biases gathered
    # from them for the plain version
    tables = [r((2 * s0 - 1) * (2 * s1 - 1), nh // 2, scale=0.5) for _ in range(2)]
    rect = RectAttnWeights(bias0=rect_bias_from_table(tables[0], s0, s1),
                           bias1=rect_bias_from_table(tables[1], s1, s0), split=split,
                           table0=tables[0], table1=tables[1], **front)
    chan = ChanAttnWeights(temperature=1 + r(nh, 1, 1, scale=0.3), **front)
    tail = TailWeights(
        sp_w1=r(m, c, scale=c ** -0.5, bf=True), sp_b1=r(m, scale=0.1),
        sp_w2=r(1, m, scale=m ** -0.5, bf=True), sp_b2=r(1, scale=0.1),
        wproj=r(c, c, scale=c ** -0.5, bf=True), bproj=r(c, scale=0.1),
        g2=1 + r(c, scale=0.1), b2=r(c, scale=0.1),
        wfc1=r(hidden, c, scale=c ** -0.5, bf=True), bfc1=r(hidden, scale=0.1),
        gsg=1 + r(half, scale=0.1), bsg=r(half, scale=0.1),
        wdw=r(3, 3, half, scale=1 / 3), bdw=r(half, scale=0.1),
        wfc2=r(c, half, scale=half ** -0.5, bf=True), bfc2=r(c, scale=0.1))
    return rect, chan, tail


def _compare_outputs(results, key, label, outs, refs16, refs32, t_kernel, t_plain, work,
                     t_library=None):
    """A kernel's outputs, each within ULP_BOUND[key] bf16 ulps at its own
    max |ref| of the plain bf16 and fp32 versions; then its times and
    bound into `results`."""
    bad, errs = [], []
    for i, (out, r16, r32) in enumerate(zip(outs, refs16, refs32)):
        mag = float(r32.abs().max())
        bound = ULP_BOUND[key] * bf16_ulp(mag)
        e16 = float((out.float() - r16.float()).abs().max())
        e32 = float((out.float() - r32.float()).abs().max())
        ok = math.isfinite(e16) and math.isfinite(e32) and e16 <= bound and e32 <= bound
        which = f" output {i}" if len(outs) > 1 else ""
        log(f"[kernels] {key} {label}{which}: max_abs_err vs plain bf16 {e16:.3e}, vs plain "
            f"fp32 {e32:.3e} (bound {bound:.3e} = {ULP_BOUND[key]} bf16 ulp at max|ref| "
            f"{mag:.3f}) {'ok' if ok else 'FAIL'}")
        errs.append(e32)
        if not ok:
            bad.append(i)
    if bad:
        raise RuntimeError(f"{key} {label}: kernel disagrees with its plain version on {bad}")
    _record(results, key, label, max(errs), t_kernel, t_plain, work, t_library)


def _dat_work(key, shape, split=(8, 16), c=180, nh=6, hidden=360):
    """(FLOPs, bytes) of one K9, K14 or K10 call on x of `shape` at the
    unpadded widths.  K9 per token: the qkv product 6C^2, both branches'
    QK^T and AV over N = s0*s1 keys on C/2 channels (2 x 4 N C/2), the
    depthwise 3x3 (18 C); its attention runs on the Hp x Wp padded map,
    whose pad tokens are real keys.  K14: qkv, the gram and v A^T (2 x 2 C
    hd), the depthwise conv.  K10: the spatial map 2 C (C/16), proj 2C^2,
    fc1 2 C hidden, the depthwise conv 18 hidden/2, fc2 C hidden.  Bytes:
    each input read once, each output written once (bf16): K9 and K14
    read x, write attened_x and conv_x; K10 reads x, u, w_px, writes out."""
    b, h, w, _ = shape
    tokens = b * h * w
    act = tokens * c * 2
    if key == "K9":
        ms = max(split)
        padded = b * (-(-h // ms) * ms) * (-(-w // ms) * ms)
        n = split[0] * split[1]
        return tokens * (6 * c * c + 18 * c) + padded * 2 * 4 * n * (c // 2), 3 * act
    if key == "K14":
        return tokens * (6 * c * c + 4 * c * (c // nh) + 18 * c), 3 * act
    return (tokens * (2 * c * (c // 16) + 2 * c * c + 2 * c * hidden + 9 * hidden + c * hidden),
            4 * act + b * c * 4)


# Each K9 / K14 launch, by its kernel's name under torch.profiler.
K9_PARTS = (("front product (LN1, qkv)", "front_product_kernel<0", ""),
            ("attention (both branches)", "window_attn_stream_kernel", ""),
            ("conv branch", "dat_conv_kernel<false", ""))
K14_PARTS = (("front product (LN1, qkv, gram)", "front_product_kernel<1", ""),
             ("softmax", "chan_softmax_kernel", ""),
             ("conv branch + v A^T", "dat_conv_kernel<true", ""))


def _launch_split(key, label, run, parts, calls=3):
    """Each launch of one kernel call timed by torch.profiler over
    `calls` calls: device ms a call by part, and the rest of the call's
    device time (the wrapper's allocations)."""
    import torch

    from tpu_superresolution_torch.utils.profiling import device_split, kernel_ms

    run()
    torch.cuda.synchronize()
    try:
        kernels = device_split(lambda: [run() for _ in range(calls)]).kernels
    except Exception as e:  # the split is a reading aid, not a check
        log(f"[kernels] {key} profiler failed: {type(e).__name__}: {e}")
        return
    out, seen = [], set()
    for name, head, tail in parts:
        ev = [e for e in kernels if head in e.name and tail in e.name]
        seen.update(id(e) for e in ev)
        out.append(f"{name} {sum(kernel_ms(e) for e in ev) / calls:.4f} ms x{len(ev) // calls}")
    rest = sum(kernel_ms(e) for e in kernels if id(e) not in seen) / calls
    busy = sum(kernel_ms(e) for e in kernels) / calls
    log(f"[kernels] {key} {label} launches (profiler, {calls} calls): " + ", ".join(out)
        + f"; other device work {rest:.4f} ms; busy {busy:.4f} ms a call")


def _front_design_bytes(key, shape, split=(8, 16), c=180, nh=6):
    """Bytes one K9 or K14 call moves by design (each buffer written and
    read once): K9 x, the two branches' q|k|v workspaces (heads padded
    to 32 dims, on the padded map) written and read, v written and read,
    attened_x and conv_x; K14 x, v written and read, the outputs, and the
    128-token tiles' gram and norm partials written and read."""
    b, h, w, _ = shape
    act = b * h * w * c * 2
    if key == "K9":
        ms = max(split)
        padded = b * (-(-h // ms) * ms) * (-(-w // ms) * ms)
        return 5 * act + 2 * 2 * 3 * padded * (nh // 2) * 32 * 2
    tiles = b * -(-(h * w) // 128)
    return 5 * act + 2 * tiles * (6 * 32 * 32 + 2 * 192) * 4


def phase_dat_kernels(res):
    """DAT's kernels at DATConfig()'s widths (C 180, 6 heads, split
    (8, 16), hidden 360) on the bench tile batch [25,64,64,180] and on a
    whole image whose sides are not multiples of 16 ([2,52,76,180]): K9
    at split (8, 16) and at the published DAT x4's (8, 32), unshifted and
    shifted, K14 (two runs compared bit for bit), K10; then K10 at the
    published DAT x4's SGFN half 360 on the bench batch.  Each output
    against the plain version in bf16 and fp32, with times (alone and 20
    calls back to back), bounds and bytes moved by design into `res`;
    each K9 / K14 launch timed by the profiler on the bench batch; each
    K10 row also beside the module chain's composition of the same
    tail."""
    import torch

    from tpu_superresolution_torch.kernels import fused_channel_attn as fc
    from tpu_superresolution_torch.kernels import fused_rect_attn as fr

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 4)
    bf = torch.bfloat16
    rect, chan, tail = _random_dat_block(gen, dev)
    rect32, _, _ = _random_dat_block(gen, dev, split=(8, 32))
    rects = {(8, 16): (rect, fr.pack_rect_weights(rect)),
             (8, 32): (rect32, fr.pack_rect_weights(rect32))}
    pchan = fc.pack_chan_weights(chan)
    for shape in ((25, 64, 64, 180), (2, 52, 76, 180)):
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        for split, (w, pk) in rects.items():
            for shifted in (False, True):
                run = lambda: fr.rect_attention(x, w, shifted, pk)
                plain = lambda: fr.rect_attention_plain(x, w, shifted)
                outs = run()
                refs16, refs32 = plain(), fr.rect_attention_plain(x.float(), w, shifted)
                torch.cuda.synchronize()
                label = (f"{list(shape)} split {split} {'shifted' if shifted else 'unshifted'}")
                nbytes = _front_design_bytes("K9", shape, split)
                _compare_outputs(res, "K9", f"{label} (b2b {queued_ms(run):.4f} ms; "
                                 f"{nbytes / 1e6:.1f} MB moved by design)", outs, refs16,
                                 refs32, cuda_ms(run), cuda_ms(plain),
                                 _dat_work("K9", shape, split))
                del outs, refs16, refs32
                if shape[0] == 25:
                    _launch_split("K9", label, run, K9_PARTS)
        run = lambda: fc.channel_attention(x, chan, pchan)
        plain = lambda: fc.channel_attention_plain(x, chan)
        outs, again = run(), run()
        refs16, refs32 = plain(), fc.channel_attention_plain(x.float(), chan)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs, again))
        log(f"[kernels] K14 {list(shape)}: two runs bit-identical: {same}")
        if not same:
            raise RuntimeError(f"K14 {list(shape)}: two runs differ")
        nbytes = _front_design_bytes("K14", shape)
        _compare_outputs(res, "K14", f"{list(shape)} (b2b {queued_ms(run):.4f} ms; "
                         f"{nbytes / 1e6:.1f} MB moved by design)", outs, refs16, refs32,
                         cuda_ms(run), cuda_ms(plain), _dat_work("K14", shape))
        del outs, again, refs16, refs32
        if shape[0] == 25:
            _launch_split("K14", f"{list(shape)}", run, K14_PARTS)
        _k10_row(res, gen, dev, x, tail)
    _, _, tail720 = _random_dat_block(gen, dev, hidden=720)
    _k10_row(res, gen, dev, torch.randn(25, 64, 64, 180, generator=gen).to(dev, bf), tail720)
    _k10_envelope(gen, dev)
    return res


# K10's envelope beyond the timed rows, as (x's shape [B, H, W, C],
# hidden = 2 x the SGFN half): padded widths 64 / 128 / 192, halves 45 to
# 384, C not a multiple of 4 or odd, two and three strips past W 64,
# bands of one row.
K10_ENVELOPE = [((2, 9, 70, 60), 120), ((1, 7, 130, 96), 384), ((3, 5, 64, 150), 300),
                ((1, 4, 33, 45), 90), ((2, 3, 5, 192), 768)]


def _k10_envelope(gen, dev):
    """K10 against its plain version (bf16 and fp32) within ULP_BOUND at
    each K10_ENVELOPE shape: correctness only, no times."""
    import torch

    from tpu_superresolution_torch.kernels import fused_datb_tail as ft

    bf = torch.bfloat16
    for shape, hidden in K10_ENVELOPE:
        c = shape[3]
        _, _, tail = _random_dat_block(gen, dev, c=c, nh=2, hidden=hidden)
        x, u, w_px = (torch.randn(*shape, generator=gen).to(dev, bf) for _ in range(3))
        gate = torch.sigmoid(torch.randn(shape[0], c, generator=gen)).to(dev)
        out = ft.datb_tail(x, u, w_px, gate, tail)
        ref16 = ft.datb_tail_plain(x, u, w_px, gate, tail)
        ref32 = ft.datb_tail_plain(x.float(), u.float(), w_px.float(), gate, tail)
        torch.cuda.synchronize()
        mag = float(ref32.abs().max())
        bound = ULP_BOUND["K10"] * bf16_ulp(mag)
        e16 = float((out.float() - ref16.float()).abs().max())
        e32 = float((out.float() - ref32).abs().max())
        ok = math.isfinite(e16) and math.isfinite(e32) and max(e16, e32) <= bound
        log(f"[kernels] K10 envelope {list(shape)} half {hidden // 2} (plan "
            f"{ft.tail_plan(*shape, hidden // 2, 132)}): max_abs_err vs plain bf16 {e16:.3e}, "
            f"vs plain fp32 {e32:.3e} (bound {bound:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"K10 envelope {list(shape)} half {hidden // 2}: kernel disagrees")


def _k10_row(res, gen, dev, x, tail):
    """K10 on x and random u, w_px, gate against its plain version, and
    beside the module chain's composition of the same tail (what the
    published DAT x4 ran before K10 took its SGFN half: bf16 F.linear
    products, K2 for LN2 and sg_norm, K11, erf GELU and the gating in
    plain ops, the products' weights in bf16), each timed alone
    and 20 calls back to back, twice in the order kernel, chain, chain,
    kernel (the mean of the two)."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from tpu_superresolution_torch.kernels import _lib
    from tpu_superresolution_torch.kernels import fused_datb_tail as ft
    from tpu_superresolution_torch.kernels.dwconv import dwconv3x3
    from tpu_superresolution_torch.kernels.layernorm import layernorm

    bf = torch.bfloat16
    shape = tuple(x.shape)
    half = tail.half
    ptail = ft.pack_tail_weights(tail)
    plan = ft.tail_plan(*shape, half, _lib.sm_count(dev.index or 0))
    u = torch.randn(*shape, generator=gen).to(dev, bf)
    w_px = torch.randn(*shape, generator=gen).to(dev, bf)
    gate = torch.sigmoid(torch.randn(shape[0], shape[3], generator=gen)).to(dev)
    tail16 = dataclasses.replace(tail, **{k: getattr(tail, k).to(bf) for k in (
        "sp_w1", "sp_b1", "sp_w2", "sp_b2", "wproj", "bproj", "wfc1", "bfc1", "wfc2", "bfc2")})
    run = lambda: ft.datb_tail(x, u, w_px, gate, tail, ptail)
    plain = lambda: ft.datb_tail_plain(x, u, w_px, gate, tail)
    chain = lambda: ft.datb_tail_plain(
        x, u, w_px, gate.to(bf), tail16, ln=lambda t, g, b: layernorm(t.to(bf).contiguous(), g, b),
        dwconv=lambda t, k, b: dwconv3x3(t.to(bf), k, b),
        linear=lambda a, wt, b: F.linear(a.to(bf), wt, b))
    out = run()
    ref16, ref32 = plain(), ft.datb_tail_plain(x.float(), u.float(), w_px.float(), gate, tail)
    torch.cuda.synchronize()
    fns = {"kernel": run, "module chain": chain}
    alone, b2b = ({n: [] for n in fns} for _ in range(2))
    for n in ("kernel", "module chain", "module chain", "kernel"):
        alone[n].append(cuda_ms(fns[n]))
        b2b[n].append(queued_ms(fns[n]))
    mean = lambda v: sum(v) / len(v)
    t = {n: mean(v) for n, v in alone.items()}
    q = {n: mean(v) for n, v in b2b.items()}
    label = (f"{list(shape)} half {half} (band {plan.band}, {plan.strips} strip(s), "
             f"{plan.units} units on {plan.grid} CTAs, {plan.stages} stages; b2b "
             f"{q['kernel']:.4f} ms, module chain {t['module chain']:.4f} ms, b2b "
             f"{q['module chain']:.4f})")
    _compare_outputs(res, "K10", label, (out,), (ref16,), (ref32,), t["kernel"], cuda_ms(plain),
                     _dat_work("K10", shape, hidden=2 * half))
    log(f"[kernels] K10 {list(shape)} half {half} against the module chain: " + "; ".join(
        f"{n} {t[n]:.4f} ms ({' / '.join(f'{v:.4f}' for v in alone[n])}), b2b {q[n]:.4f} "
        f"({' / '.join(f'{v:.4f}' for v in b2b[n])})" for n in fns)
        + f"; kernel / chain {t['kernel'] / t['module chain']:.2f}x alone, "
        f"{q['kernel'] / q['module chain']:.2f}x b2b")
    del out, ref16, ref32


def _attn_work(bw, nh, nq, nk, hd, n_mask):
    """(FLOPs, bytes) of one K15 or K16 call: QK^T and AV (4 Nk hd a query
    row); q, k, v and the output in bf16, the bias and the mask in fp32,
    each once."""
    return (bw * nh * 4 * nq * nk * hd,
            2 * bw * nh * (nq + nk) * hd * 2 + (nh + n_mask) * nq * nk * 4)


def _sdpa_mask(bias, mask, bw):
    """The bias (plus window w's mask[w % nW]) as SDPA's bf16 float
    attn_mask [BW, nH, Nq, Nk]."""
    import torch

    nh, nq, nk = bias.shape
    am = bias[None].expand(bw, nh, nq, nk)
    if mask is not None:
        am = am + mask[torch.arange(bw, device=bias.device) % mask.shape[0]][:, None]
    return am.to(torch.bfloat16).contiguous()


def phase_rect_attention_kernels(res):
    """K15 (window attention, Nq queries against Nk keys) at the shapes of
    its paths: HAT's OCAB at the bench batch ([2500, 6, 49, 16] against
    100 keys: ws 7, ows 10, C 96), hat_fast's ([1600, 6, 64, 16] against
    144), HAT-SRx4's ([400, 6, 256, 30] against 576: ws 16, ows 24, C
    180) and its train step's ([128, 6, 256, 30]), the square masked
    case (SwinIR-M's bench batch at ws 8, [1600, 6, 64, 30] with the
    shift mask [64, 64, 64]), hd 44 (C 264 in 6 heads) at HAT's OCAB,
    at the OCAB of window 16 and square with the shift mask, hd 64, and
    odd heads (hd 45, unmasked and masked) and HAT embed 264's masked 49-token HAB
    units, and the "stream" route's shapes: hd 96 and a masked unit of
    1024 keys at hd 64.  Unscaled q with scale
    hd^-0.5, as the OCAB calls it.  Each output in bf16 ulps against the
    plain bf16 and fp32 versions; kernel, plain and SDPA times (bias +
    mask as a bf16 attn_mask) and the bound, into `res`.  Beside the
    wrapper's call (its route, ``k15_route``), the call back to back and
    every kernel that takes the shape (``_attention_forms``) are timed at
    each shape, and at hd % 8 == 0 the element loads that rows off a
    16-byte boundary take, which must give the same output bit for
    bit."""
    import torch
    import torch.nn.functional as F

    from tpu_superresolution_torch.kernels import window_attention as kw
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)  # inputs made on the card
    bf = torch.bfloat16
    # (label, BW, nH, Nq, Nk, hd, the shift mask's (map side, ws, shift) or None)
    for label, bw, nh, nq, nk, hd, geom in (
            ("HAT (ws 7, ows 10) bench batch", 2500, 6, 49, 100, 16, None),
            ("hat_fast (ws 8, ows 12)", 1600, 6, 64, 144, 16, None),
            ("HAT-SRx4 (ws 16, ows 24)", 400, 6, 256, 576, 30, None),
            ("HAT-SRx4 train step", 128, 6, 256, 576, 30, None),
            ("square, masked (SwinIR-M ws 8, shift 4)", 1600, 6, 64, 64, 30, (64, 8, 4)),
            ("HAT embed 264 (ws 7, ows 10, hd 44)", 2500, 6, 49, 100, 44, None),
            ("HAT embed 264 at ws 16 (ows 24, hd 44)", 64, 6, 256, 576, 44, None),
            ("square, masked, hd 44 (C 264, ws 8, shift 4)", 1600, 6, 64, 64, 44, (64, 8, 4)),
            ("hd 64 (C 256, 4 heads; ws 8, ows 12)", 1600, 4, 64, 144, 64, None),
            # odd heads (element loads; the wgmma kernel unmasked, the
            # stream kernel masked) and masked 49-token units
            ("OCAB hd 45 (C 180 in 4 heads; ws 8, ows 12)", 1600, 4, 64, 144, 45, None),
            ("square, masked, hd 45 (C 180 in 4 heads, ws 8, shift 4)", 256, 4, 64, 64, 45,
             (64, 8, 4)),
            ("HAT embed 264 HAB, masked, hd 44 (ws 7, shift 3)", 400, 6, 49, 49, 44,
             (70, 7, 3)),
            # the "stream" route (csrc/window_attn_stream.cu): heads past 64
            # dims (an OCAB at C 576 in 6 heads) and a unit of 1024 keys
            ("stream: OCAB hd 96 (C 576, 6 heads; ws 7, ows 10)", 400, 6, 49, 100, 96, None),
            ("stream: square, masked, ws 32 (N 1024), hd 64", 8, 2, 1024, 1024, 64,
             (64, 32, 16))):
        masked = geom is not None
        q = torch.randn(bw, nh, nq, hd, generator=gen, device=dev).to(bf)
        k, v = (torch.randn(bw, nh, nk, hd, generator=gen, device=dev).to(bf) for _ in range(2))
        bias = 0.5 * torch.randn(nh, nq, nk, generator=gen, device=dev)
        mask = shift_mask_tensor(geom[0], geom[0], geom[1], geom[2], dev) if masked else None
        n_mask = 0 if mask is None else mask.shape[0]
        scale = hd ** -0.5
        run = lambda: kw.fused_window_attention(q, k, v, bias, mask, scale)
        plain = lambda: kw.fused_window_attention_plain(q, k, v, bias, mask, scale)
        out = run()
        ref16 = plain()
        ref32 = kw.fused_window_attention_plain(q.float(), k.float(), v.float(), bias, mask,
                                                scale)
        am = _sdpa_mask(bias, mask, bw)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=scale)
        torch.cuda.synchronize()
        _compare(res, "K15", f"{label} [{bw},{nh},{nq},{hd}] x {nk} keys"
                 f"{', mask ' + str(list(mask.shape)) if masked else ''}", out, ref16, ref32,
                 cuda_ms(run), cuda_ms(plain), _attn_work(bw, nh, nq, nk, hd, n_mask),
                 cuda_ms(lib))
        route = kw.k15_route(nq, nk, hd, masked, kw.K15_SPLIT_P)
        forms = [f"call {cuda_ms(run):.4f} ms, b2b {queued_ms(run):.4f} (SDPA b2b "
                 f"{queued_ms(lib):.4f})"]
        forms += _attention_forms("K15", label, q, k, v, bias, mask, scale, kw.K15_SPLIT_P,
                                  ref32)
        if hd % 8 == 0:
            qu, ku, vu = (_unaligned(t) for t in (q, k, v))
            form = lambda: kw._launch(qu, ku, vu, bias, mask, scale, kw.launches_rect,
                                      kw.K15_SPLIT_P)
            if not torch.equal(form(), out):
                raise RuntimeError(f"K15 {label}: the element loads change the output")
            forms.append(f"element loads {cuda_ms(form):.4f} ms (output identical)")
            del qu, ku, vu
        log(f"[kernels] K15 {label} route {route} forms: {'; '.join(forms)} (wrapper: "
            f"{'split' if kw.K15_SPLIT_P else 'bf16'} P, 16-byte loads where aligned)")
        del out, ref16, ref32, am
    _log_route_rows()
    return res


# (kernel, row, the route's kernel and form of P, {form: b2b ms}) of
# every K15 / K16 row: the measurements that k15_route's choices stand on
_ROUTE_ROWS = []


def _attention_forms(key, label, q, k, v, bias, mask, scale, split_p, ref32):
    """Every kernel that takes the shape of a K15 / K16 call, each checked
    against the plain fp32 version (within ULP_BOUND[key] bf16 ulps) and
    timed alone and back to back, with the share of its outputs whose
    bf16 rounding differs from the fp32 version's: the tiled kernel at hd
    <= 32 (P in two bf16 parts and rounded once), the wgmma kernel where
    ``wg_plan`` places a unit, the square kernel where ``sq_plan`` takes
    the window (P in three parts), and the stream kernel (every shape),
    the wgmma and stream kernels with the wrapper's form of P.  Returns
    the forms' log strings."""
    from tpu_superresolution_torch.kernels import window_attention as kw

    bw, nh, nq, hd = q.shape
    nk = k.shape[2]
    masked = mask is not None
    bound = ULP_BOUND[key] * bf16_ulp(float(ref32.abs().max()))
    counter = kw.launches_rect if key == "K15" else kw.launches
    routes = []
    if hd <= kw.TILED_MAX_HD:
        routes += [("tiled", True), ("tiled", False)]
    if hd <= kw.WG_MAX_HD and kw.wg_plan(nq, nk, hd, masked, bool(split_p)) is not None:
        routes.append(("wgmma", split_p))
    if nq == nk and kw.sq_plan(nq, hd) is not None:
        routes.append(("square", True))
    routes.append(("stream", split_p))
    forms, b2b = [], {}
    for other, split in routes:
        form = lambda other=other, split=split: kw._launch(q, k, v, bias, mask, scale, counter,
                                                           split, route=other)
        got = form()
        err = float((got.float() - ref32.float()).abs().max())
        if not err <= bound:
            raise RuntimeError(f"{key} {label}: the {other} kernel with "
                               f"{'split' if split else 'bf16'} P is {err:.3e} off the plain "
                               f"fp32 version (bound {bound:.3e})")
        # the share of outputs off the fp32 version's own bf16 rounding
        off = float((got != ref32.to(got.dtype)).float().mean())
        name = f"{other} {'split' if split else 'bf16'} P"
        b2b[name] = queued_ms(form)
        forms.append(f"{name} {cuda_ms(form):.4f} ms (b2b {b2b[name]:.4f}; max_abs_err vs "
                     f"plain fp32 {err:.3e}, bound {bound:.3e}; {off:.2e} of the outputs "
                     f"rounded otherwise than the fp32 version)")
    wrapper = f"{kw.k15_route(nq, nk, hd, masked, split_p)} {'split' if split_p else 'bf16'} P"
    _ROUTE_ROWS.append((key, label, wrapper, b2b))
    return forms


def _log_route_rows():
    """One line a K15 / K16 row: each kernel's back-to-back time against
    the fastest's, and whether the route's choice is the fastest."""
    for key, label, wrapper, b2b in _ROUTE_ROWS:
        best = min(b2b, key=b2b.get)
        log(f"[kernels] route check {key} {label}: route {wrapper} "
            f"{'(fastest)' if wrapper == best else f'(fastest: {best})'}; "
            + ", ".join(f"{n} {t / b2b[best]:.2f}x" for n, t in b2b.items()))


def _unaligned(t):
    """A copy of t whose data starts 2 bytes past a 16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def phase_dat_train_kernels(res):
    """The DAT module chain's kernels: K16 (batched window attention) at
    the DAT train step's [256, 3, 128, 30] and the bench tile batch's
    [800, 3, 128, 30] (DATConfig(): windows 8 x 16 of a 64^2 map, 3 heads
    a branch of hd 30), each with and without the shift mask, at the
    published DAT x4's N 256 ([400, 3, 256, 30], windows 8 x 32) and at
    branches of hd 44 and 64 (C 176 and 256 in 4 heads; heads padded to
    64 dims), each with two runs bit-identical, every kernel that takes a
    row timed (``_attention_forms``), SDPA beside it; K11
    (depthwise 3x3) at the train step's conv branch [8, 64, 64, 180] and
    the published x4's sg_conv [25, 64, 64, 360].  Each output in bf16
    ulps against the plain bf16 and fp32 versions; kernel, plain and
    library times (SDPA with bias + mask as attn_mask; cuDNN's grouped
    conv2d) and the bound, into `res`."""
    import torch
    import torch.nn.functional as F

    from tpu_superresolution_torch.kernels import dwconv as kd
    from tpu_superresolution_torch.kernels import window_attention as kw
    from tpu_superresolution_torch.ops.window import rect_mask_tensor

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 6)
    bf = torch.bfloat16
    for bw, nh, hd, (hsp, wsp) in ((256, 3, 30, (8, 16)), (800, 3, 30, (8, 16)),
                                   (400, 3, 30, (8, 32)), (256, 2, 44, (8, 16)),
                                   (256, 2, 64, (8, 16))):
        n = hsp * wsp
        q = (torch.randn(bw, nh, n, hd, generator=gen) * hd ** -0.5).to(dev, bf)
        k, v = (torch.randn(bw, nh, n, hd, generator=gen).to(dev, bf) for _ in range(2))
        bias = (0.5 * torch.randn(nh, n, n, generator=gen)).to(dev)
        for masked in (False, True):
            mask = rect_mask_tensor(64, 64, hsp, wsp, hsp // 2, wsp // 2, dev) if masked else None
            n_mask = 0 if mask is None else mask.shape[0]
            run = lambda: kw.batched_window_attention(q, k, v, bias, mask)
            plain = lambda: kw.batched_window_attention_plain(q, k, v, bias, mask)
            out = run()
            if not torch.equal(out, run()):
                raise RuntimeError(f"K16 [{bw},{nh},{n},{hd}] masked={masked}: two runs differ")
            ref16, ref32 = plain(), kw.batched_window_attention_plain(q.float(), k.float(),
                                                                      v.float(), bias, mask)
            am = _sdpa_mask(bias, mask, bw)
            lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=1.0)
            torch.cuda.synchronize()
            _compare(res, "K16", f"[{bw},{nh},{n},{hd}] {'masked' if masked else 'unmasked'} "
                     f"({kw.k15_route(n, n, hd, masked, kw.K16_SPLIT_P)} route; two runs "
                     f"bit-identical; b2b {queued_ms(run):.4f} ms, SDPA b2b {queued_ms(lib):.4f})",
                     out, ref16, ref32, cuda_ms(run), cuda_ms(plain),
                     _attn_work(bw, nh, n, n, hd, n_mask), cuda_ms(lib))
            label = f"[{bw},{nh},{n},{hd}] {'masked' if masked else 'unmasked'}"
            route = kw.k15_route(n, n, hd, masked, kw.K16_SPLIT_P)
            forms = _attention_forms("K16", label, q, k, v, bias, mask, 1.0, kw.K16_SPLIT_P,
                                     ref32)
            log(f"[kernels] K16 {label} route {route} forms: {'; '.join(forms)} (wrapper: "
                f"{'split' if kw.K16_SPLIT_P else 'bf16'} P)")
            del out, ref16, ref32, am
    for shape in ((8, 64, 64, 180), (25, 64, 64, 360)):
        c = shape[-1]
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        taps = (torch.randn(3, 3, c, generator=gen) / 3).to(dev)
        b = (0.1 * torch.randn(c, generator=gen)).to(dev)
        run = lambda: kd.dwconv3x3(x, taps, b)
        plain = lambda: kd.dwconv3x3_plain(x, taps, b)
        out = run()
        ref16, ref32 = plain(), kd.dwconv3x3_plain(x.float(), taps, b)
        wt = taps.permute(2, 0, 1)[:, None].to(bf).contiguous()
        xn, bb = x.permute(0, 3, 1, 2), b.to(bf)
        lib = lambda: F.conv2d(xn, wt, bb, padding=1, groups=c)
        torch.cuda.synchronize()
        pixels = math.prod(shape[:3])
        plan = kd.dwconv_plan(*shape, torch.cuda.get_device_properties(dev).multi_processor_count)
        # the "rows" kernel sums in the "tiles" kernel's order: bit for bit
        forms = []
        for route in ("rows", "tiles"):
            form = lambda route=route: kd._launch(x, taps, b, route=route)
            if not torch.equal(out, form()):
                raise RuntimeError(f"K11 {list(shape)}: the rows and tiles kernels disagree")
            forms.append(f"{route} {cuda_ms(form):.4f} ms (b2b {queued_ms(form):.4f})")
        log(f"[kernels] K11 {list(shape)} both kernels, output identical: {'; '.join(forms)}")
        geometry = (f": {plan.threads} threads, {plan.rows} rows x {plan.seg} columns a CTA, "
                    f"{plan.slots} row buffers, grid {plan.grid}" if plan.route == "rows" else "")
        _compare(res, "K11", f"{list(shape)} ({plan.route} route{geometry}; b2b "
                 f"{queued_ms(run):.4f} ms, cuDNN b2b {queued_ms(lib):.4f})",
                 out, ref16, ref32, cuda_ms(run), cuda_ms(plain),
                 (18 * pixels * c, 2 * pixels * c * 2 + 10 * c * 4), cuda_ms(lib))
        del out, ref16, ref32
    return res


def _random_k7(gen, device, c, nh, ws):
    """K7's raw weights at width C, `nh` heads and window `ws` with O(1)
    activations (bf16-representable GEMM weights) and its relative-
    position table [(2ws-1)^2, nh]."""
    import torch

    def r(*shape, scale=1.0, bf=False):
        t = torch.randn(*shape, generator=gen) * scale
        return (t.bfloat16().float() if bf else t).to(device)

    return (r(3 * c, c, scale=c ** -0.5, bf=True), r(3 * c, scale=0.1),
            r(c, c, scale=c ** -0.5, bf=True), r(c, scale=0.1),
            r((2 * ws - 1) ** 2, nh, scale=0.5))


def _k7_work(windows, n, c, nh):
    """(FLOPs, bytes) of one K7 call: per token qkv 6C^2, QK^T and AV over
    N keys 4NC, proj 2C^2; xw read and out written in bf16, the weights
    (bf16) and the bias [nh, N, N] (fp32) read once."""
    tokens = windows * n
    return (tokens * (6 * c * c + 4 * n * c + 2 * c * c),
            tokens * c * 2 * 2 + 4 * c * c * 2 + nh * n * n * 4)


def _tail_work(tokens, c, hidden, extra):
    """(FLOPs, bytes) of one K1t call: fc1 and fc2, 4 C hidden per
    token; x, attn (and extra) read and out written in bf16, the MLP
    weights once."""
    return tokens * 4 * c * hidden, tokens * c * 2 * (4 if extra else 3) + 2 * c * hidden * 2


def _k12_work(pixels, c, cm):
    """(FLOPs, bytes) of one K12 call: two 3x3 convs C -> Cmid -> C per
    pixel; x read and y written in bf16, the weights once."""
    return pixels * 2 * 2 * 9 * c * cm, pixels * c * 2 * 2 + 2 * 9 * c * cm * 2


def _tail_cases(res, gen, dev):
    """K1t at the main paths' shapes: the kernel ``tail_route`` names
    (csrc/swin_tail_wg.cu to C 256, the WMMA csrc/swin_tail.cu past it),
    each output within ULP_BOUND bf16 ulps of its plain bf16 and fp32
    versions, alone and back to back, two runs bit-identical; on the
    wgmma route the WMMA kernel on the same call as the A/B (wgmma, WMMA,
    WMMA, wgmma), checked against the plain fp32 version too."""
    import torch

    from tpu_superresolution_torch.kernels import fused_block as fb

    bf = torch.bfloat16
    for shape, nh, hidden, ws, shift, with_extra, with_scales in (
            ((25, 64, 64, 180), 6, 360, 16, 8, True, False),
            ((25, 64, 64, 240), 8, 480, 8, 4, False, True),
            # phase_wide's blocks (the WMMA route): SwinIR at C 264 and
            # HAT's HAB at embed 264 (ws 7, the CAB as extra), and C 576
            # (32 pixels a block)
            ((4, 64, 64, 264), 6, 528, 8, 4, False, False),
            ((4, 70, 70, 264), 6, 528, 7, 3, True, False),
            ((4, 64, 64, 576), 8, 1152, 8, 4, False, False)):
        b, c = shape[0], shape[-1]
        w = _random_block(gen, dev, c=c, nh=nh, hidden=hidden, ws=ws)
        route = fb.tail_route(c, hidden)
        packs = {route: fb.pack_block_tail(w.g2, w.b2, w.wfc1, w.bfc1, w.wfc2, w.bfc2)}
        if route == "wgmma":
            packs["wmma"] = fb.pack_block_tail(w.g2, w.b2, w.wfc1, w.bfc1, w.wfc2, w.bfc2,
                                               route="wmma")
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        windows = b * (shape[1] // ws) * (shape[2] // ws)
        attn = torch.randn(windows, ws * ws, c, generator=gen).to(dev, bf)
        extra = (0.1 * torch.randn(*shape, generator=gen)).to(dev, bf) if with_extra else None
        scales = (torch.tensor([[1.0, 0.0], [1.25, 1.25]]).repeat(b // 2 + 1, 1)[:b].to(dev)
                  if with_scales else None)
        runs = {r: (lambda pk=pk: fb.fused_block_tail(x, attn, w, ws, shift, False, scales,
                                                      extra, packed=pk))
                for r, pk in packs.items()}
        run = runs[route]
        plain = lambda: fb.swin_block_tail_plain(x, attn, w, ws, shift, False, scales, extra)
        out = run()
        twice = run()
        ref16 = plain()
        ref32 = fb.swin_block_tail_plain(x.float(), attn.float(), w, ws, shift, False, scales,
                                         None if extra is None else extra.float())
        torch.cuda.synchronize()
        if not torch.equal(out, twice):
            raise RuntimeError(f"K1t {list(shape)}: two runs differ")
        alone, b2b = ({r: [] for r in runs} for _ in range(2))
        for r in list(runs) + list(runs)[::-1]:
            alone[r].append(cuda_ms(runs[r]))
            b2b[r].append(queued_ms(runs[r]))
        mean = lambda v: sum(v) / len(v)
        ab = ""
        if route == "wgmma":
            old = runs["wmma"]()
            torch.cuda.synchronize()
            e_old = float((old.float() - ref32.float()).abs().max())
            bound = ULP_BOUND["K1t"] * bf16_ulp(float(ref32.abs().max()))
            if not e_old <= bound:
                raise RuntimeError(f"K1t {list(shape)}: the WMMA kernel off by {e_old:.3e}")
            ab = (f"; the WMMA kernel on the same call {mean(alone['wmma']):.4f} ms "
                  f"({' / '.join(f'{t:.4f}' for t in alone['wmma'])}), b2b "
                  f"{mean(b2b['wmma']):.4f}, max_abs_err {e_old:.3e}; wgmma / WMMA "
                  f"{mean(alone['wgmma']) / mean(alone['wmma']):.3f}x alone, "
                  f"{mean(b2b['wgmma']) / mean(b2b['wmma']):.3f}x b2b")
            del old
        _compare(res, "K1t", f"{list(shape)} hidden {hidden} ws {ws} shift {shift}"
                 f"{', extra' if with_extra else ''}{', branch scales' if with_scales else ''}"
                 f" (route {route}; "
                 f"{' / '.join(f'{t:.4f}' for t in alone[route])} ms, b2b "
                 f"{mean(b2b[route]):.4f}; two runs bit-identical{ab})",
                 out, ref16, ref32, mean(alone[route]), cuda_ms(plain),
                 _tail_work(math.prod(shape[:3]), c, hidden, with_extra))
        del out, twice, ref16, ref32
    # correctness only: the wgmma kernel's other paths and the WMMA
    # kernel's scratch (K1T_ENVELOPE)
    for shape, hidden, ws, shift, with_extra, with_scales, tanh in K1T_ENVELOPE:
        b, c = shape[0], shape[-1]
        w = _random_block(gen, dev, c=c, nh=1, hidden=hidden, ws=ws)
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        windows = b * (shape[1] // ws) * (shape[2] // ws)
        attn = torch.randn(windows, ws * ws, c, generator=gen).to(dev, bf)
        extra = (0.1 * torch.randn(*shape, generator=gen)).to(dev, bf) if with_extra else None
        scales = (torch.tensor([[1.0, 0.0], [1.25, 1.25], [0.0, 1.25]])[:b].to(dev)
                  if with_scales else None)
        run = lambda: fb.fused_block_tail(x, attn, w, ws, shift, tanh, scales, extra)
        out, twice = run(), run()
        ref32 = fb.swin_block_tail_plain(x.float(), attn.float(), w, ws, shift, tanh, scales,
                                         None if extra is None else extra.float())
        torch.cuda.synchronize()
        mag = float(ref32.abs().max())
        bound = ULP_BOUND["K1t"] * bf16_ulp(mag)
        err = float((out.float() - ref32).abs().max())
        ok = math.isfinite(err) and err <= bound and torch.equal(out, twice)
        log(f"[kernels] K1t envelope {list(shape)} hidden {hidden} ws {ws} shift {shift}"
            f"{', extra' if with_extra else ''}{', branch scales' if with_scales else ''}"
            f"{', tanh' if tanh else ''} (route {fb.tail_route(c, hidden)}): max_abs_err vs "
            f"plain fp32 {err:.3e} (bound {bound:.3e}), two runs "
            f"{'identical' if torch.equal(out, twice) else 'DIFFER'} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"K1t {list(shape)}: outside its bound or not deterministic")
        del out, twice, ref32


def phase_window_kernels(res):
    """K7 (the window attention for any window, width and head dim), K1t
    and K12 (HAT's fused LN + CAB convs) at the main paths' shapes, each
    output within ULP_BOUND bf16 ulps of its plain bf16 and fp32
    versions, with times and bounds, into `res`.  K7: HAT-SRx4's bench
    batch [25,64,64,180] at ws 16 (N 256), unshifted and shift 8 with the
    mask; SwinIR-L's widths (C 240, 8 heads) at ws 8 shifted; ws 6 (N
    36); ws 32 (N 1024) shifted; each with the bias as the table + token
    codes (the models' form) and dense, beside F.linear + SDPA (float
    mask) + F.linear; then its product launch alone beside cuBLAS
    (`F.linear`) at [16384,264] -> 792 and -> 264, [16384,180] -> 540,
    HAT-SRx4's qkv [102400,180] -> 540, an odd width and C 576.  K1t:
    HAT-SRx4's widths at ws 16, shift 8, with `extra`; SwinIR-L's (C 240,
    hidden 480) at ws 8, shift 4, with branch scales; C 264 at ws 8 and 7.
    K12: the HAT-SRx4, HAT (ws 7, reflect-padded tiles), hat_fast and
    HAT-S shapes, each also timed against the two compositions that
    compute its function (K2, then cuDNN conv, GELU, cuDNN conv; and the
    port's K2 + K3 with the GELU epilogue + K3).  Each kernel's first
    case is the one the kernels line reports."""
    import torch
    import torch.nn.functional as F

    from tpu_superresolution_torch.kernels import cab_conv as cc
    from tpu_superresolution_torch.kernels import fused_attention as fa
    from tpu_superresolution_torch.kernels import fused_block as fb
    from tpu_superresolution_torch.kernels.layernorm import layernorm
    from tpu_superresolution_torch.ops.window import (
        relative_position_bias,
        shift_mask_tensor,
        window_codes_tensor,
        window_partition,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 6)
    bf = torch.bfloat16
    for shape, nh, ws, shift in (((25, 64, 64, 180), 6, 16, 0), ((25, 64, 64, 180), 6, 16, 8),
                                 ((25, 64, 64, 240), 8, 8, 4), ((8, 48, 48, 180), 6, 6, 3),
                                 ((2, 64, 64, 180), 6, 32, 16),
                                 # odd widths: element copies, heads of 15 dims
                                 ((2, 32, 32, 45), 3, 8, 4)):
        c = shape[-1]
        wqkv, bqkv, wproj, bproj, table = _random_k7(gen, dev, c, nh, ws)
        rpb = relative_position_bias(table, ws)
        packed = fa.pack_window_attention(wqkv, bqkv, wproj, bproj, rpb, table, ws)
        codes = window_codes_tensor(shape[1], shape[2], ws, shift, dev)
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        xw = window_partition(x, ws).contiguous()
        mask = shift_mask_tensor(shape[1], shape[2], ws, shift, dev) if shift else None
        # the rel form (table + token codes: the models' path) and the
        # dense form (the gathered [nH, N, N] bias and [nW, N, N] mask)
        run = lambda: fa.fused_window_attention(xw, wqkv, bqkv, wproj, bproj, None, mask,
                                                packed=packed, codes=codes)
        dense = lambda: fa.fused_window_attention(xw, wqkv, bqkv, wproj, bproj, rpb, mask,
                                                  packed=packed)
        scale = (c // nh) ** -0.5
        plain = lambda: fa.window_attention_plain(xw, wqkv, bqkv, wproj, bproj, rpb, mask, scale)
        # one PyTorch call a stage: F.linear, SDPA with the float mask
        # bias + mask, F.linear
        bw, n = xw.shape[0], ws * ws
        am = rpb[None].to(bf) if mask is None else _sdpa_mask(rpb, mask, bw)
        wqkv_b, bqkv_b, wproj_b, bproj_b = (t.to(bf) for t in (wqkv, bqkv, wproj, bproj))

        def library():
            qkv = F.linear(xw, wqkv_b, bqkv_b).reshape(bw, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], attn_mask=am)
            return F.linear(o.transpose(1, 2).reshape(bw, n, c), wproj_b, bproj_b)

        ref16 = plain()
        ref32 = fa.window_attention_plain(xw.float(), wqkv, bqkv, wproj, bproj, rpb, mask, scale)
        label = f"{list(shape)} C {c} {nh} heads ws {ws} (N {n}) shift {shift}"
        t_lib = cuda_ms(library)
        for form, fn in (("table + codes", run), ("dense bias and mask", dense)):
            out = fn()
            torch.cuda.synchronize()
            _compare(res, "K7", f"{label}, {form} (b2b {queued_ms(fn):.4f} ms, composition b2b "
                     f"{queued_ms(library):.4f})", out, ref16, ref32, cuda_ms(fn), cuda_ms(plain),
                     _k7_work(bw, n, c, nh), t_lib)
            del out
        del ref16, ref32, am

    # K7's product launch alone (its qkv and proj products; the ws-16
    # block backward's qkv recompute), beside cuBLAS: C 264 (qkv 792,
    # proj 264), C 180 in 4 heads (qkv 540), HAT-SRx4's qkv on its bench
    # batch, an odd width (element loads and stores) and C 576
    for rows, c_in, c_out in ((16384, 264, 792), (16384, 264, 264), (16384, 180, 540),
                              (102400, 180, 540), (4096, 45, 135), (16384, 576, 1728)):
        x = torch.randn(rows, c_in, generator=gen).to(dev, bf)
        w = (torch.randn(c_out, c_in, generator=gen) * c_in ** -0.5).bfloat16().float().to(dev)
        b = (0.1 * torch.randn(c_out, generator=gen)).to(dev)
        packed = fa.pack_window_product(w, b)
        run = lambda: fa._launch_product(x, packed)
        plain = lambda: fa.window_product_plain(x, w, b)
        wb, bb = w.to(bf), b.to(bf)
        out = run()
        ref16, ref32 = plain(), fa.window_product_plain(x.float(), w, b)
        torch.cuda.synchronize()
        plan = packed.plan
        _compare(res, "K7", f"product [{rows},{c_in}] -> {c_out} (N {plan.n_tile} x "
                 f"{plan.n_tiles}; b2b {queued_ms(run):.4f} ms, cuBLAS b2b "
                 f"{queued_ms(lambda: F.linear(x, wb, bb)):.4f})", out, ref16, ref32,
                 cuda_ms(run), cuda_ms(plain),
                 (2 * rows * c_in * c_out,
                  rows * (c_in + c_out) * 2 + c_out * c_in * 2 + c_out * 4),
                 cuda_ms(lambda: F.linear(x, wb, bb)))
        del out, ref16, ref32

    _tail_cases(res, gen, dev)

    for label, shape, cm in (("HAT-SRx4", (25, 64, 64, 180), 60),
                             ("HAT (ws 7, padded tiles)", (25, 70, 70, 96), 32),
                             ("hat_fast", (25, 64, 64, 96), 32),
                             ("HAT-S (compress 24)", (25, 64, 64, 144), 6),
                             # Cmid 65-128: y1 in two 64-channel chunks
                             ("C 256 / Cmid 128 (compress 2)", (25, 64, 64, 256), 128),
                             # widths off the 4-channel pieces: pair and element paths
                             ("C 90 (pairs)", (2, 30, 31, 90), 30),
                             ("C 45 (elements)", (2, 17, 20, 45), 15)):
        c = shape[-1]
        def rnd(*s, sc=1.0, b16=False):
            t = torch.randn(*s, generator=gen) * sc
            return (t.bfloat16().float() if b16 else t).to(dev)

        g, b = 1 + rnd(c, sc=0.1), rnd(c, sc=0.1)
        k1, c1 = rnd(3, 3, c, cm, sc=(9 * c) ** -0.5, b16=True), rnd(cm, sc=0.1)
        k2, c2 = rnd(3, 3, cm, c, sc=(9 * cm) ** -0.5, b16=True), rnd(c, sc=0.1)
        k1b, k2b = k1.to(bf), k2.to(bf)
        packed = cc.pack_cab(g, b, k1b, c1, k2b, c2)
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        run = lambda: cc.fused_ln_cab_convs(x, g, b, k1b, c1, k2b, c2, packed=packed)
        plain = lambda: cc.fused_ln_cab_convs_plain(x, g, b, k1b, c1, k2b, c2)
        # what the CAB ran before K12: K2, then NCHW-view cuDNN convs in
        # bf16 (each made contiguous NHWC) with the GELU between
        w1, w2 = k1b.permute(3, 2, 0, 1), k2b.permute(3, 2, 0, 1)
        c1b, c2b = c1.to(bf), c2.to(bf)
        nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()
        composed = lambda: nhwc(F.conv2d(
            F.gelu(nhwc(F.conv2d(layernorm(x, g, b).permute(0, 3, 1, 2), w1, c1b, padding=1))
                   ).permute(0, 3, 1, 2), w2, c2b, padding=1))
        # the port's own composition (K2, K3 with the GELU, K3), the CAB's
        # route past K12's widths
        pconvs = (cc.pack_conv_weight(k1b), cc.pack_conv_weight(k2b))
        convs = lambda: cc.ln_cab_convs(x, g, b, k1b, c1, k2b, c2, packed=pconvs)
        out = run()
        ref16 = plain()
        ref32 = cc.fused_ln_cab_convs_plain(x.float(), g, b, k1, c1, k2, c2)
        torch.cuda.synchronize()
        # each timed twice, in the order kernel, compositions, then back,
        # alone and back to back; the mean of the two passes
        fns = {"kernel": run, "K2 + cuDNN convs + GELU": composed, "K2 + K3 (GELU) + K3": convs}
        order = list(fns) + list(fns)[::-1]
        alone, b2b = ({n: [] for n in fns} for _ in range(2))
        for n in order:
            alone[n].append(cuda_ms(fns[n]))
            b2b[n].append(queued_ms(fns[n]))
        mean = lambda v: sum(v) / len(v)
        t = {n: mean(v) for n, v in alone.items()}
        q = {n: mean(v) for n, v in b2b.items()}
        plan = packed.plan
        _compare(res, "K12", f"{label} {list(shape)} {c} -> {cm} -> {c} (N1 {plan.n1}, N2 "
                 f"{plan.n2} x {plan.passes}; route {cc.cab_route(c, cm)})", out, ref16, ref32,
                 t["kernel"], cuda_ms(plain), _k12_work(math.prod(shape[:3]), c, cm))
        best = lambda d: min(d[n] for n in fns if n != "kernel")
        log(f"[kernels] K12 {label}: " + "; ".join(
            f"{n} {t[n]:.4f} ms ({' / '.join(f'{x:.4f}' for x in alone[n])}), b2b {q[n]:.4f} "
            f"({' / '.join(f'{x:.4f}' for x in b2b[n])})" for n in fns)
            + f"; kernel / better composition {t['kernel'] / best(t):.2f}x alone, "
            f"{q['kernel'] / best(q):.2f}x b2b")
        del out, ref16, ref32
    return res


def _png_bytes(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        data = resp.read()
        status = resp.status
        meta = json.loads(resp.headers.get("X-SR-Meta", "{}"))
    return status, data, meta, time.perf_counter() - t0


def phase_serve(workdir, cfg, model_name, per_call, tag="serve", prepare=None):
    """`cfg` with seeded random weights (then `prepare(model, generator)`
    when given), exported as a reference .pth, behind SRService +
    make_server (--model `model_name`, --no-exact): three PNG requests,
    exactly `per_call` launches per model call, and the served tiled
    output against the plain fp32 path."""
    import numpy as np
    import torch
    from PIL import Image

    from tpu_superresolution_torch.cli.serve import SRService, make_server
    from tpu_superresolution_torch.core.config import EvalConfig, build_model
    from tpu_superresolution_torch.evaluate.runner import Evaluator
    from tpu_superresolution_torch.evaluate.tiling import tile_grid
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    src = build_model(cfg)
    src.reset_parameters(torch.Generator().manual_seed(SEED))
    if prepare is not None:
        prepare(src, torch.Generator().manual_seed(SEED + 5))
    ckpt = f"{workdir}/{model_name}_x4_random.pth"
    torch.save({"params": src.state_dict()}, ckpt)

    tile_batch = 8
    service = SRService(ckpt, model_name, "X4", False, -1, 16, tile_batch, device="cuda")
    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    rng = np.random.default_rng(SEED)

    def image(h, w):
        # a smooth gradient with texture, as uint8 RGB
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base_img = np.stack([yy / h, xx / w, 0.5 + 0.25 * np.sin((yy + xx) / 7.0)], -1)
        noisy = base_img + 0.05 * rng.standard_normal((h, w, 3))
        return (np.clip(noisy, 0, 1) * 255 + 0.5).astype(np.uint8)

    requests = [
        ("256x256 whole image", image(256, 256), "", 0, 16),
        ("320x240 auto-tiled 192/16/8", image(240, 320), "", 192, 16),
        ("256x256 tile 64 / overlap 8", image(256, 256), "?tile=64&overlap=8", 64, 8),
    ]
    launches_total = {k: 0 for k in per_call}
    served_tiled = None
    try:
        for label, arr, query, tile, overlap in requests:
            h, w = arr.shape[:2]
            if tile:
                n_tiles = len(tile_grid(h, min(tile, h, w), overlap)) * len(
                    tile_grid(w, min(tile, h, w), overlap))
                calls = math.ceil(n_tiles / tile_batch)
            else:
                calls = 1
            reset_counters()
            status, data, meta, secs = _post(f"{base}/upscale{query}", _png_bytes(arr))
            counts = read_counters()
            with Image.open(io.BytesIO(data)) as im:
                out = np.asarray(im.convert("RGB"))
            log(f"[{tag}] {label}: HTTP {status} {out.shape[1]}x{out.shape[0]} "
                f"{secs * 1e3:.1f} ms round trip ({meta.get('seconds')} s forward, "
                f"tile {meta.get('tile')}); model calls {calls}; launches {counts}")
            if status != 200 or out.shape != (4 * h, 4 * w, 3):
                raise RuntimeError(f"{label}: status {status}, output {out.shape}")
            expect = {k: per * calls for k, per in per_call.items()}
            if counts != expect:
                raise RuntimeError(f"{label}: launches {counts}, expected {expect}")
            for k in per_call:
                launches_total[k] += counts[k]
            # the same forward, returning floats: finite and of the right shape
            fwd = service._fwd_cache.get(tile, overlap)
            xin = torch.from_numpy(arr.astype(np.float32) / 255.0)[None].cuda()
            yf = fwd(xin)
            if not bool(torch.isfinite(yf).all()) or tuple(yf.shape) != (1, 4 * h, 4 * w, 3):
                raise RuntimeError(f"{label}: non-finite or misshapen output {tuple(yf.shape)}")
            if query:
                served_tiled = (xin, out, tile, overlap)
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=60).read())
        log(f"[{tag}] /healthz {health}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)

    # the served tiled output against the plain path in fp32 on the card
    xin, out, tile, overlap = served_tiled
    ref_model = build_model(service.mcfg, dtype=torch.float32, impl="plain", device="cuda")
    ref_model.load_state_dict(service.model.state_dict())
    ref = Evaluator(ref_model, 4, "native_lr",
                    EvalConfig(tile_size=tile, tile_overlap=overlap,
                               max_tile_batch=tile_batch)).forward_fn()(xin)
    ref = ref[0].clamp(0, 1).cpu().numpy().astype(np.float64)
    mse = float(np.mean((out.astype(np.float64) / 255.0 - ref) ** 2))
    psnr = 10 * math.log10(1.0 / max(mse, 1e-20))
    log(f"[{tag}] tiled 64/8 served PNG vs plain fp32 path: PSNR {psnr:.2f} dB "
        f"(bound >= {PSNR_MIN_DB} dB)")
    if psnr < PSNR_MIN_DB:
        raise RuntimeError(f"served output PSNR {psnr:.2f} dB < {PSNR_MIN_DB} dB")
    return service, launches_total


def phase_bench(service, smi, name="SwinIR-M x4", tag="bench"):
    """The bench workload: MPix/s of the kernels and of the plain bf16
    path; returns the kernels' tiled forward (a callable)."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.evaluate.tiling import tiled_forward

    x = torch.from_numpy(np.random.default_rng(SEED).random((1, 256, 256, 3), np.float32)).cuda()
    plain = build_model(service.mcfg, dtype=torch.bfloat16, impl="plain", device="cuda")
    plain.load_state_dict(service.model.state_dict())
    for label, model in (("kernels", service.model), ("plain", plain)):
        def run():
            return tiled_forward(model, x, 4, 64, 8).float()

        with torch.no_grad():
            out = run()  # warm-up (kernel packing, cuDNN plans)
            run()
            torch.cuda.synchronize()
            if tuple(out.shape) != (1, 1024, 1024, 3) or not bool(torch.isfinite(out).all()):
                raise RuntimeError(f"bench {label}: bad output {tuple(out.shape)}")
            n_iter = 10
            t0 = time.perf_counter()
            for _ in range(n_iter):
                out = run()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / n_iter
        log(f"[{tag}] {name}, 256^2 LR, tile 64/8, 25 tiles in one batch, bf16, "
            f"{label}: {dt * 1e3:.2f} ms/image, {1024 * 1024 / 1e6 / dt:.3f} MPix/s ({smi})")
    fwd = lambda: tiled_forward(service.model, x, 4, 64, 8)
    _conv_share(fwd, name, tag, smi)
    return fwd


# The evaluate phase: a DeepRockSR-layout test split of EVAL_IMAGES HR
# images of EVAL_HR^2 (LR 256^2 at x4), the bench workload's tiles, two
# PNG triplets; the x8 self-ensemble over the first EVAL_TTA_IMAGES of
# them, one a batch, one PNG triplet (its plain fp32 reference took 29.8
# s at 8 images, 64 model calls, on an NVIDIA H100 80GB HBM3 at 700 W).
# The PNGs fall in each run's first batch, which the steady window
# (``Evaluator.run``'s mpix_per_s) leaves out: 3 steady batches each.
EVAL_IMAGES, EVAL_TTA_IMAGES, EVAL_HR = 8, 4, 1024
EVAL_TILE, EVAL_OVERLAP, EVAL_TILE_BATCH, EVAL_BATCH = 64, 8, 25, 2
# Dataset means, kernels (bf16) against the plain fp32 path on the card
# (the ROADMAP's PSNR-delta bound), and the GPU baseline against the CPU's.
EVAL_PSNR_DB, EVAL_SSIM, EVAL_BASELINE_DB = 0.05, 1e-3, 1e-3


def _recording_evaluator(model, ecfg):
    """An Evaluator on the card that keeps each batch's SR on the host."""
    from tpu_superresolution_torch.evaluate import Evaluator

    ev = Evaluator(model, 4, "native_lr", ecfg, log=lambda m: None, device="cuda")
    ev.outs, forward_fn = [], ev.forward_fn

    def recording():
        fwd = forward_fn()

        def run(lr):
            out = fwd(lr)
            ev.outs.append(out.cpu())
            return out
        return run
    ev.forward_fn = recording
    return ev


def phase_evaluate(workdir, smi):
    """SwinIR-M x4 evaluation through ``cli.evaluate.main(--device cuda)``
    (seeded random weights exported to a .pth, --no-exact: the serving
    semantics, fused reconstruction) at the bench workload's tiles over
    a synthetic test split of EVAL_IMAGES images of EVAL_HR^2 (two PNG
    triplets) and with --self_ensemble over its first EVAL_TTA_IMAGES
    (one): exit, the report's keys, the PNG triplets,
    launches per model call as the serve phase counts (x8 under the
    ensemble), dataset-mean PSNR / SSIM against the same Evaluator.run
    of the plain fp32 model on the card, every image's SR >= PSNR_MIN_DB
    against the plain fp32 SR; and the bicubic baseline on the card
    against the same on the CPU.  Returns the CLI runs' launches."""
    import torch

    from tpu_superresolution_torch.cli.evaluate import main as evaluate_main
    from tpu_superresolution_torch.cli.upscale import load_any_checkpoint
    from tpu_superresolution_torch.core.config import EvalConfig, SwinIRConfig, build_model
    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.data.loader import Loader
    from tpu_superresolution_torch.evaluate import bicubic_baseline, tile_grid
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.utils.flops import PEAK_BF16_FLOPS, model_flops

    tag = "evaluate"
    data, data_tta = f"{workdir}/deeprock_eval", f"{workdir}/deeprock_eval_tta"
    for root, n in ((data, EVAL_IMAGES), (data_tta, EVAL_TTA_IMAGES)):  # the same first images
        _write_deeprock(root, 0, 0, hr_size=EVAL_HR, scale=4, seed=SEED + 20, n_test=n)
    src = build_model(SwinIRConfig(scale=4))
    src.reset_parameters(torch.Generator().manual_seed(SEED))
    ckpt = f"{workdir}/swinir_x4_eval.pth"
    torch.save({"params": src.state_dict()}, ckpt)
    del src
    mcfg, kernels_model = load_any_checkpoint(ckpt, "swinir", 4, False, torch.device("cuda"))
    plain = build_model(mcfg, dtype=torch.float32, impl="plain", device="cuda")
    plain.load_state_dict(kernels_model.state_dict())
    tiles = len(tile_grid(EVAL_HR // 4, EVAL_TILE, EVAL_OVERLAP)) ** 2
    def loader(root, batch):
        return Loader(PairedIndex(root, "test", "X4"), batch, grayscale=False, channels=3,
                      num_threads=4)

    launches_total = {k: 0 for k in PER_CALL}
    for label, root, n, batch, saves, extra in (
            ("plain", data, EVAL_IMAGES, EVAL_BATCH, 2, []),
            ("x8 self-ensemble", data_tta, EVAL_TTA_IMAGES, 1, 1,
             ["--self_ensemble", "--no_baseline"])):
        ens = "--self_ensemble" in extra
        out_dir = f"{workdir}/eval_{label.replace(' ', '_')}"
        argv = ["--scale", "X4", "--data_root", root, "--model", "swinir", "--ckpt", ckpt,
                "--no-exact", "--device", "cuda", "--tile", str(EVAL_TILE), "--tile_overlap",
                str(EVAL_OVERLAP), "--tile_batch", str(EVAL_TILE_BATCH), "--batch_size",
                str(batch), "--save_n", str(saves), "--save_dir", out_dir, "--workers", "4",
                "--report_json", f"{out_dir}.json"] + extra
        reset_counters()
        res = evaluate_main(argv)
        torch.cuda.synchronize()
        launches = read_counters()
        report = json.loads(open(f"{out_dir}.json").read())
        pngs = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
        n_calls = n // batch * math.ceil(batch * tiles / EVAL_TILE_BATCH) * (8 if ens else 1)
        expect = {k: per * n_calls for k, per in PER_CALL.items()}
        log(f"[{tag}] evaluate CLI, SwinIR-M x4, {label}, {n} images {EVAL_HR}^2, tile "
            f"{EVAL_TILE}/{EVAL_OVERLAP}, {EVAL_TILE_BATCH} tiles a call, batch {batch}: "
            f"PSNR {res['psnr']:.4f} dB, SSIM {res['ssim']:.6f}, wall {res['wall_s']:.3f} s, "
            f"compile_s {res['compile_s']:.3f} s, steady {res['mpix_per_s']:.3f} MPix/s; model "
            f"calls {n_calls}; launches {launches} ({smi})")
        want_keys = {"psnr", "ssim", "n", "wall_s", "compile_s", "mpix_per_s", "flops", "mfu"}
        steady_calls = (n // batch - 1) * math.ceil(batch * tiles / EVAL_TILE_BATCH) * (
            8 if ens else 1)
        analytic = model_flops(mcfg, EVAL_TILE, EVAL_TILE) * EVAL_TILE_BATCH * steady_calls
        log(f"[{tag}] {label}: mfu {res.get('mfu', float('nan')):.4%} of {PEAK_BF16_FLOPS:.4g} "
            f"FLOP/s (dense bf16) beside {res['mpix_per_s']:.3f} MPix/s steady; the steady "
            f"window's FLOPs counted (torch_flops of the pipeline) {res.get('flops', 0):.6g}, "
            f"analytic (model_flops x {EVAL_TILE_BATCH} tiles x {steady_calls} calls) "
            f"{analytic:.6g} (counted / analytic {res.get('flops', 0) / analytic:.4f}) ({smi})")
        want_pngs = [f"idx_{i:06d}_{k}.png" for i in range(saves) for k in ("hr", "lr", "sr")]
        if set(report) != want_keys or report["n"] != n or pngs != want_pngs:
            raise RuntimeError(f"{tag} {label}: report {report}, PNGs {pngs}")
        if launches != expect:
            raise RuntimeError(f"{tag} {label}: launches {launches}, expected {expect}")
        for k in PER_CALL:
            launches_total[k] += launches[k]

        # the same evaluation of the kernels (SR kept) and of the plain fp32 path
        ecfg = EvalConfig(batch_size=batch, tile_size=EVAL_TILE, tile_overlap=EVAL_OVERLAP,
                          max_tile_batch=EVAL_TILE_BATCH, self_ensemble=ens)
        runs = {}
        for name, model in (("kernels", kernels_model), ("plain fp32", plain)):
            ev = _recording_evaluator(model, ecfg)
            t0 = time.perf_counter()
            runs[name] = (ev.run(loader(root, batch)), torch.cat(ev.outs))
            log(f"[{tag}] {label}: Evaluator.run of the {name} path in "
                f"{time.perf_counter() - t0:.2f} s: PSNR {runs[name][0]['psnr']:.4f} dB, SSIM "
                f"{runs[name][0]['ssim']:.6f}")
        ref = runs["plain fp32"][0]
        per_image = [_psnr_db(a, b) for a, b in zip(runs["kernels"][1], runs["plain fp32"][1])]
        d_psnr, d_ssim = abs(res["psnr"] - ref["psnr"]), abs(res["ssim"] - ref["ssim"])
        log(f"[{tag}] {label}: CLI vs plain fp32 dataset means: PSNR {d_psnr:.4f} dB (bound "
            f"{EVAL_PSNR_DB}), SSIM {d_ssim:.2e} (bound {EVAL_SSIM}); each image's SR vs plain "
            f"fp32: PSNR {', '.join(f'{p:.2f}' for p in per_image)} dB (bound >= "
            f"{PSNR_MIN_DB})")
        if (d_psnr > EVAL_PSNR_DB or d_ssim > EVAL_SSIM or len(per_image) != n
                or min(per_image) < PSNR_MIN_DB):
            raise RuntimeError(f"{tag} {label}: the kernels' evaluation disagrees with the "
                               "plain fp32 path")
    del plain, kernels_model

    # the bicubic baseline on the card against the same on the CPU
    base = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        base[device] = bicubic_baseline(loader(data, EVAL_BATCH), 4, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        base[device]["s"] = time.perf_counter() - t0
    d = abs(base["cuda"]["psnr"] - base["cpu"]["psnr"])
    log(f"[{tag}] bicubic baseline, {EVAL_IMAGES} images: GPU PSNR {base['cuda']['psnr']:.6f} dB "
        f"SSIM {base['cuda']['ssim']:.6f} in {base['cuda']['s']:.3f} s (decode included); CPU "
        f"{base['cpu']['psnr']:.6f} dB SSIM {base['cpu']['ssim']:.6f} in {base['cpu']['s']:.3f} s; "
        f"|GPU - CPU| {d:.2e} dB (bound {EVAL_BASELINE_DB}) ({smi})")
    if d > EVAL_BASELINE_DB or base["cuda"]["n"] != EVAL_IMAGES:
        raise RuntimeError(f"{tag}: the GPU baseline disagrees with the CPU's")
    return launches_total


def _conv_share(fwd, name, tag, smi):
    """K3/K4's device time in one profiled bench forward (kernels named
    conv_nhwc_*), beside the forward's busy device time."""
    from tpu_superresolution_torch.utils.profiling import device_split, kernel_ms

    try:
        kernels = device_split(lambda: _no_grad(fwd)).kernels
    except Exception as e:  # the profile is a reading aid, not a check
        log(f"[{tag}] profiler failed: {type(e).__name__}: {e}")
        return
    conv = [e for e in kernels if "conv_nhwc" in e.name]
    busy, conv_ms = sum(kernel_ms(e) for e in kernels), sum(kernel_ms(e) for e in conv)
    if busy:
        log(f"[{tag}] {name} profiled forward: K3/K4 x{len(conv)} {conv_ms:.3f} ms of "
            f"{busy:.3f} ms busy ({conv_ms / busy:.1%}) ({smi})")


def _psnr_db(a, b) -> float:
    mse = float(((a.float().clamp(0, 1) - b.float().clamp(0, 1)) ** 2).mean())
    return 10 * math.log10(1.0 / max(mse, 1e-20))


def phase_hat(workdir, smi):
    """HAT x4 serving (the serve phase's requests and checks with --model
    hat), the bench workload for HAT with a split of one forward, and a
    hat_fast forward (K1 with `extra`) against its plain fp32 path.
    Returns the launches of the served requests and the hat_fast call."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.core.config import HATConfig, HATFastConfig, build_model
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    service, launches = phase_serve(workdir, HATConfig(), "hat", HAT_PER_CALL, tag="hat")
    fwd = phase_bench(service, smi, name="HAT x4", tag="hat")
    _hat_split(service.model, fwd, smi)
    del service

    # hat_fast (ws 8): one forward of the bench's 25 tiles, K1 with extra
    src = build_model(HATFastConfig())
    src.reset_parameters(torch.Generator().manual_seed(SEED))
    fast = build_model(HATFastConfig(), dtype=torch.bfloat16, device="cuda")
    fast.load_state_dict(src.state_dict())
    ref = build_model(HATFastConfig(), dtype=torch.float32, impl="plain", device="cuda")
    ref.load_state_dict(src.state_dict())
    x = torch.from_numpy(np.random.default_rng(SEED).random((25, 64, 64, 3), np.float32)).cuda()
    with torch.no_grad():
        fast(x)  # warm-up: weight packing, composition
        torch.cuda.synchronize()
        reset_counters()
        y = fast(x)
        torch.cuda.synchronize()
        counts = read_counters()
        ms = cuda_ms(lambda: fast(x), iters=5, warmup=1)
        psnr = _psnr_db(y, ref(x))
    log(f"[hat] hat_fast (ws 8) forward on [25,64,64,3]: launches {counts} (expected "
        f"{HAT_FAST_PER_CALL}); {ms:.2f} ms, {25 * 256 * 256 / 1e6 / ms * 1e3:.3f} MPix/s "
        f"of output; PSNR vs plain fp32 {psnr:.2f} dB (bound >= {PSNR_MIN_DB} dB) ({smi})")
    if counts != HAT_FAST_PER_CALL:
        raise RuntimeError(f"hat_fast launches {counts}, expected {HAT_FAST_PER_CALL}")
    if psnr < PSNR_MIN_DB or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"hat_fast output PSNR {psnr:.2f} dB < {PSNR_MIN_DB} dB")
    return {k: launches[k] + counts[k] for k in launches}


def _perturb_dat(model, gen):
    """Non-trivial BatchNorm statistics and affines and channel-attention
    temperatures, so that the folding into the kernels' weights and the
    temperature are exercised (reference_init leaves them 0 / 1)."""
    import torch

    rnd = lambda t, scale: scale * torch.randn(t.shape, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(rnd(m.running_mean, 0.3))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=gen))
                m.weight.copy_(1 + rnd(m.weight, 0.2))
                m.bias.copy_(rnd(m.bias, 0.2))
            elif isinstance(getattr(m, "temperature", None), torch.nn.Parameter):
                m.temperature.copy_(1 + rnd(m.temperature, 0.3))


def phase_dat(workdir, smi):
    """DAT x4 serving (DATConfig(): embed 180, depths 6x6, heads 6, split
    (8, 16); seeded random weights with perturbed BatchNorm statistics,
    exported to a .pth) behind SRService with --model dat: the serve
    phase's three requests and checks (launches per call exactly
    DAT_PER_CALL, the tiled output >= 50 dB against the plain fp32 path),
    the bench workload in MPix/s for the kernels and the plain path, and
    a profiled forward split by kernel and plain op.  Returns the
    launches of the served requests."""
    from tpu_superresolution_torch.core.config import DATConfig

    service, launches = phase_serve(workdir, DATConfig(), "dat", DAT_PER_CALL, tag="dat",
                                    prepare=_perturb_dat)
    fwd = phase_bench(service, smi, name="DAT x4", tag="dat")
    _dat_split(fwd, smi)
    return launches


def phase_dat_x4(workdir, smi):
    """The published DAT x4 (DAT's options/Test/test_DAT_x4.yml: split
    (8, 32), expansion 4; seeded random weights with perturbed BatchNorm
    statistics): K9 takes its spatial fronts at N 256, K14 its channel
    fronts, K10 every tail (SGFN half 360).  (1) Its .pth
    behind SRService with --model dat: the weights carry no split, so it
    loads at (8, 16) with expansion 4 (K9 and K14 fronts, K10 tails;
    launches per call DAT_X4_SERVE_PER_CALL), the serve phase's requests
    and checks.  (2) The model at split (8, 32) on the bench workload
    (256^2 LR, tile 64 / overlap 8, 25 tiles, bf16): launches per call
    exactly DAT_X4_PER_CALL, the output >= 50 dB against the plain fp32
    path, MPix/s for the kernels and the plain bf16 path, a profiled
    split.  Returns the launches of both."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.core.config import DATConfig, build_model
    from tpu_superresolution_torch.evaluate.tiling import tiled_forward
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    service, served = phase_serve(workdir, DATConfig(expansion_factor=4.0), "dat",
                                  DAT_X4_SERVE_PER_CALL, tag="dat_x4", prepare=_perturb_dat)
    routes = service.model.routes()[0][:2]
    log(f"[dat_x4] served .pth config: split {service.mcfg.split_size}, expansion "
        f"{service.mcfg.expansion_factor}; block routes {routes}")
    del service

    cfg = DATConfig(split_size=(8, 32), expansion_factor=4.0)
    src = build_model(cfg)
    src.reset_parameters(torch.Generator().manual_seed(SEED))
    _perturb_dat(src, torch.Generator().manual_seed(SEED + 5))
    models = {}
    for label, dtype, impl in (("kernels", torch.bfloat16, "auto"),
                               ("plain", torch.bfloat16, "plain"),
                               ("plain fp32", torch.float32, "plain")):
        models[label] = build_model(cfg, dtype=dtype, impl=impl, device="cuda")
        models[label].load_state_dict(src.state_dict())
    routes = models["kernels"].routes()[0][:2]
    if routes != [("K9", "K10"), ("K14", "K10")]:
        raise RuntimeError(f"dat_x4 routes {routes}")
    x = torch.from_numpy(np.random.default_rng(SEED).random((1, 256, 256, 3), np.float32)).cuda()
    fwd = lambda label: tiled_forward(models[label], x, 4, 64, 8)
    with torch.no_grad():
        fwd("kernels")  # warm-up: weight packing, composition, masks
        torch.cuda.synchronize()
        reset_counters()
        y = fwd("kernels")
        torch.cuda.synchronize()
        counts = read_counters()
        psnr = _psnr_db(y, fwd("plain fp32"))
        ok = bool(torch.isfinite(y).all()) and tuple(y.shape) == (1, 1024, 1024, 3)
        log(f"[dat_x4] split (8, 32), expansion 4, bench workload: launches per call {counts} "
            f"(expected {DAT_X4_PER_CALL}); block routes {routes}; PSNR vs plain fp32 "
            f"{psnr:.2f} dB (bound >= {PSNR_MIN_DB} dB) ({smi})")
        if counts != DAT_X4_PER_CALL:
            raise RuntimeError(f"dat_x4 launches {counts}, expected {DAT_X4_PER_CALL}")
        if psnr < PSNR_MIN_DB or not ok:
            raise RuntimeError(f"dat_x4 output PSNR {psnr:.2f} dB < {PSNR_MIN_DB} dB")
        del models["plain fp32"]
        for label in ("kernels", "plain"):
            fwd(label)
            torch.cuda.synchronize()
            n_iter = 5
            t0 = time.perf_counter()
            for _ in range(n_iter):
                fwd(label)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / n_iter
            log(f"[dat_x4] published DAT x4, 256^2 LR, tile 64/8, 25 tiles in one batch, bf16, "
                f"{label}: {dt * 1e3:.2f} ms/image, {1024 * 1024 / 1e6 / dt:.3f} MPix/s ({smi})")
    _dat_split(lambda: fwd("kernels"), smi, tag="dat_x4")
    return {k: served[k] + counts[k] for k in counts}


def _dat_split(fwd, smi, tag="dat"):
    """Where one DAT bench forward spends its device time, under
    torch.profiler: K9 (the front product in its K9 mode, the stream
    attention, the conv), K14 (the front product in its K14 mode, the
    softmax, the conv + apply), K10, K16, K11, K2, K3/K4 by
    kernel name, the rest (the module chain's GEMMs, BatchNorm, GELU,
    partitions and pads, channel gates, conv_first, pixel shuffle,
    tiling, casts) as plain ops, and the device's idle share of the wall
    time."""
    from tpu_superresolution_torch.utils.profiling import device_split

    try:
        split = device_split(lambda: _no_grad(fwd), host=True)
    except Exception as e:  # the profile is a reading aid, not a check
        log(f"[{tag}] profiler failed: {type(e).__name__}: {e}")
        return
    kernels, wall = split.kernels, split.wall_ms
    if not kernels:
        log(f"[{tag}] profiler: no device events recorded")
        return
    names = (("K9 front_product_kernel<0> (LN1, qkv)", ("front_product_kernel<0",)),
             ("K9 window_attn_stream_kernel (both branches)", ("window_attn_stream_kernel",)),
             ("K9 dat_conv_kernel<false> (conv branch)", ("dat_conv_kernel<false",)),
             ("K14 front_product_kernel<1> (LN1, qkv, gram partials)",
              ("front_product_kernel<1",)),
             ("K14 chan_softmax_kernel", ("chan_softmax_kernel",)),
             ("K14 dat_conv_kernel<true> (conv branch, v A^T)", ("dat_conv_kernel<true",)),
             ("K10 datb_tail_wg_kernel", ("datb_tail",)),
             ("K16 batched_attn_wg_kernel", ("batched_attn_wg_kernel",)),
             ("K11 dwconv3x3_rows_kernel / dwconv3x3_kernel", ("dwconv3x3_rows_kernel",
                                                                 "dwconv3x3_kernel")),
             ("K2 layernorm", ("layernorm_bands", "layernorm_wide")),
             ("K3/K4 conv_nhwc", ("conv_nhwc",)))
    other = ("plain ops (module-chain GEMMs, BatchNorm, GELU, partitions, channel gates, "
             "conv_first, pixel shuffle, tiling, casts)")
    groups = split.group(names, other)
    busy = sum(groups.values())
    idle = max(wall - busy, 0.0)
    log(f"[{tag}] profiled forward: {wall:.2f} ms wall (profiler on), {len(kernels)} device "
        f"kernels, busy {busy:.2f} ms, idle {idle:.2f} ms ({idle / wall:.1%}) ({smi})")
    for g, t in groups.items():
        log(f"[{tag}]   {t:8.3f} ms  {t / wall:6.1%}  {g}")


def phase_swinir_ws7(smi):
    """SwinIR-M x4 at window_size 7 (a checkpoint the JAX package serves
    and the port used to refuse on CUDA): one bf16 forward of 25 tiles of
    64^2 (reflect-padded to 70^2), its launches, and its output against
    the plain fp32 path."""
    import dataclasses

    import numpy as np
    import torch

    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    cfg = dataclasses.replace(SwinIRConfig(scale=4), window_size=7)
    src = build_model(cfg)
    src.reset_parameters(torch.Generator().manual_seed(SEED))
    model = build_model(cfg, dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(src.state_dict())
    ref = build_model(cfg, dtype=torch.float32, impl="plain", device="cuda")
    ref.load_state_dict(src.state_dict())
    x = torch.from_numpy(np.random.default_rng(SEED).random((25, 64, 64, 3), np.float32)).cuda()
    with torch.no_grad():
        reset_counters()
        y = model(x)
        torch.cuda.synchronize()
        counts = read_counters()
        psnr = _psnr_db(y, ref(x))
    log(f"[swinir-ws7] SwinIR-M x4 at window 7, [25,64,64,3] bf16: launches {counts} "
        f"(expected {SWINIR_WS7_PER_CALL}); PSNR vs plain fp32 {psnr:.2f} dB "
        f"(bound >= {PSNR_MIN_DB} dB) ({smi})")
    if counts != SWINIR_WS7_PER_CALL:
        raise RuntimeError(f"SwinIR ws 7 launches {counts}, expected {SWINIR_WS7_PER_CALL}")
    if psnr < PSNR_MIN_DB or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"SwinIR ws 7 output PSNR {psnr:.2f} dB < {PSNR_MIN_DB} dB")
    return counts


def _k1t_route_ab(model, fn, tag, smi, iters=5):
    """One end-to-end forward `fn` with the model's K1t on each kernel:
    the Swin blocks' tail operands packed for the wgmma kernel
    (``tail_route``'s choice) and for the WMMA kernel, each timed (CUDA
    events, median of `iters` after a warm-up that packs) in the order
    wgmma, WMMA, WMMA, wgmma; the route is restored afterwards."""
    import functools

    import torch

    from tpu_superresolution_torch.models import swinir

    caches = [m._packed for m in model.modules() if isinstance(m, swinir.SwinBlock)]
    real = swinir.pack_block_tail

    def use(route):
        swinir.pack_block_tail = (real if route == "wgmma"
                                  else functools.partial(real, route="wmma"))
        for cache in caches:
            cache._key = None  # repack on the next call

    times = {"wgmma": [], "wmma": []}
    try:
        with torch.no_grad():
            for route in ("wgmma", "wmma", "wmma", "wgmma"):
                use(route)
                times[route].append(cuda_ms(fn, iters=iters, warmup=1))
    finally:
        use("wgmma")
    mean = {r: sum(v) / len(v) for r, v in times.items()}
    log(f"[{tag}] K1t end to end, one call: the wgmma tail kernel {mean['wgmma']:.2f} ms "
        f"({' / '.join(f'{t:.2f}' for t in times['wgmma'])}), the WMMA kernel "
        f"{mean['wmma']:.2f} ms ({' / '.join(f'{t:.2f}' for t in times['wmma'])}): "
        f"{mean['wmma'] - mean['wgmma']:.2f} ms less a call ({smi})")


def swinir_l_config():
    """SwinIR-L, the published real-world x4 model (JingyunLiang/SwinIR
    ``003_realSR_BSRGAN_DFOWMFC_s64w8_SwinIR-L_x4_GAN``): embed 240, depths
    9x6, 8 heads, ws 8, mlp 2, 3conv, nearest+conv."""
    from tpu_superresolution_torch.core.config import SwinIRConfig

    return SwinIRConfig(scale=4, embed_dim=240, depths=(6,) * 9, num_heads=(8,) * 9,
                        window_size=8, mlp_ratio=2.0, resi_connection="3conv",
                        upsampler="nearest+conv", num_feat=64)


def phase_swinir_l(smi):
    """One forward at SwinIR-L's widths (the real-world x4 model: embed
    240, 8 heads, ws 8, depths 9x6, 3conv, nearest+conv; seeded random
    weights) on 4 tiles of 64^2 in bf16: every block takes the K7 route
    (C 240 is past the block kernel's 192); its launches, its output
    against the plain fp32 path, and its time on the bench batch (25
    tiles) with K1t on each tail kernel."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    cfg = swinir_l_config()
    src = build_model(cfg)
    src.reset_parameters(torch.Generator().manual_seed(SEED))
    model = build_model(cfg, dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(src.state_dict())
    ref = build_model(cfg, dtype=torch.float32, impl="plain", device="cuda")
    ref.load_state_dict(src.state_dict())
    x = torch.from_numpy(np.random.default_rng(SEED).random((4, 64, 64, 3), np.float32)).cuda()
    with torch.no_grad():
        model(x)  # warm-up: K7 weight packing
        torch.cuda.synchronize()
        reset_counters()
        y = model(x)
        torch.cuda.synchronize()
        counts = read_counters()
        ms = cuda_ms(lambda: model(x), iters=5, warmup=1)
        psnr = _psnr_db(y, ref(x))
    # the K1t A/B on the bench batch (25 tiles): at 4 tiles the host's
    # launches hold the forward
    xb = torch.from_numpy(np.random.default_rng(SEED + 1).random((25, 64, 64, 3),
                                                                 np.float32)).cuda()
    _k1t_route_ab(model, lambda: model(xb), "swinir-l", smi)
    log(f"[swinir-l] SwinIR-L widths (embed 240, 8 heads, ws 8, depths 9x6, 3conv, "
        f"nearest+conv), [4,64,64,3] bf16: launches {counts} (expected {SWINIR_L_PER_CALL}); "
        f"{ms:.2f} ms; PSNR vs plain fp32 {psnr:.2f} dB (bound >= {PSNR_MIN_DB} dB) ({smi})")
    if counts != SWINIR_L_PER_CALL:
        raise RuntimeError(f"SwinIR-L launches {counts}, expected {SWINIR_L_PER_CALL}")
    if psnr < PSNR_MIN_DB or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"SwinIR-L output PSNR {psnr:.2f} dB < {PSNR_MIN_DB} dB")
    return counts


# Blocks past the block kernel's widths (once the "wide" route; now the K7
# route, fused_block.block_route): K2 for LN1, K7 (any width, head dim
# and window) and K1t; a HAT CAB past K12's widths runs K2 + K3 (the GELU
# in its epilogue) + K3 (cab_conv.cab_route).  Per model call at depth
# (2,): SwinIR: K2 for patch_norm, norm and each block's LN1 (4); K7 and
# K1t 1 per block; K3 for the RSTB conv, conv_after_body and
# conv_before_upsample; K4 for the composed reconstruction.  HAT (ws 7,
# one RHAG of 2 HABs and the OCAB): K2 2 + 2 per HAB (the CAB's LN, LN1)
# + 2 for the OCAB's norms; K7 and K1t 1 per HAB; K3 2 per CAB + 3; K15
# for the OCAB (whose qkv and proj the JAX package leaves to XLA too).
WIDE_SWINIR_PER_CALL = dict(PER_CALL, K1=0, K1t=2, K2=4, K3=3, K4=1, K7=2)
WIDE_HAT_PER_CALL = dict(PER_CALL, K1=0, K1t=2, K2=8, K3=7, K4=1, K7=2, K15=1)


def phase_wide(smi):
    """The widths past the block kernel's on the card (once the "wide"
    route, now the K7 route), each at depth (2,) on 4 tiles of 64^2 in
    bf16 (seeded random weights): a SwinIR at C 264 in 6 heads (hd 44, ws
    8), a SwinIR at C 180 in 4 heads (hd 45: odd), a HAT at embed 264 (6
    heads, ws 7: its CABs past K12's C 256 take K2 + K3 with the GELU +
    K3, its OCAB K15 at hd 44; conv_scale 0.3 so that the CAB branch
    moves the output), and the widths ROADMAP Queue 3 item 1 repaired: a
    SwinIR at C 576 in 8 heads (hd 72; K1t's 32-row blocks) and one at C
    192 in 2 heads (hd 96); launches per call, and the output >= 50 dB
    against the plain fp32 path."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.core.config import HATConfig, SwinIRConfig, build_model
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels.cab_conv import cab_route
    from tpu_superresolution_torch.kernels.fused_block import block_route

    x = torch.from_numpy(np.random.default_rng(SEED).random((4, 64, 64, 3), np.float32)).cuda()
    total = {}
    for label, cfg, want in (
            ("SwinIR C 264, 6 heads, ws 8", SwinIRConfig(scale=4, embed_dim=264, depths=(2,),
                                                         num_heads=(6,), window_size=8),
             WIDE_SWINIR_PER_CALL),
            ("SwinIR C 180, 4 heads (hd 45), ws 8",
             SwinIRConfig(scale=4, embed_dim=180, depths=(2,), num_heads=(4,), window_size=8),
             WIDE_SWINIR_PER_CALL),
            ("HAT embed 264, 6 heads, ws 7", HATConfig(scale=4, embed_dim=264, depths=(2,),
                                                       num_heads=(6,), conv_scale=0.3),
             WIDE_HAT_PER_CALL),
            ("SwinIR C 576, 8 heads (hd 72), ws 8",
             SwinIRConfig(scale=4, embed_dim=576, depths=(2,), num_heads=(8,), window_size=8),
             WIDE_SWINIR_PER_CALL),
            ("SwinIR C 192, 2 heads (hd 96), ws 8",
             SwinIRConfig(scale=4, embed_dim=192, depths=(2,), num_heads=(2,), window_size=8),
             WIDE_SWINIR_PER_CALL)):
        c, nh = cfg.embed_dim, cfg.num_heads[0]
        route = block_route(cfg.window_size, c, nh, int(c * cfg.mlp_ratio))
        src = build_model(cfg)
        src.reset_parameters(torch.Generator().manual_seed(SEED))
        model = build_model(cfg, dtype=torch.bfloat16, device="cuda")
        model.load_state_dict(src.state_dict())
        ref = build_model(cfg, dtype=torch.float32, impl="plain", device="cuda")
        ref.load_state_dict(src.state_dict())
        with torch.no_grad():
            model(x)  # warm-up: the derived weights
            torch.cuda.synchronize()
            reset_counters()
            y = model(x)
            torch.cuda.synchronize()
            counts = read_counters()
            ms = cuda_ms(lambda: model(x), iters=5, warmup=1)
            psnr = _psnr_db(y, ref(x))
        cab = (f", CAB route {cab_route(c, c // cfg.compress_ratio)}"
               if cfg.name.startswith("hat") else "")
        log(f"[wide] {label}: block route {route}{cab}; launches {counts} (expected {want}); "
            f"{ms:.2f} ms; PSNR vs plain fp32 {psnr:.2f} dB (bound >= {PSNR_MIN_DB} dB) ({smi})")
        if route != "window_attention":
            raise RuntimeError(f"wide {label}: block route {route}")
        if counts != want:
            raise RuntimeError(f"wide {label}: launches {counts}, expected {want}")
        if psnr < PSNR_MIN_DB or not bool(torch.isfinite(y).all()):
            raise RuntimeError(f"wide {label}: output PSNR {psnr:.2f} dB < {PSNR_MIN_DB} dB")
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n
        del model, ref, src
    return total


def hat_srx4_config():
    """HAT-SRx4 as upstream publishes it (XPixelGroup/HAT,
    options/test/HAT_SRx4_ImageNet-pretrain.yml): window 16, embed 180,
    depths 6x6, heads 6x6, mlp_ratio 2, compress 3, squeeze 30,
    conv_scale 0.01, overlap 0.5, pixelshuffle with num_feat 64, 1conv,
    img_range 1."""
    from tpu_superresolution_torch.core.config import HATConfig

    return HATConfig(scale=4, window_size=16, embed_dim=180, depths=(6,) * 6,
                     num_heads=(6,) * 6, mlp_ratio=2.0, compress_ratio=3, squeeze_factor=30,
                     conv_scale=0.01, overlap_ratio=0.5, num_feat=64, img_range=1.0,
                     resi_connection="1conv", upsampler="pixelshuffle")


def phase_hat_srx4(workdir, smi):
    """HAT-SRx4 serving (``hat_srx4_config()``, seeded random weights,
    exported to a .pth) behind SRService with --model hat: the serve
    phase's three requests and checks (launches per call exactly
    HAT_SRX4_PER_CALL, the tiled output >= 50 dB against the plain fp32
    path), the bench workload in MPix/s for the kernels and the plain
    path, the bench forward with K1t on each tail kernel, and a profiled
    forward split by part.  Returns the launches of the served requests."""
    service, launches = phase_serve(workdir, hat_srx4_config(), "hat", HAT_SRX4_PER_CALL,
                                    tag="hat_srx4")
    fwd = phase_bench(service, smi, name="HAT-SRx4", tag="hat_srx4")
    _k1t_route_ab(service.model, fwd, "hat_srx4", smi)
    _hat_split(service.model, fwd, smi, tag="hat_srx4")
    return launches


def _hat_split(model, fwd, smi, tag="hat"):
    """Where one HAT bench forward spends its device time, under
    torch.profiler: the block kernel (K6 or K1), K7, K1t, K12, K15 (the
    OCABs' attention), K2, K3/K4 by kernel name, the other kernels by the
    module whose profiler range launched them (the CAB's SE gate, the
    OCABs' remaining plain ops: the qkv, proj and MLP products, the
    partition and overlap gathers; the HABs' plain ops on the K7 route:
    the shift and partition gathers; the rest), and the device's idle
    share of the wall time."""
    from tpu_superresolution_torch.models.hat import CAB, HAB, OCAB
    from tpu_superresolution_torch.utils.profiling import device_split

    parts = {HAB: "hat::hab", CAB: "hat::cab", OCAB: "hat::ocab"}
    handles = _range_hooks(model, parts)
    try:
        split = device_split(lambda: _no_grad(fwd), host=True)
    except Exception as e:  # the profile is a reading aid, not a check
        log(f"[{tag}] profiler failed: {type(e).__name__}: {e}")
        return
    finally:
        for h in handles:
            h.remove()
    kernels, wall = split.kernels, split.wall_ms
    if not kernels:
        log(f"[{tag}] profiler: no device events recorded")
        return
    # the device-side spans of the module ranges
    spans = split.ranges(list(parts.values()))
    names = (("block kernel (swin_block_wg_kernel)", ("swin_block_wg_kernel",)),
             ("K7 window_product_kernel (qkv, proj)", ("window_product_kernel",)),
             ("K7 window_attn_stream_kernel", ("window_attn_stream_kernel",)),
             ("K1t swin_tail_wg_kernel / swin_tail_kernel",
              ("swin_tail_wg_kernel", "swin_tail_kernel")),
             ("K12 cab_wgmma_kernel", ("cab_wgmma_kernel",)),
             ("K15 window_attn_wg_kernel / batched_attn_kernel (OCAB attention)",
              ("window_attn_wg_kernel", "batched_attn_kernel")),
             ("K8w16 ocab_heads_kernel + ocab_attn_kernel + K5a's OCAB tail (OCAB core)",
              ("ocab_heads_kernel", "ocab_attn_kernel", "swin_block_bwd_kernel")),
             ("K2 layernorm", ("layernorm_bands", "layernorm_wide")),
             ("K3/K4 conv_nhwc", ("conv_nhwc",)))
    by_span = (("hat::cab", "CAB SE gate (plain ops)"),
               ("hat::ocab", "OCAB plain ops (qkv, proj, MLP, gathers)"),
               ("hat::hab", "HAB plain ops (K7 route: the shift and partition gathers)"))
    other = "other (conv_first, mean shift, tiling, casts)"
    groups = split.group(names, other, spans, by_span)
    busy = sum(groups.values())
    idle = max(wall - busy, 0.0)
    log(f"[{tag}] profiled forward: {wall:.2f} ms wall (profiler on), {len(kernels)} device "
        f"kernels, busy {busy:.2f} ms, idle {idle:.2f} ms ({idle / wall:.1%}); "
        f"{len(spans)} module ranges seen on the device ({smi})")
    for g, t in groups.items():
        log(f"[{tag}]   {t:8.3f} ms  {t / wall:6.1%}  {g}")


def _write_deeprock(root, n_train, n_valid, hr_size, scale, seed, n_test=0):
    """A synthetic DeepRockSR-2D-layout set: smooth grayscale HR images
    (bicubic-upsampled noise) and their bicubic LR, named <stem>x<s>
    (a split of no images is not written)."""
    from pathlib import Path

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("valid", n_valid), ("test", n_test)):
        if not n:
            continue
        hr_dir = Path(root) / "shuffled2D" / f"shuffled2D_{split}_HR"
        lr_dir = Path(root) / "shuffled2D" / f"shuffled2D_{split}_LR_default_X{scale}"
        hr_dir.mkdir(parents=True)
        lr_dir.mkdir(parents=True)
        for i in range(n):
            small = (rng.random((hr_size // 8, hr_size // 8)) * 255).astype(np.uint8)
            img = Image.fromarray(small, mode="L").resize((hr_size, hr_size), Image.BICUBIC)
            img.save(hr_dir / f"{split}_{i:04d}.png")
            img.resize((hr_size // scale,) * 2, Image.BICUBIC).save(
                lr_dir / f"{split}_{i:04d}x{scale}.png")


def _train_state(model, steps_per_epoch):
    from tpu_superresolution_torch.core.config import TrainConfig
    from tpu_superresolution_torch.train.engine import build_optimizer, create_train_state

    tcfg = TrainConfig(epochs=10, loss="l1", lr=2e-5, scheduler="cosine", min_lr=2e-6,
                       finetune=True)
    opt, sched = build_optimizer(tcfg, steps_per_epoch, model)
    return create_train_state(model, opt, sched, tcfg.grad_clip_norm)


def _first_step_grads(model, lr, hr):
    """Loss, {name: grad} and {name: batch statistic} (DAT's BatchNorm
    batch means and variances) of one train-mode forward / backward, the
    stochastic-depth masks drawn from a generator of seed SEED."""
    import torch

    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0  # the running buffers then hold the batch statistics
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(lr, generator=torch.Generator().manual_seed(SEED)).float()
    loss = (out - hr).abs().mean()
    loss.backward()
    grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
    stats = {n: b.detach().float().clone() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, stats


def _cosines(g_a, g_b):
    """{name: cosine} of two gradient dicts (pairs that are both exactly
    zero, such as a branch dropped for every sample, are left out)."""
    cos = {}
    for name, gb in g_b.items():
        ga = g_a[name]
        na, nb = float(ga.norm()), float(gb.norm())
        if not (math.isfinite(na) and math.isfinite(nb)):
            raise RuntimeError(f"non-finite gradient of {name}")
        if na == 0.0 and nb == 0.0:
            continue
        cos[name] = float((ga * gb).sum()) / max(na * nb, 1e-30)
    return cos


def phase_train(workdir, smi):
    """SwinIR-M x4 fine-tuning: the finetune CLI for one epoch on the
    card, then per-step launch counts and times (kernels vs plain bf16)
    and the first step's gradients against the plain fp32 path."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.cli.finetune import main as finetune_main
    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.train.engine import make_train_step

    batch, patch, scale = TRAIN_BATCH, TRAIN_LR_PATCH, 4
    n_train, n_valid = 8 * batch, 2
    data = f"{workdir}/deeprock"
    _write_deeprock(data, n_train, n_valid, hr_size=320, scale=scale, seed=SEED)
    cfg = SwinIRConfig(scale=scale)  # SwinIR-M x4, drop_path_rate 0.1
    src = build_model(cfg)
    src.reset_parameters(torch.Generator().manual_seed(SEED))
    weights = f"{workdir}/swinir_m_x4_random.pth"
    torch.save({"params": src.state_dict()}, weights)

    # 1. the entry point: one epoch of 8 steps + validation of 2 images
    reset_counters()
    t0 = time.perf_counter()
    trainer, state = finetune_main([
        "--data_root", data, "--scale", "X4", "--weights", weights, "--epochs", "1",
        "--batch_size", str(batch), "--lr_patch", str(patch), "--workdir", f"{workdir}/run",
        "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counters()
    steps, val_calls = n_train // batch, 1
    expect = {k: steps * TRAIN_PER_STEP[k] + val_calls * PER_CALL.get(k, 0)
              for k in TRAIN_PER_STEP}
    log(f"[train] finetune CLI, SwinIR-M x4 (fused_reconstruct="
        f"{trainer.model_config.fused_reconstruct}, drop_path_rate "
        f"{trainer.model_config.drop_path_rate}), batch {batch}, lr_patch {patch}: {steps} "
        f"steps + validation in {cli_s:.1f} s (incl. weight load and the first steps' "
        f"set-up); train loss {trainer.history['train'][0]:.6f}, val PSNR "
        f"{trainer.best_val_psnr:.2f} dB; launches {launches} (expected {expect}) ({smi})")
    if state.step != steps or not math.isfinite(trainer.history["train"][0]):
        raise RuntimeError(f"finetune: {state.step} steps, loss {trainer.history['train']}")
    if launches != expect:
        raise RuntimeError(f"finetune launches {launches}, expected {expect}")

    # 2. one step's launches, and step times: kernels vs the plain bf16 path
    rng = np.random.default_rng(SEED)
    lr = torch.from_numpy(rng.random((batch, patch, patch, 3), dtype=np.float32)).cuda()
    hr = torch.from_numpy(
        rng.random((batch, patch * scale, patch * scale, 3), dtype=np.float32)).cuda()
    step = make_train_step("l1", "native_lr", scale, patch, False)
    times = {}
    for label, impl in (("kernels", "auto"), ("plain", "plain")):
        model = build_model(cfg, dtype=torch.bfloat16, impl=impl, device="cuda")
        model.load_state_dict(src.state_dict())
        st = _train_state(model, steps)
        gen = torch.Generator().manual_seed(SEED)
        warm, timed = (3, TRAIN_TIMED_STEPS) if label == "kernels" else (1, DAT_TIMED_STEPS)
        for _ in range(warm):
            step(st, lr, hr, gen)
        torch.cuda.synchronize()
        reset_counters()
        step(st, lr, hr, gen)
        torch.cuda.synchronize()
        per_step = read_counters()
        dts = []
        for _ in range(timed):
            t0 = time.perf_counter()
            m = step(st, lr, hr, gen)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        ms = statistics.median(dts) * 1e3
        times[label] = ms
        log(f"[train] {label} bf16 path: launches per step {per_step}; median "
            f"{ms:.2f} ms/step over {timed} steps after {warm + 1} warm-up "
            f"(min {min(dts) * 1e3:.2f}, max {max(dts) * 1e3:.2f}), "
            f"{batch / ms * 1e3:.1f} images/s; loss {float(m['loss']):.6f} ({smi})")
        if label == "kernels":
            if per_step != TRAIN_PER_STEP:
                raise RuntimeError(f"launches per train step {per_step}, expected "
                                   f"{TRAIN_PER_STEP}")
            _profile_step(step, st, lr, hr, gen)
            _packing_cost(model)
        elif any(per_step.values()):
            raise RuntimeError(f"the plain path launched kernels: {per_step}")
        del model, st

    # 3. the first step's gradients: kernels (bf16) vs the plain fp32 path
    _first_step_gate(cfg, src, lr, hr, "train", smi)
    return launches, times


def _misrounded_bf16(ref, frac, gen):
    """fp32 `ref` rounded to bf16, with a share `frac` of its elements
    (picked by `gen`) rounded to the other bf16 neighbour: 1-ulp
    mis-roundings at random places, as a correct kernel that rounds
    otherwise than the plain version gives."""
    import torch

    near = ref.to(torch.bfloat16)
    r = near.float()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
    other = (r + torch.sign(ref - r) * ulp).to(torch.bfloat16)
    pick = torch.rand(ref.shape, generator=gen, device=ref.device) < frac
    return torch.where(pick & (ref != r), other, near)


def _k16_misrounded(frac, seed):
    """A stand-in for K16's launch (``window_attention._launch``): its
    plain version, rounded to bf16 with mis-roundings at `frac`."""
    import torch

    from tpu_superresolution_torch.kernels import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def k16(q, k, v, bias, mask, scale, counter, split_p, route=None):
        ref = wa.fused_window_attention_plain(q.float(), k.float(), v.float(), bias, mask, scale)
        return _misrounded_bf16(ref, frac, gen)
    return k16


K16_FAULTS = ("mask windows", "head order", "row offset", "softmax scale", "head bias")


def _k16_wrong(kind):
    """K16's launch with a fault a kernel could have: "mask windows"
    gives window w the shift mask of window w + 1 (the mask applied to
    the wrong windows), "head order" stores each head's output in the
    next head's place, "row offset" each query row's output in the next
    row's, "softmax scale" applies the 1 / sqrt(hd) scale a second time
    (DAT's q comes scaled), "head bias" drops head 0's rect bias."""
    from tpu_superresolution_torch.kernels import window_attention as wa

    launch = wa._launch

    def k16(q, k, v, bias, mask, scale, counter, split_p, route=None):
        if kind == "head bias":
            bias = bias.clone()
            bias[0] = 0.0
        elif kind == "mask windows" and mask is not None:
            mask = mask.roll(-1, 0).contiguous()
        elif kind == "softmax scale":
            scale = scale * q.shape[-1] ** -0.5
        out = launch(q, k, v, bias, mask, scale, counter, split_p, route)
        if kind in ("head order", "row offset"):
            out = out.roll(1, 1 if kind == "head order" else 2).contiguous()
        return out
    return k16


@contextlib.contextmanager
def _k16_replaced(k16=None, plain_k16=None):
    """K16's launch replaced by `k16` on the kernels path, and the plain
    path's K16 (``models.dat.batched_window_attention_plain``) by
    `plain_k16`, for the duration."""
    from tpu_superresolution_torch.kernels import window_attention as wa
    from tpu_superresolution_torch.models import dat as dm

    launch, plain = wa._launch, dm.batched_window_attention_plain
    wa._launch, dm.batched_window_attention_plain = k16 or launch, plain_k16 or plain
    try:
        yield
    finally:
        wa._launch, dm.batched_window_attention_plain = launch, plain


def _plain_k16_misrounded(frac, seed):
    """The plain path's K16 with its output mis-rounded as
    ``_k16_misrounded`` does (forward only: the backward stays autograd
    of the plain version, as under the kernel)."""
    import torch

    from tpu_superresolution_torch.kernels import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def plain_k16(q, k, v, bias, mask=None, scale=1.0):
        out = wa.fused_window_attention_plain(q, k, v, bias, mask, scale)
        with torch.no_grad():
            ref = wa.fused_window_attention_plain(q.float(), k.float(), v.float(), bias, mask,
                                                  scale)
            mis = _misrounded_bf16(ref, frac, gen)
        return out + (mis - out).detach()
    return plain_k16


def _first_step_gate(cfg, src, lr, hr, tag, smi, bf16_floor=False, controls=()):
    """The first train step's gradients, kernels (bf16) against the plain
    fp32 path from the same weights, batch and stochastic-depth masks:
    loss, grad norm and every parameter's gradient cosine within the
    gates.  The plain bf16 path (the same roundings, no kernels) runs
    beside: a parameter whose plain bf16 gradient is itself below the
    cosine bound is bf16-limited, and passes only if its fp32 and kernel
    gradients are below ADAMW_EPS element by element (see there).  With
    `bf16_floor` (DAT, see BF16_FLOOR) a parameter below the cosine bound
    passes if those gradients are below ADAMW_EPS, or if the kernels'
    gradient is no farther from fp32 (relative L2) than GATE_MARGIN times
    the plain bf16 path's spread: the largest such error among the plain
    bf16 path and GATE_CAL_SEEDS runs of it with K16's output mis-rounded
    at GATE_CAL_FRAC.  Each exception is logged by name.  `controls`
    (label, K16 launch, expected verdict or None) then run the kernels
    path with K16 replaced, each held to the same gate; a control whose
    verdict is not the expected one fails the check.  Returns {name:
    cosine}."""
    import torch

    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.train.engine import global_norm

    def first_step(dtype, impl):
        model = build_model(cfg, dtype=dtype, impl=impl, device="cuda")
        model.load_state_dict(src.state_dict())
        out = _first_step_grads(model, lr, hr)
        del model
        return out

    t0 = time.perf_counter()
    loss_k, g_k, s_k = first_step(torch.bfloat16, "auto")
    loss_r, g_r, s_r = first_step(torch.float32, "plain")
    g_p = first_step(torch.bfloat16, "plain")[1]
    t_base = time.perf_counter() - t0
    gn_r = float(global_norm(list(g_r.values())))
    cos_plain = _cosines(g_p, g_r)
    amax = lambda g, k: float(g[k].abs().max())
    err = lambda g, k: float((g[k] - g_r[k]).norm()) / max(float(g_r[k].norm()), 1e-30)
    ceiling, spread = {}, {}
    if bf16_floor:
        t0 = time.perf_counter()
        spread = {k: err(g_p, k) for k in g_r}
        for seed in GATE_CAL_SEEDS:
            with _k16_replaced(plain_k16=_plain_k16_misrounded(GATE_CAL_FRAC, seed)):
                g_c = first_step(torch.bfloat16, "plain")[1]
            spread = {k: max(v, err(g_c, k)) for k, v in spread.items()}
        ceiling = {k: GATE_MARGIN * v for k, v in spread.items()}
        log(f"[{tag}] gate calibration: the plain bf16 path and {len(GATE_CAL_SEEDS)} runs of "
            f"it with K16 mis-rounded at {GATE_CAL_FRAC:g} (seeds {list(GATE_CAL_SEEDS)}) in "
            f"{time.perf_counter() - t0:.1f} s (the three base runs {t_base:.1f} s); each "
            f"parameter's ceiling = {GATE_MARGIN} x its largest relative L2 error vs fp32")

    def verdict(loss_x, g_x):
        cos = _cosines(g_x, g_r)
        tiny = lambda k: max(amax(g_x, k), amax(g_r, k)) < ADAMW_EPS
        below = [k for k in cos if cos[k] < TRAIN_COS_MIN]
        if bf16_floor:
            limited = [k for k in below if tiny(k) or err(g_x, k) <= ceiling[k]]
        else:
            limited = [k for k in below if cos_plain.get(k, 1.0) < TRAIN_COS_MIN]
        gated = {k: v for k, v in cos.items() if k not in limited}
        gn_x = float(global_norm(list(g_x.values())))
        rel_loss, rel_gn = abs(loss_x - loss_r) / abs(loss_r), abs(gn_x - gn_r) / gn_r
        # how far past the calibrated spread the worst parameter below the bound lies
        ratio = max((err(g_x, k) / max(spread[k], 1e-30) for k in below if not tiny(k)),
                    default=0.0) if bf16_floor else math.nan
        ok = (rel_loss <= TRAIN_LOSS_RTOL and rel_gn <= TRAIN_GNORM_RTOL
              and min(gated.values()) >= TRAIN_COS_MIN
              and (bf16_floor or all(tiny(k) for k in limited)))
        return dict(ok=ok, cos=cos, limited=limited, gated=gated, gn=gn_x, rel_loss=rel_loss,
                    rel_gn=rel_gn, ratio=ratio)

    v = verdict(loss_k, g_k)
    cos, gated, ok = v["cos"], v["gated"], v["ok"]
    worst = sorted(gated.items(), key=lambda kv: kv[1])[:3]
    log(f"[{tag}] first step vs plain fp32 path: loss {loss_k:.6f} vs {loss_r:.6f} (rel "
        f"{v['rel_loss']:.2e}, bound {TRAIN_LOSS_RTOL}); grad norm {v['gn']:.5f} vs {gn_r:.5f} "
        f"(rel {v['rel_gn']:.2e}, bound {TRAIN_GNORM_RTOL}); gradient cosine over {len(gated)} "
        f"of {len(g_r)} parameters, lowest {worst} (bound >= {TRAIN_COS_MIN}); plain bf16 vs "
        f"fp32 lowest {sorted(cos_plain.items(), key=lambda kv: kv[1])[:3]}"
        + (f"; worst error below the bound {v['ratio']:.3f} x the spread (bound {GATE_MARGIN})"
           if bf16_floor else "") + f" {'ok' if ok else 'FAIL'} ({smi})")
    below = sorted((k for k, c in gated.items() if c < TRAIN_COS_MIN), key=gated.get)
    if below:
        cos_kp = _cosines(g_k, g_p)
        log(f"[{tag}] {len(below)} parameters below the cosine bound")
        for k in below[:12]:
            why = f", ceiling {ceiling[k]:.3e}" if bf16_floor else ""
            log(f"[{tag}]   {k}: cosine kernels {cos[k]:.4f}, plain bf16 "
                f"{cos_plain.get(k, math.nan):.4f}, kernels vs plain bf16 "
                f"{cos_kp.get(k, math.nan):.4f}; fp32 max |g| {amax(g_r, k):.3e}, norm "
                f"{float(g_r[k].norm()):.3e}; relative L2 error {err(g_k, k):.3e}{why}")
    zero = sorted(set(g_r) - set(cos))
    if zero:
        log(f"[{tag}] {len(zero)} parameters with an exactly zero gradient in both paths, left "
            f"out of the cosine gate: {zero}")
    for k in sorted(v["limited"]):
        why = (f"relative L2 error kernels {err(g_k, k):.3e}, ceiling {ceiling[k]:.3e} "
               f"(plain bf16 {err(g_p, k):.3e}; or max |g| < AdamW eps {ADAMW_EPS})"
               if bf16_floor else f"bound max |g| < AdamW eps {ADAMW_EPS}")
        log(f"[{tag}] bf16-limited: {k}: cosine kernels {cos[k]:.4f}, plain bf16 "
            f"{cos_plain.get(k, math.nan):.4f}; max |g| kernels {amax(g_k, k):.3e}, fp32 "
            f"{amax(g_r, k):.3e}; {why}; fp32 norm {float(g_r[k].norm()):.3e} of global "
            f"{gn_r:.3e}")
    if not ok:
        raise RuntimeError(f"{tag}: train step gradients disagree with the plain fp32 path")
    if s_r:
        _compare_batch_stats(s_k, s_r, tag, smi)

    t0, wrong = time.perf_counter(), []
    for label, k16, want in controls:
        with _k16_replaced(k16=k16):
            loss_c, g_c, _ = first_step(torch.bfloat16, "auto")
        c = verdict(loss_c, g_c)
        fail = sorted((k for k, x in c["gated"].items() if x < TRAIN_COS_MIN), key=c["cos"].get)
        log(f"[{tag}] control, K16 {label}: loss rel {c['rel_loss']:.2e}, grad norm rel "
            f"{c['rel_gn']:.2e}, worst error below the bound {c['ratio']:.3f} x the spread, "
            f"{len(fail)} parameters fail"
            + "".join(f"; {k} cosine {c['cos'][k]:.4f} (rel L2 {err(g_c, k):.3e}, ceiling "
                      f"{ceiling.get(k, math.nan):.3e})" for k in fail[:4])
            + f": gate {'passes' if c['ok'] else 'fails'}"
            + ("" if want is None else f" (expected: {'passes' if want else 'fails'})")
            + f" ({smi})")
        if want is not None and c["ok"] != want:
            wrong.append(f"the gate {'fails' if want else 'passes'} K16 {label}")
    if controls:
        log(f"[{tag}] {len(controls)} controls in {time.perf_counter() - t0:.1f} s")
    if wrong:
        raise RuntimeError(f"{tag}: {'; '.join(wrong)}")
    return cos


def _compare_batch_stats(got, ref, tag, smi):
    """DAT's BatchNorm batch statistics of the first step (what the
    running statistics take in), kernels (bf16) against the plain fp32
    path, per BatchNorm in relative L2 error at the scale both are
    computed at, the second moment E[y^2] = var + mean^2 (mean against
    its square root): the fast variance E[y^2] - E[y]^2 is a difference at
    that scale, and the channel gate's, over 8 samples whose pooled
    features nearly agree, is far below it.  Bound TRAIN_GNORM_RTOL (bf16
    activations, as for the grad norm)."""
    rel = {}
    for name in ref:
        if not name.endswith("running_mean"):
            continue
        bn = name[:-len("running_mean")]
        m_k, m_r = got[name], ref[name]
        v_k, v_r = got[bn + "running_var"], ref[bn + "running_var"]
        second = v_r + m_r.square()
        rel[bn + "mean"] = float((m_k - m_r).norm()) / max(float(second.sqrt().norm()), 1e-30)
        rel[bn + "var"] = float((v_k - v_r).norm()) / max(float(second.norm()), 1e-30)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    ok = all(math.isfinite(v) and v <= TRAIN_GNORM_RTOL for v in rel.values())
    log(f"[{tag}] BatchNorm batch statistics of the first step vs plain fp32 path: "
        f"{len(rel)} means and variances, relative L2 error at the second moment's scale, "
        f"worst {worst} (bound {TRAIN_GNORM_RTOL}) {'ok' if ok else 'FAIL'} ({smi})")
    if not ok:
        raise RuntimeError(f"{tag}: BatchNorm statistics disagree with the plain fp32 path")


def phase_hat_train(workdir, smi):
    """HAT x4 training: the train CLI (``--model hat``, HATConfig() at
    full width and depth, batch 8, --patch_size 64, L1, AdamW, clip 1.0)
    for one epoch on a synthetic DeepRock tree; then per-step launches
    and times (kernels vs plain bf16), a profiled step split by part, and
    the first step's gradients against the plain fp32 path; then a
    hat_fast step (K1 with `extra`, K5 with d`extra`).  Returns the
    launches of the CLI run and of the counted steps."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.cli.train import main as train_main
    from tpu_superresolution_torch.core.config import HATConfig, HATFastConfig, build_model
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.train.engine import make_train_step

    batch, patch, scale = TRAIN_BATCH, TRAIN_LR_PATCH, 4
    n_train, n_valid = 2 * batch, 2
    data = f"{workdir}/deeprock_hat"
    _write_deeprock(data, n_train, n_valid, hr_size=320, scale=scale, seed=SEED + 2)

    # 1. the entry point: one epoch of 2 steps + validation of 2 images
    reset_counters()
    t0 = time.perf_counter()
    trainer, state = train_main([
        "--data_root", data, "--scale", "X4", "--model", "hat", "--epochs", "1",
        "--batch_size", str(batch), "--patch_size", str(patch), "--loss", "l1",
        "--workdir", f"{workdir}/hat_run", "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counters()
    steps, val_calls = n_train // batch, 1
    expect = {k: steps * HAT_TRAIN_PER_STEP[k] + val_calls * HAT_PER_CALL[k]
              for k in HAT_TRAIN_PER_STEP}
    log(f"[hat-train] train CLI, HAT x4 (HATConfig(): embed 96, depths 6x4, ws 7, drop_path_rate "
        f"{trainer.model_config.drop_path_rate}), batch {batch}, patch {patch}: {steps} steps + "
        f"validation in {cli_s:.1f} s (incl. the first steps' set-up); train loss "
        f"{trainer.history['train'][0]:.6f}, val PSNR {trainer.best_val_psnr:.2f} dB; launches "
        f"{launches} (expected {expect}) ({smi})")
    if state.step != steps or not math.isfinite(trainer.history["train"][0]):
        raise RuntimeError(f"train CLI: {state.step} steps, loss {trainer.history['train']}")
    if launches != expect:
        raise RuntimeError(f"train CLI launches {launches}, expected {expect}")
    del trainer, state

    # 2. one step's launches, step times (kernels vs plain bf16), a split
    rng = np.random.default_rng(SEED + 3)
    lr = torch.from_numpy(rng.random((batch, patch, patch, 3), dtype=np.float32)).cuda()
    hr = torch.from_numpy(
        rng.random((batch, patch * scale, patch * scale, 3), dtype=np.float32)).cuda()
    step = make_train_step("l1", "native_lr", scale, patch, False)
    cfg = HATConfig()
    src = build_model(cfg)
    src.reset_parameters(torch.Generator().manual_seed(SEED))
    per_step_all = {}
    for label, impl in (("kernels", "auto"), ("plain", "plain")):
        model = build_model(cfg, dtype=torch.bfloat16, impl=impl, device="cuda")
        model.load_state_dict(src.state_dict())
        st = _train_state(model, steps)
        gen = torch.Generator().manual_seed(SEED)
        warm, timed = (3, TRAIN_TIMED_STEPS) if label == "kernels" else (1, DAT_TIMED_STEPS)
        for _ in range(warm):
            step(st, lr, hr, gen)
        torch.cuda.synchronize()
        reset_counters()
        step(st, lr, hr, gen)
        torch.cuda.synchronize()
        per_step = read_counters()
        dts = []
        for _ in range(timed):
            t0 = time.perf_counter()
            m = step(st, lr, hr, gen)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        ms = statistics.median(dts) * 1e3
        log(f"[hat-train] {label} bf16 path: launches per step {per_step}; median {ms:.2f} "
            f"ms/step over {timed} steps after {warm + 1} warm-up (min "
            f"{min(dts) * 1e3:.2f}, max {max(dts) * 1e3:.2f}), {batch / ms * 1e3:.1f} images/s; "
            f"loss {float(m['loss']):.6f} ({smi})")
        if label == "kernels":
            if per_step != HAT_TRAIN_PER_STEP:
                raise RuntimeError(f"HAT launches per train step {per_step}, expected "
                                   f"{HAT_TRAIN_PER_STEP}")
            per_step_all = per_step
            _hat_train_split(st, lr, hr, ms, smi)
            _packing_cost(model, tag="hat-train")
        elif any(per_step.values()):
            raise RuntimeError(f"the plain path launched kernels: {per_step}")
        del model, st

    # 3. the first step's gradients; the HABs' norm1 gets two gradients
    # (the block kernel's LN1 and K12's LN1 in the CAB) whose sum must
    # match
    cos = _first_step_gate(cfg, src, lr, hr, "hat-train", smi)
    norm1 = sorted((v, k) for k, v in cos.items() if ".blocks." in k and ".norm1." in k)
    log(f"[hat-train] HAB norm1 gradients (block kernel LN1 + the CAB's K12 LN1), lowest "
        f"cosine {norm1[:2]}")
    del src

    # 4. hat_fast: one counted step (K1 with extra, K5 with d extra) and
    # its first-step gradients
    fcfg = HATFastConfig()
    fsrc = build_model(fcfg)
    fsrc.reset_parameters(torch.Generator().manual_seed(SEED))
    model = build_model(fcfg, dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(fsrc.state_dict())
    st = _train_state(model, steps)
    gen = torch.Generator().manual_seed(SEED)
    step(st, lr, hr, gen)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    step(st, lr, hr, gen)
    torch.cuda.synchronize()
    fms = (time.perf_counter() - t0) * 1e3
    fast = read_counters()
    log(f"[hat-train] hat_fast (ws 8) step: launches {fast} (expected "
        f"{HAT_FAST_TRAIN_PER_STEP}); {fms:.2f} ms (one step, synchronised) ({smi})")
    if fast != HAT_FAST_TRAIN_PER_STEP:
        raise RuntimeError(f"hat_fast launches per step {fast}, expected "
                           f"{HAT_FAST_TRAIN_PER_STEP}")
    _packing_cost(model, tag="hat-train hat_fast")
    del model, st
    _first_step_gate(fcfg, fsrc, lr, hr, "hat-train hat_fast", smi)
    return [launches, per_step_all, fast]


def hat_mlp4_config():
    """The HAT the JAX train CLI builds with HAT-SRx4's flags and no
    --mlp_ratio (it has none: ``tpu_superresolution_tpu/cli/train.py``):
    ``hat_srx4_config()`` at HATConfig's mlp 4, an MLP hidden of 720."""
    import dataclasses

    return dataclasses.replace(hat_srx4_config(), mlp_ratio=4.0)


def phase_hat_srx4_train(workdir, smi, mlp4=False):
    """HAT-SRx4 training: the train CLI (``--model hat --window_size 16
    --embed_dim 180 --t_depths 6,6,6,6,6,6 --t_heads 6,6,6,6,6,6
    --mlp_ratio 2``, which builds ``hat_srx4_config()``; with `mlp4` the
    JAX train CLI's flags alone, which build ``hat_mlp4_config()``; batch
    8, --patch_size 64, L1, AdamW, clip 1.0) for one epoch of 2 steps plus
    validation on a synthetic DeepRock tree; then per-step launches
    (exactly HAT_SRX4_TRAIN_PER_STEP, at mlp 4 too: the same routes, a
    wider MLP), ms per step for the kernels and the plain bf16 path, the
    peak device memory, the autograd graph of a step (every HAB's backward
    WindowBlockFunction's, i.e. K5w16, every OCAB's Ocab16Function's,
    i.e. K8bw16, after it the gather's OcabHeadsFunction, and none left
    to autograd of plain ops), (at mlp 2) a profiled step split by part
    and the blocks' packing cost, and the first step's gradients against
    the plain fp32 path.  Returns the launches of the CLI run and of the
    counted step, and the CLI's best checkpoint."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.cli.train import main as train_main
    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.train.engine import make_train_step

    batch, patch, scale = TRAIN_BATCH, TRAIN_LR_PATCH, 4
    n_train, n_valid = 2 * batch, 2
    tag = "hat_mlp4-train" if mlp4 else "hat_srx4-train"
    data = f"{workdir}/deeprock_{'hat_mlp4' if mlp4 else 'hat_srx4'}"
    run_dir = f"{workdir}/{'hat_mlp4' if mlp4 else 'hat_srx4'}_run"
    _write_deeprock(data, n_train, n_valid, hr_size=320, scale=scale, seed=SEED + 8)
    cfg = hat_mlp4_config() if mlp4 else hat_srx4_config()

    # 1. the entry point: one epoch of 2 steps + validation of 2 images
    reset_counters()
    t0 = time.perf_counter()
    trainer, state = train_main([
        "--data_root", data, "--scale", "X4", "--model", "hat", "--window_size", "16",
        "--embed_dim", "180", "--t_depths", "6,6,6,6,6,6", "--t_heads", "6,6,6,6,6,6"]
        + ([] if mlp4 else ["--mlp_ratio", "2"]) + [
        "--epochs", "1", "--batch_size", str(batch), "--patch_size", str(patch), "--loss", "l1",
        "--workdir", run_dir, "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counters()
    steps, val_calls = n_train // batch, 1
    expect = {k: steps * HAT_SRX4_TRAIN_PER_STEP[k] + val_calls * HAT_SRX4_PER_CALL[k]
              for k in HAT_SRX4_TRAIN_PER_STEP}
    log(f"[{tag}] train CLI, HAT (window 16, embed 180, depths 6x6, mlp "
        f"{trainer.model_config.mlp_ratio:g}{'' if mlp4 else ', HAT-SRx4'}, drop_path_rate "
        f"{trainer.model_config.drop_path_rate}), batch {batch}, patch {patch}: "
        f"{steps} steps + validation in {cli_s:.1f} s (incl. the first steps' set-up); train "
        f"loss {trainer.history['train'][0]:.6f}, val PSNR {trainer.best_val_psnr:.2f} dB; "
        f"launches {launches} (expected {expect}) ({smi})")
    if trainer.model_config != cfg:
        raise RuntimeError(f"the CLI built {trainer.model_config}, not {cfg}")
    if state.step != steps or not math.isfinite(trainer.history["train"][0]):
        raise RuntimeError(f"train CLI: {state.step} steps, loss {trainer.history['train']}")
    if launches != expect:
        raise RuntimeError(f"{tag}: train CLI launches {launches}, expected {expect}")
    del trainer, state

    # 2. one step's launches, the step's graph, step times (kernels vs
    # plain bf16), peak memory, a split
    rng = np.random.default_rng(SEED + 9)
    lr = torch.from_numpy(rng.random((batch, patch, patch, 3), dtype=np.float32)).cuda()
    hr = torch.from_numpy(
        rng.random((batch, patch * scale, patch * scale, 3), dtype=np.float32)).cuda()
    step = make_train_step("l1", "native_lr", scale, patch, False)
    src = build_model(cfg)
    src.reset_parameters(torch.Generator().manual_seed(SEED))
    per_step_all, times = {}, {}
    for label, impl in (("kernels", "auto"), ("plain", "plain")):
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, dtype=torch.bfloat16, impl=impl, device="cuda")
        model.load_state_dict(src.state_dict())
        st = _train_state(model, steps)
        gen = torch.Generator().manual_seed(SEED)
        step(st, lr, hr, gen)
        torch.cuda.synchronize()
        reset_counters()
        step(st, lr, hr, gen)
        torch.cuda.synchronize()
        per_step = read_counters()
        dts = []
        for _ in range(DAT_TIMED_STEPS):
            t0 = time.perf_counter()
            m = step(st, lr, hr, gen)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        ms = statistics.median(dts) * 1e3
        times[label] = ms
        log(f"[{tag}] {label} bf16 path: launches per step {per_step}; median "
            f"{ms:.2f} ms/step over {DAT_TIMED_STEPS} steps after 2 warm-up (min "
            f"{min(dts) * 1e3:.2f}, max {max(dts) * 1e3:.2f}), {batch / ms * 1e3:.1f} "
            f"images/s; loss {float(m['loss']):.6f}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({smi})")
        if label == "kernels":
            if per_step != HAT_SRX4_TRAIN_PER_STEP:
                raise RuntimeError(f"{tag}: launches per train step {per_step}, expected "
                                   f"{HAT_SRX4_TRAIN_PER_STEP}")
            per_step_all = per_step
            _check_backward_nodes(model, lr, hr, cfg, tag=tag)
            if not mlp4:
                _hat_train_split(st, lr, hr, ms, smi, tag=tag)
                _packing_cost(model, k5w16=True, tag=tag)
        else:
            if any(per_step.values()):
                raise RuntimeError(f"the plain path launched kernels: {per_step}")
            if not mlp4:
                _profile_step(step, st, lr, hr, gen, tag=f"{tag} plain bf16")
        del model, st
    log(f"[{tag}] kernels {times['kernels']:.2f} ms/step, plain bf16 "
        f"{times['plain']:.2f} ms/step ({times['plain'] / times['kernels']:.2f}x) ({smi})")

    # 3. the first step's gradients against the plain fp32 path
    _first_step_gate(cfg, src, lr, hr, tag, smi)
    return [launches, per_step_all], f"{run_dir}/best_X4.pth"


# the serving leg's export batch: 8 of the bench's 64^2 tiles
MLP4_SERVE_SHAPE = (8, 64, 64, 3)


def phase_hat_mlp4_serve(workdir, ckpt, smi):
    """The JAX train CLI's HAT (``hat_mlp4_config()``: window 16, mlp 4)
    served from the train leg's checkpoint `ckpt`: ``cli.upscale.main`` on
    a validation LR image of the leg's DeepRock tree (80^2, whole: one
    model call, its OCABs on K8w16 as ``models.hat.OCAB.takes_fused``
    chooses at ws 16): launches exactly HAT_SRX4_PER_CALL; the PNG equal
    to the one the same forward writes (the checkpoint as the CLI loads
    it, ``Evaluator``'s whole-image forward), and that forward within
    PSNR_MIN_DB of the plain fp32 path from the checkpoint's weights;
    then the model through ``interop.export`` at MLP4_SERVE_SHAPE
    (``_export_family`` on those weights): the loaded program
    bit-identical to eager, both with HAT_SRX4_PER_CALL's launches, within
    PSNR_MIN_DB of plain fp32.  Returns the launches of the CLI's call and
    of the loaded program's."""
    from pathlib import Path

    import numpy as np
    import torch
    from PIL import Image

    from tpu_superresolution_torch.cli.upscale import load_for_inference
    from tpu_superresolution_torch.cli.upscale import main as upscale_main
    from tpu_superresolution_torch.core.config import EvalConfig, build_model
    from tpu_superresolution_torch.data.decode import decode_image
    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.evaluate.runner import Evaluator, save_tensor_as_png
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.train.checkpoint import checked_params, read_checkpoint

    tag = "hat_mlp4-serve"
    lr_png = str(PairedIndex(f"{workdir}/deeprock_hat_mlp4", "valid", "X4")[0][0])
    out = f"{workdir}/hat_mlp4_sr.png"
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    upscale_main(["--image", lr_png, "--ckpt", ckpt, "--model", "hat", "--scale", "X4",
                  "--out", out, "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counters()
    mcfg, model, scale, convention, channels = load_for_inference(ckpt, "hat", "X4", None,
                                                                   torch.device("cuda"))
    if mcfg != hat_mlp4_config():
        raise RuntimeError(f"{tag}: the checkpoint holds {mcfg}, not hat_mlp4_config()")
    x = torch.from_numpy(decode_image(Path(lr_png), grayscale=False, channels=channels))[None]
    ecfg = EvalConfig(batch_size=1)
    sr = Evaluator(model, scale, convention, ecfg).forward_fn()(x.cuda())
    ref_png = f"{workdir}/hat_mlp4_sr_same_forward.png"
    save_tensor_as_png(sr[0].cpu().numpy(), ref_png)
    with Image.open(out) as a, Image.open(ref_png) as b:
        same_png, size = np.array_equal(np.asarray(a), np.asarray(b)), a.size
    state = checked_params(read_checkpoint(ckpt), ckpt)
    plain = build_model(mcfg, dtype=torch.float32, impl="plain", device="cuda")
    plain.load_state_dict(state)
    ref = Evaluator(plain.eval(), scale, convention, ecfg).forward_fn()(x.cuda())
    del plain, model
    psnr = _psnr_db(sr, ref)
    expect = {k: HAT_SRX4_PER_CALL.get(k, 0) for k in launches}
    log(f"[{tag}] upscale CLI on {os.path.basename(lr_png)} ({x.shape[1]}^2 LR, the whole "
        f"image) from the train leg's best_X4.pth ({mcfg.name}, window {mcfg.window_size}, "
        f"embed {mcfg.embed_dim}, mlp {mcfg.mlp_ratio:g}): {size} in {cli_s:.2f} s (load and "
        f"first call included); launches {launches} (expected {expect}); its PNG "
        f"{'equal to' if same_png else 'DIFFERS from'} the same forward's; that forward vs "
        f"plain fp32 PSNR {psnr:.2f} dB (bound >= {PSNR_MIN_DB}) ({smi})")
    if (launches != expect or not same_png or size != (4 * x.shape[2], 4 * x.shape[1])
            or psnr < PSNR_MIN_DB):
        raise RuntimeError(f"{tag}: launches {launches}, PNG equal {same_png}, size {size}, "
                           f"PSNR {psnr}")
    program = _export_family("HAT ws 16 mlp 4 (the JAX train CLI's), from the train leg's "
                             "checkpoint", mcfg, MLP4_SERVE_SHAPE, HAT_SRX4_PER_CALL, smi, tag,
                             state=state)
    return {k: launches.get(k, 0) + program.get(k, 0) for k in PER_CALL}


@contextlib.contextmanager
def _blocks_backward_as_autograd():
    """SwinIR's K7-route blocks trained as before K5r: the route's
    forward kernels (K2, K7, K1t) with their autograd functions, whose
    backwards are autograd of their plain versions.  A measurement's
    baseline only; the port has no such switch."""
    from tpu_superresolution_torch.models import swinir

    tiled = swinir.tiled_bwd_ok
    swinir.tiled_bwd_ok = lambda *args, **kw: False
    try:
        yield
    finally:
        swinir.tiled_bwd_ok = tiled


def phase_swinir_l_train(workdir, smi):
    """SwinIR-L fine-tuning: the finetune CLI (``--device cuda``) on a
    seeded SwinIR-L reference ``.pth`` written here (``swinir_l_config()``;
    the CLI infers its architecture from the weights), batch 8 of 64^2 LR
    crops, L1, AdamW, clip 1.0, drop path 0.1, one epoch of 2 steps plus
    validation on a synthetic DeepRock tree; then per-step launches
    (exactly SWINIR_L_TRAIN_PER_STEP: K5r x54), the autograd graph of a
    step (every block's backward WindowBlockFunction's, i.e. K5r, none
    left to autograd of plain ops), ms a step and peak device memory
    with K5r and with the blocks' backward as autograd of K7's and K1t's
    plain versions (the route before K5r), in turns on one model, a
    profiled step split by part, and the first step's gradients against
    the plain fp32 path.  Returns the launches of the CLI run and of the
    counted step."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.cli.finetune import main as finetune_main
    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.models.swinir import SwinBlock
    from tpu_superresolution_torch.train.engine import make_train_step

    batch, patch, scale = TRAIN_BATCH, TRAIN_LR_PATCH, 4
    n_train, n_valid = 2 * batch, 2
    data = f"{workdir}/deeprock_swinir_l"
    _write_deeprock(data, n_train, n_valid, hr_size=320, scale=scale, seed=SEED + 10)
    cfg = swinir_l_config()
    src = build_model(cfg)
    src.reset_parameters(torch.Generator().manual_seed(SEED))
    weights = f"{workdir}/swinir_l_x4_random.pth"
    torch.save({"params": src.state_dict()}, weights)

    # 1. the entry point: one epoch of 2 steps + validation of 2 images
    reset_counters()
    t0 = time.perf_counter()
    trainer, state = finetune_main([
        "--data_root", data, "--scale", "X4", "--weights", weights, "--epochs", "1",
        "--batch_size", str(batch), "--lr_patch", str(patch), "--workdir",
        f"{workdir}/swinir_l_run", "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counters()
    steps, val_calls = n_train // batch, 1
    expect = {k: steps * SWINIR_L_TRAIN_PER_STEP[k] + val_calls * SWINIR_L_PER_CALL[k]
              for k in SWINIR_L_TRAIN_PER_STEP}
    mc = trainer.model_config
    arch = lambda m: (m.embed_dim, m.depths, m.num_heads, m.window_size, m.mlp_ratio,
                      m.resi_connection, m.upsampler)
    log(f"[swinir_l-train] finetune CLI on a SwinIR-L .pth (inferred embed {mc.embed_dim}, "
        f"depths {mc.depths}, heads {mc.num_heads}, ws {mc.window_size}, mlp {mc.mlp_ratio}, "
        f"{mc.resi_connection}, {mc.upsampler}; drop_path_rate {mc.drop_path_rate}), batch "
        f"{batch}, lr_patch {patch}: {steps} steps + validation in {cli_s:.1f} s (incl. the "
        f"weight load and the first steps' set-up); train loss {trainer.history['train'][0]:.6f},"
        f" val PSNR {trainer.best_val_psnr:.2f} dB; launches {launches} (expected {expect}) "
        f"({smi})")
    if arch(mc) != arch(cfg):
        raise RuntimeError(f"finetune inferred {arch(mc)}, not SwinIR-L's {arch(cfg)}")
    if state.step != steps or not math.isfinite(trainer.history["train"][0]):
        raise RuntimeError(f"finetune: {state.step} steps, loss {trainer.history['train']}")
    if launches != expect:
        raise RuntimeError(f"SwinIR-L finetune launches {launches}, expected {expect}")
    del trainer, state

    # 2. one step's launches and graph; K5r against the autograd backward
    # in turns on one model (times, peak memory); a split
    rng = np.random.default_rng(SEED + 11)
    lr = torch.from_numpy(rng.random((batch, patch, patch, 3), dtype=np.float32)).cuda()
    hr = torch.from_numpy(
        rng.random((batch, patch * scale, patch * scale, 3), dtype=np.float32)).cuda()
    step = make_train_step("l1", "native_lr", scale, patch, False)
    model = build_model(cfg, dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(src.state_dict())
    st = _train_state(model, steps)
    gen = torch.Generator().manual_seed(SEED)
    modes = {"K5r": contextlib.nullcontext, "autograd": _blocks_backward_as_autograd}
    per_step = {}
    for label, mode in modes.items():
        with mode():
            step(st, lr, hr, gen)
            torch.cuda.synchronize()
            reset_counters()
            step(st, lr, hr, gen)
            torch.cuda.synchronize()
            per_step[label] = read_counters()
    want = {"K5r": SWINIR_L_TRAIN_PER_STEP, "autograd": dict(SWINIR_L_TRAIN_PER_STEP, K5r=0)}
    log(f"[swinir_l-train] launches per step: {per_step} (expected {want})")
    if per_step != want:
        raise RuntimeError(f"SwinIR-L launches per train step {per_step}, expected {want}")
    _check_backward_nodes(model, lr, hr, cfg, tag="swinir_l-train", ocabs=False)
    times, peaks = {k: [] for k in modes}, dict.fromkeys(modes, 0)
    for rnd in range(SWINIR_L_AB_ROUNDS):  # K5r, autograd, autograd, K5r, ...
        for label in (list(modes) if rnd % 2 == 0 else list(modes)[::-1]):
            with modes[label]():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                m = step(st, lr, hr, gen)
                torch.cuda.synchronize()
                times[label].append(time.perf_counter() - t0)
                peaks[label] = max(peaks[label], torch.cuda.max_memory_allocated())
    ms = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    for label in modes:
        dts = times[label]
        log(f"[swinir_l-train] blocks' backward {label}: median {ms[label]:.2f} ms/step over "
            f"{len(dts)} steps in turns (min {min(dts) * 1e3:.2f}, max {max(dts) * 1e3:.2f}), "
            f"{batch / ms[label] * 1e3:.1f} images/s; peak memory "
            f"{peaks[label] / 2 ** 30:.2f} GiB ({smi})")
    log(f"[swinir_l-train] K5r {ms['K5r']:.2f} ms/step, autograd backward {ms['autograd']:.2f} "
        f"ms/step ({ms['autograd'] / ms['K5r']:.2f}x); peak memory "
        f"{peaks['K5r'] / 2 ** 30:.2f} vs {peaks['autograd'] / 2 ** 30:.2f} GiB; loss "
        f"{float(m['loss']):.6f} ({smi})")
    _hat_train_split(st, lr, hr, ms["K5r"], smi, tag="swinir_l-train",
                     parts={SwinBlock: "swinir::block"},
                     by_span=(("swinir::block",
                               "forward block plain ops (shift and partition gathers)"),))
    _packing_cost(model, k5w16=True, tag="swinir_l-train")
    del model, st

    # 3. the first step's gradients against the plain fp32 path
    _first_step_gate(cfg, src, lr, hr, "swinir_l-train", smi)
    return [launches, per_step["K5r"]]


def _check_backward_nodes(model, lr, hr, cfg, tag="hat_srx4-train", ocabs=True):
    """The autograd graph of one train-mode forward on the K7 route: each
    block is one WindowBlockFunction (backward K5w16, or K5r at ws 8) and,
    with `ocabs` (HAT-SRx4), each OCAB core one Ocab16Function (backward
    K8bw16) after one OcabHeadsFunction (the gather's backward); no K7, K1t or K15 autograd function, whose
    backwards are autograd of plain ops, is in it."""
    import torch

    model.train()
    loss = (model(lr, generator=torch.Generator().manual_seed(SEED)).float() - hr).abs().mean()
    counts, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        counts[type(fn).__name__] = counts.get(type(fn).__name__, 0) + 1
        todo.extend(f for f, _ in fn.next_functions)
    blocks = sum(cfg.depths)
    want = {"WindowBlockFunctionBackward": blocks}
    if ocabs:
        want["Ocab16FunctionBackward"] = len(cfg.depths)
        want["OcabHeadsFunctionBackward"] = len(cfg.depths)
    plain = ("WindowAttentionFunctionBackward", "BlockTailFunctionBackward",
             "BatchedWindowAttentionFunctionBackward", "SwinBlockFunctionBackward")
    got = {k: counts.get(k, 0) for k in list(want) + list(plain)}
    log(f"[{tag}] autograd graph of a step: {len(seen)} nodes; {got}")
    if any(got[k] != v for k, v in want.items()) or any(got[k] for k in plain):
        raise RuntimeError(f"{tag} backward nodes {got}, expected {want} and none of {plain}")
    del loss


def phase_dat_train(workdir, smi):
    """DAT x4 training: the train CLI (``--model dat``, DATConfig() at
    full width and depth, drop path 0.1, batch 8, --patch_size 64, L1,
    AdamW, clip 1.0, --ema_decay 0.999) for one epoch of 2 steps plus
    validation (the EMA copy, on the kernels) on a synthetic DeepRock
    tree; then per-step launches and times (kernels vs plain bf16), a
    profiled step split by part, and the first step's loss, gradients
    and BatchNorm statistics against the plain fp32 path.  Returns the
    launches of the CLI run and of the counted step."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.cli.train import main as train_main
    from tpu_superresolution_torch.core.config import DATConfig, build_model
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.train.engine import make_train_step

    batch, patch, scale = TRAIN_BATCH, TRAIN_LR_PATCH, 4
    n_train, n_valid = 2 * batch, 2
    data = f"{workdir}/deeprock_dat"
    _write_deeprock(data, n_train, n_valid, hr_size=320, scale=scale, seed=SEED + 4)

    # 1. the entry point: one epoch of 2 steps + validation of 2 images
    reset_counters()
    t0 = time.perf_counter()
    trainer, state = train_main([
        "--data_root", data, "--scale", "X4", "--model", "dat", "--epochs", "1",
        "--batch_size", str(batch), "--patch_size", str(patch), "--loss", "l1",
        "--ema_decay", "0.999", "--workdir", f"{workdir}/dat_run", "--seed", str(SEED),
        "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counters()
    steps, val_calls = n_train // batch, 1
    expect = {k: steps * DAT_TRAIN_PER_STEP[k] + val_calls * DAT_PER_CALL[k]
              for k in DAT_TRAIN_PER_STEP}
    log(f"[dat-train] train CLI, DAT x4 (DATConfig(): embed 180, depths 6x6, split (8, 16), "
        f"drop_path_rate {trainer.model_config.drop_path_rate}), batch {batch}, patch {patch}, "
        f"EMA 0.999: {steps} steps + validation in {cli_s:.1f} s (incl. the first steps' "
        f"set-up); train loss {trainer.history['train'][0]:.6f}, val PSNR "
        f"{trainer.best_val_psnr:.2f} dB; launches {launches} (expected {expect}) ({smi})")
    if state.step != steps or not math.isfinite(trainer.history["train"][0]):
        raise RuntimeError(f"train CLI: {state.step} steps, loss {trainer.history['train']}")
    if launches != expect:
        raise RuntimeError(f"dat train CLI launches {launches}, expected {expect}")
    if sorted(state.ema) != sorted(n for n, _ in state.model.named_parameters()):
        raise RuntimeError("the EMA does not cover exactly the parameters")
    del trainer, state

    # 2. one step's launches, step times (kernels vs plain bf16), a split
    rng = np.random.default_rng(SEED + 5)
    lr = torch.from_numpy(rng.random((batch, patch, patch, 3), dtype=np.float32)).cuda()
    hr = torch.from_numpy(
        rng.random((batch, patch * scale, patch * scale, 3), dtype=np.float32)).cuda()
    step = make_train_step("l1", "native_lr", scale, patch, False)
    cfg = DATConfig()
    src = build_model(cfg)
    src.reset_parameters(torch.Generator().manual_seed(SEED))
    per_step_all = {}
    for label, impl in (("kernels", "auto"), ("plain", "plain")):
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, dtype=torch.bfloat16, impl=impl, device="cuda")
        model.load_state_dict(src.state_dict())
        st = _train_state(model, steps)
        gen = torch.Generator().manual_seed(SEED)
        warm = 1 if label == "kernels" else 0  # the plain path's counted step warms it
        for _ in range(warm):
            step(st, lr, hr, gen)
        torch.cuda.synchronize()
        reset_counters()
        step(st, lr, hr, gen)
        torch.cuda.synchronize()
        per_step = read_counters()
        dts = []
        for _ in range(DAT_TIMED_STEPS):
            t0 = time.perf_counter()
            m = step(st, lr, hr, gen)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        ms = statistics.median(dts) * 1e3
        log(f"[dat-train] {label} bf16 path: launches per step {per_step}; median {ms:.2f} "
            f"ms/step over {DAT_TIMED_STEPS} steps after {warm + 1} warm-up (min "
            f"{min(dts) * 1e3:.2f}, max {max(dts) * 1e3:.2f}), {batch / ms * 1e3:.1f} images/s; "
            f"loss {float(m['loss']):.6f}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB ({smi})")
        if label == "kernels":
            if per_step != DAT_TRAIN_PER_STEP:
                raise RuntimeError(f"DAT launches per train step {per_step}, expected "
                                   f"{DAT_TRAIN_PER_STEP}")
            per_step_all = per_step
            _dat_train_split(st, lr, hr, ms, smi)
        elif any(per_step.values()):
            raise RuntimeError(f"the plain path launched kernels: {per_step}")
        del model, st

    # 3. the first step's loss, gradients and BatchNorm statistics, with
    # every K16 of the step (masked and not) on the square kernel, from
    # the weights with their attention scaled to trained size
    from tpu_superresolution_torch.kernels import window_attention as wa

    n, hd = cfg.split_size[0] * cfg.split_size[1], cfg.embed_dim // 2 // (cfg.num_heads[0] // 2)
    routes = {m: wa.k15_route(n, n, hd, m, wa.K16_SPLIT_P) for m in (False, True)}
    log(f"[dat-train] K16 at [{batch * 32},{cfg.num_heads[0] // 2},{n},{hd}] takes the "
        f"\"{routes[False]}\" kernel unmasked and the \"{routes[True]}\" kernel masked")
    if set(routes.values()) != {"square"}:
        raise RuntimeError(f"dat-train: K16 is not on the square kernel: {routes}")
    _dat_attention_sizes(cfg, src, lr, "dat-train seeded weights", smi)
    _dat_attention_sizes(cfg, _dat_trained_size(src), lr, "dat-train gate weights", smi)
    _first_step_gate(cfg, src, lr, hr, "dat-train", smi, bf16_floor=True,
                     controls=_dat_gate_controls())
    return [launches, per_step_all]


def _dat_gate_controls():
    """The dat-train gate's controls: fresh mis-rounded draws (seeds the
    calibration does not use) must pass, five wrong K16s must fail."""
    controls = [(f"plain, mis-rounded at {GATE_CAL_FRAC:g}, fresh seed {seed}",
                 _k16_misrounded(GATE_CAL_FRAC, seed), True) for seed in (201, 202)]
    return controls + [(kind, _k16_wrong(kind), False) for kind in K16_FAULTS]


def _dat_attention_sizes(cfg, src, lr, tag, smi):
    """Log the std and largest magnitude of `src`'s rect bias tables and
    of the scores q k^T (scale included) over every K16 call of one
    train-mode forward of the plain fp32 path on `lr`."""
    import torch

    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.kernels import window_attention as wa
    from tpu_superresolution_torch.models.dat import RectBranch

    model = build_model(cfg, dtype=torch.float32, impl="plain", device="cuda")
    model.load_state_dict(src.state_dict())
    model.train()
    scores = []

    def plain_k16(q, k, v, bias, mask=None, scale=1.0):
        s = (q.float() @ k.float().transpose(-1, -2)) * scale
        scores.append(torch.stack([s.std(), s.abs().max()]))
        return wa.fused_window_attention_plain(q, k, v, bias, mask, scale)

    with torch.no_grad(), _k16_replaced(plain_k16=plain_k16):
        tables = torch.cat([m.table().flatten() for m in model.modules()
                            if isinstance(m, RectBranch)])
        model(lr, generator=torch.Generator().manual_seed(SEED))
    sc = torch.stack(scores).cpu()
    log(f"[{tag}] rect bias tables std {float(tables.std()):.4f}, max |bias| "
        f"{float(tables.abs().max()):.4f}; scores q k^T std {float(sc[:, 0].min()):.4f}-"
        f"{float(sc[:, 0].max()):.4f}, max |s| {float(sc[:, 1].max()):.3f} over {len(sc)} K16 "
        f"calls ({smi})")
    del model


def _dat_trained_size(model):
    """`model` (a DAT) with its attention scaled to a trained model's
    size, in place: every DynamicPosBias's last layer times
    DAT_GATE_BIAS_GAIN, q's and k's rows of every spatial qkv times
    DAT_GATE_QK_GAIN (see there)."""
    import torch

    from tpu_superresolution_torch.models.dat import RectBranch, SpatialAttention

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, RectBranch):
                for t in (m.pos.pos3[2].weight, m.pos.pos3[2].bias):
                    t.mul_(DAT_GATE_BIAS_GAIN)
            elif isinstance(m, SpatialAttention):
                c = m.qkv.weight.shape[1]
                m.qkv.weight[:2 * c].mul_(DAT_GATE_QK_GAIN)
                if m.qkv.bias is not None:
                    m.qkv.bias[:2 * c].mul_(DAT_GATE_QK_GAIN)
    return model


# The DAT first-step gate at a head dim past 32: C 180 in 4 heads (hd 45)
# at two residual groups of two blocks (group 1's first block shifted, so
# its K16 calls are masked), where every K16 takes the square kernel with
# heads padded to 64 dims, odd hd's element loads (``k15_route``).
DAT_HD45 = dict(embed_dim=180, depths=(2, 2), num_heads=(4, 4))


def phase_k16_stream_check(smi):
    """The stream kernel's masked split-P path (csrc/window_attn_stream.cu,
    every masked K16 at hd 33-64), held two ways.  (1) One shifted DAT
    spatial block at DATConfig()'s widths (C 180, 6 heads of 30, split
    (8, 16)), train mode (the module chain, K16), a forward and backward
    with K16's route forced to "stream" beside the same with the square
    kernel (K16's route there), element by element, and both against the
    block's plain fp32 path: the output within ULP_BOUND bf16 ulps, every
    parameter's gradient within TRAIN_COS_MIN in cosine wherever the
    square kernel's is.  (2) DAT's first-step gate (``_first_step_gate``,
    with DAT's BF16_FLOOR) at DAT_HD45, whose K16 run on the square kernel
    at HDP 64.
    Returns the gate's launches (a check: not counted on the main path)."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.core.config import DATConfig, build_model
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels import window_attention as wa
    from tpu_superresolution_torch.models.dat import DATB

    tag = "k16-stream"
    torch.manual_seed(SEED)
    block = DATB(180, 6, (8, 16), 2.0, True, rg_idx=1, b_idx=0).train()
    assert block.spatial and block.shifted
    gen = torch.Generator().manual_seed(SEED + 11)
    x32 = torch.randn(2, 64, 64, 180, generator=gen)
    g32 = torch.randn(2, 64, 64, 180, generator=gen)

    def run(model, x, plain=False):
        model.zero_grad(set_to_none=True)
        x = x.clone().requires_grad_()
        out = model(x, plain=plain)
        (out.float() * g32.to(out.device)).sum().backward()
        grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        grads["x"] = x.grad.detach().float()
        return out.detach().float(), grads

    # (parameters stay fp32, as build_model keeps them; bf16 is x's compute dtype)
    ref_out, ref_g = run(block.to("cuda"), x32.cuda(), plain=True)
    xb = x32.to("cuda", torch.bfloat16)
    orig, forced = wa.k15_route, []

    def to_stream(nq, nk, hd, masked=False, split_p=False):
        route = orig(nq, nk, hd, masked, split_p)
        if route == "square":
            forced.append((nq, nk, hd, masked))
            return "stream"
        return route

    t_out, t_g = run(block, xb)
    wa.k15_route = to_stream
    try:
        s_out, s_g = run(block, xb)
    finally:
        wa.k15_route = orig
    torch.cuda.synchronize()
    shapes = sorted(set(forced))
    mag = float(ref_out.abs().max())
    bound = ULP_BOUND["K16"] * bf16_ulp(mag)
    e_st = float((s_out - t_out).abs().max())
    e_s, e_t = float((s_out - ref_out).abs().max()), float((t_out - ref_out).abs().max())
    log(f"[{tag}] DAT spatial block (C 180, 6 heads of 30, split (8, 16), shifted, train) "
        f"with K16 forced to the stream kernel on {len(forced)} calls {shapes} vs the square "
        f"kernel: output max |stream - square| {e_st:.3e}; vs plain fp32 stream {e_s:.3e}, square "
        f"{e_t:.3e} (bound {bound:.3e} = {ULP_BOUND['K16']} bf16 ulp at max|ref| {mag:.3f}) ({smi})")
    # tensors whose fp32 gradient is zero but for rounding (biases that a
    # BatchNorm follows) carry no direction: left out, and counted
    norms = {k: float(g.norm()) for k, g in ref_g.items()}
    live = {k: g for k, g in ref_g.items() if norms[k] >= 1e-6 * max(norms.values())}
    cos_s, cos_t = _cosines(s_g, live), _cosines(t_g, live)
    rel = lambda g, k: float((g[k] - ref_g[k]).norm()) / norms[k]
    apart = {k: float((s_g[k] - t_g[k]).norm()) / norms[k] for k in live}
    worst = sorted(cos_s, key=lambda k: cos_s[k])[:3]
    log(f"[{tag}] gradients of {len(live)} of {len(ref_g)} tensors (the rest zero in fp32 but "
        f"for rounding): |stream - square| / |fp32| at most {max(apart.values()):.3e} (on "
        f"{max(apart, key=apart.get)}); lowest cosine vs plain fp32, stream: "
        + ", ".join(f"{k} {cos_s[k]:.5f} (square {cos_t[k]:.5f}; rel L2 stream "
                    f"{rel(s_g, k):.3e}, square {rel(t_g, k):.3e})" for k in worst))
    bad = [k for k in cos_s if cos_s[k] < TRAIN_COS_MIN <= cos_t[k]]
    if not forced or e_s > bound or bad:
        raise RuntimeError(f"{tag}: the stream kernel's masked split-P path disagrees: forced "
                           f"{len(forced)}, output err {e_s:.3e} (bound {bound:.3e}), gradients "
                           f"below the cosine bound where the square kernel's are not: {bad}")
    del block

    # (2) DAT's first-step gate at hd 45 (K16 on the square kernel at HDP 64)
    cfg = DATConfig(**DAT_HD45)
    hd = cfg.embed_dim // cfg.num_heads[0]
    n = cfg.split_size[0] * cfg.split_size[1]
    route = wa.k15_route(n, n, hd, True, wa.K16_SPLIT_P)
    src = build_model(cfg)
    src.reset_parameters(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 12)
    batch, patch = TRAIN_BATCH, TRAIN_LR_PATCH
    lr = torch.from_numpy(rng.random((batch, patch, patch, 3), dtype=np.float32)).cuda()
    hr = torch.from_numpy(rng.random((batch, 4 * patch, 4 * patch, 3), dtype=np.float32)).cuda()
    reset_counters()
    _first_step_gate(cfg, src, lr, hr, f"{tag} dat hd{hd}", smi, bf16_floor=True)
    launches = read_counters()
    log(f"[{tag}] DAT {DAT_HD45} (hd {hd}): masked K16 of {n} x {n} tokens takes the "
        f"\"{route}\" kernel; first-step gate launches {launches}")
    if route != "square" or not launches.get("K16"):
        raise RuntimeError(f"{tag}: the hd-{hd} gate did not run K16 on the square kernel "
                           f"(route {route}, launches {launches})")
    return launches


def phase_dat_gate_noise(smi):
    """How far DAT's first-step gate (``_first_step_gate`` with
    BF16_FLOOR, calibrated) tells K16 kernels apart: the DAT x4 train
    step's first gradients (DATConfig(), the dat-train phase's gate weights
    and batch) with K16 on its route, forced to the tiled kernel,
    replaced by its plain version rounded to bf16 (exact), by that
    rounding with 1-ulp mis-roundings at random places at the rates of
    the square and tiled kernels (2e-4, 2e-3; three fresh draws each),
    and by each wrong K16 of ``_k16_wrong``; the gate's verdict on each.
    A reading aid, not a check: not run by main()."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.core.config import DATConfig, build_model
    from tpu_superresolution_torch.kernels import window_attention as wa

    cfg = DATConfig()
    src = build_model(cfg)
    src.reset_parameters(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 5)
    batch, patch, scale = TRAIN_BATCH, TRAIN_LR_PATCH, 4
    lr = torch.from_numpy(rng.random((batch, patch, patch, 3), dtype=np.float32)).cuda()
    hr = torch.from_numpy(
        rng.random((batch, patch * scale, patch * scale, 3), dtype=np.float32)).cuda()
    launch = wa._launch

    def tiled(q, k, v, bias, mask, scale_, counter, split_p, route=None):
        return launch(q, k, v, bias, mask, scale_, counter, split_p, "tiled")

    variants = [("route (square)", launch), ("tiled", tiled),
                ("plain, exact rounding", _k16_misrounded(0.0, 0))]
    variants += [(f"plain, mis-rounded at {frac:g}, draw {seed}", _k16_misrounded(frac, seed))
                 for frac in (2e-4, 2e-3) for seed in (1, 2, 3)]
    variants += [(kind, _k16_wrong(kind)) for kind in K16_FAULTS]
    _first_step_gate(cfg, _dat_trained_size(src), lr, hr, "dat-gate-noise", smi, bf16_floor=True,
                     controls=[(label, k16, None) for label, k16 in variants])


def _dat_train_split(state, lr, hr, step_ms, smi):
    """Where one DAT train step spends its device time, under
    torch.profiler: the forward, backward and optimizer as ranges, K16,
    K11, K2 and K3/K4 forwards by kernel name, the rest by the range it
    ran in (the forward's plain ops: the GEMMs, BatchNorm, GELU, the
    partitions and pads; the backward: autograd of everything, K16's
    and K11's plain versions included), and the device's idle share."""
    from tpu_superresolution_torch.utils.profiling import device_split

    model = state.model
    model.train()
    try:
        split = device_split(lambda: _phased_step(state, lr, hr), host=True)
    except Exception as e:  # the profile is a reading aid, not a check
        log(f"[dat-train] profiler failed: {type(e).__name__}: {e}")
        return
    kernels, wall = split.kernels, split.wall_ms
    if not kernels:
        log("[dat-train] profiler: no device events recorded")
        return
    steps = ("step::forward", "step::backward", "step::optimizer")
    spans = split.ranges(steps, on_device=False)
    names = (("K16 forward (batched_attn_wg_kernel)", ("batched_attn_wg_kernel",)),
             ("K11 forward (dwconv3x3_rows_kernel / dwconv3x3_kernel)",
              ("dwconv3x3_rows_kernel", "dwconv3x3_kernel")),
             ("K2-K4 forwards", ("layernorm_bands", "layernorm_wide", "conv_nhwc")))
    by_span = (("step::forward", "other forward ops (GEMMs, BatchNorm, GELU, partitions, pads)"),
               ("step::backward", "backward (autograd; K16's, K11's, K2-K4's plain versions)"),
               ("step::optimizer", "optimizer (norm, clip, AdamW, EMA)"))
    groups = split.group(names, "other", spans, by_span)
    busy = sum(groups.values())
    idle = max(wall - busy, 0.0)
    log(f"[dat-train] profiled step: {wall:.2f} ms wall (profiler on, a synchronise after "
        f"each phase), {len(kernels)} device kernels, busy {busy:.2f} ms ({busy / wall:.1%}), "
        f"idle {idle:.2f} ms ({idle / wall:.1%}); against the unprofiled median step "
        f"{step_ms:.2f} ms: busy {busy / step_ms:.1%}, idle {max(step_ms - busy, 0.0):.2f} ms "
        f"({smi})")
    for g, t in groups.items():
        log(f"[dat-train]   {t:8.3f} ms  {t / wall:6.1%}  {g}")
    counts = {name: n for name, (n, _) in split.by_name().items()}
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:10]
    log(f"[dat-train] most launched device kernels: "
        f"{[(n[:60], c) for n, c in top]}")


def _hat_train_split(state, lr, hr, step_ms, smi, tag="hat-train", parts=None, by_span=None):
    """Where one HAT train step spends its device time, under
    torch.profiler: the forward's kernels by name (the block kernel K6 /
    K1, K8, K12, K2-K4) and its plain ops by the module range that
    launched them (the OCABs', the CABs' SE gates, the HABs' gathers);
    the backward by autograd node, each with the nodes nested in it: the
    block backward (K6b / K5) and K8b with their weight-gradient products
    and reductions, K12's and K2-K4's autograd-of-plain backwards, and
    the rest (the plain ops' backwards: products, SE gates, gathers,
    casts); the optimizer; and the device's idle share of the wall
    time."""
    import torch

    from tpu_superresolution_torch.models.hat import CAB, HAB, OCAB
    from tpu_superresolution_torch.utils.profiling import device_split, kernel_ms

    model = state.model
    parts = parts or {HAB: "hat::hab", CAB: "hat::cab", OCAB: "hat::ocab"}
    handles = _range_hooks(model, parts)
    model.train()
    try:
        split = device_split(lambda: _phased_step(state, lr, hr), host=True)
    except Exception as e:  # the profile is a reading aid, not a check
        log(f"[{tag}] profiler failed: {type(e).__name__}: {e}")
        return
    finally:
        for h in handles:
            h.remove()
    kernels, wall, events = split.kernels, split.wall_ms, split.events
    if not kernels:
        log(f"[{tag}] profiler: no device events recorded")
        return
    cpu = torch.autograd.DeviceType.CPU
    # the phases by their host-side spans, cut where one ends and the
    # next begins, so a kernel stamped a little outside its span still
    # counts in its phase
    host = {e.name: e.time_range for e in events
            if e.device_type == cpu and e.name.startswith("step::")}
    fwd_end, opt_start = host["step::forward"].end, host["step::optimizer"].start
    spans = split.ranges(list(parts.values()))
    fwd_names = (("forward K6 / K1 (swin_block_wg_kernel)", ("swin_block_wg_kernel",)),
                 ("forward K8 / K8w16 (ocab_win_heads_kernel, ocab_win_attn_kernel; "
                  "ocab_heads_kernel, ocab_attn_kernel; K5a's OCAB tail)",
                  ("ocab_win_heads_kernel", "ocab_win_attn_kernel", "ocab_heads_kernel",
                   "ocab_attn_kernel")
                  + tuple(f"swin_block_bwd_kernel<{ws}, {cp}, {hdp}, 4>" for ws in (7, 8, 16)
                          for cp, hdp in ((96, 16), (96, 32), (192, 32)))),
                 ("forward K7 (window_product_kernel, window_attn_stream_kernel)",
                  ("window_product_kernel", "window_attn_stream_kernel")),
                 ("forward K1t swin_tail_wg_kernel / swin_tail_kernel",
                  ("swin_tail_wg_kernel", "swin_tail_kernel")),
                 ("forward K12 cab_wgmma_kernel", ("cab_wgmma_kernel",)),
                 ("forward K2-K4", ("layernorm_bands", "layernorm_wide", "conv_nhwc")))
    by_span = by_span or (("hat::cab", "forward CAB SE gate (plain ops)"),
                          ("hat::ocab", "forward OCAB plain ops (qkv, proj, MLP, gathers)"),
                          ("hat::hab", "forward HAB plain ops (shift and partition gathers)"))
    bwd_nodes = (("backward K6b / K5 (per-window wgmma kernel, dW GEMM, ordered sums, fold)",
                  "SwinBlockFunctionBackward"),
                 ("backward K5w16 / K5r (K5a front / middle / tail, attention fwd / bwd, dW "
                  "GEMM, sums, packing, fold)", "WindowBlockFunctionBackward"),
                 ("backward K8b (K5a middle, attention bwd, dW GEMM, sums, fold)",
                  "OcabCoreFunctionBackward"),
                 ("backward K8bw16 (K5a middle, attention bwd, dW GEMM, sums, fold)",
                  "Ocab16FunctionBackward"),
                 ("backward K8bw16's gather (ocab_heads_bwd_kernel)",
                  "OcabHeadsFunctionBackward"),
                 ("backward K12 (autograd of the plain LN + CAB convs)",
                  "CabConvsFunctionBackward"),
                 ("backward K2-K4 (autograd of the plain versions)", "LayerNormFunctionBackward"),
                 ("backward K2-K4 (autograd of the plain versions)", "ConvFunctionBackward"))
    rest = "backward other nodes (plain-op backwards: products, SE gates, gathers, casts)"
    groups = dict.fromkeys([g for g, _ in fwd_names] + ["forward other ops"]
                           + [g for _, g in by_span] + [g for g, _ in bwd_nodes]
                           + [rest, "optimizer (norm, clip, AdamW)"], 0.0)
    bwd_total = 0.0
    for e in kernels:
        n, t = e.name, e.time_range.start
        if t <= fwd_end:
            inside = {name for a, b, name in spans if a <= t <= b}
            g = next((g for g, keys in fwd_names if any(k in n for k in keys)), None)
            g = g or next((g for span, g in by_span if span in inside), "forward other ops")
        elif t < opt_start:
            bwd_total += kernel_ms(e)
            continue
        else:
            g = "optimizer (norm, clip, AdamW)"
        groups[g] += kernel_ms(e)
    # the backward's kernels by the autograd node that launched them (the
    # plain versions' own autograd nodes nest inside a kernel's backward)
    prefix = "autograd::engine::evaluate_function: "

    def nested(e):
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith(prefix):
                return True
            p = p.cpu_parent
        return False

    node_ms = lambda e: (getattr(e, "device_time_total", None)
                         or getattr(e, "cuda_time_total", 0.0)) / 1e3
    named = 0.0
    for e in events:
        if e.device_type != cpu or not e.name.startswith(prefix) or nested(e):
            continue
        g = next((g for g, node in bwd_nodes if e.name[len(prefix):] == node), None)
        if g is not None:
            groups[g] += node_ms(e)
            named += node_ms(e)
    groups[rest] = max(bwd_total - named, 0.0)
    busy = sum(groups.values())
    idle = max(wall - busy, 0.0)
    log(f"[{tag}] profiled step: {wall:.2f} ms wall (profiler on, a synchronise after each "
        f"phase), {len(kernels)} device kernels, busy {busy:.2f} ms ({busy / wall:.1%}), idle "
        f"{idle:.2f} ms ({idle / wall:.1%}); against the unprofiled median step {step_ms:.2f} "
        f"ms: busy {busy / step_ms:.1%}, idle {max(step_ms - busy, 0.0):.2f} ms; backward "
        f"{bwd_total:.2f} ms of device time, {named:.2f} of it attributed to the kernels' "
        f"autograd nodes ({smi})")
    for g, t in groups.items():
        log(f"[{tag}]   {t:8.3f} ms  {t / wall:6.1%}  {g}")


def _range_hooks(model, parts):
    """Open a torch.profiler range named parts[type(m)] around every
    forward of a module m of those types; returns the hook handles."""
    from torch.profiler import record_function

    stack, handles = [], []
    for m in model.modules():
        if type(m) in parts:
            def enter(mod, args, name=parts[type(m)]):
                stack.append(record_function(name))
                stack[-1].__enter__()

            handles.append(m.register_forward_pre_hook(enter))
            handles.append(m.register_forward_hook(
                lambda mod, args, out: stack.pop().__exit__(None, None, None)))
    return handles


def _no_grad(fn):
    import torch

    with torch.no_grad():
        return fn()


def _phased_step(state, lr, hr):
    """One L1 train step in three profiler ranges (step::forward,
    step::backward, step::optimizer), each ending in a synchronise, so a
    device kernel starts inside the host-side span of the phase that
    launched it."""
    import torch
    from torch.profiler import record_function

    from tpu_superresolution_torch.train.engine import apply_gradients

    model = state.model
    state.optimizer.zero_grad(set_to_none=True)
    with record_function("step::forward"):
        loss = (model(lr, generator=torch.Generator().manual_seed(SEED)).float()
                - hr).abs().mean()
        torch.cuda.synchronize()
    with record_function("step::backward"):
        loss.backward()
        torch.cuda.synchronize()
    with record_function("step::optimizer"):
        apply_gradients(state)
        torch.cuda.synchronize()


def _packing_cost(model, k5w16=False, tag="train"):
    """What the block kernels' weight packing costs each train step:
    ``pack_block_tiles`` for every block, the forward's stream that K5 /
    K6b read too, or where K5w16 runs (`k5w16`: HAT-SRx4's HABs, whose
    forward is the K7 route) the stream that K5w16's backward packs once a
    step: device kernels and synchronised milliseconds for all blocks."""
    import torch

    from tpu_superresolution_torch.kernels.fused_block import pack_block_tiles
    from tpu_superresolution_torch.utils.profiling import device_split

    weights = [b.block_weights() for layer in model.layers
               for b in layer.residual_group.blocks]
    label = ("the tiled backward's (K5w16 / K5r; pack_block_tiles)" if k5w16 else
             "forward tiles (pack_block_tiles, read by K5 / K6b too)")
    for pack in (pack_block_tiles,):
        run = lambda: [pack(w) for w in weights]
        run()
        torch.cuda.synchronize()
        n = len(device_split(run).kernels)
        t0 = time.perf_counter()
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        log(f"[{tag}] block weight packing per step, {label}: {len(weights)} blocks, {n} device "
            f"kernels ({n / len(weights):.0f} per block), {ms:.2f} ms (host and device, "
            f"synchronised)")


def _profile_step(step, state, lr, hr, gen, tag="train"):
    """torch.profiler over one train step, device activity only (no host
    events to process): device time by kernel name and the step's CUDA
    kernel count (the weight packing's small ops included)."""
    from tpu_superresolution_torch.utils.profiling import device_split

    try:
        split = device_split(lambda: step(state, lr, hr, gen))
    except Exception as e:  # the profile is a reading aid, not a check
        log(f"[{tag}] profiler failed: {type(e).__name__}: {e}")
        return
    kernels, wall = split.kernels, split.wall_ms
    if not kernels:
        log(f"[{tag}] profiler: no device events recorded")
        return
    busy = split.busy_ms
    by_name = split.by_name()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    small = sum(n for n, t in by_name.values() if t / max(n, 1) < 0.01)
    log(f"[{tag}] profiled step: {wall:.2f} ms wall (profiler on), {len(kernels)} device "
        f"kernels, device busy {busy:.2f} ms ({busy / wall:.1%}); kernels under 10 us "
        f"each: {small}")
    for name, (n, t) in top:
        log(f"[{tag}]   {t:8.3f} ms  x{n:<4d} {name[:90]}")


# The CNN families (MS_ResUNet, UNet2D) and the data features that go
# with them.  MS_ResUNet x4 at the train CLI's defaults: batch 8 of 100^2
# HR patches (LR 25^2, bicubic-upscaled on the card), 2 epochs of 2
# steps (the second from the decoded-image cache); UNet2D (base 64, depth
# 4, residual) on the MRCCM set at --patch_size 128.  The CNNs run cuDNN
# convs and launch no hand-written kernel.
CNN_TRAIN_IMAGES, CNN_VALID_IMAGES, CNN_HR = 16, 2, 200
CNN_TIMED_STEPS = 6
# MS_ResUNet's evaluation: images of 1024^2, as the evaluate phase's, at
# batch 4, enough of them that the steady window (every batch after the
# first) lasts over CNN_EVAL_WINDOW_S seconds.
CNN_EVAL_IMAGES, CNN_EVAL_HR, CNN_EVAL_BATCH, CNN_EVAL_WINDOW_S = 32, 1024, 4, 1.0
# MRCCM volumes (classic .mat): LR 24 x 70 x 70 (--force_4x resizes each
# slice to 64^2), HR 24 x 256 x 256; split 20 / 2 / 2 by i % 10.
MRCCM_SLICES, MRCCM_LR, MRCCM_HR = 24, 70, 256
# MS_ResUNet's first step, bf16 vs the plain fp32 path (TF32 off) from
# the same weights and batch (the CNNs run no hand-written kernel: this
# holds the bf16 path itself): the loss within TRAIN_LOSS_RTOL and the
# whole gradient's norm within TRAIN_GNORM_RTOL (gross bounds: no planted
# fault reaches them); the whole gradient's cosine >= CNN_COS_ALL; the
# output's L2 error within CNN_OUT_REL of its spread about its mean;
# each BatchNorm's batch statistics within CNN_OWN_STATS (of the
# buffer's largest entry) of float64 statistics of the same layer's
# input.  The last three lie between the sound runs' largest reading and
# a planted fault's (CNN_FAULTS), read on an H100 from this step's
# weights, sound on the batch and three mirrorings of it, each fault on
# the batch: 1 - cosine 1.74e-4 - 1.91e-4 sound, 1.36e-3 with the
# transposed convs flipped; output 3.233e-2 - 3.283e-2 sound, 5.796e-2
# with the crop on the wrong side; statistics 9.8e-7 - 1.6e-6 sound,
# 3.28e-2 from bf16 sums.  Per-parameter cosines and the statistics
# against the fp32 run's do not separate these faults from bf16 noise,
# which the deep BatchNorms, a few pixels a channel, amplify.
CNN_COS_ALL, CNN_OUT_REL, CNN_OWN_STATS = 0.9995, 4.4e-2, 1e-4
# A CNN's dataset PSNR on the card against the plain fp32 model's
# (BASELINE.json): 0.05 dB, as the evaluate phase's.
CNN_PSNR_DB = 0.05


def _native_report(tag):
    """What the card's machine has for the native decoder and MRCCM's
    v7.3 branch, and whether the decoder builds; returns its reason or
    None."""
    import importlib.util
    import shutil

    from tpu_superresolution_torch.data import native_decode

    why = native_decode.unavailable_reason()
    log(f"[{tag}] g++ {shutil.which('g++')}, /usr/include/png.h "
        f"{os.path.exists('/usr/include/png.h')}, h5py "
        f"{'present' if importlib.util.find_spec('h5py') else 'absent'}; native decoder: "
        f"{native_decode.loaded_path() if why is None else f'unavailable ({why})'}")
    return why


def phase_cnn_data(workdir, smi):
    """MRCCM preparation through ``cli.prepare_mrccm.main(--force_4x)`` on
    classic .mat volumes (split counts, layout, 16-bit slices), then one
    batch of it decoded by the loader (the native decoder where it runs)
    against PIL.  Returns the dataset's root."""
    import numpy as np
    from scipy.io import savemat

    from tpu_superresolution_torch.cli.prepare_mrccm import main as prepare_main
    from tpu_superresolution_torch.data.decode import load_pair_batch
    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.data.loader import Loader

    tag = "cnn-data"
    why = _native_report(tag)
    rng = np.random.default_rng(SEED + 30)
    yy, xx = np.mgrid[0:MRCCM_HR, 0:MRCCM_HR] / MRCCM_HR
    hr = np.stack([np.sin(6 * yy + k) * np.cos(5 * xx - k) + 0.1 * rng.standard_normal(yy.shape)
                   for k in range(MRCCM_SLICES)]) * 900.0 + 1200.0
    lr = hr[:, 3::3, 3::3][:, :MRCCM_LR, :MRCCM_LR]  # 70^2: --force_4x resizes it to 64^2
    savemat(f"{workdir}/mrccm_lr.mat", {"vol": lr})
    savemat(f"{workdir}/mrccm_hr.mat", {"vol": hr})
    root = f"{workdir}/mrccm"
    t0 = time.perf_counter()
    counts = prepare_main(["--lr_mat", f"{workdir}/mrccm_lr.mat", "--hr",
                           f"ROCK={workdir}/mrccm_hr.mat", "--out_root", root, "--scale", "X4",
                           "--force_4x"])
    secs = time.perf_counter() - t0
    idx = PairedIndex(root, "train", "X4")
    from PIL import Image

    with Image.open(idx[0][0]) as a, Image.open(idx[0][1]) as b:
        sizes = (a.size, b.size)
    depths = tuple(open(p, "rb").read(25)[24] for p in idx[0])  # IHDR bit depth
    log(f"[{tag}] prepare_mrccm --force_4x: {counts} in {secs:.2f} s; slice pair "
        f"{sizes}, PNG bit depths {depths}")
    want = {"train": 20, "valid": 2, "test": 2}
    if counts != want or sizes != ((64, 64), (256, 256)) or depths != (16, 16):
        raise RuntimeError(f"{tag}: counts {counts} (want {want}), sizes {sizes}, bit depths "
                           f"{depths}")

    loader = Loader(idx, 8, num_threads=4, use_native="auto" if why else "always")
    got = next(iter(loader))
    pil = load_pair_batch([idx[i] for i in range(8)])
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, pil))
    log(f"[{tag}] first batch by the {loader.decoder} decoder vs PIL: max |diff| {err:.2e} "
        f"(bound 1e-6)")
    if err > 1e-6:
        raise RuntimeError(f"{tag}: decoded batch differs from PIL by {err}")
    return root


@contextlib.contextmanager
def _bn_stats_in_bf16():
    """Fault: BatchNorm's train-mode mean and E[x^2] taken and subtracted
    in x's dtype (bf16 sums) instead of fp32."""
    import torch

    from tpu_superresolution_torch.models.blocks import BatchNorm

    sound = BatchNorm.forward

    def forward(self, x):
        if not self.training:
            return sound(self, x)
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        var = (x.square().mean(axes) - mean.square()).clamp_min(0.0).float()
        mean = mean.float()
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        scale = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((x.float() - mean) * scale + self.bias.float()).to(x.dtype)

    BatchNorm.forward = forward
    try:
        yield
    finally:
        BatchNorm.forward = sound


@contextlib.contextmanager
def _crop_on_the_wrong_side():
    """Fault: MS_ResUNet's centre crop after each transposed conv takes
    its odd row and column off the top and left instead of the bottom
    and right."""
    from tpu_superresolution_torch.models import msresunet

    sound = msresunet.crop_like

    def crop_like(x, ref):
        h, w = x.shape[2], x.shape[3]
        dh, dw = h - ref.shape[2], w - ref.shape[3]
        return x[:, :, dh - dh // 2 : h - dh // 2, dw - dw // 2 : w - dw // 2]

    msresunet.crop_like = crop_like
    try:
        yield
    finally:
        msresunet.crop_like = sound


@contextlib.contextmanager
def _conv_transpose_flipped():
    """Fault: MS_ResUNet's transposed convs with their kernels flipped in
    space (flax's ConvTranspose convention where torch's is meant)."""
    import torch.nn.functional as F

    from tpu_superresolution_torch.models import msresunet
    from tpu_superresolution_torch.models.cnn import _weight

    sound = msresunet.conv_transpose

    def conv_transpose(m, x):
        bias = None if m.bias is None else m.bias.to(x.dtype)
        return F.conv_transpose2d(x, _weight(m, x.dtype).flip(2, 3), bias, m.stride, m.padding)

    msresunet.conv_transpose = conv_transpose
    try:
        yield
    finally:
        msresunet.conv_transpose = sound


# Faults planted in the bf16 run of MS_ResUNet's first step: the gate
# must fail each.
CNN_FAULTS = (("BatchNorm statistics from bf16 sums", _bn_stats_in_bf16),
              ("crop on the wrong side", _crop_on_the_wrong_side),
              ("transposed conv kernels flipped", _conv_transpose_flipped))


def _cnn_step_readings(model, lr, hr):
    """Loss, {name: grad}, the output and the worst relative gap between a
    BatchNorm's batch statistics and float64 statistics of its own input,
    of one train-mode forward / backward."""
    import torch

    from tpu_superresolution_torch.models.blocks import BatchNorm

    own = {}

    def record(bn, inputs, _):
        x = inputs[0].detach().double()
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        own[bn] = (mean, (x - mean).square().mean(axes))

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    hooks = [bn.register_forward_hook(record) for bn in bns]
    for bn in bns:
        bn.momentum = 1.0  # the running buffers then hold the batch statistics
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(lr).float()
    loss = (out - hr).abs().mean()
    loss.backward()
    for h in hooks:
        h.remove()
    grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
    gap = max(float((buf.double() - want).abs().max() / want.abs().max().clamp_min(1e-30))
              for bn, (mean, var) in own.items()
              for buf, want in ((bn.running_mean, mean), (bn.running_var, var)))
    return float(loss.detach()), grads, out.detach(), gap


def _cnn_first_step(cfg, state_dict, lr, hr, fault=contextlib.nullcontext):
    """The first train-mode step of `cfg` from `state_dict` on (lr, hr):
    bf16 (the train CLI's dtype on the card; run under `fault`) against
    the plain fp32 path.  Returns (the readings' line, the bounds
    broken)."""
    import torch

    from tpu_superresolution_torch.core.config import build_model

    runs = {}
    for label, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        model = build_model(cfg, dtype=dtype, device="cuda")
        model.load_state_dict(state_dict)
        with fault() if label == "bf16" else contextlib.nullcontext():
            runs[label] = _cnn_step_readings(model, lr, hr)
        del model
    (l16, g16, o16, gap), (l32, g32, o32, gap32) = runs["bf16"], runs["fp32"]
    flat16 = torch.cat([g.flatten() for g in g16.values()])
    flat32 = torch.cat([g32[n].flatten() for n in g16])
    cos_all = float((flat16 * flat32).sum() / (flat16.norm() * flat32.norm()))
    d_norm = abs(float(flat16.norm()) / float(flat32.norm()) - 1.0)
    d_out = float((o16 - o32).norm() / (o32 - o32.mean()).norm())
    d_loss = abs(l16 / l32 - 1.0)
    line = (f"loss {l16:.6f} / {l32:.6f} (rel {d_loss:.2e}, bound {TRAIN_LOSS_RTOL}); whole "
            f"gradient cosine {cos_all:.6f} (bound {CNN_COS_ALL}), norm rel {d_norm:.2e} (bound "
            f"{TRAIN_GNORM_RTOL}); output error {d_out:.3e} of its spread (bound "
            f"{CNN_OUT_REL}); BatchNorm statistics vs float64 of their input {gap:.2e} (bound "
            f"{CNN_OWN_STATS}; the fp32 run's {gap32:.2e})")
    broken = [name for name, bad in (("loss", d_loss > TRAIN_LOSS_RTOL),
                                     ("cosine", cos_all < CNN_COS_ALL),
                                     ("norm", d_norm > TRAIN_GNORM_RTOL),
                                     ("output", d_out > CNN_OUT_REL),
                                     ("statistics", gap > CNN_OWN_STATS)) if bad]
    return line, broken


def _cnn_gate(tag, cfg, state_dict, lr, hr, smi):
    """MS_ResUNet's first step, bf16 against the plain fp32 path, to the
    CNN_* bounds on the batch and three mirrorings of it; then on the
    batch with each of CNN_FAULTS planted in the bf16 run, which must
    break at least one bound."""
    draws = (("batch", lr, hr), ("flipped", lr.flip(1), hr.flip(1)),
             ("mirrored", lr.flip(2), hr.flip(2)),
             ("transposed", lr.transpose(1, 2), hr.transpose(1, 2)))
    for label, a, b in draws:
        line, broken = _cnn_first_step(cfg, state_dict, a, b)
        log(f"[{tag}] first step ({label}), bf16 vs plain fp32 (TF32 off): {line} ({smi})")
        if broken:
            raise RuntimeError(f"{tag}: the bf16 first step ({label}) disagrees with the plain "
                               f"fp32 path ({', '.join(broken)})")
    for name, fault in CNN_FAULTS:
        line, broken = _cnn_first_step(cfg, state_dict, lr, hr, fault)
        log(f"[{tag}] control, {name}: {line}; bounds broken: {broken or 'none'}")
        if not broken:
            raise RuntimeError(f"{tag}: the first-step gate passed a planted fault ({name})")


def phase_cnn_train(workdir, mrccm, smi):
    """MS_ResUNet x4 through ``cli.train.main`` with no --model
    (--do_blur --normalize --cache_decoded, 2 epochs, the CLI's default
    --patch_size 100 and --batch_size 8): the native decoder's calls in
    each epoch's training loop (epoch 2 from the cache), no kernel
    launch; the step's median time and images/s on a fixed batch; the
    first step against the plain fp32 path, and the same with planted
    faults.  Then UNet2D (--residual, --patch_size 128) for one epoch on
    the MRCCM set.  Returns MS_ResUNet's and UNet2D's best
    checkpoints."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.cli.train import main as train_main
    from tpu_superresolution_torch.data import native_decode
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.train.engine import make_train_step

    tag = "cnn-train"
    data = f"{workdir}/deeprock_cnn"
    _write_deeprock(data, CNN_TRAIN_IMAGES, CNN_VALID_IMAGES, hr_size=CNN_HR, scale=4,
                    seed=SEED + 31)
    reset_counters()
    native_decode.decodes.reset()
    t0 = time.perf_counter()
    trainer, state = train_main(["--data_root", data, "--scale", "X4", "--device", "cuda",
                                 "--do_blur", "--normalize", "--cache_decoded", "--epochs", "2",
                                 "--workdir", f"{workdir}/run_msresunet", "--seed", str(SEED)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counters()
    per_epoch = trainer.history["native_decodes"]
    dcfg = trainer.data_config
    log(f"[{tag}] train CLI with no --model: {trainer.model_config.name}, convention "
        f"{dcfg.convention}, patch {dcfg.patch_size}, batch {trainer.train_config.batch_size}, "
        f"blur {dcfg.do_blur}, normalized by ({dcfg.norm_mean:.6f}, {dcfg.norm_std:.6f}): "
        f"{state.step} steps + 2 validations in {cli_s:.1f} s; train loss "
        f"{trainer.history['train']}, val PSNR {trainer.best_val_psnr:.2f} dB (normalized "
        f"space); native decode calls in each epoch's training loop {per_epoch}, "
        f"{native_decode.decodes.count} in all (stats pass and validation included); kernel "
        f"launches {sum(launches.values())} ({smi})")
    if (trainer.model_config.name != "ms_resunet" or state.step != 4
            or not all(math.isfinite(v) for v in trainer.history["train"])):
        raise RuntimeError(f"{tag}: {trainer.model_config.name}, {state.step} steps, loss "
                           f"{trainer.history['train']}")
    if native_decode.available():
        if not (per_epoch[0] > 0 and per_epoch[1] == 0):
            raise RuntimeError(f"{tag}: native decodes per epoch {per_epoch}; want epoch 1 > 0 "
                               "and epoch 2 = 0 (the decoded-image cache)")
    else:
        log(f"[{tag}] native decoder unavailable here: the loader decoded with PIL")
    if any(launches.values()):
        raise RuntimeError(f"{tag}: the CNN path launched port kernels {launches}")
    ckpt = f"{workdir}/run_msresunet/best_X4.pth"
    norm = (dcfg.norm_mean, dcfg.norm_std)

    # the step on a fixed batch: median time, images/s
    rng = np.random.default_rng(SEED)
    lr = torch.from_numpy(rng.random((8, 25, 25, 1), dtype=np.float32)).cuda()
    hr = torch.from_numpy(rng.random((8, 100, 100, 1), dtype=np.float32)).cuda()
    step = make_train_step("mse", "pre_upscale", 4, 100, True, True, norm)
    gen = torch.Generator().manual_seed(SEED)
    for _ in range(3):
        step(state, lr, hr, gen)
    torch.cuda.synchronize()
    dts = []
    for _ in range(CNN_TIMED_STEPS):
        t0 = time.perf_counter()
        m = step(state, lr, hr, gen)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    ms = statistics.median(dts) * 1e3
    log(f"[{tag}] MS_ResUNet x4 train step (bf16, batch 8, 100^2, upscale + flips + blur + "
        f"normalize on the card): median {ms:.2f} ms over {CNN_TIMED_STEPS} steps after 3 "
        f"warm-up (min {min(dts) * 1e3:.2f}, max {max(dts) * 1e3:.2f}), {8 / ms * 1e3:.1f} "
        f"images/s; loss {float(m['loss']):.6f} ({smi})")
    _profile_step(step, state, lr, hr, gen, tag)

    # the first step, bf16 against the plain fp32 path, on an augmented batch
    from tpu_superresolution_torch.data.transforms import make_train_batch_preupscale, normalize

    a_lr, a_hr = make_train_batch_preupscale(lr, hr, 4, 100, True,
                                             torch.Generator().manual_seed(SEED + 1), True)
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    _cnn_gate(tag, trainer.model_config, sd, normalize(a_lr, *norm), normalize(a_hr, *norm),
              smi)
    del state, trainer

    # UNet2D (residual) on the MRCCM set
    t0 = time.perf_counter()
    u_trainer, u_state = train_main(["--data_root", mrccm, "--scale", "X4", "--device", "cuda",
                                     "--model", "unet2d", "--residual", "--patch_size", "128",
                                     "--epochs", "1", "--workdir", f"{workdir}/run_unet2d",
                                     "--seed", str(SEED)])
    torch.cuda.synchronize()
    ucfg = u_trainer.model_config
    log(f"[{tag}] train CLI --model unet2d --residual (base {ucfg.base_channels}, depth "
        f"{ucfg.depth}) on MRCCM, patch 128: {u_state.step} steps + validation in "
        f"{time.perf_counter() - t0:.1f} s; train loss {u_trainer.history['train'][0]:.6f}, val "
        f"PSNR {u_trainer.best_val_psnr:.2f} dB ({smi})")
    if u_state.step != 3 or not math.isfinite(u_trainer.history["train"][0]):
        raise RuntimeError(f"{tag}: unet2d {u_state.step} steps, {u_trainer.history}")
    return ckpt, f"{workdir}/run_unet2d/best_X4.pth"


def phase_cnn_evaluate(workdir, ckpt, unet_ckpt, mrccm, smi):
    """``cli.evaluate.main`` with no --model on the MS_ResUNet checkpoint
    (bicubic baseline on, CNN_EVAL_IMAGES test images of CNN_EVAL_HR^2 at
    batch CNN_EVAL_BATCH): its dataset PSNR against the same
    Evaluator.run of the plain fp32 model on the card, the steady MPix/s
    over a window of at least CNN_EVAL_WINDOW_S; then
    ``cli.upscale.main(--model unet2d)`` on one MRCCM test slice."""
    import torch
    from PIL import Image

    from tpu_superresolution_torch.cli.evaluate import main as evaluate_main
    from tpu_superresolution_torch.cli.upscale import load_port_checkpoint
    from tpu_superresolution_torch.cli.upscale import main as upscale_main
    from tpu_superresolution_torch.core.config import EvalConfig
    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.data.loader import Loader
    from tpu_superresolution_torch.evaluate import Evaluator
    from tpu_superresolution_torch.train.checkpoint import read_checkpoint

    tag = "cnn-evaluate"
    n, hr_size, batch = CNN_EVAL_IMAGES, CNN_EVAL_HR, CNN_EVAL_BATCH
    data = f"{workdir}/deeprock_cnn_eval"
    t0 = time.perf_counter()
    _write_deeprock(data, 0, 0, hr_size=hr_size, scale=4, seed=SEED + 33, n_test=n)
    log(f"[{tag}] wrote {n} test pairs of {hr_size}^2 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res = evaluate_main(["--data_root", data, "--scale", "X4", "--ckpt", ckpt, "--device", "cuda",
                         "--batch_size", str(batch), "--save_n", "1", "--save_dir",
                         f"{workdir}/cnn_preds", "--workers", "4"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    window_s = (n - batch) * hr_size ** 2 / 1e6 / res["mpix_per_s"]
    _, plain = load_port_checkpoint(ckpt, read_checkpoint(ckpt), None, None,
                                    torch.device("cuda"), torch.float32)
    t0 = time.perf_counter()
    ref = Evaluator(plain, 4, "pre_upscale", EvalConfig(batch_size=batch), log=lambda m: None,
                    device="cuda").run(Loader(PairedIndex(data, "test", "X4"), batch,
                                              num_threads=4))
    plain_s = time.perf_counter() - t0
    d = abs(res["psnr"] - ref["psnr"])
    log(f"[{tag}] evaluate CLI with no --model, MS_ResUNet x4, {res['n']} images {hr_size}^2, "
        f"batch {batch}, bicubic baseline on: PSNR {res['psnr']:.4f} dB, SSIM "
        f"{res['ssim']:.6f}, steady {res['mpix_per_s']:.3f} MPix/s over {window_s:.3f} s "
        f"({n // batch - 1} batches; bound >= {CNN_EVAL_WINDOW_S} s), wall {res['wall_s']:.3f} "
        f"s, compile_s {res['compile_s']:.3f} s, the CLI {cli_s:.1f} s; plain fp32 "
        f"{ref['psnr']:.4f} dB in {plain_s:.1f} s; |diff| {d:.4f} dB (bound {CNN_PSNR_DB}) "
        f"({smi})")
    if res["n"] != n or not math.isfinite(res["psnr"]) or d > CNN_PSNR_DB:
        raise RuntimeError(f"{tag}: MS_ResUNet evaluation {res} vs plain fp32 {ref['psnr']}")
    if window_s < CNN_EVAL_WINDOW_S:
        raise RuntimeError(f"{tag}: the steady window lasted {window_s:.3f} s, under "
                           f"{CNN_EVAL_WINDOW_S} s: raise CNN_EVAL_IMAGES")
    del plain

    lr_png = str(PairedIndex(mrccm, "test", "X4")[0][0])
    out = f"{workdir}/mrccm_sr.png"
    t0 = time.perf_counter()
    upscale_main(["--image", lr_png, "--ckpt", unet_ckpt, "--model", "unet2d", "--scale", "X4",
                  "--out", out, "--device", "cuda"])
    with Image.open(out) as im:
        size = im.size
    log(f"[{tag}] upscale --model unet2d on MRCCM slice {os.path.basename(lr_png)}: {size} in "
        f"{time.perf_counter() - t0:.2f} s (load and first call included) ({smi})")
    if size != (4 * 64, 4 * 64):
        raise RuntimeError(f"{tag}: upscaled size {size}")


def phase_swinir_data(workdir, smi):
    """SwinIR-M x4 through ``cli.train.main(--model swinir --do_blur
    --normalize --cache_decoded)``: 2 steps + validation; launches equal
    steps x TRAIN_PER_STEP + validation x PER_CALL (K1-K5 under the new
    data path).  Returns the launches."""
    import torch

    from tpu_superresolution_torch.cli.train import main as train_main
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    tag = "swinir-data"
    batch, patch = TRAIN_BATCH, TRAIN_LR_PATCH
    data = f"{workdir}/deeprock_swinir_data"
    _write_deeprock(data, 2 * batch, 2, hr_size=320, scale=4, seed=SEED + 32)
    reset_counters()
    t0 = time.perf_counter()
    trainer, state = train_main(["--model", "swinir", "--do_blur", "--normalize",
                                 "--cache_decoded", "--data_root", data, "--scale", "X4",
                                 "--device", "cuda", "--epochs", "1", "--batch_size", str(batch),
                                 "--patch_size", str(patch), "--loss", "l1", "--workdir",
                                 f"{workdir}/run_swinir_data", "--seed", str(SEED)])
    torch.cuda.synchronize()
    launches = read_counters()
    expect = {k: 2 * TRAIN_PER_STEP[k] + PER_CALL.get(k, 0) for k in TRAIN_PER_STEP}
    log(f"[{tag}] train CLI --model swinir --do_blur --normalize --cache_decoded, batch {batch}, "
        f"lr_patch {patch}: {state.step} steps + validation in {time.perf_counter() - t0:.1f} s; "
        f"train loss {trainer.history['train'][0]:.6f}; launches {launches} (expected {expect}) "
        f"({smi})")
    if state.step != 2 or not math.isfinite(trainer.history["train"][0]) or launches != expect:
        raise RuntimeError(f"{tag}: {state.step} steps, launches {launches}, expected {expect}")
    return launches


# Tracing, recomputation, the comparison / .mat / export CLIs and the
# A/B harness.  The remat leg trains SwinIR-M x4, HAT-SRx4 x4 and DAT x4
# at the train phases' batch (8 of 64^2 LR crops); compare runs DAT x4
# against SwinIR-M x4 on whole DeepRockSR-2D-sized test images (500^2
# HR, 125^2 LR); export holds the loaded program to the eager kernel
# path at the bench tile batch.
REMAT_TIMED_STEPS = 4
COMPARE_IMAGES, COMPARE_HR = 3, 500
MAT_SLICES, MAT_HR = 8, 256
ABLATE_ROWS, ABLATE_C, ABLATE_INNER, ABLATE_ROUNDS = 25 * 64 * 64, 180, 200, 7


def _seeded_swinir_m(in_channels=3):
    import torch

    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model

    cfg = SwinIRConfig(scale=4, in_channels=in_channels, out_channels=in_channels)
    src = build_model(cfg)
    src.reset_parameters(torch.Generator().manual_seed(SEED))
    return cfg, src


def _save_port_checkpoint(path, cfg, model):
    """`model`'s weights as a checkpoint of the port's train CLI
    (``train/checkpoint.py``'s layout, with no optimizer state)."""
    import torch

    torch.save({"params": model.state_dict(), "ema": None, "optimizer": {}, "step": 0,
                "config": cfg.to_dict(), "extra": {"epoch": 0, "ema_decay": 0.0}}, path)
    return path


def phase_trace(workdir, smi):
    """A one-epoch SwinIR-M x4 fine-tune through the finetune CLI with
    ``--trace``: the trace's spans ``epoch 1`` and ``val 1``, its counters
    ``train_loss`` and ``val_psnr``, every span's dur >= 0, the launches
    (steps x TRAIN_PER_STEP + one validation call).  Returns them."""
    import torch

    from tpu_superresolution_torch.cli.finetune import main as finetune_main
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    tag = "trace"
    batch, patch = TRAIN_BATCH, TRAIN_LR_PATCH
    n_train, n_valid = 2 * batch, 2
    data = f"{workdir}/deeprock_trace"
    _write_deeprock(data, n_train, n_valid, hr_size=320, scale=4, seed=SEED + 40)
    _, src = _seeded_swinir_m()
    weights = f"{workdir}/swinir_trace.pth"
    torch.save({"params": src.state_dict()}, weights)
    trace = f"{workdir}/timeline.json"
    reset_counters()
    t0 = time.perf_counter()
    finetune_main(["--data_root", data, "--scale", "X4", "--weights", weights, "--epochs", "1",
                   "--batch_size", str(batch), "--lr_patch", str(patch), "--workdir",
                   f"{workdir}/trace_run", "--seed", str(SEED), "--device", "cuda",
                   "--trace", trace])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counters()
    expect = {k: n_train // batch * TRAIN_PER_STEP[k] + PER_CALL.get(k, 0)
              for k in TRAIN_PER_STEP}
    doc = json.loads(open(trace).read())
    evs = doc["traceEvents"]
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    counters = {k: e["args"][k] for e in evs if e["ph"] == "C" for k in e["args"]}
    tracks = {e["tid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    log(f"[{tag}] finetune CLI --trace, SwinIR-M x4, batch {batch}, lr_patch {patch}, "
        f"{n_train // batch} steps + validation in {secs:.1f} s: span 'epoch 1' "
        f"{spans.get('epoch 1', {}).get('dur', float('nan')) / 1e3:.1f} ms on track "
        f"{tracks.get(spans.get('epoch 1', {}).get('tid'))}, span 'val 1' "
        f"{spans.get('val 1', {}).get('dur', float('nan')) / 1e3:.1f} ms, counters {counters}; "
        f"{len(evs)} events, displayTimeUnit {doc.get('displayTimeUnit')}; launches {launches} "
        f"({smi})")
    if (set(spans) != {"epoch 1", "val 1"} or set(counters) != {"train_loss", "val_psnr"}
            or any(e["dur"] < 0 for e in spans.values())
            or tracks.get(spans["epoch 1"]["tid"]) != "train"
            or tracks.get(spans["val 1"]["tid"]) != "val"
            or not all(math.isfinite(v) for v in counters.values())):
        raise RuntimeError(f"{tag}: spans {sorted(spans)}, counters {counters}, tracks {tracks}")
    if launches != expect:
        raise RuntimeError(f"{tag}: launches {launches}, expected {expect}")
    return launches


def _remat_run(cfg, src, lr, hr, remat):
    """One train-mode forward / backward (L1, the stochastic-depth masks
    from a generator of seed SEED) of `cfg` with ``use_remat`` = `remat`
    from `src`'s weights, bf16 on the kernels: (loss, {name: grad},
    {name: BatchNorm running statistic}, launches, peak bytes of the
    step, (count, bytes) of the tensors the forward saved for the
    backward outside a recomputed region, a tensor saved twice counted
    twice)."""
    import dataclasses

    import torch

    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    model = build_model(dataclasses.replace(cfg, use_remat=remat), dtype=torch.bfloat16,
                        device="cuda")
    model.load_state_dict(src.state_dict())
    model.train()
    kept = [0, 0]

    def pack(t):
        kept[0] += 1
        kept[1] += t.numel() * t.element_size()
        return t

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counters()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = model(lr, generator=torch.Generator().manual_seed(SEED)).float()
        loss = (out - hr).abs().mean()
    loss.backward()
    torch.cuda.synchronize()
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated() - base
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    del model, out
    return loss.detach(), grads, stats, launches, peak, tuple(kept)


def _remat_steps(cfg, src, lr, hr, steps):
    """Full train steps (``make_train_step``: forward, backward, clip,
    AdamW) of `cfg` without and with ``use_remat``: each setting's
    ``max_memory_allocated`` over a step after a warm-up step, one model
    alive at a time (the peak reset between them), then the median ms of
    `steps` steps of each, interleaved (without, with, without, ...) on
    the two models held together, so that the host's drift falls on both.
    Returns ((ms, peak bytes) without, (ms, peak bytes) with)."""
    import dataclasses

    import torch

    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.train.engine import make_train_step

    step = make_train_step("l1", "native_lr", 4, TRAIN_LR_PATCH, False)

    def fresh(remat):
        model = build_model(dataclasses.replace(cfg, use_remat=remat), dtype=torch.bfloat16,
                            device="cuda")
        model.load_state_dict(src.state_dict())
        st, gen = _train_state(model, steps + 2), torch.Generator().manual_seed(SEED)
        step(st, lr, hr, gen)
        torch.cuda.synchronize()
        return st, gen

    peaks = []
    for remat in (False, True):
        st, gen = fresh(remat)
        torch.cuda.reset_peak_memory_stats()
        step(st, lr, hr, gen)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        del st
    runs = [fresh(remat) for remat in (False, True)]
    dts = ([], [])
    for _ in range(steps):
        for (st, gen), dt in zip(runs, dts):
            t0 = time.perf_counter()
            step(st, lr, hr, gen)
            torch.cuda.synchronize()
            dt.append(time.perf_counter() - t0)
    del runs
    return tuple((statistics.median(dt) * 1e3, peak) for dt, peak in zip(dts, peaks))


def phase_remat(smi):
    """``use_remat`` on the card: one train step (batch 8 of 64^2 LR
    crops, drop path on) of SwinIR-M x4 (the block kernel: K1 / K5),
    HAT-SRx4 x4 (the K7 route: K7 and K1t forward, K5w16 backward, K12
    CABs) and DAT x4 (the module chain) from the same weights, batch and
    generator, without recomputation, with it, and without it again (the
    run-to-run floor).  The loss and every gradient with it must equal
    those without it: bit for bit where two runs without it agree bit for
    bit, else within 4x their difference (a backward whose sums run in a
    nondeterministic order); DAT's BatchNorm running statistics
    likewise.  SwinIR-M's and HAT-SRx4's blocks train on block kernels'
    autograd functions, which keep only the blocks' inputs and recompute
    the rest in their backward kernels, so ``use_remat`` leaves them
    alone (``SwinBlock.trains_on_block_kernel``): every launch count and
    the tensors saved for the backward (count and bytes) must be the same
    with it.  DAT's module chain is recomputed (K16 and K11 twice
    forward): fewer bytes must be saved, and its step peaks must be
    lower.  Each setting's step peak memory and median step time over
    REMAT_TIMED_STEPS, the two settings' steps interleaved
    (``_remat_steps``), are printed.  Returns the launches of the
    runs."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.core.config import DATConfig, build_model

    tag = "remat"
    batch, patch, scale = TRAIN_BATCH, TRAIN_LR_PATCH, 4
    rng = np.random.default_rng(SEED + 41)
    lr = torch.from_numpy(rng.random((batch, patch, patch, 3), dtype=np.float32)).cuda()
    hr = torch.from_numpy(
        rng.random((batch, patch * scale, patch * scale, 3), dtype=np.float32)).cuda()
    legs = [("SwinIR-M x4", *_seeded_swinir_m())]
    for name, cfg in (("HAT-SRx4 x4", hat_srx4_config()), ("DAT x4", DATConfig())):
        src = build_model(cfg)
        src.reset_parameters(torch.Generator().manual_seed(SEED))
        legs.append((name, cfg, src))
    total = {}
    for name, cfg, src in legs:
        chain = name.startswith("DAT")
        a = _remat_run(cfg, src, lr, hr, False)
        b = _remat_run(cfg, src, lr, hr, True)
        a2 = _remat_run(cfg, src, lr, hr, False)
        worst, floor_bad = 0.0, []
        for field, (da, db, da2) in (("grad", (a[1], b[1], a2[1])),
                                     ("stat", (a[2], b[2], a2[2]))):
            for k in da:
                d_ab = float((da[k].float() - db[k].float()).abs().max())
                d_aa = float((da[k].float() - da2[k].float()).abs().max())
                worst = max(worst, d_ab)
                if d_ab > 4 * d_aa:
                    floor_bad.append((field, k, d_ab, d_aa))
        loss_same = bool(torch.equal(a[0], b[0]))
        n_bitwise = sum(torch.equal(a[1][k], b[1][k]) for k in a[1])
        n_floor = sum(torch.equal(a[1][k], a2[1][k]) for k in a[1])
        log(f"[{tag}] {name} one train step, batch {batch}, LR {patch}^2: loss "
            f"{float(a[0]):.6f} without recomputation, {float(b[0]):.6f} with "
            f"({'bit-identical' if loss_same else 'differs'}); gradients bit-identical "
            f"{n_bitwise} of {len(a[1])} (two runs without it: {n_floor} of {len(a[1])}), "
            f"worst max |diff| {worst:.3e}; BatchNorm statistics bit-identical "
            f"{sum(torch.equal(a[2][k], b[2][k]) for k in a[2])} of {len(a[2])}; launches "
            f"without {{{', '.join(f'{k}: {v}' for k, v in a[3].items() if v)}}}, with "
            f"{{{', '.join(f'{k}: {v}' for k, v in b[3].items() if v)}}}; saved for the "
            f"backward {a[5][0]} tensors of {a[5][1] / 2**20:.1f} MiB without, {b[5][0]} of "
            f"{b[5][1] / 2**20:.1f} MiB with; step peak {a[4] / 2**20:.1f} MiB without, "
            f"{b[4] / 2**20:.1f} MiB with ({smi})")
        if not loss_same or floor_bad:
            raise RuntimeError(f"{tag} {name}: loss {float(a[0])} vs {float(b[0])}; past the "
                               f"run-to-run floor: {floor_bad[:5]}")
        if chain and not (b[3]["K16"] == 2 * a[3]["K16"] and b[3]["K11"] == 2 * a[3]["K11"]
                          and b[5][1] < a[5][1]):
            raise RuntimeError(f"{tag} {name}: the module chain was not recomputed: {b[3]}, "
                               f"saved {b[5]} vs {a[5]}")
        if not chain and (a[3] != b[3] or a[5] != b[5]):
            raise RuntimeError(f"{tag} {name}: the run changed: launches {a[3]} vs {b[3]}, "
                               f"saved {a[5]} vs {b[5]}")
        (ms_a, peak_a), (ms_b, peak_b) = _remat_steps(cfg, src, lr, hr, REMAT_TIMED_STEPS)
        log(f"[{tag}] {name} train steps (forward, backward, clip, AdamW), median of "
            f"{REMAT_TIMED_STEPS} each, interleaved: {ms_a:.2f} ms without recomputation, "
            f"{ms_b:.2f} ms with ({ms_b / ms_a:.3f}x); max_memory_allocated "
            f"{peak_a / 2**20:.1f} MiB without, {peak_b / 2**20:.1f} MiB with "
            f"({peak_b / peak_a:.3f}x) ({smi})")
        if chain and not (peak_b < peak_a and b[4] < a[4]):
            raise RuntimeError(f"{tag} {name}: the remat peak is not lower: steps {peak_b} vs "
                               f"{peak_a}, one step {b[4]} vs {a[4]}")
        for d in (a[3], b[3], a2[3]):
            for k, v in d.items():
                total[k] = total.get(k, 0) + v
    return total


def phase_compare(workdir, smi):
    """``cli.compare.main`` on the card, DAT x4 (DATConfig()) against
    SwinIR-M x4 from seeded weights saved as the port's checkpoints, on a
    synthetic test split of COMPARE_IMAGES DeepRockSR-2D-sized images
    (500^2 HR, 125^2 LR: whole-image forwards, SwinIR padding to 128 and
    DAT to its split's multiple): the panel files and sizes, the PSNR /
    SSIM, and each side's SR against its ``impl="plain"`` fp32 forward
    (>= PSNR_MIN_DB).  Returns the launches."""
    import torch

    from tpu_superresolution_torch.cli.compare import main as compare_main
    from tpu_superresolution_torch.core.config import DATConfig, build_model
    from tpu_superresolution_torch.data.decode import decode_image
    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    tag = "compare"
    data = f"{workdir}/deeprock_compare"
    _write_deeprock(data, 0, 0, hr_size=COMPARE_HR, scale=4, seed=SEED + 42,
                    n_test=COMPARE_IMAGES)
    cfg_s, src_s = _seeded_swinir_m()
    cfg_d = DATConfig()
    src_d = build_model(cfg_d)
    src_d.reset_parameters(torch.Generator().manual_seed(SEED))
    ck_s = _save_port_checkpoint(f"{workdir}/swinir_m_x4.pth", cfg_s, src_s)
    ck_d = _save_port_checkpoint(f"{workdir}/dat_x4.pth", cfg_d, src_d)
    out_dir = f"{workdir}/report"
    reset_counters()
    t0 = time.perf_counter()
    stats = compare_main(["--data_root", data, "--scale", "X4", "--ckpt_a", ck_d, "--ckpt_b",
                          ck_s, "--indices", ",".join(map(str, range(COMPARE_IMAGES))),
                          "--out_dir", out_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counters()
    from PIL import Image

    pngs = sorted(os.listdir(out_dir))
    sizes = set()
    for n in pngs:
        with Image.open(f"{out_dir}/{n}") as im:
            sizes.add(im.size)
    want_size = (5 * COMPARE_HR + 4 * 8, COMPARE_HR + 16)
    log(f"[{tag}] compare CLI, DAT x4 vs SwinIR-M x4, {COMPARE_IMAGES} images of "
        f"{COMPARE_HR}^2 HR / {COMPARE_HR // 4}^2 LR, whole image, in {secs:.1f} s (first "
        f"calls included): panels {pngs} of {sorted(sizes)}; "
        + "; ".join(f"{k}: PSNR {statistics.mean(v['psnr']):.4f} dB SSIM "
                    f"{statistics.mean(v['ssim']):.6f}" for k, v in stats.items())
        + f"; launches {launches} ({smi})")
    idx = PairedIndex(data, "test", "X4")
    want_pngs = sorted(f"dat_vs_swinir_x4_{os.path.splitext(os.path.basename(h))[0]}.png"
                       for _, h in idx.pairs)
    if pngs != want_pngs or sizes != {want_size} or sorted(stats) != ["dat", "swinir"]:
        raise RuntimeError(f"{tag}: panels {pngs} (want {want_pngs}), sizes {sizes}, "
                           f"labels {sorted(stats)}")
    if not (launches["K1"] and launches["K9"] and launches["K14"] and launches["K10"]):
        raise RuntimeError(f"{tag}: the kernels did not serve both models: {launches}")
    for label, cfg, src in (("dat", cfg_d, src_d), ("swinir", cfg_s, src_s)):
        plain = build_model(cfg, dtype=torch.float32, impl="plain", device="cuda")
        plain.load_state_dict(src.state_dict())
        psnrs = []
        with torch.no_grad():
            for i, (lr_path, _) in enumerate(idx.pairs[:COMPARE_IMAGES]):
                lr = torch.from_numpy(decode_image(lr_path, grayscale=False, channels=3))[None]
                ref = plain(lr.cuda()).float().cpu()[0]
                psnrs.append(_psnr_db(torch.from_numpy(stats[label]["sr"][i]), ref))
        del plain
        log(f"[{tag}] {label}: each image's SR vs the plain fp32 forward: PSNR "
            f"{', '.join(f'{p:.2f}' for p in psnrs)} dB (bound >= {PSNR_MIN_DB})")
        if min(psnrs) < PSNR_MIN_DB:
            raise RuntimeError(f"{tag} {label}: SR disagrees with the plain fp32 path")
    return launches


def phase_mat_eval(workdir, smi):
    """``cli.mat_eval.main`` on the card on classic .mat volumes
    (``scipy.io.savemat``; MAT_SLICES slices of MAT_HR^2, LR the 4x
    subsample) with a single-channel SwinIR-M x4 (the volumes are
    grayscale) saved as the port's checkpoint, ``--tile 64 --tile_overlap
    8``: its [baseline] and [result] lines, and the result against
    Evaluator.run of the plain fp32 model (within EVAL_PSNR_DB /
    EVAL_SSIM).  Returns the launches."""
    import numpy as np
    import torch
    from scipy.io import savemat

    from tpu_superresolution_torch.cli.mat_eval import _batches
    from tpu_superresolution_torch.cli.mat_eval import main as mat_eval_main
    from tpu_superresolution_torch.core.config import EvalConfig, build_model
    from tpu_superresolution_torch.data.mrccm import mat_volume_pairs
    from tpu_superresolution_torch.evaluate.runner import Evaluator
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    tag = "mat-eval"
    rng = np.random.default_rng(SEED + 43)
    yy, xx = np.mgrid[0:MAT_HR, 0:MAT_HR] / MAT_HR
    hr = np.stack([np.sin(7 * yy + k) * np.cos(4 * xx - k) + 0.1 * rng.standard_normal(yy.shape)
                   for k in range(MAT_SLICES)]) * 800.0 + 1500.0
    savemat(f"{workdir}/mat_hr.mat", {"vol": hr})
    savemat(f"{workdir}/mat_lr.mat", {"vol": hr[:, ::4, ::4].copy()})
    cfg, src = _seeded_swinir_m(in_channels=1)
    ckpt = _save_port_checkpoint(f"{workdir}/swinir_m_x4_gray.pth", cfg, src)
    argv = ["--hr_mat", f"{workdir}/mat_hr.mat", "--lr_mat", f"{workdir}/mat_lr.mat", "--ckpt",
            ckpt, "--batch_size", "4", "--scale", "X4", "--tile", "64", "--tile_overlap", "8",
            "--device", "cuda"]
    buf = io.StringIO()
    reset_counters()
    with contextlib.redirect_stdout(buf):
        res = mat_eval_main(argv)
    torch.cuda.synchronize()
    launches = read_counters()
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith(("[baseline]",
                                                                           "[result]"))]
    lr, hrv = mat_volume_pairs(f"{workdir}/mat_lr.mat", f"{workdir}/mat_hr.mat")
    plain = build_model(cfg, dtype=torch.float32, impl="plain", device="cuda")
    plain.load_state_dict(src.state_dict())
    ref = Evaluator(plain, 4, "native_lr", EvalConfig(batch_size=4, tile_size=64,
                                                      tile_overlap=8), log=lambda m: None,
                    device="cuda").run(_batches(lr, hrv, 4))
    del plain
    d_psnr, d_ssim = abs(res["psnr"] - ref["psnr"]), abs(res["ssim"] - ref["ssim"])
    log(f"[{tag}] mat_eval CLI, SwinIR-M x4 (1 channel), {MAT_SLICES} slices {MAT_HR}^2, tile "
        f"64/8: {' | '.join(lines)}; mpix_per_s {res['mpix_per_s']:.3f}; vs the plain fp32 "
        f"path: PSNR {d_psnr:.4f} dB (bound {EVAL_PSNR_DB}), SSIM {d_ssim:.2e} (bound "
        f"{EVAL_SSIM}); launches {launches} ({smi})")
    if (len(lines) != 2 or res["n"] != MAT_SLICES or d_psnr > EVAL_PSNR_DB
            or d_ssim > EVAL_SSIM or not launches["K1"]):
        raise RuntimeError(f"{tag}: lines {lines}, result {res}, plain {ref}, launches "
                           f"{launches}")
    return launches


# DAT x4 at C 240 (DATConfig() otherwise, its depth cut to 6 groups of 2
# blocks: the odd groups' first block shifted): past rect_ok's, chan_ok's
# and tail_ok's C <= 192, so every block runs the module chain at
# inference: per block K2 for LN1, LN2 and the gate's norm (36) and K11
# for the conv branch and the gate's conv (24), per spatial block K16 for
# each rect branch (12); K2 for before_RG and norm; K3 for the 6 group
# convs, conv_after_body and conv_before_upsample; K4 for the composed
# reconstruction.
DAT_CHAIN_DEPTHS = (2,) * 6
DAT_CHAIN_PER_CALL = dict(PER_CALL, K1=0, K2=38, K3=8, K4=1, K11=24, K16=12)
# The CNN families (pre-upscaled input; no hand-written kernel on their
# path): no launch.
CNN_PER_CALL = {k: 0 for k in PER_CALL}


def _export_families():
    """(label, config, input shape, per-call launches) of each family the
    export phase takes beside SwinIR-M x4: the SR models at the bench tile
    batch [25, 64, 64, 3], the CNNs on the same tiles pre-upscaled x4."""
    import dataclasses

    from tpu_superresolution_torch.core.config import (
        DATConfig,
        HATConfig,
        HATFastConfig,
        MSResUNetConfig,
        SwinIRConfig,
        UNet2DConfig,
    )

    tiles, pre = (25, 64, 64, 3), (25, 256, 256, 1)
    return [
        ("HAT x4 (ws 7)", HATConfig(), tiles, HAT_PER_CALL),
        ("hat_fast (ws 8)", HATFastConfig(), tiles, HAT_FAST_PER_CALL),
        ("HAT-SRx4 (ws 16)", hat_srx4_config(), tiles, HAT_SRX4_PER_CALL),
        ("DAT x4", DATConfig(), tiles, DAT_PER_CALL),
        ("DAT x4 published (8, 32)", DATConfig(split_size=(8, 32), expansion_factor=4.0), tiles,
         DAT_X4_PER_CALL),
        ("DAT x4 C 240 (module chain, depths 6x2)",
         DATConfig(embed_dim=240, depths=DAT_CHAIN_DEPTHS), tiles, DAT_CHAIN_PER_CALL),
        ("SwinIR-M x4 ws 7", dataclasses.replace(SwinIRConfig(scale=4), window_size=7), tiles,
         SWINIR_WS7_PER_CALL),
        ("SwinIR-L x4", swinir_l_config(), tiles, SWINIR_L_PER_CALL),
        ("MS_ResUNet x4", MSResUNetConfig(), pre, CNN_PER_CALL),
        ("UNet2D", UNet2DConfig(), pre, CNN_PER_CALL),
    ]


def _dispatched_ops(fn):
    """The aten ops one call of fn() dispatches (``TorchDispatchMode``):
    {"aten": all of them, "aten.<name>": each}; the kernels' direct
    launches are no aten op."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func.overloadpacket)
            if name.startswith("aten."):
                self.seen["aten"] += 1
                self.seen[name] += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.seen


def _export_family(label, cfg, shape, per_call, smi, tag="export", state=None):
    """One family through ``interop.export`` on the card (seeded random
    weights, DAT's BatchNorm statistics perturbed; or `state`'s; bf16): export and load
    the program, then on a seeded input the loaded program bit-identical
    to the eager kernel path, the launches of a call of each exactly
    `per_call`, the output within PSNR_MIN_DB of the plain fp32 path;
    the export's seconds and size, a call's ms loaded against eager and
    the device busy time of one profiled call of each.  Returns the
    loaded program's launches."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.interop.export import export_model, load_exported
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.utils.profiling import device_split

    t_leg = time.perf_counter()
    src = build_model(cfg)
    if state is not None:
        src.load_state_dict(state)
    else:
        src.reset_parameters(torch.Generator().manual_seed(SEED))
        if cfg.name == "dat":
            _perturb_dat(src, torch.Generator().manual_seed(SEED + 5))
    model = build_model(cfg, dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(src.state_dict())
    t0 = time.perf_counter()
    blob = export_model(model, shape, dtype=torch.bfloat16)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn = load_exported(blob)
    t_load = time.perf_counter() - t0
    x = torch.from_numpy(np.random.default_rng(SEED + 45).random(shape, np.float32)).to(
        "cuda", torch.bfloat16)
    counts = {}
    with torch.no_grad():
        fn(x)  # warm: the program's own first call
        for name, run in (("eager", model), ("program", fn)):
            torch.cuda.synchronize()
            reset_counters()
            out = run(x)
            torch.cuda.synchronize()
            counts[name] = read_counters()
            if name == "eager":
                eager = out
        got = out
        prog_ms = cuda_ms(lambda: fn(x), iters=5, warmup=1)
        eager_ms = cuda_ms(lambda: model(x), iters=5, warmup=1)
        busy = {name: device_split(run).busy_ms
                for name, run in (("program", lambda: fn(x)), ("eager", lambda: model(x)))}
        ops = {name: _dispatched_ops(run) for name, run in (("program", lambda: fn(x)),
                                                             ("eager", lambda: model(x)))}
    del model
    plain = build_model(cfg, dtype=torch.float32, impl="plain", device="cuda")
    plain.load_state_dict(src.state_dict())
    with torch.no_grad():
        ref = plain(x.float())
    del plain
    torch.cuda.empty_cache()
    psnr = _psnr_db(got, ref)
    same = bool(torch.equal(got, eager))
    finite = bool(torch.isfinite(got.float()).all())
    expect = {k: per_call.get(k, 0) for k in counts["program"]}
    nonzero = lambda d: {k: n for k, n in d.items() if n}
    log(f"[{tag}] {label} {list(shape)} bf16: export {len(blob) / 2**20:.1f} MiB in "
        f"{t_export:.1f} s, load {t_load:.1f} s; the loaded program vs the eager kernel path "
        f"{'bit-identical' if same else 'differs'}, vs plain fp32 PSNR {psnr:.2f} dB (bound >= "
        f"{PSNR_MIN_DB}); launches a call: program {nonzero(counts['program'])}, eager "
        f"{nonzero(counts['eager'])}; a call {prog_ms:.3f} ms loaded, {eager_ms:.3f} ms eager (median of "
        f"5), the device busy {busy['program']:.3f} / {busy['eager']:.3f} ms of one profiled "
        f"call; aten ops a call {ops['program']['aten']} loaded (of them "
        f"{ops['program']['aten._assert_tensor_metadata']} aten._assert_tensor_metadata), "
        f"{ops['eager']['aten']} eager; the leg {time.perf_counter() - t_leg:.1f} s ({smi})")
    if (not same or not finite or counts["program"] != expect or counts["eager"] != expect
            or psnr < PSNR_MIN_DB):
        raise RuntimeError(f"{tag}: {label}: same {same}, finite {finite}, launches "
                           f"{counts} (expected {expect}), PSNR {psnr}")
    return counts["program"]


def _op_dispatch_us(smi, tag="export", calls=200, rounds=3):
    """The host cost of a launch through its custom op against the
    wrapper's direct launch: K2 on a [64, 180] bf16 tensor (device time
    ~µs, so the host's time is what is read), `calls` back to back a
    round, the two interleaved over `rounds`; µs a call, the best round
    of each."""
    import torch

    from tpu_superresolution_torch.kernels import layernorm

    x = torch.rand(64, 180, device="cuda").bfloat16()
    g, b = torch.ones(180, device="cuda"), torch.zeros(180, device="cuda")
    runs = {"op": lambda: torch.ops.tpu_sr.layernorm(x, g, b, layernorm.EPS),
            "direct": lambda: layernorm._launch(x, g, b, layernorm.EPS)}
    if not torch.equal(runs["op"](), runs["direct"]()):
        raise RuntimeError(f"{tag}: the K2 op differs from its direct launch")
    best = {k: float("inf") for k in runs}
    for _ in range(rounds):
        for k, run in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
            best[k] = min(best[k], (time.perf_counter() - t0) / calls * 1e6)
    log(f"[{tag}] host cost of a K2 launch at [64, 180] ({calls} calls back to back, best of "
        f"{rounds} interleaved rounds): through tpu_sr::layernorm {best['op']:.1f} us, direct "
        f"{best['direct']:.1f} us ({smi})")


def phase_export(smi):
    """``interop.export`` on the card.  SwinIR-M x4 (serving semantics,
    bf16) exported at the bench tile batch [25, 64, 64, 3] with K1-K4 as
    the tpu_sr:: custom ops; ``export_parity`` (the loaded program
    against the eager kernel path: 0 max abs), then the loaded program
    on a seeded input: bit-identical to the eager kernel path, its
    launches exactly PER_CALL, within PSNR_MIN_DB of the plain fp32
    path.  Then each family of ``_export_families`` (HAT x4, hat_fast,
    HAT-SRx4, DAT x4, the published DAT x4, a DAT on the module chain,
    SwinIR at ws 7, SwinIR-L, MS_ResUNet, UNet2D) through
    ``_export_family``'s checks.  Returns the loaded programs' launches,
    summed."""
    import dataclasses

    import torch

    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.interop.export import export_model, export_parity, load_exported
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    tag = "export"
    t_phase = time.perf_counter()
    cfg, src = _seeded_swinir_m()
    cfg = dataclasses.replace(cfg, fused_reconstruct=True)
    model = build_model(cfg, dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(src.state_dict())
    shape = (25, 64, 64, 3)
    t0 = time.perf_counter()
    max_abs, mean_abs = export_parity(model, shape, torch.bfloat16, seed=SEED)
    t_parity = time.perf_counter() - t0
    t0 = time.perf_counter()
    blob = export_model(model, shape, dtype=torch.bfloat16)
    t_export = time.perf_counter() - t0
    fn = load_exported(blob)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(SEED + 44)).to("cuda",
                                                                               torch.bfloat16)
    with torch.no_grad():
        eager = model(x)
        fn(x)  # warm
        torch.cuda.synchronize()
        reset_counters()
        got = fn(x)
        torch.cuda.synchronize()
        launches = read_counters()
    plain = build_model(cfg, dtype=torch.float32, impl="plain", device="cuda")
    plain.load_state_dict(src.state_dict())
    with torch.no_grad():
        ref = plain(x.float())
    del plain
    psnr = _psnr_db(got, ref)
    same = bool(torch.equal(got, eager))
    prog_ms = cuda_ms(lambda: fn(x))
    eager_ms = cuda_ms(lambda: model(x))
    expect = {k: PER_CALL.get(k, 0) for k in launches}
    log(f"[{tag}] SwinIR-M x4 {list(shape)} bf16: export_parity max |diff| {max_abs:.3e}, mean "
        f"{mean_abs:.3e} ({t_parity:.1f} s); export {len(blob) / 2**20:.1f} MiB in "
        f"{t_export:.1f} s; the loaded program vs the eager kernel path "
        f"{'bit-identical' if same else 'differs'}, vs plain fp32 PSNR {psnr:.2f} dB (bound >= "
        f"{PSNR_MIN_DB}); its launches {launches}; a call {prog_ms:.3f} ms, eager "
        f"{eager_ms:.3f} ms ({smi})")
    if max_abs != 0.0 or not same or launches != expect or psnr < PSNR_MIN_DB:
        raise RuntimeError(f"{tag}: parity {max_abs}, same {same}, launches {launches} "
                           f"(expected {expect}), PSNR {psnr}")
    del model, fn
    _op_dispatch_us(smi, tag)
    all_launches = [launches]
    for label, fcfg, fshape, per_call in _export_families():
        all_launches.append(_export_family(label, fcfg, fshape, per_call, smi, tag))
    log(f"[{tag}] phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    return {k: sum(d.get(k, 0) for d in all_launches) for k in PER_CALL}


def phase_ablate(smi):
    """``utils.ablate`` on the card: K2 against F.layer_norm at
    [ABLATE_ROWS, ABLATE_C] bf16 (PERF.md's K2 row), interleaved,
    ABLATE_INNER calls a round (several ms: past the host's dispatch
    spread), ABLATE_ROUNDS rounds: min, median and spread of each, the
    outputs held to each other first."""
    import torch
    import torch.nn.functional as F

    from tpu_superresolution_torch.kernels.layernorm import layernorm
    from tpu_superresolution_torch.utils.ablate import ablate, report

    tag = "ablate"
    gen = torch.Generator().manual_seed(SEED + 45)
    bf = torch.bfloat16
    x = torch.randn(ABLATE_ROWS, ABLATE_C, generator=gen).to("cuda", bf)
    g = (1 + 0.1 * torch.randn(ABLATE_C, generator=gen)).cuda()
    b = (0.1 * torch.randn(ABLATE_C, generator=gen)).cuda()
    k2 = lambda: layernorm(x, g, b)
    lib = lambda: F.layer_norm(x, (ABLATE_C,), g.to(bf), b.to(bf), 1e-5)
    err = float((k2().float() - lib().float()).abs().max())
    res = ablate({"K2 layernorm": k2, "F.layer_norm": lib}, inner=ABLATE_INNER,
                 rounds=ABLATE_ROUNDS)
    for line in report(res).splitlines():
        log(f"[{tag}] {line}  ({smi})")
    r = res["K2 layernorm"]
    log(f"[{tag}] K2 [{ABLATE_ROWS}, {ABLATE_C}] bf16, {ABLATE_INNER} calls a round x "
        f"{ABLATE_ROUNDS} rounds (CUDA events): min {r.min_s * 1e3:.4f} ms, median "
        f"{r.median_s * 1e3:.4f} ms, spread {r.spread:.1%}; F.layer_norm min "
        f"{res['F.layer_norm'].min_s * 1e3:.4f} ms; round {r.min_s * ABLATE_INNER * 1e3:.2f} ms; "
        f"|K2 - F.layer_norm| {err:.3e} ({smi})")
    if not (math.isfinite(r.min_s) and r.min_s > 0 and err < 0.1):
        raise RuntimeError(f"{tag}: {res}, err {err}")


# The dp phase: SwinIR-M x4 (drop path 0) through the data-parallel step
# and the sharded tiled forward at world 1 (NCCL, this process) and world
# 2 (two processes on the one card over gloo: NCCL refuses two ranks on
# one device), then a DAT x4 leg at world 1.  Batch DP_BATCH of 64^2 LR
# crops (patch None, no flips); DP_TIMED_STEPS steps a path, interleaved.
DP_BATCH = TRAIN_BATCH
DP_TIMED_STEPS = 10
DP_DAT_BATCH = 2
DP_CHILD_TIMEOUT_S = 300


def _dp_swinir():
    """SwinIR-M x4 at drop path 0 (seeded weights): (config, a train and a
    serving model on the card, the phase's global batch, the bench
    image)."""
    import dataclasses

    import numpy as np
    import torch

    from tpu_superresolution_torch.core.config import build_model

    cfg, src = _seeded_swinir_m()
    cfg = dataclasses.replace(cfg, drop_path_rate=0.0)
    rng = np.random.default_rng(SEED + 26)
    lr = rng.random((DP_BATCH, TRAIN_LR_PATCH, TRAIN_LR_PATCH, 3), np.float32)
    hr = rng.random((DP_BATCH, TRAIN_LR_PATCH * 4, TRAIN_LR_PATCH * 4, 3), np.float32)
    x = np.random.default_rng(SEED).random((1, 256, 256, 3), np.float32)  # the bench image
    models = {}
    for mode in ("train", "serve"):
        models[mode] = build_model(cfg, dtype=torch.bfloat16, device="cuda")
        models[mode].load_state_dict(src.state_dict())
    return cfg, models, lr, hr, torch.from_numpy(x).cuda()


def _flat_params(state):
    import torch

    return torch.cat([p.detach().reshape(-1).float() for p in state.params])


def _flat_grads(state):
    import torch

    return torch.cat([p.grad.detach().reshape(-1).float() for p in state.params])


def _cos(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a * b).sum()) / max(float(a.norm()) * float(b.norm()), 1e-30)


def _dp_gate(tag, got, ref, smi):
    """The first-step gate: loss, grad norm and the cosine of AdamW's
    first update from the same weights, `got` against `ref`."""
    d_loss = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    d_gn = abs(got["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
    cos_u = _cos(got["update"], ref["update"])
    cos_g = _cos(got["grad"], ref["grad"])
    log(f"[dp] {tag}: loss {got['loss']:.6f} vs {ref['loss']:.6f} (rel {d_loss:.3e}, bound "
        f"{TRAIN_LOSS_RTOL}), grad norm {got['grad_norm']:.6f} vs {ref['grad_norm']:.6f} (rel "
        f"{d_gn:.3e}, bound {TRAIN_GNORM_RTOL}), update cosine {cos_u:.6f} (bound >= "
        f"{TRAIN_COS_MIN}), clipped-gradient cosine {cos_g:.6f} ({smi})")
    if d_loss > TRAIN_LOSS_RTOL or d_gn > TRAIN_GNORM_RTOL or cos_u < TRAIN_COS_MIN:
        raise RuntimeError(f"dp {tag}: the first-step gate failed")


def _dp_step_result(state, before, m):
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "update": (_flat_params(state) - before).cpu(), "grad": _flat_grads(state).cpu()}


def _timed(fn, n):
    """(median, all) wall ms of `n` calls of fn(), each synchronised."""
    import torch

    dts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(dts), dts


def _dp_child(rank, world, init_method, out_dir):
    """One rank of the dp phase's world 2 on the one card (gloo on CUDA
    tensors): the sharded tiled forward of the bench image, one dp step
    on its half of the global batch (kept for the gate), then timings.
    Each rank writes its launches, rank 0 also its results, to
    `out_dir`."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_superresolution_torch.evaluate.tiling import sharded_tiled_forward
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.parallel import (
        init_multihost,
        make_dp_train_step,
        make_mesh,
        shard_batch,
    )
    from tpu_superresolution_torch.parallel.mesh import all_reduce_sum_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    init_multihost("cuda:0", init_method, world_size=world, rank=rank, backend="gloo")
    mesh = make_mesh(world, "cuda:0")
    _, models, lr, hr, x = _dp_swinir()
    res = {}
    serve = models["serve"].eval()
    fwd = lambda: sharded_tiled_forward(serve, x, 4, 64, 8, mesh)
    with torch.no_grad():
        reset_counters()
        out = fwd()
        torch.cuda.synchronize()
        res["fwd_launches"] = read_counters()
        res["sr"] = out.float().cpu()
        res["fwd_ms"], res["fwd_all"] = _timed(fwd, 5)
    state = _train_state(models["train"], 1)
    step = make_dp_train_step("l1", "native_lr", 4, None, False, mesh)
    shards = shard_batch((lr, hr, np.ones((DP_BATCH,), np.float32)), mesh)
    gen = torch.Generator().manual_seed(SEED)
    before = _flat_params(state)
    reset_counters()
    m = step(state, *shards, gen)
    torch.cuda.synchronize()
    res["step_launches"] = read_counters()
    res.update(_dp_step_result(state, before, m))
    res["step_ms"], res["step_all"] = _timed(lambda: step(state, *shards, gen), DP_TIMED_STEPS)
    flat = torch.ones(sum(p.numel() for p in state.params) + 2, device="cuda")
    res["allreduce_ms"], _ = _timed(lambda: all_reduce_sum_(flat, mesh), 3)
    res["grad_elements"] = flat.numel() - 2
    if rank:
        res = {k: res[k] for k in ("fwd_launches", "step_launches")}
    torch.save(res, f"{out_dir}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _dp_world2(workdir):
    """Run the two ranks of world 2 (this script with --dp-child) and
    return what each wrote; both are killed on a failure or after
    DP_CHILD_TIMEOUT_S."""
    import torch

    out_dir = tempfile.mkdtemp(dir=workdir)
    init = f"file://{out_dir}/store"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-child", str(r),
                               "2", init, out_dir]) for r in range(2)]
    try:
        deadline = time.monotonic() + DP_CHILD_TIMEOUT_S
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"dp: the world 2 ranks exited {codes}")
    return [torch.load(f"{out_dir}/rank{r}.pt", weights_only=False) for r in range(2)]


def phase_dp(workdir, smi):
    """``parallel/`` on the card, SwinIR-M x4 at full width (drop path 0):
    (1) world 1 over NCCL in this process: one ``make_dp_train_step``
    step (batch 8 of 64^2 LR crops, patch None, no flips) against
    ``make_train_step`` from the same weights and batch (loss 1%, grad
    norm 5%, update cosine >= 0.98) with the same launches; the two
    steps' medians, interleaved; ``sharded_tiled_forward`` of the bench
    image (256^2 LR, tile 64 / 8) bit-identical to ``tiled_forward``;
    (2) world 2 on the one card, two processes over gloo on CUDA
    tensors: the sharded forward against world 1's (bit-identical, else
    >= 50 dB), the dp step on the same global batch against world 1's
    dp step under the same gate, the step's median and a lone all-reduce
    of the gradients' size; (3) DAT x4 at world 1: a no-grad forward on
    the kernel route (K9 / K14 / K10; its folded BatchNorm built before
    the step), one dp step at batch 2, the same forward again against
    ``impl="plain"`` fp32 from the stepped state (>= 50 dB).  Returns
    the dp paths' launches (the children's among them)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_superresolution_torch.core.config import DATConfig, build_model
    from tpu_superresolution_torch.evaluate.tiling import sharded_tiled_forward, tiled_forward
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.parallel import (
        init_multihost,
        make_dp_train_step,
        make_mesh,
        shard_batch,
    )
    from tpu_superresolution_torch.parallel.data_parallel import batch_norm_stats
    from tpu_superresolution_torch.train.engine import make_train_step

    tag = "dp"
    t_phase = time.perf_counter()
    launches = []
    store = tempfile.mkdtemp(dir=workdir)
    init_multihost("cuda:0", f"file://{store}/store", world_size=1, rank=0, backend="nccl")
    mesh = make_mesh(1, "cuda:0")
    log(f"[{tag}] world 1: backend {mesh.backend}, device {mesh.device}")

    # 1. world 1: the dp step against the single-device step
    cfg, models, lr, hr, x = _dp_swinir()
    src_sd = {k: v.clone() for k, v in models["train"].state_dict().items()}
    w = np.ones((DP_BATCH,), np.float32)
    dp_step = make_dp_train_step("l1", "native_lr", 4, None, False, mesh)
    one_step = make_train_step("l1", "native_lr", 4, None, False)
    states, first, counts = {}, {}, {}
    for label in ("single", "dp"):
        model = build_model(cfg, dtype=torch.bfloat16, device="cuda")
        model.load_state_dict(src_sd)
        states[label] = st = _train_state(model, 1)
        gen = torch.Generator().manual_seed(SEED)
        before = _flat_params(st)
        reset_counters()
        if label == "dp":
            m = dp_step(st, *shard_batch((lr, hr, w), mesh), gen)
        else:
            m = one_step(st, lr, hr, gen)
        torch.cuda.synchronize()
        counts[label] = read_counters()
        first[label] = _dp_step_result(st, before, m)
    launches.append(counts["dp"])
    log(f"[{tag}] world 1 step launches: dp {counts['dp']}, single {counts['single']}")
    if counts["dp"] != counts["single"] or counts["dp"] != TRAIN_PER_STEP:
        raise RuntimeError(f"{tag}: dp step launches {counts['dp']}, single {counts['single']}, "
                           f"expected {TRAIN_PER_STEP}")
    _dp_gate("world 1 dp step vs the single-device step", first["dp"], first["single"], smi)
    gens = {k: torch.Generator().manual_seed(SEED + 1) for k in states}
    runs = {"single": lambda: one_step(states["single"], lr, hr, gens["single"]),
            "dp": lambda: dp_step(states["dp"], *shard_batch((lr, hr, w), mesh), gens["dp"])}
    times = {k: [] for k in runs}
    for _ in range(2):  # warm-up
        for k in runs:
            runs[k]()
    for _ in range(DP_TIMED_STEPS):
        for k in runs:
            times[k].append(_timed(runs[k], 1)[0])
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"[{tag}] world 1 step, batch {DP_BATCH} of {TRAIN_LR_PATCH}^2, interleaved, median of "
        f"{DP_TIMED_STEPS}: dp {med['dp']:.2f} ms ({', '.join(f'{t:.2f}' for t in times['dp'])}), "
        f"single {med['single']:.2f} ms ({', '.join(f'{t:.2f}' for t in times['single'])}), "
        f"ratio {med['dp'] / med['single']:.4f} ({smi})")
    del states, runs

    serve = models["serve"].eval()
    with torch.no_grad():
        ref = tiled_forward(serve, x, 4, 64, 8)
        reset_counters()
        out1 = sharded_tiled_forward(serve, x, 4, 64, 8, mesh)
        torch.cuda.synchronize()
        fwd_counts = read_counters()
        launches.append(fwd_counts)
        t_tiled, _ = _timed(lambda: tiled_forward(serve, x, 4, 64, 8), 5)
        t_sharded, _ = _timed(lambda: sharded_tiled_forward(serve, x, 4, 64, 8, mesh), 5)
    same = torch.equal(out1, ref)
    log(f"[{tag}] world 1 sharded tiled forward, 256^2 LR, tile 64/8: launches {fwd_counts} "
        f"(expected {PER_CALL}); bit-identical to tiled_forward: {same}; median of 5: sharded "
        f"{t_sharded:.2f} ms, tiled {t_tiled:.2f} ms ({smi})")
    if not same or fwd_counts != PER_CALL or tuple(out1.shape) != (1, 1024, 1024, 3):
        raise RuntimeError(f"{tag}: world 1 sharded forward differs from tiled_forward")
    del models

    # 2. world 2 on the one card: two processes over gloo on CUDA tensors
    t0 = time.perf_counter()
    ranks = _dp_world2(workdir)
    child = ranks[0]
    log(f"[{tag}] world 2 (two processes on one card, backend gloo on CUDA tensors) in "
        f"{time.perf_counter() - t0:.1f} s, each rank's launches: forward "
        f"{[r['fwd_launches'] for r in ranks]}, step {[r['step_launches'] for r in ranks]}")
    for r, res in enumerate(ranks):
        for name, want in (("fwd_launches", PER_CALL), ("step_launches", TRAIN_PER_STEP)):
            if res[name] != want:
                raise RuntimeError(f"{tag}: world 2 rank {r} {name} {res[name]}, expected {want}")
        launches += [res["fwd_launches"], res["step_launches"]]
    sr1 = out1.float().cpu()
    same2 = torch.equal(child["sr"], sr1)
    psnr2 = float("inf") if same2 else _psnr_db(child["sr"], sr1)
    log(f"[{tag}] world 2 sharded forward (13 tiles a rank, one zero pad) vs world 1: "
        f"bit-identical {same2}, PSNR {psnr2:.2f} dB (bound >= {PSNR_MIN_DB} where not "
        f"identical); median of 5 on rank 0: {child['fwd_ms']:.2f} ms "
        f"({', '.join(f'{t:.2f}' for t in child['fwd_all'])}) ({smi})")
    if not same2 and psnr2 < PSNR_MIN_DB:
        raise RuntimeError(f"{tag}: the world 2 sharded forward disagrees with world 1's")
    _dp_gate("world 2 dp step vs world 1 dp step", child, first["dp"], smi)
    log(f"[{tag}] world 2 step on the one card, batch {DP_BATCH} (4 a rank), median of "
        f"{DP_TIMED_STEPS} on rank 0: {child['step_ms']:.2f} ms "
        f"({', '.join(f'{t:.2f}' for t in child['step_all'])}); a lone gloo all-reduce of "
        f"{child['grad_elements']:,} fp32 CUDA elements (staged through the host): "
        f"{child['allreduce_ms']:.2f} ms ({smi})")

    # 3. DAT x4 at world 1: the folded BatchNorm after a dp step
    dcfg = DATConfig()
    dsrc = build_model(dcfg)
    dsrc.reset_parameters(torch.Generator().manual_seed(SEED))
    _perturb_dat(dsrc, torch.Generator().manual_seed(SEED + 5))
    dat = build_model(dcfg, dtype=torch.bfloat16, device="cuda")
    dat.load_state_dict(dsrc.state_dict())
    dx = torch.from_numpy(
        np.random.default_rng(SEED + 7).random((1, 64, 64, 3), np.float32)).cuda()

    def forward(model_or_sd, dtype=torch.bfloat16, impl="auto"):
        """The no-grad eval forward of `dx` by a model, or by a new one
        loaded with a state dict."""
        model = model_or_sd
        if isinstance(model_or_sd, dict):
            model = build_model(dcfg, dtype=dtype, impl=impl, device="cuda")
            model.load_state_dict(model_or_sd)
        with torch.no_grad():
            return model.eval()(dx)

    dat.eval()
    routes = sorted({r for g in dat.routes() for r in g})
    if routes != [("K14", "K10"), ("K9", "K10")]:
        raise RuntimeError(f"{tag}: DAT eval routes {routes}")
    y0 = forward(dat)  # builds the folded weights that the step must invalidate
    ref0 = forward(dat.state_dict(), torch.float32, "plain")
    st = _train_state(dat, 1)
    stats = batch_norm_stats(dat)
    v0 = [s._version for s in stats]
    s0 = torch.cat([s.detach().reshape(-1) for s in stats]).clone()
    rng = np.random.default_rng(SEED + 8)
    dlr = rng.random((DP_DAT_BATCH, TRAIN_LR_PATCH, TRAIN_LR_PATCH, 3), np.float32)
    dhr = rng.random((DP_DAT_BATCH, TRAIN_LR_PATCH * 4, TRAIN_LR_PATCH * 4, 3), np.float32)
    dstep = make_dp_train_step("l1", "native_lr", 4, None, False, mesh)
    reset_counters()
    dm = dstep(st, *shard_batch((dlr, dhr, np.ones((DP_DAT_BATCH,), np.float32)), mesh),
               torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    dat_step_counts = read_counters()
    bumps = [s._version - v for s, v in zip(stats, v0)]
    s1 = torch.cat([s.detach().reshape(-1) for s in stats])
    reset_counters()
    y1 = forward(dat)
    torch.cuda.synchronize()
    dat_fwd_counts = read_counters()
    launches += [dat_step_counts, dat_fwd_counts]
    sd = dat.state_dict()
    fresh = forward(sd)
    ref16, ref32 = forward(sd, torch.bfloat16, "plain"), forward(sd, torch.float32, "plain")
    stale = not torch.equal(y1, fresh)
    log(f"[{tag}] DAT x4 world 1: dp step at batch {DP_DAT_BATCH}, loss "
        f"{float(dm['loss']):.6f}, launches {dat_step_counts}; the {len(stats)} BatchNorm "
        f"statistics moved by max |d| {float((s1 - s0).abs().max()):.4e} (max |stat| "
        f"{float(s1.abs().max()):.4e}), their version counters by {min(bumps)}-{max(bumps)}; "
        f"the cached kernel-route forward after the step: launches {dat_fwd_counts}, "
        f"bit-identical to a new model's from the stepped state: {not stale}; PSNR vs plain "
        f"fp32 of the stepped state {_psnr_db(y1, ref32):.2f} dB (bound >= {PSNR_MIN_DB}), "
        f"plain bf16 vs plain fp32 {_psnr_db(ref16, ref32):.2f} dB, before the step kernels vs "
        f"plain fp32 {_psnr_db(y0, ref0):.2f} dB, the model's change (plain fp32 before vs "
        f"after) {_psnr_db(ref32, ref0):.2f} dB, the kernels' change {_psnr_db(y1, y0):.2f} dB "
        f"({smi})")
    if dat_step_counts != DAT_TRAIN_PER_STEP or dat_fwd_counts != DAT_PER_CALL:
        raise RuntimeError(f"{tag}: DAT launches {dat_step_counts} / {dat_fwd_counts}")
    if (stale or _psnr_db(y1, ref32) < PSNR_MIN_DB or not math.isfinite(float(dm["loss"]))
            or min(bumps) < 1):
        raise RuntimeError(f"{tag}: the DAT kernel route after a dp step is stale or wrong")
    dist.destroy_process_group()
    log(f"[{tag}] phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    return {k: sum(d.get(k, 0) for d in launches) for k in PER_CALL}



def main() -> int:
    import torch

    name, smi = phase_device()
    from tpu_superresolution_torch.kernels import _lib

    from tpu_superresolution_torch.core.config import SwinIRConfig

    t_start = time.perf_counter()

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[time] {label}: {time.perf_counter() - t0:.1f} s "
            f"({time.perf_counter() - t_start:.1f} s in all)")
        return out

    timed("build", phase_build)
    kres = timed("kernels", lambda: phase_k5r_kernels(phase_w16_kernels(phase_rect_attention_kernels(
        phase_dat_train_kernels(phase_window_kernels(phase_dat_kernels(
            phase_train_kernels(phase_kernels()))))))))
    kres = timed("mlp4-kernels", phase_mlp4_kernels, kres)
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_lib.BUILD_DIR) as workdir:
        service, launches = timed("serve", phase_serve, workdir, SwinIRConfig(scale=4),
                                  "swinir", PER_CALL)
        timed("bench", phase_bench, service, smi)
        del service
        eval_launches = timed("evaluate", phase_evaluate, workdir, smi)
        ws7_launches = timed("swinir-ws7", phase_swinir_ws7, smi)
        swinir_l_launches = timed("swinir-l", phase_swinir_l, smi)
        wide_launches = timed("wide", phase_wide, smi)
        hat_launches = timed("hat", phase_hat, workdir, smi)
        dat_launches = timed("dat", phase_dat, workdir, smi)
        train_launches, _ = timed("train", phase_train, workdir, smi)
        hat_train_launches = timed("hat-train", phase_hat_train, workdir, smi)
        srx4_launches = timed("hat_srx4", phase_hat_srx4, workdir, smi)
        srx4_train_launches, _ = timed("hat_srx4-train", phase_hat_srx4_train, workdir, smi)
        mlp4_train_launches, mlp4_ckpt = timed("hat_mlp4-train", phase_hat_srx4_train, workdir,
                                               smi, True)
        mlp4_serve_launches = timed("hat_mlp4-serve", phase_hat_mlp4_serve, workdir, mlp4_ckpt,
                                    smi)
        swinir_l_train_launches = timed("swinir_l-train", phase_swinir_l_train, workdir, smi)
        dat_x4_launches = timed("dat_x4", phase_dat_x4, workdir, smi)
        dat_train_launches = timed("dat-train", phase_dat_train, workdir, smi)
        timed("k16-stream", phase_k16_stream_check, smi)
        mrccm = timed("cnn-data", phase_cnn_data, workdir, smi)
        msres_ckpt, unet_ckpt = timed("cnn-train", phase_cnn_train, workdir, mrccm, smi)
        timed("cnn-evaluate", phase_cnn_evaluate, workdir, msres_ckpt, unet_ckpt, mrccm, smi)
        swinir_data_launches = timed("swinir-data", phase_swinir_data, workdir, smi)
        trace_launches = timed("trace", phase_trace, workdir, smi)
        remat_launches = timed("remat", phase_remat, smi)
        compare_launches = timed("compare", phase_compare, workdir, smi)
        mat_launches = timed("mat-eval", phase_mat_eval, workdir, smi)
        export_launches = timed("export", phase_export, smi)
        dp_launches = timed("dp", phase_dp, workdir, smi)
        timed("ablate", phase_ablate, smi)

    kernels = []
    for key, meta in KERNELS.items():
        first = kres[key][0]
        kernels.append(dict(
            name=meta["name"], route=meta["route"], source=meta["source"],
            replaces=meta["replaces"],
            launches=sum(d.get(key, 0) for d in [launches, eval_launches, ws7_launches,
                                                 swinir_l_launches,
                                                 wide_launches, hat_launches, dat_launches,
                                                 train_launches,
                                                 srx4_launches, dat_x4_launches,
                                                 swinir_data_launches, trace_launches,
                                                 remat_launches, compare_launches,
                                                 mat_launches, export_launches, dp_launches,
                                                 mlp4_serve_launches]
                         + hat_train_launches + dat_train_launches + srx4_train_launches
                         + mlp4_train_launches + swinir_l_train_launches),
            max_abs_err=max(r["err"] for r in kres[key]),
            ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=first["library_ms"],
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-child"]:  # a rank of phase_dp's world 2
        _dp_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        sys.exit(0)
    sys.exit(main())
