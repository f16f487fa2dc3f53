#!/usr/bin/env python3
"""Drive the PyTorch port's SwinIR-M x4 serving and fine-tuning paths,
its HAT x4 serving and training paths, its DAT x4 serving and training
paths (the published DAT x4's widths among them) and its HAT-SRx4
(upstream HAT, window 16) serving path once on one NVIDIA H100 and check
them.  Run from the repository root:

    python3 chip_smoke.py

Phases (a failure in any raises, and the script exits non-zero):
1. device   the card's name, compute capability 9.0, power limit;
2. build    nvcc-compile the port's kernels from csrc/ (seconds, ptxas);
3. kernels  each kernel (K1-K6, K9, K10, K14) against its plain PyTorch version at the
            main paths' shapes (K1 also with stochastic-depth branch
            scales and with HAT's `extra` at hat_fast's widths; K6, the
            ws-7 block, at HAT's tile batch with `extra` and at SwinIR's
            widths without; K5, the block backward, on dx and its 13
            parameter gradients): the error vs the plain version in bf16
            and in fp32 (TF32 off), each against its stated bound; the
            median time of kernel, plain version and, where one PyTorch
            call computes the same function, that call; the bound (bytes
            or operations at the H100's published peaks); then the
            training kernels at the HAT train step's shapes: K6b (the
            ws-7 block backward) and K5 with d`extra`, on dx, d extra
            and the 13 parameter gradients, K8 (the OCAB core) and K8b
            (its backward, on dq, dk, dv, d sw and 9 gradients); then
            DAT's kernels at DATConfig()'s widths on the bench tile
            batch and on a [2,52,76,180] image (sides not multiples of
            16): K9 unshifted and shifted, K14 and K10, each output in
            bf16 ulps against the plain bf16 and fp32 versions; then K7
            (window attention for any window) at HAT-SRx4's
            [25,64,64,180] ws 16 unshifted and shift 8, at SwinIR-L's
            widths (C 240, 8 heads, ws 8, shifted), at ws 6 (N 36) and
            at ws 32 (N 1024); K1's tail on the K7 route (K1t: the
            attention residual through the window reverse and unshift,
            `extra`, LN2, the MLP and its residual) at HAT-SRx4's
            widths (ws 16, shift 8, extra) and SwinIR-L's (ws 8, shift
            4, branch scales); and K12 (LN + the CAB's two convs) at
            the HAT-SRx4, HAT, hat_fast and HAT-S shapes, also timed
            against the K2 + cuDNN convs + GELU it replaced; each in
            bf16 ulps likewise; then DAT's module-chain kernels: K16
            (batched window attention) at the DAT train step's
            [256,3,128,30], the bench batch's [800,3,128,30] and the
            published DAT x4's N 256, with and without the shift mask,
            timed beside SDPA, and K11 (depthwise 3x3) at [8,64,64,180]
            and [25,64,64,360], timed beside cuDNN's grouped conv;
4. serve    SwinIR-M x4 (seeded random weights, exported to a .pth) behind
            SRService + make_server on 127.0.0.1, three PNG requests;
            status, size, finite output, launch counts per model call,
            and PSNR >= 50 dB of the served tiled output against the
            plain fp32 path;
5. bench    the bench.py workload (256^2 LR, tile 64, overlap 8, x4, bf16,
            25 tiles in one batch, 10 timed iterations) in MPix/s, for the
            kernels and for the plain path; then SwinIR-M x4 at window 7
            (its blocks run K6): launches and PSNR vs the plain fp32 path;
            and one SwinIR-L-width forward (embed 240, 8 heads, ws 8,
            depths 9x6, 3conv, nearest+conv; 4 tiles of 64^2), whose
            blocks take the K7 route (K2, K7, K1t): launches and PSNR
            likewise;
6. hat      HAT x4 (HATConfig(): embed 96, depths 6x4, ws 7; seeded
            random weights, exported to a .pth) behind SRService with
            --model hat: the three requests and checks of the serve phase
            (every CAB is K12); then the bench workload for HAT in
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
            of K1's per-step weight packing, and the first step's loss,
            grad norm and per-parameter gradient cosine against the
            plain fp32 path;
9. hat-train HAT x4 training (HATConfig() at full width and depth, drop
            path 0.1, batch 8, --patch_size 64, L1, AdamW, clip 1.0)
            through ``cli.train.main(--model hat --device cuda)`` for one
            epoch of 2 steps + validation on a synthetic DeepRockSR-layout
            set; launches per step, ms per step for the kernels and the
            plain bf16 path, a profiled step split by part (K6, K6b, K8,
            K8b, CAB, the rest, idle), the first step's gradients
            against the plain fp32 path (with the plain bf16 path beside
            it); then a hat_fast step (K1 / K5 with `extra`): launches
            and first-step gradients;
10. hat_srx4 HAT-SRx4 (upstream HAT_SRx4_ImageNet-pretrain.yml: window
            16, embed 180, depths 6x6, heads 6, mlp 2, compress 3,
            squeeze 30, overlap 0.5; seeded random weights, exported to a
            .pth) behind SRService with --model hat: the serve phase's
            requests and checks (launches per call K7 36, K1t 36, K12
            36, K2 50, K3 8, K4 1, K1 = K6 = 0; the tiled output >= 50 dB against
            the plain fp32 path), the bench workload in MPix/s, kernels
            vs plain, and a torch.profiler split of one forward;
11. dat_x4  the published DAT x4 (split (8, 32), expansion 4; seeded
            random weights, perturbed BatchNorm statistics): its .pth
            behind SRService (which loads it at split (8, 16): K9 and K14
            fronts, module-chain tails), the serve phase's checks; then
            the model at (8, 32) on the bench workload, whose spatial
            blocks and tails take the module chain: launches per call
            (K14 18, K16 36, K11 54, K9 = K10 = 0), >= 50 dB against the
            plain fp32 path, MPix/s kernels vs plain, a profiled split;
12. dat-train DAT x4 training (DATConfig() at full width and depth, drop
            path 0.1, batch 8, --patch_size 64, L1, AdamW, clip 1.0,
            --ema_decay 0.999) through ``cli.train.main(--model dat
            --device cuda)`` for one epoch of 2 steps + validation;
            launches per step (K16 36, K11 72, K9 = K14 = K10 = 0), ms
            per step and images/s for the kernels and the plain bf16
            path, a profiled step split by part, and the first step's
            loss, gradients and BatchNorm statistics against the plain
            fp32 path (with DAT's exception for gradients below bf16's
            resolution, BF16_FLOOR).

The second-to-last stdout line is a JSON object describing each kernel
(launches summed over the serve, SwinIR ws-7, SwinIR-L, hat, dat,
train, hat-train, hat_srx4, dat_x4 and dat-train phases); the last is
{"ok": true, "device": {...}}.  There is no CPU path: with no CUDA
device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import io
import json
import math
import statistics
import subprocess
import sys
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
ULP_BOUND = {"K1": 8, "K1t": 8, "K2": 4, "K3": 4, "K4": 4, "K6": 8, "K7": 8, "K8": 8,
             "K9": 8, "K10": 8, "K11": 4, "K12": 8, "K14": 8, "K16": 8}
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
               source="tpu_superresolution_torch/csrc/ocab.cu",
               replaces="tpu_superresolution_tpu/ops/pallas/fused_ocab.py:311"),
    "K8b": dict(name="ocab_bwd", route="cuda",
                source="tpu_superresolution_torch/csrc/ocab.cu",
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
    "K7": dict(name="window_attention", route="cuda",
               source="tpu_superresolution_torch/csrc/window_attn.cu",
               replaces="tpu_superresolution_tpu/ops/pallas/fused_attention.py:229"),
    "K12": dict(name="ln_cab_convs", route="cuda",
                source="tpu_superresolution_torch/csrc/cab_fused.cu",
                replaces="tpu_superresolution_tpu/ops/pallas/cab_conv.py:209"),
    # K1's function at the windows and widths the block kernel does not
    # take is K2 (LN1) + K7 + this tail kernel
    "K1t": dict(name="swin_block_tail", route="cuda",
                source="tpu_superresolution_torch/csrc/swin_tail.cu",
                replaces="tpu_superresolution_tpu/ops/pallas/fused_block.py:958"),
    "K11": dict(name="dwconv3x3", route="cuda",
                source="tpu_superresolution_torch/csrc/dwconv.cu",
                replaces="tpu_superresolution_tpu/ops/pallas/cab_conv.py:506"),
    "K16": dict(name="batched_window_attention", route="cuda",
                source="tpu_superresolution_torch/csrc/batched_attn.cu",
                replaces="tpu_superresolution_tpu/ops/pallas/window_attention.py:352"),
}
# Launches per SwinIR-M x4 model call on the serving path (--no-exact).
PER_CALL = {"K1": 36, "K1t": 0, "K2": 2, "K3": 8, "K4": 1, "K5": 0, "K6": 0, "K6b": 0,
            "K7": 0, "K8": 0, "K8b": 0, "K9": 0, "K10": 0, "K11": 0, "K12": 0, "K14": 0,
            "K16": 0}
# Per HAT x4 model call (--no-exact): K6 per HAB (24); K12 per HAB's CAB
# (24: its LN1 inside); K2 for patch_norm, norm and each OCAB's two norms
# (8); K3 for the 4 RHAG convs, conv_after_body and conv_before_upsample;
# K4 for the composed reconstruction.  hat_fast runs K1 where hat runs K6.
HAT_PER_CALL = dict(PER_CALL, K1=0, K2=10, K3=6, K4=1, K6=24, K12=24)
HAT_FAST_PER_CALL = dict(HAT_PER_CALL, K1=24, K6=0)
# SwinIR-M x4 from a checkpoint of window 7: its 36 blocks run K6.
SWINIR_WS7_PER_CALL = dict(PER_CALL, K1=0, K6=36)
# SwinIR-L's widths (embed 240, 8 heads, ws 8, depths 9x6, 3conv,
# nearest+conv): every block takes the K7 route (C 240 > 192): K7 and
# K1t 54 each, K2 for patch_norm, norm and each block's LN1 (56); K3 for
# the two 3x3 convs of each 3conv (9 RSTBs and conv_after_body: 20),
# conv_before_upsample, conv_up1, conv_up2 and conv_hr; no K4.
SWINIR_L_PER_CALL = dict(PER_CALL, K1=0, K1t=54, K2=56, K3=24, K4=0, K7=54)
# Per HAT-SRx4 model call (window 16, depths 6x6; --no-exact): every HAB
# takes the K7 route (K7 and K1t 36 each) and its CAB K12 (36); K2 for
# patch_norm, norm, each HAB's LN1 (36) and each OCAB's two norms (12);
# K3 for the 6 RHAG convs, conv_after_body and conv_before_upsample; K4
# for the composed reconstruction; no block kernel.
HAT_SRX4_PER_CALL = dict(PER_CALL, K1=0, K1t=36, K2=50, K3=8, K4=1, K7=36, K12=36)
# Per DAT x4 model call (DATConfig(): depths 6x6, split (8, 16); --no-exact):
# K9 per spatial block (18, 9 of them shifted), K14 per channel block
# (18), K10 per block (36); K2 for before_RG and norm; K3 for the 6 group
# convs, conv_after_body and conv_before_upsample; K4 for the composed
# reconstruction.  One K9 call is 2 CUDA launches, one K14 call 3.
DAT_PER_CALL = dict(PER_CALL, K1=0, K2=2, K3=8, K4=1, K9=18, K10=36, K14=18)
# The published DAT x4 (DAT's test_DAT_x4.yml: split (8, 32), expansion 4;
# SGFN half 360), per bench call: K9 refuses s0 * s1 = 256 and K10 the half
# 360, so the spatial fronts (18) and every tail (36) take the module chain:
# K16 per rect branch (36), K11 per spatial conv branch and per sg_conv
# (18 + 36), K2 for before_RG, norm, the 18 chain fronts' LN1 and every
# block's LN2 and sg_norm (2 + 18 + 72); K14 per channel front (18).
DAT_X4_PER_CALL = dict(PER_CALL, K1=0, K2=92, K3=8, K4=1, K11=54, K14=18, K16=36)
# A published DAT x4 .pth served: the split is not in the weights, so the
# checkpoint loads at (8, 16) with expansion 4 (infer_dat_config, as the
# JAX package): K9 and K14 fronts, module-chain tails (K11 per sg_conv,
# K2 per LN2 and sg_norm).
DAT_X4_SERVE_PER_CALL = dict(PER_CALL, K1=0, K2=74, K3=8, K4=1, K9=18, K11=36, K14=18)
# Fine-tuning: batch 8 of 64^2 LR crops; per train step, with the
# composed reconstruction (fused_reconstruct, the config's default): K1
# per block forward, K5 per block backward, K2-K4 forwards (their
# backwards are autograd of the plain versions).
TRAIN_BATCH = 8
TRAIN_LR_PATCH = 64
TRAIN_TIMED_STEPS = 10
# A DAT step takes ~1 s (host-bound): fewer timed steps keep the script
# near its former length.
DAT_TIMED_STEPS = 5
TRAIN_PER_STEP = dict(PER_CALL, K5=36)
# HAT x4 training (HATConfig(), batch 8 of 64^2 LR crops, reflect-padded
# to 70^2), per train step: K6 forward and K6b backward per HAB (24); K8
# and K8b per OCAB core (4); K2 for patch_norm, norm and each OCAB's LN1
# (4; its LN2 is inside K8); K12 per HAB's CAB (24, its backward autograd
# of the plain version); K3 for the 4 RHAG convs, conv_after_body and
# conv_before_upsample; K4 for the composed reconstruction.  hat_fast
# runs K1 / K5 where hat runs K6 / K6b.
HAT_TRAIN_PER_STEP = {"K1": 0, "K1t": 0, "K2": 6, "K3": 6, "K4": 1, "K5": 0, "K6": 24,
                      "K6b": 24, "K7": 0, "K8": 4, "K8b": 4, "K9": 0, "K10": 0, "K11": 0,
                      "K12": 24, "K14": 0, "K16": 0}
HAT_FAST_TRAIN_PER_STEP = dict(HAT_TRAIN_PER_STEP, K1=24, K5=24, K6=0, K6b=0)
# DAT x4 training (DATConfig(), batch 8 of 64^2 LR crops), per train step:
# every block on the module chain (BatchNorm on batch statistics): K16 per
# rect branch of the 18 spatial blocks (36), K11 per conv branch and per
# sg_conv (72), K2 for before_RG, norm and each block's LN1, LN2 and
# sg_norm (110), K3 for the 6 group convs, conv_after_body and
# conv_before_upsample, K4 for the composed reconstruction; no K9, K14,
# K10.  K11's and K16's backwards are autograd of their plain versions.
DAT_TRAIN_PER_STEP = dict(PER_CALL, K1=0, K2=110, K3=8, K4=1, K11=72, K16=36)
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
# no farther from fp32 than twice the plain bf16 path's.


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
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build] {line.strip()}")


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
                   t_kernel, t_plain, work):
    """A backward kernel's outputs: each activation gradient in bf16 ulps
    at its max |ref|, each parameter gradient in relative Frobenius
    error, against the plain version in fp32 (and bf16), beside the
    plain bf16 version's own error."""
    bad, errs = [], []
    for k in act_fields:
        a, r16, r32 = getattr(got, k).float(), getattr(ref16, k).float(), getattr(ref32, k).float()
        mag = float(r32.abs().max())
        bound = K5_DX_ULPS * bf16_ulp(mag)
        e32, e16 = float((a - r32).abs().max()), float((a - r16).abs().max())
        own = float((r16 - r32).abs().max())
        ok = math.isfinite(e32) and e32 <= bound and e16 <= bound
        errs.append(e32)
        log(f"[kernels] {key} {label} {k if k.startswith('d') else 'd' + k}: max_abs_err vs plain fp32 {e32:.3e}, vs plain bf16 "
            f"{e16:.3e} (bound {bound:.3e} = {K5_DX_ULPS} bf16 ulp at max|ref| {mag:.3f}; "
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


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from tpu_superresolution_torch.kernels.cab_conv import conv3x3, conv_k, conv_plain
    from tpu_superresolution_torch.kernels.fused_block import (
        GRAD_FIELDS,
        fused_swin_block_backward,
        fused_windows_block,
        pack_block_weights,
        swin_block_bwd_plain,
        swin_block_plain,
    )
    from tpu_superresolution_torch.kernels.layernorm import layernorm, layernorm_plain
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    bf = torch.bfloat16
    res = {}

    # K1: swin block, shift 0 and 4 on the serve tile batch / train batch
    # (with and without stochastic-depth branch scales), and a whole image
    w = _random_block(gen, dev)
    packed = pack_block_weights(w)
    scales = torch.tensor([[1.0 / 0.9, 0.0], [1.0 / 0.9, 1.0 / 0.9]] * 4, device=dev)
    for shape, shift, sc in (((8, 64, 64, 180), 0, None), ((8, 64, 64, 180), 4, None),
                             ((1, 256, 256, 180), 4, None), ((8, 64, 64, 180), 0, scales),
                             ((8, 64, 64, 180), 4, scales)):
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        mask = shift_mask_tensor(shape[1], shape[2], 8, shift, dev) if shift else None
        run = lambda: fused_windows_block(x, w, 8, shift, mask, True, packed=packed,
                                          branch_scales=sc)
        out = run()
        ref16 = swin_block_plain(x, w, 8, shift, mask, True, sc)
        ref32 = swin_block_plain(x.float(), w, 8, shift, mask, True, sc)
        torch.cuda.synchronize()
        label = f"{list(shape)} shift {shift}" + ("" if sc is None else " branch scales")
        _compare(res, "K1", label, out, ref16, ref32, cuda_ms(run),
                 cuda_ms(lambda: swin_block_plain(x, w, 8, shift, mask, True, sc)),
                 _swin_work(shape))

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
        pk = pack_block_weights(wb)
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
        _compare(res, key, label, out, ref16, ref32, cuda_ms(run), cuda_ms(plain),
                 _swin_work(shape, c, hidden, ws=ws, extra=with_extra))
        del out, ref16, ref32

    # K5: the block backward at the train shape, shift 0 and 4, scales on
    shape = (8, 64, 64, 180)
    for shift in (0, 4):
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        ct = (0.1 * torch.randn(*shape, generator=gen)).to(dev, bf)
        mask = shift_mask_tensor(shape[1], shape[2], 8, shift, dev) if shift else None
        run = lambda: fused_swin_block_backward(ct, x, w, 8, shift, mask, True, scales,
                                                packed=packed)
        got = run()
        ref16 = swin_block_bwd_plain(ct, x, w, 8, shift, mask, True, scales)
        ref32 = swin_block_bwd_plain(ct.float(), x.float(), w, 8, shift, mask, True, scales)
        torch.cuda.synchronize()
        _compare_grads(res, "K5", f"{list(shape)} shift {shift} branch scales", got, ref16,
                       ref32, ("dx",), GRAD_FIELDS, cuda_ms(run),
                       cuda_ms(lambda: swin_block_bwd_plain(ct, x, w, 8, shift, mask, True,
                                                            scales)),
                       _swin_work(shape, backward=True))
        del got, ref16, ref32

    # K2: layernorm on the bench trunk (25 tiles of 64^2), the train batch
    # and HAT's trunk (25 tiles of 70^2, C 96)
    for rows, c in ((25 * 64 * 64, 180), (8 * 64 * 64, 180), (25 * 70 * 70, 96)):
        x = torch.randn(rows, c, generator=gen).to(dev, bf)
        g = (1 + 0.1 * torch.randn(c, generator=gen)).to(dev)
        b = (0.1 * torch.randn(c, generator=gen)).to(dev)
        g16, b16 = g.to(bf), b.to(bf)
        out = layernorm(x, g, b)
        _compare(res, "K2", f"[{rows}, {c}]", out, layernorm_plain(x, g, b),
                 layernorm_plain(x.float(), g, b),
                 cuda_ms(lambda: layernorm(x, g, b)), cuda_ms(lambda: layernorm_plain(x, g, b)),
                 (8 * x.numel(), 2 * x.numel() * 2 + 2 * c * 4),
                 cuda_ms(lambda: F.layer_norm(x, (c,), g16, b16, 1e-5)))

    # K3: 3x3 convs 180->180 and 180->64 on bench tiles, a whole image and
    # the train batch, and HAT's 96->96 on its tiles; K4: the composed 5x5
    # 64->48 reconstruction conv.
    cases = [("K3", (25, 64, 64, 180), 180, 3, ((1, 1), (1, 1))),
             ("K3", (25, 64, 64, 180), 64, 3, ((1, 1), (1, 1))),
             ("K3", (1, 256, 256, 180), 180, 3, ((1, 1), (1, 1))),
             ("K3", (1, 256, 256, 180), 64, 3, ((1, 1), (1, 1))),
             ("K3", (8, 64, 64, 180), 180, 3, ((1, 1), (1, 1))),
             ("K3", (25, 70, 70, 96), 96, 3, ((1, 1), (1, 1))),
             ("K4", (25, 64, 64, 64), 48, 5, ((2, 2), (2, 2))),
             ("K4", (8, 64, 64, 64), 48, 5, ((2, 2), (2, 2)))]
    for key, shape, cout, k, pad in cases:
        cin = shape[-1]
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        kern = (torch.randn(k, k, cin, cout, generator=gen) * (k * k * cin) ** -0.5).to(dev, bf)
        bias = (0.1 * torch.randn(cout, generator=gen)).to(dev)
        fn = (lambda: conv3x3(x, kern, bias)) if key == "K3" else (lambda: conv_k(x, kern, bias, pad))
        out = fn()
        # the one-call library yardstick: cuDNN on the same NHWC tensor
        xn, wn, b16 = x.permute(0, 3, 1, 2), kern.permute(3, 2, 0, 1).contiguous(), bias.to(bf)
        pixels = math.prod(shape[:3])
        _compare(res, key, f"{list(shape)} -> {cout}, {k}x{k}", out,
                 conv_plain(x, kern, bias, pad), conv_plain(x.float(), kern.float(), bias, pad),
                 cuda_ms(fn), cuda_ms(lambda: conv_plain(x, kern, bias, pad)),
                 (2 * pixels * cin * cout * k * k,
                  pixels * (cin + cout) * 2 + kern.numel() * 2 + cout * 4),
                 cuda_ms(lambda: F.conv2d(xn, wn, b16, padding=k // 2)))
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


def _ocab_work(windows, nq, nk, c, nh, hidden, backward=False):
    """(FLOPs, bytes) of K8 (or its backward) at the unpadded widths: per
    window QK^T and AV over nq x nk, proj, fc1 and fc2; the backward
    recomputes all but fc2 and does two products per forward one.
    Bytes: q, sw, k, v read once, the output written (the backward: ct
    read, dq, dk, dv, dsw written), in bf16; weights in bf16, bias in
    fp32 (and their fp32 gradients)."""
    fwd = {"qk": 2 * nq * nk * c, "av": 2 * nq * nk * c, "proj": 2 * nq * c * c,
           "fc1": 2 * nq * c * hidden, "fc2": 2 * nq * c * hidden}
    per = sum(fwd.values())
    weights, bias = c * c + 2 * c * hidden, nh * nq * nk
    acts = (2 * nq + 2 * nk) * c * 2
    if not backward:
        return windows * per, windows * (acts + nq * c * 2) + weights * 2 + bias * 4
    per = per - fwd["fc2"] + 2 * per
    return (windows * per, windows * (2 * acts + nq * c * 2) + weights * (2 + 4)
            + bias * (4 + 4))


def phase_train_kernels(res):
    """The training kernels at the HAT train step's shapes (batch 8 of
    64^2 LR crops; ws 7 pads them to 70^2): K6b, the ws-7 block backward,
    at [8,70,70,96] shift 0 and 3 with `extra` and branch scales; K5 with
    d`extra` at hat_fast's [8,64,64,96]; K8 and K8b, the OCAB core and
    its backward, on HAT's 800 windows (49 queries x 100 keys) and
    hat_fast's 512 (64 x 144).  Each against its plain version in bf16
    and fp32, with times and bounds, into `res`."""
    import torch

    from tpu_superresolution_torch.kernels import fused_ocab
    from tpu_superresolution_torch.kernels.fused_block import (
        GRAD_FIELDS,
        fused_swin_block_backward,
        pack_block_weights,
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
        pk = pack_block_weights(wb)
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        ct = (0.1 * torch.randn(*shape, generator=gen)).to(dev, bf)
        ex = (0.05 * torch.randn(*shape, generator=gen)).to(dev, bf)
        mask = shift_mask_tensor(shape[1], shape[2], ws, shift, dev) if shift else None
        run = lambda: fused_swin_block_backward(ct, x, wb, ws, shift, mask, True, scales,
                                                packed=pk, extra=ex)
        plain = lambda: swin_block_bwd_plain(ct, x, wb, ws, shift, mask, True, scales, ex)
        got = run()
        ref16 = plain()
        ref32 = swin_block_bwd_plain(ct.float(), x.float(), wb, ws, shift, mask, True, scales,
                                     ex.float())
        torch.cuda.synchronize()
        _compare_grads(res, key, f"{list(shape)} ws {ws} shift {shift} extra, branch scales",
                       got, ref16, ref32, ("dx", "extra"), GRAD_FIELDS, cuda_ms(run),
                       cuda_ms(plain), _swin_work(shape, c, hidden, backward=True, ws=ws,
                                                 extra=True))
        del got, ref16, ref32

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
        label = f"{windows} windows, {nq} queries x {nk} keys, C {c}"
        run = lambda: fused_ocab.fused_ocab_core(q, k, v, sw, w, bias, True)
        plain = lambda: fused_ocab.ocab_core_plain(q, k, v, sw, w, bias, True)
        out = run()
        _compare(res, "K8", label, out, plain(), fused_ocab.ocab_core_plain(*f32, w, bias, True),
                 cuda_ms(run), cuda_ms(plain), _ocab_work(windows, nq, nk, c, nh, hidden))
        runb = lambda: fused_ocab.fused_ocab_core_backward(ct, q, k, v, sw, w, bias, True)
        plainb = lambda: fused_ocab.ocab_core_bwd_plain(ct, q, k, v, sw, w, bias, True)
        got = runb()
        ref16 = plainb()
        ref32 = fused_ocab.ocab_core_bwd_plain(ct.float(), *f32, w, bias, True)
        torch.cuda.synchronize()
        _compare_grads(res, "K8b", label, got, ref16, ref32, ("dq", "dk", "dv", "dsw"),
                       fused_ocab.GRAD_FIELDS + ("bias",), cuda_ms(runb), cuda_ms(plainb),
                       _ocab_work(windows, nq, nk, c, nh, hidden, backward=True))
        del out, got, ref16, ref32
    return res


def _random_dat_block(gen, device, c=180, nh=6, split=(8, 16), hidden=360):
    """One DAT block's weights at DATConfig()'s widths with O(1)
    activations (bf16-representable GEMM weights): the spatial and
    channel fronts (K9, K14) and the tail (K10)."""
    import torch

    from tpu_superresolution_torch.kernels.fused_channel_attn import ChanAttnWeights
    from tpu_superresolution_torch.kernels.fused_datb_tail import TailWeights
    from tpu_superresolution_torch.kernels.fused_rect_attn import RectAttnWeights

    def r(*shape, scale=1.0, bf=False):
        t = torch.randn(*shape, generator=gen) * scale
        return (t.bfloat16().float() if bf else t).to(device)

    n, half, m = split[0] * split[1], hidden // 2, c // 16
    front = dict(g1=1 + r(c, scale=0.1), b1=r(c, scale=0.1),
                 wqkv=r(3 * c, c, scale=c ** -0.5, bf=True), bqkv=r(3 * c, scale=0.1),
                 wdw=r(3, 3, c, scale=1 / 3), bdw=r(c, scale=0.1), num_heads=nh)
    rect = RectAttnWeights(bias0=r(nh // 2, n, n, scale=0.5), bias1=r(nh // 2, n, n, scale=0.5),
                           split=split, **front)
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


def phase_dat_kernels(res):
    """DAT's kernels at DATConfig()'s widths (C 180, 6 heads, split
    (8, 16), hidden 360) on the bench tile batch [25,64,64,180] and on a
    whole image whose sides are not multiples of 16 ([2,52,76,180]): K9
    unshifted and shifted, K14, K10; each output against the plain
    version in bf16 and fp32, with times and bounds, into `res`."""
    import torch

    from tpu_superresolution_torch.kernels import fused_channel_attn as fc
    from tpu_superresolution_torch.kernels import fused_datb_tail as ft
    from tpu_superresolution_torch.kernels import fused_rect_attn as fr

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 4)
    bf = torch.bfloat16
    rect, chan, tail = _random_dat_block(gen, dev)
    prect, pchan, ptail = (fr.pack_rect_weights(rect), fc.pack_chan_weights(chan),
                           ft.pack_tail_weights(tail))
    for shape in ((25, 64, 64, 180), (2, 52, 76, 180)):
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        for shifted in (False, True):
            run = lambda: fr.rect_attention(x, rect, shifted, prect)
            plain = lambda: fr.rect_attention_plain(x, rect, shifted)
            outs = run()
            refs16, refs32 = plain(), fr.rect_attention_plain(x.float(), rect, shifted)
            torch.cuda.synchronize()
            _compare_outputs(res, "K9", f"{list(shape)} {'shifted' if shifted else 'unshifted'}",
                             outs, refs16, refs32, cuda_ms(run), cuda_ms(plain),
                             _dat_work("K9", shape))
            del outs, refs16, refs32
        run = lambda: fc.channel_attention(x, chan, pchan)
        plain = lambda: fc.channel_attention_plain(x, chan)
        outs = run()
        refs16, refs32 = plain(), fc.channel_attention_plain(x.float(), chan)
        torch.cuda.synchronize()
        _compare_outputs(res, "K14", f"{list(shape)}", outs, refs16, refs32, cuda_ms(run),
                         cuda_ms(plain), _dat_work("K14", shape))
        del outs, refs16, refs32
        u = torch.randn(*shape, generator=gen).to(dev, bf)
        w_px = torch.randn(*shape, generator=gen).to(dev, bf)
        gate = torch.sigmoid(torch.randn(shape[0], shape[3], generator=gen)).to(dev)
        run = lambda: ft.datb_tail(x, u, w_px, gate, tail, ptail)
        plain = lambda: ft.datb_tail_plain(x, u, w_px, gate, tail)
        out = run()
        ref16, ref32 = plain(), ft.datb_tail_plain(x.float(), u.float(), w_px.float(), gate, tail)
        torch.cuda.synchronize()
        _compare_outputs(res, "K10", f"{list(shape)}", (out,), (ref16,), (ref32,), cuda_ms(run),
                         cuda_ms(plain), _dat_work("K10", shape))
        del out, ref16, ref32
    return res


def _k16_work(bw, nh, n, hd, n_mask):
    """(FLOPs, bytes) of one K16 call: QK^T and AV (4 N hd a query row);
    q, k, v and the output in bf16, the bias and the mask in fp32, each
    once."""
    return bw * nh * 4 * n * n * hd, 4 * bw * nh * n * hd * 2 + (nh + n_mask) * n * n * 4


def phase_dat_train_kernels(res):
    """The DAT module chain's kernels: K16 (batched window attention) at
    the DAT train step's [256, 3, 128, 30] and the bench tile batch's
    [800, 3, 128, 30] (DATConfig(): windows 8 x 16 of a 64^2 map, 3 heads
    a branch of hd 30), each with and without the shift mask, and at the
    published DAT x4's N 256 ([400, 3, 256, 30], windows 8 x 32); K11
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
    nh, hd = 3, 30
    for bw, (hsp, wsp) in ((256, (8, 16)), (800, (8, 16)), (400, (8, 32))):
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
            ref16, ref32 = plain(), kw.batched_window_attention_plain(q.float(), k.float(),
                                                                      v.float(), bias, mask)
            am = bias[None].expand(bw, nh, n, n)
            if mask is not None:
                am = am + mask[torch.arange(bw, device=dev) % n_mask][:, None]
            am = am.to(bf).contiguous()
            lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=1.0)
            torch.cuda.synchronize()
            _compare(res, "K16", f"[{bw},{nh},{n},{hd}] {'masked' if masked else 'unmasked'}",
                     out, ref16, ref32, cuda_ms(run), cuda_ms(plain),
                     _k16_work(bw, nh, n, hd, n_mask), cuda_ms(lib))
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
        _compare(res, "K11", f"{list(shape)}", out, ref16, ref32, cuda_ms(run), cuda_ms(plain),
                 (18 * pixels * c, 2 * pixels * c * 2 + 10 * c * 4), cuda_ms(lib))
        del out, ref16, ref32
    return res


def _random_k7(gen, device, c, nh, ws):
    """K7's raw weights at width C, `nh` heads and window `ws` with O(1)
    activations (bf16-representable GEMM weights) and its gathered
    [nh, ws^2, ws^2] bias."""
    import torch

    from tpu_superresolution_torch.ops.window import relative_position_bias

    def r(*shape, scale=1.0, bf=False):
        t = torch.randn(*shape, generator=gen) * scale
        return (t.bfloat16().float() if bf else t).to(device)

    table = r((2 * ws - 1) ** 2, nh, scale=0.5)
    return (r(3 * c, c, scale=c ** -0.5, bf=True), r(3 * c, scale=0.1),
            r(c, c, scale=c ** -0.5, bf=True), r(c, scale=0.1),
            relative_position_bias(table, ws))


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


def phase_window_kernels(res):
    """K7 (the window-attention kernel for any window) and K12 (HAT's
    fused LN + CAB convs) at the main paths' shapes, each output within
    ULP_BOUND bf16 ulps of its plain bf16 and fp32 versions, with times
    and bounds, into `res`.  K7: HAT-SRx4's bench batch [25,64,64,180]
    at ws 16 (N 256), unshifted and shift 8 with the mask; SwinIR-L's
    widths (C 240, 8 heads) at ws 8 shifted; ws 6 (N 36); ws 32 (N
    1024) shifted.  K1t (K1's tail on the K7 route): HAT-SRx4's widths
    at ws 16, shift 8, with `extra`; SwinIR-L's (C 240, hidden 480) at
    ws 8, shift 4, with branch scales.  K12: the HAT-SRx4, HAT (ws 7,
    reflect-padded tiles), hat_fast and HAT-S shapes, each also timed
    against the composition it replaced in the CAB (K2, then cuDNN
    conv, GELU, cuDNN conv).  Each kernel's first case is the one the
    kernels line reports."""
    import torch
    import torch.nn.functional as F

    from tpu_superresolution_torch.kernels import cab_conv as cc
    from tpu_superresolution_torch.kernels import fused_attention as fa
    from tpu_superresolution_torch.kernels import fused_block as fb
    from tpu_superresolution_torch.kernels.layernorm import layernorm
    from tpu_superresolution_torch.ops.window import shift_mask_tensor, window_partition

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 6)
    bf = torch.bfloat16
    for shape, nh, ws, shift in (((25, 64, 64, 180), 6, 16, 0), ((25, 64, 64, 180), 6, 16, 8),
                                 ((25, 64, 64, 240), 8, 8, 4), ((8, 48, 48, 180), 6, 6, 3),
                                 ((2, 64, 64, 180), 6, 32, 16)):
        c = shape[-1]
        wqkv, bqkv, wproj, bproj, rpb = _random_k7(gen, dev, c, nh, ws)
        packed = fa.pack_window_attention(wqkv, bqkv, wproj, bproj, rpb)
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        xw = window_partition(x, ws).contiguous()
        mask = shift_mask_tensor(shape[1], shape[2], ws, shift, dev) if shift else None
        run = lambda: fa.fused_window_attention(xw, wqkv, bqkv, wproj, bproj, rpb, mask,
                                                packed=packed)
        scale = (c // nh) ** -0.5
        plain = lambda: fa.window_attention_plain(xw, wqkv, bqkv, wproj, bproj, rpb, mask, scale)
        out = run()
        ref16 = plain()
        ref32 = fa.window_attention_plain(xw.float(), wqkv, bqkv, wproj, bproj, rpb, mask, scale)
        torch.cuda.synchronize()
        _compare(res, "K7", f"{list(shape)} C {c} {nh} heads ws {ws} (N {ws * ws}) shift {shift}",
                 out, ref16, ref32, cuda_ms(run), cuda_ms(plain),
                 _k7_work(xw.shape[0], ws * ws, c, nh))
        del out, ref16, ref32

    for shape, nh, hidden, ws, shift, with_extra, with_scales in (
            ((25, 64, 64, 180), 6, 360, 16, 8, True, False),
            ((25, 64, 64, 240), 8, 480, 8, 4, False, True)):
        b, c = shape[0], shape[-1]
        w = _random_block(gen, dev, c=c, nh=nh, hidden=hidden, ws=ws)
        packed = fb.pack_block_tail(w.g2, w.b2, w.wfc1, w.bfc1, w.wfc2, w.bfc2)
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        windows = b * (shape[1] // ws) * (shape[2] // ws)
        attn = torch.randn(windows, ws * ws, c, generator=gen).to(dev, bf)
        extra = (0.1 * torch.randn(*shape, generator=gen)).to(dev, bf) if with_extra else None
        scales = (torch.tensor([[1.0, 0.0], [1.25, 1.25]]).repeat(b // 2 + 1, 1)[:b].to(dev)
                  if with_scales else None)
        run = lambda: fb.fused_block_tail(x, attn, w, ws, shift, False, scales, extra,
                                          packed=packed)
        plain = lambda: fb.swin_block_tail_plain(x, attn, w, ws, shift, False, scales, extra)
        out = run()
        ref16 = plain()
        ref32 = fb.swin_block_tail_plain(x.float(), attn.float(), w, ws, shift, False, scales,
                                         None if extra is None else extra.float())
        torch.cuda.synchronize()
        _compare(res, "K1t", f"{list(shape)} hidden {hidden} ws {ws} shift {shift}"
                 f"{', extra' if with_extra else ''}{', branch scales' if with_scales else ''}",
                 out, ref16, ref32, cuda_ms(run), cuda_ms(plain),
                 _tail_work(math.prod(shape[:3]), c, hidden, with_extra))
        del out, ref16, ref32

    for label, shape, cm in (("HAT-SRx4", (25, 64, 64, 180), 60),
                             ("HAT (ws 7, padded tiles)", (25, 70, 70, 96), 32),
                             ("hat_fast", (25, 64, 64, 96), 32),
                             ("HAT-S (compress 24)", (25, 64, 64, 144), 6)):
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
        out = run()
        ref16 = plain()
        ref32 = cc.fused_ln_cab_convs_plain(x.float(), g, b, k1, c1, k2, c2)
        torch.cuda.synchronize()
        t_kernel, t_composed = cuda_ms(run), cuda_ms(composed)
        _compare(res, "K12", f"{label} {list(shape)} {c} -> {cm} -> {c}", out, ref16, ref32,
                 t_kernel, cuda_ms(plain), _k12_work(math.prod(shape[:3]), c, cm))
        log(f"[kernels] K12 {label}: kernel {t_kernel:.4f} ms, the K2 + cuDNN convs + GELU it "
            f"replaced {t_composed:.4f} ms ({t_kernel / t_composed:.2f}x)")
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
    return lambda: tiled_forward(service.model, x, 4, 64, 8)


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
    statistics): K9 and K10 refuse its blocks, so they take the module
    chain (K16, K11) where they used to raise.  (1) Its .pth behind
    SRService with --model dat: the weights carry no split, so it loads
    at (8, 16) with expansion 4 (K9 and K14 fronts, module-chain tails;
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
    if routes != [("chain", "chain"), ("K14", "chain")]:
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
    torch.profiler: K9 (rect_attn_kernel + dwconv_gelu_kernel), K14
    (chan_qkv / chan_softmax / chan_apply), K10, K16, K11, K2, K3/K4 by
    kernel name, the rest (the module chain's GEMMs, BatchNorm, GELU,
    partitions and pads, channel gates, conv_first, pixel shuffle,
    tiling, casts) as plain ops, and the device's idle share of the wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with torch.no_grad(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    except Exception as e:  # the profile is a reading aid, not a check
        log(f"[{tag}] profiler failed: {type(e).__name__}: {e}")
        return
    kernels = _device_kernels(prof)
    if not kernels:
        log(f"[{tag}] profiler: no device events recorded")
        return
    us = lambda e: getattr(e, "device_time", 0.0) or getattr(e, "cuda_time", 0.0)
    names = (("K9 rect_attn_kernel", ("rect_attn_kernel",)),
             ("K9 dwconv_gelu_kernel", ("dwconv_gelu_kernel",)),
             ("K14 chan_qkv_kernel", ("chan_qkv_kernel",)),
             ("K14 chan_softmax + chan_apply", ("chan_softmax_kernel", "chan_apply_kernel")),
             ("K10 datb_tail_kernel", ("datb_tail_kernel",)),
             ("K16 batched_attn_kernel", ("batched_attn_kernel",)),
             ("K11 dwconv3x3_kernel", ("dwconv3x3_kernel",)),
             ("K2 layernorm", ("layernorm_rows",)),
             ("K3/K4 conv_nhwc", ("conv_nhwc",)))
    other = ("plain ops (module-chain GEMMs, BatchNorm, GELU, partitions, channel gates, "
             "conv_first, pixel shuffle, tiling, casts)")
    groups = dict.fromkeys([g for g, _ in names] + [other], 0.0)
    for e in kernels:
        g = next((g for g, keys in names if any(k in e.name for k in keys)), other)
        groups[g] += us(e) / 1e3
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


def phase_swinir_l(smi):
    """One forward at SwinIR-L's widths (the real-world x4 model: embed
    240, 8 heads, ws 8, depths 9x6, 3conv, nearest+conv; seeded random
    weights) on 4 tiles of 64^2 in bf16: every block takes the K7 route
    (C 240 is past the block kernel's 192); its launches, and its output
    against the plain fp32 path."""
    import numpy as np
    import torch

    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    cfg = SwinIRConfig(scale=4, embed_dim=240, depths=(6,) * 9, num_heads=(8,) * 9,
                       window_size=8, mlp_ratio=2.0, resi_connection="3conv",
                       upsampler="nearest+conv", num_feat=64)
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
    log(f"[swinir-l] SwinIR-L widths (embed 240, 8 heads, ws 8, depths 9x6, 3conv, "
        f"nearest+conv), [4,64,64,3] bf16: launches {counts} (expected {SWINIR_L_PER_CALL}); "
        f"{ms:.2f} ms; PSNR vs plain fp32 {psnr:.2f} dB (bound >= {PSNR_MIN_DB} dB) ({smi})")
    if counts != SWINIR_L_PER_CALL:
        raise RuntimeError(f"SwinIR-L launches {counts}, expected {SWINIR_L_PER_CALL}")
    if psnr < PSNR_MIN_DB or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"SwinIR-L output PSNR {psnr:.2f} dB < {PSNR_MIN_DB} dB")
    return counts


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
    path, and a profiled forward split by part.  Returns the launches of
    the served requests."""
    service, launches = phase_serve(workdir, hat_srx4_config(), "hat", HAT_SRX4_PER_CALL,
                                    tag="hat_srx4")
    fwd = phase_bench(service, smi, name="HAT-SRx4", tag="hat_srx4")
    _hat_split(service.model, fwd, smi, tag="hat_srx4")
    return launches


def _hat_split(model, fwd, smi, tag="hat"):
    """Where one HAT bench forward spends its device time, under
    torch.profiler: the block kernel (K6 or K1), K7, K1t, K12, K2, K3/K4
    by kernel name, the other kernels by the module whose profiler range
    launched them (the CAB's SE gate, the OCABs' plain ops, the HABs'
    plain ops on the K7 route: the shift and partition gathers; the
    rest), and the device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpu_superresolution_torch.models.hat import CAB, HAB, OCAB

    parts = {HAB: "hat::hab", CAB: "hat::cab", OCAB: "hat::ocab"}
    stack, handles = [], []
    for m in model.modules():
        if type(m) in parts:
            def enter(mod, args, name=parts[type(m)]):
                stack.append(record_function(name))
                stack[-1].__enter__()

            handles.append(m.register_forward_pre_hook(enter))
            handles.append(m.register_forward_hook(
                lambda mod, args, out: stack.pop().__exit__(None, None, None)))
    try:
        with torch.no_grad(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.events()
    except Exception as e:  # the profile is a reading aid, not a check
        log(f"[{tag}] profiler failed: {type(e).__name__}: {e}")
        return
    finally:
        for h in handles:
            h.remove()
    kernels = _device_kernels(prof)
    if not kernels:
        log(f"[{tag}] profiler: no device events recorded")
        return
    # the device-side spans of the module ranges
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA
             and getattr(e, "is_user_annotation", False) and e.name in parts.values()]
    us = lambda e: getattr(e, "device_time", 0.0) or getattr(e, "cuda_time", 0.0)
    names = (("block kernel (swin_block_kernel)", ("swin_block_kernel",)),
             ("K7 qkv_gemm_kernel", ("qkv_gemm_kernel",)),
             ("K7 window_attn_kernel", ("window_attn_kernel",)),
             ("K1t swin_tail_kernel", ("swin_tail_kernel",)),
             ("K12 ln_cab_convs_kernel", ("ln_cab_convs_kernel",)),
             ("K2 layernorm", ("layernorm_rows",)), ("K3/K4 conv_nhwc", ("conv_nhwc",)))
    by_span = (("hat::cab", "CAB SE gate (plain ops)"), ("hat::ocab", "OCAB plain ops"),
               ("hat::hab", "HAB plain ops (K7 route: the shift and partition gathers)"))
    other = "other (conv_first, mean shift, tiling, casts)"
    groups = dict.fromkeys([g for g, _ in names] + [g for _, g in by_span] + [other], 0.0)
    for e in kernels:
        n, t = e.name, e.time_range.start
        inside = {name for a, b, name in spans if a <= t <= b}
        g = next((g for g, keys in names if any(k in n for k in keys)), None)
        g = g or next((g for span, g in by_span if span in inside), other)
        groups[g] += us(e) / 1e3
    busy = sum(groups.values())
    idle = max(wall - busy, 0.0)
    log(f"[{tag}] profiled forward: {wall:.2f} ms wall (profiler on), {len(kernels)} device "
        f"kernels, busy {busy:.2f} ms, idle {idle:.2f} ms ({idle / wall:.1%}); "
        f"{len(spans)} module ranges seen on the device ({smi})")
    for g, t in groups.items():
        log(f"[{tag}]   {t:8.3f} ms  {t / wall:6.1%}  {g}")


def _write_deeprock(root, n_train, n_valid, hr_size, scale, seed):
    """A synthetic DeepRockSR-2D-layout set: smooth grayscale HR images
    (bicubic-upsampled noise) and their bicubic LR, named <stem>x<s>."""
    from pathlib import Path

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("valid", n_valid)):
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
        for _ in range(3):
            step(st, lr, hr, gen)
        torch.cuda.synchronize()
        reset_counters()
        step(st, lr, hr, gen)
        torch.cuda.synchronize()
        per_step = read_counters()
        dts = []
        for _ in range(TRAIN_TIMED_STEPS):
            t0 = time.perf_counter()
            m = step(st, lr, hr, gen)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        ms = statistics.median(dts) * 1e3
        times[label] = ms
        log(f"[train] {label} bf16 path: launches per step {per_step}; median "
            f"{ms:.2f} ms/step over {TRAIN_TIMED_STEPS} steps after 4 warm-up "
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


def _first_step_gate(cfg, src, lr, hr, tag, smi, bf16_floor=False):
    """The first train step's gradients, kernels (bf16) against the plain
    fp32 path from the same weights, batch and stochastic-depth masks:
    loss, grad norm and every parameter's gradient cosine within the
    gates.  The plain bf16 path (the same roundings, no kernels) runs
    beside: a parameter whose plain bf16 gradient is itself below the
    cosine bound is bf16-limited, and passes only if its fp32 and kernel
    gradients are below ADAMW_EPS element by element (see there).  With
    `bf16_floor` (DAT, see BF16_FLOOR) a parameter below the cosine bound
    passes if those gradients are below ADAMW_EPS, or if the kernels'
    gradient is no farther from fp32 than twice the plain bf16 path's
    (relative L2): the kernels add no more error than bf16 rounding
    already does.  Each exception is logged by name.  Returns {name:
    cosine}."""
    import torch

    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.train.engine import global_norm

    runs = {}
    for label, dtype, impl in (("kernels", torch.bfloat16, "auto"),
                               ("plain fp32", torch.float32, "plain"),
                               ("plain bf16", torch.bfloat16, "plain")):
        model = build_model(cfg, dtype=dtype, impl=impl, device="cuda")
        model.load_state_dict(src.state_dict())
        runs[label] = _first_step_grads(model, lr, hr)
        del model
    (loss_k, g_k, s_k), (loss_r, g_r, s_r), _ = runs.values()
    g_p = runs["plain bf16"][1]
    gn_k, gn_r = float(global_norm(list(g_k.values()))), float(global_norm(list(g_r.values())))
    cos, cos_plain = _cosines(g_k, g_r), _cosines(g_p, g_r)
    amax = lambda g, k: float(g[k].abs().max())
    err = lambda g, k: float((g[k] - g_r[k]).norm()) / max(float(g_r[k].norm()), 1e-30)
    tiny = lambda k: max(amax(g_k, k), amax(g_r, k)) < ADAMW_EPS
    below = [k for k in cos if cos[k] < TRAIN_COS_MIN]
    if bf16_floor:
        limited = {k: (cos[k], cos_plain.get(k, math.nan), amax(g_k, k), amax(g_r, k))
                   for k in below if tiny(k) or err(g_k, k) <= 2 * err(g_p, k)}
    else:
        limited = {k: (cos[k], cos_plain[k], amax(g_k, k), amax(g_r, k))
                   for k in below if cos_plain.get(k, 1.0) < TRAIN_COS_MIN}
    gated = {k: v for k, v in cos.items() if k not in limited}
    worst = sorted(gated.items(), key=lambda kv: kv[1])[:3]
    rel_loss = abs(loss_k - loss_r) / abs(loss_r)
    rel_gn = abs(gn_k - gn_r) / gn_r
    ok = (rel_loss <= TRAIN_LOSS_RTOL and rel_gn <= TRAIN_GNORM_RTOL
          and min(gated.values()) >= TRAIN_COS_MIN
          and (bf16_floor or all(tiny(k) for k in limited)))
    log(f"[{tag}] first step vs plain fp32 path: loss {loss_k:.6f} vs {loss_r:.6f} (rel "
        f"{rel_loss:.2e}, bound {TRAIN_LOSS_RTOL}); grad norm {gn_k:.5f} vs {gn_r:.5f} (rel "
        f"{rel_gn:.2e}, bound {TRAIN_GNORM_RTOL}); gradient cosine over {len(gated)} of "
        f"{len(g_r)} parameters, lowest {worst} (bound >= {TRAIN_COS_MIN}); plain bf16 vs "
        f"fp32 lowest {sorted(cos_plain.items(), key=lambda kv: kv[1])[:3]} "
        f"{'ok' if ok else 'FAIL'} ({smi})")
    below = sorted((k for k, v in gated.items() if v < TRAIN_COS_MIN), key=gated.get)
    if below:
        cos_kp = _cosines(g_k, g_p)
        log(f"[{tag}] {len(below)} parameters below the cosine bound")
        for k in below[:12]:
            log(f"[{tag}]   {k}: cosine kernels {cos[k]:.4f}, plain bf16 "
                f"{cos_plain.get(k, math.nan):.4f}, kernels vs plain bf16 "
                f"{cos_kp.get(k, math.nan):.4f}; fp32 max |g| {amax(g_r, k):.3e}, norm "
                f"{float(g_r[k].norm()):.3e}")
    zero = sorted(set(g_r) - set(cos))
    if zero:
        log(f"[{tag}] {len(zero)} parameters with an exactly zero gradient in both paths, left "
            f"out of the cosine gate: {zero}")
    for k, (ck, cp, mk, mr) in sorted(limited.items()):
        why = (f"relative L2 error kernels {err(g_k, k):.3e}, plain bf16 {err(g_p, k):.3e} "
               f"(bound: twice plain bf16's, or max |g| < AdamW eps {ADAMW_EPS})" if bf16_floor
               else f"bound max |g| < AdamW eps {ADAMW_EPS}")
        log(f"[{tag}] bf16-limited: {k}: cosine kernels {ck:.4f}, plain bf16 {cp:.4f}; max |g| "
            f"kernels {mk:.3e}, fp32 {mr:.3e}; {why}; fp32 norm {float(g_r[k].norm()):.3e} "
            f"of global {gn_r:.3e}")
    if not ok:
        raise RuntimeError(f"{tag}: train step gradients disagree with the plain fp32 path")
    if s_r:
        _compare_batch_stats(s_k, s_r, tag, smi)
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
        for _ in range(3):
            step(st, lr, hr, gen)
        torch.cuda.synchronize()
        reset_counters()
        step(st, lr, hr, gen)
        torch.cuda.synchronize()
        per_step = read_counters()
        dts = []
        for _ in range(TRAIN_TIMED_STEPS):
            t0 = time.perf_counter()
            m = step(st, lr, hr, gen)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        ms = statistics.median(dts) * 1e3
        log(f"[hat-train] {label} bf16 path: launches per step {per_step}; median {ms:.2f} "
            f"ms/step over {TRAIN_TIMED_STEPS} steps after 4 warm-up (min "
            f"{min(dts) * 1e3:.2f}, max {max(dts) * 1e3:.2f}), {batch / ms * 1e3:.1f} images/s; "
            f"loss {float(m['loss']):.6f} ({smi})")
        if label == "kernels":
            if per_step != HAT_TRAIN_PER_STEP:
                raise RuntimeError(f"HAT launches per train step {per_step}, expected "
                                   f"{HAT_TRAIN_PER_STEP}")
            per_step_all = per_step
            _hat_train_split(st, lr, hr, ms, smi)
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
    del model, st
    _first_step_gate(fcfg, fsrc, lr, hr, "hat-train hat_fast", smi)
    return [launches, per_step_all, fast]


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
            f"ms/step over {DAT_TIMED_STEPS} steps after 2 warm-up (min "
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

    # 3. the first step's loss, gradients and BatchNorm statistics
    _first_step_gate(cfg, src, lr, hr, "dat-train", smi, bf16_floor=True)
    return [launches, per_step_all]


def _dat_train_split(state, lr, hr, step_ms, smi):
    """Where one DAT train step spends its device time, under
    torch.profiler: the forward, backward and optimizer as ranges, K16,
    K11, K2 and K3/K4 forwards by kernel name, the rest by the range it
    ran in (the forward's plain ops: the GEMMs, BatchNorm, GELU, the
    partitions and pads; the backward: autograd of everything, K16's
    and K11's plain versions included), and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpu_superresolution_torch.train.engine import apply_gradients

    model = state.model
    model.train()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
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
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.events()
    except Exception as e:  # the profile is a reading aid, not a check
        log(f"[dat-train] profiler failed: {type(e).__name__}: {e}")
        return
    kernels = sorted(_device_kernels(prof), key=lambda e: e.time_range.start)
    if not kernels:
        log("[dat-train] profiler: no device events recorded")
        return
    steps = ("step::forward", "step::backward", "step::optimizer")
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == torch.autograd.DeviceType.CPU and e.name in steps]
    us = lambda e: getattr(e, "device_time", 0.0) or getattr(e, "cuda_time", 0.0)
    names = (("K16 forward (batched_attn_kernel)", ("batched_attn_kernel",)),
             ("K11 forward (dwconv3x3_kernel)", ("dwconv3x3_kernel",)),
             ("K2-K4 forwards", ("layernorm_rows", "conv_nhwc")))
    by_span = (("step::forward", "other forward ops (GEMMs, BatchNorm, GELU, partitions, pads)"),
               ("step::backward", "backward (autograd; K16's, K11's, K2-K4's plain versions)"),
               ("step::optimizer", "optimizer (norm, clip, AdamW, EMA)"))
    groups = dict.fromkeys([g for g, _ in names] + [g for _, g in by_span] + ["other"], 0.0)
    for e in kernels:
        n, t = e.name, e.time_range.start
        inside = {name for a, b, name in spans if a <= t <= b}
        g = next((g for g, keys in names if any(k in n for k in keys)), None)
        g = g or next((g for span, g in by_span if span in inside), "other")
        groups[g] += us(e) / 1e3
    busy = sum(groups.values())
    idle = max(wall - busy, 0.0)
    log(f"[dat-train] profiled step: {wall:.2f} ms wall (profiler on, a synchronise after "
        f"each phase), {len(kernels)} device kernels, busy {busy:.2f} ms ({busy / wall:.1%}), "
        f"idle {idle:.2f} ms ({idle / wall:.1%}); against the unprofiled median step "
        f"{step_ms:.2f} ms: busy {busy / step_ms:.1%}, idle {max(step_ms - busy, 0.0):.2f} ms "
        f"({smi})")
    for g, t in groups.items():
        log(f"[dat-train]   {t:8.3f} ms  {t / wall:6.1%}  {g}")
    counts = {}
    for e in kernels:
        counts[e.name] = counts.get(e.name, 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:10]
    log(f"[dat-train] most launched device kernels: "
        f"{[(n[:60], c) for n, c in top]}")


def _hat_train_split(state, lr, hr, step_ms, smi):
    """Where one HAT train step spends its device time, under
    torch.profiler: the forward, backward and optimizer as ranges, the
    kernels by name (K6, K6b, K8, K8b, each backward's weight-gradient
    products and reductions attributed to the per-window kernel before
    them; K12; K2-K4), the CAB's SE gate by module range, the rest by
    the range it ran in, and the device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpu_superresolution_torch.models.hat import CAB
    from tpu_superresolution_torch.train.engine import apply_gradients

    model = state.model
    stack, handles = [], []
    for m in model.modules():
        if isinstance(m, CAB):
            def enter(mod, args):
                stack.append(record_function("hat::cab"))
                stack[-1].__enter__()

            handles.append(m.register_forward_pre_hook(enter))
            handles.append(m.register_forward_hook(
                lambda mod, args, out: stack.pop().__exit__(None, None, None)))
    model.train()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state.optimizer.zero_grad(set_to_none=True)
            # each phase ends in a synchronise, so a device kernel starts
            # inside the host-side span of the phase that launched it
            # (the backward launches from autograd's own thread)
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
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.events()
    except Exception as e:  # the profile is a reading aid, not a check
        log(f"[hat-train] profiler failed: {type(e).__name__}: {e}")
        return
    finally:
        for h in handles:
            h.remove()
    kernels = sorted(_device_kernels(prof), key=lambda e: e.time_range.start)
    if not kernels:
        log("[hat-train] profiler: no device events recorded")
        return
    steps = ("step::forward", "step::backward", "step::optimizer")
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if (e.device_type == torch.autograd.DeviceType.CUDA
                 and getattr(e, "is_user_annotation", False) and e.name == "hat::cab")
             or (e.device_type == torch.autograd.DeviceType.CPU and e.name in steps)]
    us = lambda e: getattr(e, "device_time", 0.0) or getattr(e, "cuda_time", 0.0)
    groups = dict.fromkeys((
        "K6 forward (swin_block_kernel<7>)", "K6b (per-window, weight grads, reductions)",
        "K8 forward (ocab_fwd_kernel)", "K8b (per-window, weight grads, reductions)",
        "K12 forward (ln_cab_convs_kernel)", "K2-K4 forwards", "CAB SE gate forward",
        "other forward ops",
        "plain-op backwards (CAB, K2-K4, gathers, casts)", "optimizer (norm, clip, AdamW)",
        "other"), 0.0)
    last_bwd = "K6b (per-window, weight grads, reductions)"
    for e in kernels:
        n, t = e.name, e.time_range.start
        inside = {name for a, b, name in spans if a <= t <= b}
        if "swin_block_bwd_window" in n:
            g = last_bwd = "K6b (per-window, weight grads, reductions)"
        elif "ocab_bwd_kernel" in n:
            g = last_bwd = "K8b (per-window, weight grads, reductions)"
        elif "wgrad_kernel" in n or "reduce_rows_kernel" in n:
            g = last_bwd
        elif "swin_block_kernel" in n:
            g = "K6 forward (swin_block_kernel<7>)"
        elif "ocab_fwd_kernel" in n:
            g = "K8 forward (ocab_fwd_kernel)"
        elif "ln_cab_convs_kernel" in n:
            g = "K12 forward (ln_cab_convs_kernel)"
        elif "layernorm_rows" in n or "conv_nhwc" in n:
            g = "K2-K4 forwards"
        elif "hat::cab" in inside:
            g = "CAB SE gate forward"
        elif "step::forward" in inside:
            g = "other forward ops"
        elif "step::backward" in inside:
            g = "plain-op backwards (CAB, K2-K4, gathers, casts)"
        elif "step::optimizer" in inside:
            g = "optimizer (norm, clip, AdamW)"
        else:
            g = "other"
        groups[g] += us(e) / 1e3
    busy = sum(groups.values())
    idle = max(wall - busy, 0.0)
    log(f"[hat-train] profiled step: {wall:.2f} ms wall (profiler on, a synchronise after "
        f"each phase), {len(kernels)} device kernels, busy {busy:.2f} ms ({busy / wall:.1%}), "
        f"idle {idle:.2f} ms ({idle / wall:.1%}); against the unprofiled median step "
        f"{step_ms:.2f} ms: busy {busy / step_ms:.1%}, idle {max(step_ms - busy, 0.0):.2f} ms; "
        f"{len(spans)} ranges ({smi})")
    for g, t in groups.items():
        log(f"[hat-train]   {t:8.3f} ms  {t / wall:6.1%}  {g}")


def _device_kernels(prof):
    """The profile's kernels on the card (not the user-annotation ranges
    that the profiler also places on the device timeline)."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _packing_cost(model):
    """What K1's weight packing costs each train step: device kernels
    and synchronised milliseconds for all blocks."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_superresolution_torch.kernels.fused_block import pack_block_weights

    weights = [b.block_weights() for layer in model.layers
               for b in layer.residual_group.blocks]
    run = lambda: [pack_block_weights(w) for w in weights]
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    n = len(_device_kernels(prof))
    t0 = time.perf_counter()
    for _ in range(5):
        run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    log(f"[train] K1 weight packing per step: {len(weights)} blocks, {n} device kernels "
        f"({n / len(weights):.0f} per block), {ms:.2f} ms (host and device, synchronised)")


def _profile_step(step, state, lr, hr, gen):
    """torch.profiler over one train step: device time by kernel name
    and the step's CUDA kernel count (the weight packing's small ops
    included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, lr, hr, gen)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = _device_kernels(prof)
    except Exception as e:  # the profile is a reading aid, not a check
        log(f"[train] profiler failed: {type(e).__name__}: {e}")
        return
    if not kernels:
        log("[train] profiler: no device events recorded")
        return
    us = lambda e: getattr(e, "device_time", 0.0) or getattr(e, "cuda_time", 0.0)
    busy = sum(us(e) for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us(e) / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    small = sum(n for n, t in by_name.values() if t / max(n, 1) < 0.01)
    log(f"[train] profiled step: {wall:.2f} ms wall (profiler on), {len(kernels)} device "
        f"kernels, device busy {busy:.2f} ms ({busy / wall:.1%}); kernels under 10 us "
        f"each: {small}")
    for name, (n, t) in top:
        log(f"[train]   {t:8.3f} ms  x{n:<4d} {name[:90]}")


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
    kres = timed("kernels", lambda: phase_dat_train_kernels(phase_window_kernels(
        phase_dat_kernels(phase_train_kernels(phase_kernels())))))
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_lib.BUILD_DIR) as workdir:
        service, launches = timed("serve", phase_serve, workdir, SwinIRConfig(scale=4),
                                  "swinir", PER_CALL)
        timed("bench", phase_bench, service, smi)
        del service
        ws7_launches = timed("swinir-ws7", phase_swinir_ws7, smi)
        swinir_l_launches = timed("swinir-l", phase_swinir_l, smi)
        hat_launches = timed("hat", phase_hat, workdir, smi)
        dat_launches = timed("dat", phase_dat, workdir, smi)
        train_launches, _ = timed("train", phase_train, workdir, smi)
        hat_train_launches = timed("hat-train", phase_hat_train, workdir, smi)
        srx4_launches = timed("hat_srx4", phase_hat_srx4, workdir, smi)
        dat_x4_launches = timed("dat_x4", phase_dat_x4, workdir, smi)
        dat_train_launches = timed("dat-train", phase_dat_train, workdir, smi)

    kernels = []
    for key, meta in KERNELS.items():
        first = kres[key][0]
        kernels.append(dict(
            name=meta["name"], route=meta["route"], source=meta["source"],
            replaces=meta["replaces"],
            launches=sum(d.get(key, 0) for d in [launches, ws7_launches, swinir_l_launches,
                                                 hat_launches, dat_launches, train_launches,
                                                 srx4_launches, dat_x4_launches]
                         + hat_train_launches + dat_train_launches),
            max_abs_err=max(r["err"] for r in kres[key]),
            ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=first["library_ms"],
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
