#!/usr/bin/env python3
"""Drive the PyTorch port's SwinIR-M x4 serving path once on one NVIDIA
H100 and check it.  Run from the repository root:

    python3 chip_smoke.py

Phases (a failure in any raises, and the script exits non-zero):
1. device   the card's name, compute capability 9.0, power limit;
2. build    nvcc-compile the port's kernels from csrc/ (seconds, ptxas);
3. kernels  each kernel (K1-K4) against its plain PyTorch version at the
            main path's shapes: max abs error vs the plain version in
            bf16 and in fp32 (TF32 off), each against its stated bound,
            and the median time of kernel and plain version;
4. serve    SwinIR-M x4 (seeded random weights, exported to a .pth) behind
            SRService + make_server on 127.0.0.1, three PNG requests;
            status, size, finite output, launch counts per model call,
            and PSNR >= 50 dB of the served tiled output against the
            plain fp32 path;
5. bench    the bench.py workload (256^2 LR, tile 64, overlap 8, x4, bf16,
            25 tiles in one batch, 10 timed iterations) in MPix/s, for the
            kernels and for the plain path.

The second-to-last stdout line is a JSON object describing each kernel;
the last is {"ok": true, "device": {...}}.  There is no CPU path: with
no CUDA device the script exits non-zero and prints no result.
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
ULP_BOUND = {"K1": 8, "K2": 4, "K3": 4, "K4": 4}

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
}
# Launches per SwinIR-M x4 model call on the serving path (--no-exact).
PER_CALL = {"K1": 36, "K2": 2, "K3": 8, "K4": 1}


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


def _random_block(gen, device, c=180, nh=6, hidden=360):
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
        table=r(225, nh), num_heads=nh,
    )


def _compare(results, key, label, out, ref_bf16, ref_fp32, t_kernel, t_plain):
    mag = float(ref_fp32.abs().max())
    bound = ULP_BOUND[key] * bf16_ulp(mag)
    e16 = float((out.float() - ref_bf16.float()).abs().max())
    e32 = float((out.float() - ref_fp32.float()).abs().max())
    ok = e16 <= bound and e32 <= bound and math.isfinite(e16) and math.isfinite(e32)
    log(f"[kernels] {key} {label}: max_abs_err vs plain bf16 {e16:.3e}, vs plain fp32 "
        f"{e32:.3e} (bound {bound:.3e} = {ULP_BOUND[key]} bf16 ulp at max|ref| {mag:.3f}) "
        f"{'ok' if ok else 'FAIL'}; kernel {t_kernel:.4f} ms, plain bf16 {t_plain:.4f} ms")
    if not ok:
        raise RuntimeError(f"{key} {label}: kernel disagrees with its plain version")
    results.setdefault(key, []).append(dict(label=label, err=e32, ms=t_kernel, plain_ms=t_plain))


def phase_kernels():
    import torch

    from tpu_superresolution_torch.kernels.cab_conv import conv3x3, conv_k, conv_plain
    from tpu_superresolution_torch.kernels.fused_block import (
        fused_swin_block,
        pack_block_weights,
        swin_block_plain,
    )
    from tpu_superresolution_torch.kernels.layernorm import layernorm, layernorm_plain
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    bf = torch.bfloat16
    res = {}

    # K1: swin block, shift 0 and 4 on the serve tile batch, and a whole image
    w = _random_block(gen, dev)
    packed = pack_block_weights(w)
    for shape, shift in (((8, 64, 64, 180), 0), ((8, 64, 64, 180), 4),
                         ((1, 256, 256, 180), 4)):
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        mask = shift_mask_tensor(shape[1], shape[2], 8, shift, dev) if shift else None
        out = fused_swin_block(x, w, 8, shift, mask, True, packed=packed)
        ref16 = swin_block_plain(x, w, 8, shift, mask, True)
        ref32 = swin_block_plain(x.float(), w, 8, shift, mask, True)
        torch.cuda.synchronize()
        _compare(res, "K1", f"{list(shape)} shift {shift}", out, ref16, ref32,
                 cuda_ms(lambda: fused_swin_block(x, w, 8, shift, mask, True, packed=packed)),
                 cuda_ms(lambda: swin_block_plain(x, w, 8, shift, mask, True)))

    # K2: layernorm on the bench trunk (25 tiles of 64^2)
    x = torch.randn(25 * 64 * 64, 180, generator=gen).to(dev, bf)
    g = (1 + 0.1 * torch.randn(180, generator=gen)).to(dev)
    b = (0.1 * torch.randn(180, generator=gen)).to(dev)
    out = layernorm(x, g, b)
    _compare(res, "K2", "[102400, 180]", out, layernorm_plain(x, g, b),
             layernorm_plain(x.float(), g, b),
             cuda_ms(lambda: layernorm(x, g, b)), cuda_ms(lambda: layernorm_plain(x, g, b)))

    # K3: 3x3 convs 180->180 and 180->64 on bench tiles and a whole image;
    # K4: the composed 5x5 64->48 reconstruction conv.
    cases = [("K3", (25, 64, 64, 180), 180, 3, ((1, 1), (1, 1))),
             ("K3", (25, 64, 64, 180), 64, 3, ((1, 1), (1, 1))),
             ("K3", (1, 256, 256, 180), 180, 3, ((1, 1), (1, 1))),
             ("K3", (1, 256, 256, 180), 64, 3, ((1, 1), (1, 1))),
             ("K4", (25, 64, 64, 64), 48, 5, ((2, 2), (2, 2)))]
    for key, shape, cout, k, pad in cases:
        cin = shape[-1]
        x = torch.randn(*shape, generator=gen).to(dev, bf)
        kern = (torch.randn(k, k, cin, cout, generator=gen) * (k * k * cin) ** -0.5).to(dev, bf)
        bias = (0.1 * torch.randn(cout, generator=gen)).to(dev)
        fn = (lambda: conv3x3(x, kern, bias)) if key == "K3" else (lambda: conv_k(x, kern, bias, pad))
        out = fn()
        _compare(res, key, f"{list(shape)} -> {cout}, {k}x{k}", out,
                 conv_plain(x, kern, bias, pad), conv_plain(x.float(), kern.float(), bias, pad),
                 cuda_ms(fn), cuda_ms(lambda: conv_plain(x, kern, bias, pad)))
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


def phase_serve(workdir):
    import numpy as np
    import torch
    from PIL import Image

    from tpu_superresolution_torch.cli.serve import SRService, make_server
    from tpu_superresolution_torch.core.config import EvalConfig, SwinIRConfig, build_model
    from tpu_superresolution_torch.evaluate.runner import Evaluator
    from tpu_superresolution_torch.evaluate.tiling import tile_grid
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    # SwinIR-M x4 with seeded random weights, exported as a reference .pth
    cfg = SwinIRConfig(scale=4)
    src = build_model(cfg)
    src.reset_parameters(torch.Generator().manual_seed(SEED))
    ckpt = f"{workdir}/swinir_m_x4_random.pth"
    torch.save({"params": src.state_dict()}, ckpt)

    tile_batch = 8
    service = SRService(ckpt, "swinir", "X4", False, -1, 16, tile_batch, device="cuda")
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
    launches_total = {k: 0 for k in PER_CALL}
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
            log(f"[serve] {label}: HTTP {status} {out.shape[1]}x{out.shape[0]} "
                f"{secs * 1e3:.1f} ms round trip ({meta.get('seconds')} s forward, "
                f"tile {meta.get('tile')}); model calls {calls}; launches {counts}")
            if status != 200 or out.shape != (4 * h, 4 * w, 3):
                raise RuntimeError(f"{label}: status {status}, output {out.shape}")
            for k, per in PER_CALL.items():
                if counts[k] < per * calls:
                    raise RuntimeError(
                        f"{label}: {k} launched {counts[k]} times, expected >= {per * calls}")
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
        log(f"[serve] /healthz {health}")
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
    log(f"[serve] tiled 64/8 served PNG vs plain fp32 path: PSNR {psnr:.2f} dB "
        f"(bound >= {PSNR_MIN_DB} dB)")
    if psnr < PSNR_MIN_DB:
        raise RuntimeError(f"served output PSNR {psnr:.2f} dB < {PSNR_MIN_DB} dB")
    return service, launches_total


def phase_bench(service, smi):
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
        log(f"[bench] SwinIR-M x4, 256^2 LR, tile 64/8, 25 tiles in one batch, bf16, "
            f"{label}: {dt * 1e3:.2f} ms/image, {1024 * 1024 / 1e6 / dt:.3f} MPix/s ({smi})")


def main() -> int:
    import torch

    name, smi = phase_device()
    from tpu_superresolution_torch.kernels import _lib

    phase_build()
    kres = phase_kernels()
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_lib.BUILD_DIR) as workdir:
        service, launches = phase_serve(workdir)
    phase_bench(service, smi)

    kernels = []
    for key, meta in KERNELS.items():
        first = kres[key][0]
        kernels.append(dict(
            name=meta["name"], route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], launches=launches[key],
            max_abs_err=max(r["err"] for r in kres[key]),
            ms=first["ms"], plain_ms=first["plain_ms"],
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
