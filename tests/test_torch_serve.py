"""The port's serving entry points on the CPU: a reference-format .pth
through SRService and a real HTTP round trip, checkpoint loading
(config inference, official buffers dropped before the strict load),
and the upscale CLI."""

import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(1)

SMALL = dict(embed_dim=24, depths=(2,), num_heads=(2,), num_feat=16, scale=2)


def _official_buffers(model):
    """The two buffer kinds official SwinIR checkpoints carry."""
    from tpu_superresolution_torch.ops.window import relative_position_index, shift_attn_mask

    out = {}
    for i, layer in enumerate(model.layers):
        for j, blk in enumerate(layer.residual_group.blocks):
            pre = f"layers.{i}.residual_group.blocks.{j}"
            out[f"{pre}.attn.relative_position_index"] = torch.from_numpy(
                relative_position_index(8).astype(np.int64))
            if blk.shift_size:
                out[f"{pre}.attn_mask"] = torch.from_numpy(shift_attn_mask(64, 64, 8, 4))
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model

    model = build_model(SwinIRConfig(**SMALL))
    model.reset_parameters(torch.Generator().manual_seed(0))
    sd = dict(model.state_dict())
    sd.update(_official_buffers(model))
    path = tmp_path_factory.mktemp("serve") / "swinir_x2.pth"
    torch.save({"params": sd}, path)
    return str(path)


@pytest.fixture()
def server(ckpt):
    from tpu_superresolution_torch.cli.serve import SRService, make_server

    service = SRService(ckpt, "swinir", "X2", None, -1, 4, 2, device="cpu")
    srv = make_server(service, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", service
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)


def _png_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_serve_round_trip_equals_direct_forward(server, ckpt):
    from tpu_superresolution_torch.cli.upscale import load_any_checkpoint
    from tpu_superresolution_torch.evaluate.runner import tensor_to_pil

    base, service = server
    arr = (np.random.default_rng(0).random((20, 24, 3)) * 255).astype(np.uint8)
    req = urllib.request.Request(f"{base}/upscale", data=_png_bytes(arr), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        meta = json.loads(resp.headers["X-SR-Meta"])
        body = resp.read()
    assert meta["out_shape"] == [40, 48] and meta["tile"] == 0
    with Image.open(io.BytesIO(body)) as im:
        assert im.size == (48, 40)
        served = np.asarray(im)

    _, model = load_any_checkpoint(ckpt, "swinir", 2, device=torch.device("cpu"))
    with torch.no_grad():
        direct = model(torch.from_numpy(arr.astype(np.float32) / 255.0)[None])[0].numpy()
    np.testing.assert_array_equal(served, np.asarray(tensor_to_pil(direct)))

    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
        health = json.loads(resp.read())
    assert health == {"model": "swinir", "scale": 2, "channels": 3, "served": 1}


def test_serve_tile_override_and_errors(server):
    base, _ = server
    body = _png_bytes((np.random.default_rng(1).random((24, 24, 3)) * 255).astype(np.uint8))
    req = urllib.request.Request(f"{base}/upscale?tile=16&overlap=4", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert json.loads(resp.headers["X-SR-Meta"])["tile"] == 16
    for url, data in ((f"{base}/upscale?tile=7", body), (f"{base}/upscale?overlap=999", body),
                      (f"{base}/upscale", b"not an image")):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(url, data=data, method="POST"),
                                   timeout=30)
        assert ei.value.code == 400, url
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"{base}/nope", timeout=30)
    assert ei.value.code == 404


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(upsampler="pixelshuffledirect", resi_connection="3conv"),
    dict(upsampler="nearest+conv", scale=4, ape=True, img_size=16),
    dict(upsampler="", scale=1, patch_norm=False, mlp_ratio=4.0, depths=(2, 4)),
], ids=["pixelshuffle", "direct-3conv", "nearest-ape", "denoise"])
def test_infer_swinir_config_round_trips(overrides):
    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model
    from tpu_superresolution_torch.interop import infer_swinir_config

    cfg = SwinIRConfig(**{**SMALL, "num_heads": (2,) * len(overrides.get("depths", (2,))),
                          **overrides})
    sd = {k: v.numpy() for k, v in build_model(cfg).state_dict().items()}
    got = infer_swinir_config(sd, cfg.scale)
    fields = ("in_channels", "out_channels", "scale", "window_size", "embed_dim", "depths",
              "num_heads", "mlp_ratio", "qkv_bias", "upsampler", "resi_connection", "ape",
              "patch_norm")
    for f in fields:
        assert getattr(got, f) == getattr(cfg, f), f
    if cfg.upsampler in ("pixelshuffle", "nearest+conv"):
        assert got.num_feat == cfg.num_feat


def test_official_buffers_dropped_before_strict_load(ckpt):
    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.interop import (
        infer_swinir_config,
        load_torch_checkpoint,
        strip_reference_buffers,
    )

    sd = load_torch_checkpoint(ckpt)
    stripped = strip_reference_buffers(sd)
    dropped = sorted(set(sd) - set(stripped))
    assert dropped and all(k.endswith(("relative_position_index", "attn_mask")) for k in dropped)
    model = build_model(infer_swinir_config(stripped, 2))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in stripped.items()}, strict=True)


def test_exact_flag_selects_reference_semantics(ckpt):
    from tpu_superresolution_torch.cli.upscale import load_any_checkpoint

    cpu = torch.device("cpu")
    exact, _ = load_any_checkpoint(ckpt, "swinir", 2, device=cpu)
    fast, _ = load_any_checkpoint(ckpt, "swinir", 2, exact=False, device=cpu)
    assert (exact.fused_reconstruct, exact.gelu_approximate) == (False, False)
    assert (fast.fused_reconstruct, fast.gelu_approximate) == (True, True)
    assert dataclasses.replace(fast, fused_reconstruct=False, gelu_approximate=False) == exact


def test_other_models_and_formats_are_refused(ckpt, tmp_path):
    from tpu_superresolution_torch.cli.upscale import load_for_inference

    with pytest.raises(ValueError, match="not an MS_ResUNet checkpoint"):  # ported too
        load_for_inference(ckpt, "ms_resunet", "X2", None, torch.device("cpu"))
    with pytest.raises(ValueError, match="not a HAT checkpoint"):  # HAT is ported
        load_for_inference(ckpt, "hat", "X2", None, torch.device("cpu"))
    with pytest.raises(ValueError, match="not a DAT checkpoint"):  # DAT is ported
        load_for_inference(ckpt, "dat", "X2", None, torch.device("cpu"))
    with pytest.raises(SystemExit, match="tpu_superresolution_tpu.cli.export_torch"):
        load_for_inference(str(tmp_path / "orbax_dir"), "swinir", "X2", None,
                           torch.device("cpu"))


def test_upscale_cli_writes_png(ckpt, tmp_path):
    from tpu_superresolution_torch.cli.upscale import main

    src = tmp_path / "in.png"
    Image.fromarray((np.random.default_rng(2).random((18, 22, 3)) * 255).astype(np.uint8)).save(src)
    out = tmp_path / "out.png"
    assert main(["--image", str(src), "--ckpt", ckpt, "--model", "swinir", "--scale", "X2",
                 "--out", str(out), "--no-exact", "--tile", "16", "--tile_overlap", "4",
                 "--device", "cpu"]) == [str(out)]
    with Image.open(out) as im:
        assert im.size == (44, 36)
