"""Persistent single-GPU inference server (port of
``tpu_superresolution_tpu/cli/serve.py``) — load a checkpoint once,
serve super-resolution over HTTP (stdlib only):

    python -m tpu_superresolution_torch.cli.serve \\
        --ckpt model.pth --model swinir --scale X4 --no-exact --port 8008
    (``--model hat`` / ``dat`` / ``ms_resunet`` for a reference checkpoint of
    that family; a checkpoint of the port's train CLI carries its config)

    curl -X POST --data-binary @photo.png \\
        http://localhost:8008/upscale > photo_sr.png

Endpoints:
- ``POST /upscale`` — body is an encoded image (PNG/JPEG/...), response
  the super-resolved PNG.  Optional ``?tile=N&overlap=M`` override the
  auto-tiling choice per request.
- ``GET /healthz`` — JSON: model name, scale, channels, requests served.

One process owns the GPU, so requests are serialized through a lock.
It runs on the GPU and raises when there is none; ``--device cpu``
serves from the CPU.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time

import numpy as np
import torch

from tpu_superresolution_torch.cli.common import add_device_flag, report_device, resolve_device
from tpu_superresolution_torch.cli.upscale import (
    AUTO_OVERLAP,
    MODEL_CHOICES,
    ForwardCache,
    auto_tile,
    load_for_inference,
)

# Bounds on client-supplied ?tile=N&overlap=M.
MAX_TILE = 512
MIN_TILE = 16
MAX_OVERLAP = 64


def _validate_tiling(tile, overlap):
    """Reject client tiling configs outside sane bounds (tile -1 = auto
    and 0 = whole image stay allowed)."""
    if tile is not None and tile > 0 and not MIN_TILE <= tile <= MAX_TILE:
        raise ValueError(f"tile must be 0 (whole image) or in [{MIN_TILE}, {MAX_TILE}]")
    if overlap is not None and not 0 <= overlap <= MAX_OVERLAP:
        raise ValueError(f"overlap must be in [0, {MAX_OVERLAP}]")


class SRService:
    """Loaded model + per-tiling forwards; thread-safe serve()."""

    def __init__(self, ckpt, model_name, scale_arg, exact, tile, overlap, tile_batch,
                 device=None):
        self.device = resolve_device(device)
        (self.mcfg, self.model, self.scale, self.convention,
         self.channels) = load_for_inference(ckpt, model_name, scale_arg, exact, self.device)
        self.tile, self.overlap = tile, overlap
        self._fwd_cache = ForwardCache(self.model, self.scale, self.convention, tile_batch)
        self._lock = threading.Lock()
        self.n_served = 0

    def serve(self, image_bytes, tile=None, overlap=None):
        """Encoded image bytes -> (PNG bytes, meta dict)."""
        from tpu_superresolution_torch.data.decode import decode_image
        from tpu_superresolution_torch.evaluate.runner import tensor_to_pil

        _validate_tiling(tile, overlap)
        img = decode_image(io.BytesIO(image_bytes), grayscale=self.channels == 1,
                           channels=self.channels)
        h, w = img.shape[:2]
        t = self.tile if tile is None else tile
        ov = self.overlap if overlap is None else overlap
        if t < 0:
            t = auto_tile(h, w)
        with self._lock:
            fwd = self._fwd_cache.get(t, ov)
            t0 = time.time()
            sr = fwd(torch.from_numpy(img)[None].to(self.device))[0]
            sr = sr.cpu().numpy()  # waits for the device
            dt = time.time() - t0
            self.n_served += 1
        buf = io.BytesIO()
        tensor_to_pil(np.asarray(sr)).save(buf, format="PNG")
        meta = {
            "in_shape": [h, w],
            "out_shape": [h * self.scale, w * self.scale],
            "tile": t,
            "seconds": round(dt, 3),
        }
        return buf.getvalue(), meta


def make_server(service: SRService, host: str, port: int):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet default access log
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path != "/healthz":
                return self._json(404, {"error": "unknown path"})
            self._json(200, {
                "model": service.mcfg.name,
                "scale": service.scale,
                "channels": service.channels,
                "served": service.n_served,
            })

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/upscale":
                return self._json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0:
                    return self._json(400, {"error": "empty body"})
                q = parse_qs(url.query)
                tile = int(q["tile"][0]) if "tile" in q else None
                overlap = int(q["overlap"][0]) if "overlap" in q else None
                png, meta = service.serve(self.rfile.read(n), tile=tile, overlap=overlap)
            except Exception as e:  # surface decode/shape errors as 400
                return self._json(400, {"error": f"{type(e).__name__}: {e}"})
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(png)))
            self.send_header("X-SR-Meta", json.dumps(meta))
            self.end_headers()
            self.wfile.write(png)

    return ThreadingHTTPServer((host, port), Handler)


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", type=str, required=True,
                    help="a reference .pt/.pth or a checkpoint of the port's train / finetune "
                         "CLI")
    ap.add_argument("--model", type=str, default="ms_resunet", choices=MODEL_CHOICES,
                    help="family of a reference checkpoint (the port's own carry their config)")
    ap.add_argument("--scale", type=str, choices=["X2", "X4"], required=True)
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--tile", type=int, default=-1,
                    help="-1 = auto per image; 0 = whole image; N = tile")
    ap.add_argument("--tile_overlap", type=int, default=AUTO_OVERLAP)
    ap.add_argument("--tile_batch", type=int, default=8)
    ap.add_argument("--exact", action=argparse.BooleanOptionalAction, default=None,
                    help="reference-exact semantics (default ON for torch checkpoints); "
                         "--no-exact serves with fused reconstruction and tanh GELU")
    add_device_flag(ap)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    report_device(device)
    service = SRService(args.ckpt, args.model, args.scale, args.exact,
                        args.tile, args.tile_overlap, args.tile_batch, device)
    srv = make_server(service, args.host, args.port)
    print(f"[serve] model={service.mcfg.name} scale=X{service.scale} "
          f"on http://{args.host}:{srv.server_address[1]}  "
          f"(POST /upscale, GET /healthz)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return srv


if __name__ == "__main__":
    main()
