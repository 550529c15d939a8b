"""Inference server of the PyTorch port (counterpart of chexpert_tpu/cli/serve.py).

    python -m chexpert_tpu_torch.cli.serve --restore_path ckpt.pt \
        --model aadensenet121 [--port 8000] [--device cuda]

Endpoints:
  GET  /healthz           -> {"status": "ok", "model": ..., "params": N}
  POST /predict           -> body: JPEG bytes; response: per-pathology
                             sigmoid probabilities as JSON

Requests are padded into a fixed micro-batch, so every forward has the same
shapes; the front end is threaded and device work is serialized by a lock.
``--compute_dtype bfloat16`` runs the forward under ``torch.autocast`` with
float32 parameters. The model runs on ``--device`` (default ``cuda``); asking
for ``cuda`` on a host without a card raises instead of running on the CPU.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from chexpert_tpu_torch.data import ATTR_NAMES
from chexpert_tpu_torch.data.chexpert import PIXEL_MEAN, PIXEL_STD
from chexpert_tpu_torch.data.transforms import center_crop, resize_min_edge
from chexpert_tpu_torch.utils.io import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--restore_path", type=str, required=True)
    p.add_argument("--model", default="densenet121")
    p.add_argument("--image_size", type=int, default=320)
    p.add_argument("--resize", type=int, default=None)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--micro_batch", type=int, default=1)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; 'cpu' on request)")
    return p


class Engine:
    """Model + preprocessing, shared across request threads."""

    def __init__(self, args):
        from chexpert_tpu_torch.checkpoint import load_model_checkpoint
        from chexpert_tpu_torch.models import build_model, normalize_state_dict

        self.device = resolve_device(args.device)
        self.dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
        self.hw = args.resize or args.image_size
        self.resize = args.resize
        self.micro_batch = args.micro_batch
        self.model_name = args.model

        model = build_model(args.model, image_size=self.hw)
        ck = load_model_checkpoint(args.restore_path)
        model.load_state_dict(normalize_state_dict(ck["state_dict"], args.model), strict=True)
        self.model = model.to(self.device).eval()
        self.n_params = sum(p.numel() for p in self.model.parameters())
        self._lock = threading.Lock()
        # warm-up forward at start (first-call allocations, kernel library load)
        self.forward(np.zeros((self.micro_batch, self.hw, self.hw, 3), np.float32))

    def forward(self, batch: np.ndarray) -> np.ndarray:
        """(micro_batch, hw, hw, 3) whitened NHWC -> (micro_batch, 5) sigmoid f32."""
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
        x = x.permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode(), torch.autocast(
                self.device.type, dtype=self.dtype, enabled=self.dtype != torch.float32):
            logits = self.model(x)
        return torch.sigmoid(logits.float()).cpu().numpy()

    def preprocess(self, jpeg_bytes: bytes) -> np.ndarray:
        from PIL import Image

        img = Image.open(io.BytesIO(jpeg_bytes))
        if img.mode != "L":
            img = img.convert("L")
        if self.resize:
            img = resize_min_edge(img, self.resize)
        arr = np.asarray(img, dtype=np.float32)[..., None]
        arr = center_crop(arr, self.hw)
        arr = (arr / 255.0 - PIXEL_MEAN) / PIXEL_STD
        return np.broadcast_to(arr, arr.shape[:-1] + (3,))

    def predict(self, jpeg_bytes: bytes) -> dict:
        x = self.preprocess(jpeg_bytes)
        batch = np.zeros((self.micro_batch, self.hw, self.hw, 3), np.float32)
        batch[0] = x
        with self._lock:  # one model; serialize device access
            probs = self.forward(batch)[0]
        return {name: float(p) for name, p in zip(ATTR_NAMES, probs)}


def make_handler(engine: Engine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "model": engine.model_name,
                                 "params": engine.n_params})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0 or length > 64 * 1024 * 1024:
                self._send(400, {"error": "missing or oversized body"})
                return
            data = self.rfile.read(length)
            try:
                probs = engine.predict(data)
            except Exception as e:  # bad image etc.
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, {"probabilities": probs})

    return Handler


def serve(args) -> ThreadingHTTPServer:
    """Build the engine (with its warm-up forward) and bind the server;
    the caller runs ``serve_forever``."""
    return ThreadingHTTPServer((args.host, args.port), make_handler(Engine(args)))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    httpd = serve(args)
    print(f"serving {args.model} on {args.host}:{httpd.server_address[1]} ({args.device})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
