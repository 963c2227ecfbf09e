"""Generation server for a Glow model: keep the sampler warm, serve samples
over HTTP.

Counterpart of tools/serve.py for the Glow kind, with the same contract:

    python -m nfdpm_tpu_torch.serve --weights glow.npz --levels 3 --steps 4 \\
        --width 512 --img-size 32 --batch 64 --port 8400
    curl localhost:8400/health
    curl -X POST localhost:8400/generate -d '{"n": 16, "seed": 7}' -o out.npz

POST /generate body (JSON): n (required), temperature (default: the
server's), seed (default 0), format: "npz" (uint8 NHWC under key
'samples', default) or "png" (8-wide grid). Requests are served in
fixed-batch chunks (--batch) under one lock, each chunk with a fresh
generator, and answered with the X-Generation-Seconds and
X-Samples-Per-Sec headers.

Weights are a .npz written by nfdpm_tpu_torch.convert.save_npz (the JAX
package's parameter tree). The server runs on CUDA unless --device names
another device.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from . import resolve_device
from .convert import from_jax_params, load_npz
from .inference import generate_batched, make_sample_fn
from .models import glow as glow_m


def image_grid(images: np.ndarray, nrow: int = 8, pad: int = 1) -> np.ndarray:
    """uint8 [N, H, W, C] -> one HWC uint8 grid image."""
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c), np.uint8)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0, x0 = pad + r * (h + pad), pad + col * (w + pad)
        grid[y0: y0 + h, x0: x0 + w] = images[i]
    return grid


def _png_bytes(images: np.ndarray) -> bytes:
    from PIL import Image

    grid = image_grid(images)
    buf = io.BytesIO()
    Image.fromarray(grid.squeeze(-1) if grid.shape[-1] == 1 else grid).save(buf, "PNG")
    return buf.getvalue()


def build_sampler(args):
    """(sample_images(n, temperature, seed) -> uint8 NHWC numpy, info dict)."""
    device = resolve_device(args.device)
    params = from_jax_params(load_npz(args.weights), device)
    flow = params["flow"]
    cfg = glow_m.GlowConfig(
        in_channels=args.in_channels, levels=args.levels, steps=args.steps,
        coupling_width=args.width, learn_prior=bool(params["prior"]),
        invconv_param=args.invconv_param)
    if len(flow["blocks"]) != cfg.levels - 1 or len(flow["final_steps"]) != cfg.steps:
        raise ValueError(f"{args.weights} does not hold a Glow with "
                         f"L={cfg.levels}, K={cfg.steps}")
    sample_fn = make_sample_fn(cfg, args.img_size, args.n_bits, device)

    batch = args.batch
    lock = threading.Lock()

    def sample_images(n, temperature, seed):
        with lock:  # one sampler, one stream of work on the card
            return generate_batched(sample_fn, params, n, batch, temperature, seed)

    info = {"weights": str(args.weights), "kind": "gaussian", "batch": batch,
            "temperature": float(args.temperature), "device": str(device),
            "levels": cfg.levels, "steps": cfg.steps, "width": cfg.coupling_width,
            "img_size": args.img_size, "n_bits": args.n_bits}
    t0 = time.perf_counter()
    sample_images(min(2, batch), args.temperature, 0)  # build kernels + warm
    info["warmup_seconds"] = round(time.perf_counter() - t0, 2)
    return sample_images, info


def make_handler(sample_images, info):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json", headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, json.dumps({"status": "ok", **info}).encode())
            else:
                self._send(404, b'{"error": "unknown path"}')

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, b'{"error": "unknown path"}')
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                n = int(req["n"])
                if n < 1 or n > 1_000_000:
                    raise ValueError("n out of range")
                temperature = float(req.get("temperature", info["temperature"]))
                seed = int(req.get("seed", 0))
                if seed < 0:
                    raise ValueError("seed must be >= 0")
                fmt = req.get("format", "npz")
                if fmt not in ("npz", "png"):
                    raise ValueError("format must be 'npz' or 'png'")
                if fmt == "png":
                    n = min(n, 64)  # the grid shows 64; don't generate more
            except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
                self._send(400, json.dumps({"error": str(e)}).encode())
                return

            t0 = time.perf_counter()
            samples = sample_images(n, temperature, seed)
            dt = time.perf_counter() - t0
            if fmt == "png":
                body, ctype = _png_bytes(samples[:64]), "image/png"
            else:
                buf = io.BytesIO()
                np.savez_compressed(buf, samples=samples)
                body, ctype = buf.getvalue(), "application/octet-stream"
            self._send(200, body, ctype, [
                ("X-Generation-Seconds", f"{dt:.3f}"),
                ("X-Samples-Per-Sec", f"{len(samples) / dt:.1f}")])

        def log_message(self, fmt, *a):  # route to stdout, one line
            print(f"[serve] {self.address_string()} {fmt % a}", flush=True)

    return Handler


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weights", required=True,
                    help=".npz written by nfdpm_tpu_torch.convert.save_npz")
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--width", type=int, default=512, help="coupling width")
    ap.add_argument("--img-size", type=int, default=32)
    ap.add_argument("--in-channels", type=int, default=3)
    ap.add_argument("--n-bits", type=int, default=5)
    ap.add_argument("--invconv-param", default="plu", choices=["plu", "full"])
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=64, help="sampler batch size")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, and fail without it)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8400)
    return ap.parse_args(argv)


def make_server(argv=None) -> ThreadingHTTPServer:
    """Load the weights, warm the sampler and bind the server (not started);
    `server.info` holds what /health reports."""
    args = parse_args(argv)
    sample_images, info = build_sampler(args)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(sample_images, info))
    server.info = info
    return server


def main(argv=None):
    server = make_server(argv)
    host, port = server.server_address[:2]
    print(json.dumps({"serving": f"http://{host}:{port}", **server.info}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
