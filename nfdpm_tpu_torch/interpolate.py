"""Latent interpolation strips from a finished run directory of the port.

    python -m nfdpm_tpu_torch.interpolate --run-dir <run> --idx 0 1 --steps 8

Counterpart of tools/interpolate.py, with the same flags (and --device,
and --t, which shortens a stage-2 run's chain) and the same outputs, for
both kinds:

  * Glow runs: the two endpoints through the flow's forward, a linear
    mix of every latent part at each lambda, the flow's inverse (lambda 0
    and 1 give the endpoints back, to the round trip's error, since the
    flow is a bijection);
  * stage-2 runs: the flow's transform, the formater, the diffusion prior's
    per-part interpolation (both endpoints noised to t, T-1 unless --t
    names a smaller step, mixed, denoised over t steps), the formater's
    inverse and the flow's inverse, the whole strip as one batch through
    one chain.

The endpoints are two images of the test split of the run's own dataset
(its config.yaml, which needs PyYAML). Writes `interp_<a>_<b>.png` (the
strip [a | lambda 0..1 | b] on one row) and `interp_<a>_<b>.npz` ("strip"
uint8 NHWC, "lams"), and one JSON line on stdout. Runs on CUDA unless
--device names another device.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch


def load_endpoint_images(run_dir: str, img_size: int, idx) -> np.ndarray:
    """uint8 [2, H, W, C]: test images `idx` of the run's dataset."""
    from .data.pipeline import read_dataset
    from .training.runload import run_config

    cfg = run_config(run_dir)
    loaders = read_dataset(
        cfg.data.name, cfg.data.root, digits=cfg.data.get("digits"), batch_size=2,
        img_size=img_size, transformations=list(cfg.data.get("transformations") or []),
        seed=int(cfg.get("seed", 0)),
        synthetic_fallback=bool(cfg.data.get("synthetic_fallback", False)),
        synthetic_n=int(cfg.data.get("synthetic_n", 512)))
    images = loaders.test.dataset.images  # after the static transform, uint8 NHWC
    a, b = idx
    if max(a, b) >= len(images):
        raise SystemExit(f"--idx {a} {b} out of range (the test set has {len(images)} images)")
    return images[[a, b]]


@torch.inference_mode()
def interpolation_strip(kind: str, run, raw: np.ndarray, lams: np.ndarray,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                        t: Optional[int] = None) -> np.ndarray:
    """uint8 [len(lams), H, W, C]: the interpolation between the two uint8
    images `raw` at each lambda of `lams`, for a run of `kind` (runload's
    GlowRun or DiffusionRun). A stage-2 run noises both endpoints to `t`
    (default T-1) and draws from `generator`, or takes `noise[i]`, part i's
    injected draws in DiffusionPrior.interpolate_latents' order. Runs on the
    device of the run's parameters."""
    from .convert import named_leaves
    from .inference import _on
    from .models import glow as glow_m
    from .ops import quantize as q

    flow = run.params["flow"]
    device = next(leaf for _, leaf in named_leaves(flow)).device
    n_bits = run.tcfg.n_bits
    x = q.preprocess(_on(device, raw) / 255.0, n_bits)
    lam = _on(device, lams).reshape(-1, 1, 1, 1)
    steps = len(lams)
    if kind == "diffusion":
        latents, _ = run.backbone.transform(flow, x)
        parts = run.dp.formater.process_latents(latents)
        first = [p[:1].expand(steps, *p.shape[1:]) for p in parts]
        second = [p[1:2].expand(steps, *p.shape[1:]) for p in parts]
        mixed = run.dp.interpolate_latents(run.params["diffusion"], first, second, lam=lam,
                                           generator=generator, noise=noise, t=t)
        images = run.backbone.invert(flow, run.dp.formater.postprocess(mixed))
    else:
        latents, _, _ = glow_m.forward(flow, run.gcfg, x, with_logp=False)
        mixed = [(1.0 - lam) * z[:1] + lam * z[1:2] for z in latents]
        images = glow_m.inverse(flow, run.gcfg, mixed)
    return q.postprocess(images, n_bits).cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run-dir", required=True, help="run dir (or its name under outputs/)")
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--idx", type=int, nargs=2, default=(0, 1), metavar=("A", "B"),
                    help="test-split endpoint indices")
    ap.add_argument("--steps", type=int, default=8, help="number of lambda values in [0, 1]")
    ap.add_argument("--no-ema", action="store_true",
                    help="diffusion runs: use the live weights instead of the EMA shadow")
    ap.add_argument("--t", type=int, default=None,
                    help="diffusion runs: the step both endpoints are noised to before the "
                         "mix, and so the chain's length (default: T-1, the whole chain)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="output dir (default: <run-dir>/interpolations)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, and fail without it)")
    args = ap.parse_args(argv)

    from . import resolve_device
    from .inference import reseed
    from .training import runload
    from .training.tracking import save_image_grid

    device = resolve_device(args.device)
    try:
        run_dir = runload.resolve_run_dir(args.run_dir)
        kind, run = runload.load_run(run_dir, args.epoch, use_ema=not args.no_ema,
                                     device=device)
    except FileNotFoundError as e:
        raise SystemExit(str(e))
    steps = max(args.steps, 2)
    lams = np.linspace(0.0, 1.0, steps, dtype=np.float32)
    raw = load_endpoint_images(run_dir, run.img_size, args.idx)
    interp = interpolation_strip(kind, run, raw, lams,
                                 reseed(torch.Generator(device=device), args.seed), t=args.t)

    # the strip: [a | lambda 0..1 | b] on one row
    strip = np.concatenate([raw[:1], interp, raw[1:2]], axis=0)
    out_dir = args.out or os.path.join(run_dir, "interpolations")
    os.makedirs(out_dir, exist_ok=True)
    a, b = args.idx
    png = os.path.join(out_dir, f"interp_{a}_{b}.png")
    save_image_grid(strip, png, nrow=len(strip))
    npz = os.path.join(out_dir, f"interp_{a}_{b}.npz")
    np.savez_compressed(npz, strip=strip, lams=lams)
    record = {"run_dir": run_dir, "kind": kind, "epoch": run.epoch, "idx": [a, b],
              "steps": steps, "png": png, "npz": npz, "shape": list(strip.shape)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
