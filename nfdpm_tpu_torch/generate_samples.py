"""Generate samples from a finished run directory of the port, either kind.

    python -m nfdpm_tpu_torch.generate_samples --run-dir <run> --n 1024
    python -m nfdpm_tpu_torch.generate_samples --run-dir <diffusion run> \\
        --n 50000 --batch 256 --ddim 100 --out /tmp/fid_samples

Counterpart of tools/generate_samples.py, with the same flags (and
--device) and the same outputs: the model is rebuilt from the run
directory alone (training/runload.py: a Glow from architecture.json and
model_gaussian_*.pt; a Glow with a diffusion prior from
diffusion_architecture.json and model_diffusion_*.pt, its EMA weights
unless --no-ema), sampled in fixed-size chunks by
inference.generate_batched (the server's function, so one seed gives the
server's bytes), and written as `samples.npz` (uint8 NHWC under
"samples") and an 8-wide `grid.png` of the first 64, with one JSON line
on stdout. Runs on CUDA unless --device names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run-dir", required=True, help="run dir (or its name under outputs/)")
    ap.add_argument("--epoch", type=int, default=None,
                    help="checkpoint epoch (default: the newest)")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=None,
                    help="sampling temperature (default: the run's)")
    ap.add_argument("--ddim", type=int, default=None,
                    help="diffusion runs: override sampling_timesteps")
    ap.add_argument("--sampler", default=None, choices=["auto", "ancestral", "ddim", "dpm++"],
                    help="diffusion runs: override the sampler (dpm++ pairs with --ddim 25)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="output dir (default: <run-dir>/generated)")
    ap.add_argument("--no-npz", action="store_true", help="skip samples.npz (grid only)")
    ap.add_argument("--no-ema", action="store_true",
                    help="diffusion runs: sample the live weights instead of the EMA shadow")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, and fail without it)")
    args = ap.parse_args(argv)
    if args.n < 1 or args.batch < 1:
        ap.error("--n and --batch must be >= 1")

    import numpy as np

    from . import resolve_device
    from .inference import generate_batched
    from .training import runload
    from .training.tracking import save_image_grid

    device = resolve_device(args.device)
    try:
        run_dir = runload.resolve_run_dir(args.run_dir)
        kind, run = runload.load_run(run_dir, args.epoch, args.ddim, not args.no_ema,
                                     args.sampler, device)
    except FileNotFoundError as e:
        raise SystemExit(str(e))
    sample_fn = runload.sample_fn_of(kind, run, device)
    temperature = args.temperature if args.temperature is not None else run.temperature

    out_dir = args.out or os.path.join(run_dir, "generated")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    samples = generate_batched(sample_fn, run.params, args.n, args.batch, temperature,
                               args.seed)
    seconds = time.perf_counter() - t0

    paths = {"grid": os.path.join(out_dir, "grid.png")}
    save_image_grid(samples[:64], paths["grid"])
    if not args.no_npz:
        paths["npz"] = os.path.join(out_dir, "samples.npz")
        np.savez_compressed(paths["npz"], samples=samples)
    record = {"run_dir": run_dir, "kind": kind, "epoch": run.epoch,
              "n": int(samples.shape[0]), "shape": list(samples.shape),
              "temperature": temperature, "seconds": round(seconds, 2),
              "samples_per_sec": round(samples.shape[0] / seconds, 1), "devices": 1, **paths}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
