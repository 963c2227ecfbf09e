#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path, on one CUDA card.

    python3 tools/profile_torch_serving.py [--iters 10]

Builds the model chip_smoke.py builds (Glow L3/K4, width 512, 32x32x3,
batch 64, seeded random weights) and, for scoring (one forward through
inference.make_eval_step) and sampling (one inverse through
inference.make_sample_fn), on the kernel route and the plain route:

  - wall ms per batch (host clock around synchronised iterations);
  - device ms per batch and the device's busy share (sum of kernel times
    from torch.profiler over the same iterations, divided by the wall time);
  - device time by kernel name, largest first.

One JSON line per (path, route); all lines also go to
chiprun_out/profile_torch_serving.json. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _kernel_times(prof):
    """{kernel name: device µs} over the events that ran on the card (the
    operators that launched them carry the same time and are skipped)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.device_time > 0:
            out[e.name] = out.get(e.name, 0.0) + e.device_time
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_serving: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from nfdpm_tpu_torch import inference
    from nfdpm_tpu_torch.models import glow as glow_m
    from nfdpm_tpu_torch.models import prior as prior_m

    device = torch.device("cuda")
    cfgs = {route: glow_m.GlowConfig(levels=cs.LEVELS, steps=cs.STEPS,
                                     coupling_width=cs.WIDTH, use_kernels=route == "kernels")
            for route in ("kernels", "plain")}
    cfg = cfgs["kernels"]
    params = {"flow": glow_m.init_glow(0, cfg, device),
              "prior": prior_m.init_gaussian_prior(glow_m.final_channels(cfg), True, device)}
    cs.randomize_zero_leaves(torch, params, seed=1)
    imgs = np.random.default_rng(2).integers(0, 256, (cs.BATCH, cs.IMG, cs.IMG, 3))
    batch = torch.from_numpy(imgs.astype(np.float32) / 255.0).to(device)
    noise = torch.rand(batch.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                       device=device)

    smi = cs.nvidia_smi()
    records = []
    for route, rcfg in cfgs.items():
        score = inference.make_eval_step(rcfg, cs.N_BITS, device=device)
        sample = inference.make_sample_fn(rcfg, cs.IMG, cs.N_BITS, device=device)
        gen = torch.Generator(device="cuda").manual_seed(5)
        work = {"score": lambda: score(params, batch, noise=noise),
                "sample": lambda: sample(params, cs.BATCH, 1.0, generator=gen)}
        for path, fn in work.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / args.iters * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    fn()
                torch.cuda.synchronize()
            kernels = _kernel_times(prof)
            device_ms = sum(kernels.values()) / 1e3 / args.iters
            top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
            top = [(k[:100], us) for k, us in top]
            rec = {"path": path, "route": route, "batch": cs.BATCH, "card": smi,
                   "wall_ms_per_batch": wall_ms,
                   "device_ms_per_batch": device_ms if kernels else "not measured",
                   "device_busy_share": device_ms / wall_ms if kernels else "not measured",
                   "by_kernel_ms_per_batch": [[k, us / 1e3 / args.iters] for k, us in top]}
            records.append(rec)
            print(json.dumps(rec), flush=True)
    out = ROOT / "chiprun_out" / "profile_torch_serving.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
