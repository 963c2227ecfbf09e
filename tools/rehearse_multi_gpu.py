#!/usr/bin/env python3
"""Rehearse chip_smoke.py's phases 28 ("multi_gpu"), 29 ("model_axis"), 30
("pipeline"), 31 ("spatial") and 32 ("last_modules") on the CPU at a tiny
size.

    python3 tools/rehearse_multi_gpu.py [--dir DIR] [--phases 28 29 30 31 32]

Runs the phases' own code (their children too, in chip_smoke.py's launch
groups: one two-rank child that runs 28's data axis, 29's (data 1, model
2), 30's two pipeline stages and 31's two spatial ranks in turn, one
world-1 child with every reference and 32's deterministic epochs, and for
29 four ranks at (data 2, model 2)) with the Glow cut to L2/K2, width 16,
16x16x3 (the spatial guard's least size at L2 and model
2), batch 8, the UNets to dim 8 (2 groups; phase 31's 1) and T = 8, on the
CPU: gloo in place of NCCL, `device=cpu` and `--device cpu` on the entry
points and tools, FSDP_MIN_SIZE 64 so that leaves are partitioned at all.
The kernel
launch counts are not checked (on the CPU the wrappers run their plain
versions and launch nothing), and no time is a device's. It finds wrong
paths, shapes and control flow before a card call; it prints the phases'
records and "REHEARSAL OK". Imports no JAX.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nfdpm_tpu_torch.parallel import sharding_rules  # noqa: E402


def cut_to_size() -> None:
    """The phase's sizes, devices and launch expectations for the CPU."""
    torch.set_num_threads(1)
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    no_launches = {k: 0 for k in cs.MG_STEP_LAUNCHES}
    cs.LEVELS, cs.STEPS, cs.WIDTH, cs.IMG, cs.BATCH = 2, 2, 16, 16, 8
    cs.UNET_KWARGS = dict(cs.UNET_KWARGS, dim=8, resnet_block_groups=2)
    cs.DIFFUSION_KWARGS = dict(cs.DIFFUSION_KWARGS, timesteps=8, sampling_timesteps=4)
    cs.MG_DEVICE, cs.MG_BACKEND = "cpu", "gloo"
    cs.MG_ENTRY_ARGS, cs.MG_TOOL_ARGS = ["device=cpu"], ["--device", "cpu"]
    cs.MG_STATS_LIMIT = 8
    cs.MG_STEP_LAUNCHES = no_launches
    cs.stage2_per_step = lambda frozen: no_launches
    cs.stage1_run_launches = lambda steps, evals: no_launches
    cs.pp_step_launches = lambda stage, n_stages=2: no_launches
    cs.vlb_pass_launches = lambda timesteps: no_launches
    torch.cuda.memory_allocated = lambda *a, **k: 0
    cs.sampling_chunk = lambda sampling_timesteps=0: no_launches
    stage2_overrides = cs.stage2_overrides
    cs.stage2_overrides = lambda name, steps=cs.STAGE2_STEPS: stage2_overrides(name, steps) + [
        "model.unet.dim=8", "model.unet.resnet_block_groups=2", "model.diffusion.timesteps=8",
        "model.diffusion.sampling_timesteps=4"]
    cs.MG_CHILD = [sys.executable, str(Path(__file__).resolve()), "--child"]
    sharding_rules.FSDP_MIN_SIZE = 64
    os.environ["NFDPM_DIST_BACKEND"] = "gloo"  # the world of one's group on the CPU
    os.environ["NFDPM_NO_TENSORBOARD"] = "1"


def main() -> int:
    cut_to_size()
    if sys.argv[1:2] == ["--child"]:  # a child of the phase, started by it
        cs.run_child(torch, sys.argv[2], Path(sys.argv[3]), Path(sys.argv[4]))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=str(ROOT / "build" / "rehearse_multi_gpu"),
                    help="where the stage-1 run and the phases' files go")
    ap.add_argument("--phases", nargs="+", type=int, choices=(28, 29, 30, 31, 32),
                    default=[28, 29, 30, 31, 32])
    args = ap.parse_args()
    from nfdpm_tpu_torch.training import nf_trainer as nft

    cs.ROOT = Path(args.dir)
    cs.MULTI_ROOT = cs.ROOT / "build" / "chip_smoke" / "multi"
    stage1 = cs.ROOT / "stage1"
    if not (stage1 / "checkpoints" / "model_gaussian_001.pt").exists():
        cfg, tcfg = cs.train_configs()
        nft.train(cfg=cfg, tcfg=tcfg, loaders=cs.train_loaders(4), run_dir=str(stage1),
                  logger=logging.getLogger("rehearsal"), seed=cs.TRAIN_SEED,
                  img_size=cs.IMG, device="cpu")
    # the phases' children, as chip_smoke.main launches them
    children = cs.launch_children(stage1, parts={str(p) for p in args.phases})
    counters, card = cs.kernel_counters(), "CPU rehearsal"
    phases = {28: lambda: cs.phase_multi_gpu(torch, np, counters, card, stage1, children),
              29: lambda: cs.phase_model_axis(torch, np, counters, card, children),
              30: lambda: cs.phase_pipeline(torch, np, counters, card, children),
              31: lambda: cs.phase_spatial(torch, np, counters, card, children),
              32: lambda: cs.phase_last_modules(torch, np, counters, card, stage1, children)}
    for phase in sorted(args.phases):
        print(f"phase {phase} launches", phases[phase]())
    print("REHEARSAL OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
