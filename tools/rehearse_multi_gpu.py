#!/usr/bin/env python3
"""Rehearse chip_smoke.py's phases 28 ("multi_gpu"), 29 ("model_axis"), 30
("pipeline") and 31 ("spatial") on the CPU at a tiny size.

    python3 tools/rehearse_multi_gpu.py [--dir DIR] [--phases 28 29 30 31]

Runs the phases' own code (their children too: for 28 a world of one,
then two gloo ranks; for 29 a world of one, two ranks at (data 1, model 2)
and four at (data 2, model 2); for 30 a world of one and two pipeline
stages; for 31 a world of one and two spatial ranks) with the Glow cut to
L2/K2, width 16, 16x16x3 (the spatial guard's least size at L2 and model
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
        role, root, stage1 = sys.argv[2], Path(sys.argv[3]), Path(sys.argv[4])
        cs.CHILD_ROLES[role](torch, root, stage1)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=str(ROOT / "build" / "rehearse_multi_gpu"),
                    help="where the stage-1 run and the phases' files go")
    ap.add_argument("--phases", nargs="+", type=int, choices=(28, 29, 30, 31),
                    default=[28, 29, 30, 31])
    args = ap.parse_args()
    from nfdpm_tpu_torch.training import nf_trainer as nft

    cs.ROOT = Path(args.dir)
    stage1 = cs.ROOT / "stage1"
    if not (stage1 / "checkpoints" / "model_gaussian_001.pt").exists():
        cfg, tcfg = cs.train_configs()
        nft.train(cfg=cfg, tcfg=tcfg, loaders=cs.train_loaders(4), run_dir=str(stage1),
                  logger=logging.getLogger("rehearsal"), seed=cs.TRAIN_SEED,
                  img_size=cs.IMG, device="cpu")
    world1 = None  # phase 29's world-1 run, which 30 and 31 reuse as in chip_smoke.main

    def model_axis(*a):
        nonlocal world1
        launches, world1 = cs.phase_model_axis(*a, stage1)
        return launches

    phases = {28: lambda *a: cs.phase_multi_gpu(*a, stage1), 29: model_axis,
              30: lambda *a: cs.phase_pipeline(*a, world1),
              31: lambda *a: cs.phase_spatial(*a, stage1, world1)}
    for phase in args.phases:
        launches = phases[phase](torch, np, cs.kernel_counters(), "CPU rehearsal")
        print(f"phase {phase} launches", launches)
    print("REHEARSAL OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
