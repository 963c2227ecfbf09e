#!/usr/bin/env python3
"""Rehearse chip_smoke.py's phase 28 ("multi_gpu") on the CPU at a tiny size.

    python3 tools/rehearse_multi_gpu.py [--dir DIR]

Runs the phase's own code (its children too: a world of one, then two gloo
ranks) with the Glow cut to L2/K1, width 16, 8x8x3, batch 8, the UNets to
dim 8 and T = 8, on the CPU: gloo in place of NCCL, `device=cpu` and
`--device cpu` on the entry points and tools, FSDP_MIN_SIZE 64 so that
leaves are partitioned at all. The kernel launch counts are not checked
(on the CPU the wrappers run their plain versions and launch nothing), and
no time is a device's. It finds wrong paths, shapes and control flow before
a card call; it prints the phase's records and "REHEARSAL OK". Imports no
JAX.
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
    no_launches = {k: 0 for k in cs.MG_STEP_LAUNCHES}
    cs.LEVELS, cs.STEPS, cs.WIDTH, cs.IMG, cs.BATCH = 2, 1, 16, 8, 8
    cs.UNET_KWARGS = dict(cs.UNET_KWARGS, dim=8, resnet_block_groups=2)
    cs.DIFFUSION_KWARGS = dict(cs.DIFFUSION_KWARGS, timesteps=8, sampling_timesteps=4)
    cs.MG_DEVICE, cs.MG_BACKEND = "cpu", "gloo"
    cs.MG_ENTRY_ARGS, cs.MG_TOOL_ARGS = ["device=cpu"], ["--device", "cpu"]
    cs.MG_STATS_LIMIT = 8
    cs.MG_STEP_LAUNCHES = no_launches
    cs.stage2_per_step = lambda frozen: no_launches
    cs.stage1_run_launches = lambda steps, evals: no_launches
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
        (cs.mg_world1 if role == "world1" else cs.mg_world2)(torch, root, stage1)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=str(ROOT / "build" / "rehearse_multi_gpu"),
                    help="where the stage-1 run and the phase's files go")
    args = ap.parse_args()
    from nfdpm_tpu_torch.training import nf_trainer as nft

    cs.ROOT = Path(args.dir)
    stage1 = cs.ROOT / "stage1"
    if not (stage1 / "checkpoints" / "model_gaussian_001.pt").exists():
        cfg, tcfg = cs.train_configs()
        nft.train(cfg=cfg, tcfg=tcfg, loaders=cs.train_loaders(4), run_dir=str(stage1),
                  logger=logging.getLogger("rehearsal"), seed=cs.TRAIN_SEED,
                  img_size=cs.IMG, device="cpu")
    launches = cs.phase_multi_gpu(torch, np, cs.kernel_counters(), "CPU rehearsal", stage1)
    print("REHEARSAL OK", launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
