#!/usr/bin/env python3
"""How far the stage-2 training trajectory moves when a batch is split into
row blocks, as data parallelism splits it, on one CUDA card (or the CPU).

    python3 tools/stage2_block_gap.py [--seeds 0 1 2 ...] [--width 512]
                                      [--device cuda] [--out FILE]

For each seed: a Glow at L3/K4 and the given coupling width, its zero-init
leaves given small seeded values (a stand-in for a trained flow), frozen;
configs/nf_diffusion.yaml's three UNets at chip_smoke.py's sizes; four
batches of 64 synthetic 32x32 images made from the seed; Adam at lr 1e-3;
deterministic mode, TF32 off. For the kernel route and the plain route in
turn it runs four steps three ways:

  - "full": diffusion_trainer.make_train_step on the whole batch;
  - "repeat": the same again, which must give the same bits;
  - "blocks": chip_smoke.mg_block_step over two row blocks of 32, the
    arithmetic of two data-parallel ranks in one process.

It prints one JSON line a (seed, route): each step's loss, the relative
gaps of "blocks" and of "repeat" from "full" by step, and the step-1
gradient leaves that differ most between "full" and "blocks" (largest
absolute difference, the leaf's largest entry). With --out the lines are
also written there as one JSON list. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import nfdpm_tpu_torch as port  # noqa: E402
from nfdpm_tpu_torch.convert import named_leaves  # noqa: E402
from nfdpm_tpu_torch.data.pipeline import read_dataset  # noqa: E402
from nfdpm_tpu_torch.models import glow as glow_m  # noqa: E402
from nfdpm_tpu_torch.models.nf_backbone import NFBackbone  # noqa: E402
from nfdpm_tpu_torch.training import diffusion_trainer as dt  # noqa: E402

STEPS, BLOCKS, LR = 4, 2, 1e-3


def seeded_flow(seed: int, width: int, device: torch.device):
    """A Glow whose zero-init leaves (chip_smoke.ZERO_INIT) hold 0.05 N(0, 1)."""
    cfg = glow_m.GlowConfig(levels=cs.LEVELS, steps=cs.STEPS, coupling_width=width)
    flow = glow_m.init_glow(seed, cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def walk(node, inside):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            if isinstance(v, torch.Tensor):
                if inside:
                    v.copy_(0.05 * torch.randn(v.shape, generator=gen, device=device))
            else:
                walk(v, inside or k in cs.ZERO_INIT)

    walk(flow, False)
    return cfg, flow


def trajectory(backbone, flow, dp, batches, blocks: int, device):
    """Each step's loss and the step-1 gradients of the UNets (by leaf)."""
    tcfg = dt.DiffusionTrainConfig(lr_diffusion=LR)
    tx = dt.make_two_group_optimizer(tcfg, True)
    state = dt.init_train_state(cs.TRAIN_SEED, backbone, flow, dp, tx, device=device)
    step = (dt.make_train_step(backbone, dp, tcfg, tx, device=device) if blocks == 1
            else cs.mg_block_step(torch, backbone, dp, tcfg, tx, blocks))
    losses, grads = [], None
    for batch in batches:
        state, metrics = step(state, batch, cs.TRAIN_SEED)
        losses.append(float(metrics["loss"]))
        if grads is None:
            grads = {k: p.grad.detach().cpu().clone()
                     for k, p in named_leaves(state["params"]["diffusion"])}
    return losses, grads


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", nargs="+", type=int, default=list(range(8)))
    ap.add_argument("--width", type=int, default=cs.WIDTH)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = torch.device(args.device)
    cs.MG_DEVICE = args.device
    port.disable_tf32()
    cs.set_deterministic(torch, True)
    rows = []
    if device.type == "cuda":
        print(json.dumps({"card": cs.nvidia_smi()}), flush=True)
    for seed in args.seeds:
        cfg, flow = seeded_flow(seed, args.width, device)
        backbone = NFBackbone(cfg=cfg, img_size=cs.IMG, frozen=True)
        loaders = read_dataset("synthetic", "", batch_size=cs.BATCH, img_size=cs.IMG,
                               seed=seed, synthetic_n=cs.BATCH * STEPS)
        batches = [torch.from_numpy(x).to(device) for x, _ in loaders.train.iter_epoch(0)]
        for kernels in (True, False):
            dp = cs.stage2_prior(use_kernels=kernels)
            full, g_full = trajectory(backbone, flow, dp, batches, 1, device)
            repeat, _ = trajectory(backbone, flow, dp, batches, 1, device)
            split, g_split = trajectory(backbone, flow, dp, batches, BLOCKS, device)
            leaves = sorted(((float((g_full[k] - g_split[k]).abs().max()), k,
                              float(g_full[k].abs().max())) for k in g_full), reverse=True)
            row = {"seed": seed, "route": "kernels" if kernels else "plain",
                   "width": args.width, "loss_full": full, "loss_blocks": split,
                   "blocks_rel_gap_by_step": [abs(b - f) / abs(f) for f, b in zip(full, split)],
                   "repeat_rel_gap_by_step": [abs(r - f) / abs(f) for f, r in zip(full, repeat)],
                   "step1_grad_gaps": [{"leaf": k, "max_abs_gap": d, "leaf_max": m}
                                       for d, k, m in leaves[:4]]}
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
