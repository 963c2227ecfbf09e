"""The benchmark's cells cut to sizes a CPU test holds: Glow L2/K2 width 16
on 8x8 images, UNets of dim 8, DDIM-5 over T = 20, batches of 4."""

from __future__ import annotations

import copy
import time
from pathlib import Path

import torch

from perfbench.bench import manifest

SEED = 2 ** 33 + 7  # more than 32 bits, as the checks' seeds are
CELLS = ("nfdp-cifar10.sample", "glow-cifar10.train", "glow-cifar10.sample")


def shrink(spec: manifest.Cell) -> manifest.Cell:
    spec = copy.deepcopy(spec)
    c = spec.config
    c["flow"].update(L=2, K=2, coupling_width=16)
    c["image"]["size"] = 8
    c["assumed"]["data_dependent_init_images"] = 16
    if "unet" in c:
        c["unet"]["dim"] = 8
        c["diffusion"].update(timesteps=20, sampling_timesteps=5)
    spec.traffic["batch"] = 4
    if "dataset_images" in spec.traffic:
        spec.traffic["dataset_images"] = 64
    if "training" in c:
        c["training"]["lr_warmup_steps"] = 20
    return spec


def tiny(name: str, root: Path = manifest.ROOT) -> manifest.Cell:
    return shrink(manifest.load(name, root))


def run_tiny(name: str, seconds: float = 0.2, seed: int = SEED) -> dict:
    from perfbench import run

    return run.run(tiny(name), seed, seconds, False, torch.device("cpu"), start=time.time())
