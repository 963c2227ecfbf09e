"""Glow sampling, the stage-1 model's FID sampling: inference.make_sample_fn's
`sample` at the traffic's batch and temperature, each call with its own
standard-normal draws (the prior's and every split part's) made on the
device from (seed, call), the images copied to the host after each call.

Check: for a sample of the window's calls drawn from the seed, the
reference (perfbench/reference/glow.py, in fp64) draws the same latents
from the same numbers, inverts the flow and gives each pixel's value
before quantization; `pixel_bin_gap` is the widest distance, in
quantization levels, by which a reference value lies outside the bin of
the pixel the program served.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from perfbench.bench import inputs
from perfbench.bench.parts import Parts
from perfbench.cost import glow as glow_cost
from perfbench.reference import DTYPE
from perfbench.reference import glow as ref

TRAFFIC = ("batch", "temperature")  # the traffic keys this entry reads
LIBRARIES = ("flow_kernels",)  # the program's kernel libraries it runs
WARM_CALL = 1 << 40  # the draws of the warm-up call: a stream no timed call uses


def glow_config(config: Dict):
    from nfdpm_tpu_torch.models.glow import GlowConfig

    f = config["flow"]
    return GlowConfig(in_channels=config["image"]["channels"], levels=f["L"], steps=f["K"],
                      coupling_width=f["coupling_width"], learn_prior=f["learn_prior"])


def sample_indices(seed: int, done: int, k: int):
    rng = np.random.default_rng([int(seed) % (1 << 63), inputs.SAMPLE])
    return sorted(rng.choice(done, size=min(k, done), replace=False).tolist())


def worst(gap: float, value: float) -> float:
    """The larger of two gaps, where a NaN wins (Python's max would drop a
    NaN that comes second), so that it reaches the limit's check."""
    return value if math.isnan(value) else max(gap, value)


class Cell:
    def __init__(self, spec, seed: int, device):
        from nfdpm_tpu_torch import inference

        self.spec, self.seed, self.device = spec, seed, device
        img = spec.config["image"]
        self.batch, self.n_bits = spec.traffic["batch"], img["n_bits"]
        self.temperature = float(spec.traffic["temperature"])
        self.images_per_call = self.batch
        self.setup_parts = Parts(device)
        with self.setup_parts.timed("weights"):
            self.params = inputs.glow_params(spec.config, seed, device)
        self.sample = inference.make_sample_fn(glow_config(spec.config), img["size"],
                                               self.n_bits, device)
        self.shapes = [(self.batch, *s) for s in ref.latent_shapes(
            spec.config["flow"]["L"], img["size"], img["channels"])]
        self.served = []
        with self.setup_parts.timed("warm_up"):
            self.call(WARM_CALL)
        self.served.clear()

    def call(self, i: int) -> None:
        noise = inputs.normal_parts(self.shapes, self.seed, i, self.device)
        self.served.append(self.sample(self.params, self.batch, self.temperature,
                                       noise=noise).cpu())

    def close(self) -> None:
        self.sample = None

    def work(self) -> Dict:
        cfg = self.spec.config
        return {"flops": self.batch * glow_cost.flow_flops_per_image(cfg, splits=True),
                "flow": glow_cost.mix_tail_work(cfg, self.batch, ("inverse",)),
                "steps": 0}

    def check(self) -> Dict[str, float]:
        params = ref.cast(self.params, DTYPE)
        gap = 0.0
        for i in sample_indices(self.seed, len(self.served), self.spec.cell["check"]["calls"]):
            noise = [e.to(DTYPE) for e in inputs.normal_parts(self.shapes, self.seed, i,
                                                               self.device)]
            with torch.no_grad():
                top = ref.sample_latents(params, noise[-1], self.temperature)
                x = ref.inverse(params["flow"], [None] * (len(noise) - 1) + [top], noise,
                                self.temperature)
            served = self.served[i].to(self.device)
            gap = worst(gap, float(ref.bin_gap_levels(x, served, self.n_bits).max()))
        return {"pixel_bin_gap": gap}
