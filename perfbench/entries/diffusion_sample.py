"""Stage-2 sampling, the diffusion-prior user's FID samples:
inference.make_diffusion_sample_fn's `sample` at the traffic's batch, each
call with its own chain draws (x_T and every step's eta draw, for every
latent part) made on the device from (seed, call) and handed over as
`noise=`, the images copied to the host after each call (the FID sample
cache's path), the latent parts too, for the check.

Check, for a sample of the window's calls drawn from the seed:
  latents_gap_ratio: the widest gap between the program's latent parts and
      the reference's DDIM chain over the reference UNets from the same
      draws (perfbench/reference/diffusion.py, unet.py; in fp64), over
      the widest gap of the same reference computed in fp32: the
      program's rounding in units of an fp32 implementation's own. The
      chain amplifies rounding by orders of magnitude on some draws and
      not on others, so the absolute gap swings over two decades
      from seed to seed while this ratio stays near 1;
  pixel_bin_gap: the reference Glow inverse of the program's own latent
      parts against the pixels the program served, as in glow_sample.
The chain is judged from the draws alone; the decode from the program's
latents, so that the chain's rounding, which the inverse amplifies, does
not stand in the decode's judgement.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench.bench import inputs
from perfbench.bench.parts import Parts
from perfbench.cost import glow as glow_cost
from perfbench.cost import unet as unet_cost
from perfbench.entries.glow_sample import WARM_CALL, glow_config, sample_indices, worst
from perfbench.reference import DTYPE
from perfbench.reference import diffusion as ref_diffusion
from perfbench.reference import glow as ref_glow
from perfbench.reference import unet as ref_unet

TRAFFIC = ("batch", "warmup_sampling_timesteps")  # the traffic keys this entry reads
LIBRARIES = ("flow_kernels", "attention_kernels")  # the program's kernel libraries it runs


def _prior(spec, sampling_timesteps: int):
    from nfdpm_tpu_torch.models import formaters
    from nfdpm_tpu_torch.models.diffusion_prior import DiffusionPrior

    cfg = spec.config
    img, u, d = cfg["image"], cfg["unet"], cfg["diffusion"]
    formater = formaters.get_formater(cfg["formater"])(L=cfg["flow"]["L"],
                                                       in_channels=img["channels"],
                                                       size=img["size"])
    unet_kwargs = {"dim": u["dim"], "dim_mults": tuple(u["dim_mults"]),
                   "resnet_block_groups": u["resnet_block_groups"]}
    diffusion_kwargs = {"timesteps": d["timesteps"], "sampling_timesteps": sampling_timesteps,
                        "beta_schedule": d["beta_schedule"],
                        "ddim_sampling_eta": d["ddim_sampling_eta"],
                        "objective": d["objective"], "sampling_method": "ddim"}
    return DiffusionPrior(formater, unet_kwargs, diffusion_kwargs)


class Cell:
    def __init__(self, spec, seed: int, device):
        from nfdpm_tpu_torch import inference
        from nfdpm_tpu_torch.models.nf_backbone import NFBackbone

        self.spec, self.seed, self.device = spec, seed, device
        cfg = spec.config
        img, u = cfg["image"], cfg["unet"]
        self.batch, self.n_bits = spec.traffic["batch"], img["n_bits"]
        self.images_per_call = self.batch
        self.steps = cfg["diffusion"]["sampling_timesteps"]
        self.setup_parts = Parts(device)
        with self.setup_parts.timed("weights"):
            self.flow = inputs.glow_params(cfg, seed, device)["flow"]
        dp = _prior(spec, self.steps)
        self.parts = list(dp.formater.input_shapes)
        with self.setup_parts.timed("weights"):
            self.unet_params = [
                inputs.unet_params(ref_unet.param_shapes(u["dim"], u["dim_mults"], c), cfg,
                                   seed, i, device)
                for i, (_h, _w, c) in enumerate(self.parts)]
        unets = []
        for i, named in enumerate(self.unet_params):
            unet = dp.place(dp.build_unet(i), device)
            own = dict(unet.named_parameters())
            if set(own) != set(named) or any(own[k].shape != named[k].shape for k in own):
                raise ValueError(f"part {i}: the program's UNet parameters differ from the "
                                 "reference's names and shapes")
            with torch.no_grad():
                for k, p in own.items():
                    p.copy_(named[k])
            unets.append(unet)
        self.params = {"flow": self.flow, "diffusion": {"parts": unets}}
        backbone = NFBackbone(cfg=glow_config(cfg), img_size=img["size"])
        self.sample = inference.make_diffusion_sample_fn(backbone, dp, self.n_bits, device)
        self.served: List[torch.Tensor] = []
        self.latents: List[List[torch.Tensor]] = []
        # every shape of a call, on a chain of the traffic's warm-up length
        warm_steps = spec.traffic["warmup_sampling_timesteps"]
        warm = inference.make_diffusion_sample_fn(backbone, _prior(spec, warm_steps),
                                                  self.n_bits, device)
        with self.setup_parts.timed("warm_up"):
            warm(self.params, self.batch, noise=self._noise(WARM_CALL, warm_steps))

    def _draws(self, i: int, steps: int) -> List[torch.Tensor]:
        shapes = [(steps + 1, self.batch, h, w, c) for h, w, c in self.parts]
        return inputs.normal_parts(shapes, self.seed, i, self.device)

    def _noise(self, i: int, steps: int):
        return [list(t.unbind(0)) for t in self._draws(i, steps)]

    def call(self, i: int) -> None:
        images, latents = self.sample(self.params, self.batch, noise=self._noise(i, self.steps),
                                      return_latents=True)
        self.served.append(images.cpu())
        self.latents.append([z.cpu() for z in latents])

    def close(self) -> None:
        self.sample = None
        self.params = None

    def work(self) -> Dict:
        cfg = self.spec.config
        prior = unet_cost.prior_work(cfg, self.parts)
        attention = (sum(unet_cost.linear_attention_bytes(self.batch, n, c)
                         for n, c in prior["attention"]),
                     sum(self.batch * unet_cost.linear_attention_ops(n, c)
                         for n, c in prior["attention"]))
        return {"flops": self.batch * (prior["ops"]
                                       + glow_cost.flow_flops_per_image(cfg, splits=False)),
                "flow": glow_cost.mix_tail_work(cfg, self.batch, ("inverse",)),
                "attention": attention, "steps": 0}

    def check(self) -> Dict[str, float]:
        u, d = self.spec.config["unet"], self.spec.config["diffusion"]
        gelu = self.spec.config["time_mlp_gelu"]
        flow = ref_glow.cast(self.flow, DTYPE)
        program_gap = rounding_gap = pixel_gap = 0.0
        for i in sample_indices(self.seed, len(self.served), self.spec.cell["check"]["calls"]):
            draws = self._draws(i, self.steps)
            for part, (named, t) in enumerate(zip(self.unet_params, draws)):
                z = {}
                for precision in (DTYPE, torch.float32):
                    P = {k: v.to(precision) for k, v in named.items()}
                    with torch.no_grad():
                        z[precision] = ref_diffusion.ddim_chain(
                            lambda x, tt: ref_unet.unet(P, x, tt, u["dim"], u["dim_mults"],
                                                        u["resnet_block_groups"], gelu),
                            t.to(precision).unbind(0), d["timesteps"], self.steps,
                            d["ddim_sampling_eta"])
                served = self.latents[i][part].to(self.device, DTYPE)
                program_gap = worst(program_gap, float((served - z[DTYPE]).abs().max()))
                rounding_gap = worst(rounding_gap,
                                     float((z[torch.float32].to(DTYPE) - z[DTYPE]).abs().max()))
                del z
            with torch.no_grad():
                x = ref_glow.inverse(flow, [z.to(self.device, DTYPE) for z in self.latents[i]])
            pixel_gap = worst(pixel_gap, float(ref_glow.bin_gap_levels(
                x, self.served[i].to(self.device), self.n_bits).max()))
        ratio = program_gap / rounding_gap if not rounding_gap <= 0 else (
            0.0 if program_gap == 0 else math.inf)
        return {"latents_gap_ratio": ratio, "pixel_bin_gap": pixel_gap}
