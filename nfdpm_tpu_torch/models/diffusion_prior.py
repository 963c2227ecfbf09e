"""DiffusionPrior: one UNet + GaussianDiffusion per formater-defined latent part.

Counterpart of nfdpm_tpu/models/diffusion_prior.py: training losses,
sampling, sampling given a start, interpolation and scoring (the total VLB
nats and the per-part, per-dim values). As in the JAX package, a
part's weights live in the params tree {"parts": (unet_0, ..., unet_{n-1})},
here one models/unet.Unet module per part, and every method takes that tree
first. `use_kernels=False` takes the plain PyTorch version of the
linear-attention blocks instead of the CUDA kernel, for comparison.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .diffusion import DiffusionConfig, GaussianDiffusion
from .formaters import BaseFormater
from .unet import Unet, init_unet_, to_device


@dataclasses.dataclass
class DiffusionPrior:
    """Per-part (Unet, GaussianDiffusion) from a formater and the shared
    unet and diffusion kwargs of a run's architecture."""

    formater: BaseFormater
    unet_kwargs: Dict[str, Any]
    diffusion_kwargs: Dict[str, Any]
    use_kernels: bool = True

    def __post_init__(self):
        self.parts: List[GaussianDiffusion] = []
        for (h, _w, c) in self.formater.input_shapes:
            cfg = DiffusionConfig(image_size=h, channels=c, auto_normalize=False,
                                  **self.diffusion_kwargs)
            self.parts.append(GaussianDiffusion(self._apply, cfg))

    def _apply(self, unet: Unet, x, t, x_self_cond):
        return unet(x, t, x_self_cond, use_kernels=self.use_kernels)

    @property
    def num_parts(self) -> int:
        return self.formater.num_parts

    def build_unet(self, i: int) -> Unet:
        """Part i's Unet on the CPU, its parameters not yet set."""
        c = self.formater.input_shapes[i][-1]
        return Unet(channels=c, **self.unet_kwargs)

    @staticmethod
    def place(unet: Unet, device, requires_grad: bool = False) -> Unet:
        return to_device(unet, device, requires_grad)

    def init_params(self, seed: int = 0, device=None,
                    requires_grad: bool = False) -> Dict[str, Any]:
        """Seeded random UNets (seed + i for part i) on `device`; their
        parameters autograd leaves when `requires_grad` (training)."""
        device = resolve_device(device)
        return {"parts": [self.place(init_unet_(self.build_unet(i), seed + i), device,
                                     requires_grad)
                          for i in range(self.num_parts)]}

    def unets_from_named(self, parts: Sequence[Dict[str, torch.Tensor]], device=None,
                         requires_grad: bool = False) -> List[Unet]:
        """The UNets of a checkpoint, whose parts are saved as dicts of
        tensors by parameter name, on `device`."""
        device = resolve_device(device)
        unets = []
        for i, named in enumerate(parts):
            unet = self.build_unet(i)
            with torch.no_grad():
                for name, p in unet.named_parameters():
                    p.copy_(named[name])
            unets.append(self.place(unet, device, requires_grad))
        return unets

    # -- training ------------------------------------------------------------
    def losses(self, params, latents: Sequence[torch.Tensor],
               generator: Optional[torch.Generator] = None,
               draws: Optional[Sequence[Dict[str, Any]]] = None) -> List[torch.Tensor]:
        """Per-part diffusion losses after formater processing. `draws[i]`
        holds part i's injected "t", "noise" and "self_cond" (see
        GaussianDiffusion.loss); otherwise the parts draw from `generator`
        one after the other."""
        processed = self.formater.process_latents(latents)
        out = []
        for i, (diff, z) in enumerate(zip(self.parts, processed)):
            d = draws[i] if draws is not None else {}
            out.append(diff.loss(params["parts"][i], z, generator, t=d.get("t"),
                                 noise=d.get("noise"), self_cond=d.get("self_cond")))
        return out

    # -- sampling ------------------------------------------------------------
    def sample_latents(self, params, n: int, generator: Optional[torch.Generator] = None,
                       noise: Optional[Sequence[Sequence[torch.Tensor]]] = None
                       ) -> List[torch.Tensor]:
        """Each part's chain, then formater.postprocess. `noise[i]` is part
        i's injected chain noise (see models/diffusion.py); otherwise the
        parts draw from `generator` one after the other."""
        samples = [diff.sample(params["parts"][i], n, generator,
                               None if noise is None else noise[i])
                   for i, diff in enumerate(self.parts)]
        return self.formater.postprocess(samples)

    def sample_latents_given_start(self, params, processed: Sequence[torch.Tensor],
                                   generator: Optional[torch.Generator] = None,
                                   noise=None) -> List[torch.Tensor]:
        """Each PROCESSED part (formater.process_latents' output, the space
        the models were trained in) noised to T-1 and denoised back; returns
        processed parts (undo with formater.postprocess). `noise[i]` is part
        i's injected noise (GaussianDiffusion.sample_given_start)."""
        return [diff.sample_given_start(params["parts"][i], z, generator,
                                        None if noise is None else noise[i])
                for i, (diff, z) in enumerate(zip(self.parts, processed))]

    def interpolate_latents(self, params, processed1: Sequence[torch.Tensor],
                            processed2: Sequence[torch.Tensor], lam: float = 0.5,
                            generator: Optional[torch.Generator] = None,
                            noise=None, t: Optional[int] = None) -> List[torch.Tensor]:
        """Per-part interpolation at t (default T-1, the JAX package's only
        choice) between two lists of processed parts; inputs and outputs in
        the trained space, as above."""
        return [diff.interpolate(params["parts"][i], processed1[i], processed2[i], t, lam,
                                 generator, None if noise is None else noise[i])
                for i, diff in enumerate(self.parts)]

    # -- evaluation ----------------------------------------------------------
    def _per_part_nll_nats(self, params, latents: Sequence[torch.Tensor],
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[Sequence[Sequence[torch.Tensor]]] = None
                           ) -> List[Tuple[torch.Tensor, torch.Size]]:
        """[(part's VLB, processed part's shape), ...] over the
        formater-processed parts: GaussianDiffusion.neg_log_likelihood, a
        sum of per-dim terms, per batch element. `noise[i][t]` is part i's
        draw at t; otherwise the parts draw from `generator` in turn."""
        processed = self.formater.process_latents(latents)
        return [(diff.neg_log_likelihood(params["parts"][i], z, generator,
                                         None if noise is None else noise[i]), z.shape)
                for i, (diff, z) in enumerate(zip(self.parts, processed))]

    def evaluate_neg_log_likelihood(self, params, latents: Sequence[torch.Tensor],
                                    generator: Optional[torch.Generator] = None,
                                    noise: Optional[Sequence[Sequence[torch.Tensor]]] = None
                                    ) -> List[torch.Tensor]:
        """Each part's VLB divided by its processed part's dim count, as the
        JAX package's evaluate_neg_log_likelihood (the reference's
        per-latent-dim NLL). The VLB is already a sum of per-dim terms, so
        neg_log_likelihood_nats is sum_i value_i * dims_i**2 plus the
        formater's stats_log_sigma_total()."""
        return [nll / float(np.prod(shape[1:]))
                for nll, shape in self._per_part_nll_nats(params, latents, generator, noise)]

    def neg_log_likelihood_nats(self, params, latents: Sequence[torch.Tensor],
                                generator: Optional[torch.Generator] = None,
                                noise: Optional[Sequence[Sequence[torch.Tensor]]] = None):
        """Total VLB nats per batch element over the formater-processed
        parts: each part's per-dim VLB times its dim count, plus the
        formater's sum(log std) when it standardizes. `noise[i][t]` is part
        i's draw at t."""
        return sum(nll * float(np.prod(shape[1:]))
                   for nll, shape in self._per_part_nll_nats(params, latents, generator, noise)
                   ) + self.formater.stats_log_sigma_total()
