"""NFBackbone: the Glow flow as the diffusion prior's backbone.

Counterpart of nfdpm_tpu/models/nf_backbone.py for inference: `transform`
is the forward without the split priors' log-densities, `invert` the exact
inverse. Freezing is a training matter: the port runs the serving path
under torch.inference_mode. `load_pretrained_flow` waits for the run-dir
reader.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from . import glow as glow_m


@dataclasses.dataclass(frozen=True)
class NFBackbone:
    cfg: glow_m.GlowConfig
    img_size: int

    def transform(self, flow_params, x: torch.Tensor, ldj: Optional[torch.Tensor] = None):
        """x [B, H, W, C] -> (latent parts, ldj [B])."""
        latents, ldj, _ = glow_m.forward(flow_params, self.cfg, x, ldj=ldj, with_logp=False)
        return latents, ldj

    def invert(self, flow_params, latents: Sequence[torch.Tensor],
               generator: Optional[torch.Generator] = None, temperature: float = 1.0,
               noise=None) -> torch.Tensor:
        return glow_m.inverse(flow_params, self.cfg, latents, generator, temperature, noise)

    @property
    def latent_shapes(self) -> List[Tuple[int, int, int]]:
        return glow_m.latent_shapes_nhwc(self.cfg, self.img_size)
