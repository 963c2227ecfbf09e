"""NFBackbone: the Glow flow as the diffusion prior's backbone.

Counterpart of nfdpm_tpu/models/nf_backbone.py: `transform` is the forward
without the split priors' log-densities, `invert` the exact inverse,
`sample` the inverse with an optional postprocess. A frozen flow
(`frozen=True`, the default) runs `transform` under torch.no_grad(), the
JAX package's stop_gradient on its parameters: no graph is kept and no
gradient of the flow is formed. `load_pretrained_flow` rebuilds the flow of
one of the port's own stage-1 run directories.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..convert import map_tree
from . import glow as glow_m


@dataclasses.dataclass(frozen=True)
class NFBackbone:
    cfg: glow_m.GlowConfig
    img_size: int
    frozen: bool = True

    def maybe_freeze(self, flow_params):
        """The parameters cut from the graph when the flow is frozen."""
        return map_tree(flow_params, torch.Tensor.detach) if self.frozen else flow_params

    def transform(self, flow_params, x: torch.Tensor, ldj: Optional[torch.Tensor] = None):
        """x [B, H, W, C] -> (latent parts, ldj [B])."""
        with torch.no_grad() if self.frozen else contextlib.nullcontext():
            latents, ldj, _ = glow_m.forward(flow_params, self.cfg, x, ldj=ldj,
                                             with_logp=False)
        return latents, ldj

    def invert(self, flow_params, latents: Sequence[torch.Tensor],
               generator: Optional[torch.Generator] = None, temperature: float = 1.0,
               noise=None) -> torch.Tensor:
        return glow_m.inverse(flow_params, self.cfg, latents, generator, temperature, noise)

    def sample(self, flow_params, latents: Sequence[torch.Tensor],
               generator: Optional[torch.Generator] = None, temperature: float = 1.0,
               postprocess_fn=None) -> torch.Tensor:
        x = self.invert(flow_params, latents, generator, temperature)
        return postprocess_fn(x) if postprocess_fn else x

    @property
    def latent_shapes(self) -> List[Tuple[int, int, int]]:
        return glow_m.latent_shapes_nhwc(self.cfg, self.img_size)


def load_pretrained_flow(run_dir: str, epoch: int, frozen: bool = True, device=None,
                         use_kernels: bool = True) -> Tuple[NFBackbone, Dict[str, Any]]:
    """The backbone and flow parameters of a stage-1 run of the port
    (nfdpm_tpu_torch.run_baseline): its architecture.json and
    checkpoints/model_gaussian_<epoch>.pt, on `device` (CUDA unless named).
    A run directory of the JAX package (orbax checkpoints) is not read yet."""
    from .. import resolve_device
    from ..training.checkpoint import checkpoint_path, load_architecture, restore_params

    device = resolve_device(device)
    path = checkpoint_path(run_dir, "gaussian", epoch)
    if not os.path.exists(path) and os.path.isdir(path[:-len(".pt")]):
        raise NotImplementedError(
            f"{run_dir} holds an orbax checkpoint of the JAX package; reading one is "
            "not ported (ROADMAP §1.1: run-dir weights). Pretrain the flow with "
            "python -m nfdpm_tpu_torch.run_baseline")
    arch = load_architecture(run_dir)
    cfg = glow_m.GlowConfig(
        in_channels=int(arch["in_channels"]), levels=int(arch["L"]), steps=int(arch["K"]),
        coupling_width=int(arch["coupling_width"]),
        learn_prior=bool(arch.get("learn_prior", True)),
        invconv_param=str(arch.get("invconv_param", "plu")), use_kernels=use_kernels)
    params = restore_params(run_dir, "gaussian", epoch, device)
    return NFBackbone(cfg=cfg, img_size=int(arch["img_size"]), frozen=frozen), params["flow"]
