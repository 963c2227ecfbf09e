"""NFBackbone: the Glow flow as the diffusion prior's backbone.

Counterpart of nfdpm_tpu/models/nf_backbone.py: `transform` is the forward
without the split priors' log-densities, `invert` the exact inverse,
`sample` the inverse with an optional postprocess. A frozen flow
(`frozen=True`, the default) runs `transform` under torch.no_grad(), the
JAX package's stop_gradient on its parameters: no graph is kept and no
gradient of the flow is formed. `load_pretrained_flow` rebuilds the flow of
one of the port's own stage-1 run directories. `model` is the model axis
(parallel/tensor_parallel.ModelAxis) when the flow's parameters are a
rank's slabs of the coupling CNNs (the trainers set it from their mesh),
None on one rank. `fsdp` is the layout of a flow partitioned over the data
axis (parallel/zero.Layout, rooted at the flow): `transform` gathers each
step's weights on use. The inverse runs on whole weights. `rows` is the
model axis over which `transform` splits the images' rows (spatial
partitioning, parallel/spatial.py; the flow whole on every rank): it cuts
the images to the rank's row block, runs the flow on it, and gathers the
latents back to whole images on every rank (their gradient: the rank's own
block) and sums the logdet's partial sums over the model group.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..convert import map_tree
from ..parallel import spatial as sp
from ..parallel import tensor_parallel as tp
from . import glow as glow_m


@dataclasses.dataclass(frozen=True)
class NFBackbone:
    cfg: glow_m.GlowConfig
    img_size: int
    frozen: bool = True
    model: Optional[Any] = dataclasses.field(default=None, compare=False)
    fsdp: Optional[Any] = dataclasses.field(default=None, compare=False)
    rows: Optional[Any] = dataclasses.field(default=None, compare=False)

    def maybe_freeze(self, flow_params):
        """The parameters cut from the graph when the flow is frozen."""
        return map_tree(flow_params, torch.Tensor.detach) if self.frozen else flow_params

    def transform(self, flow_params, x: torch.Tensor, ldj: Optional[torch.Tensor] = None):
        """x [B, H, W, C] -> (latent parts, ldj [B]), whole on every rank."""
        with torch.no_grad() if self.frozen else contextlib.nullcontext():
            latents, part, _ = glow_m.forward(flow_params, self.cfg, sp.cut_rows(self.rows, x),
                                              with_logp=False, model=self.model,
                                              fsdp=self.fsdp, rows=self.rows)
            latents = [sp.gather_rows(self.rows, z) for z in latents]
            part = tp.reduce_from_model(self.rows, part)
        return latents, part if ldj is None else ldj + part

    def invert(self, flow_params, latents: Sequence[torch.Tensor],
               generator: Optional[torch.Generator] = None, temperature: float = 1.0,
               noise=None) -> torch.Tensor:
        return glow_m.inverse(flow_params, self.cfg, latents, generator, temperature, noise,
                              self.model)

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
    (nfdpm_tpu_torch.run_baseline), through training.runload.load_glow_run,
    on `device` (CUDA unless named). A run directory of the JAX package
    (orbax checkpoints) is refused with the command that converts it
    (tools/jax_run_to_torch.py)."""
    from ..training.runload import load_glow_run

    run = load_glow_run(run_dir, epoch, device, use_kernels)
    return NFBackbone(cfg=run.gcfg, img_size=run.img_size, frozen=frozen), run.params["flow"]
