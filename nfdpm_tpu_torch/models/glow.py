"""Glow: multi-scale normalizing flow.

Counterpart of nfdpm_tpu/models/glow.py:

    StepFlow  = ActNorm -> 1x1 conv -> AffineCoupling
    GlowBlock = Squeeze -> K x StepFlow -> Split       (L-1 blocks)
    Glow      = blocks -> final Squeeze -> K x StepFlow

The JAX package stacks each block's K steps and scans them; here a block's
steps are a list and the scan is a Python loop. Parameters are nested dicts
of tensors: {"blocks": [{"steps": [step, ...], "split": {"conv": ...}}],
"final_steps": [step, ...]}.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from .. import resolve_device
from ..convert import tree_to_device
from ..ops import bijectors as bj

Params = dict


@dataclasses.dataclass(frozen=True)
class GlowConfig:
    in_channels: int = 3
    levels: int = 3           # L: number of blocks incl. the final stack
    steps: int = 4            # K: step-flows per block
    coupling_width: int = 512
    learn_prior: bool = True  # learned (mean, log_sd) for the split priors
    coupling_dtype: str = "float32"  # only float32 is ported
    use_kernels: bool = True  # route the channel mix and the coupling tail
    # through ops/kernels (CUDA kernels on CUDA tensors, their plain versions
    # on CPU tensors); False takes the plain PyTorch step.
    invconv_param: str = "plu"  # "plu" or "full" (one trainable [C, C] matrix)

    def __post_init__(self):
        if self.coupling_dtype != "float32":
            raise NotImplementedError(
                f"coupling_dtype={self.coupling_dtype!r} is not ported; "
                "the port runs the coupling CNN in float32 only")
        if self.invconv_param not in ("plu", "full"):
            raise ValueError(f"invconv_param must be 'plu' or 'full', "
                             f"got {self.invconv_param!r}")


def latent_shapes_nhwc(cfg: GlowConfig, size: int) -> List[Tuple[int, int, int]]:
    """Per-part latent shapes as (H, W, C); L=3, C=3, 32 ->
    [(16,16,6), (8,8,12), (4,4,48)]."""
    shapes = []
    c, s = cfg.in_channels, size
    for _ in range(cfg.levels - 1):
        if s % 2 != 0:
            raise ValueError("The input dimension is not divisible by 2!")
        c *= 2
        s //= 2
        shapes.append((s, s, c))
    shapes.append((s // 2, s // 2, c * 4))
    return shapes


def latent_shapes_chw(cfg: GlowConfig, size: int) -> List[Tuple[int, int, int]]:
    return [(c, h, w) for (h, w, c) in latent_shapes_nhwc(cfg, size)]


def final_channels(cfg: GlowConfig) -> int:
    return (2 ** (cfg.levels + 1)) * cfg.in_channels


def init_glow(seed, cfg: GlowConfig, device=None) -> Params:
    """Host-side numpy init in the JAX package's order (an int seed gives
    the same weights as nfdpm_tpu's init_glow), then one move to `device`."""
    rng = bj.as_host_rng(seed)

    def steps(channels):
        return [bj.init_step(rng, channels, cfg.coupling_width, cfg.invconv_param)
                for _ in range(cfg.steps)]

    blocks = []
    for i in range(cfg.levels - 1):
        flow_channels = 4 * (2 ** i) * cfg.in_channels
        blocks.append({"steps": steps(flow_channels),
                       "split": bj.init_split(flow_channels, cfg.learn_prior)})
    params = {"blocks": blocks, "final_steps": steps(final_channels(cfg))}
    return tree_to_device(params, resolve_device(device))


def forward(params: Params, cfg: GlowConfig, x: torch.Tensor,
            ldj: Optional[torch.Tensor] = None, logp: Optional[torch.Tensor] = None,
            with_logp: bool = True):
    """x: [B, H, W, C] preprocessed (and dequantized) images.

    Returns (latent parts [z_1..z_{L-1}, y_final], ldj [B], logp [B] or None)."""
    b = x.shape[0]
    if ldj is None:
        ldj = torch.zeros((b,), dtype=torch.float32, device=x.device)
    if not with_logp:
        logp = None
    elif logp is None:
        logp = torch.zeros((b,), dtype=torch.float32, device=x.device)

    latents = []
    y = x
    for block in params["blocks"]:
        y = bj.squeeze_forward(y)
        for sp in block["steps"]:
            y, ldj = bj.step_forward(sp, y, ldj, cfg.use_kernels)
        y, ldj, z, logp = bj.split_forward(block["split"], y, ldj, logp)
        latents.append(z)

    y = bj.squeeze_forward(y)
    for sp in params["final_steps"]:
        y, ldj = bj.step_forward(sp, y, ldj, cfg.use_kernels)
    latents.append(y)
    return latents, ldj, logp


def inverse(params: Params, cfg: GlowConfig, latents: Sequence[torch.Tensor],
            generator: Optional[torch.Generator] = None, temperature: float = 1.0,
            noise: Optional[Sequence[Optional[torch.Tensor]]] = None) -> torch.Tensor:
    """Exact inverse. `latents` may hold only the final part: a missing
    per-level part is sampled from its split prior at `temperature`, from
    `noise[i]` ~ N(0, 1) when given (aligned with the latent parts), else
    from `generator`."""
    y = latents[-1]
    for sp in reversed(params["final_steps"]):
        y = bj.step_inverse(sp, y, cfg.use_kernels)
    y = bj.squeeze_inverse(y)

    for i, block in enumerate(reversed(params["blocks"])):
        idx = -(i + 2)
        z = latents[idx] if len(latents) >= -idx else None
        eps = noise[idx] if (z is None and noise is not None) else None
        if z is None and eps is None and generator is None:
            raise ValueError("a generator or noise is needed to sample the "
                             "missing latent parts")
        y = bj.split_inverse(block["split"], y, z, generator, temperature, eps)
        for sp in reversed(block["steps"]):
            y = bj.step_inverse(sp, y, cfg.use_kernels)
        y = bj.squeeze_inverse(y)
    return y
