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
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..convert import tree_to_device
from ..ops import bijectors as bj
from ..utils.profiling import annotate

Params = dict


@dataclasses.dataclass(frozen=True)
class GlowConfig:
    in_channels: int = 3
    levels: int = 3           # L: number of blocks incl. the final stack
    steps: int = 4            # K: step-flows per block
    coupling_width: int = 512
    learn_prior: bool = True  # learned (mean, log_sd) for the split priors
    coupling_dtype: str = "float32"  # "bfloat16": the coupling CNN's two
    # inner convolutions in bf16 (ops/coupling.py); any other string is fp32
    use_kernels: bool = True  # route the channel mix and the coupling tail
    # through ops/kernels (CUDA kernels on CUDA tensors, their plain versions
    # on CPU tensors); False takes the plain PyTorch step.
    invconv_param: str = "plu"  # "plu" or "full" (one trainable [C, C] matrix)
    remat: bool = False  # recompute each step's activations in the backward
    # pass (torch.utils.checkpoint) instead of keeping them: the same values
    # and gradients for less activation memory and one more forward
    scan_unroll: int = 1  # accepted for the JAX package's configs and
    # ignored: a block's steps are a Python loop here, there is no scan

    def __post_init__(self):
        if self.invconv_param not in ("plu", "full"):
            raise ValueError(f"invconv_param must be 'plu' or 'full', "
                             f"got {self.invconv_param!r}")

    @property
    def compute_dtype(self) -> torch.dtype:
        """The coupling CNN's convolution dtype: bf16 for "bfloat16", fp32
        for any other string (the JAX package's _coupling_jnp_dtype)."""
        return torch.bfloat16 if self.coupling_dtype == "bfloat16" else torch.float32


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


def run_step(sp: Params, y: torch.Tensor, ldj: torch.Tensor, cfg: GlowConfig, model=None,
             gather=None, rows=None):
    """One Glow step of the forward (bijectors.step_forward on the config's
    route and dtype), recomputed in the backward under `cfg.remat`.
    `gather(sp)`: the step's whole weights from its slabs (a partitioned
    flow, parallel/zero.py), called inside the recomputed function so that
    the backward gathers them again; the halo exchanges of a spatial step
    (`rows`) are recomputed there too, in the same order on every rank."""
    def fn(sp, y, ldj):
        if gather is not None:
            sp = gather(sp)
        return bj.step_forward(sp, y, ldj, cfg.use_kernels, cfg.compute_dtype, model, rows)

    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, sp, y, ldj, use_reentrant=False)
    return fn(sp, y, ldj)


def forward(params: Params, cfg: GlowConfig, x: torch.Tensor,
            ldj: Optional[torch.Tensor] = None, logp: Optional[torch.Tensor] = None,
            with_logp: bool = True, model=None, fsdp=None, rows=None):
    """x: [B, H, W, C] preprocessed (and dequantized) images. `model`: the
    model axis (parallel/tensor_parallel.ModelAxis) when `params` holds a
    rank's slabs of the coupling CNNs; None on one rank. `fsdp`: the
    layout of a flow partitioned over the data axis (parallel/zero.Layout,
    rooted at the flow): each step, and each level's split prior, gathers
    its weights just before it runs. `rows`: the model axis when `x` is
    this rank's row block of the images (spatial partitioning,
    parallel/spatial.py): the latents are the rank's rows, and `ldj` and
    `logp` the partial sums over its pixels.

    Returns (latent parts [z_1..z_{L-1}, y_final], ldj [B], logp [B] or None)."""
    with annotate("glow.forward"):
        return _forward(params, cfg, x, ldj, logp, with_logp, model, fsdp, rows)


def _forward(params, cfg, x, ldj, logp, with_logp, model, fsdp, rows):
    b = x.shape[0]
    if ldj is None:
        ldj = torch.zeros((b,), dtype=torch.float32, device=x.device)
    if not with_logp:
        logp = None
    elif logp is None:
        logp = torch.zeros((b,), dtype=torch.float32, device=x.device)

    def unit(path):
        return None if fsdp is None else (lambda tree: fsdp.gather(tree, path))

    def steps(stack, path, y, ldj):
        for i, sp in enumerate(stack):
            y, ldj = run_step(sp, y, ldj, cfg, model, unit(f"{path}/{i}"), rows)
        return y, ldj

    latents = []
    y = x
    for i, block in enumerate(params["blocks"]):
        y = bj.squeeze_forward(y)
        y, ldj = steps(block["steps"], f"blocks/{i}/steps", y, ldj)
        with annotate("glow.split"):
            split = block["split"] if fsdp is None else fsdp.gather(block["split"],
                                                                    f"blocks/{i}/split")
            y, ldj, z, logp = bj.split_forward(split, y, ldj, logp, rows)
        latents.append(z)

    y = bj.squeeze_forward(y)
    y, ldj = steps(params["final_steps"], "final_steps", y, ldj)
    latents.append(y)
    return latents, ldj, logp


@torch.no_grad()
def ddinit(params: Params, cfg: GlowConfig, x: torch.Tensor, model=None) -> Params:
    """One-batch data-dependent initialization of every actnorm in the flow
    (the steps' and the coupling CNNs'), level by level on the batch as the
    flow transforms it. Returns a new tree; `params` is not changed, and
    the leaves that are not re-initialized are shared with it."""
    zeros = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)

    def init_steps(steps, y):
        new_steps = []
        for sp in steps:
            new_sp, y = bj.step_ddinit(sp, y, model)
            new_steps.append(new_sp)
        return new_steps, y

    new_blocks = []
    y = x
    for block in params["blocks"]:
        new_steps, y = init_steps(block["steps"], bj.squeeze_forward(y))
        new_blocks.append({"steps": new_steps, "split": block["split"]})
        y = bj.split_forward(block["split"], y, zeros, None)[0]
    new_final, _ = init_steps(params["final_steps"], bj.squeeze_forward(y))
    return {"blocks": new_blocks, "final_steps": new_final}


def inverse(params: Params, cfg: GlowConfig, latents: Sequence[torch.Tensor],
            generator: Optional[torch.Generator] = None, temperature: float = 1.0,
            noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
            model=None) -> torch.Tensor:
    """Exact inverse (`model` as in `forward`). `latents` may hold only the final part: a missing
    per-level part is sampled from its split prior at `temperature`, from
    `noise[i]` ~ N(0, 1) when given (aligned with the latent parts), else
    from `generator`."""
    with annotate("glow.inverse"):
        return _inverse(params, cfg, latents, generator, temperature, noise, model)


def _inverse(params, cfg, latents, generator, temperature, noise, model):
    dtype = cfg.compute_dtype
    y = latents[-1]
    for sp in reversed(params["final_steps"]):
        y = bj.step_inverse(sp, y, cfg.use_kernels, dtype, model)
    y = bj.squeeze_inverse(y)

    for i, block in enumerate(reversed(params["blocks"])):
        idx = -(i + 2)
        z = latents[idx] if len(latents) >= -idx else None
        eps = noise[idx] if (z is None and noise is not None) else None
        if z is None and eps is None and generator is None:
            raise ValueError("a generator or noise is needed to sample the "
                             "missing latent parts")
        with annotate("glow.split"):
            y = bj.split_inverse(block["split"], y, z, generator, temperature, eps)
        for sp in reversed(block["steps"]):
            y = bj.step_inverse(sp, y, cfg.use_kernels, dtype, model)
        y = bj.squeeze_inverse(y)
    return y
