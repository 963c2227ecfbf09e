"""Gaussian prior over the final Glow latent, and the bits/dim loss.

Counterpart of nfdpm_tpu/models/prior.py: the learned prior's (mean, log_sd)
are the per-channel constants `bias * exp(3 * logs)`; with learn=False the
parameters are empty and the prior is standard normal.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..convert import tree_to_device
from ..ops.bijectors import gaussian_logp, gaussian_sample
from ..ops.zeroconv import LOGSCALE_FACTOR

Params = Dict[str, Any]


def init_gaussian_prior(channels: int, learn: bool = True, device=None) -> Params:
    """`channels` is the final-latent channel count (2^(L+1) * C_img)."""
    if not learn:
        return {}
    params = {"bias": np.zeros((2 * channels,), np.float32),
              "logs": np.zeros((2 * channels,), np.float32)}
    return tree_to_device(params, resolve_device(device))


def _moments(params: Params, channels: int,
             device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    if not params:
        z = torch.zeros((channels,), dtype=torch.float32, device=device)
        return z, z
    h = params["bias"] * torch.exp(params["logs"] * LOGSCALE_FACTOR)
    return h[:channels], h[channels:]


def gaussian_prior_logp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B] log-density of the final latent x: [B, H, W, C] (of a rank's row
    block under spatial partitioning: the partial sum over its pixels)."""
    mean, logsd = _moments(params, x.shape[-1], x.device)
    return gaussian_logp(x, mean, logsd)


def gaussian_prior_sample(params: Params, generator: Optional[torch.Generator],
                          shape: Tuple[int, int, int, int], temperature: float = 1.0,
                          eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample [B, H, W, C] at `temperature`, from `eps` ~ N(0, 1) if given,
    else from `generator` (on the device the sample is made on)."""
    device = eps.device if eps is not None else generator.device
    mean, logsd = _moments(params, shape[-1], device)
    return gaussian_sample(generator, mean.expand(shape), logsd.expand(shape),
                           temperature, eps)


def bits_per_dim(log_likelihood: torch.Tensor, n_bins: float, n_pixel: float) -> torch.Tensor:
    """BPD = (log(n_bins)*n_pixel - ll) * log2(e) / n_pixel, batch mean."""
    return torch.mean((np.log(n_bins) * n_pixel - log_likelihood) * (np.log2(np.e) / n_pixel))


def n_pixels(img_size: int, channels: int = 3, compat_three_channels: bool = True) -> float:
    """The reference counts 3 channels even for 1-channel images;
    `compat_three_channels` keeps that count, False gives the true one."""
    c = 3.0 if compat_three_channels else float(channels)
    return float(img_size) * float(img_size) * c
