"""Plain DDIM sampling over the diffusion prior's parts: the reference the
benchmark holds the stage-2 sampler against.

DDIM (Song et al., 2021) with eta on the strided grid of the reference
repository's GaussianDiffusion: the times linspace(-1, T-1, S+1) cast to
int and reversed; step (t, t_next) with alpha = abar_t, alpha_next =
abar_{t_next} (1 at t_next = -1):

    eps = unet(x, t);  x0 = clip(sqrt(1/abar_t) x - sqrt(1/abar_t - 1) eps, -1, 1)
    sigma = eta sqrt((1 - alpha / alpha_next) (1 - alpha_next) / (1 - alpha))
    x = sqrt(alpha_next) x0 + sqrt(1 - alpha_next - sigma^2) eps + sigma noise_j

The cosine schedule (Nichol and Dhariwal, 2021) in float64, its tables
then held in the working dtype, and each step's scalars computed in that
dtype. `noise[0]` is x_T, `noise[1 + j]` step j's draw.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


def cosine_alphas_cumprod(timesteps: int, s: float = 0.008) -> np.ndarray:
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    ac = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = np.clip(1 - ac[1:] / ac[:-1], 0, 0.999)
    return np.cumprod(1.0 - betas)


def ddim_times(timesteps: int, sampling_timesteps: int) -> List[int]:
    times = np.linspace(-1, timesteps - 1, sampling_timesteps + 1).astype(int).tolist()
    return list(reversed(times))


def ddim_chain(model: Callable, noise: Sequence[torch.Tensor], timesteps: int,
               sampling_timesteps: int, eta: float,
               record: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """One part's chain: model(x, t [1]) -> predicted noise. `record`, when
    given, receives the chain's state before each step."""
    x = noise[0]
    npdt = np.float64 if x.dtype == torch.float64 else np.float32
    ac = cosine_alphas_cumprod(timesteps).astype(npdt)
    one, zero, eta = npdt(1.0), npdt(0.0), npdt(eta)
    times = ddim_times(timesteps, sampling_timesteps)
    for j, (t, t_next) in enumerate(zip(times[:-1], times[1:])):
        if record is not None:
            record.append(x)
        tt = torch.full((1,), t, dtype=torch.int64, device=x.device)
        eps = model(x, tt)
        alpha = ac[t]
        alpha_next = one if t_next < 0 else ac[t_next]
        x0 = float(np.sqrt(one / alpha)) * x - float(np.sqrt(one / alpha - one)) * eps
        x0 = torch.clamp(x0, -1.0, 1.0)
        sigma = eta * np.sqrt(np.maximum((one - alpha / alpha_next) * (one - alpha_next)
                                         / (one - alpha), zero))
        c = np.sqrt(np.maximum(one - alpha_next - sigma ** 2, zero))
        x = x0 * float(np.sqrt(alpha_next)) + float(c) * eps
        if sigma > 0:
            x = x + float(sigma) * noise[1 + j]
    return x
