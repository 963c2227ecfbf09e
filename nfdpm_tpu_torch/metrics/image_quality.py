"""SSIM / PSNR on the device (pytorch-ignite's defaults).

Counterpart of nfdpm_tpu/metrics/image_quality.py: Gaussian window 11x11,
sigma 1.5, K1 = 0.01, K2 = 0.03, images NHWC in [0, data_range] at the
interface. A depthwise `F.conv2d` (one group per channel) filters them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

WINDOW, SIGMA = 11, 1.5


def _gaussian_kernel(size: int = WINDOW, sigma: float = SIGMA) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 255.0,
         pad: str = "reflect") -> torch.Tensor:
    """Mean SSIM over a batch of [B, H, W, C] fp32 images, a 0-d tensor.

    pad="reflect" mirrors ignite: both images are reflection-padded by
    (11 - 1) / 2 before the Gaussian filter, so the SSIM map covers every
    pixel; pad="valid" averages the interior map only."""
    c = pred.shape[-1]
    x = pred.float().permute(0, 3, 1, 2)
    y = target.float().to(x.device).permute(0, 3, 1, 2)
    kernel = torch.from_numpy(_gaussian_kernel()).to(x.device).expand(c, 1, WINDOW, WINDOW)
    if pad == "reflect":
        half = (WINDOW - 1) // 2
        x = F.pad(x, (half, half, half, half), mode="reflect")
        y = F.pad(y, (half, half, half, half), mode="reflect")
    elif pad != "valid":
        raise ValueError(f"pad must be 'reflect' or 'valid', got {pad!r}")

    def filt(t):
        return F.conv2d(t, kernel, groups=c)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_p, mu_t = filt(x), filt(y)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_p = filt(x * x) - mu_pp
    sigma_t = filt(y * y) - mu_tt
    sigma_pt = filt(x * y) - mu_pt
    num = (2 * mu_pt + c1) * (2 * sigma_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sigma_p + sigma_t + c2)
    return torch.mean(num / den)


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """Mean PSNR over a batch (MSE per image, clamped at 1e-12), a 0-d tensor."""
    diff = pred.float() - target.float().to(pred.device)
    mse = torch.mean(diff * diff, dim=(1, 2, 3))
    return torch.mean(10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12)))
