"""n-bit quantization pre/post-processing and uniform dequantization.

Counterpart of nfdpm_tpu/ops/quantize.py:

    preprocess : x in [0,1] -> floor(255*x / 2^(8-n_bits)) / n_bins - 0.5
    postprocess: clip(floor((y+0.5)*n_bins) * (256/n_bins), 0, 255) -> uint8
    dequantize : y + U(0, 1/n_bins)
"""

from __future__ import annotations

from typing import Optional

import torch

from . import draws


def n_bins_of(n_bits: int) -> float:
    return float(2 ** n_bits)


def preprocess(batch: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Map images in [0, 1] to centered n-bit codes in [-0.5, 0.5)."""
    n_bins = 2.0 ** n_bits
    x = batch * 255.0
    if n_bits < 8:
        x = torch.floor(x / 2.0 ** (8 - n_bits))
    return x / n_bins - 0.5


def postprocess(batch: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Map flow outputs back to uint8 pixels."""
    n_bins = 2.0 ** n_bits
    x = torch.floor((batch + 0.5) * n_bins) * (256.0 / n_bins)
    return torch.clamp(x, 0.0, 255.0).to(torch.uint8)


def dequantize(generator: Optional[torch.Generator], batch: torch.Tensor,
               n_bits: int, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add uniform dequantization noise U(0, 1/n_bins). `noise`, if given,
    is the U(0, 1) draw itself (tests feed the JAX side the same numbers)."""
    n_bins = 2.0 ** n_bits
    if noise is None:
        noise = draws.rand(batch.shape, generator, batch.device, batch.dtype)
    return batch + noise / n_bins
