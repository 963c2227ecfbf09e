"""The affine-coupling CNN: Conv3x3+ActNorm -> ReLU -> Conv1x1+ActNorm ->
ReLU -> ZeroConv3x3.

Counterpart of nfdpm_tpu/ops/coupling.py:31-78, fp32 only. The
convolutions are library calls (cuDNN), as the JAX package left them to
XLA outside any Pallas kernel; the entry points turn TF32 off
(nfdpm_tpu_torch.disable_tf32) to keep fp32 parity.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .zeroconv import conv2d_nhwc, init_zeroconv, zeroconv_apply

Params = Dict[str, Any]


def _conv_init(rng: np.random.Generator, k: int, cin: int, cout: int) -> np.ndarray:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn in the JAX package's HWIO
    order (so one seed gives the same weights) and returned as OIHW."""
    bound = 1.0 / (cin * k * k) ** 0.5
    w = rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32)
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def init_coupling_net(rng: np.random.Generator, in_channels: int, width: int,
                      out_channels: int) -> Params:
    return {
        "conv1": {"w": _conv_init(rng, 3, in_channels, width)},
        "an1": {"scale": np.zeros((width,), np.float32),
                "bias": np.zeros((width,), np.float32)},
        "conv2": {"w": _conv_init(rng, 1, width, width)},
        "an2": {"scale": np.zeros((width,), np.float32),
                "bias": np.zeros((width,), np.float32)},
        "zconv": init_zeroconv(width, out_channels, filter_size=3),
    }


def _conv_actnorm_relu(x: torch.Tensor, conv: Params, an: Params,
                       padding: int) -> torch.Tensor:
    h = conv2d_nhwc(x, conv["w"], padding=padding)
    return torch.relu(torch.exp(an["scale"]) * (h + an["bias"]))


def coupling_net_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = _conv_actnorm_relu(x, params["conv1"], params["an1"], padding=1)
    h = _conv_actnorm_relu(h, params["conv2"], params["an2"], padding=0)
    return zeroconv_apply(params["zconv"], h)
