"""Zero-initialized convolution with a learned channel-wise output log-scale.

Counterpart of nfdpm_tpu/ops/zeroconv.py:
    out = (conv(x) + bias) * exp(logs * 3).

Activations are NHWC at every public function, as in the JAX package.
Weights are OIHW, as `F.conv2d` takes them; the port keeps them in
channels-last memory (convert.tree_to_device) so that an NHWC activation
viewed as NCHW goes through cuDNN without a layout copy.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]

LOGSCALE_FACTOR = 3.0


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, padding: int = 0,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Stride-1 conv of NHWC `x` with OIHW `w` and symmetric padding -> NHWC.

    Another `dtype` (bf16) casts x and w, runs the conv in it (its sum
    rounded once to that dtype) and upcasts the output to fp32: the JAX
    package's rounding points (ops/coupling.py:_conv_actnorm). x is cast in
    NHWC, before the NCHW view, so that cuDNN gets channels-last operands."""
    if dtype != torch.float32:
        return conv2d_nhwc(x.to(dtype), w.to(dtype), padding).float()
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=padding)
    return y.permute(0, 2, 3, 1)


def init_zeroconv(in_channels: int, out_channels: int, filter_size: int = 3) -> Params:
    """All-zero weight (OIHW), bias and log-scale, host-side numpy."""
    return {
        "w": np.zeros((out_channels, in_channels, filter_size, filter_size), np.float32),
        "b": np.zeros((out_channels,), np.float32),
        "logs": np.zeros((out_channels,), np.float32),
    }


def zeroconv_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    pad = (params["w"].shape[-1] - 1) // 2
    y = conv2d_nhwc(x, params["w"], padding=pad) + params["b"]
    return y * torch.exp(params["logs"] * LOGSCALE_FACTOR)
