"""Zero-initialized convolution with a learned channel-wise output log-scale.

Counterpart of nfdpm_tpu/ops/zeroconv.py:
    out = (conv(x) + bias) * exp(logs * 3).

Activations are NHWC at every public function, as in the JAX package.
Weights are OIHW, as `F.conv2d` takes them; the port keeps them in
channels-last memory (convert.tree_to_device) so that an NHWC activation
viewed as NCHW goes through cuDNN without a layout copy.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import spatial as sp
from ..parallel.tensor_parallel import ModelAxis, active

Params = Dict[str, Any]

LOGSCALE_FACTOR = 3.0


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, padding: Union[int, Tuple[int, int]] = 0,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Stride-1 conv of NHWC `x` with OIHW `w` and symmetric padding (one
    for both axes, or (H, W): a row block with its halo rows takes (0, p),
    conv2d_nhwc_rows) -> NHWC.

    Another `dtype` (bf16) casts x and w, runs the conv in it (its sum
    rounded once to that dtype) and upcasts the output to fp32: the JAX
    package's rounding points (ops/coupling.py:_conv_actnorm). x is cast in
    NHWC, before the NCHW view, so that cuDNN gets channels-last operands."""
    if dtype != torch.float32:
        return conv2d_nhwc(x.to(dtype), w.to(dtype), padding).float()
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=padding)
    return y.permute(0, 2, 3, 1)


class _RowConv(torch.autograd.Function):
    """The SAME convolution of a rank's rows: the halo exchanged
    (parallel/spatial.halo), the rows with their halo convolved with no
    padding over H. The backward keeps the rows themselves and the halo
    strips only, and builds the padded rows again: the input is saved
    once, shared with what else keeps it (the ReLU before the coupling
    CNN's zeroconv), not a second time with its halo. The gradients are
    those autograd gives the convolution (aten.convolution_backward, at the
    casts of conv2d_nhwc); the halo rows' gradient goes back to their
    owners (parallel/spatial.halo_backward)."""

    @staticmethod
    def forward(ctx, x, w, axis, dtype):
        p = (w.shape[-1] - 1) // 2
        above, below = sp.halo(x, axis, p)
        ctx.save_for_backward(x, w, above, below)
        ctx.axis, ctx.p, ctx.dtype = axis, p, dtype
        return conv2d_nhwc(torch.cat([above, x, below], dim=1), w, padding=(0, p), dtype=dtype)

    @staticmethod
    def backward(ctx, gy):
        x, w, above, below = ctx.saved_tensors
        p, dt = ctx.p, ctx.dtype
        xp = torch.cat([above, x, below], dim=1)
        if dt != torch.float32:  # conv2d_nhwc's casts: operands and cotangent in dt
            xp, w_dt, gy = xp.to(dt), w.to(dt), gy.to(dt)
        else:
            w_dt = w
        gxp, gw, _ = torch.ops.aten.convolution_backward(
            gy.permute(0, 3, 1, 2), xp.permute(0, 3, 1, 2), w_dt, None, [1, 1], [0, p],
            [1, 1], False, [0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        dx = None
        if ctx.needs_input_grad[0]:
            dx = sp.halo_backward(gxp.permute(0, 2, 3, 1).to(x.dtype), ctx.axis, p)
        return dx, None if gw is None else gw.to(w.dtype), None, None


def conv2d_nhwc_rows(x: torch.Tensor, w: torch.Tensor, axis: Optional[ModelAxis],
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """conv2d_nhwc of the rank's rows `x` with OIHW `w` and SAME padding,
    the image's rows split over `axis` (spatial partitioning; None: the
    whole image): the halo rows exchanged (fp32, before conv2d_nhwc's cast
    to `dtype`), then the convolution padded over W only."""
    p = (w.shape[-1] - 1) // 2
    if not active(axis) or p == 0:
        return conv2d_nhwc(x, w, padding=p, dtype=dtype)
    return _RowConv.apply(x, w, axis, dtype)


def init_zeroconv(in_channels: int, out_channels: int, filter_size: int = 3) -> Params:
    """All-zero weight (OIHW), bias and log-scale, host-side numpy."""
    return {
        "w": np.zeros((out_channels, in_channels, filter_size, filter_size), np.float32),
        "b": np.zeros((out_channels,), np.float32),
        "logs": np.zeros((out_channels,), np.float32),
    }


def zeroconv_apply(params: Params, x: torch.Tensor, rows=None) -> torch.Tensor:
    """The zeroconv of NHWC `x`; `rows` (a model axis) when `x` is a rank's
    row block of the image (conv2d_nhwc_rows: the halo rows exchanged)."""
    y = conv2d_nhwc_rows(x, params["w"], rows) + params["b"]
    return y * torch.exp(params["logs"] * LOGSCALE_FACTOR)
