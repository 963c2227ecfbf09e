"""The affine-coupling CNN: Conv3x3+ActNorm -> ReLU -> Conv1x1+ActNorm ->
ReLU -> ZeroConv3x3.

Counterpart of nfdpm_tpu/ops/coupling.py. The convolutions are library
calls (cuDNN), as the JAX package left them to XLA outside any Pallas
kernel; the entry points turn TF32 off (nfdpm_tpu_torch.disable_tf32) to
keep fp32 parity. A `dtype` of bf16 runs the two inner convolutions in bf16
where the JAX package does: their operands cast, their outputs upcast, the
actnorm epilogue, the ReLUs and the zeroconv in fp32, so the zeroconv's
output, which the step tails take, stays fp32. The data-dependent init is
fp32 whatever the dtype, as in the JAX package.

Tensor parallelism (`model`, a parallel/tensor_parallel.ModelAxis; the
JAX package's sharding_rules._spec_for): the rank holds conv1's kernel and
an1's scale and bias on its slab of the hidden width (column-parallel, its
replicated input through "f"), conv2's kernel on its slab of the input
width (row-parallel, its partial output summed by "g" before an2, which is
replicated), and the zeroconv's kernel on its slab of the input width: the
rank takes its slab of the replicated hidden activation, convolves it and
"g" sums the partial outputs. Every model rank then holds the same whole
zeroconv output r, which the Glow step's tails take as on one device. bf16
casts each slab as it casts the whole.

Spatial partitioning (`rows`, the model axis carrying image rows,
parallel/spatial.py): the input is the rank's row block, the weights are
whole, and the two 3x3 convolutions (conv1 and the zeroconv,
zeroconv.conv2d_nhwc_rows) exchange their halo rows with the neighbouring
ranks first; the 1x1 conv2 needs
none. Under bf16 the halo rows move in fp32 and the cast stays where
conv2d_nhwc puts it.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..parallel import tensor_parallel as tp
from .zeroconv import LOGSCALE_FACTOR, conv2d_nhwc, conv2d_nhwc_rows, init_zeroconv

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
                       dtype: torch.dtype = torch.float32, rows=None) -> torch.Tensor:
    h = conv2d_nhwc_rows(x, conv["w"], rows, dtype)
    return torch.relu(torch.exp(an["scale"]) * (h + an["bias"]))


def _actnorm_relu(h: torch.Tensor, an: Params) -> torch.Tensor:
    return torch.relu(torch.exp(an["scale"]) * (h + an["bias"]))


def _trunk(params: Params, x: torch.Tensor, dtype: torch.dtype = torch.float32,
           model=None, rows=None) -> torch.Tensor:
    """Conv3x3+ActNorm -> ReLU -> Conv1x1+ActNorm -> ReLU: the zeroconv's
    input (whole on every model rank; the rank's rows under `rows`)."""
    h = _conv_actnorm_relu(tp.copy_to_model(model, x), params["conv1"], params["an1"], dtype,
                           rows)
    h = tp.reduce_from_model(model, conv2d_nhwc(h, params["conv2"]["w"], padding=0, dtype=dtype))
    return _actnorm_relu(h, params["an2"])


def _zeroconv_conv(zconv: Params, h: torch.Tensor, model=None, rows=None) -> torch.Tensor:
    """The zeroconv's convolution of the whole hidden activation `h`: under
    a model axis the rank's slab of its channels against the kernel's slab,
    the partial outputs summed; under `rows` the rank's rows, with their
    halo."""
    r = conv2d_nhwc_rows(tp.scatter_to_model(model, h, -1), zconv["w"], rows)
    return tp.reduce_from_model(model, r)


def _zeroconv_epilogue(zconv: Params, r: torch.Tensor) -> torch.Tensor:
    return (r + zconv["b"]) * torch.exp(zconv["logs"] * LOGSCALE_FACTOR)


def coupling_net_apply(params: Params, x: torch.Tensor,
                       dtype: torch.dtype = torch.float32, model=None,
                       rows=None) -> torch.Tensor:
    r = _zeroconv_conv(params["zconv"], _trunk(params, x, dtype, model, rows), model, rows)
    return _zeroconv_epilogue(params["zconv"], r)


def coupling_net_conv(params: Params, x: torch.Tensor,
                      dtype: torch.dtype = torch.float32, model=None,
                      rows=None) -> torch.Tensor:
    """The coupling CNN up to the zeroconv's convolution, before its bias and
    scale: coupling_net_apply(params, x) == (r + b) * exp(3 logs) with
    r = coupling_net_conv(params, x) and the zeroconv's b and logs. The
    Glow step's kernel route hands r to the step tail, which applies that
    epilogue itself (ops/kernels/coupling_tail.py: coupling_step_tail).
    Under a `model` axis r is the whole sum, the same on every rank; under
    `rows` the rank's rows of it."""
    return _zeroconv_conv(params["zconv"], _trunk(params, x, dtype, model, rows), model, rows)


def actnorm_stats_init(h: torch.Tensor, eps: float = 1e-6) -> Params:
    """Data-dependent actnorm leaves from one batch h [B, H, W, C]: per
    channel, scale = -log(std + eps) with the Bessel-corrected std (ddof=1,
    torch.std's default) and bias = -mean, so that exp(scale) * (h + bias)
    has zero mean and unit variance."""
    return {"scale": -torch.log(torch.std(h, dim=(0, 1, 2)) + eps),
            "bias": -torch.mean(h, dim=(0, 1, 2))}


@torch.no_grad()
def coupling_net_ddinit(params: Params, x: torch.Tensor,
                        model=None) -> Tuple[Params, torch.Tensor]:
    """Initialize the two inner actnorms from the batch's statistics after
    each conv, then apply. Returns (new params, output); `params` is not
    changed, and the new tree shares every other leaf with it. Under a
    `model` axis an1's statistics are per channel of the rank's slab, and
    an2's are taken after the partial outputs are summed: the same on every
    rank."""
    h1 = conv2d_nhwc(x, params["conv1"]["w"], padding=1)
    an1 = actnorm_stats_init(h1)
    y1 = _actnorm_relu(h1, an1)
    h2 = tp.reduce_from_model(model, conv2d_nhwc(y1, params["conv2"]["w"], padding=0))
    an2 = actnorm_stats_init(h2)
    y2 = _actnorm_relu(h2, an2)
    new = dict(params)
    new["an1"], new["an2"] = an1, an2
    return new, _zeroconv_epilogue(params["zconv"], _zeroconv_conv(params["zconv"], y2, model))
