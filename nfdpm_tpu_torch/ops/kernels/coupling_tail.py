"""Affine-coupling tail, forward with its logdet and inverse: CUDA kernel
wrappers and plain versions.

    s = sigmoid(log_scale + 2);  y_b = (x_b + bias) * s;  ldj[b] = sum log(s + 1e-6)
    x_b = y_b / (sigmoid(log_scale + 2) + 1e-6) - bias

Counterpart of nfdpm_tpu/ops/pallas/coupling_tail.py. The kernels are
`coupling_tail_f32` and `coupling_tail_inverse_f32` in
csrc/flow_kernels.cu. Forward only: the gradient belongs to the training
slice of the port.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

EPS = 1e-6


def coupling_tail_plain(log_scale: torch.Tensor, bias: torch.Tensor,
                        x_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: [B, ...] inputs -> (y_b [B, ...], ldj [B])."""
    s = torch.sigmoid(log_scale + 2.0)
    y_b = (x_b + bias) * s
    ldj = torch.sum(torch.log(s + EPS).reshape(x_b.shape[0], -1), dim=1)
    return y_b, ldj


def coupling_tail_inverse_plain(log_scale: torch.Tensor, bias: torch.Tensor,
                                y_b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the inverse tail."""
    return y_b / (torch.sigmoid(log_scale + 2.0) + EPS) - bias


def _check_shapes(name: str, *tensors: torch.Tensor) -> None:
    shape = tensors[0].shape
    if any(t.shape != shape for t in tensors) or len(shape) < 1:
        raise ValueError(f"{name}: inputs must share one shape [B, ...], got "
                         f"{[tuple(t.shape) for t in tensors]}")


def coupling_tail(log_scale: torch.Tensor, bias: torch.Tensor,
                  x_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, C/2] fp32 inputs -> (y_b [B, H, W, C/2], ldj [B]).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if x_b.device.type == "cpu":
        return coupling_tail_plain(log_scale, bias, x_b)
    device = _build.check_cuda_f32("coupling_tail", log_scale, bias, x_b)
    _check_shapes("coupling_tail", log_scale, bias, x_b)
    rows = x_b.shape[0]
    d = x_b.numel() // rows if rows else 0
    y_b = torch.empty_like(x_b)
    ldj = torch.empty((rows,), dtype=torch.float32, device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.coupling_tail_f32(log_scale.data_ptr(), bias.data_ptr(),
                                    x_b.data_ptr(), y_b.data_ptr(),
                                    ldj.data_ptr(), rows, d,
                                    _build.stream_handle(device))
    _build.raise_on_error("coupling_tail", err)
    coupling_tail.launches += 1
    return y_b, ldj


def coupling_tail_inverse(log_scale: torch.Tensor, bias: torch.Tensor,
                          y_b: torch.Tensor) -> torch.Tensor:
    """Inverse tail, [B, H, W, C/2] fp32 inputs -> x_b of the same shape.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if y_b.device.type == "cpu":
        return coupling_tail_inverse_plain(log_scale, bias, y_b)
    device = _build.check_cuda_f32("coupling_tail_inverse", log_scale, bias, y_b)
    _check_shapes("coupling_tail_inverse", log_scale, bias, y_b)
    x_b = torch.empty_like(y_b)
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.coupling_tail_inverse_f32(log_scale.data_ptr(), bias.data_ptr(),
                                            y_b.data_ptr(), x_b.data_ptr(),
                                            y_b.numel(),
                                            _build.stream_handle(device))
    _build.raise_on_error("coupling_tail_inverse", err)
    coupling_tail_inverse.launches += 1
    return x_b


coupling_tail.launches = 0
coupling_tail_inverse.launches = 0
