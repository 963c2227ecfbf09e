"""Affine-coupling tail, forward with its logdet and inverse: CUDA kernel
wrappers and plain versions.

    s = sigmoid(log_scale + 2);  y_b = (x_b + bias) * s;  ldj[b] = sum log(s + 1e-6)
    x_b = y_b / (sigmoid(log_scale + 2) + 1e-6) - bias

Counterpart of nfdpm_tpu/ops/pallas/coupling_tail.py. The kernels are
`coupling_tail_f32`, `coupling_tail_inverse_f32` and `coupling_tail_bwd_f32`
in csrc/flow_kernels.cu. The forward tail is differentiable: its
vector-Jacobian product (`_bwd` there) is the third kernel,

    ds = s (1 - s);  d_ls = g_y (x_b + bias) ds + g_ldj[b] ds / (s + 1e-6)
    d_xb = d_bias = g_y s

The inverse tail has no gradient (the JAX package never differentiates it
either) and raises when one is asked for.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def coupling_tail_bwd_plain(log_scale: torch.Tensor, bias: torch.Tensor,
                            x_b: torch.Tensor, g_y: Optional[torch.Tensor],
                            g_ldj: Optional[torch.Tensor]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the tail's vector-Jacobian product:
    (d_log_scale, d_x_b), where d_bias equals d_x_b. `g_y` [B, ...] and
    `g_ldj` [B] are the cotangents of (y_b, ldj); None counts as zeros."""
    s = torch.sigmoid(log_scale + 2.0)
    ds = s * (1.0 - s)
    d_ls = torch.zeros_like(x_b)
    d_xb = torch.zeros_like(x_b)
    if g_y is not None:
        d_ls = d_ls + g_y * (x_b + bias) * ds
        d_xb = g_y * s
    if g_ldj is not None:
        g_rows = g_ldj.reshape((-1,) + (1,) * (x_b.dim() - 1))
        d_ls = d_ls + g_rows * ds / (s + EPS)
    return d_ls, d_xb


def _tail(log_scale: torch.Tensor, bias: torch.Tensor,
          x_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if x_b.device.type == "cpu":
        return coupling_tail_plain(log_scale, bias, x_b)
    device = _build.check_cuda_f32("coupling_tail", log_scale, bias, x_b)
    _check_shapes("coupling_tail", log_scale, bias, x_b)
    rows = x_b.shape[0]
    d = x_b.numel() // rows if rows else 0
    y_b = torch.empty_like(x_b)
    ldj = torch.empty((rows,), dtype=torch.float32, device=device)
    _build.launch("coupling_tail", _build.function("flow_kernels", "coupling_tail_f32"), device,
                  log_scale.data_ptr(), bias.data_ptr(), x_b.data_ptr(), y_b.data_ptr(),
                  ldj.data_ptr(), rows, d)
    coupling_tail.launches += 1
    return y_b, ldj


def coupling_tail_bwd(log_scale: torch.Tensor, bias: torch.Tensor, x_b: torch.Tensor,
                      g_y: Optional[torch.Tensor], g_ldj: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's vector-Jacobian product in one pass: (d_log_scale, d_x_b)
    for the cotangents g_y [B, ...] and g_ldj [B] (None: zeros); d_bias
    equals d_x_b.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x_b.device.type == "cpu":
        return coupling_tail_bwd_plain(log_scale, bias, x_b, g_y, g_ldj)
    given = [t for t in (g_y, g_ldj) if t is not None]
    device = _build.check_cuda_f32("coupling_tail_bwd", log_scale, bias, x_b, *given)
    _check_shapes("coupling_tail_bwd", log_scale, bias, x_b,
                  *([] if g_y is None else [g_y]))
    rows = x_b.shape[0]
    if g_ldj is not None and tuple(g_ldj.shape) != (rows,):
        raise ValueError(f"coupling_tail_bwd: g_ldj {tuple(g_ldj.shape)} != ({rows},)")
    d = x_b.numel() // rows if rows else 0
    d_ls, d_xb = torch.empty_like(x_b), torch.empty_like(x_b)
    _build.launch("coupling_tail_bwd", _build.function("flow_kernels", "coupling_tail_bwd_f32"),
                  device, log_scale.data_ptr(), bias.data_ptr(), x_b.data_ptr(),
                  None if g_y is None else g_y.data_ptr(),
                  None if g_ldj is None else g_ldj.data_ptr(),
                  d_ls.data_ptr(), d_xb.data_ptr(), rows, d)
    coupling_tail_bwd.launches += 1
    return d_ls, d_xb


class CouplingTailFunction(torch.autograd.Function):
    """coupling_tail with its hand-written gradient. Both passes take the
    kernels on CUDA tensors and the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, log_scale, bias, x_b):
        ctx.save_for_backward(log_scale, bias, x_b)
        ctx.set_materialize_grads(False)  # an unused output's cotangent stays None
        return _tail(log_scale, bias, x_b)

    @staticmethod
    def backward(ctx, g_y, g_ldj):
        if g_y is None and g_ldj is None:
            return None, None, None
        log_scale, bias, x_b = ctx.saved_tensors
        # autograd hands the cotangents over as views (a slice of a
        # concatenation, an expanded scalar); the kernel takes contiguous ones
        d_ls, d_xb = coupling_tail_bwd(
            log_scale, bias, x_b,
            None if g_y is None else g_y.contiguous(),
            None if g_ldj is None else g_ldj.contiguous())
        return d_ls, d_xb, d_xb


def coupling_tail(log_scale: torch.Tensor, bias: torch.Tensor,
                  x_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, C/2] fp32 inputs -> (y_b [B, H, W, C/2], ldj [B]).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. Differentiable in all three arguments (CouplingTailFunction);
    where no gradient is asked for, nothing is saved."""
    if torch.is_grad_enabled() and (log_scale.requires_grad or bias.requires_grad
                                    or x_b.requires_grad):
        return CouplingTailFunction.apply(log_scale, bias, x_b)
    return _tail(log_scale, bias, x_b)


def coupling_tail_inverse(log_scale: torch.Tensor, bias: torch.Tensor,
                          y_b: torch.Tensor) -> torch.Tensor:
    """Inverse tail, [B, H, W, C/2] fp32 inputs -> x_b of the same shape.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. Not differentiable: raises where a gradient is asked for."""
    _build.refuse_gradient("coupling_tail_inverse",
                           "§2.3: the inverse tail is not differentiated in the JAX "
                           "package either; use coupling_tail_inverse_plain",
                           log_scale, bias, y_b)
    if y_b.device.type == "cpu":
        return coupling_tail_inverse_plain(log_scale, bias, y_b)
    device = _build.check_cuda_f32("coupling_tail_inverse", log_scale, bias, y_b)
    _check_shapes("coupling_tail_inverse", log_scale, bias, y_b)
    x_b = torch.empty_like(y_b)
    _build.launch("coupling_tail_inverse",
                  _build.function("flow_kernels", "coupling_tail_inverse_f32"), device,
                  log_scale.data_ptr(), bias.data_ptr(), y_b.data_ptr(), x_b.data_ptr(),
                  y_b.numel())
    coupling_tail_inverse.launches += 1
    return x_b


coupling_tail.launches = 0
coupling_tail_bwd.launches = 0
coupling_tail_inverse.launches = 0
