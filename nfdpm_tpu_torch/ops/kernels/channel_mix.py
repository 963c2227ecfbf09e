"""Fused actnorm + 1x1-conv channel mix: CUDA kernel wrapper and plain version.

    y[..., o] = sum_c x[..., c] * w_fold[o, c] + b_fold[o]

Counterpart of nfdpm_tpu/ops/pallas/channel_mix.py. The kernel is
`channel_mix_f32` in csrc/flow_kernels.cu (its note says what bounds it and
how it is laid out). The inverse Glow step calls the same function with the
inverted folded weight (ops/bijectors.py:step_inverse_kernels).

Gradient, as `_channel_mix_bwd` there: dx = g W goes back through the same
kernel with W^T and a zero bias (a second, counted launch); dW = g^T x and
db = sum g are a matmul and a sum outside any kernel.
"""

from __future__ import annotations

import torch

from . import _build

# Shared memory a block may use on Hopper (227 KB), see csrc/flow_kernels.cu.
_MAX_SMEM = 232448


def channel_mix_plain(x: torch.Tensor, w_fold: torch.Tensor,
                      b_fold: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [..., C], w_fold [O, C], b_fold [O] -> [..., O]."""
    return torch.matmul(x, w_fold.T) + b_fold


def _launch(x: torch.Tensor, w_fold: torch.Tensor, b_fold: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on checked CUDA operands."""
    device = _build.check_cuda_f32("channel_mix", x, w_fold, b_fold)
    c = x.shape[-1]
    if w_fold.dim() != 2 or w_fold.shape[1] != c:
        raise ValueError(f"channel_mix: w_fold {tuple(w_fold.shape)} does not "
                         f"take {c} input channels")
    o = w_fold.shape[0]
    if tuple(b_fold.shape) != (o,):
        raise ValueError(f"channel_mix: b_fold {tuple(b_fold.shape)} != ({o},)")
    lib = _build.library("flow_kernels")
    if lib.channel_mix_smem_bytes(c, o) > _MAX_SMEM:
        raise ValueError(f"channel_mix: C={c}, O={o} exceed the shared memory "
                         "of one block")
    y = torch.empty(x.shape[:-1] + (o,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.channel_mix_f32(x.data_ptr(), w_fold.data_ptr(),
                                  b_fold.data_ptr(), y.data_ptr(),
                                  x.numel() // c if c else 0, c, o,
                                  _build.stream_handle(device))
    _build.raise_on_error("channel_mix", err)
    channel_mix.launches += 1
    return y


def _mix(x: torch.Tensor, w_fold: torch.Tensor, b_fold: torch.Tensor) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return channel_mix_plain(x, w_fold, b_fold)
    return _launch(x, w_fold, b_fold)


class ChannelMixFunction(torch.autograd.Function):
    """channel_mix with its hand-written gradient. Both passes take the
    kernel on CUDA tensors and the plain version on CPU tensors."""

    @staticmethod
    def forward(ctx, x, w_fold, b_fold):
        ctx.save_for_backward(x, w_fold)
        return _mix(x, w_fold, b_fold)

    @staticmethod
    def backward(ctx, g):
        x, w_fold = ctx.saved_tensors
        o, c = w_fold.shape
        # autograd hands g over as a view of what follows (a slice of a
        # concatenation); the kernel takes contiguous operands
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            before = channel_mix.launches
            dx = _mix(g, w_fold.T.contiguous(),
                      torch.zeros((c,), dtype=g.dtype, device=g.device))
            channel_mix.backward_launches += channel_mix.launches - before
        g2d = g.reshape(-1, o)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(g2d.T, x.reshape(-1, c))
        if ctx.needs_input_grad[2]:
            db = g2d.sum(dim=0)
        return dx, dw, db


def channel_mix(x: torch.Tensor, w_fold: torch.Tensor,
                b_fold: torch.Tensor) -> torch.Tensor:
    """x [..., C], w_fold [O, C], b_fold [O] -> [..., O], fp32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. Differentiable in all three arguments (ChannelMixFunction);
    where no gradient is asked for, nothing is saved."""
    if torch.is_grad_enabled() and (x.requires_grad or w_fold.requires_grad
                                    or b_fold.requires_grad):
        return ChannelMixFunction.apply(x, w_fold, b_fold)
    return _mix(x, w_fold, b_fold)


# `launches` counts every launch of the kernel, forward and backward;
# `backward_launches` those of them made for dx in a backward pass.
channel_mix.launches = 0
channel_mix.backward_launches = 0
