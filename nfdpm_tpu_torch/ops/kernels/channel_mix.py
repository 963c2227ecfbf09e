"""Fused actnorm + 1x1-conv channel mix: CUDA kernel wrapper and plain version.

    y[..., o] = sum_c x[..., c] * w_fold[o, c] + b_fold[o]

Counterpart of nfdpm_tpu/ops/pallas/channel_mix.py. The kernel is
`channel_mix_f32` in csrc/flow_kernels.cu (its note says what bounds it and
how it is laid out). The inverse Glow step calls the same function with the
inverted folded weight (ops/bijectors.py:step_inverse_kernels).

Gradient, as `_channel_mix_bwd` there: dx = g W goes back through the same
kernel in its dx mode (W read untransposed, no bias: one counted launch, no
copy); dW = g^T x and db = sum g are a matmul and a sum outside any kernel.

The kernel's layout per shape is `plan`, a pure function of the shape that
the wrapper hands to the kernel as arguments (the CPU tests hold it).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import _build
from ...utils.profiling import annotate

SMS = 132                  # H100 SXM
MAX_THREADS = 512          # csrc/flow_kernels.cu: CM_MAX_THREADS
# C = O widths the square kernel is compiled for -> (outputs per thread,
# rows per warp), csrc/flow_kernels.cu: channel_mix_f32
SQUARE = {12: (12, 32), 24: (8, 32), 48: (4, 16)}


class Plan(NamedTuple):
    variant: int         # 0: the generic kernel; else the square kernel of that width
    rows_per_block: int  # the kernel launches ceil(n / rows_per_block) blocks


@functools.lru_cache(maxsize=None)
def plan(n: int, c_in: int, c_out: int, aligned: bool = True) -> Plan:
    """The kernel's plan for n rows of c_in channels in and c_out out.

    C = O in SQUARE with 16-byte aligned operands: the square kernel,
    C / OG threads a row; rows_per_block halves from 256 until the grid
    has a block per SM or a block has RW rows (and a block stays within
    MAX_THREADS). Anything else: the generic kernel, one thread per
    output, 64 rows a block halved the same way (down to 1)."""
    def blocks(rows):
        return -(-n // rows)

    if c_in == c_out and c_in in SQUARE and aligned:
        outputs, rows_per_warp = SQUARE[c_in]
        rows = 256
        while rows > rows_per_warp and (rows * (c_in // outputs) > MAX_THREADS
                                        or blocks(rows) < SMS):
            rows //= 2
        return Plan(c_in, rows)
    rows = 64
    while rows > 1 and blocks(rows) < SMS:
        rows //= 2
    return Plan(0, rows)


def channel_mix_plain(x: torch.Tensor, w_fold: torch.Tensor,
                      b_fold: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [..., C], w_fold [O, C], b_fold [O] -> [..., O]."""
    return torch.matmul(x, w_fold.T) + b_fold


def channel_mix_dx_plain(g: torch.Tensor, w_fold: torch.Tensor) -> torch.Tensor:
    """Plain version of the dx mode: g [..., O], w_fold [O, C] -> g W [..., C],
    the same function through channel_mix_plain with W^T and a zero bias."""
    zero = torch.zeros((w_fold.shape[1],), dtype=g.dtype, device=g.device)
    return channel_mix_plain(g, w_fold.T, zero)


def _launch(x: torch.Tensor, w_fold: torch.Tensor,
            b_fold: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of the kernel on checked CUDA operands: the forward, or
    the dx mode where b_fold is None (x is then the cotangent g [..., O])."""
    dx = b_fold is None
    device = _build.check_cuda_f32("channel_mix", x, w_fold, *(() if dx else (b_fold,)))
    if w_fold.dim() != 2:
        raise ValueError(f"channel_mix: w_fold must be [O, C], got {tuple(w_fold.shape)}")
    o, c = w_fold.shape
    c_in, c_out = (o, c) if dx else (c, o)
    if x.shape[-1] != c_in:
        raise ValueError(f"channel_mix: w_fold {tuple(w_fold.shape)} does not "
                         f"take {x.shape[-1]} input channels")
    if not dx and b_fold.shape != (o,):
        raise ValueError(f"channel_mix: b_fold {tuple(b_fold.shape)} != ({o},)")
    n = x.numel() // c_in if c_in else 0
    y = (torch.empty_like(x) if c_out == c_in
         else torch.empty(x.shape[:-1] + (c_out,), dtype=torch.float32, device=device))
    aligned = (x.data_ptr() | w_fold.data_ptr() | y.data_ptr()) % 16 == 0
    p = plan(n, c_in, c_out, aligned)
    _build.launch("channel_mix", _build.function("flow_kernels", "channel_mix_f32"), device,
                  x.data_ptr(), w_fold.data_ptr(), None if dx else b_fold.data_ptr(),
                  y.data_ptr(), n, c, o, int(dx), p.variant, p.rows_per_block)
    channel_mix.launches += 1
    return y


def _mix(x: torch.Tensor, w_fold: torch.Tensor, b_fold: torch.Tensor) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if x.is_cpu:
        return channel_mix_plain(x, w_fold, b_fold)
    return _launch(x, w_fold, b_fold)


def channel_mix_dx(g: torch.Tensor, w_fold: torch.Tensor) -> torch.Tensor:
    """dx = g W [..., C] for the cotangent g [..., O], fp32: the plain version
    for a CPU tensor, one launch of the kernel's dx mode (counted in
    `channel_mix.launches`) for a CUDA tensor."""
    if g.is_cpu:
        return channel_mix_dx_plain(g, w_fold)
    return _launch(g, w_fold, None)


class ChannelMixFunction(torch.autograd.Function):
    """channel_mix with its hand-written gradient. Both passes take the
    kernel on CUDA tensors and the plain version on CPU tensors."""

    @staticmethod
    def forward(ctx, x, w_fold, b_fold):
        ctx.save_for_backward(x, w_fold)
        return _mix(x, w_fold, b_fold)

    @staticmethod
    @annotate("flow.mix.bwd")
    def backward(ctx, g):
        x, w_fold = ctx.saved_tensors
        o, c = w_fold.shape
        # autograd hands g over as a view of what follows (a slice of a
        # concatenation); the kernel takes contiguous operands
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            before = channel_mix.launches
            dx = channel_mix_dx(g, w_fold)
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
