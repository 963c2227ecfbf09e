"""Fused actnorm + 1x1-conv channel mix: CUDA kernel wrapper and plain version.

    y[..., o] = sum_c x[..., c] * w_fold[o, c] + b_fold[o]

Counterpart of nfdpm_tpu/ops/pallas/channel_mix.py. The kernel is
`channel_mix_f32` in csrc/flow_kernels.cu (its note says what bounds it and
how it is laid out). The inverse Glow step calls the same function with the
inverted folded weight (ops/bijectors.py:step_inverse_kernels).
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


def channel_mix(x: torch.Tensor, w_fold: torch.Tensor,
                b_fold: torch.Tensor) -> torch.Tensor:
    """x [..., C], w_fold [O, C], b_fold [O] -> [..., O], fp32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if x.device.type == "cpu":
        return channel_mix_plain(x, w_fold, b_fold)
    device = _build.check_cuda_f32("channel_mix", x, w_fold, b_fold)
    c = x.shape[-1]
    if w_fold.dim() != 2 or w_fold.shape[1] != c:
        raise ValueError(f"channel_mix: w_fold {tuple(w_fold.shape)} does not "
                         f"take {c} input channels")
    o = w_fold.shape[0]
    if tuple(b_fold.shape) != (o,):
        raise ValueError(f"channel_mix: b_fold {tuple(b_fold.shape)} != ({o},)")
    lib = _build.library()
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


channel_mix.launches = 0
