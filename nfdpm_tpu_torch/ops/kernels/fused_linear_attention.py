"""Fused linear-attention block of the UNet: CUDA kernel wrapper and plain version.

    y = ChannelLayerNorm(Conv_out(attend(Conv_qkv(x))))     (the caller adds x)

Counterpart of nfdpm_tpu/ops/pallas/fused_linear_attention.py. The kernel
is `fused_linear_attention_f32` in csrc/linear_attention.cu (its note says
what bounds it and how it is laid out). Weights are the 1x1 convs as
matrices: w_qkv [C, 3*hidden] (columns [q | k | v], head-major within
each), w_out [hidden, C], b_out [C], and the LayerNorm gain g [C]. Forward
only: the gradient belongs to the stage-2 training slice of the port, and
until then the wrapper raises where a gradient is asked for.
"""

from __future__ import annotations

import torch

from . import _build

# Shared memory a block may use on Hopper (227 KB).
_MAX_SMEM = 232448
# The kernel's fixed head layout (the UNet's LinearAttention defaults).
KERNEL_HEADS, KERNEL_DIM_HEAD = 4, 32
_MAX_GRID_Y = 65535


def fused_linear_attention_plain(x: torch.Tensor, w_qkv: torch.Tensor,
                                 w_out: torch.Tensor, b_out: torch.Tensor,
                                 g: torch.Tensor, heads: int = 4,
                                 dim_head: int = 32) -> torch.Tensor:
    """Plain PyTorch version: x [B, H, W, C] pre-normed -> [B, H, W, C].

    Per head: q softmax over the head's dims times dim_head^-1/2, k softmax
    over the tokens, context k^T (v / N), q . context; then the
    out-projection and a biasless channel LayerNorm (eps 1e-5) times g."""
    b, hh, ww, c = x.shape
    n, hidden = hh * ww, heads * dim_head
    q, k, v = torch.matmul(x.reshape(b, n, c), w_qkv).split(hidden, dim=-1)
    q = torch.softmax(q.reshape(b, n, heads, dim_head), dim=-1) * (dim_head ** -0.5)
    k = torch.softmax(k.reshape(b, n, heads, dim_head), dim=1)
    v = v.reshape(b, n, heads, dim_head) / n
    ctx = torch.einsum("bnhd,bnhe->bhde", k, v)
    out = torch.einsum("bnhd,bhde->bnhe", q, ctx).reshape(b, n, hidden)
    out = torch.matmul(out, w_out) + b_out
    mean = out.mean(dim=-1, keepdim=True)
    var = ((out - mean) ** 2).mean(dim=-1, keepdim=True)
    out = (out - mean) * torch.rsqrt(var + 1e-5) * g
    return out.reshape(b, hh, ww, c)


def fused_linear_attention(x: torch.Tensor, w_qkv: torch.Tensor,
                           w_out: torch.Tensor, b_out: torch.Tensor,
                           g: torch.Tensor, heads: int = 4,
                           dim_head: int = 32) -> torch.Tensor:
    """x [B, H, W, C] pre-normed, fp32 -> [B, H, W, C].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (two CUDA kernels behind one call, counted as one launch) or raises.
    Not differentiable yet: raises where a gradient is asked for."""
    _build.refuse_gradient("fused_linear_attention",
                           "§1.10: its backward comes with the stage-2 trainer; use "
                           "fused_linear_attention_plain", x, w_qkv, w_out, b_out, g)
    if x.device.type == "cpu":
        return fused_linear_attention_plain(x, w_qkv, w_out, b_out, g, heads, dim_head)
    device = _build.check_cuda_f32("fused_linear_attention", x, w_qkv, w_out, b_out, g)
    if (heads, dim_head) != (KERNEL_HEADS, KERNEL_DIM_HEAD):
        raise ValueError(f"fused_linear_attention: the kernel takes heads={KERNEL_HEADS}, "
                         f"dim_head={KERNEL_DIM_HEAD}, got {heads}, {dim_head}")
    if x.dim() != 4:
        raise ValueError(f"fused_linear_attention: x must be [B, H, W, C], got "
                         f"{tuple(x.shape)}")
    b, hh, ww, c = x.shape
    hidden = heads * dim_head
    expected = {"w_qkv": (c, 3 * hidden), "w_out": (hidden, c), "b_out": (c,), "g": (c,)}
    for name, t in zip(expected, (w_qkv, w_out, b_out, g)):
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"fused_linear_attention: {name} {tuple(t.shape)} != "
                             f"{expected[name]}")
    if b > _MAX_GRID_Y:
        raise ValueError(f"fused_linear_attention: batch {b} > {_MAX_GRID_Y}")
    lib = _build.library("attention_kernels")
    if lib.fused_linear_attention_smem_bytes(c) > _MAX_SMEM:
        raise ValueError(f"fused_linear_attention: C={c} exceeds the shared memory "
                         "of one block")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    ctx = torch.empty((b, heads, dim_head, dim_head), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.fused_linear_attention_f32(
            x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
            g.data_ptr(), ctx.data_ptr(), y.data_ptr(), b, hh * ww, c,
            _build.stream_handle(device))
    _build.raise_on_error("fused_linear_attention", err)
    fused_linear_attention.launches += 1
    return y


fused_linear_attention.launches = 0
