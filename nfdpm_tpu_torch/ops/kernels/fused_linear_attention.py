"""Fused linear-attention block of the UNet: CUDA kernel wrapper and plain version.

    y = ChannelLayerNorm(Conv_out(attend(Conv_qkv(x))))     (the caller adds x)

Counterpart of nfdpm_tpu/ops/pallas/fused_linear_attention.py. The kernels
are `fused_linear_attention_f32` and `fused_linear_attention_bwd_f32` in
csrc/linear_attention.cu (its note says what bounds them and how they are
laid out). Weights are the 1x1 convs as matrices: w_qkv [C, 3*hidden]
(columns [q | k | v], head-major within each), w_out [hidden, C], b_out [C],
and the LayerNorm gain g [C].

Gradient, as `_fla_bwd` there (the VJP of `_reference_impl`):
`FusedLinearAttentionFunction`, whose backward is the hand-written kernel on
CUDA tensors and `fused_linear_attention_bwd_plain`, the same formulas
written out in PyTorch, on CPU tensors. The kernel forms dqkv, dy and o; the
large plain products (dx, dW_qkv, dW_out, db_out) are matmuls and sums here,
as the JAX package left the whole backward to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

# Shared memory a block may use on Hopper (227 KB).
_MAX_SMEM = 232448
# The kernel's fixed head layout (the UNet's LinearAttention defaults).
KERNEL_HEADS, KERNEL_DIM_HEAD = 4, 32
_MAX_GRID_Y = 65535
EPS = 1e-5

Grads = Tuple[Optional[torch.Tensor], ...]


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
    out = (out - mean) * torch.rsqrt(var + EPS) * g
    return out.reshape(b, hh, ww, c)


def fused_linear_attention_bwd_plain(x: torch.Tensor, w_qkv: torch.Tensor,
                                     w_out: torch.Tensor, b_out: torch.Tensor,
                                     g: torch.Tensor, dout: torch.Tensor,
                                     heads: int = 4, dim_head: int = 32) -> Grads:
    """Plain PyTorch version of the gradient: the cotangent dout [B, H, W, C]
    -> (dx, dW_qkv, dW_out, db_out, dg), each shaped like its input.

    The forward recomputed, then the chain rule written out term by term
    (not autograd through the plain forward), with s = dim_head^-1/2,
    q_s = s softmax_d(q), k_s = softmax_n(k), v_s = v / N:
        dh = dout g;  dy = rstd (dh - mean(dh) - yhat mean(dh yhat))
        do = dy W_out^T;  dctx_h = q_s,h^T do_h;  dq_s,h = do_h ctx_h^T
        dq = q_s (dq_s - sum_d q_s dq_s / s)
        dk_s,h = v_s,h dctx_h^T;  dk = k_s (dk_s - sum_n k_s dk_s)
        dv = k_s,h dctx_h / N
        dx = dqkv W_qkv^T, dW_qkv = x^T dqkv, dW_out = o^T dy, db = sum dy,
        dg = sum dout yhat."""
    b, hh, ww, c = x.shape
    n, hidden = hh * ww, heads * dim_head
    scale = dim_head ** -0.5
    x2 = x.reshape(b, n, c)
    q, k, v = torch.matmul(x2, w_qkv).split(hidden, dim=-1)
    qs = torch.softmax(q.reshape(b, n, heads, dim_head), dim=-1) * scale
    ks = torch.softmax(k.reshape(b, n, heads, dim_head), dim=1)
    vs = v.reshape(b, n, heads, dim_head) / n
    ctx = torch.einsum("bnhd,bnhe->bhde", ks, vs)
    o = torch.einsum("bnhd,bhde->bnhe", qs, ctx).reshape(b, n, hidden)
    y = torch.matmul(o, w_out) + b_out
    mean = y.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(((y - mean) ** 2).mean(dim=-1, keepdim=True) + EPS)
    yhat = (y - mean) * rstd

    dout = dout.reshape(b, n, c)
    dh = dout * g
    dy = rstd * (dh - dh.mean(dim=-1, keepdim=True)
                 - yhat * (dh * yhat).mean(dim=-1, keepdim=True))
    do = torch.matmul(dy, w_out.T).reshape(b, n, heads, dim_head)
    dctx = torch.einsum("bnhd,bnhe->bhde", qs, do)
    dqs = torch.einsum("bnhe,bhde->bnhd", do, ctx)
    dq = qs * (dqs - (qs * dqs).sum(dim=-1, keepdim=True) / scale)
    dks = torch.einsum("bnhe,bhde->bnhd", vs, dctx)
    dk = ks * (dks - (ks * dks).sum(dim=1, keepdim=True))
    dv = torch.einsum("bnhd,bhde->bnhe", ks, dctx) / n
    dqkv = torch.cat([dq.reshape(b, n, hidden), dk.reshape(b, n, hidden),
                      dv.reshape(b, n, hidden)], dim=-1).reshape(b * n, 3 * hidden)
    dx = torch.matmul(dqkv, w_qkv.T).reshape(x.shape)
    dw_qkv = torch.matmul(x2.reshape(b * n, c).T, dqkv)
    dw_out = torch.matmul(o.reshape(b * n, hidden).T, dy.reshape(b * n, c))
    db_out = dy.reshape(b * n, c).sum(dim=0)
    dg = (dout * yhat).reshape(b * n, c).sum(dim=0)
    return dx, dw_qkv, dw_out, db_out, dg


def _check(name: str, x, w_qkv, w_out, b_out, g, heads: int, dim_head: int):
    """Raise unless the operands are what the kernels take; returns the device."""
    device = _build.check_cuda_f32(name, x, w_qkv, w_out, b_out, g)
    if (heads, dim_head) != (KERNEL_HEADS, KERNEL_DIM_HEAD):
        raise ValueError(f"{name}: the kernel takes heads={KERNEL_HEADS}, "
                         f"dim_head={KERNEL_DIM_HEAD}, got {heads}, {dim_head}")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [B, H, W, C], got {tuple(x.shape)}")
    b, _, _, c = x.shape
    hidden = heads * dim_head
    expected = {"w_qkv": (c, 3 * hidden), "w_out": (hidden, c), "b_out": (c,), "g": (c,)}
    for arg, t in zip(expected, (w_qkv, w_out, b_out, g)):
        if tuple(t.shape) != expected[arg]:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} != {expected[arg]}")
    if b > _MAX_GRID_Y:
        raise ValueError(f"{name}: batch {b} > {_MAX_GRID_Y}")
    return device


def _forward_kernel(x, w_qkv, w_out, b_out, g, heads: int = 4, dim_head: int = 32):
    """One launch of the forward on checked CUDA operands: (y, ctx, stats),
    the contexts [B, 4, 32, 32] and the k softmax's maximum and sum
    [B, 4, 2, 32] that the backward reads."""
    device = _check("fused_linear_attention", x, w_qkv, w_out, b_out, g, heads, dim_head)
    b, hh, ww, c = x.shape
    lib = _build.library("attention_kernels")
    if lib.fused_linear_attention_smem_bytes(c) > _MAX_SMEM:
        raise ValueError(f"fused_linear_attention: C={c} exceeds the shared memory "
                         "of one block")
    y = torch.empty_like(x)
    ctx = torch.empty((b, heads, dim_head, dim_head), dtype=torch.float32, device=device)
    stats = torch.empty((b, heads, 2, dim_head), dtype=torch.float32, device=device)
    if y.numel() == 0:
        return y, ctx, stats
    with torch.cuda.device(device):
        err = lib.fused_linear_attention_f32(
            x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
            g.data_ptr(), ctx.data_ptr(), stats.data_ptr(), y.data_ptr(), b, hh * ww, c,
            _build.stream_handle(device))
    _build.raise_on_error("fused_linear_attention", err)
    fused_linear_attention.launches += 1
    return y, ctx, stats


def fused_linear_attention_bwd(x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor,
                               b_out: torch.Tensor, g: torch.Tensor, ctx: torch.Tensor,
                               stats: torch.Tensor, dout: torch.Tensor,
                               needs: Tuple[bool, ...] = (True,) * 5) -> Grads:
    """The gradient on CUDA tensors: one launch of the backward kernel (two
    CUDA kernels, counted as one), then the plain products. `ctx` and
    `stats` are what the forward launch wrote for the same inputs; `needs`
    says which of (dx, dW_qkv, dW_out, db_out, dg) to form (None for the
    others)."""
    device = _check("fused_linear_attention_bwd", x, w_qkv, w_out, b_out, g,
                    KERNEL_HEADS, KERNEL_DIM_HEAD)
    _build.check_cuda_f32("fused_linear_attention_bwd", x, ctx, stats, dout)
    b, hh, ww, c = x.shape
    n, hidden = hh * ww, KERNEL_HEADS * KERNEL_DIM_HEAD
    if tuple(dout.shape) != tuple(x.shape):
        raise ValueError(f"fused_linear_attention_bwd: dout {tuple(dout.shape)} != x "
                         f"{tuple(x.shape)}")
    if (tuple(ctx.shape) != (b, KERNEL_HEADS, KERNEL_DIM_HEAD, KERNEL_DIM_HEAD)
            or tuple(stats.shape) != (b, KERNEL_HEADS, 2, KERNEL_DIM_HEAD)):
        raise ValueError("fused_linear_attention_bwd: ctx and stats are not the "
                         "forward's for this batch")
    lib = _build.library("attention_kernels")
    if lib.fused_linear_attention_bwd_smem_bytes(c) > _MAX_SMEM:
        raise ValueError(f"fused_linear_attention_bwd: C={c} exceeds the shared "
                         "memory of one block")
    tiles = -(-n // lib.fused_linear_attention_bwd_tile())
    f32 = dict(dtype=torch.float32, device=device)
    o = torch.empty((b * n, hidden), **f32)
    dy = torch.empty((b * n, c), **f32)
    dqkv = torch.empty((b * n, 3 * hidden), **f32)
    dg_part = torch.empty((b * tiles, c), **f32)
    dctx_part = torch.empty((b, tiles, KERNEL_HEADS, KERNEL_DIM_HEAD, KERNEL_DIM_HEAD), **f32)
    if b * n and c:
        with torch.cuda.device(device):
            err = lib.fused_linear_attention_bwd_f32(
                x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
                g.data_ptr(), ctx.data_ptr(), stats.data_ptr(), dout.data_ptr(),
                o.data_ptr(), dy.data_ptr(), dqkv.data_ptr(), dg_part.data_ptr(),
                dctx_part.data_ptr(), b, n, c, _build.stream_handle(device))
        _build.raise_on_error("fused_linear_attention_bwd", err)
        fused_linear_attention_bwd.launches += 1
    else:
        for t in (o, dy, dqkv, dg_part):
            t.zero_()
    need_dx, need_wqkv, need_wout, need_b, need_g = needs
    return (torch.matmul(dqkv, w_qkv.T).reshape(x.shape) if need_dx else None,
            torch.matmul(x.reshape(b * n, c).T, dqkv) if need_wqkv else None,
            torch.matmul(o.T, dy) if need_wout else None,
            dy.sum(dim=0) if need_b else None,
            dg_part.sum(dim=0) if need_g else None)


class FusedLinearAttentionFunction(torch.autograd.Function):
    """fused_linear_attention with its hand-written gradient: on CUDA tensors
    the forward and backward kernels, on CPU tensors the plain forward and
    `fused_linear_attention_bwd_plain`."""

    @staticmethod
    def forward(ctx, x, w_qkv, w_out, b_out, g, heads, dim_head):
        ctx.heads, ctx.dim_head = heads, dim_head
        if x.device.type == "cpu":
            ctx.save_for_backward(x, w_qkv, w_out, b_out, g)
            return fused_linear_attention_plain(x, w_qkv, w_out, b_out, g, heads, dim_head)
        y, contexts, stats = _forward_kernel(x, w_qkv, w_out, b_out, g, heads, dim_head)
        ctx.save_for_backward(x, w_qkv, w_out, b_out, g, contexts, stats)
        return y

    @staticmethod
    def backward(ctx, dout):
        needs = tuple(ctx.needs_input_grad[:5])
        # autograd may hand the cotangent over as a view; the kernel takes
        # contiguous operands
        dout = dout.contiguous()
        saved = ctx.saved_tensors
        if dout.device.type == "cpu":
            grads = fused_linear_attention_bwd_plain(*saved, dout, ctx.heads, ctx.dim_head)
            grads = tuple(gr if need else None for gr, need in zip(grads, needs))
        else:
            grads = fused_linear_attention_bwd(*saved, dout, needs=needs)
        return (*grads, None, None)


def fused_linear_attention(x: torch.Tensor, w_qkv: torch.Tensor,
                           w_out: torch.Tensor, b_out: torch.Tensor,
                           g: torch.Tensor, heads: int = 4,
                           dim_head: int = 32) -> torch.Tensor:
    """x [B, H, W, C] pre-normed, fp32 -> [B, H, W, C].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (two CUDA kernels behind one call, counted as one launch) or raises.
    Differentiable in all five tensors (FusedLinearAttentionFunction); where
    no gradient is asked for, nothing is saved."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w_qkv, w_out, b_out, g)):
        return FusedLinearAttentionFunction.apply(x, w_qkv, w_out, b_out, g, heads, dim_head)
    if x.device.type == "cpu":
        return fused_linear_attention_plain(x, w_qkv, w_out, b_out, g, heads, dim_head)
    return _forward_kernel(x, w_qkv, w_out, b_out, g, heads, dim_head)[0]


fused_linear_attention.launches = 0
fused_linear_attention_bwd.launches = 0
