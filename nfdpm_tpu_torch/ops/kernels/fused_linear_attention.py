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
written out in PyTorch, on CPU tensors. The kernel (`_backward_kernel`)
forms dqkv, dy, o and dg's per-tile sums; the large plain products (dx,
dW_qkv, dW_out, db_out, dg) are matmuls and sums here
(`_library_products`), as the JAX package left the whole backward to XLA.

Each kernel's layout per shape is a plan, a pure function of the shape
that the wrapper hands to the kernel as arguments (the CPU tests hold it):
`plan` for the forward, fused (one batch row a block, one pass) up to
FUSED_MAX_N tokens an image, split (a context pass over token tiles, then
an output pass) above; `bwd_plan` for the backward, fused up to
BWD_FUSED_MAX_N, split (a row pass, then a k/v pass) above. The kernels lay
out their shared memory for the plan; `smem_bytes` and `bwd_smem_bytes` are
the same sums, with which the plans refuse a shape that does not fit a
block.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

# Shared memory a block may use on Hopper (227 KB).
_MAX_SMEM = 232448
# The kernel's fixed head layout (the UNet's LinearAttention defaults).
KERNEL_HEADS, KERNEL_DIM_HEAD = 4, 32
_MAX_GRID_Y = 65535
EPS = 1e-5

# The forward's layout constants, as in csrc/linear_attention.cu.
FUSED_MAX_N = 64     # tokens an image up to which the forward is one fused pass
SPLIT_TOK = 64       # tokens per block of both split passes
BWD_FUSED_MAX_N = 32  # tokens an image up to which the backward is one fused pass
MAX_C = 256          # widest C of any plan (the out-projection's register tiles)
_KCH, _HIDDEN = 16, 128
_S_IN, _S_OUT_SPLIT = 4, 3  # stages of the weight rings (csrc: S_IN, S_OUT_SPLIT)
_QKV_LD, _KV_LD, _Q_LD = 3 * _HIDDEN + 4, 2 * _HIDDEN + 4, _HIDDEN + 4
_CS_FLOATS = KERNEL_HEADS * KERNEL_DIM_HEAD * (KERNEL_DIM_HEAD + 8)  # staged contexts
PART_FLOATS = KERNEL_HEADS * KERNEL_DIM_HEAD ** 2 + 2 * _HIDDEN  # one tile's partials
_BWD_RED = 12  # the backward's per-row reduction space, floats per row (csrc: BWD_RED)


class Plan(NamedTuple):
    fused: bool   # one pass, one batch row a block; else the two split passes
    m_tiles: int  # 16-token tiles of a block (the tensor cores' M)


def smem_bytes(fused: bool, m_tiles: int, c: int) -> int:
    """Dynamic shared memory the kernel lays out for a plan at C channels
    (split: the larger of its two passes), the sums of
    csrc/linear_attention.cu: fused_floats, ctx_pass_floats and
    out_pass_floats, times 4."""
    x_ld, nto, ring = _x_ld(c), _out_tiles(c), _ring
    if fused:
        m = 16 * m_tiles
        return 4 * (max(m * x_ld + ring(6, _S_IN),
                        m * _QKV_LD + _CS_FLOATS + ring(nto, 8 if nto <= 2 else 3)) + 10 * m)
    ctx_pass = max(SPLIT_TOK * x_ld + ring(4, _S_IN), SPLIT_TOK * _KV_LD)
    out_pass = (_CS_FLOATS + max(SPLIT_TOK * x_ld + ring(2, _S_IN),
                                 2 * SPLIT_TOK * _Q_LD + ring(nto, _S_OUT_SPLIT))
                + 10 * SPLIT_TOK)
    return 4 * max(ctx_pass, out_pass)


def _x_ld(c: int) -> int:
    return -(-c // _KCH) * _KCH + 4


def _out_tiles(c: int) -> int:
    return 1 if c <= 64 else 2 if c <= 128 else 4  # the out-projection's n-tiles


def _ring(nt: int, stages: int) -> int:
    return stages * _KCH * (64 * nt + 8)


@functools.lru_cache(maxsize=None)
def plan(n: int, c: int) -> Optional[Plan]:
    """The forward kernel's plan for images of n tokens of c channels, or
    None where no variant exists (c > MAX_C, or more shared memory than a
    block has).

    N <= FUSED_MAX_N: fused, grid B, a block holds one batch row's N tokens
    in ceil(N / 16) tensor-core row tiles. Larger N: split, both passes on a
    grid (ceil(N / SPLIT_TOK), B) of SPLIT_TOK-token tiles. Packing several
    batch rows into a block was measured and lost at every served N
    (PERF.md, Findings)."""
    if c < 1 or c > MAX_C or n < 1:
        return None
    p = Plan(True, -(-n // 16)) if n <= FUSED_MAX_N else Plan(False, SPLIT_TOK // 16)
    return p if smem_bytes(p.fused, p.m_tiles, c) <= _MAX_SMEM else None


def bwd_smem_bytes(fused: bool, m_tiles: int, c: int) -> int:
    """Dynamic shared memory the backward kernels lay out for a plan at C
    channels (split: the larger of its two kernels), the sums of
    csrc/linear_attention.cu: bwd_fused_floats, bwd_rows_floats and
    bwd_kv_floats, times 4."""
    m, x_ld = 16 * m_tiles, _x_ld(c)
    tiles = _HIDDEN * (64 * _out_tiles(c) + 8) + m * _Q_LD + m * x_ld  # W_out, o, dy
    red = _BWD_RED * m
    if fused:
        return 4 * (_CS_FLOATS + max(m * x_ld + _ring(6, _S_IN), m * _QKV_LD + tiles) + red)
    rows = _CS_FLOATS + max(m * x_ld + _ring(2, _S_IN), m * _Q_LD + tiles) + red
    kv = 2 * _CS_FLOATS + 3 * _HIDDEN + max(m * x_ld + _ring(4, _S_IN), m * _KV_LD)
    return 4 * max(rows, kv)


@functools.lru_cache(maxsize=None)
def bwd_plan(n: int, c: int) -> Optional[Plan]:
    """The backward kernels' plan for images of n tokens of c channels, or
    None where no variant fits a block.

    N <= BWD_FUSED_MAX_N: fused where its layout fits (one launch, grid B;
    a block holds one batch row's N tokens in ceil(N / 16) row tiles and
    forms dctx itself). Otherwise split, a row pass and a k/v pass on a grid
    (tiles, B) of 16 m_tiles-token tiles: 32 at N <= 64, so that a batch
    row spreads over two blocks or more; above, 64 where the layout fits,
    else 32 (C above 128). Timed at the training shapes under every plan,
    the fused plan's one block a row left half the SMs idle at N = 64 at
    batch 64 (PERF.md, Findings), so the kernels have fused variants of one
    and two row tiles only."""
    if c < 1 or c > MAX_C or n < 1:
        return None
    fused = [Plan(True, -(-n // 16))] if n <= BWD_FUSED_MAX_N else []
    split = [Plan(False, 2)] if n <= SPLIT_TOK else [Plan(False, 4), Plan(False, 2)]
    return next((p for p in fused + split if bwd_smem_bytes(p.fused, p.m_tiles, c) <= _MAX_SMEM),
                None)


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
    for arg, t, want in (("w_qkv", w_qkv, (c, 3 * hidden)), ("w_out", w_out, (hidden, c)),
                         ("b_out", b_out, (c,)), ("g", g, (c,))):
        if t.shape != want:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} != {want}")
    if b > _MAX_GRID_Y:
        raise ValueError(f"{name}: batch {b} > {_MAX_GRID_Y}")
    return device


def _forward_kernel(x, w_qkv, w_out, b_out, g, heads: int = 4, dim_head: int = 32):
    """One launch of the forward on checked CUDA operands: (y, ctx, stats),
    the contexts [B, 4, 32, 32] and the k softmax's maximum and sum
    [B, 4, 2, 32] that the backward reads."""
    device = _check("fused_linear_attention", x, w_qkv, w_out, b_out, g, heads, dim_head)
    b, hh, ww, c = x.shape
    n = hh * ww
    if x.numel() == 0:
        return (torch.empty_like(x),
                x.new_empty((b, heads, dim_head, dim_head)), x.new_empty((b, heads, 2, dim_head)))
    p = plan(n, c)
    if p is None:
        raise ValueError(f"fused_linear_attention: C={c} exceeds the shared memory "
                         "of one block")
    y = torch.empty_like(x)
    # one allocation for ctx and stats (stats starts at a multiple of 16
    # bytes); the split plan's tile partials are scratch of their own, so
    # that training, which saves ctx and stats, does not keep them
    n_ctx, n_stats = b * heads * dim_head * dim_head, b * heads * 2 * dim_head
    buf = torch.empty((n_ctx + n_stats,), dtype=torch.float32, device=device)
    ctx = buf[:n_ctx].view(b, heads, dim_head, dim_head)
    stats = buf[n_ctx:].view(b, heads, 2, dim_head)
    ptrs = [t.data_ptr() for t in (x, w_qkv, w_out, b_out, g, ctx, stats, y)]
    part = None if p.fused else torch.empty((b * -(-n // SPLIT_TOK) * PART_FLOATS,),
                                            dtype=torch.float32, device=device)
    vec = c % 4 == 0 and all(ptr % 16 == 0 for ptr in (ptrs[0], ptrs[1], ptrs[2], ptrs[7]))
    _build.launch("fused_linear_attention",
                  _build.function("attention_kernels", "fused_linear_attention_f32"), device,
                  *ptrs, None if part is None else part.data_ptr(), b, n, c, int(p.fused),
                  p.m_tiles, int(vec))
    fused_linear_attention.launches += 1
    return y, ctx, stats


def _backward_kernel(x, w_qkv, w_out, b_out, g, ctx, stats, dout):
    """One launch of the backward kernels on checked CUDA operands:
    (o [B N, 128], dy [B N, C], dqkv [B N, 384], dg_part [B tiles, C]),
    views of one allocation, from which `_library_products` forms the
    five gradients."""
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
    p = bwd_plan(n, c) if x.numel() else Plan(True, 1)
    if p is None:
        raise ValueError(f"fused_linear_attention_bwd: C={c} exceeds the shared "
                         "memory of one block")
    tiles = 1 if p.fused else -(-n // (16 * p.m_tiles))
    # o, dy, dqkv, dg_part and the split plan's dctx partials in one
    # allocation, each starting at a multiple of 16 bytes
    sizes = [b * n * hidden, b * n * c, b * n * 3 * hidden, b * tiles * c,
             0 if p.fused else b * tiles * KERNEL_HEADS * KERNEL_DIM_HEAD ** 2]
    offsets = [0]
    for size in sizes:
        offsets.append(offsets[-1] + -(-size // 4) * 4)
    buf = torch.empty((offsets[-1],), dtype=torch.float32, device=device)
    o, dy, dqkv, dg_part, dctx_part = (buf[lo:lo + size]
                                       for lo, size in zip(offsets, sizes))
    if x.numel() == 0:
        buf.zero_()
    else:
        ptrs = [t.data_ptr() for t in (x, w_qkv, w_out, b_out, g, ctx, stats, dout)]
        vec = c % 4 == 0 and all(ptr % 16 == 0 for ptr in (ptrs[0], ptrs[1], ptrs[2], ptrs[7]))
        _build.launch("fused_linear_attention_bwd",
                      _build.function("attention_kernels", "fused_linear_attention_bwd_f32"),
                      device, *ptrs, *(t.data_ptr() for t in (o, dy, dqkv, dg_part, dctx_part)),
                      b, n, c, int(p.fused), p.m_tiles, int(vec))
        fused_linear_attention_bwd.launches += 1
    return (o.view(b * n, hidden), dy.view(b * n, c), dqkv.view(b * n, 3 * hidden),
            dg_part.view(b * tiles, c))


def _library_products(x, w_qkv, o, dy, dqkv, dg_part,
                      needs: Tuple[bool, ...] = (True,) * 5) -> Grads:
    """The plain products behind the kernels: (dx, dW_qkv, dW_out, db_out, dg)
    from their outputs, None where `needs` says no."""
    b, hh, ww, c = x.shape
    need_dx, need_wqkv, need_wout, need_b, need_g = needs
    return (torch.matmul(dqkv, w_qkv.T).reshape(x.shape) if need_dx else None,
            torch.matmul(x.reshape(b * hh * ww, c).T, dqkv) if need_wqkv else None,
            torch.matmul(o.T, dy) if need_wout else None,
            dy.sum(dim=0) if need_b else None,
            dg_part.sum(dim=0) if need_g else None)


def fused_linear_attention_bwd(x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor,
                               b_out: torch.Tensor, g: torch.Tensor, ctx: torch.Tensor,
                               stats: torch.Tensor, dout: torch.Tensor,
                               needs: Tuple[bool, ...] = (True,) * 5) -> Grads:
    """The gradient on CUDA tensors: one launch of the backward kernels
    (counted as one), then the plain products. `ctx` and `stats` are what
    the forward launch wrote for the same inputs; `needs` says which of
    (dx, dW_qkv, dW_out, db_out, dg) to form (None for the others)."""
    o, dy, dqkv, dg_part = _backward_kernel(x, w_qkv, w_out, b_out, g, ctx, stats, dout)
    return _library_products(x, w_qkv, o, dy, dqkv, dg_part, needs)


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
    (one CUDA kernel, or two behind one call on the split plan, counted as
    one launch) or raises.
    Differentiable in all five tensors (FusedLinearAttentionFunction); where
    no gradient is asked for, nothing is saved."""
    if torch.is_grad_enabled() and (x.requires_grad or w_qkv.requires_grad or w_out.requires_grad
                                    or b_out.requires_grad or g.requires_grad):
        return FusedLinearAttentionFunction.apply(x, w_qkv, w_out, b_out, g, heads, dim_head)
    if x.is_cpu:
        return fused_linear_attention_plain(x, w_qkv, w_out, b_out, g, heads, dim_head)
    return _forward_kernel(x, w_qkv, w_out, b_out, g, heads, dim_head)[0]


fused_linear_attention.launches = 0
fused_linear_attention_bwd.launches = 0
