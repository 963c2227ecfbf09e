"""DDPM UNet over NHWC tensors, as torch.nn.Modules.

Counterpart of nfdpm_tpu/models/unet.py: 7x7 init conv, sinusoidal or
random/learned Fourier time embedding, a down path of [ResnetBlock x2 +
linear attention + Downsample], full softmax attention in the middle, the
mirrored up path with skip concatenations, a final res-block and 1x1 conv.
Blocks are weight-standardized convs + GroupNorm + SiLU with FiLM time
conditioning.

Activations are NHWC at every module, as in the JAX package; convolutions
run on the NCHW view of an NHWC tensor (channels-last memory), so cuDNN
takes them without a layout copy. Conv weights are OIHW, Dense weights
[out, in] (nn.Linear), and the attention 1x1 convs are plain matrices
w_qkv [C, 3*hidden] and w_out [hidden, C], the layout the fused kernel
takes. `convert.unet_from_flax` fills a Unet from the JAX package's flax
parameter tree.

The linear-attention blocks go through ops/kernels/fused_linear_attention
(the CUDA kernel on CUDA tensors, its plain version on CPU tensors) unless
`use_kernels=False` is passed to the forward, which takes the plain
version everywhere. Their gradient is the kernel's hand-written backward
(FusedLinearAttentionFunction). The mid-block attention is plain PyTorch,
as it was XLA outside Pallas in the JAX package.

`dtype` (bf16) runs the convolutions in it where the JAX package does, with
its two rounding kinds: a weight-standardized conv (Block) standardizes the
kernel in fp32, casts it and x, upcasts the conv's output and adds the fp32
bias; every other conv but the last (the 7x7 init conv, the residual 1x1
convs, Downsample, Upsample and the last level's 3x3 convs) is flax's
nn.Conv(dtype=bf16), which casts the bias too and adds it in bf16 before
the upcast. The final 1x1 conv, the norms, the time MLP and FiLM, both
attentions (the kernel's operands are fp32) and the residual adds stay
fp32. The parameters are fp32 whatever the dtype.

Tensor parallelism (`shard_unet_`): under a model axis each rank holds the
slabs of the JAX package's UNet rules (parallel/sharding_rules.py
_unet_spec_for) and the blocks call the model axis's collectives
(parallel/tensor_parallel.py). Every ResnetBlock's Block_0 is
column-parallel: its WSConv kernel, bias and GroupNorm on the output
channels (the kernel's standardization is per output channel, so local;
a group split across ranks takes its statistics over the model group, see
GroupNorm), the FiLM scale and shift cut to the rank's columns. Block_1
is row-parallel: its kernel on the input channels, whose standardization
statistics are summed over the model group, then the partial output
all-reduced and the bias added once. The attention blocks the rules name
(LinearAttention_0's and the mid Attention_0's qkv and out matrices) hold
contiguous slabs that are not head groups, so they gather their weights
and run whole on every rank: the fused kernel, its backward and its
launch counts as on one device. Everything else is replicated.

Parameter partitioning over the data axis (`gather_units`,
parallel/zero.py): each rank holds slabs of the placed parameters, and
each ResnetBlock, each attention with its norm, and the rest of the UNet
as one unit gather their whole weights just before they run; the backward
reduce-scatters their gradients.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.bijectors import squeeze_forward
from ..parallel import tensor_parallel as tp
from ..ops.kernels.fused_linear_attention import (fused_linear_attention,
                                                  fused_linear_attention_plain)
from ..utils.profiling import annotate

EPS = 1e-5


def torch_dtype(dtype) -> torch.dtype:
    """A UNet's compute dtype from a torch dtype or its name ("float32",
    "bfloat16", "float16"): a floating type, else TypeError, as
    jnp.dtype(...) refuses a name it does not know."""
    dt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise TypeError(f"data type {dtype!r} not understood")
    return dt


def _conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               padding: int) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=padding)
    return y.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """flax nn.Conv counterpart: stride 1, symmetric padding, OIHW weight.
    Another `dtype` casts x, the weight and the bias to it, adds the bias
    in it and upcasts the sum (flax's promote_dtype, then the JAX UNet's
    .astype(float32))."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.padding = padding
        self.dtype = dtype

    def forward(self, x):
        if self.dtype == torch.float32:
            return _conv_nhwc(x, self.weight, self.bias, self.padding)
        dt = self.dtype
        y = _conv_nhwc(x.to(dt), self.weight.to(dt), None, self.padding)
        return (y + self.bias.to(dt)).float()


class WeightStandardizedConv(Conv):
    """Conv whose kernel is standardized per output channel over
    (kh, kw, in), biased variance, eps 1e-5. Another `dtype` runs the conv
    alone in it: the standardized kernel and x cast, the output upcast,
    then the fp32 bias added. `row_axis` (a model axis) makes it
    row-parallel: the kernel is the rank's slab of the input channels."""

    row_axis = None

    def forward(self, x):
        w = self.weight
        if self.row_axis is not None:
            return self._row_parallel(x, self.row_axis)
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = ((w - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
        w = (w - mean) * torch.rsqrt(var + EPS)
        if self.dtype == torch.float32:
            return _conv_nhwc(x, w, self.bias, self.padding)
        dt = self.dtype
        return _conv_nhwc(x.to(dt), w.to(dt), None, self.padding).float() + self.bias

    def _row_parallel(self, x, axis):
        """The statistics of each output channel summed over the model group's
        slabs of its inputs, the partial conv all-reduced, the bias added."""
        w = self.weight
        count = w[0].numel() * axis.n
        mean = tp.sum_over_model(axis, w.sum(dim=(1, 2, 3), keepdim=True)) / count
        var = tp.sum_over_model(axis, ((w - mean) ** 2).sum(dim=(1, 2, 3), keepdim=True)) / count
        w = (w - mean) * torch.rsqrt(var + EPS)
        dt = self.dtype
        y = _conv_nhwc(x.to(dt), w.to(dt), None, self.padding).float()
        return tp.reduce_from_model(axis, y) + self.bias


class ChannelLayerNorm(nn.Module):
    """Biasless LayerNorm over channels with a learned gain (biased variance)."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + EPS) * self.g


class SinusoidalPosEmb(nn.Module):
    """[T] time steps -> [T, dim] (sin | cos)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        half = self.dim // 2
        emb = math.log(10000.0) / (half - 1)
        emb = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
        emb = t[:, None].float() * emb[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class RandomOrLearnedSinusoidalPosEmb(nn.Module):
    """Fourier features of t, [T] -> [T, dim + 1] (t | sin | cos); random
    and learned frequencies differ only in training."""

    def __init__(self, dim: int):
        super().__init__()
        self.weights = nn.Parameter(torch.empty(dim // 2))

    def forward(self, t):
        t = t[:, None].float()
        freqs = t * self.weights[None, :] * 2 * math.pi
        return torch.cat([t, torch.sin(freqs), torch.cos(freqs)], dim=-1)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm over the NCHW view of an activation. `axis` (a model
    axis) when the module holds the rank's contiguous slab of the channels
    (its weight and bias too): groups that lie whole on every rank are
    normalized locally; otherwise each group's statistics are taken over
    all of its channels, wherever they live. The rank sums, per image, its
    channels' part of each group (zero for a group it does not touch), the
    sums go over the model group (sum_over_model: all-reduce forward and
    backward, as every rank uses them), the mean is the whole group's sum
    over (C/G) H W, and the variance is taken the same way from the centred
    squares (two passes, as the weight standardization does)."""

    axis = None

    def forward(self, x):
        axis = self.axis
        if not tp.active(axis):
            return super().forward(x)
        if self.num_groups % axis.n == 0:
            return F.group_norm(x, self.num_groups // axis.n, self.weight, self.bias, self.eps)
        b, c, h, w = x.shape
        size = self.num_channels // self.num_groups
        channel = torch.arange(axis.index * c, (axis.index + 1) * c, device=x.device)
        member = F.one_hot(channel // size, self.num_groups).to(x.dtype)  # [c, G]
        count = size * h * w

        def group_mean(t):  # [B, c, H, W] -> each channel's group mean, [B, c, 1, 1]
            sums = tp.sum_over_model(axis, t.sum(dim=(2, 3)) @ member)
            return ((sums / count) @ member.T)[:, :, None, None]

        centred = x - group_mean(x)
        y = centred * torch.rsqrt(group_mean(centred * centred) + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class Block(nn.Module):
    """WSConv 3x3 -> GroupNorm -> (FiLM) -> SiLU. `column_axis` (a model
    axis) makes it column-parallel: the rank's slab of the output channels,
    its input replicated."""

    column_axis = None

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = WeightStandardizedConv(dim_in, dim_out, 3, padding=1, dtype=dtype)
        self.norm = GroupNorm(groups, dim_out, eps=EPS)

    def forward(self, x, scale_shift=None):
        x = self.conv(tp.copy_to_model(self.column_axis, x))
        x = self.norm(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x)


class ResnetBlock(nn.Module):
    """Two Blocks with FiLM from the time embedding, plus a (1x1-conv)
    residual."""

    def __init__(self, dim_in: int, dim_out: int, time_emb_dim: int, groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.time_dense = nn.Linear(time_emb_dim, dim_out * 2)
        self.block0 = Block(dim_in, dim_out, groups, dtype)
        self.block1 = Block(dim_out, dim_out, groups, dtype)
        self.res_conv = Conv(dim_in, dim_out, 1, dtype=dtype) if dim_in != dim_out else None

    @annotate("unet.resnet")
    def forward(self, x, time_emb):
        h_t = self.time_dense(F.silu(time_emb))[:, None, None, :]
        scale, shift = h_t.chunk(2, dim=-1)
        axis = self.block0.column_axis
        scale, shift = tp.scatter_to_model(axis, scale, -1), tp.scatter_to_model(axis, shift, -1)
        h = self.block0(x, (scale, shift))
        h = self.block1(h)
        return h + (x if self.res_conv is None else self.res_conv(x))


class LinearAttention(nn.Module):
    """Softmax-kernel linear attention, post-normed: q softmax over each
    head's dims, k softmax over tokens, O(N d^2); one fused_linear_attention
    call. `axis` (a model axis): the rank holds slabs of w_qkv and w_out and
    gathers them whole."""

    axis = None

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.w_qkv = nn.Parameter(torch.empty(dim, hidden * 3))
        self.w_out = nn.Parameter(torch.empty(hidden, dim))
        self.b_out = nn.Parameter(torch.zeros(dim))
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x, use_kernels: bool = True):
        fn = fused_linear_attention if use_kernels else fused_linear_attention_plain
        x = x.contiguous()
        w_qkv = tp.gather_from_model(self.axis, self.w_qkv, 1)
        w_out = tp.gather_from_model(self.axis, self.w_out, 0)
        with annotate("unet.linear_attention"):
            return fn(x, w_qkv, w_out, self.b_out, self.g, self.heads, self.dim_head)


class Attention(nn.Module):
    """Full softmax attention over the tokens, per head (mid block). `axis`
    as LinearAttention's. `stacked` folds the heads into the token axis:
    one [heads*N, heads*N] similarity a batch row, its entries across heads
    set to -inf before the softmax, so each row normalizes over its own
    head's tokens: the same math and parameters (the JAX package's
    Attention(stacked=True))."""

    axis = None

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, stacked: bool = False):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.dim_head, self.stacked = heads, dim_head, stacked
        self.w_qkv = nn.Parameter(torch.empty(dim, hidden * 3))
        self.w_out = nn.Parameter(torch.empty(hidden, dim))
        self.b_out = nn.Parameter(torch.zeros(dim))

    @annotate("unet.mid_attention")
    def forward(self, x, use_kernels: bool = True):  # no kernel: the flag is unused
        b, h, w, c = x.shape
        n, hidden = h * w, self.heads * self.dim_head
        w_qkv = tp.gather_from_model(self.axis, self.w_qkv, 1)
        w_out = tp.gather_from_model(self.axis, self.w_out, 0)
        q, k, v = torch.matmul(x.reshape(b, n, c), w_qkv).split(hidden, dim=-1)
        q, k, v = (u.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for u in (q, k, v))
        q = q * (self.dim_head ** -0.5)
        if self.stacked:
            hn = self.heads * n
            q, k, v = (u.reshape(b, hn, self.dim_head) for u in (q, k, v))
            head = torch.arange(hn, device=x.device) // n
            sim = torch.matmul(q, k.transpose(-1, -2)).masked_fill(
                head[:, None] != head[None, :], float("-inf"))
            out = torch.matmul(torch.softmax(sim, dim=-1), v)
            out = out.reshape(b, self.heads, n, self.dim_head)
        else:
            sim = torch.matmul(q, k.transpose(-1, -2))
            out = torch.matmul(torch.softmax(sim, dim=-1), v)
        out = out.transpose(1, 2).reshape(b, n, hidden)
        return (torch.matmul(out, w_out) + self.b_out).reshape(b, h, w, c)


class PreNormResidual(nn.Module):
    """x + fn(ChannelLayerNorm(x))."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = ChannelLayerNorm(dim)
        self.fn = fn

    def forward(self, x, use_kernels: bool = True):
        return x + self.fn(self.norm(x), use_kernels)


class Downsample(nn.Module):
    """Space-to-depth (the flow's squeeze, channel order (c, h2, w2)) and a
    1x1 conv."""

    def __init__(self, dim_in: int, dim_out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(dim_in * 4, dim_out, 1, dtype=dtype)

    def forward(self, x):
        return self.conv(squeeze_forward(x))


class Upsample(nn.Module):
    """Nearest 2x and a 3x3 conv."""

    def __init__(self, dim_in: int, dim_out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(dim_in, dim_out, 3, padding=1, dtype=dtype)

    def forward(self, x):
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return self.conv(x.permute(0, 2, 3, 1))


class Unet(nn.Module):
    """Input and output [B, H, W, C]; `time` is [B] or a length-1 vector
    that broadcasts over the batch (the samplers' batch-uniform t).
    `dtype` is the convolutions' compute dtype (torch_dtype: a torch dtype
    or its name), fp32 by default. `stacked_mid_attn`: the mid attention
    in its stacked form (Attention). `remat`: every ResnetBlock (down, mid,
    up and final) runs under torch.utils.checkpoint where a gradient is
    recorded, its activations recomputed in the backward instead of kept,
    as the JAX package's nn.remat(ResnetBlock); inside the recomputed
    function fsdp gathers the block's weights again and the model axis's
    collectives run again, in the same order on every rank."""

    def __init__(self, dim: int, init_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, dim_mults: Sequence[int] = (1, 2, 4, 8),
                 channels: int = 3, self_condition: bool = False,
                 resnet_block_groups: int = 8, learned_variance: bool = False,
                 learned_sinusoidal_cond: bool = False,
                 random_fourier_features: bool = False,
                 learned_sinusoidal_dim: int = 16, dtype="float32",
                 stacked_mid_attn: bool = False, remat: bool = False):
        super().__init__()
        self.dtype = dt = torch_dtype(dtype)
        self.remat = remat
        self.self_condition = self_condition
        init_dim = init_dim or dim
        self.out_dim = out_dim or channels * (2 if learned_variance else 1)
        groups = resnet_block_groups

        self.init_conv = Conv(channels * (2 if self_condition else 1), init_dim, 7, padding=3,
                              dtype=dt)
        time_dim = dim * 4
        if learned_sinusoidal_cond or random_fourier_features:
            self.time_pos = RandomOrLearnedSinusoidalPosEmb(learned_sinusoidal_dim)
            fourier_dim = learned_sinusoidal_dim + 1
        else:
            self.time_pos = SinusoidalPosEmb(dim)
            fourier_dim = dim
        self.time_dense0 = nn.Linear(fourier_dim, time_dim)
        self.time_dense1 = nn.Linear(time_dim, time_dim)

        dims = [init_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.downs = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(in_out):
            is_last = ind == len(in_out) - 1
            self.downs.append(nn.ModuleDict({
                "res1": ResnetBlock(d_in, d_in, time_dim, groups, dt),
                "res2": ResnetBlock(d_in, d_in, time_dim, groups, dt),
                "attn": PreNormResidual(d_in, LinearAttention(d_in)),
                "down": (Conv(d_in, d_out, 3, padding=1, dtype=dt) if is_last
                         else Downsample(d_in, d_out, dt)),
            }))
        mid_dim = dims[-1]
        self.mid_res1 = ResnetBlock(mid_dim, mid_dim, time_dim, groups, dt)
        self.mid_attn = PreNormResidual(mid_dim, Attention(mid_dim, stacked=stacked_mid_attn))
        self.mid_res2 = ResnetBlock(mid_dim, mid_dim, time_dim, groups, dt)
        self.ups = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(reversed(in_out)):
            is_last = ind == len(in_out) - 1
            self.ups.append(nn.ModuleDict({
                "res1": ResnetBlock(d_out + d_in, d_out, time_dim, groups, dt),
                "res2": ResnetBlock(d_out + d_in, d_out, time_dim, groups, dt),
                "attn": PreNormResidual(d_out, LinearAttention(d_out)),
                "up": (Conv(d_out, d_in, 3, padding=1, dtype=dt) if is_last
                       else Upsample(d_out, d_in, dt)),
            }))
        self.final_res = ResnetBlock(init_dim * 2, dim, time_dim, groups, dt)
        self.final_conv = Conv(dim, self.out_dim, 1)

    fsdp = None  # the data axis's layout of a partitioned UNet (gather_units)

    def gather_units(self, layout) -> None:
        """Gather the parameters `layout` (parallel/zero.Layout, rooted at
        this UNet) partitions on use, unit by unit."""
        units = [n for n, m in self.named_modules()
                 if isinstance(m, (ResnetBlock, PreNormResidual))]
        self.fsdp = layout
        self._rest = [n for n, _ in self.named_parameters()
                      if not any(n.startswith(u + ".") for u in units)]

    def _unit(self, name: str, module: nn.Module, *args):
        def run(*args):
            if self.fsdp is None:
                return module(*args)
            with self.fsdp.swapped(module, name, [n for n, _ in module.named_parameters()]):
                return module(*args)

        if self.remat and isinstance(module, ResnetBlock) and torch.is_grad_enabled():
            return checkpoint(run, *args, use_reentrant=False)
        return run(*args)

    @annotate("unet")
    def forward(self, x, time, x_self_cond=None, use_kernels: bool = True):
        if self.fsdp is None:
            return self._forward(x, time, x_self_cond, use_kernels)
        with self.fsdp.swapped(self, "", self._rest):
            return self._forward(x, time, x_self_cond, use_kernels)

    def _forward(self, x, time, x_self_cond, use_kernels):
        if self.self_condition:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x)
            x = torch.cat([x_self_cond, x], dim=-1)
        x = self.init_conv(x)
        r = x
        t = self.time_dense0(self.time_pos(time))
        t = self.time_dense1(F.gelu(t, approximate="tanh"))

        hs = []
        for i, level in enumerate(self.downs):
            x = self._unit(f"downs.{i}.res1", level["res1"], x, t)
            hs.append(x)
            x = self._unit(f"downs.{i}.res2", level["res2"], x, t)
            x = self._unit(f"downs.{i}.attn", level["attn"], x, use_kernels)
            hs.append(x)
            x = level["down"](x)

        x = self._unit("mid_res1", self.mid_res1, x, t)
        x = self._unit("mid_attn", self.mid_attn, x)
        x = self._unit("mid_res2", self.mid_res2, x, t)

        for i, level in enumerate(self.ups):
            x = self._unit(f"ups.{i}.res1", level["res1"], torch.cat([x, hs.pop()], dim=-1), t)
            x = self._unit(f"ups.{i}.res2", level["res2"], torch.cat([x, hs.pop()], dim=-1), t)
            x = self._unit(f"ups.{i}.attn", level["attn"], x, use_kernels)
            x = level["up"](x)

        x = self._unit("final_res", self.final_res, torch.cat([x, r], dim=-1), t)
        return self.final_conv(x)


@torch.no_grad()
def init_unet_(unet: Unet, seed: int) -> Unet:
    """Seeded init in place, the JAX package's distributions: conv and dense
    weights N(0, 1/fan_in) (lecun normal without the truncation), Fourier
    frequencies N(0, 1), biases zero, norm gains one."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, p in unet.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "b_out"):
            p.zero_()
            continue
        if leaf == "g" or (leaf == "weight" and p.dim() == 1):  # norm gains
            p.fill_(1.0)
            continue
        if leaf in ("w_qkv", "w_out"):  # [in, out]
            std = p.shape[0] ** -0.5
        elif leaf == "weight" and p.dim() == 4:  # OIHW
            std = (p.shape[1] * p.shape[2] * p.shape[3]) ** -0.5
        elif leaf == "weight" and p.dim() == 2:  # nn.Linear [out, in]
            std = p.shape[1] ** -0.5
        else:  # the Fourier frequencies
            std = 1.0
        p.copy_(torch.randn(p.shape, generator=gen) * std)
    return unet


@torch.no_grad()
def shard_unet_(unet: Unet, axis) -> Unet:
    """Narrow a whole UNet, in place, to this rank's slabs on the model
    `axis` (parallel/tensor_parallel.ModelAxis; nothing at one rank) and
    set its blocks to call the axis's collectives, any group count (a
    group split across ranks takes its statistics over the model group,
    GroupNorm). A width that does not divide raises ValueError."""
    from ..parallel.sharding_rules import unet_model_placements

    if not tp.active(axis):
        return unet
    placements = unet_model_placements(unet, axis.n)
    modules = dict(unet.named_modules())
    for name, p in list(unet.named_parameters()):
        if name in placements:
            owner, leaf = name.rsplit(".", 1)
            slab = tp._copy_like(placements[name].slab(p, axis.index))
            setattr(modules[owner], leaf, nn.Parameter(slab, requires_grad=p.requires_grad))
    for name, m in modules.items():
        if isinstance(m, ResnetBlock):
            m.block0.column_axis = axis
            m.block0.norm.axis = axis
            m.block1.conv.row_axis = axis
        elif isinstance(m, (LinearAttention, Attention)) and f"{name}.w_qkv" in placements:
            m.axis = axis
    return unet


def to_device(unet: Unet, device, requires_grad: bool = False) -> Unet:
    """Move to `device`: 4-D conv weights in channels-last memory, the
    parameters autograd leaves only for training."""
    unet = unet.to(device=device).to(memory_format=torch.channels_last)
    return unet.requires_grad_(requires_grad).eval()
