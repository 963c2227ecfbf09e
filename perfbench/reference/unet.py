"""Plain PyTorch DDPM UNet: the reference the benchmark holds the prior's
denoisers against.

The architecture of the reference repository's UNet (lucidrains'
denoising-diffusion-pytorch, as vendored there), NHWC, written out as
functions of a dict of parameters by name:

    init conv 7x7 -> time embedding (sinusoidal(dim) -> dense 4 dim -> gelu
    (tanh) -> dense 4 dim) -> per level: resnet, resnet, x + linear
    attention(layernorm x), downsample (space-to-depth + 1x1, or a 3x3 on the
    last level) -> mid: resnet, x + full attention(layernorm x), resnet -> per
    level upward: resnet and resnet on [x, skip], x + linear attention(...),
    upsample (nearest 2x + 3x3, or a 3x3 on the last level) -> resnet on
    [x, init conv output] -> 1x1 conv.
    resnet(x, t) = block1(block0(x, film(t))) + (1x1 conv x if the width changes)
    block       = weight-standardized 3x3 conv -> group norm -> FiLM -> SiLU
    linear attn = softmax over each head's dims of q (times dim_head^-1/2),
                  softmax over the tokens of k, context k^T (v / N), q context,
                  out-projection + bias, then a channel layernorm times g
    full attn   = softmax(q k^T / sqrt(dim_head)) v, out-projection + bias

`param_shapes(dim, dim_mults, channels)` names every parameter and its
shape in the order the benchmark draws them (perfbench/bench/inputs.py).
Heads 4, dim_head 32, GroupNorm and layernorm epsilon 1e-5.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5
HEADS, DIM_HEAD = 4, 32


def _levels(dim: int, dim_mults: Sequence[int]) -> List[Tuple[int, int]]:
    dims = [dim] + [dim * m for m in dim_mults]
    return list(zip(dims[:-1], dims[1:]))


def _resnet_shapes(prefix: str, d_in: int, d_out: int, time_dim: int) -> Dict[str, tuple]:
    out = {f"{prefix}.time_dense.weight": (2 * d_out, time_dim),
           f"{prefix}.time_dense.bias": (2 * d_out,)}
    for blk, cin in (("block0", d_in), ("block1", d_out)):
        out[f"{prefix}.{blk}.conv.weight"] = (d_out, cin, 3, 3)
        out[f"{prefix}.{blk}.conv.bias"] = (d_out,)
        out[f"{prefix}.{blk}.norm.weight"] = (d_out,)
        out[f"{prefix}.{blk}.norm.bias"] = (d_out,)
    if d_in != d_out:
        out[f"{prefix}.res_conv.weight"] = (d_out, d_in, 1, 1)
        out[f"{prefix}.res_conv.bias"] = (d_out,)
    return out


def _attn_shapes(prefix: str, d: int, linear: bool) -> Dict[str, tuple]:
    hidden = HEADS * DIM_HEAD
    out = {f"{prefix}.norm.g": (d,), f"{prefix}.fn.w_qkv": (d, 3 * hidden),
           f"{prefix}.fn.w_out": (hidden, d), f"{prefix}.fn.b_out": (d,)}
    if linear:
        out[f"{prefix}.fn.g"] = (d,)
    return out


def param_shapes(dim: int, dim_mults: Sequence[int], channels: int) -> Dict[str, tuple]:
    """Every parameter of the UNet by name, with its shape: conv weights
    OIHW, dense weights [out, in], attention matrices [in, out]."""
    time_dim = 4 * dim
    p: Dict[str, tuple] = {"init_conv.weight": (dim, channels, 7, 7),
                           "init_conv.bias": (dim,),
                           "time_dense0.weight": (time_dim, dim),
                           "time_dense0.bias": (time_dim,),
                           "time_dense1.weight": (time_dim, time_dim),
                           "time_dense1.bias": (time_dim,)}
    levels = _levels(dim, dim_mults)
    for i, (d_in, d_out) in enumerate(levels):
        last = i == len(levels) - 1
        p.update(_resnet_shapes(f"downs.{i}.res1", d_in, d_in, time_dim))
        p.update(_resnet_shapes(f"downs.{i}.res2", d_in, d_in, time_dim))
        p.update(_attn_shapes(f"downs.{i}.attn", d_in, True))
        if last:
            p[f"downs.{i}.down.weight"] = (d_out, d_in, 3, 3)
            p[f"downs.{i}.down.bias"] = (d_out,)
        else:
            p[f"downs.{i}.down.conv.weight"] = (d_out, 4 * d_in, 1, 1)
            p[f"downs.{i}.down.conv.bias"] = (d_out,)
    mid = levels[-1][1]
    p.update(_resnet_shapes("mid_res1", mid, mid, time_dim))
    p.update(_attn_shapes("mid_attn", mid, False))
    p.update(_resnet_shapes("mid_res2", mid, mid, time_dim))
    for i, (d_in, d_out) in enumerate(reversed(levels)):
        last = i == len(levels) - 1
        p.update(_resnet_shapes(f"ups.{i}.res1", d_out + d_in, d_out, time_dim))
        p.update(_resnet_shapes(f"ups.{i}.res2", d_out + d_in, d_out, time_dim))
        p.update(_attn_shapes(f"ups.{i}.attn", d_out, True))
        if last:
            p[f"ups.{i}.up.weight"] = (d_in, d_out, 3, 3)
            p[f"ups.{i}.up.bias"] = (d_in,)
        else:
            p[f"ups.{i}.up.conv.weight"] = (d_in, d_out, 3, 3)
            p[f"ups.{i}.up.conv.bias"] = (d_in,)
    p.update(_resnet_shapes("final_res", 2 * dim, dim, time_dim))
    p["final_conv.weight"] = (channels, dim, 1, 1)
    p["final_conv.bias"] = (channels,)
    return p


def conv(x, w, b, pad: int):
    return F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=pad).permute(0, 2, 3, 1)


def ws_conv(x, w, b):
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    var = ((w - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    return conv(x, (w - mean) / torch.sqrt(var + EPS), b, 1)


def group_norm(x, groups: int, weight, bias):
    b, h, w, c = x.shape
    g = x.reshape(b, h * w, groups, c // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    g = (g - mean) / torch.sqrt(var + EPS)
    return g.reshape(b, h, w, c) * weight + bias


def layer_norm(x, g):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS) * g


def resnet(P, prefix: str, x, t, groups: int):
    film = F.linear(F.silu(t), P[f"{prefix}.time_dense.weight"], P[f"{prefix}.time_dense.bias"])
    scale, shift = film[:, None, None, :].chunk(2, dim=-1)
    h = ws_conv(x, P[f"{prefix}.block0.conv.weight"], P[f"{prefix}.block0.conv.bias"])
    h = group_norm(h, groups, P[f"{prefix}.block0.norm.weight"], P[f"{prefix}.block0.norm.bias"])
    h = F.silu(h * (scale + 1.0) + shift)
    h = ws_conv(h, P[f"{prefix}.block1.conv.weight"], P[f"{prefix}.block1.conv.bias"])
    h = group_norm(h, groups, P[f"{prefix}.block1.norm.weight"], P[f"{prefix}.block1.norm.bias"])
    h = F.silu(h)
    res = (conv(x, P[f"{prefix}.res_conv.weight"], P[f"{prefix}.res_conv.bias"], 0)
           if f"{prefix}.res_conv.weight" in P else x)
    return h + res


def linear_attention(P, prefix: str, x):
    b, hh, ww, c = x.shape
    n, hidden = hh * ww, HEADS * DIM_HEAD
    y = layer_norm(x, P[f"{prefix}.norm.g"]).reshape(b, n, c)
    q, k, v = (y @ P[f"{prefix}.fn.w_qkv"]).split(hidden, dim=-1)
    q = torch.softmax(q.reshape(b, n, HEADS, DIM_HEAD), dim=-1) * DIM_HEAD ** -0.5
    k = torch.softmax(k.reshape(b, n, HEADS, DIM_HEAD), dim=1)
    v = v.reshape(b, n, HEADS, DIM_HEAD) / n
    context = torch.einsum("bnhd,bnhe->bhde", k, v)
    out = torch.einsum("bnhd,bhde->bnhe", q, context).reshape(b, n, hidden)
    out = out @ P[f"{prefix}.fn.w_out"] + P[f"{prefix}.fn.b_out"]
    return x + layer_norm(out, P[f"{prefix}.fn.g"]).reshape(b, hh, ww, c)


def full_attention(P, prefix: str, x):
    b, hh, ww, c = x.shape
    n, hidden = hh * ww, HEADS * DIM_HEAD
    y = layer_norm(x, P[f"{prefix}.norm.g"]).reshape(b, n, c)
    q, k, v = ((u.reshape(b, n, HEADS, DIM_HEAD).transpose(1, 2))
               for u in (y @ P[f"{prefix}.fn.w_qkv"]).split(hidden, dim=-1))
    sim = (q * DIM_HEAD ** -0.5) @ k.transpose(-1, -2)
    out = (torch.softmax(sim, dim=-1) @ v).transpose(1, 2).reshape(b, n, hidden)
    out = out @ P[f"{prefix}.fn.w_out"] + P[f"{prefix}.fn.b_out"]
    return x + out.reshape(b, hh, ww, c)


def time_embedding(P, t: torch.Tensor, dim: int, dtype, gelu: str):
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=dtype, device=t.device)
                     * -(math.log(10000.0) / (half - 1)))
    emb = t.to(dtype)[:, None] * freq[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    emb = F.linear(emb, P["time_dense0.weight"], P["time_dense0.bias"])
    return F.linear(F.gelu(emb, approximate=gelu), P["time_dense1.weight"],
                    P["time_dense1.bias"])


def unet(P, x, t: torch.Tensor, dim: int, dim_mults: Sequence[int], groups: int, gelu: str):
    """x [B, H, W, C], t [B] or [1] time steps -> the predicted noise. `gelu`
    is the time MLP's GELU as the configuration states it (its
    time_mlp_gelu): "tanh" for the tanh approximation, "none" for the exact
    one."""
    x = conv(x, P["init_conv.weight"], P["init_conv.bias"], 3)
    r = x
    temb = time_embedding(P, t, dim, x.dtype, gelu)
    skips = []
    levels = _levels(dim, dim_mults)
    for i in range(len(levels)):
        x = resnet(P, f"downs.{i}.res1", x, temb, groups)
        skips.append(x)
        x = resnet(P, f"downs.{i}.res2", x, temb, groups)
        x = linear_attention(P, f"downs.{i}.attn", x)
        skips.append(x)
        if i == len(levels) - 1:
            x = conv(x, P[f"downs.{i}.down.weight"], P[f"downs.{i}.down.bias"], 1)
        else:
            b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
            x = conv(x.reshape(b, h // 2, w // 2, 4 * c), P[f"downs.{i}.down.conv.weight"],
                     P[f"downs.{i}.down.conv.bias"], 0)
    x = resnet(P, "mid_res1", x, temb, groups)
    x = full_attention(P, "mid_attn", x)
    x = resnet(P, "mid_res2", x, temb, groups)
    for i in range(len(levels)):
        x = resnet(P, f"ups.{i}.res1", torch.cat([x, skips.pop()], dim=-1), temb, groups)
        x = resnet(P, f"ups.{i}.res2", torch.cat([x, skips.pop()], dim=-1), temb, groups)
        x = linear_attention(P, f"ups.{i}.attn", x)
        if i == len(levels) - 1:
            x = conv(x, P[f"ups.{i}.up.weight"], P[f"ups.{i}.up.bias"], 1)
        else:
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            x = conv(x, P[f"ups.{i}.up.conv.weight"], P[f"ups.{i}.up.conv.bias"], 1)
    x = resnet(P, "final_res", torch.cat([x, r], dim=-1), temb, groups)
    return conv(x, P["final_conv.weight"], P["final_conv.bias"], 0)
