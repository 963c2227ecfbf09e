"""Plain PyTorch Glow: the reference the benchmark holds the flow against.

Written from the model's equations (Kingma and Dhariwal, "Glow", 2018, and
the CIFAR-10 recipe of the reference repository), NHWC, in the dtype the
caller names, with no kernel, no fusion and no cache:

    step     = actnorm -> invertible 1x1 conv (W = P L U) -> affine coupling
    coupling = (x_a, x_b); (log_scale, bias) = net(x_a); s = sigmoid(log_scale + 2)
               y_b = (x_b + bias) s;  ldj += sum log(s + 1e-6)
               inverse: x_b = y_b / (s + 1e-6) - bias
    net      = conv3x3 -> actnorm -> relu -> conv1x1 -> actnorm -> relu -> zeroconv3x3
    zeroconv = (conv(h) + b) exp(3 logs)
    level    = squeeze (channel order (c, h2, w2)) -> K steps -> split, the
               factored half under N(mean, exp(logsd)^2), (mean, logsd) = zeroconv(kept half)
    top      = squeeze -> K steps -> N(mean, exp(logsd)^2), (mean, logsd) = halves
               of bias exp(3 logs)

The parameters are the benchmark's own tree (perfbench/bench/inputs.py):
{"blocks": [{"steps": [...], "split": {"conv": {"w", "b", "logs"}}}],
"final_steps": [...]} with each step {"actnorm": {"scale", "bias"},
"invconv": {"p_mat", "lower", "upper", "log_s", "sign"}, "coupling": {"net":
{"conv1": {"w"}, "an1", "conv2": {"w"}, "an2", "zconv"}}}, convolution
weights OIHW, and the top prior {"bias", "logs"}. Every derived quantity
(W from its factors, its inverse, the prior's moments) is worked out here.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)
COUPLING_EPS = 1e-6


def cast(tree, dtype):
    """The tree with every tensor in `dtype` (a new tree; leaves that are
    already `dtype` are shared)."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast(v, dtype) for v in tree]
    return tree.to(dtype) if isinstance(tree, torch.Tensor) else tree


def conv(x: torch.Tensor, w: torch.Tensor, pad: int) -> torch.Tensor:
    """Stride-1 convolution of NHWC x with OIHW w, zero padding `pad`."""
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=pad).permute(0, 2, 3, 1)


def squeeze(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def unsqueeze(y: torch.Tensor) -> torch.Tensor:
    b, h, w, c = y.shape
    y = y.reshape(b, h, w, c // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(b, 2 * h, 2 * w, c // 4)


def weight(ic) -> torch.Tensor:
    """W = P L U from its factors: L unit lower, U upper with diagonal
    sign exp(log_s)."""
    c = ic["log_s"].shape[0]
    eye = torch.eye(c, dtype=ic["log_s"].dtype, device=ic["log_s"].device)
    lower = eye + torch.tril(ic["lower"], -1)
    upper = torch.triu(ic["upper"], 1) + torch.diag(ic["sign"] * torch.exp(ic["log_s"]))
    return ic["p_mat"] @ lower @ upper


def zeroconv(zc, h: torch.Tensor) -> torch.Tensor:
    return (conv(h, zc["w"], 1) + zc["b"]) * torch.exp(3.0 * zc["logs"])


def coupling_net(net, x_a: torch.Tensor) -> torch.Tensor:
    h = conv(x_a, net["conv1"]["w"], 1)
    h = torch.relu(torch.exp(net["an1"]["scale"]) * (h + net["an1"]["bias"]))
    h = conv(h, net["conv2"]["w"], 0)
    h = torch.relu(torch.exp(net["an2"]["scale"]) * (h + net["an2"]["bias"]))
    return zeroconv(net["zconv"], h)


def halves(t: torch.Tensor):
    c = t.shape[-1] // 2
    return t[..., :c], t[..., c:]


def log_normal(z: torch.Tensor, mean: torch.Tensor, logsd: torch.Tensor) -> torch.Tensor:
    """Per-image log N(z; mean, exp(logsd)^2), summed over the pixels."""
    ll = -0.5 * (LOG_2PI + 2.0 * logsd + (z - mean) ** 2 * torch.exp(-2.0 * logsd))
    return ll.reshape(z.shape[0], -1).sum(dim=1)


def step_forward(sp, x: torch.Tensor, ldj: torch.Tensor):
    h, w = x.shape[1], x.shape[2]
    an, ic = sp["actnorm"], sp["invconv"]
    x = torch.exp(an["scale"]) * (x + an["bias"])
    x = x @ weight(ic).T
    ldj = ldj + h * w * (an["scale"].sum() + ic["log_s"].sum())
    x_a, x_b = halves(x)
    log_scale, bias = halves(coupling_net(sp["coupling"]["net"], x_a))
    s = torch.sigmoid(log_scale + 2.0)
    y_b = (x_b + bias) * s
    ldj = ldj + torch.log(s + COUPLING_EPS).reshape(x.shape[0], -1).sum(dim=1)
    return torch.cat([x_a, y_b], dim=-1), ldj


def step_inverse(sp, y: torch.Tensor) -> torch.Tensor:
    an, ic = sp["actnorm"], sp["invconv"]
    y_a, y_b = halves(y)
    log_scale, bias = halves(coupling_net(sp["coupling"]["net"], y_a))
    s = torch.sigmoid(log_scale + 2.0)
    x = torch.cat([y_a, y_b / (s + COUPLING_EPS) - bias], dim=-1)
    x = x @ torch.linalg.inv(weight(ic)).T
    return x * torch.exp(-an["scale"]) - an["bias"]


def top_moments(prior, channels: int):
    h = prior["bias"] * torch.exp(3.0 * prior["logs"])
    return h[:channels], h[channels:]


def forward(params, x: torch.Tensor):
    """x: dequantized images [B, H, W, C] in [-0.5, 0.5) -> the
    log-likelihood [B] in nats of the continuous density (change of
    variables plus every prior)."""
    b = x.shape[0]
    ldj = torch.zeros(b, dtype=x.dtype, device=x.device)
    logp = torch.zeros(b, dtype=x.dtype, device=x.device)
    y = x
    for block in params["blocks"]:
        y = squeeze(y)
        for sp in block["steps"]:
            y, ldj = step_forward(sp, y, ldj)
        y, z = halves(y)
        mean, logsd = halves(zeroconv(block["split"]["conv"], y))
        logp = logp + log_normal(z, mean, logsd)
    y = squeeze(y)
    for sp in params["final_steps"]:
        y, ldj = step_forward(sp, y, ldj)
    mean, logsd = top_moments(params["prior"], y.shape[-1])
    return ldj + logp + log_normal(y, mean, logsd)


def sample_latents(params, top_eps: torch.Tensor, temperature: float) -> torch.Tensor:
    """The top latent drawn from its prior at `temperature` (its standard
    deviation scaled by it) from the standard-normal `top_eps` [B, h, w, c]."""
    mean, logsd = top_moments(params["prior"], top_eps.shape[-1])
    return mean + torch.exp(logsd) * temperature * top_eps


def inverse(params, latents: Sequence[Optional[torch.Tensor]],
            eps: Sequence[Optional[torch.Tensor]] = (), temperature: float = 1.0) -> torch.Tensor:
    """Latent parts [z_1 .. z_{L-1}, z_top] -> images in [-0.5, 0.5) before
    quantization. A missing level part (None) is drawn from its split prior
    at `temperature` from the standard-normal eps[i]."""
    y = latents[-1]
    for sp in reversed(params["final_steps"]):
        y = step_inverse(sp, y)
    y = unsqueeze(y)
    n = len(params["blocks"])
    for i in reversed(range(n)):
        block = params["blocks"][i]
        z = latents[i]
        if z is None:
            mean, logsd = halves(zeroconv(block["split"]["conv"], y))
            z = mean + torch.exp(logsd) * temperature * eps[i]
        y = torch.cat([y, z], dim=-1)
        for sp in reversed(block["steps"]):
            y = step_inverse(sp, y)
        y = unsqueeze(y)
    return y


def preprocess(images01: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Images in [0, 1] -> centred n-bit codes in [-0.5, 0.5)."""
    x = torch.floor(images01 * 255.0 / 2.0 ** (8 - n_bits))
    return x / 2.0 ** n_bits - 0.5


def bits_per_dim(ll: torch.Tensor, n_bits: int, n_dims: int) -> torch.Tensor:
    """Batch mean of -(ll - n_dims log(2^n_bits)) / (n_dims log 2)."""
    n_bins = 2.0 ** n_bits
    return ((math.log(n_bins) * n_dims - ll) / (n_dims * math.log(2.0))).mean()


def bin_gap_levels(x_ref: torch.Tensor, served: torch.Tensor, n_bits: int) -> torch.Tensor:
    """How far, in quantization levels, each reference value x_ref in
    [-0.5, 0.5) scale lies outside the bin of the served uint8 pixel (the
    bin of level k = served // 2^(8 - n_bits) is [k, k + 1) / 2^n_bits -
    0.5; the lowest and highest levels also hold everything beyond them,
    as the clamp does). 0 where x_ref lies in the served bin."""
    n_bins = 2 ** n_bits
    level = (served.to(torch.int64) // (256 // n_bins)).to(x_ref.dtype)
    v = (x_ref + 0.5) * n_bins  # the reference in level units
    below = torch.where(level > 0, level - v, torch.zeros_like(v))
    above = torch.where(level < n_bins - 1, v - (level + 1), torch.zeros_like(v))
    return torch.clamp(torch.maximum(below, above), min=0.0)


def latent_shapes(levels: int, size: int, channels: int) -> List[tuple]:
    """(H, W, C) of each latent part."""
    shapes, c, s = [], channels, size
    for _ in range(levels - 1):
        c, s = c * 2, s // 2
        shapes.append((s, s, c))
    shapes.append((s // 2, s // 2, 4 * c))
    return shapes
