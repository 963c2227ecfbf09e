"""CLIP ViT-B/32 image features (clean-fid's "clip_vit_b_32"), plain PyTorch.

Counterpart of nfdpm_tpu/metrics/clip_features.py: OpenAI CLIP's visual
transformer (patch 32, width 768, 12 layers, 12 heads, 512-d projection,
pre-LN blocks, quick-GELU). uint8-range images [B, 224, 224, 3] are
normalised by CLIP_MEAN / CLIP_STD; the output is the unit-norm 512-d
embedding.

Parameter names are those of OpenAI's `CLIP.visual`, so the `visual.*` half
of `ViT-B-32.pt` (a TorchScript archive or a plain state dict) loads straight
in through `load_weights`. Without that file, `random_init` gives a seeded
random tower.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from .. import disable_tf32

WEIGHTS_FILE = "ViT-B-32.pt"
FEATURE_DIM = 512
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class Attention(nn.Module):
    """Multi-head self-attention with nn.MultiheadAttention's parameter
    names (in_proj_weight [3C, C], in_proj_bias, out_proj), on [B, N, C]."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        b, n, c = x.shape
        dh = c // self.heads
        qkv = x @ self.in_proj_weight.t() + self.in_proj_bias
        q, k, v = (t.reshape(b, n, self.heads, dh).transpose(1, 2) for t in qkv.chunk(3, -1))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.attn = Attention(width, heads)
        self.ln_1 = nn.LayerNorm(width)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, width * 4))
        self.mlp.add_module("gelu", QuickGELU())
        self.mlp.add_module("c_proj", nn.Linear(width * 4, width))
        self.ln_2 = nn.LayerNorm(width)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.Sequential(
            *[ResidualAttentionBlock(width, heads) for _ in range(layers)])

    def forward(self, x):
        return self.resblocks(x)


class VisionTransformer(nn.Module):
    """x [B, 3, S, S], CLIP-normalised -> [B, out_dim] (not yet unit-norm)."""

    def __init__(self, patch: int = 32, width: int = 768, layers: int = 12, heads: int = 12,
                 out_dim: int = 512, image_size: int = 224):
        super().__init__()
        self.width = width
        self.conv1 = nn.Conv2d(3, width, kernel_size=patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(
            torch.zeros((image_size // patch) ** 2 + 1, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = Transformer(width, layers, heads)
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(torch.zeros(width, out_dim))

    def forward(self, x):
        x = self.conv1(x)
        b = x.shape[0]
        x = x.reshape(b, self.width, -1).permute(0, 2, 1)  # [B, grid, width]
        x = torch.cat([self.class_embedding.expand(b, 1, self.width), x], dim=1)
        x = self.ln_pre(x + self.positional_embedding)
        x = self.transformer(x)
        return self.ln_post(x[:, 0, :]) @ self.proj


def random_init(seed: int = 0, **arch) -> VisionTransformer:
    """A seeded random tower in eval mode: every weight [out, in, ...]
    N(0, 1 / fan_in), the embeddings and the projection N(0, 1 / width)
    (OpenAI's scale), biases zero and LayerNorms at the identity."""
    model = VisionTransformer(**arch).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "ln_" in name:
                continue
            if name in ("class_embedding", "positional_embedding", "proj"):
                std = model.width ** -0.5
            else:
                std = p[0].numel() ** -0.5
            p.normal_(0.0, std, generator=gen)
    return model


def load_weights(path: str, **arch) -> VisionTransformer:
    """The tower with the `visual.*` weights of an OpenAI CLIP checkpoint
    (a TorchScript archive or a plain state dict; the text tower's keys are
    dropped), loaded strictly."""
    try:
        obj = torch.jit.load(path, map_location="cpu")
    except RuntimeError:  # not a TorchScript archive
        obj = torch.load(path, map_location="cpu")
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    visual = {k[len("visual."):]: v.float() for k, v in sd.items() if k.startswith("visual.")}
    model = VisionTransformer(**arch).eval()
    model.load_state_dict(visual, strict=True)
    return model


def make_feature_fn(model: VisionTransformer, device=None):
    """fn(x): float [B, 224, 224, 3] in [0, 255] (NHWC) -> unit-norm
    [B, 512] on `device`."""
    disable_tf32()
    model = model.to(device).eval()
    mean = torch.from_numpy(CLIP_MEAN).to(device)
    std = torch.from_numpy(CLIP_STD).to(device)

    @torch.inference_mode()
    def features(x: torch.Tensor) -> torch.Tensor:
        x = (x.to(device).float() / 255.0 - mean) / std
        f = model(x.permute(0, 3, 1, 2))
        return f / f.norm(dim=-1, keepdim=True)

    features.model = model
    return features
