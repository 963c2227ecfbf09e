"""Import the original PyTorch repository's UNet weights into the port's Unet.

Counterpart of nfdpm_tpu/utils/unet_import.py. The reference's UNet (the
lucidrains-style Unet of its diffusion_prior/gaussian_diffusion.py) names
its parameters by module path; this module maps them first onto the flax
tree of the JAX package's Unet, by the same table as the JAX importer:

    init_conv                     -> Conv_0
    time_mlp.0.weights            -> RandomOrLearnedSinusoidalPosEmb_0 (optional)
    time_mlp.1 / time_mlp.3       -> Dense_0 / Dense_1
    downs.{i}.0 / .1              -> down_{i}_res1 / down_{i}_res2
    downs.{i}.2 (Residual(PreNorm(LinearAttention)))
        .fn.norm.g                -> PreNormResidual_{i}/ChannelLayerNorm_0/g
        .fn.fn.to_qkv / to_out.0  -> LinearAttention_{i}/Conv_0 / Conv_1
        .fn.fn.to_out.1.g         -> LinearAttention_{i}/ChannelLayerNorm_0/g
    downs.{i}.3.1 (Downsample)    -> Downsample_{i}/Conv_0 (last level: a
                                     plain conv downs.{i}.3 -> Conv_1)
    mid_block1 / mid_block2       -> mid_res1 / mid_res2
    mid_attn                      -> PreNormResidual_{D} + Attention_0 (to_out
                                     a plain conv)
    ups.{i}.*                     -> up_{i}_* (PreNormResidual_{D+1+i},
                                     LinearAttention_{D+i}, Upsample_{i}; last
                                     level: a plain conv -> Conv_2)
    final_res_block / final_conv  -> final_res / Conv_3

with ResnetBlock's mlp.1 -> Dense_0, block{1,2}.proj ->
Block_{0,1}/WeightStandardizedConv_0, block{1,2}.norm -> Block_{0,1}/GroupNorm_0
and res_conv -> Conv_0; then onto the port Unet's own parameter names and
layouts through convert.unet_layout (the bridge the JAX package's trees
take), so that the result is what convert.unet_from_flax makes of the JAX
importer's tree. The reference's space-to-depth Downsample orders its
channels (c, p1, p2) as the port does.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .. import convert


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x, np.float32)


class _Reader:
    """The state dict, and the keys read from it."""

    def __init__(self, sd: Mapping):
        self.sd, self.used = sd, set()

    def __contains__(self, key):
        return key in self.sd

    def __getitem__(self, key) -> np.ndarray:
        self.used.add(key)
        return _t(self.sd[key])


def _conv(sd: _Reader, prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _dense(sd: _Reader, prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}


def _resblock(sd: _Reader, prefix: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {"Dense_0": _dense(sd, f"{prefix}.mlp.1")}
    for j in (0, 1):
        out[f"Block_{j}"] = {
            "WeightStandardizedConv_0": _conv(sd, f"{prefix}.block{j + 1}.proj"),
            "GroupNorm_0": {"scale": sd[f"{prefix}.block{j + 1}.norm.weight"],
                            "bias": sd[f"{prefix}.block{j + 1}.norm.bias"]}}
    if f"{prefix}.res_conv.weight" in sd:
        out["Conv_0"] = _conv(sd, f"{prefix}.res_conv")
    return out


def _attention(sd: _Reader, prefix: str, linear: bool) -> Dict[str, Any]:
    out: Dict[str, Any] = {"Conv_0": {"kernel": _conv(sd, f"{prefix}.to_qkv")["kernel"]}}
    if linear:  # to_out = Sequential(Conv, LayerNorm)
        out["Conv_1"] = _conv(sd, f"{prefix}.to_out.0")
        out["ChannelLayerNorm_0"] = {"g": sd[f"{prefix}.to_out.1.g"].reshape(-1)}
    else:  # the full attention's to_out is a plain conv
        out["Conv_1"] = _conv(sd, f"{prefix}.to_out")
    return out


def _flax_tree(sd: _Reader, n_levels: int) -> Dict[str, Any]:
    """The reference names -> the JAX package's flax Unet tree (the table of
    the module docstring)."""
    p: Dict[str, Any] = {"Conv_0": _conv(sd, "init_conv")}
    if "time_mlp.0.weights" in sd:
        p["RandomOrLearnedSinusoidalPosEmb_0"] = {"weights": sd["time_mlp.0.weights"]}
    p["Dense_0"] = _dense(sd, "time_mlp.1")
    p["Dense_1"] = _dense(sd, "time_mlp.3")
    extra_conv = iter(range(1, 4))  # the Unet's own convs after the init conv
    for side, sampler, mid in (("down", "Downsample", False), ("up", "Upsample", True)):
        if mid:
            p["mid_res1"] = _resblock(sd, "mid_block1")
            p[f"PreNormResidual_{n_levels}"] = {
                "ChannelLayerNorm_0": {"g": sd["mid_attn.fn.norm.g"].reshape(-1)}}
            p["Attention_0"] = _attention(sd, "mid_attn.fn.fn", linear=False)
            p["mid_res2"] = _resblock(sd, "mid_block2")
        for i in range(n_levels):
            ref = f"{side}s.{i}"
            p[f"{side}_{i}_res1"] = _resblock(sd, f"{ref}.0")
            p[f"{side}_{i}_res2"] = _resblock(sd, f"{ref}.1")
            k = n_levels + 1 + i if mid else i
            p[f"PreNormResidual_{k}"] = {
                "ChannelLayerNorm_0": {"g": sd[f"{ref}.2.fn.norm.g"].reshape(-1)}}
            p[f"LinearAttention_{n_levels + i if mid else i}"] = _attention(
                sd, f"{ref}.2.fn.fn", linear=True)
            if f"{ref}.3.1.weight" in sd:
                p[f"{sampler}_{i}"] = {"Conv_0": _conv(sd, f"{ref}.3.1")}
            else:  # the last level: a plain conv
                p[f"Conv_{next(extra_conv)}"] = _conv(sd, f"{ref}.3")
    p["final_res"] = _resblock(sd, "final_res_block")
    p[f"Conv_{next(extra_conv)}"] = _conv(sd, "final_conv")
    return p


def import_unet_state_dict(sd: Mapping, n_levels: int) -> Dict[str, torch.Tensor]:
    """A reference Unet.state_dict() (tensors or numpy) of `n_levels` =
    len(dim_mults) levels -> a state dict under the port Unet's own
    parameter names (models/unet.py), which `Unet.load_state_dict(...,
    strict=True)` takes: to_qkv [3h, C, 1, 1] becomes w_qkv [C, 3h],
    to_out [C, h, 1, 1] w_out [h, C], the norms' g [1, C, 1, 1] [C]. Raises
    KeyError when a key the structure needs is missing, or when a key of
    `sd` has no place in the port's Unet."""
    reader = _Reader(sd)
    tree = _flax_tree(reader, n_levels)
    unused = sorted(set(sd) - reader.used)
    if unused:
        raise KeyError(f"reference UNet keys with no place in the port's Unet: {unused}")
    flat: Dict[str, np.ndarray] = {}
    convert._flatten(tree, "", flat)
    layout = convert.unet_layout(
        n_levels, {k for k, v in tree.items() if "Block_0" in v and "Conv_0" in v},
        "RandomOrLearnedSinusoidalPosEmb_0" in tree)
    return {name: torch.from_numpy(np.ascontiguousarray(
                convert._leaf_from_flax(flat[path], kind), np.float32))
            for path, (name, kind) in layout.items()}
