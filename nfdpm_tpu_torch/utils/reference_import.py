"""Import the original PyTorch repository's Glow checkpoints into the port.

Counterpart of nfdpm_tpu/utils/reference_import.py. The reference saves a
`Glow.state_dict()` and a `GaussianPrior.state_dict()` (its
normalizing_flow/transforms.py and prior.py); this module maps them straight
into the port's parameter trees (nfdpm_tpu_torch/convert.py):

  * conv weights stay OIHW, as in the reference;
  * each level's K steps stay a list of K step dicts (not stacked);
  * actnorm [C, 1, 1] -> [C]; ZeroConv2d logs [1, C, 1, 1] -> [C];
  * invconv2d.weight [C, C, 1, 1] -> the PLU leaves of
    ops/bijectors.plu_from_weight (scipy's LU in float64 of the float32
    weight, so both packages give the same factors), or the whole [C, C]
    matrix under invconv_param="full";
  * the GaussianPrior's ZeroConv2d (bias, logs) -> the folded per-channel
    (bias, logs) of models/prior.py, exact because the reference conv runs
    on a zeros input; a nonzero conv weight is refused.

Values may be tensors or numpy arrays; the trees hold float32 numpy arrays
(convert.tree_to_device places them).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from ..ops.bijectors import plu_from_weight


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x, np.float32)


def _actnorm(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _t(sd[f"{prefix}.scale"]).reshape(-1),
            "bias": _t(sd[f"{prefix}.bias"]).reshape(-1)}


def _zeroconv(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"w": _t(sd[f"{prefix}.weight"]),
            "b": _t(sd[f"{prefix}.bias"]).reshape(-1),
            "logs": _t(sd[f"{prefix}.logs"]).reshape(-1)}


def _coupling_net(sd: Mapping, prefix: str) -> Dict[str, Any]:
    """nn.Sequential(Conv2dActNorm, ReLU, Conv2dActNorm, ReLU, ZeroConv2d),
    whose private attributes are name-mangled (_Conv2dActNorm__conv)."""
    def conv_actnorm(idx):
        return ({"w": _t(sd[f"{prefix}.{idx}._Conv2dActNorm__conv.weight"])},
                _actnorm(sd, f"{prefix}.{idx}._Conv2dActNorm__actnorm"))

    conv1, an1 = conv_actnorm(0)
    conv2, an2 = conv_actnorm(2)
    return {"conv1": conv1, "an1": an1, "conv2": conv2, "an2": an2,
            "zconv": _zeroconv(sd, f"{prefix}.4")}


def _step(sd: Mapping, prefix: str, invconv_param: str) -> Dict[str, Any]:
    w = _t(sd[f"{prefix}.invconv2d.weight"])[:, :, 0, 0]
    return {"actnorm": _actnorm(sd, f"{prefix}.actnorm"),
            "invconv": {"weight": w} if invconv_param == "full" else plu_from_weight(w),
            "coupling": {"net": _coupling_net(sd, f"{prefix}.affcoupling.net")}}


def import_glow_state_dict(sd: Mapping, levels: int, steps: int,
                           invconv_param: str = "plu") -> Dict[str, Any]:
    """A reference Glow.state_dict() -> the port's flow tree {"blocks":
    [{"steps": [K steps], "split": {"conv": zeroconv or None}}, ...],
    "final_steps": [K steps]}. `invconv_param="full"` keeps the [C, C] 1x1
    weight whole (GlowConfig.invconv_param="full"), the parameterization in
    which Adam follows the reference's trajectory; "plu" (the default)
    decomposes it."""
    if invconv_param not in ("plu", "full"):
        raise ValueError(f"invconv_param must be 'plu' or 'full', not {invconv_param!r}")
    blocks = []
    for b in range(levels - 1):
        split = f"blocks.{b}.split.conv"
        blocks.append({
            "steps": [_step(sd, f"blocks.{b}.flows.{k}", invconv_param) for k in range(steps)],
            "split": {"conv": _zeroconv(sd, split) if f"{split}.weight" in sd else None}})
    return {"blocks": blocks,
            "final_steps": [_step(sd, f"final_flows.{k}", invconv_param) for k in range(steps)]}


def import_gaussian_prior_state_dict(sd: Mapping) -> Dict[str, np.ndarray]:
    """A reference GaussianPrior.state_dict() -> the folded {"bias", "logs"}.
    Raises ValueError when the conv weight is not zero: the fold would then
    change the model."""
    for key in (k for k in sd if k.endswith("conv.weight")):
        if np.abs(_t(sd[key])).max() >= 1e-12:
            raise ValueError(f"the reference GaussianPrior's conv weight {key} is nonzero; "
                             "the folded (bias, logs) prior cannot represent it")
    bias = next(k for k in sd if k.endswith("conv.bias"))
    logs = next(k for k in sd if k.endswith("conv.logs"))
    return {"bias": _t(sd[bias]).reshape(-1), "logs": _t(sd[logs]).reshape(-1)}
