"""Export the port's Glow weights as a checkpoint of the original PyTorch
repository.

Counterpart of nfdpm_tpu/utils/reference_export.py and the inverse of
utils/reference_import.py: the port's parameter trees become the
reference's `Glow.state_dict()` / `GaussianPrior.state_dict()` keys, shapes
and dtypes, which the unmodified reference code loads with
`load_state_dict(strict=True)`.

  * conv weights are OIHW in both; actnorm [C] -> [C, 1, 1]; ZeroConv2d
    logs [C] -> [1, C, 1, 1];
  * the PLU leaves -> the full [C, C, 1, 1] 1x1 weight
    (ops/bijectors.invconv_weight, P @ L @ U' in fp32, on the host);
  * the folded prior (bias, logs) -> ZeroConv2d(weight=0, bias, logs);
  * every ActNorm's `is_initialized` is uint8 1, so that the reference does
    not run its data-dependent init again over trained weights.

The dicts hold numpy arrays; the export command converts them to tensors
when it saves.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..ops.bijectors import invconv_weight


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().numpy().astype(np.float32, copy=False)
    return np.asarray(x, np.float32)


def _actnorm_out(out: Dict[str, np.ndarray], prefix: str, an: Mapping) -> None:
    out[f"{prefix}.scale"] = _f32(an["scale"]).reshape(-1, 1, 1)
    out[f"{prefix}.bias"] = _f32(an["bias"]).reshape(-1, 1, 1)
    out[f"{prefix}.is_initialized"] = np.asarray(1, np.uint8)


def _zeroconv_out(out: Dict[str, np.ndarray], prefix: str, zc: Mapping) -> None:
    out[f"{prefix}.weight"] = np.ascontiguousarray(_f32(zc["w"]))
    out[f"{prefix}.bias"] = _f32(zc["b"]).reshape(-1)
    out[f"{prefix}.logs"] = _f32(zc["logs"]).reshape(1, -1, 1, 1)


def _step_out(out: Dict[str, np.ndarray], prefix: str, step: Mapping) -> None:
    _actnorm_out(out, f"{prefix}.actnorm", step["actnorm"])
    host = {k: torch.from_numpy(_f32(v)) for k, v in step["invconv"].items()}
    out[f"{prefix}.invconv2d.weight"] = invconv_weight(host).numpy()[:, :, None, None]
    net = step["coupling"]["net"]
    base = f"{prefix}.affcoupling.net"
    for idx, conv, an in ((0, "conv1", "an1"), (2, "conv2", "an2")):
        out[f"{base}.{idx}._Conv2dActNorm__conv.weight"] = np.ascontiguousarray(
            _f32(net[conv]["w"]))
        _actnorm_out(out, f"{base}.{idx}._Conv2dActNorm__actnorm", net[an])
    _zeroconv_out(out, f"{base}.4", net["zconv"])


def export_glow_state_dict(params: Mapping, levels: int, steps: int) -> Dict[str, np.ndarray]:
    """The port's flow tree (tensors on any device, or numpy) -> a
    reference Glow.state_dict() of numpy arrays. Raises ValueError for a
    level without a learned split prior: the reference's Split always owns
    a ZeroConv2d."""
    out: Dict[str, np.ndarray] = {}
    for b, block in enumerate(params["blocks"]):
        for k in range(steps):
            _step_out(out, f"blocks.{b}.flows.{k}", block["steps"][k])
        conv = block["split"]["conv"]
        if conv is None:
            raise ValueError(f"level {b} has no learned split prior (learn_prior=False); the "
                             "reference's Split always owns a ZeroConv2d, so it cannot be "
                             "exported")
        _zeroconv_out(out, f"blocks.{b}.split.conv", conv)
    for k in range(steps):
        _step_out(out, f"final_flows.{k}", params["final_steps"][k])
    return out


def export_gaussian_prior_state_dict(prior: Mapping) -> Dict[str, np.ndarray]:
    """The folded (bias, logs) -> the reference GaussianPrior's ZeroConv2d
    state dict, its conv weight all zeros (what the import requires)."""
    bias = _f32(prior["bias"]).reshape(-1)
    c2 = bias.shape[0]
    return {"_GaussianPrior__conv.weight": np.zeros((c2, c2, 3, 3), np.float32),
            "_GaussianPrior__conv.bias": bias,
            "_GaussianPrior__conv.logs": _f32(prior["logs"]).reshape(1, -1, 1, 1)}


def adam_skeleton(flow_sd: Mapping[str, Any], lr: float) -> Dict:
    """A torch.optim.Adam state dict with no moments over the flow's
    trainable parameters (the reference optimizes flow.parameters() only),
    whose parameter group fits, so that the reference's
    `optimizer.load_state_dict` succeeds. Moments are not carried across
    parameterizations, as on import."""
    n_trainable = sum(1 for k in flow_sd if not k.endswith("is_initialized"))
    return {"state": {},
            "param_groups": [{"lr": float(lr), "betas": (0.9, 0.999), "eps": 1e-8,
                              "weight_decay": 0, "amsgrad": False, "maximize": False,
                              "foreach": None, "capturable": False, "differentiable": False,
                              "fused": None, "params": list(range(n_trainable))}]}
