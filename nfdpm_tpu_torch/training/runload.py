"""Rebuild a trained model from its run directory alone.

Counterpart of nfdpm_tpu/training/runload.py for the port's run
directories: every run persists its architecture (`architecture.json` from
the flow trainer, `diffusion_architecture.json` from the stage-2 entry
point) beside `checkpoints/model_{prefix}_{epoch:03d}.pt`, so the server,
the generation and interpolation commands and the stage-2 entry point
rebuild the exact model with no config. Runs whose architecture file
predates a field fall back to their `config.yaml` (which needs PyYAML).

A run directory of the JAX package holds orbax checkpoints, which the port
does not read: `tools/jax_run_to_torch.py` converts one into a run
directory of the port, and every function here refuses an orbax
checkpoint with a message that says so.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

from .. import resolve_device
from ..models import glow as glow_m
from .checkpoint import latest_epoch, load_architecture, orbax_epochs, restore_params

ORBAX_HINT = ("holds an orbax checkpoint of the JAX package, which the port does not "
              "read; convert the run directory first with python "
              "tools/jax_run_to_torch.py --run-dir <jax run dir> --out <new run dir>")


def resolve_run_dir(name: str) -> str:
    """A run directory's path, or its name under ./outputs."""
    for cand in (name, os.path.join("outputs", name)):
        if os.path.isdir(os.path.join(cand, "checkpoints")):
            return cand
    raise FileNotFoundError(f"no run dir with checkpoints/ at '{name}' or 'outputs/{name}'")


def _refuse_orbax(run_dir: str, prefix: str, epoch: Optional[int] = None) -> None:
    """Raise when the checkpoint wanted (`epoch`, or the newest) is an orbax
    directory: never fall back to an older checkpoint of the port's."""
    orbax = orbax_epochs(run_dir, prefix)
    newest = latest_epoch(run_dir, prefix)
    if (epoch in orbax if epoch is not None
            else orbax and (newest is None or max(orbax) > newest)):
        raise NotImplementedError(f"{run_dir} {ORBAX_HINT}")


def detect_kind(run_dir: str) -> tuple:
    """("diffusion" or "gaussian", the newest epoch): diffusion wins when a
    directory holds both."""
    for prefix in ("diffusion", "gaussian"):
        _refuse_orbax(run_dir, prefix)
        epoch = latest_epoch(run_dir, prefix)
        if epoch is not None:
            return prefix, epoch
    raise FileNotFoundError(
        f"no model_gaussian_*.pt or model_diffusion_*.pt checkpoints in {run_dir}/checkpoints")


@dataclasses.dataclass(frozen=True)
class GlowRun:
    gcfg: glow_m.GlowConfig
    tcfg: Any                    # NFTrainConfig
    params: Dict[str, Any]       # {"flow", "prior"} on the device
    img_size: int
    temperature: float
    epoch: int


@dataclasses.dataclass(frozen=True)
class DiffusionRun:
    backbone: Any                # NFBackbone
    dp: Any                      # DiffusionPrior
    tcfg: Any                    # DiffusionTrainConfig
    params: Dict[str, Any]       # {"flow", "diffusion": {"parts": [Unet, ...]}}
    img_size: int
    temperature: float
    epoch: int


def _require_epoch(run_dir: str, prefix: str, epoch: Optional[int]) -> int:
    _refuse_orbax(run_dir, prefix, epoch)
    if epoch is None:
        epoch = latest_epoch(run_dir, prefix)
    if epoch is None:
        raise FileNotFoundError(f"no model_{prefix}_*.pt checkpoints in {run_dir}/checkpoints")
    return int(epoch)


def run_config(run_dir: str):
    """The run's persisted config.yaml as a Config."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"reading {run_dir}/config.yaml needs PyYAML, which is not "
                          "installed") from e
    from ..utils.config import Config

    with open(os.path.join(run_dir, "config.yaml")) as f:
        return Config(yaml.safe_load(f))


def _config_temperature(run_dir: str) -> Optional[float]:
    """model.training.temperature from the run's config.yaml: the fallback
    for architecture files without the temperature field."""
    if not os.path.exists(os.path.join(run_dir, "config.yaml")):
        return None
    t = run_config(run_dir).select("model.training.temperature")
    return float(t) if t is not None else None


def load_glow_run(run_dir: str, epoch: Optional[int] = None, device=None,
                  use_kernels: bool = True) -> GlowRun:
    """A stage-1 run (the newest checkpoint unless `epoch` names one), its
    parameters on `device` (CUDA unless named)."""
    from . import nf_trainer as nft

    device = resolve_device(device)
    run_dir = resolve_run_dir(run_dir)
    epoch = _require_epoch(run_dir, "gaussian", epoch)
    arch = load_architecture(run_dir)
    gcfg = glow_m.GlowConfig(
        in_channels=int(arch["in_channels"]), levels=int(arch["L"]), steps=int(arch["K"]),
        coupling_width=int(arch.get("coupling_width", 512)),
        learn_prior=bool(arch.get("learn_prior", True)),
        invconv_param=str(arch.get("invconv_param", "plu")), use_kernels=use_kernels)
    tcfg = nft.NFTrainConfig(n_bits=int(arch.get("n_bits", 5)),
                             compat_fixed_prior=bool(arch.get("fixed_prior", True)))
    params = restore_params(run_dir, "gaussian", epoch, device)
    temperature = arch.get("temperature")
    if temperature is None:
        temperature = _config_temperature(run_dir)
    return GlowRun(gcfg=gcfg, tcfg=tcfg, params=params, img_size=int(arch["img_size"]),
                   temperature=float(tcfg.temperature if temperature is None else temperature),
                   epoch=epoch)


def _diffusion_arch_from_config(run_dir: str) -> Dict[str, Any]:
    """The architecture dict of a stage-2 run without
    diffusion_architecture.json, rebuilt from its config.yaml (the flow's
    from the pretrained run's architecture.json), as the stage-2 entry point
    assembles the model."""
    cfg = run_config(run_dir)
    nf_cfg = cfg.model.normalizing_flow
    img_size = int(cfg.data.img_size)
    in_channels = 1 if cfg.data.name == "MNIST" else 3
    if nf_cfg.init_nf.mode == "pretrain":
        # a sibling run directory under the same outputs/
        pre = os.path.join(os.path.dirname(os.path.abspath(run_dir)),
                           nf_cfg.init_nf.pretrain.dir)
        fa = load_architecture(pre)
        flow = {"L": int(fa["L"]), "K": int(fa["K"]), "in_channels": int(fa["in_channels"]),
                "coupling_width": int(fa.get("coupling_width", 512)),
                "learn_prior": bool(fa.get("learn_prior", True)),
                "invconv_param": str(fa.get("invconv_param", "plu")), "img_size": img_size}
    else:
        sc = nf_cfg.init_nf.scratch
        flow = {"L": int(sc.L), "K": int(sc.K), "in_channels": in_channels,
                "coupling_width": int(sc.get("coupling_width", 512)),
                "learn_prior": True, "invconv_param": "plu", "img_size": img_size}
    u, d = cfg.model.unet, cfg.model.diffusion
    return {
        "kind": "diffusion_prior",
        "flow": flow,
        "formater": str(nf_cfg.latent_formater),
        "unet_kwargs": dict(
            dim=int(u.dim), dim_mults=list(u.dim_mults),
            resnet_block_groups=int(u.resnet_block_groups),
            learned_sinusoidal_cond=bool(u.learned_sinusoidal_cond),
            random_fourier_features=bool(u.random_fourier_features),
            learned_sinusoidal_dim=int(u.learned_sinusoidal_dim)),
        "diffusion_kwargs": dict(
            timesteps=int(d.timesteps), sampling_timesteps=int(d.sampling_timesteps),
            loss_type=str(d.loss_type), beta_schedule=str(d.beta_schedule),
            ddim_sampling_eta=float(d.ddim_sampling_eta),
            scan_unroll=int(cfg.select("model.diffusion.scan_unroll", 1)),
            sampling_method=str(cfg.select("model.diffusion.sampling_method", "auto")),
            vlb_time_chunk=int(cfg.select("model.diffusion.vlb_time_chunk", 4))),
        "frozen": bool(nf_cfg.freeze),
        "n_bits": int(cfg.model.training.n_bits),
        "temperature": float(cfg.model.training.temperature),
    }


def build_diffusion_model(arch: Dict[str, Any], ddim: Optional[int] = None,
                          sampler: Optional[str] = None, use_kernels: bool = True):
    """(NFBackbone, DiffusionPrior) of a stage-2 architecture dict (the keys
    of diffusion_architecture.json), the formater with the run's
    standardization stats. `ddim` overrides sampling_timesteps and `sampler`
    the sampling method ("ancestral", "ddim", "dpm++"): choices made at
    inference, not trained properties."""
    from ..models.diffusion_prior import DiffusionPrior
    from ..models.formaters import get_formater, stats_from_json
    from ..models.nf_backbone import NFBackbone

    fl = arch["flow"]
    gcfg = glow_m.GlowConfig(
        in_channels=int(fl["in_channels"]), levels=int(fl["L"]), steps=int(fl["K"]),
        coupling_width=int(fl["coupling_width"]),
        learn_prior=bool(fl.get("learn_prior", True)),
        invconv_param=str(fl.get("invconv_param", "plu")), use_kernels=use_kernels)
    img_size = int(fl["img_size"])
    backbone = NFBackbone(cfg=gcfg, img_size=img_size, frozen=bool(arch.get("frozen", True)))
    # the diffusion models live in the standardized space of the run's stats
    formater = get_formater(arch["formater"])(
        L=gcfg.levels, in_channels=gcfg.in_channels, size=img_size,
        stats=stats_from_json(arch.get("formater_stats")))
    dkw = dict(arch["diffusion_kwargs"])
    if ddim is not None:
        dkw["sampling_timesteps"] = ddim
    if sampler is not None:
        dkw["sampling_method"] = sampler
    ukw = dict(arch["unet_kwargs"])
    if "dim_mults" in ukw:
        ukw["dim_mults"] = tuple(ukw["dim_mults"])
    dp = DiffusionPrior(formater=formater, unet_kwargs=ukw, diffusion_kwargs=dkw,
                        use_kernels=use_kernels)
    return backbone, dp


def diffusion_architecture(run_dir: str) -> Dict[str, Any]:
    """A stage-2 run's diffusion_architecture.json, or the same dict rebuilt
    from its config.yaml for runs that predate the file."""
    try:
        return load_architecture(run_dir, "diffusion_architecture.json")
    except FileNotFoundError:
        return _diffusion_arch_from_config(run_dir)


def load_diffusion_run(run_dir: str, epoch: Optional[int] = None, ddim: Optional[int] = None,
                       use_ema: bool = True, sampler: Optional[str] = None, device=None,
                       use_kernels: bool = True) -> DiffusionRun:
    """A stage-2 run on `device` (CUDA unless named). `use_ema=True` (the
    default) takes the checkpoint's EMA weights where the run kept them
    (`ema_decay`), the right weights for generation; a run without them
    gives its live weights either way. `ddim` and `sampler` as in
    build_diffusion_model."""
    from . import diffusion_trainer as dt

    device = resolve_device(device)
    run_dir = resolve_run_dir(run_dir)
    epoch = _require_epoch(run_dir, "diffusion", epoch)
    arch = diffusion_architecture(run_dir)
    backbone, dp = build_diffusion_model(arch, ddim, sampler, use_kernels)
    tcfg = dt.DiffusionTrainConfig(n_bits=int(arch.get("n_bits", 5)),
                                   temperature=float(arch.get("temperature", 1.0)))
    params = restore_params(run_dir, "diffusion", epoch, device, prefer_ema=use_ema)
    params["diffusion"] = {"parts": dp.unets_from_named(params["diffusion"]["parts"], device)}
    return DiffusionRun(backbone=backbone, dp=dp, tcfg=tcfg, params=params,
                        img_size=backbone.img_size, temperature=tcfg.temperature, epoch=epoch)


def load_run(run_dir: str, epoch: Optional[int] = None, ddim: Optional[int] = None,
             use_ema: bool = True, sampler: Optional[str] = None, device=None):
    """(kind, run) of a run directory of either kind: kind "diffusion" or
    "gaussian" (detect_kind), run its DiffusionRun or GlowRun (the newest
    checkpoint unless `epoch` names one). `ddim`, `use_ema` and `sampler`
    apply to a stage-2 run, as in load_diffusion_run."""
    kind, newest = detect_kind(run_dir)
    epoch = newest if epoch is None else epoch
    if kind == "diffusion":
        return kind, load_diffusion_run(run_dir, epoch, ddim, use_ema=use_ema,
                                        sampler=sampler, device=device)
    return kind, load_glow_run(run_dir, epoch, device)


def sample_fn_of(kind: str, run, device=None):
    """The sampler of a loaded run that inference.generate_batched takes."""
    from ..inference import make_diffusion_sample_fn, make_sample_fn

    if kind == "diffusion":
        return make_diffusion_sample_fn(run.backbone, run.dp, run.tcfg.n_bits, device)
    return make_sample_fn(run.gcfg, run.img_size, run.tcfg.n_bits, device)
