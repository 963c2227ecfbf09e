#!/usr/bin/env python
"""Convert a run directory of the JAX package into one of the PyTorch port.

    python tools/jax_run_to_torch.py --run-dir outputs/<jax run> --out outputs/<new run>

A JAX run directory holds orbax checkpoints, which need JAX to read; the
port (nfdpm_tpu_torch) imports no JAX, so this tool, which imports both
packages, rewrites the run once:

  * architecture.json (stage 1) or diffusion_architecture.json (stage 2)
    and config.yaml are copied unchanged (a bf16 UNet's "dtype" with them:
    the port rebuilds bf16 UNets from the same parameter trees);
  * each orbax checkpoint checkpoints/model_{prefix}_{epoch:03d}/ (or only
    --epoch) becomes checkpoints/model_{prefix}_{epoch:03d}.pt holding
    {"params", "opt_state", "step"}, and "ema" where the checkpoint has one,
    in the port's layout (nfdpm_tpu_torch.convert.from_jax_params and
    diffusion_from_jax_params; a UNet as the dict of its parameters by name).

The checkpoint is restored into the train state its entry point builds
(jax_train_state): the run's Glow and, for stage 2, its diffusion prior,
with the optimizer of its config.yaml (Adam or AdamW, the fixed-prior mask,
a learning-rate schedule, stage 2's two groups) or, for a run without one
(written by tools/convert_reference_checkpoint.py), of its
architecture.json (default: Adam, fixed prior). Adam's moments and count
are taken from optax's state (both groups' of a co-trained stage-2 run,
whose counts must agree) and written through
nfdpm_tpu_torch.convert.opt_state_from_jax, so the converted run resumes
training in the port where the JAX run stopped.
Prints one JSON line naming what it wrote.
"""

import argparse
import json
import os
import re
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PREFIXES = ("gaussian", "diffusion")
# keyword arguments both packages' train configs take, under the same names
SHARED_SETTINGS = ("optimizer", "lr_schedule", "lr_warmup_steps", "lr_decay_steps",
                   "lr_end_factor")


def orbax_checkpoints(run_dir: str):
    """[(prefix, epoch)] of the orbax checkpoint directories of a JAX run."""
    d = os.path.join(run_dir, "checkpoints")
    found = []
    for name in sorted(os.listdir(d)):
        m = re.fullmatch(r"model_(gaussian|diffusion)_(\d+)", name)
        if m and os.path.isdir(os.path.join(d, name)):
            found.append((m.group(1), int(m.group(2))))
    return found


def optimizer_settings(run_dir: str, arch: dict) -> dict:
    """The optimizer a run was trained with: from its config.yaml as the
    entry points read it, else (a run the reference import tool wrote) from
    architecture.json's "optimizer" and "fixed_prior", at the import tool's
    defaults (Adam 1e-3, fixed prior, no schedule)."""
    if not os.path.exists(os.path.join(run_dir, "config.yaml")):
        return {"optimizer": str(arch.get("optimizer", "adam")), "lr": 1e-3, "lr_nf": None,
                "fixed_prior": bool(arch.get("fixed_prior", True)),
                "lr_schedule": "constant", "lr_warmup_steps": 0, "lr_decay_steps": None,
                "lr_end_factor": 0.0}
    from nfdpm_tpu_torch.training.runload import run_config

    cfg = run_config(run_dir)
    lr_nf = cfg.select("model.normalizing_flow.lr")
    decay = cfg.select("model.optimizer.decay_steps")
    return {"optimizer": str(cfg.model.optimizer.type), "lr": float(cfg.model.optimizer.lr),
            "lr_nf": float(lr_nf) if lr_nf else None,
            "fixed_prior": bool(cfg.select("compat.fixed_prior", True)),
            "lr_schedule": str(cfg.select("model.optimizer.schedule", "constant")),
            "lr_warmup_steps": int(cfg.select("model.optimizer.warmup_steps", 0)),
            "lr_decay_steps": int(decay) if decay else None,
            "lr_end_factor": float(cfg.select("model.optimizer.end_lr_factor", 0.0))}


def jax_train_state(run_dir: str, prefix: str, epoch: int) -> dict:
    """A checkpoint's whole train state as host numpy arrays, restored into
    the abstract state its entry point builds (nf_trainer.init_train_state
    under make_optimizer; diffusion_trainer.init_train_state under
    make_two_group_optimizer, with the EMA shadow where the checkpoint has
    one), so that optax's state comes back with its own types."""
    import jax

    from nfdpm_tpu.models import glow as jglow
    from nfdpm_tpu.training import checkpoint as jckpt
    from nfdpm_tpu.training import diffusion_trainer as jdt
    from nfdpm_tpu.training import nf_trainer as jnft
    from nfdpm_tpu.training import runload as jrl
    from nfdpm_tpu.training.optim import make_lr_schedule, make_optimizer

    if prefix == "gaussian":
        arch = jckpt.load_architecture(run_dir)
        opt = optimizer_settings(run_dir, arch)
        gcfg = jglow.GlowConfig(
            in_channels=int(arch["in_channels"]), levels=int(arch["L"]), steps=int(arch["K"]),
            coupling_width=int(arch.get("coupling_width", 512)),
            learn_prior=bool(arch.get("learn_prior", True)),
            invconv_param=str(arch.get("invconv_param", "plu")))
        tcfg = jnft.NFTrainConfig(lr=opt["lr"], compat_fixed_prior=opt["fixed_prior"],
                                  **{k: opt[k] for k in SHARED_SETTINGS})
        tx = make_optimizer(tcfg.optimizer, tcfg.lr, fixed_prior=tcfg.compat_fixed_prior,
                            lr_schedule=make_lr_schedule(
                                tcfg.lr, tcfg.lr_schedule, tcfg.lr_warmup_steps,
                                tcfg.lr_decay_steps, tcfg.lr_end_factor))
        template = jax.eval_shape(lambda: jnft.init_train_state(0, gcfg, tcfg, tx))
    else:
        run = jrl.load_diffusion_run(run_dir, epoch, use_ema=False)
        opt = optimizer_settings(run_dir, {})
        tcfg = jdt.DiffusionTrainConfig(lr_diffusion=opt["lr"], lr_nf=opt["lr_nf"],
                                        **{k: opt[k] for k in SHARED_SETTINGS})
        tx = jdt.make_two_group_optimizer(tcfg, run.backbone.frozen)
        has_ema = "ema" in jckpt.checkpoint_keys(run_dir, prefix, epoch)
        flow = jglow.init_glow(0, run.backbone.cfg)
        template = jax.eval_shape(lambda: jdt.init_train_state(
            0, run.backbone, flow, run.dp, tx, ema=has_ema))
    return jckpt.restore_state(run_dir, prefix, epoch, template)


def adam_moments(opt_state, params):
    """(mu, nu, count) of the optax state `opt_state` as numpy trees shaped
    like `params`: each leaf's moments from the ScaleByAdamState that
    updates it, zeros where optax masks the leaf out of every state (p_mat,
    sign, a fixed prior, a frozen flow). A co-trained stage-2 run has one
    state per group; their counts must agree."""
    import numpy as np
    import optax

    found = []

    def visit(node):
        if isinstance(node, optax.ScaleByAdamState):
            found.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (tuple, list)):  # optax's named tuples included
            for v in node:
                visit(v)

    visit(opt_state)
    counts = {int(s.count) for s in found}
    if len(counts) > 1:
        raise ValueError(f"the Adam states of the groups disagree on their count: {counts}; "
                         "the port keeps one count for all groups")

    def fill(moments, like):
        if isinstance(like, dict):
            return {k: fill([m.get(k) if isinstance(m, dict) else None for m in moments], v)
                    for k, v in like.items()}
        if isinstance(like, (tuple, list)):
            return type(like)(
                fill([m[i] if isinstance(m, (tuple, list)) else None for m in moments], v)
                for i, v in enumerate(like))
        if like is None:
            return None
        given = [m for m in moments if m is not None and not isinstance(m, optax.MaskedNode)]
        return np.asarray(given[0]) if given else np.zeros(np.shape(like), np.float32)

    return (fill([s.mu for s in found], params), fill([s.nu for s in found], params),
            counts.pop() if counts else 0)


def convert_state(tree: dict, prefix: str, arch: dict) -> dict:
    """A JAX train state -> the port's checkpoint dict {"params",
    "opt_state", "step" [, "ema"]} of CPU tensors."""
    from nfdpm_tpu_torch.convert import (diffusion_from_jax_params, from_jax_params,
                                         map_tree, opt_state_from_jax)

    cpu = "cpu"
    mu, nu, count = adam_moments(tree["opt_state"], tree["params"])
    if prefix == "gaussian":
        params = from_jax_params(tree["params"], cpu)
        opt_state = opt_state_from_jax(mu, nu, count, cpu)
        ema = None
    else:
        from nfdpm_tpu_torch.training.runload import build_diffusion_model

        _, dp = build_diffusion_model(arch)
        converted = diffusion_from_jax_params(tree["params"], dp, cpu)
        params = {"flow": converted["flow"], "diffusion": converted["diffusion"]}
        opt_state = opt_state_from_jax(mu, nu, count, cpu, dp=dp)
        ema = None
        if "ema" in tree:
            ema = diffusion_from_jax_params({"diffusion": tree["ema"]["diffusion"]}, dp, cpu)
            if "flow" in tree["ema"]:
                ema["flow"] = from_jax_params({"flow": tree["ema"]["flow"]}, cpu)["flow"]
    state = {"params": params, "opt_state": opt_state, "step": int(tree["step"])}
    if ema is not None:
        state["ema"] = ema
    return map_tree(state, lambda t: t.detach().cpu())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                 epilog="Adam's moments and count are carried over: the "
                                        "converted run resumes training in the port.")
    ap.add_argument("--run-dir", required=True, help="the JAX package's run directory")
    ap.add_argument("--out", required=True, help="the port's run directory to write")
    ap.add_argument("--epoch", type=int, default=None,
                    help="convert only this epoch's checkpoint(s) (default: all)")
    args = ap.parse_args(argv)

    import torch

    from nfdpm_tpu_torch.training.checkpoint import checkpoint_path
    from nfdpm_tpu_torch.training.runload import diffusion_architecture

    found = [(p, e) for p, e in orbax_checkpoints(args.run_dir)
             if args.epoch is None or e == args.epoch]
    if not found:
        raise SystemExit(f"no orbax checkpoints model_gaussian_*/model_diffusion_* "
                         f"in {args.run_dir}/checkpoints")
    os.makedirs(os.path.join(args.out, "checkpoints"), exist_ok=True)
    copied = []
    for name in ("architecture.json", "diffusion_architecture.json", "config.yaml"):
        if os.path.exists(os.path.join(args.run_dir, name)):
            shutil.copyfile(os.path.join(args.run_dir, name), os.path.join(args.out, name))
            copied.append(name)
    arch = (diffusion_architecture(args.run_dir) if any(p == "diffusion" for p, _ in found)
            else None)
    written = []
    for prefix, epoch in found:
        state = convert_state(jax_train_state(args.run_dir, prefix, epoch), prefix, arch)
        path = checkpoint_path(args.out, prefix, epoch)
        torch.save(state, path)
        written.append(path)
    record = {"run_dir": args.run_dir, "out": args.out, "copied": copied,
              "checkpoints": written, "optimizer_state": "Adam moments and count"}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
