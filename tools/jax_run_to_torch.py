#!/usr/bin/env python
"""Convert a run directory of the JAX package into one of the PyTorch port.

    python tools/jax_run_to_torch.py --run-dir outputs/<jax run> --out outputs/<new run>

A JAX run directory holds orbax checkpoints, which need JAX to read; the
port (nfdpm_tpu_torch) imports no JAX, so this tool, which imports both
packages, rewrites the run once:

  * architecture.json (stage 1) or diffusion_architecture.json (stage 2)
    and config.yaml are copied unchanged;
  * each orbax checkpoint checkpoints/model_{prefix}_{epoch:03d}/ (or only
    --epoch) becomes checkpoints/model_{prefix}_{epoch:03d}.pt holding
    {"params", "step"}, and "ema" where the checkpoint has one, in the
    port's layout (nfdpm_tpu_torch.convert.from_jax_params and
    diffusion_from_jax_params; a UNet as the dict of its parameters by name).

The optimizer state (Adam's moments and count) is NOT carried over: the
converted run serves, generates, interpolates, evaluates (phase=eval) and
pretrains a stage-2 run of the port, but training cannot resume from it.
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


def orbax_checkpoints(run_dir: str):
    """[(prefix, epoch)] of the orbax checkpoint directories of a JAX run."""
    d = os.path.join(run_dir, "checkpoints")
    found = []
    for name in sorted(os.listdir(d)):
        m = re.fullmatch(r"model_(gaussian|diffusion)_(\d+)", name)
        if m and os.path.isdir(os.path.join(d, name)):
            found.append((m.group(1), int(m.group(2))))
    return found


def restore_tree(run_dir: str, prefix: str, epoch: int) -> dict:
    """The whole saved state tree of a checkpoint as host numpy arrays,
    templated from its own metadata (no optimizer rebuilt)."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    path = os.path.abspath(os.path.join(run_dir, "checkpoints", f"model_{prefix}_{epoch:03d}"))
    with ocp.StandardCheckpointer() as ckptr:
        meta = ckptr.metadata(path).item_metadata.tree
        abstract = jax.tree.map(
            lambda leaf: np.zeros(leaf.shape, leaf.dtype)
            if hasattr(leaf, "shape") and hasattr(leaf, "dtype") else leaf, meta)
        return ckptr.restore(path, abstract)


def convert_state(tree: dict, prefix: str, arch: dict) -> dict:
    """A JAX state tree -> the port's checkpoint dict {"params", "step"
    [, "ema"]} of CPU tensors."""
    from nfdpm_tpu_torch.convert import (diffusion_from_jax_params, from_jax_params,
                                         map_tree)

    cpu = "cpu"
    if prefix == "gaussian":
        params = from_jax_params(tree["params"], cpu)
        ema = None
    else:
        from nfdpm_tpu_torch.training.runload import build_diffusion_model

        _, dp = build_diffusion_model(arch)
        converted = diffusion_from_jax_params(tree["params"], dp, cpu)
        params = {"flow": converted["flow"], "diffusion": converted["diffusion"]}
        ema = None
        if "ema" in tree:
            ema = diffusion_from_jax_params({"diffusion": tree["ema"]["diffusion"]}, dp, cpu)
            if "flow" in tree["ema"]:
                ema["flow"] = from_jax_params({"flow": tree["ema"]["flow"]}, cpu)["flow"]
    state = {"params": params, "step": int(tree["step"])}
    if ema is not None:
        state["ema"] = ema
    return map_tree(state, lambda t: t.detach().cpu())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                 epilog="The optimizer state is not carried over: the "
                                        "converted run cannot resume training.")
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
        state = convert_state(restore_tree(args.run_dir, prefix, epoch), prefix, arch)
        path = checkpoint_path(args.out, prefix, epoch)
        torch.save(state, path)
        written.append(path)
    record = {"run_dir": args.run_dir, "out": args.out, "copied": copied,
              "checkpoints": written, "optimizer_state": "not carried over"}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
