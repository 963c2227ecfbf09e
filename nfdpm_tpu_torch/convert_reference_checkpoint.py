"""Convert a checkpoint of the original PyTorch repository into a run directory of the port.

    python -m nfdpm_tpu_torch.convert_reference_checkpoint \\
        --checkpoint model_gaussian_100.pt --L 3 --K 4 --in_channels 1 \\
        --img_size 32 --out outputs/imported_run --epoch 100

Counterpart of tools/convert_reference_checkpoint.py, with the same flags.
The reference saves `model_gaussian_{epoch:03d}.pt` dicts {flow,
prior_dist, optimizer, current_iter}; this command reads one with
torch.load(weights_only=True) (a file that load refuses is refused),
maps the flow and prior state dicts through utils/reference_import into the
port's trees and writes

  * architecture.json, with the JAX tool's keys;
  * checkpoints/model_gaussian_{epoch:03d}.pt: {"params": {"flow",
    "prior"}, "opt_state", "step": current_iter}, the optimizer state fresh
    (the reference's Adam moments do not carry across parameterizations,
    as in the JAX tool) for the flow-only Adam the reference trains with.

training/runload.py and the entry points read the run as any other: it
serves, samples, scores (phase=eval) and resumes training
(load.load_exp_dir, load.load_epoch). The command does file and host
(scipy) work only, so it takes no --device.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", required=True, help="the reference's .pt file")
    ap.add_argument("--L", type=int, required=True)
    ap.add_argument("--K", type=int, required=True)
    ap.add_argument("--in_channels", type=int, default=3)
    ap.add_argument("--img_size", type=int, default=32)
    ap.add_argument("--coupling_width", type=int, default=512)
    ap.add_argument("--n_bits", type=int, default=5)
    ap.add_argument("--out", required=True, help="run dir to create")
    ap.add_argument("--epoch", type=int, required=True)
    args = ap.parse_args(argv)

    import torch

    from .convert import tree_to_device
    from .training.checkpoint import save_architecture, save_state
    from .training.optim import make_optimizer
    from .utils.reference_import import (import_gaussian_prior_state_dict,
                                         import_glow_state_dict)

    ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    params = tree_to_device({"flow": import_glow_state_dict(ckpt["flow"], args.L, args.K),
                             "prior": import_gaussian_prior_state_dict(ckpt["prior_dist"])},
                            torch.device("cpu"))
    # reference checkpoints come from a flow-only optimizer
    tx = make_optimizer("adam", 1e-3, fixed_prior=True)
    step = int(ckpt.get("current_iter", 0))
    os.makedirs(args.out, exist_ok=True)
    save_architecture(args.out, {
        "L": args.L, "K": args.K, "in_channels": args.in_channels, "img_size": args.img_size,
        "coupling_width": args.coupling_width, "learn_prior": True, "n_bits": args.n_bits})
    path = save_state(args.out, "gaussian", args.epoch,
                      {"params": params, "opt_state": tx.init(params), "step": step})
    record = {"checkpoint": args.checkpoint, "out": args.out, "written": path, "step": step}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
