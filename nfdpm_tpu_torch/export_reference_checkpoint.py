"""Export a stage-1 run directory of the port as a checkpoint of the original PyTorch repository.

    python -m nfdpm_tpu_torch.export_reference_checkpoint \\
        --run-dir outputs/<run> [--epoch N] [--out DIR] [--lr 1e-4] [--device cpu]

Counterpart of tools/export_reference_checkpoint.py, with the same flags
and --device (default: CUDA, where runload places the run; the export
itself runs on the host). It writes `model_gaussian_{epoch:03d}.pt` in the
format of the reference's save_model, {flow, prior_dist, optimizer,
current_iter}, which the unmodified reference code loads with
load_state_dict(strict=True), and the same file again as
`model_{epoch:03d}.pt`, the name the reference's resume path loads.
current_iter is 0, as in the JAX tool (a run directory keeps no reference
iteration count).

Stage-2 runs are refused: the reference's own diffusion checkpoints never
held the UNet weights, so the reference has nothing that would load them.
Prints one JSON line naming what it wrote.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run-dir", required=True, help="run dir (or its name under outputs/)")
    ap.add_argument("--epoch", type=int, default=None,
                    help="checkpoint epoch (default: the newest)")
    ap.add_argument("--out", default=None, help="output dir (default: <run-dir>/exported)")
    ap.add_argument("--lr", type=float, default=1e-4,
                    help="lr recorded in the exported optimizer's parameter group (the "
                         "reference sets its own on resume)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, and fail without it)")
    args = ap.parse_args(argv)

    import torch

    from .training import runload
    from .training.checkpoint import latest_epoch
    from .utils.reference_export import (adam_skeleton, export_gaussian_prior_state_dict,
                                         export_glow_state_dict)

    run_dir = runload.resolve_run_dir(args.run_dir)
    if (latest_epoch(run_dir, "gaussian") is None
            and latest_epoch(run_dir, "diffusion") is not None):
        raise SystemExit(f"{run_dir} is a stage-2 run: the reference's diffusion checkpoints "
                         "never held the UNet weights, so there is nothing it would load; "
                         "only stage-1 runs export")
    run = runload.load_glow_run(run_dir, args.epoch, args.device)
    flow_sd = export_glow_state_dict(run.params["flow"], run.gcfg.levels, run.gcfg.steps)
    prior_sd = export_gaussian_prior_state_dict(run.params["prior"])

    def to_torch(sd):
        return {k: torch.from_numpy(v.copy()) for k, v in sd.items()}

    ckpt = {"flow": to_torch(flow_sd), "prior_dist": to_torch(prior_sd),
            "optimizer": adam_skeleton(flow_sd, args.lr), "current_iter": 0}
    out_dir = args.out or os.path.join(run_dir, "exported")
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f"model_gaussian_{run.epoch:03d}.pt"),
             os.path.join(out_dir, f"model_{run.epoch:03d}.pt")]  # the resume alias
    for path in paths:
        torch.save(ckpt, path)
    record = {"run_dir": run_dir, "epoch": run.epoch, "written": paths,
              "flow_elements": sum(v.numel() for v in ckpt["flow"].values())}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
